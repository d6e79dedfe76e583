"""Named, seeded, replayable scenario specs for the control plane.

A :class:`Scenario` composes everything a campaign needs — policy, fleet
pools, trace, fault campaign, agent behavior, autoscaling — into one
declarative record.  The same (scenario, seed) pair always produces the same
JSON report bit-for-bit; the registry holds the canonical campaigns the
benchmarks and CI run, and the CLI (``python -m repro_torch sim``) can
override the headline knobs (devices/hours/seed/policy/graceful-exit).

Copied from `repro/cluster/scenario.py` with the same behaviour.
"""
from __future__ import annotations

import dataclasses

from repro_torch.chaos import ChaosConfig
from repro_torch.cluster.agents import AgentConfig
from repro_torch.cluster.faults import FaultCampaignConfig
from repro_torch.cluster.fleet import GPUPool
from repro_torch.policies import SharingPolicy, policy_name
from repro_torch.serving_plane import ServingConfig


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str = ""
    # a repro_torch.policies registry name or a SharingPolicy instance; reports
    # always carry the canonical name
    policy: str | SharingPolicy = "muxflow"
    n_devices: int = 200
    hours: float = 12.0
    horizon_s: float | None = None    # exact horizon; overrides hours when
                                      # hours*3600 would not round-trip
    tick_s: float = 30.0
    schedule_interval_s: float = 900.0
    trace: str = "B"
    seed: int = 0
    graceful_exit: bool = True
    error_rate_per_job_hour: float = 0.05
    device_mtbf_h: float = 4000.0
    device_repair_s: float = 1800.0
    checkpoint_interval_s: float = 300.0
    restart_delay_s: float = 90.0
    online_outage_s: float = 120.0
    memory_quota: float = 0.4
    gpu_types: tuple = ("T4", "T4", "T4", "A10")   # used when pools == ()
    shard_size: int = 256
    predictor_cache_quantum: float = 0.02
    predictor_samples: int = 300
    predictor_epochs: int = 12
    pools: tuple[GPUPool, ...] = ()         # () -> homogeneous default fleet
    faults: FaultCampaignConfig | None = None
    # chaos plane: infrastructure fault campaign (None -> the byte-identical
    # no-chaos path; GPU-side faults stay in `faults` above)
    chaos: ChaosConfig | None = None
    agents: AgentConfig | None = dataclasses.field(
        default_factory=AgentConfig)
    autoscale: bool = False
    # request-level serving plane (None -> curve-level accounting only)
    serving: ServingConfig | None = None
    external_jobs: bool = True              # submit via the control plane
    keep_event_log: bool = False
    strict_lifecycle: bool = True
    # the tick-engine backend is an execution detail — "numpy" and "torch"
    # produce byte-identical reports (CI diffs them), so it stays out of
    # to_dict().  incremental_matching is NOT neutral in that sense (the
    # warm-started matcher's shard deal differs from the cold compact
    # matcher's, so flipping it changes placements) and is therefore part
    # of the scenario echo like any other semantic knob.
    engine: str = "numpy"
    incremental_matching: bool = True

    def horizon_seconds(self) -> float:
        return (self.horizon_s if self.horizon_s is not None
                else self.hours * 3600.0)

    def with_overrides(self, **kw) -> "Scenario":
        kw = {k: v for k, v in kw.items() if v is not None}
        if "hours" in kw:
            # an hours override supersedes any exact-horizon pin
            kw["horizon_s"] = None
        return dataclasses.replace(self, **kw) if kw else self

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["policy"] = policy_name(self.policy)
        d["pools"] = [p.to_dict() for p in self.pools]
        # engine-invariant reports: the same campaign must produce the same
        # bytes whichever tick engine ran it (CI diffs the two)
        del d["engine"]
        return d


_HETERO_POOLS = (
    GPUPool("t4", "T4", weight=0.60, speed=1.0, hbm_gb=16.0),
    GPUPool("a10", "A10", weight=0.25, speed=1.35, hbm_gb=24.0),
    GPUPool("a100", "A100", weight=0.15, speed=2.60, hbm_gb=40.0),
)

_TIGHT_POOLS = (
    GPUPool("small-hbm", "T4", weight=0.5, speed=1.0, hbm_gb=12.0),
    GPUPool("t4", "T4", weight=0.3, speed=1.0, hbm_gb=16.0),
    GPUPool("a10", "A10", weight=0.2, speed=1.35, hbm_gb=24.0),
)

SCENARIOS: dict[str, Scenario] = {s.name: s for s in (
    Scenario(
        name="smoke",
        description="Tiny CI scenario: every control-plane feature on, "
                    "event log retained.",
        n_devices=64, hours=1.0, trace="C",
        pools=_HETERO_POOLS,
        faults=FaultCampaignConfig(rate_per_device_hour=0.5),
        agents=AgentConfig(drop_rate=0.05),
        autoscale=True, keep_event_log=True,
        predictor_samples=150, predictor_epochs=5),
    Scenario(
        name="diurnal-mixed",
        description="The flagship campaign: heterogeneous fleet under "
                    "diurnal online load with a moderate fault campaign, "
                    "flaky node agents, and online-pool autoscaling.",
        trace="B", pools=_HETERO_POOLS,
        faults=FaultCampaignConfig(
            rate_per_device_hour=0.02,
            pool_rates=(("a100", 0.05),)),       # new silicon fails more
        agents=AgentConfig(drop_rate=0.01),
        autoscale=True),
    Scenario(
        name="fault-storm",
        description="§4.2 propagation study: the campaign drives all "
                    "errors (engine's own error process off) at storm "
                    "rates; toggle --no-graceful-exit to reproduce the "
                    "unprotected baseline.",
        trace="B", error_rate_per_job_hour=0.0,
        faults=FaultCampaignConfig(rate_per_device_hour=1.0),
        agents=AgentConfig()),
    Scenario(
        name="hetero-fleet",
        description="Heavy trace-D load on a fleet with an HBM-starved "
                    "pool: per-pool memory feasibility shapes placement.",
        trace="D", pools=_TIGHT_POOLS,
        agents=AgentConfig()),
    Scenario(
        name="agent-churn",
        description="Flaky DeviceProbe/SysMonitor daemons: 15% heartbeat "
                    "drops shrink the schedulable set; measures lifecycle "
                    "impact of control-plane staleness.",
        trace="C",
        agents=AgentConfig(drop_rate=0.15, stale_after=2.0)),
    Scenario(
        name="tally-slice",
        description="Tally-style priority task-slicing on a heterogeneous "
                    "fleet: best-effort work rides priority-gated slack "
                    "slices — near-zero online slowdown, reduced offline "
                    "throughput.",
        policy="tally-priority", trace="B", pools=_HETERO_POOLS,
        agents=AgentConfig()),
    Scenario(
        name="calibrated",
        description="Measured-interference campaign: the muxflow-measured "
                    "policy replays the profiled speed matrix (executed "
                    "jax_pallas workload pairs) as engine ground truth and "
                    "schedules with a measured-trained predictor.",
        policy="muxflow-measured", trace="B", pools=_HETERO_POOLS,
        agents=AgentConfig()),
    Scenario(
        name="serving-slo",
        description="Request-level serving campaign: diurnal arrivals with "
                    "Philly-style skewed request sizes drive per-service "
                    "queues through continuous batching; deadline admission "
                    "sheds SLO-doomed requests; the report's 'serving' "
                    "section judges the run on p50/p99 and SLO attainment.",
        trace="B", pools=_HETERO_POOLS,
        faults=FaultCampaignConfig(rate_per_device_hour=0.02),
        agents=AgentConfig(drop_rate=0.01),
        autoscale=True,
        serving=ServingConfig(arrivals="diurnal", load=0.85,
                              request_size_sigma=0.8,
                              admission="deadline")),
    Scenario(
        name="chaos-storm",
        description="Chaos-plane verification campaign: agent crash/clock-"
                    "skew storms, transient WAL IO fault bursts, predictor "
                    "outages, matcher budget exhaustion, and serving "
                    "overload bursts — every fault answered by the "
                    "graceful-degradation ladder; the harness "
                    "(python -m repro chaos) asserts zero event loss, "
                    "byte-identical crash recovery, fault↔recovery "
                    "pairing, and the online SLO budget.",
        n_devices=48, hours=2.0, trace="C",
        pools=_HETERO_POOLS,
        faults=FaultCampaignConfig(rate_per_device_hour=0.1),
        agents=AgentConfig(drop_rate=0.02),
        serving=ServingConfig(arrivals="diurnal", load=0.8,
                              admission="deadline"),
        keep_event_log=True,
        predictor_samples=150, predictor_epochs=5,
        # every episode (max 900 s) closes well before the 7200 s horizon
        chaos=ChaosConfig(
            agent_crash_rate_per_hour=0.6, agent_restart_s=240.0,
            clock_skew_rate_per_hour=0.3, clock_skew_s=120.0,
            clock_skew_len_s=600.0,
            wal_fault_rate_per_hour=40.0, wal_fault_burst=2,
            predictor_outage_rate_per_hour=2.0, predictor_outage_s=900.0,
            matcher_budget_rate_per_hour=4.0,
            serving_burst_rate_per_hour=2.0, serving_burst_s=600.0,
            serving_burst_mult=2.5, brownout_shed_frac=0.10,
            end_s=5400.0)),
    Scenario(
        name="mig-partition",
        description="ParvaGPU-style static spatial partitioning under heavy "
                    "trace-D load: a fixed MIG-like SM split isolates every "
                    "pair; predictable offline slice, online capped at its "
                    "partition.",
        policy="static-partition", trace="D", pools=_TIGHT_POOLS,
        agents=AgentConfig()),
)}


def scenario_by_name(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}"
        ) from None
