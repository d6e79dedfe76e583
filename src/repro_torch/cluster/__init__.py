"""repro_torch.cluster — the event-driven cluster control plane (§5).

Layers the paper's deployment loop over the vectorized
:class:`repro_torch.core.simulator.ClusterSim` engine:

* :mod:`repro_torch.cluster.events` — typed events + deterministic event bus;
* :mod:`repro_torch.cluster.agents` — per-device NodeAgent heartbeats/staleness
  wrapping SysMonitor, dynamic-SM, and throttle telemetry;
* :mod:`repro_torch.cluster.jobs` — the offline-job lifecycle state machine
  (submit → queue → place → run → checkpoint → preempt → requeue/complete);
* :mod:`repro_torch.cluster.faults` — fault campaigns injecting the §4.2
  ErrorKind mix through the mixed error handler;
* :mod:`repro_torch.cluster.fleet` — heterogeneous GPU pools;
* :mod:`repro_torch.cluster.scenario` — named, seeded, replayable scenario specs;
* :mod:`repro_torch.cluster.control` — the ControlPlane that owns the tick loop.

Copied from `repro/cluster`; ``python -m repro_torch sim`` runs it
(``python -m repro_torch.cluster.run`` is its deprecated delegate).
"""
from repro_torch.cluster.control import ControlPlane, run_scenario
from repro_torch.cluster.events import Event, EventBus, EventKind
from repro_torch.cluster.faults import FaultCampaign, FaultCampaignConfig
from repro_torch.cluster.fleet import FleetSpec, GPUPool
from repro_torch.cluster.jobs import JobManager, JobState, LifecycleError
from repro_torch.cluster.scenario import SCENARIOS, Scenario, scenario_by_name

__all__ = [
    "ControlPlane", "run_scenario", "Event", "EventBus", "EventKind",
    "FaultCampaign", "FaultCampaignConfig", "FleetSpec", "GPUPool",
    "JobManager", "JobState", "LifecycleError", "SCENARIOS", "Scenario",
    "scenario_by_name",
]
