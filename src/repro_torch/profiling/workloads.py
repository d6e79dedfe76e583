"""The workload catalog, ported from `repro/profiling/workloads.py`: the
port's executables as named, seeded, role-tagged :class:`Workload` records
the pair-profiling harness can run.

A profile has two sources of truth, kept deliberately separate:

  * **Execution** — :func:`execute` really runs the step function (the
    hand-written CUDA kernels on the card, their plain versions on the CPU)
    and records an output checksum plus wall-time stats.  Wall time is
    *measurement-only*: it never enters a speed-matrix artifact, because
    artifacts must be byte-identical across runs.
  * **Cost model** — deterministic per-step cost from the declared analytic
    FLOP/byte counts against the paper's T4 testbed (``roofline-v1``).  The
    harness's virtual clock runs on these costs, so co-location measurements
    are exact functions of (catalog, suite, seed), and equal `repro`'s.

The four catalog entries cover the serving and training hot paths at
`repro`'s own shapes: flash-attention prefill and decode attention (online
role — the workloads MuxFlow protects) and the SSM scan plus an LM train step
(offline role — the best-effort work MuxFlow packs in).

Each builder is split into an inputs function and a step function, so that
a test can feed the step the same inputs it gives the JAX kernel.  Inputs
are drawn by a seeded CPU generator and moved to the device, so the card and
the CPU see the same numbers and their checksums agree.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, synchronize
from repro_torch.core.interference import WorkloadProfile
from repro_torch.kernels import ops

# roofline-v1 device model: the paper's testbed GPU, an NVIDIA T4 (fp32
# FLOP/s, HBM bytes/s, memory).  These are the cost model's data, not this
# card's: the speed-matrix artifact depends on them, so they are `repro`'s
# values unchanged.
PEAK_FLOPS = 8.1e12        # fp32 FLOP/s
PEAK_BW = 300e9            # HBM bytes/s
DEVICE_BYTES = 16 << 30    # 16 GiB HBM
COST_MODEL = "roofline-v1"

ROLE_ONLINE = "online"
ROLE_OFFLINE = "offline"


@dataclasses.dataclass(frozen=True)
class Workload:
    """One named, seeded, role-tagged executable.

    ``build(device)`` returns a zero-argument step function whose float
    return value feeds the execution checksum.  ``flops_per_step`` /
    ``bytes_per_step`` are analytic counts for the roofline cost model;
    ``mem_bytes`` is the resident footprint (inputs + params) for
    memory-quota feasibility.  ``target_util`` is the online role's duty
    cycle in the harness (offline workloads run dense).
    """
    name: str
    role: str                          # ROLE_ONLINE | ROLE_OFFLINE
    seed: int
    warmup: int
    steps: int
    flops_per_step: float
    bytes_per_step: float
    mem_bytes: int
    build: Callable[[torch.device], Callable[[], float]]
    target_util: float = 0.5

    def cost_s(self) -> float:
        """Deterministic roofline step cost (compute + memory phases)."""
        return self.flops_per_step / PEAK_FLOPS + self.bytes_per_step / PEAK_BW

    def profile(self) -> WorkloadProfile:
        """Separate-execution profile derived from the cost model.

        The 'SM activity' analogue is the compute fraction of the roofline
        cost, 'memory bandwidth' the byte fraction (they sum to 1 by
        construction, floored at 0.05)."""
        cost = max(self.cost_s(), 1e-12)
        compute_frac = (self.flops_per_step / PEAK_FLOPS) / cost
        bw_frac = (self.bytes_per_step / PEAK_BW) / cost
        util = self.target_util if self.role == ROLE_ONLINE else 0.95
        return WorkloadProfile(
            name=self.name, gpu_util=util,
            sm_activity=max(compute_frac, 0.05),
            sm_occupancy=0.35 + 0.3 * max(compute_frac, 0.05),
            mem_bw=max(bw_frac, 0.05),
            exec_time_ms=cost * 1e3,
            mem_bytes_frac=self.mem_bytes / DEVICE_BYTES)


@dataclasses.dataclass
class ExecutionRecord:
    """What one :func:`execute` run measured."""
    workload: Workload
    steps_executed: int
    checksum: float              # deterministic (seeded inputs)
    wall_ms_per_step: float      # measured; NEVER serialized into artifacts
    profile: WorkloadProfile = dataclasses.field(init=False)

    def __post_init__(self):
        self.profile = self.workload.profile()


def execute(workload: Workload, *, device=None,
            clock=time.perf_counter) -> ExecutionRecord:
    """Run ``workload`` for real on ``device`` (the CUDA card unless
    ``device="cpu"``): warmup, then ``steps`` timed iterations, with the
    device synchronised before and after the timed loop.  Returns the
    execution record with an output checksum (rounded so the float is
    stable) and wall stats."""
    dev = resolve_device(device)
    step_fn = workload.build(dev)
    for _ in range(workload.warmup):
        step_fn()
    synchronize(dev)
    acc = 0.0
    t0 = clock()
    for _ in range(workload.steps):
        acc += step_fn()
    synchronize(dev)
    wall = (clock() - t0) / max(workload.steps, 1)
    return ExecutionRecord(
        workload=workload, steps_executed=workload.steps,
        checksum=float(round(acc, 6)), wall_ms_per_step=wall * 1e3)


# ---------------------------------------------------------------------------
# Catalog builders: inputs (seeded, on the device) and the step on them
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


FLASH_SHAPE = dict(B=1, Sq=128, H=4, Hk=2, d=64)


def flash_prefill_inputs(device) -> tuple:
    B, Sq, H, Hk, d = FLASH_SHAPE.values()
    gen = torch.Generator().manual_seed(11)
    return (_normal(gen, (B, Sq, H, d), device),
            _normal(gen, (B, Sq, Hk, d), device),
            _normal(gen, (B, Sq, Hk, d), device))


def flash_prefill_step(q, k, v) -> float:
    out = ops.flash_attention(q, k, v, causal=True)
    return float(out.float().sum())


DECODE_SHAPE = dict(B=4, Skv=256, H=4, Hk=2, d=64, kv_len=224)


def decode_serve_inputs(device) -> tuple:
    B, Skv, H, Hk, d, _ = DECODE_SHAPE.values()
    gen = torch.Generator().manual_seed(23)
    return (_normal(gen, (B, 1, H, d), device),
            _normal(gen, (B, Skv, Hk, d), device),
            _normal(gen, (B, Skv, Hk, d), device))


def decode_serve_step(q, k, v) -> float:
    out = ops.decode_attention(q, k, v, DECODE_SHAPE["kv_len"])
    return float(out.float().sum())


SSM_SHAPE = dict(B=2, S=64, di=128, N=8)


def ssm_scan_inputs(device) -> tuple:
    B, S, di, N = SSM_SHAPE.values()
    gen = torch.Generator().manual_seed(37)
    dt = F.softplus(_normal(gen, (B, S, di), device))
    x = _normal(gen, (B, S, di), device)
    Bc = _normal(gen, (B, S, N), device)
    Cc = _normal(gen, (B, S, N), device)
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=device).expand(di, N))
    return dt, x, Bc, Cc, A_log


def ssm_scan_step(dt, x, Bc, Cc, A_log) -> float:
    return float(ops.ssm_scan(dt, x, Bc, Cc, A_log).sum())


def _kernel_builder(inputs, step):
    def build(device) -> Callable[[], float]:
        args = inputs(device)
        return lambda: step(*args)
    return build


_TRAIN_ARCH = "xlstm-350m"
_TRAIN_BATCH, _TRAIN_SEQ = 2, 32


def lm_train_inputs(device) -> dict:
    """xlstm-350m SMOKE (bf16) weights, momentum SGD and the token stream
    the train step runs on."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim.optimizer import MomentumSGD, MomentumSGDConfig
    cfg = get_config(_TRAIN_ARCH, smoke=True)
    params = init_params(torch.Generator().manual_seed(41), cfg).to(device)
    opt = MomentumSGD(MomentumSGDConfig(lr=1e-3, momentum=0.9))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, _TRAIN_SEQ, _TRAIN_BATCH,
                                    seed=41))
    return {"step_fn": make_train_step(cfg, opt), "params": params,
            "opt_state": opt.init(list(params.parameters())), "pipe": pipe,
            "i": 0}


def lm_train_step(state: dict) -> float:
    """One train step on the next batch (torch autograd; no kernel, as in
    `repro`, whose smoke model's train path is plain jnp)."""
    batch = state["pipe"].batch_at(state["i"])
    state["params"], state["opt_state"], metrics = state["step_fn"](
        state["params"], state["opt_state"], batch)
    state["i"] += 1
    return float(metrics["loss"])


def _build_lm_train(device) -> Callable[[], float]:
    state = lm_train_inputs(device)
    return lambda: lm_train_step(state)


def _train_work() -> tuple[float, float, int]:
    """Analytic train-step work: ~6 FLOP per param per token, parameter +
    gradient + optimizer traffic for bytes (fp32)."""
    from repro_torch.configs import get_config
    cfg = get_config(_TRAIN_ARCH, smoke=True)
    n_params = cfg.param_count()
    tokens = _TRAIN_BATCH * _TRAIN_SEQ
    flops = 6.0 * n_params * tokens
    bytes_ = 3.0 * n_params * 4
    mem = int(4 * n_params * 4)          # params + grads + momentum + slack
    return flops, bytes_, mem


def _attn_flops(B, Sq, Skv, H, d) -> float:
    return 4.0 * B * H * Sq * Skv * d


def build_catalog() -> dict[str, Workload]:
    """The canonical catalog, rebuilt fresh each call (entries are frozen).
    Declared counts are `repro`'s, literal for literal."""
    train_flops, train_bytes, train_mem = _train_work()
    entries = [
        Workload(
            name="flash-prefill", role=ROLE_ONLINE, seed=11, warmup=1, steps=3,
            flops_per_step=_attn_flops(1, 128, 128, 4, 64),
            bytes_per_step=float((128 * 4 * 64 + 2 * 128 * 2 * 64
                                  + 128 * 4 * 64) * 4),
            mem_bytes=(128 * 4 * 64 + 2 * 128 * 2 * 64) * 4,
            build=_kernel_builder(flash_prefill_inputs, flash_prefill_step),
            target_util=0.6),
        Workload(
            name="decode-serve", role=ROLE_ONLINE, seed=23, warmup=1, steps=3,
            flops_per_step=_attn_flops(4, 1, 256, 4, 64),
            bytes_per_step=float(4 * (2 * 256 * 2 * 64 + 2 * 4 * 64) * 4),
            mem_bytes=4 * 2 * 256 * 2 * 64 * 4,
            build=_kernel_builder(decode_serve_inputs, decode_serve_step),
            target_util=0.45),
        Workload(
            name="ssm-scan", role=ROLE_OFFLINE, seed=37, warmup=1, steps=3,
            flops_per_step=float(2 * 64 * 128 * 8 * 6),
            bytes_per_step=float(2 * 64 * (2 * 128 + 2 * 8) * 4),
            mem_bytes=2 * 64 * (2 * 128 + 2 * 8) * 4,
            build=_kernel_builder(ssm_scan_inputs, ssm_scan_step)),
        Workload(
            name="lm-train-step", role=ROLE_OFFLINE, seed=41, warmup=1, steps=2,
            flops_per_step=train_flops, bytes_per_step=train_bytes,
            mem_bytes=train_mem, build=_build_lm_train),
    ]
    return {w.name: w for w in entries}


def catalog_by_role(catalog: dict[str, Workload] | None = None,
                    ) -> tuple[list[Workload], list[Workload]]:
    """(online workloads, offline workloads) in catalog order."""
    catalog = catalog or build_catalog()
    ws = list(catalog.values())
    return ([w for w in ws if w.role == ROLE_ONLINE],
            [w for w in ws if w.role == ROLE_OFFLINE])
