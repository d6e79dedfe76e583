"""Torch tick engine — the port's counterpart of `repro/core/engine_xla.py`,
the fused form of :meth:`repro_torch.core.simulator.ClusterSim._dense_core_numpy`.

The dense per-tick math — failure/error/completion state transitions,
progress/wall/checkpoint accrual, outage windows, DCGM-style telemetry, and
the vectorized SysMonitor state machine — runs as float64 torch ops on the
engine's device (the CUDA card unless the simulator was given
``device="cpu"``).  Ticks run in *blocks* between scheduling rounds: one
copy of the block's inputs to the device, the ticks one after another on
the device with their outputs stacked into one buffer there, and one copy
of that buffer back to the host.  Python re-enters only at sparse event
boundaries (job arrivals, scheduling rounds, control-plane hooks): the
accounting pass in ``simulator.py`` replays each tick from the stacked
outputs.

Bitwise parity contract
-----------------------
``SimConfig.engine = "torch"`` must produce *byte-identical* ``SimResults``
to the numpy engine at the same seed.  What makes that possible:

* the engine runs only IEEE correctly-rounded elementwise ops (+, −, ×,
  min, max, where, compares, gathers, integer math), each as its own torch
  op, so no compiler can contract a multiply into an add (an FMA rounds
  once where numpy rounds twice).  No ``addcmul``, ``addcdiv``, ``lerp``,
  ``add(alpha≠1)`` or ``torch.compile`` here; products the telemetry needs
  are formed on the host in ``_tick_inputs``, and every transcendental and
  every reduction stays on the host in the shared ``_account``;
* randomness is the numpy ``Generator``'s (3, n) uniform block of each
  tick, copied to the device — the engine draws nothing;
* every state array is float64 on the device, and scalars such as
  ``t + repair_s`` are formed in Python exactly as numpy forms them.

All state is host-authoritative: the fleet arrays, monitor state codes and
re-admission timers are pushed in and pulled out around each block, so the
control plane's between-tick mutations (``force_error``, ``evict_device``,
``set_schedulable_mask`` …) keep working on plain numpy, and the Overlimit
ring buffer never leaves the host — its rare updates replay per tick
through the same :class:`VectorSysMonitor` primitives the numpy engine
uses.  The engine cannot see the re-admission period the host assigns, so a
``start_wait`` before a block's last tick truncates the block: the prefix is
accepted and the rest re-steps from the restored state with the same
already-drawn inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sysmonitor import (S_DISABLED, S_HEALTHY, S_INIT,
                                         S_OVERLIMIT, S_UNHEALTHY)

_MAX_BLOCK = 32

# per-tick outputs, in their order in the block's output buffer: float64
# rows, then int8 rows (masks as 0/1, level, monitor state, error kind)
_F64 = ("tele_util", "tele_sm", "tele_clock", "tele_mem", "progress",
        "wall", "checkpoint", "outage_until", "failed_until", "readmit_at")
_MASKS = ("new_fail", "err", "fin", "evict_cand", "busy", "act",
          "mon_evict", "start_wait", "has_job")
_I8 = _MASKS + ("level", "mstate", "kind_idx")
_F = {k: i for i, k in enumerate(_F64)}
_I = {k: i for i, k in enumerate(_I8)}
# the per-tick input rows copied to the device for each block
_XS = ("fail_u", "err_u", "kind_u", "tput_dt", "on_util", "on_act", "on_mem")


class TorchTickEngine:
    """Drives the float64 tick core for one :class:`ClusterSim` on
    ``device``."""

    def __init__(self, sim, device: torch.device):
        self.sim = sim
        self.device = device
        cfg = sim.cfg
        mon = sim.monitor
        th = mon.cfg.thresholds
        # the scalars, formed in Python exactly as the numpy core forms them
        self.dt = cfg.tick_s
        self.p_fail = cfg.tick_s / (cfg.device_mtbf_h * 3600.0)
        self.p_err = cfg.error_rate_per_job_hour * cfg.tick_s / 3600.0
        self.repair_s = cfg.device_repair_s
        self.outage_s = cfg.online_outage_s
        self.ck_interval = cfg.checkpoint_interval_s
        self.err_total = sim._err_total
        self.th = th
        self.init_dur = mon.cfg.init_duration_s
        temp_c = 60.0                  # the engines' constant device temp
        self.temp_over = temp_c > th.temp_c[1]
        self.temp_unhealthy = temp_c > th.temp_c[0]
        self.n_kinds = len(sim._err_kinds)
        self.err_thresh = torch.from_numpy(sim._err_thresh).to(device)
        self.err_propagates = torch.from_numpy(sim._err_propagates).to(device)
        self.err_graceful_ck = torch.from_numpy(sim._err_graceful_ck).to(device)
        self.init_at = torch.from_numpy(mon._init_at).to(device)  # static
        self._block_hint = _MAX_BLOCK

    # ------------------------------------------------------------- driving
    def tick(self, inp: dict) -> dict:
        """Per-tick mode (control-plane interleaving): a block of one."""
        return self.tick_block([inp])[0]

    def tick_block(self, inps: list[dict]) -> list[dict]:
        """Run a scheduling-free run of ticks and return per-tick core dicts
        for the shared accounting pass."""
        cores: list[dict] = []
        while inps:
            T = min(len(inps), self._block_hint)
            accepted = self._run_block(inps[:T], cores)
            # adapt: monitor-event-dense phases shrink blocks (a truncated
            # block discards work past the event), quiet phases regrow them
            self._block_hint = (min(_MAX_BLOCK, 2 * accepted)
                                if accepted == T else accepted)
            inps = inps[accepted:]
        return cores

    def _tick(self, st: dict, x: torch.Tensor, stat: torch.Tensor,
              t: float, f_out: torch.Tensor, i_out: torch.Tensor) -> None:
        """One tick of dense state evolution on the device — mirrors
        ``ClusterSim._dense_core_numpy`` + ``VectorSysMonitor.update``
        operation for operation.  Updates ``st`` in place and writes the
        tick's outputs into ``f_out`` (float64 rows) and ``i_out`` (int8
        rows)."""
        fail_u, err_u, kind_u, tput_dt, on_util, on_act, on_mem = x
        used_min, used62, used45, duration, off_mem = stat
        has_job, progress, checkpoint = (st["has_job"], st["progress"],
                                         st["checkpoint"])
        wall, failed_until, outage_until = (st["wall"], st["failed_until"],
                                            st["outage_until"])
        mstate, readmit_at = st["mstate"], st["readmit_at"]

        alive = failed_until <= t
        new_fail = alive & (fail_u < self.p_fail)
        failed_until = torch.where(new_fail, t + self.repair_s, failed_until)
        act = alive & ~new_fail
        busy = act & has_job
        has_job = has_job & ~new_fail
        # offline progress + periodic checkpoint (tput·dt is a host-side
        # product, so the engine only adds)
        progress = torch.where(busy, progress + tput_dt, progress)
        wall = torch.where(busy, wall + self.dt, wall)
        ck = busy & (progress - checkpoint >= self.ck_interval)
        checkpoint = torch.where(ck, progress, checkpoint)
        # offline container errors: kind and §4.2 outcome from the per-kind
        # tables probed out of MixedErrorHandler (kind_idx is computed over
        # the whole fleet; it means something only where err is set)
        err = busy & (err_u < self.p_err)
        r = kind_u * self.err_total
        kind_idx = torch.clamp_max(
            (r[:, None] > self.err_thresh[None, :]).sum(dim=1),
            self.n_kinds - 1)
        propagated = err & self.err_propagates[kind_idx]
        outage_until = torch.where(propagated, t + self.outage_s,
                                   outage_until)
        checkpoint = torch.where(err & self.err_graceful_ck[kind_idx],
                                 progress, checkpoint)
        has_job = has_job & ~err
        # job completion
        fin = busy & has_job & (progress >= duration)
        has_job = has_job & ~fin
        # telemetry (products precomputed on the host; the clock scales
        # inside the max, as the numpy core does)
        used_off = torch.where(has_job, used_min, 0.0)
        tele_util = torch.clamp_max(
            on_util + torch.where(has_job, used62, 0.0), 1.0)
        tele_sm = torch.clamp_max(
            on_act + torch.where(has_job, used45, 0.0), 1.0)
        tele_clock = 1590.0 - torch.clamp_min(
            420.0 * (on_act + used_off - 0.8), 0.0)
        tele_mem = torch.clamp_max(
            on_mem + torch.where(has_job, off_mem, 0.0), 1.0)
        # SysMonitor classification (0 healthy / 1 unhealthy / 2 overlimit)
        th = self.th
        over = ((tele_util > th.gpu_util[1]) | (tele_sm > th.sm_activity[1])
                | (tele_mem > th.mem_used_frac[1]) | self.temp_over
                | (tele_clock < th.sm_clock_min[1]))
        unhealthy = ((tele_util > th.gpu_util[0])
                     | (tele_sm > th.sm_activity[0])
                     | (tele_mem > th.mem_used_frac[0]) | self.temp_unhealthy
                     | (tele_clock < th.sm_clock_min[0]))
        level = torch.where(over, 2, torch.where(unhealthy, 1, 0)).to(
            torch.int8)
        # SysMonitor transitions (VectorSysMonitor.update, vector form)
        init_m = act & (mstate == S_INIT)
        promote = init_m & (t - self.init_at >= self.init_dur)
        mstate = torch.where(promote, S_HEALTHY, mstate)
        rest = act & ~init_m & (mstate != S_DISABLED)
        healthy_m = rest & (mstate == S_HEALTHY)
        unhealthy_m = rest & (mstate == S_UNHEALTHY)
        over_m = rest & (mstate == S_OVERLIMIT)
        evict = (healthy_m | unhealthy_m) & (level == 2)
        mstate = torch.where(healthy_m & (level == 1), S_UNHEALTHY, mstate)
        mstate = torch.where(unhealthy_m & (level == 0), S_HEALTHY, mstate)
        mstate = torch.where(evict, S_OVERLIMIT, mstate)
        readmit_at = torch.where(evict, float("nan"), readmit_at)
        # Overlimit: wait out the exponential re-admission period (the
        # period itself is assigned on the host from the ring)
        exit_lvl = over_m & (level != 2)
        had_wait = ~torch.isnan(readmit_at)
        start_wait = exit_lvl & ~had_wait
        readmit = exit_lvl & had_wait & (t >= readmit_at)
        readmit_at = torch.where(over_m & (level == 2), float("nan"),
                                 readmit_at)
        mstate = torch.where(readmit, S_UNHEALTHY, mstate)
        readmit_at = torch.where(readmit, float("nan"), readmit_at)
        evict_cand = evict & has_job
        has_job = has_job & ~evict_cand

        st.update(has_job=has_job, progress=progress, checkpoint=checkpoint,
                  wall=wall, failed_until=failed_until,
                  outage_until=outage_until, mstate=mstate,
                  readmit_at=readmit_at)
        f = dict(tele_util=tele_util, tele_sm=tele_sm, tele_clock=tele_clock,
                 tele_mem=tele_mem, progress=progress, wall=wall,
                 checkpoint=checkpoint, outage_until=outage_until,
                 failed_until=failed_until, readmit_at=readmit_at)
        i8 = dict(new_fail=new_fail, err=err, fin=fin, evict_cand=evict_cand,
                  busy=busy, act=act, mon_evict=evict, start_wait=start_wait,
                  has_job=has_job)
        torch.stack([f[k] for k in _F64], out=f_out)
        torch.stack([i8[k].view(torch.int8) for k in _MASKS]
                    + [level, mstate, kind_idx.to(torch.int8)], out=i_out)

    def _run_block(self, inps: list[dict], cores: list[dict]) -> int:
        sim = self.sim
        s = sim.state
        mon = sim.monitor
        n = sim.cfg.n_devices
        dev = self.device
        T = len(inps)
        # one copy in: the block's per-tick inputs
        xs = np.empty((T, len(_XS), n), np.float64)
        for j, inp in enumerate(inps):
            on = inp["on"]
            xs[j] = (inp["fail_u"], inp["err_u"], inp["kind_u"],
                     inp["tput_dt"], on["gpu_util"], on["sm_activity"],
                     on["mem_bytes_frac"])
        xs = torch.from_numpy(xs).to(dev)
        inp0 = inps[0]
        stat = torch.from_numpy(np.stack(
            (inp0["used_min"], inp0["used62"], inp0["used45"], s.duration,
             inp0["off_mem"]))).to(dev)
        fstate = torch.from_numpy(np.stack(
            (s.progress, s.checkpoint, s.wall, s.failed_until,
             s.outage_until, mon._readmit_at))).to(dev)
        st = dict(zip(("progress", "checkpoint", "wall", "failed_until",
                       "outage_until", "readmit_at"), fstate))
        st["has_job"] = torch.from_numpy(s.has_job).to(dev)
        st["mstate"] = torch.from_numpy(mon.state).to(dev)
        # the outputs of every tick, stacked in one device buffer
        nf = T * len(_F64) * n * 8
        buf = torch.empty(nf + T * len(_I8) * n, dtype=torch.uint8,
                          device=dev)
        f_out = buf[:nf].view(torch.float64).view(T, len(_F64), n)
        i_out = buf[nf:].view(torch.int8).view(T, len(_I8), n)
        for j, inp in enumerate(inps):
            self._tick(st, xs[j], stat, inp["t"], f_out[j], i_out[j])
        # one copy out
        host = buf.cpu().numpy()
        fo = host[:nf].view(np.float64).reshape(T, len(_F64), n)
        io = host[nf:].view(np.int8).reshape(T, len(_I8), n)
        # accept ticks up to (and including) the first mid-block start_wait
        # (the host assigns re-admission periods the engine can't see)
        accepted = T
        sw = io[:T - 1, _I["start_wait"]].any(axis=1)
        if sw.any():
            accepted = int(np.argmax(sw)) + 1
        last = accepted - 1
        # fleet/monitor state back to (writable) numpy — the authoritative
        # copies — from the last accepted tick
        s.has_job = io[last, _I["has_job"]].view(np.bool_).copy()
        s.progress = fo[last, _F["progress"]].copy()
        s.checkpoint = fo[last, _F["checkpoint"]].copy()
        s.wall = fo[last, _F["wall"]].copy()
        s.failed_until = fo[last, _F["failed_until"]].copy()
        s.outage_until = fo[last, _F["outage_until"]].copy()
        mon.state = io[last, _I["mstate"]].copy()
        mon._readmit_at = fo[last, _F["readmit_at"]].copy()
        for j in range(accepted):
            inp = inps[j]
            t = inp["t"]
            core = {k: fo[j, i] for i, k in enumerate(_F64[:8])}
            core.update({k: io[j, _I[k]].view(np.bool_) for k in _MASKS})
            core["level"] = io[j, _I["level"]]
            core["mstate"] = io[j, _I["mstate"]]
            core["kind_idx"] = io[j, _I["kind_idx"]].astype(np.int64)
            busy = core["busy"]
            # the host-side masking the numpy core applies (shared formula)
            core["slowdown"] = np.where(busy, inp["slow_raw"], 1.0)
            core["tput"] = np.where(busy, inp["tput_speed"], 0.0)
            cores.append(core)
            # sparse host-side monitor ring work, per tick and in order —
            # through the same VectorSysMonitor primitives the numpy
            # engine's update() uses
            ei = np.flatnonzero(core["mon_evict"])
            if ei.size:
                mon.push_overlimit(ei, t)
            si = np.flatnonzero(core["start_wait"])
            if si.size:
                mon._readmit_at[si] = t + mon.wait_periods(si, t)
        return accepted
