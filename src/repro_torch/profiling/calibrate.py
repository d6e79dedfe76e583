"""Calibration, ported from `repro/profiling/calibrate.py`: turn a measured
speed matrix into a shared-performance provider and a trained predictor.

  * :class:`MeasuredInterferenceProvider` — per-device profile arrays in,
    (online slowdown, offline throughput) out, looked up from measured pair
    grids (nearest measured workload by profile distance, linear
    interpolation along the share axis).
  * a measured predictor training set (:func:`make_measured_dataset`) and
    per-GPU-type trained MLPs (:func:`build_measured_predictor`), so the §5
    speed predictor trains on measurements.
  * :class:`MeasuredMuxFlowPolicy` — MuxFlow scheduling (dynamic SM + KM
    matching) with measured shared-performance and a measured-trained
    predictor, registered as ``muxflow-measured``.

The default matrix is built from the smoke suite on first use (on the CUDA
card unless ``device="cpu"``) and memoized; set
``REPRO_SPEED_MATRIX=/path/to/matrix.json`` to calibrate from a saved
artifact instead.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.interference import WorkloadProfile
from repro_torch.core.predictor import (SpeedPredictor, pair_features,
                                        train_predictor)
from repro_torch.profiling.matrix import SpeedMatrix

_MATCH_KEYS = ("gpu_util", "sm_activity", "mem_bw")

_DEFAULT_MATRICES: dict[tuple, SpeedMatrix] = {}


def default_matrix(suite: str = "smoke", seed: int = 0,
                   device=None) -> SpeedMatrix:
    """The process-wide default matrix: ``$REPRO_SPEED_MATRIX`` if set,
    otherwise built from the named suite on ``device`` (the CUDA card
    unless ``device="cpu"``) once and memoized."""
    path = os.environ.get("REPRO_SPEED_MATRIX")
    if path:
        return SpeedMatrix.load(path)
    dev = resolve_device(device)
    key = (suite, seed, str(dev))
    if key not in _DEFAULT_MATRICES:
        from repro_torch.profiling.harness import build_speed_matrix
        _DEFAULT_MATRICES[key] = build_speed_matrix(suite, seed=seed,
                                                    device=dev)
    return _DEFAULT_MATRICES[key]


def workload_profile(matrix: SpeedMatrix, name: str) -> WorkloadProfile:
    """Reconstruct a measured workload's separate-execution profile."""
    p = matrix.workloads[name]["profile"]
    return WorkloadProfile(name=name, **p)


class MeasuredInterferenceProvider:
    """Vectorized measured shared-performance lookup.

    ``on``/``off`` are ``[key] -> (n,) array`` mappings, ``sm_off`` the
    per-device share.  Each device is matched to its nearest measured online
    and offline workload by Euclidean distance over (gpu_util, sm_activity,
    mem_bw); the pair's measured slowdown/throughput grids are then linearly
    interpolated at the assigned share (clamped to the measured sweep at the
    ends).
    """

    def __init__(self, matrix: SpeedMatrix):
        self.matrix = matrix
        roles = {"online": [], "offline": []}
        for name, w in matrix.workloads.items():
            roles[w["role"]].append(name)
        self.online_names = sorted(roles["online"])
        self.offline_names = sorted(roles["offline"])
        if not self.online_names or not self.offline_names:
            raise ValueError("speed matrix must measure both roles")

        def feats(names):
            return np.array([[matrix.workloads[n]["profile"][k]
                              for k in _MATCH_KEYS] for n in names])

        self._on_feats = feats(self.online_names)
        self._off_feats = feats(self.offline_names)
        self._grids: dict[tuple[int, int], tuple] = {}
        for i, on in enumerate(self.online_names):
            for j, off in enumerate(self.offline_names):
                p = matrix.pair(on, off)
                self._grids[(i, j)] = (np.asarray(p["shares"], np.float64),
                                       np.asarray(p["online_slowdown"],
                                                  np.float64),
                                       np.asarray(p["offline_tput"],
                                                  np.float64))

    @staticmethod
    def _nearest(feats: np.ndarray, measured: np.ndarray) -> np.ndarray:
        # (n, 3) vs (m, 3) -> (n,) argmin over squared distance
        d2 = ((feats[:, None, :] - measured[None, :, :]) ** 2).sum(axis=2)
        return np.argmin(d2, axis=1)

    def __call__(self, on, off, sm_off) -> tuple[np.ndarray, np.ndarray]:
        sm_off = np.clip(np.asarray(sm_off, np.float64), 0.0, 1.0)
        on_f = np.stack([np.asarray(on[k], np.float64) for k in _MATCH_KEYS],
                        axis=1)
        off_f = np.stack([np.asarray(off[k], np.float64) for k in _MATCH_KEYS],
                         axis=1)
        oi = self._nearest(on_f, self._on_feats)
        oj = self._nearest(off_f, self._off_feats)
        slowdown = np.ones(sm_off.shape, np.float64)
        tput = np.zeros(sm_off.shape, np.float64)
        pair_code = oi * len(self.offline_names) + oj
        for (i, j), (grid, slow_g, tput_g) in self._grids.items():
            mask = pair_code == i * len(self.offline_names) + j
            if not mask.any():
                continue
            slowdown[mask] = np.interp(sm_off[mask], grid, slow_g)
            tput[mask] = np.interp(sm_off[mask], grid, tput_g)
        return np.maximum(slowdown, 1.0), np.clip(tput, 0.0, 1.0)

    # alias so the provider reads as a drop-in at call sites
    shared_performance_arrays = __call__


# ---------------------------------------------------------------------------
# Measured predictor training
# ---------------------------------------------------------------------------

def make_measured_dataset(matrix: SpeedMatrix, rng: np.random.Generator,
                          n: int = 2000, noise: float = 0.01,
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Predictor training pairs from the measured grids: random (pair,
    share) samples with the measured throughput (interpolated along the
    share sweep) as target.  Profile features are mildly jittered so the
    MLP sees a family around each measured workload.  numpy, draw for draw
    `repro`'s."""
    provider = MeasuredInterferenceProvider(matrix)
    feats, targets = [], []
    for _ in range(n):
        on_name = provider.online_names[
            rng.integers(len(provider.online_names))]
        off_name = provider.offline_names[
            rng.integers(len(provider.offline_names))]
        pair = matrix.pair(on_name, off_name)
        share = float(rng.uniform(0.05, 1.0))
        target = float(np.interp(share, pair["shares"],
                                 pair["offline_tput"]))
        on_p = workload_profile(matrix, on_name)
        off_p = workload_profile(matrix, off_name)

        def jitter(p):
            return dataclasses.replace(
                p,
                gpu_util=float(np.clip(p.gpu_util * rng.uniform(0.9, 1.1),
                                       0.0, 1.0)),
                sm_activity=float(np.clip(
                    p.sm_activity * rng.uniform(0.9, 1.1), 0.05, 1.0)),
                exec_time_ms=p.exec_time_ms * float(rng.uniform(0.9, 1.1)))

        feats.append(pair_features(jitter(on_p), jitter(off_p), share))
        targets.append(target + rng.normal(0.0, noise))
    return np.stack(feats), np.clip(np.array(targets, np.float32), 0.0, 1.0)


def build_measured_predictor(matrix: SpeedMatrix, gpu_types=("T4", "A10"),
                             n: int = 2000, epochs: int = 120, seed: int = 0,
                             device=None) -> SpeedPredictor:
    """Train one MLP per GPU type on the measured dataset, on ``device``
    (the CUDA card unless ``device="cpu"``).  The initial weights are drawn
    by a CPU generator seeded with ``seed + i``, so the card and the CPU
    start from the same weights.  Each type's training history is kept on
    the predictor's ``histories``."""
    dev = resolve_device(device)
    params_by_type, histories = {}, {}
    for i, t in enumerate(gpu_types):
        rng = np.random.default_rng(seed + i)
        feats, targets = make_measured_dataset(matrix, rng, n=n)
        params_by_type[t], histories[t] = train_predictor(
            torch.Generator().manual_seed(seed + i), feats, targets,
            epochs=epochs, seed=seed + i, device=dev)
    return SpeedPredictor(params_by_type, histories)


def predict_share_curve(predictor, gpu_type: str, online: WorkloadProfile,
                        offline: WorkloadProfile,
                        shares: np.ndarray) -> np.ndarray:
    """Predicted offline throughput across a share sweep, monotone
    non-decreasing by construction: the isotonic envelope (running max) of
    the raw MLP outputs along the share axis."""
    shares = np.asarray(shares, np.float64)
    order = np.argsort(shares)
    feats = np.stack([pair_features(online, offline, float(s))
                      for s in shares[order]])
    raw = np.asarray(predictor.predict(gpu_type, feats), np.float64)
    iso = np.maximum.accumulate(raw)
    out = np.empty_like(iso)
    out[order] = iso
    return out


# ---------------------------------------------------------------------------
# The calibrated policy
# ---------------------------------------------------------------------------

class MeasuredMuxFlowPolicy:
    """MuxFlow scheduling with measured shared-performance.

    Same dynamic-SM + KM-matching scheduling as ``muxflow``, but the
    engine's per-tick ground truth comes from the profiled speed matrix via
    :class:`MeasuredInterferenceProvider`, and the speed predictor it
    schedules with trains on measured pairs.  With no matrix supplied the
    smoke-suite default is built on ``device`` on first use (or loaded from
    ``$REPRO_SPEED_MATRIX``).

    (Declared as a :class:`~repro_torch.policies.base.SharingPolicy`
    subclass at registration time — see the bottom of this module — to keep
    this module's import graph one-directional into
    ``repro_torch.policies.base``.)
    """

    name = "muxflow-measured"
    description = ("MuxFlow with measured interference: speed matrix from "
                   "executed workload pairs replaces the analytic "
                   "contention model; predictor trains on measurements.")
    needs_predictor = True
    wants_scheduling = True

    def __init__(self, matrix: SpeedMatrix | None = None,
                 suite: str = "smoke", device=None):
        self._matrix = matrix
        self._pinned = matrix is not None     # explicit matrix wins over env
        self._env_src: str | None = None
        self._suite = suite
        self._device = device
        self._provider: MeasuredInterferenceProvider | None = None

    @property
    def matrix(self) -> SpeedMatrix:
        if self._pinned:
            return self._matrix
        # the registry holds one process-wide instance, so the memo tracks
        # $REPRO_SPEED_MATRIX: setting/changing/unsetting it between runs
        # swaps the calibration source instead of keeping a stale matrix
        src = os.environ.get("REPRO_SPEED_MATRIX")
        if self._matrix is None or src != self._env_src:
            self._env_src = src
            self._matrix = default_matrix(self._suite, device=self._device)
            self._provider = None
        return self._matrix

    @property
    def provider(self) -> MeasuredInterferenceProvider:
        matrix = self.matrix            # may invalidate self._provider
        if self._provider is None:
            self._provider = MeasuredInterferenceProvider(matrix)
        return self._provider

    def scheduler_config(self, shard_size: int = 256):
        from repro_torch.core.scheduler import SchedulerConfig
        return SchedulerConfig(use_dynamic_sm=True, use_matching=True,
                               shard_size=shard_size)

    def sm_shares(self, on, idx):
        from repro_torch.core.dynamic_sm import dynamic_sm_array
        return dynamic_sm_array(on["sm_activity"][idx])

    def shared_performance(self, on, off, shares):
        return self.provider(on, off, shares)

    def on_device(self, device):
        """A policy whose default matrix is built on ``device``; a pinned
        matrix or the same device keeps this one."""
        if self._pinned or device == self._device:
            return self
        return type(self)(suite=self._suite, device=device)

    def build_predictor(self, gpu_types, *, samples: int = 2000,
                        epochs: int = 120, seed: int = 0, device=None):
        return build_measured_predictor(self.matrix, gpu_types, n=samples,
                                        epochs=epochs, seed=seed,
                                        device=device)


def register_measured_policy():
    """Idempotently register ``muxflow-measured`` (done on import of
    :mod:`repro_torch.policies`).

    The concrete registered class mixes :class:`MeasuredMuxFlowPolicy` over
    ``SharingPolicy`` here, lazily, so importing this module never imports
    the policy package back (one-directional import graph)."""
    global MeasuredMuxFlowPolicy
    from repro_torch.policies.base import SharingPolicy, register, resolve
    if not issubclass(MeasuredMuxFlowPolicy, SharingPolicy):
        MeasuredMuxFlowPolicy = type("MeasuredMuxFlowPolicy",
                                     (MeasuredMuxFlowPolicy, SharingPolicy),
                                     {"__doc__": MeasuredMuxFlowPolicy.__doc__})
    try:
        return resolve("muxflow-measured")
    except ValueError:
        return register(MeasuredMuxFlowPolicy(),
                        aliases=("calibrated-muxflow",))
