"""The DL speed predictor (§5), ported from `repro/core/predictor.py`: a
4-layer MLP with 64x64 hidden sizes that maps (online profile, offline
profile, assigned SM %) -> predicted normalized offline throughput.  Trained
with momentum SGD (the paper's optimizer), one model per GPU type.

Parameters are `repro`'s layout, a list of {"w": (din, dout), "b": (dout,)}
fp32 tensors, so `models.convert.mlp_from_jax` carries them across.  The
memoizing `CachedSpeedPredictor` (the scheduler's view of the predictor) and
the synthetic `make_dataset` are copied from `repro` draw for draw.

Predictions are fp32 on the device that holds the MLP; a card and the CPU
sum in different orders, so their answers agree within 1e-5, not bitwise.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.interference import (OFFLINE_MODEL_PROFILES,
                                           WorkloadProfile, online_profile,
                                           shared_performance)
from repro_torch.optim.optimizer import MomentumSGD, MomentumSGDConfig

N_FEATURES = 9  # on: util, sm_act, occ, time | off: util, sm_act, occ, time | sm%

# The documented feature contract (per-column [low, high]): occupancy-style
# features live in [0, 1]; the two separate-execution times are in seconds
# and bounded by 10 s (no profiled iteration/request is longer); the
# assigned SM share is a fraction.
FEATURE_RANGES = np.array([
    [0.0, 1.0],    # online gpu_util
    [0.0, 1.0],    # online sm_activity
    [0.0, 1.0],    # online sm_occupancy
    [0.0, 10.0],   # online exec time (s)
    [0.0, 1.0],    # offline gpu_util
    [0.0, 1.0],    # offline sm_activity
    [0.0, 1.0],    # offline sm_occupancy
    [0.0, 10.0],   # offline exec time (s)
    [0.0, 1.0],    # assigned offline SM share
], np.float32)


def pair_features(online: WorkloadProfile, offline: WorkloadProfile,
                  sm_off: float) -> np.ndarray:
    """The predictor's input row — see ``FEATURE_RANGES`` for the contract."""
    return np.array([
        online.gpu_util, online.sm_activity, online.sm_occupancy,
        online.exec_time_ms / 1000.0,
        offline.gpu_util, offline.sm_activity, offline.sm_occupancy,
        offline.exec_time_ms / 1000.0,
        sm_off,
    ], dtype=np.float32)


def mlp_init(generator: torch.Generator, hidden: int = 64, layers: int = 4,
             in_dim: int = N_FEATURES, device=None) -> list[dict]:
    """`layers` linear layers (the paper picks 4, hidden 64x64), He-normal
    weights and zero biases, drawn on the generator's device and placed on
    `device` (default: the generator's)."""
    dims = [in_dim] + [hidden] * (layers - 1) + [1]
    device = device or generator.device
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        w = torch.randn((din, dout), generator=generator,
                        device=generator.device) * (2.0 / din) ** 0.5
        params.append({"w": w.to(device),
                       "b": torch.zeros((dout,), device=device)})
    return params


def mlp_apply(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h[..., 0])   # normalized throughput in (0,1)


@dataclasses.dataclass
class SpeedPredictor:
    """One trained MLP per GPU type (the paper trains per-type models);
    ``histories`` holds each type's training history where it was trained
    here."""
    params_by_type: dict
    histories: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    @torch.no_grad()
    def predict(self, gpu_type: str, feats: np.ndarray) -> np.ndarray:
        """feats: (..., N_FEATURES) -> (...,) normalized throughput, numpy,
        computed on the device that holds the MLP."""
        params = self.params_by_type[gpu_type]
        feats = np.asarray(feats, np.float32)
        rows = torch.from_numpy(feats.reshape(-1, feats.shape[-1]))
        if rows.shape[0] == 0:
            return np.zeros(feats.shape[:-1], np.float32)
        out = mlp_apply(params, rows.to(params[0]["w"].device))
        return out.cpu().numpy().reshape(feats.shape[:-1])

    def predict_pair(self, gpu_type: str, online, offline, sm_off) -> float:
        return float(self.predict(gpu_type, pair_features(online, offline, sm_off)))


class CachedSpeedPredictor:
    """Bounded (LRU) memoizing wrapper around :class:`SpeedPredictor` for
    the scheduler's repeated rounds.

    With the paper's workloads a feature row is determined by the (online
    service @ QPS, offline model, SM share) triple, and the same triples
    recur every scheduling interval.  Rows are quantized to ``quantum`` (the
    prediction is computed *on the quantized row*, so the cache is
    self-consistent) and keyed per GPU type by their bytes.

    Each call deduplicates its rows **vectorized** (``np.unique`` over the
    byte rows) before touching the Python-level cache, so a 20 000-device
    round costs a few hundred dict operations instead of one per
    (device × model) pair — this is what keeps weight-grid construction off
    the interpreter at paper scale.  Misses are batched into a single inner
    predictor call.

    The memo is a true LRU bounded by ``max_entries`` (hits refresh
    recency, overflow evicts the least-recently-used row — the unbounded
    growth the earlier clear-on-overflow scheme traded away is gone), and
    ``stats()`` exposes hit/miss/eviction counters for telemetry snapshots.
    """

    def __init__(self, inner, quantum: float = 0.01,
                 max_entries: int = 2_000_000):
        self.inner = inner
        self.quantum = float(quantum)
        self.max_entries = int(max_entries)
        self._cache: "collections.OrderedDict[tuple[str, bytes], float]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def params_by_type(self):
        return self.inner.params_by_type

    def predict(self, gpu_type: str, feats: np.ndarray) -> np.ndarray:
        feats = np.asarray(feats, np.float32)
        squeeze = feats.ndim == 1
        rows = feats.reshape(-1, feats.shape[-1])
        if self.quantum > 0:
            rows = (np.round(rows / self.quantum)
                    * self.quantum).astype(np.float32)
        rows = np.ascontiguousarray(rows)
        # dedupe by row *bytes* (matches dict-key semantics: -0.0 != 0.0);
        # a void view makes this one memcmp-argsort instead of the
        # column-by-column lexsort np.unique(axis=0) would run
        nbytes = rows.shape[-1] * rows.itemsize
        voids = rows.view(np.dtype((np.void, nbytes))).reshape(-1)
        uniq_v, inverse = np.unique(voids, return_inverse=True)
        uniq_u8 = uniq_v.view(np.uint8).reshape(uniq_v.shape[0], nbytes)
        uniq_rows = uniq_u8.view(np.float32)
        cache = self._cache
        uniq_vals = np.empty(uniq_rows.shape[0], np.float32)
        miss_u: list[int] = []
        keys = [(gpu_type, uniq_u8[i].tobytes())
                for i in range(uniq_rows.shape[0])]
        for i, key in enumerate(keys):
            val = cache.get(key)
            if val is None:
                miss_u.append(i)
            else:
                cache.move_to_end(key)
                uniq_vals[i] = val
        n_miss = int(np.isin(inverse, miss_u).sum()) if miss_u else 0
        self.misses += n_miss
        self.hits += rows.shape[0] - n_miss
        if miss_u:
            mi = np.asarray(miss_u)
            pred = np.asarray(self.inner.predict(gpu_type, uniq_rows[mi]),
                              np.float32)
            uniq_vals[mi] = pred
            for i, p in zip(miss_u, pred):
                cache[keys[i]] = float(p)
            while len(cache) > self.max_entries:
                cache.popitem(last=False)
                self.evictions += 1
        out = uniq_vals[inverse]
        shaped = out.reshape(feats.shape[:-1])
        return shaped[()] if squeeze else shaped

    def predict_pair(self, gpu_type: str, online, offline, sm_off) -> float:
        return float(self.predict(gpu_type,
                                  pair_features(online, offline, sm_off)))

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        """Deterministic counters for telemetry/report surfaces."""
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self._cache),
                "hit_rate": self.hit_rate()}


def make_dataset(rng: np.random.Generator, n: int = 2000,
                 noise: float = 0.02) -> tuple[np.ndarray, np.ndarray]:
    """Synthesize a profiling dataset from the interference model: random
    (online service @ random QPS, offline model, sm%) triples with measured
    (= modeled + measurement noise) shared throughput."""
    feats, targets = [], []
    services = list(("recommend", "translate", "vision"))
    offline_names = list(OFFLINE_MODEL_PROFILES)
    for _ in range(n):
        svc = services[rng.integers(len(services))]
        qps = float(rng.uniform(5.0, 190.0))
        on = online_profile(svc, qps)
        off = OFFLINE_MODEL_PROFILES[offline_names[rng.integers(len(offline_names))]]
        # jitter the offline profile so the dataset covers a family, not 4 points
        off = dataclasses.replace(
            off,
            sm_activity=float(np.clip(off.sm_activity * rng.uniform(0.8, 1.2), 0.05, 1.0)),
            mem_bw=float(np.clip(off.mem_bw * rng.uniform(0.8, 1.2), 0.05, 1.0)),
            exec_time_ms=off.exec_time_ms * float(rng.uniform(0.7, 1.4)))
        sm = float(rng.uniform(0.05, 1.0))
        _, tput = shared_performance(on, off, sm)
        feats.append(pair_features(on, off, sm))
        targets.append(tput + rng.normal(0.0, noise))
    return np.stack(feats), np.clip(np.array(targets, np.float32), 0.0, 1.0)


def train_predictor(generator: torch.Generator, feats: np.ndarray,
                    targets: np.ndarray, *, hidden: int = 64, layers: int = 4,
                    epochs: int = 200, batch_size: int = 128, lr: float = 0.05,
                    val_frac: float = 0.2, seed: int = 0, init=None,
                    device=None):
    """Momentum-SGD training.  Returns (params, history dict).

    The validation split, the permutation and every epoch's batch order come
    from `np.random.default_rng(seed)` in `repro`'s order, so a run that
    starts from carried initial weights (`init`, a parameter list) follows
    `repro`'s run.  Without `init` the weights come from `mlp_init` on
    `generator`.  Training runs on `device` (default: the generator's)."""
    device = torch.device(device) if device is not None else generator.device
    n = len(feats)
    n_val = int(n * val_frac)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    feats = torch.from_numpy(np.asarray(feats, np.float32)[perm]).to(device)
    targets = torch.from_numpy(np.asarray(targets, np.float32)[perm]).to(device)
    xv, yv = feats[:n_val], targets[:n_val]
    xt, yt = feats[n_val:], targets[n_val:]
    if init is None:
        params = mlp_init(generator, hidden=hidden, layers=layers,
                          device=device)
    else:
        params = [{k: t.to(device=device, dtype=torch.float32, copy=True)
                   for k, t in layer.items()} for layer in init]
    weights = [t for layer in params for t in (layer["w"], layer["b"])]
    opt = MomentumSGD(MomentumSGDConfig(lr=lr, momentum=0.9))
    state = opt.init(weights)

    n_train = len(xt)
    steps_per_epoch = max(1, n_train // batch_size)
    history = {"val_mae": [], "train_loss": []}
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n_train)).to(device)
        losses = []
        for s in range(steps_per_epoch):
            idx = order[s * batch_size:(s + 1) * batch_size]
            with torch.enable_grad():
                for w in weights:
                    w.requires_grad_(True)
                loss = torch.mean((mlp_apply(params, xt[idx]) - yt[idx]) ** 2)
                grads = torch.autograd.grad(loss, weights)
                for w in weights:
                    w.requires_grad_(False)
            opt.update(weights, grads, state)
            losses.append(loss.detach())
        # one transfer an epoch, not one a step
        history["train_loss"].append(float(torch.stack(losses).sum())
                                     / steps_per_epoch)
        with torch.no_grad():
            history["val_mae"].append(
                float(torch.mean(torch.abs(mlp_apply(params, xv) - yv))))
    return params, history


def build_speed_predictor(gpu_types=("T4", "A10"), n: int = 2000,
                          epochs: int = 120, seed: int = 0,
                          device=None) -> SpeedPredictor:
    """Train one MLP per GPU type on the synthetic dataset (A10 modeled as a
    1.35x faster T4 with a different contention noise seed), on ``device``
    (the CUDA card unless ``device="cpu"``).  The initial weights come from
    a CPU generator seeded with ``seed + i``, so the card and the CPU start
    from the same weights."""
    dev = resolve_device(device)
    params_by_type, histories = {}, {}
    for i, t in enumerate(gpu_types):
        rng = np.random.default_rng(seed + i)
        feats, targets = make_dataset(rng, n=n)
        params_by_type[t], histories[t] = train_predictor(
            torch.Generator().manual_seed(seed + i), feats, targets,
            epochs=epochs, seed=seed + i, device=dev)
    return SpeedPredictor(params_by_type, histories)
