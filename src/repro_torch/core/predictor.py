"""The DL speed predictor (§5), ported from `repro/core/predictor.py`: a
4-layer MLP with 64x64 hidden sizes that maps (online profile, offline
profile, assigned SM %) -> predicted normalized offline throughput.  Trained
with momentum SGD (the paper's optimizer), one model per GPU type.

Parameters are `repro`'s layout, a list of {"w": (din, dout), "b": (dout,)}
fp32 tensors, so `models.convert.mlp_from_jax` carries them across.  The
memoizing `CachedSpeedPredictor` and the synthetic `make_dataset` /
`build_speed_predictor` wait for the scheduler and the simulator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.interference import WorkloadProfile
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
