"""The SharingPolicy API and its string-keyed registry.

MuxFlow's evaluation (§7) is a comparison of *GPU-sharing policies* —
dedicated devices, Gandiva-style time-sharing, AntMan/PAI-style
priority-based time-sharing, MuxFlow and its -S/-M ablations.  This module
makes a policy a first-class object instead of a magic string dispatched
inside the simulator engine: each policy says whether it needs the speed
predictor, whether it schedules at all, how matched placement should be
configured, what SM share greedy placement hands out, and how a
sharing pair performs (the engine's per-tick ground truth), all in
vectorized array form.

The engine (:class:`repro_torch.core.simulator.ClusterSim`) resolves
policies through :func:`resolve`; adding a policy is
``register(MyPolicy())`` — no engine edits.  Copied from
`repro/policies/base.py`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.scheduler import SchedulerConfig


class SharingPolicy:
    """One GPU-sharing policy: scheduling behavior + shared-performance model.

    Subclasses set the class attributes and implement
    :meth:`shared_performance`; everything else has a sensible default.
    Policies are stateless — one instance serves every simulator run — and
    every array method is vectorized over the fleet.

    Attributes:
        name: registry key; also what :class:`SimResults.policy` reports.
        description: one-liner for ``--list-policies`` and docs.
        needs_predictor: True if scheduling requires the §5 speed predictor
            (the engine refuses to run without one).
        wants_scheduling: False for dedicated policies that never place
            offline work (the engine skips scheduling rounds entirely).
    """

    name: str = "unnamed"
    description: str = ""
    needs_predictor: bool = False
    wants_scheduling: bool = True

    # ------------------------------------------------------------ scheduling
    def scheduler_config(self, shard_size: int = 256) -> SchedulerConfig | None:
        """Configuration for the matching scheduler (§5, Algorithm 1).

        Return a :class:`SchedulerConfig` to place jobs through the
        predictor + KM-matching path (only Healthy, memory-feasible devices),
        or None to use greedy FIFO packing onto any alive free device (the
        time-sharing baselines' placement).
        """
        return None

    def sm_shares(self, on: dict[str, np.ndarray],
                  idx: np.ndarray) -> np.ndarray:
        """Offline SM shares handed out at greedy (non-matching) placement.

        ``on`` holds fleet-wide online profile arrays (see
        :func:`repro_torch.core.interference.online_profile_arrays`); ``idx`` are
        the device indices about to receive a job.  Returns one share in
        [0, 1] per entry of ``idx``.  On the matching path the
        :class:`SchedulerConfig` governs shares instead.
        """
        return np.full(idx.shape, 0.5, np.float64)

    def build_predictor(self, gpu_types, *, samples: int = 2000,
                        epochs: int = 120, seed: int = 0, device=None):
        """Train the §5 speed predictor this policy schedules with, on
        ``device`` (the CUDA card unless ``device="cpu"``).

        Only consulted when ``needs_predictor`` is True and the caller did
        not supply a predictor.  The default trains on the synthetic
        interference model; measured policies (``muxflow-measured``)
        override this to train on profiled pairs, so the predictor's
        training distribution always matches the policy's ground truth.
        """
        from repro_torch.core.predictor import build_speed_predictor
        return build_speed_predictor(gpu_types=tuple(gpu_types), n=samples,
                                     epochs=epochs, seed=seed, device=device)

    # ----------------------------------------------------------- performance
    def shared_performance(self, on: dict[str, np.ndarray],
                           off: dict[str, np.ndarray],
                           shares: np.ndarray,
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Per-device (online slowdown, offline normalized throughput).

        ``on``/``off`` are ``[key] -> (n_devices,) array`` mappings of
        online/offline profile fields (``gpu_util``, ``sm_activity``,
        ``sm_occupancy``, ``mem_bw``, ``exec_time_ms``, ``mem_bytes_frac``).
        The engine hands ``off`` in lazily — untouched keys cost nothing —
        and its entries for devices without a job are stale (the engine
        masks afterwards); ``shares`` is the per-device offline SM share.
        Must return two ``(n_devices,)`` arrays with slowdown >= 1.0 and
        throughput in [0, 1] everywhere.
        """
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<{type(self).__name__} {self.name!r}>"


# --------------------------------------------------------------------- registry
_REGISTRY: dict[str, SharingPolicy] = {}


def register(policy: SharingPolicy, *,
             aliases: tuple[str, ...] = ()) -> SharingPolicy:
    """Register ``policy`` under its name (plus ``aliases``); returns it.

    Re-registering a name bound to a *different* policy object raises — the
    registry is the single source of truth for what a name means.  The check
    runs over every key before any is inserted, so a rejected registration
    leaves the registry untouched.
    """
    if not policy.name or policy.name == SharingPolicy.name:
        raise ValueError(
            f"policy {type(policy).__name__} must set a unique `name` class "
            f"attribute before registration (got {policy.name!r})")
    keys = (policy.name, *aliases)
    for key in keys:
        bound = _REGISTRY.get(key)
        if bound is not None and bound is not policy:
            raise ValueError(f"sharing policy name {key!r} already registered "
                             f"to {bound!r}")
    for key in keys:
        _REGISTRY[key] = policy
    return policy


def unregister(name: str) -> None:
    """Remove the policy bound to ``name`` — together with every other key
    (canonical name and aliases) bound to the same object, so
    :func:`available` never advertises a name :func:`resolve` would reject."""
    pol = _REGISTRY.pop(name, None)
    if pol is not None:
        for key in [k for k, v in _REGISTRY.items() if v is pol]:
            del _REGISTRY[key]


def available() -> tuple[str, ...]:
    """Sorted canonical policy names (aliases excluded)."""
    return tuple(sorted({p.name for p in _REGISTRY.values()}))


def resolve(spec: str | SharingPolicy) -> SharingPolicy:
    """A policy instance from a registry name or an instance (passthrough).

    Unknown names raise ``ValueError`` listing every registered policy, so a
    typo'd ``--policy`` flag or config value fails loudly and helpfully.
    """
    if isinstance(spec, SharingPolicy):
        return spec
    try:
        return _REGISTRY[spec]
    except KeyError:
        raise ValueError(
            f"unknown sharing policy {spec!r}; available: "
            f"{', '.join(available())}") from None


def policy_name(spec: str | SharingPolicy) -> str:
    """Canonical name for a policy spec (resolves aliases and instances)."""
    return resolve(spec).name
