"""SLO-aware admission control — the serving plane's policy seam.

An :class:`AdmissionPolicy` decides, each tick and per service, how many
queued requests to *shed* before the continuous-batching drain runs.  The
contract is vectorized over the service's queued cohorts (oldest first):
given each cohort's age and size plus the lane's SLO/service-time/capacity
context, return per-cohort shed counts.

Like :mod:`repro_torch.policies`, policies are string-keyed through a registry so
scenarios name them declaratively (``ServingConfig.admission``) and tests /
users can register their own without touching the plane.

Built-ins:

``none``
    Never sheds — queues grow without bound under overload; the SLO
    attainment column shows what that costs.
``deadline``
    Deadline-based shedding: a request whose queueing delay has already
    exceeded ``slack × SLO − service_time`` cannot possibly meet its SLO,
    so serving it wastes capacity that fresher requests could meet their
    deadline with.  Shedding is monotone in load by construction (pinned by
    a unit test): queues only age past the deadline when arrivals outrun
    capacity.

Copied from `repro/serving_plane/admission.py` with the same behaviour.
"""
from __future__ import annotations

import numpy as np


class AdmissionPolicy:
    """Base class: decide per-cohort sheds for one service lane."""

    #: registry key (subclasses set it)
    name = "abstract"

    def shed(self, t: float, ages_s: np.ndarray, counts: np.ndarray, *,
             slo_s: float, service_s: float,
             capacity_rps: float) -> np.ndarray:
        """Per-cohort shed counts (``0 <= shed[k] <= counts[k]``).

        ``ages_s``/``counts`` walk the queue oldest-first; ``service_s`` is
        the current service time (base latency × slowdown) and
        ``capacity_rps`` the lane's effective fleet capacity this tick.
        """
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__doc__ or self.name


class NoAdmission(AdmissionPolicy):
    """Admit everything; never shed."""

    name = "none"

    def shed(self, t, ages_s, counts, *, slo_s, service_s, capacity_rps):
        return np.zeros_like(counts)


class DeadlineAdmission(AdmissionPolicy):
    """Shed requests whose wait already makes the SLO unreachable.

    The deadline is ``max(slack × slo_s − service_s, 0)``: once a request
    has queued longer than that, even immediate service lands past the SLO,
    so it is dropped (the client has long since timed out anyway).
    ``slack > 1`` keeps doomed requests around longer (softer shedding);
    ``slack < 1`` sheds ahead of the deadline (harder protection).
    """

    name = "deadline"

    def __init__(self, slack: float = 1.0):
        if slack <= 0:
            raise ValueError(f"slack must be positive, got {slack}")
        self.slack = slack

    def shed(self, t, ages_s, counts, *, slo_s, service_s, capacity_rps):
        deadline_s = max(self.slack * slo_s - service_s, 0.0)
        return np.where(ages_s > deadline_s, counts, 0)


_REGISTRY: dict[str, type[AdmissionPolicy]] = {}


def register_admission(cls: type[AdmissionPolicy]) -> type[AdmissionPolicy]:
    """Register an :class:`AdmissionPolicy` subclass under ``cls.name``."""
    name = cls.name
    if not name or name == "abstract":
        raise ValueError("admission policy needs a concrete .name")
    _REGISTRY[name] = cls
    return cls


def admission_available() -> list[str]:
    return sorted(_REGISTRY)


def resolve_admission(name_or_policy, **kwargs) -> AdmissionPolicy:
    """Name → constructed policy (kwargs forwarded); instances pass
    through.  Unknown names raise ``ValueError`` listing the registry."""
    if isinstance(name_or_policy, AdmissionPolicy):
        return name_or_policy
    cls = _REGISTRY.get(name_or_policy)
    if cls is None:
        raise ValueError(
            f"unknown admission policy {name_or_policy!r}; "
            f"available: {admission_available()}")
    if cls is NoAdmission:
        kwargs = {}          # the null policy takes no knobs
    return cls(**kwargs)


register_admission(NoAdmission)
register_admission(DeadlineAdmission)
