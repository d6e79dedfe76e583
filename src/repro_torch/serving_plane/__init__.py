"""repro_torch.serving_plane — the request-level serving layer over the
cluster sim, copied from `repro/serving_plane`.

MuxFlow's whole point is protecting *online* workloads while space-sharing,
so policies must be judged on user-visible latency, not a proxy QPS curve.
This package adds that judgment layer:

* :mod:`repro_torch.serving_plane.arrivals` — :class:`ArrivalProcess`, the one
  shared definition of "requests arrive" (``poisson`` / ``diurnal`` /
  ``trace-replay`` / ``burst``), consumed by the pair-profiling harness,
  the §4.2 multiplexer demo, and the cluster serving plane alike;
* :mod:`repro_torch.serving_plane.admission` — the SLO-aware admission-control
  seam (:class:`AdmissionPolicy` registry: ``none`` / ``deadline``);
* :mod:`repro_torch.serving_plane.plane` — :class:`ServingPlane`: per-service
  request queues drained by continuous batching on the sim's tick clock,
  with per-request enqueue/start/finish accounting, deadline shedding, and
  a schema-versioned ``"serving"`` report section (per-service p50/p99,
  SLO-attainment %, shed counts).

Everything is a pure function of (scenario, seed): serving sections are
byte-identical across processes and across the numpy/torch tick engines.
"""
from repro_torch.serving_plane.admission import (AdmissionPolicy,
                                                 DeadlineAdmission,
                                                 NoAdmission,
                                                 admission_available,
                                                 register_admission,
                                                 resolve_admission)
from repro_torch.serving_plane.arrivals import ARRIVAL_KINDS, ArrivalProcess
from repro_torch.serving_plane.plane import (SERVING_SCHEMA, ServingConfig,
                                             ServingPlane)

__all__ = [
    "ARRIVAL_KINDS", "ArrivalProcess",
    "AdmissionPolicy", "DeadlineAdmission", "NoAdmission",
    "admission_available", "register_admission", "resolve_admission",
    "SERVING_SCHEMA", "ServingConfig", "ServingPlane",
]
