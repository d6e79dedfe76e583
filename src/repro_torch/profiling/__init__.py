"""repro_torch.profiling — MuxFlow's measurement loop on the port: the
workload catalog (`workloads`), the pair-profiling harness (`harness`), the
speed-matrix artifact (`matrix`) and calibration into a trained speed
predictor (`calibrate`).  The package exports `repro.profiling`'s names and
binds ``MEASURED_MUXFLOW``, the registered ``muxflow-measured`` policy
(registration is idempotent, so importing this package or
`repro_torch.policies` first gives the same registry).

CLI: ``python -m repro_torch profile --suite smoke`` (see ``--help``).
"""
from repro_torch.profiling.calibrate import (MeasuredInterferenceProvider,
                                             build_measured_predictor,
                                             default_matrix,
                                             make_measured_dataset,
                                             predict_share_curve,
                                             register_measured_policy,
                                             workload_profile)
from repro_torch.profiling.harness import (SUITES, PairProfiler, SuiteConfig,
                                           build_speed_matrix)
from repro_torch.profiling.matrix import SCHEMA, SpeedMatrix, check_schema
from repro_torch.profiling.workloads import (ExecutionRecord, ProfileStore,
                                             Workload, build_catalog,
                                             catalog_by_role, execute,
                                             profile_from_trace,
                                             profile_step_fn)

MEASURED_MUXFLOW = register_measured_policy()

__all__ = [
    "SUITES", "SCHEMA", "ExecutionRecord", "MeasuredInterferenceProvider",
    "PairProfiler", "ProfileStore", "SpeedMatrix", "SuiteConfig", "Workload",
    "build_catalog", "build_measured_predictor", "build_speed_matrix",
    "catalog_by_role", "check_schema", "default_matrix", "execute",
    "make_measured_dataset", "predict_share_curve", "profile_from_trace",
    "profile_step_fn", "register_measured_policy", "workload_profile",
    "MEASURED_MUXFLOW",
]
