"""repro_torch.profiling — MuxFlow's measurement loop on the port: the
workload catalog (`workloads`), the pair-profiling harness (`harness`), the
speed-matrix artifact (`matrix`) and calibration into a trained speed
predictor (`calibrate`).

CLI: ``python -m repro_torch profile --suite smoke`` (see ``--help``).
"""
