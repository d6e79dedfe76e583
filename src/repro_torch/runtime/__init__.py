from .fault_tolerance import HeartbeatMonitor, NodeState, stale_mask  # noqa: F401
