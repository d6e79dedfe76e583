from .fault_tolerance import (ElasticCoordinator, ElasticPlan,  # noqa: F401
                              HeartbeatMonitor, NodeState, stale_mask)
