"""repro_torch.policies — first-class, pluggable GPU-sharing policies,
copied from `repro/policies`.

The :class:`SharingPolicy` API plus a string-keyed registry
(:func:`register` / :func:`resolve` / :func:`available`).  Importing this
package registers the paper's policies (``online-only`` a.k.a.
``dedicated``, the ``muxflow`` family, ``time-sharing``,
``pb-time-sharing``), the related-work baselines (``tally-priority``,
``static-partition``) and ``muxflow-measured``.

Adding your own policy::

    from repro_torch.policies import SharingPolicy, register

    class MyPolicy(SharingPolicy):
        name = "my-policy"
        def shared_performance(self, on, off, shares):
            ...

    register(MyPolicy())
    # now: run_policy("my-policy", ...)
"""
from repro_torch.policies.base import (SharingPolicy, available, policy_name,
                                       register, resolve, unregister)
from repro_torch.policies.builtin import (DedicatedPolicy, MuxFlowPolicy,
                                          PriorityTimeSharingPolicy,
                                          TimeSharingPolicy)
from repro_torch.policies.extra import (StaticPartitionPolicy,
                                        TallyPriorityPolicy)
# registered last: the measured policy lives in repro_torch.profiling (it
# wraps the speed-matrix artifact) and only touches repro_torch.policies.base,
# so the import graph stays acyclic in both import orders
from repro_torch.profiling.calibrate import register_measured_policy

MEASURED_MUXFLOW = register_measured_policy()

__all__ = [
    "SharingPolicy", "available", "policy_name", "register", "resolve",
    "unregister", "DedicatedPolicy", "MuxFlowPolicy",
    "PriorityTimeSharingPolicy", "TimeSharingPolicy",
    "StaticPartitionPolicy", "TallyPriorityPolicy", "MEASURED_MUXFLOW",
]
