"""Chaos plane: deterministic control-plane fault injection + the
graceful-degradation ladder that provably survives it.

Public surface:

- :class:`ChaosConfig` / :class:`ChaosCampaign` — seeded campaign wired
  into :class:`repro_torch.cluster.control.ControlPlane` via ``Scenario.chaos``.
- :class:`FaultInjector` / :class:`ScriptedInjector` — the seam protocol
  and a hand-scripted stub for unit tests.

Copied from `repro/chaos`.  `repro`'s invariant harness
(``chaos/harness.py``, behind ``python -m repro chaos``) needs the
durability plane and is not ported yet (ROADMAP §1 item 3.3).
"""
from repro_torch.chaos.campaign import (CHAOS_KINDS, CHAOS_SCHEMA,
                                        ChaosCampaign, ChaosConfig)
from repro_torch.chaos.injector import FaultInjector, ScriptedInjector

__all__ = [
    "CHAOS_KINDS",
    "CHAOS_SCHEMA",
    "ChaosCampaign",
    "ChaosConfig",
    "FaultInjector",
    "ScriptedInjector",
]
