"""Chaos plane: deterministic control-plane fault injection + the
graceful-degradation ladder that provably survives it.

Public surface:

- :class:`ChaosConfig` / :class:`ChaosCampaign` — seeded campaign wired
  into :class:`repro_torch.cluster.control.ControlPlane` via ``Scenario.chaos``.
- :class:`FaultInjector` / :class:`ScriptedInjector` — the seam protocol
  and a hand-scripted stub for unit tests.
- ``run_chaos_verification`` (in :mod:`repro_torch.chaos.harness`, imported
  lazily to keep this package import-light) — the invariant harness
  behind ``python -m repro_torch chaos``.

Copied from `repro/chaos` with the same behaviour.
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
