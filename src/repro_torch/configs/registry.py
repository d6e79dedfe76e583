"""Architecture registry: `get_config(arch_id, smoke=False)`.

The ids are `repro`'s; only the architectures in PORTED have a module here
(FULL, the exact public config, and SMOKE, the reduced one for CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "h2o-danube-1.8b",
    "gemma-7b",
    "h2o-danube-3-4b",
    "mistral-nemo-12b",
    "seamless-m4t-medium",
    "deepseek-v2-lite-16b",
    "granite-moe-1b-a400m",
    "jamba-1.5-large-398b",
    "xlstm-350m",
    "pixtral-12b",
]

PORTED = {
    "mistral-nemo-12b": "mistral_nemo_12b",
    "xlstm-350m": "xlstm_350m",
}


def get_config(arch_id: str, smoke: bool = False, **overrides):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported to repro_torch yet (ported: "
            f"{', '.join(PORTED)}); see ROADMAP.md for the order of the port")
    mod = importlib.import_module(f"repro_torch.configs.{PORTED[arch_id]}")
    cfg = mod.SMOKE if smoke else mod.FULL
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
