"""Architecture registry: `get_config(arch_id, smoke=False)` and
`all_configs(smoke=False)`.

The ids are `repro`'s, and all ten are ported: each has a module here
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
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "gemma-7b": "gemma_7b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "xlstm-350m": "xlstm_350m",
    "pixtral-12b": "pixtral_12b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def get_config(arch_id: str, smoke: bool = False, **overrides):
    if arch_id not in PORTED:
        raise ValueError(f"unknown architecture {arch_id!r}")
    mod = importlib.import_module(f"repro_torch.configs.{PORTED[arch_id]}")
    cfg = mod.SMOKE if smoke else mod.FULL
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def all_configs(smoke: bool = False) -> dict:
    """Every architecture's config by id, in `ARCH_IDS`' order."""
    return {a: get_config(a, smoke=smoke) for a in ARCH_IDS}
