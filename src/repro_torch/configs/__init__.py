"""Run configurations of the port: the assigned architecture configs (as
``repro.configs`` holds them) and the paper's own SOAM configuration
(``soam_paper``).

Each <arch>.py holds the exact published configuration, with torch
dtypes; reduced smoke variants derive via
``repro_torch.models.registry.smoke_config``. Every config resolves here;
``repro_torch.models.registry.get_bundle`` decides which families run.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "qwen3_moe_235b_a22b",
    "qwen2_moe_a2_7b",
    "llama3_405b",
    "yi_34b",
    "granite_3_2b",
    "qwen1_5_0_5b",
    "whisper_medium",
    "mamba2_2_7b",
    "zamba2_2_7b",
    "internvl2_76b",
)

ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama3-405b": "llama3_405b",
    "yi-34b": "yi_34b",
    "granite-3-2b": "granite_3_2b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "whisper-medium": "whisper_medium",
    "mamba2-2.7b": "mamba2_2_7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-76b": "internvl2_76b",
})


def get_config(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.config


def all_configs():
    return {a: get_config(a) for a in ARCHS}
