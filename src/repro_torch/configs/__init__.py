"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

One module per assigned architecture (exact public configs, sources in
each file), data only: a copy of ``repro.configs`` over the port's
``repro_torch.models.config``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

ARCH_IDS: List[str] = [
    "deepseek_v2_236b",
    "grok_1_314b",
    "hubert_xlarge",
    "zamba2_2p7b",
    "chatglm3_6b",
    "h2o_danube_3_4b",
    "yi_34b",
    "qwen2p5_3b",
    "llama_3p2_vision_11b",
    "mamba2_370m",
]

#: hyphenated public ids → module names
ALIASES: Dict[str, str] = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "grok-1-314b": "grok_1_314b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-2.7b": "zamba2_2p7b",
    "chatglm3-6b": "chatglm3_6b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "yi-34b": "yi_34b",
    "qwen2.5-3b": "qwen2p5_3b",
    "llama-3.2-vision-11b": "llama_3p2_vision_11b",
    "mamba2-370m": "mamba2_370m",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()


def all_arch_names() -> List[str]:
    return list(ALIASES.keys())
