"""Architecture registry of the port: ``get_config(name)`` gives the full
published config, ``smoke_config(name)`` a reduced same-family config for
CPU tests.  ``ARCHS`` lists the ids the port serves: every id of the
JAX package's registry.
"""
from __future__ import annotations

import importlib

__all__ = ["ARCHS", "get_config", "smoke_config"]

ARCHS = [
    "falcon-mamba-7b",
    "mixtral-8x7b",
    "phi3.5-moe-42b-a6.6b",
    "gemma-7b",
    "phi3-medium-14b",
    "smollm-360m",
    "h2o-danube-3-4b",
    "whisper-large-v3",
    "internvl2-26b",
    "jamba-1.5-large-398b",
]

_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "gemma-7b": "gemma_7b",
    "phi3-medium-14b": "phi3_medium_14b",
    "smollm-360m": "smollm_360m",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "whisper-large-v3": "whisper_large_v3",
    "internvl2-26b": "internvl2_26b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _mod(name).config()


def smoke_config(name: str):
    return _mod(name).smoke_config()
