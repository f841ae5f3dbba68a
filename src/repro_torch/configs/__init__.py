"""Architecture registry: ``--arch <id>`` resolves here.

Lists the reference's architectures in its order, the paper's own
accelerator (`imagine-u55`, an `ImagineConfig`, kept out of `ARCH_IDS`
as in the reference) and the port's own configurations
(`mellum2-12b-a2.5b`, kept out of `ARCH_IDS`, which is held equal to
the reference's registry); each module defines ``config()`` (published
numbers) and ``smoke()`` (same family, tiny dims, CPU-testable) —
copies of the reference's config modules.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable

_MODULES: Dict[str, str] = {
    "xlstm-350m": "xlstm_350m",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "granite-20b": "granite_20b",
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma3-27b": "gemma3_27b",
    "qwen2.5-14b": "qwen2_5_14b",
    "llava-next-34b": "llava_next_34b",
    "whisper-medium": "whisper_medium",
    "zamba2-1.2b": "zamba2_1_2b",
    # the paper's own accelerator config (FPGA simulator side)
    "imagine-u55": "imagine_u55",
    # the port's own: no counterpart in the reference's registry
    "mellum2-12b-a2.5b": "mellum2_12b",
}

#: registered ids outside `ARCH_IDS`
PORT_ONLY = ("imagine-u55", "mellum2-12b-a2.5b")

ARCH_IDS: List[str] = [k for k in _MODULES if k not in PORT_ONLY]


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.smoke() if smoke else mod.config()


__all__ = ["ARCH_IDS", "PORT_ONLY", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "shape_applicable"]
