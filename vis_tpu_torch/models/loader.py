"""Where a model's checkpoint lives: the device-free part of
``vis_tpu/models/loader.py``, copied as it is.

Production checkpoints are HF-format directories (model*.safetensors +
tokenizer.json) placed under config.checkpoint_dir/<model-name>/.  The port
does not load them yet; ``serving.engine.build_engine`` uses
``find_checkpoint`` to refuse a build that the reference would serve from
real weights.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def find_checkpoint(model_name: str, checkpoint_root: Path) -> Optional[Path]:
    """Locate a checkpoint dir for a model id like 'Qwen/Qwen2-VL-7B-Instruct'."""
    candidates = [
        checkpoint_root / model_name.replace("/", "__"),
        checkpoint_root / model_name.split("/")[-1],
        checkpoint_root / model_name,
    ]
    for cand in candidates:
        if cand.is_dir() and any(cand.glob("*.safetensors")):
            return cand
    return None


__all__ = ["find_checkpoint"]
