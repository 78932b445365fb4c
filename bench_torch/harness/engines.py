"""The system under test, built from a configuration file.

The program's ``Engine`` (``vis_tpu_torch.serving.engine``), given the
benchmark's seeded weights in the program's serving layout, the
configuration's sizes, the byte-level tokenizer and the serving settings
that the environment (the configuration's ``serving`` section) gives the
program's config.  The port is imported here, after ``run.py`` has set
that environment.
"""

from __future__ import annotations

from typing import Any, Dict

from bench_torch.harness.weights import make_weights


def _program_leaves(tree):
    from vis_tpu_torch.ops.quantized import QuantizedWeight, QuantizedWeight4

    if isinstance(tree, dict):
        if "q4" in tree:
            return QuantizedWeight4(q=tree["q4"], scale=tree["s"])
        if "q8" in tree:
            return QuantizedWeight(q=tree["q8"], scale=tree["s"])
        return {k: _program_leaves(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_program_leaves(v) for v in tree]
    return tree


def program_config(model: Dict[str, Any]):
    from vis_tpu_torch.models.common.decoder import DecoderConfig

    rope = model.get("rope_scaling") or {}
    text = DecoderConfig(
        vocab_size=model["vocab_size"], hidden_size=model["hidden_size"],
        num_layers=model["num_hidden_layers"], num_heads=model["num_attention_heads"],
        num_kv_heads=model["num_key_value_heads"],
        intermediate_size=model["intermediate_size"], head_dim=model.get("head_dim"),
        rope_theta=float(model["rope_theta"]), rms_norm_eps=float(model["rms_norm_eps"]),
        qkv_bias=bool(model.get("qkv_bias", False)),
        mrope_section=tuple(rope["mrope_section"]) if "mrope_section" in rope else None,
        tie_word_embeddings=bool(model.get("tie_word_embeddings", False)),
    )
    vc = model.get("vision_config")
    if vc is None:
        return text
    from vis_tpu_torch.models.qwen2_5_vl.config import Qwen25VisionConfig, Qwen25VLConfig

    return Qwen25VLConfig(
        vision=Qwen25VisionConfig(
            depth=vc["depth"], hidden_size=vc["hidden_size"],
            intermediate_size=vc["intermediate_size"], num_heads=vc["num_heads"],
            in_channels=vc["in_chans"], patch_size=vc["patch_size"],
            temporal_patch_size=vc["temporal_patch_size"],
            spatial_merge_size=vc["spatial_merge_size"],
            out_hidden_size=vc["out_hidden_size"], window_size=vc["window_size"],
            fullatt_block_indexes=tuple(vc["fullatt_block_indexes"]),
        ),
        text=text, image_token_id=model["image_token_id"],
        vision_start_token_id=model["vision_start_token_id"],
        vision_end_token_id=model["vision_end_token_id"],
        eos_token_id=model["eos_token_id"],
    )


def build_engine(model: Dict[str, Any], role: str, seed: int, device):
    """An ``Engine`` for ``role`` with weights from ``seed``; a scheduler is
    attached where the serving settings batch the role."""
    from vis_tpu_torch.serving.engine import Engine, ServingSettings
    from vis_tpu_torch.serving.tokenizer import ByteTokenizer
    from vis_tpu_torch.utils.config import config as app_config

    params = _program_leaves(make_weights(model, seed, device))
    engine = Engine(f"bench-{role}", program_config(model), params,
                    ByteTokenizer(vocab_size=model["vocab_size"]), device,
                    ServingSettings.from_app_config())
    roles = {r.strip() for r in app_config.batching_roles.split(",") if r.strip()}
    if app_config.continuous_batching and ("all" in roles or role in roles):
        engine.attach_scheduler()
    return engine


def release_engine(engine) -> None:
    if getattr(engine, "scheduler", None) is not None:
        engine.detach_scheduler()
    engine.params = None


__all__ = ["build_engine", "program_config", "release_engine"]
