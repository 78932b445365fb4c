"""Family ``mistral`` (Mistral-7B, and the Llama 3.x text decoder it
shares its code path with): the dense GQA text decoder alone."""

from bench_torch.families._dense_gqa import (  # noqa: F401
    decode_bytes, decode_flops, finish_weights, input_flops, logits, plan_weights,
    prefill_flops, program_config, sequence,
)

__all__ = [
    "decode_bytes", "decode_flops", "finish_weights", "input_flops", "logits", "plan_weights",
    "prefill_flops", "program_config", "sequence",
]
