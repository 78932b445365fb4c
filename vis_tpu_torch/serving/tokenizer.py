"""Tokenization for the serving engine.

Two implementations behind one interface:
- HFTokenizer: wraps a `tokenizer.json` (HF tokenizers library, present in
  this environment) from a local checkpoint directory — the production path
  for real Qwen2-VL / Llama checkpoints.
- ByteTokenizer: self-contained byte-level vocabulary (256 bytes + special
  tokens) requiring no external files — used when running weightless
  (benchmarks, random-weight models, tests).  Real text round-trips exactly.

Both expose the special tokens the multimodal prompt builder needs
(vision_start / image / vision_end / eos).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    vocab_size: int
    eos_id: int
    image_token_id: int
    vision_start_id: int
    vision_end_id: int

    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """Byte-level tokenizer: ids 0-255 are raw bytes; specials follow."""

    def __init__(self, vocab_size: Optional[int] = None):
        self.eos_id = 256
        self.bos_id = 257
        self.pad_id = 258
        self.vision_start_id = 259
        self.vision_end_id = 260
        self.image_token_id = 261
        self.vocab_size = max(vocab_size or 0, 262)

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """Wraps a local `tokenizer.json` with Qwen2-VL / Llama special tokens."""

    # Qwen2-VL vocabulary ids (model-card constants).
    _QWEN_SPECIALS = {
        "eos": "<|im_end|>",
        "vision_start": "<|vision_start|>",
        "vision_end": "<|vision_end|>",
        "image": "<|image_pad|>",
    }
    _LLAMA_SPECIALS = {
        "eos": "<|eot_id|>",
        "vision_start": "<|image|>",
        "vision_end": "<|image|>",
        "image": "<|image|>",
    }

    def __init__(self, tokenizer_file: Path):
        from tokenizers import Tokenizer as _RustTokenizer

        self._tok = _RustTokenizer.from_file(str(tokenizer_file))
        self.vocab_size = self._tok.get_vocab_size(with_added_tokens=True)

        def tid(token: str, default: int) -> int:
            value = self._tok.token_to_id(token)
            return value if value is not None else default

        specials = (
            self._QWEN_SPECIALS
            if self._tok.token_to_id("<|vision_start|>") is not None
            else self._LLAMA_SPECIALS
        )
        self.eos_id = tid(specials["eos"], tid("</s>", 2))
        self.vision_start_id = tid(specials["vision_start"], 0)
        self.vision_end_id = tid(specials["vision_end"], 0)
        self.image_token_id = tid(specials["image"], 0)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def load_tokenizer(checkpoint_dir: Optional[Path]) -> Tokenizer:
    """HF tokenizer when the checkpoint ships one; byte-level otherwise."""
    if checkpoint_dir is not None:
        tok_file = Path(checkpoint_dir) / "tokenizer.json"
        if tok_file.exists():
            return HFTokenizer(tok_file)
    return ByteTokenizer()


__all__ = ["Tokenizer", "ByteTokenizer", "HFTokenizer", "load_tokenizer"]
