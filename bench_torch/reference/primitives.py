"""The plain references' shared pieces: rounding, dequantization, blocked
attention and rotary tables.

Each model family's reference (``families/<model_type>.py``) is written
from its published description with these, in plain torch operations: no
kernel, cache or batching of the program, and nothing imported from it.
Weights are the benchmark's own seeded leaves (``harness/weights.py``)
dequantized here: an int4 weight is (n - 8) * s over split halves, an int8
table q * s.

``Precision`` says how every product's inputs are rounded: ``EXACT`` keeps
float32 (TF32 must be off: ``exact_matmuls()``), ``FP8`` rounds each
operand to float8 e4m3 with a per-row scale, the control that the check
must refuse.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence

import torch


@contextlib.contextmanager
def exact_matmuls():
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Precision:
    """The rounding applied to the operands of every product."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


EXACT = Precision("fp32")
FP8 = Precision("fp8")


def dequant(leaf: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A quantized leaf -> float32 weight [..., out, in]."""
    if "q4" in leaf:
        p = leaf["q4"].to(torch.int32)
        s = leaf["s"].to(torch.float32)
        lo = ((p & 15) - 8).to(torch.float32) * s[..., 0:1]
        hi = ((p >> 4) - 8).to(torch.float32) * s[..., 1:2]
        return torch.cat([lo, hi], dim=-1)
    return leaf["q8"].to(torch.float32) * leaf["s"].to(torch.float32)[..., None]


def embed_rows(leaf: Dict[str, torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    return dequant({k: v[ids] for k, v in leaf.items()})


def lin(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
        prec: Precision) -> torch.Tensor:
    y = prec(x) @ prec(w).T
    return y if bias is None else y + bias.to(torch.float32)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.to(torch.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def attention(q, k, v, mask_fn, prec: Precision, block: int = 512) -> torch.Tensor:
    """q [n, H, d], k/v [m, KV, d]; ``mask_fn(rows) -> bool [len(rows), m]``
    (True = visible).  Query rows in blocks, float32 softmax."""
    n, heads, d = q.shape
    rep = heads // k.shape[1]
    kk = prec(k).repeat_interleave(rep, dim=1)
    vv = v.repeat_interleave(rep, dim=1)
    qq = prec(q)
    out = torch.empty_like(q)
    for start in range(0, n, block):
        rows = torch.arange(start, min(start + block, n), device=q.device)
        logits = torch.einsum("qhd,khd->hqk", qq[rows], kk) / math.sqrt(d)
        logits = logits.masked_fill(~mask_fn(rows)[None], float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out[rows] = torch.einsum("hqk,khd->qhd", prec(probs), prec(vv))
    return out


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                sections: Optional[Sequence[int]] = None):
    """cos/sin [n, head_dim] for positions [n] or, with ``sections``, [len(sections), n]:
    the frequency bands of each half take their angles from position stream i in
    turn, ``sections[i]`` bands each (Qwen2-VL's multimodal rotary, M-RoPE)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                        device=positions.device) / head_dim))
    if sections is None:
        ang = positions.to(torch.float64)[:, None] * inv[None]
    else:
        stream = torch.cat([torch.full((s,), i, dtype=torch.long)
                            for i, s in enumerate(sections)]).to(positions.device)
        ang = positions.to(torch.float64)[stream, :].T * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)


__all__ = [
    "EXACT", "FP8", "Precision", "attention", "dequant", "embed_rows", "exact_matmuls", "lin",
    "rms_norm", "rope_tables", "rotate_half",
]
