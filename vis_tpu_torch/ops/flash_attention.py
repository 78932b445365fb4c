"""Flash attention (kernel C) and its plain PyTorch version.

Counterpart of ``vis_tpu/ops/flash_attention.py``: the same ``[b, s, h, d]``
API with per-batch valid KV ``lengths``, optional ``causal`` masking and
``sm_scale``.  On a CUDA tensor ``flash_attention`` launches the hand-written
kernel in ``csrc/flash_attention.cu`` (bf16 only, sequence lengths a
multiple of ``BLOCK``, head_dim in ``HEAD_DIMS``) or raises; on a CPU tensor
it runs ``flash_attention_reference``.  ``flash_attention.launches`` counts
kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from vis_tpu_torch.ops import _kernels

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
BLOCK = 64
HEAD_DIMS = (64, 80)  # the Qwen2.5-VL towers: 80 at 7B, 64 in the small profile


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, *,
    causal: bool = False, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Unfused attention with the kernel's masking law; a query row with no
    valid key gives 0, as the kernel's does."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    logits = torch.einsum(
        "bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)
    ) * scale
    cols = torch.arange(skv, device=q.device)
    mask = torch.ones((b, 1, sq, skv), dtype=torch.bool, device=q.device)
    if lengths is not None:
        mask = mask & (cols[None, None, None, :] < lengths.to(q.device)[:, None, None, None])
    if causal:
        rows = torch.arange(sq, device=q.device)
        mask = mask & (cols[None, None, None, :] <= rows[None, None, :, None])
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    return out.to(q.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None, *,
    causal: bool = False, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Tiled attention. q [b, sq, h, d]; k/v [b, skv, h, d]; lengths [b]
    valid KV lengths (None = all valid).  Padded query rows come back as
    rows the caller slices off."""
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, lengths, causal=causal, sm_scale=sm_scale
        )

    b, sq, h, d = q.shape
    skv = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bf16, got {name} {t.dtype}")
        if t.device != q.device:
            raise ValueError("flash_attention operands must share one device")
    if k.shape != (b, skv, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS or sq % BLOCK or skv % BLOCK:
        raise ValueError(
            f"flash_attention kernel needs head_dim in {HEAD_DIMS} and "
            f"sequence lengths that are multiples of {BLOCK}; got d={d}, "
            f"sq={sq}, skv={skv}"
        )
    scale = sm_scale if sm_scale is not None else d ** -0.5
    if scale < 0:  # the kernel's running max is over raw scores: fold the sign into q
        q, scale = -q, -scale
    if lengths is None:
        lengths = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()  # the kernel's 16-byte copies
               for t in (q.contiguous(), k.contiguous(), v.contiguous()))
    out = torch.empty_like(q)
    lib = _kernels.library()
    with torch.cuda.device(q.device):
        err = lib.vt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), b, sq, skv, h, d, float(scale), int(causal),
            _kernels.stream_of(q),
        )
    _kernels.check(err, "vt_flash_attention")
    _kernels.count_launch(flash_attention)
    return out


flash_attention.launches = 0


def row_relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest max|got - want| / max|want| over the rows of the last
    axis, the measure the kernel is held to against its plain version: bf16
    rounds each output to a share of its own size, so the bound scales with
    the row.  A row the reference holds at 0 must come back 0."""
    err = (got.float() - want.float()).abs().amax(-1)
    ref = want.float().abs().amax(-1)
    return (err / ref.clamp_min(torch.finfo(torch.float32).tiny)).max().item()


__all__ = ["flash_attention", "flash_attention_reference", "row_relative_error", "NEG_INF"]
