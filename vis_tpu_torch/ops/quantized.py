"""Weight-only quantization and its matmul kernels: int4 (A and B), int8 (D).

Counterpart of ``vis_tpu/ops/quantized.py``.  Int4 has the same byte layout:
``q [out, in//2]`` u8 packs input j (low nibble) and input j + in//2 (high
nibble), both stored as value+8; ``scale [out, 2]`` f32 holds one scale per
output row per input half; vocab tables pad their rows with zeros.

The matmul semantics are the JAX package's dequantized path: x rounded to
bf16, the weight dequantized to bf16 (``unpack_int4``), products summed in
f32, f32 out.  Two kernels carry it on the card (``csrc/q4_matmul.cu``):

- ``q4_matmul`` (kernel B, TPU ``_q4_matmul_kernel``): one weight, the
  int4 vocab head;
- ``q4_matmul_stacked`` (kernel A, TPU ``_q4_stacked_kernel``): layer
  ``idx`` of a stacked ``[L, out, in//2]`` weight, every decoder projection
  of a decode window.

Int8 (``QuantizedWeight``: q [out, in] int8, scale [out] f32, per output
row) has the TPU kernel's semantics, not the JAX CPU fallback's: x rounded
to bf16, products of x and the exact int8 value summed in f32, and the sum
multiplied by ``scale[o]`` afterwards.  Kernel D carries it on the card
(``csrc/q8_matmul.cu``):

- ``q8_matmul`` (kernel D, TPU ``_q8_matmul_kernel``): the explainer's int8
  vocab head.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor (or raises); ``launches`` counts the kernel
launches.  Dispatch follows the JAX package's shape rule: the kernels take
at most ``MAX_KERNEL_ROWS`` rows and a row length that is a multiple of 16
bytes (their 16-byte loads); other inputs (prefill, the vision tower)
dequantize the weight and call ``torch.matmul``, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

MAX_KERNEL_ROWS = 128


def unpack_int4(packed: torch.Tensor, scales: torch.Tensor,
                dtype=torch.bfloat16) -> torch.Tensor:
    """[..., half] packed bytes + [..., 2] scales -> [..., 2*half] weights."""
    p = packed.to(torch.int32)
    lo = ((p & 15) - 8).to(torch.float32) * scales[..., 0:1]
    hi = (((p >> 4) & 15) - 8).to(torch.float32) * scales[..., 1:2]
    return torch.cat([lo, hi], dim=-1).to(dtype)


@dataclasses.dataclass
class QuantizedWeight4:
    """Split-half packed symmetric int4 weight: q [out, in//2] u8,
    scale [out, 2] f32."""

    q: torch.Tensor
    scale: torch.Tensor


@dataclasses.dataclass
class QuantizedWeight4Pick:
    """Layer ``idx`` of stacked int4 weights (q [L, out, in//2], scale
    [L, out, 2]); ``linear`` routes it to kernel A."""

    q: torch.Tensor
    scale: torch.Tensor
    idx: int


def quantize_weight4(w: torch.Tensor, pad_out_multiple: int = 1) -> QuantizedWeight4:
    """Symmetric int4 quantization with per-(row, input-half) scales; the
    same bytes as ``vis_tpu.ops.quantized.quantize_weight4``."""
    w32 = w.to(torch.float32)
    out, inn = w32.shape
    if inn % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {inn}")
    half = inn // 2
    w_lo, w_hi = w32[:, :half], w32[:, half:]
    s_lo = torch.clamp_min(w_lo.abs().amax(dim=1), 1e-8) / 7.0
    s_hi = torch.clamp_min(w_hi.abs().amax(dim=1), 1e-8) / 7.0
    q_lo = torch.clamp(torch.round(w_lo / s_lo[:, None]), -7, 7) + 8
    q_hi = torch.clamp(torch.round(w_hi / s_hi[:, None]), -7, 7) + 8
    packed = q_lo.to(torch.uint8) | (q_hi.to(torch.uint8) << 4)
    scale = torch.stack([s_lo, s_hi], dim=1)
    if pad_out_multiple > 1 and out % pad_out_multiple:
        pad = pad_out_multiple - out % pad_out_multiple
        packed = torch.nn.functional.pad(packed, (0, 0, 0, pad))
        scale = torch.nn.functional.pad(scale, (0, 0, 0, pad))
    return QuantizedWeight4(q=packed, scale=scale)


def q4_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernels A and B: x [B, I] . W^T -> [B, O] f32."""
    w = unpack_int4(q, scale, torch.bfloat16).to(torch.float32)
    return x.to(torch.bfloat16).to(torch.float32) @ w.T


def _check_kernel_args(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor):
    if q.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(f"int4 kernel wants u8 q / f32 scale, got {q.dtype} / {scale.dtype}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int4 kernel needs contiguous q and scale (a layer view of a stack is)")
    if x.device != q.device or scale.device != q.device:
        raise ValueError("int4 kernel operands must share one device")
    batch, in_dim = x.shape
    out_dim, half = q.shape
    if in_dim != 2 * half or scale.shape != (out_dim, 2):
        raise ValueError(f"int4 kernel shapes disagree: x {tuple(x.shape)}, q {tuple(q.shape)}, scale {tuple(scale.shape)}")
    if half % 16 or q.data_ptr() % 16:
        raise ValueError("int4 kernel reads 16 bytes per lane: in//2 and q's address must be multiples of 16")
    if not 1 <= batch <= MAX_KERNEL_ROWS:
        raise ValueError(f"int4 kernel takes 1..{MAX_KERNEL_ROWS} rows, got {batch}")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    return xb


def _launch_q4(entry: str, x: torch.Tensor, q: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    from vis_tpu_torch.ops import _kernels

    xb = _check_kernel_args(x, q, scale)
    out_dim, half = q.shape
    y = torch.empty((x.shape[0], out_dim), dtype=torch.float32, device=x.device)
    lib = _kernels.library()
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(
            xb.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
            x.shape[0], out_dim, half, _kernels.stream_of(x),
        )
    _kernels.check(err, entry)
    return y


def q4_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel B wrapper: x [B, I] . W^T for one int4 weight -> [B, O] f32."""
    if x.device.type == "cpu":
        return q4_matmul_plain(x, q, scale)
    y = _launch_q4("vt_q4_matmul", x, q, scale)
    q4_matmul.launches += 1
    return y


q4_matmul.launches = 0


def q4_matmul_stacked(x: torch.Tensor, pick: QuantizedWeight4Pick) -> torch.Tensor:
    """Kernel A wrapper: x [B, I] . W[idx]^T for a stacked int4 weight. The
    layer is a view of the stack (``q[idx]``), so nothing is copied."""
    q, scale = pick.q[pick.idx], pick.scale[pick.idx]
    if x.device.type == "cpu":
        return q4_matmul_plain(x, q, scale)
    y = _launch_q4("vt_q4_matmul_stacked", x, q, scale)
    q4_matmul_stacked.launches += 1
    return y


q4_matmul_stacked.launches = 0


def quantized_matmul4(x: torch.Tensor, qw: QuantizedWeight4) -> torch.Tensor:
    """x [B, I] . qw^T -> [B, O] f32."""
    if x.shape[0] > MAX_KERNEL_ROWS or qw.q.shape[1] % 16:
        return q4_matmul_plain(x, qw.q, qw.scale)  # dequantize + one matmul
    return q4_matmul(x, qw.q, qw.scale)


def quantized_matmul4_stacked(x: torch.Tensor, pick: QuantizedWeight4Pick) -> torch.Tensor:
    """x [B, I] . stacked_q[idx]^T -> [B, O] f32."""
    if x.shape[0] > MAX_KERNEL_ROWS or pick.q.shape[2] % 16:
        return q4_matmul_plain(x, pick.q[pick.idx], pick.scale[pick.idx])
    return q4_matmul_stacked(x, pick)


def _linear(x, matmul, weight, out_dim, bias):
    lead = x.shape[:-1]
    y = matmul(x.reshape(-1, x.shape[-1]), weight)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.reshape(*lead, out_dim).to(x.dtype)


def quantized_linear4(x: torch.Tensor, qw: QuantizedWeight4,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _linear(x, quantized_matmul4, qw, qw.q.shape[0], bias)


def quantized_linear4_stacked(x: torch.Tensor, pick: QuantizedWeight4Pick,
                              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _linear(x, quantized_matmul4_stacked, pick, pick.q.shape[1], bias)


def embed_rows4(table: QuantizedWeight4, token_ids: torch.Tensor) -> torch.Tensor:
    """Embedding gather from a packed int4 table, dequantized to bf16."""
    return unpack_int4(table.q[token_ids], table.scale[token_ids])


# ---------------------------------------------------------------------------
# Int8 (kernel D)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedWeight:
    """Per-output-row symmetric int8 weight: q [out, in] int8, scale [out]
    f32, w ~ q * scale[:, None]."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.scale[:, None]).to(dtype)


def quantize_weight(w: torch.Tensor, pad_out_multiple: int = 1) -> QuantizedWeight:
    """Symmetric per-row int8 quantization; the same bytes as
    ``vis_tpu.ops.quantized.quantize_weight``.  ``pad_out_multiple`` pads the
    rows with zeros (scale 0, so their outputs are exactly 0)."""
    w32 = w.to(torch.float32)
    scale = torch.clamp_min(w32.abs().amax(dim=1), 1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127).to(torch.int8)
    out = q.shape[0]
    if pad_out_multiple > 1 and out % pad_out_multiple:
        pad = pad_out_multiple - out % pad_out_multiple
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
        scale = torch.nn.functional.pad(scale, (0, pad))
    return QuantizedWeight(q=q, scale=scale)


def q8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel D: (bf16(x) . q^T, f32 sums) * scale
    -> [B, O] f32."""
    return (x.to(torch.bfloat16).to(torch.float32) @ q.to(torch.float32).T) * scale


def q8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel D wrapper: x [B, I] . q^T * scale for an int8 weight -> [B, O] f32."""
    if x.device.type == "cpu":
        return q8_matmul_plain(x, q, scale)
    from vis_tpu_torch.ops import _kernels

    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8 kernel wants i8 q / f32 scale, got {q.dtype} / {scale.dtype}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8 kernel needs contiguous q and scale")
    if x.device != q.device or scale.device != q.device:
        raise ValueError("int8 kernel operands must share one device")
    batch, in_dim = x.shape
    out_dim = q.shape[0]
    if q.shape != (out_dim, in_dim) or scale.shape != (out_dim,):
        raise ValueError(f"int8 kernel shapes disagree: x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}, scale {tuple(scale.shape)}")
    if in_dim % 16 or q.data_ptr() % 16:
        raise ValueError("int8 kernel reads 16 bytes per lane: in and q's address "
                         "must be multiples of 16")
    if not 1 <= batch <= MAX_KERNEL_ROWS:
        raise ValueError(f"int8 kernel takes 1..{MAX_KERNEL_ROWS} rows, got {batch}")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    y = torch.empty((batch, out_dim), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels.library().vt_q8_matmul(
            xb.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
            batch, out_dim, in_dim, _kernels.stream_of(x),
        )
    _kernels.check(err, "vt_q8_matmul")
    q8_matmul.launches += 1
    return y


q8_matmul.launches = 0


def quantized_matmul(x: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """x [B, I] . qw^T -> [B, O] f32, dispatched as the JAX package does on
    the TPU: kernel D for 1..MAX_KERNEL_ROWS rows when O and I are
    multiples of 128 (its tile rule); otherwise the weight is dequantized to
    bf16 and one f32-summed matmul runs, the JAX package's XLA path."""
    out_dim, in_dim = qw.q.shape
    if x.shape[0] > MAX_KERNEL_ROWS or out_dim % 128 or in_dim % 128:
        return x.to(torch.bfloat16).to(torch.float32) @ qw.dequantize().to(torch.float32).T
    return q8_matmul(x, qw.q, qw.scale)


def quantized_linear(x: torch.Tensor, qw: QuantizedWeight,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _linear(x, quantized_matmul, qw, qw.q.shape[0], bias)


def embed_rows8(table: QuantizedWeight, token_ids: torch.Tensor) -> torch.Tensor:
    """Embedding gather from an int8 table, dequantized to bf16."""
    return (table.q[token_ids].to(torch.float32) * table.scale[token_ids][..., None]).to(
        torch.bfloat16)


__all__ = [
    "MAX_KERNEL_ROWS",
    "QuantizedWeight",
    "QuantizedWeight4",
    "QuantizedWeight4Pick",
    "embed_rows4",
    "embed_rows8",
    "q4_matmul",
    "q4_matmul_plain",
    "q4_matmul_stacked",
    "q8_matmul",
    "q8_matmul_plain",
    "quantize_weight",
    "quantize_weight4",
    "quantized_linear",
    "quantized_linear4",
    "quantized_linear4_stacked",
    "quantized_matmul",
    "quantized_matmul4",
    "quantized_matmul4_stacked",
    "unpack_int4",
]
