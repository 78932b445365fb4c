"""The int8 probe's integer dot products and their kernels (L, M, O, P).

Counterparts of the Pallas kernels of ``tools/probe_unpack2.py``, which asks
whether quantized weights can skip the per-byte cast to bf16; the port's
tool is ``vis_tpu_torch.tools.probe_unpack2``.  Four wrappers, each with its
plain PyTorch version beside it and its kernel in ``csrc/int_dot.cu``:

- ``u8_sum`` (kernel L, ``_stream_kernel``): the sum of every byte of a u8
  tensor as int32, wrapping mod 2^32, shape [1, 1];
- ``i8_matmul`` (kernel M, ``_i8dot_kernel``): int8 x [B, K] . int8 w
  [O, K]^T with exact int32 sums, then f32(y) * scale[0] (scale [1, O]);
- ``q4_i8_matmul`` (kernel O, ``_q4i8_kernel``) and ``q4_i8s_matmul``
  (kernel P, ``_q4i8s_kernel``): int8 x [B, K] against split-half packed
  int4 q [O, K/2] (byte j: input j in the low nibble, input K/2 + j in the
  high one), two int32 sums, then f32(y_lo) * scale[0] + f32(y_hi) *
  scale[1] (scale [2, O]).  O reads a nibble n as n - 8, P as its
  two's-complement value.

The probe's fifth kernel, N (``_mixdot_kernel``, bf16 x times int8 w with
f32 sums, then the scale), is kernel D's function: the tool runs it on
``quantized.q8_matmul``.  ``quant_act`` is the probe's per-row activation
quantizer, copied.

Each wrapper runs its plain version for a CPU tensor and launches its kernel
for a CUDA tensor, or raises on what the kernel does not take; ``launches``
counts the launches.  The plain versions also run on the card (the smoke
script compares them with the kernels there), where torch has no integer
matmul: they take the integer dot in float64, exact below 2^53, and the
epilogue as separate convert, multiply and add, which is what the kernels'
rounded (never fused) epilogue computes, bit for bit.
"""

from __future__ import annotations

import torch

from vis_tpu_torch.ops import _kernels
from vis_tpu_torch.ops.quantized import MAX_KERNEL_ROWS


def quant_act(h: torch.Tensor):
    """Per-row dynamic int8 quantization (the probe's ``quant_act``):
    s = max(max|h|, 1e-6) / 127 in h's type, codes clip(round(h / s), -127,
    127) as int8.  For bf16 h, s and h / s are bf16, as in the probe."""
    s = h.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
    return torch.clamp(torch.round(h / s), -127, 127).to(torch.int8), s


def wrap_int32(total: torch.Tensor) -> torch.Tensor:
    """An integer tensor taken mod 2^32 into int32's range, as int32."""
    return ((total.to(torch.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def u8_sum_plain(q: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel L: the bytes summed in int64, then wrapped."""
    return wrap_int32(q.sum(dtype=torch.int64)).reshape(1, 1)


def u8_sum(q: torch.Tensor) -> torch.Tensor:
    """Kernel L wrapper: the sum of every byte of q (u8, contiguous, a
    multiple of 16 bytes at a 16-byte aligned address) as int32 [1, 1],
    wrapping mod 2^32."""
    if q.device.type == "cpu":
        return u8_sum_plain(q)

    if q.dtype != torch.uint8:
        raise TypeError(f"byte sum wants u8, got {q.dtype}")
    if not q.is_contiguous():
        raise ValueError("byte sum needs a contiguous tensor")
    if q.numel() < 16 or q.numel() % 16 or q.data_ptr() % 16:
        raise ValueError("byte sum reads 16 bytes per lane: the size and the address must be "
                         "multiples of 16")
    out = torch.empty((1, 1), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernels.library().vt_u8_sum(q.data_ptr(), q.numel(), out.data_ptr(),
                                           _kernels.stream_of(q))
    _kernels.check(err, "vt_u8_sum")
    _kernels.count_launch(u8_sum)
    return out


u8_sum.launches = 0


def _int_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, K] . w [O, K]^T for integer tensors, exactly, as int32."""
    return (x.double() @ w.double().T).to(torch.int32)


def offset_nibbles(q: torch.Tensor):
    """Kernel O's reading of split-half packed bytes: (b & 15) - 8 and
    (b >> 4) - 8, as int32."""
    p = q.to(torch.int32)
    return (p & 15) - 8, (p >> 4) - 8


def signed_nibbles(q: torch.Tensor):
    """Kernel P's reading: each nibble as a two's-complement int4, as the
    probe's (int8(b) << 4) >> 4 and int8(b) >> 4, as int32."""
    b = q.view(torch.int8).to(torch.int32)
    return ((b & 15) ^ 8) - 8, b >> 4


def i8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel M: f32(x . q^T) * scale[0] -> [B, O] f32."""
    return _int_dot(x, q).to(torch.float32) * scale[0]


def _q4_i8_plain(x, q, scale, nibbles) -> torch.Tensor:
    half = q.shape[-1]
    w_lo, w_hi = nibbles(q)
    y_lo = _int_dot(x[:, :half], w_lo).to(torch.float32)
    y_hi = _int_dot(x[:, half:], w_hi).to(torch.float32)
    return y_lo * scale[0] + y_hi * scale[1]


def q4_i8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel O -> [B, O] f32."""
    return _q4_i8_plain(x, q, scale, offset_nibbles)


def q4_i8s_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel P -> [B, O] f32."""
    return _q4_i8_plain(x, q, scale, signed_nibbles)


def _launch(entry: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            q_dtype: torch.dtype, scale_rows: int) -> torch.Tensor:
    """Checks the operands of an int8-activation matvec (x [B, scale_rows *
    W], q [O, W] of ``q_dtype``, scale [scale_rows, O] f32) and launches
    ``entry``; returns y [B, O] f32."""

    if x.dtype != torch.int8 or q.dtype != q_dtype or scale.dtype != torch.float32:
        raise TypeError(f"{entry} wants int8 x / {q_dtype} q / f32 scale, got {x.dtype} / "
                        f"{q.dtype} / {scale.dtype}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{entry} needs contiguous q and scale (a layer view of a stack is)")
    if x.device != q.device or scale.device != q.device:
        raise ValueError(f"{entry} operands must share one device")
    batch, in_dim = x.shape
    out_dim, width = q.shape
    if in_dim != scale_rows * width or scale.shape != (scale_rows, out_dim):
        raise ValueError(f"{entry} shapes disagree: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if width % 16 or q.data_ptr() % 16:
        raise ValueError(f"{entry} reads 16 bytes per lane: q's row length and address must "
                         "be multiples of 16")
    if not 1 <= batch <= MAX_KERNEL_ROWS:
        raise ValueError(f"{entry} takes 1..{MAX_KERNEL_ROWS} rows, got {batch}")
    xc = x.contiguous()
    if xc.data_ptr() % 16:
        xc = xc.clone()
    y = torch.empty((batch, out_dim), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(_kernels.library(), entry)(
            xc.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
            batch, out_dim, width, _kernels.stream_of(x))
    _kernels.check(err, entry)
    return y


def i8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel M wrapper: int8 x [B, K] . int8 q [O, K]^T, scale [1, O] ->
    [B, O] f32."""
    if x.device.type == "cpu":
        return i8_matmul_plain(x, q, scale)
    y = _launch("vt_i8_matmul", x, q, scale, torch.int8, 1)
    _kernels.count_launch(i8_matmul)
    return y


i8_matmul.launches = 0


def q4_i8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel O wrapper: int8 x [B, K] against split-half int4 q [O, K/2]
    read as n - 8, scale [2, O] -> [B, O] f32."""
    if x.device.type == "cpu":
        return q4_i8_matmul_plain(x, q, scale)
    y = _launch("vt_q4_i8_matmul", x, q, scale, torch.uint8, 2)
    _kernels.count_launch(q4_i8_matmul)
    return y


q4_i8_matmul.launches = 0


def q4_i8s_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel P wrapper: as ``q4_i8_matmul`` with each nibble read as a
    two's-complement int4."""
    if x.device.type == "cpu":
        return q4_i8s_matmul_plain(x, q, scale)
    y = _launch("vt_q4_i8s_matmul", x, q, scale, torch.uint8, 2)
    _kernels.count_launch(q4_i8s_matmul)
    return y


q4_i8s_matmul.launches = 0


__all__ = [
    "i8_matmul",
    "i8_matmul_plain",
    "offset_nibbles",
    "q4_i8_matmul",
    "q4_i8_matmul_plain",
    "q4_i8s_matmul",
    "q4_i8s_matmul_plain",
    "quant_act",
    "signed_nibbles",
    "u8_sum",
    "u8_sum_plain",
    "wrap_int32",
]
