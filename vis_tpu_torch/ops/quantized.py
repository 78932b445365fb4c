"""Weight-only quantization and its kernels: int4 (A and B), int8 (D, E),
and the int4 probe tools' kernels (F, H, I, J, K).

Counterpart of ``vis_tpu/ops/quantized.py``.  Int4 has the same byte layout:
``q [out, in//2]`` u8 packs input j (low nibble) and input j + in//2 (high
nibble), both stored as value+8; ``scale [out, 2]`` f32 holds one scale per
output row per input half; vocab tables pad their rows with zeros.

The matmul semantics are the JAX package's dequantized path: x rounded to
bf16, the weight dequantized to bf16 (``unpack_int4``), products summed in
f32, f32 out.  One tensor-core matvec carries it on the card
(``csrc/q4_matmul.cu``, ``q4_stacked_mma_kernel``), behind two wrappers:

- ``q4_matmul`` (kernel B, TPU ``_q4_matmul_kernel``): one weight, the
  int4 vocab head;
- ``q4_matmul_stacked`` (kernel A, TPU ``_q4_stacked_kernel``): layer
  ``idx`` of a stacked ``[L, out, in//2]`` weight, every decoder projection
  of a decode window.

Int8 (``QuantizedWeight``: q [out, in] int8, scale [out] f32, per output
row) has the TPU kernel's semantics, not the JAX CPU fallback's: x rounded
to bf16, products of x and the exact int8 value summed in f32, and the sum
multiplied by ``scale[o]`` afterwards.  One int8 tensor-core matvec carries
it on the card (``csrc/q8_matmul.cu``, ``q8_mma_kernel``), behind two
wrappers:

- ``q8_matmul`` (kernel D, TPU ``_q8_matmul_kernel``): int8 vocab heads and,
  under QUANTIZATION=int8, every decoder's qkv and o projections;
- ``fused_swiglu_mlp`` (kernel E, TPU ``_fused_mlp_kernel``, two launches
  of the matvec, the first gated): a whole int8 decoder MLP,
  down(silu(gate(x)) * up(x)), with h rounded to bf16 before the down
  product; ``fused_mlp_applies`` is the JAX package's dispatch rule for it.

The int4 probe tools (``vis_tpu_torch.tools``) add three functions:

- ``q4_matmul_folded`` / ``q4_matmul_stacked_folded`` (probe kernels J and
  I / F): the TPU kernels' folded function, (x_lo . n_lo - 8 sum x_lo) s_lo
  + (x_hi . n_hi - 8 sum x_hi) s_hi with n the unsigned nibble, bf16 x and
  f32 sums, the scale applied once after the sum (A and B instead round
  each (n - 8) * s to bf16).  Scales are the probes' layout ``[2, O]`` (the
  s_lo row, then the s_hi row).  On the card they run A's kernel in its
  folded form, which sums x_lo . (n_lo - 8) and x_hi . (n_hi - 8) apart, the
  same value in another order, and scales each after the sum;
- ``i4_matmul`` (probe kernel K): signed int4 stored as adjacent
  two's-complement nibbles (``pack_int4_adjacent``), one scale per output
  row; on the card A's kernel in its signed form, the row's scale applied
  once after the f32 sum;
- ``q4_fused_mlp_slab`` (probe kernel H): a whole int4 SwiGLU MLP over the
  probe's per-slab layout (``repack_slabs``); on the card A's kernel in a
  gated folded form (act, slab-major), then its folded form once per slab,
  then an ordered sum of the slabs' partial outputs.

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

import numpy as np
import torch

from vis_tpu_torch.ops import _kernels

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


def _check_kernel_args(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                       scale_shape=None):
    """Validates an int4 kernel's operands (``scale`` is [O, 2] unless
    ``scale_shape`` says otherwise) and returns x as contiguous bf16."""
    if q.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(f"int4 kernel wants u8 q / f32 scale, got {q.dtype} / {scale.dtype}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int4 kernel needs contiguous q and scale (a layer view of a stack is)")
    if x.device != q.device or scale.device != q.device:
        raise ValueError("int4 kernel operands must share one device")
    batch, in_dim = x.shape
    out_dim, half = q.shape
    if in_dim != 2 * half or scale.shape != (scale_shape or (out_dim, 2)):
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
               scale: torch.Tensor, scale_shape=None) -> torch.Tensor:

    xb = _check_kernel_args(x, q, scale, scale_shape)
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
    """Kernel B wrapper: x [B, I] . W^T for one int4 weight -> [B, O] f32
    (on the card, the launch kernel A makes for a one-layer stack)."""
    if x.device.type == "cpu":
        return q4_matmul_plain(x, q, scale)
    y = _launch_q4("vt_q4_matmul", x, q, scale)
    _kernels.count_launch(q4_matmul)
    return y


q4_matmul.launches = 0


def q4_matmul_stacked(x: torch.Tensor, pick: QuantizedWeight4Pick) -> torch.Tensor:
    """Kernel A wrapper: x [B, I] . W[idx]^T for a stacked int4 weight. The
    layer is a view of the stack (``q[idx]``), so nothing is copied."""
    q, scale = pick.q[pick.idx], pick.scale[pick.idx]
    if x.device.type == "cpu":
        return q4_matmul_plain(x, q, scale)
    y = _launch_q4("vt_q4_matmul", x, q, scale)
    _kernels.count_launch(q4_matmul_stacked)
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
    _kernels.count_launch(q8_matmul)
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


def mlp_block_size(inter: int, hidden: int) -> Optional[int]:
    """The TPU kernel's intermediate block (``vis_tpu`` ``_mlp_block_size``):
    the largest multiple of 128 that divides ``inter`` and keeps three int8
    weight blocks under 4 MB, or None.  The port keeps it only as the
    dispatch rule, so that kernel E runs exactly where the TPU ran its."""
    cap = (4 * 1024 * 1024) // max(1, 3 * hidden)
    for candidate in (1280, 1024, 896, 768, 640, 512, 384, 256, 128):
        if candidate <= cap and inter % candidate == 0:
            return candidate
    return None


def fused_mlp_applies(x: torch.Tensor, gateup: QuantizedWeight,
                      down: QuantizedWeight) -> bool:
    """The JAX package's rule for its fused int8 MLP kernel: at most
    MAX_KERNEL_ROWS rows, hidden % 128 == 0, an intermediate block exists,
    and down is [hidden, inter]."""
    rows = x.numel() // x.shape[-1]
    hidden = x.shape[-1]
    inter = gateup.q.shape[0] // 2
    return (rows <= MAX_KERNEL_ROWS and hidden % 128 == 0
            and mlp_block_size(inter, hidden) is not None
            and tuple(down.q.shape) == (hidden, inter))


def fused_swiglu_mlp_plain(x: torch.Tensor, gq: torch.Tensor, gs: torch.Tensor,
                           dq: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel E on x [B, H]: g and u are f32 sums
    of bf16(x) times the exact int8 gate / up rows (``gq`` [2I, H], gate
    rows first) times their scales, h = bf16(silu(g) * u), and
    y = (h . dq^T, f32 sums) * ds, cast to x's type."""
    inter = gq.shape[0] // 2
    gu = (x.to(torch.bfloat16).to(torch.float32) @ gq.to(torch.float32).T) * gs
    g, u = gu[:, :inter], gu[:, inter:]
    h = (g * torch.sigmoid(g) * u).to(torch.bfloat16).to(torch.float32)
    return ((h @ dq.to(torch.float32).T) * ds).to(x.dtype)


def fused_swiglu_mlp(x: torch.Tensor, gateup: QuantizedWeight,
                     down: QuantizedWeight) -> torch.Tensor:
    """Kernel E wrapper: down(silu(gate(x)) * up(x)) for x [..., H] with
    the fused int8 gateup [2I, H] (gate rows first) and down [H, I] ->
    [..., H] in x's type.  Runs the plain version for CPU tensors; on the
    card launches the kernel or raises on what it does not take."""
    lead, hidden = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, hidden)
    gq, gs, dq, ds = gateup.q, gateup.scale, down.q, down.scale
    if x.device.type == "cpu":
        return fused_swiglu_mlp_plain(flat, gq, gs, dq, ds).reshape(*lead, hidden)

    if any(t.dtype != torch.int8 for t in (gq, dq)) or any(
            t.dtype != torch.float32 for t in (gs, ds)):
        raise TypeError(f"fused int8 MLP wants i8 weights / f32 scales, got "
                        f"{gq.dtype}, {dq.dtype} / {gs.dtype}, {ds.dtype}")
    if not all(t.is_contiguous() for t in (gq, gs, dq, ds)):
        raise ValueError("fused int8 MLP needs contiguous weights and scales")
    if any(t.device != x.device for t in (gq, gs, dq, ds)):
        raise ValueError("fused int8 MLP operands must share one device")
    batch = flat.shape[0]
    inter = gq.shape[0] // 2
    if (gq.shape != (2 * inter, hidden) or gs.shape != (2 * inter,)
            or dq.shape != (hidden, inter) or ds.shape != (hidden,)):
        raise ValueError(f"fused int8 MLP shapes disagree: x {tuple(x.shape)}, gateup "
                         f"{tuple(gq.shape)}/{tuple(gs.shape)}, down {tuple(dq.shape)}/"
                         f"{tuple(ds.shape)}")
    if hidden % 16 or inter % 16 or gq.data_ptr() % 16 or dq.data_ptr() % 16:
        raise ValueError("fused int8 MLP reads 16 bytes per lane: hidden, inter and the "
                         "weights' addresses must be multiples of 16")
    if not 1 <= batch <= MAX_KERNEL_ROWS:
        raise ValueError(f"fused int8 MLP takes 1..{MAX_KERNEL_ROWS} rows, got {batch}")
    xb = flat.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    h = torch.empty((batch, inter), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((batch, hidden), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels.library().vt_q8_swiglu(
            xb.data_ptr(), gq.data_ptr(), gs.data_ptr(), dq.data_ptr(), ds.data_ptr(),
            h.data_ptr(), y.data_ptr(), batch, hidden, inter, _kernels.stream_of(x),
        )
    _kernels.check(err, "vt_q8_swiglu")
    _kernels.count_launch(fused_swiglu_mlp)
    return y.to(x.dtype).reshape(*lead, hidden)


fused_swiglu_mlp.launches = 0


def embed_rows8(table: QuantizedWeight, token_ids: torch.Tensor) -> torch.Tensor:
    """Embedding gather from an int8 table, dequantized to bf16."""
    return (table.q[token_ids].to(torch.float32) * table.scale[token_ids][..., None]).to(
        torch.bfloat16)


# ---------------------------------------------------------------------------
# The int4 probe tools' kernels: folded (F, I, J), signed int4 (K), fused
# int4 SwiGLU over slabs (H)
# ---------------------------------------------------------------------------

def _folded(xf: torch.Tensor, q: torch.Tensor, scale2: torch.Tensor) -> torch.Tensor:
    """The TPU kernels' folded int4 arithmetic: xf [B, 2*half] f32 (values of
    bf16), q [O, half] u8 split-half packed, scale2 [2, O] -> [B, O] f32,
    (x_lo . n_lo - 8 sum x_lo) s_lo + (x_hi . n_hi - 8 sum x_hi) s_hi."""
    half = q.shape[-1]
    p = q.to(torch.int32)
    x_lo, x_hi = xf[:, :half], xf[:, half:]
    y_lo = x_lo @ (p & 15).to(torch.float32).T - 8.0 * x_lo.sum(dim=1, keepdim=True)
    y_hi = x_hi @ (p >> 4).to(torch.float32).T - 8.0 * x_hi.sum(dim=1, keepdim=True)
    return y_lo * scale2[0] + y_hi * scale2[1]


def q4_matmul_folded_plain(x: torch.Tensor, q: torch.Tensor,
                           scale2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the folded kernels (probe F, I, J): x [B, I]
    rounded to bf16, q [O, I/2], scale2 [2, O] -> [B, O] f32."""
    return _folded(x.to(torch.bfloat16).to(torch.float32), q, scale2)


def q4_matmul_folded(x: torch.Tensor, q: torch.Tensor, scale2: torch.Tensor) -> torch.Tensor:
    """Probe kernels J and I (``_q4_matmul_kernel_folded``, ``flat_folded``):
    x [B, I] . W^T with the folded function for one int4 weight q [O, I/2]
    and scales [2, O] -> [B, O] f32 (on the card: kernel A's matvec, the
    low and high nibbles' sums of x . (n - 8) kept apart, then scaled)."""
    if x.device.type == "cpu":
        return q4_matmul_folded_plain(x, q, scale2)
    y = _launch_q4("vt_q4_matmul_folded", x, q, scale2, (2, q.shape[0]))
    _kernels.count_launch(q4_matmul_folded)
    return y


q4_matmul_folded.launches = 0


def q4_matmul_stacked_folded(x: torch.Tensor, q_stacked: torch.Tensor,
                             scale_stacked: torch.Tensor, idx: int) -> torch.Tensor:
    """Probe kernel F (``_q4_stacked_folded_kernel``): the folded function
    on layer ``idx`` of q [L, O, I/2] with scales [L, 2, O]; the layer is a
    view of the stack, so nothing is copied (on the card, the same launch as
    ``q4_matmul_folded``)."""
    q, scale2 = q_stacked[idx], scale_stacked[idx]
    if x.device.type == "cpu":
        return q4_matmul_folded_plain(x, q, scale2)
    y = _launch_q4("vt_q4_matmul_folded", x, q, scale2, (2, q.shape[0]))
    _kernels.count_launch(q4_matmul_stacked_folded)
    return y


q4_matmul_stacked_folded.launches = 0


def pack_int4_adjacent(values):
    """Signed int4 values [..., 2k] (int8 in [-8, 7], numpy or torch) -> the
    port's packing of them, u8 [..., k]: element 2k in the low nibble and
    2k + 1 in the high nibble, each as its two's-complement bits.

    The JAX probe stores a native ``jnp.int4`` array; torch has no
    arithmetic int4 type, so this packing is the port's own choice (no +8
    offset, no split-half pairing, unlike ``quantize_weight4``)."""
    u = values.view(torch.uint8 if isinstance(values, torch.Tensor) else np.uint8)
    return (u[..., 0::2] & 15) | (u[..., 1::2] << 4)


def unpack_int4_adjacent(q: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_int4_adjacent``: u8 [..., k] -> int8 [..., 2k]."""
    p = q.to(torch.int16)
    pairs = torch.stack([p & 15, p >> 4], dim=-1)
    return ((pairs ^ 8) - 8).to(torch.int8).reshape(*q.shape[:-1], 2 * q.shape[-1])


def i4_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of probe kernel K: (bf16(x) . w^T, f32 sums) *
    scale for adjacent-packed signed int4 q [O, I/2], scale [1, O] -> [B, O]."""
    w = unpack_int4_adjacent(q).to(torch.float32)
    return (x.to(torch.bfloat16).to(torch.float32) @ w.T) * scale


def i4_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Probe kernel K wrapper (``_i4_matmul_kernel``): x [B, I] . w^T * scale
    for a signed int4 weight packed by ``pack_int4_adjacent`` (q [O, I/2] u8)
    and one scale per output row (scale [1, O] f32, the probe's layout) ->
    [B, O] f32 (on the card: kernel A's matvec in its signed form)."""
    if x.device.type == "cpu":
        return i4_matmul_plain(x, q, scale)
    y = _launch_q4("vt_i4_matmul", x, q, scale, (1, q.shape[0]))
    _kernels.count_launch(i4_matmul)
    return y


i4_matmul.launches = 0


def repack_slabs(gu_q: torch.Tensor, gu_s: torch.Tensor, dn_q: torch.Tensor,
                 dn_s: torch.Tensor, inter_block: int):
    """The int4 probe's per-slab repack (``tools/probe_stacked_fused.py``,
    variant F), copied as it is.  From the probes' stacks gu_q [L, 2I, H/2],
    gu_s [L, 2, 2I], dn_q [L, H, I/2], dn_s [L, 2, H] and bi = inter_block:

    - gq2 [L, n, 2*bi, H/2]: slab j is gate rows j*bi.. then up rows;
    - gs2 [L, n, 2, 2*bi]: their scales;
    - dq2 [L, n, H, bi/2]: byte b of slab j packs intermediate elements
      j*bi + b (low nibble) and j*bi + bi/2 + b (high);
    - ds2 [L, n, 2, H]: dn_s's (lo, hi) rows broadcast to every slab.

    The last is the probe's: after the repack slab j's elements all come from
    one half of the original packing (the lo half for j < n/2), yet its high
    nibbles take the hi scale.  So the repacked weight equals the original
    only where dn_s[:, 0] == dn_s[:, 1] (the probe's uniform scales)."""
    layers, two_inter, halfh = gu_q.shape
    inter, hidden, bi = two_inter // 2, 2 * halfh, inter_block
    blocks = inter // bi
    gate = gu_q[:, :inter].reshape(layers, blocks, bi, halfh)
    up = gu_q[:, inter:].reshape(layers, blocks, bi, halfh)
    gq2 = torch.cat([gate, up], dim=2)
    gs_gate = gu_s[:, :, :inter].reshape(layers, 2, blocks, bi)
    gs_up = gu_s[:, :, inter:].reshape(layers, 2, blocks, bi)
    gs2 = torch.cat([gs_gate, gs_up], dim=3).permute(0, 2, 1, 3).contiguous()
    full = torch.cat([dn_q & 15, dn_q >> 4], dim=-1)  # [L, H, I] nibbles
    slab = full.reshape(layers, hidden, blocks, bi).permute(0, 2, 1, 3)
    dq2 = (slab[..., :bi // 2] | (slab[..., bi // 2:] << 4)).contiguous()
    ds2 = dn_s[:, None].expand(layers, blocks, 2, hidden).contiguous()
    return gq2, gs2, dq2, ds2


def q4_slab_act_plain(x: torch.Tensor, gq: torch.Tensor, gs: torch.Tensor) -> torch.Tensor:
    """act [B, n*bi] bf16 of one layer's slabs (gq [n, 2bi, H/2], gs
    [n, 2, 2bi]): bf16(g * sigmoid(g) * u) with g, u from the folded
    arithmetic."""
    bi = gq.shape[1] // 2
    xf = x.to(torch.bfloat16).to(torch.float32)
    acts = []
    for j in range(gq.shape[0]):
        gu = _folded(xf, gq[j], gs[j])
        g, u = gu[:, :bi], gu[:, bi:]
        acts.append((g * torch.sigmoid(g) * u).to(torch.bfloat16))
    return torch.cat(acts, dim=1)


def q4_fused_mlp_slab_plain(x: torch.Tensor, gq2: torch.Tensor, gs2: torch.Tensor,
                            dq2: torch.Tensor, ds2: torch.Tensor, idx: int) -> torch.Tensor:
    """Plain PyTorch version of probe kernel H on layer ``idx``: each slab's
    folded down product of its act, summed over the slabs in order from 0
    -> [B, H] f32."""
    gq, gs, dq, ds = gq2[idx], gs2[idx], dq2[idx], ds2[idx]
    bi = gq.shape[1] // 2
    act = q4_slab_act_plain(x, gq, gs).to(torch.float32)
    y = torch.zeros((x.shape[0], dq.shape[1]), dtype=torch.float32, device=x.device)
    for j in range(gq.shape[0]):
        y = y + _folded(act[:, j * bi:(j + 1) * bi], dq[j], ds[j])
    return y


def q4_fused_mlp_slab(x: torch.Tensor, gq2: torch.Tensor, gs2: torch.Tensor,
                      dq2: torch.Tensor, ds2: torch.Tensor, idx: int) -> torch.Tensor:
    """Probe kernel H wrapper (``_q4_fused_mlp_kernel``): the int4 SwiGLU MLP
    of layer ``idx`` over ``repack_slabs``' layout, x [B, H] -> [B, H] f32.
    Runs the plain version for CPU tensors; on the card launches the kernel
    (three launches on one stream: the gated folded matvec into act, the
    folded matvec once per slab into the partial outputs, their ordered
    sum) or raises on what it does not take."""
    if x.device.type == "cpu":
        return q4_fused_mlp_slab_plain(x, gq2, gs2, dq2, ds2, idx)

    gq, gs, dq, ds = gq2[idx], gs2[idx], dq2[idx], ds2[idx]
    if gq.dtype != torch.uint8 or dq.dtype != torch.uint8 or any(
            t.dtype != torch.float32 for t in (gs, ds)):
        raise TypeError(f"fused int4 MLP wants u8 weights / f32 scales, got "
                        f"{gq.dtype}, {dq.dtype} / {gs.dtype}, {ds.dtype}")
    if not all(t.is_contiguous() for t in (gq, gs, dq, ds)):
        raise ValueError("fused int4 MLP needs contiguous slab stacks")
    if any(t.device != x.device for t in (gq, gs, dq, ds)):
        raise ValueError("fused int4 MLP operands must share one device")
    batch, hidden = x.shape
    n, two_bi, halfh = gq.shape
    bi = two_bi // 2
    if (2 * halfh != hidden or gs.shape != (n, 2, two_bi)
            or dq.shape != (n, hidden, bi // 2) or ds.shape != (n, 2, hidden)):
        raise ValueError(f"fused int4 MLP shapes disagree: x {tuple(x.shape)}, gq "
                         f"{tuple(gq.shape)}, gs {tuple(gs.shape)}, dq {tuple(dq.shape)}, "
                         f"ds {tuple(ds.shape)}")
    if hidden % 32 or bi % 32 or gq.data_ptr() % 16 or dq.data_ptr() % 16:
        raise ValueError("fused int4 MLP reads 16 bytes per lane: hidden and the slab width "
                         "must be multiples of 32, the weights' addresses of 16")
    if not 1 <= batch <= MAX_KERNEL_ROWS:
        raise ValueError(f"fused int4 MLP takes 1..{MAX_KERNEL_ROWS} rows, got {batch}")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    # One scratch for both intermediates: act [n, B, bi] bf16, then the
    # slabs' partial outputs [n, B, H] f32.
    scratch = torch.empty((n * batch * (2 * bi + 4 * hidden),), dtype=torch.uint8,
                          device=x.device)
    y = torch.empty((batch, hidden), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels.library().vt_q4_fused_mlp(
            xb.data_ptr(), gq.data_ptr(), gs.data_ptr(), dq.data_ptr(), ds.data_ptr(),
            scratch.data_ptr(), y.data_ptr(), batch, hidden, n, bi, _kernels.stream_of(x),
        )
    _kernels.check(err, "vt_q4_fused_mlp")
    _kernels.count_launch(q4_fused_mlp_slab)
    return y


q4_fused_mlp_slab.launches = 0


__all__ = [
    "MAX_KERNEL_ROWS",
    "QuantizedWeight",
    "QuantizedWeight4",
    "QuantizedWeight4Pick",
    "embed_rows4",
    "embed_rows8",
    "fused_mlp_applies",
    "fused_swiglu_mlp",
    "fused_swiglu_mlp_plain",
    "i4_matmul",
    "i4_matmul_plain",
    "mlp_block_size",
    "pack_int4_adjacent",
    "q4_fused_mlp_slab",
    "q4_fused_mlp_slab_plain",
    "q4_matmul",
    "q4_matmul_folded",
    "q4_matmul_folded_plain",
    "q4_matmul_plain",
    "q4_matmul_stacked",
    "q4_matmul_stacked_folded",
    "q4_slab_act_plain",
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
    "repack_slabs",
    "unpack_int4",
    "unpack_int4_adjacent",
]
