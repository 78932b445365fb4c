"""The hybrid decoders' fused normalisations and their plain versions.

No TPU kernel stands behind them: the JAX package runs no hybrid stack.
Each is one launch of ``csrc/norms.cu`` on a CUDA tensor (or a raise), and
its plain version on a CPU tensor; ``launches`` counts the launches.

- ``add_rms_norm(x, delta, weight, eps) -> (x + delta, rms_norm(x + delta))``:
  the residual add that ends a block and the RMSNorm that begins the next,
  bf16 rows, f32 statistics (``rms_norm``'s arithmetic, which every model's
  layers use as plain ops); ``delta`` None normalises x alone.
- ``gated_group_norm(y, z, weight, groups, eps)``: Mamba2's gated RMSNorm,
  (y * silu(z)) normalised over each of ``groups`` equal slices of a row,
  times the weight, in the weight's dtype; y f32, z bf16 (a strided view of
  in_proj's output is taken as it is).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vis_tpu_torch.ops import _kernels

VEC = 8  # the kernels' 16-byte loads: a row's width and stride in bf16


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    variance = (x32 * x32).mean(dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(variance + eps)
    return (x32 * weight.to(torch.float32)).to(x.dtype)


def add_rms_norm_plain(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x if delta is None else x + delta
    return x, rms_norm(x, weight, eps)


def gated_group_norm_plain(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                           groups: int, eps: float) -> torch.Tensor:
    g = y.to(torch.float32) * torch.nn.functional.silu(z.to(torch.float32))
    shape = g.shape
    g = g.reshape(*shape[:-1], groups, shape[-1] // groups)
    g = g * torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + eps)
    return (g.reshape(shape) * weight.to(torch.float32)).to(weight.dtype)


def _rows(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` [..., n] as [rows, n] rows of 16-byte aligned, unit-stride
    columns, with no copy."""
    rows = t.reshape(-1, t.shape[-1])
    if rows.stride(-1) != 1 or rows.stride(0) % VEC or rows.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel reads rows of 16-byte loads; got shape "
                         f"{tuple(t.shape)}, strides {tuple(t.stride())}")
    return rows


def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + delta, its RMSNorm times ``weight``), both like x (bf16 on the
    card)."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, delta, weight, eps)
    n = x.shape[-1]
    for t in (x, weight) + ((delta,) if delta is not None else ()):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise TypeError(f"add_rms_norm takes bf16 on one device, got {t.dtype} on {t.device}")
    if n % VEC or weight.shape != (n,) or (delta is not None and delta.shape != x.shape):
        raise ValueError(f"add_rms_norm: x {tuple(x.shape)}, delta "
                         f"{None if delta is None else tuple(delta.shape)}, weight "
                         f"{tuple(weight.shape)}")
    x2 = _rows(x.contiguous(), "add_rms_norm x")
    d2 = None if delta is None else _rows(delta.contiguous(), "add_rms_norm delta")
    _rows(weight, "add_rms_norm weight")
    x_out, h = torch.empty_like(x2), torch.empty_like(x2)
    with torch.cuda.device(x.device):
        err = _kernels.library().vt_add_rms_norm(
            x2.data_ptr(), None if d2 is None else d2.data_ptr(), weight.data_ptr(),
            x_out.data_ptr(), h.data_ptr(), x2.shape[0], n, float(eps), _kernels.stream_of(x))
    _kernels.check(err, "vt_add_rms_norm")
    _kernels.count_launch(add_rms_norm)
    return x_out.view(x.shape), h.view(x.shape)


add_rms_norm.launches = 0


def gated_group_norm(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, groups: int,
                     eps: float) -> torch.Tensor:
    """Mamba2's gated RMSNorm of y [..., n] f32 by z [..., n] (the gate)."""
    if y.device.type == "cpu":
        return gated_group_norm_plain(y, z, weight, groups, eps)
    n = y.shape[-1]
    if (y.dtype != torch.float32 or z.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16
            or z.device != y.device or weight.device != y.device):
        raise TypeError("gated_group_norm takes f32 y, bf16 z and weight on one device")
    if z.shape != y.shape or weight.shape != (n,) or n % groups or (n // groups) % VEC:
        raise ValueError(f"gated_group_norm: y {tuple(y.shape)}, z {tuple(z.shape)}, weight "
                         f"{tuple(weight.shape)}, groups {groups}")
    y2 = y.contiguous().reshape(-1, n)
    if y2.data_ptr() % 16:
        y2 = y2.clone()
    z2 = _rows(z, "gated_group_norm z")
    _rows(weight, "gated_group_norm weight")
    out = torch.empty(y2.shape, dtype=torch.bfloat16, device=y.device)
    with torch.cuda.device(y.device):
        err = _kernels.library().vt_gated_group_norm(
            y2.data_ptr(), z2.data_ptr(), z2.stride(0), weight.data_ptr(), out.data_ptr(),
            y2.shape[0], n, groups, float(eps), _kernels.stream_of(y))
    _kernels.check(err, "vt_gated_group_norm")
    _kernels.count_launch(gated_group_norm)
    return out.view(y.shape)


gated_group_norm.launches = 0


__all__ = ["add_rms_norm", "add_rms_norm_plain", "gated_group_norm", "gated_group_norm_plain",
           "rms_norm"]
