"""The Mamba2 decode state step and its plain PyTorch version.

No TPU kernel stands behind it: the JAX package runs no state-space layer.
The hybrid decoders (``DecoderConfig.block_pattern``) carry, per sequence
and Mamba2 layer, a ring of the last four pre-convolution inputs and an f32
state [H, P, N]; one decode step of one layer, for every row and head at
once, is ``ssm_step``: on a CUDA tensor one launch of
``csrc/ssm_step.cu``'s kernel (or a raise), on a CPU tensor
``ssm_step_plain``.  ``ssm_step.launches`` counts the launches.

Layouts: ``zxbcdt`` [b, ld] bf16 rows of in_proj's output, z [d_inner] |
xBC [conv_dim] | dt [H]; ``conv`` [b, conv_dim, 4] bf16, token t's xBC in
slot t % 4; ``cursor`` [b] int32, the index t of the token stepped;
``conv_w`` [conv_dim, 4] bf16 (w[:, k] multiplies token t - 3 + k),
``conv_b`` [conv_dim] bf16; ``dt_bias``, ``a_log``, ``d_skip`` [H] f32;
``ssm`` [b, H, P, N] f32.  ``conv`` and ``ssm`` are updated in place; the
result is y [b, H * P] f32 before the gate and the grouped norm.
"""

from __future__ import annotations

import torch

from vis_tpu_torch.ops import _kernels

STATE_SIZES = (128, 256)  # the kernel's N: 32 lanes of 4 or 8 columns
HEAD_DIM_MULTIPLE = 32    # its P: 8 warps of 4 rows at a time


def ssm_step_plain(zxbcdt: torch.Tensor, conv: torch.Tensor, cursor: torch.Tensor,
                   conv_w: torch.Tensor, conv_b: torch.Tensor, dt_bias: torch.Tensor,
                   a_log: torch.Tensor, d_skip: torch.Tensor, ssm: torch.Tensor,
                   groups: int) -> torch.Tensor:
    """One token through the convolution and the recurrence, in f32."""
    b, heads, p, n = ssm.shape
    d_inner, conv_dim = heads * p, conv.shape[1]
    xbc = zxbcdt[:, d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[:, d_inner + conv_dim:d_inner + conv_dim + heads]
    # Ring slots of tokens t - 3 .. t; the window reads the first three.
    slots = (cursor.long()[:, None] + torch.arange(-3, 1, device=cursor.device)) % 4
    hist = torch.gather(conv, 2, slots[:, None, :3].expand(b, conv_dim, 3)).to(torch.float32)
    w = conv_w.to(torch.float32)
    acc = conv_b.to(torch.float32).expand(b, conv_dim)
    for k in range(3):
        acc = acc + w[:, k] * hist[:, :, k]
    acc = acc + w[:, 3] * xbc.to(torch.float32)
    conv.scatter_(2, slots[:, None, 3:].expand(b, conv_dim, 1), xbc[:, :, None].to(conv.dtype))
    u = torch.nn.functional.silu(acc)
    x = u[:, :d_inner].view(b, heads, p)
    per_group = heads // groups
    bmat = u[:, d_inner:d_inner + groups * n].view(b, groups, n).repeat_interleave(per_group, 1)
    cmat = u[:, d_inner + groups * n:].view(b, groups, n).repeat_interleave(per_group, 1)
    dt = torch.nn.functional.softplus(dt_raw.to(torch.float32) + dt_bias)
    a = torch.exp(dt * -torch.exp(a_log))
    xd = x * dt[:, :, None]
    ssm.mul_(a[:, :, None, None]).add_(xd[:, :, :, None] * bmat[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", ssm, cmat) + d_skip[None, :, None] * x
    return y.reshape(b, d_inner)


def ssm_step(zxbcdt: torch.Tensor, conv: torch.Tensor, cursor: torch.Tensor,
             conv_w: torch.Tensor, conv_b: torch.Tensor, dt_bias: torch.Tensor,
             a_log: torch.Tensor, d_skip: torch.Tensor, ssm: torch.Tensor,
             groups: int) -> torch.Tensor:
    """One decode step of one Mamba2 layer for every row (see the module's
    layouts): the plain version for a CPU tensor, one kernel launch for a
    CUDA tensor, which raises on what the kernel does not take."""
    if zxbcdt.device.type == "cpu":
        return ssm_step_plain(zxbcdt, conv, cursor, conv_w, conv_b, dt_bias, a_log, d_skip,
                              ssm, groups)
    b, heads, p, n = ssm.shape
    d_inner, conv_dim = heads * p, conv.shape[1]
    if n not in STATE_SIZES or p % HEAD_DIM_MULTIPLE or heads % groups:
        raise ValueError(f"ssm step kernel takes N in {STATE_SIZES} and P a multiple of "
                         f"{HEAD_DIM_MULTIPLE}; got H {heads}, P {p}, N {n}, groups {groups}")
    if conv_dim != d_inner + 2 * groups * n or tuple(conv.shape) != (b, conv_dim, 4):
        raise ValueError(f"ssm step: conv ring {tuple(conv.shape)} does not fit H {heads}, "
                         f"P {p}, N {n}, groups {groups}")
    expected = {
        "zxbcdt": (zxbcdt, torch.bfloat16), "conv": (conv, torch.bfloat16),
        "cursor": (cursor, torch.int32), "conv_w": (conv_w, torch.bfloat16),
        "conv_b": (conv_b, torch.bfloat16), "dt_bias": (dt_bias, torch.float32),
        "a_log": (a_log, torch.float32), "d_skip": (d_skip, torch.float32),
        "ssm": (ssm, torch.float32),
    }
    for name, (t, dtype) in expected.items():
        if t.dtype != dtype or t.device != ssm.device:
            raise TypeError(f"ssm step: {name} must be {dtype} on {ssm.device}, "
                            f"got {t.dtype} on {t.device}")
        if name != "zxbcdt" and not t.is_contiguous():
            raise ValueError(f"ssm step: {name} must be contiguous")
    if (zxbcdt.dim() != 2 or zxbcdt.shape[0] != b or zxbcdt.stride(1) != 1
            or zxbcdt.shape[1] < d_inner + conv_dim + heads):
        raise ValueError(f"ssm step: zxbcdt {tuple(zxbcdt.shape)} is not [{b}, "
                         f">= {d_inner + conv_dim + heads}] rows")
    if (cursor.shape != (b,) or conv_w.shape != (conv_dim, 4) or conv_b.shape != (conv_dim,)
            or any(t.shape != (heads,) for t in (dt_bias, a_log, d_skip))):
        raise ValueError("ssm step: cursor, conv weights or per-head leaves mis-shaped")
    if ssm.data_ptr() % 16:
        raise ValueError("ssm step reads the state in 16-byte loads: its address must be "
                         "a multiple of 16")
    y = torch.empty((b, d_inner), dtype=torch.float32, device=ssm.device)
    with torch.cuda.device(ssm.device):
        err = _kernels.library().vt_ssm_step(
            zxbcdt.data_ptr(), zxbcdt.stride(0), conv.data_ptr(), cursor.data_ptr(),
            conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(), a_log.data_ptr(),
            d_skip.data_ptr(), ssm.data_ptr(), y.data_ptr(), b, heads, p, n, groups,
            _kernels.stream_of(ssm),
        )
    _kernels.check(err, "vt_ssm_step")
    _kernels.count_launch(ssm_step)
    return y


ssm_step.launches = 0


__all__ = ["HEAD_DIM_MULTIPLE", "STATE_SIZES", "ssm_step", "ssm_step_plain"]
