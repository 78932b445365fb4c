"""Transformer primitives shared by the port's models.

Counterpart of ``vis_tpu/models/common/layers.py``: plain functions on
tensors.  Norms and softmax statistics run in f32; every matmul sums in f32
and returns f32 before the cast back (the JAX package's
``preferred_element_type=f32``).

The hybrid decoders' pieces have no counterpart there: the Mamba2 mixer
(``mamba2_prefill``, a chunked scan; ``mamba2_step``, one token through the
state step of ``ops/ssm.py``), its grouped gated RMSNorm and the squared-ReLU
MLP.  Their recurrent state sits in ``KVCache`` beside the K/V.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from vis_tpu_torch.utils.logger import span, synced
from vis_tpu_torch.ops.quantized import (
    QuantizedWeight,
    QuantizedWeight4,
    QuantizedWeight4Pick,
    embed_rows4,
    embed_rows8,
    fused_mlp_applies,
    fused_swiglu_mlp,
    quantized_linear,
    quantized_linear4,
    quantized_linear4_stacked,
)
from vis_tpu_torch.ops.norms import gated_group_norm, rms_norm
from vis_tpu_torch.ops.ssm import ssm_step

Params = Dict[str, Any]


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with f32 statistics (population variance)."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed and returned in f32 (inputs keep their rounding)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def linear(x: torch.Tensor, weight: Any, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ W^T (+ b), W laid out [out, in]; int4 weights go to the int4
    matmuls (kernels A and B), int8 weights to kernel D."""
    if isinstance(weight, QuantizedWeight):
        return quantized_linear(x, weight, bias)
    if isinstance(weight, QuantizedWeight4):
        return quantized_linear4(x, weight, bias)
    if isinstance(weight, QuantizedWeight4Pick):
        return quantized_linear4_stacked(x, weight, bias)
    out = matmul_f32(x, weight.T)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def embed(token_ids: torch.Tensor, table: Any) -> torch.Tensor:
    if isinstance(table, QuantizedWeight):
        return embed_rows8(table, token_ids)
    if isinstance(table, QuantizedWeight4):
        return embed_rows4(table, token_ids)
    return table[token_ids]


def rope_frequencies(head_dim: int, theta: float, device=None,
                     rope_scaling: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2], f32.  ``rope_scaling`` takes the
    Llama-3 scheme ({"rope_type": "llama3", "factor", "low_freq_factor",
    "high_freq_factor", "original_max_position_embeddings"}): low
    frequencies divided by ``factor``, high ones kept, the band between
    interpolated."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    if rope_scaling and rope_scaling.get("rope_type") == "llama3":
        factor = rope_scaling["factor"]
        low = rope_scaling["low_freq_factor"]
        high = rope_scaling["high_freq_factor"]
        old_len = rope_scaling["original_max_position_embeddings"]
        wavelen = 2 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (old_len / wavelen - low) / (high - low)
        interp = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        inv_freq = torch.where(
            wavelen < old_len / high, inv_freq,
            torch.where(wavelen > old_len / low, scaled, interp),
        )
    return inv_freq


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
                 rope_scaling: Optional[Dict[str, Any]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [..., head_dim] (half-split layout) for integer positions."""
    inv_freq = rope_frequencies(head_dim, theta, positions.device, rope_scaling)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., seq, heads, head_dim]; cos/sin [..., seq, head_dim]."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    x32 = x.to(torch.float32)
    return (x32 * cos + _rotate_half(x32) * sin).to(x.dtype)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int,
                  mrope_section: Tuple[int, int, int],
                  theta: float = 1000000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE: positions [3, ...seq]; stream i owns its section of
    the frequency spectrum.  Returns cos/sin [...seq, head_dim]."""
    if sum(mrope_section) != head_dim // 2:
        raise ValueError(
            f"mrope_section {mrope_section} must sum to head_dim//2 = {head_dim // 2}"
        )
    inv_freq = rope_frequencies(head_dim, theta, positions.device)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)

    def select(table: torch.Tensor) -> torch.Tensor:
        chunks, start = [], 0
        for stream, span in enumerate(mrope_section):
            chunks.append(table[stream, ..., start:start + span])
            start += span
        half = torch.cat(chunks, dim=-1)
        return torch.cat([half, half], dim=-1)

    return select(cos), select(sin)


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention with native GQA: q [b, sq, h, d], k/v
    [b, skv, kvh, d] with h = kvh * rep; ``mask`` additive and
    head-agnostic ([b|1, 1, sq, skv]).  Logits and softmax in f32, the
    probabilities cast to v's dtype before the second product, the output
    in q's dtype."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d).to(torch.float32)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(torch.float32)) * d ** -0.5
    if mask is not None:
        if mask.shape[1] != 1:
            raise ValueError(f"attention mask must be head-agnostic, got head dim {mask.shape[1]}")
        logits = logits + mask[:, :, None]
    probs = torch.softmax(logits, dim=-1).to(v.dtype).to(torch.float32)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.to(torch.float32))
    return out.reshape(b, sq, h, d).to(q.dtype)


def causal_mask(sq: int, skv: int, device=None, offset: int = 0) -> torch.Tensor:
    """Additive [1, 1, sq, skv]: query i sees keys <= i + offset."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv, device=device)[None, :]
    mask = torch.where(kj <= qi, 0.0, -1e30).to(torch.float32)
    return mask[None, None]


def length_mask(skv: int, lengths: torch.Tensor) -> torch.Tensor:
    """Additive [b, 1, 1, skv] hiding keys >= each row's length."""
    kj = torch.arange(skv, device=lengths.device)[None, :]
    mask = torch.where(kj < lengths[:, None], 0.0, -1e30).to(torch.float32)
    return mask[:, None, None, :]


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    """A Mamba2 mixer's sizes: ``num_heads`` heads of ``head_dim`` channels,
    each with an f32 state [head_dim, state_size]; ``n_groups`` groups of
    B and C shared by num_heads / n_groups heads; a causal depthwise
    convolution of ``conv_kernel`` taps (4: the state's ring has four
    slots); the prefill scan's ``chunk_size``; the grouped gated norm's
    ``norm_eps``."""

    num_heads: int
    head_dim: int
    state_size: int
    n_groups: int
    conv_kernel: int = 4
    chunk_size: int = 128
    norm_eps: float = 1e-5

    @property
    def d_inner(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.state_size

    @property
    def in_proj_size(self) -> int:
        """z | xBC | dt."""
        return self.d_inner + self.conv_dim + self.num_heads


@dataclasses.dataclass
class KVCache:
    """Dense per-layer KV buffers with per-row cursors.

    k/v: [n_layers, batch, max_len, kv_heads, head_dim]; lengths [batch]
    int32 on the device, plus a host copy (``lengths_host``) so the decode
    loop never reads the cursor back from the device.  The port updates the
    buffers in place (the JAX package's are immutable), the cursors too.
    ``window_pass`` is the request's lookahead window pass
    (``decoder.WindowPass``), which binds k, v and lengths and lives and
    dies with the cache.

    A hybrid decoder's cache holds K/V for its attention layers only, and
    beside them each row's recurrent state for each Mamba2 layer: ``conv``
    [n_mamba, batch, conv_dim, 4] (the ring of pre-convolution inputs,
    token t in slot t % 4) and ``ssm`` [n_mamba, batch, H, P, N] f32.  The
    cursor is also the count of tokens folded into that state."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    lengths_host: list
    window_pass: Any = dataclasses.field(default=None, repr=False, compare=False)
    conv: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, n_layers: int, batch: int, max_len: int, kv_heads: int,
               head_dim: int, dtype, device, mamba: Optional[Mamba2Config] = None,
               n_mamba: int = 0) -> "KVCache":
        shape = (n_layers, batch, max_len, kv_heads, head_dim)
        cache = cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
            lengths_host=[0] * batch,
        )
        if mamba is not None and n_mamba:
            cache.conv, cache.ssm = recurrent_state(mamba, n_mamba, batch, dtype, device)
        return cache

    def set_lengths(self, lengths) -> None:
        """Both cursors; the device's is written in place, never rebound."""
        self.lengths_host = [int(n) for n in lengths]
        synced(self.lengths.copy_, torch.tensor(self.lengths_host, dtype=torch.int32))

    def update(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Write k/v [b, s, kvh, d] of ``layer`` at each row's cursor; the
        cursors move only by ``advance``, so every layer of a pass writes
        at the same offsets."""
        s = k_new.shape[1]
        for row, start in enumerate(self.lengths_host):
            self.k[layer, row, start:start + s] = k_new[row].to(self.k.dtype)
            self.v[layer, row, start:start + s] = v_new[row].to(self.v.dtype)

    def layer(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.k[layer], self.v[layer]

    def advance(self, n: int) -> None:
        self.set_lengths([length + n for length in self.lengths_host])

    def decode_mask(self) -> torch.Tensor:
        """Additive [b, 1, 1, max_len] for a one-token step: key j of row b
        is visible iff j <= its cursor (the new token writes at the cursor
        within the same step)."""
        kj = torch.arange(self.k.shape[2], device=self.k.device)
        return torch.where(kj[None, :] <= self.lengths[:, None], 0.0, -1e30).to(
            torch.float32)[:, None, None, :]


def recurrent_state(mamba: Mamba2Config, n_mamba: int, rows: int, dtype, device):
    """Zeroed (conv ring [n_mamba, rows, conv_dim, 4] in the activations'
    dtype, ssm state [n_mamba, rows, H, P, N] f32)."""
    conv = torch.zeros((n_mamba, rows, mamba.conv_dim, mamba.conv_kernel), dtype=dtype,
                       device=device)
    ssm = torch.zeros((n_mamba, rows, mamba.num_heads, mamba.head_dim, mamba.state_size),
                      dtype=torch.float32, device=device)
    return conv, ssm


def relu2_mlp(x: torch.Tensor, params: Params) -> torch.Tensor:
    """down(relu(up(x))^2): Nemotron-H's MLP, no gate, no bias; up's output
    and the square in x's dtype (the square computed in f32 and rounded)."""
    return linear(torch.relu(linear(x, params["up_proj"])).square(), params["down_proj"])


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., l] -> [..., l, l]: out[i, j] = x[j+1] + .. + x[i] for i >= j,
    -inf above the diagonal (sums of masked copies, not differences of
    cumulative sums, so long decays keep their precision)."""
    l = x.shape[-1]
    rep = x[..., None].expand(*x.shape, l)
    below = torch.tril(torch.ones(l, l, dtype=torch.bool, device=x.device), diagonal=-1)
    sums = torch.cumsum(rep.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(l, l, dtype=torch.bool, device=x.device))
    return sums.masked_fill(~keep, float("-inf"))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_in: torch.Tensor,
             c_in: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state-space recurrence over a whole prompt, chunk by chunk (the
    SSD form): x [b, s, H, P], dt [b, s, H] (0 at pad positions: they
    neither decay nor feed the state), a [H] (negative), B/C [b, s, G, N].
    Within a chunk the quadratic form, across chunks the states carried
    one chunk at a time (so a bucket's trailing pad chunks leave the state
    exactly as it was).  f32 throughout.  Returns y [b, s, H, P] (without
    the D skip) and the final state [b, H, P, N]."""
    bsz, s, heads, p = x.shape
    groups, n = b_in.shape[2:]
    per = heads // groups
    pad = -s % chunk
    if pad:
        x, dt, b_in, c_in = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                             for t in (x, dt, b_in, c_in))
    nc = (s + pad) // chunk
    xdt = (x * dt[..., None]).view(bsz, nc, chunk, groups, per, p)
    da = (dt * a).view(bsz, nc, chunk, heads).permute(0, 1, 3, 2).contiguous()  # [b, c, H, l]
    bb = b_in.reshape(bsz, nc, chunk, groups, n)
    cc = c_in.reshape(bsz, nc, chunk, groups, n)
    cum = torch.cumsum(da, dim=-1)
    decay = torch.exp(_segsum(da)).reshape(bsz, nc, groups, per, chunk, chunk)
    cb = torch.einsum("bclgn,bcsgn->bcgls", cc, bb)
    y = torch.einsum("bcgjls,bcsgjp->bclgjp", decay * cb[:, :, :, None], xdt)
    to_end = torch.exp(cum[..., -1:] - cum).reshape(bsz, nc, groups, per, chunk)
    states = torch.einsum("bclgn,bcgjl,bclgjp->bcgjpn", bb, to_end, xdt)
    chunk_decay = torch.exp(cum[..., -1]).reshape(bsz, nc, groups, per, 1, 1)
    state = torch.zeros_like(states[:, 0])
    entering = []
    for k in range(nc):
        entering.append(state)
        state = chunk_decay[:, k] * state + states[:, k]
    from_start = torch.exp(cum).reshape(bsz, nc, groups, per, chunk)
    y = y + torch.einsum("bclgn,bcgjpn,bcgjl->bclgjp", cc, torch.stack(entering, dim=1),
                         from_start)
    return y.reshape(bsz, nc * chunk, heads, p)[:, :s], state.reshape(bsz, heads, p, n)


def _ring_at(xbc: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The conv ring after a prompt: xbc [b, s, conv_dim] -> [b, conv_dim,
    4] with token j of the last four before each row's length in slot j %
    4 (zeros before the prompt's start; pad positions never enter)."""
    bsz, s, dim = xbc.shape
    padded = torch.nn.functional.pad(xbc, (0, 0, 4, 0))  # token j at index j + 4
    n = lengths.long()[:, None]
    slot = torch.arange(4, device=xbc.device)[None]
    token = n - 4 + (slot - (n - 4)) % 4  # the token of [n - 4, n) in each slot
    return torch.gather(padded, 1, (token + 4)[:, :, None].expand(bsz, 4, dim)).transpose(1, 2)


def mamba2_prefill(cfg: Mamba2Config, h: torch.Tensor, layer: Params, lengths: torch.Tensor,
                   conv: torch.Tensor, ssm: torch.Tensor) -> torch.Tensor:
    """A Mamba2 mixer over normed prompts h [b, s, hidden] whose rows hold
    ``lengths`` [b] valid tokens: in_proj, then (an untimed ``ssm.scan``
    span) the causal depthwise convolution and SiLU, softplus dt (0 at pad
    positions), the chunked scan, the D skip and the grouped gated norm,
    then out_proj.  Writes each row's conv ring and final state into
    ``conv`` [b, conv_dim, 4] and ``ssm`` [b, H, P, N]."""
    bsz, s, _ = h.shape
    zxbcdt = linear(h, layer["in_proj"])
    di, dim = cfg.d_inner, cfg.conv_dim
    z, xbc, dt_raw = zxbcdt[..., :di], zxbcdt[..., di:di + dim], zxbcdt[..., di + dim:]
    with span("ssm.scan", timed=False):
        w = layer["conv_weight"].to(torch.float32)
        taps = cfg.conv_kernel
        window = torch.nn.functional.pad(xbc.to(torch.float32), (0, 0, taps - 1, 0))
        acc = layer["conv_bias"].to(torch.float32).expand(bsz, s, dim)
        for k in range(taps):
            acc = acc + w[:, k] * window[:, k:k + s]
        u = torch.nn.functional.silu(acc)
        valid = torch.arange(s, device=h.device)[None, :] < lengths[:, None]
        dt = torch.nn.functional.softplus(dt_raw.to(torch.float32) + layer["dt_bias"])
        dt = torch.where(valid[..., None], dt, 0.0)
        x = u[..., :di].reshape(bsz, s, cfg.num_heads, cfg.head_dim)
        gn = cfg.n_groups * cfg.state_size
        b_in = u[..., di:di + gn].reshape(bsz, s, cfg.n_groups, cfg.state_size)
        c_in = u[..., di + gn:].reshape(bsz, s, cfg.n_groups, cfg.state_size)
        y, state = ssd_scan(x, dt, -torch.exp(layer["A_log"]), b_in, c_in, cfg.chunk_size)
        y = y + layer["D"][:, None] * x
        conv.copy_(_ring_at(xbc, lengths).to(conv.dtype))
        ssm.copy_(state)
        y = gated_group_norm(y.reshape(bsz, s, di), z, layer["gated_norm"], cfg.n_groups,
                             cfg.norm_eps)
    return linear(y, layer["out_proj"])


def mamba2_step(cfg: Mamba2Config, h: torch.Tensor, layer: Params, cursor: torch.Tensor,
                conv: torch.Tensor, ssm: torch.Tensor) -> torch.Tensor:
    """One decode token of a Mamba2 mixer for every row: h [b, 1, hidden]
    normed, ``cursor`` [b] the token's index in each row; in_proj, then (an
    untimed ``ssm.step`` span) the state step (``ops/ssm.py``: ring, conv,
    dt, recurrence, readout, D skip; ``conv`` and ``ssm`` in place) and the
    grouped gated norm (``ops/norms.py``), then out_proj."""
    zxbcdt = linear(h, layer["in_proj"])[:, 0]
    with span("ssm.step", timed=False):
        y = ssm_step(zxbcdt, conv, cursor, layer["conv_weight"], layer["conv_bias"],
                     layer["dt_bias"], layer["A_log"], layer["D"], ssm, cfg.n_groups)
        y = gated_group_norm(y, zxbcdt[:, :cfg.d_inner], layer["gated_norm"], cfg.n_groups,
                             cfg.norm_eps)
    return linear(y[:, None], layer["out_proj"])


def swiglu_mlp(x: torch.Tensor, params: Params) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)), with the fused gate+up layout.  Int8
    weights take kernel E for the whole MLP where the JAX package's rule
    sends them to its fused kernel (decode-sized rows); otherwise the
    projections run one by one."""
    if "gateup_proj" in params:
        gateup, down = params["gateup_proj"], params["down_proj"]
        if (isinstance(gateup, QuantizedWeight) and isinstance(down, QuantizedWeight)
                and fused_mlp_applies(x, gateup, down)):
            return fused_swiglu_mlp(x, gateup, down)
        gate, up = linear(x, gateup).chunk(2, dim=-1)
    else:
        gate = linear(x, params["gate_proj"])
        up = linear(x, params["up_proj"])
    return linear(gate * torch.sigmoid(gate) * up, params["down_proj"])


__all__ = [
    "KVCache",
    "Mamba2Config",
    "Params",
    "apply_rope",
    "attention_scores",
    "causal_mask",
    "embed",
    "layer_norm",
    "gated_group_norm",
    "length_mask",
    "linear",
    "mamba2_prefill",
    "mamba2_step",
    "matmul_f32",
    "mrope_cos_sin",
    "recurrent_state",
    "relu2_mlp",
    "rms_norm",
    "rope_cos_sin",
    "rope_frequencies",
    "ssd_scan",
    "swiglu_mlp",
]
