"""GQA transformer decoder: the Qwen2.5-VL and Llama text stacks, and the
hybrid Mamba2 / attention / MLP stacks (Nemotron-H).

Counterpart of the scan-execution half of ``vis_tpu/models/common/decoder.py``.
Layer parameters are stacked ([L, ...] leaves, int4 leaves as
``QuantizedWeight4`` with q [L, O, I/2]); a Python loop over layers takes
the place of ``lax.scan``, and ``_pick_layer`` hands each layer's int4
weights to kernel A as a view of the stack.  Cache cursors live on the
device, where a chunk's K/V store and the cursors' advance read and write
them, with a host mirror for the host's own bookkeeping.

Decode over a dense per-request cache is ``decode_loop_scan`` (greedy),
``decode_loop_scan_sampled`` (Gumbel-max) and
``decode_loop_scan_constrained`` (a grammar mask, greedy or sampled), one
token per weight pass, and ``decode_loop_lookahead``: schema-constrained
windows of ``window`` tokens, one weight pass and one host sync per
window, the pass replayed as a CUDA graph on the card (``WindowPass``).
Decode over the scheduler's paged KV pool is ``decode_loop_paged``
(greedy) and ``decode_loop_paged_constrained`` (a per-row grammar over
stacked tables, greedy or per-row Gumbel-sampled), one token per weight
pass for every slot at once.  Every token-per-pass loop runs on the
``_eos_loop`` scaffold.

A hybrid config (``block_pattern``) walks three stacks in the published
order of its blocks: Mamba2 mixers, attention without rotary embedding,
squared-ReLU MLPs, each ``h = h + block(rms_norm(h))``.  Its cache
(``new_cache``) holds K/V for the attention blocks only and each row's
recurrent state for the Mamba2 blocks.  Prefill, the dense and the paged
token steps take it; the lookahead window and chat sessions (which extend
a cache by a chunk) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vis_tpu_torch.models.common.layers import (
    KVCache,
    Mamba2Config,
    apply_rope,
    causal_mask,
    embed,
    length_mask,
    linear,
    mamba2_prefill,
    mamba2_step,
    matmul_f32,
    mrope_cos_sin,
    relu2_mlp,
    rms_norm,
    rope_cos_sin,
    swiglu_mlp,
)
from vis_tpu_torch.utils.logger import span, synced
from vis_tpu_torch.ops._kernels import add_launches, captured_launches
from vis_tpu_torch.ops.norms import add_rms_norm
from vis_tpu_torch.ops.quantized import (
    QuantizedWeight,
    QuantizedWeight4,
    QuantizedWeight4Pick,
    quantize_weight,
    quantize_weight4,
    quantized_matmul,
    quantized_matmul4,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 2
    intermediate_size: int = 5504
    head_dim: Optional[int] = None
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    qkv_bias: bool = True
    mrope_section: Optional[Tuple[int, int, int]] = None
    rope_scaling: Optional[Tuple[Tuple[str, Any], ...]] = None  # llama3 scheme
    tie_word_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # Class attributes, not fields: the plain decoder is num_layers layers
    # of rotary attention then a SwiGLU MLP.  HybridDecoderConfig makes
    # them fields.
    block_pattern = None
    mamba = None

    @property
    def rope_scaling_dict(self) -> Optional[Dict[str, Any]]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def kv_layers(self) -> int:
        """Layers that keep K/V: every layer, or a hybrid's attention blocks."""
        if self.block_pattern is None:
            return self.num_layers
        return self.block_pattern.count("*")

    @property
    def mamba_layers(self) -> int:
        return 0 if self.block_pattern is None else self.block_pattern.count("M")

    def describe(self) -> str:
        if self.block_pattern is None:
            return f"{self.num_layers}-layer decoder, hidden {self.hidden_size}"
        p = self.block_pattern
        return (f"hybrid stack of {len(p)} blocks ({p.count('M')} Mamba2, {p.count('*')} "
                f"attention, {p.count('-')} MLP), hidden {self.hidden_size}")


@dataclasses.dataclass(frozen=True)
class HybridDecoderConfig(DecoderConfig):
    """A hybrid stack (Nemotron-H): one character of ``block_pattern`` a
    block, "M" a Mamba2 mixer (sizes in ``mamba``), "*" attention, "-" an
    relu2 MLP (down(relu(up(x))^2), no gate), each
    h = h + block(rms_norm(h)); ``num_layers`` is the pattern's length;
    attention without positional encoding."""

    block_pattern: str = ""
    mamba: Optional[Mamba2Config] = None

    def __post_init__(self):
        pattern = self.block_pattern
        if not pattern or set(pattern) - set("M*-") or len(pattern) != self.num_layers:
            raise ValueError(f"block_pattern must be {self.num_layers} of 'M', '*', '-'")
        if "M" in pattern and (self.mamba is None or self.mamba.conv_kernel != 4):
            raise ValueError("a block_pattern with Mamba2 blocks needs mamba sizes with a "
                             "4-tap convolution (the state's ring has four slots)")


def new_cache(config: DecoderConfig, batch: int, max_len: int, device) -> KVCache:
    """A zeroed decode cache for ``config``: K/V for its attention layers
    and, for a hybrid stack, each row's Mamba2 state."""
    return KVCache.create(config.kv_layers, batch, max_len, config.num_kv_heads,
                          config.head_dim_, config.dtype, device, config.mamba,
                          config.mamba_layers)


def _refuse_hybrid(config: DecoderConfig, what: str) -> None:
    if config.block_pattern is not None:
        raise NotImplementedError(
            f"{what} is not ported for a {config.describe()}: a hybrid decoder's "
            "recurrent state cannot be extended by a padded chunk")


def _position_tables(config: DecoderConfig, positions: torch.Tensor):
    """cos/sin [b, s, head_dim]; positions [b, s] or [3, b, s] (M-RoPE);
    (None, None) for a hybrid stack, whose attention has no positional
    encoding."""
    if config.block_pattern is not None:
        return None, None
    if config.mrope_section is not None:
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        return mrope_cos_sin(
            positions, config.head_dim_, config.mrope_section, config.rope_theta
        )
    return rope_cos_sin(positions, config.head_dim_, config.rope_theta,
                        config.rope_scaling_dict)


def _to_device(value, dtype, device: torch.device) -> torch.Tensor:
    """``torch.as_tensor(value, dtype, device)``, a ``synced`` transfer
    unless ``value`` is a tensor on ``device`` already."""
    if isinstance(value, torch.Tensor) and value.device == device:
        return torch.as_tensor(value, dtype=dtype, device=device)
    return synced(torch.as_tensor, value, dtype=dtype, device=device)


def init_decoder_params(config: DecoderConfig, generator: torch.Generator,
                        device="cpu", scale: float = 0.02) -> Params:
    """Random-normal weights (norms one, biases zero) in the per-layer layout
    of the JAX package's ``init_decoder_params``, drawn from ``generator``."""
    hd, h, dtype = config.head_dim_, config.hidden_size, config.dtype

    def norm(*shape):
        return (scale * torch.randn(shape, generator=generator, device=device)).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    params: Params = {
        "embed_tokens": norm(config.vocab_size, h),
        "final_norm": ones(h),
        "layers": [],
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = norm(config.vocab_size, h)
    for _ in range(config.num_layers):
        layer = {
            "input_norm": ones(h), "post_attn_norm": ones(h),
            "q_proj": norm(config.num_heads * hd, h),
            "k_proj": norm(config.num_kv_heads * hd, h),
            "v_proj": norm(config.num_kv_heads * hd, h),
            "o_proj": norm(h, config.num_heads * hd),
            "mlp": {
                "gate_proj": norm(config.intermediate_size, h),
                "up_proj": norm(config.intermediate_size, h),
                "down_proj": norm(h, config.intermediate_size),
            },
        }
        if config.qkv_bias:
            layer["q_bias"] = torch.zeros(config.num_heads * hd, dtype=dtype, device=device)
            layer["k_bias"] = torch.zeros(config.num_kv_heads * hd, dtype=dtype, device=device)
            layer["v_bias"] = torch.zeros(config.num_kv_heads * hd, dtype=dtype, device=device)
        params["layers"].append(layer)
    return params


def params_from_numpy(flat: Mapping[str, np.ndarray], dtype, device="cpu") -> Params:
    """Rebuild a parameter tree from the JAX package's, flattened to
    "/"-joined key paths -> numpy (list items by index; a quantized weight
    as ".../q" and ".../scale": u8 q is int4, i8 q is int8).  Float leaves
    take ``dtype``; quantized bytes keep theirs and scales stay f32."""
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def build(node):
        if isinstance(node, np.ndarray):
            t = tensor(node)
            return t.to(dtype) if t.is_floating_point() else t
        if set(node) == {"q", "scale"}:
            cls = QuantizedWeight if node["q"].dtype == np.int8 else QuantizedWeight4
            return cls(q=tensor(node["q"]), scale=tensor(node["scale"].astype(np.float32)))
        if node and all(k.isdigit() for k in node):
            return [build(node[str(i)]) for i in range(len(node))]
        return {k: build(v) for k, v in node.items()}

    return build(tree)


# ---------------------------------------------------------------------------
# Stacked parameter layout
# ---------------------------------------------------------------------------

_QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "qkv_proj", "o_proj")
_QUANT_MLP_TARGETS = ("gate_proj", "up_proj", "gateup_proj", "down_proj")


def stack_decoder_layers(params: Params) -> Params:
    """Per-layer dicts -> one dict of [L, ...] tensors under "layers_stacked"."""

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return torch.stack(items)

    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers_stacked"] = stack(params["layers"])
    return out


def fuse_stacked_projections(stacked: Params) -> Params:
    """Concatenate Q/K/V into qkv_proj and gate/up into gateup_proj."""
    layers = dict(stacked["layers_stacked"])
    layers["qkv_proj"] = torch.cat(
        [layers.pop("q_proj"), layers.pop("k_proj"), layers.pop("v_proj")], dim=1
    )
    if "q_bias" in layers:
        layers["qkv_bias"] = torch.cat(
            [layers.pop("q_bias"), layers.pop("k_bias"), layers.pop("v_bias")], dim=1
        )
    mlp = dict(layers["mlp"])
    mlp["gateup_proj"] = torch.cat([mlp.pop("gate_proj"), mlp.pop("up_proj")], dim=1)
    layers["mlp"] = mlp
    out = {k: v for k, v in stacked.items() if k != "layers_stacked"}
    out["layers_stacked"] = layers
    return out


def quantize_stacked_params(stacked: Params, quantize_embeddings: bool = False,
                            vocab_mode: Optional[str] = None, mode: str = "int4") -> Params:
    """Weight-only quantization of the stacked projections: ``mode`` "int4"
    (QuantizedWeight4, q [L, O, I/2]) or "int8" (QuantizedWeight, q
    [L, O, I], scale [L, O]); with quantize_embeddings, of the vocab tables
    too, rows padded to 512, by ``vocab_mode`` (default: ``mode``).  The
    bytes equal the JAX package's ``quantize_stacked_params``."""
    vocab_mode = vocab_mode or mode
    if mode not in ("int4", "int8") or vocab_mode not in ("int4", "int8", "none"):
        raise ValueError(f"mode {mode!r} / vocab_mode {vocab_mode!r}: the port has "
                         "int4 and int8 layers, int4, int8 and none vocab tables")
    quantize_vocab = quantize_weight4 if vocab_mode == "int4" else quantize_weight
    quantize_layer, stack_cls = ((quantize_weight4, QuantizedWeight4) if mode == "int4"
                                 else (quantize_weight, QuantizedWeight))

    def quantize_stack(w):
        qws = [quantize_layer(layer) for layer in w]
        return stack_cls(
            q=torch.stack([qw.q for qw in qws]),
            scale=torch.stack([qw.scale for qw in qws]),
        )

    out = {k: v for k, v in stacked.items() if k != "layers_stacked"}
    if quantize_embeddings and vocab_mode != "none":
        for name in ("embed_tokens", "lm_head"):
            if name in out:
                out[name] = quantize_vocab(out[name], pad_out_multiple=512)
    layers = dict(stacked["layers_stacked"])
    for name in _QUANT_TARGETS:
        if name in layers:
            layers[name] = quantize_stack(layers[name])
    mlp = dict(layers["mlp"])
    for name in _QUANT_MLP_TARGETS:
        if name in mlp:
            mlp[name] = quantize_stack(mlp[name])
    layers["mlp"] = mlp
    out["layers_stacked"] = layers
    return out


def _pick_layer(stacked: Params, idx: int) -> Params:
    """Layer ``idx`` of the stacked tree: int4 leaves become
    QuantizedWeight4Pick (kernel A reads the layer in place), int8 leaves a
    QuantizedWeight of contiguous views (q[idx], scale[idx]), tensors
    views."""

    def pick(w):
        if isinstance(w, dict):
            return {k: pick(v) for k, v in w.items()}
        if isinstance(w, QuantizedWeight4):
            return QuantizedWeight4Pick(w.q, w.scale, idx)
        if isinstance(w, QuantizedWeight):
            return QuantizedWeight(w.q[idx], w.scale[idx])
        return w[idx]

    return pick(stacked)


def num_stacked_layers(stacked: Params) -> int:
    leaf = stacked["input_norm"]
    return leaf.shape[0]


# ---------------------------------------------------------------------------
# Layers, prefill, extend
# ---------------------------------------------------------------------------

def _layer_body(
    config: DecoderConfig, x: torch.Tensor, layer: Params,
    cos: torch.Tensor, sin: torch.Tensor, mask: Optional[torch.Tensor],
    cache_k: Optional[torch.Tensor], cache_v: Optional[torch.Tensor],
    cache_mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder layer over a chunk, attending jointly over the valid
    cached keys (when given) and the causal chunk; returns (x, k, v)."""
    h = rms_norm(x, layer["input_norm"], config.rms_norm_eps)
    out, k, v = _attention(config, h, layer, cos, sin, mask, cache_k, cache_v, cache_mask)
    x = x + linear(out, layer["o_proj"])
    h = rms_norm(x, layer["post_attn_norm"], config.rms_norm_eps)
    x = x + _mlp(config, h, layer["mlp"])
    return x, k, v


def _mlp(config: DecoderConfig, h: torch.Tensor, params: Params) -> torch.Tensor:
    return relu2_mlp(h, params) if config.block_pattern is not None else swiglu_mlp(h, params)


def _attention(
    config: DecoderConfig, h: torch.Tensor, layer: Params,
    cos: Optional[torch.Tensor], sin: Optional[torch.Tensor], mask: Optional[torch.Tensor],
    cache_k: Optional[torch.Tensor], cache_v: Optional[torch.Tensor],
    cache_mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GQA attention of the normed chunk h [b, s, hidden] (rotary unless
    cos is None) over the valid cached keys (when given) and the causal
    chunk; returns (heads' output [b, s, heads * hd] before o_proj, k, v)."""
    b, s, _ = h.shape
    hd = config.head_dim_
    if "qkv_proj" in layer:
        qdim = config.num_heads * hd
        kvdim = config.num_kv_heads * hd
        qkv = linear(h, layer["qkv_proj"], layer.get("qkv_bias"))
        q = qkv[..., :qdim].reshape(b, s, config.num_heads, hd)
        k = qkv[..., qdim:qdim + kvdim].reshape(b, s, config.num_kv_heads, hd)
        v = qkv[..., qdim + kvdim:].reshape(b, s, config.num_kv_heads, hd)
    else:
        q = linear(h, layer["q_proj"], layer.get("q_bias")).reshape(b, s, config.num_heads, hd)
        k = linear(h, layer["k_proj"], layer.get("k_bias")).reshape(b, s, config.num_kv_heads, hd)
        v = linear(h, layer["v_proj"], layer.get("v_bias")).reshape(b, s, config.num_kv_heads, hd)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    kvh = config.num_kv_heads
    rep = config.num_heads // kvh
    scale = hd ** -0.5
    qg = q.reshape(b, s, kvh, rep, hd).to(torch.float32)
    logits_new = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(torch.float32)) * scale
    if mask is not None:
        logits_new = logits_new + mask[:, :, None]
    if cache_k is not None:
        logits_cache = torch.einsum(
            "bqgrd,bkgd->bgrqk", qg, cache_k.to(torch.float32)
        ) * scale
        logits_cache = logits_cache + cache_mask[:, :, None]
        n_cache = cache_k.shape[1]
        probs = torch.softmax(torch.cat([logits_cache, logits_new], dim=-1), dim=-1)
        probs = probs.to(v.dtype).to(torch.float32)
        out = torch.einsum(
            "bgrqk,bkgd->bqgrd", probs[..., :n_cache], cache_v.to(torch.float32)
        ) + torch.einsum(
            "bgrqk,bkgd->bqgrd", probs[..., n_cache:], v.to(torch.float32)
        )
    else:
        probs = torch.softmax(logits_new, dim=-1).to(v.dtype).to(torch.float32)
        out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.to(torch.float32))
    return out.reshape(b, s, config.num_heads * hd).to(h.dtype), k, v


_BLOCK_STACKS = {"M": "mamba", "*": "attention", "-": "mlp"}


def _hybrid_stack(config: DecoderConfig, x: torch.Tensor, params: Params,
                  attend: Callable[[int, torch.Tensor, Params], torch.Tensor],
                  mix: Callable[[int, torch.Tensor, Params], torch.Tensor]) -> torch.Tensor:
    """x [b, s, hidden] through a hybrid stack in its pattern's order, each
    block h = h + block(rms_norm(h)), then the final norm, which is
    returned.  ``params["layers_stacked"]`` holds three stacks, "mamba",
    "attention" and "mlp", whose layer i is the i-th block of its kind;
    ``attend(i, h, layer)`` gives attention block i's heads' output (before
    o_proj), ``mix(i, h, layer)`` Mamba2 block i's output.  Each block's
    residual add and the next norm are one ``add_rms_norm``."""
    stacked, eps = params["layers_stacked"], config.rms_norm_eps
    seen = {"M": 0, "*": 0, "-": 0}
    delta = None
    for kind in config.block_pattern:
        i = seen[kind]
        seen[kind] += 1
        layer = _pick_layer(stacked[_BLOCK_STACKS[kind]], i)
        x, h = add_rms_norm(x, delta, layer["norm"], eps)
        if kind == "M":
            delta = mix(i, h, layer)
        elif kind == "*":
            delta = linear(attend(i, h, layer), layer["o_proj"])
        else:
            delta = _mlp(config, h, layer)
    return add_rms_norm(x, delta, params["final_norm"], eps)[1]


def _hybrid_decode(config: DecoderConfig, x: torch.Tensor, params: Params,
                   kv: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                   cache_mask: torch.Tensor, lengths: torch.Tensor,
                   conv: torch.Tensor, ssm: torch.Tensor, new_k: list, new_v: list):
    """One decode token x [b, 1, hidden] through a hybrid stack: attention
    block i over ``kv(i)``'s cached keys (its new K/V appended to new_k /
    new_v), Mamba2 block i stepping each row's state ``conv[i]`` /
    ``ssm[i]`` in place at token index ``lengths``; returns the final
    norm's output."""
    cursor = lengths.to(torch.int32)

    def attend(i, h, layer):
        cache_k, cache_v = kv(i)
        out, k, v = _attention(config, h, layer, None, None, None, cache_k, cache_v,
                               cache_mask)
        new_k.append(k[:, 0])
        new_v.append(v[:, 0])
        return out

    def mix(i, h, layer):
        return mamba2_step(config.mamba, h, layer, cursor, conv[i], ssm[i])

    return _hybrid_stack(config, x, params, attend, mix)


def lm_logits(config: DecoderConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits [..., vocab]; an int4 table goes through kernel B, an int8
    table through kernel D (their zero-padded rows are sliced off)."""
    table = params["embed_tokens"] if config.tie_word_embeddings else params["lm_head"]
    flat = hidden.reshape(-1, hidden.shape[-1])
    if isinstance(table, QuantizedWeight4):
        out = quantized_matmul4(flat, table)
    elif isinstance(table, QuantizedWeight):
        out = quantized_matmul(flat, table)
    else:
        out = matmul_f32(flat, table.T)
    return out[:, :config.vocab_size].reshape(*hidden.shape[:-1], config.vocab_size)


def _last_logits(config, params, x, lengths: Sequence[int]) -> torch.Tensor:
    rows = torch.arange(x.shape[0], device=x.device)
    last = synced(torch.tensor, [max(n - 1, 0) for n in lengths], device=x.device)
    return lm_logits(config, params, x[rows, last][:, None])[:, 0]


def prefill_scan(
    config: DecoderConfig, params: Params, input_embeds: torch.Tensor,
    positions: torch.Tensor, cache: KVCache, prompt_lengths: Sequence[int],
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill a padded prompt [b, s_pad, hidden] into a fresh cache; returns
    the logits at each row's last valid position and the cache with its
    cursors at the prompt lengths.  A hybrid stack's Mamba2 blocks leave
    each row's state as of its last valid token: pad positions step nothing."""
    b, s = input_embeds.shape[:2]
    if s > cache.k.shape[2]:
        raise ValueError(f"prefill chunk {s} exceeds the {cache.k.shape[2]}-token cache")
    device = input_embeds.device
    cos, sin = _position_tables(config, positions)
    lengths_dev = synced(torch.tensor, list(prompt_lengths), dtype=torch.int32, device=device)
    mask = causal_mask(s, s, device) + length_mask(s, lengths_dev)
    stacked = params["layers_stacked"]
    x = input_embeds
    if config.block_pattern is not None:
        def attend(i, h, layer):
            out, k, v = _attention(config, h, layer, cos, sin, mask, None, None, None)
            cache.k[i, :, :s] = k.to(cache.k.dtype)
            cache.v[i, :, :s] = v.to(cache.v.dtype)
            return out

        def mix(i, h, layer):
            return mamba2_prefill(config.mamba, h, layer, lengths_dev, cache.conv[i],
                                  cache.ssm[i])

        x = _hybrid_stack(config, x, params, attend, mix)
    else:
        for idx in range(num_stacked_layers(stacked)):
            x, k, v = _layer_body(
                config, x, _pick_layer(stacked, idx), cos, sin, mask, None, None, None
            )
            cache.k[idx, :, :s] = k.to(cache.k.dtype)
            cache.v[idx, :, :s] = v.to(cache.v.dtype)
        x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    cache.set_lengths(prompt_lengths)
    return _last_logits(config, params, x, prompt_lengths), cache


def extend_scan(
    config: DecoderConfig, params: Params, input_embeds: torch.Tensor,
    positions: torch.Tensor, cache: KVCache, new_lengths: Sequence[int],
) -> Tuple[torch.Tensor, KVCache]:
    """Append a padded chunk [b, s_pad, hidden] to an existing cache: the
    chunk attends jointly over each row's valid cached keys and itself, its
    K/V (padding included) land at each row's cursor, and the cursors move
    by the true lengths.  Returns the last valid position's logits."""
    starts = _check_room(cache, input_embeds.shape[1])
    n_valid = synced(torch.tensor, list(new_lengths), dtype=torch.int32,
                     device=input_embeds.device)
    logits = _extend_pass(config, params, input_embeds, positions, n_valid,
                          cache.k, cache.v, cache.lengths)
    cache.lengths_host = [a + n for a, n in zip(starts, new_lengths)]
    return logits, cache


def _check_room(cache: KVCache, s: int) -> list:
    """The host cursors, once each row has room for an s-token chunk."""
    max_len = cache.k.shape[2]
    starts = list(cache.lengths_host)
    if any(start + s > max_len for start in starts):
        raise ValueError(
            f"a {s}-token chunk at cursors {starts} overruns the {max_len}-token cache"
        )
    return starts


def _extend_pass(
    config: DecoderConfig, params: Params, x: torch.Tensor, positions: torch.Tensor,
    n_valid: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """The weight pass of ``extend_scan`` and of a lookahead window, which
    reads no host value and so can be captured as a CUDA graph: the chunk x
    [b, s, hidden] attends jointly over each row's cached keys below its
    cursor ``lengths`` [b] and over itself up to its valid length
    ``n_valid`` [b]; after the stack every layer's K/V of the whole chunk
    (padding included) lands at (row, cursor + 0..s-1) in one indexed store
    per tensor, and the cursors move by ``n_valid`` in place.  Returns the
    last valid position's logits [b, vocab]."""
    _refuse_hybrid(config, "extending a cache by a chunk (lookahead windows, chat turns)")
    b, s = x.shape[:2]
    device = x.device
    cos, sin = _position_tables(config, positions)
    kj = torch.arange(cache_k.shape[2], device=device)
    cache_mask = torch.where(kj[None, :] < lengths[:, None], 0.0, -1e30).to(
        torch.float32)[:, None, None, :]
    chunk_mask = causal_mask(s, s, device) + length_mask(s, n_valid)
    stacked = params["layers_stacked"]
    new_k, new_v = [], []
    for idx in range(num_stacked_layers(stacked)):
        x, k, v = _layer_body(
            config, x, _pick_layer(stacked, idx), cos, sin, chunk_mask,
            cache_k[idx], cache_v[idx], cache_mask,
        )
        new_k.append(k)
        new_v.append(v)
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    rows = torch.arange(b, device=device)
    cols = lengths.long()[:, None] + torch.arange(s, device=device)[None, :]
    cache_k[:, rows[:, None], cols] = torch.stack(new_k).to(cache_k.dtype)
    cache_v[:, rows[:, None], cols] = torch.stack(new_v).to(cache_v.dtype)
    lengths.add_(n_valid.to(lengths.dtype))
    last = torch.clamp_min(n_valid.long() - 1, 0)
    return lm_logits(config, params, x[rows, last][:, None])[:, 0]


# ---------------------------------------------------------------------------
# Constrained picking and sampling
# ---------------------------------------------------------------------------

class DecodeConstraint(NamedTuple):
    """Grammar state for constrained decode (tables from
    vis_tpu_torch.serving.schema / constrained, moved to the device).  The allowed
    set is token_ok[state] & (cost_after[state] < remaining), with closing
    moves blocked while remaining > min_remaining.  With ``table_idx`` the
    tables are stacked [T, S, K] (and ``class_of`` [T, V]) and each row
    reads its own grammar: the scheduler's slots mix free-form, generic-JSON
    and schema rows in one batch."""

    token_ok: torch.Tensor     # [S, K] bool (or [T, S, K] with table_idx)
    token_trans: torch.Tensor  # [S, K] int32 (or [T, S, K])
    cost_after: torch.Tensor   # [S, K] int32 (or [T, S, K])
    state: torch.Tensor        # [b] int
    remaining: torch.Tensor    # [b] int
    active: torch.Tensor       # [b] bool
    min_remaining: torch.Tensor  # [b] int
    class_of: Optional[torch.Tensor] = None  # [V] (or [T, V]) column of each vocab id
    table_idx: Optional[torch.Tensor] = None  # [b] grammar of each row


def constrained_pick(logits: torch.Tensor, constraint: DecodeConstraint,
                     pick_fn: Callable[[torch.Tensor], torch.Tensor]):
    """Mask the logits to grammar-legal, budget-feasible tokens (every
    column past the table width too), pick with ``pick_fn``, advance the
    DFA.  Inactive rows see the raw logits.  Returns (token [b],
    constraint')."""
    c = constraint
    state = c.state.long()
    stacked = c.token_ok.dim() == 3
    tbl = c.table_idx.long() if stacked else None
    ok_row = c.token_ok[tbl, state] if stacked else c.token_ok[state]
    cost_row = c.cost_after[tbl, state] if stacked else c.cost_after[state]
    if c.class_of is not None:
        cls_rows = (c.class_of[tbl] if stacked
                    else c.class_of[None].expand(ok_row.shape[0], -1)).long()
        ok_row = torch.gather(ok_row, 1, cls_rows)
        cost_row = torch.gather(cost_row, 1, cls_rows)
    k = ok_row.shape[-1]
    feasible = ok_row & (cost_row < c.remaining[:, None])
    open_opts = feasible & (cost_row > 0)
    floor_on = (c.remaining > c.min_remaining) & open_opts.any(dim=-1)
    allowed = torch.where(floor_on[:, None], open_opts, feasible)
    allowed = allowed | ~c.active[:, None]
    head = torch.where(allowed, logits[:, :k], -1e30)
    if logits.shape[-1] > k:
        tail = torch.where(c.active[:, None], -1e30, logits[:, k:])
        masked = torch.cat([head, tail], dim=-1)
    else:
        masked = head
    token = pick_fn(masked).to(torch.int64)
    clipped = torch.clamp_max(token, k - 1)
    col = clipped if c.class_of is None else cls_rows.gather(1, clipped[:, None])[:, 0]
    trans = c.token_trans[tbl, state, col] if stacked else c.token_trans[state, col]
    new_state = torch.where(c.active, trans.to(c.state.dtype), c.state)
    return token, c._replace(state=new_state, remaining=c.remaining - 1)


def constrained_argmax(logits: torch.Tensor, constraint: DecodeConstraint):
    return constrained_pick(logits, constraint, lambda m: torch.argmax(m, dim=-1))


def gumbel_sample_token(logits: torch.Tensor, uniforms: torch.Tensor,
                        temperature) -> torch.Tensor:
    """Gumbel-max sampling with caller-drawn uniforms in (0, 1] (the same
    [b, V] shape as the logits); rows with temperature <= 0 take the exact
    greedy argmax."""
    temp = _to_device(temperature, torch.float32, logits.device)
    temp = temp.expand(logits.shape[0])
    gumbel = -torch.log(-torch.log(uniforms))
    sampled = torch.argmax(logits / torch.clamp_min(temp, 1e-6)[:, None] + gumbel, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temp > 0, sampled, greedy)


class TokenPicker:
    """The token choice of the decode loops, ``picker(logits) ->
    token [b]``: argmax, or with ``draw_uniforms`` Gumbel-max at
    ``temperature`` (one draw of the logits' shape a step), either under
    the grammar mask of ``constraint`` when one is given, whose DFA then
    advances with every pick (``picker.constraint`` holds the latest)."""

    def __init__(self, constraint: Optional[DecodeConstraint] = None,
                 draw_uniforms: Optional[Callable[[Tuple[int, ...]], torch.Tensor]] = None,
                 temperature=None):
        self.constraint = constraint
        self.draw_uniforms = draw_uniforms
        self.temperature = temperature

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        if self.draw_uniforms is None:
            def choose(m):
                return torch.argmax(m, dim=-1)
        else:
            u = self.draw_uniforms(tuple(logits.shape))

            def choose(m):
                return gumbel_sample_token(m, u, self.temperature)
        if self.constraint is None:
            return choose(logits)
        token, self.constraint = constrained_pick(logits, self.constraint, choose)
        return token


# ---------------------------------------------------------------------------
# Lookahead decode
# ---------------------------------------------------------------------------

# One capture at a time in the process: the dual-VLM node's two engines
# each capture their requests' windows from their own threads.
_CAPTURE_LOCK = threading.Lock()
# Each thread's side stream per device, for warm-ups and captures: a graph
# is captured off the legacy default stream, two threads never capture on
# one stream, and cuBLAS keeps one workspace per (handle, stream) for good.
_SIDE_STREAMS = threading.local()


def _side_stream(device: torch.device):
    streams = _SIDE_STREAMS.__dict__.setdefault("by_device", {})
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


class WindowPass:
    """One request's lookahead window pass, ``lookahead_decode``'s
    ``extend``, run from static buffers: each window's tokens [b, window]
    int64, valid mask [b, window] bool and positions [b, window] int32 are
    copied in on the device, and ``_extend_pass`` runs the embedded window
    against the cache's k, v and cursors, bound once (the cursors are only
    ever written in place), leaving the last valid logits [b, vocab] in
    ``logits`` until the next window.

    On a CUDA cache the first window runs eagerly on a side stream (the
    warm-up: lazy allocations and library workspaces), the second is
    captured there as a CUDA graph (``capture_s`` seconds), and it and
    every later window replay the graph, each replay a ``decode.replay``
    span: one host launch for all the stack's kernels (~2,200 a
    Qwen2.5-VL-7B window), each still counted in its wrapper's
    ``launches``.  On a CPU cache every window runs eagerly."""

    def __init__(self, config: DecoderConfig, params: Params, cache: KVCache, window: int):
        b, device = cache.k.shape[1], cache.k.device
        self.config, self.params, self.window = config, params, window
        self.k, self.v, self.lengths = cache.k, cache.v, cache.lengths
        self.tokens = torch.zeros((b, window), dtype=torch.int64, device=device)
        self.valid = torch.zeros((b, window), dtype=torch.bool, device=device)
        self.positions = torch.zeros((b, window), dtype=torch.int32, device=device)
        self.logits: Optional[torch.Tensor] = None
        self.on_card = device.type == "cuda"
        self.graph = None
        self.launched: dict = {}  # the kernels' launches in one replay
        self.capture_s: Optional[float] = None
        self.windows = 0

    def binds(self, cache: KVCache, params: Params, window: int) -> bool:
        return (cache.k is self.k and cache.v is self.v and cache.lengths is self.lengths
                and params is self.params and window == self.window)

    def _run(self) -> None:
        positions = self.positions
        if self.config.mrope_section is not None:
            positions = positions[None].expand(3, *positions.shape)
        x = embed(self.tokens, self.params["embed_tokens"])
        self.logits = _extend_pass(self.config, self.params, x, positions,
                                   self.valid.sum(dim=1), self.k, self.v, self.lengths)

    def _warm_up(self) -> None:
        main = torch.cuda.current_stream(self.k.device)
        side = _side_stream(self.k.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._run()
        main.wait_stream(side)

    def _capture(self) -> None:
        """The pass as a CUDA graph, captured on the thread's side stream.
        By hand rather than through ``torch.cuda.graph``, which synchronizes
        the device and empties the allocator's caches before each capture:
        here once a request, beside the other engine's work."""
        graph = torch.cuda.CUDAGraph()
        start = time.perf_counter()
        with _CAPTURE_LOCK, captured_launches() as launched, \
                torch.cuda.stream(_side_stream(self.k.device)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._run()
            finally:
                graph.capture_end()
        self.capture_s = time.perf_counter() - start
        self.graph, self.launched = graph, launched

    def __call__(self, w_tokens: torch.Tensor, w_valid: torch.Tensor,
                 positions: torch.Tensor, cache: KVCache,
                 valid_len: Sequence[int]) -> Tuple[torch.Tensor, KVCache]:
        starts = _check_room(cache, self.window)
        self.tokens.copy_(w_tokens)
        self.valid.copy_(w_valid)
        self.positions.copy_(positions)
        if not self.on_card:
            self._run()
        elif self.windows == 0:
            self._warm_up()
        else:
            if self.graph is None:
                self._capture()
            with span("decode.replay", timed=False):
                self.graph.replay()
            add_launches(self.launched)
        self.windows += 1
        cache.lengths_host = [a + n for a, n in zip(starts, valid_len)]
        return self.logits, cache


def decode_loop_lookahead(
    config: DecoderConfig, params: Params, first_logits: torch.Tensor,
    start_position, cache: KVCache, constraint: DecodeConstraint,
    forced_token: torch.Tensor, forced_state: torch.Tensor,
    num_windows: int, window: int,
    draw_uniforms: Optional[Callable[[Tuple[int, ...]], torch.Tensor]] = None,
    temperature=None, eos_id: Optional[int] = None,
):
    """``lookahead_decode`` through this decoder's stack: each window is
    one pass of the cache's ``WindowPass`` (M-RoPE positions repeat the
    window's positions on all three axes), which the cache keeps for every
    later call of the request: on the card its windows after the first
    replay one CUDA graph.  The last logits returned are a copy, free of
    the next window's."""
    _refuse_hybrid(config, "the lookahead window pass")
    runner = cache.window_pass
    if runner is None or not runner.binds(cache, params, window):
        runner = cache.window_pass = WindowPass(config, params, cache, window)
    tokens, valid, logits, cache, constraint = lookahead_decode(
        first_logits, start_position, cache, constraint, forced_token, forced_state,
        num_windows, window, runner, draw_uniforms, temperature, eos_id)
    return tokens, valid, logits.clone(), cache, constraint


def lookahead_decode(
    first_logits: torch.Tensor, start_position, cache: KVCache,
    constraint: DecodeConstraint, forced_token: torch.Tensor,
    forced_state: torch.Tensor, num_windows: int, window: int,
    extend: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, KVCache, Sequence[int]],
                     Tuple[torch.Tensor, KVCache]],
    draw_uniforms: Optional[Callable[[Tuple[int, ...]], torch.Tensor]] = None,
    temperature=None, eos_id: Optional[int] = None,
):
    """Constrained decode emitting up to ``window`` tokens per weight pass.

    Each window: pick position 0 under the grammar mask (argmax, or Gumbel
    sampling at ``temperature`` with uniforms from ``draw_uniforms(shape)``),
    follow the DFA's forced moves for positions 1.. (``forced_token`` /
    ``forced_state``, -1 where the state has a choice), then run the window
    through the model in one pass, ``extend(tokens [b, window], valid
    [b, window], positions [b, window], cache, valid lengths as a host
    list) -> (last valid logits, cache)``, which writes the window's K/V at
    each row's cursor and moves the cursors (device and host mirror) by the
    valid lengths.  The window's tokens come to the host once; with
    ``eos_id`` a row is done once its valid span holds EOS, its cursor and
    position freeze, and the loop stops when every row is done.  Each
    window is one ``decode.pass`` span, and each of its blocking transfers
    a ``sync`` one (through ``decode_loop_lookahead`` only the window's
    read-back; a sampled call sends its temperature once, before the
    first window).

    Returns (tokens [b, num_windows, window], valid [b, num_windows, window]
    on the host, last logits, cache, constraint).
    """
    b = first_logits.shape[0]
    device = first_logits.device
    pos = _to_device(start_position, torch.int32, device).expand(b).clone()
    offs = torch.arange(window, dtype=torch.int32, device=device)
    fill = eos_id if eos_id is not None else 0
    tokens_out = torch.full((b, num_windows, window), fill, dtype=torch.int64)
    valid_out = torch.zeros((b, num_windows, window), dtype=torch.bool)
    done = torch.zeros((b,), dtype=torch.bool)
    logits = first_logits
    if draw_uniforms is not None:  # one transfer a call, not one a window
        temperature = _to_device(temperature, torch.float32, device)
    picker = TokenPicker(constraint, draw_uniforms, temperature)
    # The forced tables in the chain's dtypes, once a call: the chain's
    # launches are the host's work between two replays.
    forced_token = forced_token.long()
    forced_state = forced_state.to(constraint.state.dtype)

    for win in range(num_windows):
        if eos_id is not None and bool(done.all()):
            break
        with span("decode.pass", timed=False):
            t0 = picker(logits)
            con = picker.constraint
            state = con.state
            alive = torch.ones((b,), dtype=torch.bool, device=device)
            chain_toks, chain_ok = [], []
            for _ in range(window - 1):
                ft = forced_token[state]
                ok = alive & (ft >= 0)
                chain_toks.append(torch.where(ok, ft, 0))
                chain_ok.append(ok)
                state = torch.where(ok, forced_state[state], state)
                alive = ok
            w_tokens = torch.stack([t0] + chain_toks, dim=1)
            w_valid = torch.stack([torch.ones_like(alive)] + chain_ok, dim=1)
            forced_n = w_valid.sum(dim=1) - 1
            picker.constraint = con._replace(
                state=state, remaining=con.remaining - forced_n.to(con.remaining.dtype))

            host = synced(torch.cat([w_tokens, w_valid.to(torch.int64)], dim=1).cpu)
            h_tokens, h_valid = host[:, :window], host[:, window:].bool()
            valid_len = h_valid.sum(dim=1).tolist()

            prev_lengths, prev_pos = list(cache.lengths_host), pos
            logits, cache = extend(w_tokens, w_valid, pos[:, None] + offs[None, :], cache,
                                   valid_len)
            pos = pos + w_valid.sum(dim=1, dtype=torch.int32)

            if eos_id is not None:
                h_valid = h_valid & ~done[:, None]
                if bool(done.any()):
                    frozen = done.tolist()
                    cache.set_lengths([p if f else n for p, n, f in
                                       zip(prev_lengths, cache.lengths_host, frozen)])
                    pos = torch.where(synced(done.to, device), prev_pos, pos)
                done = done | (h_valid & (h_tokens == eos_id)).any(dim=1)
            tokens_out[:, win] = h_tokens
            valid_out[:, win] = h_valid
    return tokens_out, valid_out, logits, cache, picker.constraint


# ---------------------------------------------------------------------------
# Token-per-pass decode over a dense cache
# ---------------------------------------------------------------------------

def _eos_loop(slots: int, num_steps: int, eos_id: int, budget: Optional[Sequence[int]],
              step_fn, device) -> torch.Tensor:
    """The early-exit scaffold of every token-per-pass decode loop (dense,
    paged, and the loop engine's): run ``step_fn(step_idx) -> token
    [slots]`` until every row has emitted EOS or spent its per-row
    ``budget`` (a host list, None for ``num_steps`` each; rows with budget
    <= 0 start done: inactive scheduler slots), checking ``done`` on the
    host once per step as the JAX loop's condition does.  Token slots past
    a row's EOS read ``eos_id``.  Returns tokens [slots, num_steps].

    CURSOR CONTRACT (the JAX package's): done rows keep stepping, their
    recorded token masked to ``eos_id``, and their cursors still advance
    past garbage writes; a caller chaining chunks rewinds them on the host."""
    budget = [num_steps] * slots if budget is None else list(budget)
    tokens = torch.full((slots, num_steps), eos_id, dtype=torch.int64, device=device)
    budget_dev = synced(torch.tensor, budget, dtype=torch.int64, device=device)
    done = budget_dev <= 0
    for step_idx in range(min(num_steps, max(budget))):
        if synced(bool, done.all()):
            break
        with span("decode.pass", timed=False):
            token = torch.where(done, eos_id, step_fn(step_idx))
            tokens[:, step_idx] = token
            done = done | (token == eos_id) | (step_idx + 1 >= budget_dev)
    return tokens


def _dense_token_step(
    config: DecoderConfig, params: Params, token: torch.Tensor, pos_vec: torch.Tensor,
    cache: KVCache, lengths: torch.Tensor,
) -> torch.Tensor:
    """One decode step for every row over a dense cache: embed the picked
    token [b], run the stacked layers against each row's cached keys below
    its device cursor ``lengths`` (the new token attends to itself out of
    the cache), then write every layer's new K/V in place at (row,
    lengths[row]) in one indexed store.  Returns the next logits [b,
    vocab]; the caller advances ``lengths``.  No host cursor is read.  A
    hybrid stack steps each row's Mamba2 state in the cache in place."""
    b = token.shape[0]
    positions = pos_vec[:, None]
    if config.mrope_section is not None:
        positions = positions[None].expand(3, b, 1)
    cos, sin = _position_tables(config, positions)
    x = embed(token[:, None], params["embed_tokens"])
    kj = torch.arange(cache.k.shape[2], device=token.device)
    cache_mask = torch.where(kj[None, :] < lengths[:, None], 0.0, -1e30).to(
        torch.float32)[:, None, None, :]
    stacked = params["layers_stacked"]
    new_k, new_v = [], []
    if config.block_pattern is not None:
        x = _hybrid_decode(config, x, params, lambda i: (cache.k[i], cache.v[i]), cache_mask,
                           lengths, cache.conv, cache.ssm, new_k, new_v)
    else:
        for idx in range(num_stacked_layers(stacked)):
            x, k, v = _layer_body(
                config, x, _pick_layer(stacked, idx), cos, sin, None,
                cache.k[idx], cache.v[idx], cache_mask,
            )
            new_k.append(k[:, 0])
            new_v.append(v[:, 0])
        x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    logits = lm_logits(config, params, x)[:, 0]
    rows = torch.arange(b, device=token.device)
    cursor = lengths.long()
    cache.k[:, rows, cursor] = torch.stack(new_k).to(cache.k.dtype)
    cache.v[:, rows, cursor] = torch.stack(new_v).to(cache.v.dtype)
    return logits


def _dense_loop(
    config: DecoderConfig, params: Params, first_logits: torch.Tensor, start_position,
    cache: KVCache, num_steps: int, eos_id: int, budget: Optional[Sequence[int]],
    pick: Callable[[torch.Tensor], torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense decode loops' body: ``pick(logits) -> token``, one
    ``_dense_token_step`` a token on the ``_eos_loop`` scaffold.  The
    cache is updated in place, its device cursors advanced by the steps
    run (done rows too, as the cursor contract says) and its host mirror
    set to match.  Returns (tokens [b, num_steps], last logits)."""
    b = first_logits.shape[0]
    device = first_logits.device
    start = _to_device(start_position, torch.int32, device).expand(b)
    carry = {"logits": first_logits, "lengths": cache.lengths, "steps": 0}

    def step(step_idx):
        token = pick(carry["logits"])
        carry["logits"] = _dense_token_step(
            config, params, token, start + step_idx, cache, carry["lengths"])
        carry["lengths"] = carry["lengths"] + 1
        carry["steps"] += 1
        return token

    tokens = _eos_loop(b, num_steps, eos_id, budget, step, device)
    cache.lengths.copy_(carry["lengths"])
    cache.lengths_host = [n + carry["steps"] for n in cache.lengths_host]
    return tokens, carry["logits"]


def decode_loop_scan(
    config: DecoderConfig, params: Params, first_logits: torch.Tensor, start_position,
    cache: KVCache, num_steps: int, *, eos_id: int, budget: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Greedy decode of up to ``num_steps`` tokens per row over a dense
    cache, ending once every row has emitted EOS or spent its host-side
    ``budget``.  Returns (tokens [b, num_steps] on the device, last logits,
    cache)."""
    tokens, logits = _dense_loop(config, params, first_logits, start_position, cache,
                                 num_steps, eos_id, budget, TokenPicker())
    return tokens, logits, cache


def decode_loop_scan_sampled(
    config: DecoderConfig, params: Params, first_logits: torch.Tensor, start_position,
    cache: KVCache, draw_uniforms: Callable[[Tuple[int, ...]], torch.Tensor], temperature,
    num_steps: int, *, eos_id: int, budget: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """``decode_loop_scan`` with Gumbel-max sampling at ``temperature``
    (a scalar or [b]; rows at <= 0 stay exact-greedy), one draw of
    ``draw_uniforms(logits.shape)`` a step, uniforms in (0, 1]."""
    tokens, logits = _dense_loop(config, params, first_logits, start_position, cache,
                                 num_steps, eos_id, budget,
                                 TokenPicker(None, draw_uniforms, temperature))
    return tokens, logits, cache


def decode_loop_scan_constrained(
    config: DecoderConfig, params: Params, first_logits: torch.Tensor, start_position,
    cache: KVCache, constraint: DecodeConstraint, num_steps: int, *, eos_id: int,
    budget: Optional[Sequence[int]] = None,
    draw_uniforms: Optional[Callable[[Tuple[int, ...]], torch.Tensor]] = None,
    temperature=None,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache, DecodeConstraint]:
    """``decode_loop_scan`` under a grammar mask, the DFA carried across
    steps and returned so that chunked callers continue it; with
    ``draw_uniforms`` every pick is Gumbel-max sampled at ``temperature``
    over the masked logits.  Returns (tokens, last logits, cache,
    constraint)."""
    picker = TokenPicker(constraint, draw_uniforms, temperature)
    tokens, logits = _dense_loop(config, params, first_logits, start_position, cache,
                                 num_steps, eos_id, budget, picker)
    return tokens, logits, cache, picker.constraint


# ---------------------------------------------------------------------------
# Paged decode (the continuous-batching scheduler's slots)
# ---------------------------------------------------------------------------

def _paged_token_step(
    config: DecoderConfig, params: Params, token: torch.Tensor, pos_vec: torch.Tensor,
    pool_k: torch.Tensor, pool_v: torch.Tensor, page_tables: torch.Tensor,
    lengths: torch.Tensor, state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """One decode step for every slot over a paged KV pool
    (pool [L, n_pages, page, kvh, hd], page_tables [slots, max_pages]):
    each layer gathers a slot's pages into a [slots, max_pages * page] key
    window masked past its cursor, the new token attends to itself out of
    the pool, and after the stack every layer's new K/V lands in place at
    (page_tables[i, len // page], len % page).  Returns the next logits
    [slots, vocab]; the caller advances ``lengths``.  A hybrid stack's
    Mamba2 blocks step ``state`` = (conv [n_mamba, slots, conv_dim, 4],
    ssm [n_mamba, slots, H, P, N]), the slots' rows, in place."""
    slots, max_pages = page_tables.shape
    page = pool_k.shape[2]
    width = max_pages * page
    positions = pos_vec[:, None]
    if config.mrope_section is not None:
        positions = positions[None].expand(3, slots, 1)
    cos, sin = _position_tables(config, positions)
    x = embed(token[:, None], params["embed_tokens"])
    kj = torch.arange(width, device=token.device)
    cache_mask = torch.where(kj[None, :] < lengths[:, None], 0.0, -1e30).to(
        torch.float32)[:, None, None, :]
    stacked = params["layers_stacked"]
    new_k, new_v = [], []
    if config.block_pattern is not None:
        def kv(i):
            return (pool_k[i][page_tables].reshape(slots, width, *pool_k.shape[3:]),
                    pool_v[i][page_tables].reshape(slots, width, *pool_v.shape[3:]))

        x = _hybrid_decode(config, x, params, kv, cache_mask, lengths, state[0], state[1],
                           new_k, new_v)
    else:
        for idx in range(num_stacked_layers(stacked)):
            ck = pool_k[idx][page_tables].reshape(slots, width, *pool_k.shape[3:])
            cv = pool_v[idx][page_tables].reshape(slots, width, *pool_v.shape[3:])
            x, k, v = _layer_body(
                config, x, _pick_layer(stacked, idx), cos, sin, None, ck, cv, cache_mask
            )
            new_k.append(k[:, 0])
            new_v.append(v[:, 0])
        x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    logits = lm_logits(config, params, x)[:, 0]
    rows = torch.arange(slots, device=token.device)
    page_idx = page_tables[rows, torch.div(lengths, page, rounding_mode="floor").long()].long()
    offset = (lengths % page).long()
    pool_k[:, page_idx, offset] = torch.stack(new_k).to(pool_k.dtype)
    pool_v[:, page_idx, offset] = torch.stack(new_v).to(pool_v.dtype)
    return logits


def decode_loop_paged(
    config: DecoderConfig, params: Params, first_logits: torch.Tensor,
    start_position: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
    page_tables: torch.Tensor, lengths: torch.Tensor, num_steps: int, *,
    eos_id: int, budget: Sequence[int],
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Greedy decode of up to ``num_steps`` tokens for every slot over the
    paged pool (updated in place), ending once every row has hit EOS or its
    host-side ``budget``; a hybrid stack also steps the slots' recurrent
    ``state`` in place.  Returns (tokens [slots, num_steps] on the device,
    last logits, pool_k, pool_v, lengths)."""
    slots = page_tables.shape[0]
    start = _to_device(start_position, torch.int32, first_logits.device).expand(slots)
    carry = {"logits": first_logits, "lengths": lengths}
    picker = TokenPicker()

    def step(step_idx):
        token = picker(carry["logits"])
        carry["logits"] = _paged_token_step(
            config, params, token, start + step_idx, pool_k, pool_v, page_tables,
            carry["lengths"], state)
        carry["lengths"] = carry["lengths"] + 1
        return token

    tokens = _eos_loop(slots, num_steps, eos_id, budget, step, first_logits.device)
    return tokens, carry["logits"], pool_k, pool_v, carry["lengths"]


def decode_loop_paged_constrained(
    config: DecoderConfig, params: Params, first_logits: torch.Tensor,
    start_position: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
    page_tables: torch.Tensor, lengths: torch.Tensor, constraint: DecodeConstraint,
    num_steps: int, *, eos_id: int, budget: Sequence[int],
    draw_uniforms: Optional[Callable[[Tuple[int, ...]], torch.Tensor]] = None,
    temperature=None, state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """``decode_loop_paged`` with each row's grammar mask (rows with
    ``active`` False decode free-form).  With ``draw_uniforms`` every step
    samples Gumbel-max per row at ``temperature`` ([slots]; rows at <= 0
    stay exact-greedy) from ``draw_uniforms(logits.shape)``, uniforms in
    (0, 1].  Returns (tokens, last logits, pool_k, pool_v, lengths,
    constraint)."""
    slots = page_tables.shape[0]
    start = _to_device(start_position, torch.int32, first_logits.device).expand(slots)
    carry = {"logits": first_logits, "lengths": lengths}
    picker = TokenPicker(constraint, draw_uniforms, temperature)

    def step(step_idx):
        token = picker(carry["logits"])
        carry["logits"] = _paged_token_step(
            config, params, token, start + step_idx, pool_k, pool_v, page_tables,
            carry["lengths"], state)
        carry["lengths"] = carry["lengths"] + 1
        return token

    tokens = _eos_loop(slots, num_steps, eos_id, budget, step, first_logits.device)
    return tokens, carry["logits"], pool_k, pool_v, carry["lengths"], picker.constraint


__all__ = [
    "DecodeConstraint",
    "DecoderConfig",
    "HybridDecoderConfig",
    "TokenPicker",
    "WindowPass",
    "constrained_argmax",
    "constrained_pick",
    "decode_loop_lookahead",
    "decode_loop_paged",
    "decode_loop_paged_constrained",
    "decode_loop_scan",
    "decode_loop_scan_constrained",
    "decode_loop_scan_sampled",
    "extend_scan",
    "fuse_stacked_projections",
    "gumbel_sample_token",
    "init_decoder_params",
    "lm_logits",
    "lookahead_decode",
    "new_cache",
    "params_from_numpy",
    "prefill_scan",
    "quantize_stacked_params",
    "stack_decoder_layers",
]
