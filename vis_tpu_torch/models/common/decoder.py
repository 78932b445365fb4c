"""GQA transformer decoder: the Qwen2.5-VL and Llama text stacks.

Counterpart of the scan-execution half of ``vis_tpu/models/common/decoder.py``.
Layer parameters are stacked ([L, ...] leaves, int4 leaves as
``QuantizedWeight4`` with q [L, O, I/2]); a Python loop over layers takes
the place of ``lax.scan``, and ``_pick_layer`` hands each layer's int4
weights to kernel A as a view of the stack.  Cache cursors are kept on the
host too, so writing a chunk's K/V never reads the device.

Decode over a dense per-request cache is ``decode_loop_lookahead``:
schema-constrained windows of ``window`` tokens, one weight pass and one
host sync per window.  Decode over the scheduler's paged KV pool is
``decode_loop_paged`` (greedy) and ``decode_loop_paged_constrained`` (a
per-row grammar over stacked tables, greedy or per-row Gumbel-sampled),
one token per weight pass for every slot at once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vis_tpu_torch.models.common.layers import (
    KVCache,
    apply_rope,
    causal_mask,
    embed,
    length_mask,
    linear,
    matmul_f32,
    mrope_cos_sin,
    rms_norm,
    rope_cos_sin,
    swiglu_mlp,
)
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

    @property
    def rope_scaling_dict(self) -> Optional[Dict[str, Any]]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


def _position_tables(config: DecoderConfig, positions: torch.Tensor):
    """cos/sin [b, s, head_dim]; positions [b, s] or [3, b, s] (M-RoPE)."""
    if config.mrope_section is not None:
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        return mrope_cos_sin(
            positions, config.head_dim_, config.mrope_section, config.rope_theta
        )
    return rope_cos_sin(positions, config.head_dim_, config.rope_theta,
                        config.rope_scaling_dict)


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
    b, s, _ = x.shape
    hd = config.head_dim_
    h = rms_norm(x, layer["input_norm"], config.rms_norm_eps)
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
    out = out.reshape(b, s, config.num_heads * hd).to(x.dtype)
    x = x + linear(out, layer["o_proj"])
    h = rms_norm(x, layer["post_attn_norm"], config.rms_norm_eps)
    x = x + swiglu_mlp(h, layer["mlp"])
    return x, k, v


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
    last = torch.tensor([max(n - 1, 0) for n in lengths], device=x.device)
    return lm_logits(config, params, x[rows, last][:, None])[:, 0]


def prefill_scan(
    config: DecoderConfig, params: Params, input_embeds: torch.Tensor,
    positions: torch.Tensor, cache: KVCache, prompt_lengths: Sequence[int],
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill a padded prompt [b, s_pad, hidden] into a fresh cache; returns
    the logits at each row's last valid position and the cache with its
    cursors at the prompt lengths."""
    b, s = input_embeds.shape[:2]
    if s > cache.k.shape[2]:
        raise ValueError(f"prefill chunk {s} exceeds the {cache.k.shape[2]}-token cache")
    device = input_embeds.device
    cos, sin = _position_tables(config, positions)
    lengths_dev = torch.tensor(list(prompt_lengths), dtype=torch.int32, device=device)
    mask = causal_mask(s, s, device) + length_mask(s, lengths_dev)
    stacked = params["layers_stacked"]
    x = input_embeds
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
    s = input_embeds.shape[1]
    max_len = cache.k.shape[2]
    starts = list(cache.lengths_host)
    if any(start + s > max_len for start in starts):
        raise ValueError(
            f"a {s}-token chunk at cursors {starts} overruns the {max_len}-token cache"
        )
    device = input_embeds.device
    cos, sin = _position_tables(config, positions)
    kj = torch.arange(max_len, device=device)
    cache_mask = torch.where(
        kj[None, :] < cache.lengths[:, None], 0.0, -1e30
    ).to(torch.float32)[:, None, None, :]
    new_dev = torch.tensor(list(new_lengths), dtype=torch.int32, device=device)
    chunk_mask = causal_mask(s, s, device) + length_mask(s, new_dev)
    stacked = params["layers_stacked"]
    x = input_embeds
    for idx in range(num_stacked_layers(stacked)):
        x, k, v = _layer_body(
            config, x, _pick_layer(stacked, idx), cos, sin, chunk_mask,
            cache.k[idx], cache.v[idx], cache_mask,
        )
        for row, start in enumerate(starts):
            cache.k[idx, row, start:start + s] = k[row].to(cache.k.dtype)
            cache.v[idx, row, start:start + s] = v[row].to(cache.v.dtype)
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    cache.set_lengths([a + n for a, n in zip(starts, new_lengths)])
    return _last_logits(config, params, x, new_lengths), cache


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
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    temp = temp.expand(logits.shape[0])
    gumbel = -torch.log(-torch.log(uniforms))
    sampled = torch.argmax(logits / torch.clamp_min(temp, 1e-6)[:, None] + gumbel, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temp > 0, sampled, greedy)


# ---------------------------------------------------------------------------
# Lookahead decode
# ---------------------------------------------------------------------------

def decode_loop_lookahead(
    config: DecoderConfig, params: Params, first_logits: torch.Tensor,
    start_position, cache: KVCache, constraint: DecodeConstraint,
    forced_token: torch.Tensor, forced_state: torch.Tensor,
    num_windows: int, window: int,
    draw_uniforms: Optional[Callable[[Tuple[int, ...]], torch.Tensor]] = None,
    temperature=None, eos_id: Optional[int] = None,
):
    """Constrained decode emitting up to ``window`` tokens per weight pass.

    Each window: pick position 0 under the grammar mask (argmax, or Gumbel
    sampling at ``temperature`` with uniforms from ``draw_uniforms(shape)``),
    follow the DFA's forced moves for positions 1.. (``forced_token`` /
    ``forced_state``, -1 where the state has a choice), then run the window
    through the stack in one extend pass.  The window's tokens come to the
    host once (the loop's one sync); with ``eos_id`` a row is done once its
    valid span holds EOS, its cursor and position freeze, and the loop stops
    when every row is done.

    Returns (tokens [b, num_windows, window], valid [b, num_windows, window]
    on the host, last logits, cache, constraint).
    """
    b = first_logits.shape[0]
    device = first_logits.device
    sampled = draw_uniforms is not None
    pos = torch.as_tensor(start_position, dtype=torch.int32, device=device).expand(b).clone()
    offs = torch.arange(window, dtype=torch.int32, device=device)
    fill = eos_id if eos_id is not None else 0
    tokens_out = torch.full((b, num_windows, window), fill, dtype=torch.int64)
    valid_out = torch.zeros((b, num_windows, window), dtype=torch.bool)
    done = torch.zeros((b,), dtype=torch.bool)
    logits, con = first_logits, constraint

    for win in range(num_windows):
        if eos_id is not None and bool(done.all()):
            break
        if sampled:
            u = draw_uniforms(tuple(logits.shape))
            t0, con = constrained_pick(
                logits, con, lambda m: gumbel_sample_token(m, u, temperature)
            )
        else:
            t0, con = constrained_argmax(logits, con)

        state, remaining = con.state, con.remaining
        alive = torch.ones((b,), dtype=torch.bool, device=device)
        chain_toks, chain_ok = [], []
        for _ in range(window - 1):
            ft = forced_token[state.long()]
            ok = alive & (ft >= 0)
            chain_toks.append(torch.where(ok, ft, 0).to(torch.int64))
            chain_ok.append(ok)
            state = torch.where(ok, forced_state[state.long()].to(state.dtype), state)
            remaining = remaining - ok.to(remaining.dtype)
            alive = ok
        con = con._replace(state=state, remaining=remaining)
        w_tokens = torch.stack([t0] + chain_toks, dim=1)
        w_valid = torch.stack([torch.ones_like(alive)] + chain_ok, dim=1)

        host = torch.cat([w_tokens, w_valid.to(torch.int64)], dim=1).cpu()
        h_tokens, h_valid = host[:, :window], host[:, window:].bool()
        valid_len = h_valid.sum(dim=1).tolist()

        prev_lengths, prev_pos = list(cache.lengths_host), pos
        embeds = embed(w_tokens, params["embed_tokens"])
        pos_mat = pos[:, None] + offs[None, :]
        positions = (pos_mat[None].expand(3, b, window)
                     if config.mrope_section is not None else pos_mat)
        logits, cache = extend_scan(config, params, embeds, positions, cache, valid_len)
        pos = pos + torch.tensor(valid_len, dtype=torch.int32, device=device)

        if eos_id is not None:
            h_valid = h_valid & ~done[:, None]
            if bool(done.any()):
                frozen = done.tolist()
                cache.set_lengths([p if f else n for p, n, f in
                                   zip(prev_lengths, cache.lengths_host, frozen)])
                pos = torch.where(done.to(device), prev_pos, pos)
            done = done | (h_valid & (h_tokens == eos_id)).any(dim=1)
        tokens_out[:, win] = h_tokens
        valid_out[:, win] = h_valid
    return tokens_out, valid_out, logits, cache, con


# ---------------------------------------------------------------------------
# Paged decode (the continuous-batching scheduler's slots)
# ---------------------------------------------------------------------------

def _paged_token_step(
    config: DecoderConfig, params: Params, token: torch.Tensor, pos_vec: torch.Tensor,
    pool_k: torch.Tensor, pool_v: torch.Tensor, page_tables: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """One decode step for every slot over a paged KV pool
    (pool [L, n_pages, page, kvh, hd], page_tables [slots, max_pages]):
    each layer gathers a slot's pages into a [slots, max_pages * page] key
    window masked past its cursor, the new token attends to itself out of
    the pool, and after the stack every layer's new K/V lands in place at
    (page_tables[i, len // page], len % page).  Returns the next logits
    [slots, vocab]; the caller advances ``lengths``."""
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


def _eos_loop(slots: int, num_steps: int, eos_id: int, budget: Sequence[int],
              step_fn, device) -> torch.Tensor:
    """The early-exit scaffold of the paged decode loops: run
    ``step_fn(step_idx) -> token [slots]`` until every row has emitted EOS
    or spent its per-row ``budget`` (a host list; rows with budget <= 0
    start done: inactive scheduler slots), checking ``done`` on the host
    once per step as the JAX loop's condition does.  Token slots past a
    row's EOS read ``eos_id``.  Returns tokens [slots, num_steps].

    CURSOR CONTRACT (the JAX package's): done rows keep stepping, their
    recorded token masked to ``eos_id``, and their cursors still advance
    past garbage writes; a caller chaining chunks rewinds them on the host."""
    tokens = torch.full((slots, num_steps), eos_id, dtype=torch.int64, device=device)
    budget_dev = torch.tensor(list(budget), dtype=torch.int64, device=device)
    done = budget_dev <= 0
    for step_idx in range(min(num_steps, max(budget))):
        if bool(done.all()):
            break
        token = torch.where(done, eos_id, step_fn(step_idx))
        tokens[:, step_idx] = token
        done = done | (token == eos_id) | (step_idx + 1 >= budget_dev)
    return tokens


def decode_loop_paged(
    config: DecoderConfig, params: Params, first_logits: torch.Tensor,
    start_position: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
    page_tables: torch.Tensor, lengths: torch.Tensor, num_steps: int, *,
    eos_id: int, budget: Sequence[int],
):
    """Greedy decode of up to ``num_steps`` tokens for every slot over the
    paged pool (updated in place), ending once every row has hit EOS or its
    host-side ``budget``.  Returns (tokens [slots, num_steps] on the device,
    last logits, pool_k, pool_v, lengths)."""
    slots = page_tables.shape[0]
    start = torch.as_tensor(start_position, dtype=torch.int32,
                            device=first_logits.device).expand(slots)
    carry = {"logits": first_logits, "lengths": lengths}

    def step(step_idx):
        token = torch.argmax(carry["logits"], dim=-1)
        carry["logits"] = _paged_token_step(
            config, params, token, start + step_idx, pool_k, pool_v, page_tables,
            carry["lengths"])
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
    temperature=None,
):
    """``decode_loop_paged`` with each row's grammar mask (rows with
    ``active`` False decode free-form).  With ``draw_uniforms`` every step
    samples Gumbel-max per row at ``temperature`` ([slots]; rows at <= 0
    stay exact-greedy) from ``draw_uniforms(logits.shape)``, uniforms in
    (0, 1].  Returns (tokens, last logits, pool_k, pool_v, lengths,
    constraint)."""
    slots = page_tables.shape[0]
    start = torch.as_tensor(start_position, dtype=torch.int32,
                            device=first_logits.device).expand(slots)
    carry = {"logits": first_logits, "lengths": lengths, "con": constraint}

    def step(step_idx):
        logits = carry["logits"]
        if draw_uniforms is not None:
            u = draw_uniforms(tuple(logits.shape))
            token, con = constrained_pick(
                logits, carry["con"], lambda m: gumbel_sample_token(m, u, temperature))
        else:
            token, con = constrained_argmax(logits, carry["con"])
        carry["con"] = con
        carry["logits"] = _paged_token_step(
            config, params, token, start + step_idx, pool_k, pool_v, page_tables,
            carry["lengths"])
        carry["lengths"] = carry["lengths"] + 1
        return token

    tokens = _eos_loop(slots, num_steps, eos_id, budget, step, first_logits.device)
    return tokens, carry["logits"], pool_k, pool_v, carry["lengths"], carry["con"]


__all__ = [
    "DecodeConstraint",
    "DecoderConfig",
    "constrained_argmax",
    "constrained_pick",
    "decode_loop_lookahead",
    "decode_loop_paged",
    "decode_loop_paged_constrained",
    "extend_scan",
    "fuse_stacked_projections",
    "gumbel_sample_token",
    "init_decoder_params",
    "lm_logits",
    "params_from_numpy",
    "prefill_scan",
    "quantize_stacked_params",
    "stack_decoder_layers",
]
