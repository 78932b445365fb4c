"""GQA transformer decoder with a dense KV cache: the Qwen2.5-VL text stack.

Counterpart of the scan-execution half of ``vis_tpu/models/common/decoder.py``.
Layer parameters are stacked ([L, ...] leaves, int4 leaves as
``QuantizedWeight4`` with q [L, O, I/2]); a Python loop over layers takes
the place of ``lax.scan``, and ``_pick_layer`` hands each layer's int4
weights to kernel A as a view of the stack.  Cache cursors are kept on the
host too, so writing a chunk's K/V never reads the device.

Decode is ``decode_loop_lookahead``: schema-constrained windows of
``window`` tokens, one weight pass and one host sync per window.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

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
    QuantizedWeight4,
    QuantizedWeight4Pick,
    quantize_weight4,
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
    tie_word_embeddings: bool = False
    dtype: Any = torch.bfloat16

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
    return rope_cos_sin(positions, config.head_dim_, config.rope_theta)


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
                            vocab_mode: str = "int4") -> Params:
    """Int4 weight-only quantization of the stacked projections (and, with
    quantize_embeddings, of the vocab tables, rows padded to 512)."""
    if vocab_mode not in ("int4", "none"):
        raise ValueError(f"vocab_mode {vocab_mode!r}: the port has int4 and none")

    def quantize_stack(w):
        qws = [quantize_weight4(layer) for layer in w]
        return QuantizedWeight4(
            q=torch.stack([qw.q for qw in qws]),
            scale=torch.stack([qw.scale for qw in qws]),
        )

    out = {k: v for k, v in stacked.items() if k != "layers_stacked"}
    if quantize_embeddings and vocab_mode == "int4":
        for name in ("embed_tokens", "lm_head"):
            if name in out:
                out[name] = quantize_weight4(out[name], pad_out_multiple=512)
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
    QuantizedWeight4Pick (kernel A reads the layer in place), tensors views."""

    def pick(w):
        if isinstance(w, dict):
            return {k: pick(v) for k, v in w.items()}
        if isinstance(w, QuantizedWeight4):
            return QuantizedWeight4Pick(w.q, w.scale, idx)
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
    """f32 logits [..., vocab]; an int4 table goes through kernel B (its
    zero-padded rows are sliced off)."""
    table = params["embed_tokens"] if config.tie_word_embeddings else params["lm_head"]
    flat = hidden.reshape(-1, hidden.shape[-1])
    if isinstance(table, QuantizedWeight4):
        out = quantized_matmul4(flat, table)
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
    vis_tpu.serving.schema / constrained, moved to the device).  The allowed
    set is token_ok[state] & (cost_after[state] < remaining), with closing
    moves blocked while remaining > min_remaining."""

    token_ok: torch.Tensor     # [S, K] bool
    token_trans: torch.Tensor  # [S, K] int32
    cost_after: torch.Tensor   # [S, K] int32
    state: torch.Tensor        # [b] int
    remaining: torch.Tensor    # [b] int
    active: torch.Tensor       # [b] bool
    min_remaining: torch.Tensor  # [b] int
    class_of: Optional[torch.Tensor] = None  # [V] column of each vocab id


def constrained_pick(logits: torch.Tensor, constraint: DecodeConstraint,
                     pick_fn: Callable[[torch.Tensor], torch.Tensor]):
    """Mask the logits to grammar-legal, budget-feasible tokens (every
    column past the table width too), pick with ``pick_fn``, advance the
    DFA.  Returns (token [b], constraint')."""
    c = constraint
    state = c.state.long()
    ok_row = c.token_ok[state]
    cost_row = c.cost_after[state]
    if c.class_of is not None:
        cls_rows = c.class_of[None].expand(ok_row.shape[0], -1)
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
    trans = c.token_trans[state, col]
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


__all__ = [
    "DecodeConstraint",
    "DecoderConfig",
    "constrained_argmax",
    "constrained_pick",
    "decode_loop_lookahead",
    "extend_scan",
    "fuse_stacked_projections",
    "gumbel_sample_token",
    "lm_logits",
    "prefill_scan",
    "quantize_stacked_params",
    "stack_decoder_layers",
]
