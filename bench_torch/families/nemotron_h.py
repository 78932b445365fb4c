"""Family ``nemotron_h`` (Nemotron-H): a hybrid of Mamba2 state-space
mixers, GQA attention without positional encoding and squared-ReLU MLPs,
one block a character of ``hybrid_override_pattern`` ("M", "*", "-"),
each ``h = h + mixer(rms_norm(h))``; a final RMSNorm, then the untied head.

The published layer equations, which ``logits`` writes down and the
program must match:

- MLP: ``down(relu(up(x))^2)``, no gate, no bias.
- Attention: GQA, causal, no positional encoding, no bias.
- Mamba2: ``in_proj(x)`` splits into z [d_inner], xBC [d_inner + 2 G N]
  and dt [H].  xBC goes through a causal depthwise convolution of
  ``conv_kernel`` taps (with bias), then SiLU, and splits into x [H, P],
  B and C [G, N].  dt = softplus(dt + dt_bias) (``time_step_limit`` (0,
  inf) clips nothing), A = -exp(A_log).  For head h of group g = h // (H /
  G): S_h <- exp(dt_h A_h) S_h + dt_h (x_h outer B_g), y_h = S_h C_g + D_h
  x_h.  Then y = RMSNorm over each of G groups of (y * silu(z)), times the
  weight; the mixer returns out_proj(y).

The reference steps that recurrence token by token in float32 (never the
program's chunked scan), from the dequantized weights, with TF32 off.
Under the float8 control every product's operands are rounded: the
projections', attention's, and the recurrence's input (dt x outer B) and
readout (S C), the carried state itself staying f32.

Weights (``harness/weights.py``'s plan; these leaves are this family's):
int8 embedding and head, int4 projections (one leaf a layer in the plan, so
that drawing the 22 GB of int4 bytes makes no stack-sized temporaries,
stacked [layers, ...] by ``finish_weights``), bf16 norms (1 + 0.1 z).  The
Mamba2 leaves are derived in ``finish_weights`` from standard normals z the
plan draws (each a ``scale`` leaf of base 1, 1 + 0.1 z, from which z is
read back), at the published initialisation ranges, so some heads keep
their state over hundreds of tokens and the check tests the carry:

- A uniform in [1, 16] (``A_log`` = log A, f32);
- dt log-uniform in [``time_step_min``, ``time_step_max``], floored at
  ``time_step_floor``, stored as its inverse softplus in ``dt_bias`` (f32);
- D = 1 + 0.1 z (f32), near 1;
- conv weights 0.5 z (zero mean, variance 1/4; bf16), conv bias 0.02 z
  (the plan's bias leaves; bf16);
- the gated norm's weight 1 + 0.1 z (bf16).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from bench_torch.families._dense_gqa import sequence  # noqa: F401
from bench_torch.harness.weights import _Plan, vocab_rows
from bench_torch.reference.primitives import (
    EXACT, Precision, attention, dequant, lin, rms_norm,
)

KINDS = {"M": "mamba", "*": "attention", "-": "mlp"}


# ---------------------------------------------------------------------------
# Sizes
# ---------------------------------------------------------------------------


def _check(m: Dict[str, Any]) -> None:
    """The family runs what its equations say, and refuses other settings."""
    wanted = {"mlp_hidden_act": "relu2", "mamba_hidden_act": "silu", "use_conv_bias": True,
              "mamba_proj_bias": False, "attention_bias": False, "mlp_bias": False,
              "residual_in_fp32": False, "tie_word_embeddings": False}
    for key, value in wanted.items():
        if m.get(key, value) != value:
            raise ValueError(f"nemotron_h: {key}={m[key]!r}, this family runs {value!r}")
    low, high = m.get("time_step_limit", [0.0, None])
    if low not in (0, 0.0) or high is not None:
        raise ValueError("nemotron_h: time_step_limit other than (0, inf) is not written here")
    if len(m["hybrid_override_pattern"]) != m["num_hidden_layers"]:
        raise ValueError("nemotron_h: the pattern's length is not num_hidden_layers")


def counts(m: Dict[str, Any]) -> Dict[str, int]:
    """Blocks of each kind: {"mamba": 45, "attention": 5, "mlp": 48} at 47B."""
    p = m["hybrid_override_pattern"]
    return {name: p.count(c) for c, name in KINDS.items()}


def _dims(m: Dict[str, Any]):
    """(hidden, heads, kv heads, head dim, H, P, N, G, d_inner, conv_dim, taps)."""
    h = m["hidden_size"]
    heads, kvh = m["num_attention_heads"], m["num_key_value_heads"]
    hd = m.get("attention_head_dim") or h // heads
    H, P, N, G = m["mamba_num_heads"], m["mamba_head_dim"], m["ssm_state_size"], m["n_groups"]
    d_inner = H * P
    return h, heads, kvh, hd, H, P, N, G, d_inner, d_inner + 2 * G * N, m["conv_kernel"]


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _normals(plan: _Plan, path, *shape) -> None:
    """A leaf of standard normals z, kept as 1 + 0.1 z in f32."""
    plan.float_leaves.append((path, shape, "scale", 1.0))


def _int4_layers(plan: _Plan, path, n: int, out: int, inn: int) -> None:
    for i in range(n):
        plan.int4(path + (i,), (), out, inn)


def plan_weights(plan: _Plan, model: Dict[str, Any]) -> None:
    """Embedding and head in int8, the final norm, then the three stacks:
    mamba, attention, mlp (each layer's int4 projections a leaf of their
    own, stacked by ``finish_weights``)."""
    _check(model)
    h, heads, kvh, hd, H, P, N, G, d_inner, conv_dim, taps = _dims(model)
    n = counts(model)
    rows = vocab_rows(model["vocab_size"])
    t = ("text",)
    plan.int8(t + ("embed_tokens",), rows, h, 1.0)
    plan.int8(t + ("lm_head",), rows, h, 1.0 / math.sqrt(h))
    plan.norm(t + ("final_norm",), h)
    mb = t + ("layers_stacked", "mamba")
    plan.norm(mb + ("norm",), n["mamba"], h)
    _int4_layers(plan, mb + ("in_proj",), n["mamba"], d_inner + conv_dim + H, h)
    _normals(plan, mb + ("conv_weight",), n["mamba"], conv_dim, taps)
    plan.bias(mb + ("conv_bias",), n["mamba"], conv_dim)
    _normals(plan, mb + ("A_log",), n["mamba"], H)
    _normals(plan, mb + ("dt_bias",), n["mamba"], H)
    _normals(plan, mb + ("D",), n["mamba"], H)
    plan.norm(mb + ("gated_norm",), n["mamba"], d_inner)
    _int4_layers(plan, mb + ("out_proj",), n["mamba"], h, d_inner)
    at = t + ("layers_stacked", "attention")
    plan.norm(at + ("norm",), n["attention"], h)
    _int4_layers(plan, at + ("qkv_proj",), n["attention"], (heads + 2 * kvh) * hd, h)
    _int4_layers(plan, at + ("o_proj",), n["attention"], h, heads * hd)
    ml = t + ("layers_stacked", "mlp")
    plan.norm(ml + ("norm",), n["mlp"], h)
    _int4_layers(plan, ml + ("up_proj",), n["mlp"], model["intermediate_size"], h)
    _int4_layers(plan, ml + ("down_proj",), n["mlp"], h, model["intermediate_size"])


def _stack(layers: Dict[int, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """{i: {"q4", "s"}} -> {"q4": [n, ...], "s": [n, ...]}, freeing each
    layer's leaves as its stack is made."""
    out = {}
    for key in ("q4", "s"):
        out[key] = torch.stack([layers[i][key] for i in range(len(layers))])
        for i in range(len(layers)):
            del layers[i][key]
    return out


def finish_weights(tree: Dict[str, Any], model: Dict[str, Any]) -> Dict[str, Any]:
    """Stack each projection's layers, derive the Mamba2 leaves from their
    normals (the module's list), and set the head's end-of-sequence row's
    scale to 0 (the budget, not the model, ends an answer)."""
    text = tree["text"]
    text["lm_head"]["s"][model["eos_token_id"]] = 0.0
    for stack in text["layers_stacked"].values():
        for key, leaf in stack.items():
            if isinstance(leaf, dict) and 0 in leaf:
                stack[key] = _stack(leaf)
    mb = text["layers_stacked"]["mamba"]

    def z_of(leaf):
        return (leaf - 1.0) * 10.0

    def uniform(leaf):
        return 0.5 * (1.0 + torch.erf(z_of(leaf) / math.sqrt(2.0)))

    mb["A_log"] = torch.log(1.0 + 15.0 * uniform(mb["A_log"]))
    lo, hi = math.log(model["time_step_min"]), math.log(model["time_step_max"])
    dt = torch.exp(lo + (hi - lo) * uniform(mb["dt_bias"])).clamp_min(model["time_step_floor"])
    mb["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    mb["conv_weight"] = (0.5 * z_of(mb["conv_weight"])).to(torch.bfloat16)
    return tree


# ---------------------------------------------------------------------------
# The program's config
# ---------------------------------------------------------------------------


def program_config(model: Dict[str, Any]):
    from vis_tpu_torch.models.common.decoder import HybridDecoderConfig
    from vis_tpu_torch.models.common.layers import Mamba2Config

    _check(model)
    h, heads, kvh, hd, H, P, N, G, _, _, taps = _dims(model)
    return HybridDecoderConfig(
        vocab_size=model["vocab_size"], hidden_size=h, num_layers=model["num_hidden_layers"],
        num_heads=heads, num_kv_heads=kvh, intermediate_size=model["intermediate_size"],
        head_dim=hd, rms_norm_eps=float(model["rms_norm_eps"]), qkv_bias=False,
        tie_word_embeddings=False, block_pattern=model["hybrid_override_pattern"],
        mamba=Mamba2Config(num_heads=H, head_dim=P, state_size=N, n_groups=G,
                           conv_kernel=taps, chunk_size=model["chunk_size"],
                           norm_eps=float(model["layer_norm_epsilon"])),
    )


# ---------------------------------------------------------------------------
# Plain reference
# ---------------------------------------------------------------------------


def _layer(stack: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i])
            for k, v in stack.items()}


def mamba_mixer(model: Dict[str, Any], layer: Dict[str, Any], y: torch.Tensor,
                prec: Precision = EXACT) -> torch.Tensor:
    """The Mamba2 mixer over normed rows y [n, hidden], token by token."""
    _, _, _, _, H, P, N, G, d_inner, conv_dim, taps = _dims(model)
    n = y.shape[0]
    zxbcdt = lin(y, dequant(layer["in_proj"]), None, prec)
    z, xbc, dt_raw = (zxbcdt[:, :d_inner], zxbcdt[:, d_inner:d_inner + conv_dim],
                      zxbcdt[:, d_inner + conv_dim:])
    w = layer["conv_weight"].to(torch.float32)
    window = torch.cat([torch.zeros(taps - 1, conv_dim, device=y.device), xbc])
    conv = layer["conv_bias"].to(torch.float32).expand(n, conv_dim)
    for k in range(taps):
        conv = conv + w[:, k] * window[k:k + n]
    u = torch.nn.functional.silu(conv)
    x = u[:, :d_inner].reshape(n, H, P)
    per = H // G
    b_in = u[:, d_inner:d_inner + G * N].reshape(n, G, N).repeat_interleave(per, dim=1)
    c_in = u[:, d_inner + G * N:].reshape(n, G, N).repeat_interleave(per, dim=1)
    dt = torch.nn.functional.softplus(dt_raw + layer["dt_bias"].to(torch.float32))
    a = -torch.exp(layer["A_log"].to(torch.float32))
    d_skip = layer["D"].to(torch.float32)
    state = torch.zeros(H, P, N, device=y.device)
    out = torch.empty(n, H, P, device=y.device)
    for t in range(n):
        state = torch.exp(dt[t] * a)[:, None, None] * state + torch.einsum(
            "hp,hn->hpn", prec(dt[t][:, None] * x[t]), prec(b_in[t]))
        out[t] = torch.einsum("hpn,hn->hp", prec(state), prec(c_in[t])) + d_skip[:, None] * x[t]
    gated = out.reshape(n, d_inner) * torch.nn.functional.silu(z)
    gated = gated.reshape(n, G, d_inner // G)
    normed = gated * torch.rsqrt((gated * gated).mean(dim=-1, keepdim=True)
                                 + model["layer_norm_epsilon"])
    normed = normed.reshape(n, d_inner) * layer["gated_norm"].to(torch.float32)
    return lin(normed, dequant(layer["out_proj"]), None, prec)


def logits(model: Dict[str, Any], weights, seq, rows: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """Causal forward over the sequence's embeddings in float32, block by
    block in the pattern's order; logits [len(rows), vocab] at ``rows``."""
    text = weights["text"]
    h, heads, kvh, hd, *_ = _dims(model)
    eps = model["rms_norm_eps"]
    stacks = text["layers_stacked"]
    x = seq.embeds.to(torch.float32)
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)

    def causal(r):
        return idx[None, :] <= r[:, None]

    seen = {c: 0 for c in KINDS}
    for c in model["hybrid_override_pattern"]:
        layer = _layer(stacks[KINDS[c]], seen[c])
        seen[c] += 1
        y = rms_norm(x, layer["norm"], eps)
        if c == "M":
            x = x + mamba_mixer(model, layer, y, prec)
        elif c == "*":
            qkv = lin(y, dequant(layer["qkv_proj"]), None, prec)
            q = qkv[:, :heads * hd].view(n, heads, hd)
            k = qkv[:, heads * hd:(heads + kvh) * hd].view(n, kvh, hd)
            v = qkv[:, (heads + kvh) * hd:].view(n, kvh, hd)
            att = attention(q, k, v, causal, prec).reshape(n, heads * hd)
            x = x + lin(att, dequant(layer["o_proj"]), None, prec)
        else:
            up = lin(y, dequant(layer["up_proj"]), None, prec)
            x = x + lin(torch.relu(up).square(), dequant(layer["down_proj"]), None, prec)
    y = rms_norm(x[rows], text["final_norm"], eps)
    return lin(y, dequant(text["lm_head"]), None, prec)[:, :model["vocab_size"]]


# ---------------------------------------------------------------------------
# Work: operations (multiply-adds times two) and bytes, counted from the
# shapes.  The recurrence's operations are the token-by-token form's, which
# a chunked scan exceeds: 3 H P N for the state update (a product for the
# input and a multiply-add for the decay), 2 H P N for the readout, 2 taps
# conv_dim for the convolution.
# ---------------------------------------------------------------------------


def layer_params(m: Dict[str, Any]) -> int:
    """Projection weights of every block."""
    h, heads, kvh, hd, H, P, N, G, d_inner, conv_dim, _ = _dims(m)
    n = counts(m)
    mamba = h * (d_inner + conv_dim + H) + d_inner * h
    attn = h * (heads + 2 * kvh) * hd + heads * hd * h
    mlp = 2 * h * m["intermediate_size"]
    return n["mamba"] * mamba + n["attention"] * attn + n["mlp"] * mlp


def head_params(m: Dict[str, Any]) -> int:
    return m["hidden_size"] * m["vocab_size"]


def weight_bytes_per_pass(m: Dict[str, Any]) -> float:
    """Bytes one decode pass must read: int4 projections (half a byte a
    weight, two f32 scales a row), bf16 norms, the Mamba2 layers' bf16 conv
    weights and biases and f32 A_log, dt_bias and D, the int8 head with its
    f32 row scales, the final norm."""
    h, heads, kvh, hd, H, P, N, G, d_inner, conv_dim, taps = _dims(m)
    n = counts(m)
    inter = m["intermediate_size"]
    in_out = d_inner + conv_dim + H
    mamba = (h * in_out + d_inner * h) / 2 + (in_out + h) * 8 + h * 2 + d_inner * 2 \
        + conv_dim * (taps + 1) * 2 + 3 * H * 4
    attn = (h * (heads + 2 * kvh) * hd + heads * hd * h) / 2 \
        + ((heads + 2 * kvh) * hd + h) * 8 + h * 2
    mlp = 2 * h * inter / 2 + (inter + h) * 8 + h * 2
    rows = vocab_rows(m["vocab_size"])
    return n["mamba"] * mamba + n["attention"] * attn + n["mlp"] * mlp + rows * h + rows * 4 \
        + h * 2


def kv_bytes_per_position(m: Dict[str, Any]) -> float:
    _, _, kvh, hd, *_ = _dims(m)
    return counts(m)["attention"] * 2 * kvh * hd * 2


def state_update_bytes(m: Dict[str, Any]) -> float:
    """Bytes one sequence's state step of one Mamba2 layer moves at least:
    its f32 state read and written, the conv tail's taps - 1 entries read
    and the new one written (bf16), x, B, C and dt in and z in (bf16), y
    out (bf16, after the gated norm)."""
    _, _, _, _, H, P, N, G, d_inner, conv_dim, taps = _dims(m)
    return 2 * H * P * N * 4 + taps * conv_dim * 2 + (conv_dim + H) * 2 + 2 * d_inner * 2


def mixer_flops(m: Dict[str, Any]) -> float:
    """One token's convolution and recurrence in one Mamba2 layer."""
    _, _, _, _, H, P, N, G, d_inner, conv_dim, taps = _dims(m)
    return 5.0 * H * P * N + 2.0 * taps * conv_dim


def attention_flops(m: Dict[str, Any], context_sum: float) -> float:
    """QK and PV products over ``context_sum`` keys in all, every attention
    block."""
    _, heads, _, hd, *_ = _dims(m)
    return 4.0 * counts(m)["attention"] * heads * hd * context_sum


def prefill_flops(m: Dict[str, Any], n: int) -> float:
    """A causal prompt of n tokens, logits at its last row only."""
    return (2.0 * layer_params(m) + counts(m)["mamba"] * mixer_flops(m)) * n \
        + attention_flops(m, n * (n + 1) / 2) + 2.0 * head_params(m)


def decode_flops(m: Dict[str, Any], tokens: int, context_sum: float) -> float:
    return (2.0 * (layer_params(m) + head_params(m)) + counts(m)["mamba"] * mixer_flops(m)) \
        * tokens + attention_flops(m, context_sum)


def decode_bytes(m: Dict[str, Any], passes: int, context_sum: float) -> float:
    """``passes`` weight passes: the weights once a pass, the KV of the
    attention blocks at ``context_sum`` cached positions in all, and one
    sequence's state read and written a pass in every Mamba2 layer.  That is
    the least any pass moves: the signature does not say how many sequences
    a pass carried, and each further one adds ``state_update_bytes`` a
    Mamba2 layer."""
    return (weight_bytes_per_pass(m) + counts(m)["mamba"] * state_update_bytes(m)) * passes \
        + kv_bytes_per_position(m) * context_sum


def input_flops(m: Dict[str, Any], record: Dict[str, Any]) -> float:
    """A text request's inputs cost nothing before its prompt."""
    return 0.0


__all__ = [
    "counts", "decode_bytes", "decode_flops", "finish_weights", "input_flops",
    "kv_bytes_per_position", "logits", "mamba_mixer", "plan_weights", "prefill_flops",
    "program_config", "sequence", "state_update_bytes", "weight_bytes_per_pass",
]
