"""Plain float32 references of the benchmark's two model families.

Written from the published descriptions (Qwen2.5-VL's tower and M-RoPE
decoder, the Mistral/Llama decoder), in plain torch operations: no kernel,
cache or batching of the program, and nothing imported from it.  Weights
are the benchmark's own seeded leaves (``harness/weights.py``) dequantized
here: an int4 weight is (n - 8) * s over split halves, an int8 table q * s.

``Precision`` says how every product's inputs are rounded: ``EXACT`` keeps
float32 (TF32 must be off: ``exact_matmuls()``), ``FP8`` rounds each
operand to float8 e4m3 with a per-row scale, the control that the check
must refuse.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


@contextlib.contextmanager
def exact_matmuls():
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Precision:
    """The rounding applied to the operands of every product."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


EXACT = Precision("fp32")
FP8 = Precision("fp8")


def dequant(leaf: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A quantized leaf -> float32 weight [..., out, in]."""
    if "q4" in leaf:
        p = leaf["q4"].to(torch.int32)
        s = leaf["s"].to(torch.float32)
        lo = ((p & 15) - 8).to(torch.float32) * s[..., 0:1]
        hi = ((p >> 4) - 8).to(torch.float32) * s[..., 1:2]
        return torch.cat([lo, hi], dim=-1)
    return leaf["q8"].to(torch.float32) * leaf["s"].to(torch.float32)[..., None]


def embed_rows(leaf: Dict[str, torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    return dequant({k: v[ids] for k, v in leaf.items()})


def lin(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
        prec: Precision) -> torch.Tensor:
    y = prec(x) @ prec(w).T
    return y if bias is None else y + bias.to(torch.float32)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.to(torch.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def attention(q, k, v, mask_fn, prec: Precision, block: int = 512) -> torch.Tensor:
    """q [n, H, d], k/v [m, KV, d]; ``mask_fn(rows) -> bool [len(rows), m]``
    (True = visible).  Query rows in blocks, float32 softmax."""
    n, heads, d = q.shape
    rep = heads // k.shape[1]
    kk = prec(k).repeat_interleave(rep, dim=1)
    vv = v.repeat_interleave(rep, dim=1)
    qq = prec(q)
    out = torch.empty_like(q)
    for start in range(0, n, block):
        rows = torch.arange(start, min(start + block, n), device=q.device)
        logits = torch.einsum("qhd,khd->hqk", qq[rows], kk) / math.sqrt(d)
        logits = logits.masked_fill(~mask_fn(rows)[None], float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out[rows] = torch.einsum("hqk,khd->qhd", prec(probs), prec(vv))
    return out


# ---------------------------------------------------------------------------
# Text decoder (Mistral / Llama, and Qwen2.5-VL's with M-RoPE)
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_section: Optional[Sequence[int]] = None):
    """cos/sin [n, head_dim] for positions [n] or, with M-RoPE, [3, n]:
    frequency band i of each half takes its angle from position stream
    i mod 3 in the sections' order (Qwen2-VL's multimodal rotary)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                        device=positions.device) / head_dim))
    if mrope_section is None:
        ang = positions.to(torch.float64)[:, None] * inv[None]
    else:
        stream = torch.cat([torch.full((s,), i, dtype=torch.long)
                            for i, s in enumerate(mrope_section)]).to(positions.device)
        ang = positions.to(torch.float64)[stream, :].T * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)


def text_logits(model: Dict[str, Any], text: Dict[str, Any], embeds: torch.Tensor,
                positions: torch.Tensor, rows: torch.Tensor,
                prec: Precision = EXACT) -> torch.Tensor:
    """Causal forward over embeds [n, h] at ``positions``; float32 logits
    [len(rows), vocab] at the sequence rows ``rows``."""
    h, L = model["hidden_size"], model["num_hidden_layers"]
    heads, kvh = model["num_attention_heads"], model["num_key_value_heads"]
    hd = model.get("head_dim") or h // heads
    eps = model["rms_norm_eps"]
    mrope = model.get("rope_scaling", {}) or {}
    cos, sin = rope_tables(positions, hd, model["rope_theta"], mrope.get("mrope_section"))
    n = embeds.shape[0]
    idx = torch.arange(n, device=embeds.device)

    def causal(r):
        return idx[None, :] <= r[:, None]

    ls = text["layers_stacked"]
    x = embeds.to(torch.float32)
    for i in range(L):
        y = rms_norm(x, ls["input_norm"][i], eps)
        qkv = lin(y, dequant({k: v[i] for k, v in ls["qkv_proj"].items()}),
                  ls["qkv_bias"][i] if "qkv_bias" in ls else None, prec)
        q = qkv[:, :heads * hd].view(n, heads, hd)
        k = qkv[:, heads * hd:(heads + kvh) * hd].view(n, kvh, hd)
        v = qkv[:, (heads + kvh) * hd:].view(n, kvh, hd)
        q = q * cos[:, None] + rotate_half(q) * sin[:, None]
        k = k * cos[:, None] + rotate_half(k) * sin[:, None]
        att = attention(q, k, v, causal, prec).reshape(n, heads * hd)
        x = x + lin(att, dequant({k_: v_[i] for k_, v_ in ls["o_proj"].items()}), None, prec)
        y = rms_norm(x, ls["post_attn_norm"][i], eps)
        gate, up = lin(y, dequant({k_: v_[i] for k_, v_ in ls["mlp"]["gateup_proj"].items()}),
                       None, prec).chunk(2, dim=-1)
        down = dequant({k_: v_[i] for k_, v_ in ls["mlp"]["down_proj"].items()})
        x = x + lin(torch.nn.functional.silu(gate) * up, down, None, prec)
    y = rms_norm(x[rows], text["final_norm"], eps)
    return lin(y, dequant(text["lm_head"]), None, prec)[:, :model["vocab_size"]]


def text_embeds(text: Dict[str, Any], ids: torch.Tensor) -> torch.Tensor:
    return embed_rows(text["embed_tokens"], ids)


# ---------------------------------------------------------------------------
# Qwen2.5-VL vision tower
# ---------------------------------------------------------------------------

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def served_size(height: int, width: int, proc: Dict[str, Any], factor: int) -> Tuple[int, int]:
    """Qwen2-VL's resize rule: each side rounded to a multiple of
    ``factor`` (patch * merge), scaled down (floor) into ``max_pixels`` or
    up (ceil) to ``min_pixels`` keeping the aspect ratio, then the longest
    side held to ``max_image_dimension``."""
    lo, hi, cap = proc["min_pixels"], proc["max_pixels"], proc.get("max_image_dimension")
    if cap:
        hi = min(hi, cap * cap)
    h, w = round(height / factor) * factor, round(width / factor) * factor
    if h * w > hi:
        beta = math.sqrt(height * width / hi)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < lo:
        beta = math.sqrt(lo / (height * width))
        h, w = math.ceil(height * beta / factor) * factor, math.ceil(width * beta / factor) * factor
    if cap and max(h, w) > cap:
        scale = cap / max(h, w)
        h = max(factor, math.floor(h * scale / factor) * factor)
        w = max(factor, math.floor(w * scale / factor) * factor)
    return h, w


def _cubic_taps(src: int, dst: int, device) -> torch.Tensor:
    """[dst, src] float64 weights of an antialiased bicubic resample (Keys,
    a = -0.5): output pixel i is centred at (i + 0.5) * src / dst; on a
    downscale the kernel widens by the scale; taps sum to 1."""
    scale = src / dst
    widen = max(scale, 1.0)
    centre = (torch.arange(dst, dtype=torch.float64, device=device) + 0.5) * scale
    xs = torch.arange(src, dtype=torch.float64, device=device)
    lo = torch.floor(centre - 2.0 * widen + 0.5).clamp_min(0)
    hi = torch.floor(centre + 2.0 * widen + 0.5).clamp_max(src)
    inside = (xs[None] >= lo[:, None]) & (xs[None] < hi[:, None])
    t = ((xs[None] + 0.5 - centre[:, None]) / widen).abs()
    a = -0.5
    w = torch.where(t <= 1, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
                    torch.where(t < 2, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a,
                                torch.zeros_like(t)))
    w = w * inside
    return w / w.sum(dim=1, keepdim=True)


def resize(rgb_u8: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """u8 [H, W, 3] -> float32 [height, width, 3] in [0, 1]: the bicubic
    resample of rows then columns, in float64, clipped."""
    img = rgb_u8.to(torch.float64) / 255.0
    rows = torch.einsum("dh,hwc->dwc", _cubic_taps(img.shape[0], height, img.device), img)
    out = torch.einsum("ew,dwc->dec", _cubic_taps(img.shape[1], width, img.device), rows)
    return out.clamp(0.0, 1.0).to(torch.float32)


def image_patches(pixels: torch.Tensor, vc: Dict[str, Any]) -> torch.Tensor:
    """float [H, W, 3] in [0, 1] (sides multiples of patch * merge) ->
    patches [gh*gw, C*T*P*P] in merge-window-major order: each 2x2 group of
    patches that merges into one token is contiguous, groups in raster
    order."""
    p, m, t = vc["patch_size"], vc["spatial_merge_size"], vc["temporal_patch_size"]
    img = pixels.to(torch.float32)
    mean = torch.tensor(CLIP_MEAN, device=img.device)
    std = torch.tensor(CLIP_STD, device=img.device)
    chw = ((img - mean) / std).permute(2, 0, 1)
    c, hh, ww = chw.shape
    gh, gw = hh // p, ww // p
    frames = chw[None].expand(t, c, hh, ww)
    x = frames.reshape(t, c, gh // m, m, p, gw // m, m, p)
    x = x.permute(2, 5, 3, 6, 1, 0, 4, 7)   # gh/m, gw/m, m, m, c, t, p, p
    return x.reshape(gh * gw, c * t * p * p)


def vision_embeds(vc: Dict[str, Any], vision: Dict[str, Any], pixels: torch.Tensor,
                  prec: Precision = EXACT) -> torch.Tensor:
    """The tower over one image -> merged tokens [gh*gw/4, out_hidden] in
    raster order of the merged grid.  Window blocks attend within windows
    of window_size/patch/merge merged cells a side; the blocks in
    ``fullatt_block_indexes`` over the whole image."""
    p, m = vc["patch_size"], vc["spatial_merge_size"]
    d, heads = vc["hidden_size"], vc["num_heads"]
    hd = d // heads
    gh, gw = pixels.shape[0] // p, pixels.shape[1] // p
    device = pixels.device
    x = lin(image_patches(pixels, vc), dequant(vision["patch_embed"]), None, prec)
    n = x.shape[0]
    # Patch (row, col) in merge-window-major order.
    cell = torch.arange(n, device=device) // (m * m)
    within = torch.arange(n, device=device) % (m * m)
    cr, cc = cell // (gw // m), cell % (gw // m)
    row, col = cr * m + within // m, cc * m + within % m
    dim = hd // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim))
    ang = torch.cat([row[:, None] * inv[None], col[:, None] * inv[None]], dim=-1)
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)
    wc = vc["window_size"] // p // m
    window = (cr // wc) * (-(-(gw // m) // wc)) + cc // wc

    def local(r):
        return window[r][:, None] == window[None, :]

    def full(r):
        return torch.ones((len(r), n), dtype=torch.bool, device=device)

    for i, blk in enumerate(vision["blocks"]):
        y = rms_norm(x, blk["norm1"], 1e-6)
        qkv = lin(y, dequant(blk["qkv"]), blk["qkv_bias"], prec).view(n, 3, heads, hd)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        q = q * cos[:, None] + rotate_half(q) * sin[:, None]
        k = k * cos[:, None] + rotate_half(k) * sin[:, None]
        mask = full if i in vc["fullatt_block_indexes"] else local
        att = attention(q, k, v, mask, prec).reshape(n, d)
        x = x + lin(att, dequant(blk["proj"]), blk["proj_bias"], prec)
        y = rms_norm(x, blk["norm2"], 1e-6)
        mlp = blk["mlp"]
        gate = lin(y, dequant(mlp["gate_proj"]), mlp["gate_bias"], prec)
        up = lin(y, dequant(mlp["up_proj"]), mlp["up_bias"], prec)
        x = x + lin(torch.nn.functional.silu(gate) * up, dequant(mlp["down_proj"]),
                    mlp["down_bias"], prec)
    mg = vision["merger"]
    y = rms_norm(x, mg["ln_q"], 1e-6).reshape(n // (m * m), m * m * d)
    y = torch.nn.functional.gelu(lin(y, dequant(mg["fc1"]), mg["fc1_bias"], prec))
    return lin(y, dequant(mg["fc2"]), mg["fc2_bias"], prec)


def mrope_positions(n_before: int, gh: int, gw: int, m: int, n_after: int) -> torch.Tensor:
    """Qwen2-VL's rope index for [n_before text, image, n_after text]
    tokens: text on the diagonal, image tokens at (t, h, w) = start +
    (0, row, col) of the merged grid, the text after it from the image's
    largest index + 1.  Returns [3, n]."""
    lh, lw = gh // m, gw // m
    before = torch.arange(n_before).expand(3, n_before)
    rows = torch.arange(lh).repeat_interleave(lw)
    cols = torch.arange(lw).repeat(lh)
    img = torch.stack([torch.zeros_like(rows), rows, cols]) + n_before
    start = int(img.max()) + 1
    after = (torch.arange(n_after) + start).expand(3, n_after)
    return torch.cat([before, img, after], dim=1)


__all__ = [
    "EXACT", "FP8", "Precision", "dequant", "exact_matmuls", "image_patches",
    "mrope_positions", "resize", "served_size", "text_embeds", "text_logits",
    "vision_embeds",
]
