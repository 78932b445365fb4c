"""Family ``qwen2_5_vl`` (Qwen2.5-VL): the window-attention vision tower,
its merger, and the dense GQA text decoder with M-RoPE.

The tower's leaves come first in the plan, then the text decoder's.  The
reference resizes a photo by its own copy of Qwen2-VL's served-size rule
and a bicubic resample, runs the tower over it and puts its merged tokens
in the image's place among the text embeddings.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from bench_torch.families import _dense_gqa as dense_gqa
from bench_torch.families._dense_gqa import decode_bytes, decode_flops, prefill_flops  # noqa: F401
from bench_torch.harness.photos import photo_array
from bench_torch.harness.weights import _Plan
from bench_torch.reference.primitives import (
    EXACT, Precision, attention, dequant, lin, rms_norm, rotate_half,
)

# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _tower_plan(plan: _Plan, vc: Dict[str, Any]) -> None:
    d, inter = vc["hidden_size"], vc["intermediate_size"]
    patch_dim = vc["in_chans"] * vc["temporal_patch_size"] * vc["patch_size"] ** 2
    merge_dim = d * vc["spatial_merge_size"] ** 2
    v = ("vision",)
    plan.int4(v + ("patch_embed",), (), d, patch_dim)
    for i in range(vc["depth"]):
        b = v + ("blocks", i)
        plan.norm(b + ("norm1",), d)
        plan.norm(b + ("norm2",), d)
        plan.int4(b + ("qkv",), (), 3 * d, d)
        plan.bias(b + ("qkv_bias",), 3 * d)
        plan.int4(b + ("proj",), (), d, d)
        plan.bias(b + ("proj_bias",), d)
        for name, out, inn in (("gate", inter, d), ("up", inter, d), ("down", d, inter)):
            plan.int4(b + ("mlp", f"{name}_proj"), (), out, inn)
            plan.bias(b + ("mlp", f"{name}_bias"), out)
    m = v + ("merger",)
    plan.norm(m + ("ln_q",), d)
    plan.int4(m + ("fc1",), (), merge_dim, merge_dim)
    plan.bias(m + ("fc1_bias",), merge_dim)
    plan.int4(m + ("fc2",), (), vc["out_hidden_size"], merge_dim)
    plan.bias(m + ("fc2_bias",), vc["out_hidden_size"])


def plan_weights(plan: _Plan, model: Dict[str, Any]) -> None:
    _tower_plan(plan, model["vision_config"])
    dense_gqa.plan_weights(plan, model)


def finish_weights(tree: Dict[str, Any], model: Dict[str, Any]) -> Dict[str, Any]:
    blocks = tree["vision"]["blocks"]
    tree["vision"]["blocks"] = [blocks[i] for i in range(len(blocks))]
    return dense_gqa.finish_weights(tree, model)


# ---------------------------------------------------------------------------
# The program's config
# ---------------------------------------------------------------------------


def program_config(model: Dict[str, Any]):
    from vis_tpu_torch.models.qwen2_5_vl.config import Qwen25VisionConfig, Qwen25VLConfig

    vc = model["vision_config"]
    return Qwen25VLConfig(
        vision=Qwen25VisionConfig(
            depth=vc["depth"], hidden_size=vc["hidden_size"],
            intermediate_size=vc["intermediate_size"], num_heads=vc["num_heads"],
            in_channels=vc["in_chans"], patch_size=vc["patch_size"],
            temporal_patch_size=vc["temporal_patch_size"],
            spatial_merge_size=vc["spatial_merge_size"],
            out_hidden_size=vc["out_hidden_size"], window_size=vc["window_size"],
            fullatt_block_indexes=tuple(vc["fullatt_block_indexes"]),
        ),
        text=dense_gqa.decoder_config(
            model, mrope_section=tuple(model["rope_scaling"]["mrope_section"])),
        image_token_id=model["image_token_id"],
        vision_start_token_id=model["vision_start_token_id"],
        vision_end_token_id=model["vision_end_token_id"],
        eos_token_id=model["eos_token_id"],
    )


# ---------------------------------------------------------------------------
# Plain reference: the tower
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


# ---------------------------------------------------------------------------
# Plain reference: a check item
# ---------------------------------------------------------------------------


@dataclass
class PhotoSequence(dense_gqa.Sequence):
    """With a photo: the resized pixels [H, W, 3] whose tower output takes
    the image tokens' rows (positions [3, n])."""

    image: Optional[torch.Tensor] = None


def sequence(model: Dict[str, Any], item: Dict[str, Any], weights, device) -> PhotoSequence:
    """The item's photo, if any (vision start, its merged tokens, vision
    end), then its pieces, at M-RoPE positions."""
    if item.get("photo") is None:
        seq = dense_gqa.sequence(model, item, weights, device)
        return PhotoSequence(seq.ids, seq.embeds, seq.positions.expand(3, -1), seq.served)
    vc = model["vision_config"]
    raw = torch.from_numpy(photo_array(item["photo"])).to(device)
    p, m = vc["patch_size"], vc["spatial_merge_size"]
    size = served_size(raw.shape[0], raw.shape[1], model["image_processor"], p * m)
    gh, gw = size[0] // p, size[1] // p
    n_img = (gh // m) * (gw // m)
    prefix = ([model["vision_start_token_id"]] + [model["image_token_id"]] * n_img
              + [model["vision_end_token_id"]])
    seq = dense_gqa.sequence(model, item, weights, device, prefix=prefix)
    n_after = seq.ids.shape[0] - 1 - n_img
    positions = mrope_positions(1, gh, gw, m, n_after).to(device)
    return PhotoSequence(seq.ids, seq.embeds, positions, seq.served, image=resize(raw, *size))


def logits(model: Dict[str, Any], weights, seq: PhotoSequence, rows: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    x = seq.embeds
    if seq.image is not None:
        x = seq.embeds.clone()
        x[seq.ids == model["image_token_id"]] = vision_embeds(
            model["vision_config"], weights["vision"], seq.image, prec)
    return dense_gqa.text_logits(model, weights["text"], x, seq.positions, rows, prec,
                                 sections=model["rope_scaling"]["mrope_section"])


# ---------------------------------------------------------------------------
# Work
# ---------------------------------------------------------------------------


def tower_flops(vc: Dict[str, Any], grid_h: int, grid_w: int) -> float:
    """Qwen2.5-VL's tower over one image of grid_h x grid_w patches: the
    projections, window attention in windows of window_size/14/2 merged
    cells a side, full attention in ``fullatt_block_indexes``, the merger."""
    d, inter = vc["hidden_size"], vc["intermediate_size"]
    m = vc["spatial_merge_size"]
    n = grid_h * grid_w
    patch = vc["in_chans"] * vc["temporal_patch_size"] * vc["patch_size"] ** 2
    proj = 2.0 * n * (patch * d)
    per_block = 2.0 * n * (3 * d * d + d * d + 3 * d * inter)
    wc = vc["window_size"] // vc["patch_size"] // m
    lh, lw = grid_h // m, grid_w // m
    win_sq = 0
    for r in range(0, lh, wc):
        for c in range(0, lw, wc):
            cells = min(wc, lh - r) * min(wc, lw - c)
            win_sq += (cells * m * m) ** 2
    full = len(vc["fullatt_block_indexes"])
    attn = 4.0 * d * (full * n * n + (vc["depth"] - full) * win_sq)
    merge = 2.0 * (n // (m * m)) * ((m * m * d) ** 2 + m * m * d * vc["out_hidden_size"])
    return proj + vc["depth"] * per_block + attn + merge


def input_flops(model: Dict[str, Any], record: Dict[str, Any]) -> float:
    """The tower over a request's image, where it had one (``grid``: its
    patch grid)."""
    grid = record.get("grid")
    return tower_flops(model["vision_config"], *grid) if grid else 0.0


__all__ = [
    "decode_bytes", "decode_flops", "finish_weights", "input_flops", "logits", "mrope_positions",
    "plan_weights", "prefill_flops", "program_config", "resize", "sequence", "served_size",
    "tower_flops", "vision_embeds",
]
