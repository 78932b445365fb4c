"""Seeded weights in the serving layout, made on the device in a few calls.

The packed bytes of every int4 leaf come from one ``torch.randint``, the
bytes of every int8 leaf from a second, every float leaf from one
``torch.randn``, all drawn from a ``torch.Generator`` on the device seeded
with the run's seed.  Weights are uniform over the symmetric ranges the
program's quantizers produce (-7..7, -127..127), so no weight matrix has a
common offset that would make every context give the same ranking.  The same seed on the same
device gives the same bytes, so the check remakes the weights for the
plain reference instead of reading the program's.

Leaves are plain tensors: an int4 projection is ``{"q4": u8 [..., out,
in/2], "s": f32 [..., out, 2]}`` (split-half nibbles n, weight (n - 8) *
s, low half of the inputs on the low nibble), an int8 table ``{"q8": i8
[out, in], "s": f32 [out]}``.  Scales are set so that every projection
keeps the variance of its input (nibbles and bytes are uniform), norms are
1 + 0.1 z and biases 0.02 z, so every layer moves the logits and the logits
have a spread near one.  The head's row of the end-of-sequence id has
scale 0: with random weights the budget, not the model, ends an answer.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

# Standard deviation of a weight uniform over -7..7 (int4) and -127..127
# (int8): the symmetric ranges the program's quantizers produce.
SIGMA4 = math.sqrt((15 ** 2 - 1) / 12.0)
SIGMA8 = math.sqrt((255 ** 2 - 1) / 12.0)


class _Plan:
    """Leaves in a fixed order: quantized bytes and floats, with how each
    float leaf is made from its standard normals."""

    def __init__(self):
        self.byte_leaves: List[Tuple[tuple, tuple]] = []   # (path, shape)
        self.float_leaves: List[Tuple[tuple, tuple, str, float]] = []

    def int4(self, path, lead, out, inn):
        self.byte_leaves.append((path + ("q4",), (*lead, out, inn // 2)))
        self.float_leaves.append((path + ("s",), (*lead, out, 2), "scale",
                                  1.0 / (SIGMA4 * math.sqrt(inn))))

    def int8(self, path, out, inn, gain):
        self.byte_leaves.append((path + ("q8",), (out, inn)))
        self.float_leaves.append((path + ("s",), (out,), "scale", gain / SIGMA8))

    def norm(self, path, *shape):
        self.float_leaves.append((path, shape, "norm", 0.0))

    def bias(self, path, *shape):
        self.float_leaves.append((path, shape, "bias", 0.0))


def _set(tree: Dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _materialize(plan: _Plan, seed: int, device) -> Dict[str, Any]:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    leaves4 = [(p, s) for p, s in plan.byte_leaves if p[-1] == "q4"]
    leaves8 = [(p, s) for p, s in plan.byte_leaves if p[-1] == "q8"]
    n_floats = sum(_numel(s) for _, s, _, _ in plan.float_leaves)
    # A byte of two nibbles, each 1..15 (weights -7..7): one draw of 15 * 15.
    raw4 = torch.randint(0, 225, (sum(_numel(s) for _, s in leaves4),), generator=gen,
                         device=device, dtype=torch.uint8)
    raw8 = torch.randint(0, 255, (sum(_numel(s) for _, s in leaves8),), generator=gen,
                         device=device, dtype=torch.uint8)
    normals = torch.randn((n_floats,), generator=gen, device=device, dtype=torch.float32)
    tree: Dict[str, Any] = {}
    off = 0
    for path, shape in leaves4:
        n = _numel(shape)
        r = raw4.narrow(0, off, n).view(shape)
        _set(tree, path, (r % 15 + 1) | ((r // 15 + 1) << 4))
        off += n
    del raw4
    off = 0
    for path, shape in leaves8:
        n = _numel(shape)
        _set(tree, path, (raw8.narrow(0, off, n).view(shape).to(torch.int16) - 127)
             .to(torch.int8))
        off += n
    del raw8
    off = 0
    for path, shape, kind, base in plan.float_leaves:
        n = _numel(shape)
        z = normals.narrow(0, off, n).view(shape)
        if kind == "scale":
            leaf = base * (1.0 + 0.1 * z)
        elif kind == "norm":
            leaf = (1.0 + 0.1 * z).to(torch.bfloat16)
        else:
            leaf = (0.02 * z).to(torch.bfloat16)
        _set(tree, path, leaf)
        off += n
    return tree


def vocab_rows(vocab: int) -> int:
    return -(-vocab // 512) * 512


def _text_plan(plan: _Plan, cfg: Dict[str, Any], head: str, qkv_bias: bool) -> None:
    h, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or h // heads
    inter, rows = cfg["intermediate_size"], vocab_rows(cfg["vocab_size"])
    t = ("text",)
    if head == "int4":
        plan.int4(t + ("embed_tokens",), (), rows, h)
        # Entries of standard deviation one: the embedding is not a projection.
        plan.float_leaves[-1] = (t + ("embed_tokens", "s"), (rows, 2), "scale", 1.0 / SIGMA4)
        plan.int4(t + ("lm_head",), (), rows, h)
    else:
        plan.int8(t + ("embed_tokens",), rows, h, 1.0)
        plan.int8(t + ("lm_head",), rows, h, 1.0 / math.sqrt(h))
    plan.norm(t + ("final_norm",), h)
    ls = t + ("layers_stacked",)
    plan.norm(ls + ("input_norm",), L, h)
    plan.norm(ls + ("post_attn_norm",), L, h)
    qkv_out = (heads + 2 * kv) * hd
    plan.int4(ls + ("qkv_proj",), (L,), qkv_out, h)
    if qkv_bias:
        plan.bias(ls + ("qkv_bias",), L, qkv_out)
    plan.int4(ls + ("o_proj",), (L,), h, heads * hd)
    plan.int4(ls + ("mlp", "gateup_proj"), (L,), 2 * inter, h)
    plan.int4(ls + ("mlp", "down_proj"), (L,), h, inter)


def _vision_plan(plan: _Plan, vc: Dict[str, Any]) -> None:
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


def make_weights(model: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The weights of a configuration file's ``model`` section (a
    ``vision_config`` makes a VLM) from ``seed``, on ``device``."""
    plan = _Plan()
    vision = model.get("vision_config")
    if vision is not None:
        _vision_plan(plan, vision)
    _text_plan(plan, model, model["head_quantization"], model.get("qkv_bias", False))
    tree = _materialize(plan, seed, device)
    blocks = tree.get("vision", {}).get("blocks")
    if blocks is not None:
        tree["vision"]["blocks"] = [blocks[i] for i in range(len(blocks))]
    head = tree["text"]["lm_head"]
    head["s"][model["eos_token_id"]] = 0.0
    return tree


__all__ = ["make_weights", "vocab_rows", "SIGMA4", "SIGMA8"]
