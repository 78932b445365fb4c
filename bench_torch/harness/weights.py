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
Which leaves a model has, and how the tree is finished, is its family's
(``families/<model_type>.py``); the order of the leaves fixes the bytes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from bench_torch.families import family_of

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


def plan_of(model: Dict[str, Any]) -> _Plan:
    """The leaves of a configuration file's ``model`` section, in the
    order its family adds them (``families/<model_type>.py``)."""
    plan = _Plan()
    family_of(model).plan_weights(plan, model)
    return plan


def make_weights(model: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The weights of a configuration file's ``model`` section from
    ``seed``, on ``device``, finished by its family."""
    tree = _materialize(plan_of(model), seed, device)
    return family_of(model).finish_weights(tree, model)


__all__ = ["make_weights", "plan_of", "vocab_rows", "SIGMA4", "SIGMA8"]
