"""Probe: int4 unpack variants of the MLP stack's matmul.

The port of ``tools/probe_unpack.py``.  Variants, on the MLP stack's shape
(28 layers of gate_up [37888, 3584] + down [3584, 18944]):

  A. kernel B (``q4_matmul``): each (nibble - 8) * s rounded to bf16
  B. folded-bias unpack (``q4_matmul_folded``, the counterpart of the
     probe's kernel J, ``_q4_matmul_kernel_folded``): n = (b & 15), (b >> 4),
     the -8 folded into y -= 8 * sum(x_half), the scale after the sum
  C. signed int4 (``i4_matmul``, the counterpart of kernel K,
     ``_i4_matmul_kernel``): the probe's native jnp.int4 weight, stored as
     adjacent two's-complement nibbles (``pack_int4_adjacent``)
  D. the int8 fused MLP (kernel E, ``fused_swiglu_mlp``), over twice the bytes
  E. the device-memory floor: an in-place u8 xor over a 2 GiB tensor

Run: python -m vis_tpu_torch.tools.probe_unpack [ABCDE] [--device cuda:0]
"""

from __future__ import annotations

import sys

import torch

from vis_tpu_torch.ops import quantized as qz
from vis_tpu_torch.tools import _probe

FLOOR_BYTES = 2 * 1024 ** 3


def _i4_stack(gen, shape, layers):
    """Random signed int4 in [-7, 7] packed as ``pack_int4_adjacent`` does,
    one layer at a time (the int8 values of the whole stack would not fit
    beside it)."""
    return torch.stack([
        qz.pack_int4_adjacent(torch.randint(-7, 8, shape, generator=gen, device=gen.device,
                                            dtype=torch.int8))
        for _ in range(layers)])


def signed_stack(gen, hidden: int, inter: int, layers: int):
    """Variant C's weights, drawn from ``gen`` after the int4 stack:
    gate_up [L, 2I, H/2] and down [L, H, I/2] signed int4 (adjacent
    nibbles), with uniform scales [L, 1, 2I] and [L, 1, H]."""
    gu4 = _i4_stack(gen, (2 * inter, hidden), layers)
    dn4 = _i4_stack(gen, (hidden, inter), layers)
    gs4 = torch.full((layers, 1, 2 * inter), _probe.SCALE, device=gen.device)
    ds4 = torch.full((layers, 1, hidden), _probe.SCALE, device=gen.device)
    return gu4, gs4, dn4, ds4


def run(which: str = "ABCDE", device="cuda:0", hidden: int = _probe.HIDDEN,
        inter: int = _probe.INTER, layers: int = _probe.LAYERS, steps: int = _probe.STEPS,
        repeats: int = _probe.REPEATS, seed: int = 0, floor_bytes: int = FLOOR_BYTES) -> dict:
    """Runs the variants in ``which``; returns, by letter, each one's times,
    GB/s, launches and (A-D) the output of its first pass from x0
    (``first``) and of that pass's first layer (``layer``)."""
    which = set(which.upper())
    gen = _probe.generator(device, seed)
    stack = _probe.int4_stack(gen, hidden, inter, layers)
    _probe.banner(device, stack.nbytes)
    x0 = _probe.first_input(device, hidden)
    results = {}

    def timed(letter, label, one_pass, nbytes=stack.nbytes):
        step, first, layer = _probe.chain(one_pass, x0)
        results[letter] = _probe.measure(label, step, device, nbytes, steps, repeats)
        results[letter].update(first=first, layer=layer)

    def stacked(matmul, gu, gs, dn, ds):
        def one_pass(h, n=layers):
            for i in range(n):
                d = matmul(_probe.swiglu(matmul(h, gu[i], gs[i])), dn[i], ds[i])
                h = _probe.residual(h, d)
            return h
        return one_pass

    if "A" in which:
        gu_rows, dn_rows = stack.row_scales()
        timed("A", "A. kernel B:         ", stacked(
            lambda h, q, s: qz.quantized_matmul4(h, qz.QuantizedWeight4(q=q, scale=s)),
            stack.gu_q, gu_rows, stack.dn_q, dn_rows))
        del gu_rows, dn_rows

    if "B" in which:
        timed("B", "B. folded-bias:      ", stacked(
            qz.q4_matmul_folded, stack.gu_q, stack.gu_s, stack.dn_q, stack.dn_s))
    del stack

    if "C" in which:
        gu4, gs4, dn4, ds4 = signed_stack(gen, hidden, inter, layers)
        timed("C", "C. signed int4:      ", stacked(qz.i4_matmul, gu4, gs4, dn4, ds4),
              nbytes=gu4.numel() + dn4.numel())
        del gu4, dn4, gs4, ds4

    if "D" in which:
        gu8 = torch.randint(-127, 128, (layers, 2 * inter, hidden), generator=gen,
                            device=device, dtype=torch.int8)
        dn8 = torch.randint(-127, 128, (layers, hidden, inter), generator=gen,
                            device=device, dtype=torch.int8)
        gs8 = torch.full((layers, 2 * inter), 0.0001, device=device)
        ds8 = torch.full((layers, hidden), 0.0001, device=device)

        def stack_i8(h, n=layers):
            for i in range(n):
                d = qz.fused_swiglu_mlp(h, qz.QuantizedWeight(gu8[i], gs8[i]),
                                        qz.QuantizedWeight(dn8[i], ds8[i]))
                h = _probe.residual(h, d)
            return h

        timed("D", "D. int8 fused MLP (2x bytes):", stack_i8, nbytes=gu8.numel() + dn8.numel())
        del gu8, dn8, gs8, ds8

    if "E" in which:
        big = torch.randint(0, 256, (floor_bytes,), generator=gen, device=device,
                            dtype=torch.uint8)
        results["E"] = _probe.measure("E. u8 xor, read+write:", lambda: big.bitwise_xor_(1),
                                      device, 2 * big.numel(), 4, repeats, per="xor")
        del big
    return results


def main(argv=None) -> int:
    args = _probe.parser(__doc__, "ABCDE").parse_args(argv)
    run(args.variants, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
