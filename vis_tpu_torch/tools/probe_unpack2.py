"""Probe 2: can quantized weights skip the per-byte cast to bf16?

The port of ``tools/probe_unpack2.py``.  The JAX probe asks whether the TPU's
matrix unit can take int8 operands natively, so that weight bytes reach it
with no elementwise pass; here each variant runs the 7B MLP stack (28 x
gate_up [37888, 3584] + down [3584, 18944]) through its kernel:

  S. the stream floor: every byte of the int4 stack summed as wrapping
     int32 (``u8_sum``, the counterpart of kernel L, ``_stream_kernel``);
     a pass returns the sum
  F. int8 x int8 dot (``i8_matmul``, kernel M, ``_i8dot_kernel``) over the
     int8 stack (twice the bytes), activations quantized per row by
     ``quant_act``
  G. bf16 x int8 dot (kernel N, ``_mixdot_kernel``), which is kernel D's
     function: ``q8_matmul`` on the int8 stack
  H. int4 -> int8 through int32 staging (``q4_i8_matmul``, kernel O,
     ``_q4i8_kernel``): nibble n read as n - 8
  I. int4 -> int8 through int8 shifts (``q4_i8s_matmul``, kernel P,
     ``_q4i8s_kernel``): the same bytes read as two's-complement nibbles

F, H and I quantize the activation before each matmul and multiply its
output by the activation's scale, as the probe's layer bodies do.  The
JAX probe prints FAILED for a variant that raises and carries on; here the
error ends the run.

Run: python -m vis_tpu_torch.tools.probe_unpack2 [SFGHI] [--device cuda:0]
"""

from __future__ import annotations

import sys

import torch

from vis_tpu_torch.ops import int_dot
from vis_tpu_torch.ops import quantized as qz
from vis_tpu_torch.tools import _probe

I8_SCALE = 0.0001  # the probe's uniform int8 scale


def int8_stack(gen: torch.Generator, hidden: int, inter: int, layers: int):
    """The probe's int8 stack, drawn from ``gen`` after the int4 stack:
    gate_up [L, 2I, H] and down [L, H, I] int8 in [-127, 127], with uniform
    scales in the probe's layout, [L, 1, 2I] and [L, 1, H]."""
    device = gen.device
    gu8 = torch.randint(-127, 128, (layers, 2 * inter, hidden), generator=gen, device=device,
                        dtype=torch.int8)
    dn8 = torch.randint(-127, 128, (layers, hidden, inter), generator=gen, device=device,
                        dtype=torch.int8)
    gs8 = torch.full((layers, 1, 2 * inter), I8_SCALE, device=device)
    ds8 = torch.full((layers, 1, hidden), I8_SCALE, device=device)
    return gu8, gs8, dn8, ds8


def quantized_layer(matmul, h, gq, gs, dq, ds):
    """One layer of the probe's F, H and I bodies: quant_act, the matmul
    times the activation's scale, SwiGLU, again for down, the residual."""
    h8, hs = int_dot.quant_act(h)
    a8, as_ = int_dot.quant_act(_probe.swiglu(matmul(h8, gq, gs) * hs))
    return _probe.residual(h, matmul(a8, dq, ds) * as_)


def mixed_layer(h, gq, gs, dq, ds):
    """One layer of the probe's G body on kernel D: scales [O]."""
    return _probe.residual(h, qz.q8_matmul(_probe.swiglu(qz.q8_matmul(h, gq, gs)), dq, ds))


def stream_sum(stack: _probe.Stack, layers: int) -> torch.Tensor:
    """Variant S's pass over the first ``layers`` layers: the wrapping int32
    sum of every byte of gate_up and down, [1, 1]."""
    acc = int_dot.u8_sum(stack.gu_q[0]) + int_dot.u8_sum(stack.dn_q[0])
    for i in range(1, layers):
        acc = acc + int_dot.u8_sum(stack.gu_q[i]) + int_dot.u8_sum(stack.dn_q[i])
    return acc


def run(which: str = "SFGHI", device="cuda:0", hidden: int = _probe.HIDDEN,
        inter: int = _probe.INTER, layers: int = _probe.LAYERS, steps: int = _probe.STEPS,
        repeats: int = _probe.REPEATS, seed: int = 0) -> dict:
    """Runs the variants in ``which``; returns, by letter, each one's times,
    GB/s and launches, and the output of its first pass from x0
    (``first``; for S the pass's int32 sum) and of that pass's first layer
    (``layer``)."""
    which = set(which.upper())
    gen = _probe.generator(device, seed)
    stack = _probe.int4_stack(gen, hidden, inter, layers)
    _probe.banner(device, stack.nbytes)
    x0 = _probe.first_input(device, hidden)
    results = {}

    def timed(letter, label, one_pass, nbytes, start=x0):
        step, first, layer = _probe.chain(one_pass, start)
        results[letter] = _probe.measure(label, step, device, nbytes, steps, repeats)
        results[letter].update(first=first, layer=layer)

    def stacked(layer_fn, *weights):
        def one_pass(h, n=layers):
            for i in range(n):
                h = layer_fn(h, *(w[i] for w in weights))
            return h
        return one_pass

    if "S" in which:
        # The probe's chain: a <- a ^ pass, from 0.
        timed("S", "S. u8 stream floor:  ", lambda a, n=layers: a ^ stream_sum(stack, n),
              stack.nbytes, start=torch.zeros((1, 1), dtype=torch.int32, device=device))

    if "F" in which or "G" in which:
        gu8, gs8, dn8, ds8 = int8_stack(gen, hidden, inter, layers)
        i8_bytes = gu8.numel() + dn8.numel()
        if "F" in which:
            timed("F", "F. i8 native dot (2x bytes):", stacked(
                lambda h, *w: quantized_layer(int_dot.i8_matmul, h, *w), gu8, gs8, dn8, ds8),
                i8_bytes)
        if "G" in which:
            timed("G", "G. bf16 x i8 dot (2x bytes):", stacked(
                mixed_layer, gu8, gs8[:, 0], dn8, ds8[:, 0]), i8_bytes)
        del gu8, gs8, dn8, ds8

    for letter, label, matmul in (("H", "H. q4->i8 (i32) dot: ", int_dot.q4_i8_matmul),
                                  ("I", "I. q4->i8 (i8<<) dot:", int_dot.q4_i8s_matmul)):
        if letter in which:
            timed(letter, label, stacked(
                lambda h, *w, matmul=matmul: quantized_layer(matmul, h, *w),
                stack.gu_q, stack.gu_s, stack.dn_q, stack.dn_s), stack.nbytes)
    return results


def main(argv=None) -> int:
    args = _probe.parser(__doc__, "SFGHI").parse_args(argv)
    run(args.variants, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
