"""Probe: the int4 MLP stack by how each layer's weight reaches the kernel.

The port of ``tools/probe_scan_slice.py``.  On the TPU the question was
whether ``lax.scan`` over stacked weights copies each layer's slice before
the kernel reads it.  In torch a layer of a stack is a view, so A, B and D
differ only in how the layer is named; the probe keeps them as the card's
answer to the same question.  Variants (28 layers of int4 gate_up
[37888, 3584] + down [3584, 18944]):

  A. loop over the stack's layer views, kernel B (``q4_matmul``)
  B. loop over 28 separate per-layer tensors (direct operands), kernel B
  C. one layer's weights, 28 times a pass (ms per layer), kernel B
  D. the layer picked by index inside the wrapper, kernel A
     (``q4_matmul_stacked``): the counterpart of the probe's kernel Q,
     ``_q4_stacked_kernel``

Run: python -m vis_tpu_torch.tools.probe_scan_slice [ABCD] [--device cuda:0]
"""

from __future__ import annotations

import sys

from vis_tpu_torch.ops import quantized as qz
from vis_tpu_torch.tools import _probe


def mlp_body(h, gq, gs, dq, ds):
    """One layer through kernel B; gs / ds are [O, 2] (kernel B's layout)."""
    gu = qz.quantized_matmul4(h, qz.QuantizedWeight4(q=gq, scale=gs))
    d = qz.quantized_matmul4(_probe.swiglu(gu), qz.QuantizedWeight4(q=dq, scale=ds))
    return _probe.residual(h, d)


def mlp_body_stacked(h, idx, stack: _probe.Stack, gu_rows, dn_rows):
    """One layer through kernel A, the layer picked by index."""
    gu = qz.q4_matmul_stacked(h, qz.QuantizedWeight4Pick(stack.gu_q, gu_rows, idx))
    d = qz.q4_matmul_stacked(_probe.swiglu(gu), qz.QuantizedWeight4Pick(stack.dn_q, dn_rows, idx))
    return _probe.residual(h, d)


def run(which: str = "ABCD", device="cuda:0", hidden: int = _probe.HIDDEN,
        inter: int = _probe.INTER, layers: int = _probe.LAYERS, steps: int = _probe.STEPS,
        repeats: int = _probe.REPEATS, seed: int = 0) -> dict:
    """Runs the variants in ``which``; returns, by letter, each one's times,
    GB/s, launches and the output of its first pass from x0 (``first``) and
    of that pass's first layer (``layer``)."""
    which = set(which.upper())
    stack = _probe.int4_stack(_probe.generator(device, seed), hidden, inter, layers)
    gu_rows, dn_rows = stack.row_scales()
    _probe.banner(device, stack.nbytes)
    x0 = _probe.first_input(device, hidden)
    results = {}

    def timed(letter, label, one_pass, nbytes=stack.nbytes, per="pass", unit=1):
        step, first, layer = _probe.chain(one_pass, x0)
        results[letter] = _probe.measure(label, step, device, nbytes, steps, repeats, per, unit)
        results[letter].update(first=first, layer=layer)

    if "A" in which:
        def stack_scan(h, n=layers):
            for i in range(n):
                h = mlp_body(h, stack.gu_q[i], gu_rows[i], stack.dn_q[i], dn_rows[i])
            return h

        timed("A", "A. loop over stack views:", stack_scan)

    if "B" in which:
        per_layer = [(stack.gu_q[i].clone(), gu_rows[i].clone(), stack.dn_q[i].clone(),
                      dn_rows[i].clone()) for i in range(layers)]

        def unrolled(h, n=layers):
            for gq, gs, dq, ds in per_layer[:n]:
                h = mlp_body(h, gq, gs, dq, ds)
            return h

        timed("B", "B. per-layer tensors:    ", unrolled)
        del per_layer

    if "C" in which:
        one = (stack.gu_q[0], gu_rows[0], stack.dn_q[0], dn_rows[0])

        def single(h, n=layers):
            for _ in range(n):
                h = mlp_body(h, *one)
            return h

        timed("C", "C. one layer, direct:    ", single,
              nbytes=stack.gu_q[0].numel() + stack.dn_q[0].numel(), per="layer", unit=layers)

    if "D" in which:
        def stack_idx(h, n=layers):
            for i in range(n):
                h = mlp_body_stacked(h, i, stack, gu_rows, dn_rows)
            return h

        timed("D", "D. index, in-kernel pick:", stack_idx)
    return results


def main(argv=None) -> int:
    args = _probe.parser(__doc__, "ABCD").parse_args(argv)
    run(args.variants, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
