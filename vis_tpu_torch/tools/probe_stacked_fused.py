"""Probe: the in-kernel layer pick composed with the folded-bias unpack and
with a fused gate_up + down MLP, and the int4 vocab head by padding.

The port of ``tools/probe_stacked_fused.py``.  Shapes: the 7B MLP stack
(28 x gate_up [37888, 3584] + down [3584, 18944] int4) and the head
[152064, 3584] int4.  Variants:

  D. layer picked by index (``q4_matmul_stacked``, kernel A): the
     counterpart of the probe's kernel G, ``_q4_stacked_kernel``
  E. layer picked by index, folded-bias unpack
     (``q4_matmul_stacked_folded``, the counterpart of kernel F,
     ``_q4_stacked_folded_kernel``)
  F. the fused int4 SwiGLU MLP over per-slab repacked weights
     (``q4_fused_mlp_slab``, the counterpart of kernel H,
     ``_q4_fused_mlp_kernel``), slabs of 1184 intermediate rows
  H. the head through the folded kernel (``q4_matmul_folded``, the
     counterpart of kernel I, ``flat_folded``), its rows padded to a
     multiple of 512, 1024 and 2048 as the probe pads them for its VMEM
     block; the port's kernel has no block of that kind (one warp per row),
     so the sweep shows what the padding alone costs

Run: python -m vis_tpu_torch.tools.probe_stacked_fused [DEFH] [--device cuda:0]
"""

from __future__ import annotations

import sys

import torch

from vis_tpu_torch.ops import quantized as qz
from vis_tpu_torch.tools import _probe

INTER_BLOCK = 1184  # 18944 / 16 slabs
HEAD_BLOCKS = (512, 1024, 2048)


def pad_head(q: torch.Tensor, s: torch.Tensor, block: int):
    """The head q [V, H/2] and scales [2, V] with zero rows up to a multiple
    of ``block`` (a copy only where padding is needed, as in the probe)."""
    pad = -q.shape[0] % block
    if not pad:
        return q, s
    return (torch.nn.functional.pad(q, (0, 0, 0, pad)),
            torch.nn.functional.pad(s, (0, pad)))


def run(which: str = "DEFH", device="cuda:0", hidden: int = _probe.HIDDEN,
        inter: int = _probe.INTER, layers: int = _probe.LAYERS, vocab: int = _probe.VOCAB,
        inter_block: int = INTER_BLOCK, steps: int = _probe.STEPS,
        repeats: int = _probe.REPEATS, seed: int = 0) -> dict:
    """Runs the variants in ``which``; returns, by key (D, E, F, H512,
    H1024, H2048), each one's times, GB/s, launches and the output of its
    first pass (or head step) from x0 (``first``) and of that pass's first
    layer (``layer``; a head step is one layer)."""
    which = set(which.upper())
    gen = _probe.generator(device, seed)
    stack = _probe.int4_stack(gen, hidden, inter, layers)
    _probe.banner(device, stack.nbytes)
    x0 = _probe.first_input(device, hidden)
    results = {}

    def timed(key, label, one_pass, nbytes=stack.nbytes):
        step, first, layer = _probe.chain(one_pass, x0)
        results[key] = _probe.measure(label, step, device, nbytes, steps, repeats,
                                      "pass" if key[0] != "H" else "step")
        results[key].update(first=first, layer=layer)

    def run_stack(gate_up, down):
        def one_pass(h, n=layers):
            for i in range(n):
                h = _probe.residual(h, down(_probe.swiglu(gate_up(h, i)), i))
            return h
        return one_pass

    if "D" in which:
        gu_rows, dn_rows = stack.row_scales()
        timed("D", "D. stacked pick:      ", run_stack(
            lambda h, i: qz.q4_matmul_stacked(h, qz.QuantizedWeight4Pick(stack.gu_q, gu_rows, i)),
            lambda a, i: qz.q4_matmul_stacked(a, qz.QuantizedWeight4Pick(stack.dn_q, dn_rows, i))))
        del gu_rows, dn_rows

    if "E" in which:
        timed("E", "E. stacked + folded:  ", run_stack(
            lambda h, i: qz.q4_matmul_stacked_folded(h, stack.gu_q, stack.gu_s, i),
            lambda a, i: qz.q4_matmul_stacked_folded(a, stack.dn_q, stack.dn_s, i)))

    if "F" in which:
        slabs = qz.repack_slabs(stack.gu_q, stack.gu_s, stack.dn_q, stack.dn_s, inter_block)

        def fused(h, n=layers):
            for i in range(n):
                h = _probe.residual(h, qz.q4_fused_mlp_slab(h, *slabs, i))
            return h

        timed("F", "F. fused MLP region:  ", fused)
        del slabs
    del stack

    if "H" in which:
        hq = torch.randint(0, 256, (vocab, hidden // 2), generator=gen, device=device,
                           dtype=torch.uint8)
        hs = torch.full((2, vocab), _probe.SCALE, device=device)
        for block in HEAD_BLOCKS:
            q, s = pad_head(hq, hs, block)

            def head_step(h, n=1, q=q, s=s):
                return torch.tanh(qz.q4_matmul_folded(h, q, s)[:, :hidden]).to(torch.bfloat16)

            timed(f"H{block}", f"H. head pad {block:4d}: rows={q.shape[0]}", head_step,
                  nbytes=hq.numel())
    return results


def main(argv=None) -> int:
    args = _probe.parser(__doc__, "DEFH").parse_args(argv)
    run(args.variants, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
