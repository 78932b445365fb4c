"""Time kernels D, E and H of another checkout beside this checkout's, on one
NVIDIA GPU, in one process.

    python3 tools/compare_kernels.py [--kernel D,E,H] BEFORE_CSRC [--rounds 2]

BEFORE_CSRC is a directory holding another checkout's ``vis_tpu_torch/csrc``
sources, for instance the parent commit's:

    git archive HEAD vis_tpu_torch/csrc | tar -x -C build/parent

Its ``.cu`` files are compiled by nvcc for sm_90a (one nvcc each, all at
once, the port's flags) into one shared library under
``build/compare_kernels/``, and its ``vt_q8_matmul`` (D), ``vt_q8_swiglu``
(E) and ``vt_q4_fused_mlp`` (H) entries are bound with ctypes (the same C
signatures as this checkout's).  The shapes are chip_smoke.py's:

- D at every int8 qkv and o of the main path (Qwen2.5-VL-7B at B = 1 and 8,
  Llama-3.1-8B at B = 1 and 3), walking a stack of ``D_WALK`` layers, and
  the explainer's int8 vocab head [128512, 4096] at B = 1 and 3; each held
  to the plain version (max|err| <= 1e-3 * max|y|) with its zero-padded
  rows (the head's last 256, a projection's last 16 in layer 0) exactly 0;
- E at both models' MLP (``MLP8``), held to 2^-7 * max|y|;
- H at the int4 probe's layer (16 slabs of 1184, hidden 3584, B = 1), two
  layers of the repack, held to 2^-12 * max_o sum_i |act_i w_oi| + 1e-4 *
  max|y| and bit-equal across two runs.

Both sides are timed as chip_smoke.py times a kernel: a CUDA graph of a run
of launches walking the stack, so that each launch reads its weights from
device memory.  The runs go before, after, after, before (``--rounds``
pairs); the table gives each side's median beside the bound.  The last line
is one JSON object of the medians.  Nothing here imports jax or the JAX
package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.modules["jax"] = None
sys.modules["vis_tpu"] = None
BUILD = REPO / "build" / "compare_kernels"
ENTRIES = {"D": "vt_q8_matmul", "E": "vt_q8_swiglu", "H": "vt_q4_fused_mlp"}


def build_before(csrc: Path) -> ctypes.CDLL:
    """The other checkout's kernels as one library, with D's, E's and H's
    entries bound."""
    from vis_tpu_torch.ops import _kernels

    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._nvcc()
    sources = sorted(csrc.glob("*.cu"))
    if not sources:
        raise SystemExit(f"compare_kernels: no .cu sources in {csrc}")
    objects = [BUILD / f"{src.stem}.o" for src in sources]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        for done in [pool.submit(subprocess.run, [nvcc, *_kernels.NVCC_FLAGS, "-c", "-o",
                                                  str(obj), str(src)], check=True)
                     for src, obj in zip(sources, objects)]:
            done.result()
    target = BUILD / "libbefore.so"
    subprocess.run([nvcc, "-shared", "-o", str(target), *map(str, objects)], check=True)
    lib = ctypes.CDLL(str(target))
    for entry in ENTRIES.values():
        fn = getattr(lib, entry)
        fn.argtypes = _kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return lib


def before_d(lib, x, q, scale):
    """The other checkout's D, launched as its wrapper does."""
    import torch

    from vis_tpu_torch.ops import _kernels

    y = torch.empty((x.shape[0], q.shape[0]), dtype=torch.float32, device=x.device)
    err = lib.vt_q8_matmul(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                           x.shape[0], q.shape[0], q.shape[1], _kernels.stream_of(x))
    _kernels.check(err, "vt_q8_matmul (before)")
    return y


def before_e(lib, x, gq, gs, dq, ds):
    """The other checkout's E on one layer, launched as its wrapper does."""
    import torch

    from vis_tpu_torch.ops import _kernels

    batch, hidden = x.shape
    inter = gq.shape[0] // 2
    h = torch.empty((batch, inter), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((batch, hidden), dtype=torch.float32, device=x.device)
    err = lib.vt_q8_swiglu(x.data_ptr(), gq.data_ptr(), gs.data_ptr(), dq.data_ptr(),
                           ds.data_ptr(), h.data_ptr(), y.data_ptr(), batch, hidden, inter,
                           _kernels.stream_of(x))
    _kernels.check(err, "vt_q8_swiglu (before)")
    return y.to(x.dtype)


def before_h(lib, x, gq, gs, dq, ds):
    """The other checkout's H on one layer's slabs.  Its scratch is this
    checkout's size, n * B * (2 * bi + 4 * H) bytes, which holds the [B,
    n * bi] bf16 act of a checkout that needs only that."""
    import torch

    from vis_tpu_torch.ops import _kernels

    batch, hidden = x.shape
    n, two_bi, _ = gq.shape
    bi = two_bi // 2
    scratch = torch.empty((n * batch * (2 * bi + 4 * hidden),), dtype=torch.uint8,
                          device=x.device)
    y = torch.empty((batch, hidden), dtype=torch.float32, device=x.device)
    err = lib.vt_q4_fused_mlp(x.data_ptr(), gq.data_ptr(), gs.data_ptr(), dq.data_ptr(),
                              ds.data_ptr(), scratch.data_ptr(), y.data_ptr(), batch, hidden,
                              n, bi, _kernels.stream_of(x))
    _kernels.check(err, "vt_q4_fused_mlp (before)")
    return y


def _hold(label: str, sides: dict, want, tol: float, padded=None) -> None:
    """Every side finite and within ``tol`` of ``want``; the columns
    ``padded`` (a slice) exactly 0; two runs of each side bit-equal."""
    import torch

    for side, fn in sides.items():
        got = fn(0)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        pad = 0.0 if padded is None else got[:, padded].abs().max().item()
        again = torch.equal(got, fn(0))
        print(f"[{label}] {side}: max|err| {err:.3e} <= tol {tol:.3e}; padded rows max|y| "
              f"{pad} == 0; a second run bit-equal: {again}")
        if not (bool(torch.isfinite(got).all()) and err <= tol and pad == 0.0 and again):
            raise AssertionError(f"{label} {side}: err {err} > {tol}, padded {pad}, "
                                 f"non-finite, or two runs differ")


def _time(label: str, sides: dict, calls: int, rounds: int, limit: tuple, medians: dict):
    """Both sides as CUDA graphs of ``calls`` launches, in turns."""
    import chip_smoke as cs

    times = {"before": [], "after": []}
    for _ in range(rounds):
        for side in ("before", "after", "after", "before"):
            times[side].append(cs.device_ms(sides[side], calls))
    med = {side: statistics.median(t) for side, t in times.items()}
    medians[label] = dict(med, bound=limit[0])
    print(f"[{label}] before {' '.join(f'{t:.4f}' for t in times['before'])} ms, after "
          f"{' '.join(f'{t:.4f}' for t in times['after'])} ms; medians before "
          f"{med['before']:.4f}, after {med['after']:.4f} ms (after/before "
          f"{med['after'] / med['before']:.3f}x, bound {limit[0]:.4f} ms ({limit[1]}), after "
          f"{limit[0] / med['after']:.1%} of bound)", flush=True)


def compare_d(lib, gen, dev, rounds: int, medians: dict) -> None:
    import torch

    import chip_smoke as cs
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.serving.engine import random_q8, random_q8_stack

    for model, projections, batches in (("qwen", cs.PROJECTIONS, (1, 8)),
                                        ("llama", cs.LLAMA_PROJECTIONS, (1, 3))):
        for name in ("qkv", "o"):
            out, inn = projections[name]
            w = random_q8_stack(gen, cs.D_WALK, out=out, inn=inn, device=dev)
            w.q[0, -16:], w.scale[0, -16:] = 0, 0.0
            for rows in batches:
                x = torch.randn((rows, inn), generator=gen, device=dev).to(torch.bfloat16)
                sides = {
                    "before": lambda i: before_d(lib, x, w.q[i % cs.D_WALK],
                                                 w.scale[i % cs.D_WALK]),
                    "after": lambda i: qz.q8_matmul(x, w.q[i % cs.D_WALK],
                                                    w.scale[i % cs.D_WALK]),
                }
                label = f"D {model} {name} [{out}, {inn}] B={rows}"
                want = qz.q8_matmul_plain(x, w.q[0], w.scale[0])
                _hold(label, sides, want, 1e-3 * want.abs().max().item(), slice(out - 16, out))
                limit = cs.bound(out * inn + out * 4 + rows * inn * 2 + rows * out * 4,
                                 2 * rows * out * inn)
                _time(label, sides, 2 * cs.D_WALK, rounds, limit, medians)
            del w
            torch.cuda.empty_cache()
    rows_padded, vocab, inn = cs.HEAD8
    w = random_q8(gen, rows_padded, vocab, inn, device=dev)
    for rows in (1, 3):
        x = torch.randn((rows, inn), generator=gen, device=dev).to(torch.bfloat16)
        sides = {"before": lambda i: before_d(lib, x, w.q, w.scale),
                 "after": lambda i: qz.q8_matmul(x, w.q, w.scale)}
        label = f"D head [{rows_padded}, {inn}] B={rows}"
        want = qz.q8_matmul_plain(x, w.q, w.scale)
        _hold(label, sides, want, 1e-3 * want.abs().max().item(), slice(vocab, rows_padded))
        limit = cs.bound(w.q.numel() + rows_padded * 4 + rows * inn * 2 + rows * rows_padded * 4,
                         2 * rows * rows_padded * inn)
        _time(label, sides, 30, rounds, limit, medians)
    del w
    torch.cuda.empty_cache()


def compare_e(lib, gen, dev, rounds: int, medians: dict) -> None:
    import torch

    import chip_smoke as cs
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.serving.engine import random_q8_stack

    for model, (hidden, inter, layers, batches) in cs.MLP8.items():
        gateup = random_q8_stack(gen, layers, out=2 * inter, inn=hidden, device=dev)
        down = random_q8_stack(gen, layers, out=hidden, inn=inter, device=dev)

        def weights(i):
            i %= layers
            return gateup.q[i], gateup.scale[i], down.q[i], down.scale[i]

        for rows in batches:
            x = torch.randn((rows, hidden), generator=gen, device=dev).to(torch.bfloat16)
            sides = {
                "before": lambda i: before_e(lib, x, *weights(i)),
                "after": lambda i: qz.fused_swiglu_mlp(
                    x, qz.QuantizedWeight(*weights(i)[:2]), qz.QuantizedWeight(*weights(i)[2:])),
            }
            label = f"E {model} H={hidden} I={inter} B={rows}"
            want = qz.fused_swiglu_mlp_plain(x, *weights(0)).float()
            _hold(label, sides, want, 2.0 ** -7 * want.abs().max().item())
            weight = 3 * hidden * inter + 2 * inter * 4 + hidden * 4
            limit = cs.bound(weight + 2 * rows * hidden * 2, 6 * rows * hidden * inter)
            _time(label, sides, 2 * layers, rounds, limit, medians)
        del gateup, down
        torch.cuda.empty_cache()


def compare_h(lib, gen, dev, rounds: int, medians: dict) -> None:
    import torch

    import chip_smoke as cs
    from vis_tpu_torch.ops import quantized as qz

    hidden, inter = cs.PROBE_MLP
    bi = cs.INTER_BLOCK

    def rand_s(*shape):
        return 0.01 + 0.005 * torch.randn(shape, generator=gen, device=dev)

    gu_q = torch.randint(0, 256, (2, 2 * inter, hidden // 2), generator=gen, device=dev,
                         dtype=torch.uint8)
    dn_q = torch.randint(0, 256, (2, hidden, inter // 2), generator=gen, device=dev,
                         dtype=torch.uint8)
    slabs = qz.repack_slabs(gu_q, rand_s(2, 2, 2 * inter), dn_q, rand_s(2, 2, hidden), bi)
    del gu_q, dn_q
    x = torch.randn((1, hidden), generator=gen, device=dev).to(torch.bfloat16)
    sides = {"before": lambda i: before_h(lib, x, *(t[i % 2] for t in slabs)),
             "after": lambda i: qz.q4_fused_mlp_slab(x, *slabs, i % 2)}
    want = qz.q4_fused_mlp_slab_plain(x, *slabs, 0)
    act = qz.q4_slab_act_plain(x, slabs[0][0], slabs[1][0]).float()
    w = torch.cat([qz.unpack_int4(q, s.T, torch.float32)
                   for q, s in zip(slabs[2][0], slabs[3][0])], dim=1)
    tol = 2.0 ** -12 * (act.abs() @ w.abs().T).max().item() + 1e-4 * want.abs().max().item()
    del act, w
    label = f"H one layer H {hidden} I {inter} ({inter // bi} slabs of {bi}) B=1"
    _hold(label, sides, want, tol)
    weight = sum(t[0].numel() * t.element_size() for t in slabs)
    limit = cs.bound(weight + hidden * 2 + hidden * 4, 2 * 3 * hidden * inter)
    _time(label, sides, 40, rounds, limit, medians)
    del slabs
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("before", type=Path, help="the other checkout's csrc directory")
    parser.add_argument("--kernel", default="D,E,H",
                        help="comma-separated kernels to compare (D, E, H)")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    kernels = [k.strip().upper() for k in args.kernel.split(",") if k.strip()]
    unknown = sorted(set(kernels) - set(ENTRIES))
    if unknown:
        raise SystemExit(f"compare_kernels: no kernel {unknown}; choose from {sorted(ENTRIES)}")

    import torch

    import chip_smoke as cs

    cs.phase_card()
    cs.phase_build()
    lib = build_before(args.before)
    dev = torch.device(cs.DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    medians = {}
    compare = {"D": compare_d, "E": compare_e, "H": compare_h}
    for kernel in kernels:
        compare[kernel](lib, gen, dev, args.rounds, medians)
    print(json.dumps(medians))
    return 0


if __name__ == "__main__":
    sys.exit(main())
