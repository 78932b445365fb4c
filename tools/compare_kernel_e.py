"""Time kernel E (the fused int8 SwiGLU MLP) of another checkout beside this
checkout's, on one NVIDIA GPU, in one process.

    python3 tools/compare_kernel_e.py BEFORE_CSRC [--rounds 2]

BEFORE_CSRC is a directory holding another checkout's ``vis_tpu_torch/csrc``
sources, for instance the parent commit's:

    git archive HEAD vis_tpu_torch/csrc | tar -x -C build/parent

Its ``.cu`` files are compiled by nvcc for sm_90a (one nvcc each, all at
once, the port's flags) into one shared library under
``build/compare_kernel_e/``, and its ``vt_q8_swiglu`` entry is bound with
ctypes (the same C signature as this checkout's).  At each main-path shape
of E (Qwen2.5-VL-7B H 3584, I 18944 at B = 1 and 8; Llama-3.1-8B H 4096,
I 14336 at B = 1 and 3; chip_smoke.py's ``MLP8``) both kernels are held to
the plain version (max|err| <= 2^-7 * max|y|) and timed as chip_smoke.py
times a kernel: a CUDA graph of a run of launches walking the stack of
layers, so that each launch reads its weights from device memory.  The
runs go before, after, after, before (``--rounds`` pairs); the table gives
each side's median.  The last line is one JSON object of the medians.
Nothing here imports jax or the JAX package.
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
BUILD = REPO / "build" / "compare_kernel_e"


def build_before(csrc: Path) -> ctypes.CDLL:
    """The other checkout's kernels as one library, with vt_q8_swiglu bound."""
    from vis_tpu_torch.ops import _kernels

    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._nvcc()
    sources = sorted(csrc.glob("*.cu"))
    if not sources:
        raise SystemExit(f"compare_kernel_e: no .cu sources in {csrc}")
    objects = [BUILD / f"{src.stem}.o" for src in sources]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        for done in [pool.submit(subprocess.run, [nvcc, *_kernels.NVCC_FLAGS, "-c", "-o",
                                                  str(obj), str(src)], check=True)
                     for src, obj in zip(sources, objects)]:
            done.result()
    target = BUILD / "libbefore.so"
    subprocess.run([nvcc, "-shared", "-o", str(target), *map(str, objects)], check=True)
    lib = ctypes.CDLL(str(target))
    lib.vt_q8_swiglu.argtypes = _kernels._SIGNATURES["vt_q8_swiglu"]
    lib.vt_q8_swiglu.restype = ctypes.c_int
    return lib


def before_mlp(lib, x, gq, gs, dq, ds):
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("before", type=Path, help="the other checkout's csrc directory")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()

    import torch

    import chip_smoke as cs
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.serving.engine import random_q8_stack

    cs.phase_card()
    cs.phase_build()
    lib = build_before(args.before)
    dev = torch.device(cs.DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    medians = {}
    for model, (hidden, inter, layers, batches) in cs.MLP8.items():
        gateup = random_q8_stack(gen, layers, out=2 * inter, inn=hidden, device=dev)
        down = random_q8_stack(gen, layers, out=hidden, inn=inter, device=dev)

        def weights(i):
            i %= layers
            return gateup.q[i], gateup.scale[i], down.q[i], down.scale[i]

        for rows in batches:
            x = torch.randn((rows, hidden), generator=gen, device=dev).to(torch.bfloat16)
            sides = {
                "before": lambda i: before_mlp(lib, x, *weights(i)),
                "after": lambda i: qz.fused_swiglu_mlp(
                    x, qz.QuantizedWeight(*weights(i)[:2]), qz.QuantizedWeight(*weights(i)[2:])),
            }
            want = qz.fused_swiglu_mlp_plain(x, *weights(0)).float()
            tol = 2.0 ** -7 * want.abs().max().item()
            for side, fn in sides.items():
                err = (fn(0).float() - want).abs().max().item()
                print(f"[E] {model} B={rows} {side}: max|err| {err:.3e} <= tol {tol:.3e}")
                if not err <= tol:
                    raise AssertionError(f"E {side} {model} B={rows}: {err} > {tol}")
            times = {"before": [], "after": []}
            for _ in range(args.rounds):
                for side in ("before", "after", "after", "before"):
                    times[side].append(cs.device_ms(sides[side], 2 * layers))
            weight = 3 * hidden * inter + 2 * inter * 4 + hidden * 4
            limit = cs.bound(weight + 2 * rows * hidden * 2, 6 * rows * hidden * inter)
            med = {side: statistics.median(t) for side, t in times.items()}
            medians[f"{model} B={rows}"] = dict(med, bound=limit[0])
            print(f"[E] {model} H={hidden} I={inter} B={rows}: before "
                  f"{' '.join(f'{t:.4f}' for t in times['before'])} ms, after "
                  f"{' '.join(f'{t:.4f}' for t in times['after'])} ms; medians before "
                  f"{med['before']:.4f}, after {med['after']:.4f} ms "
                  f"(after/before {med['after'] / med['before']:.2f}x, bound {limit[0]:.4f} ms, "
                  f"after {limit[0] / med['after']:.1%} of bound)")
        del gateup, down
        torch.cuda.empty_cache()
    print(json.dumps(medians))
    return 0


if __name__ == "__main__":
    sys.exit(main())
