"""What the probe tools share: the 7B MLP stack's shapes, its random
weights made on the device from a seed, the pass's SwiGLU, and the timing of
one step, eager and as a replayed CUDA graph, with the kernel launches it
made."""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import torch

from vis_tpu_torch.ops import int_dot
from vis_tpu_torch.ops import quantized as qz

HIDDEN, INTER, LAYERS, VOCAB = 3584, 18944, 28, 152064
STEPS, REPEATS = 32, 3
SCALE = 0.01  # the probes' uniform int4 scale

# Every wrapper a probe variant can reach, by name.
WRAPPERS = (qz.q4_matmul, qz.q4_matmul_stacked, qz.q4_matmul_folded,
            qz.q4_matmul_stacked_folded, qz.i4_matmul, qz.q4_fused_mlp_slab,
            qz.fused_swiglu_mlp, qz.q8_matmul, int_dot.u8_sum, int_dot.i8_matmul,
            int_dot.q4_i8_matmul, int_dot.q4_i8s_matmul)


@dataclasses.dataclass
class Stack:
    """The probes' int4 MLP stack in their kernel layout: gu_q [L, 2I, H/2]
    and dn_q [L, H, I/2] split-half packed u8, gu_s [L, 2, 2I] and dn_s
    [L, 2, H] f32 (the s_lo row, then the s_hi row)."""

    gu_q: torch.Tensor
    gu_s: torch.Tensor
    dn_q: torch.Tensor
    dn_s: torch.Tensor

    @property
    def nbytes(self) -> int:
        """Packed weight bytes of the stack (the probes' "MLP stack bytes")."""
        return self.gu_q.numel() + self.dn_q.numel()

    def row_scales(self):
        """gu_s and dn_s as [L, O, 2], the layout kernels A and B take (the
        JAX probes transpose them inside their jitted pass; here it is done
        once, outside the timed pass)."""
        return (self.gu_s.transpose(1, 2).contiguous(),
                self.dn_s.transpose(1, 2).contiguous())


def generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen


def int4_stack(gen: torch.Generator, hidden: int, inter: int, layers: int) -> Stack:
    """Random packed bytes and uniform scales, as the JAX probes' make()."""
    device = gen.device
    return Stack(
        gu_q=torch.randint(0, 256, (layers, 2 * inter, hidden // 2), generator=gen,
                           device=device, dtype=torch.uint8),
        gu_s=torch.full((layers, 2, 2 * inter), SCALE, device=device),
        dn_q=torch.randint(0, 256, (layers, hidden, inter // 2), generator=gen,
                           device=device, dtype=torch.uint8),
        dn_s=torch.full((layers, 2, hidden), SCALE, device=device),
    )


def first_input(device, hidden: int) -> torch.Tensor:
    """The probes' x0: ones * 0.01 in bf16, one row."""
    return torch.full((1, hidden), 0.01, dtype=torch.bfloat16, device=device)


def swiglu(gu: torch.Tensor) -> torch.Tensor:
    """(silu(g) * u) in bf16 for the fused gate;up output [B, 2I]."""
    g, u = gu.chunk(2, dim=-1)
    return (g * torch.sigmoid(g) * u).to(torch.bfloat16)


def residual(h: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return (h + d).to(torch.bfloat16)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best(run: Callable[[], None], device: torch.device, steps: int, repeats: int) -> float:
    """Seconds per step: the best of ``repeats`` runs of ``steps`` steps, on
    the host clock up to a synchronize."""
    best = float("inf")
    for _ in range(repeats):
        _sync(device)
        start = time.perf_counter()
        for _ in range(steps):
            run()
        _sync(device)
        best = min(best, (time.perf_counter() - start) / steps)
    return best


def measure(label: str, step: Callable[[], None], device, nbytes: int, steps: int,
            repeats: int, per: str = "pass", unit: int = 1) -> dict:
    """Times ``step`` (one pass, in place on its own buffers) eagerly and,
    on a card, as a CUDA graph of one step replayed; prints ms per ``per``
    and GB/s of ``nbytes`` (each step does ``unit`` of them).  Returns the
    times and the launches each wrapper made meanwhile (a graph's replays
    launch no wrapper, so only the warm-up, capture and eager steps count)."""
    device = torch.device(device)
    before = launch_counts()
    step()  # warm-up; the first call on a card builds the kernels
    _sync(device)
    eager = _best(step, device, steps, repeats) / unit
    graph = None
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(device).wait_stream(side)
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            step()
        captured.replay()
        graph = _best(captured.replay, device, steps, repeats) / unit
        del captured
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def rate(seconds):
        return nbytes / seconds / 1e9

    shown = (f"{graph * 1e3:9.4f} ms/{per} ({rate(graph):6.0f} GB/s) CUDA graph, "
             if graph is not None else f"CUDA graph n/a on {device.type}, ")
    print(f"{label} {shown}{eager * 1e3:9.4f} ms/{per} ({rate(eager):6.0f} GB/s) eager",
          flush=True)
    return {"label": label.strip(), "nbytes": nbytes, "per": per,
            "graph_ms": None if graph is None else graph * 1e3, "eager_ms": eager * 1e3,
            "graph_gbps": None if graph is None else rate(graph), "eager_gbps": rate(eager),
            "launches": launches}


def chain(one_pass: Callable[..., torch.Tensor], x0: torch.Tensor):
    """A step for ``measure``: h <- one_pass(h) on one buffer; with the
    output of the first pass from x0 and of its first layer alone,
    one_pass(x0, 1) (for the checks: from x0 the probes' residual grows
    every layer and overflows within a pass, so only a layer is a value to
    compare)."""
    first = one_pass(x0.clone())
    layer = one_pass(x0.clone(), 1)
    h = x0.clone()

    def step():
        h.copy_(one_pass(h))

    return step, first, layer


def parser(doc: str, variants: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("variants", nargs="?", default=variants,
                    help=f"variant letters to run (default {variants})")
    ap.add_argument("--device", default="cuda:0", help="torch device (cpu is for the tests)")
    return ap


def banner(device, stack_bytes: int) -> None:
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})", flush=True)
    print(f"int4 MLP stack bytes: {stack_bytes / 1e9:.3f} GB", flush=True)
