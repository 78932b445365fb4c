"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py ssm      # phases 1, 2, the state step and the hybrid decode

Phases, in order; any failure raises and the script exits non-zero:

1. card: the GPU's name and power limit, torch and CUDA versions, and
   which host packages the pipeline needs are installed;
2. build: compile the port's CUDA kernels from vis_tpu_torch/csrc (one
   nvcc per source, all at once);
3. kernels: each kernel (A, B, C, D, E) against its plain PyTorch version
   at the shapes the main paths give it, with the tolerance stated, and
   both timed, beside the least time the card could take (bound), its
   share of that bound and one PyTorch call for the same function where
   there is one (scaled_dot_product_attention for C, the int4 and int8
   weight-only matmuls for A, B and D).  A runs every projection of both
   models (Qwen2.5-VL-7B at B = 1 and 8, Llama-3.1-8B at B = 1 and 3), D the int8
   heads and every int8 qkv and o projection (Qwen at B = 1 and 8, Llama at
   B = 1 and 3, Llama-3.2-11B-Vision at B = 1 and 8), E one int8 MLP layer
   at each model's width; B, the int4 head, runs A's kernel on a one-layer
   weight, must equal A on it bit for bit and give exactly 0 on zero-padded
   rows, and B runs every int4 text projection of Llama-3.2-11B-Vision (B =
   1 and 8) and its head (B = 1).  A kernel's time is that of a run of
   launches captured into a CUDA graph (``device_ms``), a plain version's
   that of a run of calls back to back (``stream_ms``).  Then the Mamba2
   state step (``ops/ssm.py``, no TPU counterpart) at the bundle cell's
   shapes (3 rows, 256 heads x 64 x 256, Nemotron-H-47B), against its plain
   version: its ms, the bound at 3.35 TB/s and max|err|; and the hybrid
   stack's two fused norms (``ops/norms.py``) at its decode and prefill
   rows.  Both run before the other kernels, and so does the hybrid
   decoder's main path at Nemotron-H-47B's widths in a 4-block stack
   (``phase_hybrid``): prefill, then one paged scheduler chunk on 3 slots,
   on the card against the CPU, with the chunk's launches of the state
   step and the two norms counted and required;
4. reference: the small Qwen2.5-VL, Llama text and Mllama profiles, int4
   and int8, on the card against the same engines on the CPU (prefill
   logits, a lookahead window, one batched paged decode chunk; the Mllama
   tower's features; one 16-step chunk of each token-a-pass decode loop,
   greedy, sampled and schema-constrained, its first step's logits held);
   Then the window-graph phase: the inspector's lookahead decode at the
   photo cell's size (int4 Qwen2.5-VL-7B, 448-token schema answers), one
   greedy and one sampled request, replayed as a CUDA graph and eager, bit
   for bit equal (tokens, valid masks, cursors, K/V, final logits), with
   as many kernel launches counted both ways (a replay counts what its
   capture recorded); two engines replaying at once from two threads, each
   equal to its request alone; the capture ms, ms a window both ways and
   the graph's pool bytes;
5. int4 slice: vis_tpu_torch.orchestration.graph.run_inspection on
   assets/sample.jpg, three requests, with the Qwen2.5-VL-7B inspector, the
   Llama-3.2-11B-Vision auditor and the Llama-3.1-8B explainer on the port
   (full width and depth, random int4 weights from a fixed seed; the
   explainer's report bundle through the paged continuous-batching
   scheduler).  Before them one auditor request runs alone, and its
   kernel B launches must equal what its decode passes and prefill bucket
   predict.  Kernels A-D must have launched during the three requests,
   every request must show the explainer's three decodes as model text
   from the scheduler (decision support for a fixed defect list when the
   consensus holds none, while the pipeline keeps its "No Action
   Required") and both VLMs' answers with the schema's keys;
6. int8 slice: the same under QUANTIZATION=int8 (int8 layers, vocab tables
   and vision projections; the auditor alone launches D and E as its
   passes predict).  Kernels C, D and E must have launched;
   Then the default-decode phase: the int4 models again with every decode
   setting at the config's default (free-form sampled decode, no lookahead
   window, no scheduler, host preprocess; 128-token budgets): one auditor
   request alone (its B launches must be passes x 161 + the prefill's),
   one run_inspection request, one more under CONSTRAINED_SCHEMA=true with
   the window still 0 (both VLMs must answer with the schema's keys), and
   two turns of a KV-cached explainer chat session.  No role's engine may
   raise, every role must decode tokens, and A-D must launch;
7. probes: the int4 probe tools' kernels (F, G, H, I, J, K, Q) against
   their plain versions at the probes' full shapes (7B MLP stack, int4
   head), with the tolerance stated, timed beside their bound and PyTorch's
   int4 matmul (torch._weight_int4pack_mm) on the same weights; H with one
   slab's gate and up swapped and K with its nibble order flipped must miss
   their tolerance.  The int8 probe's kernels (L, M, N, O, P) at its full
   shapes: L, M, O and P bit-equal to their plain versions, N (kernel D)
   within D's tolerance; O with its x halves swapped, O's reading of P's
   bytes and L's sum without the wrap must miss.  Then the four probe tools
   run every variant over the full 28-layer stack, eagerly and as a
   replayed CUDA graph of one pass, printing ms per pass and GB/s of
   weight; each of F-Q must have launched there, and each variant's first
   layer from x0 must agree with the variants that run its kernel on the
   same bytes (bit for bit) and with the plain versions.

Neither jax nor the JAX package (vis_tpu) can be imported here: the port
stands alone.  The last line of standard output is {"ok": true, "device":
{...}}; the line before it lists each kernel's launches, error, times and
bound.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HOST_PACKAGES = ("pydantic", "PIL", "yaml")
INSTALLED = {name: importlib.util.find_spec(name) is not None for name in HOST_PACKAGES}
# The port imports neither jax nor the JAX package; make sure nothing does.
sys.modules["jax"] = None
sys.modules["vis_tpu"] = None

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
WORK = REPO / "build" / "chip_smoke"
SEED = 1234
REQUESTS = 3
DEVICE = "cuda:0"
SAMPLE = REPO / "assets" / "sample.jpg"

# The serving profile of bench.py (copied: importing bench.py rewrites the
# environment), with all three models on the port.
PROFILE = {
    "TORCH_DEVICE": DEVICE,
    "DEV_PROFILE": "target",
    "QUANTIZATION": "int4",
    "VOCAB_QUANTIZATION": "int4",
    "EXPLAINER_VOCAB_QUANTIZATION": "int8",
    "CONSTRAINED_JSON": "true",
    "VLM_INSPECTOR_PROVIDER": "cuda",
    "VLM_AUDITOR_PROVIDER": "cuda",
    "EXPLAINER_PROVIDER": "cuda",
    "VLM_INSPECTOR_MAX_TOKENS": "448",
    "VLM_INSPECTOR_MIN_TOKENS": "432",
    "VLM_AUDITOR_MAX_TOKENS": "304",
    "VLM_AUDITOR_MIN_TOKENS": "288",
    "EXPLAINER_MAX_TOKENS": "400",
    "USE_MOCK_RESPONSES": "false",
    "CONTINUOUS_BATCHING": "true",
    "BATCHING_ROLES": "explainer",
    "DECODE_BATCH_SIZE": "3",
    "SCHEDULER_DECODE_CHUNK": "48",
    "PAGED_KV_CACHE": "true",
    "KV_PAGE_SIZE": "128",
    "KV_POOL_TOKENS": "4992",
    "SPECULATIVE_DECODING": "none",
    "DECODE_CHUNK": "512",
    "PREFIX_CACHING": "false",
    "KV_CACHE_MAX_TOKENS": "2560",
    "DEVICE_PREPROCESS": "true",
    "CONSTRAINED_JSON_MIN_TOKENS": "384",
    "CONSTRAINED_SCHEMA": "true",
    "CONSTRAINED_LOOKAHEAD": "8",
    "LOG_TO_FILE": "false",
    "DATABASE_PATH": str(WORK / "inspections.db"),
    "CHAT_HISTORY_DB": str(WORK / "chat.db"),
    "UPLOAD_DIR": str(WORK / "uploads"),
    "REPORT_DIR": str(WORK / "reports"),
    "LOG_DIR": str(WORK / "logs"),
}
# The int8 slice: the same profile under QUANTIZATION=int8 with the
# config's own vocab default (VOCAB_QUANTIZATION=same, no per-role
# override): int8 layers, vocab tables and vision projections.
INT8_PROFILE = {**PROFILE, "QUANTIZATION": "int8", "VOCAB_QUANTIZATION": "same",
                "INSPECTOR_VOCAB_QUANTIZATION": "", "AUDITOR_VOCAB_QUANTIZATION": "",
                "EXPLAINER_VOCAB_QUANTIZATION": ""}

# 7B decoder projections, [out, in], and the padded int4 vocab head.
PROJECTIONS = {
    "qkv": (4608, 3584),
    "o": (3584, 3584),
    "gate_up": (37888, 3584),
    "down": (3584, 18944),
}
LAYERS = 28
HEAD = (152064, 3584)
# Llama-3.1-8B decoder projections, [out, in], which kernel A runs at the
# explainer scheduler's B = 3 and at B = 1 when the explainer decodes alone.
LLAMA_PROJECTIONS = {
    "qkv": (6144, 4096),
    "o": (4096, 4096),
    "gate_up": (28672, 4096),
    "down": (4096, 14336),
}
# Llama-3.2-11B-Vision's text projections, [out, in]: every self layer's
# qkv, o, gate_up and down (Llama-3.1-8B's shapes; a cross layer's q is
# o's), which kernel B runs in the auditor's lookahead windows (B = 8)
# and its int4 head (128256 rows padded to 128512) at B = 1.  B_WALK
# separate weights are walked (more than the 50 MB L2 holds).
MLLAMA_PROJECTIONS = LLAMA_PROJECTIONS
MLLAMA_HEAD = (128512, 4096)
B_WALK = 8
# The auditor's decode tokens (VLM_AUDITOR_MIN_TOKENS, _MAX_TOKENS).
AUDITOR_TOKENS = (288, 304)
FLASH = dict(b=1, s=4096, h=16, d=80, length=3996)
# The explainer's int8 vocab head: Llama-3.1-8B's 128256 rows padded to 128512.
HEAD8 = (128512, 128256, 4096)
# Layers of the int8 qkv and o stacks D's timing walks (more than the 50 MB
# L2 holds).
D_WALK = 8
# Kernel E's shapes: (hidden, inter, stacked layers, batch rows); Qwen's
# decode windows run 8 rows, Llama's scheduler 3 slots.
MLP8 = {"qwen": (3584, 18944, 28, (1, 8)), "llama": (4096, 14336, 8, (1, 3)),
        "mllama": (4096, 14336, 8, (8,))}
# The int4 probe tools: the 7B MLP stack (hidden, inter), the int4 head's
# rows and their paddings, the fused MLP's slab rows, and the passes per timed
# run and timed runs of each probe variant.
PROBE_MLP = (3584, 18944)
PROBE_HEAD, HEAD_BLOCKS, INTER_BLOCK = 152064, (512, 1024, 2048), 1184
PROBE_STEPS, PROBE_REPEATS = 8, 2
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s, bf16 FLOP/s and
# int8 OP/s.
PEAK_BYTES, PEAK_FLOPS, PEAK_INT8_OPS = 3.35e12, 989e12, 1979e12


def bound(nbytes: float, flops: float, peak: float = PEAK_FLOPS) -> tuple:
    """The least time (ms) the card could take for this work, and what
    bounds it: the bytes over HBM's rate or the operations over ``peak``
    (bf16's unless the operations are on integers)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, calls: int, replays: int = 5) -> float:
    """Device time of one fn(i), in ms: fn(0) .. fn(calls - 1) captured into
    one CUDA graph, replayed ``replays`` times between CUDA events, the
    median replay over ``calls``.  The wrappers' host time stays out of what
    is timed, and i lets fn walk a stack so that each launch reads its
    weight from device memory."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def stream_ms(fn, calls: int, warmup: int = 2) -> float:
    """Time of one fn(i), in ms, for the plain versions: ``calls`` calls
    back to back between one pair of CUDA events, over ``calls`` (each is
    many kernels of device work, which hides the host's launches)."""
    import torch

    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def phase_card() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no GPU, no result")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    print("host packages: " + ", ".join(
        f"{name}={'yes' if ok else 'no'}" for name, ok in INSTALLED.items()))
    return smi


def phase_build() -> None:
    from vis_tpu_torch.ops import _kernels

    start = time.perf_counter()
    _kernels.library()
    built = _kernels.build_seconds
    print(f"[build] {time.perf_counter() - start:.2f} s "
          f"({'nvcc ' + format(built, '.2f') + ' s' if built else 'cached library'}) "
          f"-> {_kernels.library_path().relative_to(REPO)}")


def phase_kernels() -> dict:
    """Each kernel against its plain version on the same inputs."""
    import torch

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return {"A": _kernel_a(gen, dev), "B": _kernel_b(gen, dev), "C": _kernel_c(gen, dev),
            "D": _kernel_d(gen, dev), "E": _kernel_e(gen, dev)}


# The Mamba2 state step at Nemotron-H-47B's sizes: rows (the bundle cell's
# slots), heads, head dim, state size, groups; LAYERS_SSM layers' states
# are walked (each 100.7 MB at three rows, more than the 50 MB L2 holds).
SSM_SHAPE = dict(rows=3, heads=256, head_dim=64, state=256, groups=8)
LAYERS_SSM = 4


def phase_ssm_step() -> dict:
    """The Mamba2 state step (``ops/ssm.py``) against its plain version at
    the bundle cell's shapes, on cursors that start a ring (0, 1) and wrap
    it (1,234): y and the state within 2^-14 of max|ref| (only the
    readout's sum order and the exp/log1p roundings differ), the conv ring
    bit for bit.  Times the kernel over LAYERS_SSM layers' states beside
    its bound (the state read and written once, the ring, the inputs and
    y, at 3.35 TB/s) and the plain version."""
    import torch

    from vis_tpu_torch.ops.ssm import ssm_step, ssm_step_plain

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows, heads, p, n, groups = (SSM_SHAPE[k] for k in ("rows", "heads", "head_dim", "state",
                                                         "groups"))
    d_inner = heads * p
    conv_dim = d_inner + 2 * groups * n

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    zxbcdt = randn(rows, d_inner + conv_dim + heads, dtype=torch.bfloat16)
    conv_w = randn(conv_dim, 4, scale=0.5, dtype=torch.bfloat16)
    conv_b = randn(conv_dim, scale=0.02, dtype=torch.bfloat16)
    u = torch.rand((heads,), generator=gen, device=dev)
    a_log = torch.log(1.0 + 15.0 * u)
    dt = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand((heads,), generator=gen,
                                                                  device=dev))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    d_skip = 1.0 + randn(heads, scale=0.1)
    rings = randn(LAYERS_SSM, rows, conv_dim, 4, dtype=torch.bfloat16)
    states = randn(LAYERS_SSM, rows, heads, p, n, scale=0.1)
    cursor = torch.tensor([0, 1, 1234], dtype=torch.int32, device=dev)[:rows]
    args = (conv_w, conv_b, dt_bias, a_log, d_skip)

    ring_k, state_k = rings[0].clone(), states[0].clone()
    ring_p, state_p = rings[0].clone(), states[0].clone()
    before = ssm_step.launches
    got = ssm_step(zxbcdt, ring_k, cursor, *args, state_k, groups)
    want = ssm_step_plain(zxbcdt, ring_p, cursor, *args, state_p, groups)
    torch.cuda.synchronize()
    err = max((got - want).abs().max().item(), (state_k - state_p).abs().max().item())
    tol = 2.0 ** -14 * max(want.abs().max().item(), state_p.abs().max().item())
    ring_same = bool(torch.equal(ring_k, ring_p))
    print(f"[S] ssm step rows={rows} H={heads} P={p} N={n} G={groups}: max|err| {err:.3e} "
          f"<= tol {tol:.3e}; conv ring bit-equal {ring_same}; launches "
          f"{ssm_step.launches - before}")
    if not (err <= tol and ring_same and ssm_step.launches - before == 1):
        raise AssertionError(f"ssm step: err {err} > {tol}, ring equal {ring_same}")
    ms = device_ms(lambda i: ssm_step(zxbcdt, rings[i % LAYERS_SSM], cursor, *args,
                                      states[i % LAYERS_SSM], groups), 4 * LAYERS_SSM)
    plain = stream_ms(lambda i: ssm_step_plain(zxbcdt, rings[i % LAYERS_SSM], cursor, *args,
                                               states[i % LAYERS_SSM], groups), 8)
    nbytes = (rows * (2 * heads * p * n * 4 + 3 * conv_dim * 2 + conv_dim * 2
                      + (conv_dim + heads) * 2 + d_inner * 4)
              + conv_dim * 5 * 2 + 3 * heads * 4)
    limit = bound(nbytes, rows * heads * p * n * 5.0)
    print(f"[S] ssm step: kernel {ms:.4f} ms ({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s), plain "
          f"{plain:.4f} ms, bound {limit[0]:.4f} ms ({limit[1]}), {limit[0] / ms:.1%} of it")
    _hybrid_norms(gen, dev, zxbcdt.shape[1], d_inner, groups)
    return dict(err=err, ms=ms, plain_ms=plain, bound=limit, library_ms=None)


def _hybrid_norms(gen, dev, in_proj: int, d_inner: int, groups: int,
                  hidden: int = 8192) -> None:
    """The fused add + RMSNorm and the grouped gated norm (``ops/norms.py``)
    against their plain versions at Nemotron-H-47B's widths, 3 rows (decode)
    and 2,112 (a prefill bucket): x + delta bit for bit, the norms within
    2^-7 of max|ref| (the sum of squares is a tree on the card, so an output
    can move by one bf16 step), one launch each; the decode rows timed."""
    import torch

    from vis_tpu_torch.ops import norms

    for rows in (3, 2112):
        x = torch.randn((rows, hidden), generator=gen, device=dev).to(torch.bfloat16)
        delta = torch.randn((rows, hidden), generator=gen, device=dev).to(torch.bfloat16)
        w = (1.0 + 0.1 * torch.randn((hidden,), generator=gen, device=dev)).to(torch.bfloat16)
        zxbcdt = torch.randn((rows, in_proj), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.randn((rows, d_inner), generator=gen, device=dev)
        gw = (1.0 + 0.1 * torch.randn((d_inner,), generator=gen, device=dev)).to(torch.bfloat16)
        before = (norms.add_rms_norm.launches, norms.gated_group_norm.launches)
        for d in (delta, None):
            (xo, h), (xp, hp) = (norms.add_rms_norm(x, d, w, 1e-5),
                                 norms.add_rms_norm_plain(x, d, w, 1e-5))
            err = (h.float() - hp.float()).abs().max().item()
            same = bool(torch.equal(xo, xp))
            print(f"[S] add_rms_norm rows={rows} delta={d is not None}: x + delta bit-equal "
                  f"{same}; max|err| {err:.3e} <= {2 ** -7 * hp.float().abs().max().item():.3e}")
            if not (same and err <= 2 ** -7 * hp.float().abs().max().item()):
                raise AssertionError(f"add_rms_norm rows={rows}: x equal {same}, err {err}")
        z = zxbcdt[:, :d_inner]
        got = norms.gated_group_norm(y, z, gw, groups, 1e-5)
        want = norms.gated_group_norm_plain(y, z, gw, groups, 1e-5)
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -7 * want.float().abs().max().item()
        print(f"[S] gated_group_norm rows={rows}: max|err| {err:.3e} <= {tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"gated_group_norm rows={rows}: err {err} > {tol}")
        if (norms.add_rms_norm.launches - before[0], norms.gated_group_norm.launches
                - before[1]) != (2, 1):
            raise AssertionError("the fused norms did not launch once a call")
        if rows == 3:
            add_ms = device_ms(lambda i: norms.add_rms_norm(x, delta, w, 1e-5), 64)
            gated_ms = device_ms(lambda i: norms.gated_group_norm(y, z, gw, groups, 1e-5), 64)
            print(f"[S] rows=3: add_rms_norm {add_ms:.4f} ms, gated_group_norm {gated_ms:.4f} ms")


# The hybrid decode phase: Nemotron-H-47B's widths (the bundle cell's
# configuration file) in a short stack that still holds the three kinds of
# block, two of them Mamba2; a 4,096-token vocabulary keeps the CPU side's
# head small (no kernel of the phase changes with it).
HYBRID_PATTERN, HYBRID_VOCAB, HYBRID_STEPS = "M*M-", 4096, 8
HYBRID_PROMPTS = ("Estimate repair costs for a cracked weld seam.",
                  "Estimate repair costs for two dents on the housing.",
                  "Estimate repair costs for corrosion, a crack and a missing bolt.")


def phase_hybrid() -> dict:
    """The hybrid decoder's main path on the card against the same engine
    on the CPU, same weights (the benchmark's seeded Nemotron-H weights at
    ``HYBRID_PATTERN``): three prompts prefilled (the chunked scan, the
    fused add + RMSNorm at bucket rows), handed to a 3-slot paged scheduler
    and decoded in one chunk of ``HYBRID_STEPS`` steps under the
    decision_support schema, whose first 19 tokens are forced, so both
    sides feed the same tokens.  Prefill and the chunk's last logits are
    held to 2^-5 * max|ref|, the tokens must be equal, and with the
    launch counters read just before the chunk, the card's chunk must
    launch the state step and the gated norm once a Mamba2 block a step
    and the add + RMSNorm once a block a step and once more for the final
    norm."""
    import torch

    from bench_torch.families import family_of
    from bench_torch.harness.engines import _program_leaves
    from bench_torch.harness.weights import make_weights
    from vis_tpu_torch.ops import norms
    from vis_tpu_torch.ops.ssm import ssm_step
    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
    from vis_tpu_torch.serving.schema import schema_constraint_tables
    from vis_tpu_torch.serving.tokenizer import ByteTokenizer

    model = json.loads((REPO / "bench_torch" / "configs" / "nemotron_h_47b.json")
                       .read_text())["model"]
    model = {**model, "hybrid_override_pattern": HYBRID_PATTERN,
             "num_hidden_layers": len(HYBRID_PATTERN), "vocab_size": HYBRID_VOCAB}
    config = family_of(model).program_config(model)
    blocks, mamba = len(HYBRID_PATTERN), HYBRID_PATTERN.count("M")
    params = _program_leaves(make_weights(model, SEED, DEVICE))
    tokenizer = ByteTokenizer(vocab_size=HYBRID_VOCAB)
    tables = {"decision_support": schema_constraint_tables(tokenizer, HYBRID_VOCAB,
                                                           "decision_support")}
    settings = E.ServingSettings(max_cache_tokens=1024, prefill_buckets=(128,))
    out = {}
    for label, device in (("kernel", DEVICE), ("plain", "cpu")):
        side = E.Engine("hybrid", config, params if label == "kernel"
                        else _to_device(params, device), tokenizer, device, settings)
        side.scheduler = ContinuousBatchingScheduler(
            config, side.params["text"], tokenizer, side.device, num_slots=3, max_len=1024,
            json_tables=tables, page_size=128, pool_tokens=3072, decode_chunk=HYBRID_STEPS)
        prefill, requests = [], []
        for prompt in HYBRID_PROMPTS:
            cache, logits, pos, kv_len, _ = side._prefill_request(
                prompt, None, max_tokens=200, max_image_dim=0, prompt_only_cache=True)
            prefill.append(logits)
            requests.append(side.scheduler.submit_prefilled(
                cache, logits, pos, max_tokens=200, kv_len=kv_len, json_mode=True,
                schema="decision_support"))
        while side.scheduler._admit_one():
            pass
        if label == "kernel":
            torch.cuda.synchronize()
        before = (ssm_step.launches, norms.add_rms_norm.launches,
                  norms.gated_group_norm.launches, side.scheduler.stats["steps"])
        side.scheduler._decode_once()
        after = (ssm_step.launches, norms.add_rms_norm.launches,
                 norms.gated_group_norm.launches, side.scheduler.stats["steps"])
        out[label] = {"prefill": torch.cat(prefill).float().cpu(),
                      "chunk": side.scheduler._logits.float().cpu(),
                      "tokens": [r.generated for r in requests],
                      "counts": [a - b for a, b in zip(after, before)]}
        side.scheduler = None
        del side
    ssm_n, add_n, gated_n, steps = out["kernel"]["counts"]
    want = (mamba * steps, (blocks + 1) * steps, mamba * steps)
    print(f"[hybrid] {config.describe()}: one chunk of {steps} steps on 3 slots launched "
          f"ssm_step {ssm_n}, add_rms_norm {add_n}, gated_group_norm {gated_n} (want "
          f"{want[0]}, {want[1]}, {want[2]}); the CPU's {out['plain']['counts'][:3]}")
    if steps != HYBRID_STEPS or (ssm_n, add_n, gated_n) != want:
        raise AssertionError(f"hybrid chunk launches {(ssm_n, add_n, gated_n)} != {want} "
                             f"over {steps} steps")
    if out["kernel"]["tokens"] != out["plain"]["tokens"]:
        raise AssertionError(f"hybrid chunk tokens differ: {out['kernel']['tokens']} != "
                             f"{out['plain']['tokens']}")
    print(f"[hybrid] chunk tokens equal: {out['plain']['tokens']}")
    worst = max(_hold("hybrid", name, out["plain"][name], out["kernel"][name])
                for name in ("prefill", "chunk"))
    return {"worst_err_over_tol": worst, "steps": steps, "ssm_step": ssm_n,
            "add_rms_norm": add_n, "gated_group_norm": gated_n}


def _kernel_a(gen, dev) -> dict:
    """A at every projection of both models: Qwen2.5-VL-7B at B = 1 and 8
    (the inspector's token steps and lookahead windows), Llama-3.1-8B at
    B = 1 (the explainer's unscheduled steps) and 3 (the scheduler's
    slots), each held to its plain version at layers 0 and 27
    (max|err| <= 1e-3 * max|y|: only the order of the f32 sums differs).
    Timing walks the 28 layers so each launch reads its weight from device
    memory, as a decode window does.  Beside the kernel: its plain version,
    its bound and torch._weight_int4pack_mm on the same weights."""
    import torch

    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.serving.engine import random_q4

    worst, table = 0.0, {}
    for model, projections, batches in (("qwen", PROJECTIONS, (1, 8)),
                                        ("llama", LLAMA_PROJECTIONS, (1, 3))):
        for name, (out, inn) in projections.items():
            w = random_q4(gen, LAYERS, out=out, inn=inn, device=dev)
            q, scale = w.q, w.scale
            for rows in batches:
                x = torch.randn((rows, inn), generator=gen, device=dev).to(torch.bfloat16)
                for idx in (0, LAYERS - 1):
                    got = qz.q4_matmul_stacked(x, qz.QuantizedWeight4Pick(q, scale, idx))
                    want = qz.q4_matmul_plain(x, q[idx], scale[idx])
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    tol = 1e-3 * want.abs().max().item()
                    print(f"[A] {model} {name:8s} [{out}, {inn}] B={rows} idx={idx:2d}: "
                          f"max|err| {err:.3e} <= tol {tol:.3e}")
                    if not err <= tol:
                        raise AssertionError(f"kernel A {model} {name} B={rows} idx={idx}: "
                                             f"{err} > {tol}")
                    worst = max(worst, err)
                ms = device_ms(lambda i: qz.q4_matmul_stacked(
                    x, qz.QuantizedWeight4Pick(q, scale, i % LAYERS)), 56)
                plain = stream_ms(lambda i: qz.q4_matmul_plain(
                    x, q[i % LAYERS], scale[i % LAYERS]), 28)
                library = _library_int4(f"{model} {name} B={rows}", x, [
                    (_split_values(q[i]), scale[i][:, 0], scale[i][:, 1]) for i in range(3)],
                    calls=56, tag="A")
                weight = q[0].numel() + scale[0].numel() * 4
                limit = bound(weight + rows * inn * 2 + rows * out * 4, 2 * rows * out * inn)
                table[(model, name, rows)] = (ms, plain, limit, library)
                print(f"[A] {model} {name:8s} [{out}, {inn}] B={rows}: kernel {ms:.4f} ms "
                      f"({weight / (ms * 1e-3) / 1e9:.0f} GB/s of weight, {limit[0] / ms:.1%} of "
                      f"bound {limit[0]:.4f} ms ({limit[1]})), plain {plain:.4f} ms, library "
                      f"{library:.4f} ms (kernel/library {ms / library:.2f}x)")
            del w, q, scale
            torch.cuda.empty_cache()
    ms, plain, limit, library = table[("qwen", "gate_up", 8)]
    return dict(err=worst, ms=ms, plain_ms=plain, bound=limit, library_ms=library, table=table)


def _kernel_b(gen, dev) -> dict:
    """B: the int4 vocab head, B = 1, beside PyTorch's int4 matmul on the
    same weights (``_library_int4``).  Its last 64 rows are zeroed as a
    padded vocab's are (q 0, scale 0) and must give exactly 0; B runs A's
    kernel, so it must equal A on the head as a one-layer stack bit for bit."""
    import torch

    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.serving.engine import random_q4

    w = random_q4(gen, out=HEAD[0], inn=HEAD[1], device=dev)
    q, scale = w.q, w.scale
    q[-64:], scale[-64:] = 0, 0.0
    x = torch.randn((1, HEAD[1]), generator=gen, device=dev).to(torch.bfloat16)
    got = qz.q4_matmul(x, q, scale)
    want = qz.q4_matmul_plain(x, q, scale)
    as_a = qz.q4_matmul_stacked(x, qz.QuantizedWeight4Pick(q[None], scale[None], 0))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-3 * want.abs().max().item()
    padded = got[:, -64:].abs().max().item()
    print(f"[B] head {list(HEAD)} B=1: max|err| {err:.3e} <= tol {tol:.3e}; padded rows "
          f"max|y| {padded} == 0; equal to A on a one-layer stack: {torch.equal(got, as_a)}")
    if not (err <= tol and padded == 0.0 and torch.equal(got, as_a)):
        raise AssertionError(f"kernel B: {err} > {tol}, padded rows {padded}, or not A's bits")
    ms = device_ms(lambda i: qz.q4_matmul(x, q, scale), 30)
    plain = stream_ms(lambda i: qz.q4_matmul_plain(x, q, scale), 10)
    gbps = (q.numel() + scale.numel() * 4) / (ms * 1e-3) / 1e9
    limit = bound(q.numel() + scale.numel() * 4 + HEAD[1] * 2 + HEAD[0] * 4,
                  2 * HEAD[0] * HEAD[1])
    print(f"[B] head B=1: kernel {ms:.4f} ms ({gbps:.0f} GB/s of weight), plain {plain:.4f} ms, "
          f"bound {limit[0]:.4f} ms ({limit[1]})")
    library = _library_int4("head B=1", x, [(_split_values(q), scale[:, 0], scale[:, 1])],
                            tag="B")
    del w, q, scale
    torch.cuda.empty_cache()
    err = max(err, _kernel_b_mllama(gen, dev))
    return dict(err=err, ms=ms, plain_ms=plain, bound=limit, library_ms=library)


def _kernel_b_mllama(gen, dev) -> float:
    """B at the auditor's shapes: every int4 text projection of
    Llama-3.2-11B-Vision at B = 1 and 8, each held to its plain version
    (1e-3 * max|y|) and timed walking B_WALK separate weights, beside its
    bound and torch._weight_int4pack_mm on the same weights; then its head
    at B = 1 with the last 256 rows zeroed (exactly 0 out).  Returns the
    worst error."""
    import torch

    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.serving.engine import random_q4

    worst = 0.0
    for name, (out, inn) in MLLAMA_PROJECTIONS.items():
        w = random_q4(gen, B_WALK, out=out, inn=inn, device=dev)
        for rows in (1, 8):
            x = torch.randn((rows, inn), generator=gen, device=dev).to(torch.bfloat16)
            got = qz.q4_matmul(x, w.q[0], w.scale[0])
            want = qz.q4_matmul_plain(x, w.q[0], w.scale[0])
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 1e-3 * want.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"kernel B mllama {name} B={rows}: {err} > {tol}")
            worst = max(worst, err)
            ms = device_ms(lambda i: qz.q4_matmul(x, w.q[i % B_WALK], w.scale[i % B_WALK]),
                           2 * B_WALK)
            plain = stream_ms(lambda i: qz.q4_matmul_plain(
                x, w.q[i % B_WALK], w.scale[i % B_WALK]), B_WALK)
            weight = w.q[0].numel() + w.scale[0].numel() * 4
            limit = bound(weight + rows * inn * 2 + rows * out * 4, 2 * rows * out * inn)
            library = _library_int4(f"mllama {name} B={rows}", x, [
                (_split_values(w.q[i]), w.scale[i][:, 0], w.scale[i][:, 1]) for i in range(3)],
                calls=2 * B_WALK, tag="B")
            print(f"[B] mllama {name:8s} [{out}, {inn}] B={rows}: max|err| {err:.3e} <= tol "
                  f"{tol:.3e}; kernel {ms:.4f} ms ({weight / (ms * 1e-3) / 1e9:.0f} GB/s of "
                  f"weight, {limit[0] / ms:.1%} of bound {limit[0]:.4f} ms ({limit[1]})), plain "
                  f"{plain:.4f} ms, library {library:.4f} ms (kernel/library "
                  f"{ms / library:.2f}x)")
        del w
        torch.cuda.empty_cache()
    rows_out, inn = MLLAMA_HEAD
    w = random_q4(gen, out=rows_out, inn=inn, device=dev)
    w.q[-256:], w.scale[-256:] = 0, 0.0
    x = torch.randn((1, inn), generator=gen, device=dev).to(torch.bfloat16)
    got = qz.q4_matmul(x, w.q, w.scale)
    want = qz.q4_matmul_plain(x, w.q, w.scale)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-3 * want.abs().max().item()
    padded = got[:, -256:].abs().max().item()
    if not (err <= tol and padded == 0.0):
        raise AssertionError(f"kernel B mllama head: {err} > {tol} or padded rows {padded}")
    ms = device_ms(lambda i: qz.q4_matmul(x, w.q, w.scale), 30)
    plain = stream_ms(lambda i: qz.q4_matmul_plain(x, w.q, w.scale), 10)
    weight = w.q.numel() + w.scale.numel() * 4
    limit = bound(weight + inn * 2 + rows_out * 4, 2 * rows_out * inn)
    library = _library_int4("mllama head B=1", x, [(_split_values(w.q), w.scale[:, 0],
                                                    w.scale[:, 1])], tag="B")
    print(f"[B] mllama head [{rows_out}, {inn}] B=1: max|err| {err:.3e} <= tol {tol:.3e}; "
          f"padded rows max|y| {padded} == 0; kernel {ms:.4f} ms ({weight / (ms * 1e-3) / 1e9:.0f} "
          f"GB/s of weight, {limit[0] / ms:.1%} of bound {limit[0]:.4f} ms ({limit[1]})), plain "
          f"{plain:.4f} ms, library {library:.4f} ms (kernel/library {ms / library:.2f}x)")
    del w
    torch.cuda.empty_cache()
    return max(worst, err)


def _kernel_c(gen, dev) -> dict:
    """C: the vision tower's full-attention shape, non-causal, then causal.
    Every query row is compared (the rows past the length attend the valid
    keys too) and held to max|err| <= 2e-2 and, as bf16 rounds each output
    to a share of its own size, each (query, head) row to max|err| <= 2^-6 *
    max|ref| over that row.  The row bound is what sees a broken mask where
    outputs are small: each case runs the kernel with a mask dropped (the
    lengths, and in the causal case the diagonal) and requires it to miss
    the masked reference by more.  Beside the kernel: its plain version, its
    bound, its rate on the valid keys, and PyTorch's
    scaled_dot_product_attention on the same inputs and key mask."""
    import torch

    from vis_tpu_torch.ops import flash_attention as fa

    b, s, h, d, n = (FLASH[k] for k in ("b", "s", "h", "d", "length"))
    tol_c = 2.0 ** -6
    worst, times = 0.0, {}
    for causal in (False, True):
        qkv = [torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3)]
        lengths = torch.tensor([n], dtype=torch.int32, device=dev)
        got = fa.flash_attention(*qkv, lengths, causal=causal)
        want = fa.flash_attention_reference(*qkv, lengths, causal=causal)
        err = (got.float() - want.float()).abs().max().item()
        rel = fa.row_relative_error(got, want)
        print(f"[C] b={b} s={s} h={h} d={d} lengths=[{n}] causal={causal}: max|err| "
              f"{err:.3e} <= tol 2.0e-02; worst row max|err|/max|ref| {rel:.3e} <= tol "
              f"{tol_c:.3e}")
        if not (err <= 2e-2 and rel <= tol_c):
            raise AssertionError(f"kernel C causal={causal}: max|err| {err}, row error {rel}")
        dropped = {"lengths": fa.flash_attention(*qkv, None, causal=causal)}
        if causal:
            dropped["causal"] = fa.flash_attention(*qkv, lengths, causal=False)
        for mask, broken in dropped.items():
            miss = fa.row_relative_error(broken, want)
            print(f"[C] causal={causal}, {mask} mask dropped: worst row "
                  f"max|err|/max|ref| {miss:.3e} > tol {tol_c:.3e}")
            if not miss > tol_c:
                raise AssertionError(f"kernel C check misses a dropped {mask} mask: "
                                     f"{miss} <= {tol_c}")
        del dropped
        worst = max(worst, err)
        ms = device_ms(lambda i: fa.flash_attention(*qkv, lengths, causal=causal), 20)
        plain = stream_ms(lambda i: fa.flash_attention_reference(
            *qkv, lengths, causal=causal), 10)
        # Operations on the valid keys: every query row attends the n
        # valid keys (the causal case about half of them).
        flops = 4 * s * n * d * h * b * (0.5 if causal else 1.0)
        limit = bound(4 * b * s * h * d * 2 + 4, flops)
        print(f"[C] causal={causal}: kernel {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} "
              f"TFLOP/s on valid keys, {limit[0] / ms:.1%} of bound {limit[0]:.4f} ms "
              f"({limit[1]})), plain {plain:.4f} ms")
        times[causal] = (ms, plain, limit)
    # The yardstick, timed here only: PyTorch's fused attention on the same
    # inputs and key mask (non-causal), in [b, h, s, d].
    q_t, k_t, v_t = (a.transpose(1, 2) for a in qkv)
    keep = (torch.arange(s, device=dev) < n)[None, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = (sdpa(q_t, k_t, v_t, attn_mask=keep).transpose(1, 2).float()
               - fa.flash_attention_reference(*qkv, lengths, causal=False).float()
               ).abs().max().item()
    library = device_ms(lambda i: sdpa(q_t, k_t, v_t, attn_mask=keep), 20)
    ms, plain, limit = times[False]
    print(f"[C] library scaled_dot_product_attention (non-causal, key mask): {library:.4f} ms "
          f"(max|err| vs plain {lib_err:.3e}); kernel/library {ms / library:.2f}x")
    return dict(err=worst, ms=ms, plain_ms=plain, bound=limit, library_ms=library)


def _kernel_d(gen, dev) -> dict:
    """D: the int8 vocab head at B = 1 (end of prefill), B = 3 (batched
    decode) and B = 8 (a lookahead window).  Only the order of the f32 sums
    differs from the plain version: max|err| <= 1e-3 * max|y|, and the 256
    zero-padded rows must come out exactly 0."""
    import torch

    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.serving.engine import random_q8

    rows, vocab, inn = HEAD8
    w = random_q8(gen, rows, vocab, inn, device=dev)
    worst, times, xs = 0.0, {}, {}
    for batch in (1, 3, 8):
        x = xs[batch] = torch.randn((batch, inn), generator=gen, device=dev).to(torch.bfloat16)
        got = qz.q8_matmul(x, w.q, w.scale)
        want = qz.q8_matmul_plain(x, w.q, w.scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 1e-3 * want.abs().max().item()
        pad = got[:, vocab:].abs().max().item()
        print(f"[D] head [{rows}, {inn}] B={batch}: max|err| {err:.3e} <= tol {tol:.3e}; "
              f"padded rows max|y| {pad} == 0")
        if not (err <= tol and pad == 0.0):
            raise AssertionError(f"kernel D B={batch}: err {err} > {tol} or padded {pad}")
        worst = max(worst, err)
        ms = device_ms(lambda i: qz.q8_matmul(x, w.q, w.scale), 30)
        plain = stream_ms(lambda i: qz.q8_matmul_plain(x, w.q, w.scale), 10)
        gbps = (w.q.numel() + w.scale.numel() * 4) / (ms * 1e-3) / 1e9
        print(f"[D] head B={batch}: kernel {ms:.4f} ms ({gbps:.0f} GB/s of weight), "
              f"plain {plain:.4f} ms")
        times[batch] = (ms, plain)
    for batch in (1, 8):
        head_bound = bound(w.q.numel() + w.scale.numel() * 4 + batch * inn * 2
                           + batch * rows * 4, 2 * batch * rows * inn)
        print(f"[D] head B={batch} bound {head_bound[0]:.4f} ms ({head_bound[1]}), "
              f"{head_bound[0] / times[batch][0]:.1%} of it")
    limit = bound(w.q.numel() + w.scale.numel() * 4 + 3 * inn * 2 + 3 * rows * 4,
                  2 * 3 * rows * inn)
    print(f"[D] head B=3 bound {limit[0]:.4f} ms ({limit[1]})")
    library = _library_int8("head B=3", xs[3], [(w.q, w.scale)], tag="D")
    del w
    torch.cuda.empty_cache()
    worst = max(worst, _kernel_d_projections(gen, dev))
    return dict(err=worst, ms=times[3][0], plain_ms=times[3][1], bound=limit,
                library_ms=library)


def _kernel_d_projections(gen, dev) -> float:
    """D at every int8 decoder projection of the main path, where most of its
    launches go: qkv and o of Qwen2.5-VL-7B at B = 1 and 8, of Llama-3.1-8B
    at B = 1 and 3 and of Llama-3.2-11B-Vision at B = 1 and 8, each held to its plain version (1e-3 *
    max|y|) and timed walking a stack of D_WALK layers, so that each launch
    reads its weight from device memory as a decode does, beside its bound
    and torch._weight_int8pack_mm on the same weights.  Returns the worst
    error."""
    import torch

    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.serving.engine import random_q8_stack

    worst = 0.0
    for model, projections, batches in (("qwen", PROJECTIONS, (1, 8)),
                                        ("llama", LLAMA_PROJECTIONS, (1, 3)),
                                        ("mllama", MLLAMA_PROJECTIONS, (1, 8))):
        for name in ("qkv", "o"):
            out, inn = projections[name]
            w = random_q8_stack(gen, D_WALK, out=out, inn=inn, device=dev)
            for rows in batches:
                x = torch.randn((rows, inn), generator=gen, device=dev).to(torch.bfloat16)
                got = qz.q8_matmul(x, w.q[0], w.scale[0])
                want = qz.q8_matmul_plain(x, w.q[0], w.scale[0])
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = 1e-3 * want.abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"kernel D {model} {name} B={rows}: {err} > {tol}")
                worst = max(worst, err)
                ms = device_ms(lambda i: qz.q8_matmul(x, w.q[i % D_WALK], w.scale[i % D_WALK]),
                               2 * D_WALK)
                plain = stream_ms(lambda i: qz.q8_matmul_plain(
                    x, w.q[i % D_WALK], w.scale[i % D_WALK]), D_WALK)
                weight = out * inn + out * 4
                limit = bound(weight + rows * inn * 2 + rows * out * 4, 2 * rows * out * inn)
                library = _library_int8(f"{model} {name} B={rows}", x, [
                    (w.q[i], w.scale[i]) for i in range(D_WALK)], calls=2 * D_WALK, tag="D")
                print(f"[D] {model} {name:3s} [{out}, {inn}] B={rows}: max|err| {err:.3e} <= tol "
                      f"{tol:.3e}; kernel {ms:.4f} ms ({weight / (ms * 1e-3) / 1e9:.0f} GB/s of "
                      f"weight, {limit[0] / ms:.1%} of bound {limit[0]:.4f} ms ({limit[1]})), "
                      f"plain {plain:.4f} ms, library "
                      + ("none" if library is None else f"{library:.4f} ms "
                         f"(kernel/library {ms / library:.2f}x)"))
            del w
            torch.cuda.empty_cache()
    return worst


def _kernel_e(gen, dev) -> dict:
    """E, the fused int8 SwiGLU MLP, at the Qwen shape (28 stacked layers,
    layers 0 and 27, B = 1 and 8) and the Llama shape (8 stacked layers,
    B = 1 and 3).  The output is bf16 and h is rounded to bf16 inside, so
    a sum taken in another order can move an element of h, or of y, by one
    bf16 step: max|err| <= 2^-7 * max|y|.  The same kernel with gate and
    up swapped must miss by more, which shows the bound catches a wrong
    kernel, and a second run must give the same bits (no atomics).  Timing
    walks the stack, so each launch reads its weights from device memory, as
    a decode step does."""
    import torch

    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.serving.engine import random_q8_stack

    tol_e = 2.0 ** -7
    table, worst = {}, 0.0
    for model, (hidden, inter, layers, batches) in MLP8.items():
        gateup = random_q8_stack(gen, layers, out=2 * inter, inn=hidden, device=dev)
        down = random_q8_stack(gen, layers, out=hidden, inn=inter, device=dev)

        def pick(i):
            i %= layers
            return (qz.QuantizedWeight(gateup.q[i], gateup.scale[i]),
                    qz.QuantizedWeight(down.q[i], down.scale[i]))

        for rows in batches:
            x = torch.randn((rows, hidden), generator=gen, device=dev).to(torch.bfloat16)
            for idx in (0, layers - 1):
                gu, dn = pick(idx)
                got = qz.fused_swiglu_mlp(x, gu, dn)
                want = qz.fused_swiglu_mlp_plain(x, gu.q, gu.scale, dn.q, dn.scale)
                swapped = qz.fused_swiglu_mlp(x, qz.QuantizedWeight(
                    torch.cat([gu.q[inter:], gu.q[:inter]]),
                    torch.cat([gu.scale[inter:], gu.scale[:inter]])), dn)
                again = torch.equal(got, qz.fused_swiglu_mlp(x, gu, dn))
                torch.cuda.synchronize()
                scale = want.float().abs().max().item()
                err = (got.float() - want.float()).abs().max().item()
                miss = (swapped.float() - want.float()).abs().max().item()
                finite = bool(torch.isfinite(got).all())
                print(f"[E] {model} H={hidden} I={inter} B={rows} idx={idx:2d}: max|err| "
                      f"{err:.3e} <= tol {tol_e * scale:.3e}; gate/up swapped {miss:.3e} > tol; "
                      f"a second run bit-equal: {again}")
                if not (finite and err <= tol_e * scale and again):
                    raise AssertionError(f"kernel E {model} B={rows} idx={idx}: {err} > "
                                         f"{tol_e * scale}, non-finite, or two runs differ")
                if not miss > tol_e * scale:
                    raise AssertionError(f"kernel E check misses swapped gate/up: {miss}")
                worst = max(worst, err)
            ms = device_ms(lambda i: qz.fused_swiglu_mlp(x, *pick(i)), 2 * layers)
            plain = stream_ms(lambda i: qz.fused_swiglu_mlp_plain(
                x, *(a for w in pick(i) for a in (w.q, w.scale))), layers)
            weight = 3 * hidden * inter + 2 * inter * 4 + hidden * 4
            limit = bound(weight + 2 * rows * hidden * 2, 6 * rows * hidden * inter)
            print(f"[E] {model} B={rows}: kernel {ms:.4f} ms ({weight / (ms * 1e-3) / 1e9:.0f} "
                  f"GB/s of weight), plain {plain:.4f} ms, bound {limit[0]:.4f} ms ({limit[1]})")
            table[(model, rows)] = (ms, plain, limit)
        del gateup, down
        torch.cuda.empty_cache()
    ms, plain, limit = table[("qwen", 8)]
    return dict(err=worst, ms=ms, plain_ms=plain, bound=limit, library_ms=None, table=table)


def _to_device(tree, device):
    """A copy of a parameter tree (dicts, lists, int4 weights, tensors) on device."""
    import dataclasses

    import torch

    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if torch.is_tensor(tree):
        return tree.to(device)
    return dataclasses.replace(tree, q=tree.q.to(device), scale=tree.scale.to(device))


def phase_reference(quantization: str) -> dict:
    """The engine on the card against the same engine on the CPU, where every
    wrapper runs its plain version: the small Qwen2.5-VL profile (8 layers,
    text layers and vocab table int4 or int8 by ``quantization``) with the
    same weights on both.  Prefill runs the vision tower through kernel C
    (1024 patches) and the vocab head through kernel B (int4) or D (int8);
    one 8-token window then runs every projection through kernel A (int4),
    or qkv and o through D and each MLP through E (int8).  Both sides work
    in bf16 with f32 sums, so a sum taken in another order can flip a bf16
    rounding that the next layers carry on: logits are held to max|err| <=
    2^-5 * max|ref|, which a wrong kernel (wrong layer, nibble or mask)
    exceeds by far."""
    import torch

    from vis_tpu_torch.models.common.decoder import extend_scan
    from vis_tpu_torch.models.common.layers import embed
    from vis_tpu_torch.serving import engine as E

    settings = E.ServingSettings(max_cache_tokens=2048, lookahead=8)
    cpu = E.build_small_engine("reference", "cpu", SEED, quantization=quantization,
                               vocab_mode=quantization, settings=settings)
    worst = 0.0
    gpu = E.Engine(cpu.name, cpu.config, _to_device(cpu.params, DEVICE),
                   cpu.tokenizer, DEVICE, settings)
    window = torch.tensor([cpu.tokenizer.encode('{"object')])
    n = window.shape[1]
    out = {}
    for label, side in (("plain", cpu), ("kernel", gpu)):
        cache, logits, next_pos, _, _ = side._prefill_request(
            "Describe the part.", str(SAMPLE), max_tokens=64, max_image_dim=512)
        text = side.params["text"]
        pos = torch.arange(next_pos, next_pos + n, dtype=torch.int32, device=side.device)
        last, _ = extend_scan(
            side.config.text, text, embed(window.to(side.device), text["embed_tokens"]),
            pos[None, None].expand(3, 1, n), cache, [n])
        out[label] = {"prefill": logits.cpu(), "window": last.cpu()}
    for name in ("prefill", "window"):
        worst = max(worst, _hold(f"small Qwen2.5-VL {quantization}", name, out["plain"][name],
                                 out["kernel"][name]))
    worst = max(worst, _reference_text(quantization), _reference_mllama(quantization),
                _reference_loops(cpu, gpu, quantization))
    return {"worst_err_over_tol": worst}


LOOP_STEPS, LOOP_TEMPERATURE = 16, 0.7
LOOP_MODES = ("greedy", "sampled", "constrained", "constrained_sampled")


def _loop_state(side, mode: str, uniforms) -> dict:
    """A loop mode's inputs on ``side``'s device: the inspection schema's
    DFA at its start for the constrained modes, and a draw over the shared
    uniforms for the sampled ones."""
    from vis_tpu_torch.serving.engine import request_constraint

    draws = iter([u.to(side.device) for u in uniforms])
    constraint = (request_constraint(side._json_tables("inspection"), 160, 0, side.device)
                  if mode.startswith("constrained") else None)
    return {"con": constraint, "draw": lambda shape: next(draws)}


def _hold_loops(profile: str, out: dict) -> float:
    """Each loop mode's first step on the card against the CPU (logits at
    2^-5 * max|ref|, argmax equal); prints how many of the chunk's tokens
    lead equal on both sides."""
    worst = 0.0
    for mode in LOOP_MODES:
        (want, want_tokens), (got, got_tokens) = out["plain"][mode], out["kernel"][mode]
        worst = max(worst, _hold(profile, f"{mode} loop step 1", want, got, argmax=True))
        same = next((i for i, (a, b) in enumerate(zip(want_tokens, got_tokens)) if a != b),
                    len(want_tokens))
        print(f"[reference] {profile} {mode} loop: {same} of {len(want_tokens)} tokens "
              f"lead equal on the card and the CPU")
    return worst


def _run_loop(side, mode: str, state: dict, logits, pos: int, cache, steps: int):
    """One chunk of ``mode``'s dense decode loop on ``side``."""
    from vis_tpu_torch.models.common.decoder import (
        decode_loop_scan,
        decode_loop_scan_constrained,
        decode_loop_scan_sampled,
    )

    tc, params, eos = side.text_config, side.params["text"], side.tokenizer.eos_id
    if mode == "greedy":
        tokens, logits, _ = decode_loop_scan(tc, params, logits, pos, cache, steps, eos_id=eos)
    elif mode == "sampled":
        tokens, logits, _ = decode_loop_scan_sampled(
            tc, params, logits, pos, cache, state["draw"], LOOP_TEMPERATURE, steps, eos_id=eos)
    else:
        sampling = ({"draw_uniforms": state["draw"], "temperature": LOOP_TEMPERATURE}
                    if mode == "constrained_sampled" else {})
        tokens, logits, _, state["con"] = decode_loop_scan_constrained(
            tc, params, logits, pos, cache, state["con"], steps, eos_id=eos, **sampling)
    return tokens, logits


def _uniforms(vocab: int) -> list:
    import torch

    gen = torch.Generator().manual_seed(SEED)
    return [torch.rand((1, vocab), generator=gen).clamp_min_(1e-20) for _ in range(LOOP_STEPS)]


def _clone_cache(cache):
    from vis_tpu_torch.models.common.layers import KVCache

    return KVCache(cache.k.clone(), cache.v.clone(), cache.lengths.clone(),
                   list(cache.lengths_host))


def _reference_loops(cpu, gpu, quantization: str) -> float:
    """The dense decode loops of the config's default decode paths
    (``decode_loop_scan``, ``decode_loop_scan_sampled`` at 0.7 and
    ``decode_loop_scan_constrained`` under the inspection schema, greedy
    and sampled) on the small Qwen2.5-VL profile (``cpu`` and ``gpu``, the
    same weights) and the small Llama text profile, one 16-step chunk each
    from a text prompt's prefill: one step, then 15 chained on it, the same
    uniforms on both sides.  Every projection runs kernel A (int4) or D and
    E (int8) at B = 1, the head B or D."""
    from vis_tpu_torch.serving import engine as E

    text_cpu = E.build_small_text_engine("reference", "cpu", SEED, quantization, "int8",
                                         settings=cpu.settings)
    text_gpu = E.Engine(text_cpu.name, text_cpu.config, _to_device(text_cpu.params, DEVICE),
                        text_cpu.tokenizer, DEVICE, text_cpu.settings)
    worst = 0.0
    for profile, pair in ((f"small Qwen2.5-VL {quantization}", (cpu, gpu)),
                          (f"small Llama text {quantization}", (text_cpu, text_gpu))):
        uniforms = _uniforms(pair[0].text_config.vocab_size)
        out = {}
        for label, side in zip(("plain", "kernel"), pair):
            cache0, logits0, next_pos, _, _ = side._prefill_request(
                "Describe the part.", None, max_tokens=64, max_image_dim=512)
            out[label] = {}
            for mode in LOOP_MODES:
                cache, state = _clone_cache(cache0), _loop_state(side, mode, uniforms)
                first, logits = _run_loop(side, mode, state, logits0, next_pos, cache, 1)
                rest, _ = _run_loop(side, mode, state, logits, next_pos + 1, cache,
                                    LOOP_STEPS - 1)
                out[label][mode] = (logits.cpu(), first[0].tolist() + rest[0].tolist())
        worst = max(worst, _hold_loops(profile, out))
    return worst


def _reference_mllama(quantization: str) -> float:
    """The small Mllama profile (a 256-wide tower of 4 + 2 layers; 8 text
    layers, cross layers 1 and 5; text layers and the tied vocab table int4
    or int8) on the card against the same engine on the CPU, same weights,
    same host tiles of the sample (4 tiles, 4128 tower tokens): the tower's
    features, the prefill logits of a short prompt (bucket 128, so every
    text projection runs through kernel B at int4, or D and E at int8, and
    the head at B = 1) and one 8-token window's last logits, each held to
    2^-5 * max|ref|; then the loop engine's token-a-pass chunk from the
    prefill with each of the four picks of ``_reference_loops``, its first
    step held as theirs are.  Fails unless B (int4), or D and E (int8),
    launched on the card."""
    import torch

    from vis_tpu_torch.models.common.decoder import TokenPicker
    from vis_tpu_torch.models.common.layers import KVCache, causal_mask, length_mask
    from vis_tpu_torch.models.llama.mllama import (
        compute_cross_kv,
        mllama_logits,
        text_forward,
        vision_forward,
    )
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.ops.preprocess_mllama import preprocess_image_mllama
    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.serving.engine_mllama import MllamaEngine, build_small_mllama_engine

    settings = E.ServingSettings(max_cache_tokens=1024, lookahead=8)
    cpu = build_small_mllama_engine("reference", "cpu", SEED, quantization, quantization,
                                    settings)
    gpu = MllamaEngine(cpu.name, cpu.config, _to_device(cpu.params, DEVICE), cpu.tokenizer,
                       DEVICE, settings)
    cfg, tok = cpu.config, cpu.tokenizer
    tiles = preprocess_image_mllama(SAMPLE)
    ids = [tok.image_token_id] + tok.encode("Audit the part.")
    window = tok.encode('{"object')
    seq_len, bucket, max_len = len(ids), 128, 256
    wrappers = ((qz.q4_matmul,) if quantization == "int4"
                else (qz.q8_matmul, qz.fused_swiglu_mlp))
    out, loops, uniforms = {}, {}, _uniforms(cfg.text.vocab_size)
    for label, side in (("plain", cpu), ("kernel", gpu)):
        dev = side.device
        for fn in wrappers:
            fn.launches = 0
        features = vision_forward(cfg.vision, side.params, torch.from_numpy(tiles.tiles).to(dev),
                                  tiles.aspect_ratio_id,
                                  torch.from_numpy(tiles.tile_mask).to(dev))
        cross_kv = compute_cross_kv(cfg, side.params, features)
        padded = torch.zeros((1, bucket), dtype=torch.int64)
        padded[0, :seq_len] = torch.tensor(ids)
        cache = KVCache.create(len(cfg.self_layer_indices), 1, max_len, cfg.text.num_kv_heads,
                               cfg.text.head_dim_, cfg.text.dtype, dev)
        prefill = side._prefill(side._embed_tokens(padded.to(dev)),
                                torch.arange(bucket, dtype=torch.int32, device=dev)[None],
                                cross_kv, cache, seq_len)
        loops[label] = {}
        for mode in LOOP_MODES:  # the loop engine's chunk, one 16-step chunk a pick
            state, loop_cache = _loop_state(side, mode, uniforms), _clone_cache(cache)
            picker = TokenPicker(state["con"], state["draw"] if mode.endswith("sampled") else None,
                                 LOOP_TEMPERATURE)
            first, logits = side._decode_chunk(prefill, cross_kv, loop_cache, seq_len, 1, picker)
            rest, _ = side._decode_chunk(logits, cross_kv, loop_cache, seq_len + 1,
                                         LOOP_STEPS - 1, picker)
            loops[label][mode] = (logits.cpu(), first[0].tolist() + rest[0].tolist())
        n = len(window)
        mask = (causal_mask(n, max_len, dev, offset=seq_len)
                + length_mask(max_len, torch.tensor([seq_len + n], device=dev)))
        positions = torch.arange(seq_len, seq_len + n, dtype=torch.int32, device=dev)[None]
        hidden, _ = text_forward(cfg, side.params, side._embed_tokens(
            torch.tensor([window], device=dev)), positions, cross_kv, cache, mask)
        last = mllama_logits(cfg, side.params, hidden[:, -1:])[:, 0]
        out[label] = {"features": features.float().cpu(), "prefill": prefill.cpu(),
                      "window": last.cpu()}
    launches = {fn.__name__: fn.launches for fn in wrappers}
    print(f"[reference] small Mllama {quantization} kernel launches on the card: {launches}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"small Mllama {quantization}: a kernel never launched {launches}")
    return max([_hold(f"small Mllama {quantization}", name, out["plain"][name],
                      out["kernel"][name]) for name in ("features", "prefill", "window")]
               + [_hold_loops(f"small Mllama {quantization}", loops)])


def _hold(profile: str, name: str, want, got, argmax: bool = False) -> float:
    """Logits on the card against the CPU: finite, the same shape, max|err|
    <= 2^-5 * max|ref| (and, with ``argmax``, the same argmax per row)."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"reference {profile} {name}: shape {tuple(got.shape)} "
                             "or non-finite")
    err = (got - want).abs().max().item()
    tol = 2.0 ** -5 * want.abs().max().item()
    same_top = bool((got.argmax(-1) == want.argmax(-1)).all())
    print(f"[reference] {profile} {name} logits {list(want.shape)}: max|err| {err:.3e} "
          f"<= tol {tol:.3e} (argmax {'equal' if same_top else 'differs'})")
    if not err <= tol or (argmax and not same_top):
        raise AssertionError(f"reference {profile} {name}: {err} > {tol} or argmax differs")
    return err / tol


def _reference_text(quantization: str) -> float:
    """The small Llama text profile (8 layers, int4 or int8 layers, int8
    embedding and head) on the card against the CPU, same weights: the
    prefill logits of three prompts, then one batched paged decode chunk of
    4 steps over 3 scheduler slots (free-form, generic JSON,
    decision_support), driven on this thread: the chunk's tokens must be
    equal and its last logits held to the same bound with the argmax equal.
    The prefill's head runs kernel D at B=1 (and at int8 each MLP kernel E),
    the chunk runs kernel A (int4) or D and E (int8) at B=3, and D for the
    head."""
    import torch

    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.serving.constrained import json_constraint_tables
    from vis_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
    from vis_tpu_torch.serving.schema import SCHEMAS, schema_constraint_tables

    settings = E.ServingSettings(max_cache_tokens=1024, lookahead=8)
    cpu = E.build_small_text_engine("reference", "cpu", SEED, quantization, "int8",
                                    settings=settings)
    gpu = E.Engine(cpu.name, cpu.config, _to_device(cpu.params, DEVICE), cpu.tokenizer,
                   DEVICE, settings)
    vocab = cpu.text_config.vocab_size
    tables = {None: json_constraint_tables(cpu.tokenizer, vocab)}
    for name in SCHEMAS:
        tables[name] = schema_constraint_tables(cpu.tokenizer, vocab, name)
    jobs = (("Narrate the inspection findings.", {}),
            ("Summarize the defects as JSON.", {"json_mode": True}),
            ("Estimate repair costs.", {"json_mode": True, "schema": "decision_support"}))
    out = {}
    for label, side in (("plain", cpu), ("kernel", gpu)):
        side.scheduler = ContinuousBatchingScheduler(
            side.text_config, side.params["text"], side.tokenizer, side.device,
            num_slots=3, max_len=1024, json_tables=tables, page_size=128,
            pool_tokens=3072, decode_chunk=4)
        prefill, requests = [], []
        for prompt, kwargs in jobs:
            cache, logits, pos, kv_len, _ = side._prefill_request(
                prompt, None, max_tokens=200, max_image_dim=512, prompt_only_cache=True)
            prefill.append(logits)
            requests.append(side.scheduler.submit_prefilled(
                cache, logits, pos, max_tokens=200, kv_len=kv_len, **kwargs))
        while side.scheduler._admit_one():
            pass
        side.scheduler._decode_once()
        out[label] = {"prefill": torch.cat(prefill).cpu(),
                      "chunk": side.scheduler._logits.cpu(),
                      "tokens": [r.generated for r in requests]}
        side.scheduler = None
    if out["kernel"]["tokens"] != out["plain"]["tokens"]:
        raise AssertionError(f"reference text chunk tokens differ: {out['kernel']['tokens']} "
                             f"!= {out['plain']['tokens']}")
    print(f"[reference] small Llama text {quantization} chunk tokens equal: "
          f"{out['plain']['tokens']}")
    return max(_hold(f"small Llama text {quantization}", name, out["plain"][name],
                     out["kernel"][name], argmax=True) for name in ("prefill", "chunk"))


class _Recorder:
    """Keeps a backend's raw outputs (for the schema check) and every
    exception a call raised (the agents turn one into a failed analysis
    or fallback text, so the text alone cannot tell)."""

    def __init__(self, backend):
        import threading

        self.backend = backend
        self.name = backend.name
        self.engine = backend.engine
        self.outputs, self.errors = [], []
        self._lock = threading.Lock()

    def generate(self, *args, **kwargs):
        try:
            text = self.backend.generate(*args, **kwargs)
        except Exception as exc:
            with self._lock:
                self.errors.append(repr(exc))
            raise
        with self._lock:
            self.outputs.append(text)
        return text

    def generate_stream(self, *args, **kwargs):
        raise AssertionError("a stateless chat fallback ran instead of a KV-cached session")

    def health_check(self):
        return self.backend.health_check()


class _BundleRecorder:
    """The explainer's backend, recording every call from the bundle's three
    threads: its kind, its output or the exception it raised (the agent
    turns an exception into fallback text, so the text alone cannot tell),
    and the scheduler request it became."""

    def __init__(self, backend):
        import threading

        self.backend = backend
        self.name = backend.name
        self.calls = []
        self.requests = []
        self._lock = threading.Lock()
        scheduler = backend.engine.scheduler
        submit = scheduler.submit_prefilled

        def recording_submit(*args, **kwargs):
            request = submit(*args, **kwargs)
            with self._lock:
                self.requests.append(request)
            return request

        scheduler.submit_prefilled = recording_submit

    def generate(self, prompt, image_path=None, **kwargs):
        kind = ("decision" if kwargs.get("json_schema") else
                "narration" if "STRUCTURED FINDINGS" in prompt else "counterfactual")
        try:
            text = self.backend.generate(prompt, image_path, **kwargs)
        except Exception as exc:
            with self._lock:
                self.calls.append({"kind": kind, "error": repr(exc)})
            raise
        with self._lock:
            self.calls.append({"kind": kind, "text": text, "error": None})
        return text

    def health_check(self):
        return self.backend.health_check()

    def take(self):
        with self._lock:
            calls, requests = self.calls, self.requests
            self.calls, self.requests = [], []
        return calls, requests


# The defect list the explainer's decision support decodes for when the
# consensus holds none (both random VLMs answer "defects": []).
BUNDLE_DEFECTS = [{"type": "crack", "safety_impact": "MODERATE", "location": "weld seam"}]


# The window-graph phase: the inspector's lookahead decode at the photo
# cell's size (bench_torch/configs/qwen2_5_vl_7b.json: an 8,192-token cache
# cap, 448-token schema answers with a 432-token floor, windows of 8 in calls
# of 64, the agent's temperature 0.1 when sampled).
WINDOW_SETTINGS = dict(max_cache_tokens=8192, decode_chunk=64, lookahead=8,
                       min_json_tokens=432)
WINDOW_BUDGET, WINDOW_TEMPERATURE = 448, 0.1
WINDOW_PROMPT = ("Inspect this part for defects. " * 84).strip()


def _pool_bytes(graph) -> int:
    """Bytes of the segments the caching allocator holds for ``graph``'s
    private pool."""
    import torch

    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def _launch_counts() -> dict:
    """Every hand-written kernel wrapper's ``launches``, by name."""
    from vis_tpu_torch.ops import flash_attention, int_dot, quantized

    return {name: fn.launches for module in (flash_attention, int_dot, quantized)
            for name, fn in vars(module).items() if hasattr(fn, "launches")}


def _window_request(engine, prefill, side: str, temperature: float) -> dict:
    """One schema request's decode from ``prefill`` (cache, logits, next
    position) on a copy of its cache, chained call after call as
    ``Engine._lookahead_decode`` chains them: ``decode_loop_lookahead``
    (``side`` "replayed": the cache's window pass, its windows after the
    first replaying one CUDA graph) or ``lookahead_decode`` over
    ``extend_scan`` (side "eager": each window launched op by op)."""
    import torch

    from vis_tpu_torch.models.common.decoder import (
        decode_loop_lookahead,
        extend_scan,
        lookahead_decode,
    )
    from vis_tpu_torch.models.common.layers import embed
    from vis_tpu_torch.serving import engine as E

    tc, params = engine.text_config, engine.params["text"]
    json_tables = engine._json_tables("inspection")
    tables = json_tables[-1]
    forced_tok = torch.from_numpy(tables.forced_token).to(engine.device)
    forced_state = torch.from_numpy(tables.forced_state).to(engine.device)
    eos, settings = engine.tokenizer.eos_id, engine.settings
    cache0, logits, next_pos = prefill
    cache = _clone_cache(cache0)
    constraint = E.request_constraint(json_tables, WINDOW_BUDGET, settings.min_json_tokens,
                                      engine.device)
    draw = E.request_uniforms(engine.device) if temperature > 0 else None

    def eager_extend(w_tokens, w_valid, positions, cache, valid_len):
        embeds = embed(w_tokens, params["embed_tokens"])
        return extend_scan(tc, params, embeds, positions[None].expand(3, *positions.shape),
                           cache, valid_len)

    remaining, step0, done, generated = WINDOW_BUDGET, 0, False, []
    tokens_all, valid_all, windows = [], [], 0
    torch.cuda.synchronize()
    launched = _launch_counts()
    start = time.perf_counter()
    while remaining > 0 and not done:
        common = dict(draw_uniforms=draw, temperature=temperature, eos_id=eos)
        if side == "replayed":
            tokens, valid, logits, cache, constraint = decode_loop_lookahead(
                tc, params, logits, next_pos + step0, cache, constraint, forced_tok,
                forced_state, settings.decode_chunk, settings.lookahead, **common)
        else:
            tokens, valid, logits, cache, constraint = lookahead_decode(
                logits, next_pos + step0, cache, constraint, forced_tok, forced_state,
                settings.decode_chunk, settings.lookahead, eager_extend, **common)
        tokens_all.append(tokens)
        valid_all.append(valid)
        windows += int(valid.any(dim=2).any(dim=0).sum())
        emitted_n, done = E.window_tokens(tokens[0].tolist(), valid[0].tolist(), eos,
                                          remaining, generated)
        remaining -= emitted_n
        step0 += emitted_n
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launched = {k: n - launched[k] for k, n in _launch_counts().items() if n != launched[k]}
    runner = cache.window_pass
    return {"tokens": torch.cat(tokens_all, dim=1), "valid": torch.cat(valid_all, dim=1),
            "logits": logits, "cache": cache, "generated": len(generated),
            "windows": windows, "seconds": seconds, "launches": launched,
            "capture_s": runner.capture_s if runner is not None else None,
            "pool_bytes": (_pool_bytes(runner.graph)
                           if runner is not None and runner.graph is not None else None)}


def _same_request(label: str, got: dict, want: dict) -> None:
    """Tokens, valid masks, cursors (device and host), K/V and the final
    logits, all bit for bit."""
    import torch

    checks = {
        "tokens": torch.equal(got["tokens"], want["tokens"]),
        "valid": torch.equal(got["valid"], want["valid"]),
        "cursors": (torch.equal(got["cache"].lengths, want["cache"].lengths)
                    and got["cache"].lengths_host == want["cache"].lengths_host),
        "kv": (torch.equal(got["cache"].k, want["cache"].k)
               and torch.equal(got["cache"].v, want["cache"].v)),
        "logits": torch.equal(got["logits"], want["logits"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"[{label}] replayed and eager differ: {checks}")


def phase_window_graph(label: str = "window graph") -> None:
    """The inspector's lookahead decode at the photo cell's size (int4
    Qwen2.5-VL-7B, a ~2.5k-byte prompt after the sample photo, 448-token
    schema answers): one greedy and one sampled request, each replayed (a
    CUDA graph captured on its second window) and eager, must agree bit for
    bit in tokens, valid masks, cursors, K/V and final logits, and count
    the same kernel launches.  Then two engines decode a replayed greedy
    request each, at once from two threads (as the dual-VLM node's engines
    do), each equal to its request run alone.  Prints the capture ms, ms a window both ways and the graph's
    pool bytes."""
    import threading

    import torch

    from vis_tpu_torch.serving import engine as E

    settings = E.ServingSettings(**WINDOW_SETTINGS)
    engines = [E.build_target_engine(f"window-{i}", DEVICE, SEED + i, settings)
               for i in range(2)]
    prefills = []
    for engine in engines:
        cache, logits, next_pos, seq_len, _ = engine._prefill_request(
            WINDOW_PROMPT, str(SAMPLE), max_tokens=WINDOW_BUDGET, max_image_dim=1024)
        prefills.append((cache, logits, next_pos))
    print(f"[{label}] prompt {seq_len} tokens, cache {cache.k.shape[2]} tokens")
    alone = {}
    for mode, temperature in (("greedy", 0.0), ("sampled", WINDOW_TEMPERATURE)):
        eager = _window_request(engines[0], prefills[0], "eager", temperature)
        replayed = _window_request(engines[0], prefills[0], "replayed", temperature)
        _same_request(f"{label} {mode}", replayed, eager)
        # A replay counts the launches its capture recorded: the kernels
        # that ran, as many as the eager windows launched.
        if replayed["launches"] != eager["launches"] or not eager["launches"]:
            raise AssertionError(f"[{label}] {mode}: kernel launches replayed "
                                 f"{replayed['launches']}, eager {eager['launches']}")
        alone[mode] = replayed
        print(f"[{label}] {mode}: {replayed['generated']} tokens in {replayed['windows']} "
              f"windows, bit-equal; ms a window replayed "
              f"{1e3 * replayed['seconds'] / replayed['windows']:.3f} (capture "
              f"{1e3 * replayed['capture_s']:.1f} ms), eager "
              f"{1e3 * eager['seconds'] / eager['windows']:.3f}; graph pool "
              f"{replayed['pool_bytes']} bytes; kernel launches both ways "
              f"{replayed['launches']}")
    alone["other"] = _window_request(engines[1], prefills[1], "replayed", 0.0)
    results, errors = {}, []

    def run(i):
        try:
            results[i] = _window_request(engines[i], prefills[i], "replayed", 0.0)
        except Exception as exc:  # reported below, with the other thread's result
            errors.append(repr(exc))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - start
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"[{label}] two threads: {errors or 'a thread hung'}")
    _same_request(f"{label} thread 0", results[0], alone["greedy"])
    _same_request(f"{label} thread 1", results[1], alone["other"])
    print(f"[{label}] two engines in two threads: both equal to their requests alone, "
          f"{wall:.3f} s for {results[0]['windows']} + {results[1]['windows']} windows")
    del engines, prefills, alone, results
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _decide_always(explainer) -> None:
    """Make every report bundle decode decision support.  With no defect
    the agent answers "No Action Required" without a decode; then its
    decision support is also decoded for BUNDLE_DEFECTS, in the bundle's
    own thread (so through the scheduler, beside the narration and the
    counterfactual, as a real defect would be), and the pipeline still gets
    the agent's own no-defect answer."""
    own = explainer.generate_decision_support

    def decide(defects, verdict, schema_batched=False):
        if not defects:
            own(BUNDLE_DEFECTS, verdict, schema_batched)
        return own(defects, verdict, schema_batched)

    explainer.generate_decision_support = decide


def _check_bundle(i: int, calls, requests, scheduler, decision_keys, state) -> list:
    """Fail unless the explainer's three bundle calls all returned model
    text through the scheduler (no exception, so none of the agent's
    fallbacks; each request decoded tokens, which random weights may spend
    on ids the byte tokenizer decodes to nothing), decision support parses
    with the schema's keys in order, and the scheduler decoded at least one
    chunk with >= 2 slots live.  With no defect in the consensus the state
    must hold the agent's "No Action Required" (vis_tpu_torch/agents/
    explainer.py); the decision decode then ran for BUNDLE_DEFECTS."""
    kinds = sorted(c["kind"] for c in calls)
    if kinds != ["counterfactual", "decision", "narration"]:
        raise AssertionError(f"request {i}: explainer calls {kinds}")
    for call in calls:
        if call["error"] is not None:
            raise AssertionError(f"request {i}: explainer {call['kind']} raised {call['error']}")
    errors = [r.error for r in requests if r.error]
    if len(requests) != 3 or errors:
        raise AssertionError(f"request {i}: {len(requests)} scheduler requests, errors {errors}")
    if any(not r.generated for r in requests):
        raise AssertionError(f"request {i}: a scheduler request decoded no token")
    texts = {c["kind"]: c["text"] for c in calls}
    doc = json.loads(texts["decision"])
    if list(doc) != decision_keys:
        raise AssertionError(f"request {i}: decision keys {list(doc)} != {decision_keys}")
    if (not state["consensus"]["combined_defects"]
            and state["decision_support"]["recommendation"] != "No Action Required"):
        raise AssertionError(f"request {i}: no defect, yet decision support "
                             f"{state['decision_support']}")
    if scheduler.stats["max_live"] < 2:
        raise AssertionError(f"request {i}: no chunk decoded with >= 2 live slots")
    return sorted((r.max_tokens, len(r.generated)) for r in requests)


def _check_auditor(label: str, i, result: dict, raw: str, engine, keys) -> None:
    """The auditor's answer: not failed, the inspection schema's keys in
    order, and a decode of AUDITOR_TOKENS[0]..AUDITOR_TOKENS[1] tokens."""
    if result["analysis_failed"]:
        raise AssertionError(f"{label} request {i}: auditor failed: {result['failure_reason']}")
    doc = json.loads(raw)
    if list(doc) != keys:
        raise AssertionError(f"{label} request {i}: auditor keys {list(doc)} != {keys}")
    low, high = AUDITOR_TOKENS
    if not low <= engine.last_decode_tokens <= high:
        raise AssertionError(f"{label} request {i}: auditor decoded {engine.last_decode_tokens} "
                             f"tokens, not {low}..{high}")


def _auditor_alone(label: str, auditor, recorder, wrappers: dict, check) -> None:
    """One auditor request with nothing else running (the counts are not
    atomic across the dual-VLM node's two threads, and the inspector's head
    runs on B too).  Its kernel launches must be what its decode passes and
    prefill bucket predict: each pass (a lookahead window or one token)
    runs every text
    projection of the 40 layers and the head at B <= 8, int4 on kernel B
    (4 a layer + 1), int8 qkv, o, cross q and the head on D (2 a layer + 1)
    and each MLP on E (1 a layer); the prefill runs the same when its
    bucket is at most MAX_KERNEL_ROWS rows, else only its head (B = 1).  No
    other kernel may launch.  ``check(result, raw, engine)`` judges the
    answer."""
    import torch

    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.schemas.models import InspectionContext

    engine = recorder.backend.engine
    layers = engine.config.text.num_layers
    if isinstance(engine.params["text"]["layers"][0]["qkv_proj"], qz.QuantizedWeight4):
        per_pass, head = {"B": 4 * layers + 1}, {"B": 1}
    else:
        per_pass, head = {"D": 2 * layers + 1, "E": layers}, {"D": 1, "E": 0}
    for fn in wrappers.values():
        fn.launches = 0
    decode_s = engine.decode_device_s_total
    start = time.perf_counter()
    result = auditor.verify(SAMPLE, InspectionContext(image_id="chip-smoke", criticality="high",
                                                      domain="general"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    decode_s = engine.decode_device_s_total - decode_s
    check(result.model_dump(), recorder.outputs[-1], engine)
    passes, bucket = engine.last_decode_passes, engine.last_prefill_bucket
    prefill = per_pass if bucket <= qz.MAX_KERNEL_ROWS else head
    predicted = {k: passes * n + prefill[k] for k, n in per_pass.items()}
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"[{label}] auditor alone: wall {wall:.3f} s, {engine.last_decode_tokens} tokens in "
          f"{passes} passes, decode {decode_s:.3f} s ({1e3 * decode_s / max(passes, 1):.2f} ms "
          f"a pass, {1e3 * decode_s / max(engine.last_decode_tokens, 1):.2f} ms a token), "
          f"prefill bucket {bucket}; launches {launches}, predicted "
          f"{predicted} ({per_pass} a pass + {prefill} in prefill)")
    if any(launches[k] != predicted.get(k, 0) for k in wrappers):
        raise AssertionError(f"{label}: the auditor's launches {launches} are not the "
                             f"predicted {predicted}")


def phase_slice(label: str, profile: dict, required: str) -> dict:
    """Three run_inspection requests through the port's own entry point
    under ``profile``, after one auditor request alone (``_auditor_alone``);
    fails unless every kernel in ``required`` launched during the three.
    Returns each kernel's launches, counted from 0 just before the first
    of the three."""
    import torch

    from vis_tpu_torch import agents
    from vis_tpu_torch.ops import flash_attention as fa
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.orchestration.graph import run_inspection
    from vis_tpu_torch.serving.schema import SCHEMAS
    from vis_tpu_torch.utils.config import get_config
    from vis_tpu_torch.utils.logger import get_timings

    for key, value in profile.items():
        os.environ[key] = value
    get_config(reload=True)
    keys = [k for k, _ in SCHEMAS["inspection"].props]
    decision_keys = [k for k, _ in SCHEMAS["decision_support"].props]
    agents.install(DEVICE, seed=SEED)
    for name, get in (("inspector", agents.get_inspector), ("auditor", agents.get_auditor),
                      ("explainer", agents.get_explainer)):
        start = time.perf_counter()
        agent = get()
        torch.cuda.synchronize()
        print(f"[{label}] built {agent.backend.engine.name} on {DEVICE} (seed {SEED}) in "
              f"{time.perf_counter() - start:.2f} s; device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    inspector, explainer = agents.get_inspector(), agents.get_explainer()
    recorder = _Recorder(inspector.backend)
    inspector.backend = recorder
    engine = inspector.backend.backend.engine
    auditor = agents.get_auditor()
    auditor_recorder = _Recorder(auditor.backend)
    auditor.backend = auditor_recorder
    auditor_engine = auditor_recorder.backend.engine
    scheduler = explainer.backend.engine.scheduler
    if scheduler is None:
        raise AssertionError("the explainer engine has no scheduler attached")
    bundle = _BundleRecorder(explainer.backend)
    explainer.backend = bundle
    _decide_always(explainer)

    wrappers = {"A": qz.q4_matmul_stacked, "B": qz.q4_matmul, "C": fa.flash_attention,
                "D": qz.q8_matmul, "E": qz.fused_swiglu_mlp}
    _auditor_alone(label, auditor, auditor_recorder, wrappers,
                   lambda result, raw, eng: _check_auditor(label, "alone", result, raw, eng,
                                                           keys))
    for fn in wrappers.values():
        fn.launches = 0
    for i in range(REQUESTS):
        get_timings(reset=True)
        admitted, steps = scheduler.stats["admitted"], scheduler.stats["steps"]
        scheduler.stats["max_live"] = 0
        start = time.perf_counter()
        state = run_inspection(str(SAMPLE), criticality="high", domain="general",
                               user_notes="chip smoke")
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        result = state["inspector_result"]
        if result["analysis_failed"]:
            raise AssertionError(f"{label} request {i}: inspector failed: "
                                 f"{result['failure_reason']}")
        doc = json.loads(recorder.outputs[-1])
        if list(doc) != keys:
            raise AssertionError(f"{label} request {i}: inspector keys {list(doc)} != {keys}")
        _check_auditor(label, i, state["auditor_result"], auditor_recorder.outputs[-1],
                       auditor_engine, keys)
        calls, requests = bundle.take()
        tokens = _check_bundle(i, calls, requests, scheduler, decision_keys, state)
        if scheduler.stats["admitted"] - admitted != len(tokens):
            raise AssertionError(f"{label} request {i}: scheduler admitted "
                                 f"{scheduler.stats['admitted'] - admitted}, not {len(tokens)}")
        spans = {k: round(sum(v), 4) for k, v in get_timings().items()
                 if k.startswith(("engine.", "mllama.", "scheduler.", "explainer"))}
        steps = scheduler.stats["steps"] - steps
        verdict = (state.get("safety_verdict") or {}).get("verdict")
        defects = len(state["consensus"]["combined_defects"])
        print(f"[{label}] request {i}: wall {wall:.3f} s, spans {spans}, {defects} defects, "
              f"inspector decode "
              f"tokens {engine.last_decode_tokens}, auditor decode tokens "
              f"{auditor_engine.last_decode_tokens} in {auditor_engine.last_decode_passes} "
              f"windows, explainer (budget, tokens) {tokens}, "
              f"scheduler steps {steps} "
              f"({1e3 * spans.get('scheduler.decode', 0.0) / max(steps, 1):.2f} ms a step), "
              f"most live slots {scheduler.stats['max_live']}, verdict {verdict}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"[{label}] kernel launches during the {REQUESTS} requests: {launches}")
    for k in required:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the {label} path")
    return launches


# The default-decode phase: the bench profile at int4 with every decode
# setting at the config's default (free-form sampled decode at the agents'
# own temperatures, no grammar, no lookahead window, no scheduler, host
# preprocess) and short budgets; DEFAULT_UNSET go back to their defaults.
DEFAULT_DECODE = {**PROFILE, "CONSTRAINED_JSON": "false", "CONSTRAINED_SCHEMA": "false",
                  "CONSTRAINED_LOOKAHEAD": "0", "CONTINUOUS_BATCHING": "false",
                  "DECODE_CHUNK": "64", "DEVICE_PREPROCESS": "false",
                  "VLM_INSPECTOR_MAX_TOKENS": "128", "VLM_AUDITOR_MAX_TOKENS": "128",
                  "EXPLAINER_MAX_TOKENS": "128"}
DEFAULT_UNSET = ("VLM_INSPECTOR_TEMPERATURE", "VLM_AUDITOR_TEMPERATURE", "EXPLAINER_TEMPERATURE",
                 "VLM_INSPECTOR_MIN_TOKENS", "VLM_AUDITOR_MIN_TOKENS",
                 "CONSTRAINED_JSON_MIN_TOKENS")
CHAT_QUESTIONS = ("Where is the worst damage?", "Is it safe to keep running?")


def _role_summary(label: str, step: str, recorders: dict, before: dict) -> dict:
    """Fail on any exception a role's backend raised; returns each role's
    decode tokens and seconds since ``before`` (engine counters) and prints
    ms a token."""
    summary = {}
    for role, rec in recorders.items():
        if rec.errors:
            raise AssertionError(f"{label} {step}: the {role}'s engine raised {rec.errors}")
        tokens = rec.engine.decode_tokens_total - before[role][0]
        seconds = rec.engine.decode_device_s_total - before[role][1]
        summary[role] = (tokens, seconds)
    print(f"[{label}] {step}: " + ", ".join(
        f"{role} {n} tokens in {sec:.3f} s of decode ({1e3 * sec / max(n, 1):.2f} ms a token)"
        for role, (n, sec) in summary.items()))
    return summary


def phase_default_decode(label: str = "default decode") -> dict:
    """The decode paths of the config's defaults on the int4 bench models
    (full width and depth), through the port's entry points: one auditor
    request alone (free-form sampled, a pass a token: its kernel B
    launches must equal passes x 161 + the prefill's), one run_inspection
    request, the same request under CONSTRAINED_SCHEMA=true with the window
    still 0 (both VLM answers must carry the inspection schema's keys in
    order), and two turns of one KV-cached explainer chat session.  Fails
    on any exception from a role's engine, a role that decoded no token, or
    a kernel of A-D that never launched in the last three steps.  Returns
    their launches."""
    import torch

    from vis_tpu_torch import agents
    from vis_tpu_torch.ops import flash_attention as fa
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.orchestration.graph import run_inspection
    from vis_tpu_torch.serving.schema import SCHEMAS
    from vis_tpu_torch.utils.config import get_config
    from vis_tpu_torch.utils.logger import get_timings

    for key in DEFAULT_UNSET:
        os.environ.pop(key, None)
    os.environ.update(DEFAULT_DECODE)
    get_config(reload=True)
    agents.install(DEVICE, seed=SEED)
    roles = {"inspector": agents.get_inspector, "auditor": agents.get_auditor,
             "explainer": agents.get_explainer}
    recorders = {}
    for role, get in roles.items():
        start = time.perf_counter()
        agent = get()
        torch.cuda.synchronize()
        recorders[role] = agent.backend = _Recorder(agent.backend)
        engine = recorders[role].engine
        print(f"[{label}] built {engine.name} in {time.perf_counter() - start:.2f} s "
              f"(lookahead {engine.settings.lookahead}, decode chunk "
              f"{engine.settings.decode_chunk}, temperature {agent.temperature}, scheduler "
              f"{getattr(engine, 'scheduler', None)})")
        if engine.settings.lookahead != 0 or getattr(engine, "scheduler", None) is not None:
            raise AssertionError(f"{label}: the {role}'s engine was not built under the "
                                 "default decode settings")
    keys = [k for k, _ in SCHEMAS["inspection"].props]
    wrappers = {"A": qz.q4_matmul_stacked, "B": qz.q4_matmul, "C": fa.flash_attention,
                "D": qz.q8_matmul, "E": qz.fused_swiglu_mlp}

    def counters():
        return {role: (rec.engine.decode_tokens_total, rec.engine.decode_device_s_total)
                for role, rec in recorders.items()}

    def no_raise(result, raw, engine):
        if recorders["auditor"].errors or not engine.last_decode_tokens:
            raise AssertionError(f"{label}: the auditor alone raised "
                                 f"{recorders['auditor'].errors} or decoded no token")

    _auditor_alone(label, roles["auditor"](), recorders["auditor"], wrappers, no_raise)
    for fn in wrappers.values():
        fn.launches = 0
    for step, schema in (("free-form request", "false"), ("schema request", "true")):
        os.environ["CONSTRAINED_SCHEMA"] = schema
        get_config(reload=True)
        get_timings(reset=True)
        before = counters()
        start = time.perf_counter()
        state = run_inspection(str(SAMPLE), criticality="high", domain="general",
                               user_notes="chip smoke, default decode")
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        summary = _role_summary(label, step, recorders, before)
        spans = {k: round(sum(v), 4) for k, v in get_timings().items()
                 if k.startswith(("engine.", "mllama.", "explainer"))}
        verdict = (state.get("safety_verdict") or {}).get("verdict")
        print(f"[{label}] {step}: wall {wall:.3f} s, spans {spans}, verdict {verdict}, "
              f"inspector failed {state['inspector_result']['analysis_failed']}, auditor "
              f"failed {state['auditor_result']['analysis_failed']}")
        if not all(n > 0 for n, _ in summary.values()):
            raise AssertionError(f"{label} {step}: a role decoded no token {summary}")
        if schema == "true":
            for role in ("inspector", "auditor"):
                doc = json.loads(recorders[role].outputs[-1])
                if list(doc) != keys or state[f"{role}_result"]["analysis_failed"]:
                    raise AssertionError(f"{label} {step}: the {role}'s answer has keys "
                                         f"{list(doc)}, not {keys}")
    os.environ["CONSTRAINED_SCHEMA"] = "false"
    get_config(reload=True)
    explainer = roles["explainer"]()
    before, context = counters(), json.dumps(state["consensus"], default=str)[:1500]
    for turn, question in enumerate(CHAT_QUESTIONS):
        start = time.perf_counter()
        reply = "".join(explainer.chat_session_stream("chip-smoke", context, question))
        torch.cuda.synchronize()
        engine = recorders["explainer"].engine
        print(f"[{label}] chat turn {turn}: wall {time.perf_counter() - start:.3f} s, "
              f"{engine.last_decode_tokens} tokens, {len(reply)} characters")
        if not engine.last_decode_tokens:
            raise AssertionError(f"{label}: chat turn {turn} decoded no token")
    session = explainer._chat_sessions.get("chip-smoke")
    if session is None or engine.decode_tokens_total == before["explainer"][0]:
        raise AssertionError(f"{label}: the chat turns did not run on a KV-cached session")
    print(f"[{label}] chat session: position {session.position}, cursor "
          f"{session.cache.lengths_host[0]} of {session.cache.k.shape[2]}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"[{label}] kernel launches in the two requests and the chat: {launches}")
    for k in "ABCD":
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the {label} path")
    return launches


def _release_engines() -> None:
    """Stop the schedulers and drop the engines (the recorders hold them in
    reference cycles, hence the collection), so that the next slice's
    weights have the card to themselves."""
    import gc

    import torch

    from vis_tpu_torch import agents
    from vis_tpu_torch.serving import engine as E

    for eng in E._engines.values():
        if hasattr(eng, "detach_scheduler"):
            eng.detach_scheduler()
    E._engines.clear()
    agents.reset_agent_cache()
    gc.collect()
    torch.cuda.empty_cache()


def _hold_probe(label: str, got, want, tol: float) -> float:
    """Finite, and max|got - want| <= tol; returns the error."""
    import torch

    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    print(f"[probes] {label}: max|err| {err:.3e} <= tol {tol:.3e}")
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        raise AssertionError(f"probe kernel {label}: {err} > {tol} or non-finite")
    return err


def _miss_probe(label: str, broken, want, tol: float) -> None:
    """A deliberately broken run must miss the tolerance."""
    miss = (broken.float() - want.float()).abs().max().item()
    print(f"[probes] {label}: max|err| {miss:.3e} > tol {tol:.3e}")
    if not miss > tol:
        raise AssertionError(f"probe check misses a broken kernel ({label}): {miss} <= {tol}")


def _timed_probe(key: str, shape: str, kernel, plain, nbytes: int, flops: int,
                 calls: int, peak: float = PEAK_FLOPS) -> tuple:
    """Kernel and plain times (``device_ms``, ``stream_ms``; fn(i) walks the
    stack with i) and the bound for ``nbytes`` and ``flops`` at ``peak``."""
    ms = device_ms(kernel, calls)
    plain_ms = stream_ms(plain, max(4, calls // 4))
    limit = bound(nbytes, flops, peak)
    print(f"[probes] {key} {shape}: kernel {ms:.4f} ms ({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s), "
          f"plain {plain_ms:.4f} ms, bound {limit[0]:.4f} ms ({limit[1]})")
    return ms, plain_ms, limit


# PyTorch's int4 matmul, torch._weight_int4pack_mm: scales in groups of 256
# inputs (3584 / 2 and 18944 / 2 are multiples), weights tiled 8 k-tiles deep.
INT4PACK_GROUP, INT4PACK_TILES = 256, 8


def _int4pack(values, s_lo, s_hi) -> tuple:
    """torch._weight_int4pack_mm's operands for an int4 weight: ``values``
    [O, I] u8 in [0, 15], the weight being (value - 8) * s with s_lo [O] over
    the first I/2 inputs and s_hi [O] over the rest.  Its packing holds input
    2k in the high nibble and 2k + 1 in the low; its scales are bf16, one a
    row and group of inputs, beside zero points of 0 (it computes
    (value - 8) * scale + zero)."""
    import torch

    packed = ((values[:, 0::2] << 4) | values[:, 1::2]).contiguous()
    weight = torch._convert_weight_to_int4pack(packed, INT4PACK_TILES)
    groups = values.shape[1] // INT4PACK_GROUP
    scales = torch.cat([s_lo[None].expand(groups // 2, -1), s_hi[None].expand(groups // 2, -1)])
    return weight, torch.stack([scales, torch.zeros_like(scales)], dim=-1).to(
        torch.bfloat16).contiguous()


def _library_int4(label: str, inp, weights, calls: int = 30, tag: str = "probes") -> float:
    """The time (``device_ms``) of torch._weight_int4pack_mm on x ``inp``
    over ``weights``, a list of (values, s_lo, s_hi) as ``_int4pack`` takes
    them, walked in turn.  Each weight is converted to the library's layout
    once, outside the timing, as C's library call gets its layout.  Its
    output on the first weight is held to the exact product: the library
    rounds the scales, each dequantized weight and the output to bf16, so
    max|err| <= 2^-7 * max_o sum_i |x_i w_oi| + 2^-7 * max|y|."""
    import torch

    packs = [_int4pack(*w) for w in weights]
    values, s_lo, s_hi = weights[0]
    half = values.shape[1] // 2
    w = values.float() - 8.0
    w[:, :half] *= s_lo[:, None]
    w[:, half:] *= s_hi[:, None]
    want = inp.float() @ w.T
    room = (inp.float().abs() @ w.abs().T).max().item()
    del w
    got = torch._weight_int4pack_mm(inp, packs[0][0], INT4PACK_GROUP, packs[0][1])
    err = (got.float() - want).abs().max().item()
    tol = 2.0 ** -7 * (room + want.abs().max().item())
    print(f"[{tag}] library torch._weight_int4pack_mm {label}: max|err| vs the exact "
          f"product {err:.3e} <= tol {tol:.3e}")
    if not (tuple(got.shape) == tuple(want.shape) and err <= tol):
        raise AssertionError(f"library int4 matmul {label}: {err} > {tol} or shape "
                             f"{tuple(got.shape)}")
    ms = device_ms(lambda i: torch._weight_int4pack_mm(
        inp, packs[i % len(packs)][0], INT4PACK_GROUP, packs[i % len(packs)][1]), calls)
    print(f"[{tag}] library torch._weight_int4pack_mm {label}: {ms:.4f} ms")
    return ms


def _library_int8(label: str, inp, weights, calls: int = 30, tag: str = "probes"):
    """The time (``device_ms``) of torch._weight_int8pack_mm (bf16 x, int8
    rows, bf16 scales, bf16 out) on x ``inp`` over ``weights``, a list of
    (q, scale [O] f32) walked in turn, each scale converted once outside the
    timing; its output on the first weight is held within 2^-7 * max|y| of
    kernel D's plain version (it rounds the scales and the output to bf16).
    None, said so, where this torch build has no CUDA kernel for it."""
    import torch

    from vis_tpu_torch.ops import quantized as qz

    name = "torch._weight_int8pack_mm"
    if not torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm", "CUDA"):
        print(f"[{tag}] library {name} {label}: none, torch {torch.__version__} registers no "
              "CUDA kernel for it")
        return None
    scales = [s.to(torch.bfloat16) for _, s in weights]
    got = torch._weight_int8pack_mm(inp, weights[0][0], scales[0])
    want = qz.q8_matmul_plain(inp, *weights[0])
    err = (got.float() - want).abs().max().item()
    tol = 2.0 ** -7 * want.abs().max().item()
    print(f"[{tag}] library {name} {label}: max|err| vs kernel D's plain version {err:.3e} <= "
          f"tol {tol:.3e}")
    if not (tuple(got.shape) == tuple(want.shape) and err <= tol):
        raise AssertionError(f"library int8 matmul {label}: {err} > {tol} or shape "
                             f"{tuple(got.shape)}")
    ms = device_ms(lambda i: torch._weight_int8pack_mm(
        inp, weights[i % len(weights)][0], scales[i % len(weights)]), calls)
    print(f"[{tag}] library {name} {label}: {ms:.4f} ms")
    return ms


def _split_values(q):
    """A split-half packed int4 weight q [O, I/2] as values [O, I] in [0, 15]."""
    import torch

    return torch.cat([q & 15, q >> 4], dim=1)


def _probe_kernels(gen, dev) -> dict:
    """F, G, H, I, J, K and Q against their plain versions at the probes' full
    shapes, B = 1 as the probes run, random int4 bytes and scales
    N(0,1)*0.005+0.01 (lo and hi differ).  The exact-arithmetic kernels (F,
    I, J, K) differ from their plain versions in the order of the f32 sums:
    max|err| <= 1e-4 * max|y|; padded head rows are exactly 0; K with the
    nibbles of each byte swapped must miss.  G and Q run on kernel A: held to
    its plain version as phase 3 holds A (1e-3 * max|y|) and to the probes'
    exact arithmetic within A's bf16 weight rounding, 2^-8 * max_o sum_i
    |x_i w_oi| + 1e-4 * max|y|.  H rounds act to bf16 inside: 2^-12 * max_o
    sum_i |act_i w_oi| + 1e-4 * max|y| (a flip of one act value in 32), which
    the kernel with slab 0's gate and up swapped must exceed; two runs must
    agree bit for bit.  Timing walks the stack's layers, so each launch
    reads its weight from device memory.  Every row but H (a whole MLP, no
    one call) also times torch._weight_int4pack_mm on its weights."""
    import torch

    from vis_tpu_torch.ops import quantized as qz

    hidden, inter = PROBE_MLP
    layers = LAYERS

    def rand_q(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)

    def rand_s(*shape):
        return 0.01 + 0.005 * torch.randn(shape, generator=gen, device=dev)

    gu_q, gu_s = rand_q(layers, 2 * inter, hidden // 2), rand_s(layers, 2, 2 * inter)
    dn_q, dn_s = rand_q(layers, hidden, inter // 2), rand_s(layers, 2, hidden)
    x = torch.randn((1, hidden), generator=gen, device=dev).to(torch.bfloat16)
    a = torch.randn((1, inter), generator=gen, device=dev).to(torch.bfloat16)
    gu_bytes, dn_bytes = gu_q[0].numel(), dn_q[0].numel()
    io_gu = gu_bytes + 2 * inter * 2 * 4 + hidden * 2 + 2 * inter * 4
    io_dn = dn_bytes + hidden * 2 * 4 + inter * 2 + hidden * 4
    report = {}

    # F: the folded arithmetic on a layer picked by index (gate_up).
    err = 0.0
    for idx in (0, layers - 1):
        want = qz.q4_matmul_folded_plain(x, gu_q[idx], gu_s[idx])
        err = max(err, _hold_probe(f"F gate_up idx={idx}", qz.q4_matmul_stacked_folded(
            x, gu_q, gu_s, idx), want, 1e-4 * want.abs().max().item()))
    times = _timed_probe("F", f"gate_up [{2 * inter}, {hidden}] B=1", lambda i: qz.q4_matmul_stacked_folded(
        x, gu_q, gu_s, i % layers), lambda i: qz.q4_matmul_folded_plain(
        x, gu_q[i % layers], gu_s[i % layers]), io_gu, 2 * 2 * inter * hidden, 56)
    # One library yardstick a weight: F, G and J take x through gu_q, Q a
    # through dn_q.
    library = {name: _library_int4(f"{name} [{q.shape[1]}, {2 * q.shape[2]}] B=1", inp, [
        (_split_values(q[i]), s[i][0], s[i][1]) for i in range(3)])
        for name, q, s, inp in (("gate_up", gu_q, gu_s, x), ("down", dn_q, dn_s, a))}
    report["F"] = dict(err=err, ms=times[0], plain_ms=times[1], bound=times[2],
                       library_ms=library["gate_up"])

    # G (gate_up) and Q (down): kernel A on the probes' layout, scales [L, O, 2].
    for key, q, s, inp, io, out in (("G", gu_q, gu_s, x, io_gu, 2 * inter),
                                    ("Q", dn_q, dn_s, a, io_dn, hidden)):
        rows = s.transpose(1, 2).contiguous()
        name = "gate_up" if key == "G" else "down"
        err = 0.0
        for idx in (0, layers - 1):
            got = qz.q4_matmul_stacked(inp, qz.QuantizedWeight4Pick(q, rows, idx))
            want = qz.q4_matmul_plain(inp, q[idx], rows[idx])
            err = max(err, _hold_probe(f"{key} {name} idx={idx} (kernel A)", got, want,
                                       1e-3 * want.abs().max().item()))
            exact = qz.q4_matmul_folded_plain(inp, q[idx], s[idx])
            weights = qz.unpack_int4(q[idx], rows[idx], torch.float32)
            room = (inp.float().abs() @ weights.abs().T).max().item()
            _hold_probe(f"{key} {name} idx={idx} against the probe's exact arithmetic", got,
                        exact, 2.0 ** -8 * room + 1e-4 * exact.abs().max().item())
            del weights
        shape = f"{name} [{out}, {inp.shape[1]}] B=1"
        times = _timed_probe(key, shape, lambda i: qz.q4_matmul_stacked(
            inp, qz.QuantizedWeight4Pick(q, rows, i % layers)), lambda i: qz.q4_matmul_plain(
            inp, q[i % layers], rows[i % layers]), io, 2 * out * inp.shape[1], 56)
        report[key] = dict(err=err, ms=times[0], plain_ms=times[1], bound=times[2],
                           library_ms=library[name])

    # J: one folded weight, gate_up (the row) and down.
    err = 0.0
    for name, q, s, inp, io, out in (("down", dn_q, dn_s, a, io_dn, hidden),
                                     ("gate_up", gu_q, gu_s, x, io_gu, 2 * inter)):
        want = qz.q4_matmul_folded_plain(inp, q[0], s[0])
        err = max(err, _hold_probe(f"J {name}", qz.q4_matmul_folded(inp, q[0], s[0]), want,
                                   1e-4 * want.abs().max().item()))
        times = _timed_probe("J", f"{name} [{out}, {inp.shape[1]}] B=1",
                             lambda i: qz.q4_matmul_folded(inp, q[i % layers], s[i % layers]),
                             lambda i: qz.q4_matmul_folded_plain(inp, q[i % layers],
                                                                 s[i % layers]),
                             io, 2 * out * inp.shape[1], 56)
    report["J"] = dict(err=err, ms=times[0], plain_ms=times[1], bound=times[2],
                       library_ms=library["gate_up"])

    # H: the fused slab MLP on two layers of the probe's repack.
    slabs = qz.repack_slabs(gu_q[:2], gu_s[:2], dn_q[:2], dn_s[:2], INTER_BLOCK)
    del gu_q, gu_s, dn_q, dn_s
    err = 0.0
    for idx in (0, 1):
        want = qz.q4_fused_mlp_slab_plain(x, *slabs, idx)
        act = qz.q4_slab_act_plain(x, slabs[0][idx], slabs[1][idx]).float()
        weights = torch.cat([qz.unpack_int4(q, s.T, torch.float32)
                             for q, s in zip(slabs[2][idx], slabs[3][idx])], dim=1)
        tol = 2.0 ** -12 * (act.abs() @ weights.abs().T).max().item() + \
            1e-4 * want.abs().max().item()
        del act, weights
        got = qz.q4_fused_mlp_slab(x, *slabs, idx)
        err = max(err, _hold_probe(f"H layer {idx}", got, want, tol))
        if not torch.equal(got, qz.q4_fused_mlp_slab(x, *slabs, idx)):
            raise AssertionError("probe kernel H: two runs differ")
        gq2, gs2 = slabs[0].clone(), slabs[1].clone()
        bi = INTER_BLOCK
        gq2[idx, 0] = torch.cat([gq2[idx, 0, bi:], gq2[idx, 0, :bi]])
        gs2[idx, 0] = torch.cat([gs2[idx, 0, :, bi:], gs2[idx, 0, :, :bi]], dim=1)
        _miss_probe(f"H layer {idx}, slab 0 gate/up swapped", qz.q4_fused_mlp_slab(
            x, gq2, gs2, *slabs[2:], idx), want, tol)
        del gq2, gs2
    weight = sum(t[0].numel() * t.element_size() for t in slabs)
    times = _timed_probe("H", "one layer H 3584 I 18944 (16 slabs of 1184) B=1",
                         lambda i: qz.q4_fused_mlp_slab(x, *slabs, i % 2),
                         lambda i: qz.q4_fused_mlp_slab_plain(x, *slabs, i % 2),
                         weight + hidden * 2 + hidden * 4,
                         2 * 3 * hidden * inter, 40)
    report["H"] = dict(err=err, ms=times[0], plain_ms=times[1], bound=times[2], library_ms=None)
    del slabs

    # K: signed int4, adjacent nibbles, two layers each so the timing walks.
    err = 0.0
    for name, out, inn in (("down", hidden, inter), ("gate_up", 2 * inter, hidden)):
        q = torch.stack([qz.pack_int4_adjacent(torch.randint(
            -7, 8, (out, inn), generator=gen, device=dev, dtype=torch.int8)) for _ in range(2)])
        s = rand_s(2, 1, out)
        inp = torch.randn((1, inn), generator=gen, device=dev).to(torch.bfloat16)
        want = qz.i4_matmul_plain(inp, q[0], s[0])
        tol = 1e-4 * want.abs().max().item()
        err = max(err, _hold_probe(f"K {name}", qz.i4_matmul(inp, q[0], s[0]), want, tol))
        _miss_probe(f"K {name}, nibble order flipped", qz.i4_matmul(
            inp, (q[0] >> 4) | (q[0] << 4), s[0]), want, tol)
        times = _timed_probe("K", f"{name} [{out}, {inn}] B=1",
                             lambda i: qz.i4_matmul(inp, q[i % 2], s[i % 2]),
                             lambda i: qz.i4_matmul_plain(inp, q[i % 2], s[i % 2]),
                             q[0].numel() + out * 4 + inn * 2 + out * 4, 2 * out * inn, 56)
        # The library's unsigned value is w + 8, both halves at the row's scale.
        library_k = _library_int4(f"K {name} [{out}, {inn}] B=1", inp, [
            ((qz.unpack_int4_adjacent(q[i]).to(torch.int16) + 8).to(torch.uint8), s[i][0],
             s[i][0]) for i in range(2)])
    report["K"] = dict(err=err, ms=times[0], plain_ms=times[1], bound=times[2],
                       library_ms=library_k)
    del q, s

    # I: the int4 head through the folded kernel, padded as the probe pads it.
    hq, hs = rand_q(PROBE_HEAD, hidden // 2), rand_s(2, PROBE_HEAD)
    err, table = 0.0, {}
    for block in HEAD_BLOCKS:
        pad = -PROBE_HEAD % block
        q = torch.nn.functional.pad(hq, (0, 0, 0, pad)) if pad else hq
        s = torch.nn.functional.pad(hs, (0, pad)) if pad else hs
        got = qz.q4_matmul_folded(x, q, s)
        want = qz.q4_matmul_folded_plain(x, q, s)
        err = max(err, _hold_probe(f"I head pad {block} rows={q.shape[0]}", got, want,
                                   1e-4 * want.abs().max().item()))
        padded = got[:, PROBE_HEAD:].abs().max().item() if pad else 0.0
        print(f"[probes] I head pad {block}: padded rows max|y| {padded} == 0")
        if padded != 0.0:
            raise AssertionError(f"probe kernel I: padded rows give {padded}")
        table[block] = _timed_probe(
            "I", f"head [{q.shape[0]}, {hidden}] B=1", lambda i: qz.q4_matmul_folded(x, q, s),
            lambda i: qz.q4_matmul_folded_plain(x, q, s),
            hq.numel() + PROBE_HEAD * 2 * 4 + hidden * 2 + PROBE_HEAD * 4,
            2 * PROBE_HEAD * hidden, 30)
        del q, s
    ms, plain_ms, limit = table[HEAD_BLOCKS[0]]
    library_i = _library_int4(f"head [{PROBE_HEAD}, {hidden}] B=1", x,
                              [(_split_values(hq), hs[0], hs[1])])
    report["I"] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=limit, library_ms=library_i,
                       table=table)
    del hq, hs
    torch.cuda.empty_cache()
    return report


def _same_bits(label: str, got, want) -> None:
    """Bit-equal, or the script fails."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item()
        raise AssertionError(f"probe kernel {label}: not bit-equal to its plain version "
                             f"(max|err| {diff:.3e})")
    print(f"[probes] {label}: bit-equal to its plain version (max|err| 0)")


def _exact_ints(label: str, got, want) -> None:
    """A kernel's integer sums, read through unit scales as f32 ``got``,
    equal the exact sums ``want`` (float64); exact while |want| < 2^24."""
    top = want.abs().max().item()
    if not top < 2 ** 24:
        raise AssertionError(f"{label}: sums reach {top}, past f32's exact integers")
    _same_bits(f"{label} integer sums", got.double(), want)


def _int_dot_kernels(gen, dev) -> dict:
    """L, M, N, O and P at the int8 probe's full shapes: gate_up [37888,
    3584] and down [3584, 18944] (int8 for M and N, split-half int4 for O
    and P, whose bytes L sums), B = 1 and 8, int8 activations from
    quant_act.  L's sum wraps and M, O and P keep exact int32 sums with a
    rounded (never fused) epilogue, so each must equal its plain version
    bit for bit, and their integer sums (read through unit scales) the
    exact ones; N is kernel D, held to D's 1e-3 * max|y|.  O with its x
    halves swapped, O on P's bytes (n - 8 for the two's-complement value)
    and the gate_up sum without the wrap must miss (tolerance 0).  Timing walks 3 layers,
    so each launch reads its weight from device memory; the integer rows'
    bounds take int8's peak, N's bf16's.  Library calls: torch.sum(dtype=
    int32) for L, torch._int_mm for M (x zero-padded to 32 rows, as its
    cuBLASLt path takes more than 16; the time is not divided), and
    torch._weight_int8pack_mm for N; none takes int4 weights with int8
    activations, so O and P have none."""
    import torch

    from vis_tpu_torch.ops import int_dot
    from vis_tpu_torch.ops import quantized as qz

    hidden, inter = PROBE_MLP
    walk = 3
    shapes = {"gate_up": (2 * inter, hidden), "down": (hidden, inter)}
    q4 = {name: torch.randint(0, 256, (walk, out, inn // 2), generator=gen, device=dev,
                              dtype=torch.uint8) for name, (out, inn) in shapes.items()}
    s4 = {name: 0.01 * (1 + torch.rand((walk, 2, out), generator=gen, device=dev))
          for name, (out, _) in shapes.items()}
    q8 = {name: torch.randint(-127, 128, (walk, out, inn), generator=gen, device=dev,
                              dtype=torch.int8) for name, (out, inn) in shapes.items()}
    s8 = {name: 1e-4 * (1 + torch.rand((walk, 1, out), generator=gen, device=dev))
          for name, (out, _) in shapes.items()}
    rows_timed = {}  # (key, weight, rows) -> (ms, plain_ms, bound)
    report = {}

    def timed(key, name, rows, kernel, plain, nbytes, ops, peak):
        rows_timed[(key, name, rows)] = _timed_probe(
            key, f"{name} B={rows}" if rows else name, lambda i: kernel(i % walk),
            lambda i: plain(i % walk), nbytes, ops, 30, peak)

    # L: the wrapping byte sum over the int4 weights' bytes.
    library = {}
    for name, q in q4.items():
        got = int_dot.u8_sum(q[0])
        _same_bits(f"L {name} u8 {list(q[0].shape)}", got, int_dot.u8_sum_plain(q[0]))
        lib = torch.sum(q[0], dtype=torch.int32)
        _same_bits(f"L {name} against torch.sum(dtype=int32)", got.reshape(()), lib)
        if name == "gate_up":
            _miss_probe(f"L {name} summed without the wrap (int64 "
                        f"{q[0].sum(dtype=torch.int64).item()}, kernel {got.item()})",
                        got, q[0].sum(dtype=torch.int64).reshape(1, 1), 0.0)
        timed("L", name, 0, lambda i, q=q: int_dot.u8_sum(q[i]),
              lambda i, q=q: int_dot.u8_sum_plain(q[i]), q[0].numel() + 4, q[0].numel(),
              PEAK_INT8_OPS)
        library[name] = device_ms(lambda i, q=q: torch.sum(q[i % walk], dtype=torch.int32), 30)
        print(f"[probes] L {name}: library torch.sum(dtype=int32) {library[name]:.4f} ms")
    report["L"] = dict(err=0.0, ms=rows_timed[("L", "gate_up", 0)][0],
                       plain_ms=rows_timed[("L", "gate_up", 0)][1],
                       bound=rows_timed[("L", "gate_up", 0)][2], library_ms=library["gate_up"])

    library_m, library_n, worst_n = {}, {}, 0.0
    for name, (out, inn) in shapes.items():
        half = inn // 2
        for rows in (1, 8):
            x8, _ = int_dot.quant_act(
                torch.randn((rows, inn), generator=gen, device=dev).to(torch.bfloat16))
            xb = torch.randn((rows, inn), generator=gen, device=dev).to(torch.bfloat16)
            io = rows * inn + rows * out * 4
            # M
            q, s = q8[name], s8[name]
            _same_bits(f"M {name} B={rows}", int_dot.i8_matmul(x8, q[0], s[0]),
                       int_dot.i8_matmul_plain(x8, q[0], s[0]))
            exact = x8.double() @ q[0].double().T
            _exact_ints(f"M {name} B={rows}", int_dot.i8_matmul(
                x8, q[0], torch.ones_like(s[0])), exact)
            timed("M", name, rows, lambda i: int_dot.i8_matmul(x8, q[i], s[i]),
                  lambda i: int_dot.i8_matmul_plain(x8, q[i], s[i]),
                  q[0].numel() + out * 4 + io, 2 * rows * out * inn, PEAK_INT8_OPS)
            if rows == 1:
                pad = torch.zeros((32, inn), dtype=torch.int8, device=dev)
                pad[:rows] = x8
                _same_bits(f"M {name} library torch._int_mm (x padded to 32 rows)",
                           torch._int_mm(pad, q[0].t())[:rows].double(), exact)
                library_m[name] = device_ms(lambda i: torch._int_mm(pad, q[i % walk].t()), 30)
                print(f"[probes] M {name}: library torch._int_mm [32, {inn}] x [{inn}, {out}] "
                      f"{library_m[name]:.4f} ms (32 rows, not divided)")
            # N: kernel D on the same int8 bytes, scales [O].
            got = qz.q8_matmul(xb, q[0], s[0, 0])
            want = qz.q8_matmul_plain(xb, q[0], s[0, 0])
            worst_n = max(worst_n, _hold_probe(f"N {name} B={rows} (kernel D)", got, want,
                                               1e-3 * want.abs().max().item()))
            timed("N", name, rows, lambda i: qz.q8_matmul(xb, q[i], s[i, 0]),
                  lambda i: qz.q8_matmul_plain(xb, q[i], s[i, 0]),
                  q[0].numel() + out * 4 + rows * inn * 2 + rows * out * 4,
                  2 * rows * out * inn, PEAK_FLOPS)
            if rows == 1:
                library_n[name] = _library_int8(f"N {name} B={rows}", xb,
                                                [(q[i], s[i, 0]) for i in range(walk)])
            # O and P on the int4 bytes.
            q, s = q4[name], s4[name]
            lo, hi = int_dot.offset_nibbles(q[0])
            slo, shi = int_dot.signed_nibbles(q[0])
            unit = {"lo": torch.tensor([[1.0], [0.0]], device=dev).expand(2, out).contiguous(),
                    "hi": torch.tensor([[0.0], [1.0]], device=dev).expand(2, out).contiguous()}
            for key, fn, plain, (wl, wh) in (
                    ("O", int_dot.q4_i8_matmul, int_dot.q4_i8_matmul_plain, (lo, hi)),
                    ("P", int_dot.q4_i8s_matmul, int_dot.q4_i8s_matmul_plain, (slo, shi))):
                want = plain(x8, q[0], s[0])
                _same_bits(f"{key} {name} B={rows}", fn(x8, q[0], s[0]), want)
                for part, w_part, xs in (("lo", wl, x8[:, :half]), ("hi", wh, x8[:, half:])):
                    _exact_ints(f"{key} {name} B={rows} {part}", fn(x8, q[0], unit[part]),
                                xs.double() @ w_part.double().T)
                timed(key, name, rows, lambda i, fn=fn: fn(x8, q[i], s[i]),
                      lambda i, plain=plain: plain(x8, q[i], s[i]),
                      q[0].numel() + 2 * out * 4 + io, 2 * rows * out * inn, PEAK_INT8_OPS)
            want = int_dot.q4_i8_matmul_plain(x8, q[0], s[0])
            print(f"[probes] O {name} B={rows}: max|y| {want.abs().max().item():.3e}")
            _miss_probe(f"O {name} B={rows}, x halves swapped", int_dot.q4_i8_matmul(
                torch.cat([x8[:, half:], x8[:, :half]], dim=1), q[0], s[0]), want, 0.0)
            _miss_probe(f"P {name} B={rows}, decoded as O (n - 8)", int_dot.q4_i8_matmul(
                x8, q[0], s[0]), int_dot.q4_i8s_matmul_plain(x8, q[0], s[0]), 0.0)
            del lo, hi, slo, shi
    for key in ("O", "P"):
        print(f"[probes] {key} at every timed shape: " + "; ".join(
            f"{name} B={rows} {ms:.4f} ms, bound {limit[0]:.4f} ms ({limit[0] / ms:.0%})"
            for (k, name, rows), (ms, _, limit) in rows_timed.items() if k == key))
    for key, lib in (("M", library_m["gate_up"]), ("N", library_n["gate_up"]),
                     ("O", None), ("P", None)):
        ms, plain_ms, limit = rows_timed[(key, "gate_up", 1)]
        report[key] = dict(err=worst_n if key == "N" else 0.0, ms=ms, plain_ms=plain_ms,
                           bound=limit, library_ms=lib)
    print("[probes] O, P: no library call takes int4 weights with int8 activations")
    del q4, q8
    torch.cuda.empty_cache()
    return report


# Which probe variant runs which TPU kernel, through which wrapper:
# kernel -> (probe tool, result key(s), wrapper).
PROBE_PATHS = {
    "F": ("probe_stacked_fused", ("E",), "q4_matmul_stacked_folded"),
    "G": ("probe_stacked_fused", ("D",), "q4_matmul_stacked"),
    "H": ("probe_stacked_fused", ("F",), "q4_fused_mlp_slab"),
    "I": ("probe_stacked_fused", tuple(f"H{b}" for b in HEAD_BLOCKS), "q4_matmul_folded"),
    "J": ("probe_unpack", ("B",), "q4_matmul_folded"),
    "K": ("probe_unpack", ("C",), "i4_matmul"),
    "L": ("probe_unpack2", ("S",), "u8_sum"),
    "M": ("probe_unpack2", ("F",), "i8_matmul"),
    "N": ("probe_unpack2", ("G",), "q8_matmul"),
    "O": ("probe_unpack2", ("H",), "q4_i8_matmul"),
    "P": ("probe_unpack2", ("I",), "q4_i8s_matmul"),
    "Q": ("probe_scan_slice", ("D",), "q4_matmul_stacked"),
}


# Probe variants that run one kernel on the same bytes from the same x0:
# their first layers must agree bit for bit.  Kernels A and B share one row
# function, as do the folded entries; every tool draws its int4 stack first
# from the seed, so all of them hold the same bytes.
SAME_LAYER = {
    "kernel A and B": [("probe_scan_slice", k) for k in "ABCD"]
    + [("probe_unpack", "A"), ("probe_stacked_fused", "D")],
    "folded": [("probe_unpack", "B"), ("probe_stacked_fused", "E")],
    "folded head": [("probe_stacked_fused", f"H{b}") for b in HEAD_BLOCKS],
}


def _check_probe_layers(results) -> None:
    """The probes time a chain, not a model: from their x0 (0.01) through
    random nibbles (mean bias -0.5) at uniform scales, the residual grows
    every layer and overflows within a pass, on the TPU as here, so a pass's
    output is no value to check.  Its first layer is: each variant's must be
    finite, agree bit for bit with the variants of ``SAME_LAYER``, and
    (kernels A/B, folded, H, K, M, O, P) agree with the same layer through
    the plain versions on the same seed's weights within 2^-6 * max|h| (the
    sums in another order can move h's bf16 rounding, or an act's, by one
    step, at most 2^-7 * |h|); the int8 probe's G (kernel N on D) must equal
    the layer through q8_matmul on the same bytes bit for bit.  The int8
    probe's S returns a sum, not a layer: its pass from 0 must equal the
    plain wrapped sum over the stack's bytes, bit for bit."""
    import torch

    from vis_tpu_torch.ops import int_dot
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.tools import _probe, probe_unpack, probe_unpack2

    hidden, inter = PROBE_MLP
    layer = {(tool, key): r["layer"] for tool, by_key in results.items()
             for key, r in by_key.items() if "layer" in r and r["layer"].is_floating_point()}
    for (tool, key), h in layer.items():
        if tuple(h.shape) != (1, hidden) or not bool(torch.isfinite(h).all()):
            raise AssertionError(f"{tool} {key}: first layer {tuple(h.shape)} or non-finite")
    for name, members in SAME_LAYER.items():
        for member in members[1:]:
            if not torch.equal(layer[member], layer[members[0]]):
                raise AssertionError(f"probe {member} first layer differs from {members[0]}")
        print(f"[probes] first layer, {name}: {len(members)} variants bit-equal")
    gen = _probe.generator(DEVICE, SEED)
    stack = _probe.int4_stack(gen, hidden, inter, LAYERS)
    gu4, gs4, dn4, ds4 = probe_unpack.signed_stack(gen, hidden, inter, LAYERS)
    x0 = _probe.first_input(DEVICE, hidden)

    def plain_layer(matmul, gu, gs, dn, ds):
        return _probe.residual(x0, matmul(_probe.swiglu(matmul(x0, gu, gs)), dn, ds))

    folded = plain_layer(qz.q4_matmul_folded_plain, stack.gu_q[0], stack.gu_s[0],
                         stack.dn_q[0], stack.dn_s[0])
    wants = {
        ("probe_scan_slice", "A"): plain_layer(
            qz.q4_matmul_plain, stack.gu_q[0], stack.gu_s[0].T.contiguous(), stack.dn_q[0],
            stack.dn_s[0].T.contiguous()),
        ("probe_unpack", "B"): folded,
        # The repack equals the original under the probe's uniform scales.
        ("probe_stacked_fused", "F"): folded,
        ("probe_unpack", "C"): plain_layer(qz.i4_matmul_plain, gu4[0], gs4[0], dn4[0], ds4[0]),
    }
    del gu4, gs4, dn4, ds4
    int4 = (stack.gu_q[0], stack.gu_s[0], stack.dn_q[0], stack.dn_s[0])
    wants[("probe_unpack2", "H")] = probe_unpack2.quantized_layer(
        int_dot.q4_i8_matmul_plain, x0, *int4)
    wants[("probe_unpack2", "I")] = probe_unpack2.quantized_layer(
        int_dot.q4_i8s_matmul_plain, x0, *int4)
    got = results["probe_unpack2"]["S"]["first"]
    want = int_dot.wrap_int32(stack.gu_q.sum(dtype=torch.int64) +
                              stack.dn_q.sum(dtype=torch.int64)).reshape(1, 1)
    print(f"[probes] probe_unpack2 S, one pass from 0: {got.item()} == plain wrapped sum "
          f"{want.item()}")
    if not torch.equal(got, want):
        raise AssertionError(f"probe_unpack2 S: {got.item()} != {want.item()}")
    del stack, int4
    # The int8 stack is drawn after the int4 one from the same seed.
    gen = _probe.generator(DEVICE, SEED)
    _probe.int4_stack(gen, hidden, inter, LAYERS)
    gu8, gs8, dn8, ds8 = probe_unpack2.int8_stack(gen, hidden, inter, LAYERS)
    wants[("probe_unpack2", "F")] = probe_unpack2.quantized_layer(
        int_dot.i8_matmul_plain, x0, gu8[0], gs8[0], dn8[0], ds8[0])
    through_d = probe_unpack2.mixed_layer(x0, gu8[0], gs8[0, 0], dn8[0], ds8[0, 0])
    if not torch.equal(layer[("probe_unpack2", "G")], through_d):
        raise AssertionError("probe_unpack2 G first layer differs from the layer through "
                             "q8_matmul on the same bytes")
    print("[probes] first layer, probe_unpack2 G: bit-equal to the layer through q8_matmul")
    del gu8, gs8, dn8, ds8
    for (tool, key), want in wants.items():
        got = layer[(tool, key)]
        err = (got.float() - want.float()).abs().max().item()
        tol = 2.0 ** -6 * want.float().abs().max().item()
        print(f"[probes] first layer, {tool} {key} against the plain versions: max|err| "
              f"{err:.3e} <= tol {tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"probe {tool} {key} first layer: {err} > {tol}")


def phase_probes() -> tuple:
    """Phase 7: the probe kernels' checks, then every variant of the four
    probe tools over the full 7B MLP stack, with nothing caught.  Every
    wrapper's count is set to 0 just before the tools run and read just
    after; returns the kernel report and each probe kernel's launches."""
    import importlib

    import torch

    from vis_tpu_torch.tools import _probe

    start = time.perf_counter()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    report = _probe_kernels(gen, dev)
    report.update(_int_dot_kernels(gen, dev))
    for fn in _probe.WRAPPERS:
        fn.launches = 0
    results = {}
    for tool, variants in (("probe_scan_slice", "ABCD"), ("probe_unpack", "ABCDE"),
                           ("probe_stacked_fused", "DEFH"), ("probe_unpack2", "SFGHI")):
        print(f"[probes] python -m vis_tpu_torch.tools.{tool} {variants} "
              f"(steps {PROBE_STEPS}, best of {PROBE_REPEATS})", flush=True)
        module = importlib.import_module(f"vis_tpu_torch.tools.{tool}")
        results[tool] = module.run(variants, DEVICE, steps=PROBE_STEPS, repeats=PROBE_REPEATS,
                                   seed=SEED)
        torch.cuda.empty_cache()
    totals = _probe.launch_counts()
    _check_probe_layers(results)
    launches = {k: sum(results[tool][key]["launches"].get(wrapper, 0) for key in keys)
                for k, (tool, keys, wrapper) in PROBE_PATHS.items()}
    print(f"[probes] wrapper launches during the probe tools: {totals}")
    print(f"[probes] launches by TPU kernel: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"probe kernel {k} never launched on the probe tools' path")
    summary = {tool: {key: {f: r[f] for f in ("graph_ms", "eager_ms", "graph_gbps",
                                               "eager_gbps", "per")}
                      for key, r in by_key.items()} for tool, by_key in results.items()}
    print(f"[probes] summary {json.dumps(summary)}")
    print(f"[probes] phase 7 took {time.perf_counter() - start:.1f} s")
    return report, launches


KERNELS = {  # key: (wrapper, source, the TPU kernel it replaces)
    "A": ("q4_matmul_stacked", "vis_tpu_torch/csrc/q4_matmul.cu",
          "vis_tpu/ops/quantized.py:453"),
    "B": ("q4_matmul", "vis_tpu_torch/csrc/q4_matmul.cu", "vis_tpu/ops/quantized.py:337"),
    "C": ("flash_attention", "vis_tpu_torch/csrc/flash_attention.cu",
          "vis_tpu/ops/flash_attention.py:41"),
    "D": ("q8_matmul", "vis_tpu_torch/csrc/q8_matmul.cu", "vis_tpu/ops/quantized.py:74"),
    "E": ("fused_swiglu_mlp", "vis_tpu_torch/csrc/q8_matmul.cu",
          "vis_tpu/ops/quantized.py:164"),
    "F": ("q4_matmul_stacked_folded", "vis_tpu_torch/csrc/q4_matmul.cu",
          "tools/probe_stacked_fused.py:59"),
    "G": ("q4_matmul_stacked", "vis_tpu_torch/csrc/q4_matmul.cu",
          "tools/probe_stacked_fused.py:108"),
    "H": ("q4_fused_mlp_slab", "vis_tpu_torch/csrc/q4_matmul.cu",
          "tools/probe_stacked_fused.py:130"),
    "I": ("q4_matmul_folded", "vis_tpu_torch/csrc/q4_matmul.cu",
          "tools/probe_stacked_fused.py:376"),
    "J": ("q4_matmul_folded", "vis_tpu_torch/csrc/q4_matmul.cu", "tools/probe_unpack.py:55"),
    "K": ("i4_matmul", "vis_tpu_torch/csrc/q4_matmul.cu", "tools/probe_unpack.py:105"),
    "L": ("u8_sum", "vis_tpu_torch/csrc/int_dot.cu", "tools/probe_unpack2.py:64"),
    "M": ("i8_matmul", "vis_tpu_torch/csrc/int_dot.cu", "tools/probe_unpack2.py:88"),
    "N": ("q8_matmul", "vis_tpu_torch/csrc/q8_matmul.cu", "tools/probe_unpack2.py:120"),
    "O": ("q4_i8_matmul", "vis_tpu_torch/csrc/int_dot.cu", "tools/probe_unpack2.py:152"),
    "P": ("q4_i8s_matmul", "vis_tpu_torch/csrc/int_dot.cu", "tools/probe_unpack2.py:195"),
    "Q": ("q4_matmul_stacked", "vis_tpu_torch/csrc/q4_matmul.cu",
          "tools/probe_scan_slice.py:66"),
}


def main() -> int:
    if not (REPO / "vis_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: {REPO} holds no vis_tpu_torch checkout")
    for key, value in PROFILE.items():
        os.environ[key] = value
    WORK.mkdir(parents=True, exist_ok=True)
    phase_card()
    import torch

    phase_build()
    ssm = phase_ssm_step()
    hybrid = phase_hybrid()
    if sys.argv[1:] == ["ssm"]:
        print(json.dumps({"ssm_step": ssm, "hybrid": hybrid}))
        return 0
    kernels = phase_kernels()
    for quantization in ("int4", "int8"):
        phase_reference(quantization)
    phase_window_graph()
    int4 = phase_slice("int4 slice", PROFILE, "ABCD")
    _release_engines()
    int8 = phase_slice("int8 slice", INT8_PROFILE, "CDE")
    _release_engines()
    default = phase_default_decode()
    _release_engines()
    probe_kernels, probe_launches = phase_probes()
    kernels.update(probe_kernels)
    launches = {k: int4[k] + int8[k] + default[k] for k in int4}
    launches.update(probe_launches)
    rows = [
        {"name": f"{k}: {name}", "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[k], "max_abs_err": kernels[k]["err"],
         "ms": kernels[k]["ms"], "plain_ms": kernels[k]["plain_ms"],
         "bound_ms": kernels[k]["bound"][0], "bound_by": kernels[k]["bound"][1],
         "library_ms": kernels[k]["library_ms"]}
        for k, (name, source, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": rows, "ssm_step": ssm, "hybrid": hybrid}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
