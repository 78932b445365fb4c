"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: the GPU's name and power limit, torch and CUDA versions, and
   which host packages the pipeline needs are installed;
2. build: compile the port's CUDA kernels from vis_tpu_torch/csrc (one
   nvcc per source, all at once);
3. kernels: each kernel (A, B, C, D) against its plain PyTorch version at
   the shapes the main path gives it, with the tolerance stated, and both
   timed;
4. reference: the small Qwen2.5-VL profile and the small Llama text
   profile on the card against the same engines on the CPU (prefill
   logits, a lookahead window, one batched paged decode chunk);
5. slice: run_inspection on assets/sample.jpg, three requests, with the
   Qwen2.5-VL-7B inspector and the Llama-3.1-8B explainer on the port (full
   width and depth, random weights from a fixed seed; the explainer's
   report bundle through the paged continuous-batching scheduler) and the
   auditor on the mock provider.  Every kernel must have launched during
   these requests, and every request must show the explainer's three
   decodes as model text from the scheduler.

The last line of standard output is {"ok": true, "device": {...}}; the
line before it lists each kernel's launches, error and times.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HOST_PACKAGES = ("pydantic", "PIL", "yaml", "jax")
INSTALLED = {name: importlib.util.find_spec(name) is not None for name in HOST_PACKAGES}
sys.modules["jax"] = None  # the port never imports jax; make sure nothing does

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
WORK = REPO / "build" / "chip_smoke"
SEED = 1234
REQUESTS = 3
DEVICE = "cuda:0"
SAMPLE = REPO / "assets" / "sample.jpg"

# The serving profile of bench.py (copied: importing bench.py rewrites the
# environment), with the inspector and the explainer on the port and the
# auditor mocked.
PROFILE = {
    "DEV_PROFILE": "target",
    "QUANTIZATION": "int4",
    "VOCAB_QUANTIZATION": "int4",
    "EXPLAINER_VOCAB_QUANTIZATION": "int8",
    "CONSTRAINED_JSON": "true",
    "VLM_INSPECTOR_PROVIDER": "cuda",
    "VLM_AUDITOR_PROVIDER": "mock",
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

# 7B decoder projections, [out, in], and the padded int4 vocab head.
PROJECTIONS = {
    "qkv": (4608, 3584),
    "o": (3584, 3584),
    "gate_up": (37888, 3584),
    "down": (3584, 18944),
}
LAYERS = 28
HEAD = (152064, 3584)
FLASH = dict(b=1, s=4096, h=16, d=80, length=3996)
# The explainer's int8 vocab head: Llama-3.1-8B's 128256 rows padded to 128512.
HEAD8 = (128512, 128256, 4096)


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of fn() over CUDA events."""
    import torch

    for i in range(warmup):
        fn(i)
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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

    from vis_tpu_torch.ops import flash_attention as fa
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.serving.engine import random_q4

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    report = {}

    # A: every 7B projection, B in {1, 8}, layers 0 and 27.  Timing walks
    # the 28 layers so each launch reads its weight from device memory, as
    # a decode window does.
    worst_a, times_a = 0.0, {}
    for name, (out, inn) in PROJECTIONS.items():
        w = random_q4(gen, LAYERS, out=out, inn=inn, device=dev)
        q, scale = w.q, w.scale
        for rows in (1, 8):
            x = torch.randn((rows, inn), generator=gen, device=dev).to(torch.bfloat16)
            for idx in (0, LAYERS - 1):
                pick = qz.QuantizedWeight4Pick(q, scale, idx)
                got = qz.q4_matmul_stacked(x, pick)
                want = qz.q4_matmul_plain(x, q[idx], scale[idx])
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = 1e-3 * want.abs().max().item()
                print(f"[A] {name:8s} [{out}, {inn}] B={rows} idx={idx:2d}: "
                      f"max|err| {err:.3e} <= tol {tol:.3e}")
                if not err <= tol:
                    raise AssertionError(f"kernel A {name} B={rows} idx={idx}: {err} > {tol}")
                worst_a = max(worst_a, err)
            ms = median_ms(lambda i: qz.q4_matmul_stacked(
                x, qz.QuantizedWeight4Pick(q, scale, i % LAYERS)), reps=56)
            plain = median_ms(lambda i: qz.q4_matmul_plain(
                x, q[i % LAYERS], scale[i % LAYERS]), reps=28)
            gbps = (q[0].numel() + scale[0].numel() * 4) / (ms * 1e-3) / 1e9
            times_a[(name, rows)] = (ms, plain)
            print(f"[A] {name:8s} B={rows}: kernel {ms:.4f} ms ({gbps:.0f} GB/s of "
                  f"weight), plain {plain:.4f} ms")
        del w, q, scale
    report["A"] = dict(err=worst_a, ms=times_a[("gate_up", 8)][0],
                       plain_ms=times_a[("gate_up", 8)][1], table=times_a)

    # B: the int4 vocab head, B = 1.
    w = random_q4(gen, out=HEAD[0], inn=HEAD[1], device=dev)
    q, scale = w.q, w.scale
    x = torch.randn((1, HEAD[1]), generator=gen, device=dev).to(torch.bfloat16)
    got = qz.q4_matmul(x, q, scale)
    want = qz.q4_matmul_plain(x, q, scale)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-3 * want.abs().max().item()
    print(f"[B] head {list(HEAD)} B=1: max|err| {err:.3e} <= tol {tol:.3e}")
    if not err <= tol:
        raise AssertionError(f"kernel B: {err} > {tol}")
    ms = median_ms(lambda i: qz.q4_matmul(x, q, scale), reps=30)
    plain = median_ms(lambda i: qz.q4_matmul_plain(x, q, scale), reps=10)
    gbps = (q.numel() + scale.numel() * 4) / (ms * 1e-3) / 1e9
    print(f"[B] head B=1: kernel {ms:.4f} ms ({gbps:.0f} GB/s of weight), plain {plain:.4f} ms")
    report["B"] = dict(err=err, ms=ms, plain_ms=plain)
    del w, q, scale

    # C: the vision tower's full-attention shape, non-causal, then causal.
    # Every query row is compared (the rows past the length attend the
    # valid keys too) and held to max|err| <= 2e-2 and, as bf16 rounds each
    # output to a share of its own size, each (query, head) row to
    # max|err| <= 2^-6 * max|ref| over that row.  The row bound is what
    # sees a broken mask where outputs are small: each case runs the kernel
    # with a mask dropped (the lengths, and in the causal case the
    # diagonal) and requires it to miss the masked reference by more.
    b, s, h, d, n = (FLASH[k] for k in ("b", "s", "h", "d", "length"))
    tol_c = 2.0 ** -6
    worst_c, times_c = 0.0, {}
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
        worst_c = max(worst_c, err)
        ms = median_ms(lambda i: fa.flash_attention(*qkv, lengths, causal=causal), reps=20)
        plain = median_ms(lambda i: fa.flash_attention_reference(
            *qkv, lengths, causal=causal), reps=10)
        flops = 4 * n * n * d * h * b * (0.5 if causal else 1.0)
        print(f"[C] causal={causal}: kernel {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} "
              f"TFLOP/s on valid keys), plain {plain:.4f} ms")
        times_c[causal] = (ms, plain)
    report["C"] = dict(err=worst_c, ms=times_c[False][0], plain_ms=times_c[False][1])
    del qkv

    # D: the int8 vocab head at B = 1 (end of prefill) and B = 3 (batched
    # decode).  Only the order of the f32 sums differs from the plain
    # version: max|err| <= 1e-3 * max|y|, and the 256 zero-padded rows must
    # come out exactly 0.
    from vis_tpu_torch.serving.engine import random_q8

    rows, vocab, inn = HEAD8
    w = random_q8(gen, rows, vocab, inn, device=dev)
    worst_d, times_d = 0.0, {}
    for batch in (1, 3):
        x = torch.randn((batch, inn), generator=gen, device=dev).to(torch.bfloat16)
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
        worst_d = max(worst_d, err)
        ms = median_ms(lambda i: qz.q8_matmul(x, w.q, w.scale), reps=30)
        plain = median_ms(lambda i: qz.q8_matmul_plain(x, w.q, w.scale), reps=10)
        gbps = (w.q.numel() + w.scale.numel() * 4) / (ms * 1e-3) / 1e9
        print(f"[D] head B={batch}: kernel {ms:.4f} ms ({gbps:.0f} GB/s of weight), "
              f"plain {plain:.4f} ms")
        times_d[batch] = (ms, plain)
    report["D"] = dict(err=worst_d, ms=times_d[3][0], plain_ms=times_d[3][1])
    del w
    return report


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


def phase_reference() -> dict:
    """The engine on the card against the same engine on the CPU, where every
    wrapper runs its plain version: the small Qwen2.5-VL profile (8 layers,
    int4 layers and vocab head) with the same weights on both.  Prefill runs
    the vision tower through kernel C (1024 patches) and the vocab head
    through kernel B; one 8-token window then runs every projection through
    kernel A.  Both sides work in bf16 with f32 sums, so a sum taken in
    another order can flip a bf16 rounding that the next layers carry on:
    logits are held to max|err| <= 2^-5 * max|ref|, which a wrong kernel
    (wrong layer, nibble or mask) exceeds by far."""
    import torch

    from vis_tpu_torch.models.common.decoder import extend_scan
    from vis_tpu_torch.models.common.layers import embed
    from vis_tpu_torch.serving import engine as E

    settings = E.ServingSettings(max_cache_tokens=2048, lookahead=8)
    cpu = E.build_small_engine("reference", "cpu", SEED, quantization="int4",
                               settings=settings)
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
        worst = max(worst, _hold("small Qwen2.5-VL", name, out["plain"][name],
                                 out["kernel"][name]))
    worst = max(worst, _reference_text())
    return {"worst_err_over_tol": worst}


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


def _reference_text() -> float:
    """The small Llama text profile (8 layers, int4 layers, int8 embedding and
    head) on the card against the CPU, same weights: the prefill logits of
    three prompts, then one batched paged decode chunk of 4 steps over 3
    scheduler slots (free-form, generic JSON, decision_support), driven on
    this thread: the chunk's tokens must be equal and its last logits held
    to the same bound with the argmax equal.  The prefill's head runs kernel
    D at B=1, the chunk runs kernel A and kernel D at B=3."""
    import torch

    from vis_tpu.serving.constrained import json_constraint_tables
    from vis_tpu.serving.schema import SCHEMAS, schema_constraint_tables
    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.serving.scheduler import ContinuousBatchingScheduler

    settings = E.ServingSettings(max_cache_tokens=1024, lookahead=8)
    cpu = E.build_small_text_engine("reference", "cpu", SEED, "int4", "int8",
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
    print(f"[reference] small Llama text chunk tokens equal: {out['plain']['tokens']}")
    return max(_hold("small Llama text", name, out["plain"][name], out["kernel"][name],
                     argmax=True) for name in ("prefill", "chunk"))


class _Recorder:
    """Keeps the inspector backend's raw outputs for the schema check."""

    def __init__(self, backend):
        self.backend = backend
        self.name = backend.name
        self.outputs = []

    def generate(self, *args, **kwargs):
        text = self.backend.generate(*args, **kwargs)
        self.outputs.append(text)
        return text

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


def _check_bundle(i: int, calls, requests, scheduler, decision_keys) -> dict:
    """Fail unless the explainer's three bundle calls all returned model text
    through the scheduler (no exception, so none of the agent's fallbacks;
    each request decoded tokens, which random weights may spend on ids the
    byte tokenizer decodes to nothing), decision support parses with the
    schema's keys in order, and the scheduler decoded at least one chunk
    with >= 2 slots live."""
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
    if scheduler.stats["max_live"] < 2:
        raise AssertionError(f"request {i}: no chunk decoded with >= 2 live slots")
    return sorted((r.max_tokens, len(r.generated)) for r in requests)


def phase_slice() -> dict:
    import torch

    from vis_tpu.agents import get_explainer, get_inspector
    from vis_tpu.orchestration.graph import run_inspection
    from vis_tpu.serving.schema import SCHEMAS
    from vis_tpu.utils.logger import get_timings
    from vis_tpu_torch import agents as port_agents
    from vis_tpu_torch.ops import flash_attention as fa
    from vis_tpu_torch.ops import quantized as qz

    keys = [k for k, _ in SCHEMAS["inspection"].props]
    decision_keys = [k for k, _ in SCHEMAS["decision_support"].props]
    port_agents.install(DEVICE, seed=SEED)
    for name, get in (("inspector", get_inspector), ("explainer", get_explainer)):
        start = time.perf_counter()
        agent = get()
        torch.cuda.synchronize()
        print(f"[slice] built {agent.backend.engine.name} on {DEVICE} (seed {SEED}) in "
              f"{time.perf_counter() - start:.2f} s; device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    inspector, explainer = get_inspector(), get_explainer()
    recorder = _Recorder(inspector.backend)
    inspector.backend = recorder
    engine = inspector.backend.backend.engine
    scheduler = explainer.backend.engine.scheduler
    if scheduler is None:
        raise AssertionError("the explainer engine has no scheduler attached")
    bundle = _BundleRecorder(explainer.backend)
    explainer.backend = bundle

    wrappers = {"A": qz.q4_matmul_stacked, "B": qz.q4_matmul, "C": fa.flash_attention,
                "D": qz.q8_matmul}
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
            raise AssertionError(f"request {i}: inspector failed: {result['failure_reason']}")
        doc = json.loads(recorder.outputs[-1])
        if list(doc) != keys:
            raise AssertionError(f"request {i}: inspector keys {list(doc)} != {keys}")
        calls, requests = bundle.take()
        tokens = _check_bundle(i, calls, requests, scheduler, decision_keys)
        if scheduler.stats["admitted"] - admitted != 3:
            raise AssertionError(f"request {i}: scheduler admitted "
                                 f"{scheduler.stats['admitted'] - admitted}, not 3")
        spans = {k: round(sum(v), 4) for k, v in get_timings().items()
                 if k.startswith(("engine.", "scheduler.", "explainer"))}
        steps = scheduler.stats["steps"] - steps
        verdict = (state.get("safety_verdict") or {}).get("verdict")
        print(f"[slice] request {i}: wall {wall:.3f} s, spans {spans}, inspector decode "
              f"tokens {engine.last_decode_tokens}, explainer (budget, tokens) {tokens}, "
              f"scheduler steps {steps} "
              f"({1e3 * spans.get('scheduler.decode', 0.0) / max(steps, 1):.2f} ms a step), "
              f"most live slots {scheduler.stats['max_live']}, verdict {verdict}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"[slice] kernel launches during the {REQUESTS} requests: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    return launches


def main() -> int:
    if not (REPO / "vis_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: {REPO} holds no vis_tpu_torch checkout")
    for key, value in PROFILE.items():
        os.environ[key] = value
    WORK.mkdir(parents=True, exist_ok=True)
    phase_card()
    import torch

    phase_build()
    kernels = phase_kernels()
    phase_reference()
    launches = phase_slice()
    meta = {
        "A": ("q4_matmul_stacked", "vis_tpu_torch/csrc/q4_matmul.cu",
              "vis_tpu/ops/quantized.py:453"),
        "B": ("q4_matmul", "vis_tpu_torch/csrc/q4_matmul.cu",
              "vis_tpu/ops/quantized.py:337"),
        "C": ("flash_attention", "vis_tpu_torch/csrc/flash_attention.cu",
              "vis_tpu/ops/flash_attention.py:41"),
        "D": ("q8_matmul", "vis_tpu_torch/csrc/q8_matmul.cu",
              "vis_tpu/ops/quantized.py:74"),
    }
    rows = [
        {"name": meta[k][0], "route": "cuda", "source": meta[k][1], "replaces": meta[k][2],
         "launches": launches[k], "max_abs_err": kernels[k]["err"],
         "ms": kernels[k]["ms"], "plain_ms": kernels[k]["plain_ms"]}
        for k in ("A", "B", "C", "D")
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
