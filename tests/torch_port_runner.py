"""Run the PyTorch port on inputs written by a JAX-side test.

    python tests/torch_port_runner.py CASE IN.npz OUT.npz

torch and jax deadlock when both load in one process here, and every
pytest worker imports jax (tests/conftest.py), so the tests compute the
JAX side in-process, write its inputs to IN.npz, and run this script as a
subprocess: it blocks jax before anything else, runs the port on the CPU
(every kernel wrapper takes its plain version there) and writes OUT.npz
for the test to compare.  CASE names one function below.
"""

from __future__ import annotations

import sys

sys.modules["jax"] = None  # nothing in this process may load jax

import json
import os
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().to(torch.float32).numpy() if t.is_floating_point() else t.numpy()


def case_quantized(inp):
    from vis_tpu_torch.ops import quantized as qz

    out = {}
    for name in ("square", "padded"):
        qw = qz.quantize_weight4(_t(inp[f"{name}/w"]), int(inp[f"{name}/pad"]))
        out[f"{name}/q"], out[f"{name}/scale"] = qw.q.numpy(), qw.scale.numpy()
    q, scale = _t(inp["square/jax_q"]), _t(inp["square/jax_scale"])
    out["unpack/f32"] = _np(qz.unpack_int4(q, scale, torch.float32))
    out["unpack/bf16"] = _np(qz.unpack_int4(q, scale))
    out["embed"] = _np(qz.embed_rows4(qz.QuantizedWeight4(q, scale), _t(inp["embed/ids"])))
    stack = qz.QuantizedWeight4(_t(inp["stack/q"]), _t(inp["stack/scale"]))
    for rows in inp["rows"].tolist():
        x = _t(inp[f"x{rows}"])
        out[f"single/{rows}"] = _np(qz.quantized_matmul4(x, qz.QuantizedWeight4(q, scale)))
        for idx in (0, 2):
            pick = qz.QuantizedWeight4Pick(stack.q, stack.scale, idx)
            out[f"stacked{idx}/{rows}"] = _np(qz.quantized_matmul4_stacked(x, pick))
    pad_q, pad_s = _t(inp["padded/jax_q"]), _t(inp["padded/jax_scale"])
    pick = qz.QuantizedWeight4Pick(pad_q[None], pad_s[None], 0)
    out["zero_rows"] = _np(qz.quantized_matmul4_stacked(_t(inp["padded/x"]), pick))
    return out


def case_flash(inp):
    from vis_tpu_torch.ops.flash_attention import flash_attention

    out = {}
    for name in json.loads(str(inp["cases"])):
        lengths = inp.get(f"{name}/lengths")
        out[name] = _np(flash_attention(
            _t(inp[f"{name}/q"]), _t(inp[f"{name}/k"]), _t(inp[f"{name}/v"]),
            None if lengths is None else _t(lengths),
            causal=bool(inp[f"{name}/causal"]),
        ))
    return out


def case_qwen25vl(inp):
    from vis_tpu_torch.models.common.decoder import (
        DecodeConstraint,
        decode_loop_lookahead,
        prefill_scan,
    )
    from vis_tpu_torch.models.common.layers import KVCache
    from vis_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig
    from vis_tpu_torch.models.qwen2_5_vl.model import embed_multimodal, from_jax_numpy
    from vis_tpu_torch.models.qwen2_5_vl.vision import vision_forward_25, window_layout
    from vis_tpu_torch.ops.preprocess_device import preprocess_frame_device, resize_weights

    out = {}
    cfg = Qwen25VLConfig.tiny()
    vision_7b = Qwen25VLConfig.qwen2_5_vl_7b().vision
    for i, (grid_h, grid_w, min_len, src_len, big) in enumerate(inp["layouts"].tolist()):
        layout = window_layout(vision_7b if big else cfg.vision, grid_h, grid_w, min_len, src_len)
        for field in ("gather_patch", "valid", "inv_merged", "inv_patch", "cos", "sin"):
            out[f"layout{i}/{field}"] = getattr(layout, field)
        out[f"layout{i}/sizes"] = np.array([layout.n_windows, layout.win_len])
    for i, (src, dst, bilinear) in enumerate(inp["resizes"].tolist()):
        out[f"resize{i}"] = resize_weights(src, dst, "bilinear" if bilinear else "bicubic")
    dst_h, dst_w = inp["dst"].tolist()
    out["patches"] = _np(preprocess_frame_device(_t(inp["frame"]), dst_h, dst_w))

    grid_h, grid_w, min_len, src_len, n_patches = inp["vision_layout"].tolist()
    layout = window_layout(cfg.vision, grid_h, grid_w, min_len, src_len)
    ids = _t(inp["ids"]).long()
    positions = _t(inp["positions"])
    seq_len, max_len, window, _, eos = inp["decode_dims"].tolist()
    tables = {k: _t(inp[f"tables/{k}"]) for k in
              ("token_ok", "token_trans", "cost_after", "forced_token", "forced_state")}
    for variant in ("plain", "int4"):
        prefix = f"{variant}/params/"
        flat = {k[len(prefix):]: inp[k] for k in inp.files if k.startswith(prefix)}
        params = from_jax_numpy(flat, cfg)
        vision = vision_forward_25(cfg.vision, params["vision"], _t(inp["vision_patches"]),
                                   layout, n_patches)
        out[f"{variant}/vision"] = _np(vision)
        n_tokens = n_patches // cfg.vision.merge_unit
        embeds = embed_multimodal(cfg, params, ids, vision[:n_tokens])
        for mode in ("greedy", "sampled", "greedy_to_eos", "sampled_to_eos"):
            cache = KVCache.create(cfg.text.num_layers, 1, max_len, cfg.text.num_kv_heads,
                                   cfg.text.head_dim_, cfg.text.dtype, "cpu")
            logits, cache = prefill_scan(cfg.text, params["text"], embeds, positions,
                                         cache, [seq_len])
            out[f"{variant}/prefill_logits"] = _np(logits)
            con = DecodeConstraint(
                token_ok=tables["token_ok"], token_trans=tables["token_trans"],
                cost_after=tables["cost_after"], state=_t(inp[f"{mode}/con/state"]).long(),
                remaining=_t(inp[f"{mode}/con/remaining"]).long(),
                active=_t(inp[f"{mode}/con/active"]),
                min_remaining=_t(inp[f"{mode}/con/min_remaining"]).long(),
            )
            num_windows = int(inp[f"{mode}/windows"])
            draw, temperature = None, None
            if mode.startswith("sampled"):
                uniforms = iter(_t(inp["uniforms"]))
                draw, temperature = (lambda shape: next(uniforms)), float(inp["temperature"])
            tokens, valid, _, cache, _ = decode_loop_lookahead(
                cfg.text, params["text"], logits, int(inp["next_pos"]), cache, con,
                tables["forced_token"], tables["forced_state"], num_windows, window,
                draw_uniforms=draw, temperature=temperature, eos_id=eos,
            )
            out[f"{variant}/{mode}/tokens"] = tokens.numpy()
            out[f"{variant}/{mode}/valid"] = valid.numpy()
            out[f"{variant}/{mode}/lengths"] = np.array(cache.lengths_host)
    return out


def case_pipeline(inp):
    workdir = Path(str(inp["workdir"]))
    os.environ.update({
        "VLM_INSPECTOR_PROVIDER": "cuda",
        "VLM_AUDITOR_PROVIDER": "mock",
        "EXPLAINER_PROVIDER": "mock",
        "USE_MOCK_RESPONSES": "false",
        "DEV_PROFILE": "small",
        "QUANTIZATION": "int4",
        "VOCAB_QUANTIZATION": "int4",
        "CONSTRAINED_SCHEMA": "true",
        "CONSTRAINED_LOOKAHEAD": "8",
        "DEVICE_PREPROCESS": "true",
        "VLM_INSPECTOR_MAX_TOKENS": "160",
        "VLM_INSPECTOR_MIN_TOKENS": "150",
        "KV_CACHE_MAX_TOKENS": "1024",
        "LOG_TO_FILE": "false",
        "DATABASE_PATH": str(workdir / "inspections.db"),
        "CHAT_HISTORY_DB": str(workdir / "chat.db"),
        "UPLOAD_DIR": str(workdir / "uploads"),
        "REPORT_DIR": str(workdir / "reports"),
        "LOG_DIR": str(workdir / "logs"),
    })
    from vis_tpu.agents import get_inspector
    from vis_tpu.orchestration.graph import run_inspection
    from vis_tpu_torch import agents as port_agents
    from vis_tpu_torch.ops import flash_attention as fa
    from vis_tpu_torch.ops import quantized as qz

    port_agents.install("cpu")
    backend = get_inspector().backend
    raw = []
    generate = backend.generate

    def recording_generate(*args, **kwargs):
        raw.append(generate(*args, **kwargs))
        return raw[-1]

    backend.generate = recording_generate
    state = run_inspection(str(inp["image"]), criticality="high", domain="general",
                           user_notes="port pipeline test")
    verdict = (state.get("safety_verdict") or {}).get("verdict")
    jax_live = sys.modules.get("jax") is not None or any(
        name.startswith("jax.") for name in sys.modules)
    return {
        "verdict": np.array(verdict or ""),
        "analysis_failed": np.array(bool(state["inspector_result"]["analysis_failed"])),
        "backend": np.array(backend.name),
        "raw": np.array(raw[-1] if raw else ""),
        "launches": np.array([qz.q4_matmul_stacked.launches, qz.q4_matmul.launches,
                              fa.flash_attention.launches, qz.q8_matmul.launches]),
        "jax_live": np.array(jax_live),
    }


def case_explainer_routing(inp):
    """EXPLAINER_PROVIDER=cuda under the bench's batching profile reaches
    the port's text engine with a paged scheduler attached."""
    os.environ.update({
        "EXPLAINER_PROVIDER": "cuda", "VLM_INSPECTOR_PROVIDER": "mock",
        "VLM_AUDITOR_PROVIDER": "mock", "USE_MOCK_RESPONSES": "false",
        "DEV_PROFILE": "small", "QUANTIZATION": "int4", "VOCAB_QUANTIZATION": "int4",
        "EXPLAINER_VOCAB_QUANTIZATION": "int8", "CONTINUOUS_BATCHING": "true",
        "BATCHING_ROLES": "explainer", "DECODE_BATCH_SIZE": "3", "PAGED_KV_CACHE": "true",
        "KV_PAGE_SIZE": "128", "KV_POOL_TOKENS": "4992", "KV_CACHE_MAX_TOKENS": "2560",
        "SCHEDULER_DECODE_CHUNK": "48", "LOG_TO_FILE": "false",
    })
    from vis_tpu.agents import get_explainer, get_inspector
    from vis_tpu_torch import agents as port_agents
    from vis_tpu_torch.ops.quantized import QuantizedWeight

    port_agents.install("cpu")
    backend = get_explainer().backend
    engine = backend.engine
    sched = engine.scheduler
    out = {
        "backend": np.array(backend.name),
        "inspector_backend": np.array(get_inspector().backend.name),
        "text_only": np.array(engine.vlm_config is None),
        "int8_head": np.array(isinstance(engine.params["text"]["embed_tokens"], QuantizedWeight)),
        "scheduler": np.array(json.dumps({
            "slots": sched.num_slots, "pages": sched.pool.n_pages - 1,
            "page": sched.pool.page_size, "chunk": sched.decode_chunk,
            "decision_support": sched.has_table("decision_support"),
            "generic": sched.has_table(None),
        })),
    }
    engine.detach_scheduler()
    return out


def case_boundaries(inp):
    from vis_tpu_torch import agents as port_agents
    from vis_tpu_torch.ops import _kernels
    from vis_tpu_torch.ops import flash_attention as fa
    from vis_tpu_torch.ops import quantized as qz

    gen = torch.Generator().manual_seed(0)
    q = torch.randint(0, 256, (3, 64, 32), generator=gen, dtype=torch.uint8)
    scale = torch.rand((3, 64, 2), generator=gen) * 0.01
    x = torch.randn((4, 64), generator=gen)
    qkv = [torch.randn((1, 64, 2, 16), generator=gen) for _ in range(3)]
    lengths = torch.tensor([40])
    q8 = torch.randint(-128, 128, (48, 64), generator=gen, dtype=torch.int8)
    s8 = torch.rand((48,), generator=gen) * 0.01
    same = {
        "q4_matmul": torch.equal(qz.q4_matmul(x, q[1], scale[1]),
                                 qz.q4_matmul_plain(x, q[1], scale[1])),
        "q4_matmul_stacked": torch.equal(
            qz.q4_matmul_stacked(x, qz.QuantizedWeight4Pick(q, scale, 2)),
            qz.q4_matmul_plain(x, q[2], scale[2])),
        "flash_attention": torch.equal(
            fa.flash_attention(*qkv, lengths, causal=True),
            fa.flash_attention_reference(*qkv, lengths, causal=True)),
        "q8_matmul": torch.equal(qz.q8_matmul(x, q8, s8), qz.q8_matmul_plain(x, q8, s8)),
    }
    launches = {"q4_matmul": qz.q4_matmul.launches,
                "q4_matmul_stacked": qz.q4_matmul_stacked.launches,
                "flash_attention": fa.flash_attention.launches,
                "q8_matmul": qz.q8_matmul.launches}
    try:
        port_agents.install("cuda")
        install_error = ""
    except RuntimeError as exc:
        install_error = str(exc)
    return {
        "same": np.array(json.dumps(same)),
        "launches": np.array(json.dumps(launches)),
        "library_loaded": np.array(_kernels._lib is not None),
        "install_error": np.array(install_error),
        "cuda_available": np.array(torch.cuda.is_available()),
    }


def case_cuda_kernels(inp):
    """Each kernel against its plain version on the card, at small and ragged
    shapes; on a host without a card it reports why nothing ran."""
    if not torch.cuda.is_available():
        return {"skip": np.array("torch sees no CUDA device")}
    from vis_tpu_torch.ops import flash_attention as fa
    from vis_tpu_torch.ops import quantized as qz

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"skip": np.array("")}
    for name, (rows, out_dim, in_dim, layers) in json.loads(str(inp["q4_cases"])).items():
        lead = (layers,) if layers else ()
        q = torch.randint(0, 256, (*lead, out_dim, in_dim // 2), generator=gen,
                          device=dev, dtype=torch.uint8)
        scale = torch.rand((*lead, out_dim, 2), generator=gen, device=dev) * 0.01
        x = torch.randn((rows, in_dim), generator=gen, device=dev)
        if layers:
            got = qz.q4_matmul_stacked(x, qz.QuantizedWeight4Pick(q, scale, layers - 1))
            want = qz.q4_matmul_plain(x, q[layers - 1], scale[layers - 1])
        else:
            got, want = qz.q4_matmul(x, q, scale), qz.q4_matmul_plain(x, q, scale)
        out[f"q4/{name}"] = np.array([(got - want).abs().max().item(),
                                      want.abs().max().item()])
    for name, (rows, out_dim, in_dim, padded) in json.loads(str(inp["q8_cases"])).items():
        q = torch.randint(-128, 128, (out_dim, in_dim), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((out_dim,), generator=gen, device=dev) * 0.01
        q[out_dim - padded:], scale[out_dim - padded:] = 0, 0.0
        x = torch.randn((rows, in_dim), generator=gen, device=dev)
        got, want = qz.q8_matmul(x, q, scale), qz.q8_matmul_plain(x, q, scale)
        out[f"q8/{name}"] = np.array([(got - want).abs().max().item(), want.abs().max().item(),
                                      got[:, out_dim - padded:].abs().max().item()
                                      if padded else 0.0])
    for name, (d, causal, lens) in json.loads(str(inp["flash_cases"])).items():
        q, k, v = (torch.randn((2, 256, 3, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
        got = fa.flash_attention(q, k, v, lengths, causal=causal)
        want = fa.flash_attention_reference(q, k, v, lengths, causal=causal)
        valid = [256, 256] if lens is None else list(lens)
        empty = [got[b].float().abs().max().item() for b, n in enumerate(valid) if n == 0]
        out[f"flash/{name}"] = np.array([
            fa.row_relative_error(got, want),
            (got.float() - want.float()).abs().max().item(), max(empty, default=0.0)])
    torch.cuda.synchronize()
    refused = {}
    x = torch.randn((qz.MAX_KERNEL_ROWS + 1, 64), device=dev)
    q = torch.zeros((8, 32), dtype=torch.uint8, device=dev)
    scale = torch.ones((8, 2), device=dev)
    qkv = [torch.randn((1, 64, 2, 64), device=dev) for _ in range(3)]
    qkv96 = [torch.randn((1, 64, 2, 96), device=dev).to(torch.bfloat16) for _ in range(3)]
    q8 = torch.zeros((8, 64), dtype=torch.int8, device=dev)
    s8 = torch.ones((8,), device=dev)
    x24 = torch.randn((2, 24), device=dev)
    for name, call in (("q4_rows", lambda: qz.q4_matmul(x, q, scale)),
                       ("q8_rows", lambda: qz.q8_matmul(x, q8, s8)),
                       ("q8_in16", lambda: qz.q8_matmul(
                           x24, torch.zeros((8, 24), dtype=torch.int8, device=dev), s8)),
                       ("q8_u8", lambda: qz.q8_matmul(x[:2], q8.to(torch.uint8), s8)),
                       ("flash_f32", lambda: fa.flash_attention(*qkv)),
                       ("flash_d96", lambda: fa.flash_attention(*qkv96))):
        try:
            call()
            refused[name] = ""
        except (TypeError, ValueError) as exc:
            refused[name] = type(exc).__name__
    out["refused"] = np.array(json.dumps(refused))
    out["launches"] = np.array([qz.q4_matmul.launches, qz.q4_matmul_stacked.launches,
                                fa.flash_attention.launches, qz.q8_matmul.launches])
    return out


def case_int8(inp):
    from vis_tpu_torch.models.common.layers import embed, rope_frequencies
    from vis_tpu_torch.ops import quantized as qz

    out = {}
    for name in ("square", "padded"):
        qw = qz.quantize_weight(_t(inp[f"{name}/w"]), int(inp[f"{name}/pad"]))
        out[f"{name}/q"], out[f"{name}/scale"] = qw.q.numpy(), qw.scale.numpy()
    qw = qz.QuantizedWeight(_t(inp["square/jax_q"]), _t(inp["square/jax_scale"]))
    out["embed"] = _np(embed(_t(inp["embed/ids"]), qw))
    for rows in inp["rows"].tolist():
        out[f"matmul/{rows}"] = _np(qz.quantized_matmul(_t(inp[f"x{rows}"]), qw))
    padded = qz.QuantizedWeight(_t(inp["padded/jax_q"]), _t(inp["padded/jax_scale"]))
    out["zero_rows"] = _np(qz.quantized_matmul(_t(inp["padded/x"]), padded))
    for i, (head_dim, theta, scaled) in enumerate(inp["rope"].tolist()):
        scaling = dict(json.loads(str(inp["rope_scaling"]))) if scaled else None
        out[f"rope{i}"] = _np(rope_frequencies(int(head_dim), theta, rope_scaling=scaling))
    return out


def _tiny_llama(inp):
    import dataclasses

    from vis_tpu_torch.models.llama.config import llama_tiny

    return dataclasses.replace(llama_tiny(), **json.loads(str(inp["config"])))


def _params(inp, prefix, config):
    from vis_tpu_torch.models.llama.model import from_jax_numpy

    flat = {k[len(prefix):]: inp[k] for k in inp.files if k.startswith(prefix)}
    return from_jax_numpy(flat, config)


def case_llama(inp):
    from vis_tpu_torch.models.common.decoder import (
        DecodeConstraint,
        decode_loop_paged,
        decode_loop_paged_constrained,
        extend_scan,
        prefill_scan,
    )
    from vis_tpu_torch.models.common.layers import KVCache, embed

    cfg = _tiny_llama(inp)
    params = _params(inp, "params/", cfg)
    out = {}
    seq_len, s_pad, max_len, n_new = inp["prefill_dims"].tolist()
    cache = KVCache.create(cfg.num_layers, 1, max_len, cfg.num_kv_heads, cfg.head_dim_,
                           cfg.dtype, "cpu")
    ids = _t(inp["prefill/ids"]).long()
    logits, cache = prefill_scan(cfg, params, embed(ids, params["embed_tokens"]),
                                 torch.arange(s_pad, dtype=torch.int32)[None], cache, [seq_len])
    out["prefill"] = _np(logits)
    chunk = _t(inp["extend/ids"]).long()
    positions = torch.arange(seq_len, seq_len + chunk.shape[1], dtype=torch.int32)[None]
    logits, cache = extend_scan(cfg, params, embed(chunk, params["embed_tokens"]),
                                positions, cache, [n_new])
    out["extend"] = _np(logits)

    params = _params(inp, "decode_params/", cfg)
    for mode in json.loads(str(inp["modes"])):
        pool_k, pool_v = _t(inp["pool/k"]).clone(), _t(inp["pool/v"]).clone()
        args = (cfg, params, _t(inp[f"{mode}/logits"]), _t(inp[f"{mode}/start"]), pool_k,
                pool_v, _t(inp["page_tables"]), _t(inp[f"{mode}/lengths"]))
        common = dict(eos_id=int(inp["eos"]), budget=inp[f"{mode}/budget"].tolist())
        steps = int(inp[f"{mode}/steps"])
        if mode == "free":
            tokens, _, pool_k, pool_v, lengths = decode_loop_paged(*args, steps, **common)
        else:
            tables = "tables_cls" if mode == "compressed" else "tables"
            con = DecodeConstraint(
                *(_t(inp[f"{tables}/{k}"]) for k in ("token_ok", "token_trans", "cost_after")),
                state=_t(inp[f"{mode}/state"]).long(),
                remaining=_t(inp[f"{mode}/remaining"]).long(),
                active=_t(inp[f"{mode}/active"]),
                min_remaining=_t(inp[f"{mode}/min_remaining"]).long(),
                table_idx=_t(inp[f"{mode}/table_idx"]).long(),
                class_of=_t(inp["tables_cls/class_of"]).long() if mode == "compressed" else None,
            )
            if f"{mode}/uniforms" in inp.files:
                uniforms = iter(_t(inp[f"{mode}/uniforms"]))
                common.update(draw_uniforms=lambda shape: next(uniforms),
                              temperature=_t(inp[f"{mode}/temperature"]))
            tokens, _, pool_k, pool_v, lengths, con = decode_loop_paged_constrained(
                *args, con, steps, **common)
            out[f"{mode}/state"] = con.state.numpy()
        out[f"{mode}/tokens"] = tokens.numpy()
        out[f"{mode}/lengths"] = lengths.numpy()
        out[f"{mode}/pool_k"], out[f"{mode}/pool_v"] = _np(pool_k), _np(pool_v)
    return out


def case_paged_pool(inp):
    """The host accounting of PagedKVPool, case by case."""
    from vis_tpu_torch.serving.paged_kv import PagedKVPool

    def pool(**kw):
        args = dict(num_layers=2, slots=4, max_len=512, kv_heads=2, head_dim=16,
                    page_size=128, pool_tokens=1024, dtype=torch.float32)
        args.update(kw)
        return PagedKVPool(**args)

    def boom(*a, **k):
        raise RuntimeError("device failure: injected")

    results = {}
    p = pool(pool_tokens=2048)
    total = p.free_pages
    results["beyond_window"] = [p.max_pages == 4, not p.try_reserve(0, 4 * 128 + 1),
                                p.free_pages == total, p.try_reserve(0, 4 * 128)]
    p = pool()
    total = p.free_pages
    ok = [p.try_reserve(1, 300), p.try_reserve(1, 150), p.free_pages == total - 2]
    p.release(1)
    results["rereserve_replaces"] = ok + [p.free_pages == total]
    p = pool()
    total = p.free_pages
    ok = [p.try_reserve(0, 300), p.free_pages == total - 3]
    row = p.page_tables[0].numpy()
    ok += [bool((row[:3] > 0).all() and (row[3:] == 0).all()),
           bool((p.tables_host[0] == row).all())]
    p.release(0)
    results["roundtrip"] = ok + [p.free_pages == total, bool((p.page_tables[0] == 0).all())]
    p = pool(pool_tokens=256)
    ok = [p.try_reserve(0, 256), not p.try_reserve(1, 128)]
    p.release(0)
    results["exhausted"] = ok + [p.try_reserve(1, 128)]
    try:
        pool(max_len=500)
        results["alignment"] = [False]
    except ValueError:
        results["alignment"] = [True]
    dense_bytes = 2 * 2 * 4 * 512 * 2 * 16 * 4
    results["smaller_than_dense"] = [pool().memory_bytes() < dense_bytes / 1.5]
    p = pool()
    total = p.free_pages
    ok = [p.try_reserve(0, 300)]
    before = sorted(p._free)
    p._set_row = boom
    ok += [not p.try_reserve(0, 150), not p.try_reserve(0, 512), not p.try_reserve(1, 128)]
    del p._set_row
    ok += [len(p._owned[0]) == 3, 1 not in p._owned, p.free_pages == total - 3,
           sorted(p._free) == before, not set(p._free) & set(p._owned[0])]
    p.release(0)
    results["reserve_failure_rolls_back"] = ok + [p.free_pages == total]
    p = pool()
    total = p.free_pages
    ok = [p.try_reserve(0, 300)]
    p._set_row = boom
    p.release(0)
    del p._set_row
    ok += [p.free_pages == total, 0 not in p._owned, p.try_reserve(0, 128)]
    results["release_failure_frees"] = ok + [bool((p.page_tables[0][1:] == 0).all())]
    p = pool()
    p.release_buffers()
    ok = [p.memory_bytes() == 0]
    p.ensure_buffers()
    results["elastic_buffers"] = ok + [p.memory_bytes() > 0, float(p.k.abs().sum()) == 0.0]
    return {"results": np.array(json.dumps(results))}


class _Recorder:
    """An explainer backend that keeps each call's raw output by kind."""

    def __init__(self, backend):
        self.backend, self.name, self.outputs = backend, backend.name, {}

    def generate(self, prompt, image_path=None, **kwargs):
        text = self.backend.generate(prompt, image_path, **kwargs)
        kind = ("decision" if kwargs.get("json_schema") else
                "narration" if "STRUCTURED FINDINGS" in prompt else "counterfactual")
        self.outputs[kind] = text
        return text


def case_bundle(inp):
    """The explainer bundle through the port's scheduler, and the same three
    calls made one by one on an engine without a scheduler."""
    os.environ.update(json.loads(str(inp["env"])))
    from vis_tpu.agents.explainer import ExplainerAgent
    from vis_tpu.schemas.models import VLMAnalysisResult
    from vis_tpu.serving.tokenizer import ByteTokenizer
    from vis_tpu_torch.serving import engine as E

    cfg = _tiny_llama(inp)
    params = {"text": _params(inp, "params/", cfg)}
    settings = E.ServingSettings(**json.loads(str(inp["settings"])))
    tok = ByteTokenizer(vocab_size=cfg.vocab_size)
    fixture = json.loads(str(inp["fixture"]))
    result = VLMAnalysisResult(**fixture["result"])
    consensus, verdict = fixture["consensus"], fixture["verdict"]

    scheduled = E.Engine("port-scheduled", cfg, params, tok, "cpu", settings)
    scheduled.attach_scheduler()
    batched = _Recorder(E.EngineBackend(scheduled))
    bundle = ExplainerAgent(batched).generate_report_bundle(result, result, consensus, verdict)
    stats = dict(scheduled.scheduler.stats)
    scheduled.detach_scheduler()

    plain = E.Engine("port-plain", cfg, params, tok, "cpu", settings)
    sequential = _Recorder(E.EngineBackend(plain))
    agent = ExplainerAgent(sequential)
    seq = (agent.generate_explanation(result, result, consensus, verdict),
           agent.generate_counterfactual(result, verdict),
           agent.generate_decision_support(consensus["combined_defects"], verdict["verdict"]))
    return {
        "batched": np.array(json.dumps(batched.outputs)),
        "sequential": np.array(json.dumps(sequential.outputs)),
        "bundle": np.array(json.dumps([bundle, seq])),
        "stats": np.array(json.dumps(stats)),
        "room": np.array(json.dumps(_prompt_room(inp, cfg, params, tok, settings))),
    }


def _prompt_room(inp, cfg, params, tok, settings):
    """The prompt length a long prompt is cut to, unbatched and as a
    scheduler hand-off, with the tighter chunk of the bench profile."""
    import dataclasses

    from vis_tpu_torch.serving import engine as E

    chunk, prompt = json.loads(str(inp["tight"]))
    engine = E.Engine("port-room", cfg, params, tok, "cpu",
                      dataclasses.replace(settings, scheduler_decode_chunk=chunk))
    engine.attach_scheduler()
    try:
        return [engine._prefill_request(prompt, None, max_tokens=48, max_image_dim=512,
                                        prompt_only_cache=only)[3] for only in (False, True)]
    finally:
        engine.detach_scheduler()


def case_churn(inp):
    """Prompts through the scheduler's own whole-prompt prefill (submit):
    more requests than slots and than the pool holds at once, then the
    same prompts through the engine's unbatched greedy decode."""
    from vis_tpu.serving.tokenizer import ByteTokenizer
    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.serving.scheduler import ContinuousBatchingScheduler

    cfg = _tiny_llama(inp)
    params = _params(inp, "params/", cfg)
    tok = ByteTokenizer(vocab_size=cfg.vocab_size)
    jobs = json.loads(str(inp["jobs"]))
    sched = ContinuousBatchingScheduler(
        cfg, params, tok, "cpu", **json.loads(str(inp["scheduler"])))
    sched.start()
    requests = [sched.submit(prompt, max_tokens=budget) for prompt, budget in jobs]
    for request in requests:
        while request.out.get(timeout=300) is not None:
            pass
    free_after = [sched.pool.free_pages, sched.pool.n_pages - 1]
    sched.stop()
    engine = E.Engine("port-plain", cfg, {"text": params}, tok, "cpu",
                      E.ServingSettings(max_cache_tokens=512))
    return {
        "scheduled": np.array(json.dumps([tok.decode(r.generated) for r in requests])),
        "errors": np.array(json.dumps([r.error for r in requests])),
        "unbatched": np.array(json.dumps([engine.generate(p, max_tokens=b) for p, b in jobs])),
        "free_pages": np.array(free_after),
        "stats": np.array(json.dumps(sched.stats)),
    }


def case_refusals(inp):
    """Settings the port does not implement raise instead of changing its
    numbers: KV_QUANTIZATION=int8, QUANTIZATION=int8, dense scheduler slots,
    chunked prefill."""
    os.environ.update({"DEV_PROFILE": "small", "QUANTIZATION": "int4",
                       "KV_QUANTIZATION": "int8", "LOG_TO_FILE": "false"})
    from vis_tpu.utils.config import get_config
    from vis_tpu_torch.serving import engine as E

    def refused(call):
        try:
            call()
        except NotImplementedError as exc:
            return str(exc)
        return ""

    out = {}
    for role, model in (("explainer", "meta-llama/Llama-3.1-8B-Instruct"),
                        ("inspector", "Qwen/Qwen2.5-VL-7B-Instruct")):
        out[f"kv_int8/{role}"] = refused(lambda: E.build_engine(role, model, "cpu"))
    os.environ.update({"KV_QUANTIZATION": "none", "QUANTIZATION": "int8"})
    get_config(reload=True)
    out["quantization_int8"] = refused(
        lambda: E.build_engine("explainer", "meta-llama/Llama-3.1-8B-Instruct", "cpu"))
    cfg = _tiny_llama(inp)
    for name, settings in (
            ("dense_scheduler", E.ServingSettings(max_cache_tokens=256, paged_kv_cache=False)),
            ("chunked_prefill", E.ServingSettings(max_cache_tokens=256, paged_kv_cache=True,
                                                  chunked_prefill_tokens=64))):
        engine = E.build_small_text_engine("x", "cpu", 0, "int4", "int8", config=cfg,
                                           settings=settings)
        out[name] = refused(engine.attach_scheduler)
    return {k: np.array(v) for k, v in out.items()}


def main() -> int:
    case, in_path, out_path = sys.argv[1:4]
    inp = np.load(in_path, allow_pickle=False)
    out = globals()[f"case_{case}"](inp)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
