"""Run the PyTorch port on inputs written by a JAX-side test.

    python tests/torch_port_runner.py CASE IN.npz OUT.npz

torch and jax deadlock when both load in one process here, and every
pytest worker imports jax (tests/conftest.py), so the tests compute the
JAX side in-process, write its inputs to IN.npz, and run this script as a
subprocess: it blocks jax and the JAX package (vis_tpu) before anything
else, so any import of either fails loudly, runs the port on the CPU
(every kernel wrapper takes its plain version there) and writes OUT.npz
for the test to compare.  CASE names one function below.
"""

from __future__ import annotations

import sys

sys.modules["jax"] = None  # nothing in this process may load jax
sys.modules["vis_tpu"] = None  # nor the JAX package: the port stands alone

import dataclasses
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
        "TORCH_DEVICE": "cpu",
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
    from vis_tpu_torch.agents import get_inspector
    from vis_tpu_torch.ops import flash_attention as fa
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.orchestration.graph import run_inspection

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
    jax_live = any(sys.modules.get(name) is not None for name in sys.modules
                   if name in ("jax", "vis_tpu") or name.startswith(("jax.", "vis_tpu.")))
    return {
        "verdict": np.array(verdict or ""),
        "analysis_failed": np.array(bool(state["inspector_result"]["analysis_failed"])),
        "backend": np.array(backend.name),
        "raw": np.array(raw[-1] if raw else ""),
        "launches": np.array([qz.q4_matmul_stacked.launches, qz.q4_matmul.launches,
                              fa.flash_attention.launches, qz.q8_matmul.launches,
                              qz.fused_swiglu_mlp.launches]),
        "jax_live": np.array(jax_live),
    }


def case_standalone(inp):
    """The port's copies of the JAX package's device-free modules: the mock
    pipeline on each (image, criticality, domain) case, the constraint
    tables, the byte tokenizer, the host preprocess and the config's
    provider mapping."""
    import tempfile

    workdir = Path(str(inp["workdir"]))
    for key in ("VLM_INSPECTOR_PROVIDER", "VLM_AUDITOR_PROVIDER", "EXPLAINER_PROVIDER",
                "TORCH_DEVICE"):
        os.environ.pop(key, None)
    from vis_tpu_torch.utils import config as cfg

    out = {"defaults": np.array(json.dumps({
        name: getattr(cfg.get_config(reload=True), name) for name in (
            "vlm_inspector_provider", "vlm_auditor_provider", "explainer_provider",
            "torch_device")}))}
    with tempfile.TemporaryDirectory() as tmp:
        mapped = {}
        for provider in ("tpu", "TPU", "cuda", "mock"):
            path = Path(tmp) / f"models_{provider}.yaml"
            path.write_text("\n".join(f"{section}:\n  provider: \"{provider}\""
                                      for section in ("inspector", "auditor", "explainer")))
            mapped[provider] = cfg._load_models_yaml(path)
        out["yaml"] = np.array(json.dumps(mapped))
    os.environ["TORCH_DEVICE"] = "cpu"
    out["torch_device_env"] = np.array(cfg.get_config(reload=True).torch_device)

    os.environ.update({
        "USE_MOCK_RESPONSES": "true", "LOG_TO_FILE": "false",
        "DATABASE_PATH": str(workdir / "inspections.db"),
        "CHAT_HISTORY_DB": str(workdir / "chat.db"), "UPLOAD_DIR": str(workdir / "uploads"),
        "REPORT_DIR": str(workdir / "reports"), "LOG_DIR": str(workdir / "logs"),
    })
    cfg.get_config(reload=True)
    from vis_tpu_torch.agents import reset_agent_cache
    from vis_tpu_torch.orchestration.graph import run_inspection

    reset_agent_cache()
    states = []
    for image, criticality, domain in json.loads(str(inp["cases"])):
        state = run_inspection(image, criticality=criticality, domain=domain,
                               user_notes="standalone parity")
        states.append({k: state.get(k) for k in json.loads(str(inp["fields"]))})
    out["pipeline"] = np.array(json.dumps(states, default=str))

    from vis_tpu_torch.serving.constrained import json_constraint_tables
    from vis_tpu_torch.serving.schema import SCHEMAS, schema_constraint_tables
    from vis_tpu_torch.serving.tokenizer import ByteTokenizer

    vocab = int(inp["vocab"])
    tok = ByteTokenizer(vocab_size=vocab)
    tables = {"json": json_constraint_tables(tok, vocab)}
    tables.update({name: schema_constraint_tables(tok, vocab, name) for name in SCHEMAS})
    for name, table in tables.items():
        for field, value in vars(table).items():
            if value is not None:
                out[f"tables/{name}/{field}"] = np.asarray(value)
    texts = json.loads(str(inp["texts"]))
    out["encode"] = np.array(json.dumps([tok.encode(s) for s in texts]))
    out["decode"] = np.array(json.dumps([tok.decode(ids) for ids in
                                         json.loads(str(inp["ids"]))]))

    from vis_tpu_torch.ops.preprocess import preprocess_image

    for i, (image, max_dim) in enumerate(json.loads(str(inp["preprocess"]))):
        patches = preprocess_image(image, max_image_dim=max_dim)
        out[f"preprocess{i}/patches"] = patches.patches
        out[f"preprocess{i}/grid"] = np.array([patches.grid_t, patches.grid_h, patches.grid_w])

    from vis_tpu_torch.ops.preprocess_mllama import preprocess_image_mllama

    for i, image in enumerate(json.loads(str(inp["preprocess_mllama"]))):
        tiles = preprocess_image_mllama(image)
        out[f"mllama{i}/tiles"] = tiles.tiles
        out[f"mllama{i}/meta"] = np.array([tiles.aspect_ratio_id, tiles.num_tiles])
    return out


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
        "SCHEDULER_DECODE_CHUNK": "48", "LOG_TO_FILE": "false", "TORCH_DEVICE": "cpu",
    })
    from vis_tpu_torch.agents import get_explainer, get_inspector
    from vis_tpu_torch.ops.quantized import QuantizedWeight

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
    from vis_tpu_torch.ops import int_dot
    from vis_tpu_torch.ops import quantized as qz

    gen = torch.Generator().manual_seed(0)
    q = torch.randint(0, 256, (3, 64, 32), generator=gen, dtype=torch.uint8)
    scale = torch.rand((3, 64, 2), generator=gen) * 0.01
    x = torch.randn((4, 64), generator=gen)
    qkv = [torch.randn((1, 64, 2, 16), generator=gen) for _ in range(3)]
    lengths = torch.tensor([40])
    q8 = torch.randint(-128, 128, (48, 64), generator=gen, dtype=torch.int8)
    s8 = torch.rand((48,), generator=gen) * 0.01
    gu8 = torch.randint(-128, 128, (96, 64), generator=gen, dtype=torch.int8)
    gus = torch.rand((96,), generator=gen) * 0.01
    dn8 = torch.randint(-128, 128, (64, 48), generator=gen, dtype=torch.int8)
    dns = torch.rand((64,), generator=gen) * 0.01
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
        "fused_swiglu_mlp": torch.equal(
            qz.fused_swiglu_mlp(x, qz.QuantizedWeight(gu8, gus), qz.QuantizedWeight(dn8, dns)),
            qz.fused_swiglu_mlp_plain(x, gu8, gus, dn8, dns)),
    }
    # The probe tools' wrappers: scales [2, O] / [L, 2, O] / [1, O], and
    # one layer of slabs of 32 intermediate rows (hidden 64, inter 64).
    s2 = torch.rand((3, 2, 64), generator=gen) * 0.01
    i4 = torch.randint(0, 256, (48, 32), generator=gen, dtype=torch.uint8)
    slabs = qz.repack_slabs(torch.randint(0, 256, (2, 128, 32), generator=gen, dtype=torch.uint8),
                            torch.rand((2, 2, 128), generator=gen) * 0.01,
                            torch.randint(0, 256, (2, 64, 32), generator=gen, dtype=torch.uint8),
                            torch.rand((2, 2, 64), generator=gen) * 0.01, 32)
    same.update({
        "q4_matmul_folded": torch.equal(qz.q4_matmul_folded(x, q[1], s2[1]),
                                        qz.q4_matmul_folded_plain(x, q[1], s2[1])),
        "q4_matmul_stacked_folded": torch.equal(qz.q4_matmul_stacked_folded(x, q, s2, 2),
                                                qz.q4_matmul_folded_plain(x, q[2], s2[2])),
        "i4_matmul": torch.equal(qz.i4_matmul(x, i4, s8[None]), qz.i4_matmul_plain(x, i4, s8[None])),
        "q4_fused_mlp_slab": torch.equal(qz.q4_fused_mlp_slab(x, *slabs, 1),
                                         qz.q4_fused_mlp_slab_plain(x, *slabs, 1)),
    })
    # The int8 probe's wrappers: int8 x, int8 / split-half int4 q.
    x8 = torch.randint(-127, 128, (4, 64), generator=gen, dtype=torch.int8)
    s1 = torch.rand((1, 48), generator=gen) * 0.01
    same.update({
        "u8_sum": torch.equal(int_dot.u8_sum(i4), int_dot.u8_sum_plain(i4)),
        "i8_matmul": torch.equal(int_dot.i8_matmul(x8, q8, s1),
                                 int_dot.i8_matmul_plain(x8, q8, s1)),
        "q4_i8_matmul": torch.equal(int_dot.q4_i8_matmul(x8, i4, s2[0, :, :48]),
                                    int_dot.q4_i8_matmul_plain(x8, i4, s2[0, :, :48])),
        "q4_i8s_matmul": torch.equal(int_dot.q4_i8s_matmul(x8, i4, s2[0, :, :48]),
                                     int_dot.q4_i8s_matmul_plain(x8, i4, s2[0, :, :48])),
    })
    launches = {name: getattr(qz, name).launches for name in (
        "q4_matmul", "q4_matmul_stacked", "q8_matmul", "fused_swiglu_mlp", "q4_matmul_folded",
        "q4_matmul_stacked_folded", "i4_matmul", "q4_fused_mlp_slab")}
    launches.update({name: getattr(int_dot, name).launches for name in (
        "u8_sum", "i8_matmul", "q4_i8_matmul", "q4_i8s_matmul")})
    launches["flash_attention"] = fa.flash_attention.launches
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


def _slab_bound(x, gq2, gs2, dq2, ds2, idx):
    """max_o sum_i |act_i * w_oi| for probe kernel H on layer ``idx``: act
    from the plain version, w the down weight as the slab layout's scales
    apply it."""
    from vis_tpu_torch.ops import quantized as qz

    act = qz.q4_slab_act_plain(x, gq2[idx], gs2[idx]).to(torch.float32)
    w = torch.cat([qz.unpack_int4(dq, ds.T, torch.float32)
                   for dq, ds in zip(dq2[idx], ds2[idx])], dim=1)
    return (act.abs() @ w.abs().T).max().item()


def _centred_folded(x, q, scale2):
    """The folded function in the order the card's kernel sums it: bf16 x
    times the exact (n - 8), one f32 sum per nibble half, each sum scaled
    after it is complete: (x_lo . (n_lo - 8)) s_lo + (x_hi . (n_hi - 8)) s_hi
    for q [O, half] u8 and scale2 [2, O] -> [B, O] f32."""
    half = q.shape[-1]
    p = q.to(torch.int32)
    xf = x.to(torch.bfloat16).to(torch.float32)
    lo = xf[:, :half] @ ((p & 15) - 8).to(torch.float32).T
    hi = xf[:, half:] @ ((p >> 4) - 8).to(torch.float32).T
    return lo * scale2[0] + hi * scale2[1]


def case_probes(inp):
    """The int4 probe tools' counterparts on the CPU (plain versions): the
    folded pair (F, I, J), kernel A on the probes' layout (G, Q), signed
    int4 (K), the fused slab MLP (H), repack_slabs, pack_int4_adjacent, the
    fused-vs-unfused check with equal and unequal down scales, and each
    probe module run end to end at a tiny shape."""
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.tools import probe_scan_slice, probe_stacked_fused, probe_unpack
    from vis_tpu_torch.tools._probe import swiglu

    out = {}
    gu_q, gu_s, dn_q, dn_s = (_t(inp[k]) for k in ("gu_q", "gu_s", "dn_q", "dn_s"))
    slabs = tuple(_t(inp[f"jax_slab/{k}"]) for k in ("gq2", "gs2", "dq2", "ds2"))
    bi = int(inp["inter_block"])
    for rows in inp["rows"].tolist():
        x, a = _t(inp[f"x{rows}"]), _t(inp[f"a{rows}"])
        out[f"F/{rows}"] = _np(qz.q4_matmul_stacked_folded(x, gu_q, gu_s, 1))
        out[f"G/{rows}"] = _np(qz.q4_matmul_stacked(x, qz.QuantizedWeight4Pick(
            gu_q, gu_s.transpose(1, 2).contiguous(), 1)))
        out[f"Q/{rows}"] = _np(qz.q4_matmul_stacked(a, qz.QuantizedWeight4Pick(
            dn_q, dn_s.transpose(1, 2).contiguous(), 1)))
        out[f"J/{rows}"] = _np(qz.q4_matmul_folded(a, dn_q[0], dn_s[0]))
        out[f"I/{rows}"] = _np(qz.q4_matmul_folded(x, _t(inp["head_q"]), _t(inp["head_s"])))
        out[f"K/{rows}"] = _np(qz.i4_matmul(x, qz.pack_int4_adjacent(_t(inp["k_w"])),
                                            _t(inp["k_s"])))
        out[f"H/{rows}"] = _np(qz.q4_fused_mlp_slab(x, *slabs, 1))
        out[f"H/{rows}/bound"] = np.array(_slab_bound(x, *slabs, 1))
        for label, ds in (("equal", dn_s[:, :1].expand(-1, 2, -1).contiguous()), ("unequal", dn_s)):
            fused = qz.q4_fused_mlp_slab(x, *qz.repack_slabs(gu_q, gu_s, dn_q, ds, bi), 1)
            unfused = qz.q4_matmul_folded(
                swiglu(qz.q4_matmul_folded(x, gu_q[1], gu_s[1])), dn_q[1], ds[1])
            out[f"trap/{label}/{rows}"] = np.array([
                (fused - unfused).abs().max().item(), unfused.abs().max().item(),
                _slab_bound(x, *qz.repack_slabs(gu_q, gu_s, dn_q, ds, bi), 1)])
    head_q, head_s = _t(inp["head_q"]), _t(inp["head_s"])
    inputs = {str(rows): (inp[f"x{rows}"], inp[f"a{rows}"]) for rows in inp["rows"].tolist()}
    inputs["x0"] = (inp["x0"], inp["a0"])  # the probes' constant first input
    for label, (x, a) in inputs.items():
        x, a = _t(x), _t(a)
        out[f"centred/F/{label}"] = _np(_centred_folded(x, gu_q[1], gu_s[1]))
        out[f"centred/J/{label}"] = _np(_centred_folded(a, dn_q[0], dn_s[0]))
        out[f"centred/I/{label}"] = _np(_centred_folded(x, head_q, head_s))
    for name, value in zip(("gq2", "gs2", "dq2", "ds2"), qz.repack_slabs(gu_q, gu_s, dn_q, dn_s, bi)):
        out[f"slab/{name}"] = _np(value)
    out["packed"] = qz.pack_int4_adjacent(inp["k_w"])
    out["unpacked"] = qz.unpack_int4_adjacent(_t(out["packed"])).numpy()

    kw = dict(device="cpu", hidden=256, inter=512, layers=2, steps=1, repeats=1)
    runs = {"scan": probe_scan_slice.run(**kw),
            "unpack": probe_unpack.run(floor_bytes=1 << 16, **kw),
            "fused": probe_stacked_fused.run(vocab=640, inter_block=128, **kw)}
    for module, results in runs.items():
        for key, result in results.items():
            if "first" in result:
                out[f"run/{module}/{key}"] = _np(result["first"])
                out[f"run/{module}/{key}/layer"] = _np(result["layer"])
            out[f"run/{module}/{key}/launches"] = np.array(json.dumps(result["launches"]))
    return out


def case_probe_unpack2(inp):
    """The int8 probe's counterparts on the CPU (plain versions): the byte
    sum (L), int8 x int8 (M), kernel D for N, int4 -> int8 (O, P) with their
    integer sums read through unit scales, quant_act, one layer of each
    variant's body on random x, and the tool run end to end at a tiny shape
    with the weights it drew."""
    from vis_tpu_torch.ops import int_dot
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.tools import _probe, probe_unpack2

    out = {}
    for name in json.loads(str(inp["l_cases"])):
        out[f"L/{name}"] = _np(int_dot.u8_sum(_t(inp[f"l/{name}"])))
    unit = {"lo": torch.tensor([1.0, 0.0]), "hi": torch.tensor([0.0, 1.0])}
    kernels = {"O": int_dot.q4_i8_matmul, "P": int_dot.q4_i8s_matmul}
    for rows in inp["rows"].tolist():
        for w in ("gu", "dn"):
            x8, xb = _t(inp[f"x8/{w}/{rows}"]), _t(inp[f"xb/{w}/{rows}"])
            out[f"M/{w}/{rows}"] = _np(int_dot.i8_matmul(x8, _t(inp[f"m/{w}"]),
                                                         _t(inp[f"m/{w}s"])))
            out[f"N/{w}/{rows}"] = _np(qz.q8_matmul(xb, _t(inp[f"m/{w}"]), _t(inp[f"m/{w}s"])[0]))
            q4, s4 = _t(inp[f"q4/{w}"]), _t(inp[f"q4/{w}s"])
            for key, fn in kernels.items():
                out[f"{key}/{w}/{rows}"] = _np(fn(x8, q4, s4))
                for part, rows_scale in unit.items():
                    s = rows_scale[:, None].expand(2, q4.shape[0]).contiguous()
                    out[f"{key}/{w}/{rows}/{part}"] = _np(fn(x8, q4, s))
    codes, scales = int_dot.quant_act(_t(inp["act"]).to(torch.bfloat16))
    out["quant/codes"], out["quant/scales"] = codes.numpy(), _np(scales)

    body = {"F": lambda h, *w: probe_unpack2.quantized_layer(int_dot.i8_matmul, h, *w),
            "G": probe_unpack2.mixed_layer,
            "H": lambda h, *w: probe_unpack2.quantized_layer(int_dot.q4_i8_matmul, h, *w),
            "I": lambda h, *w: probe_unpack2.quantized_layer(int_dot.q4_i8s_matmul, h, *w)}
    b8 = [_t(inp[f"body/{k}"]) for k in ("gu8", "gs8", "dn8", "ds8")]
    b4 = [_t(inp[f"body/{k}"]) for k in ("gu4", "gs4", "dn4", "ds4")]
    weights = {"F": b8, "G": [b8[0], b8[1][0], b8[2], b8[3][0]], "H": b4, "I": b4}
    for key, fn in body.items():
        out[f"body/{key}"] = _np(fn(_t(inp["body/x"]).to(torch.bfloat16), *weights[key]))

    hidden, inter, layers = 256, 512, 2
    runs = probe_unpack2.run(device="cpu", hidden=hidden, inter=inter, layers=layers, steps=1,
                             repeats=1)
    for key, result in runs.items():
        out[f"run/{key}"], out[f"run/{key}/layer"] = _np(result["first"]), _np(result["layer"])
        out[f"run/{key}/launches"] = np.array(json.dumps(result["launches"]))
    gen = _probe.generator("cpu", 0)
    stack = _probe.int4_stack(gen, hidden, inter, layers)
    for name in ("gu_q", "gu_s", "dn_q", "dn_s"):
        out[f"stack/{name}"] = _np(getattr(stack, name))
    for name, value in zip(("gu8", "gs8", "dn8", "ds8"),
                           probe_unpack2.int8_stack(gen, hidden, inter, layers)):
        out[f"stack/{name}"] = _np(value)
    return out


def case_cuda_kernels(inp):
    """Each kernel against its plain version on the card, at small and ragged
    shapes; on a host without a card it reports why nothing ran."""
    if not torch.cuda.is_available():
        return {"skip": np.array("torch sees no CUDA device")}
    from vis_tpu_torch.ops import flash_attention as fa
    from vis_tpu_torch.ops import int_dot
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
            def run():
                return qz.q4_matmul_stacked(x, qz.QuantizedWeight4Pick(q, scale, layers - 1))
            want = qz.q4_matmul_plain(x, q[layers - 1], scale[layers - 1])
        else:
            # A head's zero padding (q 0, scale 0) in the last 8 rows.
            q[-8:], scale[-8:] = 0, 0.0

            def run():
                return qz.q4_matmul(x, q, scale)
            want = qz.q4_matmul_plain(x, q, scale)
        got = run()
        out[f"q4/{name}"] = np.array([(got - want).abs().max().item(),
                                      want.abs().max().item(), float(torch.equal(got, run()))])
        if not layers:  # B against A on the same weight as a one-layer stack
            as_a = qz.q4_matmul_stacked(x, qz.QuantizedWeight4Pick(q[None], scale[None], 0))
            out[f"q4_b/{name}"] = np.array([got[:, -8:].abs().max().item(),
                                            float(torch.equal(got, as_a))])
    for name, (rows, out_dim, in_dim, padded) in json.loads(str(inp["q8_cases"])).items():
        q = torch.randint(-128, 128, (out_dim, in_dim), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((out_dim,), generator=gen, device=dev) * 0.01
        q[out_dim - padded:], scale[out_dim - padded:] = 0, 0.0
        x = torch.randn((rows, in_dim), generator=gen, device=dev)
        got, want = qz.q8_matmul(x, q, scale), qz.q8_matmul_plain(x, q, scale)
        again = float(torch.equal(got, qz.q8_matmul(x, q, scale)))
        swapped = (qz.q8_matmul(x[[1, 0, *range(2, rows)]], q, scale) - want).abs().max().item() \
            if rows > 1 else 0.0
        out[f"q8/{name}"] = np.array([(got - want).abs().max().item(), want.abs().max().item(),
                                      got[:, out_dim - padded:].abs().max().item()
                                      if padded else 0.0, again, swapped])
    for name, (d, causal, lens, seq) in json.loads(str(inp["flash_cases"])).items():
        q, k, v = (torch.randn((2, seq, 3, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
        got = fa.flash_attention(q, k, v, lengths, causal=causal)
        want = fa.flash_attention_reference(q, k, v, lengths, causal=causal)
        valid = [seq, seq] if lens is None else list(lens)
        empty = [got[b].float().abs().max().item() for b, n in enumerate(valid) if n == 0]
        out[f"flash/{name}"] = np.array([
            fa.row_relative_error(got, want),
            (got.float() - want.float()).abs().max().item(), max(empty, default=0.0),
            float(torch.equal(got, fa.flash_attention(q, k, v, lengths, causal=causal)))])
    # A negative sm_scale, which the wrapper folds into q.
    lengths = torch.tensor([100, 256], dtype=torch.int32, device=dev)
    out["flash_negative_scale"] = np.array(fa.row_relative_error(
        fa.flash_attention(q, k, v, lengths, sm_scale=-0.05),
        fa.flash_attention_reference(q, k, v, lengths, sm_scale=-0.05)))
    for name, (rows, hidden, inter) in json.loads(str(inp["e_cases"])).items():
        gq = torch.randint(-128, 128, (2 * inter, hidden), generator=gen, device=dev,
                           dtype=torch.int8)
        gs = torch.rand((2 * inter,), generator=gen, device=dev) * 0.01
        dq = torch.randint(-128, 128, (hidden, inter), generator=gen, device=dev,
                           dtype=torch.int8)
        ds = torch.rand((hidden,), generator=gen, device=dev) * 0.01
        x = torch.randn((rows, hidden), generator=gen, device=dev).to(torch.bfloat16)
        got = qz.fused_swiglu_mlp(x, qz.QuantizedWeight(gq, gs), qz.QuantizedWeight(dq, ds))
        want = qz.fused_swiglu_mlp_plain(x, gq, gs, dq, ds)
        swapped = qz.fused_swiglu_mlp(
            x, qz.QuantizedWeight(torch.cat([gq[inter:], gq[:inter]]),
                                  torch.cat([gs[inter:], gs[:inter]])),
            qz.QuantizedWeight(dq, ds))
        out[f"e/{name}"] = np.array([
            (got.float() - want.float()).abs().max().item(), want.float().abs().max().item(),
            (swapped.float() - want.float()).abs().max().item(),
            float(torch.equal(got, qz.fused_swiglu_mlp(
                x, qz.QuantizedWeight(gq, gs), qz.QuantizedWeight(dq, ds))))])
    for name, (rows, out_dim, in_dim, layers) in json.loads(str(inp["fold_cases"])).items():
        q = torch.randint(0, 256, (max(layers, 1), out_dim, in_dim // 2), generator=gen,
                          device=dev, dtype=torch.uint8)
        scale = torch.rand((max(layers, 1), 2, out_dim), generator=gen, device=dev) * 0.01
        x = torch.randn((rows, in_dim), generator=gen, device=dev)

        def run(scale):
            if layers:
                return qz.q4_matmul_stacked_folded(x, q, scale, layers - 1)
            return qz.q4_matmul_folded(x, q[0], scale[0])
        got = run(scale)
        want = qz.q4_matmul_folded_plain(x, q[max(layers, 1) - 1], scale[max(layers, 1) - 1])
        swapped = run(scale.flip(1).contiguous())  # the s_lo and s_hi rows exchanged
        out[f"fold/{name}"] = np.array([(got - want).abs().max().item(),
                                        want.abs().max().item(),
                                        float(torch.equal(got, run(scale))),
                                        (swapped - want).abs().max().item()])
    for name, (rows, out_dim, in_dim) in json.loads(str(inp["i4_cases"])).items():
        w = torch.randint(-8, 8, (out_dim, in_dim), generator=gen, device=dev, dtype=torch.int8)
        q = qz.pack_int4_adjacent(w)
        scale = torch.rand((1, out_dim), generator=gen, device=dev) * 0.01
        x = torch.randn((rows, in_dim), generator=gen, device=dev)
        got, want = qz.i4_matmul(x, q, scale), qz.i4_matmul_plain(x, q, scale)
        flipped = qz.i4_matmul(x, (q >> 4) | (q << 4), scale)
        out[f"i4/{name}"] = np.array([(got - want).abs().max().item(), want.abs().max().item(),
                                      (flipped - want).abs().max().item(),
                                      float(torch.equal(got, qz.i4_matmul(x, q, scale)))])
    for name, (rows, hidden, inter, bi, unequal) in json.loads(str(inp["h_cases"])).items():
        stacks = (torch.randint(0, 256, (2, 2 * inter, hidden // 2), generator=gen, device=dev,
                                dtype=torch.uint8),
                  0.01 + torch.rand((2, 2, 2 * inter), generator=gen, device=dev) * 0.01,
                  torch.randint(0, 256, (2, hidden, inter // 2), generator=gen, device=dev,
                                dtype=torch.uint8),
                  0.01 + torch.rand((2, 2, hidden), generator=gen, device=dev) * 0.01)
        slabs = qz.repack_slabs(*stacks, bi)
        if unequal:  # each slab's down scales its own
            slabs = (*slabs[:3], slabs[3] * (0.5 + torch.rand(
                (2, inter // bi, 1, 1), generator=gen, device=dev)))
        x = torch.randn((rows, hidden), generator=gen, device=dev).to(torch.bfloat16)
        got = qz.q4_fused_mlp_slab(x, *slabs, 1)
        want = qz.q4_fused_mlp_slab_plain(x, *slabs, 1)
        gq2 = slabs[0].clone()
        gq2[1, 0] = torch.cat([gq2[1, 0, bi:], gq2[1, 0, :bi]])
        gs2 = slabs[1].clone()
        gs2[1, 0] = torch.cat([gs2[1, 0, :, bi:], gs2[1, 0, :, :bi]], dim=1)
        swapped = qz.q4_fused_mlp_slab(x, gq2, gs2, *slabs[2:], 1)
        out[f"h/{name}"] = np.array([
            (got - want).abs().max().item(), want.abs().max().item(),
            _slab_bound(x, *slabs, 1), (swapped - want).abs().max().item(),
            float(torch.equal(got, qz.q4_fused_mlp_slab(x, *slabs, 1)))])
    _int_dot_cases(inp, gen, out)
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
    x8 = torch.zeros((qz.MAX_KERNEL_ROWS + 1, 64), dtype=torch.int8, device=dev)
    gu = qz.QuantizedWeight(torch.zeros((64, 64), dtype=torch.int8, device=dev),
                            torch.ones((64,), device=dev))
    dn = qz.QuantizedWeight(torch.zeros((64, 32), dtype=torch.int8, device=dev),
                            torch.ones((64,), device=dev))
    for name, call in (("q4_rows", lambda: qz.q4_matmul(x, q, scale)),
                       ("q8_rows", lambda: qz.q8_matmul(x, q8, s8)),
                       ("q8_in16", lambda: qz.q8_matmul(
                           x24, torch.zeros((8, 24), dtype=torch.int8, device=dev), s8)),
                       ("q8_u8", lambda: qz.q8_matmul(x[:2], q8.to(torch.uint8), s8)),
                       ("e_rows", lambda: qz.fused_swiglu_mlp(x, gu, dn)),
                       ("e_shape", lambda: qz.fused_swiglu_mlp(x[:2], gu, gu)),
                       ("e_u8", lambda: qz.fused_swiglu_mlp(
                           x[:2], qz.QuantizedWeight(gu.q.to(torch.uint8), gu.scale), dn)),
                       ("flash_f32", lambda: fa.flash_attention(*qkv)),
                       ("flash_d96", lambda: fa.flash_attention(*qkv96)),
                       ("fold_scale_rows", lambda: qz.q4_matmul_folded(x[:2], q, scale)),
                       ("i4_rows", lambda: qz.i4_matmul(x, q, torch.ones((1, 8), device=dev))),
                       ("h_slab24", lambda: qz.q4_fused_mlp_slab(x[:2], *qz.repack_slabs(
                           torch.zeros((1, 48, 32), dtype=torch.uint8, device=dev),
                           torch.ones((1, 2, 48), device=dev),
                           torch.zeros((1, 64, 12), dtype=torch.uint8, device=dev),
                           torch.ones((1, 2, 64), device=dev), 24), 0)),
                       ("l_misaligned", lambda: int_dot.u8_sum(
                           torch.zeros((64,), dtype=torch.uint8, device=dev)[1:49])),
                       ("m_misaligned", lambda: int_dot.i8_matmul(
                           x8[:2], torch.zeros((8 * 64 + 16,), dtype=torch.int8,
                                               device=dev)[1:8 * 64 + 1].view(8, 64),
                           torch.ones((1, 8), device=dev))),
                       ("m_bf16", lambda: int_dot.i8_matmul(
                           x[:2].to(torch.bfloat16), q8, torch.ones((1, 8), device=dev))),
                       ("o_scale_rows", lambda: int_dot.q4_i8_matmul(
                           x8[:2], q, torch.ones((1, 8), device=dev))),
                       ("p_rows", lambda: int_dot.q4_i8s_matmul(
                           x8, q, torch.ones((2, 8), device=dev)))):
        try:
            call()
            refused[name] = ""
        except (TypeError, ValueError) as exc:
            refused[name] = type(exc).__name__
    out["refused"] = np.array(json.dumps(refused))
    out["launches"] = np.array([qz.q4_matmul.launches, qz.q4_matmul_stacked.launches,
                                fa.flash_attention.launches, qz.q8_matmul.launches,
                                qz.fused_swiglu_mlp.launches, qz.q4_matmul_folded.launches,
                                qz.q4_matmul_stacked_folded.launches, qz.i4_matmul.launches,
                                qz.q4_fused_mlp_slab.launches, int_dot.u8_sum.launches,
                                int_dot.i8_matmul.launches, int_dot.q4_i8_matmul.launches,
                                int_dot.q4_i8s_matmul.launches])
    out["ab_bits"] = np.array(json.dumps(_ab_bits(qz, json.loads(str(inp["ab_cases"])))))
    return out


def _int_dot_cases(inp, gen, out) -> None:
    """The int8 probe's kernels (L, M, O, P) against their plain versions on
    the card: L's value, the library's int32 sum and whether the unwrapped
    sum differs; for M, O (twice) and P (twice) whether each output is
    bit-equal, then whether O with its x halves swapped, and O on P's
    reading, are equal to the plain O and P (they must not be).  An
    extremes case takes x rows all +127, all -127 or +-127 at random, and
    weight rows of one byte 0x00, 0xFF, 0x88 or 0x77, or of those four at
    random."""
    from vis_tpu_torch.ops import int_dot

    dev = gen.device
    for name, (rows, width, fill) in json.loads(str(inp["l_cases"])).items():
        q = (torch.full((rows, width), fill, dtype=torch.uint8, device=dev) if fill >= 0 else
             torch.randint(0, 256, (rows, width), generator=gen, device=dev, dtype=torch.uint8))
        got = int_dot.u8_sum(q)
        out[f"l/{name}"] = np.array([
            float(torch.equal(got, int_dot.u8_sum_plain(q))),
            float(got.item() == torch.sum(q, dtype=torch.int32).item()),
            float(got.item() != q.sum(dtype=torch.int64).item())])
    for name, (rows, out_dim, in_dim, extremes) in json.loads(str(inp["int_cases"])).items():
        half = in_dim // 2
        if extremes:
            sign = torch.randint(0, 2, (rows, in_dim), generator=gen, device=dev) * 2 - 1
            sign[0::3], sign[1::3] = 1, -1
            x8 = (127 * sign).to(torch.int8)
            ends = torch.tensor([0x00, 0xFF, 0x88, 0x77], dtype=torch.uint8, device=dev)
            kind = torch.arange(out_dim, device=dev)[:, None] % 5  # 4: random bytes
            pick = torch.where(kind < 4, kind, torch.randint(0, 4, (out_dim, in_dim),
                                                             generator=gen, device=dev))
            q8 = ends[pick].view(torch.int8)
            q4 = ends[pick[:, :half]].contiguous()
        else:
            x8 = torch.randint(-127, 128, (rows, in_dim), generator=gen, device=dev,
                               dtype=torch.int8)
            q8 = torch.randint(-128, 128, (out_dim, in_dim), generator=gen, device=dev,
                               dtype=torch.int8)
            q4 = torch.randint(0, 256, (out_dim, half), generator=gen, device=dev,
                               dtype=torch.uint8)
        s1 = torch.rand((1, out_dim), generator=gen, device=dev) * 0.01
        s2 = torch.rand((2, out_dim), generator=gen, device=dev) * 0.01
        want_o = int_dot.q4_i8_matmul_plain(x8, q4, s2)
        want_p = int_dot.q4_i8s_matmul_plain(x8, q4, s2)
        got_o = int_dot.q4_i8_matmul(x8, q4, s2)
        swapped = torch.cat([x8[:, half:], x8[:, :half]], dim=1)
        out[f"int/{name}"] = np.array([
            float(torch.equal(int_dot.i8_matmul(x8, q8, s1), int_dot.i8_matmul_plain(x8, q8, s1))),
            float(torch.equal(got_o, want_o)),
            float(torch.equal(int_dot.q4_i8_matmul(x8, q4, s2), want_o)),
            float(torch.equal(int_dot.q4_i8s_matmul(x8, q4, s2), want_p)),
            float(torch.equal(int_dot.q4_i8s_matmul(x8, q4, s2), want_p)),
            float(torch.equal(int_dot.q4_i8_matmul(swapped, q4, s2), want_o)),
            float(torch.equal(got_o, want_p))])


def _ab_bits(qz, cases):
    """SHA-256 of the bytes of kernel B's (layers 0) or kernel A's (the last
    layer) output for each case (rows, out, in, layers), on inputs made with
    numpy from one seed; ``qz`` is the port's quantized module."""
    import hashlib

    dev = torch.device("cuda:0")
    digests = {}
    for name, (rows, out_dim, in_dim, layers) in cases.items():
        rng = np.random.default_rng(5)
        lead = (layers,) if layers else ()
        q = torch.from_numpy(rng.integers(0, 256, (*lead, out_dim, in_dim // 2),
                                          dtype=np.uint8)).to(dev)
        scale = torch.from_numpy((0.01 + 0.005 * rng.standard_normal((*lead, out_dim, 2))
                                  ).astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((rows, in_dim)).astype(np.float32)).to(dev)
        if layers:
            y = qz.q4_matmul_stacked(x, qz.QuantizedWeight4Pick(q, scale, layers - 1))
        else:
            y = qz.q4_matmul(x, q, scale)
        digests[name] = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
    return digests


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


def _flat(tree, prefix, out):
    """A port parameter tree as "/"-joined paths -> numpy, floats as f32."""
    from vis_tpu_torch.ops.quantized import QuantizedWeight

    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    elif isinstance(tree, QuantizedWeight):
        out[f"{prefix}/q"], out[f"{prefix}/scale"] = tree.q.numpy(), tree.scale.numpy()
    else:
        out[prefix] = _np(tree)
    return out


def case_int8_engine(inp):
    """Kernel E's plain version through swiglu_mlp, int8 stacked
    quantization, the int8 layer pick, and the small Qwen2.5-VL text stack
    and small Llama text profile at int8 (prefill, a lookahead window, a
    paged scheduler chunk)."""
    from vis_tpu_torch.models.common import decoder as D
    from vis_tpu_torch.models.common import layers
    from vis_tpu_torch.ops import quantized as qz
    from vis_tpu_torch.serving import engine as E

    out = {}
    for name in json.loads(str(inp["mlp_cases"])):
        x = _t(inp[f"mlp/{name}/x"])
        gateup = qz.QuantizedWeight(_t(inp[f"mlp/{name}/gateup_q"]),
                                    _t(inp[f"mlp/{name}/gateup_scale"]))
        down = qz.QuantizedWeight(_t(inp[f"mlp/{name}/down_q"]),
                                  _t(inp[f"mlp/{name}/down_scale"]))
        out[f"mlp/{name}/fused"] = np.array(qz.fused_mlp_applies(x, gateup, down))
        out[f"mlp/{name}"] = _np(layers.swiglu_mlp(x, {"gateup_proj": gateup,
                                                       "down_proj": down}))

    calls = {"n": 0}
    fused = layers.fused_swiglu_mlp

    def counting(*args, **kwargs):
        calls["n"] += 1
        return fused(*args, **kwargs)

    layers.fused_swiglu_mlp = counting
    seq_len, s_pad, max_len, window, eos, steps = inp["decode_dims"].tolist()
    fused_calls = {}
    for profile, config in (("qwen", E.small_config().text), ("llama", E.small_text_config())):
        flat = {k[len(f"{profile}/float/"):]: inp[k] for k in inp.files
                if k.startswith(f"{profile}/float/")}
        stacked = D.params_from_numpy(flat, config.dtype)
        _flat(D.quantize_stacked_params(stacked, quantize_embeddings=True, mode="int8"),
              f"{profile}/int8", out)
        flat = {k[len(f"{profile}/params/"):]: inp[k] for k in inp.files
                if k.startswith(f"{profile}/params/")}
        params = D.params_from_numpy(flat, config.dtype)
        calls["n"] = 0
        if profile == "qwen":
            stack = params["layers_stacked"]["mlp"]["gateup_proj"]
            pick = D._pick_layer(params["layers_stacked"], 5)["mlp"]["gateup_proj"]
            out["pick"] = np.array(json.dumps({
                "type": type(pick).__name__, "contiguous": pick.q.is_contiguous()
                and pick.scale.is_contiguous(),
                "view": pick.q.data_ptr() == stack.q[5].data_ptr()
                and pick.scale.data_ptr() == stack.scale[5].data_ptr(),
                "equal": torch.equal(pick.q, stack.q[5]) and torch.equal(pick.scale,
                                                                         stack.scale[5])}))
            cache = _cache(config, 1, max_len)
            ids = _t(inp["qwen/ids"]).long()
            logits, cache = D.prefill_scan(config, params,
                                           layers.embed(ids, params["embed_tokens"]),
                                           _t(inp["qwen/positions"]), cache, [seq_len])
            out["qwen/prefill"] = _np(logits)
            tables = {k: _t(inp[f"qwen/tables/{k}"]) for k in
                      ("token_ok", "token_trans", "cost_after", "forced_token", "forced_state")}
            con = D.DecodeConstraint(
                token_ok=tables["token_ok"], token_trans=tables["token_trans"],
                cost_after=tables["cost_after"], state=_t(inp["qwen/con/state"]).long(),
                remaining=_t(inp["qwen/con/remaining"]).long(),
                active=_t(inp["qwen/con/active"]),
                min_remaining=_t(inp["qwen/con/min_remaining"]).long())
            tokens, valid, last, cache, _ = D.decode_loop_lookahead(
                config, params, logits, seq_len, cache, con, tables["forced_token"],
                tables["forced_state"], 1, window, eos_id=eos)
            out.update({"qwen/tokens": tokens.numpy(), "qwen/valid": valid.numpy(),
                        "qwen/window": _np(last), "qwen/lengths": np.array(cache.lengths_host)})
        else:
            con = D.DecodeConstraint(
                *(_t(inp[f"llama/tables/{k}"]) for k in ("token_ok", "token_trans",
                                                          "cost_after")),
                state=_t(inp["llama/con/state"]).long(),
                remaining=_t(inp["llama/con/remaining"]).long(),
                active=_t(inp["llama/con/active"]),
                min_remaining=_t(inp["llama/con/min_remaining"]).long(),
                table_idx=_t(inp["llama/con/table_idx"]).long())
            lengths = _t(inp["llama/lengths"])
            first = []
            for slot, plen in enumerate(lengths.tolist()):
                staging = _cache(config, 1, inp[f"llama/prompt{slot}"].shape[1])
                prompt = _t(inp[f"llama/prompt{slot}"]).long()
                logits, _ = D.prefill_scan(
                    config, params, layers.embed(prompt, params["embed_tokens"]),
                    torch.arange(prompt.shape[1], dtype=torch.int32)[None], staging, [plen])
                first.append(logits)
            out["llama/prefill"] = _np(torch.cat(first))
            pool_k = _t(inp["llama/pool_k"]).to(config.dtype)
            pool_v = _t(inp["llama/pool_v"]).to(config.dtype)
            tokens, last, _, _, out_len, con = D.decode_loop_paged_constrained(
                config, params, _t(inp["llama/first"]), lengths, pool_k, pool_v,
                _t(inp["llama/page_tables"]), lengths, con, steps, eos_id=eos,
                budget=[steps] * len(lengths))
            out.update({"llama/tokens": tokens.numpy(), "llama/chunk": _np(last),
                        "llama/lengths": out_len.numpy(), "llama/state": con.state.numpy()})
        fused_calls[profile] = calls["n"]
    layers.fused_swiglu_mlp = fused
    out["fused_calls"] = np.array(json.dumps(fused_calls))
    return out


def _cache(config, batch, max_len):
    from vis_tpu_torch.models.common.layers import KVCache

    return KVCache.create(config.num_layers, batch, max_len, config.num_kv_heads,
                          config.head_dim_, config.dtype, "cpu")


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
    from vis_tpu_torch.agents.explainer import ExplainerAgent
    from vis_tpu_torch.schemas.models import VLMAnalysisResult
    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.serving.tokenizer import ByteTokenizer

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
    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
    from vis_tpu_torch.serving.tokenizer import ByteTokenizer

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
    numbers: KV_QUANTIZATION=int8, QUANTIZATION=int8 layers under an int4
    vocab head at the target scale, dense scheduler slots, chunked
    prefill.  QUANTIZATION=int8 itself builds int8 engines."""
    os.environ.update({"DEV_PROFILE": "small", "QUANTIZATION": "int4",
                       "KV_QUANTIZATION": "int8", "LOG_TO_FILE": "false"})
    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.utils.config import get_config

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
    os.environ.update({"KV_QUANTIZATION": "none", "QUANTIZATION": "int8",
                       "VOCAB_QUANTIZATION": "same"})
    get_config(reload=True)
    built = {role: E.build_engine(role, model, "cpu") for role, model in (
        ("explainer", "meta-llama/Llama-3.1-8B-Instruct"),
        ("inspector", "Qwen/Qwen2.5-VL-7B-Instruct"))}
    out["int8_built"] = json.dumps({
        role: [type(engine.params["text"][name]).__name__ for name in ("embed_tokens",)]
        + [type(engine.params["text"]["layers_stacked"][name]).__name__
           for name in ("qkv_proj", "o_proj")]
        + [type(w).__name__ for w in engine.params["text"]["layers_stacked"]["mlp"].values()]
        for role, engine in built.items()})
    os.environ.update({"DEV_PROFILE": "target", "EXPLAINER_VOCAB_QUANTIZATION": "int4"})
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


def _same_params(a, b) -> bool:
    """Two parameter trees (dicts, lists, tensors, quantized weights) hold
    equal values."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_params(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_params(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b)
    return type(a) is type(b) and torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)


def case_checkpoint(inp):
    """find_checkpoint on each directory layout under ``root``; build_engine
    under CHECKPOINT_DIR=``served`` (safetensors for both roles' models),
    which it must refuse, and under CHECKPOINT_DIR=``other`` (safetensors
    for another model only), where it must build what the small profile
    builds without any checkpoint."""
    os.environ.update({"DEV_PROFILE": "small", "QUANTIZATION": "int4",
                       "KV_QUANTIZATION": "none", "LOG_TO_FILE": "false"})
    from vis_tpu_torch.models.loader import find_checkpoint
    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.utils.config import get_config

    root = Path(str(inp["root"]))
    out = {}
    for name in json.loads(str(inp["layouts"])):
        found = find_checkpoint(str(inp["model"]), root / name)
        out[f"found/{name}"] = "" if found is None else str(found.relative_to(root / name))
    models = json.loads(str(inp["models"]))
    os.environ["CHECKPOINT_DIR"] = str(inp["served"])
    get_config(reload=True)
    for role, model in models.items():
        try:
            E.build_engine(role, model, "cpu")
            out[f"refused/{role}"] = ""
        except NotImplementedError as exc:
            out[f"refused/{role}"] = str(exc)
    os.environ["CHECKPOINT_DIR"] = str(inp["other"])
    cfg = get_config(reload=True)
    for role, model in models.items():
        built = E.build_engine(role, model, "cpu")
        settings = E.ServingSettings.from_app_config()
        if role == "inspector":
            plain = E.build_small_engine(role, "cpu", 0, cfg.quantization, E._vocab_mode(role),
                                         settings)
        else:
            plain = E.build_small_text_engine(role, "cpu", 0, cfg.quantization,
                                              E._vocab_mode(role), settings=settings)
        out[f"unchanged/{role}"] = json.dumps(
            [built.name == plain.name, _same_params(built.params, plain.params)])
    return {k: np.array(v) for k, v in out.items()}


def _mllama_logits(config, params, ids, cross_kv, table=None):
    """Logits of ids [1, s] through text_forward (causal mask, no cache),
    the embedding gathered from ``table`` or else the tree's own table."""
    from vis_tpu_torch.models.common.layers import causal_mask, embed
    from vis_tpu_torch.models.llama.mllama import mllama_logits, text_forward

    s = ids.shape[1]
    embeds = embed(ids, params["text"]["embed_tokens"] if table is None else table)
    hidden, _ = text_forward(config, params, embeds, torch.arange(s, dtype=torch.int32)[None],
                             cross_kv, mask=causal_mask(s, s))
    return mllama_logits(config, params, hidden)


def case_mllama(inp):
    """The tiny Mllama: tower, cross K/V, text-only and multimodal logits,
    cached decode, fused vs unfused, quantized bytes and logits."""
    from vis_tpu_torch.models.common.layers import KVCache, causal_mask, embed, length_mask
    from vis_tpu_torch.models.llama import mllama as M
    from vis_tpu_torch.ops.quantized import QuantizedWeight, QuantizedWeight4

    config = M.MllamaConfig.tiny()
    tc = config.text

    def params_of(prefix):
        flat = {k[len(prefix):]: inp[k] for k in inp.files if k.startswith(prefix)}
        return M.from_jax_numpy(flat, config)

    params = params_of("params/")
    out = {}
    vision = M.vision_forward(config.vision, params, _t(inp["pixels"]),
                              int(inp["aspect_ratio_id"]), _t(inp["tile_mask"]))
    out["vision"] = _np(vision)
    cross_kv = M.compute_cross_kv(config, params, vision)
    for i, (k, v) in enumerate(cross_kv):
        out[f"cross{i}/k"], out[f"cross{i}/v"] = _np(k), _np(v)
    text_ids, mm_ids = _t(inp["text_ids"]).long(), _t(inp["mm_ids"]).long()
    out["text_logits"] = _np(_mllama_logits(config, params, text_ids, None))
    out["mm_logits"] = _np(_mllama_logits(config, params, mm_ids, cross_kv))

    # Cached decode: prefill a prefix into the cache, then one token a step.
    prefix, s = int(inp["prefix"]), mm_ids.shape[1]
    table = params["text"]["embed_tokens"]
    cache = KVCache.create(len(config.self_layer_indices), 1, 32, tc.num_kv_heads,
                           tc.head_dim_, tc.dtype, "cpu")
    mask = causal_mask(prefix, 32) + length_mask(32, torch.tensor([prefix]))
    hidden, cache = M.text_forward(config, params, embed(mm_ids[:, :prefix], table),
                                   torch.arange(prefix, dtype=torch.int32)[None], cross_kv,
                                   cache=cache, mask=mask)
    cache.set_lengths([prefix])
    cached = [M.mllama_logits(config, params, hidden)[0, -1]]
    for t in range(prefix, s):
        hidden, cache = M.text_forward(config, params, embed(mm_ids[:, t:t + 1], table),
                                       torch.tensor([[t]], dtype=torch.int32), cross_kv,
                                       cache=cache, mask=cache.decode_mask())
        cached.append(M.mllama_logits(config, params, hidden)[0, -1])
    out["cached_logits"] = _np(torch.stack(cached))

    # Fused against unfused, plain and int8; cross layers keep k/v apart.
    layout_ok = True
    for variant, base in (("plain", params), ("int8", M.quantize_mllama_params(params, "int8"))):
        fused = M.fuse_mllama_projections(config, base)
        for idx, layer in enumerate(fused["text"]["layers"]):
            cross = idx in config.cross_attention_layers
            layout_ok &= (("qkv_proj" in layer) != cross and ("k_proj" in layer) == cross
                          and "gateup_proj" in layer["mlp"])
        for name, tree in (("fused", fused), ("unfused", base)):
            out[f"{name}/{variant}"] = _np(_mllama_logits(
                config, tree, mm_ids, M.compute_cross_kv(config, tree, vision), table))
    out["fused_layout_ok"] = np.array(layout_ok)

    for mode in ("int4", "int8"):
        carried = params_of(f"{mode}/params/")
        ours = M.quantize_mllama_params(M.fuse_mllama_projections(config, params), mode=mode)
        differ = []

        def compare(a, b, path):
            if isinstance(a, dict):
                for k in a:
                    compare(a[k], b[k], f"{path}/{k}")
            elif isinstance(a, list):
                for i, (x, y) in enumerate(zip(a, b)):
                    compare(x, y, f"{path}/{i}")
            elif isinstance(a, (QuantizedWeight, QuantizedWeight4)):
                if not (type(a) is type(b) and torch.equal(a.q, b.q)
                        and torch.equal(a.scale, b.scale)):
                    differ.append(path)

        compare(carried["text"], ours["text"], "text")
        out[f"{mode}/bytes_equal"] = np.array(not differ)
        out[f"{mode}/bytes_differ"] = np.array(" ".join(differ))
        kv = M.compute_cross_kv(config, carried, vision)
        out[f"{mode}/mm_logits"] = _np(_mllama_logits(config, carried, mm_ids, kv, table))
        out[f"{mode}/mm_logits_qembed"] = _np(_mllama_logits(config, carried, mm_ids, kv))
    return out


def _config_from_json(data):
    """An MllamaConfig from the JSON of its fields (dtypes by name)."""
    from vis_tpu_torch.models.common.decoder import DecoderConfig
    from vis_tpu_torch.models.llama.mllama import MllamaConfig, MllamaVisionConfig

    def dtype(name):
        return getattr(torch, name)

    vision = dict(data["vision"], dtype=dtype(data["vision"]["dtype"]))
    vision["intermediate_layers_indices"] = tuple(vision["intermediate_layers_indices"])
    text = dict(data["text"], dtype=dtype(data["text"]["dtype"]))
    if text["rope_scaling"] is not None:
        text["rope_scaling"] = tuple(tuple(item) for item in text["rope_scaling"])
    return MllamaConfig(vision=MllamaVisionConfig(**vision), text=DecoderConfig(**text),
                        cross_attention_layers=tuple(data["cross_attention_layers"]),
                        image_token_id=data["image_token_id"], eos_token_id=data["eos_token_id"])


def _config_to_json(config) -> str:
    """The inverse of _config_from_json, in the JAX side's format."""
    def plain(value):
        if isinstance(value, dict):
            return {k: plain(v) for k, v in value.items()}
        if isinstance(value, (tuple, list)):
            return [plain(v) for v in value]
        if isinstance(value, torch.dtype):
            return str(value).replace("torch.", "")
        return value

    return json.dumps(plain(dataclasses.asdict(config)))


def _quantized_leaves(a, b, path, differ):
    """Walks two trees; returns the number of quantized leaves of ``a`` and
    records in ``differ`` every path whose leaf type or bytes differ."""
    from vis_tpu_torch.ops.quantized import QuantizedWeight, QuantizedWeight4

    if isinstance(a, dict):
        if a.keys() != b.keys():
            differ.append(f"{path} keys")
            return 0
        return sum(_quantized_leaves(a[k], b[k], f"{path}/{k}", differ) for k in a)
    if isinstance(a, list):
        return sum(_quantized_leaves(x, y, f"{path}/{i}", differ)
                   for i, (x, y) in enumerate(zip(a, b)))
    if type(a) is not type(b):
        differ.append(f"{path} {type(a).__name__} != {type(b).__name__}")
        return 0
    if isinstance(a, (QuantizedWeight, QuantizedWeight4)):
        if not (torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)):
            differ.append(path)
        return 1
    if not torch.equal(a, b):
        differ.append(path)
    return 0


def case_engine_mllama(inp):
    """The Mllama engine on the tiny engine config (greedy, sampled with
    replayed uniforms, free-form), device tiles, vision quantization,
    configs, routing, refusals and the pipeline with the auditor on the
    port."""
    from vis_tpu_torch.models.common.decoder import params_from_numpy
    from vis_tpu_torch.models.llama.mllama import MllamaConfig, from_jax_numpy
    from vis_tpu_torch.ops.frame_cache import get_frame
    from vis_tpu_torch.ops.preprocess_mllama_device import preprocess_frame_mllama_device
    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.serving.engine_mllama import (
        MllamaEngine,
        MllamaEngineBackend,
        small_mllama_config,
    )
    from vis_tpu_torch.serving.tokenizer import ByteTokenizer

    out = {}
    config = _config_from_json(json.loads(str(inp["config"])))
    flat = {k[len("params/"):]: inp[k] for k in inp.files if k.startswith("params/")}
    max_cache, decode_chunk, window = inp["settings"].tolist()
    settings = E.ServingSettings(max_cache_tokens=max_cache, decode_chunk=decode_chunk,
                                 lookahead=window, device_preprocess=False, min_json_tokens=0)
    tok = ByteTokenizer(vocab_size=config.text.vocab_size)
    decode = tok.decode

    def recording(ids):  # the engine's final decode is the whole generation
        tok.last = list(ids)
        return decode(ids)

    tok.decode = recording
    engine = MllamaEngine("tiny-mllama", config, from_jax_numpy(flat, config), tok, "cpu",
                          settings)
    uniforms = _t(inp["uniforms"])
    for mode, (with_image, kwargs) in json.loads(str(inp["modes"])).items():
        if kwargs["temperature"] > 0:
            replay = iter(uniforms)
            engine._uniforms = lambda: (lambda shape: next(replay))
        out[f"{mode}/text"] = np.array(engine.generate(
            str(inp["prompt"]), str(inp["image"]) if with_image else None, **kwargs))
        out[f"{mode}/tokens"] = np.array(tok.last, np.int64)

    for i, path in enumerate(json.loads(str(inp["tile_images"]))):
        tiles = preprocess_frame_mllama_device(torch.from_numpy(get_frame(path).copy()))
        out[f"tiles{i}/device"] = _np(tiles.tiles)
        out[f"tiles{i}/meta"] = np.array([tiles.aspect_ratio_id, tiles.num_tiles])

    old_keys = frozenset({"qkv", "proj", "fc1", "fc2", "patch_embed", "gate_proj", "up_proj",
                          "down_proj"})
    for tower in ("qwen", "mllama"):
        def tree(kind):
            prefix = f"towers/{tower}/{kind}/"
            return params_from_numpy({k[len(prefix):]: inp[k] for k in inp.files
                                      if k.startswith(prefix)}, torch.float32)

        plain = tree("float")
        for mode in ("int4", "int8"):
            differ = []
            ours = E._quantize_vision_tree(plain, mode)
            count = _quantized_leaves(tree(mode), ours, tower, differ)
            out[f"towers/{tower}/{mode}/equal"] = np.array(not differ)
            out[f"towers/{tower}/{mode}/differ"] = np.array(" ".join(differ))
            out[f"towers/{tower}/{mode}/quantized"] = np.array(count)
            if tower == "qwen":
                keys, E._VISION_QUANT_KEYS = E._VISION_QUANT_KEYS, old_keys
                before = E._quantize_vision_tree(plain, mode)
                E._VISION_QUANT_KEYS = keys
                same = []
                _quantized_leaves(before, ours, tower, same)
                out["towers/qwen/unchanged"] = np.array(
                    not same and bool(out.get("towers/qwen/unchanged", True)))

    from vis_tpu_torch.ops.quantized import QuantizedWeight, QuantizedWeight4
    from vis_tpu_torch.serving.engine_mllama import _random_target_params

    def layout(tree, path, acc):
        if isinstance(tree, dict):
            for k, v in tree.items():
                layout(v, f"{path}/{k}", acc)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                layout(v, f"{path}/{i}", acc)
        elif isinstance(tree, (QuantizedWeight, QuantizedWeight4)):
            layout(tree.q, f"{path}/q", acc)
            layout(tree.scale, f"{path}/scale", acc)
        else:
            acc[path] = [list(tree.shape), str(tree.dtype).replace("torch.", "")]
        return acc

    layout_config = _config_from_json(json.loads(str(inp["layout_config"])))
    for mode in ("int4", "int8"):
        tree = _random_target_params(layout_config, torch.Generator().manual_seed(0), "cpu", mode)
        out[f"layout/{mode}"] = np.array(json.dumps(layout(tree, "", {})))
    out["configs/target"] = np.array(_config_to_json(MllamaConfig.llama32_11b_vision()))
    out["configs/small"] = np.array(_config_to_json(small_mllama_config()))
    out["jax_configs"] = inp["jax_configs"]

    workdir = Path(str(inp["workdir"]))
    model = "meta-llama/Llama-3.2-11B-Vision-Instruct"
    os.environ.update({
        "DEV_PROFILE": "small", "QUANTIZATION": "int4", "VOCAB_QUANTIZATION": "int4",
        "KV_QUANTIZATION": "none", "LOG_TO_FILE": "false", "TORCH_DEVICE": "cpu",
        "CHECKPOINT_DIR": str(workdir / "no_checkpoints"),
    })
    from vis_tpu_torch.utils.config import get_config

    get_config(reload=True)
    built = E.build_engine("auditor", model, "cpu")
    layers = built.params["text"]["layers"]
    out["routing"] = np.array(json.dumps({
        "type": type(built).__name__, "name": built.name,
        "backend": MllamaEngineBackend(built).name,
        "layer0": type(layers[0]["qkv_proj"]).__name__,
        "cross_q": type(layers[1]["q_proj"]).__name__,
        "vision_q": type(built.params["local_layers"][0]["q_proj"]).__name__}))

    def refused(call, errors=(NotImplementedError,)):
        try:
            call()
        except errors as exc:
            return str(exc)
        return ""

    os.environ["KV_QUANTIZATION"] = "int8"
    get_config(reload=True)
    out["refused/kv_int8"] = np.array(refused(lambda: E.build_engine("auditor", model, "cpu")))
    os.environ["KV_QUANTIZATION"] = "none"
    served = workdir / "checkpoints" / model.split("/")[-1]
    served.mkdir(parents=True)
    (served / "model.safetensors").write_bytes(b"")
    os.environ["CHECKPOINT_DIR"] = str(workdir / "checkpoints")
    get_config(reload=True)
    out["refused/checkpoint"] = np.array(refused(lambda: E.build_engine("auditor", model, "cpu")))
    os.environ.update({"CHECKPOINT_DIR": str(workdir / "no_checkpoints"), "TORCH_DEVICE": "cuda:0",
                       "VLM_AUDITOR_PROVIDER": "cuda", "USE_MOCK_RESPONSES": "false"})
    get_config(reload=True)
    from vis_tpu_torch import agents

    agents.reset_agent_cache()
    out["refused/no_cuda"] = np.array(refused(agents.get_auditor, (RuntimeError,)))
    out["refused/no_room"] = np.array(refused(lambda: engine.generate(
        "audit this part", None, max_tokens=max_cache - 1), (RuntimeError,)))
    out["health"] = np.array(engine.health_check())

    os.environ.update({
        "VLM_INSPECTOR_PROVIDER": "mock", "VLM_AUDITOR_PROVIDER": "cuda",
        "EXPLAINER_PROVIDER": "mock", "TORCH_DEVICE": "cpu", "CONSTRAINED_SCHEMA": "true",
        "CONSTRAINED_LOOKAHEAD": "8", "DEVICE_PREPROCESS": "true",
        "VLM_AUDITOR_MAX_TOKENS": "160", "VLM_AUDITOR_MIN_TOKENS": "150",
        "KV_CACHE_MAX_TOKENS": "2560",
        "DATABASE_PATH": str(workdir / "inspections.db"),
        "CHAT_HISTORY_DB": str(workdir / "chat.db"), "UPLOAD_DIR": str(workdir / "uploads"),
        "REPORT_DIR": str(workdir / "reports"), "LOG_DIR": str(workdir / "logs"),
    })
    get_config(reload=True)
    agents.reset_agent_cache()
    from vis_tpu_torch.orchestration.graph import run_inspection

    backend = agents.get_auditor().backend
    raw = []
    generate = backend.generate

    def recording_generate(*args, **kwargs):
        raw.append(generate(*args, **kwargs))
        return raw[-1]

    backend.generate = recording_generate
    state = run_inspection(str(inp["image"]), criticality="high", domain="general",
                           user_notes="port auditor pipeline test")
    out["pipeline/auditor_result"] = np.array(json.dumps(state["auditor_result"], default=str))
    out["pipeline/raw"] = np.array(raw[-1] if raw else "")
    out["pipeline/backend"] = np.array(backend.name)
    return out


def _decoder_config(text: str):
    """A port DecoderConfig, f32, from the JSON of a JAX one's fields."""
    from vis_tpu_torch.models.common.decoder import DecoderConfig

    fields = json.loads(text)
    for name in ("mrope_section", "rope_scaling"):
        if fields[name] is not None:
            fields[name] = tuple(tuple(v) if isinstance(v, list) else v for v in fields[name])
    return DecoderConfig(**fields, dtype=torch.float32)


def _subtree(inp, prefix):
    """The entries of ``inp`` under ``prefix``, keyed by the rest of their path."""
    return {k[len(prefix):]: inp[k] for k in inp.files if k.startswith(prefix)}


def _recording_tokenizer(vocab):
    from vis_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer(vocab_size=vocab)
    decode = tok.decode

    def recording(ids):  # a request's final decode is the whole generation
        tok.last = list(ids)
        return decode(ids)

    tok.decode = recording
    return tok


def _decode_loops(inp, out):
    """The dense decode loops from one two-row prefill, mode by mode."""
    from vis_tpu_torch.models.common.decoder import (
        DecodeConstraint,
        decode_loop_scan,
        decode_loop_scan_constrained,
        decode_loop_scan_sampled,
        params_from_numpy,
        prefill_scan,
    )
    from vis_tpu_torch.models.common.layers import KVCache, embed

    ids = _t(inp["loops/ids"]).long()
    prompts = [21, 34]
    tables = {k: _t(inp[f"loops/tables/{k}"]) for k in ("token_ok", "token_trans",
                                                         "cost_after")}
    for profile in ("qwen", "llama"):
        cfg = _decoder_config(str(inp[f"loops/{profile}/config"]))
        for variant in ("f32", "int4", "int8"):
            prefix = f"loops/{profile}/{variant}"
            params = params_from_numpy(_subtree(inp, f"{prefix}/params/"), torch.float32)
            steps = int(inp[f"{prefix}/steps"])
            modes = [k.split("/")[-2] for k in inp.files
                     if k.startswith(prefix + "/") and k.endswith("/exit")]
            for mode in modes:
                cache = KVCache.create(cfg.num_layers, len(prompts), 128, cfg.num_kv_heads,
                                       cfg.head_dim_, cfg.dtype, "cpu")
                positions = torch.arange(ids.shape[1], dtype=torch.int32)[None].expand(2, -1)
                logits, cache = prefill_scan(cfg, params, embed(ids, params["embed_tokens"]),
                                             positions, cache, prompts)
                eos, b0, b1 = inp[f"{prefix}/{mode}/exit"].tolist()
                kwargs = dict(eos_id=eos, budget=None if b0 < 0 else [b0, b1])
                uniforms = iter(_t(inp["loops/uniforms"]))
                draw = lambda shape: next(uniforms)  # noqa: E731
                start = torch.tensor(prompts, dtype=torch.int32)
                if mode.startswith("constrained"):
                    con = DecodeConstraint(
                        **tables, state=torch.full((2,), int(inp["loops/init_state"])),
                        remaining=torch.tensor([160, 150]), active=torch.ones(2, dtype=torch.bool),
                        min_remaining=torch.tensor([60, 150]))
                    if mode == "constrained_sampled":
                        kwargs.update(draw_uniforms=draw, temperature=0.7)
                    tokens, last, cache, con = decode_loop_scan_constrained(
                        cfg, params, logits, start, cache, con, steps, **kwargs)
                    out[f"{prefix}/{mode}/state"] = con.state.numpy()
                elif mode == "sampled":
                    tokens, last, cache = decode_loop_scan_sampled(
                        cfg, params, logits, start, cache, draw, torch.tensor([0.7, 0.0]), steps,
                        **kwargs)
                else:
                    tokens, last, cache = decode_loop_scan(cfg, params, logits, start, cache,
                                                           steps, **kwargs)
                out[f"{prefix}/{mode}/tokens"] = tokens.numpy()
                out[f"{prefix}/{mode}/logits"] = _np(last)
                out[f"{prefix}/{mode}/lengths"] = cache.lengths.numpy()
                out[f"{prefix}/{mode}/lengths_host"] = np.array(cache.lengths_host)


def _decode_engines(inp, out):
    """Engine.generate (Qwen2.5-VL with an image, Llama text) and the
    Mllama loop engine in each mode, sampled requests on the JAX engines'
    replayed uniforms; then each engine's health check."""

    from vis_tpu_torch.models.llama.config import llama_tiny
    from vis_tpu_torch.models.llama.model import from_jax_numpy as llama_params
    from vis_tpu_torch.models.llama.mllama import from_jax_numpy as mllama_params
    from vis_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig
    from vis_tpu_torch.models.qwen2_5_vl.model import from_jax_numpy as qwen_params
    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.serving.engine_mllama import MllamaEngine

    vocab = int(inp["vocab"])
    max_cache, _, max_image_dim = inp["settings"].tolist()
    modes = json.loads(str(inp["engines/modes"]))
    engines = {"qwen": ("greedy", "sampled", "schema", "schema_sampled"),
               "llama": tuple(modes),
               "mllama": ("greedy", "sampled", "schema", "schema_sampled")}
    qwen_cfg = dataclasses.replace(Qwen25VLConfig.tiny(), image_token_id=261,
                                   vision_start_token_id=259, vision_end_token_id=260,
                                   eos_token_id=256)
    llama_cfg = dataclasses.replace(llama_tiny(), vocab_size=vocab)
    mllama_cfg = _config_from_json(json.loads(str(inp["engines/mllama_config"])))

    def build(profile, tok, chunk):
        settings = E.ServingSettings(max_cache_tokens=max_cache, decode_chunk=chunk, lookahead=0,
                                     device_preprocess=False, min_json_tokens=0)
        flat = _subtree(inp, f"engines/{profile}/params/")
        if profile == "qwen":
            return E.Engine("tiny-qwen", qwen_cfg, qwen_params(flat, qwen_cfg), tok, "cpu",
                            settings)
        if profile == "llama":
            return E.Engine("tiny-llama", llama_cfg, {"text": llama_params(flat, llama_cfg)},
                            tok, "cpu", settings)
        return MllamaEngine("tiny-mllama", mllama_cfg, mllama_params(flat, mllama_cfg), tok,
                            "cpu", settings)

    for profile, names in engines.items():
        for name in names:
            with_image, chunk, kwargs = modes[name]
            tok = _recording_tokenizer(vocab)
            engine = build(profile, tok, chunk)
            if kwargs["temperature"] > 0:
                replay = iter(_t(inp["engines/uniforms"]))
                engine._uniforms = lambda: (lambda shape: next(replay))
            text = engine.generate(str(inp["prompt"]),
                                   str(inp["engines/image"]) if with_image else None,
                                   max_image_dim=max_image_dim, **kwargs)
            out[f"engines/{profile}/{name}/text"] = np.array(text)
            out[f"engines/{profile}/{name}/tokens"] = np.array(tok.last, np.int64)
        if profile in ("llama", "mllama"):
            engine = build(profile, _recording_tokenizer(vocab), 5)
            out[f"health/{profile}"] = np.array([int(engine.health_check()),
                                                 engine.last_decode_tokens])


def _decode_chat(inp, out):
    """Two turns on one session (the tokenizer's EOS, then an EOS the first
    reply emits), the follow-up against a re-prefill, the session budget
    and the engine's token counters."""
    from vis_tpu_torch.models.llama.model import from_jax_numpy
    from vis_tpu_torch.serving import engine as E

    cfg = _decoder_config(str(inp["chat/config"]))
    _, chat_tokens, _ = inp["settings"].tolist()
    settings = E.ServingSettings(max_cache_tokens=512, decode_chunk=5, lookahead=0,
                                 min_json_tokens=0)
    tok = _recording_tokenizer(cfg.vocab_size)
    engine = E.Engine("chat", cfg, {"text": from_jax_numpy(_subtree(inp, "chat/params/"), cfg)},
                      tok, "cpu", settings)
    system, turns = str(inp["chat/system"]), json.loads(str(inp["chat/turns"]))
    replies = []  # the plain session's reply ids
    for kind in ("plain", "eos"):
        if kind == "eos":
            tok.eos_id = int(inp["chat/eos"])
        session = engine.chat_start(system)
        total = engine.decode_tokens_total
        for turn, question in enumerate(turns):
            text = "".join(engine.chat_turn(session, question, max_tokens=chat_tokens))
            key = f"chat/{kind}/turn{turn}"
            out[f"{key}/text"] = np.array(text)
            out[f"{key}/tokens"] = np.array(tok.last, np.int64)
            out[f"{key}/state"] = np.array([session.position, session.cache.lengths_host[0]])
            if int(session.cache.lengths[0]) != session.cache.lengths_host[0]:
                raise AssertionError("the session's host cursor left its device cursor")
            if kind == "plain":
                replies.append(list(tok.last))
        if kind == "plain":
            out["chat/counts"] = np.array([engine.last_decode_tokens,
                                           engine.decode_tokens_total - total])
    tok.eos_id = 256
    # The transcript as ids: a reply's bytes need not be valid UTF-8, and
    # ids past the bytes decode to nothing, so its text would not re-encode
    # to the ids the session holds.
    transcript = (tok.encode(system) + tok.encode(f"\nUser: {turns[0]}\nAssistant:")
                  + replies[0] + tok.encode(f"\nUser: {turns[1]}\nAssistant:"))
    encode = tok.encode
    tok.encode = lambda text: transcript if text == "<transcript>" else encode(text)
    engine.generate("<transcript>", max_tokens=chat_tokens)
    tok.encode = encode
    out["chat/reprefill"] = np.array(tok.last, np.int64)
    try:
        next(engine.chat_turn(engine.chat_start("ctx"), "q" * 2000, max_tokens=500))
        out["chat/budget"] = np.array("")
    except RuntimeError as exc:
        out["chat/budget"] = np.array(str(exc))


def case_decode_paths(inp):
    """The decode paths of the config's defaults: the dense loops, both
    engines' requests and chat sessions."""
    out = {}
    _decode_loops(inp, out)
    _decode_engines(inp, out)
    _decode_chat(inp, out)
    return out


def case_decode_pipeline(inp):
    """run_inspection on the small profiles with every decode setting at
    the config's default, the process environment replaced by ``env``;
    every backend call recorded with its exception, if any."""
    os.environ.clear()
    os.environ.update(json.loads(str(inp["env"])))
    from vis_tpu_torch import agents
    from vis_tpu_torch.orchestration.graph import run_inspection
    from vis_tpu_torch.utils.config import get_config

    get_config(reload=True)
    agents.reset_agent_cache()
    calls, errors, tokens = [], [], {}
    for role, get in (("inspector", agents.get_inspector), ("auditor", agents.get_auditor)):
        backend = get().backend
        generate = backend.generate

        def recording(*args, _role=role, _generate=generate, _engine=backend.engine, **kwargs):
            calls.append(_role)
            try:
                text = _generate(*args, **kwargs)
            except Exception as exc:
                errors.append(f"{_role}: {exc!r}")
                raise
            tokens[_role] = tokens.get(_role, 0) + _engine.last_decode_tokens
            return text

        backend.generate = recording
    state = run_inspection(str(inp["image"]), criticality="high", domain="general",
                           user_notes="default decode")
    return {"result": np.array(json.dumps({
        "verdict": (state.get("safety_verdict") or {}).get("verdict"),
        "inspector_failed": state["inspector_result"]["analysis_failed"],
        "auditor_failed": state["auditor_result"]["analysis_failed"],
        "errors": errors, "calls": sorted(set(calls)), "tokens": tokens,
    }))}


# ---------------------------------------------------------------------------
# The lookahead window pass (``decoder.WindowPass`` over ``_extend_pass``)
# against the list-driven ``extend_scan`` and ``lookahead_decode`` it
# replaced, kept below as they were as the reference: cursors taken from
# the host mirror, per-row slice writes, the last index and the position
# update sent from host lists, the cursors rebound to a new tensor.
# ---------------------------------------------------------------------------

def _reference_set_lengths(cache, lengths):
    cache.lengths_host = [int(n) for n in lengths]
    cache.lengths = torch.tensor(cache.lengths_host, dtype=torch.int32)


def _reference_extend_scan(config, params, input_embeds, positions, cache, new_lengths):
    from vis_tpu_torch.models.common import decoder as D
    from vis_tpu_torch.models.common.layers import causal_mask, length_mask, rms_norm

    s = input_embeds.shape[1]
    max_len = cache.k.shape[2]
    starts = list(cache.lengths_host)
    assert all(start + s <= max_len for start in starts)
    cos, sin = D._position_tables(config, positions)
    kj = torch.arange(max_len)
    cache_mask = torch.where(
        kj[None, :] < cache.lengths[:, None], 0.0, -1e30
    ).to(torch.float32)[:, None, None, :]
    new_dev = torch.tensor(list(new_lengths), dtype=torch.int32)
    chunk_mask = causal_mask(s, s) + length_mask(s, new_dev)
    stacked = params["layers_stacked"]
    x = input_embeds
    for idx in range(D.num_stacked_layers(stacked)):
        x, k, v = D._layer_body(
            config, x, D._pick_layer(stacked, idx), cos, sin, chunk_mask,
            cache.k[idx], cache.v[idx], cache_mask,
        )
        for row, start in enumerate(starts):
            cache.k[idx, row, start:start + s] = k[row].to(cache.k.dtype)
            cache.v[idx, row, start:start + s] = v[row].to(cache.v.dtype)
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    _reference_set_lengths(cache, [a + n for a, n in zip(starts, new_lengths)])
    rows = torch.arange(x.shape[0])
    last = torch.tensor([max(n - 1, 0) for n in new_lengths])
    return D.lm_logits(config, params, x[rows, last][:, None])[:, 0], cache


def _reference_lookahead_decode(config, params, first_logits, start_position, cache,
                                constraint, forced_token, forced_state, num_windows, window,
                                draw_uniforms=None, temperature=None, eos_id=None):
    from vis_tpu_torch.models.common.decoder import TokenPicker
    from vis_tpu_torch.models.common.layers import embed

    def extend(w_tokens, pos_mat, cache, valid_len):
        embeds = embed(w_tokens, params["embed_tokens"])
        positions = (pos_mat[None].expand(3, *pos_mat.shape)
                     if config.mrope_section is not None else pos_mat)
        return _reference_extend_scan(config, params, embeds, positions, cache, valid_len)

    b = first_logits.shape[0]
    pos = torch.as_tensor(start_position, dtype=torch.int32).expand(b).clone()
    offs = torch.arange(window, dtype=torch.int32)
    fill = eos_id if eos_id is not None else 0
    tokens_out = torch.full((b, num_windows, window), fill, dtype=torch.int64)
    valid_out = torch.zeros((b, num_windows, window), dtype=torch.bool)
    done = torch.zeros((b,), dtype=torch.bool)
    logits = first_logits
    picker = TokenPicker(constraint, draw_uniforms, temperature)
    for win in range(num_windows):
        if eos_id is not None and bool(done.all()):
            break
        t0 = picker(logits)
        con = picker.constraint
        state, remaining = con.state, con.remaining
        alive = torch.ones((b,), dtype=torch.bool)
        chain_toks, chain_ok = [], []
        for _ in range(window - 1):
            ft = forced_token[state.long()]
            ok = alive & (ft >= 0)
            chain_toks.append(torch.where(ok, ft, 0).to(torch.int64))
            chain_ok.append(ok)
            state = torch.where(ok, forced_state[state.long()].to(state.dtype), state)
            remaining = remaining - ok.to(remaining.dtype)
            alive = ok
        picker.constraint = con._replace(state=state, remaining=remaining)
        w_tokens = torch.stack([t0] + chain_toks, dim=1)
        w_valid = torch.stack([torch.ones_like(alive)] + chain_ok, dim=1)
        host = torch.cat([w_tokens, w_valid.to(torch.int64)], dim=1)
        h_tokens, h_valid = host[:, :window], host[:, window:].bool()
        valid_len = h_valid.sum(dim=1).tolist()
        prev_lengths, prev_pos = list(cache.lengths_host), pos
        logits, cache = extend(w_tokens, pos[:, None] + offs[None, :], cache, valid_len)
        pos = pos + torch.tensor(valid_len, dtype=torch.int32)
        if eos_id is not None:
            h_valid = h_valid & ~done[:, None]
            if bool(done.any()):
                frozen = done.tolist()
                _reference_set_lengths(cache, [p if f else n for p, n, f in
                                               zip(prev_lengths, cache.lengths_host, frozen)])
                pos = torch.where(done, prev_pos, pos)
            done = done | (h_valid & (h_tokens == eos_id)).any(dim=1)
        tokens_out[:, win] = h_tokens
        valid_out[:, win] = h_valid
    return tokens_out, valid_out, logits, cache, picker.constraint


def _window_models():
    """(name, config, params): the tiny Qwen2.5-VL text stack (M-RoPE) and
    the tiny Llama (llama3 RoPE scaling) at vocab 512, so the byte
    tokenizer's schema tables fit, in the engines' fused layout."""
    from vis_tpu_torch.models.common.decoder import (
        fuse_stacked_projections,
        init_decoder_params,
        stack_decoder_layers,
    )
    from vis_tpu_torch.models.llama.config import llama_tiny
    from vis_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig

    for name, cfg in (("qwen", Qwen25VLConfig.tiny().text),
                      ("llama", dataclasses.replace(llama_tiny(), vocab_size=512))):
        gen = torch.Generator()
        gen.manual_seed(11)
        params = fuse_stacked_projections(stack_decoder_layers(
            init_decoder_params(cfg, gen, scale=0.2)))
        yield name, cfg, params


def _cache_bytes(cache):
    return {"k": _np(cache.k), "v": _np(cache.v), "lengths": cache.lengths.numpy(),
            "lengths_host": np.array(cache.lengths_host)}


def _window_body(cfg, params, window: int, schedule, frozen_after: int):
    """Two rows at different cursors through windows of ``schedule``'s
    valid lengths, a ``WindowPass`` on one cache and the reference
    extend_scan on its twin; after window ``frozen_after`` row 1 freezes
    (its cursor and position put back, as lookahead_decode does).  Then a
    16-token chunk through extend_scan on both."""
    from vis_tpu_torch.models.common.decoder import WindowPass, extend_scan, prefill_scan
    from vis_tpu_torch.models.common.layers import embed

    b, s_pad, prompt_lengths = 2, 32, [13, 29]
    gen = torch.Generator()
    gen.manual_seed(5)
    ids = torch.randint(0, 256, (b, s_pad), generator=gen)
    new, ref = _cache(cfg, b, 96), _cache(cfg, b, 96)
    for cache in (new, ref):
        prefill_scan(cfg, params, embed(ids, params["embed_tokens"]),
                     torch.arange(s_pad, dtype=torch.int32)[None].expand(b, s_pad), cache,
                     prompt_lengths)
    runner = WindowPass(cfg, params, new, window)
    pos = torch.tensor(prompt_lengths, dtype=torch.int32)
    out = {}
    for w, lens in enumerate(schedule):
        tokens = torch.randint(0, 256, (b, window), generator=gen)
        valid = torch.arange(window)[None, :] < torch.tensor(lens)[:, None]
        pos_mat = pos[:, None] + torch.arange(window, dtype=torch.int32)[None, :]
        prev_lengths, prev_pos = list(new.lengths_host), pos
        out[f"new/logits{w}"] = _np(runner(tokens, valid, pos_mat, new, list(lens))[0])
        ref_pos = pos_mat[None].expand(3, b, window) if cfg.mrope_section else pos_mat
        out[f"ref/logits{w}"] = _np(_reference_extend_scan(
            cfg, params, embed(tokens, params["embed_tokens"]), ref_pos, ref, list(lens))[0])
        pos = pos + valid.sum(dim=1, dtype=torch.int32)
        if w == frozen_after:
            kept = [new.lengths_host[0], prev_lengths[1]]
            new.set_lengths(kept)
            _reference_set_lengths(ref, kept)
            pos = torch.where(torch.tensor([False, True]), prev_pos, pos)
    out["bound"] = np.array(runner.binds(new, params, window))
    chunk = torch.randint(0, 256, (b, 16), generator=gen)
    chunk_pos = pos[:, None] + torch.arange(16, dtype=torch.int32)[None, :]
    if cfg.mrope_section:
        chunk_pos = chunk_pos[None].expand(3, b, 16)
    embeds = embed(chunk, params["embed_tokens"])
    out["new/chunk"] = _np(extend_scan(cfg, params, embeds, chunk_pos, new, [16, 9])[0])
    out["ref/chunk"] = _np(_reference_extend_scan(cfg, params, embeds, chunk_pos, ref,
                                                  [16, 9])[0])
    for side, cache in (("new", new), ("ref", ref)):
        for key, value in _cache_bytes(cache).items():
            out[f"{side}/{key}"] = value
    return out


def _window_decode(cfg, params, rows: int, mode: str, num_windows: int, window: int):
    """One schema request's lookahead decode on both sides, chained call
    after call as ``Engine._lookahead_decode`` chains them (a host
    position, the last logits and the DFA carried over), until every row
    is done: ``decode_loop_lookahead`` (a ``WindowPass`` held by the cache)
    and the reference.  Two rows get budgets far apart, so the first
    freezes while the second decodes on.  Sampled picks draw each side's
    uniforms from a generator seeded alike."""
    from vis_tpu_torch.models.common.decoder import (
        DecodeConstraint,
        decode_loop_lookahead,
        prefill_scan,
    )
    from vis_tpu_torch.models.common.layers import embed
    from vis_tpu_torch.serving.engine import load_constraint_tables, request_uniforms
    from vis_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer(vocab_size=cfg.vocab_size)
    ok_t, trans_t, cost_t, cls_t, tables = load_constraint_tables(
        tok, cfg.vocab_size, "inspection", "cpu")
    forced_tok = torch.from_numpy(tables.forced_token)
    forced_state = torch.from_numpy(tables.forced_state)
    budgets = [tables.min_budget + 8, tables.min_budget + 72][:rows]
    s_pad, prompt_lengths = 32, [24, 31][:rows]
    gen = torch.Generator()
    gen.manual_seed(7)
    ids = torch.randint(0, 256, (rows, s_pad), generator=gen)
    max_len = -(-(s_pad + max(budgets) + 32) // 64) * 64
    out = {}
    for side in ("new", "ref"):
        cache = _cache(cfg, rows, max_len)
        logits, cache = prefill_scan(
            cfg, params, embed(ids, params["embed_tokens"]),
            torch.arange(s_pad, dtype=torch.int32)[None].expand(rows, s_pad), cache,
            prompt_lengths)
        full = torch.full((rows,), tables.init_state, dtype=torch.int64)
        budget = torch.tensor(budgets, dtype=torch.int64)
        con = DecodeConstraint(token_ok=ok_t, token_trans=trans_t, cost_after=cost_t,
                               class_of=cls_t, state=full, remaining=budget,
                               active=torch.ones((rows,), dtype=torch.bool),
                               min_remaining=budget)
        draw = request_uniforms("cpu") if mode == "sampled" else None
        temperature = 0.7 if mode == "sampled" else None
        decode = decode_loop_lookahead if side == "new" else _reference_lookahead_decode
        pos, calls, all_tokens, all_valid = torch.tensor(prompt_lengths), 0, [], []
        done = np.zeros(rows, bool)
        while not done.all():
            tokens, valid, logits, cache, con = decode(
                cfg, params, logits, pos, cache, con, forced_tok, forced_state, num_windows,
                window, draw_uniforms=draw, temperature=temperature, eos_id=tok.eos_id)
            all_tokens.append(tokens.numpy())
            all_valid.append(valid.numpy())
            ended = ((tokens == tok.eos_id) & valid).flatten(1).any(dim=1).numpy()
            done |= ended
            pos = pos + valid.flatten(1).sum(dim=1)
            calls += 1
            assert calls < 400, "no EOS"
        out[f"{side}/tokens"] = np.concatenate(all_tokens, axis=1)
        out[f"{side}/valid"] = np.concatenate(all_valid, axis=1)
        out[f"{side}/logits"] = _np(logits)
        out[f"{side}/calls"] = np.array(calls)
        for key, value in _cache_bytes(cache).items():
            out[f"{side}/{key}"] = value
        if side == "new":
            out["new/windows"] = np.array(cache.window_pass.windows)
    return out


def case_window_pass(inp):
    cases = json.loads(str(inp["cases"]))
    out = {}
    for name, cfg, params in _window_models():
        for key, value in _window_body(cfg, params, cases["window"], **cases["body"]).items():
            out[f"{name}/body/{key}"] = value
        for rows, mode, num_windows in cases["decode"]:
            got = _window_decode(cfg, params, rows, mode, num_windows, cases["window"])
            for key, value in got.items():
                out[f"{name}/decode{rows}_{mode}/{key}"] = value
    return out


def _stand_in_window_pass(window_pass):
    """``window_pass`` (``decoder.WindowPass``) on the card's path, on a CPU
    cache: the first window warms up, the second is captured into a
    stand-in graph whose replay runs the pass eagerly, and every later
    window replays it."""
    from types import SimpleNamespace

    class StandIn(window_pass):
        def __init__(self, *args):
            super().__init__(*args)
            self.on_card = True

        def _warm_up(self):
            self._run()

        def _capture(self):
            self.graph = SimpleNamespace(replay=self._run)

    return StandIn


def case_trace(inp):
    """The program's span records on the tiny text profile: lookahead
    requests (greedy and sampled) with no profiler and under a CPU
    profiler, beside the benchmark's own counts (its ``Recorder``); a chat
    turn and the engine's counters; the lookahead requests again on the
    card's path (``_stand_in_window_pass``); a scheduler run of three
    requests."""
    import threading
    import time

    from torch.profiler import ProfilerActivity, profile

    from bench_torch.harness.record import Recorder
    from vis_tpu_torch.models.common import decoder as D
    from vis_tpu_torch.models.llama.config import llama_tiny
    from vis_tpu_torch.serving import engine as E
    from vis_tpu_torch.serving import scheduler as S
    from vis_tpu_torch.utils.logger import get_timings, get_trace

    cfg = dataclasses.replace(llama_tiny(), vocab_size=512)
    settings = E.ServingSettings(**json.loads(str(inp["settings"])))
    schema = dict(max_tokens=64, json_mode=True, json_schema="inspection")
    engine = E.build_small_text_engine("trace", "cpu", 3, config=cfg, settings=settings)
    recorder = Recorder()
    recorder.install(E, S)
    recorder.watch_engine(engine)
    out = {}
    get_timings(reset=True)
    engine.generate("warm-up", temperature=0.0, **schema)
    out["off"] = {"records": len(get_trace()),
                  "timings": {k: len(v) for k, v in get_timings(reset=True).items()}}

    passes, times = {}, {}
    with profile(activities=[ProfilerActivity.CPU]):
        times["profiled"] = [time.time_ns()]
        for name, temperature in (("greedy", 0.0), ("sampled", 0.7)):
            rec = recorder.begin()
            t0 = time.time_ns()
            engine.generate(f"inspect {name}", temperature=temperature, **schema)
            times[name] = [t0, time.time_ns()]
            passes[name] = rec["passes"]
        session = engine.chat_start("a chat")
        before = [engine.decode_tokens_total, engine.decode_device_s_total]
        t0 = time.perf_counter()
        times["chat"] = [time.time_ns()]
        reply = "".join(engine.chat_turn(session, "and then?", max_tokens=20))
        times["chat"].append(time.time_ns())
        out["chat"] = {"tokens": engine.decode_tokens_total - before[0],
                       "last": engine.last_decode_tokens, "reply": reply,
                       "seconds": engine.decode_device_s_total - before[1],
                       "wall": time.perf_counter() - t0}
        times["profiled"].append(time.time_ns())
    out["on_timings"] = {k: len(v) for k, v in get_timings(reset=True).items()}

    real_pass = D.WindowPass
    D.WindowPass = _stand_in_window_pass(real_pass)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            times["replayed"] = [time.time_ns()]
            for name, temperature in (("greedy", 0.0), ("sampled", 0.7)):
                t0 = time.time_ns()
                engine.generate(f"inspect {name} replayed", temperature=temperature, **schema)
                times[f"replayed_{name}"] = [t0, time.time_ns()]
            times["replayed"].append(time.time_ns())
    finally:
        D.WindowPass = real_pass

    batched = dataclasses.replace(settings, decode_batch_size=3, paged_kv_cache=True,
                                  kv_pool_tokens=4096, scheduler_decode_chunk=16)
    engine = E.build_small_text_engine("sched", "cpu", 3, config=cfg, settings=batched)
    engine.attach_scheduler()
    scheduler = engine.scheduler
    try:
        engine.generate("warm-up", max_tokens=4)
        steps = scheduler.stats["steps"]
        with profile(activities=[ProfilerActivity.CPU]):
            times["scheduler"] = [time.time_ns()]
            threads = [threading.Thread(target=engine.generate, args=(f"prompt {k}",),
                                        kwargs={"max_tokens": n})
                       for k, n in enumerate((20, 37, 50))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            engine.detach_scheduler()  # joins its thread: the last chunk's spans end
            times["scheduler"].append(time.time_ns())
        out["steps"] = scheduler.stats["steps"] - steps
    finally:
        engine.detach_scheduler()
        recorder.uninstall()
    out["stress"] = _trace_stress(profile, ProfilerActivity)
    out["handed"] = _trace_handed_over(profile, ProfilerActivity)
    out.update(passes=passes, times=times, records=get_trace(reset=True))
    out["after_reset"] = len(get_trace())
    return {"out": np.array(json.dumps(out))}


def _trace_handed_over(profile, activity):
    """A generator's span opened in this thread and closed in another (a
    stream dropped by a thread that did not start it), then a span opened
    here: its parent, and the threads of the two records."""
    import threading
    import time

    from vis_tpu_torch.utils.logger import get_trace, span

    def stream():
        with span("handed.held", timed=False):
            yield

    with profile(activities=[activity.CPU]):
        t0 = time.time_ns()
        held = stream()
        next(held)
        closer = threading.Thread(target=held.close)
        closer.start()
        closer.join()
        with span("handed.after", timed=False):
            pass
        t1 = time.time_ns()
    recs = {r["name"]: r for r in get_trace() if r["name"].startswith("handed.")}
    return {"after_parent": recs["handed.after"]["parent"],
            "held_thread": recs["handed.held"]["thread"],
            "after_thread": recs["handed.after"]["thread"],
            "here": threading.get_ident(), "window": [t0, t1]}


def _trace_stress(profile, activity, threads=16, pairs=200):
    """Nested spans from more threads than cores, switching every
    microsecond, under a CPU profiler: (records, distinct ids, children
    whose parent is not their own thread's enclosing span)."""
    import threading
    import time

    from vis_tpu_torch.utils.logger import get_trace, span, synced

    def work(k):
        for i in range(pairs):
            with span(f"stress.{k}", timed=False):
                synced(int, i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[activity.CPU]):
            t0 = time.time_ns()
            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
            alive = sum(t.is_alive() for t in pool)
            t1 = time.time_ns()
    finally:
        sys.setswitchinterval(interval)
    recs = [r for r in get_trace() if r["start_ns"] >= t0
            and (r["name"].startswith("stress.") or r["name"] == "sync")]
    by_id = {r["id"]: r for r in recs}
    astray = sum(1 for r in recs if r["name"] == "sync" and not (
        r["parent"] in by_id and by_id[r["parent"]]["thread"] == r["thread"]
        and by_id[r["parent"]]["start_ns"] <= r["start_ns"] <= r["end_ns"]
        <= by_id[r["parent"]]["end_ns"]))
    return {"records": len(recs), "ids": len(by_id), "astray": astray, "alive": alive,
            "expected": 2 * threads * pairs, "window": [t0, t1]}


# ---------------------------------------------------------------------------
# The hybrid decoder (Nemotron-H) against its plain reference
# ---------------------------------------------------------------------------

NEMOTRON_CONFIG = REPO / "bench_torch" / "configs" / "nemotron_h_47b.json"


def _nemotron_models():
    """(full-size model, rehearsal model) of the configuration file."""
    cfg = json.loads(NEMOTRON_CONFIG.read_text())
    return cfg["model"], dict(cfg["model"], **cfg["rehearsal"]["model"])


def _dequantized(tree):
    """The benchmark's weights as float32 tensors: each int4 or int8 leaf
    dequantized exactly as the reference reads it."""
    from bench_torch.reference.primitives import dequant

    if isinstance(tree, dict):
        if "q4" in tree or "q8" in tree:
            return dequant(tree)
        return {k: _dequantized(v) for k, v in tree.items()}
    return tree.to(torch.float32)


def _nemotron_setup(seed: int):
    """The rehearsal model, its seeded weights, the program's config in
    float32 and its parameters: the same values the reference reads, so the
    two differ only in the order of float32 sums."""
    from bench_torch.families import nemotron_h as fam
    from bench_torch.harness.weights import make_weights

    _, tiny = _nemotron_models()
    weights = make_weights(tiny, seed, "cpu")
    config = dataclasses.replace(fam.program_config(tiny), dtype=torch.float32)
    return fam, tiny, weights, config, _dequantized(weights["text"])


def _nemotron_reference(fam, tiny, weights, ids, rows):
    from bench_torch.reference.primitives import EXACT

    seq = fam.sequence(tiny, {"pieces": [{"ids": list(ids)}]}, weights, "cpu")
    with torch.no_grad():
        return fam.logits(tiny, weights, seq, torch.tensor(rows), EXACT)


def _nemotron_prefill(config, params, ids, bucket, cache_len):
    from vis_tpu_torch.models.common import decoder as dec

    padded = torch.zeros((1, bucket), dtype=torch.int64)
    padded[0, :len(ids)] = torch.tensor(ids)
    cache = dec.new_cache(config, 1, cache_len, "cpu")
    embeds = params["embed_tokens"][padded]
    positions = torch.arange(bucket, dtype=torch.int32)[None]
    logits, cache = dec.prefill_scan(config, params, embeds, positions, cache, [len(ids)])
    return logits, cache


def _capturing_picker(dec, captured):
    class Capturing(dec.TokenPicker):
        def __call__(self, logits):
            captured.append(logits.clone())
            return super().__call__(logits)

    return Capturing


def case_nemotron_h(inp):
    """The hybrid decoder at the rehearsal size in float32 against the
    family's reference; see tests/test_torch_nemotron_h.py."""
    from vis_tpu_torch.models.common import decoder as dec
    from vis_tpu_torch.models.common import layers as lay
    from vis_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
    from vis_tpu_torch.serving.tokenizer import ByteTokenizer

    spec = json.loads(str(inp["spec"]))
    fam, tiny, weights, config, params = _nemotron_setup(spec["seed"])
    rng = np.random.default_rng(spec["seed"])
    out = {}
    torch.set_grad_enabled(False)

    def prompt(n):
        return rng.integers(0, 256, n).tolist()

    # Bucketed prefill, then decode through _eos_loop (dense cache).
    d = spec["dense"]
    ids = prompt(d["prompt"])
    logits0, cache = _nemotron_prefill(config, params, ids, d["bucket"], d["cache"])
    captured = []
    tokens, _ = dec._dense_loop(config, params, logits0, len(ids), cache, d["steps"], -1, None,
                                _capturing_picker(dec, captured)())
    got = torch.stack([c[0] for c in captured])
    gen = tokens[0].tolist()
    ref = _nemotron_reference(fam, tiny, weights, ids + gen,
                              [len(ids) - 1 + j for j in range(len(gen))])
    out["dense/got"], out["dense/ref"] = _np(got), _np(ref)
    out["dense/tokens"] = np.array(gen)

    # The same prompt in two buckets: the same state, K/V and next logits.
    b = spec["buckets"]
    ids = prompt(b["prompt"])
    for bucket in b["buckets"]:
        logits, cache = _nemotron_prefill(config, params, ids, bucket, max(b["buckets"]))
        out[f"bucket{bucket}/logits"] = _np(logits)
        out[f"bucket{bucket}/ssm"] = _np(cache.ssm)
        out[f"bucket{bucket}/conv"] = _np(cache.conv)
        out[f"bucket{bucket}/k"] = _np(cache.k[:, :, :len(ids)])

    # Chunked scan against the recurrence, at lengths off the chunk.
    cfg = config.mamba
    for n in spec["scan_lengths"]:
        g = torch.Generator().manual_seed(n)
        x = torch.randn(2, n, cfg.num_heads, cfg.head_dim, generator=g)
        dt = 0.2 * torch.rand(2, n, cfg.num_heads, generator=g)
        a = -(1.0 + 15.0 * torch.rand(cfg.num_heads, generator=g))
        bmat = torch.randn(2, n, cfg.n_groups, cfg.state_size, generator=g)
        cmat = torch.randn(2, n, cfg.n_groups, cfg.state_size, generator=g)
        y, state = lay.ssd_scan(x, dt, a, bmat, cmat, cfg.chunk_size)
        per = cfg.num_heads // cfg.n_groups
        s = torch.zeros(2, cfg.num_heads, cfg.head_dim, cfg.state_size)
        ys = []
        for t in range(n):
            bh = bmat[:, t].repeat_interleave(per, 1)
            ch = cmat[:, t].repeat_interleave(per, 1)
            s = torch.exp(dt[:, t] * a)[:, :, None, None] * s \
                + (dt[:, t, :, None] * x[:, t])[..., None] * bh[:, :, None, :]
            ys.append(torch.einsum("bhpn,bhn->bhp", s, ch))
        out[f"scan{n}/y"], out[f"scan{n}/y_ref"] = _np(y), _np(torch.stack(ys, 1))
        out[f"scan{n}/state"], out[f"scan{n}/state_ref"] = _np(state), _np(s)

    # One Mamba2 layer: the prefill mixer, the step a token at a time, and a
    # prefill of the first tokens then steps, against the reference's mixer.
    layer = dec._pick_layer(params["layers_stacked"]["mamba"], 0)
    ref_layer = fam._layer(weights["text"]["layers_stacked"]["mamba"], 0)
    for n in spec["scan_lengths"]:
        h = torch.randn(1, n, config.hidden_size, generator=torch.Generator().manual_seed(7 + n))
        want = fam.mamba_mixer(tiny, ref_layer, h[0])
        conv, ssm = lay.recurrent_state(cfg, 1, 1, torch.float32, "cpu")
        full = lay.mamba2_prefill(cfg, h, layer, torch.tensor([n]), conv[0], ssm[0])
        conv, ssm = lay.recurrent_state(cfg, 1, 1, torch.float32, "cpu")
        steps = [lay.mamba2_step(cfg, h[:, t:t + 1], layer, torch.tensor([t], dtype=torch.int32),
                                 conv[0], ssm[0]) for t in range(n)]
        split = spec["split"]
        conv2, ssm2 = lay.recurrent_state(cfg, 1, 1, torch.float32, "cpu")
        bucket = -(-split // cfg.chunk_size) * cfg.chunk_size + cfg.chunk_size
        padded = torch.zeros(1, bucket, config.hidden_size)
        padded[:, :split] = h[:, :split]
        head = lay.mamba2_prefill(cfg, padded, layer, torch.tensor([split]), conv2[0], ssm2[0])
        tail = [lay.mamba2_step(cfg, h[:, t:t + 1], layer, torch.tensor([t], dtype=torch.int32),
                                conv2[0], ssm2[0]) for t in range(split, n)]
        out[f"mixer{n}/ref"] = _np(want)
        out[f"mixer{n}/prefill"] = _np(full[0])
        out[f"mixer{n}/steps"] = _np(torch.cat(steps, 1)[0])
        out[f"mixer{n}/split"] = _np(torch.cat([head[:, :split]] + tail, 1)[0])

    # The paged scheduler: 3 slots, staggered admissions, a slot reused.
    sp = spec["paged"]
    tok = ByteTokenizer(vocab_size=tiny["vocab_size"])
    sched = ContinuousBatchingScheduler(config, params, tok, "cpu", num_slots=3,
                                        max_len=sp["max_len"], page_size=sp["page"],
                                        pool_tokens=sp["pool"], decode_chunk=sp["chunk"])
    reqs, prompts = {}, {}

    def submit(name):
        ids = prompt(sp["prompts"][name])
        page = max(128, sched.pool.page_size)
        staging = -(-len(ids) // page) * page
        logits, cache = _nemotron_prefill(config, params, ids, staging, staging)
        prompts[name] = ids
        reqs[name] = sched.submit_prefilled(cache, logits, len(ids),
                                            max_tokens=sp["budgets"][name], kv_len=len(ids))
        assert sched._admit_one()

    rows = {}  # request name -> program logits of each generated token
    original = dec.TokenPicker

    def chunk():
        before = [(s.request, len(s.request.generated) if s.request else 0)
                  for s in sched.slots]
        captured = []
        dec.TokenPicker = _capturing_picker(dec, captured)
        try:
            sched._decode_once()
        finally:
            dec.TokenPicker = original
        for i, (request, n0) in enumerate(before):
            if request is None:
                continue
            name = next(k for k, r in reqs.items() if r is request)
            kept = len(request.generated) - n0
            rows.setdefault(name, []).extend(captured[k][i] for k in range(kept))

    slot_of = {}
    for step in sp["schedule"]:
        if step == "decode":
            chunk()
        else:
            submit(step)
            slot_of[step] = next(i for i, s in enumerate(sched.slots) if s.request is reqs[step])
    while sched.active_count:
        chunk()
    for name, request in reqs.items():
        ids = prompts[name]
        gen = list(request.generated)
        ref = _nemotron_reference(fam, tiny, weights, ids + gen,
                                  [len(ids) - 1 + j for j in range(len(gen))])
        out[f"paged/{name}/got"] = _np(torch.stack(rows[name]))
        out[f"paged/{name}/ref"] = _np(ref)
        out[f"paged/{name}/tokens"] = np.array(gen)
        out[f"paged/{name}/slot"] = np.array(slot_of[name])
        out[f"paged/{name}/error"] = np.array(request.error or "")
    return out


def case_nemotron_h_refusals(inp):
    """Lookahead windows and chat sessions on a hybrid config raise
    NotImplementedError naming it; the message of each attempt."""
    from vis_tpu_torch.models.common import decoder as dec
    from vis_tpu_torch.serving.engine import Engine, ServingSettings
    from vis_tpu_torch.serving.tokenizer import ByteTokenizer

    fam, tiny, weights, config, params = _nemotron_setup(int(inp["seed"]))
    engine = Engine("hybrid", config, {"text": params}, ByteTokenizer(vocab_size=tiny["vocab_size"]),
                    "cpu", ServingSettings(max_cache_tokens=1024, prefill_buckets=(128, 256),
                                           lookahead=8))
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = np.array("no error")
        except NotImplementedError as exc:
            out[name] = np.array(f"NotImplementedError: {exc}")

    attempt("chat", lambda: engine.chat_start("The report says the weld is cracked."))
    attempt("schema", lambda: engine.generate("Decide.", max_tokens=256, json_mode=True,
                                              json_schema="decision_support"))
    cache = dec.new_cache(config, 1, 256, "cpu")
    attempt("extend", lambda: dec.extend_scan(
        config, params, torch.zeros(1, 128, config.hidden_size), torch.zeros(1, 128), cache,
        [5]))
    attempt("lookahead", lambda: dec.decode_loop_lookahead(
        config, params, None, 0, cache, None, None, None, num_windows=1, window=8))
    out["greedy"] = np.array(engine.generate("Explain the verdict.", max_tokens=6))
    return out


def case_ssm_step_card(inp):
    """The Mamba2 state step kernel against its plain version on the card;
    on a host without a card it reports why nothing ran."""
    if not torch.cuda.is_available():
        return {"skip": np.array("torch sees no CUDA device")}
    from vis_tpu_torch.ops.ssm import ssm_step, ssm_step_plain

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"skip": np.array("")}
    for name, (rows, heads, p, n, groups, cursors) in json.loads(str(inp["cases"])).items():
        d_inner = heads * p
        conv_dim = d_inner + 2 * groups * n

        def randn(*shape, scale=1.0, dtype=torch.float32):
            return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

        # Rows of a wider in_proj output (a leading stride past the row).
        zxbcdt = randn(rows, d_inner + conv_dim + heads + 16, dtype=torch.bfloat16)
        args = (randn(conv_dim, 4, scale=0.5, dtype=torch.bfloat16),
                randn(conv_dim, scale=0.02, dtype=torch.bfloat16), randn(heads) - 4.0,
                torch.log(1.0 + 15.0 * torch.rand((heads,), generator=gen, device=dev)),
                1.0 + randn(heads, scale=0.1))
        ring = randn(rows, conv_dim, 4, dtype=torch.bfloat16)
        state = randn(rows, heads, p, n, scale=0.1)
        cursor = torch.tensor(cursors, dtype=torch.int32, device=dev)
        results = []
        for _ in range(2):
            r, st = ring.clone(), state.clone()
            results.append((ssm_step(zxbcdt, r, cursor, *args, st, groups), r, st))
        r, st = ring.clone(), state.clone()
        want = ssm_step_plain(zxbcdt, r, cursor, *args, st, groups)
        got, r_k, st_k = results[0]
        torch.cuda.synchronize()
        out[name] = np.array([
            max((got - want).abs().max().item(), (st_k - st).abs().max().item()),
            max(want.abs().max().item(), st.abs().max().item()),
            float(torch.equal(r_k, r)),
            float(all(torch.equal(a, b) for a, b in zip(results[0], results[1])))])
    try:
        ssm_step(zxbcdt, ring, cursor, *args, torch.zeros(rows, heads, p, 64, device=dev), groups)
        out["refused"] = np.array("")
    except ValueError as exc:
        out["refused"] = np.array(str(exc))
    from vis_tpu_torch.ops import norms

    # The fused norms: (rows, hidden, in_proj row width, d_inner, groups).
    for rows, hidden, width, d_inner, groups in json.loads(str(inp["norm_cases"])):
        x, delta = (torch.randn((rows, hidden), generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
        w = (1.0 + 0.1 * torch.randn((hidden,), generator=gen, device=dev)).to(torch.bfloat16)
        xo, h = norms.add_rms_norm(x, delta, w, 1e-5)
        xp, hp = norms.add_rms_norm_plain(x, delta, w, 1e-5)
        z = torch.randn((rows, width), generator=gen, device=dev).to(torch.bfloat16)[:, :d_inner]
        y = torch.randn((rows, d_inner), generator=gen, device=dev)
        gw = (1.0 + 0.1 * torch.randn((d_inner,), generator=gen, device=dev)).to(torch.bfloat16)
        got = norms.gated_group_norm(y, z, gw, groups, 1e-5)
        want = norms.gated_group_norm_plain(y, z, gw, groups, 1e-5)
        out[f"norms/{rows}x{hidden}"] = np.array([
            (h.float() - hp.float()).abs().max().item(), hp.float().abs().max().item(),
            float(torch.equal(xo, xp)), (got.float() - want.float()).abs().max().item(),
            want.float().abs().max().item()])
    return out


def case_nemotron_h_alone(inp):
    """The family's weights, reference and counts in a process that cannot
    import the program; its program_config must fail there."""
    sys.modules["vis_tpu_torch"] = None
    from bench_torch.families import nemotron_h as fam
    from bench_torch.harness.weights import make_weights
    from bench_torch.reference.primitives import EXACT

    full, tiny = _nemotron_models()
    weights = make_weights(tiny, 11, "cpu")
    seq = fam.sequence(tiny, {"pieces": [{"ids": list(range(40))}]}, weights, "cpu")
    with torch.no_grad():
        logits = fam.logits(tiny, weights, seq, torch.tensor([39]), EXACT)
    out = {"logits": _np(logits), "weight_bytes": np.array(fam.weight_bytes_per_pass(full)),
           "state_bytes": np.array(fam.state_update_bytes(full)),
           "kv_bytes": np.array(fam.kv_bytes_per_position(full)),
           "counts": np.array(json.dumps(fam.counts(full))),
           "decode_bytes": np.array(fam.decode_bytes(full, 10, 1000.0)),
           "decode_flops": np.array(fam.decode_flops(full, 10, 1000.0)),
           "prefill_flops": np.array(fam.prefill_flops(full, 100))}
    try:
        fam.program_config(tiny)
        out["program_config"] = np.array("imported")
    except ImportError as exc:
        out["program_config"] = np.array(f"ImportError: {exc}")
    return out


def main() -> int:
    case, in_path, out_path = sys.argv[1:4]
    inp = np.load(in_path, allow_pickle=False)
    out = globals()[f"case_{case}"](inp)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
