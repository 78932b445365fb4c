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
    sum differs; for M, O and P whether each output is bit-equal, then
    whether O with its x halves swapped, and O on P's reading, are equal to
    the plain O and P (they must not be)."""
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
    for name, (rows, out_dim, in_dim) in json.loads(str(inp["int_cases"])).items():
        half = in_dim // 2
        x8 = torch.randint(-127, 128, (rows, in_dim), generator=gen, device=dev, dtype=torch.int8)
        q8 = torch.randint(-128, 128, (out_dim, in_dim), generator=gen, device=dev,
                           dtype=torch.int8)
        s1 = torch.rand((1, out_dim), generator=gen, device=dev) * 0.01
        q4 = torch.randint(0, 256, (out_dim, half), generator=gen, device=dev, dtype=torch.uint8)
        s2 = torch.rand((2, out_dim), generator=gen, device=dev) * 0.01
        want_o = int_dot.q4_i8_matmul_plain(x8, q4, s2)
        swapped = torch.cat([x8[:, half:], x8[:, :half]], dim=1)
        out[f"int/{name}"] = np.array([
            float(torch.equal(int_dot.i8_matmul(x8, q8, s1), int_dot.i8_matmul_plain(x8, q8, s1))),
            float(torch.equal(int_dot.q4_i8_matmul(x8, q4, s2), want_o)),
            float(torch.equal(int_dot.q4_i8s_matmul(x8, q4, s2),
                              int_dot.q4_i8s_matmul_plain(x8, q4, s2))),
            float(torch.equal(int_dot.q4_i8_matmul(swapped, q4, s2), want_o)),
            float(torch.equal(int_dot.q4_i8_matmul(x8, q4, s2),
                              int_dot.q4_i8s_matmul_plain(x8, q4, s2)))])


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


def main() -> int:
    case, in_path, out_path = sys.argv[1:4]
    inp = np.load(in_path, allow_pickle=False)
    out = globals()[f"case_{case}"](inp)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
