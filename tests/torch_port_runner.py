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
                              fa.flash_attention.launches]),
        "jax_live": np.array(jax_live),
    }


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
    same = {
        "q4_matmul": torch.equal(qz.q4_matmul(x, q[1], scale[1]),
                                 qz.q4_matmul_plain(x, q[1], scale[1])),
        "q4_matmul_stacked": torch.equal(
            qz.q4_matmul_stacked(x, qz.QuantizedWeight4Pick(q, scale, 2)),
            qz.q4_matmul_plain(x, q[2], scale[2])),
        "flash_attention": torch.equal(
            fa.flash_attention(*qkv, lengths, causal=True),
            fa.flash_attention_reference(*qkv, lengths, causal=True)),
    }
    launches = {"q4_matmul": qz.q4_matmul.launches,
                "q4_matmul_stacked": qz.q4_matmul_stacked.launches,
                "flash_attention": fa.flash_attention.launches}
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
    for name, call in (("q4_rows", lambda: qz.q4_matmul(x, q, scale)),
                       ("flash_f32", lambda: fa.flash_attention(*qkv)),
                       ("flash_d96", lambda: fa.flash_attention(*qkv96))):
        try:
            call()
            refused[name] = ""
        except (TypeError, ValueError) as exc:
            refused[name] = type(exc).__name__
    out["refused"] = np.array(json.dumps(refused))
    out["launches"] = np.array([qz.q4_matmul.launches, qz.q4_matmul_stacked.launches,
                                fa.flash_attention.launches])
    return out


def main() -> int:
    case, in_path, out_path = sys.argv[1:4]
    inp = np.load(in_path, allow_pickle=False)
    out = globals()[f"case_{case}"](inp)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
