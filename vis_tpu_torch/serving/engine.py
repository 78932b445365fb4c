"""Inference engine: the Qwen2.5-VL inspector (preprocess -> vision encode
-> prefill -> schema-constrained lookahead decode) and text-only decoders
such as the Llama-3.1-8B explainer (prefill -> decode, unbatched or through
the continuous-batching scheduler).

Counterpart of ``vis_tpu/serving/engine.py`` for these two paths.  The
engine core takes its serving settings as arguments (``ServingSettings``);
only ``build_engine`` and the ``EngineBackend`` adapter read
``vis_tpu_torch.utils.config``.  Every tensor lives on the engine's ``device``;
nothing picks a device on its own.

Weights are random (no checkpoint loading yet): ``build_target_engine``
materializes Qwen2.5-VL-7B and ``build_target_text_engine`` Llama-3.1-8B
at full width and depth, straight on the device from an explicit
``torch.Generator``: under QUANTIZATION=int4 int4 decoder layers (and
vision projections) with an int4 (Qwen) or int8 (Llama) vocab head, under
QUANTIZATION=int8 int8 everywhere (layers, vocab tables, vision
projections).  ``build_small_engine`` and ``build_small_text_engine`` are
the small profiles the CPU tests drive.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vis_tpu_torch.ops.preprocess import (
    PATCH_BUCKETS,
    build_mrope_positions,
    preprocess_image,
)
from vis_tpu_torch.serving.tokenizer import ByteTokenizer
from vis_tpu_torch.utils.config import config as app_config
from vis_tpu_torch.utils.logger import setup_logger, span
from vis_tpu_torch.models.common.decoder import (
    DecodeConstraint,
    DecoderConfig,
    decode_loop_lookahead,
    extend_scan,
    fuse_stacked_projections,
    init_decoder_params,
    prefill_scan,
    quantize_stacked_params,
    stack_decoder_layers,
)
from vis_tpu_torch.models.common.layers import KVCache, embed
from vis_tpu_torch.models.qwen2_5_vl.config import Qwen25VisionConfig, Qwen25VLConfig
from vis_tpu_torch.models.qwen2_5_vl.model import embed_multimodal, init_params
from vis_tpu_torch.models.qwen2_5_vl.vision import vision_forward_25, window_layout
from vis_tpu_torch.ops.frame_cache import DeviceFrameCache
from vis_tpu_torch.ops.preprocess_device import (
    DeviceImagePatches,
    preprocess_image_device,
)
from vis_tpu_torch.models.llama.config import llama31_8b
from vis_tpu_torch.ops.quantized import QuantizedWeight, QuantizedWeight4

logger = setup_logger(__name__, level="INFO", component="ENGINE")


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    return ((n + 127) // 128) * 128


def load_constraint_tables(tokenizer, vocab_size: int, schema: Optional[str],
                           device) -> Optional[tuple]:
    """Compile a schema's (or generic JSON's) constraint tables on the host
    and move them to ``device``: (token_ok, token_trans, cost_after,
    class_of-or-None, host ConstraintTables), or None when unsupported."""
    if schema is not None:
        from vis_tpu_torch.serving.schema import schema_constraint_tables

        tables = schema_constraint_tables(tokenizer, vocab_size, schema)
    else:
        from vis_tpu_torch.serving.constrained import json_constraint_tables

        tables = json_constraint_tables(tokenizer, vocab_size)
    if tables is None:
        return None

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (
        dev(tables.token_ok), dev(tables.token_trans), dev(tables.cost_after),
        None if tables.class_of is None else dev(tables.class_of).long(),
        tables,
    )


@dataclasses.dataclass(frozen=True)
class ServingSettings:
    """What the engine core takes instead of reading the app config."""

    max_cache_tokens: int = 8192
    prefill_buckets: Tuple[int, ...] = (512, 1024, 2048, 4096, 8192)
    decode_chunk: int = 64      # lookahead windows per decode call
    lookahead: int = 8          # tokens per window (2..16)
    device_preprocess: bool = True
    min_json_tokens: int = 0    # JSON-close floor when a request names none
    # Continuous-batching scheduler (attach_scheduler)
    decode_batch_size: int = 8  # slots
    paged_kv_cache: bool = False
    kv_page_size: int = 128
    kv_pool_tokens: int = 16384
    scheduler_decode_chunk: int = 32
    chunked_prefill_tokens: int = 0

    @classmethod
    def from_app_config(cls) -> "ServingSettings":
        return cls(
            max_cache_tokens=app_config.kv_cache_max_tokens,
            prefill_buckets=tuple(app_config.prefill_bucket_list),
            decode_chunk=app_config.decode_chunk,
            lookahead=app_config.constrained_lookahead,
            device_preprocess=app_config.device_preprocess,
            min_json_tokens=app_config.constrained_json_min_tokens,
            decode_batch_size=app_config.decode_batch_size,
            paged_kv_cache=app_config.paged_kv_cache,
            kv_page_size=app_config.kv_page_size,
            kv_pool_tokens=app_config.kv_pool_tokens,
            scheduler_decode_chunk=app_config.scheduler_decode_chunk,
            chunked_prefill_tokens=app_config.chunked_prefill_tokens,
        )


class Engine:
    """One model on one torch device: a Qwen2.5-VL model (``config`` a
    ``Qwen25VLConfig``) or a text-only decoder (a ``DecoderConfig``)."""

    def __init__(self, name: str, config, params: Dict[str, Any],
                 tokenizer, device, settings: ServingSettings):
        self.name = name
        self.config = config
        self.vlm_config = None if isinstance(config, DecoderConfig) else config
        self.text_config = config if self.vlm_config is None else config.text
        # {"text": stacked tree} plus, for a VLM, {"vision": per-block tree}
        self.params = params
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.settings = settings
        self._lock = threading.Lock()
        self._frames = DeviceFrameCache()
        self._json: Dict[Optional[str], Any] = {}
        self.scheduler = None
        self.last_decode_tokens: Optional[int] = None
        self.decode_tokens_total = 0

    def _sync(self) -> None:
        """End a span on the device's clock, not the host's enqueue."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _json_tables(self, schema: Optional[str]):
        if schema not in self._json:
            self._json[schema] = load_constraint_tables(
                self.tokenizer, self.text_config.vocab_size, schema, self.device
            )
        if self._json[schema] is None and schema is not None:
            return self._json_tables(None)
        return self._json[schema]

    # -- vision ----------------------------------------------------------
    def _preprocess(self, image_path, max_image_dim) -> DeviceImagePatches:
        """An image file -> its patches on the device."""
        if self.settings.device_preprocess:
            frame = self._frames.get(image_path, self.device)
            return preprocess_image_device(frame, max_image_dim)
        host = preprocess_image(image_path, max_image_dim=max_image_dim)
        return DeviceImagePatches(
            patches=torch.from_numpy(host.patches).to(self.device),
            grid_t=host.grid_t, grid_h=host.grid_h, grid_w=host.grid_w,
        )

    def encode_vision(self, image: DeviceImagePatches) -> torch.Tensor:
        """Vision tower over the bucket-padded patches -> merged embeddings
        trimmed to the image's token count."""
        vc = self.vlm_config.vision
        padded, bucket = image.padded()
        base = window_layout(vc, image.grid_h, image.grid_w, src_len=bucket)
        wp = vc.window_patches
        win_bucket = next(
            (b for b in PATCH_BUCKETS if b >= base.win_len and b % wp == 0),
            ((base.win_len + wp - 1) // wp) * wp,
        )
        layout = window_layout(vc, image.grid_h, image.grid_w,
                               min_len=win_bucket, src_len=bucket)
        with span("engine.vision_encode", logger):
            embeds = vision_forward_25(
                vc, self.params["vision"], padded, layout, image.num_patches
            )[: image.num_tokens]
            self._sync()
        return embeds

    # -- prompt and prefill ----------------------------------------------
    def _build_prompt_ids(self, prompt: str, image: Optional[DeviceImagePatches]):
        """Token ids [1, s], M-RoPE positions (or None), next decode position."""
        tok = self.tokenizer
        if image is None:
            ids = tok.encode(prompt)
            return np.array([ids]), None, len(ids)
        text_ids = tok.encode(prompt)
        ids = ([tok.vision_start_id] + [tok.image_token_id] * image.num_tokens
               + [tok.vision_end_id] + text_ids)
        positions, next_pos = build_mrope_positions(
            1, image.grid_h, image.grid_w, len(text_ids) + 1
        )
        return np.array([ids]), positions, next_pos

    @staticmethod
    def _request_cache_len(bucket: int, max_tokens: int, cap: int) -> int:
        need = bucket + max_tokens + 32
        return min(cap, ((need + 511) // 512) * 512)

    def _prefill_request(self, prompt, image, *, max_tokens, max_image_dim,
                         prompt_only_cache: bool = False):
        """Vision encode + prefill into a fresh batch-1 cache; returns (cache,
        first_logits, next_position, kv_len, ids).  The cache is sized to the
        request's budget, or with ``prompt_only_cache`` (a scheduler hand-off,
        whose decode KV lives in the page pool) to the page-aligned prompt
        bucket alone."""
        tc = self.text_config
        patches = vision_embeds = None
        if image is not None and self.vlm_config is not None:
            with span("engine.preprocess", logger):
                patches = self._preprocess(image, max_image_dim)
                self._sync()
            vision_embeds = self.encode_vision(patches)

        ids, mrope_positions, next_pos = self._build_prompt_ids(prompt, patches)
        seq_len = ids.shape[1]
        cap = self.settings.max_cache_tokens
        # 32 tokens of slack past the budget: lookahead windows write whole
        # window-sized chunks at the cursor.
        bucket = min(_bucket_for(seq_len, self.settings.prefill_buckets),
                     cap - max_tokens - 32)
        pool = self.scheduler.pool if prompt_only_cache and self.scheduler else None
        if pool is not None:
            # The pool's per-slot room (prompt + max_tokens + one decode chunk,
            # bounded by the page-table window) can be tighter than the cache
            # cap: truncate against it here, or the scheduler refuses the
            # request after its prefill was paid.
            slot_tokens = min(pool.n_pages - 1, pool.max_pages) * pool.page_size
            paged_room = slot_tokens - max_tokens - self.scheduler.decode_chunk
            if 2 <= paged_room < bucket:
                bucket = paged_room
        if bucket < 2:
            raise RuntimeError(
                f"max_tokens={max_tokens} leaves no prompt room in a "
                f"{cap}-token KV cache (32 tokens of chunk slack are reserved)"
            )
        if seq_len > bucket:
            keep_head = bucket // 2
            ids = np.concatenate([ids[:, :keep_head], ids[:, -(bucket - keep_head):]], axis=1)
            seq_len = bucket
            mrope_positions = None
            next_pos = seq_len
            logger.warning(f"Prompt truncated to {bucket} tokens")
        if pool is not None:
            page = max(128, pool.page_size)
            cache_len = min(cap, -(-bucket // page) * page)
        else:
            cache_len = self._request_cache_len(bucket, max_tokens, cap)

        padded = np.zeros((1, bucket), dtype=np.int64)
        padded[0, :seq_len] = ids[0]
        padded_ids = torch.from_numpy(padded).to(self.device)
        if patches is not None:
            embeds = embed_multimodal(self.vlm_config, self.params, padded_ids, vision_embeds)
        else:
            embeds = embed(padded_ids, self.params["text"]["embed_tokens"])

        if mrope_positions is not None:
            positions = np.zeros((3, 1, bucket), dtype=np.int32)
            positions[:, 0, :seq_len] = mrope_positions
            positions[:, 0, seq_len:] = mrope_positions.max()
        else:
            positions = np.arange(bucket, dtype=np.int32)[None]
            next_pos = seq_len
        positions = torch.from_numpy(positions).to(self.device)

        cache = KVCache.create(tc.num_layers, 1, cache_len, tc.num_kv_heads,
                               tc.head_dim_, tc.dtype, self.device)
        with span("engine.prefill", logger):
            logits, cache = prefill_scan(
                tc, self.params["text"], embeds, positions, cache, [seq_len]
            )
            self._sync()  # the scheduler's hand-off relies on this synchronise
        return cache, logits, next_pos, seq_len, ids

    # -- decode ----------------------------------------------------------
    def _generate_locked(self, prompt, image, *, max_tokens, temperature,
                         max_image_dim, json_schema: Optional[str],
                         json_mode: bool, min_tokens: Optional[int]) -> Iterator[str]:
        params = self.params["text"]
        json_tables = self._json_tables(json_schema) if json_mode else None
        if json_tables is not None:
            max_tokens = max(max_tokens, json_tables[-1].min_budget)
        cache, logits, next_pos, _, _ = self._prefill_request(
            prompt, image, max_tokens=max_tokens, max_image_dim=max_image_dim
        )
        eos = self.tokenizer.eos_id
        generated: List[int] = []
        emitted = ""

        def emit_progress() -> Iterator[str]:
            nonlocal emitted
            text = self.tokenizer.decode(generated)
            if len(text) > len(emitted) and not text.endswith("�"):
                chunk, emitted = text[len(emitted):], text
                yield chunk

        with span("engine.decode", logger):
            if json_tables is not None:
                yield from self._lookahead_decode(
                    params, logits, cache, next_pos, json_tables, max_tokens,
                    temperature, min_tokens, generated, emit_progress,
                )
            elif temperature <= 0.0:
                yield from self._greedy_chunk_loop(
                    params, logits, cache, next_pos, generated, emit_progress, max_tokens,
                )
            else:
                raise NotImplementedError(
                    "free-form sampled decode is not ported yet; use a JSON "
                    "schema request or temperature 0"
                )
            self._sync()
        self.last_decode_tokens = len(generated)
        self.decode_tokens_total += len(generated)
        final = self.tokenizer.decode(generated)
        if len(final) > len(emitted):
            yield final[len(emitted):]

    def _lookahead_decode(self, params, logits, cache, next_pos, json_tables,
                          max_tokens, temperature, min_tokens, generated,
                          emit_progress) -> Iterator[str]:
        """Schema-constrained decode, ``lookahead`` tokens per weight pass,
        sampled (Gumbel-max from a per-request device generator) when
        temperature > 0, greedy otherwise."""
        tc = self.text_config
        ok_t, trans_t, cost_t, cls_t, tables = json_tables
        window = self.settings.lookahead
        if not (2 <= window <= 16 and tables.forced_token is not None):
            raise NotImplementedError(
                "constrained decode without a 2..16-token lookahead window is not ported yet"
            )
        floor = min_tokens if min_tokens is not None else self.settings.min_json_tokens
        min_tok = min(max(floor, 0), max_tokens - 32)
        dev = self.device

        def full(value, dtype):
            return torch.full((1,), value, dtype=dtype, device=dev)

        constraint = DecodeConstraint(
            token_ok=ok_t, token_trans=trans_t, cost_after=cost_t, class_of=cls_t,
            state=full(tables.init_state, torch.int64),
            remaining=full(max_tokens, torch.int64),
            active=full(True, torch.bool),
            min_remaining=full(max_tokens - max(min_tok, 0), torch.int64),
        )
        forced_tok = torch.from_numpy(tables.forced_token).to(dev)
        forced_state = torch.from_numpy(tables.forced_state).to(dev)
        draw = None
        if temperature > 0.0:
            # Every request samples from seed 0, as the JAX engine's PRNGKey(0).
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)

            def draw(shape):
                return torch.rand(shape, generator=gen, device=dev).clamp_min_(1e-20)

        remaining, step0, done = max_tokens, 0, False
        while remaining > 0 and not done:
            tokens, valid, logits, cache, constraint = decode_loop_lookahead(
                tc, params, logits, next_pos + step0, cache, constraint,
                forced_tok, forced_state, num_windows=self.settings.decode_chunk,
                window=window, draw_uniforms=draw, temperature=temperature,
                eos_id=self.tokenizer.eos_id,
            )
            emitted_n = 0
            for win_tokens, win_valid in zip(tokens[0].tolist(), valid[0].tolist()):
                for token_id, ok in zip(win_tokens, win_valid):
                    if not ok:
                        break
                    emitted_n += 1
                    if token_id == self.tokenizer.eos_id:
                        done = True
                        break
                    generated.append(token_id)
                    if emitted_n >= remaining:
                        done = True
                        break
                if done:
                    break
            yield from emit_progress()
            remaining -= emitted_n
            step0 += emitted_n

    def _greedy_chunk_loop(self, params, logits, cache, start_pos, generated,
                           emit_progress, budget) -> Iterator[str]:
        """Free-form greedy decode, one token per pass, host EOS check per
        token (the health check's path)."""
        tc = self.text_config
        for step in range(budget):
            token = torch.argmax(logits, dim=-1)
            token_id = int(token[0])
            if token_id == self.tokenizer.eos_id:
                break
            generated.append(token_id)
            pos = torch.full((1, 1), start_pos + step, dtype=torch.int32, device=self.device)
            positions = pos[None].expand(3, 1, 1) if tc.mrope_section is not None else pos
            logits, cache = extend_scan(
                tc, params, embed(token[:, None], params["embed_tokens"]),
                positions, cache, [1],
            )
            yield from emit_progress()

    # -- continuous batching ---------------------------------------------
    def attach_scheduler(self, num_slots: Optional[int] = None,
                         paged: Optional[bool] = None) -> None:
        """Batched decode: concurrent requests prefill under the engine lock,
        then decode together in the scheduler's slots.  The scheduler gets
        the generic JSON grammar and every registered schema, stacked as far
        as its size budget allows (``has_table``)."""
        from vis_tpu_torch.serving.constrained import json_constraint_tables
        from vis_tpu_torch.serving.schema import SCHEMAS, schema_constraint_tables
        from vis_tpu_torch.serving.scheduler import ContinuousBatchingScheduler

        vocab = self.text_config.vocab_size
        tables = {None: json_constraint_tables(self.tokenizer, vocab)}
        for name in SCHEMAS:
            tables[name] = schema_constraint_tables(self.tokenizer, vocab, name)
        st = self.settings
        self.scheduler = ContinuousBatchingScheduler(
            self.text_config, self.params["text"], self.tokenizer, self.device,
            num_slots=num_slots or st.decode_batch_size, max_len=st.max_cache_tokens,
            paged=st.paged_kv_cache if paged is None else paged, json_tables=tables,
            page_size=st.kv_page_size, pool_tokens=st.kv_pool_tokens,
            decode_chunk=st.scheduler_decode_chunk,
            chunked_prefill=st.chunked_prefill_tokens, min_json_tokens=st.min_json_tokens,
        )
        self.scheduler.start()

    def detach_scheduler(self) -> None:
        if self.scheduler is not None:
            self.scheduler.stop()
            self.scheduler = None

    def _use_scheduler(self, json_mode: bool, json_schema: Optional[str],
                       schema_batched: bool, temperature: float) -> bool:
        """The JAX engine's routing rules for the batched path."""
        sched = self.scheduler
        if sched is None:
            return False
        if json_schema is not None and not (schema_batched and sched.has_table(json_schema)):
            return False  # a lone schema request is faster unbatched (lookahead)
        if json_mode and json_schema is None and not sched.has_table(None):
            return False  # the stack holds no generic grammar
        if temperature > 0.0 and sched._json_dev is None:
            return False  # sampled paged decode rides the constrained loop
        return True

    # -- public ------------------------------------------------------------
    def generate_stream(self, prompt, image=None, *, max_tokens: int = 1024,
                        temperature: float = 0.0, max_image_dim: int = 2048,
                        json_mode: bool = False, json_schema: Optional[str] = None,
                        schema_batched: bool = False,
                        min_tokens: Optional[int] = None) -> Iterator[str]:
        if not json_mode:
            json_schema = None
        if json_mode and self._json_tables(json_schema) is None:
            json_mode, json_schema = False, None
        if json_schema is not None and self._json.get(json_schema) is None:
            json_schema = None  # the schema's tables are unavailable: generic JSON
        if self._use_scheduler(json_mode, json_schema, schema_batched, temperature):
            yield from self._generate_scheduled(
                prompt, image, max_tokens=max_tokens, temperature=temperature,
                max_image_dim=max_image_dim, json_schema=json_schema,
                json_mode=json_mode, min_tokens=min_tokens,
            )
            return
        with self._lock:
            yield from self._generate_locked(
                prompt, image, max_tokens=max_tokens, temperature=temperature,
                max_image_dim=max_image_dim, json_schema=json_schema,
                json_mode=json_mode, min_tokens=min_tokens,
            )

    def _generate_scheduled(self, prompt, image, *, max_tokens, temperature,
                            max_image_dim, json_schema, json_mode,
                            min_tokens) -> Iterator[str]:
        """Prefill under the lock, then decode in the scheduler's slots."""
        if json_mode:
            max_tokens = max(max_tokens, self._json_tables(json_schema)[-1].min_budget)
        with self._lock:
            cache, logits, next_pos, kv_len, _ = self._prefill_request(
                prompt, image, max_tokens=max_tokens, max_image_dim=max_image_dim,
                prompt_only_cache=True,
            )
        request = self.scheduler.submit_prefilled(
            cache, logits, next_pos, max_tokens=max_tokens, kv_len=kv_len,
            json_mode=json_mode, temperature=temperature, schema=json_schema,
            min_tokens=min_tokens,
        )
        while True:
            chunk = request.out.get()
            if chunk is None:
                break
            yield chunk
        if request.error:
            raise RuntimeError(request.error)
        with self._lock:  # concurrent bundle requests share these counters
            self.last_decode_tokens = len(request.generated)
            self.decode_tokens_total += len(request.generated)

    def generate(self, prompt, image=None, **kwargs) -> str:
        return "".join(self.generate_stream(prompt, image, **kwargs))

    def health_check(self) -> bool:
        try:
            return self.generate("OK?", None, max_tokens=2) is not None
        except Exception as exc:  # a health probe reports, it does not raise
            logger.error(f"Engine health check failed: {exc}")
            return False


class EngineBackend:
    """InferenceBackend adapter over an Engine (what the agents call)."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.name = f"cuda:{engine.name}"

    def generate(self, prompt, image_path=None, *, max_tokens=1024, temperature=0.0,
                 max_image_dim=2048, json_mode: bool = False,
                 json_schema: Optional[str] = None, schema_batched: bool = False,
                 min_tokens: Optional[int] = None) -> str:
        return "".join(self.generate_stream(
            prompt, image_path, max_tokens=max_tokens, temperature=temperature,
            max_image_dim=max_image_dim, json_mode=json_mode,
            json_schema=json_schema, schema_batched=schema_batched,
            min_tokens=min_tokens,
        ))

    def generate_stream(self, prompt, image_path=None, *, max_tokens=1024,
                        temperature=0.0, max_image_dim=2048, json_mode: bool = False,
                        json_schema: Optional[str] = None, schema_batched: bool = False,
                        min_tokens: Optional[int] = None):
        yield from self.engine.generate_stream(
            prompt, image_path, max_tokens=max_tokens, temperature=temperature,
            max_image_dim=max_image_dim, json_mode=json_mode,
            json_schema=json_schema, schema_batched=schema_batched,
            min_tokens=min_tokens,
        )

    def health_check(self) -> bool:
        return self.engine.health_check()


# ---------------------------------------------------------------------------
# Engine construction
# ---------------------------------------------------------------------------

_VISION_QUANT_KEYS = frozenset({
    "qkv", "proj", "fc1", "fc2", "patch_embed", "gate_proj", "up_proj", "down_proj",
})


def _quantize_vision_tree(tree: Any, mode: str = "int4") -> Any:
    """Int4- or int8-quantize a vision tower's projection weights by name."""
    from vis_tpu_torch.ops.quantized import quantize_weight, quantize_weight4

    quantize = quantize_weight4 if mode == "int4" else quantize_weight
    if isinstance(tree, dict):
        return {
            k: (quantize(v) if k in _VISION_QUANT_KEYS and torch.is_tensor(v)
                and v.dim() == 2 and v.shape[1] % 2 == 0 else _quantize_vision_tree(v, mode))
            for k, v in tree.items()
        }
    if isinstance(tree, list):
        return [_quantize_vision_tree(v, mode) for v in tree]
    return tree


def _byte_token_ids(cfg: Qwen25VLConfig) -> Qwen25VLConfig:
    """Point the multimodal token ids at the ByteTokenizer's specials."""
    return dataclasses.replace(
        cfg, image_token_id=261, vision_start_token_id=259,
        vision_end_token_id=260, eos_token_id=256,
    )


def _random_floats(gen: torch.Generator, *shape, device, dtype=torch.bfloat16) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * 0.005 + 0.01).to(dtype)


def random_q4(gen: torch.Generator, *lead, out: int, inn: int, device) -> QuantizedWeight4:
    """A random int4 weight [*lead, out, inn] as the target profile makes
    it: random packed bytes, scales N(0,1)*0.005+0.01."""
    return QuantizedWeight4(
        q=torch.randint(0, 256, (*lead, out, inn // 2), generator=gen,
                        device=device, dtype=torch.uint8),
        scale=_random_floats(gen, *lead, out, 2, device=device, dtype=torch.float32),
    )


def random_q8_stack(gen: torch.Generator, *lead, out: int, inn: int,
                    device) -> QuantizedWeight:
    """A random int8 weight [*lead, out, inn] as the target profile makes
    it: random bytes over -128..127 (the JAX package's random bits cast to
    int8), one scale N(0,1)*0.005+0.01 per output row."""
    return QuantizedWeight(
        q=torch.randint(-128, 128, (*lead, out, inn), generator=gen, device=device,
                        dtype=torch.int8),
        scale=_random_floats(gen, *lead, out, device=device, dtype=torch.float32),
    )


def _random_layer_weight(mode: str):
    """The random weight maker of a target profile's layers: int4 or int8."""
    if mode not in ("int4", "int8"):
        raise ValueError(f"target profiles are int4 or int8, not {mode!r}")
    return random_q4 if mode == "int4" else random_q8_stack


def _random_target_params(cfg: Qwen25VLConfig, gen: torch.Generator, device,
                          mode: str = "int4") -> Dict[str, Any]:
    """Qwen2.5-VL-7B in its serving layout (stacked, fused; ``mode`` int4:
    int4 layers, vision projections and vocab tables; int8: int8 for all of
    them), made leaf by leaf on the device: random bytes for quantized
    weights, N(0,1)*0.005+0.01 for every float leaf (scales, norms,
    biases), so no bf16 copy of the model is ever staged."""
    make = _random_layer_weight(mode)

    def floats(*shape):
        return _random_floats(gen, *shape, device=device)

    def weight(*lead, out, inn):
        return make(gen, *lead, out=out, inn=inn, device=device)

    vc, tc = cfg.vision, cfg.text
    d, inter = vc.hidden_size, vc.intermediate_size
    merge_dim = d * vc.merge_unit
    vision = {
        "patch_embed": weight(out=d, inn=vc.patch_input_dim),
        "blocks": [
            {
                "norm1": floats(d), "norm2": floats(d),
                "qkv": weight(out=3 * d, inn=d), "qkv_bias": floats(3 * d),
                "proj": weight(out=d, inn=d), "proj_bias": floats(d),
                "mlp": {
                    "gate_proj": weight(out=inter, inn=d), "gate_bias": floats(inter),
                    "up_proj": weight(out=inter, inn=d), "up_bias": floats(inter),
                    "down_proj": weight(out=d, inn=inter), "down_bias": floats(d),
                },
            }
            for _ in range(vc.depth)
        ],
        "merger": {
            "ln_q": floats(d),
            "fc1": weight(out=merge_dim, inn=merge_dim), "fc1_bias": floats(merge_dim),
            "fc2": weight(out=vc.out_hidden_size, inn=merge_dim),
            "fc2_bias": floats(vc.out_hidden_size),
        },
    }
    L, h, hd = tc.num_layers, tc.hidden_size, tc.head_dim_
    qkv_out = (tc.num_heads + 2 * tc.num_kv_heads) * hd
    vocab_rows = -(-tc.vocab_size // 512) * 512

    def vocab():
        if mode == "int4":
            return weight(out=vocab_rows, inn=h)
        return random_q8(gen, vocab_rows, tc.vocab_size, h, device)

    text = {
        "embed_tokens": vocab(),
        "lm_head": vocab(),
        "final_norm": floats(h),
        "layers_stacked": {
            "input_norm": floats(L, h), "post_attn_norm": floats(L, h),
            "qkv_proj": weight(L, out=qkv_out, inn=h), "qkv_bias": floats(L, qkv_out),
            "o_proj": weight(L, out=h, inn=tc.num_heads * hd),
            "mlp": {
                "gateup_proj": weight(L, out=2 * tc.intermediate_size, inn=h),
                "down_proj": weight(L, out=h, inn=tc.intermediate_size),
            },
        },
    }
    return {"vision": vision, "text": text}


def build_target_engine(role: str, device, seed: int,
                        settings: Optional[ServingSettings] = None,
                        quantization: str = "int4") -> Engine:
    """Qwen2.5-VL-7B at full width and depth with random int4 or int8
    weights."""
    device = torch.device(device)
    cfg = _byte_token_ids(Qwen25VLConfig.qwen2_5_vl_7b())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = _random_target_params(cfg, gen, device, quantization)
    logger.info(f"{role}: target-scale Qwen2.5-VL-7B ({quantization}, random) on {device}")
    return Engine(f"target-{role}-qwen25vl-7b", cfg, params,
                  ByteTokenizer(vocab_size=cfg.text.vocab_size), device,
                  settings or ServingSettings())


def small_config() -> Qwen25VLConfig:
    """The JAX package's small Qwen2.5-VL dev profile."""
    return Qwen25VLConfig(
        vision=Qwen25VisionConfig(
            depth=4, hidden_size=256, intermediate_size=704, num_heads=4,
            out_hidden_size=1024, window_size=112, fullatt_block_indexes=(1, 3),
        ),
        text=DecoderConfig(
            vocab_size=1024, hidden_size=1024, num_layers=8, num_heads=8,
            num_kv_heads=2, intermediate_size=2816, rope_theta=1_000_000.0,
            qkv_bias=True, mrope_section=(16, 24, 24), tie_word_embeddings=True,
        ),
        image_token_id=261, vision_start_token_id=259,
        vision_end_token_id=260, eos_token_id=256,
    )


def build_small_engine(role: str, device, seed: int, quantization: str = "none",
                       vocab_mode: str = "int4",
                       settings: Optional[ServingSettings] = None) -> Engine:
    """The small profile: random-normal weights, layers stacked and fused,
    int4 or int8 text weights (vocab tables by ``vocab_mode``) when
    ``quantization`` says so; the vision tower stays float, as in the JAX
    package's small profile."""
    device = torch.device(device)
    cfg = small_config()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device)
    text = fuse_stacked_projections(stack_decoder_layers(params["text"]))
    if quantization in ("int4", "int8"):
        text = quantize_stacked_params(text, quantize_embeddings=True,
                                       vocab_mode=vocab_mode, mode=quantization)
    elif quantization != "none":
        raise NotImplementedError(f"QUANTIZATION={quantization} is not ported yet")
    params["text"] = text
    return Engine(f"dev-{role}-qwen25", cfg, params,
                  ByteTokenizer(vocab_size=cfg.text.vocab_size), device,
                  settings or ServingSettings())


def random_q8(gen: torch.Generator, rows: int, out: int, inn: int, device) -> QuantizedWeight:
    """A random int8 table [rows, inn] as the target profile makes it: random
    bytes and scales N(0,1)*0.005+0.01 for the first ``out`` rows, zeros
    (q and scale) for the padding rows past them."""
    q = torch.zeros((rows, inn), dtype=torch.int8, device=device)
    q[:out] = torch.randint(-128, 128, (out, inn), generator=gen, device=device,
                            dtype=torch.int8)
    scale = torch.zeros((rows,), dtype=torch.float32, device=device)
    scale[:out] = _random_floats(gen, out, device=device, dtype=torch.float32)
    return QuantizedWeight(q=q, scale=scale)


def _random_text_params(cfg: DecoderConfig, gen: torch.Generator, device,
                        mode: str = "int4") -> Dict[str, Any]:
    """A text decoder in its serving layout (stacked, fused; int4 or int8
    layers by ``mode``, int8 embedding and vocab head with rows padded to
    512), made leaf by leaf on the device like ``_random_target_params``."""
    L, h, hd = cfg.num_layers, cfg.hidden_size, cfg.head_dim_
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    rows = -(-cfg.vocab_size // 512) * 512
    make = _random_layer_weight(mode)

    def weight(*lead, out, inn):
        return make(gen, *lead, out=out, inn=inn, device=device)

    def floats(*shape):
        return _random_floats(gen, *shape, device=device)

    return {
        "embed_tokens": random_q8(gen, rows, cfg.vocab_size, h, device),
        "lm_head": random_q8(gen, rows, cfg.vocab_size, h, device),
        "final_norm": floats(h),
        "layers_stacked": {
            "input_norm": floats(L, h), "post_attn_norm": floats(L, h),
            "qkv_proj": weight(L, out=qkv_out, inn=h),
            "o_proj": weight(L, out=h, inn=cfg.num_heads * hd),
            "mlp": {
                "gateup_proj": weight(L, out=2 * cfg.intermediate_size, inn=h),
                "down_proj": weight(L, out=h, inn=cfg.intermediate_size),
            },
        },
    }


def build_target_text_engine(role: str, device, seed: int,
                             settings: Optional[ServingSettings] = None,
                             quantization: str = "int4") -> Engine:
    """Llama-3.1-8B at full width and depth: random int4 or int8 layers,
    int8 embedding and vocab head (128256 rows padded to 128512)."""
    device = torch.device(device)
    cfg = llama31_8b()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {"text": _random_text_params(cfg, gen, device, quantization)}
    logger.info(f"{role}: target-scale Llama-3.1-8B ({quantization} layers, int8 head, "
                f"random) on {device}")
    return Engine(f"target-{role}-llama31-8b", cfg, params,
                  ByteTokenizer(vocab_size=cfg.vocab_size), device,
                  settings or ServingSettings())


def small_text_config() -> DecoderConfig:
    """The JAX package's small text dev profile (``_dev_text_config``)."""
    return DecoderConfig(
        vocab_size=1024, hidden_size=1024, num_layers=8, num_heads=8,
        num_kv_heads=2, intermediate_size=2816, rope_theta=500000.0,
        qkv_bias=False, tie_word_embeddings=True,
    )


def build_small_text_engine(role: str, device, seed: int, quantization: str = "none",
                            vocab_mode: str = "int4", config: Optional[DecoderConfig] = None,
                            settings: Optional[ServingSettings] = None) -> Engine:
    """The small text profile (or ``config``): random-normal weights, layers
    stacked and fused, int4 or int8 layers and an int4/int8/none vocab head
    when ``quantization`` says so."""
    device = torch.device(device)
    cfg = config or small_text_config()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    text = fuse_stacked_projections(stack_decoder_layers(init_decoder_params(cfg, gen, device)))
    if quantization in ("int4", "int8"):
        text = quantize_stacked_params(text, quantize_embeddings=True,
                                       vocab_mode=vocab_mode, mode=quantization)
    elif quantization != "none":
        raise NotImplementedError(f"QUANTIZATION={quantization} is not ported yet")
    return Engine(f"dev-{role}", cfg, {"text": text},
                  ByteTokenizer(vocab_size=cfg.vocab_size), device,
                  settings or ServingSettings())


def _is_qwen25(model_name: str) -> bool:
    lower = model_name.lower()
    return "qwen2.5-vl" in lower or "qwen2_5_vl" in lower or "qwen2.5vl" in lower


def _vocab_mode(role: str) -> str:
    mode = (getattr(app_config, f"{role}_vocab_quantization", "")
            or app_config.vocab_quantization)
    return app_config.quantization if mode == "same" else mode


def build_engine(role: str, model_name: str, device, seed: int = 0) -> Engine:
    """An engine for a role from the app config (weightless profiles only):
    the inspector and auditor are VLMs, every other role a text model, as
    in the JAX package.  Settings that would change the reference's numbers
    and are not ported raise instead of being ignored."""
    if app_config.kv_quantization == "int8":
        raise NotImplementedError(
            "KV_QUANTIZATION=int8 is not ported: the port stores bf16 KV where "
            "the reference would store int8, so it refuses the setting"
        )
    quant = app_config.quantization
    settings = ServingSettings.from_app_config()
    target = app_config.dev_profile == "target"
    vocab_mode = _vocab_mode(role)
    if role not in ("inspector", "auditor"):
        if not target:
            return build_small_text_engine(role, device, seed, quant, vocab_mode,
                                           settings=settings)
        if quant not in ("int4", "int8") or vocab_mode != "int8":
            raise NotImplementedError(
                "the target text profile is ported for int4 or int8 layers with an "
                f"int8 vocab head, not QUANTIZATION={quant} with a {vocab_mode} head")
        return build_target_text_engine(role, device, seed, settings, quant)
    if not _is_qwen25(model_name):
        raise NotImplementedError(
            f"the port serves Qwen2.5-VL only among VLMs so far, not {model_name!r} ({role})"
        )
    if target:
        if quant not in ("int4", "int8") or vocab_mode != quant:
            raise NotImplementedError(
                "the target profile is ported for int4 or int8 layers with a vocab head "
                f"of the same precision, not QUANTIZATION={quant} with a {vocab_mode} head")
        return build_target_engine(role, device, seed, settings, quant)
    return build_small_engine(role, device, seed, quant, vocab_mode, settings)


def _maybe_attach_scheduler(role: str, engine: Engine) -> None:
    """CONTINUOUS_BATCHING=true attaches a scheduler to the engines of the
    roles in BATCHING_ROLES ("all" = every engine)."""
    roles = {r.strip() for r in app_config.batching_roles.split(",") if r}
    if app_config.continuous_batching and ("all" in roles or role in roles):
        engine.attach_scheduler()


_engines: Dict[tuple, Engine] = {}
_engine_lock = threading.Lock()


def get_engine_backend(role: str, model_name: str, device, seed: int = 0) -> EngineBackend:
    """The cached engine for (role, model, device, seed) and the settings
    that decide its weights (profile, layer and vocab precision), built on
    first use."""
    key = (role, model_name, str(torch.device(device)), seed, app_config.dev_profile,
           app_config.quantization, _vocab_mode(role))
    with _engine_lock:
        if key not in _engines:
            engine = build_engine(role, model_name, device, seed)
            _maybe_attach_scheduler(role, engine)
            _engines[key] = engine
        return EngineBackend(_engines[key])


__all__ = [
    "Engine",
    "EngineBackend",
    "ServingSettings",
    "build_engine",
    "build_small_engine",
    "build_small_text_engine",
    "build_target_engine",
    "build_target_text_engine",
    "get_engine_backend",
    "random_q4",
    "random_q8",
    "random_q8_stack",
    "load_constraint_tables",
]
