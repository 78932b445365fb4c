"""Single-request loop-decode engine: prefill, then schema-constrained
lookahead windows or greedy chunks, with EOS early exit.

Counterpart of ``vis_tpu/serving/loop_engine.py`` (``LoopDecodeEngine``,
``LoopEngineBackend``), parameterized over a model family's forward; the
Mllama auditor (``serving/engine_mllama.py``) subclasses it.  Subclasses
provide:

  _model_forward(embeds, positions, aux, cache, mask) -> (hidden, cache)
  _model_logits(hidden)            f32 logits
  _embed_tokens(token_ids)
  _prepare_aux(image_path)         per-request vision work (None: text only)
  _prompt_ids(prompt, aux)         token ids with any placeholders
  _cache_geometry()                (n_layers, kv_heads, head_dim, dtype)
  _vocab_size

The engine takes its serving settings as arguments (``ServingSettings``)
and keeps every tensor on its ``device``.  It decodes as the reference's
does: schema-constrained lookahead windows (a 2..16 window), else one
token a pass in fused chunks of ``decode_chunk`` steps, under a grammar
or free-form, greedy or Gumbel-sampled from a per-request device
generator seeded 0.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vis_tpu_torch.models.common.decoder import (
    TokenPicker,
    _eos_loop,
    lookahead_decode,
)
from vis_tpu_torch.models.common.layers import KVCache, causal_mask, length_mask
from vis_tpu_torch.serving.engine import (
    EngineBackend,
    ServingSettings,
    TokenStream,
    chunked_decode,
    load_constraint_tables,
    request_constraint,
    request_uniforms,
    use_lookahead,
    window_tokens,
)
from vis_tpu_torch.utils.logger import setup_logger, span, synced

logger = setup_logger(__name__, level="INFO", component="LOOP_ENGINE")


class LoopDecodeEngine:
    """One model on one torch device, one request at a time."""

    span_prefix: str = "loop"  # subclasses name their spans ("mllama", ...)

    def __init__(self, name: str, params, tokenizer, device, settings: ServingSettings):
        self.name = name
        self.params = params
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.settings = settings
        self._lock = threading.Lock()
        self._json = {}
        self.last_decode_tokens: Optional[int] = None
        self.decode_tokens_total = 0
        # Seconds inside the decode block of generate (ended on the
        # device's clock), the reference's telemetry twin.
        self.decode_device_s_total = 0.0
        # What a request's kernel launches follow from: its prefill bucket
        # and its decode windows (or greedy steps).
        self.last_prefill_bucket: Optional[int] = None
        self.last_decode_passes = 0

    # -- subclass contract ------------------------------------------------
    def _model_forward(self, embeds, positions, aux, cache, mask):
        raise NotImplementedError

    def _model_logits(self, hidden):
        raise NotImplementedError

    def _embed_tokens(self, token_ids):
        raise NotImplementedError

    def _prepare_aux(self, image_path: Optional[Path]):
        return None

    def _prompt_ids(self, prompt: str, aux) -> List[int]:
        raise NotImplementedError

    def _cache_geometry(self):
        raise NotImplementedError

    @property
    def _vocab_size(self) -> int:
        raise NotImplementedError

    # -- helpers ------------------------------------------------------------
    def _sync(self) -> None:
        """End a span on the device's clock, not the host's enqueue."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _json_tables(self, schema: Optional[str]):
        if schema not in self._json:
            self._json[schema] = load_constraint_tables(
                self.tokenizer, self._vocab_size, schema, self.device)
        if self._json[schema] is None and schema is not None:
            return self._json_tables(None)
        return self._json[schema]

    def _uniforms(self) -> Callable[[Tuple[int, ...]], torch.Tensor]:
        return request_uniforms(self.device)

    # -- prefill and decode ---------------------------------------------------
    def _prefill(self, embeds, positions, aux, cache: KVCache, seq_len: int) -> torch.Tensor:
        """The padded prompt through the model into a fresh cache (keys
        past ``seq_len`` masked); returns the last valid position's logits,
        the cursor at ``seq_len``."""
        s, max_len = embeds.shape[1], cache.k.shape[2]
        lengths = torch.tensor([seq_len], dtype=torch.int32, device=self.device)
        mask = causal_mask(s, max_len, self.device) + length_mask(max_len, lengths)
        hidden, cache = self._model_forward(embeds, positions, aux, cache, mask)
        cache.set_lengths([seq_len])
        return self._model_logits(hidden[:, seq_len - 1:seq_len])[:, 0]

    def _decode_chunk(self, logits, aux, cache: KVCache, start: int, steps: int,
                      pick: Callable[[torch.Tensor], torch.Tensor]):
        """Up to ``steps`` tokens, one pass each, ``pick(logits) -> token``
        (greedy, sampled or grammar-masked), on the ``_eos_loop`` scaffold:
        the step that picks EOS still runs its pass, as the reference's
        loop body does, and the chunk ends there.  Returns (tokens [1,
        steps], last logits)."""
        carry = {"logits": logits}

        def step(step_idx):
            token = pick(carry["logits"])
            positions = torch.full((1, 1), start + step_idx, dtype=torch.int32,
                                   device=self.device)
            hidden, _ = self._model_forward(
                self._embed_tokens(token[:, None]), positions, aux, cache, cache.decode_mask())
            carry["logits"] = self._model_logits(hidden)[:, 0]
            self.last_decode_passes += 1
            return token

        tokens = _eos_loop(1, steps, self.tokenizer.eos_id, None, step, self.device)
        return tokens, carry["logits"]

    def _window_extend(self, aux):
        """``lookahead_decode``'s pass for one row: the window's K/V written
        at the cursor (causal within the window, keys past the valid span
        masked), the cursor moved by the valid length, so the next window
        overwrites the padding's K/V."""
        def extend(w_tokens, w_valid, positions, cache: KVCache, valid_len):
            n, length0 = valid_len[0], cache.lengths_host[0]
            max_len = cache.k.shape[2]
            new_len = synced(torch.tensor, [length0 + n], dtype=torch.int32,
                             device=self.device)
            mask = (causal_mask(w_tokens.shape[1], max_len, self.device, offset=length0)
                    + length_mask(max_len, new_len))
            hidden, cache = self._model_forward(
                self._embed_tokens(w_tokens), positions, aux, cache, mask)
            cache.set_lengths([length0 + n])
            self.last_decode_passes += 1
            return self._model_logits(hidden[:, n - 1:n])[:, 0], cache

        return extend

    # -- public API ----------------------------------------------------------
    def generate_stream(self, prompt: str, image_path=None, *, max_tokens: int = 1024,
                        temperature: float = 0.0, max_image_dim: int = 1024,
                        json_mode: bool = False, json_schema: Optional[str] = None,
                        schema_batched: bool = False,
                        min_tokens: Optional[int] = None) -> Iterator[str]:
        # max_image_dim and schema_batched keep the backend interface: the
        # tiler sizes its own canvas, and no scheduler is attached here.
        with self._lock:
            yield from self._generate(prompt, image_path, max_tokens, json_mode=json_mode,
                                      temperature=temperature, json_schema=json_schema,
                                      min_tokens=min_tokens)

    def _generate(self, prompt, image_path, max_tokens, json_mode: bool = False,
                  temperature: float = 0.0, json_schema: Optional[str] = None,
                  min_tokens: Optional[int] = None) -> Iterator[str]:
        # The constraint tables first: a schema raises max_tokens to its
        # least feasible budget, and the cache is sized from max_tokens.
        json_tables = self._json_tables(json_schema) if json_mode else None
        if json_tables is not None:
            max_tokens = max(max_tokens, json_tables[-1].min_budget)
        aux = self._prepare_aux(image_path)

        ids = self._prompt_ids(prompt, aux)
        cap = self.settings.max_cache_tokens
        budget = cap - max_tokens - 1
        if budget < 2:
            # ids[:0] + ids[-0:] would be the whole prompt: fail loudly.
            raise RuntimeError(
                f"max_tokens={max_tokens} leaves no prompt room in a {cap}-token KV "
                "cache; lower max_tokens or raise KV_CACHE_MAX_TOKENS")
        if len(ids) > budget:
            ids = ids[:budget // 2] + ids[-(budget - budget // 2):]
        seq_len = len(ids)
        bucket = 128
        while bucket < seq_len:
            bucket *= 2
        bucket = min(bucket, cap)
        padded = np.zeros((1, bucket), dtype=np.int64)
        padded[0, :seq_len] = ids
        positions = torch.arange(bucket, dtype=torch.int32, device=self.device)[None]
        n_layers, kv_heads, head_dim, cache_dtype = self._cache_geometry()
        # Sized to the request: prompt bucket + budget + 17 (a window writes
        # up to window - 1 padding positions past the final cursor), 128-aligned.
        cache_len = min(cap, ((bucket + max_tokens + 17 + 127) // 128) * 128)
        cache = KVCache.create(n_layers, 1, cache_len, kv_heads, head_dim, cache_dtype,
                               self.device)
        self.last_prefill_bucket, self.last_decode_passes = bucket, 0
        embeds = self._embed_tokens(torch.from_numpy(padded).to(self.device))
        with span(f"{self.span_prefix}.prefill", logger):
            logits = self._prefill(embeds, positions, aux, cache, seq_len)
            self._sync()

        stream = TokenStream(self.tokenizer)
        draw = self._uniforms() if temperature > 0.0 else None
        decode_start = time.perf_counter()
        with span(f"{self.span_prefix}.decode", logger):
            constraint = None
            if json_tables is not None:
                floor = min_tokens if min_tokens is not None else self.settings.min_json_tokens
                constraint = request_constraint(json_tables, max_tokens, floor, self.device)
            if constraint is not None and use_lookahead(self.settings.lookahead, json_tables):
                yield from self._constrained_decode(
                    logits, aux, cache, seq_len, json_tables, constraint, max_tokens, draw,
                    temperature, stream)
            else:
                carry = {"logits": logits}
                pick = TokenPicker(constraint, draw, temperature)

                def run(pos, steps):
                    tokens, carry["logits"] = self._decode_chunk(
                        carry["logits"], aux, cache, pos, steps, pick)
                    return tokens

                yield from chunked_decode(run, seq_len, max_tokens, self.settings.decode_chunk,
                                          self.tokenizer.eos_id, stream)
            self._sync()
        self.decode_device_s_total += time.perf_counter() - decode_start
        self.last_decode_tokens = len(stream.generated)
        self.decode_tokens_total += len(stream.generated)
        yield from stream.finish()

    def _constrained_decode(self, logits, aux, cache, seq_len, json_tables, constraint,
                            max_tokens, draw, temperature,
                            stream: TokenStream) -> Iterator[str]:
        """Schema-constrained decode in lookahead windows of
        ``settings.lookahead`` tokens, ``settings.decode_chunk`` windows a
        call, until EOS or the budget."""
        tables = json_tables[-1]
        forced_tok = synced(torch.from_numpy(tables.forced_token).to, self.device)
        forced_state = synced(torch.from_numpy(tables.forced_state).to, self.device)
        eos = self.tokenizer.eos_id
        remaining, pos, done = max_tokens, seq_len, False
        extend = self._window_extend(aux)
        while remaining > 0 and not done:
            tokens, valid, logits, cache, constraint = lookahead_decode(
                logits, pos, cache, constraint, forced_tok, forced_state,
                self.settings.decode_chunk, self.settings.lookahead, extend, draw,
                temperature, eos)
            emitted_n, done = window_tokens(tokens[0].tolist(), valid[0].tolist(), eos,
                                            remaining, stream.generated)
            yield from stream.progress()
            remaining -= emitted_n
            pos += emitted_n

    def generate(self, prompt, image_path=None, **kwargs) -> str:
        return "".join(self.generate_stream(prompt, image_path, **kwargs))

    def health_check(self) -> bool:
        try:
            self.generate("OK?", None, max_tokens=2)
            return True
        except Exception as exc:  # a health probe reports, it does not raise
            logger.error(f"{self.name} health check failed: {exc}")
            return False


# The port's one engine backend (``cuda:<engine>``) adapts loop engines too.
LoopEngineBackend = EngineBackend


__all__ = ["LoopDecodeEngine", "LoopEngineBackend"]
