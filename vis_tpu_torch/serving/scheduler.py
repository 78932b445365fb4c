"""Continuous-batching scheduler: many requests share one model's decode.

Counterpart of ``vis_tpu/serving/scheduler.py`` (paged layout).  One
scheduler thread owns a text model's decode state on the engine's device:

- S decode slots map their KV through a shared page pool
  (``serving/paged_kv.py``), pages reserved per request at admission; a
  hybrid decoder's slots also hold a fixed recurrent state each (its
  Mamba2 layers' conv ring and SSM state), moved in with the request;
- a request arrives prefilled (the engine's own prefill, handed over with
  ``submit_prefilled``) or as a prompt (``submit``: whole-prompt prefill
  here), and its staging cache is copied into its slot's pages;
- every active slot decodes together, ``decode_chunk`` tokens per chunk,
  each row under its own grammar (stacked constraint tables) and its own
  temperature; a chunk ends on the device side once every live row has hit
  EOS or its budget;
- tokens stream to per-request queues; finished slots free their pages and
  waiting requests take their place between chunks.

The host keeps mirrors of the cursors, positions, budgets and temperatures,
so building a chunk reads nothing back from the device: a chunk costs the
token read-back at its end, plus the per-step ``done`` check of the decode
loop (``models/common/decoder.py:_eos_loop``).

Sampled rows draw their uniforms from one ``torch.Generator`` on the
device, seeded once per scheduler (``seed``), so a run is deterministic for
a seed; it cannot reproduce ``jax.random``'s bits.  Not ported: dense
slots (``paged=False``) and chunked prefill, which raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import queue
import threading
import time
import uuid
from typing import Any, List, Optional

import numpy as np
import torch

from vis_tpu_torch.utils.logger import setup_logger, span, synced
from vis_tpu_torch.models.common.decoder import (
    DecodeConstraint,
    DecoderConfig,
    decode_loop_paged,
    decode_loop_paged_constrained,
    new_cache,
    prefill_scan,
)
from vis_tpu_torch.models.common.layers import KVCache, embed, recurrent_state
from vis_tpu_torch.serving.paged_kv import PagedKVPool

logger = setup_logger(__name__, level="INFO", component="SCHEDULER")

# Stacked-tables size budget (T * S_max * K entries; three such arrays live
# on the device), as in the JAX scheduler.
_MAX_STACKED_ENTRIES = 64_000_000


@dataclasses.dataclass
class Request:
    prompt: str
    max_tokens: int = 512
    request_id: str = dataclasses.field(default_factory=lambda: str(uuid.uuid4())[:8])
    # Stream of decoded text chunks; a final None marks completion.
    out: "queue.Queue[Optional[str]]" = dataclasses.field(default_factory=queue.Queue)
    generated: List[int] = dataclasses.field(default_factory=list)
    emitted: str = ""
    error: Optional[str] = None
    # Prefilled hand-off: (staging KVCache [b=1], first logits [1, V],
    # next rope position, kv_len or None).
    prefilled: Optional[Any] = None
    json_mode: bool = False
    schema: Optional[str] = None  # a stacked table's name (None = generic JSON)
    temperature: float = 0.0
    min_tokens: Optional[int] = None


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    position: int = 0          # next decode position (rope)
    remaining: int = 0

    @property
    def active(self) -> bool:
        return self.request is not None


class ContinuousBatchingScheduler:
    """Batched decode for one text model on one device (the engine does
    vision and prompt prefill before submission)."""

    def __init__(self, text_config: DecoderConfig, params: Any, tokenizer, device, *,
                 num_slots: int, max_len: int, paged: bool = True,
                 json_tables: Optional[Any] = None, page_size: int = 128,
                 pool_tokens: int = 16384, decode_chunk: int = 32,
                 chunked_prefill: int = 0, min_json_tokens: int = 0, seed: int = 0):
        if not paged:
            raise NotImplementedError(
                "dense scheduler slots (PAGED_KV_CACHE=false) are not ported; "
                "the port's scheduler decodes over the paged KV pool"
            )
        if chunked_prefill > 0:
            raise NotImplementedError(
                "chunked prefill (CHUNKED_PREFILL_TOKENS>0) is not ported")
        if "layers_stacked" not in params:
            raise ValueError("the scheduler takes the stacked parameter layout")
        self.config = text_config
        self.params = params
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.num_slots = num_slots
        self.max_len = max_len
        self.paged = True
        self.decode_chunk = decode_chunk
        self.min_json_tokens = min_json_tokens
        state = None
        if text_config.mamba_layers:
            state = functools.partial(recurrent_state, text_config.mamba,
                                      text_config.mamba_layers, num_slots, text_config.dtype,
                                      self.device)
        self.pool = PagedKVPool(
            text_config.kv_layers, num_slots, max_len, text_config.num_kv_heads,
            text_config.head_dim_, page_size=page_size, pool_tokens=pool_tokens,
            dtype=text_config.dtype, device=self.device, state=state,
        )
        logger.info(
            f"paged KV: {self.pool.n_pages - 1} pages x {page_size} tokens "
            f"({self.pool.memory_bytes() / 1e6:.0f} MB; dense layout would hold "
            f"{num_slots * max_len} tokens)"
        )
        self.slots = [_Slot() for _ in range(num_slots)]
        self._lengths_host = np.zeros((num_slots,), np.int64)
        self._temps_host = np.zeros((num_slots,), np.float32)
        self._logits = torch.zeros((num_slots, text_config.vocab_size),
                                   dtype=torch.float32, device=self.device)
        self._stack_tables(json_tables)

        def dev_zeros(dtype):
            return torch.zeros((num_slots,), dtype=dtype, device=self.device)

        self._fsm_table = dev_zeros(torch.int64)
        self._fsm_state = dev_zeros(torch.int64)
        self._fsm_remaining = torch.ones((num_slots,), dtype=torch.int64, device=self.device)
        self._fsm_active = dev_zeros(torch.bool)
        self._fsm_min_remaining = dev_zeros(torch.int64)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        # Seconds inside the batched decode dispatch + token read-back, and
        # counts: requests admitted, chunks and steps decoded, most slots
        # live in one chunk.
        self.decode_device_s_total = 0.0
        self.stats = {"admitted": 0, "chunks": 0, "steps": 0, "max_live": 0}
        self._pending: "queue.Queue[Request]" = queue.Queue()
        # Set by every submission: an idle scheduler thread sleeps on it
        # instead of polling, so it takes no host time (and no GIL) from the
        # other engines' threads while it has nothing to do.
        self._wake = threading.Event()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _stack_tables(self, json_tables) -> None:
        """Stack the grammars that fit ``_MAX_STACKED_ENTRIES``, in dict
        order, to [T, S_max, K_max] device tables (and [T, V] class maps);
        ``has_table`` reports which made it.  Padded states and columns are
        unreachable (cost 2**30)."""
        if json_tables is None:
            tables_map = {}
        elif isinstance(json_tables, dict):
            tables_map = {k: v for k, v in json_tables.items() if v is not None}
        else:
            tables_map = {None: json_tables}
        kept: dict = {}
        for name, tbl in tables_map.items():
            shapes = [t.token_ok.shape for t in kept.values()] + [tbl.token_ok.shape]
            entries = (len(kept) + 1) * max(s[0] for s in shapes) * max(s[1] for s in shapes)
            if kept and entries > _MAX_STACKED_ENTRIES:
                logger.info(f"constraint table '{name}' skipped: stacked size "
                            f"{entries} entries over budget")
                continue
            kept[name] = tbl
        self._tables_map = kept
        self._table_index = {name: i for i, name in enumerate(kept)}
        self._json_tables = kept.get(None)
        self._json_dev = None
        if not kept:
            return
        smax = max(t.token_ok.shape[0] for t in kept.values())
        kmax = max(t.token_ok.shape[1] for t in kept.values())
        compressed = any(t.class_of is not None for t in kept.values())
        oks, transs, costs, classes = [], [], [], []
        for t in kept.values():
            pad = ((0, smax - t.token_ok.shape[0]), (0, kmax - t.token_ok.shape[1]))
            oks.append(np.pad(t.token_ok, pad))
            transs.append(np.pad(t.token_trans, pad))
            costs.append(np.pad(t.cost_after, pad, constant_values=2**30))
            if compressed:
                classes.append(t.class_of)

        def dev(arrays):
            return torch.from_numpy(np.stack(arrays)).to(self.device)

        self._json_dev = (dev(oks), dev(transs), dev(costs),
                          dev(classes).long() if compressed else None)

    # -- public API ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="vis-tpu-torch-scheduler")
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _check_alive(self) -> None:
        """Fail fast when the scheduler loop is gone, instead of queueing a
        request that nothing will ever answer."""
        t = self._thread
        if self._shutdown.is_set() or (t is not None and not t.is_alive()):
            raise RuntimeError(
                "scheduler thread is not running; restart the scheduler "
                "(attach_scheduler) before submitting"
            )

    def has_table(self, schema: Optional[str]) -> bool:
        """True when ``schema`` (None = generic JSON) is in the stacked
        device tables, i.e. its requests can join batched decode."""
        return schema in self._table_index

    def _feasible_budget(self, json_mode: bool, max_tokens: int,
                         schema: Optional[str] = None) -> int:
        """A JSON row needs at least its grammar's min_budget tokens."""
        if json_mode:
            tables = self._tables_map.get(schema) or self._json_tables
            if tables is not None:
                return max(max_tokens, int(tables.min_budget))
        return max_tokens

    def _check_modes(self, json_mode: bool, temperature: float,
                     schema: Optional[str] = None) -> None:
        if json_mode and self._json_dev is None:
            raise ValueError("json_mode requires the scheduler to be built with "
                             "constraint tables (json_tables=)")
        if json_mode and schema is None and self._json_tables is None:
            raise ValueError("generic json_mode requires the scheduler's tables to "
                             "include the generic JSON grammar (key None)")
        if schema is not None and not json_mode:
            raise ValueError("schema= requires json_mode=True")
        if schema is not None and schema not in self._table_index:
            raise ValueError(
                f"schema '{schema}' is not in this scheduler's stacked tables "
                f"(have: {sorted(k for k in self._table_index if k)})")
        if temperature > 0.0 and self._json_dev is None:
            raise ValueError("sampled decode over the paged pool requires constraint "
                             "tables (the sampled paged loop rides the constrained path)")

    def submit(self, prompt: str, max_tokens: int = 512, json_mode: bool = False,
               temperature: float = 0.0, schema: Optional[str] = None,
               min_tokens: Optional[int] = None) -> Request:
        """Queue a prompt; the scheduler prefills it whole at admission."""
        self._check_alive()
        self._check_modes(json_mode, temperature, schema)
        request = Request(prompt=prompt,
                          max_tokens=self._feasible_budget(json_mode, max_tokens, schema),
                          json_mode=json_mode, temperature=temperature, schema=schema,
                          min_tokens=min_tokens)
        self._pending.put(request)
        self._wake.set()
        return request

    def submit_prefilled(self, src_cache: KVCache, first_logits: torch.Tensor,
                         next_position: int, max_tokens: int = 512,
                         kv_len: Optional[int] = None, json_mode: bool = False,
                         temperature: float = 0.0, schema: Optional[str] = None,
                         min_tokens: Optional[int] = None) -> Request:
        """Hand off a request the engine prefilled: ``src_cache`` is a
        batch-1 staging cache, page-aligned, whose writes have finished (the
        engine's prefill span ends in a device synchronise)."""
        self._check_alive()
        self._check_modes(json_mode, temperature, schema)
        request = Request(prompt="",
                          max_tokens=self._feasible_budget(json_mode, max_tokens, schema),
                          json_mode=json_mode, temperature=temperature, schema=schema,
                          min_tokens=min_tokens)
        request.prefilled = (src_cache, first_logits, int(next_position), kv_len)
        self._pending.put(request)
        self._wake.set()
        return request

    @property
    def active_count(self) -> int:
        return sum(1 for s in self.slots if s.active)

    # -- admission -------------------------------------------------------
    def _fail(self, request: Request, error: str) -> None:
        request.error = error
        request.out.put(None)
        logger.error(f"{request.request_id}: {error}")

    def _reserve_paged(self, free: int, request: Request, kv_len: int) -> bool:
        """Reserve prompt + max_tokens + one chunk of slack (a chunk's steps
        past a slot's budget land in its own pages and are rewound).  A
        request that can never fit errors out; one that does not fit now is
        requeued."""
        budget = kv_len + request.max_tokens + self.decode_chunk
        need = self.pool.pages_for(budget)
        if need > self.pool.n_pages - 1 or need > self.pool.max_pages:
            limit = min(self.pool.n_pages - 1, self.pool.max_pages) * self.pool.page_size
            self._fail(request, f"request KV budget ({budget} tokens) exceeds the "
                                f"paged-KV limit ({limit} tokens)")
            return False
        if not self.pool.try_reserve(free, budget):
            logger.info(f"page pool full ({self.pool.free_pages} pages free); "
                        f"requeueing {request.request_id}")
            self._pending.put(request)
            return False
        return True

    def _prefill_prompt(self, ids: List[int]):
        """Whole-prompt prefill into a bucket-sized staging cache (the
        prompt's KV only; decode writes go to the pool)."""
        seq_len = len(ids)
        bucket = max(128, self.pool.page_size)
        while bucket < seq_len:
            bucket *= 2
        bucket = min(bucket, self.max_len)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :seq_len] = ids
        embeds = embed(torch.from_numpy(padded).to(self.device), self.params["embed_tokens"])
        positions = torch.arange(bucket, dtype=torch.int32, device=self.device)[None]
        cache = new_cache(self.config, 1, bucket, self.device)
        return prefill_scan(self.config, self.params, embeds, positions, cache, [seq_len])

    def _admit_one(self) -> bool:
        """Move one waiting request into a free slot; True if one was admitted."""
        free = next((i for i, s in enumerate(self.slots) if s.request is None), None)
        if free is None:
            return False
        try:
            request = self._pending.get_nowait()
        except queue.Empty:
            return False
        self.pool.ensure_buffers()
        try:
            if request.prefilled is not None:
                cache, logits, seq_len, kv_len = request.prefilled
                if kv_len is None:
                    kv_len = cache.lengths_host[0]
                if not self._reserve_paged(free, request, kv_len):
                    return False  # requeued (hand-off kept) or failed
                request.prefilled = None
            else:
                ids = self.tokenizer.encode(request.prompt)
                room = self.max_len - request.max_tokens - 1
                if room < 2:
                    self._fail(request, f"max_tokens ({request.max_tokens}) leaves no "
                                        f"prompt room in max_len ({self.max_len})")
                    return False
                if len(ids) > room:
                    ids = ids[: room // 2] + ids[-(room - room // 2):]
                seq_len = kv_len = len(ids)
                if not self._reserve_paged(free, request, kv_len):
                    return False  # requeued before spending the prefill
                logits, cache = self._prefill_prompt(ids)
            self._activate_slot(free, request, cache, logits, seq_len, kv_len)
            return True
        except Exception as exc:
            logger.error(f"Prefill failed for {request.request_id}: {exc}", exc_info=True)
            self._fail(request, str(exc))
            self.pool.release(free)
            return False

    def _activate_slot(self, free: int, request: Request, cache: KVCache,
                       logits: torch.Tensor, seq_len: int, kv_len: int) -> None:
        """Copy a batch-1 staging cache into the slot's reserved pages and
        arm the slot's cursor, budget, temperature and grammar row.  A
        hybrid request's recurrent state replaces the slot's whole state:
        nothing of the slot's last occupant carries over."""
        page = self.pool.page_size
        n_src = cache.k.shape[2] // page
        owned = self.pool._owned[free][:n_src]
        idx = torch.tensor(owned, dtype=torch.int64, device=self.device)
        for src, dst in ((cache.k, self.pool.k), (cache.v, self.pool.v)):
            pages = src[:, 0, : n_src * page].reshape(src.shape[0], n_src, page, *src.shape[3:])
            dst[:, idx] = pages[:, : len(owned)].to(dst.dtype)
        if self.pool.state is not None:
            for src, dst in zip((cache.conv, cache.ssm), self.pool.state):
                dst[:, free] = src[:, 0]
        self._logits[free] = logits[0].to(torch.float32)
        slot = self.slots[free]
        slot.request = request
        self.stats["admitted"] += 1
        slot.position = seq_len
        slot.remaining = request.max_tokens
        self._lengths_host[free] = kv_len
        self._temps_host[free] = max(0.0, request.temperature)
        if self._json_dev is not None:
            tables = self._tables_map.get(request.schema) if request.json_mode else None
            floor = request.min_tokens if request.min_tokens is not None \
                else self.min_json_tokens
            min_tok = min(max(floor, 0), request.max_tokens - 32)
            self._fsm_table[free] = (self._table_index.get(request.schema, 0)
                                     if request.json_mode else 0)
            self._fsm_state[free] = tables.init_state if tables is not None else 0
            self._fsm_remaining[free] = request.max_tokens
            self._fsm_active[free] = bool(request.json_mode)
            self._fsm_min_remaining[free] = request.max_tokens - max(min_tok, 0)
        logger.info(f"Admitted {request.request_id} into slot {free} "
                    f"(prompt {seq_len} tokens, active {self.active_count})")

    # -- decode ----------------------------------------------------------
    def _draw_uniforms(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self._generator, device=self.device).clamp_min_(1e-20)

    def _decode_once(self) -> None:
        """One chunk of batched decode over all slots: up to ``decode_chunk``
        tokens per active slot, ending early once every live row has hit
        EOS or its budget.  Inactive rows compute garbage at their zeroed
        cursors into the trash page."""
        # The chunk's span holds the transfers that set it up beside its
        # decode span, so a trace counts every transfer of the chunk.
        with span("scheduler.chunk", timed=False):
            steps, prev_lengths, token_matrix = self._decode_chunk()
        with span("scheduler.host"):
            self._postprocess_chunk(steps, prev_lengths, token_matrix)

    def _decode_chunk(self):
        """The device side of a chunk: (steps, the cursors before it, its
        token matrix on the host)."""
        steps = self.decode_chunk
        positions = np.zeros((self.num_slots,), np.int64)
        budget = [0] * self.num_slots
        for i, slot in enumerate(self.slots):
            if slot.active:
                positions[i] = slot.position
                budget[i] = max(0, slot.remaining)
        prev_lengths = self._lengths_host.copy()
        start_pos, cursors = synced(torch.from_numpy(np.stack([positions, prev_lengths])).to,
                                    self.device)
        any_sampled = any(s.active and self._temps_host[i] > 0
                          for i, s in enumerate(self.slots))
        self.stats["chunks"] += 1
        self.stats["max_live"] = max(self.stats["max_live"], self.active_count)
        start = time.perf_counter()
        with span("scheduler.decode"):
            common = dict(eos_id=self.tokenizer.eos_id, budget=budget, state=self.pool.state)
            if self._json_dev is not None:
                ok_t, trans_t, cost_t, cls_t = self._json_dev
                constraint = DecodeConstraint(
                    token_ok=ok_t, token_trans=trans_t, cost_after=cost_t,
                    state=self._fsm_state, remaining=self._fsm_remaining,
                    active=self._fsm_active, min_remaining=self._fsm_min_remaining,
                    class_of=cls_t, table_idx=self._fsm_table,
                )
                if any_sampled:
                    common.update(
                        draw_uniforms=self._draw_uniforms,
                        temperature=synced(torch.from_numpy(self._temps_host).to,
                                           self.device))
                tokens, self._logits, _, _, lengths, constraint = decode_loop_paged_constrained(
                    self.config, self.params, self._logits, start_pos, self.pool.k,
                    self.pool.v, self.pool.page_tables, cursors, constraint, steps,
                    **common)
                # Finished slots keep stale DFA rows until their next admission.
                self._fsm_state = constraint.state
                self._fsm_remaining = constraint.remaining
            else:
                tokens, self._logits, _, _, lengths = decode_loop_paged(
                    self.config, self.params, self._logits, start_pos, self.pool.k,
                    self.pool.v, self.pool.page_tables, cursors, steps, **common)
            # The chunk's one read-back: its tokens, and the cursors, which
            # every step advances for every row.
            back = synced(torch.cat([tokens, lengths[:, None].to(tokens.dtype)], dim=1).cpu)
            back = back.numpy()
        token_matrix = back[:, :-1]
        self.stats["steps"] += int(back[0, -1] - prev_lengths[0])
        self.decode_device_s_total += time.perf_counter() - start
        return steps, prev_lengths, token_matrix

    def _postprocess_chunk(self, steps, prev_lengths, token_matrix) -> None:
        """Host side of a chunk: keep tokens up to EOS/budget, stream deltas,
        retire finished slots, rewind cursors past the kept tokens."""
        lengths = prev_lengths + steps
        for i, slot in enumerate(self.slots):
            if not slot.active:
                lengths[i] = prev_lengths[i]
                continue
            request = slot.request
            kept = 0
            finished = False
            for token_id in token_matrix[i].tolist():
                if kept >= slot.remaining or token_id == self.tokenizer.eos_id:
                    finished = True
                    break
                request.generated.append(token_id)
                kept += 1
            slot.position += kept
            slot.remaining -= kept
            if slot.remaining <= 0:
                finished = True
            text = self.tokenizer.decode(request.generated)
            if len(text) > len(request.emitted) and not text.endswith("�"):
                request.out.put(text[len(request.emitted):])
                request.emitted = text
            if finished:
                # Final flush without the replacement-char guard: at the end,
                # whatever decoded is the output.
                if len(text) > len(request.emitted):
                    request.out.put(text[len(request.emitted):])
                    request.emitted = text
                slot.request = None
                lengths[i] = 0
                self._temps_host[i] = 0.0
                # Release before signalling completion, so a caller that sees
                # the end of its stream also sees its pages back in the pool.
                self.pool.release(i)
                request.out.put(None)
                logger.info(f"Finished {request.request_id} ({len(request.generated)} tokens)")
            else:
                lengths[i] = prev_lengths[i] + kept
        self._lengths_host = lengths

    def _run(self) -> None:
        logger.info(f"Scheduler started: {self.num_slots} slots, max_len {self.max_len}")
        on_device = (torch.cuda.device(self.device) if self.device.type == "cuda"
                     else contextlib.nullcontext())
        with on_device:
            while not self._shutdown.is_set():
                self._wake.clear()  # a submission from here on wakes the wait below
                admitted = False
                # Drain the queue before decoding, so simultaneous arrivals
                # share the first chunk.  An admission fault that escapes
                # _admit_one's handler must not kill the thread.
                try:
                    while self._admit_one():
                        admitted = True
                except Exception as exc:
                    logger.exception(f"request admission failed: {exc}")
                if self.active_count == 0:
                    if not admitted:
                        if (self.pool.k is not None and not self.pool._owned
                                and self._pending.empty()):
                            self.pool.release_buffers()  # fully idle
                        self._wake.wait(timeout=1.0)
                    continue
                try:
                    self._decode_once()
                except Exception as exc:
                    # A failed chunk errors out the active slots and keeps
                    # serving: callers always get their terminating None.
                    logger.exception(f"batched decode chunk failed: {exc}")
                    self._fail_active(exc)
        logger.info("Scheduler stopped")

    def _fail_active(self, exc: Exception) -> None:
        """Error out every active slot after a decode-chunk fault."""
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            request = slot.request
            slot.request = None
            self._lengths_host[i] = 0
            self._temps_host[i] = 0.0
            try:
                self.pool.release(i)
            except Exception:
                logger.exception(f"page release failed for slot {i}")
            self._fail(request, f"batched decode failed: {exc}")


__all__ = ["ContinuousBatchingScheduler", "Request"]
