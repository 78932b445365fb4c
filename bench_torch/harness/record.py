"""The benchmark's own instrumentation around the calls into each layer.

Nothing here changes what the program computes.  ``Recorder.install``
wraps, for one run:

- the engine module's ``TokenStream``, so that every unbatched request's
  record holds the ids the engine served (its own list, filled in place);
- the engines' decode loops (``decode_loop_lookahead`` and the
  token-a-pass loops) and the scheduler's paged loops: a ``decode`` span,
  and the weight passes each call ran;
- ``Engine._prefill_request`` and ``Engine.encode_vision`` on each engine:
  ``prefill`` / ``vision`` spans, the prompt length and the image's
  patch grid (for the work arithmetic);
- a scheduler's ``submit_prefilled``: the request's served ids.

Spans are kept only while ``spans_on`` (traced runs), on the Unix clock
in ns, the clock of the profiler's events; the passes a request's decode
ran are always counted.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class Recorder:
    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self.requests: List[Dict[str, Any]] = []
        self.spans: List[tuple] = []
        self.spans_on = False
        # Tests only: "token" alters the first token of every decode call.
        self.fault: Optional[str] = None
        self._undo: List[Callable[[], None]] = []

    # -- request records ---------------------------------------------------
    def begin(self, **fields) -> Dict[str, Any]:
        rec = dict(fields)
        rec.setdefault("ids", None)
        rec.setdefault("text", None)
        rec.setdefault("error", None)
        self._local.rec = rec
        with self._lock:
            self.requests.append(rec)
        return rec

    def current(self) -> Optional[Dict[str, Any]]:
        return getattr(self._local, "rec", None)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.spans_on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.spans.append((name, t0, t1, threading.get_ident()))

    # -- patches ------------------------------------------------------------
    def _patch(self, owner, name: str, value) -> None:
        old = getattr(owner, name)
        setattr(owner, name, value)
        self._undo.append(lambda: setattr(owner, name, old))

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def _alter(self, tokens):
        """The test fault: the first token of a decode call, changed."""
        altered = tokens.clone()
        flat = altered.view(-1)
        flat[0] = (flat[0] + 1) % 256
        return altered

    def install(self, engine_mod, scheduler_mod, decoder_names=("decode_loop_lookahead",
                "decode_loop_scan", "decode_loop_scan_sampled",
                "decode_loop_scan_constrained")) -> None:
        rec_self = self

        class RecordedStream(engine_mod.TokenStream):
            def __init__(self, tokenizer):
                super().__init__(tokenizer)
                rec = rec_self.current()
                if rec is not None:
                    rec["ids"] = self.generated

        self._patch(engine_mod, "TokenStream", RecordedStream)

        for name in decoder_names:
            self._patch(engine_mod, name, self._wrap_decode(getattr(engine_mod, name), name))
        for name in ("decode_loop_paged", "decode_loop_paged_constrained"):
            self._patch(scheduler_mod, name, self._wrap_paged(getattr(scheduler_mod, name)))

    def _wrap_decode(self, fn, name: str):
        rec_self = self

        def wrapped(*args, **kwargs):
            with rec_self.span("decode"):
                out = fn(*args, **kwargs)
            if name == "decode_loop_lookahead":
                valid = out[1]
                passes = int(valid[:, :, 0].any(dim=0).sum())
            else:
                tokens = out[0]
                eos = kwargs.get("eos_id")
                row = tokens[0].tolist()
                passes = row.index(eos) + 1 if eos in row else len(row)
            rec = rec_self.current()
            if rec is not None:
                rec["passes"] = rec.get("passes", 0) + passes
            if rec_self.fault == "token":
                out = (rec_self._alter(out[0]),) + tuple(out[1:])
            return out

        return wrapped

    def _wrap_paged(self, fn):
        rec_self = self

        def wrapped(*args, **kwargs):
            with rec_self.span("scheduler.decode"):
                out = fn(*args, **kwargs)
            if rec_self.fault == "token":
                out = (rec_self._alter(out[0]),) + tuple(out[1:])
            return out

        return wrapped

    def watch_engine(self, engine) -> None:
        """Per-engine hooks: prefill and vision spans and sizes, and the
        scheduler's hand-off when one is attached."""
        rec_self = self
        prefill = engine._prefill_request
        encode = engine.encode_vision

        def prefill_wrapped(*args, **kwargs):
            with rec_self.span("prefill"):
                out = prefill(*args, **kwargs)
            rec = rec_self.current()
            if rec is not None:
                rec.setdefault("prefill_lens", []).append(int(out[3]))
            return out

        def encode_wrapped(image):
            with rec_self.span("vision"):
                out = encode(image)
            rec = rec_self.current()
            if rec is not None:
                rec["grid"] = (int(image.grid_h), int(image.grid_w))
            return out

        engine._prefill_request = prefill_wrapped
        engine.encode_vision = encode_wrapped
        sched = engine.scheduler
        if sched is not None:
            submit = sched.submit_prefilled

            def submit_wrapped(*args, **kwargs):
                request = submit(*args, **kwargs)
                rec = rec_self.current()
                if rec is not None:
                    rec["ids"] = request.generated
                    rec["scheduled"] = True
                return request

            sched.submit_prefilled = submit_wrapped


class RecordingBackend:
    """The agents' backend over an engine backend: each call opens a
    request record holding its prompt, image and decode settings."""

    def __init__(self, inner, recorder: Recorder, **tags):
        self.inner = inner
        self.engine = inner.engine
        self.name = inner.name
        self.recorder = recorder
        self.tags = tags

    def generate(self, prompt, image_path=None, **kwargs) -> str:
        rec = self.recorder.begin(prompt=prompt, image=image_path, kwargs=dict(kwargs),
                                  **self.tags)
        with self.recorder.span("generate"):
            try:
                text = self.inner.generate(prompt, image_path, **kwargs)
            except Exception as exc:
                rec["error"] = repr(exc)
                raise
        rec["text"] = text
        return text

    def health_check(self) -> bool:
        return self.inner.health_check()


__all__ = ["Recorder", "RecordingBackend"]
