"""Structured logging with request-ID correlation and secret masking.

Covers the reference's logging surface (reference: utils/logger.py:27-351):
colored console output, JSON file logs, request-ID context propagation,
sensitive-value masking, and console banners/tables.  colorlog/rich are
replaced by plain ANSI escape codes so the module has zero dependencies;
per-stage device timings are added for the GPU execution path.
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import re
import sys
import threading
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

_LEVEL_COLORS = {
    "DEBUG": "\x1b[36m",     # cyan
    "INFO": "\x1b[32m",      # green
    "WARNING": "\x1b[33m",   # yellow
    "ERROR": "\x1b[31m",     # red
    "CRITICAL": "\x1b[1;31m",
}
_RESET = "\x1b[0m"
_DIM = "\x1b[2m"

# Request-ID context: thread-local with a global fallback, replacing the
# reference's unsynchronized module dict (utils/logger.py:24) since this
# framework runs a real multi-threaded serving tier.
_context = threading.local()
_global_request_id: Optional[str] = None
_lock = threading.Lock()

_SECRET_PATTERNS = [
    re.compile(r"(hf_[A-Za-z0-9]{4})[A-Za-z0-9]+"),
    re.compile(r"(gsk_[A-Za-z0-9]{4})[A-Za-z0-9]+"),
    re.compile(r"(sk-[A-Za-z0-9]{4})[A-Za-z0-9]+"),
    re.compile(r"((?:api[_-]?key|token|secret|password)\s*[=:]\s*)\S+", re.IGNORECASE),
]


def set_request_id(request_id: Optional[str]) -> None:
    """Bind a request ID to the current thread (and as global fallback)."""
    global _global_request_id
    _context.request_id = request_id
    with _lock:
        _global_request_id = request_id


def get_request_id() -> Optional[str]:
    rid = getattr(_context, "request_id", None)
    if rid is not None:
        return rid
    return _global_request_id


class SensitiveDataFilter(logging.Filter):
    """Mask API-key-shaped substrings in log messages (reference utils/logger.py:44-68)."""

    def filter(self, record: logging.LogRecord) -> bool:
        msg = record.getMessage()
        masked = msg
        for pattern in _SECRET_PATTERNS:
            masked = pattern.sub(lambda m: m.group(1) + "****", masked)
        if masked != msg:
            record.msg = masked
            record.args = ()
        return True


class ContextFilter(logging.Filter):
    """Inject the current request ID into every record."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.request_id = get_request_id() or "-"
        return True


class _ConsoleFormatter(logging.Formatter):
    def __init__(self, component: str, use_color: bool = True):
        super().__init__()
        self.component = component
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        level = record.levelname
        rid = getattr(record, "request_id", "-")
        component = getattr(record, "component", self.component)
        msg = record.getMessage()
        if record.exc_info:
            msg = msg + "\n" + self.formatException(record.exc_info)
        if self.use_color:
            color = _LEVEL_COLORS.get(level, "")
            return f"{_DIM}[{ts}]{_RESET} {color}{level:<8}{_RESET} {_DIM}[{rid}]{_RESET} [{component}] {msg}"
        return f"[{ts}] {level:<8} [{rid}] [{component}] {msg}"


class _JsonFormatter(logging.Formatter):
    def __init__(self, component: str):
        super().__init__()
        self.component = component

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "request_id": getattr(record, "request_id", None),
            "component": getattr(record, "component", self.component),
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload, ensure_ascii=False)


def setup_logger(
    name: str,
    level: str = "INFO",
    component: str = "APP",
    log_dir: Optional[Path] = None,
    to_console: bool = True,
    to_file: bool = True,
) -> logging.Logger:
    """Create (or reconfigure) a named logger with console + JSON-file handlers.

    Mirrors the reference's setup_logger API (utils/logger.py:84).
    """
    logger = logging.getLogger(name)
    # LOG_LEVEL is the operator's knob; call sites all pass the INFO
    # default, so the env var must win — and it must win on EVERY call,
    # because repeat setup_logger() for an already-configured name skips
    # the handlers block but still runs this setLevel.
    effective = level
    try:
        from vis_tpu_torch.utils.config import get_config

        cfg_level = get_config().log_level
        if cfg_level:
            effective = cfg_level
    except Exception:
        pass
    logger.setLevel(getattr(logging, effective.upper(), logging.INFO))
    logger.propagate = False

    if not logger.handlers:  # configure once; idempotent on repeat calls
        logger.addFilter(SensitiveDataFilter())
        logger.addFilter(ContextFilter())

        # Honor LOG_TO_CONSOLE / LOG_TO_FILE / LOG_FORMAT (reference
        # utils/config.py logging block) unless the caller overrides.
        json_console = False
        try:
            from vis_tpu_torch.utils.config import get_config

            cfg = get_config()
            to_console = to_console and cfg.log_to_console
            to_file = to_file and cfg.log_to_file
            json_console = cfg.log_format.lower() == "json"
        except Exception:
            pass

        if to_console:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                _JsonFormatter(component) if json_console
                else _ConsoleFormatter(component, use_color=sys.stderr.isatty())
            )
            logger.addHandler(handler)

        if to_file:
            try:
                if log_dir is None:
                    from vis_tpu_torch.utils.config import get_config

                    log_dir = get_config().get_log_dir()
                log_dir = Path(log_dir)
                log_dir.mkdir(parents=True, exist_ok=True)
                fh = logging.FileHandler(log_dir / "vis_tpu_torch.jsonl")
                fh.setFormatter(_JsonFormatter(component))
                logger.addHandler(fh)
            except Exception:  # never fail caller setup because of file logging
                pass

    # Stamp component onto records via an adapter (the record factory is
    # process-global, so per-logger component tagging must go through extra=).
    class _ComponentAdapter(logging.LoggerAdapter):
        def process(self, msg: str, kwargs: Dict[str, Any]) -> Tuple[str, Dict[str, Any]]:
            extra = kwargs.setdefault("extra", {})
            extra.setdefault("component", component)
            return msg, kwargs

    return _ComponentAdapter(logger, {})  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Device-timing spans (replacement for LangSmith tracing; SURVEY §5.1)
# ---------------------------------------------------------------------------
#
# While a torch profiler records (in any thread of the process), every span
# also leaves one timestamped record in a bounded list (get_trace) and opens
# a ``record_function`` range of its name, so the program's spans sit on the
# profiler's timeline beside the kernels.  A record: name, id, parent (the
# innermost span open in the same thread), thread, start_ns and end_ns on
# time.time_ns(), the clock of the profiler's device events.  With no
# profiler the added work is one flag check.

_timings: Dict[str, List[float]] = {}
TRACE_CAP = 1 << 18  # records kept; the oldest go first
_trace: Deque[Dict[str, Any]] = collections.deque(maxlen=TRACE_CAP)
_span_ids = itertools.count(1)
_open = threading.local()  # .stack: this thread's open records, innermost last
_NO_SPAN = nullcontext()


def tracing() -> bool:
    """True while a torch profiler records anywhere in the process (torch's
    own process-wide flag: the profiler's C++ state is per thread, and the
    scheduler decodes in a thread of its own)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


class _Span:
    __slots__ = ("name", "logger", "timed", "start", "rec", "stack", "profiler_range")

    def __init__(self, name, logger, timed):
        self.name, self.logger, self.timed = name, logger, timed
        self.rec = None

    def __enter__(self) -> None:
        if tracing():
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            rec = {"name": self.name, "id": next(_span_ids),
                   "parent": stack[-1]["id"] if stack else None,
                   "thread": threading.get_ident()}
            stack.append(rec)
            self.rec, self.stack = rec, stack
            self.profiler_range = sys.modules["torch.autograd.profiler"].record_function(self.name)
            self.profiler_range.__enter__()
            rec["start_ns"] = time.time_ns()
        self.start = time.perf_counter()

    def __exit__(self, *exc) -> None:
        elapsed = time.perf_counter() - self.start
        rec = self.rec
        if rec is not None:
            rec["end_ns"] = time.time_ns()
            self.profiler_range.__exit__(None, None, None)
            # Off the stack of the thread that opened it: a generator's span
            # may close after a later one, or in another thread.
            stack = self.stack
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is rec:
                    del stack[i]
                    break
            with _lock:
                _trace.append(rec)
        if self.timed:
            with _lock:
                _timings.setdefault(self.name, []).append(elapsed)
        if self.logger is not None:
            self.logger.debug(f"[span] {self.name}: {elapsed*1000:.1f} ms")


def span(name: str, logger: Optional[logging.Logger] = None, *, timed: bool = True):
    """Wall-clock span; accumulates per-stage timings retrievable via
    get_timings().  ``timed=False`` keeps it out of them (a span per weight
    pass or transfer; with no profiler it is then a no-op)."""
    if not timed and not tracing():
        return _NO_SPAN
    return _Span(name, logger, timed)


def synced(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
    """``fn(*args, **kwargs)``: one blocking host<->device transfer (a
    ``.cpu()``, ``.tolist()`` or ``bool()`` of a device tensor, a host list
    or array copied to the device), under a ``sync`` span."""
    if not tracing():
        return fn(*args, **kwargs)
    with span("sync", timed=False):
        return fn(*args, **kwargs)


def get_timings(reset: bool = False) -> Dict[str, List[float]]:
    with _lock:
        out = {k: list(v) for k, v in _timings.items()}
        if reset:
            _timings.clear()
    return out


def get_trace(reset: bool = False) -> List[Dict[str, Any]]:
    """The span records kept while a profiler recorded, oldest first (each
    appended when its span ends); ``reset`` drops them once read.
    ``get_timings(reset=True)`` leaves them; readers clip them to their own
    window."""
    with _lock:
        out = list(_trace)
        if reset:
            _trace.clear()
    return out


# ---------------------------------------------------------------------------
# Console UX helpers (reference utils/logger.py:172-351, sans rich)
# ---------------------------------------------------------------------------

def print_banner(title: str, subtitle: str = "", width: int = 72) -> None:
    line = "=" * width
    print(line)
    print(title.center(width))
    if subtitle:
        print(subtitle.center(width))
    print(line)


def print_table(headers: Sequence[str], rows: Sequence[Sequence[Any]]) -> None:
    cols = [max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows else len(str(h))
            for i, h in enumerate(headers)]
    fmt = "  ".join(f"{{:<{w}}}" for w in cols)
    print(fmt.format(*headers))
    print(fmt.format(*("-" * w for w in cols)))
    for row in rows:
        print(fmt.format(*(str(c) for c in row)))


def print_health_check_table(checks: Dict[str, Tuple[bool, str]]) -> None:
    rows = [(name, "OK" if ok else "FAIL", detail) for name, (ok, detail) in checks.items()]
    print_table(["Check", "Status", "Detail"], rows)


def print_inspection_result(verdict: str, request_id: str, elapsed: float,
                            defect_count: int, agreement: float) -> None:
    print_banner("INSPECTION RESULT")
    print_table(
        ["Field", "Value"],
        [
            ("Request", request_id),
            ("Verdict", verdict),
            ("Defects", defect_count),
            ("Agreement", f"{agreement:.2%}"),
            ("Elapsed", f"{elapsed:.2f}s"),
        ],
    )


__all__ = [
    "setup_logger",
    "set_request_id",
    "get_request_id",
    "SensitiveDataFilter",
    "ContextFilter",
    "span",
    "synced",
    "get_timings",
    "get_trace",
    "print_banner",
    "print_table",
    "print_health_check_table",
    "print_inspection_result",
]
