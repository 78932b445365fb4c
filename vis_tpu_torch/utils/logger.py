"""Structured logging with request-ID correlation and secret masking.

Covers the reference's logging surface (reference: utils/logger.py:27-351):
colored console output, JSON file logs, request-ID context propagation,
sensitive-value masking, and console banners/tables.  colorlog/rich are
replaced by plain ANSI escape codes so the module has zero dependencies;
per-stage device timings are added for the GPU execution path.
"""

from __future__ import annotations

import json
import logging
import re
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

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

_timings: Dict[str, List[float]] = {}


@contextmanager
def span(name: str, logger: Optional[logging.Logger] = None) -> Iterator[None]:
    """Wall-clock span; accumulates per-stage timings retrievable via get_timings()."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        with _lock:
            _timings.setdefault(name, []).append(elapsed)
        if logger is not None:
            logger.debug(f"[span] {name}: {elapsed*1000:.1f} ms")


def get_timings(reset: bool = False) -> Dict[str, List[float]]:
    with _lock:
        out = {k: list(v) for k, v in _timings.items()}
        if reset:
            _timings.clear()
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
    "get_timings",
    "print_banner",
    "print_table",
    "print_health_check_table",
    "print_inspection_result",
]
