"""Device profiling: torch.profiler traces per pipeline phase.

The replacement for the reference's LangSmith tracing (SURVEY.md §5.1;
reference utils/config.py:321-326 enabled LangChain auto-instrumentation),
as ``vis_tpu.utils.profiling`` is for the JAX package.  Setting PROFILE_DIR
makes every ``device_trace("phase")`` block write a Chrome trace of host and
CUDA activity, correlated with the request-ID-tagged structured logs from
vis_tpu_torch.utils.logger.
"""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path
from typing import Iterator

from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.logger import get_request_id, get_trace, setup_logger, span

logger = setup_logger(__name__, level="INFO", component="PROFILER")


def profiling_enabled() -> bool:
    return bool(config.profile_dir)


@contextmanager
def device_trace(phase: str) -> Iterator[None]:
    """torch.profiler trace when PROFILE_DIR is set; no-op otherwise.

    The disabled path is a pure pass-through (no extra span): the pipeline
    runner wraps every node in this, and phantom spans would pollute the
    span-tree attribution.  The profiling span is namespaced
    "profile.<phase>" for the same reason."""
    if not profiling_enabled():
        yield
        return

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    trace_dir = Path(config.profile_dir) / (get_request_id() or "session")
    trace_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with span(f"profile.{phase}", logger):
        with profile(activities=activities) as prof:
            with record_function(phase):
                yield
    path = trace_dir / f"{phase}.trace.json"
    prof.export_chrome_trace(str(path))
    get_trace(reset=True)  # the file holds the spans' ranges; nothing else reads them
    logger.info(f"Profiler trace for '{phase}' written to {path}")


__all__ = ["device_trace", "profiling_enabled"]
