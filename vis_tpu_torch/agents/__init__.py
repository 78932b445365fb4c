"""Agent factories and aggregate health checks
(reference: src/agents/__init__.py:11-68).

Unlike the reference, which builds a fresh HTTP client per call, these
factories cache agents per backend because an engine backend owns
device-resident model weights — re-instantiating would reload checkpoints.
Backend selection: `use_mock_responses` / provider "mock" -> deterministic
MockVLMBackend; provider "cuda" -> the port's engine
(vis_tpu_torch.serving.engine) on the torch device TORCH_DEVICE, weights
seeded with 0; ``install(device, seed)`` sets both explicitly.  Any other
provider raises.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from vis_tpu_torch.agents.auditor import AuditorAgent, VLMAuditorAgent
from vis_tpu_torch.agents.base import InferenceBackend
from vis_tpu_torch.agents.explainer import ExplainerAgent
from vis_tpu_torch.agents.inspector import InspectorAgent, VLMInspectorAgent
from vis_tpu_torch.agents.mock import MockVLMBackend
from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__, level="INFO", component="AGENTS")

PROVIDER = "cuda"

_lock = threading.Lock()
_cache: Dict[str, object] = {}
# install() sets these; None = config.torch_device, seed 0.
_device: Optional[str] = None
_seed = 0


def _engine_device():
    """The torch device of the port's engines; raises when it names a CUDA
    device and torch sees none (no silent move to the CPU)."""
    import torch

    device = torch.device(_device or config.torch_device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"engine device {device}: torch sees no CUDA device")
    return device


def install(device, seed: int = 0) -> None:
    """Serve provider ``"cuda"`` from engines on ``device`` with weights
    seeded by ``seed``.  Drops the agents cached so far."""
    import torch

    global _device, _seed
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"install({device}): torch sees no CUDA device")
    _device, _seed = str(device), seed
    reset_agent_cache()


def _resolve_backend(role: str, provider: str, model_name: str) -> InferenceBackend:
    """Pick the inference backend for an agent role."""
    if config.use_mock_responses or provider == "mock":
        return MockVLMBackend()
    if provider == PROVIDER:
        from vis_tpu_torch.serving.engine import get_engine_backend

        return get_engine_backend(role, model_name, _engine_device(), _seed)
    raise ValueError(f"Unknown provider {provider!r} for {role} "
                     f"(the port serves {PROVIDER!r} and 'mock')")


def get_inspector(backend: Optional[InferenceBackend] = None) -> VLMInspectorAgent:
    with _lock:
        key = f"inspector:{id(backend) if backend else 'default'}"
        if key not in _cache:
            resolved = backend or _resolve_backend(
                "inspector", config.vlm_inspector_provider, config.vlm_inspector_model
            )
            _cache[key] = VLMInspectorAgent(resolved)
        return _cache[key]  # type: ignore[return-value]


def get_auditor(backend: Optional[InferenceBackend] = None) -> VLMAuditorAgent:
    with _lock:
        key = f"auditor:{id(backend) if backend else 'default'}"
        if key not in _cache:
            resolved = backend or _resolve_backend(
                "auditor", config.vlm_auditor_provider, config.vlm_auditor_model
            )
            _cache[key] = VLMAuditorAgent(resolved)
        return _cache[key]  # type: ignore[return-value]


def get_explainer(backend: Optional[InferenceBackend] = None) -> ExplainerAgent:
    with _lock:
        key = f"explainer:{id(backend) if backend else 'default'}"
        if key not in _cache:
            resolved = backend or _resolve_backend(
                "explainer", config.explainer_provider, config.explainer_model
            )
            _cache[key] = ExplainerAgent(resolved)
        return _cache[key]  # type: ignore[return-value]


def reset_agent_cache() -> None:
    """Drop cached agents (used by tests and config reloads)."""
    with _lock:
        _cache.clear()


def health_check_agents() -> Dict[str, bool]:
    """Ping all three agents' backends (reference src/agents/__init__.py:26)."""
    results = {}
    for name, factory in (
        ("inspector", get_inspector),
        ("auditor", get_auditor),
        ("explainer", get_explainer),
    ):
        try:
            results[name] = factory().health_check()
        except Exception as exc:
            logger.error(f"{name} health check errored: {exc}")
            results[name] = False
    return results


__all__ = [
    "PROVIDER",
    "install",
    "get_inspector",
    "get_auditor",
    "get_explainer",
    "health_check_agents",
    "reset_agent_cache",
    "VLMInspectorAgent",
    "InspectorAgent",
    "VLMAuditorAgent",
    "AuditorAgent",
    "ExplainerAgent",
    "MockVLMBackend",
]
