"""The provider seam: route agent provider ``"cuda"`` to the port's engine.

``vis_tpu.agents`` resolves a role's backend through ``_resolve_backend``,
looked up when an agent is first built, and knows the providers ``"mock"``
and ``"tpu"``.  ``install(device)`` wraps that function so that provider
``"cuda"`` gets the port's ``EngineBackend`` on ``device``; every other
provider, and ``USE_MOCK_RESPONSES``, still goes to the original.
"""

from __future__ import annotations

import torch

import vis_tpu.agents as _agents
from vis_tpu.utils.config import config

PROVIDER = "cuda"


def install(device, seed: int = 0) -> None:
    """Serve provider ``"cuda"`` from the port's engines on ``device``
    (weights seeded with ``seed``).  Drops the agents cached so far."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"install({device}): torch sees no CUDA device")
    original = getattr(_agents._resolve_backend, "wrapped", _agents._resolve_backend)

    def resolve(role: str, provider: str, model_name: str):
        if provider == PROVIDER and not config.use_mock_responses:
            from vis_tpu_torch.serving.engine import get_engine_backend

            return get_engine_backend(role, model_name, device, seed)
        return original(role, provider, model_name)

    resolve.wrapped = original
    _agents._resolve_backend = resolve
    _agents.reset_agent_cache()


__all__ = ["PROVIDER", "install"]
