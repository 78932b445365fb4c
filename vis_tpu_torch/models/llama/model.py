"""Llama text model: random init and the carry-over of JAX-side parameters.

Counterpart of ``vis_tpu/models/llama/model.py``; the forward pass is the
shared decoder (``models/common/decoder.py``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from vis_tpu_torch.models.common.decoder import (
    DecoderConfig,
    Params,
    init_decoder_params,
    params_from_numpy,
)


def init_params(config: DecoderConfig, generator: torch.Generator, device="cpu") -> Params:
    return init_decoder_params(config, generator, device)


def from_jax_numpy(flat: Mapping[str, np.ndarray], config: DecoderConfig,
                   device="cpu") -> Params:
    """The port's tree from a JAX decoder tree flattened to "/"-joined key
    paths -> numpy; int4 ``QuantizedWeight4`` and int8 ``QuantizedWeight``
    leaves come as ".../q" and ".../scale" (see ``params_from_numpy``)."""
    return params_from_numpy(flat, config.dtype, device)


__all__ = ["from_jax_numpy", "init_params"]
