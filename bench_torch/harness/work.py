"""The yardstick's arithmetic: operations and bytes a run's work needs,
from a configuration file's ``model`` section and what the run served.

Counted from the shapes, never from the kernels that did the work, so the
numbers stay the same whatever kernel a later change puts on the path.
Operations are multiply-adds times two.  Bytes are what one weight pass
reads once: every projection's packed weights and scales, the norms, the
vocab head; the KV cache is read at its valid length.  The counts are the
model family's (``families/<model_type>.py``: ``input_flops``,
``prefill_flops``, ``decode_flops``, ``decode_bytes``); the peaks they
are held against are here.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity), at its full 700 W power limit.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

__all__ = ["PEAK_BF16_FLOPS", "PEAK_HBM_BYTES"]
