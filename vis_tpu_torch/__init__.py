"""vis_tpu_torch: the PyTorch/CUDA port of vis_tpu for NVIDIA Hopper.

It stands beside ``vis_tpu`` (the JAX reference) and imports nothing of it:
the device-free modules it needs (config, logging, prompts, schemas, agents,
safety gates, orchestration, database, reporting, the tokenizer and the
constrained-decoding table compilers) are its own copies.  Every Pallas
kernel on its path is a hand-written CUDA kernel under ``csrc/``.  The
entry point is ``vis_tpu_torch.orchestration.graph.run_inspection``;
provider ``"cuda"`` serves a role from the port's engines on the torch
device ``TORCH_DEVICE`` (``vis_tpu_torch.agents.install`` sets the device
and the weight seed explicitly).
"""

__version__ = "0.1.0"
