"""vis_tpu_torch: the PyTorch/CUDA port of vis_tpu for NVIDIA Hopper.

It runs beside ``vis_tpu`` (the JAX reference, which it never imports
``jax`` through) and reuses the reference's device-free modules: schemas,
agents, orchestration, safety, database, reporting, the tokenizers and the
constrained-decoding table compilers.  Every Pallas kernel on its path is a
hand-written CUDA kernel under ``csrc/``; ``agents.install(device)`` routes
the provider ``"cuda"`` to the port's engine.
"""

__version__ = "0.1.0"
