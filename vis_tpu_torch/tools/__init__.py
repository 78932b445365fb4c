"""The probe tools on the card: the port of ``tools/probe_scan_slice.py``,
``tools/probe_unpack.py``, ``tools/probe_stacked_fused.py`` and
``tools/probe_unpack2.py``.

Each runs the full 7B MLP stack (28 layers of int4 gate_up [37888, 3584]
and down [3584, 18944], 2.85 GB of packed weight, or its int8 twin) through
one kernel variant and prints ms per pass and GB/s of weight, as a replayed CUDA graph
of one pass (the counterpart of the JAX probes' one jitted loop) and eagerly
(the gap is the host's share):

    python -m vis_tpu_torch.tools.probe_scan_slice [ABCD]
    python -m vis_tpu_torch.tools.probe_unpack [ABCDE]
    python -m vis_tpu_torch.tools.probe_stacked_fused [DEFH]
    python -m vis_tpu_torch.tools.probe_unpack2 [SFGHI]

They run on ``cuda:0`` unless ``--device`` says otherwise; ``--device cpu``
and the shape keywords of each ``run`` are for the tests.
"""
