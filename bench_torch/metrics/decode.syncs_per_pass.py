"""decode.syncs_per_pass: the program's ``sync`` records (one per blocking
host<->device transfer) inside its decode regions (see
``harness/passes.py``), over the ``decode.pass`` records (weight passes)
inside them."""

from bench_torch.harness.passes import decode_records


def read(run):
    found = decode_records(run)
    if found is None:
        return None
    return len(found.syncs) / len(found.passes)
