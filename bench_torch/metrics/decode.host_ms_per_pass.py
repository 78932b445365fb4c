"""decode.host_ms_per_pass: the host's own time a weight pass, in ms: the
program's ``decode.pass`` records (each spans the host issuing one pass of
the decode loop and booking its result) less the ``sync`` records inside
them (the host waiting on a blocking transfer), over the passes of the
decode regions (see ``harness/passes.py``)."""

from bench_torch.harness.passes import decode_records


def read(run):
    found = decode_records(run)
    if found is None:
        return None
    ns = (sum(r["end_ns"] - r["start_ns"] for r in found.passes)
          - sum(r["end_ns"] - r["start_ns"] for r in found.pass_syncs))
    return ns / 1e6 / len(found.passes)
