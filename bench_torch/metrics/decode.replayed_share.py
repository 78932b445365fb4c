"""decode.replayed_share: the share of the decode regions' weight passes
(see ``harness/passes.py``) that replayed a captured CUDA graph, in %: the
program's ``decode.replay`` records whose parent is one of those
``decode.pass`` records, over those passes, 0 where none replayed.  A
program with no replayed window pass (no ``WindowPass`` in its decoder)
gives None, as does a run with no pass recorded."""

from bench_torch.harness.passes import decode_records


def read(run):
    found = decode_records(run)
    if found is None:
        return None
    from vis_tpu_torch.models.common import decoder
    from vis_tpu_torch.utils.logger import get_trace

    if not hasattr(decoder, "WindowPass"):
        return None
    pass_ids = {r["id"] for r in found.passes}
    replays = sum(1 for r in get_trace()
                  if r["name"] == "decode.replay" and r["parent"] in pass_ids)
    return 100.0 * replays / len(found.passes)
