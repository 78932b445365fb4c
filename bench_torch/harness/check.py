"""The comparison that decides ``correct``: served tokens against the
plain reference.

A check item is one served sequence: the inputs its model family reads
(a photo for a VLM, resized by the reference's own copy of the served-size
rule and bicubic resample), then pieces of token ids in order, each either
context (a prompt) or served (an answer the program decoded greedily).
The reference, the model family's (``families/<model_type>.py``), remakes
the weights from the item's seed, runs one float32 forward over the whole
sequence and reads, at every served position, the gap by which the served
token's logit lies below the reference's best among the tokens that were
legal there: every id for a free-form answer, the schema's legal bytes
under the budget rule for a constrained one (``reference/grammar.py``).
Positions the schema forces carry no choice and are skipped.  A served
token the schema does not allow reads as an infinite gap.

With ``control=True`` the reference is also run with every product's
operands in float8 (e4m3), the precision below the configuration's bf16,
and at each position the token that the float8 model puts first is read
the same way: the control, which the limit must refuse (``run.py
--control`` judges ``correct`` by its readings).
"""

from __future__ import annotations

import math
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bench_torch.families import family_of
from bench_torch.harness.weights import make_weights
from bench_torch.reference import grammar
from bench_torch.reference.primitives import EXACT, FP8, exact_matmuls

LEGAL_WIDTH = 262  # byte ids and the tokenizer's specials


def prompt_cut(n: int, max_tokens: int, serving: Dict[str, str], paged: bool) -> int:
    """The configuration's prompt room: a prompt longer than its prefill
    bucket keeps its first bucket // 2 and last bucket - bucket // 2
    tokens.  The bucket is the smallest of ``PREFILL_BUCKETS`` that holds
    it, at most the KV cache less the budget and 32 tokens, and for a
    paged request at most a slot's pages less the budget and one
    scheduler chunk."""
    cap = int(serving["KV_CACHE_MAX_TOKENS"])
    buckets = sorted(int(b) for b in serving.get("PREFILL_BUCKETS", "512,1024,2048,4096,8192")
                     .split(","))
    bucket = next((b for b in buckets if b >= n), -(-n // 128) * 128)
    bucket = min(bucket, cap - max_tokens - 32)
    if paged:
        page = int(serving["KV_PAGE_SIZE"])
        pages = min(int(serving["KV_POOL_TOKENS"]) // page, cap // page)
        room = pages * page - max_tokens - int(serving["SCHEDULER_DECODE_CHUNK"])
        if 2 <= room < bucket:
            bucket = room
    return bucket


def cut_ids(ids: List[int], bucket: int) -> List[int]:
    if len(ids) <= bucket:
        return ids
    head = bucket // 2
    return ids[:head] + ids[len(ids) - (bucket - head):]


def min_budget(schema: str) -> int:
    dfa = grammar.schema_dfa(schema)
    return int(dfa.close_cost[dfa.start]) + 1


def _legal_masks(piece: Dict[str, Any], eos: int):
    """[n, LEGAL_WIDTH] bool legal ids and [n] forced flags for a served
    piece (None masks: free-form), plus the count of illegal tokens."""
    ids = piece["ids"]
    replay = grammar.replay_for(piece.get("schema"), eos, piece.get("max_tokens", 0),
                                piece.get("floor", 0))
    if replay is None:
        return None, np.zeros(len(ids), bool), 0
    mask = np.zeros((len(ids), LEGAL_WIDTH), bool)
    forced = np.zeros(len(ids), bool)
    illegal = 0
    for j, tok in enumerate(ids):
        allowed, forced[j] = replay.step_allowed()
        mask[j, allowed] = True
        if not (tok < LEGAL_WIDTH and mask[j, tok]):
            illegal += 1
            break
        replay.advance(tok)
    return mask, forced, illegal


def _gaps(ref: torch.Tensor, tokens: torch.Tensor, mask: Optional[torch.Tensor],
          picks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per position: the reference's best legal logit minus its logit of
    the served token (or of ``picks``)."""
    if mask is not None:
        legal = torch.full_like(ref, float("-inf"))
        legal[:, :LEGAL_WIDTH] = torch.where(mask, ref[:, :LEGAL_WIDTH], float("-inf"))
        ref_legal = legal
    else:
        ref_legal = ref
    best = ref_legal.max(dim=-1).values
    chosen = tokens if picks is None else picks
    return best - ref.gather(1, chosen[:, None])[:, 0]


def _control_picks(ctl: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return ctl.argmax(dim=-1)
    masked = torch.full_like(ctl, float("-inf"))
    masked[:, :LEGAL_WIDTH] = torch.where(mask, ctl[:, :LEGAL_WIDTH], float("-inf"))
    return masked.argmax(dim=-1)


def compare(model: Dict[str, Any], items: List[Dict[str, Any]], device,
            control: bool = False) -> Dict[str, Any]:
    """Readings over ``items``: the widest gap, the served positions
    compared, the illegal tokens, and with ``control`` the control's
    widest gap."""
    eos = model["eos_token_id"]
    compared, illegal = 0, 0
    gaps_all, ctl_all = [], []
    by_seed: Dict[int, List[Dict[str, Any]]] = {}
    for item in items:
        by_seed.setdefault(int(item["seed"]), []).append(item)
    family = family_of(model)
    with exact_matmuls(), torch.no_grad():
        for seed, group in by_seed.items():
            weights = make_weights(model, seed, device)
            for item in group:
                seq = family.sequence(model, item, weights, device)
                rows = torch.cat([torch.arange(start - 1, start - 1 + len(piece["ids"]),
                                               device=device) for piece, start in seq.served])
                outs = [family.logits(model, weights, seq, rows, prec)
                        for prec in [EXACT] + ([FP8] if control else [])]
                off = 0
                for piece, _ in seq.served:
                    n = len(piece["ids"])
                    mask_np, forced, bad = _legal_masks(piece, eos)
                    illegal += bad
                    ref = outs[0][off:off + n]
                    tokens = torch.tensor(piece["ids"], device=device)
                    mask = None if mask_np is None else torch.from_numpy(mask_np).to(device)
                    keep = torch.from_numpy(~forced).to(device)
                    if bad == 0:
                        gaps = _gaps(ref, tokens, mask)[keep].cpu()
                        gaps_all.append(gaps)
                        if gaps.numel():
                            print(f"check item {item.get('label', '')} served {n} compared "
                                  f"{gaps.numel()} widest {float(gaps.max()):.4f} flips "
                                  f"{float((gaps > 0).float().mean()):.4f}", file=sys.stderr)
                        compared += int(keep.sum())
                        if control:
                            picks = _control_picks(outs[1][off:off + n], mask)
                            ctl_all.append(_gaps(ref, tokens, mask, picks)[keep].cpu())
                    off += n
            del weights
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    out = {"compared": compared, "illegal": illegal}
    out.update(_summary(gaps_all, "", illegal))
    if control:
        out.update(_summary(ctl_all, "control_", 0))
    return out


def _summary(parts, prefix: str, illegal: int) -> Dict[str, float]:
    """The widest gap over every compared position (infinite where a served
    token was illegal or nothing was compared)."""
    gaps = torch.cat(parts) if parts else torch.zeros(0)
    if illegal or not gaps.numel():
        return {f"{prefix}widest_gap": math.inf}
    return {f"{prefix}widest_gap": float(gaps.max())}


__all__ = ["compare", "cut_ids", "min_budget", "prompt_cut"]
