"""Helpers the drivers share: seeded draws, the schema-answer test, and
the choice of the served requests the check compares."""

from __future__ import annotations

import json
import random
from typing import Any, Dict, List, Optional, Sequence

from bench_torch.reference.grammar import schema_keys


def rng_for(seed: int, *salt) -> random.Random:
    return random.Random(f"{seed}:" + ":".join(str(s) for s in salt))


def balanced(seed: int, items: Sequence[Any], n: int, salt: str) -> List[Any]:
    """``n`` draws from ``items`` in blocks, each block a seeded order of
    all of them: every seed gets the same mix, in another order."""
    rng = rng_for(seed, salt)
    out: List[Any] = []
    while len(out) < n:
        block = list(items)
        rng.shuffle(block)
        out.extend(block)
    return out[:n]


def byte_ids(text: str) -> List[int]:
    """The byte-level tokenizer's ids of ``text``."""
    return list(text.encode("utf-8"))


def schema_ok(text: Optional[str], schema: str) -> bool:
    """An answer parses as JSON with exactly the schema's keys, in order."""
    if text is None:
        return False
    try:
        doc = json.loads(text)
    except ValueError:
        return False
    return isinstance(doc, dict) and list(doc) == schema_keys(schema)


def pick_for_check(done: List[Dict[str, Any]], seed: int, count: int) -> List[Dict[str, Any]]:
    """The finished greedy requests the check reads: the one with the most
    served tokens, and ``count - 1`` more drawn from the seed."""
    greedy = [d for d in done if d.get("greedy") and d["tokens"]]
    if not greedy:
        return []
    longest = max(greedy, key=lambda d: d["tokens"])
    rest = [d for d in greedy if d is not longest]
    rng_for(seed, "check").shuffle(rest)
    return [longest] + rest[:max(0, count - 1)]


__all__ = ["balanced", "byte_ids", "pick_for_check", "rng_for", "schema_ok"]
