"""Schema-level constrained decoding: the output is forced to be one exact
JSON document shape, not merely valid JSON.

The generic DFA in vis_tpu_torch.serving.constrained guarantees *well-formed*
JSON; the agents' contracts are stronger — a fixed object skeleton with
ordered keys and typed values (reference utils/prompts.py JSON schema
block; reference src/agents/vlm_inspector.py:269-433 spends ~160 lines
repairing outputs that miss it).  This module compiles a *schema* into the
same byte-level-DFA + per-tokenizer table format, so the whole fused
constrained-decode path (models/common/decoder.py constrained_pick and the
scan loops) is reused unchanged — only the tables differ.

Schema atoms:

- ``SObject([(key, spec), ...])`` — all keys required, fixed order, compact
  separators (the skeleton bytes are *forced*: the model has no choice).
- ``SString(min_len=n)`` — JSON string with escapes; at least n characters
  (floor implemented as a counting chain of DFA states).
- ``SEnum(values)`` — one of a fixed set of quoted strings (byte trie).
- ``SNumber()`` — JSON number grammar (self-delimiting: terminator bytes
  are resolved via epsilon edges into the continuation state).
- ``SArray(item, min_items=0|1)`` — homogeneous array, unbounded above
  (the budget-feasibility mask funnels closure near the token budget).

Registered schemas mirror the agents' prompt contracts:
``inspection`` (inspector + auditor, reference utils/prompts.py:18-101)
and ``decision_support`` (reference src/agents/explainer.py:264-338).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vis_tpu_torch.serving.constrained import (
    ConstraintTables,
    _close_costs_table,
    _compile_tables,
    _tokenizer_fingerprint,
)

_ESCAPABLE = frozenset(b'"\\/bfnrt')
_HEX = frozenset(b"0123456789abcdefABCDEF")
_DIGITS = frozenset(b"0123456789")
_STR_RAW = frozenset(b for b in range(0x20, 0x100) if b not in (0x22, 0x5C))


# ---------------------------------------------------------------------------
# Schema spec atoms
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SString:
    min_len: int = 0


@dataclass(frozen=True)
class SNumber:
    pass


@dataclass(frozen=True)
class SEnum:
    values: Tuple[str, ...]


@dataclass(frozen=True)
class SObject:
    props: Tuple[Tuple[str, object], ...]


@dataclass(frozen=True)
class SArray:
    item: object
    min_items: int = 0


# ---------------------------------------------------------------------------
# DFA construction
# ---------------------------------------------------------------------------

class SchemaDfa:
    """Byte-level DFA for one schema; exposes the same surface the table
    compiler consumes (trans_table [S,256], start_id, accept_id,
    close_cost, n_states)."""

    def __init__(self, spec):
        self.trans: List[np.ndarray] = []
        self._eps: Dict[int, int] = {}  # acceptable-end state -> continuation
        start = self._new()
        accept = self._new()
        self._build(spec, start, accept)
        self._resolve_eps()
        self.n_states = len(self.trans)
        self.trans_table = np.stack(self.trans)
        self.start_id = start
        self.accept_id = accept
        self.close_cost = _close_costs_table(self.trans_table, accept)
        assert self.close_cost[start] < 2**29, "schema cannot complete"

    # -- graph helpers ----------------------------------------------------

    def _new(self) -> int:
        self.trans.append(np.full(256, -1, np.int32))
        return len(self.trans) - 1

    def _edge(self, s: int, byte: int, t: int) -> None:
        cur = int(self.trans[s][byte])
        if cur not in (-1, t):
            raise ValueError(
                f"nondeterministic schema: state {s} byte {byte!r} -> "
                f"{cur} and {t}"
            )
        self.trans[s][byte] = t

    def _lit(self, entry: int, data: bytes, exit_: int) -> None:
        """Chain of forced literal bytes from entry to exit_."""
        cur = entry
        for i, b in enumerate(data):
            nxt = exit_ if i == len(data) - 1 else self._new()
            self._edge(cur, b, nxt)
            cur = nxt

    # -- value builders ---------------------------------------------------

    def _build(self, spec, entry: int, exit_: int) -> None:
        if isinstance(spec, SObject):
            self._obj(spec, entry, exit_)
        elif isinstance(spec, SString):
            self._string(spec, entry, exit_)
        elif isinstance(spec, SEnum):
            self._enum(spec, entry, exit_)
        elif isinstance(spec, SNumber):
            self._number(entry, exit_)
        elif isinstance(spec, SArray):
            self._array(spec, entry, exit_)
        else:
            raise TypeError(f"unknown schema atom {spec!r}")

    def _obj(self, spec: SObject, entry: int, exit_: int) -> None:
        if not spec.props:
            self._lit(entry, b"{}", exit_)
            return
        cur = entry
        for i, (key, sub) in enumerate(spec.props):
            prefix = ("{" if i == 0 else ",") + json.dumps(key) + ":"
            mid = self._new()
            self._lit(cur, prefix.encode(), mid)
            cur = self._new()
            self._build(sub, mid, cur)
        self._lit(cur, b"}", exit_)

    def _string(self, spec: SString, entry: int, exit_: int) -> None:
        # counting chain c_0..c_min; raw chars advance the count up to the
        # floor, then self-loop; '"' closes only at/after the floor.
        n = max(0, spec.min_len)
        chain = [self._new() for _ in range(n + 1)]
        self._edge(entry, 0x22, chain[0])
        for i, c in enumerate(chain):
            nxt = chain[min(i + 1, n)]
            for b in _STR_RAW:
                self._edge(c, b, nxt)
            esc = self._new()
            self._edge(c, 0x5C, esc)
            for b in _ESCAPABLE:
                self._edge(esc, b, nxt)
            u = esc
            for k in range(4):
                u_next = nxt if k == 3 else self._new()
                if k == 0:
                    hex_entry = self._new()
                    self._edge(esc, 0x75, hex_entry)  # 'u'
                    u = hex_entry
                for b in _HEX:
                    self._edge(u, b, u_next)
                u = u_next
        self._edge(chain[n], 0x22, exit_)

    def _enum(self, spec: SEnum, entry: int, exit_: int) -> None:
        # '"' + byte trie over the values + '"'
        root = self._new()
        self._edge(entry, 0x22, root)
        nodes: Dict[bytes, int] = {b"": root}
        ends = set()
        for value in spec.values:
            data = value.encode()
            for i in range(1, len(data) + 1):
                prefix = data[:i]
                if prefix not in nodes:
                    nodes[prefix] = self._new()
                    self._edge(nodes[data[: i - 1]], data[i - 1], nodes[prefix])
            ends.add(data)
        for data in ends:
            self._edge(nodes[data], 0x22, exit_)

    def _number(self, entry: int, exit_: int) -> None:
        # JSON number grammar; acceptable-end states epsilon-exit so the
        # continuation's delimiter byte terminates the number.
        zero, integer = self._new(), self._new()
        frac_start, frac = self._new(), self._new()
        exp_start, exp_sign, exp = self._new(), self._new(), self._new()
        neg = self._new()
        self._edge(entry, ord("-"), neg)
        for s in (entry, neg):
            self._edge(s, ord("0"), zero)
            for b in b"123456789":
                self._edge(s, b, integer)
        for b in _DIGITS:
            self._edge(integer, b, integer)
            self._edge(frac_start, b, frac)
            self._edge(frac, b, frac)
            self._edge(exp_start, b, exp)
            self._edge(exp_sign, b, exp)
            self._edge(exp, b, exp)
        for s in (zero, integer):
            self._edge(s, ord("."), frac_start)
        for s in (zero, integer, frac):
            self._edge(s, ord("e"), exp_start)
            self._edge(s, ord("E"), exp_start)
        for b in b"+-":
            self._edge(exp_start, b, exp_sign)
        for s in (zero, integer, frac, exp):
            self._eps[s] = exit_

    def _array(self, spec: SArray, entry: int, exit_: int) -> None:
        if spec.min_items not in (0, 1):
            raise ValueError("SArray.min_items must be 0 or 1")
        first = self._new()
        self._edge(entry, 0x5B, first)  # [
        if spec.min_items == 0:
            self._edge(first, 0x5D, exit_)  # ]
        after = self._new()
        self._build(spec.item, first, after)
        self._edge(after, 0x5D, exit_)
        rest = self._new()
        self._edge(after, 0x2C, rest)  # ,
        self._build(spec.item, rest, after)  # loop

    # -- epsilon elimination ---------------------------------------------

    def _resolve_eps(self) -> None:
        """Merge each epsilon target's byte transitions into its source for
        bytes the source does not claim (number delimiters).  Fixpoint to
        tolerate chains (number array item -> after-item -> ...)."""
        for _ in range(len(self._eps) + 1):
            changed = False
            for s, t in self._eps.items():
                src, tgt = self.trans[s], self.trans[t]
                take = (src == -1) & (tgt != -1)
                if take.any():
                    src[take] = tgt[take]
                    changed = True
            if not changed:
                return
        raise ValueError("epsilon resolution did not converge")


# ---------------------------------------------------------------------------
# Registered schemas (the agents' output contracts)
# ---------------------------------------------------------------------------

_CONF = SEnum(("high", "medium", "low"))

INSPECTION_SCHEMA = SObject((
    ("object_identified", SString(min_len=3)),
    ("overall_condition", SEnum(("damaged", "good", "uncertain"))),
    ("defects", SArray(SObject((
        ("type", SString(min_len=3)),
        ("location", SString(min_len=3)),
        ("bbox", SObject((
            ("x", SNumber()),
            ("y", SNumber()),
            ("width", SNumber()),
            ("height", SNumber()),
        ))),
        ("safety_impact", SEnum(("CRITICAL", "MODERATE", "COSMETIC"))),
        ("reasoning", SString(min_len=10)),
        ("confidence", _CONF),
        ("recommended_action", SString(min_len=3)),
    )), min_items=0)),
    ("overall_confidence", _CONF),
    ("analysis_reasoning", SString(min_len=20)),
))

DECISION_SUPPORT_SCHEMA = SObject((
    ("repair_cost_min", SNumber()),
    ("repair_cost_max", SNumber()),
    ("replace_cost_estimate", SNumber()),
    ("repair_time_estimate", SString(min_len=2)),
    ("replace_lead_time", SString(min_len=2)),
    ("recommendation", SEnum(("REPAIR", "REPLACE"))),
    ("reasoning", SString(min_len=5)),
))

SCHEMAS: Dict[str, SObject] = {
    "inspection": INSPECTION_SCHEMA,
    "decision_support": DECISION_SUPPORT_SCHEMA,
}


_dfa_lock = threading.Lock()
_dfa_cache: Dict[str, SchemaDfa] = {}
_tables_lock = threading.Lock()
_tables_cache: Dict[Tuple, Optional[ConstraintTables]] = {}


def get_schema_dfa(name: str) -> SchemaDfa:
    with _dfa_lock:
        if name not in _dfa_cache:
            _dfa_cache[name] = SchemaDfa(SCHEMAS[name])
        return _dfa_cache[name]


def schema_constraint_tables(
    tokenizer, vocab_size: int, name: str
) -> Optional[ConstraintTables]:
    """Per-tokenizer tables for a registered schema; large vocabularies
    get column-class-compressed tables (class_of set); None only when the
    tokenizer fails the byte-composability probe (callers fall back to
    generic-JSON or unconstrained decode).

    ``require_open=False``: unlike generic JSON, a schema has forced-close
    states (e.g. the final '}') with no open continuation — the decoder's
    floor mask falls through to the forced move there."""
    key = (
        "schema",
        _tokenizer_fingerprint(tokenizer, vocab_size),
        getattr(tokenizer, "vocab_size", vocab_size),
        vocab_size,
        name,
    )
    from vis_tpu_torch.serving.constrained import compile_cached

    return compile_cached(
        _tables_cache, _tables_lock, key,
        lambda: _compile_tables(
            get_schema_dfa(name), tokenizer, vocab_size, require_open=False
        ),
    )
