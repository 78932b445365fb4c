"""The agents' answer schemas as byte-level automata, for the check.

A copy of the schema automaton the served answers are held to (the JSON
skeletons of the inspection and decision-support answers: fixed keys in
order, typed values), so that the reference can say which tokens a
constrained request was free to choose at each position without reading
any table the program built.  Tokens are bytes (the byte-level tokenizer):
id b < 256 is byte b, ``eos`` closes a finished document, and no other id
is ever legal under a grammar.

``allowed(...)`` replays the budget rule of constrained decode: a token is
legal if the automaton takes it and the document can still close within
the tokens left, and while the request's floor holds, only tokens that
keep the document open are legal where such exist.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

INF = 2 ** 30
_ESCAPABLE = frozenset(b'"\\/bfnrt')
_HEX = frozenset(b"0123456789abcdefABCDEF")
_DIGITS = frozenset(b"0123456789")
_STR_RAW = frozenset(b for b in range(0x20, 0x100) if b not in (0x22, 0x5C))


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


_CONF = SEnum(("high", "medium", "low"))

SCHEMAS: Dict[str, SObject] = {
    "inspection": SObject((
        ("object_identified", SString(min_len=3)),
        ("overall_condition", SEnum(("damaged", "good", "uncertain"))),
        ("defects", SArray(SObject((
            ("type", SString(min_len=3)),
            ("location", SString(min_len=3)),
            ("bbox", SObject((
                ("x", SNumber()), ("y", SNumber()),
                ("width", SNumber()), ("height", SNumber()),
            ))),
            ("safety_impact", SEnum(("CRITICAL", "MODERATE", "COSMETIC"))),
            ("reasoning", SString(min_len=10)),
            ("confidence", _CONF),
            ("recommended_action", SString(min_len=3)),
        )), min_items=0)),
        ("overall_confidence", _CONF),
        ("analysis_reasoning", SString(min_len=20)),
    )),
    "decision_support": SObject((
        ("repair_cost_min", SNumber()),
        ("repair_cost_max", SNumber()),
        ("replace_cost_estimate", SNumber()),
        ("repair_time_estimate", SString(min_len=2)),
        ("replace_lead_time", SString(min_len=2)),
        ("recommendation", SEnum(("REPAIR", "REPLACE"))),
        ("reasoning", SString(min_len=5)),
    )),
}


def schema_keys(name: str) -> List[str]:
    """The top-level keys of a schema, in order."""
    return [key for key, _ in SCHEMAS[name].props]


class ByteDfa:
    """Deterministic byte automaton of one schema: ``trans`` [S, 256]
    (-1 = rejected), ``start``, ``accept``, ``close_cost`` [S] (fewest
    bytes to a finished document)."""

    def __init__(self, spec):
        self._rows: List[np.ndarray] = []
        self._eps: Dict[int, int] = {}
        self.start = self._new()
        self.accept = self._new()
        self._build(spec, self.start, self.accept)
        self._resolve_eps()
        self.trans = np.stack(self._rows)
        self.close_cost = _close_costs(self.trans, self.accept)
        if self.close_cost[self.start] >= INF:
            raise ValueError("schema cannot complete")

    def _new(self) -> int:
        self._rows.append(np.full(256, -1, np.int64))
        return len(self._rows) - 1

    def _edge(self, s: int, byte: int, t: int) -> None:
        cur = int(self._rows[s][byte])
        if cur not in (-1, t):
            raise ValueError(f"nondeterministic schema at state {s}, byte {byte}")
        self._rows[s][byte] = t

    def _lit(self, entry: int, data: bytes, exit_: int) -> None:
        cur = entry
        for i, b in enumerate(data):
            nxt = exit_ if i == len(data) - 1 else self._new()
            self._edge(cur, b, nxt)
            cur = nxt

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
                    self._edge(esc, 0x75, hex_entry)
                    u = hex_entry
                for b in _HEX:
                    self._edge(u, b, u_next)
                u = u_next
        self._edge(chain[n], 0x22, exit_)

    def _enum(self, spec: SEnum, entry: int, exit_: int) -> None:
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
        first = self._new()
        self._edge(entry, 0x5B, first)
        if spec.min_items == 0:
            self._edge(first, 0x5D, exit_)
        after = self._new()
        self._build(spec.item, first, after)
        self._edge(after, 0x5D, exit_)
        rest = self._new()
        self._edge(after, 0x2C, rest)
        self._build(spec.item, rest, after)

    def _resolve_eps(self) -> None:
        for _ in range(len(self._eps) + 1):
            changed = False
            for s, t in self._eps.items():
                src, tgt = self._rows[s], self._rows[t]
                take = (src == -1) & (tgt != -1)
                if take.any():
                    src[take] = tgt[take]
                    changed = True
            if not changed:
                return
        raise ValueError("epsilon resolution did not converge")


def _close_costs(trans: np.ndarray, accept: int) -> np.ndarray:
    cost = np.full(trans.shape[0], INF, np.int64)
    cost[accept] = 0
    for _ in range(trans.shape[0]):
        nxt = np.where(trans >= 0, cost[np.clip(trans, 0, None)], INF)
        new = np.minimum(cost, 1 + nxt.min(axis=1))
        if np.array_equal(new, cost):
            break
        cost = new
    return np.minimum(cost, INF)


class Replay:
    """A constrained request's grammar state, token by token.

    ``step_allowed()`` gives the ids legal at the next position (a sorted
    array) and whether the position was forced (one id the automaton
    takes, so the model had no choice); ``advance(token)`` moves on."""

    def __init__(self, dfa: ByteDfa, eos_id: int, max_tokens: int, floor: int):
        self.dfa = dfa
        self.eos = eos_id
        self.state = dfa.start
        self.remaining = max_tokens
        self.min_remaining = max_tokens - max(min(max(floor, 0), max_tokens - 32), 0)

    def _takes(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, cost after each) the automaton takes from this state."""
        dfa = self.dfa
        if self.state == dfa.accept:
            return np.array([self.eos]), np.array([0])
        row = dfa.trans[self.state]
        ids = np.nonzero(row >= 0)[0]
        return ids, dfa.close_cost[row[ids]]

    def step_allowed(self) -> Tuple[np.ndarray, bool]:
        ids, cost = self._takes()
        if len(ids) == 1:
            return ids, True
        feasible = cost < self.remaining
        open_ = feasible & (cost > 0)
        if self.remaining > self.min_remaining and open_.any():
            return ids[open_], False
        return ids[feasible], False

    def advance(self, token: int) -> None:
        if self.state != self.dfa.accept:
            nxt = int(self.dfa.trans[self.state][token]) if 0 <= token < 256 else -1
            if nxt < 0:
                raise ValueError(f"token {token} is not legal in state {self.state}")
            self.state = nxt
        self.remaining -= 1


_DFAS: Dict[str, ByteDfa] = {}


def schema_dfa(name: str) -> ByteDfa:
    if name not in _DFAS:
        _DFAS[name] = ByteDfa(SCHEMAS[name])
    return _DFAS[name]


def replay_for(schema: Optional[str], eos_id: int, max_tokens: int, floor: int):
    """A ``Replay`` for a schema request, or None for a free-form one."""
    if schema is None:
        return None
    return Replay(schema_dfa(schema), eos_id, max_tokens, floor)
