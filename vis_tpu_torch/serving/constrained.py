"""Constrained JSON decoding: grammar-masked logits inside the fused scan.

The reference survives malformed model JSON with a 3-strategy parser and
field fix-ups (reference src/agents/vlm_inspector.py:142-267).  That is a
*recovery* strategy; this module is the *prevention* strategy SURVEY §7
(hard part 6) recommends: a byte-level JSON finite-state machine compiled
to per-tokenizer lookup tables that mask the logits at every decode step,
so the model can only emit tokens that keep the output a prefix of some
valid JSON document — and, jointly with a budget-feasibility rule, can
always *complete* the document within the request's token budget.

Design (all device-side work is two gathers + a compare per step):

- A pushdown automaton for JSON is flattened to a DFA by bounding the
  container nesting depth (MAX_DEPTH); states are (mode, container-stack)
  pairs, reachable states are enumerated by BFS over the 256 byte inputs.
- ``close_cost[s]`` = minimum number of BYTES from state ``s`` to a
  complete document (computed by fixpoint relaxation).  Because every
  token is >= 1 byte, it lower-bounds the number of TOKENS too.
- Token tables (per tokenizer): walking each token's UTF-8 bytes through
  the DFA yields ``token_trans[s, v]`` (next state or reject) and
  ``cost_after[s, v] = close_cost[token_trans[s, v]]``.
- Per decode step the allowed set is
      ``token_ok[s] & (cost_after[s] < remaining)``
  which maintains the invariant ``close_cost[state] < remaining``: the
  document always remains completable in the remaining budget, and as the
  budget tightens the mask funnels the model onto a shortest completion
  path.  At the ACCEPT state only EOS is allowed, which terminates the
  engine's chunked decode loop.

Tables are [num_states, K]; for byte-level tokenizers (the dev/bench
profile) K is the vocab and the tables are a few MB.  For very large
vocabularies (real checkpoints: ~151k pieces x ~1-2k DFA states would be
GBs dense) the compiler COMPRESSES columns: tokens whose byte strings act
identically on every state share one column, K becomes the number of
distinct behaviors, and a ``class_of`` [V] map carries vocab id ->
column.  ``json_constraint_tables`` returns None only when the tokenizer
fails the byte-composability probe (or the grammar is too wide even
compressed) — callers then fall back to unconstrained decode + the
robust parser.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

MAX_DEPTH = 6
_INF = np.int32(2**30)
_MAX_TABLE_ENTRIES = 64_000_000  # states x K guard (~256 MB of int32)
# Vocabularies past this compile column-class-compressed tables (real
# checkpoints: 32k-152k pieces); smaller vocabs (byte-level dev/bench,
# tiny test tokenizers) keep dense [S, V] tables.
_COMPRESS_VOCAB_THRESHOLD = 4096

_WS = frozenset(b" \t\n\r")
_DIGITS = frozenset(b"0123456789")
_HEX = frozenset(b"0123456789abcdefABCDEF")
# Bytes allowed raw inside a JSON string: anything except the control
# range, '"' and '\'.  Bytes >= 0x80 are permitted — invalid UTF-8 decodes
# to U+FFFD on the host, which is still a legal JSON string character.
_STR_RAW = frozenset(
    b for b in range(0x20, 0x100) if b not in (0x22, 0x5C)
)
_ESCAPABLE = frozenset(b'"\\/bfnrt')


def _end_value(stack: Tuple[str, ...]) -> Tuple[str, Tuple[str, ...]]:
    """State after a value completes inside `stack`."""
    if not stack:
        return ("accept", stack)
    return ("after", stack)


class _JsonDfa:
    """Byte-level DFA for JSON with bounded nesting depth.

    States are (mode, stack) tuples; `mode` is a small string tag, `stack`
    is the tuple of open containers ('o'/'a'), innermost last.  The root
    document is required to be an object (the agents' output contract,
    reference utils/prompts.py JSON schemas).
    """

    def __init__(self, max_depth: int = MAX_DEPTH):
        self.max_depth = max_depth
        self.states: Dict[Tuple, int] = {}
        self.trans: List[np.ndarray] = []  # per state: [256] int32
        self._build()

    def _sid(self, state: Tuple) -> int:
        if state not in self.states:
            self.states[state] = len(self.states)
            self.trans.append(np.full(256, -1, np.int32))
        return self.states[state]

    def _next(self, state: Tuple, byte: int) -> Optional[Tuple]:
        mode, stack = state
        depth = len(stack)

        if mode == "accept":
            return None  # only EOS (handled at the token layer)

        if mode == "root":
            if byte in _WS:
                return state
            if byte == 0x7B:  # {
                return ("key_or_close", stack + ("o",))
            return None

        if mode == "value":
            if byte in _WS:
                return state
            if byte == 0x7B and depth < self.max_depth:
                return ("key_or_close", stack + ("o",))
            if byte == 0x5B and depth < self.max_depth:  # [
                return ("val_or_close", stack + ("a",))
            if byte == 0x22:  # "
                return ("str", stack)
            if byte == 0x2D:  # -
                return ("num_minus", stack)
            if byte == 0x30:  # 0
                return ("num_zero", stack)
            if byte in _DIGITS:
                return ("num_int", stack)
            if byte == ord("t"):
                return (("lit", "rue"), stack)
            if byte == ord("f"):
                return (("lit", "alse"), stack)
            if byte == ord("n"):
                return (("lit", "ull"), stack)
            return None

        if mode == "val_or_close":  # just after '[' — value or ']'
            if byte in _WS:
                return state
            if byte == 0x5D:  # ]
                return _end_value(stack[:-1])
            return self._next(("value", stack), byte)

        if isinstance(mode, tuple) and mode[0] == "lit":
            rest = mode[1]
            if byte == ord(rest[0]):
                if len(rest) == 1:
                    return _end_value(stack)
                return (("lit", rest[1:]), stack)
            return None

        if mode in ("str", "key_str"):
            esc = "str_esc" if mode == "str" else "key_esc"
            if byte == 0x22:
                if mode == "key_str":
                    return ("colon", stack)
                return _end_value(stack)
            if byte == 0x5C:
                return (esc, stack)
            if byte in _STR_RAW:
                return state
            return None

        if mode in ("str_esc", "key_esc"):
            base = "str" if mode == "str_esc" else "key_str"
            if byte in _ESCAPABLE:
                return (base, stack)
            if byte == ord("u"):
                return ((base + "_u", 4), stack)
            return None

        if isinstance(mode, tuple) and mode[0] in ("str_u", "key_str_u"):
            base, n = mode
            if byte in _HEX:
                if n == 1:
                    return (base[: -2], stack)  # "str_u"->"str"
                return ((base, n - 1), stack)
            return None

        # --- numbers: terminable states fall through to the delimiter ---
        if mode == "num_minus":
            if byte == 0x30:
                return ("num_zero", stack)
            if byte in _DIGITS:
                return ("num_int", stack)
            return None
        if mode in ("num_zero", "num_int", "num_frac", "num_exp"):
            if byte in _DIGITS and mode in ("num_int", "num_frac", "num_exp"):
                return (mode, stack)
            if byte == 0x2E and mode in ("num_zero", "num_int"):  # .
                return ("num_dot", stack)
            if byte in (ord("e"), ord("E")) and mode in (
                "num_zero", "num_int", "num_frac",
            ):
                return ("num_e", stack)
            # number complete; delimiter handled by the container
            end_mode, end_stack = _end_value(stack)
            if end_mode == "accept":
                return None  # root is an object, never a bare number
            return self._next((end_mode, end_stack), byte)
        if mode == "num_dot":
            if byte in _DIGITS:
                return ("num_frac", stack)
            return None
        if mode == "num_e":
            if byte in (0x2B, 0x2D):
                return ("num_esign", stack)
            if byte in _DIGITS:
                return ("num_exp", stack)
            return None
        if mode == "num_esign":
            if byte in _DIGITS:
                return ("num_exp", stack)
            return None

        if mode == "after":
            # inside a container, after a complete value
            container = stack[-1]
            if byte in _WS:
                return state
            if byte == 0x2C:  # ,
                if container == "o":
                    return ("key_expect", stack)
                return ("value", stack)
            if byte == 0x7D and container == "o":
                return _end_value(stack[:-1])
            if byte == 0x5D and container == "a":
                return _end_value(stack[:-1])
            return None

        if mode == "key_or_close":
            if byte in _WS:
                return state
            if byte == 0x22:
                return ("key_str", stack)
            if byte == 0x7D:
                return _end_value(stack[:-1])
            return None

        if mode == "key_expect":
            if byte in _WS:
                return state
            if byte == 0x22:
                return ("key_str", stack)
            return None

        if mode == "colon":
            if byte in _WS:
                return state
            if byte == 0x3A:  # :
                return ("value", stack)
            return None

        raise AssertionError(f"unhandled DFA mode {mode!r}")

    def _build(self) -> None:
        start = ("root", ())
        self._sid(start)
        frontier = [start]
        while frontier:
            state = frontier.pop()
            sid = self.states[state]
            for byte in range(256):
                nxt = self._next(state, byte)
                if nxt is None:
                    continue
                is_new = nxt not in self.states
                self.trans[sid][byte] = self._sid(nxt)
                if is_new:
                    frontier.append(nxt)
        self.n_states = len(self.states)
        self.trans_table = np.stack(self.trans)  # [S, 256]
        self.accept_id = self.states.get(("accept", ()), -1)
        assert self.accept_id >= 0, "accept state unreachable"
        self.start_id = self.states[start]
        self._close_costs()

    def _close_costs(self) -> None:
        self.close_cost = _close_costs_table(self.trans_table, self.accept_id)


def _close_costs_table(trans_table: np.ndarray, accept_id: int) -> np.ndarray:
    """close_cost[s] = min bytes from s to accept (fixpoint relaxation;
    shared by the generic-JSON and schema DFAs)."""
    n_states = trans_table.shape[0]
    cost = np.full(n_states, _INF, np.int64)
    cost[accept_id] = 0
    for _ in range(n_states):
        valid = trans_table >= 0  # [S, 256]
        nxt_cost = np.where(valid, cost[np.clip(trans_table, 0, None)], _INF)
        new = np.minimum(cost, 1 + nxt_cost.min(axis=1))
        if np.array_equal(new, cost):
            break
        cost = new
    return np.minimum(cost, _INF).astype(np.int32)


_dfa_lock = threading.Lock()
_dfa_cache: Dict[int, _JsonDfa] = {}


def _get_dfa(max_depth: int) -> _JsonDfa:
    with _dfa_lock:
        if max_depth not in _dfa_cache:
            _dfa_cache[max_depth] = _JsonDfa(max_depth)
        return _dfa_cache[max_depth]


@dataclass
class ConstraintTables:
    """Per-tokenizer JSON constraint tables (host numpy; engines move them
    on device once and reuse across requests)."""

    token_ok: np.ndarray     # [S, K] bool  — token keeps output a valid prefix
    token_trans: np.ndarray  # [S, K] int32 — DFA state after the token
    cost_after: np.ndarray   # [S, K] int32 — close_cost of that state (INF if rejected)
    init_state: int
    accept_state: int
    eos_id: int
    min_budget: int          # smallest max_tokens that can complete a document
    # Forced-move tables for lookahead decode: states whose allowed set is a
    # single token (schema skeleton runs; EOS at accept).  -1 where free.
    forced_token: np.ndarray = None   # [S] int32
    forced_state: np.ndarray = None   # [S] int32
    # Column-class compression (None = dense, K == vocab): tokens whose
    # byte strings act IDENTICALLY on every DFA state share one table
    # column, so K is the number of distinct behaviors (hundreds) instead
    # of the vocab size (151k for real checkpoints — a dense [S, V] int32
    # table would be GBs of HBM).  class_of maps vocab id -> column.
    class_of: np.ndarray = None       # [V] int32

    @property
    def num_states(self) -> int:
        return self.token_ok.shape[0]


def _bytelevel_char_to_byte() -> Dict[str, int]:
    """Inverse of the GPT-2 ``bytes_to_unicode`` map used by byte-level BPE
    vocabularies (Qwen, Llama-3/Mllama tokenizer.json): printable stand-in
    characters -> the raw byte they represent."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


_BYTELEVEL_DECODER = _bytelevel_char_to_byte()


def _id_to_piece_fn(tokenizer):
    """Vocab-piece lookup for the supported tokenizer wrappers, or None."""
    rust = getattr(tokenizer, "_tok", None)  # serving.tokenizer.HFTokenizer
    if rust is not None and hasattr(rust, "id_to_token"):
        return rust.id_to_token
    conv = getattr(tokenizer, "convert_ids_to_tokens", None)  # raw HF
    if conv is not None:
        return lambda i: conv(int(i))
    return None


def _piece_bytes(piece: Optional[str], family: str) -> Optional[bytes]:
    """In-context byte contribution of one vocab piece.

    Standalone ``decode([id])`` is NOT used for content: SentencePiece-family
    tokenizers strip/remap the leading-space marker in single-token decode,
    so decode-derived bytes can diverge from the detokenized output.  The
    piece string itself is unambiguous: byte-level BPE pieces map through
    the GPT-2 stand-in alphabet; SentencePiece pieces use U+2581 for space
    and ``<0xNN>`` byte-fallback entries."""
    if not piece:
        return None
    if family == "bytelevel":
        out = bytearray()
        for ch in piece:
            b = _BYTELEVEL_DECODER.get(ch)
            if b is None:
                return None  # added/special token — not raw content
            out.append(b)
        return bytes(out)
    # SentencePiece family.
    if len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
        try:
            return bytes([int(piece[3:5], 16)])
        except ValueError:
            return None
    if "▁" in piece:
        piece = piece.replace("▁", " ")
    try:
        return piece.encode("utf-8")
    except UnicodeEncodeError:
        return None


def _vocab_byte_contents(
    tokenizer, vocab_size: int
) -> Optional[List[Optional[bytes]]]:
    """Byte content per vocab id (None for specials/undecodable), or None
    if the tokenizer fails the byte-composability probe — callers then skip
    constrained decode entirely rather than risk DFA/detokenizer drift."""
    eos = getattr(tokenizer, "eos_id", None)
    contents: List[Optional[bytes]] = [None] * vocab_size
    if type(tokenizer).__name__ == "ByteTokenizer":
        for v in range(min(vocab_size, 256)):
            contents[v] = bytes([v])
        if eos is not None and 0 <= eos < vocab_size:
            contents[eos] = None
        return contents

    id_to_piece = _id_to_piece_fn(tokenizer)
    if id_to_piece is None:
        return None

    # Family detection: pieces of " a" carry the space marker.
    try:
        probe_ids = tokenizer.encode(" a")
        probe_pieces = "".join(id_to_piece(i) or "" for i in probe_ids)
    except Exception:
        return None
    if "▁" in probe_pieces:
        family = "spm"
    elif all(ch in _BYTELEVEL_DECODER for ch in probe_pieces):
        family = "bytelevel"
    else:
        return None

    special_ids = set()
    raw_special = getattr(tokenizer, "all_special_ids", None)
    if raw_special:
        special_ids.update(int(i) for i in raw_special)
    rust = getattr(tokenizer, "_tok", None)
    if rust is not None and hasattr(rust, "get_added_tokens_decoder"):
        try:
            special_ids.update(int(i) for i in rust.get_added_tokens_decoder())
        except Exception:
            pass
    for name in ("eos_id", "bos_id", "pad_id", "image_token_id",
                 "vision_start_id", "vision_end_id"):
        value = getattr(tokenizer, name, None)
        if value is not None:
            special_ids.add(int(value))

    for v in range(vocab_size):
        if v in special_ids:
            continue
        try:
            piece = id_to_piece(v)
        except Exception:
            piece = None
        contents[v] = _piece_bytes(piece, family)

    # Composability probe: round-trip JSON-shaped text through encode and
    # the derived byte map; any drift disables constrained decode for this
    # tokenizer (fall back to unconstrained + robust parser).
    for probe in ('{"verdict": "SAFE", "scores": [0.25, -3e1, true, null]}',
                  'a b\tc\nd "quoted\\path"'):
        try:
            ids = tokenizer.encode(probe)
        except Exception:
            return None
        parts = [contents[i] if 0 <= i < vocab_size else None for i in ids]
        if any(p is None for p in parts):
            return None
        if b"".join(parts) != probe.encode("utf-8"):
            return None
    return contents


def _tokenizer_fingerprint(tokenizer, vocab_size: int) -> Tuple:
    """Identity component for the table caches: two tokenizer instances of
    the same class/width but different vocab contents or eos must not share
    compiled tables.  Besides fixed-index piece samples, the fingerprint
    walks the pieces along canonical JSON-shaped probe encodings — a vocab
    that differs anywhere content-relevant (the bytes the DFA will track)
    produces different probe ids or pieces."""
    eos = getattr(tokenizer, "eos_id", None)
    sample: List[Optional[str]] = []
    id_to_piece = _id_to_piece_fn(tokenizer)
    if id_to_piece is not None:
        for v in (0, 1, vocab_size // 2, vocab_size - 1):
            try:
                sample.append(id_to_piece(max(0, min(v, vocab_size - 1))))
            except Exception:
                sample.append(None)
        for probe in ('{"verdict": "SAFE", "n": [0.5, true, null]}',
                      'a b\tc\nd "quoted\\path"'):
            try:
                ids = tokenizer.encode(probe)
                sample.append("\x00".join(
                    str(i) + ":" + (id_to_piece(i) or "") for i in ids
                ))
            except Exception:
                sample.append(None)
    return (type(tokenizer).__name__, vocab_size, eos, tuple(sample))


_tables_lock = threading.Lock()
_tables_cache: Dict[Tuple, Optional[ConstraintTables]] = {}
_compile_key_locks: Dict[Tuple, threading.Lock] = {}


def compile_cached(cache: Dict, cache_lock: threading.Lock, key: Tuple,
                   compile_fn):
    """Per-key once-compilation: a table compile is a full vocab x states
    walk (seconds at large vocabs), so concurrent first requests for the
    SAME key must not both pay it — while different keys (other engines'
    vocabs) still compile in parallel."""
    with cache_lock:
        if key in cache:
            return cache[key]
        key_lock = _compile_key_locks.setdefault(key, threading.Lock())
    with key_lock:
        with cache_lock:
            if key in cache:
                return cache[key]
        tables = compile_fn()
        with cache_lock:
            cache[key] = tables
        return tables


def json_constraint_tables(
    tokenizer, vocab_size: int, max_depth: int = MAX_DEPTH
) -> Optional[ConstraintTables]:
    """Compile (and cache) JSON constraint tables for a tokenizer.

    Large vocabularies get column-class-compressed tables (class_of set);
    returns None only for tokenizers that fail the byte-composability
    probe — callers then decode unconstrained and rely on the robust
    parser (reference vlm_inspector.py:142 behavior).
    """
    key = ("json", _tokenizer_fingerprint(tokenizer, vocab_size),
           getattr(tokenizer, "vocab_size", vocab_size),
           vocab_size, max_depth)
    return compile_cached(
        _tables_cache, _tables_lock, key,
        lambda: _compile_tables(
            _get_dfa(max_depth), tokenizer, vocab_size, require_open=True
        ),
    )


def _compile_tables(
    dfa, tokenizer, vocab_size: int, require_open: bool
) -> Optional[ConstraintTables]:
    """Compile any byte-DFA (generic JSON or a schema DFA — anything with
    trans_table/close_cost/start_id/accept_id) to per-tokenizer tables.

    require_open: demand every reachable state keep a cost>0 continuation
    (needed for the generic DFA's min-length floor; schema DFAs have
    forced-close states, so they compile with require_open=False and the
    decoder's floor mask falls through to the forced move there)."""
    # ByteTokenizer: only ids < 262 carry content/specials, so the tables
    # can be narrow even when the model's logits are padded to a real
    # model's vocab width — the decoder arg-maxes over the masked head and
    # everything past the table width is implicitly disallowed.
    if type(tokenizer).__name__ == "ByteTokenizer":
        vocab_size = min(vocab_size, 262)
    # Dense [S, V] tables at real 151k vocabularies would be GBs of HBM;
    # compress instead of refusing: tokens whose bytes act identically on
    # every state share one table COLUMN, and the number of distinct
    # behaviors is grammar-bounded (hundreds), not vocab-bounded.  The
    # decoder indexes through class_of ([V] int32).  The trigger is a
    # VOCAB threshold (not the entry cap) so every grammar of one
    # tokenizer shares a format — the scheduler stacks a tokenizer's
    # tables into one [T, S, K] array and cannot mix dense with
    # compressed.
    compress = vocab_size > _COMPRESS_VOCAB_THRESHOLD

    S, V = dfa.n_states, vocab_size
    contents = _vocab_byte_contents(tokenizer, V)
    if contents is None:
        return None
    eos_id = int(getattr(tokenizer, "eos_id", 0))

    def token_columns(vs: List[int]) -> np.ndarray:
        """[n, S] int32 state-actions (-1 = rejected) for a BLOCK of token
        ids, vectorized over tokens x states (a per-token python walk at
        151k-piece vocabularies costs a minute per grammar on a slow
        host), with the accept-state law folded in: at ACCEPT only EOS is
        allowed (self-loop; repeated EOS after the closed document is
        stripped by the engine's host-side EOS check)."""
        n = len(vs)
        conts = [contents[v] or b"" for v in vs]
        lens = np.array([len(c) for c in conts], np.int32)
        L = int(lens.max()) if n else 0
        byte_mat = np.zeros((n, L), np.int32)
        for i, c in enumerate(conts):
            if c:
                byte_mat[i, : len(c)] = np.frombuffer(c, np.uint8)
        cur = np.broadcast_to(
            np.arange(S, dtype=np.int32), (n, S)
        ).copy()
        alive = np.ones((n, S), bool)
        for pos in range(L):
            live_rows = lens > pos
            step = dfa.trans_table[cur, byte_mat[:, pos][:, None]]
            new_alive = alive & (step >= 0)
            cur = np.where(
                live_rows[:, None], np.where(new_alive, step, 0), cur
            )
            alive = np.where(live_rows[:, None], new_alive, alive)
        cols = np.where(alive, cur, -1).astype(np.int32)
        cols[lens == 0] = -1  # specials / undecodable: never legal
        cols[:, dfa.accept_id] = np.where(
            np.asarray(vs) == eos_id, dfa.accept_id, -1
        )
        return cols

    _BLOCK = 2048  # token block: n x S walk state stays tens of MB

    def _blocks_by_length() -> List[List[int]]:
        """Token-id blocks grouped by content length, so a block's walk
        runs exactly its tokens' byte count (mixed-length blocks pay the
        longest member for every row)."""
        by_len: Dict[int, List[int]] = {}
        for v in range(V):
            by_len.setdefault(len(contents[v] or b""), []).append(v)
        blocks = []
        for _, vs in sorted(by_len.items()):
            for start in range(0, len(vs), _BLOCK):
                blocks.append(vs[start:start + _BLOCK])
        return blocks

    if compress:
        class_of = np.empty(V, np.int32)
        class_cols: List[np.ndarray] = []
        class_first: List[int] = []
        index: Dict[bytes, int] = {}
        for vs in _blocks_by_length():
            cols = token_columns(vs)
            # Dedup inside the block first: hashing every token's [S]
            # column re-serializes ~S*4 bytes x 151k tokens per grammar;
            # np.unique leaves only the grammar-bounded distinct rows
            # (hundreds) for the python-level cross-block merge.
            uniq, first_idx, inv = np.unique(
                cols, axis=0, return_index=True, return_inverse=True
            )
            gid = np.empty(len(uniq), np.int32)
            for j in np.argsort(first_idx):  # first-seen creation order
                key = uniq[j].tobytes()
                cid = index.get(key)
                if cid is None:
                    cid = len(class_cols)
                    index[key] = cid
                    class_cols.append(uniq[j])
                    class_first.append(vs[int(first_idx[j])])
                gid[j] = cid
            class_of[np.asarray(vs, np.int64)] = gid[inv]
        token_trans = np.stack(class_cols, axis=1)  # [S, C]
        counts = np.bincount(class_of, minlength=len(class_cols)).astype(
            np.int64
        )
        first_token = np.asarray(class_first, np.int32)
        if S * token_trans.shape[1] > _MAX_TABLE_ENTRIES:
            return None  # grammar itself is too wide even compressed
    else:
        if S * V > _MAX_TABLE_ENTRIES:
            return None  # enormous grammar at a small vocab: refuse dense
        token_trans = np.full((S, V), -1, np.int32)
        for vs in _blocks_by_length():
            token_trans[:, vs] = token_columns(vs).T
        class_of = None
        counts = np.ones(V, np.int64)
        first_token = np.arange(V, dtype=np.int32)

    token_ok = token_trans >= 0
    cost_after = np.where(
        token_ok, dfa.close_cost[np.clip(token_trans, 0, None)], _INF
    ).astype(np.int32)

    # Completability guard: from every reachable non-accept state some
    # token must strictly reduce the closing cost, otherwise the funnel
    # could dead-end under a tight budget.
    reachable = np.zeros(S, bool)
    reachable[dfa.start_id] = True
    for _ in range(S):
        nxt = token_trans[reachable]
        ids = nxt[nxt >= 0]
        new = reachable.copy()
        new[ids] = True
        if np.array_equal(new, reachable):
            break
        reachable = new
    finite = dfa.close_cost < _INF
    need = reachable & finite & (np.arange(S) != dfa.accept_id)
    best_after = np.where(token_ok, cost_after, _INF).min(axis=1)
    ok = best_after[need] < dfa.close_cost[need]
    if not bool(np.all(ok)):
        return None
    if require_open:
        # Min-length support: every non-accept state must also have a token
        # that KEEPS the document open (cost_after > 0), or the completion
        # floor in constrained_argmax could dead-end.
        open_ok = ((cost_after > 0) & (cost_after < _INF)).any(axis=1)
        if not bool(np.all(open_ok[need])):
            return None

    # Forced-move tables: a state with exactly one allowed TOKEN (not
    # class — a class may cover many tokens) has no model choice —
    # lookahead decode emits the whole forced run in one weight pass
    # (models/common/decoder.py decode_loop_lookahead).  Dense tables use
    # counts == 1 per column, so the formulas coincide.
    n_allowed = (token_ok * counts[None, :]).sum(axis=1)
    only = np.argmax(token_ok, axis=1).astype(np.int32)
    forced_token = np.where(n_allowed == 1, first_token[only], -1).astype(
        np.int32
    )
    forced_state = np.where(
        n_allowed == 1,
        token_trans[np.arange(S), np.clip(only, 0, None)],
        -1,
    ).astype(np.int32)

    return ConstraintTables(
        token_ok=token_ok,
        token_trans=np.where(token_ok, token_trans, 0).astype(np.int32),
        cost_after=cost_after,
        init_state=dfa.start_id,
        accept_state=dfa.accept_id,
        eos_id=eos_id,
        min_budget=int(dfa.close_cost[dfa.start_id]) + 1,
        forced_token=forced_token,
        forced_state=forced_state,
        class_of=class_of,
    )


def walk_document(tables: ConstraintTables, token_ids, start_state=None) -> int:
    """Host-side replay of a token sequence; returns the final DFA state or
    raises if any token was illegal (test/debug helper)."""
    state = tables.init_state if start_state is None else start_state
    for t in token_ids:
        col = t if tables.class_of is None else int(tables.class_of[t])
        if not tables.token_ok[state, col]:
            raise ValueError(f"token {t} illegal in state {state}")
        state = int(tables.token_trans[state, col])
    return state
