"""SQLite-backed chat history with session management and query rewriting.

Same capability surface as the reference (reference: src/chat_memory.py:29-423)
— per-session message persistence, trimming to `max_chat_history`, session
CRUD, heuristic + LLM-backed standalone-query rewriting — without the
LangChain dependency: messages are plain (role, content, timestamp) records,
and the LLM hook is any `str -> str` callable (the on-pod explainer engine).
"""

from __future__ import annotations

import sqlite3
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Any, Callable, Dict, List, Optional, Tuple

from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.logger import setup_logger
from vis_tpu_torch.utils.prompts import CHAT_HISTORY_AWARE_PROMPT

logger = setup_logger(__name__, level="INFO", component="CHAT_MEMORY")

ROLE_USER = "user"
ROLE_ASSISTANT = "assistant"

_DDL = [
    """
    CREATE TABLE IF NOT EXISTS chat_messages (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        session_id TEXT NOT NULL,
        role TEXT NOT NULL,
        content TEXT NOT NULL,
        created_at TEXT NOT NULL
    );
    """,
    """
    CREATE TABLE IF NOT EXISTS chat_sessions (
        session_id TEXT PRIMARY KEY,
        inspection_id TEXT,
        title TEXT,
        created_at TEXT NOT NULL,
        last_active TEXT NOT NULL
    );
    """,
    "CREATE INDEX IF NOT EXISTS idx_chat_messages_session ON chat_messages(session_id);",
]

_schema_lock = threading.Lock()
_schema_ready: set = set()


def _utcnow_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


@dataclass
class ChatMessage:
    role: str
    content: str
    created_at: str = ""

    @property
    def is_user(self) -> bool:
        return self.role == ROLE_USER


class SQLiteChatHistory:
    """Message history for one chat session (reference chat_memory.py:29-217)."""

    def __init__(self, session_id: str, db_path: Optional[str] = None):
        self.session_id = session_id
        self.db_path = str(db_path or config.chat_history_db)
        self._ensure_schema()

    @contextmanager
    def _connect(self):
        # Closes the connection on exit (per-op connections would otherwise
        # leak WAL handles until GC); the inner `with conn` keeps sqlite3's
        # commit/rollback semantics.
        conn = sqlite3.connect(self.db_path, timeout=30.0)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA journal_mode=WAL;")
        try:
            with conn:
                yield conn
        finally:
            conn.close()

    def _ensure_schema(self) -> None:
        with _schema_lock:
            if self.db_path in _schema_ready:
                return
            with self._connect() as conn:
                for ddl in _DDL:
                    conn.execute(ddl)
            _schema_ready.add(self.db_path)

    @property
    def messages(self) -> List[ChatMessage]:
        with self._connect() as conn:
            rows = conn.execute(
                "SELECT role, content, created_at FROM chat_messages "
                "WHERE session_id = ? ORDER BY id",
                (self.session_id,),
            ).fetchall()
        return [ChatMessage(r["role"], r["content"], r["created_at"]) for r in rows]

    def add_message(self, role: str, content: str) -> None:
        with self._connect() as conn:
            conn.execute(
                "INSERT INTO chat_messages (session_id, role, content, created_at) "
                "VALUES (?, ?, ?, ?)",
                (self.session_id, role, content, _utcnow_iso()),
            )
            conn.execute(
                "UPDATE chat_sessions SET last_active = ? WHERE session_id = ?",
                (_utcnow_iso(), self.session_id),
            )
        self.trim_messages()

    def add_user_message(self, content: str) -> None:
        self.add_message(ROLE_USER, content)

    def add_ai_message(self, content: str) -> None:
        self.add_message(ROLE_ASSISTANT, content)

    def clear(self) -> None:
        with self._connect() as conn:
            conn.execute(
                "DELETE FROM chat_messages WHERE session_id = ?", (self.session_id,)
            )

    def get_message_count(self) -> int:
        with self._connect() as conn:
            return conn.execute(
                "SELECT COUNT(*) FROM chat_messages WHERE session_id = ?",
                (self.session_id,),
            ).fetchone()[0]

    def trim_messages(self, max_messages: Optional[int] = None) -> None:
        """Keep only the newest `max_messages` rows for this session
        (reference chat_memory.py:184-213)."""
        limit = max_messages if max_messages is not None else config.max_chat_history
        with self._connect() as conn:
            conn.execute(
                "DELETE FROM chat_messages WHERE session_id = ? AND id NOT IN ("
                "  SELECT id FROM chat_messages WHERE session_id = ? "
                "  ORDER BY id DESC LIMIT ?)",
                (self.session_id, self.session_id, limit),
            )


class ChatMemoryManager:
    """Session CRUD over the chat DB (reference chat_memory.py:220-339)."""

    def __init__(self, db_path: Optional[str] = None):
        self.db_path = str(db_path or config.chat_history_db)
        SQLiteChatHistory("__bootstrap__", self.db_path)  # ensure schema

    @contextmanager
    def _connect(self):
        conn = sqlite3.connect(self.db_path, timeout=30.0)
        conn.row_factory = sqlite3.Row
        try:
            with conn:
                yield conn
        finally:
            conn.close()

    def get_history(self, session_id: str) -> SQLiteChatHistory:
        return SQLiteChatHistory(session_id, self.db_path)

    def create_session(
        self,
        session_id: str,
        inspection_id: Optional[str] = None,
        title: Optional[str] = None,
    ) -> str:
        now = _utcnow_iso()
        with self._connect() as conn:
            conn.execute(
                "INSERT OR REPLACE INTO chat_sessions "
                "(session_id, inspection_id, title, created_at, last_active) "
                "VALUES (?, ?, ?, COALESCE((SELECT created_at FROM chat_sessions "
                "WHERE session_id = ?), ?), ?)",
                (session_id, inspection_id, title, session_id, now, now),
            )
        return session_id

    def get_session_info(self, session_id: str) -> Optional[Dict[str, Any]]:
        with self._connect() as conn:
            row = conn.execute(
                "SELECT * FROM chat_sessions WHERE session_id = ?", (session_id,)
            ).fetchone()
            if row is None:
                return None
            count = conn.execute(
                "SELECT COUNT(*) FROM chat_messages WHERE session_id = ?",
                (session_id,),
            ).fetchone()[0]
        info = dict(row)
        info["message_count"] = count
        return info

    def list_sessions(self, limit: int = 20) -> List[Dict[str, Any]]:
        with self._connect() as conn:
            rows = conn.execute(
                "SELECT * FROM chat_sessions ORDER BY last_active DESC LIMIT ?",
                (limit,),
            ).fetchall()
        return [dict(r) for r in rows]

    def delete_session(self, session_id: str) -> None:
        with self._connect() as conn:
            conn.execute(
                "DELETE FROM chat_messages WHERE session_id = ?", (session_id,)
            )
            conn.execute(
                "DELETE FROM chat_sessions WHERE session_id = ?", (session_id,)
            )


_FOLLOWUP_STARTERS = {"it", "this", "that", "they", "those", "where", "how"}


def rewrite_query_with_history(
    query: str,
    chat_history: List[ChatMessage],
    llm: Optional[Callable[[str], str]] = None,
) -> str:
    """Make a follow-up question standalone (reference chat_memory.py:342-404).

    Without an LLM: a pronoun-opener heuristic prefixes context.  With an LLM
    (any `prompt -> text` callable, e.g. the on-pod explainer), the
    CHAT_HISTORY_AWARE_PROMPT drives a real rewrite.
    """
    if not chat_history:
        return query

    if llm is None:
        first_word = query.lower().split()[0] if query.split() else ""
        if first_word in _FOLLOWUP_STARTERS:
            for msg in reversed(chat_history[-4:]):
                if msg.role == ROLE_ASSISTANT:
                    return f"Regarding the previous response about inspection results: {query}"
        return query

    try:
        history_str = "\n".join(
            f"{'User' if m.is_user else 'Assistant'}: {m.content}"
            for m in chat_history[-6:]
        )
        prompt = CHAT_HISTORY_AWARE_PROMPT.format(
            chat_history=history_str, question=query
        )
        rewritten = llm(prompt)
        return rewritten.strip()
    except Exception as exc:
        logger.warning(f"Query rewriting failed, using original: {exc}")
        return query


_memory_manager: Optional[ChatMemoryManager] = None
_manager_lock = threading.Lock()


def get_memory_manager() -> ChatMemoryManager:
    global _memory_manager
    with _manager_lock:
        if _memory_manager is None:
            _memory_manager = ChatMemoryManager()
        return _memory_manager


def get_session_history(session_id: str) -> SQLiteChatHistory:
    return get_memory_manager().get_history(session_id)


#: Hard cap on one chat question (shared by the web API and the CLI).
MAX_CHAT_QUESTION_CHARS = 2000
#: How many persisted turns seed a fresh engine session after restart.
HISTORY_SEED_TURNS = 8


def prepare_chat_turn(
    request_id: str, question: str,
) -> Tuple[str, Optional[SQLiteChatHistory], str, Optional[str]]:
    """One chat-memory entry flow shared by the web server and the CLI.

    Returns ``(session_id, history, standalone_question, history_text)``:
    the per-inspection session id, the SQLite history (None when
    ENABLE_CHAT_MEMORY=false — stateless turns, nothing persisted), the
    question rewritten standalone against the history, and the last few
    persisted turns formatted to seed a FRESH engine session (after a
    restart/eviction the device KV is empty and the SQLite memory is the
    only copy of the conversation).
    """
    from vis_tpu_torch.utils.config import config

    question = str(question)[:MAX_CHAT_QUESTION_CHARS]
    session_id = f"chat-{request_id}"
    history = (
        get_session_history(session_id) if config.enable_chat_memory else None
    )
    standalone = question
    history_text = None
    if history is not None and history.messages:
        standalone = rewrite_query_with_history(question, history.messages)
        recent = history.messages[-HISTORY_SEED_TURNS:]
        history_text = "\n".join(
            f"{'User' if m.is_user else 'Assistant'}: {m.content}"
            for m in recent
        )
    return session_id, history, standalone, history_text


def persist_chat_turn(
    history: Optional[SQLiteChatHistory], question: str, answer: str,
) -> None:
    """Persist one COMPLETE turn; no-op for stateless or empty/failed turns
    (a truncated answer in the durable history would pollute every later
    rewrite and session seed)."""
    if history is not None and answer:
        history.add_user_message(str(question)[:MAX_CHAT_QUESTION_CHARS])
        history.add_ai_message(answer)


__all__ = [
    "ChatMessage",
    "SQLiteChatHistory",
    "ChatMemoryManager",
    "rewrite_query_with_history",
    "prepare_chat_turn",
    "persist_chat_turn",
    "get_memory_manager",
    "get_session_history",
    "ROLE_USER",
    "ROLE_ASSISTANT",
]
