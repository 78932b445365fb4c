"""Inspection persistence on stdlib sqlite3.

Same public API as the reference repository (reference:
src/database/repository.py:27-245): create/get/list/count/statistics/delete
plus `init_database()` / `health_check_database()`.  Uses WAL mode and a
connection per operation so the multi-threaded serving tier can write
concurrently with UI reads.
"""

from __future__ import annotations

import json
import sqlite3
from contextlib import contextmanager
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

from vis_tpu_torch.database.models import (
    DEFECTS_DDL,
    INDEX_DDL,
    INSPECTIONS_DDL,
    DefectRecord,
    InspectionRecord,
)
from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__, level="INFO", component="DATABASE")

_init_lock = threading.Lock()
_initialized_paths: set = set()

_INSPECTION_COLS = [
    "inspection_id", "image_path", "image_filename", "image_size_kb",
    "image_format", "criticality", "domain", "user_notes", "overall_verdict",
    "defect_count", "critical_defect_count", "inspector_confidence",
    "auditor_confidence", "models_agree", "agreement_score", "triggered_gates",
    "requires_human", "processing_time_seconds", "report_path", "created_at",
]
_DEFECT_COLS = [
    "inspection_id", "defect_id", "defect_type", "location", "bbox_x",
    "bbox_y", "bbox_width", "bbox_height", "safety_impact", "reasoning",
    "confidence", "recommended_action", "detected_by", "created_at",
]


class InspectionRepository:
    """CRUD + analytics over the inspections/defects tables."""

    def __init__(self, db_path: Optional[str] = None):
        self.db_path = str(db_path or config.database_path)
        self._ensure_schema()

    # -- connection management -----------------------------------------
    @contextmanager
    def _connect(self):
        # Closes on exit (per-op connections would otherwise leak WAL
        # handles until GC); the inner `with conn` keeps sqlite3's
        # commit/rollback semantics.
        conn = sqlite3.connect(self.db_path, timeout=30.0)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA journal_mode=WAL;")
        conn.execute("PRAGMA foreign_keys=ON;")
        from vis_tpu_torch.utils.config import config as _cfg

        if _cfg.database_echo:
            # DATABASE_ECHO (reference SQLAlchemy echo=True equivalent):
            # every executed statement at DEBUG.
            conn.set_trace_callback(lambda s: logger.debug(f"SQL: {s}"))
        try:
            with conn:
                yield conn
        finally:
            conn.close()

    def _ensure_schema(self) -> None:
        with _init_lock:
            # Key the cache on the RESOLVED path and bypass it when the file
            # is gone: a rotated/deleted DB (or a chdir moving a relative
            # path) would otherwise be recreated empty by sqlite3.connect
            # while the early-return skips the DDL, and every write after
            # that fails with 'no such table'.
            resolved = str(Path(self.db_path).resolve())
            if resolved in _initialized_paths and Path(resolved).exists():
                return
            with self._connect() as conn:
                conn.execute(INSPECTIONS_DDL)
                conn.execute(DEFECTS_DDL)
                for ddl in INDEX_DDL:
                    conn.execute(ddl)
            _initialized_paths.add(resolved)

    # -- writes ---------------------------------------------------------
    def create_inspection(
        self,
        inspection_data: Dict[str, Any],
        defects_data: Optional[List[Dict[str, Any]]] = None,
    ) -> InspectionRecord:
        """Persist one inspection and its defects atomically."""
        record = InspectionRecord(
            **{k: v for k, v in inspection_data.items()
               if k in InspectionRecord.__dataclass_fields__}
        )
        row = record.to_dict()
        row["models_agree"] = int(bool(row["models_agree"]))
        row["requires_human"] = int(bool(row["requires_human"]))
        row["triggered_gates"] = json.dumps(row["triggered_gates"])

        with self._connect() as conn:
            placeholders = ", ".join("?" for _ in _INSPECTION_COLS)
            conn.execute(
                f"INSERT INTO inspections ({', '.join(_INSPECTION_COLS)}) "
                f"VALUES ({placeholders})",
                [row[c] for c in _INSPECTION_COLS],
            )
            for defect in defects_data or []:
                drec = DefectRecord(
                    inspection_id=record.inspection_id,
                    **{k: v for k, v in defect.items()
                       if k in DefectRecord.__dataclass_fields__ and k != "inspection_id"},
                )
                drow = drec.to_dict()
                dplaceholders = ", ".join("?" for _ in _DEFECT_COLS)
                conn.execute(
                    f"INSERT INTO defects ({', '.join(_DEFECT_COLS)}) "
                    f"VALUES ({dplaceholders})",
                    [drow[c] for c in _DEFECT_COLS],
                )
        logger.info(f"Saved inspection {record.inspection_id} "
                    f"({len(defects_data or [])} defects)")
        return record

    # -- reads ----------------------------------------------------------
    def get_inspection(self, inspection_id: str) -> Optional[InspectionRecord]:
        with self._connect() as conn:
            row = conn.execute(
                "SELECT * FROM inspections WHERE inspection_id = ?", (inspection_id,)
            ).fetchone()
        return InspectionRecord.from_row(row) if row else None

    def get_defects(self, inspection_id: str) -> List[DefectRecord]:
        with self._connect() as conn:
            rows = conn.execute(
                "SELECT * FROM defects WHERE inspection_id = ? ORDER BY id",
                (inspection_id,),
            ).fetchall()
        return [DefectRecord.from_row(r) for r in rows]

    def list_inspections(
        self,
        limit: int = 50,
        offset: int = 0,
        verdict: Optional[str] = None,
        criticality: Optional[str] = None,
    ) -> List[InspectionRecord]:
        clauses, params = [], []
        if verdict:
            clauses.append("overall_verdict = ?")
            params.append(verdict)
        if criticality:
            clauses.append("criticality = ?")
            params.append(criticality)
        where = f"WHERE {' AND '.join(clauses)}" if clauses else ""
        with self._connect() as conn:
            rows = conn.execute(
                f"SELECT * FROM inspections {where} "
                "ORDER BY created_at DESC LIMIT ? OFFSET ?",
                params + [limit, offset],
            ).fetchall()
        return [InspectionRecord.from_row(r) for r in rows]

    def get_inspection_count(self) -> int:
        with self._connect() as conn:
            return conn.execute("SELECT COUNT(*) FROM inspections").fetchone()[0]

    def get_defect_statistics(self) -> Dict[str, Any]:
        """Analytics rollup (reference repository.py:147-200)."""
        with self._connect() as conn:
            defect_counts = dict(
                conn.execute(
                    "SELECT defect_type, COUNT(id) FROM defects GROUP BY defect_type"
                ).fetchall()
            )
            severity_counts = dict(
                conn.execute(
                    "SELECT safety_impact, COUNT(id) FROM defects GROUP BY safety_impact"
                ).fetchall()
            )
            verdict_counts = dict(
                conn.execute(
                    "SELECT overall_verdict, COUNT(id) FROM inspections "
                    "GROUP BY overall_verdict"
                ).fetchall()
            )
            total = conn.execute("SELECT COUNT(*) FROM inspections").fetchone()[0]
            agreed = conn.execute(
                "SELECT COUNT(*) FROM inspections WHERE models_agree = 1"
            ).fetchone()[0]
            avg_time = conn.execute(
                "SELECT AVG(processing_time_seconds) FROM inspections"
            ).fetchone()[0] or 0
        return {
            "defect_counts": defect_counts,
            "severity_counts": severity_counts,
            "verdict_counts": verdict_counts,
            "agreement_rate": agreed / total if total else 0,
            "total_inspections": total,
            "avg_processing_time": avg_time,
        }

    def set_report_path(self, inspection_id: str, report_path: str) -> None:
        """Backfill the PDF path: the row is created by the database node,
        which runs BEFORE finalize generates the report."""
        with self._connect() as conn:
            conn.execute(
                "UPDATE inspections SET report_path = ? "
                "WHERE inspection_id = ?",
                (report_path, inspection_id),
            )

    def delete_inspection(self, inspection_id: str) -> None:
        with self._connect() as conn:
            conn.execute("DELETE FROM defects WHERE inspection_id = ?", (inspection_id,))
            conn.execute(
                "DELETE FROM inspections WHERE inspection_id = ?", (inspection_id,)
            )


def init_database(db_path: Optional[str] = None) -> None:
    """Create tables if missing (reference repository.py:220)."""
    InspectionRepository(db_path)


def health_check_database(db_path: Optional[str] = None) -> bool:
    """True when the DB answers a trivial query (reference repository.py:231)."""
    try:
        InspectionRepository(db_path).get_inspection_count()
        return True
    except Exception as exc:
        logger.error(f"Database health check failed: {exc}")
        return False


__all__ = ["InspectionRepository", "init_database", "health_check_database"]
