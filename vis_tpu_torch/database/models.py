"""SQLite schema + record types for inspection persistence.

Same logical schema as the reference ORM (reference: src/database/models.py:
18-134) — an `inspections` table 1-N `defects` — but implemented on stdlib
sqlite3 (SQLAlchemy is not available in this environment, and a serving host
does not need an ORM for two tables).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

INSPECTIONS_DDL = """
CREATE TABLE IF NOT EXISTS inspections (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    inspection_id TEXT UNIQUE NOT NULL,
    image_path TEXT NOT NULL,
    image_filename TEXT NOT NULL,
    image_size_kb REAL,
    image_format TEXT,
    criticality TEXT NOT NULL,
    domain TEXT,
    user_notes TEXT,
    overall_verdict TEXT NOT NULL,
    defect_count INTEGER DEFAULT 0,
    critical_defect_count INTEGER DEFAULT 0,
    inspector_confidence TEXT,
    auditor_confidence TEXT,
    models_agree INTEGER DEFAULT 0,
    agreement_score REAL,
    triggered_gates TEXT,
    requires_human INTEGER DEFAULT 0,
    processing_time_seconds REAL,
    report_path TEXT,
    created_at TEXT NOT NULL
);
"""

DEFECTS_DDL = """
CREATE TABLE IF NOT EXISTS defects (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    inspection_id TEXT NOT NULL REFERENCES inspections(inspection_id) ON DELETE CASCADE,
    defect_id TEXT NOT NULL,
    defect_type TEXT NOT NULL,
    location TEXT,
    bbox_x REAL,
    bbox_y REAL,
    bbox_width REAL,
    bbox_height REAL,
    safety_impact TEXT NOT NULL,
    reasoning TEXT,
    confidence TEXT,
    recommended_action TEXT,
    detected_by TEXT,
    created_at TEXT NOT NULL
);
"""

INDEX_DDL = [
    "CREATE INDEX IF NOT EXISTS idx_inspections_inspection_id ON inspections(inspection_id);",
    "CREATE INDEX IF NOT EXISTS idx_inspections_created_at ON inspections(created_at);",
    "CREATE INDEX IF NOT EXISTS idx_defects_inspection_id ON defects(inspection_id);",
    "CREATE INDEX IF NOT EXISTS idx_defects_type ON defects(defect_type);",
]


def _utcnow_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


@dataclass
class InspectionRecord:
    """One persisted inspection (reference models.py:18-81)."""

    inspection_id: str
    image_path: str
    image_filename: str
    criticality: str
    overall_verdict: str
    id: Optional[int] = None
    image_size_kb: Optional[float] = None
    image_format: Optional[str] = None
    domain: Optional[str] = None
    user_notes: Optional[str] = None
    defect_count: int = 0
    critical_defect_count: int = 0
    inspector_confidence: Optional[str] = None
    auditor_confidence: Optional[str] = None
    models_agree: bool = False
    agreement_score: Optional[float] = None
    triggered_gates: List[str] = field(default_factory=list)
    requires_human: bool = False
    processing_time_seconds: Optional[float] = None
    report_path: Optional[str] = None
    created_at: str = field(default_factory=_utcnow_iso)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_row(cls, row: Any) -> "InspectionRecord":
        d = dict(row)
        d["models_agree"] = bool(d.get("models_agree"))
        d["requires_human"] = bool(d.get("requires_human"))
        gates = d.get("triggered_gates")
        d["triggered_gates"] = json.loads(gates) if gates else []
        return cls(**d)


@dataclass
class DefectRecord:
    """One persisted defect (reference models.py:84-131)."""

    inspection_id: str
    defect_id: str
    defect_type: str
    safety_impact: str
    id: Optional[int] = None
    location: Optional[str] = None
    bbox_x: Optional[float] = None
    bbox_y: Optional[float] = None
    bbox_width: Optional[float] = None
    bbox_height: Optional[float] = None
    reasoning: Optional[str] = None
    confidence: Optional[str] = None
    recommended_action: Optional[str] = None
    detected_by: Optional[str] = None
    created_at: str = field(default_factory=_utcnow_iso)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_row(cls, row: Any) -> "DefectRecord":
        return cls(**dict(row))


__all__ = [
    "InspectionRecord",
    "DefectRecord",
    "INSPECTIONS_DDL",
    "DEFECTS_DDL",
    "INDEX_DDL",
]
