"""Input validation helpers (reference: utils/validators.py:14-208).

All validators return `(is_valid, error_message, normalized_value)` so callers
can surface actionable messages without exceptions on the user-input path.
"""

from __future__ import annotations

import re
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from vis_tpu_torch.utils.config import config

VALID_CRITICALITIES = ("low", "medium", "high")
MAX_DOMAIN_LEN = 100
MAX_NOTES_LEN = 1000
MAX_REQUEST_ID_LEN = 36


def validate_criticality(value: str) -> Tuple[bool, Optional[str], str]:
    normalized = value.lower().strip()
    if normalized not in VALID_CRITICALITIES:
        return False, f"Invalid criticality. Must be one of: {list(VALID_CRITICALITIES)}", value
    return True, None, normalized


def validate_domain(value: Optional[str]) -> Tuple[bool, Optional[str], Optional[str]]:
    if not value:
        return True, None, None
    normalized = re.sub(r"\s+", "_", value.lower().strip())
    normalized = re.sub(r"[^a-z0-9_-]", "", normalized)
    if len(normalized) > MAX_DOMAIN_LEN:
        return False, f"Domain name too long (max {MAX_DOMAIN_LEN} characters)", value
    return True, None, normalized


def validate_image_path(path: str) -> Tuple[bool, Optional[str], Optional[Path]]:
    try:
        image_path = Path(path)
    except Exception as exc:
        return False, f"Invalid path: {exc}", None
    if not image_path.exists():
        return False, f"File not found: {path}", None
    if not image_path.is_file():
        return False, f"Not a file: {path}", None
    ext = image_path.suffix.lower().lstrip(".")
    if ext not in config.allowed_extensions_list:
        return False, f"Invalid file type: {ext}", None
    size_mb = image_path.stat().st_size / (1024 * 1024)
    if size_mb > config.max_file_size_mb:
        return False, f"File too large: {size_mb:.1f}MB (max: {config.max_file_size_mb}MB)", None
    if size_mb == 0:
        return False, "File is empty", None
    return True, None, image_path


def validate_user_notes(value: Optional[str]) -> Tuple[bool, Optional[str], Optional[str]]:
    if not value:
        return True, None, None
    sanitized = value.strip()
    if len(sanitized) > MAX_NOTES_LEN:
        return False, f"Notes too long (max {MAX_NOTES_LEN} characters)", value
    return True, None, sanitized


def validate_request_id(value: Optional[str]) -> str:
    """Sanitize a caller-provided request ID or mint a fresh short UUID."""
    if value and len(value) >= 8:
        sanitized = re.sub(r"[^a-zA-Z0-9-]", "", value)
        if len(sanitized) >= 8:
            return sanitized[:MAX_REQUEST_ID_LEN]
    return str(uuid.uuid4())[:8]


def sanitize_filename(filename: str) -> str:
    """Strip path components and shell-dangerous characters; cap length."""
    filename = Path(filename).name
    # Control bytes (NUL, newline, ...) beyond the reference's character
    # class: an embedded NUL in a crafted multipart filename crashes
    # Path.write_bytes with an unhandled ValueError instead of failing
    # validation cleanly.
    cleaned = re.sub(r'[<>:"/\\|?*\x00-\x1f\x7f]', "_", filename)
    stem = Path(cleaned).stem[:50]
    suffix = Path(cleaned).suffix[:10]
    return f"{stem}{suffix}"


def validate_inspection_context(
    image_path: str,
    criticality: str,
    domain: Optional[str] = None,
    user_notes: Optional[str] = None,
) -> Tuple[bool, List[str], Dict[str, Optional[str]]]:
    """Validate a full inspection request; collects all errors at once."""
    errors: List[str] = []
    context: Dict[str, Optional[str]] = {}

    ok, err, path = validate_image_path(image_path)
    if not ok:
        errors.append(f"Image: {err}")
    else:
        context["image_path"] = str(path)

    ok, err, crit = validate_criticality(criticality)
    if not ok:
        errors.append(f"Criticality: {err}")
    else:
        context["criticality"] = crit

    ok, err, dom = validate_domain(domain)
    if not ok:
        errors.append(f"Domain: {err}")
    else:
        context["domain"] = dom

    ok, err, notes = validate_user_notes(user_notes)
    if not ok:
        errors.append(f"Notes: {err}")
    else:
        context["user_notes"] = notes

    return not errors, errors, context


__all__ = [
    "validate_criticality",
    "validate_domain",
    "validate_image_path",
    "validate_user_notes",
    "validate_request_id",
    "sanitize_filename",
    "validate_inspection_context",
]
