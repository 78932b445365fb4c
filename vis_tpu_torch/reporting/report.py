"""Branded inspection PDF report built on the from-scratch PDF writer.

Mirrors the reference report structure (reference: src/reporting/
pdf_generator.py:450-1669): header/footer branding, verdict status stamp,
executive summary, inspection metadata, 3-panel visual evidence
(original / heatmap / annotated), defect tables, decision support,
model comparison, and the full all-gates audit trail.  Also provides
parse_explanation_sections(), consumed by both the report and the UI
(reference pdf_generator.py:53-276, imported by app/ui.py:165).
"""

from __future__ import annotations

import re
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from vis_tpu_torch.reporting.pdf import LETTER, PDFDocument, string_width, wrap_text
from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__, level="INFO", component="REPORTING")

# Section-name normalization used across all parsing strategies.  The first
# four entries are the system's OWN explainer headers (utils/prompts.py
# EXPLAINER_PROMPT emits EXECUTIVE SUMMARY / INSPECTION DETAILS / DEFECT
# ANALYSIS / FINAL RECOMMENDATION) — without them every in-house report
# collapsed into SUMMARY and the PDF rendered the explanation twice.
# Order matters: specific names before the generic "summary" catch-all.
_SECTION_PATTERNS: List[Tuple[str, List[str]]] = [
    ("EXECUTIVE SUMMARY", ["executive summary"]),
    ("INSPECTION DETAILS", ["inspection details"]),
    ("DEFECT ANALYSIS", ["defect analysis"]),
    ("FINAL RECOMMENDATION", ["final recommendation"]),
    ("REASONING CHAINS", ["reasoning chains", "reasoning chain"]),
    ("INSPECTOR ANALYSIS", ["inspector analysis", "inspector:"]),
    ("AUDITOR VERIFICATION", ["auditor verification", "auditor:"]),
    ("COUNTERFACTUAL", ["counterfactual analysis", "counterfactual"]),
    ("KEY TAKEAWAYS", ["key takeaways", "key findings", "highlights"]),
    ("RECOMMENDATIONS", ["recommendations", "recommended actions", "next steps",
                          "action items"]),
    ("SUMMARY", ["summary", "inspection findings", "verdict", "overview"]),
]

_KEYWORD_SECTIONS: Dict[str, List[str]] = {
    "EXECUTIVE SUMMARY": ["executive summary", "summary", "overview",
                           "inspection summary"],
    "INSPECTION DETAILS": ["inspection details"],
    "DEFECT ANALYSIS": ["defect analysis", "defect details"],
    "KEY TAKEAWAYS": ["key takeaways", "key findings", "highlights",
                       "main points", "takeaways"],
    "RECOMMENDATIONS": ["recommendations", "recommended actions", "next steps",
                         "action items", "action required", "suggested actions"],
    "FINAL RECOMMENDATION": ["final recommendation", "recommendation", "verdict",
                              "conclusion", "final verdict"],
    "REASONING CHAINS": ["reasoning chains", "reasoning", "analysis reasoning",
                          "thought process"],
    "INSPECTOR ANALYSIS": ["inspector analysis", "inspector:",
                            "inspector findings", "primary analysis"],
    "AUDITOR VERIFICATION": ["auditor verification", "auditor:",
                              "auditor findings", "verification"],
    "COUNTERFACTUAL": ["counterfactual", "what if", "alternative scenario",
                        "counterfactual analysis"],
}

_MARKER_RE = re.compile(r"(?:^|\n+)---+\n+##\s*([A-Z\s]+)\n+", re.MULTILINE)


def _strip_md(text: str) -> str:
    return text.replace("**", "").replace("##", "").replace("#", "")


def _is_header_line(line_lower: str, keyword: str) -> bool:
    """A line is a section header only when the keyword accounts for nearly
    the whole line — 'FINAL RECOMMENDATION' is a header, but a content line
    like 'Verdict: SAFE' (which merely contains the keyword 'verdict') is
    not.  This fixes the reference parser's loss of key-value lines that
    happened to contain section keywords (reference pdf_generator.py:221-233)."""
    idx = line_lower.find(keyword)
    if idx == -1:
        return False
    remainder = (line_lower[:idx] + line_lower[idx + len(keyword):])
    remainder = remainder.strip(" :-#*\t")
    return len(remainder) <= 2


def parse_explanation_sections(explanation: str) -> Dict[str, str]:
    """Split explainer output into named sections.

    Three cooperating strategies (reference pdf_generator.py:53-276):
      1. explicit `---` + `## HEADER` markers,
      2. line-by-line header pattern matching,
      3. aggressive keyword extraction (always runs; longer content wins).
    A SUMMARY is synthesized from leading sentences if nothing matched.
    """
    if not explanation:
        return {"SUMMARY": "Explanation not available - workflow may have been interrupted."}

    sections: Dict[str, str] = {}
    text = explanation.strip()

    markers = list(_MARKER_RE.finditer(text))
    if markers:
        lead = text[: markers[0].start()].strip()
        if lead:
            sections["SUMMARY"] = _strip_md(lead)
        for i, match in enumerate(markers):
            header = match.group(1).strip()
            start = match.end()
            end = markers[i + 1].start() if i + 1 < len(markers) else len(text)
            content = _strip_md(text[start:end].strip())
            name = header
            for sname, patterns in _SECTION_PATTERNS:
                if any(p in header.lower() for p in patterns):
                    name = sname
                    break
            if content:
                sections[name] = content
    else:
        current = "SUMMARY"
        buffer: List[str] = []

        def flush() -> None:
            if buffer:
                content = _strip_md("\n".join(buffer).strip())
                if content:
                    sections[current] = content

        for line in text.split("\n"):
            stripped = line.strip()
            if not stripped:
                if buffer:
                    buffer.append("")
                continue
            # Match BEFORE stripping colons: patterns like "inspector:" can
            # only ever match the raw line (the _is_header_line remainder
            # strip tolerates a trailing colon on plain headers).
            clean = _strip_md(stripped).strip()
            lower = clean.lower()
            matched = None
            for sname, patterns in _SECTION_PATTERNS:
                if len(clean) < 80 and any(
                    lower.startswith(p) and _is_header_line(lower, p)
                    for p in patterns
                ):
                    matched = sname
                    break
            if matched:
                flush()
                current = matched
                buffer = []
            else:
                buffer.append(_strip_md(stripped))
        flush()

    # Strategy 3: keyword sweep — supplements and upgrades sparse sections.
    keyword_sections: Dict[str, str] = {}
    current: Optional[str] = None
    buffer = []
    for line in text.split("\n"):
        lower = line.lower().strip()
        matched = None
        for sname, keywords in _KEYWORD_SECTIONS.items():
            if len(lower) < 100 and any(
                _is_header_line(lower, kw) for kw in keywords
            ):
                matched = sname
                break
        if matched:
            if current and buffer:
                content = _strip_md("\n".join(buffer).strip())
                if content:
                    keyword_sections[current] = content
            current = matched
            buffer = []
        elif current:
            if line.strip():
                buffer.append(_strip_md(line.strip()))
        elif line.strip() and not lower.startswith(("---", "##")):
            current = "SUMMARY"
            buffer.append(_strip_md(line.strip()))
    if current and buffer:
        content = _strip_md("\n".join(buffer).strip())
        if content:
            keyword_sections[current] = content

    for name, content in keyword_sections.items():
        if name not in sections or len(content) > len(sections.get(name, "")):
            sections[name] = content

    # Synthesize a SUMMARY from leading sentences only when NO summary-like
    # section was parsed — duplicating an EXECUTIVE SUMMARY would render the
    # same explanation twice in the PDF.
    if not sections or not ("SUMMARY" in sections
                            or "EXECUTIVE SUMMARY" in sections):
        sentences = explanation.split(".")
        summary = ". ".join(sentences[:5]).strip() or explanation[:500]
        sections["SUMMARY"] = _strip_md(summary)

    return sections


def format_agreement_score(score: float) -> str:
    """Percentage formatting avoiding 99.99999% artifacts
    (reference pdf_generator.py:280)."""
    if score >= 0.9999:
        return "100.0%"
    if score <= 0.0001:
        return "0.0%"
    return f"{score * 100:.1f}%"


def get_short_model_name(model_id: str) -> str:
    return model_id.split("/")[-1].replace("-Instruct", "").replace("-instruct", "")


# ---------------------------------------------------------------------------
# Layout engine
# ---------------------------------------------------------------------------

_MARGIN = 54.0
_HEADER_H = 40.0
_FOOTER_H = 32.0
_BRAND = (0.10, 0.22, 0.42)  # deep blue
_LIGHT = (0.93, 0.95, 0.98)
_GRAY = (0.45, 0.45, 0.45)
_VERDICT_RGB = {
    "SAFE": (0.09, 0.64, 0.29),
    "UNSAFE": (0.86, 0.15, 0.15),
    "REQUIRES_HUMAN_REVIEW": (0.96, 0.62, 0.04),
}


class _Layout:
    """Top-down flowing cursor over PDFDocument pages with branded chrome."""

    def __init__(self, doc: PDFDocument, title: str, request_id: str):
        self.doc = doc
        self.title = title
        self.request_id = request_id
        self.page = None
        self.y = 0.0
        self._image_count = 0
        self.new_page()

    @property
    def width(self) -> float:
        return LETTER[0] - 2 * _MARGIN

    def new_page(self) -> None:
        self.page = self.doc.new_page()
        w, h = LETTER
        # Header band
        self.page.set_fill(*_BRAND)
        self.page.rect(0, h - _HEADER_H, w, _HEADER_H)
        self.page.text(_MARGIN, h - 26, self.title, "Helvetica-Bold", 13,
                       color=(1, 1, 1))
        stamp = time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime())
        self.page.text(
            w - _MARGIN - string_width(stamp, "Helvetica", 8), h - 24,
            stamp, "Helvetica", 8, color=(0.85, 0.88, 0.95),
        )
        # Footer
        self.page.set_fill(*_GRAY)
        footer = f"Vision Inspection Report - {self.request_id}"
        self.page.text(_MARGIN, 18, footer, "Helvetica", 8, color=_GRAY)
        page_no = f"Page {len(self.doc.pages)}"
        self.page.text(
            w - _MARGIN - string_width(page_no, "Helvetica", 8), 18,
            page_no, "Helvetica", 8, color=_GRAY,
        )
        self.page.set_stroke(*_GRAY)
        self.page.set_line_width(0.5)
        self.page.line(_MARGIN, 30, w - _MARGIN, 30)
        self.y = h - _HEADER_H - 24

    def need(self, height: float) -> None:
        if self.y - height < _FOOTER_H + 12:
            self.new_page()

    def spacer(self, h: float = 10.0) -> None:
        self.y -= h

    def heading(self, text: str, size: float = 12.0) -> None:
        self.need(size + 16)
        self.page.text(_MARGIN, self.y - size, text, "Helvetica-Bold", size,
                       color=_BRAND)
        self.y -= size + 4
        self.page.set_stroke(*_BRAND)
        self.page.set_line_width(1.0)
        self.page.line(_MARGIN, self.y, _MARGIN + self.width, self.y)
        self.y -= 8

    def paragraph(self, text: str, size: float = 9.5,
                  font: str = "Helvetica",
                  color: Tuple[float, float, float] = (0.1, 0.1, 0.1)) -> None:
        leading = size * 1.35
        for line in wrap_text(text, self.width, font, size):
            self.need(leading)
            if line:
                self.page.text(_MARGIN, self.y - size, line, font, size, color=color)
            self.y -= leading
        self.y -= 2

    def key_values(self, rows: List[Tuple[str, str]], label_w: float = 160.0) -> None:
        size = 9.5
        leading = size * 1.5
        for label, value in rows:
            wrapped = wrap_text(str(value), self.width - label_w, "Helvetica", size)
            block_h = max(1, len(wrapped)) * leading
            self.need(block_h)
            self.page.text(_MARGIN, self.y - size, label, "Helvetica-Bold", size,
                           color=(0.2, 0.2, 0.2))
            for i, line in enumerate(wrapped or [""]):
                self.page.text(_MARGIN + label_w, self.y - size - i * leading,
                               line, "Helvetica", size, color=(0.1, 0.1, 0.1))
            self.y -= block_h + 2

    def table(self, headers: List[str], rows: List[List[str]],
              col_fracs: Optional[List[float]] = None, size: float = 8.5) -> None:
        if col_fracs is None:
            col_fracs = [1.0 / len(headers)] * len(headers)
        widths = [f * self.width for f in col_fracs]
        leading = size * 1.4
        pad = 4.0

        def render_row(cells: List[str], bold: bool, shade: bool) -> None:
            font = "Helvetica-Bold" if bold else "Helvetica"
            wrapped = [
                wrap_text(str(c), widths[i] - 2 * pad, font, size)
                for i, c in enumerate(cells)
            ]
            height = max(len(wv) or 1 for wv in wrapped) * leading + 2 * pad
            self.need(height)
            if shade or bold:
                self.page.set_fill(*( _BRAND if bold else _LIGHT))
                self.page.rect(_MARGIN, self.y - height, self.width, height)
            x = _MARGIN
            text_color = (1, 1, 1) if bold else (0.1, 0.1, 0.1)
            for i, lines in enumerate(wrapped):
                for j, line in enumerate(lines or [""]):
                    self.page.text(x + pad, self.y - pad - size - j * leading,
                                   line, font, size, color=text_color)
                x += widths[i]
            self.y -= height

        render_row(headers, bold=True, shade=False)
        for r_idx, row in enumerate(rows):
            render_row([str(c) for c in row], bold=False, shade=r_idx % 2 == 1)
        self.y -= 6

    def verdict_banner(self, verdict: str, confidence: str) -> None:
        color = _VERDICT_RGB.get(verdict, _GRAY)
        height = 44.0
        self.need(height + 8)
        self.page.set_fill(*color)
        self.page.rect(_MARGIN, self.y - height, self.width, height)
        label = verdict.replace("_", " ")
        self.page.text(
            _MARGIN + (self.width - string_width(label, "Helvetica-Bold", 20)) / 2,
            self.y - height / 2 - 7, label, "Helvetica-Bold", 20, color=(1, 1, 1),
        )
        sub = f"confidence: {confidence}"
        self.page.text(
            _MARGIN + (self.width - string_width(sub, "Helvetica", 8)) / 2,
            self.y - height + 6, sub, "Helvetica", 8, color=(1, 1, 1),
        )
        self.y -= height + 10

    def stamp(self, verdict: str) -> None:
        """Rubber-stamp verdict badge anchored to the TOP-RIGHT of the
        current page, outside the text flow (reference
        pdf_generator.py:303 wires its StatusStamp flowable the same way).
        Rendered by utils.image_utils.create_status_stamp and composited
        on white (the PDF stream embeds JPEGs, which have no alpha)."""
        from PIL import Image as _PILImage

        from vis_tpu_torch.utils.image_utils import create_status_stamp

        badge = create_status_stamp(verdict)
        white = _PILImage.new("RGBA", badge.size, (255, 255, 255, 255))
        rgb = _PILImage.alpha_composite(white, badge).convert("RGB")
        self._image_count += 1
        name = f"Im{self._image_count}"
        try:
            px_w, px_h = self.doc.add_image(name, rgb)
        except Exception as exc:
            logger.warning(f"Could not embed verdict stamp: {exc}")
            return
        # Sized to the 18-pt title line it sits beside (90 x ~27 pts): the
        # badge fills the unused right half of the title row and ends
        # before the full-width verdict banner below it.
        w = 90.0
        h = w * px_h / px_w
        self.page.image(name, _MARGIN + self.width - w, self.y - h, w, h)

    def image(self, source, caption: str, max_h: float = 200.0) -> None:
        self._image_count += 1
        name = f"Im{self._image_count}"
        try:
            px_w, px_h = self.doc.add_image(name, source)
        except Exception as exc:
            logger.warning(f"Could not embed image in report: {exc}")
            return
        scale = min(self.width / px_w, max_h / px_h, 1.0)
        w, h = px_w * scale, px_h * scale
        self.need(h + 20)
        x = _MARGIN + (self.width - w) / 2
        self.page.image(name, x, self.y - h, w, h)
        self.y -= h + 4
        self.page.text(
            _MARGIN + (self.width - string_width(caption, "Helvetica-Oblique", 8)) / 2,
            self.y - 8, caption, "Helvetica-Oblique", 8, color=_GRAY,
        )
        self.y -= 16

    def image_row(self, items: List[Tuple[Any, str]], max_h: float = 150.0) -> None:
        """Several images side by side with captions."""
        if not items:
            return
        gap = 10.0
        cell_w = (self.width - gap * (len(items) - 1)) / len(items)
        rendered = []
        row_h = 0.0
        for source, caption in items:
            self._image_count += 1
            name = f"Im{self._image_count}"
            try:
                px_w, px_h = self.doc.add_image(name, source)
            except Exception as exc:
                logger.warning(f"Could not embed image: {exc}")
                continue
            scale = min(cell_w / px_w, max_h / px_h, 1.0)
            rendered.append((name, px_w * scale, px_h * scale, caption))
            row_h = max(row_h, px_h * scale)
        if not rendered:
            return
        self.need(row_h + 24)
        x = _MARGIN
        for name, w, h, caption in rendered:
            self.page.image(name, x + (cell_w - w) / 2, self.y - row_h + (row_h - h), w, h)
            self.page.text(
                x + (cell_w - string_width(caption, "Helvetica-Oblique", 7)) / 2,
                self.y - row_h - 10, caption, "Helvetica-Oblique", 7, color=_GRAY,
            )
            x += cell_w + gap
        self.y -= row_h + 22


class InspectionReport:
    """Builds the full PDF for one inspection state
    (reference pdf_generator.py:450-1664)."""

    def __init__(self, state: Dict[str, Any]):
        self.state = state

    def generate(self, output_path: Optional[Path] = None) -> Path:
        state = self.state
        request_id = state.get("request_id", "unknown")
        verdict = state.get("safety_verdict") or {}
        consensus = state.get("consensus") or {}
        context = state.get("context") or {}
        inspector = state.get("inspector_result") or {}
        auditor = state.get("auditor_result") or {}
        defects = consensus.get("combined_defects", [])
        image_path = state.get("image_path")
        if isinstance(image_path, list):
            image_path = image_path[0] if image_path else None

        doc = PDFDocument()
        layout = _Layout(doc, config.app_title, request_id)

        # Title + verdict (stamp first: it anchors to the pre-title y so
        # the badge sits beside the heading, not over the banner).
        layout.spacer(4)
        layout.stamp(verdict.get("verdict", "UNKNOWN"))
        layout.paragraph("Automated Visual Inspection Report",
                         size=18, font="Helvetica-Bold", color=_BRAND)
        layout.verdict_banner(
            verdict.get("verdict", "UNKNOWN"),
            verdict.get("confidence_level", "unknown"),
        )

        # Metadata
        layout.heading("Inspection Details")
        quality = state.get("image_quality") or {}
        layout.key_values([
            ("Request ID", request_id),
            ("Image", Path(image_path).name if image_path else "n/a"),
            ("Criticality", str(context.get("criticality", "n/a"))
             + (" (upgraded from "
                f"{context.get('original_criticality')})"
                if context.get("criticality_upgraded") else "")),
            ("Domain", str(context.get("domain") or "general")),
            ("User notes", str(context.get("user_notes") or "none")),
            ("Agreement", format_agreement_score(consensus.get("agreement_score", 0.0))),
            ("Image quality", f"{quality.get('quality_score', 'n/a')} "
             f"({'passed' if quality.get('quality_passed') else 'below threshold'})"),
            ("Processing time", f"{state.get('processing_time', 0.0):.2f}s"
             if state.get("processing_time") else "n/a"),
        ])

        # Explanation sections
        sections = parse_explanation_sections(state.get("explanation") or "")
        order = ["EXECUTIVE SUMMARY", "SUMMARY", "INSPECTION DETAILS",
                 "DEFECT ANALYSIS", "INSPECTOR ANALYSIS",
                 "AUDITOR VERIFICATION", "REASONING CHAINS", "KEY TAKEAWAYS",
                 "RECOMMENDATIONS", "FINAL RECOMMENDATION", "COUNTERFACTUAL"]
        seen = set()
        for name in order + [k for k in sections if k not in order]:
            if name in sections and name not in seen:
                seen.add(name)
                layout.heading(name.title())
                layout.paragraph(sections[name])

        # Visual evidence
        if image_path and Path(image_path).exists():
            from vis_tpu_torch.utils.image_utils import (
                create_heatmap_overlay,
                draw_bounding_boxes,
                load_image,
            )

            layout.heading("Visual Evidence")
            try:
                original = load_image(image_path)
                heatmap = create_heatmap_overlay(image_path, defects)
                annotated = draw_bounding_boxes(image_path, defects)
                layout.image_row([
                    (original, "Original"),
                    (heatmap, "Defect heatmap"),
                    (annotated, "Annotated findings"),
                ])
            except Exception as exc:
                logger.warning(f"Visual evidence rendering failed: {exc}")

        # Defect table
        layout.heading(f"Defect Findings ({len(defects)})")
        if defects:
            rows = []
            for i, d in enumerate(defects, 1):
                bbox = d.get("bbox")
                loc = d.get("location", "")
                if bbox:
                    loc += (f" [x={bbox['x']:.0f}%, y={bbox['y']:.0f}%, "
                            f"{bbox['width']:.0f}x{bbox['height']:.0f}%]")
                rows.append([
                    str(i), d.get("type", ""), loc,
                    d.get("safety_impact", ""), d.get("confidence", ""),
                    d.get("recommended_action", ""),
                ])
            layout.table(
                ["#", "Type", "Location", "Severity", "Conf.", "Action"],
                rows,
                col_fracs=[0.05, 0.15, 0.30, 0.12, 0.08, 0.30],
            )
        else:
            layout.paragraph("No defects detected. Component appears in good condition.")

        # Decision support
        ds = state.get("decision_support") or {}
        if ds:
            layout.heading("Decision Support")
            layout.table(
                ["Option", "Cost", "Time"],
                [
                    ["Repair", ds.get("repair_cost", "N/A"), ds.get("repair_time", "N/A")],
                    ["Replace", ds.get("replace_cost", "N/A"), ds.get("replace_time", "N/A")],
                ],
                col_fracs=[0.3, 0.4, 0.3],
            )
            layout.key_values([
                ("Recommendation", ds.get("recommendation", "N/A")),
                ("Reasoning", ds.get("reasoning", "")),
            ])

        # Model comparison
        layout.heading("Model Comparison")
        layout.table(
            ["", "Inspector", "Auditor"],
            [
                ["Model", get_short_model_name(config.vlm_inspector_model),
                 get_short_model_name(config.vlm_auditor_model)],
                ["Condition", inspector.get("overall_condition", "n/a"),
                 auditor.get("overall_condition", "n/a")],
                ["Confidence", inspector.get("overall_confidence", "n/a"),
                 auditor.get("overall_confidence", "n/a")],
                ["Defects found", str(len(inspector.get("defects", []))),
                 str(len(auditor.get("defects", [])))],
            ],
            col_fracs=[0.24, 0.38, 0.38],
        )

        # Audit trail: every gate's pass/fail
        gates = (verdict.get("defect_summary") or {}).get("all_gate_results", [])
        if gates:
            layout.heading("Safety Gate Audit Trail")
            layout.table(
                ["Gate", "Result", "Detail"],
                [
                    [g.get("display_name", g.get("gate_id", "")),
                     "PASS" if g.get("passed") else "FAIL",
                     g.get("message", "")]
                    for g in gates
                ],
                col_fracs=[0.3, 0.1, 0.6],
            )
        if verdict.get("triggered_gates"):
            layout.key_values([
                ("Triggered gates", ", ".join(verdict["triggered_gates"])),
                ("Verdict reason", verdict.get("reason", "")),
            ])
        errors = state.get("failure_history") or []
        if errors:
            layout.heading("Errors Encountered")
            for err in errors:
                layout.paragraph(f"- {err}", color=(0.7, 0.1, 0.1))

        if output_path is None:
            output_path = config.get_report_dir() / f"inspection_{request_id}.pdf"
        return doc.save(output_path)


def generate_report(state: Dict[str, Any], output_path: Optional[Path] = None) -> Path:
    """Render the state to PDF and return its path
    (reference pdf_generator.py:1667)."""
    return InspectionReport(state).generate(output_path)


__all__ = [
    "InspectionReport",
    "generate_report",
    "parse_explanation_sections",
    "format_agreement_score",
    "get_short_model_name",
]
