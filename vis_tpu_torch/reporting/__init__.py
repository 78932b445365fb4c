from vis_tpu_torch.reporting.pdf import PDFDocument, string_width, wrap_text
from vis_tpu_torch.reporting.report import (
    InspectionReport,
    format_agreement_score,
    generate_report,
    parse_explanation_sections,
)

__all__ = [
    "PDFDocument",
    "string_width",
    "wrap_text",
    "InspectionReport",
    "generate_report",
    "parse_explanation_sections",
    "format_agreement_score",
]
