"""Minimal from-scratch PDF writer.

The reference used reportlab (reference: src/reporting/pdf_generator.py);
that package is not available here, so this module implements the subset of
PDF 1.4 the inspection report needs directly: multi-page documents, the
standard Helvetica font family with real AFM metrics for accurate word-wrap,
vector fills/strokes, and baseline-JPEG image XObjects (DCTDecode).

Coordinate system: PDF-native, origin bottom-left, points (1/72 inch).
The higher-level report layout lives in vis_tpu_torch.reporting.report.
"""

from __future__ import annotations

import io
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from PIL import Image

LETTER = (612.0, 792.0)  # 8.5 x 11 inches in points

# AFM widths (units per 1000 em) for ASCII 32..126.
_HELV_WIDTHS = [
    278, 278, 355, 556, 556, 889, 667, 191, 333, 333, 389, 584, 278, 333, 278,
    278, 556, 556, 556, 556, 556, 556, 556, 556, 556, 556, 278, 278, 584, 584,
    584, 556, 1015, 667, 667, 722, 722, 667, 611, 778, 722, 278, 500, 667,
    556, 833, 722, 778, 667, 778, 722, 667, 611, 722, 667, 944, 667, 667, 611,
    278, 278, 278, 469, 556, 333, 556, 556, 500, 556, 556, 278, 556, 556, 222,
    222, 500, 222, 833, 556, 556, 556, 556, 333, 500, 278, 556, 500, 722, 500,
    500, 500, 334, 260, 334, 584,
]
_HELV_BOLD_WIDTHS = [
    278, 333, 474, 556, 556, 889, 722, 238, 333, 333, 389, 584, 278, 333, 278,
    278, 556, 556, 556, 556, 556, 556, 556, 556, 556, 556, 333, 333, 584, 584,
    584, 611, 975, 722, 722, 722, 722, 667, 611, 778, 722, 278, 556, 722, 611,
    833, 722, 778, 667, 778, 722, 667, 611, 722, 667, 944, 667, 667, 611, 333,
    278, 333, 584, 556, 333, 556, 611, 556, 611, 556, 333, 611, 611, 278, 278,
    556, 278, 889, 611, 611, 611, 611, 389, 556, 333, 611, 556, 778, 556, 556,
    500, 389, 280, 389, 584,
]

FONTS = {
    "Helvetica": _HELV_WIDTHS,
    "Helvetica-Bold": _HELV_BOLD_WIDTHS,
    "Helvetica-Oblique": _HELV_WIDTHS,
    "Helvetica-BoldOblique": _HELV_BOLD_WIDTHS,
}


# Common model-output unicode that base-14 latin-1 fonts cannot encode,
# mapped to visual equivalents instead of '?' artifacts.  Applied both when
# rendering (_escape) and when measuring (string_width) so centered text and
# wrap budgets match what actually prints.
_TRANSLIT_TABLE = {
    0x2010: "-", 0x2011: "-", 0x2012: "-", 0x2013: "-", 0x2014: "--",
    0x2015: "--", 0x2212: "-",
    0x2018: "'", 0x2019: "'", 0x201A: "'", 0x2032: "'",
    0x201C: '"', 0x201D: '"', 0x201E: '"', 0x2033: '"',
    0x2022: "\xb7", 0x25CF: "\xb7", 0x25E6: "\xb7",
    0x2026: "...",
    0x2190: "<-", 0x2192: "->",
    0x2264: "<=", 0x2265: ">=", 0x2260: "!=", 0x2248: "~",
    0x00A0: " ", 0x202F: " ", 0x2009: " ",
    0x03BC: "\xb5",
    0x2713: "*", 0x2714: "*", 0x2717: "x", 0x2718: "x",
}


def _transliterate(text: str) -> str:
    return text.translate(_TRANSLIT_TABLE)


def string_width(text: str, font: str = "Helvetica", size: float = 10.0) -> float:
    """Width of `text` in points using AFM metrics (non-ASCII ≈ 600/1000 em),
    measured AFTER the same transliteration the renderer applies."""
    widths = FONTS.get(font, _HELV_WIDTHS)
    total = 0
    for ch in _transliterate(text):
        code = ord(ch)
        if 32 <= code <= 126:
            total += widths[code - 32]
        else:
            total += 600
    return total * size / 1000.0


def wrap_text(
    text: str, max_width: float, font: str = "Helvetica", size: float = 10.0
) -> List[str]:
    """Greedy word wrap honoring explicit newlines; long words are split."""
    lines: List[str] = []
    for paragraph in text.split("\n"):
        if not paragraph.strip():
            lines.append("")
            continue
        current = ""
        for word in paragraph.split():
            candidate = f"{current} {word}".strip()
            if string_width(candidate, font, size) <= max_width:
                current = candidate
                continue
            if current:
                lines.append(current)
            # Word alone exceeds the line: hard-split it.
            while string_width(word, font, size) > max_width and len(word) > 1:
                cut = len(word)
                while cut > 1 and string_width(word[:cut], font, size) > max_width:
                    cut -= 1
                lines.append(word[:cut])
                word = word[cut:]
            current = word
        lines.append(current)
    while lines and not lines[-1]:
        lines.pop()
    return lines


def _escape(text: str) -> str:
    out = _transliterate(text)
    out = out.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
    # Strip whatever non-latin1 remains (base-14 fonts are WinAnsi-ish).
    return out.encode("latin-1", errors="replace").decode("latin-1")


class PDFPage:
    """Accumulates content-stream operators for one page."""

    def __init__(self, width: float, height: float):
        self.width = width
        self.height = height
        self.ops: List[str] = []
        self.fonts_used: set = set()
        self.images_used: set = set()

    # -- graphics -------------------------------------------------------
    def set_fill(self, r: float, g: float, b: float) -> None:
        self.ops.append(f"{r:.3f} {g:.3f} {b:.3f} rg")

    def set_stroke(self, r: float, g: float, b: float) -> None:
        self.ops.append(f"{r:.3f} {g:.3f} {b:.3f} RG")

    def set_line_width(self, w: float) -> None:
        self.ops.append(f"{w:.2f} w")

    def rect(self, x: float, y: float, w: float, h: float,
             fill: bool = True, stroke: bool = False) -> None:
        op = "B" if (fill and stroke) else ("f" if fill else "S")
        self.ops.append(f"{x:.2f} {y:.2f} {w:.2f} {h:.2f} re {op}")

    def line(self, x0: float, y0: float, x1: float, y1: float) -> None:
        self.ops.append(f"{x0:.2f} {y0:.2f} m {x1:.2f} {y1:.2f} l S")

    def dashed(self, on: float = 3, off: float = 3) -> None:
        self.ops.append(f"[{on} {off}] 0 d")

    def solid(self) -> None:
        self.ops.append("[] 0 d")

    # -- text -----------------------------------------------------------
    def text(self, x: float, y: float, content: str,
             font: str = "Helvetica", size: float = 10.0,
             color: Optional[Tuple[float, float, float]] = None) -> None:
        self.fonts_used.add(font)
        if color is not None:
            self.set_fill(*color)
        self.ops.append(
            f"BT /{font} {size:.1f} Tf {x:.2f} {y:.2f} Td ({_escape(content)}) Tj ET"
        )

    # -- images ---------------------------------------------------------
    def image(self, name: str, x: float, y: float, w: float, h: float) -> None:
        self.images_used.add(name)
        self.ops.append(f"q {w:.2f} 0 0 {h:.2f} {x:.2f} {y:.2f} cm /{name} Do Q")

    def content(self) -> bytes:
        return "\n".join(self.ops).encode("latin-1")


class PDFDocument:
    """Assembles pages + resources into a valid PDF byte stream."""

    def __init__(self, page_size: Tuple[float, float] = LETTER):
        self.page_size = page_size
        self.pages: List[PDFPage] = []
        self.images: Dict[str, Tuple[bytes, int, int]] = {}  # name -> (jpeg, w, h)

    def new_page(self) -> PDFPage:
        page = PDFPage(*self.page_size)
        self.pages.append(page)
        return page

    def add_image(self, name: str, source) -> Tuple[int, int]:
        """Register an image (path / PIL.Image / numpy array) as a JPEG
        XObject; returns (width, height) in pixels."""
        if isinstance(source, (str, Path)):
            img = Image.open(source)
        elif isinstance(source, Image.Image):
            img = source
        else:  # numpy array
            img = Image.fromarray(source)
        img = img.convert("RGB")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=85)
        self.images[name] = (buf.getvalue(), img.width, img.height)
        return img.width, img.height

    # -- serialization --------------------------------------------------
    def render(self) -> bytes:
        objects: List[bytes] = []  # 1-indexed

        def add_object(body: bytes) -> int:
            objects.append(body)
            return len(objects)

        font_ids: Dict[str, int] = {}
        for font in FONTS:
            font_ids[font] = add_object(
                f"<< /Type /Font /Subtype /Type1 /BaseFont /{font} "
                f"/Encoding /WinAnsiEncoding >>".encode()
            )

        image_ids: Dict[str, int] = {}
        for name, (jpeg, w, h) in self.images.items():
            image_ids[name] = add_object(
                (
                    f"<< /Type /XObject /Subtype /Image /Width {w} /Height {h} "
                    f"/ColorSpace /DeviceRGB /BitsPerComponent 8 "
                    f"/Filter /DCTDecode /Length {len(jpeg)} >>\nstream\n"
                ).encode()
                + jpeg
                + b"\nendstream"
            )

        page_obj_ids: List[int] = []
        pages_id_placeholder = len(objects) + 2 * len(self.pages) + 1
        for page in self.pages:
            raw = page.content()
            compressed = zlib.compress(raw)
            content_id = add_object(
                (
                    f"<< /Length {len(compressed)} /Filter /FlateDecode >>\nstream\n"
                ).encode()
                + compressed
                + b"\nendstream"
            )
            font_res = " ".join(
                f"/{f} {font_ids[f]} 0 R" for f in sorted(page.fonts_used)
            )
            img_res = " ".join(
                f"/{n} {image_ids[n]} 0 R" for n in sorted(page.images_used)
            )
            resources = f"<< /Font << {font_res} >>"
            if img_res:
                resources += f" /XObject << {img_res} >>"
            resources += " >>"
            page_obj_ids.append(
                add_object(
                    (
                        f"<< /Type /Page /Parent {pages_id_placeholder} 0 R "
                        f"/MediaBox [0 0 {page.width:.0f} {page.height:.0f}] "
                        f"/Resources {resources} /Contents {content_id} 0 R >>"
                    ).encode()
                )
            )

        kids = " ".join(f"{pid} 0 R" for pid in page_obj_ids)
        pages_id = add_object(
            f"<< /Type /Pages /Kids [{kids}] /Count {len(page_obj_ids)} >>".encode()
        )
        assert pages_id == pages_id_placeholder, "page tree id drifted"
        catalog_id = add_object(
            f"<< /Type /Catalog /Pages {pages_id} 0 R >>".encode()
        )

        out = io.BytesIO()
        out.write(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0]
        for i, body in enumerate(objects, start=1):
            offsets.append(out.tell())
            out.write(f"{i} 0 obj\n".encode())
            out.write(body)
            out.write(b"\nendobj\n")
        xref_pos = out.tell()
        out.write(f"xref\n0 {len(objects) + 1}\n".encode())
        out.write(b"0000000000 65535 f \n")
        for off in offsets[1:]:
            out.write(f"{off:010d} 00000 n \n".encode())
        out.write(
            (
                f"trailer\n<< /Size {len(objects) + 1} /Root {catalog_id} 0 R >>\n"
                f"startxref\n{xref_pos}\n%%EOF\n"
            ).encode()
        )
        return out.getvalue()

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(self.render())
        return path


__all__ = ["PDFDocument", "PDFPage", "LETTER", "string_width", "wrap_text"]
