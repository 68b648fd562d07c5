"""Minimal dependency-free .xlsx reader and writer (``edrl_tpu/data/xlsx.py``, copied).

The reference's label schema lives in Excel files (``train_true.xlsx``,
``train_839.xlsx`` — ``code/data_harvard.py:645``, ``fusion_train.py:581``);
pandas reads them only through openpyxl, and the port needs neither.  An
xlsx file is a zip of XML — this reads the first worksheet plus the
shared-strings table, which is all the label files need.
"""

from __future__ import annotations

import re
import zipfile
from typing import Dict, List, Optional
from xml.etree import ElementTree

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}


def _col_index(cell_ref: str) -> int:
    """'B12' -> 1 (zero-based column index)."""
    letters = re.match(r"[A-Z]+", cell_ref).group(0)
    idx = 0
    for ch in letters:
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def read_xlsx_rows(path: str) -> List[List[Optional[str]]]:
    """Rows of the first worksheet as strings (None for empty cells)."""
    with zipfile.ZipFile(path) as zf:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in zf.namelist():
            root = ElementTree.fromstring(zf.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", _NS):
                shared.append("".join(t.text or "" for t in si.iter(f"{{{_NS['m']}}}t")))
        # Numeric sort: lexicographic order puts sheet10.xml before
        # sheet2.xml, so "first worksheet" would be wrong for 10+ sheets.
        sheet_names = sorted(
            (
                n
                for n in zf.namelist()
                if re.match(r"xl/worksheets/sheet\d+\.xml", n)
            ),
            key=lambda n: int(re.search(r"sheet(\d+)\.xml", n).group(1)),
        )
        root = ElementTree.fromstring(zf.read(sheet_names[0]))
        rows: List[List[Optional[str]]] = []
        for row in root.iter(f"{{{_NS['m']}}}row"):
            values: List[Optional[str]] = []
            for cell in row.findall("m:c", _NS):
                col = _col_index(cell.get("r", "A1"))
                while len(values) < col:
                    values.append(None)
                ctype = cell.get("t")
                if ctype == "inlineStr":
                    is_el = cell.find("m:is", _NS)
                    if is_el is None:
                        values.append(None)
                    else:
                        values.append(
                            "".join(
                                t.text or "" for t in is_el.iter(f"{{{_NS['m']}}}t")
                            )
                        )
                    continue
                v = cell.find("m:v", _NS)
                if v is None or v.text is None:
                    values.append(None)
                elif ctype == "s":  # shared string
                    values.append(shared[int(v.text)])
                else:
                    values.append(v.text)
            rows.append(values)
        return rows


def read_xlsx_dict(path: str) -> Dict[str, List[Optional[str]]]:
    """{column_name: values} using the first row as the header."""
    rows = read_xlsx_rows(path)
    if not rows:
        return {}
    header = rows[0]
    n = len(header)
    out: Dict[str, List[Optional[str]]] = {str(h): [] for h in header}
    for row in rows[1:]:
        padded = list(row) + [None] * (n - len(row))
        for h, v in zip(header, padded):
            out[str(h)].append(v)
    return out


def write_xlsx(path: str, header: List[str], rows: List[List]) -> None:
    """Write a minimal single-sheet xlsx (inline strings / numbers).

    Used for fixtures and label-file export; mirrors the cell layout of the
    reference's ``train_true.xlsx``.
    """

    def cell(ref: str, value) -> str:
        if isinstance(value, (int, float)):
            return f'<c r="{ref}" t="n"><v>{value}</v></c>'
        return f'<c r="{ref}" t="inlineStr"><is><t>{value}</t></is></c>'

    def col_letter(idx: int) -> str:
        letters = ""
        idx += 1
        while idx:
            idx, rem = divmod(idx - 1, 26)
            letters = chr(ord("A") + rem) + letters
        return letters

    body = []
    for r, row in enumerate([header] + rows, start=1):
        cells = "".join(
            cell(f"{col_letter(c)}{r}", v) for c, v in enumerate(row) if v is not None
        )
        body.append(f'<row r="{r}">{cells}</row>')
    sheet = (
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f"<sheetData>{''.join(body)}</sheetData></worksheet>"
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
        "</Types>"
    )
    rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
        "</Relationships>"
    )
    wb = (
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        '<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>'
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>'
        "</Relationships>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", content_types)
        zf.writestr("_rels/.rels", rels)
        zf.writestr("xl/workbook.xml", wb)
        zf.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        zf.writestr("xl/worksheets/sheet1.xml", sheet)
