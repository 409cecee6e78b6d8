"""Report generation: CSVs, run summaries, console summary.

Byte-compatible output schemas with the reference ``reporting.py``:
* ``cell_metrics.csv`` with fixed leading columns
  ``['condition', 'image_name', 'cell_id']`` (reference ``reporting.py:19-27``);
* ``processing_times.csv`` with leading
  ``['condition', 'image_name', 'cells_processed']`` (``:34-39``);
* ``run_summary.txt`` sections and ``print_summary`` console block
  (``:43-153``).

A copy of the JAX package's ``reporting.py`` (which the port may not
import), but for the CSV writer: the card's machine has no pandas, so the
``csv`` module writes the bytes ``DataFrame(rows).to_csv(index=False)`` gives,
and reads CSVs back typed as ``pandas.read_csv`` types them
(:func:`read_csv_rows`).
"""

from __future__ import annotations

import csv
import io
import math
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .pipeline.results import BatchProcessingResult


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _column_text(values: List[Any]) -> List[str]:
    """One column as pandas writes it when it builds the column from records:
    ints alone stay ints; numbers with a float or a gap among them become
    float64 (repr, ``5`` as ``5.0``); anything else is str; a missing value or
    a NaN is an empty field."""
    present = [v for v in values if not _missing(v)]
    numbers = all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present)
    if present and numbers:
        if len(present) == len(values) and all(isinstance(v, int) for v in present):
            return [str(v) for v in values]
        return ["" if _missing(v) else repr(float(v)) for v in values]
    return ["" if _missing(v) else str(v) for v in values]


def rows_csv_text(rows: List[Dict[str, Any]], fixed: Sequence[str] = (),
                  columns: Optional[Sequence[str]] = None) -> str:
    """``pandas.DataFrame(rows)`` with the ``fixed`` columns first, as
    ``to_csv(index=False)`` writes it: columns in order of first
    appearance, minimal quoting, a line feed ending each line. ``columns``
    names the frame's columns where ``rows`` is a subset of a larger frame's
    (an empty subset still writes its header)."""
    if columns is None:
        columns = dict.fromkeys(k for row in rows for k in row)
    columns = [c for c in fixed if c in columns] + [c for c in columns if c not in fixed]
    cells = [_column_text([row.get(c) for row in rows]) for c in columns]
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    writer.writerow(columns)
    writer.writerows(zip(*cells))
    return buf.getvalue()


def write_rows_csv(rows: List[Dict[str, Any]], fixed: Sequence[str], path: Path,
                   columns: Optional[Sequence[str]] = None) -> None:
    """:func:`rows_csv_text` written to ``path``."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        f.write(rows_csv_text(rows, fixed, columns))


_NA_TEXTS = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                       "nan", "null"})
_POW10 = [float(f"1e{k}") for k in range(309)]


def pandas_float(text: str) -> float:
    """A decimal as pandas' default C parser reads it (``precise_xstrtod``):
    up to 17 significant digits accumulated in a double, then one multiply or
    divide by a power of ten. It is not always the correctly rounded value
    that ``float()`` gives: a repr written by pandas can read back one ulp
    off, and the tools' outputs carry that value."""
    t = text.strip()
    low = t.lower()
    if low.lstrip("+-") in ("inf", "infinity"):
        return float(low)
    neg = t[:1] == "-"
    i = 1 if t[:1] in "+-" else 0
    number, exponent, digits = 0.0, 0, 0
    while i < len(t) and t[i].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(t[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < len(t) and t[i] == ".":
        i += 1
        decimals = 0
        while i < len(t) and t[i].isdigit():
            if digits < 17:
                number = number * 10.0 + (ord(t[i]) - 48)
                digits += 1
                decimals += 1
            i += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(f"not a number: {text!r}")
    if i < len(t) and t[i] in "eE":
        exponent += int(t[i + 1:])
    elif i != len(t):
        raise ValueError(f"not a number: {text!r}")
    if neg:
        number = -number
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _typed(texts: List[str]) -> tuple:
    """One CSV column as pandas types it: (kind, values), kind "int" (all
    present and integral), "float" (an NA text is NaN) or "str"."""
    present = [t for t in texts if t not in _NA_TEXTS]
    if len(present) == len(texts):
        try:
            return "int", [int(t) for t in texts]
        except ValueError:
            pass
    try:
        return "float", [pandas_float(t) if t not in _NA_TEXTS else math.nan for t in texts]
    except ValueError:
        return "str", [t if t not in _NA_TEXTS else math.nan for t in texts]


def parse_csv_rows(text: str) -> tuple:
    """({column: kind}, rows) of CSV text with a header, each column typed as
    ``pandas.read_csv`` types it. Text with no header raises ValueError."""
    reader = csv.reader(io.StringIO(text, newline=""))
    columns = next(reader, None)
    if columns is None:
        raise ValueError("no columns to parse")
    records = list(reader)
    typed = [_typed([r[j] if j < len(r) else "" for r in records]) for j in range(len(columns))]
    kinds = {c: kind for c, (kind, _) in zip(columns, typed)}
    return kinds, [dict(zip(columns, vals)) for vals in zip(*(v for _, v in typed))]


def concat_tables(tables: Sequence[tuple]) -> Tuple[List[str], List[Dict[str, Any]]]:
    """(columns, rows) of the tables joined as ``pandas.concat(frames,
    ignore_index=True)`` joins them: a column some table lacks is NaN there;
    an all-number column that is float in a table, or missing from one,
    holds floats. No table raises ValueError, as ``pandas.concat`` does."""
    if not tables:
        raise ValueError("No objects to concatenate")
    columns = list(dict.fromkeys(c for kinds, _ in tables for c in kinds))
    as_float = {c for c in columns
                if all(kinds.get(c, "float") in ("int", "float") for kinds, _ in tables)
                and any(kinds.get(c) != "int" for kinds, _ in tables)}
    rows = [{c: (float(row[c]) if c in as_float else row[c]) if c in row else math.nan
             for c in columns}
            for _, table_rows in tables for row in table_rows]
    return columns, rows


def read_csv_rows(path: Path) -> tuple:
    """:func:`parse_csv_rows` of a file."""
    with open(path, newline="", encoding="utf-8") as f:
        return parse_csv_rows(f.read())

def save_results_to_csv(batch_result: BatchProcessingResult, output_dir: Path) -> None:
    """Save metrics and timing data to CSV files."""
    output_dir = Path(output_dir)
    if batch_result.metrics_data:
        write_rows_csv(batch_result.metrics_data, ("condition", "image_name", "cell_id"),
                   output_dir / "cell_metrics.csv")
    if batch_result.timing_data:
        write_rows_csv(batch_result.timing_data, ("condition", "image_name", "cells_processed"),
                   output_dir / "processing_times.csv")


def generate_summary_text(
    batch_result: BatchProcessingResult,
    input_dir: Path,
    output_dir: Path,
    run_id: str,
    total_runtime: float,
    is_condition_summary: bool = False,
) -> str:
    """Generate a comprehensive summary (sections mirror reference
    ``reporting.py:43-110``)."""
    num_images = max(len(batch_result.results), 1)
    tt = batch_result.total_timing

    lines = []
    if is_condition_summary:
        condition = batch_result.results[0].condition if batch_result.results else "Unknown"
        lines.append(f"Condition Summary: {condition}")
        lines.append("=" * len(lines[0]) + "\n")
    else:
        lines.append("Pipeline Run Summary")
        lines.append("==================\n")

    lines.append(f"Run ID: {run_id}")
    lines.append(f"Timestamp: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}")
    lines.append(f"Input Directory: {Path(input_dir).absolute()}")
    lines.append(f"Output Directory: {Path(output_dir).absolute()}\n")

    if not is_condition_summary:
        lines.append("Condition Breakdown")
        lines.append("==================")
        conditions = {}
        for r in batch_result.results:
            cond = getattr(r, "condition", None) or "Unknown"
            stats = conditions.setdefault(cond, {"images": 0, "cells": 0})
            stats["images"] += 1
            stats["cells"] += r.num_cells
        for cond, stats in conditions.items():
            lines.append(f"Condition: {cond}")
            lines.append(f"  Images processed: {stats['images']}")
            lines.append(f"  Cells detected: {stats['cells']}")
            lines.append(
                f"  Average cells per image: {stats['cells'] / stats['images']:.1f}\n"
            )

    lines.append("Processing Statistics")
    lines.append("====================")
    lines.append(f"Total images processed: {len(batch_result.results)}")
    lines.append(f"Total cells detected: {tt['total_cells']}")
    lines.append(f"Average cells per image: {tt['total_cells'] / num_images:.1f}\n")

    lines.append("Timing Statistics (averaged per image)")
    lines.append("===================================")
    lines.append(f"Image loading: {(tt['image_load'] / num_images) * 1000:.1f}ms")
    lines.append(f"YOLO detection: {(tt['yolo_detection'] / num_images) * 1000:.1f}ms")
    lines.append(f"SAM preprocessing: {(tt['sam_preprocess'] / num_images) * 1000:.1f}ms")
    lines.append(f"SAM inference: {(tt['sam_inference_total'] / num_images) * 1000:.1f}ms")
    lines.append(
        f"SAM postprocessing: {(tt['sam_postprocess_total'] / num_images) * 1000:.1f}ms"
    )
    lines.append(f"Metrics calculation: {(tt['metrics_total'] / num_images) * 1000:.1f}ms")
    lines.append(f"Visualization: {(tt['visualization'] / num_images) * 1000:.1f}ms\n")

    lines.append("Overall Performance")
    lines.append("==================")
    lines.append(f"Total runtime: {total_runtime:.1f}s")
    lines.append(f"Average time per image: {total_runtime / num_images:.3f}s")
    lines.append(f"Throughput: {len(batch_result.results) / max(total_runtime, 1e-9):.1f} images/s")
    if tt["total_cells"] > 0:
        lines.append(
            f"Average time per cell: {(total_runtime / tt['total_cells']) * 1000:.1f}ms"
        )
    return "\n".join(lines)


def print_summary(batch_result: BatchProcessingResult, total_runtime: float) -> None:
    """Console performance summary (reference ``reporting.py:112-153``)."""
    num_images = max(len(batch_result.results), 1)
    tt = batch_result.total_timing

    print("\n" + "=" * 80)
    print("PIPELINE PERFORMANCE SUMMARY")
    print("=" * 80)

    print("\nCondition Breakdown:")
    conditions = {}
    for r in batch_result.results:
        cond = getattr(r, "condition", None) or "Unknown"
        stats = conditions.setdefault(cond, {"images": 0, "cells": 0})
        stats["images"] += 1
        stats["cells"] += r.num_cells
    for cond, stats in conditions.items():
        print(f"\nCondition: {cond}")
        print(f"  Images processed: {stats['images']}")
        print(f"  Cells detected: {stats['cells']}")
        print(f"  Average cells per image: {stats['cells'] / stats['images']:.1f}")

    print("\nOverall Statistics:")
    print(f"Total images processed: {len(batch_result.results)}")
    print(f"Total cells detected: {tt['total_cells']}")
    print(f"Average cells per image: {tt['total_cells'] / num_images:.1f}")
    print("\nTiming Breakdown (averaged per image):")
    print(f"Image loading: {(tt['image_load'] / num_images) * 1000:.1f}ms")
    print(f"YOLO detection: {(tt['yolo_detection'] / num_images) * 1000:.1f}ms")
    print(f"SAM preprocessing: {(tt['sam_preprocess'] / num_images) * 1000:.1f}ms")
    print(f"SAM inference: {(tt['sam_inference_total'] / num_images) * 1000:.1f}ms")
    print(f"SAM postprocessing: {(tt['sam_postprocess_total'] / num_images) * 1000:.1f}ms")
    print(f"Metrics calculation: {(tt['metrics_total'] / num_images) * 1000:.1f}ms")
    print(f"Visualization: {(tt['visualization'] / num_images) * 1000:.1f}ms")
    print(f"\nTotal runtime: {total_runtime:.1f}s")
    print(f"Average time per image: {total_runtime / num_images:.3f}s")
    if tt["total_cells"] > 0:
        print(f"Average time per cell: {(total_runtime / tt['total_cells']) * 1000:.1f}ms")
    print("=" * 80)


def save_run_summary(
    batch_result: BatchProcessingResult,
    input_dir: Path,
    output_dir: Path,
    run_id: str,
    total_runtime: float,
    summary_name: str = "run_summary.txt",
    is_condition_summary: bool = False,
) -> None:
    """Write ``run_summary.txt`` (reference ``reporting.py:155-174``)."""
    text = generate_summary_text(
        batch_result, input_dir, output_dir, run_id, total_runtime, is_condition_summary
    )
    with open(Path(output_dir) / summary_name, "w") as f:
        f.write(text)
