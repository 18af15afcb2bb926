"""Render sweep CSVs into a RESULTS-style markdown table.

Usage:
    python -m sparsematrixvectormultiplication_tpu_torch.bench.report result
    python -m sparsematrixvectormultiplication_tpu_torch.bench.report --best DIR [DIR ...]
"""

# Copied from sparsematrixvectormultiplication_tpu/bench/report.py (the port
# must not import the JAX package), with the port's stage names and the
# card's copy rate.

from __future__ import annotations

import csv
import os
import sys
from collections import defaultdict

from .csv_report import STREAM_BW_BYTES

__all__ = ["load_native", "best_table", "main"]

# the stages of the per-matrix table, in column order (the JAX package's
# serial_csr, serial_hll, xla_csr, xla_ell, pallas_hll, pallas_sell,
# pallas_sell_sigma, pallas_sell_dd)
STAGES = ("serial_csr", "serial_hll", "csr", "ell", "hll", "sell",
          "sell_sigma", "sell_dd")


def load_native(path: str):
    rows = defaultdict(dict)  # matrix -> stage -> row
    meta = {}
    with open(path) as f:
        for r in csv.DictReader(f):
            rows[r["matrix_name"]][r["stage"]] = r
            meta[r["matrix_name"]] = (int(r["rows"]), int(r["cols"]),
                                      int(r["nonzeros"]))
    return rows, meta


def fmt_gf(row):
    if not row:
        return "—"
    gf = float(row["gflops"])
    sig = int(row["significant_diffs"]) if row["significant_diffs"] else 0
    mark = "" if sig == 0 else f" ✗{sig}"
    return f"{gf:.2f}{mark}"


def _iter_native_rows(dirs):
    for d in dirs:
        for fname in ("spmv_results.csv", "spmv_scale_ladders.csv"):
            path = os.path.join(d, fname)
            if not os.path.exists(path):
                continue
            with open(path) as f:
                for r in csv.DictReader(f):
                    if r.get("matrix_name"):
                        yield r


def best_table(dirs, out=None):
    """Consolidated best-per-matrix table across result dirs: best f32 /
    bf16 / fp64-class (dd) stage per matrix with %STREAM (a row without
    ``pct_stream_bw`` is priced at the card's copy rate), merged from every
    native-schema CSV found — generated, never hand-edited."""
    best = defaultdict(dict)  # matrix -> class -> (gf, stage, row)
    meta = {}
    for r in _iter_native_rows(dirs):
        m = r["matrix_name"]
        stage = r["stage"]
        if stage.startswith("serial"):
            continue
        try:
            gf = float(r["gflops"])
            sig = int(r["significant_diffs"] or 0)
        except (ValueError, KeyError):
            continue
        if sig != 0 or gf <= 0:
            continue  # only validated rows may claim "best"
        cls = ("dd" if ("dd" in stage or "float64-dd" in r.get("dtype", ""))
               else "bf16" if ("bf16" in stage or "bfloat16" in r.get("dtype", ""))
               else "f32")
        meta[m] = int(r["nonzeros"])
        if gf > best[m].get(cls, (0, "", None))[0]:
            best[m][cls] = (gf, stage, r)

    def pct_stream(entry, nnz):
        if entry is None:
            return ""
        gf, _stage, r = entry
        p = r.get("pct_stream_bw")
        if p:
            return f"{float(p):.0f}%"
        try:
            per_nnz = float(r.get("bytes_streamed_per_nnz") or 0)
            sec = float(r["time_s"])
        except (TypeError, ValueError):
            return ""
        if per_nnz <= 0 or sec <= 0:
            return ""
        return f"{per_nnz * nnz / sec / STREAM_BW_BYTES * 100:.0f}%"

    lines = [
        "| Matrix | nnz | best f32 (stage) | %STREAM | best bf16 | "
        "best fp64-class (stage) | %STREAM |",
        "|---|---|---|---|---|---|---|",
    ]
    for m in sorted(best, key=lambda m: -meta[m]):
        nnz = meta[m]
        f32 = best[m].get("f32")
        bf = best[m].get("bf16")
        dd = best[m].get("dd")
        cell = lambda e: f"{e[0]:.2f} ({e[1]})" if e else "—"
        lines.append(
            f"| {m} | {nnz/1e6:.1f}M | {cell(f32)} | {pct_stream(f32, nnz)} "
            f"| {f'{bf[0]:.2f}' if bf else '—'} | {cell(dd)} | "
            f"{pct_stream(dd, nnz)} |")
    text = "\n".join(lines)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    return text


def main(argv=None):
    args = list(argv or sys.argv[1:])
    if args and args[0] == "--best":
        print(best_table(args[1:]))
        return
    out_dir = args[0] if args else "result"
    native = os.path.join(out_dir, "spmv_results.csv")
    rows, meta = load_native(native)
    present = [s for s in STAGES
               if any(s in st for st in rows.values())]
    hdr = "| Matrix | nnz | " + " | ".join(present) + " |"
    sep = "|" + "---|" * (len(present) + 2)
    print(hdr)
    print(sep)
    for m in sorted(rows, key=lambda m: -meta[m][2]):
        nnz = meta[m][2]
        cells = " | ".join(fmt_gf(rows[m].get(s)) for s in present)
        print(f"| {m} | {nnz/1e6:.1f}M | {cells} |")
    print("\nGFLOPS = 2·nnz/t; ✗N marks N significant validation diffs "
          "(tolerances abs 1e-5 / rel 1e-4, ≙ reference main.c:145).")


if __name__ == "__main__":
    main()
