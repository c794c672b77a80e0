"""Markdown tables of roofline records (counterpart of
``repro.launch.report``).

Usage: PYTHONPATH=src python -m repro_torch.launch.report records.jsonl

A record is one JSON line: ``arch``, ``shape``, ``mesh`` (a name),
``status`` (ok | skipped | error), and for an ok record ``analytic``
(``launch.analytic.Analytic``'s counts and detail) and ``roofline``
(``launch.roofline.Roofline``'s terms with ``roofline_fraction``);
``measured_peak_bytes`` where a run measured the device's peak; from
``launch/dryrun.py``, ``memory`` (the traced peak a rank), ``fits`` and
``trace_s``.  The port compiles nothing, so the dry-run table has no
compile seconds and no collective op counts.
"""
from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def fmt_ms(s):
    return f"{s*1e3:.1f}"


def load(path):
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def dryrun_table(recs, mesh):
    """One row a cell of ``mesh``.  Where the records hold a dry run's
    trace (``memory``, of ``launch/dryrun.py``) the table gains its
    peak, whether that fits the card and the trace's host seconds."""
    recs = [r for r in recs if r["mesh"] == mesh]
    traced = any("memory" in r for r in recs)
    head = ["arch", "shape", "status", "resident GiB/dev"]
    head += ["dry-run peak GiB/dev", "fits 80 GB"] if traced else []
    head += ["measured peak GiB/dev", "fallbacks"]
    head += ["trace s"] if traced else []
    rows = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
    for r in recs:
        cells = [r["arch"], r["shape"]]
        if r["status"] == "skipped":
            cells += ["skipped (sub-quadratic gate)"]
            cells += ["—"] * (len(head) - len(cells))
        elif r["status"] == "error":
            cells += ["ERROR"] + ["—"] * (len(head) - 4)
            cells.insert(head.index("fallbacks"), r["error"][:40])
        else:
            peak = r.get("measured_peak_bytes")
            mem = r.get("memory")
            cells += ["ok",
                      fmt_bytes(r["analytic"]["resident_bytes_per_dev"])]
            if traced:
                cells += ["—", "—"] if mem is None else [
                    fmt_bytes(mem["peak_bytes_per_device"]),
                    "yes" if r["fits"] else "no"]
            cells += ["—" if peak is None else fmt_bytes(peak),
                      str(len(r.get("sharding_fallbacks", [])))]
            if traced:
                cells += ["—" if mem is None else str(r["trace_s"])]
        rows.append("| " + " | ".join(cells) + " |")
    return "\n".join(rows)


def roofline_table(recs, mesh="pod"):
    rows = ["| arch | shape | compute ms | memory ms | collective ms "
            "| dominant | MODEL_FLOPS | useful ratio | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh or r["status"] != "ok":
            continue
        ro = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {fmt_ms(ro['compute_s'])} | {fmt_ms(ro['memory_s'])} "
            f"| {fmt_ms(ro['collective_s'])} | **{ro['dominant']}** "
            f"| {ro['model_flops']:.2e} | {ro['useful_ratio']:.2f} "
            f"| {ro['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def summary(recs):
    ok = [r for r in recs if r["status"] == "ok"]
    sk = [r for r in recs if r["status"] == "skipped"]
    er = [r for r in recs if r["status"] == "error"]
    by_dom = {}
    for r in ok:
        if r["mesh"] == "pod":
            d = r["roofline"]["dominant"]
            by_dom[d] = by_dom.get(d, 0) + 1
    return (f"{len(ok)} compiled ok, {len(sk)} skipped (sub-quadratic "
            f"gate), {len(er)} errors; single-pod dominant terms: {by_dom}")


def main(paths):
    recs = []
    for p in paths:
        recs.extend(load(p))
    # keep last record per cell (later files / re-runs win)
    seen = {}
    for r in recs:
        seen[(r["arch"], r["shape"], r["mesh"], r.get("plan"))] = r
    recs = list(seen.values())
    print("## Summary\n")
    print(summary(recs))
    for mesh in dict.fromkeys(r["mesh"] for r in recs):
        print(f"\n## Dry-run — mesh {mesh}\n")
        print(dryrun_table(recs, mesh))
        print(f"\n## Roofline — mesh {mesh}\n")
        print(roofline_table(recs, mesh))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: python -m repro_torch.launch.report "
                 "records.jsonl [more.jsonl ...]")
    main(sys.argv[1:])
