"""Suite aggregation, the paper comparison and the trend verdict.

The port's copy of ``repro.core.calibration`` (without ``run_suite``,
whose work the batched engine and ``repro_torch.cli`` do).
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from repro_torch.api.schema import (AGG_COLUMNS, AGG_SOURCES, LADDER,
                                    METRIC_SENSE)
from repro_torch.core.presets import PAPER_TABLE


def aggregate_rows(rows: List[Dict]) -> Dict:
    """Suite aggregate from per-workload Metrics rows (equal weighting)."""
    out: Dict = {col: float(np.mean([r[src] for r in rows]))
                 for col, src in AGG_SOURCES.items()}
    out["per_workload"] = rows
    return out


def compare_to_paper(results: Dict[str, Dict]) -> List[Dict]:
    """Per (config, metric): simulated vs published + relative error."""
    rows = []
    for cfg, paper in PAPER_TABLE.items():
        if cfg not in results:
            continue
        sim = results[cfg]
        for metric, pub in paper.items():
            if metric not in sim:
                print(f"[calibration] skipping {cfg}/{metric}: no "
                      f"simulated value (degraded campaign)",
                      file=sys.stderr)
                continue
            got = sim[metric]
            rows.append({
                "config": cfg, "metric": metric,
                "paper": pub, "simulated": round(got, 3),
                "rel_err": round((got - pub) / pub, 3),
            })
    return rows


def trend_ok(results: Dict[str, Dict]) -> bool:
    """Each ladder row strictly improves all four metrics over the
    previous one; a missing or incomplete row cannot certify it."""
    for name in LADDER:
        row = results.get(name)
        if not row or any(col not in row for col in METRIC_SENSE):
            print(f"[calibration] trend_ok: ladder row {name!r} is "
                  f"missing or incomplete (degraded campaign) — "
                  f"cannot certify the trend", file=sys.stderr)
            return False
    for a, b in zip(LADDER, LADDER[1:]):
        for col, sense in METRIC_SENSE.items():
            if sense * (results[b][col] - results[a][col]) <= 0:
                return False
    return True


def report_vs_paper(results: Dict[str, Dict], scale: float,
                    engine: str = "torch",
                    elapsed_s: float = 0.0) -> bool:
    """Print the trend verdict and the per-cell paper comparison; at
    scale >= 1.0 the trend is a hard assertion."""
    ok = trend_ok(results)
    print(f"\nmonotone trend (all 4 metrics, all rows): {ok}")
    if scale >= 1.0:
        assert ok, ("trend_ok regression at full scale: " + "; ".join(
            f"{c}={{'{m}': {results[c][m]:.4f}}}"
            for c in LADDER for m in AGG_COLUMNS))
    rows = compare_to_paper(results)
    rel = [abs(r["rel_err"]) for r in rows]
    if not rel:
        print("[calibration] no comparable cells (degraded campaign); "
              "skipping paper comparison", file=sys.stderr)
        return ok
    print(f"mean |rel err| vs paper: {sum(rel)/len(rel):.3f} "
          f"(n={len(rel)} cells)  [{elapsed_s:.0f}s @ scale={scale}, "
          f"engine={engine}]")
    for r in rows:
        print(f"  table,{r['config']},{r['metric']},{r['paper']},"
              f"{r['simulated']},{r['rel_err']}")
    return ok
