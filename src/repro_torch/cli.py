"""``python -m repro_torch`` — the port's front door.

    repro_torch table   paper Tables I–III over the preset ladder

``table`` prints the same aggregate table and builds the same artifact
rows as ``python -m repro table --backend batched``; every cell of the
ladder runs as one lane of one launch of the step kernel.  It runs on
the card unless ``--device cpu`` is given, and writes its ArtifactV1
only where ``--out`` says.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

SMOKE_SCALE = 0.02


def print_aggregate_table(aggregates: Dict[str, Dict[str, float]]) -> None:
    from repro_torch.api.schema import AGG_COLUMNS
    from repro_torch.core.presets import PAPER_TABLE

    print(f"\n{'config':14s} " + "".join(f"{m:>26s}" for m in AGG_COLUMNS))
    for cfg, agg in aggregates.items():
        cells = []
        for m in AGG_COLUMNS:
            pub = PAPER_TABLE.get(cfg, {}).get(m)
            cells.append(f"{agg[m]:9.2f} (paper {pub:7.2f})" if pub
                         else f"{agg[m]:9.2f} {'':15s}")
        print(f"{cfg:14s} " + "".join(f"{c:>26s}" for c in cells))


def run_table(scale: float, preset: Optional[str] = None,
              device: Optional[str] = None, out: Optional[str] = None,
              tool: str = "python -m repro_torch table") -> Dict[str, Any]:
    """The ``repro_torch table`` body: traces → one batched engine run
    over every (preset × workload) cell → Metrics → aggregates, paper
    comparison and trend verdict → a ``table`` ArtifactV1."""
    import torch

    from repro_torch.api.schema import (LADDER, artifact_fingerprint,
                                        artifact_v1)
    from repro_torch.core import engine_torch
    from repro_torch.core import trace as trace_mod
    from repro_torch.core.calibration import aggregate_rows, report_vs_paper
    from repro_torch.core.presets import CONFIGS, PRESETS

    dev = engine_torch.resolve_device(device)
    t0 = time.time()
    if preset is not None and preset not in PRESETS:
        raise SystemExit(f"unknown preset {preset!r} (known: "
                         f"{sorted(PRESETS)})")
    configs = [PRESETS[preset]] if preset else list(CONFIGS)
    workloads = list(trace_mod.WORKLOADS)
    traces = {wl: trace_mod.WORKLOADS[wl](scale) for wl in workloads}
    cells = [(sp, traces[wl]) for sp in configs for wl in workloads]
    outs = engine_torch.run_cells(cells, device=str(dev))
    rows: List[Dict] = [
        engine_torch.metrics_from_outputs(sp, tr, oi, od).row()
        for (sp, tr), (oi, od) in zip(cells, outs)]
    aggregates = {}
    for i, sp in enumerate(configs):
        agg = aggregate_rows(rows[i * len(workloads):(i + 1) * len(workloads)])
        aggregates[sp.name] = {k: v for k, v in agg.items()
                               if k != "per_workload"}
    print_aggregate_table(aggregates)
    trend = None
    if tuple(aggregates) == LADDER:
        trend = report_vs_paper(aggregates, scale, engine="torch",
                                elapsed_s=time.time() - t0)
    name = f"scale{scale:g}" + (f"_{preset}" if preset else "")
    spec = {"name": name,
            "hierarchies": [{"name": sp.name, "preset": sp.name,
                             "overrides": {}} for sp in configs],
            "workloads": workloads, "engine": "torch", "scale": scale}
    stats = dict(engine_torch.last_run_stats)
    wall = time.time() - t0
    provenance = {
        "tool": tool, "engine": "torch", "engine_resolved": "torch",
        "backend": "batched",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "python": sys.version.split()[0],
        "wall_s": round(wall, 2), "created_unix": int(time.time()),
        "accesses_per_sec": sum(len(tr["core"]) for _, tr in cells) / wall,
        "run_stats": stats,
    }
    result: Dict[str, Any] = {"aggregates": aggregates}
    if trend is not None:
        result["trend_ok"] = trend
    art = artifact_v1("table", spec, rows, result=result,
                      provenance=provenance)
    art["provenance"]["fingerprint"] = artifact_fingerprint(art)
    if out:
        path = Path(out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(art, indent=1))
        print(f"[repro_torch] wrote {path}")
    return art


def cmd_table(args: argparse.Namespace) -> int:
    scale = args.scale if args.scale is not None else (
        SMOKE_SCALE if args.smoke else 1.0)
    run_table(scale, preset=args.preset, device=args.device, out=args.out)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.core.engine_torch import TorchEngineError

    ap = argparse.ArgumentParser(prog="python -m repro_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("table", help="paper Tables I-III over the ladder")
    t.add_argument("--smoke", action="store_true",
                   help=f"tiny-scale run (scale {SMOKE_SCALE})")
    t.add_argument("--scale", type=float, default=None,
                   help="workload scale (default 1.0)")
    t.add_argument("--preset", default=None,
                   help="run one hierarchy preset instead of the ladder")
    t.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    t.add_argument("--out", default=None, help="artifact path")
    t.set_defaults(fn=cmd_table)
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except TorchEngineError as e:
        print(f"[repro_torch] error: {e}", file=sys.stderr)
        return 2
