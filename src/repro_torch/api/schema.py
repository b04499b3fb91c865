"""Canonical metric columns and the ``table`` ArtifactV1 envelope.

The port's copy of the parts of ``repro.api.schema`` that the paper-table
path needs: the column lists, the ladder, the spec hash, and the
envelope builder and validator for kind ``table``.  An artifact written
here validates under the reference package's ``validate_artifact``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Dict, Mapping, Optional, Sequence

from repro_torch.core.metrics import Metrics

SCHEMA_V1 = "repro.artifact.v1"

#: per-cell Metrics.row() columns
METRIC_ROW_KEYS = tuple(f.name for f in dataclasses.fields(Metrics))

#: the paper's four aggregate metrics (Tables I–III), canonical order
AGG_COLUMNS = ("latency_ns", "bandwidth_gbps", "hit_rate", "energy_uj")

#: aggregate column → the Metrics.row() field it averages over workloads
AGG_SOURCES = {
    "latency_ns": "avg_latency_ns",
    "bandwidth_gbps": "bandwidth_gbps",
    "hit_rate": "hit_rate",
    "energy_uj": "energy_uj_per_op",
}

#: optimization sense per aggregate column: +1 maximize, -1 minimize
METRIC_SENSE = {
    "latency_ns": -1,
    "bandwidth_gbps": +1,
    "hit_rate": +1,
    "energy_uj": -1,
}

#: the cumulative four-row configuration ladder
LADDER = ("baseline", "shared_l3", "prefetch", "tensor_aware")

#: provenance keys that differ between two runs of the same spec
VOLATILE_PROVENANCE = ("wall_s", "created_unix", "python",
                       "accesses_per_sec", "resilience", "fingerprint",
                       "failures")


class ArtifactError(ValueError):
    """An artifact does not conform to the ArtifactV1 schema."""


def spec_hash(spec: Mapping[str, Any]) -> str:
    """Canonical-JSON sha256 of a spec dict (order-insensitive)."""
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"),
                      default=str)
    return "sha256:" + hashlib.sha256(blob.encode()).hexdigest()


def artifact_fingerprint(art: Mapping[str, Any]) -> str:
    """Hash of an artifact's deterministic content (no provenance)."""
    content = {k: art.get(k) for k in
               ("schema", "kind", "spec", "spec_hash", "columns",
                "rows", "result")}
    return spec_hash(content)


def artifact_v1(kind: str, spec: Mapping[str, Any],
                rows: Sequence[Mapping[str, Any]],
                result: Optional[Mapping[str, Any]] = None,
                provenance: Optional[Mapping[str, Any]] = None,
                ) -> Dict[str, Any]:
    """Assemble (and validate) one ArtifactV1 envelope."""
    art = {
        "schema": SCHEMA_V1,
        "kind": kind,
        "spec": dict(spec),
        "spec_hash": spec_hash(spec),
        "provenance": dict(provenance or {}),
        "columns": list(AGG_COLUMNS),
        "rows": [dict(r) for r in rows],
        "result": dict(result or {}),
    }
    art["provenance"].setdefault("tool", "repro_torch")
    art["provenance"].setdefault("wall_s", 0.0)
    return validate_artifact(art)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ArtifactError(msg)


def validate_artifact(art: Mapping[str, Any]) -> Dict[str, Any]:
    """Validate a ``table`` ArtifactV1 envelope; returns it."""
    _require(isinstance(art, Mapping), "artifact is not a mapping")
    _require(art.get("schema") == SCHEMA_V1,
             f"schema tag {art.get('schema')!r} != {SCHEMA_V1!r}")
    _require(art.get("kind") == "table",
             f"unsupported artifact kind {art.get('kind')!r}")
    spec = art.get("spec")
    _require(isinstance(spec, Mapping), "spec is not a mapping")
    _require(art.get("spec_hash") == spec_hash(spec),
             "spec_hash does not match spec (artifact tampered or stale)")
    prov = art.get("provenance")
    _require(isinstance(prov, Mapping) and "tool" in prov,
             "provenance.tool missing")
    _require(art.get("columns") == list(AGG_COLUMNS),
             f"columns {art.get('columns')!r} != canonical {AGG_COLUMNS}")
    rows = art.get("rows")
    _require(isinstance(rows, list) and len(rows) > 0
             and all(isinstance(r, Mapping) for r in rows),
             "rows is not a non-empty list of mappings")
    _require(isinstance(art.get("result"), Mapping),
             "result is not a mapping")
    for i, row in enumerate(rows):
        for k in METRIC_ROW_KEYS:
            _require(k in row, f"rows[{i}]: missing Metrics column {k!r}")
            if k in ("name", "workload"):
                continue
            v = row[k]
            _require(not isinstance(v, bool) and isinstance(v, (int, float))
                     and math.isfinite(float(v)),
                     f"rows[{i}]: column {k!r} is not a finite number "
                     f"({v!r})")
    return dict(art)
