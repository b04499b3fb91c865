"""The paper's four evaluated configurations (Table I/II/III rows).

Rows are cumulative: each HERMES row adds one technique on top of the
previous one.  The values are those of ``repro.core.presets``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.params import (CacheParams, HybridMemParams,
                                     PrefetchParams, SystemParams,
                                     TensorPolicyParams)

_L3 = CacheParams("L3", 8 * 1024 * 1024, 16, hit_latency=42)
_L3_TA = CacheParams("L3", 8 * 1024 * 1024, 16, hit_latency=42,
                     policy="tensor_aware",
                     ta=TensorPolicyParams(prefetch_rank=3.5))

BASELINE = SystemParams(
    name="baseline",
    l3=None,
    coherence="mesi",
    prefetch=PrefetchParams(enabled=False),
    hybrid=HybridMemParams(enabled=False),
)

SHARED_L3 = dataclasses.replace(
    BASELINE,
    name="shared_l3",
    l3=_L3,
    hybrid=HybridMemParams(enabled=True),
)

PREFETCH = dataclasses.replace(
    SHARED_L3,
    name="prefetch",
    prefetch=PrefetchParams(enabled=True, ml_enabled=True, degree=3,
                            ml_threshold=2.0),
)

TENSOR_AWARE = dataclasses.replace(
    PREFETCH,
    name="tensor_aware",
    l3=_L3_TA,
)

CONFIGS: List[SystemParams] = [BASELINE, SHARED_L3, PREFETCH, TENSOR_AWARE]

#: name → preset
PRESETS: Dict[str, SystemParams] = {sp.name: sp for sp in CONFIGS}

#: Paper-published values (Tables I, II, III).
PAPER_TABLE: Dict[str, Dict[str, float]] = {
    "baseline":     {"latency_ns": 120, "bandwidth_gbps": 25,
                     "hit_rate": 0.60, "energy_uj": 50},
    "shared_l3":    {"latency_ns": 95,  "bandwidth_gbps": 35,
                     "hit_rate": 0.75, "energy_uj": 40},
    "prefetch":     {"latency_ns": 85,  "bandwidth_gbps": 40,
                     "hit_rate": 0.80, "energy_uj": 38},
    "tensor_aware": {"latency_ns": 80,  "bandwidth_gbps": 42,
                     "hit_rate": 0.90, "energy_uj": 35},
}
