"""Configuration dataclasses of the HERMES memory-hierarchy simulator.

The port's own copy of ``repro.core.params``: the same frozen dataclasses
with the same defaults, the per-lane knob lists of the batched engine and
the lane stacking helpers.  ``from_reference`` rebuilds a ``SystemParams``
from ``dataclasses.asdict()`` of the reference package's equivalent, which
is how presets and off-preset sweep points cross between the packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

LINE_SIZE = 64  # bytes, fixed across the hierarchy
PAGE_SIZE = 4096  # bytes, hybrid-memory migration granularity


@dataclasses.dataclass(frozen=True)
class TensorPolicyParams:
    """Knobs of the tensor-aware replacement policy."""

    sample: int = 16
    shadow_max: int = 16384
    decay_fills: int = 16384
    low_utility: float = 0.05
    high_utility: float = 0.5
    prefetch_rank: float = 2.5
    bypass_utility: float = 0.05
    stream_rank: float = 0.0

    def __post_init__(self) -> None:
        if self.sample < 1 or self.shadow_max < 1 or self.decay_fills < 1:
            raise ValueError("sample/shadow_max/decay_fills must be >= 1")
        if not (0.0 <= self.low_utility <= self.high_utility):
            raise ValueError("need 0 <= low_utility <= high_utility")


@dataclasses.dataclass(frozen=True)
class CacheParams:
    """One cache level."""

    name: str
    size_bytes: int
    assoc: int
    hit_latency: int  # cycles
    policy: str = "lru"  # "lru" | "tensor_aware"
    line_size: int = LINE_SIZE
    ta: TensorPolicyParams = dataclasses.field(
        default_factory=TensorPolicyParams)

    @property
    def n_sets(self) -> int:
        n = self.size_bytes // (self.assoc * self.line_size)
        if n & (n - 1):
            raise ValueError(f"{self.name}: set count {n} not a power of two")
        return n


@dataclasses.dataclass(frozen=True)
class MemChannelParams:
    """One main-memory channel (DRAM or HBM)."""

    name: str
    capacity_bytes: int
    base_latency: int
    bandwidth_bytes_per_cycle: float
    row_hit_latency: int
    row_buffer_bytes: int = 2048
    row_gap: float = 0.0


@dataclasses.dataclass(frozen=True)
class PrefetchParams:
    enabled: bool = False
    stride_table_size: int = 256
    stride_confidence: int = 3
    degree: int = 2
    ml_enabled: bool = False
    ml_history: int = 4
    ml_table_size: int = 512
    ml_threshold: float = 0.5


@dataclasses.dataclass(frozen=True)
class HybridMemParams:
    enabled: bool = False
    hot_threshold: int = 8
    window: int = 4096
    migration_cost_cycles: int = 600


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """Full simulated system = one paper configuration row."""

    name: str
    n_cores: int = 4
    clock_ghz: float = 2.0
    l1: CacheParams = dataclasses.field(
        default_factory=lambda: CacheParams("L1", 32 * 1024, 8, hit_latency=4)
    )
    l2: CacheParams = dataclasses.field(
        default_factory=lambda: CacheParams("L2", 256 * 1024, 8, hit_latency=14)
    )
    l3: Optional[CacheParams] = None
    prefetch: PrefetchParams = dataclasses.field(default_factory=PrefetchParams)
    hybrid: HybridMemParams = dataclasses.field(default_factory=HybridMemParams)
    coherence: str = "mesi"
    accel_port: bool = True

    def cycles_to_ns(self, cycles: float) -> float:
        return cycles / self.clock_ghz


def _cache_from(d: Dict[str, Any]) -> CacheParams:
    d = dict(d)
    d["ta"] = TensorPolicyParams(**d["ta"])
    return CacheParams(**d)


def from_reference(d: Dict[str, Any]) -> SystemParams:
    """The port's ``SystemParams`` from ``dataclasses.asdict()`` of a
    reference ``SystemParams`` (every field carried, nothing defaulted)."""
    d = dict(d)
    d["l1"] = _cache_from(d["l1"])
    d["l2"] = _cache_from(d["l2"])
    d["l3"] = _cache_from(d["l3"]) if d["l3"] is not None else None
    d["prefetch"] = PrefetchParams(**d["prefetch"])
    d["hybrid"] = HybridMemParams(**d["hybrid"])
    return SystemParams(**d)


#: per-lane integer knobs of the batched engine
LANE_INT_FIELDS = ("st_conf", "hp_hot", "hp_window", "ta_decay")
#: per-lane float knobs of the batched engine
LANE_FLOAT_FIELDS = ("ml_thresh", "migcost", "ta_low", "ta_high",
                     "ta_pref", "ta_stream", "ta_bypass",
                     "hl1", "hl2", "hl3")


def lane_pad(n: int) -> int:
    """Next power of two of a lane count (1 stays 1)."""
    if n <= 1:
        return n
    return 1 << (n - 1).bit_length()


def stack_lanes(cfgs, pad: bool = True):
    """Stack per-lane knob dicts into arrays of length ``lane_pad(n)``
    (padding lanes replicate lane 0); returns ``(arrays, n)``."""
    n = len(cfgs)
    if n == 0:
        raise ValueError("stack_lanes needs at least one lane")
    total = lane_pad(n) if pad else n
    idx = list(range(n)) + [0] * (total - n)
    arrays = {}
    for k in LANE_INT_FIELDS:
        arrays[k] = np.asarray([cfgs[i][k] for i in idx], dtype=np.int64)
    for k in LANE_FLOAT_FIELDS:
        arrays[k] = np.asarray([cfgs[i][k] for i in idx],
                               dtype=np.float64)
    return arrays, n
