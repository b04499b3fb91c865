"""``Metrics`` rows derived straight from the engine's flat counters.

The batched engine exports one ``oi`` (98 int64) and one ``od`` (10
float64) vector per lane, in the layout of ``repro.core.engine_jax``.
``metrics_from_outputs`` turns them into the ``Metrics`` row that
``repro.core.simulator.compute_metrics`` derives after
``native.deposit_counters``: the same counters, the same float operations
in the same order, so the rows compare with ``==``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.energy import EnergyModel
from repro_torch.core.params import LINE_SIZE, SystemParams


@dataclasses.dataclass
class Metrics:
    name: str
    workload: str
    avg_latency_ns: float
    bandwidth_gbps: float
    hit_rate: float            # fraction of accesses served by ANY cache
    l1_hit_rate: float
    l2_hit_rate: float
    l3_hit_rate: float
    energy_uj_per_op: float
    elapsed_ns: float
    dram_lines: int
    hbm_lines: int
    hbm_fraction: float
    invalidations: int
    c2c_transfers: int
    prefetches_issued: int
    prefetch_useful: int
    migrations: int

    def row(self) -> Dict:
        return dataclasses.asdict(self)


def metrics_from_outputs(sp: SystemParams, trace: Dict, oi, od) -> Metrics:
    """One lane's ``Metrics`` from its ``(oi, od)`` export vectors."""
    oi = [int(v) for v in oi]
    od = [float(v) for v in od]
    nr = sp.n_cores + (1 if sp.accel_port else 0)
    mesi = sp.coherence == "mesi"
    has_l3 = sp.l3 is not None
    hbm = sp.hybrid.enabled

    n_acc = oi[0]
    l1h, l1m = oi[26:26 + nr], oi[34:34 + nr]
    l2h, l2m = oi[50:50 + nr], oi[58:58 + nr]
    l2pu = oi[66:66 + nr]
    time = od[:nr]
    lat_sum = od[8]

    elapsed = max(time) if time else 1.0
    l1_acc = sum(h + m for h, m in zip(l1h, l1m))
    l1_hits = sum(l1h)
    l2_acc = sum(h + m for h, m in zip(l2h, l2m))
    l2_hits = sum(l2h)
    l3_acc = oi[23] + oi[24] if has_l3 else 0
    l3_hits = oi[23] if has_l3 else 0
    c2c = oi[4] if mesi else 0
    invalidations = oi[3] if mesi else 0
    served_by_cache = l1_hits + l2_hits + l3_hits + c2c
    dram_bytes, dram_row_hits = oi[8], oi[9]
    hbm_bytes = oi[11] if hbm else 0
    migrations, migration_bytes = oi[6], oi[7]
    dram_lines = dram_bytes // LINE_SIZE
    hbm_lines = hbm_bytes // LINE_SIZE if hbm else 0
    issued = sum(oi[74 + r] + oi[82 + r] for r in range(nr))
    counters = {
        "l1_accesses": l1_acc,
        "l2_accesses": l2_acc,
        "l3_accesses": l3_acc,
        "dram_lines": dram_lines,
        "dram_row_hits": dram_row_hits,
        "hbm_lines": hbm_lines,
        "hbm_row_hits": oi[12] if hbm else 0,
        "coherence_msgs": (invalidations + c2c) if mesi else 0,
        "prefetches": issued,
        "migrations": migrations,
        "migration_lines": migration_bytes // LINE_SIZE,
    }
    total_bytes = dram_bytes + migration_bytes + hbm_bytes
    elapsed_ns = sp.cycles_to_ns(elapsed)
    return Metrics(
        name=sp.name,
        workload=trace["name"],
        avg_latency_ns=sp.cycles_to_ns(lat_sum / max(1, n_acc)),
        bandwidth_gbps=(l1_hits * 8 + (n_acc - l1_hits) * LINE_SIZE)
        / max(elapsed_ns, 1e-9),
        hit_rate=served_by_cache / max(1, n_acc),
        l1_hit_rate=l1_hits / max(1, l1_acc),
        l2_hit_rate=l2_hits / max(1, l2_acc),
        l3_hit_rate=l3_hits / max(1, l3_acc) if l3_acc else 0.0,
        energy_uj_per_op=EnergyModel().uj_per_op(
            counters, trace["meta"]["n_macro_ops"], elapsed_ns=elapsed_ns),
        elapsed_ns=elapsed_ns,
        dram_lines=dram_lines,
        hbm_lines=hbm_lines,
        hbm_fraction=(hbm_bytes / total_bytes) if (hbm and total_bytes)
        else 0.0,
        invalidations=invalidations,
        c2c_transfers=c2c,
        prefetches_issued=issued,
        prefetch_useful=sum(l2pu) + (oi[25] if has_l3 else 0),
        migrations=migrations,
    )
