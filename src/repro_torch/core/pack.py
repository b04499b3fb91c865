"""Knob lowering: ``SystemParams`` → the flat ``(ci, cd)`` config arrays.

The port's copy of the index tables and of ``pack_config_sp`` in
``repro.core.native`` (the compiled-kernel loader there is not needed),
plus the timing constants of ``repro.core.simulator`` that the lowering
reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.params import (LINE_SIZE, PAGE_SIZE, MemChannelParams,
                                     SystemParams, TensorPolicyParams)

#: limited memory-level parallelism: in-order cores vs the Gemmini port
CORE_MLP = 6.0
ACCEL_MLP = 48.0
#: latency of one interconnect hop / cache-to-cache transfer (cycles)
C2C_LATENCY = 40
INV_LATENCY = 12
#: drop prefetches when the target channel queue exceeds this depth (cycles)
PREFETCH_THROTTLE = 200.0

DRAM_CHANNEL = MemChannelParams(
    name="ddr4", capacity_bytes=8 << 30, base_latency=150,
    bandwidth_bytes_per_cycle=12.8, row_hit_latency=55, row_gap=8.0)
HBM_CHANNEL = MemChannelParams(
    name="hbm2", capacity_bytes=4 << 30, base_latency=100,
    bandwidth_bytes_per_cycle=64.0, row_hit_latency=36, row_gap=2.0)

# int-config indices
(CI_NREQ, CI_NCORES, CI_S1, CI_A1, CI_S2, CI_A2, CI_S3, CI_A3,
 CI_HASL3, CI_MESI, CI_PFON, CI_MLON, CI_TA1, CI_TA2, CI_TA3,
 CI_HYBRID, CI_NTEN, CI_ST_TSIZE, CI_ST_CONF, CI_ST_DEG,
 CI_ML_TSIZE, CI_ML_HIST, CI_HP_HOT, CI_HP_WINDOW, CI_HL1, CI_HL2,
 CI_HL3, CI_HBM_PAGES_MAX, CI_TA_SAMPLE, CI_TA_SHADOW, CI_TA_DECAY,
 CI_COUNT) = range(32)

# float-config indices
(CD_ML_THRESH, CD_HP_MIGCOST, CD_D_BL, CD_D_RHL, CD_D_BW, CD_D_GAP,
 CD_D_RBB, CD_H_BL, CD_H_RHL, CD_H_BW, CD_H_GAP, CD_H_RBB,
 CD_CORE_MLP, CD_ACCEL_MLP, CD_C2C, CD_INV, CD_PF_THROTTLE,
 CD_TA_LOW, CD_TA_HIGH, CD_TA_PREF, CD_TA_BYPASS, CD_TA_STREAM,
 CD_COUNT) = range(23)


def pack_config_sp(sp: SystemParams, nten: int
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Lower a ``SystemParams`` + tensor-id count to ``(ci, cd)``, or
    ``None`` when the configuration is outside the array engine's
    envelope."""
    n_req = sp.n_cores + (1 if sp.accel_port else 0)
    pp = sp.prefetch
    if (LINE_SIZE != 64 or PAGE_SIZE != 4096 or n_req > 8
            or pp.degree > 16 or max(3, pp.ml_history) > 8
            or DRAM_CHANNEL.row_buffer_bytes != HBM_CHANNEL.row_buffer_bytes
            or sp.l1.line_size != 64 or sp.l2.line_size != 64
            or (sp.l3 is not None and sp.l3.line_size != 64)):
        return None
    # one TA-knob set: levels running the tensor-aware policy must agree
    levels = [sp.l1, sp.l2] + ([sp.l3] if sp.l3 is not None else [])
    ta_sets = {lv.ta for lv in levels if lv.policy == "tensor_aware"}
    if len(ta_sets) > 1:
        return None
    tp = ta_sets.pop() if ta_sets else TensorPolicyParams()

    ci = np.zeros(CI_COUNT, np.int64)
    ci[CI_NREQ] = n_req
    ci[CI_NCORES] = sp.n_cores
    ci[CI_S1], ci[CI_A1] = sp.l1.n_sets, sp.l1.assoc
    ci[CI_S2], ci[CI_A2] = sp.l2.n_sets, sp.l2.assoc
    if sp.l3 is not None:
        ci[CI_S3], ci[CI_A3] = sp.l3.n_sets, sp.l3.assoc
        ci[CI_HASL3] = 1
        ci[CI_TA3] = sp.l3.policy == "tensor_aware"
        ci[CI_HL3] = sp.l3.hit_latency
    ci[CI_MESI] = sp.coherence == "mesi"
    ci[CI_PFON] = pp.enabled
    ci[CI_MLON] = pp.ml_enabled
    ci[CI_TA1] = sp.l1.policy == "tensor_aware"
    ci[CI_TA2] = sp.l2.policy == "tensor_aware"
    ci[CI_HYBRID] = sp.hybrid.enabled
    ci[CI_NTEN] = nten
    ci[CI_ST_TSIZE] = pp.stride_table_size
    ci[CI_ST_CONF] = pp.stride_confidence
    ci[CI_ST_DEG] = pp.degree
    ci[CI_ML_TSIZE] = pp.ml_table_size
    ci[CI_ML_HIST] = max(3, pp.ml_history)
    ci[CI_HP_HOT] = sp.hybrid.hot_threshold
    ci[CI_HP_WINDOW] = sp.hybrid.window
    ci[CI_HL1] = sp.l1.hit_latency
    ci[CI_HL2] = sp.l2.hit_latency
    ci[CI_HBM_PAGES_MAX] = HBM_CHANNEL.capacity_bytes // PAGE_SIZE
    ci[CI_TA_SAMPLE] = tp.sample
    ci[CI_TA_SHADOW] = tp.shadow_max
    ci[CI_TA_DECAY] = tp.decay_fills

    cd = np.zeros(CD_COUNT, np.float64)
    cd[CD_ML_THRESH] = pp.ml_threshold
    cd[CD_HP_MIGCOST] = sp.hybrid.migration_cost_cycles
    d, h = DRAM_CHANNEL, HBM_CHANNEL
    cd[CD_D_BL], cd[CD_D_RHL], cd[CD_D_BW] = d.base_latency, \
        d.row_hit_latency, d.bandwidth_bytes_per_cycle
    cd[CD_D_GAP], cd[CD_D_RBB] = d.row_gap, d.row_buffer_bytes
    cd[CD_H_BL], cd[CD_H_RHL], cd[CD_H_BW] = h.base_latency, \
        h.row_hit_latency, h.bandwidth_bytes_per_cycle
    cd[CD_H_GAP], cd[CD_H_RBB] = h.row_gap, h.row_buffer_bytes
    cd[CD_CORE_MLP], cd[CD_ACCEL_MLP] = CORE_MLP, ACCEL_MLP
    cd[CD_C2C], cd[CD_INV] = C2C_LATENCY, INV_LATENCY
    cd[CD_PF_THROTTLE] = PREFETCH_THROTTLE
    cd[CD_TA_LOW] = tp.low_utility
    cd[CD_TA_HIGH] = tp.high_utility
    cd[CD_TA_PREF] = tp.prefetch_rank
    cd[CD_TA_STREAM] = tp.stream_rank
    cd[CD_TA_BYPASS] = (sp.l3.ta.bypass_utility
                        if sp.l3 is not None else 0.0)
    return ci, cd
