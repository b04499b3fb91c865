"""Whole-trace step kernel: every lane's whole trace in one launch.

Replaces the ``lax.scan`` of ``_make_step`` over the trace
(``repro/core/engine_jax.py:1383``, vmapped over config lanes).  Each lane
is one warp of ``csrc/sim_step.cu``; it reads its structural knobs, its
trace columns and the addresses of its state arrays from one row of a
descriptor table (``LaneDesc`` in the source, ``DESC_FIELDS`` here: the
same fields in the same order, every one 8 bytes).  On CPU lanes the
wrapper runs the plain step (``core.step_plain``) instead.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import engine_torch as E

_LEVEL = (["S", "A", "sb", "ta"]
          + list("tvdpunlrq") + ["ctr", "ev", "dev", "pf"]
          + ["bkt", "utl", "fil", "hit", "ref", "sin", "shr", "shl", "shh",
             "shk"])
_LEVEL_STATIC = {"S", "A", "sb", "ta"}
_CHAN = ["bl", "rhl", "bw", "gap", "rbb", "b", "s", "by", "ac", "rh", "op"]
_CHAN_FLOAT = {"bl", "rhl", "bw", "gap"}
_LDICT = ["pool", "hcap", "nv", "pk", "pv", "prv", "nxt", "hd", "tl", "cnt",
          "fs", "ft", "hk", "hv"]
_LDICT_STATIC = {"pool", "hcap", "nv"}
_INTS = ["n", "n_req", "n_cores", "has_l3", "mesi", "pf_on", "ml_on",
         "hybrid", "nten", "st_deg", "ml_tsize", "ml_hist", "ta_sample",
         "ta_shadow", "st_conf", "hp_hot", "hp_window", "ta_decay",
         "n_pc", "blk_cap", "pg_cap", "mk_cap", "sh_cap"]
_FLOATS = ["core_mlp", "accel_mlp", "c2c_lat", "inv_lat", "pf_throttle",
           "ml_thresh", "migcost", "ta_low", "ta_high", "ta_pref",
           "ta_stream", "ta_bypass", "hl1", "hl2", "hl3"]
_TRACE = ["x_r", "x_a", "x_w", "x_ten", "x_reu", "x_pc", "x_f1",
          "x_blk_slot", "x_pg_slot", "blk_tab"]
_STATE = ["l1h", "l1m", "l1pu", "l2h", "l2m", "l2pu", "l3h", "l3m", "l3pu",
          "dirm", "diro", "dinv", "dc2c", "dupg",
          "pgk", "pgh", "pgp", "pge", "pgl", "epoch", "sdec", "hpg",
          "mig", "migb", "migs",
          "sta", "sts", "stc", "sai", "sau", "stp", "sti",
          "mhl", "mhb", "mk1", "mk2", "mk3", "mkc", "mkd", "mko",
          "wpc", "wd1", "wd2", "wbs", "mli", "mlt",
          "time", "lat", "nacc", "wbl", "pfd", "flags", "probes"]

#: (name, kind) of every 8-byte LaneDesc slot, in declaration order:
#: kind "i" int64 value, "f" float64 value, "p" device address
DESC_FIELDS: List[Tuple[str, str]] = (
    [(k, "i") for k in _INTS] + [(k, "f") for k in _FLOATS]
    + [(k, "p") for k in _TRACE]
    + [(f"{lv}.{m}", "i" if m in _LEVEL_STATIC else "p")
       for lv in ("l1", "l2", "l3") for m in _LEVEL]
    + [(f"{ch}.{m}", "f" if m in _CHAN_FLOAT else
        ("i" if m == "rbb" else "p"))
       for ch in ("d", "h") for m in _CHAN]
    + [(f"{p}.{m}", "i" if m in _LDICT_STATIC else "p")
       for p in ("sp", "mp") for m in _LDICT]
    + [(k, "p") for k in _STATE])


def _state_name(field: str) -> str:
    """Desc field → ``state_spec`` array name (``l1.ctr`` → ``l1_ctr``,
    ``sp.pk`` → ``sppk``, ``d.b`` → ``db``)."""
    if "." not in field:
        return field
    pre, m = field.split(".")
    if pre in ("l1", "l2", "l3") and len(m) > 1:
        return f"{pre}_{m}"
    return pre + m


def _desc_row(lane: "E.Lane") -> np.ndarray:
    S, cfg, prep = lane.S, lane.cfg, lane.prep
    ints = {"n": len(lane.xs["r"]), "n_req": S.n_req, "n_cores": S.n_cores,
            "has_l3": S.has_l3, "mesi": S.mesi, "pf_on": S.pf_on,
            "ml_on": S.ml_on, "hybrid": S.hybrid, "nten": S.nten,
            "st_deg": S.st_deg, "ml_tsize": S.ml_tsize,
            "ml_hist": S.ml_hist, "ta_sample": S.ta_sample,
            "ta_shadow": S.ta_shadow, "st_conf": cfg["st_conf"],
            "hp_hot": cfg["hp_hot"], "hp_window": cfg["hp_window"],
            "ta_decay": cfg["ta_decay"], "n_pc": prep.n_pc,
            "blk_cap": len(prep.blk_tab), "pg_cap": prep.pg_cap,
            "mk_cap": prep.mk_cap,
            "sh_cap": E.pow2_at_least(4 * S.ta_shadow)}
    for i, lv in enumerate(("l1", "l2", "l3")):
        s = (S.s1, S.s2, S.s3)[i]
        ints.update({f"{lv}.S": s, f"{lv}.A": (S.a1, S.a2, S.a3)[i],
                     f"{lv}.sb": (S.s1b, S.s2b, S.s3b)[i],
                     f"{lv}.ta": (S.ta1, S.ta2, S.ta3)[i]})
    for p, pool, hcap, nv in (("sp", E.SP_POOL, E.SP_HASH, 1),
                              ("mp", E.MP_POOL, E.MP_HASH, 3)):
        ints.update({f"{p}.pool": pool, f"{p}.hcap": hcap, f"{p}.nv": nv})
    ints.update({"d.rbb": S.d_rbb, "h.rbb": S.h_rbb})
    floats = {k: cfg[k] for k in _FLOATS if k in cfg}
    floats.update({"core_mlp": S.core_mlp, "accel_mlp": S.accel_mlp,
                   "c2c_lat": S.c2c_lat, "inv_lat": S.inv_lat,
                   "pf_throttle": S.pf_throttle})
    for ch in ("d", "h"):
        for m in ("bl", "rhl", "bw", "gap"):
            floats[f"{ch}.{m}"] = getattr(S, f"{ch}_{m}")
    ptrs = {f"x_{k}": v.data_ptr() for k, v in lane.xs.items()}
    ptrs["blk_tab"] = lane.blk_tab.data_ptr()
    row = np.zeros(len(DESC_FIELDS), np.int64)
    for j, (name, kind) in enumerate(DESC_FIELDS):
        if kind == "i":
            row[j] = int(ints[name])
        elif kind == "f":
            row[j] = np.float64(floats[name]).view(np.int64)
        elif name in ptrs:
            row[j] = ptrs[name]
        else:
            t = lane.st.get(_state_name(name))
            row[j] = t.data_ptr() if t is not None else 0
    return row


def sim_step(lanes: Sequence["E.Lane"]) -> None:
    """Run every lane over its trace columns ``lane.xs``, updating its
    state in place.  Columns sliced to a window of the trace run that
    window from whatever state the lane holds.

    CUDA lanes: one launch of the step kernel, one warp per lane, on the
    current stream.  CPU lanes: the plain step, lane by lane.
    """
    if not lanes:
        return
    device = lanes[0].st["time"].device
    if any(lane.st["time"].device != device for lane in lanes):
        raise ValueError("sim_step: all lanes must live on one device")
    if device.type == "cpu":
        from repro_torch.core.step_plain import run_lane
        for lane in lanes:
            run_lane(lane)
        return
    from repro_torch.kernels import _lib
    desc = torch.from_numpy(np.stack([_desc_row(lane) for lane in lanes])
                            ).to(device)
    lib = _lib.load("sim_step")
    stream = torch.cuda.current_stream(device)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record(stream)
    err = lib.sim_step_launch(desc.data_ptr(), ctypes.c_int64(len(lanes)),
                              stream.cuda_stream)
    _lib.check(err, "sim_step")
    sim_step.launches += 1
    t1.record(stream)
    stream.synchronize()
    sim_step.last_ms = t0.elapsed_time(t1)


sim_step.launches = 0
#: device time of the last launch (CUDA events), milliseconds
sim_step.last_ms = None
