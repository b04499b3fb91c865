"""Batched hierarchy engine: PyTorch state, one hand-written step kernel.

The port of ``repro.core.engine_jax``.  All simulator state (tag stores,
MESI directory, prefetcher tables, tensor-aware buckets, hybrid-memory
page heat) lives in fixed-capacity int64/float64 tensors on an explicit
``device``, in the reference's layout:

* a frozen open-addressing table of all trace blocks (built here in
  numpy) gives every directory lookup a precomputed slot;
* the hybrid-memory page table decays lazily per page in closed form;
* bounded linked dicts (slot pool + hash with backshift deletion) hold
  the prefetcher pending tables.

Every lane (one config × one trace) carries its own structural knobs as
data, so lanes of different shape buckets and different traces run in
one launch of the whole-trace step kernel ``kernels.sim_step``.  On the
CPU the same wrapper runs the plain PyTorch step (``core.step_plain``),
which is what the tests hold against ``engine_jax`` and the SoA engine.
A fixed-capacity table that overflows raises ``TorchEngineOverflow``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import pack
# ``Metrics`` for one lane of a run: the engine's public name for it
from repro_torch.core.metrics import metrics_from_outputs  # noqa: F401

EMPTY = -(1 << 62)     # hash-slot "no key" sentinel
PROBE = 32             # linear-probe window (overflow-flagged)

# overflow-flag bits (checked after the run)
F_PAGE, F_MK, F_LD, F_SHADOW, F_BLK, F_POOL = 1, 2, 4, 8, 16, 32
FLAG_NAMES = {F_PAGE: "page table", F_MK: "markov table",
              F_LD: "pending-dict hash", F_SHADOW: "shadow hash",
              F_BLK: "block table probe", F_POOL: "pending pool"}

SP_POOL, SP_HASH = 4100, 16384       # stride pending: cap 4096 (+put slack)
MP_POOL, MP_HASH = 2052, 8192        # ML pending: cap 2048

#: counts of the last ``run_cells`` call: kernel launches and the probes
#: the step made through the tag-probe routine
last_run_stats: Dict[str, int] = {}


class TorchEngineError(RuntimeError):
    pass


class TorchEngineUnsupported(TorchEngineError):
    """Configuration/trace outside the engine's static envelope."""


class TorchEngineOverflow(TorchEngineError):
    """A fixed-capacity table overflowed at runtime (never silent)."""


def resolve_device(device: Optional[str]) -> torch.device:
    """The card unless the caller asks for the CPU; no silent fallback."""
    if device is None or str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            raise TorchEngineError(
                "no CUDA device: the port runs on the GPU unless the "
                "caller asks for the CPU (device='cpu', CLI --device cpu)")
        return torch.device(device or "cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# static / per-lane config split
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Structural knobs of one lane (data to the step kernel)."""

    n_req: int
    n_cores: int
    s1: int
    a1: int
    s2: int
    a2: int
    s3: int
    a3: int
    has_l3: bool
    mesi: bool
    pf_on: bool
    ml_on: bool
    ta1: bool
    ta2: bool
    ta3: bool
    hybrid: bool
    nten: int
    st_tsize: int
    st_deg: int
    ml_tsize: int
    ml_hist: int
    hbm_pages_max: int
    ta_sample: int
    ta_shadow: int
    d_bl: float
    d_rhl: float
    d_bw: float
    d_gap: float
    d_rbb: int
    h_bl: float
    h_rhl: float
    h_bw: float
    h_gap: float
    h_rbb: int
    core_mlp: float
    accel_mlp: float
    c2c_lat: float
    inv_lat: float
    pf_throttle: float

    @property
    def s1b(self) -> int:
        return (self.s1 - 1).bit_length()

    @property
    def s2b(self) -> int:
        return (self.s2 - 1).bit_length()

    @property
    def s3b(self) -> int:
        return (self.s3 - 1).bit_length() if self.has_l3 else 0


def split_config(sp, nten: int) -> Tuple[StaticConfig, Dict[str, float]]:
    """Lower a SystemParams to (StaticConfig, per-lane knob dict)."""
    packed = pack.pack_config_sp(sp, nten)
    if packed is None:
        raise TorchEngineUnsupported(
            f"{sp.name}: outside the array-engine envelope "
            f"(see core/pack.py pack_config_sp)")
    ci, cd = packed
    P = pack
    static = StaticConfig(
        n_req=int(ci[P.CI_NREQ]), n_cores=int(ci[P.CI_NCORES]),
        s1=int(ci[P.CI_S1]), a1=int(ci[P.CI_A1]),
        s2=int(ci[P.CI_S2]), a2=int(ci[P.CI_A2]),
        s3=int(ci[P.CI_S3]), a3=int(ci[P.CI_A3]),
        has_l3=bool(ci[P.CI_HASL3]), mesi=bool(ci[P.CI_MESI]),
        pf_on=bool(ci[P.CI_PFON]), ml_on=bool(ci[P.CI_MLON]),
        ta1=bool(ci[P.CI_TA1]), ta2=bool(ci[P.CI_TA2]),
        ta3=bool(ci[P.CI_TA3]), hybrid=bool(ci[P.CI_HYBRID]),
        nten=int(ci[P.CI_NTEN]), st_tsize=int(ci[P.CI_ST_TSIZE]),
        st_deg=int(ci[P.CI_ST_DEG]), ml_tsize=int(ci[P.CI_ML_TSIZE]),
        ml_hist=int(ci[P.CI_ML_HIST]),
        hbm_pages_max=int(ci[P.CI_HBM_PAGES_MAX]),
        ta_sample=int(ci[P.CI_TA_SAMPLE]),
        ta_shadow=int(ci[P.CI_TA_SHADOW]),
        d_bl=float(cd[P.CD_D_BL]), d_rhl=float(cd[P.CD_D_RHL]),
        d_bw=float(cd[P.CD_D_BW]), d_gap=float(cd[P.CD_D_GAP]),
        d_rbb=int(cd[P.CD_D_RBB]),
        h_bl=float(cd[P.CD_H_BL]), h_rhl=float(cd[P.CD_H_RHL]),
        h_bw=float(cd[P.CD_H_BW]), h_gap=float(cd[P.CD_H_GAP]),
        h_rbb=int(cd[P.CD_H_RBB]),
        core_mlp=float(cd[P.CD_CORE_MLP]),
        accel_mlp=float(cd[P.CD_ACCEL_MLP]),
        c2c_lat=float(cd[P.CD_C2C]), inv_lat=float(cd[P.CD_INV]),
        pf_throttle=float(cd[P.CD_PF_THROTTLE]),
    )
    cfg = {
        "st_conf": int(ci[P.CI_ST_CONF]),
        "hp_hot": int(ci[P.CI_HP_HOT]),
        "hp_window": int(ci[P.CI_HP_WINDOW]),
        "ta_decay": int(ci[P.CI_TA_DECAY]),
        "ml_thresh": float(cd[P.CD_ML_THRESH]),
        "migcost": float(cd[P.CD_HP_MIGCOST]),
        "ta_low": float(cd[P.CD_TA_LOW]),
        "ta_high": float(cd[P.CD_TA_HIGH]),
        "ta_pref": float(cd[P.CD_TA_PREF]),
        "ta_stream": float(cd[P.CD_TA_STREAM]),
        "ta_bypass": float(cd[P.CD_TA_BYPASS]),
        "hl1": float(ci[P.CI_HL1]),
        "hl2": float(ci[P.CI_HL2]),
        "hl3": float(ci[P.CI_HL3]),
    }
    return static, cfg


# ---------------------------------------------------------------------------
# host-side trace preparation (numpy): pc ids, frozen block/page tables
# ---------------------------------------------------------------------------
def np_hash64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x).astype(np.uint64)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
    return x


def pow2_at_least(n: int) -> int:
    c = 16
    while c < n:
        c <<= 1
    return c


def _build_table(keys: np.ndarray, cap: int) -> np.ndarray:
    """Open-addressing insert of unique ``keys`` into a power-of-two
    table, grown until every occupied run is shorter than the probe
    window (so windowed probes are exact for present and absent keys)."""
    while True:
        tab = np.full(cap, EMPTY, np.int64)
        mask = cap - 1
        homes = (np_hash64(keys) & np.uint64(mask)).astype(np.int64)
        ok = True
        for k, i in zip(keys.tolist(), homes.tolist()):
            steps = 0
            while tab[i] != EMPTY:
                i = (i + 1) & mask
                steps += 1
                if steps >= PROBE:
                    ok = False
                    break
            if not ok:
                break
            tab[i] = k
        if ok:
            empties = np.flatnonzero(tab == EMPTY)
            if len(empties):
                runs = np.diff(empties) - 1
                wrap = empties[0] + (cap - 1 - empties[-1])
                longest = int(max(runs.max(initial=0), wrap))
                if longest < PROBE - 1:
                    return tab
        cap <<= 1


def _lookup_slots(tab: np.ndarray, keys: np.ndarray) -> np.ndarray:
    occupied = np.flatnonzero(tab != EMPTY)
    order = np.argsort(tab[occupied])
    sorted_keys = tab[occupied][order]
    pos = np.searchsorted(sorted_keys, keys)
    return occupied[order][pos].astype(np.int64)


class PreparedTrace:
    """Trace columns + host-derived slot columns and frozen tables."""

    def __init__(self, static: StaticConfig, trace: Dict):
        core = np.asarray(trace["core"], np.int64)
        pc = np.asarray(trace["pc"], np.int64)
        addr = np.asarray(trace["addr"], np.int64)
        write = np.asarray(trace["write"], bool)
        tensor = np.asarray(trace["tensor"], np.int64)
        reuse = np.asarray(trace["reuse"], np.int64)
        n = len(core)
        if np.any(addr < 0):
            raise TorchEngineUnsupported("negative addresses unsupported")

        upc, pc_id = np.unique(pc, return_inverse=True)
        self.n_pc = len(upc)
        if static.pf_on and self.n_pc > min(static.st_tsize, 512):
            raise TorchEngineUnsupported(
                f"{self.n_pc} distinct PCs exceeds the dense prefetcher "
                f"table bound {min(static.st_tsize, 512)}")

        blocks = addr >> 6
        ublk = np.unique(blocks)
        self.blk_tab = _build_table(
            ublk, pow2_at_least(max(1024, 3 * len(ublk))))
        blk_slot = _lookup_slots(self.blk_tab, blocks)

        pages = addr >> 12
        upage = np.unique(pages)
        self.pg_tab = _build_table(
            upage, pow2_at_least(max(2048, 8 * len(upage))))
        self.pg_cap = len(self.pg_tab)
        pg_slot = _lookup_slots(self.pg_tab, pages)
        if static.hybrid and static.hbm_pages_max <= self.pg_cap:
            raise TorchEngineUnsupported(
                "HBM capacity within page-table reach: the cold-page "
                "eviction path would be live (unported)")

        if static.pf_on and static.ml_on:
            f1 = np.array([(int(p) * 2654435761) % static.ml_tsize
                           for p in pc.tolist()], np.int64)
        else:
            f1 = np.zeros(n, np.int64)

        self.n = n
        cols = {"r": core, "a": addr, "w": write, "ten": tensor,
                "reu": reuse, "pc": pc_id, "f1": f1, "blk_slot": blk_slot,
                "pg_slot": pg_slot}
        self.xs = {k: np.ascontiguousarray(v, np.int64)
                   for k, v in cols.items()}
        # markov capacity per requester.  The paper-scale traces hold up
        # to ~104k distinct (pc, d1, d2) keys per requester (transformer,
        # scale 1.0), past engine_jax's 65536 ceiling; n // 2 keeps the
        # load under ~0.2, where a 32-slot window does not run out
        self.mk_cap = pow2_at_least(max(4096, n // 2))


# ---------------------------------------------------------------------------
# state: one int64 and one float64 arena per lane, named views into them
# ---------------------------------------------------------------------------
def _cache_spec(p: str, inst: int, S: int, A: int) -> list:
    n = inst * S * A
    return ([(p + c, "i", (n,), 0) for c in "tvdpun"]
            + [(p + c, "f", (n,), 0.0) for c in "lr"]
            + [(p + "q", "i", (n,), 0)]
            + [(p + c, "i", (1,), 0) for c in ("_ctr", "_ev", "_dev", "_pf")])


def _ta_spec(p: str, inst: int, nten: int, shadow: int) -> list:
    return [(p + "_bkt", "f", (inst, nten), 3.0),
            (p + "_utl", "f", (inst, nten), 1.0),
            (p + "_fil", "i", (inst, nten), 0),
            (p + "_hit", "i", (inst, nten), 0),
            (p + "_ref", "i", (inst, nten), 0),
            (p + "_sin", "i", (inst,), 0),
            (p + "_shr", "i", (inst, shadow), 0),
            (p + "_shl", "i", (inst,), 0),
            (p + "_shh", "i", (inst,), 0),
            (p + "_shk", "i", (inst, pow2_at_least(4 * shadow)), EMPTY)]


def _ldict_spec(p: str, R: int, pool: int, hcap: int, nv: int) -> list:
    return [(p + "pk", "i", (R, pool), 0),
            (p + "pv", "i", (R, pool, nv), 0),
            (p + "prv", "i", (R, pool), -1),
            (p + "nxt", "i", (R, pool), -1),
            (p + "hd", "i", (R,), -1),
            (p + "tl", "i", (R,), -1),
            (p + "cnt", "i", (R,), 0),
            (p + "fs", "i", (R, pool), "arange"),
            (p + "ft", "i", (R,), pool),
            (p + "hk", "i", (R, hcap), EMPTY),
            (p + "hv", "i", (R, hcap), 0)]


def state_spec(S: StaticConfig, prep: PreparedTrace) -> list:
    """(name, 'i'|'f', shape, initial value) of every state array — the
    same arrays ``engine_jax.init_state`` builds (bools and the int32
    markov columns are int64 here)."""
    R, P = S.n_req, prep.n_pc
    sp = _cache_spec("l1", R, S.s1, S.a1) + _cache_spec("l2", R, S.s2, S.a2)
    if S.has_l3:
        sp += _cache_spec("l3", 1, S.s3, S.a3)
        sp += [(k, "i", (1,), 0) for k in ("l3h", "l3m", "l3pu")]
    for lv, ta, inst in (("l1", S.ta1, R), ("l2", S.ta2, R),
                         ("l3", S.ta3, 1)):
        if ta:
            sp += _ta_spec(lv, inst, S.nten, S.ta_shadow)
    sp += [(k, "i", (R,), 0)
           for k in ("l1h", "l1m", "l1pu", "l2h", "l2m", "l2pu")]
    nblk = len(prep.blk_tab)
    if S.mesi:
        sp += [("dirm", "i", (nblk,), 0), ("diro", "i", (nblk,), -1)]
        sp += [(k, "i", (1,), 0) for k in ("dinv", "dc2c", "dupg")]
    sp += [("db", "f", (1,), 0.0), ("ds", "f", (1,), 0.0)]
    sp += [(k, "i", (1,), 0) for k in ("dby", "dac", "drh")]
    sp += [("dop", "i", (8,), -1)]
    if S.hybrid:
        pg = prep.pg_cap
        sp += [("hb", "f", (1,), 0.0), ("hs", "f", (1,), 0.0)]
        sp += [(k, "i", (1,), 0) for k in ("hby", "hac", "hrh")]
        sp += [("hop", "i", (8,), -1), ("pgk", "i", (pg,), "pg_tab")]
        sp += [(k, "i", (pg,), 0) for k in ("pgh", "pgp", "pge", "pgl")]
        sp += [(k, "i", (1,), 0) for k in ("epoch", "sdec", "hpg")]
    sp += [("mig", "i", (1,), 0), ("migb", "i", (1,), 0),
           ("migs", "f", (1,), 0.0)]
    if S.pf_on:
        sp += [(k, "i", (R, P), 0)
               for k in ("sta", "sts", "stc", "sai", "sau", "stp")]
        sp += [("sti", "i", (R,), 0)]
        sp += _ldict_spec("sp", R, SP_POOL, SP_HASH, 1)
        if S.ml_on:
            mk = prep.mk_cap
            sp += [("mhl", "i", (R, P), 0), ("mhb", "i", (R, P, 9), 0),
                   ("mk1", "i", (R, mk), -1), ("mk2", "i", (R, mk), 0),
                   ("mk3", "i", (R, mk), 0), ("mkc", "i", (R, mk), 0),
                   ("mkd", "i", (R, mk, 9), 0), ("mko", "i", (R, mk, 9), 0)]
            sp += [(k, "f", (R, S.ml_tsize), 0.0)
                   for k in ("wpc", "wd1", "wd2")]
            sp += [("wbs", "f", (R,), 0.0)]
            sp += _ldict_spec("mp", R, MP_POOL, MP_HASH, 3)
            sp += [("mli", "i", (R,), 0), ("mlt", "i", (R,), 0)]
    sp += [("time", "f", (R,), 0.0), ("lat", "f", (1,), 0.0)]
    sp += [(k, "i", (1,), 0)
           for k in ("nacc", "wbl", "pfd", "flags", "probes")]
    return sp


def init_state(S: StaticConfig, prep: PreparedTrace,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Allocate a lane's arenas on ``device`` and return named views,
    initialised as ``engine_jax.init_state`` initialises its arrays."""
    spec = state_spec(S, prep)
    sizes = {"i": 0, "f": 0}
    offs = []
    for name, kind, shape, _ in spec:
        n = int(np.prod(shape))
        offs.append(sizes[kind])
        sizes[kind] += n
    arena = {"i": torch.zeros(sizes["i"], dtype=torch.int64, device=device),
             "f": torch.zeros(sizes["f"], dtype=torch.float64,
                              device=device)}
    st: Dict[str, torch.Tensor] = {}
    for (name, kind, shape, init), off in zip(spec, offs):
        n = int(np.prod(shape))
        v = arena[kind][off:off + n].view(shape)
        if isinstance(init, str):
            if init == "arange":
                v.copy_(torch.arange(shape[-1], dtype=torch.int64,
                                     device=device).expand(shape))
            else:   # the frozen page table of the trace
                v.copy_(torch.from_numpy(prep.pg_tab).to(device))
        elif init != 0:
            v.fill_(init)
        st[name] = v
    return st


# ---------------------------------------------------------------------------
# counter export (oi[98]/od[10], the reference engines' layout)
# ---------------------------------------------------------------------------
def export(S: StaticConfig, st: Dict[str, torch.Tensor]
           ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """One lane's ``(oi, od, flags, probes)`` from its final state."""
    R = S.n_req
    h = {k: v.cpu().numpy() for k, v in st.items() if v.numel() <= 64}
    oi = np.zeros(98, np.int64)
    od = np.zeros(10, np.float64)

    def one(k):
        return h[k][0]

    oi[0], oi[1], oi[2] = one("nacc"), one("wbl"), one("pfd")
    if S.mesi:
        oi[3], oi[4], oi[5] = one("dinv"), one("dc2c"), one("dupg")
    oi[6], oi[7] = one("mig"), one("migb")
    oi[8], oi[9], oi[10] = one("dby"), one("drh"), one("dac")
    if S.hybrid:
        oi[11], oi[12], oi[13] = one("hby"), one("hrh"), one("hac")
    oi[14], oi[15], oi[16] = one("l1_ev"), one("l1_dev"), one("l1_pf")
    oi[17], oi[18], oi[19] = one("l2_ev"), one("l2_dev"), one("l2_pf")
    if S.has_l3:
        oi[20], oi[21], oi[22] = one("l3_ev"), one("l3_dev"), one("l3_pf")
        oi[23], oi[24], oi[25] = one("l3h"), one("l3m"), one("l3pu")
    for base, k in ((26, "l1h"), (34, "l1m"), (42, "l1pu"), (50, "l2h"),
                    (58, "l2m"), (66, "l2pu")):
        oi[base:base + R] = h[k]
    if S.pf_on:
        oi[74:74 + R] = h["sti"]
        if S.ml_on:
            oi[82:82 + R] = h["mli"]
            oi[90:90 + R] = h["mlt"]
    od[0:R] = h["time"]
    od[8], od[9] = one("lat"), one("migs")
    return oi, od, int(one("flags")), int(one("probes"))


def step_bytes(S: StaticConfig, n: int, oi: np.ndarray) -> int:
    """Bytes one lane's step must move for this run's accesses: six
    trace columns per access, the pc columns on L1 misses of prefetching
    lanes, the block slot on L2 misses of MESI lanes, and oi/od out."""
    l1m, l2m = int(oi[34:42].sum()), int(oi[58:66].sum())
    cols = 6 * n
    if S.pf_on:
        cols += l1m * (2 if S.ml_on else 1)
    if S.mesi:
        cols += l2m
    return 8 * cols + 98 * 8 + 10 * 8


def check_flags(flags: int) -> None:
    if flags:
        hit = [name for bit, name in FLAG_NAMES.items() if flags & bit]
        raise TorchEngineOverflow(
            "fixed-capacity table overflow in torch engine: "
            + ", ".join(hit))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def nten_of(trace: Dict) -> int:
    tensor = np.asarray(trace["tensor"])
    return int(tensor.max()) + 1 if len(tensor) else 1


@dataclasses.dataclass
class Lane:
    """One config × one trace: what the step (kernel or plain) runs."""

    S: StaticConfig
    cfg: Dict[str, float]
    prep: PreparedTrace
    st: Dict[str, torch.Tensor]
    xs: Dict[str, torch.Tensor]
    blk_tab: torch.Tensor


def build_lanes(cells: Sequence[Tuple[object, Dict]],
                device: torch.device) -> List[Lane]:
    """Host prep + device state for each (SystemParams, trace) cell.
    Cells that share a trace object and the knobs that shape its prep
    share one PreparedTrace and its device columns."""
    shared: Dict[tuple, tuple] = {}
    lanes = []
    for sp, trace in cells:
        S, cfg = split_config(sp, nten_of(trace))
        key = (id(trace), S.pf_on, S.ml_on, S.ml_tsize, S.st_tsize,
               S.hybrid, S.hbm_pages_max)
        if key not in shared:
            prep = PreparedTrace(S, trace)
            xs = {k: torch.from_numpy(v).to(device)
                  for k, v in prep.xs.items()}
            shared[key] = (prep, xs,
                           torch.from_numpy(prep.blk_tab).to(device))
        prep, xs, blk = shared[key]
        lanes.append(Lane(S, cfg, prep, init_state(S, prep, device), xs,
                          blk))
    return lanes


def run_cells(cells: Sequence[Tuple[object, Dict]],
              device: Optional[str] = None
              ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Run every (SystemParams, trace) cell; on the card all lanes are in
    flight in one launch of the step kernel.  Returns ``(oi, od)`` per
    cell in input order; a lane whose tables overflowed raises."""
    from repro_torch.kernels import sim_step as sim_step_mod
    dev = resolve_device(device)
    t0 = time.perf_counter()
    lanes = build_lanes(cells, dev)
    t1 = time.perf_counter()
    launches0 = sim_step_mod.sim_step.launches
    sim_step_mod.sim_step(lanes)
    t2 = time.perf_counter()
    out, probes, nbytes = [], 0, 0
    for lane in lanes:
        oi, od, flags, n_probes = export(lane.S, lane.st)
        check_flags(flags)
        probes += n_probes
        nbytes += step_bytes(lane.S, lane.prep.n, oi)
        out.append((oi, od))
    last_run_stats.clear()
    last_run_stats.update({
        "lanes": len(lanes),
        "sim_step_launches": sim_step_mod.sim_step.launches - launches0,
        "tag_probe_main_path_probes": probes,
        "accesses": sum(lane.prep.n for lane in lanes),
        "step_bytes": nbytes,
        "host_prep_s": t1 - t0,
        "step_s": t2 - t1,
        "kernel_ms": (sim_step_mod.sim_step.last_ms if dev.type == "cuda"
                      else None),
    })
    return out


def run_single(sp, trace: Dict, device: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """One config through the engine; ``(oi, od)`` export vectors."""
    return run_cells([(sp, trace)], device)[0]


def run_batch(sps: List, trace: Dict, device: Optional[str] = None
              ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """N configs against one trace, one lane each, results in input
    order (shape buckets mix freely: structure is per-lane data)."""
    return run_cells([(sp, trace) for sp in sps], device)

