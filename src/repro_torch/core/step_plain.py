"""Plain PyTorch version of the step: one access of one lane per call.

A transcription of ``_make_step`` (``repro/core/engine_jax.py``) onto the
lane state of ``core.engine_torch``.  The reference evaluates every path
under a predicate (``jnp.where`` masks, ``.at[i].set`` writes,
``lax.while_loop``); here a predicate that guards a whole operation is an
``if`` (a masked operation whose predicate is false changes nothing),
``.at[i].set`` is an in-place indexed write and ``while_loop`` a Python
``while``.  Scalars read out of the state are Python ints and floats,
whose arithmetic is the same IEEE float64 in the same order.  Every set
probe and insert goes through ``kernels.tag_probe.tag_probe_plain`` on
the set's row, as the step kernel calls its probe routine.

It is the reference the step kernel (``csrc/sim_step.cu``) is held to on
the card, and what ``run_cells(..., device="cpu")`` runs: not a fast path.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.engine_torch import (EMPTY, F_LD, F_MK, F_PAGE,
                                           F_POOL, F_SHADOW, PROBE, Lane)
from repro_torch.kernels.tag_probe import tag_probe_plain

M64 = (1 << 64) - 1


def h64(x: int) -> int:
    """The uint64 mixing hash of ``engine_jax._h64j`` (two's complement
    view of an int64 key)."""
    x &= M64
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & M64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & M64
    x ^= x >> 33
    return x


def pmod(v: int, m: int) -> int:
    """``jnp.mod(v * 2654435761, m)`` (floor mod, as Python's)."""
    return (v * 2654435761) % m


def probe(keys: torch.Tensor, key: int):
    """Windowed linear probe of a 1-D key table.
    Returns (slot, found, insert_ok, window_exhausted)."""
    cap = keys.shape[0]
    home = h64(key) & (cap - 1)
    for j in range(PROBE):
        i = (home + j) & (cap - 1)
        k = keys[i].item()
        if k == key:
            return i, True, False, False
        if k == EMPTY:
            return i, False, True, False
    return home, False, False, True


def backshift(hk: torch.Tensor, hv, slot: int) -> None:
    """Backshift deletion at ``slot`` keeping probe chains intact."""
    mask = hk.shape[0] - 1
    i = j = slot
    while True:
        j = (j + 1) & mask
        kj = hk[j].item()
        if kj == EMPTY:
            break
        home = h64(kj) & mask
        if ((i - home) & mask) <= ((j - home) & mask):
            hk[i] = kj
            if hv is not None:
                hv[i] = hv[j]
            i = j
    hk[i] = EMPTY


def decay_closed(h: int, p: int, k: int, half: int):
    """k lazy decay rounds in closed form (see engine_jax)."""
    hf = h >> min(max(k, 0), 63)
    bumps = min(k, (h // max(half, 1)).bit_length())
    return hf, (p + bumps if hf > 0 else 0)


class PlainStep:
    """The step of one lane; ``access`` runs one trace entry."""

    def __init__(self, lane: Lane):
        self.S, self.cfg, self.st = lane.S, lane.cfg, lane.st
        self.blk_tab = lane.blk_tab
        S = self.S
        self.lvl = {"l1": (S.a1, S.s1, S.s1b, S.ta1),
                    "l2": (S.a2, S.s2, S.s2b, S.ta2),
                    "l3": (S.a3, S.s3, S.s3b, S.ta3)}
        self.probes = 0

    # ---- small helpers --------------------------------------------------
    def flag(self, bit: int) -> None:
        self.st["flags"][0] |= bit

    def add(self, name: str, idx, v=1) -> None:
        self.st[name][idx] += v

    # ---- linked dict (FIFO-capped map) ----------------------------------
    def ld_pop(self, p, rr, key):
        st = self.st
        slot, found, _, ovf = probe(st[p + "hk"][rr], key)
        if ovf:
            self.flag(F_LD)
        if not found:
            return False, None
        pi = st[p + "hv"][rr, slot].item()
        val = st[p + "pv"][rr, pi].tolist()
        backshift(st[p + "hk"][rr], st[p + "hv"][rr], slot)
        self._ld_unlink(p, rr, pi)
        return True, val

    def _ld_unlink(self, p, rr, pi):
        st = self.st
        prv = st[p + "prv"][rr, pi].item()
        nxt = st[p + "nxt"][rr, pi].item()
        if prv >= 0:
            st[p + "nxt"][rr, prv] = nxt
        else:
            st[p + "hd"][rr] = nxt
        if nxt >= 0:
            st[p + "prv"][rr, nxt] = prv
        else:
            st[p + "tl"][rr] = prv
        ft = st[p + "ft"][rr].item()
        st[p + "fs"][rr, min(ft, st[p + "fs"].shape[1] - 1)] = pi
        st[p + "ft"][rr] = ft + 1
        st[p + "cnt"][rr] -= 1

    def ld_put(self, p, rr, key, vals):
        st = self.st
        slot, found, can_ins, ovf = probe(st[p + "hk"][rr], key)
        if ovf or (not found and not can_ins):
            self.flag(F_LD)
        new = not found
        ft = st[p + "ft"][rr].item()
        if new and ft <= 0:
            self.flag(F_POOL)
        if found:
            pi = st[p + "hv"][rr, slot].item()
        else:
            pi = st[p + "fs"][rr, max(ft - 1, 0)].item()
            st[p + "ft"][rr] = ft - 1
        st[p + "pk"][rr, pi] = key
        st[p + "pv"][rr, pi] = torch.tensor(vals, dtype=torch.int64)
        if new:
            tl = st[p + "tl"][rr].item()
            st[p + "prv"][rr, pi] = tl
            st[p + "nxt"][rr, pi] = -1
            if tl >= 0:
                st[p + "nxt"][rr, tl] = pi
            else:
                st[p + "hd"][rr] = pi
            st[p + "tl"][rr] = pi
            st[p + "cnt"][rr] += 1
            st[p + "hk"][rr, slot] = key
            st[p + "hv"][rr, slot] = pi

    def ld_evict(self, p, rr):
        """Evict the FIFO-oldest entry (caller checked the length)."""
        st = self.st
        if st[p + "cnt"][rr].item() <= 0:
            return False, None
        pi = max(st[p + "hd"][rr].item(), 0)
        key = st[p + "pk"][rr, pi].item()
        val = st[p + "pv"][rr, pi].tolist()
        slot, found, _, ovf = probe(st[p + "hk"][rr], key)
        if ovf or not found:
            self.flag(F_LD)
        if found:
            backshift(st[p + "hk"][rr], st[p + "hv"][rr], slot)
        self._ld_unlink(p, rr, pi)
        return True, val

    # ---- tensor-aware shadow / bucket machinery -------------------------
    def ta_bucket_upd(self, lv, inst, t, all_rows):
        st, cfg, S = self.st, self.cfg, self.S
        rows = torch.arange(S.nten) if all_rows else torch.tensor([t])
        f_ = st[lv + "_fil"][inst, rows].to(torch.float64)
        num = (st[lv + "_hit"][inst, rows]
               + S.ta_sample * st[lv + "_ref"][inst, rows]
               ).to(torch.float64)
        u_ = torch.where(f_ == 0.0, torch.ones_like(f_),
                         torch.clamp(num / torch.clamp(f_, min=1.0),
                                     max=4.0))
        b_ = torch.where(u_ < cfg["ta_low"], 1.0,
                         torch.where(u_ < cfg["ta_high"], 2.0, 3.0)
                         ).to(torch.float64)
        st[lv + "_utl"][inst, rows] = u_
        st[lv + "_bkt"][inst, rows] = b_

    def ta_hit(self, lv, inst, t):
        self.st[lv + "_hit"][inst, t] += 1
        self.ta_bucket_upd(lv, inst, t, False)

    def ta_fill(self, lv, inst, t, blk):
        st, S = self.st, self.S
        st[lv + "_fil"][inst, t] += 1
        sampled = blk >= 0 and pmod(blk, S.ta_sample) == 0
        if sampled:
            shk = st[lv + "_shk"][inst]
            _, found, _, ovf = probe(shk, blk)
            if ovf:
                self.flag(F_SHADOW)
            if found:
                st[lv + "_ref"][inst, t] += 1
            else:
                if st[lv + "_shl"][inst].item() >= S.ta_shadow:
                    # evict FIFO-oldest from the shadow ring
                    hd = st[lv + "_shh"][inst].item()
                    evk = st[lv + "_shr"][inst, hd].item()
                    es, ef, _, eovf = probe(shk, evk)
                    if eovf or not ef:
                        self.flag(F_SHADOW)
                    if ef:
                        backshift(shk, None, es)
                    st[lv + "_shh"][inst] = (hd + 1) % S.ta_shadow
                    st[lv + "_shl"][inst] -= 1
                ln = st[lv + "_shl"][inst].item()
                hd2 = st[lv + "_shh"][inst].item()
                st[lv + "_shr"][inst, (hd2 + ln) % S.ta_shadow] = blk
                s2_, f2_, ci2, ovf2 = probe(shk, blk)
                if ovf2 or not ci2 or f2_:
                    self.flag(F_SHADOW)
                shk[s2_] = blk
                st[lv + "_shl"][inst] += 1
        st[lv + "_sin"][inst] += 1
        dec = st[lv + "_sin"][inst].item() >= self.cfg["ta_decay"]
        if dec:
            st[lv + "_sin"][inst] = 0
            for k in ("_fil", "_hit", "_ref"):
                st[lv + k][inst] >>= 1
        self.ta_bucket_upd(lv, inst, t, dec)

    # ---- set-associative cache primitives -------------------------------
    def c_probe(self, lv, si, tag):
        """(hit, way) of ``tag`` in set row ``si``."""
        A = self.lvl[lv][0]
        st = self.st
        rows = slice(si * A, (si + 1) * A)
        self.probes += 1
        out = tag_probe_plain(
            st[lv + "t"][rows].view(1, A), st[lv + "v"][rows].view(1, A),
            st[lv + "l"][rows].view(1, A), st[lv + "q"][rows].view(1, A),
            torch.tensor([tag])).view(-1).tolist()
        return bool(out[0]), out[1]

    def c_insert(self, lv, si, sset, tag, blk, ten, reu, now, is_w,
                 prefd, ready):
        """Insert (or refresh) a line; returns (victim, victim_dirty,
        victim_addr) for the caller's writeback."""
        st, cfg = self.st, self.cfg
        A, S_sets, sb, ta_on = self.lvl[lv]
        rows = slice(si * A, (si + 1) * A)
        last = st[lv + "l"][rows]
        inst = si // S_sets
        if ta_on:
            bkt = st[lv + "_bkt"][inst]
            bvals = torch.where(
                st[lv + "p"][rows] != 0, cfg["ta_pref"],
                torch.where(st[lv + "u"][rows] == 0, cfg["ta_stream"],
                            bkt[st[lv + "n"][rows]]))
            last = torch.where(bvals == bvals.min(), last, math.inf)
        self.probes += 1
        hit, way, victim = tag_probe_plain(
            st[lv + "t"][rows].view(1, A), st[lv + "v"][rows].view(1, A),
            last.view(1, A), st[lv + "q"][rows].view(1, A),
            torch.tensor([tag])).view(-1).tolist()
        sl = si * A + way
        vdirty = bool(victim) and st[lv + "d"][sl].item() != 0
        vaddr = ((st[lv + "t"][sl].item() << sb) | sset) << 6
        if victim:
            self.add(lv + "_ev", 0)
        if vdirty:
            self.add(lv + "_dev", 0)
        ctr = st[lv + "_ctr"][0].item()
        for col, val in (("v", 1), ("t", tag), ("d", int(is_w)),
                         ("n", ten), ("u", reu), ("l", now),
                         ("p", int(prefd)), ("r", ready), ("q", ctr)):
            st[lv + col][sl] = val
        st[lv + "_ctr"][0] = ctr + 1
        if prefd:
            self.add(lv + "_pf", 0)
        if ta_on:
            self.ta_fill(lv, inst, ten, blk)
        return bool(victim), vdirty, vaddr

    # ---- memory channels + hybrid page heat -----------------------------
    def chan_access(self, ch, now, addr, spec):
        S, st = self.S, self.st
        bl, rhl, bw, gap_c, rbb = (
            (S.d_bl, S.d_rhl, S.d_bw, S.d_gap, S.d_rbb) if ch == "d"
            else (S.h_bl, S.h_rhl, S.h_bw, S.h_gap, S.h_rbb))
        self.add(ch + "ac", 0)
        self.add(ch + "by", 0, 64)
        bank = (addr // rbb) % 8
        row = addr // (rbb * 8)
        rowhit = st[ch + "op"][bank].item() == row
        if rowhit:
            self.add(ch + "rh", 0)
        else:
            st[ch + "op"][bank] = row
        latc = rhl if rowhit else bl
        gap = 0.0 if rowhit else gap_c
        xfer = 64.0 / bw + gap
        busy = st[ch + "b"][0].item()
        sb_ = st[ch + "s"][0].item()
        if spec:
            start = max(max(now, busy), sb_)
            st[ch + "s"][0] = start + xfer
        else:
            start = max(now, busy)
            nb = start + xfer
            st[ch + "b"][0] = nb
            st[ch + "s"][0] = max(sb_, nb)
        done = start + latc + xfer
        return done, done - now

    def mem_access(self, now, addr, spec, pg_slot):
        S, st, cfg = self.S, self.st, self.cfg
        if not S.hybrid:
            return self.chan_access("d", now, addr, spec)
        half = cfg["hp_hot"] // 2
        if pg_slot is None:
            page = addr >> 12
            slot, found, can_ins, ovf = probe(st["pgk"], page)
            if ovf or (not found and not can_ins):
                self.flag(F_PAGE)
            if not found:
                st["pgk"][slot] = page
        else:
            slot = pg_slot
        k = st["epoch"][0].item() - st["pge"][slot].item()
        h0, p0 = decay_closed(st["pgh"][slot].item(),
                              st["pgp"][slot].item(), k, half)
        h1 = h0 + 1
        sd = st["sdec"][0].item() + 1
        fired = sd >= cfg["hp_window"]
        st["sdec"][0] = 0 if fired else sd
        if fired:
            self.add("epoch", 0)
        h2, p2 = decay_closed(h1, p0, 1 if fired else 0, half)
        st["pgh"][slot] = h2
        st["pgp"][slot] = p2
        st["pge"][slot] = st["epoch"][0].item()
        # promotion check: pre-fire heat, post-fire persist
        if h1 >= cfg["hp_hot"] and p2 >= 2 and st["pgl"][slot].item() != 1:
            st["pgl"][slot] = 1
            self.add("hpg", 0)
            self.add("mig", 0)
            self.add("migb", 0, 4096)
            st["migs"][0] = st["migs"][0].item() + cfg["migcost"]
            st["db"][0] = max(st["db"][0].item(), now) + 4096.0 / S.d_bw
            st["hb"][0] = max(st["hb"][0].item(), now) + 4096.0 / S.h_bw
        use_h = st["pgl"][slot].item() == 1
        return self.chan_access("h" if use_h else "d", now, addr, spec)

    def wb(self, now, vaddr):
        self.add("wbl", 0)
        self.mem_access(now, vaddr, True, None)

    def promote_wait(self, lv, sl, pg_slot, now):
        S, st = self.S, self.st
        remaining = st[lv + "r"][sl].item() - now
        if S.hybrid and st["pgl"][pg_slot].item() == 1:
            promoted = S.h_rhl + 64.0 / S.h_bw
        else:
            promoted = S.d_rhl + 64.0 / S.d_bw
        st[lv + "r"][sl] = 0.0
        return min(max(remaining, 0.0), promoted)

    # ---- MESI directory -------------------------------------------------
    def dir_evict_at(self, slot, rr):
        st = self.st
        m = st["dirm"][slot].item()
        o = st["diro"][slot].item()
        m2 = m & ~(1 << rr)
        o2 = -1 if (o == rr or m2 == 0) else o
        st["dirm"][slot] = m2
        st["diro"][slot] = o2

    # ---- fills ----------------------------------------------------------
    def fill_shared(self, blk, ten, reu, now, is_w):
        S, st = self.S, self.st
        if not S.has_l3:
            return
        if (S.ta3 and reu == 0 and not is_w
                and st["l3_utl"][0, ten].item() < self.cfg["ta_bypass"]):
            return
        s3 = blk & (S.s3 - 1)
        _, vd, va = self.c_insert("l3", s3, s3, blk >> S.s3b, blk, ten,
                                  reu, now, False, False, 0.0)
        if vd:
            self.wb(now, va)

    def fill_private(self, rr, blk, ten, reu, now, is_w):
        S, st = self.S, self.st
        s2 = blk & (S.s2 - 1)
        v2, vd2, va2 = self.c_insert("l2", rr * S.s2 + s2, s2,
                                     blk >> S.s2b, blk, ten, reu, now,
                                     is_w, False, 0.0)
        if S.mesi and v2:
            # victim leaves the private domain only when not in L1
            vblk = va2 >> 6
            s1v = vblk & (S.s1 - 1)
            in_l1, _ = self.c_probe("l1", rr * S.s1 + s1v, vblk >> S.s1b)
            dslot, dfound, _, _ = probe(self.blk_tab, vblk)
            if not in_l1 and dfound:
                self.dir_evict_at(dslot, rr)
        if vd2:
            self.wb(now, va2)
        s1 = blk & (S.s1 - 1)
        _, vd1, va1 = self.c_insert("l1", rr * S.s1 + s1, s1,
                                    blk >> S.s1b, blk, ten, reu, now, is_w,
                                    False, 0.0)
        if vd1:
            vblk1 = va1 >> 6
            s2v = vblk1 & (S.s2 - 1)
            hit2, w2 = self.c_probe("l2", rr * S.s2 + s2v, vblk1 >> S.s2b)
            if hit2:
                st["l2d"][(rr * S.s2 + s2v) * S.a2 + w2] = 1
            else:
                self.wb(now, va1)

    # ---- prefetchers ----------------------------------------------------
    def do_prefetch(self, rr, tgt, ten, reu, now, is_stride):
        S, st, cfg = self.S, self.st, self.cfg
        blk = tgt >> 6
        s2 = blk & (S.s2 - 1)
        in2, _ = self.c_probe("l2", rr * S.s2 + s2, blk >> S.s2b)
        act = not in2
        if S.has_l3:
            s3 = blk & (S.s3 - 1)
            in3, _ = self.c_probe("l3", s3, blk >> S.s3b)
            if is_stride and act and in3:
                # shared-level hit: cheap promote to L2
                _, vd, va = self.c_insert(
                    "l2", rr * S.s2 + s2, s2, blk >> S.s2b, blk, ten, reu,
                    now, False, True, now + cfg["hl3"])
                if vd:
                    self.wb(now, va)
            act = act and not in3
        if not act:
            return
        # throttle on the target channel's speculative backlog
        if S.hybrid:
            page = tgt >> 12
            pslot, pfound, pcan, povf = probe(st["pgk"], page)
            if povf or (not pfound and not pcan):
                self.flag(F_PAGE)
            if not pfound:
                st["pgk"][pslot] = page
            if st["pgl"][pslot].item() == 1:
                backlog = st["hs"][0].item() - st["hb"][0].item()
            else:
                backlog = st["ds"][0].item() - st["db"][0].item()
        else:
            pslot = None
            backlog = st["ds"][0].item() - st["db"][0].item()
        if backlog > S.pf_throttle:
            self.add("pfd", 0)
            return
        done, _ = self.mem_access(now, tgt, True, pslot)
        if not is_stride and S.has_l3:
            s3 = blk & (S.s3 - 1)
            _, vd, va = self.c_insert("l3", s3, s3, blk >> S.s3b, blk, ten,
                                      reu, now, False, True, done)
        else:
            _, vd, va = self.c_insert("l2", rr * S.s2 + s2, s2,
                                      blk >> S.s2b, blk, ten, reu, now,
                                      False, True, done)
        if vd:
            self.wb(now, va)

    def stride_observe(self, rr, pc, a):
        S, st, cfg = self.S, self.st, self.cfg
        popped, val = self.ld_pop("sp", rr, a >> 6)
        if popped:
            st["sau"][rr, val[0]] += 1
        pres = st["stp"][rr, pc].item() != 0
        old_last = st["sta"][rr, pc].item()
        old_st = st["sts"][rr, pc].item()
        old_cf = st["stc"][rr, pc].item()
        strd = a - old_last
        same = pres and strd != 0 and strd == old_st
        if same:
            ncf, nst = min(old_cf + 1, 7), old_st
        elif pres:
            ncf, nst = 0, strd
        else:
            ncf, nst = old_cf, old_st
        st["stp"][rr, pc] = 1
        st["sta"][rr, pc] = a
        st["sts"][rr, pc] = nst if pres else 0
        st["stc"][rr, pc] = ncf if pres else 0
        issue = pres and ncf >= cfg["st_conf"] and nst != 0
        iss = st["sai"][rr, pc].item()
        used = st["sau"][rr, pc].item()
        if issue and iss >= 32 and float(used) / float(max(iss, 1)) < 0.4:
            issue = False
        tgts = [a + nst * k for k in range(1, S.st_deg + 1)]
        if issue:
            for tgt in tgts:
                st["sai"][rr, pc] += 1
                if st["spcnt"][rr].item() > 4096:
                    self.ld_evict("sp", rr)
                self.ld_put("sp", rr, tgt >> 6, [pc])
            st["sti"][rr] += S.st_deg
        return issue, tgts

    def ml_train(self, rr, ff1, ff2, ff3, useful):
        st = self.st
        lr = 0.5 if useful else -0.5
        for w, f in (("wpc", ff1), ("wd1", ff2), ("wd2", ff3)):
            st[w][rr, f] = min(max(st[w][rr, f].item() + lr, -8.0), 8.0)
        st["wbs"][rr] = min(max(st["wbs"][rr].item() + lr * 0.25, -8.0),
                            8.0)
        st["mlt"][rr] += 1

    def mk_probe(self, rr, k1, k2, k3):
        """Probe the per-requester markov table for (k1, k2, k3);
        mk1 == -1 marks a free slot."""
        st = self.st
        cap = st["mk1"].shape[1]
        h = (h64(k1) ^ ((h64(k2) << 1) & M64) ^ ((h64(k3) << 2) & M64))
        home = h & (cap - 1)
        for j in range(PROBE):
            i = (home + j) & (cap - 1)
            a1 = st["mk1"][rr, i].item()
            if (a1 == k1 and st["mk2"][rr, i].item() == k2
                    and st["mk3"][rr, i].item() == k3):
                return i, True, False, False
            if a1 == -1:
                return i, False, True, False
        return home, False, False, True

    def ml_observe(self, rr, pc, ff1, a):
        S, st, cfg = self.S, self.st, self.cfg
        blkm = a >> 6
        popped, pv = self.ld_pop("mp", rr, blkm)
        if popped:
            self.ml_train(rr, pv[0], pv[1], pv[2], True)
        hl = st["mhl"][rr, pc].item()
        hb = st["mhb"][rr, pc].tolist()
        hi = max(hl - 1, 0)
        d_new = blkm - hb[hi]
        key2 = hb[max(hi - 1, 0)] - hb[max(hi - 2, 0)] if hl >= 3 else 0
        key3 = hb[hi] - hb[max(hi - 1, 0)]
        emit, best = False, 0
        if hl >= 2:
            # markov transition update: entry (pc, key2, key3) += d_new
            es, ef, eci, eovf = self.mk_probe(rr, pc, key2, key3)
            if eovf or (not ef and not eci):
                self.flag(F_MK)
            if not ef:
                st["mk1"][rr, es] = pc
                st["mk2"][rr, es] = key2
                st["mk3"][rr, es] = key3
            dr = st["mkd"][rr, es].tolist()
            co = st["mko"][rr, es].tolist()
            cnt = st["mkc"][rr, es].item()
            d32 = _i32(d_new)
            fi = next((j for j in range(9) if j < cnt and dr[j] == d32),
                      None)
            if fi is not None:
                co[fi] += 1
                cnt2 = cnt
            else:
                app_i = min(cnt, 8)
                dr[app_i] = d32
                co[app_i] = 1
                cnt2 = cnt + 1
            if cnt2 > 8:
                cm = [co[j] if j < cnt2 else (1 << 30) for j in range(9)]
                mi = cm.index(min(cm))
                dr = dr[:mi] + [dr[min(j + 1, 8)] for j in range(mi, 9)]
                co = co[:mi] + [co[min(j + 1, 8)] for j in range(mi, 9)]
                cnt2 -= 1
            st["mkd"][rr, es] = torch.tensor(dr, dtype=torch.int64)
            st["mko"][rr, es] = torch.tensor(co, dtype=torch.int64)
            st["mkc"][rr, es] = cnt2
            # candidate lookup (post-update): entry (pc, key3, d_new)
            cs, cf, _, covf = self.mk_probe(rr, pc, key3, d_new)
            if covf:
                self.flag(F_MK)
            ccnt = st["mkc"][rr, cs].item() if cf else 0
            if ccnt > 0:
                cco = st["mko"][rr, cs].tolist()
                bm_ = [cco[j] if j < ccnt else -1 for j in range(9)]
                best = st["mkd"][rr, cs, bm_.index(max(bm_))].item()
            if ccnt > 0 and best != 0:
                f2 = pmod(key3, S.ml_tsize)
                f3 = pmod(d_new, S.ml_tsize)
                score = (st["wpc"][rr, ff1].item() + st["wd1"][rr, f2].item()
                         + st["wd2"][rr, f3].item() + st["wbs"][rr].item())
                emit = score >= cfg["ml_thresh"]
                if emit:
                    st["mli"][rr] += 1
                if st["mpcnt"][rr].item() > 2048:
                    evd, evv = self.ld_evict("mp", rr)
                    if evd:
                        self.ml_train(rr, evv[0], evv[1], evv[2], False)
                self.ld_put("mp", rr, blkm + best, [ff1, f2, f3])
        # history append + trim
        st["mhb"][rr, pc, min(hl, 8)] = blkm
        hl2 = hl + 1
        if hl2 > S.ml_hist:
            row = st["mhb"][rr, pc].tolist()
            st["mhb"][rr, pc] = torch.tensor(
                [row[min(j + 1, 8)] for j in range(9)], dtype=torch.int64)
            hl2 -= 1
        st["mhl"][rr, pc] = hl2
        return emit, (blkm + best) * 64

    # ---- the access itself ----------------------------------------------
    def access(self, rr, a, w, ten, reu, pc, f1, blk_slot, pg_slot):
        S, st, cfg = self.S, self.st, self.cfg
        now = st["time"][rr].item()
        blk = a >> 6
        t1 = blk >> S.s1b
        s1 = blk & (S.s1 - 1)
        si1 = rr * S.s1 + s1
        lat = cfg["hl1"] + 0.0
        hitdone = True

        hit1, w1 = self.c_probe("l1", si1, t1)
        if hit1:
            sl1 = si1 * S.a1 + w1
            self.add("l1h", rr)
            if S.ta1:
                self.ta_hit("l1", rr, st["l1n"][sl1].item())
            if st["l1p"][sl1].item():
                self.add("l1pu", rr)
                st["l1p"][sl1] = 0
            st["l1l"][sl1] = now
            if w:
                st["l1d"][sl1] = 1
            if st["l1r"][sl1].item() > now:
                lat = lat + self.promote_wait("l1", sl1, pg_slot, now)
        else:
            self.add("l1m", rr)
            # prefetcher observation (on L1 miss)
            if S.pf_on:
                issue, tgts = self.stride_observe(rr, pc, a)
                if S.ml_on:
                    emit_ml, tgt_ml = self.ml_observe(rr, pc, f1, a)
            lat = lat + cfg["hl2"]
            s2 = blk & (S.s2 - 1)
            t2 = blk >> S.s2b
            si2 = rr * S.s2 + s2
            hit2, w2 = self.c_probe("l2", si2, t2)
            if hit2:
                sl2 = si2 * S.a2 + w2
                self.add("l2h", rr)
                if S.ta2:
                    self.ta_hit("l2", rr, st["l2n"][sl2].item())
                if st["l2p"][sl2].item():
                    self.add("l2pu", rr)
                    st["l2p"][sl2] = 0
                st["l2l"][sl2] = now
                if w:
                    st["l2d"][sl2] = 1
                if st["l2r"][sl2].item() > now:
                    lat = lat + self.promote_wait("l2", sl2, pg_slot, now)
                # L2 hit copies into L1 (victim writeback dropped)
                self.c_insert("l1", si1, s1, t1, blk, ten, reu, now, w,
                              False, 0.0)
            else:
                self.add("l2m", rr)
                # prefetch issue (on L2 miss)
                if S.pf_on:
                    if issue:
                        for tgt in tgts:
                            self.do_prefetch(rr, tgt, ten, reu, now, True)
                    if S.ml_on and emit_ml:
                        self.do_prefetch(rr, tgt_ml, ten, reu, now, False)
                lat, served = self._coherence(rr, blk, blk_slot, s1, t1,
                                              s2, t2, w, lat)
                l3hit = False
                if S.has_l3:
                    if served:
                        lat = lat + S.c2c_lat
                    else:
                        lat = lat + cfg["hl3"]
                        s3 = blk & (S.s3 - 1)
                        hit3, w3 = self.c_probe("l3", s3, blk >> S.s3b)
                        if hit3:
                            sl3 = s3 * S.a3 + w3
                            self.add("l3h", 0)
                            if S.ta3:
                                self.ta_hit("l3", 0, st["l3n"][sl3].item())
                            if st["l3p"][sl3].item():
                                self.add("l3pu", 0)
                                st["l3p"][sl3] = 0
                            st["l3l"][sl3] = now
                            if w:
                                st["l3d"][sl3] = 1
                            l3hit = True
                        else:
                            self.add("l3m", 0)
                bm = not served and not l3hit
                # demand memory access (miss path; c2c without L3)
                if bm or (served and not S.has_l3):
                    _, svc = self.mem_access(now + lat, a, False, pg_slot)
                    lat = lat + svc
                if bm or (served and S.has_l3):
                    self.fill_shared(blk, ten, reu, now, bm and w)
                self.fill_private(rr, blk, ten, reu, now, w)
                hitdone = served or l3hit
        # ---- retire ----
        st["lat"][0] = st["lat"][0].item() + lat
        self.add("nacc", 0)
        mlp = S.accel_mlp if rr >= S.n_cores else S.core_mlp
        d_ = lat / mlp
        if hitdone and lat <= cfg["hl1"] + 12.0:
            st["time"][rr] = now + 1.0
        else:
            st["time"][rr] = now + max(d_, 2.0)

    def _coherence(self, rr, blk, dslot, s1, t1, s2, t2, w, lat):
        """MESI action on leaving the private domain; (lat, served)."""
        S, st = self.S, self.st
        if not S.mesi:
            return lat, False
        bit = 1 << rr
        m0 = st["dirm"][dslot].item()
        o0 = st["diro"][dslot].item()
        others = m0 & ~bit
        ninv = sum((others >> k) & 1 for k in range(S.n_req))
        prov = False
        if w:
            self.add("dinv", 0, ninv)
            if (m0 & bit) != 0 and o0 != rr:
                self.add("dupg", 0)
            st["dirm"][dslot] = bit
            st["diro"][dslot] = rr
        else:
            prov = o0 >= 0 and o0 != rr
            if prov:
                self.add("dc2c", 0)
            m_r = m0 | bit
            o_r = -1 if prov else o0
            if m_r == bit and not prov:
                o_r = rr
            st["dirm"][dslot] = m_r
            st["diro"][dslot] = o_r
        if w and ninv > 0:
            # invalidate the other requesters' private copies
            for r2 in range(S.n_req):
                if r2 == rr:
                    continue
                for lv, si, tag, A in (("l1", r2 * S.s1 + s1, t1, S.a1),
                                       ("l2", r2 * S.s2 + s2, t2, S.a2)):
                    rows = slice(si * A, (si + 1) * A)
                    m = (st[lv + "v"][rows] != 0) & (st[lv + "t"][rows] == tag)
                    st[lv + "v"][rows] = torch.where(
                        m, 0, st[lv + "v"][rows])
            lat = lat + S.inv_lat
        return lat, prov


def _i32(v: int) -> int:
    """Truncate to int32 as ``astype(jnp.int32)`` does."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def run_lane(lane: Lane) -> None:
    """Run a CPU lane over its whole trace, in place."""
    step = PlainStep(lane)
    xs = {k: v.tolist() for k, v in lane.xs.items()}
    for i in range(len(xs["r"])):
        step.access(xs["r"][i], xs["a"][i], xs["w"][i] != 0, xs["ten"][i],
                    xs["reu"][i], xs["pc"][i], xs["f1"][i],
                    xs["blk_slot"][i], xs["pg_slot"][i])
    lane.st["probes"][0] = step.probes
