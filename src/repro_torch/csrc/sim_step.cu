// Whole-trace step kernel of the batched hierarchy engine.
//
// Replaces the lax.scan over the trace (src/repro/core/engine_jax.py:1383,
// _make_run) of the step _make_step (engine_jax.py:500-1338), vmapped over
// config lanes.  One launch runs every lane's whole trace: lane = one
// warp (one block of 32 threads), reading its knobs, trace columns and
// state addresses from its LaneDesc row.  Structural knobs (sets, ways,
// feature flags, table capacities) are data, so lanes of different shape
// buckets and different traces share the launch.
//
// Execution: the step is sequential scalar work.  All 32 threads of a
// warp run it redundantly on identical values; every state write is made
// by lane 0 between two __syncwarp() (put()), so all lanes always read
// the same state.  The warp's width is used where the reference works on
// a whole row: the set probe of every cache probe and insert is
// warp_tag_probe (tag_probe.cuh, ways across lanes), the 32-slot hash
// windows are probed one slot per lane, and MESI invalidation clears a
// set's matching ways one way per lane.
//
// Bound: the latency of dependent loads.  Each access is a chain of
// data-dependent reads of the lane's state (set row → victim → directory
// → page table → prefetcher tables); the lane can do nothing else while
// a read is in flight, and one warp per lane leaves an SM nearly idle.
// The card's bytes and operations bounds are far below the time; this
// simple form is kept as the correct baseline for a later redesign.
//
// Bit identity with the reference: float64 for time and latency, the
// float op order of engine_jax (itself that of core/_sim_kernel.c), no
// fused multiply-add (built with --fmad=false), the uint64 hash _h64j,
// the _EMPTY sentinel and the 32-slot probe window, first-index
// tie-breaks, int32 truncation of the markov delta columns.  Overflow of
// a fixed-capacity table sets a flag bit that the host turns into an
// exception.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tag_probe.cuh"

namespace {

typedef long long i64;
typedef unsigned long long u64;

// hash-slot "no key" sentinel; the 32-slot probe window is the warp width
constexpr i64 kEmpty = -(1LL << 62);
constexpr i64 kFlagPage = 1, kFlagMk = 2, kFlagLd = 4, kFlagShadow = 8,
              kFlagPool = 32;

// ---- lane descriptor: every member 8 bytes, order = DESC_FIELDS -------
struct CacheLv {
  i64 S, A, sb, ta;
  i64 *t, *v, *d, *p, *u, *n;
  double *l, *r;
  i64 *q, *ctr, *ev, *dev, *pf;
  double *bkt, *utl;
  i64 *fil, *hit, *ref, *sin, *shr, *shl, *shh, *shk;
};

struct Chan {
  double bl, rhl, bw, gap;
  i64 rbb;
  double *b, *s;
  i64 *by, *ac, *rh, *op;
};

struct LDict {
  i64 pool, hcap, nv;
  i64 *pk, *pv, *prv, *nxt, *hd, *tl, *cnt, *fs, *ft, *hk, *hv;
};

struct LaneDesc {
  i64 n, n_req, n_cores, has_l3, mesi, pf_on, ml_on, hybrid, nten, st_deg,
      ml_tsize, ml_hist, ta_sample, ta_shadow, st_conf, hp_hot, hp_window,
      ta_decay, n_pc, blk_cap, pg_cap, mk_cap, sh_cap;
  double core_mlp, accel_mlp, c2c_lat, inv_lat, pf_throttle, ml_thresh,
      migcost, ta_low, ta_high, ta_pref, ta_stream, ta_bypass, hl1, hl2,
      hl3;
  const i64 *x_r, *x_a, *x_w, *x_ten, *x_reu, *x_pc, *x_f1, *x_blk_slot,
      *x_pg_slot, *blk_tab;
  CacheLv lv[3];
  Chan ch[2];
  LDict sp, mp;
  i64 *l1h, *l1m, *l1pu, *l2h, *l2m, *l2pu, *l3h, *l3m, *l3pu;
  i64 *dirm, *diro, *dinv, *dc2c, *dupg;
  i64 *pgk, *pgh, *pgp, *pge, *pgl, *epoch, *sdec, *hpg;
  i64 *mig, *migb;
  double *migs;
  i64 *sta, *sts, *stc, *sai, *sau, *stp, *sti;
  i64 *mhl, *mhb, *mk1, *mk2, *mk3, *mkc, *mkd, *mko;
  double *wpc, *wd1, *wd2, *wbs;
  i64 *mli, *mlt;
  double *time, *lat;
  i64 *nacc, *wbl, *pfd, *flags, *probes;
};
static_assert(sizeof(LaneDesc) % 8 == 0, "LaneDesc is 8-byte slots");

// ---- warp-uniform scalar helpers ----------------------------------------
__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// The one way state is written: every lane has read what it needs, lane 0
// stores, and the store is visible to the whole warp afterwards.
__device__ __forceinline__ void put(i64* p, i64 v) {
  __syncwarp();
  if (lane_id() == 0) *p = v;
  __syncwarp();
}
__device__ __forceinline__ void put(double* p, double v) {
  __syncwarp();
  if (lane_id() == 0) *p = v;
  __syncwarp();
}
__device__ __forceinline__ void inc(i64* p, i64 by = 1) { put(p, *p + by); }

__device__ __forceinline__ i64 imin(i64 a, i64 b) { return a < b ? a : b; }
__device__ __forceinline__ i64 imax(i64 a, i64 b) { return a > b ? a : b; }
__device__ __forceinline__ double dmin(double a, double b) {
  return b < a ? b : a;
}
__device__ __forceinline__ double dmax(double a, double b) {
  return b > a ? b : a;
}
// floor division / modulo (jnp // and jnp.mod), b > 0
__device__ __forceinline__ i64 fdiv(i64 a, i64 b) {
  i64 q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ i64 fmod_(i64 a, i64 b) {
  i64 r = a % b;
  return r < 0 ? r + b : r;
}
__device__ __forceinline__ i64 wrap(i64 x, i64 cap) {
  return (i64)((u64)x & (u64)(cap - 1));
}
__device__ __forceinline__ i64 pmod(i64 v, i64 m) {
  return fmod_(v * 2654435761LL, m);
}
__device__ __forceinline__ u64 h64(i64 k) {
  u64 x = (u64)k;
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDULL;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ULL;
  x ^= x >> 33;
  return x;
}
__device__ __forceinline__ double clip8(double x) {
  return dmin(dmax(x, -8.0), 8.0);
}

struct Slot {
  i64 slot;
  bool found, can_ins, ovf;
};

// First stop (match or empty) of a 32-slot window, one slot per lane.
__device__ __forceinline__ Slot window_stop(i64 home, i64 cap, bool match,
                                            bool empty) {
  const unsigned stop = __ballot_sync(HERMES_FULL_MASK, match || empty);
  const unsigned mm = __ballot_sync(HERMES_FULL_MASK, match);
  Slot r;
  if (stop == 0u) {
    r.slot = home;
    r.found = r.can_ins = false;
    r.ovf = true;
    return r;
  }
  const int f = __ffs(stop) - 1;
  r.slot = wrap(home + f, cap);
  r.found = (mm >> f) & 1u;
  r.can_ins = !r.found;
  r.ovf = false;
  return r;
}

// Windowed linear probe of a 1-D key table (kEmpty = free).
__device__ Slot probe(const i64* keys, i64 cap, i64 key) {
  const i64 home = wrap((i64)h64(key), cap);
  const i64 k = keys[wrap(home + lane_id(), cap)];
  return window_stop(home, cap, k == key, k == kEmpty);
}

// Backshift deletion at `slot` keeping probe chains intact.
__device__ void backshift(i64* hk, i64* hv, i64 cap, i64 slot) {
  i64 i = slot, j = slot;
  while (true) {
    j = wrap(j + 1, cap);
    const i64 kj = hk[j];
    if (kj == kEmpty) break;
    const i64 home = wrap((i64)h64(kj), cap);
    if (wrap(i - home, cap) <= wrap(j - home, cap)) {
      put(&hk[i], kj);
      if (hv != nullptr) put(&hv[i], hv[j]);
      i = j;
    }
  }
  put(&hk[i], kEmpty);
}

// k lazy decay rounds in closed form.
__device__ __forceinline__ void decay_closed(i64 h, i64 p, i64 k, i64 half,
                                             i64* hf, i64* pf) {
  const i64 kc = k < 0 ? 0 : (k > 63 ? 63 : k);
  *hf = h >> kc;
  const i64 bl = 64 - __clzll(h / imax(half, 1));
  *pf = *hf > 0 ? p + imin(k, bl) : 0;
}

struct Victim {
  bool victim, dirty;
  i64 addr;
};

struct Step {
  const LaneDesc& D;
  i64 probes;

  __device__ void flag(i64 bit) { put(D.flags, *D.flags | bit); }

  // ---- linked dict (FIFO-capped map) ------------------------------------
  __device__ void ld_unlink(const LDict& L, i64 rr, i64 pi) {
    const i64 b = rr * L.pool;
    const i64 prv = L.prv[b + pi], nxt = L.nxt[b + pi];
    if (prv >= 0) put(&L.nxt[b + prv], nxt);
    else put(&L.hd[rr], nxt);
    if (nxt >= 0) put(&L.prv[b + nxt], prv);
    else put(&L.tl[rr], prv);
    const i64 ft = L.ft[rr];
    put(&L.fs[b + imin(ft, L.pool - 1)], pi);
    put(&L.ft[rr], ft + 1);
    inc(&L.cnt[rr], -1);
  }

  __device__ bool ld_pop(const LDict& L, i64 rr, i64 key, i64* val) {
    i64* hk = L.hk + rr * L.hcap;
    i64* hv = L.hv + rr * L.hcap;
    const Slot s = probe(hk, L.hcap, key);
    if (s.ovf) flag(kFlagLd);
    if (!s.found) return false;
    const i64 pi = hv[s.slot];
    for (i64 j = 0; j < L.nv; ++j) val[j] = L.pv[(rr * L.pool + pi) * L.nv + j];
    backshift(hk, hv, L.hcap, s.slot);
    ld_unlink(L, rr, pi);
    return true;
  }

  __device__ void ld_put(const LDict& L, i64 rr, i64 key, const i64* vals) {
    i64* hk = L.hk + rr * L.hcap;
    i64* hv = L.hv + rr * L.hcap;
    const i64 b = rr * L.pool;
    const Slot s = probe(hk, L.hcap, key);
    if (s.ovf || (!s.found && !s.can_ins)) flag(kFlagLd);
    const bool fresh = !s.found;
    const i64 ft = L.ft[rr];
    if (fresh && ft <= 0) flag(kFlagPool);
    i64 pi;
    if (s.found) {
      pi = hv[s.slot];
    } else {
      pi = L.fs[b + imax(ft - 1, 0)];
      put(&L.ft[rr], ft - 1);
    }
    put(&L.pk[b + pi], key);
    for (i64 j = 0; j < L.nv; ++j) put(&L.pv[(b + pi) * L.nv + j], vals[j]);
    if (fresh) {
      const i64 tl = L.tl[rr];
      put(&L.prv[b + pi], tl);
      put(&L.nxt[b + pi], (i64)-1);
      if (tl >= 0) put(&L.nxt[b + tl], pi);
      else put(&L.hd[rr], pi);
      put(&L.tl[rr], pi);
      inc(&L.cnt[rr]);
      put(&hk[s.slot], key);
      put(&hv[s.slot], pi);
    }
  }

  __device__ bool ld_evict(const LDict& L, i64 rr, i64* val) {
    if (L.cnt[rr] <= 0) return false;
    i64* hk = L.hk + rr * L.hcap;
    i64* hv = L.hv + rr * L.hcap;
    const i64 b = rr * L.pool;
    const i64 pi = imax(L.hd[rr], 0);
    const i64 key = L.pk[b + pi];
    for (i64 j = 0; j < L.nv; ++j) val[j] = L.pv[(b + pi) * L.nv + j];
    const Slot s = probe(hk, L.hcap, key);
    if (s.ovf || !s.found) flag(kFlagLd);
    if (s.found) backshift(hk, hv, L.hcap, s.slot);
    ld_unlink(L, rr, pi);
    return true;
  }

  // ---- tensor-aware shadow / bucket machinery ---------------------------
  __device__ void ta_bucket_upd(const CacheLv& L, i64 inst, i64 t,
                                bool all_rows) {
    const i64 r0 = all_rows ? 0 : t, r1 = all_rows ? D.nten : t + 1;
    for (i64 r = r0; r < r1; ++r) {
      const i64 k = inst * D.nten + r;
      const double f = (double)L.fil[k];
      const double num = (double)(L.hit[k] + D.ta_sample * L.ref[k]);
      const double u = f == 0.0 ? 1.0 : dmin(num / dmax(f, 1.0), 4.0);
      const double bk = u < D.ta_low ? 1.0 : (u < D.ta_high ? 2.0 : 3.0);
      put(&L.utl[k], u);
      put(&L.bkt[k], bk);
    }
  }

  __device__ void ta_hit(const CacheLv& L, i64 inst, i64 t) {
    inc(&L.hit[inst * D.nten + t]);
    ta_bucket_upd(L, inst, t, false);
  }

  __device__ void ta_fill(const CacheLv& L, i64 inst, i64 t, i64 blk) {
    inc(&L.fil[inst * D.nten + t]);
    if (blk >= 0 && pmod(blk, D.ta_sample) == 0) {
      i64* shk = L.shk + inst * D.sh_cap;
      const Slot s = probe(shk, D.sh_cap, blk);
      if (s.ovf) flag(kFlagShadow);
      if (s.found) {
        inc(&L.ref[inst * D.nten + t]);
      } else {
        if (L.shl[inst] >= D.ta_shadow) {
          // evict FIFO-oldest from the shadow ring
          const i64 hd = L.shh[inst];
          const i64 evk = L.shr[inst * D.ta_shadow + hd];
          const Slot e = probe(shk, D.sh_cap, evk);
          if (e.ovf || !e.found) flag(kFlagShadow);
          if (e.found) backshift(shk, nullptr, D.sh_cap, e.slot);
          put(&L.shh[inst], fmod_(hd + 1, D.ta_shadow));
          inc(&L.shl[inst], -1);
        }
        const i64 ln = L.shl[inst], hd2 = L.shh[inst];
        put(&L.shr[inst * D.ta_shadow + fmod_(hd2 + ln, D.ta_shadow)], blk);
        const Slot s2 = probe(shk, D.sh_cap, blk);
        if (s2.ovf || !s2.can_ins || s2.found) flag(kFlagShadow);
        put(&shk[s2.slot], blk);
        inc(&L.shl[inst]);
      }
    }
    inc(&L.sin[inst]);
    const bool dec = L.sin[inst] >= D.ta_decay;
    if (dec) {
      put(&L.sin[inst], (i64)0);
      for (i64 r = 0; r < D.nten; ++r) {
        const i64 k = inst * D.nten + r;
        put(&L.fil[k], L.fil[k] >> 1);
        put(&L.hit[k], L.hit[k] >> 1);
        put(&L.ref[k], L.ref[k] >> 1);
      }
    }
    ta_bucket_upd(L, inst, t, dec);
  }

  // ---- set-associative cache primitives ---------------------------------
  __device__ ProbeOut c_probe(const CacheLv& L, i64 si, i64 tag) {
    const int lane = lane_id();
    bool v = false;
    i64 t = 0, q = 0;
    double l = 0.0;
    if (lane < L.A) {
      const i64 i = si * L.A + lane;
      v = L.v[i] != 0;
      t = L.t[i];
      l = L.l[i];
      q = L.q[i];
    }
    ++probes;
    return warp_tag_probe((int)L.A, v, t, l, q, tag);
  }

  // Insert (or refresh) a line; the victim comes back for writeback.
  __device__ Victim c_insert(const CacheLv& L, i64 si, i64 sset, i64 tag,
                             i64 blk, i64 ten, i64 reu, double now,
                             bool is_w, bool prefd, double ready) {
    const int lane = lane_id();
    const i64 inst = si / L.S;
    bool v = false;
    i64 t = 0, q = 0;
    double l = 0.0, bv = INFINITY;
    if (lane < L.A) {
      const i64 i = si * L.A + lane;
      v = L.v[i] != 0;
      t = L.t[i];
      l = L.l[i];
      q = L.q[i];
      if (L.ta)
        bv = L.p[i] != 0 ? D.ta_pref
                         : (L.u[i] == 0 ? D.ta_stream
                                        : L.bkt[inst * D.nten + L.n[i]]);
    }
    if (L.ta) {
      // LRU only among the ways of the lowest-utility bucket
      double m = bv;
      for (int off = 16; off > 0; off >>= 1)
        m = dmin(m, __shfl_xor_sync(HERMES_FULL_MASK, m, off));
      if (bv != m) l = INFINITY;
    }
    ++probes;
    const ProbeOut p = warp_tag_probe((int)L.A, v, t, l, q, tag);
    const i64 sl = si * L.A + p.way;
    Victim r;
    r.victim = p.evict != 0;
    r.dirty = r.victim && L.d[sl] != 0;
    r.addr = ((L.t[sl] << L.sb) | sset) << 6;
    if (r.victim) inc(L.ev);
    if (r.dirty) inc(L.dev);
    const i64 ctr = *L.ctr;
    put(&L.v[sl], (i64)1);
    put(&L.t[sl], tag);
    put(&L.d[sl], (i64)(is_w ? 1 : 0));
    put(&L.n[sl], ten);
    put(&L.u[sl], reu);
    put(&L.l[sl], now);
    put(&L.p[sl], (i64)(prefd ? 1 : 0));
    put(&L.r[sl], ready);
    put(&L.q[sl], ctr);
    put(L.ctr, ctr + 1);
    if (prefd) inc(L.pf);
    if (L.ta) ta_fill(L, inst, ten, blk);
    return r;
  }

  // ---- memory channels + hybrid page heat -------------------------------
  __device__ double chan_access(const Chan& C, double now, i64 addr,
                                bool spec, double* svc) {
    inc(C.ac);
    inc(C.by, 64);
    const i64 bank = fmod_(fdiv(addr, C.rbb), 8);
    const i64 row = fdiv(addr, C.rbb * 8);
    const bool rowhit = C.op[bank] == row;
    if (rowhit) inc(C.rh);
    else put(&C.op[bank], row);
    const double latc = rowhit ? C.rhl : C.bl;
    const double gap = rowhit ? 0.0 : C.gap;
    const double xfer = 64.0 / C.bw + gap;
    const double busy = *C.b, sb = *C.s;
    double start;
    if (spec) {
      start = dmax(dmax(now, busy), sb);
      put(C.s, start + xfer);
    } else {
      start = dmax(now, busy);
      const double nb = start + xfer;
      put(C.b, nb);
      put(C.s, dmax(sb, nb));
    }
    const double done = start + latc + xfer;
    *svc = done - now;
    return done;
  }

  // pg_slot < 0: look the page up (and insert it) in the page table
  __device__ double mem_access(double now, i64 addr, bool spec, i64 pg_slot,
                               double* svc) {
    if (!D.hybrid) return chan_access(D.ch[0], now, addr, spec, svc);
    const i64 half = fdiv(D.hp_hot, 2);
    i64 slot = pg_slot;
    if (pg_slot < 0) {
      const i64 page = addr >> 12;
      const Slot s = probe(D.pgk, D.pg_cap, page);
      if (s.ovf || (!s.found && !s.can_ins)) flag(kFlagPage);
      if (!s.found) put(&D.pgk[s.slot], page);
      slot = s.slot;
    }
    i64 h0, p0, h2, p2;
    decay_closed(D.pgh[slot], D.pgp[slot], *D.epoch - D.pge[slot], half,
                 &h0, &p0);
    const i64 h1 = h0 + 1;
    const i64 sd = *D.sdec + 1;
    const bool fired = sd >= D.hp_window;
    put(D.sdec, fired ? (i64)0 : sd);
    if (fired) inc(D.epoch);
    decay_closed(h1, p0, fired ? 1 : 0, half, &h2, &p2);
    put(&D.pgh[slot], h2);
    put(&D.pgp[slot], p2);
    put(&D.pge[slot], *D.epoch);
    // promotion check: pre-fire heat, post-fire persist
    if (h1 >= D.hp_hot && p2 >= 2 && D.pgl[slot] != 1) {
      put(&D.pgl[slot], (i64)1);
      inc(D.hpg);
      inc(D.mig);
      inc(D.migb, 4096);
      put(D.migs, *D.migs + D.migcost);
      put(D.ch[0].b, dmax(*D.ch[0].b, now) + 4096.0 / D.ch[0].bw);
      put(D.ch[1].b, dmax(*D.ch[1].b, now) + 4096.0 / D.ch[1].bw);
    }
    return chan_access(D.ch[D.pgl[slot] == 1 ? 1 : 0], now, addr, spec, svc);
  }

  __device__ void wb(double now, i64 vaddr) {
    inc(D.wbl);
    double svc;
    mem_access(now, vaddr, true, -1, &svc);
  }

  __device__ double promote_wait(const CacheLv& L, i64 sl, i64 pg_slot,
                                 double now) {
    const double remaining = L.r[sl] - now;
    const Chan& C = (D.hybrid && D.pgl[pg_slot] == 1) ? D.ch[1] : D.ch[0];
    const double promoted = C.rhl + 64.0 / C.bw;
    put(&L.r[sl], 0.0);
    return dmin(dmax(remaining, 0.0), promoted);
  }

  // ---- MESI directory ---------------------------------------------------
  __device__ void dir_evict_at(i64 slot, i64 rr) {
    const i64 m = D.dirm[slot], o = D.diro[slot];
    const i64 m2 = m & ~(1LL << rr);
    put(&D.dirm[slot], m2);
    put(&D.diro[slot], (o == rr || m2 == 0) ? (i64)-1 : o);
  }

  // ---- fills --------------------------------------------------------------
  __device__ void fill_shared(i64 blk, i64 ten, i64 reu, double now,
                              bool is_w) {
    if (!D.has_l3) return;
    const CacheLv& L3 = D.lv[2];
    if (L3.ta && reu == 0 && !is_w && L3.utl[ten] < D.ta_bypass) return;
    const i64 s3 = blk & (L3.S - 1);
    const Victim v = c_insert(L3, s3, s3, blk >> L3.sb, blk, ten, reu, now,
                              false, false, 0.0);
    if (v.dirty) wb(now, v.addr);
  }

  __device__ void fill_private(i64 rr, i64 blk, i64 ten, i64 reu,
                               double now, bool is_w) {
    const CacheLv &L1 = D.lv[0], &L2 = D.lv[1];
    const i64 s2 = blk & (L2.S - 1);
    const Victim v2 = c_insert(L2, rr * L2.S + s2, s2, blk >> L2.sb, blk,
                               ten, reu, now, is_w, false, 0.0);
    if (D.mesi && v2.victim) {
      // the victim leaves the private domain only when not in L1
      const i64 vblk = v2.addr >> 6;
      const i64 s1v = vblk & (L1.S - 1);
      const ProbeOut in_l1 = c_probe(L1, rr * L1.S + s1v, vblk >> L1.sb);
      const Slot ds = probe(D.blk_tab, D.blk_cap, vblk);
      if (!in_l1.hit && ds.found) dir_evict_at(ds.slot, rr);
    }
    if (v2.dirty) wb(now, v2.addr);
    const i64 s1 = blk & (L1.S - 1);
    const Victim v1 = c_insert(L1, rr * L1.S + s1, s1, blk >> L1.sb, blk,
                               ten, reu, now, is_w, false, 0.0);
    if (v1.dirty) {
      const i64 vblk1 = v1.addr >> 6;
      const i64 s2v = vblk1 & (L2.S - 1);
      const ProbeOut h2 = c_probe(L2, rr * L2.S + s2v, vblk1 >> L2.sb);
      if (h2.hit) put(&L2.d[(rr * L2.S + s2v) * L2.A + h2.way], (i64)1);
      else wb(now, v1.addr);
    }
  }

  // ---- prefetchers --------------------------------------------------------
  __device__ void do_prefetch(i64 rr, i64 tgt, i64 ten, i64 reu,
                              double now, bool is_stride) {
    const CacheLv &L2 = D.lv[1], &L3 = D.lv[2];
    const i64 blk = tgt >> 6;
    const i64 s2 = blk & (L2.S - 1);
    bool act = !c_probe(L2, rr * L2.S + s2, blk >> L2.sb).hit;
    const i64 s3 = D.has_l3 ? (blk & (L3.S - 1)) : 0;
    if (D.has_l3) {
      const bool in3 = c_probe(L3, s3, blk >> L3.sb).hit;
      if (is_stride && act && in3) {
        // shared-level hit: cheap promote to L2
        const Victim v = c_insert(L2, rr * L2.S + s2, s2, blk >> L2.sb, blk,
                                  ten, reu, now, false, true, now + D.hl3);
        if (v.dirty) wb(now, v.addr);
      }
      act = act && !in3;
    }
    if (!act) return;
    // throttle on the target channel's speculative backlog
    i64 pslot = -1;
    double backlog;
    if (D.hybrid) {
      const i64 page = tgt >> 12;
      const Slot s = probe(D.pgk, D.pg_cap, page);
      if (s.ovf || (!s.found && !s.can_ins)) flag(kFlagPage);
      if (!s.found) put(&D.pgk[s.slot], page);
      pslot = s.slot;
      const Chan& C = D.pgl[pslot] == 1 ? D.ch[1] : D.ch[0];
      backlog = *C.s - *C.b;
    } else {
      backlog = *D.ch[0].s - *D.ch[0].b;
    }
    if (backlog > D.pf_throttle) {
      inc(D.pfd);
      return;
    }
    double svc;
    const double done = mem_access(now, tgt, true, pslot, &svc);
    Victim v;
    if (!is_stride && D.has_l3)
      v = c_insert(L3, s3, s3, blk >> L3.sb, blk, ten, reu, now, false, true,
                   done);
    else
      v = c_insert(L2, rr * L2.S + s2, s2, blk >> L2.sb, blk, ten, reu, now,
                   false, true, done);
    if (v.dirty) wb(now, v.addr);
  }

  __device__ bool stride_observe(i64 rr, i64 pc, i64 a, i64* tgts) {
    i64 val[1];
    if (ld_pop(D.sp, rr, a >> 6, val)) inc(&D.sau[rr * D.n_pc + val[0]]);
    const i64 k = rr * D.n_pc + pc;
    const bool pres = D.stp[k] != 0;
    const i64 old_last = D.sta[k], old_st = D.sts[k], old_cf = D.stc[k];
    const i64 strd = a - old_last;
    const bool same = pres && strd != 0 && strd == old_st;
    i64 ncf = old_cf, nst = old_st;
    if (same) {
      ncf = imin(old_cf + 1, 7);
    } else if (pres) {
      ncf = 0;
      nst = strd;
    }
    put(&D.stp[k], (i64)1);
    put(&D.sta[k], a);
    put(&D.sts[k], pres ? nst : (i64)0);
    put(&D.stc[k], pres ? ncf : (i64)0);
    bool issue = pres && ncf >= D.st_conf && nst != 0;
    const i64 iss = D.sai[k], used = D.sau[k];
    if (issue && iss >= 32 && (double)used / (double)imax(iss, 1) < 0.4)
      issue = false;
    for (i64 j = 0; j < D.st_deg; ++j) tgts[j] = a + nst * (j + 1);
    if (issue) {
      for (i64 j = 0; j < D.st_deg; ++j) {
        inc(&D.sai[k]);
        i64 ev[1];
        if (D.sp.cnt[rr] > 4096) ld_evict(D.sp, rr, ev);
        const i64 v1[1] = {pc};
        ld_put(D.sp, rr, tgts[j] >> 6, v1);
      }
      inc(&D.sti[rr], D.st_deg);
    }
    return issue;
  }

  __device__ void ml_train(i64 rr, i64 f1, i64 f2, i64 f3, bool useful) {
    const double lr = useful ? 0.5 : -0.5;
    const i64 b = rr * D.ml_tsize;
    put(&D.wpc[b + f1], clip8(D.wpc[b + f1] + lr));
    put(&D.wd1[b + f2], clip8(D.wd1[b + f2] + lr));
    put(&D.wd2[b + f3], clip8(D.wd2[b + f3] + lr));
    put(&D.wbs[rr], clip8(D.wbs[rr] + lr * 0.25));
    inc(&D.mlt[rr]);
  }

  // Markov table probe for (k1, k2, k3); mk1 == -1 marks a free slot.
  __device__ Slot mk_probe(i64 rr, i64 k1, i64 k2, i64 k3) {
    const i64 cap = D.mk_cap;
    const u64 h = h64(k1) ^ (h64(k2) << 1) ^ (h64(k3) << 2);
    const i64 home = wrap((i64)h, cap);
    const i64 i = rr * cap + wrap(home + lane_id(), cap);
    const i64 a1 = D.mk1[i];
    return window_stop(home, cap,
                       a1 == k1 && D.mk2[i] == k2 && D.mk3[i] == k3,
                       a1 == -1);
  }

  __device__ bool ml_observe(i64 rr, i64 pc, i64 ff1, i64 a, i64* tgt) {
    const i64 blkm = a >> 6;
    i64 pv[3];
    if (ld_pop(D.mp, rr, blkm, pv)) ml_train(rr, pv[0], pv[1], pv[2], true);
    const i64 hx = rr * D.n_pc + pc;
    const i64 hl = D.mhl[hx];
    i64 hb[9];
    for (int j = 0; j < 9; ++j) hb[j] = D.mhb[hx * 9 + j];
    const i64 hi = imax(hl - 1, 0);
    const i64 d_new = blkm - hb[hi];
    const i64 key2 = hl >= 3 ? hb[imax(hi - 1, 0)] - hb[imax(hi - 2, 0)] : 0;
    const i64 key3 = hb[hi] - hb[imax(hi - 1, 0)];
    bool emit = false;
    i64 best = 0;
    if (hl >= 2) {
      // markov transition update: entry (pc, key2, key3) += d_new
      const Slot e = mk_probe(rr, pc, key2, key3);
      if (e.ovf || (!e.found && !e.can_ins)) flag(kFlagMk);
      const i64 eb = rr * D.mk_cap + e.slot;
      if (!e.found) {
        put(&D.mk1[eb], pc);
        put(&D.mk2[eb], key2);
        put(&D.mk3[eb], key3);
      }
      i64 dr[9], co[9];
      for (int j = 0; j < 9; ++j) {
        dr[j] = D.mkd[eb * 9 + j];
        co[j] = D.mko[eb * 9 + j];
      }
      const i64 cnt = D.mkc[eb];
      const i64 d32 = (i64)(int32_t)(uint32_t)(u64)d_new;
      int fi = -1;
      for (int j = 0; j < 9; ++j)
        if (j < cnt && dr[j] == d32) {
          fi = j;
          break;
        }
      i64 cnt2 = cnt;
      if (fi >= 0) {
        co[fi] += 1;
      } else {
        const i64 app = imin(cnt, 8);
        dr[app] = d32;
        co[app] = 1;
        cnt2 = cnt + 1;
      }
      if (cnt2 > 8) {
        int mi = 0;
        for (int j = 1; j < 9; ++j) {
          const i64 cj = j < cnt2 ? co[j] : (1LL << 30);
          const i64 cm = mi < cnt2 ? co[mi] : (1LL << 30);
          if (cj < cm) mi = j;
        }
        for (int j = mi; j < 8; ++j) {
          dr[j] = dr[j + 1];
          co[j] = co[j + 1];
        }
        cnt2 -= 1;
      }
      for (int j = 0; j < 9; ++j) {
        put(&D.mkd[eb * 9 + j], dr[j]);
        put(&D.mko[eb * 9 + j], co[j]);
      }
      put(&D.mkc[eb], cnt2);
      // candidate lookup (post-update): entry (pc, key3, d_new)
      const Slot c = mk_probe(rr, pc, key3, d_new);
      if (c.ovf) flag(kFlagMk);
      const i64 cb = rr * D.mk_cap + c.slot;
      const i64 ccnt = c.found ? D.mkc[cb] : 0;
      if (ccnt > 0) {
        int bi = 0;
        for (int j = 1; j < 9; ++j) {
          const i64 bj = j < ccnt ? D.mko[cb * 9 + j] : -1;
          const i64 bm = bi < ccnt ? D.mko[cb * 9 + bi] : -1;
          if (bj > bm) bi = j;
        }
        best = D.mkd[cb * 9 + bi];
      }
      if (ccnt > 0 && best != 0) {
        const i64 f2 = pmod(key3, D.ml_tsize), f3 = pmod(d_new, D.ml_tsize);
        const i64 wb_ = rr * D.ml_tsize;
        const double score =
            D.wpc[wb_ + ff1] + D.wd1[wb_ + f2] + D.wd2[wb_ + f3] + D.wbs[rr];
        emit = score >= D.ml_thresh;
        if (emit) inc(&D.mli[rr]);
        if (D.mp.cnt[rr] > 2048) {
          i64 ev[3];
          if (ld_evict(D.mp, rr, ev)) ml_train(rr, ev[0], ev[1], ev[2], false);
        }
        const i64 vals[3] = {ff1, f2, f3};
        ld_put(D.mp, rr, blkm + best, vals);
      }
    }
    // history append + trim
    put(&D.mhb[hx * 9 + imin(hl, 8)], blkm);
    i64 hl2 = hl + 1;
    if (hl2 > D.ml_hist) {
      i64 row[9];
      for (int j = 0; j < 9; ++j) row[j] = D.mhb[hx * 9 + j];
      for (int j = 0; j < 9; ++j) put(&D.mhb[hx * 9 + j], row[j < 8 ? j + 1 : 8]);
      hl2 -= 1;
    }
    put(&D.mhl[hx], hl2);
    *tgt = (blkm + best) * 64;
    return emit;
  }

  // MESI action on leaving the private domain; returns served-by-c2c.
  __device__ bool coherence(i64 rr, i64 dslot, i64 s1, i64 t1, i64 s2,
                            i64 t2, bool w, double* lat) {
    if (!D.mesi) return false;
    const i64 bit = 1LL << rr;
    const i64 m0 = D.dirm[dslot], o0 = D.diro[dslot];
    const i64 others = m0 & ~bit;
    i64 ninv = 0;
    for (i64 k = 0; k < D.n_req; ++k) ninv += (others >> k) & 1;
    bool prov = false;
    if (w) {
      inc(D.dinv, ninv);
      if ((m0 & bit) != 0 && o0 != rr) inc(D.dupg);
      put(&D.dirm[dslot], bit);
      put(&D.diro[dslot], rr);
    } else {
      prov = o0 >= 0 && o0 != rr;
      if (prov) inc(D.dc2c);
      const i64 m_r = m0 | bit;
      i64 o_r = prov ? -1 : o0;
      if (m_r == bit && !prov) o_r = rr;
      put(&D.dirm[dslot], m_r);
      put(&D.diro[dslot], o_r);
    }
    if (w && ninv > 0) {
      // invalidate the other requesters' private copies, one way per lane
      const int lane = lane_id();
      for (i64 r2 = 0; r2 < D.n_req; ++r2) {
        if (r2 == rr) continue;
        for (int lvi = 0; lvi < 2; ++lvi) {
          const CacheLv& L = D.lv[lvi];
          const i64 si = r2 * L.S + (lvi == 0 ? s1 : s2);
          const i64 tag = lvi == 0 ? t1 : t2;
          const i64 i = si * L.A + lane;
          const bool m = lane < L.A && L.v[i] != 0 && L.t[i] == tag;
          __syncwarp();
          if (m) L.v[i] = 0;
          __syncwarp();
        }
      }
      *lat = *lat + D.inv_lat;
    }
    return prov;
  }

  // ---- the access itself ------------------------------------------------
  __device__ void access(i64 x) {
    const CacheLv &L1 = D.lv[0], &L2 = D.lv[1], &L3 = D.lv[2];
    const i64 rr = D.x_r[x], a = D.x_a[x], ten = D.x_ten[x],
              reu = D.x_reu[x], pg_slot = D.x_pg_slot[x];
    const bool w = D.x_w[x] != 0;
    const double now = D.time[rr];
    const i64 blk = a >> 6;
    const i64 t1 = blk >> L1.sb, s1 = blk & (L1.S - 1);
    const i64 si1 = rr * L1.S + s1;
    double lat = D.hl1 + 0.0;
    bool hitdone = true;

    const ProbeOut p1 = c_probe(L1, si1, t1);
    if (p1.hit) {
      const i64 sl1 = si1 * L1.A + p1.way;
      inc(&D.l1h[rr]);
      if (L1.ta) ta_hit(L1, rr, L1.n[sl1]);
      if (L1.p[sl1] != 0) {
        inc(&D.l1pu[rr]);
        put(&L1.p[sl1], (i64)0);
      }
      put(&L1.l[sl1], now);
      if (w) put(&L1.d[sl1], (i64)1);
      if (L1.r[sl1] > now) lat = lat + promote_wait(L1, sl1, pg_slot, now);
    } else {
      inc(&D.l1m[rr]);
      // prefetcher observation (on L1 miss)
      bool issue = false, emit_ml = false;
      i64 tgts[16];
      i64 tgt_ml = 0;
      if (D.pf_on) {
        issue = stride_observe(rr, D.x_pc[x], a, tgts);
        if (D.ml_on) emit_ml = ml_observe(rr, D.x_pc[x], D.x_f1[x], a, &tgt_ml);
      }
      lat = lat + D.hl2;
      const i64 s2 = blk & (L2.S - 1), t2 = blk >> L2.sb;
      const i64 si2 = rr * L2.S + s2;
      const ProbeOut p2 = c_probe(L2, si2, t2);
      if (p2.hit) {
        const i64 sl2 = si2 * L2.A + p2.way;
        inc(&D.l2h[rr]);
        if (L2.ta) ta_hit(L2, rr, L2.n[sl2]);
        if (L2.p[sl2] != 0) {
          inc(&D.l2pu[rr]);
          put(&L2.p[sl2], (i64)0);
        }
        put(&L2.l[sl2], now);
        if (w) put(&L2.d[sl2], (i64)1);
        if (L2.r[sl2] > now) lat = lat + promote_wait(L2, sl2, pg_slot, now);
        // L2 hit copies into L1 (victim writeback dropped)
        c_insert(L1, si1, s1, t1, blk, ten, reu, now, w, false, 0.0);
      } else {
        inc(&D.l2m[rr]);
        // prefetch issue (on L2 miss)
        if (D.pf_on) {
          if (issue)
            for (i64 j = 0; j < D.st_deg; ++j)
              do_prefetch(rr, tgts[j], ten, reu, now, true);
          if (D.ml_on && emit_ml) do_prefetch(rr, tgt_ml, ten, reu, now, false);
        }
        const bool served =
            coherence(rr, D.x_blk_slot[x], s1, t1, s2, t2, w, &lat);
        bool l3hit = false;
        if (D.has_l3) {
          if (served) {
            lat = lat + D.c2c_lat;
          } else {
            lat = lat + D.hl3;
            const i64 s3 = blk & (L3.S - 1);
            const ProbeOut p3 = c_probe(L3, s3, blk >> L3.sb);
            if (p3.hit) {
              const i64 sl3 = s3 * L3.A + p3.way;
              inc(D.l3h);
              if (L3.ta) ta_hit(L3, 0, L3.n[sl3]);
              if (L3.p[sl3] != 0) {
                inc(D.l3pu);
                put(&L3.p[sl3], (i64)0);
              }
              put(&L3.l[sl3], now);
              if (w) put(&L3.d[sl3], (i64)1);
              l3hit = true;
            } else {
              inc(D.l3m);
            }
          }
        }
        const bool bm = !served && !l3hit;
        // demand memory access (miss path; c2c without L3)
        if (bm || (served && !D.has_l3)) {
          double svc;
          mem_access(now + lat, a, false, pg_slot, &svc);
          lat = lat + svc;
        }
        if (bm || (served && D.has_l3))
          fill_shared(blk, ten, reu, now, bm && w);
        fill_private(rr, blk, ten, reu, now, w);
        hitdone = served || l3hit;
      }
    }
    // ---- retire ----
    put(D.lat, *D.lat + lat);
    inc(D.nacc);
    const double mlp = rr >= D.n_cores ? D.accel_mlp : D.core_mlp;
    const double d_ = lat / mlp;
    put(&D.time[rr], (hitdone && lat <= D.hl1 + 12.0) ? now + 1.0
                                                      : now + dmax(d_, 2.0));
  }
};

__global__ void __launch_bounds__(32)
    sim_step_kernel(const LaneDesc* __restrict__ descs) {
  __shared__ LaneDesc D;
  const i64* src = reinterpret_cast<const i64*>(descs + blockIdx.x);
  i64* dst = reinterpret_cast<i64*>(&D);
  for (int j = threadIdx.x; j < (int)(sizeof(LaneDesc) / 8); j += 32)
    dst[j] = src[j];
  __syncwarp();
  Step s{D, 0};
  for (i64 x = 0; x < D.n; ++x) s.access(x);
  put(D.probes, s.probes);
}

}  // namespace

// Launch one warp per lane on `stream`; returns cudaGetLastError().
extern "C" int sim_step_launch(const void* descs, long long n_lanes,
                               void* stream) {
  if (n_lanes <= 0) return 0;
  sim_step_kernel<<<(unsigned)n_lanes, 32, 0, (cudaStream_t)stream>>>(
      (const LaneDesc*)descs);
  return (int)cudaGetLastError();
}
