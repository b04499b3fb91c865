// Warp-cooperative set probe: tag compare + LRU victim select.
//
// Replaces the Pallas kernel _tag_probe_kernel (src/repro/kernels/
// tag_probe.py:32) and the jnp probe inlined in engine_jax's c_probe /
// c_insert (src/repro/core/engine_jax.py:740-779).  One warp probes one
// set row; way w of the row sits in lane w (A <= 32), so the row is read
// once, in one coalesced access, and every decision is a warp vote:
//   hit   = first valid way whose tag equals the query  (__ballot_sync)
//   full  = every way valid                               (__ballot_sync)
//   free  = first invalid way                             (__ballot_sync)
//   victim= lexicographic min of (last, seq, way)  (butterfly shuffles)
// Only first-index tie-breaks count, as in the reference.
//
// Bound: a standalone probe moves ~ A*(8+1+8+8) bytes per row and does a
// few operations per byte, so it is bound by device memory bytes; the
// design reads each byte once and writes 12 bytes per row.  Inside the
// step kernel the probe is bound by the latency of its one row load.
#pragma once

#include <limits.h>
#include <math.h>
#include <stdint.h>

#define HERMES_FULL_MASK 0xffffffffu

struct ProbeOut {
  int hit;    // 1 when a valid way holds the query tag
  int way;    // hit way, else the victim (full set), else the first free way
  int evict;  // no hit and the set is full
};

// Every lane calls this with its own way's values (lanes >= A pass
// anything).  `last` is the caller's LRU stamp for the way, possibly
// masked to +inf (tensor-aware levels).  The result is the same in every
// lane.
__device__ __forceinline__ ProbeOut warp_tag_probe(int A, bool valid,
                                                   long long tag,
                                                   double last,
                                                   long long seq,
                                                   long long query) {
  const int lane = threadIdx.x & 31;
  const bool in = lane < A;
  const unsigned ways = A >= 32 ? HERMES_FULL_MASK : ((1u << A) - 1u);
  const unsigned hitm = __ballot_sync(HERMES_FULL_MASK,
                                      in && valid && tag == query);
  const unsigned vm = __ballot_sync(HERMES_FULL_MASK, in && valid);
  const bool full = vm == ways;
  const unsigned freem = ~vm & ways;
  double bl = in ? last : INFINITY;
  long long bs = in ? seq : LLONG_MAX;
  int bw = in ? lane : 32;
  for (int off = 16; off > 0; off >>= 1) {
    const double ol = __shfl_xor_sync(HERMES_FULL_MASK, bl, off);
    const long long os = __shfl_xor_sync(HERMES_FULL_MASK, bs, off);
    const int ow = __shfl_xor_sync(HERMES_FULL_MASK, bw, off);
    if (ol < bl || (ol == bl && (os < bs || (os == bs && ow < bw)))) {
      bl = ol;
      bs = os;
      bw = ow;
    }
  }
  ProbeOut r;
  r.hit = hitm != 0u;
  r.way = r.hit ? __ffs(hitm) - 1
                : (full ? bw : (freem ? __ffs(freem) - 1 : 0));
  r.evict = !r.hit && full;
  return r;
}
