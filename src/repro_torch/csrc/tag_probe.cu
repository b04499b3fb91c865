// Batched set probe: B independent set rows, one warp per row.
//
// Replaces the Pallas kernel _tag_probe_kernel (src/repro/kernels/
// tag_probe.py:32, pallas_call at :78).  The probe itself is the
// warp routine of tag_probe.cuh, the same one the step kernel
// (sim_step.cu) calls for every cache probe and insert.
//
// Bound: bytes.  Each row reads A*(8 tag + 1 valid + 8 last + 8 seq) + 8
// query bytes and writes 12, with a handful of operations per row; the
// warp reads its row in one coalesced access and keeps everything else
// in registers.  Rows narrower than a warp leave lanes idle (A = 8 uses a
// quarter of each warp), which a later version can pack.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tag_probe.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    tag_probe_kernel(const long long* __restrict__ tags,
                     const unsigned char* __restrict__ valid,
                     const double* __restrict__ last,
                     const long long* __restrict__ seq,
                     const long long* __restrict__ query,
                     int* __restrict__ out, long long B, int A) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // uniform per warp
  const int lane = threadIdx.x & 31;
  bool v = false;
  long long t = 0, s = 0;
  double l = 0.0;
  if (lane < A) {
    const long long i = row * A + lane;
    v = valid[i] != 0;
    t = tags[i];
    l = last[i];
    s = seq[i];
  }
  const ProbeOut p = warp_tag_probe(A, v, t, l, s, query[row]);
  if (lane == 0) {
    out[row * 3 + 0] = p.hit;
    out[row * 3 + 1] = p.way;
    out[row * 3 + 2] = p.evict;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int tag_probe_launch(const void* tags, const void* valid,
                                const void* last, const void* seq,
                                const void* query, void* out, long long B,
                                int A, void* stream) {
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  tag_probe_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                     (cudaStream_t)stream>>>(
      (const long long*)tags, (const unsigned char*)valid,
      (const double*)last, (const long long*)seq, (const long long*)query,
      (int*)out, B, A);
  return (int)cudaGetLastError();
}
