// W: traceback walk over the packed parent plane, one thread per pair.
//
// Replaces pacbioassembly_tpu/align/tbwave.py::walk_parents, an XLA
// while_loop under vmap (not a Pallas kernel). In eager PyTorch that loop
// would be thousands of tiny launches per commit; here each thread walks its
// pair from the screening goal cell (matlen_a, matlen_b) back to the origin.
//
// Semantics kept exactly: row 0 is analytic (INSERT while 1 <= j <=
// min(len_b, md), stop at j == 0); the walk emits in blocks of 32 edits and
// stops before a block when t + 32 > E, so a too-small buffer truncates at
// the same edit count; ops/vals come out left-aligned and zero-padded, vals
// carrying b's code for MATCH/INSERT and 0 for DELETE. Edits are written
// back to front at the row's end, then moved to the front.
//
// What bounds it: one dependent global load per edit (the parent word at the
// current cell), a latency chain of ~len edits per thread; 32 pairs per
// launch. Cheap next to the parent plane.

#include "common.cuh"

namespace pbt {
namespace {

constexpr int TB_WALK = 32;

__global__ void walk_kernel(
    const int* __restrict__ parents, int NRB, int S,
    const uint8_t* __restrict__ b, int LB,
    const int* __restrict__ lenb_in, const int* __restrict__ md_in,
    const int* __restrict__ ma_in, const int* __restrict__ mb_in,
    const uint8_t* __restrict__ acc_in, int B, int W, int E,
    uint8_t* __restrict__ ops, uint8_t* __restrict__ vals, int* __restrict__ nedit) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  const int* pw = parents + (size_t)q * NRB * S;
  const uint8_t* brow = b + (size_t)q * LB;
  uint8_t* o = ops + (size_t)q * E;
  uint8_t* v = vals + (size_t)q * E;
  const int lim = min(lenb_in[q], md_in[q]);
  int i = ma_in[q];
  int j = mb_in[q];
  int t = 0;
  bool done = acc_in[q] == 0;
  while (!done && t + TB_WALK <= E) {
    for (int r = 0; r < TB_WALK; ++r) {
      int p;
      if (i == 0) {
        p = (j >= 1 && j <= lim) ? INSERT : 0;
      } else {
        const int k = clampi(j - i + W, 0, S - 1);
        const int im1 = i - 1;
        const int rb = min(im1 >> 4, NRB - 1);
        p = (pw[(size_t)rb * S + k] >> ((im1 & 15) * 2)) & 3;
      }
      if (p == 0) {
        done = true;
        break;
      }
      o[E - 1 - t] = (uint8_t)p;
      v[E - 1 - t] = (p != DELETE) ? brow[clampi(j - 1, 0, LB - 1)] : (uint8_t)0;
      ++t;
      if (p != INSERT) --i;
      if (p != DELETE) --j;
    }
  }
  // left-align: the stream sits in [E - t, E); move it to [0, t), zero the rest
  for (int x = 0; x < t; ++x) {
    o[x] = o[E - t + x];
    v[x] = v[E - t + x];
  }
  for (int x = t; x < E; ++x) {
    o[x] = 0;
    v[x] = 0;
  }
  nedit[q] = t;
}

}  // namespace
}  // namespace pbt

extern "C" int pb_walk(const void* parents, int NRB, int S, const void* b, int LB,
                       const void* len_b, const void* md, const void* ma, const void* mb,
                       const void* acc, int B, int w_max, int E, void* ops, void* vals,
                       void* nedit, void* stream) {
  using namespace pbt;
  if (B <= 0) return (int)cudaSuccess;
  constexpr int kThreads = 32;
  const int grid = (B + kThreads - 1) / kThreads;
  walk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(parents), NRB, S, static_cast<const uint8_t*>(b), LB,
      static_cast<const int*>(len_b), static_cast<const int*>(md),
      static_cast<const int*>(ma), static_cast<const int*>(mb),
      static_cast<const uint8_t*>(acc), B, w_max, E, static_cast<uint8_t*>(ops),
      static_cast<uint8_t*>(vals), static_cast<int*>(nedit));
  return (int)cudaGetLastError();
}
