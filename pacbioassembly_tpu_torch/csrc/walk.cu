// W: traceback walk over the packed parent plane, one warp per pair.
//
// Replaces pacbioassembly_tpu/align/tbwave.py::walk_parents, an XLA
// while_loop under vmap (not a Pallas kernel). In eager PyTorch that loop
// would be thousands of tiny launches per commit; here a warp walks its pair
// from the screening goal cell (matlen_a, matlen_b) back to the origin.
//
// Semantics kept exactly: at cell (i, j) the parent is bits [2r, 2r+1] of
// word [rb, k] with k = clamp(j - i + W, 0, S - 1), rb = min((i - 1) >> 4,
// NRB - 1) and r = (i - 1) & 15, so rows cut at the plane read its last row
// block again; row 0 is analytic (INSERT while 1 <= j <= min(len_b, md),
// stop at j == 0); the walk emits in blocks of 32 edits and stops before a
// block when t + 32 > E, so it ends at 32 * floor(E / 32) edits at most and
// a too-small buffer truncates at the same count; ops/vals come out
// left-aligned and zero-padded, vals carrying b's code for MATCH/INSERT and
// 0 for DELETE.
//
// What bounds it on Hopper: the walk is a chain, each step's cell known only
// once the last step's parent is read, and a commit launch has 32 pairs. A
// word load per edit from the plane (73 MB at the main shape, above the
// 50 MB L2) made the chain one L2 or HBM latency an edit. The design takes
// the plane off the chain and most edits off the step:
//   * a step reads one word: a MATCH keeps k and moves up one row, and a
//     word holds the 16 rows of its lane, so the step takes the whole run of
//     MATCH parents from row r down in that word (a xor, a mask and a count
//     of leading zeros) plus the one INSERT, DELETE or stop below it. A
//     pair of n rows at a few per cent indels is ~n/16 + indels steps, not
//     ~n; the run's edits are stored by one lane each;
//   * the warp reads the plane a tile at a time, lanes [k - 63, k + 64] of
//     a row block, clamped to the plane, 4 words a lane, into a ring of
//     kRing tiles in shared memory. Entering row block rb, it issues the
//     cp.async copy of row block rb - (kRing - 1), centred where rb was
//     entered, so the copies run kRing - 1 steps ahead of the walk; a cell
//     outside its tile (a long INSERT or DELETE run) loads the tile it
//     needs at once;
//   * the pair's b row sits in shared memory, each lane loads its edit's b
//     code at the start of a step, and edits go back to front into shared
//     buffers of E bytes; the stream then leaves left-aligned and
//     zero-padded through coalesced 16-byte stores.
// Shared memory is 2E + LB + 4 KB; align/tbwave.py checks it against the
// card's limit before the launch.

#include "common.cuh"

namespace pbt {
namespace {

constexpr int TB_WALK = 32;
constexpr int kTile = 128;  // words of a row block a tile holds
constexpr int kRing = 8;    // tiles in the ring: the current row block and the next 7
constexpr unsigned kMatchWord = 0x55555555u;  // MATCH (01) in every 2-bit field

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[x] = s[E - t + x] for x < t, 0 for t <= x < E: bytes to the first
// 16-byte boundary, 16-byte vectors, then the tail
__device__ __forceinline__ void store_left_aligned(uint8_t* __restrict__ dst, const uint8_t* s,
                                                   int E, int t, int lane) {
  const uint8_t* src = s + (E - t);
  const int head = min(E, (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
  for (int x = lane; x < head; x += 32) dst[x] = x < t ? src[x] : 0;
  const int nvec = (E - head) >> 4;
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  for (int v = lane; v < nvec; v += 32) {
    const int x0 = head + 16 * v;
    unsigned w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      w[c] = 0;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int x = x0 + 4 * c + y;
        w[c] |= (x < t ? (unsigned)src[x] : 0u) << (8 * y);
      }
    }
    dv[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int x = head + 16 * nvec + lane; x < E; x += 32) dst[x] = x < t ? src[x] : 0;
}

__global__ void __launch_bounds__(32) walk_kernel(
    const int* __restrict__ parents, int NRB, int S,
    const uint8_t* __restrict__ b, int LB,
    const int* __restrict__ lenb_in, const int* __restrict__ md_in,
    const int* __restrict__ ma_in, const int* __restrict__ mb_in,
    const uint8_t* __restrict__ acc_in, int W, int E, int Es,
    uint8_t* __restrict__ ops, uint8_t* __restrict__ vals, int* __restrict__ nedit) {
  extern __shared__ int4 smem4[];
  int* ring = reinterpret_cast<int*>(smem4);                   // kRing tiles
  uint8_t* os = reinterpret_cast<uint8_t*>(ring + kRing * kTile);  // E ops, back to front
  uint8_t* vs = os + Es;                                       // E vals
  uint8_t* bs = vs + Es;                                       // the pair's b codes
  __shared__ int sbase[kRing];  // first lane of each ring slot's tile

  const int q = blockIdx.x;
  const int lane = threadIdx.x;
  const int* pw = parents + (size_t)q * NRB * S;
  const uint8_t* brow = b + (size_t)q * LB;
  for (int x = lane; x < LB; x += 32) bs[x] = brow[x];
  const int lim = min(lenb_in[q], md_in[q]);
  const int tmax = (E / TB_WALK) * TB_WALK;  // the block rule's most edits
  int i = ma_in[q];
  int j = mb_in[q];
  int t = 0;
  int trb = -1, tbase = 0;  // the current tile's row block and first lane
  const int* tile = ring;
  __syncwarp();

  // the tile of row block rbp from lane base into its ring slot, by cp.async (one group)
  auto prefetch = [&](int rbp, int base) {
    if (rbp >= 0) {
      const int s = rbp & (kRing - 1);
      const int* src = pw + (size_t)rbp * S + base + lane;
#pragma unroll
      for (int c = 0; c < 4; ++c) cp_async4(ring + s * kTile + lane + 32 * c, src + 32 * c);
      if (lane == 0) sbase[s] = base;
    }
    cp_async_commit();
  };

  bool done = acc_in[q] == 0;
  while (!done && t < tmax) {
    // this lane's b code if it stores the step's l-th edit, l = lane
    const uint8_t bv = bs[clampi(j - 1 - lane, 0, LB - 1)];
    int n, p;  // MATCH edits in the run, then the parent below it (-1: none)
    if (i == 0) {
      // row 0: INSERT while 1 <= j <= min(len_b, md), then the stop at j == 0
      n = (j >= 1 && j <= lim) ? j : 0;
      p = 0;
    } else {
      const int k = clampi(j - i + W, 0, S - 1);
      const int im1 = i - 1;
      const int rb = min(im1 >> 4, NRB - 1);
      if (rb != trb || k < tbase || k >= tbase + kTile) {
        const int base = clampi(k - 63, 0, S - kTile);
        int* slot = ring + (rb & (kRing - 1)) * kTile;
        bool have = false;
        if (rb == trb - 1) {
          // the next row block: its copy went out kRing - 1 entries ago
          cp_async_wait<kRing - 2>();
          __syncwarp();
          tbase = sbase[rb & (kRing - 1)];
          have = k >= tbase && k < tbase + kTile;
          prefetch(rb - (kRing - 1), base);
        }
        if (!have) {  // the first tile, or the cell left the window: load it now
          const int* src = pw + (size_t)rb * S + base + lane;
          int w4[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) w4[c] = src[32 * c];
          __syncwarp();
#pragma unroll
          for (int c = 0; c < 4; ++c) slot[lane + 32 * c] = w4[c];
          tbase = base;
          if (trb < 0) {
            for (int d = 1; d < kRing; ++d) prefetch(rb - d, base);
          }
        }
        __syncwarp();
        trb = rb;
        tile = slot;
      }
      const unsigned w = (unsigned)tile[k - tbase];
      const int r = im1 & 15;
      // fields r, r-1, ..., 0 of the word; MATCH fields xor to 00
      const unsigned x = (w ^ kMatchWord) & (0xffffffffu >> (30 - 2 * r));
      const int f = x ? (31 - __clz((int)x)) >> 1 : -1;  // the first non-MATCH field below r
      n = r - f;
      p = f >= 0 ? (int)((w >> (2 * f)) & 3u) : -1;
    }
    const int op = i == 0 ? INSERT : MATCH;
    // the run's edits, then the one below it: edit l by lane l (a MATCH
    // run has at most 16; row 0's INSERT run may be longer)
    const int m = min(n, tmax - t);
    const bool one = m == n && p > 0 && t + n < tmax;
    for (int l = lane; l < m; l += 32) {
      os[E - 1 - t - l] = (uint8_t)op;
      vs[E - 1 - t - l] = l < 32 ? bv : bs[clampi(j - 1 - l, 0, LB - 1)];
    }
    if (one && lane == n) {
      os[E - 1 - t - n] = (uint8_t)p;
      vs[E - 1 - t - n] = p != DELETE ? bv : (uint8_t)0;
    }
    t += m;
    j -= m;
    if (op == MATCH) i -= m;
    if (one) {
      t += 1;
      if (p != INSERT) --i;
      if (p != DELETE) --j;
    }
    done = m < n || p == 0;  // truncated, or a stop
  }
  cp_async_wait<0>();
  __syncwarp();
  store_left_aligned(ops + (size_t)q * E, os, E, t, lane);
  store_left_aligned(vals + (size_t)q * E, vs, E, t, lane);
  if (lane == 0) nedit[q] = t;
}

}  // namespace
}  // namespace pbt

extern "C" int pb_walk(const void* parents, int NRB, int S, const void* b, int LB,
                       const void* len_b, const void* md, const void* ma, const void* mb,
                       const void* acc, int B, int w_max, int E, void* ops, void* vals,
                       void* nedit, void* stream) {
  using namespace pbt;
  if (B <= 0) return (int)cudaSuccess;
  if (S < kTile || NRB < 1) return (int)cudaErrorInvalidValue;
  const int Es = (E + 15) & ~15;
  const size_t smem = (size_t)kRing * kTile * sizeof(int) + 2 * (size_t)Es + LB;
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  walk_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(parents), NRB, S, static_cast<const uint8_t*>(b), LB,
      static_cast<const int*>(len_b), static_cast<const int*>(md),
      static_cast<const int*>(ma), static_cast<const int*>(mb),
      static_cast<const uint8_t*>(acc), w_max, E, Es, static_cast<uint8_t*>(ops),
      static_cast<uint8_t*>(vals), static_cast<int*>(nedit));
  return (int)cudaGetLastError();
}
