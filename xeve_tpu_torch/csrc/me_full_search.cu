// Full-search integer motion estimation on the 16x16 grid, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel xeve_tpu/ops/pallas_me.py:_me_kernel (reached
// through _me_pallas_jit and integer_me_pallas).  Contract, as in the numpy
// oracle enc/analysis_inter_np.integer_me: for every (dx, dy) in [-R, R]^2
// the cost of a block is its SAD plus |dx| + |dy|; the first minimum in
// raster order (dy outer, dx inner) wins.  The plain PyTorch version is
// xeve_tpu_torch/enc/me_torch.py:integer_me_plain.
//
// What bounds it on the card: at 1920x1088 and R = 16 a reference frame
// costs 8160 blocks x 1089 candidates x 256 pels, about 2.3e9 integer
// abs-diff-adds, against about 19 MB of unique input.  So it is bound by
// operations: one abs-diff-add is one __sad, and the SM's 64 INT32 lanes
// per clock make the bound 2.3e9 / (132 x 64 x clock), 0.14 ms at 1.98 GHz.
//
// Design.  The first design (one CTA per block, one thread per candidate)
// loaded both operands of every abs-diff-add from shared memory, so it ran
// at the shared-memory load rate, about a fifth of the bound.  This one
// tiles registers and shares windows:
//  - One CTA takes G = 4 horizontally adjacent blocks of one block row.
//    They share one reference window of (16 + 2R) rows by (16G + 2R)
//    columns, staged once in shared memory.
//  - A thread owns one (block, dy, strip of K = 11 consecutive dx).  For
//    each of the block's 16 rows it loads the current row (16 values, four
//    16-byte broadcast loads) and the window row (16 + K - 1 values) into
//    registers and does 16 x K abs-diff-adds: 0.17 shared loads per
//    abs-diff-add instead of 2.  At R = 16, 2R + 1 = 33 = 3 strips, so a
//    CTA has 4 x 33 x 3 = 396 work items and no ragged candidate pass.  A
//    tail strip (2R + 1 not a multiple of K) computes its overhang on
//    zero-filled columns and masks it out of the minimum.
//  - Consecutive lanes take consecutive dy, so they read consecutive
//    window rows at the same column; the row pitch is odd, which puts the
//    32 lanes of a warp in 32 banks.
//  - Three CTAs per SM (39 warps): the launch bounds hold a thread to 48
//    registers, which ptxas meets without spills.  More warps hide the
//    shared-memory loads at the head of each row and one CTA's staging
//    behind another's arithmetic.
//  - Samples stay int32 in shared memory (23 KB a CTA at R = 16).  Shared
//    memory does not limit the CTAs per SM here (registers and threads
//    do), and 16-bit storage would cost an unpack on the INT32 pipe that
//    bounds the kernel.
//  - First minimum: each thread packs (cost, raster index) into one 64-bit
//    key, cost high; the smallest key is the smallest cost and, among
//    equal costs, the first candidate in raster order.  A segmented
//    min-scan over the warp's lanes of one block, then one shared-memory
//    atomicMin per run of lanes, takes the block's smallest key.  Sums are
//    exact in 32 bits (at most 256 x 1023 + 2R).
//  - For large R the window outgrows shared memory; the host halves G
//    until it fits (G = 1 serves R up to about 100 at 227 KB).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int BLK = 16;
constexpr int K = 11;                    // dx candidates per work item
constexpr int G_MAX = 4;                 // blocks per CTA
constexpr int MAX_THREADS = 416;        // 13 warps: R = 16's 396 items
constexpr int CUR_PITCH = BLK * BLK + 4; // ints per staged block: 16-byte
                                         // aligned, and two blocks' rows
                                         // fall in different banks
constexpr int CUR_OFF = 2 * G_MAX;       // ints: the G_MAX 64-bit keys first
constexpr size_t SMEM_MAX = 232448;      // bytes a CTA may opt in to

struct Geom {
  int G, nstrip, pitch, rows, cols;
  size_t smem;
};

Geom geometry(int R, int G) {
  Geom g;
  g.G = G;
  g.nstrip = (2 * R + 1 + K - 1) / K;
  g.rows = BLK + 2 * R;
  // the last block's tail strip reads up to column 16G + nstrip*K - 2
  g.cols = BLK * G + g.nstrip * K - 1;
  g.pitch = g.cols | 1;
  g.smem = (size_t)(CUR_OFF + G * CUR_PITCH + g.rows * g.pitch) * sizeof(int);
  return g;
}

__global__ void __launch_bounds__(MAX_THREADS, 3)
me_full_search_kernel(const int* __restrict__ cur, const int* __restrict__ ref,
                      int* __restrict__ mv, int* __restrict__ out_cost,
                      int wc, int nbx, int pad, int R, int G, int nstrip,
                      int pitch, int cols) {
  extern __shared__ __align__(16) int smem[];
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(smem);
  int* s_cur = smem + CUR_OFF;              // [G][CUR_PITCH]
  int* s_win = s_cur + G * CUR_PITCH;       // [rows][pitch]

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int bx0 = blockIdx.x * G, by = blockIdx.y;
  const int ng = min(G, nbx - bx0);         // blocks this CTA owns
  const int side = 2 * R + 1;
  const int rows = BLK + 2 * R;
  const int ref_w = wc + 2 * pad;

  if (tid < G) s_key[tid] = ULLONG_MAX;
  // current blocks: row i of the CTA's ng blocks is one run of 16 ng pels
  for (int r = warp; r < BLK; r += nwarps) {
    const int* src = cur + (size_t)(by * BLK + r) * wc + bx0 * BLK;
    for (int c = lane; c < ng * BLK; c += 32)
      s_cur[(c / BLK) * CUR_PITCH + r * BLK + (c % BLK)] = src[c];
  }
  // window origin: the first block's origin shifted by (-R, -R) in the
  // padded plane; columns past the owned blocks' window are zero-filled
  const int valid = ng * BLK + 2 * R;
  for (int r = warp; r < rows; r += nwarps) {
    const int* src = ref + (size_t)(pad + by * BLK - R + r) * ref_w
                     + pad + bx0 * BLK - R;
    int* dst = s_win + r * pitch;
    for (int c = lane; c < cols; c += 32) dst[c] = c < valid ? src[c] : 0;
  }
  __syncthreads();

  const int per_block = side * nstrip;
  const int items = ng * per_block;
  // whole warps walk the items, so that every lane reaches the shuffles
  for (int t0 = warp * 32; t0 < items; t0 += nthr) {
    const int t = t0 + lane;
    const bool active = t < items;
    const int tt = active ? t : items - 1;
    const int g = tt / per_block;
    const int rem = tt - g * per_block;
    const int s = rem / side;
    const int oy = rem - s * side;          // dy + R
    const int ox0 = s * K;                  // dx + R of the strip's first
    const int* w = s_win + oy * pitch + g * BLK + ox0;
    const int4* c4 = reinterpret_cast<const int4*>(s_cur + g * CUR_PITCH);

    unsigned int acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0u;
#pragma unroll 1
    for (int i = 0; i < BLK; ++i) {
      int cr[BLK];
#pragma unroll
      for (int q = 0; q < BLK / 4; ++q) {
        const int4 v = c4[i * (BLK / 4) + q];
        cr[4 * q] = v.x;
        cr[4 * q + 1] = v.y;
        cr[4 * q + 2] = v.z;
        cr[4 * q + 3] = v.w;
      }
      int wr[BLK + K - 1];
#pragma unroll
      for (int j = 0; j < BLK + K - 1; ++j) wr[j] = w[i * pitch + j];
#pragma unroll
      for (int j = 0; j < BLK; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = __sad(cr[j], wr[j + k], acc[k]);
      }
    }

    const int bias_y = abs(oy - R);
    unsigned long long best = ULLONG_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int ox = ox0 + k;
      if (active && ox < side) {
        const unsigned long long cost = acc[k] + abs(ox - R) + bias_y;
        const unsigned long long key =
            (cost << 32) | (unsigned long long)(oy * side + ox);
        best = key < best ? key : best;
      }
    }
    // the lanes of one block are a contiguous run of the warp: a segmented
    // min-scan leaves the run's minimum in its last lane, which alone
    // meets the other warps' keys in shared memory
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long b2 = __shfl_up_sync(0xffffffffu, best, off);
      const int g2 = __shfl_up_sync(0xffffffffu, g, off);
      if (lane >= off && g2 == g && b2 < best) best = b2;
    }
    const int g_next = __shfl_down_sync(0xffffffffu, g, 1);
    if (active && (lane == 31 || t + 1 == items || g_next != g))
      atomicMin(&s_key[g], best);
  }
  __syncthreads();

  if (tid < ng) {
    const unsigned long long key = s_key[tid];
    const int idx = (int)(key & 0xffffffffu);
    const int blk = by * nbx + bx0 + tid;
    mv[2 * blk] = idx % side - R;           // dx
    mv[2 * blk + 1] = idx / side - R;       // dy
    out_cost[blk] = (int)(key >> 32);
  }
}

}  // namespace

// cur: (hc, wc) int32; ref: (hc + 2 pad, wc + 2 pad) int32; mv: (hc/16,
// wc/16, 2) int32; cost: (hc/16, wc/16) int32; all contiguous on the card.
// The caller checks hc, wc multiples of 16 and 0 <= R <= pad.  Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue when even
// one block's window does not fit in shared memory).
extern "C" int xt_me_full_search(const void* cur, const void* ref, void* mv,
                                 void* cost, int hc, int wc, int pad, int R,
                                 void* stream) {
  Geom g = geometry(R, G_MAX);
  while (g.smem > SMEM_MAX && g.G > 1) g = geometry(R, g.G / 2);
  if (g.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        me_full_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nbx = wc / BLK, nby = hc / BLK;
  const int items = g.G * (2 * R + 1) * g.nstrip;
  const int threads = items >= MAX_THREADS ? MAX_THREADS
                                           : (items + 31) / 32 * 32;
  const dim3 grid((nbx + g.G - 1) / g.G, nby);
  me_full_search_kernel<<<grid, threads, g.smem, (cudaStream_t)stream>>>(
      (const int*)cur, (const int*)ref, (int*)mv, (int*)cost, wc, nbx, pad, R,
      g.G, g.nstrip, g.pitch, g.cols);
  return (int)cudaGetLastError();
}
