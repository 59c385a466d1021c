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
// abs-diff-adds, while each block reads only its 10 KB window once.  So it
// is bound by integer instruction throughput and shared-memory loads, not
// by device-memory bytes.
//
// Design (simple first): one thread block per 16x16 block.  The current
// block and its (16 + 2R)^2 reference window are staged in shared memory
// as int32; threads stride over the (2R + 1)^2 candidates in raster order
// and accumulate SAD + bias in 32-bit integers (at most 256 * 1023 + 2R, so
// exact); a warp-shuffle then shared-memory reduction picks the minimum of
// (cost, raster index), which keeps the first minimum.  Reads of the
// current block are broadcasts; neighbouring threads read neighbouring
// window columns.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int BLK = 16;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ void keep_first_min(int& cost, int& idx,
                                               int cost2, int idx2) {
  if (cost2 < cost || (cost2 == cost && idx2 < idx)) {
    cost = cost2;
    idx = idx2;
  }
}

__global__ void __launch_bounds__(NTHREADS)
me_full_search_kernel(const int* __restrict__ cur, const int* __restrict__ ref,
                      int* __restrict__ mv, int* __restrict__ out_cost,
                      int wc, int pad, int R) {
  extern __shared__ int smem[];
  __shared__ int s_cost[NWARPS];
  __shared__ int s_idx[NWARPS];
  const int win = BLK + 2 * R;
  int* s_cur = smem;                 // BLK * BLK
  int* s_win = smem + BLK * BLK;     // win * win

  const int bx = blockIdx.x, by = blockIdx.y;
  const int tid = threadIdx.x;
  const int ref_w = wc + 2 * pad;

  for (int k = tid; k < BLK * BLK; k += NTHREADS) {
    const int i = k / BLK, j = k % BLK;
    s_cur[k] = cur[(size_t)(by * BLK + i) * wc + bx * BLK + j];
  }
  // window origin: block origin shifted by (-R, -R) in the padded plane
  const int y0 = pad + by * BLK - R, x0 = pad + bx * BLK - R;
  for (int k = tid; k < win * win; k += NTHREADS) {
    const int i = k / win, j = k % win;
    s_win[k] = ref[(size_t)(y0 + i) * ref_w + x0 + j];
  }
  __syncthreads();

  const int side = 2 * R + 1;
  const int ncand = side * side;
  int best = INT_MAX, best_idx = INT_MAX;
  for (int c = tid; c < ncand; c += NTHREADS) {
    const int oy = c / side, ox = c % side;      // dy + R, dx + R
    const int* w = s_win + oy * win + ox;
    unsigned int acc = 0;
#pragma unroll 4
    for (int i = 0; i < BLK; ++i) {
#pragma unroll
      for (int j = 0; j < BLK; ++j)
        acc = __sad(s_cur[i * BLK + j], w[i * win + j], acc);
    }
    const int cost = (int)acc + abs(ox - R) + abs(oy - R);
    if (cost < best) {           // c rises per thread: strict < keeps first
      best = cost;
      best_idx = c;
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    const int c2 = __shfl_down_sync(0xffffffffu, best, off);
    const int i2 = __shfl_down_sync(0xffffffffu, best_idx, off);
    keep_first_min(best, best_idx, c2, i2);
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    s_cost[warp] = best;
    s_idx[warp] = best_idx;
  }
  __syncthreads();
  if (tid == 0) {
    int bc = s_cost[0], bi = s_idx[0];
    for (int k = 1; k < NWARPS; ++k) keep_first_min(bc, bi, s_cost[k], s_idx[k]);
    const int blk = by * gridDim.x + bx;
    mv[2 * blk] = bi % side - R;       // dx
    mv[2 * blk + 1] = bi / side - R;   // dy
    out_cost[blk] = bc;
  }
}

}  // namespace

// cur: (hc, wc) int32; ref: (hc + 2 pad, wc + 2 pad) int32; mv: (hc/16,
// wc/16, 2) int32; cost: (hc/16, wc/16) int32; all contiguous on the card.
// The caller checks hc, wc multiples of 16 and 0 <= R <= pad.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int xt_me_full_search(const void* cur, const void* ref, void* mv,
                                 void* cost, int hc, int wc, int pad, int R,
                                 void* stream) {
  const int win = BLK + 2 * R;
  const size_t smem = (size_t)(BLK * BLK + win * win) * sizeof(int);
  // above 48 KB (static reduction arrays included) only as opted-in
  // dynamic shared memory; at R = 16 the launch needs 10 KB
  if (smem + 2 * NWARPS * sizeof(int) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        me_full_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(wc / BLK, hc / BLK);
  me_full_search_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const int*)cur, (const int*)ref, (int*)mv, (int*)cost, wc, pad, R);
  return (int)cudaGetLastError();
}
