// Resource-fit mask for the wave kernel's Stage A, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel kubernetes_tpu/ops/pallas_ops.py::fit_mask
// (body `_mask_kernel`). Template t fits node n iff for every resource r:
//     req[t, r] == 0  ||  req[t, r] <= free[n, r]
// with free = allocatable - requested (may be negative: a zero request still
// fits an over-committed node).
//
// Layout: the snapshot's natural [N, R] int32 `free`, [TPL, R] int32 `req`,
// [TPL, N] bool (one byte) `mask`. No padding of R to the TPU's 8 sublanes
// and no transpose: any N, any TPL, and R up to FIT_R_MAX.
//
// What bounds it: launch latency and one exposed memory round trip. The
// work is N*R*4 + TPL*N + TPL*R*4 bytes against TPL*N*R integer compares;
// at the wave path's shape [4, 8192, 6] that is 229,472 bytes, 0.07 us of
// HBM time, far below what any launch costs. So the design removes every
// step that sits between the launch and the single round trip:
//
// * Fill the SMs. A thread owns one node in blocks of FIT_BLOCK = 64
//   threads: 128 blocks at N = 8192. The template axis is cut into tiles of
//   FIT_T_TILE over the grid's y dimension, so a large TPL adds blocks
//   rather than a longer chain per thread. Measured, not guessed: a quad of
//   adjacent nodes per thread with int4 loads and 32-bit mask stores has a
//   quarter of the threads and was slower at every shape timed (PERF.md).
// * No barriers. Every lane of a warp reads the same request words, which
//   the read-only path broadcasts; a tile's FIT_T_TILE * R request loads
//   are all issued before its first compare. There is no shared-memory
//   staging and no __syncthreads().
// * Adjacent threads own adjacent nodes: a warp's R row loads cover one
//   contiguous 32*R*4-byte span, and its mask stores for a template are 32
//   contiguous bytes.
// R is a template parameter (0..FIT_R_MAX, one instantiation each) so the
// per-thread rows live in registers with static indices.

#include <cstdint>
#include <cuda_runtime.h>

#define FIT_R_MAX 16
#define FIT_BLOCK 64    // threads per block, one node each (measured, PERF.md)
#define FIT_T_TILE 4    // templates per grid row, unrolled
#define FIT_GRID_Y_MAX 65535

template <int R>
__global__ void __launch_bounds__(FIT_BLOCK)
fit_mask_kernel(const int32_t* __restrict__ req,
                const int32_t* __restrict__ free_,
                uint8_t* __restrict__ mask, int tpl, int n) {
  const int64_t node = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;

  int32_t v[R > 0 ? R : 1];  // v[k] = free[node, k]
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = __ldg(free_ + node * R + k);

  for (int t0 = blockIdx.y * FIT_T_TILE; t0 < tpl; t0 += gridDim.y * FIT_T_TILE) {
    // the tile's request words, all loads issued before the first compare
    int32_t q[FIT_T_TILE][R > 0 ? R : 1];
#pragma unroll
    for (int i = 0; i < FIT_T_TILE; ++i) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        q[i][k] = t0 + i < tpl ? __ldg(req + (int64_t)(t0 + i) * R + k) : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < FIT_T_TILE; ++i) {
      if (t0 + i >= tpl) break;
      bool ok = true;
#pragma unroll
      for (int k = 0; k < R; ++k) ok &= (q[i][k] == 0) | (q[i][k] <= v[k]);
      mask[(int64_t)(t0 + i) * n + node] = (uint8_t)ok;
    }
  }
}

// The same grid and block with an empty body: the launch floor.
__global__ void fit_mask_floor_kernel() {}

static dim3 fit_grid(int tpl, int n) {
  const int tiles = (tpl + FIT_T_TILE - 1) / FIT_T_TILE;
  return dim3((unsigned)(((int64_t)n + FIT_BLOCK - 1) / FIT_BLOCK),
              (unsigned)(tiles < FIT_GRID_Y_MAX ? tiles : FIT_GRID_Y_MAX));
}

extern "C" int fit_mask_r_max() { return FIT_R_MAX; }

// Launches on `stream` (PyTorch's current stream); never synchronises.
// Returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int fit_mask_launch(const void* req, const void* free_, void* mask,
                               int tpl, int n, int r, void* stream) {
  if (r < 0 || r > FIT_R_MAX) return (int)cudaErrorInvalidValue;
  if (tpl > 0 && n > 0) {
    const dim3 grid = fit_grid(tpl, n);
    const cudaStream_t s = (cudaStream_t)stream;
    const int32_t* rq = (const int32_t*)req;
    const int32_t* fr = (const int32_t*)free_;
    uint8_t* out = (uint8_t*)mask;
    switch (r) {
#define FIT_CASE(R)                                                     \
  case R:                                                               \
    fit_mask_kernel<R><<<grid, FIT_BLOCK, 0, s>>>(rq, fr, out, tpl, n); \
    break;
      FIT_CASE(0) FIT_CASE(1) FIT_CASE(2) FIT_CASE(3) FIT_CASE(4) FIT_CASE(5)
      FIT_CASE(6) FIT_CASE(7) FIT_CASE(8) FIT_CASE(9) FIT_CASE(10)
      FIT_CASE(11) FIT_CASE(12) FIT_CASE(13) FIT_CASE(14) FIT_CASE(15)
      FIT_CASE(16)
#undef FIT_CASE
    }
  }
  return (int)cudaGetLastError();
}

// Measurement entry: an empty kernel with fit_mask_launch's grid and block.
extern "C" int fit_mask_floor_launch(int tpl, int n, void* stream) {
  if (tpl > 0 && n > 0) {
    fit_mask_floor_kernel<<<fit_grid(tpl, n), FIT_BLOCK, 0,
                            (cudaStream_t)stream>>>();
  }
  return (int)cudaGetLastError();
}
