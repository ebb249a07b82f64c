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
// What bounds it: memory and launch latency. The work is N*R*4 + TPL*N +
// TPL*R*4 bytes against TPL*N*R integer compares — under one compare per
// byte moved, far below the card's compute line. At the wave path's shapes
// (N = 8192, R = 6, TPL <= 64) that is at most ~0.7 MB, a fraction of a
// microsecond of HBM time, so the launch itself dominates.
//
// Design against that: one thread owns one node. It reads its R free values
// once into registers (they are reused for every template), the block stages
// the requests in shared memory in chunks of FIT_T_CHUNK templates (so any
// TPL fits in a fixed 16 KB), and the thread then walks the templates writing
// mask[t, n]: adjacent threads write adjacent bytes, so each warp's stores
// coalesce into 32-byte segments. One launch covers the whole [TPL, N] mask;
// there is no second pass and no atomics.

#include <cstdint>
#include <cuda_runtime.h>

#define FIT_R_MAX 16
#define FIT_T_CHUNK 256
#define FIT_BLOCK 256

__global__ void __launch_bounds__(FIT_BLOCK)
fit_mask_kernel(const int32_t* __restrict__ req,
                const int32_t* __restrict__ free_,
                uint8_t* __restrict__ mask,
                int tpl, int n, int r) {
  __shared__ int32_t s_req[FIT_T_CHUNK * FIT_R_MAX];
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = node < n;

  int32_t f[FIT_R_MAX];
#pragma unroll
  for (int k = 0; k < FIT_R_MAX; ++k) {
    f[k] = (live && k < r) ? free_[(int64_t)node * r + k] : 0;
  }

  for (int t0 = 0; t0 < tpl; t0 += FIT_T_CHUNK) {
    const int tc = min(FIT_T_CHUNK, tpl - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < tc * r; i += blockDim.x) {
      s_req[i] = req[(int64_t)t0 * r + i];
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < tc; ++t) {
        bool ok = true;
#pragma unroll
        for (int k = 0; k < FIT_R_MAX; ++k) {
          if (k < r) {
            const int32_t q = s_req[t * r + k];
            ok = ok && (q == 0 || q <= f[k]);
          }
        }
        mask[(int64_t)(t0 + t) * n + node] = ok ? 1 : 0;
      }
    }
  }
}

extern "C" int fit_mask_r_max() { return FIT_R_MAX; }

// Launches on `stream` (PyTorch's current stream); never synchronises.
// Returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int fit_mask_launch(const void* req, const void* free_, void* mask,
                               int tpl, int n, int r, void* stream) {
  if (r < 0 || r > FIT_R_MAX) return (int)cudaErrorInvalidValue;
  if (tpl > 0 && n > 0) {
    const dim3 block(FIT_BLOCK);
    const dim3 grid((n + FIT_BLOCK - 1) / FIT_BLOCK);
    fit_mask_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)req, (const int32_t*)free_, (uint8_t*)mask, tpl, n, r);
  }
  return (int)cudaGetLastError();
}
