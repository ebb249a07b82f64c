// Resource-fit mask fused with a least-allocated score, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// kubernetes_tpu/ops/pallas_ops.py::fit_mask_least_alloc (body `_kernel`).
// For template t and node n, over resources r = 0..R-1:
//     mask[t, n]  = AND_r (req[t, r] == 0 || req[t, r] <= free[n, r])
//     score[t, n] = (SUM_r w[t, r] * f32(free[n, r] - req[t, r])
//                                  / f32(max(alloc[n, r], 1)))
//                   / max(SUM_r w[t, r], 1)       with w = (req > 0 ? 1 : 0)
//
// Layout: the snapshot's natural [N, R] int32 `free` and `alloc`, [TPL, R]
// int32 `req`, [TPL, N] bool (one byte) `mask` and [TPL, N] float32 `score`.
// No padding of R to the TPU's 8 sublanes, no transpose, no N % 512
// requirement: any N, any TPL, R up to FLA_R_MAX. `free` and `alloc` must be
// 16-byte aligned (the wrapper checks it). A zero-padded resource column
// has w = 0 and fits, so it adds nothing to either output: the results
// equal the reference's padded layout on the real columns.
//
// Arithmetic, in the oracle's order and bit for bit against the plain
// PyTorch version (fit_kernels.fit_mask_least_alloc_plain): the int32
// difference free - req (two's-complement wrap, as int32 tensors wrap),
// converted to f32 with round-to-nearest; an IEEE division by
// f32(max(alloc, 1)); the product with the 0/1 weight; the products summed
// over r = 0..R-1 in order starting from 0; and an IEEE division by
// max(count, 1). Every step is an explicit round-to-nearest intrinsic
// (__fdiv_rn, __fmul_rn, __fadd_rn), and the build adds -fmad=false, so no
// multiply-add is contracted and no fast-math division is substituted.
//
// What bounds it: launch latency, then the IEEE divisions' latency. The
// work moves 2*N*R*4 + TPL*R*4 bytes in and TPL*N*(1 + 4) bytes out for
// TPL*N*(R + 1) divisions; at [16, 8192, 6] that is 1,048,960 bytes, about
// 0.31 us of HBM3 time. A thread that walks every template for its node
// (one node per thread) leaves most SMs idle at this N and chains
// TPL*(R + 1) divisions; so the template axis is parallel too:
//
// * A 2-D grid of node tiles (FLA_TILE_N nodes) by template tiles
//   (FLA_TILE_T templates). Thread (x, y) of a block computes the one output
//   (template y of the tile, node x of the tile): R + 1 divisions. A warp
//   covers 32 adjacent nodes of one template row, so its mask bytes and
//   score words are contiguous stores, and its request words are one
//   broadcast read.
// * The block reads its node tile's free and alloc once, as int4 vectors
//   when the tile is whole (scalar words on the ragged last tile), and keeps
//   free and the denominators f32(max(alloc, 1)) in shared memory, resource-
//   major so the lanes of a warp hit distinct banks; one __syncthreads()
//   then lets every template row of the block use them.
// * When TPL exceeds the grid's y range, a block walks further template
//   tiles over the same shared node tile.
// R is a template parameter (0..FLA_R_MAX, one instantiation each), so the
// resource loop is unrolled with static indices; only the assignment of
// outputs to threads differs from a per-node loop, never the per-output
// arithmetic or its order.

#include <cstdint>
#include <cuda_runtime.h>

#define FLA_R_MAX 16
#define FLA_TILE_N 64  // nodes per block: blockDim.x
#define FLA_TILE_T 4   // templates per block row: blockDim.y
#define FLA_GRID_Y_MAX 65535

template <int R>
__global__ void __launch_bounds__(FLA_TILE_N * FLA_TILE_T)
fit_least_alloc_kernel(const int32_t* __restrict__ req,
                       const int32_t* __restrict__ free_,
                       const int32_t* __restrict__ alloc,
                       uint8_t* __restrict__ mask,
                       float* __restrict__ score, int tpl, int n) {
  constexpr int RS = R > 0 ? R : 1;
  __shared__ int32_t s_free[RS][FLA_TILE_N];
  __shared__ float s_den[RS][FLA_TILE_N];

  const int64_t node0 = (int64_t)blockIdx.x * FLA_TILE_N;
  const int64_t rest = (int64_t)n - node0;
  const int nodes = rest < FLA_TILE_N ? (int)rest : FLA_TILE_N;
  const int tid = threadIdx.y * FLA_TILE_N + threadIdx.x;
  constexpr int threads = FLA_TILE_N * FLA_TILE_T;
  const int32_t* fsrc = free_ + node0 * R;
  const int32_t* asrc = alloc + node0 * R;
  // word w of the tile is (node w / R, resource w % R)
  auto put = [&](int w, int32_t f, int32_t a) {
    s_free[w % RS][w / RS] = f;
    s_den[w % RS][w / RS] = __int2float_rn(a > 1 ? a : 1);
  };
  if (nodes == FLA_TILE_N) {  // FLA_TILE_N * R words = FLA_TILE_N * R / 4 int4
    const int4* fv = reinterpret_cast<const int4*>(fsrc);
    const int4* av = reinterpret_cast<const int4*>(asrc);
    for (int i = tid; i < FLA_TILE_N * R / 4; i += threads) {
      const int4 f = __ldg(fv + i);
      const int4 a = __ldg(av + i);
      put(4 * i, f.x, a.x);
      put(4 * i + 1, f.y, a.y);
      put(4 * i + 2, f.z, a.z);
      put(4 * i + 3, f.w, a.w);
    }
  } else {
    for (int i = tid; i < nodes * R; i += threads) {
      put(i, __ldg(fsrc + i), __ldg(asrc + i));
    }
  }
  // this thread's first template's requests, loaded before the barrier so
  // they travel with the tile's
  const int t_first = blockIdx.y * FLA_TILE_T + threadIdx.y;
  int32_t q[RS];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    q[k] = t_first < tpl ? __ldg(req + (int64_t)t_first * R + k) : 0;
  }

  __syncthreads();

  const int x = threadIdx.x;
  if (x >= nodes) return;  // after the block's only barrier
  for (int t = t_first; t < tpl; t += gridDim.y * FLA_TILE_T) {
    if (t != t_first) {
#pragma unroll
      for (int k = 0; k < R; ++k) q[k] = __ldg(req + (int64_t)t * R + k);
    }
    bool ok = true;
    float acc = 0.0f;
    float cnt = 0.0f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int32_t f = s_free[k][x];
      ok = ok && (q[k] == 0 || q[k] <= f);
      const int32_t d = (int32_t)((uint32_t)f - (uint32_t)q[k]);
      const float frac = __fdiv_rn(__int2float_rn(d), s_den[k][x]);
      const float w = q[k] > 0 ? 1.0f : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(frac, w));
      cnt = __fadd_rn(cnt, w);
    }
    const int64_t o = (int64_t)t * n + node0 + x;
    mask[o] = ok ? 1 : 0;
    score[o] = __fdiv_rn(acc, fmaxf(cnt, 1.0f));
  }
}

// The same grid and block with an empty body: the launch floor.
__global__ void fit_least_alloc_floor_kernel() {}

static dim3 fla_grid(int tpl, int n) {
  const int tiles = (tpl + FLA_TILE_T - 1) / FLA_TILE_T;
  return dim3((unsigned)(((int64_t)n + FLA_TILE_N - 1) / FLA_TILE_N),
              (unsigned)(tiles < FLA_GRID_Y_MAX ? tiles : FLA_GRID_Y_MAX));
}

extern "C" int fit_least_alloc_r_max() { return FLA_R_MAX; }

// Launches on `stream` (PyTorch's current stream); never synchronises.
// Returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int fit_least_alloc_launch(const void* req, const void* free_,
                                      const void* alloc, void* mask,
                                      void* score, int tpl, int n, int r,
                                      void* stream) {
  if (r < 0 || r > FLA_R_MAX) return (int)cudaErrorInvalidValue;
  if (tpl > 0 && n > 0) {
    const dim3 grid = fla_grid(tpl, n);
    const dim3 block(FLA_TILE_N, FLA_TILE_T);
    const cudaStream_t s = (cudaStream_t)stream;
    const int32_t* rq = (const int32_t*)req;
    const int32_t* fr = (const int32_t*)free_;
    const int32_t* al = (const int32_t*)alloc;
    switch (r) {
#define FLA_CASE(R)                                                  \
  case R:                                                            \
    fit_least_alloc_kernel<R><<<grid, block, 0, s>>>(                \
        rq, fr, al, (uint8_t*)mask, (float*)score, tpl, n);          \
    break;
      FLA_CASE(0) FLA_CASE(1) FLA_CASE(2) FLA_CASE(3) FLA_CASE(4)
      FLA_CASE(5) FLA_CASE(6) FLA_CASE(7) FLA_CASE(8) FLA_CASE(9)
      FLA_CASE(10) FLA_CASE(11) FLA_CASE(12) FLA_CASE(13) FLA_CASE(14)
      FLA_CASE(15) FLA_CASE(16)
#undef FLA_CASE
    }
  }
  return (int)cudaGetLastError();
}

// Measurement entry: an empty kernel with fit_least_alloc_launch's grid and
// block.
extern "C" int fit_least_alloc_floor_launch(int tpl, int n, void* stream) {
  if (tpl > 0 && n > 0) {
    fit_least_alloc_floor_kernel<<<fla_grid(tpl, n),
                                   dim3(FLA_TILE_N, FLA_TILE_T), 0,
                                   (cudaStream_t)stream>>>();
  }
  return (int)cudaGetLastError();
}
