// One-direction nearest-neighbour argmin on Hopper: K3.
//
// Replaces psi_tpu/ops/chamfer.py::_nn_kernel, the Pallas kernel behind
// chamfer_one_sided / chamfer_one_sided_nn: for every point x[b,i], the index
// of its nearest y[b,j] in squared euclidean distance.
//
// What bounds it on this card: B*N*M distance evaluations (9 f32 ops each)
// — 763M pairs at the fit's pruned shape B=256, N=1455, M=2048 and 7.5G at
// the full 20k-point cloud. The y cloud of one body is 24 KB (pruned) or
// 240 KB (full) and is re-read by every x tile, so the work is f32 issue on
// the CUDA cores, not memory.
//
// Design: one thread per x point, a block per (x tile, body); the body's y
// cloud streams through shared memory in tiles, every thread scanning the
// tile in ascending j against its register-resident point (an smem
// broadcast per j), as the original chamfer.cu did. The TPU kernel formed
// |y|^2 - 2 x.y on the matrix unit with a split-bf16 cross term to emulate
// f32; CUDA cores evaluate (x - y)^2 in f32 directly, so that trick is
// dropped. The sum is written with explicit _rn intrinsics, with no FMA
// contraction, so it is the same rounding as the plain twin's
// ((dx^2 + dy^2) + dz^2). Ties go to the lowest index: strict < while j rises.
// Only the index is returned; the caller recomputes the distance in torch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NN_THREADS = 256;
constexpr int NN_TILE = 1024;  // y points per shared-memory tile (12 KB)

__global__ void nn_argmin_kernel(const float* __restrict__ x,  // [B, N, 3]
                                 const float* __restrict__ y,  // [B, M, 3]
                                 int32_t* __restrict__ idx,    // [B, N]
                                 int N, int M) {
  __shared__ float ys[3][NN_TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * NN_THREADS + threadIdx.x;
  const bool valid = i < N;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    const float* p = x + ((size_t)b * N + i) * 3;
    px = p[0]; py = p[1]; pz = p[2];
  }
  const float* yb = y + (size_t)b * M * 3;
  float best = INFINITY;
  int best_j = 0;
  for (int m0 = 0; m0 < M; m0 += NN_TILE) {
    const int cnt = min(NN_TILE, M - m0);
    __syncthreads();  // the previous tile is fully consumed
    for (int t = threadIdx.x; t < cnt; t += NN_THREADS) {
      const float* q = yb + (size_t)(m0 + t) * 3;
      ys[0][t] = q[0]; ys[1][t] = q[1]; ys[2][t] = q[2];
    }
    __syncthreads();
    if (valid) {
      for (int t = 0; t < cnt; ++t) {
        const float dx = px - ys[0][t], dy = py - ys[1][t], dz = pz - ys[2][t];
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (d < best) { best = d; best_j = m0 + t; }
      }
    }
  }
  if (valid) idx[(size_t)b * N + i] = best_j;
}

}  // namespace

extern "C" int psi_nn_argmin(const void* x, const void* y, void* idx, int B, int N, int M,
                             void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + NN_THREADS - 1) / NN_THREADS, B);
  nn_argmin_kernel<<<grid, NN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (int32_t*)idx, N, M);
  return cudaGetLastError();
}
