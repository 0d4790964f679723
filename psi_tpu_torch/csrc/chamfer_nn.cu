// One-direction nearest-neighbour argmin on Hopper: K3.
//
// Replaces psi_tpu/ops/chamfer.py::_nn_kernel, the Pallas kernel behind
// chamfer_one_sided / chamfer_one_sided_nn / chamfer_distance: for every
// point x[b,i], the index of its nearest y[b,j] in squared euclidean
// distance, ties to the lowest j.
//
// What bounds it on this card: B*N*M distance evaluations — 763M pairs at the
// fit's pruned shape B=256, N=1455, M=2048 and 7.5G at the full 20k-point
// cloud. The y cloud of one body is 24 KB (pruned) or 240 KB (full) and is
// re-read from L2 by every x tile, so the work is f32 issue on the CUDA
// cores, not memory. The distance is written with explicit _rn intrinsics,
// with no FMA contraction, so that it is the same rounding as the plain
// twin's ((dx^2 + dy^2) + dz^2): 3 subtractions, 3 multiplications and 2
// additions a pair that cannot fuse. An SM issues 4 warp instructions a
// clock, so those 8 set the floor, and the design spends as little as it can
// on everything else:
//
// * NN_R x points live in each thread's registers, and the y tile lies in
//   shared memory as float4 (x, y, z, unused): one warp-uniform 16-byte load
//   brings a y point for NN_R pairs (1/NN_R loads a pair).
// * A distance is a sum of squares: +0 or above, +inf, or the canonical NaN
//   0x7fffffff that every f32 add and multiply returns. Bit patterns with a
//   clear sign order as signed integers exactly as the floats do, with NaN
//   above +inf, so the scan works on the bits: the minimum over NN_CHUNK
//   consecutive y points is taken by the three-way integer minimum of
//   Hopper's DPX unit (__vimin3_s32: one instruction for two pairs, where
//   fminf takes one a pair), and compared once a chunk: `chunk_min < best`,
//   strict, remembers the chunk's first j. No index is tracked per pair and
//   the hot loop has no branch.
// * Before a tile leaves shared memory, a thread whose best chunk lies in it
//   recomputes that chunk's NN_CHUNK distances (the same instructions on the
//   same operands: the same bits) and takes the first j whose distance
//   equals the minimum.
//   Ties stay with the lowest j: a later chunk replaces the best only by
//   being strictly smaller, so the remembered chunk is the first that holds
//   the overall minimum, and within it the scan for equality runs down to
//   the lowest j. A NaN distance never wins (it lies above the initial
//   +inf), as `d < best` refused it in a per-pair scan; when no distance is
//   below +inf the index stays 0.
// * The tiles arrive through a two-deep cp.async ring (three 4-byte copies a
//   point: the 12-byte points have no 16-byte alignment), the next tile in
//   flight while this one is scanned. The last tile is padded to a whole
//   chunk with points at +inf, whose distance is +inf or NaN and never wins.
// * A block covers NN_R * NN_THREADS x points of one body; the body is
//   folded into blockIdx.x, so B is bounded by 2^31 / blocks a body only.
//   Point r of a thread is NN_THREADS apart from point r - 1: loads and the
//   int64 index stores of a warp are contiguous.
//
// The TPU kernel formed |y|^2 - 2 x.y on the matrix unit with a split-bf16
// cross term to emulate f32; a K=3 product wastes a tensor-core tile and the
// expansion cancels between near neighbours, so the CUDA cores evaluate
// (x - y)^2 in f32 directly. Only the index is returned, as int64; the
// caller recomputes the distance in torch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NN_THREADS = 128;  // threads a block
constexpr int NN_R = 4;          // x points a thread
constexpr int NN_TILE = 1024;    // y points a shared-memory tile (16 KB as float4; two in the ring)
constexpr int NN_CHUNK = 16;     // y points between two compares against the best
static_assert(NN_TILE % NN_CHUNK == 0 && NN_CHUNK % 2 == 0, "a tile is a whole number of chunks, a chunk of pairs");

// ((dx^2 + dy^2) + dz^2), every operation rounded on its own: the twin's bits
__device__ __forceinline__ float dist2(float px, float py, float pz, const float4 q) {
  const float dx = px - q.x, dy = py - q.y, dz = pz - q.z;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// the distance's bit pattern: sign clear, so it orders as a signed integer
__device__ __forceinline__ int dist2_bits(float px, float py, float pz, const float4 q) {
  return __float_as_int(dist2(px, py, pz, q));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// start the copy of y points [m0, m0 + cnt) of one body into a tile; one commit group
__device__ __forceinline__ void stage_tile(float4* tile, const float* __restrict__ yb, int m0, int cnt) {
  for (int p = threadIdx.x; p < cnt; p += NN_THREADS) {
    const float* q = yb + (size_t)(m0 + p) * 3;
    float* s = reinterpret_cast<float*>(tile + p);
    cp_async4(s, q);
    cp_async4(s + 1, q + 1);
    cp_async4(s + 2, q + 2);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(NN_THREADS)
nn_argmin_kernel(const float* __restrict__ x,  // [B, N, 3]
                 const float* __restrict__ y,  // [B, M, 3]
                 long long* __restrict__ idx,  // [B, N]
                 int N, int M, int blocks_per_body) {
  __shared__ float4 ys[2][NN_TILE];
  const int b = blockIdx.x / blocks_per_body;
  const int i0 = (blockIdx.x - b * blocks_per_body) * (NN_R * NN_THREADS) + threadIdx.x;
  float px[NN_R], py[NN_R], pz[NN_R];
  int best[NN_R];     // bits of the least distance so far
  int chunk_j[NN_R];  // first j of the chunk that holds it; -1: none yet
  int best_j[NN_R];   // its index, resolved tile by tile
  #pragma unroll
  for (int r = 0; r < NN_R; ++r) {
    const int i = i0 + r * NN_THREADS;
    px[r] = py[r] = pz[r] = 0.f;
    if (i < N) {
      const float* p = x + ((size_t)b * N + i) * 3;
      px[r] = p[0]; py[r] = p[1]; pz[r] = p[2];
    }
    best[r] = __float_as_int(INFINITY);
    chunk_j[r] = -1;
    best_j[r] = 0;
  }
  const float* yb = y + (size_t)b * M * 3;
  const int ntiles = (M + NN_TILE - 1) / NN_TILE;
  stage_tile(ys[0], yb, 0, min(NN_TILE, M));
  for (int k = 0; k < ntiles; ++k) {
    const int m0 = k * NN_TILE;
    const int cnt = min(NN_TILE, M - m0);
    float4* tile = ys[k & 1];
    if (k + 1 < ntiles) {  // the other buffer was released by the barrier that ended tile k - 1
      stage_tile(ys[(k + 1) & 1], yb, m0 + NN_TILE, min(NN_TILE, M - m0 - NN_TILE));
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    const int padded = (cnt + NN_CHUNK - 1) / NN_CHUNK * NN_CHUNK;
    for (int t = cnt + threadIdx.x; t < padded; t += NN_THREADS)
      tile[t] = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    __syncthreads();  // every thread's copies and the padding are in the tile

    for (int t = 0; t < padded; t += NN_CHUNK) {
      int cmin[NN_R];
      #pragma unroll
      for (int r = 0; r < NN_R; ++r) cmin[r] = best[r];
      #pragma unroll
      for (int c = 0; c < NN_CHUNK; c += 2) {
        const float4 q0 = tile[t + c], q1 = tile[t + c + 1];
        #pragma unroll
        for (int r = 0; r < NN_R; ++r)
          cmin[r] = __vimin3_s32(cmin[r], dist2_bits(px[r], py[r], pz[r], q0), dist2_bits(px[r], py[r], pz[r], q1));
      }
      #pragma unroll
      for (int r = 0; r < NN_R; ++r) {
        if (cmin[r] < best[r]) chunk_j[r] = m0 + t;
        best[r] = cmin[r];
      }
    }

    #pragma unroll
    for (int r = 0; r < NN_R; ++r) {
      if (chunk_j[r] >= m0) {  // the best moved into this tile: find its j while the tile is here
        const float4* q = tile + (chunk_j[r] - m0);
        int first = 0;
        #pragma unroll
        for (int c = NN_CHUNK - 1; c >= 0; --c)
          if (dist2_bits(px[r], py[r], pz[r], q[c]) == best[r]) first = c;
        best_j[r] = chunk_j[r] + first;
      }
    }
    __syncthreads();  // the tile is consumed: the copy after next may overwrite it
  }
  #pragma unroll
  for (int r = 0; r < NN_R; ++r) {
    const int i = i0 + r * NN_THREADS;
    if (i < N) idx[(size_t)b * N + i] = best_j[r];
  }
}

}  // namespace

extern "C" int psi_nn_argmin(const void* x, const void* y, void* idx, int B, int N, int M,
                             void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return cudaErrorInvalidValue;
  const int blocks_per_body = (N + NN_R * NN_THREADS - 1) / (NN_R * NN_THREADS);
  const long long blocks = (long long)B * blocks_per_body;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  nn_argmin_kernel<<<(unsigned)blocks, NN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (long long*)idx, N, M, blocks_per_body);
  return cudaGetLastError();
}
