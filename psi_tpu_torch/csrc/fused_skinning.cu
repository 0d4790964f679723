// Fused SMPL-X skinning on Hopper: K1 (forward) and K2 (backward).
//
// Replaces psi_tpu/ops/fused_skinning.py::_fwd_kernel (K1) and ::_bwd_kernel
// (K2), the Pallas kernels of the 'fused' LBS tier. Per body b and vertex v:
//   vp_y  = sum_c cb[b,c] * base[y,c,v]         C = 1 + n_betas + (J-1)*9
//   T_z   = sum_j A12[b,j,z] * w[j,v]           z = 4x + y, 12 planes
//   out_x = T_{4x+3} + sum_y T_{4x+y} * vp_y
//   fin_x = cam[b,4x+3] + sum_y cam[b,4x+y] * out_y
// cb, A12, base and w are bf16; cam and all sums are f32.
//
// What bounds it on this card: about 2 * (3C + 12J) = 4.3k FLOP per (b, v)
// at C=497, J=55 — 11.5 GFLOP for the forward at B=256, V=10475 — against
// 31 MB of bf16 basis that every body reads. The basis fits in the 50 MB L2,
// so the kernel is bound by L1/L2 traffic and f32 FMA issue, not by HBM.
//
// Design (simple first; no tensor cores yet):
// * K1: a 2-D grid over vertex tiles x body tiles. Each block stages its
//   bodies' cb and A12 rows in shared memory as f32 (the bf16 rounding was
//   done by the caller, exactly where the TPU kernel rounds). Each thread
//   computes one (b, v): a warp is 32 consecutive vertices of one body, so
//   basis loads are coalesced and the staged rows are smem broadcasts; the
//   block's other warps read the same basis lines from L1.
// * K2: the TPU kernel accumulated g_cb / g_A / g_cam serially across its
//   sequential grid. Blocks here run in no order, so the reduction over
//   vertices is two passes, with no atomics and therefore bit-identical
//   results from run to run:
//   pass 1 — per (vertex tile, body tile) block: recompute vp/T/out for
//            each (b, v), form the per-vertex coefficients (g_vp_y and the
//            g_A plane weights rounded to bf16 as the TPU kernel rounds
//            them, and the f32 g_cam terms) into shared memory, then let
//            each thread own output columns k and sum over the tile's
//            vertices in order. Writes partial[tile][b][k].
//   pass 2 — out[b][k] = sum over tiles in ascending order.
//   Output columns: k < C -> g_cb; C + 12j + z -> g_A12[b,j,z];
//   C + 12J + z -> g_cam12[b,z].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FWD_TV = 32;   // vertices per block (threadIdx.x, one warp)
constexpr int FWD_TB = 8;    // bodies per block (threadIdx.y)
constexpr int BWD_TV = 128;  // vertices per backward tile
constexpr int BWD_TB = 4;    // bodies per backward block
constexpr int BWD_THREADS = 256;
constexpr int NZ = 27;       // per-(b,v) coefficients: 3 g_vp, 12 g_A, 12 g_cam
constexpr int RED_THREADS = 256;
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 227 * 1024;

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stage rows [b0, b0+nb) of a [B, n] bf16 matrix as f32 in shared memory
// (zeros past B).
__device__ __forceinline__ void stage_rows(float* dst, const __nv_bfloat16* src, int b0, int nb,
                                           int B, int n, int tid, int nthreads) {
  for (int i = tid; i < nb * n; i += nthreads) {
    const int b = b0 + i / n;
    dst[i] = b < B ? bf(src[(size_t)b * n + i % n]) : 0.f;
  }
}

// vp[3] and T[12] of body row (cbr, ar) at vertex v.
__device__ __forceinline__ void recompute(const float* cbr, const float* ar,
                                          const __nv_bfloat16* __restrict__ base,
                                          const __nv_bfloat16* __restrict__ w_jv,
                                          int C, int J, int V, int v, float vp[3], float T[12]) {
  const size_t plane = (size_t)C * V;
  float v0 = 0.f, v1 = 0.f, v2 = 0.f;
  for (int c = 0; c < C; ++c) {
    const float k = cbr[c];
    const size_t o = (size_t)c * V + v;
    v0 = fmaf(k, bf(base[o]), v0);
    v1 = fmaf(k, bf(base[plane + o]), v1);
    v2 = fmaf(k, bf(base[2 * plane + o]), v2);
  }
  vp[0] = v0; vp[1] = v1; vp[2] = v2;
#pragma unroll
  for (int z = 0; z < 12; ++z) T[z] = 0.f;
  for (int j = 0; j < J; ++j) {
    const float wj = bf(w_jv[(size_t)j * V + v]);
    const float* a = ar + j * 12;
#pragma unroll
    for (int z = 0; z < 12; ++z) T[z] = fmaf(a[z], wj, T[z]);
  }
}

__device__ __forceinline__ void skin_out(const float vp[3], const float T[12], float out[3]) {
#pragma unroll
  for (int x = 0; x < 3; ++x)
    out[x] = T[4 * x + 3] + T[4 * x] * vp[0] + T[4 * x + 1] * vp[1] + T[4 * x + 2] * vp[2];
}

__global__ void skin_fwd_kernel(const __nv_bfloat16* __restrict__ cb,   // [B, C]
                                const __nv_bfloat16* __restrict__ a12,  // [B, J, 12]
                                const float* __restrict__ cam,          // [B, 12]
                                const __nv_bfloat16* __restrict__ base, // [3, C, V]
                                const __nv_bfloat16* __restrict__ w_jv, // [J, V]
                                float* __restrict__ out,                // [B, V, 3]
                                int B, int C, int J, int V) {
  extern __shared__ float smem[];
  float* cb_s = smem;                 // [FWD_TB][C]
  float* a_s = smem + FWD_TB * C;     // [FWD_TB][J * 12]
  const int b0 = blockIdx.y * FWD_TB;
  const int tid = threadIdx.y * FWD_TV + threadIdx.x;
  stage_rows(cb_s, cb, b0, FWD_TB, B, C, tid, FWD_TV * FWD_TB);
  stage_rows(a_s, a12, b0, FWD_TB, B, J * 12, tid, FWD_TV * FWD_TB);
  __syncthreads();

  const int v = blockIdx.x * FWD_TV + threadIdx.x;
  const int b = b0 + threadIdx.y;
  if (v >= V || b >= B) return;
  float vp[3], T[12], o[3];
  recompute(cb_s + threadIdx.y * C, a_s + threadIdx.y * J * 12, base, w_jv, C, J, V, v, vp, T);
  skin_out(vp, T, o);
  const float* cm = cam + (size_t)b * 12;
  float* dst = out + ((size_t)b * V + v) * 3;
#pragma unroll
  for (int x = 0; x < 3; ++x)
    dst[x] = cm[4 * x + 3] + cm[4 * x] * o[0] + cm[4 * x + 1] * o[1] + cm[4 * x + 2] * o[2];
}

__global__ void skin_bwd_partial_kernel(const __nv_bfloat16* __restrict__ cb,
                                        const __nv_bfloat16* __restrict__ a12,
                                        const float* __restrict__ cam,
                                        const __nv_bfloat16* __restrict__ base_cv,  // [3, C, V]
                                        const __nv_bfloat16* __restrict__ base_vc,  // [3, V, C]
                                        const __nv_bfloat16* __restrict__ w_jv,     // [J, V]
                                        const __nv_bfloat16* __restrict__ w_vj,     // [V, J]
                                        const float* __restrict__ g,                // [B, V, 3]
                                        float* __restrict__ partial,                // [nvt, B, K]
                                        int B, int C, int J, int V) {
  extern __shared__ float smem[];
  float* cb_s = smem;                         // [BWD_TB][C]
  float* a_s = cb_s + BWD_TB * C;             // [BWD_TB][J*12]
  float* coef = a_s + BWD_TB * J * 12;        // [BWD_TB][BWD_TV][NZ]
  const int tile = blockIdx.x;
  const int v0 = tile * BWD_TV;
  const int b0 = blockIdx.y * BWD_TB;
  const int tid = threadIdx.x;
  const int K = C + 12 * J + 12;
  stage_rows(cb_s, cb, b0, BWD_TB, B, C, tid, BWD_THREADS);
  stage_rows(a_s, a12, b0, BWD_TB, B, J * 12, tid, BWD_THREADS);
  __syncthreads();

  // phase A: per-(b, v) coefficients
  for (int i = tid; i < BWD_TB * BWD_TV; i += BWD_THREADS) {
    const int tb = i / BWD_TV, vl = i % BWD_TV;
    const int b = b0 + tb, v = v0 + vl;
    float* cf = coef + (size_t)(tb * BWD_TV + vl) * NZ;
    if (b >= B || v >= V) {
#pragma unroll
      for (int z = 0; z < NZ; ++z) cf[z] = 0.f;
      continue;
    }
    float vp[3], T[12], o[3];
    recompute(cb_s + tb * C, a_s + tb * J * 12, base_cv, w_jv, C, J, V, v, vp, T);
    skin_out(vp, T, o);
    const float* gp = g + ((size_t)b * V + v) * 3;
    const float gx[3] = {gp[0], gp[1], gp[2]};
    const float* cm = cam + (size_t)b * 12;
    float gout[3];
#pragma unroll
    for (int y = 0; y < 3; ++y) gout[y] = cm[y] * gx[0] + cm[4 + y] * gx[1] + cm[8 + y] * gx[2];
#pragma unroll
    for (int y = 0; y < 3; ++y)
      cf[y] = round_bf16(gout[0] * T[y] + gout[1] * T[4 + y] + gout[2] * T[8 + y]);
#pragma unroll
    for (int x = 0; x < 3; ++x) {
#pragma unroll
      for (int y = 0; y < 3; ++y) {
        cf[3 + 4 * x + y] = round_bf16(gout[x] * vp[y]);
        cf[15 + 4 * x + y] = gx[x] * o[y];
      }
      cf[3 + 4 * x + 3] = round_bf16(gout[x]);
      cf[15 + 4 * x + 3] = gx[x];
    }
  }
  __syncthreads();

  // phase B: each thread owns columns k and sums the tile's vertices in order
  const int nv = min(BWD_TV, V - v0);
  const size_t plane = (size_t)V * C;
  for (int k = tid; k < K; k += BWD_THREADS) {
    float acc[BWD_TB];
#pragma unroll
    for (int tb = 0; tb < BWD_TB; ++tb) acc[tb] = 0.f;
    if (k < C) {
      for (int vl = 0; vl < nv; ++vl) {
        const size_t o = (size_t)(v0 + vl) * C + k;
        const float e0 = bf(base_vc[o]), e1 = bf(base_vc[plane + o]), e2 = bf(base_vc[2 * plane + o]);
#pragma unroll
        for (int tb = 0; tb < BWD_TB; ++tb) {
          const float* cf = coef + (size_t)(tb * BWD_TV + vl) * NZ;
          acc[tb] += cf[0] * e0 + cf[1] * e1 + cf[2] * e2;
        }
      }
    } else if (k < C + 12 * J) {
      const int j = (k - C) / 12, z = (k - C) % 12;
      for (int vl = 0; vl < nv; ++vl) {
        const float wv = bf(w_vj[(size_t)(v0 + vl) * J + j]);
#pragma unroll
        for (int tb = 0; tb < BWD_TB; ++tb)
          acc[tb] = fmaf(coef[(size_t)(tb * BWD_TV + vl) * NZ + 3 + z], wv, acc[tb]);
      }
    } else {
      const int z = k - C - 12 * J;
      for (int vl = 0; vl < nv; ++vl) {
#pragma unroll
        for (int tb = 0; tb < BWD_TB; ++tb) acc[tb] += coef[(size_t)(tb * BWD_TV + vl) * NZ + 15 + z];
      }
    }
#pragma unroll
    for (int tb = 0; tb < BWD_TB; ++tb) {
      const int b = b0 + tb;
      if (b < B) partial[((size_t)tile * B + b) * K + k] = acc[tb];
    }
  }
}

__global__ void reduce_tiles_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int n_tiles, size_t n) {
  const size_t i = (size_t)blockIdx.x * RED_THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[(size_t)t * n + i];
  out[i] = s;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes > SMEM_DEFAULT)
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return cudaSuccess;
}

}  // namespace

extern "C" int psi_skin_bwd_vtile() { return BWD_TV; }

extern "C" int psi_skin_fwd(const void* cb, const void* a12, const void* cam, const void* base,
                            const void* w_jv, void* out, int B, int C, int J, int V, void* stream) {
  if (B <= 0 || C <= 0 || J <= 0 || V <= 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)FWD_TB * (C + 12 * J) * sizeof(float);
  cudaError_t err = set_smem((const void*)skin_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(FWD_TV, FWD_TB);
  const dim3 grid((V + FWD_TV - 1) / FWD_TV, (B + FWD_TB - 1) / FWD_TB);
  skin_fwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)cb, (const __nv_bfloat16*)a12, (const float*)cam,
      (const __nv_bfloat16*)base, (const __nv_bfloat16*)w_jv, (float*)out, B, C, J, V);
  return cudaGetLastError();
}

extern "C" int psi_skin_bwd(const void* cb, const void* a12, const void* cam, const void* base_cv,
                            const void* base_vc, const void* w_jv, const void* w_vj, const void* g,
                            void* partial, void* out, int B, int C, int J, int V, void* stream) {
  if (B <= 0 || C <= 0 || J <= 0 || V <= 0) return cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)BWD_TB * (C + 12 * J) + (size_t)BWD_TB * BWD_TV * NZ) * sizeof(float);
  cudaError_t err = set_smem((const void*)skin_bwd_partial_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (V + BWD_TV - 1) / BWD_TV;
  const dim3 grid(n_tiles, (B + BWD_TB - 1) / BWD_TB);
  skin_bwd_partial_kernel<<<grid, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)cb, (const __nv_bfloat16*)a12, (const float*)cam,
      (const __nv_bfloat16*)base_cv, (const __nv_bfloat16*)base_vc, (const __nv_bfloat16*)w_jv,
      (const __nv_bfloat16*)w_vj, (const float*)g, (float*)partial, B, C, J, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)B * (C + 12 * J + 12);
  reduce_tiles_kernel<<<(unsigned)((n + RED_THREADS - 1) / RED_THREADS), RED_THREADS, 0,
                        (cudaStream_t)stream>>>((const float*)partial, (float*)out, n_tiles, n);
  return cudaGetLastError();
}
