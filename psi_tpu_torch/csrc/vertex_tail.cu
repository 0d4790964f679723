// The einsum decode's per-vertex tail on Hopper: K6 (forward and gradient).
//
// Replaces no Pallas kernel: psi_tpu leaves this tail to XLA, which fuses it
// into the skinning blend's consumers (psi_tpu/body/lbs.py:198, the apply at
// Precision.HIGHEST; psi_tpu/body/smplx_model.py adds transl and
// psi_tpu/geometry/camera.py::verts_transform the extrinsics). In PyTorch
// the same chain ran as cuBLAS batched products over B*V = 2,681,600 tiny
// matrices (a [3,3]x[3,1] GEMV a vertex forward; a GEMV and a [3,1]x[1,3]
// GEMM a vertex backward, each cut into batches of 65,535) plus a [V,4]x[4,4]
// product a body and their elementwise glue: ~11 ms a fit pass at B = 256 for
// work that moves 72 bytes a vertex forward and 132 backward.
//
// Per vertex (b, v), T its row-major 3x4 blended transform ([B, V, 12], the
// layout K4 writes and K5 reads), p = v_posed, t = transl[b], E = cam_ext[b]:
//   forward   q = T33 p + T3;  w = q + t;  out = E33 w + E3   (E optional)
//   gradient  h = E33^T g (h = g without E);  grad_T = h (x) [p, 1];
//             grad_v = T33^T h;  grad_transl[b] = sum over v of h
// all in f32 with fused multiply-adds, each 3-term dot product summed from
// its first term, as the chain's einsums contract. The bound is the bytes:
// forward T 48 + p 12 in, 12 out; gradient g 12 + T 48 + p 12 in, grad_T 48
// + grad_v 12 out. So one thread a vertex, its T row by three 16-byte loads
// (a row is 48 bytes: 16-byte aligned when T's pointer is), the body on
// blockIdx.y so that t and E are one broadcast load a block. No tensor core
// and no TF32: the arithmetic is a few FMAs a vertex, not the bound.
//
// grad_transl sums over the vertices without atomics, in a fixed order: each
// block sums its VT_THREADS vertices' h by a fixed shuffle tree and a fixed
// walk over its warps into the workspace (one partial a block and
// component), then vtail_reduce_kernel adds a body's partials in block order.
// Every output has one writer: two runs give equal bits. Nothing is
// allocated here; both entry points launch on the stream they are given and
// return cudaGetLastError(), so they capture into a CUDA graph.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int VT_THREADS = 256;  // vertices a block
constexpr int VT_WARPS = VT_THREADS / 32;
constexpr int REDUCE_THREADS = 128;

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

__global__ void __launch_bounds__(VT_THREADS) vtail_fwd_kernel(const float* __restrict__ T,
                                                              const float* __restrict__ p,
                                                              const float* __restrict__ transl,
                                                              const float* __restrict__ E,
                                                              float* __restrict__ out, int V) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * VT_THREADS + threadIdx.x;
  if (i >= V) return;
  const size_t r = (size_t)b * V + i;
  const float4* t4 = reinterpret_cast<const float4*>(T + r * 12);
  const float4 r0 = __ldg(t4), r1 = __ldg(t4 + 1), r2 = __ldg(t4 + 2);
  const float p0 = __ldg(p + 3 * r), p1 = __ldg(p + 3 * r + 1), p2 = __ldg(p + 3 * r + 2);
  float x = dot3(r0.x, r0.y, r0.z, p0, p1, p2) + r0.w;
  float y = dot3(r1.x, r1.y, r1.z, p0, p1, p2) + r1.w;
  float z = dot3(r2.x, r2.y, r2.z, p0, p1, p2) + r2.w;
  if (transl != nullptr) {
    x += __ldg(transl + 3 * b);
    y += __ldg(transl + 3 * b + 1);
    z += __ldg(transl + 3 * b + 2);
  }
  if (E != nullptr) {
    const float* e = E + 16 * (size_t)b;
    const float ox = dot3(__ldg(e + 0), __ldg(e + 1), __ldg(e + 2), x, y, z) + __ldg(e + 3);
    const float oy = dot3(__ldg(e + 4), __ldg(e + 5), __ldg(e + 6), x, y, z) + __ldg(e + 7);
    const float oz = dot3(__ldg(e + 8), __ldg(e + 9), __ldg(e + 10), x, y, z) + __ldg(e + 11);
    x = ox, y = oy, z = oz;
  }
  out[3 * r] = x;
  out[3 * r + 1] = y;
  out[3 * r + 2] = z;
}

// the block's sum of v, in a fixed order; the result is valid in thread 0
__device__ __forceinline__ float block_sum(float v, float* smem) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) smem[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    #pragma unroll
    for (int w = 0; w < VT_WARPS; ++w) s += smem[w];
  }
  __syncthreads();  // smem is read before the next component reuses it
  return s;
}

__global__ void __launch_bounds__(VT_THREADS) vtail_bwd_kernel(const float* __restrict__ T,
                                                              const float* __restrict__ p,
                                                              const float* __restrict__ E,
                                                              const float* __restrict__ g,
                                                              float* __restrict__ gT, float* __restrict__ gp,
                                                              float* __restrict__ partial, int V) {
  __shared__ float smem[VT_WARPS];
  const int b = blockIdx.y;
  const int i = blockIdx.x * VT_THREADS + threadIdx.x;
  float h0 = 0.f, h1 = 0.f, h2 = 0.f;
  if (i < V) {
    const size_t r = (size_t)b * V + i;
    const float g0 = __ldg(g + 3 * r), g1 = __ldg(g + 3 * r + 1), g2 = __ldg(g + 3 * r + 2);
    if (E != nullptr) {
      const float* e = E + 16 * (size_t)b;
      h0 = dot3(__ldg(e + 0), __ldg(e + 4), __ldg(e + 8), g0, g1, g2);
      h1 = dot3(__ldg(e + 1), __ldg(e + 5), __ldg(e + 9), g0, g1, g2);
      h2 = dot3(__ldg(e + 2), __ldg(e + 6), __ldg(e + 10), g0, g1, g2);
    } else {
      h0 = g0, h1 = g1, h2 = g2;
    }
    const float4* t4 = reinterpret_cast<const float4*>(T + r * 12);
    const float4 r0 = __ldg(t4), r1 = __ldg(t4 + 1), r2 = __ldg(t4 + 2);
    const float p0 = __ldg(p + 3 * r), p1 = __ldg(p + 3 * r + 1), p2 = __ldg(p + 3 * r + 2);
    float4* o4 = reinterpret_cast<float4*>(gT + r * 12);
    o4[0] = make_float4(h0 * p0, h0 * p1, h0 * p2, h0);
    o4[1] = make_float4(h1 * p0, h1 * p1, h1 * p2, h1);
    o4[2] = make_float4(h2 * p0, h2 * p1, h2 * p2, h2);
    gp[3 * r] = dot3(r0.x, r1.x, r2.x, h0, h1, h2);
    gp[3 * r + 1] = dot3(r0.y, r1.y, r2.y, h0, h1, h2);
    gp[3 * r + 2] = dot3(r0.z, r1.z, r2.z, h0, h1, h2);
  }
  if (partial == nullptr) return;  // uniform over the block: no transl to differentiate
  const float s0 = block_sum(h0, smem), s1 = block_sum(h1, smem), s2 = block_sum(h2, smem);
  if (threadIdx.x == 0) {
    float* q = partial + 3 * ((size_t)b * gridDim.x + blockIdx.x);
    q[0] = s0, q[1] = s1, q[2] = s2;
  }
}

// grad_transl[b, c] = the sum of body b's block partials of component c, in block order
__global__ void __launch_bounds__(REDUCE_THREADS) vtail_reduce_kernel(const float* __restrict__ partial,
                                                                     float* __restrict__ gt, int B, int blocks) {
  const int t = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (t >= 3 * B) return;
  const int b = t / 3, c = t % 3;
  const float* q = partial + 3 * (size_t)b * blocks + c;
  float s = 0.f;
  for (int k = 0; k < blocks; ++k) s += q[3 * k];
  gt[t] = s;
}

int blocks_per_body(int V) { return (V + VT_THREADS - 1) / VT_THREADS; }

bool shape_ok(int B, int V) { return B > 0 && V > 0 && B <= 65535; }

}  // namespace

// K6 forward: out [B, V, 3] from T [B, V, 12], p [B, V, 3], transl [B, 3] or
// null (no translation), E [B, 4, 4] or null (no extrinsics); all contiguous
// f32, T 16-byte aligned.
extern "C" int psi_vtail_fwd(const void* T, const void* p, const void* transl, const void* E, void* out, int B,
                             int V, void* stream) {
  if (!shape_ok(B, V)) return cudaErrorInvalidValue;
  const dim3 grid(blocks_per_body(V), B);
  vtail_fwd_kernel<<<grid, VT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)T, (const float*)p, (const float*)transl, (const float*)E, (float*)out, V);
  return cudaGetLastError();
}

// Bytes of psi_vtail_bwd's workspace: one partial a block and component.
extern "C" size_t psi_vtail_bwd_workspace(int B, int V) {
  if (!shape_ok(B, V)) return 0;
  return sizeof(float) * 3 * (size_t)B * blocks_per_body(V);
}

// K6 gradient: from g [B, V, 3] (the cotangent of out), grad_T [B, V, 12],
// grad_p [B, V, 3] and, unless gt is null, grad_transl gt [B, 3] through the
// workspace; E as in psi_vtail_fwd. Two launches: the per-vertex pass, then
// the fixed-order reduction (only with gt).
extern "C" int psi_vtail_bwd(const void* T, const void* p, const void* E, const void* g, void* gT, void* gp,
                             void* gt, void* work, int B, int V, void* stream) {
  if (!shape_ok(B, V) || (gt != nullptr && work == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = blocks_per_body(V);
  float* partial = gt != nullptr ? (float*)work : nullptr;
  vtail_bwd_kernel<<<dim3(blocks, B), VT_THREADS, 0, st>>>((const float*)T, (const float*)p, (const float*)E,
                                                           (const float*)g, (float*)gT, (float*)gp, partial, V);
  if (gt != nullptr) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    vtail_reduce_kernel<<<(3 * B + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, st>>>(
        partial, (float*)gt, B, blocks);
  }
  return cudaGetLastError();
}
