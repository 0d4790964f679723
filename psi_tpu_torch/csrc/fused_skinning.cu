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
// K1 (forward), on the tensor cores. What bounds it on this card: each input
// read once and the vertices written once are 65 MB at B=256, V=10475, C=497,
// J=55 (31 MB of bf16 basis, 32 MB of f32 vertices), 0.020 ms at 3.35 TB/s;
// its 2 B V (3C + 12J) = 11.5 GFLOP of bf16 products are 0.012 ms at 989
// TFLOP/s. So bytes set the bound, 0.020 ms. Design: K1 is K2's mainloop
// (mma_tile, below) with a light epilogue, after K2's pack launch:
//   1. pack: cb, the A12 planes and cam, zero-padded to Bp bodies (the launch
//      K2 starts with, into K1's own small workspace).
//   2. main, grid (body tiles x vertex tiles of 64 x 32), blockIdx.x the body
//      tile so that the blocks that share a basis tile run together and find
//      it in L2: vp_y = base_vc[y] @ cb^T (K = Cp; three basis tiles share one cb
//      tile), then for each output row x: T_4x..T_4x+3 = w_vj @ A12[:,:,z]^T
//      (K = Jp; four A12 planes share one weight tile) and out_x from them at
//      once, so that only vp, one row's four T planes and the three out_x are
//      live in registers. The epilogue applies cam in f32 in the twin's
//      association order and stages the tile's [bodies][3 x vertices] floats
//      in the (now free) ring, so that each body's run leaves as consecutive
//      4-byte stores: a row of `out` starts only 4-byte aligned (3V floats),
//      so there are no 16-byte stores. Stores are masked to b < B, v < V.
// Nothing is summed across blocks, so two runs give equal bits. Bodies are
// padded to a multiple of 64: at B=16 three quarters of the packed rows, and
// of the one body tile's products, are padding.
// The block is 64 bodies x 32 vertices on 8 warps (each 16 x 16, as in K2's
// coefficient pass) at 128 registers a thread, two blocks an SM. On an NVIDIA
// H100 80GB HBM3 at 700.00 W the main launch takes 0.124 ms, 6.4x the bound,
// and the pack 0.014 ms; a 32 x 32 block on 4 warps took 0.194 ms at 176
// registers and 0.145 ms held to 128. Its ~100 TFLOP/s are a tenth of the
// card's bf16 peak: 16 x 16 warp tiles read about 340 bytes of shared memory
// for every mma, and a k-slab of 32 is 12 mma a warp between two barriers.
// Wider warp tiles on wgmma are the next step.
//
// K2 (backward), on the tensor cores. Every large contraction of
// _bwd_kernel is a bf16 x bf16 product summed in f32 (the TPU kernel rounds
// its operands to bf16 before each jnp.dot), and a product of two bf16 is
// exact in f32, so bf16 mma.sync with f32 accumulators computes the same
// values up to summation order. K2 is one mainloop (mma_tile: bf16
// m16n8k16 mma.sync, A and B k-slabs of 32 staged by 16-byte cp.async into
// a 3-deep shared-memory ring, both operands K-contiguous) used by three
// launches, between a pack and a fixed-order reduce:
//   1. pack: cb, the A12 planes and cam, zero-padded to Bp bodies.
//   2. coefficient pass, grid (body tiles x vertex tiles of 32 x 32):
//      vp_y = base_vc[y] @ cb^T (K = Cp; the three basis tiles share one
//      cb tile) and T_z = w_vj @ A12[:,:,z]^T (K = Jp; four A12 planes per
//      pass share one weight tile): 15 products whose accumulators stay in
//      registers (each thread owns the same (v, b) points of all 15). The
//      epilogue forms, per (b, v) in f32, gout_y = sum_x cam[4x+y] g_x and
//      the 15 bf16 planes coef[15, Bp, Vp], rounded where _bwd_kernel
//      rounds: g_vp_y, gout_x * vp_y, gout_x. They leave through shared
//      memory as 16-byte rows. The 12 f32 g_cam terms are summed over the
//      tile in a fixed order (shuffle butterfly, then the two warp rows).
//   3. g_cb[Bp, Cp] = sum_y coef[y] @ base_cv[y]^T, split over S vertex
//      chunks so that the grid fills the 132 SMs: partials [S, Bp, Cp].
//   4. g_A[12 Bp, Jp] = coef[3:15] @ w_jv^T, the same kernel and split.
//   5. reduce: each output is the sum of its partials in ascending order,
//      written in the wrapper's layouts.
// No atomics anywhere, so two runs give equal bits. All operands are the
// bundle's zero-padded copies (C to Cp, V to Vp, J to Jp) and the pack's
// (bodies to Bp), so every row starts 16-byte aligned and no tile is
// ragged; padded (b, v) points have g = 0 and write zero planes.
//
// What bounds K2 at B=256, V=10475 (Vp=10496, Cp=512, Jp=64): 12.4 GFLOP
// of recompute and 2 B Vp (3 Cp + 12 Jp) = 12.4 GFLOP of reductions, about
// 0.1 ms at 250 TFLOP/s of mma.sync; about 200 MB of device-memory
// traffic (g 32 MB read, coef 80 MB written and read back, partials
// ~15 MB), about 0.06 ms at 3.35 TB/s. The 32 MB bf16 basis in each layout
// is re-read per body tile from L2 (~490 MB of L2 reads in the coefficient
// pass). On an H100 the five launches take ~0.42 ms, the coefficient pass
// ~0.22 of it: its 221 registers a thread leave two 4-warp blocks on an SM,
// too few warps to hide the ring's latency. A wider body tile on wgmma is
// the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BK = 32;       // k per shared-memory slab: two m16n8k16 steps
constexpr int SK = BK + 8;   // slab row pitch in bf16 (80 B): 16-B rows, conflict-free fragment loads
constexpr int STAGES = 3;    // slabs in flight in the shared-memory ring
constexpr int MMA_THREADS = 128;         // 4 warps in every K2 mma block
constexpr int FW_TV = 32, FW_TB = 64;    // K1: vertices x bodies per block
constexpr int FW_WARPS_N = 4;            // K1: warps along the bodies (2 x 4 warps of 16 vertices x 16 bodies)
constexpr int FW_THREADS = 256;
constexpr int FW_MIN_BLOCKS = 2;         // K1: blocks an SM that ptxas must leave registers for (128 a thread)
constexpr int CF_TV = 32, CF_TB = 32;    // coefficient pass: vertices x bodies per block
constexpr int RG_TM = 64, RG_TN = 64;    // reductions: output rows x columns per block
constexpr int NCOEF = 15;    // bf16 planes: 3 g_vp, 12 g_A weights
constexpr int PAD_B = 64;   // the pack pads the bodies to this multiple
constexpr int PAD_C = 64, PAD_J = 64, PAD_V = 256;  // multiples K1 and K2 require of the bundle's widths
constexpr int TARGET_BLOCKS = 264;       // two blocks on each of the 132 SMs
constexpr int RED_THREADS = 256;
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 227 * 1024;

// One row of the blended transform applied to the posed vertex:
// T[3] + T[0] vp[0] + T[1] vp[1] + T[2] vp[2], in this order.
__device__ __forceinline__ float skin_row(const float vp[3], const float T[4]) {
  return T[3] + T[0] * vp[0] + T[1] * vp[1] + T[2] * vp[2];
}

__device__ __forceinline__ void skin_out(const float vp[3], const float T[12], float out[3]) {
#pragma unroll
  for (int x = 0; x < 3; ++x) out[x] = skin_row(vp, T + 4 * x);
}

// ---- the bf16 mma.sync mainloop and its uses: K2's launches, then K1

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Operands of one mma_tile call. A holds NA tiles of BM rows, B holds NB
// tiles of BN rows, `plane` apart; both row-major and K-contiguous (row
// pitches multiples of 8 bf16, so every 16-byte cp.async is aligned). The
// K loop runs over `kplanes` planes (`kplane` apart) and, in each, over
// columns [k0, k1), multiples of BK. Every row in range is valid.
struct MmaOperands {
  const __nv_bfloat16* A;
  int lda;
  size_t a_plane, a_kplane;
  const __nv_bfloat16* B;
  int ldb;
  size_t b_plane, b_kplane;
  int kplanes, k0, k1;
};

template <int BM, int BN, int NA, int NB>
__host__ __device__ constexpr int stage_elems() { return STAGES * (NA * BM + NB * BN) * SK; }

// The mainloop. A block of THREADS computes, for every pair (pa < NA, pb < NB),
//   acc[pa][pb] += sum over K planes q of A_q[pa][0:BM, k0:k1] @ B_q[pb][0:BN, k0:k1]^T
// through a STAGES-deep ring of BK-slabs in shared memory (`stage`,
// stage_elems<BM, BN, NA, NB>() bf16), one __syncthreads per slab. Warp w owns
// rows (w / WARPS_N) * 16MT and columns (w % WARPS_N) * 8NT of each product;
// acc[..][mt][nt] is the m16n8 tile in mma.sync's layout: elements 0,1 at
// (row g, cols 2t, 2t+1), 2,3 at row g+8 (g = lane/4, t = lane%4). Returns
// with every thread past its last read of `stage`.
template <int BM, int BN, int WARPS_N, int MT, int NT, int NA, int NB, int THREADS = MMA_THREADS>
__device__ __forceinline__ void mma_tile(const MmaOperands& o, __nv_bfloat16* stage,
                                         float (&acc)[NA][NB][MT][NT][4]) {
  static_assert(BM == (THREADS / 32 / WARPS_N) * 16 * MT && BN == WARPS_N * 8 * NT, "warp tiling");
  constexpr int ROWS = NA * BM + NB * BN;
  constexpr int CHUNKS = ROWS * (BK / 8);  // 16-byte copies per slab
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int nk = (o.k1 - o.k0) / BK, n_slabs = nk * o.kplanes;

  auto load = [&](int slab) {
    if (slab < n_slabs) {
      const int q = slab / nk, k = o.k0 + (slab % nk) * BK;
      __nv_bfloat16* dst = stage + (slab % STAGES) * ROWS * SK;
      const __nv_bfloat16* A = o.A + q * o.a_kplane + k;
      const __nv_bfloat16* B = o.B + q * o.b_kplane + k;
      for (int i = tid; i < CHUNKS; i += THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const __nv_bfloat16* src;
        if (r < NA * BM) src = A + (r / BM) * o.a_plane + (size_t)(r % BM) * o.lda + c;
        else src = B + ((r - NA * BM) / BN) * o.b_plane + (size_t)((r - NA * BM) % BN) * o.ldb + c;
        cp_async16(dst + r * SK + c, src);
      }
    }
    cp_async_commit();  // possibly empty: wait_group counts stay uniform
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();       // slab s has landed for all; slab s-1's buffer is free
    load(s + STAGES - 1);  // into slab s-1's buffer
    const __nv_bfloat16* As = stage + (s % STAGES) * ROWS * SK;
    const __nv_bfloat16* Bs = As + NA * BM * SK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[NA][MT][4], b[NB][NT][2];
#pragma unroll
      for (int pa = 0; pa < NA; ++pa)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const __nv_bfloat16* p = As + (pa * BM + wm * MT * 16 + mt * 16 + g) * SK + kk + 2 * t;
          a[pa][mt][0] = ld32(p);
          a[pa][mt][1] = ld32(p + 8 * SK);
          a[pa][mt][2] = ld32(p + 8);
          a[pa][mt][3] = ld32(p + 8 * SK + 8);
        }
#pragma unroll
      for (int pb = 0; pb < NB; ++pb)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* q = Bs + (pb * BN + wn * NT * 8 + nt * 8 + g) * SK + kk + 2 * t;
          b[pb][nt][0] = ld32(q);
          b[pb][nt][1] = ld32(q + 8);
        }
#pragma unroll
      for (int pa = 0; pa < NA; ++pa)
#pragma unroll
        for (int pb = 0; pb < NB; ++pb)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[pa][pb][mt][nt], a[pa][mt], b[pb][nt]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The pack, first launch of K1 and of K2: the per-body operands, zero-padded
// to Bp bodies, into the workspace: cb [Bp, Cp], the A12 planes [12, Bp, Jp],
// cam [Bp, 12].
__global__ void skin_pack_kernel(const __nv_bfloat16* __restrict__ cb, const __nv_bfloat16* __restrict__ a12,
                                 const float* __restrict__ cam, __nv_bfloat16* __restrict__ cbp,
                                 __nv_bfloat16* __restrict__ a12p, float* __restrict__ camp, int B, int C,
                                 int J, int Bp, int Cp, int Jp) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Bp * Cp; i += stride) {
    const int b = i / Cp, c = i % Cp;
    cbp[i] = b < B && c < C ? cb[(size_t)b * C + c] : zero;
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 12 * Bp * Jp; i += stride) {
    const int z = i / (Bp * Jp), b = (i / Jp) % Bp, j = i % Jp;
    a12p[i] = b < B && j < J ? a12[((size_t)b * J + j) * 12 + z] : zero;
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Bp * 12; i += stride)
    camp[i] = i < B * 12 ? cam[i] : 0.f;
}

// K1's main launch. Block (body tile, vertex tile) of TB x TV with THREADS / 32
// warps, WARPS_N of them along the bodies. vp first; then, for each output row
// x, the four T planes of that row and out_x from them, so that a thread holds
// vp[3], T[4] and out[3] for its points and never all 12 T planes.
template <int TV, int TB>
__host__ __device__ constexpr int fwd_stage_elems() {
  return stage_elems<TV, TB, 3, 1>() > stage_elems<TV, TB, 1, 4>() ? stage_elems<TV, TB, 3, 1>()
                                                                    : stage_elems<TV, TB, 1, 4>();
}
// Row pitch, in floats, of the tile's [TB][3 TV] vertices staged for the
// stores: 12 mod 16, so that a warp's 32 writes (bodies 2t apart, vertices g
// apart, 3 floats a vertex) fall in 32 banks.
template <int TV>
__host__ __device__ constexpr int fwd_out_pitch() { return 3 * TV + 12 + (16 - 3 * TV % 16) % 16; }

template <int TV, int TB, int WARPS_N, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
skin_fwd_kernel(const __nv_bfloat16* __restrict__ cbp,       // [Bp, Cp]
                const __nv_bfloat16* __restrict__ a12p,      // [12, Bp, Jp]
                const float* __restrict__ camp,              // [Bp, 12]
                const __nv_bfloat16* __restrict__ base_vcp,  // [3, Vp, Cp]
                const __nv_bfloat16* __restrict__ w_vjp,     // [Vp, Jp]
                float* __restrict__ out,                     // [B, V, 3]
                int B, int V, int Bp, int Cp, int Jp, int Vp) {
  constexpr int WARPS_M = THREADS / 32 / WARPS_N, MT = TV / (WARPS_M * 16), NT = TB / (WARPS_N * 8);
  constexpr int OP = fwd_out_pitch<TV>();
  static_assert(PAD_B % TB == 0 && PAD_V % TV == 0, "tiles divide the padded sizes");
  static_assert(TB * OP * sizeof(float) <= fwd_stage_elems<TV, TB>() * sizeof(__nv_bfloat16), "staged tile fits the ring");
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(fwd_smem);
  const int b0 = blockIdx.x * TB, v0 = blockIdx.y * TV;

  float vp[3][1][MT][NT][4] = {};
  mma_tile<TV, TB, WARPS_N, MT, NT, 3, 1, THREADS>(
      MmaOperands{base_vcp + (size_t)v0 * Cp, Cp, (size_t)Vp * Cp, 0, cbp + (size_t)b0 * Cp, Cp, 0, 0, 1, 0, Cp},
      stage, vp);
  float o[3][MT][NT][4];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    float T[1][4][MT][NT][4] = {};
    mma_tile<TV, TB, WARPS_N, MT, NT, 1, 4, THREADS>(
        MmaOperands{w_vjp + (size_t)v0 * Jp, Jp, 0, 0, a12p + ((size_t)4 * x * Bp + b0) * Jp, Jp, (size_t)Bp * Jp,
                    0, 1, 0, Jp},
        stage, T);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p[3] = {vp[0][0][mt][nt][i], vp[1][0][mt][nt][i], vp[2][0][mt][nt][i]};
          const float Tx[4] = {T[0][0][mt][nt][i], T[0][1][mt][nt][i], T[0][2][mt][nt][i], T[0][3][mt][nt][i]};
          o[x][mt][nt][i] = skin_row(p, Tx);
        }
  }

  // epilogue: cam in f32 (the twin's order), the tile to shared memory (the
  // ring is free: mma_tile returned past its last read), then each body's run
  // of 3 * (vertices of the tile) floats out as consecutive 4-byte stores
  float* os = reinterpret_cast<float*>(fwd_smem);  // [TB][OP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane >> 2, t = lane & 3, wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // the two bodies of an accumulator row
      const int bl = (wn * NT + nt) * 8 + 2 * t + q;
      float cm[12];
      const float4* cp = reinterpret_cast<const float4*>(camp + (size_t)(b0 + bl) * 12);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 c = cp[k];
        cm[4 * k] = c.x; cm[4 * k + 1] = c.y; cm[4 * k + 2] = c.z; cm[4 * k + 3] = c.w;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // vertex rows g and g + 8
          const int i = 2 * h + q, vl = (wm * MT + mt) * 16 + gi + h * 8;
          const float ov[3] = {o[0][mt][nt][i], o[1][mt][nt][i], o[2][mt][nt][i]};
          float* dst = os + bl * OP + vl * 3;
#pragma unroll
          for (int x = 0; x < 3; ++x) dst[x] = skin_row(ov, cm + 4 * x);
        }
    }
  __syncthreads();
  const int run = 3 * min(TV, V - v0);  // floats of a body's row that this tile owns
  for (int i = threadIdx.x; i < TB * 3 * TV; i += THREADS) {
    const int bl = i / (3 * TV), c = i % (3 * TV);
    if (b0 + bl < B && c < run) out[((size_t)(b0 + bl) * V + v0) * 3 + c] = os[bl * OP + c];
  }
}

// K2's launch 2, the coefficient pass. Block (body tile, vertex tile) of 32 x 32,
// 2 x 2 warps of 16 vertices x 16 bodies. Each thread holds, for its 8 (v, b)
// points, vp[3] and T[12] in the same accumulator slots.
constexpr int CF_STAGE = stage_elems<CF_TV, CF_TB, 1, 4>();  // the larger of the two products' rings
constexpr int CS_PITCH = CF_TV + 8;  // plane rows staged for the stores: 16-B aligned, banks spread
static_assert(CF_STAGE >= stage_elems<CF_TV, CF_TB, 3, 1>() && CF_STAGE >= NCOEF * CF_TB * CS_PITCH, "coef stage");

__global__ void __launch_bounds__(MMA_THREADS)
skin_bwd_coef_kernel(const __nv_bfloat16* __restrict__ cbp,       // [Bp, Cp]
                     const __nv_bfloat16* __restrict__ a12p,      // [12, Bp, Jp]
                     const float* __restrict__ camp,              // [Bp, 12]
                     const __nv_bfloat16* __restrict__ base_vcp,  // [3, Vp, Cp]
                     const __nv_bfloat16* __restrict__ w_vjp,     // [Vp, Jp]
                     const float* __restrict__ g,                 // [B, V, 3]
                     __nv_bfloat16* __restrict__ coef,            // [15, Bp, Vp]
                     float* __restrict__ gcam_part,               // [Vp / CF_TV, Bp, 12]
                     int B, int V, int Bp, int Cp, int Jp, int Vp) {
  __shared__ __align__(16) __nv_bfloat16 stage[CF_STAGE];
  __shared__ float red[2][CF_TB][12];
  const int b0 = blockIdx.x * CF_TB, v0 = blockIdx.y * CF_TV;

  // vp_y = base_vc[y] @ cb^T: three A tiles share the B tile
  float vp[3][1][1][2][4] = {};
  mma_tile<CF_TV, CF_TB, 2, 1, 2, 3, 1>(
      MmaOperands{base_vcp + (size_t)v0 * Cp, Cp, (size_t)Vp * Cp, 0, cbp + (size_t)b0 * Cp, Cp, 0, 0, 1, 0, Cp},
      stage, vp);
  // T_z = w_vj @ A12[:, :, z]^T, four planes z = 4x..4x+3 per pass
  float T[3][1][4][1][2][4] = {};
#pragma unroll
  for (int x = 0; x < 3; ++x)
    mma_tile<CF_TV, CF_TB, 2, 1, 2, 1, 4>(
        MmaOperands{w_vjp + (size_t)v0 * Jp, Jp, 0, 0, a12p + ((size_t)4 * x * Bp + b0) * Jp, Jp, (size_t)Bp * Jp,
                    0, 1, 0, Jp},
        stage, T[x]);

  // epilogue, per (b, v) in f32: the math and bf16 rounding points of _bwd_kernel.
  // The 15 planes of the 32 x 32 tile go to shared memory first (the ring is
  // free), then out as 16-byte rows.
  __nv_bfloat16* cs = stage;  // [15][CF_TB][CS_PITCH]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;
  float sc[2][2][12] = {};  // g_cam terms of bodies (nt, parity), summed over this thread's vertices
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int bl = wn * 16 + nt * 8 + 2 * t + (i & 1), vl = wm * 16 + gi + (i >> 1) * 8;
      const int b = b0 + bl, v = v0 + vl;
      float gx[3] = {0.f, 0.f, 0.f};
      if (b < B && v < V) {
        const float* gp = g + ((size_t)b * V + v) * 3;
        gx[0] = gp[0]; gx[1] = gp[1]; gx[2] = gp[2];
      }
      const float* cm = camp + (size_t)b * 12;
      float p[3], Tz[12], o[3], gout[3];
#pragma unroll
      for (int y = 0; y < 3; ++y) p[y] = vp[y][0][0][nt][i];
#pragma unroll
      for (int z = 0; z < 12; ++z) Tz[z] = T[z / 4][0][z % 4][0][nt][i];
      skin_out(p, Tz, o);
#pragma unroll
      for (int y = 0; y < 3; ++y) gout[y] = cm[y] * gx[0] + cm[4 + y] * gx[1] + cm[8 + y] * gx[2];
      __nv_bfloat16* cf = cs + bl * CS_PITCH + vl;
      constexpr int PL = CF_TB * CS_PITCH;
#pragma unroll
      for (int y = 0; y < 3; ++y)
        cf[y * PL] = __float2bfloat16_rn(gout[0] * Tz[y] + gout[1] * Tz[4 + y] + gout[2] * Tz[8 + y]);
#pragma unroll
      for (int x = 0; x < 3; ++x) {
#pragma unroll
        for (int y = 0; y < 3; ++y) {
          cf[(3 + 4 * x + y) * PL] = __float2bfloat16_rn(gout[x] * p[y]);
          sc[nt][i & 1][4 * x + y] += gx[x] * o[y];
        }
        cf[(3 + 4 * x + 3) * PL] = __float2bfloat16_rn(gout[x]);
        sc[nt][i & 1][4 * x + 3] += gx[x];
      }
    }
  }
  // g_cam: sum over the warp's 16 vertices (lanes of equal t), then its two warp rows
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int c = 0; c < 12; ++c) {
        float s = sc[nt][q][c];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (gi == 0) red[wm][wn * 16 + nt * 8 + 2 * t + q][c] = s;
      }
  __syncthreads();
  for (int i = threadIdx.x; i < CF_TB * 12; i += MMA_THREADS) {
    const int bl = i / 12, c = i % 12;
    gcam_part[((size_t)blockIdx.y * Bp + b0 + bl) * 12 + c] = red[0][bl][c] + red[1][bl][c];
  }
  constexpr int ROW_CHUNKS = CF_TV / 8;  // 16-byte chunks per plane row
  for (int i = threadIdx.x; i < NCOEF * CF_TB * ROW_CHUNKS; i += MMA_THREADS) {
    const int pr = i / ROW_CHUNKS, c = (i % ROW_CHUNKS) * 8;  // pr = plane * CF_TB + body
    const int pl = pr / CF_TB, bl = pr % CF_TB;
    *reinterpret_cast<uint4*>(coef + ((size_t)pl * Bp + b0 + bl) * Vp + v0 + c) =
        *reinterpret_cast<const uint4*>(cs + pr * CS_PITCH + c);
  }
}

// K2's launches 3 and 4: partial[s] = sum over K planes of A @ B^T over vertex chunk s
// (slabs [s * per, min((s + 1) * per, n_slabs))), 64 x 64 outputs per block,
// 2 x 2 warps of 32 x 32.
__global__ void __launch_bounds__(MMA_THREADS)
splitk_gemm_kernel(const __nv_bfloat16* __restrict__ A, int lda, size_t a_kplane,
                   const __nv_bfloat16* __restrict__ B, int ldb, size_t b_kplane, int kplanes,
                   int per, int n_slabs, float* __restrict__ partial, int ldc, size_t split_stride) {
  __shared__ __align__(16) __nv_bfloat16 stage[stage_elems<RG_TM, RG_TN, 1, 1>()];
  const int n0 = blockIdx.x * RG_TN, m0 = blockIdx.y * RG_TM, s = blockIdx.z;
  float acc[1][1][2][4][4] = {};
  mma_tile<RG_TM, RG_TN, 2, 2, 4, 1, 1>(
      MmaOperands{A + (size_t)m0 * lda, lda, 0, a_kplane, B + (size_t)n0 * ldb, ldb, 0, b_kplane, kplanes,
                  s * per * BK, min(n_slabs, (s + 1) * per) * BK},
      stage, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;
  float* out = partial + s * split_stride;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float(&d)[4] = acc[0][0][mt][nt];
      const int r = m0 + wm * 32 + mt * 16 + gi, c = n0 + wn * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + (size_t)r * ldc + c) = make_float2(d[0], d[1]);
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * ldc + c) = make_float2(d[2], d[3]);
    }
}

// K2's launch 5: each output the sum of its partials in ascending order, written in
// the wrapper's layouts: blockIdx.y 0 -> g_cb [B, C] from [S_cb, Bp, Cp];
// 1 -> g_A12 [B, J, 12] from [S_a, 12, Bp, Jp]; 2 -> g_cam12 [B, 12] from
// [Vp / CF_TV, Bp, 12].
__global__ void reduce_tiles_kernel(const float* __restrict__ part_cb, const float* __restrict__ part_a,
                                    const float* __restrict__ gcam_part, float* __restrict__ g_cb,
                                    float* __restrict__ g_a, float* __restrict__ g_cam, int s_cb, int s_a,
                                    int n_vt, int B, int C, int J, int Bp, int Cp, int Jp) {
  const int i = blockIdx.x * RED_THREADS + threadIdx.x;
  const float* src;
  float* dst;
  int n_tiles;
  size_t stride;
  if (blockIdx.y == 0) {
    if (i >= B * C) return;
    src = part_cb + (size_t)(i / C) * Cp + i % C;
    dst = g_cb + i, n_tiles = s_cb, stride = (size_t)Bp * Cp;
  } else if (blockIdx.y == 1) {
    if (i >= B * J * 12) return;
    const int b = i / (J * 12), j = (i / 12) % J, z = i % 12;
    src = part_a + ((size_t)z * Bp + b) * Jp + j;
    dst = g_a + i, n_tiles = s_a, stride = (size_t)12 * Bp * Jp;
  } else {
    if (i >= B * 12) return;
    src = gcam_part + i;
    dst = g_cam + i, n_tiles = n_vt, stride = (size_t)Bp * 12;
  }
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += src[t * stride];
  *dst = s;
}

// K2's launch plan for padded sizes: the split counts and the workspace carve.
struct BwdPlan {
  int n_slabs, per_cb, s_cb, per_a, s_a;
  size_t off_gcam, off_cb, off_a, off_cbp, off_a12p, off_camp, bytes;  // byte offsets (coef at 0)
};

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// The fewest vertex chunks that give TARGET_BLOCKS blocks, as equal as slabs allow.
void split(int tiles, int n_slabs, int* per, int* s) {
  int want = (TARGET_BLOCKS + tiles - 1) / tiles;
  want = std::max(1, std::min(want, n_slabs));
  *per = (n_slabs + want - 1) / want;
  *s = (n_slabs + *per - 1) / *per;
}

BwdPlan bwd_plan(int Bp, int Cp, int Jp, int Vp) {
  BwdPlan p;
  p.n_slabs = Vp / BK;
  split((Cp / RG_TN) * (Bp / RG_TM), p.n_slabs, &p.per_cb, &p.s_cb);
  split((Jp / RG_TN) * (12 * Bp / RG_TM), p.n_slabs, &p.per_a, &p.s_a);
  p.off_gcam = align256((size_t)NCOEF * Bp * Vp * sizeof(__nv_bfloat16));
  p.off_cb = p.off_gcam + align256((size_t)(Vp / CF_TV) * Bp * 12 * sizeof(float));
  p.off_a = p.off_cb + align256((size_t)p.s_cb * Bp * Cp * sizeof(float));
  p.off_cbp = p.off_a + align256((size_t)p.s_a * 12 * Bp * Jp * sizeof(float));
  p.off_a12p = p.off_cbp + align256((size_t)Bp * Cp * sizeof(__nv_bfloat16));
  p.off_camp = p.off_a12p + align256((size_t)12 * Bp * Jp * sizeof(__nv_bfloat16));
  p.bytes = p.off_camp + align256((size_t)Bp * 12 * sizeof(float));
  return p;
}

int ceil_to(int x, int m) { return (x + m - 1) / m * m; }

bool shapes_ok(int B, int C, int J, int V, int Cp, int Jp, int Vp) {
  return B > 0 && C > 0 && J > 0 && V > 0 && C <= Cp && J <= Jp && V <= Vp && Cp % PAD_C == 0 &&
         Jp % PAD_J == 0 && Vp % PAD_V == 0;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes > SMEM_DEFAULT)
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return cudaSuccess;
}

// K1's workspace: the packed per-body operands.
struct FwdPlan {
  size_t off_a12p, off_camp, bytes;  // byte offsets (cb at 0)
};

FwdPlan fwd_plan(int Bp, int Cp, int Jp) {
  FwdPlan p;
  p.off_a12p = align256((size_t)Bp * Cp * sizeof(__nv_bfloat16));
  p.off_camp = p.off_a12p + align256((size_t)12 * Bp * Jp * sizeof(__nv_bfloat16));
  p.bytes = p.off_camp + align256((size_t)Bp * 12 * sizeof(float));
  return p;
}

void launch_pack(const void* cb, const void* a12, const void* cam, __nv_bfloat16* cbp, __nv_bfloat16* a12p,
                 float* camp, int B, int C, int J, int Bp, int Cp, int Jp, cudaStream_t st) {
  const int n = std::max(Bp * Cp, 12 * Bp * Jp);
  skin_pack_kernel<<<(n + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0, st>>>(
      (const __nv_bfloat16*)cb, (const __nv_bfloat16*)a12, (const float*)cam, cbp, a12p, camp, B, C, J, Bp, Cp, Jp);
}

}  // namespace

// Workspace bytes psi_skin_fwd needs for B bodies and the bundle's padded
// widths (0 if they are not multiples of PAD_C, PAD_J, PAD_V).
extern "C" size_t psi_skin_fwd_workspace(int B, int Cp, int Jp, int Vp) {
  if (!shapes_ok(B, 1, 1, 1, Cp, Jp, Vp)) return 0;
  return fwd_plan(ceil_to(B, PAD_B), Cp, Jp).bytes;
}

// Dynamic shared memory of K1's main launch, in bytes (ptxas does not report it).
extern "C" int psi_skin_fwd_smem() { return fwd_stage_elems<FW_TV, FW_TB>() * sizeof(__nv_bfloat16); }

// K1: verts [B, V, 3] f32 from cb [B, C] and A12 [B, J, 12] (bf16), cam
// [B, 12] (f32) and the bundle's operands zero-padded to Cp, Jp, Vp.
// `stages` selects the launches (1 pack, 2 main; 3 runs both): the main
// launch reads what the pack left in the workspace, so a subset is only for
// timing one launch after a full run.
extern "C" int psi_skin_fwd(const void* cb, const void* a12, const void* cam, const void* base_vcp,
                            const void* w_vjp, void* work, void* out, int B, int C, int J, int V, int Cp,
                            int Jp, int Vp, int stages, void* stream) {
  if (!shapes_ok(B, C, J, V, Cp, Jp, Vp)) return cudaErrorInvalidValue;
  const int Bp = ceil_to(B, PAD_B);
  const cudaStream_t st = (cudaStream_t)stream;
  const FwdPlan p = fwd_plan(Bp, Cp, Jp);
  char* ws = (char*)work;
  __nv_bfloat16* cbp = (__nv_bfloat16*)ws;
  __nv_bfloat16* a12p = (__nv_bfloat16*)(ws + p.off_a12p);
  float* camp = (float*)(ws + p.off_camp);
  cudaError_t err;
  if (stages & 1) {
    launch_pack(cb, a12, cam, cbp, a12p, camp, B, C, J, Bp, Cp, Jp, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 2) {
    const auto kernel = skin_fwd_kernel<FW_TV, FW_TB, FW_WARPS_N, FW_THREADS, FW_MIN_BLOCKS>;
    const size_t smem = psi_skin_fwd_smem();
    if ((err = set_smem((const void*)kernel, smem)) != cudaSuccess) return err;
    kernel<<<dim3((B + FW_TB - 1) / FW_TB, (V + FW_TV - 1) / FW_TV), FW_THREADS, smem, st>>>(
        cbp, a12p, camp, (const __nv_bfloat16*)base_vcp, (const __nv_bfloat16*)w_vjp, (float*)out, B, V, Bp, Cp,
        Jp, Vp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Workspace bytes psi_skin_bwd needs for B bodies and the bundle's padded
// widths Cp, Jp, Vp (0 if they are not multiples of PAD_C, PAD_J, PAD_V).
extern "C" size_t psi_skin_bwd_workspace(int B, int Cp, int Jp, int Vp) {
  if (!shapes_ok(B, 1, 1, 1, Cp, Jp, Vp)) return 0;
  return bwd_plan(ceil_to(B, PAD_B), Cp, Jp, Vp).bytes;
}

// K2: (g_cb [B, C], g_A12 [B, J, 12], g_cam12 [B, 12]) from cb [B, C] and
// A12 [B, J, 12] (bf16), cam [B, 12] and g [B, V, 3] (f32), and the bundle's
// operands zero-padded to Cp, Jp, Vp. `stages` selects the launches (1 pack,
// 2 coefficient pass, 4 g_cb reduction, 8 g_A reduction, 16 reduce; 31 runs
// all five): a launch reads what the earlier ones left in the workspace, so
// a subset is only for timing one launch after a full run.
extern "C" int psi_skin_bwd(const void* cb, const void* a12, const void* cam, const void* base_cvp,
                            const void* base_vcp, const void* w_jvp, const void* w_vjp, const void* g,
                            void* work, void* g_cb, void* g_a, void* g_cam, int B, int C, int J, int V,
                            int Cp, int Jp, int Vp, int stages, void* stream) {
  if (!shapes_ok(B, C, J, V, Cp, Jp, Vp)) return cudaErrorInvalidValue;
  const int Bp = ceil_to(B, PAD_B);
  const cudaStream_t st = (cudaStream_t)stream;
  const BwdPlan p = bwd_plan(Bp, Cp, Jp, Vp);
  char* ws = (char*)work;
  __nv_bfloat16* coef = (__nv_bfloat16*)ws;
  float* gcam_part = (float*)(ws + p.off_gcam);
  float* part_cb = (float*)(ws + p.off_cb);
  float* part_a = (float*)(ws + p.off_a);
  __nv_bfloat16* cbp = (__nv_bfloat16*)(ws + p.off_cbp);
  __nv_bfloat16* a12p = (__nv_bfloat16*)(ws + p.off_a12p);
  float* camp = (float*)(ws + p.off_camp);
  const size_t plane = (size_t)Bp * Vp;
  cudaError_t err;
  if (stages & 1) {
    launch_pack(cb, a12, cam, cbp, a12p, camp, B, C, J, Bp, Cp, Jp, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 2) {
    skin_bwd_coef_kernel<<<dim3(Bp / CF_TB, Vp / CF_TV), MMA_THREADS, 0, st>>>(
        cbp, a12p, camp, (const __nv_bfloat16*)base_vcp, (const __nv_bfloat16*)w_vjp, (const float*)g, coef,
        gcam_part, B, V, Bp, Cp, Jp, Vp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 4) {  // g_cb[Bp, Cp] = sum_y coef[y] @ base_cv[y]^T
    splitk_gemm_kernel<<<dim3(Cp / RG_TN, Bp / RG_TM, p.s_cb), MMA_THREADS, 0, st>>>(
        coef, Vp, plane, (const __nv_bfloat16*)base_cvp, Vp, (size_t)Cp * Vp, 3, p.per_cb, p.n_slabs, part_cb,
        Cp, (size_t)Bp * Cp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 8) {  // g_A[12 Bp, Jp] = coef[3:15] @ w_jv^T
    splitk_gemm_kernel<<<dim3(Jp / RG_TN, 12 * Bp / RG_TM, p.s_a), MMA_THREADS, 0, st>>>(
        coef + 3 * plane, Vp, 0, (const __nv_bfloat16*)w_jvp, Vp, 0, 1, p.per_a, p.n_slabs, part_a, Jp,
        (size_t)12 * Bp * Jp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 16) {
    const int n = std::max(B * C, B * J * 12);
    reduce_tiles_kernel<<<dim3((n + RED_THREADS - 1) / RED_THREADS, 3), RED_THREADS, 0, st>>>(
        part_cb, part_a, gcam_part, (float*)g_cb, (float*)g_a, (float*)g_cam, p.s_cb, p.s_a, Vp / CF_TV, B, C,
        J, Bp, Cp, Jp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
