// Split-bf16 products on Hopper: K4 (forward) and K5 (a gradient).
//
// Replaces no Pallas kernel: psi_tpu computes these products in XLA
// (psi_tpu/ops/precision.py:43 matmul_f32x3 and :52 einsum_f32x3, the two
// large contractions of its 'high' LBS tier, psi_tpu/body/lbs.py:179,196).
// They are kernels here because the card has no split-bf16 product of its
// own: cuBLAS multiplies f32 in f32 (or TF32), never as hi/lo bf16 halves.
//
// Every product is a batch of T matrix products out[t] = A[t] @ B[t],
// [M, K] @ [K, N], of f32 operands read through strides (in elements), so
// that one kernel takes each layout on the path with no copy. B's and the
// output's column n may be grouped, n = G q + r, at q sq + r sn: the blend
// einsum('vj,bjz->bvz', w, A12) is one product of w [V, J] with the bodies'
// A12 side by side (N = 12 B, G = 12), written straight into [B, V, 12].
// On the path: the pose correctives [B, 486] @ posedirs [486, 31425], the
// blend, and the transposes that their gradients need.
//
// K4 (forward). Each operand element x is cut, as its tile is loaded, into
// hi = bf16(x) (round to nearest even) and lo = bf16(x - hi); x - hi is
// exact in f32, so these are the halves of psi_tpu's _hi_lo. A block keeps
// both halves of its A and B tiles in shared memory and computes, for each
// 16-deep k step, ah.bh + al.bh + ah.bl on bf16 m16n8k16 mma.sync: the
// (hi, lo, hi) x (hi, hi, lo) widened contraction with its three blocks
// interleaved. A bf16 x bf16 product is exact in f32, so this is the twin's
// sum in another order. The tensor cores add into their f32 accumulator
// with truncation toward zero, a bias that a long K would pile up; so each
// k step's products are summed by mma.sync from zero and the step's sum is
// added to the running f32 sum by an ordinary rounded add. On an H100 at
// the correctives' shape this lands within ~4e-7 of max |out| of the
// float64 sum, closer than an f32 sum of the same products by cuBLAS
// (chip_smoke.py's [K4/K5] prints both).
// Nothing is summed across blocks: two runs give equal bits.
//
// K5 (a gradient). A gradient of a split product is a product of the f32
// output cotangent g with the other operand's bf16 halves, each summed in
// f32 and rounded to bf16: H = bf16(g . other_hi), L = bf16(g . other_lo);
// the operand's gradient is H + rp(bf16(H + L) - H) (rp: round to bf16 and
// back; ops/precision.py derives it from JAX's transpose). g is f32, so on
// the tensor cores it is cut into three bf16 parts, which carry it to about
// 2^-27 relative: H's and L's sums then differ from the twin's f32 sums
// only in order. The main launch keeps H's and L's sums over a slice of K
// (split-K, so that a small output with a long K, 256 x 486 over K =
// 31425, still fills the card) and writes both partials; the reduce launch
// adds each output's partials in ascending order, rounds, combines and
// writes the gradient through its strides. No atomics: two runs give equal
// bits.
//
// What bounds them on this card (NVIDIA H100 SXM: 3.35 TB/s, 989 TFLOP/s
// bf16). K4 at the correctives, B = 256: posedirs (61 MB f32) and the pose
// feature read once, [256, 31425] f32 written once: 94 MB, 0.028 ms; its
// 3 x 2 x 256 x 486 x 31425 = 23.5 GFLOP of bf16 products, 0.024 ms. Bytes
// bound it. The blend at B = 256 writes [256, 10475, 12] f32 (129 MB):
// 0.038 ms. Design: the simplest tensor-core kernel that reads every layout
// through strides. Tiles of 64 x 64 (64 x 16 where N <= 16), four warps,
// BK = 32; each thread loads its share of the next slab into registers, two
// k-neighbours of one row at a time (coalesced along whichever of the
// operand's axes has stride 1), while the warps multiply the current one out
// of shared memory; the cut happens between that load and the 32-bit store
// of each k-pair's parts to shared memory. No cp.async, TMA or wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BK = 32;        // k per slab: two m16n8k16 steps
constexpr int SK = BK + 8;    // shared-memory row pitch in bf16 (80 B): conflict-free fragment loads
constexpr int THREADS = 128;  // four warps
constexpr int BM = 64;        // output rows per block
constexpr int BN_WIDE = 64, BN_NARROW = 16;  // output columns per block; narrow where N <= 16
constexpr int TARGET_BLOCKS = 264;  // two blocks on each of the 132 SMs
constexpr int RED_THREADS = 256;
constexpr int MAX_GRID_YZ = 65535;

enum Mode { FWD = 0, GRAD_COT_A = 1, GRAD_COT_B = 2 };

// The bf16 parts each operand is cut into, and the f32 sums a thread keeps.
template <int MODE>
struct Parts;
template <>
struct Parts<FWD> { static constexpr int A = 2, B = 2, ACC = 1; };
template <>
struct Parts<GRAD_COT_A> { static constexpr int A = 3, B = 2, ACC = 2; };
template <>
struct Parts<GRAD_COT_B> { static constexpr int A = 2, B = 3, ACC = 2; };

// An operand: element (t, row, k) at p[t st + (row / G) sq + (row % G) sr + k sk];
// row is the output row m for A (G = its row count, sq unused) and the output
// column n for B.
struct Operand {
  const float* p;
  long long st, sq, sr, sk;
  int G;
};

// The output: (t, m, n) at p[t st + m sm + (n / G) sq + (n % G) sn].
struct Output {
  float* p;
  long long st, sm, sq, sn;
  int G;
};

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

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

// One operand's tile of ROWS rows x BK k, loaded by the block as k-pairs:
// E pairs a thread. Pair slot e of a thread holds (row, k0 + kp) and (row,
// k0 + kp + 1), walking k fastest when the operand's k stride is 1, else the
// rows. Each slot's row offset is fixed over the K loop.
template <int ROWS>
struct Tile {
  static constexpr int E = ROWS * BK / 2 / THREADS;
  static_assert(E * THREADS * 2 == ROWS * BK, "tile loads");
  long long roff[E];  // the slot's row offset in the operand, or -1 past its rows
  float v[2 * E];     // the slab's values, in flight
  bool kfast;

  // slot e's row within the tile and its k pair within the slab
  __device__ __forceinline__ void pos(int e, int& r, int& kp) const {
    const int i = threadIdx.x + e * THREADS;
    r = kfast ? i / (BK / 2) : i % ROWS;
    kp = kfast ? (i % (BK / 2)) * 2 : (i / ROWS) * 2;
  }

  __device__ __forceinline__ void init(const Operand& o, int t, int row0, int rows) {
    kfast = o.sk == 1;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      int r, kp;
      pos(e, r, kp);
      const int gr = row0 + r;
      roff[e] = gr < rows ? t * o.st + (long long)(gr / o.G) * o.sq + (long long)(gr % o.G) * o.sr : -1;
    }
  }

  __device__ __forceinline__ void fetch(const Operand& o, int k0, int K) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      int r, kp;
      pos(e, r, kp);
      const int k = k0 + kp;
      const bool row_ok = roff[e] >= 0;
      const float* q = o.p + (row_ok ? roff[e] : 0) + (long long)k * o.sk;
      v[2 * e] = row_ok && k < K ? q[0] : 0.f;
      v[2 * e + 1] = row_ok && k + 1 < K ? q[o.sk] : 0.f;
    }
  }

  // The slab's values cut into P bf16 parts, each the nearest-even bf16 of
  // what the earlier parts left (every remainder is exact in f32; P = 2 gives
  // psi_tpu's hi, lo), one 32-bit store per k-pair and part into the part
  // planes s[P][ROWS * SK].
  template <int P>
  __device__ __forceinline__ void stash(__nv_bfloat16 (*s)[ROWS * SK]) const {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      int r, kp;
      pos(e, r, kp);
      float x0 = v[2 * e], x1 = v[2 * e + 1];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);  // .x the lower k
        *reinterpret_cast<__nv_bfloat162*>(s[q] + r * SK + kp) = h;
        x0 -= __low2float(h);
        x1 -= __high2float(h);
      }
    }
  }
};

// One block: output tile (blockIdx.x, blockIdx.y) of product t = blockIdx.z / S
// over slabs [s per, min((s + 1) per, n_slabs)) of K, s = blockIdx.z % S.
// FWD writes through `out`; the gradient modes write their two partial sums
// (H then L) to part as [S][2][T][M][N]. Warp w owns rows (w / WARPS_N) 16 MT
// and columns (w % WARPS_N) 8 NT of the tile; acc[h][mt][nt] is an m16n8 tile
// in mma.sync's layout: elements 0,1 at (row g, cols 2q, 2q+1), 2,3 at row
// g + 8 (g = lane / 4, q = lane % 4).
template <int BN, int WARPS_N, int MODE>
__global__ void __launch_bounds__(THREADS)
split_mm_kernel(Operand a, Operand b, int M, int N, int K, int S, int per, Output out, float* __restrict__ part) {
  using P = Parts<MODE>;
  constexpr int WARPS_M = THREADS / 32 / WARPS_N;
  constexpr int MT = BM / (WARPS_M * 16), NT = BN / (WARPS_N * 8);
  static_assert(MT * WARPS_M * 16 == BM && NT * WARPS_N * 8 == BN, "warp tiling");
  __shared__ __align__(16) __nv_bfloat16 as[P::A][BM * SK];
  __shared__ __align__(16) __nv_bfloat16 bs[P::B][BN * SK];

  const int t = blockIdx.z / S, s = blockIdx.z % S;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_slabs = (K + BK - 1) / BK;
  const int slab0 = s * per, slab1 = min(n_slabs, slab0 + per);
  Tile<BM> ta;
  Tile<BN> tb;
  ta.init(a, t, m0, M);
  tb.init(b, t, n0, N);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  float acc[P::ACC][MT][NT][4] = {};

  if (slab0 < slab1) {
    ta.fetch(a, slab0 * BK, K);
    tb.fetch(b, slab0 * BK, K);
  }
  for (int slab = slab0; slab < slab1; ++slab) {
    ta.template stash<P::A>(as);
    tb.template stash<P::B>(bs);
    __syncthreads();  // the slab is in shared memory for all
    if (slab + 1 < slab1) {  // the next one's loads fly while the warps multiply
      ta.fetch(a, (slab + 1) * BK, K);
      tb.fetch(b, (slab + 1) * BK, K);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t fa[P::A][MT][4], fb[P::B][NT][2];
#pragma unroll
      for (int q = 0; q < P::A; ++q)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const __nv_bfloat16* p = as[q] + (wm * MT * 16 + mt * 16 + g) * SK + kk + 2 * qd;
          fa[q][mt][0] = ld32(p);
          fa[q][mt][1] = ld32(p + 8 * SK);
          fa[q][mt][2] = ld32(p + 8);
          fa[q][mt][3] = ld32(p + 8 * SK + 8);
        }
#pragma unroll
      for (int q = 0; q < P::B; ++q)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* p = bs[q] + (wn * NT * 8 + nt * 8 + g) * SK + kk + 2 * qd;
          fb[q][nt][0] = ld32(p);
          fb[q][nt][1] = ld32(p + 8);
        }
      // Each k step's products are summed by mma.sync from zero and the step's
      // sum is added to the running sum by a rounded f32 add, so that the
      // truncation of a tensor-core sum costs one ulp of one step. K4 sums
      // the large product (hi x hi) apart from the two small ones; K5's sums
      // are rounded to bf16 at the end, so there the three parts of g share one.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if constexpr (MODE == FWD) {  // ah.bh, then al.bh + ah.bl
            float big[4] = {}, small[4] = {};
            mma_bf16(big, fa[0][mt], fb[0][nt]);
            mma_bf16(small, fa[1][mt], fb[0][nt]);
            mma_bf16(small, fa[0][mt], fb[1][nt]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[0][mt][nt][i] += big[i] + small[i];
          } else {
            float step[2][4] = {};
#pragma unroll
            for (int q = 2; q >= 0; --q) {  // the smallest part of g first
              if constexpr (MODE == GRAD_COT_A) {  // H = g.bh, L = g.bl
                mma_bf16(step[0], fa[q][mt], fb[0][nt]);
                mma_bf16(step[1], fa[q][mt], fb[1][nt]);
              } else {  // H = ah.g, L = al.g
                mma_bf16(step[0], fa[0][mt], fb[q][nt]);
                mma_bf16(step[1], fa[1][mt], fb[q][nt]);
              }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[h][mt][nt][i] += step[h][i];
          }
        }
    }
    __syncthreads();  // every warp is done with the slab before the next stash
  }

  // Each thread holds the column pair (c, c + 1) of rows r and r + 8: one
  // 8-byte store where the pair lies side by side and 8-byte aligned.
  const int T = gridDim.z / S;
#pragma unroll
  for (int h = 0; h < P::ACC; ++h)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int r = m0 + wm * MT * 16 + mt * 16 + g + rh * 8;
          const int c = n0 + wn * NT * 8 + nt * 8 + 2 * qd;
          if (r >= M || c >= N) continue;
          const float v0 = acc[h][mt][nt][2 * rh], v1 = acc[h][mt][nt][2 * rh + 1];
          float* p0;
          float* p1;
          if constexpr (MODE == FWD) {
            const long long base = t * out.st + r * out.sm;
            p0 = out.p + base + (long long)(c / out.G) * out.sq + (long long)(c % out.G) * out.sn;
            p1 = out.p + base + (long long)((c + 1) / out.G) * out.sq + (long long)((c + 1) % out.G) * out.sn;
          } else {
            p0 = part + (((long long)s * 2 + h) * T + t) * M * N + (long long)r * N + c;
            p1 = p0 + 1;
          }
          if (c + 1 < N && p1 == p0 + 1 && ((uintptr_t)p0 & 7) == 0) {
            *reinterpret_cast<float2*>(p0) = make_float2(v0, v1);
          } else {
            *p0 = v0;
            if (c + 1 < N) *p1 = v1;
          }
        }
}

// K5's reduce: for each output, H's and L's partials summed in ascending
// split order, each rounded to bf16, combined: H + rp(bf16(H + L) - H).
__global__ void split_grad_reduce_kernel(const float* __restrict__ part, Output out, int T, int M, int N, int S) {
  const long long i = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  const long long plane = (long long)T * M * N;
  if (i >= plane) return;
  float sh = 0.f, sl = 0.f;
  for (int s = 0; s < S; ++s) {
    sh += part[(2LL * s) * plane + i];
    sl += part[(2LL * s + 1) * plane + i];
  }
  const float h = bf16r(sh), l = bf16r(sl);
  const float pair = bf16r(h + l);  // the two blocks that pair g with the hi half, added in bf16
  const long long t = i / ((long long)M * N), m = (i / N) % M;
  const int n = (int)(i % N);
  out.p[t * out.st + m * out.sm + (long long)(n / out.G) * out.sq + (long long)(n % out.G) * out.sn] =
      h + bf16r(pair - h);
}

int bn_for(int N) { return N <= BN_NARROW ? BN_NARROW : BN_WIDE; }

// The split of K5's main launch: the fewest K slices that give TARGET_BLOCKS
// blocks, as equal as slabs allow.
struct GradPlan {
  int S, per;
  size_t bytes;  // partials [S][2][T][M][N] f32
};

GradPlan grad_plan(int T, int M, int N, int K) {
  const long long tiles = (long long)T * ((M + BM - 1) / BM) * ((N + bn_for(N) - 1) / bn_for(N));
  const int n_slabs = (K + BK - 1) / BK;
  const long long want = std::max(1LL, std::min<long long>((TARGET_BLOCKS + tiles - 1) / tiles, n_slabs));
  GradPlan p;
  p.per = (int)((n_slabs + want - 1) / want);
  p.S = (n_slabs + p.per - 1) / p.per;
  p.bytes = (size_t)p.S * 2 * T * M * N * sizeof(float);
  return p;
}

bool shapes_ok(int T, int M, int N, int K, int S, int gb, int go) {
  return T > 0 && M > 0 && N > 0 && K > 0 && gb > 0 && go > 0 &&
         (N + BN_NARROW - 1) / BN_NARROW <= MAX_GRID_YZ && (long long)T * S <= MAX_GRID_YZ;
}

template <int MODE>
cudaError_t launch_main(const Operand& a, const Operand& b, int T, int M, int N, int K, int S, int per,
                        const Output& out, float* part, cudaStream_t st) {
  if (N <= BN_NARROW) {
    const dim3 grid((M + BM - 1) / BM, (N + BN_NARROW - 1) / BN_NARROW, T * S);
    split_mm_kernel<BN_NARROW, 1, MODE><<<grid, THREADS, 0, st>>>(a, b, M, N, K, S, per, out, part);
  } else {
    const dim3 grid((M + BM - 1) / BM, (N + BN_WIDE - 1) / BN_WIDE, T * S);
    split_mm_kernel<BN_WIDE, 2, MODE><<<grid, THREADS, 0, st>>>(a, b, M, N, K, S, per, out, part);
  }
  return cudaGetLastError();
}

// A's (t, m, k) at a[t sa_t + m sa_m + k sa_k]; B's (t, k, n) at
// b[t sb_t + k sb_k + (n / gb) sb_q + (n % gb) sb_n].
Operand operand_a(const void* a, long long sa_t, long long sa_m, long long sa_k, int M) {
  return Operand{(const float*)a, sa_t, 0, sa_m, sa_k, M};
}
Operand operand_b(const void* b, long long sb_t, long long sb_k, long long sb_q, long long sb_n, int gb) {
  return Operand{(const float*)b, sb_t, sb_q, sb_n, sb_k, gb};
}

}  // namespace

// K4: c[t] = a[t] @ b[t] with split-bf16 accuracy, f32 out. a's (t, m, k) at
// a[t sa_t + m sa_m + k sa_k]; b's (t, k, n) at b[t sb_t + k sb_k + (n / gb)
// sb_q + (n % gb) sb_n]; c's (t, m, n) at c[t sc_t + m sc_m + (n / gc) sc_q +
// (n % gc) sc_n]. A batch stride may be 0.
extern "C" int psi_split_mm(const void* a, const void* b, void* c, int T, int M, int N, int K, long long sa_t,
                            long long sa_m, long long sa_k, long long sb_t, long long sb_k, long long sb_q,
                            long long sb_n, int gb, long long sc_t, long long sc_m, long long sc_q, long long sc_n,
                            int gc, void* stream) {
  if (!shapes_ok(T, M, N, K, 1, gb, gc)) return cudaErrorInvalidValue;
  const int n_slabs = (K + BK - 1) / BK;
  return launch_main<FWD>(operand_a(a, sa_t, sa_m, sa_k, M), operand_b(b, sb_t, sb_k, sb_q, sb_n, gb), T, M, N, K,
                          1, n_slabs, Output{(float*)c, sc_t, sc_m, sc_q, sc_n, gc}, nullptr, (cudaStream_t)stream);
}

// Workspace bytes psi_split_mm_grad needs for the product's sizes.
extern "C" size_t psi_split_mm_grad_workspace(int T, int M, int N, int K) {
  if (T <= 0 || M <= 0 || N <= 0 || K <= 0) return 0;
  return grad_plan(T, M, N, K).bytes;
}

// K5: out[t] = the split-bf16 gradient whose f32 cotangent is a (cot_is_a = 1)
// or b (0) and whose other operand, the other one, is cut into (hi, lo): H =
// bf16(sum over k with other_hi), L = bf16(... other_lo), out = H + rp(bf16(H +
// L) - H). Strides as psi_split_mm's; `stages` selects the launches (1 main, 2
// reduce; 3 both): the reduce reads what the main launch left in the
// workspace, so a subset is only for timing one launch after a full run.
extern "C" int psi_split_mm_grad(const void* a, const void* b, void* out, void* work, int cot_is_a, int T, int M,
                                 int N, int K, long long sa_t, long long sa_m, long long sa_k, long long sb_t,
                                 long long sb_k, long long sb_q, long long sb_n, int gb, long long so_t,
                                 long long so_m, long long so_q, long long so_n, int go, int stages, void* stream) {
  const GradPlan p = grad_plan(T, M, N, K);
  if (!shapes_ok(T, M, N, K, p.S, gb, go)) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Operand oa = operand_a(a, sa_t, sa_m, sa_k, M), ob = operand_b(b, sb_t, sb_k, sb_q, sb_n, gb);
  const Output o{(float*)out, so_t, so_m, so_q, so_n, go};
  float* part = (float*)work;
  cudaError_t err;
  if (stages & 1) {
    err = cot_is_a ? launch_main<GRAD_COT_A>(oa, ob, T, M, N, K, p.S, p.per, o, part, st)
                   : launch_main<GRAD_COT_B>(oa, ob, T, M, N, K, p.S, p.per, o, part, st);
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    const long long n = (long long)T * M * N;
    split_grad_reduce_kernel<<<(unsigned)((n + RED_THREADS - 1) / RED_THREADS), RED_THREADS, 0, st>>>(part, o, T, M,
                                                                                                       N, p.S);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
