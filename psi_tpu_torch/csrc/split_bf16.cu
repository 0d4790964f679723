// Split-bf16 products on Hopper: K4 (forward) and K5 (a gradient), on wgmma.
//
// Replaces no Pallas kernel: psi_tpu computes these products in XLA
// (psi_tpu/ops/precision.py:43 matmul_f32x3 and :52 einsum_f32x3, the two
// large contractions of its 'high' LBS tier, psi_tpu/body/lbs.py:179,196).
// They are kernels here because the card has no split-bf16 product of its
// own: cuBLAS multiplies f32 in f32 (or TF32), never as hi/lo bf16 halves.
//
// Every product is a batch of T products out[t] = A[t] @ B[t] of f32
// operands read through strides. A's rows and the contraction are index axes
// in groups (Axis: index i is member i % r of group i / r and exists where
// i / r < q and i % r < g), so that one kernel takes each product of the
// path with no copy of an operand: the blend einsum('vj,bjz->bvz', w, A12)
// is rows (b, z) of A12 (16 laid out a body, 12 used) against w^T, written
// straight into [B, V, 12]; its weights' gradient contracts over the grouped
// axis (b, z), so the sum over the bodies comes before the bf16 rounding as
// in JAX's transpose; a 2-D lhs under a batched rhs contracts over (t, n).
//
// Operands. A varies per call (the pose feature, A12, the f32 cotangent g):
// wgmma takes it from registers (64 rows a consumer warpgroup), cut there
// into bf16 parts. B is cut once by the pack launch (split_pack_kernel) into
// a bf16 hi plane and a bf16 lo plane, 4 bytes an element like its f32
// source, padded and laid out as wgmma reads it: per column panel of NB and
// ring stage of KC = 64 k, the two planes' core matrices (8 columns x 8 k,
// 128 contiguous bytes, no swizzle), one contiguous run a stage, which the
// producer moves with ONE cp.async.bulk into a shared-memory ring, completion
// on the stage's mbarrier. No tensor map: TMA's tiled maps want 16-byte
// strides, and posedirs' rows are 125,700 B, the pose feature's 1,944 B, the
// weights' 220 B; the pack is what makes the constants bulk-copyable, so the
// library links no -lcuda. A reaches registers by one of two routes:
// * the slab route, where A's rows are contiguous in one k group (the pose
//   feature; the correctives' cotangent g): each producer thread moves one
//   row's 16-byte-aligned span around its 64 k by one bulk copy into the
//   stage (plain loads for floats past the tensor's last whole 16 bytes); the
//   consumers read 4 neighbouring k a row from shared memory, and the pack
//   orders each 16 k so that those four are the thread's fragment slots;
// * the register route otherwise (A12; the blend's cotangent, whose rows
//   (b, z) step 12 floats along v): plain loads straight into the fragment
//   registers, one stage ahead.
// The wrapper (ops/precision.py) keeps the planes of a B that takes no
// gradient in a cache keyed on a weak reference to the tensor and its
// _version, and packs any other B every call. On every 'high' path that is
// posedirs in K4's layout (K = 512 x N = 31,488) and in K5's (K = 31,488 x
// N = 512), 64.5 MB each, and lbs_weights in both (2.7 MB each): 134 MB of
// device memory, rebuilt when the source changes in place or is replaced. A
// pack launch inside a K4 or K5 wrapper call does not change their
// Kernel.launches; it counts on its own Kernel.
//
// K4 (forward): out = ah.bh + al.bh + ah.bl, each bf16 x bf16 product exact
// in f32 (hi = bf16(x) to nearest even, lo = bf16(x - hi), x - hi exact in
// f32). The tensor cores add into their f32 accumulator with truncation
// toward zero, which a long K would pile up into a bias: so each 16-deep k
// step is summed by wgmma from zero (scale-d = 0) in the order al.bh, ah.bl,
// ah.bh (the small products first, so that the step's one truncation at
// full magnitude is the big one's), and the step's sum is added to a running
// f32 sum in registers by a rounded add: PR 16's per-step scheme, which held
// K4 within 4.3e-7 of max |out| of the float64 sum (chip_smoke.py's
// K4_REL_TOL is 2e-6; cuBLAS's f32 sum of the same products is 1.8e-6 to
// 2.8e-6 off). Blocks never share an output: two runs give equal bits.
//
// K5 (a gradient): H = bf16(g . other_hi), L = bf16(g . other_lo), gradient
// H + rp(bf16(H + L) - H) (rp: round to bf16 and back). The cotangent g is
// always A, cut into three bf16 parts (about 2^-27 relative); the other
// operand's halves are the packed planes. H and L are two chains, each a
// stage's sum from zero (12 wgmma deep) added to a running sum: H and L are
// rounded to bf16, and that chunk keeps the truncation bias near 1e-6
// relative, far inside a bf16 step. The stages are split over blocks
// (split-K) so that a small output with a long K fills the card: the main
// launch writes each slice's H and L partials, the reduce launch adds an
// output's partials in ascending slice order, rounds and combines. No
// atomics: two runs give equal bits.
//
// Blocks are persistent, one an SM: two consumer warpgroups and a producer
// warpgroup (setmaxnreg moves the producer's registers to the consumers),
// walking the work items row tile fastest so that blocks which share a B
// stage run together. K4's step and running sums take 2 floats an output
// (K5's four), which caps a block's tile at 128 x 128 (K5: 128 x 64).
// Bounds (NVIDIA H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16) and the design:
// * K4 correctives, pose feature [B, 486] @ posedirs [486, 31425], B = 256:
//   94 MB moved once, 0.028 ms; 23.5 GFLOP, 0.024 ms: bytes, nearly
//   balanced. Slab route, tiles of 128 rows x 128 columns; the pose feature
//   is read again by each of the 246 column tiles (from L2) and posedirs by
//   both row tiles: ~250 MB through L2, which bounds it. Its rows of 31,425
//   floats take no vector store: the tile goes out row by row, coalesced,
//   from shared memory, which leaves room for a ring of two stages. B = 32:
//   one 64-row tile, the warpgroups on two 64-column halves, three stages;
//   posedirs once, 0.0195 ms.
// * K4 blend at B = 256: the [256, 10475, 12] output, 129 MB, 0.039 ms:
//   bytes. K = 55 is one stage. A warpgroup's 64 x 128 tile (4 bodies x 128
//   vertices) goes into shared memory as each body's contiguous run of 128
//   x 12 f32 and out by one bulk store a body, double-buffered, so that the
//   stores overlap the next tile's products.
// * K5 correctives, g [B, 31425] @ posedirs^T: 47 GFLOP, 0.047 ms:
//   operations. Slab route, tiles of 128 rows x 64 columns, K in slices.
// * K5 blend (A12's gradient: rows (b, z) of g against w, K = V) and the
//   weights' gradient (rows v of g against A12, K = (b, z)): each reads g
//   (129 MB) once, 0.039 ms: bytes. Register route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int KC = 64;                 // k a ring stage (four wgmma k steps)
constexpr int NSTAGE = 4;              // ring depth, where the shared memory holds it
constexpr unsigned SMEM_MAX = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr int WG = 128;                // threads a warpgroup
constexpr int THREADS = 3 * WG;        // two consumer warpgroups and the producer's
constexpr int APITCH = KC + 8;         // a slab row of A: floats (a 16-byte span of up to KC + 3, and a pad)
constexpr int RUN_G = 12;              // K4's body runs: at most 12 rows a group (the blend's 3 x 4)
constexpr int NB_FWD = 128, NB_GRAD = 64;  // a block's columns: the packed panel width
constexpr int RED_THREADS = 256, PACK_THREADS = 256;

enum Mode { FWD = 0, GRAD = 1 };

// An index axis in groups: index i is member i % r of group i / r; it exists
// where i / r < q and i % r < g. q * r indices; the contraction's r is a
// multiple of 16, so that no wgmma k step spans two groups.
struct Axis {
  int q, r, g;
};

// A (the register operand): element (t, m, k) at p[t st + (m / r) sq + (m % r) sr + (k / r') skq + (k % r')
// skr]; n elements from p may be read.
struct Lhs {
  const float* p;
  long long st, sq, sr, skq, skr, n;
};

// The output (K4) or the gradient (K5): (t, m, n) at p[t st + (m / r) sq + (m % r) sr + n sn].
struct Out {
  float* p;
  long long st, sq, sr, sn;
};

// The work of one launch: T x S x m_tiles x n_tiles items, an item the
// block's 64 WGM x NB output tile over stages [s per, min((s + 1) per, k_stages)).
struct Plan {
  int T, N;
  Axis m, k;
  int m_tiles, n_tiles, k_stages, S, per;
  long long b_t;  // packed bf16 elements a batch entry of B (0: one B for all)
};

struct Item {
  int t, s, mt, nt, ks0, ks1;
};

__device__ __forceinline__ Item item_of(int it, const Plan& p) {
  Item w;
  w.mt = it % p.m_tiles;
  it /= p.m_tiles;
  w.nt = it % p.n_tiles;
  it /= p.n_tiles;
  w.s = it % p.S;
  w.t = it / p.S;
  w.ks0 = w.s * p.per;
  w.ks1 = min(p.k_stages, w.ks0 + p.per);
  return w;
}

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) { return *reinterpret_cast<uint32_t*>(&h); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// ---- mbarriers, the bulk copy, named barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Shared -> global bulk store, tracked by this thread's bulk groups.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Makes this thread's shared-memory writes visible to the bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(WG) : "memory");
}

// ---- wgmma

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// Keeps the compiler from moving reads of accumulators above the wait that completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Waits for the chunk's wgmma and adds each chain's chunk sum to its running sum.
template <int ACC, int CHAINS>
__device__ __forceinline__ void add_chunk(float (&run)[CHAINS][ACC], float (&step)[CHAINS][ACC]) {
  wg_wait0();
#pragma unroll
  for (int h = 0; h < CHAINS; ++h) {
    fence_regs(step[h]);
#pragma unroll
    for (int i = 0; i < ACC; ++i) run[h][i] += step[h][i];
  }
}

// The shared-memory descriptor of a K-major bf16 tile in the packed layout:
// no swizzle; core matrices of 8 columns x 16 bytes of k, 128 contiguous
// bytes; the next one along k 128 bytes on (leading byte offset), along the
// columns KC / 8 cores on (stride byte offset).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  constexpr uint64_t LBO = 128, SBO = (KC / 8) * 128;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) | ((SBO >> 4) << 32);
}

// d (m64 x n32 f32, wgmma's accumulator layout) (+)= a (64 x 16 bf16, registers) . the n32 x 16 B tile
// at desc; scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %21, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

// d (m64 x n64 f32, wgmma's accumulator layout) (+)= a (64 x 16 bf16, registers) . the n64 x 16 B tile
// at desc; scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

// d (m64 x n128 f32, wgmma's accumulator layout) (+)= a (64 x 16 bf16, registers) . the n128 x 16 B tile
// at desc; scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  if constexpr (BN == 32) {
    wgmma_n32(d, a, desc, scale_d);
  } else if constexpr (BN == 64) {
    wgmma_n64(d, a, desc, scale_d);
  } else {
    wgmma_n128(d, a, desc, scale_d);
  }
}

// ---- the register operand

// This thread's eight A values of one wgmma k step at k0 (rows m and m + 8
// of its two rows, k = k0 + 2 q + {0, 1, 8, 9}): v[4 h + c] is row h, k
// offset (c & 1) + 8 (c >> 1). Zero where a row or a k does not exist.
__device__ __forceinline__ void load8(float (&v)[8], const Lhs& a, const long long (&rb)[2], const bool (&rv)[2],
                                      int k0, const Axis& k, int q) {
  const int kq = k0 / k.r, kr0 = k0 - kq * k.r + 2 * q;
  const long long kb = (long long)kq * a.skq;
  const bool gq = kq < k.q;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kr = kr0 + (c & 1) + (c >> 1) * 8;
      v[4 * h + c] = rv[h] && gq && kr < k.g ? __ldg(a.p + rb[h] + kb + (long long)kr * a.skr) : 0.f;
    }
}

// The eight values cut into P bf16 parts, each the nearest-even bf16 of what
// the earlier parts left (every remainder is exact in f32; P = 2 gives
// psi_tpu's hi, lo), as wgmma's A fragments: f[p] = {(row, k 2q..), (row + 8,
// k 2q..), (row, k 2q+8..), (row + 8, k 2q+8..)}, the lower k in the low half.
template <int P>
__device__ __forceinline__ void cut(const float (&v)[8], uint32_t (&f)[P][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = (i & 1) * 4 + (i >> 1) * 2;
    float x0 = v[j], x1 = v[j + 1];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      f[p][i] = bits(h);
      x0 -= __low2float(h);
      x1 -= __high2float(h);
    }
  }
}

// ---- the product kernel

// The dynamic shared memory of an instance: the ring (a stage: B's two bf16
// planes of NB x KC, then on the slab route A's WGM 64 rows x KC f32 slab),
// K4's staging (a warpgroup: on the register route two buffers of 4 groups x
// BN x RUN_G f32, which also hold its 64-row tile at a pitch of BN + 8; on
// the slab route that tile alone), the 2 x STAGES mbarriers; as many stages
// as fit beside the staging, up to NSTAGE (K4's 128-row slab route: 2).
template <int MODE, int BN, int WGN, bool SLAB>
struct Smem {
  static constexpr unsigned B_STAGE = 4u * BN * WGN * KC;
  static constexpr unsigned A_ROWS = 64u * (2 / WGN);
  static constexpr unsigned STAGE = B_STAGE + (SLAB ? A_ROWS * APITCH * 4 : 0);
  static constexpr unsigned PITCH = BN + 8;
  static constexpr unsigned RUN_BUF = 4u * BN * RUN_G;  // floats: one buffer of a warpgroup's body runs
  static constexpr unsigned WG_STAGING = MODE == GRAD ? 0 : SLAB ? 64 * PITCH : 2 * RUN_BUF;  // floats
  static constexpr unsigned FIT = (SMEM_MAX - 2 * WG_STAGING * 4) / (STAGE + 16);
  static constexpr int STAGES = FIT < NSTAGE ? FIT : NSTAGE;
  static constexpr unsigned BYTES = STAGES * STAGE + 2 * WG_STAGING * 4 + 2 * STAGES * 8;
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static_assert(2 * RUN_BUF >= 64 * PITCH, "the row tile fits the body-run buffers");
};

// The slab route, the producer's share: row `pt` of the item's rows, k
// [ks KC, ks KC + KC), into the slab row at `dst` (16-byte aligned). A's
// rows (the pose feature, the cotangent) are contiguous in k but only 4-byte
// aligned: one bulk copy
// moves the 16-byte-aligned span that holds the 64 floats, so the row lands
// off = (its address % 16) / 4 floats into the slab row; the span stops at
// the tensor's last whole 16 bytes, and plain loads take the floats past it.
// Returns the bulk copy's bytes (the caller's expect_tx) and its source.
__device__ __forceinline__ unsigned slab_row(float* dst, const Lhs& a, const Plan& pl, const Item& w, int m, int ks,
                                             const float*& src) {
  const int mq = m / pl.m.r, mr = m - mq * pl.m.r;
  if (mq >= pl.m.q || mr >= pl.m.g) return 0;
  const long long e0 = w.t * a.st + mq * a.sq + mr * a.sr + (long long)ks * KC;
  const uintptr_t from = (uintptr_t)(a.p + e0), base = from & ~(uintptr_t)15;
  const uintptr_t want = from + 4 * KC, last = (uintptr_t)(a.p + a.n), whole = last & ~(uintptr_t)15;
  const uintptr_t up = (want + 15) & ~(uintptr_t)15, to = up < whole ? up : whole, end = want < last ? want : last;
  for (uintptr_t t = to > from ? to : from; t < end; t += 4)  // floats past the tensor's last whole 16 bytes
    dst[(t - base) / 4] = *reinterpret_cast<const float*>(t);
  src = reinterpret_cast<const float*>(base);
  return to > base ? (unsigned)(to - base) : 0;
}

// Warps 0-7 are two consumer warpgroups, warps 8-11 the producer's. Warpgroup
// w owns rows (w if WGN == 1) 64 + [0, 64) and columns (w if WGN == 2) BN +
// [0, BN) of the item's tile; in wgmma's accumulator layout its thread holds
// d[4 j + {0, 1}] at (row 16 warp + g, column 8 j + 2 q + {0, 1}) and d[4 j
// + {2, 3}] at row + 8 (g = lane / 4, q = lane % 4). A is read from the slab
// where SLAB, else straight into registers, a stage ahead.
template <int MODE, int BN, int WGN, bool SLAB>
__global__ void __launch_bounds__(THREADS, 1)
    split_wgmma_kernel(Lhs a, const __nv_bfloat16* __restrict__ b, Out out, float* __restrict__ part, Plan pl) {
  using SM = Smem<MODE, BN, WGN, SLAB>;
  constexpr int WGM = 2 / WGN, NB = BN * WGN, ACC = BN / 2, P = MODE == FWD ? 2 : 3, CHAINS = MODE == FWD ? 1 : 2;
  constexpr bool PER_STEP = MODE == FWD;  // K4 sums each k step apart, K5 each stage
  // setmaxnreg: 2 x 128 consumer + 128 producer registers <= 65,536; the slab's producers copy rows, the
  // register route's consumers hold a stage of A in flight (K5's 64-column tile needs ~236 to spill nothing)
  constexpr int PRODUCER_REGS = SLAB ? 56 : 24, CONSUMER_REGS = SLAB ? 224 : 240;
  extern __shared__ __align__(128) unsigned char smem[];
  float* staging = reinterpret_cast<float*>(smem + SM::STAGES * SM::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::STAGES * SM::STAGE + 2 * SM::WG_STAGING * 4);
  uint64_t* empty = full + SM::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < SM::STAGES; ++s) {
      mbar_init(&full[s], SLAB ? WG : 1);  // the producers' arrivals, each with its bytes
      mbar_init(&empty[s], 8);             // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int items = pl.T * pl.S * pl.m_tiles * pl.n_tiles;  // under 2^31: launch_product checks

  if (warp >= 8) {  // the producer: a stage once the consumers have released its slot
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = tid - 2 * WG;
    if (!SLAB && pt != 0) return;
    int slot = 0;
    unsigned phase = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const Item w = item_of(it, pl);
      const __nv_bfloat16* src = b + w.t * pl.b_t + (long long)w.nt * pl.k_stages * (SM::B_STAGE / 2);
      for (int ks = w.ks0; ks < w.ks1; ++ks) {
        mbar_wait(&empty[slot], phase ^ 1);
        unsigned char* stage = smem + slot * SM::STAGE;
        unsigned bytes = 0;
        const float* row = nullptr;
        float* dst = reinterpret_cast<float*>(stage + SM::B_STAGE) + pt * APITCH;
        if constexpr (SLAB) {
          if (pt < (int)SM::A_ROWS) bytes = slab_row(dst, a, pl, w, w.mt * WGM * 64 + pt, ks, row);
        }
        mbar_expect_tx(&full[slot], bytes + (pt == 0 ? SM::B_STAGE : 0));  // after any plain stores: release
        if (pt == 0)  // B's stage: one contiguous run of the packed planes
          bulk_load(stage, src + (long long)ks * (SM::B_STAGE / 2), SM::B_STAGE, &full[slot]);
        if (bytes) bulk_load(dst, row, bytes, &full[slot]);
        if (++slot == SM::STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3, wt = tid & (WG - 1);
  const int wm = WGN == 1 ? wg : 0, wn = WGN == 1 ? 0 : wg;
  const int kend = pl.k.q * pl.k.r;
  const uint32_t ring = smem_u32(smem) + wn * (BN / 8) * (KC / 8) * 128;  // this warpgroup's columns
  const long long Mp = (long long)pl.m_tiles * WGM * 64, Np = (long long)pl.n_tiles * NB;
  // K4's body runs go out by bulk stores where the output takes them (the blend): groups of 16 rows, each
  // a dense (column, row) run of 16-byte multiples, 16-byte aligned
  const bool runs = MODE == FWD && !SLAB && pl.m.r == 16 && pl.m.g <= RUN_G && pl.m.g % 4 == 0 && out.sr == 1 &&
                    out.sn == pl.m.g && ((uintptr_t)out.p & 15) == 0 && (out.st & 3) == 0 && (out.sq & 3) == 0;
  int slot = 0, buf = 0;
  unsigned phase = 0;
  // K4: run, the running sum; step, one k step's. K5: H's and L's of each.
  float run[CHAINS][ACC], step[CHAINS][ACC];
#pragma unroll
  for (int h = 0; h < CHAINS; ++h)
#pragma unroll
    for (int i = 0; i < ACC; ++i) step[h][i] = 0.f;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item w = item_of(it, pl);
    const int m0 = w.mt * WGM * 64 + wm * 64, n0 = w.nt * NB + wn * BN;
    long long rb[2];
    bool rv[2];
    int off[2];  // the slab route: where each of this thread's rows starts in its slab row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * wq + g + 8 * h, mq = m / pl.m.r, mr = m - mq * pl.m.r;
      rv[h] = mq < pl.m.q && mr < pl.m.g;
      rb[h] = rv[h] ? w.t * a.st + mq * a.sq + mr * a.sr : 0;
      off[h] = (int)(((uintptr_t)(a.p + rb[h]) & 15) >> 2) + (wm * 64 + 16 * wq + g + 8 * h) * APITCH;
    }
#pragma unroll
    for (int h = 0; h < CHAINS; ++h)
#pragma unroll
      for (int i = 0; i < ACC; ++i) run[h][i] = 0.f;
    float raw[KC / 16][8];  // the register route: the next stage's values, in flight
    if constexpr (!SLAB) {
#pragma unroll
      for (int s = 0; s < KC / 16; ++s) load8(raw[s], a, rb, rv, w.ks0 * KC + 16 * s, pl.k, q);
    }

    for (int ks = w.ks0; ks < w.ks1; ++ks) {
      mbar_wait(&full[slot], phase);
      const uint32_t hi = ring + slot * SM::STAGE, lo = hi + SM::B_STAGE / 2;
      const float* slab = reinterpret_cast<const float*>(smem + slot * SM::STAGE + SM::B_STAGE);
#pragma unroll
      for (int s = 0; s < KC / 16; ++s) {
        const int k0 = ks * KC + 16 * s;
        uint32_t f[P][4];
        if constexpr (SLAB) {  // k 4 q + [0, 4) of the step (the pack's order); none past the last
          float v[8];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              v[4 * h + c] = rv[h] && k0 + 4 * q + c < pl.k.g ? slab[off[h] + 16 * s + 4 * q + c] : 0.f;
          cut<P>(v, f);
        } else {
          cut<P>(raw[s], f);
          if (ks + 1 < w.ks1) load8(raw[s], a, rb, rv, k0 + KC, pl.k, q);
        }
        if (k0 < kend) {  // past the last group only padding: skipped
          const uint64_t dh = tile_desc(hi + s * 256), dl = tile_desc(lo + s * 256);
          const int fresh = PER_STEP || s == 0 ? 0 : 1;  // 0: the chunk's sum starts from zero
          wg_fence();
          if constexpr (MODE == FWD) {  // al.bh, ah.bl, then ah.bh
            wgmma<BN>(step[0], f[1], dh, fresh);
            wgmma<BN>(step[0], f[0], dl, 1);
            wgmma<BN>(step[0], f[0], dh, 1);
          } else {  // H += g . bh, L += g . bl, the smallest part of g first
#pragma unroll
            for (int p = 2; p >= 0; --p) {
              wgmma<BN>(step[0], f[p], dh, p == 2 ? fresh : 1);
              wgmma<BN>(step[1], f[p], dl, p == 2 ? fresh : 1);
            }
          }
          wg_commit();
          if (PER_STEP) add_chunk<ACC, CHAINS>(run, step);
          if (!PER_STEP && !SLAB) wg_wait1();  // K5's register route: two steps' A fragments live, no more
        }
      }
      if (!PER_STEP && ks * KC < kend) add_chunk<ACC, CHAINS>(run, step);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);  // this warp is done with the stage
      if (++slot == SM::STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }

    if constexpr (MODE == GRAD) {  // H's and L's partials of slice s: [S][2][T][Mp][Np]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dst = part + (((long long)w.s * 2 + h) * pl.T + w.t) * Mp * Np;
#pragma unroll
        for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const long long r = m0 + 16 * wq + g + 8 * rh;
            *reinterpret_cast<float2*>(dst + r * Np + n0 + 8 * j + 2 * q) =
                make_float2(run[h][4 * j + 2 * rh], run[h][4 * j + 2 * rh + 1]);
          }
      }
    } else if (runs) {  // a warp's 16 rows are one group: its run [n][row] of BN x G in the buffer
      float* st = staging + wg * SM::WG_STAGING + buf * SM::RUN_BUF;
      const int G = pl.m.g, nv = min(BN, pl.N - n0);
      if (wt == 0) bulk_wait_read<1>();  // the stores from this buffer two items ago have read it
      named_sync(1 + wg);
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int r = g + 8 * rh, c = 8 * j + 2 * q;
          if (r < G) {
            st[(wq * BN + c) * G + r] = run[0][4 * j + 2 * rh];
            st[(wq * BN + c + 1) * G + r] = run[0][4 * j + 2 * rh + 1];
          }
        }
      fence_async_shared();
      named_sync(1 + wg);
      if (wt == 0 && nv > 0) {
        for (int grp = 0; grp < 4; ++grp) {
          const int mq = m0 / 16 + grp;
          if (mq < pl.m.q)
            bulk_store(out.p + w.t * out.st + (long long)mq * out.sq + (long long)n0 * G, st + grp * BN * G,
                       nv * G * 4);
        }
        bulk_commit();
      }
      buf ^= 1;
    } else {  // the tile through shared memory, then out row by row, coalesced
      float* st = staging + wg * SM::WG_STAGING;
      named_sync(1 + wg);  // the previous item's reads of st are done
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
          *reinterpret_cast<float2*>(st + (16 * wq + g + 8 * rh) * SM::PITCH + 8 * j + 2 * q) =
              make_float2(run[0][4 * j + 2 * rh], run[0][4 * j + 2 * rh + 1]);
      named_sync(1 + wg);
      const int nv = min(BN, pl.N - n0);
      for (int e = wt; e < 64 * BN; e += WG) {
        const int r = e / BN, c = e % BN;
        const int m = m0 + r, mq = m / pl.m.r, mr = m - mq * pl.m.r;
        if (c < nv && mq < pl.m.q && mr < pl.m.g)
          out.p[w.t * out.st + mq * out.sq + mr * out.sr + (long long)(n0 + c) * out.sn] = st[r * SM::PITCH + c];
      }
    }
  }
  if (MODE == FWD && wt == 0) bulk_wait_all();  // the bulk stores are done before the block's memory goes
}

// K5's reduce: for each output, H's and L's partials summed in ascending
// slice order, each rounded to bf16, combined: H + rp(bf16(H + L) - H).
__global__ void split_reduce_kernel(const float* __restrict__ part, Out out, Plan pl, long long Mp, long long Np) {
  const long long i = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  const long long Mi = (long long)pl.m.q * pl.m.r;
  if (i >= pl.T * Mi * pl.N) return;
  const int n = (int)(i % pl.N);
  const long long m = (i / pl.N) % Mi, t = i / (pl.N * Mi);
  const long long mq = m / pl.m.r, mr = m - mq * pl.m.r;
  if (mr >= pl.m.g) return;
  const long long plane = (long long)pl.T * Mp * Np, off = (t * Mp + m) * Np + n;
  float sh = 0.f, sl = 0.f;
  for (int s = 0; s < pl.S; ++s) {
    sh += part[(2LL * s) * plane + off];
    sl += part[(2LL * s + 1) * plane + off];
  }
  const float h = bf16r(sh), l = bf16r(sl);
  const float pair = bf16r(h + l);  // the two blocks that pair g with the hi half, added in bf16
  out.p[t * out.st + mq * out.sq + mr * out.sr + (long long)n * out.sn] = h + bf16r(pair - h);
}

// ---- the pack: B's element (t, k, n) at src[t st + (k / r) skq + (k % r) skr + n sn]
// into its bf16 hi and lo planes, laid out as split_wgmma_kernel reads them.

struct Pack {
  int T, N;
  Axis k;
  long long st, skq, skr, sn;
  int nb, n_tiles, k_stages, perm;
};

// The k a packed position holds. K5's layout (perm) orders each 16 k so that
// the thread with q = lane % 4 finds k 4 q + [0, 4) in its A fragment's
// slots 2 q, 2 q + 1, 2 q + 8, 2 q + 9 (K5 reads them as one 16-byte load).
__device__ __forceinline__ int k_of(int kp, int perm) {
  if (!perm) return kp;
  const int s = kp & 15;
  return (kp - s) + 4 * ((s & 7) >> 1) + (s & 1) + 2 * (s >> 3);
}

// One thread a column n and 8 consecutive packed k: the 16-byte row of one
// core matrix in each plane. Threads walk k first where the source's k is
// contiguous, else the columns.
__global__ void split_pack_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst, Pack pk) {
  const long long i = (long long)blockIdx.x * PACK_THREADS + threadIdx.x;
  const long long Np = (long long)pk.n_tiles * pk.nb, K8 = (long long)pk.k_stages * (KC / 8);
  if (i >= pk.T * Np * K8) return;
  long long n, k8, t;
  if (pk.skr == 1) {
    k8 = i % K8;
    n = (i / K8) % Np;
    t = i / (K8 * Np);
  } else {
    n = i % Np;
    k8 = (i / Np) % K8;
    t = i / (Np * K8);
  }
  __align__(16) __nv_bfloat16 hi[8], lo[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = k_of((int)(8 * k8 + e), pk.perm), kq = k / pk.k.r, kr = k - kq * pk.k.r;
    const float x = n < pk.N && kq < pk.k.q && kr < pk.k.g ? src[t * pk.st + kq * pk.skq + kr * pk.skr + n * pk.sn]
                                                           : 0.f;
    hi[e] = __float2bfloat16_rn(x);
    lo[e] = __float2bfloat16_rn(x - __bfloat162float(hi[e]));
  }
  const long long nt = n / pk.nb, nl = n % pk.nb, ks = 8 * k8 / KC, kl = 8 * k8 % KC;
  const long long off = ((t * pk.n_tiles + nt) * pk.k_stages + ks) * (2LL * pk.nb * KC) +
                        ((nl / 8) * (KC / 8) + kl / 8) * 64 + (nl % 8) * 8;
  *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(hi);
  *reinterpret_cast<uint4*>(dst + off + (long long)pk.nb * KC) = *reinterpret_cast<const uint4*>(lo);
}

// ---- host side

int div_up(long long a, long long b) { return (int)((a + b - 1) / b); }

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return std::max(n, 1);
}

bool axes_ok(int T, Axis m, int N, Axis k) {
  return T > 0 && N > 0 && m.q > 0 && m.r > 0 && m.g > 0 && m.g <= m.r && k.q > 0 && k.r > 0 && k.g > 0 &&
         k.g <= k.r && k.r % 16 == 0 && (long long)m.q * m.r < (1LL << 31) && (long long)k.q * k.r < (1LL << 31);
}

// One warpgroup row tile where the rows fit it, else two.
int wgm_for(Axis m) { return (long long)m.q * m.r <= 64 ? 1 : 2; }

// The launch's tiles; K5's split: the count of slices that fills the SMs in
// the fewest stage-times (each item costing its stages and about two more).
Plan plan_for(int mode, int T, Axis m, int N, Axis k, int b_batched) {
  const int nb = mode == FWD ? NB_FWD : NB_GRAD;
  Plan p;
  p.T = T;
  p.N = N;
  p.m = m;
  p.k = k;
  p.m_tiles = div_up((long long)m.q * m.r, 64 * wgm_for(m));
  p.n_tiles = div_up(N, nb);
  p.k_stages = div_up((long long)k.q * k.r, KC);
  p.b_t = b_batched ? (long long)p.n_tiles * p.k_stages * 2 * nb * KC : 0;
  p.S = 1;
  p.per = p.k_stages;
  if (mode == GRAD) {
    const long long tiles = (long long)T * p.m_tiles * p.n_tiles, sms = sm_count();
    long long best = -1;
    for (int s = 1; s <= std::min(p.k_stages, 256); ++s) {
      const int per = div_up(p.k_stages, s), used = div_up(p.k_stages, per);
      const long long cost = (tiles * used + sms - 1) / sms * (per + 2);
      if (best < 0 || cost < best) {
        best = cost;
        p.S = used;
        p.per = per;
      }
    }
  }
  return p;
}

size_t workspace_bytes(const Plan& p) {
  return (size_t)p.S * 2 * p.T * p.m_tiles * 64 * wgm_for(p.m) * p.n_tiles * NB_GRAD * sizeof(float);
}

template <int MODE, int BN, int WGN, bool SLAB>
cudaError_t launch_product(const Lhs& a, const void* b, const Out& o, float* part, const Plan& p, cudaStream_t st) {
  using SM = Smem<MODE, BN, WGN, SLAB>;
  static bool opted_in[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(split_wgmma_kernel<MODE, BN, WGN, SLAB>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SM::BYTES);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const long long items = (long long)p.T * p.S * p.m_tiles * p.n_tiles;
  if (items >= (1LL << 31)) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)std::min<long long>(items, sm_count());
  split_wgmma_kernel<MODE, BN, WGN, SLAB>
      <<<grid, THREADS, SM::BYTES, st>>>(a, (const __nv_bfloat16*)b, o, part, p);
  return cudaGetLastError();
}

}  // namespace

// The pack: B's element (t, k = (k / kr, k % kr), n) at src[t st + (k / kr) skq
// + (k % kr) skr + n sn] cut into its hi and lo planes in dst
// (T x ceil(N / NB) NB x ceil(kq kr / KC) KC x 2 bf16 elements), zero where k or n does not exist;
// layout 0 for K4's register route, 1 for K5's; + 2 for the slab route (k reordered).
extern "C" int psi_split_pack(const void* src, void* dst, int T, int N, int kq, int kr, int kg, long long st,
                              long long skq, long long skr, long long sn, int layout, void* stream) {
  const int grad = layout & 1;
  const Axis k{kq, kr, kg};
  if (!axes_ok(T, Axis{1, 1, 1}, N, k)) return cudaErrorInvalidValue;
  Pack pk{T, N, k, st, skq, skr, sn, grad ? NB_GRAD : NB_FWD, 0, 0, layout >> 1};
  pk.n_tiles = div_up(N, pk.nb);
  pk.k_stages = div_up((long long)kq * kr, KC);
  const long long n = (long long)T * pk.n_tiles * pk.nb * pk.k_stages * (KC / 8);
  split_pack_kernel<<<(unsigned)((n + PACK_THREADS - 1) / PACK_THREADS), PACK_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)src, (__nv_bfloat16*)dst, pk);
  return cudaGetLastError();
}

// K4: c[t] = a[t] @ b[t] with split-bf16 accuracy, f32 out. a's (t, m, k) at
// a[t sa_t + (m / mr) sa_q + (m % mr) sa_r + (k / kr) sa_kq + (k % kr) sa_kr];
// b: its packed planes (psi_split_pack, layout 0 + 3 slab), one for every t
// unless b_batched; c's (t, m, n) at c[t sc_t + (m / mr) sc_q + (m % mr) sc_r
// + n sc_n]. Rows m exist where m / mr < mq and m % mr < mg, k likewise;
// a_n elements may be read from a. slab = 1: a's rows are contiguous in k (one
// group, sa_kr = 1) and go through shared memory by bulk copies.
extern "C" int psi_split_mm(const void* a, const void* bp, void* c, int T, int mq, int mr, int mg, int N, int kq,
                            int kr, int kg, long long sa_t, long long sa_q, long long sa_r, long long sa_kq,
                            long long sa_kr, long long a_n, int b_batched, long long sc_t, long long sc_q,
                            long long sc_r, long long sc_n, int slab, void* stream) {
  const Axis m{mq, mr, mg}, k{kq, kr, kg};
  if (!axes_ok(T, m, N, k) || (slab && (kq != 1 || sa_kr != 1))) return cudaErrorInvalidValue;
  const Plan p = plan_for(FWD, T, m, N, k, b_batched);
  const Lhs la{(const float*)a, sa_t, sa_q, sa_r, sa_kq, sa_kr, a_n};
  const Out o{(float*)c, sc_t, sc_q, sc_r, sc_n};
  const cudaStream_t st = (cudaStream_t)stream;
  if (wgm_for(m) == 2)
    return slab ? launch_product<FWD, 128, 1, true>(la, bp, o, nullptr, p, st)
                : launch_product<FWD, 128, 1, false>(la, bp, o, nullptr, p, st);
  return slab ? launch_product<FWD, 64, 2, true>(la, bp, o, nullptr, p, st)
              : launch_product<FWD, 64, 2, false>(la, bp, o, nullptr, p, st);
}

// Workspace bytes psi_split_mm_grad needs for the product's axes.
extern "C" size_t psi_split_mm_grad_workspace(int T, int mq, int mr, int N, int kq, int kr) {
  const Axis m{mq, mr, mr}, k{kq, kr, kr};
  if (!axes_ok(T, m, N, k)) return 0;
  return workspace_bytes(plan_for(GRAD, T, m, N, k, 0));
}

// K5: out[t] = the split-bf16 gradient H + rp(bf16(H + L) - H), H = bf16(sum
// over k of a . b_hi), L likewise with b_lo: a is the f32 cotangent (cut into
// three bf16 parts), b the packed planes of the other operand (layout 1 + 2 slab).
// Axes and strides as psi_split_mm's. slab = 1: the cotangent's rows are
// contiguous in k (one group, sa_kr = 1) and go through shared memory by bulk
// copies. `stages` selects the launches (1 main, 2 reduce; 3 both): the reduce
// reads what the main launch left in the workspace, so a subset is only for
// timing one launch after a full run.
extern "C" int psi_split_mm_grad(const void* a, const void* bp, void* out, void* work, int T, int mq, int mr,
                                 int mg, int N, int kq, int kr, int kg, long long sa_t, long long sa_q,
                                 long long sa_r, long long sa_kq, long long sa_kr, long long a_n, int b_batched,
                                 long long so_t, long long so_q, long long so_r, long long so_n, int slab,
                                 int stages, void* stream) {
  const Axis m{mq, mr, mg}, k{kq, kr, kg};
  if (!axes_ok(T, m, N, k) || (slab && (kq != 1 || sa_kr != 1))) return cudaErrorInvalidValue;
  const Plan p = plan_for(GRAD, T, m, N, k, b_batched);
  const Lhs la{(const float*)a, sa_t, sa_q, sa_r, sa_kq, sa_kr, a_n};
  const Out o{(float*)out, so_t, so_q, so_r, so_n};
  const cudaStream_t st = (cudaStream_t)stream;
  float* part = (float*)work;
  cudaError_t err;
  if (stages & 1) {
    if (wgm_for(m) == 2)
      err = slab ? launch_product<GRAD, 64, 1, true>(la, bp, o, part, p, st)
                 : launch_product<GRAD, 64, 1, false>(la, bp, o, part, p, st);
    else
      err = slab ? launch_product<GRAD, 32, 2, true>(la, bp, o, part, p, st)
                 : launch_product<GRAD, 32, 2, false>(la, bp, o, part, p, st);
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    const long long n = (long long)T * mq * mr * N;
    const long long Mp = (long long)p.m_tiles * 64 * wgm_for(m), Np = (long long)p.n_tiles * NB_GRAD;
    split_reduce_kernel<<<(unsigned)((n + RED_THREADS - 1) / RED_THREADS), RED_THREADS, 0, st>>>(part, o, p, Mp,
                                                                                                  Np);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
