// Shared-memory gather probes on Hopper: P1-P4.
//
// Replace the four Pallas probes of scripts/profile_vmem_gather.py, which
// measure gathers from a table resident in the TPU's VMEM as a candidate for
// the trilinear SDF corner fetch:
//   P1 _row_gather_kernel   (:49)  out[i,j] = t[r[i,j], j]          (axis 0)
//   P2 _lane_gather_kernel  (:53)  out[i,j] = t[i, l[i,j]]          (axis 1)
//   P3 _chained_kernel      (:82)  out[n,i,j] = sum_k t[n, i, (l[n,i,j]+k) % L]
//   P4 measure_relayout.kern (:130) out[n,r,:] = sum_k (c[n].flat[r] + k)
// The card's counterpart of a VMEM-resident table is shared memory, so each
// gather kernel stages its table there and gathers from it; what is measured
// is the rate of that gather against the global-memory packed-row gather.
//
// What bounds them on this card: P1-P3 move their index and output arrays
// through device memory once (8 bytes per gathered element for P1/P2, 12
// bytes for the whole of P3's 8 gathers) and gather from shared memory at
// its bank rate; P4 reads nothing of size and writes G*R*L floats (288 MiB
// at the probe's shape), so it is bound by device-memory writes.
//
// Design:
// - P1: column j of the output needs only column j of the table, so a block
//   stages a strip of `strip` columns of every table row (16 x 2304 rows =
//   147 KB, dynamic shared memory above the 48 KB default, one block an SM)
//   and fills the rows of its ROW_CHUNK-row chunk in that strip. What a
//   launch costs is the strips' way from L2 to the SMs: every row chunk
//   stages its whole strip, so 256-row chunks (9 at 2304 rows) move half the
//   bytes of 128-row ones, and wider strips need fewer blocks for the same
//   bytes in flight. A strip row of 16 floats is four 16-byte cp.async
//   copies; every thread starts all of its copies at once, then loads its
//   indices as int4 while they land, waits, gathers four values a unit and
//   writes them as one float4. The strip narrows (8, 4, 2, 1) when a table
//   has more rows than 16 columns of them fit.
// - P2: row i of the output needs only row i of the table, so a block stages
//   LANE_ROWS rows, one contiguous 16-byte-aligned span of the table (8 KB at
//   L = 128), by 16-byte cp.async, loads its first indices as int4 while
//   the span lands, and gathers within each row: a warp owns a row, a lane 4
//   columns, so no index is divided.
// - P1 and P2 take the 16-byte route when L is a multiple of 4 and the three
//   base pointers are 16-byte aligned (and P1's strip is at least 4 wide);
//   any other operand takes the same design with 4-byte copies, loads and
//   stores. Both routes give the same values: a gather copies.
// - P3: as P2's rows, CHAIN_ROWS of them staged with plain loads. Its
//   grid is (row block, body): one body's [512, 128] table (256 KB) is over
//   a block's limit. P3 sums from 0 in k order with _rn adds, as the Pallas
//   kernel and the plain twin do, so kernel and twin agree bit for bit.
// - P4: the Pallas kernel relayouts lanes to sublanes; here one warp per
//   output row computes the row's value in registers, in the same k order,
//   and writes its L floats as float4 stores.
// P1/P2: an index outside the table gives NaN instead of a read outside it;
// P3 takes its indices mod L, as the probe does.
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError(). A kernel that needs more than 48 KB of shared
// memory is opted in once per device, at its first such launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_STRIP = 16;   // P1: table columns staged per block (fewer when the rows do not fit)
constexpr int ROW_CHUNK = 256;  // P1: output rows per block
constexpr int LANE_ROWS = 16;   // P2: table rows staged per block
constexpr int CHAIN_ROWS = 16;  // P3: table rows staged per block
constexpr int MAX_SMEM = 232448;  // 227 KB: the most dynamic shared memory a block may have
constexpr int MAX_DEVICES = 64;   // devices whose shared-memory opt-in is remembered

// P1: the most 4-column units (16-byte route) and single columns (4-byte
// route) of its chunk that one thread fills
constexpr int ROW_UNITS = ROW_CHUNK * (ROW_STRIP / 4) / THREADS;
constexpr int ROW_SCALARS = ROW_CHUNK * ROW_STRIP / THREADS;
static_assert(ROW_STRIP % 4 == 0 && ROW_UNITS >= 1 && ROW_UNITS * THREADS == ROW_CHUNK * (ROW_STRIP / 4),
              "a P1 chunk is a whole number of 4-column units per thread");
static_assert(LANE_ROWS % WARPS == 0, "a P2 warp owns whole rows");
constexpr int LANE_ROWS_PER_WARP = LANE_ROWS / WARPS;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
// every copy this thread started has landed; a barrier then makes all threads' copies visible
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// s[src * pitch] if src is a row (or lane) of the table, else NaN
__device__ __forceinline__ float pick(const float* s, int src, int n, int pitch) {
  return ((unsigned)src < (unsigned)n) ? s[src * pitch] : NAN;
}

// kVec: L and strip are multiples of 4 and t, r, out are 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(THREADS) row_gather_kernel(const float* __restrict__ t,    // [rows, L]
                                                             const int32_t* __restrict__ r,  // [rows, L]
                                                             float* __restrict__ out,        // [rows, L]
                                                             int rows, int L, int strip) {
  extern __shared__ __align__(16) float smem[];  // [rows][strip]: columns c0 .. c0 + w of the table
  constexpr int E = kVec ? 4 : 1;                // columns a thread moves at once
  constexpr int N = kVec ? ROW_UNITS : ROW_SCALARS;
  const int c0 = blockIdx.x * strip;
  const int w = min(strip, L - c0);
  // strip / E is a power of two, so each thread keeps one column group jj and
  // steps over rows: no division in the loops (threads whose group lies past
  // a ragged last strip idle, but still reach the barrier)
  const int groups = strip / E;
  const int jj = E * (threadIdx.x % groups), step = THREADS / groups;
  const bool active = jj < w;
  const int first = threadIdx.x / groups;
  if (active) {
    const float* src = t + c0 + jj;
    #pragma unroll 4
    for (int i = first; i < rows; i += step) {
      if (kVec) cp_async16(smem + i * strip + jj, src + (size_t)i * L);
      else cp_async4(smem + i * strip + jj, src + (size_t)i * L);
    }
  }
  // this thread's indices, loaded while the strip lands
  const int i0 = blockIdx.y * ROW_CHUNK + first;
  const int i1 = min(rows, (int)(blockIdx.y + 1) * ROW_CHUNK);
  int4 idx[N];
  #pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = i0 + k * step;
    idx[k] = make_int4(-1, -1, -1, -1);
    if (active && i < i1) {
      const int32_t* p = r + (size_t)i * L + c0 + jj;
      if (kVec) idx[k] = __ldg(reinterpret_cast<const int4*>(p));
      else idx[k].x = __ldg(p);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (!active) return;
  const float* s = smem + jj;
  #pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = i0 + k * step;
    if (i >= i1) break;
    float* o = out + (size_t)i * L + c0 + jj;
    if (kVec) {
      *reinterpret_cast<float4*>(o) = make_float4(pick(s, idx[k].x, rows, strip), pick(s + 1, idx[k].y, rows, strip),
                                                  pick(s + 2, idx[k].z, rows, strip), pick(s + 3, idx[k].w, rows, strip));
    } else {
      *o = pick(s, idx[k].x, rows, strip);
    }
  }
}

// kVec: L is a multiple of 4 and t, l, out are 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(THREADS) lane_gather_kernel(const float* __restrict__ t,    // [rows, L]
                                                              const int32_t* __restrict__ l,  // [rows, L]
                                                              float* __restrict__ out,        // [rows, L]
                                                              int rows, int L) {
  extern __shared__ __align__(16) float smem[];  // [LANE_ROWS][L]
  constexpr int E = kVec ? 4 : 1;                // columns a lane moves at once
  const int r0 = blockIdx.x * LANE_ROWS;
  const int nr = min(LANE_ROWS, rows - r0);
  const size_t base = (size_t)r0 * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the block's rows are one contiguous span of the table
  const int n = nr * L;
  for (int e = E * threadIdx.x; e < n; e += E * THREADS) {
    if (kVec) cp_async16(smem + e, t + base + e);
    else cp_async4(smem + e, t + base + e);
  }
  // a warp owns rows warp, warp + WARPS, ...; a lane the columns E * lane,
  // E * (lane + 32), ... of each. The first indices of every row are loaded
  // while the span lands.
  int4 head[LANE_ROWS_PER_WARP];
  #pragma unroll
  for (int k = 0; k < LANE_ROWS_PER_WARP; ++k) {
    const int row = warp + k * WARPS;
    head[k] = make_int4(-1, -1, -1, -1);
    if (row < nr && E * lane < L) {
      const int32_t* p = l + base + (size_t)row * L + E * lane;
      if (kVec) head[k] = __ldg(reinterpret_cast<const int4*>(p));
      else head[k].x = __ldg(p);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  #pragma unroll
  for (int k = 0; k < LANE_ROWS_PER_WARP; ++k) {
    const int row = warp + k * WARPS;
    if (row >= nr) break;
    const float* s = smem + row * L;
    const int32_t* lrow = l + base + (size_t)row * L;
    float* orow = out + base + (size_t)row * L;
    for (int j = E * lane; j < L; j += E * 32) {
      if (kVec) {
        const int4 ix = (j == E * lane) ? head[k] : __ldg(reinterpret_cast<const int4*>(lrow + j));
        *reinterpret_cast<float4*>(orow + j) =
            make_float4(pick(s, ix.x, L, 1), pick(s, ix.y, L, 1), pick(s, ix.z, L, 1), pick(s, ix.w, L, 1));
      } else {
        const int src = (j == lane) ? head[k].x : __ldg(lrow + j);
        orow[j] = pick(s, src, L, 1);
      }
    }
  }
}

// P3: out = sum over k < n_gathers of t[i, (l + k) % L], accumulated from 0
// in k order.
__global__ void chained_gather_kernel(const float* __restrict__ t,    // [G, rows, L]
                                      const int32_t* __restrict__ l,  // [G, rows, L]
                                      float* __restrict__ out,        // [G, rows, L]
                                      int rows, int L, int n_gathers) {
  extern __shared__ __align__(16) float smem[];  // [CHAIN_ROWS][L]
  const int r0 = blockIdx.x * CHAIN_ROWS;
  const size_t base = ((size_t)blockIdx.y * rows + r0) * L;
  const int n = min(CHAIN_ROWS, rows - r0) * L;
  for (int e = threadIdx.x; e < n; e += blockDim.x) smem[e] = t[base + e];
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float* srow = smem + (e / L) * L;
    const int src = l[base + e];
    // (src + k) mod L, floored as jnp's and torch's %, stepped by one
    // with a wrap instead of dividing for every k
    int c = src % L;
    if (c < 0) c += L;
    float v = 0.f;
    for (int k = 0; k < n_gathers; ++k) {
      v = __fadd_rn(v, srow[c]);
      c = (c + 1 == L) ? 0 : c + 1;
    }
    out[base + e] = v;
  }
}

__global__ void relayout_kernel(const float* __restrict__ c,  // [G * R]: c[n].flat[r] at n * R + r
                                float* __restrict__ out,      // [G * R, L]
                                long long n_rows, int L, int n_arrays) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const float x = c[row];
  float acc = 0.f;
  for (int k = 0; k < n_arrays; ++k) acc = __fadd_rn(acc, __fadd_rn(x, (float)k));
  const float4 v = make_float4(acc, acc, acc, acc);
  float4* o = reinterpret_cast<float4*>(out + row * L);
  for (int q = threadIdx.x % 32; q < L / 4; q += 32) o[q] = v;
}

// A block may use more than 48 KB of dynamic shared memory only after an
// opt-in, which costs a launch's worth of host time: it is made once per
// kernel and device, for the most a block may have, and `opted` (the
// caller's, one flag per device) remembers it. g_smem_opt_ins counts the
// calls that were made.
int g_smem_opt_ins = 0;

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t smem, bool* opted) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (opted[dev]) return cudaSuccess;
  ++g_smem_opt_ins;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  opted[dev] = err == cudaSuccess;
  return err;
}

bool aligned16(const void* a, const void* b, const void* c) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15) == 0;
}

template <bool kVec>
int launch_row(const void* t, const void* r, void* out, int rows, int L, int strip, void* stream) {
  static bool opted[MAX_DEVICES] = {};
  const size_t smem = (size_t)rows * strip * sizeof(float);
  cudaError_t err = opt_in_smem(row_gather_kernel<kVec>, smem, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + strip - 1) / strip, (rows + ROW_CHUNK - 1) / ROW_CHUNK);
  row_gather_kernel<kVec><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)t, (const int32_t*)r, (float*)out, rows, L, strip);
  return cudaGetLastError();
}

template <bool kVec>
int launch_lane(const void* t, const void* l, void* out, int rows, int L, void* stream) {
  static bool opted[MAX_DEVICES] = {};
  const size_t smem = (size_t)LANE_ROWS * L * sizeof(float);
  cudaError_t err = opt_in_smem(lane_gather_kernel<kVec>, smem, opted);
  if (err != cudaSuccess) return err;
  lane_gather_kernel<kVec><<<(rows + LANE_ROWS - 1) / LANE_ROWS, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)t, (const int32_t*)l, (float*)out, rows, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" int psi_probe_row_gather(const void* t, const void* r, void* out, int rows, int L,
                                    void* stream) {
  if (rows <= 0 || L <= 0) return cudaErrorInvalidValue;
  int strip = ROW_STRIP;
  while (strip > 1 && (size_t)rows * strip * sizeof(float) > MAX_SMEM) strip /= 2;
  if ((size_t)rows * strip * sizeof(float) > MAX_SMEM) return cudaErrorInvalidValue;
  if (strip % 4 == 0 && L % 4 == 0 && aligned16(t, r, out)) return launch_row<true>(t, r, out, rows, L, strip, stream);
  return launch_row<false>(t, r, out, rows, L, strip, stream);
}

extern "C" int psi_probe_lane_gather(const void* t, const void* l, void* out, int rows, int L,
                                     void* stream) {
  if (rows <= 0 || L <= 0) return cudaErrorInvalidValue;
  if ((size_t)LANE_ROWS * L * sizeof(float) > MAX_SMEM) return cudaErrorInvalidValue;
  if (L % 4 == 0 && aligned16(t, l, out)) return launch_lane<true>(t, l, out, rows, L, stream);
  return launch_lane<false>(t, l, out, rows, L, stream);
}

extern "C" int psi_probe_chained_gather(const void* t, const void* l, void* out, int G, int rows,
                                        int L, int n_gathers, void* stream) {
  static bool opted[MAX_DEVICES] = {};
  if (G <= 0 || rows <= 0 || L <= 0 || G > 65535 || n_gathers < 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)CHAIN_ROWS * L * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(chained_gather_kernel, smem, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + CHAIN_ROWS - 1) / CHAIN_ROWS, G);
  chained_gather_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)t, (const int32_t*)l, (float*)out, rows, L, n_gathers);
  return cudaGetLastError();
}

// The number of shared-memory opt-ins made so far by this library's probes:
// at most one per kernel and device, however many launches follow.
extern "C" int psi_probe_smem_opt_ins() { return g_smem_opt_ins; }

extern "C" int psi_probe_relayout(const void* c, void* out, int G, int R, int L, int n_arrays,
                                  void* stream) {
  if (G <= 0 || R <= 0 || L <= 0 || L % 4 != 0 || n_arrays < 0) return cudaErrorInvalidValue;
  const long long n_rows = (long long)G * R;
  const long long blocks = (n_rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  relayout_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)c, (float*)out, n_rows, L, n_arrays);
  return cudaGetLastError();
}
