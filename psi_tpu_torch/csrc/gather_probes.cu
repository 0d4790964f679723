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
//   stages a strip of `strip` columns of every table row (8 x 2304 rows =
//   74 KB, dynamic shared memory above the 48 KB default) and fills the
//   rows of its 128-row chunk in that strip. Eight columns rather than 16
//   let three blocks share an SM, so more staging loads are in flight: the
//   staging, not the gather, is what a block waits on. The strip narrows
//   (4, 2, 1) when a table has more rows than 8 columns of them fit.
// - P2/P3: row i of the output needs only row i of the table, so a block
//   stages LANE_ROWS rows (8 KB at L = 128) and gathers within each row. P3's
//   grid is (row block, body): one body's [512, 128] table (256 KB) is over
//   a block's limit. P3 sums from 0 in k order with _rn adds, as the Pallas
//   kernel and the plain twin do, so kernel and twin agree bit for bit.
// - P4: the Pallas kernel relayouts lanes to sublanes; here one warp per
//   output row computes the row's value in registers, in the same k order,
//   and writes its L floats as float4 stores.
// P1/P2: an index outside the table gives NaN instead of a read outside it;
// P3 takes its indices mod L, as the probe does.
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW_STRIP = 8;    // P1: table columns staged per block (fewer when the rows do not fit)
constexpr int ROW_CHUNK = 128;  // P1: output rows per block
constexpr int LANE_ROWS = 16;   // P2/P3: table rows staged per block
constexpr int MAX_SMEM = 232448;  // 227 KB: the most dynamic shared memory a block may have

__global__ void row_gather_kernel(const float* __restrict__ t,    // [rows, L]
                                  const int32_t* __restrict__ r,  // [rows, L]
                                  float* __restrict__ out,        // [rows, L]
                                  int rows, int L, int strip) {
  extern __shared__ float s[];  // [rows][strip]: columns c0 .. c0 + w of the table
  const int c0 = blockIdx.x * strip;
  const int w = min(strip, L - c0);
  // strip is a power of two <= ROW_STRIP, so each thread keeps one column jj and
  // steps over rows: no division in the loops, and the loads can overlap
  // (threads whose column lies past a ragged last strip idle, but still
  // reach the barrier)
  const int jj = threadIdx.x % strip, step = THREADS / strip;
  const bool active = jj < w;
  if (active) {
    #pragma unroll 4
    for (int i = threadIdx.x / strip; i < rows; i += step) s[i * strip + jj] = t[(size_t)i * L + c0 + jj];
  }
  __syncthreads();
  if (!active) return;
  const int i1 = min(rows, (int)(blockIdx.y + 1) * ROW_CHUNK);
  #pragma unroll 4
  for (int i = blockIdx.y * ROW_CHUNK + threadIdx.x / strip; i < i1; i += step) {
    const size_t o = (size_t)i * L + c0 + jj;
    const int src = r[o];
    out[o] = ((unsigned)src < (unsigned)rows) ? s[src * strip + jj] : NAN;
  }
}

// kChained = false: P2, out = t[i, l]. kChained = true: P3, out = sum over
// k < n_gathers of t[i, (l + k) % L], accumulated from 0 in k order.
template <bool kChained>
__global__ void lane_gather_kernel(const float* __restrict__ t,    // [G, rows, L]
                                   const int32_t* __restrict__ l,  // [G, rows, L]
                                   float* __restrict__ out,        // [G, rows, L]
                                   int rows, int L, int n_gathers) {
  extern __shared__ float s[];  // [LANE_ROWS][L]
  const int r0 = blockIdx.x * LANE_ROWS;
  const size_t base = ((size_t)blockIdx.y * rows + r0) * L;
  const int n = min(LANE_ROWS, rows - r0) * L;
  for (int e = threadIdx.x; e < n; e += blockDim.x) s[e] = t[base + e];
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float* srow = s + (e / L) * L;
    const int src = l[base + e];
    float v;
    if (kChained) {
      // (src + k) mod L, floored as jnp's and torch's %, stepped by one
      // with a wrap instead of dividing for every k
      int c = src % L;
      if (c < 0) c += L;
      v = 0.f;
      for (int k = 0; k < n_gathers; ++k) {
        v = __fadd_rn(v, srow[c]);
        c = (c + 1 == L) ? 0 : c + 1;
      }
    } else {
      v = ((unsigned)src < (unsigned)L) ? srow[src] : NAN;
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

// A block may use more than 48 KB of dynamic shared memory only after this
// opt-in; below that the host call is skipped (it costs a launch's worth of
// host time at the probes' smallest shapes).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool kChained>
int launch_lane(const void* t, const void* l, void* out, int G, int rows, int L, int n_gathers,
                void* stream) {
  if (G <= 0 || rows <= 0 || L <= 0 || G > 65535) return cudaErrorInvalidValue;
  const size_t smem = (size_t)LANE_ROWS * L * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(lane_gather_kernel<kChained>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + LANE_ROWS - 1) / LANE_ROWS, G);
  lane_gather_kernel<kChained><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)t, (const int32_t*)l, (float*)out, rows, L, n_gathers);
  return cudaGetLastError();
}

}  // namespace

extern "C" int psi_probe_row_gather(const void* t, const void* r, void* out, int rows, int L,
                                    void* stream) {
  if (rows <= 0 || L <= 0) return cudaErrorInvalidValue;
  int strip = ROW_STRIP;
  while (strip > 1 && (size_t)rows * strip * sizeof(float) > MAX_SMEM) strip /= 2;
  const size_t smem = (size_t)rows * strip * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(row_gather_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + strip - 1) / strip, (rows + ROW_CHUNK - 1) / ROW_CHUNK);
  row_gather_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)t, (const int32_t*)r, (float*)out, rows, L, strip);
  return cudaGetLastError();
}

extern "C" int psi_probe_lane_gather(const void* t, const void* l, void* out, int rows, int L,
                                     void* stream) {
  return launch_lane<false>(t, l, out, 1, rows, L, 1, stream);
}

extern "C" int psi_probe_chained_gather(const void* t, const void* l, void* out, int G, int rows,
                                        int L, int n_gathers, void* stream) {
  if (n_gathers < 0) return cudaErrorInvalidValue;
  return launch_lane<true>(t, l, out, G, rows, L, n_gathers, stream);
}

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
