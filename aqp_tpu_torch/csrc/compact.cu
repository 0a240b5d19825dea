// Hopper kernels of the segment scatter: copy row segments of one or two
// (rows, 128) int32 arrays to destination offsets in an output buffer, and
// fill every row no segment covers.
//
//   scatter_segments      replaces _make_scatter_kernel
//                         (aqp_tpu/ops/pallas/compact.py:157), launched by
//                         scatter_segments (compact.py:280): key + payload.
//   scatter_segments_one  replaces _make_scatter_kernel_one (compact.py:299),
//                         launched by scatter_segments_one (compact.py:368):
//                         one array.
//
// Segment i copies rows [soff_i, soff_i + sz_i) of the source to rows
// [doff_i, doff_i + sz_i) of the output.  Segments may come in any order and
// must not overlap in the output (the callers' segments never do).  A
// segment with sz <= 0, or whose start lies outside [0, out_rows), copies
// nothing; rows past out_rows are cut, and source rows are clamped to
// [0, src_rows), as the gather formulation of the reference
// (compact.py:219-242) does.  Every other output row is written with the
// fill: fill_key in the key array, 0 in the payload array.  The kernel
// writes every output row exactly once, so the caller allocates the output
// uninitialised and nothing else touches it.
//
// Design.  The TPU issues one dynamic-size DMA per segment through a ring of
// semaphores onto an output pre-filled by XLA.  Here each CTA owns an equal
// chunk of output rows (16 to 1,024; about four waves of CTAs), so the
// work is balanced however the rows split into copies and gaps: the z =
// 1.5 residual's output, for one, is half a gap after its last segment.
// The CTA passes once over the segment list, each lane loading four
// segments' sizes and starts before it looks at any: the lanes whose
// segment meets the chunk are found by a ballot, and the whole warp writes
// each such segment's source rows into a shared-memory map of the chunk
// (-1: fill).  Then each warp copies or fills whole rows, a lane per
// 16-byte vector (one 512-byte row a warp), four rows loaded before any is
// stored.  The pass over the list costs each CTA nseg / 256 reads a
// thread, small at the few thousand segments the join and aggregate paths
// make.
//
// Bound: the bytes of the rows the segments cover, read once, the output
// written once, and the segment list read once.

#include <cuda_runtime.h>

#include <limits.h>

namespace {

constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_WARPS = SCATTER_THREADS / 32;
constexpr int SCATTER_CTAS_PER_SM = 4;
constexpr int VEC_PER_ROW = 128 / 4;  // int4 vectors in one row: a warp's
constexpr int ROWS_IN_FLIGHT = 4;     // rows a warp loads before it stores
constexpr int MAP_IN_FLIGHT = 4;      // segments a lane loads at once
constexpr int MIN_CHUNK = 16;         // output rows a CTA owns, at least
constexpr int MAX_CHUNK = 1024;       // and at most (the map's size)
constexpr unsigned FULL = 0xffffffffu;

template <bool PAY>
__global__ void __launch_bounds__(SCATTER_THREADS, SCATTER_CTAS_PER_SM)
scatter_kernel(const int4* __restrict__ ks, const int4* __restrict__ ps,
               const int* __restrict__ soff, const int* __restrict__ doff,
               const int* __restrict__ sz, int nseg, long long src_rows,
               long long out_rows, long long chunk, int fill_key,
               int4* __restrict__ ok, int4* __restrict__ op) {
  __shared__ int s_src[MAX_CHUNK];  // a chunk row's source row; -1: fill
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.x * chunk;
  const long long r1 = r0 + chunk < out_rows ? r0 + chunk : out_rows;
  const int rows = (int)(r1 - r0);
  for (int r = threadIdx.x; r < rows; r += SCATTER_THREADS) s_src[r] = -1;
  __syncthreads();
  // the map: lane l of warp w looks at segments w * 32 + l + q * 256, four
  // (q) loaded before any is looked at
  constexpr int MAP_STEP = SCATTER_THREADS * MAP_IN_FLIGHT;
  for (int base = warp * 32; base < nseg; base += MAP_STEP) {
    int n[MAP_IN_FLIGHT];
    int d[MAP_IN_FLIGHT];
#pragma unroll
    for (int q = 0; q < MAP_IN_FLIGHT; ++q) {
      const int i = base + q * SCATTER_THREADS + lane;
      n[q] = i < nseg ? sz[i] : 0;
      d[q] = i < nseg ? doff[i] : 0;
    }
#pragma unroll
    for (int q = 0; q < MAP_IN_FLIGHT; ++q) {
      long long lo = 0;
      long long hi = 0;
      long long s = 0;
      if (n[q] > 0 && d[q] >= 0 && d[q] < out_rows) {
        lo = d[q] > r0 ? d[q] : r0;
        hi = (long long)d[q] + n[q] < r1 ? (long long)d[q] + n[q] : r1;
        if (lo < hi)
          s = soff[base + q * SCATTER_THREADS + lane] + (lo - d[q]);
      }
      // the whole warp writes each met segment's rows, 32 a step
      for (unsigned m = __ballot_sync(FULL, lo < hi); m; m &= m - 1u) {
        const int l = __ffs(m) - 1;
        const long long a = __shfl_sync(FULL, lo, l);
        const long long b = __shfl_sync(FULL, hi, l);
        const long long s0 = __shfl_sync(FULL, s, l);
        for (long long r = a + lane; r < b; r += 32) {
          long long x = s0 + (r - a);
          x = x < 0 ? 0 : (x >= src_rows ? src_rows - 1 : x);
          s_src[r - r0] = (int)x;
        }
      }
    }
  }
  __syncthreads();
  // copy or fill: warp w takes chunk rows w, w + 8, ..., a lane a vector
  const int4 fk = make_int4(fill_key, fill_key, fill_key, fill_key);
  const int4 fz = make_int4(0, 0, 0, 0);
  for (int r = warp; r < rows; r += SCATTER_WARPS * ROWS_IN_FLIGHT) {
    int4 kv[ROWS_IN_FLIGHT];
    int4 pv[ROWS_IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
      const int rr = r + u * SCATTER_WARPS;
      const int src = rr < rows ? s_src[rr] : -1;
      const long long si = (long long)src * VEC_PER_ROW + lane;
      kv[u] = src >= 0 ? ks[si] : fk;
      if (PAY) pv[u] = src >= 0 ? ps[si] : fz;
    }
#pragma unroll
    for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
      const int rr = r + u * SCATTER_WARPS;
      if (rr < rows) {
        const long long di = (r0 + rr) * VEC_PER_ROW + lane;
        ok[di] = kv[u];
        if (PAY) op[di] = pv[u];
      }
    }
  }
}

// SMs of the current device, asked once a process.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    int v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    sms = v > 0 ? v : 132;
  }
  return sms;
}

}  // namespace

extern "C" {

// ks (and ps, or null): src_rows x 128 int32; soff/doff/sz: nseg int32 on
// the device; ok (and op): out_rows x 128 int32, written whole (no
// pre-fill).  All row pointers 16-byte aligned.
int scatter_segments(const int* ks, const int* ps, const int* soff,
                     const int* doff, const int* sz, int nseg,
                     long long src_rows, long long out_rows, int fill_key,
                     int* ok, int* op, void* stream) {
  if (out_rows <= 0) return 0;
  if (nseg < 0 || src_rows > INT_MAX || (nseg > 0 && src_rows <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // about four waves of CTAs, each owning an equal chunk of rows
  const long long ctas = 4LL * sm_count() * SCATTER_CTAS_PER_SM;
  long long chunk = (out_rows + ctas - 1) / ctas;
  chunk = chunk < MIN_CHUNK ? MIN_CHUNK : (chunk > MAX_CHUNK ? MAX_CHUNK
                                                             : chunk);
  const long long grid = (out_rows + chunk - 1) / chunk;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  if (ps)
    scatter_kernel<true><<<(unsigned)grid, SCATTER_THREADS, 0, st>>>(
        reinterpret_cast<const int4*>(ks), reinterpret_cast<const int4*>(ps),
        soff, doff, sz, nseg, src_rows, out_rows, chunk, fill_key,
        reinterpret_cast<int4*>(ok), reinterpret_cast<int4*>(op));
  else
    scatter_kernel<false><<<(unsigned)grid, SCATTER_THREADS, 0, st>>>(
        reinterpret_cast<const int4*>(ks), nullptr, soff, doff, sz, nseg,
        src_rows, out_rows, chunk, fill_key, reinterpret_cast<int4*>(ok),
        nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
