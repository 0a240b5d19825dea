// Hopper kernels of the predicate scans over an 8-bit column.
//
//   scan_count      replaces _count_kernel (aqp_tpu/ops/pallas/scan.py:30),
//                   launched by _run_partials (scan.py:71): the number of
//                   rows with lo <= x <= hi.
//   scan_sum        replaces _sum_kernel (scan.py:41), launched by
//                   _run_partials: the sum of the qualifying values.
//   scan_bitvector  replaces _bitvector_kernel (scan.py:47), launched by
//                   scan_bitvector_pallas (scan.py:197): one bit per row,
//                   bit i of byte j = row 8j+i.
//
// Design.  The TPU kernels widen each (sub, 128) block of bytes to int32 in
// VMEM, reduce it to one int32 partial per grid step (summed outside), and
// pack the bitvector with a constant (128, 16) matmul on the MXU.  Here
// every thread reads 16 bytes at a time (one uint4, neighbouring threads on
// neighbouring addresses) and compares the four bytes of each 32-bit word at
// once with the SIMD video intrinsics: __vcmpgeu4 / __vcmpleu4 give 0xff for
// each byte in [lo, hi].  The count is the population of those masks / 8;
// the sum is __vsadu4 of the masked word against 0 (the sum of its bytes).
// Each thread accumulates in 64 bits, a warp shuffle and a shared-memory
// step reduce a CTA, and one 64-bit atomicAdd per CTA adds it to the
// result: exact for any n (the reference's partials are int32 per block,
// its sum int32 without x64).  Grid-stride loops and 64-bit indices serve
// columns past 2^31 rows (16 GiB is 2^34).  The bitvector: 32 rows per
// thread (two uint4) give one 32-bit word whose little-endian bytes are
// exactly the reference's layout, stored as one coalesced 4-byte store.
// Bytes before the first 16-byte boundary of the column and after the last
// whole vector are handled one at a time, so any pointer and any n work.
//
// Bound: count and sum read n bytes, n / 3.35 TB/s; the bitvector reads n
// bytes and writes n/8.  The kernels are a single streaming pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_MAX_CTAS = 132 * 16;

__device__ __forceinline__ unsigned in_range4(unsigned w, unsigned lo4,
                                              unsigned hi4) {
  return __vcmpgeu4(w, lo4) & __vcmpleu4(w, hi4);
}

// bit k of the result = byte k of m is 0xff (k < 4)
__device__ __forceinline__ unsigned nibble(unsigned m) {
  return (((m & 0x01010101u) * 0x01020408u) >> 24) & 0xFu;
}

template <bool SUM>
__device__ __forceinline__ unsigned long long reduce_word(unsigned w,
                                                          unsigned lo4,
                                                          unsigned hi4) {
  const unsigned m = in_range4(w, lo4, hi4);
  if (SUM) return __vsadu4(w & m, 0u);
  return __popc(m) >> 3;
}

template <bool SUM>
__global__ void __launch_bounds__(SCAN_THREADS) range_reduce_kernel(
    const unsigned char* __restrict__ col, long long n, int lo, int hi,
    unsigned long long* __restrict__ out) {
  __shared__ unsigned long long s_warp[SCAN_THREADS / 32];
  const unsigned lo4 = 0x01010101u * (unsigned)lo;
  const unsigned hi4 = 0x01010101u * (unsigned)hi;
  long long head = (long long)((16 - ((uintptr_t)col & 15)) & 15);
  if (head > n) head = n;
  const long long nvec = (n - head) >> 4;
  const long long tail = head + (nvec << 4);
  const uint4* v = reinterpret_cast<const uint4*>(col + head);
  unsigned long long acc = 0;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += step) {
    const uint4 x = __ldg(v + i);
    acc += reduce_word<SUM>(x.x, lo4, hi4) + reduce_word<SUM>(x.y, lo4, hi4) +
           reduce_word<SUM>(x.z, lo4, hi4) + reduce_word<SUM>(x.w, lo4, hi4);
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {  // at most 15 + 15 odd bytes
    const long long e = threadIdx.x < 16 ? threadIdx.x
                                         : tail + (threadIdx.x - 16);
    if ((threadIdx.x < 16 && e < head) || (threadIdx.x >= 16 && e < n)) {
      const int x = col[e];
      if (x >= lo && x <= hi) acc += SUM ? (unsigned long long)x : 1ull;
    }
  }
  for (int d = 16; d; d >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, d);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < SCAN_THREADS / 32; ++w) total += s_warp[w];
    if (total) atomicAdd(out, total);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(SCAN_THREADS) bitvector_kernel(
    const unsigned char* __restrict__ col, long long n, int lo, int hi,
    unsigned char* __restrict__ out) {
  const unsigned lo4 = 0x01010101u * (unsigned)lo;
  const unsigned hi4 = 0x01010101u * (unsigned)hi;
  const long long nwords = (n + 31) >> 5;
  const long long nbytes = (n + 7) >> 3;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < nwords; t += step) {
    const long long r0 = t << 5;
    unsigned word = 0;
    if (VEC && r0 + 32 <= n) {
      const uint4* v = reinterpret_cast<const uint4*>(col + r0);
      const uint4 a = __ldg(v);
      const uint4 b = __ldg(v + 1);
      word = nibble(in_range4(a.x, lo4, hi4)) |
             nibble(in_range4(a.y, lo4, hi4)) << 4 |
             nibble(in_range4(a.z, lo4, hi4)) << 8 |
             nibble(in_range4(a.w, lo4, hi4)) << 12 |
             nibble(in_range4(b.x, lo4, hi4)) << 16 |
             nibble(in_range4(b.y, lo4, hi4)) << 20 |
             nibble(in_range4(b.z, lo4, hi4)) << 24 |
             nibble(in_range4(b.w, lo4, hi4)) << 28;
    } else {
      for (int k = 0; k < 32 && r0 + k < n; ++k) {
        const int x = col[r0 + k];
        word |= (unsigned)(x >= lo && x <= hi) << k;
      }
    }
    const long long b0 = t << 2;
    if (b0 + 4 <= nbytes) {
      reinterpret_cast<unsigned*>(out)[t] = word;
    } else {
      for (int k = 0; b0 + k < nbytes; ++k)
        out[b0 + k] = (unsigned char)(word >> (8 * k));
    }
  }
}

int grid_for(long long items) {
  long long g = (items + SCAN_THREADS - 1) / SCAN_THREADS;
  if (g < 1) g = 1;
  if (g > SCAN_MAX_CTAS) g = SCAN_MAX_CTAS;
  return (int)g;
}

}  // namespace

extern "C" {

// col[n] uint8, lo/hi already clamped to [0, 255] with lo <= hi by the
// caller -> *out += count (sum == 0) or sum of qualifying values (sum ==
// 1).  The caller zeroes *out.
int scan_reduce(const unsigned char* col, long long n, int lo, int hi,
                int sum, unsigned long long* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  const int grid = grid_for(n >> 4);
  if (sum)
    range_reduce_kernel<true><<<grid, SCAN_THREADS, 0, st>>>(col, n, lo, hi,
                                                             out);
  else
    range_reduce_kernel<false><<<grid, SCAN_THREADS, 0, st>>>(col, n, lo,
                                                              hi, out);
  return (int)cudaGetLastError();
}

// col[n] uint8, lo/hi as for scan_reduce -> out[ceil(n / 8)]: bit i of
// byte j = row 8j+i qualifies; bits past n are 0.  out 4-byte aligned.
int scan_bitvector(const unsigned char* col, long long n, int lo, int hi,
                   unsigned char* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  const int grid = grid_for((n + 31) >> 5);
  if (((uintptr_t)col & 15) == 0)
    bitvector_kernel<true><<<grid, SCAN_THREADS, 0, st>>>(col, n, lo, hi,
                                                          out);
  else
    bitvector_kernel<false><<<grid, SCAN_THREADS, 0, st>>>(col, n, lo, hi,
                                                           out);
  return (int)cudaGetLastError();
}

}  // extern "C"
