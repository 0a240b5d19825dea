// Hopper kernel of the windowed range-mask compaction.
//
//   compact_windows  replaces _make_kernel
//                    (aqp_tpu/ops/pallas/lanecompact.py:209), launched by
//                    _compact_windows (lanecompact.py:322).
//
// The column is cut into windows of `block` = w*128 elements.  For each
// window, the elements x with lo <= x <= hi are kept in order (a stable
// compaction), and for each kept element the same position of every
// payload array (one or two int32 arrays) is written to the window's output
// block of `cap` = ow*128 elements: the first min(count, cap) kept elements,
// then the array's fill value up to cap.  The window's count is written
// UNCAPPED, so the caller sees a window that was cut (count > cap) and
// reports it as overflow.  Elements past n (the ragged last window) are
// never kept.
//
// Design.  The TPU has no compress instruction, so the Pallas kernel builds
// a lane-compaction map by recursive doubling and places rows with one-hot
// int8 matmuls on the MXU.  None of that carries over: a warp has a ballot.
// One CTA per window walks it in tiles of blockDim.x elements, one element
// per thread: the range mask, a warp ballot and __popc of the lanes below
// give the rank inside the warp, a scan of the 32 warp counts gives the rank
// inside the tile, and a running offset carried across tiles gives the rank
// inside the window.  Kept elements are written straight to their output
// position.
//
// Bound: the column and the payload arrays are read once (n elements each)
// and the output blocks written once (nb * cap elements each), plus the
// counts.  The kernel reads the column once and a payload element only
// where its key is kept (from cache when the payload is the column itself,
// as compact_kp_fast passes it); the writes of kept elements are coalesced
// within a warp (consecutive ranks).

#include <cuda_runtime.h>

namespace {

constexpr int COMPACT_THREADS = 1024;

template <int NARR>
__global__ void __launch_bounds__(COMPACT_THREADS) compact_windows_kernel(
    const int* __restrict__ col, const int* __restrict__ a0,
    const int* __restrict__ a1, long long n, int block, int lo, int hi,
    int fill0, int fill1, int cap, int* __restrict__ o0,
    int* __restrict__ o1, int* __restrict__ counts) {
  __shared__ int s_warp[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long base = (long long)blockIdx.x * block;
  const long long out_base = (long long)blockIdx.x * cap;
  int running = 0;  // kept elements of earlier tiles; equal in every thread
  for (int t0 = 0; t0 < block; t0 += blockDim.x) {
    const int e = t0 + threadIdx.x;
    const long long gi = base + e;
    bool keep = false;
    if (e < block && gi < n) {
      const int x = col[gi];
      keep = x >= lo && x <= hi;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      int v = lane < nwarps ? s_warp[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      s_warp[lane] = v;  // inclusive prefix of the warp counts
    }
    __syncthreads();
    if (keep) {
      const int pos = running + (warp ? s_warp[warp - 1] : 0) +
                      __popc(bal & ((1u << lane) - 1u));
      if (pos < cap) {
        o0[out_base + pos] = a0[gi];
        if (NARR == 2) o1[out_base + pos] = a1[gi];
      }
    }
    running += s_warp[nwarps - 1];
    __syncthreads();  // the next tile overwrites s_warp
  }
  const int kept = running < cap ? running : cap;
  for (int p = kept + threadIdx.x; p < cap; p += blockDim.x) {
    o0[out_base + p] = fill0;
    if (NARR == 2) o1[out_base + p] = fill1;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = running;
}

}  // namespace

extern "C" {

// col[n], a0[n] (and a1[n] when narr == 2) -> o0/o1[nb][cap], counts[nb]
// with nb = ceil(n / block).
int compact_windows(const int* col, const int* a0, const int* a1, int narr,
                    long long n, int block, int lo, int hi, int fill0,
                    int fill1, int cap, int* o0, int* o1, int* counts,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (narr < 1 || narr > 2) return (int)cudaErrorInvalidValue;
  const long long nb = (n + block - 1) / block;
  if (narr == 2)
    compact_windows_kernel<2><<<(unsigned)nb, COMPACT_THREADS, 0, st>>>(
        col, a0, a1, n, block, lo, hi, fill0, fill1, cap, o0, o1, counts);
  else
    compact_windows_kernel<1><<<(unsigned)nb, COMPACT_THREADS, 0, st>>>(
        col, a0, nullptr, n, block, lo, hi, fill0, fill1, cap, o0, nullptr,
        counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
