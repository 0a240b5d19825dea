// Hopper kernel of the routed group-by aggregate's region step.
//
//   K3AGG  replaces _make_k3agg (aqp_tpu/ops/pallas/aggpipe.py:112),
//          launched by groupby_aggregate_routed (aggpipe.py:244).
//
// Input: K2's fine slots of one packed array routed by key range (salt 1):
// region (a, b) owns the slots (a, j, b) of every window j < nbg; a slot
// holds its real (key, value) elements first, sorted by (key, value as
// unsigned), then pads, and cnt2 says how many are real.  A key's elements
// all lie in one region, spread over any of its nbg slots ("runs").  For
// every region the kernel emits one row per distinct valid key k (k >= 0,
// k != KEY_PAD_INT): ((k >> 1) & (2^30 - 1), count, sum mod 2^32, min, max
// of its values, min and max signed), the rows dense and ascending by key
// at the start of the region's output block of w = nbg * cap2 elements,
// (HOLE, 0, 0, 0, 0) behind them, and the region's row count.
//
// Why the design differs from the TPU's: there a region's window (nbg runs
// of cap2 pairs, 1 MiB at bench.py's aggregate) sits in VMEM, the runs are
// merged, segmented lane and row scans aggregate the key runs, and the
// lane compactor packs one row per group.  A CTA has 227 KB of shared
// memory, so nothing of that carries over.  The kernel instead uses that
// every run is sorted:
//   pass 1 (k3agg_owner_kernel), one CTA per (region, run j): the first
//          element of each key of run j that no earlier run holds (a binary
//          search of each run < j) is the key's OWNER.  The owner's thread
//          reduces count, sum, min and max over the key's contiguous range
//          in every run >= j (a binary search finds where the range starts)
//          and writes the row to run j's scratch list at the owner's rank
//          among run j's owners (warp ballots and a running offset, as the
//          window compactor ranks kept elements), so the list is sorted by
//          key; then the list's length.
//   pass 2 (k3agg_place_kernel), one CTA per (region, run j): every key of
//          the region has exactly one owner, so the owner at position i of
//          list j has rank i + sum over r != j of lower_bound(list r, k)
//          among the region's keys; its row goes there.  The CTAs of a
//          region split the fill of the positions past the region's count;
//          run 0's CTA writes the count.
// The sum wraps mod 2^32 as the reference's int32 adds do; the Python side
// returns it as an unsigned value in int64.
//
// Bound: the real (key, value) pairs of the fine slots read once (8 bytes
// each, the counts say where they end) and each group's five output values
// written once (20 bytes), plus the counts: at bench.py's aggregate (52.4M
// live rows, 2^20 groups) 0.42 GB, 0.13 ms at 3.35 TB/s.  This kernel also
// writes the fill of every region block (5 x 4 x w bytes per region) and
// passes through a scratch list per run, and its binary searches are
// chains of dependent loads; PERF.md has the measured times.

#include <cuda_runtime.h>

namespace {

constexpr int AGG_THREADS = 256;
constexpr int KEY_PAD_INT = 2147483647;
constexpr int HOLE = -3;
constexpr int KEY_MASK = (1 << 30) - 1;

struct Region {
  long long slot_stride;  // elements between the slots of runs j and j + 1
  long long first;        // element offset of the region's run-0 slot
  int cnt_first;          // index of the run-0 slot in cnt2
  int cnt_stride;
};

__device__ __forceinline__ Region region_of(int reg, int nbg, int f2,
                                            int cap2) {
  const int a = reg / f2, b = reg % f2;
  Region r;
  r.cnt_first = a * nbg * f2 + b;
  r.cnt_stride = f2;
  r.first = (long long)r.cnt_first * cap2;
  r.slot_stride = (long long)f2 * cap2;
  return r;
}

// first index in [0, n) with a[i] >= k (n when none)
__device__ __forceinline__ int lower_bound_i(const int* __restrict__ a,
                                             int n, int k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < k)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(AGG_THREADS) k3agg_owner_kernel(
    const int* __restrict__ k2, const int* __restrict__ p2,
    const int* __restrict__ cnt2, int nbg, int f2, int cap2,
    int* __restrict__ sk, int* __restrict__ scnt, int* __restrict__ ssum,
    int* __restrict__ smin, int* __restrict__ smax,
    int* __restrict__ ocount) {
  __shared__ int s_warp[AGG_THREADS / 32];
  const int reg = blockIdx.x / nbg;
  const int j = blockIdx.x % nbg;
  const Region R = region_of(reg, nbg, f2, cap2);
  const int* keys = k2 + R.first + j * R.slot_stride;
  const int cnt = cnt2[R.cnt_first + j * R.cnt_stride];
  const long long list = ((long long)reg * nbg + j) * cap2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int running = 0;  // owners of earlier tiles; equal in every thread
  for (int t0 = 0; t0 < cnt; t0 += AGG_THREADS) {
    const int i = t0 + threadIdx.x;
    bool owner = false;
    int k = 0;
    if (i < cnt) {
      k = keys[i];
      owner = k >= 0 && k != KEY_PAD_INT && (i == 0 || keys[i - 1] != k);
      for (int r = 0; owner && r < j; ++r) {
        const int* rk = k2 + R.first + r * R.slot_stride;
        const int rc = cnt2[R.cnt_first + r * R.cnt_stride];
        const int at = lower_bound_i(rk, rc, k);
        owner = !(at < rc && rk[at] == k);
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, owner);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int before = running;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    int tile = 0;
    for (int w = 0; w < AGG_THREADS / 32; ++w) tile += s_warp[w];
    if (owner) {
      unsigned sum = 0;
      int c = 0, mn = 2147483647, mx = -2147483647 - 1;
      for (int r = j; r < nbg; ++r) {
        const int* rk = k2 + R.first + r * R.slot_stride;
        const int* rv = p2 + R.first + r * R.slot_stride;
        const int rc = cnt2[R.cnt_first + r * R.cnt_stride];
        int e = r == j ? i : lower_bound_i(rk, rc, k);
        for (; e < rc && rk[e] == k; ++e) {
          const int v = rv[e];
          ++c;
          sum += (unsigned)v;
          mn = v < mn ? v : mn;
          mx = v > mx ? v : mx;
        }
      }
      const long long q = list + before + __popc(bal & ((1u << lane) - 1u));
      sk[q] = k;
      scnt[q] = c;
      ssum[q] = (int)sum;
      smin[q] = mn;
      smax[q] = mx;
    }
    running += tile;
    __syncthreads();  // the next tile overwrites s_warp
  }
  if (threadIdx.x == 0) ocount[(long long)reg * nbg + j] = running;
}

__global__ void __launch_bounds__(AGG_THREADS) k3agg_place_kernel(
    const int* __restrict__ sk, const int* __restrict__ scnt,
    const int* __restrict__ ssum, const int* __restrict__ smin,
    const int* __restrict__ smax, const int* __restrict__ ocount, int nbg,
    int cap2, int* __restrict__ okey, int* __restrict__ ocnt,
    int* __restrict__ osum, int* __restrict__ omin, int* __restrict__ omax,
    int* __restrict__ counts) {
  const int reg = blockIdx.x / nbg;
  const int j = blockIdx.x % nbg;
  const long long w = (long long)nbg * cap2;
  const long long lists = (long long)reg * nbg * cap2;
  const int* oc = ocount + (long long)reg * nbg;
  int total = 0;
  for (int r = 0; r < nbg; ++r) total += oc[r];
  const long long out = (long long)reg * w;
  const int mine = oc[j];
  const long long list = lists + (long long)j * cap2;
  for (int i = threadIdx.x; i < mine; i += AGG_THREADS) {
    const int k = sk[list + i];
    long long rank = i;
    for (int r = 0; r < nbg; ++r)
      if (r != j)
        rank += lower_bound_i(sk + lists + (long long)r * cap2, oc[r], k);
    const long long q = out + rank;
    okey[q] = (k >> 1) & KEY_MASK;
    ocnt[q] = scnt[list + i];
    osum[q] = ssum[list + i];
    omin[q] = smin[list + i];
    omax[q] = smax[list + i];
  }
  // the fill of [total, w), split among the region's nbg CTAs
  const long long span = (w - total + nbg - 1) / nbg;
  const long long f0 = total + span * j;
  const long long f1 = f0 + span < w ? f0 + span : w;
  for (long long p = f0 + threadIdx.x; p < f1; p += AGG_THREADS) {
    okey[out + p] = HOLE;
    ocnt[out + p] = 0;
    osum[out + p] = 0;
    omin[out + p] = 0;
    omax[out + p] = 0;
  }
  if (j == 0 && threadIdx.x == 0) counts[reg] = total;
}

}  // namespace

extern "C" {

// k2/p2: (f1, nbg, f2, cap2) int32 fine slots, cnt2: (f1, nbg, f2) ->
// okey/ocnt/osum/omin/omax: (f1 * f2, nbg * cap2) int32 region blocks,
// counts: (f1 * f2) int32.  Scratch: sk/scnt/ssum/smin/smax of
// f1 * f2 * nbg * cap2 int32 each, ocount of f1 * f2 * nbg int32.
int aggpipe_k3agg(const int* k2, const int* p2, const int* cnt2, int f1,
                  int nbg, int f2, int cap2, int* sk, int* scnt, int* ssum,
                  int* smin, int* smax, int* ocount, int* okey, int* ocnt,
                  int* osum, int* omin, int* omax, int* counts,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long ctas = (long long)f1 * f2 * nbg;
  if (ctas <= 0) return 0;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k3agg_owner_kernel<<<(unsigned)ctas, AGG_THREADS, 0, st>>>(
      k2, p2, cnt2, nbg, f2, cap2, sk, scnt, ssum, smin, smax, ocount);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3agg_place_kernel<<<(unsigned)ctas, AGG_THREADS, 0, st>>>(
      sk, scnt, ssum, smin, smax, ocount, nbg, cap2, okey, ocnt, osum, omin,
      omax, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
