// The parts of a key sub-range CTA, shared by the region joins of
// region_join.cuh (K3, K3M, K3TWO) and the routed aggregate of aggpipe.cu
// (K3AGG), and the merge-path helpers rho3.cu's K2 uses too.
//
// Fine slots have K2's layout: keys (and payloads) of shape
// (f1, nbg, f2, cap2), counts (f1, nbg, f2); a slot holds its real elements
// first, sorted by (key, payload as unsigned).  A region is one (f1, f2)
// bucket pair: `nbg` runs, one slot each.  A region at the headline holds
// ~114,000 elements in 16 runs, far more than a CTA's 227 KB of shared
// memory; keys spread evenly over the region's key interval and every run
// is sorted, so a CTA owns a key sub-range of the region across all of its
// runs, and every element is read by one CTA only:
//   - Bounds.  The region's smallest and largest key (the first and last
//     element of each run) give its interval; it is cut into P equal widths
//     at EVEN keys (subrange_bounds), so an S key k of a join and its
//     partner k - 1 always fall on the same side.  The first sub-range
//     starts at the smallest key and the last ends past the largest, so no
//     element is lost whatever scale routed the keys.
//   - Pieces.  A CTA works on a piece [A, B) of keys: its sub-range, or a
//     half of it that it cut off because the piece did not fit its shared
//     memory (the right half waits on a stack in shared memory).  One warp
//     a run finds the piece's two bounds in the run by two 32-way searches
//     in device memory, side by side (piece_bounds: 3 rounds at 7,100
//     elements); the runs' stretches then make one virtual array, run after
//     run (lengths_to_offsets).
//   - Merge.  Sorted sub-runs in shared memory are merged pairwise,
//     merge-path levels with ties to the left (lower) run, SR_IT outputs a
//     thread, values riding along (merge_runs).

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// Warp and merge-path helpers

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(FULL, v, d);
  return v;
}

__device__ __forceinline__ unsigned warp_incl_scan(unsigned x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The number of a's values among the first k outputs of merge(a[0, na),
// b[0, nb)), a's value first on ties.
template <class FA, class FB>
__device__ __forceinline__ int co_rank(FA a, int na, FB b, int nb, int k) {
  int lo = max(0, k - nb), hi = min(k, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a(mid) <= b(k - 1 - mid))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Shared-memory slot of value x: one pad word every 16 keeps a thread's
// consecutive values and 16 consecutive threads' values on distinct banks.
__device__ __forceinline__ int pad_at(int x) { return x + (x >> 4); }

// The last sub-run bi in [0, G) with off[bi] <= x (off[0] = 0 <= x).
__device__ __forceinline__ int run_of(const int* off, int G, int x) {
  int lo = 0, hi = G;      // the answer lies in [lo, hi)
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= x)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

struct Runs {
  const int* k;    // (f1, nbg, f2, cap2) keys
  const int* p;    // payloads of the same shape, or null
  const int* cnt;  // (f1, nbg, f2) real elements per slot
  int nbg;
};

// ---------------------------------------------------------------------------
// Key sub-range CTAs

constexpr int SR_THREADS = 512;
constexpr int SR_WARPS = SR_THREADS / 32;
constexpr int SR_ITEMS = 4;                   // loads a lane has in flight
constexpr int SR_CHUNK = SR_THREADS * SR_ITEMS;
constexpr int SR_IT = 8;                      // merge outputs a thread
constexpr int SR_RCAP = SR_THREADS * SR_IT;   // values a CTA merges: 4,096
constexpr int SR_BUF = SR_RCAP + SR_RCAP / 16;  // pad_at(SR_RCAP)
constexpr int SR_STACK = 40;                  // halvings pending (<= 32)
// Registers a thread is held to: 3 CTAs of 512 an SM, 40 registers (with
// the loop state in shared memory nothing spills); the latency-bound
// searches and sweeps gain from the third CTA
constexpr int SR_MIN_CTAS = 3;
static_assert(SR_WARPS <= 32, "one warp scans the warps' counts");

// Sub-range p of P of the key interval [kmin, kmax]: ab = [A, B), cut at
// even keys; the first starts at or below kmin, the last ends past kmax.
__device__ __forceinline__ void subrange_bounds(int kmin, int kmax, int p,
                                                int P, long long* ab) {
  const long long width = (long long)kmax - kmin + 1;
  ab[0] = p == 0 ? ((long long)kmin & ~1LL) : (kmin + p * width / P) & ~1LL;
  ab[1] = p == P - 1 ? ((long long)kmax & ~1LL) + 2
                     : (kmin + (p + 1) * width / P) & ~1LL;
}

// [lo, hi) after a 32-way search step of `step` found t of its 32 keys
// below the bound.
__device__ __forceinline__ void narrow(int& lo, int& hi, int step, int t) {
  if (lo < hi) {
    if (t == 0) {
      hi = lo;
    } else {
      hi = min(hi, lo + t * step);
      lo += (t - 1) * step + 1;
    }
  }
}

// One round of two 32-way searches by a whole warp, for the first index
// in [lo0, hi0) whose key is >= c0 and in [lo1, hi1) whose key is >= c1:
// the lanes load 32 evenly spaced keys of each range (none of a range
// that is done), both loads in flight at once.
__device__ __forceinline__ void search_round(const int* __restrict__ keys,
                                             long long c0, long long c1,
                                             int lane, int& lo0, int& hi0,
                                             int& lo1, int& hi1) {
  const int s0 = (hi0 - lo0 + 31) >> 5;
  const int s1 = (hi1 - lo1 + 31) >> 5;
  const int q0 = lo0 + lane * s0;
  const int q1 = lo1 + lane * s1;
  const int k0 = q0 < hi0 ? __ldg(keys + q0) : INT_MAX;
  const int k1 = q1 < hi1 ? __ldg(keys + q1) : INT_MAX;
  narrow(lo0, hi0, s0, __popc(__ballot_sync(FULL, q0 < hi0 && k0 < c0)));
  narrow(lo1, hi1, s1, __popc(__ballot_sync(FULL, q1 < hi1 && k1 < c1)));
}

// Element offset of run i's slot of region (a, b).
__device__ __forceinline__ size_t slot_at(const Runs& r, int a, int i, int b,
                                          int f2, int cap2) {
  return (((size_t)a * r.nbg + i) * f2 + b) * cap2;
}

// Sets lo[i] to the first position of run i's slot at or past key A and
// off[i] to the count up to B, for each of n runs (one warp a run); A at
// or below kmin means position 0, B past kmax the slot's count.
__device__ __forceinline__ void piece_bounds(const Runs& r, int n, int a,
                                             int b, int f2, int cap2,
                                             long long A, long long B,
                                             int kmin, int kmax, int* lo,
                                             int* off) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n; i += SR_WARPS) {
    const size_t s = ((size_t)a * r.nbg + i) * f2 + b;
    const int c = r.cnt[s];
    const int* keys = r.k + s * cap2;
    // both bounds at once: their loads share each round trip
    int l = 0, l_hi = A <= kmin ? 0 : c;
    int h = 0, h_hi = B > kmax ? 0 : c;
    while (l < l_hi || h < h_hi)
      search_round(keys, A, B, lane, l, l_hi, h, h_hi);
    if (B > kmax) h = c;
    if (lane == 0) {
      lo[i] = l;
      off[i] = h - l;
    }
  }
}

// off[0, n) holds lengths: make it their exclusive prefix, off[n] the
// total (one warp).
__device__ __forceinline__ void lengths_to_offsets(int* off, int n,
                                                   int lane) {
  unsigned carry = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const unsigned len = i < n ? off[i] : 0;
    const unsigned incl = warp_incl_scan(len, lane);
    if (i < n) off[i] = carry + incl - len;
    carry += __shfl_sync(FULL, incl, 31);
  }
  if (lane == 0) off[n] = carry;
}

// Merges the G sorted sub-runs [m_off[q], m_off[q + 1]) of n <= SR_RCAP
// values in shared memory into one, pairwise, ties to the left (lower)
// sub-run, so equal keys keep their sub-runs' order.  Buffer s (0 or 1)
// holds keys at buf + s * SR_BUF and, with VAL, values at buf + (2 + s) *
// SR_BUF, each at pad_at(position); the values start in buffer 0.
// Returns the buffer that holds the merged run.  Every thread calls it.
template <bool VAL>
__device__ __forceinline__ int merge_runs(int* buf, const int* m_off, int G,
                                          int n) {
  int src = 0;
  for (int w = 1; w < G; w <<= 1, src ^= 1) {
    // merge level: sub-runs [q, q + w) and [q + w, q + 2w) of m_off
    const int* ak = buf + src * SR_BUF;
    const int* ap = buf + (2 + src) * SR_BUF;
    int* dk = buf + (src ^ 1) * SR_BUF;
    int* dp = buf + (2 + (src ^ 1)) * SR_BUF;
    const int d = threadIdx.x * SR_IT;
    if (d < n) {
      int q = run_of(m_off, G, d) / (2 * w) * (2 * w);
      int ps = m_off[q];
      int pm = m_off[min(q + w, G)];
      int pe = m_off[min(q + 2 * w, G)];
      const int k = d - ps;
      const int i = co_rank(
          [&](int t) { return ak[pad_at(ps + t)]; }, pm - ps,
          [&](int t) { return ak[pad_at(pm + t)]; }, pe - pm, k);
      int ia = ps + i, ib = pm + k - i;
#pragma unroll
      for (int j = 0; j < SR_IT; ++j) {
        const int x = d + j;
        if (x < n) {
          while (x == pe) {   // the next pair starts here
            q += 2 * w;
            ps = pe;
            pm = m_off[min(q + w, G)];
            pe = m_off[min(q + 2 * w, G)];
            ia = ps;
            ib = pm;
          }
          const int va = ia < pm ? ak[pad_at(ia)] : 0;
          const int vb = ib < pe ? ak[pad_at(ib)] : 0;
          const bool take_a = ib >= pe || (ia < pm && va <= vb);
          dk[pad_at(x)] = take_a ? va : vb;
          if (VAL) dp[pad_at(x)] = ap[pad_at(take_a ? ia : ib)];
          ia += take_a;
          ib += !take_a;
        }
      }
    }
    __syncthreads();
  }
  return src;
}

}  // namespace
