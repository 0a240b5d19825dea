// The region joins shared by rho3.cu (K3, K3M) and nphj.cu (K3TWO,
// K3TWO_MAT), and the merge-path helpers rho3.cu's K2 uses too.
//
// Fine slots have K2's layout: keys (and payloads) of shape
// (f1, nbg, f2, cap2), counts (f1, nbg, f2); a slot holds its real elements
// first, sorted by (key, payload as unsigned).  A region is one (f1, f2)
// bucket pair: `nbg` runs, one slot each.  An S element (odd packed key k)
// matches when a TABLE run of its region holds k - 1, its R partner.  The
// first run (in index order) that holds the partner answers, and within it
// the lowest (key, payload) copy, so a duplicate R key still counts each S
// element once and the checksum is deterministic.  Matches and the
// checksum leave a CTA through integer atomicAdd; an unsigned 32-bit
// atomicAdd wraps mod 2^32, so the checksum is exact in any order.
//
// K3 and K3M probe and search the same array (RHO's union of R and S, R
// and S interleaved in each run).  K3TWO and K3TWO_MAT probe S's slots and
// search the table's, two arrays with their own run counts, so the
// persistent table is read where it lies.
//
// K3 and K3TWO: subrange_join_kernel, one CTA per (region, key sub-range).
//   A region at the headline holds ~22,800 R and ~91,000 S elements in 16
//   runs: far more than a CTA's 227 KB of shared memory.  Hashed keys spread
//   evenly over the region's key interval and every run is sorted, so the
//   CTA owns a key sub-range of the region across all of its runs, and
//   every element is read by one CTA only.
//   - Bounds.  The region's smallest and largest key (the first and last
//     element of each run) give its interval; it is cut into P equal widths
//     at EVEN packed keys, so S key k and its partner k - 1 always fall on
//     the same side.  The first sub-range starts at the smallest key and the
//     last ends past the largest, so no element is lost whatever scale
//     routed the keys.  One warp a run finds the sub-range's two bounds in
//     the run by two 32-way searches in device memory, side by side (3
//     rounds at 7,100 elements).
//   - R side.  The CTA reads its sub-range of every table run, run after
//     run as one virtual array cut into one stretch a warp (coalesced,
//     SR_ITEMS loads a lane in flight), keeps the even keys that differ
//     from their predecessor in the run (the first, lowest-payload copy of
//     each key) and compacts them into shared memory in run order: each
//     warp counts its kept keys (ballots), one scan gives the warps'
//     offsets, and each warp reads its stretch again, from L1, to place
//     them.  The runs' kept sub-runs are then merged pairwise, merge-path
//     levels with ties to the left (lower) run, so equal keys end in run
//     order and a lower_bound finds the answering copy; runs that kept
//     nothing take no level.  Payloads ride along.
//   - Too many R.  A piece whose kept R exceed SR_RCAP is cut in two halves
//     at an even key; the CTA does the left one and keeps the right one on
//     a stack in shared memory (each halving counted in *halvings).  After
//     the per-run dedupe one key has at most nbg copies, so a piece of one
//     R key always fits (the launcher requires nbg <= SR_RCAP).
//   - S side.  A directory of the merged keys (the first key at or past
//     each of up to SR_DIR equal key buckets of the piece) goes into the
//     free buffer.  The CTA reads its sub-range of every probe run,
//     coalesced, and each S element binary-searches its partner among its
//     bucket's keys (about one).  K3 reads a run's sub-range three times,
//     the two R sweeps and the S pass (the last two from L1 or L2); K3TWO
//     reads the table's runs twice and S's once.
//
// K3M and K3TWO_MAT: region_join_mat_kernel, one CTA per (region, probe
//   run j): it stages its probe slot in shared memory, stages each table
//   run of the region in turn, and each still unmatched S element
//   binary-searches it.  The CTA of (region, j) owns the output positions
//   of its slot (a * sa + b * sb + j * sj, + cap2): a matched S element
//   writes (((k >> 1) * inv) mod 2^30, R payload, S payload) at its own
//   position, every other position gets (-3, 0, 0).  `tail` more chunks of
//   cap2 per region, after the probe runs' slots, are holes too; the CTA of
//   run j writes the chunks j, j + nbg, ... of them.  inv is the salt's
//   inverse mod 2^30, so the first column is the original key.

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
// K3, K3TWO: one CTA per (region, key sub-range)

constexpr int SR_THREADS = 512;
constexpr int SR_WARPS = SR_THREADS / 32;
constexpr int SR_ITEMS = 4;                   // loads a lane has in flight
constexpr int SR_CHUNK = SR_THREADS * SR_ITEMS;
constexpr int SR_IT = 8;                      // merge outputs a thread
constexpr int SR_RCAP = SR_THREADS * SR_IT;   // R keys a CTA holds: 4,096
constexpr int SR_BUF = SR_RCAP + SR_RCAP / 16;  // pad_at(SR_RCAP)
constexpr int SR_DIR = 4096;                  // buckets, <= SR_BUF - 1
constexpr int SR_STACK = 40;                  // halvings pending (<= 31)
// Registers a thread is held to: 3 CTAs of 512 an SM, 40 registers (with
// the loop state in shared memory nothing spills); the latency-bound
// searches and sweeps gain from the third CTA
constexpr int SR_MIN_CTAS = 3;
static_assert(SR_WARPS <= 32, "one warp scans the warps' counts");

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

// Shared memory of the sub-range join: the ping-pong R buffers (keys, and
// payloads with PAY; the directory takes the free key buffer), the table
// runs' piece bounds (lo, offsets, kept rank at each run's start), the
// merged sub-runs' offsets, the probe runs' bounds (unless SAME) and the
// warps' counts.
inline long long subrange_smem(bool pay, bool same, int nt, int np) {
  return 4LL * ((pay ? 4 : 2) * SR_BUF + 4LL * nt + 2 +
                (same ? 0 : 2LL * np + 1) + SR_WARPS + 1);
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

template <bool PAY, bool SAME>
__global__ void __launch_bounds__(SR_THREADS, SR_MIN_CTAS)
    subrange_join_kernel(Runs probe, Runs table, int f2, int cap2, int P,
                         unsigned long long* __restrict__ matches,
                         unsigned int* __restrict__ checksum,
                         unsigned long long* __restrict__ halvings) {
  extern __shared__ int sm_sub[];
  // R buffer `src` (0 or 1): keys at sm_sub + src * SR_BUF, payloads (PAY
  // only) at sm_sub + (2 + src) * SR_BUF
  const int nt = table.nbg;
  const int np = SAME ? nt : probe.nbg;
  int* t_lo = sm_sub + (PAY ? 4 : 2) * SR_BUF;
  int* t_off = t_lo + nt;        // nt + 1
  int* t_start = t_off + nt + 1; // kept R before each run's piece
  int* m_off = t_start + nt;     // nt + 1: the merged sub-runs
  int* p_lo = SAME ? t_lo : m_off + nt + 1;
  int* p_off = SAME ? t_off : p_lo + np;
  int* w_cnt = SAME ? m_off + nt + 1 : p_off + np + 1;  // SR_WARPS + 1
  // the loop's state, uniform over the CTA, in shared memory (registers
  // are what a CTA an SM more costs): the piece [s_ab[0], s_ab[1]), the
  // right ends of the halves still to do, their count (-1: done)
  __shared__ long long s_ab[2];
  __shared__ long long s_stack[SR_STACK];
  __shared__ int s_kmin, s_kmax, s_runs, s_top;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = blockIdx.x % P;
  const int region = blockIdx.x / P;
  const int a = region / f2;
  const int b = region % f2;

  // the region's key interval
  if (tid == 0) {
    s_kmin = INT_MAX;
    s_kmax = -1;
  }
  __syncthreads();
  for (int r = tid; r < nt + (SAME ? 0 : np); r += SR_THREADS) {
    const bool tab = SAME || r < nt;
    const size_t s =
        ((size_t)a * (tab ? nt : np) + (tab ? r : r - nt)) * f2 + b;
    const int c = (tab ? table.cnt : probe.cnt)[s];
    const int* keys = (tab ? table.k : probe.k) + s * cap2;
    if (c > 0) {
      atomicMin(&s_kmin, keys[0]);
      atomicMax(&s_kmax, keys[c - 1]);
    }
  }
  __syncthreads();
  if (s_kmax < 0) return;  // an empty region (the whole CTA leaves)
  if (tid == 0) {
    const int kmin = s_kmin;
    const int kmax = s_kmax;
    const long long width = (long long)kmax - kmin + 1;
    s_ab[0] = p == 0 ? (kmin & ~1) : (kmin + p * width / P) & ~1LL;
    s_ab[1] = p == P - 1 ? (long long)(kmax & ~1) + 2
                         : (kmin + (p + 1) * width / P) & ~1LL;
    s_top = 0;
  }
  __syncthreads();

  unsigned my_m = 0u;
  unsigned my_c = 0u;
  // run i's slot is at t_base + i * run_stride (p_base for probe runs);
  // offsets from them fit 32 bits (the launcher checks nbg * f2 * cap2)
  const size_t t_base = slot_at(table, a, 0, b, f2, cap2);
  const size_t p_base = slot_at(probe, a, 0, b, f2, cap2);
  const unsigned run_stride = (unsigned)f2 * cap2;
  for (;;) {
    if (s_ab[0] < s_ab[1]) {
      piece_bounds(table, nt, a, b, f2, cap2, s_ab[0], s_ab[1], s_kmin,
                   s_kmax, t_lo, t_off);
      if (!SAME)
        piece_bounds(probe, np, a, b, f2, cap2, s_ab[0], s_ab[1], s_kmin,
                     s_kmax, p_lo, p_off);
      __syncthreads();
      if (warp == 0) lengths_to_offsets(t_off, nt, lane);
      if (!SAME && warp == 1) lengths_to_offsets(p_off, np, lane);
      __syncthreads();
      const int vt = t_off[nt];
      const int vp = p_off[np];
      if (vt > 0 && vp > 0) {
        // R pass: the first copy of each even key of each run, compacted
        // into R buffer 0 in run order.  Warp w takes the stretch
        // [w_lo, w_hi) of the runs' virtual array; sweep 0 counts the keys
        // it keeps, the warps' counts are scanned, and sweep 1 reads the
        // stretch again (from L1) to place them.
        const int seg = (vt + SR_THREADS - 1) / SR_THREADS * 32;
        const int w_lo = min(vt, warp * seg);
        const int w_hi = min(vt, w_lo + seg);
        int kept = 0;
        for (int sweep = 0; sweep < 2; ++sweep) {
          int rank = sweep ? w_cnt[warp] : 0;
          // this lane's run: its positions rise, so the run only moves on
          int run = w_lo < w_hi ? run_of(t_off, nt, w_lo) : 0;
          int r_off = t_off[run], r_next = t_off[run + 1];
          int r_lo = t_lo[run];
          for (int x0 = w_lo; x0 < w_hi; x0 += 32 * SR_ITEMS) {
            // per item: its key, run and element offset from t_base
            int key[SR_ITEMS], rr[SR_ITEMS];
            unsigned at[SR_ITEMS];
            unsigned first = 0;   // bit u: item u starts its run's piece
#pragma unroll
            for (int u = 0; u < SR_ITEMS; ++u) {
              const int x = x0 + u * 32 + lane;
              key[u] = -1;   // odd: never kept
              rr[u] = 0;
              at[u] = 0;
              if (x < w_hi) {
                while (x >= r_next) {
                  ++run;
                  r_off = r_next;
                  r_next = t_off[run + 1];
                  r_lo = t_lo[run];
                }
                rr[u] = run;
                at[u] = run * run_stride + r_lo + x - r_off;
                key[u] = __ldg(table.k + t_base + at[u]);
                if (x == r_off) first |= 1u << u;
              }
            }
#pragma unroll
            for (int u = 0; u < SR_ITEMS; ++u) {
              const bool is_first = (first >> u) & 1u;
              const size_t g = t_base + at[u];
              int prev = __shfl_up_sync(FULL, key[u], 1);
              if (lane == 0 && key[u] != -1 && !is_first)
                prev = __ldg(table.k + g - 1);
              const bool keep = !(key[u] & 1) && (is_first || prev != key[u]);
              const unsigned m = __ballot_sync(FULL, keep);
              if (sweep) {
                const int r = rank + __popc(m & ((1u << lane) - 1u));
                if (is_first) t_start[rr[u]] = r;
                if (keep) {
                  sm_sub[pad_at(r)] = key[u];
                  if (PAY) sm_sub[2 * SR_BUF + pad_at(r)] = __ldg(table.p + g);
                }
              }
              rank += __popc(m);
            }
          }
          if (sweep == 0) {   // the warps' exclusive offsets and the total
            if (lane == 0) w_cnt[warp] = rank;
            __syncthreads();
            if (warp == 0) {
              const unsigned v = lane < SR_WARPS ? w_cnt[lane] : 0;
              const unsigned incl = warp_incl_scan(v, lane);
              if (lane < SR_WARPS) w_cnt[lane] = incl - v;
              if (lane == 31) w_cnt[SR_WARPS] = incl;
            }
            __syncthreads();
            kept = w_cnt[SR_WARPS];
            if (kept > SR_RCAP) break;
          }
        }
        __syncthreads();
        if (kept > SR_RCAP) {
          // too many R: do the left half first, the right one waits
          if (tid == 0) {
            const long long A = s_ab[0], B = s_ab[1];
            s_stack[s_top++] = B;
            s_ab[1] = A + (((B - A) >> 2) << 1);
            atomicAdd(halvings, 1ull);
          }
          __syncthreads();
          continue;
        }
        // the runs that kept something, in run order
        if (tid == 0) {
          int g = 0;
          int prev = -1;
          for (int i = 0; i < nt; ++i) {
            if (t_off[i + 1] == t_off[i]) continue;
            const int s = t_start[i];
            if (prev >= 0 && s > prev) m_off[g++] = prev;
            prev = s;
          }
          if (prev >= 0 && kept > prev) m_off[g++] = prev;
          m_off[g] = kept;
          s_runs = g;
        }
        __syncthreads();
        const int G = s_runs;
        int src = 0;
        for (int w = 1; w < G; w <<= 1, src ^= 1) {
          // merge level: sub-runs [q, q + w) and [q + w, q + 2w) of m_off
          const int* ak = sm_sub + src * SR_BUF;
          const int* ap = sm_sub + (2 + src) * SR_BUF;
          int* dk = sm_sub + (src ^ 1) * SR_BUF;
          int* dp = sm_sub + (2 + (src ^ 1)) * SR_BUF;
          const int d = tid * SR_IT;
          if (d < kept) {
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
              if (x < kept) {
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
                if (PAY) dp[pad_at(x)] = ap[pad_at(take_a ? ia : ib)];
                ia += take_a;
                ib += !take_a;
              }
            }
          }
          __syncthreads();
        }
        const int* rk = sm_sub + src * SR_BUF;
        const int* rp = sm_sub + (2 + src) * SR_BUF;
        // directory of the merged keys in the other buffer: dir[t] is the
        // first key at or past A + (t << sh), for D <= SR_DIR buckets of
        // the piece, so a lookup searches one bucket's keys
        int* dir = sm_sub + (src ^ 1) * SR_BUF;
        const int a32 = (int)s_ab[0];
        const unsigned span = (unsigned)(s_ab[1] - s_ab[0]);
        int sh = 0;
        while (((span - 1) >> sh) >= (unsigned)SR_DIR) ++sh;
        const int nd = (int)((span - 1) >> sh) + 1;
        for (int i = tid; i < kept; i += SR_THREADS) {
          const int bi = (int)((unsigned)(rk[pad_at(i)] - a32) >> sh);
          const int bp =
              i ? (int)((unsigned)(rk[pad_at(i - 1)] - a32) >> sh) : -1;
          for (int t = bp + 1; t <= bi; ++t) dir[t] = i;
          if (i == kept - 1)
            for (int t = bi + 1; t <= nd; ++t) dir[t] = kept;
        }
        __syncthreads();
        // S pass: each S element of the piece looks up its partner; this
        // thread's positions rise, so its run only moves on
        int run = 0;
        int r_off = 0, r_next = p_off[1], r_lo = p_lo[0];
        for (int c0 = 0; kept > 0 && c0 < vp; c0 += SR_CHUNK) {
          int key[SR_ITEMS];
          unsigned at[SR_ITEMS];   // element offsets from p_base
#pragma unroll
          for (int q = 0; q < SR_ITEMS; ++q) {
            const int x = c0 + q * SR_THREADS + tid;
            key[q] = 0;   // even: never looked up
            at[q] = 0;
            if (x < vp) {
              while (x >= r_next) {
                ++run;
                r_off = r_next;
                r_next = p_off[run + 1];
                r_lo = p_lo[run];
              }
              at[q] = run * run_stride + r_lo + x - r_off;
              key[q] = __ldg(probe.k + p_base + at[q]);
            }
          }
#pragma unroll
          for (int q = 0; q < SR_ITEMS; ++q) {
            if (key[q] & 1) {
              const int want = key[q] - 1;
              const int bw = (int)((unsigned)(want - a32) >> sh);
              int lo = dir[bw], hi = dir[bw + 1];
              const int end = hi;
              while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (rk[pad_at(mid)] < want) lo = mid + 1; else hi = mid;
              }
              if (lo < end && rk[pad_at(lo)] == want) {
                ++my_m;
                if (PAY)
                  my_c += (unsigned)rp[pad_at(lo)] +
                          (unsigned)__ldg(probe.p + p_base + at[q]);
              }
            }
          }
        }
      }
    }
    __syncthreads();   // the next piece reuses every shared array
    if (tid == 0) {
      if (s_top > 0) {
        s_ab[0] = s_ab[1];
        s_ab[1] = s_stack[--s_top];
      } else {
        s_top = -1;
      }
    }
    __syncthreads();
    if (s_top < 0) break;
  }
  my_m = warp_sum(my_m);
  if (PAY) my_c = warp_sum(my_c);
  if (lane == 0) {
    if (my_m) atomicAdd(matches, (unsigned long long)my_m);
    if (PAY && my_c) atomicAdd(checksum, my_c);
  }
}

// Largest fine-slot capacity the region joins take (K3M's per-thread match
// mask: RJ_THREADS * RJ_MAX_PER_THREAD).
constexpr int RJ_THREADS = 512;
constexpr int RJ_MAX_PER_THREAD = 64;
constexpr int RJ_MAX_CAP = RJ_THREADS * RJ_MAX_PER_THREAD;

// K3 (SAME: probe and table are one array) or K3TWO: P key sub-ranges a
// region; payloads on both sides or neither.
template <bool SAME>
cudaError_t launch_subrange_join(Runs probe, Runs table, int f1, int f2,
                                 int cap2, int P,
                                 unsigned long long* matches,
                                 unsigned int* checksum,
                                 unsigned long long* halvings,
                                 cudaStream_t st) {
  const bool pay = table.p != nullptr;
  if ((probe.p == nullptr) == pay || f1 < 1 || f2 < 1 || P < 1 || cap2 < 1 ||
      cap2 > RJ_MAX_CAP || table.nbg < 0 || table.nbg > SR_RCAP ||
      probe.nbg < 0 || (long long)f1 * f2 * P > INT_MAX ||
      (long long)table.nbg * f2 * cap2 > INT_MAX ||
      (long long)probe.nbg * f2 * cap2 > INT_MAX)
    return cudaErrorInvalidValue;
  const long long grid = (long long)f1 * f2 * P;
  if (table.nbg == 0 || probe.nbg == 0) return cudaSuccess;
  const int smem = (int)subrange_smem(pay, SAME, table.nbg, probe.nbg);
  cudaError_t err;
#define RJ_SUB(PAY)                                                          \
  err = cudaFuncSetAttribute(subrange_join_kernel<PAY, SAME>,                \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                             smem);                                          \
  if (err != cudaSuccess) return err;                                        \
  subrange_join_kernel<PAY, SAME><<<(unsigned)grid, SR_THREADS, smem, st>>>( \
      probe, table, f2, cap2, P, matches, checksum, halvings)
  if (pay) {
    RJ_SUB(true);
  } else {
    RJ_SUB(false);
  }
#undef RJ_SUB
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3M, K3TWO_MAT: one CTA per (region, probe run)

struct Cols {  // materialized columns
  int* k;
  int* rp;
  int* sp;
  long long sa, sb, sj;  // element offsets of region (a, b) and probe run j
  int tail;              // hole chunks of cap2 per region after the runs
};

__global__ void __launch_bounds__(RJ_THREADS) region_join_mat_kernel(
    Runs probe, Runs table, int f2, int cap2, int inv, Cols out,
    unsigned long long* __restrict__ matches,
    unsigned int* __restrict__ checksum) {
  extern __shared__ int sm_mat[];
  int* s_probe = sm_mat;           // probe slot keys
  int* s_rk = sm_mat + cap2;       // searched run keys
  int* s_rp = sm_mat + 2 * cap2;   // searched run payloads
  const int j = blockIdx.x % probe.nbg;
  const int region = blockIdx.x / probe.nbg;
  const int a = region / f2;
  const int b = region % f2;
  const size_t cnt_j = ((size_t)a * probe.nbg + j) * f2 + b;
  const int cj = probe.cnt[cnt_j];
  const size_t off_j = cnt_j * cap2;
  int has_s = 0;
  for (int e = threadIdx.x; e < cj; e += blockDim.x) {
    const int k = probe.k[off_j + e];
    s_probe[e] = k;
    has_s |= k & 1;
  }
  const int any_s = __syncthreads_or(has_s);
  const size_t region_out = (size_t)a * out.sa + (size_t)b * out.sb;
  const size_t out_j = region_out + (size_t)j * out.sj;

  unsigned long long done = 0ull;  // bit t: element threadIdx.x + t*blockDim.x
  unsigned my_m = 0u;
  unsigned my_c = 0u;
  for (int i = 0; any_s && i < table.nbg; ++i) {
    const size_t cnt_i = ((size_t)a * table.nbg + i) * f2 + b;
    const int ci = table.cnt[cnt_i];
    if (ci == 0) continue;
    const size_t off_i = cnt_i * cap2;
    int has_r = 0;
    for (int e = threadIdx.x; e < ci; e += blockDim.x) {
      const int k = table.k[off_i + e];
      s_rk[e] = k;
      s_rp[e] = table.p[off_i + e];
      has_r |= !(k & 1);
    }
    if (__syncthreads_or(has_r)) {
      int t = 0;
      for (int e = threadIdx.x; e < cj; e += blockDim.x, ++t) {
        if ((done >> t) & 1ull) continue;
        const int k = s_probe[e];
        if (!(k & 1)) continue;
        const int want = k - 1;
        int lo = 0;
        int hi = ci;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_rk[mid] < want) lo = mid + 1; else hi = mid;
        }
        if (lo < ci && s_rk[lo] == want) {
          done |= 1ull << t;
          ++my_m;
          const int rp = s_rp[lo];
          const int sp = probe.p[off_j + e];
          my_c += (unsigned)rp + (unsigned)sp;
          out.k[out_j + e] =
              (int)(((unsigned)(k >> 1) * (unsigned)inv) & 0x3FFFFFFFu);
          out.rp[out_j + e] = rp;
          out.sp[out_j + e] = sp;
        }
      }
    }
    __syncthreads();  // the next run overwrites s_rk / s_rp
  }
  // holes: every position of the slot that no match wrote
  int t = 0;
  for (int e = threadIdx.x; e < cap2; e += blockDim.x, ++t) {
    if (e < cj && ((done >> t) & 1ull)) continue;
    out.k[out_j + e] = -3;
    out.rp[out_j + e] = 0;
    out.sp[out_j + e] = 0;
  }
  for (int q = probe.nbg + j; q < probe.nbg + out.tail; q += probe.nbg) {
    const size_t o = region_out + (size_t)q * out.sj;
    for (int e = threadIdx.x; e < cap2; e += blockDim.x) {
      out.k[o + e] = -3;
      out.rp[o + e] = 0;
      out.sp[o + e] = 0;
    }
  }
  my_m = warp_sum(my_m);
  my_c = warp_sum(my_c);
  if ((threadIdx.x & 31) == 0) {
    if (my_m) atomicAdd(matches, (unsigned long long)my_m);
    if (my_c) atomicAdd(checksum, my_c);
  }
}

// Shared memory the materializing region join needs for a fine-slot
// capacity of cap2.
inline long long region_join_mat_smem(int cap2) {
  return (long long)cap2 * sizeof(int) * 3;
}

// The materializing region join of probe's slots against table's, with
// payloads on both sides, into the columns of `out`.
inline cudaError_t launch_region_join_mat(Runs probe, Runs table, int f1,
                                          int f2, int cap2, int inv, Cols out,
                                          unsigned long long* matches,
                                          unsigned int* checksum,
                                          cudaStream_t st) {
  if (probe.p == nullptr || table.p == nullptr || cap2 > RJ_MAX_CAP)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)region_join_mat_smem(cap2);
  cudaError_t err = cudaFuncSetAttribute(
      region_join_mat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)f1 * f2 * probe.nbg;
  if (grid > 0)
    region_join_mat_kernel<<<(unsigned)grid, RJ_THREADS, smem, st>>>(
        probe, table, f2, cap2, inv, out, matches, checksum);
  return cudaGetLastError();
}

}  // namespace
