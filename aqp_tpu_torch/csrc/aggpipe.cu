// Hopper kernels of the routed group-by aggregate's region step.
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
// memory.  So, as K3 does (subrange.cuh), a CTA owns a key sub-range of a
// region across all of its runs, and each element is read by one CTA.
// Count, sum mod 2^32, min and max do not depend on the order of a key's
// values, so only the keys' order matters:
//   pass 1 (k3agg_reduce_kernel), one CTA per (region, key sub-range p of
//          P): the sub-range's bounds in every run, then piece by piece
//          (a piece: the sub-range, or a half of it), after one more round
//          trip for the piece's smallest and largest key:
//          - keys spanning at most AGG_TABLE values (a dense key range,
//            the 64-group leg's pseudo-groups, a key that fills a region):
//            a table in shared memory, one entry a key value.  The CTA
//            reads the piece's elements once, coalesced, SR_ITEMS loads a
//            lane in flight; equal keys sit side by side in a run, so a
//            segmented warp scan folds each lane stretch of one key into
//            its last lane, which adds it to the key's entry (four shared
//            atomics).  The used entries, in key order, are the rows (a
//            scan of the threads' counts gives each its rank);
//          - else a piece of at most SR_RCAP elements (sparse keys) is
//            staged (key, value) in shared memory run after run, its runs
//            merged (merge_runs, the values riding along), its groups found
//            by their first elements (a scan gives each group's rank), and
//            each group reduced by one thread, or by a warp where it holds
//            more than LONG_GROUP elements;
//          - else the piece is halved at the middle of the keys it holds
//            (each halving counted in *halvings), the right half stacked
//            in shared memory.
//          The rows go to scratch at the sub-range's element offset in its
//          region (its first piece's start in every run, summed), which no
//          other sub-range's rows can reach: a sub-range has at most one
//          row per element.  Then the sub-range's row count and offset.
//   pass 2 (k3agg_place_kernel), one CTA per (region, sub-range): the rows
//          of the region's earlier sub-ranges give this one's place; a
//          column at a time, its rows are copied there and the region's
//          fill [count, w) is split evenly among its CTAs (16-byte
//          stores); sub-range 0's CTA writes the count.  Each output
//          position is written once (PERF.md has the layouts tried).
// The sum wraps mod 2^32 as the reference's int32 adds do; the Python side
// returns it as an unsigned value in int64.
//
// Bound: the real (key, value) pairs of the fine slots read once (8 bytes
// each, the counts say where they end), plus the counts, and the five
// int32 region blocks (nreg x w each) and the region counts written once:
// at bench.py's aggregate (52.4M live rows, 2^20 groups; nreg = 576, w =
// 131,072) 0.42 + 1.51 GB, 0.58 ms at 3.35 TB/s.  The scratch rows (20
// bytes a group, written once and read once) and the two ints a sub-range
// are on top of that; PERF.md has the measured times.

#include <cstdint>

#include <cuda_runtime.h>

#include "subrange.cuh"

namespace {

constexpr int KEY_PAD_INT = 2147483647;
constexpr int HOLE = -3;
constexpr int KEY_MASK = (1 << 30) - 1;
constexpr int AGG_TABLE = SR_RCAP;   // key values a direct table spans
constexpr int LONG_GROUP = 32;       // a group of more elements takes a warp
constexpr int PLACE_THREADS = 512;

constexpr int NCOL = 5;
struct Rows {  // the key, count, sum, min and max columns
  int* col[NCOL];
};

__device__ __forceinline__ bool is_group(int k) {
  return k >= 0 && k != KEY_PAD_INT;
}

__device__ __forceinline__ void put_row(const Rows& o, size_t q, int key,
                                        unsigned c, unsigned s, int mn,
                                        int mx) {
  o.col[0][q] = (key >> 1) & KEY_MASK;
  o.col[1][q] = (int)c;
  o.col[2][q] = (int)s;
  o.col[3][q] = mn;
  o.col[4][q] = mx;
}

// Sum, min and max over a warp; lane 0 holds them.
__device__ __forceinline__ void warp_reduce(unsigned& s, int& mn, int& mx) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s += __shfl_down_sync(FULL, s, d);
    mn = min(mn, __shfl_down_sync(FULL, mn, d));
    mx = max(mx, __shfl_down_sync(FULL, mx, d));
  }
}

// This thread's exclusive rank of n among the CTA's threads, in thread
// order, and the CTA's total in *total (every thread calls it; w_cnt holds
// SR_WARPS + 1 ints).
__device__ __forceinline__ int cta_rank(unsigned n, int* w_cnt, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned incl = warp_incl_scan(n, lane);
  if (lane == 31) w_cnt[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned t = lane < SR_WARPS ? w_cnt[lane] : 0;
    const unsigned ti = warp_incl_scan(t, lane);
    if (lane < SR_WARPS) w_cnt[lane] = ti - t;
    if (lane == 31) w_cnt[SR_WARPS] = ti;
  }
  __syncthreads();
  *total = w_cnt[SR_WARPS];
  return w_cnt[warp] + incl - n;
}

// A piece of v elements in the runs' virtual array: run i's stretch is
// [lo[i], + len) of its slot, off[i] its first position in the array.
struct Piece {
  const int* k;     // the region's run-0 slot (keys)
  const int* p;     // (values)
  unsigned stride;  // elements between the slots of runs i and i + 1
  const int* lo;
  const int* off;
  int v;
};

// Walks one thread's rising positions of a piece's virtual array.
struct Cursor {
  int run = 0, r_off = 0, r_next, r_lo;
  __device__ explicit Cursor(const Piece& pc)
      : r_next(pc.off[1]), r_lo(pc.lo[0]) {}
  // element offset of position x from the run-0 slot
  __device__ __forceinline__ unsigned at(const Piece& pc, int x) {
    while (x >= r_next) {
      ++run;
      r_off = r_next;
      r_next = pc.off[run + 1];
      r_lo = pc.lo[run];
    }
    return run * pc.stride + r_lo + x - r_off;
  }
};

// Loads the SR_ITEMS (key, value) pairs of this thread at positions c0 +
// q * SR_THREADS + tid; past v, (KEY_PAD_INT, 0).
__device__ __forceinline__ void load_items(const Piece& pc, Cursor& cur,
                                           int c0, int* key, int* val) {
#pragma unroll
  for (int q = 0; q < SR_ITEMS; ++q) {
    const int x = c0 + q * SR_THREADS + threadIdx.x;
    key[q] = KEY_PAD_INT;
    val[q] = 0;
    if (x < pc.v) {
      const unsigned at = cur.at(pc, x);
      key[q] = __ldg(pc.k + at);
      val[q] = __ldg(pc.p + at);
    }
  }
}

// The rows of a piece whose keys lie in [pmin, pmin + span), span <=
// AGG_TABLE, through a table in shared memory (sm: 4 buffers of SR_BUF
// ints).  Returns the rows written at row0 on.
__device__ __forceinline__ int direct_piece(const Piece& pc, int pmin,
                                            int span, int* sm, int* w_cnt,
                                            const Rows& tmp, size_t row0) {
  int* t_cnt = sm;
  unsigned* t_sum = reinterpret_cast<unsigned*>(sm + SR_BUF);
  int* t_min = sm + 2 * SR_BUF;
  int* t_max = sm + 3 * SR_BUF;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i = tid; i < span; i += SR_THREADS) {
    t_cnt[i] = 0;
    t_sum[i] = 0;
    t_min[i] = INT_MAX;
    t_max[i] = INT_MIN;
  }
  __syncthreads();
  Cursor cur(pc);
  for (int c0 = 0; c0 < pc.v; c0 += SR_CHUNK) {
    int key[SR_ITEMS], val[SR_ITEMS];
    load_items(pc, cur, c0, key, val);
#pragma unroll
    for (int q = 0; q < SR_ITEMS; ++q) {
      // the lanes of one key are side by side: fold each stretch into its
      // last lane (a segmented scan from the stretch's first lane); the
      // lanes past v hold KEY_PAD_INT, no group
      const int k = key[q];
      const int up = __shfl_up_sync(FULL, k, 1);
      const unsigned hm = __ballot_sync(FULL, lane == 0 || k != up);
      const int first = 31 - __clz(hm & (FULL >> (31 - lane)));
      unsigned s = (unsigned)val[q];
      int mn = val[q], mx = val[q];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned s2 = __shfl_up_sync(FULL, s, d);
        const int mn2 = __shfl_up_sync(FULL, mn, d);
        const int mx2 = __shfl_up_sync(FULL, mx, d);
        if (lane - d >= first) {
          s += s2;
          mn = min(mn, mn2);
          mx = max(mx, mx2);
        }
      }
      if ((lane == 31 || ((hm >> (lane + 1)) & 1u)) && is_group(k)) {
        const int i = k - pmin;
        atomicAdd(t_cnt + i, lane - first + 1);
        atomicAdd(t_sum + i, s);
        atomicMin(t_min + i, mn);
        atomicMax(t_max + i, mx);
      }
    }
  }
  __syncthreads();
  // the used entries, in key order
  const int d = tid * SR_IT;
  unsigned used = 0;
#pragma unroll
  for (int j = 0; j < SR_IT; ++j)
    if (d + j < span && t_cnt[d + j] > 0) used |= 1u << j;
  int ng;
  int r = cta_rank(__popc(used), w_cnt, &ng);
  for (int j = 0; j < SR_IT; ++j) {
    if ((used >> j) & 1u) {
      const int i = d + j;
      put_row(tmp, row0 + r++, pmin + i, t_cnt[i], t_sum[i], t_min[i],
              t_max[i]);
    }
  }
  return ng;
}

// The rows of a piece of at most SR_RCAP elements: staged in shared
// memory, its runs merged, and reduced a group at a time (sm: 4 buffers of
// SR_BUF ints; m_off nbg + 1 ints).  Returns the rows written at row0 on.
__device__ __forceinline__ int merge_piece(const Piece& pc, int nbg, int* sm,
                                           int* m_off, int* w_cnt,
                                           const Rows& tmp, size_t row0) {
  __shared__ int s_runs, s_end, s_nlong;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // stage the (key, value) pairs in buffer 0, run after run
  Cursor cur(pc);
  for (int c0 = 0; c0 < pc.v; c0 += SR_CHUNK) {
    int key[SR_ITEMS], val[SR_ITEMS];
    load_items(pc, cur, c0, key, val);
#pragma unroll
    for (int q = 0; q < SR_ITEMS; ++q) {
      const int x = c0 + q * SR_THREADS + tid;
      if (x < pc.v) {
        sm[pad_at(x)] = key[q];
        sm[2 * SR_BUF + pad_at(x)] = val[q];
      }
    }
  }
  // the runs that hold elements, in run order
  if (tid == 0) {
    int g = 0;
    for (int i = 0; i < nbg; ++i)
      if (pc.off[i + 1] > pc.off[i]) m_off[g++] = pc.off[i];
    m_off[g] = pc.v;
    s_runs = g;
    s_nlong = 0;
  }
  __syncthreads();
  const int src = merge_runs<true>(sm, m_off, s_runs, pc.v);
  const int* rk = sm + src * SR_BUF;
  const int* rv = sm + (2 + src) * SR_BUF;
  int* hp = sm + (src ^ 1) * SR_BUF;          // group starts
  int* longs = sm + (2 + (src ^ 1)) * SR_BUF;  // groups a warp reduces
  // heads: the first element of each valid key (negative keys sort first,
  // KEY_PAD_INT last); SR_IT consecutive positions a thread
  const int d = tid * SR_IT;
  unsigned heads = 0;
  if (d < pc.v) {
    int prev = d ? rk[pad_at(d - 1)] : 0;
#pragma unroll
    for (int j = 0; j < SR_IT; ++j) {
      const int x = d + j;
      if (x < pc.v) {
        const int k = rk[pad_at(x)];
        if (is_group(k)) {
          if (x == 0 || k != prev) heads |= 1u << j;
          if (x + 1 == pc.v || !is_group(rk[pad_at(x + 1)])) s_end = x + 1;
        }
        prev = k;
      }
    }
  }
  int ng;
  int r = cta_rank(__popc(heads), w_cnt, &ng);
  for (int j = 0; j < SR_IT; ++j)
    if ((heads >> j) & 1u) hp[r++] = d + j;
  if (tid == 0 && ng > 0) hp[ng] = s_end;
  __syncthreads();
  // one row a group: a thread reduces it, a warp if it is long
  for (int g = tid; g < ng; g += SR_THREADS) {
    const int e0 = hp[g], e1 = hp[g + 1];
    if (e1 - e0 > LONG_GROUP) {
      longs[atomicAdd(&s_nlong, 1)] = g;
      continue;
    }
    unsigned sum = 0;
    int mn = INT_MAX, mx = INT_MIN;
    for (int e = e0; e < e1; ++e) {
      const int x = rv[pad_at(e)];
      sum += (unsigned)x;
      mn = min(mn, x);
      mx = max(mx, x);
    }
    put_row(tmp, row0 + g, rk[pad_at(e0)], e1 - e0, sum, mn, mx);
  }
  __syncthreads();
  for (int i = warp; i < s_nlong; i += SR_WARPS) {
    const int g = longs[i];
    const int e0 = hp[g], e1 = hp[g + 1];
    unsigned sum = 0;
    int mn = INT_MAX, mx = INT_MIN;
    for (int e = e0 + lane; e < e1; e += 32) {
      const int x = rv[pad_at(e)];
      sum += (unsigned)x;
      mn = min(mn, x);
      mx = max(mx, x);
    }
    warp_reduce(sum, mn, mx);
    if (lane == 0)
      put_row(tmp, row0 + g, rk[pad_at(e0)], e1 - e0, sum, mn, mx);
  }
  return ng;
}

// Shared memory of pass 1: four buffers (the merge's ping-pong keys and
// values, or the direct table's four columns), the runs' piece bounds
// (lo, offsets), the merged sub-runs' offsets and the warps' counts.
inline long long agg_smem(int nbg) {
  return 4LL * (4 * SR_BUF + 3LL * nbg + 2 + SR_WARPS + 1);
}

__global__ void __launch_bounds__(SR_THREADS, SR_MIN_CTAS)
    k3agg_reduce_kernel(Runs runs, int f2, int cap2, int P, Rows tmp,
                        int* __restrict__ sub_rows, int* __restrict__ sub_at,
                        unsigned long long* __restrict__ halvings) {
  extern __shared__ int sm_agg[];
  const int nbg = runs.nbg;
  int* lo = sm_agg + 4 * SR_BUF;  // nbg
  int* off = lo + nbg;            // nbg + 1
  int* m_off = off + nbg + 1;     // nbg + 1: the merged sub-runs
  int* w_cnt = m_off + nbg + 1;   // SR_WARPS + 1
  // the loop's state, uniform over the CTA, in shared memory (as K3's):
  // the piece [s_ab[0], s_ab[1]), the right ends of the halves still to
  // do, their count (-1: done), the piece's smallest and largest key
  __shared__ long long s_ab[2];
  __shared__ long long s_stack[SR_STACK];
  __shared__ int s_kmin, s_kmax, s_top, s_rows, s_at, s_pmin, s_pmax;

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
    s_kmax = INT_MIN;
    s_top = 0;
    s_rows = 0;
    s_at = 0;
  }
  __syncthreads();
  for (int r = tid; r < nbg; r += SR_THREADS) {
    const size_t s = ((size_t)a * nbg + r) * f2 + b;
    const int c = runs.cnt[s];
    if (c > 0) {
      atomicMin(&s_kmin, runs.k[s * cap2]);
      atomicMax(&s_kmax, runs.k[s * cap2 + c - 1]);
    }
  }
  __syncthreads();
  if (s_kmin > s_kmax) {   // an empty region: no rows
    if (tid == 0) {
      sub_rows[blockIdx.x] = 0;
      sub_at[blockIdx.x] = 0;
    }
    return;
  }
  if (tid == 0) subrange_bounds(s_kmin, s_kmax, p, P, s_ab);
  __syncthreads();
  // run i's slot is at base + i * stride; offsets from it fit 32 bits (the
  // launcher checks nbg * f2 * cap2)
  const size_t base = slot_at(runs, a, 0, b, f2, cap2);
  const size_t block = (size_t)region * nbg * cap2;  // the region's rows
  bool first = true;   // the sub-range's first piece
  for (;;) {
    if (s_ab[0] < s_ab[1]) {
      piece_bounds(runs, nbg, a, b, f2, cap2, s_ab[0], s_ab[1], s_kmin,
                   s_kmax, lo, off);
      if (tid == 0) {
        s_pmin = INT_MAX;
        s_pmax = INT_MIN;
      }
      __syncthreads();
      if (warp == 0) {
        if (first) {   // the sub-range's element offset in its region
          unsigned t = 0;
          for (int i = lane; i < nbg; i += 32) t += lo[i];
          t = warp_sum(t);
          if (lane == 0) s_at = (int)t;
        }
        lengths_to_offsets(off, nbg, lane);
      }
      first = false;
      __syncthreads();
      const Piece pc{runs.k + base, runs.p + base, (unsigned)f2 * cap2, lo,
                     off, off[nbg]};
      if (pc.v > 0) {
        // the piece's smallest and largest key
        for (int i = tid; i < nbg; i += SR_THREADS) {
          const int len = off[i + 1] - off[i];
          if (len > 0) {
            const int* keys = pc.k + i * pc.stride + lo[i];
            atomicMin(&s_pmin, keys[0]);
            atomicMax(&s_pmax, keys[len - 1]);
          }
        }
        __syncthreads();
        const long long span = (long long)s_pmax - s_pmin + 1;
        const size_t row0 = block + s_at + s_rows;
        int ng;
        if (span <= AGG_TABLE) {
          ng = direct_piece(pc, s_pmin, (int)span, sm_agg, w_cnt, tmp,
                            row0);
        } else if (pc.v <= SR_RCAP) {
          ng = merge_piece(pc, nbg, sm_agg, m_off, w_cnt, tmp, row0);
        } else {
          // too many elements over too many keys: halve at the middle of
          // the keys it holds; the left half first, the right one waits
          if (tid == 0) {
            s_stack[s_top++] = s_ab[1];
            s_ab[1] = s_pmin + (span >> 1);
            atomicAdd(halvings, 1ull);
          }
          __syncthreads();
          continue;
        }
        if (tid == 0) s_rows += ng;
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
  if (tid == 0) {
    sub_rows[blockIdx.x] = s_rows;
    sub_at[blockIdx.x] = s_at;
  }
}

__global__ void __launch_bounds__(PLACE_THREADS) k3agg_place_kernel(
    Rows tmp, const int* __restrict__ sub_rows,
    const int* __restrict__ sub_at, int P, long long w, Rows out,
    int* __restrict__ counts) {
  __shared__ int s_before, s_total;
  const int tid = threadIdx.x;
  const int p = blockIdx.x % P;
  const int region = blockIdx.x / P;
  const int* rows = sub_rows + (size_t)region * P;
  if (tid < 32) {
    // the rows of the region's sub-ranges before p, and of all of them
    unsigned before = 0, total = 0;
    for (int i = tid; i < P; i += 32) {
      const unsigned n = rows[i];
      total += n;
      if (i < p) before += n;
    }
    before = warp_sum(before);
    total = warp_sum(total);
    if (tid == 0) {
      s_before = (int)before;
      s_total = (int)total;
    }
  }
  __syncthreads();
  const size_t blk = (size_t)region * w;
  const size_t from = blk + sub_at[blockIdx.x];
  const size_t to = blk + s_before;
  const int n = rows[p];
  // the fill of [total, w), split evenly among the region's P CTAs: 16
  // bytes a store between the first and last multiple of 4 (the columns
  // start 16-byte aligned)
  const long long total = s_total;
  const size_t f0 = blk + total + (w - total) * p / P;
  const size_t f1 = blk + total + (w - total) * (p + 1) / P;
  const size_t up = (f0 + 3) & ~(size_t)3, down = f1 & ~(size_t)3;
  const size_t v0 = up < f1 ? up : f1;
  const size_t v1 = down > v0 ? down : v0;
  for (int c = 0; c < NCOL; ++c) {   // a column at a time: its rows, fill
    int* o = out.col[c];
    const int* t = tmp.col[c];
    for (int i = tid; i < n; i += PLACE_THREADS) o[to + i] = t[from + i];
    const int f = c == 0 ? HOLE : 0;
    if (f0 + tid < v0) o[f0 + tid] = f;
    if (v1 + tid < f1) o[v1 + tid] = f;
    const int4 f4 = make_int4(f, f, f, f);
    for (size_t q = v0 + 4 * (size_t)tid; q < v1; q += 4 * PLACE_THREADS)
      *reinterpret_cast<int4*>(o + q) = f4;
  }
  if (p == 0 && tid == 0) counts[region] = (int)total;
}

bool aligned16(const int* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// k2/p2: (f1, nbg, f2, cap2) int32 fine slots, cnt2: (f1, nbg, f2), with P
// key sub-ranges a region -> okey/ocnt/osum/omin/omax: (f1 * f2, nbg *
// cap2) int32 region blocks (16-byte aligned), counts: (f1 * f2) int32;
// adds each halving of a piece to *halvings.  Scratch: tk/tc/ts/tmn/tmx of
// the blocks' shape, sub_rows/sub_at of f1 * f2 * P int32.
int aggpipe_k3agg(const int* k2, const int* p2, const int* cnt2, int f1,
                  int nbg, int f2, int cap2, int P, int* tk, int* tc,
                  int* ts, int* tmn, int* tmx, int* sub_rows, int* sub_at,
                  int* okey, int* ocnt, int* osum, int* omin, int* omax,
                  int* counts, unsigned long long* halvings, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (f1 < 1 || f2 < 1 || P < 1 || cap2 < 1 || nbg < 0 ||
      (long long)f1 * f2 * P > INT_MAX ||
      (long long)nbg * f2 * cap2 > INT_MAX || !aligned16(okey) ||
      !aligned16(ocnt) || !aligned16(osum) || !aligned16(omin) ||
      !aligned16(omax))
    return (int)cudaErrorInvalidValue;
  const Runs runs{k2, p2, cnt2, nbg};
  const Rows tmp{{tk, tc, ts, tmn, tmx}};
  const Rows out{{okey, ocnt, osum, omin, omax}};
  const unsigned grid = (unsigned)((long long)f1 * f2 * P);
  const int smem = (int)agg_smem(nbg);
  cudaError_t err = cudaFuncSetAttribute(
      k3agg_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  k3agg_reduce_kernel<<<grid, SR_THREADS, smem, st>>>(
      runs, f2, cap2, P, tmp, sub_rows, sub_at, halvings);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3agg_place_kernel<<<grid, PLACE_THREADS, 0, st>>>(
      tmp, sub_rows, sub_at, P, (long long)nbg * cap2, out, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
