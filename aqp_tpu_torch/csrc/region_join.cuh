// The region joins shared by rho3.cu (K3, K3M) and nphj.cu (K3TWO,
// K3TWO_MAT), on the sub-range parts of subrange.cuh.
//
// An S element (odd packed key k) matches when a TABLE run of its region
// holds k - 1, its R partner.  The first run (in index order) that holds
// the partner answers, and within it the lowest (key, payload) copy, so a
// duplicate R key still counts each S element once and the checksum is
// deterministic.  Matches and the checksum leave a CTA through integer
// atomicAdd; an unsigned 32-bit atomicAdd wraps mod 2^32, so the checksum
// is exact in any order.
//
// K3 and K3M probe and search the same array (RHO's union of R and S, R
// and S interleaved in each run: SAME).  K3TWO and K3TWO_MAT probe S's
// slots and search the table's, two arrays with their own run counts, so
// the persistent table is read where it lies.
//
// All four are subrange_join_kernel, one CTA per (region, key sub-range).
// A region at the headline holds ~22,800 R and ~91,000 S elements in 16
// (K3) or 4 + 16 (K3TWO) runs; the CTA owns a key sub-range of all of them
// (subrange.cuh: bounds at even keys, pieces, merge).
//   - R side.  The CTA reads its piece of every table run, run after run
//     as one virtual array cut into one stretch a warp (coalesced,
//     SR_ITEMS loads a lane in flight), keeps the even keys that differ
//     from their predecessor in the run (the first, lowest-payload copy of
//     each key) and compacts them into shared memory in run order: each
//     warp counts its kept keys (ballots), one scan gives the warps'
//     offsets, and each warp reads its stretch again, from L1, to place
//     them.  The runs' kept sub-runs are then merged (merge_runs), so equal
//     keys end in run order and a lower_bound finds the answering copy;
//     runs that kept nothing take no level.  Payloads ride along.
//   - Too many R.  A piece whose kept R exceed SR_RCAP is cut in two halves
//     at an even key; the CTA does the left one and keeps the right one on
//     a stack in shared memory (each halving counted in *halvings).  After
//     the per-run dedupe one key has at most nbg copies, so a piece of one
//     R key always fits (the launcher requires nbg <= SR_RCAP).
//   - S side.  A directory of the merged keys (the first key at or past
//     each of up to SR_DIR equal key buckets of the piece) goes into the
//     free buffer.  The CTA reads its piece of every probe run, coalesced,
//     and each S element binary-searches its partner among its bucket's
//     keys (about one).  K3 reads a run's piece three times, the two R
//     sweeps and the S pass (the last two from L1 or L2); K3TWO reads the
//     table's runs twice and S's once.
//   - MAT (K3M, K3TWO_MAT) writes three columns from the S pass: every
//     probe element of the piece writes its own output position once, a
//     matched S element (((k >> 1) * inv) mod 2^30, R payload, S payload),
//     every other element (-3, 0, 0), a piece that kept no R, or whose
//     table runs hold nothing in its range, included (a halved piece
//     writes once per half, after its last halving).  inv is the salt's
//     inverse mod 2^30, so the first column is the original key.  Probe
//     run j's slot position e of region (a, b) lies at a * sa + b * sb +
//     j * sj + e (MatOut): K2's layout for K3M, whose probe runs hold R
//     too; for K3TWO_MAT nphj's region chunks of w elements, S run j at
//     chunk + j * cap2, and `tail` more chunks of cap2 after the S runs.
//     The positions no element owns, [count, cap2) of each probe slot and
//     the tail's chunks, are holes split evenly among the region's P CTAs,
//     before an empty region's CTAs leave.  No staging buffer and no match
//     mask: the MAT kernels take what K3 and K3TWO take.

#pragma once

#include "subrange.cuh"

namespace {

constexpr int SR_DIR = 4096;   // directory buckets, <= SR_BUF - 1

// The MAT kernels' output columns (k null: no columns).  Probe run j's
// slot position e of region (a, b) is written at a * sa + b * sb + j * sj
// + e; `tail` chunks of cap2 holes follow the probe runs' (j = nbg, ...).
struct MatOut {
  int* k;
  int* rp;
  int* sp;
  int inv;   // the salt's inverse mod 2^30
  long long sa, sb, sj;
  int tail;
};

// Shared memory of the sub-range join: the ping-pong R buffers (keys, and
// payloads with PAY; the directory takes the free key buffer), the table
// runs' piece bounds (lo, offsets, kept rank at each run's start), the
// merged sub-runs' offsets, the probe runs' bounds (unless SAME) and the
// warps' counts.
inline long long subrange_smem(bool pay, bool same, int nt, int np) {
  return 4LL * ((pay ? 4 : 2) * SR_BUF + 4LL * nt + 2 +
                (same ? 0 : 2LL * np + 1) + SR_WARPS + 1);
}

template <bool PAY, bool SAME, bool MAT>
__global__ void __launch_bounds__(SR_THREADS, SR_MIN_CTAS)
    subrange_join_kernel(Runs probe, Runs table, int f2, int cap2, int P,
                         MatOut out,
                         unsigned long long* __restrict__ matches,
                         unsigned int* __restrict__ checksum,
                         unsigned long long* __restrict__ halvings) {
  static_assert(!MAT || PAY, "the MAT columns need the payloads");
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
  // MAT: where probe run j's slot position e of this region is written
  auto out_at = [&](unsigned j, unsigned e) {
    return (size_t)a * out.sa + (size_t)b * out.sb + j * (size_t)out.sj + e;
  };
  if constexpr (MAT) {
    // the holes no element owns, [count, cap2) of each probe slot and the
    // tail's chunks: this CTA writes its P-th share of each, a warp a slot
    for (int j = warp; j < np + out.tail; j += SR_WARPS) {
      const int c = j < np ? probe.cnt[((size_t)a * np + j) * f2 + b] : 0;
      const int e0 = c + (int)((long long)(cap2 - c) * p / P);
      const int e1 = c + (int)((long long)(cap2 - c) * (p + 1) / P);
      for (int e = e0 + lane; e < e1; e += 32) {
        const size_t o = out_at(j, e);
        out.k[o] = -3;
        out.rp[o] = 0;
        out.sp[o] = 0;
      }
    }
  }
  __syncthreads();
  if (s_kmax < 0) return;  // an empty region (the whole CTA leaves)
  if (tid == 0) {
    subrange_bounds(s_kmin, s_kmax, p, P, s_ab);
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
      // MAT: a piece whose table runs hold nothing still writes its S
      if (vp > 0 && (MAT || vt > 0)) {
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
        const int src = merge_runs<PAY>(sm_sub, m_off, s_runs, kept);
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
        // thread's positions rise, so its run only moves on.  MAT: every
        // element of the piece writes its own position, even where the
        // piece kept no R
        int run = 0;
        int r_off = 0, r_next = p_off[1], r_lo = p_lo[0];
        for (int c0 = 0; (MAT || kept > 0) && c0 < vp; c0 += SR_CHUNK) {
          int key[SR_ITEMS];
          // where each item lies: its element offset from p_base, or with
          // MAT its run and slot position, run << 16 | e (cap2 <= 2^15;
          // ~0: no element, nothing written)
          unsigned at[SR_ITEMS];
#pragma unroll
          for (int q = 0; q < SR_ITEMS; ++q) {
            const int x = c0 + q * SR_THREADS + tid;
            key[q] = 0;   // even: never looked up, never written
            at[q] = MAT ? ~0u : 0u;
            if (x < vp) {
              while (x >= r_next) {
                ++run;
                r_off = r_next;
                r_next = p_off[run + 1];
                r_lo = p_lo[run];
              }
              const unsigned e = r_lo + x - r_off;
              key[q] = __ldg(probe.k + p_base + run * run_stride + e);
              at[q] = MAT ? (unsigned)run << 16 | e : run * run_stride + e;
            }
          }
#pragma unroll
          for (int q = 0; q < SR_ITEMS; ++q) {
            // MAT: what item q writes, a hole unless it matches
            int w_k = -3, w_rp = 0, w_sp = 0;
            if ((key[q] & 1) && (!MAT || kept > 0)) {
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
                if (PAY) {
                  const unsigned in_at =
                      MAT ? (at[q] >> 16) * run_stride + (at[q] & 0xFFFFu)
                          : at[q];
                  const int r_pay = rp[pad_at(lo)];
                  const int s_pay = __ldg(probe.p + p_base + in_at);
                  my_c += (unsigned)r_pay + (unsigned)s_pay;
                  w_k = (int)(((unsigned)(key[q] >> 1) * (unsigned)out.inv) &
                              0x3FFFFFFFu);
                  w_rp = r_pay;
                  w_sp = s_pay;
                }
              }
            }
            if (MAT && at[q] != ~0u) {
              const size_t o = out_at(at[q] >> 16, at[q] & 0xFFFFu);
              out.k[o] = w_k;
              out.rp[o] = w_rp;
              out.sp[o] = w_sp;
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

// Largest fine-slot capacity the region joins take: the MAT S pass keeps
// an element's slot position in the low 16 bits of one word, beside its
// run (K3 and K3TWO are held to the same limit).
constexpr int SR_MAX_CAP = 1 << 15;

// K3 (SAME: probe and table are one array) or K3TWO: P key sub-ranges a
// region; payloads on both sides or neither.  MAT (K3M, K3TWO_MAT; with
// payloads): and the columns of `out`, every position written.
template <bool SAME, bool MAT = false>
cudaError_t launch_subrange_join(Runs probe, Runs table, int f1, int f2,
                                 int cap2, int P,
                                 unsigned long long* matches,
                                 unsigned int* checksum,
                                 unsigned long long* halvings,
                                 cudaStream_t st, MatOut out = MatOut{}) {
  const bool pay = table.p != nullptr;
  if ((probe.p == nullptr) == pay || f1 < 1 || f2 < 1 || P < 1 || cap2 < 1 ||
      cap2 > SR_MAX_CAP || table.nbg < 0 || table.nbg > SR_RCAP ||
      probe.nbg < 0 || (long long)f1 * f2 * P > INT_MAX ||
      (long long)table.nbg * f2 * cap2 > INT_MAX ||
      (long long)probe.nbg * f2 * cap2 > INT_MAX ||
      (MAT && (!pay || out.k == nullptr || out.rp == nullptr ||
               out.sp == nullptr || probe.nbg > 0xFFFF || out.tail < 0)))
    return cudaErrorInvalidValue;
  const long long grid = (long long)f1 * f2 * P;
  // without S or a table nothing matches; the MAT columns still hold holes
  if (MAT ? probe.nbg + out.tail == 0 : table.nbg == 0 || probe.nbg == 0)
    return cudaSuccess;
  const int smem = (int)subrange_smem(pay, SAME, table.nbg, probe.nbg);
  cudaError_t err;
#define RJ_SUB(PAY)                                                        \
  err = cudaFuncSetAttribute(subrange_join_kernel<PAY, SAME, MAT>,         \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                             smem);                                        \
  if (err != cudaSuccess) return err;                                      \
  subrange_join_kernel<PAY, SAME, MAT>                                     \
      <<<(unsigned)grid, SR_THREADS, smem, st>>>(                          \
          probe, table, f2, cap2, P, out, matches, checksum, halvings)
  if constexpr (MAT) {
    RJ_SUB(true);
  } else if (pay) {
    RJ_SUB(true);
  } else {
    RJ_SUB(false);
  }
#undef RJ_SUB
  return cudaGetLastError();
}

}  // namespace
