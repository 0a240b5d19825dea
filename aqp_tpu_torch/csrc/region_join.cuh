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
// and S interleaved in each run).  K3TWO and K3TWO_MAT probe S's slots and
// search the table's, two arrays with their own run counts, so the
// persistent table is read where it lies.
//
// K3, K3M and K3TWO: subrange_join_kernel, one CTA per (region, key
//   sub-range).  A region at the headline holds ~22,800 R and ~91,000 S
//   elements in 16 runs; the CTA owns a key sub-range of all of them
//   (subrange.cuh: bounds at even keys, pieces, merge).
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
//   - K3M (MAT) writes its columns from the S pass: the output has K2's
//     layout, so every element of the piece, R or S, writes its own
//     position once: a matched S element (((k >> 1) * inv) mod 2^30, R
//     payload, S payload), every other element (-3, 0, 0), a piece that
//     kept no R included (a halved piece writes once per half, after its
//     last halving).  The positions no element owns, [count, cap2) of each
//     slot, are holes split evenly among the region's P CTAs, an empty
//     region's too.  inv is the salt's inverse mod 2^30, so the first
//     column is the original key.  No staging buffer and no match mask:
//     K3M takes what K3 takes.
//
// K3TWO_MAT: region_join_mat_kernel, one CTA per (region, probe run j): it
//   stages its probe slot in shared memory, stages each table run of the
//   region in turn, and each still unmatched S element binary-searches it.
//   The CTA of (region, j) owns the output positions of its slot (a * sa +
//   b * sb + j * sj, + cap2): a matched S element writes as K3M's, every
//   other position gets (-3, 0, 0).  `tail` more chunks of cap2 per region,
//   after the probe runs' slots, are holes too; the CTA of run j writes the
//   chunks j, j + nbg, ... of them.

#pragma once

#include "subrange.cuh"

namespace {

constexpr int SR_DIR = 4096;   // directory buckets, <= SR_BUF - 1

// K3M's output columns, at K2's layout (k null: no columns)
struct MatOut {
  int* k;
  int* rp;
  int* sp;
  int inv;   // the salt's inverse mod 2^30
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
  static_assert(!MAT || (PAY && SAME), "K3M: one array, with payloads");
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
  if constexpr (MAT) {
    // the holes no element owns, [count, cap2) of each slot: this CTA
    // writes its P-th share of each slot's, a warp a slot
    for (int j = warp; j < nt; j += SR_WARPS) {
      const size_t s = ((size_t)a * nt + j) * f2 + b;
      const int c = table.cnt[s];
      const int e0 = c + (int)((long long)(cap2 - c) * p / P);
      const int e1 = c + (int)((long long)(cap2 - c) * (p + 1) / P);
      for (int e = e0 + lane; e < e1; e += 32) {
        out.k[s * cap2 + e] = -3;
        out.rp[s * cap2 + e] = 0;
        out.sp[s * cap2 + e] = 0;
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
        // thread's positions rise, so its run only moves on.  K3M: every
        // element of the piece writes its own position, R or S, even where
        // the piece kept no R
        int run = 0;
        int r_off = 0, r_next = p_off[1], r_lo = p_lo[0];
        for (int c0 = 0; (MAT || kept > 0) && c0 < vp; c0 += SR_CHUNK) {
          int key[SR_ITEMS];
          unsigned at[SR_ITEMS];   // element offsets from p_base
          unsigned hole = 0;       // K3M: bit q, item q writes a hole
#pragma unroll
          for (int q = 0; q < SR_ITEMS; ++q) {
            const int x = c0 + q * SR_THREADS + tid;
            key[q] = 0;   // even: never looked up, never written
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
              if (MAT) hole |= 1u << q;
            }
          }
#pragma unroll
          for (int q = 0; q < SR_ITEMS; ++q) {
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
                  const int r_pay = rp[pad_at(lo)];
                  const int s_pay = __ldg(probe.p + p_base + at[q]);
                  my_c += (unsigned)r_pay + (unsigned)s_pay;
                  if constexpr (MAT) {
                    const size_t o = p_base + at[q];
                    out.k[o] = (int)(((unsigned)(key[q] >> 1) *
                                      (unsigned)out.inv) & 0x3FFFFFFFu);
                    out.rp[o] = r_pay;
                    out.sp[o] = s_pay;
                    hole &= ~(1u << q);
                  }
                }
              }
            }
            if (MAT && ((hole >> q) & 1u)) {
              const size_t o = p_base + at[q];
              out.k[o] = -3;
              out.rp[o] = 0;
              out.sp[o] = 0;
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

// Largest fine-slot capacity the region joins take (K3TWO_MAT's per-thread
// match mask: RJ_THREADS * RJ_MAX_PER_THREAD).
constexpr int RJ_THREADS = 512;
constexpr int RJ_MAX_PER_THREAD = 64;
constexpr int RJ_MAX_CAP = RJ_THREADS * RJ_MAX_PER_THREAD;

// K3 (SAME: probe and table are one array) or K3TWO: P key sub-ranges a
// region; payloads on both sides or neither.  MAT (K3M, SAME with
// payloads): and the columns of `out`, every position written.
template <bool SAME, bool MAT = false>
cudaError_t launch_subrange_join(Runs probe, Runs table, int f1, int f2,
                                 int cap2, int P,
                                 unsigned long long* matches,
                                 unsigned int* checksum,
                                 unsigned long long* halvings,
                                 cudaStream_t st, MatOut out = MatOut{}) {
  static_assert(!MAT || SAME, "K3M probes its own runs");
  const bool pay = table.p != nullptr;
  if ((probe.p == nullptr) == pay || f1 < 1 || f2 < 1 || P < 1 || cap2 < 1 ||
      cap2 > RJ_MAX_CAP || table.nbg < 0 || table.nbg > SR_RCAP ||
      probe.nbg < 0 || (long long)f1 * f2 * P > INT_MAX ||
      (long long)table.nbg * f2 * cap2 > INT_MAX ||
      (long long)probe.nbg * f2 * cap2 > INT_MAX ||
      (MAT && (!pay || out.k == nullptr || out.rp == nullptr ||
               out.sp == nullptr)))
    return cudaErrorInvalidValue;
  const long long grid = (long long)f1 * f2 * P;
  if (table.nbg == 0 || probe.nbg == 0) return cudaSuccess;
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

// ---------------------------------------------------------------------------
// K3TWO_MAT: one CTA per (region, probe run)

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

// Shared memory K3TWO_MAT's region join needs for a fine-slot capacity of
// cap2.
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
