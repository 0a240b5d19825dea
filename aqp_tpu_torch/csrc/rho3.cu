// Hopper kernels of the fixed-slot two-level RHO count join.
//
// They replace the four Pallas kernels of aqp_tpu/ops/pallas/rho3.py that
// the count and materialize paths run.  Each kernel computes what its Pallas
// counterpart computes, with a layout chosen for an SM instead of a TPU
// core:
//
//   K1  replaces _make_k1 (rho3.py:212), launched by route_2level
//       (rho3.py:471).  Routes each block of block_rows*128 packed keys into
//       one fixed slot per level-1 bucket (f1 of them) and counts overflow.
//   K2  replaces _make_k2 (rho3.py:250), launched at rho3.py:500.  Routes
//       the bucket-f slots of `group` consecutive blocks (one window) into
//       f2 fine slots and counts overflow.
//   K3  replaces _make_k3 (rho3.py:300), launched by rho_join_count_v3
//       (rho3.py:558).  For each region (f1 bucket, f2 bucket), counts the
//       S elements whose key has an R element, and sums r_pay + s_pay
//       mod 2^32 over them.
//   K3M replaces _make_k3m (rho3.py:343), launched by
//       rho_join_materialize_v3 (rho3.py:597).  K3, and every matched S
//       element also writes (original key, R payload, S payload) at its own
//       position in K2's layout; every other position gets (-3, 0, 0).
//
// Slot semantics.  A slot holds its real elements first, sorted by (key,
// payload as unsigned), then KEY_PAD_INT with payload 0 up to its capacity;
// the slot's count says how many are real.  Capacity is counted in
// elements (slot_rows*128), where the Pallas extraction counts rows of the
// sorted block, so it is never smaller: wherever the TPU pipeline reports
// no overflow, this one reports none either.  Overflow is the number of
// elements that did not fit.  A K1 slot that overflows keeps the elements
// its scatter placed first (an order of atomics); a K2 fine slot keeps the
// first cap2 values of its sorted window, as the plain version does.
//
// Design.  A K1 block at the default geometry is 131,072 keys (512 KB,
// 1 MB with payloads): it does not fit the 227 KB of shared memory a CTA
// can have.  So the TPU's "sort the whole block, then cut slots out of it"
// becomes "bucket, then sort each slot"; and K2, whose window is 32 sorted
// K1 slots, merges them instead of sorting again.
//   K1 = k1_scatter_kernel + k1_sort_kernel.
//     scatter  one CTA per chunk of 8,192 keys (16 chunks a default block,
//              8,192 CTAs at the headline).  Each key takes its rank in its
//              level-1 bucket from one shared counter a bucket, the CTA
//              stages the chunk by bucket in shared memory, reserves each
//              bucket's run in its slot with one device atomicAdd on the
//              slot's count, and writes each run out as contiguous stores.
//              Which chunk lands first in a slot is left to the atomics:
//              the sort that follows makes the slot's order.
//     sort     one CTA per slot, 16 values a thread (8 warps up to cap1 =
//              4,096; 16 warps up to 8,192, the most K1 takes).  An LSD radix sort
//              in shared memory over 8-bit digits of (key - the slot's
//              smallest key): a default slot's
//              keys span 2^31 / f1 packed values, 26 bits, so 4 passes.  A
//              pass ranks each value among its warp's by digit (the lanes
//              that share a digit set their bits in a per-warp mask word;
//              one counter per (digit, warp)), scans the counters and
//              scatters every value once into the exchange buffer.  Keys
//              only sort 32-bit values.  With payloads the slot sorts the
//              key digits of the 64-bit (key, payload) value, then orders
//              each run of equal keys by payload in place: a value counts
//              the run's smaller values (runs of at most RUN_MAX = 32).
//              A slot with a longer run (the Zipf tail, the aggregate's
//              groups) keeps its runs where they stand and sorts (run
//              index, payload) instead: 32 + log2(runs) bits, at most 6
//              passes at cap1 = 4,096 (all keys equal: 4).
//   K2 = k2_merge_kernel, one CTA per fine slot (f, g, j), 16 values a
//              thread (8 warps up to cap2 = 4,096, 16 up to 8,192, 32 up to
//              16,384; at 16,384, 16 warps of 32 values took 1.3x the time
//              on the z = 1.5 residual).  A level-1 slot is f2
//              sub-runs in fine-bucket order (fine_bucket is monotone in
//              the packed key), so the fine slot's values are the window's
//              `group` sub-runs of bucket j, each sorted.  One thread per
//              (K1 slot, end) binary-searches the sub-run's bound in device
//              memory with fine_bucket; the CTA stages the sub-runs one
//              after another in shared memory (a warp a sub-run,
//              coalesced) and merges them pairwise, log2(group) merge-path
//              levels (5 at the default group of 32), ties to the left
//              run, each thread merging 16 outputs (keys-only in registers;
//              with payloads it keeps each output's 16-bit place, then
//              gathers the values).  A fine slot whose window holds more
//              than cap2 values (K2's own overflow) merges its sub-runs one
//              at a time into the first cap2 values, the incoming sub-run
//              read from device memory, so it keeps exactly the plain
//              version's values.
//   K3  = subrange_join_kernel (region_join.cuh, shared with nphj.cu's
//         K3TWO): one CTA per (region, key sub-range), P sub-ranges a
//         region cut at even packed keys.  The CTA reads its sub-range of
//         every run (R and S interleaved), keeps the first copy of each R
//         key a run, merges the runs' R in run order in shared memory, then
//         reads the sub-range again and each S element binary-searches the
//         merged R for its partner (packed key - 1).
//   K3M = subrange_join_kernel with MAT (region_join.cuh): K3's CTAs, and
//         the S pass writes every element's own output position (a matched
//         S element its row, any other element a hole); the CTAs of a
//         region split the holes past each slot's count.
//
// Numerics.  Build without --use_fast_math.  fine_bucket() must reproduce
// the float32 rounding of rho3._fine_bucket bit for bit: int -> float
// rounds to nearest (__int2float_rn), the product rounds to nearest
// (__fmul_rn, which also keeps the compiler from contracting it into an
// FMA), and the conversion back truncates (__float2int_rz).
//
// Registers.  __launch_bounds__ holds the sort to 64 registers a thread
// keys-only and 80 with payloads, and the merge to 64 (4 and 3 CTAs an SM
// for the sort's 256 threads, 2 for the merge's 512, 1 for its 1,024):
// more CTAs an SM hide
// the shared-memory latency of the passes and the device-memory latency of
// the merge's searches.  Left to itself, ptxas gave the merge with
// payloads 106 registers, 1 CTA an SM, and 1.7x the time of 2.
//
// Bounds at the headline size (13,107,200 R + 52,428,800 S keys, default
// Rho3Params: nb = 512 blocks, f1 = 36, f2 = 16, nbg = 16; H100 HBM
// 3.35 TB/s), counting each input byte read once and each output byte
// written once:
//   K1  keys-only reads 262 MB of keys and writes the 302 MB slot array:
//       >= 0.17 ms (twice that with payloads).  The scatter reads each key
//       once and writes it once, the sort reads each real value once and
//       writes the whole slot: 1.9x the bound's bytes.  Shared memory: the
//       scatter 41 KB a CTA (75 KB with payloads), the sort 34 KB (50 KB).
//   K2  reads the 262 MB of real slot elements (the counts say where they
//       end, padding is never read) and writes the 302 MB fine-slot array:
//       >= 0.17 ms keys-only.  The merge moves the bound's bytes, plus the
//       searches' few sectors a sub-run.  Shared memory: 35 KB a CTA
//       (70 KB with payloads; 139 KB at cap2 = 16,384 with payloads).
//   K3  reads the 262 MB of real fine-slot elements: >= 0.08 ms keys-only.
//       Each CTA reads its sub-range of each run twice (R pass, then S
//       pass, the second from L2) plus 2 x nbg bound searches; the merge
//       and the binary searches run in shared memory.
//   K3M reads the real fine-slot elements with payloads (524 MB) and writes
//       three columns of the fine-slot array's length (3 x 302 MB): >=
//       0.43 ms.  It reads what K3 reads; each output position is written
//       once, the holes included, coalesced, so no pre-fill pass is needed.
// PERF.md has the measured times.

#include <cuda_runtime.h>

#include "region_join.cuh"

namespace {

typedef unsigned long long u64;

constexpr int KEY_PAD_INT = 2147483647;
constexpr int MAX_F = 128;            // f1 and f2 stay below it

// K1's scatter: a CTA's chunk of keys
constexpr int SC_THREADS = 512;
constexpr int SC_ITEMS = 16;
constexpr int SC_WARP_SPAN = 32 * SC_ITEMS;
constexpr int CHUNK = SC_THREADS * SC_ITEMS;

// K1's slot sort and K2's merge: a CTA of (warps, values a thread)
constexpr int ITEMS = 16;
constexpr int SHAPES[3][2] = {{8, ITEMS}, {16, ITEMS}, {32, ITEMS}};
constexpr int K1_MAX_CAP = 16 * 32 * ITEMS;   // 8,192 values
constexpr int K2_MAX_CAP = 32 * 32 * ITEMS;   // 16,384 values
// Registers a thread is held to, through the CTAs an SM must fit
// (__launch_bounds__): more CTAs an SM hide the sorts' shared-memory
// latency and K2's searches in device memory.
constexpr int min_ctas(int threads, int regs) {
  return 65536 / (threads * regs) > 1 ? 65536 / (threads * regs) : 1;
}
constexpr int SORT_REGS_KEYS = 64;
constexpr int SORT_REGS_PAY = 80;
constexpr int MERGE_REGS = 64;
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int RUN_MAX = 32;               // longest run of equal keys ordered
                                          // by payload in place
constexpr int MAX_GROUP = 1024;           // K1 slots a K2 window merges

// Global fine bucket in [0, gmax) of a real packed key, gmax for a high pad,
// -1 for a low pad (rho3._fine_bucket).
__device__ __forceinline__ int fine_bucket(int packed, float scale, int gmax) {
  if (packed < 0) return -1;
  if (packed >= KEY_PAD_INT) return gmax;
  const int sig = packed >> 1;
  int g = __float2int_rz(__fmul_rn(__int2float_rn(sig), scale));
  g = min(g, gmax - 1);
  return max(g, 0);
}

// (key signed, payload unsigned) order as one unsigned 64-bit key.
__device__ __forceinline__ u64 pack64(int key, int pay) {
  return ((u64)((unsigned)key ^ 0x80000000u) << 32) | (unsigned)pay;
}
__device__ __forceinline__ int key_of(u64 v) {
  return (int)((unsigned)(v >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int pay_of(u64 v) { return (int)(unsigned)v; }

// A slot's value: the packed key as unsigned (real keys are >= 0, so the
// order is the same), or the 64-bit (key, payload) value.
template <bool PAY>
struct Val {
  typedef unsigned T;
};
template <>
struct Val<true> {
  typedef u64 T;
};

template <bool PAY>
__device__ __forceinline__ typename Val<PAY>::T load_val(
    const int* __restrict__ k, const int* __restrict__ p, size_t i) {
  if constexpr (PAY)
    return pack64(k[i], p[i]);
  else
    return (unsigned)k[i];
}

template <bool PAY>
__device__ __forceinline__ void store_val(int* __restrict__ k,
                                          int* __restrict__ p, size_t i,
                                          typename Val<PAY>::T v) {
  if constexpr (PAY) {
    k[i] = key_of(v);
    p[i] = pay_of(v);
  } else {
    k[i] = (int)v;
  }
}

template <typename T>
__device__ __forceinline__ T warp_min(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
template <typename T>
__device__ __forceinline__ T warp_max(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ int bit_len(u64 x) {
  return x ? 64 - __clzll((long long)x) : 0;
}

// ---------------------------------------------------------------------------
// K1

// First launch: one CTA per chunk of CHUNK keys of a block (a block is
// `chunks` chunks, the last one cut at the block's end).  fill[nb][f1]
// (zeroed before) counts the keys each slot was sent, overflow included.
template <bool PAY>
__global__ void __launch_bounds__(SC_THREADS) k1_scatter_kernel(
    const int* __restrict__ keys, const int* __restrict__ pay, long long n,
    int block_elems, int chunks, int f1, int f2, float scale, int cap1,
    int* __restrict__ out_k, int* __restrict__ out_p,
    int* __restrict__ fill) {
  extern __shared__ int sm_scatter[];
  int* s_cnt = sm_scatter;          // the chunk's keys a bucket
  int* s_off = s_cnt + MAX_F;       // a bucket's run in the stage
  int* s_dst = s_off + MAX_F;       // a bucket's run in its slot
  int* s_k = s_dst + MAX_F;         // the chunk by bucket
  int* s_p = s_k + CHUNK;           // (PAY) its payloads
  unsigned char* s_b =
      reinterpret_cast<unsigned char*>(s_p + (PAY ? CHUNK : 0));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int blk = blockIdx.x / chunks;
  const long long c0 = (long long)(blockIdx.x % chunks) * CHUNK;
  const long long base = (long long)blk * block_elems + c0;
  const long long lim =
      min(min((long long)CHUNK, (long long)block_elems - c0), n - base);
  const int gmax = f1 * f2;
  for (int f = threadIdx.x; f < MAX_F; f += SC_THREADS) s_cnt[f] = 0;
  __syncthreads();

  // each key's rank among the chunk's keys of its bucket, from one shared
  // counter a bucket (a warp's 32 keys hit about 20 buckets, so an atomic
  // waits for few others; ranking by __match_any_sync first was slower)
  int kv[SC_ITEMS], pv[SC_ITEMS];
  unsigned meta[SC_ITEMS];          // rank << 8 | bucket; 0xFF: not routed
#pragma unroll
  for (int i = 0; i < SC_ITEMS; ++i) {
    const int e = warp * SC_WARP_SPAN + i * 32 + lane;
    int f = -1;
    kv[i] = 0;
    pv[i] = 0;
    if (e < lim) {
      kv[i] = keys[base + e];
      if (PAY) pv[i] = pay[base + e];
      const int g = fine_bucket(kv[i], scale, gmax);
      if (g >= 0 && g < gmax) f = g / f2;   // pads are dropped
    }
    const int r = f >= 0 ? atomicAdd(&s_cnt[f], 1) : 0;
    meta[i] = f >= 0 ? ((unsigned)r << 8) | (unsigned)f : 0xFFu;
  }
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the counts, MAX_F / 32 a lane
    int c[MAX_F / 32];
    unsigned sum = 0;
#pragma unroll
    for (int q = 0; q < MAX_F / 32; ++q) {
      c[q] = s_cnt[lane * (MAX_F / 32) + q];
      sum += c[q];
    }
    unsigned run = warp_incl_scan(sum, lane) - sum;
#pragma unroll
    for (int q = 0; q < MAX_F / 32; ++q) {
      s_off[lane * (MAX_F / 32) + q] = run;
      run += c[q];
    }
  }
  for (int f = threadIdx.x; f < f1; f += SC_THREADS) {
    const int c = s_cnt[f];
    s_dst[f] = c ? atomicAdd(&fill[(size_t)blk * f1 + f], c) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < SC_ITEMS; ++i) {
    const unsigned m = meta[i];
    if ((m & 0xFF) != 0xFF) {
      const int f = m & 0xFF;
      const int at = s_off[f] + (int)(m >> 8);
      s_k[at] = kv[i];
      if (PAY) s_p[at] = pv[i];
      s_b[at] = (unsigned char)f;
    }
  }
  __syncthreads();
  // each bucket's run leaves as contiguous stores
  const int total = s_off[MAX_F - 1] + s_cnt[MAX_F - 1];
  for (int x = threadIdx.x; x < total; x += SC_THREADS) {
    const int f = s_b[x];
    const int dst = s_dst[f] + x - s_off[f];
    if (dst < cap1) {
      const size_t o = ((size_t)blk * f1 + f) * cap1 + dst;
      out_k[o] = s_k[x];
      if (PAY) out_p[o] = s_p[x];
    }
  }
}

// The radix digit of x: bits [shift, shift + RADIX_BITS) of (x >> hs) -
// base, base the smallest (x >> hs) of the slot.
template <typename T>
__device__ __forceinline__ unsigned digit_of(T x, int hs, T base,
                                             int shift) {
  return (unsigned)((((x >> hs) - base) >> shift) & (RADIX - 1));
}

// Replace the counters c(d, w) (digit-major, pitch WARPS + 1) by their
// exclusive prefix sums: c(d, w) becomes the number of the slot's values
// with a smaller digit, plus those with digit d in warps before w.
template <int WARPS>
__device__ __forceinline__ void scan_counters(unsigned* hist, unsigned* wsum,
                                              int lane, int warp) {
  constexpr int EPT = RADIX / 32;         // counters a thread
  constexpr int PITCH = WARPS + 1;
  const int e0 = threadIdx.x * EPT;
  unsigned c[EPT];
  unsigned sum = 0;
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = e0 + q;
    c[q] = hist[(e / WARPS) * PITCH + e % WARPS];
    sum += c[q];
  }
  const unsigned incl = warp_incl_scan(sum, lane);
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  const unsigned w = lane < WARPS ? wsum[lane] : 0;
  const unsigned w_excl = warp_incl_scan(w, lane) - w;
  unsigned run = __shfl_sync(FULL, w_excl, warp) + incl - sum;
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = e0 + q;
    hist[(e / WARPS) * PITCH + e % WARPS] = run;
    run += c[q];
  }
}

// Shared memory of a slot sort.  A pass's parameters are kept here too:
// the scatter reads them back after the scan's barriers, so the compiler
// recomputes each value's digit there instead of keeping the ranking's
// counter addresses live (which spills).
template <typename T>
struct SortSmem {
  T* exch;            // WARPS * 32 * IT values
  unsigned* hist;     // RADIX x (WARPS + 1) counters
  unsigned* mask;     // this warp's RADIX match masks
  unsigned* wsum;     // a warp's total
  T* base;            // the pass's digit base, shift and hs
  int* shift;
  int* hs;
};

// One stable LSD pass over the slot's first n values (v: this thread's IT,
// warp-striped: warp w's lane l holds positions w * 32 * IT + i * 32 + l)
// on one digit.  v comes back in position order, and exch holds the slot.
template <typename T, int WARPS, int IT>
__device__ __forceinline__ void radix_pass(T (&v)[IT], int n, int hs,
                                           T base, int shift,
                                           const SortSmem<T>& sm, int lane,
                                           int warp) {
  constexpr int PITCH = WARPS + 1;
  const int wpos = warp * 32 * IT;
  const unsigned below_me = (1u << lane) - 1;
  for (int d = lane; d < RADIX; d += 32) sm.hist[d * PITCH + warp] = 0;
  if (threadIdx.x == 0) {
    *sm.base = base;
    *sm.shift = shift;
    *sm.hs = hs;
  }
  __syncwarp();
  // rank of each value among the warp's values of its digit, in position
  // order; two 16-bit ranks a register
  unsigned rank[IT / 2];
#pragma unroll
  for (int q = 0; q < IT / 2; ++q) rank[q] = 0;
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    if (wpos + i * 32 >= n) continue;     // the whole warp: past the slot
    const bool act = wpos + i * 32 + lane < n;
    const unsigned dig = digit_of(v[i], hs, base, shift);
    // the lanes that share the digit each set their bit in the digit's
    // mask; the lowest of them (the leader) clears it again
    if (act) atomicOr(sm.mask + dig, 1u << lane);
    __syncwarp();
    unsigned peers = 0, cnt = 0;
    unsigned* c = sm.hist + dig * PITCH + warp;
    if (act) {
      peers = sm.mask[dig];
      cnt = *c;
    }
    __syncwarp();
    const unsigned below = peers & below_me;
    if (act && below == 0) {
      *c = cnt + __popc(peers);
      sm.mask[dig] = 0;
    }
    __syncwarp();
    const unsigned r = cnt + __popc(below);
    rank[i / 2] |= r << (16 * (i & 1));
  }
  __syncthreads();
  scan_counters<WARPS>(sm.hist, sm.wsum, lane, warp);
  __syncthreads();
  const T b = *sm.base;
  const int sh = *sm.shift;
  const int h = *sm.hs;
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    if (wpos + i * 32 + lane < n) {
      const unsigned dig = digit_of(v[i], h, b, sh);
      const unsigned r = (rank[i / 2] >> (16 * (i & 1))) & 0xFFFF;
      sm.exch[sm.hist[dig * PITCH + warp] + r] = v[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < IT; ++i)
    if (wpos + i * 32 + lane < n) v[i] = sm.exch[wpos + i * 32 + lane];
  // the next pass writes the exchange buffer and its parameters only after
  // its own barriers
}

// LSD passes over every digit of (v >> hs) - base below `bits`.
template <typename T, int WARPS, int IT>
__device__ __forceinline__ void radix_sort(T (&v)[IT], int n, int hs,
                                           T base, int bits,
                                           const SortSmem<T>& sm, int lane,
                                           int warp) {
#pragma unroll 1
  for (int s = 0; s < bits; s += RADIX_BITS)
    radix_pass<T, WARPS, IT>(v, n, hs, base, s, sm, lane, warp);
}

// The run of equal keys around position pos of the sorted slot exch[0, n),
// looked for at most RUN_MAX values each way: [s, e).  Returns false when
// the run is longer than RUN_MAX.
__device__ __forceinline__ bool key_run(const u64* exch, int n, int pos,
                                        int& s, int& e) {
  const unsigned key = (unsigned)(exch[pos] >> 32);
  s = pos;
  while (s > 0 && pos - s < RUN_MAX && (unsigned)(exch[s - 1] >> 32) == key)
    --s;
  e = pos + 1;
  while (e < n && e - s <= RUN_MAX && (unsigned)(exch[e] >> 32) == key) ++e;
  return e - s <= RUN_MAX &&
         !(s > 0 && (unsigned)(exch[s - 1] >> 32) == key);
}

// Second launch: one CTA per slot of capacity cap <= WARPS * 32 * IT.
// Reads the slot's count as the scatter left it (keys sent, overflow
// included), sorts the slot's real values, writes them back with pads
// behind, the count cut to cap, and adds the overflow to *ovf.
template <bool PAY, int WARPS, int IT>
__global__ void __launch_bounds__(
    WARPS * 32, min_ctas(WARPS * 32, PAY ? SORT_REGS_PAY : SORT_REGS_KEYS))
    k1_sort_kernel(
    int* __restrict__ k, int* __restrict__ p, int* __restrict__ cnt, int cap,
    u64* __restrict__ ovf) {
  typedef typename Val<PAY>::T T;
  constexpr int THREADS = WARPS * 32;
  constexpr int PITCH = WARPS + 1;
  extern __shared__ u64 sm_sort[];
  __shared__ T s_lo[WARPS], s_hi[WARPS], s_base;
  __shared__ unsigned s_wsum[32];
  __shared__ int s_shift, s_hs;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* exch = reinterpret_cast<T*>(sm_sort);
  unsigned* hist = reinterpret_cast<unsigned*>(exch + THREADS * IT);
  const SortSmem<T> sm{exch, hist, hist + RADIX * PITCH + warp * RADIX,
                       s_wsum, &s_base, &s_shift, &s_hs};
  const size_t off = (size_t)blockIdx.x * cap;
  const int c = cnt[blockIdx.x];
  const int n = min(c, cap);
  const int pos0 = warp * 32 * IT + lane;
  T v[IT];
  T lo = ~T(0), hi = 0;
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    v[i] = 0;
    if (pos0 + i * 32 < n) {
      v[i] = load_val<PAY>(k, p, off + pos0 + i * 32);
      lo = min(lo, v[i]);
      hi = max(hi, v[i]);
    }
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  for (int d = lane; d < RADIX; d += 32) sm.mask[d] = 0;
  __syncthreads();
  // (every thread has read its values: the count and the pads may go out)
  if (threadIdx.x == 0) {
    cnt[blockIdx.x] = n;
    if (c > cap) atomicAdd(ovf, (u64)(c - cap));
  }
  for (int x = n + threadIdx.x; x < cap; x += THREADS) {
    k[off + x] = KEY_PAD_INT;
    if (PAY) p[off + x] = 0;
  }
  if (n == 0) return;
#pragma unroll 1
  for (int w = 0; w < WARPS; ++w) {
    lo = min(lo, s_lo[w]);
    hi = max(hi, s_hi[w]);
  }
  // keys-only: every varying bit of the key; with payloads: the key's
  const int hs = PAY ? 32 : 0;
  const int key_bits = bit_len((u64)((hi >> hs) - (lo >> hs)));
  radix_sort<T, WARPS, IT>(v, n, hs, lo >> hs, key_bits, sm, lane, warp);
  if constexpr (!PAY) {
#pragma unroll
    for (int i = 0; i < IT; ++i)
      if (pos0 + i * 32 < n) k[off + pos0 + i * 32] = (int)v[i];
  } else {
    if (key_bits == 0) {    // no pass ran: the exchange buffer is stale
#pragma unroll
      for (int i = 0; i < IT; ++i)
        if (pos0 + i * 32 < n) exch[pos0 + i * 32] = v[i];
      __syncthreads();
    }
    // Each run of equal keys is ordered by payload.  A run longer than
    // RUN_MAX shows at its start (the value RUN_MAX places on has its key);
    // then every run keeps its place and the slot sorts (run index,
    // payload), 32 + log2(runs) bits, with the keys written out as they
    // stand.  (The values are read from the exchange buffer, which holds
    // the slot in key order, not kept in registers.)
    bool longer = false;
#pragma unroll 1
    for (int pos = pos0; pos < n && pos < pos0 + 32 * IT; pos += 32) {
      const unsigned key = (unsigned)(exch[pos] >> 32);
      longer |= (pos == 0 || (unsigned)(exch[pos - 1] >> 32) != key) &&
                pos + RUN_MAX < n &&
                (unsigned)(exch[pos + RUN_MAX] >> 32) == key;
    }
    if (__syncthreads_or(longer)) {
      // run index of each value: the run starts up to its place, counted
      // with ballots in place order, warp by warp
      const unsigned upto_me = 0xffffffffu >> (31 - lane);
      unsigned starts = 0;
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        const int pos = pos0 + i * 32;
        bool start = false;
        if (pos < n) {
          v[i] = exch[pos];
          k[off + pos] = key_of(v[i]);
          start = pos == 0 || (exch[pos - 1] >> 32) != (v[i] >> 32);
        }
        const unsigned b = __ballot_sync(FULL, start);
        v[i] = ((u64)(starts + __popc(b & upto_me)) << 32) |
               (v[i] & 0xffffffffull);
        starts += __popc(b);
      }
      if (lane == 0) s_wsum[warp] = starts;
      __syncthreads();
      unsigned before = 0, runs = 0;
#pragma unroll 1
      for (int w = 0; w < WARPS; ++w) {
        before += w < warp ? s_wsum[w] : 0;
        runs += s_wsum[w];
      }
#pragma unroll
      for (int i = 0; i < IT; ++i) v[i] += (u64)(before - 1) << 32;
      radix_sort<T, WARPS, IT>(v, n, 0, 0, 32 + bit_len(runs - 1), sm, lane,
                               warp);
#pragma unroll
      for (int i = 0; i < IT; ++i)
        if (pos0 + i * 32 < n) p[off + pos0 + i * 32] = pay_of(v[i]);
      return;
    }
    int s, e;
    // a value's place: its run's start plus the run's values before it in
    // (key, payload) order
#pragma unroll 1
    for (int pos = pos0; pos < n && pos < pos0 + 32 * IT; pos += 32) {
      const T x = exch[pos];
      int q = 0;
      if (key_run(exch, n, pos, s, e) && e - s > 1) {
        for (int t = s; t < e; ++t) {
          const T y = exch[t];
          q += y < x || (y == x && t < pos);
        }
      } else {
        s = pos;
      }
      store_val<PAY>(k, p, off + s + q, x);
    }
  }
}

// ---------------------------------------------------------------------------
// K2

// The first index in [0, c) of the sorted keys whose fine bucket is >= b.
__device__ __forceinline__ int first_at_least(const int* __restrict__ keys,
                                              int c, int b, float scale,
                                              int gmax) {
  int lo = 0, hi = c;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (fine_bucket(keys[mid], scale, gmax) < b)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The outputs a thread merges, until the CTA's barrier lets it write them:
// keys-only the values; with payloads each value's place, two 16-bit places
// a register (IT 64-bit values would take 2 * IT registers through the
// merge), B_RUN set for a place in the incoming sub-run (K2's overflow
// path), else a place in buf.
constexpr unsigned B_RUN = 0x8000u;
template <bool PAY, int IT>
struct Taken {
  unsigned w[PAY ? IT / 2 : IT];
  __device__ __forceinline__ Taken() {
#pragma unroll
    for (int q = 0; q < (PAY ? IT / 2 : IT); ++q) w[q] = 0;
  }
  __device__ __forceinline__ void set(int j, typename Val<PAY>::T v,
                                      unsigned place) {
    if constexpr (PAY)
      w[j / 2] |= place << (16 * (j & 1));
    else
      w[j] = v;
  }
  // the values, for outputs d .. d + IT - 1 below m; RUN: places in the
  // incoming sub-run at b may occur
  template <bool RUN>
  __device__ __forceinline__ void values(
      const typename Val<PAY>::T* buf, const int* __restrict__ k1,
      const int* __restrict__ p1, size_t b, int d, int m,
      typename Val<PAY>::T (&val)[IT]) const {
#pragma unroll
    for (int q = 0; q < IT; ++q) {
      if (d + q < m) {
        if constexpr (PAY) {
          const unsigned at = (w[q / 2] >> (16 * (q & 1))) & 0xFFFF;
          if (RUN && (at & B_RUN))
            val[q] = load_val<PAY>(k1, p1, b + (at & ~B_RUN));
          else
            val[q] = buf[at];
        } else {
          val[q] = w[q];
        }
      }
    }
  }
};

// Outputs d .. d + IT - 1 (those below total) of one merge level: sub-runs
// [q, q + w) and [q + w, q + 2w) of off[] (q a multiple of 2w) become one
// run.  A thread's outputs may cross into the next pair.
template <bool PAY, int IT>
__device__ __forceinline__ void merge_items(const typename Val<PAY>::T* buf,
                                            const int* off, int G, int w,
                                            int total, int d,
                                            Taken<PAY, IT>& out) {
  typedef typename Val<PAY>::T T;
  if (d >= total) return;
  int q = run_of(off, G, d) / (2 * w) * (2 * w);
  int ps = off[q];
  int pm = off[min(q + w, G)];
  int pe = off[min(q + 2 * w, G)];
  const int k = d - ps;
  const int i = co_rank([&](int t) { return buf[pad_at(ps + t)]; }, pm - ps,
                        [&](int t) { return buf[pad_at(pm + t)]; }, pe - pm,
                        k);
  int ia = ps + i, ib = pm + k - i;
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    const int x = d + j;
    if (x < total) {
      while (x == pe) {        // the next pair starts here
        q += 2 * w;
        ps = pe;
        pm = off[min(q + w, G)];
        pe = off[min(q + 2 * w, G)];
        ia = ps;
        ib = pm;
      }
      const T a = ia < pm ? buf[pad_at(ia)] : T(0);
      const T b = ib < pe ? buf[pad_at(ib)] : T(0);
      const bool take_a = ib >= pe || (ia < pm && a <= b);
      out.set(j, take_a ? a : b, pad_at(take_a ? ia : ib));
      ia += take_a;
      ib += !take_a;
    }
  }
}

// One CTA per fine slot (f, g, j) of capacity cap2 <= WARPS * 32 * IT: the
// merge of the sub-runs of fine bucket j in the window's `group` K1 slots,
// cut to its first cap2 values, then pads.
template <bool PAY, int WARPS, int IT>
__global__ void __launch_bounds__(WARPS * 32,
                                  min_ctas(WARPS * 32, MERGE_REGS))
    k2_merge_kernel(
    const int* __restrict__ k1, const int* __restrict__ p1,
    const int* __restrict__ cnt1, int f1, int group, int cap1, int f2,
    int nbg, float scale, int cap2, int* __restrict__ out_k,
    int* __restrict__ out_p, int* __restrict__ cnt2, u64* __restrict__ ovf) {
  typedef typename Val<PAY>::T T;
  constexpr int THREADS = WARPS * 32;
  constexpr int CAP = THREADS * IT;
  extern __shared__ u64 sm_merge[];
  T* buf = reinterpret_cast<T*>(sm_merge);              // pad_at(CAP) values
  int* s_lo = reinterpret_cast<int*>(buf + CAP + CAP / 16);  // group
  int* s_len = s_lo + group;                                 // group
  int* s_off = s_len + group;                                // group + 1
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x % f2;
  const int fg = blockIdx.x / f2;
  const int f = fg / nbg;
  const int g = fg % nbg;
  const int gmax = f1 * f2;
  const size_t slot0 = (size_t)g * group * f1 + f;   // + bi * f1: K1 slot
  // each sub-run's bounds in its K1 slot (s_len holds its end for now)
  for (int t = threadIdx.x; t < 2 * group; t += THREADS) {
    const int bi = t >> 1;
    const size_t slot = slot0 + (size_t)bi * f1;
    const int c = min(cnt1[slot], cap1);
    const int x = first_at_least(k1 + slot * cap1, c, f * f2 + j + (t & 1),
                                 scale, gmax);
    if (t & 1)
      s_len[bi] = x;
    else
      s_lo[bi] = x;
  }
  __syncthreads();
  if (threadIdx.x < 32) {   // lengths and their exclusive prefix
    unsigned carry = 0;
    for (int b0 = 0; b0 < group; b0 += 32) {
      const int bi = b0 + lane;
      const unsigned len = bi < group ? s_len[bi] - s_lo[bi] : 0;
      const unsigned incl = warp_incl_scan(len, lane);
      if (bi < group) {
        s_len[bi] = len;
        s_off[bi] = carry + incl - len;
      }
      carry += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) s_off[group] = carry;
  }
  __syncthreads();
  const int total = s_off[group];
  const int kept = min(total, cap2);
  if (threadIdx.x == 0) {
    cnt2[blockIdx.x] = kept;
    if (total > cap2) atomicAdd(ovf, (u64)(total - cap2));
  }
  const int d = threadIdx.x * IT;
  if (total <= cap2) {
    // stage the sub-runs one after another, a warp a sub-run, then
    // log2(group) levels
    for (int bi = threadIdx.x >> 5; bi < group; bi += WARPS) {
      const size_t src = (slot0 + (size_t)bi * f1) * cap1 + s_lo[bi];
      const int o = s_off[bi];
#pragma unroll 4
      for (int e = lane; e < s_len[bi]; e += 32)
        buf[pad_at(o + e)] = load_val<PAY>(k1, p1, src + e);
    }
    __syncthreads();
#pragma unroll 1
    for (int w = 1; w < group; w <<= 1) {
      Taken<PAY, IT> out;
      merge_items<PAY, IT>(buf, s_off, group, w, total, d, out);
      T val[IT];
      out.template values<false>(buf, k1, p1, 0, d, total, val);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < IT; ++q)
        if (d + q < total) buf[pad_at(d + q)] = val[q];
      __syncthreads();
    }
  } else {
    // K2's own overflow: merge the sub-runs one at a time into the first
    // cap2 values; the incoming sub-run is read from device memory
    int acc = 0;
#pragma unroll 1
    for (int bi = 0; bi < group; ++bi) {
      const int lb = min(s_len[bi], cap2);
      if (lb == 0) continue;
      const size_t src = (slot0 + (size_t)bi * f1) * cap1 + s_lo[bi];
      if (acc == 0) {
        for (int x = threadIdx.x; x < lb; x += THREADS)
          buf[pad_at(x)] = load_val<PAY>(k1, p1, src + x);
        __syncthreads();
        acc = lb;
        continue;
      }
      const int m = min(acc + lb, cap2);
      Taken<PAY, IT> out;
      if (d < m) {
        auto a = [&](int t) { return buf[pad_at(t)]; };
        auto b = [&](int t) { return load_val<PAY>(k1, p1, src + t); };
        const int i = co_rank(a, acc, b, lb, d);
        int ia = i, ib = d - i;
#pragma unroll
        for (int q = 0; q < IT; ++q) {
          if (d + q < m) {
            const T x = ia < acc ? a(ia) : T(0);
            const T y = ib < lb ? b(ib) : T(0);
            const bool take_a = ib >= lb || (ia < acc && x <= y);
            out.set(q, take_a ? x : y,
                    take_a ? (unsigned)pad_at(ia) : B_RUN | ib);
            ia += take_a;
            ib += !take_a;
          }
        }
      }
      T val[IT];
      out.template values<true>(buf, k1, p1, src, d, m, val);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < IT; ++q)
        if (d + q < m) buf[pad_at(d + q)] = val[q];
      __syncthreads();
      acc = m;
    }
  }
  const size_t o = (size_t)blockIdx.x * cap2;
  for (int x = threadIdx.x; x < cap2; x += THREADS) {
    if (x < kept) {
      store_val<PAY>(out_k, out_p, o + x, buf[pad_at(x)]);
    } else {
      out_k[o + x] = KEY_PAD_INT;
      if (PAY) out_p[o + x] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers

template <bool PAY, int WARPS, int IT>
cudaError_t launch_k1_sort(int* k, int* p, int* cnt, int nslots, int cap,
                           u64* ovf, cudaStream_t st) {
  typedef typename Val<PAY>::T T;
  const int smem = WARPS * 32 * IT * (int)sizeof(T) +
                   (RADIX * (WARPS + 1) + WARPS * RADIX) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      k1_sort_kernel<PAY, WARPS, IT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k1_sort_kernel<PAY, WARPS, IT><<<nslots, WARPS * 32, smem, st>>>(
      k, p, cnt, cap, ovf);
  return cudaGetLastError();
}

template <bool PAY, int WARPS, int IT>
cudaError_t launch_k2(const int* k1, const int* p1, const int* cnt1, int f1,
                      int group, int cap1, int f2, int nbg, float scale,
                      int cap2, int* out_k, int* out_p, int* cnt2, u64* ovf,
                      cudaStream_t st) {
  typedef typename Val<PAY>::T T;
  constexpr int CAP = WARPS * 32 * IT;
  const int smem = (CAP + CAP / 16) * (int)sizeof(T) + (3 * group + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      k2_merge_kernel<PAY, WARPS, IT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k2_merge_kernel<PAY, WARPS, IT><<<f1 * nbg * f2, WARPS * 32, smem, st>>>(
      k1, p1, cnt1, f1, group, cap1, f2, nbg, scale, cap2, out_k, out_p, cnt2,
      ovf);
  return cudaGetLastError();
}

// The CTA a slot of `cap` values takes, as one of SHAPES: 8, 16 or 32
// warps of ITEMS values a thread (smaller slots leave threads idle; K1's
// sort stops at 16 warps, whose 80 registers a thread with payloads 1,024
// threads could not have).  -1 past K2_MAX_CAP.
int shape_for(int cap) {
  for (int s = 0; s < 3; ++s)
    if (cap <= SHAPES[s][0] * 32 * SHAPES[s][1]) return s;
  return -1;
}

template <bool PAY>
cudaError_t k1_launch(const int* keys, const int* pay, long long n, int nb,
                      int block_elems, int f1, int f2, float scale, int cap1,
                      int* out_k, int* out_p, int* cnt1, u64* ovf,
                      cudaStream_t st) {
  const int shape = shape_for(cap1);
  if (f1 < 1 || f1 >= MAX_F || f2 < 1 || f2 >= MAX_F || block_elems < 1 ||
      nb < 0 || n < 0 || n > (long long)nb * block_elems ||
      cap1 > K1_MAX_CAP || shape < 0)
    return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  cudaError_t err =
      cudaMemsetAsync(cnt1, 0, (size_t)nb * f1 * sizeof(int), st);
  if (err != cudaSuccess) return err;
  const int chunks = (block_elems + CHUNK - 1) / CHUNK;
  const int smem = 3 * MAX_F * 4 + CHUNK * (PAY ? 9 : 5);
  err = cudaFuncSetAttribute(k1_scatter_kernel<PAY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  k1_scatter_kernel<PAY><<<(unsigned)((long long)nb * chunks), SC_THREADS,
                           smem, st>>>(keys, pay, n, block_elems, chunks, f1,
                                       f2, scale, cap1, out_k, out_p, cnt1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define RHO3_K1(S)                                                           \
  launch_k1_sort<PAY, SHAPES[S][0], SHAPES[S][1]>(out_k, out_p, cnt1,         \
                                                  nb * f1, cap1, ovf, st)
  return shape == 0 ? RHO3_K1(0) : RHO3_K1(1);
#undef RHO3_K1
}

template <bool PAY>
cudaError_t k2_launch(const int* k1, const int* p1, const int* cnt1, int f1,
                      int group, int cap1, int f2, int nbg, float scale,
                      int cap2, int* out_k, int* out_p, int* cnt2, u64* ovf,
                      cudaStream_t st) {
  const int shape = shape_for(cap2);
  if (f1 < 1 || f2 < 1 || group < 1 || group > MAX_GROUP || cap1 < 1 ||
      nbg < 0 || cap2 > K2_MAX_CAP || shape < 0)
    return cudaErrorInvalidValue;
  if (nbg == 0) return cudaSuccess;
#define RHO3_K2(S)                                                          \
  launch_k2<PAY, SHAPES[S][0], SHAPES[S][1]>(k1, p1, cnt1, f1, group, cap1, \
                                             f2, nbg, scale, cap2, out_k,   \
                                             out_p, cnt2, ovf, st)
  switch (shape) {
    case 0: return RHO3_K2(0);
    case 1: return RHO3_K2(1);
    default: return RHO3_K2(2);
  }
#undef RHO3_K2
}

}  // namespace

extern "C" {

const char* rho3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Largest slot capacity, in elements, K1 (k = 1) and K2 (k = 2) take.
int rho3_max_slot(int k) { return k == 1 ? K1_MAX_CAP : K2_MAX_CAP; }

// Most K1 slots one K2 window merges (the geometry's group).
int rho3_max_group() { return MAX_GROUP; }

// K1: keys[n] (+ pay[n], or null) -> out_k/out_p[nb][f1][cap1], cnt1[nb][f1];
// adds the overflow to *ovf.  Keys at index >= n are pads.
int rho3_k1(const int* keys, const int* pay, long long n, int nb,
            int block_elems, int f1, int f2, float scale, int cap1,
            int* out_k, int* out_p, int* cnt1, unsigned long long* ovf,
            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(pay ? k1_launch<true>(keys, pay, n, nb, block_elems, f1, f2,
                                     scale, cap1, out_k, out_p, cnt1, ovf, st)
                   : k1_launch<false>(keys, nullptr, n, nb, block_elems, f1,
                                      f2, scale, cap1, out_k, nullptr, cnt1,
                                      ovf, st));
}

// K2: K1's slots -> out_k/out_p[f1][nbg][f2][cap2], cnt2[f1][nbg][f2];
// adds the overflow to *ovf.
int rho3_k2(const int* k1, const int* p1, const int* cnt1, int f1, int group,
            int cap1, int f2, int nbg, float scale, int cap2, int* out_k,
            int* out_p, int* cnt2, unsigned long long* ovf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(p1 ? k2_launch<true>(k1, p1, cnt1, f1, group, cap1, f2, nbg,
                                    scale, cap2, out_k, out_p, cnt2, ovf, st)
                  : k2_launch<false>(k1, nullptr, cnt1, f1, group, cap1, f2,
                                     nbg, scale, cap2, out_k, nullptr, cnt2,
                                     ovf, st));
}

// Largest fine-slot capacity K3, K3M, K3TWO and K3TWO_MAT take (the MAT
// S pass's 16-bit slot positions).
int rho3_k3_max_cap() { return SR_MAX_CAP; }

// K3: K2's fine slots -> *matches, *checksum, with P key sub-ranges a
// region; adds each halving of a sub-range to *halvings (all accumulated;
// the caller zeroes matches and checksum).
int rho3_k3(const int* k2, const int* p2, const int* cnt2, int f1, int nbg,
            int f2, int cap2, int P, unsigned long long* matches,
            unsigned int* checksum, unsigned long long* halvings,
            void* stream) {
  const Runs runs{k2, p2, cnt2, nbg};
  return (int)launch_subrange_join<true>(runs, runs, f1, f2, cap2, P,
                                         matches, checksum, halvings,
                                         (cudaStream_t)stream);
}

// K3M: K2's fine slots with payloads -> ok/orp/osp[f1][nbg][f2][cap2] (every
// position written), *matches, *checksum, with P key sub-ranges a region;
// adds each halving of a sub-range to *halvings (all accumulated; the
// caller zeroes matches and checksum).
int rho3_k3m(const int* k2, const int* p2, const int* cnt2, int f1, int nbg,
             int f2, int cap2, int P, int inv, int* ok, int* orp, int* osp,
             unsigned long long* matches, unsigned int* checksum,
             unsigned long long* halvings, void* stream) {
  const Runs runs{k2, p2, cnt2, nbg};
  // K2's layout: run j's slot of region (a, b) at ((a * nbg + j) * f2 + b)
  const long long sj = (long long)f2 * cap2;
  return (int)launch_subrange_join<true, true>(
      runs, runs, f1, f2, cap2, P, matches, checksum, halvings,
      (cudaStream_t)stream, MatOut{ok, orp, osp, inv, nbg * sj, cap2, sj, 0});
}

}  // extern "C"
