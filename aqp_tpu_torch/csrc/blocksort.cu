// Hopper kernels of the block sort: sort each block of sub*128 (key,
// payload) int32 pairs independently, ascending.
//
//   sort_blocks  replaces _sort_kernel (aqp_tpu/ops/pallas/blocksort.py:103),
//                launched by sort_blocks (blocksort.py:133).
//   sort_hist    replaces _make_sort_hist_kernel
//                (aqp_tpu/ops/pallas/compact.py:86), launched by sort_hist
//                (compact.py:137): the same sort, then per block the row
//                index where each bucket of its rows' leading keys starts.
//
// Order.  A pair sorts as the unsigned 64-bit value
// (key ^ 0x80000000) << 32 | (unsigned)payload: by key as signed int32, and
// equal keys by payload as unsigned.  The TPU's bitonic network never
// exchanges equal keys, so its payload order among equal keys is the
// network's own; here it is defined, and the plain version (a row-wise
// torch.sort of the same 64-bit values) gives the same output bit for bit.
// Two values tie only when they are bit-identical, so no stability question
// arises between tiles or runs.  The TPU kernels sort a column-major
// (sub, 128) tile and turn it row-major again; their net effect is one sort
// of each block in flat order, which is what these kernels compute, with
// no corner turns.
//
// Bound: each pair read once and written once, 16 bytes a pair: 2^27 pairs
// are 2.15 GB, >= 0.64 ms at 3.35 TB/s.
//
// Design.  A block is 16 Ki to 128 Ki pairs (128 KiB to 1 MiB as 64-bit
// values); a CTA has at most 227 KB of shared memory.  So a block is sorted
// in tiles of TILE = 16 Ki values, then the tiles are merged pairwise.
//   tile_sort_kernel  one CTA of 512 threads per tile; each thread holds 32
//                 values in registers, warp-striped (warp w's lane l holds
//                 tile positions w*1024 + i*32 + l).  Each 8-bit digit to
//                 sort takes one stable LSD pass (radix_pass): every warp
//                 ranks its 1,024 values in position order (the lanes that
//                 share a digit set their bits in a per-warp mask word of
//                 that digit; one counter per (digit, warp)), one
//                 block-wide scan of the counters in (digit, warp) order
//                 gives each digit's offset for each warp, and every value
//                 is scattered once into a 16 Ki x 8 B exchange buffer and
//                 read back in position order.  The digits to sort: an
//                 AND/OR reduction skips those constant over the tile (a
//                 tile of equal values takes no pass); the payload digits
//                 only order equal keys, so they are skipped when the
//                 payloads ascend in position order (partition_bench's
//                 arange), and a tile whose keys and payloads both vary
//                 sorts its 4 key digits first and keeps the result when it
//                 is in order (16 Ki random 30-bit keys repeat one with
//                 probability ~0.12, in payload order half the time), else
//                 sorts every varying digit from there.  A tile of repeated
//                 keys (compact_kp's pads: most of the first 32 keys of a
//                 quarter of its warps equal their lane 0's) does so at
//                 once.  At sub = 128 (one tile a block) this kernel writes
//                 the int32 outputs.  sort_tile_plan runs it with a counter
//                 of the tiles by plan and of their passes.
//   merge_kernel  one level of pairwise merges of sorted runs of `run`
//                 values, log2(block / TILE) levels.  A CTA owns 4,096
//                 outputs: one warp per end of its range finds the range's
//                 split (co-rank) in the two runs by a 32-way search in
//                 device memory, the CTA stages the two input windows in
//                 shared memory (coalesced), each thread finds its own 16
//                 outputs' split there by binary search and merges them in
//                 registers, and the CTA writes them coalesced.  The last
//                 level writes the int32 outputs.
// Ties go to the left run in every split and every merge step, so the
// CTAs' and threads' splits agree.
//
// Trips through device memory per call, each reading and writing every
// pair once, in as many launches (sort_hist adds one small launch):
//   sub   128  256  512  1024
//   trips   1    2    3     4
// Shared memory per value: 16 bytes (a scatter and a read-back) and four
// to six 4-byte mask and counter accesses per warp for each digit sorted
// (at most 8, 12 when a tile's key-first order fails); 24 bytes per merge
// level (staged, merged, written back).  Scratch: the tile kernel writes
// 64-bit values to `work`, the levels alternate between its two halves (n
// values each; one half at sub = 256, none at sub = 128).
//
// sort_hist adds row_starts_kernel: one CTA per block reads each row's
// leading key, buckets it (as rho3's fine bucket, float32 with
// round-to-nearest and truncation: build without --use_fast_math), counts
// the buckets in shared memory and writes the exclusive prefix.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int LANES = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int HIST_THREADS = 256;
constexpr int PACKED_PAD_MIN = 2147483644;

// Kernels launched without error since the library was loaded: the tile
// sort, merge levels and row starts (sort_kernel_launches).
long long launched[3];

// tile radix sort
constexpr int TILE_THREADS = 512;
constexpr int TILE = 16384;                      // values a CTA sorts
constexpr int ITEMS = TILE / TILE_THREADS;       // values a thread holds
constexpr int TILE_WARPS = TILE_THREADS / 32;
constexpr int WARP_SPAN = 32 * ITEMS;            // a warp's positions
constexpr int RADIX = 256;
// counters of digit d at d * HIST_PITCH + warp: the pad keeps one warp's
// 256 counters, and each thread's run of scan entries, on distinct banks
constexpr int HIST_PITCH = TILE_WARPS + 1;
constexpr int SCAN_ITEMS = RADIX * TILE_WARPS / TILE_THREADS;
// the exchange buffer, the counters, and each warp's 256 match masks
constexpr int TILE_SMEM = TILE * 8 + RADIX * HIST_PITCH * 4 +
                          TILE_WARPS * RADIX * 4;
static_assert(TILE_WARPS <= 32, "the tile reductions read one warp total "
              "a lane");
static_assert(TILE_WARPS == 2 * SCAN_ITEMS, "two threads scan a digit's "
              "counters");
// sort_tile_plan's counters: tiles, LSD passes, then tiles by plan (a
// tile's PLAN_KEYS resolves to PLAN_KEPT or PLAN_FAILED)
enum Plan {
  PLAN_TILES, PLAN_PASSES,
  PLAN_DIRECT,    // sorts its varying digits: keys or payloads constant,
                  // or payloads ascending
  PLAN_KEPT,      // in order after its key digits
  PLAN_FAILED,    // not in order after its key digits: every digit again
  PLAN_REPEATED,  // repeated keys seen before any pass: every digit
  PLAN_COUNTERS,
  PLAN_KEYS = PLAN_COUNTERS
};

// merge levels
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_ITEMS = 16;                  // outputs a thread merges
constexpr int MERGE_SPAN = MERGE_THREADS * MERGE_ITEMS;   // a CTA's outputs
static_assert(TILE % MERGE_SPAN == 0, "a CTA's range lies in one pair");

__device__ __forceinline__ u64 pack64(int key, int pay) {
  return ((u64)((unsigned)key ^ 0x80000000u) << 32) | (unsigned)pay;
}
__device__ __forceinline__ int key_of(u64 v) {
  return (int)((unsigned)(v >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int pay_of(u64 v) { return (int)(unsigned)v; }

__device__ __forceinline__ u64 warp_and(u64 x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x &= __shfl_xor_sync(FULL, x, o);
  return x;
}
__device__ __forceinline__ u64 warp_or(u64 x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x |= __shfl_xor_sync(FULL, x, o);
  return x;
}
// True when f(v) never decreases over the tile's positions (v: this
// thread's values, warp-striped; s_last: one value a warp).
template <class F>
__device__ __forceinline__ bool tile_ascends(const u64 (&v)[ITEMS], F f,
                                             u64* s_last, int lane,
                                             int warp) {
  bool up = true;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const u64 x = f(v[i]);
    const u64 left = __shfl_up_sync(FULL, x, 1);
    if (lane > 0) up &= left <= x;
    if (i > 0) {
      const u64 prev = __shfl_sync(FULL, f(v[i - 1]), 31);
      if (lane == 0) up &= prev <= x;
    }
  }
  if (lane == 31) s_last[warp] = f(v[ITEMS - 1]);
  __syncthreads();
  if (lane == 0 && warp > 0) up &= s_last[warp - 1] <= f(v[0]);
  return __syncthreads_and(up);
}

__device__ __forceinline__ unsigned warp_incl_scan(unsigned x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Replace the counters c(d, w) (digit-major) by their exclusive prefix
// sums: c(d, w) becomes the number of the tile's values with a smaller
// digit, plus those with digit d in warps before w.
__device__ __forceinline__ void scan_counters(unsigned* s_hist,
                                              unsigned* s_wsum, int lane,
                                              int warp) {
  const int e0 = threadIdx.x * SCAN_ITEMS;
  unsigned* h = s_hist + (e0 / TILE_WARPS) * HIST_PITCH + e0 % TILE_WARPS;
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) sum += h[j];
  const unsigned incl = warp_incl_scan(sum, lane);
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  const unsigned w = lane < TILE_WARPS ? s_wsum[lane] : 0;
  const unsigned w_excl = warp_incl_scan(w, lane) - w;
  unsigned run = __shfl_sync(FULL, w_excl, warp) + incl - sum;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const unsigned c = h[j];
    h[j] = run;
    run += c;
  }
}

// Shared memory of the tile sort.
struct TileSmem {
  u64* exch;              // TILE values
  unsigned* hist;         // RADIX x HIST_PITCH counters
  unsigned* mask;         // this warp's RADIX match masks
  unsigned* wsum;         // TILE_WARPS
  int* shift;
};

// One stable LSD pass of the tile on the digit at `shift`: v (position
// order) is sorted by that digit, and by position among equal digits.
__device__ __forceinline__ void radix_pass(u64 (&v)[ITEMS], int shift,
                                           const TileSmem& sm, int lane,
                                           int warp, int pos0) {
  const unsigned below_me = (1u << lane) - 1;
  for (int d = lane; d < RADIX; d += 32) sm.hist[d * HIST_PITCH + warp] = 0;
  if (threadIdx.x == 0) *sm.shift = shift;
  __syncwarp();
  // rank of each value among the warp's values of its digit, in position
  // order; two 16-bit ranks a register
  unsigned rank[ITEMS / 2];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned dig = (unsigned)(v[i] >> shift) & 0xFF;
    // the lanes that share the digit: each sets its bit in the digit's
    // mask; the lowest of them (the leader) clears it again
    atomicOr(sm.mask + dig, 1u << lane);
    __syncwarp();
    const unsigned peers = sm.mask[dig];
    const unsigned below = peers & below_me;
    unsigned* c = sm.hist + dig * HIST_PITCH + warp;
    const unsigned cnt = *c;
    __syncwarp();
    if (below == 0) {
      *c = cnt + __popc(peers);
      sm.mask[dig] = 0;
    }
    __syncwarp();
    const unsigned r = cnt + __popc(below);
    if (i & 1)
      rank[i / 2] |= r << 16;
    else
      rank[i / 2] = r;
  }
  __syncthreads();
  scan_counters(sm.hist, sm.wsum, lane, warp);
  __syncthreads();
  // the shift read back from shared memory: the digits and counter
  // addresses are computed again here, not kept live from the ranking
  // (which spills)
  const int sh = *sm.shift;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned dig = (unsigned)(v[i] >> sh) & 0xFF;
    const unsigned r = (rank[i / 2] >> (16 * (i & 1))) & 0xFFFF;
    sm.exch[sm.hist[dig * HIST_PITCH + warp] + r] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) v[i] = sm.exch[pos0 + i * 32];
  // the next pass writes the exchange buffer only after its own barriers
}

// Sort each tile of TILE pairs: pack, choose the digits to sort, one
// stable LSD pass for each, then write the 64-bit values to work (TO_INT
// false) or the int32 outputs (TO_INT true); plan, when not null, gets the
// tile counted by its Plan and its passes.
//
// The digits: those that are constant over the tile are skipped.  The
// payload digits only order equal keys: a stable sort on the key digits
// alone leaves equal keys in position order, which is the answer when the
// payloads ascend in position order (they are skipped then), and may be
// when no key repeats.  So a tile whose keys and payloads both vary sorts
// its key digits first and checks the result; only a tile not yet in
// order then takes every varying digit, payloads first, from where it
// stands (an LSD sort over every varying digit is exact from any order).
// A tile that shows a repeated key before it starts (most of the first 32
// keys of a quarter of its warps equal their lane 0's: compact_kp's pads)
// takes every digit at once.
template <bool TO_INT>
__global__ void __launch_bounds__(TILE_THREADS, 1) tile_sort_kernel(
    const int* __restrict__ key, const int* __restrict__ pay,
    u64* __restrict__ work, int* __restrict__ ok, int* __restrict__ op,
    int* __restrict__ plan) {
  extern __shared__ u64 s_exch[];                            // TILE values
  unsigned* s_hist = reinterpret_cast<unsigned*>(s_exch + TILE);
  __shared__ u64 s_and[TILE_WARPS], s_or[TILE_WARPS], s_last[TILE_WARPS];
  __shared__ unsigned s_wsum[TILE_WARPS];
  __shared__ int s_shift;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const TileSmem sm{s_exch, s_hist,
                    s_hist + RADIX * HIST_PITCH + warp * RADIX, s_wsum,
                    &s_shift};
  const int pos0 = warp * WARP_SPAN + lane;           // position of v[0]
  const size_t g0 = (size_t)blockIdx.x * TILE + pos0;
  u64 v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) v[i] = pack64(key[g0 + i * 32],
                                                pay[g0 + i * 32]);

  u64 all_and = v[0], any_or = v[0];
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) {
    all_and &= v[i];
    any_or |= v[i];
  }
  all_and = warp_and(all_and);
  any_or = warp_or(any_or);
  if (lane == 0) {
    s_and[warp] = all_and;
    s_or[warp] = any_or;
  }
  for (int d = lane; d < RADIX; d += 32) sm.mask[d] = 0;
  // (the barrier in tile_ascends publishes s_and and s_or)
  const bool pay_ascends = tile_ascends(
      v, [](u64 x) { return x & 0xFFFFFFFFull; }, s_last, lane, warp);
  const u64 vary = warp_and(lane < TILE_WARPS ? s_and[lane] : ~0ull) ^
                   warp_or(lane < TILE_WARPS ? s_or[lane] : 0ull);
  unsigned digits = 0;               // bit j: digit j (bits 8j..8j+7) varies
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if ((vary >> (8 * j)) & 0xFF) digits |= 1u << j;
  if (pay_ascends) digits &= 0xF0;
  // A warp whose first 32 keys mostly equal its lane 0's marks a key that
  // repeats; a quarter of the warps marking one skips the key-first order.
  const unsigned k0 = (unsigned)(v[0] >> 32);
  const bool marks = __popc(__ballot_sync(
      FULL, k0 == __shfl_sync(FULL, k0, 0))) > 16;
  const bool repeats = 4 * __syncthreads_count(lane == 0 && marks) >=
                       TILE_WARPS;
  // every branch below is the same for the whole tile
  int kind = !((digits & 0x0F) && (digits & 0xF0)) ? PLAN_DIRECT
             : repeats                              ? PLAN_REPEATED
                                                    : PLAN_KEYS;
  unsigned queue = kind == PLAN_KEYS ? digits & 0xF0 : digits;
#pragma unroll 1
  while (queue) {
    const int j = __ffs(queue) - 1;
    queue &= queue - 1;
    radix_pass(v, 8 * j, sm, lane, warp, pos0);
    if (kind == PLAN_KEYS && queue == 0) {
      kind = PLAN_KEPT;
      if (!tile_ascends(v, [](u64 x) { return x; }, s_last, lane, warp)) {
        kind = PLAN_FAILED;
        queue = digits;
      }
    }
  }
  if (plan && threadIdx.x == 0) {
    const bool keys = kind == PLAN_KEPT || kind == PLAN_FAILED;
    atomicAdd(plan + PLAN_TILES, 1);
    atomicAdd(plan + PLAN_PASSES,
              __popc(keys ? digits & 0xF0 : digits) +
                  (kind == PLAN_FAILED ? __popc(digits) : 0));
    atomicAdd(plan + kind, 1);
  }

#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (TO_INT) {
      ok[g0 + i * 32] = key_of(v[i]);
      op[g0 + i * 32] = pay_of(v[i]);
    } else {
      work[g0 + i * 32] = v[i];
    }
  }
}

// The number of a's values among the first k outputs of merge(a, b), runs
// of len sorted values each, a's value first on ties.  One warp; each round
// probes 32 evenly spaced splits at once.
__device__ __forceinline__ int co_rank_warp(const u64* __restrict__ a,
                                            const u64* __restrict__ b,
                                            int len, int k, int lane) {
  int lo = max(0, k - len), hi = min(k, len);
  // answer in [lo, hi]: the first i in [lo, hi) with a[i] > b[k - 1 - i],
  // else hi
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int q = lo + (lane + 1) * step - 1;
    const bool before = q < hi && a[q] <= b[k - 1 - q];
    const int c = __popc(__ballot_sync(FULL, before));
    const int nlo = lo + c * step;
    hi = min(lo + (c + 1) * step - 1, hi);
    lo = nlo;
  }
  const int q = lo + lane;
  const bool before = q < hi && a[q] <= b[k - 1 - q];
  return lo + __popc(__ballot_sync(FULL, before));
}

// Shared-memory slot of a CTA's value x: one pad word every 16 keeps both a
// thread's run of 16 and 16 consecutive values on distinct banks.
__device__ __forceinline__ int slot(int x) { return x + (x >> 4); }

// One merge level: each pair of sorted runs of `run` values becomes one
// run of 2 * run, in dst (TO_INT false) or the int32 outputs (TO_INT true).
// (The bound of 4 CTAs an SM gives ptxas a 64-register target; without
// it, it spilled two of `out`.)
template <bool TO_INT>
__global__ void __launch_bounds__(MERGE_THREADS, 4) merge_kernel(
    const u64* __restrict__ src, u64* __restrict__ dst, int* __restrict__ ok,
    int* __restrict__ op, int run) {
  __shared__ u64 s_buf[MERGE_SPAN + MERGE_SPAN / 16];
  __shared__ int s_split[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long o = (long long)blockIdx.x * MERGE_SPAN;
  const long long pair0 = o & -(2LL * run);   // run: a power of two
  const u64* a = src + pair0;
  const u64* b = a + run;
  const int k0 = (int)(o - pair0);
  if (warp < 2) {
    const int split = co_rank_warp(a, b, run, k0 + warp * MERGE_SPAN, lane);
    if (lane == 0) s_split[warp] = split;
  }
  __syncthreads();
  const int a0 = s_split[0];
  const int na = s_split[1] - a0;         // the window's values from a
  const int b0 = k0 - a0;
  for (int x = threadIdx.x; x < MERGE_SPAN; x += MERGE_THREADS)
    s_buf[slot(x)] = x < na ? a[a0 + x] : b[b0 + x - na];
  __syncthreads();

  // this thread's outputs d .. d + MERGE_ITEMS - 1 of the window's merge
  // of s_buf[0, na) and s_buf[na, MERGE_SPAN)
  const int d = threadIdx.x * MERGE_ITEMS;
  int lo = max(0, d - (MERGE_SPAN - na)), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_buf[slot(mid)] <= s_buf[slot(na + d - 1 - mid)])
      lo = mid + 1;
    else
      hi = mid;
  }
  // branch-free steps: the next value of the side taken is read at an
  // index clamped into the window and used only while that side lasts
  int ia = lo, ib = na + d - lo;
  u64 x = s_buf[slot(min(ia, MERGE_SPAN - 1))];
  u64 y = s_buf[slot(min(ib, MERGE_SPAN - 1))];
  u64 out[MERGE_ITEMS];
#pragma unroll
  for (int j = 0; j < MERGE_ITEMS; ++j) {
    const bool take_a = ib >= MERGE_SPAN || (ia < na && x <= y);
    out[j] = take_a ? x : y;
    ia += take_a;
    ib += !take_a;
    const u64 z = s_buf[slot(min(take_a ? ia : ib, MERGE_SPAN - 1))];
    x = take_a ? z : x;
    y = take_a ? y : z;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < MERGE_ITEMS; ++j) s_buf[slot(d + j)] = out[j];
  __syncthreads();
  for (int i = threadIdx.x; i < MERGE_SPAN; i += MERGE_THREADS) {
    const u64 v = s_buf[slot(i)];
    if (TO_INT) {
      ok[o + i] = key_of(v);
      op[o + i] = pay_of(v);
    } else {
      dst[o + i] = v;
    }
  }
}

// Bucket of a sorted row by its leading key (compact.py:97-103): F for a
// pad, else clamp(int(float32(lead >> 1) * scale), 0, F - 1).
__device__ __forceinline__ int row_bucket(int lead, float scale, int F) {
  if (lead >= PACKED_PAD_MIN) return F;
  int g = __float2int_rz(__fmul_rn(__int2float_rn(lead >> 1), scale));
  g = min(g, F - 1);
  return max(g, 0);
}

// starts[b, f] = the number of rows of block b whose bucket is < f,
// f = 0..F.  One CTA per block.
__global__ void __launch_bounds__(HIST_THREADS) row_starts_kernel(
    const int* __restrict__ ks, int sub, int F, float scale,
    int* __restrict__ starts) {
  __shared__ int hist[LANES];
  for (int f = threadIdx.x; f < LANES; f += blockDim.x) hist[f] = 0;
  __syncthreads();
  const size_t row0 = (size_t)blockIdx.x * sub;
  for (int r = threadIdx.x; r < sub; r += blockDim.x)
    atomicAdd(&hist[row_bucket(ks[(row0 + r) * LANES], scale, F)], 1);
  __syncthreads();
  for (int f = threadIdx.x; f <= F; f += blockDim.x) {
    int c = 0;
    for (int g = 0; g < f; ++g) c += hist[g];
    starts[(size_t)blockIdx.x * (F + 1) + f] = c;
  }
}

template <bool TO_INT>
cudaError_t launch_tiles(const int* key, const int* pay, u64* work, int* ok,
                         int* op, int* plan, long long n, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_kernel<TO_INT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TILE_SMEM);
  if (err != cudaSuccess) return err;
  tile_sort_kernel<TO_INT><<<(unsigned)(n / TILE), TILE_THREADS, TILE_SMEM,
                             st>>>(key, pay, work, ok, op, plan);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[0];
  return err;
}

bool valid_sub(int sub) {
  return sub >= 128 && sub <= 1024 && (sub & (sub - 1)) == 0;
}

// Tile sort, then log2(block / TILE) merge levels, on every block of n
// pairs (n a multiple of sub*128).  work: 2n 64-bit values when a block
// holds four tiles or more, n when it holds two, else unused.
cudaError_t sort_launch(const int* key, const int* pay, long long n, int sub,
                        u64* work, int* ok, int* op, cudaStream_t st) {
  const int block = sub * LANES;
  if (!valid_sub(sub) || n < 0 || n % block) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (block == TILE)
    return launch_tiles<true>(key, pay, nullptr, ok, op, nullptr, n, st);
  if (!work) return cudaErrorInvalidValue;
  cudaError_t err = launch_tiles<false>(key, pay, work, nullptr, nullptr,
                                        nullptr, n, st);
  const unsigned ctas = (unsigned)(n / MERGE_SPAN);
  u64* src = work;
  u64* dst = work + n;
  for (int run = TILE; run < block && err == cudaSuccess; run <<= 1) {
    if (2 * run == block)
      merge_kernel<true><<<ctas, MERGE_THREADS, 0, st>>>(src, nullptr, ok,
                                                         op, run);
    else
      merge_kernel<false><<<ctas, MERGE_THREADS, 0, st>>>(src, dst, nullptr,
                                                          nullptr, run);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++launched[1];
    u64* t = src;
    src = dst;
    dst = t;
  }
  return err;
}

}  // namespace

extern "C" {

// key, pay, ok, op: n int32 on the device, n a multiple of sub*128, sub a
// power of two in [128, 1024]; work: 2n 64-bit values when sub >= 512, n
// when sub = 256, may be null when sub = 128.
int sort_blocks(const int* key, const int* pay, long long n, int sub,
                void* work, int* ok, int* op, void* stream) {
  return (int)sort_launch(key, pay, n, sub, (u64*)work, ok, op,
                          (cudaStream_t)stream);
}

// sort_blocks, then starts: (n / (sub*128)) x (F + 1) int32, 1 <= F <= 127.
int sort_hist(const int* key, const int* pay, long long n, int sub, int F,
              float scale, void* work, int* ok, int* op, int* starts,
              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F < 1 || F + 1 > LANES) return (int)cudaErrorInvalidValue;
  cudaError_t err = sort_launch(key, pay, n, sub, (u64*)work, ok, op, st);
  if (err != cudaSuccess || n == 0) return (int)err;
  const long long nb = n / ((long long)sub * LANES);
  row_starts_kernel<<<(unsigned)nb, HIST_THREADS, 0, st>>>(ok, sub, F, scale,
                                                           starts);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[2];
  return (int)err;
}

// sort_blocks at sub = 128 (each tile sorted, as at every sub), with the
// tile sort's counts added to plan[0..5]: tiles, LSD passes, then tiles
// sorted directly, in order after their key digits, sorted again on every
// digit, and seen to repeat keys before any pass.
int sort_tile_plan(const int* key, const int* pay, long long n, int* ok,
                   int* op, int* plan, void* stream) {
  if (n < 0 || n % TILE || !plan) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  return (int)launch_tiles<true>(key, pay, nullptr, ok, op, plan, n,
                                 (cudaStream_t)stream);
}

// out[0..2]: the tile sorts, merge levels and row-starts kernels launched
// so far.
void sort_kernel_launches(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = launched[i];
}

}  // extern "C"
