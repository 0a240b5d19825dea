// RSTATS: the skew tier's R-side candidate statistics.
//
// Replaces _make_rstats_kernel (aqp_tpu/joins/skewtier.py:113), launched by
// r_cand_stats_pallas (skewtier.py:191).  For each of h candidate slots
// (h = 64 on the skew path; a slot may be -1 and slots may repeat): the
// number of R rows whose key equals it and the sum of their payloads mod
// 2^32.  A negative slot counts nothing; repeated slots each get the full
// count.
//
// The TPU kernel compares every row with every candidate (h unrolled
// broadcast compares per block) and reduces sublanes on the MXU, summing
// payload bytes in int8 planes, which is exact only for unique R keys.
//
// Design.  On the skew path nearly every row misses (64 of the headline's
// 13.1M R rows hit), so the kernel is a stream of R's keys in which a miss
// must cost next to nothing.
//  - Candidates: each CTA loads hk into shared memory once and inserts its
//    non-negative keys into an open-addressed table of 2^b >= 4h entries
//    (at least 2,048): a key array and, beside it, each key's group, the
//    least slot that holds the key, so repeated slots act as one group.  A
//    row's key hashes to one entry; a miss ends at the first free entry,
//    which at the skew path's load of 1/32 is nearly always the first one
//    read (one 4-byte shared read).  Collisions probe on, so the table is
//    exact for any candidates.
//  - Bytes in flight: each thread loads its next two 16-byte key vectors
//    before it looks up the two it holds (the first two load while the
//    table is built), and the grid is one wave of resident CTAs over R.  A
//    thread keeps its hits as bits; the warp looks at them only when some
//    lane has one.  The elements before R's first 16-byte boundary and
//    after its last whole vector (fewer than four each) are read one by
//    one.
//  - Payloads: a payload is read only for a row that hits, so the payload
//    column is no stream of its own and its alignment does not matter.
//  - Hits are counted in shared memory, warp-aggregated: the lanes of a
//    warp that hit one group in the same step are found with
//    __match_any_sync and their leader adds the lane count and the summed
//    payloads (a 32-bit sum that wraps mod 2^32) with one atomic each.
//  - At the end a CTA adds the totals of the groups it touched to every
//    slot of the group: the count into the int64 count output, the sum
//    into the low word of the int64 payload output, where an unsigned
//    32-bit atomic wraps mod 2^32 and leaves the high word 0.  Exact for
//    any R.
// The launcher zeroes the output (one memset) before the kernel adds into
// it.  The kernel keeps no state between calls: calls on one stream are
// serial, and calls on two streams may run at once, each with its own
// output.
//
// Bound: the device bytes the function must move, each once: R's keys (4
// bytes a row), the 32-byte sectors of payload that hold a hit, hk and the
// (2, h) int64 output.  At |R| = 13,107,200 and 64 candidates that is 52.4
// MB with or without payloads: >= 0.016 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include <limits.h>
#include <stdint.h>

namespace {

constexpr int RSTATS_THREADS = 256;
constexpr int RSTATS_CTAS_PER_SM = 4;
constexpr int RSTATS_MAX_H = 1024;
constexpr int RSTATS_VECS = 2;             // key vectors a thread looks up
constexpr int RSTATS_MIN_TABLE_BITS = 11;  // 2,048 entries
constexpr long long RSTATS_MAX_CTA_ROWS = 1LL << 31;  // a CTA's 32-bit counts
constexpr int EMPTY = -1;                  // a free entry's key
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned HASH_MUL = 0x9E3779B1u;

// Entry of key k in a table of 2^bits entries (Fibonacci hashing).
__device__ __forceinline__ unsigned home(int k, int bits) {
  return ((unsigned)k * HASH_MUL) >> (32 - bits);
}

struct Table {
  int* key;   // EMPTY when free
  int* grp;   // the least slot holding key
  int bits;

  __device__ __forceinline__ void insert(int k, int slot) const {
    const unsigned mask = (1u << bits) - 1u;
    for (unsigned s = home(k, bits);; s = (s + 1u) & mask) {
      const int old = atomicCAS(&key[s], EMPTY, k);
      if (old == EMPTY || old == k) {
        atomicMin(&grp[s], slot);
        return;
      }
    }
  }

  // Group of key k, or -1.  A negative key never matches (EMPTY is one).
  __device__ __forceinline__ int find(int k) const {
    if (k < 0) return -1;
    const unsigned mask = (1u << bits) - 1u;
    for (unsigned s = home(k, bits);; s = (s + 1u) & mask) {
      const int x = key[s];
      if (x == k) return grp[s];
      if (x == EMPTY) return -1;
    }
  }
};

// One element a lane; every lane of the warp calls it (the ballot is the
// warp's).  i: the element's row in R, read for its payload on a hit.
template <bool PAY>
__device__ __forceinline__ void visit(const Table& tab, int k, long long i,
                                      const int* __restrict__ rp,
                                      unsigned* s_cnt, unsigned* s_pay) {
  const int g = tab.find(k);
  const unsigned hit = __ballot_sync(FULL, g >= 0);
  if (hit == 0u || g < 0) return;
  const unsigned peers = __match_any_sync(hit, g);
  unsigned p = 0u;
  if (PAY) p = __reduce_add_sync(peers, (unsigned)__ldg(rp + i));
  if ((int)(threadIdx.x & 31u) == __ffs(peers) - 1) {
    atomicAdd(&s_cnt[g], (unsigned)__popc(peers));
    if (PAY) atomicAdd(&s_pay[g], p);
  }
}

__device__ __forceinline__ int4 load_keys(const int4* k4, long long x,
                                          long long nv) {
  return x < nv ? k4[x] : make_int4(-1, -1, -1, -1);
}

template <bool PAY>
__global__ void __launch_bounds__(RSTATS_THREADS, RSTATS_CTAS_PER_SM)
rstats_kernel(const int* __restrict__ rk, const int* __restrict__ rp,
              long long n, int head, const int* __restrict__ hk, int h,
              int bits, unsigned long long* __restrict__ cnt,
              unsigned* __restrict__ pay_lo) {
  extern __shared__ int s_key[];                  // 2^bits
  int* s_grp = s_key + (1 << bits);               // 2^bits
  int* s_hk = s_grp + (1 << bits);                // h
  unsigned* s_cnt = reinterpret_cast<unsigned*>(s_hk + h);  // h, by group
  unsigned* s_pay = s_cnt + h;                    // h
  const int lane = threadIdx.x & 31;
  const long long nv = (n - head) / 4;
  const int4* k4 = reinterpret_cast<const int4*>(rk + head);
  const long long stride = (long long)gridDim.x * RSTATS_THREADS;
  const long long step = stride * RSTATS_VECS;
  long long v = (long long)blockIdx.x * RSTATS_THREADS + threadIdx.x;

  // the first vectors are in flight while the table is built
  int4 kv[RSTATS_VECS];
#pragma unroll
  for (int u = 0; u < RSTATS_VECS; ++u)
    kv[u] = load_keys(k4, v + u * stride, nv);
  const Table tab{s_key, s_grp, bits};
  for (int s = threadIdx.x; s < (1 << bits); s += RSTATS_THREADS) {
    s_key[s] = EMPTY;
    s_grp[s] = INT_MAX;
  }
  for (int t = threadIdx.x; t < h; t += RSTATS_THREADS) {
    s_hk[t] = hk[t];
    s_cnt[t] = 0u;
    s_pay[t] = 0u;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < h; t += RSTATS_THREADS)
    if (s_hk[t] >= 0) tab.insert(s_hk[t], t);
  __syncthreads();

  // the head and the tail (under four elements each): CTA 0's warp 0,
  // lanes 0-3 the head, lanes 4-7 the tail
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    long long i = -1;
    if (lane < head) i = lane;
    const long long t0 = head + nv * 4;
    if (lane >= 4 && lane < 8 && t0 + lane - 4 < n) i = t0 + lane - 4;
    visit<PAY>(tab, i >= 0 ? rk[i] : -1, i, rp, s_cnt, s_pay);
  }
  // whole vectors, the next ones loading while these are looked up; the
  // loop runs alike in every lane of a warp
  for (; v - lane < nv; v += step) {
    int4 next[RSTATS_VECS];
#pragma unroll
    for (int u = 0; u < RSTATS_VECS; ++u)
      next[u] = load_keys(k4, v + step + u * stride, nv);
    // a lane's hits as bits; the warp looks at them only when it has any
    unsigned hits = 0u;
#pragma unroll
    for (int u = 0; u < RSTATS_VECS; ++u) {
      hits |= (unsigned)(tab.find(kv[u].x) >= 0) << (4 * u);
      hits |= (unsigned)(tab.find(kv[u].y) >= 0) << (4 * u + 1);
      hits |= (unsigned)(tab.find(kv[u].z) >= 0) << (4 * u + 2);
      hits |= (unsigned)(tab.find(kv[u].w) >= 0) << (4 * u + 3);
    }
    if (__any_sync(FULL, hits != 0u)) {
#pragma unroll
      for (int u = 0; u < RSTATS_VECS; ++u) {
        const long long i = head + (v + u * stride) * 4;
        const int b = 4 * u;
        visit<PAY>(tab, (hits >> b) & 1u ? kv[u].x : -1, i, rp, s_cnt, s_pay);
        visit<PAY>(tab, (hits >> (b + 1)) & 1u ? kv[u].y : -1, i + 1, rp,
                   s_cnt, s_pay);
        visit<PAY>(tab, (hits >> (b + 2)) & 1u ? kv[u].z : -1, i + 2, rp,
                   s_cnt, s_pay);
        visit<PAY>(tab, (hits >> (b + 3)) & 1u ? kv[u].w : -1, i + 3, rp,
                   s_cnt, s_pay);
      }
    }
#pragma unroll
    for (int u = 0; u < RSTATS_VECS; ++u) kv[u] = next[u];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < h; t += RSTATS_THREADS) {
    const int g = tab.find(s_hk[t]);
    if (g < 0 || s_cnt[g] == 0u) continue;
    atomicAdd(&cnt[t], (unsigned long long)s_cnt[g]);
    if (PAY) atomicAdd(&pay_lo[2 * t], s_pay[g]);
  }
}

// SMs of the current device, asked once a process.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    int v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    sms = v > 0 ? v : 132;
  }
  return sms;
}

}  // namespace

extern "C" {

// Largest number of candidate slots rstats takes.
int rstats_max_h() { return RSTATS_MAX_H; }

// rk[n] (+ rp[n], or null), hk[h] -> out (2, h) int64: row 0 the counts,
// row 1 the payload sums mod 2^32.  out is zeroed here (one memset), then
// the kernel adds into it.
int rstats(const int* rk, const int* rp, long long n, const int* hk, int h,
           long long* out, void* stream) {
  if (h < 1 || h > RSTATS_MAX_H || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t zeroed =
      cudaMemsetAsync(out, 0, (size_t)h * 2 * sizeof(long long), st);
  if (zeroed != cudaSuccess) return (int)zeroed;
  // the elements before rk's first 16-byte boundary go one by one
  const uintptr_t mis = (uintptr_t)rk & 15u;
  long long head = (long long)(((16u - mis) & 15u) / 4u);
  if (head > n) head = n;
  int bits = RSTATS_MIN_TABLE_BITS;
  while ((1 << bits) < 4 * h) ++bits;
  const long long nv = (n - head) / 4;
  const long long per_cta = (long long)RSTATS_THREADS * RSTATS_VECS;
  long long blocks = (nv + per_cta - 1) / per_cta;
  const long long wave = (long long)sm_count() * RSTATS_CTAS_PER_SM;
  if (blocks > wave) blocks = wave;
  const long long least = (n + RSTATS_MAX_CTA_ROWS - 1) / RSTATS_MAX_CTA_ROWS;
  if (blocks < least) blocks = least;
  if (blocks < 1) blocks = 1;
  const size_t smem = (((size_t)2 << bits) + (size_t)h * 3) * sizeof(int);
  unsigned long long* cnt = reinterpret_cast<unsigned long long*>(out);
  unsigned* pay_lo = reinterpret_cast<unsigned*>(out + h);
  if (rp)
    rstats_kernel<true><<<(unsigned)blocks, RSTATS_THREADS, smem, st>>>(
        rk, rp, n, (int)head, hk, h, bits, cnt, pay_lo);
  else
    rstats_kernel<false><<<(unsigned)blocks, RSTATS_THREADS, smem, st>>>(
        rk, nullptr, n, (int)head, hk, h, bits, cnt, pay_lo);
  return (int)cudaGetLastError();
}

}  // extern "C"
