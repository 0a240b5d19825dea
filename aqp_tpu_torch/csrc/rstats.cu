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
// payload bytes in int8 planes, which is exact only for unique R keys.  Here
// one grid-stride pass reads R once with 16-byte loads; each CTA holds the
// candidates sorted in shared memory and each row binary-searches them
// (6 steps at h = 64).  A hit adds to its candidate group's count and sum in
// shared memory (64-bit count, 32-bit sum that wraps mod 2^32), and at the
// end each CTA adds its group totals to every slot of the group with one
// global atomic per slot.  Exact for any R.
//
// Bound: R's keys (and payloads) read once, 52 MB keys-only and 105 MB with
// payloads at |R| = 13,107,200: >= 0.016 / 0.031 ms on an H100 (3.35 TB/s).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int RSTATS_THREADS = 256;
constexpr int RSTATS_MAX_H = 1024;
constexpr int RSTATS_MAX_BLOCKS = 132 * 8;

struct Groups {
  const int* key;            // sorted candidates
  int h;
  unsigned long long* cnt;   // per sorted position (a group's first)
  unsigned int* pay;

  // Sorted position of the first candidate equal to k, or -1.
  __device__ __forceinline__ int find(int k) const {
    if (k < 0 || k < key[0] || k > key[h - 1]) return -1;
    int lo = 0;
    int hi = h;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key[mid] < k) lo = mid + 1; else hi = mid;
    }
    return key[lo] == k ? lo : -1;
  }

  template <bool PAY>
  __device__ __forceinline__ void visit(int k, int p) const {
    const int g = find(k);
    if (g < 0) return;
    atomicAdd(&cnt[g], 1ull);
    if (PAY) atomicAdd(&pay[g], (unsigned)p);
  }
};

template <bool PAY>
__global__ void __launch_bounds__(RSTATS_THREADS) rstats_kernel(
    const int* __restrict__ rk, const int* __restrict__ rp, long long n,
    long long head, const int* __restrict__ hk, int h,
    unsigned long long* __restrict__ cnt, unsigned int* __restrict__ pay) {
  extern __shared__ unsigned long long s_cnt[];              // h
  unsigned int* s_pay = reinterpret_cast<unsigned int*>(s_cnt + h);  // h
  int* s_key = reinterpret_cast<int*>(s_pay + h);            // h, sorted
  // each candidate goes to its rank (ties by slot), so s_key is sorted
  for (int t = threadIdx.x; t < h; t += blockDim.x) {
    const int v = hk[t];
    int r = 0;
    for (int u = 0; u < h; ++u) {
      const int w = hk[u];
      r += (w < v) || (w == v && u < t);
    }
    s_key[r] = v;
    s_cnt[t] = 0ull;
    s_pay[t] = 0u;
  }
  __syncthreads();
  const Groups grp{s_key, h, s_cnt, s_pay};
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // rows [0, head) one by one, then 16-byte loads, then the rest
  for (long long i = tid; i < head; i += stride)
    grp.visit<PAY>(rk[i], PAY ? rp[i] : 0);
  const long long nv = (n - head) / 4;
  const int4* k4 = reinterpret_cast<const int4*>(rk + head);
  const int4* p4 = reinterpret_cast<const int4*>(PAY ? rp + head : rk);
  for (long long v = tid; v < nv; v += stride) {
    const int4 k = k4[v];
    const int4 p = PAY ? p4[v] : make_int4(0, 0, 0, 0);
    grp.visit<PAY>(k.x, p.x);
    grp.visit<PAY>(k.y, p.y);
    grp.visit<PAY>(k.z, p.z);
    grp.visit<PAY>(k.w, p.w);
  }
  for (long long i = head + nv * 4 + tid; i < n; i += stride)
    grp.visit<PAY>(rk[i], PAY ? rp[i] : 0);
  __syncthreads();
  for (int t = threadIdx.x; t < h; t += blockDim.x) {
    const int g = grp.find(hk[t]);
    if (g < 0 || s_cnt[g] == 0ull) continue;
    atomicAdd(&cnt[t], s_cnt[g]);
    if (PAY) atomicAdd(&pay[t], s_pay[g]);
  }
}

}  // namespace

extern "C" {

// Largest number of candidate slots rstats takes.
int rstats_max_h() { return RSTATS_MAX_H; }

// rk[n] (+ rp[n], or null), hk[h] -> cnt[h] (+ pay[h]), accumulated: the
// caller zeroes them.
int rstats(const int* rk, const int* rp, long long n, const int* hk, int h,
           unsigned long long* cnt, unsigned int* pay, void* stream) {
  if (h < 1 || h > RSTATS_MAX_H) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the elements before rk's first 16-byte boundary go one by one; when rp
  // is not aligned alike, every element does
  const uintptr_t mis = (uintptr_t)rk & 15u;
  long long head = (long long)(((16u - mis) & 15u) / 4u);
  if (rp && (((uintptr_t)rp & 15u) != mis)) head = n;
  if (head > n) head = n;
  long long blocks = (n + RSTATS_THREADS * 16 - 1) / (RSTATS_THREADS * 16);
  if (blocks < 1) blocks = 1;
  if (blocks > RSTATS_MAX_BLOCKS) blocks = RSTATS_MAX_BLOCKS;
  const size_t smem =
      (size_t)h * (sizeof(unsigned long long) + 2 * sizeof(int));
  if (rp)
    rstats_kernel<true><<<(unsigned)blocks, RSTATS_THREADS, smem, st>>>(
        rk, rp, n, head, hk, h, cnt, pay);
  else
    rstats_kernel<false><<<(unsigned)blocks, RSTATS_THREADS, smem, st>>>(
        rk, nullptr, n, head, hk, h, cnt, pay);
  return (int)cudaGetLastError();
}

}  // extern "C"
