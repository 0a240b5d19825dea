// Hopper kernels of the fixed-slot two-level RHO count join.
//
// They replace the three Pallas kernels of aqp_tpu/ops/pallas/rho3.py that
// the count path runs.  Each kernel computes what its Pallas counterpart
// computes, with a layout chosen for an SM instead of a TPU core:
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
// Why the design differs from the TPU's: a K1 block at the default geometry
// is 131072 keys (512 KB, 1 MB with payloads) and a K3 region can hold
// 131072 keys too; neither fits in the 227 KB of shared memory a CTA can
// have.  So the TPU's "sort the whole block, then cut slots out of it"
// becomes "bucket, then sort":
//   K1  = k1_scatter_kernel (one CTA per block: a shared-memory counter per
//         level-1 bucket hands out slot positions with atomicAdd, so every
//         key is read once and written once) + slot_sort_kernel (one CTA
//         per slot: bitonic sort of the slot in shared memory, pads written
//         after the real elements).
//   K2  = k2_scatter_kernel (one CTA per window, f2 shared counters) +
//         slot_sort_kernel.
//   K3  = region_join_kernel (region_join.cuh, shared with nphj.cu's
//         K3TWO): one CTA per (region, probe run).  The probe run is staged
//         in shared memory; every run of the region is staged in turn and
//         each unmatched S element binary-searches it for its R partner
//         (packed key - 1).  K3 probes and searches the same array.
//   K3M = the same kernel with its output columns.
// A "kernel" of the Python side (K1, K2) is thus two launches.
//
// Slot semantics.  A slot holds its real elements first, sorted by (key,
// payload as unsigned), then KEY_PAD_INT with payload 0 up to its capacity;
// the slot's count says how many are real.  Capacity is counted in
// elements (slot_rows*128), where the Pallas extraction counts rows of the
// sorted block, so it is never smaller: wherever the TPU pipeline reports
// no overflow, this one reports none either.  Overflow is the number of
// elements that did not fit.  Which elements of an overflowing slot are
// kept depends on the order of the atomics, so an overflowing result is
// only ever reported, never used.
//
// Numerics.  Build without --use_fast_math.  fine_bucket() must reproduce
// the float32 rounding of rho3._fine_bucket bit for bit: int -> float
// rounds to nearest (__int2float_rn), the product rounds to nearest
// (__fmul_rn, which also keeps the compiler from contracting it into an
// FMA), and the conversion back truncates (__float2int_rz).
//
// Bounds at the headline size (13,107,200 R + 52,428,800 S keys, default
// Rho3Params: nb = 512 blocks, f1 = 36, f2 = 16, nbg = 16; H100 HBM
// 3.35 TB/s), counting each input byte read once and each output byte
// written once:
//   K1  keys-only reads 262 MB of keys and writes the 302 MB slot array:
//       >= 0.17 ms (twice that with payloads).  The scatter reads each key
//       once, coalesced; the slot sort reads and writes each slot once
//       more, so this design moves about 1.6x the bound's bytes.
//   K2  reads the 262 MB of real slot elements (the counts say where they
//       end, padding is never read) and writes the 302 MB fine-slot array:
//       >= 0.17 ms keys-only.  Same 1.6x as K1.
//   K3  reads the 262 MB of real fine-slot elements: >= 0.08 ms keys-only.
//       Each run is staged once per probe run of its region (nbg times),
//       which L2 serves; the binary searches run in shared memory.
//   K3M reads the real fine-slot elements with payloads (524 MB) and writes
//       three columns of the fine-slot array's length (3 x 302 MB): >=
//       0.43 ms.  It reads as K3 does; each output position is written once,
//       the holes included, so no pre-fill pass is needed.
// None of the three is near its bound yet; PERF.md has the measured times.

#include <cuda_runtime.h>

#include "region_join.cuh"

namespace {

constexpr int KEY_PAD_INT = 2147483647;
constexpr int SCATTER_THREADS = 1024;

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
__device__ __forceinline__ unsigned long long pack64(int key, int pay) {
  return ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) |
         (unsigned)pay;
}
__device__ __forceinline__ int key_of(unsigned long long v) {
  return (int)((unsigned)(v >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int pay_of(unsigned long long v) {
  return (int)(unsigned)v;
}

// Ascending bitonic sort of s[0, n), n a power of two, by the whole CTA.
template <typename T>
__device__ void bitonic_sort_shared(T* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (n >> 1); q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int l = i | j;
        const T a = s[i];
        const T b = s[l];
        const bool up = (i & k) == 0;
        if ((a > b) == up) {
          s[i] = b;
          s[l] = a;
        }
      }
      __syncthreads();
    }
  }
}

// K1, first launch: one CTA per block of block_elems keys.
template <bool PAY>
__global__ void __launch_bounds__(SCATTER_THREADS) k1_scatter_kernel(
    const int* __restrict__ keys, const int* __restrict__ pay, long long n,
    int block_elems, int f1, int f2, float scale, int cap1,
    int* __restrict__ out_k, int* __restrict__ out_p, int* __restrict__ cnt1,
    unsigned long long* __restrict__ ovf) {
  extern __shared__ int s_cnt[];  // f1 counters
  const int gmax = f1 * f2;
  for (int f = threadIdx.x; f < f1; f += blockDim.x) s_cnt[f] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * block_elems;
  long long lim = n - base;
  if (lim > block_elems) lim = block_elems;
  for (long long e = threadIdx.x; e < lim; e += blockDim.x) {
    const int k = keys[base + e];
    const int g = fine_bucket(k, scale, gmax);
    if (g < 0 || g >= gmax) continue;  // pads are dropped
    const int f = g / f2;
    const int pos = atomicAdd(&s_cnt[f], 1);
    if (pos < cap1) {
      const size_t o = ((size_t)blockIdx.x * f1 + f) * cap1 + pos;
      out_k[o] = k;
      if (PAY) out_p[o] = pay[base + e];
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < f1; f += blockDim.x) {
    const int c = s_cnt[f];
    cnt1[(size_t)blockIdx.x * f1 + f] = min(c, cap1);
    if (c > cap1) atomicAdd(ovf, (unsigned long long)(c - cap1));
  }
}

// K2, first launch: one CTA per window (level-1 bucket f, group g).
template <bool PAY>
__global__ void __launch_bounds__(SCATTER_THREADS) k2_scatter_kernel(
    const int* __restrict__ k1, const int* __restrict__ p1,
    const int* __restrict__ cnt1, int f1, int group, int cap1, int f2,
    int nbg, float scale, int cap2, int* __restrict__ out_k,
    int* __restrict__ out_p, int* __restrict__ cnt2,
    unsigned long long* __restrict__ ovf) {
  extern __shared__ int s_cnt[];  // f2 counters
  const int f = blockIdx.x / nbg;
  const int g = blockIdx.x % nbg;
  const int gmax = f1 * f2;
  for (int b = threadIdx.x; b < f2; b += blockDim.x) s_cnt[b] = 0;
  __syncthreads();
  const size_t out_base = ((size_t)f * nbg + g) * f2;
  for (int bi = 0; bi < group; ++bi) {
    const size_t slot = (size_t)(g * group + bi) * f1 + f;
    const int c = cnt1[slot];
    const int* src_k = k1 + slot * cap1;
    for (int e = threadIdx.x; e < c; e += blockDim.x) {
      const int k = src_k[e];
      const int loc = fine_bucket(k, scale, gmax) - f * f2;
      if (loc < 0 || loc >= f2) continue;  // not this window's: K1 never sends one
      const int pos = atomicAdd(&s_cnt[loc], 1);
      if (pos < cap2) {
        const size_t o = (out_base + loc) * cap2 + pos;
        out_k[o] = k;
        if (PAY) out_p[o] = p1[slot * cap1 + e];
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < f2; b += blockDim.x) {
    const int c = s_cnt[b];
    cnt2[out_base + b] = min(c, cap2);
    if (c > cap2) atomicAdd(ovf, (unsigned long long)(c - cap2));
  }
}

// Second launch of K1 and K2: one CTA per slot of capacity cap.  Sorts the
// slot's cnt real elements and writes pads behind them.
template <bool PAY>
__global__ void slot_sort_kernel(int* __restrict__ k, int* __restrict__ p,
                                 const int* __restrict__ cnt, int cap) {
  extern __shared__ unsigned long long s_sort[];
  const size_t off = (size_t)blockIdx.x * cap;
  const int c = cnt[blockIdx.x];
  int n2 = 1;
  while (n2 < c) n2 <<= 1;
  if (PAY) {
    unsigned long long* s = s_sort;
    for (int i = threadIdx.x; i < n2; i += blockDim.x)
      s[i] = i < c ? pack64(k[off + i], p[off + i]) : ~0ull;
    __syncthreads();
    bitonic_sort_shared(s, n2);
    for (int i = threadIdx.x; i < cap; i += blockDim.x) {
      const bool real = i < c;
      k[off + i] = real ? key_of(s[i]) : KEY_PAD_INT;
      p[off + i] = real ? pay_of(s[i]) : 0;
    }
  } else {
    int* s = reinterpret_cast<int*>(s_sort);
    for (int i = threadIdx.x; i < n2; i += blockDim.x)
      s[i] = i < c ? k[off + i] : KEY_PAD_INT;
    __syncthreads();
    bitonic_sort_shared(s, n2);
    for (int i = threadIdx.x; i < cap; i += blockDim.x)
      k[off + i] = i < c ? s[i] : KEY_PAD_INT;
  }
}

int sort_threads(int n_pow2) {
  int t = n_pow2 / 2;
  if (t < 32) t = 32;
  if (t > 1024) t = 1024;
  return t;
}

int next_pow2(int x) {
  int n = 1;
  while (n < x) n <<= 1;
  return n;
}

template <bool PAY>
cudaError_t launch_slot_sort(int* k, int* p, const int* cnt, int nslots,
                             int cap, cudaStream_t stream) {
  const int n2 = next_pow2(cap);
  const size_t smem = (size_t)n2 * (PAY ? 8 : 4);
  cudaError_t err = cudaFuncSetAttribute(
      slot_sort_kernel<PAY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (nslots > 0)
    slot_sort_kernel<PAY><<<nslots, sort_threads(n2), smem, stream>>>(k, p, cnt, cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rho3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1: keys[n] (+ pay[n], or null) -> out_k/out_p[nb][f1][cap1], cnt1[nb][f1];
// adds the overflow to *ovf.  Keys at index >= n are pads.
int rho3_k1(const int* keys, const int* pay, long long n, int nb,
            int block_elems, int f1, int f2, float scale, int cap1,
            int* out_k, int* out_p, int* cnt1, unsigned long long* ovf,
            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)f1 * sizeof(int);
  if (pay)
    k1_scatter_kernel<true><<<nb, SCATTER_THREADS, smem, st>>>(
        keys, pay, n, block_elems, f1, f2, scale, cap1, out_k, out_p, cnt1, ovf);
  else
    k1_scatter_kernel<false><<<nb, SCATTER_THREADS, smem, st>>>(
        keys, nullptr, n, block_elems, f1, f2, scale, cap1, out_k, nullptr,
        cnt1, ovf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = pay ? launch_slot_sort<true>(out_k, out_p, cnt1, nb * f1, cap1, st)
            : launch_slot_sort<false>(out_k, nullptr, cnt1, nb * f1, cap1, st);
  return (int)err;
}

// K2: K1's slots -> out_k/out_p[f1][nbg][f2][cap2], cnt2[f1][nbg][f2];
// adds the overflow to *ovf.
int rho3_k2(const int* k1, const int* p1, const int* cnt1, int f1, int group,
            int cap1, int f2, int nbg, float scale, int cap2, int* out_k,
            int* out_p, int* cnt2, unsigned long long* ovf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)f2 * sizeof(int);
  const int grid = f1 * nbg;
  if (p1)
    k2_scatter_kernel<true><<<grid, SCATTER_THREADS, smem, st>>>(
        k1, p1, cnt1, f1, group, cap1, f2, nbg, scale, cap2, out_k, out_p,
        cnt2, ovf);
  else
    k2_scatter_kernel<false><<<grid, SCATTER_THREADS, smem, st>>>(
        k1, nullptr, cnt1, f1, group, cap1, f2, nbg, scale, cap2, out_k,
        nullptr, cnt2, ovf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = p1 ? launch_slot_sort<true>(out_k, out_p, cnt2, grid * f2, cap2, st)
           : launch_slot_sort<false>(out_k, nullptr, cnt2, grid * f2, cap2, st);
  return (int)err;
}

// Shared memory K3 needs for a fine-slot capacity of cap2.
long long rho3_k3_smem(int cap2, int with_payload) {
  return region_join_smem(cap2, with_payload != 0);
}

// Largest fine-slot capacity K3's per-thread match mask covers.
int rho3_k3_max_cap() { return RJ_THREADS * RJ_MAX_PER_THREAD; }

// K3: K2's fine slots -> *matches, *checksum (both accumulated; the caller
// zeroes them).
int rho3_k3(const int* k2, const int* p2, const int* cnt2, int f1, int nbg,
            int f2, int cap2, unsigned long long* matches,
            unsigned int* checksum, void* stream) {
  const Runs runs{k2, p2, cnt2, nbg};
  return (int)launch_region_join(runs, runs, f1, f2, cap2, 0, false, Cols{},
                                 matches, checksum, (cudaStream_t)stream);
}

// K3M: K2's fine slots with payloads -> ok/orp/osp[f1][nbg][f2][cap2] (every
// position written), *matches, *checksum (accumulated; the caller zeroes
// them).
int rho3_k3m(const int* k2, const int* p2, const int* cnt2, int f1, int nbg,
             int f2, int cap2, int inv, int* ok, int* orp, int* osp,
             unsigned long long* matches, unsigned int* checksum,
             void* stream) {
  const Runs runs{k2, p2, cnt2, nbg};
  // output position of slot (a, j, b) = its position in K2's layout
  const Cols out{ok, orp, osp, (long long)nbg * f2 * cap2, cap2,
                 (long long)f2 * cap2, 0};
  return (int)launch_region_join(runs, runs, f1, f2, cap2, inv, true, out,
                                 matches, checksum, (cudaStream_t)stream);
}

}  // extern "C"
