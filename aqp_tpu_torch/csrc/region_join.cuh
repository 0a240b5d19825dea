// The region join shared by rho3.cu (K3, K3M) and nphj.cu (K3TWO,
// K3TWO_MAT).
//
// Fine slots have K2's layout: keys (and payloads) of shape
// (f1, nbg, f2, cap2), counts (f1, nbg, f2); a slot holds its real elements
// first, sorted by (key, payload as unsigned).  A region is one (f1, f2)
// bucket pair: `nbg` runs, one slot each.  An S element (odd packed key k)
// matches when a run of its region in the SEARCHED runs holds k - 1, its R
// partner.
//
// One CTA per (region, probe run j): it stages its probe slot in shared
// memory, stages each searched run of the region in turn, and each still
// unmatched S element binary-searches it.  Runs are searched in index order
// and the first one that holds the partner decides; within a run the lowest
// (key, payload) copy answers, so a duplicate R key still counts each S
// element once and the checksum is deterministic.  Matches and the checksum
// leave the CTA through integer atomicAdd; an unsigned 32-bit atomicAdd
// wraps mod 2^32, so the checksum is exact and independent of order.
//
// K3 and K3M probe and search the same array (RHO's union of R and S).
// K3TWO and K3TWO_MAT probe S's slots and search the table's, two arrays
// with their own run counts, so the persistent table is read where it lies.
//
// With MAT, the CTA of (region, j) owns the output positions of its slot
// (a * sa + b * sb + j * sj, + cap2): a matched S element writes
// (((k >> 1) * inv) mod 2^30, R payload, S payload) at its own position,
// every other position gets (-3, 0, 0).  `tail` more chunks of cap2 per
// region, after the probe runs' slots, are holes too; the CTA of run j
// writes the chunks j, j + nbg, ... of them.  inv is the salt's inverse mod
// 2^30, so the first column is the original key.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int RJ_THREADS = 512;
// A thread tracks which of its probe elements matched in one 64-bit mask.
constexpr int RJ_MAX_PER_THREAD = 64;

struct Runs {
  const int* k;    // (f1, nbg, f2, cap2) keys
  const int* p;    // payloads of the same shape, or null
  const int* cnt;  // (f1, nbg, f2) real elements per slot
  int nbg;
};

struct Cols {  // materialized columns (MAT only)
  int* k;
  int* rp;
  int* sp;
  long long sa, sb, sj;  // element offsets of region (a, b) and probe run j
  int tail;              // hole chunks of cap2 per region after the runs
};

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

template <bool PAY, bool MAT>
__global__ void __launch_bounds__(RJ_THREADS) region_join_kernel(
    Runs probe, Runs table, int f2, int cap2, int inv, Cols out,
    unsigned long long* __restrict__ matches,
    unsigned int* __restrict__ checksum) {
  extern __shared__ int smem[];
  int* s_probe = smem;           // probe slot keys
  int* s_rk = smem + cap2;       // searched run keys
  int* s_rp = smem + 2 * cap2;   // searched run payloads (PAY only)
  const int j = blockIdx.x % probe.nbg;
  const int region = blockIdx.x / probe.nbg;
  const int a = region / f2;
  const int b = region % f2;
  const size_t cnt_j = ((size_t)a * probe.nbg + j) * f2 + b;
  const int cj = probe.cnt[cnt_j];
  if (!MAT && cj == 0) return;
  const size_t off_j = cnt_j * cap2;
  int has_s = 0;
  for (int e = threadIdx.x; e < cj; e += blockDim.x) {
    const int k = probe.k[off_j + e];
    s_probe[e] = k;
    has_s |= k & 1;
  }
  const int any_s = __syncthreads_or(has_s);
  if (!MAT && !any_s) return;
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
      if (PAY) s_rp[e] = table.p[off_i + e];
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
          if (PAY) {
            const int rp = s_rp[lo];
            const int sp = probe.p[off_j + e];
            my_c += (unsigned)rp + (unsigned)sp;
            if (MAT) {
              out.k[out_j + e] =
                  (int)(((unsigned)(k >> 1) * (unsigned)inv) & 0x3FFFFFFFu);
              out.rp[out_j + e] = rp;
              out.sp[out_j + e] = sp;
            }
          }
        }
      }
    }
    __syncthreads();  // the next run overwrites s_rk / s_rp
  }
  if (MAT) {
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
  }
  my_m = warp_sum(my_m);
  if (PAY) my_c = warp_sum(my_c);
  if ((threadIdx.x & 31) == 0) {
    if (my_m) atomicAdd(matches, (unsigned long long)my_m);
    if (PAY && my_c) atomicAdd(checksum, my_c);
  }
}

// Shared memory the region join needs for a fine-slot capacity of cap2.
inline long long region_join_smem(int cap2, bool pay) {
  return (long long)cap2 * sizeof(int) * (pay ? 3 : 2);
}

template <bool PAY, bool MAT>
cudaError_t launch_region_join_as(Runs probe, Runs table, int f1, int f2,
                                  int cap2, int inv, Cols out,
                                  unsigned long long* matches,
                                  unsigned int* checksum, cudaStream_t st) {
  const size_t smem = (size_t)region_join_smem(cap2, PAY);
  cudaError_t err = cudaFuncSetAttribute(
      region_join_kernel<PAY, MAT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)f1 * f2 * probe.nbg;
  if (grid > 0)
    region_join_kernel<PAY, MAT><<<(unsigned)grid, RJ_THREADS, smem, st>>>(
        probe, table, f2, cap2, inv, out, matches, checksum);
  return cudaGetLastError();
}

// The region join of probe's slots against table's (both with payloads or
// neither); with `mat`, also the columns of `out` (payloads required).
inline cudaError_t launch_region_join(Runs probe, Runs table, int f1, int f2,
                                      int cap2, int inv, bool mat, Cols out,
                                      unsigned long long* matches,
                                      unsigned int* checksum,
                                      cudaStream_t st) {
  if ((probe.p == nullptr) != (table.p == nullptr))
    return cudaErrorInvalidValue;
  if (cap2 > RJ_THREADS * RJ_MAX_PER_THREAD) return cudaErrorInvalidValue;
  if (mat) {
    if (probe.p == nullptr) return cudaErrorInvalidValue;
    return launch_region_join_as<true, true>(probe, table, f1, f2, cap2, inv,
                                             out, matches, checksum, st);
  }
  if (probe.p)
    return launch_region_join_as<true, false>(probe, table, f1, f2, cap2, 0,
                                              out, matches, checksum, st);
  return launch_region_join_as<false, false>(probe, table, f1, f2, cap2, 0,
                                             out, matches, checksum, st);
}

}  // namespace
