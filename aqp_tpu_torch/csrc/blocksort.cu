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
// The TPU kernels sort a column-major (sub, 128) tile and turn it row-major
// again; their net effect is one sort of each block in flat order, which is
// what these kernels compute, with no corner turns.
//
// Design.  A block is 16 Ki to 128 Ki pairs (128 KiB to 1 MiB as 64-bit
// values); a CTA has at most 227 KB of shared memory.  So the bitonic
// network over a block is cut at TILE = 16 Ki elements (128 KiB):
//   tile_kernel        one CTA per tile of TILE elements: stages k <= TILE
//                      of the network in shared memory (the first launch
//                      also packs the int32 inputs); launched again, one
//                      stage k > TILE from its distance TILE/2 down to 1;
//   global_stage_kernel  one compare-exchange at a distance j >= TILE, one
//                      thread per pair, in device memory (L2 holds much of
//                      it).
// The last launch writes the int32 outputs.  At sub = 128 (one tile a
// block) that is the only launch; at sub = 512, six launches move the data
// six times; at sub = 1024, ten.  The direction of a compare-exchange is
// that of the block-wide network (ascending iff (i & k) == 0, with i the
// element's index in its block), so tiles and blocks never mix.
//
// sort_hist adds row_starts_kernel: one CTA per block reads each row's
// leading key, buckets it (as rho3's fine bucket, float32 with
// round-to-nearest and truncation: build without --use_fast_math), counts
// the buckets in shared memory and writes the exclusive prefix.
//
// Bound: each pair read once and written once, 16 bytes a pair: 2^27 pairs
// are 2.15 GB, >= 0.64 ms at 3.35 TB/s.  This design moves the data
// 1 + (number of global stages) + (number of tile merges) times and runs
// log2(TILE) * (log2(TILE) + 1) / 2 = 105 shared-memory stages per tile
// first, so it is far from that bound; PERF.md has the measured times.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int LANES = 128;
constexpr int TILE = 16384;          // elements a CTA sorts in shared memory
constexpr int TILE_THREADS = 1024;
constexpr int STEP_THREADS = 256;
constexpr int HIST_THREADS = 256;
constexpr int PACKED_PAD_MIN = 2147483644;

__device__ __forceinline__ u64 pack64(int key, int pay) {
  return ((u64)((unsigned)key ^ 0x80000000u) << 32) | (unsigned)pay;
}
__device__ __forceinline__ int key_of(u64 v) {
  return (int)((unsigned)(v >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int pay_of(u64 v) { return (int)(unsigned)v; }

// One stage (k, j) of the network over the tile s[0, TILE), whose element
// i is element base + i of its block.
__device__ __forceinline__ void tile_stage(u64* s, int base, int k, int j) {
  for (int q = threadIdx.x; q < TILE / 2; q += blockDim.x) {
    const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
    const int l = i | j;
    const u64 a = s[i];
    const u64 b = s[l];
    const bool up = ((base + i) & k) == 0;
    if ((a > b) == up) {
      s[i] = b;
      s[l] = a;
    }
  }
  __syncthreads();
}

// Stages k_first..k_last (powers of two) of the network on each tile, each
// from distance min(k/2, TILE/2) down to 1.  FROM_INT: read the int32
// inputs, else the 64-bit work array; TO_INT: write the int32 outputs,
// else the work array (in place).
template <bool FROM_INT, bool TO_INT>
__global__ void __launch_bounds__(TILE_THREADS) tile_kernel(
    const int* __restrict__ key, const int* __restrict__ pay, u64* work,
    int* __restrict__ ok, int* __restrict__ op, int block_elems, int k_first,
    int k_last) {
  extern __shared__ u64 s_tile[];
  const size_t t0 = (size_t)blockIdx.x * TILE;
  const int base = (int)(t0 % (size_t)block_elems);
  for (int i = threadIdx.x; i < TILE; i += blockDim.x)
    s_tile[i] = FROM_INT ? pack64(key[t0 + i], pay[t0 + i]) : work[t0 + i];
  __syncthreads();
  for (int k = k_first; k <= k_last; k <<= 1)
    for (int j = min(k >> 1, TILE >> 1); j > 0; j >>= 1)
      tile_stage(s_tile, base, k, j);
  for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
    const u64 v = s_tile[i];
    if (TO_INT) {
      ok[t0 + i] = key_of(v);
      op[t0 + i] = pay_of(v);
    } else {
      work[t0 + i] = v;
    }
  }
}

// One stage (k, j), j >= TILE, of every block's network: one thread per
// compare-exchange pair.
__global__ void __launch_bounds__(STEP_THREADS) global_stage_kernel(
    u64* work, long long half_n, int block_elems, int k, int j) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= half_n) return;
  const int half_block = block_elems >> 1;
  const long long blk = q / half_block;
  const int qq = (int)(q - blk * half_block);
  const int i = ((qq & ~(j - 1)) << 1) | (qq & (j - 1));
  const int l = i | j;
  u64* b = work + blk * block_elems;
  const u64 x = b[i];
  const u64 y = b[l];
  const bool up = (i & k) == 0;
  if ((x > y) == up) {
    b[i] = y;
    b[l] = x;
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

template <bool FROM_INT, bool TO_INT>
cudaError_t launch_tiles(const int* key, const int* pay, u64* work, int* ok,
                         int* op, long long n, int block_elems, int k_first,
                         int k_last, cudaStream_t st) {
  const int smem = TILE * (int)sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<FROM_INT, TO_INT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tile_kernel<FROM_INT, TO_INT><<<(unsigned)(n / TILE), TILE_THREADS, smem,
                                  st>>>(key, pay, work, ok, op, block_elems,
                                        k_first, k_last);
  return cudaGetLastError();
}

bool valid_sub(int sub) {
  return sub >= 128 && sub <= 1024 && (sub & (sub - 1)) == 0;
}

// The whole network on every block of n pairs (n a multiple of sub*128).
// work: n 64-bit values of scratch, needed when a block exceeds one tile.
cudaError_t sort_launch(const int* key, const int* pay, long long n, int sub,
                        u64* work, int* ok, int* op, cudaStream_t st) {
  const int block = sub * LANES;
  if (!valid_sub(sub) || n < 0 || n % block) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (block == TILE)
    return launch_tiles<true, true>(key, pay, nullptr, ok, op, n, block, 2,
                                    TILE, st);
  if (!work) return cudaErrorInvalidValue;
  cudaError_t err = launch_tiles<true, false>(key, pay, work, nullptr,
                                              nullptr, n, block, 2, TILE, st);
  const long long half_n = n / 2;
  const unsigned step_grid =
      (unsigned)((half_n + STEP_THREADS - 1) / STEP_THREADS);
  for (int k = 2 * TILE; k <= block && err == cudaSuccess; k <<= 1) {
    for (int j = k >> 1; j >= TILE && err == cudaSuccess; j >>= 1) {
      global_stage_kernel<<<step_grid, STEP_THREADS, 0, st>>>(work, half_n,
                                                             block, k, j);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) break;
    err = k == block
              ? launch_tiles<false, true>(nullptr, nullptr, work, ok, op, n,
                                          block, k, k, st)
              : launch_tiles<false, false>(nullptr, nullptr, work, nullptr,
                                           nullptr, n, block, k, k, st);
  }
  return err;
}

}  // namespace

extern "C" {

// key, pay, ok, op: n int32 on the device, n a multiple of sub*128, sub a
// power of two in [128, 1024]; work: n 64-bit values when sub > 128, else
// may be null.
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
  return (int)cudaGetLastError();
}

}  // extern "C"
