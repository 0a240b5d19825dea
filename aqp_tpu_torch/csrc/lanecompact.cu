// Hopper kernel of the windowed range-mask compaction.
//
//   compact_windows  replaces _make_kernel
//                    (aqp_tpu/ops/pallas/lanecompact.py:209), launched by
//                    _compact_windows (lanecompact.py:322).
//
// The column (int32, or uint8 as the scan modes keep it) is cut into
// windows of `block` = w*128 elements.  For each window, the elements x
// with lo <= x <= hi are kept in order (a stable compaction), and for each
// kept element every output (one to three) gets one value, written to the
// window's output block of `cap` = ow*128 elements: the first
// min(count, cap) kept elements, then the output's fill value up to cap.
// What an output holds is its kind:
//   OUT_ARRAY    the same position of an int32 payload array (the join's
//                key and payload columns);
//   OUT_ROW_ID   the element's global row index, computed here: no arange
//                is read (scan_index_fast, scan_values_fast and
//                scan_dict_fast; fill PAD_S_INPUT);
//   OUT_VALUE    the column value itself, widened to int32 in registers
//                (scan_values_fast; no int32 copy of the column is read);
//   OUT_DICT_LO / OUT_DICT_HI
//                the column value (a code) decoded through a 256-entry
//                int32 plane of a dictionary, which each CTA stages in
//                shared memory once (scan_dict_fast, the reference's
//                _decode256 at lanecompact.py:196); the fill is the plane's
//                entry 0, as the reference decodes its code fill 0.
// The window's count is written UNCAPPED, so the caller sees a window that
// was cut (count > cap) and reports it as overflow.  Elements past n (the
// ragged last window) are never kept, so a uint8 column is read as bytes
// whatever n is (the reference widens it when n is not a multiple of w*128).
//
// Design.  The TPU has no compress instruction, so the Pallas kernel builds
// a lane-compaction map by recursive doubling and places rows with one-hot
// int8 matmuls on the MXU.  None of that carries over: a warp has a ballot.
// One CTA per window walks it in tiles of blockDim.x elements, one element
// per thread: the range mask, a warp ballot and __popc of the lanes below
// give the rank inside the warp, a scan of the 32 warp counts gives the rank
// inside the tile, and a running offset carried across tiles gives the rank
// inside the window.  Kept elements are written straight to their output
// position.
//
// Bound: the column is read once (n elements of 4 or 1 bytes), a payload
// array where its key is kept, and the output blocks written once (nb * cap
// elements each), plus the counts.  The kernel reads the column once and a
// payload element only where its key is kept (from cache when the payload
// is the column itself, as compact_kp_fast passes it); the writes of kept
// elements are coalesced within a warp (consecutive ranks).

#include <cuda_runtime.h>

namespace {

constexpr int COMPACT_THREADS = 1024;
constexpr int MAX_OUTS = 3;

enum OutKind { OUT_ARRAY = 0, OUT_ROW_ID = 1, OUT_VALUE = 2, OUT_DICT_LO = 3,
               OUT_DICT_HI = 4 };

struct Outs {
  int kind[MAX_OUTS];
  const int* src[MAX_OUTS];
  int fill[MAX_OUTS];
  int* out[MAX_OUTS];
};

// the reference's _decode256: entry (code >= 128 ? 128 : 0) + (code & 127)
__device__ __forceinline__ int dict_entry(int code) {
  return (code >= 128 ? 128 : 0) + (code & 127);
}

template <typename T, int NOUT, bool DICT>
__global__ void __launch_bounds__(COMPACT_THREADS) compact_windows_kernel(
    const T* __restrict__ col, long long n, int block, int lo, int hi,
    int cap, Outs o, const int* __restrict__ dict_lo,
    const int* __restrict__ dict_hi, int* __restrict__ counts) {
  __shared__ int s_warp[32];
  __shared__ int s_dict[DICT ? 512 : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long base = (long long)blockIdx.x * block;
  const long long out_base = (long long)blockIdx.x * cap;
  if (DICT) {
    for (int e = threadIdx.x; e < 512; e += blockDim.x)
      s_dict[e] = e < 256 ? dict_lo[e] : dict_hi[e - 256];
    __syncthreads();
  }
  int running = 0;  // kept elements of earlier tiles; equal in every thread
  for (int t0 = 0; t0 < block; t0 += blockDim.x) {
    const int e = t0 + threadIdx.x;
    const long long gi = base + e;
    bool keep = false;
    int x = 0;
    if (e < block && gi < n) {
      x = (int)col[gi];
      keep = x >= lo && x <= hi;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      int v = lane < nwarps ? s_warp[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      s_warp[lane] = v;  // inclusive prefix of the warp counts
    }
    __syncthreads();
    if (keep) {
      const int pos = running + (warp ? s_warp[warp - 1] : 0) +
                      __popc(bal & ((1u << lane) - 1u));
      if (pos < cap) {
#pragma unroll
        for (int k = 0; k < NOUT; ++k) {
          int val;
          switch (o.kind[k]) {
            case OUT_ARRAY: val = o.src[k][gi]; break;
            case OUT_ROW_ID: val = (int)gi; break;
            case OUT_VALUE: val = x; break;
            case OUT_DICT_LO: val = DICT ? s_dict[dict_entry(x)] : 0; break;
            default: val = DICT ? s_dict[256 + dict_entry(x)] : 0; break;
          }
          o.out[k][out_base + pos] = val;
        }
      }
    }
    running += s_warp[nwarps - 1];
    __syncthreads();  // the next tile overwrites s_warp
  }
  const int kept = running < cap ? running : cap;
#pragma unroll
  for (int k = 0; k < NOUT; ++k) {
    int fill = o.fill[k];
    if (DICT && o.kind[k] == OUT_DICT_LO) fill = s_dict[0];
    if (DICT && o.kind[k] == OUT_DICT_HI) fill = s_dict[256];
    for (int p = kept + threadIdx.x; p < cap; p += blockDim.x)
      o.out[k][out_base + p] = fill;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = running;
}

template <typename T, int NOUT>
void launch(const void* col, long long n, int block, int lo, int hi,
            int cap, const Outs& o, bool dict, const int* dict_lo,
            const int* dict_hi, int* counts, cudaStream_t st) {
  const unsigned nb = (unsigned)((n + block - 1) / block);
  const T* c = static_cast<const T*>(col);
  if (dict)
    compact_windows_kernel<T, NOUT, true><<<nb, COMPACT_THREADS, 0, st>>>(
        c, n, block, lo, hi, cap, o, dict_lo, dict_hi, counts);
  else
    compact_windows_kernel<T, NOUT, false><<<nb, COMPACT_THREADS, 0, st>>>(
        c, n, block, lo, hi, cap, o, nullptr, nullptr, counts);
}

template <typename T>
void launch_n(int nout, const void* col, long long n, int block, int lo,
              int hi, int cap, const Outs& o, bool dict, const int* dict_lo,
              const int* dict_hi, int* counts, cudaStream_t st) {
  if (nout == 1)
    launch<T, 1>(col, n, block, lo, hi, cap, o, dict, dict_lo, dict_hi,
                 counts, st);
  else if (nout == 2)
    launch<T, 2>(col, n, block, lo, hi, cap, o, dict, dict_lo, dict_hi,
                 counts, st);
  else
    launch<T, 3>(col, n, block, lo, hi, cap, o, dict, dict_lo, dict_hi,
                 counts, st);
}

}  // namespace

extern "C" {

// col[n] (int32, or uint8 when col_u8) -> for each of the nout outputs k,
// out_k[nb][cap] of kind kind_k (OutKind above; src_k is the payload array
// for OUT_ARRAY, else unused), fill_k past the window's count (the
// dictionary kinds fill with their plane's entry 0 instead); counts[nb]
// with nb = ceil(n / block).  dict_lo/dict_hi: 256 int32 each, read only
// when an output is of a dictionary kind.
int compact_windows(const void* col, int col_u8, long long n, int block,
                    int lo, int hi, int cap, int nout, int kind0, int kind1,
                    int kind2, const int* src0, const int* src1,
                    const int* src2, int fill0, int fill1, int fill2,
                    int* o0, int* o1, int* o2, const int* dict_lo,
                    const int* dict_hi, int* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (nout < 1 || nout > MAX_OUTS) return (int)cudaErrorInvalidValue;
  Outs o = {{kind0, kind1, kind2}, {src0, src1, src2}, {fill0, fill1, fill2},
            {o0, o1, o2}};
  bool dict = false;
  for (int k = 0; k < nout; ++k) {
    if (o.kind[k] < OUT_ARRAY || o.kind[k] > OUT_DICT_HI)
      return (int)cudaErrorInvalidValue;
    if (o.kind[k] >= OUT_DICT_LO) dict = true;
  }
  if (dict && (!dict_lo || !dict_hi)) return (int)cudaErrorInvalidValue;
  if (col_u8)
    launch_n<unsigned char>(nout, col, n, block, lo, hi, cap, o, dict,
                            dict_lo, dict_hi, counts, st);
  else
    launch_n<int>(nout, col, n, block, lo, hi, cap, o, dict, dict_lo,
                  dict_hi, counts, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
