// Hopper kernels of the segment scatter: copy row segments of one or two
// (rows, 128) int32 arrays to destination offsets in an output buffer.
//
//   scatter_segments      replaces _make_scatter_kernel
//                         (aqp_tpu/ops/pallas/compact.py:157), launched by
//                         scatter_segments (compact.py:280): key + payload.
//   scatter_segments_one  replaces _make_scatter_kernel_one (compact.py:299),
//                         launched by scatter_segments_one (compact.py:368):
//                         one array.
//
// Segment i copies rows [soff_i, soff_i + sz_i) of the source to rows
// [doff_i, doff_i + sz_i) of the output.  The output is pre-filled by the
// caller (the key array with its fill key, the payload with 0), so rows no
// segment covers keep the fill.  Segments must not overlap in the output
// (the compactor's segments never do).  A segment with sz <= 0, or whose
// start lies outside [0, out_rows), copies nothing; rows past out_rows are
// cut, and source rows are clamped to [0, src_rows), as the gather
// formulation of the reference (compact.py:219-242) does.
//
// Design.  The TPU issues one dynamic-size DMA per segment through a ring of
// semaphores, and aims empty segments at a trash row only to arm those
// semaphores.  A CTA needs no DMA engine: grid (segment, slice) and every
// thread copies 16-byte vectors (one row = 32 int4), neighbouring threads on
// neighbouring addresses.  Empty segments simply return.
//
// Bound: the bytes of the rows the segments cover, read once and written
// once (plus the caller's pre-fill of the output).  The copy is a stream of
// coalesced 16-byte loads and stores, so it should run near the memory rate
// once the segments are long enough to fill the card.

#include <cuda_runtime.h>

namespace {

constexpr int SCATTER_COPY_THREADS = 256;
constexpr int VEC_PER_ROW = 128 / 4;  // int4 vectors in one 128-wide row

template <bool PAY>
__global__ void __launch_bounds__(SCATTER_COPY_THREADS) scatter_kernel(
    const int4* __restrict__ ks, const int4* __restrict__ ps,
    const int* __restrict__ soff, const int* __restrict__ doff,
    const int* __restrict__ sz, long long src_rows, long long out_rows,
    int4* __restrict__ ok, int4* __restrict__ op) {
  const int seg = blockIdx.x;
  const long long n = sz[seg];
  const long long d0 = doff[seg];
  if (n <= 0 || d0 < 0 || d0 >= out_rows) return;
  const long long s0 = soff[seg];
  const long long rows = n < out_rows - d0 ? n : out_rows - d0;
  const long long vecs = rows * VEC_PER_ROW;
  const long long step = (long long)gridDim.y * blockDim.x;
  for (long long v = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       v < vecs; v += step) {
    const long long r = v / VEC_PER_ROW;
    const int c = (int)(v % VEC_PER_ROW);
    long long s = s0 + r;
    s = s < 0 ? 0 : (s >= src_rows ? src_rows - 1 : s);
    const long long di = (d0 + r) * VEC_PER_ROW + c;
    const long long si = s * VEC_PER_ROW + c;
    ok[di] = ks[si];
    if (PAY) op[di] = ps[si];
  }
}

}  // namespace

extern "C" {

// ks (and ps, or null): src_rows x 128 int32; soff/doff/sz: nseg int32 on
// the device; ok (and op): out_rows x 128 int32, pre-filled.  All pointers
// 16-byte aligned.
int scatter_segments(const int* ks, const int* ps, const int* soff,
                     const int* doff, const int* sz, int nseg,
                     long long src_rows, long long out_rows, int* ok,
                     int* op, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nseg <= 0 || src_rows <= 0 || out_rows <= 0) return 0;
  // enough CTAs in flight to fill 132 SMs even with few segments
  int slices = (4 * 132 + nseg - 1) / nseg;
  slices = slices < 1 ? 1 : (slices > 64 ? 64 : slices);
  const dim3 grid(nseg, slices);
  if (ps)
    scatter_kernel<true><<<grid, SCATTER_COPY_THREADS, 0, st>>>(
        reinterpret_cast<const int4*>(ks), reinterpret_cast<const int4*>(ps),
        soff, doff, sz, src_rows, out_rows, reinterpret_cast<int4*>(ok),
        reinterpret_cast<int4*>(op));
  else
    scatter_kernel<false><<<grid, SCATTER_COPY_THREADS, 0, st>>>(
        reinterpret_cast<const int4*>(ks), nullptr, soff, doff, sz, src_rows,
        out_rows, reinterpret_cast<int4*>(ok), nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
