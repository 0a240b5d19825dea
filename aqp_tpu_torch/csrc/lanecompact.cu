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
// The outputs come in the wrapper's order (row ids, payload arrays, the
// values, the dictionary's planes), and each such form is a template of
// its own, so the kind of each output is known where a value is written.
// The window's count is written UNCAPPED, so the caller sees a window that
// was cut (count > cap) and reports it as overflow.  Elements past n (the
// ragged last window) are never kept, so a uint8 column is read as bytes
// whatever n is (the reference widens it when n is not a multiple of w*128).
//
// Bound: the column is read once (n elements of 4 or 1 bytes), a payload
// array where its key is kept, and the output blocks written once (nb * cap
// elements each), plus the counts.  A byte column at 10% kept writes 0.7
// (row ids) to 2.1 (row ids and a dictionary's planes) bytes for each byte
// it reads, so the kernel is bound by HBM, and to reach its rate an SM
// needs ~25 KB of loads in flight (Little's law at ~1 us of latency).
//
// Design.  The TPU has no compress instruction, so the Pallas kernel builds
// a lane-compaction map by recursive doubling and places rows with one-hot
// int8 matmuls on the MXU.  None of that carries over.  One CTA of 256
// threads per window walks it in tiles of 256 x LC_U 16-byte vectors
// (16 KB: 16,384 bytes or 4,096 int32), vector u * 256 + t of a tile to
// thread t, so each load instruction of a warp reads 512 contiguous bytes:
//   - Loads.  A thread holds LC_U vectors in flight, and loads the next
//     tile's as soon as it has the keep bits of this one, so the loads of
//     one tile overlap the scan and the writes of the last (4 CTAs an SM,
//     3 where the writes need the values: 48-64 KB in flight).  The keep
//     bits of a byte vector come from SIMD byte compares (x - lo <= hi -
//     lo, per byte), 16 bits a vector.
//   - Ranks.  One scan a tile: a thread's LC_U vector counts (__popc of
//     their bits) packed into one 64-bit word of 16-bit fields, a warp's
//     inclusive scan by __shfl_up_sync, the 8 warp totals through shared
//     memory (double-buffered, so one __syncthreads a tile).  A kept
//     element's rank in its window is the count carried from earlier tiles
//     (a register, equal in every thread), the totals of the tile's earlier
//     vector rows, the thread's exclusive prefix in its row and the bits
//     below it in its vector.  A window is 4 (uint8) or 16 (int32) tiles at
//     w = 512.
//   - Writes.  Each warp stages its kept elements of a vector row in
//     shared memory in rank order (a thread walks the set bits of its
//     vector; a byte's entry carries its place in the tile and its value),
//     then writes them out, 32 consecutive positions a store, up to `cap`:
//     whether the kept elements of a row spread over the lanes or bunch
//     in a few (a run of kept bytes), the stores stay whole.  Payload
//     arrays are read by index there.  The fill past min(count, cap) is
//     written with 16-byte stores.
//   - Alignment.  Windows start 128 elements apart, so every window of a
//     column has the same misalignment o = data_ptr % 16.  The (16 - o) % 16
//     bytes before a window's first aligned vector (the head) and the
//     elements past its last whole vector (the tail, the ragged last
//     window's included) are read one an element, by a ballot that every
//     warp takes alike (warp 0 writes), in rank order: head, tiles, tail.
//     The column is never copied, and nothing is read past n.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LC_THREADS = 256;
constexpr int LC_WARPS = LC_THREADS / 32;
constexpr int LC_U = 4;        // 16-byte vectors a thread has in flight
constexpr int MAX_OUTS = 3;

enum OutKind { OUT_ARRAY = 0, OUT_ROW_ID = 1, OUT_VALUE = 2, OUT_DICT_LO = 3,
               OUT_DICT_HI = 4 };

struct Outs {
  const int* src[MAX_OUTS];
  int fill[MAX_OUTS];
  int* out[MAX_OUTS];
};

// The outputs of a form, in the wrapper's order: row ids (IDS), NA payload
// arrays, the values (VALS), the dictionary's two planes (DICT).
template <bool IDS, int NA, bool VALS, bool DICT>
struct Form {
  static constexpr int NOUT = IDS + NA + VALS + 2 * DICT;
  static constexpr bool NEEDX = VALS || DICT;  // writes need the value
  static constexpr bool HAS_DICT = DICT;
  // CTAs an SM: 4 (64 registers a thread), 3 where the writes need the
  // values (a thread keeps two tiles' vectors)
  static constexpr int MIN_CTAS = NEEDX ? 3 : 4;
  static_assert(NOUT >= 1 && NOUT <= MAX_OUTS, "one to three outputs");
  __host__ __device__ static constexpr int kind(int k) {
    return IDS && k == 0          ? OUT_ROW_ID
           : k < IDS + NA         ? OUT_ARRAY
           : VALS && k == IDS + NA ? OUT_VALUE
           : k == IDS + NA + VALS ? OUT_DICT_LO
                                  : OUT_DICT_HI;
  }
};

// the reference's _decode256: entry (code >= 128 ? 128 : 0) + (code & 127)
__device__ __forceinline__ int dict_entry(int code) {
  return (code >= 128 ? 128 : 0) + (code & 127);
}

// Writes the outputs of the element at row gi (value x) at position `at`
// of every output.  k is unrolled, so each kind is known.
template <class F>
__device__ __forceinline__ void put(const Outs& o, const int* s_dict,
                                    size_t at, long long gi, int x) {
#pragma unroll
  for (int k = 0; k < F::NOUT; ++k) {
    const int kind = F::kind(k);
    int val;
    if (kind == OUT_ROW_ID)
      val = (int)gi;
    else if (kind == OUT_ARRAY)
      val = __ldg(o.src[k] + gi);
    else if (kind == OUT_VALUE)
      val = x;
    else
      val = s_dict[(kind == OUT_DICT_HI ? 256 : 0) + dict_entry(x)];
    o.out[k][at] = val;
  }
}

template <typename T>
struct Lanes;
template <>
struct Lanes<unsigned char> {
  static constexpr int VEC = 16;   // elements a vector
  // keep bits of the vector's 16 bytes: byte x kept when (x - lo) mod 256
  // <= d (lo4, d4: lo and hi - lo in every byte)
  __device__ static __forceinline__ unsigned keep(uint4 v, unsigned lo4,
                                                  unsigned d4) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned b = __vcmpleu4(__vsub4(w[i], lo4), d4) & 0x08040201u;
      m |= ((b * 0x01010101u) >> 24) << (4 * i);   // the four bits of word i
    }
    return m;
  }
  __device__ static __forceinline__ int at(uint4 v, int i) {
    const unsigned w = i < 8 ? (i < 4 ? v.x : v.y) : (i < 12 ? v.z : v.w);
    return (int)((w >> ((i & 3) * 8)) & 0xffu);
  }
};
template <>
struct Lanes<int> {
  static constexpr int VEC = 4;
  __device__ static __forceinline__ unsigned keep(uint4 v, int lo, int hi) {
    const int x[4] = {(int)v.x, (int)v.y, (int)v.z, (int)v.w};
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) m |= (unsigned)(x[i] >= lo && x[i] <= hi) << i;
    return m;
  }
  __device__ static __forceinline__ int at(uint4 v, int i) {
    return (int)(i < 2 ? (i < 1 ? v.x : v.y) : (i < 3 ? v.z : v.w));
  }
};

// The elements [e0, e1) of the window at `base` (at most 31: a head or a
// tail), read one a lane: every warp takes the same ballot, warp 0 writes
// the kept ones from rank r0.  Returns their count.
template <typename T, class F>
__device__ __forceinline__ int edge(const T* __restrict__ col, long long base,
                                    int e0, int e1, int lo, int hi, int r0,
                                    int cap, size_t ob, const Outs& o,
                                    const int* s_dict) {
  const int lane = threadIdx.x & 31;
  const int e = e0 + lane;
  bool keep = false;
  int x = 0;
  if (e < e1) {
    x = (int)col[base + e];
    keep = x >= lo && x <= hi;
  }
  const unsigned m = __ballot_sync(FULL, keep);
  if (threadIdx.x < 32 && keep) {
    const int r = r0 + __popc(m & ((1u << lane) - 1u));
    if (r < cap) put<F>(o, s_dict, ob + r, base + e, x);
  }
  return __popc(m);
}

constexpr int TILE = LC_THREADS * LC_U;   // 16-byte vectors a tile

template <typename T, class F>
__global__ void __launch_bounds__(LC_THREADS, F::MIN_CTAS)
    compact_windows_kernel(const T* __restrict__ col, long long n, int block,
                           int head, int lo, int hi, int cap, Outs o,
                           const int* __restrict__ dict_lo,
                           const int* __restrict__ dict_hi,
                           int* __restrict__ counts) {
  using L = Lanes<T>;
  constexpr int VEC = L::VEC;
  constexpr unsigned VMASK = (1u << VEC) - 1u;
  // a byte column's staged entry carries the byte (the value) beside the
  // element's place in the tile; an int32 value is read again by index
  constexpr bool STAGE_X = F::NEEDX && sizeof(T) == 1;
  __shared__ unsigned long long s_tot[2][LC_WARPS];
  __shared__ int s_stage[LC_WARPS][32 * VEC];
  __shared__ int s_dict[F::HAS_DICT ? 512 : 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)blockIdx.x * block;
  const int len = (int)min((long long)block, n - base);
  const size_t ob = (size_t)blockIdx.x * cap;
  if (F::HAS_DICT) {
    for (int e = tid; e < 512; e += LC_THREADS)
      s_dict[e] = e < 256 ? dict_lo[e] : dict_hi[e - 256];
    __syncthreads();
  }
  // the keep test of a vector: bytes by SIMD compares against the range
  // clamped to [0, 255] (none when it is empty), int32 by two compares
  const int l8 = max(lo, 0), h8 = min(hi, 255);
  const bool none = sizeof(T) == 1 && l8 > h8;
  const unsigned lo4 = (unsigned)l8 * 0x01010101u;
  const unsigned d4 = (unsigned)(h8 - l8) * 0x01010101u;
  auto keep_bits = [&](uint4 v) -> unsigned {
    if constexpr (sizeof(T) == 1)
      return none ? 0u : L::keep(v, lo4, d4);
    else
      return L::keep(v, lo, hi);
  };

  // the head: the elements before the first aligned vector
  const int hh = min(head, len);
  int running = edge<T, F>(col, base, 0, hh, lo, hi, 0, cap, ob, o, s_dict);
  const int nvec = (len - hh) / VEC;
  const uint4* __restrict__ body =
      reinterpret_cast<const uint4*>(col + base + hh);
  int* const stage = s_stage[warp];
  // a thread's LC_U vectors of the tile at t0; the next tile's are loaded as
  // soon as this one's keep bits are known, so they are in flight through
  // the scan and the writes
  uint4 nxt[LC_U];
  auto load = [&](int t0) {
#pragma unroll
    for (int u = 0; u < LC_U; ++u)
      if (t0 + u * LC_THREADS + tid < nvec)
        nxt[u] = __ldg(body + t0 + u * LC_THREADS + tid);
  };
  load(0);
  uint4 v[LC_U];
  int buf = 0;
  for (int t0 = 0; t0 < nvec; t0 += TILE, buf ^= 1) {
#pragma unroll
    for (int u = 0; u < LC_U; ++u) v[u] = nxt[u];
    // the keep bits, vector u's at bit u * VEC
    unsigned long long mk = 0;
#pragma unroll
    for (int u = 0; u < LC_U; ++u)
      if (t0 + u * LC_THREADS + tid < nvec)
        mk |= (unsigned long long)keep_bits(v[u]) << (u * VEC);
    load(t0 + TILE);   // the next tile's loads
    // this thread's vector counts in 16-bit fields (at most 4,096 each
    // over the tile), scanned over the warp and then the CTA
    unsigned long long c = 0;
#pragma unroll
    for (int u = 0; u < LC_U; ++u)
      c |= (unsigned long long)__popc((unsigned)(mk >> (u * VEC)) & VMASK)
           << (16 * u);
    unsigned long long inc = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) s_tot[buf][warp] = inc;
    __syncthreads();
    unsigned long long before = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < LC_WARPS; ++w) {
      const unsigned long long t = s_tot[buf][w];
      before += w < warp ? t : 0ull;
      tot += t;
    }
    // field u: the rank in the tile of the warp's first kept element of
    // vector row u (the earlier rows' totals, the earlier warps' counts)
    // and the warp's count in that row
    const unsigned long long w_rank = before + tot * 0x0001000100010000ull;
    const unsigned long long w_cnt = __shfl_sync(FULL, inc, 31);
    const unsigned long long l_rank = inc - c;   // within the warp's row
#pragma unroll
    for (int u = 0; u < LC_U; ++u) {
      // the warp stages its kept elements of row u in rank order, then
      // writes them out, 32 consecutive positions a store
      const int wb = running + (int)((w_rank >> (16 * u)) & 0xffffu);
      const int lim = min((int)((w_cnt >> (16 * u)) & 0xffffu), cap - wb);
      if (lim <= 0) continue;   // the warp's row keeps nothing below cap
      unsigned m = (unsigned)(mk >> (u * VEC)) & VMASK;
      int r = (int)((l_rank >> (16 * u)) & 0xffffu);
      const int et = (u * LC_THREADS + tid) * VEC;   // its place in the tile
      while (m != 0u && r < lim) {
        const int i = __ffs(m) - 1;
        m &= m - 1u;
        stage[r++] = STAGE_X ? (et + i) << 8 | L::at(v[u], i)
                             : (sizeof(T) == 1 ? (et + i) << 8 : et + i);
      }
      __syncwarp();
      for (int j = lane; j < lim; j += 32) {
        const int s = stage[j];
        const long long gi = base + hh + (long long)t0 * VEC +
                             (sizeof(T) == 1 ? s >> 8 : s);
        int xv = 0;
        if (STAGE_X) xv = s & 0xff;
        else if (F::NEEDX) xv = (int)__ldg(col + gi);
        put<F>(o, s_dict, ob + wb + j, gi, xv);
      }
      __syncwarp();   // the next row restages
    }
    running += (int)((tot * 0x0001000100010001ull) >> 48);
  }
  // the tail: the elements past the last whole vector
  running += edge<T, F>(col, base, hh + nvec * VEC, len, lo, hi, running, cap,
                        ob, o, s_dict);

  // the fill past min(count, cap): to a multiple of 4, then 16 bytes a store
  const int kept = min(running, cap);
  const int a4 = min(cap, (kept + 3) & ~3);
#pragma unroll
  for (int k = 0; k < F::NOUT; ++k) {
    const int kind = F::kind(k);
    const int fill = kind == OUT_DICT_LO   ? s_dict[0]
                     : kind == OUT_DICT_HI ? s_dict[256]
                                           : o.fill[k];
    int* out = o.out[k] + ob;
    for (int p = kept + tid; p < a4; p += LC_THREADS) out[p] = fill;
    const int4 f4 = make_int4(fill, fill, fill, fill);
    for (int p = a4 / 4 + tid; p < cap / 4; p += LC_THREADS)
      reinterpret_cast<int4*>(out)[p] = f4;
  }
  if (tid == 0) counts[blockIdx.x] = running;
}

template <typename T, bool IDS, int NA, bool VALS, bool DICT>
void launch(const T* col, long long n, int block, int head, int lo, int hi,
            int cap, const Outs& o, const int* dict_lo, const int* dict_hi,
            int* counts, cudaStream_t st) {
  const unsigned nb = (unsigned)((n + block - 1) / block);
  compact_windows_kernel<T, Form<IDS, NA, VALS, DICT>>
      <<<nb, LC_THREADS, 0, st>>>(col, n, block, head, lo, hi, cap, o,
                                  dict_lo, dict_hi, counts);
}

// The form's template: row ids, na payload arrays, the values, the
// dictionary (at most three outputs).
template <typename T>
void launch_form(bool ids, int na, bool vals, bool dict, const T* col,
                 long long n, int block, int head, int lo, int hi, int cap,
                 const Outs& o, const int* dict_lo, const int* dict_hi,
                 int* counts, cudaStream_t st) {
#define LC_FORM(I, A, V, D)                                                 \
  if (ids == I && na == A && vals == V && dict == D)                        \
    return launch<T, I, A, V, D>(col, n, block, head, lo, hi, cap, o,       \
                                 dict_lo, dict_hi, counts, st)
  LC_FORM(false, 0, false, true);
  LC_FORM(true, 0, false, true);
  LC_FORM(false, 1, false, true);
  LC_FORM(false, 0, true, true);
  LC_FORM(false, 1, false, false);
  LC_FORM(false, 2, false, false);
  LC_FORM(false, 0, true, false);
  LC_FORM(false, 1, true, false);
  LC_FORM(false, 2, true, false);
  LC_FORM(true, 0, false, false);
  LC_FORM(true, 1, false, false);
  LC_FORM(true, 2, false, false);
  LC_FORM(true, 0, true, false);
  LC_FORM(true, 1, true, false);
#undef LC_FORM
}

}  // namespace

extern "C" {

// col[n] (int32, or uint8 when col_u8; any start, 16-byte aligned or not)
// -> for each of the nout outputs k, out_k[nb][cap] of kind kind_k (OutKind
// above, in the order row ids, payload arrays, values, dictionary planes;
// src_k is the payload array for OUT_ARRAY, else unused), fill_k past the
// window's count (the dictionary kinds fill with their plane's entry 0
// instead); counts[nb] with nb = ceil(n / block).  block and cap are
// multiples of 128 and the outputs 16-byte aligned (the wrapper's
// blocks).  dict_lo/dict_hi: 256 int32 each, read only when an output is
// of a dictionary kind.
int compact_windows(const void* col, int col_u8, long long n, int block,
                    int lo, int hi, int cap, int nout, int kind0, int kind1,
                    int kind2, const int* src0, const int* src1,
                    const int* src2, int fill0, int fill1, int fill2,
                    int* o0, int* o1, int* o2, const int* dict_lo,
                    const int* dict_hi, int* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  const int kinds[MAX_OUTS] = {kind0, kind1, kind2};
  const Outs o = {{src0, src1, src2}, {fill0, fill1, fill2}, {o0, o1, o2}};
  if (nout < 1 || nout > MAX_OUTS || block < 128 || block % 128 ||
      cap < 0 || cap % 128)
    return (int)cudaErrorInvalidValue;
  // the form, from the kinds in the wrapper's order
  int k = 0;
  const bool ids = kinds[0] == OUT_ROW_ID;
  k += ids;
  int na = 0;
  while (k < nout && kinds[k] == OUT_ARRAY) {
    if (!o.src[k]) return (int)cudaErrorInvalidValue;
    ++na;
    ++k;
  }
  const bool vals = k < nout && kinds[k] == OUT_VALUE;
  k += vals;
  const bool dict = k + 1 < nout && kinds[k] == OUT_DICT_LO &&
                    kinds[k + 1] == OUT_DICT_HI;
  k += 2 * dict;
  if (k != nout || na > 2 || (dict && (!dict_lo || !dict_hi)))
    return (int)cudaErrorInvalidValue;
  for (k = 0; k < nout; ++k)
    if ((uintptr_t)o.out[k] % 16) return (int)cudaErrorInvalidValue;
  // elements before the column's first 16-byte boundary
  const int mis = (int)((uintptr_t)col % 16);
  if (col_u8) {
    launch_form(ids, na, vals, dict, static_cast<const unsigned char*>(col),
                n, block, (16 - mis) % 16, lo, hi, cap, o, dict_lo, dict_hi,
                counts, st);
  } else {
    if (mis % 4) return (int)cudaErrorInvalidValue;   // not an int32 array
    launch_form(ids, na, vals, dict, static_cast<const int*>(col), n, block,
                (16 - mis) % 16 / 4, lo, hi, cap, o, dict_lo, dict_hi, counts,
                st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
