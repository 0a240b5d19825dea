// Hopper kernels of the no-partition hash join's probe (PHT / NPO family).
//
//   K3TWO     replaces _make_k3two (aqp_tpu/ops/pallas/nphj.py:137),
//             launched by nphj_probe (nphj.py:233).  For each (f1, f2)
//             region: the S elements whose R partner is in the region's
//             TABLE runs, and r_pay + s_pay summed mod 2^32 over them.
//   K3TWO_MAT replaces _make_k3two_mat (nphj.py:171), launched by
//             nphj_join_materialize (nphj.py:280).  K3TWO, and region-chunked
//             output columns with (-3, 0, 0) holes.
//
// The table is the build side routed once by K1 + K2 (rho3.cu) into fine
// slots (f1, nbg_r, f2, cap2); it persists and is probed many times.  S is
// routed the same way (same salt and scale, so equal keys meet in one
// region) into (f1, nbg_s, f2, cap2).  The TPU kernel merges both sides'
// runs of a region in VMEM and propagates the last R over the combined
// window; a region (up to 2 x 16 runs of 16,384 keys) does not fit the
// 227 KB of shared memory a CTA has.  So both launch the sub-range join of
// region_join.cuh with the S slots as the probe runs and the table's as
// the searched runs, the table read where it lies, never copied next to S:
// one CTA per (region, key sub-range), which reads its sub-range of each
// table run once (the first copy of each R key, merged in run order in
// shared memory) and of each S run once (a binary search an S element).
// K3TWO_MAT is its MAT form: each S element writes its own output row, a
// match or a hole, from the S pass, and the region's CTAs split the holes
// no element owns (the S slots past their counts and the tail's chunks).
//
// Materialized layout (the reference's): three int32 columns of
// f1 * f2 * w elements, w = 2 * max(nbg_r, nbg_s) * cap2; region (a, b) owns
// the chunk [(a * f2 + b) * w, + w).  A matched S element of run j at slot
// position e writes at chunk + j * cap2 + e (nbg_s * cap2 <= w, so it always
// fits); every other position of the chunk, the tail of w - nbg_s * cap2
// past the S runs included, is written (-3, 0, 0) by the kernel itself, each
// once.  Length, live multiset and hole count equal the reference's;
// positions inside a chunk differ (the reference writes merged-window
// order).
//
// Bounds at the headline size (13,107,200 R + 52,428,800 S keys, default
// Rho3Params: nbg_r = 4, nbg_s = 16, cap2 = 8,192; H100 HBM 3.35 TB/s),
// each input byte read once and each output byte written once:
//   K3TWO      the real slot elements, 262 MB keys-only (524 MB with
//              payloads): >= 0.08 ms (0.16 ms).  It reads each of them once,
//              plus 2 x (nbg_r + nbg_s) bound searches a CTA.
//   K3TWO_MAT  524 MB read and three columns of 151M elements (1.81 GB)
//              written: >= 0.70 ms; the holes (half of every region is the
//              tail) are most of the writes.  It reads what K3TWO with
//              payloads reads, and writes each position once.

#include <cuda_runtime.h>

#include "region_join.cuh"

extern "C" {

// K3TWO: table slots tk/tp/tcnt (nbg_r runs) probed by S slots sk/sp/scnt
// (nbg_s runs), payloads on both sides or neither, with P key sub-ranges a
// region -> *matches, *checksum; adds each halving of a sub-range to
// *halvings (all accumulated; the caller zeroes matches and checksum).
int nphj_k3two(const int* tk, const int* tp, const int* tcnt, int nbg_r,
               const int* sk, const int* sp, const int* scnt, int nbg_s,
               int f1, int f2, int cap2, int P, unsigned long long* matches,
               unsigned int* checksum, unsigned long long* halvings,
               void* stream) {
  const Runs table{tk, tp, tcnt, nbg_r};
  const Runs probe{sk, sp, scnt, nbg_s};
  return (int)launch_subrange_join<false>(probe, table, f1, f2, cap2, P,
                                          matches, checksum, halvings,
                                          (cudaStream_t)stream);
}

// K3TWO_MAT: as nphj_k3two with payloads, and ok/orp/osp[f1 * f2 * w] with
// w = 2 * max(nbg_r, nbg_s) * cap2, every position written.
int nphj_k3two_mat(const int* tk, const int* tp, const int* tcnt, int nbg_r,
                   const int* sk, const int* sp, const int* scnt, int nbg_s,
                   int f1, int f2, int cap2, int P, int inv, int* ok,
                   int* orp, int* osp, unsigned long long* matches,
                   unsigned int* checksum, unsigned long long* halvings,
                   void* stream) {
  const Runs table{tk, tp, tcnt, nbg_r};
  const Runs probe{sk, sp, scnt, nbg_s};
  const int chunks = 2 * (nbg_r > nbg_s ? nbg_r : nbg_s);
  const long long w = (long long)chunks * cap2;
  const MatOut out{ok, orp, osp, inv, f2 * w, w, cap2, chunks - nbg_s};
  return (int)launch_subrange_join<false, true>(
      probe, table, f1, f2, cap2, P, matches, checksum, halvings,
      (cudaStream_t)stream, out);
}

}  // extern "C"
