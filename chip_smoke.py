"""Smoke run of the PyTorch/CUDA port (aqp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on one line with its elapsed seconds:
  1. device: a CUDA card is required; its name and power limit are printed
     as nvidia-smi reports them;
  2. build: every kernel is compiled from aqp_tpu_torch/csrc, one nvcc
     process per source started together, then one link (no PyTorch
     headers, no ninja, no network); each compile runs with -Xptxas -v,
     and blocksort.cu's, rho3.cu's, nphj.cu's, aggpipe.cu's,
     lanecompact.cu's, compact.cu's and rstats.cu's reports (the sub-range
     kernels are in rho3.cu, nphj.cu and aggpipe.cu) are printed and must
     show no spill;
  3. kernels: K1, K2, K3 and K3M against their plain PyTorch versions on
     the card, at the default, a small, the skew tier's residual and the
     no-partition variants' geometries (f1 = 48; f2 = 32 with 4,096-value
     fine slots; f2 = 8 with 16,384), keys-only and with payloads; K1 and
     K2 alone on MWAY's range scale, the aggregate's duplicate group keys
     with value payloads, all keys equal, a K2-only overflow (equal, the
     fine slots' contents included) and a K1 overflow (K1's counts and
     overflow; K2 exact on K1's output); the window compactor (key +
     payload and keys-only) and the segment scatters at w=512 with a
     cutting and a non-cutting keep fraction: exact equality; K3 and K3M
     also on MWAY's range route (salt 1, the range scale), where a
     region's R passes one CTA's array (R = 13.1M, S = 1M at f2 = 8 with
     16,384-value fine slots: their sub-ranges must halve) and on one R
     key 5,000 times (the skew residual's geometry); K3M is held to K3's
     every case with payloads (all three columns, matches and checksum);
     each K3, K3M, K3TWO, K3TWO_MAT and K3AGG check prints the sub-ranges
     (pieces) it halved, and a {"halvings"...} line before the kernels line
     gathers them;
  4. the slice at full width: run_join("RHO") keys-only and checksummed and
     engine.rho_join_count_fused on |R| = 13,107,200 dense PK keys and
     |S| = 52,428,800 tiled FK keys with seeded random payloads (bench.py's
     workload); matches must equal |S|, the checksum must equal the exact
     core's, and every kernel must have been launched; then ms per call;
  5. each kernel at the shapes of phase 4: time, plain version's time,
     bound, exact agreement, and a composition of PyTorch calls for the
     same function (library time): for K1 and K2 a torch.sort of the same
     routing, for K3 torch.isin(S - 1, R) over the live elements (with
     payloads torch.sort + torch.searchsorted + a gather), for K3M the
     same with index_put_ of the columns (K3M also checked exactly at
     the headline);
  6. the ladder: one key on a quarter of S is served by the heavy-split
     skew tier; 80 keys of 17,000 rows each overflow every salt and the skew
     tier, and must get the exact core's answer;
  7. materialize at full width: run_join("RHO", materialize=True) and
     engine.rho_join_materialize_fused on phase 4's relations: matches ==
     |S|, overflow 0, checksum and the live (key, R payload, S payload)
     multiset equal to the exact core's; K3M timed at its shapes;
  8. skew at full width: S = 52,428,800 Zipf keys over R's 13,107,200 keys
     at z = 1.5 and 1.0 (experiments/run_r5_studies.py's study): the plan,
     run_join("RHO") keys-only and checksummed (and materialize at z = 1.5)
     equal to the exact core, with the compactor and scatter launched where
     the plan compacts; the compactor (both forms) and the scatters timed
     at z = 1.5, and K3 exact on the z = 1.5 residual's fine slots;
  9. scans at full width: the count and sum kernels, the bitvector kernel
     and the window kernel's index, values and dict forms against their
     plain versions (odd n, unaligned starts, windows cut; B5's forms and
     the join's key + payload form also on columns 1, 7 and 15 bytes and
     one int32 element past a 16-byte boundary); then the main
     path through the user's entry points: count, sum and bitvector over the
     reference's 16 GiB scale-up column (2^34 uint8 rows, arange & 255,
     against the closed form), bench.py's 32 count passes over 2^28 rows,
     and the index (2^29 rows), values and dict (2^28 rows) scans at 10%
     and 50% with a full-size output (experiments/scan_bench.py's sizes),
     live rows equal to the dense forms', and a hint below the selectivity
     that must report overflow; then each kernel timed at those shapes
     (B7 and B8 at 2^30 random rows against their plain versions) and
     scan_count_streamed over a 2^30-row pinned host column;
 10. the aggregate at full width: bench.py's leg on phase 7's
     materialize output (group key = key & (2^20 - 1), compact_kp_fast,
     groupby_aggregate_routed_auto with capacity 2^21) and the jittered
     branch (64 groups, capacity 64), equal to the sort-based aggregate;
     the leg's steps timed, and K3AGG against its plain version (all six
     outputs) at 2^16 and 2^19 groups, the small geometry, 64 jittered
     groups, one key filling a region, sparse keys (its pieces must
     halve), empty regions, and both legs' K2 shapes, beside torch.sort +
     bincount + index_add_ + scatter_reduce_ over its live rows (library
     time); its bound counts the five full region blocks it writes.
 11. the no-partition family at full width: K3TWO (keys-only and with
     payloads at the default, small, PHT_un, PHT_o and skew-residual
     geometries, with empty table runs, more table runs than S runs (its
     sub-ranges must halve), duplicate R keys and one R key 5,000 times),
     K3TWO_MAT (default and small geometry, empty table runs, nbg_r >
     nbg_s at the default and at tests/test_torch_nphj.py's geometry,
     duplicate R keys, one R key 5,000 times; its halvings equal K3TWO's
     and join the {"halvings"...} line) and RSTATS
     (odd lengths, unaligned starts, -1 and repeated candidates; at full
     size h = 1 and 1,024, 40 candidates colliding in its table, an R drawn
     from 4M values and one in runs of 4,096 keys, two calls in a row)
     against their plain versions; then run_join on phase 4's relations
     for PHT (keys-only and checksummed), PHT_no, PHT_un, PHT_o, NPO_st,
     NPO_no, PHT materialized, one nphj_build probed twice, NPBC_st and PHT's
     staged engine (profile_phases), and PHT keys-only and checksummed on
     phase 8's z = 1.5 Zipf S: matches, checksums and live rows equal to the
     exact core's; K1, K2, K3TWO, K3TWO_MAT and RSTATS launched, K3 not;
     each call timed, and each new kernel at the headline shapes beside its
     plain version, its bound and a PyTorch composition (K3TWO and
     K3TWO_MAT as K3's and K3M's, RSTATS its own; RSTATS's bound counts
     R's keys and only the payload sectors that hold a hit, all its
     kernel reads).
 12. the partition-and-sort side at full width: the block sort (B13) and
     the block sort with bucket starts (B12, at F = 1, 16 and 127) against
     their plain versions at sub = 128, 256, 512 and 1024 (three blocks of
     random keys, all keys equal, a few runs of equal keys, a third
     KEY_PAD_INT; and at one block and at nine: equal keys with payloads
     varying in one high digit, arange payloads, a block of KEY_PAD_INT with
     equal payloads, keys varying in their top digit only, distinct keys,
     every key twice and one repeated key a tile with payloads out of
     order, keys 0..4 with random payloads); then the main
     path: the radix-partition microbenchmark (2^26 rows: histograms,
     partition passes, sort+hist, segment scatter), the memory benchmark
     (2^24 and 2^27 rows, its block sort at sub = 512) and compact_kp over
     2^26 rows at 30% kept (live rows equal a masked_select oracle,
     overflow 0; overflow > 0 at half the rows it needs), with B12 and B13
     launched; then run_join on phase 4's relations for RHO_seq, RHT, RSM,
     MWAY and PSM (keys-only and checksummed), RHT and MWAY materialized,
     RHO with use_pallas=False and with profile_phases, RHT on an R with
     duplicate keys, and MWAY on phase 8's z = 1.5 S (its range route
     overflows, the fallback answers): equal to the exact cores, with K1,
     K2, K3 and K3M launched by MWAY's range route; each call timed, and
     B12 and B13 at the drivers' shapes beside their plain versions, their
     bounds and one torch.sort of the same 64-bit composite, each by sub
     with the kernels one call launches (counted by the launchers; they
     must be the design's); and the tile sort's plan counts (tile_plan) at those
     shapes and compact_kp's, equal to their plain version's.
 13. the seven join names that call no kernel (plain PyTorch, as the
     reference's are plain XLA): CHT, INL, CRKJ, CrkJoin, CRKJF and CRKJS
     on phase 4's relations, keys-only, checksummed and materialized,
     and CHT's, INL's and CRKJ's profile_phases forms (the bitmap probe,
     the binary search, the windowed join after one crack sort a level);
     NL at experiments/join_overview.py's 2^18 x 2^20, count and
     materialize; CHT on an R of keys 32 apart (its domain passes
     16 |R|: it must take sortmerge._sortmerge); the cracking store
     itself: crk_join_cracked at CRKJ's depth, again on the stores it
     returned (no crack sort, the same objects back), then one level
     deeper (one crack sort a side); matches |S|, checksums and live
     rows equal to PSM's on the same relations, every kernel's launches
     over the main path 0; each call timed (PSM's three forms beside),
     with the card's name and power limit;
 14. the TPC-H layer at SF 10: data/tpch_dbgen.py writes its store into
     a temporary directory (removed after phase 15) and the loaders put
     the five tables on the card (seconds printed); the four staged plans
     (RHO) and the four fused plans on them and on
     generate_tpch_tables(scale=10)'s tables: every count equal to an
     oracle on the card that uses no join engine (torch.isin chains for
     Q3, Q10 and Q12, a searchsorted lookup of part and the residual for
     Q19), every fused ok true, K1, K2, K3, K3M, the window compactor and
     both scatters launched by the fused plans (the staged plans'
     launches reported); each plan timed (1 warm-up, 3 calls, CUDA
     events) as M rows/s = rows_in / s, the staged plans with their
     filter, join and materialize phases; staged Q12's join on the
     filter's full-length output (its pad keys walk RHO's ladder) and on
     its live prefix, equal answers, both timed; and at the plans' SF 10
     shapes B5 and B6b (Q12's 1/48 of lineitem), B5 and B6a (Q3's
     orders), K1, K2, K3 and K3M (fused Q3's first join) and K1, K2 and K3
     (its count join) held exactly to their plain versions; staged Q12's
     join and staged Q3's first join rebuilt up to their skew tier on
     the filters' full-length columns: RSTATS on R with skew_plan's own
     candidates (keys-only and with payloads), the compacted residual's
     B5 and B6a, and K1 and K2 under the first salt on each attempt's
     packed keys, held to their plain versions; the fused plans' key
     domain check timed beside its former form; one {"tpch"...} line;
 15. the entry points at full width, in-process (python -m aqp_tpu_torch's
     main with its output captured), each CLI call a main path of its
     own: join -x cache-exceed (bench.py's headline) RHO, RHO -m, PHT and
     -z 1.5, and -x L (50M x 200M, RHO) once, every answer equal to the
     exact core on the same seeded relations and -x L's serving rung
     printed; then K1, K2 and K3 (K3M with payloads) held exactly to
     their plain versions at -x L's geometry, on its relations' keys
     with random payloads, keys-only and with payloads; tpch -q
     3|10|12|19 staged and --fused on phase 14's dbgen store, each count
     equal to phase 14's oracle; scan in its six modes
     over 2^28 rows at 10%; matrix RHO, PHT, PSM at the headline, both
     materialize forms, 3 reps (no error row, matches |S|); join
     --profile at the headline (0 < device_total_s <= the traced
     section's wall time; the trace's kernels and calls beside the
     launchers' counts); K1, K2, K3, K3M, K3TWO, RSTATS, B5, B6a, B6b,
     B7 and B8 required launched; one {"cli"...} line; then the
     streaming join: R the headline's 13.1M keys on the card, S 2^29 FK
     rows from native.gen_fk_host (seconds printed), pinned (halved if
     the host cannot pin it) and streamed in 2^26-row chunks, (matches,
     checksum) equal to the exact core on the whole S on the card, the
     streamed time (best of 3 after a warm-up, host clock to the last
     sync) below copy alone plus probe alone; one {"streamjoin"...} line;
 16. 64-bit keys (int64 relations, which reach no kernel): every join
     name but NL on 13,107,200 x 52,428,800 keys above 2^40 with int64
     payloads beyond 32 bits, 16 S keys 2^40 + 1 + 2^32 (R's 2^40 + 1 in
     their low 32 bits), keys-only and checksummed, and materialized for
     RHO, PHT, MWAY and INL; NL at 2^18 x 2^20; dense int64 keys through
     CHT and the cracking names; each answer held to its int32 twin (keys
     less 2^40, the trap rows keyed |R| + 1) through RHO's kernel
     pipeline, materialized rows as multisets of live rows with int64
     columns and every R and S payload whole; every kernel's launches
     over those calls 0; RHO, PHT, MWAY and INL keys-only and materialized
     (1 warm-up, 5 calls, CUDA events) and NL checksummed and materialized
     (1 warm-up, 1 call) timed beside the same call on the int32 twin,
     with the int64 call's phases; join --key64 -x cache-exceed in-process (matches |S|, no
     launch); the four join-sweep drivers (join_overview and its key64
     rows, skew, selectivity, scaling) at full size through their config
     functions, 3 pipelined calls a configuration: no error row, every
     row's matches equal to the exact core's (merge_join_count_keys) on
     the workload the harness draws; then the sweeps once more, 1
     pipelined call a configuration, keys-only and checksummed, with
     every kernel launch (K1, K2, K3, K3TWO, the compactor, both
     scatters, RSTATS) held exactly to its plain version on the inputs
     the main path gives it, the 2^29 x 52.4M point included (the
     routing and region kernels' plain versions run in pieces of whole
     blocks, windows or regions, each against its slice); every launch
     of that pass a held one, every kernel the sweeps launched held;
     one {"key64"...} line;
 17. the distributed layer (aqp_tpu_torch/parallel) on one rank: a
     one-rank group brought up by parallel.bringup.initialize_distributed
     (NCCL for the card's tensors, gloo for the CPU's, a TCP store on a
     free localhost port) and 1-D and 1 x 1 meshes; on phase 4's
     relations the hash-shuffle count join with engine "pallas" (K1, K2
     and K3 on the shuffle's receive buffers: 26.2M R and 104.9M S
     slots, half of them pads) and "xla", the 2-D join, the
     materializing join, the ring, the skew tier on phase 8's z = 1.5 S
     and dist_join_count_auto on both (tier printed), each equal to the
     exact core (matches, checksum, the multiset of live rows) and run_join
     RHO; the 8-shard layout laid out on the card (8 row blocks through
     _pack_by_dest at 8 destinations, the exchange as the transpose of
     the stacked (8, 8, cap) buffers, the "pallas" local count on each of
     the 8 received shards), its sum equal to the one-rank answer and one
     block's send buffers equal to the CPU's position by position; K1, K2
     and K3 launched on the path, then every launch of a second pass held
     to its plain version (in pieces, as in phase 16); real keys 2^30 - 2
     and 2^30 - 1 (rho3's input pads) through "pallas" (overflow
     reported) and auto (the truth, tier "hash+salt"), and int64
     relations through "pallas", the 2-D join and auto (the truth, no
     launch); each form timed with CUDA events beside run_join RHO
     keys-only and checksummed; the group destroyed; then
     experiments/weak_scaling at its full size a rank (2^17 x 2^19) with
     one rank (a process of its own), matches = |S| on every row; one
     {"parallel"...} line;
 18. the six drivers at their full default sizes, each main in this
     process (its own watchdog): rho_phases and roofline (13.1M x 52.4M),
     scan_bench (its three families, to 2^30 rows), aggregate_bench (2^26
     rows, 2^6 to 2^24 groups), tpch_bench (SF 1 on its dbgen store,
     written into a temporary directory) and cracking (13.1M x 52.4M, 8
     queries a variant) as one main path; RHO's, rho_phases' fused,
     the roofline's and every cracking variant's matches equal to the
     exact core's on their relations, each TPC-H query's staged and fused
     matches equal to each other and to tpch_oracle, every aggregate row
     within its capacity, every scan count and sum equal to the plain
     version's on the driver's column; then the drivers again (timed calls
     repeated less) with every kernel launch held to its plain version;
     the roofline's table; one {"drivers"...} line with each driver's
     seconds and rows;
 19. after every main path, so that its work does not change the state
     the timed phases run in: the segment scatters (both) on 3,000 segments in no order
     with gaps, dead segments among them and a cut at out_rows, with no
     live segment and with none at all, every output row compared (the
     kernel writes the fill too): exact equality; then the device
     operations one call issues, from torch.profiler in a fresh process
     for each call (experiments/wrapper_split.py --only), with its
     kernel's device microseconds a launch, added to the kernel rows:
     RSTATS at phase 11's shapes (at most its output's memset and the
     kernel) and each scatter at phase 8's (the kernel alone); each
     kernel seen at least once a call.
Each of phases 4, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17 and 18 sets the launch counts
to 0 just before its main path and reads them just after; a kernel's launches in the
kernels line are summed over those main paths.  The scale-up column needs 16 GiB
of device memory (18 GiB with its bitvector).  Then one JSON line with the
kernels' numbers, and last the result line {"ok": true, "device": {...}}.  Any failure exits
non-zero; a watchdog ends a run that hangs.
"""

import contextlib
import faulthandler

faulthandler.dump_traceback_later(600, exit=True)

import dataclasses  # noqa: E402
import functools  # noqa: E402
import io  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import aqp_tpu_torch.__main__ as cli_main  # noqa: E402
from aqp_tpu_torch.config import JoinConfig  # noqa: E402
from aqp_tpu_torch.data import (  # noqa: E402
    create_relation_fk, create_relation_pk, create_relation_zipf, native,
    tpch_dbgen, tpch_loader)
from aqp_tpu_torch import engine  # noqa: E402
from aqp_tpu_torch.experiments import (  # noqa: E402
    dist_forms, membench, partition_bench)
from aqp_tpu_torch.experiments.dist_forms import live_rows  # noqa: E402
from aqp_tpu_torch.joins import (  # noqa: E402
    cht, crk, skewtier, sortmerge)
from aqp_tpu_torch.joins.api import (  # noqa: E402
    JOIN_ALGORITHMS, run_join)
from aqp_tpu_torch.harness.runner import (  # noqa: E402
    CSV_HEADER, _gen_workload, run_experiments_pipelined)
from aqp_tpu_torch.ops import (  # noqa: E402
    aggregate, mergejoin, scan, streamjoin)
from aqp_tpu_torch.ops.hashing import fib_hash32  # noqa: E402
from aqp_tpu_torch.ops.kernels import (  # noqa: E402
    aggpipe, blocksort, build, compact, lanecompact, nphj, rho3, rstats)
from aqp_tpu_torch.ops.kernels import scan as kscan  # noqa: E402
from aqp_tpu_torch.ops.kernels.held import (  # noqa: E402
    as_list, flat_outputs, held_to_plain, max_abs_err, read_launches,
    reset_launches)
from aqp_tpu_torch.parallel import bringup  # noqa: E402
from aqp_tpu_torch.parallel import dist_join as pdj  # noqa: E402
from aqp_tpu_torch.parallel import shuffle as pshuffle  # noqa: E402
from aqp_tpu_torch.parallel import skew as pskew  # noqa: E402
from aqp_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, make_mesh_2d, row_block, shard_relation)
from aqp_tpu_torch.queries import filters as F  # noqa: E402
from aqp_tpu_torch.queries import fused, tpch  # noqa: E402
from aqp_tpu_torch.queries import tables as TT  # noqa: E402
from aqp_tpu_torch.relation import Relation  # noqa: E402
from aqp_tpu_torch.utils import profiler  # noqa: E402
from aqp_tpu_torch.utils.timing import PhaseTimer, mean_ms  # noqa: E402

NR, NS = 13_107_200, 52_428_800      # bench.py's headline workload
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
REPS = 5
T0 = time.perf_counter()
SOURCE = {"K1": "aqp_tpu_torch/csrc/rho3.cu",
          "K2": "aqp_tpu_torch/csrc/rho3.cu",
          "K3": "aqp_tpu_torch/csrc/rho3.cu",
          "K3M": "aqp_tpu_torch/csrc/rho3.cu",
          "compact_windows": "aqp_tpu_torch/csrc/lanecompact.cu",
          "scatter_segments": "aqp_tpu_torch/csrc/compact.cu",
          "scatter_segments_one": "aqp_tpu_torch/csrc/compact.cu",
          "scan_count": "aqp_tpu_torch/csrc/scan.cu",
          "scan_sum": "aqp_tpu_torch/csrc/scan.cu",
          "scan_bitvector": "aqp_tpu_torch/csrc/scan.cu",
          "compact_windows_index": "aqp_tpu_torch/csrc/lanecompact.cu",
          "compact_windows_values": "aqp_tpu_torch/csrc/lanecompact.cu",
          "compact_windows_dict": "aqp_tpu_torch/csrc/lanecompact.cu",
          "K3AGG": "aqp_tpu_torch/csrc/aggpipe.cu",
          "K3TWO": "aqp_tpu_torch/csrc/nphj.cu",
          "K3TWO_MAT": "aqp_tpu_torch/csrc/nphj.cu",
          "RSTATS": "aqp_tpu_torch/csrc/rstats.cu",
          "sort_hist": "aqp_tpu_torch/csrc/blocksort.cu",
          "sort_blocks": "aqp_tpu_torch/csrc/blocksort.cu"}
REPLACES = {"K1": "aqp_tpu/ops/pallas/rho3.py:212",
            "K2": "aqp_tpu/ops/pallas/rho3.py:250",
            "K3": "aqp_tpu/ops/pallas/rho3.py:300",
            "K3M": "aqp_tpu/ops/pallas/rho3.py:343",
            "compact_windows": "aqp_tpu/ops/pallas/lanecompact.py:209",
            "scatter_segments": "aqp_tpu/ops/pallas/compact.py:157",
            "scatter_segments_one": "aqp_tpu/ops/pallas/compact.py:299",
            "scan_count": "aqp_tpu/ops/pallas/scan.py:30",
            "scan_sum": "aqp_tpu/ops/pallas/scan.py:41",
            "scan_bitvector": "aqp_tpu/ops/pallas/scan.py:47",
            "compact_windows_index": "aqp_tpu/ops/pallas/lanecompact.py:209",
            "compact_windows_values": "aqp_tpu/ops/pallas/lanecompact.py:209",
            "compact_windows_dict": "aqp_tpu/ops/pallas/lanecompact.py:209",
            "K3AGG": "aqp_tpu/ops/pallas/aggpipe.py:112",
            "K3TWO": "aqp_tpu/ops/pallas/nphj.py:137",
            "K3TWO_MAT": "aqp_tpu/ops/pallas/nphj.py:171",
            "RSTATS": "aqp_tpu/joins/skewtier.py:113",
            "sort_hist": "aqp_tpu/ops/pallas/compact.py:86",
            "sort_blocks": "aqp_tpu/ops/pallas/blocksort.py:103"}
W = 512                              # the compactor's window, in rows
# the compaction keeps lo <= key <= hi: every key but the input pad
KEEP_RANGE = (lanecompact.INT32_MIN + 1, lanecompact.PAD_R_INPUT - 1)
KEYS_ONLY_B5 = "compact_windows keys-only"
DEV = "cuda"
SMALL_GEOM = rho3.Rho3Params(block_rows=128, slot_rows=8, f1=20, f2=4,
                             kd_slot_rows=16)


def say(msg: str) -> None:
    print(f"[smoke {time.perf_counter() - T0:7.2f}s] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over `reps` calls after one
    warm-up call, from CUDA events (utils/timing.mean_ms)."""
    return mean_ms(fn, DEV, reps)[0]


def kernel_split(fn, reps: int = 5) -> dict:
    """Device microseconds per call of each CUDA kernel `fn` launches, from
    torch.profiler over `reps` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key.replace("(anonymous namespace)::", "").split("(")[0]:
            ev.device_time_total / reps
            for ev in prof.key_averages() if ev.device_time_total > 0}


def fresh_device_ops(label: str) -> dict:
    """wrapper_split's device operations of one call (`label`), measured in
    a process of its own: in this one, which profiled before, the
    profiler drops device records."""
    run = subprocess.run(
        [sys.executable, "-m", "aqp_tpu_torch.experiments.wrapper_split",
         "--only", label, "--reps", str(REPS)], capture_output=True,
        text=True, timeout=240, cwd=os.path.dirname(os.path.abspath(
            __file__)))
    require(run.returncode == 0, f"wrapper_split --only {label!r} exited "
            f"{run.returncode}: {run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])[label]["ops"]


def call_split(name, ops: dict, kernel: str, most_ops: int) -> dict:
    """A wrapper's device operations a call (at most `most_ops`, the
    design's, and its kernel at least once) and its kernel's own device
    microseconds a launch, from wrapper_split's torch.profiler count."""
    n_ops = sum(v["per_call"] for v in ops.values())
    mine = [v for k, v in ops.items() if kernel in k]
    require(mine and mine[0]["per_call"] >= 1, f"{name}: the profiler shows "
            f"{kernel} less than once a call: {ops}")
    require(n_ops <= most_ops, f"{name} issues {n_ops} device operations a "
            f"call, more than {most_ops}: {ops}")
    return {"device_ops_per_call": n_ops, "kernel_us": mine[0]["us_each"],
            "device_ops": ops}


def device_op_checks(rows) -> None:
    """Phase 19, after every main path (so that its checks and profiler
    sessions do not change the state the timed phases run in): the
    segment scatters on scatter_cases, then the device operations one
    call issues, each counted in a fresh process (fresh_device_ops),
    RSTATS at phase 11's shapes (at most the output's memset and the
    kernel) and each scatter at phase 8's (the kernel alone), with the
    kernel's device microseconds, into their kernel rows."""
    check_scatter_cases()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    splits = {}
    for with_pay, label in ((True, "RSTATS with payloads"),
                            (False, "RSTATS keys-only")):
        splits[("RSTATS", with_pay)] = call_split(
            "RSTATS", fresh_device_ops(label), "rstats_kernel", 2)
    for name in ("scatter_segments", "scatter_segments_one"):
        splits[(name, True)] = call_split(name, fresh_device_ops(name),
                                          "scatter_kernel", 1)
    for (name, with_pay), split in splits.items():
        (rows[name] if with_pay else rows[name]["keys_only"]).update(split)
        say(f"{name}{'' if with_pay else ' keys-only'}: "
            f"{split['device_ops_per_call']} device operations a call, the "
            f"kernel {split['kernel_us']} us a launch: {split['device_ops']}")


def stage_inputs(rk, rp, sk, sp, prm, with_payload, salt=rho3.HASH_C,
                 scale=None):
    """The inputs the main path hands K1, K2 and K3, from the kernels
    (MWAY's range route: salt 1 and its scale)."""
    packed, alias = rho3.pack_pair(rk, sk, salt)
    pay = torch.cat([rp, sp]) if with_payload else None
    nb = rho3.num_blocks(packed.numel(), prm)
    scale = rho3.default_scale(prm) if scale is None else scale
    k1_in = (packed, pay, nb, prm, scale)
    k1_out = rho3.k1(*k1_in)
    k2_in = (k1_out[0], k1_out[1], k1_out[2], prm, scale)
    k2_out = rho3.k2(*k2_in)
    k3_in = (k2_out[0], k2_out[1], k2_out[2])
    return int(alias), {"K1": (k1_in, k1_out), "K2": (k2_in, k2_out),
                        "K3": (k3_in, None)}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def kernel_bytes(name, args, out) -> int:
    """Bytes the kernel's function must move: each input read once (only
    the real slot elements, which the counts delimit), each output written
    once."""
    if name == "K1":
        packed, pay = args[0], args[1]
        return nbytes(packed, pay) + nbytes(*out[:3]) + 8
    if name == "K2":
        k1k, k1p, cnt1 = args[:3]
        real = int(cnt1.sum()) * 4 * (2 if k1p is not None else 1)
        return real + nbytes(cnt1) + nbytes(*out[:3]) + 8
    k2k, k2p, cnt2 = args
    real = int(cnt2.sum()) * 4 * (2 if k2p is not None else 1)
    return real + nbytes(cnt2) + 16


INV = rho3._modinv_pow2(rho3.HASH_C)
PLAIN = {"K1": rho3.k1_plain, "K2": rho3.k2_plain, "K3": rho3.k3_plain,
         "K3M": rho3.k3m_plain, "K3TWO": nphj.k3two_plain,
         "K3TWO_MAT": lambda *a: nphj.k3two_mat_plain(*a, INV),
         "K3AGG": aggpipe.k3agg_plain}
KERNEL = {"K1": rho3.k1, "K2": rho3.k2, "K3": rho3.k3, "K3M": rho3.k3m,
          "K3TWO": nphj.k3two,
          "K3TWO_MAT": lambda *a: nphj.k3two_mat(*a, INV),
          "K3AGG": aggpipe.k3agg}
U32 = 0xFFFFFFFF


MAIN_PATH = {}      # phase -> the launches of its main path


def main_path_launches(phase: str) -> dict:
    """The launches since the last reset_launches(), recorded as the main
    path of `phase`."""
    got = read_launches()
    MAIN_PATH[phase] = got
    return got


def kernel_row(name, err, k_ms, p_ms, bound_ms, library_ms=None,
               library_call=None) -> dict:
    """One entry of the kernels line; its launches are filled in from the
    main path's run."""
    row = {"name": name, "route": "cuda", "source": SOURCE[name],
           "replaces": REPLACES[name], "launches": None,
           "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "library_ms": library_ms}
    if library_call:
        row["library_call"] = library_call
    return row


HALVINGS = {}       # sub-range kernel case -> the pieces it halved


def check_subrange(name, label, args) -> tuple:
    """K3, K3M, K3TWO, K3TWO_MAT (the salt's inverse given here) or K3AGG
    equals its plain version exactly on `args` (every output); records and
    prints the pieces it halved (a region join's R, K3AGG's elements, past
    one CTA's array) and returns them with the measured max_abs_err."""
    halved = rho3.halving_counter(DEV)
    halved.zero_()
    got = KERNEL[name](*args)
    want = PLAIN[name](*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(err == 0, f"{name} differs from its plain version by {err} "
            f"({label})")
    n = int(halved)
    HALVINGS[f"{name} {label}"] = n
    say(f"{name} {label}: exact, {n} sub-ranges halved")
    return n, err


def check_kernels(rk, rp, sk, sp, prm, with_payload, label, salt=rho3.HASH_C,
                  scale=None, errs=None) -> int:
    """Each kernel equals its plain version exactly on the same inputs (K3M
    with payloads).  Returns the sub-ranges K3 halved; each kernel's
    max_abs_err goes into `errs` where one is given."""
    errs = {} if errs is None else errs
    mode = "payload" if with_payload else "keys-only"
    alias, stages = stage_inputs(rk, rp, sk, sp, prm, with_payload, salt,
                                 scale)
    require(alias == 0, "pack_keys reported an alias")
    for name in ("K1", "K2"):
        args, _ = stages[name]
        got = KERNEL[name](*args)
        want = PLAIN[name](*args)
        torch.cuda.synchronize()
        require(int(got[3]) == 0, f"{name} overflowed")
        err = max_abs_err(got, want)
        require(err == 0, f"{name} differs from its plain version by {err}"
                f" ({prm}, payload={with_payload})")
        errs[f"{name} {mode}"] = err
    halved, errs[f"K3 {mode}"] = check_subrange(
        "K3", f"{label}, {mode}", stages["K3"][0])
    if with_payload:
        m_halved, errs["K3M"] = check_subrange(
            "K3M", label, (*stages["K3"][0], rho3._modinv_pow2(salt)))
        require(m_halved == halved, f"K3M halved {m_halved} sub-ranges, K3 "
                f"{halved} ({label})")
    return halved


def check_routing(label, packed, pay, scale, k1_overflows, k2_overflows,
                  prm=rho3.Rho3Params()) -> None:
    """K1 and K2 against their plain versions on packed keys: exactly,
    or where K1 overflows (its slots keep what its scatter placed first)
    K1's counts and overflow, and K2 exactly on K1's output.  An overflow
    flag given as None is taken from the plain version.  Returns (K1's
    overflow, K2's)."""
    nb = rho3.num_blocks(packed.numel(), prm)
    got = rho3.k1(packed, pay, nb, prm, scale)
    want = rho3.k1_plain(packed, pay, nb, prm, scale)
    torch.cuda.synchronize()
    if k1_overflows is None:
        k1_overflows = int(want[3]) > 0
    what = f"{label}, payload={pay is not None}"
    require((int(got[3]) > 0) == k1_overflows
            and int(got[3]) == int(want[3]), f"K1 overflow {int(got[3])} "
            f"(plain {int(want[3])}) at {what}")
    err = max_abs_err(got[2:3] if k1_overflows else got, want[2:3]
                      if k1_overflows else want)
    require(err == 0, f"K1 differs from its plain version by {err} at {what}")
    k2 = rho3.k2(*got[:3], prm, scale)
    k2_want = rho3.k2_plain(*got[:3], prm, scale)
    torch.cuda.synchronize()
    if k2_overflows is None:
        k2_overflows = int(k2_want[3]) > 0
    require(k1_overflows or (int(k2[3]) > 0) == k2_overflows,
            f"K2 overflow {int(k2[3])} at {what}")
    err = max_abs_err(k2, k2_want)
    require(err == 0, f"K2 differs from its plain version by {err} at {what}")
    return int(got[3]), int(k2[3])


def routing_cases(r, s) -> dict:
    """K1 and K2's cases beyond the joins' geometries, at the default
    geometry: {label: (packed, payloads, scale, K1 overflows, K2
    overflows)}."""
    prm = rho3.Rho3Params()
    gen = torch.Generator(device=DEV).manual_seed(505)

    def ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=DEV,
                             dtype=torch.int64).int()

    pad = torch.tensor(rho3.KEY_PAD_INT, dtype=torch.int32, device=DEV)
    cases = {}
    # MWAY's range route: salt 1 and the range scale
    key = torch.cat([r.key, s.key])
    tag = torch.cat([torch.zeros_like(r.key), torch.ones_like(s.key)])
    packed, _ = rho3.pack_keys(key, tag, 1)
    cases["MWAY's scale"] = (packed, torch.cat([r.payload, s.payload]),
                             sortmerge.mway_scale(r.key, s.key), False, False)
    # the aggregate's input: 2^16 group keys of 64 rows, in runs of 64 in a
    # random order, 40% holes (dropped), value payloads, the range scale
    n = 4 << 20
    groups = torch.randperm(1 << 16, generator=gen, device=DEV)
    gkey = groups.repeat_interleave(64).int()
    gkey = torch.where(ints(n, 0, 10) < 4, aggpipe.MAX_KEY, gkey)
    packed, _ = rho3.pack_keys(gkey, torch.zeros_like(gkey), 1)
    cases["duplicate group keys"] = (packed, ints(n, -1000, 1000),
                                     aggpipe._range_scale(gkey, prm), False,
                                     False)
    # all keys equal: one slot of a block, one fine slot
    cases["all keys equal"] = (torch.full((4000,), 2 * 12345 + 1,
                                          dtype=torch.int32, device=DEV),
                               ints(4000, -(1 << 31), 1 << 31),
                               rho3.default_scale(prm), False, False)
    # a K2-only overflow: half the keys pads, 1,000 keys a block in fine
    # bucket 0; no K1 slot overflows, fine slot 0 of each window does
    n = prm.group * prm.block
    width = (1 << 31) // prm.gmax
    packed = torch.where(ints(n, 0, 2) == 0, pad, ints(n, 0, rho3.KEY_PAD_INT))
    packed = torch.where(ints(n, 0, 131) == 0, ints(n, 0, width - 2), packed)
    pay = ints(n, -(1 << 31), 1 << 31)
    cases["a K2-only overflow"] = (packed, pay, rho3.default_scale(prm),
                                   False, True)
    # a K1 overflow: 10% of the keys in level-1 bucket 0
    packed = torch.where(ints(n, 0, 10) == 0, ints(n, 0, width - 2),
                         ints(n, 0, rho3.KEY_PAD_INT))
    cases["a K1 overflow"] = (packed, pay, rho3.default_scale(prm), True,
                              True)
    return cases


def k1_library(packed, pay, nb, prm, scale):
    """K1's routing as PyTorch calls: one torch.sort of each block's
    packed keys (the 64-bit key << 32 | payload composite with payloads;
    pads past n), then each sorted key's level-1 bucket and one
    torch.searchsorted for the slots' starts."""
    v = packed.long()
    if pay is not None:
        v = (v << 32) | (pay.long() & U32)
    pad_v = rho3.KEY_PAD_INT << (32 if pay is not None else 0)
    full = torch.full((nb * prm.block,), pad_v, dtype=torch.int64,
                      device=DEV)
    full[:v.numel()] = v
    srt = torch.sort(full.view(nb, prm.block), dim=1).values
    key = (srt >> 32 if pay is not None else srt).int()
    b = rho3._fine_bucket(key, scale, prm.gmax) // prm.f2
    f = torch.arange(prm.f1 + 1, device=DEV).expand(nb, -1).contiguous()
    return srt, torch.searchsorted(b.contiguous(), f)


def k2_library(k1k, p1, prm, scale):
    """K2's routing as PyTorch calls: one torch.sort of each window's
    level-1 slots (pads included; the 64-bit composite with payloads), then
    each sorted key's fine bucket and one torch.searchsorted for the fine
    slots' starts."""
    nb = k1k.shape[0]
    nbg = nb // prm.group
    v = k1k.long()
    if p1 is not None:
        v = (v << 32) | (p1.long() & U32)
    win = v.view(nbg, prm.group, prm.f1, prm.cap1).permute(2, 0, 1, 3)
    srt = torch.sort(win.reshape(prm.f1 * nbg, -1), dim=1).values
    key = (srt >> 32 if p1 is not None else srt).int()
    b = rho3._fine_bucket(key, scale, prm.gmax) % prm.f2
    b = torch.where(key >= rho3.KEY_PAD_INT, prm.f2, b)
    j = torch.arange(prm.f2 + 1, device=DEV).expand(b.shape[0], -1)
    return srt, torch.searchsorted(b.contiguous(), j.contiguous())


LIBRARY = {"K1": (k1_library, "torch.sort of each block's packed keys (the "
                  "64-bit key << 32 | payload composite with payloads) + "
                  "the level-1 buckets + torch.searchsorted"),
           "K2": (k2_library, "torch.sort of each window's level-1 slots "
                  "(the 64-bit composite with payloads) + the fine buckets "
                  "+ torch.searchsorted")}


def live_sides(tk, tp, tcnt, sk=None, sp=None, scnt=None):
    """The live R elements of the table's fine slots and the live S
    elements of the probe's (K3: the same slots): (R keys, R payloads, S
    keys, S payloads, the S elements' flat positions in the probe's
    slots), payloads None without."""
    def live(k, p, cnt):
        m = torch.arange(k.shape[-1], device=DEV) < cnt[..., None].long()
        return m, k[m], None if p is None else p[m]

    m_t, key, pay = live(tk, tp, tcnt)
    m_s, skey, spay = (m_t, key, pay) if sk is None else live(sk, sp, scnt)
    r = (key & 1) == 0
    s = (skey & 1) == 1
    pos = torch.nonzero(m_s.view(-1), as_tuple=True)[0][s]
    return (key[r], None if pay is None else pay[r], skey[s],
            None if spay is None else spay[s], pos)


def join_library(rk, rp, sk, sp, pos=None, n_out=0):
    """The region join as PyTorch calls over the live elements (a region
    is a function of the packed key, so none is needed): keys-only
    torch.isin(S - 1, R) and a sum; with payloads torch.sort of R,
    torch.searchsorted of S - 1, a gather of the answering payloads and the
    checksum; with n_out, also the three output columns by index_put_ at
    the S elements' positions `pos`."""
    want = sk - 1
    if rp is None:
        return torch.isin(want, rk).sum()
    srt, order = torch.sort(rk)
    at = torch.searchsorted(srt, want).clamp_(max=srt.numel() - 1)
    hit = srt[at] == want
    r_pay = rp[order[at]]
    ck = torch.where(hit, (r_pay.long() & U32) + (sp.long() & U32),
                     0).sum() & U32
    if not n_out:
        return hit.sum(), ck
    q = pos[hit]
    cols = [torch.full((n_out,), -3, dtype=torch.int32, device=DEV),
            torch.zeros((n_out,), dtype=torch.int32, device=DEV),
            torch.zeros((n_out,), dtype=torch.int32, device=DEV)]
    vals = ((((sk[hit].long() >> 1) * INV) & rho3.HASH_MASK).int(),
            r_pay[hit], sp[hit])
    for col, v in zip(cols, vals):
        col.index_put_((q,), v)
    return (hit.sum(), ck, *cols)


JOIN_LIBRARY = ("torch.isin(S - 1, R) over the live elements (keys-only); "
                "with payloads torch.sort of R + torch.searchsorted + a "
                "gather")
JOIN_LIBRARY_MAT = ("torch.sort of the live R + torch.searchsorted of S - 1"
                    " + a gather + index_put_ of the three columns")


def compaction_inputs(n, drop, seed):
    """n keys of which a fraction `drop` are the input pad, and payloads."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    key = torch.randint(0, 1 << 20, (n,), generator=gen, device=DEV,
                        dtype=torch.int32)
    pay = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                        device=DEV, dtype=torch.int64).int()
    pad = torch.rand(n, generator=gen, device=DEV) < drop
    return torch.where(pad, lanecompact.PAD_S_INPUT, key), pay


def compaction_stages(key, pay, keep_frac, cap_rows):
    """The compactor's and the scatters' inputs on one column: returns
    {name: (kernel args, kernel fn, plain fn)} for compact_windows (key +
    payload, as compact_kp_fast calls it, and keys-only, as compact_k_fast
    does), scatter_segments and scatter_segments_one."""
    ow = lanecompact.out_w_for(W, keep_frac)
    fills = (lanecompact.PAD_S_INPUT, 0)
    b5 = (key, [key, pay], *KEEP_RANGE, W, fills, ow)
    b5k = (key, [key], *KEEP_RANGE, W, fills[:1], ow)
    blocks, counts = lanecompact._compact_windows(*b5)
    keys_blocks, _ = lanecompact._compact_windows(*b5k)
    desc, _, ovf = lanecompact._segments(counts, ow, cap_rows)
    nb = counts.numel()
    flat = [b.view(nb * ow, 128) for b in blocks]
    b6a = (*flat, *desc, nb, cap_rows + 1, fills[0])
    b6b = (keys_blocks[0].view(nb * ow, 128), *desc, nb, cap_rows + 1,
           fills[0])

    def plain6a(ks, ps, soff, doff, sz, nseg, out_rows, fill):
        return compact.scatter_segments_plain([ks, ps], soff, doff, sz,
                                              out_rows, fill)

    def plain6b(ks, soff, doff, sz, nseg, out_rows, fill):
        return compact.scatter_segments_plain([ks], soff, doff, sz,
                                              out_rows, fill)[0]

    return {"compact_windows": (b5, lanecompact._compact_windows,
                                lanecompact.compact_windows_plain),
            KEYS_ONLY_B5: (b5k, lanecompact._compact_windows,
                           lanecompact.compact_windows_plain),
            "scatter_segments": (b6a, compact.scatter_segments, plain6a),
            "scatter_segments_one": (b6b, compact.scatter_segments_one,
                                     plain6b)}, counts, ow, int(ovf)


def check_compaction(n, drop, keep_frac, seed, want_cut) -> None:
    key, pay = compaction_inputs(n, drop, seed)
    need = -(-int((key < lanecompact.PAD_R_INPUT).sum()) // 128)
    stages, counts, ow, ovf = compaction_stages(key, pay, keep_frac,
                                                need + 1024)
    cut = int((counts.long() > ow * 128).sum())
    require((cut > 0) == want_cut and (ovf > 0) == want_cut,
            f"compaction at drop={drop}, keep_frac={keep_frac}: {cut} "
            f"windows cut, overflow {ovf}")
    for name, (args, kernel, plain) in stages.items():
        got = flat_outputs(name, kernel(*args))
        want = flat_outputs(name, plain(*args))
        torch.cuda.synchronize()
        if not name.startswith("compact_windows"):  # callers drop the last row
            got, want = [g[:-1] for g in got], [w[:-1] for w in want]
        err = max_abs_err(got, want)
        require(err == 0, f"{name} differs from its plain version by {err}"
                f" (drop={drop}, keep_frac={keep_frac})")


def scatter_cases(src_rows, seed) -> dict:
    """{label: (soff, doff, sz, out_rows)} on the card: 3,000 segments in
    no order with gaps between them, the first live one past row 0, dead
    ones among them (size 0 or negative, a start below 0 or past the
    output), sources clamped below 0 and past the last row; the same cut
    at out_rows; none live; none at all."""
    rng = np.random.default_rng(seed)
    nseg = 3000
    sz = rng.integers(1, 80, nseg)
    doff = np.cumsum(rng.integers(0, 12, nseg) + sz) - sz + 1000
    end = int((doff + sz).max())
    soff = rng.integers(-40, src_rows, nseg)
    sz[::7] = 0
    sz[3::11] = -5
    doff[5::13] = -9
    doff[6::17] = end + 7000
    order = rng.permutation(nseg)
    desc = [torch.from_numpy(a[order].astype(np.int32)).to(DEV)
            for a in (soff, doff, sz)]
    none = torch.zeros(0, dtype=torch.int32, device=DEV)
    return {"gaps, dead segments, no order": (*desc, end + 5000),
            "cut at out_rows": (*desc, end * 2 // 3),
            "no live segment": (desc[0], desc[1], torch.zeros_like(desc[2]),
                                end),
            "no segment": (none, none, none, 4096)}


def check_scatter_cases() -> None:
    """B6a and B6b equal their plain versions on scatter_cases, every
    output row compared (the kernel writes each one, fill included)."""
    gen = torch.Generator(device=DEV).manual_seed(306)
    src_rows = 1 << 17
    ks, ps = (torch.randint(-(1 << 31), 1 << 31, (src_rows, 128),
                            generator=gen, device=DEV, dtype=torch.int64)
              .int() for _ in range(2))
    fill = lanecompact.PAD_S_INPUT
    for label, (soff, doff, sz, out_rows) in scatter_cases(src_rows,
                                                           307).items():
        nseg = soff.numel()
        got = [*compact.scatter_segments(ks, ps, soff, doff, sz, nseg,
                                         out_rows, fill),
               compact.scatter_segments_one(ks, soff, doff, sz, nseg,
                                            out_rows, fill)]
        want = compact.scatter_segments_plain([ks, ps], soff, doff, sz,
                                              out_rows, fill)
        torch.cuda.synchronize()
        err = max_abs_err(got, [*want, want[0]])
        require(err == 0, f"the segment scatter differs from its plain "
                f"version by {err} ({label})")
        covered = int((want[0] != fill).any(1).sum())
        say(f"scatter_segments and scatter_segments_one ({label}: {nseg} "
            f"segments, {out_rows} rows, {covered} not fill) equal their "
            "plain versions")


def same_live_rows(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(live_rows(*a),
                                                 live_rows(*b)))


def seeded(nr, ns, seed):
    r = create_relation_pk(nr, seed=seed, random_payload=True, device=DEV)
    s = create_relation_fk(ns, nr, seed=seed + 1, random_payload=True,
                           device=DEV)
    return r, s


def ladder_relations(seed):
    """R = 1M dense keys; S = 80 of them, 17,000 rows each, shuffled: more
    heavy keys than the skew tier's 64 candidates, each too many rows for
    a fine slot even at the residual geometry."""
    rl, _ = seeded(1 << 20, 4, seed)
    gen = torch.Generator(device=DEV).manual_seed(seed + 7)
    keys = torch.randperm(1 << 20, generator=gen, device=DEV)[:80] + 1
    sk = keys.repeat_interleave(17_000)
    sk = sk[torch.randperm(sk.numel(), generator=gen, device=DEV)]
    sp = torch.randint(-(1 << 31), 1 << 31, sk.shape, generator=gen,
                       device=DEV, dtype=torch.int64).int()
    return rl, Relation(key=sk.int(), payload=sp)


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: no answer"
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    # 2. build, and the block sort's register report beside it
    _, secs = build.build()
    build.load()
    say(f"build: {secs:.2f} s of nvcc")
    for source in ("blocksort.cu", "rho3.cu", "nphj.cu", "aggpipe.cu",
                   "lanecompact.cu", "compact.cu", "rstats.cu"):
        report = build.ptxas_report(source)
        for line in report:
            print(f"  {line}", flush=True)
        spill = build.spill_bytes(report)
        require(spill == 0, f"{source} spills {spill} bytes")
        say(f"{source}: -Xptxas -v shows 0 bytes of spill stores and loads")

    # 3. kernels against their plain versions, moderate sizes
    # (the small geometry's slots only hold a small input)
    for label, prm, nr in (("default", rho3.Rho3Params(), 1 << 20),
                           ("small", SMALL_GEOM, 1 << 14),
                           ("skew residual", skewtier._skew_prm(), 1 << 20),
                           *((v, nphj.VARIANT_PARAMS[v], 1 << 20)
                             for v in ("PHT_no", "PHT_un", "PHT_o"))):
        r, s = seeded(nr, 4 * nr, seed=101)
        for with_payload in (False, True):
            check_kernels(r.key, r.payload, s.key, s.payload, prm,
                          with_payload, label)
    # duplicate R keys: K3's rule for which R copy answers must agree too
    gen = torch.Generator(device=DEV).manual_seed(202)
    rk, sk = (torch.randint(1, 1 << 19, (n,), generator=gen, device=DEV,
                            dtype=torch.int32) for n in (1 << 20, 4 << 20))
    rp, sp = (torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                            device=DEV, dtype=torch.int64).int()
              for n in (1 << 20, 4 << 20))
    for with_payload in (False, True):
        check_kernels(rk, rp, sk, sp, rho3.Rho3Params(), with_payload,
                      "duplicate R keys")
    # MWAY's range route: salt 1 and the range scale, so a region holds an
    # ascending key range (K3M's first column is the key itself)
    rm, sm = seeded(1 << 20, 4 << 20, seed=102)
    for with_payload in (False, True):
        check_kernels(rm.key, rm.payload, sm.key, sm.payload,
                      rho3.Rho3Params(), with_payload, "MWAY's range route",
                      salt=1, scale=sortmerge.mway_scale(rm.key, sm.key))
    del rm, sm
    # K3 where a region's R passes one CTA's array: R = 13.1M, S = 1M at
    # f2 = 8 with 16,384-value fine slots (PHT_o's geometry), the
    # sub-ranges must halve
    rh, sh = seeded(NR, 1 << 20, seed=404)
    for with_payload in (False, True):
        halved = check_kernels(rh.key, rh.payload, sh.key, sh.payload,
                               nphj.VARIANT_PARAMS["PHT_o"], with_payload,
                               "R-heavy, f2 = 8 / kd = 128")
        require(halved > 0, "K3 halved no sub-range where a region's R "
                "passes one CTA's array")
    # one R key 5,000 times, its copies spread over R (distinct payloads),
    # at the skew residual's 16,384-value fine slots, which hold them
    rh, sh = seeded(4 << 20, 4 << 20, seed=505)
    gen = torch.Generator(device=DEV).manual_seed(506)
    rk = torch.cat([rh.key, rh.key[7:8].repeat(5000)])
    rp = torch.cat([rh.payload, torch.randint(
        -(1 << 31), 1 << 31, (5000,), generator=gen, device=DEV,
        dtype=torch.int64).int()])
    perm = torch.randperm(rk.numel(), generator=gen, device=DEV)
    for with_payload in (False, True):
        check_kernels(rk[perm], rp[perm], sh.key, sh.payload,
                      skewtier._skew_prm(), with_payload,
                      "one R key 5,000 times")
    del rh, sh, rk, rp, perm
    for label, (packed, pay, scale, k1_ovf, k2_ovf) in routing_cases(
            r, s).items():
        for with_payload in (False, True):
            check_routing(label, packed, pay if with_payload else None,
                          scale, k1_ovf, k2_ovf)
    # the compactor and the scatters at w=512: windows cut and not cut
    for drop, keep_frac, cut in ((0.5, None, False), (0.9, 0.1, False),
                                 (0.5, 0.1, True)):
        check_compaction((4 << 20) + 77, drop, keep_frac, 303, cut)
    say("kernels: K1, K2, K3, K3M, compact_windows, scatter_segments and "
        "scatter_segments_one equal their plain versions (default, small, "
        "residual, PHT_no, PHT_un and PHT_o geometry, unique and duplicate "
        "R keys, keys-only and with payloads; K3 and K3M also on MWAY's "
        "range route, R-heavy at f2 = 8 / kd = 128 (halving) and on one R "
        "key 5,000 times; K1 and K2 on MWAY's scale, "
        "duplicate group keys, equal keys, a K2-only and a K1 overflow; "
        "windows cut and not cut)")

    # a small input against a plain dictionary-free numpy oracle
    rs, ss = seeded(4096, 16384, seed=7)
    res, _ = run_join(rs, ss, "RHO", JoinConfig(dense_path=False),
                      device=DEV)
    rk, rp = rs.key.cpu().numpy(), rs.payload.cpu().numpy()
    sk, sp = ss.key.cpu().numpy(), ss.payload.cpu().numpy()
    order = np.argsort(rk)
    at = np.searchsorted(rk[order], sk)
    want_c = int((rp[order][at].astype(np.int64) & 0xFFFFFFFF).sum()
                 + (sp.astype(np.int64) & 0xFFFFFFFF).sum()) & 0xFFFFFFFF
    require(int(res.matches) == 16384 and int(res.checksum) == want_c,
            "small RHO join disagrees with the numpy oracle")
    del r, s, rs, ss

    # 4. the slice at full width
    relR, relS = seeded(NR, NS, seed=11111)
    torch.cuda.synchronize()
    say(f"data: |R| = {NR}, |S| = {NS} on the card")
    reset_launches()
    keys_res, _ = run_join(relR, relS, "RHO", JoinConfig(checksum=False))
    sum_res, _ = run_join(relR, relS, "RHO", JoinConfig())
    fm, fc, fovf = engine.rho_join_count_fused(relR.key, relR.payload,
                                               relS.key, relS.payload)
    torch.cuda.synchronize()
    launches = main_path_launches("4 slice")
    say(f"main path launches: {launches}")
    require(all(launches[k] > 0 for k in ("K1", "K2", "K3")),
            f"a kernel was not launched on the main path: {launches}")
    require(skewtier.skew_plan(relS.key) == (False, 0),
            "uniform keys were planned as skewed")
    exact = mergejoin.merge_join_count(relR.key, relR.payload, relS.key,
                                       relS.payload)
    require(int(exact.matches) == NS, "exact core: matches != |S|")
    require(int(keys_res.matches) == NS, "keys-only RHO: matches != |S|")
    require(int(keys_res.checksum) == 0, "keys-only RHO: checksum != 0")
    require(int(sum_res.matches) == NS, "RHO: matches != |S|")
    require(int(sum_res.checksum) == int(exact.checksum),
            "RHO: checksum != exact core")
    require(int(fovf) == 0, "fused: overflow")
    require((int(fm), int(fc)) == (NS, int(exact.checksum)),
            "fused: result != exact core")
    say(f"slice: matches = {NS}, checksum = {int(exact.checksum)} "
        "(= exact core), overflow 0")
    slice_ms = {}
    for label, cfg in (("keys-only", JoinConfig(checksum=False)),
                       ("checksummed", JoinConfig())):
        ms = cuda_ms(lambda: run_join(relR, relS, "RHO", cfg), REPS)
        slice_ms[label] = ms
        say(f"run_join RHO {label} (skew_plan cached in front): {ms:.3f} "
            f"ms/call, {(NR + NS) / ms / 1e3:.1f} M rows/s")
    ms = cuda_ms(lambda: engine.rho_join_count_fused(
        relR.key, relR.payload, relS.key, relS.payload), REPS)
    say(f"engine.rho_join_count_fused: {ms:.3f} ms/call, "
        f"{(NR + NS) / ms / 1e3:.1f} M rows/s")

    def pack():
        key = torch.cat([relR.key, relS.key])
        tag = torch.cat([torch.zeros_like(relR.key),
                         torch.ones_like(relS.key)])
        return rho3.pack_keys(key, tag, rho3.HASH_C)

    pack_ms = cuda_ms(pack, REPS)
    say(f"pack_keys (plain PyTorch, before K1): {pack_ms:.3f} ms/call")
    print(json.dumps({"slice": {k: {"ms": v, "mrows_per_s":
                                    (NR + NS) / v / 1e3}
                                for k, v in slice_ms.items()},
                      "fused_ms": ms, "pack_ms": pack_ms}), flush=True)

    # 5. each kernel at the main path's shapes
    rows = {}
    for with_payload in (False, True):
        _, stages = stage_inputs(relR.key, relR.payload, relS.key,
                                 relS.payload, rho3.Rho3Params(),
                                 with_payload)
        mode = "payload" if with_payload else "keys-only"
        for name in ("K1", "K2", "K3"):
            args, _ = stages[name]
            if name == "K3":
                _, err = check_subrange("K3", f"headline, {mode}", args)
                out = None
            else:
                out = KERNEL[name](*args)
                want = PLAIN[name](*args)
                torch.cuda.synchronize()
                err = max_abs_err(out, want)
                require(err == 0, f"{name} differs from its plain version "
                        f"at the headline shape (payload={with_payload})")
                del want
            k_ms = cuda_ms(lambda: KERNEL[name](*args), REPS)
            p_ms = cuda_ms(lambda: PLAIN[name](*args), 1)
            bound = kernel_bytes(name, args, out) / HBM_BYTES_PER_S * 1e3
            lib_ms = lib_call = None
            if name in LIBRARY:
                lib, lib_call = LIBRARY[name]
                lib_args = ((args[0], args[1], args[2], args[3], args[4])
                            if name == "K1" else
                            (args[0], args[1], args[3], args[4]))
                lib_ms = cuda_ms(lambda: lib(*lib_args), REPS)
            if name == "K3":
                sides = live_sides(*args)[:4]
                lib_ms = cuda_ms(lambda: join_library(*sides), REPS)
                lib_call = JOIN_LIBRARY
                del sides
            row = kernel_row(name, err, k_ms, p_ms, bound, lib_ms, lib_call)
            say(f"{name} {'payload' if with_payload else 'keys-only'}: "
                f"{k_ms:.3f} ms (plain {p_ms:.3f} ms, bound {bound:.3f} "
                f"ms, library {lib_ms} ms)")
            if with_payload:
                row["launches"] = launches[name]
                print(json.dumps({"with_payload": row}), flush=True)
            else:
                rows[name] = row
        if with_payload:   # K3M takes K3's inputs with payloads
            args = (*stages["K3"][0], INV)
            _, err = check_subrange("K3M", "headline", args)
            k_ms = cuda_ms(lambda: rho3.k3m(*args), REPS)
            p_ms = cuda_ms(lambda: rho3.k3m_plain(*args), 1)
            k2k, k2p, cnt2 = args[:3]
            nbytes_ = (int(cnt2.sum()) * 8 + nbytes(cnt2) + 16
                       + 3 * k2k.numel() * 4)
            bound = nbytes_ / HBM_BYTES_PER_S * 1e3
            sides = live_sides(*args[:3])
            lib_ms = cuda_ms(lambda: join_library(*sides, k2k.numel()), REPS)
            del sides
            rows["K3M"] = kernel_row("K3M", err, k_ms, p_ms, bound, lib_ms,
                                     JOIN_LIBRARY_MAT)
            say(f"K3M payload: {k_ms:.3f} ms (plain {p_ms:.3f} ms, bound "
                f"{bound:.3f} ms, library {lib_ms:.3f} ms)")
        del stages
        torch.cuda.synchronize()

    # 6. the ladder.  One key on a quarter of S: the skew plan hints, and
    # the heavy-split tier answers with one pipeline run.
    rl, sl = seeded(1 << 20, 4 << 20, seed=303)
    skey = sl.key.clone()
    skey[: skey.numel() // 4] = 77
    sl = Relation(key=skey, payload=sl.payload)
    reset_launches()
    res, _ = run_join(rl, sl, "RHO", JoinConfig(dense_path=False))
    exact = mergejoin.merge_join_count(rl.key, rl.payload, sl.key,
                                       sl.payload)
    require(rho3.LAUNCHES["K1"] == 1,
            f"the skew tier did not answer first: {rho3.LAUNCHES}")
    require((int(res.matches), int(res.checksum))
            == (int(exact.matches), int(exact.checksum))
            and int(res.matches) == sl.num_tuples,
            "the skew tier's answer != exact core")
    # 80 heavy keys: every salt and the skew tier overflow
    rl, sl = ladder_relations(404)
    for salt in rho3.RETRY_SALTS:
        _, _, ovf = rho3.rho_join_count_v3(rl.key, rl.payload, sl.key,
                                           sl.payload, salt=salt)
        require(int(ovf) > 0, "the duplicate-heavy input did not overflow")
    reset_launches()
    res, _ = run_join(rl, sl, "RHO", JoinConfig(dense_path=False))
    exact = mergejoin.merge_join_count(rl.key, rl.payload, sl.key,
                                       sl.payload)
    require(rho3.LAUNCHES["K1"] == len(rho3.RETRY_SALTS) + 1,
            f"the ladder did not try every tier: {rho3.LAUNCHES}")
    require((int(res.matches), int(res.checksum))
            == (int(exact.matches), int(exact.checksum))
            and int(res.matches) == sl.num_tuples,
            "the ladder's answer != exact core")
    say("ladder: one heavy key -> the skew tier answered; 80 heavy keys -> "
        "every salt and the skew tier overflowed, the exact core answered")
    del rl, sl, skey, res

    # 7. materialize at full width, on phase 4's relations
    reset_launches()
    mres, _ = run_join(relR, relS, "RHO", JoinConfig(materialize=True))
    fused = engine.rho_join_materialize_fused(relR.key, relR.payload,
                                              relS.key, relS.payload)
    torch.cuda.synchronize()
    mat_launches = main_path_launches("7 materialize")
    say(f"materialize path launches: {mat_launches}")
    require(mat_launches["K3M"] > 0, "K3M was not launched")
    exact = mergejoin.merge_join_materialize(relR.key, relR.payload,
                                             relS.key, relS.payload, NS)
    want_rows = (exact.key, exact.r_payload, exact.s_payload)
    require(int(exact.matches) == NS, "exact core: matches != |S|")
    require(mres.overflow is None and int(fused[5]) == 0,
            "materialize: overflow")
    for label, got in (("run_join", (mres.matches, mres.checksum,
                                     mres.key, mres.r_payload,
                                     mres.s_payload)),
                       ("fused", fused[:5])):
        require((int(got[0]), int(got[1])) == (NS, int(exact.checksum)),
                f"materialize {label}: matches/checksum != exact core")
        require(got[2].numel() == mres.key.numel(),
                f"materialize {label}: column length")
        require(same_live_rows(got[2:5], want_rows),
                f"materialize {label}: live rows != exact core's")
    out_len = mres.key.numel()
    agg_input = (fused[2], fused[4])     # phase 10 groups this output
    del mres, fused, exact, want_rows
    mat_ms = {}
    for label, fn in (
            ("run_join", lambda: run_join(relR, relS, "RHO",
                                          JoinConfig(materialize=True))),
            ("fused", lambda: engine.rho_join_materialize_fused(
                relR.key, relR.payload, relS.key, relS.payload))):
        mat_ms[label] = cuda_ms(fn, REPS)
        say(f"materialize {label}: {mat_ms[label]:.3f} ms/call, "
            f"{(NR + NS) / mat_ms[label] / 1e3:.1f} M rows/s "
            f"({out_len} output rows per column, holes included)")

    def pack_with_payloads():
        key = torch.cat([relR.key, relS.key])
        tag = torch.cat([torch.zeros_like(relR.key),
                         torch.ones_like(relS.key)])
        return (rho3.pack_keys(key, tag, rho3.HASH_C),
                torch.cat([relR.payload, relS.payload]))

    mat_ms["pack_with_payloads"] = cuda_ms(pack_with_payloads, REPS)
    say(f"pack_keys + payload concatenation (plain PyTorch, before K1): "
        f"{mat_ms['pack_with_payloads']:.3f} ms/call")
    print(json.dumps({"materialize": {k: {"ms": v, "mrows_per_s":
                                          (NR + NS) / v / 1e3}
                                      for k, v in mat_ms.items()},
                      "out_len": out_len}), flush=True)

    # 8. skew at full width: Zipf S over R's keys
    skew_launches = {k: 0 for k in read_launches()}
    skew_out = {}
    for z in (1.5, 1.0):
        zs = create_relation_zipf(NS, NR, z, seed=22222, random_payload=True,
                                  device=DEV)
        hinted, cap = skewtier.skew_plan(zs.key)
        say(f"z={z}: skew_plan hinted={hinted} cap_rows={cap} "
            f"(fraction {cap * 128 / NS:.4f})")
        require(hinted or z != 1.5, f"z={z}: not hinted")
        exact = mergejoin.merge_join_count(relR.key, relR.payload, zs.key,
                                           zs.payload)
        runs = [("keys-only", JoinConfig(checksum=False)),
                ("checksummed", JoinConfig())]
        if z == 1.5:
            runs.append(("materialize", JoinConfig(materialize=True)))
        for label, cfg in runs:
            # a fresh key tensor has its own plan, as a new relation would
            s = Relation(key=zs.key.clone(), payload=zs.payload)
            reset_launches()
            res, _ = run_join(relR, s, "RHO", cfg)
            torch.cuda.synchronize()
            got = main_path_launches(f"8 z={z} {label}")
            for k, v in got.items():
                skew_launches[k] += v
            want_c = 0 if label == "keys-only" else int(exact.checksum)
            require((int(res.matches), int(res.checksum))
                    == (int(exact.matches), want_c),
                    f"z={z} {label}: result != exact core")
            if cap and label != "materialize":
                one = label == "keys-only"
                require(got["compact_windows"] > 0 and got[
                    "scatter_segments_one" if one else "scatter_segments"]
                    > 0, f"z={z} {label}: the compacted tier's kernels "
                    f"were not launched: {got}")
            if label == "materialize":
                require(got["K3M"] > 0, f"z={z}: K3M was not launched")
                ref = mergejoin.merge_join_materialize(
                    relR.key, relR.payload, zs.key, zs.payload, NS)
                require(same_live_rows(
                    (res.key, res.r_payload, res.s_payload),
                    (ref.key, ref.r_payload, ref.s_payload)),
                    f"z={z} materialize: live rows != exact core's")
                del ref
            plan_after = skewtier.skew_plan(s.key)
            del res
            ms = cuda_ms(lambda: run_join(relR, s, "RHO", cfg), REPS)
            skew_out[f"z={z} {label}"] = {
                "ms": ms, "mrows_per_s": (NR + NS) / ms / 1e3,
                "plan_after": list(plan_after), "launches_first_call": got}
            say(f"z={z} run_join RHO {label}: {ms:.3f} ms/call, "
                f"{(NR + NS) / ms / 1e3:.1f} M rows/s; first call "
                f"launches {got}; plan after it {plan_after}")
        # the two skew tiers directly, keys-only with R proven dense (the
        # form experiments/run_r5_studies.py times)
        for capr in sorted({0, cap}):
            def tier(capr=capr):
                return skewtier.skew_fused_count(
                    relR.key, relR.payload, zs.key, zs.payload,
                    rho3.RETRY_SALTS[0], with_checksum=False,
                    resid_cap_rows=capr, r_dense=True)
            m, _, ovf = tier()
            ms = cuda_ms(tier, REPS)
            skew_out[f"z={z} skew_fused_count cap_rows={capr}"] = {
                "ms": ms, "overflow": int(ovf), "matches": int(m)}
            say(f"z={z} skew_fused_count keys-only cap_rows={capr}: "
                f"overflow {int(ovf)}, {ms:.3f} ms/call")
        if z == 1.5:
            compaction_rows = time_compaction(relR, zs, cap, rows)
            skew_out["z=1.5 steps"] = skew_steps(relR, zs, cap)
        del zs, exact
        torch.cuda.synchronize()
    print(json.dumps({"skew": skew_out}), flush=True)
    say(f"skew path launches: {skew_launches}")
    rows.update(compaction_rows)

    for name in ("compact_windows", "scatter_segments",
                 "scatter_segments_one"):
        require(skew_launches[name] > 0, f"{name} was not launched on the "
                "skew path")
    torch.cuda.synchronize()

    # 9. scans at full width
    rows.update(scan_phase())
    # 10. the aggregate at full width, on phase 7's materialize output
    rows.update(aggregate_phase(*agg_input))
    del agg_input
    torch.cuda.synchronize()
    # 11. the no-partition family at full width, on phase 4's relations
    rows.update(nopart_phase(relR, relS))
    torch.cuda.synchronize()
    # 12. the partition-and-sort side at full width, on phase 4's relations
    rows.update(sort_phase(relR, relS))
    torch.cuda.synchronize()
    # 13. the seven join names left (plain PyTorch), on phase 4's relations
    print(json.dumps(families_phase(relR, relS, card)), flush=True)
    with tempfile.TemporaryDirectory() as store:
        # 14. the TPC-H layer at SF 10: the dbgen store and synthetic
        # tables
        tpch_out = tpch_phase(card, store)
        print(json.dumps(tpch_out), flush=True)
        del relS
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        # 15. the entry points: the CLI, the harness, the profiler and the
        # streaming join, on the dbgen store before it is removed
        entry_phase(card, store, tpch_out["tpch"]["dbgen"]["oracle"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # 16. 64-bit keys through every join name, join --key64 and the four
    # join-sweep drivers at full size
    print(json.dumps(key64_phase(card)), flush=True)
    # 17. the distributed layer on one rank, phase 4's relations
    print(json.dumps(parallel_phase(card)), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # 18. the six drivers at their full default sizes
    with tempfile.TemporaryDirectory() as store:
        print(json.dumps(drivers_phase(card, store)), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # 19. after every main path: the scatters' full-size cases and the
    # device operations of one RSTATS or scatter call
    device_op_checks(rows)
    say(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    # each kernel's launches over every phase's main path (K1 and K2 run in
    # phases 4, 7, 8, 10, 11, 12, 14, 15, 16, 17 and 18)
    total = {k: sum(p[k] for p in MAIN_PATH.values()) for k in SOURCE}
    print(json.dumps({"main_path_launches": MAIN_PATH, "total": total}),
          flush=True)
    for k in SOURCE:
        require(total[k] > 0, f"{k} was launched on no main path")
        rows[k]["launches"] = total[k]
    print(json.dumps({"halvings": HALVINGS}), flush=True)
    print(json.dumps({"kernels": [rows[k] for k in SOURCE]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def skew_steps(relR, zs, cap) -> dict:
    """ms of each step of the two skew tiers at z = 1.5, keys-only (R
    proven dense) and checksummed: candidates, R-side statistics, the
    split pass, the compaction (compacted tier) and the residual
    pipeline."""
    steps = {}
    prm = skewtier._skew_prm()
    hk = skewtier.heavy_candidates(zs.key)
    steps["heavy_candidates"] = cuda_ms(
        lambda: skewtier.heavy_candidates(zs.key), REPS)
    for label, cs in (("keys-only", False), ("checksummed", True)):
        if cs:
            rcnt, rph = skewtier.r_cand_stats(relR.key, relR.payload, hk)
            pres = (hk >= 0) & (rcnt > 0)
            steps[f"{label} r_cand_stats"] = cuda_ms(
                lambda: skewtier.r_cand_stats(relR.key, relR.payload, hk),
                REPS)
        else:
            pres = (hk >= 1) & (hk <= NR)
            rph = torch.zeros(hk.shape, dtype=torch.int64, device=DEV)
        _, _, sk_res = skewtier.heavy_split_pass(zs.key, zs.payload, hk,
                                                 pres, rph, with_pay=cs)
        _, stages = stage_inputs(relR.key, relR.payload, sk_res, zs.payload,
                                 prm, cs)
        check_subrange("K3", f"z=1.5 residual, {label}", stages["K3"][0])
        del stages
        steps[f"{label} heavy_split_pass"] = cuda_ms(
            lambda: skewtier.heavy_split_pass(zs.key, zs.payload, hk, pres,
                                              rph, with_pay=cs), REPS)
        steps[f"{label} residual pipeline"] = cuda_ms(
            lambda: rho3.rho_join_count_v3(relR.key, relR.payload, sk_res,
                                           zs.payload, prm=prm,
                                           with_checksum=cs), REPS)
        kf = min(1.0, cap * 128 / NS)
        if cs:
            def squeeze():
                return lanecompact.compact_kp_fast(
                    sk_res, zs.payload, cap, keep_frac=kf)
        else:
            def squeeze():
                k, o = lanecompact.compact_k_fast(sk_res, cap, keep_frac=kf)
                return k, torch.zeros_like(k), o
        ck, cp, _ = squeeze()
        steps[f"{label} compaction"] = cuda_ms(squeeze, REPS)
        steps[f"{label} compacted residual pipeline (overflows)"] = cuda_ms(
            lambda: rho3.rho_join_count_v3(relR.key, relR.payload, ck, cp,
                                           prm=prm, with_checksum=cs), REPS)
    for k, v in steps.items():
        say(f"z=1.5 step {k}: {v:.3f} ms")
    return steps


def residual_stages(relR, zs, cap):
    """compaction_stages on the z = 1.5 residual (the skew tier's remapped
    S), and that residual."""
    hk = skewtier.heavy_candidates(zs.key)
    rcnt, rph = skewtier.r_cand_stats(relR.key, relR.payload, hk)
    pres = (hk >= 0) & (rcnt > 0)
    _, _, sk_res = skewtier.heavy_split_pass(zs.key, zs.payload, hk, pres,
                                             rph)
    keep_frac = min(1.0, cap * 128 / NS)
    return (*compaction_stages(sk_res, zs.payload, keep_frac, cap), sk_res)


def time_compaction(relR, zs, cap, rows) -> dict:
    """The compactor and the scatters at the z = 1.5 residual's shapes:
    exact agreement, time, plain time, bound and the one-call equivalent
    (boolean-mask selection of the same column)."""
    stages, counts, ow, ovf, sk_res = residual_stages(relR, zs, cap)
    sp = zs.payload
    n = sk_res.numel()
    nb = counts.numel()
    lo, hi = KEEP_RANGE

    def select_pair():
        m = sk_res <= hi
        return torch.masked_select(sk_res, m), torch.masked_select(sp, m)

    def select_key():
        return torch.masked_select(sk_res, sk_res <= hi)

    lib_pair = cuda_ms(select_pair, REPS)
    lib_key = cuda_ms(select_key, REPS)
    covered = int(stages["scatter_segments"][0][4].long().sum())
    out_rows = cap + 1
    kept = (sk_res >= lo) & (sk_res <= hi)
    out_block = nb * ow * 128 * 4
    bytes_of = {
        # the key column is read whole, once, although it is also array 0;
        # the payload only where a key is kept, in whole 32-byte sectors
        "compact_windows": n * 4 + 32 * kept_sectors(kept) + 2 * out_block
        + nb * 4,
        KEYS_ONLY_B5: n * 4 + out_block + nb * 4,
        "scatter_segments": 2 * covered * 512 + 2 * out_rows * 512
        + 3 * nb * 4,
        "scatter_segments_one": covered * 512 + out_rows * 512 + 3 * nb * 4,
    }
    library = {
        "compact_windows": (lib_pair, "torch.masked_select of key and "
                            "payload: one call for B5+B6a together"),
        KEYS_ONLY_B5: (lib_key, "torch.masked_select of the key: one call "
                       "for B5+B6b together"),
        "scatter_segments": (lib_pair, "torch.masked_select of key and "
                             "payload: one call for B5+B6a together"),
        "scatter_segments_one": (lib_key, "torch.masked_select of the key: "
                                 "one call for B5+B6b together"),
    }
    out = {}
    for name, (args, kernel, plain) in stages.items():
        got = flat_outputs(name, kernel(*args))
        want = flat_outputs(name, plain(*args))
        torch.cuda.synchronize()
        if not name.startswith("compact_windows"):
            got, want = [g[:-1] for g in got], [w[:-1] for w in want]
        err = max_abs_err(got, want)
        require(err == 0, f"{name} differs from its plain version at the "
                "z=1.5 residual's shape")
        del got, want
        k_ms = cuda_ms(lambda: kernel(*args), REPS)
        p_ms = cuda_ms(lambda: plain(*args), 1)
        bound = bytes_of[name] / HBM_BYTES_PER_S * 1e3
        out[name] = kernel_row(name.split()[0], err, k_ms, p_ms, bound,
                               *library[name])
        say(f"{name} (z=1.5 residual, ow={ow}, {int(counts.sum())} kept, "
            f"overflow {ovf}): {k_ms:.3f} ms (plain {p_ms:.3f} ms, bound "
            f"{bound:.3f} ms from {bytes_of[name]} bytes, "
            f"{library[name][1]}: {library[name][0]:.3f} ms)")
    keys_only = out.pop(KEYS_ONLY_B5)
    out["compact_windows"]["keys_only"] = {
        k: keys_only[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "library_ms", "library_call")}
    return out


def kept_sectors(kept: torch.Tensor) -> int:
    """32-byte sectors (8 int32 elements) that hold at least one kept
    element: the least the card can read of a column to fetch those."""
    pad = -kept.numel() % 8
    kept = torch.cat([kept, kept.new_zeros(pad)])
    return int(kept.view(-1, 8).any(1).sum())


SCAN_LO, SCAN_HI = 32, 200          # bench.py's predicate (first pass)
SCALE_UP_ROWS = 1 << 34             # the reference's DRAM scale-up column
READ_ROWS = 1 << 30                 # scan_bench.py's read-only modes
BENCH_SCAN_ROWS = 1 << 28           # bench.py's scan leg
BENCH_SCAN_PASSES = 32
WRITE_ROWS = {"index": 1 << 29, "values": 1 << 28, "dict": 1 << 28}
AGG_GROUPS = 1 << 20                # bench.py's group key: the low 20 bits
AGG_CAP = 1 << 21
LOW_GROUPS = 64                     # the jittered branch's case


def byte_column(n: int) -> torch.Tensor:
    """scan_bench.py's column arange(n) & 255 as uint8 (n a multiple of
    256), a 256-byte pattern repeated: no wider intermediate."""
    return torch.arange(256, dtype=torch.uint8, device=DEV).repeat(n // 256)


def in_range(lo: int, hi: int):
    """The bytes of one 256-row cycle of byte_column in [lo, hi]."""
    return [b for b in range(256) if lo <= b <= hi]


def sel_bound(sel: float) -> int:
    """scan_bench.py's predicate [0, hi] for a selectivity fraction."""
    return max(0, min(255, round(sel * 256) - 1))


def scan_form_args(col, hi, sel_hint, mode, tables):
    """The window kernel's arguments as scan_<mode>_fast passes them."""
    ow = lanecompact.out_w_for(W, sel_hint)
    kw = {"with_ids": True}
    fills = ()
    if mode == "values":
        kw["with_values"] = True
        fills = (0,)
    if mode == "dict":
        kw["dict_tables"] = tables
    return (col, [], 0, hi, W, fills, ow), kw


def check_scan_kernels(tables) -> None:
    """B7, B8 and B5's scan forms equal their plain versions: odd lengths,
    an unaligned start, empty and clamped ranges; windows cut and not cut,
    uint8 and int32 columns; B5 (its scan forms and the join's key +
    payload form) also on columns starting 1, 7 and 15 bytes (uint8) and
    one element (int32) past a 16-byte boundary, n not a multiple of
    16."""
    gen = torch.Generator(device=DEV).manual_seed(909)
    base = torch.randint(0, 256, ((1 << 24) + 45,), generator=gen,
                         device=DEV, dtype=torch.uint8)
    pairs = ((kscan.count, kscan.count_plain), (kscan.sum_, kscan.sum_plain),
             (kscan.bitvector, kscan.bitvector_plain))
    for col in (base, base[3:], base[5:1000]):
        for lo, hi in ((32, 200), (0, 255), (250, 400), (9, 3)):
            for kernel, plain in pairs:
                got, want = kernel(col, lo, hi), plain(col, lo, hi)
                torch.cuda.synchronize()
                err = max_abs_err([got], [want])
                require(err == 0, f"{kernel.__name__} differs from its plain "
                        f"version by {err} (n={col.numel()}, [{lo}, {hi}])")
    col8 = base[:(4 << 20) + 77]
    for col in (col8, col8.int()):
        for hint in (None, 0.1):
            for mode in ("index", "values", "dict"):
                args, kw = scan_form_args(col, 180, hint, mode, tables)
                args = (args[0], args[1], 30) + args[3:]
                got = lanecompact._compact_windows(*args, **kw)
                want = lanecompact.compact_windows_plain(*args, **kw)
                torch.cuda.synchronize()
                err = max_abs_err([*got[0], got[1]], [*want[0], want[1]])
                require(err == 0, f"compact_windows {mode} differs from its "
                        f"plain version by {err} ({col.dtype}, hint {hint})")
                cut = int((got[1].long() > args[6] * 128).sum())
                require((cut > 0) == (hint == 0.1),
                        f"compact_windows {mode}: {cut} windows cut")
    # unaligned starts: the window kernel reads a head and a tail of each
    # window one element at a time, and the whole 16-byte vectors between
    n = (4 << 20) + 77
    wide = base[:n + 1].int()
    for col in (base[1:1 + n], base[7:7 + n], base[15:15 + n], wide[1:]):
        require(col.data_ptr() % 16 != 0 and n % 16 != 0,
                "an unaligned column was not unaligned")
        for hint in (None, 0.1):
            for mode in ("index", "values", "dict"):
                args, kw = scan_form_args(col, 180, hint, mode, tables)
                args = (args[0], args[1], 30) + args[3:]
                got = lanecompact._compact_windows(*args, **kw)
                want = lanecompact.compact_windows_plain(*args, **kw)
                torch.cuda.synchronize()
                err = max_abs_err([*got[0], got[1]], [*want[0], want[1]])
                require(err == 0, f"compact_windows {mode} differs from its "
                        f"plain version by {err} ({col.dtype}, start "
                        f"{col.data_ptr() % 16} bytes past 16, hint {hint})")
    key, pay = compaction_inputs(n + 1, 0.9, 304)
    key, pay = key[1:], pay[1:]
    for keep_frac in (None, 0.05):
        args = (key, [key, pay], *KEEP_RANGE, W, (lanecompact.PAD_S_INPUT, 0),
                lanecompact.out_w_for(W, keep_frac))
        got = lanecompact._compact_windows(*args)
        want = lanecompact.compact_windows_plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err([*got[0], got[1]], [*want[0], want[1]])
        require(err == 0, f"compact_windows (key + payload) differs from "
                f"its plain version by {err} (int32 column one element past "
                f"16 bytes, keep_frac {keep_frac})")


def check_write_mode(mode, col, hi, out, tables) -> None:
    """A write mode's block-granular output against the dense forms: no
    overflow, the closed-form count, the live row ids equal to
    ops/scan.scan_index's in order, and their values / decoded planes."""
    n = col.numel()
    want = n // 256 * len(in_range(0, hi))
    require(int(out[-1]) == 0 and int(out[-2]) == want,
            f"{mode} scan at {n} rows, [0, {hi}]: count {int(out[-2])} "
            f"(want {want}), overflow {int(out[-1])}")
    ids = out[0]
    live = ids < lanecompact.PAD_S_INPUT
    dense, cnt = scan.scan_index(col, 0, hi, n)
    got_ids = ids[live]
    require(int(cnt) == want and torch.equal(got_ids, dense[:want]),
            f"{mode} scan: live row ids != the dense index scan's")
    codes = col[got_ids.long()].long()
    if mode == "values":
        require(torch.equal(out[1][live], codes.int()),
                "values scan: values != the column's")
    if mode == "dict":
        require(torch.equal(out[1][live], tables[0][codes])
                and torch.equal(out[2][live], tables[1][codes]),
                "dict scan: planes != the dictionary's")


def bench_scan_passes(col):
    """bench.py's scan leg: 32 count passes with lo = 32 + i, hi = 200."""
    total = torch.zeros((), dtype=torch.int64, device=DEV)
    for i in range(BENCH_SCAN_PASSES):
        total += scan.scan_count(col, SCAN_LO + i, SCAN_HI)
    return total


def scan_phase() -> dict:
    """Phase 9: the scan family at full width.  Returns the kernels'
    rows."""
    tables = (torch.arange(256, dtype=torch.int32, device=DEV) * 7,
              torch.arange(256, dtype=torch.int32, device=DEV) * 7 + 1)
    check_scan_kernels(tables)
    say("scans: count, sum, bitvector and the window kernel's index, values "
        "and dict forms equal their plain versions (odd n, unaligned start, "
        "clamped and empty ranges; uint8 and int32, windows cut and not; "
        "B5 also at uint8 starts 1, 7 and 15 bytes and an int32 start 4 "
        "bytes past a 16-byte boundary, the join's form included)")
    big = byte_column(SCALE_UP_ROWS)
    torch.cuda.synchronize()
    # the main path: every scan mode through the entry points a user calls
    reset_launches()
    c34 = scan.scan_count(big, SCAN_LO, SCAN_HI)
    s34 = scan.scan_sum(big, SCAN_LO, SCAN_HI)
    b34 = scan.scan_bitvector(big, SCAN_LO, SCAN_HI)
    bench_total = bench_scan_passes(big[:BENCH_SCAN_ROWS])
    for mode, n in WRITE_ROWS.items():
        col = big[:n]
        for sel in (0.1, 0.5):
            hi = sel_bound(sel)
            extra = tables if mode == "dict" else ()
            out = getattr(kscan, f"scan_{mode}_pallas")(
                col, *extra, 0, hi, n // 128, sel_hint=sel)
            check_write_mode(mode, col, hi, out, tables)
            del out
    low = kscan.scan_index_pallas(big[:WRITE_ROWS["index"]], 0,
                                  sel_bound(0.5), WRITE_ROWS["index"] // 128,
                                  sel_hint=0.1)
    torch.cuda.synchronize()
    launches = main_path_launches("9 scans")
    say(f"scan path launches: {launches}")
    require(int(low[-1]) > 0, "a hint below the selectivity did not report "
            "overflow")
    del low
    for name in ("scan_count", "scan_sum", "scan_bitvector",
                 "compact_windows_index", "compact_windows_values",
                 "compact_windows_dict"):
        require(launches[name] > 0, f"{name} was not launched on the scan "
                "path")
    cyc = in_range(SCAN_LO, SCAN_HI)
    reps = SCALE_UP_ROWS // 256
    pat = kscan.bitvector_plain(big[:256].cpu(), SCAN_LO, SCAN_HI).to(DEV)
    require(int(c34) == reps * len(cyc) and int(s34) == reps * sum(cyc),
            "2^34-row count/sum != the closed form")
    require(bool((b34.view(-1, 32) == pat).all()),
            "2^34-row bitvector != the closed form")
    want_bench = sum(BENCH_SCAN_ROWS // 256 * len(in_range(SCAN_LO + i,
                                                           SCAN_HI))
                     for i in range(BENCH_SCAN_PASSES))
    require(int(bench_total) == want_bench, "bench.py's scan passes: total "
            f"{int(bench_total)} != {want_bench}")
    del b34
    out = {"rows_2^34": {}}
    for label, fn in (("count", scan.scan_count), ("sum", scan.scan_sum),
                      ("bitvector", scan.scan_bitvector)):
        ms = cuda_ms(lambda: fn(big, SCAN_LO, SCAN_HI), 3)
        out["rows_2^34"][label] = {"ms": ms, "gb_per_s":
                                   SCALE_UP_ROWS / ms / 1e6}
        say(f"{label} over 2^34 rows (16 GiB, exact): {ms:.3f} ms, "
            f"{SCALE_UP_ROWS / ms / 1e6:.1f} GB/s")
    col28 = big[:BENCH_SCAN_ROWS]
    ms = cuda_ms(lambda: bench_scan_passes(col28), REPS)
    out["bench_scan"] = {"ms": ms, "gb_per_s": BENCH_SCAN_PASSES
                         * BENCH_SCAN_ROWS / ms / 1e6}
    say(f"bench.py's scan leg (32 count passes over 2^28 rows, exact): "
        f"{ms:.3f} ms, {out['bench_scan']['gb_per_s']:.1f} GB/s")
    rows = {}
    out["write_modes"] = {}
    for mode, n in WRITE_ROWS.items():
        col = big[:n]
        hi = sel_bound(0.1)
        args, kw = scan_form_args(col, hi, 0.1, mode, tables)
        name = f"compact_windows_{mode}"
        got = lanecompact._compact_windows(*args, **kw)
        want = lanecompact.compact_windows_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err([*got[0], got[1]], [*want[0], want[1]])
        require(err == 0, f"{name} differs from its plain version at {n} "
                "rows")
        del want
        k_ms = cuda_ms(lambda: lanecompact._compact_windows(*args, **kw),
                       REPS)
        p_ms = cuda_ms(lambda: lanecompact.compact_windows_plain(*args, **kw),
                       1)
        nb, ow = got[1].numel(), args[6]
        bound = (n + len(got[0]) * nb * ow * 128 * 4 + nb * 4) \
            / HBM_BYTES_PER_S * 1e3
        del got

        def composition(col=col, hi=hi, mode=mode):
            m = kscan.range_mask(col, 0, hi)
            if mode == "index":
                return torch.nonzero(m)
            v = torch.masked_select(col, m)
            return (tables[0][v.long()], tables[1][v.long()]) \
                if mode == "dict" else v

        lib_ms = cuda_ms(composition, REPS)
        lib_call = {"index": "torch.nonzero of the range mask",
                    "values": "torch.masked_select by the range mask",
                    "dict": "torch.masked_select + two table gathers"}[mode]
        rows[name] = kernel_row(name, err, k_ms, p_ms, bound, lib_ms,
                                lib_call)
        fn = getattr(kscan, f"scan_{mode}_pallas")
        extra = tables if mode == "dict" else ()
        e_ms = cuda_ms(lambda: fn(col, *extra, 0, hi, n // 128,
                                  sel_hint=0.1), REPS)
        out["write_modes"][mode] = {"rows": n, "ms": e_ms, "read_gb_per_s":
                                    n / e_ms / 1e6}
        say(f"{name} ({n} rows, 10%, hint 0.1, ow={ow}): {k_ms:.3f} ms "
            f"(plain {p_ms:.3f}, bound {bound:.3f}, {lib_call} "
            f"{lib_ms:.3f} ms); scan_{mode}_pallas {e_ms:.3f} ms, "
            f"{n / e_ms / 1e6:.1f} GB/s read")
    del big, col, col28
    # each of B7 and B8 against its plain version at 2^30 random rows
    gen = torch.Generator(device=DEV).manual_seed(910)
    col30 = torch.randint(0, 256, (READ_ROWS,), generator=gen, device=DEV,
                          dtype=torch.uint8)
    for name, kernel, plain in (
            ("scan_count", kscan.count, kscan.count_plain),
            ("scan_sum", kscan.sum_, kscan.sum_plain),
            ("scan_bitvector", kscan.bitvector, kscan.bitvector_plain)):
        got, want = kernel(col30, SCAN_LO, SCAN_HI), plain(col30, SCAN_LO,
                                                           SCAN_HI)
        torch.cuda.synchronize()
        err = max_abs_err([got], [want])
        require(err == 0, f"{name} differs from its plain version at 2^30 "
                "rows")
        k_ms = cuda_ms(lambda: kernel(col30, SCAN_LO, SCAN_HI), REPS)
        p_ms = cuda_ms(lambda: plain(col30, SCAN_LO, SCAN_HI), 1)
        nbytes_ = READ_ROWS + (READ_ROWS // 8 if name == "scan_bitvector"
                               else 8)
        bound = nbytes_ / HBM_BYTES_PER_S * 1e3
        lib_ms, lib_call = None, None
        if name != "scan_bitvector":
            lib_ms = cuda_ms(lambda: torch.bincount(col30, minlength=256),
                             REPS)
            lib_call = ("torch.bincount of the column (a histogram, from "
                        "which a 256-entry epilogue gives the result)")
        rows[name] = kernel_row(name, err, k_ms, p_ms, bound, lib_ms,
                                lib_call)
        say(f"{name} (2^30 rows): {k_ms:.3f} ms, {READ_ROWS / k_ms / 1e6:.1f}"
            f" GB/s (plain {p_ms:.3f} ms, bound {bound:.3f} ms"
            + (f", {lib_call.split(' (')[0]} {lib_ms:.3f} ms)" if lib_ms
               else ")"))
    host = torch.empty((READ_ROWS,), dtype=torch.uint8, pin_memory=True)
    host.copy_(col30)
    want = int(kscan.count_plain(col30, SCAN_LO, SCAN_HI))
    got = scan.scan_count_streamed(host, SCAN_LO, SCAN_HI)
    require(int(got) == want, "scan_count_streamed != the count")
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        int(scan.scan_count_streamed(host, SCAN_LO, SCAN_HI))
        times.append(time.perf_counter() - t0)
    out["streamed_2^30"] = {"s": times, "gb_per_s": READ_ROWS / min(times)
                            / 1e9}
    say(f"scan_count_streamed over a 2^30-row pinned host column (exact): "
        f"{min(times) * 1e3:.3f} ms, {READ_ROWS / min(times) / 1e9:.1f} GB/s")
    del col30, host
    print(json.dumps({"scan": out}), flush=True)
    return rows


def check_k3agg() -> None:
    """K3AGG equals its plain version exactly (all six outputs) on
    range-routed slots: the default geometry with 2^16 groups of wide
    values, the small one, an input with holes, the 64-group leg's jittered
    keys, one key filling a whole region (single-key pieces), sparse keys
    over [0, 2^30 - 2) gathered near the start of each region (its first
    sub-range halves) and empty regions; each case prints the pieces it
    halved."""
    gen = torch.Generator(device=DEV).manual_seed(808)
    prm = rho3.Rho3Params()

    def ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=DEV,
                             dtype=torch.int64).int()

    def holes(key, frac):
        return torch.where(torch.rand(key.numel(), generator=gen,
                                      device=DEV) < frac, -3, key)

    cases = {}
    for label, p, n, groups in (("2^16 groups", prm, 4 << 20, 1 << 16),
                                ("small geometry", SMALL_GEOM, 1 << 16, 3000),
                                ("2^19 groups", prm, (1 << 20) + 99,
                                 1 << 19)):
        cases[label] = (p, holes(ints(n, 0, groups) * 5, 0.1))
    # the 64-group leg's first level: 64 keys jittered into 32,768
    n = 8 << 20
    cases["64 groups, jittered"] = (prm, aggpipe.jittered_keys(
        holes(ints(n, 0, LOW_GROUPS), 0.1), aggpipe.jitter_for(LOW_GROUPS)))
    # one key fills region (0, 0): cap2 rows of key 0 in each of two
    # windows (~256 a K1 block); the other keys lie past 2^16, outside its
    # fine bucket and its level-1 bucket
    win = prm.group * prm.block
    key = ints(2 * win, 1 << 16, 1 << 20)
    for w0 in (0, win):
        key[torch.randperm(win, generator=gen, device=DEV)[:prm.cap2]
            + w0] = 0
    cases["one key fills a region"] = (prm, key)
    # sparse keys: half spread over [0, 2^30 - 2), half on 256 keys an
    # eighth into a region's key range
    n = 4 << 20
    width = (1 << 30) // prm.gmax
    near = ints(n, 0, prm.gmax) * width + width // 8 + ints(n, 0, 256)
    cases["sparse keys"] = (prm, torch.where(ints(n, 0, 2) == 0,
                                             ints(n, 0, rho3.MAX_KEY), near))
    # empty regions: keys below 7 * 2^17 and 100 rows of 2^20 - 1 (the
    # top eighth of the regions is empty but for one)
    n = 2 << 20
    key = holes(ints(n, 0, 7 << 17), 0.2)
    key[ints(100, 0, n).long()] = (1 << 20) - 1
    cases["empty regions"] = (prm, key)
    for label, (p, key) in cases.items():
        val = ints(key.numel(), -(1 << 31), 1 << 31)
        args = k3agg_inputs(key, val, p)
        require(int(args[3]) == 0, f"routing overflowed in the K3AGG check "
                f"({label})")
        k2, _, cnt2 = args[:3]
        halved, _ = check_subrange("K3AGG", label, args[:3])
        if label == "one key fills a region":
            require(bool((cnt2[0, :, 0] == p.cap2).all())
                    and bool((k2[0, :, 0] == 0).all()),
                    "key 0 does not fill region (0, 0)")
        if label == "sparse keys":
            require(halved > 0, "K3AGG halved no piece where a sub-range "
                    "passes one CTA's array")
        if label == "empty regions":
            require(bool((cnt2.sum(dim=1) == 0).any()), "no region is empty")
        del args, k2, cnt2


def agg_library(key, val):
    """K3AGG's groups as PyTorch calls over the live (key, value) rows (a
    region is a function of the key): torch.sort, the group starts,
    bincount for the counts, index_add_ for the sums mod 2^32 and
    scatter_reduce_ for the min and max."""
    srt, order = torch.sort(key)
    start = torch.ones_like(srt, dtype=torch.bool)
    start[1:] = srt[1:] != srt[:-1]
    gid = torch.cumsum(start, 0) - 1
    val = val[order]
    cnt = torch.bincount(gid)
    sm = torch.zeros(cnt.shape, dtype=torch.int64, device=DEV).index_add_(
        0, gid, val.long() & U32) & U32
    mn = torch.full(cnt.shape, 2 ** 31 - 1, dtype=torch.int32, device=DEV)
    mn.scatter_reduce_(0, gid, val, "amin")
    mx = torch.full(cnt.shape, -2 ** 31, dtype=torch.int32, device=DEV)
    mx.scatter_reduce_(0, gid, val, "amax")
    return srt[start], cnt, sm, mn, mx


AGG_LIBRARY = ("torch.sort of the live group keys + bincount + index_add_ "
               "+ scatter_reduce_ (amin, amax)")


def k3agg_inputs(key, val, prm):
    """K3AGG's inputs as groupby_aggregate_routed makes them: (k2, v2,
    cnt2, overflow, nbg)."""
    key = torch.where(key < 0, rho3.MAX_KEY, key)
    scale = aggpipe._range_scale(key, prm)
    packed, _ = rho3.pack_keys(key, torch.zeros_like(key), 1)
    k2, v2, cnt2, nbg, ovf = rho3.route_2level(packed, val, prm, True,
                                               scale=scale)
    return k2, v2, cnt2, ovf, nbg


def live_groups(g):
    """The live rows (key != -3) of a group-by result, in output order."""
    live = g.key != -3
    return [c[live].long() for c in (g.key, g.count, g.sum, g.min, g.max)]


def same_groups(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(live_groups(got),
                                                 live_groups(want)))


def aggregate_phase(key, spay) -> dict:
    """Phase 10: bench.py's aggregate leg over phase 7's materialize output,
    the jittered branch at 64 groups, and K3AGG alone at the leg's K2
    shapes.  Returns the kernel's row."""
    check_k3agg()
    say("aggregate: K3AGG equals its plain version (default and small "
        "geometry, holes, wide values, 64 jittered groups, one key filling a "
        "region, sparse keys (halving), empty regions)")
    # bench.py sizes the compaction at ceil(|S| / 128) + 16 rows and does
    # not read its overflow; the block-granular output can need one partial
    # row per window more than that (1,152 windows here), so the leg gets
    # that much room and its overflow is checked
    cap_rows = -(-NS // 128) + -(-key.numel() // (W * 128))
    gk = {g: torch.where(key < 0, rho3.PAD_S_INPUT, key & (g - 1))
          for g in (AGG_GROUPS, LOW_GROUPS)}
    caps = {AGG_GROUPS: AGG_CAP, LOW_GROUPS: LOW_GROUPS}

    def leg(groups):
        ck, cv, ovf = lanecompact.compact_kp_fast(gk[groups], spay, cap_rows)
        return aggpipe.groupby_aggregate_routed_auto(ck, cv, caps[groups]), ovf

    torch.cuda.synchronize()
    reset_launches()
    res = {g: leg(g) for g in (AGG_GROUPS, LOW_GROUPS)}
    torch.cuda.synchronize()
    launches = main_path_launches("10 aggregate")
    say(f"aggregate path launches: {launches}")
    for name in ("compact_windows", "scatter_segments", "scatter_segments_one",
                 "K1", "K2", "K3AGG"):
        require(launches[name] > 0, f"{name} was not launched on the "
                "aggregate path")
    out = {}
    for groups, (g, covf) in res.items():
        oracle = aggregate.groupby_aggregate(
            torch.where(key < 0, -3, key & (groups - 1)), spay, 2 * groups)
        require(int(covf) == 0, "compact_kp_fast overflowed")
        require(int(g.num_groups) == groups <= caps[groups],
                f"{groups} groups: num_groups {int(g.num_groups)}")
        require(same_groups(g, oracle), f"{groups} groups: the routed rows "
                "!= the sort-based aggregate's")
        out[f"groups={groups}"] = {"out_len": g.key.numel()}
        del oracle
    del res
    for groups in (AGG_GROUPS, LOW_GROUPS):
        ms = cuda_ms(lambda: leg(groups), REPS)
        out[f"groups={groups}"].update(ms=ms, mrows_per_s=NS / ms / 1e3)
        say(f"aggregate leg, {groups} groups (compact_kp_fast + "
            f"groupby_aggregate_routed_auto, capacity {caps[groups]}): "
            f"{ms:.3f} ms, {NS / ms / 1e3:.1f} M rows/s over the live rows")
    okey = torch.where(key < 0, -3, key & (AGG_GROUPS - 1))
    out["sort_based_ms"] = cuda_ms(
        lambda: aggregate.groupby_aggregate(okey, spay, AGG_CAP), 1)
    # the 2^20-group leg step by step
    prm = rho3.Rho3Params()
    ck, cv, _ = lanecompact.compact_kp_fast(gk[AGG_GROUPS], spay, cap_rows)
    cap1 = AGG_CAP + 128 * prm.f1 * prm.f2 + 128
    kk = torch.where(ck < 0, rho3.MAX_KEY, ck)
    scale = aggpipe._range_scale(kk, prm)
    packed, _ = rho3.pack_keys(kk, torch.zeros_like(kk), 1)
    k2, v2, cnt2, nbg, ovf = rho3.route_2level(packed, cv, prm, True,
                                               scale=scale)
    blocks = aggpipe.k3agg(k2, v2, cnt2)
    steps = {
        "compact_kp_fast": lambda: lanecompact.compact_kp_fast(
            gk[AGG_GROUPS], spay, cap_rows),
        "range scale (kmax, host sync)": lambda: aggpipe._range_scale(kk,
                                                                      prm),
        "pack_keys": lambda: rho3.pack_keys(kk, torch.zeros_like(kk), 1),
        "route_2level (K1 + K2)": lambda: rho3.route_2level(
            packed, cv, prm, True, scale=scale),
        "K3AGG": lambda: aggpipe.k3agg(k2, v2, cnt2),
        "assembly (segments + scatters)": lambda: aggpipe.assemble_regions(
            list(blocks[:5]), blocks[5], ovf, nbg, prm, cap1),
    }
    # the 64-group leg's first level (the routed pipeline on the jittered
    # keys) and its K3AGG
    ck64, cv64, _ = lanecompact.compact_kp_fast(gk[LOW_GROUPS], spay,
                                                cap_rows)
    jit = aggpipe.jitter_for(LOW_GROUPS)
    ek = aggpipe.jittered_keys(ck64, jit)
    cap64 = LOW_GROUPS * jit + 128 * prm.f1 * prm.f2 + 128
    args64 = k3agg_inputs(ek, cv64, prm)
    require(int(args64[3]) == 0, "the 64-group leg's routing overflowed")
    check_subrange("K3AGG", f"{LOW_GROUPS} groups, the leg's jittered keys",
                   args64[:3])
    steps[f"{LOW_GROUPS} groups: routed pipeline on the jittered keys "
          f"(jitter {jit})"] = lambda: aggpipe.groupby_aggregate_routed(
              ek, cv64, cap64)
    steps[f"{LOW_GROUPS} groups: K3AGG"] = lambda: aggpipe.k3agg(
        *args64[:3])
    out["steps_ms"] = {k: cuda_ms(f, REPS) for k, f in steps.items()}
    # K3AGG's two passes (reduce, place) apart
    out["k3agg_split_us"] = {
        f"{AGG_GROUPS} groups": kernel_split(steps["K3AGG"]),
        f"{LOW_GROUPS} groups": kernel_split(steps[f"{LOW_GROUPS} groups: "
                                                  "K3AGG"])}
    say(f"K3AGG's passes, device us a call: {out['k3agg_split_us']}")
    for k, v in out["steps_ms"].items():
        say(f"aggregate step {k}: {v:.3f} ms")
    del ck64, cv64, ek, args64
    # K3AGG alone at the leg's K2 shapes
    _, err = check_subrange("K3AGG", f"{AGG_GROUPS} groups, the leg's "
                            "shapes", (k2, v2, cnt2))
    k_ms = out["steps_ms"]["K3AGG"]
    p_ms = cuda_ms(lambda: aggpipe.k3agg_plain(k2, v2, cnt2), 1)
    groups = int(blocks[5].long().sum())
    # the bound: the live pairs and the counts read, the five full region
    # blocks (rows and fill) and the region counts written; the rows alone
    # (20 bytes a group) beside it, as the bound was counted before
    read = int(cnt2.long().sum()) * 8 + cnt2.numel() * 4
    nbytes_ = read + nbytes(*blocks)
    rows_only = read + groups * 20 + blocks[5].numel() * 4
    bound = nbytes_ / HBM_BYTES_PER_S * 1e3
    live = torch.arange(k2.shape[-1], device=DEV) < cnt2[..., None].long()
    live &= (k2 >= 0) & (k2 != rho3.KEY_PAD_INT)
    lk, lv = k2[live], v2[live]
    lib_ms = cuda_ms(lambda: agg_library(lk, lv), REPS)
    del live, lk, lv
    row = kernel_row("K3AGG", err, k_ms, p_ms, bound, lib_ms, AGG_LIBRARY)
    say(f"K3AGG ({groups} groups over {int(cnt2.long().sum())} routed rows, "
        f"nbg={nbg}): {k_ms:.3f} ms (plain {p_ms:.3f} ms, bound "
        f"{bound:.3f} ms from {nbytes_} bytes with the full region blocks; "
        f"{rows_only} bytes with the rows alone, "
        f"{rows_only / HBM_BYTES_PER_S * 1e3:.3f} ms; library "
        f"{lib_ms:.3f} ms)")
    print(json.dumps({"aggregate": out}), flush=True)
    return {"K3AGG": row}


NOPART_NAMES = ("PHT", "PHT_no", "PHT_un", "PHT_o", "NPO_st", "NPO_no")


def nphj_stage(rk, rp, sk, sp, prm, with_payload):
    """K3TWO's inputs as nphj_probe makes them (table slots, payloads and
    counts, then S's) and the routing's overflow."""
    tk2, tp2, tcnt, t_ovf = nphj.nphj_build(rk, rp, prm,
                                            with_payload=with_payload)
    sk2, sp2, scnt, s_ovf = nphj._route_s(sk, sp, prm, rho3.HASH_C,
                                          with_payload)
    return (tk2, tp2, tcnt, sk2, sp2, scnt), int(t_ovf) + int(s_ovf)


def random_pairs(nr, ns, hi, seed, unique_r=True, hit=1.0, repeat=0):
    """R keys in [1, hi) (unique or not), S keys drawn from R with
    probability `hit` and else from [1, hi); seeded payloads.  With
    `repeat`, one R key more `repeat` times, at random places."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    rk = torch.randint(1, hi, (nr,), generator=gen, device=DEV)
    if unique_r:    # a few fewer than nr keys, in random order
        rk = torch.unique(rk)
        rk = rk[torch.randperm(rk.numel(), generator=gen, device=DEV)]
        nr = rk.numel()
    pick = rk[torch.randint(0, nr, (ns,), generator=gen, device=DEV)]
    miss = torch.randint(1, hi, (ns,), generator=gen, device=DEV)
    sk = torch.where(torch.rand(ns, generator=gen, device=DEV) < hit, pick,
                     miss)
    if repeat:
        rk = torch.cat([rk, rk[:1].repeat(repeat)])
        rk = rk[torch.randperm(rk.numel(), generator=gen, device=DEV)]
    rp, sp = (torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                            device=DEV, dtype=torch.int64).int()
              for n in (rk.numel(), ns))
    return rk.int(), rp, sk.int(), sp


# tests/test_torch_nphj.py's geometry (its R-more-runs shape below)
NPHJ_TEST_GEOM = rho3.Rho3Params(block_rows=64, slot_rows=8, f1=16, f2=4,
                                 kd_slot_rows=16)


def check_nphj_kernels() -> None:
    """K3TWO and K3TWO_MAT equal their plain versions exactly."""
    default = rho3.Rho3Params()
    skew = skewtier._skew_prm()
    cases = [  # (label, prm, R, S, hi, unique R, hit rate, materialize)
        ("default", default, 1 << 20, 8 << 20, 1 << 29, True, 0.8, True),
        ("small", SMALL_GEOM, 1 << 14, 1 << 16, 1 << 20, True, 0.8, True),
        ("PHT_un", nphj.VARIANT_PARAMS["PHT_un"], 1 << 20, 8 << 20, 1 << 29,
         True, 0.8, False),
        ("PHT_o", nphj.VARIANT_PARAMS["PHT_o"], 1 << 20, 8 << 20, 1 << 29,
         True, 0.8, False),
        ("skew residual", skewtier._skew_prm(), 1 << 20, 8 << 20, 1 << 29,
         True, 0.8, False),
        ("empty table runs", default, 2048, 1 << 20, 1 << 29, True, 0.01,
         True),
        ("more table runs than S runs", default, 8 << 20, 1 << 20, 1 << 29,
         True, 0.8, True),
        # nbg_r > nbg_s at a small geometry: the chunk's tail is longer
        # than the S runs
        ("R-more-runs test geometry", NPHJ_TEST_GEOM, 1 << 18, 4096, 1 << 19,
         True, 0.5, True),
        ("duplicate R keys", default, 1 << 20, 8 << 20, 1 << 19, False, 0.8,
         True),
        # one R key 5,000 times (past a CTA's 4,096-key array; the
        # skew residual's fine slots hold the copies)
        ("repeated R key", skew, 8 << 20, 1 << 20, 1 << 29, True, 0.8,
         True),
    ]
    for label, prm, nr, ns, hi, unique, hit, mat in cases:
        rk, rp, sk, sp = random_pairs(nr, ns, hi, 1101, unique, hit,
                                      5000 if label == "repeated R key"
                                      else 0)
        for with_payload in (False, True):
            args, ovf = nphj_stage(rk, rp, sk, sp, prm, with_payload)
            require(ovf == 0, f"nphj routing overflowed ({label})")
            halved, _ = check_subrange(
                "K3TWO", f"{label}, "
                f"{'payload' if with_payload else 'keys-only'}", args)
            # 8M table keys over 2 sub-ranges a region: ~6,900 R each
            require(halved > 0 or label != "more table runs than S runs",
                    "K3TWO halved no sub-range where a region's R passes "
                    "one CTA's array")
            if with_payload and mat:
                require(args[0].shape[1] > args[3].shape[1]
                        or label != "R-more-runs test geometry",
                        f"nbg_r {args[0].shape[1]} <= nbg_s "
                        f"{args[3].shape[1]} ({label})")
                m_halved, _ = check_subrange("K3TWO_MAT", label, args)
                require(m_halved == halved, f"K3TWO_MAT halved {m_halved} "
                        f"sub-ranges, K3TWO {halved} ({label})")
            del args


def rstats_candidates(rk, seed) -> torch.Tensor:
    """64 slots: -1s, keys of R (one repeated), keys R lacks."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    present = rk[torch.randint(0, rk.numel(), (48,), generator=gen,
                               device=DEV)]
    absent = torch.tensor([0, (1 << 30) - 3, 2_000_000_001], device=DEV,
                          dtype=torch.int32)
    hk = torch.cat([torch.full((10,), -1, dtype=torch.int32, device=DEV),
                    present, present[:3], absent])
    return hk[torch.randperm(64, generator=gen, device=DEV)]


def colliding_candidates(rk, count) -> torch.Tensor:
    """`count` keys of R that share one home entry of RSTATS's smallest
    table (2,048 entries: key * 0x9E3779B1 >> 21)."""
    home = ((rk.long() * 0x9E3779B1) & U32) >> 21
    mode = torch.bincount(home).argmax()
    return rk[home == mode][:count]


def rstats_cases():
    """{label: (rk, rp, hk)} at full size: the cases RSTATS's design must
    get right besides the odd lengths and starts of check_rstats."""
    rk, rp, _, _ = random_pairs(NR, 1, 1 << 23, 1204, True)
    cases = {}
    for label, hk in (("h = 1, a key of R", rk[5:6]),
                      ("h = 1, -1", torch.full((1,), -1, dtype=torch.int32,
                                               device=DEV)),
                      ("h = 1, a key R lacks", torch.zeros(
                          1, dtype=torch.int32, device=DEV))):
        cases[label] = (rk, rp, hk)
    # 1,024 slots: keys of R (some repeated), -1s and keys R lacks
    gen = torch.Generator(device=DEV).manual_seed(1205)
    present = rk[torch.randint(0, rk.numel(), (960,), generator=gen,
                               device=DEV)]
    hk = torch.cat([present, present[:40],
                    torch.full((20,), -1, dtype=torch.int32, device=DEV),
                    torch.arange(1 << 23, (1 << 23) + 4, dtype=torch.int32,
                                 device=DEV)])
    cases["h = 1,024"] = (rk, rp, hk[torch.randperm(1024, generator=gen,
                                                    device=DEV)])
    # 40 candidates on one home entry, -1s and repeats
    coll = colliding_candidates(rk, 40)
    cases["40 colliding candidates"] = (rk, rp, torch.cat([
        coll, coll[:4], torch.full((20,), -1, dtype=torch.int32,
                                   device=DEV)]))
    # phase 12's duplicate-key R (RHT's, drawn from 4M values), and R
    # sorted into runs of 4,096 equal keys (a warp's lanes on one key)
    dk, dp, _, _ = random_pairs(NR, 1, 1 << 22, 1502, unique_r=False)
    cases["R drawn from 4M values"] = (dk, dp, rstats_candidates(dk, 1206))
    runs = (torch.arange(NR, device=DEV, dtype=torch.int32) >> 12) + 1
    cases["R in runs of 4,096 keys"] = (runs, dp, rstats_candidates(
        runs, 1207))
    return cases


def check_rstats() -> None:
    """RSTATS equals its plain version exactly: odd lengths, starts off a
    16-byte boundary (alike and unlike for keys and payloads), duplicate R
    keys, -1 and repeated candidate slots; then at full size h = 1 and h
    = 1,024, candidates colliding in the kernel's table, an R drawn from
    4M values and an R in long runs of one key, and two calls in a row on
    different candidates."""
    def same(keys, pays, hk, with_pay, what):
        got = rstats.r_cand_stats_kernel(keys, pays, hk, with_pay)
        want = rstats.r_cand_stats_plain(keys, pays, hk, with_pay)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"RSTATS differs from its plain version by {err} "
                f"({what}, n={keys.numel()}, h={hk.numel()}, "
                f"payload={with_pay})")
        return got

    for unique in (True, False):
        rk, rp, _, _ = random_pairs((1 << 22) + 77, 1, 1 << 23, 1202,
                                    unique)
        hk = rstats_candidates(rk, 1203)
        for keys, pays in ((rk, rp), (rk[1:], rp[1:]), (rk[1:-2], rp[2:-1])):
            for with_pay in (True, False):
                got = same(keys, pays, hk, with_pay, f"unique R {unique}")
                require(int(got[0].sum()) > 0, "RSTATS counted nothing")
    cases = rstats_cases()
    for label, (rk, rp, hk) in cases.items():
        for with_pay in (True, False):
            got = same(rk, rp, hk, with_pay, label)
        say(f"RSTATS {label}: {int(got[0].sum())} rows counted, equal to "
            "the plain version")
    # two calls in a row on different candidates, read after both
    rk, rp, hk = cases["R drawn from 4M values"]
    rk, rp = rk[3:], rp[3:]
    hk2 = rstats_candidates(rk, 1208)
    got = [rstats.r_cand_stats_kernel(rk, rp, h, True) for h in (hk, hk2)]
    for g, h in zip(got, (hk, hk2)):
        err = max_abs_err(g, rstats.r_cand_stats_plain(rk, rp, h, True))
        require(err == 0, f"RSTATS's second call in a row differs by {err}")


def nopart_main_path(relR, relS, zs):
    """Phase 11's main path through run_join and nphj; returns the results
    to check, and for z = 1.5 the pipeline attempts of each call."""
    out = {}
    out["PHT keys-only"] = run_join(relR, relS, "PHT",
                                    JoinConfig(checksum=False))[0]
    for name in NOPART_NAMES:
        out[name] = run_join(relR, relS, name, JoinConfig())[0]
    out["PHT materialize"] = run_join(relR, relS, "PHT",
                                      JoinConfig(materialize=True))[0]
    table = nphj.nphj_build(relR.key, relR.payload)
    out["nphj_probe"] = [nphj.nphj_probe(*table, relS.key, relS.payload)
                         for _ in range(2)]
    del table
    out["NPBC_st"] = run_join(relR, relS, "NPBC_st", JoinConfig())[0]
    out["PHT profile_phases"] = run_join(relR, relS, "PHT", JoinConfig(
        profile_phases=True))[0]
    attempts = {}
    for label, cfg in (("keys-only", JoinConfig(checksum=False)),
                       ("checksummed", JoinConfig())):
        s = Relation(key=zs.key.clone(), payload=zs.payload)
        before = read_launches()
        out[f"z=1.5 {label}"] = run_join(relR, s, "PHT", cfg)[0]
        torch.cuda.synchronize()
        after = read_launches()
        attempts[label] = {k: after[k] - before[k] for k in after}
    return out, attempts


def check_nopart_results(out, relR, relS, exact, exact_z) -> None:
    want = (NS, int(exact.checksum))
    require((int(out["PHT keys-only"].matches),
             int(out["PHT keys-only"].checksum)) == (NS, 0),
            "PHT keys-only: result != (|S|, 0)")
    for name in NOPART_NAMES + ("NPBC_st", "PHT profile_phases"):
        res = out[name]
        require((int(res.matches), int(res.checksum)) == want,
                f"{name}: result != exact core")
    for m, c, ovf in out["nphj_probe"]:
        require((int(m), int(c), int(ovf)) == (*want, 0),
                "nphj_probe on a reused table: result != exact core")
    mres = out["PHT materialize"]
    prm = nphj.VARIANT_PARAMS["PHT"]
    nbg_r = rho3.num_blocks(NR, prm) // prm.group
    nbg_s = rho3.num_blocks(NS, prm) // prm.group
    length = prm.f1 * prm.f2 * nphj.mat_chunk(nbg_r, nbg_s, prm.cap2)
    require((int(mres.matches), int(mres.checksum)) == want,
            "PHT materialize: matches/checksum != exact core")
    require(mres.key.numel() == length
            and int((mres.key == -3).sum()) == length - NS,
            f"PHT materialize: length {mres.key.numel()} (want {length}) "
            "or hole count")
    dense = mergejoin.merge_join_materialize(relR.key, relR.payload,
                                             relS.key, relS.payload, NS)
    require(same_live_rows((mres.key, mres.r_payload, mres.s_payload),
                           (dense.key, dense.r_payload, dense.s_payload)),
            "PHT materialize: live rows != exact core's")
    del dense
    for label, want_c in (("keys-only", 0),
                          ("checksummed", int(exact_z.checksum))):
        res = out[f"z=1.5 {label}"]
        require((int(res.matches), int(res.checksum))
                == (int(exact_z.matches), want_c),
                f"z=1.5 PHT {label}: result != exact core")


def tier_name(hinted, cap, attempts) -> str:
    """The count ladder's tier that answered after `attempts` pipeline
    runs (joins/radix.count_tiers' order)."""
    if hinted:
        tiers = (["compacted-residual"] if cap else []) + [
            "heavy-split", "plain"]
    else:
        tiers = ["plain", "heavy-split"]
    tiers += [f"plain, salt {i}" for i in range(1, len(rho3.RETRY_SALTS))]
    if not 1 <= attempts <= len(tiers):
        return f"unknown ({attempts} pipeline runs)"
    return tiers[attempts - 1] + (" (or the exact core after it)"
                                  if attempts == len(tiers) else "")


def npbc_steps(relR, relS) -> dict:
    """ms of NPBC_st's fused form step by step (bucket-major sort key, the
    sort, the run-count scan) and of the exact core it shares the scan's
    building blocks with (the ladders' last rung)."""
    nb_bits = min(24, (NR - 1).bit_length())

    def sort_key():
        b = fib_hash32(torch.cat([relR.key, relS.key]), nb_bits).long()
        skey = torch.cat([relR.key.long() << 1, (relS.key.long() << 1) | 1])
        return skey, b * (1 << 33) + (skey + (1 << 32))

    skey, comp = sort_key()
    order = torch.sort(comp, stable=True).indices
    pk = skey[order]
    pay = torch.cat([relR.payload, relS.payload])[order]
    is_r = (pk & 1) == 0
    idx = torch.arange(pk.numel(), device=pk.device)
    steps = {
        "NPBC_st bucket-major sort key": sort_key,
        "NPBC_st stable sort (|R| + |S| int64 keys)": lambda: torch.sort(
            comp, stable=True),
        "NPBC_st count_general_scan": lambda: mergejoin.count_general_runs(
            pk >> 1, is_r, pay),
        "exact core merge_join_count": lambda: mergejoin.merge_join_count(
            relR.key, relR.payload, relS.key, relS.payload),
        "mergejoin.last_index over the sorted union": lambda:
            mergejoin.last_index(is_r),
    }
    out = {k: cuda_ms(f, REPS) for k, f in steps.items()}
    # what last_index replaced: one thread block scans the whole 1-D tensor
    out["torch.cummax form of last_index (1 call)"] = cuda_ms(
        lambda: torch.where(is_r, idx, -1).cummax(0), 1)
    for k, v in out.items():
        say(f"nopart step {k}: {v:.3f} ms")
    return out


def nopart_phase(relR, relS) -> dict:
    """Phase 11: the no-partition family at full width.  Returns the rows
    of K3TWO, K3TWO_MAT and RSTATS."""
    check_nphj_kernels()
    check_rstats()
    say("nopart kernels: K3TWO (default, small, PHT_un, PHT_o and residual "
        "geometry; empty table runs, nbg_r > nbg_s (halving, and at the "
        "test geometry), duplicate R keys, one R key 5,000 times; "
        "keys-only and with payloads), K3TWO_MAT (default, small, empty "
        "table runs, nbg_r > nbg_s at both, duplicate R keys, one R key "
        "5,000 times; the same halvings as K3TWO) and RSTATS (odd n, "
        "unaligned starts, duplicate R, -1 and repeated candidates) equal "
        "their plain versions")
    zs = create_relation_zipf(NS, NR, 1.5, seed=22222, random_payload=True,
                              device=DEV)
    plan = skewtier.skew_plan(zs.key)     # each call below plans anew
    torch.cuda.synchronize()
    reset_launches()
    out, attempts = nopart_main_path(relR, relS, zs)
    torch.cuda.synchronize()
    launches = main_path_launches("11 no-partition")
    say(f"nopart path launches: {launches}")
    for name in ("K1", "K2", "K3TWO", "K3TWO_MAT", "RSTATS"):
        require(launches[name] > 0, f"{name} was not launched on the "
                "no-partition path")
    require(launches["K3"] == 0 and launches["K3M"] == 0,
            f"K3 / K3M ran on the no-partition path: {launches}")
    require(attempts["checksummed"]["RSTATS"] > 0,
            "RSTATS was not launched by PHT's checksummed z=1.5 call")
    exact = mergejoin.merge_join_count(relR.key, relR.payload, relS.key,
                                       relS.payload)
    exact_z = mergejoin.merge_join_count(relR.key, relR.payload, zs.key,
                                         zs.payload)
    check_nopart_results(out, relR, relS, exact, exact_z)
    tiers = {k: tier_name(plan[0], plan[1], v["K3TWO"])
             for k, v in attempts.items()}
    say(f"nopart: PHT, PHT_no, PHT_un, PHT_o, NPO_st, NPO_no, NPBC_st, the "
        f"staged engine and a twice-probed table: matches = {NS}, checksum "
        f"= {int(exact.checksum)} (= exact core); PHT materialize: live rows "
        f"= exact core's, {out['PHT materialize'].key.numel()} rows per "
        f"column; z=1.5 (plan {plan}) = exact core, answered by {tiers}")
    del out
    torch.cuda.synchronize()

    # each call through the entry points, timed
    calls = {"PHT keys-only": lambda: run_join(relR, relS, "PHT", JoinConfig(
        checksum=False))}
    for name in NOPART_NAMES + ("NPBC_st",):
        calls[name] = functools.partial(run_join, relR, relS, name,
                                        JoinConfig())
    calls["PHT materialize"] = lambda: run_join(relR, relS, "PHT", JoinConfig(
        materialize=True))
    table = nphj.nphj_build(relR.key, relR.payload)
    calls["nphj_build"] = lambda: nphj.nphj_build(relR.key, relR.payload)
    calls["nphj_probe (reused table)"] = lambda: nphj.nphj_probe(
        *table, relS.key, relS.payload)
    zs_key = zs.key.clone()
    zs_rel = Relation(key=zs_key, payload=zs.payload)
    calls["z=1.5 PHT keys-only"] = lambda: run_join(relR, zs_rel, "PHT",
                                                    JoinConfig(checksum=False))
    calls["z=1.5 PHT checksummed"] = lambda: run_join(relR, zs_rel, "PHT",
                                                      JoinConfig())
    res_ms = {k: cuda_ms(f, REPS) for k, f in calls.items()}
    res_ms["PHT profile_phases (1 call)"] = cuda_ms(
        lambda: run_join(relR, relS, "PHT", JoinConfig(profile_phases=True)),
        1)
    for k, v in res_ms.items():
        say(f"nopart {k}: {v:.3f} ms/call, {(NR + NS) / v / 1e3:.1f} M "
            "rows/s")
    del table
    res_ms["steps"] = npbc_steps(relR, relS)

    # each new kernel at the headline shapes
    rows = {}
    for with_payload in (False, True):
        args, ovf = nphj_stage(relR.key, relR.payload, relS.key,
                               relS.payload, rho3.Rho3Params(), with_payload)
        require(ovf == 0, "headline nphj routing overflowed")
        tcnt, scnt = args[2], args[5]
        real = int(tcnt.long().sum() + scnt.long().sum())
        _, err = check_subrange(
            "K3TWO", f"headline, {'payload' if with_payload else 'keys-only'}",
            args)
        k_ms = cuda_ms(lambda: nphj.k3two(*args), REPS)
        p_ms = cuda_ms(lambda: nphj.k3two_plain(*args), 1)
        nbytes_ = (real * 4 * (2 if with_payload else 1)
                   + nbytes(tcnt, scnt) + 16)
        bound = nbytes_ / HBM_BYTES_PER_S * 1e3
        sides = live_sides(*args)
        lib_ms = cuda_ms(lambda: join_library(*sides[:4]), REPS)
        row = kernel_row("K3TWO", err, k_ms, p_ms, bound, lib_ms,
                         JOIN_LIBRARY)
        row["launches"] = launches["K3TWO"]
        say(f"K3TWO {'payload' if with_payload else 'keys-only'} (nbg_r = "
            f"{args[0].shape[1]}, nbg_s = {args[3].shape[1]}): {k_ms:.3f} ms "
            f"(plain {p_ms:.3f} ms, bound {bound:.3f} ms, library "
            f"{lib_ms:.3f} ms)")
        if with_payload:
            print(json.dumps({"with_payload": row}), flush=True)
            _, err = check_subrange("K3TWO_MAT", "headline", args)
            n_out = args[0].shape[0] * args[0].shape[2] * nphj.mat_chunk(
                args[0].shape[1], args[3].shape[1], args[0].shape[3])
            k_ms = cuda_ms(lambda: nphj.k3two_mat(*args, INV), REPS)
            p_ms = cuda_ms(lambda: nphj.k3two_mat_plain(*args, INV), 1)
            nbytes_ = real * 8 + nbytes(tcnt, scnt) + 16 + 3 * n_out * 4
            bound = nbytes_ / HBM_BYTES_PER_S * 1e3
            # the S elements' places in the region-chunked columns
            f2, nbg_s, cap2 = args[3].shape[2], args[3].shape[1], \
                args[3].shape[3]
            w = nphj.mat_chunk(args[0].shape[1], nbg_s, cap2)
            pos = sides[4]
            a_b = pos // (cap2 * f2 * nbg_s) * f2 + pos // cap2 % f2
            q = a_b * w + pos // (cap2 * f2) % nbg_s * cap2 + pos % cap2
            mat_sides = (*sides[:4], q, n_out)
            lib_ms = cuda_ms(lambda: join_library(*mat_sides), REPS)
            del mat_sides, q, a_b
            rows["K3TWO_MAT"] = kernel_row("K3TWO_MAT", err, k_ms, p_ms,
                                           bound, lib_ms, JOIN_LIBRARY_MAT)
            say(f"K3TWO_MAT ({n_out} rows per column): {k_ms:.3f} ms "
                f"(plain {p_ms:.3f} ms, bound {bound:.3f} ms, library "
                f"{lib_ms:.3f} ms)")
        else:
            rows["K3TWO"] = row
        del args, sides
    # RSTATS at the z = 1.5 checksummed call's shapes
    hk = skewtier.heavy_candidates(zs.key)
    for with_pay in (True, False):
        got = rstats.r_cand_stats_kernel(relR.key, relR.payload, hk, with_pay)
        want = rstats.r_cand_stats_plain(relR.key, relR.payload, hk,
                                         with_pay)
        err = max_abs_err(got, want)
        require(err == 0, "RSTATS differs from its plain version at the "
                f"headline shape (payload={with_pay})")
        k_ms = cuda_ms(lambda: rstats.r_cand_stats_kernel(
            relR.key, relR.payload, hk, with_pay), REPS)
        p_ms = cuda_ms(lambda: rstats.r_cand_stats_plain(
            relR.key, relR.payload, hk, with_pay), 1)

        def composition(with_pay=with_pay):
            hs = torch.sort(hk).values
            g = torch.searchsorted(hs, relR.key).clamp(max=hs.numel() - 1)
            g = torch.where(hs[g] == relR.key, g, hs.numel())
            cnt = torch.bincount(g, minlength=hs.numel() + 1)
            if with_pay:
                return cnt, torch.bincount(g, weights=relR.payload.double(),
                                           minlength=hs.numel() + 1)
            return cnt

        lib_ms = cuda_ms(composition, REPS)
        # R's keys once, the payloads only where a key hits (in whole
        # 32-byte sectors), hk, and the (2, h) int64 output
        hit = torch.isin(relR.key, hk[hk >= 0])
        pay_bytes = 32 * kept_sectors(hit) if with_pay else 0
        nbytes_ = relR.key.numel() * 4 + pay_bytes + hk.numel() * (4 + 16)
        bound = nbytes_ / HBM_BYTES_PER_S * 1e3
        lib_call = ("torch.searchsorted of R into the sorted candidates + "
                    + ("two torch.bincount" if with_pay
                       else "one torch.bincount"))
        row = kernel_row("RSTATS", err, k_ms, p_ms, bound, lib_ms, lib_call)
        say(f"RSTATS {'payload' if with_pay else 'keys-only'} (|R| = {NR}, "
            f"{int((hk >= 0).sum())} candidates, {int(hit.sum())} rows "
            f"hit): {k_ms:.3f} ms (plain {p_ms:.3f} ms, bound {bound:.3f} ms "
            f"from {nbytes_} bytes, {lib_call} {lib_ms:.3f} ms)")
        if with_pay:
            rows["RSTATS"] = row
        else:
            rows["RSTATS"]["keys_only"] = {k: row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
    print(json.dumps({"nopart": {"ms": res_ms, "z=1.5 tiers": tiers,
                                 "z=1.5 plan": list(plan),
                                 "launches": launches}}), flush=True)
    del zs, zs_rel, zs_key
    return rows


RADIX_NAMES = ("RHO_seq", "RHT", "RSM", "MWAY", "PSM")
SORT_N = 1 << 27                    # membench.py's large size
HIST_N = 1 << 26                    # partition_bench.py's N
HIST_SUB, HIST_F = 512, 16          # its sort+hist leg
COMPACT_ROWS = 1 << 26


def hist_scale(F: int) -> float:
    """partition_bench.py's scale F / 2^30 in float32; 0 for one bucket
    (compact_kp's)."""
    if F == 1:
        return 0.0
    return (torch.tensor(F, dtype=torch.float32) / (1 << 30)).item()


def sort_cases(n: int, seed: int):
    """(label, key, payload) on the card: random keys, every key equal, a
    few runs of equal keys, and a third of the keys KEY_PAD_INT."""
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def i32(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=DEV,
                             dtype=torch.int64).int()

    key, pay = i32(-(1 << 31), 1 << 31), i32(-(1 << 31), 1 << 31)
    pads = torch.where(torch.rand(n, generator=gen, device=DEV) < 0.3,
                       blocksort.KEY_PAD_INT, key)
    return [("random", key, pay), ("all equal", torch.full_like(key, 7), pay),
            ("few runs", i32(0, 5), pay), ("pads", pads, pay)]


def design_cases(n: int, sub: int, seed: int):
    """(label, key, payload) on the card that the radix tile sort and its
    digit plan could get wrong: digits constant over a tile, payloads that
    ascend (their digits skipped), a block of pads, keys whose digits
    alone give the order or do not, and keys from a handful of values."""
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def i32(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=DEV,
                             dtype=torch.int64).int()

    def full(x):
        return torch.full((n,), x, dtype=torch.int32, device=DEV)

    arange = torch.arange(n, dtype=torch.int32, device=DEV)
    distinct = (torch.randperm(n, generator=gen, device=DEV) * 7
                - (1 << 30)).int()
    pads, pads_pay = i32(-(1 << 31), 1 << 31), i32(-(1 << 31), 1 << 31)
    pads[:sub * 128] = blocksort.KEY_PAD_INT
    pads_pay[:sub * 128] = 3
    # one key repeated in each tile, its two payloads out of order
    one, one_pay = distinct.clone(), i32(-(1 << 31), 1 << 31)
    tile = torch.arange(0, n, blocksort.TILE, device=DEV)
    one[tile + 5000] = one[tile + 100]
    one_pay[tile + 100], one_pay[tile + 5000] = 9, 4
    pairs = torch.repeat_interleave(distinct[:n // 2], 2)
    pairs_pay = torch.tensor([1 << 20, 7], dtype=torch.int32,
                             device=DEV).repeat(n // 2)
    return [
        ("equal keys, payloads varying in one high digit", full(7),
         (i32(0, 256) << 24) | 0x5A5A5A),
        ("arange payloads", i32(0, 1 << 30), arange),
        ("a block of KEY_PAD_INT with equal payloads", pads, pads_pay),
        ("keys varying in their top digit only",
         (i32(0, 256) << 24) | 0x123456, full(5)),
        ("distinct keys, random payloads", distinct,
         i32(-(1 << 31), 1 << 31)),
        ("one repeated key a tile, payloads out of order", one, one_pay),
        ("every key twice, payloads out of order", pairs, pairs_pay),
        ("keys 0..4, random payloads", i32(0, 5), i32(-(1 << 31), 1 << 31)),
    ]


def check_sort_kernels(seed: int = 0, blocks=(3, 1, 9),
                       fs=(1, 16, 127)) -> None:
    """B13 and B12 equal their plain versions exactly at every sub:
    sort_cases at the first of `blocks` blocks, design_cases at each of
    the others; B12 at each F of `fs`.  `seed` moves every case's seed."""
    for sub in blocksort.SUBS:
        cases = sort_cases(blocks[0] * sub * 128, seed + 1300 + sub)
        for nb in blocks[1:]:
            cases += design_cases(nb * sub * 128, sub,
                                  seed + 1350 + 10 * sub + nb)
        for label, key, pay in cases:
            label = f"{label}, {key.numel() // (sub * 128)} blocks"
            got = blocksort.sort_blocks(key, pay, sub)
            want = blocksort.sort_blocks_plain(key, pay, sub)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            require(err == 0, f"sort_blocks differs from its plain version "
                    f"by {err} (sub={sub}, {label})")
            for F in fs:
                got = compact.sort_hist(key, pay, hist_scale(F), sub, F)
                want = compact.sort_hist_plain(key, pay, hist_scale(F), sub,
                                               F)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                require(err == 0, f"sort_hist differs from its plain "
                        f"version by {err} (sub={sub}, F={F}, {label})")


def compact_input(seed: int):
    """COMPACT_ROWS keys below PAD_R_INPUT and payloads, 30% kept: the rows
    not kept carry PAD_S_INPUT."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    key = torch.randint(0, compact.PAD_R_INPUT, (COMPACT_ROWS,),
                        generator=gen, device=DEV, dtype=torch.int32)
    pay = torch.randint(-(1 << 31), 1 << 31, (COMPACT_ROWS,), generator=gen,
                        device=DEV, dtype=torch.int64).int()
    keep = torch.rand(COMPACT_ROWS, generator=gen, device=DEV) < 0.3
    return torch.where(keep, key, compact.PAD_S_INPUT), pay, keep


def compact_caps(keep) -> tuple:
    """(rows enough for the kept keys with each block's boundary row, half
    the rows they need)."""
    need = -(-int(keep.sum()) // 128)
    return need + COMPACT_ROWS // (1024 * 128), need // 2


def sorted_pairs(key, pay) -> torch.Tensor:
    return torch.sort(blocksort.composite(key, pay)).values


def check_compact_kp(mkey, pay, keep, out, out_short) -> None:
    ok, op, ovf = out
    live = ok < compact.PAD_R_INPUT
    require(int(ovf) == 0, f"compact_kp: overflow {int(ovf)}")
    require(torch.equal(sorted_pairs(ok[live], op[live]),
                        sorted_pairs(torch.masked_select(mkey, keep),
                                     torch.masked_select(pay, keep))),
            "compact_kp: live rows != the masked_select oracle's")
    require(int(out_short[2]) > 0,
            "compact_kp at half the rows it needs reported no overflow")


RHO_FRAME = (("RHO use_pallas=False keys-only",
              JoinConfig(use_pallas=False, checksum=False)),
             ("RHO use_pallas=False", JoinConfig(use_pallas=False)),
             ("RHO use_pallas=False profile_phases",
              JoinConfig(use_pallas=False, profile_phases=True)),
             ("RHO profile_phases", JoinConfig(profile_phases=True)))


def radix_main_path(relR, relS, zs, dup):
    """Phase 12's engines through run_join; returns {label: JoinResult}."""
    out = {}
    for name in RADIX_NAMES:
        out[f"{name} keys-only"] = run_join(relR, relS, name, JoinConfig(
            checksum=False))[0]
        out[name] = run_join(relR, relS, name, JoinConfig())[0]
    for name in ("RHT", "MWAY"):
        out[f"{name} materialize"] = run_join(relR, relS, name, JoinConfig(
            materialize=True))[0]
    for label, cfg in RHO_FRAME:
        out[label] = run_join(relR, relS, "RHO", cfg)[0]
    out["RHT duplicate R"] = run_join(*dup, "RHT", JoinConfig())[0]
    for label, cfg in (("keys-only", JoinConfig(checksum=False)),
                       ("checksummed", JoinConfig())):
        s = Relation(key=zs.key.clone(), payload=zs.payload)
        out[f"MWAY z=1.5 {label}"] = run_join(relR, s, "MWAY", cfg)[0]
    return out


def check_radix_results(out, relR, relS, zs, dup) -> None:
    exact = mergejoin.merge_join_count(relR.key, relR.payload, relS.key,
                                       relS.payload)
    want = (NS, int(exact.checksum))
    for label, res in out.items():
        if label.startswith(("MWAY z=1.5", "RHT duplicate")) or \
                label.endswith("materialize"):
            continue
        # only the staged RHO frame sums payloads on a keys-only call
        cs = want[1] if "keys-only" not in label else 0
        require((int(res.matches), int(res.checksum)) == (NS, cs),
                f"{label}: result != exact core")
    dense = mergejoin.merge_join_materialize(relR.key, relR.payload,
                                             relS.key, relS.payload, NS)
    for name in ("RHT", "MWAY"):
        res = out[f"{name} materialize"]
        require((int(res.matches), int(res.checksum)) == want,
                f"{name} materialize: matches/checksum != exact core")
        require(same_live_rows((res.key, res.r_payload, res.s_payload),
                               (dense.key, dense.r_payload, dense.s_payload)),
                f"{name} materialize: live rows != exact core's")
    del dense
    gen = mergejoin.merge_join_count_general(dup[0].key, dup[0].payload,
                                             dup[1].key, dup[1].payload)
    res = out["RHT duplicate R"]
    require((int(res.matches), int(res.checksum))
            == (int(gen.matches), int(gen.checksum))
            and int(gen.matches) > NS,
            "RHT on duplicate R keys != merge_join_count_general")
    exact_z = mergejoin.merge_join_count(relR.key, relR.payload, zs.key,
                                         zs.payload)
    for label, cs in (("keys-only", 0), ("checksummed",
                                         int(exact_z.checksum))):
        res = out[f"MWAY z=1.5 {label}"]
        require((int(res.matches), int(res.checksum))
                == (int(exact_z.matches), cs),
                f"MWAY z=1.5 {label}: result != exact core")


def b12_library(comp, scale, sub, F):
    """One torch.sort of the 64-bit composites along each block, then the
    rows' buckets and one torch.searchsorted for the starts."""
    nb = comp.numel() // (sub * 128)
    srt = torch.sort(comp.view(nb, sub * 128), dim=1).values
    lead = (srt.view(nb, sub, 128)[:, :, 0] >> 32).int()
    b = compact.row_buckets(lead, scale, F)
    f = torch.arange(F + 1, device=DEV).expand(nb, F + 1).contiguous()
    return srt, torch.searchsorted(b, f)


def kernels_per_call(call) -> dict:
    """The kernels of csrc/blocksort.cu that one call launches, by name, as
    the library's launchers count them."""
    before = blocksort.kernel_launches()
    call()
    after = blocksort.kernel_launches()
    return {k: after[k] - before[k] for k in after}


def plan_counts(label, key, pay) -> dict:
    """tile_plan's counts on (key, pay), equal to tile_plan_plain's."""
    plan = blocksort.tile_plan(key, pay)
    want = blocksort.tile_plan_plain(key, pay)
    require(plan == want, f"tile_plan at {label}: the kernel counted "
            f"{plan}, its plain version {want}")
    say(f"tile plan at {label}: {plan}; "
        f"{plan['key-first failed'] / plan['tiles']:.4%} of the tiles fail "
        f"the key-first check")
    return plan


def sort_kernel_rows():
    """B13 at membench's 2^27 pairs (sub 512) and B12 at partition_bench's
    2^26 (sub 512, F = 16; also compact_kp's sub 1024, F = 1): exact
    agreement, time, plain time, bound and the library yardstick, and by
    sub.  Returns (rows, what was measured beside them: the tile sort's
    plan counts at each shape and the kernels one call launches by sub)."""
    gen = torch.Generator(device=DEV).manual_seed(1401)
    rows = {}
    plans, per_call = {}, {}
    for name, n in (("sort_blocks", SORT_N), ("sort_hist", HIST_N)):
        key = torch.randint(0, 1 << 30, (n,), generator=gen, device=DEV,
                            dtype=torch.int32)
        pay = (torch.arange(n, dtype=torch.int32, device=DEV)
               if name == "sort_hist" else
               torch.randint(0, 1 << 30, (n,), generator=gen, device=DEV,
                             dtype=torch.int32))
        comp = blocksort.composite(key, pay)
        if name == "sort_blocks":
            def kernel():
                return blocksort.sort_blocks(key, pay, 512)

            def plain():
                return blocksort.sort_blocks_plain(key, pay, 512)

            def library():
                return torch.sort(comp.view(-1, 512 * 128), dim=1)

            lib_call = ("torch.sort of the int64 composite key << 32 | "
                        "uint32(payload) along each 65,536-pair block")
            out_bytes = 0
        else:
            scale = hist_scale(HIST_F)

            def kernel():
                return compact.sort_hist(key, pay, scale, HIST_SUB, HIST_F)

            def plain():
                return compact.sort_hist_plain(key, pay, scale, HIST_SUB,
                                               HIST_F)

            def library():
                return b12_library(comp, scale, HIST_SUB, HIST_F)

            lib_call = ("torch.sort of the int64 composite along each block "
                        "+ the rows' buckets + torch.searchsorted")
            out_bytes = n // (HIST_SUB * 128) * (HIST_F + 1) * 4
        err = max_abs_err(kernel(), plain())
        require(err == 0, f"{name} differs from its plain version at the "
                "drivers' shape")
        k_ms = cuda_ms(kernel, REPS)
        p_ms = cuda_ms(plain, 1)
        lib_ms = cuda_ms(library, REPS)
        bound = (n * 16 + out_bytes) / HBM_BYTES_PER_S * 1e3
        rows[name] = kernel_row(name, err, k_ms, p_ms, bound, lib_ms,
                                lib_call)
        plans[name] = plan_counts(f"{name}'s shape", key, pay)
        # how the time grows with the block: one trip through device
        # memory per launch of the tile sort or a merge level
        call = (functools.partial(blocksort.sort_blocks, key, pay)
                if name == "sort_blocks" else
                functools.partial(compact.sort_hist, key, pay, scale,
                                  F=HIST_F))
        by_sub = {sub: cuda_ms(functools.partial(call, sub=sub), REPS)
                  for sub in blocksort.SUBS}
        rows[name]["ms by sub"] = by_sub
        per_call[name] = {sub: kernels_per_call(
            functools.partial(call, sub=sub)) for sub in blocksort.SUBS}
        for sub, got in per_call[name].items():
            want = {"tile_sort_kernel": 1,
                    "merge_kernel": blocksort.merge_levels(sub),
                    "row_starts_kernel": int(name == "sort_hist")}
            require(got == want, f"{name} at sub {sub} launched {got}, "
                    f"not the design's {want}")
        say(f"{name} by sub: ms {by_sub}; kernels launched by one call "
            f"(counted by the launchers; each tile sort or merge level is "
            f"one trip through device memory) {per_call[name]}")
        say(f"{name} ({n} pairs, sub 512): {k_ms:.3f} ms (plain "
            f"{p_ms:.3f} ms, bound {bound:.3f} ms, {lib_call} {lib_ms:.3f} "
            "ms)")
        del key, pay, comp
    # B12 at compact_kp's shape: sub 1024, F = 1, packed keys
    key, pay, _ = compact_input(1402)
    packed = ((key.long() << 1) | 1).int()
    plans["sort_hist at compact_kp"] = plan_counts("compact_kp's shape",
                                                   packed, pay)
    err = max_abs_err(compact.sort_hist(packed, pay, 0.0, 1024, 1),
                      compact.sort_hist_plain(packed, pay, 0.0, 1024, 1))
    require(err == 0, "sort_hist differs from its plain version at "
            "compact_kp's shape")
    k_ms = cuda_ms(lambda: compact.sort_hist(packed, pay, 0.0, 1024, 1), REPS)
    bound = (COMPACT_ROWS * 16 + 512 * 8) / HBM_BYTES_PER_S * 1e3
    rows["sort_hist"]["at compact_kp (sub 1024, F = 1)"] = {
        "max_abs_err": err, "ms": k_ms, "bound_ms": bound}
    say(f"sort_hist at compact_kp's shape (sub 1024, F = 1): {k_ms:.3f} ms "
        f"(bound {bound:.3f} ms)")
    return rows, {"tile plan": plans, "kernels per call by sub": per_call}


def sort_phase(relR, relS) -> dict:
    """Phase 12: the partition-and-sort side at full width.  Returns the
    rows of sort_hist (B12) and sort_blocks (B13)."""
    check_sort_kernels()
    say("sort kernels: sort_blocks and sort_hist (F = 1, 16, 127) equal "
        "their plain versions at sub = 128, 256, 512 and 1024 (random, all "
        "equal, few runs, KEY_PAD_INT pads; at one block and nine: a high "
        "payload digit, arange payloads, a pad block, a top key digit, "
        "distinct keys, repeated keys out of payload order, keys 0..4)")
    mkey, pay, keep = compact_input(1501)
    cap, short = compact_caps(keep)
    torch.cuda.synchronize()
    reset_launches()
    pb_rows = partition_bench.main([])
    mb_rows = membench.main([])
    ck = compact.compact_kp(mkey, pay, cap)
    ck_short = compact.compact_kp(mkey, pay, short)
    torch.cuda.synchronize()
    launches = main_path_launches("12 drivers and compact_kp")
    say(f"partition_bench / membench / compact_kp path launches: {launches}")
    for name in ("sort_hist", "sort_blocks", "scatter_segments"):
        require(launches[name] > 0, f"{name} was not launched on the "
                "drivers' and compact_kp's path")
    check_compact_kp(mkey, pay, keep, ck, ck_short)
    say(f"compact_kp: {int(keep.sum())} of {COMPACT_ROWS} rows kept = the "
        f"masked_select oracle's, overflow 0 at {cap} rows, "
        f"{int(ck_short[2])} at {short}")
    del ck, ck_short

    zs = create_relation_zipf(NS, NR, 1.5, seed=22222, random_payload=True,
                              device=DEV)
    rk, rp, sk, sp = random_pairs(NR, NS, 1 << 22, 1502, unique_r=False)
    dup = (Relation(key=rk, payload=rp), Relation(key=sk, payload=sp))
    torch.cuda.synchronize()
    reset_launches()
    out = radix_main_path(relR, relS, zs, dup)
    torch.cuda.synchronize()
    eng_launches = main_path_launches("12 radix and sort-merge")
    say(f"radix / sort-merge path launches: {eng_launches}")
    for name in ("K1", "K2", "K3", "K3M"):
        require(eng_launches[name] > 0, f"{name} was not launched by "
                "MWAY's range route")
    check_radix_results(out, relR, relS, zs, dup)
    _, _, ovf = sortmerge._mway_range_count(relR.key, relR.payload, zs.key,
                                            zs.payload, True)
    require(int(ovf) > 0, "MWAY's range route did not overflow at z=1.5")
    say(f"radix / sort-merge: {', '.join(RADIX_NAMES)} keys-only and "
        f"checksummed, RHT and MWAY materialized, RHO's radix frame and "
        f"profile_phases = exact core; RHT on duplicate R = the general "
        f"core; MWAY at z=1.5: the range route overflowed ({int(ovf)}), "
        "the exact core answered")
    del out
    torch.cuda.synchronize()

    calls = {}
    for name in RADIX_NAMES:
        calls[f"{name} keys-only"] = functools.partial(
            run_join, relR, relS, name, JoinConfig(checksum=False))
        calls[name] = functools.partial(run_join, relR, relS, name,
                                        JoinConfig())
    for name in ("RHT", "MWAY"):
        calls[f"{name} materialize"] = functools.partial(
            run_join, relR, relS, name, JoinConfig(materialize=True))
    for label, cfg in RHO_FRAME:
        calls[label] = functools.partial(run_join, relR, relS, "RHO", cfg)
    calls["RHT duplicate R"] = functools.partial(run_join, *dup, "RHT",
                                                 JoinConfig())
    zs_rel = Relation(key=zs.key.clone(), payload=zs.payload)
    calls["MWAY z=1.5 checksummed"] = functools.partial(
        run_join, relR, zs_rel, "MWAY", JoinConfig())
    calls["compact_kp (2^26 rows, 30% kept)"] = functools.partial(
        compact.compact_kp, mkey, pay, cap)
    res_ms = {k: cuda_ms(f, REPS) for k, f in calls.items()}
    for name in ("MWAY", "PSM", "RHT"):
        res_ms[f"{name} profile_phases (1 call)"] = cuda_ms(
            functools.partial(run_join, relR, relS, name,
                              JoinConfig(profile_phases=True)), 1)
    for k, v in res_ms.items():
        say(f"phase 12 {k}: {v:.3f} ms/call")
    del zs, zs_rel, dup, mkey, pay, keep
    torch.cuda.synchronize()

    rows, beside = sort_kernel_rows()
    print(json.dumps({"sort": {
        "ms": res_ms, "launches": launches, "engine_launches": eng_launches,
        "partition_bench": pb_rows, "membench": mb_rows, **beside}}),
        flush=True)
    return rows


FAMILY_NAMES = ("CHT", "INL", "CRKJ", "CrkJoin", "CRKJF", "CRKJS")
FAMILY_FORMS = (("keys-only", JoinConfig(checksum=False)),
                ("checksummed", JoinConfig()),
                ("materialize", JoinConfig(materialize=True)))
PROFILE_FORMS = (("profile_phases", JoinConfig(profile_phases=True)),
                 ("profile_phases materialize",
                  JoinConfig(profile_phases=True, materialize=True)))
NL_NR, NL_NS = 1 << 18, 1 << 20     # experiments/join_overview.py:29-33
SPARSE_STRIDE = 32                  # CHT's sparse R: keys 32 apart


def once_ms(fn):
    """(result, device milliseconds) of one call of fn, from CUDA events
    (no warm-up: the first call is the one measured)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def family_calls(relR, relS, nl, sparse) -> dict:
    """Phase 13's calls: label -> a run_join call, whose first element is
    the JoinResult and second the Timings."""
    calls = {}
    for name in FAMILY_NAMES + ("PSM",):
        for label, cfg in FAMILY_FORMS:
            calls[f"{name} {label}"] = functools.partial(
                run_join, relR, relS, name, cfg)
    for name in ("CHT", "INL", "CRKJ"):
        for label, cfg in PROFILE_FORMS:
            calls[f"{name} {label}"] = functools.partial(
                run_join, relR, relS, name, cfg)
    calls["NL"] = functools.partial(run_join, *nl, "NL", JoinConfig())
    calls["NL materialize"] = functools.partial(
        run_join, *nl, "NL", JoinConfig(materialize=True))
    calls["CHT sparse R"] = functools.partial(run_join, *sparse, "CHT",
                                              JoinConfig())
    return calls


def crack_reuse(relR, relS) -> dict:
    """The persistent cracking store at the headline: crk_join_cracked at
    CRKJ's depth (11), again on the stores it returned (no crack sort,
    the same objects back), then one level deeper with profile_phases
    (one crack sort a side, of the missing level only).  Returns each
    call's result, stores, time and the crack sorts it ran."""
    kb = crk._key_bits(NR)
    depth = crk._query_depth(NR, JoinConfig(), 0)
    sorts = []
    level = crk._crack_level

    def counted(key, payload, d, key_bits):
        sorts.append(d)
        return level(key, payload, d, key_bits)

    stores = (crk.crack_relation(relR, kb), crk.crack_relation(relS, kb))
    out = {}
    crk._crack_level = counted
    try:
        for label, d, cfg in (("first", depth, JoinConfig()),
                              ("second", depth, JoinConfig()),
                              ("deeper", depth + 1,
                               JoinConfig(profile_phases=True))):
            pt = PhaseTimer(DEV)
            sorts.clear()
            (res, cr_r, cr_s), ms = once_ms(
                lambda: crk.crk_join_cracked(*stores, cfg, d, pt))
            out[label] = {"result": res, "stores": (cr_r, cr_s), "ms": ms,
                          "sorts": list(sorts), "phases": pt.t.phases,
                          "same_objects": cr_r is stores[0]
                          and cr_s is stores[1]}
            stores = (cr_r, cr_s)
    finally:
        crk._crack_level = level
    return out


def check_families(out, reuse, nl, sparse) -> dict:
    """Every phase-13 answer against PSM's on the same relations: matches
    |S|, the checksum (0 keys-only on the serving paths; the staged
    profile_phases forms sum payloads as the reference's do), materialized
    live rows as a multiset; CHT's sparse R through _sortmerge; the crack
    store's reuse.  Returns what the families line prints of it."""
    psm = out["PSM checksummed"][0]
    want = (NS, int(psm.checksum))
    psm_rows = out["PSM materialize"][0]
    psm_rows = (psm_rows.key, psm_rows.r_payload, psm_rows.s_payload)
    require((int(psm.matches), int(out["PSM keys-only"][0].matches))
            == (NS, NS), "PSM: matches != |S|")
    for label, (res, t) in out.items():
        if label.startswith(("NL", "CHT sparse")):
            continue
        cs = 0 if label.endswith("keys-only") else want[1]
        require((int(res.matches), int(res.checksum)) == (NS, cs),
                f"{label}: matches/checksum != PSM's")
        if label.endswith("materialize"):
            require(same_live_rows((res.key, res.r_payload, res.s_payload),
                                   psm_rows),
                    f"{label}: live rows != PSM's")
    nl_psm = run_join(*nl, "PSM", JoinConfig())[0]
    nl_mat = run_join(*nl, "PSM", JoinConfig(materialize=True))[0]
    require((int(out["NL"][0].matches), int(out["NL"][0].checksum))
            == (NL_NS, int(nl_psm.checksum)) and int(nl_psm.matches)
            == NL_NS, "NL: matches/checksum != PSM's")
    res = out["NL materialize"][0]
    require((int(res.matches), int(res.checksum))
            == (NL_NS, int(nl_psm.checksum)), "NL materialize: "
            "matches/checksum != PSM's")
    require(same_live_rows((res.key, res.r_payload, res.s_payload),
                           (nl_mat.key, nl_mat.r_payload, nl_mat.s_payload)),
            "NL materialize: live rows != PSM's")
    res, t = out["CHT sparse R"]
    sp_psm = run_join(*sparse, "PSM", JoinConfig())[0]
    require((int(res.matches), int(res.checksum))
            == (NS, int(sp_psm.checksum)), "CHT sparse R != PSM's")
    domain = cht.cht_domain(sparse[0].key)
    require(domain > 16 * NR and "build" not in t.phases
            and "merge" in t.phases, f"CHT on a sparse R (domain {domain})"
            f" did not take _sortmerge: {t.phases}")
    first, second, deeper = reuse["first"], reuse["second"], reuse["deeper"]
    depth = first["stores"][0].depth
    require(first["sorts"] == [depth, depth] and "partition"
            in first["phases"], f"the first crack ran {first['sorts']}")
    require(second["sorts"] == [] and "partition" not in second["phases"]
            and second["same_objects"], "the second query on the cracked "
            f"stores cracked again: {second['sorts']}")
    require(deeper["sorts"] == [depth + 1, depth + 1]
            and deeper["stores"][0].depth == depth + 1
            and deeper["stores"][1].depth == depth + 1,
            f"the deeper query cracked {deeper['sorts']}, not one level")
    for label, r in reuse.items():
        cs = int(r["result"].checksum)
        require((int(r["result"].matches), cs) == want,
                f"crk_join_cracked {label}: result != PSM's")
    return {label: {"ms": r["ms"], "sorts": r["sorts"],
                    "phases": r["phases"], "depth": r["stores"][0].depth}
            for label, r in reuse.items()} | {"sparse_domain": domain}


def families_phase(relR, relS, card) -> dict:
    """Phase 13: the seven join names left, plain PyTorch, at full width:
    CHT, INL, CRKJ, CrkJoin, CRKJF and CRKJS on phase 4's relations
    (keys-only, checksummed, materialized; CHT's, INL's and CRKJ's
    profile_phases forms), NL at join_overview's 2^18 x 2^20, CHT on a
    sparse R (keys 32 apart: its domain passes 16 |R|), and the cracking
    store's reuse.  Every answer equals PSM's; every kernel's launches
    over the main path must be 0 (no name reaches a kernel).  Returns the
    families line."""
    nl = seeded(NL_NR, NL_NS, seed=1601)
    sparse = (Relation(key=relR.key * SPARSE_STRIDE, payload=relR.payload),
              Relation(key=relS.key * SPARSE_STRIDE, payload=relS.payload))
    calls = family_calls(relR, relS, nl, sparse)
    torch.cuda.synchronize()
    reset_launches()
    out = {label: fn() for label, fn in calls.items()}
    reuse = crack_reuse(relR, relS)
    torch.cuda.synchronize()
    launches = main_path_launches("13 join families")
    say(f"join families path launches: {launches}")
    require(not any(launches.values()), "a plain-PyTorch join name "
            f"launched a kernel: {launches}")
    crack = check_families(out, reuse, nl, sparse)
    say("join families: CHT, INL, CRKJ, CrkJoin, CRKJF and CRKJS "
        "(keys-only, checksummed, materialized; CHT, INL and CRKJ also "
        "profile_phases) and NL at 2^18 x 2^20 = PSM's answers; CHT on a "
        "sparse R took _sortmerge; a second crk_join_cracked cracked "
        "nothing and returned the same stores, a deeper one cracked one "
        f"level: {json.dumps(crack)}")
    phases = {label: res[1].phases for label, res in out.items()}
    del out, reuse
    torch.cuda.synchronize()
    res_ms = {}
    for label, fn in calls.items():
        slow = label.startswith("NL") or "profile_phases" in label
        res_ms[label] = cuda_ms(fn, 1 if slow else REPS)
        say(f"phase 13 {label}: {res_ms[label]:.3f} ms/call ({card})")
    del nl, sparse, calls
    torch.cuda.synchronize()
    return {"families": {"card": card, "ms": res_ms, "phases": phases,
                         "crack_reuse": crack, "launches": launches}}


# ---------------------------------------------------------------------------
# Phase 14: the TPC-H layer

TPCH_SCALE = 10
TPCH_REPS = 3
TPCH_NAMES = ("lineitem", "orders", "customer", "part", "nation")
# query -> (staged plan, fused plan, its tables as indices into
# (lineitem, orders, customer, part, nation))
TPCH_PLANS = {"Q3": (tpch.tpch_q3, fused.tpch_q3_fused, (2, 1, 0)),
              "Q10": (tpch.tpch_q10, fused.tpch_q10_fused, (2, 1, 0, 4)),
              "Q12": (tpch.tpch_q12, fused.tpch_q12_fused, (0, 1)),
              "Q19": (tpch.tpch_q19, fused.tpch_q19_fused, (0, 3))}
# B1-B6: what the fused plans launch at SF 10
TPCH_KERNELS = ("K1", "K2", "K3", "K3M", "compact_windows",
                "scatter_segments", "scatter_segments_one")


def tpch_oracle(q, l, o, c, p, n) -> int:
    """The query's count from masks, torch.isin chains and (Q19) a
    searchsorted lookup of part with the residual: no join engine and none
    of the plans' code."""
    if q == "Q3":
        cust = c.key[c.mktsegment == TT.MKT_BUILDING]
        om = (o.orderdate < TT.TS_1995_03_15) & torch.isin(o.custkey, cust)
        lm = l.shipdate >= TT.TS_1995_03_16
        return int((lm & torch.isin(l.key, o.key[om])).sum())
    if q == "Q10":
        cust = c.key[torch.isin(c.nationkey, n.key)]
        om = ((o.orderdate >= TT.TS_1993_10_01)
              & (o.orderdate < TT.TS_1994_01_01)
              & torch.isin(o.custkey, cust))
        lm = l.returnflag == TT.L_RETURNFLAG_R
        return int((lm & torch.isin(l.key, o.key[om])).sum())
    if q == "Q12":
        lm = (((l.shipmode == TT.L_SHIPMODE_MAIL)
               | (l.shipmode == TT.L_SHIPMODE_SHIP))
              & (l.commitdate < l.receiptdate) & (l.shipdate < l.commitdate)
              & (l.receiptdate >= TT.TS_1994_01_01)
              & (l.receiptdate < TT.TS_1995_01_01))
        return int((lm & torch.isin(l.key, o.key)).sum())
    keys, order = torch.sort(p.key)
    at = torch.searchsorted(keys, l.partkey).clamp(max=keys.numel() - 1)
    hit = keys[at] == l.partkey
    row = order[at]
    brand, cont, size = p.brand[row], p.container[row], p.size[row]
    qty = l.quantity
    lm = ((qty >= 1) & (qty <= 30)
          & ((l.shipmode == TT.L_SHIPMODE_AIR)
             | (l.shipmode == TT.L_SHIPMODE_AIR_REG))
          & (l.shipinstruct == TT.L_SHIPINSTRUCT_DELIVER_IN_PERSON))
    p1 = ((brand == TT.P_BRAND_12) & (cont >= 1) & (cont <= 4)
          & (size >= 1) & (size <= 5) & (qty <= 11))
    p2 = ((brand == TT.P_BRAND_23) & (cont >= 5) & (cont <= 8)
          & (size >= 1) & (size <= 10) & (qty >= 10) & (qty <= 20))
    p3 = ((brand == TT.P_BRAND_34) & (cont >= 9) & (cont <= 12)
          & (size >= 1) & (size <= 15) & (qty >= 20))
    return int((lm & hit & (p1 | p2 | p3)).sum())


def time_plan(fn):
    """(mean device ms of one call over TPCH_REPS calls after one warm-up,
    from CUDA events around each call; the mean of a staged plan's
    phases in seconds, or None)."""
    fn()
    total, phases = 0.0, {}
    for _ in range(TPCH_REPS):
        out, ms = once_ms(fn)
        total += ms
        for k, v in getattr(getattr(out, "timings", None), "phases",
                            {}).items():
            phases[k] = phases.get(k, 0.0) + v / TPCH_REPS
    return total / TPCH_REPS, phases or None


def tpch_run(label, tables, card) -> dict:
    """The eight plans on one set of tables: every count equal to the
    oracle's, every fused ok true, B1-B6 launched by the fused plans (the
    staged plans' launches reported); then each plan timed."""
    want = {q: tpch_oracle(q, *tables) for q in TPCH_PLANS}
    calls = {}
    for q, (staged, fuse, idx) in TPCH_PLANS.items():
        args = tuple(tables[i] for i in idx)
        calls[f"{q} fused"] = (functools.partial(fuse, *args), args)
        calls[f"{q} staged"] = (functools.partial(staged, *args,
                                                  algorithm="RHO"), args)
    got, launches = {}, {}
    for form in ("fused", "staged"):
        torch.cuda.synchronize()
        reset_launches()
        for q in TPCH_PLANS:
            got[f"{q} {form}"] = calls[f"{q} {form}"][0]()
        torch.cuda.synchronize()
        launches[form] = main_path_launches(f"14 TPC-H {form}, {label}")
        say(f"TPC-H {label} {form} path launches: {launches[form]}")
    for q in TPCH_PLANS:
        m, ok = got[f"{q} fused"]
        require(bool(ok), f"TPC-H {label} {q} fused: a bound overflowed")
        require(int(m) == want[q], f"TPC-H {label} {q} fused: {int(m)} "
                f"!= the oracle's {want[q]}")
        staged = got[f"{q} staged"].matches
        require(staged == want[q], f"TPC-H {label} {q} staged: {staged} "
                f"!= the oracle's {want[q]}")
    missing = [k for k in TPCH_KERNELS if launches["fused"][k] == 0]
    require(not missing, f"TPC-H {label}: the fused plans launched no "
            f"{missing}")
    say(f"TPC-H {label}: the eight plans equal the oracle {want}, every "
        "fused ok true")
    del got
    timed = {}
    for name, (fn, args) in calls.items():
        ms, phases = time_plan(fn)
        rows_in = sum(t.num_tuples for t in args)
        timed[name] = {"ms": ms, "mrows_per_s": rows_in / ms / 1e3,
                       "rows_in": rows_in, "phases": phases}
        say(f"TPC-H {label} {name}: {ms:.3f} ms/call, "
            f"{rows_in / ms / 1e3:.1f} M rows/s"
            + (f", phases {json.dumps(phases)}" if phases else "")
            + f" ({card})")
    return {"oracle": want, "launches": launches, "timed": timed}


def staged_pads_cost(l, o, card) -> dict:
    """Staged Q12's join on the filter's full-length output (the pad keys
    walk RHO's ladder to the exact core) and on its live prefix: equal
    answers, both timed with fresh S tensors each call (the staged plan
    filters anew each call, so its skew plan is never cached)."""
    lk, lp, cnt = F.q12_filter_lineitem(l)
    live = int(cnt)
    relR = Relation(key=o.key, payload=o.rowid)
    out = {}
    for label, n in (("full length", lk.numel()), ("live prefix", live)):
        def join(n=n):
            return run_join(relR, Relation(key=lk[:n].clone(),
                                           payload=lp[:n].clone()), "RHO",
                            JoinConfig(), device=DEV)[0]
        torch.cuda.synchronize()
        reset_launches()
        res = join()
        torch.cuda.synchronize()
        ran = {k: v for k, v in read_launches().items() if v}
        out[label] = {"rows": n, "matches": int(res.matches),
                      "checksum": int(res.checksum), "launches": ran,
                      "ms": cuda_ms(join, TPCH_REPS)}
        say(f"TPC-H staged Q12 join, {label} ({n} S rows): "
            f"{out[label]['ms']:.3f} ms/call, launches {ran} ({card})")
    a, b = out["full length"], out["live prefix"]
    require((a["matches"], a["checksum"]) == (b["matches"], b["checksum"]),
            f"staged Q12's join: the full length {a} != the live prefix {b}")
    return out


def check_tpch_kernels(l, o, c) -> None:
    """The kernels the fused plans launch, each against its plain version
    exactly at one of its SF 10 shapes: B5 (keys-only) and B6b at Q12's
    keep fraction of 1/48 over lineitem, B5 (key + payload) and B6a at
    Q3's orders compaction, K1, K2, K3 and K3M at fused Q3's first join
    and K1, K2 and K3 at its count join; then the staged plans' RSTATS,
    B5, B6a, K1 and K2 on staged Q12's join and staged Q3's first join up
    to their skew tier (check_staged_ladder)."""
    nl, no, nc = l.num_tuples, o.num_tuples, c.num_tuples
    lmask, lkey, _ = F.q12_mask_lineitem(l)
    omask, okey, opay = F.q3_mask_orders(o)
    for label, key, pay, cap, names in (
            ("Q12's lineitem", torch.where(lmask, lkey, rho3.PAD_S_INPUT),
             l.rowid, fused._cap(nl, 1, 48),
             (KEYS_ONLY_B5, "scatter_segments_one")),
            ("Q3's orders", torch.where(omask, okey, rho3.PAD_S_INPUT),
             torch.where(omask, opay, 0), fused._cap(no, 5, 8),
             ("compact_windows", "scatter_segments"))):
        stages, _, _, ovf = compaction_stages(key, pay, cap / key.numel(),
                                              cap // 128)
        require(ovf == 0, f"TPC-H {label}: the compaction overflowed")
        for name in names:
            args, kernel, plain = stages[name]
            got = flat_outputs(name, kernel(*args))
            want = flat_outputs(name, plain(*args))
            torch.cuda.synchronize()
            if not name.startswith("compact_windows"):
                got, want = [g[:-1] for g in got], [w[:-1] for w in want]
            err = max_abs_err(got, want)
            require(err == 0, f"{name} differs from its plain version by "
                    f"{err} at TPC-H {label}")
        del stages
    ck, cp, ok1 = fused._compact(*F.q3_mask_customer(c),
                                 fused._cap(nc, 5, 16), rho3.PAD_R_INPUT)
    ok_, op_, ok2 = fused._compact(*F.q3_mask_orders(o),
                                   fused._cap(no, 5, 8), rho3.PAD_S_INPUT)
    require(bool(ok1 & ok2), "fused Q3's compactions overflowed")
    check_kernels(ck, cp, ok_, op_, rho3.Rho3Params(), True,
                  f"TPC-H SF {TPCH_SCALE} Q3 first join")
    j1, okj = fused._mat_join(ck, cp, ok_, op_, ok_.numel())
    lmask, lkey, _ = F.q3_mask_lineitem(l)
    lk, okc = fused._compact_keys(lmask, lkey, fused._cap(nl, 3, 4),
                                  rho3.PAD_S_INPUT)
    require(bool(okj & okc), "fused Q3's first join or compaction "
            "overflowed")
    uk = torch.where(j1.key == -3, rho3.PAD_R_INPUT, j1.s_payload)
    check_kernels(uk, j1.s_payload, lk, torch.zeros_like(lk),
                  rho3.Rho3Params(), False,
                  f"TPC-H SF {TPCH_SCALE} Q3 count join")
    say("TPC-H kernels: B5 and B6b at Q12's 1/48, B5 and B6a at Q3's "
        "orders, K1, K2, K3 and K3M at fused Q3's first join, K1, K2 and "
        "K3 at its count join equal their plain versions "
        f"(SF {TPCH_SCALE})")
    lk, lp, _ = F.q12_filter_lineitem(l)
    check_staged_ladder("Q12's join", o.key, o.rowid, lk, lp, True)
    del lk, lp
    ck, cp, _ = F.q3_filter_customer(c)
    sk, sp, _ = F.q3_filter_orders(o)
    check_staged_ladder("Q3's first join", ck, cp, sk, sp, False)


def check_staged_ladder(label, rk, rp, sk, sp, count: bool) -> dict:
    """One staged join's kernels up to its skew tier, on the filters'
    full-length columns (pad keys in the tail) as the staged plan hands
    them to RHO.  RSTATS on R with skew_plan's own candidates from S,
    keys-only and with payloads, exactly equal to its plain version; the
    skew tier's residual (S with the present candidates' rows remapped to
    the input pad), and for a count ladder whose plan gives a capacity
    its compaction (B5 and B6a exactly, as the compacted-residual tier's
    first attempt runs them); then K1 and K2 under the first salt on the
    packed keys of each attempt, at the residual's geometry and at the
    plain tier's, held as check_routing holds them where K1 overflows.
    Returns what it saw."""
    hinted, cap_rows = skewtier.skew_plan(sk)
    hk = skewtier.heavy_candidates(sk)
    for with_pay in (False, True):
        got = rstats.r_cand_stats_kernel(rk, rp, hk, with_pay)
        want = rstats.r_cand_stats_plain(rk, rp, hk, with_pay)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"RSTATS differs from its plain version by {err} "
                f"at {label} (payload={with_pay})")
    rcnt, rph = want
    pres = (hk >= 0) & (rcnt > 0)
    _, _, sk_res = skewtier.heavy_split_pass(sk, sp, hk, pres, rph)
    prm = skewtier._skew_prm() if count else rho3.Rho3Params()
    same = not count and not bool(pres.any())   # the residual is S itself
    attempts = {"skew and plain tiers" if same else "skew tier":
                (sk_res, sp, prm)}
    comp_ovf = None
    if count and cap_rows:
        kf = min(1.0, cap_rows * 128 / max(1, sk.numel()))
        stages, _, _, comp_ovf = compaction_stages(sk_res, sp, kf, cap_rows)
        for name in ("compact_windows", "scatter_segments"):
            args, kernel, plain = stages[name]
            got = flat_outputs(name, kernel(*args))
            want = flat_outputs(name, plain(*args))
            torch.cuda.synchronize()
            if name == "scatter_segments":   # callers drop the last row
                got, want = [g[:-1] for g in got], [w[:-1] for w in want]
            err = max_abs_err(got, want)
            require(err == 0, f"{name} differs from its plain version by "
                    f"{err} at {label}'s compacted residual")
        del stages
        ck, cp, _ = lanecompact.compact_kp_fast(
            sk_res, sp, cap_rows, pad_key=rho3.PAD_S_INPUT, keep_frac=kf)
        attempts["compacted-residual tier"] = (ck, cp, prm)
    if not same:
        attempts["plain tier"] = (sk, sp, rho3.Rho3Params())
    ovf = {}
    for what, (k, p, pm) in attempts.items():
        packed, _ = rho3.pack_keys(
            torch.cat([rk, k]),
            torch.cat([torch.zeros_like(rk), torch.ones_like(k)]),
            rho3.RETRY_SALTS[0])
        ovf[what] = check_routing(f"{label}, {what}", packed,
                                  torch.cat([rp, p]), rho3.default_scale(pm),
                                  None, None, pm)
    seen = {"hinted": hinted, "cap_rows": cap_rows,
            "candidates": int((hk >= 0).sum()),
            "present": int(pres.sum()), "r_rows": rk.numel(),
            "r_counted": int(rcnt.sum()), "compaction_overflow": comp_ovf,
            "k1_k2_overflow": ovf}
    say(f"TPC-H staged {label} up to its skew tier: RSTATS (keys-only and "
        f"payload) exact, K1 and K2 equal their plain versions: {seen}")
    return seen


def domain_check_ms(l, o, c) -> dict:
    """The fused plans' key-domain check (fused._in_domain: one aminmax a
    column) on fused Q3's and Q12's columns, timed beside the form it
    replaced (two compares, an and, an all: four passes a column), with
    its bound (each column read once)."""
    lim = rho3.MAX_KEY
    cases = {"Q3": ((c.key, lim), (o.custkey, lim), (o.key, lim),
                    (l.key, lim)),
             "Q12": ((o.key, lim), (l.key, lim))}

    def former(pairs):
        ok = None
        for key, limit in pairs:
            inside = ((key >= 0) & (key < limit)).all()
            ok = inside if ok is None else ok & inside
        return ok

    out = {}
    for q, pairs in cases.items():
        require(bool(fused._in_domain(*pairs)) and bool(former(pairs)),
                f"fused {q}'s keys lie outside the domain")
        out[q] = {"ms": cuda_ms(lambda: fused._in_domain(*pairs), TPCH_REPS),
                  "former_ms": cuda_ms(lambda: former(pairs), TPCH_REPS),
                  "bound_ms": nbytes(*(k for k, _ in pairs))
                  / HBM_BYTES_PER_S * 1e3}
        say(f"TPC-H fused {q}'s domain check: {out[q]['ms']:.3f} ms/call, "
            f"the former form {out[q]['former_ms']:.3f}, bound "
            f"{out[q]['bound_ms']:.3f}")
    return out


def tpch_phase(card, store) -> dict:
    """Phase 14: the TPC-H layer at SF 10.  dbgen's store written to the
    temporary directory `store` (phase 15 reads it too) and loaded onto
    the card, the eight plans on it and on generate_tpch_tables' SF 10
    tables (tpch_run), the cost of the staged plans' pads on one join, and
    the fused plans' kernels at their TPC-H shapes.  Returns the tpch
    line."""
    t0 = time.perf_counter()
    tpch_dbgen.generate(TPCH_SCALE, store)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dbgen = (tpch_loader.load_lineitem(store, device=DEV),
             tpch_loader.load_orders(store, device=DEV),
             tpch_loader.load_customer(store, device=DEV),
             tpch_loader.load_part(store, device=DEV),
             tpch_loader.load_nation(store, device=DEV))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    synth = TT.generate_tpch_tables(scale=TPCH_SCALE, device=DEV)
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    rows = {name: t.num_tuples for name, t in zip(TPCH_NAMES, dbgen)}
    say(f"TPC-H SF {TPCH_SCALE}: dbgen wrote the store in {gen_s:.2f} s, "
        f"the loaders put it on the card in {load_s:.2f} s ({rows}); "
        f"generate_tpch_tables took {synth_s:.2f} s")
    out = {"card": card, "scale": TPCH_SCALE, "dbgen_s": gen_s,
           "load_s": load_s, "generate_s": synth_s, "dbgen_rows": rows}
    for label, tables in (("dbgen", dbgen), ("synthetic", synth)):
        out[label] = tpch_run(label, tables, card)
    out["staged_pads"] = staged_pads_cost(dbgen[0], dbgen[1], card)
    out["domain_check"] = domain_check_ms(*dbgen[:3])
    check_tpch_kernels(*dbgen[:3])
    del dbgen, synth
    torch.cuda.synchronize()
    return {"tpch": out}


# Phase 15: the entry points at full width
CLI_X = "cache-exceed"               # bench.py's headline, through -x
CLI_SCAN_ROWS = 1 << 28
CLI_REPS = 3
STREAM_ROWS = 1 << 29                # 4 GiB of S keys and payloads
STREAM_CHUNK = 1 << 26
CLI_SEEDS = (11111, 22222)           # the CLI's --seed-r / --seed-s


def cli(argv) -> tuple:
    """(stdout, wall seconds) of `python -m aqp_tpu_torch argv`, run
    in-process; the device is waited for at the end."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main.main([str(a) for a in argv])
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def cli_tuples(out: str) -> int:
    lines = [ln for ln in out.splitlines() if ln.startswith("Result tuples")]
    require(len(lines) == 1, f"the CLI printed no contract: {out!r}")
    return int(lines[0].split(": ")[1])


def cli_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def cli_exact(nr, ns, z=None) -> tuple:
    """(the exact core's matches, skew_plan) on the CLI's seeded
    relations."""
    r = create_relation_pk(nr, seed=CLI_SEEDS[0], device=DEV)
    s = (create_relation_zipf(ns, nr, z, seed=CLI_SEEDS[1], device=DEV)
         if z else create_relation_fk(ns, nr, seed=CLI_SEEDS[1], device=DEV))
    m = int(mergejoin.merge_join_count(r.key, r.payload, s.key,
                                       s.payload).matches)
    plan = skewtier.skew_plan(s.key)
    del r, s
    torch.cuda.empty_cache()
    return m, plan


def cli_run(label, argv, out_rows) -> tuple:
    """One CLI call as a main path of its own: launches reset before and
    read after.  Returns (stdout, launches)."""
    reset_launches()
    out, secs = cli(argv)
    launches = main_path_launches(f"15 CLI {label}")
    out_rows[label] = {"argv": " ".join(map(str, argv)), "wall_s": secs,
                       "launched": {k: v for k, v in launches.items() if v}}
    say(f"CLI {label}: {secs:.2f} s, launches "
        f"{out_rows[label]['launched']}")
    return out, launches


def need_launched(label, launches, names) -> None:
    missing = [k for k in names if launches[k] == 0]
    require(not missing, f"CLI {label} launched no {missing}")


def cli_joins(card, out) -> None:
    """join at bench.py's headline (-x cache-exceed): RHO, RHO -m, PHT and
    -z 1.5; then -x L (RHO) once.  Every answer equal to the exact core
    on the same seeded relations."""
    nr, ns = cli_main._dataset_sizes(CLI_X)
    require((nr, ns) == (NR, NS), f"-x {CLI_X} is {nr} x {ns}")
    exact_fk, _ = cli_exact(nr, ns)
    require(exact_fk == ns, "exact core: FK matches != |S|")
    exact_z, _ = cli_exact(nr, ns, 1.5)
    runs = {"join RHO": ([], exact_fk, ("K1", "K2", "K3")),
            "join RHO -m": (["-m"], exact_fk, ("K1", "K2", "K3M")),
            "join PHT": (["-a", "PHT"], exact_fk, ("K1", "K2", "K3TWO")),
            "join -z 1.5": (["-z", 1.5], exact_z,
                            ("RSTATS", "compact_windows",
                             "scatter_segments"))}
    for label, (extra, want, kernels) in runs.items():
        stdout, launches = cli_run(label, ["join", "-x", CLI_X, "--reps",
                                           CLI_REPS, "--quiet", *extra],
                                   out)
        got = cli_tuples(stdout)
        j = cli_json(stdout)
        require(got == j["matches"] == want, f"CLI {label}: {got} result "
                f"tuples, the exact core {want}")
        need_launched(label, launches, kernels)
        out[label].update(matches=got, best_total_s=j["phases"]["total"],
                          mrows_per_s=j["mrows_per_s"])
        say(f"CLI {label}: {got} tuples (= exact core), best "
            f"{j['phases']['total'] * 1e3:.3f} ms, "
            f"{j['mrows_per_s']:.1f} M rows/s ({card})")
    # -x L: 50M x 200M, once
    lr, ls = cli_main._dataset_sizes("L")
    stdout, launches = cli_run("join -x L", ["join", "-x", "L", "--reps", 1,
                                             "--quiet"], out)
    want, plan = cli_exact(lr, ls)
    got = cli_tuples(stdout)
    j = cli_json(stdout)
    require(got == want == ls, f"CLI join -x L: {got} result tuples, the "
            f"exact core {want}, |S| {ls}")
    rung = tier_name(plan[0], plan[1], launches["K3"])
    out["join -x L"].update(matches=got, total_s=j["phases"]["total"],
                            mrows_per_s=j["mrows_per_s"],
                            pipeline_runs=launches["K3"], serving_rung=rung,
                            max_abs_err=check_x_l_kernels(lr, ls))
    say(f"CLI join -x L ({lr} x {ls}): {got} tuples (= exact core), "
        f"{j['phases']['total'] * 1e3:.3f} ms, {j['mrows_per_s']:.1f} M "
        f"rows/s; {launches['K3']} pipeline runs, served by: {rung} "
        f"({card})")


def check_x_l_kernels(nr, ns) -> dict:
    """K1, K2 and K3 (K3M with payloads) held exactly to their plain
    versions at -x L's geometry (the plain rung's Rho3Params()): the CLI's
    seeded keys with random payloads (drawn after the keys, so the keys
    are the CLI's), keys-only and with payloads.  Returns each kernel's
    max_abs_err."""
    r = create_relation_pk(nr, seed=CLI_SEEDS[0], random_payload=True,
                           device=DEV)
    s = create_relation_fk(ns, nr, seed=CLI_SEEDS[1], random_payload=True,
                           device=DEV)
    errs = {}
    for with_payload in (False, True):
        check_kernels(r.key, r.payload, s.key, s.payload, rho3.Rho3Params(),
                      with_payload, "-x L", errs=errs)
    del r, s
    torch.cuda.empty_cache()
    say(f"CLI join -x L: K1, K2, K3 and K3M equal their plain versions at "
        f"{nr} x {ns}, max_abs_err {errs}")
    return errs


def cli_tpch(card, store, oracle, out) -> None:
    """tpch -q 3|10|12|19 on the dbgen store, staged and fused: each count
    equal to phase 14's oracle; the fused plans launch B5, B6a/B6b and
    K3M."""
    fused_launches = {}
    for form in ("staged", "fused"):
        for q in (3, 10, 12, 19):
            label = f"tpch Q{q} {form}"
            stdout, launches = cli_run(
                label, ["tpch", "-q", q, "--data", store, "--scale",
                        TPCH_SCALE, "--reps", CLI_REPS]
                + (["--fused"] if form == "fused" else []), out)
            got = cli_tuples(stdout)
            require(got == oracle[f"Q{q}"], f"CLI {label}: {got} result "
                    f"tuples, phase 14's oracle {oracle[f'Q{q}']}")
            j = cli_json(stdout)
            out[label].update(matches=got, best_total_s=j["phases"]["total"],
                              mrows_per_s=j["mrows_per_s"])
            if form == "fused":
                for k, v in launches.items():
                    fused_launches[k] = fused_launches.get(k, 0) + v
            say(f"CLI {label}: {got} tuples (= oracle), best "
                f"{j['phases']['total'] * 1e3:.3f} ms ({card})")
    need_launched("tpch --fused", fused_launches,
                  ("compact_windows", "scatter_segments",
                   "scatter_segments_one", "K3M"))


def cli_scans(card, out) -> None:
    """scan in its six modes over 2^28 rows at 10%; count and sum launch
    B7, bitvector B8."""
    for mode in ("count", "sum", "bitvector", "index", "values", "dict"):
        label = f"scan {mode}"
        stdout, launches = cli_run(label, [
            "scan", "--mode", mode, "--rows", CLI_SCAN_ROWS,
            "--selectivity", 10, "--reps", 5], out)
        j = cli_json(stdout)
        require(j["rows"] == CLI_SCAN_ROWS and j["mode"] == mode,
                f"CLI {label}: {j}")
        kernel = {"count": "scan_count", "sum": "scan_sum",
                  "bitvector": "scan_bitvector"}.get(mode)
        if kernel:
            need_launched(label, launches, (kernel,))
        out[label].update(seconds=j["seconds"], gb_per_s=j["gb_per_s"])
        say(f"CLI {label}: {j['seconds'] * 1e3:.3f} ms, {j['gb_per_s']} "
            f"GB/s ({card})")


def cli_matrix(card, out) -> None:
    """matrix RHO, PHT, PSM at the headline, both materialize forms, 3
    reps: no error row, every matches |S|."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/matrix.csv"
        cli_run("matrix", ["matrix", "--algs", "RHO,PHT,PSM", "--sizes",
                           f"{NR}x{NS}", "--materialize", "both", "--reps",
                           CLI_REPS, "--csv", path], out)
        with open(path) as fh:
            lines = fh.read().splitlines()
    require(lines[0] == CSV_HEADER, f"matrix header {lines[0]!r}")
    rows = [ln.split(",") for ln in lines[1:]]
    require(not [r for r in rows if r[8] == "error"],
            "the matrix has an error row")
    matches = [float(r[9]) for r in rows if r[8] == "matches"]
    require(len(matches) == 3 * 2 * CLI_REPS and set(matches) == {float(NS)},
            f"matrix matches {matches}")
    total = {}
    for r in rows:
        if r[8] == "phase_total_s":
            total.setdefault(f"{r[1]} m={r[2]}", []).append(float(r[9]))
    out["matrix"].update(rows=len(rows), total_s=total)
    say(f"CLI matrix: {len(rows)} rows, no error, matches |S| everywhere; "
        f"phase_total_s {total} ({card})")


def trace_wall_s(path: str) -> float:
    """The profiled section's wall seconds: the span of the trace's
    events (the profiler's own window event included)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    return (hi - lo) * 1e-6


def cli_profile(card, out) -> None:
    """join --profile at the headline: the trace exists, 0 <
    device_total_s <= the section's wall time; its kernels' calls printed
    beside the launchers' counts."""
    with tempfile.TemporaryDirectory() as tmp:
        stdout, launches = cli_run("join --profile", [
            "join", "-x", CLI_X, "--reps", CLI_REPS, "--quiet",
            "--profile", tmp], out)
        j = cli_json(stdout)
        rep = profiler.parse_trace(tmp)
        require(rep.trace_path is not None, "--profile wrote no trace")
        wall = trace_wall_s(rep.trace_path)
    require(j["profile_dir"] == tmp and "device_total_s" in j,
            f"--profile JSON {j}")
    require(0 < rep.device_total_s <= wall, f"device_total_s "
            f"{rep.device_total_s} outside (0, {wall}]")
    require(cli_tuples(stdout) == NS, "CLI join --profile: tuples != |S|")
    calls = {k: v for k, v in rep.per_program_calls.items()}
    out["join --profile"].update(
        device_total_s=rep.device_total_s, host_total_s=rep.host_total_s,
        section_wall_s=wall, device_share=rep.device_total_s / wall,
        trace_kernel_calls=calls,
        trace_kernel_s={k: v for k, v in rep.per_program_s.items()})
    say(f"CLI join --profile: device busy {rep.device_total_s * 1e3:.3f} ms "
        f"of the section's {wall * 1e3:.3f} ms ({rep.device_total_s / wall:.1%}"
        f"; idle {1 - rep.device_total_s / wall:.1%}), host "
        f"{rep.host_total_s * 1e3:.3f} ms ({card})")
    say("CLI join --profile: kernels in the trace (name: calls) "
        f"{json.dumps(calls)}; the launchers' counts "
        f"{out['join --profile']['launched']}")


def pinned_s(n: int, seed: int):
    """(key, payload, native seconds): S's keys from native.gen_fk_host
    over R's NR keys and random payloads, in pinned host memory."""
    t0 = time.perf_counter()
    keys = native.gen_fk_host(n, NR, seed=seed)
    gen_s = time.perf_counter() - t0
    key_h = torch.empty(n, dtype=torch.int32, pin_memory=True)
    pay_h = torch.empty(n, dtype=torch.int32, pin_memory=True)
    key_h.copy_(torch.from_numpy(keys))
    del keys
    gen = torch.Generator(device=DEV).manual_seed(seed)
    for lo in range(0, n, STREAM_CHUNK):
        m = min(STREAM_CHUNK, n - lo)
        pay_h[lo:lo + m].copy_(torch.randint(
            -(1 << 31), 1 << 31, (m,), generator=gen, dtype=torch.int64,
            device=DEV).int())
    return key_h, pay_h, gen_s


def stream_phase(card) -> dict:
    """The streaming join: R = the headline's 13.1M dense-PK relation on
    the card, S = 2^29 FK rows on the host (native.gen_fk_host), pinned
    and streamed in 2^26-row chunks.  (matches, checksum) equal to the
    exact core on the whole S on the card; the streamed time below the
    copies' alone plus the probes' alone."""
    relR = create_relation_pk(NR, seed=CLI_SEEDS[0], random_payload=True,
                              device=DEV)
    n, why = STREAM_ROWS, None
    while True:
        try:
            key_h, pay_h, gen_s = pinned_s(n, CLI_SEEDS[1])
            break
        except RuntimeError as e:          # the host could not pin S
            if n <= STREAM_CHUNK:
                raise
            why = f"{n} rows could not be pinned: {e}"
            n //= 2
            say(f"streamjoin: {why}; halving S")
    say(f"streamjoin: native.gen_fk_host made {n} rows in {gen_s:.3f} s")
    byts = 2 * 4 * n

    def chunks():
        return streamjoin.chunk_host_relation(key_h, pay_h, STREAM_CHUNK)

    # the exact core on the whole S, on the card in one piece
    sk, sp = key_h.to(DEV), pay_h.to(DEV)
    ex = mergejoin.merge_join_count(relR.key, relR.payload, sk, sp)
    want = (int(ex.matches), int(ex.checksum))
    require(want[0] == n, f"exact core: {want[0]} matches, |S| {n}")
    got = streamjoin.streaming_join_count(relR, chunks(), device=DEV)
    require(got == want, f"streamjoin {got} != the exact core's {want}")

    def streamed():
        return streamjoin.streaming_join_count(relR, chunks(), device=DEV)

    def copy_alone():
        bufs = [torch.empty(STREAM_CHUNK, dtype=torch.int32, device=DEV)
                for _ in range(4)]
        for i, (k, p) in enumerate(chunks()):
            bufs[2 * (i % 2)][:k.numel()].copy_(k, non_blocking=True)
            bufs[2 * (i % 2) + 1][:p.numel()].copy_(p, non_blocking=True)

    def probe_alone():
        rk, rp = streamjoin.build_sorted(relR.key, relR.payload)
        total = torch.zeros((), dtype=torch.int64, device=DEV)
        for lo in range(0, n, STREAM_CHUNK):
            m, _ = streamjoin.probe_chunk(rk, rp, sk[lo:lo + STREAM_CHUNK],
                                          sp[lo:lo + STREAM_CHUNK])
            total += m
        return total

    times = {}
    for label, fn in (("streamed", streamed), ("copy alone", copy_alone),
                      ("probe alone", probe_alone)):
        fn()
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        times[label] = best
    del sk, sp, relR, key_h, pay_h
    torch.cuda.empty_cache()
    overlap = times["copy alone"] + times["probe alone"]
    require(times["streamed"] < overlap, f"streamed {times['streamed']:.4f}"
            f" s is not below copy alone + probe alone {overlap:.4f} s")
    out = {"card": card, "rows": n, "chunk_rows": STREAM_CHUNK,
           "bytes": byts, "halved_because": why, "native_gen_s": gen_s,
           "matches": got[0], "checksum": got[1],
           "streamed_s": times["streamed"],
           "copy_alone_s": times["copy alone"],
           "probe_alone_s": times["probe alone"],
           "host_gb_per_s": byts / times["streamed"] / 1e9,
           "copy_gb_per_s": byts / times["copy alone"] / 1e9}
    say(f"streamjoin: {n} rows in {n // STREAM_CHUNK} chunks, (matches, "
        f"checksum) = {got} (= exact core); streamed "
        f"{times['streamed'] * 1e3:.3f} ms ({out['host_gb_per_s']:.2f} GB/s "
        f"from the host), copy alone {times['copy alone'] * 1e3:.3f} ms "
        f"({out['copy_gb_per_s']:.2f} GB/s), probe alone "
        f"{times['probe alone'] * 1e3:.3f} ms ({card})")
    return out


def entry_phase(card, store, oracle) -> None:
    """Phase 15: the entry points at full width, in-process: the CLI's
    join (headline RHO, RHO -m, PHT, -z 1.5; -x L), tpch (the dbgen
    store, staged and fused), scan (six modes, 2^28 rows), matrix and
    join --profile; then the streaming join."""
    out = {}
    cli_joins(card, out)
    cli_tpch(card, store, oracle, out)
    cli_scans(card, out)
    cli_matrix(card, out)
    cli_profile(card, out)
    print(json.dumps({"cli": out}), flush=True)
    reset_launches()
    stream = stream_phase(card)
    main_path_launches("15 streamjoin")
    print(json.dumps({"streamjoin": stream}), flush=True)


# ---------------------------------------------------------------------------
# Phase 16: 64-bit keys through every join name, and the join-sweep drivers

KEY64_HI = 1 << 40
KEY64_TRAP = 16                      # S rows keyed 2^40 + 1 + 2^32
KEY64_FORMS = (("keys-only", JoinConfig(checksum=False)),
               ("checksummed", JoinConfig()))
KEY64_MATERIALIZE = ("RHO", "PHT", "MWAY", "INL")
KEY64_DENSE = ("CHT", "CRKJ", "CrkJoin", "CRKJF", "CRKJS")
KEY64_DENSE_MATERIALIZE = ("CHT", "CRKJ")
KEY64_WATCHDOG_S = 600               # the phase's own watchdog


def wide_payloads(n, gen) -> tuple:
    """(int64 payloads in [-2^40, 2^40), their low 32 bits as int32)."""
    p = torch.randint(-(1 << 40), 1 << 40, (n,), generator=gen, device=DEV,
                      dtype=torch.int64)
    return p, (((p + (1 << 31)) & U32) - (1 << 31)).int()


def key64_relations(nr, ns, seed, sparse=True) -> tuple:
    """((R64, S64), (R32, S32)): R the PK keys 1..nr, S FK keys, with int64
    payloads beyond 32 bits.  sparse: the int64 keys are those + 2^40, and
    the first KEY64_TRAP S keys 2^40 + 1 + 2^32 (R's key 2^40 + 1 in its
    low 32 bits, no R key); the int32 twin keys those rows nr + 1, which
    no R key is either.  Else the int64 keys are the int32 keys."""
    r, s = seeded(nr, ns, seed)
    gen = torch.Generator(device=DEV).manual_seed(seed + 5)
    rp64, rp32 = wide_payloads(nr, gen)
    sp64, sp32 = wide_payloads(ns, gen)
    off = KEY64_HI if sparse else 0
    rk64, sk64, sk32 = r.key.long() + off, s.key.long() + off, s.key
    if sparse:
        sk64[:KEY64_TRAP] = KEY64_HI + 1 + (1 << 32)
        sk32 = sk32.clone()
        sk32[:KEY64_TRAP] = nr + 1
    return ((Relation(rk64, rp64), Relation(sk64, sp64)),
            (Relation(r.key, rp32), Relation(sk32, sp32)))


def key64_truth(narrow, traps: int) -> dict:
    """The int32 twin through RHO's kernel pipeline (the dense path off):
    keys-only and checksummed counts and the materialized live rows, every
    S row but the `traps` matching.  These are the answers the int64 calls
    are held to."""
    cfg = JoinConfig(dense_path=False)
    out = {}
    for label, c in KEY64_FORMS:
        res = run_join(*narrow, "RHO", cfg.replace(checksum=c.checksum))[0]
        out[label] = (int(res.matches), int(res.checksum))
    res = run_join(*narrow, "RHO", cfg.replace(materialize=True))[0]
    out["rows"] = live_rows(res.key, res.r_payload, res.s_payload)
    out["materialize"] = (int(res.matches), int(res.checksum))
    expect = narrow[1].num_tuples - traps
    require(out["checksummed"][0] == out["keys-only"][0]
            == out["materialize"][0] == expect, "the int32 twin through "
            f"RHO: {out} matches, want {expect}")
    return out


def key64_calls(sparse, dense, nl) -> dict:
    """Phase 16's int64 calls: label -> a run_join call."""
    calls = {}
    for name in sorted(set(JOIN_ALGORITHMS) - {"NL"}):
        for label, cfg in KEY64_FORMS:
            calls[f"{name} {label}"] = functools.partial(
                run_join, *sparse, name, cfg.replace(key64=True))
    for name in KEY64_MATERIALIZE:
        calls[f"{name} materialize"] = functools.partial(
            run_join, *sparse, name, JoinConfig(key64=True,
                                                materialize=True))
    for name in KEY64_DENSE:
        for label, cfg in KEY64_FORMS:
            calls[f"{name} dense {label}"] = functools.partial(
                run_join, *dense, name, cfg.replace(key64=True))
    for name in KEY64_DENSE_MATERIALIZE:
        calls[f"{name} dense materialize"] = functools.partial(
            run_join, *dense, name, JoinConfig(key64=True, materialize=True))
    calls["NL checksummed"] = functools.partial(
        run_join, *nl, "NL", JoinConfig(key64=True))
    calls["NL materialize"] = functools.partial(
        run_join, *nl, "NL", JoinConfig(key64=True, materialize=True))
    return calls


def check_key64_rows(label, res, wide, want) -> None:
    """A materialized int64 result: int64 columns; (key - 2^40, payloads'
    low 32 bits) equal to the twin's live rows as a multiset; every live
    R payload R's own (all 64 bits), the S payloads those of S's matching
    rows."""
    r64, s64 = wide
    require(res.key.dtype == res.r_payload.dtype == res.s_payload.dtype
            == torch.int64, f"{label}: columns {res.key.dtype}, "
            f"{res.r_payload.dtype}, {res.s_payload.dtype}")
    off = KEY64_HI if int(r64.key.min()) > KEY64_HI else 0
    live = res.key != -3
    k = torch.where(live, res.key - off, -3)
    require(all(torch.equal(a, b) for a, b in zip(
        live_rows(k, res.r_payload, res.s_payload), want["rows"])),
        f"{label}: live rows != the int32 twin's")
    by_key = torch.empty_like(r64.payload)
    by_key[r64.key - off - 1] = r64.payload
    require(torch.equal(res.r_payload[live], by_key[k[live] - 1]),
            f"{label}: an R payload is not R's own 64 bits")
    hit = torch.isin(s64.key, r64.key)
    require(torch.equal(torch.sort(res.s_payload[live]).values,
                        torch.sort(s64.payload[hit]).values),
            f"{label}: the S payloads are not S's matching rows'")


def key64_times(card, sparse, narrow, nl, nl32) -> dict:
    """ms per call (CUDA events, REPS calls after a warm-up; NL one) of
    RHO, PHT, MWAY and INL on the int64 relations, keys-only and
    materialized, and of NL at 2^18 x 2^20, checksummed and materialized,
    each beside the same call on the int32 twin; and the int64 call's
    phases (seconds, PhaseTimer)."""
    out = {}
    cases = [(name, form, sparse, narrow, REPS)
             for name in KEY64_MATERIALIZE
             for form in (("keys-only", JoinConfig(checksum=False)),
                          ("materialize", JoinConfig(materialize=True)))]
    cases += [("NL", form, nl, nl32, 1)
              for form in (("checksummed", JoinConfig()),
                           ("materialize", JoinConfig(materialize=True)))]
    for name, (label, cfg), wide, twin, reps in cases:
        call64 = functools.partial(run_join, *wide, name,
                                   cfg.replace(key64=True))
        ms64 = cuda_ms(call64, reps)
        ms32 = cuda_ms(functools.partial(run_join, *twin, name, cfg),
                       reps)
        phases = call64()[1].phases
        out[f"{name} {label}"] = {"int64": ms64, "int32": ms32,
                                  "int64_phases": phases}
        say(f"phase 16 {name} {label}: int64 {ms64:.3f} ms/call, "
            f"int32 twin {ms32:.3f} ms/call ({card}); int64 phases "
            + ", ".join(f"{k} {v * 1e3:.3f} ms"
                        for k, v in phases.items()))
    return out


def sweep_drivers() -> dict:
    """join_overview (and its key64 rows), skew, selectivity and scaling at
    full size, read through their config functions as the JAX package's
    drivers define them: name -> (configurations, backend label)."""
    from aqp_tpu_torch.experiments import (join_overview, scaling,
                                           selectivity, skew)

    return {
        "join_overview": (join_overview.configs(device=DEV), None),
        "join_overview --key64": (join_overview.key64_configs(device=DEV),
                                  "cuda_k64"),
        "skew": ([skew.config(device=DEV)], None),
        "selectivity": ([selectivity.config(device=DEV)], None),
        "scaling": ([scaling.config(device=DEV)], None),
    }


def sweep_point(size_r, size_s, skew, sel) -> tuple:
    """A workload as the harness's rows name it."""
    return (int(size_r), int(size_s), 0.0 if skew is None else float(skew),
            100.0 if sel is None else float(sel))


def sweep_exact(cfgs) -> dict:
    """Per workload of `cfgs` (sweep_point), the exact core's matches
    (merge_join_count_keys) on the relations the harness draws for it."""
    out = {}
    for cfg in cfgs:
        for (nr, ns), z, sel in itertools.product(cfg.sizes, cfg.skews,
                                                  cfg.selectivities):
            point = sweep_point(nr, ns, z, sel)
            if point in out:
                continue
            r, s = _gen_workload(nr, ns, z, sel, cfg.seed_r, cfg.seed_s,
                                 cfg.alias_payloads, DEV, cfg.key64)
            out[point] = int(mergejoin.merge_join_count_keys(
                r.key, s.key).matches)
            del r, s
            torch.cuda.empty_cache()
    return out


def sweep_checks(name, rows, exact) -> dict:
    """A driver's rows: no error row, and every row's matches equal to the
    exact core's on the same workload (`exact`, sweep_exact).  Returns per
    (alg, size, skew, selectivity) its throughput (M rows/s)."""
    errors = [r for r in rows if r["measurement"] == "error"]
    require(not errors, f"{name}: error rows {errors}")
    out = {}
    for r in rows:
        point = f"{r['alg']} {r['size_r']}x{r['size_s']} z={r['skew']} " \
                f"sel={r['selectivity']} m={r['materialize']}"
        if r["measurement"] == "matches":
            want = exact[sweep_point(r["size_r"], r["size_s"], r["skew"],
                                     r["selectivity"])]
            require(r["value"] == want, f"{name} {point}: {r['value']} "
                    f"matches, the exact core {want}")
        if r["measurement"] == "throughput_mrows" and r["rep"] == 0:
            out[point] = r["value"]
    return out


def sweeps_held(drivers, exact, launched) -> dict:
    """The sweeps once more with every kernel launch held to its plain
    version on the inputs the main path gives it (held_to_plain): each
    configuration at 1 pipelined call after its deferred call, keys-only
    as the drivers run it and checksummed (payloads through K1, K2, K3,
    K3TWO, RSTATS and the pair scatter).  Every launch of this pass must be
    a held one (the launch counts' rise equals the held launches), and
    every kernel the sweeps launched must be held.  Returns per kernel its
    held launches, max_abs_err and input shapes."""
    held = {}
    reset_launches()
    t0 = time.perf_counter()
    with held_to_plain(held):
        for name, (cfgs, backend) in drivers.items():
            for checksum in (False, True):
                rows = []
                for cfg in cfgs:
                    rows += run_experiments_pipelined(dataclasses.replace(
                        cfg, reps=1, checksum=checksum), backend=backend)
                sweep_checks(f"{name} (held, checksum={checksum})", rows,
                             exact[name])
                torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    rose = {k: v for k, v in read_launches().items() if v}
    require(rose == {k: v["launches"] for k, v in held.items()},
            f"a launch escaped the plain check: launched {rose}, held "
            f"{ {k: v['launches'] for k, v in held.items()} }")
    missing = sorted(set(launched) - set(held))
    require(not missing, f"the sweeps launched {missing}, never held")
    say(f"phase 16 drivers held to the plain versions in {secs:.2f} s: "
        + "; ".join(f"{k} {v['launches']} launches on "
                    f"{len(v['inputs'])} input shapes, max_abs_err "
                    f"{v['max_abs_err']}" for k, v in held.items()))
    return held


def sweeps(card) -> tuple:
    """The four drivers' sweeps at full size (3 pipelined calls a
    configuration) as one main path; then every row's matches against the
    exact core, and the sweeps again with every kernel launch held to its
    plain version (sweeps_held).  Returns (each driver's seconds, rows and
    points, with the held launches; the main path's launches)."""
    drivers = sweep_drivers()
    out, runs = {}, {}
    torch.cuda.synchronize()
    reset_launches()
    for name, (cfgs, backend) in drivers.items():
        t0 = time.perf_counter()
        rows = []
        for cfg in cfgs:
            rows += run_experiments_pipelined(cfg, backend=backend)
        runs[name] = (rows, time.perf_counter() - t0)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launched = {k: v for k, v in main_path_launches("16 sweeps").items()
                if v}
    say(f"phase 16 drivers' launches: {launched}")
    exact = {name: sweep_exact(cfgs) for name, (cfgs, _) in drivers.items()}
    for name, (rows, secs) in runs.items():
        points = sweep_checks(name, rows, exact[name])
        out[name] = {"s": secs, "rows": len(rows), "mrows_per_s": points}
        say(f"phase 16 driver {name}: {len(rows)} rows, no error, matches "
            f"equal to the exact core's, in {secs:.2f} s ({card}): "
            f"{json.dumps(points)}")
    out["held"] = sweeps_held(drivers, exact, launched)
    return out, launched


def key64_phase(card) -> dict:
    """Phase 16: every join name but NL on 13.1M x 52.4M int64 relations
    (keys above 2^40, 16 S keys that alias R's 2^40 + 1 under a 32-bit
    cut), keys-only and checksummed, materialized for RHO, PHT, MWAY and
    INL; NL at 2^18 x 2^20; dense int64 keys through CHT and the cracking
    names: each held to its int32 twin through RHO's kernels, no kernel
    launched by any int64 call; the int64 times beside the int32 twin's;
    join --key64 -x cache-exceed; the four join-sweep drivers at full
    size.  Returns the key64 line."""
    faulthandler.dump_traceback_later(KEY64_WATCHDOG_S, exit=True)
    sparse, narrow = key64_relations(NR, NS, seed=1701)
    dense, dense32 = key64_relations(NR, NS, seed=1702, sparse=False)
    nl, nl32 = key64_relations(NL_NR, NL_NS, seed=1703)
    want = {"sparse": key64_truth(narrow, KEY64_TRAP),
            "dense": key64_truth(dense32, 0),
            "nl": key64_truth(nl32, KEY64_TRAP)}
    calls = key64_calls(sparse, dense, nl)
    torch.cuda.synchronize()
    reset_launches()
    results = {label: fn()[0] for label, fn in calls.items()}
    torch.cuda.synchronize()
    k64_launches = main_path_launches("16 key64")
    require(not any(k64_launches.values()), "an int64 join launched a "
            f"kernel: {k64_launches}")
    for label, res in results.items():
        which = ("nl" if label.startswith("NL") else
                 "dense" if " dense " in label else "sparse")
        form = label.rsplit(" ", 1)[1]
        got = (int(res.matches), int(res.checksum))
        w = want[which]["materialize" if form == "materialize" else
                        "checksummed"]
        if form == "keys-only":
            require(got[0] == w[0], f"{label}: {got[0]} matches, the int32 "
                    f"twin {w[0]}")
        else:
            require(got == w, f"{label}: {got}, the int32 twin {w}")
        if form == "materialize":
            check_key64_rows(label, res,
                             {"nl": nl, "dense": dense}.get(which, sparse),
                             want[which])
    del results
    say(f"phase 16: {len(calls)} int64 calls (every name but NL at {NR} x "
        f"{NS}, keys above 2^40 with {KEY64_TRAP} alias traps; NL at "
        f"{NL_NR} x {NL_NS}; dense int64 keys through CHT and the cracking "
        "names) equal their int32 twins through RHO's kernels; materialized "
        "columns int64, R and S payloads whole; no kernel launched")
    ms = key64_times(card, sparse, narrow, nl, nl32)
    del sparse, narrow, dense, dense32, nl, nl32, calls
    torch.cuda.empty_cache()
    argv = ["join", "--key64", "-x", CLI_X, "--reps", CLI_REPS, "--quiet"]
    reset_launches()
    stdout, secs = cli(argv)
    cli_launches = main_path_launches("16 CLI join --key64")
    got, j = cli_tuples(stdout), cli_json(stdout)
    require(got == j["matches"] == NS, f"CLI join --key64: {got} result "
            f"tuples, |S| {NS}")
    require(not any(cli_launches.values()), "CLI join --key64 launched "
            f"{cli_launches}")
    cli_out = {"argv": " ".join(map(str, argv)), "wall_s": secs,
               "matches": got, "best_total_s": j["phases"]["total"],
               "mrows_per_s": j["mrows_per_s"]}
    say(f"CLI join --key64 -x {CLI_X}: {got} tuples (= |S|), best "
        f"{j['phases']['total'] * 1e3:.3f} ms, {secs:.2f} s ({card})")
    drivers, launched = sweeps(card)
    return {"key64": {"card": card, "ms": ms, "cli": cli_out,
                      "sweeps": drivers, "sweep_launches": launched}}


# ---------------------------------------------------------------------------
# Phase 17: the distributed layer on one rank, and the 8-shard layout

PARALLEL_WATCHDOG_S = 600            # the phase's own watchdog
SHARDS = 8                           # the 8-shard layout laid out on the card
WEAK_SCALING_ARGV = ["--ranks", "1", "--reps", "3"]
WEAK_SCALING_TIMEOUT_S = 300
DIST_FORMS_ARGV = ["--ranks", "1", "--reps", "3"]
DIST_FORMS_TIMEOUT_S = 300


def exchange_on_one_card(rel, pad_key) -> tuple:
    """The shuffle of `rel` over SHARDS ranks laid out on the card: each
    row block through _pack_send_buffers at SHARDS destinations, the
    all_to_all as the transpose of the stacked (src, dst, cap) buffers.
    Returns (receive keys (dst, src * cap), payloads, overflow)."""
    rows = -(-rel.num_tuples // SHARDS)
    cap = pdj._capacity(rows, SHARDS, 2.0)
    ks, ps, ovf = [], [], 0
    for b in range(SHARDS):
        k, p, o = pshuffle._pack_send_buffers(*row_block(rel, b, SHARDS),
                                              SHARDS, cap, pad_key, 0)
        ks.append(k)
        ps.append(p)
        ovf = ovf + o
    recv = [torch.stack(x).transpose(0, 1).reshape(SHARDS, -1)
            for x in (ks, ps)]
    return recv[0], recv[1], ovf


def eight_shard_layout(relR, relS) -> tuple:
    """The 8-shard distributed count join on one card: the exchange, then
    the "pallas" shard-local count (K1, K2, K3) on each received shard.
    Returns (matches, checksum, overflow), summed over the shards."""
    rk, rp, ovf_r = exchange_on_one_card(relR, pshuffle.PAD_R)
    sk, sp, ovf_s = exchange_on_one_card(relS, pshuffle.PAD_S)
    m, c, ovf = 0, 0, ovf_r + ovf_s
    for d in range(SHARDS):
        md, cd, od = pdj._local_count(rk[d], rp[d], sk[d], sp[d], "pallas")
        m, c, ovf = m + md, c + cd, ovf + od
    return m, c & U32, ovf


def check_block_on_the_cpu(relS) -> None:
    """Block 0 of S through _pack_send_buffers on the card and on the CPU:
    equal position by position, the overflow too."""
    rows = -(-relS.num_tuples // SHARDS)
    cap = pdj._capacity(rows, SHARDS, 2.0)
    key, pay = row_block(relS, 0, SHARDS)
    card = pshuffle._pack_send_buffers(key, pay, SHARDS, cap,
                                       pshuffle.PAD_S, 0)
    cpu = pshuffle._pack_send_buffers(key.cpu(), pay.cpu(), SHARDS, cap,
                                      pshuffle.PAD_S, 0)
    require(all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)),
            "a block's send buffers on the card differ from the CPU's")


def parallel_forms(relR, relS, zs, mesh, mesh2) -> dict:
    """Phase 17's forms, label -> call, through the layer's entry points
    on one rank (the relations are this rank's shards)."""
    R, S, Z = (shard_relation(x, mesh) for x in (relR, relS, zs))
    count = {eng: pdj.make_dist_join_count(mesh, R.num_tuples, S.num_tuples,
                                           engine=eng)
             for eng in ("pallas", "xla")}
    # the heavy rows a rank keeps: all of S's heavy keys' rows at one rank
    # (tests/test_skew.py's cap_heavy = |S|; the default 4,096 holds a
    # small shard's)
    skew_fn = pskew.make_dist_join_count_skew(mesh, R.num_tuples,
                                              Z.num_tuples,
                                              cap_heavy=Z.num_tuples)
    return {
        "count pallas": lambda: count["pallas"](R.key, R.payload, S.key,
                                                S.payload),
        "count xla": lambda: count["xla"](R.key, R.payload, S.key,
                                          S.payload),
        "2d": lambda: pdj.dist_join_count_2d(relR, relS, mesh2),
        "materialize": lambda: pdj.dist_join_materialize(relR, relS, mesh),
        "ring": lambda: pdj.dist_join_count_ring(relR, relS, mesh),
        "skew z=1.5": lambda: skew_fn(R.key, R.payload, Z.key, Z.payload),
        "auto": lambda: pdj.dist_join_count_auto(relR, relS, mesh),
        "auto z=1.5": lambda: pdj.dist_join_count_auto(relR, zs, mesh),
        f"{SHARDS}-shard layout": lambda: eight_shard_layout(relR, relS),
    }


# the forms whose shard-local join is the rho3 pipeline
KERNEL_FORMS = ("count pallas", "2d", "auto", "auto z=1.5",
                f"{SHARDS}-shard layout")


def check_parallel(out, want, want_z, exact_rows) -> dict:
    """Every form's answer against the exact core's: matches, checksum,
    zero overflow, the materialized live rows; returns the tiers."""
    def scalars(res):
        return tuple(int(x) if isinstance(x, torch.Tensor) else x
                     for x in res)

    for label in ("count pallas", "count xla", "2d"):
        require(scalars(out[label]) == want + (0, 0),
                f"{label}: {scalars(out[label])}, exact core {want}")
    m, c, key, rp, sp, ovf = out["materialize"]
    require(scalars((m, c, ovf)) == want + (0,),
            f"materialize: {scalars((m, c, ovf))}, exact core {want}")
    require(all(torch.equal(a, b) for a, b in zip(live_rows(key, rp, sp),
                                                  exact_rows)),
            "materialize: the live rows differ from the exact core's")
    require(scalars(out["ring"]) == want, f"ring: {scalars(out['ring'])}")
    require(scalars(out["skew z=1.5"]) == want_z + (0,),
            f"skew z=1.5: {scalars(out['skew z=1.5'])}, exact core "
            f"{want_z}")
    tiers = {}
    for label, w in (("auto", want), ("auto z=1.5", want_z)):
        m, c, tiers[label] = out[label]
        require((m, c) == w, f"{label}: {(m, c)}, exact core {w}")
    eight = scalars(out[f"{SHARDS}-shard layout"])
    require(eight == want + (0,), f"the {SHARDS}-shard layout's sum "
            f"{eight} != the one-rank answer {want}")
    return tiers


def parallel_held(forms) -> dict:
    """The kernel forms once more with every launch held to its plain
    version on the inputs the path gives it (held_to_plain); every launch
    of the pass a held one."""
    held = {}
    reset_launches()
    t0 = time.perf_counter()
    with held_to_plain(held):
        for label in KERNEL_FORMS:
            forms[label]()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    rose = {k: v for k, v in read_launches().items() if v}
    require(rose == {k: v["launches"] for k, v in held.items()},
            f"a launch escaped the plain check: launched {rose}, held "
            f"{ {k: v['launches'] for k, v in held.items()} }")
    require(all(held.get(k, {}).get("launches") for k in ("K1", "K2", "K3")),
            f"K1, K2 or K3 not held: {held}")
    say(f"phase 17 held to the plain versions in {secs:.2f} s: "
        + "; ".join(f"{k} {v['launches']} launches on {len(v['inputs'])} "
                    f"input shapes, max_abs_err {v['max_abs_err']}"
                    for k, v in held.items()))
    return held


def weak_scaling_run(card) -> dict:
    """experiments/weak_scaling at its full size a rank with one rank, in a
    process of its own: every row's matches = |S|."""
    from aqp_tpu_torch.experiments import weak_scaling

    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "aqp_tpu_torch.experiments.weak_scaling",
         *WEAK_SCALING_ARGV], capture_output=True, text=True,
        timeout=WEAK_SCALING_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    require(run.returncode == 0, f"weak_scaling exited {run.returncode}: "
            f"{run.stderr[-3000:]}")
    rows = [line.split() for line in run.stdout.splitlines()
            if "matches=" in line]
    want = [(mode, ns) for mode, _, _, ns in weak_scaling.configs(
        "--small" in WEAK_SCALING_ARGV, 1) for _ in weak_scaling.ENGINES]
    require(len(rows) == len(want), f"weak_scaling printed {len(rows)} "
            f"rows, not {len(want)}: {run.stdout[-2000:]}")
    out = {}
    for r, (mode, ns) in zip(rows, want):
        matches = int(r[-1].split("=")[1])
        require(r[0] == mode and matches == ns, f"weak_scaling {r}: "
                f"{matches} matches, |S| = {ns}")
        out[f"{r[0]} {r[2]}"] = float(r[3])
    say(f"phase 17 weak_scaling ({' '.join(WEAK_SCALING_ARGV)}) in "
        f"{secs:.2f} s, best of 3 on the host clock ({card}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in out.items()))
    return {"s": secs, "ms": out}


def dist_forms_run(card, want, want_z) -> dict:
    """experiments/dist_forms at full width with one rank, in a process of
    its own: rc 0, every form of the strong run printed with the exact
    core's answer on phase 17's relations (the same seeds), overflow 0,
    the pad-key and int64 cases, K1, K2 and K3 launched on its main path
    (recorded as this phase's "17 dist_forms" launches) and held to their
    plain versions.  Returns the forms' rows, keyed by form, and the
    summary."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "aqp_tpu_torch.experiments.dist_forms",
         *DIST_FORMS_ARGV], capture_output=True, text=True,
        timeout=DIST_FORMS_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    require(run.returncode == 0, f"dist_forms exited {run.returncode}: "
            f"{run.stderr[-3000:]}")
    lines = [json.loads(line) for line in run.stdout.splitlines()
             if line.startswith('{"dist_form')]
    rows = {r["dist_form"]["form"]: r["dist_form"] for r in lines
            if "dist_form" in r}
    summary = next((r["dist_forms"] for r in lines if "dist_forms" in r),
                   None)
    require(summary is not None, f"dist_forms printed no summary: "
            f"{run.stdout[-2000:]}")
    strong = ("count pallas", "count xla", "2d pallas", "2d xla",
              "materialize", "ring", "skew z=1.5", "auto", "auto z=1.5")
    cases = [f"{c} {f}" for c in ("pad keys", "int64")
             for f in ("pallas", "2d pallas", "auto")]
    require(set(rows) == set(strong + tuple(cases)), f"dist_forms printed "
            f"the forms {sorted(rows)}")
    for label in strong:
        r = rows[label]
        w = want_z if "z=1.5" in label else want
        require((r["matches"], r["checksum"], r["overflow"]) == w + (0,)
                and (r["nr"], r["ns"]) == (NR, NS) and r["ms"] > 0,
                f"dist_forms {label}: {r}, phase 17's exact core {w}")
    launches = dict(zip(summary["kernels"], summary["launches"][0]))
    held = dict(zip(summary["kernels"], summary["held"][0]))
    errs = dict(zip(summary["kernels"], summary["max_abs_err"][0]))
    require(all(launches.values()) and all(held.values())
            and not any(errs.values()), f"dist_forms: launches {launches}, "
            f"held {held}, max_abs_err {errs}")
    MAIN_PATH["17 dist_forms"] = {**{k: 0 for k in read_launches()},
                                  **launches}
    say(f"phase 17 dist_forms ({' '.join(DIST_FORMS_ARGV)}) in {secs:.2f} "
        f"s, every form equal to the exact core, tiers "
        f"{ {k: r['tier'] for k, r in rows.items() if r['tier']} }; "
        f"launches {launches}, held {held} (max_abs_err 0), peak "
        f"{summary['peak_bytes'][0][0]} bytes ({card}): "
        + ", ".join(f"{k} {r['ms']:.3f} ms" for k, r in rows.items()
                    if "ms" in r))
    say(f"phase 17 dist_forms count pallas's steps: {summary['steps']}")
    return {"s": secs, "rows": rows, "summary": summary}


def parallel_steps(relR, relS, mesh, card) -> dict:
    """ms of the "pallas" count join's steps at world size 1: each side's
    pack (_pack_send_buffers) and whole shuffle (pack, all_reduce of the
    overflow, all_to_all), and the shard-local count on the receive
    buffers."""
    group = mesh.get_group("shard")
    caps = [pdj._capacity(rel.num_tuples, 1, 2.0) for rel in (relR, relS)]
    pads = (pshuffle.PAD_R, pshuffle.PAD_S)
    recv = [pshuffle.shuffle_relation(rel.key, rel.payload, group, cap, pad)
            for rel, cap, pad in zip((relR, relS), caps, pads)]
    ms = {}
    for side, rel, cap, pad in zip("RS", (relR, relS), caps, pads):
        ms[f"pack {side}"] = cuda_ms(lambda: pshuffle._pack_send_buffers(
            rel.key, rel.payload, 1, cap, pad, 0), REPS)
        ms[f"shuffle {side}"] = cuda_ms(lambda: pshuffle.shuffle_relation(
            rel.key, rel.payload, group, cap, pad), REPS)
    ms["local count (pallas)"] = cuda_ms(lambda: pdj._local_count(
        recv[0][0], recv[0][1], recv[1][0], recv[1][1], "pallas"), REPS)
    say(f"phase 17 count pallas's steps ({card}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    return ms


def pad_key_checks(mesh, mesh2) -> dict:
    """Real keys equal to rho3's input pads through "pallas" (overflow
    reported, never a short count) and auto (the truth, tier
    "hash+salt"); int64 relations through "pallas", the 2-D join and auto
    (the truth, no kernel launched).  The truth is the exact core's."""
    out = {}
    for wide in (False, True):
        r, s = dist_forms.pad_key_relations(wide, DEV)
        ex = mergejoin.merge_join_count(r.key, r.payload, s.key, s.payload)
        want = (int(ex.matches), int(ex.checksum))
        require(want[0] == 905, f"the pad-key relations hold {want[0]} "
                "matches, not 905")
        R, S = shard_relation(r, mesh), shard_relation(s, mesh)
        R2, S2 = shard_relation(r, mesh2), shard_relation(s, mesh2)
        reset_launches()
        one = pdj.make_dist_join_count(mesh, R.num_tuples, S.num_tuples,
                                       engine="pallas")
        two = pdj.make_dist_join_count_2d(mesh2, R2.num_tuples,
                                          S2.num_tuples, engine="pallas")
        got = {"pallas": tuple(map(int, one(R.key, R.payload, S.key,
                                            S.payload))),
               "2d pallas": tuple(map(int, two(R2.key, R2.payload, S2.key,
                                               S2.payload))),
               "auto": pdj.dist_join_count_auto(r, s, mesh)}
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        label = "int64" if wide else "pad keys"
        if wide:
            require(not launches, f"int64 relations launched {launches}")
            require(got["pallas"] == got["2d pallas"] == want + (0, 0)
                    and got["auto"] == want + ("hash",),
                    f"{label}: {got}, the exact core {want}")
        else:
            require(all(got[k][2] > 0 and got[k][3] == 0
                        for k in ("pallas", "2d pallas")),
                    f"{label}: the overflow is not reported: {got}")
            require(got["auto"] == want + ("hash+salt",),
                    f"{label}: auto {got['auto']}, the exact core {want}")
        out[label] = {"want": want, "got": got, "launches": launches}
        say(f"phase 17 {label}: {got}, the exact core {want}, launches "
            f"{launches}")
    return out


def parallel_phase(card) -> dict:
    """Phase 17: the distributed layer at world size 1 under NCCL on
    phase 4's relations (phase 8's z = 1.5 S for the skew forms), each
    form equal to the exact core and RHO; K1, K2 and K3 on its main path
    and held to their plain versions; the 8-shard layout on the card;
    the forms timed; weak_scaling and dist_forms with one rank, each in
    a process of its own.  Returns the parallel line."""
    faulthandler.dump_traceback_later(PARALLEL_WATCHDOG_S, exit=True)
    t0 = time.perf_counter()
    world = bringup.initialize_distributed(
        f"127.0.0.1:{bringup.free_port()}", 1, 0)
    backend = torch.distributed.get_backend()
    mesh, mesh2 = make_mesh(device=DEV), make_mesh_2d(1, 1, device=DEV)
    relR, relS = seeded(NR, NS, seed=11111)
    zs = create_relation_zipf(NS, NR, 1.5, seed=22222, random_payload=True,
                              device=DEV)
    say(f"phase 17: world {world}, backend {backend}, meshes "
        f"{mesh.mesh_dim_names} {tuple(mesh.shape)} and "
        f"{mesh2.mesh_dim_names} {tuple(mesh2.shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    exact = mergejoin.merge_join_count(relR.key, relR.payload, relS.key,
                                       relS.payload)
    exact_z = mergejoin.merge_join_count(relR.key, relR.payload, zs.key,
                                         zs.payload)
    want = (int(exact.matches), int(exact.checksum))
    want_z = (int(exact_z.matches), int(exact_z.checksum))
    rho = run_join(relR, relS, "RHO", JoinConfig(), device=DEV)[0]
    require((int(rho.matches), int(rho.checksum)) == want and want[0] == NS,
            f"run_join RHO {int(rho.matches), int(rho.checksum)} != the "
            f"exact core {want}")
    mat = mergejoin.merge_join_materialize(relR.key, relR.payload, relS.key,
                                           relS.payload, NS)
    exact_rows = live_rows(mat.key, mat.r_payload, mat.s_payload)
    del mat
    check_block_on_the_cpu(relS)
    forms = parallel_forms(relR, relS, zs, mesh, mesh2)
    torch.cuda.synchronize()
    reset_launches()
    out = {label: fn() for label, fn in forms.items()}
    torch.cuda.synchronize()
    launches = {k: v for k, v in main_path_launches("17 parallel").items()
                if v}
    require(all(launches.get(k) for k in ("K1", "K2", "K3")),
            f"K1, K2 or K3 not launched on the parallel path: {launches}")
    tiers = check_parallel(out, want, want_z, exact_rows)
    del out, exact_rows
    torch.cuda.empty_cache()
    say(f"phase 17: every form equals the exact core (matches {want[0]}, "
        f"checksum {want[1]}; z = 1.5: {want_z}), overflow 0; tiers "
        f"{tiers}; the {SHARDS}-shard layout's sum equals the one-rank "
        f"answer; main-path launches {launches}")
    held = parallel_held(forms)
    pad_keys = pad_key_checks(mesh, mesh2)
    ms = {}
    for label, fn in forms.items():
        ms[label] = cuda_ms(fn, REPS)
        say(f"phase 17 {label}: {ms[label]:.3f} ms/call ({card})")
    steps = parallel_steps(relR, relS, mesh, card)
    for label, cfg in (("run_join RHO keys-only", JoinConfig(checksum=False)),
                       ("run_join RHO checksummed", JoinConfig())):
        ms[label] = cuda_ms(lambda: run_join(relR, relS, "RHO", cfg,
                                                 device=DEV), REPS)
        say(f"phase 17 {label}: {ms[label]:.3f} ms/call ({card})")
    del forms, relR, relS, zs
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    weak = weak_scaling_run(card)
    forms_run = dist_forms_run(card, want, want_z)
    return {"parallel": {"card": card, "world": world, "backend": backend,
                         "want": want, "want_z": want_z, "tiers": tiers,
                         "launches": launches, "ms": ms, "steps": steps,
                         "pad_keys": pad_keys,
                         "held": {k: {"launches": v["launches"],
                                      "max_abs_err": v["max_abs_err"]}
                                  for k, v in held.items()},
                         "weak_scaling": weak,
                         "dist_forms": {
                             "s": forms_run["s"],
                             "ms": {k: r["ms"] for k, r in
                                    forms_run["rows"].items() if "ms" in r},
                             "tiers": {k: r["tier"] for k, r in
                                       forms_run["rows"].items()
                                       if r["tier"]},
                             "launches": forms_run["summary"]["launches"],
                             "peak_bytes":
                                 forms_run["summary"]["peak_bytes"]}}}


# ---------------------------------------------------------------------------
# Phase 18: the six drivers at their full default sizes

DRIVERS_WATCHDOG_S = 600             # the phase's own watchdog
DRIVER_TPCH_SCALE = 1.0              # tpch_bench's default scale factor
DRIVER_NAMES = ("rho_phases", "roofline", "scan_bench", "aggregate_bench",
                "tpch_bench", "cracking")
# the held pass repeats each timed call less often: the same inputs and
# shapes as the main path's, fewer identical calls
DRIVER_HELD_ARGV = {"scan_bench": ["--reps", "1"],
                    "aggregate_bench": ["--reps", "1"],
                    "tpch_bench": ["--reps", "1"],
                    "cracking": ["--queries", "2"]}


def driver_modules() -> dict:
    import importlib

    return {name: importlib.import_module(
        f"aqp_tpu_torch.experiments.{name}") for name in DRIVER_NAMES}


def run_driver(name, mod, argv) -> tuple:
    """mod.main(argv) with its output captured (its last lines printed if
    it raises, then the error goes on); returns (its result, seconds,
    output lines)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            out = mod.main(argv)
        torch.cuda.synchronize()
    except BaseException:
        print("\n".join(buf.getvalue().splitlines()[-40:]), flush=True)
        raise
    return out, time.perf_counter() - t0, buf.getvalue().splitlines()


def driver_rows(name, res) -> int:
    """The rows a driver's result holds (the roofline: its table rows)."""
    if name == "roofline":
        return len(res["stages"]) + len(res["kernels"])
    if name == "scan_bench":
        return sum(map(len, res.values()))
    return len(res)


def exact_fk_matches(nr, ns, seeds) -> int:
    """The exact core's matches on the drivers' PK / FK relations."""
    r = create_relation_pk(nr, seed=seeds[0], device=DEV)
    s = create_relation_fk(ns, nr, seed=seeds[1], device=DEV)
    got = int(mergejoin.merge_join_count_keys(r.key, s.key).matches)
    del r, s
    torch.cuda.empty_cache()
    return got


def check_scan_rows(mod, fams) -> int:
    """Every count and sum row's answer (the timed calls' last) equals the
    plain version's on the driver's own column; returns the rows held."""
    want = {}
    rows = [r for fam in fams.values() for r in fam
            if r[1] in ("count", "sum")]
    for n in sorted({r[3] for r in rows}):
        col = mod.make_col(n, DEV)
        for r in rows:
            if r[3] == n:
                lo, hi = mod.sel_bounds(r[4])
                plain = kscan.count_plain if r[1] == "count" else \
                    kscan.sum_plain
                want[id(r)] = int(plain(col, lo, hi))
        del col
        torch.cuda.empty_cache()
    for r in rows:
        require(r[9] == want[id(r)], f"scan_bench {r[:6]}: {r[9]}, the "
                f"plain version {want[id(r)]}")
    return len(rows)


def check_drivers(mods, out, store) -> dict:
    """Each driver's answers: RHO's, every cracking variant's, the
    roofline's and rho_phases' fused count equal to the exact core's on
    their relations; each TPC-H query's staged and fused matches equal to
    each other and to tpch_oracle on the store's tables; every aggregate
    row within its capacity; every scan count and sum equal to the plain
    version's.  Returns a summary."""
    rp, rf, sc, ag, tp, cr = (out[k][0] for k in DRIVER_NAMES)
    m = mods["rho_phases"]
    want = exact_fk_matches(*m.SIZES[False], m.SEEDS)
    got = {r[4] for r in rp if r[4] is not None}
    require(got == {want}, f"rho_phases: matches {got}, exact core {want}")
    m = mods["roofline"]
    want_rf = exact_fk_matches(*m.SIZES[False], m.SEEDS)
    require(rf["matches"] == want_rf, f"roofline: {rf['matches']} matches, "
            f"exact core {want_rf}")
    m = mods["cracking"]
    want_cr = exact_fk_matches(*m.SIZES[False], m.SEEDS)
    got = {(r[0], r[4]) for r in cr}
    require(got == {(v, want_cr) for v in m.VARIANTS},
            f"cracking: {got}, exact core {want_cr}")
    for r in ag:
        cap = mods["aggregate_bench"].capacity(r[1])
        require(r[2] <= cap, f"aggregate_bench {r}: live groups past {cap}")
    base = tpch_dbgen.ensure_generated(DRIVER_TPCH_SCALE, root=store)
    tables = tuple(getattr(tpch_loader, f"load_{t}")(base, device=DEV)
                   for t in TPCH_NAMES)
    oracle = {q: tpch_oracle(q, *tables) for q in TPCH_PLANS}
    del tables
    torch.cuda.empty_cache()
    for q, w in oracle.items():
        got = {(r[2], r[6]) for r in tp if r[0] == q}
        require(got == {("staged", w), ("fused", w)}, f"tpch_bench {q}: "
                f"{got}, the oracle {w}")
    held = check_scan_rows(mods["scan_bench"], sc)
    return {"rho_exact": want, "roofline_exact": want_rf,
            "cracking_exact": want_cr, "tpch_oracle": oracle,
            "scan_rows_held": held,
            "aggregate_engines": {r[1]: r[3] for r in ag}}


def drivers_held(mods, argvs, launched) -> dict:
    """The six drivers once more, timed calls repeated less
    (DRIVER_HELD_ARGV), with every kernel launch held to its plain version
    on the inputs the driver gives it (held_to_plain); every launch of the
    pass a held one, every kernel of the main path held."""
    held = {}
    reset_launches()
    t0 = time.perf_counter()
    with held_to_plain(held):
        for name, mod in mods.items():
            run_driver(name, mod, argvs[name] + DRIVER_HELD_ARGV.get(name,
                                                                      []))
            torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    rose = {k: v for k, v in read_launches().items() if v}
    require(rose == {k: v["launches"] for k, v in held.items()},
            f"a launch escaped the plain check: launched {rose}, held "
            f"{ {k: v['launches'] for k, v in held.items()} }")
    missing = sorted(set(launched) - set(held))
    require(not missing, f"the drivers launched {missing}, never held")
    say(f"phase 18 drivers held to the plain versions in {secs:.2f} s: "
        + "; ".join(f"{k} {v['launches']} launches on {len(v['inputs'])} "
                    f"input shapes, max_abs_err {v['max_abs_err']}"
                    for k, v in held.items()))
    return {"s": secs, **{k: {"launches": v["launches"],
                              "max_abs_err": v["max_abs_err"]}
                          for k, v in held.items()}}


def driver_summary(name, res, lines) -> dict:
    """What a driver measured, in a few numbers for the drivers line."""
    if name == "roofline":
        return {"stages": res["stages"], "kernels": res["kernels"],
                "checksummed_s": res["checksummed_s"],
                "table": [ln for ln in lines if ln.startswith("|")]}
    if name == "scan_bench":
        return {fam: {f"{r[1]} {r[2]} n={r[3]} sel={r[4]} {r[5]}": r[6]
                      for r in rows} for fam, rows in res.items()}
    if name == "rho_phases":
        return [r[:4] for r in res]
    return [list(r[:8]) for r in res]


def drivers_phase(card, store) -> dict:
    """Phase 18: rho_phases, roofline, scan_bench, aggregate_bench,
    tpch_bench (SF 1, its dbgen store under `store`) and cracking, each
    main in this process at its full default size on the card, as one main
    path; their answers checked (check_drivers); then the drivers again
    with every launch held to its plain version.  Returns the drivers
    line."""
    faulthandler.dump_traceback_later(DRIVERS_WATCHDOG_S, exit=True)
    mods = driver_modules()
    argvs = {name: ["--device", DEV] for name in DRIVER_NAMES}
    argvs["tpch_bench"] += ["--store", store, "--scale",
                            str(DRIVER_TPCH_SCALE)]
    out = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_launches()
    for name, mod in mods.items():
        out[name] = run_driver(name, mod, argvs[name])
        say(f"phase 18 driver {name}: {driver_rows(name, out[name][0])} "
            f"rows in {out[name][1]:.2f} s ({card})")
        torch.cuda.empty_cache()
    launched = {k: v for k, v in main_path_launches("18 drivers").items()
                if v}
    say(f"phase 18 drivers' launches: {launched}")
    for k in ("K1", "K2", "K3", "scan_count", "scan_sum", "scan_bitvector",
              "K3AGG", "compact_windows_index"):
        require(launched.get(k), f"{k} was not launched by the drivers")
    checks = check_drivers(mods, out, store)
    say(f"phase 18 answers: {json.dumps(checks)}")
    for line in out["roofline"][2]:
        if line.startswith(("|", "Card", "Checksummed")):
            say(f"phase 18 roofline {line}")
    held = drivers_held(mods, argvs, launched)
    return {"drivers": {
        "card": card, "launches": launched, "checks": checks, "held": held,
        **{name: {"s": secs, "rows": driver_rows(name, res),
                  "measured": driver_summary(name, res, lines)}
           for name, (res, secs, lines) in out.items()}}}


if __name__ == "__main__":
    sys.exit(main())
