"""Chip smoke test of the PyTorch/CUDA port (`raft_tpu_torch`) on one GPU.

    python3 chip_smoke.py              # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse   # tiny geometry on the CPU: checks the
                                       # control flow, prints no result, exits 3
    python3 chip_smoke.py --checks     # on the card: phases 1-3 only (build,
                                       # ptxas lines, adversarial checks); exits 4
    python3 chip_smoke.py --graph      # the build and the graph path only (phase
                                       # 4d and its kernel rows); exits 5
    python3 chip_smoke.py --primitives # the build and the primitives path only
                                       # (phase 4e and its kernel rows); exits 6
    python3 chip_smoke.py --obs        # the build and the observability path only
                                       # (phase 4f on indexes it builds); exits 7
    python3 chip_smoke.py --comms      # the build and the comms path only (phase
                                       # 4g and its kernel rows); exits 8
    python3 chip_smoke.py --mnmg-ivf   # the build and the distributed IVF path only
                                       # (phase 4h and its kernel rows); exits 9
    python3 chip_smoke.py --serve      # the build and the serving path only (phase
                                       # 4i on indexes it builds); exits 10
    python3 chip_smoke.py --jobs       # the build and the jobs path only (phase 4j
                                       # on its own data and truth); exits 11
    python3 chip_smoke.py --parent DIR # as the first, and times the kernels of
                                       # DIR/raft_tpu_torch/csrc (an earlier
                                       # commit's) beside this one's in turns on
                                       # the phase-5 rows of kernels 1, 3, 4, 7
    python3 chip_smoke.py --apply      # as the first, and writes the tuned A/B
                                       # winners and the adaptive policy as
                                       # raft_tpu_torch/tuned_defaults.json

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel under raft_tpu_torch/csrc/ (one nvcc per source,
     all started together), with ptxas's register and spill lines;
  3. each kernel against its plain PyTorch version at small adversarial
     shapes (ties, int8 values at +-127, ragged edges, +inf slots and
     tiles, dead rows, empty chunks, k past the finite slots, odd fold
     counts), and the int8 exact trim's values among the int8 bin fold's
     candidates; the bin fold's stop at a list's last real slot and its
     fill of the unscanned folds by rule (the lists of the list kernels'
     stop below; both folds, L2 and IP, int8 rows by TMA and byte by
     byte, f32 rows on int8, bf16 and f32 stores at rot 33, 96 and 128, L
     384, 640 and 3840, live-row prefixes; bit for bit, gaussian rows by
     fold_compare); the
     pairwise kernel for every metric (ragged m, n, k, k = 1, KL zeros,
     canberra zero denominators, integer grids bitwise), canberra and KL
     on denormals, 1e-30, huge values, the fast paths' range edges,
     magnitudes from 1e-44 to 1e30, KL ratios past the f32 range, and rows
     equal to rows of the other side (exactly 0), the fused L2 argmin
     (k 1 to 400, n 1 to 1024, m ragged against its
     row blocks, duplicate rows and centres, blob rows and the same
     shifted by +100, candidates that round below zero, sqrt) and the
     counting select (ties, +-0, +-inf, NaN,
     k = 1 to L, rows of 128 to 1,048,576, descending and all-equal rows,
     k on both sides of its variant switch, B 1); the flat fused top-k's
     tensor-core variant (m 1, 127, 129; n below k and ragged against
     its tiles and n ranges; k 1 to 256; L2 and inner product; integer
     grids with duplicate rows across the n ranges, ids exact; a
     prefilter's +inf base columns through its `valid` operand: density 1
     and 0.5, k - 1 survivors, none, survivors only in its last n range,
     +inf and id -1 past the survivors); the
     RaBitQ bit-plane scan bit
     for bit (1, 4 and 8 query bits, 1 to 4 words, duplicate codes, +inf
     tails and tiles, empty chunks and live-row prefixes, k 1 to 256 and
     past the finite slots, L 128 to 3840, L2 and inner product), its
     integer scores S_u recovered exactly from a case whose estimator is
     an exact map of them, half its real slots filtered (+inf between real
     ones) at k 10 and 40, k 32 and 33 (either side of its selection
     switch) and 129 to 256 at L 4992, scores that fall with the slot and
     all-equal scores, and at the widest rotations its shared memory
     admits at 8 query bits (389 / 373 / 341 code words at k 40 / 100 /
     250); the list kernels' stop at a list's last real slot on lists of
     0, 1, 5, 63, 64, 65, 127 and 129 real slots, real slots in the last
     tile only, tombstone runs before the end (whole +inf tiles between
     real ones, a run across a tile boundary, the first tile +inf),
     lengths up to L, at k 10,
     32, 33, 40, 128 and 256, L2 and inner product, fused_list_topk on
     int8, bf16 and f32 stores (integer grids, ids exact) and
     fused_list_topk_int8 with and without its TMA staging (bit for bit);
     and the same lists with half their real slots filtered at k 10 and
     40 (L 640 and 3840, IVF-Flat's bf16 store);
  4. the main path at full size: 1M x 96 clustered vectors (1024 blob
     centers U(-5, 5) plus unit gaussian noise, made from --seed), IVF-PQ
     build (n_lists 1024, pq_dim 48, kmeans_n_iters 10), exact truth with
     brute_force.knn(engine="fused") for 4096 queries at k = 10, then the
     refined ladder of the fused bf16 trim (n_probes 8/16/32/64, a 4k
     shortlist, refine(strategy="fused")) with ten profiled n_probes-8
     batches, then the same at n_probes 8/16 for three more engines: trim
     "fused" on int8 rows, trim "pallas" (the bin fold) on bf16 and on
     int8 rows, with ten profiled n_probes-8 batches of the pallas bf16
     engine (its device time op by op). Gate: recall@10 >= 0.95 on some
     rung of every engine. Each engine is a path of its own: the launch
     counts are set to 0 just
     before it and read just after (the first path's window holds the
     truth too), and each kernel of the path must have launched. A timed
     A/B of the fused bf16 engine at n_probes 8 with select_k's earlier
     float sort and its repaired order-key sort. Then four more paths on
     the same data (slice_paths): the tiled L1 k-NN over every row, the
     exact fused L2 k-NN (QPS over windows, ids equal to the truth), the
     counting select on the first L1 distance tile, and the fused L2 1-NN
     labelling of the rotated rows against the index's coarse centres.
     Then the IVF-RaBitQ path on the same data and truth (rabitq_path):
     build (n_lists 1024, kmeans_n_iters 10; rot_dim 96, 3 words, 8
     query bits), the ladder of bench/bench_ivf_rabitq.py (n_probes
     8/16/32/64 x rerank_mult 4/8/16/25, up to the first rung at recall@10
     >= 0.95) with scan_engine="fused" and the exact rerank, QPS over
     windows; once at n_probes 8, rerank_mult 4, the "xla" engine against
     the fused one on the estimator-ranked candidates. Then IVF-Flat on
     the same data and truth (ivf_flat_path): build (n_lists 1024,
     kmeans_n_iters 10), the engines "fused" (kernel 1 over the bf16
     residual store), "list", "query" and "auto" over n_probes 8/16/32 up
     to the first rung at recall@10 >= 0.95 and always 32, QPS over
     windows (the "query" engine one window of three batches), one
     profiled n_probes-32 batch of the fused engine. Then the filtered
     searches (prefilter_path): one seeded bitset keeping half the ids;
     brute_force.knn(engine="fused") with it is the filtered truth
     (against the tiled engine on 16 queries); IVF-Flat fused, IVF-PQ
     fused bf16 + refine and IVF-RaBitQ fused at the rungs where each
     cleared unfiltered (one rung up where short): every id passes the
     filter, recall@10 >= 0.95 against the filtered truth. Then IVF-PQ's
     other modes and builds (pq_modes_path): the default-params ladder
     SearchParams(n_probes=p) (recon8_list with the "approx" trim at nq
     4096) with the "exact" trim, bf16 distances and "recon8" at its gate
     rung; 128 queries at n_probes 20 (the default resolves to "lut"):
     lut f32 and bf16, recon8, the fused trim; per-cluster codebooks on
     the fused bf16, fused int8 and pallas ladders and lut; an index of
     4096 lists (kmeans_balanced.fit_hierarchical) on the fused ladder;
     Lloyd kmeans.fit (1024 clusters, 20 iterations, k-means++) beside
     kmeans_balanced.fit's cost. Then live mutation and persistence
     (mutation_path) on the three 1M-row indexes, each at its gate rung:
     delete 10% of the ids, upsert 5%, insert 5%; recall@10 against the
     live truth (kernel 2 with the deleted ids invalid), no deleted id,
     delete equal to the exclusion prefilter bit for bit, compact, save
     and load on the card bit for bit, and a Mutator over IVF-Flat with
     its cold resume bit for bit. Then the integrity of the live index
     and the fault sites (integrity_path) on the three 1M-row indexes:
     digest compute GB/s, the build's attach, an upsert with and without
     its digest refresh, save / load with the sidecar and check_fresh;
     the lane pad's extended digests after IVF-Flat's fused search (a
     clean full_scan); a seeded rot of each payload field found by
     8-list slices; quarantine equal to delete bit for bit; point-in-time
     restores byte for byte (Mutator retain 3) and the fallback past a
     rotted snapshot; the watchdog's quarantine and checkpoint repair;
     the hooks inert, fused.scan.scores NaN and ivf.probe_budget drills;
     a mutation.log.commit SIGKILL drill in a child process; refine_host
     over the dataset as host numpy. Phases 4 and 5 run under an empty tuned
     table: the JAX package's untuned program, each engine by name;
  4b. the tuned table (tuned_path): every tuned key the port reads, A/B
     of the untuned resolution against each candidate by name, with
     recall@10, each key on top of the winners before it (the cells in
     tuned_path's docstring); with --apply the winners are written as
     raft_tpu_torch/tuned_defaults.json. Then the committed table, read
     afresh (a file that does not load fails): each promotion's default
     call launches its kernel, clears the gate and returns the ids of the
     explicit engine it resolved to (order within equal values aside);
     the default IVF-PQ batch's QPS at nq 4096 and 128 and its profile;
  4c. adaptive probing: the adaptive_probe_policy calibration
     (calibrate_policy: bench/bench_adaptive_probes.py's procedure and
     data, overlapping blobs; a ladder that reads one recall at every tau
     gives no policy; with --apply a policy is committed), then
     (adaptive_path) at n_probes 32 on IVF-PQ fused bf16 + refine,
     IVF-Flat fused and IVF-RaBitQ fused the recall_target ladder 0.90 /
     0.95 / 0.99 / 1.0 and budget_tau rungs, with and without early
     termination: recall@10, lists a query, ms a batch; recall_target 1.0
     equal to the fixed search bit for bit; every masked rung's ids in the
     lists its mask kept, and its search equal to the same search through
     the kernels' plain versions (256 queries);
  4d. the graph path (graph_path), under the committed table: the port's
     own make_blobs (seed --seed) of 262,144 x 96 rows in 64 blobs,
     single_linkage(n_clusters=64, connectivity="knn", n_neighbors=15)
     with its stage times (k-NN graph, symmetrize, MST, each repair pass
     with its component count, dendrogram, cut; gates: ARI >= 0.99, n - 1
     merges, nondecreasing deltas, the MST's weight equal to scipy's on
     the final edge set in float64) and again with metric="l1" over the
     first 65,536 rows; the masked L2 NN of 65,536 noisy rows against all
     of them (64 random groups, a random 50% adjacency; 64 rows against
     float64); bench/bench_sparse.py's sparse pairwise distances
     (sqeuclidean, l1, canberra, cosine) equal to the dense call, sparse
     k-NN against dense brute_force.knn and the 1M-column compact case
     against float64; spectral.partition(n_clusters=8) over a k-NN graph
     of 262,144 x 32 rows in 8 blobs made connected by
     connect_components, the JAX program's fixed Lanczos reported and
     `tol=1e-3` gated (Ritz residuals <= 1e-2 by spmv, two runs bit for
     bit); the Borůvka forest of rmat(16, 16, 2^20) against scipy's; the
     LAP auction at 2048 (a permutation within 1.02 of scipy). The host
     library (raft_tpu_torch/native) must load; kernel 6 must launch in
     the k-NN graphs and the sparse k-NN, kernel 8 in the L1 graph and
     the sparse metrics;
  4e. the rest of the single-device primitives (primitives_path), under the
     committed table: two .fbin files written to a temporary directory,
     2^20 (lat, lon) points (64 gaussian cities, 10% uniform background)
     read through io.FileBatchLoader's C++ ring reader (it must load) and
     2^20 3-D points in a centred unit cube through BatchLoadIterator,
     equal byte for byte; ball_cover on the (lat, lon) rows (haversine, L
     1024, all_knn_query k 16; 4,096 rows against brute_force.knn's exact
     haversine: distances within 1e-5 at each rank, ids equal outside
     ties) and on the 3-D rows (sqeuclidean, 65,536 queries at k 16,
     tie-aware recall 1.0 against float64; eps_nn_query of 2,048 of them
     at a mean degree near 32, the adjacency equal to float64 but within
     1e-3 of eps); on the graph path's 262,144 x 96 blobs (8 clusters)
     the silhouette of the true labels, ARI and v-measure of a Lloyd fit,
     the RBF gram of 4,096 rows against all, a 2-D PCA (mean_center,
     rsvd) of 32,768 rows and its trustworthiness (k 5), each against its
     float64 twin on the card (scores 1e-4 absolute, gram 1e-5 relative);
     an IVF-Flat index (512 lists) streamed from host memory in 8
     extend_batched batches answering as the one-shot build at n_probes
     512; interruptible.cancel ending a synchronize on a sleep kernel.
     Kernel 6 must launch in both ball covers, kernel 8 in the 3-D one;
  4f. the observability layer (obs_path) on phase 4's indexes and data:
     obs off, in turns with on, the default and fused IVF-PQ batches
     record nothing and cost what they cost with obs on; obs enabled, every fenced call of the main path (IVF-PQ
     default, fused bf16 / int8 and pallas searches, each refine, the
     exact fused k-NN, IVF-Flat fused, RaBitQ at its gate rung) answers
     bit for bit as with obs disabled, its spans charge their analytic
     cost and no MFU against the "h100" row reads above 1.05; kernels 1,
     2, 3, 4, 6 and 7 launch; the adaptive, mutation and scrub counters
     equal the operations; the report renders in a subprocess, the
     Prometheus buckets are monotone, a trace_session's Chrome trace
     names kernels 1 and 2; a child SIGKILLed at a crash_point leaves its
     flight dump, and a child that indexes a CUDA tensor out of range
     sees `is_device_fault` errors on that op and the next;
  4g. the comms layer (comms_path), under the committed table: on
     bench/bench_mnmg.py's rows cut to 5M x 96 (1,024 blobs, made on the card
     from --seed) and 4,096 queries, `comms.mnmg.knn` (k 10) on
     in-process worlds of 1 and 4 ranks of the card (s a call, QPS,
     kernel 6's launches, one profiled call each), world 4 against world
     1, the single-device tiled scan and float64 (16 queries); on 4 ranks
     the sharded / auto query modes and the tournament merge, the int8 /
     bf16 merges' recall, a 50% prefilter, bf16 operands, a rank marked
     down (the survivors' merge) and replication 2 (the healthy answer
     bit for bit); `mnmg.kmeans_fit` (1,024 clusters, 10 iterations) at
     both worlds from the same init (equal centres, s an iteration, one
     profiled iteration each) and the predict labels; every collective on
     4 ranks at bench/bench_comms.py's (64, 256) block against its
     one-tensor reference and the health barrier; the process worlds as
     children under a deadline (NCCL at world 1 on the card, 1M rows, and
     gloo at world 2 on the CPU, each bit for bit its in-process world; the
     children also run 4h's IVF-PQ lifecycle);
  4h. the distributed IVF drivers (mnmg_ivf_path), under the committed
     table, on 4g's data, queries and exact truth, 4 ranks of the card:
     IVF-PQ (1,024 lists, pq_dim 48) "recon8_list", "lut" (64 queries),
     the bin, fused bf16 and fused int8 trims at n_probes 32 and the
     refined pipeline at 8
     (gate recall@10 >= 0.95), seconds a call, QPS, recall and the kernels
     each launches (6 / 4 / 1 / 3), padded and real bytes of every store;
     its sharded checkpoint, the fold-merge load onto one rank answering
     as four (GB/s both ways), extend_local of 1M rows there and the driver
     extend with the post-merge refine against the truth over 6M rows;
     IVF-Flat "auto" and "pallas" (kernel 1), IVF-RaBitQ up
     bench/bench_ivf_rabitq.py's ladder (kernel 7); replication 2:
     failover, repair + rank_rejoin, rot_rank -> verify_mnmg ->
     repair_ranks and a corrupt checkpoint healed on load, each bit or
     byte for bit; delete 1% of the ids and upsert 10,000 rows;
  4i. the serving layer (serve_path), under the committed table, on phase
     4's 1M x 96 indexes with bench/bench_serve.py's traffic (256 probe
     queries, data rows + 0.01 noise; 8 client threads x 250 requests of
     1-8 rows; buckets 16 / 64 / 256, a 1 ms linger): IVF-Flat pinned to
     "pallas" (kernel 1) at the first n_probes of 1..32 with recall@10 >=
     0.95, the server's snapshot, wall req/s, the unbatched baseline (200
     requests one call at a time), the speedup, the SLO verdict and the
     device's idle share; every searcher under 2 x 100 requests (brute
     force fused, IVF-PQ recon8_list with the fused bf16 / int8 and pallas
     trims, RaBitQ fused: kernels 2, 1, 3, 4, 7 and 6), each batch-mate
     independent bit for bit (a request in a mixed batch against itself
     alone in the same bucket) and against the plain search of its own
     rows (bit for bit, else values within 1e-6 of the squared norms and
     ids equal outside ties, the steps whose rows change with the row
     count named); a 4x burst against a
     shedding admission; a live index (a 1% delete and a 10,000-row
     upsert through a MutationFeed during traffic, untouched queries bit
     for bit, no deleted id back), p99 with and without an
     IntegrityWatchdog's slice, a rotted list quarantined then repaired
     bit for bit; MnmgSearcher over a replicated 1M-row distributed
     IVF-PQ on 4 ranks (failover bit for bit at coverage 1.0, the heal
     between batches); request traces and the Prometheus section;
  4j. the jobs layer (jobs_path) in a temporary directory: a Job of
     make_data (the rows in 8 fsynced chunks), train and stream (8
     batches) for IVF-PQ, IVF-Flat and RaBitQ: stage seconds, extend
     rows/s, checkpoint GB/s, the streamed IVF-PQ's recall at phase 4's
     rung; five children at once through run_supervised (`--jobs-child`):
     a stream, make_data, a scrub and a checkpointed distributed build
     SIGKILLed at their crash sites and resumed here (the index and the
     .npy byte for byte the uninterrupted run's, the scrub from its
     cursor, the distributed build through rehydrate equal to an
     uninterrupted one), and a job preempted by its SIGTERM whose rerun
     skips the committed stages; a stalled stage killed as StageTimeout
     and retried (detection seconds, device memory around the kill);
  5. each kernel against its plain version on the inputs the main path gave
     it, with kernel, plain and library times (CUDA events) and the bound;
     kernel 1 also at IVF-Flat's own shape (bf16 residual store, n_probes
     32), kernels 1, 3 and 4 on the per-cluster store and kernel 1 on the
     4096-list index, kernels 1, 2 and 7 on the mutation path (the mutated
     IVF-Flat store, the live truth, the mutated RaBitQ store); the fused
     L2 argmin's bound on both routes (split TF32 on the tensor
     cores, f32 on the CUDA cores), the bit-plane scan over k 8 to 128
     and the two IVF-PQ trim kernels over k 8 to 250 across their
     selection switch, the trim kernels' tiles a live block scans, and
     fused_list_topk's trim and refine launches counted apart; the list
     kernels' and the bin fold's device time of each launch (CUDA events
     behind a sleep kernel);
     the pairwise bound with its f32 and MUFU terms apart;
     beside the counting select, descending rows of the tile's shape (its
     one-pass variant's worst case); kernels 6 and 8 on the graph path's
     own tiles (the k-NN graph's, the L1 graph's, the sparse k-NN block
     and the sparse query block), and at the ball cover's (the ball and
     candidate selects of both covers, the 3-D landmark bounds), and
     kernel 6 at the comms path's tile and merge selects; kernels 1, 3, 4,
     6 and 7 at the distributed IVF path's per-rank shapes; kernels 1, 2,
     3, 4, 6 and 7 at the serving path's served batches;
  6. a JSON line of kernels, the card's line, then the device line last.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 and int8 tensor-core
#: rates, f32 on the CUDA cores (an FMA counted as two), HBM rate; f32
#: instructions a second: 132 SMs x 128 lanes x 1.98 GHz
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 66.9e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_INSTR = 33.5e12
PEAK_HBM_BYTES = 3.35e12
#: 32-bit population counts a second: 132 SMs x 16 a clock x 1.98 GHz (the
#: CUDA programming guide's throughput for compute capability 9.0; the
#: AND and the add beside each run at 64 a clock)
PEAK_POPC = 4.18e12
#: special-function unit (MUFU: reciprocal, lg2, ...) operations a second,
#: the same 16 a clock an SM
PEAK_MUFU = 4.18e12
#: f32 instructions each pairwise term needs at least (the absolute value
#: and a negation are free operand modifiers): l1 sub + add; linf sub +
#: max; l2 sub + fma; hamming compare-select + add; canberra sub, add and
#: multiply-add beside a reciprocal, the fewer of two ways: two terms
#: sharing one reciprocal of the product of their denominators (the
#: product and the two scalings, 1.5 f32 and half a MUFU operation a
#: term) bound it below one reciprocal a term (3 f32 and one MUFU, the
#: kernel's way, which runs faster on the H100: PERF.md section 6);
#: KL, held to the reference's rounded ratio q = RN(a / b) (PERF.md
#: section 7), q from a staged reciprocal and two residual steps (a
#: multiply, four multiply-adds), q's residual (one), the difference of
#: two logarithms staged in two floats each (three adds) and two
#: multiply-adds: 11. The two finalizes (sqrt, the 1/k scale) add one per
#: output. MUFU operations beside them (the f32 pipe cannot give a
#: reciprocal): canberra half a reciprocal a term (TERM_MUFU); KL one
#: reciprocal an element of y, n k (Y_ELEM_MUFU; its logarithms, one an
#: element of x and of y, run on the f64 pipe and are not counted). Each
#: rate is its own term of the bound. (KL as a log a - a log b, 2 a term,
#: misses the tolerance between rows close to each other.)
TERM_OPS = {"l1": 2, "linf": 2, "l2_unexpanded": 2, "l2_sqrt_unexpanded": 2, "canberra": 4.5,
            "kl_divergence": 11, "hamming": 2}
TERM_MUFU = {"canberra": 0.5}
Y_ELEM_MUFU = {"kl_divergence": 1}
RECALL_GATE = 0.95
#: earlier times, for the log lines only (figures quoted from PERF.md
#: section 6, H100 80GB HBM3, 700.00 W; not measured by this run): the f32
#: CUDA-core fused_l2_argmin the split-TF32 design replaced, at the
#: labelling shape, and the CUDA-core (AND + popcount) fused_bitplane_topk
#: that the tensor-core scan replaced, on phase 4's RaBitQ rows (k 250 at
#: the gate rung, k 40 at n_probes 8)
EARLIER_ARGMIN_MS = 7.1835
EARLIER_BITPLANE_MS = {250: 2.7891, 40: 1.4774}
#: values agree to this relative tolerance, scaled by the row's largest
#: finite magnitude (the f32 sums run in another order in kernel and plain)
VAL_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# comparison and timing
# ---------------------------------------------------------------------------


def compare(name, kernel_out, plain_out, k, terms=None):
    """Hold a kernel's (values, ids) against its plain version's. Values
    agree to VAL_RTOL times the row's largest finite magnitude (or, where
    `terms` gives it, the row's largest sum of its scores' term magnitudes,
    `list_term_scale`, if larger); ids agree exactly except where the
    plain version's neighbouring scores lie within that tolerance (a
    near-tie that the two summation orders may break either way). Returns
    the max abs error over finite values."""
    kv, ki = (t[..., :k].float().cpu().reshape(-1, k) for t in kernel_out)
    pv, pi = (t[..., :k].float().cpu().reshape(-1, k) for t in plain_out)
    kfin, pfin = torch.isfinite(kv), torch.isfinite(pv)
    if not torch.equal(kfin, pfin):
        raise AssertionError(f"{name}: finite slots differ")
    scale = torch.where(pfin, pv.abs(), 0.0).amax(dim=1, keepdim=True).clamp_min(1.0)
    if terms is not None:
        scale = torch.maximum(scale, terms.float().cpu().reshape(-1, 1))
    tol = VAL_RTOL * scale
    err = torch.where(pfin, (kv - pv).abs(), 0.0)
    if bool((err > tol).any()):
        raise AssertionError(f"{name}: values differ by up to {float(err.max())}")
    gap_prev = torch.full_like(pv, float("inf"))
    gap_prev[:, 1:] = (pv[:, 1:] - pv[:, :-1]).abs()
    gap_next = torch.zeros_like(pv)  # the last slot borders unseen candidates
    gap_next[:, :-1] = (pv[:, 1:] - pv[:, :-1]).abs()
    gap_next[:, -1] = 0.0
    tied = (gap_prev <= tol) | (gap_next <= tol)
    bad = (ki != pi) & pfin & ~tied
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} ids differ away from near-ties")
    agree = float(((ki == pi) | ~pfin).float().mean())
    return float(err.max()), agree


def require_equal(name, out, ref):
    """Bitwise equality of (values, ids): the kernels whose sums are
    exact (int8 rows, integer-grid data) must give the plain version's
    very bits."""
    (kv, ki), (pv, pi) = out, ref
    dv = int((kv.contiguous().view(torch.int32) != pv.contiguous().view(torch.int32)).sum())
    di = int((ki != pi).sum())
    if dv or di:
        raise AssertionError(f"{name}: {dv} values and {di} ids differ from the plain version")


def fold_compare(name, out, ref, rescore):
    """Hold a bin-fold kernel's (values, slots) against its plain
    version's, position by position. Values agree to VAL_RTOL times the
    row's largest finite magnitude; where the slots differ, the float64
    scores of the two slots (`rescore(chunk, row, slot)`) must lie within
    that tolerance (a near-tie inside one bin that the two summation
    orders may break either way). Returns (max abs error, slot
    agreement)."""
    (kv, ki), (pv, pi) = out, ref
    kfin, pfin = torch.isfinite(kv), torch.isfinite(pv)
    if not torch.equal(kfin, pfin):
        raise AssertionError(f"{name}: finite candidates differ")
    tol = VAL_RTOL * torch.where(pfin, pv.abs(), 0.0).amax(-1, keepdim=True).clamp_min(1.0)
    err = torch.where(pfin, (kv - pv).abs(), 0.0)
    if bool((err > tol).any()):
        raise AssertionError(f"{name}: values differ by up to {float(err.max())}")
    bad = (ki != pi) & pfin
    if bool(bad.any()):
        c, r, j = bad.nonzero(as_tuple=True)
        gap = (rescore(c, r, ki[c, r, j]) - rescore(c, r, pi[c, r, j])).abs()
        if bool((gap > tol[c, r, 0].double()).any()):
            raise AssertionError(f"{name}: slots differ away from near-ties")
    agree = 1.0 - float(bad.sum()) / max(1, int(pfin.sum()))
    return float(err.max()), agree


def list_term_scale(lof, q, store, base, slots, ip):
    """Per chunk row of a list kernel's output, the largest |base| + coef
    |q| |v| over its selected slots (`slots`, (ncb, chunk, k)): by
    Cauchy-Schwarz a bound on the sum of the magnitudes of a score's
    terms, which scales the difference two summation orders of its dot may
    give. Where the score cancels (a residual row far from its list's
    centre: large |q| . |v|, a score near |v|^2), the score's own
    magnitude understates it. bf16-rounded operands, as the kernel scores."""
    coef = 1.0 if ip else 2.0
    chunk = slots.shape[1]
    s = slots.long().clamp(0, store.shape[1] - 1)
    vn = store.to(torch.bfloat16).float().norm(dim=-1)[lof.long()]  # (ncb, L)
    b = base[lof.long(), 0]
    vn = torch.gather(vn[:, None, :].expand(-1, chunk, -1), 2, s)
    b = torch.gather(b[:, None, :].expand(-1, chunk, -1), 2, s)
    qn = q.to(torch.bfloat16).float().norm(dim=-1)[..., None]
    t = torch.where(torch.isfinite(b), b.abs() + coef * qn * vn, 0.0)
    return t.amax(-1)


def bf16_rescore(lof, q, store, base, ip):
    """float64 score of (chunk, row, slot) triples over bf16-rounded
    operands, for `fold_compare`."""
    coef = 1.0 if ip else 2.0

    def rescore(c, r, s):
        lst, s = lof[c].long(), s.long()
        dots = (q[c, r].to(torch.bfloat16).double() * store[lst, s].to(torch.bfloat16).double())
        return base[lst, 0, s].double() - coef * dots.sum(-1)

    return rescore


def time_ms(fn, reps, warmup=1):
    """Mean milliseconds per call over `reps` calls, by CUDA events (a
    CPU rehearsal, which reports no times, runs the calls only)."""
    for _ in range(warmup):
        fn()
    if not torch.cuda.is_available():
        for _ in range(reps):
            fn()
        return float("nan")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: {source: ctypes library} of an earlier commit's kernels (`--parent
#: DIR`), timed beside this checkout's by `parent_ab`; empty without it
PARENT_LIBS = {}


def build_parent(root):
    """Build the kernels of the checkout at `root` (its
    raft_tpu_torch/csrc, one nvcc per source, all started together) into
    root/_parent_build, with this checkout's compiler command
    (`_build._command`), and load each library whose source exists there
    into PARENT_LIBS."""
    import ctypes
    from raft_tpu_torch.ops import _build

    csrc = Path(root).resolve() / "raft_tpu_torch" / "csrc"
    out_dir = Path(root).resolve() / "_parent_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in _build.KERNEL_SOURCES:
        if (csrc / src).exists():
            out = out_dir / (Path(src).stem + ".so")
            procs[src] = (out, subprocess.Popen(_build._command(src, out, csrc),
                                                stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    for src, (out, p) in procs.items():
        rep, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"parent {src}: nvcc failed:\n{rep}")
        os.replace(str(out) + ".tmp", out)
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  parent {src}: {line.strip()}")
        PARENT_LIBS[src] = ctypes.CDLL(str(out))
    log(f"parent kernels from {csrc}: {sorted(PARENT_LIBS)}")


def same_bits(a, b):
    """Tensors (or tuples of them) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and bool(
            (a.contiguous().view(torch.uint8) == b.contiguous().view(torch.uint8)).all())
    return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))


def parent_ab(fn, source, reps, name):
    """The parent's kernel of `source` (PARENT_LIBS) on the call `fn`
    makes: the wrapper's cached launchers of that source are swapped for
    the parent library's (same C entries and arguments) while it runs.
    Its output must equal this checkout's bit for bit; then parent,
    change, change, parent, `reps` calls each by CUDA events. {} without
    a parent."""
    lib = PARENT_LIBS.get(source)
    if lib is None:
        return {}
    from raft_tpu_torch.ops import _launch

    out = fn()  # fills the launcher cache
    mine = {key: f for key, f in _launch._fns.items() if key[0] == source}
    theirs = {}
    for key, f in mine.items():
        t = getattr(lib, key[1])
        t.argtypes, t.restype = f.argtypes, f.restype
        theirs[key] = t

    def parent():
        _launch._fns.update(theirs)
        try:
            return fn()
        finally:
            _launch._fns.update(mine)

    if not same_bits(out, parent()):
        raise AssertionError(f"{name}: the parent's kernel gives other bits on the same call")
    p1, c1, c2, p2 = (time_ms(parent, reps), time_ms(fn, reps), time_ms(fn, reps),
                      time_ms(parent, reps))
    log(f"  {name} against the parent's kernel (bitwise equal): parent {p1:.4f} / {p2:.4f} "
        f"ms, change {c1:.4f} / {c2:.4f} ms")
    return {"parent_ms": [p1, p2], "change_ms": [c1, c2]}


# ---------------------------------------------------------------------------
# phase 3: adversarial shapes
# ---------------------------------------------------------------------------


def adversarial_checks(fs, pls, dev, rng):
    """Kernel vs plain at small shapes built to break a kernel: integer
    grids (ties everywhere), int8 values at +-127, ragged widths, +inf
    slots and whole +inf tiles, dead rows, empty chunks, k past the finite
    slots, L 256, 384 (an odd fold count) and 3840."""

    def list_case(name, ncb, chunk, L, rot, k, n_lists, dtype, grid, ip=False, cv=False,
                  inf_frac=0.1, inf_tiles=(), rows=False):
        if grid:
            q = rng.integers(-3, 4, (ncb, chunk, rot)).astype(np.float32)
            st = rng.integers(-3, 4, (n_lists, L, rot)).astype(np.float32)
        else:
            q = rng.standard_normal((ncb, chunk, rot)).astype(np.float32)
            st = rng.standard_normal((n_lists, L, rot)).astype(np.float32) * 30
        store = torch.tensor(st)
        store = (store.clamp(-127, 127).round().to(torch.int8) if dtype == torch.int8
                 else store.to(dtype))
        base = torch.tensor(rng.integers(0, 20, (n_lists, 1, L)).astype(np.float32))
        base[torch.tensor(rng.random((n_lists, 1, L)) < inf_frac)] = float("inf")
        for t in inf_tiles:  # whole 128-slot tiles of +inf base skip their dots
            base[:, :, 128 * t:128 * (t + 1)] = float("inf")
        lof = torch.tensor(rng.integers(0, n_lists, ncb).astype(np.int32))
        cvt = torch.tensor((rng.random(ncb) < 0.7).astype(np.int32)).to(dev) if cv else None
        crt = (torch.tensor(rng.integers(0, chunk + 1, ncb).astype(np.int32)).to(dev)
               if rows else None)
        args = [t.to(dev) for t in (lof, torch.tensor(q), store, base)]
        out = fs.fused_list_topk(*args, k, inner_product=ip, chunk_valid=cvt, chunk_rows=crt)
        ref = fs.fused_list_topk_plain(*args, k, fs.fused_kbuf(k), ip, cvt, crt)
        err, agree = compare(name, out, ref, k)
        if grid and agree != 1.0:
            raise AssertionError(f"{name}: integer-grid ids must match exactly ({agree})")
        log(f"check {name}: ok, max_abs_err {err}, id agreement {agree}")

    num_sms = (torch.cuda.get_device_properties(dev).multi_processor_count
                if dev.type == "cuda" else 132)

    def valid_mask(kind, m, n, d, k):
        """A (n,) survivor mask for the flat kernel's `valid` operand (the
        prefilter's +inf base columns): "all", "half" (density 0.5),
        "k-1" (exactly k - 1 survivors), "none", or "last range" (the
        survivors only in the last n range of its tensor-core plan)."""
        mask = np.ones(n, bool)
        if kind == "half":
            mask = rng.random(n) < 0.5
        elif kind == "k-1":
            mask[:] = False
            mask[rng.choice(n, k - 1, replace=False)] = True
        elif kind == "none":
            mask[:] = False
        elif kind == "last range":
            plan = fs.flat_plan(m, n, d, k, num_sms)
            if plan.n_ranges < 2:
                raise AssertionError(f"last range: the case must cross n ranges ({plan})")
            mask[:(plan.n_ranges - 1) * plan.range_len] = False
        return torch.tensor(mask, device=dev)

    def flat_case(name, m, n, d, k, grid, ip=False, dup=False, valid=None):
        """dup: copies of dataset rows on both sides of every boundary
        between the kernel's n ranges (flat_plan), and two rows duplicated
        across the whole dataset; ties must still go to the smaller id.
        valid: a `valid_mask` kind; the slots past the survivors must hold
        +inf, and `scan_select_k` must turn their ids to -1."""
        gen = (lambda s: rng.integers(-3, 4, s)) if grid else rng.standard_normal
        x = torch.tensor(gen((m, d)).astype(np.float32), device=dev)
        yn = gen((n, d)).astype(np.float32)
        if dup:
            plan = fs.flat_plan(m, n, d, k, num_sms)
            if plan.n_ranges < 2:
                raise AssertionError(f"{name}: the case must cross n ranges ({plan})")
            for b in range(plan.range_len, n, plan.range_len):
                yn[b - 2:b + 3] = yn[b - 2]
            yn[n - 1], yn[n // 3] = yn[0], yn[0]
        y = torch.tensor(yn, device=dev)
        vt = None if valid is None else valid_mask(valid, m, n, d, k)
        out = fs.fused_topk(x, y, k, inner_product=ip, valid=vt)
        yb = y.to(torch.bfloat16)
        base = torch.zeros(n, device=dev) if ip else (yb.float() ** 2).sum(1)
        ref = fs.fused_topk_plain(x.to(torch.bfloat16).float(), yb, base, k,
                                  fs.fused_kbuf(k), ip, valid=vt)
        kk = min(k, n)
        err, agree = compare(name, (out[0][:, :kk], out[1][:, :kk]),
                             (ref[0][:, :kk], ref[1][:, :kk]), kk)
        if grid and agree != 1.0:
            raise AssertionError(f"{name}: integer-grid ids must match exactly ({agree})")
        if bool((out[1][:, kk:k] != fs._ID_SENTINEL).any()):
            raise AssertionError(f"{name}: exhausted slots must hold the sentinel")
        note = ""
        if vt is not None:
            from raft_tpu_torch.matrix.select_k import scan_select_k

            live = min(kk, int(vt.sum()))
            if not bool(torch.isfinite(out[0][:, :live]).all()
                        and torch.isinf(out[0][:, live:kk]).all()):
                raise AssertionError(f"{name}: the slots past the {live} survivors must be +inf")
            sv, si = scan_select_k(x, y, kk, metric="inner_product" if ip else "sqeuclidean",
                                   strategy="fused", valid=vt, device=dev)
            if not bool((si[:, live:] == -1).all() and vt[si[:, :live].long()].all()):
                raise AssertionError(f"{name}: scan_select_k must give the survivors' ids, "
                                     "then -1")
            note = f", {live} of {kk} slots survivors, the rest +inf and id -1"
        log(f"check {name}: ok, max_abs_err {err}, id agreement {agree}{note}")

    def int8_operands(ncb, chunk, L, rot, n_lists, grid, inf_frac=0.1, inf_tiles=()):
        """int8 rows and store: small values (ties everywhere, one scale)
        or the full range with rows and slots at +-127."""
        lo, hi = (-3, 4) if grid else (-127, 128)
        q8 = torch.tensor(rng.integers(lo, hi, (ncb, chunk, rot)).astype(np.int8))
        st = torch.tensor(rng.integers(lo, hi, (n_lists, L, rot)).astype(np.int8))
        q8[0, 0, :], st[0, :2, :] = 127, -127
        if grid:
            rs = torch.full((ncb, chunk, 1), 0.25)
            base = torch.tensor(rng.integers(0, 20, (n_lists, 1, L)).astype(np.float32))
        else:
            rs = torch.tensor(rng.uniform(1e-3, 1.0, (ncb, chunk, 1)).astype(np.float32))
            base = torch.tensor(rng.uniform(0, 1e5, (n_lists, 1, L)).astype(np.float32))
        base[torch.tensor(rng.random((n_lists, 1, L)) < inf_frac)] = float("inf")
        for t in inf_tiles:
            base[:, :, 128 * t:128 * (t + 1)] = float("inf")
        lof = torch.tensor(rng.integers(0, n_lists, ncb).astype(np.int32))
        return [t.to(dev) for t in (lof, q8, st, base, rs)]

    def live_rows(ncb, chunk):
        rows = rng.integers(0, chunk + 1, ncb).astype(np.int32)
        rows[0], rows[-1] = chunk, 0  # a full chunk and an empty one
        return torch.tensor(rows).to(dev)

    def int8_list_case(name, ncb, chunk, L, rot, k, n_lists, grid, ip=False, cv=False,
                       rows=False, inf_frac=0.1, inf_tiles=()):
        args = int8_operands(ncb, chunk, L, rot, n_lists, grid, inf_frac, inf_tiles)
        cvt = torch.tensor((rng.random(ncb) < 0.7).astype(np.int32)).to(dev) if cv else None
        crt = live_rows(ncb, chunk) if rows else None
        out = fs.fused_list_topk_int8(*args, k, inner_product=ip, chunk_valid=cvt, chunk_rows=crt)
        ref = fs.fused_list_topk_int8_plain(*args, k, fs.fused_kbuf(k), ip, cvt, crt)
        require_equal(name, out, ref)
        log(f"check {name}: ok, bitwise equal")

    def fold_case(name, ncb, chunk, L, rot, n_lists, q_rows, ip=False, fold="exact",
                  store_dtype=torch.int8, rows=False, inf_frac=0.1, inf_tiles=()):
        """q_rows: "int8", "grid" (small-integer f32 rows: exact sums) or
        "gaussian"."""
        lof, q8, st, base, rs = int8_operands(ncb, chunk, L, rot, n_lists, q_rows != "int8",
                                              inf_frac, inf_tiles)
        if q_rows == "gaussian":
            q = torch.tensor(rng.standard_normal((ncb, chunk, rot)).astype(np.float32)).to(dev)
        else:
            q = q8 if q_rows == "int8" else q8.float()
        if q_rows != "int8":
            st, rs = st.to(store_dtype), None
        crt = live_rows(ncb, chunk) if rows else None
        out = pls.pq_list_scan(lof, q, st, base, inner_product=ip, q_scale=rs, fold=fold,
                               chunk_rows=crt)
        ref = pls.pq_list_scan_plain(lof, q, st, base, ip, rs, fold, crt)
        if q_rows == "gaussian":
            err, agree = fold_compare(name, out, ref, bf16_rescore(lof, q, st, base, ip))
            log(f"check {name}: ok, max_abs_err {err}, slot agreement {agree}")
        else:
            require_equal(name, out, ref)
            log(f"check {name}: ok, bitwise equal")

    def subset_case(name, ncb, chunk, L, rot, n_lists, ip):
        """Every pair of the int8 exact trim's top-k with fewer than two
        better pairs in its bin is, bitwise, among the int8 bin fold's
        candidates of that row (all of them at L <= 512)."""
        lof, q8, st, base, rs = int8_operands(ncb, chunk, L, rot, n_lists, False)
        k = 100
        tv, ti = (t[..., :k].cpu().numpy() for t in
                  fs.fused_list_topk_int8(lof, q8, st, base, rs, k, inner_product=ip))
        fv, fi = (t.cpu().numpy() for t in
                  pls.pq_list_scan(lof, q8, st, base, inner_product=ip, q_scale=rs))
        checked = 0
        for c in range(ncb):
            for r in range(chunk):
                cands = set(zip(fv[c, r].view(np.int32).tolist(), fi[c, r].tolist()))
                seen = {}
                for v, slot in zip(tv[c, r], ti[c, r]):
                    if not np.isfinite(v):
                        break
                    b = (slot % 128, (slot // 128) % 2)
                    if seen.get(b, 0) < 2 and (int(np.float32(v).view(np.int32)),
                                               int(slot)) not in cands:
                        raise AssertionError(f"{name}: ({v}, {slot}) missing from the fold")
                    checked += seen.get(b, 0) < 2
                    seen[b] = seen.get(b, 0) + 1
        log(f"check {name}: ok, {checked} top-k pairs found among the fold's candidates")

    def stop_base(L, high):
        """(n_lists, 1, L) base rows whose +inf patterns the list kernels'
        stop at a list's last real slot, and their fill past it, must
        survive: lists whose real slots end at 0 (all +inf), 1, 5, 63, 64,
        65, 127, 129, L - 1, L and at random (fewer than k; the later tiles
        all +inf); real slots in the last tile only; tombstone runs before
        the end (whole +inf tiles between real ones, a run across a tile
        boundary, the first tile +inf); scattered +inf slots among the
        real ones of the last seven."""
        ends = (0, 1, 5, 63, 64, 65, 127, 129, L - 1, L, int(rng.integers(1, L)))
        t = len(ends)
        fin = np.ones((t + 4, L), bool)
        for i, e in enumerate(ends):
            fin[i, e:] = False
        fin[t, :L - 128] = False          # real slots in the last tile only
        fin[t + 1, 128:384] = False       # whole +inf tiles, real ones after
        fin[t + 1, 512:] = False
        fin[t + 2, 100:300] = False       # a run across a tile boundary
        fin[t + 2, L - 70:] = False
        fin[t + 3, :128] = False          # the first tile +inf
        fin[t - 3:] &= rng.random((7, L)) >= 0.1
        base = rng.uniform(0, high, fin.shape).astype(np.float32)
        if high <= 20:
            base = np.round(base)
        base[~fin] = np.inf
        return torch.tensor(base[:, None, :])

    def early_stop_case(k, ip, dtype=None, rot=96, L=640, chunk=19, filtered=False):
        """Kernel 1 (`dtype` its store) or, with dtype None, kernel 3 on
        every list of stop_base, each probed by two chunks, with live-row
        prefixes (a full chunk, an empty one): kernel 1 on integer grids
        (ids exact), kernel 3 at +-127 bit for bit. `filtered`: half of
        the real slots +inf besides (a prefilter's view)."""
        base = stop_base(L, 1e5 if dtype is None else 20)
        if filtered:
            base[torch.tensor(rng.random(base.shape) < 0.5)] = float("inf")
        n_lists = base.shape[0]
        ncb = 2 * n_lists
        lof = torch.tensor(np.arange(ncb) % n_lists, dtype=torch.int32).to(dev)
        crt = live_rows(ncb, chunk)
        tag = f"L {L} rot {rot} k {k}{' ip' if ip else ''}{', filtered' if filtered else ''}"
        if dtype is None:
            q8 = torch.tensor(rng.integers(-127, 128, (ncb, chunk, rot)).astype(np.int8))
            st = torch.tensor(rng.integers(-127, 128, (n_lists, L, rot)).astype(np.int8))
            rs = torch.tensor(rng.uniform(1e-3, 1.0, (ncb, chunk, 1)).astype(np.float32))
            args = [lof] + [t.to(dev) for t in (q8, st, base, rs)]
            name = f"int8 list early stop {tag}"
            out = fs.fused_list_topk_int8(*args, k, inner_product=ip, chunk_rows=crt)
            require_equal(name, out, fs.fused_list_topk_int8_plain(*args, k, fs.fused_kbuf(k), ip,
                                                                   None, crt))
            log(f"check {name}: ok, bitwise equal")
            return
        q = torch.tensor(rng.integers(-3, 4, (ncb, chunk, rot)).astype(np.float32))
        st = torch.tensor(rng.integers(-3, 4, (n_lists, L, rot)).astype(np.float32)).to(dtype)
        args = [lof] + [t.to(dev) for t in (q, st, base)]
        name = f"list early stop {str(dtype).split('.')[-1]} {tag}"
        out = fs.fused_list_topk(*args, k, inner_product=ip, chunk_rows=crt)
        ref = fs.fused_list_topk_plain(*args, k, fs.fused_kbuf(k), ip, None, crt)
        err, agree = compare(name, out, ref, k)
        if agree != 1.0:
            raise AssertionError(f"{name}: integer-grid ids must match exactly ({agree})")
        log(f"check {name}: ok, max_abs_err {err}, id agreement {agree}")

    list_case("list int8 grid, empty chunks", 40, 128, 256, 96, 40, 7, torch.int8, True, cv=True)
    list_case("list bf16 grid, chunk 1", 50, 1, 128, 96, 10, 50, torch.bfloat16, True)
    list_case("list f32 grid ragged, ip", 9, 5, 384, 33, 100, 3, torch.float32, True, ip=True)
    list_case("list k > finite slots", 6, 3, 128, 20, 200, 2, torch.float32, True, inf_frac=0.5)
    list_case("list int8 gaussian", 30, 128, 512, 96, 40, 5, torch.int8, False, cv=True)
    list_case("list live-row prefixes, ip", 40, 128, 384, 96, 40, 5, torch.int8, True, ip=True,
              cv=True, rows=True)
    list_case("list +inf tiles, k > finite slots", 7, 19, 640, 96, 256, 3, torch.int8, True,
              inf_frac=0.6, inf_tiles=(0, 2, 4))
    list_case("list long, int8 gaussian", 12, 128, 3840, 96, 40, 4, torch.int8, False,
              inf_tiles=tuple(range(8, 30)))
    for k in (1, 10, 100):
        flat_case(f"flat grid k={k}", 37, 1000, 40, k, True)
        flat_case(f"flat grid ip k={k}", 21, 777, 96, k, True, ip=True)
    flat_case("flat n < k", 5, 50, 8, 100, True)
    flat_case("flat gaussian", 100, 5000, 96, 10, False)
    # the tensor-core variant: m not a multiple of a block's 128 query
    # rows, n below k and ragged against the 128-row tile and the n
    # ranges, k on both sides of the 32-, 128- and 96-row switches
    for m in (1, 127, 129):
        flat_case(f"flat gaussian m={m}", m, 3000, 96, 10, False)
        flat_case(f"flat grid ip m={m}", m, 1100, 96, 33, True, ip=True)
    flat_case("flat n < k, d 96", 7, 100, 96, 128, True)
    flat_case("flat n < k, ip", 3, 200, 96, 256, True, ip=True)
    for k in (1, 10, 32, 33, 128, 129, 256):
        for ip in (False, True):
            flat_case(f"flat grid n 2037 k={k}{' ip' if ip else ''}", 130, 2037, 96, k, True,
                      ip=ip)
    flat_case("flat gaussian d 40 k 97", 200, 4000, 40, 97, False)
    for k, ip in ((10, False), (33, True), (200, False)):
        flat_case(f"flat grid duplicates across n ranges k={k}{' ip' if ip else ''}", 64, 5000,
                  96, k, True, ip=ip, dup=True)
    flat_case("flat grid duplicates across n ranges m 300", 300, 20000, 96, 10, True, dup=True)
    # a prefilter's +inf base columns (`valid`): density 1 and 0.5,
    # exactly k - 1 survivors, none, and survivors only in the last n
    # range of the tensor-core plan; k on both sides of the 32- and
    # 128-row switches, L2 and inner product, integer grids (ids exact)
    for k in (10, 33, 129):
        for ip in (False, True):
            for kind in ("all", "half", "k-1", "none", "last range"):
                flat_case(f"flat valid {kind} k={k}{' ip' if ip else ''}", 130, 2037, 96, k,
                          True, ip=ip, valid=kind)
    flat_case("flat valid half gaussian m 300", 300, 20000, 96, 10, False, valid="half")
    flat_case("flat valid last range gaussian m 300", 300, 20000, 96, 10, False,
              valid="last range")

    int8_list_case("int8 list grid ties, empty chunks", 40, 128, 256, 96, 40, 7, True, cv=True)
    int8_list_case("int8 list +-127, ip, live-row prefixes", 40, 128, 384, 96, 40, 5, False,
                   ip=True, cv=True, rows=True)
    int8_list_case("int8 list +inf tiles, k > finite slots", 7, 19, 640, 96, 256, 3, True,
                   inf_frac=0.6, inf_tiles=(0, 2, 4))
    int8_list_case("int8 list long", 12, 128, 3840, 96, 40, 4, False, rows=True,
                   inf_tiles=tuple(range(8, 30)))
    int8_list_case("int8 list ragged rot, chunk 1", 50, 1, 128, 33, 10, 50, False)
    # the list kernels' early stop, +inf fill and both selections: k on
    # both sides of the switch at 32, every store type of kernel 1, kernel
    # 3 with its TMA ring (rot 96) and its byte staging (rot 40), L2 and IP
    for k in (10, 32, 33, 40, 128, 256):
        for ip in (False, True):
            for dtype in (torch.int8, torch.bfloat16, torch.float32):
                early_stop_case(k, ip, dtype)
            early_stop_case(k, ip)
            early_stop_case(k, ip, rot=40)
    early_stop_case(40, False, torch.bfloat16, rot=33)
    early_stop_case(40, True, torch.int8, rot=40)
    # a prefilter's filtered slots: +inf between real ones, half of every
    # list's real slots, on the lists of stop_base (kernel 1 on the bf16
    # store IVF-Flat scans, and on int8; kernel 3 bit for bit), k 10 and 40
    for k in (10, 40):
        for ip in (False, True):
            early_stop_case(k, ip, torch.bfloat16, filtered=True)
            early_stop_case(k, ip, torch.int8, filtered=True)
            early_stop_case(k, ip, filtered=True)
        early_stop_case(k, False, torch.bfloat16, L=3840, chunk=128, filtered=True)
        list_case(f"list bf16 gaussian L 3840, half the slots filtered, k {k}", 12, 128, 3840,
                  96, k, 4, torch.bfloat16, False, rows=True, inf_frac=0.5)
    for ip in (False, True):
        for fold in ("exact", "packed"):
            tag = f"{'ip' if ip else 'l2'}, {fold}"
            fold_case(f"fold int8 rows L 256, {tag}", 30, 128, 256, 96, 5, "int8", ip, fold,
                      rows=True)
            fold_case(f"fold int8 rows L 384 +inf tile, {tag}", 20, 37, 384, 96, 4, "int8", ip,
                      fold, rows=True, inf_tiles=(1,))
            fold_case(f"fold grid rows L 3840, {tag}", 12, 128, 3840, 96, 4, "grid", ip, fold,
                      rows=True, inf_tiles=tuple(range(8, 30)))
            fold_case(f"fold grid rows bf16 store L 384, {tag}", 9, 5, 384, 33, 3, "grid", ip,
                      fold, store_dtype=torch.bfloat16, inf_frac=0.5)
            fold_case(f"fold grid rows f32 store L 256, {tag}", 9, 16, 256, 40, 3, "grid", ip,
                      fold, store_dtype=torch.float32)
    fold_case("fold int8 rows ragged rot 33, all +inf tiles", 8, 16, 512, 33, 2, "int8",
              fold="packed", inf_tiles=(0, 1, 2, 3))
    fold_case("fold gaussian rows L 3840", 12, 128, 3840, 96, 4, "gaussian", rows=True,
              inf_tiles=tuple(range(8, 30)))

    def fold_stop_case(q_rows, fold, ip, rot=96, store_dtype=torch.int8, L=640, chunk=19):
        """Kernel 4 on every list of stop_base, each probed by two chunks
        with live-row prefixes (a full chunk, an empty one). q_rows "int8"
        (int8 rows at +-127, bit for bit), "grid" (small-integer rows,
        store and base: exact sums, bit for bit) or "gaussian"
        (fold_compare)."""
        grid = q_rows == "grid"
        base = stop_base(L, 20 if grid else 1e5).to(dev)
        n_lists = base.shape[0]
        ncb = 2 * n_lists
        lof = torch.tensor(np.arange(ncb) % n_lists, dtype=torch.int32).to(dev)
        crt = live_rows(ncb, chunk)
        lo, hi = (-3, 4) if grid else (-127, 128)
        st = torch.tensor(rng.integers(lo, hi, (n_lists, L, rot)).astype(np.int8))
        rs = None
        if q_rows == "int8":
            q = torch.tensor(rng.integers(-127, 128, (ncb, chunk, rot)).astype(np.int8)).to(dev)
            rs = torch.tensor(rng.uniform(1e-3, 1.0, (ncb, chunk, 1)).astype(np.float32)).to(dev)
        elif grid:
            q = torch.tensor(rng.integers(-3, 4, (ncb, chunk, rot)).astype(np.float32)).to(dev)
        else:
            q = torch.tensor(rng.standard_normal((ncb, chunk, rot)).astype(np.float32)).to(dev)
        st = st.to(store_dtype).to(dev)
        name = (f"fold stop {q_rows} rows {str(store_dtype).split('.')[-1]} store L {L} rot "
                f"{rot}, {'ip' if ip else 'l2'}, {fold}")
        out = pls.pq_list_scan(lof, q, st, base, inner_product=ip, q_scale=rs, fold=fold,
                               chunk_rows=crt)
        ref = pls.pq_list_scan_plain(lof, q, st, base, ip, rs, fold, crt)
        if q_rows == "gaussian":
            err, agree = fold_compare(name, out, ref, bf16_rescore(lof, q, st, base, ip))
            log(f"check {name}: ok, max_abs_err {err}, slot agreement {agree}")
        else:
            require_equal(name, out, ref)
            log(f"check {name}: ok, bitwise equal")

    # the fold's stop at a list's last real slot and its fill by rule: both
    # folds, L2 and IP, every kind of rows; int8 rows with TMA staging (rot
    # 96, 128) and byte staging (rot 33); f32 rows against int8, bf16 and
    # f32 stores at rot 33, 96 and 128; an odd fold count (L 384) and L 3840
    for fold in ("exact", "packed"):
        for ip in (False, True):
            for q_rows in ("int8", "grid", "gaussian"):
                fold_stop_case(q_rows, fold, ip)
        for rot in (33, 128):
            fold_stop_case("int8", fold, False, rot=rot)
        for rot in (33, 96, 128):
            for dtype in (torch.bfloat16, torch.float32):
                fold_stop_case("grid", fold, rot % 2 == 1, rot=rot, store_dtype=dtype)
            fold_stop_case("gaussian", fold, False, rot=rot, store_dtype=torch.bfloat16)
        fold_stop_case("int8", fold, True, L=384)
        fold_stop_case("grid", fold, False, L=3840, chunk=40)
    for ip in (False, True):
        subset_case(f"int8 trims subset L 384, {'ip' if ip else 'l2'}", 6, 16, 384, 96, 3, ip)
        subset_case(f"int8 trims subset L 1280, {'ip' if ip else 'l2'}", 6, 16, 1280, 96, 3, ip)


def matrix_compare(name, out, ref, exact):
    """Hold a (m, n) distance matrix against its plain version: bitwise
    where `exact`, else VAL_RTOL of the value plus VAL_RTOL of the row's
    largest finite magnitude (the sums run in another order); non-finite
    entries must match. Returns the max abs error over finite entries."""
    out, ref = out.float(), ref.float()
    if exact:
        require_equal(name, (out, torch.zeros(1)), (ref, torch.zeros(1)))
        return 0.0
    fin = torch.isfinite(ref)
    if not torch.equal(torch.where(fin, 0.0, out), torch.where(fin, 0.0, ref)):
        raise AssertionError(f"{name}: non-finite entries differ")
    scale = torch.where(fin, ref.abs(), 0.0).amax(dim=1, keepdim=True)
    err = torch.where(fin, (out - ref).abs(), 0.0)
    if bool((err > VAL_RTOL * torch.where(fin, ref.abs(), 0.0) + VAL_RTOL * scale).any()):
        raise AssertionError(f"{name}: values differ by up to {float(err.max())}")
    return float(err.max())


#: pairwise metrics whose terms are exact on integer-grid data (canberra
#: on values in {0, 1, 3}, whose terms are 0, 1/2 or 1): kernel and plain
#: must agree bit for bit there; linf and hamming always
GRID_EXACT = ("l1", "linf", "l2_unexpanded", "l2_sqrt_unexpanded", "hamming", "canberra")


def expanded_floor(x, y):
    """The rounding floor of an f32 distance computed in the expanded form
    |x|^2 + |y|^2 - 2 x.y, row by row: 4 eps (|x|^2 + |y|^2 + 2|x.y|). The
    terms cancel, so two f32 summation orders differ by up to this much
    whatever the distance."""
    x, y = x.double(), y.double()
    eps = float(torch.finfo(torch.float32).eps)
    return 4 * eps * ((x * x).sum(1) + (y * y).sum(1) + 2 * (x * y).sum(1).abs())


def argmin_compare(name, out, ref, x, y, sqrt=False):
    """Hold a fused L2 argmin's (dist, idx) against its plain version's:
    squared distances to VAL_RTOL of |d| plus the expanded form's f32 floor
    (`expanded_floor` at the plain version's pick); with `sqrt` both
    outputs are squared back (float64) first, since the floor is in squared
    units; where the ids differ, the two candidates' float64 squared
    distances lie within that tolerance (a near-tie the two summation
    orders may break either way). Returns (max abs error of the outputs as
    given, id agreement)."""
    (kd, ki), (pd, pi) = (tuple(t.cpu() for t in o) for o in (out, ref))
    floor = expanded_floor(x, y[pi.long().to(y.device)]).cpu()
    kq, pq = kd.double(), pd.double()
    if sqrt:
        kq, pq = kq * kq, pq * pq
    tol = VAL_RTOL * pq.abs() + floor
    if bool(((kq - pq).abs() > tol).any()):
        raise AssertionError(f"{name}: squared distances differ by up to "
                             f"{float((kq - pq).abs().max())}")
    err = (kd - pd).abs()
    bad = (ki != pi).nonzero()[:, 0]
    if bad.numel():
        xr = x[bad.to(x.device)].double()
        da = ((xr - y[ki[bad].long().to(y.device)].double()) ** 2).sum(1).cpu()
        db = ((xr - y[pi[bad].long().to(y.device)].double()) ** 2).sum(1).cpu()
        if bool(((da - db).abs() > tol[bad]).any()):
            raise AssertionError(f"{name}: {bad.numel()} ids differ away from near-ties")
    return float(err.max()), 1.0 - bad.numel() / max(1, ki.numel())


def tf32_split(a):
    """(hi, lo) of f32 values: hi rounded to TF32 to nearest, ties away
    from zero (cvt.rna.tf32.f32, on the bits), lo = TF32 of a - hi."""
    def rna(v):
        b = np.ascontiguousarray(v, np.float32).view(np.uint32)
        return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    hi = rna(a)
    return hi, rna((a - hi).astype(np.float32))


def split_tf32_depth1(x0, yv, mode):
    """The fused L2 argmin kernel's arithmetic for one row x = [x0] against
    rows y = yv[:, None] (depth 1), in numpy: |x|^2 and |y|^2 rounded once,
    -2y split into TF32 hi and lo as x is, the three products lo.hi, hi.lo,
    hi.hi (each exact) summed in that order with each tensor-core
    accumulation rounded once, to nearest ("rn") or toward zero ("rz"),
    added to |y|^2, then |x|^2 added. Returns the (unclamped) f32
    distances."""
    f64 = np.float64

    def rnd(v):
        r = v.astype(np.float32)
        if mode == "rz":
            r = np.where(np.abs(r.astype(f64)) > np.abs(v), np.nextafter(r, np.float32(0)), r)
        return r

    xn, yn = np.float32(x0 * x0), (yv * yv).astype(np.float32)
    (xh,), (xl,) = tf32_split(np.array([x0], np.float32))
    yh, yl = tf32_split((-2 * yv).astype(np.float32))
    c = rnd(f64(xl) * yh.astype(f64))
    c = rnd(c.astype(f64) + f64(xh) * yl.astype(f64))
    c = rnd(c.astype(f64) + f64(xh) * yh.astype(f64))
    return (xn + (yn + c).astype(np.float32)).astype(np.float32)


def slice_checks(dev, rng):
    """Kernels 8, 5 and 6 against their plain versions at adversarial
    shapes: ragged m, n and k (and k = 1), KL rows with zeros, canberra
    with zero denominators, hamming on 0..2, integer grids (bitwise);
    duplicate rows of y, candidates that round below zero, n = 1, sqrt on
    and off; heavy ties, +-0.0, +-inf and NaN, k = 1, k = L, k past the
    finite values, L from 128 to 1,048,576 (a row that does not fit in
    shared memory)."""
    from raft_tpu_torch.ops import fused_l2_argmin as fla
    from raft_tpu_torch.ops import pairwise_tiled as pt
    from raft_tpu_torch.ops import select_counting as sc

    def operands(metric, m, n, k, grid):
        if grid:
            vals = np.array([0, 1, 3]) if metric in ("canberra", "kl_divergence") else np.arange(-3, 4)
            x, y = rng.choice(vals, (m, k)), rng.choice(vals, (n, k))
        elif metric == "kl_divergence":
            x = rng.random((m, k)) * (rng.random((m, k)) > 0.3)
            y = rng.random((n, k)) * (rng.random((n, k)) > 0.3)
            x, y = x / np.maximum(x.sum(1, keepdims=True), 1e-6), y / np.maximum(
                y.sum(1, keepdims=True), 1e-6)
        elif metric == "hamming":
            x, y = rng.integers(0, 3, (m, k)), rng.integers(0, 3, (n, k))
        else:
            x, y = rng.standard_normal((m, k)), rng.standard_normal((n, k))
            if metric == "canberra":
                x[0, :], y[:3, : max(1, k // 2)] = 0.0, 0.0  # zero denominators
        return (torch.tensor(x.astype(np.float32), device=dev),
                torch.tensor(y.astype(np.float32), device=dev))

    for metric in pt.METRIC_OPS:
        for (m, n, k), grid in (((33, 47, 10), False), ((33, 47, 1), False), ((33, 47, 10), True),
                                ((130, 257, 96), False), ((257, 130, 97), True)):
            x, y = operands(metric, m, n, k, grid)
            out = pt.pairwise_tiled(x, y, metric)
            ref = pt.pairwise_tiled_plain(x, y, metric)
            exact = metric in ("linf", "hamming") or (grid and metric in GRID_EXACT)
            err = matrix_compare(f"pairwise_tiled {metric} {m}x{n}x{k}", out, ref, exact)
            log(f"check pairwise_tiled {metric} {m}x{n}x{k}{' grid' if grid else ''}: ok, "
                + ("bitwise equal" if exact else f"max_abs_err {err}"))

    # canberra's MUFU reciprocal and KL's staged reciprocals and logarithms, and their
    # general path past the fast paths' range: denormals (no flush to zero),
    # 1e-30, huge values, the range's edges 2^-62 and 2^61, magnitudes from
    # 1e-44 to 1e30 (canberra: every term lies in [0, 1]), KL ratios a / b
    # past the f32 range (the reference's +inf); rows equal to rows of the
    # other side (exact zeros), zeros beside all of them
    edge = np.float32(2.0 ** 61)
    uniform = lambda scale: (lambda sh: rng.random(sh) * scale)  # noqa: E731
    for name, metrics, gen_x, gen_y in (
            ("denormals", ("canberra", "kl_divergence"), uniform(1e-39), None),
            ("1e-30", ("canberra", "kl_divergence"), uniform(1e-30), None),
            ("huge", ("canberra", "kl_divergence"), uniform(1e30), None),
            ("range edges", ("canberra", "kl_divergence"), lambda sh: rng.choice(
                np.array([2.0 ** -62, edge, edge * 0.75, 1.0, 3.0, 2.0 ** -61]), sh), None),
            ("magnitudes 1e-44 to 1e30", ("canberra",),
             lambda sh: 10.0 ** rng.uniform(-44, 30, sh), None),
            ("ratio overflow", ("kl_divergence",), lambda sh: 0.5 + 0.5 * rng.random(sh),
             uniform(1e-39))):
        for metric in metrics:
            m, n, k = 130, 257, 97
            x, y = gen_x((m, k)), (gen_y or gen_x)((n, k))
            if metric == "canberra":
                x, y = x * rng.choice([-1.0, 1.0], x.shape), y * rng.choice([-1.0, 1.0], y.shape)
            x[:, ::7], y[:, ::5] = 0.0, 0.0   # zeros: canberra 0/0, KL's guards
            y[:40] = x[:40]                   # rows equal across x and y
            x, y = (torch.tensor(t.astype(np.float32), device=dev) for t in (x, y))
            out = pt.pairwise_tiled(x, y, metric)
            ref = pt.pairwise_tiled_plain(x, y, metric)
            label = f"pairwise_tiled {metric} {name} {m}x{n}x{k}"
            err = matrix_compare(label, out, ref, False)
            eq = torch.arange(40, device=dev)
            if bool((out[eq, eq] != 0).any()) or bool((ref[eq, eq] != 0).any()):
                raise AssertionError(f"{label}: equal rows must give exactly 0")
            log(f"check {label}: ok, max_abs_err {err}, equal rows exactly 0")

    # rows close to each other in every column: one profile times 1 + delta
    # gaussian noise, each row normalised to sum 1. KL's terms a log(a / b)
    # are ~delta a, of both signs, and their sum ~delta^2 / 2: at delta
    # 1e-2 the reference's one rounding of a / b a term sets the last
    # digits VAL_RTOL sees, and the summation order does not
    for delta in (1e-2, 3e-2):
        m, n, k = 130, 257, 97
        base = rng.random(k) + 0.5
        x = base * (1 + delta * rng.standard_normal((m, k)))
        y = base * (1 + delta * rng.standard_normal((n, k)))
        x, y = x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)
        y[:40] = x[:40]
        x, y = (torch.tensor(t.astype(np.float32), device=dev) for t in (x, y))
        for metric in ("canberra", "kl_divergence"):
            out = pt.pairwise_tiled(x, y, metric)
            ref = pt.pairwise_tiled_plain(x, y, metric)
            label = f"pairwise_tiled {metric} near-identical rows delta {delta} {m}x{n}x{k}"
            err = matrix_compare(label, out, ref, False)
            eq = torch.arange(40, device=dev)
            if bool((out[eq, eq] != 0).any()) or bool((ref[eq, eq] != 0).any()):
                raise AssertionError(f"{label}: equal rows must give exactly 0")
            log(f"check {label}: ok, max_abs_err {err}, equal rows exactly 0")

    def argmin_case(name, x, y, sqrt, exact=False):
        out = fla.fused_l2_argmin(x, y, sqrt=sqrt)
        ref = fla.fused_l2_argmin_plain(x, y, sqrt=sqrt)
        if exact:
            require_equal(name, out, ref)
            log(f"check {name}: ok, bitwise equal")
            return out
        err, agree = argmin_compare(name, out, ref, x, y, sqrt)
        log(f"check {name}: ok, max_abs_err {err}, id agreement {agree}")
        return out

    # k 1 to 400 (padded depth 128 is the last with x resident; 160, 224
    # and 416 stream it), n 1 to 1024 (ragged against the 128-column
    # tiles), m ragged against the 128-row blocks; each with and without sqrt
    shapes = ((70, 300, 12), (1000, 1, 96), (257, 129, 97), (33, 1024, 5), (300, 1023, 1),
              (129, 129, 7), (1000, 1023, 200), (131, 1, 200), (200, 130, 400),
              (300, 257, 129), (70, 40, 160))
    for sqrt in (False, True):
        for m, n, k in shapes:
            g = lambda s: torch.tensor(rng.integers(-3, 4, s).astype(np.float32), device=dev)
            x, y = g((m, k)), g((n, k))
            y[n // 2:] = y[:n - n // 2].clone()  # duplicate rows: the lower index wins
            argmin_case(f"fused_l2_argmin grid {m}x{n}x{k} sqrt={sqrt}", x, y, sqrt, exact=True)
            x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32), device=dev)
            y = torch.tensor(rng.standard_normal((n, k)).astype(np.float32), device=dev)
            argmin_case(f"fused_l2_argmin gaussian {m}x{n}x{k} sqrt={sqrt}", x, y, sqrt)
    # the main path's kind of rows (centres U(-5, 5) plus unit noise), and
    # the same shifted by +100: |x|^2 ~ 1e6 against distances ~ 100, the
    # expanded form's cancellation
    for off in (0.0, 100.0):
        cen = rng.uniform(-5, 5, (1023, 96))
        rows = cen[rng.integers(0, 1023, 3001)] + rng.standard_normal((3001, 96))
        x = torch.tensor((rows + off).astype(np.float32), device=dev)
        y = torch.tensor((cen + off).astype(np.float32), device=dev)
        argmin_case(f"fused_l2_argmin blob rows + {off:g}, 3001x1023x96", x, y, False)
    # duplicate centres across column tiles and blocks, rows near them:
    # every pick is the first copy of its centre
    y = torch.tensor(rng.standard_normal((256, 96)).astype(np.float32), device=dev)
    y = torch.cat([y, y[:200], y[:64]]).contiguous()  # copies at 256 + j and 456 + j
    x = (y[rng.integers(0, 256, 2000)] + 1e-3 * torch.randn(2000, 96, device=dev)).contiguous()
    _, i = argmin_case("fused_l2_argmin duplicate centres 2000x520x96", x, y, False)
    if bool((i >= 256).any()):
        raise AssertionError("fused_l2_argmin duplicate centres: a later copy won")
    # duplicates of the query rows at several indices: the lowest wins
    y = torch.tensor(rng.standard_normal((300, 8)).astype(np.float32), device=dev)
    y[130], y[257] = y[5], y[5]
    _, i = argmin_case("fused_l2_argmin duplicate rows", y[[5, 130, 257, 7]].clone(), y, False)
    if i.tolist() != [5, 5, 5, 7]:
        raise AssertionError(f"fused_l2_argmin duplicate rows: ids {i.tolist()}")
    # k = 1, y = x + j ulp: many candidates round below zero; after the
    # clamp they tie at 0.0 and the lowest index wins. The expectation is
    # independent of the kernel: its split-TF32 arithmetic in numpy
    # (`split_tf32_depth1`) under either rounding of the tensor cores'
    # accumulation; the case must discriminate (the unclamped minimum lies
    # elsewhere), and every candidate's own distance from the kernel (n = 1)
    # is >= 0
    x0 = np.float32(1 + 2**-12)
    yv = (x0 + np.arange(-40, 41, dtype=np.float32) * np.float32(2**-23)).astype(np.float32)
    x, y = torch.tensor([[x0]], device=dev), torch.tensor(yv[:, None], device=dev)
    d, i = argmin_case("fused_l2_argmin rounds below zero", x, y, False)
    want, zeros = set(), set()
    for mode in ("rn", "rz"):
        raw = split_tf32_depth1(x0, yv, mode)
        clamped = np.maximum(raw, np.float32(0))
        w = int(np.argmin(clamped))  # the first minimum: the lowest index
        if clamped[w] != 0 or int(np.argmin(raw)) == w or int((clamped == 0).sum()) < 2:
            raise AssertionError(f"fused_l2_argmin rounds below zero: the {mode} model does not "
                                 f"put several candidates below zero")
        want.add(w)
        zeros.add(int((clamped == 0).sum()))
    each = torch.cat([fla.fused_l2_argmin(x, y[j:j + 1].contiguous())[0]
                      for j in range(y.shape[0])]).cpu()
    if int(i[0]) not in want or float(d[0]) != 0.0 or not bool((each >= 0).all()):
        raise AssertionError(f"fused_l2_argmin rounds below zero: ({float(d[0])}, {int(i[0])}), "
                             f"want (0.0, {sorted(want)}); least candidate {float(each.min())}")
    log(f"check fused_l2_argmin clamp before compare: index {int(i[0])} at 0.0 as the split-TF32 "
        f"model gives ({sorted(zeros)} candidates clamp to 0.0, rn / rz)")

    def counting_case(name, vals, k):
        t = torch.tensor(vals, device=dev)
        out = sc.counting_select_min(t, k)
        ref = sc.counting_select_min_plain(t, k)
        nan = torch.isnan(ref[0])
        if not torch.equal(torch.isnan(out[0]), nan):
            raise AssertionError(f"{name}: NaN slots differ")
        require_equal(name, (torch.where(nan, 0.0, out[0]), out[1]),
                      (torch.where(nan, 0.0, ref[0]), ref[1]))
        log(f"check {name}: ok, bitwise equal")

    def padded(x):
        pad = (-x.shape[1]) % 128
        return np.pad(x, ((0, 0), (0, pad)), constant_values=np.inf).astype(np.float32)

    ties = rng.integers(0, 6, (9, 1000)).astype(np.float32)
    specials = rng.choice(np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0], np.float32),
                          (9, 1000)).astype(np.float32)
    for k in (1, 10, 300, 1000, 1024):
        counting_case(f"counting ties L 1000 padded k={k}", padded(ties), k)
        counting_case(f"counting +-0/+-inf/NaN L 1000 padded k={k}", padded(specials), k)
    short = rng.standard_normal((5, 128)).astype(np.float32)
    short[:, 40:] = np.inf  # k past the finite values: real +inf before the pad
    for k in (1, 40, 64, 128):
        counting_case(f"counting L 128 k={k}", short, k)
    wide = rng.integers(-50, 50, (6, 32768)).astype(np.float32)
    for k in (1, 10, sc.SMALL_K_MAX, sc.SMALL_K_MAX + 1, 256, 257, 32768):
        counting_case(f"counting L 32768 k={k}", wide, k)
    # every element an insertion (the one-pass variant's worst case), and
    # ties everywhere; k on both sides of the variant switch
    # (sc.SMALL_K_MAX) and of the JAX envelope's cap (256)
    i = np.arange(32768, dtype=np.float32)
    desc = np.stack([32768.0 - i, -0.25 * i, 1e30 / (i + 1.0)]).astype(np.float32)
    equal = np.stack([np.full(32768, 7.0), np.full(32768, -0.0),
                      np.full(32768, np.inf)]).astype(np.float32)
    for k in (1, 10, sc.SMALL_K_MAX, sc.SMALL_K_MAX + 1, 256, 257):
        counting_case(f"counting descending L 32768 k={k}", desc, k)
        counting_case(f"counting all-equal L 32768 k={k}", equal, k)
    for k in (10, sc.SMALL_K_MAX, sc.SMALL_K_MAX + 1, 256, 257):
        counting_case(f"counting B 1 L 32768 k={k}", wide[:1], k)
    long = rng.standard_normal((2, 1 << 20)).astype(np.float32)
    long[1] = np.round(long[1])
    for k in (1, 10, 1000):
        counting_case(f"counting L 1048576 (device-memory row) k={k}", long, k)


def bitplane_checks(fs, dev, rng):
    """Kernel 7 against its plain version, bit for bit (values and slots:
    both round the estimator with the same explicit operations): 1, 4
    and 8 query bits; 1 to 32 words (the K-block edges 4, 5, 8, 9), both
    sides of the resident / streamed switch and the widest envelope;
    all-ones planes and codes; duplicate codes (ties to the
    smaller slot); +inf tails and whole +inf tiles; empty chunks and
    live-row prefixes; k 1, 40 and 256 (kbuf 256) and k past the finite
    slots; L 128 to 3840; L2 and inner product. Two cases make the
    estimator an exact map of the integer scores (lo 0, delta 1, qsum 0,
    qconst 0, |r| 1, o_dot 1, rot_dim 64: score = 1 - S_u / 2), so S_u
    is read back from the kernel and held against `bitplane_su`."""
    from raft_tpu_torch.neighbors import quantizer as tq

    def operands(ncb, chunk, L, W, bits, n_lists, ties=False, inf_frac=0.1, inf_tiles=(),
                 integer=False, equal=False, falling=False, ones=False):
        words = rng.integers(0, 2**32, (n_lists, L, W), dtype=np.uint64).astype(np.uint32)
        if ones:
            words[:] = 0xFFFFFFFF  # every code bit set, bit 31 too
        if ties:
            words[:, 1::2] = words[:, 0::2]  # every code twice
        if equal:
            words[:] = words[:, :1]  # one code a list: every score of a row ties
        if falling:
            words[:] = 0  # S_u = 0: the estimator is the same for every slot
        codes = torch.tensor(words.view(np.int32))
        pop = tq.popcount32(codes).sum(-1).float()
        rn = torch.tensor(rng.uniform(0.5, 20.0, (n_lists, L)).astype(np.float32))
        od = torch.tensor(rng.uniform(0.5, 1.0, (n_lists, L)).astype(np.float32))
        if ties:
            rn[:, 1::2], od[:, 1::2] = rn[:, 0::2], od[:, 0::2]
        if integer or equal:
            rn, od = torch.ones_like(rn), torch.ones_like(od)
        if falling:
            # inner product, est = rsq > 0 for every slot (qsum -1 below):
            # score -(rn est + qconst) falls strictly with the slot, so
            # every slot beats the row's k-th pair (each one an insertion)
            rn = (1.0 + torch.arange(L, dtype=torch.float32)).expand(n_lists, L).contiguous()
            od = torch.ones_like(od)
        meta = torch.stack([pop, rn, od], dim=1)
        base = torch.zeros((n_lists, 1, L))
        base[torch.tensor(rng.random((n_lists, 1, L)) < inf_frac)] = float("inf")
        for t in inf_tiles:
            base[:, :, 128 * t:128 * (t + 1)] = float("inf")
        qres = torch.tensor((rng.standard_normal((ncb, chunk, 32 * W))
                             * np.exp(rng.uniform(-3, 3, (ncb, chunk, 1)))).astype(np.float32))
        planes, lo, delta = tq.quantize_queries(qres, bits)
        if ones:
            planes = torch.full_like(planes, -1)  # every level 2^bits - 1
        qmeta = torch.stack([lo[..., 0], delta[..., 0], qres.sum(-1), (qres * qres).sum(-1)], 1)
        if integer:
            qmeta = torch.zeros_like(qmeta)
            qmeta[:, 1] = 1.0
        if falling:
            qmeta[:, 2] = -1.0
        lof = torch.tensor(rng.integers(0, n_lists, ncb).astype(np.int32))
        return [t.contiguous().to(dev) for t in (lof, planes.reshape(ncb, chunk, bits * W),
                                                 codes.transpose(1, 2), meta, base, qmeta)]

    def case(name, ncb, chunk, L, W, bits, k, n_lists, ip=False, kbuf=None, cv=False,
             rows=False, integer=False, **kw):
        args = operands(ncb, chunk, L, W, bits, n_lists, integer=integer, **kw)
        rot = 64 if integer else 32 * W
        cvt = torch.tensor((rng.random(ncb) < 0.7).astype(np.int32)).to(dev) if cv else None
        crt = None
        if rows:
            live = rng.integers(0, chunk + 1, ncb).astype(np.int32)
            live[0], live[-1] = chunk, 0  # a full chunk and an empty one
            crt = torch.tensor(live).to(dev)
        kb = kbuf or fs.fused_kbuf(k)
        out = fs.fused_bitplane_topk(*args, k, rot_dim=rot, bits=bits, kbuf=kb, inner_product=ip,
                                     chunk_valid=cvt, chunk_rows=crt)
        ref = fs.fused_bitplane_topk_plain(*args, k, kb, rot, bits, ip, cvt, crt)
        require_equal(name, out, ref)
        note = "bitwise equal"
        if integer:
            lof, planes, codes_t = args[:3]
            v, i = out[0][..., :k], out[1][..., :k]
            fin = torch.isfinite(v)
            su = fs.bitplane_su(planes, codes_t[lof.long()], bits)
            want = torch.gather(su, 2, torch.where(fin, i, 0).long())
            got = ((1.0 - v) * 2.0).round().to(torch.int32)
            if bool((torch.where(fin, got, 0) != torch.where(fin, want, 0)).any()):
                raise AssertionError(f"{name}: integer scores S_u differ from bitplane_su")
            note += f", S_u of {int(fin.sum())} selected slots exact"
        log(f"check {name}: ok, {note}")

    case("bitplane bits 8 W 3 L 384 k 40", 20, 128, 384, 3, 8, 40, 5)
    case("bitplane bits 1 W 1 L 128 k 1", 30, 64, 128, 1, 1, 1, 7)
    case("bitplane bits 4 W 4 L 256 k 256 ip", 12, 128, 256, 4, 4, 256, 3, ip=True)
    case("bitplane ties (duplicate codes) k 40", 16, 128, 256, 3, 8, 40, 4, ties=True)
    case("bitplane ties ip, bits 4", 16, 37, 256, 3, 4, 100, 4, ties=True, ip=True)
    case("bitplane +inf tails and tiles, k past the finite slots", 7, 19, 640, 3, 8, 256, 3,
         inf_frac=0.6, inf_tiles=(0, 2, 4))
    case("bitplane empty chunks and live-row prefixes, ip", 40, 128, 384, 3, 8, 40, 5, ip=True,
         cv=True, rows=True)
    case("bitplane k 10 in a 256-wide buffer", 10, 128, 384, 3, 8, 10, 5, kbuf=256, rows=True)
    case("bitplane long list L 3840, +inf tail tiles", 12, 128, 3840, 3, 8, 40, 4, rows=True,
         inf_tiles=tuple(range(8, 30)))
    case("bitplane integer S_u, bits 8 W 3", 12, 128, 384, 3, 8, 100, 4, integer=True)
    case("bitplane integer S_u, bits 1 W 4, ties", 12, 64, 256, 4, 1, 256, 3, integer=True,
         ties=True)
    # the two selection variants (register lists to k 32, the shared-memory
    # batch past it): k 32 and 33 at either side of the switch, 129 to 256
    # at the gate rung's list length; scores that fall with the slot (every
    # slot an insertion, the batch's worst case); all-equal scores (ties in
    # id order); +inf tails and tiles with empty chunks and live-row prefixes
    for k in (32, 33, 129, 160, 250, 256):
        case(f"bitplane L 4992 k {k}", 24, 128, 4992, 3, 8, k, 4, rows=True)
    case("bitplane falling scores L 4992 k 250, ip", 8, 128, 4992, 3, 8, 250, 3, ip=True,
         inf_frac=0.0, falling=True)
    case("bitplane falling scores L 4992 k 32, ip", 8, 128, 4992, 3, 8, 32, 3, ip=True,
         inf_frac=0.0, falling=True)
    for k in (32, 129, 256):
        case(f"bitplane all-equal scores L 640 k {k}", 10, 128, 640, 3, 8, k, 3, inf_frac=0.0,
             equal=True)
    case("bitplane +inf tails, empty chunks, live rows, k 200", 30, 128, 1280, 3, 8, 200, 4,
         cv=True, rows=True, inf_frac=0.5, inf_tiles=(1, 3, 4, 9))
    # the widest rotations the shared memory admits at 8 query bits, now
    # that a row's list is sized by k (64, 128 or 256 pairs)
    # a prefilter's filtered slots: +inf between real ones (half of them),
    # with and without +inf tail tiles, k 10 and 40
    for k in (10, 40):
        for ip in (False, True):
            case(f"bitplane half the slots filtered k {k}{' ip' if ip else ''}", 20, 128, 1280,
                 3, 8, k, 4, ip=ip, rows=True, inf_frac=0.5)
        case(f"bitplane filtered slots and +inf tail L 4992 k {k}", 12, 128, 4992, 3, 8, k, 4,
             rows=True, inf_frac=0.5, inf_tiles=tuple(range(20, 39)))
    # the tensor-core scan (4 code words a K-block): word counts at the
    # K-block edges, a wide rotation, all-ones planes (level 255, which an
    # s8 operand cannot hold) against all-ones codes (S_u = 255 x 32 W,
    # read back exactly), phase 4h's list length at the gate rung's k
    for W in (4, 5, 8, 9):
        case(f"bitplane K-block edge: {W} words, 8 bits, k 40", 12, 128, 384, W, 8, 40, 4,
             rows=True)
    for W in (2, 5):  # 2-word K-blocks, with the 256-pair lists
        case(f"bitplane K-block edge: {W} words, 8 bits, k 250", 12, 128, 640, W, 8, 250, 4,
             rows=True)
    case("bitplane wide: 32 words (rot 1024), 8 bits, k 100, ip", 10, 64, 640, 32, 8, 100, 3,
         ip=True, rows=True)
    for W in (3, 9):
        case(f"bitplane all-ones planes and codes, {W} words, integer S_u", 6, 32, 256, W, 8, 40,
             2, integer=True, ones=True, inf_frac=0.0)
    case("bitplane 4h geometry: L 9984, k 250", 16, 128, 9984, 3, 8, 250, 4, rows=True)
    # both sides of the launcher's switch by shape: the widest rotation
    # whose levels stay resident in shared memory, and one word past it
    # (each warpgroup rebuilds a K-block's slice of them)
    for k in (32, 33, 250):
        edge = max(w for w in range(1, 1024) if fs.bitplane_resident(w, k))
        for W in (edge, edge + 1):
            side = "resident" if fs.bitplane_resident(W, k) else "streamed"
            case(f"bitplane {side} levels: {W} words, 8 bits, k {k}", 3, 16, 256, W, 8, k, 2,
                 rows=True)
    # the widest rotations the envelope admits at 8 query bits (S_u below
    # 2^24), either side of the selection switch and past it
    for k in (32, 33, 40, 100, 250):
        words = max(w for w in range(1, 4096) if fs.fits_fused_bitplane(256, w, 8, k))
        case(f"bitplane widest envelope: {words} words, 8 bits, k {k}", 3, 16, 256, words, 8, k,
             2, rows=True)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def make_blobs(seed, n, dim, nq, n_blobs):
    """Clustered f32 data as bench.py makes it: blob centers U(-5, 5),
    unit gaussian noise; the queries come from the same blobs."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5.0, 5.0, (n_blobs, dim)).astype(np.float32)
    data = centers[rng.integers(0, n_blobs, n)]
    data += rng.standard_normal((n, dim), dtype=np.float32)
    queries = centers[rng.integers(0, n_blobs, nq)]
    queries += rng.standard_normal((nq, dim), dtype=np.float32)
    return data, queries


def timed_windows(g, run, sync):
    """(seconds per batch, each window's QPS) over g.windows windows of
    g.batch_reps back-to-back batches, one synchronize at each window's
    end, so every stall inside a window counts."""
    windows = []
    for _ in range(g.windows):
        sync()
        t0 = time.perf_counter()
        for _ in range(g.batch_reps):
            run()
        sync()
        windows.append(time.perf_counter() - t0)
    return (sum(windows) / (len(windows) * g.batch_reps),
            [g.nq * g.batch_reps / w for w in windows])


def recall(ids, truth):
    ids, truth = ids.cpu().numpy(), truth.cpu().numpy()
    k = truth.shape[1]
    return float(np.mean([len(set(ids[i]) & set(truth[i])) / k for i in range(len(truth))]))


class Spy:
    """Keeps the arguments of the first calls to a kernel wrapper, so the
    kernel can be held against its plain version on the very inputs the
    main path gave it. The wrapper itself runs unchanged and keeps its
    own launch count."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.orig(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class ListTally(Spy):
    """Counts the calls to `fused_list_topk` by what they are, over a whole
    path: the trim (chunks of many rows) and the refine (chunk 1). Each
    call is one launch on the card, so the two sum to the wrapper's own
    launch count for the path."""

    def __init__(self, module):
        super().__init__(module, "fused_list_topk")
        self.counts = {"trim": 0, "refine": 0}

    def __call__(self, *args, **kwargs):
        self.counts["refine" if args[1].shape[1] == 1 else "trim"] += 1
        return self.orig(*args, **kwargs)


#: the engines the main path drives after the fused bf16 ladder: (trim, score_dtype)
ENGINES = (("fused", "int8"), ("pallas", "bf16"), ("pallas", "int8"))
#: the kernels each path must launch: the first path (truth, the fused bf16
#: ladder and its profiled batches) and one path per later engine; every
#: path refines its shortlist with fused_list_topk
PATH_KERNELS = {("fused", "bf16"): ("fused_topk", "fused_list_topk"),
                ("fused", "int8"): ("fused_list_topk_int8", "fused_list_topk"),
                ("pallas", "bf16"): ("pq_list_scan", "fused_list_topk"),
                ("pallas", "int8"): ("pq_list_scan", "fused_list_topk"),
                # the distance and selection slice (slice_paths)
                ("knn", "l1"): ("pairwise_tiled",),
                ("knn", "fused"): ("fused_topk",),
                ("select_k", "counting"): ("counting_select_min",),
                ("fused_l2_nn", "argmin"): ("fused_l2_argmin",),
                # IVF-RaBitQ, scan_engine="fused" (rabitq_path)
                ("rabitq", "fused"): ("fused_bitplane_topk",),
                # IVF-Flat, every engine; only "fused" launches a kernel (ivf_flat_path)
                ("ivf_flat", "fused"): ("fused_list_topk",),
                # the filtered searches (prefilter_path): the filtered truth,
                # IVF-Flat and IVF-PQ fused (with its refine), IVF-RaBitQ fused
                ("prefilter", "all"): ("fused_topk", "fused_list_topk", "fused_bitplane_topk"),
                # IVF-PQ's other modes (pq_modes_path): the default ladder
                # (the approx trim is tensor code; its refine launches kernel 1),
                # the small batches (the fused trim among them), per-cluster
                # codebooks on the three kernel trims, the index past 1024 lists
                ("pq_default", "approx"): ("fused_list_topk",),
                ("pq_small", "nq"): ("fused_list_topk",),
                ("per_cluster", "all"): ("fused_list_topk", "fused_list_topk_int8",
                                         "pq_list_scan"),
                ("pq_wide", "fused"): ("fused_list_topk",),
                # live mutation and persistence on the three indexes
                # (mutation_path): the live truth, IVF-PQ fused (with its
                # refine) and IVF-Flat fused, RaBitQ fused
                ("mutation", "all"): ("fused_list_topk", "fused_topk", "fused_bitplane_topk"),
                # integrity of the live index and the fault sites
                # (integrity_path): searches at the gate rungs, knn fused,
                # refine_host's fused re-rank
                ("integrity", "all"): ("fused_list_topk", "fused_topk", "fused_bitplane_topk")}
#: IVF-Flat's engines and n_probes ladder on the main path's data
#: (bench/bench_neighbors.py:93-118 runs n_probes 32)
FLAT_ENGINES = ("fused", "list", "query", "auto")
FLAT_PROBES = (8, 16, 32)
#: the "query" engine's timing: one window of this many batches (its
#: gathers copy n_probes x max_list rows a query)
QUERY_ENGINE_BATCHES = 3


def main_path(g, dev, fs, pls, sync):
    from raft_tpu_torch.neighbors import brute_force, ivf_pq
    from raft_tpu_torch.neighbors.refine import refine

    t0 = time.perf_counter()
    data_np, queries_np = make_blobs(g.seed, g.n, g.dim, g.nq, g.n_lists)
    dataset = torch.from_numpy(data_np).to(dev)
    queries = torch.from_numpy(queries_np).to(dev)
    sync()
    log(f"data: {g.n} x {g.dim}, {g.nq} queries, made in {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=g.n_lists, pq_dim=g.dim // 2,
                                            kmeans_n_iters=10),
                         dataset, seed=g.seed, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    log(f"build: {index} in {build_s:.3f} s, max list {int(index.list_sizes.max())}")

    # the first path's fused_list_topk calls, trim and refine apart
    tally = ListTally(fs)
    tally.__enter__()
    with Spy(fs, "fused_topk") as flat_spy:
        t0 = time.perf_counter()
        _, truth = brute_force.knn(dataset, queries, g.k, engine="fused", device=dev)
        sync()
        truth_s = time.perf_counter() - t0
    log(f"truth: brute_force.knn(engine='fused') in {truth_s:.3f} s")

    def rung(n_probes, trim, dtype, spies):
        """One rung: a first run for recall and the kernels' inputs (under
        `spies`), then QPS over windows of back-to-back batches, one
        synchronize at each window's end, so every stall inside a window
        counts."""
        params = ivf_pq.SearchParams(n_probes=n_probes, score_mode="recon8_list",
                                     trim_engine=trim, score_dtype=dtype)

        def run():
            _, cand = ivf_pq.search(params, index, queries, 4 * g.k)
            return refine(dataset, queries, cand, g.k, strategy="fused", device=dev)

        with contextlib.ExitStack() as stack:
            for spy in spies:
                stack.enter_context(spy)
            _, ids = run()
            sync()
        r = recall(ids, truth)
        s, w_qps = timed_windows(g, run, sync)
        log(f"rung trim={trim} score_dtype={dtype} n_probes={n_probes} + refine: "
            f"recall@{g.k} {r:.4f}, {g.nq / s:.1f} qps ({s * 1e3:.4f} ms per {g.nq}-query "
            f"batch over {len(w_qps)} windows of {g.batch_reps} batches; window qps "
            f"{min(w_qps):.1f} .. {max(w_qps):.1f})")
        return {"trim": trim, "score_dtype": dtype, "n_probes": n_probes, "refine": True,
                "recall": r, "qps": g.nq / s, "batch_s": s, "window_qps": w_qps}

    rungs = []
    captured = {"flat": flat_spy.calls[0]}
    for n_probes in (8, 16, 32, 64):
        spy = Spy(fs, "fused_list_topk")
        rungs.append(rung(n_probes, "fused", "bf16", [spy]))
        if n_probes == 8:
            captured["trim"], captured["refine"] = spy.calls[0], spy.calls[-1]
    breakdown = pallas_breakdown = None
    if dev.type == "cuda":
        params8 = ivf_pq.SearchParams(n_probes=8, score_mode="recon8_list", trim_engine="fused")
        breakdown = device_breakdown(
            lambda: refine(dataset, queries, ivf_pq.search(params8, index, queries, 4 * g.k)[1],
                           g.k, strategy="fused", device=dev), g.batch_reps,
            rungs[0]["batch_s"] * 1e3)
    tally.__exit__(None, None, None)
    # each later engine is a path of its own: its counts from 0, read after
    launches = {("fused", "bf16"): fs.launch_counts()}
    log(f"path trim=fused score_dtype=bf16: fused_list_topk launches "
        f"{launches[('fused', 'bf16')]['fused_list_topk']}, of them trim "
        f"{tally.counts['trim']}, refine {tally.counts['refine']}")
    for trim, dtype in ENGINES:
        fs.reset_launch_counts()
        for n_probes in (8, 16):
            spy = (Spy(pls, "pq_list_scan") if trim == "pallas"
                   else Spy(fs, "fused_list_topk_int8"))
            rungs.append(rung(n_probes, trim, dtype, [spy]))
            if n_probes == 8:
                captured[(trim, dtype)] = spy.calls[0]
        if (trim, dtype) == ("pallas", "bf16") and dev.type == "cuda":
            # where the bin trim's batch goes beside its kernel, op by op
            pparams = ivf_pq.SearchParams(n_probes=8, score_mode="recon8_list",
                                          trim_engine=trim, score_dtype=dtype)
            pallas_breakdown = device_breakdown(
                lambda: refine(dataset, queries,
                               ivf_pq.search(pparams, index, queries, 4 * g.k)[1], g.k,
                               strategy="fused", device=dev), g.batch_reps,
                rungs[-2]["batch_s"] * 1e3, label="trim pallas bf16, n_probes 8 + refine",
                top=20)
        launches[(trim, dtype)] = fs.launch_counts()
    fused8 = ivf_pq.SearchParams(n_probes=8, score_mode="recon8_list", trim_engine="fused")
    ab = sorted_top_ab(g, lambda: refine(
        dataset, queries, ivf_pq.search(fused8, index, queries, 4 * g.k)[1], g.k,
        strategy="fused", device=dev), sync)
    return {"build_s": build_s, "truth_s": truth_s, "rungs": rungs, "breakdown": breakdown,
            "pallas_breakdown": pallas_breakdown,
            "dataset": dataset, "queries": queries, "truth": truth, "index": index,
            "launches": launches, "list_launches": tally.counts, "sorted_top_ab": ab}, captured


def _float_sort_top(vals, k, largest):
    """`matrix.select_k._sorted_top` as it was before the signed-zero
    repair: a stable sort of the values themselves, which ranks -0.0 and
    +0.0 as equal. Kept here only to time the repair against it."""
    v, i = torch.sort(vals, dim=-1, descending=largest, stable=True)
    return v[..., :k], i[..., :k]


def sorted_top_ab(g, run, sync):
    """QPS of the fused bf16 engine at n_probes 8 + refine (its coarse
    select and merges go through `_sorted_top`) with the earlier float
    sort and with the repaired order-key sort, in turns: earlier,
    repaired, repaired, earlier; each turn QPS over g.windows windows of
    g.batch_reps back-to-back batches."""
    # the module (the package's `select_k` is the function)
    sk = importlib.import_module("raft_tpu_torch.matrix.select_k")
    repaired, out = sk._sorted_top, {"earlier": [], "repaired": []}
    try:
        for label in ("earlier", "repaired", "repaired", "earlier"):
            sk._sorted_top = _float_sort_top if label == "earlier" else repaired
            run()
            out[label].append(g.nq / timed_windows(g, run, sync)[0])
    finally:
        sk._sorted_top = repaired
    log(f"_sorted_top A/B, fused bf16 n_probes 8 + refine: earlier float sort "
        f"{out['earlier'][0]:.1f} / {out['earlier'][1]:.1f} qps, repaired order-key sort "
        f"{out['repaired'][0]:.1f} / {out['repaired'][1]:.1f} qps (turns 1, 4 / 2, 3)")
    return out


def l1_truth_check(dataset, queries, ids, k):
    """The L1 k-NN ids of 16 queries against numpy float64 L1 over every
    row (summed in blocks of rows). Returns the agreement."""
    ds = dataset.cpu().numpy()
    qs = queries[:16].cpu().numpy().astype(np.float64)
    d = np.empty((16, ds.shape[0]))
    for s in range(0, ds.shape[0], 1 << 16):
        blk = ds[s:s + (1 << 16)].astype(np.float64)
        d[:, s:s + blk.shape[0]] = np.abs(qs[:, None, :] - blk[None, :, :]).sum(-1)
    ref = np.argsort(d, axis=1, kind="stable")[:, :k]
    return recall(ids[:16], torch.from_numpy(ref))


def slice_paths(g, dev, res, sync):
    """The distance and selection slice on the main path's data, four
    paths, each with its launch counts set to 0 just before it and read
    just after:
      1. brute_force.knn(metric="l1"), tiled over every row (pairwise_tiled
         on each 32,768-row tile); QPS over three calls; ids against numpy
         float64 L1 for 16 queries, agreement >= 0.99;
      1b. brute_force.knn(engine="fused"), the exact L2 k-NN (fused_topk):
         ids equal to the truth phase 4 computed with it, QPS over windows
         of back-to-back calls;
      2. select_k(strategy="counting") on the first L1 distance tile;
         ids and values equal to select_k(strategy="topk");
      3. fused_l2_nn_argmin of the rotated rows against the index's coarse
         centres (the build's own labelling), against
         kmeans_balanced.predict: differing rows must be float64 near-ties
         (1e-5 relative); distances against numpy float64 on 16,384 rows,
         rtol 1e-5."""
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.core.config import strict_f32_matmul
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn, fused_l2_nn_argmin
    from raft_tpu_torch.matrix.select_k import select_k
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import _launch
    from raft_tpu_torch.ops import pairwise_tiled as pt

    dataset, queries, k = res["dataset"], res["queries"], g.k
    out = {"launches": {}}

    _launch.reset_launch_counts()
    with Spy(pt, "pairwise_tiled") as spy:
        _, ids = brute_force.knn(dataset, queries, k, metric="l1", device=dev)
        sync()
    t0 = time.perf_counter()
    for _ in range(3):
        brute_force.knn(dataset, queries, k, metric="l1", device=dev)
    sync()
    secs = (time.perf_counter() - t0) / 3
    out["launches"][("knn", "l1")] = _launch.launch_counts()
    agree = l1_truth_check(dataset, queries, ids, k)
    out["knn_l1"] = {"qps": g.nq / secs, "call_s": secs, "agreement": agree,
                     "tiles": len(spy.calls)}
    log(f"path knn l1: {g.nq / secs:.1f} qps ({secs:.4f} s a {g.nq}-query call over "
        f"{dataset.shape[0]} rows, mean of 3), ids vs numpy float64 L1 (16 queries x "
        f"{dataset.shape[0]} rows): agreement {agree:.4f}")
    if agree < 0.99:
        raise AssertionError(f"L1 k-NN disagrees with numpy float64: {agree}")
    out["tile_inputs"] = spy.calls[0][0][:2]

    _launch.reset_launch_counts()

    def exact_l2():
        return brute_force.knn(dataset, queries, k, engine="fused", device=dev)

    _, ids = exact_l2()
    sync()
    if not torch.equal(ids, res["truth"]):
        raise AssertionError("brute_force.knn(engine='fused') differs from the truth it computed")
    s, w_qps = timed_windows(g, exact_l2, sync)
    out["launches"][("knn", "fused")] = _launch.launch_counts()
    out["knn_fused"] = {"qps": g.nq / s, "call_s": s, "window_qps": w_qps}
    log(f"path knn fused (exact L2, bf16 operands): {g.nq / s:.1f} qps ({s * 1e3:.4f} ms a "
        f"{g.nq}-query call over {dataset.shape[0]} rows, {len(w_qps)} windows of "
        f"{g.batch_reps} calls; window qps {min(w_qps):.1f} .. {max(w_qps):.1f}); beside it "
        f"knn l1 {out['knn_l1']['qps']:.1f} qps; ids equal to the truth")

    tile = pt.pairwise_tiled(*out["tile_inputs"], "l1")
    tile = tile[:, :tile.shape[1] // 128 * 128].contiguous()
    _launch.reset_launch_counts()
    cv, ci = select_k(tile, k, strategy="counting", device=dev)
    sync()
    out["launches"][("select_k", "counting")] = _launch.launch_counts()
    tv, ti = select_k(tile, k, strategy="topk", device=dev)
    require_equal("select_k counting vs topk (L1 tile)", (cv, ci), (tv, ti))
    out["tile"] = tile
    log(f"path select_k counting on the first L1 tile {tuple(tile.shape)}, k {k}: ids and "
        f"values equal to strategy='topk'")

    index = res["index"]
    strict_f32_matmul()
    v_rot = dataset @ index.rotation.T
    centers = index.centers
    _launch.reset_launch_counts()
    labels = fused_l2_nn_argmin(v_rot, centers, device=dev)
    dist, _ = fused_l2_nn(v_rot[:16384], centers, device=dev)
    sync()
    out["launches"][("fused_l2_nn", "argmin")] = _launch.launch_counts()
    ref = kmeans_balanced.predict(v_rot, centers, device=dev)
    differ = (labels.long() != ref).nonzero()[:, 0]
    if differ.numel():
        rows = v_rot[differ].double()
        da = ((rows - centers[labels[differ].long()].double()) ** 2).sum(1)
        db = ((rows - centers[ref[differ]].double()) ** 2).sum(1)
        if bool(((da - db).abs() > 1e-5 * torch.maximum(da, db)).any()):
            raise AssertionError("fused_l2_nn labels differ from kmeans_balanced.predict away "
                                 "from float64 near-ties")
    label_agree = 1.0 - differ.numel() / labels.numel()
    # float64 distance to the nearest centre against rtol 1e-5 plus the f32
    # expanded form's own rounding floor (`expanded_floor`): a row that
    # sits on a centre (a singleton list) is 0 in float64, ~eps |x|^2 in f32
    x64 = v_rot[:16384].cpu().numpy().astype(np.float64)
    c64 = centers.cpu().numpy().astype(np.float64)
    full = (x64 * x64).sum(1)[:, None] + (c64 * c64).sum(1)[None, :] - 2.0 * x64 @ c64.T
    near = full.argmin(1)
    d64 = ((x64 - c64[near]) ** 2).sum(1)
    floor = expanded_floor(torch.from_numpy(x64), torch.from_numpy(c64[near])).numpy()
    err = np.abs(dist.cpu().numpy().astype(np.float64) - d64)
    if bool((err > 1e-5 * d64 + floor).any()):
        raise AssertionError(f"fused_l2_nn distances differ from float64 beyond rtol 1e-5 and "
                             f"the f32 floor (max abs error {err.max()})")
    away = d64 >= 100 * floor  # rows whose distance is not cancellation-dominated
    rel = float((err[away] / d64[away]).max()) if away.any() else 0.0
    over = int((err > 1e-5 * d64).sum())
    # the labelling call itself (host clock, g.reps calls, one sync)
    t0 = time.perf_counter()
    for _ in range(g.reps):
        fused_l2_nn_argmin(v_rot, centers, device=dev)
    sync()
    label_ms = (time.perf_counter() - t0) / g.reps * 1e3
    out["fused_l2_nn"] = {"label_agreement": label_agree, "differing_rows": int(differ.numel()),
                          "dist_max_rel_err": rel, "rows_past_rtol_within_floor": over,
                          "labelling_ms": label_ms}
    out["rotated"], out["centers"] = v_rot, centers
    log(f"path fused_l2_nn: labels of {labels.numel()} rotated rows vs kmeans_balanced.predict: "
        f"agreement {label_agree:.6f} ({differ.numel()} rows differ, all float64 near-ties); "
        f"distances vs numpy float64 on 16384 rows: max relative error {rel:.3e} (rows at "
        f"least 100 floors from a centre), {over} rows past rtol 1e-5 and within the f32 floor "
        f"of the expanded form; labelling {label_ms:.4f} ms a call of {v_rot.shape[0]} rows "
        f"against {centers.shape[0]} centres (mean of {g.reps})")
    return out


def rabitq_path(g, dev, res, fs, sync):
    """IVF-RaBitQ on the main path's data, queries and truth, one path
    with its launch counts set to 0 just before the build and read just
    after the ladder: build (n_lists g.n_lists, kmeans_n_iters 10), then
    the ladder of bench/bench_ivf_rabitq.py:141-154 (n_probes 8/16/32/64 x
    rerank_mult 4/8/16/25, stopping at the first rung with recall@k >=
    RECALL_GATE) with scan_engine="fused" and the exact rerank through
    refine; each rung's QPS over g.windows windows of g.batch_reps
    back-to-back batches. Then, once at n_probes 8 and rerank_mult 4, the
    "xla" engine against the fused one on the estimator-ranked
    candidates: the share of equal ids and the largest value gap."""
    from raft_tpu_torch.neighbors import ivf_rabitq
    from raft_tpu_torch.ops import _launch

    dataset, queries, truth = res["dataset"], res["queries"], res["truth"]
    _launch.reset_launch_counts()
    t0 = time.perf_counter()
    index = ivf_rabitq.build(ivf_rabitq.IndexParams(n_lists=g.n_lists, kmeans_n_iters=10),
                             dataset, seed=g.seed, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    log(f"rabitq build: {index} in {build_s:.3f} s, max list {int(index.list_sizes.max())}, "
        f"words {index.words}")
    rungs, captured, gate, gate_call = [], None, None, None
    for n_probes in (8, 16, 32, 64):
        for mult in (4, 8, 16, 25):
            params = ivf_rabitq.SearchParams(n_probes=n_probes, rerank_mult=mult,
                                             scan_engine="fused")

            def run():
                return ivf_rabitq.search(params, index, queries, g.k)

            with Spy(fs, "fused_bitplane_topk") as spy:
                _, ids = run()
                sync()
            if captured is None:
                captured = spy.calls[0]
            r = recall(ids, truth)
            sec, w_qps = timed_windows(g, run, sync)
            log(f"rung rabitq fused n_probes={n_probes} rerank_mult={mult} + rerank: "
                f"recall@{g.k} {r:.4f}, {g.nq / sec:.1f} qps ({sec * 1e3:.4f} ms per "
                f"{g.nq}-query batch over {len(w_qps)} windows of {g.batch_reps} batches; "
                f"window qps {min(w_qps):.1f} .. {max(w_qps):.1f})")
            rungs.append({"n_probes": n_probes, "rerank_mult": mult, "recall": r,
                          "qps": g.nq / sec, "batch_s": sec, "window_qps": w_qps})
            if r >= RECALL_GATE:
                gate, gate_call = rungs[-1], spy.calls[0]
                break
        if gate:
            break
    launches = _launch.launch_counts()
    log(f"path rabitq fused: launches {launches}, gate rung "
        + (f"n_probes {gate['n_probes']} rerank_mult {gate['rerank_mult']} recall@{g.k} "
           f"{gate['recall']:.4f}, {gate['batch_s'] * 1e3:.4f} ms a {g.nq}-query batch, "
           f"{gate['qps']:.1f} qps" if gate else "none"))
    if gate is None:
        raise AssertionError(f"rabitq fused: no rung reached recall@{g.k} >= {RECALL_GATE}")
    gate_params = ivf_rabitq.SearchParams(n_probes=gate["n_probes"],
                                          rerank_mult=gate["rerank_mult"], scan_engine="fused")

    def gate_run():
        return ivf_rabitq.search(gate_params, index, queries, g.k)

    breakdown = None
    if dev.type == "cuda":
        breakdown = device_breakdown(
            gate_run, g.batch_reps, gate["batch_s"] * 1e3,
            label=f"rabitq gate rung n_probes {gate['n_probes']} rerank_mult "
                  f"{gate['rerank_mult']}")
    qconsts = query_consts_cost(ivf_rabitq, gate_run, g.reps, gate["batch_s"] * 1e3, dev, sync)

    # the two scan engines on the estimator ranking (no rerank)
    kk = ivf_rabitq.rerank_depth(g.k, 4)
    t0 = time.perf_counter()
    xv, xr = ivf_rabitq._search_impl_rabitq(queries, index.rotation, index.centers, index.codes,
                                             index.aux, index.slot_rows, kk, 8, index.metric)
    sync()
    xla_s = time.perf_counter() - t0
    fv, fr = ivf_rabitq._search_impl_rabitq_fused(queries, index.rotation, index.centers,
                                                   index.codes_t, index.bp_meta,
                                                   index.slot_rows_pad, kk, 8, index.metric,
                                                   kb=index.fused_kb)
    sync()
    same = float((xr == fr).float().mean())
    fin = torch.isfinite(xv) & torch.isfinite(fv)
    gap = float(torch.where(fin, (xv - fv).abs(), 0.0).max())
    bitwise = float((xv.contiguous().view(torch.int32) == fv.contiguous().view(torch.int32))
                    .float().mean())
    log(f"rabitq xla vs fused engine, n_probes 8, {kk} estimator-ranked candidates of "
        f"{queries.shape[0]} queries: equal ids {same:.6f}, bitwise-equal values {bitwise:.6f}, "
        f"largest value gap {gap}; xla engine {xla_s:.3f} s for the batch")
    return {"build_s": build_s, "rungs": rungs, "gate": gate, "launches": launches,
            "breakdown": breakdown, "query_consts": qconsts, "index": index,
            "xla_vs_fused": {"equal_ids": same, "equal_value_bits": bitwise, "max_gap": gap,
                             "xla_s": xla_s}}, (captured, gate_call)


def ivf_flat_path(g, dev, res, fs, sync):
    """IVF-Flat on the main path's data, queries and truth, one path with
    its launch counts set to 0 just before the build and read just after
    the last engine: build (n_lists g.n_lists, kmeans_n_iters 10, as
    bench/bench_neighbors.py:86-124), then each engine of FLAT_ENGINES over
    the n_probes ladder FLAT_PROBES up to the first rung at recall@k >=
    RECALL_GATE, and always n_probes 32, the bench's own setting. QPS over
    g.windows windows of g.batch_reps back-to-back batches; the "query"
    engine over one window of QUERY_ENGINE_BATCHES batches. "auto" prints
    what it resolved to. Then one n_probes-32 batch of the fused engine
    under torch.profiler."""
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import _launch

    dataset, queries, truth = res["dataset"], res["queries"], res["truth"]
    _launch.reset_launch_counts()
    t0 = time.perf_counter()
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=g.n_lists, kmeans_n_iters=10), dataset,
                           seed=g.seed, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    built_width = int(index.list_data.shape[1])  # before a fused search pads it
    log(f"ivf_flat build: {index} in {build_s:.3f} s, max list {int(index.list_sizes.max())}, "
        f"width {built_width}")
    rungs, captured = [], None
    for engine in FLAT_ENGINES:
        gw = g if engine != "query" else argparse.Namespace(
            **{**vars(g), "windows": 1, "batch_reps": QUERY_ENGINE_BATCHES})
        cleared = False
        for n_probes in FLAT_PROBES:
            if cleared and n_probes != 32:
                continue
            params = ivf_flat.SearchParams(n_probes=n_probes, engine=engine)

            def run():
                return ivf_flat.search(params, index, queries, g.k)

            with Spy(fs, "fused_list_topk") as spy:
                _, ids = run()
                sync()
            if engine == "fused" and n_probes == 32:
                captured = spy.calls[0]
            r = recall(ids, truth)
            sec, w_qps = timed_windows(gw, run, sync)
            resolved = (ivf_flat.resolve_auto_engine(g.nq, n_probes, index.n_lists)
                        if engine == "auto" else engine)
            log(f"rung ivf_flat engine={engine}" + (f" (resolved to {resolved!r})"
                                                   if engine == "auto" else "")
                + f" n_probes={n_probes}: recall@{g.k} {r:.4f}, {g.nq / sec:.1f} qps "
                f"({sec * 1e3:.4f} ms per {g.nq}-query batch over {len(w_qps)} window(s) of "
                f"{gw.batch_reps} batches; window qps {min(w_qps):.1f} .. {max(w_qps):.1f})")
            rungs.append({"engine": engine, "resolved": resolved, "n_probes": n_probes,
                          "recall": r, "qps": g.nq / sec, "batch_s": sec, "window_qps": w_qps,
                          "windows": len(w_qps), "batches_a_window": gw.batch_reps})
            cleared = cleared or r >= RECALL_GATE
        best = max(x["recall"] for x in rungs if x["engine"] == engine)
        if best < RECALL_GATE:
            raise AssertionError(f"ivf_flat engine={engine}: no rung reached recall@{g.k} >= "
                                 f"{RECALL_GATE} (best {best})")
    launches = _launch.launch_counts()
    log(f"path ivf_flat: launches {launches}; fused_list_topk launched by the fused engine "
        f"only (list, query and auto={rungs[-1]['resolved']!r} run torch operations)")
    breakdown = None
    if dev.type == "cuda":
        p32 = ivf_flat.SearchParams(n_probes=32, engine="fused")
        b32 = next(x for x in rungs if x["engine"] == "fused" and x["n_probes"] == 32)
        breakdown = device_breakdown(lambda: ivf_flat.search(p32, index, queries, g.k), 1,
                                     b32["batch_s"] * 1e3, label="ivf_flat fused, n_probes 32",
                                     top=20)
    return {"build_s": build_s, "rungs": rungs, "launches": launches, "breakdown": breakdown,
            "index": index, "max_list": int(index.list_sizes.max()),
            "built_width": built_width}, captured


#: the n_probes ladder a filtered search steps up when it falls short
PROBE_LADDER = (8, 16, 32, 64)


def first_cleared(rungs, **match):
    """The smallest n_probes of the `rungs` matching `match` whose recall
    cleared RECALL_GATE."""
    return min(x["n_probes"] for x in rungs if x["recall"] >= RECALL_GATE
               and all(x.get(key) == v for key, v in match.items()))


def prefilter_path(g, dev, res, flat, rb, sync):
    """The filtered searches on the main path's data, one path with its
    launch counts set to 0 just before it and read just after. One seeded
    bitset keeps half of the ids. brute_force.knn(engine="fused") with it
    is the filtered truth, cross-checked against the tiled engine on 16
    queries (agreement >= 0.95: bf16 operands against f32). Then IVF-Flat
    "fused", IVF-PQ trim "fused" on bf16 rows (4k shortlist + refine) and
    IVF-RaBitQ "fused" (with its rerank), each at the rung where its
    unfiltered search first cleared RECALL_GATE: every id returned must
    pass the filter, and recall@k against the filtered truth must reach
    RECALL_GATE, else n_probes steps up one rung (PROBE_LADDER), said in
    the log."""
    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq, ivf_rabitq
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops import _launch

    dataset, queries, k = res["dataset"], res["queries"], g.k
    keep = np.random.default_rng(g.seed + 9).random(dataset.shape[0]) < 0.5
    bs = Bitset.from_mask(torch.from_numpy(keep), device=dev)
    out = {"kept": int(bs.count())}

    def passes(ids):
        ids = ids.reshape(-1)
        return bool(bs.test(ids[ids >= 0]).all())

    _launch.reset_launch_counts()
    t0 = time.perf_counter()
    _, ftruth = brute_force.knn(dataset, queries, k, engine="fused", prefilter=bs, device=dev)
    sync()
    out["truth_s"] = time.perf_counter() - t0
    if not passes(ftruth) or bool((ftruth < 0).any()):
        raise AssertionError("filtered truth: ids fail the filter or fall short of k")
    _, tiled = brute_force.knn(dataset, queries[:16], k, engine="tiled", prefilter=bs, device=dev)
    agree = recall(tiled, ftruth[:16])
    out["truth_tiled_agreement"] = agree
    log(f"path prefilter: {out['kept']} of {dataset.shape[0]} ids kept; filtered truth "
        f"(brute_force.knn fused) in {out['truth_s']:.3f} s, every id passes; against the "
        f"tiled engine on 16 queries: agreement {agree:.4f}")
    if agree < 0.95 or not passes(tiled):
        raise AssertionError(f"filtered truth disagrees with the tiled engine: {agree}")

    def ladder(name, start, search):
        """Run `search(n_probes)` from `start` up PROBE_LADDER until recall
        against the filtered truth reaches the gate."""
        steps = [p for p in PROBE_LADDER if p >= start]
        for n_probes in steps:
            _, ids = search(n_probes)
            sync()
            if not passes(ids):
                raise AssertionError(f"{name}: a returned id fails the filter")
            r = recall(ids, ftruth)
            note = "" if n_probes == start else f" (stepped up from n_probes {start})"
            log(f"path prefilter {name} n_probes={n_probes}{note}: recall@{k} against the "
                f"filtered truth {r:.4f}, every id passes the filter")
            if r >= RECALL_GATE:
                return {"n_probes": n_probes, "start": start, "recall": r}
        raise AssertionError(f"{name}: recall under the filter below {RECALL_GATE} up to "
                             f"n_probes {steps[-1]}")

    out["ivf_flat"] = ladder(
        "ivf_flat fused", first_cleared(flat["rungs"], engine="fused"),
        lambda p: ivf_flat.search(ivf_flat.SearchParams(n_probes=p, engine="fused"),
                                  flat["index"], queries, k, prefilter=bs))
    pq_index = res["index"]
    out["ivf_pq"] = ladder(
        "ivf_pq fused bf16 + refine", first_cleared(res["rungs"], trim="fused",
                                                    score_dtype="bf16"),
        lambda p: refine(dataset, queries, ivf_pq.search(
            ivf_pq.SearchParams(n_probes=p, score_mode="recon8_list", trim_engine="fused"),
            pq_index, queries, 4 * k, prefilter=bs)[1], k, strategy="fused", device=dev))
    gate = rb["gate"]
    out["ivf_rabitq"] = ladder(
        f"ivf_rabitq fused rerank_mult {gate['rerank_mult']}", gate["n_probes"],
        lambda p: ivf_rabitq.search(
            ivf_rabitq.SearchParams(n_probes=p, rerank_mult=gate["rerank_mult"],
                                    scan_engine="fused"), rb["index"], queries, k,
            prefilter=bs))
    out["launches"] = _launch.launch_counts()
    log(f"path prefilter: launches {out['launches']}")
    return out


#: n_probes of the small-batch searches (an online caller's few queries:
#: nq * 20 / 1024 = 2.5 at nq 128, so the default resolves to "lut")
SMALL_PROBES = 20
#: batches a timing of a slow engine takes (one window)
SLOW_BATCHES = 3
#: the n_probes ladder of the index past 1024 lists
WIDE_PROBES = (8, 16, 32, 64, 128)


def pq_modes_path(g, dev, res, fs, pls, sync):
    """IVF-PQ's full search surface on the main path's data, queries and
    truth, five paths, each with its launch counts set to 0 just before it
    and read just after:
      1. ("pq_default", "approx"): the JAX bench's own ladder,
         SearchParams(n_probes=p) with every other field at its default
         (at nq g.nq: recon8_list, trim "approx", f32 scores; the resolution
         is logged), n_probes up PROBE_LADDER to the first rung at
         recall@k >= RECALL_GATE, each with a 4k shortlist and
         refine(strategy="fused"); QPS over windows; the gate batch under
         torch.profiler; at the gate rung also trim "exact", bf16 trim
         scores and score_mode "recon8" (one window of SLOW_BATCHES);
      2. ("pq_small", "nq"): g.small_nq queries at n_probes SMALL_PROBES:
         the default (it resolves to "lut"), the bf16 LUT, "recon8" and
         the fused trim, each + refine, recall against those queries'
         truth, ms a batch;
      3. ("per_cluster", "all"): the main path's IndexParams with
         codebook_kind="per_cluster" (build seconds), the fused bf16,
         fused int8 and pallas bf16 ladders + refine to the gate, and the
         lut engine at g.small_nq; the trims' first kernel calls kept for
         phase 5;
      4. ("pq_wide", "fused"): IVF-PQ with n_lists g.wide_lists (past
         1024: kmeans_balanced.fit_hierarchical), pq_dim g.dim // 2,
         kmeans_n_iters 10 (build seconds, largest and smallest list), the
         fused bf16 ladder WIDE_PROBES + refine to the gate;
      5. Lloyd k-means, kmeans.fit(n_clusters=g.n_lists, max_iter=20,
         init="k-means++") on every row: seconds, n_iter, inertia, and the
         cost of kmeans_balanced.fit's centers (20 iterations) beside it.
         No kernel: the assignment is a matmul, as in the JAX package.
    Any gate missed raises."""
    from raft_tpu_torch.cluster import kmeans, kmeans_balanced
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops import _launch

    dataset, queries, truth, index = res["dataset"], res["queries"], res["truth"], res["index"]
    slow = argparse.Namespace(**{**vars(g), "windows": 1, "batch_reps": SLOW_BATCHES})
    out, launches, calls = {}, {}, {}

    def measure(label, params, idx, qs, tr, gw, spy=None):
        """Recall and batch time of search(params) + refine on qs."""
        def run():
            _, cand = ivf_pq.search(params, idx, qs, 4 * g.k)
            return refine(dataset, qs, cand, g.k, strategy="fused", device=dev)

        with contextlib.ExitStack() as stack:
            if spy is not None:
                stack.enter_context(spy)
            _, ids = run()
            sync()
        r = recall(ids, tr)
        gq = argparse.Namespace(**{**vars(gw), "nq": qs.shape[0]})
        sec, w_qps = timed_windows(gq, run, sync)
        n_probes = min(params.n_probes, idx.n_lists)
        mode, trim, idd = ivf_pq.resolve_search(params, qs.shape[0], n_probes, idx.n_lists)
        log(f"rung {label} n_probes={n_probes} (score_mode {mode}, trim {trim}, distances "
            f"{idd}, score_dtype {params.score_dtype}, lut {params.lut_dtype}) + refine, nq "
            f"{qs.shape[0]}: recall@{g.k} {r:.4f}, {qs.shape[0] / sec:.1f} qps ({sec * 1e3:.4f} "
            f"ms a batch over {len(w_qps)} window(s) of {gq.batch_reps} batches; window qps "
            f"{min(w_qps):.1f} .. {max(w_qps):.1f})")
        return {"label": label, "n_probes": n_probes, "score_mode": mode, "trim": trim,
                "distances": idd, "nq": qs.shape[0], "recall": r, "qps": qs.shape[0] / sec,
                "batch_s": sec, "window_qps": w_qps, "run": run}

    def ladder(label, probes, make, idx, spy_of=None):
        """Rungs of make(n_probes) up `probes` to the first at the gate;
        the first rung's kernel call kept when `spy_of` names one."""
        rungs = []
        for n_probes in probes:
            spy = spy_of() if spy_of is not None and not rungs else None
            rungs.append(measure(label, make(n_probes), idx, queries, truth, g, spy))
            if spy is not None:
                calls[label] = spy.calls[0]
            if rungs[-1]["recall"] >= RECALL_GATE:
                return rungs
        raise AssertionError(f"{label}: no rung reached recall@{g.k} >= {RECALL_GATE} "
                             f"(best {max(x['recall'] for x in rungs)})")

    def strip(rows):
        return [{key: v for key, v in x.items() if key != "run"} for x in rows]

    # 1. the default-params ladder
    _launch.reset_launch_counts()
    rungs = ladder("ivf_pq default", PROBE_LADDER, lambda p: ivf_pq.SearchParams(n_probes=p),
                   index)
    gate = rungs[-1]
    breakdown = None
    if dev.type == "cuda":
        breakdown = device_breakdown(gate["run"], 2, gate["batch_s"] * 1e3,
                                     label=f"ivf_pq default n_probes {gate['n_probes']} + "
                                           "refine", top=12)
    variants = [measure(label, ivf_pq.SearchParams(n_probes=gate["n_probes"], **kw), index,
                        queries, truth, slow)
                for label, kw in (("ivf_pq trim exact", {"trim_engine": "exact"}),
                                  ("ivf_pq bf16 distances",
                                   {"internal_distance_dtype": "bfloat16"}),
                                  ("ivf_pq recon8", {"score_mode": "recon8"}))]
    launches[("pq_default", "approx")] = _launch.launch_counts()
    out["default"] = {"rungs": strip(rungs), "gate_variants": strip(variants),
                      "breakdown": breakdown}

    # 2. small batches
    _launch.reset_launch_counts()
    qs, tr = queries[:g.small_nq], truth[:g.small_nq]
    small = [measure(label, ivf_pq.SearchParams(n_probes=SMALL_PROBES, **kw), index, qs, tr, g)
             for label, kw in (("small default", {}),
                               ("small lut bf16", {"score_mode": "lut",
                                                   "lut_dtype": "bfloat16"}),
                               ("small recon8", {"score_mode": "recon8"}),
                               ("small fused", {"score_mode": "recon8_list",
                                                "trim_engine": "fused"}))]
    if small[0]["score_mode"] != "lut":
        raise AssertionError(f"nq {g.small_nq} at n_probes {SMALL_PROBES} resolved to "
                             f"{small[0]['score_mode']}, not lut")
    launches[("pq_small", "nq")] = _launch.launch_counts()
    out["small"] = strip(small)
    for x in small:
        if x["recall"] < RECALL_GATE:
            raise AssertionError(f"{x['label']}: recall@{g.k} {x['recall']} < {RECALL_GATE}")

    # 3. per-cluster codebooks
    _launch.reset_launch_counts()
    t0 = time.perf_counter()
    pc = ivf_pq.build(ivf_pq.IndexParams(n_lists=g.n_lists, pq_dim=g.dim // 2, kmeans_n_iters=10,
                                         codebook_kind="per_cluster"),
                      dataset, seed=g.seed, device=dev)
    sync()
    pc_build_s = time.perf_counter() - t0
    log(f"per-cluster build: {pc} in {pc_build_s:.3f} s, codebooks "
        f"{tuple(pc.pq_centers.shape)}, max list {int(pc.list_sizes.max())}")
    pc_rungs = []
    for trim, dtype, spy_of in (("fused", "bf16", lambda: Spy(fs, "fused_list_topk")),
                                ("fused", "int8", lambda: Spy(fs, "fused_list_topk_int8")),
                                ("pallas", "bf16", lambda: Spy(pls, "pq_list_scan"))):
        pc_rungs += ladder(f"per_cluster {trim} {dtype}", PROBE_LADDER,
                           lambda p, t=trim, d=dtype: ivf_pq.SearchParams(
                               n_probes=p, score_mode="recon8_list", trim_engine=t,
                               score_dtype=d), pc, spy_of)
    pc_lut = measure("per_cluster small lut", ivf_pq.SearchParams(n_probes=SMALL_PROBES,
                                                                  score_mode="lut"),
                     pc, qs, tr, g)
    if pc_lut["recall"] < RECALL_GATE:
        raise AssertionError(f"per-cluster lut: recall@{g.k} {pc_lut['recall']}")
    launches[("per_cluster", "all")] = _launch.launch_counts()
    out["per_cluster"] = {"build_s": pc_build_s, "rungs": strip(pc_rungs),
                          "small_lut": strip([pc_lut])[0]}

    # 4. past 1024 lists
    _launch.reset_launch_counts()
    t0 = time.perf_counter()
    wide = ivf_pq.build(ivf_pq.IndexParams(n_lists=g.wide_lists, pq_dim=g.dim // 2,
                                           kmeans_n_iters=10), dataset, seed=g.seed, device=dev)
    sync()
    wide_build_s = time.perf_counter() - t0
    sizes = wide.list_sizes
    log(f"wide build: {wide} in {wide_build_s:.3f} s (fit_hierarchical), largest list "
        f"{int(sizes.max())}, smallest {int(sizes.min())}, slot width {int(wide.codes.shape[1])}")
    if not bool(torch.isfinite(wide.centers).all()):
        raise AssertionError("wide build: non-finite centers")
    wide_rungs = ladder(f"ivf_pq {g.wide_lists} lists fused bf16", WIDE_PROBES,
                        lambda p: ivf_pq.SearchParams(n_probes=p, score_mode="recon8_list",
                                                      trim_engine="fused"),
                        wide, lambda: Spy(fs, "fused_list_topk"))
    calls["wide"] = calls.pop(f"ivf_pq {g.wide_lists} lists fused bf16")
    launches[("pq_wide", "fused")] = _launch.launch_counts()
    out["wide"] = {"n_lists": g.wide_lists, "build_s": wide_build_s,
                   "largest_list": int(sizes.max()), "smallest_list": int(sizes.min()),
                   "rungs": strip(wide_rungs)}

    # 5. Lloyd k-means
    t0 = time.perf_counter()
    centers, inertia, n_iter = kmeans.fit(dataset, n_clusters=g.n_lists, max_iter=20,
                                          init="k-means++", seed=g.seed, device=dev)
    sync()
    lloyd_s = time.perf_counter() - t0
    lloyd_cost = kmeans.cluster_cost(dataset, centers, device=dev)
    t0 = time.perf_counter()
    bal = kmeans_balanced.fit(dataset, g.n_lists, n_iters=20, seed=g.seed, device=dev)
    sync()
    bal_s = time.perf_counter() - t0
    bal_cost = kmeans.cluster_cost(dataset, bal, device=dev)
    log(f"lloyd kmeans.fit(n_clusters={g.n_lists}, max_iter=20, init='k-means++') on "
        f"{dataset.shape[0]} rows: {lloyd_s:.3f} s, n_iter {n_iter}, inertia {inertia}, cost "
        f"of its centers {lloyd_cost}; kmeans_balanced.fit (20 iterations) {bal_s:.3f} s, "
        f"cost {bal_cost}")
    if not (np.isfinite(inertia) and 1 <= n_iter <= 20 and bool(torch.isfinite(centers).all())
            and lloyd_cost <= inertia * (1 + 1e-4)):
        raise AssertionError(f"lloyd: inertia {inertia}, n_iter {n_iter}, cost {lloyd_cost}")
    out["lloyd"] = {"seconds": lloyd_s, "n_iter": n_iter, "inertia": inertia,
                    "cost": lloyd_cost, "balanced_s": bal_s, "balanced_cost": bal_cost}
    out["launches"] = launches
    return out, calls


# ---------------------------------------------------------------------------
# phase 4: live mutation and persistence on the three 1M-row indexes
# ---------------------------------------------------------------------------


def bit_equal(a, b) -> bool:
    """Two (values, ids) results equal bit for bit."""
    return (torch.equal(a[1], b[1])
            and torch.equal(a[0].contiguous().view(torch.int32),
                            b[0].contiguous().view(torch.int32)))


def blob_rows(seed, n_blobs, dim, n, rng):
    """`n` fresh rows of make_blobs' blobs (the same centres from `seed`,
    new unit noise from `rng`)."""
    centers = np.random.default_rng(seed).uniform(-5.0, 5.0, (n_blobs, dim)).astype(np.float32)
    rows = centers[rng.integers(0, n_blobs, n)]
    return rows + rng.standard_normal((n, dim), dtype=np.float32)


def mutation_path(g, dev, res, fl, rb, sync):
    """Live mutation and persistence (neighbors/mutation, core/serialize)
    on the three 1M-row indexes of phase 4, one path with its launch
    counts set to 0 just before it and read just after. Each family
    searches at its phase-4 gate rung with its engine by name (IVF-PQ
    trim "fused" on bf16 rows + refine(strategy="fused"), IVF-Flat
    "fused", RaBitQ scan "fused" with its rerank); the indexes of `res`,
    `fl` and `rb` are only read (mutations return new objects), which is
    asserted on their slot_rows and one payload table at the end.
      1. From --seed: delete 10% of the ids, upsert 5% others with fresh
         rows of the same blobs, insert 5% new rows (ids=None), after
         ensure_append_slack(64); each call timed.
      2. The live truth: an (id_bound, dim) id-indexed table on the card
         (original rows, upserted ids' new rows, inserted rows),
         brute_force.knn(engine="fused") over it with the deleted ids
         excluded by its `valid` operand; refine reads that table.
      3. Gates per family: no deleted id returned; an upserted id re-ranked
         (IVF-PQ's refine, RaBitQ's rerank) returns its new row's
         distance (float64 over the rows the re-rank reads, to 1e-5 of
         |q|^2 + |v|^2); recall@k >= RECALL_GATE against the live truth;
         delete(index, v) searches bit for bit like search(index,
         prefilter=Bitset.excluding(id_bound, v)); after compact: no
         tombstones, live rows unchanged, recall within 0.002 of the
         search before, values within VAL_RTOL and ids equal but within a
         group of equal values.
      4. Save each mutated index to a temporary directory and load it onto
         the card: the search equal bit for bit (RaBitQ with the rows as
         refine_dataset on both sides); seconds, bytes and GB/s.
      5. A Mutator over IVF-Flat (ckpt_every 4): upsert, delete, upsert,
         delete, rebalance, upsert; a cold resume from the directory
         equals it bit for bit (slot_rows, tombstones, list_sizes,
         source_ids, the search).
    Times: ms a batch before mutation, the first batch after it (the
    derived store's rebuild included), steady batches after it (dead slots
    still scanned), the first and steady batches after compact (the three
    steady states timed in turns, the better of two windows each), and
    the seconds of compact."""
    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq, ivf_rabitq, mutation
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops import _launch
    from raft_tpu_torch.ops import fused_scan as fs

    dataset, queries, k = res["dataset"], res["queries"], g.k
    n, dim = dataset.shape
    originals = {"ivf_pq": res["index"], "ivf_flat": fl["index"], "ivf_rabitq": rb["index"]}
    payload = {"ivf_pq": "codes", "ivf_flat": "list_data", "ivf_rabitq": "codes"}
    kept = {f: (idx.slot_rows.clone(), getattr(idx, payload[f]).clone())
            for f, idx in originals.items()}

    p_pq = first_cleared(res["rungs"], trim="fused", score_dtype="bf16")
    p_fl = first_cleared(fl["rungs"], engine="fused")
    gate = rb["gate"]
    pq_params = ivf_pq.SearchParams(n_probes=p_pq, score_mode="recon8_list", trim_engine="fused")
    fl_params = ivf_flat.SearchParams(n_probes=p_fl, engine="fused")
    rb_params = ivf_rabitq.SearchParams(n_probes=gate["n_probes"],
                                        rerank_mult=gate["rerank_mult"], scan_engine="fused")
    rung = {"ivf_pq": f"trim fused bf16 n_probes {p_pq} + refine",
            "ivf_flat": f"fused n_probes {p_fl}",
            "ivf_rabitq": f"fused n_probes {gate['n_probes']} rerank_mult {gate['rerank_mult']}"}

    def searcher(fam, idx, table=None, prefilter=None, rows=None):
        """One batch of `fam` at its gate rung on `idx`: IVF-PQ refines over
        `table` (ids index it), RaBitQ re-ranks over `rows` (positions)."""
        if fam == "ivf_pq":
            return lambda: refine(table, queries, ivf_pq.search(
                pq_params, idx, queries, 4 * k, prefilter=prefilter)[1], k, strategy="fused",
                device=dev)
        if fam == "ivf_flat":
            return lambda: ivf_flat.search(fl_params, idx, queries, k, prefilter=prefilter)
        return lambda: ivf_rabitq.search(rb_params, idx, queries, k, prefilter=prefilter,
                                         refine_dataset=rows)

    def first_ms(run):
        sync()
        t0 = time.perf_counter()
        out = run()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def steady_ms(run):
        return timed_windows(g, run, sync)[0] * 1e3

    out = {"rungs": rung}
    _launch.reset_launch_counts()
    t_path = time.perf_counter()

    # 1. the script, from --seed
    rng = np.random.default_rng(g.seed + 12)
    n_del, n_up, n_new = n // 10, n // 20, n // 20
    perm = rng.permutation(n).astype(np.int32)
    deleted, upserted = perm[:n_del], perm[n_del:n_del + n_up]
    up_rows = torch.from_numpy(blob_rows(g.seed, g.n_lists, dim, n_up, rng)).to(dev)
    new_rows = torch.from_numpy(blob_rows(g.seed, g.n_lists, dim, n_new, rng)).to(dev)
    deleted_t = torch.from_numpy(deleted).to(dev)
    upserted_t = torch.from_numpy(upserted).to(dev)

    # 2. the live truth over the id-indexed table (ids n .. n + n_new inserted)
    id_bound = n + n_new
    table_rows = torch.cat([dataset, new_rows])
    table_rows[upserted_t.long()] = up_rows
    live = torch.ones(id_bound, dtype=torch.bool, device=dev)
    live[deleted_t.long()] = False
    live_bs = Bitset.from_mask(live)
    with Spy(fs, "fused_topk") as truth_spy:
        (_, truth), truth_ms = first_ms(lambda: brute_force.knn(
            table_rows, queries, k, engine="fused", prefilter=live_bs, device=dev))
    if bool(torch.isin(truth, deleted_t).any()) or bool((truth < 0).any()):
        raise AssertionError("live truth: a deleted id or a short row")
    log(f"path mutation: delete {n_del}, upsert {n_up}, insert {n_new} of {n} ids; live truth "
        f"(brute_force.knn fused over the {id_bound} x {dim} id table, valid = live ids) in "
        f"{truth_ms:.3f} ms")

    mutated, timing, calls = {}, {}, {}
    for fam, idx in originals.items():
        rows0 = idx.dataset if fam == "ivf_rabitq" else None
        _, before_first = first_ms(searcher(fam, idx, dataset, rows=rows0))
        t = {}
        # delete equals the exclusion prefilter, bit for bit
        dead = mutation.delete(idx, deleted_t)
        a = searcher(fam, dead, dataset, rows=rows0)()
        b = searcher(fam, idx, dataset, rows=rows0,
                     prefilter=Bitset.excluding(idx.id_bound, deleted_t, device=dev))()
        if not bit_equal(a, b):
            raise AssertionError(f"{fam}: delete differs from the exclusion prefilter")
        # the script, each call timed
        cur = idx
        for name, op in (("slack_ms", lambda i: mutation.ensure_append_slack(i, 64)),
                         ("delete_ms", lambda i: mutation.delete(i, deleted_t)),
                         ("upsert_ms", lambda i: mutation.upsert(i, up_rows, upserted_t)),
                         ("insert_ms", lambda i: mutation.upsert(i, new_rows))):
            cur, t[name] = first_ms(lambda: op(cur))
        if cur.id_bound != id_bound or mutation.live_rows(cur) != n - n_del + n_new:
            raise AssertionError(f"{fam}: id_bound {cur.id_bound}, live rows "
                                 f"{mutation.live_rows(cur)}")
        rows = cur.dataset if fam == "ivf_rabitq" else None
        spy = (Spy(fs, "fused_bitplane_topk") if fam == "ivf_rabitq"
               else Spy(fs, "fused_list_topk"))
        with spy:
            (vals, ids), t["first_after_ms"] = first_ms(searcher(fam, cur, table_rows, rows=rows))
        if fam != "ivf_pq":
            calls[fam] = spy.calls[0]
        if bool(torch.isin(ids, deleted_t).any()):
            raise AssertionError(f"{fam}: a deleted id was returned")
        r = recall(ids, truth)
        # an upserted id re-ranked returns its new row's distance
        checked = 0
        if fam != "ivf_flat":
            hit = torch.isin(ids, upserted_t) & (ids >= 0)
            qi, ci = torch.nonzero(hit, as_tuple=True)
            got = vals[qi, ci].double()
            if fam == "ivf_pq":  # the fused refine: exact over bf16-rounded rows
                qv = queries[qi].to(torch.bfloat16).double()
                vv = table_rows[ids[qi, ci].long()].to(torch.bfloat16).double()
                ov = dataset[ids[qi, ci].long()].to(torch.bfloat16).double()
            else:
                qv, vv = queries[qi].double(), table_rows[ids[qi, ci].long()].double()
                ov = dataset[ids[qi, ci].long()].double()
            want = ((qv - vv) ** 2).sum(1)
            tol = VAL_RTOL * ((qv * qv).sum(1) + (vv * vv).sum(1))
            old = ((qv - ov) ** 2).sum(1)
            checked = int(hit.sum())
            if checked == 0 or bool(((got - want).abs() > tol).any()):
                raise AssertionError(f"{fam}: {checked} upserted ids re-ranked, largest gap "
                                     f"{float((got - want).abs().max()) if checked else None}")
            t["upserted_checked"] = checked
            t["old_row_would_differ"] = int(((got - old).abs() > tol).sum())
        if r < RECALL_GATE:
            raise AssertionError(f"{fam}: recall@{k} {r} against the live truth")
        # compact
        pre_live = mutation.live_rows(cur)
        packed, t["compact_ms"] = first_ms(lambda: mutation.compact(cur))
        if packed.tombstones is not None or mutation.live_rows(packed) != pre_live:
            raise AssertionError(f"{fam}: compact kept tombstones or lost live rows")
        (cv, cids), t["first_compact_ms"] = first_ms(searcher(fam, packed, table_rows,
                                                              rows=rows))
        # steady batches of the three states in turns (before, after,
        # compacted, then back), the better of each state's two windows
        turns = {"before_ms": searcher(fam, idx, dataset, rows=rows0),
                 "steady_after_ms": searcher(fam, cur, table_rows, rows=rows),
                 "steady_compact_ms": searcher(fam, packed, table_rows, rows=rows)}
        for name in list(turns) + list(turns)[::-1]:
            t[name] = min(t.get(name, float("inf")), steady_ms(turns[name]))
        rc = recall(cids, truth)
        if abs(rc - r) > 0.002 or not tie_equal(vals, ids, cv, cids, rtol=VAL_RTOL):
            raise AssertionError(f"{fam}: compact changed the search (recall {r} -> {rc})")
        t.update({"recall": r, "recall_compact": rc, "width": int(cur.slot_rows.shape[1]),
                  "width_compact": int(packed.slot_rows.shape[1]),
                  "dead_slots": cur.n_tombstones, "first_before_ms": before_first})
        log(f"path mutation {fam} ({rung[fam]}): ensure_append_slack {t['slack_ms']:.3f} ms, "
            f"delete {t['delete_ms']:.3f} ms, upsert {t['upsert_ms']:.3f} ms, insert "
            f"{t['insert_ms']:.3f} ms; recall@{k} against the live truth {r:.4f}, no deleted "
            f"id, delete == exclusion prefilter bit for bit"
            + (f", {checked} upserted ids at their new rows' distance" if checked else "")
            + f"; ms a batch: before {t['before_ms']:.4f}, first after the upsert "
            f"{t['first_after_ms']:.4f}, steady {t['steady_after_ms']:.4f} "
            f"({t['dead_slots']} dead slots of width {t['width']}); compact "
            f"{t['compact_ms']:.3f} ms -> width {t['width_compact']}, first "
            f"{t['first_compact_ms']:.4f}, steady {t['steady_compact_ms']:.4f}, recall {rc:.4f}")
        mutated[fam], timing[fam] = (cur, rows), t

    # 4. persistence on the card
    persist = {}
    with tempfile.TemporaryDirectory(prefix="raft_tpu_torch_mutation_") as tmp:
        for fam, (cur, rows) in mutated.items():
            mod = {"ivf_pq": ivf_pq, "ivf_flat": ivf_flat, "ivf_rabitq": ivf_rabitq}[fam]
            path = os.path.join(tmp, f"{fam}.ckpt")
            _, save_ms = first_ms(lambda: mod.save(path, cur))
            loaded, load_ms = first_ms(lambda: mod.load(path, device=dev))
            nbytes = os.path.getsize(path)
            a = searcher(fam, cur, table_rows, rows=rows)()
            b = searcher(fam, loaded, table_rows, rows=rows)()
            if loaded.device != dev or not bit_equal(a, b):
                raise AssertionError(f"{fam}: the loaded index searches differently")
            persist[fam] = {"bytes": nbytes, "save_s": save_ms / 1e3, "load_s": load_ms / 1e3,
                            "save_gb_s": nbytes / save_ms / 1e6, "load_gb_s": nbytes / load_ms / 1e6}
            log(f"path mutation {fam}: save {save_ms / 1e3:.3f} s, load onto {dev} "
                f"{load_ms / 1e3:.3f} s, {nbytes} bytes ({persist[fam]['save_gb_s']:.3f} / "
                f"{persist[fam]['load_gb_s']:.3f} GB/s); the loaded index searches bit for bit")
            del loaded

        # 5. the crash-atomic Mutator over IVF-Flat, then a cold resume
        root = os.path.join(tmp, "mutator")
        batch = max(1, n // 100)
        mrng = np.random.default_rng(g.seed + 13)
        ids_of = mrng.permutation(n).astype(np.int32)
        t0 = time.perf_counter()
        mut = mutation.Mutator(root, originals["ivf_flat"], ckpt_every=4)
        for step, op in enumerate(("upsert", "delete", "upsert", "delete", "rebalance",
                                   "upsert")):
            chunk = ids_of[step * batch:(step + 1) * batch]
            if op == "upsert":
                mut.upsert(blob_rows(g.seed, g.n_lists, dim, batch, mrng), chunk)
            elif op == "delete":
                mut.delete(chunk)
            else:
                mut.rebalance()
        sync()
        mutator_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = mutation.Mutator(root, kind="ivf_flat", device=dev)
        sync()
        resume_s = time.perf_counter() - t0
        for f in ("slot_rows", "list_sizes", "source_ids"):
            if not torch.equal(getattr(again.index, f), getattr(mut.index, f)):
                raise AssertionError(f"mutator resume: {f} differs")
        if not torch.equal(again.index.tombstones, mut.index.tombstones):
            raise AssertionError("mutator resume: tombstones differ")
        a = ivf_flat.search(fl_params, mut.index, queries, k)
        b = ivf_flat.search(fl_params, again.index, queries, k)
        if not bit_equal(a, b):
            raise AssertionError("mutator resume: the search differs")
        out["mutator"] = {"batches": 6, "batch_rows": batch, "seconds": mutator_s,
                          "resume_s": resume_s, "cursor": int(again.index.mut_cursor),
                          "replayed": again.applied - int(again.index.mut_cursor),
                          "ckpt_bytes": os.path.getsize(os.path.join(root, "index.ckpt"))}
        log(f"path mutation mutator (IVF-Flat, ckpt_every 4): 6 batches of {batch} rows "
            f"(upsert, delete, upsert, delete, rebalance, upsert) in {mutator_s:.3f} s; cold "
            f"resume {resume_s:.3f} s (checkpoint at cursor {out['mutator']['cursor']}, "
            f"{out['mutator']['ckpt_bytes']} bytes, {out['mutator']['replayed']} replayed), "
            f"slot_rows, tombstones, list_sizes, source_ids and search bit for bit")
    for fam, idx in originals.items():
        sr, pay = kept[fam]
        if not (torch.equal(idx.slot_rows, sr) and torch.equal(getattr(idx, payload[fam]), pay)):
            raise AssertionError(f"{fam}: the phase-4 index changed under mutation")
    out.update({"timing": timing, "persist": persist, "truth_ms": truth_ms,
                "wall_s": time.perf_counter() - t_path,
                "launches": _launch.launch_counts()})
    calls["truth"] = truth_spy.calls[0]
    log(f"path mutation: launches {out['launches']}, {out['wall_s']:.1f} s; the phase-4 "
        f"indexes unchanged")
    return out, calls


class AttachClock(Spy):
    """Times each call of `integrity.digest.attach` (the build-time digest
    pass) by index kind, so each phase-4 build's share spent on its
    sidecar is read from the build itself. The first call of a kind is
    its phase-4 build's."""

    def __init__(self):
        from raft_tpu_torch.integrity import digest

        super().__init__(digest, "attach")
        self.seconds = {}

    def __call__(self, index, kind=None):
        from raft_tpu_torch.integrity import digest

        kind = kind or digest.kind_of(index)
        if index.device.type == "cuda":
            torch.cuda.synchronize(index.device)
        t0 = time.perf_counter()
        self.orig(index, kind)
        self.seconds.setdefault(kind, []).append(time.perf_counter() - t0)


#: the kill-and-resume drill's depth: rows and lists of the IVF-PQ index
#: it mutates, rows an upsert or delete batch, batches (ckpt_every 2), and
#: the visit of `mutation.log.commit` that dies (4: after the third log
#: append, the log one entry ahead of the checkpoint)
KILL_DRILL = dict(rows=50_000, n_lists=64, batch=2000, batches=6, count=4)

_KILL_CHILD = """
import sys
import time
t0 = time.perf_counter()
sys.path.insert(0, {repo!r})
import torch
import chip_smoke
from raft_tpu_torch.core import faults
from raft_tpu_torch.neighbors import ivf_pq, mutation
print(f"imported {{time.perf_counter() - t0:.3f}}", flush=True)
idx = ivf_pq.load({base!r}, device=torch.device({dev!r}))
print(f"loaded {{time.perf_counter() - t0:.3f}}", flush=True)
plan = faults.FaultPlan([faults.Fault(kind="kill_rank", site="mutation.log.commit",
                                      count={count})], seed=0)
with plan.install():
    chip_smoke.kill_drill_batches(mutation.Mutator({root!r}, idx, ckpt_every=2), {rows},
                                  {dim}, {seed})
print("finished", flush=True)
"""


def kill_drill_batches(mut, rows, dim, seed):
    """The kill drill's mutation sequence (the child's and the parent's)
    over an index of `rows` ids: upserts of fresh rows over existing ids
    and deletes, in turns, then a commit. Returns the committed index."""
    rng = np.random.default_rng(seed)
    b = KILL_DRILL["batch"]
    for step in range(KILL_DRILL["batches"]):
        ids = rng.choice(rows, b, replace=False).astype(np.int32)
        if step % 2 == 0:
            mut.upsert(rng.standard_normal((b, dim), dtype=np.float32), ids)
        else:
            mut.delete(ids)
    return mut.commit()


def integrity_path(g, dev, res, fl, rb, attach_s, sync):
    """Integrity of the live index (raft_tpu_torch/integrity) and the fault
    sites (core/faults) on the three 1M-row indexes of phase 4, one path
    with its launch counts set to 0 just before it and read just after.
    Each family searches at its phase-4 gate rung with its engine by name,
    as in mutation_path; the phase-4 indexes are only read (rot goes to
    clones, each a new table on the card).
      1. Sidecars, each family: `digest.compute` timed (GB/s over the bytes
         it hashes) against the sidecar the build attached; the build's
         own attach time (`attach_s`, read by AttachClock); an upsert of
         n/20 rows timed without a sidecar and with one (the refresh);
         save and load of the upserted index, the loaded sidecar equal and
         `check_fresh` passing.
      2. The lane pad: IVF-Flat's phase-4 fused search widened the store
         in place (its built width is not a lane multiple); a `full_scan`
         (budget 8) afterwards returns []. Where the build was already
         lane-aligned, a compacted copy at a width that is not gives the
         same drill.
      3. Rot: one seeded list of each payload field (IVF-PQ codes,
         IVF-Flat list_data, RaBitQ codes and aux) rotted with `rot_list`
         on the card; slices of 8 lists until detection (the slices and
         the seconds), then the rest of the lap: exactly that pair.
      4. Quarantine of that list on each family: the search equals
         `mutation.delete(index, ids of the list)` bit for bit, with no id
         of the list.
      5. Point-in-time restore on IVF-PQ: `Mutator(retain=3, ckpt_every=2)`
         over 8 batches of n/100 rows (upserts and deletes in turns) keeps
         the snapshots at 4, 6 and 8; `restore` to 6 from base 4 and to 8
         from base 6 (the two committed seqs above the oldest retained
         base), each a replay, byte for byte the crash-free commit at that
         seq (a copy of each commit taken as it happened); with the
         snapshot at 6 rotted, it is refused when pinned, and restore to 6
         falls back to base 4, again byte for byte the commit.
      6. Watchdog and repair on the committed IVF-PQ index of 5: a list
         rotted, `IntegrityWatchdog.step` until it quarantines (coverage <
         1.0, no id of the list), then with
         `repair=checkpoint_repairer(root)` once more: coverage 1.0, the
         search bit for bit the one before the rot.
      7. Faults on the card: the phase-4 searches and brute_force.knn
         (engine="fused") bit for bit under a plan for another site (the
         hooks inert); `fused.scan.scores` at fraction 1.0 turns every
         value of knn fused and of IVF-Flat fused NaN, and cleared they
         return bit for bit; `ivf.probe_budget` gives full-shape valid
         results at a lower recall, cleared bit for bit; a
         `mutation.log.commit` kill_rank drill in a child process on the
         card (KILL_DRILL's depth), started after 1 and collected before
         5, so that only the lane pad's lap and the rot drills run beside
         it: the child dies by SIGKILL and the resume equals a crash-free
         run (the committed file byte for byte).
      8. refine_host: the IVF-PQ 4k shortlist re-ranked against the
         dataset as host numpy (fused), ids and values equal to `refine`
         over the device rows; its time and the host gather's alone.
    Times are host seconds around work that ends in a synchronize."""
    import shutil

    import raft_tpu_torch.integrity as integrity
    from raft_tpu_torch.core import faults
    from raft_tpu_torch.integrity import digest, scrub, watchdog
    from raft_tpu_torch.neighbors import (brute_force, ivf_flat, ivf_pq, ivf_rabitq, mutation,
                                          probe_budget)
    from raft_tpu_torch.neighbors.refine import refine, refine_host
    from raft_tpu_torch.ops import _launch
    from raft_tpu_torch.ops.pq_list_scan import lane_padded

    dataset, queries, truth, k = res["dataset"], res["queries"], res["truth"], g.k
    n, dim = dataset.shape
    mods = {"ivf_pq": ivf_pq, "ivf_flat": ivf_flat, "ivf_rabitq": ivf_rabitq}
    originals = {"ivf_pq": res["index"], "ivf_flat": fl["index"], "ivf_rabitq": rb["index"]}
    kept = {f: (idx.slot_rows.clone(), idx.list_digests) for f, idx in originals.items()}
    p_pq = first_cleared(res["rungs"], trim="fused", score_dtype="bf16")
    p_fl = first_cleared(fl["rungs"], engine="fused")
    gate = rb["gate"]
    params = {"ivf_pq": ivf_pq.SearchParams(n_probes=p_pq, score_mode="recon8_list",
                                            trim_engine="fused"),
              "ivf_flat": ivf_flat.SearchParams(n_probes=p_fl, engine="fused"),
              "ivf_rabitq": ivf_rabitq.SearchParams(n_probes=gate["n_probes"],
                                                    rerank_mult=gate["rerank_mult"],
                                                    scan_engine="fused")}
    rows0 = rb["index"].dataset

    def search(fam, idx, table=dataset, rows=None, prm=None):
        prm = prm or params[fam]
        if fam == "ivf_pq":
            return refine(table, queries, ivf_pq.search(prm, idx, queries, 4 * k)[1], k,
                          strategy="fused", device=dev)
        if fam == "ivf_flat":
            return ivf_flat.search(prm, idx, queries, k)
        return ivf_rabitq.search(prm, idx, queries, k, refine_dataset=rows)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def nbytes(idx, kind):
        total = 0
        for field in digest.DIGEST_FIELDS[kind]:
            t = getattr(idx, field, None)
            if t is not None:
                total += t.numel() * (1 if field == "tombstones" else t.element_size())
        return total

    out = {"attach_in_build_s": attach_s}
    _launch.reset_launch_counts()
    t_path = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="raft_tpu_torch_integrity_")
    child = None
    try:
        # 1. sidecars
        up_rng = np.random.default_rng(g.seed + 22)
        n_up = n // 20
        up_ids = torch.from_numpy(up_rng.permutation(n)[:n_up].astype(np.int32)).to(dev)
        up_rows = torch.from_numpy(blob_rows(g.seed, g.n_lists, dim, n_up, up_rng)).to(dev)
        sidecar = {}
        for fam, idx in originals.items():
            (lists, tables), comp_s = timed(lambda: digest.compute(idx, fam))
            size = nbytes(idx, fam)
            same = (sorted(lists) == sorted(idx.list_digests)
                    and all(np.array_equal(lists[f], idx.list_digests[f]) for f in lists)
                    and tables == idx.table_digests)
            if not same:
                raise AssertionError(f"{fam}: compute differs from the build's sidecar")
            bare = mutation._clone(idx)
            bare.list_digests = bare.table_digests = None
            # the upsert without a sidecar in turns around the one with it
            # (the first of three warms up), the better of its two times
            bare_s = [timed(lambda: mutation.upsert(bare, up_rows, up_ids))[1]
                      for _ in range(2)]
            up, up_s = timed(lambda: mutation.upsert(idx, up_rows, up_ids))
            up_bare_s = min(bare_s[1], timed(lambda: mutation.upsert(bare, up_rows, up_ids))[1])
            path = os.path.join(tmp, f"{fam}.ckpt")
            _, save_s = timed(lambda: mods[fam].save(path, up))
            loaded, load_s = timed(lambda: mods[fam].load(path, device=dev))
            same = (sorted(loaded.list_digests) == sorted(up.list_digests)
                    and all(np.array_equal(loaded.list_digests[f], up.list_digests[f])
                            for f in up.list_digests)
                    and loaded.table_digests == up.table_digests)
            if not same:
                raise AssertionError(f"{fam}: the loaded sidecar differs from the saved one")
            _, fresh_s = timed(lambda: digest.check_fresh(loaded))
            build_attach = attach_s.get(fam, [None])[0]
            sidecar[fam] = {"compute_s": comp_s, "bytes": size, "compute_gb_s": size / comp_s / 1e9,
                            "attach_in_build_s": build_attach, "upsert_bare_ms": up_bare_s * 1e3,
                            "upsert_ms": up_s * 1e3, "refresh_ms": (up_s - up_bare_s) * 1e3,
                            "save_s": save_s, "load_s": load_s, "check_fresh_s": fresh_s,
                            "file_bytes": os.path.getsize(path)}
            log(f"integrity sidecar {fam}: compute {comp_s:.3f} s over {size} bytes "
                f"({size / comp_s / 1e9:.3f} GB/s), equal to the build's sidecar; attach in the "
                f"phase-4 build {build_attach if build_attach is None else round(build_attach, 3)}"
                f" s; upsert {n_up} rows {up_bare_s * 1e3:.1f} ms without a sidecar, "
                f"{up_s * 1e3:.1f} ms with its refresh (+{(up_s - up_bare_s) * 1e3:.1f} ms); "
                f"save {save_s:.3f} s, load {load_s:.3f} s ({os.path.getsize(path)} bytes), "
                f"loaded sidecar equal, check_fresh {fresh_s:.3f} s")
            del bare, loaded, up
            os.remove(path)
        out["sidecars"] = sidecar

        # 7d. the kill drill's child (seconds of importing torch, then
        # mutations on the card) runs beside the lane pad's lap and the rot
        # drills only: every other timed section runs without it
        kd = dict(KILL_DRILL, rows=min(KILL_DRILL["rows"], n))
        small = ivf_pq.build(ivf_pq.IndexParams(n_lists=kd["n_lists"], pq_dim=dim // 2,
                                                kmeans_n_iters=5),
                             dataset[:kd["rows"]], seed=g.seed, device=dev)
        base = os.path.join(tmp, "kill_base.ckpt")
        ivf_pq.save(base, small)
        kill_root = os.path.join(tmp, "kill")
        repo = os.path.dirname(os.path.abspath(__file__))
        code = _KILL_CHILD.format(repo=repo, base=base, dev=str(dev), count=kd["count"],
                                  root=kill_root, rows=kd["rows"], dim=dim, seed=g.seed + 21)
        t_child = time.perf_counter()
        child_out = os.path.join(tmp, "kill_child.log")
        with open(child_out, "w") as fh:
            child = subprocess.Popen([sys.executable, "-c", code], cwd=repo, stdout=fh,
                                     stderr=subprocess.STDOUT)

        # 2. the lane pad on the card
        flat = originals["ivf_flat"]
        padded = flat
        if fl["built_width"] % 128 == 0:
            # the build came out lane-aligned: a compacted copy at a width
            # that is not a lane multiple takes the pad instead
            live = int(flat.list_sizes.max())
            slack = next(s for s in (0, 32, 64, 96)
                         if mutation._round_group(live + s) % 128)
            padded = mutation.compact(mutation.delete(flat, [0]), slack=slack)
            width0 = int(padded.list_data.shape[1])
            search("ivf_flat", padded)
        else:
            width0 = fl["built_width"]
        width1 = int(padded.list_data.shape[1])
        sc = scrub.Scrubber("ivf_flat", budget_lists=8)
        bad, lap_s = timed(lambda: sc.full_scan(padded))
        if bad or width1 != lane_padded(width0) or width1 == width0:
            raise AssertionError(f"lane pad: widths {width0} -> {width1}, full_scan {bad[:4]}")
        out["lane_pad"] = {"width": [width0, width1], "full_scan_s": lap_s,
                           "slices": -(-flat.n_lists // 8)}
        log(f"integrity lane pad (IVF-Flat): the fused search widened the store {width0} -> "
            f"{width1} slots in place; full_scan (budget 8, {-(-flat.n_lists // 8)} slices) "
            f"{lap_s:.3f} s: [] (the digests extended over the pad bytes)")

        # 3. rot, and 4. quarantine
        rot, quar = {}, {}
        pick = np.random.default_rng(g.seed + 23)
        for fam, fields in (("ivf_pq", ("codes",)), ("ivf_flat", ("list_data",)),
                            ("ivf_rabitq", ("codes", "aux"))):
            idx = originals[fam]
            for field in fields:
                lid = int(pick.integers(idx.n_lists))
                victim = mutation._clone(idx)
                scrub.rot_list(victim, lid, field, frac=0.1, seed=g.seed + lid)
                sc = scrub.Scrubber(fam, budget_lists=8)
                sync()
                t0 = time.perf_counter()
                found, slices = [], 0
                while not found:
                    found = sc.slice_scan(victim)
                    slices += 1
                    if sc.cursor == 0 and not found:
                        break
                detect_s = time.perf_counter() - t0
                rest = []
                while sc.cursor != 0:
                    rest += sc.slice_scan(victim)
                if found + rest != [(field, lid)]:
                    raise AssertionError(f"{fam} rot of {field} list {lid}: {found + rest}")
                rot[f"{fam} {field}"] = {"list": lid, "slices": slices, "detect_s": detect_s}
                log(f"integrity rot {fam} {field} list {lid} (rot_list on {dev}): found after "
                    f"{slices} slices of 8 lists in {detect_s:.3f} s; the lap names exactly "
                    f"({field!r}, {lid})")
            # quarantine the last rotted list against delete of its ids
            srows = idx.slot_rows[lid]
            ids = idx.source_ids[srows[srows >= 0].long()]
            q_idx, q_s = timed(lambda: watchdog.quarantine(victim, lid, fam))
            dead = mutation.delete(idx, ids)
            rows = rows0 if fam == "ivf_rabitq" else None
            a = search(fam, q_idx, rows=rows)
            b = search(fam, dead, rows=rows)
            if not bit_equal(a, b) or bool(torch.isin(a[1], ids).any()):
                raise AssertionError(f"{fam}: quarantine differs from delete of list {lid}")
            quar[fam] = {"list": lid, "ids": int(ids.numel()), "quarantine_ms": q_s * 1e3}
            log(f"integrity quarantine {fam} list {lid} ({int(ids.numel())} ids) in "
                f"{q_s * 1e3:.2f} ms: search equal bit for bit to delete of its ids, none "
                f"returned")
            del victim, q_idx, dead
        out.update({"rot": rot, "quarantine": quar})

        # 7d. collect the kill drill, then its crash-free reference
        rc = child.wait(timeout=600)
        child_s = time.perf_counter() - t_child
        child = None
        with open(child_out) as fh:
            said = fh.read()
        if rc != -signal.SIGKILL or "finished" in said:
            raise AssertionError(f"kill drill: child exit {rc}: {said[-2000:]}")
        marks = dict(line.split()[:2] for line in said.splitlines()
                     if line.startswith(("imported ", "loaded ")))
        resumed, resume_s = timed(lambda: kill_drill_batches(
            mutation.Mutator(kill_root, ivf_pq.load(base, device=dev), ckpt_every=2),
            kd["rows"], dim, g.seed + 21))
        clean_root = os.path.join(tmp, "kill_clean")
        crash_free = kill_drill_batches(
            mutation.Mutator(clean_root, ivf_pq.load(base, device=dev), ckpt_every=2),
            kd["rows"], dim, g.seed + 21)
        with open(os.path.join(kill_root, mutation.CKPT_NAME), "rb") as fa, \
                open(os.path.join(clean_root, mutation.CKPT_NAME), "rb") as fb:
            same_file = fa.read() == fb.read()
        same = all(torch.equal(getattr(resumed, f), getattr(crash_free, f))
                   for f in ("codes", "slot_rows", "list_sizes", "source_ids"))
        if not (same_file and same):
            raise AssertionError("kill drill: the resume differs from the crash-free run")
        out["kill_drill"] = {**kd, "child_s": child_s, "child_marks_s": marks,
                             "resume_s": resume_s}
        log(f"integrity kill drill (mutation.log.commit, kill_rank count {kd['count']}): a "
            f"child on {dev} over an IVF-PQ of {kd['rows']} rows, {kd['n_lists']} lists, "
            f"{kd['batches']} batches of {kd['batch']} (depth cut from the 1M index), died by "
            f"SIGKILL {child_s:.1f} s after its start, beside the lane pad's lap and the "
            f"rot drills (imports done at {marks.get('imported')} s, index on the card at "
            f"{marks.get('loaded')} s); the "
            f"resume ({resume_s:.3f} s) equals the crash-free run, the committed file byte "
            "for byte")

        # 5. point-in-time restore on IVF-PQ
        root = os.path.join(tmp, "pitr")
        pq = originals["ivf_pq"]
        mrng = np.random.default_rng(g.seed + 24)
        batch = max(1, n // 100)
        commits = {}
        t0 = time.perf_counter()
        mut = mutation.Mutator(root, pq, ckpt_every=2, retain=3)
        for step in range(8):
            ids = mrng.choice(n, batch, replace=False).astype(np.int32)
            if step % 2 == 0:
                mut.upsert(blob_rows(g.seed, g.n_lists, dim, batch, mrng), ids)
            else:
                mut.delete(ids)
            if int(mut.index.mut_cursor) == mut.applied:  # a commit: keep its bytes
                commits[mut.applied] = os.path.join(tmp, f"commit_{mut.applied}.ckpt")
                shutil.copyfile(mut.ckpt_path, commits[mut.applied])
        sync()
        mutator_s = time.perf_counter() - t0
        snaps = [c for c, _ in integrity.retained(root)]
        if snaps != [4, 6, 8] or sorted(commits) != [2, 4, 6, 8]:
            raise AssertionError(f"retain=3: snapshots {snaps}, commits {sorted(commits)}")
        def restored(target, **kw):
            dst = os.path.join(tmp, f"restored_{target}.ckpt")
            _, r_s = timed(lambda: integrity.restore(root, target, out=dst, device=dev, **kw))
            with open(dst, "rb") as fa, open(commits[target], "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f"restore to {target} ({kw}): bytes differ from the "
                                         "crash-free commit")
            os.remove(dst)
            return r_s

        # the two committed seqs above the oldest retained base, each a replay
        restores = [{"seq": t, "base": b, "replayed": t - b, "seconds": restored(t, base_cursor=b)}
                    for t, b in ((6, 4), (8, 6))]
        snap6 = integrity.snapshot_path(root, 6)
        with open(snap6, "r+b") as fh:  # rot mid-file
            fh.seek(os.path.getsize(snap6) // 2)
            blk = fh.read(64)
            fh.seek(-len(blk), os.SEEK_CUR)
            fh.write(bytes(x ^ 0xFF for x in blk))
        try:
            integrity.restore(root, 6, base_cursor=6, device=dev)
            raise AssertionError("a rotted base restored")
        except digest.IntegrityError:
            pass
        fb_s = restored(6)  # the newest base at or below 6 is rotted: base 4 replays
        out["pitr"] = {"batches": 8, "batch_rows": batch, "mutator_s": mutator_s,
                       "snapshots": snaps, "restores": restores, "fallback_s": fb_s,
                       "ckpt_bytes": os.path.getsize(mut.ckpt_path)}
        log(f"integrity pitr (IVF-PQ, Mutator retain 3, ckpt_every 2): 8 batches of {batch} "
            f"rows in {mutator_s:.3f} s, snapshots {snaps} ({os.path.getsize(mut.ckpt_path)} "
            "bytes each); restore "
            + ", ".join(f"seq {r['seq']} from base {r['base']} ({r['replayed']} replayed) "
                        f"{r['seconds']:.3f} s" for r in restores)
            + f", each byte for byte the crash-free commit at that seq; snapshot 6 rotted "
            f"(refused when pinned): restore to 6 falls back to base 4 in {fb_s:.3f} s, byte "
            "for byte the same commit")

        # 6. watchdog and repair on the committed IVF-PQ index
        served = mut.commit()
        pre = search("ivf_pq", served)
        lid = int(pick.integers(served.n_lists))
        srows = served.slot_rows[lid]
        ids = served.source_ids[srows[srows >= 0].long()]
        rotted = mutation._clone(served)
        scrub.rot_list(rotted, lid, "codes", frac=0.1, seed=g.seed)
        wd = integrity.IntegrityWatchdog("ivf_pq", budget_lists=8)
        steps = 0
        while not wd.quarantined:
            rotted = wd.step(rotted)
            steps += 1
            if steps > served.n_lists:
                raise AssertionError("the watchdog never found the rotted list")
        cov_before = wd.coverage()
        mid = search("ivf_pq", rotted)
        if wd.quarantined != {lid} or not cov_before < 1.0 or bool(torch.isin(mid[1], ids).any()):
            raise AssertionError(f"watchdog: quarantined {wd.quarantined}, coverage {cov_before}")
        wd.repair = integrity.checkpoint_repairer(root)
        repaired, rep_s = timed(lambda: wd.step(rotted))
        post = search("ivf_pq", repaired)
        if wd.repairs != 1 or wd.coverage() != 1.0 or not bit_equal(pre, post):
            raise AssertionError(f"repair: {wd.repairs} repairs, coverage {wd.coverage()}, "
                                 f"search equal {bit_equal(pre, post)}")
        out["watchdog"] = {"list": lid, "steps": steps, "coverage_before": cov_before,
                           "coverage_after": wd.coverage(), "repair_s": rep_s}
        log(f"integrity watchdog (IVF-PQ, budget 8): list {lid} rotted, quarantined after "
            f"{steps} steps, coverage {cov_before:.6f}, no id of the list returned; repair "
            f"from the checkpoint {rep_s:.3f} s (restore + check_fresh), coverage "
            f"{wd.coverage()}, search bit for bit the one before the rot")
        del served, rotted, repaired, mut

        # 7. faults on the card
        other = faults.FaultPlan([faults.Fault(kind="corrupt_shard", site="serve.batch")],
                                 seed=g.seed)
        clean = {fam: search(fam, idx, rows=rows0 if fam == "ivf_rabitq" else None)
                 for fam, idx in originals.items()}
        clean["knn"] = brute_force.knn(dataset, queries, k, engine="fused", device=dev)
        with other.install():
            inert = {fam: search(fam, idx, rows=rows0 if fam == "ivf_rabitq" else None)
                     for fam, idx in originals.items()}
            inert["knn"] = brute_force.knn(dataset, queries, k, engine="fused", device=dev)
        if not all(bit_equal(clean[f], inert[f]) for f in clean):
            raise AssertionError("a hook changed a search under a plan for another site")
        nan_plan = faults.FaultPlan([faults.Fault(kind="corrupt_shard", site="fused.scan.scores",
                                                  fraction=1.0)], seed=g.seed)
        with nan_plan.install():
            bad_knn = brute_force.knn(dataset, queries, k, engine="fused", device=dev)
            bad_flat = search("ivf_flat", originals["ivf_flat"])
        if not (bool(torch.isnan(bad_knn[0]).all()) and bool(torch.isnan(bad_flat[0]).all())):
            raise AssertionError("fused.scan.scores at fraction 1.0 left finite values")
        after = (brute_force.knn(dataset, queries, k, engine="fused", device=dev),
                 search("ivf_flat", originals["ivf_flat"]))
        if not (bit_equal(after[0], clean["knn"]) and bit_equal(after[1], clean["ivf_flat"])):
            raise AssertionError("fused.scan.scores cleared: results differ")
        budget_params = ivf_flat.SearchParams(n_probes=p_fl, engine="fused", budget_tau=1.0,
                                              early_term=False)
        b_clean = search("ivf_flat", originals["ivf_flat"], prm=budget_params)
        budget_plan = faults.FaultPlan([faults.Fault(kind="corrupt_shard",
                                                     site="ivf.probe_budget", fraction=1.0)],
                                       seed=g.seed)
        with budget_plan.install():
            b_bad = search("ivf_flat", originals["ivf_flat"], prm=budget_params)
            _, scanned = probe_budget.probe_plan(queries, originals["ivf_flat"].centers,
                                                 n_probes=p_fl, min_probes=1, k=k,
                                                 metric=originals["ivf_flat"].metric, tau=1.0)
        b_again = search("ivf_flat", originals["ivf_flat"], prm=budget_params)
        r_clean, r_bad = recall(b_clean[1], truth), recall(b_bad[1], truth)
        if (tuple(b_bad[1].shape) != (g.nq, k) or bool((b_bad[1] < 0).any())
                or bool((scanned != 1).any()) or bit_equal(b_bad, b_clean)
                or not r_bad <= r_clean or not bit_equal(b_again, b_clean)):
            raise AssertionError(f"ivf.probe_budget: recall {r_clean} -> {r_bad}")
        out["faults"] = {"budget_recall": [r_clean, r_bad]}
        log("integrity faults: hooks inert (the four phase-4 searches and knn fused bit for "
            "bit under a plan for another site); fused.scan.scores at fraction 1.0: every value "
            f"of knn fused and IVF-Flat fused NaN, cleared bit for bit; ivf.probe_budget: "
            f"budgets shrunk to 1 list, recall@{k} {r_clean:.4f} -> {r_bad:.4f}, full-shape "
            "valid ids, cleared bit for bit")

        # 8. refine_host
        host = dataset.cpu().numpy()
        cand = ivf_pq.search(params["ivf_pq"], originals["ivf_pq"], queries, 4 * k)[1]
        cand_host = cand.cpu().numpy()
        dev_out, dev_s = timed(lambda: refine(dataset, queries, cand, k, strategy="fused",
                                              device=dev))
        host_out, host_s = timed(lambda: refine_host(host, queries, cand_host, k,
                                                     strategy="fused", device=dev))
        _, gather_s = timed(lambda: host[np.clip(cand_host, 0, host.shape[0] - 1)])
        if not bit_equal(dev_out, host_out):
            raise AssertionError("refine_host differs from refine over the device rows")
        out["refine_host"] = {"ms": host_s * 1e3, "gather_ms": gather_s * 1e3,
                              "device_refine_ms": dev_s * 1e3,
                              "candidates": list(cand_host.shape)}
        log(f"integrity refine_host (IVF-PQ {4 * k} shortlist, {g.nq} queries, the {n} x {dim} "
            f"dataset as host numpy, fused): {host_s * 1e3:.3f} ms, host gather alone "
            f"{gather_s * 1e3:.3f} ms; refine over the device rows {dev_s * 1e3:.3f} ms; ids "
            "and values bit for bit")

    finally:
        if child is not None:
            child.kill()
            child.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    for fam, idx in originals.items():
        sr, digests = kept[fam]
        if not torch.equal(idx.slot_rows, sr) or idx.list_digests is not digests:
            raise AssertionError(f"{fam}: the phase-4 index changed on the integrity path")
    out.update({"wall_s": time.perf_counter() - t_path, "launches": _launch.launch_counts()})
    log(f"path integrity: launches {out['launches']}, {out['wall_s']:.1f} s; the phase-4 "
        "indexes unchanged")
    return out



def device_breakdown(run, reps, batch_ms, label="n_probes 8 + refine", top=10):
    """Where a batch's time goes: `reps` batches under torch.profiler.
    Only the device's own activities count (kernels, copies, sets: events
    whose device_type is CUDA); the operator rows that launched them carry
    the same time again and are left out. Busy time is the union of those
    intervals. The idle share is read twice: against the profiled wall,
    and against `batch_ms`, the unprofiled batch time of the same rung
    (the profiler slows the host, not the device's work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, reach, per_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        per_name[name] = per_name.get(name, 0.0) + (end - start)
    device_ms = busy_us / 1e3 / reps
    ops = sorted(((name, us / 1e3 / reps) for name, us in per_name.items()), key=lambda kv: -kv[1])
    out = {"wall_ms": wall_ms, "device_ms": device_ms, "device_events": len(spans),
           "idle_share": 1.0 - device_ms / wall_ms,
           "idle_share_unprofiled": 1.0 - device_ms / batch_ms,
           "top": [{"kernel": name[:80], "ms": ms} for name, ms in ops[:top]]}
    log(f"breakdown, {label}, per batch: device busy {device_ms:.4f} ms "
        f"({len(spans) // reps} device activities); profiled wall {wall_ms:.4f} ms, idle "
        f"share {out['idle_share']:.4f}; unprofiled batch {batch_ms:.4f} ms, idle share "
        f"{out['idle_share_unprofiled']:.4f}")
    for row in out["top"]:
        log(f"  {row['ms']:9.4f} ms  {row['kernel']}")
    if not spans or device_ms > wall_ms:
        raise AssertionError(f"profile read no device activity or too much: {device_ms} ms")
    return out


def query_consts_cost(ivf_rabitq, run, reps, batch_ms, dev, sync):
    """What the estimator's per-(query, list) constants cost a RaBitQ
    batch: the calls of `ivf_rabitq._query_consts` (each pair's residual
    sum and qconst) that one batch of `run` makes, replayed on their own
    inputs: ms a batch by CUDA events and the device activities of one
    replay. Beside them the same sums in the JAX reference's CPU order
    (`quantizer.ordered_row_sum`, the CPU path of `_query_consts`): their
    ms, device activities, and how far the two differ."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.neighbors.quantizer import ordered_row_sum

    with Spy(ivf_rabitq, "_query_consts") as spy:
        run()
        sync()
    calls = spy.calls

    def engine():
        return [ivf_rabitq._query_consts(*a, **kw) for a, kw in calls]

    def ordered():
        return [(ordered_row_sum(qres), ordered_row_sum(qs, cent) if ip
                 else ordered_row_sum(qres, qres)) for (qs, cent, qres, ip), _ in calls]

    def activities(fn):
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            fn()
            sync()
        return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))

    ms, ordered_ms = time_ms(engine, reps), time_ms(ordered, reps)
    n_dev, n_ordered = activities(engine), activities(ordered)
    a = torch.cat([t.reshape(-1) for pair in engine() for t in pair])
    b = torch.cat([t.reshape(-1) for pair in ordered() for t in pair])
    equal = float((a.view(torch.int32) == b.view(torch.int32)).float().mean())
    gap = float((a - b).abs().max())
    out = {"calls": len(calls), "ms": ms, "device_activities": n_dev,
           "share_of_batch": ms / batch_ms, "ordered_ms": ordered_ms,
           "ordered_device_activities": n_ordered, "ordered_equal_bits": equal,
           "ordered_max_abs_gap": gap}
    log(f"rabitq query constants, gate rung: {len(calls)} call(s) a batch, {ms:.4f} ms a batch "
        f"in {n_dev} device activities, {out['share_of_batch']:.4f} of the {batch_ms:.4f} ms "
        f"batch; in the reference's order {ordered_ms:.4f} ms in {n_ordered} device "
        f"activities, bitwise-equal sums {equal:.6f}, largest gap {gap:.3g}")
    if not gap <= 1e-4 * float(b.abs().max()):  # f32 sums of 96 terms differ by ulps, not more
        raise AssertionError(f"rabitq query constants differ from the ordered sums by {gap}")
    return out


def check_truth(res, k, dev):
    """Cross-check the fused truth against numpy float64 exact kNN on 16
    queries x the first 100k rows (bench.py's check): agreement >= 0.95
    (bf16 rounding and f32 sums may flip near-ties at rank k)."""
    from raft_tpu_torch.neighbors import brute_force

    ns = min(100_000, res["dataset"].shape[0])
    sub = res["dataset"][:ns].cpu().numpy().astype(np.float64)
    qs = res["queries"][:16].cpu().numpy().astype(np.float64)
    d2 = (qs * qs).sum(1)[:, None] + (sub * sub).sum(1)[None, :] - 2.0 * qs @ sub.T
    ref = np.argsort(d2, axis=1, kind="stable")[:, :k]
    _, got = brute_force.knn(res["dataset"][:ns], res["queries"][:16], k, engine="fused",
                             device=dev)
    agree = recall(got, torch.from_numpy(ref))
    log(f"truth check vs numpy float64 (16 queries x {ns} rows): agreement {agree:.4f}")
    if agree < 0.95:
        raise AssertionError(f"truth disagrees with numpy float64: {agree}")


# ---------------------------------------------------------------------------
# phase 4b: the tuned table (A/B of every key, then the committed table)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def table(values):
    """Run under the tuned table `values` (a dict) in place of the
    committed file, on any device (the CPU rehearsal too). `table({})` is
    the untuned resolution, the JAX package's program without a tuned
    value."""
    from raft_tpu_torch.core import tuned

    load, applies = tuned._load, tuned.applies
    tuned._load = lambda: dict(values)
    tuned.applies = lambda device: device is not None
    try:
        yield
    finally:
        tuned._load, tuned.applies = load, applies


@contextlib.contextmanager
def committed(dev):
    """Run under the committed table file, read afresh. On the CPU
    rehearsal the table is made to govern the CPU too, so that the
    promoted paths run (their kernels' plain versions)."""
    from raft_tpu_torch.core import tuned

    tuned.reload()
    applies = tuned.applies
    if dev.type != "cuda":
        tuned.applies = lambda device: device is not None
    try:
        yield
    finally:
        tuned.applies = applies


def tie_equal(v1, i1, v2, i2, rtol=0.0) -> bool:
    """Values equal (within `rtol` of each row's largest finite magnitude),
    and ids equal but for their order within a group of such equal values
    (a group that reaches the row's end may hold other ids of that
    value)."""
    a, b = i1.cpu().numpy(), i2.cpu().numpy()
    va, vb = v1.cpu().numpy().astype(np.float64), v2.cpu().numpy().astype(np.float64)
    fin = np.isfinite(va)
    if (a.shape != b.shape or not np.array_equal(fin, np.isfinite(vb))
            or not np.array_equal(va[~fin], vb[~fin])):
        return False
    tol = rtol * np.where(fin, np.abs(va), 0).max(axis=1)
    with np.errstate(invalid="ignore"):  # inf - inf: not within any tolerance
        if (np.where(fin, np.abs(va - vb), 0) > tol[:, None]).any():
            return False
        for r in np.nonzero((a != b).any(axis=1))[0]:
            for c in np.nonzero(a[r] != b[r])[0]:
                group = (va[r] == va[r, c]) | (np.abs(va[r] - va[r, c]) <= tol[r])
                if not group[-1] and set(a[r][group]) != set(b[r][group]):
                    return False
    return True


#: a candidate wins a key when it is at most AB_KEEP times the untuned time
#: in every cell, below AB_WIN times it in one, clears the recall gate, and
#: loses at most AB_RECALL_LOSS of the untuned resolution's recall in every
#: cell (the JAX package's rule for its engine defaults: a candidate more
#: than 0.01 recall under the baseline is dropped, bench/apply_profile_hints.py)
AB_WIN, AB_KEEP, AB_RECALL_LOSS = 0.97, 1.03, 0.01


def ab_cells(key, cells, cands, base, g, sync):
    """The A/B of one tuned key. `cells`: (label, run, truth, batches),
    truth None for an exact engine held to its untuned answer;
    `cands`: (name, value or None for the untuned resolution). Every
    candidate runs under `base` (the winners of the keys before) with the
    key set to its value: a first run for ids, recall and launches, then
    ms a batch over `batches` back-to-back batches in two turns, the
    candidates in order and then reversed, the better turn kept. Returns
    {cell label: [row a candidate]}."""
    from raft_tpu_torch.ops import _launch

    def values(v):
        t = {k2: v2 for k2, v2 in base.items() if k2 != key}
        if v is not None:
            if key == "hints":
                t["hints"] = {**t.get("hints", {}), **v}
            else:
                t[key] = v
        return t

    out = {}
    for label, run, truth, batches in cells:
        rows = []
        for name, v in cands:
            with table(values(v)):
                _launch.reset_launch_counts()
                vals, ids = run()
                sync()
                launches = {n: c for n, c in _launch.launch_counts().items() if c}
            rows.append({"candidate": name, "value": v, "launches": launches, "vals": vals,
                         "ids": ids, "turns_ms": []})
        for row in rows:  # truth None: the untuned (first) candidate's exact answer
            row["recall"] = recall(row["ids"], truth if truth is not None else rows[0]["ids"])
        for order in (rows, rows[::-1]):
            for row in order:
                with table(values(row["value"])):
                    sync()
                    t0 = time.perf_counter()
                    for _ in range(batches):
                        run()
                    sync()
                    row["turns_ms"].append((time.perf_counter() - t0) * 1e3 / batches)
        for row in rows:
            row["ms"] = min(row["turns_ms"])
            log(f"tuned A/B {key}, {label}: {row['candidate']}: {row['ms']:.4f} ms a batch "
                f"(turns {', '.join(f'{t:.4f}' for t in row['turns_ms'])}; {batches} batches "
                f"a turn), recall@{g.k} {row['recall']:.4f}, launches {row['launches']}")
        out[label] = rows
    return out


def ab_winner(key, res_by_cell, admissible=None):
    """The winning candidate name of an A/B (the `AB_WIN`/`AB_KEEP`/
    `AB_RECALL_LOSS` rule, the smallest summed time ratio among the
    winners), or None."""
    names = [r["candidate"] for r in next(iter(res_by_cell.values()))]
    best, best_score = None, None
    for name in names:
        if name == "untuned" or (admissible is not None and name not in admissible):
            continue
        ratios, ok = [], True
        for rows in res_by_cell.values():
            base = next(r for r in rows if r["candidate"] == "untuned")
            row = next(r for r in rows if r["candidate"] == name)
            ratios.append(row["ms"] / base["ms"])
            ok = (ok and row["recall"] >= RECALL_GATE and ratios[-1] <= AB_KEEP
                  and row["recall"] >= base["recall"] - AB_RECALL_LOSS)
        if ok and min(ratios) < AB_WIN and (best is None or sum(ratios) < best_score):
            best, best_score = name, sum(ratios)
    log(f"tuned A/B {key}: winner {best!r}" if best else
        f"tuned A/B {key}: no winner (no candidate below {AB_WIN} of the untuned time in a "
        f"cell and at most {AB_KEEP} in every cell at recall@10 >= {RECALL_GATE} and within "
        f"{AB_RECALL_LOSS} of the untuned recall); left out")
    return best


def gate_winner(key, rows):
    """Recall-driven keys (the RaBitQ depths): the fastest candidate that
    clears the recall gate, unless the untuned one clears it within AB_KEEP
    of that time (then None)."""
    ok = [r for r in rows if r["recall"] >= RECALL_GATE]
    if not ok:
        log(f"tuned A/B {key}: no candidate clears recall@10 >= {RECALL_GATE}; left out")
        return None
    best = min(ok, key=lambda r: r["ms"])
    base = next(r for r in rows if r["candidate"] == "untuned")
    if best["candidate"] == "untuned" or (base["recall"] >= RECALL_GATE
                                          and base["ms"] <= AB_KEEP * best["ms"]):
        log(f"tuned A/B {key}: no winner (the untuned value clears the gate within "
            f"{AB_KEEP} of the fastest); left out")
        return None
    log(f"tuned A/B {key}: winner {best['candidate']!r}")
    return best["candidate"]


def strip_ab(res_by_cell):
    return {label: [{k2: v2 for k2, v2 in r.items() if k2 not in ("vals", "ids")}
                    for r in rows] for label, rows in res_by_cell.items()}


def _timed(fn, sync, reps=3):
    """(the last result, the best of `reps` synchronized calls in ms)."""
    best, out = None, None
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        best = ms if best is None else min(best, ms)
    return out, best


def _bits(t):
    return t.contiguous().view(torch.int32)


def invert_checks(g, dev, res, sync):
    """Item 8 on the card: the counting chunk tables equal the sorted ones
    table for table and bit for bit (values and dtypes) at the main path's
    probes (nq g.nq at n_probes 8 and 20 on the index's lists), at
    g.wide_lists lists (the queries' 8 nearest of as many dataset rows)
    and under an adaptive keep mask (budget_tau 0.3 at n_probes 20); and
    the one-hot query rows at the main path's n_probes-8 tables:
    "onehot_f32h" equal to the gather bit for bit, "onehot_bf16" equal to
    the gathered rows rounded to bf16 (the sums start from +0.0, so both
    are held to the gather + 0.0). Each construction and impl timed
    (best of three synchronized calls). Raises on any difference."""
    from raft_tpu_torch.neighbors import ivf_pq, probe_budget
    from raft_tpu_torch.neighbors import probe_invert as pi

    index, queries, dataset = res["index"], res["queries"], res["dataset"]
    chunk = 128
    cases = []
    for n_probes in (8, 20):
        q_rot, probes, _ = ivf_pq._coarse_select(queries, index.rotation, index.centers,
                                                 n_probes, index.metric)
        cases.append((f"{n_probes} probes of {index.n_lists} lists", probes, index.n_lists,
                      None, q_rot))
    gen = torch.Generator(device=dev).manual_seed(g.seed + 16)
    cent = dataset[torch.randperm(dataset.shape[0], generator=gen, device=dev)[:g.wide_lists]]
    wide_probes = torch.topk(torch.cdist(queries, cent), 8, largest=False).indices
    cases.append((f"8 probes of {g.wide_lists} lists", wide_probes, g.wide_lists, None, None))
    params = ivf_pq.SearchParams(n_probes=20, budget_tau=0.3)
    plan = probe_budget.search_plan(probe_budget.resolve_params(params, 20, dev), queries,
                                    index.centers, n_probes=20, k=4 * g.k, metric=index.metric,
                                    rotation=index.rotation, radii=index.list_radii,
                                    sizes=index.list_sizes)
    cases.append((f"adaptive, budget_tau 0.3, 20 probes of {index.n_lists} lists", plan[1],
                  index.n_lists, plan[0], None))
    out = []
    for label, probes, n_lists, pvalid, q_rot in cases:
        ts, sort_ms = _timed(lambda: pi.invert_probes_sort(probes, n_lists, chunk, pvalid), sync)
        tc, count_ms = _timed(lambda: pi.invert_probes_count(probes, n_lists, chunk, pvalid),
                              sync)
        for name, a, b in zip(pi.ChunkTables._fields, ts, tc):
            if (a is None) != (b is None) or (a is not None and (
                    a.dtype != b.dtype or not torch.equal(a, b))):
                raise AssertionError(f"invert_probes_count != invert_probes_sort, {label}: "
                                     f"table {name}")
        kept = int((ts.qid_tbl != queries.shape[0]).sum())
        row = {"case": label, "sort_ms": sort_ms, "count_ms": count_ms, "pairs_kept": kept,
               "chunks": int(ts.lof.shape[0])}
        log(f"item 8 invert, {label}: count == sort bit for bit ({row['chunks']} chunks, "
            f"{kept} pairs kept); sort {sort_ms:.4f} ms, count {count_ms:.4f} ms")
        if q_rot is not None and label.startswith("8 probes"):
            q_pad = torch.cat([q_rot, q_rot.new_zeros((1, q_rot.shape[1]))])
            gathered, gather_ms = _timed(lambda: pi.gather_query_rows(q_pad, ts.qid_tbl,
                                                                      "gather"), sync)
            f32h, f32h_ms = _timed(lambda: pi.gather_query_rows(q_pad, ts.qid_tbl,
                                                                "onehot_f32h"), sync)
            bf16, bf16_ms = _timed(lambda: pi.gather_query_rows(q_pad, ts.qid_tbl,
                                                                "onehot_bf16"), sync)
            want = gathered + 0.0
            if not torch.equal(_bits(f32h), _bits(want)):
                raise AssertionError(f"onehot_f32h rows != gathered rows, {label}")
            if not torch.equal(_bits(bf16), _bits(want.to(torch.bfloat16).float() + 0.0)):
                raise AssertionError(f"onehot_bf16 rows != bf16-rounded gathered rows, {label}")
            row.update(gather_ms=gather_ms, onehot_f32h_ms=f32h_ms, onehot_bf16_ms=bf16_ms,
                       rows=int(gathered.shape[0] * gathered.shape[1]))
            log(f"item 8 query rows, {label}: onehot_f32h == gather bit for bit, onehot_bf16 "
                f"== gather rounded to bf16 bit for bit ({row['rows']} rows of "
                f"{q_rot.shape[1]}); gather {gather_ms:.4f} ms, onehot_f32h {f32h_ms:.4f} ms, "
                f"onehot_bf16 {bf16_ms:.4f} ms")
        out.append(row)
    return out


def tuned_path(g, dev, res, pm, fl, rb, sync, card, apply):
    """Phase 4b: the A/B of every tuned key on the main path's data, then
    the committed table's default calls. Each key's candidates run under
    the winners of the keys before it (the order of the dispatch layers),
    each candidate by name beside the untuned resolution, in the cells:
      select_k_auto_strategy   the default IVF-PQ batch (SearchParams at
                               the default ladder's gate rung + refine) and
                               exact L1 k-NN over every row;
      select_k_strategy        exact L2 k-NN, brute_force.knn(engine="auto");
      select_k_strategy_int8   the default IVF-PQ batch with int8 rows;
      select_k_strategy_bitplane  IVF-RaBitQ's default scan at its gate rung;
      flat_auto_engine         IVF-Flat engine="auto" at its gate n_probes,
                               nq g.nq and g.small_nq;
      pq_auto_engine           IVF-PQ defaults at g.small_nq, n_probes
                               SMALL_PROBES, and at g.nq (the gate rung);
      internal_distance_dtype  the default IVF-PQ batch (a hint);
      pallas_fold              trim "pallas", bf16 and int8 rows;
      listmajor_chunk          the default IVF-PQ batch, 64 / 128 / 256
                               (256 is outside the reference's set: timed,
                               never committed);
      rabitq_rerank_mult, rabitq_query_bits  IVF-RaBitQ defaults at its
                               gate n_probes, the fastest depth that clears
                               the gate;
      invert_impl              the default IVF-PQ batch and IVF-Flat's
                               "list" engine at its gate n_probes, after
                               `invert_checks` (count == sort bit for bit,
                               the one-hot rows against the gather);
      listmajor_qs_impl        the default IVF-PQ batch;
      listmajor_qs_impl_flat   IVF-Flat's "list" engine.
    With `apply`, the winners and hints.measured_on (the card) are written
    as raft_tpu_torch/tuned_defaults.json (`apply_table`). Then, under the
    committed table (read afresh; a file that does not load fails),
    `committed_checks`: each promoted default
    call must launch its kernel, clear the gate and return the ids of the
    explicit engine it resolved to (order within equal values aside), each
    a path of its own (launch counts set to 0 just before, read after)."""
    from raft_tpu_torch.core import tuned
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq, ivf_rabitq
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops import _launch

    dataset, queries, truth, index = res["dataset"], res["queries"], res["truth"], res["index"]
    k = g.k
    np_pq = pm["default"]["rungs"][-1]["n_probes"]
    np_flat = next(x["n_probes"] for x in fl["rungs"]
                   if x["engine"] == "fused" and x["recall"] >= RECALL_GATE)
    flat_index, rb_index = fl["index"], rb["index"]
    np_rb = rb["gate"]["n_probes"]
    qs, tr = queries[:g.small_nq], truth[:g.small_nq]
    # batches a turn: 5, and 1 where the untuned engine takes seconds a
    # batch (RaBitQ's "xla" scan); a candidate that is the untuned engine
    # in a cell reads 1 +- its noise there, and one-batch turns of one
    # engine differ by several percent on the card: AB_KEEP would fail by
    # noise alone
    slow, fast = 1, (5 if dev.type == "cuda" else 1)

    def pq_run(params, q=queries):
        def run():
            _, cand = ivf_pq.search(params, index, q, 4 * k)
            return refine(dataset, q, cand, k, strategy="fused", device=dev)
        return run

    def knn_run(**kw):
        return lambda: brute_force.knn(dataset, queries, k, device=dev, **kw)

    def flat_run(params, q=queries):
        return lambda: ivf_flat.search(params, flat_index, q, k)

    def rb_run(params):
        return lambda: ivf_rabitq.search(params, rb_index, queries, k)

    default_pq = ivf_pq.SearchParams(n_probes=np_pq)
    wins, report = {}, {}
    # 1. the per-row select of every internal top-k
    r = ab_cells("select_k_auto_strategy",
                 [("ivf_pq default", pq_run(default_pq), truth, fast),
                  ("knn l1", knn_run(metric="l1"), None, 1)],
                 [("untuned", None), ("counting", "counting")], wins, g, sync)
    report["select_k_auto_strategy"] = strip_ab(r)
    if ab_winner("select_k_auto_strategy", r):
        wins["select_k_auto_strategy"] = "counting"
    r = ab_cells("select_k_strategy", [("knn l2 auto", knn_run(engine="auto"), truth, fast)],
                 [("untuned", None), ("fused", "fused")], wins, g, sync)
    report["select_k_strategy"] = strip_ab(r)
    if ab_winner("select_k_strategy", r):
        wins["select_k_strategy"] = "fused"
    # 2. the list-scan kernels
    r = ab_cells("select_k_strategy_int8",
                 [("ivf_pq default int8", pq_run(ivf_pq.SearchParams(n_probes=np_pq,
                                                                     score_dtype="int8")),
                   truth, fast)],
                 [("untuned", None), ("fused_int8", "fused_int8")], wins, g, sync)
    report["select_k_strategy_int8"] = strip_ab(r)
    if ab_winner("select_k_strategy_int8", r):
        wins["select_k_strategy_int8"] = "fused_int8"
    r = ab_cells("select_k_strategy_bitplane",
                 [("rabitq default", rb_run(ivf_rabitq.SearchParams(
                     n_probes=np_rb, rerank_mult=rb["gate"]["rerank_mult"])), truth, slow)],
                 [("untuned", None), ("fused_bitplane", "fused_bitplane")], wins, g, sync)
    report["select_k_strategy_bitplane"] = strip_ab(r)
    if ab_winner("select_k_strategy_bitplane", r):
        wins["select_k_strategy_bitplane"] = "fused_bitplane"
    r = ab_cells("flat_auto_engine",
                 [(f"ivf_flat auto nq {g.nq}", flat_run(ivf_flat.SearchParams(
                     n_probes=np_flat, engine="auto")), truth, fast),
                  (f"ivf_flat auto nq {g.small_nq}", flat_run(ivf_flat.SearchParams(
                      n_probes=np_flat, engine="auto"), qs), tr, fast)],
                 [("untuned", None), ("query", "query"), ("list", "list"), ("fused", "fused")],
                 wins, g, sync)
    report["flat_auto_engine"] = strip_ab(r)
    w = ab_winner("flat_auto_engine", r)
    if w:
        wins["flat_auto_engine"] = w
    # 3. IVF-PQ's engine choices
    r = ab_cells("pq_auto_engine",
                 [(f"ivf_pq default nq {g.small_nq} n_probes {SMALL_PROBES}",
                   pq_run(ivf_pq.SearchParams(n_probes=SMALL_PROBES), qs), tr, fast),
                  (f"ivf_pq default nq {g.nq}", pq_run(default_pq), truth, fast)],
                 [("untuned", None), ("lut", "lut"), ("recon8", "recon8"),
                  ("recon8_list", "recon8_list")], wins, g, sync)
    report["pq_auto_engine"] = strip_ab(r)
    w = ab_winner("pq_auto_engine", r)
    if w:
        wins["pq_auto_engine"] = w
    r = ab_cells("hints", [("ivf_pq default", pq_run(default_pq), truth, fast)],
                 [("untuned", None), ("bfloat16", {"internal_distance_dtype": "bfloat16"})],
                 wins, g, sync)
    report["internal_distance_dtype"] = strip_ab(r)
    if ab_winner("internal_distance_dtype", r):
        wins["hints"] = {**wins.get("hints", {}), "internal_distance_dtype": "bfloat16"}
    r = ab_cells("pallas_fold",
                 [(f"ivf_pq pallas {d}", pq_run(ivf_pq.SearchParams(
                     n_probes=np_pq, score_mode="recon8_list", trim_engine="pallas",
                     score_dtype=d)), truth, fast) for d in ("bf16", "int8")],
                 [("untuned", None), ("packed", "packed")], wins, g, sync)
    report["pallas_fold"] = strip_ab(r)
    if ab_winner("pallas_fold", r):
        wins["pallas_fold"] = "packed"
    chunks = ivf_pq._LISTMAJOR_CHUNKS
    ivf_pq._LISTMAJOR_CHUNKS = chunks + (256,)  # 256 timed only
    try:
        r = ab_cells("listmajor_chunk", [("ivf_pq default", pq_run(default_pq), truth, fast)],
                     [("untuned", None), ("64", 64), ("256", 256)], wins, g, sync)
    finally:
        ivf_pq._LISTMAJOR_CHUNKS = chunks
    report["listmajor_chunk"] = strip_ab(r)
    w = ab_winner("listmajor_chunk", r, admissible={str(c) for c in chunks})
    if w:
        wins["listmajor_chunk"] = int(w)
    # 5. item 8: the chunk-table construction and the list-major query rows
    report["invert_checks"] = invert_checks(g, dev, res, sync)
    flat_list = (f"ivf_flat list n_probes {np_flat}",
                 flat_run(ivf_flat.SearchParams(n_probes=np_flat, engine="list")), truth, fast)
    pq_default = ("ivf_pq default", pq_run(default_pq), truth, fast)
    for key, cells, cands in (
            ("invert_impl", [pq_default, flat_list], ("count",)),
            ("listmajor_qs_impl", [pq_default], ("onehot_bf16", "onehot_f32h")),
            ("listmajor_qs_impl_flat", [flat_list], ("onehot_f32h", "onehot_bf16"))):
        r = ab_cells(key, cells, [("untuned", None)] + [(c, c) for c in cands], wins, g, sync)
        report[key] = strip_ab(r)
        w = ab_winner(key, r)
        if w:
            wins[key] = w
    # 4. IVF-RaBitQ's depths at its gate n_probes, the fastest that clears the gate
    for key, cands in (("rabitq_rerank_mult", (8, 16, 25)), ("rabitq_query_bits", (4, 6))):
        r = ab_cells(key, [("rabitq default", rb_run(ivf_rabitq.SearchParams(n_probes=np_rb)),
                            truth, fast)],
                     [("untuned", None)] + [(str(c), c) for c in cands], wins, g, sync)
        report[key] = strip_ab(r)
        w = gate_winner(key, next(iter(r.values())))
        if w:
            wins[key] = int(w)
    log("tuned winners " + json.dumps(wins, sort_keys=True))
    return wins, report


def apply_table(wins, card):
    """Write the winners and where they were measured as
    raft_tpu_torch/tuned_defaults.json, in place of what it held (a key
    this run finds no winner for leaves the table), by temp-then-rename."""
    from raft_tpu_torch.core import tuned

    record = dict(wins)
    record["hints"] = {**wins.get("hints", {}), "measured_on": card,
                       "measured_by": "chip_smoke.py"}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(tuned.path()), suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, tuned.path())
    tuned.reload()
    log(f"tuned table written: {tuned.path()}: {json.dumps(tuned._load(), sort_keys=True)}")


def committed_checks(g, dev, res, pm, fl, rb, sync):
    """Each promotion of the committed table on its default call: the
    kernel it promotes launches (a path of its own), recall@k clears the
    gate, and the ids equal those of the explicit engine the call resolved
    to (for the select promotions, the untuned run), order within equal
    values aside. A table file that does not load, or holds an unknown key
    or value, fails."""
    from raft_tpu_torch.core import tuned
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq, ivf_rabitq
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops import _launch

    with open(tuned.path()) as f:
        record = json.load(f)  # a corrupt file fails here
    bad = [key for key, v in record.items()
           if key not in tuned.TUNED_KEYS or (tuned.TUNED_KEYS[key]["choices"] is not None
                                               and v not in tuned.TUNED_KEYS[key]["choices"])]
    if not isinstance(record, dict) or bad:
        raise AssertionError(f"tuned table: unknown keys or values {bad}")
    tuned.reload()
    if record and tuned._load() != record:
        raise AssertionError("tuned table did not load")
    log(f"committed tuned table ({tuned.path()}): {json.dumps(record, sort_keys=True)}")
    dataset, queries, truth, index = res["dataset"], res["queries"], res["truth"], res["index"]
    k = g.k
    np_pq = pm["default"]["rungs"][-1]["n_probes"]
    np_flat = next(x["n_probes"] for x in fl["rungs"]
                   if x["engine"] == "fused" and x["recall"] >= RECALL_GATE)
    np_rb = rb["gate"]["n_probes"]
    qs, tr = queries[:g.small_nq], truth[:g.small_nq]
    out, launches = [], {}

    def pq(params, q=queries):
        _, cand = ivf_pq.search(params, index, q, 4 * k)
        return refine(dataset, q, cand, k, strategy="fused", device=dev)

    def check(label, default, explicit, tr_, kernels, explicit_table=None):
        """default() under the committed table against explicit() (under
        `explicit_table` where given, else the committed table too)."""
        with committed(dev):
            _launch.reset_launch_counts()
            v, ids = default()
            sync()
            counts = _launch.launch_counts()
        with contextlib.ExitStack() as st:
            st.enter_context(table(explicit_table) if explicit_table is not None
                             else committed(dev))
            ev, eids = explicit()
            sync()
        # tr_ None: an exact engine, held to the explicit engine's answer
        rc, same = recall(ids, tr_ if tr_ is not None else eids), tie_equal(v, ids, ev, eids)
        missing = [n for n in kernels if counts[n] <= 0]
        log(f"committed {label}: recall@{k} {rc:.4f}, ids equal to the explicit engine's "
            f"{same}, launches {({n: c for n, c in counts.items() if c})}")
        launches[("tuned", label)] = counts
        out.append({"label": label, "recall": rc, "ids_equal": same,
                    "launches": {n: c for n, c in counts.items() if c}})
        if rc < RECALL_GATE or not same or (missing and dev.type == "cuda"):
            raise AssertionError(f"committed table, {label}: recall {rc}, ids equal {same}, "
                                 f"kernels never launched {missing}")

    if record.get("select_k_auto_strategy") == "counting":
        p = ivf_pq.SearchParams(n_probes=np_pq)
        check("select_k_auto_strategy=counting, ivf_pq default", lambda: pq(p), lambda: pq(p),
              truth, ("counting_select_min",), explicit_table={})
        check("select_k_auto_strategy=counting, knn l1",
              lambda: brute_force.knn(dataset, queries, k, metric="l1", device=dev),
              lambda: brute_force.knn(dataset, queries, k, metric="l1", device=dev),
              None, ("counting_select_min", "pairwise_tiled"), explicit_table={})
    if record.get("select_k_strategy") == "fused":
        check("select_k_strategy=fused, knn auto",
              lambda: brute_force.knn(dataset, queries, k, engine="auto", device=dev),
              lambda: brute_force.knn(dataset, queries, k, engine="fused", device=dev),
              truth, ("fused_topk",))
    if record.get("select_k_strategy_int8") == "fused_int8":
        check("select_k_strategy_int8=fused_int8, ivf_pq default int8",
              lambda: pq(ivf_pq.SearchParams(n_probes=np_pq, score_dtype="int8")),
              lambda: pq(ivf_pq.SearchParams(n_probes=np_pq, score_dtype="int8",
                                             score_mode="recon8_list", trim_engine="fused")),
              truth, ("fused_list_topk_int8",))
    rb_index, flat_index = rb["index"], fl["index"]
    if record.get("select_k_strategy_bitplane") == "fused_bitplane":
        m = rb["gate"]["rerank_mult"]
        check("select_k_strategy_bitplane=fused_bitplane, rabitq default",
              lambda: ivf_rabitq.search(ivf_rabitq.SearchParams(n_probes=np_rb, rerank_mult=m),
                                        rb_index, queries, k),
              lambda: ivf_rabitq.search(ivf_rabitq.SearchParams(
                  n_probes=np_rb, rerank_mult=m, scan_engine="fused"), rb_index, queries, k),
              truth, ("fused_bitplane_topk",))
    if "flat_auto_engine" in record:
        eng = {"pallas": "fused"}.get(record["flat_auto_engine"], record["flat_auto_engine"])
        for q_, t_ in ((queries, truth), (qs, tr)):
            check(f"flat_auto_engine={eng}, ivf_flat auto nq {q_.shape[0]}",
                  lambda q_=q_: ivf_flat.search(ivf_flat.SearchParams(n_probes=np_flat,
                                                                      engine="auto"),
                                                flat_index, q_, k),
                  lambda q_=q_: ivf_flat.search(ivf_flat.SearchParams(n_probes=np_flat,
                                                                      engine=eng),
                                                flat_index, q_, k),
                  t_, ("fused_list_topk",) if eng == "fused" else ())
    if "pq_auto_engine" in record:
        mode = record["pq_auto_engine"]
        check(f"pq_auto_engine={mode}, ivf_pq default nq {g.small_nq}",
              lambda: pq(ivf_pq.SearchParams(n_probes=SMALL_PROBES), qs),
              lambda: pq(ivf_pq.SearchParams(n_probes=SMALL_PROBES, score_mode=mode), qs),
              tr, ("fused_list_topk",))
    idd = tuned.hints().get("internal_distance_dtype") if record else None
    if idd is not None:
        check(f"internal_distance_dtype={idd}, ivf_pq default",
              lambda: pq(ivf_pq.SearchParams(n_probes=np_pq)),
              lambda: pq(ivf_pq.SearchParams(n_probes=np_pq, internal_distance_dtype=idd)),
              truth, ("fused_list_topk",))
    if "pallas_fold" in record:
        p = ivf_pq.SearchParams(n_probes=np_pq, score_mode="recon8_list", trim_engine="pallas")
        check(f"pallas_fold={record['pallas_fold']}, ivf_pq pallas", lambda: pq(p),
              lambda: pq(p), truth, ("pq_list_scan",))
    if "listmajor_chunk" in record:
        p = ivf_pq.SearchParams(n_probes=np_pq)
        check(f"listmajor_chunk={record['listmajor_chunk']}, ivf_pq default", lambda: pq(p),
              lambda: pq(p), truth, ("fused_list_topk",), explicit_table={})
    # item 8: the default calls under each committed impl against the
    # same calls under the table without the item-8 keys
    without = {key: v for key, v in record.items()
               if key not in ("invert_impl", "listmajor_qs_impl", "listmajor_qs_impl_flat")}
    if any(key in record for key in ("invert_impl", "listmajor_qs_impl")):
        p = ivf_pq.SearchParams(n_probes=np_pq)
        check(f"invert_impl={record.get('invert_impl')}, listmajor_qs_impl="
              f"{record.get('listmajor_qs_impl')}, ivf_pq default", lambda: pq(p), lambda: pq(p),
              truth, (), explicit_table=without)
    if any(key in record for key in ("invert_impl", "listmajor_qs_impl_flat")):
        p = ivf_flat.SearchParams(n_probes=np_flat, engine="list")
        check(f"invert_impl={record.get('invert_impl')}, listmajor_qs_impl_flat="
              f"{record.get('listmajor_qs_impl_flat')}, ivf_flat list",
              lambda: ivf_flat.search(p, flat_index, queries, k),
              lambda: ivf_flat.search(p, flat_index, queries, k), truth, (),
              explicit_table=without)
    depth = {"rerank_mult": record.get("rabitq_rerank_mult"),
             "query_bits": record.get("rabitq_query_bits")}
    if any(v is not None for v in depth.values()):
        explicit = {f: v for f, v in depth.items() if v is not None}
        check(f"rabitq depths {explicit}, rabitq default",
              lambda: ivf_rabitq.search(ivf_rabitq.SearchParams(n_probes=np_rb), rb_index,
                                        queries, k),
              lambda: ivf_rabitq.search(ivf_rabitq.SearchParams(n_probes=np_rb, **explicit),
                                        rb_index, queries, k),
              truth, ())
    # the default IVF-PQ batch a caller who sets nothing now runs: QPS over
    # windows at g.nq and g.small_nq, the g.nq batch under torch.profiler
    timing = {}
    with committed(dev):
        for label, q_, t_, p in (("nq", queries, truth, ivf_pq.SearchParams(n_probes=np_pq)),
                                 ("small", qs, tr, ivf_pq.SearchParams(n_probes=SMALL_PROBES))):
            def run(p=p, q_=q_):
                return pq(p, q_)

            _, ids = run()
            sync()
            gq = argparse.Namespace(**{**vars(g), "nq": q_.shape[0]})
            sec, w_qps = timed_windows(gq, run, sync)
            mode, trim, idd = ivf_pq.resolve_search(
                p, q_.shape[0], p.n_probes, index.n_lists, index.device, k=4 * k,
                L=int(index.recon8.shape[1]), rot=index.rot_dim, kbuf=index.fused_kb)
            timing[label] = {"nq": q_.shape[0], "n_probes": p.n_probes, "score_mode": mode,
                             "trim": trim, "distances": idd, "recall": recall(ids, t_),
                             "batch_s": sec, "qps": q_.shape[0] / sec, "window_qps": w_qps}
            log(f"committed default ivf_pq SearchParams(n_probes={p.n_probes}) + refine, nq "
                f"{q_.shape[0]} (score_mode {mode}, trim {trim}, distances {idd}): recall@{k} "
                f"{timing[label]['recall']:.4f}, {q_.shape[0] / sec:.1f} qps ({sec * 1e3:.4f} ms "
                f"a batch over {len(w_qps)} windows of {g.batch_reps} batches; window qps "
                f"{min(w_qps):.1f} .. {max(w_qps):.1f})")
            if label == "nq" and dev.type == "cuda":
                timing["breakdown"] = device_breakdown(
                    run, 2, sec * 1e3, label=f"ivf_pq default n_probes {np_pq} + refine, "
                    "committed table", top=12)
    return {"checks": out, "default_batch": timing}, launches


# ---------------------------------------------------------------------------
# phase 4c: adaptive probing
# ---------------------------------------------------------------------------

#: the recall_target ladder and the explicit budget_tau rungs
ADAPTIVE_TARGETS = (0.90, 0.95, 0.99, 1.0)
ADAPTIVE_TAUS = (0.2, 0.4)
#: the calibration's tau grid
CALIBRATION_TAUS = (0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
ADAPTIVE_PROBES = 32


def adaptive_families(g, dev, res, fl, rb):
    """The three families adaptive probing runs on, at n_probes P:
    {name: (params maker, run(params) -> (values, ids), index, the plan's
    k, the coarse rotation or None, the kernels the family launches,
    scan(params, queries) -> the index search's own (values, ids), before
    any refine)}."""
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, ivf_rabitq
    from raft_tpu_torch.neighbors.refine import refine

    dataset, queries, pq_index = res["dataset"], res["queries"], res["index"]
    k, P = g.k, min(ADAPTIVE_PROBES, g.n_lists)
    flat_index, rb_index = fl["index"], rb["index"]
    mult = rb["gate"]["rerank_mult"]
    return {
        "ivf_pq fused bf16 + refine": (
            lambda **kw: ivf_pq.SearchParams(n_probes=P, score_mode="recon8_list",
                                             trim_engine="fused", **kw),
            lambda p: refine(dataset, queries, ivf_pq.search(p, pq_index, queries, 4 * k)[1], k,
                             strategy="fused", device=dev),
            pq_index, 4 * k, pq_index.rotation, ("fused_list_topk",),
            lambda p, q: ivf_pq.search(p, pq_index, q, 4 * k)),
        "ivf_flat fused": (
            lambda **kw: ivf_flat.SearchParams(n_probes=P, engine="fused", **kw),
            lambda p: ivf_flat.search(p, flat_index, queries, k),
            flat_index, k, None, ("fused_list_topk",),
            lambda p, q: ivf_flat.search(p, flat_index, q, k)),
        "ivf_rabitq fused": (
            lambda **kw: ivf_rabitq.SearchParams(n_probes=P, rerank_mult=mult,
                                                 scan_engine="fused", **kw),
            lambda p: ivf_rabitq.search(p, rb_index, queries, k),
            rb_index, ivf_rabitq.rerank_depth(k, mult), rb_index.rotation,
            ("fused_bitplane_topk",),
            lambda p, q: ivf_rabitq.search(p, rb_index, q, k)),
    }


@contextlib.contextmanager
def plain_list_kernels():
    """The list kernels' wrappers (`fused_list_topk`, `fused_bitplane_topk`,
    which every engine imports at call time) replaced by their plain
    PyTorch versions on every device: a search run under it is the same
    search with each kernel launch done by its plain version."""
    from raft_tpu_torch.ops import fused_scan as fs

    orig = fs.fused_list_topk, fs.fused_bitplane_topk

    def list_plain(lof, qres, store, base, k, *, kbuf=None, inner_product=False,
                   chunk_valid=None, chunk_rows=None):
        return fs.fused_list_topk_plain(lof, qres, store, base, int(k),
                                        fs.fused_kbuf(k) if kbuf is None else int(kbuf),
                                        bool(inner_product), chunk_valid, chunk_rows)

    def bitplane_plain(lof, planes, codes_t, meta, base, qmeta, k, *, rot_dim, bits, kbuf=None,
                       inner_product=False, chunk_valid=None, chunk_rows=None):
        return fs.fused_bitplane_topk_plain(lof, planes, codes_t, meta, base, qmeta, int(k),
                                            fs.fused_kbuf(k) if kbuf is None else int(kbuf),
                                            int(rot_dim), int(bits), bool(inner_product),
                                            chunk_valid, chunk_rows)

    fs.fused_list_topk, fs.fused_bitplane_topk = list_plain, bitplane_plain
    try:
        yield
    finally:
        fs.fused_list_topk, fs.fused_bitplane_topk = orig


def kept_lists(queries, idx, P, ap, plan_k, rot):
    """(nq, P) the list ids a search scanned (-1 where its plan masked the
    probe): the plan the engines take (`probe_budget.search_plan`: the
    probes they scan and the mask over them), or the fixed search's coarse
    select where the search plans nothing."""
    from raft_tpu_torch.neighbors import probe_budget

    plan = probe_budget.search_plan(ap, queries, idx.centers, n_probes=P, k=plan_k,
                                    metric=idx.metric, rotation=rot, radii=idx.list_radii,
                                    sizes=idx.list_sizes)
    if plan is None:
        q = queries.float() if rot is None else queries.float() @ rot.T
        return probe_budget.coarse_select(q, idx.centers, idx.metric, P,
                                          pq_style=rot is not None)[1].long()
    keep, probes = plan
    return torch.where(keep, probes.long(), -1)


def list_of_ids(idx):
    """(id_bound,) int64 the list holding each id of an IVF index (-1:
    none), from its slot table."""
    sr = idx.slot_rows.long()
    lists = torch.arange(sr.shape[0], device=sr.device)[:, None].expand_as(sr)
    live = sr >= 0
    out = torch.full((int(idx.id_bound),), -1, dtype=torch.long, device=sr.device)
    out[idx.source_ids.long()[sr[live]]] = lists[live]
    return out


#: the masked rungs' kernel-against-plain check runs on this many queries
ADAPTIVE_CHECK_NQ = 256


def masked_checks(g, dev, res, fams, fam, label, p, ids, sync):
    """A masked rung held on the card: every id it returned lies in a list
    its keep mask kept (all queries), and the index search on the first
    ADAPTIVE_CHECK_NQ queries equals the same search with every kernel
    launch done by its plain version (`compare`: values to VAL_RTOL of the
    row, ids but at near-ties). Returns the check's numbers."""
    from raft_tpu_torch.neighbors import probe_budget

    make, run, idx, plan_k, rot, _, scan = fams[fam]
    queries, P = res["queries"], min(ADAPTIVE_PROBES, g.n_lists)
    ap = probe_budget.resolve_params(p, P, dev)
    kept = kept_lists(queries, idx, P, ap, plan_k, rot)
    held = list_of_ids(idx)[ids.long().clamp(min=0)]
    outside = int(((ids >= 0) & ~(held[..., None] == kept[:, None, :]).any(-1)).sum())
    if outside:
        raise AssertionError(f"adaptive {fam}, {label}: {outside} ids from lists the keep mask "
                             "dropped")
    qs = queries[:ADAPTIVE_CHECK_NQ]
    kv, ki = scan(p, qs)
    with plain_list_kernels():
        pv, pi = scan(p, qs)
    sync()
    err, agree = compare(f"adaptive {fam}, {label}, kernel against plain", (kv, ki), (pv, pi),
                         kv.shape[1])
    masked = int((kept < 0).sum())
    log(f"adaptive {fam}, {label}: every id in a kept list ({masked} of {kept.numel()} probes "
        f"masked); kernel against plain on {qs.shape[0]} queries: max abs err {err:.3g}, ids "
        f"agree {agree:.4f}")
    return {"masked_probes": masked, "plain_max_abs_err": err, "plain_id_agreement": agree}


def adaptive_rung(g, dev, res, fams, fam, label, p, sync):
    """One adaptive rung: recall@k, the mean of the lists a query scanned
    (the kept pairs of the plan the search made over nq), ms a batch over
    back-to-back batches. Returns (row, values, ids)."""
    from raft_tpu_torch.neighbors import probe_budget

    make, run, idx, plan_k, rot = fams[fam][:5]
    queries, P = res["queries"], min(ADAPTIVE_PROBES, g.n_lists)
    batches = 5 if dev.type == "cuda" else 1
    v, ids = run(p)
    sync()
    t0 = time.perf_counter()
    for _ in range(batches):
        run(p)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / batches
    ap = probe_budget.resolve_params(p, P, dev)
    lists = float(P)
    if ap is not None:
        _, counts = probe_budget.probe_plan(
            queries, idx.centers, n_probes=P, min_probes=ap.min_probes, k=plan_k,
            metric=idx.metric, tau=ap.tau, rotation=rot,
            radii=idx.list_radii if ap.early_term else None, sizes=idx.list_sizes)
        lists = float(counts.sum()) / queries.shape[0]
    row = {"family": fam, "rung": label, "recall": recall(ids, res["truth"]), "scanned": lists,
           "ms": ms}
    log(f"adaptive {fam}, n_probes {P}, {label}: recall@{g.k} {row['recall']:.4f}, "
        f"{lists:.3f} lists a query, {ms:.4f} ms a batch")
    return row, v, ids


#: the calibration's data and search, bench/bench_adaptive_probes.py's
#: defaults (its --smoke sizes on the CPU rehearsal): overlapping blobs,
#: max(n_lists // 2, 8) clusters of std 3.0 with centres U(-10, 10) (the
#: regime adaptive budgets exist for: easy queries deep in a cluster,
#: hard ones between), the queries drawn from the rows, k 10
CALIBRATION = dict(rows=100_000, dim=64, n_lists=256, n_probes=32, nq=1024)
CALIBRATION_SMOKE = dict(rows=20_000, dim=64, n_lists=64, n_probes=16, nq=256)


def calibration_data(g, dev):
    """(dataset, queries, exact truth, geometry) of the calibration."""
    from raft_tpu_torch.neighbors import brute_force

    c = CALIBRATION_SMOKE if dev.type != "cuda" else CALIBRATION
    rng = np.random.default_rng(11)
    centers = rng.uniform(-10.0, 10.0, (max(c["n_lists"] // 2, 8), c["dim"])).astype(np.float32)
    x = centers[rng.integers(0, centers.shape[0], c["rows"])]
    x += 3.0 * rng.standard_normal(x.shape, dtype=np.float32)
    q = x[rng.choice(c["rows"], c["nq"], replace=False)]
    x, q = torch.as_tensor(x, device=dev), torch.as_tensor(q, device=dev)
    _, truth = brute_force.knn(x, q, g.k, device=dev)  # exact f32 ("tiled")
    return x, q, truth, c


def calibrate_policy(g, dev, sync):
    """The adaptive_probe_policy by the JAX package's procedure
    (bench/bench_adaptive_probes.py --apply) on its data
    (`calibration_data`): IVF-Flat (SearchParams(n_probes)) and IVF-PQ
    (pq_dim dim // 4, score_mode "recon8_list", no refine), each built
    with kmeans_n_iters 10, under the committed table, at each tau of
    CALIBRATION_TAUS (budget_tau, early termination on); per tau the
    worse family's recall@k; targets [[recall, tau], ...] sorted by
    recall; default_tau the smallest tau whose recall clears the gate
    (0.6 where none does). A ladder that reads one recall at every tau
    tells no tau from another: no policy (None), so DEFAULT_POLICY
    stays in force. Returns (policy or None, rows)."""
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, probe_budget

    x, q, truth, c = calibration_data(g, dev)
    P = c["n_probes"]
    by_tau, rows = {}, []
    with committed(dev):
        fams = (("ivf_flat", ivf_flat.build(ivf_flat.IndexParams(
                    n_lists=c["n_lists"], kmeans_n_iters=10), x, device=dev),
                 lambda **kw: ivf_flat.SearchParams(n_probes=P, **kw), None),
                ("ivf_pq", ivf_pq.build(ivf_pq.IndexParams(
                    n_lists=c["n_lists"], pq_dim=max(c["dim"] // 4, 8), kmeans_n_iters=10), x,
                    device=dev),
                 lambda **kw: ivf_pq.SearchParams(n_probes=P, score_mode="recon8_list", **kw),
                 True))
        for fam, idx, make, rotated in fams:
            search = ivf_flat.search if fam == "ivf_flat" else ivf_pq.search
            fixed = recall(search(make(), idx, q, g.k)[1], truth)
            for tau in CALIBRATION_TAUS:
                _, ids = search(make(budget_tau=tau, early_term=True), idx, q, g.k)
                sync()
                _, counts = probe_budget.probe_plan(
                    q, idx.centers, n_probes=P, min_probes=1, k=g.k, metric=idx.metric,
                    tau=tau, rotation=idx.rotation if rotated else None, radii=idx.list_radii,
                    sizes=idx.list_sizes)
                row = {"family": fam, "tau": tau, "recall": recall(ids, truth),
                       "fixed_recall": fixed,
                       "scanned": float(counts.sum()) / q.shape[0]}
                rows.append(row)
                by_tau[tau] = min(by_tau.get(tau, 1.0), row["recall"])
                log(f"calibration {fam} ({c['rows']} x {c['dim']} overlapping blobs, n_lists "
                    f"{c['n_lists']}, n_probes {P}, nq {c['nq']}): budget_tau {tau}: recall@"
                    f"{g.k} {row['recall']:.4f} (fixed {fixed:.4f}), {row['scanned']:.3f} lists "
                    "a query")
    targets = sorted([round(r, 4), t] for t, r in by_tau.items())
    if len({r for r, _ in targets}) < 2:
        log(f"adaptive_probe_policy: recall@{g.k} {targets[0][0]} at every tau; no policy "
            "(DEFAULT_POLICY stays in force)")
        return None, rows
    default = float(min((t for r, t in targets if r >= RECALL_GATE), default=0.6))
    policy = {"default_tau": default, "targets": targets}
    log("adaptive_probe_policy measured " + json.dumps(policy))
    return policy, rows


def adaptive_path(g, dev, res, fams, sync):
    """Phase 4c: adaptive probing at n_probes ADAPTIVE_PROBES on IVF-PQ
    (trim "fused", bf16 rows, 4k shortlist + refine), IVF-Flat "fused" and
    IVF-RaBitQ "fused" (its gate rerank_mult). Under the committed table,
    for each family
    the fixed search, the recall_target ladder ADAPTIVE_TARGETS and the
    budget_tau rungs ADAPTIVE_TAUS, each with early termination on (L2,
    radii) and off: recall@k, the mean of the lists a query scanned
    (the kept pairs of the search's own plan over nq), ms a batch. Each
    family is a path of its own. recall_target 1.0 must equal the fixed
    search bit for bit (values and ids); every other rung, after the
    path's launch counts are read, passes `masked_checks` (its ids in the
    lists its mask kept; kernel against plain on the masked search)."""
    from raft_tpu_torch.ops import _launch

    out, launches = [], {}
    with committed(dev):
        for fam, (make, run, idx, plan_k, rot, kernels, _) in fams.items():
            _launch.reset_launch_counts()
            fixed, fv, fids = adaptive_rung(g, dev, res, fams, fam, "fixed", make(), sync)
            out.append(fixed)
            masked = []  # (row, params, ids) of the rungs a mask may cut
            for early in (True, False):
                for rt in ADAPTIVE_TARGETS:
                    p = make(recall_target=rt, early_term=early)
                    row, v, ids = adaptive_rung(g, dev, res, fams, fam,
                                                f"recall_target {rt}, early_term {early}", p, sync)
                    out.append(row)
                    if rt < 1.0:
                        masked.append((row, p, ids))
                    elif not (torch.equal(v, fv) and torch.equal(ids, fids)):
                        raise AssertionError(f"adaptive {fam}: recall_target 1.0 is not the "
                                             "fixed search bit for bit")
                for tau in ADAPTIVE_TAUS:
                    p = make(budget_tau=tau, early_term=early)
                    row, _, ids = adaptive_rung(g, dev, res, fams, fam,
                                                f"budget_tau {tau}, early_term {early}", p, sync)
                    out.append(row)
                    masked.append((row, p, ids))
            launches[("adaptive", fam)] = _launch.launch_counts()
            missing = [n for n in kernels if launches[("adaptive", fam)][n] <= 0]
            if missing and dev.type == "cuda":
                raise AssertionError(f"adaptive {fam}: kernels never launched {missing}")
            log(f"path adaptive {fam}: launches {launches[('adaptive', fam)]}; recall_target "
                "1.0 equal to the fixed search bit for bit")
            # after the path's counts: these launches are comparisons
            for row, p, ids in masked:
                row.update(masked_checks(g, dev, res, fams, fam, row["rung"], p, ids, sync))
    return out, launches


# ---------------------------------------------------------------------------
# phase 4d: the graph path
# ---------------------------------------------------------------------------

#: the graph path's sizes on the card: single-linkage over 262,144 x 96 blobs
#: (64 centres U(-5, 5), unit noise; L1 again over the first 65,536 rows),
#: spectral over 262,144 x 32 (8 blobs), bench/bench_sparse.py's shapes,
#: RMAT scale 16, the masked NN's 65,536 queries, a 2048 x 2048 LAP
GRAPH = dict(n=262_144, dim=96, blobs=64, k=15, l1_rows=65_536, spec_dim=32, spec_blobs=8,
             sparse_rows=100_000, sparse_dim=256, sparse_q=512, density=0.05, wide_rows=8192,
             wide_q=512, wide_cols=1_000_000, wide_nnz=8, rmat_scale=16, rmat_edges=1 << 20,
             masked_q=65_536, groups=64, lap_n=2048)
#: the same path at a size the CPU rehearsal runs in seconds
GRAPH_REHEARSE = dict(n=8192, dim=16, blobs=8, k=15, l1_rows=4096, spec_dim=8, spec_blobs=4,
                      sparse_rows=6000, sparse_dim=64, sparse_q=64, density=0.05, wide_rows=512,
                      wide_q=64, wide_cols=100_000, wide_nnz=8, rmat_scale=10,
                      rmat_edges=1 << 14, masked_q=2048, groups=16, lap_n=64)
ARI_GATE = 0.99
RITZ_GATE = 1e-2
#: the Lanczos tolerance of the gated spectral call (`partition(tol=)`)
SPECTRAL_TOL = 1e-3
MST_RTOL = 1e-6
LAP_GATE = 1.02


class FirstCall(Spy):
    """Keeps the arguments of the first call only (the graph path's tiles
    are fresh tensors of up to a GiB each)."""

    def __call__(self, *args, **kwargs):
        if not self.calls:
            self.calls.append((args, kwargs))
        return self.orig(*args, **kwargs)


def ari(a, b) -> float:
    """Adjusted Rand index of two labelings (numpy only, so that the script
    needs no scikit-learn)."""
    _, ai = np.unique(np.asarray(a), return_inverse=True)
    _, bi = np.unique(np.asarray(b), return_inverse=True)
    cont = np.zeros((ai.max() + 1, bi.max() + 1), np.float64)
    np.add.at(cont, (ai, bi), 1.0)

    def pairs(c):
        return float((c * (c - 1) / 2).sum())

    s, sa, sb = pairs(cont), pairs(cont.sum(1)), pairs(cont.sum(0))
    expected = sa * sb / pairs(np.array([len(ai)], np.float64))
    top = (sa + sb) / 2
    return 1.0 if top == expected else (s - expected) / (top - expected)


def scipy_forest(coo, n):
    """(total weight, edges) of scipy's minimum spanning forest of the
    undirected graph `coo` in float64: one entry an undirected pair (its
    least weight), no self loops."""
    import scipy.sparse as ssp
    from scipy.sparse.csgraph import minimum_spanning_tree

    r, c = coo.rows.cpu().numpy().astype(np.int64), coo.cols.cpu().numpy().astype(np.int64)
    w = coo.vals.cpu().double().numpy()
    keep = r != c
    key = np.minimum(r, c)[keep] * n + np.maximum(r, c)[keep]
    w = w[keep]
    order = np.lexsort((w, key))
    key, w = key[order], w[order]
    first = np.ones(len(key), bool)
    first[1:] = key[1:] != key[:-1]
    g = ssp.coo_matrix((w[first], (key[first] // n, key[first] % n)), shape=(n, n)).tocsr()
    t = minimum_spanning_tree(g)
    return float(t.sum()), int(t.nnz)


def check_forest(name, tree, graph, n):
    ours = float(tree.vals.double().sum())
    want, edges = scipy_forest(graph, n)
    if abs(ours - want) > MST_RTOL * max(abs(want), 1e-30) or tree.nnz != edges:
        raise AssertionError(f"{name}: forest weight {ours} over {tree.nnz} edges, scipy "
                             f"{want} over {edges}")
    return ours, want, edges


def graph_linkage(x, truth, metric, dev, sync):
    """single_linkage over x with its stage times and gates: ARI against
    the blobs, n - 1 merges, nondecreasing deltas, the final tree's weight
    and edge count equal to scipy's minimum spanning forest of the
    symmetrized k-NN graph together with every repair pass's edges."""
    from raft_tpu_torch.cluster import single_linkage

    n = x.shape[0]
    stages = {}
    sync()
    t0 = time.perf_counter()
    out = single_linkage(x, n_clusters=int(truth.max()) + 1, metric=metric,
                         connectivity="knn", n_neighbors=GRAPH["k"], device=dev, stages=stages)
    sync()
    wall = time.perf_counter() - t0
    score = ari(truth, out.labels.cpu().numpy())
    deltas = out.deltas.cpu().numpy()
    if out.children.shape != (n - 1, 2):
        raise AssertionError(f"single_linkage {metric}: children {tuple(out.children.shape)}")
    if not np.all(np.diff(deltas) >= 0):
        raise AssertionError(f"single_linkage {metric}: deltas decrease")
    if score < ARI_GATE:
        raise AssertionError(f"single_linkage {metric}: ARI {score} < {ARI_GATE}")
    # the first graph with every repair pass's edges: its minimum spanning
    # forest has the weight of any pass's forest plus the later edges
    # (cycle property), so this holds the first Boruvka pass over the whole
    # k-NN graph as well as the repairs
    graph, extra = stages["graph"], stages["repair_edges"]
    union = type(graph)(*(torch.cat([getattr(g, f) for g in [graph, *extra]])
                          for f in ("rows", "cols", "vals")), graph.shape)
    ours, want, edges = check_forest(f"single_linkage {metric}", stages["tree"], union, n)
    rec = {"rows": n, "metric": metric, "wall_s": wall, "ari": score,
           "mst_weight": ours, "scipy_weight": want, "mst_edges": edges,
           "graph_nnz": graph.nnz, "repair_nnz": [e.nnz for e in extra],
           "stages_s": {key: v for key, v in stages.items() if key.endswith("_s")},
           "repairs": stages.get("repair", []), "n_clusters": out.n_clusters}
    log(f"graph single_linkage {metric}: n {n}, {wall:.3f} s (knn {rec['stages_s']['knn_s']:.3f}, "
        f"symmetrize {rec['stages_s']['symmetrize_s']:.3f}, mst {rec['stages_s']['mst_s']:.3f}, "
        + "".join(f"repair {i + 1} ({r['components']} components, {r['edges']} edges) "
                  f"{r['s']:.3f}, " for i, r in enumerate(rec["repairs"]))
        + f"dendrogram {rec['stages_s']['dendrogram_s']:.3f}, cut {rec['stages_s']['cut_s']:.3f}); "
        f"ARI {score:.6f}, {out.children.shape[0]} merges, deltas nondecreasing, MST weight "
        f"{ours:.6f} (scipy {want:.6f} on the k-NN graph and the repair edges, {edges} edges)")
    return rec


def connected_graph(x, k, dev):
    """knn_graph(k), then connect_components until one component (the
    components by scipy, as the reference's repair finds them), merged
    by max. Returns (graph, passes)."""
    import scipy.sparse as ssp
    from scipy.sparse.csgraph import connected_components

    from raft_tpu_torch import sparse

    g = sparse.neighbors.knn_graph(x, k, device=dev)
    passes = []
    n = x.shape[0]
    while True:
        adj = ssp.coo_matrix((np.ones(g.nnz), (g.rows.cpu().numpy(), g.cols.cpu().numpy())),
                             shape=(n, n))
        n_comp, comp = connected_components(adj, directed=False)
        if n_comp == 1:
            return g, passes
        passes.append(int(n_comp))
        extra = sparse.neighbors.connect_components(x, comp, device=dev)
        g = sparse.linalg.symmetrize(sparse.CooMatrix(
            torch.cat([g.rows, extra.rows]), torch.cat([g.cols, extra.cols]),
            torch.cat([g.vals, extra.vals]), g.shape), "max")


def graph_spectral(G, dev, sync, seed):
    """spectral.partition(n_clusters=8) on a k-NN graph of 8 blobs made
    connected: the JAX program's fixed Lanczos, the default (its pairs'
    residuals and ARI reported, and at the card's size its known miss
    pinned: its largest residual above RITZ_GATE, so that a change to it
    shows), then
    `tol=SPECTRAL_TOL` twice (gates: the returned pairs' residuals
    ||L v - lambda v|| by spmv within RITZ_GATE, the two runs bit for
    bit)."""
    from raft_tpu_torch import sparse, spectral
    from raft_tpu_torch.random import make_blobs
    from raft_tpu_torch.sparse.solver import lanczos, ritz_residuals

    n, k = G["n"], G["spec_blobs"]
    x, truth = make_blobs(n, G["spec_dim"], n_clusters=k, center_box=(-5.0, 5.0),
                          seed=seed + 1, device=dev)
    sync()
    t0 = time.perf_counter()
    g, passes = connected_graph(x, G["k"], dev)
    csr = sparse.coo_to_csr(g)
    sync()
    graph_s = time.perf_counter() - t0
    mv = sparse.linalg.laplacian_matvec(csr)
    truth = truth.cpu().numpy()
    rec = {"rows": n, "graph_s": graph_s, "graph_nnz": g.nnz, "repair_components": passes}
    for name, tol in (("fixed", None), ("tol", SPECTRAL_TOL)):
        sync()
        t0 = time.perf_counter()
        labels, vals, emb = spectral.partition(csr, k, seed=0, tol=tol)
        sync()
        secs = time.perf_counter() - t0
        info = {}
        pv, vecs = lanczos(mv, n, k, "smallest", seed=0, device=dev, tol=tol, info=info)
        if not torch.equal(pv, vals):
            raise AssertionError(f"spectral {name}: the pairs' eigenvalues are not partition's")
        resid = ritz_residuals(mv, pv, vecs).cpu().numpy()
        cut, cost = spectral.analyze_partition(csr, labels, k)
        r = {"s": secs, "ncv": info["ncv"], "eigenvalues": pv.cpu().tolist(),
             "residuals": resid.tolist(), "ari": ari(truth, labels.cpu().numpy()),
             "edge_cut": cut, "cost": cost, "modularity": spectral.modularity(csr, labels)}
        if tol is not None:
            labels2, vals2, emb2 = spectral.partition(csr, k, seed=0, tol=tol)
            same = (torch.equal(labels, labels2) and torch.equal(vals, vals2)
                    and torch.equal(emb, emb2))
            r["bit_equal_rerun"] = same
            if not same:
                raise AssertionError("spectral: two runs differ")
            if resid.max() > RITZ_GATE:
                raise AssertionError(f"spectral: Ritz residual {resid.max()} > {RITZ_GATE}")
        elif G is GRAPH and resid.max() <= RITZ_GATE:
            # the fixed 32 steps miss near-zero eigenvalues at the card's size
            # (ROADMAP Reference caveats); a default that now meets the gate
            # is a change to record, not a pass to take silently
            raise AssertionError(f"spectral fixed: largest Ritz residual {resid.max()} is within "
                                 f"{RITZ_GATE}: the default's known miss is gone; update the "
                                 f"records and this check")
        rec[name] = r
        log(f"graph spectral {name} (ncv {info['ncv']}): {secs:.3f} s, eigenvalues "
            f"{np.array2string(pv.cpu().numpy(), precision=6)}, residuals max {resid.max():.3e}, "
            f"ARI {r['ari']:.6f}, edge cut {cut:.6g}, cost {cost:.6g}, modularity "
            f"{r['modularity']:.6f}" + (", two runs bit for bit" if tol is not None else ""))
    log(f"graph spectral graph: n {n}, {g.nnz} entries, repair passes at {passes} components, "
        f"{graph_s:.3f} s")
    return rec


def graph_sparse(G, dev, sync, rng):
    """bench/bench_sparse.py's shapes: sparse pairwise_distance against the
    dense one on the densified operands, sparse knn against dense
    brute_force.knn, and the compact-column case against float64 numpy."""
    import scipy.sparse as ssp

    from raft_tpu_torch import sparse
    from raft_tpu_torch.distance import pairwise_distance
    from raft_tpu_torch.neighbors import brute_force

    n, d, nq = G["sparse_rows"], G["sparse_dim"], G["sparse_q"]
    dense = rng.random((n, d), dtype=np.float32)
    dense[dense > G["density"]] = 0.0
    qd = rng.random((nq, d), dtype=np.float32)
    qd[qd > G["density"]] = 0.0
    x, q = sparse.dense_to_csr(dense, device=dev), sparse.dense_to_csr(qd, device=dev)
    xt, qt = torch.as_tensor(dense, device=dev), torch.as_tensor(qd, device=dev)
    rec = {"rows": n, "dim": d, "queries": nq, "nnz": x.nnz, "pairwise": {}, "knn": {}}
    for metric in ("sqeuclidean", "l1", "canberra", "cosine"):
        sync()
        t0 = time.perf_counter()
        got = sparse.distance.pairwise_distance(q, x, metric)
        sync()
        secs = time.perf_counter() - t0
        want = pairwise_distance(qt, xt, metric=metric, device=dev)
        err = float((got - want).abs().max())
        if err > VAL_RTOL * max(1.0, float(want.abs().max())):
            raise AssertionError(f"sparse pairwise {metric}: max_abs_err {err}")
        rec["pairwise"][metric] = {"s": secs, "max_abs_err": err,
                                   "bitwise": bool(torch.equal(got, want))}
        log(f"graph sparse pairwise {metric}: {nq} x {n} x {d}, {secs * 1e3:.3f} ms, against "
            f"the dense call max_abs_err {err}")
    for metric in ("sqeuclidean", "l1"):
        sync()
        t0 = time.perf_counter()
        got = sparse.distance.knn(x, q, 10, metric=metric)
        sync()
        secs = time.perf_counter() - t0
        want = brute_force.knn(xt, qt, 10, metric=metric, device=dev)
        err, agree = compare(f"sparse knn {metric}", got, want, 10)
        rec["knn"][metric] = {"s": secs, "max_abs_err": err, "id_agreement": agree}
        log(f"graph sparse knn {metric}: k 10, {secs * 1e3:.3f} ms, ids against dense "
            f"brute_force.knn {agree:.6f} (away from near-ties equal), max_abs_err {err}")
    # the compact-column case: 1M columns, 8 entries a row
    nr, nc, nz, yr = G["wide_rows"], G["wide_cols"], G["wide_nnz"], G["wide_q"]
    idx = rng.integers(0, nc, (nr, nz), dtype=np.int64)
    idx.sort(axis=1)
    data = (rng.random((nr, nz)).astype(np.float32) + 0.1).reshape(-1)
    indptr = np.arange(0, nr * nz + 1, nz, dtype=np.int64)
    wide_x = sparse.CsrMatrix(torch.as_tensor(indptr, device=dev),
                              torch.as_tensor(idx.reshape(-1), device=dev),
                              torch.as_tensor(data, device=dev), (nr, nc))
    wide_y = sparse.CsrMatrix(wide_x.indptr[:yr + 1], wide_x.indices[:yr * nz],
                              wide_x.data[:yr * nz], (yr, nc))
    sync()
    t0 = time.perf_counter()
    got = sparse.distance.pairwise_distance(wide_x, wide_y, "sqeuclidean")
    sync()
    secs = time.perf_counter() - t0
    X = ssp.csr_matrix((data.astype(np.float64), idx.reshape(-1), indptr), shape=(nr, nc))
    X.sum_duplicates()
    Y, X64 = X[:yr], X[:64]
    xn = np.asarray(X64.multiply(X64).sum(1)).reshape(-1, 1)
    yn = np.asarray(Y.multiply(Y).sum(1)).reshape(1, -1)
    want = xn + yn - 2.0 * (X64 @ Y.T).toarray()
    rel = float(np.max(np.abs(got[:64].double().cpu().numpy() - want) / (xn + yn)))
    if rel > VAL_RTOL:
        raise AssertionError(f"sparse compact: error {rel} of |x|^2 + |y|^2")
    rec["compact"] = {"rows": nr, "cols": nc, "queries": yr, "s": secs,
                      "rel_err_f64_64_rows": rel}
    log(f"graph sparse compact: {nr} x {yr} over {nc} columns, {nz} a row, {secs * 1e3:.3f} ms, "
        f"64 rows against float64 numpy: error {rel:.3e} of |x|^2 + |y|^2")
    return rec


def graph_rmat(G, dev, sync):
    """rmat(16, 16, 2^20) with U(0, 1] weights, symmetrized; the Borůvka
    forest against scipy's in total weight and edge count."""
    from raft_tpu_torch import sparse
    from raft_tpu_torch.random import rmat
    from raft_tpu_torch.random.rng import make_generator

    s, m = G["rmat_scale"], G["rmat_edges"]
    edges = rmat(s, s, m, seed=0, device=dev)
    w = 1.0 - torch.rand((m,), generator=make_generator(1, dev), device=dev)
    coo = sparse.linalg.symmetrize(sparse.CooMatrix(edges[:, 0], edges[:, 1], w,
                                                    (1 << s, 1 << s)), "max")
    sync()
    t0 = time.perf_counter()
    tree = sparse.solver.mst(coo)
    sync()
    secs = time.perf_counter() - t0
    ours, want, n_edges = check_forest("rmat mst", tree, coo, 1 << s)
    log(f"graph rmat mst: scale {s}, {m} edges ({coo.nnz} symmetric entries), {secs:.3f} s, "
        f"forest {tree.nnz} edges weight {ours:.6f} (scipy {want:.6f}, {n_edges} edges)")
    return {"scale": s, "edges": m, "entries": coo.nnz, "s": secs, "forest_edges": tree.nnz,
            "weight": ours, "scipy_weight": want}


def graph_masked(G, x, dev, sync):
    """masked_l2_nn of noisy copies of the first rows against all of x, in
    G['groups'] random groups under a random 50% adjacency; 64 rows against
    float64 numpy (ids equal where the float64 gap exceeds the f32 error)."""
    from raft_tpu_torch.distance import masked_l2_nn
    from raft_tpu_torch.random.rng import make_generator

    gen = make_generator(2, dev)
    m, n, ng = G["masked_q"], x.shape[0], G["groups"]
    q = x[:m] + 0.5 * torch.randn((m, x.shape[1]), generator=gen, device=dev)
    groups = torch.randint(0, ng, (n,), generator=gen, device=dev)
    adj = torch.rand((m, ng), generator=gen, device=dev) < 0.5
    sync()
    t0 = time.perf_counter()
    d, i = masked_l2_nn(q, x, adj, groups, device=dev)
    sync()
    secs = time.perf_counter() - t0
    q64, x64 = q[:64].double().cpu().numpy(), x.double().cpu().numpy()
    full = ((q64 ** 2).sum(1)[:, None] + (x64 ** 2).sum(1)[None, :] - 2.0 * q64 @ x64.T)
    allowed = adj[:64].cpu().numpy()[:, groups.cpu().numpy()]
    full = np.where(allowed, full, np.inf)
    best = full.min(1)
    none = np.isinf(best)  # no allowed group: (inf, -1)
    scale = (q64 ** 2).sum(1) + (x64 ** 2).sum(1).max()
    got_i = i[:64].cpu().numpy().astype(np.int64)
    got_d = d[:64].double().cpu().numpy()
    if not (np.all(got_i[none] == -1) and np.all(np.isinf(got_d[none]))
            and np.all(got_i[~none] >= 0)):
        raise AssertionError("masked_l2_nn: rows without an allowed group differ")
    at_got = full[np.arange(64), np.maximum(got_i, 0)]
    err = float(np.max(np.where(none, 0.0, np.abs(got_d - best) / scale)))
    gap = float(np.max(np.where(none, 0.0, (at_got - best) / scale)))
    if err > VAL_RTOL or gap > VAL_RTOL:
        raise AssertionError(f"masked_l2_nn: distance error {err}, id gap {gap} of the scale")
    same = float(np.mean(got_i == full.argmin(1)))
    log(f"graph masked_l2_nn: {m} x {n}, {ng} groups, 50% adjacency, {secs * 1e3:.3f} ms; 64 "
        f"rows against float64: ids equal {same:.4f} (the others within {gap:.2e} of the "
        f"scale), distance error {err:.2e}")
    return {"queries": m, "rows": n, "groups": ng, "s": secs, "ids_equal_f64": same,
            "rel_err": err}


def graph_lap(G, dev, sync):
    """linear_assignment on an n x n U(0, 1) cost: a permutation, its total
    within LAP_GATE of scipy's optimum."""
    from scipy.optimize import linear_sum_assignment

    from raft_tpu_torch.random.rng import make_generator
    from raft_tpu_torch.solver import linear_assignment

    n = G["lap_n"]
    cost = torch.rand((n, n), generator=make_generator(3, dev), device=dev)
    sync()
    t0 = time.perf_counter()
    _, cols = linear_assignment(cost, device=dev)
    sync()
    secs = time.perf_counter() - t0
    c = cost.cpu().numpy()
    col = cols.cpu().numpy()
    if sorted(col.tolist()) != list(range(n)):
        raise AssertionError("linear_assignment: not a permutation")
    r, cc = linear_sum_assignment(c)
    got, want = float(c[np.arange(n), col].sum()), float(c[r, cc].sum())
    if got > want * LAP_GATE:
        raise AssertionError(f"linear_assignment: total {got} > {LAP_GATE} x scipy {want}")
    log(f"graph lap: n {n}, {secs:.3f} s, total {got:.6f} (scipy {want:.6f}, ratio "
        f"{got / want:.6f})")
    return {"n": n, "s": secs, "total": got, "scipy_total": want}


def graph_path(g, dev, sync):
    """The graph path: single-linkage, spectral, the sparse
    distances, the RMAT MST, the masked NN and the LAP, under the
    committed tuned table (kernel 6 takes the k-NN selects), each part
    with its launch counts set to 0 just before it and read just after.
    Gates: the host library loaded; kernel 6 launched by single-linkage
    and the sparse k-NN, kernel 8 by single-linkage L1 and the sparse
    metrics; each part's own gates. Returns (summary, kernel rows)."""
    from raft_tpu_torch import native
    from raft_tpu_torch.ops import _launch
    from raft_tpu_torch.ops import pairwise_tiled as pt
    from raft_tpu_torch.ops import select_counting as sc
    from raft_tpu_torch.random import make_blobs

    G = GRAPH_REHEARSE if g.rehearse else GRAPH
    if not native.available():
        raise AssertionError(f"graph host library did not load: {native.load_error()}")
    t_all = time.perf_counter()
    out = {"sizes": G, "launches": {}}
    rows = []

    def need(part, counts, names):
        out["launches"][part] = counts
        missing = [name for name in names if counts[name] <= 0]
        log(f"path graph {part}: launches {counts}")
        if missing and dev.type == "cuda":
            raise AssertionError(f"graph {part}: kernels never launched: {missing}")

    x, truth = make_blobs(G["n"], G["dim"], n_clusters=G["blobs"], center_box=(-5.0, 5.0),
                          seed=g.seed, device=dev)
    truth = truth.cpu().numpy()
    with committed(dev):
        _launch.reset_launch_counts()
        with FirstCall(sc, "counting_select_min") as sel:
            out["linkage"] = graph_linkage(x, truth, "sqeuclidean", dev, sync)
        need("linkage", _launch.launch_counts(), ("counting_select_min",))
        l1 = G["l1_rows"]
        _launch.reset_launch_counts()
        with FirstCall(pt, "pairwise_tiled") as l1_spy:
            out["linkage_l1"] = graph_linkage(x[:l1], truth[:l1], "l1", dev, sync)
        need("linkage_l1", _launch.launch_counts(), ("pairwise_tiled",))
        out["masked_nn"] = graph_masked(G, x, dev, sync)
        _launch.reset_launch_counts()
        with FirstCall(pt, "pairwise_tiled") as sp_spy, FirstCall(sc, "counting_select_min") as \
                sp_sel:
            out["sparse"] = graph_sparse(G, dev, sync, np.random.default_rng(g.seed + 4))
        need("sparse", _launch.launch_counts(), ("pairwise_tiled", "counting_select_min"))
        # the spectral graph is a k-NN graph too: its selects launch kernel 6
        _launch.reset_launch_counts()
        out["spectral"] = graph_spectral(G, dev, sync, g.seed)
        need("spectral", _launch.launch_counts(), ("counting_select_min",))
        out["rmat"] = graph_rmat(G, dev, sync)
        out["lap"] = graph_lap(G, dev, sync)
    counts = out["launches"]
    (tile, k), _ = sel.calls[0]
    rows.append(counting_tile_row(tile, k, counts["linkage"]["counting_select_min"], g.reps,
                                  "knn_graph tile, single-linkage"))
    (tile, k), _ = sp_sel.calls[0]
    rows.append(counting_tile_row(tile, k, counts["sparse"]["counting_select_min"], g.reps,
                                  "sparse k-NN block"))
    (a, b, metric), _ = l1_spy.calls[0]
    rows.append(pairwise_row(a, b, metric, counts["linkage_l1"]["pairwise_tiled"], g.reps,
                             "knn_graph tile, single-linkage l1"))
    (a, b, metric), _ = sp_spy.calls[0]
    rows.append(pairwise_row(a, b, metric, counts["sparse"]["pairwise_tiled"], g.reps,
                             "sparse pairwise, query block against the densified rows"))
    del sel, sp_sel, l1_spy, sp_spy, tile, a, b
    out["wall_s"] = time.perf_counter() - t_all
    log("graph summary " + json.dumps(out))
    return out, rows


# ---------------------------------------------------------------------------
# phase 4e: the rest of the single-device primitives
# ---------------------------------------------------------------------------

#: phase 4e's sizes: 2^20 (lat, lon) points in 64 gaussian cities (std
#: CITY_STD rad) plus 10% uniform background; 2^20 uniform 3-D points
#: centred at the origin (the expanded L2's f32 error scales with |x|^2)
#: and 65,536 queries; 2,048 range queries at a mean degree near 32; the
#: graph path's 262,144 x 96 blobs in 8 clusters for the evaluation and
#: the streamed build (n_lists 512, 8 batches); far_q queries at far_r
#: (10 to 40) from the cube's centre, where the bound's relative slack
#: lets many balls survive pass 1 (pass 2); the load's rate is read on a
#: file of the blobs' shape (about 100 MB), load_reads times by each reader
PRIM = dict(hav_n=1 << 20, cities=64, city_std=0.02, background=0.1, k=16, hav_truth=4096,
            l2_n=1 << 20, l2_q=65_536, far_q=1024, far_r=(10.0, 40.0), eps_q=2048,
            degree=32, eval_n=262_144, eval_dim=96, eval_blobs=8, gram_m=4096, gamma=1e-3,
            pca_n=32_768, tw_k=5, stream_lists=512, stream_batches=8, stream_q=4096,
            load_batch=131_072, rate_batch=32_768, load_reads=3, sleep_s=2.0, cancel_s=0.2)
PRIM_REHEARSE = dict(PRIM, hav_n=20_000, cities=16, hav_truth=512, l2_n=20_000, l2_q=2048,
                     far_q=256, eps_q=256, eval_n=8192, eval_dim=16, gram_m=256, pca_n=2048,
                     stream_lists=32, stream_q=256, load_batch=4096, rate_batch=1024)
#: the gates: distances at each rank (haversine, against float64), the
#: tie-aware recall slack of the 3-D queries and of the far ones (their
#: squared distances are large beside the expanded form's f32 error), eps
#: slack, scores (absolute) and gram entries (relative)
HAV_RTOL, L2_SLACK, FAR_SLACK, EPS_SLACK, SCORE_ATOL, GRAM_RTOL = (1e-5, 2e-3, 1e-5, 1e-3, 1e-4,
                                                                   1e-5)


class ProbeTally(Spy):
    """Counts the ball cover's probe passes (`ball_cover._probe_exact`): a
    call over more balls than p1 is a pass-2 block. `pass_no` is the pass
    of the call under way, for `KCalls`."""

    def __init__(self, module):
        super().__init__(module, "_probe_exact")
        self.blocks, self.queries, self.p2, self.pass_no = [0, 0], [0, 0], set(), 1

    def __call__(self, index, rows, q, lb, p, k):
        self.pass_no = 2 if p > min(index.n_landmarks, max(32, k)) else 1
        self.blocks[self.pass_no - 1] += 1
        self.queries[self.pass_no - 1] += q.shape[0]
        if self.pass_no == 2:
            self.p2.add(p)
        return self.orig(index, rows, q, lb, p, k)

    def record(self):
        return {"pass1_blocks": self.blocks[0], "pass2_blocks": self.blocks[1],
                "pass2_queries": self.queries[1], "p2": sorted(self.p2)}


class KCalls(Spy):
    """Keeps the first call of a kernel wrapper for each (pass, k) of the
    ball cover, the pass read from `tally`: each pass's ball select (k =
    its ball count) and candidate select."""

    def __init__(self, module, name, tally):
        super().__init__(module, name)
        self.tally = tally

    def __call__(self, *args, **kwargs):
        key = (self.tally.pass_no, args[1])
        if all(c[0] != key for c in self.calls):
            self.calls.append((key, args))
        return self.orig(*args, **kwargs)


def city_points(P, rng):
    """(n, 2) f32 (lat, lon) in radians: `cities` gaussian clusters (std
    `city_std`, the longitude spread widened by 1 / cos(lat)) and a
    `background` share uniform on the sphere, shuffled."""
    n = P["hav_n"]
    n_bg = int(n * P["background"])
    c_lat = np.arcsin(rng.uniform(-0.9, 0.9, P["cities"]))
    c_lon = rng.uniform(-np.pi, np.pi, P["cities"])
    who = rng.integers(0, P["cities"], n - n_bg)
    lat = c_lat[who] + P["city_std"] * rng.standard_normal(n - n_bg)
    lon = c_lon[who] + P["city_std"] * rng.standard_normal(n - n_bg) / np.cos(c_lat[who])
    lat = np.concatenate([lat, np.arcsin(rng.uniform(-1, 1, n_bg))])
    lon = np.concatenate([lon, rng.uniform(-np.pi, np.pi, n_bg)])
    pts = np.stack([np.clip(lat, -np.pi / 2, np.pi / 2), (lon + np.pi) % (2 * np.pi) - np.pi], 1)
    return pts[rng.permutation(n)].astype(np.float32)


def write_fbin(path, arr):
    with open(path, "wb") as f:
        np.asarray(arr.shape, np.uint32).tofile(f)
        arr.tofile(f)


def ring_read(path, shape, batch_rows, dev):
    """The rows of an .fbin file through the ring reader
    (`io.FileBatchLoader(native=True)`), copied into one tensor on `dev`."""
    from raft_tpu_torch import io

    dst = torch.empty(shape, dtype=torch.float32, device=dev)
    s = 0
    for batch, valid in io.FileBatchLoader(path, batch_rows, native=True, copy=False):
        # a copy from pageable memory returns once the host rows are read,
        # before the next step releases the ring slot
        dst[s:s + valid].copy_(torch.from_numpy(batch[:valid]))
        s += valid
    return dst


def iterator_read(path, shape, batch_rows, dev):
    """The rows of an .fbin file through `BatchLoadIterator` over its
    memmap, copied into one tensor on `dev`."""
    from raft_tpu_torch.neighbors import BatchLoadIterator

    mm = np.memmap(path, dtype=np.float32, mode="r", offset=8, shape=shape)
    dst = torch.empty(shape, dtype=torch.float32, device=dev)
    s = 0
    for b, v in BatchLoadIterator(mm, batch_rows, device=dev):
        dst[s:s + v].copy_(b[:v])
        s += v
    return dst


def prim_load(P, g, dev, sync, tmp, rng):
    """Write the two datasets as .fbin; read the (lat, lon) file through
    the ring reader and the 3-D file through `BatchLoadIterator`, onto the
    card; each equal to the written rows byte for byte. The rate: a file
    of the blobs' shape (eval_n x eval_dim f32), read load_reads times by
    each reader in batches of rate_batch rows, each read byte for byte
    (page cache warm: the file was just written)."""
    from raft_tpu_torch import native

    if native.loader_lib() is None:
        raise AssertionError(f"ring reader library did not load: {native.loader_error()}")
    hav = city_points(P, rng)
    pts3 = (rng.random((P["l2_n"], 3), dtype=np.float32) - np.float32(0.5))
    big = np.random.default_rng(g.seed + 11).random((P["eval_n"], P["eval_dim"]),
                                                    dtype=np.float32)
    paths = {"hav": os.path.join(tmp, "cities.fbin"), "l2": os.path.join(tmp, "cube.fbin"),
             "big": os.path.join(tmp, "rows.fbin")}
    t0 = time.perf_counter()
    for name, arr in (("hav", hav), ("l2", pts3), ("big", big)):
        write_fbin(paths[name], arr)
    rec = {"write_s": time.perf_counter() - t0, "rate_bytes": big.nbytes}
    hav_t = ring_read(paths["hav"], hav.shape, P["load_batch"], dev)
    pts3_t = iterator_read(paths["l2"], pts3.shape, P["load_batch"], dev)
    big_t = torch.from_numpy(big).to(dev)
    for name, got, want in (("ring", hav_t, torch.from_numpy(hav).to(dev)),
                            ("iterator", pts3_t, torch.from_numpy(pts3).to(dev))):
        if not torch.equal(got, want):
            raise AssertionError(f"load {name}: the rows on the card differ from the file")
    for name, read in (("ring", ring_read), ("iterator", iterator_read)):
        rates = []
        for _ in range(P["load_reads"]):
            sync()
            t0 = time.perf_counter()
            got = read(paths["big"], big.shape, P["rate_batch"], dev)
            sync()
            rates.append(big.nbytes / (time.perf_counter() - t0) / 1e9)
            if not torch.equal(got, big_t):
                raise AssertionError(f"load {name}: the rows on the card differ from the file")
            del got
        rec[f"{name}_gb_s"] = rates
    log(f"prim load: wrote {hav.nbytes + pts3.nbytes + big.nbytes} bytes in "
        f"{rec['write_s']:.3f} s; the two datasets bytes equal; {big.nbytes} bytes in batches "
        f"of {P['rate_batch']} rows, GB/s a read (warm): ring reader "
        + ", ".join(f"{r:.3f}" for r in rec["ring_gb_s"]) + "; BatchLoadIterator "
        + ", ".join(f"{r:.3f}" for r in rec["iterator_gb_s"]) + "; bytes equal")
    return hav_t, pts3_t, rec


def prim_haversine(P, hav, dev, sync):
    """build_index(haversine) and the exact all-k-NN: (index, d, i, build
    seconds, query seconds)."""
    from raft_tpu_torch.neighbors import ball_cover

    sync()
    t0 = time.perf_counter()
    index = ball_cover.build_index(hav, metric="haversine", device=dev)
    sync()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d, i = ball_cover.all_knn_query(index, P["k"])
    sync()
    return index, d, i, build_s, time.perf_counter() - t0


def hav_truth(x, q, k):
    """The exact top-k of the queries q among the rows x by a float64
    haversine (torch.topk, nearest first)."""
    x64 = x.double()
    lat2, lon2 = x64[:, 0][None, :], x64[:, 1][None, :]
    cos2 = torch.cos(lat2)
    vals, ids = [], []
    for s in range(0, q.shape[0], 64):
        q64 = q[s:s + 64].double()
        lat1, lon1 = q64[:, 0:1], q64[:, 1:2]
        h = (torch.sin(0.5 * (lat2 - lat1)) ** 2
             + torch.cos(lat1) * cos2 * torch.sin(0.5 * (lon2 - lon1)) ** 2)
        v, i = torch.topk(2.0 * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0))), k, dim=1,
                          largest=False)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def check_haversine(P, hav, run, tally, rng):
    """Gates of the haversine all-k-NN on `hav_truth` sampled rows: the
    distances at each rank within HAV_RTOL of the float64 truth, ids equal
    outside groups of equal distance."""
    index, d, i, build_s, query_s = run
    sample = torch.as_tensor(rng.choice(hav.shape[0], P["hav_truth"], replace=False),
                             device=hav.device)
    td, ti = hav_truth(hav, hav[sample], P["k"])
    got_d, got_i = d[sample].double(), i[sample]
    err = (got_d - td).abs()
    rel = float(torch.where(td > 0, err / td.clamp(min=1e-300), err).max())
    if rel > HAV_RTOL or not tie_equal(td, ti, got_d, got_i, HAV_RTOL):
        raise AssertionError(f"ball cover haversine: {rel} from the float64 truth, or ids differ "
                             f"outside ties")
    sizes = (index.row_ids >= 0).sum(1)
    rec = {"rows": hav.shape[0], "landmarks": index.n_landmarks, "max_ball": int(sizes.max()),
           "mean_ball": float(sizes.float().mean()), "build_s": build_s, "query_s": query_s,
           "max_rel_err": rel, **tally.record()}
    log(f"prim haversine: n {hav.shape[0]}, L {index.n_landmarks} (balls mean "
        f"{rec['mean_ball']:.1f}, max {rec['max_ball']}), build {build_s:.3f} s, all_knn_query "
        f"k {P['k']} {query_s:.3f} s ({rec['pass1_blocks']} blocks, pass 2 "
        f"{rec['pass2_blocks']} blocks of {rec['pass2_queries']} queries); {P['hav_truth']} rows "
        f"against the float64 truth: distances within {rel:.2e}, ids equal outside ties")
    return rec


def l2_truth_check(pts3, q, ids, k, slack=L2_SLACK):
    """Tie-aware recall against float64: each returned id's float64
    squared distance is at most the true k-th x (1 + slack); ids
    distinct. Returns the recall (1.0 to pass)."""
    x64 = pts3.double()
    xn = (x64 * x64).sum(1)
    ok = 0
    for s in range(0, q.shape[0], 256):
        q64 = q[s:s + 256].double()
        d = (q64 * q64).sum(1, keepdim=True) + xn[None, :] - 2.0 * q64 @ x64.T
        kth = torch.topk(d, k, dim=1, largest=False).values[:, -1]
        got = ((q64[:, None, :] - x64[ids[s:s + 256].long()]) ** 2).sum(-1)
        ok += int((got <= kth[:, None] * (1 + slack) + 1e-12).sum())
    distinct = all(len(set(r)) == k for r in ids.cpu().numpy().tolist())
    return ok / ids.numel() if distinct else 0.0


def prim_l2(P, pts3, q, dev, sync):
    """build_index(sqeuclidean) on the 3-D rows and knn_query of the
    queries q: (index, i, build seconds, query seconds)."""
    from raft_tpu_torch.neighbors import ball_cover

    sync()
    t0 = time.perf_counter()
    index = ball_cover.build_index(pts3, metric="sqeuclidean", device=dev)
    sync()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, i = ball_cover.knn_query(index, q, P["k"])
    sync()
    return index, i, build_s, time.perf_counter() - t0


def check_l2(P, pts3, q, run, tally, what, slack):
    """Gate of a 3-D k-NN: tie-aware recall 1.0 against float64."""
    i, query_s = run
    rec_k = l2_truth_check(pts3, q, i, P["k"], slack)
    if rec_k < 1.0:
        raise AssertionError(f"ball cover sqeuclidean ({what}): tie-aware recall {rec_k} < 1.0")
    rec = {"queries": q.shape[0], "query_s": query_s, "recall": rec_k, **tally.record()}
    log(f"prim sqeuclidean ({what}): knn_query {q.shape[0]} x k {P['k']} {query_s:.3f} s "
        f"({rec['pass1_blocks']} blocks; pass 2 {rec['pass2_blocks']} blocks of "
        f"{rec['pass2_queries']} queries at p2 {rec['p2']}), tie-aware recall {rec_k:.6f} "
        f"against float64 (slack {slack})")
    return rec


def far_queries(P, rng, dev):
    """far_q queries at a distance in far_r from the cube's centre, in
    uniform directions."""
    v = rng.standard_normal((P["far_q"], 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = rng.uniform(P["far_r"][0], P["far_r"][1], (P["far_q"], 1))
    return torch.as_tensor((v * r).astype(np.float32), device=dev)


def prim_far(P, index, q, sync):
    """knn_query of the far queries on the 3-D index: (i, seconds)."""
    from raft_tpu_torch.neighbors import ball_cover

    sync()
    t0 = time.perf_counter()
    _, i = ball_cover.knn_query(index, q, P["k"])
    sync()
    return i, time.perf_counter() - t0


def prim_eps(P, index, q, sync):
    """eps_nn_query of the first eps_q queries, eps for a mean degree near
    `degree` (a ball of radius r around a uniform point holds n 4/3 pi r^3
    rows): (queries, eps, adj, deg, seconds)."""
    from raft_tpu_torch.neighbors import ball_cover

    eps = float((P["degree"] * 3 / (4 * np.pi * P["l2_n"])) ** (2 / 3))
    qe = q[:P["eps_q"]]
    sync()
    t0 = time.perf_counter()
    adj, deg = ball_cover.eps_nn_query(index, qe, eps)
    sync()
    return qe, eps, adj, deg, time.perf_counter() - t0


def check_eps(pts3, run):
    """Gate: the adjacency equals the float64 one but for pairs within
    EPS_SLACK of eps, and the degrees are its row sums."""
    qe, eps, adj, deg, eps_s = run
    x64 = pts3.double()
    bad = 0
    for s in range(0, qe.shape[0], 256):
        d64 = ((qe[s:s + 256].double()[:, None, :] - x64[None]) ** 2).sum(-1)
        near = (d64 - eps).abs() <= EPS_SLACK * eps
        bad += int(((d64 <= eps) != adj[s:s + 256])[~near].sum())
    if bad or not torch.equal(deg, adj.sum(1, dtype=torch.int32)):
        raise AssertionError(f"eps_nn_query: {bad} pairs differ from float64 outside the slack")
    rec = {"queries": qe.shape[0], "eps": eps, "eps_s": eps_s,
           "mean_degree": float(deg.float().mean())}
    log(f"prim eps: eps_nn_query {qe.shape[0]} queries eps {eps:.4e} {eps_s * 1e3:.3f} ms, "
        f"mean degree {rec['mean_degree']:.2f}, equal to float64 outside {EPS_SLACK} of eps")
    return rec


def f64_silhouette(x, labels, k):
    x64 = x.double()
    n = x.shape[0]
    onehot = torch.nn.functional.one_hot(labels.long(), k).double()
    counts = onehot.sum(0)
    xn = (x64 * x64).sum(1)
    sums = torch.empty((n, k), dtype=torch.float64, device=x.device)
    for s in range(0, n, 2048):
        d = torch.sqrt(torch.clamp(xn[s:s + 2048, None] + xn[None, :] - 2.0 * x64[s:s + 2048]
                                   @ x64.T, min=0.0))
        sums[s:s + 2048] = d @ onehot
    lab = labels.long()
    own = counts[lab]
    a = torch.where(own > 1, sums.gather(1, lab[:, None])[:, 0] / (own - 1).clamp(min=1), 0.0)
    other = (sums / counts.clamp(min=1)).masked_fill(onehot.bool(), float("inf"))
    b = other.min(1).values
    return float(torch.where(own > 1, (b - a) / torch.maximum(a, b).clamp(min=1e-30), 0.0).mean())


def f64_trustworthiness(x, emb, k):
    x64, e64 = x.double(), emb.double()
    n = x.shape[0]
    xn, en = (x64 * x64).sum(1), (e64 * e64).sum(1)
    col = torch.arange(n, device=x.device)
    penalty = 0.0
    for s in range(0, n, 2048):
        de = en[s:s + 2048, None] + en[None, :] - 2.0 * e64[s:s + 2048] @ e64.T
        nbrs = torch.topk(de, k + 1, dim=1, largest=False).indices[:, 1:]
        dx = xn[s:s + 2048, None] + xn[None, :] - 2.0 * x64[s:s + 2048] @ x64.T
        for t in range(k):
            j = nbrs[:, t:t + 1]
            dj = dx.gather(1, j)
            rank = ((dx < dj) | ((dx == dj) & (col[None, :] < j))).sum(1)
            penalty += float(torch.clamp(rank - k, min=0).double().sum())
    return 1.0 - 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)) * penalty


def v_measure64(a, b):
    """sklearn's v-measure of two labelings in float64 (numpy only)."""
    _, ai = np.unique(np.asarray(a), return_inverse=True)
    _, bi = np.unique(np.asarray(b), return_inverse=True)
    cont = np.zeros((ai.max() + 1, bi.max() + 1), np.float64)
    np.add.at(cont, (ai, bi), 1.0)
    p = cont / cont.sum()

    def ent(v):
        v = v[v > 0]
        return float(-(v * np.log(v)).sum())

    pi, pj = p.sum(1), p.sum(0)
    nz = p > 0
    mi = float((p[nz] * np.log(p[nz] / np.outer(pi, pj)[nz])).sum())
    h = mi / ent(pi) if ent(pi) > 0 else 1.0
    c = mi / ent(pj) if ent(pj) > 0 else 1.0
    return 2 * h * c / (h + c) if h + c > 0 else 0.0


def prim_eval(P, g, dev, sync):
    """Evaluation on the graph path's blobs: silhouette of the true labels,
    ARI and v-measure of a Lloyd fit, the RBF gram of (gram_m, n), and on
    a pca_n subsample a 2-D PCA (mean_center, rsvd); each against the same
    formula in float64 on the card. Returns (record, x, the subsample, its
    embedding) for the streamed build and the trustworthiness."""
    from raft_tpu_torch import linalg, stats
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.distance import KernelParams, KernelType, gram_matrix
    from raft_tpu_torch.random import make_blobs

    x, truth = make_blobs(P["eval_n"], P["eval_dim"], n_clusters=P["eval_blobs"],
                          center_box=(-5.0, 5.0), seed=g.seed, device=dev)
    rec, times = {}, {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = time.perf_counter() - t0
        return out

    sil = float(timed("silhouette", lambda: stats.silhouette_score(x, truth, device=dev)))
    sil64 = f64_silhouette(x, truth, P["eval_blobs"])
    centers, _, _ = timed("kmeans", lambda: kmeans.fit(x, n_clusters=P["eval_blobs"],
                                                       max_iter=20, seed=g.seed, device=dev))
    labels = kmeans.predict(x, centers, device=dev)
    ari_v = float(timed("ari", lambda: stats.adjusted_rand_index(truth, labels, device=dev)))
    vm = float(timed("v_measure", lambda: stats.v_measure(truth, labels, device=dev)))
    t_np, l_np = truth.cpu().numpy(), labels.cpu().numpy()
    ari64, vm64 = ari(t_np, l_np), v_measure64(t_np, l_np)
    params = KernelParams(KernelType.RBF, gamma=P["gamma"])
    gm = timed("gram", lambda: gram_matrix(x[:P["gram_m"]], x, params, device=dev))
    x64 = x.double()
    gram_err = 0.0
    for s in range(0, gm.shape[0], 512):
        a = x64[s:min(s + 512, gm.shape[0])]
        sq = (a * a).sum(1)[:, None] + (x64 * x64).sum(1)[None, :] - 2.0 * a @ x64.T
        want = torch.exp(-P["gamma"] * sq.clamp(min=0.0))
        gram_err = max(gram_err, float(((gm[s:s + 512].double() - want).abs() / want).max()))
    del gm
    sub = x[torch.as_tensor(np.random.default_rng(g.seed + 5).choice(P["eval_n"], P["pca_n"],
                                                                     replace=False),
                            device=dev)]
    u, s_, _ = timed("pca", lambda: linalg.rsvd(stats.mean_center(sub, device=dev), 2,
                                                device=dev))
    scores = {"silhouette": (sil, sil64), "ari": (ari_v, ari64), "v_measure": (vm, vm64)}
    for name, (got, want) in scores.items():
        if not abs(got - want) <= SCORE_ATOL:
            raise AssertionError(f"stats {name}: {got} against float64 {want}")
    if gram_err > GRAM_RTOL:
        raise AssertionError(f"gram_matrix rbf: relative error {gram_err} > {GRAM_RTOL}")
    rec = {"rows": P["eval_n"], "dim": P["eval_dim"], "scores": scores,
           "gram_rel_err": gram_err, "s": times}
    log(f"prim eval: n {P['eval_n']} x {P['eval_dim']}, " + ", ".join(
        f"{name} {got:.6f} (float64 {want:.6f})" for name, (got, want) in scores.items())
        + f"; gram rbf ({P['gram_m']}, {P['eval_n']}) within {gram_err:.2e} of float64; seconds "
        + ", ".join(f"{k_} {v:.3f}" for k_, v in times.items()))
    return rec, x, sub, u * s_


def prim_tw(P, sub, emb, dev, sync):
    """trustworthiness_score of the PCA embedding: (score, seconds)."""
    from raft_tpu_torch import stats

    sync()
    t0 = time.perf_counter()
    tw = float(stats.trustworthiness_score(sub, emb, n_neighbors=P["tw_k"], device=dev))
    return tw, time.perf_counter() - t0


def check_tw(P, sub, emb, run):
    """Gate: the trustworthiness within SCORE_ATOL of float64."""
    tw, tw_s = run
    tw64 = f64_trustworthiness(sub, emb, P["tw_k"])
    if not abs(tw - tw64) <= SCORE_ATOL:
        raise AssertionError(f"stats trustworthiness: {tw} against float64 {tw64}")
    log(f"prim trustworthiness: {P['pca_n']} rows, 2-D PCA, n_neighbors {P['tw_k']}: {tw:.6f} "
        f"(float64 {tw64:.6f}) in {tw_s:.3f} s")
    return {"rows": P["pca_n"], "score": (tw, tw64), "s": tw_s}


def prim_stream(P, x, dev, sync):
    """extend_batched(ivf_flat.extend) of the blobs from host memory in
    stream_batches batches into an empty IVF-Flat index (n_lists
    stream_lists), against the one-shot build at n_probes = n_lists: a
    tie-aware recall of 1.0 (bit for bit reported)."""
    from raft_tpu_torch.neighbors import batch_loader, ivf_flat

    n_lists = P["stream_lists"]
    host = x.cpu().numpy()
    sync()
    t0 = time.perf_counter()
    one = ivf_flat.build(ivf_flat.IndexParams(n_lists=n_lists), x, device=dev)
    sync()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    empty = ivf_flat.build(ivf_flat.IndexParams(n_lists=n_lists, add_data_on_build=False), x,
                           device=dev)
    sync()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    streamed = batch_loader.extend_batched(ivf_flat.extend, empty, host,
                                           -(-host.shape[0] // P["stream_batches"]))
    sync()
    stream_s = time.perf_counter() - t0
    q = x[:P["stream_q"]] + 0.01
    sp = ivf_flat.SearchParams(n_probes=n_lists)
    d1, i1 = ivf_flat.search(sp, one, q, 10)
    d2, i2 = ivf_flat.search(sp, streamed, q, 10)
    same = bool(torch.equal(d1, d2) and torch.equal(i1, i2))
    if not tie_equal(d1, i1, d2, i2, 0.0):
        raise AssertionError("streamed IVF-Flat: answers differ from the one-shot build")
    rec = {"rows": host.shape[0], "n_lists": n_lists, "batches": P["stream_batches"],
           "one_shot_s": one_s, "train_s": train_s, "stream_s": stream_s, "bit_equal": same}
    log(f"prim stream: IVF-Flat {n_lists} lists, one-shot build {one_s:.3f} s; train "
        f"{train_s:.3f} s + {P['stream_batches']} extend_batched batches {stream_s:.3f} s; "
        f"{P['stream_q']} queries at n_probes {n_lists}: tie-aware recall 1.0"
        + (", bit for bit" if same else ""))
    return rec


class _Pending:
    """A waitable that is never ready (the CPU rehearsal's stand-in for a
    long kernel)."""

    def query(self):
        return False


def prim_interrupt(P, dev):
    """interruptible.cancel from another thread stops a synchronize that
    waits on a sleep kernel (`torch.cuda._sleep`), with
    InterruptedException; the kernel then drains."""
    import threading

    from raft_tpu_torch.core import interruptible

    if dev.type == "cuda":
        # the sleep kernel counts clock cycles: calibrate cycles a second
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        per_s = 10_000_000 / (start.elapsed_time(end) / 1e3)
        for _ in range(8):
            torch.cuda._sleep(int(P["sleep_s"] / 8 * per_s))
        waitable = torch.cuda.Event()
        waitable.record()
    else:
        waitable = _Pending()
    timer = threading.Timer(P["cancel_s"], interruptible.cancel, args=(threading.get_ident(),))
    t0 = time.perf_counter()
    timer.start()
    try:
        interruptible.synchronize(waitable, timeout_s=30)
        raise AssertionError("interruptible.synchronize returned instead of raising")
    except interruptible.InterruptedException:
        waited = time.perf_counter() - t0
    finally:
        timer.join()
    pending = dev.type == "cuda" and not waitable.query()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    drained = time.perf_counter() - t0
    if waited > P["cancel_s"] + 0.5 or (dev.type == "cuda" and not pending):
        raise AssertionError(f"cancel: the wait ended after {waited:.3f} s, kernel pending "
                             f"{pending}")
    log(f"prim interrupt: cancel at {P['cancel_s']} s ended the wait on a {P['sleep_s']} s "
        f"sleep kernel after {waited:.3f} s (InterruptedException; kernel still running: "
        f"{pending}), drained at {drained:.3f} s")
    return {"waited_s": waited, "drained_s": drained, "kernel_pending": pending}


def primitives_path(g, dev, sync):
    """Phase 4e: load, the haversine and 3-D ball covers (uniform and far
    queries) with the range query, the evaluation stats, the
    trustworthiness, the streamed build and the interrupt, under the
    committed tuned table. Each part's launch counts are set to 0 just
    before it and read just after its drive; its checks run after that.
    Gates: each part's own; kernels 6 and 8 launched by the 3-D ball
    cover, its far queries and the trustworthiness, kernel 6 by the
    haversine ball cover; pass 2 ran for the far queries. Returns
    (summary, kernel rows)."""
    from raft_tpu_torch.neighbors import ball_cover as bc
    from raft_tpu_torch.ops import _launch
    from raft_tpu_torch.ops import pairwise_tiled as pt
    from raft_tpu_torch.ops import select_counting as sc

    P = PRIM_REHEARSE if g.rehearse else PRIM
    rng = np.random.default_rng(g.seed + 7)
    t_all = time.perf_counter()
    out = {"sizes": P, "launches": {}, "wall_s": {}, "check_s": {}}
    both = ("counting_select_min", "pairwise_tiled")

    def part(name, drive, check=None, need=()):
        _launch.reset_launch_counts()
        t0 = time.perf_counter()
        res = drive()
        sync()
        out["wall_s"][name] = time.perf_counter() - t0
        counts = _launch.launch_counts()
        out["launches"][name] = counts
        log(f"path primitives {name}: {out['wall_s'][name]:.3f} s, launches {counts}")
        missing = [k for k in need if counts[k] <= 0]
        if missing and dev.type == "cuda":
            raise AssertionError(f"primitives {name}: kernels never launched: {missing}")
        if check is None:
            return res
        t0 = time.perf_counter()
        rec = check(res)
        out["check_s"][name] = time.perf_counter() - t0
        return rec

    with tempfile.TemporaryDirectory(prefix="prim_") as tmp, committed(dev):
        hav, pts3, out["load"] = part("load", lambda: prim_load(P, g, dev, sync, tmp, rng))
        with ProbeTally(bc) as hav_t, KCalls(sc, "counting_select_min", hav_t) as hav_sel:
            out["haversine"] = part("haversine", lambda: prim_haversine(P, hav, dev, sync),
                                    lambda r: check_haversine(P, hav, r, hav_t, rng),
                                    ("counting_select_min",))
        del hav
        q = torch.as_tensor(rng.random((P["l2_q"], 3), dtype=np.float32) - np.float32(0.5),
                            device=dev)
        with (ProbeTally(bc) as l2_t, KCalls(sc, "counting_select_min", l2_t) as l2_sel,
              FirstCall(pt, "pairwise_tiled") as l2_lb):
            index, i, build_s, query_s = part("sqeuclidean", lambda: prim_l2(P, pts3, q, dev, sync),
                                              need=both)
            out["sqeuclidean"] = dict(check_l2(P, pts3, q, (i, query_s), l2_t, "uniform",
                                               L2_SLACK), rows=pts3.shape[0],
                                      landmarks=index.n_landmarks, build_s=build_s)
        qf = far_queries(P, rng, dev)
        with (ProbeTally(bc) as far_t, KCalls(sc, "counting_select_min", far_t) as far_sel,
              FirstCall(pt, "pairwise_tiled") as far_lb):
            out["far"] = part("far", lambda: prim_far(P, index, qf, sync),
                              lambda r: check_l2(P, pts3, qf, r, far_t, "far", FAR_SLACK), both)
        if out["far"]["pass2_blocks"] == 0:
            raise AssertionError("ball cover far queries: pass 2 never ran")
        out["eps"] = part("eps", lambda: prim_eps(P, index, q, sync),
                          lambda r: check_eps(pts3, r))
        del pts3, index, q, qf, i
        out["eval"], x, sub, emb = part("eval", lambda: prim_eval(P, g, dev, sync))
        with (FirstCall(pt, "pairwise_tiled") as tw_pt,
              FirstCall(sc, "counting_select_min") as tw_sel):
            out["trustworthiness"] = part("trustworthiness",
                                          lambda: prim_tw(P, sub, emb, dev, sync),
                                          lambda r: check_tw(P, sub, emb, r), both)
        del sub, emb
        out["stream"] = part("stream", lambda: prim_stream(P, x, dev, sync))
        del x
        out["interrupt"] = part("interrupt", lambda: prim_interrupt(P, dev))
    counts = out["launches"]
    rows = []
    for spy, part_name, what, passes in ((l2_sel, "sqeuclidean", "3-D", (1, 2)),
                                         (far_sel, "far", "3-D far queries", (2,)),
                                         (hav_sel, "haversine", "haversine", (1, 2))):
        for (pass_no, k), (tile, _) in spy.calls:
            if pass_no in passes:
                label = (f"ball cover {what}, pass {pass_no} "
                         + ("candidate select" if k == P["k"] else "ball select"))
                rows.append(counting_tile_row(tile, k, counts[part_name]["counting_select_min"],
                                              g.reps, label))
    for (tile, k), _ in tw_sel.calls:
        rows.append(counting_tile_row(tile, k, counts["trustworthiness"]["counting_select_min"],
                                      g.reps, "trustworthiness, the embedding's k-NN"))
    for spy, part_name, label in ((l2_lb, "sqeuclidean", "ball cover 3-D landmark bounds"),
                                  (far_lb, "far", "ball cover 3-D far queries' landmark bounds"),
                                  (tw_pt, "trustworthiness",
                                   "trustworthiness, the embedding's k-NN")):
        for (a, b, metric), _ in spy.calls:
            rows.append(pairwise_row(a, b, metric, counts[part_name]["pairwise_tiled"], g.reps,
                                     label))
    del l2_sel, far_sel, hav_sel, tw_sel, l2_lb, far_lb, tw_pt
    out["wall_s"]["phase"] = time.perf_counter() - t_all
    log("primitives summary " + json.dumps(out))
    return out, rows


# ---------------------------------------------------------------------------
# phase 4f: the observability layer on the main path
# ---------------------------------------------------------------------------

#: a span's MFU share (charged flops over its fenced time, against the
#: "h100" peaks) above this means a formula or a peak is wrong
OBS_SHARE_CAP = 1.05
#: how far a host-bound batch's time may differ between obs off and on,
#: measured in turns: the off windows' mean is held to the on windows'
#: range widened by this share of its mean, or by the range itself where
#: that is wider. Turns, because the same fused IVF-PQ batch (~3 ms,
#: host-bound), same state, read 3.06 to 5.15 ms within seconds on an
#: H100 (PERF.md §6): a reference taken minutes, or even seconds, apart
#: from the reading held no 15% band
HOST_DRIFT = 0.15
#: the CUDA kernels of kernels 1 and 2 as the profiler names them
TRACE_SYMBOLS = {"fused_list_topk": ("rtt::list_kernel<",),
                 "fused_topk": ("rtt::tc_range_kernel", "rtt::flat_kernel")}
#: the kernels the enabled drive must launch (1, 2, 3, 4, 6, 7)
OBS_KERNELS = ("fused_list_topk", "fused_topk", "fused_list_topk_int8", "pq_list_scan",
               "counting_select_min", "fused_bitplane_topk")

_FLIGHT_CHILD = """
import sys
sys.path.insert(0, {root!r})
from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
assert obs.enabled() and obs.flight.installed() is not None
for i in range(3):
    obs.event("drill", step=i)
plan = faults.FaultPlan([faults.Fault("kill_rank", site="mutation.log.commit", count=1)],
                        seed=0)
with plan.install():
    faults.crash_point("mutation.log.commit")
print("survived")
"""

_FAULT_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from raft_tpu_torch.core.config import is_device_fault
out = {{}}
x = torch.zeros(16, device="cuda")
for step, fn in (("first", lambda: x[torch.tensor([1 << 20], device="cuda")]),
                 ("later", lambda: torch.ones(4, device="cuda") * 2)):
    try:
        fn()
        torch.cuda.synchronize()
        out[step] = None
    except Exception as e:
        out[step] = str(e)[:300]
        out[step + "_fault"] = is_device_fault(e)
print(json.dumps(out))
"""


def obs_setup(g, dev, sync):
    """The data, indexes, gates and reference windows phase 4f reuses,
    made here when it runs alone (`--obs`): the main path's data, truth
    and IVF-PQ index, the fused bf16 n_probes-8 rung's windows, the
    default ladder's gate rung and its windows (both under the untuned
    table, as phase 4 times them), and the IVF-Flat and RaBitQ indexes
    with their fused engines' first rungs that clear the gate."""
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq, ivf_rabitq
    from raft_tpu_torch.neighbors.refine import refine

    data_np, queries_np = make_blobs(g.seed, g.n, g.dim, g.nq, g.n_lists)
    dataset = torch.from_numpy(data_np).to(dev)
    queries = torch.from_numpy(queries_np).to(dev)
    t0 = time.perf_counter()
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=g.n_lists, pq_dim=g.dim // 2,
                                            kmeans_n_iters=10), dataset, seed=g.seed, device=dev)
    flat_index = ivf_flat.build(ivf_flat.IndexParams(n_lists=g.n_lists, kmeans_n_iters=10),
                                dataset, seed=g.seed, device=dev)
    rb_index = ivf_rabitq.build(ivf_rabitq.IndexParams(n_lists=g.n_lists, kmeans_n_iters=10),
                                dataset, seed=g.seed, device=dev)
    _, truth = brute_force.knn(dataset, queries, g.k, engine="fused", device=dev)
    sync()
    log(f"obs setup: data, three builds and the truth in {time.perf_counter() - t0:.3f} s")

    def pq_run(params):
        return lambda: refine(dataset, queries, ivf_pq.search(params, index, queries,
                                                              4 * g.k)[1],
                              g.k, strategy="fused", device=dev)

    ref = {}
    with table({}):
        fused8 = ivf_pq.SearchParams(n_probes=8, score_mode="recon8_list", trim_engine="fused")
        pq_run(fused8)()  # the first call, as phase 4's rung makes it before its windows
        ref["ivf_pq fused"] = timed_windows(g, pq_run(fused8), sync)[1]
        for np_pq in PROBE_LADDER:
            run = pq_run(ivf_pq.SearchParams(n_probes=np_pq))
            if recall(run()[1], truth) >= RECALL_GATE:
                break
        ref["ivf_pq default"] = timed_windows(g, run, sync)[1]
        np_flat = next(p for p in FLAT_PROBES if recall(ivf_flat.search(
            ivf_flat.SearchParams(n_probes=p, engine="fused"), flat_index, queries, g.k)[1],
            truth) >= RECALL_GATE)
        rb_gate = next({"n_probes": p, "rerank_mult": m} for p in PROBE_LADDER
                       for m in (4, 8, 16, 25) if recall(ivf_rabitq.search(
                           ivf_rabitq.SearchParams(n_probes=p, rerank_mult=m,
                                                   scan_engine="fused"),
                           rb_index, queries, g.k)[1], truth) >= RECALL_GATE)
    return {"dataset": dataset, "queries": queries, "truth": truth, "index": index,
            "flat_index": flat_index, "rb_index": rb_index, "np_pq": np_pq,
            "np_flat": np_flat, "rb_gate": rb_gate, "ref_windows": ref}


def obs_inputs(res, pm, fl, rb):
    """Phase 4f's inputs from phases 4's results."""
    gate = pm["default"]["rungs"][-1]
    return {"dataset": res["dataset"], "queries": res["queries"], "truth": res["truth"],
            "index": res["index"], "flat_index": fl["index"], "rb_index": rb["index"],
            "np_pq": gate["n_probes"],
            "np_flat": next(x["n_probes"] for x in fl["rungs"]
                            if x["engine"] == "fused" and x["recall"] >= RECALL_GATE),
            "rb_gate": rb["gate"],
            "ref_windows": {"ivf_pq default": gate["window_qps"],
                            "ivf_pq fused": res["rungs"][0]["window_qps"]}}


def _hist_buckets(text):
    """{histogram family: [(le, count), ...]} from Prometheus text."""
    fams = {}
    for line in text.strip().splitlines():
        name, _, value = line.rpartition(" ")
        if '_bucket{le="' in name:
            fam, le = name.split('_bucket{le="')
            fams.setdefault(fam, []).append((le[:-2], float(value)))
    return fams


def obs_path(g, dev, inp, sync):
    """Phase 4f: the observability layer (raft_tpu_torch.obs) on the main
    path, reusing phase 4's 1M-row indexes and data (`obs_setup` makes
    them when the phase runs alone, `--obs`).
      1. the default IVF-PQ batch (its gate rung) and the fused bf16
         n_probes-8 batch, each + refine, in windows of g.batch_reps
         batches under the untuned table as phase 4 times them (one
         untimed window first), obs off and on (not fenced) in turns:
         off, on, on, off, g.windows rounds. An off window must record no
         metric and no event and leave the logger without the bus handler;
         the off windows' mean ms a batch must lie within the on windows'
         range widened on each side by that range or HOST_DRIFT of its
         mean, whichever is wider. Phase 4's windows are logged beside;
      2. under the committed table, each call fenced (synchronized before
         and after), first with obs disabled and then enabled: the default
         IVF-PQ search, the fused bf16, fused int8 and pallas bf16
         searches at n_probes 8, each refine, brute_force.knn(engine=
         "fused"), IVF-Flat's fused search and RaBitQ's at its gate rung.
         The answers must equal the disabled ones bit for bit; each
         call's spans, host ms, fenced ms, charged flops and bytes, FLOP/s,
         B/s and MFU against the "h100" row are logged, and an MFU above
         OBS_SHARE_CAP fails. The enabled drive is a path of its own:
         kernels 1, 2, 3, 4, 6 and 7 must launch;
      3. counters: an adaptive IVF-PQ rung's `ivf.scanned_lists` equals
         its plan's kept pairs; a delete of 1,000 ids and an insert of 500
         rows on the IVF-Flat index count 1,000 tombstones and 500
         upserts; a scrub slice over a list rotted on a clone counts one
         mismatch;
      4. exports: a saved snapshot rendered by `python -m
         raft_tpu_torch.obs.report` in a subprocess (exit 0), every
         histogram's Prometheus buckets monotone up to `_count`, and one
         fused batch plus an exact fused k-NN under `trace_session`, whose
         Chrome trace must name kernels 1 and 2;
      5. child processes: one with RAFT_TPU_OBS=1 and RAFT_TPU_FLIGHT_DIR
         SIGKILLed at an armed crash_point must leave a flight dump
         holding its events before the crash; one that indexes a CUDA
         tensor out of range must see errors that `is_device_fault`
         classifies as device faults, on that op and on a later one (the
         context is poisoned).
    Returns a summary dict; raises on any failed check."""
    from raft_tpu_torch import integrity, obs
    from raft_tpu_torch.neighbors import (brute_force, ivf_flat, ivf_pq, ivf_rabitq, mutation,
                                          probe_budget)
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops import _launch

    t_phase = time.perf_counter()
    dataset, queries, truth, index = inp["dataset"], inp["queries"], inp["truth"], inp["index"]
    flat_index, rb_index, k = inp["flat_index"], inp["rb_index"], g.k
    out = {"windows": {}, "calls": [], "counters": {}, "exports": {}, "children": {}}
    obs.disable()
    obs.reset()

    def pq_run(params):
        return lambda: refine(dataset, queries, ivf_pq.search(params, index, queries,
                                                              4 * k)[1],
                              k, strategy="fused", device=dev)

    fused8 = ivf_pq.SearchParams(n_probes=8, score_mode="recon8_list", trim_engine="fused")
    default = ivf_pq.SearchParams(n_probes=inp["np_pq"])

    # 1. obs off against obs on, in turns (off, on, on, off; g.windows
    # rounds of one-window turns) after one untimed window; off must
    # record nothing and leave the logger as it found it
    log_handlers = importlib.import_module("raft_tpu_torch.core.logger").logger.handlers
    handlers0 = list(log_handlers)
    one = argparse.Namespace(**{**vars(g), "windows": 1})
    with table({}):
        for label, run in (("ivf_pq default", pq_run(default)), ("ivf_pq fused", pq_run(fused8))):
            timed_windows(one, run, sync)
            turns = {False: [], True: []}
            residue = []
            for _ in range(g.windows):
                for on in (False, True, True, False):
                    if not on:
                        snap = json.dumps(obs.registry().snapshot())
                        turns[on] += timed_windows(one, run, sync)[1]
                        if (json.dumps(obs.registry().snapshot()) != snap
                                or obs.bus().events() or list(log_handlers) != handlers0):
                            residue.append(len(turns[on]))
                        continue
                    obs.enable()
                    try:
                        turns[on] += timed_windows(one, run, sync)[1]
                    finally:
                        obs.disable()
                        obs.reset()
            off_ms, on_ms = ([g.nq / q * 1e3 for q in turns[state]] for state in (False, True))
            p4_ms = [g.nq / q * 1e3 for q in inp["ref_windows"][label]]
            off, lo, hi = sum(off_ms) / len(off_ms), min(on_ms), max(on_ms)
            widen = max(hi - lo, HOST_DRIFT * sum(on_ms) / len(on_ms))
            ok = lo - widen <= off <= hi + widen
            out["windows"][label] = {"off_window_ms": off_ms, "on_window_ms": on_ms,
                                     "off_batch_ms": off, "on_batch_ms": sum(on_ms) / len(on_ms),
                                     "within": ok, "off_residue_windows": residue,
                                     "phase4_window_ms": p4_ms}
            log(f"obs off, {label} + refine, in turns with on: {off:.4f} ms a batch (windows "
                f"{', '.join(f'{m:.4f}' for m in off_ms)}) against on "
                f"{sum(on_ms) / len(on_ms):.4f} (windows {', '.join(f'{m:.4f}' for m in on_ms)}):"
                f" within [{lo - widen:.4f}, {hi + widen:.4f}] {ok}; off windows that recorded "
                f"or left something: {residue}; phase 4's windows "
                f"{', '.join(f'{m:.4f}' for m in p4_ms)}")
            if residue:
                raise AssertionError(f"obs off, {label}: windows {residue} recorded metrics or "
                                     "events, or the logger kept the bus handler")
            if not ok and dev.type == "cuda":
                raise AssertionError(f"obs off, {label}: {off:.4f} ms a batch outside "
                                     f"[{lo - widen:.4f}, {hi + widen:.4f}], in turns with on")

    # 2. fenced calls, disabled then enabled, under the committed table
    rb_gate = inp["rb_gate"]
    cand = {}

    def search(label, params):
        def run():
            cand[label] = ivf_pq.search(params, index, queries, 4 * k)[1]
            return cand[label]
        return run

    calls = []
    for label, params in (("default", default), ("fused bf16", fused8),
                          ("fused int8", ivf_pq.SearchParams(
                              n_probes=8, score_mode="recon8_list", trim_engine="fused",
                              score_dtype="int8")),
                          ("pallas bf16", ivf_pq.SearchParams(
                              n_probes=8, score_mode="recon8_list", trim_engine="pallas"))):
        calls.append((f"ivf_pq.search {label}", search(label, params)))
        calls.append((f"refine ({label} candidates)",
                       lambda label=label: refine(dataset, queries, cand[label], k,
                                                  strategy="fused", device=dev)))
    calls += [("brute_force.knn fused",
               lambda: brute_force.knn(dataset, queries, k, engine="fused", device=dev)),
              (f"ivf_flat.search fused n_probes {inp['np_flat']}",
               lambda: ivf_flat.search(ivf_flat.SearchParams(n_probes=inp["np_flat"],
                                                             engine="fused"),
                                       flat_index, queries, k)),
              (f"ivf_rabitq.search fused n_probes {rb_gate['n_probes']} rerank_mult "
               f"{rb_gate['rerank_mult']}",
               lambda: ivf_rabitq.search(ivf_rabitq.SearchParams(
                   n_probes=rb_gate["n_probes"], rerank_mult=rb_gate["rerank_mult"],
                   scan_engine="fused"), rb_index, queries, k))]
    info = obs.perf.platform_info()
    with committed(dev):
        off = {}
        for label, fn in calls:
            sync()
            off[label] = fn()
            sync()
        obs.reset()
        obs.enable()
        _launch.reset_launch_counts()
        try:
            for label, fn in calls:
                with obs.capture_spans() as cap:
                    sync()
                    t0 = time.perf_counter()
                    got = fn()
                    sync()
                    secs = time.perf_counter() - t0
                same = all(torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    off[label] if isinstance(off[label], tuple) else (off[label],)))
                cost, spans = cap.cost_totals(), cap.totals()
                mfu = obs.perf.mfu(cost["by_dtype"], secs, info) if cost["flops"] else None
                row = {"call": label, "fenced_ms": secs * 1e3, "equal_to_disabled": same,
                       "spans": {n: {"calls": s["calls"], "host_ms": s["total_ms"]}
                                 for n, s in spans.items()},
                       "cost_flops": cost["flops"], "flops_by_dtype": cost["by_dtype"],
                       "cost_bytes": cost["bytes"], "flop_per_s": cost["flops"] / secs,
                       "bytes_per_s": cost["bytes"] / secs, "mfu": mfu}
                out["calls"].append(row)
                log(f"obs span {label}: fenced {secs * 1e3:.4f} ms, spans "
                    f"{json.dumps(row['spans'])}, cost_flops {cost['flops']} "
                    f"{json.dumps(cost['by_dtype'])}, cost_bytes {cost['bytes']}, "
                    f"{row['flop_per_s'] / 1e12:.4f} TFLOP/s, {row['bytes_per_s'] / 1e9:.4f} "
                    f"GB/s modeled, MFU {mfu if mfu is None else f'{mfu:.6f}'} "
                    f"({info['platform']} peaks, {info['device_kind']}); answers equal to obs "
                    f"disabled bit for bit {same}")
                if not same:
                    raise AssertionError(f"obs enabled changed the answer of {label}")
                if mfu is not None and mfu > OBS_SHARE_CAP:
                    raise AssertionError(f"{label}: MFU {mfu} > {OBS_SHARE_CAP}: a formula or a "
                                         "peak is wrong")
        finally:
            counts = _launch.launch_counts()
    out["launches"] = counts
    log(f"path obs enabled: launches {counts}")
    missing = [n for n in OBS_KERNELS if counts[n] <= 0]
    if missing and dev.type == "cuda":
        raise AssertionError(f"path obs: kernels never launched: {missing}")
    if dev.type == "cuda" and info["platform"] != "h100":
        raise AssertionError(f"obs platform_info on the card: {info}")

    # 3. counters
    obs.reset()
    ap_params = ivf_pq.SearchParams(n_probes=20, score_mode="recon8_list", trim_engine="fused",
                                    budget_tau=0.3)
    with table({}):
        ivf_pq.search(ap_params, index, queries, 4 * k)
        plan = probe_budget.search_plan(
            probe_budget.resolve_params(ap_params, 20, dev), queries, index.centers,
            n_probes=20, k=4 * k, metric=index.metric, rotation=index.rotation,
            radii=index.list_radii if index.tombstones is None else None,
            sizes=index.list_sizes)
    kept = int(plan[0].sum())
    scanned = obs.registry().snapshot()["counters"]["ivf.scanned_lists"]
    out["counters"]["adaptive"] = {"scanned_lists": scanned, "kept_pairs": kept,
                                   "worst_case": g.nq * 20}
    log(f"obs counters, adaptive ivf_pq fused n_probes 20 budget_tau 0.3: ivf.scanned_lists "
        f"{scanned}, the plan's kept pairs {kept} (of {g.nq * 20})")
    if scanned != kept:
        raise AssertionError(f"ivf.scanned_lists {scanned} != the plan's kept pairs {kept}")
    rng = np.random.default_rng(g.seed + 17)
    victims = torch.as_tensor(rng.choice(g.n, 1000, replace=False).astype(np.int32), device=dev)
    t0 = time.perf_counter()
    live = mutation.delete(flat_index, victims)
    live = mutation.upsert(live, dataset[:500] + 0.25)
    sync()
    mut_s = time.perf_counter() - t0
    ctr = obs.registry().snapshot()["counters"]
    out["counters"]["mutation"] = {"tombstones": ctr["mutation.tombstones"],
                                   "upserts": ctr["mutation.upserts"], "seconds": mut_s}
    log(f"obs counters, IVF-Flat delete 1000 + insert 500 ({mut_s:.3f} s): mutation.tombstones "
        f"{ctr['mutation.tombstones']}, mutation.upserts {ctr['mutation.upserts']}")
    if ctr["mutation.tombstones"] != 1000 or ctr["mutation.upserts"] != 500:
        raise AssertionError(f"mutation counters {ctr}")
    del live
    rot = mutation._clone(flat_index)
    integrity.rot_list(rot, 3, "list_data", frac=0.2, seed=g.seed)
    bad = integrity.Scrubber(budget_lists=8).slice_scan(rot)
    ctr = obs.registry().snapshot()["counters"]
    out["counters"]["scrub"] = {"found": bad, "mismatches": ctr["integrity.mismatches"],
                                "rot_injected": ctr["integrity.rot_injected"]}
    log(f"obs counters, scrub slice over lists 0-7 with list 3 rotted: found {bad}, "
        f"integrity.mismatches {ctr['integrity.mismatches']}, integrity.rot_injected "
        f"{ctr['integrity.rot_injected']}")
    if bad != [("list_data", 3)] or ctr["integrity.mismatches"] != 1:
        raise AssertionError(f"scrub of one rotted list: {bad}, counters {ctr}")
    del rot

    # 4. exports
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory(prefix="obs_") as tmp:
        snap_path = os.path.join(tmp, "snap.json")
        obs.save_snapshot(snap_path, label="chip_smoke obs_path")
        r = subprocess.run([sys.executable, "-m", "raft_tpu_torch.obs.report", snap_path],
                           capture_output=True, text=True, env=env, timeout=300, cwd=root)
        out["exports"]["report_rc"] = r.returncode
        log(f"obs report subprocess: exit {r.returncode}, {len(r.stdout.splitlines())} lines; "
            f"head: {' | '.join(r.stdout.splitlines()[:3])}")
        if r.returncode != 0:
            raise AssertionError(f"python -m raft_tpu_torch.obs.report failed: {r.stderr[-2000:]}")
        fams = _hist_buckets(obs.render_registry_prometheus())
        counts_ok = all(all(a[1] <= b[1] for a, b in zip(v, v[1:])) and v[-1][0] == "+Inf"
                        for v in fams.values())
        out["exports"]["prometheus_histograms"] = len(fams)
        log(f"obs prometheus: {len(fams)} histogram families, buckets monotone {counts_ok}")
        if not fams or not counts_ok:
            raise AssertionError("prometheus histogram buckets are not monotone")
        t0 = time.perf_counter()
        with committed(dev), obs.trace_session(os.path.join(tmp, "trace")) as d:
            pq_run(fused8)()
            brute_force.knn(dataset, queries[:256], k, engine="fused", device=dev)
            sync()
        trace_s = time.perf_counter() - t0
        files = os.listdir(d)
        with open(os.path.join(d, files[0])) as f:
            names = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
        named = {kern: sorted({n for n in names if any(sym in n for sym in syms)})[:2]
                 for kern, syms in TRACE_SYMBOLS.items()}
        out["exports"]["trace"] = {"seconds": trace_s, "kernels": named, "events": len(names)}
        log(f"obs trace_session: one fused batch + an exact fused k-NN of 256 queries in "
            f"{trace_s:.3f} s, {len(names)} event names; kernel 1 as {named['fused_list_topk']}, "
            f"kernel 2 as {named['fused_topk']}")
        if dev.type == "cuda" and not all(named.values()):
            raise AssertionError(f"the Chrome trace does not name kernels 1 and 2: {named}")

        # 5. child processes
        fdir = os.path.join(tmp, "flight")
        os.makedirs(fdir)
        r = subprocess.run([sys.executable, "-c", _FLIGHT_CHILD.format(root=root)],
                           capture_output=True, text=True, timeout=300, cwd=root,
                           env=dict(env, RAFT_TPU_OBS="1", RAFT_TPU_FLIGHT_DIR=fdir))
        dumps = [p for p in os.listdir(fdir) if p.startswith("flight-")]
        events = []
        if dumps:
            with open(os.path.join(fdir, dumps[0])) as f:
                events = [(e["kind"], e.get("step", e.get("action"))) for e in json.load(f)["events"]]
        out["children"]["flight"] = {"rc": r.returncode, "dumps": len(dumps), "events": events}
        log(f"obs flight child: exit {r.returncode}, dumps {len(dumps)}, events {events}")
        if (r.returncode != -signal.SIGKILL or len(dumps) != 1
                or events[:3] != [("drill", 0), ("drill", 1), ("drill", 2)]):
            raise AssertionError(f"flight drill: rc {r.returncode}, dumps {dumps}, events "
                                 f"{events}; {r.stderr[-1000:]}")
    if dev.type == "cuda":
        r = subprocess.run([sys.executable, "-c", _FAULT_CHILD.format(root=root)],
                           capture_output=True, text=True, timeout=300, cwd=root, env=env)
        rep = json.loads(r.stdout.strip().splitlines()[-1]) if r.stdout.strip() else {}
        out["children"]["device_fault"] = dict(rep, rc=r.returncode)
        log(f"obs device-fault child: exit {r.returncode}, {json.dumps(rep)}")
        if not (rep.get("first_fault") and rep.get("later_fault")):
            raise AssertionError(f"device-fault child: {rep}; {r.stderr[-1000:]}")
    obs.disable()
    obs.reset()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"obs path complete in {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phase 4g: the comms layer (distributed brute-force k-NN and k-means)
# ---------------------------------------------------------------------------

#: bench/bench_mnmg.py:35's configuration: its 10M x 96 rows from 1,024
#: blob centres U(-5, 5) plus unit noise cut to 5M (a cut of depth that
#: keeps the whole run inside its time limit beside phases 4i and 4j),
#: 4,096 queries at k 10, k-means at 1,024 clusters for 10 iterations; the
#: NCCL child's 1M rows; the gloo children's small CPU world;
#: bench/bench_comms.py's (rows, 256) f32 block
COMMS = dict(n=5_000_000, dim=96, nq=4096, k=10, blobs=1024, clusters=1024, max_iter=10,
             f64_queries=16, child_n=1_000_000, gloo_n=20_000, gloo_nq=256, coll_rows=64,
             coll_d=256, child_timeout_s=300.0)
COMMS_REHEARSE = dict(COMMS, n=20_000, dim=32, nq=256, blobs=64, clusters=64, max_iter=3,
                      child_n=20_000, gloo_n=4_000, gloo_nq=64)
#: the quantized merges' recall against the exact one (tests/test_qcomms.py)
QUANT_RECALL = 1.0 - 1e-3


def comms_blobs(seed, n, dim, nq, n_blobs, dev):
    """Clustered f32 rows made on `dev` from `seed` (the comms phase's 3.84
    GB dataset is made on the card: centres U(-5, 5), unit noise, queries
    from the same centres)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    centers = torch.rand((n_blobs, dim), generator=gen, device=dev) * 10.0 - 5.0
    x = torch.empty((n, dim), device=dev)
    step = 1 << 20
    for s in range(0, n, step):
        m = min(step, n - s)
        lab = torch.randint(0, n_blobs, (m,), generator=gen, device=dev)
        x[s:s + m] = centers[lab] + torch.randn((m, dim), generator=gen, device=dev)
    lab = torch.randint(0, n_blobs, (nq,), generator=gen, device=dev)
    q = centers[lab] + torch.randn((nq, dim), generator=gen, device=dev)
    return x, q


def f64_knn(x, q, k, step=1 << 20):
    """float64 (values, ids) of `q`'s k nearest rows of `x` (sqeuclidean),
    the rows in chunks."""
    qd = q.double()
    best_v = torch.full((q.shape[0], k), float("inf"), dtype=torch.float64, device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)
    for s in range(0, x.shape[0], step):
        d = torch.cdist(qd, x[s:s + step].double()) ** 2
        v, i = torch.topk(torch.cat([best_v, d], 1), k, dim=1, largest=False)
        best_i = torch.gather(torch.cat([best_i, torch.arange(s, s + d.shape[1], device=q.device)
                                         .expand(q.shape[0], -1)], 1), 1, i)
        best_v = v
    return best_v, best_i


class SelectCalls(Spy):
    """Keeps the first call of a (B, L) shape and the last call overall:
    the k-NN's tile select and, last in a replicated call, a rank's merge
    select."""

    def __init__(self, module, name):
        super().__init__(module, name)
        self.first = {}
        self.last = None

    def __call__(self, *args, **kwargs):
        key = tuple(args[0].shape)
        if key not in self.first:
            self.first[key] = args
        self.last = args
        return self.orig(*args, **kwargs)


def comms_collectives(g, dev, C, sync):
    """Every AxisComms collective on 4 ranks of `dev` at bench_comms.py's
    (rows, 256) f32 block, each against its reference composed on the one
    (4, rows, 256) stack (rank-order sums, so SUM is bit for bit; the PROD
    planes composed the same way), the int8 allreduce within its codec
    bound; the body's wall time; the health barrier's latency."""
    from raft_tpu_torch.comms import Comms, op_t, resilience
    from raft_tpu_torch.comms.comms import AxisComms, P

    w, rows, d = 4, C["coll_rows"], C["coll_d"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(g.seed + 41)
    x = torch.randn((w, rows, d), generator=gen, device=dev)
    xi = torch.randint(1, 4, (w, rows, 16), generator=gen, device=dev, dtype=torch.int32)
    comms = Comms(n_devices=w, device=dev)
    counts = [rows - 3 * r for r in range(w)]

    def body(ac, x, xi):
        f, i = x[0], xi[0]
        grp = ac.comm_split([0, 0, 1, 1])
        return tuple(o[None] for o in (
            ac.allreduce(f), ac.allreduce(f, op_t.MIN), ac.allreduce(f, op_t.MAX),
            ac.allreduce(f, op_t.PROD), ac.allreduce(i, op_t.PROD), ac.bcast(f, root=1),
            ac.reduce(f, root=2), ac.allgather(f), ac.allgatherv(f, counts),
            ac.gather(f, root=3), ac.reducescatter(f), ac.reducescatter(f, op_t.MIN),
            ac.reducescatter(f, op_t.MAX), ac.shift(f, 1),
            ac.device_sendrecv(f, [(0, 2), (2, 0), (1, 3), (3, 1)]),
            ac.device_multicast_sendrecv(f, [[1, 2], [2], [3, 0], [0]]), ac.barrier(),
            grp.allreduce(f), grp.allgather(f), ac.allreduce(f, quantization="int8")))

    def run():
        return comms.run(body, comms.shard(x), comms.shard(xi), in_specs=(P("data"), P("data")),
                         out_specs=(P("data"),) * 20)

    out = run()
    sync()
    t0 = time.perf_counter()
    for _ in range(g.reps):
        out = run()
    sync()
    body_ms = (time.perf_counter() - t0) / g.reps * 1e3
    acc = x[0]
    for r in range(1, w):
        acc = acc + x[r]
    zero = torch.zeros_like(x[0])
    planes = AxisComms._prod_split(x[0])
    for r in range(1, w):
        planes = planes + AxisComms._prod_split(x[r])
    gather_all = x.clone()
    for r in range(w):
        gather_all[r, counts[r]:] = 0
    ref = {
        "allreduce sum": [acc] * w, "allreduce min": [x.amin(0)] * w,
        "allreduce max": [x.amax(0)] * w,
        "allreduce prod (log planes)": [AxisComms._prod_recombine(planes, x.dtype)] * w,
        "allreduce prod (int, exact)": [torch.prod(xi, 0).to(torch.int32)] * w,
        "bcast": [x[1]] * w, "reduce": [acc if r == 2 else zero for r in range(w)],
        "allgather": [x] * w, "allgatherv": [gather_all] * w,
        "gather": [x if r == 3 else torch.zeros_like(x) for r in range(w)],
        "reducescatter sum": [acc.chunk(w)[r] for r in range(w)],
        "reducescatter min": [x.amin(0).chunk(w)[r] for r in range(w)],
        "reducescatter max": [x.amax(0).chunk(w)[r] for r in range(w)],
        "shift": [x[(r - 1) % w] for r in range(w)],
        "device_sendrecv": [x[r ^ 2] if r in (0, 2) else x[4 - r] for r in range(w)],
        # out = (0 + the slot-0 arrival) + the slot-1 arrival (0 where none)
        "multicast": [(zero + x[3]) + x[2], (zero + x[0]) + zero, (zero + x[1]) + x[0],
                      (zero + x[2]) + zero],
        "barrier": [torch.tensor(float(w), device=dev)] * w,
        "comm_split allreduce": [x[0] + x[1]] * 2 + [x[2] + x[3]] * 2,
        "comm_split allgather": [x[:2]] * 2 + [x[2:]] * 2,
    }
    results = {}
    for (name, want), got in zip(ref.items(), out):
        want = torch.stack(want)
        if not (got.dtype == want.dtype and torch.equal(got, want)):
            raise AssertionError(f"collective {name}: differs from its reference")
        results[name] = "equal"
    q8 = out[-1]
    # one encode error (absmax / 254 of a partial sum of up to w values) at
    # each of the w - 1 reduce hops and the final encode
    bound = w * w * float(x.abs().max()) / 254.0
    q8_err = float((q8 - acc[None]).abs().max())
    if q8_err > bound or not all(torch.equal(q8[r], q8[0]) for r in range(w)):
        raise AssertionError(f"int8 allreduce: error {q8_err} past {bound}, or ranks differ")
    results["allreduce int8"] = {"max_abs_err": q8_err, "bound": bound}
    barrier = [resilience.health_barrier(comms, timeout_s=30) for _ in range(5)]
    comms.destroy()
    log(f"comms collectives: every collective on 4 ranks at ({rows}, {d}) f32 equal to its "
        f"reference; the 20-collective body {body_ms:.3f} ms; int8 allreduce error {q8_err:.4g} "
        f"(bound {bound:.4g}); health_barrier latency "
        + ", ".join(f"{1e3 * s:.3f}" for s in barrier) + " ms")
    return {"collectives": results, "body_ms": body_ms, "barrier_ms": [1e3 * s for s in barrier]}


def comms_children(g, dev, C):
    """Start the process worlds (NCCL at world 1 on the card, gloo at
    world 2 on the CPU) as children of this script; `comms_join` waits."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    kids = {}
    script = os.path.abspath(__file__)

    def port():
        import socket

        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    if dev.type == "cuda":
        kids["nccl"] = subprocess.Popen(
            [sys.executable, script, "--comms-child", "nccl", "--seed", str(g.seed),
             "--child-port", str(port()), "--child-rank", "0"]
            + (["--rehearse"] if g.rehearse else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root, env=env)
    p = port()
    for r in range(2):
        kids[f"gloo{r}"] = subprocess.Popen(
            [sys.executable, script, "--comms-child", "gloo", "--seed", str(g.seed),
             "--child-port", str(p), "--child-rank", str(r)]
            + (["--rehearse"] if g.rehearse else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root, env=env)
    return kids, time.monotonic() + C["child_timeout_s"]


def comms_join(kids, deadline):
    """Wait for every child until the deadline, kill the rest; any child
    that fails, times out or reports no result fails the phase."""
    out, failed = {}, []
    try:
        for name, p in kids.items():
            try:
                so, se = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                so, se = p.communicate()
                failed.append(f"{name}: past its deadline")
                continue
            lines = [ln for ln in so.splitlines() if ln.startswith("comms_child ")]
            rep = json.loads(lines[-1][len("comms_child "):]) if lines else None
            out[name] = dict(rep or {}, rc=p.returncode)
            log(f"comms child {name}: exit {p.returncode}, {json.dumps(rep)}")
            if p.returncode != 0 or not rep or not rep.get("ok"):
                failed.append(f"{name}: exit {p.returncode}; {se[-2000:]}")
    finally:
        for p in kids.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError("comms children failed: " + " | ".join(failed))
    return out


def comms_child(g):
    """A process-world child (`--comms-child nccl|gloo`): bootstraps
    torch.distributed through `comms.bootstrap_multihost`, runs the
    distributed k-NN (and on gloo k-means) and holds it against the
    in-process world of as many ranks, bit for bit. Prints one
    `comms_child {...}` line; exits 0 only when every check held."""
    from raft_tpu_torch.comms import Comms, bootstrap_multihost, mnmg
    from raft_tpu_torch.ops import _launch

    C = COMMS_REHEARSE if g.rehearse else COMMS
    rep = {"ok": False, "kind": g.comms_child, "rank": g.child_rank}
    if g.comms_child == "nccl":
        dev = torch.device("cuda", 0)
        bootstrap_multihost(f"localhost:{g.child_port}", num_processes=1, process_id=0,
                            device=dev, timeout_s=120.0)
        comms = Comms()
        x, q = comms_blobs(g.seed, C["child_n"], C["dim"], C["nq"], C["blobs"], dev)
        with committed(dev):
            mnmg.knn(comms, x, q, C["k"])  # the first call
            torch.cuda.synchronize()
            _launch.reset_launch_counts()
            t0 = time.perf_counter()
            pv, pi = mnmg.knn(comms, x, q, C["k"])
            torch.cuda.synchronize()
            rep["process_s"] = time.perf_counter() - t0
            rep["launches"] = _launch.launch_counts()["counting_select_min"]
            local = Comms(n_devices=1, device=dev)
            t0 = time.perf_counter()
            lv, li = mnmg.knn(local, x, q, C["k"])
            torch.cuda.synchronize()
            rep["in_process_s"] = time.perf_counter() - t0
            # the distributed IVF-PQ lifecycle's first steps at world 1:
            # ivf_pq_build_local and a refined search, in the process world
            # and in the in-process world
            rep.update(mnmg_ivf_child(comms, local, x, q, C["k"], torch.cuda.synchronize,
                                      MNMG_IVF_REHEARSE if g.rehearse else MNMG_IVF, g.seed))
        rep.update(world=comms.get_size(), backend="nccl", rows=C["child_n"],
                   process_world=comms.process_world,
                   equal=bool(torch.equal(pv, lv) and torch.equal(pi, li)))
        rep["ok"] = (rep["equal"] and rep["process_world"] and rep["launches"] > 0
                     and rep["ivf_equal"])
    else:
        world, rank = 2, g.child_rank
        bootstrap_multihost(f"localhost:{g.child_port}", num_processes=world, process_id=rank,
                            device="cpu", timeout_s=120.0)
        comms = Comms()
        x, q = comms_blobs(g.seed, C["gloo_n"], C["dim"], C["gloo_nq"], C["blobs"], "cpu")
        per = -(-x.shape[0] // world)
        part = x[rank * per:(rank + 1) * per]
        t0 = time.perf_counter()
        pv, pi = mnmg.knn_local(comms, part, q, C["k"])
        pc, pin, pit = mnmg.kmeans_fit_local(comms, part, 16, max_iter=5, seed=g.seed)
        rep["process_s"] = time.perf_counter() - t0
        local = Comms(n_devices=world, device="cpu")
        lv, li = mnmg.knn(local, x, q, C["k"])
        lc, lin, lit = mnmg.kmeans_fit(local, x, 16, max_iter=5, seed=g.seed)
        rep.update(world=world, backend="gloo", rows=C["gloo_n"],
                   knn_equal=bool(torch.equal(pv, lv) and torch.equal(pi, li)),
                   kmeans_equal=bool(torch.equal(pc, lc) and pin == lin and pit == lit))
        rep.update(mnmg_ivf_gloo(g, comms, local, part, q, C["k"]))
        rep["ok"] = (rep["knn_equal"] and rep["kmeans_equal"] and rep["ivf_equal"]
                     and comms.spans_processes())
        import torch.distributed as dist

        dist.barrier()
    import torch.distributed as dist

    dist.destroy_process_group()
    print("comms_child " + json.dumps(rep), flush=True)
    return 0 if rep["ok"] else 9


def comms_knn_part(g, dev, C, x, q, sync):
    """The distributed k-NN at worlds 1 and 4 on `dev`: seconds a call,
    QPS and kernel 6's launches a world (counts set to 0 just before each
    world's timed calls and read just after); then the world-4 variants
    and their gates. Returns (summary, the select spy, world 4's (values,
    ids): the exact truth phase 4h reads)."""
    from raft_tpu_torch.comms import Comms, RankHealth, mnmg
    from raft_tpu_torch.comms import mnmg_merge
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import _launch
    from raft_tpu_torch.ops import select_counting as sc

    k, nq, n = C["k"], C["nq"], C["n"]
    out = {"worlds": {}}
    knn = {}
    for w in (1, 4):
        comms = Comms(n_devices=w, device=dev)
        mnmg.knn(comms, x, q, k, query_mode="replicated")  # the first call
        sync()
        _launch.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(g.reps):
            v, i = mnmg.knn(comms, x, q, k, query_mode="replicated")
        sync()
        sec = (time.perf_counter() - t0) / g.reps
        counts = _launch.launch_counts()
        launches = counts["counting_select_min"] // g.reps
        out["worlds"][w] = {"s_per_call": sec, "qps": nq / sec,
                            "counting_launches_per_call": launches, "launches": counts}
        log(f"path comms knn world {w}: {sec:.4f} s a call, {nq / sec:.1f} QPS, kernel 6 "
            f"launches a call {launches}, launches {counts}")
        if dev.type == "cuda" and launches <= 0:
            raise AssertionError(f"comms knn world {w}: kernel 6 never launched")
        if dev.type == "cuda":
            out["worlds"][w]["breakdown"] = device_breakdown(
                lambda: mnmg.knn(comms, x, q, k, query_mode="replicated"), 1, sec * 1e3,
                label=f"comms knn world {w}", top=6)
        knn[w] = (v, i, comms)
    v4, i4, comms = knn[4]
    if not tie_equal(knn[1][0], knn[1][1], v4, i4):
        raise AssertionError("comms knn: world 4 differs from world 1 away from ties")
    t0 = time.perf_counter()
    sv, si = brute_force.knn(x, q, k, engine="tiled", device=dev)
    sync()
    out["single_device_s"] = time.perf_counter() - t0
    err, agree = compare("comms knn off vs brute_force tiled", (v4, i4), (sv, si), k)
    out["off_vs_single"] = {"max_abs_err": err, "id_agreement": agree}
    nf = C["f64_queries"]
    fv, fi = f64_knn(x, q[:nf], k)
    err64, agree64 = compare("comms knn vs float64", (v4[:nf], i4[:nf]), (fv.float(), fi), k)
    out["f64"] = {"queries": nf, "max_abs_err": err64, "id_agreement": agree64}
    log(f"comms knn: world 4 equals world 1 (ties aside); against brute_force tiled "
        f"max_abs_err {err:.4g}, id agreement {agree:.6f}; {nf} queries against float64 "
        f"max_abs_err {err64:.4g}, id agreement {agree64:.6f}")
    spy = SelectCalls(sc, "counting_select_min")
    with spy:
        _launch.reset_launch_counts()
        mnmg.knn(comms, x, q, k, query_mode="replicated")
        sync()
    out["launches_one_call"] = _launch.launch_counts()["counting_select_min"]

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, time.perf_counter() - t0

    variants = {}
    for mode in ("sharded", "auto"):
        (mv, mi), s = timed(lambda: mnmg.knn(comms, x, q, k, query_mode=mode))
        if not tie_equal(mv, mi, v4, i4):
            raise AssertionError(f"comms knn query_mode={mode}: differs from replicated")
        variants[f"query_mode {mode}"] = {"s": s, "equal_to_replicated": True}
    with contextlib.ExitStack() as stack:
        orig = mnmg_merge._replicated_merge_schedule
        mnmg_merge._replicated_merge_schedule = lambda device=None: "tournament"
        stack.callback(setattr, mnmg_merge, "_replicated_merge_schedule", orig)
        (tv, ti), s = timed(lambda: mnmg.knn(comms, x, q, k, query_mode="replicated"))
    if not tie_equal(tv, ti, v4, i4):
        raise AssertionError("comms knn tournament merge: differs from the allgather merge")
    variants["tournament"] = {"s": s, "equal_to_allgather": True}
    (ov, oi), s = timed(lambda: mnmg.knn(comms, x, q, k, quantization="off",
                                         query_mode="replicated"))
    if not (torch.equal(ov, v4) and torch.equal(oi, i4)):
        raise AssertionError("comms knn quantization off: not the exact merge bit for bit")
    variants["quantization off"] = {"s": s, "bit_equal": True}
    for mode in ("int8", "bf16"):
        (qv, qi), s = timed(lambda: mnmg.knn(comms, x, q, k, quantization=mode,
                                             query_mode="replicated"))
        rec = recall(qi, oi)
        if rec < QUANT_RECALL:
            raise AssertionError(f"comms knn quantization {mode}: recall {rec} < {QUANT_RECALL}")
        variants[f"quantization {mode}"] = {"s": s, "recall_vs_off": rec}
    keep = np.random.default_rng(g.seed + 43).random(n) < 0.5
    (pv, pi), s = timed(lambda: mnmg.knn(comms, x, q, k, prefilter=keep,
                                         query_mode="replicated"))
    ref_pv, ref_pi = brute_force.knn(x, q, k, engine="tiled", prefilter=keep, device=dev)
    if not bool(torch.as_tensor(keep, device=dev)[pi.long()].all()):
        raise AssertionError("comms knn prefilter: an id outside the filter")
    perr, pagree = compare("comms knn prefilter vs brute_force tiled", (pv, pi),
                           (ref_pv, ref_pi), k)
    variants["prefilter 50%"] = {"s": s, "max_abs_err": perr, "id_agreement": pagree}
    (bv, bi), s = timed(lambda: mnmg.knn(comms, x, q, k, compute_dtype=torch.bfloat16,
                                         query_mode="replicated"))
    ref_bv, ref_bi = brute_force.knn(x, q, k, engine="tiled", compute_dtype=torch.bfloat16,
                                     device=dev)
    berr, bagree = compare("comms knn bf16 vs brute_force tiled bf16", (bv, bi),
                           (ref_bv, ref_bi), k)
    variants["compute_dtype bf16"] = {"s": s, "max_abs_err": berr, "id_agreement": bagree,
                                      "recall_vs_f32": recall(bi, si)}
    per = -(-n // 4)
    health = RankHealth.all_healthy(4).mark_unhealthy(2)
    res, s = timed(lambda: mnmg.knn(comms, x, q, k, health=health, query_mode="replicated"))
    alive = np.ones(n, bool)
    alive[2 * per:3 * per] = False
    sv_, si_ = mnmg.knn(comms, x, q, k, prefilter=alive, query_mode="replicated")
    if res.coverage != 0.75 or not tie_equal(res.values, res.ids, sv_, si_):
        raise AssertionError(f"comms knn degraded: coverage {res.coverage}, or not the "
                             "survivors' merge")
    variants["degraded rank 2"] = {"s": s, "coverage": res.coverage,
                                   "equal_to_survivors": True, "recall": recall(res.ids, i4)}
    health = RankHealth.all_healthy(4).mark_unhealthy(1)
    res, s = timed(lambda: mnmg.knn(comms, x, q, k, health=health, replication=2,
                                    query_mode="replicated"))
    if not (torch.equal(res.values, v4) and torch.equal(res.ids, i4)
            and res.repaired_ranks == (1,) and res.coverage == 1.0):
        raise AssertionError(f"comms knn replication 2: coverage {res.coverage}, repaired "
                             f"{res.repaired_ranks}, or not the healthy answer bit for bit")
    variants["replication 2, rank 1 down"] = {"s": s, "coverage": 1.0, "repaired_ranks": [1],
                                              "bit_equal_to_healthy": True}
    for name, rec in variants.items():
        log(f"comms knn world 4 {name}: " + json.dumps(rec))
    out["variants"] = variants
    for w in (1, 4):
        knn[w][2].destroy()
    return out, spy, (v4, i4)


def comms_kmeans_part(g, dev, C, x, sync):
    """`mnmg.kmeans_fit` at worlds 1 and 4 from the same init (the same
    seed), its EM timed apart (seconds an iteration); gates: centres
    within 1e-4 of their scale, inertia within 1e-5 relative, n_iter
    equal; `kmeans_predict` labels of world 1's centres equal across the
    worlds outside near-ties (their count printed)."""
    from raft_tpu_torch.comms import Comms, mnmg
    from raft_tpu_torch.comms import mnmg_kmeans

    out = {}
    fits = {}
    em = {}
    orig = mnmg_kmeans._kmeans_fit_sharded

    def timed_em(*a, **kw):
        sync()
        t0 = time.perf_counter()
        r = orig(*a, **kw)
        sync()
        em["s"] = time.perf_counter() - t0
        return r

    for w in (1, 4):
        comms = Comms(n_devices=w, device=dev)
        mnmg_kmeans._kmeans_fit_sharded = timed_em
        try:
            sync()
            t0 = time.perf_counter()
            c, inertia, n_iter = mnmg.kmeans_fit(comms, x, C["clusters"], max_iter=C["max_iter"],
                                                 tol=0.0, seed=g.seed)
            sync()
            total = time.perf_counter() - t0
        finally:
            mnmg_kmeans._kmeans_fit_sharded = orig
        fits[w] = (c, inertia, n_iter, comms)
        out[w] = {"fit_s": total, "em_s": em["s"], "s_per_iteration": em["s"] / n_iter,
                  "n_iter": n_iter, "inertia": inertia}
        if dev.type == "cuda":
            xs, n, per = mnmg._shard_rows(comms, x)
            wts = comms.shard(np.where(np.arange(per * w) < n, 1.0, 0.0).astype(np.float32))
            out[w]["breakdown"] = device_breakdown(
                lambda: orig(comms, xs, wts, centers=c, max_iter=1, tol=0.0), 1,
                em["s"] / n_iter * 1e3, label=f"comms kmeans world {w}, one iteration", top=6)
            del xs, wts
        log(f"path comms kmeans world {w}: fit {total:.3f} s, EM {em['s']:.3f} s, "
            f"{em['s'] / n_iter:.4f} s an iteration, n_iter {n_iter}, inertia {inertia}")
    (c1, in1, it1, comms1), (c4, in4, it4, comms4) = fits[1], fits[4]
    cerr = float((c1 - c4).abs().max() / c1.abs().max())
    ierr = abs(in1 - in4) / in1
    out["centres_rel_err"], out["inertia_rel_err"] = cerr, ierr
    if it1 != it4 or cerr > 1e-4 or ierr > 1e-5:
        raise AssertionError(f"comms kmeans: worlds 1 and 4 differ: n_iter {it1} / {it4}, "
                             f"centres {cerr}, inertia {ierr}")
    t0 = time.perf_counter()
    l1 = mnmg.kmeans_predict(comms1, x, c1)
    l4 = mnmg.kmeans_predict(comms4, x, c1)
    sync()
    out["predict_s_both"] = time.perf_counter() - t0
    diff = (l1 != l4).nonzero().flatten()
    if diff.numel():
        xd = x[diff].double()
        d1 = ((xd - c1[l1[diff].long()].double()) ** 2).sum(1)
        d4 = ((xd - c1[l4[diff].long()].double()) ** 2).sum(1)
        scale = (xd ** 2).sum(1) + (c1.double() ** 2).sum(1).max()
        if bool(((d1 - d4).abs() > VAL_RTOL * scale).any()):
            raise AssertionError("comms kmeans_predict: labels differ away from near-ties")
    out["predict_label_diffs"] = int(diff.numel())
    log(f"comms kmeans: worlds 1 and 4 agree: centres {cerr:.3g} of their scale, inertia "
        f"{ierr:.3g} relative, n_iter {it1}; predict labels differing at near-ties: "
        f"{int(diff.numel())}")
    comms1.destroy()
    comms4.destroy()
    return out


def comms_path(g, dev, sync):
    """Phase 4g: the comms layer (raft_tpu_torch.comms) under the committed
    tuned table, on in-process worlds of 1 and 4 ranks on `dev`
    (COMMS: bench/bench_mnmg.py's rows cut to 5M x 96):
      1. `mnmg.knn` (sqeuclidean, k 10) at worlds 1 and 4: seconds a call,
         QPS, kernel 6's launches (> 0); world 4 equal to world 1 (ties
         aside), to single-device brute_force.knn(engine="tiled") outside
         near-ties within VAL_RTOL, 16 queries to float64; then on 4 ranks
         the sharded and auto query modes and the tournament merge (equal
         to the replicated merge), quantization off (bit for bit), int8 and
         bf16 (recall >= QUANT_RECALL against off), a 50% prefilter
         (against the filtered single-device scan), bf16 operands (against
         the single-device bf16 scan), rank 2 marked down (the survivors'
         merge, coverage 0.75) and replication 2 with rank 1 down (the
         healthy answer bit for bit, repaired rank 1);
      2. `mnmg.kmeans_fit` (1,024 clusters, 10 iterations) at worlds 1 and
         4 from the same init, seconds an iteration, and the predict labels;
      3. every collective on 4 ranks at bench_comms.py's (64, 256) f32
         block against its reference composed on one tensor; the health
         barrier's latency;
      4. the process worlds, as children of this script under a deadline:
         NCCL at world 1 on the card (1M rows, bit for bit the in-process
         world 1) and gloo at world 2 on the CPU (bit for bit the in-process
         2-rank CPU world).
    Returns (summary, kernel 6's rows at this path's shapes, (the data, the
    queries, and world 4's exact values and ids: phase 4h's data and
    truth))."""
    C = COMMS_REHEARSE if g.rehearse else COMMS
    t_phase = time.perf_counter()
    out = {"sizes": C}
    x, q = comms_blobs(g.seed, C["n"], C["dim"], C["nq"], C["blobs"], dev)
    sync()
    out["data_s"] = time.perf_counter() - t_phase
    log(f"comms data: {C['n']} x {C['dim']} rows and {C['nq']} queries made on {dev} in "
        f"{out['data_s']:.3f} s")
    with committed(dev):
        out["knn"], spy, (tv, ti) = comms_knn_part(g, dev, C, x, q, sync)
        out["kmeans"] = comms_kmeans_part(g, dev, C, x, sync)
        kids, deadline = comms_children(g, dev, C)
        out["collectives"] = comms_collectives(g, dev, C, sync)
        out["children"] = comms_join(kids, deadline)
    rows = []
    launches = out["knn"]["launches_one_call"]
    tile = spy.first.get((C["nq"], 1 << 15))
    if tile is not None:
        rows.append(counting_tile_row(tile[0], tile[1], launches, g.reps,
                                      "comms knn world 4, a rank's tile select"))
    if spy.last is not None:
        rows.append(counting_tile_row(spy.last[0], spy.last[1], launches, g.reps,
                                      "comms knn world 4, the merge select (4 x 10 candidates "
                                      "padded to 128)"))
    if dev.type == "cuda" and len(rows) != 2:
        raise AssertionError(f"comms path: kernel 6 saw no tile or merge select "
                             f"({list(spy.first)})")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"comms path complete in {out['wall_s']:.3f} s")
    return out, rows, (x, q, tv, ti)


# ---------------------------------------------------------------------------
# phase 4h: the distributed IVF drivers (IVF-PQ, IVF-Flat, IVF-RaBitQ)
# ---------------------------------------------------------------------------

#: bench/bench_mnmg.py:56-124's IVF configuration on 4g's data: IVF-PQ at
#: 1,024 lists, pq_dim 48, 10 k-means iterations, searched at n_probes 32
#: and refined at 8, 1M rows extended; IVF-Flat and RaBitQ at 1,024 lists;
#: the mutation drill's 1% deletes and 10,000 upserts; the NCCL child's
#: IVF-PQ on its 1M rows, the gloo children's small index (`gloo_rows` of
#: each process's rows); `timed_s`: the
#: seconds a search's timed window aims at (1 to 5 calls); `lut_nq`: the
#: queries of the "lut" engine, a cut of depth (at 4,096 queries and 10M
#: rows it took 119.4 s a call on the H100, 34 QPS; at 256, 6.4–8.7 s:
#: PERF.md §6)
MNMG_IVF = dict(n_lists=1024, pq_dim=48, iters=10, probes=32, refine_probes=8,
                n_extend=1_000_000, delete_frac=0.01, n_upsert=10_000, gloo_lists=32,
                gloo_pq_dim=16, gloo_rows=2_000, timed_s=3.0, lut_nq=64)
MNMG_IVF_REHEARSE = dict(MNMG_IVF, n_lists=16, pq_dim=16, n_extend=2_000, n_upsert=200,
                         gloo_lists=16, gloo_pq_dim=8, timed_s=0.0, lut_nq=32)
#: bench/bench_ivf_rabitq.py's ladder: n_probes x rerank_mult
RABITQ_LADDER = ((8, 4), (8, 8), (16, 4), (16, 8), (16, 16), (32, 8), (32, 16), (32, 25),
                 (64, 16), (64, 25))
#: the bin trim's recall may differ from the exact trims' (ROADMAP Queue C)
BIN_TRIM_RECALL = 0.005


def mnmg_timed(run, sync, nq, budget_s, first_s):
    """(seconds a call, QPS, calls): one window of back-to-back calls sized
    to about `budget_s` from a first call's `first_s` (1 to 5 calls), one
    synchronize at its end."""
    reps = max(1, min(5, int(budget_s / max(first_s, 1e-3))))
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    sync()
    s = (time.perf_counter() - t0) / reps
    return s, nq / s, reps


def mnmg_search(run, names, spy, sync, nq, budget_s):
    """A first call with the launch counts set to 0 just before it and read
    just after (under `spy`, which keeps the kernels' inputs), then a timed
    window (`mnmg_timed`). Returns (result, {kernel: launches}, seconds a
    call, QPS, calls)."""
    from raft_tpu_torch.ops import _launch

    with spy if spy is not None else contextlib.nullcontext():
        sync()
        _launch.reset_launch_counts()
        t0 = time.perf_counter()
        res = run()
        sync()
        first = time.perf_counter() - t0
        counts = _launch.launch_counts()
    return (res, {n: counts[n] for n in names}) + mnmg_timed(run, sync, nq, budget_s, first)


def store_bytes(name, arr, rows, row_bytes):
    """A sharded store's padded bytes beside the bytes its real rows hold."""
    padded = int(np.prod(arr.shape)) * arr.blocks[0].element_size()
    real = int(rows) * int(row_bytes)
    log(f"mnmg ivf store {name}: {tuple(arr.shape)} {arr.dtype}, padded {padded / 1e9:.4f} GB, "
        f"real rows {real / 1e9:.4f} GB ({padded / max(real, 1):.3f}x)")
    return {"shape": list(arr.shape), "padded_gb": padded / 1e9, "real_gb": real / 1e9}


def mnmg_ivf_child(comms, local, x, q, k, sync, M, seed):
    """The NCCL child's IVF-PQ at world 1: `ivf_pq_build_local` and a
    refined search in the process world and in the in-process world of
    one rank, bit for bit."""
    from raft_tpu_torch.comms import mnmg
    from raft_tpu_torch.neighbors import ivf_pq

    params = ivf_pq.IndexParams(n_lists=M["n_lists"], pq_dim=M["pq_dim"],
                                kmeans_n_iters=M["iters"])
    t0 = time.perf_counter()
    pidx = mnmg.ivf_pq_build_local(comms, params, x, seed=seed)
    pres = mnmg.ivf_pq_search(pidx, q, k, n_probes=M["refine_probes"], refine_dataset=x)
    sync()
    out = {"ivf_process_s": time.perf_counter() - t0}
    lidx = mnmg.ivf_pq_build_local(local, params, x, seed=seed)
    lres = mnmg.ivf_pq_search(lidx, q, k, n_probes=M["refine_probes"], refine_dataset=x)
    out["ivf_equal"] = bit_equal(pres, lres) and torch.equal(pidx.codes.full(),
                                                             lidx.codes.full())
    return out


def mnmg_ivf_gloo(g, comms, local, part, q, k):
    """The gloo children's IVF-PQ lifecycle at world 2 on the CPU:
    `ivf_pq_build_local` of each process's rows, `ivf_pq_save_local` (a
    part file each and the manifest), then `ivf_pq_load` into the
    in-process 2-rank CPU world and back into the process world; every
    search bit for bit the process world's own index."""
    import shutil

    from raft_tpu_torch.comms import mnmg
    from raft_tpu_torch.neighbors import ivf_pq
    import torch.distributed as dist

    M = MNMG_IVF_REHEARSE if g.rehearse else MNMG_IVF
    params = ivf_pq.IndexParams(n_lists=M["gloo_lists"], pq_dim=M["gloo_pq_dim"],
                                kmeans_n_iters=5)
    ckdir = os.path.join(tempfile.gettempdir(), f"chip_smoke_gloo_{g.child_port}")
    os.makedirs(ckdir, exist_ok=True)
    path = os.path.join(ckdir, "pq.ckpt")
    t0 = time.perf_counter()
    pidx = mnmg.ivf_pq_build_local(comms, params, part[:M["gloo_rows"]], seed=g.seed)
    pres = mnmg.ivf_pq_search(pidx, q, k, n_probes=4, engine="lut")
    mnmg.ivf_pq_save_local(path, pidx)
    out = {"ivf_process_s": time.perf_counter() - t0}
    lres = mnmg.ivf_pq_search(mnmg.ivf_pq_load(local, path), q, k, n_probes=4, engine="lut")
    rres = mnmg.ivf_pq_search(mnmg.ivf_pq_load(comms, path), q, k, n_probes=4, engine="lut")
    out["ivf_equal"] = bit_equal(pres, lres) and bit_equal(pres, rres)
    dist.barrier()
    if g.child_rank == 0:
        shutil.rmtree(ckdir, ignore_errors=True)
    return out


def mnmg_pq_runs(M, x):
    """{search: (arguments, kernels it must launch)} of phase 4h's IVF-PQ
    searches (the "approx" trim and the merges select with kernel 6)."""
    P_, R_ = M["probes"], M["refine_probes"]
    return {
        "recon8_list": (dict(n_probes=P_, engine="recon8_list"), ("counting_select_min",)),
        "lut": (dict(n_probes=P_, engine="lut"), ("counting_select_min",)),
        "refined": (dict(n_probes=R_, refine_dataset=x), ("counting_select_min",)),
        "pallas": (dict(n_probes=P_, trim_engine="pallas"), ("pq_list_scan",)),
        "fused_bf16": (dict(n_probes=P_, trim_engine="fused"), ("fused_list_topk",)),
        "fused_int8": (dict(n_probes=P_, trim_engine="fused", score_dtype="int8"),
                       ("fused_list_topk_int8",)),
    }


def mnmg_pq_part(g, dev, M, C, c4, x, q, truth, sync, spies):
    """Step 1: the IVF-PQ build and searches at 4 ranks. Returns (summary,
    index, {search: result})."""
    from raft_tpu_torch.comms import mnmg
    from raft_tpu_torch.neighbors import ivf_pq

    k, nq = C["k"], C["nq"]
    out = {}
    params = ivf_pq.IndexParams(n_lists=M["n_lists"], pq_dim=M["pq_dim"],
                                kmeans_n_iters=M["iters"])
    sync()
    t0 = time.perf_counter()
    idx = mnmg.ivf_pq_build(c4, params, x, seed=g.seed)
    sync()
    out["build_s"] = time.perf_counter() - t0
    log(f"path mnmg ivf_pq build: {C['n']} x {C['dim']} rows, {M['n_lists']} lists, pq_dim "
        f"{M['pq_dim']}, 4 ranks in {out['build_s']:.3f} s, padded list {idx.codes.shape[2]}")
    out["codes"] = store_bytes("ivf_pq codes", idx.codes, idx.n, M["pq_dim"])
    results = {}
    for name, (kw, kernels) in mnmg_pq_runs(M, x).items():
        nq_run = M["lut_nq"] if name == "lut" else nq
        res, launches, s, qps, reps = mnmg_search(
            lambda: mnmg.ivf_pq_search(idx, q[:nq_run], k, **kw), kernels, spies.get(name),
            sync, nq_run, M["timed_s"])
        r = recall(res[1], truth[:nq_run])
        results[name] = res
        out[name] = {"n_probes": kw["n_probes"], "queries": nq_run, "recall": r,
                     "s_per_call": s, "qps": qps, "calls": reps, "launches": launches}
        log(f"path mnmg ivf_pq {name} n_probes {kw['n_probes']}, {nq_run} queries: recall@{k} "
            f"{r:.4f}, {s:.4f} s a call ({reps} timed), {qps:.1f} QPS, launches {launches}")
        if dev.type == "cuda" and min(launches.values()) <= 0:
            raise AssertionError(f"mnmg ivf_pq {name}: kernels never launched: {launches}")
    if out["refined"]["recall"] < RECALL_GATE:
        raise AssertionError(f"mnmg ivf_pq refined: recall@{k} {out['refined']['recall']} < "
                             f"{RECALL_GATE}")
    recon = idx.recon8
    out["recon8"] = store_bytes("ivf_pq recon8", recon, idx.n, recon.shape[-1])
    return out, idx, results


def mnmg_ckpt_part(g, dev, M, C, c4, idx, x, q, truth, results, tmp, sync):
    """Step 2: the sharded checkpoint of the 4-rank index, its fold-merge
    load onto one rank (the world-4 ids of the engines exact within the
    probes, the bin trim within BIN_TRIM_RECALL), then `ivf_pq_extend_local` of 1M rows on the world-1
    index and the driver extend with the post-merge refine against the
    truth over all the rows."""
    from raft_tpu_torch.comms import Comms, mnmg

    k, nq = C["k"], C["nq"]
    out = {}
    path = os.path.join(tmp, "pq_sharded.ckpt")
    sync()
    t0 = time.perf_counter()
    mnmg.ivf_pq_save_local(path, idx)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp)
                 if f.startswith("pq_sharded.ckpt"))
    c1 = Comms(n_devices=1, device=dev)
    t0 = time.perf_counter()
    idx1 = mnmg.ivf_pq_load(c1, path)
    sync()
    load_s = time.perf_counter() - t0
    out.update(save_s=save_s, load_s=load_s, bytes=nbytes, save_gbps=nbytes / save_s / 1e9,
               load_gbps=nbytes / load_s / 1e9)
    log(f"mnmg ivf_pq save_local {nbytes / 1e9:.4f} GB in {save_s:.3f} s "
        f"({out['save_gbps']:.3f} GB/s); load onto 1 rank (fold-merge) in {load_s:.3f} s "
        f"({out['load_gbps']:.3f} GB/s); padded list {idx1.codes.shape[2]}")
    R_ = M["refine_probes"]
    out["world1"] = {}
    for name, (kw, _) in mnmg_pq_runs(M, x).items():
        nq_run = M["lut_nq"] if name == "lut" else nq
        v1, i1 = mnmg.ivf_pq_search(idx1, q[:nq_run], k, **kw)
        v4, i4 = results[name]
        if name == "pallas":
            d = abs(recall(i1, truth) - recall(i4, truth))
            ok = d <= BIN_TRIM_RECALL
            out["world1"][name] = {"recall_diff": d}
        elif name == "refined":
            # not exact within the probes: each rank re-ranks its own
            # shortlist, so four ranks re-rank four times the candidates
            ok = True
            out["world1"][name] = {"recall": recall(i1, truth),
                                   "recall_world4": recall(i4, truth)}
        else:
            ok = tie_equal(v4, i4, v1, i1, rtol=VAL_RTOL)
            out["world1"][name] = {"ids_equal_outside_ties": ok,
                                   "bit_equal": bit_equal((v1, i1), (v4, i4))}
        if not ok:
            raise AssertionError(f"mnmg ivf_pq world 1 {name}: not the world-4 answer")
    log("mnmg ivf_pq world 1 (fold-merged) against world 4: " + json.dumps(out["world1"]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(g.seed + 61)
    centers = x[torch.randint(0, x.shape[0], (M["n_extend"],), generator=gen, device=dev)]
    extra = centers + 0.5 * torch.randn(centers.shape, generator=gen, device=dev)
    sync()
    t0 = time.perf_counter()
    ext1 = mnmg.ivf_pq_extend_local(idx1, extra)
    sync()
    s = time.perf_counter() - t0
    out["extend_local"] = {"rows": M["n_extend"], "s": s, "rows_per_s": M["n_extend"] / s,
                           "n": ext1.n}
    log(f"mnmg ivf_pq_extend_local of {M['n_extend']} rows on 1 rank: {s:.3f} s "
        f"({M['n_extend'] / s:.1f} rows/s), n {ext1.n}")
    del ext1, idx1
    c1.destroy()
    sync()
    t0 = time.perf_counter()
    ext4 = mnmg.ivf_pq_extend(idx, extra)
    sync()
    s = time.perf_counter() - t0
    full = torch.cat([x, extra])
    tv, ti = mnmg.knn(c4, full, q, k, query_mode="replicated")
    res, _, sc_, qps, _ = mnmg_search(
        lambda: mnmg.ivf_pq_search(ext4, q, k, n_probes=R_, refine_dataset=full), (), None,
        sync, nq, M["timed_s"])
    r = recall(res[1], ti)
    out["extend"] = {"rows": M["n_extend"], "s": s, "rows_per_s": M["n_extend"] / s,
                     "refined_recall": r, "refined_s": sc_, "refined_qps": qps}
    log(f"mnmg ivf_pq_extend of {M['n_extend']} rows on 4 ranks: {s:.3f} s "
        f"({M['n_extend'] / s:.1f} rows/s); the post-merge refined search at n_probes {R_}: "
        f"recall@{k} {r:.4f} against the truth over all {full.shape[0]} rows, {sc_:.4f} s a "
        f"call, {qps:.1f} QPS")
    if r < RECALL_GATE:
        raise AssertionError(f"mnmg ivf_pq extended refined: recall@{k} {r} < {RECALL_GATE}")
    del ext4, full, tv, ti, extra, centers
    return out


def mnmg_flat_rabitq_part(g, dev, M, C, c4, x, q, truth, sync, spies):
    """Step 3: IVF-Flat at 4 ranks, "auto" (= "list") and "pallas"
    (kernel 1) at n_probes 32; IVF-RaBitQ at 4 ranks up bench_ivf_rabitq's
    ladder (scan_engine "fused", the exact rerank) to the first rung at
    recall >= RECALL_GATE (kernel 7)."""
    from raft_tpu_torch.comms import mnmg
    from raft_tpu_torch.neighbors import ivf_flat, ivf_rabitq

    k, nq = C["k"], C["nq"]
    out = {"flat": {}, "rabitq": {}}
    sync()
    t0 = time.perf_counter()
    fl = mnmg.ivf_flat_build(c4, ivf_flat.IndexParams(n_lists=M["n_lists"],
                                                      kmeans_n_iters=M["iters"]), x, seed=g.seed)
    sync()
    out["flat"]["build_s"] = time.perf_counter() - t0
    out["flat"]["list_data"] = store_bytes("ivf_flat list_data", fl.list_data, fl.n,
                                           C["dim"] * 4)
    log(f"path mnmg ivf_flat build: {M['n_lists']} lists, 4 ranks in "
        f"{out['flat']['build_s']:.3f} s")
    for engine in ("auto", "pallas"):
        res, launches, s, qps, reps = mnmg_search(
            lambda: mnmg.ivf_flat_search(fl, q, k, n_probes=M["probes"], engine=engine),
            ("fused_list_topk",), spies["flat"] if engine == "pallas" else None, sync, nq,
            M["timed_s"])
        r = recall(res[1], truth)
        out["flat"][engine] = {"recall": r, "s_per_call": s, "qps": qps, "calls": reps,
                               "launches": launches}
        log(f"path mnmg ivf_flat {engine} n_probes {M['probes']}: recall@{k} {r:.4f}, "
            f"{s:.4f} s a call, {qps:.1f} QPS, launches {launches}")
        if engine == "pallas" and dev.type == "cuda" and launches["fused_list_topk"] <= 0:
            raise AssertionError("mnmg ivf_flat pallas: kernel 1 never launched")
    out["flat"]["resid_bf16"] = store_bytes("ivf_flat resid_bf16", fl.resid_bf16, fl.n,
                                            C["dim"] * 2)
    del fl
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sync()
    t0 = time.perf_counter()
    rb = mnmg.ivf_rabitq_build(c4, ivf_rabitq.IndexParams(n_lists=M["n_lists"],
                                                          kmeans_n_iters=M["iters"]),
                               x, seed=g.seed)
    sync()
    out["rabitq"]["build_s"] = time.perf_counter() - t0
    out["rabitq"]["codes"] = store_bytes("ivf_rabitq codes", rb.codes, rb.n,
                                         rb.codes.shape[-1] * 4)
    log(f"path mnmg ivf_rabitq build: {M['n_lists']} lists, 4 ranks in "
        f"{out['rabitq']['build_s']:.3f} s")
    rungs = []
    for p, mult in RABITQ_LADDER:
        ids = mnmg.ivf_rabitq_search(rb, q, k, n_probes=p, refine_dataset=x, refine_mult=mult,
                                     scan_engine="fused")[1]
        r = recall(ids, truth)
        rungs.append({"n_probes": p, "refine_mult": mult, "recall": r})
        log(f"mnmg ivf_rabitq rung n_probes {p}, refine_mult {mult}: recall@{k} {r:.4f}")
        if r >= RECALL_GATE:
            break
    gate = rungs[-1]
    _, launches, s, qps, reps = mnmg_search(
        lambda: mnmg.ivf_rabitq_search(rb, q, k, n_probes=gate["n_probes"], refine_dataset=x,
                                       refine_mult=gate["refine_mult"], scan_engine="fused"),
        ("fused_bitplane_topk",), spies["rabitq"], sync, nq, M["timed_s"])
    gate.update(s_per_call=s, qps=qps, calls=reps, launches=launches)
    out["rabitq"]["rungs"] = rungs
    log(f"path mnmg ivf_rabitq gate rung n_probes {gate['n_probes']}, refine_mult "
        f"{gate['refine_mult']}: recall@{k} {gate['recall']:.4f}, {s:.4f} s a call, "
        f"{qps:.1f} QPS, launches {launches}")
    if gate["recall"] < RECALL_GATE:
        raise AssertionError(f"mnmg ivf_rabitq: no rung reached recall@{k} >= {RECALL_GATE}")
    if dev.type == "cuda" and launches["fused_bitplane_topk"] <= 0:
        raise AssertionError("mnmg ivf_rabitq: kernel 7 never launched")
    return out


def mnmg_resilience_part(g, M, C, c4, idx, x, q, tmp, sync):
    """Step 4: failover, repair and rejoin, the watchdog's rot and mirror
    repair, and a corrupt replicated checkpoint healed on load, all on the
    4-rank IVF-PQ index (replication 2), each bit / byte for bit."""
    from raft_tpu_torch.comms import RankHealth, mnmg, recovery
    from raft_tpu_torch.core import faults
    from raft_tpu_torch.core.serialize import deserialize_arrays_checked
    from raft_tpu_torch.integrity import watchdog

    k = C["k"]
    out = {}
    t0 = time.perf_counter()
    mnmg.replicate_index(idx, 2)
    sync()
    out["mirror_s"] = time.perf_counter() - t0

    def refined(health=None):
        return mnmg.ivf_pq_search(idx, q, k, n_probes=M["refine_probes"], refine_dataset=x,
                                  health=health)

    healthy = refined()
    health = RankHealth.all_healthy(4).mark_unhealthy(1)
    t0 = time.perf_counter()
    res = refined(health)
    sync()
    out["failover_s"] = time.perf_counter() - t0
    if not (bit_equal(res, healthy) and res.coverage == 1.0 and res.repaired_ranks == (1,)):
        raise AssertionError(f"mnmg failover: coverage {res.coverage}, repaired "
                             f"{res.repaired_ranks}, or not the healthy answer bit for bit")
    t0 = time.perf_counter()
    recovery.repair(c4, health, idx)
    health = recovery.rank_rejoin(c4, health, 1)
    sync()
    out["repair_rejoin_s"] = time.perf_counter() - t0
    if health.degraded or not bit_equal(refined(health)[:2], healthy):
        raise AssertionError("mnmg repair + rank_rejoin: not healthy bit for bit")
    # one replicated checkpoint, rotted by the fault site as it is saved:
    # healed on load, and the repair's fallback below
    plan = faults.FaultPlan([faults.Fault(kind="corrupt_shard", site="ckpt.corrupt_file",
                                          fraction=1e-4)], seed=g.seed + 7)
    drill = os.path.join(tmp, "pq_drill.ckpt")
    with plan.install():
        mnmg.ivf_pq_save(drill, idx)
    bad = deserialize_arrays_checked(drill, to_device=False)[2]
    t0 = time.perf_counter()
    healed = mnmg.ivf_pq_load(c4, drill)
    sync()
    out["heal_load_s"] = time.perf_counter() - t0
    if not bad or not all(torch.equal(getattr(healed, n).full(), getattr(idx, n).full())
                          for n in ("codes", "slot_gids")):
        raise AssertionError(f"mnmg ckpt heal: corrupt fields {bad}, or the load is not the "
                             "saved tables")
    out["corrupt_fields"] = bad
    del healed
    t0 = time.perf_counter()
    base = watchdog.mnmg_digests(idx)
    out["digest_s"] = time.perf_counter() - t0
    watchdog.rot_rank(idx, 2, seed=g.seed)
    named = watchdog.verify_mnmg(idx, base)
    t0 = time.perf_counter()
    idx = watchdog.repair_ranks(idx, named, checkpoint=drill)
    sync()
    out["rot_repair_s"] = time.perf_counter() - t0
    if named != [2] or watchdog.verify_mnmg(idx, base) != []:
        raise AssertionError(f"mnmg watchdog: named {named}, or the repair left a mismatch")
    log(f"mnmg resilience on ivf_pq (replication 2): mirror {out['mirror_s']:.3f} s; rank 1 "
        f"down: the healthy refined answer bit for bit, coverage 1.0, repaired (1,) in "
        f"{out['failover_s']:.3f} s; repair + rank_rejoin {out['repair_rejoin_s']:.3f} s, bit "
        f"for bit; digests {out['digest_s']:.3f} s, rot_rank(2) named {named}, repair_ranks "
        f"{out['rot_repair_s']:.3f} s byte for byte; ckpt.corrupt_file hit {bad}, healed on "
        f"load in {out['heal_load_s']:.3f} s")
    return out, idx


def mnmg_mutation_part(g, dev, M, C, c4, idx, x, q, sync):
    """Step 5: delete 1% of the ids (none comes back; recall against the
    live truth), then upsert new rows, each found first by the post-merge
    refine."""
    from raft_tpu_torch.comms import mnmg, mnmg_mutation

    k = C["k"]
    n = x.shape[0]
    out = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(g.seed + 67)
    victims = torch.randperm(n, generator=gen, device=dev)[:int(n * M["delete_frac"])]
    t0 = time.perf_counter()
    dl = mnmg_mutation.delete(idx, victims.cpu().numpy())
    sync()
    out["delete_s"] = time.perf_counter() - t0
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[victims] = False
    _, live_truth = mnmg.knn(c4, x, q, k, prefilter=alive.cpu().numpy(), query_mode="replicated")
    _, ids = mnmg.ivf_pq_search(dl, q, k, n_probes=M["refine_probes"], refine_dataset=x)
    back = int((~alive[ids.long().clamp(min=0)] & (ids >= 0)).sum())
    r = recall(ids, live_truth)
    out.update(deleted=int(victims.numel()), deleted_back=back, live_recall=r)
    if back or r < RECALL_GATE:
        raise AssertionError(f"mnmg delete: {back} deleted ids came back, or recall {r}")
    rows = x[:M["n_upsert"]] + 0.25 * torch.randn((M["n_upsert"], x.shape[1]), generator=gen,
                                                  device=dev)
    t0 = time.perf_counter()
    up = mnmg_mutation.upsert(dl, "ivf_pq", rows)
    sync()
    out["upsert_s"] = time.perf_counter() - t0
    full = torch.cat([x, rows])
    _, ids = mnmg.ivf_pq_search(up, rows, k, n_probes=M["refine_probes"], refine_dataset=full)
    found = float((ids[:, 0].cpu() == torch.arange(n, n + M["n_upsert"])).float().mean())
    out.update(upserted=M["n_upsert"], self_first=found)
    log(f"mnmg mutation on ivf_pq: delete {victims.numel()} ids in {out['delete_s']:.3f} s, "
        f"{back} back, recall@{k} {r:.4f} against the live truth; upsert {M['n_upsert']} rows "
        f"in {out['upsert_s']:.3f} s, each first for itself: {found:.4f}")
    if found < 1.0:
        raise AssertionError(f"mnmg upsert: {found} of the rows find themselves first")
    return out


def mnmg_ivf_path(g, dev, sync, data=None):
    """Phase 4h: the distributed IVF drivers (raft_tpu_torch.comms
    mnmg_ivf_build / mnmg_ivf_search / mnmg_rabitq / mnmg_ckpt /
    mnmg_mutation / replication / recovery) under the committed table, on
    4g's 5M x 96 rows and 4,096 queries (or their rehearsal size) at k
    10, the exact truth 4g's world-4 `mnmg.knn`, on `Comms(n_devices=4)`
    of the card (MNMG_IVF: bench/bench_mnmg.py's configuration):
      1. `ivf_pq_build` (1,024 lists, pq_dim 48); "recon8_list", "lut" (on
         the first `lut_nq` queries) and the trims "pallas", "fused" bf16
         and int8 at n_probes 32, the
         refined pipeline at 8 (gate: recall@10 >= RECALL_GATE): seconds a
         call, QPS, recall, kernels 6 / 4 / 1 / 3 launched; padded and
         real bytes of each store;
      2. `ivf_pq_save_local`, `ivf_pq_load` onto one rank (the
         fold-merge): save and load GB/s; the world-1 index answers every
         search of step 1 as world 4 does (outside ties; the bin trim
         within BIN_TRIM_RECALL; the refined pipeline's recall beside world
         4's: each rank re-ranks its own shortlist, so it is not exact
         within the probes); `ivf_pq_extend_local` of 1M rows on it
         (rows/s), `ivf_pq_extend` on world 4 and the post-merge refined
         search against the truth over all the rows;
      3. `ivf_flat_build` with "auto" and "pallas" (kernel 1), and
         `ivf_rabitq_build` up bench_ivf_rabitq's ladder (kernel 7);
      4. replication 2: failover, repair + rank_rejoin, the watchdog's rot
         and mirror repair, a corrupt checkpoint healed on load;
      5. delete 1% of the ids and upsert 10,000 rows;
      6. the process worlds run as 4g's children (ivf_pq_build_local at
         world 1 on NCCL, build_local / save_local / load at world 2 on
         gloo).
    Returns (summary, rows of kernels 1, 3, 4, 6 and 7 at this path's
    per-rank shapes)."""
    import shutil

    from raft_tpu_torch.comms import Comms, mnmg
    from raft_tpu_torch.ops import fused_scan as fs
    from raft_tpu_torch.ops import pq_list_scan as pls
    from raft_tpu_torch.ops import select_counting as sc

    C = COMMS_REHEARSE if g.rehearse else COMMS
    M = MNMG_IVF_REHEARSE if g.rehearse else MNMG_IVF
    t_phase = time.perf_counter()
    out = {"sizes": M}
    c4 = Comms(n_devices=4, device=dev)
    if data is None:
        x, q = comms_blobs(g.seed, C["n"], C["dim"], C["nq"], C["blobs"], dev)
        with committed(dev):
            _, truth = mnmg.knn(c4, x, q, C["k"], query_mode="replicated")
    else:
        x, q, _, truth = data
    spies = {"recon8_list": SelectCalls(sc, "counting_select_min"),
             "pallas": Spy(pls, "pq_list_scan"), "fused_bf16": Spy(fs, "fused_list_topk"),
             "fused_int8": Spy(fs, "fused_list_topk_int8"), "flat": Spy(fs, "fused_list_topk"),
             "rabitq": Spy(fs, "fused_bitplane_topk")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mnmg_ivf_")
    try:
        with committed(dev):
            out["ivf_pq"], idx, results = mnmg_pq_part(g, dev, M, C, c4, x, q, truth, sync, spies)
            out["ckpt"] = mnmg_ckpt_part(g, dev, M, C, c4, idx, x, q, truth, results, tmp, sync)
            out["resilience"], idx = mnmg_resilience_part(g, M, C, c4, idx, x, q, tmp, sync)
            out["mutation"] = mnmg_mutation_part(g, dev, M, C, c4, idx, x, q, sync)
            del idx, results
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            out.update(mnmg_flat_rabitq_part(g, dev, M, C, c4, x, q, truth, sync, spies))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    c4.destroy()
    rows = []
    launch = {name: rec["launches"] for name, rec in out["ivf_pq"].items()
              if isinstance(rec, dict) and "launches" in rec}
    sel = spies["recon8_list"]
    tile = next(iter(sel.first.values()), None)
    if tile is not None:
        rows.append(counting_tile_row(tile[0], tile[1], launch["recon8_list"]
                                      ["counting_select_min"], g.reps,
                                      "mnmg ivf_pq approx trim, a rank's chunk select"))
    if sel.last is not None:
        rows.append(counting_tile_row(sel.last[0], sel.last[1],
                                      launch["recon8_list"]["counting_select_min"], g.reps,
                                      "mnmg ivf_pq, the merge select"))
    for name, label, row_fn in (
            ("fused_bf16", "mnmg ivf_pq trim, a rank, n_probes 32", "list"),
            ("fused_int8", "mnmg ivf_pq int8 trim, a rank, n_probes 32", "int8"),
            ("pallas", "mnmg ivf_pq bin trim, exact fold, a rank, n_probes 32", "fold")):
        calls = spies[name].calls
        if not calls:
            continue
        n_l = launch[name][next(iter(launch[name]))]
        if row_fn == "list":
            rows.append(list_kernel_row(fs, calls[0], n_l, g.reps, label))
        elif row_fn == "int8":
            rows.append(int8_list_row(fs, calls[0], n_l, g.reps, label))
        else:
            rows.append(fold_kernel_row(pls, calls[0], n_l, g.reps, label, "exact"))
    if spies["flat"].calls:
        rows.append(list_kernel_row(fs, spies["flat"].calls[0],
                                    out["flat"]["pallas"]["launches"]["fused_list_topk"], g.reps,
                                    "mnmg ivf_flat pallas, a rank, n_probes 32",
                                    term_scale=True))
    if spies["rabitq"].calls:
        gate = out["rabitq"]["rungs"][-1]
        rows.append(bitplane_row(fs, spies["rabitq"].calls[0],
                                 gate["launches"]["fused_bitplane_topk"], g.reps,
                                 f"mnmg ivf_rabitq, a rank, n_probes {gate['n_probes']}, "
                                 f"refine_mult {gate['refine_mult']}"))
    if dev.type == "cuda" and len(rows) != 7:
        raise AssertionError(f"mnmg ivf path: {len(rows)} kernel rows, not 7")
    for s_ in spies.values():
        if isinstance(s_, SelectCalls):
            s_.first, s_.last = {}, None
        else:
            s_.calls = []
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"mnmg ivf path complete in {out['wall_s']:.3f} s")
    return out, rows


# ---------------------------------------------------------------------------
# phase 4i: the serving layer
# ---------------------------------------------------------------------------

#: phase 4i's traffic, bench/bench_serve.py's protocol (:94-151): 256 probe
#: queries (data rows plus 0.01 noise), 8 client threads x 250 requests of
#: 1-8 rows, buckets (16, 64, 256), a 1 ms linger; the unbatched baseline's
#: 200 requests; the brief stream of every other searcher (2 x 100); the
#: IVF-Flat n_probes ladder; the overload's 4x burst against a shedding
#: admission (a 256-row queue, a 250 ms deadline); the live index's 1%
#: delete and 10,000-row upsert; the scrub's slice; the distributed
#: searcher's rows and probes; the batch-mate requests
SERVE = dict(probe_q=256, noise=0.01, clients=8, requests=250, baseline=200, brief_clients=2,
             brief_requests=100, buckets=(16, 64, 256), max_wait_ms=1.0,
             flat_ladder=(1, 2, 4, 8, 16, 32), pq_probes=16, burst=4, burst_requests=60,
             burst_size=6, overload_probes=8, queue_rows=256, deadline_s=0.25, delete_frac=0.01, upsert_rows=10_000,
             scrub_budget=8, mnmg_rows=1_000_000, mnmg_probes=32, mates=(3, 5, 7, 16),
             obs_requests=64)
SERVE_REHEARSE = dict(SERVE, clients=2, requests=30, baseline=20, brief_requests=20,
                      burst_requests=15, queue_rows=64, deadline_s=2.0, upsert_rows=200,
                      scrub_budget=4, mnmg_rows=20_000, obs_requests=16)


def serve_setup(g, dev, sync):
    """Phase 4i's indexes when it runs alone (`--serve`): the main path's
    data, its IVF-PQ, IVF-Flat and RaBitQ builds (phase 4's settings) and
    the RaBitQ gate rung on the main path's queries (phase 4's ladder)."""
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq, ivf_rabitq

    data_np, queries_np = make_blobs(g.seed, g.n, g.dim, g.nq, g.n_lists)
    dataset = torch.from_numpy(data_np).to(dev)
    queries = torch.from_numpy(queries_np).to(dev)
    t0 = time.perf_counter()
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=g.n_lists, pq_dim=g.dim // 2,
                                            kmeans_n_iters=10), dataset, seed=g.seed, device=dev)
    flat_index = ivf_flat.build(ivf_flat.IndexParams(n_lists=g.n_lists, kmeans_n_iters=10),
                                dataset, seed=g.seed, device=dev)
    rb_index = ivf_rabitq.build(ivf_rabitq.IndexParams(n_lists=g.n_lists, kmeans_n_iters=10),
                                dataset, seed=g.seed, device=dev)
    _, truth = brute_force.knn(dataset, queries, g.k, engine="fused", device=dev)
    sync()
    log(f"serve setup: data, three builds and the truth in {time.perf_counter() - t0:.3f} s")
    with table({}):
        rb_gate = next({"n_probes": p, "rerank_mult": m} for p in PROBE_LADDER
                       for m in (4, 8, 16, 25) if recall(ivf_rabitq.search(
                           ivf_rabitq.SearchParams(n_probes=p, rerank_mult=m,
                                                   scan_engine="fused"),
                           rb_index, queries, g.k)[1], truth) >= RECALL_GATE)
    return {"data_np": data_np, "dataset": dataset, "index": index, "flat_index": flat_index,
            "rb_index": rb_index, "rb_gate": rb_gate}


def serve_inputs(res, fl, rb):
    """Phase 4i's inputs from phase 4's results."""
    return {"data_np": res["dataset"].cpu().numpy(), "dataset": res["dataset"],
            "index": res["index"], "flat_index": fl["index"], "rb_index": rb["index"],
            "rb_gate": {key: rb["gate"][key] for key in ("n_probes", "rerank_mult")}}


def serve_stream(rng, n_probe, total):
    """bench_serve's request stream: `total` requests of 1-8 probe rows,
    uniform; returns [probe row indices of each request]."""
    sizes = rng.integers(1, 9, total)
    return [rng.integers(0, n_probe, int(n)) for n in sizes]


def drive(server, probe_q, stream, clients, k, timeout_s=300.0):
    """`clients` threads, each submitting its share of `stream` one request
    at a time and waiting for the reply (bench_serve's client). Returns
    (wall seconds, [reply of each request], [client-side latency s])."""
    replies, lats = [None] * len(stream), [0.0] * len(stream)
    errors = []
    per = -(-len(stream) // clients)

    def client(lo):
        try:
            for i in range(lo, min(lo + per, len(stream))):
                t1 = time.perf_counter()
                replies[i] = server.submit(probe_q[stream[i]], k).result(timeout=timeout_s)
                lats[i] = time.perf_counter() - t1
        except Exception as e:  # noqa: BLE001 — re-raised by the caller below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c * per,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or any(r is None for r in replies):
        raise AssertionError(f"serve clients failed: {errors[:3]}")
    return wall, replies, lats


def served_recall(stream, replies, truth_np):
    """recall@k of every served row against the probe queries' truth."""
    hits = tot = 0
    for rows, rep in zip(stream, replies):
        for r, ids in zip(rows, rep.ids):
            t = truth_np[r]
            hits += len(set(ids.tolist()) & set(t.tolist()))
            tot += len(t)
    return hits / tot


def busy_share(run):
    """(wall s, device busy s, device activities) of one `run()` under
    torch.profiler: the union of the device's own activities (kernels,
    copies, sets) over the profiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return wall, busy_us / 1e6, len(spans)


def snap_line(snap):
    return (f"QPS {snap['qps']:.1f}, p50 {snap['latency_ms_p50']:.3f} ms, p99 "
            f"{snap['latency_ms_p99']:.3f} ms, occupancy {snap['batch_occupancy']:.4f}, "
            f"{snap['requests_per_batch']:.2f} requests a batch, {snap['batches']} batches")


def serve_flat_part(g, dev, S, inp, sync, spies):
    """Step 1: IVF-Flat pinned to engine "pallas" (kernel 1) at the smallest
    n_probes of the ladder whose recall@k on the probe queries reaches the
    gate; the unbatched baseline (every shape warmed), the server under
    the full stream (its snapshot, the wall req/s, the speedup), the SLO
    verdict and the device's idle share over the brief stream."""
    from raft_tpu_torch import serve
    from raft_tpu_torch.core.interruptible import synchronize
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import slo
    from raft_tpu_torch.ops import _launch

    idx, pq, truth = inp["flat_index"], inp["probe_q"], inp["probe_truth"]
    n_probes = None
    for p in S["flat_ladder"]:
        r = recall(ivf_flat.search(ivf_flat.SearchParams(n_probes=p, engine="pallas"), idx, pq,
                                   g.k)[1], truth)
        log(f"serve ivf_flat ladder: n_probes {p}, recall@{g.k} {r:.4f}")
        if r >= RECALL_GATE:
            n_probes = p
            break
    if n_probes is None:
        raise AssertionError(f"serve ivf_flat: no n_probes of {S['flat_ladder']} reaches "
                             f"recall@{g.k} >= {RECALL_GATE}")
    sp = ivf_flat.SearchParams(n_probes=n_probes, engine="pallas")
    out = {"n_probes": n_probes, "recall": r}
    rng = np.random.default_rng(g.seed + 71)
    stream = serve_stream(rng, S["probe_q"], S["clients"] * S["requests"])
    # the unbatched baseline: every request shape warmed, then one call at a time
    for n in sorted({len(rows) for rows in stream}):
        synchronize(*ivf_flat.search(sp, idx, pq[:n], g.k))
    lats = []
    t0 = time.perf_counter()
    for rows in stream[:S["baseline"]]:
        t1 = time.perf_counter()
        v, i = ivf_flat.search(sp, idx, pq[torch.as_tensor(rows, device=dev)], g.k)
        v.cpu(), i.cpu()
        lats.append(time.perf_counter() - t1)
    base_wall = time.perf_counter() - t0
    out["baseline"] = {"requests": S["baseline"], "req_s": S["baseline"] / base_wall,
                       "p50_ms": float(np.percentile(lats, 50)) * 1e3,
                       "p99_ms": float(np.percentile(lats, 99)) * 1e3}
    log(f"serve ivf_flat unbatched baseline: {S['baseline']} requests one call at a time, "
        f"{out['baseline']['req_s']:.1f} req/s, p50 {out['baseline']['p50_ms']:.3f} ms, p99 "
        f"{out['baseline']['p99_ms']:.3f} ms")
    pq_np = pq.cpu().numpy()
    cfg = serve.ServerConfig(buckets=S["buckets"], max_wait_ms=S["max_wait_ms"], warmup_k=g.k)
    with serve.SearchServer(idx, cfg, search_params=sp) as server:
        _launch.reset_launch_counts()
        with spies["flat"]:
            wall, replies, _ = drive(server, pq_np, stream, S["clients"], g.k)
        launches = _launch.launch_counts()
        snap = server.metrics.snapshot()
    out.update(server=snap, wall_req_s=len(stream) / wall,
               speedup=(len(stream) / wall) / out["baseline"]["req_s"], launches=launches,
               served_recall=served_recall(stream, replies, truth.cpu().numpy()),
               slo=slo.judge_serve(snap))
    log(f"serve ivf_flat pallas n_probes {n_probes}: {S['clients']} clients x "
        f"{S['requests']} requests, {snap_line(snap)}; wall {out['wall_req_s']:.1f} req/s, "
        f"{out['speedup']:.2f}x the unbatched baseline; served recall@{g.k} "
        f"{out['served_recall']:.4f}; slo {out['slo']}; launches {launches}")
    if min(rep.coverage for rep in replies) != 1.0 or snap["completed"] != len(stream):
        raise AssertionError("serve ivf_flat: a reply below coverage 1.0 or a lost request")
    if dev.type == "cuda" and launches["fused_list_topk"] <= 0:
        raise AssertionError(f"serve ivf_flat: kernel 1 never launched: {launches}")
    if dev.type == "cuda":
        brief = stream[:S["brief_clients"] * S["brief_requests"]]
        with serve.SearchServer(idx, cfg, search_params=sp) as server:
            wall_p, busy_s, n_act = busy_share(
                lambda: drive(server, pq_np, brief, S["brief_clients"], g.k))
        out["idle"] = {"wall_s": wall_p, "busy_s": busy_s, "activities": n_act,
                       "idle_share": 1.0 - busy_s / wall_p}
        log(f"serve ivf_flat idle share: {len(brief)} requests of {S['brief_clients']} clients "
            f"under torch.profiler: wall {wall_p:.4f} s, device busy {busy_s:.4f} s over "
            f"{n_act} device activities, idle share {out['idle']['idle_share']:.4f}")
    return out, sp


def pad_rows(q, bucket):
    return np.concatenate([q, np.zeros((bucket - q.shape[0], q.shape[1]), np.float32)])


def alone_in_bucket(server, q, bucket, k):
    """A request's reply alone in a batch of `bucket` rows, through the
    server's own path (host merge, one copy to the device, the search, the
    fence, one copy back)."""
    from raft_tpu_torch.serve import engine

    vals, ids, _ = server.searcher.search(server._to_device(pad_rows(q, bucket)), k)
    engine._fence(vals, ids)
    v, i = engine._to_host(vals, ids)
    return v[:q.shape[0]], i[:q.shape[0]]


def stage_diffs(index, q, bucket, n_probes):
    """Which query-side steps of an IVF-PQ / RaBitQ search change with the
    row count, the request's own M against its bucket's: the queries'
    squared norms, the rotation GEMM's rows, and the coarse select's
    probes (each from its own M's rotated rows)."""
    from raft_tpu_torch.neighbors import probe_budget

    dev = index.rotation.device
    qa = torch.as_tensor(q, device=dev)
    qb = torch.as_tensor(pad_rows(q, bucket), device=dev)
    ra, rb = qa @ index.rotation.T, (qb @ index.rotation.T)[:q.shape[0]]
    pa = probe_budget.coarse_select(ra, index.centers, index.metric, n_probes, pq_style=True)[1]
    pb = probe_budget.coarse_select(qb @ index.rotation.T, index.centers, index.metric,
                                    n_probes, pq_style=True)[1][:q.shape[0]]
    out = query_norms_differ(q, bucket, dev)
    out.update(rotation_rows_differ=not torch.equal(ra, rb), probes_differ=not torch.equal(pa, pb))
    return out


def query_norms_differ(q, bucket, dev):
    """Whether the queries' squared norms (a row sum an expanded L2 adds
    back) change with the row count: the request's own M against its
    bucket's."""
    qa = torch.as_tensor(q, device=dev)
    qb = torch.as_tensor(pad_rows(q, bucket), device=dev)
    return {"query_norms_differ": not torch.equal(torch.sum(qa * qa, dim=1),
                                                  torch.sum(qb * qb, dim=1)[:q.shape[0]])}


def within_ties(pv, pi, av, ai, tol):
    """Values within `tol` of each other, and ids equal but for their order
    within a group of values within `tol` (a group that reaches the row's
    end may hold other ids of that value)."""
    va, vb = pv.astype(np.float64), av.astype(np.float64)
    fin = np.isfinite(va)
    if not np.array_equal(fin, np.isfinite(vb)) or not np.array_equal(va[~fin], vb[~fin]):
        return False
    if (np.where(fin, np.abs(va - vb), 0) > tol).any():
        return False
    for r in np.nonzero((pi != ai).any(axis=1))[0]:
        for c in np.nonzero(pi[r] != ai[r])[0]:
            group = np.abs(va[r] - va[r, c]) <= tol
            if not group[-1] and set(pi[r][group]) != set(ai[r][group]):
                return False
    return True


def batch_mate_checks(g, server, S, pq_np, plain, diag, scale):
    """(a) each of the requests of S["mates"] rows in one mixed batch is
    bit for bit its reply alone in a batch of the same bucket; (b) that
    reply against the plain search of the request's own rows: bit for bit,
    else values within 1e-6 of `scale` (the squared norms an expanded L2
    cancels from) and ids equal outside ties at that tolerance, with the
    steps whose rows change with the row count (`diag`) named."""
    from raft_tpu_torch.serve import bucket_for

    rng = np.random.default_rng(g.seed + 73)
    reqs = [pq_np[rng.integers(0, len(pq_np), n)] for n in S["mates"]]
    futs = [server.submit(q, g.k) for q in reqs]
    while not all(f.done() for f in futs):
        if server.step() == 0:
            break
    mixed = [f.result(timeout=60.0) for f in futs]
    bucket = bucket_for(sum(S["mates"]), S["buckets"])
    tol = 1e-6 * scale
    out = {"bucket": bucket, "a": True, "b": [], "b_within": True, "tol": tol}
    for q, m in zip(reqs, mixed):
        av, ai = alone_in_bucket(server, q, bucket, g.k)
        if not (np.array_equal(m.values.view(np.int32), av.view(np.int32))
                and np.array_equal(m.ids, ai)):
            out["a"] = False
        pv, pi = plain(q)
        bit = bool(np.array_equal(pv.view(np.int32), av.view(np.int32))
                   and np.array_equal(pi, ai))
        fin = np.isfinite(pv) & np.isfinite(av)
        rec = {"rows": len(q), "bit": bit, "within": bit or within_ties(pv, pi, av, ai, tol),
               "max_abs": float(np.abs(pv[fin] - av[fin]).max()) if fin.any() else 0.0,
               "ids_differ": int((pi != ai).sum())}
        if not bit and diag is not None:
            rec.update(diag(q, bucket))
        out["b"].append(rec)
        out["b_within"] &= rec["within"]
    return out


def serve_searchers_part(g, dev, S, inp, sync, spies):
    """Step 2: every searcher under the brief stream — brute force (kernel
    2), IVF-PQ recon8_list with the trims fused bf16 (kernel 1), fused int8
    (3) and pallas (4), IVF-RaBitQ (7): QPS, p99, recall@k, launches, and
    the batch-mate checks (a) and (b)."""
    from raft_tpu_torch import serve
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, ivf_rabitq
    from raft_tpu_torch.ops import _launch

    pq, truth = inp["probe_q"], inp["probe_truth"]
    pq_np, truth_np = pq.cpu().numpy(), truth.cpu().numpy()
    gate = inp["rb_gate"]

    def pq_params(trim, dtype):
        return ivf_pq.SearchParams(n_probes=S["pq_probes"], score_mode="recon8_list",
                                   trim_engine=trim, score_dtype=dtype)

    def host(vi):
        return vi[0].cpu().numpy(), vi[1].cpu().numpy()

    rb_sp = ivf_rabitq.SearchParams(n_probes=gate["n_probes"], rerank_mult=gate["rerank_mult"],
                                    scan_engine="fused")
    scale = float((inp["dataset"] ** 2).sum(1).max() + (pq ** 2).sum(1).max())

    def pq_diag(q, bucket):
        return stage_diffs(inp["index"], q, bucket, S["pq_probes"])

    cases = {
        "brute_force fused": (lambda: serve.BruteForceSearcher(inp["dataset"], engine="fused"),
                              ("fused_topk",), "bf",
                              lambda q: host(brute_force.knn(inp["dataset"], q, g.k,
                                                             engine="fused", device=dev)),
                              lambda q, b: query_norms_differ(q, b, dev)),
        "ivf_pq fused bf16": (lambda: serve.IvfPqSearcher(inp["index"], pq_params("fused", "bf16")),
                              ("fused_list_topk",), "pq_bf16",
                              lambda q: host(ivf_pq.search(pq_params("fused", "bf16"),
                                                           inp["index"], q, g.k)),
                              pq_diag),
        "ivf_pq fused int8": (lambda: serve.IvfPqSearcher(inp["index"], pq_params("fused", "int8")),
                              ("fused_list_topk_int8",), "pq_int8",
                              lambda q: host(ivf_pq.search(pq_params("fused", "int8"),
                                                           inp["index"], q, g.k)),
                              pq_diag),
        "ivf_pq pallas bf16": (lambda: serve.IvfPqSearcher(inp["index"],
                                                            pq_params("pallas", "bf16")),
                               ("pq_list_scan",), "pq_pallas",
                               lambda q: host(ivf_pq.search(pq_params("pallas", "bf16"),
                                                            inp["index"], q, g.k)),
                               pq_diag),
        "ivf_rabitq fused": (lambda: serve.IvfRabitqSearcher(inp["rb_index"], rb_sp),
                             ("fused_bitplane_topk",), "rabitq",
                             lambda q: host(ivf_rabitq.search(rb_sp, inp["rb_index"], q, g.k)),
                             lambda q, b: stage_diffs(inp["rb_index"], q, b, gate["n_probes"])),
    }
    rng = np.random.default_rng(g.seed + 72)
    stream = serve_stream(rng, S["probe_q"], S["brief_clients"] * S["brief_requests"])
    cfg = serve.ServerConfig(buckets=S["buckets"], max_wait_ms=S["max_wait_ms"], warmup_k=g.k)
    out, select_total = {}, 0
    for name, (make, kernels, spy, plain, diag) in cases.items():
        searcher = make()
        with serve.SearchServer(searcher, cfg) as server:
            _launch.reset_launch_counts()
            with spies[spy], spies["select"]:
                wall, replies, _ = drive(server, pq_np, stream, S["brief_clients"], g.k)
            launches = _launch.launch_counts()
            snap = server.metrics.snapshot()
        mates = batch_mate_checks(g, serve.SearchServer(searcher, serve.ServerConfig(
            buckets=S["buckets"], max_wait_ms=S["max_wait_ms"])), S, pq_np, plain, diag, scale)
        rec = served_recall(stream, replies, truth_np)
        select_total += launches["counting_select_min"]
        out[name] = {"server": snap, "recall": rec, "launches": launches, "mates": mates}
        log(f"serve {name}: {len(stream)} requests of {S['brief_clients']} clients, "
            f"{snap_line(snap)}, recall@{g.k} {rec:.4f}, launches "
            f"{ {kk: launches[kk] for kk in kernels + ('counting_select_min',)} }")
        log(f"serve {name} batch mates: (a) mixed == alone in bucket {mates['bucket']}: "
            f"{mates['a']}; (b) alone against the plain search of the request's rows "
            f"(tolerance {mates['tol']:.6g}): " + "; ".join(
                f"{b['rows']} rows bit {b['bit']} within {b['within']} max_abs "
                f"{b['max_abs']:.6g} ids_differ {b['ids_differ']}"
                + "".join(f" {key} {b[key]}" for key in (
                    "query_norms_differ", "rotation_rows_differ", "probes_differ") if key in b)
                for b in mates["b"]))
        if not mates["a"]:
            raise AssertionError(f"serve {name}: a batch-mate changed a reply")
        if not mates["b_within"]:
            raise AssertionError(f"serve {name}: a reply differs from the plain search beyond "
                                 f"ties and {mates['tol']}")
        if dev.type == "cuda" and min(launches[kk] for kk in kernels) <= 0:
            raise AssertionError(f"serve {name}: kernels never launched: {launches}")
    out["counting_select_min"] = select_total
    if dev.type == "cuda" and select_total <= 0:
        raise AssertionError("serve searchers: kernel 6 never launched")
    return out


def serve_overload_part(g, dev, S, inp, sp, sync):
    """Step 3: a 4x burst of clients, each submitting its requests in
    bursts of S["burst_size"] without waiting, then waiting for the burst,
    against an admission that sheds (a S["queue_rows"]-row queue, policy
    "reject", a S["deadline_s"] default deadline, degrading past half
    full), on IVF-Flat "pallas" at S["overload_probes"] probes (so a
    degraded batch scans fewer): rejects, expiries, degraded batches, the
    smallest probe_scale, p99 against the deadline, and the recall at
    that scale."""
    import dataclasses

    from raft_tpu_torch import serve

    pq, truth = inp["probe_q"], inp["probe_truth"]
    pq_np = pq.cpu().numpy()
    scales = []

    class ScaleSpy(serve.IvfFlatSearcher):
        def search(self, queries, k, probe_scale=1.0, recall_target=None):
            scales.append(float(probe_scale))
            return super().search(queries, k, probe_scale, recall_target)

    sp = dataclasses.replace(sp, n_probes=max(sp.n_probes, S["overload_probes"]))
    searcher = ScaleSpy(inp["flat_index"], sp)
    adm = serve.AdmissionConfig(max_pending_rows=S["queue_rows"], policy="reject",
                                default_deadline_s=S["deadline_s"], degrade_at=0.5,
                                min_probe_scale=0.25)
    cfg = serve.ServerConfig(buckets=S["buckets"], max_wait_ms=S["max_wait_ms"], admission=adm,
                             warmup_k=g.k)
    clients = S["burst"] * S["clients"]
    rng = np.random.default_rng(g.seed + 74)
    stream = serve_stream(rng, S["probe_q"], clients * S["burst_requests"])
    counts = {"rejected": 0, "expired": 0, "served": 0}
    lock = threading.Lock()

    def client(lo):
        rej = exp = ok = 0
        for b0 in range(lo, lo + S["burst_requests"], S["burst_size"]):
            futs = []
            for i in range(b0, min(b0 + S["burst_size"], lo + S["burst_requests"])):
                try:
                    futs.append(server.submit(pq_np[stream[i]], g.k))
                except serve.RejectedError:
                    rej += 1
            for f in futs:
                try:
                    rep = f.result(timeout=120.0)
                    ok += rep.coverage == 1.0
                except serve.DeadlineExceeded:
                    exp += 1
        with lock:
            counts["rejected"] += rej
            counts["expired"] += exp
            counts["served"] += ok

    with serve.SearchServer(searcher, cfg) as server:
        scales.clear()  # the warmup's searches run at full scale
        threads = [threading.Thread(target=client, args=(c * S["burst_requests"],))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300.0)
        snap = server.metrics.snapshot()
    if any(t.is_alive() for t in threads):
        raise AssertionError("serve overload: a client never finished")
    min_scale = min(scales) if scales else 1.0
    deg = sum(s < 1.0 for s in scales)
    dv = searcher.search(pq, g.k, probe_scale=min_scale)
    deg_recall = recall(dv[1], truth)
    out = {"clients": clients, "requests": len(stream), **counts, "server": snap,
           "degraded_batches": deg, "batches": len(scales), "min_probe_scale": min_scale,
           "degraded_n_probes": max(1, int(sp.n_probes * min_scale)),
           "degraded_recall": deg_recall}
    log(f"serve overload: {clients} clients x {S['burst_requests']} requests in bursts of "
        f"{S['burst_size']}, IVF-Flat n_probes {sp.n_probes}, queue "
        f"{S['queue_rows']} rows, deadline {S['deadline_s']} s: rejected {counts['rejected']}, "
        f"expired {counts['expired']}, served {counts['served']}; degraded {deg} of "
        f"{len(scales)} batches, smallest probe_scale {min_scale:.4f} (n_probes "
        f"{out['degraded_n_probes']} of {sp.n_probes}, recall@{g.k} {deg_recall:.4f}); "
        f"{snap_line(snap)}")
    if counts["rejected"] + counts["expired"] + counts["served"] != len(stream):
        raise AssertionError(f"serve overload: requests unaccounted for: {counts}")
    if snap["completed"] and snap["latency_ms_p99"] > S["deadline_s"] * 1e3:
        raise AssertionError(f"serve overload: p99 {snap['latency_ms_p99']} ms past the "
                             f"{S['deadline_s']} s deadline")
    if counts["rejected"] == 0 and deg == 0:
        raise AssertionError("serve overload: the burst neither shed nor degraded")
    return out


def serve_live_part(g, dev, S, inp, sp, sync):
    """Step 4: IVF-Flat served with a MutationFeed; a delete of
    S["delete_frac"] of the ids and an upsert of S["upsert_rows"] rows
    published during traffic: coverage 1.0, the queries the mutation does
    not touch bit for bit before and after the swap, no deleted id back.
    Then an IntegrityWatchdog over a checkpointed copy: p99 with and
    without the scrub, a rotted list quarantined (degraded coverage) and
    repaired from the checkpoint (answers bit for bit the pre-rot ones)."""
    import shutil

    from raft_tpu_torch import integrity, serve
    from raft_tpu_torch.integrity import scrub
    from raft_tpu_torch.neighbors import mutation

    idx, pq = inp["flat_index"], inp["probe_q"]
    pq_np = pq.cpu().numpy()
    n = idx.size
    rng = np.random.default_rng(g.seed + 75)
    deleted = rng.choice(n, int(n * S["delete_frac"]), replace=False).astype(np.int64)
    src = inp["data_np"][rng.integers(0, n, S["upsert_rows"])]
    new_rows = (src + 0.5 * rng.standard_normal(src.shape)).astype(np.float32)
    new_ids = np.arange(idx.id_bound, idx.id_bound + S["upsert_rows"])
    cfg = serve.ServerConfig(buckets=S["buckets"], max_wait_ms=S["max_wait_ms"], warmup_k=g.k)
    server = serve.SearchServer(idx, cfg, search_params=sp)
    feed = mutation.MutationFeed()
    server.attach_mutations(feed)
    pre = server.search(pq_np, g.k, timeout=60.0)  # step mode, before the worker starts
    own = inp["data_np"][deleted[:S["probe_q"]]]
    pre_own = server.search(own, 1, timeout=60.0)
    stream = serve_stream(np.random.default_rng(g.seed + 76), S["probe_q"],
                          S["brief_clients"] * S["brief_requests"])
    server.start()
    try:
        done = threading.Event()

        def publish():
            time.sleep(0.05)
            feed.publish(("delete", deleted))
            feed.publish(("upsert", new_rows, new_ids))
            done.set()

        pub = threading.Thread(target=publish)
        t0 = time.perf_counter()
        pub.start()
        _, replies, _ = drive(server, pq_np, stream, S["brief_clients"], g.k)
        pub.join(60.0)
        deadline = time.monotonic() + 120.0
        while server.searcher.index is idx and time.monotonic() < deadline:
            server.search(pq_np[:1], g.k, timeout=60.0)  # a batch: the drain runs after it
        swap_s = time.perf_counter() - t0
        post = server.search(pq_np, g.k, timeout=60.0)
        post_own = server.search(own, 1, timeout=60.0)
        snap = server.metrics.snapshot()
    finally:
        server.stop()
    if not done.is_set() or server.searcher.index is idx:
        raise AssertionError("serve live: the mutation batches never swapped in")
    touched = np.concatenate([deleted, new_ids])
    untouched = ~np.isin(pre.ids, touched).any(1) & ~np.isin(post.ids, new_ids).any(1)
    same = bool(np.array_equal(pre.values[untouched].view(np.int32),
                               post.values[untouched].view(np.int32))
                and np.array_equal(pre.ids[untouched], post.ids[untouched]))
    back = int(np.isin(post.ids, deleted).sum() + np.isin(post_own.ids, deleted).sum())
    cov = min([r.coverage for r in replies] + [pre.coverage, post.coverage])
    out = {"deleted": int(len(deleted)), "upserted": int(len(new_ids)), "swap_s": swap_s,
           "coverage_min": cov, "untouched": int(untouched.sum()), "untouched_equal": same,
           "deleted_back": back,
           "pre_own_self": float(np.mean(pre_own.ids[:, 0] == deleted[:len(own)])),
           "server": snap}
    log(f"serve live: delete {len(deleted)} ids + upsert {len(new_ids)} rows published during "
        f"{len(stream)} requests; swapped in {swap_s:.3f} s after publishing; coverage min "
        f"{cov}; {int(untouched.sum())} of {len(pq_np)} probe queries untouched, bit for bit "
        f"before and after: {same}; deleted ids back: {back} (before the delete "
        f"{out['pre_own_self']:.4f} of the deleted rows found themselves); {snap_line(snap)}")
    if cov != 1.0 or not same or back or untouched.sum() < len(pq_np) // 2:
        raise AssertionError(f"serve live: {out}")
    live = server.searcher.index
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        t0 = time.perf_counter()
        mut = mutation.Mutator(tmp, live, kind="ivf_flat")
        mut.delete(np.asarray([int(new_ids[0])]))  # a commit to restore from
        served = mut.commit()
        ckpt_s = time.perf_counter() - t0
        p99 = {}
        for label, wd in (("without scrub", None),
                          ("with scrub", integrity.IntegrityWatchdog(
                              "ivf_flat", budget_lists=S["scrub_budget"]))):
            s = serve.SearchServer(served, cfg, search_params=sp)
            if wd is not None:
                s.attach_integrity(wd)
            with s:
                drive(s, pq_np, stream, S["brief_clients"], g.k)
                p99[label] = s.metrics.snapshot()["latency_ms_p99"]
        log(f"serve scrub: p99 {p99['without scrub']:.3f} ms without the watchdog, "
            f"{p99['with scrub']:.3f} ms with one {S['scrub_budget']}-list slice between "
            f"batches (the checkpoint of the live index: {ckpt_s:.3f} s)")
        wd = integrity.IntegrityWatchdog("ivf_flat", budget_lists=S["scrub_budget"])
        s = serve.SearchServer(served, cfg, search_params=sp)
        s.attach_integrity(wd)
        before = s.search(pq_np, g.k, timeout=60.0)
        lid = (wd.scrubber.cursor + S["scrub_budget"]) % served.n_lists
        scrub.rot_list(served, lid, "list_data", frac=1.0, seed=g.seed)
        ticks = 0
        while not wd.quarantined and ticks < served.n_lists // S["scrub_budget"] + 4:
            s.search(pq_np[:1], g.k, timeout=60.0)
            ticks += 1
        mid = s.search(pq_np, g.k, timeout=60.0)
        quarantined = sorted(wd.quarantined)
        wd.repair = integrity.checkpoint_repairer(tmp)
        t0 = time.perf_counter()
        s.search(pq_np[:1], g.k, timeout=60.0)  # the tick that repairs
        repair_s = time.perf_counter() - t0
        after = s.search(pq_np, g.k, timeout=60.0)
        s.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    healed = bool(np.array_equal(before.values.view(np.int32), after.values.view(np.int32))
                  and np.array_equal(before.ids, after.ids))
    out["integrity"] = {"p99_ms": p99, "rotted_list": int(lid), "ticks": ticks,
                        "quarantined": quarantined, "mid_coverage": mid.coverage,
                        "repairs": wd.repairs, "repair_batch_s": repair_s,
                        "after_coverage": after.coverage, "healed_equal": healed}
    log(f"serve integrity: list {lid} rotted, quarantined after {ticks} batches "
        f"({quarantined}), coverage {mid.coverage:.6f} then {after.coverage} after "
        f"{wd.repairs} repair ({repair_s:.3f} s batch + repair); answers after the repair bit "
        f"for bit the pre-rot ones: {healed}")
    if (quarantined != [lid] or mid.coverage >= 1.0 or after.coverage != 1.0 or not healed
            or wd.repairs != 1 or wd.quarantined):
        raise AssertionError(f"serve integrity: {out['integrity']}")
    return out


def serve_mnmg_part(g, dev, S, inp, sync):
    """Step 5: MnmgSearcher over a distributed IVF-PQ (replication 2) built
    on S["mnmg_rows"] rows on 4 ranks of the card: a degraded mask answers
    bit for bit the healthy answer at coverage 1.0; rank 1 marked down
    during traffic keeps every reply at 1.0, and the heal runs between
    batches (its seconds)."""
    from raft_tpu_torch import serve
    from raft_tpu_torch.comms import Comms, mnmg
    from raft_tpu_torch.comms.resilience import RankHealth
    from raft_tpu_torch.neighbors import ivf_pq

    pq_np = inp["probe_q"].cpu().numpy()
    c4 = Comms(n_devices=4, device=dev)
    try:
        t0 = time.perf_counter()
        dindex = mnmg.ivf_pq_build(c4, ivf_pq.IndexParams(
            n_lists=g.n_lists, pq_dim=g.dim // 2, kmeans_n_iters=10),
            inp["dataset"][:S["mnmg_rows"]], seed=g.seed, replication=2)
        sync()
        build_s = time.perf_counter() - t0
        cfg = serve.ServerConfig(buckets=S["buckets"], max_wait_ms=S["max_wait_ms"],
                                 warmup_k=g.k)
        healthy = serve.SearchServer(dindex, cfg, n_probes=S["mnmg_probes"])
        want = healthy.search(pq_np, g.k, timeout=120.0)
        degraded = serve.SearchServer(dindex, cfg, n_probes=S["mnmg_probes"],
                                      health=RankHealth.all_healthy(4).mark_unhealthy(1),
                                      auto_heal=False)
        got = degraded.search(pq_np, g.k, timeout=120.0)
        failover_equal = bool(got.coverage == 1.0 and np.array_equal(
            got.values.view(np.int32), want.values.view(np.int32))
            and np.array_equal(got.ids, want.ids))
        server = serve.SearchServer(dindex, cfg, n_probes=S["mnmg_probes"])
        heals = []
        inner = server.searcher.maybe_heal

        def timed_heal():
            t1 = time.perf_counter()
            ran = inner()
            if ran:
                heals.append(time.perf_counter() - t1)
            return ran

        server.searcher.maybe_heal = timed_heal
        stream = serve_stream(np.random.default_rng(g.seed + 77), S["probe_q"],
                              S["brief_clients"] * S["brief_requests"])

        def mark_down():
            time.sleep(0.05)
            server.set_health(RankHealth.all_healthy(4).mark_unhealthy(1))

        with server:
            marker = threading.Thread(target=mark_down)
            marker.start()
            wall, replies, _ = drive(server, pq_np, stream, S["brief_clients"], g.k)
            marker.join(60.0)
            deadline = time.monotonic() + 120.0
            while not heals and time.monotonic() < deadline:
                server.search(pq_np[:1], g.k, timeout=120.0)
            after = server.search(pq_np, g.k, timeout=120.0)
            snap = server.metrics.snapshot()
        cov = min(r.coverage for r in replies)
        after_equal = bool(np.array_equal(after.ids, want.ids) and np.array_equal(
            after.values.view(np.int32), want.values.view(np.int32)))
        out = {"rows": S["mnmg_rows"], "build_s": build_s, "failover_equal": failover_equal,
               "coverage_min": cov, "heal_s": heals, "healthy_after": after_equal,
               "health_after": server.searcher.health.coverage(), "server": snap}
        log(f"serve mnmg ivf_pq: {S['mnmg_rows']} rows, replication 2, 4 ranks, built in "
            f"{build_s:.3f} s; degraded mask (rank 1 down) bit for bit the healthy answer at "
            f"coverage 1.0: {failover_equal}; rank 1 down during {len(stream)} requests: "
            f"coverage min {cov}, heal between batches in "
            f"{', '.join(f'{h:.3f}' for h in heals)} s, mask coverage after "
            f"{out['health_after']}, answers after the heal bit for bit: {after_equal}; "
            f"{snap_line(snap)}")
        if not failover_equal or cov != 1.0 or not heals or not after_equal:
            raise AssertionError(f"serve mnmg: {out}")
    finally:
        c4.destroy()
    return out


def serve_obs_part(g, dev, S, inp, sp, sync):
    """Step 6: obs on, one client's sequential requests with request traces
    (mint order is request order): each trace's stages sum to within its
    measured latency; the Prometheus text has the server's serve# section."""
    from raft_tpu_torch import obs, serve
    from raft_tpu_torch.obs.export import prom_name

    pq_np = inp["probe_q"].cpu().numpy()
    stream = serve_stream(np.random.default_rng(g.seed + 78), S["probe_q"], S["obs_requests"])
    obs.reset()
    obs.trace.reset(seed=0)
    obs.enable()
    try:
        cfg = serve.ServerConfig(buckets=S["buckets"], max_wait_ms=S["max_wait_ms"],
                                 warmup_k=g.k)
        with serve.SearchServer(inp["flat_index"], cfg, search_params=sp) as server:
            _, _, lats = drive(server, pq_np, stream, 1, g.k)
            text = obs.render_registry_prometheus()
            name = next((k for k in obs.snapshot()["metrics"].get("collectors", {})
                         if k.startswith("serve#")), None)
        traces = [e for e in obs.snapshot()["events"] if e["kind"] == "trace"]
    finally:
        obs.disable()
        obs.reset()
    sums = [sum(e["marks"][b] - e["marks"][a]
                for a, b in zip(obs.trace.STAGES, obs.trace.STAGES[1:])) for e in traces]
    within = len(traces) == len(stream) and all(s <= lat for s, lat in zip(sums, lats))
    prom = name is not None and prom_name(f"{name}.completed") in text
    out = {"traces": len(traces), "within": within,
           "stage_share": float(np.mean([s / lat for s, lat in zip(sums, lats)])),
           "prometheus_section": prom}
    log(f"serve obs: {len(traces)} traces of {len(stream)} sequential requests, every stage "
        f"sum within its measured latency: {within} (mean share {out['stage_share']:.4f}); "
        f"the Prometheus text carries the {name} section: {prom}")
    if not within or not prom:
        raise AssertionError(f"serve obs: {out}")
    return out


def serve_path(g, dev, sync, inp):
    """Phase 4i: the serving layer (raft_tpu_torch.serve) under the
    committed table at k 10 on phase 4's 1M x 96 indexes (or its rehearsal
    size), with bench/bench_serve.py's traffic (SERVE):
      1. IVF-Flat pinned to engine "pallas" (kernel 1) at the smallest
         n_probes whose recall@k on the probe queries clears the gate:
         the server's snapshot, wall req/s, the unbatched baseline, the
         speedup, the SLO verdict, the device's idle share;
      2. every searcher under the brief stream (brute force fused, IVF-PQ
         recon8_list fused bf16 / fused int8 / pallas, IVF-RaBitQ fused):
         QPS, p99, recall, kernels 2, 1, 3, 4, 7 and 6 launched, and the
         batch-mate checks (a) bit for bit and (b);
      3. an overload burst against a shedding admission;
      4. a live index (MutationFeed) and an IntegrityWatchdog's
         quarantine and repair, p99 with and without the scrub;
      5. MnmgSearcher failover and heal on 4 ranks;
      6. request traces and the Prometheus section with obs on.
    Returns (summary, kernel rows at this path's shapes)."""
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import fused_scan as fs
    from raft_tpu_torch.ops import pq_list_scan as pls
    from raft_tpu_torch.ops import select_counting as sc

    S = SERVE_REHEARSE if g.rehearse else SERVE
    t_phase = time.perf_counter()
    rng = np.random.default_rng(g.seed + 70)
    rows = rng.integers(0, inp["data_np"].shape[0], S["probe_q"])
    probe_np = (inp["data_np"][rows] + S["noise"] * rng.standard_normal(
        (S["probe_q"], inp["data_np"].shape[1]))).astype(np.float32)
    inp = dict(inp, probe_q=torch.from_numpy(probe_np).to(dev))
    with committed(dev):
        inp["probe_truth"] = brute_force.knn(inp["dataset"], inp["probe_q"], g.k,
                                             engine="fused", device=dev)[1]
        spies = {"flat": FirstCall(fs, "fused_list_topk"), "pq_bf16": FirstCall(fs, "fused_list_topk"),
                 "pq_int8": FirstCall(fs, "fused_list_topk_int8"),
                 "pq_pallas": FirstCall(pls, "pq_list_scan"), "rabitq": FirstCall(fs, "fused_bitplane_topk"),
                 "bf": FirstCall(fs, "fused_topk"), "select": SelectCalls(sc, "counting_select_min")}
        out = {}
        out["ivf_flat"], sp = serve_flat_part(g, dev, S, inp, sync, spies)
        out["searchers"] = serve_searchers_part(g, dev, S, inp, sync, spies)
        out["overload"] = serve_overload_part(g, dev, S, inp, sp, sync)
        out["live"] = serve_live_part(g, dev, S, inp, sp, sync)
        out["mnmg"] = serve_mnmg_part(g, dev, S, inp, sync)
        out["obs"] = serve_obs_part(g, dev, S, inp, sp, sync)
    krows = []
    if dev.type == "cuda":
        fl, se = out["ivf_flat"], out["searchers"]
        krows.append(list_kernel_row(fs, spies["flat"].calls[0], fl["launches"]["fused_list_topk"],
                                     g.reps, f"serve IVF-Flat pallas, n_probes {fl['n_probes']}, "
                                     "a served batch", term_scale=True))
        krows.append(flat_kernel_row(fs, spies["bf"].calls[0],
                                     se["brute_force fused"]["launches"]["fused_topk"], g.reps,
                                     label="serve brute force fused, a served batch"))
        krows.append(list_kernel_row(fs, spies["pq_bf16"].calls[0],
                                     se["ivf_pq fused bf16"]["launches"]["fused_list_topk"],
                                     g.reps, f"serve IVF-PQ trim, n_probes {S['pq_probes']}, a "
                                     "served batch"))
        krows.append(int8_list_row(fs, spies["pq_int8"].calls[0],
                                   se["ivf_pq fused int8"]["launches"]["fused_list_topk_int8"],
                                   g.reps, f"serve IVF-PQ int8 trim, n_probes {S['pq_probes']}, a "
                                   "served batch"))
        krows.append(fold_kernel_row(pls, spies["pq_pallas"].calls[0],
                                     se["ivf_pq pallas bf16"]["launches"]["pq_list_scan"], g.reps,
                                     f"serve IVF-PQ bin trim, exact fold, n_probes "
                                     f"{S['pq_probes']}, a served batch", "exact"))
        krows.append(bitplane_row(fs, spies["rabitq"].calls[0],
                                  se["ivf_rabitq fused"]["launches"]["fused_bitplane_topk"], g.reps,
                                  "serve rabitq, a served batch"))
        sel = spies["select"]
        if sel.last is not None:
            krows.append(counting_tile_row(sel.last[0], sel.last[1], se["counting_select_min"],
                                           g.reps, "serve, a searcher's last select"))
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"serve path complete in {out['wall_s']:.3f} s, {len(krows)} kernel rows")
    return out, krows


# ---------------------------------------------------------------------------
# phase 4j: the jobs layer
# ---------------------------------------------------------------------------

#: phase 4j: the dataset written in 8 chunks and streamed in 8 batches (1M
#: rows: 125,000 each); the SIGKILL lands after the third commit of a
#: stream, of make_data and of a scrub (slices of 128 lists); the watchdog
#: drill's stall timeout and injected stall; the children's deadline
JOBS = dict(chunks=8, batches=8, kill_at=3, scrub_budget=128, stall_timeout_s=1.0,
            stall_s=4.0, child_deadline_s=600.0, preempt_rc=75)
JOBS_REHEARSE = dict(JOBS, scrub_budget=8)
#: the streamed families and their trained-seed (empty table) params
JOB_KINDS = ("ivf_pq", "ivf_flat", "ivf_rabitq")


def job_params(g, kind):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, ivf_rabitq

    if kind == "ivf_pq":
        return ivf_pq.IndexParams(n_lists=g.n_lists, pq_dim=g.dim // 2, kmeans_n_iters=10,
                                  add_data_on_build=False)
    if kind == "ivf_flat":
        return ivf_flat.IndexParams(n_lists=g.n_lists, kmeans_n_iters=10,
                                    add_data_on_build=False)
    return ivf_rabitq.IndexParams(n_lists=g.n_lists, kmeans_n_iters=10, add_data_on_build=False)


def job_module(kind):
    return importlib.import_module(f"raft_tpu_torch.neighbors.{kind}")


class SaveClock:
    """Times every `save` of an index module (the streams' checkpoints):
    seconds and bytes of each."""

    def __init__(self, mod):
        self.mod, self.orig = mod, mod.save
        self.seconds, self.nbytes = [], []

    def __call__(self, filename, index):
        t0 = time.perf_counter()
        self.orig(filename, index)
        self.seconds.append(time.perf_counter() - t0)
        self.nbytes.append(os.path.getsize(filename))

    def __enter__(self):
        self.mod.save = self
        return self

    def __exit__(self, *exc):
        self.mod.save = self.orig


def build_job(g, dev, root, kinds=JOB_KINDS, timings=None):
    """The build job of phase 4j over JobDir `root`: `make_data` (the main
    path's rows written by `resumable_write_npy` in J["chunks"] chunks),
    then for each kind its `train` (the trained empty index; IVF-PQ's stage
    is named `train`, the others `train_<kind>`) and `stream`
    (`resumable_extend_from_file` in J["batches"] batches, the index saved
    as the stage's artifact). The same declaration in the parent and in
    its children gives the same fingerprints (`kinds=()`: make_data
    alone). `timings` collects each stage's seconds and stream stats."""
    from raft_tpu_torch import jobs

    J = JOBS_REHEARSE if g.rehearse else JOBS
    job = jobs.Job("chip_smoke_build", root)
    timings = {} if timings is None else timings
    chunk = -(-g.n // J["chunks"])
    geometry = {"rows": g.n, "dim": g.dim, "seed": g.seed, "blobs": g.n_lists}

    def timed(name, fn):
        def stage(ctx):
            t0 = time.perf_counter()
            meta = fn(ctx)
            timings.setdefault(name, {})["s"] = time.perf_counter() - t0
            return meta
        return stage

    def make_data(ctx):
        data = make_blobs(g.seed, g.n, g.dim, g.nq, g.n_lists)[0]
        path = ctx.artifact_path("data.npy")
        jobs.resumable_write_npy(path, g.n, g.dim, chunk, lambda lo, hi: data[lo:hi], ctx=ctx)
        return {"_artifacts": {"data": path}, "rows": g.n}

    def data_path(ctx):
        return ctx.dep_artifact("make_data", "data.npy")

    def train(kind):
        def fn(ctx):
            x = torch.from_numpy(np.load(data_path(ctx))).to(dev)
            idx = job_module(kind).build(job_params(g, kind), x, seed=g.seed, device=dev)
            job_module(kind).save(ctx.artifact_path(), idx)
            return {"n_lists": int(idx.n_lists)}
        return fn

    def stream(kind, train_stage):
        def fn(ctx):
            mod = job_module(kind)
            seed_index = mod.load(ctx.dep_artifact(train_stage), device=dev)
            ext = []
            with SaveClock(mod) as clock:
                index, stats = jobs.resumable_extend_from_file(
                    kind, seed_index, data_path(ctx), chunk, ctx=ctx, checkpoint_every=1,
                    on_batch=lambda b, rows, s: ext.append((rows, s)))
            mod.save(ctx.artifact_path(), index)
            timings.setdefault(f"stream {kind}", {}).update(
                extend_rows=sum(r for r, _ in ext), extend_s=sum(s for _, s in ext),
                ckpt_s=sum(clock.seconds), ckpt_bytes=sum(clock.nbytes), stats=stats)
            return stats
        return fn

    job.add_stage("make_data", timed("make_data", make_data), inputs=geometry)
    for kind in kinds:
        tname = "train" if kind == "ivf_pq" else f"train_{kind}"
        sname = "stream" if kind == "ivf_pq" else f"stream_{kind}"
        job.add_stage(tname, timed(tname, train(kind)), deps=("make_data",),
                      inputs={"kind": kind, "n_lists": g.n_lists})
        job.add_stage(sname, timed(sname, stream(kind, tname)), deps=(tname,),
                      inputs={"kind": kind, "batches": J["batches"]})
    return job


def preempt_job(root, dev, notice):
    """Three stages of device work; with `notice` the second sends this
    process a SIGTERM (the preemption notice) before its work."""
    from raft_tpu_torch import jobs

    job = jobs.Job("chip_smoke_preempt", root)

    def work(ctx):
        x = torch.randn((512, 512), device=dev)
        return {"sum": float((x @ x).sum().item())}

    def noticed(ctx):
        if notice:
            os.kill(os.getpid(), signal.SIGTERM)
        return work(ctx)

    job.add_stage("s1", work)
    job.add_stage("s2", noticed, deps=("s1",))
    job.add_stage("s3", work, deps=("s2",))
    return job


def mnmg_build_fn(g, dev, c4, rows):
    from raft_tpu_torch.comms import mnmg
    from raft_tpu_torch.neighbors import ivf_pq

    def build():
        x = torch.from_numpy(make_blobs(g.seed, g.n, g.dim, g.nq, g.n_lists)[0][:rows]).to(dev)
        return mnmg.ivf_pq_build(c4, ivf_pq.IndexParams(n_lists=g.n_lists, pq_dim=g.dim // 2,
                                                        kmeans_n_iters=10), x, seed=g.seed)
    return build


def jobs_child(g):
    """A child of phase 4j (`--jobs-child MODE --child-dir D`): under a
    kill_rank plan at the J["kill_at"]-th visit of the mode's crash site
    (`--child-kill`), runs the stream stage of the build job (`stream`:
    make_data and train skip, their commits linked in), the make_data
    stage alone (`data`), a scrub of the parent's streamed IVF-PQ index
    (`scrub`) or a checkpointed distributed build (`mnmg`); or the
    preemption job, which suspends at its own SIGTERM (`preempt`, exit
    J["preempt_rc"]). A SIGKILL at the crash site is the expected end of
    the killed modes."""
    from raft_tpu_torch import jobs
    from raft_tpu_torch.core import faults

    J = JOBS_REHEARSE if g.rehearse else JOBS
    dev = torch.device("cpu") if g.rehearse else torch.device("cuda", 0)
    mode, d = g.jobs_child, g.child_dir
    site = "integrity.scrub.crash" if mode == "scrub" else "job.stage.crash"
    plan = faults.FaultPlan([faults.Fault(kind="kill_rank", site=site, count=g.child_kill)],
                            seed=g.seed) if g.child_kill else None
    cm = plan.install() if plan is not None else contextlib.nullcontext()
    log(f"jobs child {mode}: pid {os.getpid()}, kill at visit {g.child_kill} of {site}")
    with committed(dev), cm:
        if mode == "stream":
            build_job(g, dev, d, kinds=("ivf_pq",)).run()
        elif mode == "data":
            build_job(g, dev, d, kinds=()).run()
        elif mode == "scrub":
            index = job_module("ivf_pq").load(os.path.join(d, "index.ckpt"), device=dev)
            jobs.resumable_scrub("ivf_pq", index, scratch=os.path.join(d, "scratch"),
                                 budget_lists=J["scrub_budget"], laps=1)
        elif mode == "mnmg":
            from raft_tpu_torch.comms import Comms

            c4 = Comms(n_devices=4, device=dev)
            jobs.checkpointed_mnmg_build(c4, "ivf_pq", mnmg_build_fn(g, dev, c4, g.n),
                                         os.path.join(d, "mnmg.ckpt"))
            c4.destroy()
        else:
            try:
                preempt_job(d, dev, notice=True).run()
            except jobs.JobPreempted:
                log("jobs child preempt: suspended as JobPreempted")
                return J["preempt_rc"]
    log(f"jobs child {mode}: ran to its end")
    return 0


def link_commits(src, dst, stages):
    """A JobDir at `dst` holding `src`'s commits of `stages`: their manifest
    lines and hard links of their artifacts (same bytes, size and mtime, so
    the child's runner skips them without reading them)."""
    from raft_tpu_torch.jobs import JobDir

    s, t = JobDir(src), JobDir(dst)
    with open(t.manifest_path, "w") as fh:
        for e in s.read_manifest():
            if e.get("stage") in stages:
                fh.write(json.dumps(e, sort_keys=True) + "\n")
                for art in e["artifacts"].values():
                    os.link(os.path.join(src, art["path"]), os.path.join(dst, art["path"]))


def jobs_children(g, tmp, dirs):
    """The five drills' children, started together through `run_supervised`
    (one thread each); returns {mode: exit code}."""
    from raft_tpu_torch import jobs

    J = JOBS_REHEARSE if g.rehearse else JOBS
    script = os.path.abspath(__file__)
    rcs, errors = {}, []

    def run(mode, kill):
        cmd = [sys.executable, script, "--jobs-child", mode, "--child-dir", dirs[mode],
               "--child-kill", str(kill), "--seed", str(g.seed)] + (
                   ["--rehearse"] if g.rehearse else [])
        try:
            rcs[mode] = jobs.run_supervised(cmd, describe=f"jobs child {mode}",
                                            deadline_s=J["child_deadline_s"], echo=True,
                                            cwd=os.path.dirname(script))
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append((mode, repr(e)))

    kills = {"stream": J["kill_at"], "data": J["kill_at"], "scrub": J["kill_at"], "mnmg": 1,
             "preempt": 0}
    threads = [threading.Thread(target=run, args=(m, kills[m])) for m in dirs]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(J["child_deadline_s"] + 60)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"jobs children failed: {errors}")
    log(f"jobs children: {rcs} in {time.perf_counter() - t0:.3f} s together")
    return rcs


def same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def jobs_path(g, dev, sync, inp):
    """Phase 4j: the jobs layer (raft_tpu_torch.jobs) in a temporary
    directory, under the committed table, at the main path's 1M x 96 rows
    (or the rehearsal's):
      1. the build job (`build_job`: make_data, then train + stream for
         IVF-PQ, IVF-Flat and RaBitQ): each stage's seconds, the extends'
         rows/s, the checkpoints' GB/s; the streamed IVF-PQ index at the
         main path's fused bf16 gate rung + refine clears the gate;
      2. five children at once (`--jobs-child`, through `run_supervised`):
         the stream SIGKILLed after its third checkpoint, make_data after
         its third chunk, a scrub after its third cursor commit, a
         checkpointed distributed build after its checkpoint, and the
         preemption job at its own SIGTERM; each resumed here: the index
         and the .npy byte for byte the uninterrupted run's, the scrub on
         from its cursor, the distributed build through `rehydrate` equal
         to an uninterrupted build, the preempted job's rerun skipping its
         committed stages;
      3. a stage stalled at `job.heartbeat.stall`, killed as StageTimeout
         and retried to its end: the detection seconds against
         stall_timeout_s and the device memory around the kill.
    Returns the summary."""
    import shutil

    from raft_tpu_torch import jobs
    from raft_tpu_torch.comms import Comms, mnmg
    from raft_tpu_torch.jobs import JobDir
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.refine import refine

    J = JOBS_REHEARSE if g.rehearse else JOBS
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_jobs_")
    out = {}
    try:
        with committed(dev):
            root = os.path.join(tmp, "build")
            timings = {}
            t0 = time.perf_counter()
            statuses = build_job(g, dev, root, timings=timings).run()
            out["job_s"] = time.perf_counter() - t0
            if set(statuses.values()) != {"ran"}:
                raise AssertionError(f"jobs build: {statuses}")
            out["stages"] = {k: v["s"] for k, v in timings.items() if "s" in v}
            out["streams"] = {}
            for kind in JOB_KINDS:
                t = timings[f"stream {kind}"]
                out["streams"][kind] = {
                    "rows_s": t["extend_rows"] / t["extend_s"], "extend_s": t["extend_s"],
                    "ckpt_gb_s": t["ckpt_bytes"] / t["ckpt_s"] / 1e9,
                    "ckpt_bytes": t["ckpt_bytes"], "ckpt_s": t["ckpt_s"],
                    "batches": t["stats"]["batches"]}
            log("jobs build: " + ", ".join(f"{k} {v:.3f} s" for k, v in out["stages"].items())
                + f"; {out['job_s']:.3f} s in all")
            for kind, s in out["streams"].items():
                log(f"jobs stream {kind}: {s['batches']} batches, extend {s['rows_s']:.1f} "
                    f"rows/s ({s['extend_s']:.3f} s fenced), checkpoints {s['ckpt_bytes']} "
                    f"bytes in {s['ckpt_s']:.3f} s, {s['ckpt_gb_s']:.4f} GB/s")
            jd = JobDir(root)
            pq_art = jd.artifact_path("stream")
            index = ivf_pq.load(pq_art, device=dev)
            for np_pq in ([inp["np_pq"]] if inp["np_pq"] else PROBE_LADDER):
                params = ivf_pq.SearchParams(n_probes=np_pq, score_mode="recon8_list",
                                             trim_engine="fused")
                _, cand = ivf_pq.search(params, index, inp["queries"], 4 * g.k)
                _, ids = refine(inp["dataset"], inp["queries"], cand, g.k, strategy="fused",
                                device=dev)
                out["recall"], out["n_probes"] = recall(ids, inp["truth"]), np_pq
                if out["recall"] >= RECALL_GATE:
                    break
            log(f"jobs stream ivf_pq: the job's index at n_probes {out['n_probes']} fused bf16 "
                f"+ refine, recall@{g.k} {out['recall']:.4f} (phase 4's index at that rung: "
                f"{inp['recall_pq']})")
            if out["recall"] < RECALL_GATE:
                raise AssertionError(f"jobs stream ivf_pq: recall {out['recall']} below the gate")
            del index
            # -- the children ------------------------------------------------
            dirs = {m: os.path.join(tmp, m) for m in ("stream", "data", "scrub", "mnmg",
                                                       "preempt")}
            for d in dirs.values():
                os.makedirs(d)
            link_commits(root, dirs["stream"], ("make_data", "train"))
            os.link(pq_art, os.path.join(dirs["scrub"], "index.ckpt"))
            rcs = jobs_children(g, tmp, dirs)
            kill = -signal.SIGKILL
            want = {"stream": kill, "data": kill, "scrub": kill, "mnmg": kill,
                    "preempt": J["preempt_rc"]}
            if rcs != want:
                raise AssertionError(f"jobs children: exit codes {rcs}, not {want}")
            # the stream: resumed from its cursor to the uninterrupted bytes
            t0 = time.perf_counter()
            timings2 = {}
            st = build_job(g, dev, dirs["stream"], kinds=("ivf_pq",), timings=timings2).run()
            resumed = timings2["stream ivf_pq"]["stats"]
            same = same_file(pq_art, JobDir(dirs["stream"]).artifact_path("stream"))
            out["kill_stream"] = {"statuses": st, "resumed_from_batch":
                                  resumed["resumed_from_batch"], "resume_s":
                                  time.perf_counter() - t0, "byte_equal": same}
            log(f"jobs kill stream: SIGKILL after checkpoint {J['kill_at']}; the rerun "
                f"{st} resumed from batch {resumed['resumed_from_batch']} in "
                f"{out['kill_stream']['resume_s']:.3f} s; saved index byte for byte the "
                f"uninterrupted run's: {same}")
            if (not same or resumed["resumed_from_batch"] != J["kill_at"]
                    or st != {"make_data": "skipped", "train": "skipped", "stream": "ran"}):
                raise AssertionError(f"jobs kill stream: {out['kill_stream']}")
            # make_data: resumed from its marker to the uninterrupted bytes
            marker = JobDir.read_json(os.path.join(dirs["data"], "scratch", "make_data",
                                                   "datagen_progress.json"))
            st = build_job(g, dev, dirs["data"], kinds=()).run()
            same = same_file(jd.artifact_path("make_data", "data.npy"),
                             JobDir(dirs["data"]).artifact_path("make_data", "data.npy"))
            out["kill_data"] = {"rows_done_at_kill": marker["rows_done"], "byte_equal": same}
            log(f"jobs kill make_data: SIGKILL after {marker['rows_done']} of {g.n} rows; the "
                f"rerun {st}; the .npy byte for byte the uninterrupted one: {same}")
            if not same or not 0 < marker["rows_done"] < g.n:
                raise AssertionError(f"jobs kill make_data: {out['kill_data']}")
            # the scrub: on from its committed cursor
            cur = JobDir.read_json(os.path.join(dirs["scrub"], "scratch", "scrub_cursor.json"))
            sindex = ivf_pq.load(pq_art, device=dev)
            bad, sst = jobs.resumable_scrub("ivf_pq", sindex,
                                            scratch=os.path.join(dirs["scrub"], "scratch"),
                                            budget_lists=J["scrub_budget"], laps=1)
            at = cur["lap"] * sindex.n_lists + cur["cursor"]
            out["kill_scrub"] = {"cursor": cur, "stats": sst, "mismatches": bad}
            log(f"jobs kill scrub: SIGKILL after cursor {cur['cursor']} (lap {cur['lap']}); the "
                f"rerun resumed at {sst['resumed_at']} and scanned {sst['lists_scanned']} of "
                f"{sindex.n_lists} lists, {len(bad)} mismatches")
            if (sst["resumed_at"] != at or at == 0
                    or sst["lists_scanned"] != sindex.n_lists - at or bad):
                raise AssertionError(f"jobs kill scrub: {out['kill_scrub']}")
            del sindex
            # the distributed build: through rehydrate, equal to an uninterrupted one
            c4 = Comms(n_devices=4, device=dev)
            try:
                ckpt = os.path.join(dirs["mnmg"], "mnmg.ckpt")

                def must_not_build():
                    raise AssertionError("the resume rebuilt the index")

                t0 = time.perf_counter()
                got, health, was_resumed = jobs.checkpointed_mnmg_build(
                    c4, "ivf_pq", must_not_build, ckpt)
                rehydrate_s = time.perf_counter() - t0
                ref = mnmg_build_fn(g, dev, c4, g.n)()
                q = inp["queries"][:256]
                gv, gi = mnmg.ivf_pq_search(got, q, g.k, n_probes=32)
                rv, ri = mnmg.ivf_pq_search(ref, q, g.k, n_probes=32)
                parts = {"ids": torch.equal(gi, ri), "values": torch.equal(gv, rv),
                         "codes": torch.equal(got.codes.full(), ref.codes.full()),
                         "centers": torch.equal(got.centers.full(), ref.centers.full())}
                equal = all(parts.values())
            finally:
                c4.destroy()
            out["kill_mnmg"] = {"resumed": was_resumed, "rehydrate_s": rehydrate_s,
                                "coverage": health.coverage(), "equal": equal, "parts": parts}
            log(f"jobs kill mnmg: SIGKILL after the checkpoint; checkpointed_mnmg_build "
                f"resumed through rehydrate in {rehydrate_s:.3f} s (coverage "
                f"{health.coverage()}), tables and answers equal to an uninterrupted build: "
                f"{equal}")
            if not (was_resumed and equal and health.coverage() == 1.0):
                raise AssertionError(f"jobs kill mnmg: {out['kill_mnmg']}")
            # the preempted job: the rerun skips the committed stages
            st = preempt_job(dirs["preempt"], dev, notice=False).run()
            out["preempt"] = st
            log(f"jobs preempt: the child ended as JobPreempted after its SIGTERM; the rerun "
                f"{st}")
            if st != {"s1": "skipped", "s2": "skipped", "s3": "ran"}:
                raise AssertionError(f"jobs preempt: {st}")
            # -- the watchdog: a stalled stage killed and retried ---------------
            out["watchdog"] = jobs_watchdog_part(g, dev, tmp, J)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"jobs path complete in {out['wall_s']:.3f} s")
    return out


def jobs_watchdog_part(g, dev, tmp, J):
    """A stage of device work that beats its heartbeat, armed with
    slow_rank at `job.heartbeat.stall` (the first beat stalls J["stall_s"]):
    the watchdog kills it as StageTimeout, the retry passes. Logs the
    detection seconds against stall_timeout_s and the device memory before
    the kill, after it and after the retry."""
    from raft_tpu_torch import jobs, obs
    from raft_tpu_torch.core import faults

    mem = {}

    def allocated():
        return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0

    attempts = []

    def work(ctx):
        attempts.append(1)
        key = "before_kill" if len(attempts) == 1 else "after_kill"
        x = torch.randn((4096, 4096), device=dev)
        mem[key] = allocated()
        ctx.heartbeat()  # the first attempt's beat stalls here
        y = x @ x
        ctx.heartbeat()
        return {"norm": float(y.norm().item())}

    job = jobs.Job("chip_smoke_watchdog", os.path.join(tmp, "watchdog"))
    job.add_stage("stall", work, retries=2, stall_timeout_s=J["stall_timeout_s"])
    plan = faults.FaultPlan([faults.Fault(kind="slow_rank", site="job.heartbeat.stall",
                                          latency_s=J["stall_s"], count=1)], seed=g.seed)
    obs.reset()
    obs.enable()
    try:
        t0 = time.perf_counter()
        with plan.install():
            st = job.run()
        wall = time.perf_counter() - t0
        kills = [e for e in obs.snapshot()["events"]
                 if e["kind"] == "fault" and e.get("action") == "watchdog_kill"]
    finally:
        obs.disable()
        obs.reset()
    mem["after_retry"] = allocated()
    out = {"statuses": st, "attempts": len(attempts), "kills": len(kills),
           "detect_s": kills[0]["elapsed_s"] if kills else None,
           "stall_timeout_s": J["stall_timeout_s"], "wall_s": wall, "memory": mem}
    log(f"jobs watchdog: stage {st} after {len(attempts)} attempts; the stall killed after "
        f"{out['detect_s']} s (stall_timeout_s {J['stall_timeout_s']}); device memory "
        f"allocated before the kill {mem.get('before_kill')}, in the retry "
        f"{mem.get('after_kill')}, after it {mem['after_retry']} bytes; {wall:.3f} s in all")
    if st != {"stall": "ran"} or len(attempts) != 2 or len(kills) != 1:
        raise AssertionError(f"jobs watchdog: {out}")
    return out


def jobs_setup(g, dev, sync):
    """Phase 4j's inputs when it runs alone (`--jobs`): the main path's data,
    queries and truth; the IVF-PQ rung is found on the job's own index."""
    from raft_tpu_torch.neighbors import brute_force

    data_np, queries_np = make_blobs(g.seed, g.n, g.dim, g.nq, g.n_lists)
    dataset = torch.from_numpy(data_np).to(dev)
    queries = torch.from_numpy(queries_np).to(dev)
    _, truth = brute_force.knn(dataset, queries, g.k, engine="fused", device=dev)
    sync()
    return {"dataset": dataset, "queries": queries, "truth": truth, "np_pq": None,
            "recall_pq": "not measured"}


def jobs_inputs(res):
    """Phase 4j's inputs from phase 4's results: the fused bf16 + refine
    rung that first cleared the gate, and its recall."""
    gate = next(r for r in res["rungs"] if (r["trim"], r["score_dtype"]) == ("fused", "bf16")
                and r["recall"] >= RECALL_GATE)
    return {"dataset": res["dataset"], "queries": res["queries"], "truth": res["truth"],
            "np_pq": gate["n_probes"], "recall_pq": f"{gate['recall']:.4f}"}


# ---------------------------------------------------------------------------
# phase 5: kernels on the main path's inputs
# ---------------------------------------------------------------------------


def bound_ms(ops, nbytes, peak=PEAK_BF16_FLOPS):
    """(the least time the card could take in ms, "operations" or
    "bytes", the two terms in ms)."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"),
            {"ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3})


def list_work(lof, base, live, rot):
    """What a list scan's data needs: 2 x each chunk's live rows x its
    list's real (finite-base) slots x rot operations; the distinct lists
    touched and their real slots."""
    slots = torch.isfinite(base[:, 0, :]).sum(1)
    lists = torch.unique(lof[live > 0].long())
    ops = 2.0 * float((live.long() * slots[lof.long()]).sum()) * rot
    return ops, int(slots[lists].sum()), lists.numel()


#: k over which phase 5 times the list kernels on the trim's inputs (their
#: selection switches from register to shared-memory lists past k 32)
LIST_K_SWEEP = (8, 16, 32, 33, 40, 64, 128, 250)


def scan_tiles(lof, base, live):
    """The tiles each live block of a list kernel scans (its list's slots
    up to the end of the last one whose base is not +inf, rounded up to 64
    slots, in tiles of 128), over the call's live blocks (16 rows each):
    (min, median, mean, max, total) and the total at the padded length."""
    L = base.shape[2]
    real = base[:, 0, :] != float("inf")
    pos = torch.arange(1, L + 1, device=base.device)
    last = torch.where(real, pos, 0).amax(1)            # end of the last real slot
    tiles = (-(-last // 64) * 64 + 127) // 128          # per list
    blocks = (live.long() + 15) // 16                   # live blocks per chunk
    t = torch.repeat_interleave(tiles[lof.long()], blocks).float().cpu()
    if t.numel() == 0:
        return {"blocks": 0}
    return {"blocks": int(t.numel()), "min": float(t.min()), "median": float(t.median()),
            "mean": float(t.mean()), "max": float(t.max()), "total": float(t.sum()),
            "total_at_L": float(t.numel() * (L // 128))}


def k_sweep(run, reps, kb_of):
    """{k: ms} of run(k, kbuf) over LIST_K_SWEEP."""
    return {ks: time_ms(lambda: run(ks, kb_of(ks)), reps) for ks in LIST_K_SWEEP}


def list_kernel_row(fs, call, launches, reps, label, sweep=False, term_scale=False):
    """Kernel 1 on one captured call, against its plain version. With
    `term_scale` the values are held to VAL_RTOL times the rows' term
    magnitudes (`list_term_scale`) where those exceed the scores', and both
    the kernel's and the plain version's values of 32 sampled chunks are
    held to the same tolerance against float64 scores of their slots."""
    (lof, qres, store, base, k), kw = call[0], call[1]
    ip = bool(kw.get("inner_product", False))
    cv, cr = kw.get("chunk_valid"), kw.get("chunk_rows")
    kb = kw.get("kbuf") or fs.fused_kbuf(k)
    ncb, chunk, rot = qres.shape
    L = store.shape[1]
    live = fs._live_rows(cv, cr, chunk)
    if live is None:
        live = torch.full((ncb,), chunk, dtype=torch.int32, device=lof.device)
    # work this run's data needs: each chunk's live rows against its
    # list's real slots; bytes: operands read once (live rows, the real
    # slots and base rows of the distinct lists touched, the chunk
    # tables), outputs written once
    flops, real_slots, n_used = list_work(lof, base, live, rot)
    nbytes = (ncb * 8 + int(live.sum()) * rot * 4 + real_slots * rot * store.element_size()
              + n_used * L * 4 + ncb * chunk * kb * 8)
    b_ms, b_by, terms = bound_ms(flops, nbytes)

    def kernel():
        return fs.fused_list_topk(lof, qres, store, base, k, kbuf=kb, inner_product=ip,
                                  chunk_valid=cv, chunk_rows=cr)

    def plain():
        return fs.fused_list_topk_plain(lof, qres, store, base, k, kb, ip, cv, cr)

    ref = plain()
    terms_f64 = None
    if term_scale:
        out = kernel()
        scale = list_term_scale(lof, qres, store, base, ref[1][..., :k], ip)
        err, agree = compare(f"fused_list_topk ({label})", out, ref, k, terms=scale)
        terms_f64 = f64_check(f"fused_list_topk ({label})", lof, qres, store, base, ip, out, ref,
                              k, scale)
    else:
        err, agree = compare(f"fused_list_topk ({label})", kernel(), ref, k)
    ms = time_ms(kernel, reps)
    terms.update(parent_ab(kernel, "fused_list_topk.cu", reps, f"fused_list_topk ({label})"))
    plain_ms = time_ms(plain, max(1, reps // 4))
    coef = 1.0 if ip else 2.0

    def library():
        st = store[lof.long()].to(torch.bfloat16)
        sc = base[lof.long()] - coef * torch.bmm(qres.to(torch.bfloat16), st.transpose(1, 2))
        return torch.topk(sc, k, dim=-1, largest=False)

    lib_ms = time_ms(library, reps)
    if qres.is_cuda:  # the device time of each launch
        terms.update(launch_ms(kernel, reps))
    terms["tiles"] = tiles = scan_tiles(lof, base, live)
    if sweep:
        terms["k_sweep_ms"] = k_sweep(
            lambda ks, kbs: fs.fused_list_topk(lof, qres, store, base, ks, kbuf=kbs,
                                               inner_product=ip, chunk_valid=cv, chunk_rows=cr),
            reps, lambda ks: max(kb, fs.fused_kbuf(ks)))
        log(f"kernel fused_list_topk ({label}) over k (register lists to k "
            f"{fs.MAX_REGISTER_K}): " + ", ".join(
                f"k {ks} {v:.4f} ms" for ks, v in terms["k_sweep_ms"].items()))
    if terms_f64 is not None:
        terms["vs_float64"] = terms_f64
    log(f"kernel fused_list_topk ({label}): ncb {ncb} ({int((live > 0).sum())} live, "
        f"{int(live.sum())} live rows), chunk {chunk}, L {L}, "
        f"rot {rot}, store {store.dtype}, k {k}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max_abs_err {err}, "
        f"id agreement {agree}; launches {launches}; device ms a launch "
        f"{terms.get('launch_ms', float('nan')):.4f} (each "
        f"{[round(v, 4) for v in terms.get('launch_ms_each', [])]}); "
        f"tiles a live block {tiles}"
        + ("" if terms_f64 is None else f"; tolerance from the term scale, against float64 "
           f"on 32 chunks {terms_f64}"))
    return {"name": "fused_list_topk", "route": "cuda",
            "source": "raft_tpu_torch/csrc/fused_list_topk.cu",
            "replaces": "raft_tpu/ops/fused_scan.py:443", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "bound_terms": terms,
            "shape": f"{label}: ncb={ncb} chunk={chunk} L={L} rot={rot} k={k}"}


def f64_check(name, lof, q, store, base, ip, out, ref, k, scale, n_chunks=32):
    """The kernel's and the plain version's values of `n_chunks` sampled
    live chunks against float64 scores of their own slots (bf16-rounded
    operands, `bf16_rescore`), each within VAL_RTOL times `scale`. Returns
    the two largest errors and the largest tolerance-scaled one."""
    rescore = bf16_rescore(lof, q, store, base, ip)
    chunks = torch.nonzero(torch.isfinite(ref[0][:, :, 0]).any(1))[:, 0]
    chunks = chunks[torch.linspace(0, chunks.numel() - 1, min(n_chunks, chunks.numel()),
                                   device=chunks.device).long()]
    res = {}
    worst = 0.0
    for label, (v, i) in (("kernel", out), ("plain", ref)):
        v, i = v[chunks, :, :k], i[chunks, :, :k]
        fin = torch.isfinite(v)
        c, r, j = torch.nonzero(fin, as_tuple=True)
        exact = rescore(chunks[c], r, i[c, r, j])
        e = (v[c, r, j].double() - exact).abs()
        rel = e / (VAL_RTOL * scale[chunks[c], r].double())
        res[f"{label}_max_abs_err"] = float(e.max()) if e.numel() else 0.0
        worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
    res["max_err_in_tolerances"] = worst
    if worst > 1.0:
        raise AssertionError(f"{name}: values differ from float64 beyond VAL_RTOL x the term scale")
    return res


def device_split(run, reps, kernel_names):
    """Device milliseconds a call of `run` under torch.profiler, split into
    the kernels named (substrings) and everything else the call launches,
    and how many launches of the named kernels the profiler reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    kern = other = 0.0
    seen = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.end - e.time_range.start
        if any(name in e.name for name in kernel_names):
            kern += us
            seen += 1
        else:
            other += us
    return {"kernel_device_ms": kern / 1e3 / reps, "setup_device_ms": other / 1e3 / reps,
            "kernel_launches_seen": seen, "calls": reps}


#: cycles of the sleep kernel `launch_ms` queues ahead of a timed launch
#: (about 2 ms at 1.98 GHz, far longer than the host takes to queue it)
SLEEP_CYCLES = 4_000_000


def launch_ms(run, reps):
    """The device milliseconds of each of `reps` launches of a one-kernel
    call, by CUDA events around that call alone: a sleep kernel queued
    first keeps the stream busy while the host queues the start event, the
    call and the end event, so the interval holds the launch and none of
    the host's time. (torch.profiler, late in this script, reports only
    some launches of the list kernels, PERF.md section 7.)"""
    run()
    torch.cuda.synchronize()
    each = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        run()
        end.record()
        end.synchronize()
        each.append(start.elapsed_time(end))
    return {"launch_ms": sum(each) / reps, "launch_ms_each": each}


def flat_kernel_row(fs, call, launches, reps, label="truth"):
    (x, y, k), kw = call[0], call[1]
    ip = bool(kw.get("inner_product", False))
    m, d = x.shape
    n = y.shape[0]
    kb = fs.fused_kbuf(k)
    flops = 2.0 * m * n * d
    nbytes = (m + n) * d * 4 + m * kb * 8
    b_ms, b_by, terms = bound_ms(flops, nbytes)
    out = fs.fused_topk(x, y, k, inner_product=ip, valid=kw.get("valid"))
    yb = y.to(torch.bfloat16)
    base = torch.zeros(n, device=y.device) if ip else (yb.float() ** 2).sum(1)
    xb = x.to(torch.bfloat16).float()

    def plain():
        return fs.fused_topk_plain(xb, yb, base, k, kb, ip)

    valid = kw.get("valid")
    if valid is not None:  # filtered columns: +inf base, as the wrapper makes them
        base = torch.where(valid.bool(), base, float("inf"))
    err, agree = compare(f"fused_topk ({label})", out, plain(), k)
    ms = time_ms(lambda: fs.fused_topk(x, y, k, inner_product=ip, valid=valid), reps,
                 warmup=0)
    plan = fs.flat_plan(m, n, d, k, torch.cuda.get_device_properties(x.device).multi_processor_count
                        if x.is_cuda else 132)
    plain_ms = time_ms(plain, 1, warmup=0)
    coef = 1.0 if ip else 2.0
    xh, yh, bh = x.to(torch.bfloat16), yb, base.to(torch.bfloat16)

    def library():
        return torch.topk(torch.addmm(bh[None, :], xh, yh.T, alpha=-coef), k, dim=1,
                          largest=False)

    lib_ms = time_ms(library, reps)
    if x.is_cuda:  # the call's device time: the kernels, and the wrapper's setup around them
        terms.update(device_split(lambda: fs.fused_topk(x, y, k, inner_product=ip, valid=valid),
                                  reps, ("tc_range_kernel", "merge_ranges_kernel", "flat_kernel")))
    log(f"kernel fused_topk ({label}): m {m}, n {n}, d {d}, k {k} ({plan.variant}, "
        f"{plan.rows} rows a block, {plan.n_ranges} n ranges of {plan.range_len}): {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"max_abs_err {err}, id agreement {agree}; device ms a call: kernels "
        f"{terms.get('kernel_device_ms', float('nan')):.4f}, setup "
        f"{terms.get('setup_device_ms', float('nan')):.4f}")
    return {"name": "fused_topk", "route": "cuda", "source": "raft_tpu_torch/csrc/fused_topk.cu",
            "replaces": "raft_tpu/ops/fused_scan.py:267", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "bound_terms": terms,
            "shape": f"{label}: m={m} n={n} d={d} k={k}", "plan": plan._asdict()}


def bf16_bmm(a, b):
    """One cuBLAS call: bf16 x bf16 batched product with f32 output (a
    CPU rehearsal, which has no such kernel, multiplies in f32)."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def int8_list_row(fs, call, launches, reps, label, sweep=False):
    (lof, q8, store, base, q_scale, k), kw = call[0], call[1]
    ip = bool(kw.get("inner_product", False))
    cv, cr = kw.get("chunk_valid"), kw.get("chunk_rows")
    kb = kw.get("kbuf") or fs.fused_kbuf(k)
    ncb, chunk, rot = q8.shape
    L = store.shape[1]
    live = fs._live_rows(cv, cr, chunk)
    if live is None:
        live = torch.full((ncb,), chunk, dtype=torch.int32, device=lof.device)
    # int8 operations; bytes: live int8 rows and their scales, the real
    # slots and base rows of the lists touched, the chunk tables, outputs
    ops, real_slots, n_used = list_work(lof, base, live, rot)
    nbytes = (ncb * 8 + int(live.sum()) * (rot + 4) + real_slots * rot + n_used * L * 4
              + ncb * chunk * kb * 8)
    b_ms, b_by, terms = bound_ms(ops, nbytes, PEAK_INT8_OPS)

    def kernel():
        return fs.fused_list_topk_int8(lof, q8, store, base, q_scale, k, kbuf=kb,
                                       inner_product=ip, chunk_valid=cv, chunk_rows=cr)

    def plain():
        return fs.fused_list_topk_int8_plain(lof, q8, store, base, q_scale, k, kb, ip, cv, cr)

    require_equal(f"fused_list_topk_int8 ({label})", kernel(), plain())
    ms = time_ms(kernel, reps)
    terms.update(parent_ab(kernel, "fused_list_topk_int8.cu", reps,
                           f"fused_list_topk_int8 ({label})"))
    plain_ms = time_ms(plain, max(1, reps // 4))
    coef = 1.0 if ip else 2.0

    def library():
        # the int8 values are exact in bf16 and their 96-term sums in f32
        st = store[lof.long()].to(torch.bfloat16)
        dots = bf16_bmm(q8.to(torch.bfloat16), st.transpose(1, 2))
        return torch.topk(base[lof.long()] - coef * (dots * q_scale), k, dim=-1, largest=False)

    lib_ms = time_ms(library, reps)
    if q8.is_cuda:  # the device time of each launch
        terms.update(launch_ms(kernel, reps))
    terms["tiles"] = tiles = scan_tiles(lof, base, live)
    if sweep:
        terms["k_sweep_ms"] = k_sweep(
            lambda ks, kbs: fs.fused_list_topk_int8(lof, q8, store, base, q_scale, ks, kbuf=kbs,
                                                    inner_product=ip, chunk_valid=cv,
                                                    chunk_rows=cr),
            reps, lambda ks: max(kb, fs.fused_kbuf(ks)))
        log(f"kernel fused_list_topk_int8 ({label}) over k (register lists to k "
            f"{fs.MAX_REGISTER_K}): " + ", ".join(
                f"k {ks} {v:.4f} ms" for ks, v in terms["k_sweep_ms"].items()))
    log(f"kernel fused_list_topk_int8 ({label}): ncb {ncb} ({int((live > 0).sum())} live, "
        f"{int(live.sum())} live rows), chunk {chunk}, L {L}, rot {rot}, k {k}: {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"ops {terms['ops_ms']:.4f}, bytes {terms['bytes_ms']:.4f}), bitwise equal to plain; "
        f"launches {launches}; device ms a launch "
        f"{terms.get('launch_ms', float('nan')):.4f} (each "
        f"{[round(v, 4) for v in terms.get('launch_ms_each', [])]}); "
        f"tiles a live block {tiles}")
    return {"name": "fused_list_topk_int8", "route": "cuda",
            "source": "raft_tpu_torch/csrc/fused_list_topk_int8.cu",
            "replaces": "raft_tpu/ops/fused_scan.py:575", "launches": launches,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "bound_terms": terms,
            "shape": f"{label}: ncb={ncb} chunk={chunk} L={L} rot={rot} k={k}"}


def fold_kernel_row(pls, call, launches, reps, label, fold):
    (lof, q, store, base), kw = call[0], call[1]
    ip = bool(kw["inner_product"])
    q_scale, cr = kw.get("q_scale"), kw.get("chunk_rows")
    ncb, chunk, rot = q.shape
    L = store.shape[1]
    live = cr if cr is not None else torch.full((ncb,), chunk, dtype=torch.int32,
                                                  device=lof.device)
    int8 = q_scale is not None
    # bytes: live query rows (and int8 scales), the real slots and base
    # rows of the lists touched, the chunk tables, and the output the
    # contract writes: 512 candidates for every row of every chunk
    ops, real_slots, n_used = list_work(lof, base, live, rot)
    out_bytes = ncb * chunk * pls._CANDS * 8
    in_bytes = (ncb * 8 + int(live.sum()) * rot * q.element_size()
                + (int(live.sum()) * 4 if int8 else 0) + real_slots * rot * store.element_size()
                + n_used * L * 4)
    b_ms, b_by, terms = bound_ms(ops, in_bytes + out_bytes, PEAK_INT8_OPS if int8 else
                                 PEAK_BF16_FLOPS)
    terms.update(input_bytes=in_bytes, output_bytes=out_bytes)

    def kernel():
        return pls.pq_list_scan(lof, q, store, base, inner_product=ip, q_scale=q_scale,
                                fold=fold, chunk_rows=cr)

    def plain():
        return pls.pq_list_scan_plain(lof, q, store, base, ip, q_scale, fold, cr)

    name = f"pq_list_scan ({label})"
    if int8:
        require_equal(name, kernel(), plain())
        err, agree = 0.0, 1.0
    else:
        err, agree = fold_compare(name, kernel(), plain(), bf16_rescore(lof, q, store, base, ip))
    ms = time_ms(kernel, reps)
    terms.update(parent_ab(kernel, "pq_list_scan.cu", reps, name))
    plain_ms = time_ms(plain, max(1, reps // 4))
    coef = 1.0 if ip else 2.0

    def library():
        st = store[lof.long()].to(torch.bfloat16)
        dots = bf16_bmm(q.to(torch.bfloat16), st.transpose(1, 2))
        if int8:
            dots = dots * q_scale
        sc = torch.nn.functional.pad(base[lof.long()] - coef * dots, (0, -L % 256),
                                     value=float("inf"))
        return torch.topk(sc.view(ncb, chunk, -1, 2, 128), 2, dim=2, largest=False)

    lib_ms = time_ms(library, reps)
    if q.is_cuda:  # the device time of each launch
        terms.update(launch_ms(kernel, reps))
    terms["tiles"] = tiles = scan_tiles(lof, base, live)
    log(f"kernel pq_list_scan ({label}): ncb {ncb} ({int((live > 0).sum())} live, "
        f"{int(live.sum())} live rows), chunk {chunk}, L {L}, rot {rot}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; ops "
        f"{terms['ops_ms']:.4f}, bytes {terms['bytes_ms']:.4f}: {in_bytes} in + {out_bytes} "
        f"out), max_abs_err {err}, slot agreement {agree}; device ms a launch "
        f"{terms.get('launch_ms', float('nan')):.4f} (each "
        f"{[round(v, 4) for v in terms.get('launch_ms_each', [])]}); "
        f"tiles a live block {tiles}")
    return {"name": "pq_list_scan", "route": "cuda", "source": "raft_tpu_torch/csrc/pq_list_scan.cu",
            "replaces": "raft_tpu/ops/pq_list_scan.py:303", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "bound_terms": terms,
            "shape": f"{label}: ncb={ncb} chunk={chunk} L={L} rot={rot}"}


def pairwise_row(a, b, metric, launches, reps, label):
    """Kernel 8 on the operands (a, b) a path gave it under `metric`,
    against its plain version (bit for bit for linf and hamming), with
    the bound: f32 instructions a term (`TERM_OPS`) beside MUFU operations
    and the bytes. Library: torch.cdist where one call computes the same
    function."""
    from raft_tpu_torch.ops import pairwise_tiled as pt

    m, k = a.shape
    n = b.shape[0]
    library = {"l1": {"p": 1.0}, "linf": {"p": float("inf")},
               "l2_sqrt_unexpanded": {"p": 2.0, "compute_mode": "donot_use_mm_for_euclid_dist"},
               "hamming": {"p": 0.0}}
    finalize = metric in ("l2_sqrt_unexpanded", "hamming")
    ops = TERM_OPS[metric] * m * n * k + (m * n if finalize else 0)
    mufu = TERM_MUFU.get(metric, 0) * m * n * k + Y_ELEM_MUFU.get(metric, 0) * n * k
    b_ms, b_by, terms = bound_ms(max(ops, mufu * PEAK_F32_INSTR / PEAK_MUFU),
                                 (m + n) * k * 4 + m * n * 4, PEAK_F32_INSTR)
    terms.update(f32_ms=ops / PEAK_F32_INSTR * 1e3, mufu_ms=mufu / PEAK_MUFU * 1e3)

    def kernel():
        return pt.pairwise_tiled(a, b, metric)

    def plain():
        return pt.pairwise_tiled_plain(a, b, metric)

    exact = metric in ("linf", "hamming")
    err = matrix_compare(f"pairwise_tiled {metric} ({label})", kernel(), plain(), exact)
    ms = time_ms(kernel, reps)
    plain_ms = time_ms(plain, 1, warmup=0)
    lib_ms = None
    if metric in library:
        lib_ms = time_ms(lambda: torch.cdist(a, b, **library[metric]), reps)
    log(f"kernel pairwise_tiled {metric} ({label}): m {m}, n {n}, k {k}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
        f"bound {b_ms:.4f} ms ({b_by}; f32 {terms['f32_ms']:.4f}, MUFU "
        f"{terms['mufu_ms']:.4f}, bytes {terms['bytes_ms']:.4f}), "
        + ("bitwise equal to plain" if exact else f"max_abs_err {err}"))
    return {"name": "pairwise_tiled", "route": "cuda",
            "source": "raft_tpu_torch/csrc/pairwise_tiled.cu",
            "replaces": "raft_tpu/ops/pairwise_pallas.py:113", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "bound_terms": terms,
            "metric": metric, "shape": f"{label}: m={m} n={n} k={k}"}


def pairwise_rows(slice_res, launches, reps):
    """Kernel 8 at the brute-force tile shape (the first L1 tile's inputs:
    the queries against 32,768 dataset rows), one row per metric: l1,
    linf, the two L2 and canberra on the blobs, KL on the blobs' absolute
    values normalised to sum 1, hamming on the blobs rounded to integers."""
    from raft_tpu_torch.ops import pairwise_tiled as pt

    x, y = slice_res["tile_inputs"]
    xa, ya = x.abs(), y.abs()
    inputs = {"kl_divergence": (xa / xa.sum(1, keepdim=True), ya / ya.sum(1, keepdim=True)),
              "hamming": (x.round(), y.round())}
    return [pairwise_row(*inputs.get(metric, (x, y)), metric, launches, reps, "L1 tile")
            for metric in pt.METRIC_OPS]


def argmin_row(slice_res, launches, reps):
    """Kernel 5 at the build's labelling shape: the rotated rows against
    the coarse centres. Library: one f32 addmm (|c|^2 - 2 x.c, TF32 off)
    and torch.min over it."""
    from raft_tpu_torch.core.config import strict_f32_matmul
    from raft_tpu_torch.ops import fused_l2_argmin as fla

    x, y = slice_res["rotated"], slice_res["centers"]
    m, k = x.shape
    n = y.shape[0]
    # the same work on two routes: f32 on the CUDA cores, or split TF32
    # (three TF32 products a multiply-add) on the tensor cores, as the
    # kernel runs it; the bound is the cheaper route's
    ops, nbytes = 2.0 * m * n * (k + 1), (m + n) * k * 4 + m * 8
    b_ms, b_by, terms = bound_ms(3.0 * ops, nbytes, PEAK_TF32_FLOPS)
    terms["split_tf32_ms"] = terms.pop("ops_ms")
    terms["f32_cuda_core_ms"] = bound_ms(ops, nbytes, PEAK_F32_FLOPS)[2]["ops_ms"]
    variant = "x resident" if -(-k // 32) * 32 <= fla.RESIDENT_MAX_DEPTH else "x streamed"

    def kernel():
        return fla.fused_l2_argmin(x, y)

    def plain():
        return fla.fused_l2_argmin_plain(x, y)

    err, agree = argmin_compare("fused_l2_argmin (labelling)", kernel(), plain(), x, y)
    ms = time_ms(kernel, reps)
    plain_ms = time_ms(plain, 1, warmup=0)
    strict_f32_matmul()
    yn = (y * y).sum(1)
    lib_ms = time_ms(lambda: torch.min(torch.addmm(yn, x, y.T, alpha=-2.0), dim=1), reps)
    log(f"kernel fused_l2_argmin (labelling, {variant}): m {m}, n {n}, k {k}: {ms:.4f} ms "
        f"(PERF.md's figure for the earlier SIMT kernel: {EARLIER_ARGMIN_MS} ms), plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; split TF32 "
        f"{terms['split_tf32_ms']:.4f}, f32 on the CUDA cores "
        f"{terms['f32_cuda_core_ms']:.4f}, bytes {terms['bytes_ms']:.4f}), max_abs_err {err}, "
        f"id agreement {agree}")
    return {"name": "fused_l2_argmin", "route": "cuda",
            "source": "raft_tpu_torch/csrc/fused_l2_argmin.cu",
            "replaces": "raft_tpu/ops/fused_l2_argmin.py:114", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "bound_terms": terms,
            "shape": f"labelling: m={m} n={n} k={k} ({variant})"}


def counting_tile_row(tile, k, launches, reps, label):
    """Kernel 6 on a tile a path gave it: bit for bit against its plain
    version, with the bytes bound. Library: torch.topk."""
    from raft_tpu_torch.ops import select_counting as sc

    B, L = tile.shape
    b_ms, b_by, terms = bound_ms(0.0, B * L * 4 + B * k * 8)

    def kernel():
        return sc.counting_select_min(tile, k)

    def plain():
        return sc.counting_select_min_plain(tile, k)

    require_equal(f"counting_select_min ({label})", kernel(), plain())
    ms = time_ms(kernel, reps)
    plain_ms = time_ms(plain, 1, warmup=0)
    lib_ms = time_ms(lambda: torch.topk(tile, k, dim=1, largest=False), reps)
    log(f"kernel counting_select_min ({label}): B {B}, L {L}, k {k}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), bitwise "
        f"equal to plain")
    return {"name": "counting_select_min", "route": "cuda",
            "source": "raft_tpu_torch/csrc/select_counting.cu",
            "replaces": "raft_tpu/ops/select_counting.py:140", "launches": launches,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "bound_terms": terms,
            "shape": f"{label}: B={B} L={L} k={k}"}


def counting_row(slice_res, launches, reps, k):
    """Kernel 6 on the first L1 distance tile, and beside it descending
    rows of the tile's shape (the one-pass variant's worst case) and the
    two variants at the switch."""
    from raft_tpu_torch.ops import select_counting as sc

    tile = slice_res["tile"]
    B, L = tile.shape
    row = counting_tile_row(tile, k, launches, reps, "L1 tile")
    terms = row["bound_terms"]
    # the worst case of the small-k variant, at the tile's shape: strictly
    # descending rows, every element an insertion
    desc = torch.arange(L, 0, -1, dtype=torch.float32, device=tile.device).expand(B, L)
    desc = desc.contiguous()
    require_equal("counting_select_min (descending rows)", sc.counting_select_min(desc, k),
                  sc.counting_select_min_plain(desc, k))
    desc_ms = time_ms(lambda: sc.counting_select_min(desc, k), reps)
    desc_lib_ms = time_ms(lambda: torch.topk(desc, k, dim=1, largest=False), reps)
    terms["descending_ms"], terms["descending_library_ms"] = desc_ms, desc_lib_ms
    del desc
    # at the variant switch (k = SMALL_K_MAX): the one-pass variant against
    # the radix one, forced by a row view off 16-byte alignment, on the tile
    off = torch.empty(B * L + 1, dtype=torch.float32, device=tile.device)[1:].view(B, L)
    off.copy_(tile)
    ks = sc.SMALL_K_MAX
    require_equal(f"counting_select_min radix k {ks}", sc.counting_select_min(off, ks),
                  sc.counting_select_min(tile, ks))
    terms["switch_k"] = ks
    terms["switch_one_pass_ms"] = time_ms(lambda: sc.counting_select_min(tile, ks), reps)
    terms["switch_radix_ms"] = time_ms(lambda: sc.counting_select_min(off, ks), reps)
    del off
    log(f"kernel counting_select_min (L1 tile) beside it: descending rows of the same shape "
        f"{desc_ms:.4f} ms (library {desc_lib_ms:.4f} ms), bitwise equal to plain; at the "
        f"variant switch, k {ks}: one pass {terms['switch_one_pass_ms']:.4f} ms, radix "
        f"{terms['switch_radix_ms']:.4f} ms")
    return row


def bitplane_row(fs, call, launches, reps, label, sweep=False):
    """Kernel 7 on the operands a rung of the RaBitQ path gave it (its
    first call; `label` names the rung). Bound: the function is a
    rot_dim-wide dot product of each live row's uint8 query levels against
    each real (finite-base) slot's {0,1} code bits, so 2 x rot_dim x those
    pairs operations at the card's int8 rate, as rows 1, 3 and 4 count
    theirs, against the bytes at 3.35 TB/s (live rows' planes and qmeta,
    the real slots' codes and meta and the base rows of the lists touched,
    the chunk tables, the (chunk, kbuf) outputs). The popcounts of the
    CUDA-core scan the kernel replaced (pairs x bits x words at PEAK_POPC)
    stand beside them in bound_terms. Library, by rows 1, 3 and 4's
    convention: the levels and the code bits as bf16 (exact), prepared
    once outside the timing, the chunks' lists gathered, one bf16 `bmm`
    with f32 sums (exact below 2^24), the estimator, then `torch.topk`;
    the port never calls it."""
    (lof, planes, codes_t, meta, base, qmeta, k), kw = call
    rot, bits, kb = kw["rot_dim"], kw["bits"], kw.get("kbuf") or fs.fused_kbuf(k)
    ip, cv, cr = bool(kw.get("inner_product", False)), kw.get("chunk_valid"), kw.get("chunk_rows")
    ncb, chunk, pw = planes.shape
    W, L = codes_t.shape[1:]
    live = fs._live_rows(cv, cr, chunk)
    if live is None:
        live = torch.full((ncb,), chunk, dtype=torch.int32, device=lof.device)
    ops, real, n_lists = list_work(lof, base, live, rot)
    pairs = ops / (2.0 * rot)
    n_popc = pairs * bits * W
    nbytes = (ncb * 8 + int(live.sum()) * (pw * 4 + 16) + real * (W * 4 + 12)
              + n_lists * L * 4 + ncb * chunk * kb * 8)
    b_ms, b_by, terms = bound_ms(ops, nbytes, PEAK_INT8_OPS)
    terms["popc_ms"] = n_popc / PEAK_POPC * 1e3
    terms["resident_levels"] = fs.bitplane_resident(W, k)

    def kernel():
        return fs.fused_bitplane_topk(lof, planes, codes_t, meta, base, qmeta, k, rot_dim=rot,
                                      bits=bits, kbuf=kb, inner_product=ip, chunk_valid=cv,
                                      chunk_rows=cr)

    def plain():
        return fs.fused_bitplane_topk_plain(lof, planes, codes_t, meta, base, qmeta, k, kb, rot,
                                            bits, ip, cv, cr)

    require_equal(f"fused_bitplane_topk ({label})", kernel(), plain())
    ms = time_ms(kernel, reps)
    terms.update(parent_ab(kernel, "fused_bitplane_topk.cu", reps,
                           f"fused_bitplane_topk ({label})"))
    plain_ms = time_ms(plain, 1, warmup=0)
    levels = fs.bitplane_levels(planes, bits).to(torch.bfloat16)   # (ncb, chunk, 32 W)
    cbits = fs.expand_code_bits(codes_t).to(torch.bfloat16)       # (n_lists, 32 W, L)
    rsq = fs.rsqrt_dim(rot)

    def library():
        lids = lof.long()
        su = bf16_bmm(levels, cbits[lids])
        m = meta[lids]
        s = su.mul_(qmeta[:, 1, :, None]).add_(qmeta[:, 0, :, None] * m[:, 0:1])
        est = s.mul_(2.0).sub_(qmeta[:, 2, :, None]).mul_(rsq).div_(m[:, 2:3].clamp(min=1e-12))
        if ip:
            sc = est.mul_(m[:, 1:2]).add_(qmeta[:, 3, :, None]).neg_()
        else:
            sc = est.mul_(-2.0 * m[:, 1:2]).add_(m[:, 1:2] * m[:, 1:2] + qmeta[:, 3, :, None])
        return torch.topk(sc.add_(base[lids]), k, dim=-1, largest=False)

    lib_ms = time_ms(library, reps)
    del levels, cbits
    if planes.is_cuda:  # the device time of each launch
        terms.update(launch_ms(kernel, reps))
    terms["tiles"] = tiles = scan_tiles(lof, base, live)
    if sweep:
        # the kernel over k on these inputs, across its selection switch
        # (register lists to MAX_REGISTER_K, the batch past it)
        terms["k_sweep_ms"] = {ks: time_ms(
            lambda: fs.fused_bitplane_topk(lof, planes, codes_t, meta, base, qmeta, ks, rot_dim=rot,
                                           bits=bits, kbuf=kb, inner_product=ip, chunk_valid=cv,
                                           chunk_rows=cr), reps)
            for ks in (8, 16, 32, 33, 40, 64, 96, 128) if ks <= kb}
        log(f"kernel fused_bitplane_topk ({label}) over k (register lists to k "
            f"{fs.MAX_REGISTER_K}): " + ", ".join(
                f"k {ks} {v:.4f} ms" for ks, v in terms["k_sweep_ms"].items()))
    log(f"kernel fused_bitplane_topk ({label}): ncb {ncb} ({int((live > 0).sum())} "
        f"live, {int(live.sum())} live rows), chunk {chunk}, L {L}, words {W}, bits {bits}, "
        f"k {k}, kbuf {kb}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {pairs:.4g} row-slot pairs, {ops:.4g} int8 ops "
        f"{terms['ops_ms']:.4f}, {nbytes} bytes {terms['bytes_ms']:.4f}; the CUDA-core scan's "
        f"{n_popc:.4g} popcounts {terms['popc_ms']:.4f}), bitwise equal to plain; levels "
        f"{'resident' if terms['resident_levels'] else 'streamed'}; device ms a launch "
        f"{terms.get('launch_ms', float('nan')):.4f}; tiles a live block {tiles} (PERF.md's "
        f"figure for the CUDA-core scan: {EARLIER_BITPLANE_MS.get(k, '-')} ms)")
    return {"name": "fused_bitplane_topk", "route": "cuda",
            "source": "raft_tpu_torch/csrc/fused_bitplane_topk.cu",
            "replaces": "raft_tpu/ops/fused_scan.py:781", "launches": launches,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "bound_terms": terms,
            "shape": f"{label}: ncb={ncb} chunk={chunk} L={L} words={W} bits={bits} k={k} "
                     f"kbuf={kb}"}


# ---------------------------------------------------------------------------


def device_header():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return smi[0] if smi else ""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny geometry on the CPU; prints no result and exits 3")
    ap.add_argument("--checks", action="store_true",
                    help="phases 1-3 only (build and adversarial checks); prints no result "
                         "and exits 4")
    ap.add_argument("--graph", action="store_true",
                    help="the build and the graph path only (phase 4d and its kernel rows); "
                         "prints no result and exits 5")
    ap.add_argument("--primitives", action="store_true",
                    help="the build and the primitives path only (phase 4e and its kernel "
                         "rows); prints no result and exits 6")
    ap.add_argument("--obs", action="store_true",
                    help="the build and the observability path only (phase 4f on indexes it "
                         "builds itself); prints no result and exits 7")
    ap.add_argument("--comms", action="store_true",
                    help="the build and the comms path only (phase 4g and its kernel rows); "
                         "prints no result and exits 8")
    ap.add_argument("--mnmg-ivf", action="store_true",
                    help="the build and the distributed IVF path only (phase 4h on its own "
                         "data and truth, and its kernel rows); prints no result and exits 9")
    ap.add_argument("--serve", action="store_true",
                    help="the build and the serving path only (phase 4i on indexes it builds "
                         "itself, and its kernel rows); prints no result and exits 10")
    ap.add_argument("--jobs", action="store_true",
                    help="the build and the jobs path only (phase 4j on its own data and "
                         "truth); prints no result and exits 11")
    ap.add_argument("--jobs-child", choices=("stream", "data", "scrub", "mnmg", "preempt"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--child-dir", help=argparse.SUPPRESS)
    ap.add_argument("--child-kill", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--comms-child", choices=("nccl", "gloo"), help=argparse.SUPPRESS)
    ap.add_argument("--child-port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--child-rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--apply", action="store_true",
                    help="write the tuned A/B winners of this run as "
                         "raft_tpu_torch/tuned_defaults.json, and merge the adaptive policy "
                         "where its calibration tells taus apart, before the committed-table "
                         "checks")
    ap.add_argument("--parent", metavar="DIR",
                    help="an earlier commit's checkout: build its kernels and time them beside "
                         "this checkout's on the phase-5 rows of kernels 1, 3, 4 and 7")
    ap.add_argument("--seed", type=int, default=0)
    g = ap.parse_args(argv)
    if g.comms_child:
        return comms_child(g)
    if g.rehearse:
        g.n, g.dim, g.nq, g.k, g.n_lists, g.reps, g.batch_reps, g.windows = (
            20_000, 32, 256, 10, 64, 1, 1, 1)
        # small batches below the lut threshold; a wide index past 1024 lists
        g.small_nq, g.wide_lists = 8, 1088
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
                  file=sys.stderr)
            return 1
        # kernel timings over 3 calls; search QPS over 3 windows of 10
        # back-to-back batches each
        g.n, g.dim, g.nq, g.k, g.n_lists, g.reps, g.batch_reps, g.windows = (
            1_000_000, 96, 4096, 10, 1024, 3, 10, 3)
        # bench/bench_10m_build.py:250-252 builds at 4096 lists
        g.small_nq, g.wide_lists = 128, 4096
        dev = torch.device("cuda", 0)
    if g.jobs_child:
        return jobs_child(g)
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import fused_scan as fs
    from raft_tpu_torch.ops import pq_list_scan as pls

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_all = time.perf_counter()
    card = device_header() if dev.type == "cuda" else "cpu rehearsal"
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    if dev.type == "cuda":
        t0 = time.perf_counter()
        reports = _build.build_all()
        log(f"build kernels: {time.perf_counter() - t0:.3f} s")
        for src, rep in reports.items():
            for line in rep.splitlines():
                if "Function properties for" in line:
                    log(f"  {src}: {line.strip().split('for ')[-1]}")
                elif "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")
        if g.parent:
            build_parent(g.parent)
    if g.graph:
        _, graph_rows = graph_path(g, dev, sync)
        log(f"graph path complete in {time.perf_counter() - t_all:.1f} s, {len(graph_rows)} "
            "kernel rows; no result printed")
        return 5
    if g.primitives:
        _, prim_rows = primitives_path(g, dev, sync)
        log(f"primitives path complete in {time.perf_counter() - t_all:.1f} s, "
            f"{len(prim_rows)} kernel rows; no result printed")
        return 6
    if g.obs:
        obs_path(g, dev, obs_setup(g, dev, sync), sync)
        log(f"obs path complete in {time.perf_counter() - t_all:.1f} s; no result printed")
        return 7
    if g.comms:
        _, comms_rows, _ = comms_path(g, dev, sync)
        log(f"comms path complete in {time.perf_counter() - t_all:.1f} s, {len(comms_rows)} "
            "kernel rows; no result printed")
        return 8
    if g.mnmg_ivf:
        _, ivf_rows = mnmg_ivf_path(g, dev, sync)
        log(f"mnmg ivf path complete in {time.perf_counter() - t_all:.1f} s, {len(ivf_rows)} "
            "kernel rows; no result printed")
        return 9
    if g.serve:
        _, serve_rows = serve_path(g, dev, sync, serve_setup(g, dev, sync))
        log(f"serve path complete in {time.perf_counter() - t_all:.1f} s, {len(serve_rows)} "
            "kernel rows; no result printed")
        return 10
    if g.jobs:
        jobs_path(g, dev, sync, jobs_setup(g, dev, sync))
        log(f"jobs path complete in {time.perf_counter() - t_all:.1f} s; no result printed")
        return 11
    adversarial_checks(fs, pls, dev, np.random.default_rng(g.seed + 1))
    slice_checks(dev, np.random.default_rng(g.seed + 2))
    bitplane_checks(fs, dev, np.random.default_rng(g.seed + 3))
    if g.checks:
        log(f"checks complete in {time.perf_counter() - t_all:.1f} s; no result printed")
        return 4

    # phases 4 and 5 run the JAX package's untuned program (the engines by
    # name); phases 4b and 4c read the tuned table
    with table({}), AttachClock() as attach_clock:
        fs.reset_launch_counts()
        res, captured = main_path(g, dev, fs, pls, sync)
        launches = res["launches"]
        check_truth(res, g.k, dev)
        for path, counts in launches.items():
            trim, dtype = path
            best = max(r["recall"] for r in res["rungs"]
                       if (r["trim"], r["score_dtype"]) == path)
            log(f"path trim={trim} score_dtype={dtype}: launches {counts}, best recall@{g.k} "
                f"{best:.4f}")
            if best < RECALL_GATE:
                raise AssertionError(f"trim={trim} score_dtype={dtype}: no rung reached "
                                     f"recall@{g.k} >= {RECALL_GATE} (best {best})")
        sl = slice_paths(g, dev, res, sync)
        for path, counts in sl["launches"].items():
            log(f"path {' '.join(path)}: launches {counts}")
        launches.update(sl["launches"])
        rb, rb_call = rabitq_path(g, dev, res, fs, sync)
        launches[("rabitq", "fused")] = rb["launches"]
        fl, fl_call = ivf_flat_path(g, dev, res, fs, sync)
        launches[("ivf_flat", "fused")] = fl["launches"]
        pf = prefilter_path(g, dev, res, fl, rb, sync)
        launches[("prefilter", "all")] = pf["launches"]
        pm, pm_calls = pq_modes_path(g, dev, res, fs, pls, sync)
        launches.update(pm["launches"])
        for path, counts in pm["launches"].items():
            log(f"path {' '.join(path)}: launches {counts}")
        mt, mt_calls = mutation_path(g, dev, res, fl, rb, sync)
        launches[("mutation", "all")] = mt["launches"]
        it = integrity_path(g, dev, res, fl, rb, attach_clock.seconds, sync)
        launches[("integrity", "all")] = it["launches"]
        for path, counts in launches.items():
            missing = [name for name in PATH_KERNELS[path] if counts[name] <= 0]
            if missing and dev.type == "cuda":
                raise AssertionError(f"path {path}: kernels never launched on the path: {missing}")

        def n(path, name):
            return launches[path][name]

        rows = [list_kernel_row(fs, captured["trim"], res["list_launches"]["trim"], g.reps,
                                "IVF-PQ trim, n_probes 8", sweep=True),
                flat_kernel_row(fs, captured["flat"], n(("fused", "bf16"), "fused_topk"), g.reps),
                int8_list_row(fs, captured[("fused", "int8")],
                              n(("fused", "int8"), "fused_list_topk_int8"), g.reps,
                              "IVF-PQ int8 trim, n_probes 8", sweep=True),
                fold_kernel_row(pls, captured[("pallas", "bf16")],
                                n(("pallas", "bf16"), "pq_list_scan"), g.reps,
                                "IVF-PQ bin trim, exact fold, bf16 rows, n_probes 8", "exact"),
                fold_kernel_row(pls, captured[("pallas", "int8")],
                                n(("pallas", "int8"), "pq_list_scan"), g.reps,
                                "IVF-PQ bin trim, exact fold, int8 rows, n_probes 8", "exact"),
                fold_kernel_row(pls, captured[("pallas", "int8")],
                                n(("pallas", "int8"), "pq_list_scan"), g.reps,
                                "IVF-PQ bin trim, packed fold, int8 rows, n_probes 8", "packed")]
        rows += pairwise_rows(sl, n(("knn", "l1"), "pairwise_tiled"), g.reps)
        rows.append(argmin_row(sl, n(("fused_l2_nn", "argmin"), "fused_l2_argmin"), g.reps))
        rows.append(counting_row(sl, n(("select_k", "counting"), "counting_select_min"), g.reps,
                                 g.k))
        rows.append(bitplane_row(fs, rb_call[0], n(("rabitq", "fused"), "fused_bitplane_topk"), g.reps,
                                 "rabitq n_probes 8, rerank_mult 4", sweep=True))
        gate = rb["gate"]
        rows.append(bitplane_row(fs, rb_call[1], n(("rabitq", "fused"), "fused_bitplane_topk"), g.reps,
                                 f"rabitq gate rung n_probes {gate['n_probes']}, rerank_mult "
                                 f"{gate['rerank_mult']}"))
        refine_row = list_kernel_row(fs, captured["refine"], res["list_launches"]["refine"], g.reps,
                                     "refine, chunk 1")
        rows.append(list_kernel_row(fs, fl_call, n(("ivf_flat", "fused"), "fused_list_topk"), g.reps,
                                    "IVF-Flat fused, bf16 residual store, n_probes 32",
                                    term_scale=True))
        # kernels 1, 3 and 4 on a store decoded from per-cluster codebooks, and
        # kernel 1 on the shorter lists of the index past 1024 lists
        pcl = ("per_cluster", "all")
        rows.append(list_kernel_row(fs, pm_calls["per_cluster fused bf16"],
                                    n(pcl, "fused_list_topk"), g.reps,
                                    "IVF-PQ per-cluster store, trim, n_probes 8"))
        rows.append(int8_list_row(fs, pm_calls["per_cluster fused int8"],
                                  n(pcl, "fused_list_topk_int8"), g.reps,
                                  "IVF-PQ per-cluster store, int8 trim, n_probes 8"))
        rows.append(fold_kernel_row(pls, pm_calls["per_cluster pallas bf16"],
                                    n(pcl, "pq_list_scan"), g.reps,
                                    "IVF-PQ per-cluster store, bin trim, exact fold, bf16 rows, "
                                    "n_probes 8", "exact"))
        rows.append(list_kernel_row(fs, pm_calls["wide"], n(("pq_wide", "fused"), "fused_list_topk"),
                                    g.reps, f"IVF-PQ {g.wide_lists} lists, trim, n_probes 8"))
        # kernels 1, 2 and 7 on the mutation path: the tombstoned and
        # upserted IVF-Flat store, the live truth, the tombstoned RaBitQ store
        mpath = ("mutation", "all")
        rows.append(list_kernel_row(fs, mt_calls["ivf_flat"], n(mpath, "fused_list_topk"), g.reps,
                                    f"IVF-Flat fused after mutation, {mt['rungs']['ivf_flat']}"))
        rows.append(flat_kernel_row(fs, mt_calls["truth"], n(mpath, "fused_topk"), g.reps,
                                    label="live truth after mutation, valid = live ids"))
        rows.append(bitplane_row(fs, mt_calls["ivf_rabitq"], n(mpath, "fused_bitplane_topk"),
                                 g.reps, f"rabitq after mutation, {mt['rungs']['ivf_rabitq']}"))
    wins, tuned_report = tuned_path(g, dev, res, pm, fl, rb, sync, card, g.apply)
    if g.apply:
        apply_table(wins, card)
    policy, calibration = calibrate_policy(g, dev, sync)
    if g.apply and policy is not None:
        from raft_tpu_torch.core import tuned

        tuned.merge({tuned.POLICY_KEY: policy})
        log(f"adaptive_probe_policy merged into {tuned.path()}")
    fams = adaptive_families(g, dev, res, fl, rb)
    committed_rows, _ = committed_checks(g, dev, res, pm, fl, rb, sync)
    adaptive_rows, _ = adaptive_path(g, dev, res, fams, sync)
    graph, graph_rows = graph_path(g, dev, sync)
    rows += graph_rows
    prim, prim_rows = primitives_path(g, dev, sync)
    rows += prim_rows
    obs_summary = obs_path(g, dev, obs_inputs(res, pm, fl, rb), sync)
    comms_summary, comms_rows, comms_data = comms_path(g, dev, sync)
    rows += comms_rows
    mnmg_ivf_summary, mnmg_ivf_rows = mnmg_ivf_path(g, dev, sync, comms_data)
    del comms_data
    rows += mnmg_ivf_rows
    serve_summary, serve_rows = serve_path(g, dev, sync, serve_inputs(res, fl, rb))
    rows += serve_rows
    jobs_summary = jobs_path(g, dev, sync, jobs_inputs(res))
    summary = {"build_s": res["build_s"], "truth_s": res["truth_s"], "rungs": res["rungs"],
               "breakdown": res["breakdown"], "pallas_breakdown": res["pallas_breakdown"],
               "refine_kernel": refine_row,
               "sorted_top_ab": res["sorted_top_ab"], "knn_l1": sl["knn_l1"],
               "knn_fused": sl["knn_fused"],
               "fused_l2_nn": sl["fused_l2_nn"],
               "rabitq": {key: v for key, v in rb.items() if key != "index"},
               "ivf_flat": {key: v for key, v in fl.items() if key != "index"},
               "prefilter": pf,
               "pq_modes": {key: v for key, v in pm.items() if key != "launches"},
               "mutation": mt,
               "integrity": it,
               "tuned": {"winners": wins, "ab": tuned_report, "committed": committed_rows},
               "adaptive": {"policy": policy, "calibration": calibration,
                            "rows": adaptive_rows},
               "graph": graph,
               "primitives": prim,
               "obs": obs_summary,
               "comms": comms_summary,
               "mnmg_ivf": mnmg_ivf_summary,
               "serve": serve_summary,
               "jobs": jobs_summary,
               "wall_s": time.perf_counter() - t_all}
    log("summary " + json.dumps(summary))
    if dev.type != "cuda":
        log("rehearsal complete: control flow ran on the CPU; no result printed")
        return 3
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
