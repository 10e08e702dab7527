#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rabit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which exits non-zero when it fails:

1. device  -- the card's name, count and power limit; no card is a failure.
2. build   -- compile every CUDA source (one nvcc each, in parallel),
              printing nvcc's -Xptxas -v report, and beside them the native
              engine's library (g++).
3. kernels -- each kernel against its plain PyTorch version on the same
              inputs at the headline size (1M rows x 28 features x 256
              bins, bench.py's generator, seed 0), both histogram
              encodings: hist_level at every depth of a depth-8 tree (up to
              128 nodes), the histogram for given node ids at the node ids
              of a real round's levels d = 0..7 (the last row block
              short), the histogram path's helpers (hist_prep,
              hist_partition: exactly), leaf_fit on the real round's last
              level and at depths 1, 6, 8, 13 and 16 (leaf ids exactly,
              bitwise on repeat; masses past depth 12 against an f64 sum
              over all rows, and the plain version on the first 70 row
              blocks), the final passes (route_level, route_margin_level)
              bit for bit at depths 1, 6, 8 and 13 (4096 parents), and the
              histogram path past 4096 nodes (the sorting partition): the
              partition exactly at 8192 and 16384 nodes over all rows, the
              histogram on the first 70 row blocks.  Then the three
              histogram kernels and leaf_fit at row blocks of 128 rows (on
              the first 70 x 1024 rows: the plain versions loop over the
              blocks) and 16384 rows (all rows; leaf_fit at depth 13 on
              five blocks), the i8 block scales exactly, and the histogram
              kernels at 512 bins (all rows) and 4096 bins (the first 70
              row blocks: the plain one-hot grows with the bins), bitwise
              on repeat.
4. main    -- the fused boosting round (train_round_fused) at that size,
              for bf16 and i8 and both final passes: 1 warm-up and 3 timed
              rounds, launch counts per kernel, and every level held
              teacher-forced against the plain versions.  Then GBDT.fit /
              predict as a user calls them, the fused round on a small
              input against the CPU reference round, and one depth-10
              fused round per encoding, teacher-forced (depths 14 and 15
              are the GPU tests').  The four fused rounds again on data of
              512 bins.
5. hook    -- the hook-based round: GBDT(engine_allreduce=...).fit (depth
              + 1 hook calls per tree), train_round's ms/round in bf16 and
              i8 (1 warm-up, 3 timed), every level teacher-forced, at 256
              and 512 bins.
6. leaf    -- leaf_fit on a real round's last level: its leaf ids equal
              route_level's, its leaf masses split_child_masses'.
7. dp      -- train_round_dp and train_round_dp_fused on an NCCL group of
              one, bitwise equal to train_round and train_round_fused; then
              two processes on the one card over gloo with CUDA tensors
              (rows split by elastic_shard; spawned once, they also run
              the two-process parts of phases 8-10 and 23-25, one group
              each): identical forests on both
              ranks, the single-process round's splits but for printed near
              ties; and in the same processes train_round_dp_fused exact and
              with wire_i8 (the int8-wire histogram ring), in turns, timed:
              identical forests on both ranks, the wire round's first two
              trees teacher-forced against the single-process round (near
              ties printed, leaves within rtol = atol = 1e-3).
8. engine  -- the engine matrix of tests/workers/torch_basic_worker.py
              (every dtype x op against numpy_reduce, broadcast, allgather,
              prepare_fun, checkpoints) through the port's api and
              TorchEngine: in this process on NCCL at world 1, arrays
              staged on the card, then on phase 7's two processes over
              gloo; the time of a 64-node histogram's SUM.
9. compress -- the wire codecs on the card (each codec's bytes equal
              numpy's encode, its decode numpy's, on a depth-5 level
              histogram and on a block with inf, -inf and NaN; device
              times), ring_allreduce_quantized and the fused ring on an
              NCCL group of one against the CPU and reference_allreduce,
              and api.allreduce(codec=...) through TorchEngine on NCCL at
              world 1 and on two gloo processes sharing the card
              (rabit_fused_allreduce on: the fused ring; off: the unfused
              device path, encode, one all_gather of the planes and the
              rank-order decode-fold on the card, with no run of the numpy
              host transport), each bitwise equal to reference_allreduce and
              timed beside the exact SUM.
10. hybrid -- train_round_hybrid on two processes sharing the card (phase
              7's, which run it after their dp rounds), each a worker whose local group is an NCCL group of one, the hop
              TorchEngine over gloo: identical forests, depth + 1 hops a
              tree, the first two trees phase 7's but for printed near
              ties, every tree teacher-forced; ms/round.
11. recover -- the port's fault-tolerant engine on the card: two workers of
              tests/workers/torch_gbdt_native_worker.py under the port's
              LocalCluster and tracker, rabit_engine=mock (rabit's C++
              robust engine, built with g++ in the build phase), 3 trees of
              the headline data each, every level's histogram from
              node_histograms_kernel: a clean run of train_round with the
              hop on every histogram and the leaf masses (under
              rabit_engine=robust with phase 12's leases and obs: it is
              also phase 12's clean run), and of train_round_hybrid (each
              worker an NCCL group of one); then a
              mock kill mid-tree (with obs, rabit_trace_exit=1 and rank 0
              1 s late to each tree, behind 2 relays: the trace phase 14
              merges, and phase 17's run (d)), a kill
              in the checkpoint commit window and
              a timed SIGKILL, each run's forest byte-identical to its clean
              run's, restarts equal to kills, and the clean hybrid forest
              phase 10's; ms/round, the ms of a depth-6 level histogram's
              hop beside phase 8's gloo hop, and the seconds from a death to
              the restarted worker's next commit.
12. liveness -- leases, the hang watchdog and obs on the card: phase 11's
              gbdt job under rabit_engine=robust with
              rabit_heartbeat_sec=0.5, the flight recorder and
              rabit_trace_exit=1.  A clean run (phase 11's clean gbdt run,
              whose forest phase 11's mock kills and phase 19's obs-off (a)
              match; both ranks' snapshots in the tracker's
              telemetry.json, each counting one allreduce a hop and the
              accuracy count; no lease expired; an -exit dump a rank;
              ms/round); rank 1 frozen with SIGSTOP after its first commit
              (its lease expires within (1 + LEASE_FACTOR) x 0.5 + 1 s, the
              launcher SIGKILLs and restarts it once, the forest is the
              clean run's; the detection latency and the seconds to the
              restarted worker's next commit); and dump-then-die (rank 1
              frozen with no lease, rank 0 with rabit_obs_hang_sec=1,
              rabit_hang_abort_sec=3 and the native detectors parked at 120
              s exits with 11 within 10 s, leaving -hang and -abort dumps).
13. elastic -- the elastic plane on the card: two ElasticWorkers
              (tests/workers/torch_elastic_worker.py) under the port's
              LocalCluster and tracker, heartbeats on, each histogramming
              its shard_slice of the headline bins (64 nodes, g an integer
              in [-8, 8], h = 1: exact, folded in rank order as int64) with
              node_histograms_kernel, 8 versions a run: (a) a clean run; (b)
              rank 1 SIGKILLed once version 2 is committed, no spare, one
              restart; (c) the same kill with a warm spare parked (promoted
              within one wave; the restarted worker parks as a surplus spare
              and is released); (d) rank 1 dies at version 3 with no spare
              and shrink_after_sec=1 (1 s heartbeats): the world shrinks to
              1 and grows back when a spare parks.  Every completed state bitwise the world-1
              totals of the kernel on the card (version 1 held against its
              plain version), the telemetry's n_spares_promoted, n_shrunk and
              n_grown counting the events, and the seconds from the death to
              the next commit for (b) and (c).
14. diagnose -- the diagnosis plane on the card: ElasticWorker threads of
              this process against an in-process port Tracker
              (tests/workers/torch_diag_job.py), each contribution
              node_histograms_kernel over the worker's shard of the headline
              bins (64 nodes, exact, folded on the card to [64, 2] int64 by
              a bin-position weight), launches serialized: (a) world 3, 6
              versions, clean: no incident; (b) world 3, schedule ring, 12
              versions, rank 1's frames into rank 2 delayed 0.15 s by a
              ChaosProxy: one degraded-link incident naming (1, 2) with
              link-wait-attributed evidence, the schedule repaired (a later
              ring with no 1 -> 2 hop), obs.top scraped from a thread while
              the incident is open (rendered), the scrape at the end equal
              to telemetry.json's stream, rank 2's link wait before and
              after the repair; (c) world 4, 10 versions, rank 2 0.4 s late
              to each contribution: one compute-straggler incident naming
              rank 2.  Every state bitwise the world-1 totals (version 1's
              histogram held against its plain version), the kernel launched
              workers x versions times.  Then phase 11's mid-tree kill run,
              which also ran with obs, rabit_trace_exit=1 and rank 0 a 1 s
              straggler: export_job and critical_path_report over its obs
              dir (a valid trace, (version, seqno) identities equal across
              ranks, a clock estimate a rank within 0.5 s, rank 0 first by
              arrival skew and first gating rank, the recovery's
              collectives apart, telemetry.json gaining stragglers and
              critical_path).
15. quorum -- quorum rounds on the card: ElasticWorker threads against an
              in-process port Tracker (tests/workers/torch_diag_job.py),
              phase 14's contribution (node_histograms_kernel on the card):
              (a) world 3, quorum 1.0, 6 versions: every state bitwise the
              world-1 totals, 6 quorum rounds a rank, no quorum_met; (b)
              world 3, quorum 0.6, quorum_wait 0.12, 8 versions, rank 2
              0.4 s late to each contribution up to version 3: every
              quorum_met excludes [2], a late block delivered and folded,
              the states bitwise equal and equal the totals less every
              excluded contribution never folded (the plain version's
              histogram of it), no exclusion at the last version; (c) world
              3, quorum 0.6, quorum_flag_after 3, 10 versions, rank 2 0.2 s
              late to every contribution, with quorum and without: the
              adjusted totals, rank 2 skipping contributions, a
              link_degraded via quorum with dst 2, and rank 0's commit
              cadence over versions 1-9 under half the exact run's (both
              printed in ms); (d) world 3, quorum 1.0, 3 versions, each
              contribution the unfolded histogram ([64, 28, 256, 2] int64,
              7.34 MB a block, larger than a socket's buffers), beside the
              same job on the exact path: every state bitwise the world-1
              totals of the card's histograms, both cadences and the block
              size printed with the run's seconds.  The kernel is launched
              once a contribution.
16. failover -- the HA control plane on the card: the same jobs with a
              port Standby (takeover 0.5 s, polls 0.05 s) beside a primary
              that journals: (a) world 3, 4 versions, workers 0 and 1 check
              in, the primary is killed after 0.3 s, then worker 2 starts:
              the states bitwise the totals, one tracker_failover and a
              wave on the promoted tracker, no lease_expired; (b) world 3,
              quorum 0.6 with (b)'s healing straggler, 10 versions,
              heartbeats 0.2 s, the primary killed once it has frozen 3
              records: the promoted tracker answers each of them the same,
              the states equal the totals adjusted by both trackers'
              records, every shutdown lands on the promoted tracker, no
              lease_expired; the seconds from the kill to the takeover and
              to the next commit; (c) as (a) with a file journal that the
              standby tails: the states the totals, and its state at the
              takeover bitwise read_journal + replay of the file.
17. relay  -- the reactor and the relay tier on the card, phase 15's
              contribution: (a) phase 15's job (a) (world 3, quorum 1.0,
              10 versions) on the tracker's reactor and on its threaded
              path: the states bitwise equal and the world-1 totals, the
              event-kind tallies equal, no handler thread on the reactor and
              one or more threaded; each run's wall time and rank 0's
              cadence.  (b) the same job behind 2 relays, heartbeats 0.3 s,
              the quorum reports riding the batches: the states the totals,
              2 relays up, batch messages >= world x versions, root accepts
              <= 2 + versions, no lease_expired; the relays' stats, their
              clock error and a relayed rank's clock estimate.  (c) 20
              versions behind 2 relays, relay 0 stopped 0.5 s in and a new
              one on its port 0.4 s later, rabit_diag_window_sec 0.1: no
              lease_expired, relay_lost then relay_up, one lost-relay
              incident opened and resolved, the states the totals; the
              seconds from the stop to relay_up.  (d) phase 11's mid-tree
              mock kill run (mock=1,1,2,0), which runs behind 2 relays
              (LocalCluster(relays=2)): the forest byte-identical to phase
              11's clean gbdt forest, one restart, 2 relays up, root accepts
              <= 4; its launches and the seconds from the death to the next
              commit.  (e) tools/torch_scale_sweep.py at world 256, its three
              arms: the relayed tracker accepts <= 8, the direct ones >= 256;
              each arm's accepts, handler-thread peak, heartbeat p99 and wave
              seconds.
18. chaos  -- the schedule runners (rabit_tpu_torch.chaos) on the port's
              tracker: node_histograms_kernel first at the runners' shapes
              ([n, 1] bins, n = 1 to 129, 8 bins) against its plain version
              and np.bincount, exactly; (a) run_schedule seeds 0-9, each
              converging with dense ranks; (b) run_elastic_schedule seeds
              7000-7011 with device="cuda" (kills without restart, late,
              dying and dying-promoted spares; every contribution
              node_histograms_kernel on the card, held against np.bincount,
              the first also against its plain version), each completed,
              epochs strictly rising and worlds within [1, world]; (c) one
              schedule of each fault plane with the JAX package's test
              arguments: a relay bounce (seed 7101: no spurious
              lease_expired, a relay_lost), a tracker death mid-bootstrap
              (seed 9301: no journal gap, at most one failover) and a
              straggler under quorum 0.5 with kills and spares (seed 9300).
              Each schedule's line (seed, world, spares, died, worlds seen,
              outcome, launches, seconds) and the phase's seconds.
19. delivery -- the model-delivery plane (rabit_tpu_torch.delivery) on the
              card: (a) phase 11's gbdt job behind two relays with
              rabit_delivery_publish=1 and a rabit_checkpoint_dir, rank 0 (the
              publisher) killed in the commit window of version 2; two
              subscribers poll and fetch every new version through the relays
              (the run lingers until they hold the last one): each fetched
              blob's sha256 the digest on its line, the last version's bytes
              rank 0's committed blob, its decoded forest byte-identical to
              the job's forest.npy and to phase 11's clean gbdt forest (the
              mock engine with obs off), one restart, and
              node_histograms_kernel launched once a level of every tree the
              final lives trained.
              (b) tools/torch_delivery_bench.py's swarm arm, in a process of
              its own, at tests/test_delivery.py's arguments (1000
              subscribers in a spawned process, 2 relays, 3 rounds of 0.4 s,
              64 KiB, polls every 0.15 s, 4 shards) and that test's bars
              (the tool's own exit code holds the 10^4 swarm's): the
              writer's cadence ratio >= 0.70, failed polls <= 5%, polls and
              propagation delays seen; (c) its failover arm (2 subscribers):
              the standby restores the line, every subscriber converges, no
              subscriber errors.
20. service -- the multi-tenant collective service
              (rabit_tpu_torch.service) on the card, every contribution
              node_histograms_kernel (np.full(8, v (rank + 1)) as the g plane
              of 8 rows, bins 0..7, node 0, held exactly against the closed
              form, the first also against its plain version): (a)
              tools/torch_service_bench.py's bench_service at
              tests/test_service.py's arguments (4 jobs of world 2, 2
              rounds, 0.02 s of sleep, 1 relay, a 0.25 s straggler in the
              victim job, bar 1.2, 2 pooled workers serving 2 fits): clean
              bitwise and completed, chaos neighbours bitwise and the victim
              completed, both pooled fits completed, the legacy hello's bytes
              unchanged; jobs a second and bootstrap p99 printed.  (b) a
              CollectiveService with a file journal and two admitted jobs of
              ElasticWorker threads (world 2, 6 rounds of 0.25 s) is killed
              at their second round; a Standby(service=True) promotes a CollectiveService
              that restores both jobs from the journal's stream, and both
              complete bitwise their closed form; the takeover's seconds.
              node_histograms_kernel's launches, one a contribution, in (a)
              and in (b).
21. surface -- the user surface on the card.  (a) The five guide programs
              (guide/torch_*.py) solo in this process through their
              main(argv), each output holding what tests/test_guide.py
              asserts; the hybrid one trains on the card (its local group
              an NCCL group of one), launching node_histograms_kernel once a
              level, counted.  (b) and (d) beside them: the port's
              launcher's CLI, --schedule swing --sched-mesh 2x2, runs the
              hybrid program at world 2 with rabit_engine=mock
              mock=1,1,1,0: worker 1 restarts once, both reports give the
              same train-acc and forest sha256, that forest is the one the
              same world-2 job gives in this process (two threads, the hop a
              float32 sum in rank order), and telemetry.json says swing
              with every plan swing's.  (c) tools/torch_consensus_bench.py's
              run_smoke on the card (one job per rabit_schedule value, all
              bitwise the closed form) and schedule_job with swing at world
              4 on 2x2 and world 6 on 3x2: the plans [0, 1, 3, 2] and
              [0, 1, 3, 2, 4, 5] in the schedule_planned events and in
              telemetry.json; node_histograms_kernel launched once a
              contribution.
22. recovery -- tools/torch_recovery_bench.py's in-thread modes on the card,
              every contribution node_histograms_kernel over the shard's
              [n, 1] bins (8 bins, one node, g = h = 1), each held exactly
              against np.bincount and the first of a run against its plain
              version: _failover_once at world 2 direct and world 3 behind a
              relay (tests/test_ha.py's gate arguments: niter 8, 0.12 s a
              version, the primary killed at 0.5 s, takeover 0.4 s), each
              taken over in under 3.0 s with one post-failover wave and
              exactly one lease_expired (the scheduled death's); and
              _elastic_once at world 3 with a parked spare (promoted, the
              world stays 3) and without (shrunk to 2, grown back to 3 by a
              late spare; the --elastic sweep's 16 versions of 0.15 s).
              Prints each JSON record; node_histograms_kernel's launches,
              one a contribution, a run.
23. linear -- models.linear at the headline size (X = bins / 256, f32;
              logistic, the LinearConfig defaults, 50 steps): LinearModel.fit
              on the card bitwise its train_step loop, steps 0, 25, 49 held
              teacher-forced against the CPU (tests/test_models.py's rtol
              2e-4, atol 2e-5); train_step_dp on an NCCL group of one
              bitwise the loop; then phase 7's two processes on the card
              over gloo (500k rows each; they also run phases 24 and 25's
              two-process parts): train_step_dp, every step
              teacher-forced against the single-process step, and
              LinearModel(engine_allreduce=api.allreduce) through TorchEngine,
              bitwise the dp weights; ms/step of each.
24. kmeans -- models.kmeans on the same data, K = 64, 20 iterations, the
              init drawn by KMeans(seed=0): KMeans.fit bitwise its
              train_iter loop, iterations 0, 10, 19 teacher-forced against
              the CPU (assignments equal but for near ties within
              c 2^-23 (|c.c| + 2 |x| |c|), c = 2F, counted; local_stats
              within an f32 ulp of the f64 sums); train_iter_dp on NCCL world
              1 bitwise; on the gloo world train_iter_dp (the checked
              iterations' assignments against the card's but for near ties,
              the new centers within 2^-21 of the f64 means) and
              KMeans(engine_allreduce=...) bitwise the dp centers; ms/iteration
              and the f64 one-hot segment_sum's time.
25. attention -- ring_attention and ulysses_attention at sequence 8192, 32
              heads of 128, f32 and bf16, causal and not, on an NCCL group of
              one and on the gloo world (block 4096; k/v hops and Ulysses'
              all-to-alls through host memory), each against
              reference_attention of the f32-cast inputs computed 4 heads at
              a time (tests/test_parallel.py's rtol 2e-4, atol 2e-5; bf16 adds
              the output's half-ulp rounding, 2^-8); ms a call and the
              hops' share.
26. durable -- the api's durable spill (rabit_checkpoint_dir) in two-process
              gloo jobs on the card, each fitting the linear model with a
              checkpoint a step (tests/workers/torch_durable_worker.py): a job
              stopped at version 3 of 6 and resumed by a fresh job, and again
              with rank 1's global files deleted (served by rank 0's
              broadcast), both bit for bit the weights of a job never
              stopped; the frames' bytes and the jobs' times.
27. report -- per-level times of the histogram kernels (d = 0..7, bf16
              and i8) and of the helpers, and a {"kernels": [...]} line
              with each kernel's time (CUDA events over back-to-back
              calls, "ms"; and the device time of the kernels a call
              launches, from torch.profiler, "device_ms", null where the
              profiler kept no whole profile), launches,
              bound, plain-version time and library-call time.  Its times
              are taken in a process of its own (_report_rank): late in a
              long run the card's profiler keeps only part of the launches
              (kernel_ms), and earlier its sessions would slow the launches
              of the phases after them.
28. trace  -- one warm fused and one warm hook-based bf16 round under
              profile.device_trace (a Chrome trace under --trace-dir): each
              round's wall time, the device time of the port's kernels, of
              every other kernel by the top aten op that launched it, and
              the device's idle time inside the round.

Launches are counted per path (phases 4-7, 14-18, 20-22 and 28, and 7, 10, 11, 12,
13, 17 and 19 in their processes), each run with the counts set to 0 just before it and read
just after; the phase-3 and phase-13 to phase-18, phase-20 to phase-22 comparisons and the
phase-27 timings do not count.  Phases 23-26 run no kernel of the port (their products are torch matmuls
and einsums, as in the JAX package, in f32 with TF32 off).  Each phase
prints its wall time.  The histogram kernels count in
boost.launches, their helpers (one hist_prep and one hist_partition a
histogram) in boost.helper_launches.  The last line is {"ok": true, "device":
{...}}.  The script imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import io
import importlib
import json
import multiprocessing
import os
import pickle
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

N_FEATURES = 28
N_BINS = 256
DEPTH = 6
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PROFILE_TRIES = 8           # profiles kernel_ms takes before it gives up on two whole ones
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
HIST_RTOL = 1e-5            # histograms: rtol, and atol = 1e-5 * max |bin|
GAIN_TIE = 1e-4             # a differing split must be this close in gain
DEEP = 8                    # levels of 64 and 128 nodes: the kernel checks and the report
DEEPEST = 10                # the deepest round: levels of 512 nodes, the sorting partition
FULL_PLAIN_DEPTH = 13       # levels below this: whole plain histograms; deeper: a subset
SUBSET_BLOCKS = 70          # row blocks of the plain histogram / leaf fit past that
                            # (more than 2 x leaf_fit's merge groups of 32 blocks)
LEAF_DEPTHS = (1, DEPTH, DEEP, 13, 16)  # accumulators to 8; sort and compact records at 13, 16
LARGE_NODES = (8192, 16384)  # histogram levels past the shared-memory partition
WIDE_BINS = (512, 4096)     # past one 256-bin window of the tile kernel
DP_RANKS = 2                # processes of the gloo phase, on the one card
DP_FUSED_TREES = 4          # trees of the exact and the int8-wire fused dp rounds, each
WIRE_CHECKED_TREES = 2      # of them held teacher-forced against the single-process round
CODECS = ("identity", "bf16", "bf16x2", "i8", "i8x2")
FUSED_CODECS = CODECS[1:]
LEVEL5 = 2 ** 5 * N_FEATURES * N_BINS * 2  # floats of a depth-5 level histogram
KM_K, KM_ITERS = 64, 20     # k-means: clusters and iterations
KM_CHECKED = (0, 10, KM_ITERS - 1)  # iterations held teacher-forced against the CPU
LIN_CHECKED = (0, 25, 49)   # linear steps held teacher-forced against the CPU
LIN_TOL = (2e-4, 2e-5)      # tests/test_models.py's linear rtol, atol
ATT_SEQ, ATT_HEADS, ATT_DIM = 8192, 32, 128  # a 7B-class decoder's heads
ATT_REF_HEADS = 4           # heads a slice of the head-sliced reference
ATT_F32 = (2e-4, 2e-5)      # tests/test_parallel.py's attention rtol, atol
DURABLE_STEPS, DURABLE_STOP = 6, 3
RECOVER_TREES = 3           # trees a run of the recover phase
RECOVER_PAUSE = 1.0         # s before each tree of the preempted run
# s rank 0 sleeps before each tree of the traced kill run: of its trees only
# the last is both ranks' and outside the recovery, and the restarted life's
# first kernel calls skew the trees before it by up to ~0.4 s in all
TRACE_STRAGGLE = 1.0
COMMIT_1 = re.compile(r"\[\d+\] commit version=1 ")  # a worker's first commit, as it prints it
LIVE_HB = 0.5               # rabit_heartbeat_sec of the liveness phase
#: the liveness phase's worker arguments (the recover phase's clean gbdt run's too; the
#: frozen run adds a pause before each tree, where its freeze lands)
LIVE_ARGS = (f"rabit_heartbeat_sec={LIVE_HB}", "rabit_trace_exit=1")
HANG_PAUSE = 0.5            # s before each tree of the dump-then-die run
ELASTIC_NODES = 64          # the elastic job's histogram: a depth-6 level
ELASTIC_VERSIONS = 8        # versions a run of the elastic phase
ELASTIC_SLEEP = 0.3         # s a version waits before its contribution (the kill lands mid-job)
ELASTIC_HB = 0.5            # its workers' heartbeat interval
ELASTIC_SHRINK = 1.0        # shrink_after_sec of the shrink run
# its workers' heartbeat interval: the dead worker's process must be gone
# before its lease (two intervals) lapses, or the lease monitor SIGKILLs a
# worker that has no restart left, and a process that held the card is
# slow to end
ELASTIC_SHRINK_HB = 1.0
DIAG_VERSIONS = {"clean": 6, "slow link": 12, "straggler": 10}  # versions a job
DIAG_SLEEP = 0.1            # s a diagnose-phase worker waits before each contribution
DIAG_SLOW = (1, 2, 0.15)    # the slow link of run (b): src, dst, s a frame
DIAG_STRAGGLER = (2, 0.4)   # the compute straggler of run (c): rank, s a version
QUORUM_SLEEP = 0.01         # s a quorum-phase worker waits before each contribution
QUORUM_VERSIONS = {"full": 6, "healing": 8, "persistent": 10, "wide": 3}
QUORUM_HEALING = (2, 0.4, 3)  # run (b)'s straggler: rank, s a version, up to this version
QUORUM_PERSISTENT = (2, 0.2)  # run (c)'s: rank, s more than the others before each version
FAILOVER_VERSIONS = {"mid-wave": 4, "mid-run": 10, "file": 4}
FAILOVER_SLEEP = 0.05       # s a failover-phase worker waits before each contribution
FAILOVER_KILL = 0.3         # s after the start the primary dies in runs (a) and (c)
FAILOVER_FREEZES = 3        # quorum records the primary freezes before run (b) kills it
RELAY_VERSIONS = {"serving": 10, "relayed": 10, "bounce": 20}  # versions a relay-phase job
RELAY_HB = 0.3              # heartbeat interval of the relayed jobs
RELAY_BOUNCE = (0.5, 0.4)   # relay 0 stopped this many s in, a new one this many s later
RELAY_BOUNCE_SLEEP = 0.1    # s a bounce-run worker waits before each contribution
RELAY_DIAG_WINDOW = "0.1"   # rabit_diag_window_sec of the bounce run
RELAY_WORLD = 256           # the scale sweep's world
CHAOS_BOOT_SEEDS = range(10)             # run_schedule seeds of the chaos phase's run (a)
CHAOS_ELASTIC_SEEDS = range(7000, 7012)  # run_elastic_schedule seeds of its run (b)
CHAOS_SHAPES = (1, 8, 24, 32, 127, 129)  # rows of the [n, 1] bin matrices it checks first
#: the service phase's (a): tests/test_service.py's bench gate arguments
SERVICE_BENCH = dict(n_jobs=4, world=2, niter=2, sleep=0.02, relays=1, chaos="straggler",
                     straggle=0.25, bar=1.2, pool=2, pool_jobs=2, deadline=40.0,
                     assert_isolation=False)
SERVICE_TAKEOVER_ROUNDS = 6   # its (b): rounds a job, tests/test_service.py's takeover
SERVICE_TAKEOVER_SLEEP = 0.25  # s before each contribution
RECOVERY_FAILOVER = dict(niter=8, iter_sleep=0.12, kill_at=0.5, takeover_sec=0.4)
RECOVERY_GROW = dict(niter=16, iter_sleep=0.15)  # the --elastic sweep's grow-back job

#: the surface phase: the guide programs of (a) and what tests/test_guide.py
#: asserts of each one's solo output
SURFACE_GUIDES = {"basic": "after-allreduce-sum", "broadcast": "'hello world': 100",
                  "lazy_allreduce": "run prepare function", "durable_resume": "final weights",
                  "hybrid_gbdt": "hybrid gbdt: 3 trees"}
SURFACE_KILL = "mock=1,1,1,0"  # (b): worker 1 dies in version 1's level-1 hop
SURFACE_LAUNCHER = ("--schedule", "swing", "--sched-mesh", "2x2")  # (d)
#: (c)'s jobs: the mesh spec, the world and the swing ring it plans
SURFACE_MESHES = (("2x2", 4, [0, 1, 3, 2]), ("3x2", 6, [0, 1, 3, 2, 4, 5]))
SURFACE_VERSIONS = 2        # versions a job of (c)
RELAYS = 2                  # relays in front of the recover phase's traced kill and delivery's job
DELIVERY_SUBS = 2           # subscribers of the delivery phase's run (a), one a relay
DELIVERY_KILL = 2           # the version in whose commit window run (a) kills the publisher
                            # (mock= names the version the engine holds before it)
DELIVERY_POLL = 0.05        # s between their polls
DELIVERY_SWARM = ("--subs", "1000", "--relays", "2", "--rounds", "3", "--round-sec", "0.4",
                  "--size", "65536", "--poll-sec", "0.15", "--shards", "4")  # tests/test_delivery.py's
DELIVERY_FAILOVER = dict(n_subs=2, rounds=2, round_sec=0.1, size=8192, poll_sec=0.05)
REPLACES = {
    "hist_level0": "rabit_tpu/ops/boost.py:341",
    "hist_level": "rabit_tpu/ops/boost.py:374",
    "route_level": "rabit_tpu/ops/boost.py:290",
    "route_margin_level": "rabit_tpu/ops/boost.py:260",
    "node_histograms_kernel": "rabit_tpu/ops/hist.py:157",
    "leaf_fit": "rabit_tpu/ops/boost.py:413",
    # the histogram path's helpers: the routing, i8 block scale and encoding
    # that the TPU kernels do inside _level_kernel (and _level0_kernel,
    # _hist_kernel), split out on the card
    "hist_prep": "rabit_tpu/ops/boost.py:374",
    "hist_partition": "rabit_tpu/ops/boost.py:374",
}
SOURCE = {
    "hist_level0": "rabit_tpu_torch/csrc/hist.cu",
    "hist_level": "rabit_tpu_torch/csrc/hist.cu",
    "route_level": "rabit_tpu_torch/csrc/route.cu",
    "route_margin_level": "rabit_tpu_torch/csrc/route.cu",
    "node_histograms_kernel": "rabit_tpu_torch/csrc/hist.cu",
    "leaf_fit": "rabit_tpu_torch/csrc/route.cu",
    "hist_prep": "rabit_tpu_torch/csrc/hist.cu",
    "hist_partition": "rabit_tpu_torch/csrc/hist.cu",
}
HELPERS = ("hist_prep", "hist_partition")
HIST_KERNELS = ("hist_level0", "hist_level", "node_histograms_kernel")


class PhaseFailed(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def make_data(n_rows, seed=0, n_bins=N_BINS):
    """bench.py's Higgs-shaped generator: pre-binned features and labels
    (at another bin count the same labels' shape, bins scaled)."""
    rng = np.random.RandomState(seed)
    xb = rng.randint(0, n_bins, size=(n_rows, N_FEATURES), dtype=np.int32)
    logits = (xb[:, 0] > n_bins // 2).astype(np.float32) + 0.01 * xb[:, 1] * (N_BINS / n_bins)
    y = (logits + rng.randn(n_rows) > 1.5).astype(np.float32)
    return xb, y


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the card: CUDA events around ``reps``
    calls after one warm-up call."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _mean_ms(fn, reps: int = 5) -> float:
    """Mean host ms of ``fn`` after one warm-up call (a host-to-host
    collective: its result is on the host when it returns)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def kernel_ms(torch, fn, reps: int, kernel: str = "", skip: str | None = None) -> dict:
    """Device time per call of ``fn``, kernel by kernel: every kernel, copy
    and fill it puts on the card whose name holds ``kernel`` and not
    ``skip``, from torch.profiler over ``reps`` calls after one warm-up
    call.  Host time between launches is not in it, as it is in cuda_ms.

    On the card the profiler at times keeps only some of the launches (late
    in a long run, and after a trace: a kernel counted fewer times than the
    calls launched it, or a profile empty), and a sum over what it kept,
    divided by ``reps``, reads under the kernels' true time.  So profiles are taken until two in a row
    agree on every kernel's launch count, each a whole multiple of
    ``reps``, up to PROFILE_TRIES."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prev = None
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, counts = {}, {}
        for e in prof.key_averages():
            us = (getattr(e, "self_device_time_total", 0)
                  or getattr(e, "self_cuda_time_total", 0))
            if (us > 0 and e.device_type.name == "CUDA" and kernel in e.key
                    and (skip is None or skip not in e.key)):
                out[e.key], counts[e.key] = us / reps / 1e3, e.count
        if counts == prev and all(n % reps == 0 for n in counts.values()):
            return out
        prev = counts
    raise PhaseFailed(f"torch.profiler kept no two whole profiles in a row of {reps} "
                      f"calls in {PROFILE_TRIES} ({kernel or 'every kernel'})")


def dev_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def device_ms(torch, fn, reps: int, kernel: str = "", skip: str | None = None) -> float:
    """Device time per call of ``fn``: the sum of ``kernel_ms``."""
    ms = sum(kernel_ms(torch, fn, reps, kernel, skip).values())
    require(ms > 0, "torch.profiler saw no device time")
    return ms


ROUTE_DEPTHS = (1, DEPTH, DEEP, 13)  # 13: the deepest final pass the fused round reaches


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of nvcc's -Xptxas -v report: the kernel's name
    and template arguments, registers, shared memory and spills."""
    out, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?\d([a-z][a-z_]*_kernel)(I\w+?EE)?", line)
        if m:
            name, spills = m.group(1) + (m.group(2) or ""), ""
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
    return out


def hist_err(got, ref) -> float:
    """Largest |got - ref| / (atol + rtol*|ref|), atol = 1e-5 * max |ref|;
    the histogram passes when this is <= 1."""
    atol = HIST_RTOL * float(ref.abs().max())
    lim = atol + HIST_RTOL * ref.abs()
    return float(((got - ref).abs() / lim.clamp_min(1e-30)).max())


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def dump_kinds(path: str) -> list[str]:
    """The event kinds of a flight dump, its header line first."""
    with open(path) as f:
        return [json.loads(line)["kind"] for line in f if line.strip()]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(target, world: int, *args) -> list[dict]:
    """``world`` spawned processes ``target(rank, world, tmp, *args)``; each
    writes rank{rank}.npz into the temp dir tmp.  Returns them in rank
    order; fails unless every process exits 0."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target, args=(r, world, tmp, *args))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=600)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        codes = [p.exitcode for p in procs]
        require(codes == [0] * world, f"{target.__name__} processes exited {codes}")
        return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)]


def worker_path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "workers",
                        f"{name}.py")


def load_module(name: str, path: str):
    """The file at ``path`` as a module named ``name``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker_module(name: str):
    """tests/workers/<name>.py as a module."""
    return load_module(name, worker_path(name))


def scale_sweep_module():
    """tools/torch_scale_sweep.py of this checkout as a module."""
    return load_module("torch_scale_sweep", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tools", "torch_scale_sweep.py"))


def basic_worker():
    """tests/workers/torch_basic_worker.py, whose run_matrix is the engine
    matrix (each result against numpy_reduce of the ranks' inputs)."""
    return worker_module("torch_basic_worker")


def engine_args(device: str, port: int, world: int, rank: int) -> list[str]:
    return ["rabit_engine=torch", f"rabit_torch_device={device}",
            "rabit_torch_master_addr=127.0.0.1", f"rabit_torch_master_port={port}",
            f"rabit_torch_world_size={world}", f"rabit_torch_rank={rank}"]


def engine_matrix(api, worker) -> dict:
    """The engine matrix on the engine api runs, then the mean ms of an f32
    SUM the size of a depth-6 level's histogram (64 nodes x 28 x 256 x 2),
    host staging included."""
    t0 = time.perf_counter()
    try:
        worker.run_matrix(256)
    except worker.CheckFailed as e:
        raise PhaseFailed(str(e)) from e
    matrix_s = time.perf_counter() - t0
    a = np.ones(64 * N_FEATURES * N_BINS * 2, np.float32)
    return {"matrix_s": matrix_s, "hop_ms": _mean_ms(lambda: api.allreduce(a, api.SUM), 10)}


def _hybrid_part(rank: int, world: int, port: int, n_rows: int, n_trees: int) -> dict:
    """One worker of the hybrid phase: its local group an NCCL group of one
    (this process, on the card), the hop between workers the port's
    TorchEngine over gloo; train_round_hybrid on this rank's elastic shard.
    Returns the forest, the launches, the hops and each round's ms."""
    import torch
    import torch.distributed as dist

    from rabit_tpu_torch import api
    from rabit_tpu_torch.models import gbdt
    from rabit_tpu_torch.ops import boost

    torch.cuda.set_device(0)
    api.init(engine_args("cpu", port, world, rank))
    try:
        local = [dist.new_group([r], backend="nccl") for r in range(world)][rank]
        xb, y = make_data(n_rows, seed=0)
        xs, ys = gbdt.elastic_shard(xb, y, world, rank)
        xs, ys = torch.as_tensor(xs, device="cuda"), torch.as_tensor(ys, device="cuda")
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES, n_trees=n_trees, depth=DEPTH,
                              n_bins=N_BINS)
        hops = []

        def hop(a):
            hops.append(a.shape)
            return api.allreduce(a, api.SUM)

        state = gbdt.init_state(cfg, len(ys), "cuda")
        boost.launches.clear()
        ms = []
        for _ in range(n_trees):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = gbdt.train_round_hybrid(state, xs, ys, cfg, local, hop)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        forest = gbdt.forest_to_numpy(state.forest)
        return dict(feature=forest.feature, threshold=forest.threshold, leaf=forest.leaf,
                    launches=boost.launches["node_histograms_kernel"], hops=len(hops),
                    ms=np.array(ms))
    finally:
        api.finalize()


def _gloo_world_rank(rank: int, world: int, tmp: str, n_rows: int, n_trees: int, port: int,
                     hybrid_trees: int, engine_port: int) -> None:
    """One process of the gloo world of phases 7-10 and 23-25, spawned once
    (one start of DP_RANKS processes for all of them): the dp rounds
    (_dp_part), the hybrid round (_hybrid_part, "hybrid/"), the engine
    matrix through TorchEngine with host arrays ("engine/"), the compress
    phase's part (_compress_part, "compress/") and the models' and
    attention's part (_slice_part, "slice/"), each on a group of its own
    that it takes down.  Writes every part's results."""
    from rabit_tpu_torch import api

    out = _dp_part(rank, world, tmp, n_rows, n_trees)
    out.update({f"hybrid/{k}": v
                for k, v in _hybrid_part(rank, world, port, n_rows, hybrid_trees).items()})
    api.init(engine_args("cpu", engine_port, world, rank))
    try:
        out.update({f"engine/{k}": v for k, v in engine_matrix(api, basic_worker()).items()})
    finally:
        api.finalize()
    out.update({f"compress/{k}": v
                for k, v in _compress_part(rank, world, tmp, "store-compress").items()})
    out.update({f"slice/{k}": v
                for k, v in _slice_part(rank, world, tmp, n_rows, "store-slice").items()})
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


def _dp_part(rank: int, world: int, tmp: str, n_rows: int, n_trees: int) -> dict:
    """The dp part of a process of phase 7's gloo world: train_round_dp
    with CUDA tensors on this rank's elastic shard, then
    train_round_dp_fused exact and over the int8 wire; returns the forests,
    launch counts, times and the wire's summed histograms."""
    import torch
    import torch.distributed as dist

    from rabit_tpu_torch.models import gbdt
    from rabit_tpu_torch.ops import boost

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        xb, y = make_data(n_rows, seed=0)
        xs, ys = gbdt.elastic_shard(xb, y, world, rank)
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES, n_trees=n_trees, depth=DEPTH,
                              n_bins=N_BINS)
        xs, ys = torch.as_tensor(xs, device="cuda"), torch.as_tensor(ys, device="cuda")
        state = gbdt.init_state(cfg, len(ys), "cuda")
        boost.launches.clear()
        for _ in range(n_trees):
            state = gbdt.train_round_dp(state, xs, ys, cfg)
        forest = gbdt.forest_to_numpy(state.forest)
        out = dict(feature=forest.feature, threshold=forest.threshold, leaf=forest.leaf,
                   launches=boost.launches["node_histograms_kernel"])
        # train_round_dp_fused, exact and over the int8 wire, in turns
        # (exact, wire, wire, exact, ...), each round timed
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES, n_trees=DP_FUSED_TREES, depth=DEPTH,
                              n_bins=N_BINS)
        xs3, _ = boost.block_rows(xs)
        from rabit_tpu_torch import parallel

        ring, wired = parallel.ring_allreduce_quantized, []

        def recording_ring(x, group=None, **kw):  # keeps what the wire summed
            out = ring(x, group, **kw)
            if len(wired) < WIRE_CHECKED_TREES * DEPTH:
                wired.append(out)
            return out

        parallel.ring_allreduce_quantized = recording_ring
        states = {w: gbdt.init_state(cfg, len(ys), "cuda") for w in (False, True)}
        ms = {False: [], True: []}
        boost.launches.clear()
        for t in range(DP_FUSED_TREES):
            for wire in ((False, True) if t % 2 == 0 else (True, False)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[wire] = gbdt.train_round_dp_fused(states[wire], xs3, ys, cfg,
                                                         wire_i8=wire)
                torch.cuda.synchronize()
                ms[wire].append((time.perf_counter() - t0) * 1e3)
        for wire, key in ((False, "exact"), (True, "wire")):
            forest = gbdt.forest_to_numpy(states[wire].forest)
            out.update({f"{key}_feature": forest.feature, f"{key}_threshold": forest.threshold,
                        f"{key}_leaf": forest.leaf, f"{key}_ms": np.array(ms[wire])})
        out["fused_launches"] = json.dumps(dict(boost.launches))
        out.update({f"wired_{i}": a.reshape(2 ** (i % DEPTH), N_FEATURES, N_BINS, 2)
                    .cpu().numpy() for i, a in enumerate(wired)})
        parallel.ring_allreduce_quantized = ring
        return out
    finally:
        dist.destroy_process_group()


def _compress_part(rank: int, world: int, tmp: str, store: str) -> dict:
    """The compress phase's part of a process of the gloo world on the
    card: the port's TorchEngine adopts this program's gloo group with
    rabit_torch_device=cuda (codec work on the card, hops through host
    memory), and api.allreduce(codec=...) of a depth-5 level histogram's
    size runs with rabit_fused_allreduce 1 (the fused ring) and 0 (the
    unfused device path), each result against reference_allreduce bit for
    bit, each time beside the exact SUM's and the numpy host transport's
    (called directly); the api's runs of the host transport are counted
    (none is due)."""
    import torch
    import torch.distributed as dist

    from rabit_tpu_torch import api, compress
    from rabit_tpu_torch.parallel import wire_device

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, store), world),
                            rank=rank, world_size=world)
    rng = np.random.RandomState(7)
    parts = [(rng.randn(LEVEL5) * 50).astype(np.float32) for _ in range(world)]
    out = {"wire": str(wire_device(None, "cuda")), "backend": dist.get_backend()}
    host_runs = []
    host_allreduce = compress.host_allreduce
    compress.host_allreduce = lambda *a, **kw: host_runs.append(1) or host_allreduce(*a, **kw)
    try:
        for mode in ("1", "0"):
            api.init(["rabit_engine=torch", "rabit_torch_device=cuda",
                      f"rabit_fused_allreduce={mode}"])
            try:
                out[f"exact_ms/{mode}"] = _mean_ms(lambda: api.allreduce(parts[rank], api.SUM))
                for name in FUSED_CODECS:
                    got = api.allreduce(parts[rank], api.SUM, codec=name)
                    ref = compress.reference_allreduce(parts, api.SUM, name)
                    out[f"equal/{mode}/{name}"] = got.tobytes() == ref.tobytes()
                    out[f"fused/{mode}/{name}"] = api.get_engine().fused_active(
                        compress.get_codec(name), api.SUM)
                    out[f"ms/{mode}/{name}"] = _mean_ms(
                        lambda: api.allreduce(parts[rank], api.SUM, codec=name))
                    if mode == "0":  # the host transport the device path replaced
                        out[f"ms/host/{name}"] = _mean_ms(lambda: host_allreduce(
                            api.get_engine(), parts[rank], api.SUM, compress.get_codec(name),
                            deflate=compress.policy().wire_deflate))
            finally:
                api.finalize()
        out["host_runs"] = len(host_runs)
        return out
    finally:
        compress.host_allreduce = host_allreduce
        dist.destroy_process_group()


# -- phases 23-26: the linear and k-means models, attention, the durable spill ----


def slice_data(n_rows: int):
    """The headline data as the linear and k-means models take it: X =
    bins / 256 (f32, [n, 28]) and the labels."""
    xb, y = make_data(n_rows, seed=0)
    return xb.astype(np.float32) / 256, y


def attention_inputs(torch, dtype, seed: int = 11):
    """Seeded global q, k, v ``[ATT_SEQ, ATT_HEADS, ATT_DIM]`` made on the
    card (the same on every process of the card)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(ATT_SEQ, ATT_HEADS, ATT_DIM, generator=g, device="cuda").to(dtype)
            for _ in range(3)]


def reference_rows(ring, q, k, v, causal: bool, rows: slice):
    """reference_attention of the f32-cast inputs, the query rows ``rows``,
    computed ATT_REF_HEADS heads at a time (the whole one would hold 8.6 GB
    of scores a tensor)."""
    import torch

    out = []
    for h in range(0, q.shape[1], ATT_REF_HEADS):
        hs = slice(h, h + ATT_REF_HEADS)
        out.append(ring.reference_attention(q[:, hs].float(), k[:, hs].float(),
                                            v[:, hs].float(), causal=causal)[rows])
    return torch.cat(out, 1)


def tol_err(got, want, rtol: float, atol: float) -> float:
    """Largest |got - want| / (atol + rtol |want|): within tolerance <= 1."""
    return float(((got.float() - want).abs() / (atol + rtol * want.abs())).max())


def att_tol(torch, dtype) -> tuple[float, float]:
    """(rtol, atol) of attention against the f32 reference of the f32-cast
    inputs: tests/test_parallel.py's in f32; in bf16 the output's rounding,
    half an ulp (2^-8 of the value), on top."""
    return ATT_F32 if dtype == torch.float32 else (2.0 ** -8 + ATT_F32[0], ATT_F32[1])


def attention_cases(torch, ring, rank: int, world: int, out: dict) -> None:
    """ring_attention and ulysses_attention on this rank's sequence block
    over the default group, f32 and bf16, causal and not: each output's
    tol_err against the head-sliced reference and its ms a call (rank
    ``rank`` of ``world``); then the host-staged hops alone: one ring hop of
    the f32 k and v blocks, and Ulysses' four all-to-alls."""
    from rabit_tpu_torch.parallel.collectives import ring_shift
    from rabit_tpu_torch.parallel.ring import _all_to_all

    block = ATT_SEQ // world
    rows = slice(rank * block, (rank + 1) * block)
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = attention_inputs(torch, dtype)
        qb, kb, vb = q[rows], k[rows], v[rows]
        rtol, atol = att_tol(torch, dtype)
        for causal in (False, True):
            want = reference_rows(ring, q, k, v, causal, rows)
            for fn in ("ring_attention", "ulysses_attention"):
                call = lambda: getattr(ring, fn)(qb, kb, vb, causal=causal)
                got = call()
                require(got.dtype == dtype and got.shape == qb.shape,
                        f"{fn} gave {got.dtype} {tuple(got.shape)}")
                key = f"{fn}/{dname}/{'causal' if causal else 'full'}"
                out[f"err/{key}"] = tol_err(got, want, rtol, atol)
                out[f"ms/{key}"] = cuda_ms(torch, call, 2)
            del want
        if world > 1:
            if dname == "f32":  # the ring rotates k and v as f32 in either dtype
                kf, vf = kb.float(), vb.float()
                out["hop_ms/ring"] = cuda_ms(torch, lambda: ring_shift((kf, vf)), 2)
            part = qb.reshape(world, block, ATT_HEADS // world, ATT_DIM)
            out[f"hop_ms/ulysses/{dname}"] = cuda_ms(
                torch, lambda: [_all_to_all(part, None) for _ in range(4)], 2)
        del q, k, v, qb, kb, vb
        torch.cuda.empty_cache()


def _slice_part(rank: int, world: int, tmp: str, n_rows: int, store: str) -> dict:
    """The models' and attention's part of a process of the gloo world
    (phases 23-25), on the card, on this rank's elastic shard: linear.train_step_dp and kmeans.train_iter_dp
    over the group (every step's weights; the iterations' centers, and the
    assignments at the checked ones), the engine-hook fits (LinearModel,
    KMeans with engine_allreduce = api.allreduce through TorchEngine, which
    adopts the group), each timed; then attention_cases.  Returns the
    results."""
    import torch
    import torch.distributed as dist

    from rabit_tpu_torch import api, elastic
    from rabit_tpu_torch.models import kmeans, linear
    from rabit_tpu_torch.parallel import ring

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # torch's default, made explicit
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, store), world),
                            rank=rank, world_size=world)
    try:
        X, y = slice_data(n_rows)
        init = kmeans.KMeans(KM_K, 0, seed=0).fit(X).centers  # KMeans(seed=0)'s draw
        rows = elastic.shard_slice(n_rows, world, rank)
        Xs, ys = (torch.as_tensor(a[rows], device="cuda") for a in (X, y))
        out = {}
        cfg = linear.LinearConfig(n_features=N_FEATURES)
        state = linear.init_state(cfg)
        linear.train_step_dp(state, Xs, ys, cfg)  # warm-up: the first product and hop
        kmeans.train_iter_dp(torch.as_tensor(init, device="cuda"), Xs)
        ws = [state.w.cpu().numpy()]
        t0 = time.perf_counter()
        for _ in range(cfg.n_steps):
            state = linear.train_step_dp(state, Xs, ys, cfg)
            ws.append(state.w.cpu().numpy())
        out["lin_dp_ms"] = (time.perf_counter() - t0) * 1e3 / cfg.n_steps
        out["lin_dp_w"] = np.stack(ws)
        centers, cs = torch.as_tensor(init, device="cuda"), [init]
        t0 = time.perf_counter()
        for i in range(KM_ITERS):
            if i in KM_CHECKED:
                out[f"km_dp_assign/{i}"] = kmeans.assign(Xs, centers).cpu().numpy()
            centers = kmeans.train_iter_dp(centers, Xs)
            cs.append(centers.cpu().numpy())
        out["km_dp_ms"] = (time.perf_counter() - t0) * 1e3 / KM_ITERS
        out["km_dp_c"] = np.stack(cs)
        api.init(["rabit_engine=torch", "rabit_torch_device=cuda"])
        try:
            hook = lambda a: api.allreduce(a, api.SUM)
            t0 = time.perf_counter()
            out["lin_hook_w"] = linear.LinearModel(hook).fit(X[rows], y[rows]).w
            out["lin_hook_ms"] = (time.perf_counter() - t0) * 1e3 / cfg.n_steps
            t0 = time.perf_counter()
            out["km_hook_c"] = kmeans.KMeans(KM_K, KM_ITERS, engine_allreduce=hook).fit(
                X[rows], init_centers=init).centers
            out["km_hook_ms"] = (time.perf_counter() - t0) * 1e3 / KM_ITERS
        finally:
            api.finalize()
        del Xs, ys
        attention_cases(torch, ring, rank, world, out)
        return out
    finally:
        dist.destroy_process_group()


def _durable_rank(proc: int, n_procs: int, tmp: str, n_rows: int, jobs: str) -> None:
    """One process of the durable phase: rank proc % 2 of job proc // 2 of
    ``jobs`` (JSON: [checkpoint dir, steps, stop at] a job), a gloo job of
    two processes on the card through the port's api and TorchEngine with
    rabit_checkpoint_dir, running tests/workers/torch_durable_worker.py's
    job (the linear model, a checkpoint a step, rank-local models) on the
    headline data.  Writes the job's results and its wall time."""
    import torch
    import torch.distributed as dist

    from rabit_tpu_torch import api

    job, rank = divmod(proc, 2)
    ckpt, niter, stop_at = json.loads(jobs)[job]
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, f"job{job}.store"), 2), rank=rank, world_size=2)
    try:
        X, y = slice_data(n_rows)
        worker = worker_module("torch_durable_worker")
        api.init(["rabit_engine=torch", "rabit_torch_device=cuda",
                  f"rabit_checkpoint_dir={ckpt}"])
        try:
            t0 = time.perf_counter()
            out = worker.job(X, y, niter, stop_at, local=True, device="cuda")
            out["wall_s"] = time.perf_counter() - t0
        except worker.CheckFailed as e:
            raise PhaseFailed(str(e)) from e
        finally:
            api.finalize()
        np.savez(os.path.join(tmp, f"rank{proc}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _report_rank(rank: int, world: int, tmp: str, n_rows: int) -> None:
    """The report's timings (Smoke.measure) on fresh data in a process of
    their own; writes them as JSON."""
    import torch

    from rabit_tpu_torch.models import gbdt
    from rabit_tpu_torch.ops import boost, hist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch, boost, hist, gbdt, n_rows)
    smoke.levels = smoke.real_levels()
    smoke.measure()
    fields = ("ms", "device_ms", "plain_ms", "library_ms", "bound")
    np.savez(os.path.join(tmp, f"rank{rank}.npz"),
             report=json.dumps({k: getattr(smoke, k) for k in fields}))


@contextlib.contextmanager
def nccl_group_of_one():
    """This process as an NCCL group of one (a FileStore in a temp dir)."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


class Smoke:
    def __init__(self, torch, boost, hist, gbdt, n_rows: int, device="cuda",
                 n_bins: int = N_BINS):
        self.torch, self.boost, self.hist, self.gbdt = torch, boost, hist, gbdt
        self.dev = torch.device(device)
        self.n_rows = n_rows
        self.n_bins = n_bins
        xb, y = make_data(n_rows, seed=0, n_bins=n_bins)
        self.xb = torch.as_tensor(xb, device=self.dev)
        self.y = torch.as_tensor(y, device=self.dev)
        self.xb3, _ = boost.block_rows(self.xb)
        # gradients at a seeded, non-trivial margin
        rng = np.random.RandomState(1)
        margin = torch.as_tensor(rng.randn(n_rows).astype(np.float32) * 0.5,
                                 device=self.dev)
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES)
        self.g, self.h = gbdt.gradients(cfg, margin, self.y)
        g, h = self.g, self.h
        self.g3, _ = boost.block_rows(g)
        self.h3, _ = boost.block_rows(h)
        self.margin3, _ = boost.block_rows(margin)
        self.err = {k: 0.0 for k in REPLACES}
        self.ms = {}
        self.plain_ms = {}
        self.library_ms = {}
        self.bound = {}
        self.device_fns = {k: [] for k in REPLACES}  # calls whose mean is device_ms
        self.launches = {k: 0 for k in REPLACES}
        self.slice_ms = {}

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def route(self, node, feat, thr):
        """Node ids one level down (train_round's routing): right iff the
        row's bin of its node's feature is above the threshold."""
        p = node.long()
        xv = self.xb.gather(1, feat.long()[p][:, None])[:, 0]
        return node * 2 + (xv > thr[p]).to(self.torch.int32)

    def clear_counts(self):
        self.sync()
        self.boost.launches.clear()
        self.boost.helper_launches.clear()

    def read_counts(self, n_hist: int):
        """The kernels' launch counts since clear_counts, added to the
        report's launches; the helpers must have run once a histogram."""
        self.sync()
        counts = dict(self.boost.launches)
        helpers = dict(self.boost.helper_launches)
        want = {k: n_hist for k in HELPERS} if n_hist else {}
        require(helpers == want, f"helper launches {helpers}, expected {want}")
        for k, v in {**counts, **helpers}.items():
            self.launches[k] += v
        return counts

    def path(self, fn):
        """Run one path with every launch count set to 0 just before it and
        read just after; adds them to the report's launches."""
        self.clear_counts()
        out = fn()
        self.sync()
        n_hist = sum(v for k, v in self.boost.launches.items() if k in HIST_KERNELS)
        return out, self.read_counts(n_hist)

    # -- phase 3 ------------------------------------------------------------------
    def level_inputs(self, d: int):
        """Seeded parent node ids and split tables for level d."""
        torch, n_prev = self.torch, 2 ** (d - 1)
        gen = torch.Generator(device=self.dev).manual_seed(100 + d)
        node3 = torch.randint(0, n_prev, self.g3.shape, generator=gen,
                              device=self.dev, dtype=torch.int32)
        feat = torch.randint(0, N_FEATURES, (n_prev,), generator=gen,
                             device=self.dev, dtype=torch.int32)
        thr = torch.randint(0, self.n_bins, (n_prev,), generator=gen,
                            device=self.dev, dtype=torch.int32)
        return node3, feat, thr

    def check_kernels(self):
        torch, boost = self.torch, self.boost
        xb3, g3, h3 = self.xb3, self.g3, self.h3
        for i8 in (False, True):
            mode = "i8" if i8 else "bf16"
            got = boost.hist_level0(xb3, g3, h3, n_bins=self.n_bins, mxu_i8=i8)
            ref = boost.hist_level0_plain(xb3, g3, h3, n_bins=self.n_bins, mxu_i8=i8)
            e = hist_err(got, ref)
            print(f"  hist_level0 {mode}: max |d| {float((got - ref).abs().max()):.3e}"
                  f" (err/limit {e:.3f})")
            require(e <= 1.0, f"hist_level0 {mode} disagrees with its plain version")
            self.err["hist_level0"] = max(self.err["hist_level0"],
                                          float((got - ref).abs().max()))
            for d in range(1, DEPTH):
                node3, feat, thr = self.level_inputs(d)
                got, nk = boost.hist_level(xb3, node3, g3, h3, feat, thr, depth=d,
                                           n_bins=self.n_bins, mxu_i8=i8)
                ref, npl = boost.hist_level_plain(xb3, node3, g3, h3, feat, thr,
                                                  depth=d, n_bins=self.n_bins, mxu_i8=i8)
                e = hist_err(got, ref)
                same = bool(torch.equal(nk, npl))
                print(f"  hist_level d={d} {mode}: max |d| "
                      f"{float((got - ref).abs().max()):.3e} (err/limit {e:.3f}),"
                      f" node ids equal: {same}")
                require(same and e <= 1.0,
                        f"hist_level d={d} {mode} disagrees with its plain version")
                self.err["hist_level"] = max(self.err["hist_level"],
                                             float((got - ref).abs().max()))
        self.check_route()

    def check_route(self):
        """The final passes against their plain versions, bit for bit
        (integer routing and one f32 add a row), at each of ROUTE_DEPTHS."""
        torch, boost, xb3 = self.torch, self.boost, self.xb3
        for d in ROUTE_DEPTHS:
            node3, feat, thr = self.level_inputs(d)
            gen = torch.Generator(device=self.dev).manual_seed(7)
            leaf = torch.randn(2 ** d, generator=gen, device=self.dev)
            nk = boost.route_level(xb3, node3, feat, thr, depth=d)
            npl = boost.route_level_plain(xb3, node3, feat, thr, depth=d)
            nerr = float((nk - npl).abs().max())
            self.err["route_level"] = max(self.err["route_level"], nerr)
            require(bool(torch.equal(nk, npl)), f"route_level d={d}: node ids differ")
            mk, nk2 = boost.route_margin_level(xb3, node3, self.margin3, feat, thr,
                                               leaf, depth=d)
            mp, np2 = boost.route_margin_level_plain(xb3, node3, self.margin3, feat,
                                                     thr, leaf, depth=d)
            merr = float((mk - mp).abs().max())
            self.err["route_margin_level"] = max(
                self.err["route_margin_level"], merr, float((nk2 - np2).abs().max()))
            require(bool(torch.equal(nk2, np2)),
                    f"route_margin_level d={d}: node ids differ")
            require(bool(torch.equal(mk.view(torch.int32), mp.view(torch.int32))),
                    f"route_margin_level d={d}: margins differ (max |d| {merr})")
            print(f"  route_level, route_margin_level d={d} ({2 ** (d - 1)} parents): "
                  "node ids and margins equal to the plain versions bit for bit")

    def check_helpers(self):
        """hist_prep and hist_partition against their plain twins, exactly,
        at a route level (d = 5, 32 nodes) and at a real round's node ids
        (d = 5, the last row block short), both encodings."""
        boost, torch = self.boost, self.torch
        node3, feat, thr = self.level_inputs(5)
        cpu = lambda a: None if a is None else a.cpu()
        n_block = self.xb3.shape[0] * self.xb3.shape[1]
        cases = (("route", self.xb3, node3, self.g3, self.h3, feat, thr, n_block),
                 ("nodes", self.xb, self.levels[5][0], self.g, self.h, None, None,
                  self.n_rows))
        for mode, xb, node, g, h, ft, th, n in cases:
            for i8 in (False, True):
                kw = dict(n_rows=n, block=1024, n_nodes=32, i8=i8)
                key, counts, scale = boost.hist_prep(mode, xb, node, g, h, ft, th, **kw)
                part = boost.hist_partition(key, g, h, counts, scale, **kw)
                rk, rc, rs = boost.hist_prep_plain(mode, *map(cpu, (xb, node, g, h, ft, th)),
                                                   **kw)
                rp = boost.hist_partition_plain(rk, g.cpu(), h.cpu(), rc, rs, **kw)
                n_listed, n_chunks = int(rp.node_base[-1]), int(rp.node_chunk0[-1])
                same = (torch.equal(key.cpu().reshape(-1), rk) and torch.equal(counts.cpu(), rc)
                        and (scale is None or torch.equal(scale.cpu(), rs))
                        and torch.equal(part.node_base.cpu(), rp.node_base)
                        and torch.equal(part.node_chunk0.cpu(), rp.node_chunk0)
                        and torch.equal(part.chunk_begin[:n_chunks].cpu(), rp.chunk_begin)
                        and torch.equal(part.perm[:n_listed].cpu(), rp.perm)
                        and torch.equal(part.planes[:n_listed].cpu(), rp.planes))
                print(f"  hist_prep + hist_partition {mode} d=5 {'i8' if i8 else 'bf16'}: "
                      f"{n_listed} rows in {n_chunks} chunks, equal to the plain twins: {same}")
                require(same, f"the histogram helpers ({mode}) disagree with their twins")

    def check_deep_levels(self):
        """hist_level at 64 and 128 nodes (d = 6, 7)."""
        boost = self.boost
        for d in (DEPTH, DEPTH + 1):
            node3, feat, thr = self.level_inputs(d)
            for i8 in (False, True):
                args = (self.xb3, node3, self.g3, self.h3, feat, thr)
                got, nk = boost.hist_level(*args, depth=d, n_bins=self.n_bins, mxu_i8=i8)
                ref, npl = boost.hist_level_plain(*args, depth=d, n_bins=self.n_bins,
                                                  mxu_i8=i8)
                e = hist_err(got, ref)
                same = bool(self.torch.equal(nk, npl))
                print(f"  hist_level d={d} ({2 ** d} nodes) {'i8' if i8 else 'bf16'}:"
                      f" max |d| {float((got - ref).abs().max()):.3e} (err/limit"
                      f" {e:.3f}), node ids equal: {same}")
                require(same and e <= 1.0, f"hist_level d={d} disagrees with its "
                        "plain version")

    def real_levels(self):
        """The node ids, histograms and split tables of a real round's
        levels d = 0..DEEP-1 (train_round's loop on the card, bf16, seeded
        margin)."""
        torch, gbdt = self.torch, self.gbdt
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES, depth=DEEP, n_bins=self.n_bins)
        node = torch.zeros(self.n_rows, dtype=torch.int32, device=self.dev)
        levels = []
        for d in range(DEEP):
            hist = self.hist.node_histograms_kernel(self.xb, self.g, self.h, node,
                                                    2 ** d, self.n_bins)
            feat, thr, _ = gbdt.best_splits(hist, cfg)
            levels.append((node, hist, feat, thr))
            node = self.route(node, feat, thr)
        return levels

    def check_node_kernel(self):
        """The histogram for given node ids at a real round's node ids,
        d = 0..7 (1-128 nodes); the last row block is short."""
        hist = self.hist
        self.levels = self.real_levels()
        for i8 in (False, True):
            for d, (node, _, _, _) in enumerate(self.levels):
                args = (self.xb, self.g, self.h, node, 2 ** d, self.n_bins)
                got = hist.node_histograms_kernel(*args, mxu_i8=i8)
                ref = hist.node_histograms_kernel_plain(*args, mxu_i8=i8)
                e = hist_err(got, ref)
                print(f"  node_histograms_kernel d={d} {'i8' if i8 else 'bf16'}: "
                      f"max |d| {float((got - ref).abs().max()):.3e} (err/limit {e:.3f})")
                require(e <= 1.0, f"node_histograms_kernel d={d} disagrees with "
                        "its plain version")
                self.err["node_histograms_kernel"] = max(
                    self.err["node_histograms_kernel"], float((got - ref).abs().max()))

    def leaf_inputs(self):
        """leaf_fit's inputs from the real round: the last level's node ids
        (blocked) and split tables."""
        node, hist, feat, thr = self.levels[DEPTH - 1]
        node3, _ = self.boost.block_rows(node)
        return (self.xb3, node3, self.g3, self.h3, feat, thr), hist

    def check_leaf_fit(self):
        """leaf_fit on the real round's last level, then on seeded node ids
        at each of LEAF_DEPTHS: leaf ids exactly (all rows), masses within
        the histogram tolerance, bitwise the same on repeat.  At depth 13
        and past, the plain version's one-hot (R x 2**(depth+1) a block) is
        too slow for every row block: it runs on the first SUBSET_BLOCKS
        row blocks (a second kernel call on those), and the full call's
        masses are held against an f64 sum of the rows' hi/lo planes per
        leaf (``leaf_masses_f64``) over all rows, its leaf ids against
        route_level_plain."""
        torch, boost = self.torch, self.boost
        args, _ = self.leaf_inputs()
        gk, nk = boost.leaf_fit(*args, depth=DEPTH)
        gp, npl = boost.leaf_fit_plain(*args, depth=DEPTH)
        e = hist_err(gk, gp)
        same = bool(torch.equal(nk, npl))
        print(f"  leaf_fit (real round, d={DEPTH}): max |d| {float((gk - gp).abs().max()):.3e}"
              f" (err/limit {e:.3f}), leaf ids equal: {same}")
        require(same and e <= 1.0, "leaf_fit disagrees with its plain version")
        self.err["leaf_fit"] = float((gk - gp).abs().max())
        for d in LEAF_DEPTHS:
            node3, feat, thr = self.level_inputs(d)
            full = (self.xb3, node3, self.g3, self.h3, feat, thr)
            gk, nk = boost.leaf_fit(*full, depth=d)
            again, n2 = boost.leaf_fit(*full, depth=d)
            repeat = bool(torch.equal(again.view(torch.int32), gk.view(torch.int32))
                          and torch.equal(n2, nk))
            leaf3 = boost.route_level_plain(self.xb3, node3, feat, thr, depth=d)
            same = bool(torch.equal(nk, leaf3))
            if d >= FULL_PLAIN_DEPTH:
                ref = self.leaf_masses_f64(leaf3, d)
                e = hist_err(gk.double(), ref)
                print(f"  leaf_fit d={d} ({2 ** d} leaves): masses on all rows against the "
                      f"f64 sum max |d| {float((gk.double() - ref).abs().max()):.3e} "
                      f"(err/limit {e:.3f})")
                require(e <= 1.0, f"leaf_fit d={d} disagrees with the f64 sum over all rows")
                full = tuple(a[:SUBSET_BLOCKS] if a.ndim == 3 else a for a in full)
                gk, _ = boost.leaf_fit(*full, depth=d)
            gp, _ = boost.leaf_fit_plain(*full, depth=d)
            e = hist_err(gk, gp)
            where = ("all rows" if d < FULL_PLAIN_DEPTH
                     else f"the first {SUBSET_BLOCKS} row blocks")
            print(f"  leaf_fit d={d} ({2 ** d} leaves): masses on {where} max |d| "
                  f"{float((gk - gp).abs().max()):.3e} (err/limit {e:.3f}); leaf ids "
                  f"equal: {same}; bitwise on repeat: {repeat}")
            require(same and repeat and e <= 1.0,
                    f"leaf_fit d={d} disagrees with its plain version")
            self.err["leaf_fit"] = max(self.err["leaf_fit"], float((gk - gp).abs().max()))

    def leaf_masses_f64(self, leaf3, depth: int):
        """[2**depth, 2] f64: per leaf the sum over all rows of g's and h's
        hi + lo bf16 planes (hi = bf16(v), lo = bf16(v - hi)), by index_add_
        in f64: independent of the kernel's order, and exact to f64."""
        torch = self.torch

        def planes(v):
            hi = v.reshape(-1).to(torch.bfloat16).float()
            return hi.double() + (v.reshape(-1) - hi).to(torch.bfloat16).double()

        vals = torch.stack([planes(self.g3), planes(self.h3)], -1)
        out = torch.zeros((2 ** depth, 2), dtype=torch.float64, device=self.dev)
        return out.index_add_(0, leaf3.reshape(-1).long(), vals)

    def check_large_hist(self):
        """The histogram path past 4096 nodes (the sorting partition): at
        8192 and 16384 nodes of the route mode (d = 13, 14) and 8192 given
        node ids, the partition equals hist_partition_plain exactly over all
        rows; the histogram matches its plain version on the first
        SUBSET_BLOCKS row blocks (the plain one-hot at 8192 nodes is too
        slow for all of them), both encodings."""
        torch, boost = self.torch, self.boost
        R = self.xb3.shape[1]
        cases = [("route", n) for n in LARGE_NODES] + [("nodes", LARGE_NODES[0])]
        for mode, n_nodes in cases:
            d = n_nodes.bit_length() - 1
            if mode == "route":
                node3, feat, thr = self.level_inputs(d)
                xb, node, g, h = self.xb3, node3, self.g3, self.h3
                n = self.xb3.numel() // N_FEATURES
            else:
                gen = torch.Generator(device=self.dev).manual_seed(200)
                node = torch.randint(0, n_nodes, (self.n_rows,), generator=gen,
                                     device=self.dev, dtype=torch.int32)
                xb, g, h, n, feat, thr = self.xb, self.g, self.h, self.n_rows, None, None
            for i8 in (False, True):
                enc = "i8" if i8 else "bf16"
                kw = dict(n_rows=n, block=R, n_nodes=n_nodes, i8=i8)
                key, counts, scale = boost.hist_prep(mode, xb, node, g, h, feat, thr, **kw)
                part = boost.hist_partition(key, g, h, counts, scale, **kw)
                rk, rc, rs = boost.hist_prep_plain(mode, xb, node, g, h, feat, thr, **kw)
                rp = boost.hist_partition_plain(rk, g, h, rc, rs, **kw)
                n_listed, n_chunks = int(rp.node_base[-1]), int(rp.node_chunk0[-1])
                same = (torch.equal(key.reshape(-1), rk.reshape(-1))
                        and torch.equal(counts, rc)
                        and (scale is None or torch.equal(scale, rs))
                        and torch.equal(part.node_base, rp.node_base)
                        and torch.equal(part.node_chunk0, rp.node_chunk0)
                        and torch.equal(part.chunk_begin[:n_chunks], rp.chunk_begin)
                        and torch.equal(part.perm[:n_listed], rp.perm)
                        and torch.equal(part.planes[:n_listed], rp.planes))
                del key, counts, scale, part, rk, rc, rs, rp
                sub = SUBSET_BLOCKS * R
                if mode == "route":
                    a = (self.xb3[:SUBSET_BLOCKS], node3[:SUBSET_BLOCKS],
                         self.g3[:SUBSET_BLOCKS], self.h3[:SUBSET_BLOCKS], feat, thr)
                    got, nk = boost.hist_level(*a, depth=d, n_bins=self.n_bins, mxu_i8=i8)
                    ref, npl = boost.hist_level_plain(*a, depth=d, n_bins=self.n_bins, mxu_i8=i8)
                    same = same and bool(torch.equal(nk, npl))
                    name = "hist_level"
                else:
                    a = (self.xb[:sub], self.g[:sub], self.h[:sub], node[:sub], n_nodes,
                         self.n_bins)
                    got = self.hist.node_histograms_kernel(*a, mxu_i8=i8)
                    ref = self.hist.node_histograms_kernel_plain(*a, mxu_i8=i8)
                    name = "node_histograms_kernel"
                e = hist_err(got, ref)
                print(f"  {mode} {n_nodes} nodes {enc}: partition of {n_listed} rows in "
                      f"{n_chunks} chunks equal to the plain twins: {same}; histogram on "
                      f"the first {SUBSET_BLOCKS} row blocks max |d| "
                      f"{float((got - ref).abs().max()):.3e} (err/limit {e:.3f})")
                require(same and e <= 1.0, f"{mode} {n_nodes} nodes {enc}: the histogram "
                        "path disagrees with its plain twins")
                self.err[name] = max(self.err[name], float((got - ref).abs().max()))
                del got, ref

    def check_equal_hist(self, name, run, plain, what: str):
        """One histogram call on the card (``run``, called twice: bitwise
        the same) against its plain version; returns the card's result."""
        got, again, ref = run(), run(), plain()
        if isinstance(got, tuple):  # hist_level: (histogram, node ids)
            require(bool(self.torch.equal(got[1], again[1]) and
                         self.torch.equal(got[1], ref[1])), f"{what}: node ids differ")
            got, again, ref = got[0], again[0], ref[0]
        e = hist_err(got, ref)
        repeat = bool(self.torch.equal(got.view(self.torch.int32), again.view(self.torch.int32)))
        print(f"  {what}: max |d| {float((got - ref).abs().max()):.3e} (err/limit {e:.3f}),"
              f" bitwise on repeat: {repeat}")
        require(e <= 1.0 and repeat, f"{what} disagrees with its plain version")
        self.err[name] = max(self.err[name], float((got - ref).abs().max()))

    def check_wide_bins(self):
        """This instance's bins past 256 (the tile kernel's windows of 256
        bins): hist_level0, hist_level (d = 3, seeded) and
        node_histograms_kernel (8 seeded nodes, one in 13 ids foreign) in
        both encodings against their plain versions, over all rows up to
        512 bins and on the first SUBSET_BLOCKS row blocks past that (the
        plain one-hot grows with the bins), where the kernels also run once
        over all rows."""
        torch, boost, hist = self.torch, self.boost, self.hist
        nb = self.xb3.shape[0] if self.n_bins <= 512 else SUBSET_BLOCKS
        rows = nb * self.xb3.shape[1]
        node3, feat, thr = self.level_inputs(3)
        gen = torch.Generator(device=self.dev).manual_seed(300)
        node = torch.randint(0, 8, (self.n_rows,), generator=gen, device=self.dev,
                             dtype=torch.int32)
        node[::13] = 8
        where = "all rows" if nb == self.xb3.shape[0] else f"the first {nb} row blocks"
        a3 = (self.xb3[:nb], node3[:nb], self.g3[:nb], self.h3[:nb], feat, thr)
        n = min(rows, self.n_rows)
        a1 = (self.xb[:n], self.g[:n], self.h[:n], node[:n], 8, self.n_bins)
        for i8 in (False, True):
            enc = "i8" if i8 else "bf16"
            kw = dict(n_bins=self.n_bins, mxu_i8=i8)
            self.check_equal_hist(
                "hist_level0", lambda: boost.hist_level0(a3[0], a3[2], a3[3], **kw),
                lambda: boost.hist_level0_plain(a3[0], a3[2], a3[3], **kw),
                f"hist_level0 {self.n_bins} bins {enc}, {where}")
            self.check_equal_hist(
                "hist_level", lambda: boost.hist_level(*a3, depth=3, **kw),
                lambda: boost.hist_level_plain(*a3, depth=3, **kw),
                f"hist_level d=3 {self.n_bins} bins {enc}, {where}")
            self.check_equal_hist(
                "node_histograms_kernel", lambda: hist.node_histograms_kernel(*a1, mxu_i8=i8),
                lambda: hist.node_histograms_kernel_plain(*a1, mxu_i8=i8),
                f"node_histograms_kernel 8 nodes {self.n_bins} bins {enc}, {where}")
            if nb < self.xb3.shape[0]:
                full = boost.hist_level(self.xb3, node3, self.g3, self.h3, feat, thr,
                                        depth=3, **kw)[0]
                require(bool(torch.isfinite(full).all()), "non-finite histogram")

    def check_row_blocks(self):
        """Row blocks of 128 and 16384 rows (the headline data reblocked):
        the three histogram kernels (root, route d = 3, 8 given node ids)
        and leaf_fit (d = 6 and 13) in both encodings against their plain
        versions, the i8 block scales and the counts exactly.  At 128 rows
        on the first SUBSET_BLOCKS x 1024 rows (the plain versions loop
        over 7813 blocks otherwise); at 16384 rows over all rows, but for
        leaf_fit at d = 13 (a [16384, 16384] one-hot a block) on the first
        five blocks."""
        torch, boost, hist = self.torch, self.boost, self.hist
        sub = SUBSET_BLOCKS * 1024
        for R, n in ((128, sub), (16384, self.n_rows)):
            xb3, _ = boost.block_rows(self.xb[:n], R)
            g3, _ = boost.block_rows(self.g[:n], R)
            h3, _ = boost.block_rows(self.h[:n], R)
            gen = torch.Generator(device=self.dev).manual_seed(R)
            node3 = torch.randint(0, 4, g3.shape, generator=gen, device=self.dev,
                                  dtype=torch.int32)
            _, feat, thr = self.level_inputs(3)
            node = torch.randint(0, 9, (n,), generator=gen, device=self.dev,
                                 dtype=torch.int32)  # 8: foreign
            rows = xb3.shape[0] * R
            for i8 in (False, True):
                enc = "i8" if i8 else "bf16"
                kw = dict(n_bins=self.n_bins, mxu_i8=i8)
                self.check_equal_hist(
                    "hist_level0", lambda: boost.hist_level0(xb3, g3, h3, **kw),
                    lambda: boost.hist_level0_plain(xb3, g3, h3, **kw),
                    f"hist_level0 R={R} {enc}, {rows} rows")
                a = (xb3, node3, g3, h3, feat, thr)
                self.check_equal_hist(
                    "hist_level", lambda: boost.hist_level(*a, depth=3, **kw),
                    lambda: boost.hist_level_plain(*a, depth=3, **kw),
                    f"hist_level d=3 R={R} {enc}, {rows} rows")
                a1 = (self.xb[:n], self.g[:n], self.h[:n], node, 8, self.n_bins)
                self.check_equal_hist(
                    "node_histograms_kernel",
                    lambda: hist.node_histograms_kernel(*a1, block_rows=R, mxu_i8=i8),
                    lambda: hist.node_histograms_kernel_plain(*a1, block_rows=R, mxu_i8=i8),
                    f"node_histograms_kernel R={R} {enc}, {n} rows (last block short)")
                pk = dict(n_rows=n, block=R, n_nodes=8, i8=i8)
                args = (self.xb[:n], node, self.g[:n], self.h[:n], None, None)
                _, counts, scale = boost.hist_prep("nodes", *args, **pk)
                _, rc, rs = boost.hist_prep_plain("nodes", *args, **pk)
                require(bool(torch.equal(counts, rc)) and
                        (scale is None or bool(torch.equal(scale, rs))),
                        f"hist_prep R={R} {enc}: counts or block scales differ")
            print(f"  hist_prep R={R}: counts and i8 block scales equal to the plain twin's")
            for d in (DEPTH, 13):
                nbl = xb3.shape[0] if d < FULL_PLAIN_DEPTH or R < 1024 else 5
                gen = torch.Generator(device=self.dev).manual_seed(d)
                n_prev = 2 ** (d - 1)
                la = (xb3[:nbl],
                      torch.randint(0, n_prev, (nbl, R, 1), generator=gen, device=self.dev,
                                    dtype=torch.int32), g3[:nbl], h3[:nbl],
                      torch.randint(0, N_FEATURES, (n_prev,), generator=gen, device=self.dev,
                                    dtype=torch.int32),
                      torch.randint(0, self.n_bins, (n_prev,), generator=gen,
                                    device=self.dev, dtype=torch.int32))
                self.check_equal_hist(
                    "leaf_fit", lambda: boost.leaf_fit(*la, depth=d),
                    lambda: boost.leaf_fit_plain(*la, depth=d),
                    f"leaf_fit d={d} R={R}, {nbl * R} rows")

    # -- phase 4 ------------------------------------------------------------------
    def near_ties(self, hist, feat, thr, cfg, where: str, what: str):
        """Split tables ``feat``/``thr`` against the best splits of ``hist``:
        a differing split must be a near tie on ``hist``; each is printed."""
        gbdt, torch = self.gbdt, self.torch
        fp, tp, _ = gbdt.best_splits(hist, cfg)
        gains = gbdt.split_gains(hist, cfg)
        for nd in torch.nonzero((feat != fp) | (thr != tp)).flatten().tolist():
            a = float(gains[nd, int(feat[nd]) * self.n_bins + int(thr[nd])])
            b = float(gains[nd, int(fp[nd]) * self.n_bins + int(tp[nd])])
            gap = abs(a - b) / max(abs(a), abs(b), 1e-30)
            print(f"    {where} node {nd}: {what} split ({int(feat[nd])},{int(thr[nd])})"
                  f" vs plain ({int(fp[nd])},{int(tp[nd])}), gains {a:.7g} / {b:.7g}")
            require(gap < GAIN_TIE, f"{where}: split differs beyond a near tie")

    def wire_level(self, hist, wired, partials, feat, thr, cfg, where: str, exact=None):
        """One level of a round grown over the int8 wire, against ``hist``,
        the single-process histogram of the same rows: the histogram the
        ranks summed on the wire (``wired``) lies within the ring's error
        of ``hist`` element by element, and the level's split tables are
        ``hist``'s best splits and, while ``exact`` holds the exact round's
        tables of the same rows, the exact round's splits.  A differing
        split is allowed only where the wire's error could turn it, and is
        printed (``wire_turned``).

        The error: at DP_RANKS = 2, ring_allreduce_quantized (planes 2,
        blocks of 256) quantizes a rank's partial block once and the
        owner's summed block once, each off by at most half a step of
        max|block| / (127 * 254); ``partials`` are the ranks' histograms.
        The single-process sum adds f32 rounding in another order: the
        histogram check allows HIST_RTOL for it, the split check the
        measured |hist - sum(partials)| and two f32 rounding steps."""
        gbdt, torch = self.gbdt, self.torch
        blockmax = lambda a: a.reshape(-1, 256).abs().amax(1, keepdim=True)
        half_steps = (blockmax(hist) + torch.stack([blockmax(p) for p in partials]).amax(0))
        quant = (0.5 * half_steps / (127 * 254)).expand(-1, 256).reshape(hist.shape)
        env = quant + HIST_RTOL * (hist.abs() + float(hist.abs().max()))
        over = float(((wired - hist).abs() / env).max())
        require(over <= 1.0, f"{where}: the wire's histogram is off by {over:.3f}x its "
                             "error bound")
        summed = sum(partials)
        env = (quant + (hist - summed).abs()
               + 2.0 ** -22 * (hist.abs() + sum(p.abs() for p in partials)))
        fp, tp, _ = gbdt.best_splits(hist, cfg)
        self.wire_turned(hist, env, cfg, (feat, thr), (fp, tp), 0.0, where, "plain best")
        if exact is not None:
            # the exact round's own splits are hist's best up to a near tie
            self.wire_turned(hist, env, cfg, (feat, thr), exact, GAIN_TIE, where,
                             "exact round")
        return over

    def wire_turned(self, hist, env, cfg, wire, other, tie: float, where: str, what: str):
        """Nodes where the wire's split differs from ``other``'s: each must
        be one the wire's error could turn, and is printed.  Either the two
        splits' gains on ``hist`` (f64) lie within the sum of their error
        bounds, plus ``tie`` of the larger gain; or a child of either split
        has a hessian mass within its error of min_child_weight.  A gain's
        bound: each child's score g^2/(h + lambda) over the box of (g, h)
        that the bins' errors ``env`` allow, plus 4 f32 rounding steps of
        the scores the argmax compared (the parent's score is the same for
        every split of a node)."""
        torch = self.torch
        g, h = hist[..., 0].double(), hist[..., 1].double()
        eg, eh = env[..., 0].double(), env[..., 1].double()
        GL, HL, eGL, eHL = (torch.cumsum(a, -1) for a in (g, h, eg, eh))
        GR, HR, eGR, eHR = (a[..., -1:] - a for a in (GL, HL, eGL, eHL))
        lam, mcw = cfg.reg_lambda, cfg.min_child_weight

        def score(G, H, eG, eH):
            s = G * G / (H + lam)
            hi = (G.abs() + eG) ** 2 / (H - eH + lam).clamp_min(1e-300)
            lo = (G.abs() - eG).clamp_min(0) ** 2 / (H + eH + lam)
            err = torch.where(H - eH + lam > 0, torch.maximum(hi - s, s - lo),
                              torch.full_like(s, torch.inf))
            return s, err

        (sl, el), (sr, er) = score(GL, HL, eGL, eHL), score(GR, HR, eGR, eHR)
        parent = GL[..., -1:] ** 2 / (HL[..., -1:] + lam)
        valid = (HL >= mcw) & (HR >= mcw)
        gain = torch.where(valid, sl + sr - parent, torch.full_like(sl, -torch.inf))
        err = el + er + 4 * 2.0 ** -24 * (sl + sr + parent)
        edge = ((HL - mcw).abs() <= eHL) | ((HR - mcw).abs() <= eHR)
        gain, err, edge = (a.reshape(a.shape[0], -1) for a in (gain, err, edge))
        (fw, tw), (fo, to) = wire, other
        for nd in torch.nonzero((fw != fo) | (tw != to)).flatten().tolist():
            a = int(fw[nd]) * self.n_bins + int(tw[nd])
            b = int(fo[nd]) * self.n_bins + int(to[nd])
            ga, gb = float(gain[nd, a]), float(gain[nd, b])
            bound = float(err[nd, a] + err[nd, b]) + tie * max(abs(ga), abs(gb))
            gap = 0.0 if ga == gb else abs(ga - gb)
            at_mcw = bool(edge[nd, a] | edge[nd, b])
            print(f"    {where} node {nd}: wire split ({int(fw[nd])},{int(tw[nd])}) vs "
                  f"{what} ({int(fo[nd])},{int(to[nd])}), gains on the single-process "
                  f"histogram {ga:.9g} / {gb:.9g}, gap {gap:.3g} against the wire's bound "
                  f"{bound:.3g}" + (", a child at min_child_weight" if at_mcw else ""))
            require(gap <= bound or at_mcw,
                    f"{where}: the wire's split differs from the {what}'s beyond the "
                    "wire's error")

    def compare_splits(self, hk, hp, cfg, where: str):
        """Split tables from the kernel's and the plain histogram; a differing
        split must be a near tie on the plain histogram.  Returns the
        kernel's tables (the teacher-forced path goes on with them)."""
        fk, tk, _ = self.gbdt.best_splits(hk, cfg)
        self.near_ties(hp, fk, tk, cfg, where, "kernel")
        return fk, tk

    def teacher_forced(self, state, cfg):
        """One fused round level by level, each kernel held against its plain
        version on the kernel path's inputs; returns the kernel path's
        split tables."""
        boost, gbdt, torch = self.boost, self.gbdt, self.torch
        g, h = gbdt.gradients(cfg, state.margin, self.y)
        g3, _ = boost.block_rows(g)
        h3, _ = boost.block_rows(h)
        kw = dict(n_bins=self.n_bins, mxu_i8=cfg.mxu_i8)
        hk = boost.hist_level0(self.xb3, g3, h3, **kw)
        hp = boost.hist_level0_plain(self.xb3, g3, h3, **kw)
        require(hist_err(hk, hp) <= 1.0, "level 0 histogram disagrees")
        feat, thr = self.compare_splits(hk, hp, cfg, "level 0")
        feats, thrs = [feat], [thr]
        node3 = torch.zeros(g3.shape, dtype=torch.int32, device=self.dev)
        for d in range(1, cfg.depth):
            hk, nk = boost.hist_level(self.xb3, node3, g3, h3, feat, thr,
                                      depth=d, **kw)
            hp, npl = boost.hist_level_plain(self.xb3, node3, g3, h3, feat, thr,
                                             depth=d, **kw)
            require(bool(torch.equal(nk, npl)), f"level {d} node ids differ")
            require(hist_err(hk, hp) <= 1.0, f"level {d} histogram disagrees")
            feat, thr = self.compare_splits(hk, hp, cfg, f"level {d}")
            feats.append(feat)
            thrs.append(thr)
            node3 = nk
        nk = boost.route_level(self.xb3, node3, feat, thr, depth=cfg.depth)
        npl = boost.route_level_plain(self.xb3, node3, feat, thr, depth=cfg.depth)
        require(bool(torch.equal(nk, npl)), "leaf ids differ")
        return feats, thrs

    def main_path(self, i8: bool, fused_final: bool):
        torch, boost, gbdt = self.torch, self.boost, self.gbdt
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES, n_trees=4, depth=DEPTH,
                              n_bins=self.n_bins, mxu_i8=i8, fused_final=fused_final)
        final = "route_margin_level" if fused_final else "route_level"
        state = gbdt.init_state(cfg, self.n_rows, self.dev)
        state = gbdt.train_round_fused(state, self.xb3, self.y, cfg)  # warm-up
        warm = state
        self.clear_counts()
        t0 = time.perf_counter()
        for _ in range(3):
            state = gbdt.train_round_fused(state, self.xb3, self.y, cfg)
        self.sync()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        counts = self.read_counts(3 * DEPTH)
        want = {"hist_level0": 3, "hist_level": 3 * (DEPTH - 1), final: 3}
        require(counts == want, f"launch counts {counts}, expected {want}")
        require(bool(torch.isfinite(state.margin).all()), "non-finite margin")
        # the same round (from the warm state), level by level
        feats, thrs = self.teacher_forced(warm, cfg)
        t = warm.round
        for d in range(DEPTH):
            n = 2 ** d
            require(bool(torch.equal(state.forest.feature[t, d, :n], feats[d])) and
                    bool(torch.equal(state.forest.threshold[t, d, :n], thrs[d])),
                    f"teacher-forced tree differs from train_round_fused at level {d}")
        mode = ("i8" if i8 else "bf16") + (" fused_final" if fused_final else "")
        print(f"  main path {mode}, {self.n_bins} bins: {ms:.3f} ms/round (3 rounds after 1 "
              "warm-up),"
              f" launches {counts}")
        return ms

    def user_entry(self):
        """GBDT.fit / predict as a user calls them, on float features."""
        gbdt, boost, torch = self.gbdt, self.boost, self.torch
        X = self.xb.cpu().numpy().astype(np.float32)
        y = self.y.cpu().numpy()
        model = gbdt.GBDT(device=self.dev, n_trees=3, depth=DEPTH, n_bins=self.n_bins)
        self.clear_counts()
        t0 = time.perf_counter()
        model.fit(X, y)
        self.sync()
        fit_s = time.perf_counter() - t0
        counts = self.read_counts(3 * DEPTH)
        want = {"hist_level0": 3, "hist_level": 3 * (DEPTH - 1), "route_level": 3}
        require(counts == want, f"GBDT.fit launch counts {counts}, expected {want}")
        margin = model.predict_margin(X)
        require(margin.shape == (len(X),) and np.isfinite(margin).all(),
                "predict_margin: bad shape or non-finite")
        train_margin = model._state.margin.cpu().numpy()
        require(np.array_equal(margin, train_margin),
                "predict_margin differs from the training margin")
        acc = float((model.predict(X) == y).mean())
        base = float(max(y.mean(), 1 - y.mean()))
        print(f"  GBDT.fit (3 trees, incl. bin edges): {fit_s:.2f} s; "
              f"train accuracy {acc:.4f} vs majority {base:.4f}")
        require(acc > base, "the trained forest does not beat the majority class")

    def small_reference(self):
        """The fused round on the card against the CPU reference round, at
        the CPU tests' size."""
        gbdt, boost, torch = self.gbdt, self.boost, self.torch
        rng = np.random.RandomState(3)
        n, f = 600, 5
        xb = rng.randint(0, 16, size=(n, f)).astype(np.int32)
        y = rng.randint(0, 2, size=n).astype(np.float32)
        for i8 in (False, True):
            cfg = gbdt.GBDTConfig(n_features=f, n_trees=3, depth=3, n_bins=16,
                                  mxu_i8=i8)
            s_ref = gbdt.init_state(cfg, n, "cpu")
            s_k = gbdt.init_state(cfg, n, self.dev)
            xb3, _ = boost.block_rows(torch.as_tensor(xb, device=self.dev), 256)
            yc = torch.as_tensor(y, device=self.dev)
            for _ in range(cfg.n_trees):
                s_ref = gbdt.train_round(s_ref, torch.as_tensor(xb), torch.as_tensor(y), cfg)
                s_k = gbdt.train_round_fused(s_k, xb3, yc, cfg)
            fr, fk = gbdt.forest_to_numpy(s_ref.forest), gbdt.forest_to_numpy(s_k.forest)
            require(np.array_equal(fr.feature, fk.feature) and
                    np.array_equal(fr.threshold, fk.threshold),
                    f"small input ({'i8' if i8 else 'bf16'}): trees differ from the reference")
            rtol, atol = (5e-3, 5e-3) if i8 else (1e-3, 1e-5)
            require(np.allclose(fk.leaf, fr.leaf, rtol=rtol, atol=atol),
                    "small input: leaves differ from the reference")
        print("  small input: fused round on the card grows the CPU reference's trees")

    def deep_round(self, i8: bool, depth: int = DEEPEST):
        """One deep fused round (levels of 64 to 512 nodes, the sorting
        partition past 256), teacher-forced against the plain versions."""
        torch, gbdt = self.torch, self.gbdt
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES, n_trees=1, depth=depth,
                              n_bins=self.n_bins, mxu_i8=i8)
        start = gbdt.init_state(cfg, self.n_rows, self.dev)
        t0 = time.perf_counter()
        state, counts = self.path(
            lambda: gbdt.train_round_fused(start, self.xb3, self.y, cfg))
        ms = (time.perf_counter() - t0) * 1e3
        want = {"hist_level0": 1, "hist_level": depth - 1, "route_level": 1}
        require(counts == want, f"depth-{depth} launch counts {counts}, expected {want}")
        feats, thrs = self.teacher_forced(start, cfg)
        for d in range(depth):
            n = 2 ** d
            require(bool(torch.equal(state.forest.feature[0, d, :n], feats[d])) and
                    bool(torch.equal(state.forest.threshold[0, d, :n], thrs[d])),
                    f"depth-{depth} round differs from the teacher-forced tree at level {d}")
        print(f"  depth-{depth} fused round {'i8' if i8 else 'bf16'}: {ms:.3f} ms "
              f"(one round, cold), launches {counts}, every level matches the plain path "
              f"(round and check {time.perf_counter() - t0:.1f} s)")

    # -- phase 5 ------------------------------------------------------------------
    def teacher_forced_hook(self, state, cfg):
        """train_round level by level: the kernel's histogram against its
        plain twin on the kernel path's inputs; returns the kernel path's
        split tables."""
        torch, gbdt, hist = self.torch, self.gbdt, self.hist
        g, h = gbdt.gradients(cfg, state.margin, self.y)
        node = torch.zeros(self.n_rows, dtype=torch.int32, device=self.dev)
        feats, thrs = [], []
        for d in range(cfg.depth):
            args = (self.xb, g, h, node, 2 ** d, self.n_bins)
            hk = hist.node_histograms_kernel(*args, mxu_i8=cfg.mxu_i8)
            hp = hist.node_histograms_kernel_plain(*args, mxu_i8=cfg.mxu_i8)
            require(hist_err(hk, hp) <= 1.0, f"hook level {d} histogram disagrees")
            feat, thr = self.compare_splits(hk, hp, cfg, f"hook level {d}")
            feats.append(feat)
            thrs.append(thr)
            node = self.route(node, feat, thr)
        return feats, thrs

    def hook_path(self):
        """GBDT(engine_allreduce=...) as a user calls it."""
        torch, gbdt = self.torch, self.gbdt
        X = self.xb.cpu().numpy().astype(np.float32)
        y = self.y.cpu().numpy()
        calls = []

        def engine_allreduce(a):  # a counting identity: one process
            calls.append(a.shape)
            return a

        model = gbdt.GBDT(engine_allreduce=engine_allreduce, device=self.dev,
                          n_trees=3, depth=DEPTH, n_bins=self.n_bins)
        t0 = time.perf_counter()
        _, counts = self.path(lambda: model.fit(X, y))
        fit_s = time.perf_counter() - t0
        want = {"node_histograms_kernel": 3 * DEPTH}
        require(counts == want, f"hooked GBDT.fit launch counts {counts}, expected {want}")
        require(len(calls) == 3 * (DEPTH + 1),
                f"{len(calls)} hook calls, expected {3 * (DEPTH + 1)}")
        acc = float((model.predict(X) == y).mean())
        print(f"  GBDT(engine_allreduce).fit (3 trees, incl. bin edges): {fit_s:.2f} s;"
              f" {len(calls)} hook calls; launches {counts}; train accuracy {acc:.4f}")
        require(acc > float(max(y.mean(), 1 - y.mean())),
                "the hooked forest does not beat the majority class")

    def hook_rounds(self):
        """train_round's ms/round in bf16 and i8 (1 warm-up, 3 timed), every
        level teacher-forced."""
        torch, gbdt = self.torch, self.gbdt
        round_ms = {}
        for i8 in (False, True):
            cfg = gbdt.GBDTConfig(n_features=N_FEATURES, n_trees=4, depth=DEPTH,
                                  n_bins=self.n_bins, mxu_i8=i8)
            state = gbdt.init_state(cfg, self.n_rows, self.dev)
            state = gbdt.train_round(state, self.xb, self.y, cfg)  # warm-up
            warm = state

            def rounds():
                s = warm
                for _ in range(3):
                    s = gbdt.train_round(s, self.xb, self.y, cfg)
                return s

            t0 = time.perf_counter()
            state, counts = self.path(rounds)
            ms = (time.perf_counter() - t0) * 1e3 / 3
            want = {"node_histograms_kernel": 3 * DEPTH}
            require(counts == want, f"train_round launch counts {counts}, expected {want}")
            require(bool(torch.isfinite(state.margin).all()), "non-finite margin")
            feats, thrs = self.teacher_forced_hook(warm, cfg)
            t = warm.round
            for d in range(DEPTH):
                n = 2 ** d
                require(bool(torch.equal(state.forest.feature[t, d, :n], feats[d])) and
                        bool(torch.equal(state.forest.threshold[t, d, :n], thrs[d])),
                        f"teacher-forced tree differs from train_round at level {d}")
            mode = "i8" if i8 else "bf16"
            round_ms[mode] = ms
            print(f"  train_round {mode}, {self.n_bins} bins: {ms:.3f} ms/round (3 rounds after 1 "
                  f"warm-up), launches {counts}")
        return round_ms

    # -- phase 6 ------------------------------------------------------------------
    def leaf_path(self):
        """leaf_fit on the real round's last level: the leaf masses of the
        round's tree, held against split_child_masses of the same level."""
        args, hist = self.leaf_inputs()
        (gk, nk), counts = self.path(lambda: self.boost.leaf_fit(*args, depth=DEPTH))
        require(counts == {"leaf_fit": 1}, f"leaf path launch counts {counts}")
        masses = self.gbdt.split_child_masses(hist, args[4], args[5])
        e = hist_err(gk, masses)
        nr = self.boost.route_level(args[0], args[1], args[4], args[5], depth=DEPTH)
        same = bool(self.torch.equal(nk, nr))
        print(f"  leaf_fit vs split_child_masses: max |d| "
              f"{float((gk - masses).abs().max()):.3e} (err/limit {e:.3f}); "
              f"leaf ids equal route_level's: {same}")
        require(same and e <= 1.0, "leaf_fit disagrees with the round's leaves")

    # -- phase 7 ------------------------------------------------------------------
    def dp_single(self):
        """train_round_dp / train_round_dp_fused on an NCCL group of one:
        bitwise train_round / train_round_fused."""
        torch, gbdt = self.torch, self.gbdt
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES, n_trees=2, depth=DEPTH,
                              n_bins=self.n_bins)
        start = gbdt.init_state(cfg, self.n_rows, self.dev)
        with nccl_group_of_one():
            (s_dp, s_f), counts = self.path(lambda: (
                gbdt.train_round_dp(start, self.xb, self.y, cfg),
                gbdt.train_round_dp_fused(start, self.xb3, self.y, cfg)))
        want = {"node_histograms_kernel": DEPTH, "hist_level0": 1,
                "hist_level": DEPTH - 1, "route_level": 1}
        require(counts == want, f"dp launch counts {counts}, expected {want}")
        for got, ref, name in (
                (s_dp, gbdt.train_round(start, self.xb, self.y, cfg), "train_round_dp"),
                (s_f, gbdt.train_round_fused(start, self.xb3, self.y, cfg),
                 "train_round_dp_fused")):
            same = all(bool(torch.equal(a, b)) for a, b in zip(got.forest, ref.forest))
            same = same and bool(torch.equal(got.margin, ref.margin))
            require(same, f"{name} on one NCCL rank differs from the single-process round")
        print(f"  NCCL, world 1: train_round_dp and train_round_dp_fused bitwise equal "
              f"to the single-process rounds; launches {counts}")

    def dp_two_ranks(self, n_trees: int = 2, hybrid_trees: int = 3):
        """DP_RANKS processes on the one card over gloo with CUDA tensors;
        their forests against each other and against the single-process
        round, teacher-forced on the ranks' tables.  The same processes then
        run the hybrid round, the engine matrix, the compress phase's part and
        the models' and attention's (_gloo_world_rank), whose results phases
        8-10 and 21-23 check."""
        t0 = time.perf_counter()
        port = free_port()
        engine_port = next(p for p in iter(free_port, None) if p != port)
        world = run_ranks(_gloo_world_rank, DP_RANKS, self.n_rows, n_trees, port, hybrid_trees,
                          engine_port)
        wall = time.perf_counter() - t0

        def part(prefix: str) -> list[dict]:
            return [{k[len(prefix):]: v for k, v in r.items() if k.startswith(prefix)}
                    for r in world]

        runs = [{k: v for k, v in r.items()
                 if not k.startswith(("hybrid/", "engine/", "compress/", "slice/"))}
                for r in world]
        self.hybrid_runs = part("hybrid/")
        self.engine_runs = part("engine/")
        self.compress_runs = part("compress/")
        self.slice_runs = part("slice/")
        self.hybrid_trees = hybrid_trees
        launches = self.check_ranks(runs, n_trees, "gloo")
        self.dp_forest = runs[0]
        self.check_forest(runs[0], n_trees, "gloo")
        print(f"  gloo, {DP_RANKS} ranks on one card ({wall:.1f} s incl. start-up and the "
              "hybrid, engine, compress, models' and attention's parts in the same "
              "processes): "
              f"identical forests; launches per rank {launches}; the single-process "
              "round's splits at every level")
        # train_round_dp_fused exact and with wire_i8 (the int8-wire ring)
        want = {"hist_level0": 2 * DP_FUSED_TREES,
                "hist_level": 2 * DP_FUSED_TREES * (DEPTH - 1),
                "route_level": 2 * DP_FUSED_TREES}
        for run in runs:
            got = json.loads(str(run["fused_launches"]))
            require(got == want, f"fused dp launch counts {got}, expected {want}")
        for key in ("exact", "wire"):
            for run in runs[1:]:
                require(all(np.array_equal(run[f"{key}_{k}"], runs[0][f"{key}_{k}"])
                            for k in ("feature", "threshold", "leaf")),
                        f"the {key} fused dp ranks' forests differ")
        wire = {k: runs[0][f"wire_{k}"][:WIRE_CHECKED_TREES]
                for k in ("feature", "threshold", "leaf")}
        exact = {k: runs[0][f"exact_{k}"][:WIRE_CHECKED_TREES]
                 for k in ("feature", "threshold", "leaf")}
        self.check_forest(exact, WIRE_CHECKED_TREES, "fused dp exact")
        wired = [runs[0][f"wired_{i}"] for i in range(WIRE_CHECKED_TREES * DEPTH)]
        worst, split = self.check_forest(wire, WIRE_CHECKED_TREES, "fused dp wire_i8",
                                         wired, exact)
        same = ("equal" if split is None else
                f"equal up to tree {split[0]} level {split[1]}, where the nodes printed "
                "above differ within the wire's error")
        leaf_d = float(np.abs(wire["leaf"] - exact["leaf"]).max())
        ms = {k: runs[0][f"{k}_ms"].tolist() for k in ("exact", "wire")}
        self.dp_fused_ms = ms
        print(f"  train_round_dp_fused, {DP_RANKS} gloo ranks (a hop's bytes in host memory: "
              "gloo stages CUDA tensors there, wire_i8's hops through parallel.wire_device): "
              "identical forests on both "
              f"ranks, exact and wire_i8; launches per rank {want}; wire_i8's first "
              f"{WIRE_CHECKED_TREES} trees: every level's summed histogram within "
              f"{worst:.3f} of the ring's error bound of the single-process one and its "
              f"best splits the tables (differences within the wire's error printed); "
              f"split tables against the exact round's: {same}; leaves max |wire - exact| "
              f"{leaf_d:.3e}")
        for k in ("exact", "wire"):
            print(f"  train_round_dp_fused {k} ms/round (in turns exact, wire, wire, "
                  f"exact, ...; rank 0): " + ", ".join(f"{x:.3f}" for x in ms[k]))

    def check_ranks(self, runs, n_trees: int, what: str):
        """The ranks' forests identical, depth launches a tree each."""
        for run in runs[1:]:
            require(all(np.array_equal(run[k], runs[0][k])
                        for k in ("feature", "threshold", "leaf")),
                    f"the {what} ranks' forests differ")
        launches = [int(run["launches"]) for run in runs]
        require(all(n == n_trees * DEPTH for n in launches),
                f"{what} ranks' node_histograms_kernel launches {launches}")
        return launches

    def check_forest(self, run, n_trees: int, what: str, wired=None, exact=None):
        """A forest grown across processes against the single-process round,
        teacher-forced on its own tables: a split may differ from the
        single-process histogram's best only at a printed near tie, the
        leaves are the single-process sums (within rtol 1e-4, atol 1e-6).
        For a forest grown over the int8 wire, ``wired`` holds the
        histograms its ranks summed, level by level: each level is held by
        ``wire_level``, and the leaves within rtol = atol = 1e-3.  ``exact``
        holds the exact round's forest: ``wire_level`` holds each level's
        tables to it up to the first level where they differ (past it the
        two rounds route their rows apart).  Returns the largest histogram
        error over its bound (0 without ``wired``) and that first level
        (None where the tables are equal)."""
        torch, gbdt = self.torch, self.gbdt
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES, n_trees=n_trees, depth=DEPTH,
                              n_bins=self.n_bins)
        forest = [torch.as_tensor(run[k], device=self.dev)
                  for k in ("feature", "threshold", "leaf")]
        margin = torch.zeros(self.n_rows, device=self.dev)
        shards = [slice(lo, hi) for lo, hi in gbdt.elastic.shard_bounds(self.n_rows, DP_RANKS)]
        worst, split = 0.0, None
        for t in range(n_trees):
            g, h = gbdt.gradients(cfg, margin, self.y)
            node = torch.zeros(self.n_rows, dtype=torch.int32, device=self.dev)
            for d in range(DEPTH):
                n = 2 ** d
                hist = self.hist.node_histograms_kernel(self.xb, g, h, node, n, self.n_bins)
                feat, thr = forest[0][t, d, :n], forest[1][t, d, :n]
                where = f"{what} tree {t} level {d}"
                if wired is None:
                    self.near_ties(hist, feat, thr, cfg, where, "ranks'")
                else:
                    partials = [self.hist.node_histograms_kernel(
                        self.xb[rows], g[rows], h[rows], node[rows], n, self.n_bins)
                        for rows in shards]
                    q = torch.as_tensor(wired[t * DEPTH + d], device=self.dev)
                    ref = None
                    if exact is not None and split is None:
                        ref = [torch.as_tensor(exact[k][t, d, :n], device=self.dev)
                               for k in ("feature", "threshold")]
                        if not (torch.equal(ref[0], feat) and torch.equal(ref[1], thr)):
                            split = (t, d)
                    worst = max(worst, self.wire_level(hist, q, partials, feat, thr, cfg,
                                                       where, ref))
                node = self.route(node, feat, thr)
            leaf_gh = self.hist.segment_sum(torch.stack([g, h], -1), node, 2 ** DEPTH)
            leaf = -cfg.learning_rate * leaf_gh[:, 0] / (leaf_gh[:, 1] + cfg.reg_lambda)
            rtol, atol = (1e-4, 1e-6) if wired is None else (1e-3, 1e-3)
            require(bool(torch.allclose(forest[2][t], leaf, rtol=rtol, atol=atol)),
                    f"{what} tree {t}: leaves differ from the single-process sums")
            margin = margin + forest[2][t][node.long()]
        return (worst, split) if wired is not None else worst

    # -- phase 8 ------------------------------------------------------------------
    def engine_phase(self):
        """The engine matrix through the port's api: in this process on
        NCCL at world 1 (arrays staged on the card), then the dp phase's
        DP_RANKS processes over gloo (_gloo_world_rank).  Returns each
        setting's times."""
        import torch.distributed as dist

        from rabit_tpu_torch import api

        out = {}
        api.init(engine_args("cuda", free_port(), 1, 0))
        try:
            require(dist.get_backend() == "nccl", "the engine did not start NCCL")
            out["nccl_world1"] = engine_matrix(api, basic_worker())
        finally:
            api.finalize()
        require(not dist.is_initialized(), "finalize left the process group up")
        out[f"gloo_world{DP_RANKS}"] = {k: float(v) for k, v in self.engine_runs[0].items()}
        self.gloo_hop_ms = out[f"gloo_world{DP_RANKS}"]["hop_ms"]
        for k, v in out.items():
            print(f"  engine matrix, {k}: every dtype x op equal to numpy_reduce, broadcast,"
                  f" allgather, prepare_fun, checkpoints; {v['matrix_s']:.2f} s; a 64-node"
                  f" histogram's SUM {v['hop_ms']:.3f} ms")
        return out

    # -- phase 9 ------------------------------------------------------------------
    def compress_phase(self):
        """The wire codecs on the card and the compressed api.allreduce:
        each codec's torch_encode bytes against numpy's encode, bit for bit,
        and its torch_decode against numpy's decode, on a depth-5 level
        histogram of the round (and on a block with an inf, a -inf and a
        NaN), with their device times; ring_allreduce_quantized and the
        fused ring on an NCCL group of one against the CPU and
        reference_allreduce; api.allreduce(codec=...) through TorchEngine on
        NCCL at world 1 and on DP_RANKS gloo processes with
        rabit_fused_allreduce on and off, each bitwise equal to
        reference_allreduce, each timed beside the exact SUM."""
        import torch.distributed as dist

        from rabit_tpu_torch import api, compress
        from rabit_tpu_torch.engine import fused
        from rabit_tpu_torch.parallel import ring_allreduce_quantized, wire_device

        torch = self.torch
        node3, feat, thr = self.level_inputs(5)
        hist, _ = self.boost.hist_level(self.xb3, node3, self.g3, self.h3, feat, thr,
                                        depth=5, n_bins=self.n_bins)
        x = hist.reshape(-1).contiguous()
        xs = x.cpu().numpy()
        n = xs.size
        require(n == LEVEL5, f"a depth-5 level histogram of {n} floats")
        bad = (np.random.RandomState(2).randn(1000) * 10).astype(np.float32)
        bad[1], bad[3], bad[4] = np.inf, np.nan, -np.inf
        out = {"codecs": {}}
        for name in CODECS:
            c = compress.get_codec(name)
            for arr in (xs, bad):
                enc = c.encode(arr)
                got = c.torch_encode(torch.as_tensor(arr, device=self.dev))
                require(got.cpu().numpy().tobytes() == enc,
                        f"{name}: torch_encode on the card differs from numpy's encode")
                dec = c.torch_decode(got, arr.size).cpu().numpy()
                require(np.array_equal(dec, c.decode(enc, arr.size), equal_nan=True),
                        f"{name}: torch_decode on the card differs from numpy's decode")
            packed = c.torch_encode(x)
            wire = c.wire_len(n)
            row = {"wire_bytes": wire, "ratio": 4 * n / wire,
                   "bound_ms": (4 * n + wire) / HBM_BYTES_PER_S * 1e3}
            for what, fn in (("encode", lambda: c.torch_encode(x)),
                             ("decode", lambda: c.torch_decode(packed, n))):
                row[f"{what}_ms"] = cuda_ms(torch, fn, 20)
                try:
                    row[f"{what}_device_ms"] = sum(kernel_ms(torch, fn, 20).values())
                except PhaseFailed:  # the profiler kept no whole profile
                    row[f"{what}_device_ms"] = None
            out["codecs"][name] = row
            print(f"  {name}: bytes equal numpy's, decode equal (incl. inf/-inf/NaN); "
                  f"{wire} wire bytes ({row['ratio']:.2f}x fewer than f32); encode "
                  f"{row['encode_ms']:.4f} ms ({dev_ms(row['encode_device_ms'])} on the device), "
                  f"decode {row['decode_ms']:.4f} ({dev_ms(row['decode_device_ms'])}); bound "
                  f"{row['bound_ms']:.4f} ms each")

        api.init(engine_args("cuda", free_port(), 1, 0))
        try:
            require(dist.get_backend() == "nccl", "the engine did not start NCCL")
            hop_bytes = wire_device(None, x.device)
            for planes in (1, 2):
                got = ring_allreduce_quantized(x, planes=planes)
                want = ring_allreduce_quantized(x.cpu(), planes=planes)
                require(got.device == x.device and got.cpu().numpy().tobytes()
                        == want.numpy().tobytes(),
                        f"ring_allreduce_quantized planes {planes}: the card's differs "
                        "from the CPU's")
            for name in FUSED_CODECS:
                fn = fused.build_fused_allreduce(None, (0,), api.SUM, compress.get_codec(name),
                                                 n, device=self.dev)
                ref = compress.reference_allreduce([xs], api.SUM, name)
                require(fn(x).cpu().numpy().tobytes() == ref.tobytes(),
                        f"the fused ring on the card ({name}) differs from reference_allreduce")
            nccl = {"exact_ms": _mean_ms(lambda: api.allreduce(xs, api.SUM), 10)}
            for name in FUSED_CODECS:
                got = api.allreduce(xs, api.SUM, codec=name)
                ref = compress.reference_allreduce([xs], api.SUM, name)
                require(got.tobytes() == ref.tobytes(),
                        f"api.allreduce codec={name} on NCCL differs from reference_allreduce")
                nccl[name] = _mean_ms(lambda: api.allreduce(xs, api.SUM, codec=name), 10)
            out["nccl_world1"] = nccl
        finally:
            api.finalize()
        print(f"  NCCL, world 1 (a hop's bytes would live on {hop_bytes}; the engine's "
              "fused ring is off at world 1, so api.allreduce takes the host transport): "
              "ring_allreduce_quantized (planes 1, 2) bitwise the CPU's; the fused ring on "
              "the card and api.allreduce(codec=...) bitwise reference_allreduce; ms "
              + json.dumps({k: round(v, 4) for k, v in nccl.items()}))
        runs = self.compress_runs  # run by phase 7's processes
        gloo = {}
        for r, run in enumerate(runs):
            for k, v in run.items():
                if k.startswith("equal/"):
                    require(bool(v), f"gloo rank {r}: api.allreduce {k[6:]} differs from "
                                     "reference_allreduce")
                if k.startswith("fused/"):
                    mode = k.split("/")[1]
                    require(bool(v) == (mode == "1"), f"gloo rank {r}: fused_active {k}")
            require(int(run["host_runs"]) == 0,
                    f"gloo rank {r}: the numpy host transport ran {run['host_runs']} times")
        for mode in ("1", "0"):
            gloo[mode] = {"exact_ms": float(runs[0][f"exact_ms/{mode}"])}
            gloo[mode].update({name: float(runs[0][f"ms/{mode}/{name}"])
                               for name in FUSED_CODECS})
        gloo["host"] = {name: float(runs[0][f"ms/host/{name}"]) for name in FUSED_CODECS}
        out[f"gloo_world{DP_RANKS}"] = gloo
        print(f"  gloo, {DP_RANKS} processes on one card (phase 8's world; "
              f"backend {runs[0]['backend']}, codec work on the card, a hop's bytes on "
              f"{runs[0]['wire']}): api.allreduce(codec=...) bitwise reference_allreduce "
              f"on every rank, the fused ring (1) and the unfused device path (0; no host "
              f"transport; the host transport itself timed as host); rank 0 ms "
              + json.dumps({m: {k: round(v, 4) for k, v in d.items()}
                            for m, d in gloo.items()}))
        return out

    # -- phase 10 -----------------------------------------------------------------
    def hybrid_phase(self):
        """Two workers on the card (phase 7's processes), each one process
        whose local group is an NCCL group of one, the hop the port's
        TorchEngine over gloo: the ranks' forests identical, depth + 1 hops a
        tree, the first two trees train_round_dp's (phase 7) but for printed
        near ties, every tree teacher-forced against the single-process
        round.  Returns ms/round (rank 0, rounds after the first)."""
        runs, n_trees = self.hybrid_runs, self.hybrid_trees
        launches = self.check_ranks(runs, n_trees, "hybrid")
        hops = [int(run["hops"]) for run in runs]
        require(hops == [n_trees * (DEPTH + 1)] * DP_RANKS,
                f"engine hops {hops}, expected {n_trees * (DEPTH + 1)} a rank")
        same = all(np.array_equal(runs[0][k][:2], self.dp_forest[k])
                   for k in ("feature", "threshold", "leaf"))
        self.hybrid_forest = np.concatenate([np.asarray(runs[0][k], np.float32).reshape(-1)
                                             for k in ("feature", "threshold", "leaf")])
        self.check_forest(runs[0], n_trees, "hybrid")
        ms = runs[0]["ms"].tolist()
        print(f"  hybrid, {DP_RANKS} workers on one card (phase 7's processes): "
              f"identical forests; launches per rank {launches}; hops per rank {hops}; "
              f"first two trees bitwise train_round_dp's: {same}; the single-process "
              "round's splits at every level; ms/round " + ", ".join(f"{x:.3f}" for x in ms))
        return sum(ms[1:]) / len(ms[1:])

    # -- phase 11 -----------------------------------------------------------------
    def recover_run(self, mode: str, *args: str, preempt=None, wedge=None,
                    engine: str = "mock", obs: bool = False, keep_obs: str = "",
                    relays: int = 0, on_cluster=None) -> dict:
        """DP_RANKS workers of tests/workers/torch_gbdt_native_worker.py on
        the card under the port's LocalCluster, rabit_engine=``engine``:
        each trains RECOVER_TREES trees of the headline data (its elastic
        shard) in ``mode``.  Fails unless every worker ends with exit 0.
        Returns rank 0's forest, the restarts, preemptions and wedges, the
        workers' stats and registry files, the commit stamps, the kill and
        freeze times and the tracker's telemetry; with ``obs``, the workers
        and the tracker get RABIT_OBS_DIR=<tmp>/obs, and the run the files
        there (telemetry.json read back); ``keep_obs`` (a directory) keeps a
        copy of the obs dir past the run.  The delays of ``preempt`` and
        ``wedge`` count from the run's first commit of version 1 (a
        worker's print to the tracker), not from launch: a process's start
        on the card varies by seconds between runs.  ``relays`` puts that many
        relays between the workers and the tracker.  ``on_cluster(cluster)``,
        called before the run, returns the run's ``linger`` predicate (the
        tracker and the relays keep serving once the workers are gone until
        it holds)."""
        from rabit_tpu_torch.tracker.launcher import LocalCluster

        with tempfile.TemporaryDirectory() as tmp:
            obs_dir = os.path.join(tmp, "obs")
            cmd = [sys.executable, worker_path("torch_gbdt_native_worker"),
                   f"rabit_engine={engine}", f"mode={mode}", "device=cuda",
                   f"rows={self.n_rows}", f"ntrees={RECOVER_TREES}",
                   f"out={os.path.join(tmp, 'forest')}", f"stats={tmp}", *args]
            cluster = LocalCluster(DP_RANKS, max_restarts=2, quiet=True, relays=relays)
            linger = on_cluster(cluster) if on_cluster is not None else None
            t0 = time.time()
            if obs:
                os.environ["RABIT_OBS_DIR"] = obs_dir  # the tracker's too
            try:
                cluster.run(cmd, timeout=600, preempt=preempt, wedge=wedge, linger=linger,
                            start_when=lambda _: any(COMMIT_1.search(m)
                                                     for m in list(cluster.messages)))
            except (RuntimeError, TimeoutError) as e:
                raise PhaseFailed(f"{engine} {mode} {list(args)}: {e}") from e
            finally:
                os.environ.pop("RABIT_OBS_DIR", None)
            require(all(rc == 0 for rc in cluster.returncodes.values()),
                    f"{engine} {mode} {list(args)}: workers exited {cluster.returncodes}")
            run = {"forest": np.load(os.path.join(tmp, "forest.npy")), "t0": t0,
                   "wall_s": time.time() - t0, "restarts": sum(cluster.restarts.values()),
                   "preempts": cluster.preempts_delivered, "deaths": cluster.death_times,
                   "wedges": cluster.wedge_times, "telemetry": cluster.telemetry,
                   "obs_files": sorted(os.listdir(obs_dir)) if os.path.isdir(obs_dir) else [],
                   "stats": [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                             for r in range(DP_RANKS)],
                   "registry": [read_json(os.path.join(tmp, f"rank{r}.registry.json"))
                                for r in range(DP_RANKS)]}
            if "telemetry.json" in run["obs_files"]:
                run["telemetry_file"] = read_json(os.path.join(obs_dir, "telemetry.json"))
            if keep_obs:
                shutil.copytree(obs_dir, keep_obs, dirs_exist_ok=True)
        # "[rank] commit version=V attempt=A t=T" after every commit
        run["commits"] = [tuple(float(x) for x in m.groups()) for m in (
            re.search(r"\[(\d+)\] commit version=(\d+) attempt=(\d+) t=([\d.]+)", msg)
            for msg in cluster.messages) if m]
        counts = {}
        for st in run["stats"]:
            for k, v in st.items():
                if k.startswith("launches/"):
                    counts[k[9:]] = counts.get(k[9:], 0) + int(v)
        want = ("node_histograms_kernel", *HELPERS)
        require(all(counts.get(k, 0) > 0 for k in want) and set(counts) <= set(want),
                f"{engine} {mode} {list(args)}: launches {counts}")
        for k, v in counts.items():
            self.launches[k] += v
        run["launches"] = counts
        return run

    def recovery_s(self, run) -> float:
        """Seconds from the first death to the restarted life's next commit."""
        after = [t for _, _, attempt, t in run["commits"] if attempt > 0]
        require(bool(after) and bool(run["deaths"]), "no commit after the restart")
        return min(after) - run["deaths"][0]

    def recover_phase(self):
        """The port's fault-tolerant engine on the card: the native mock
        engine under the port's tracker and launcher, DP_RANKS workers on
        the one card, a clean run of each mode (train_round with the hop on
        every level's histogram and the leaf masses, under the robust engine
        with the liveness phase's leases and obs, whose clean run it is;
        train_round_hybrid, a worker an NCCL group of one), then a mock kill
        mid-tree (rank 1, version 1, the level-2 histogram's hop), a kill in
        the checkpoint commit window (seqno -3) and one timed SIGKILL.  Every
        run's forest byte-identical to its mode's clean run, the ranks' identical (each
        worker checks), restarts equal to kills, and the clean hybrid forest
        the hybrid phase's (whose hops crossed TorchEngine over gloo)."""
        clean = {}
        for mode in ("gbdt", "hybrid"):
            # the clean gbdt run is also the liveness phase's clean run: the
            # robust engine with leases and obs, one job less to start
            run = (self.recover_run(mode, *LIVE_ARGS, engine="robust", obs=True) if mode == "gbdt"
                   else self.recover_run(mode, "time_hop=1"))
            want = {k: RECOVER_TREES * DEPTH * DP_RANKS for k in ("node_histograms_kernel",
                                                                  *HELPERS)}
            require(run["restarts"] == 0 and run["launches"] == want,
                    f"clean {mode}: restarts {run['restarts']}, launches {run['launches']}")
            clean[mode] = run
            ms = run["stats"][0]["ms"].tolist()
            print(f"  clean {mode}: {run['wall_s']:.1f} s incl. start-up; ms/round "
                  + ", ".join(f"{x:.3f}" for x in ms) + f"; accuracy "
                  f"{float(run['stats'][0]['acc']):.4f}; launches {run['launches']}")
        require(np.array_equal(clean["hybrid"]["forest"], self.hybrid_forest),
                "the clean hybrid forest over the native engine differs from the hybrid "
                "phase's over TorchEngine")
        hop = {k: float(clean["hybrid"]["stats"][0][k]) for k in ("hop_ms", "hop_tensor_ms")}
        delay = 1.5 * RECOVER_PAUSE  # after the first commit: in the pause before tree 3
        # the mid-tree kill also leaves the trace the diagnose phase merges:
        # every rank's exit dump and telemetry.json, rank 0 a straggler
        self.trace_obs = tempfile.mkdtemp(prefix="rabit-trace-obs-")
        kills = [("gbdt", "mid-tree mock kill (rank 1, version 1, level-2 hop; rank 0 "
                  f"{TRACE_STRAGGLE} s late to each tree, obs and exit dumps on; behind "
                  f"{RELAYS} relays)",
                  ["mock=1,1,2,0", "rabit_trace_exit=1", "straggler=0",
                   f"straggler_sleep={TRACE_STRAGGLE}"], None),
                 ("hybrid", "commit-window mock kill (rank 0, version 1, seqno -3)",
                  ["mock=0,1,-3,0"], None),
                 ("hybrid", f"SIGKILL of rank 1 {delay:.1f} s after the first commit",
                  [f"pause={RECOVER_PAUSE}"],
                  [(delay, 1)])]
        out = {"hop": hop, "recovery_s": {}, "ms": {m: r["stats"][0]["ms"].tolist()
                                                     for m, r in clean.items()}}
        for mode, what, args, preempt in kills:
            traced = "rabit_trace_exit=1" in args
            # the traced kill runs behind RELAYS relays: it is the relay phase's run (d)
            run = self.recover_run(mode, *args, preempt=preempt, obs=traced,
                                   keep_obs=self.trace_obs if traced else "",
                                   relays=RELAYS if traced else 0)
            require(np.array_equal(run["forest"], clean[mode]["forest"]),
                    f"{what}: the forest differs from the clean {mode} run's")
            require(run["restarts"] == 1 and run["preempts"] == (1 if preempt else 0),
                    f"{what}: {run['restarts']} restarts, {run['preempts']} preemptions")
            out["recovery_s"][what] = self.recovery_s(run)
            if traced:  # the relay phase's run (d)
                self.mid_tree_kill = run
            print(f"  {what} ({mode}): forest byte-identical to the clean run's; restarts "
                  f"{run['restarts']}; from the death to the restarted worker's next "
                  f"commit {out['recovery_s'][what]:.2f} s; run {run['wall_s']:.1f} s")
        self.clean_gbdt = clean["gbdt"]
        same = np.array_equal(clean["gbdt"]["forest"], clean["hybrid"]["forest"])
        print(f"  clean hybrid forest bitwise the hybrid phase's (TorchEngine over gloo): "
              f"True; clean gbdt forest bitwise the clean hybrid's: {same}")
        print(f"  one depth-6 level histogram's hop (64 x {N_FEATURES} x {N_BINS} x 2 f32) "
              f"through the native engine: {hop['hop_ms']:.3f} ms as numpy, "
              f"{hop['hop_tensor_ms']:.3f} ms from the card; TorchEngine over gloo (engine "
              f"phase) {self.gloo_hop_ms:.3f} ms")
        return out

    # -- phase 12 -----------------------------------------------------------------
    def liveness_phase(self):
        """Leases, the watchdog and obs on the card: the recover phase's
        gbdt job under rabit_engine=robust with heartbeat leases, the flight
        recorder and -exit dumps on.  (a) A clean run: the forest the
        recover phase's clean gbdt forest, two ranks' snapshots in the
        telemetry each counting one allreduce a hop and the accuracy count,
        no lease expired, an -exit dump a rank.  (b) Rank 1 frozen (SIGSTOP)
        after its first commit: its lease expires within
        (1 + LEASE_FACTOR) x hb + 1 s of the freeze, the launcher SIGKILLs
        and restarts it (one restart, a recovery wave restarting "1"), and
        the forest is (a)'s.  (c) Dump-then-die: rank 1 frozen again, with
        no lease; rank 0, stuck in its next hop, dumps -hang and -abort and
        exits with HANG_ABORT_EXIT within 10 s."""
        from rabit_tpu_torch.tracker.protocol import LEASE_FACTOR

        # (a) is the recover phase's clean gbdt run; the delivery phase's (a),
        # the mock engine with obs off, is held to its forest
        clean = self.clean_gbdt
        t = clean["telemetry"]
        require(clean["restarts"] == 0 and t["n_lease_expired"] == 0,
                f"clean: restarts {clean['restarts']}, leases expired {t['n_lease_expired']}")
        require(clean.get("telemetry_file") == t, "clean: telemetry.json differs from the "
                "tracker's document, or is missing")
        require(set(t["ranks"]) == {str(r) for r in range(DP_RANKS)},
                f"clean: snapshots of ranks {sorted(t['ranks'])}")
        for r, reg in enumerate(clean["registry"]):
            calls = t["ranks"][str(r)]["metrics"]["ops"]["allreduce"]["calls"]
            require(reg["hops"] == RECOVER_TREES * (DEPTH + 1) and calls == reg["hops"] + 1,
                    f"clean: rank {r} made {reg['hops']} hops, its snapshot {calls} allreduces")
        exits = sorted(n.split("-")[1] for n in clean["obs_files"] if n.endswith("-exit.jsonl"))
        require(exits == [f"rank{r}" for r in range(DP_RANKS)], f"clean: exit dumps {exits}")
        ms = clean["stats"][0]["ms"].tolist()
        print(f"  (a) clean, obs and leases on (the recover phase's clean gbdt run): "
              f"{clean['wall_s']:.1f} s incl. start-up; snapshots of "
              f"ranks {sorted(t['ranks'])}, allreduce calls = hops + 1; exit dumps {exits}; "
              "ms/round " + ", ".join(f"{x:.3f}" for x in ms))

        delay = 1.5 * RECOVER_PAUSE  # after the first commit
        wedged = self.recover_run("gbdt", *LIVE_ARGS, f"pause={RECOVER_PAUSE}", engine="robust",
                                  obs=True, wedge=[(delay, 1)])
        t = wedged["telemetry"]
        require(len(wedged["wedges"]) == 1, f"frozen: {len(wedged['wedges'])} wedges landed")
        leases = [e for e in t["events"] if e["kind"] == "lease_expired"]
        require(bool(leases) and leases[0]["task_id"] == "1", f"frozen: lease expiries {leases}")
        detect = leases[0]["ts"] - wedged["wedges"][0]
        bound = (1 + LEASE_FACTOR) * LIVE_HB + 1.0
        require(0 < detect < bound, f"frozen: lease expired {detect:.3f} s after the freeze "
                f"(bound {bound} s)")
        require(any(w["epoch"] > 0 and w["ts"] > leases[0]["ts"] and "1" in w["restarted"]
                    for w in t["waves"]), f"frozen: no recovery wave restarted 1: {t['waves']}")
        require(t["n_lease_expired"] >= 1 and wedged["restarts"] == 1 and t["restarts"] == {"1": 1},
                f"frozen: {t['n_lease_expired']} expiries, restarts {wedged['restarts']}, "
                f"{t['restarts']}")
        require(np.array_equal(wedged["forest"], clean["forest"]),
                "frozen: the forest differs from the clean run's")
        after = [ts for _, _, attempt, ts in wedged["commits"] if attempt > 0]
        require(bool(after), "frozen: the restarted worker never committed")
        to_commit = min(after) - wedged["wedges"][0]
        print(f"  (b) rank 1 frozen {delay:.1f} s after the first commit: lease expired after {detect:.3f} s "
              f"(bound {bound} s), SIGKILL and one restart; from the freeze to the restarted "
              f"worker's next commit {to_commit:.2f} s; forest byte-identical to (a)'s; run "
              f"{wedged['wall_s']:.1f} s")

        hang = self.hang_abort()
        print(f"  (c) rank 1 frozen, no lease: rank 0 exited {hang['rc']} {hang['abort_s']:.2f} s "
              f"after the freeze, dumps {hang['dumps']}")
        return {"ms": ms, "detect_s": detect, "freeze_to_commit_s": to_commit,
                "abort_s": hang["abort_s"], "clean_wall_s": clean["wall_s"],
                "frozen_wall_s": wedged["wall_s"]}

    def hang_abort(self) -> dict:
        """Dump-then-die: two gbdt workers on the card under a tracker of
        this process; rank 0 with rabit_obs_hang_sec=1, rabit_hang_abort_sec=3
        and the native detectors parked at 120 s.  Rank 1 is SIGSTOPped when
        its first commit arrives; rank 0 must exit with HANG_ABORT_EXIT
        within 10 s, leaving a -hang and an -abort dump, the latter holding
        hang_detected and hang_abort.  Then every process is killed."""
        from rabit_tpu_torch.obs import HANG_ABORT_EXIT
        from rabit_tpu_torch.tracker.tracker import Tracker

        with tempfile.TemporaryDirectory() as tmp:
            obs_dir = os.path.join(tmp, "obs")
            tracker = Tracker(DP_RANKS, quiet=True).start()
            procs = []
            try:
                for rank in range(DP_RANKS):
                    env = dict(os.environ, DMLC_TRACKER_URI=tracker.host,
                               DMLC_TRACKER_PORT=str(tracker.port), DMLC_TASK_ID=str(rank),
                               DMLC_NUM_ATTEMPT="0")
                    cmd = [sys.executable, worker_path("torch_gbdt_native_worker"),
                           "rabit_engine=robust", "mode=gbdt", "device=cuda",
                           f"rows={self.n_rows}", f"ntrees={RECOVER_TREES}", f"pause={HANG_PAUSE}",
                           f"rabit_obs_dir={obs_dir}"]
                    if rank == 0:
                        cmd += ["rabit_obs_hang_sec=1", "rabit_hang_abort_sec=3",
                                "rabit_stall_timeout_sec=120", "rabit_timeout_sec=120"]
                    # each worker in a session of its own: a stopped process
                    # left in this script's process group exposes the whole
                    # group to the kernel's SIGHUP of an orphaned group with
                    # stopped members
                    with open(os.path.join(tmp, f"rank{rank}.err"), "w") as err:
                        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                                      stderr=err, start_new_session=True))
                deadline = time.time() + 300
                while not any(m.startswith("[1] commit version=1") for m in list(tracker.messages)):
                    require(time.time() < deadline and all(p.poll() is None for p in procs),
                            f"dump-then-die: no first commit of rank 1 (exits "
                            f"{[p.poll() for p in procs]})")
                    time.sleep(0.01)
                os.kill(procs[1].pid, signal.SIGSTOP)
                frozen = time.time()
                while procs[0].poll() is None and time.time() - frozen < 20:
                    time.sleep(0.01)
                abort_s = time.time() - frozen
                rc = procs[0].poll()
                with open(os.path.join(tmp, "rank0.err")) as f:
                    err = f.read()[-2000:]
                require(rc == HANG_ABORT_EXIT and abort_s < 10,
                        f"dump-then-die: rank 0 exited {rc} after {abort_s:.2f} s: {err}")
                names = sorted(os.listdir(obs_dir))
                hang = [n for n in names if n.startswith("flight-rank0-") and n.endswith("-hang.jsonl")]
                aborts = [n for n in names
                          if n.startswith("flight-rank0-") and n.endswith("-abort.jsonl")]
                require(len(hang) == 1 and len(aborts) == 1, f"dump-then-die: dumps {names}")
                kinds = dump_kinds(os.path.join(obs_dir, aborts[0]))
                require("hang_detected" in kinds and "hang_abort" in kinds,
                        f"dump-then-die: the abort dump holds {kinds}")
                return {"rc": rc, "abort_s": abort_s, "dumps": names}
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()  # a stopped process dies too
                    p.wait()
                tracker.stop()

    # -- phase 13 -----------------------------------------------------------------
    def elastic_expected(self, ew):
        """The elastic job's totals: one world-1 run of node_histograms_kernel
        on the card over all rows, a version at a time (int64, exact), and
        version 1 held against node_histograms_kernel_plain.  These
        launches are a comparison's: they do not count."""
        torch = self.torch
        node = torch.as_tensor(ew.row_nodes(self.n_rows, ELASTIC_NODES), device=self.dev)
        h = torch.ones(self.n_rows, device=self.dev)
        total = None
        for v in range(1, ELASTIC_VERSIONS + 1):
            g = torch.as_tensor(ew.row_grads(0, self.n_rows, v), device=self.dev)
            hv = self.hist.node_histograms_kernel(self.xb, g, h, node, ELASTIC_NODES, self.n_bins)
            if v == 1:
                plain = self.hist.node_histograms_kernel_plain(self.xb, g, h, node,
                                                               ELASTIC_NODES, self.n_bins)
                require(torch.equal(hv, plain), "the elastic job's histogram differs from "
                        "node_histograms_kernel_plain")
                require(bool((hv == hv.round()).all()) and float(hv.abs().max()) < 2 ** 24,
                        "the elastic job's histogram is not exact integers")
            hv = hv.to(torch.int64).cpu().numpy()
            total = hv if total is None else total + hv
        return total

    def elastic_run(self, what: str, *args: str, spares: int = 0, shrink: float = 0.0,
                    max_restarts: int = 0, preempt=None, start_when=None) -> dict:
        """DP_RANKS workers of tests/workers/torch_elastic_worker.py on the
        card (and ``spares`` hot spares) under the port's LocalCluster and
        tracker, ElasticWorker over node_histograms_kernel at the headline
        width, heartbeats on.  Fails unless every process exits 0.  Returns
        each life's result (state, worlds, commit wall times, launches), the
        tracker's events and telemetry, the deaths and the restarts."""
        from rabit_tpu_torch.tracker.launcher import LocalCluster

        with tempfile.TemporaryDirectory() as tmp:
            cmd = [sys.executable, worker_path("torch_elastic_worker"), "device=cuda",
                   f"rows={self.n_rows}", f"bins={self.n_bins}", f"nodes={ELASTIC_NODES}",
                   f"niter={ELASTIC_VERSIONS}", f"sleep={ELASTIC_SLEEP}", f"hb={ELASTIC_HB}",
                   "deadline=240", f"out={tmp}", *args]
            cluster = LocalCluster(DP_RANKS, max_restarts=max_restarts, quiet=True,
                                   spares=spares, shrink_after_sec=shrink)
            t0 = time.time()
            try:
                cluster.run(cmd, timeout=300, preempt=preempt, start_when=start_when)
            except (RuntimeError, TimeoutError) as e:
                raise PhaseFailed(f"elastic {what}: {e}") from e
            require(all(rc == 0 for rc in cluster.returncodes.values()),
                    f"elastic {what}: workers exited {cluster.returncodes}")
            lives = {os.path.basename(f)[:-4]: dict(np.load(os.path.join(tmp, f)))
                     for f in os.listdir(tmp) if f.endswith(".npz")}
        counts = {}
        for life in lives.values():
            for k, v in life.items():
                if k.startswith("launches/"):
                    counts[k[9:]] = counts.get(k[9:], 0) + int(v)
        return {"lives": lives, "events": list(cluster.events), "telemetry": cluster.telemetry,
                "deaths": list(cluster.death_times), "restarts": dict(cluster.restarts),
                "preempts": cluster.preempts_delivered, "wall_s": time.time() - t0,
                "launches": counts}

    def elastic_check(self, run, what: str, want) -> list[dict]:
        """Every completed life's state bitwise ``want``; the launches are
        the kernel and its helpers only, one each a contribution, added to
        the report's; the telemetry's three elastic keys count the events.
        Returns the completed lives."""
        done = [life for life in run["lives"].values() if bool(life["completed"])]
        require(len(done) >= 1, f"elastic {what}: no worker completed")
        for life in done:
            require(np.array_equal(life["state"], want),
                    f"elastic {what}: a completed state differs from the expected totals")
        counts = run["launches"]
        want_keys = ("node_histograms_kernel", *HELPERS)
        require(all(counts.get(k, 0) > 0 for k in want_keys) and set(counts) <= set(want_keys)
                and len({counts[k] for k in want_keys}) == 1,
                f"elastic {what}: launches {counts}")
        for k, v in counts.items():
            self.launches[k] += v
        t = run["telemetry"]
        for key, kind in (("n_spares_promoted", "spare_promoted"),
                          ("n_shrunk", "world_shrunk"), ("n_grown", "world_grown")):
            n = sum(1 for e in run["events"] if e["kind"] == kind)
            require(t[key] == n, f"elastic {what}: telemetry {key} {t[key]}, {n} {kind} events")
        return done

    def death_to_commit(self, run, what: str) -> float:
        """Seconds from the first death to the next commit of any worker."""
        after = [t for life in run["lives"].values() for _, t in life["commits"]
                 if run["deaths"] and t > run["deaths"][0]]
        require(bool(run["deaths"]) and bool(after), f"elastic {what}: no commit after the death")
        return min(after) - run["deaths"][0]

    def elastic_phase(self):
        """The elastic plane on the card: DP_RANKS ElasticWorkers sharing the
        card, each histogramming its shard_slice of the headline bins
        (ELASTIC_NODES nodes, integer g, h = 1: exact, folded as int64)
        with node_histograms_kernel, ELASTIC_VERSIONS versions a run.  (a)
        A clean run, with no pause before a contribution; (b) rank 1 SIGKILLed once version 2 is committed, no
        spare, one restart (the restart baseline); (c) the same kill with a
        warm spare parked (the card touched, the bins resident, one
        contribution launched before it parks): the spare is promoted in one
        wave, every epoch at world 2, the restarted worker parks as a
        surplus spare and is released; (d) rank 1 dies at version 3 with no
        spare and shrink_after_sec (heartbeats every ELASTIC_SHRINK_HB): the
        world shrinks to 1, and a spare that parks once it has shrunk grows
        it back.  Every completed state is
        bitwise the world-1 totals; the seconds from the death to the next
        commit are printed for (b) and (c)."""
        ew = worker_module("torch_elastic_worker")
        want = self.elastic_expected(ew)

        def parked(ev):
            return any(e["kind"] == "spare_parked" for e in ev)

        def committed(ev):  # rank 0 uploads its state after each commit
            return any(e["kind"] == "bootstrap_blob" and e["version"] >= 2 for e in ev)

        out = {}
        clean = self.elastic_run("clean", "sleep=0")  # no kill to land: no pause
        done = self.elastic_check(clean, "(a) clean", want)
        evidence = [{k: e[k] for k in ("ts", "kind", "class", "src", "dst", "rank") if k in e}
                    for e in clean["events"] if e["kind"] in (
                        "wave", "incident_opened", "link_degraded", "schedule_repaired",
                        "lease_expired", "wave_purged")]
        require(len(done) == DP_RANKS and all(list(d["worlds"]) == [DP_RANKS] for d in done)
                and clean["launches"]["node_histograms_kernel"] == DP_RANKS * ELASTIC_VERSIONS,
                f"(a) clean: worlds {[list(d['worlds']) for d in done]}, launches "
                f"{clean['launches']}; the tracker's waves, incidents and flags {evidence}")
        print(f"  (a) clean: {clean['wall_s']:.1f} s incl. start-up; states bitwise the "
              f"world-1 totals; launches {clean['launches']}")

        restart = self.elastic_run("restart", max_restarts=1, preempt=[(0.0, 1)],
                                   start_when=committed)
        self.elastic_check(restart, "(b) restart", want)
        require(restart["preempts"] == 1 and restart["restarts"]["1"] == 1
                and restart["telemetry"]["n_spares_promoted"] == 0,
                f"(b) restart: {restart['preempts']} kills, restarts {restart['restarts']}")
        out["restart_s"] = self.death_to_commit(restart, "(b) restart")
        print(f"  (b) SIGKILL of rank 1 after version 2, no spare: one restart; from the death "
              f"to the next commit {out['restart_s']:.3f} s; run {restart['wall_s']:.1f} s")

        hot = self.elastic_run("hot spare", spares=1, max_restarts=1, preempt=[(0.0, 1)],
                               start_when=lambda ev: parked(ev) and committed(ev))
        self.elastic_check(hot, "(c) hot spare", want)
        t = hot["telemetry"]
        surplus = [e["task_id"] for e in hot["events"] if e["kind"] == "spare_parked"]
        require(hot["preempts"] == 1 and t["n_spares_promoted"] >= 1
                and all(ep["world"] == DP_RANKS for ep in t["epochs"]) and "1" in surplus,
                f"(c) hot spare: {hot['preempts']} kills, {t['n_spares_promoted']} promoted, "
                f"epochs {t['epochs']}, parked {surplus}")
        require(any(bool(life["parked_only"]) for k, life in hot["lives"].items()
                    if k.startswith("1-")), "(c) hot spare: the restarted worker did not park")
        out["hot_spare_s"] = self.death_to_commit(hot, "(c) hot spare")
        print(f"  (c) the same kill with a warm spare parked: promoted in one wave, epochs "
              f"{[ep['world'] for ep in t['epochs']]}, the restarted worker parked (spares "
              f"parked {surplus}); from the death to the next commit {out['hot_spare_s']:.3f} s "
              f"(restart: {out['restart_s']:.3f} s); run {hot['wall_s']:.1f} s")

        shrink = self.elastic_run("shrink", "die=1:3", "park_after_shrink=1",
                                  f"world={DP_RANKS}", f"hb={ELASTIC_SHRINK_HB}", spares=1,
                                  shrink=ELASTIC_SHRINK)
        self.elastic_check(shrink, "(d) shrink", want)
        t = shrink["telemetry"]
        worlds = [ep["world"] for ep in t["epochs"]]
        require(t["n_shrunk"] >= 1 and t["n_grown"] >= 1 and 1 in worlds
                and worlds[-1] == DP_RANKS, f"(d) shrink: {t['n_shrunk']} shrunk, "
                f"{t['n_grown']} grown, epochs {t['epochs']}")
        print(f"  (d) rank 1 dies at version 3, no spare, shrink_after_sec={ELASTIC_SHRINK}, "
              f"heartbeats every {ELASTIC_SHRINK_HB} s: "
              f"worlds {worlds} (world_shrunk, then world_grown when the spare parked); states "
              f"bitwise the totals; run {shrink['wall_s']:.1f} s")
        out.update({k: r["wall_s"] for k, r in (("clean_wall_s", clean),
                                                ("restart_wall_s", restart),
                                                ("hot_wall_s", hot), ("shrink_wall_s", shrink))})
        return out

    # -- phase 14 -----------------------------------------------------------------
    def diag_work(self, ew, wide: bool = False):
        """The diagnose phase's contribution and its world-1 totals.  A
        worker's contribution is node_histograms_kernel over its shard_slice
        of the headline bins (ELASTIC_NODES nodes, the elastic job's integer
        g, h = 1: exact), folded on the card to [nodes, 2] int64 by a
        bin-position weight (sum over f, b of (f B + b + 1) hist[n, f, b]):
        exact and linear, so the ranks' folds sum to the world-1 fold, and a
        misplaced bin changes it.  The fold keeps a ring frame at 1 KiB: the
        chaos proxy delays every 4 KiB chunk it forwards, so the 7.3 MB
        histogram would take minutes a hop across the slow link.  g is
        computed on the card, so a contribution takes the host well under a
        millisecond and balanced workers show no wait a detection window
        could count; launches are serialized (the workers are threads of
        this process).  The totals equal the elastic worker's row_grads
        (version 1 also checked against them in numpy).  Returns
        work(version, world, rank), totals(n_versions) and plain_of(version,
        world, rank) (the fold of node_histograms_kernel_plain on the same
        shard, the contribution the quorum accounting subtracts); the
        totals' launches (version 1 held against node_histograms_kernel_plain)
        are a comparison's and do not count.  ``wide`` keeps the histogram
        unfolded, [nodes, F, B, 2] int64 (7.34 MB at the headline size), the
        block a user's histogram allreduce sends, for QUORUM_VERSIONS["wide"]
        versions."""
        from rabit_tpu_torch.elastic import shard_slice

        torch = self.torch
        node = torch.as_tensor(ew.row_nodes(self.n_rows, ELASTIC_NODES), device=self.dev)
        row = torch.arange(self.n_rows, device=self.dev, dtype=torch.int64)
        weight = (torch.arange(N_FEATURES * self.n_bins, device=self.dev, dtype=torch.int64)
                  + 1).reshape(1, N_FEATURES, self.n_bins, 1)
        lock = threading.Lock()

        def hist(version, rows, fn):
            # ew.row_grads on the card: the host stays out of a worker's turn
            g = ((7 * row[rows] + 13 * version) % 17 - 8).to(torch.float32)
            return fn(self.xb[rows], g, torch.ones_like(g), node[rows], ELASTIC_NODES,
                      self.n_bins)

        def fold(hv):
            if wide:
                return hv.to(torch.int64).cpu().numpy()
            return (hv.to(torch.int64) * weight).sum((1, 2)).cpu().numpy()

        def kernel(*a):
            with lock:  # the launch counters are plain dict adds
                return self.hist.node_histograms_kernel(*a)

        def work(version: int, world: int, rank: int) -> np.ndarray:
            return fold(hist(version, shard_slice(self.n_rows, world, rank), kernel))

        def plain_of(version: int, world: int, rank: int) -> np.ndarray:
            return fold(hist(version, shard_slice(self.n_rows, world, rank),
                             self.hist.node_histograms_kernel_plain))

        whole = slice(0, self.n_rows)
        per_version = []
        n_versions = (QUORUM_VERSIONS["wide"] if wide
                      else max(*DIAG_VERSIONS.values(), *RELAY_VERSIONS.values()))
        for v in range(1, n_versions + 1):
            hv = hist(v, whole, self.hist.node_histograms_kernel)
            if v == 1:
                g = ew.row_grads(0, self.n_rows, v)
                require(np.array_equal(((7 * row + 13 * v) % 17 - 8).to(torch.float32)
                                       .cpu().numpy(), g), "g on the card differs from "
                        "row_grads")
                plain = hist(v, whole, self.hist.node_histograms_kernel_plain)
                require(bool(torch.equal(hv, plain)), "the diagnose job's histogram differs "
                        "from node_histograms_kernel_plain")
            per_version.append(fold(hv))
        return work, lambda n: sum(per_version[:n]), plain_of

    def diag_run(self, dj, what: str, world: int, work, want, **kw) -> dict:
        """One job of tests/workers/torch_diag_job.py: ``world`` ElasticWorker
        threads against an in-process port Tracker, DIAG_VERSIONS[what]
        versions; every completed state bitwise ``want``, and
        node_histograms_kernel (and its helpers) launched once a worker and
        version, with the counts set to 0 just before the run and read just
        after."""
        niter = DIAG_VERSIONS[what]
        self.clear_counts()
        t0 = time.time()
        try:
            out = dj.run_job(world, niter, work, iter_sleep=DIAG_SLEEP, deadline_sec=90.0, **kw)
        except TimeoutError as e:
            raise PhaseFailed(f"diagnose {what}: {e}") from e
        counts = self.read_counts(world * niter)
        require(counts == {"node_histograms_kernel": world * niter},
                f"diagnose {what}: launches {counts}, expected {world * niter} of "
                "node_histograms_kernel")
        for tid, res in sorted(out["results"].items()):
            require(res.completed and res.final_version == niter, f"diagnose {what}: task "
                    f"{tid} did not complete: {res.error}")
            require(np.array_equal(res.state, want(niter)),
                    f"diagnose {what}: task {tid}'s state differs from the world-1 totals")
        out["t0"] = t0
        out["launches"] = counts
        out["opened_s"] = [round(e["ts"] - t0, 3) for e in out["events"]
                           if e["kind"] == "incident_opened"]
        return out

    @staticmethod
    def incidents_of(out) -> list:
        inc = out["incidents"]
        return [(i["class"], i["subject"]) for i in inc["open"] + inc["recent"]]

    def diagnose_phase(self):
        """The diagnosis plane on the card.  Three jobs of ElasticWorker
        threads (tests/workers/torch_diag_job.py) against an in-process port
        Tracker, each worker's contribution node_histograms_kernel on the
        card (diag_work): (a) world 3, clean: no incident; (b) world 3,
        schedule ring, rank 1's frames into rank 2 delayed by a ChaosProxy
        in front of rank 2's socket: one degraded-link incident naming
        (1, 2) with link-wait-attributed evidence, the schedule repaired, a
        later ring with no 1 -> 2 hop, obs.top scraped from a thread while it
        runs (the open incident, rendered), and the scrape at the job's end
        equal to telemetry.json's stream; (c) world 4, rank 2 a compute
        straggler: one compute-straggler incident naming rank 2.  Then the
        recover phase's traced kill run: export_job and critical_path_report
        over its obs dir (a valid trace, (version, seqno) identities equal
        across ranks, a clock a rank within 0.5 s, rank 0 first by arrival
        skew and among the gating ranks, the recovery's collectives apart,
        telemetry.json gains stragglers and critical_path)."""
        from rabit_tpu_torch.obs import critical, top, trace
        from rabit_tpu_torch.obs.events import load_dump

        ew = worker_module("torch_elastic_worker")
        dj = worker_module("torch_diag_job")
        work, want, _ = self.diag_work(ew)
        out = {}

        clean = self.diag_run(dj, "clean", 3, work, want)
        require(self.incidents_of(clean) == [] and clean["n_repaired"] == 0,
                f"(a) clean: incidents {self.incidents_of(clean)}")
        print(f"  (a) clean, world 3, {DIAG_VERSIONS['clean']} versions: no incident; states "
              f"bitwise the world-1 totals; launches {clean['launches']}; "
              f"{clean['elapsed']:.1f} s")

        src, dst, delay = DIAG_SLOW
        with tempfile.TemporaryDirectory() as obs:
            slow = self.diag_run(dj, "slow link", 3, work, want, schedule="ring", repair=True,
                                 slow_link=DIAG_SLOW, obs_dir=obs, watch=dj.scrape_until_open)
            tele = read_json(os.path.join(obs, "telemetry.json"))
        require(self.incidents_of(slow) == [("degraded-link", {"src": src, "dst": dst})],
                f"(b) slow link: incidents {self.incidents_of(slow)}")
        inc = (slow["incidents"]["open"] + slow["incidents"]["recent"])[0]
        require(any(e["rule"] == "link-wait-attributed" for e in inc["evidence"]),
                f"(b) slow link: evidence {inc['evidence']}")
        ring = slow["rings"][-1]
        require(tele["n_schedule_repaired"] >= 1 and len(slow["rings"]) >= 2
                and all((ring[i], ring[(i + 1) % 3]) != (src, dst) for i in range(3)),
                f"(b) slow link: {tele['n_schedule_repaired']} repairs, rings {slow['rings']}")
        seen = slow["watched"]
        require(seen is not None and seen["incidents"]["n_open"] == 1
                and seen["incidents"]["open"][0]["class"] == "degraded-link",
                f"(b) slow link: the scrape taken mid-run shows {seen and seen['incidents']}")
        final = slow["final"]["jobs"][""]["stream"]
        require(final == tele["stream"], "(b) slow link: the scrape at the job's end differs "
                "from telemetry.json's stream")
        for name, h in seen["jobs"][""]["stream"]["total"]["histograms"].items():
            require(h["count"] <= tele["stream"]["total"]["histograms"][name]["count"],
                    f"(b) slow link: the mid-run scrape's {name} ran ahead of telemetry.json")
        waits = tele["stream"]["per_rank"][str(dst)]["histograms"]
        before = waits.get(f"link_wait_seconds{{dst={dst},src={src}}}", {})
        new_prev = ring[(ring.index(dst) - 1) % 3]
        after = waits.get(f"link_wait_seconds{{dst={dst},src={new_prev}}}", {})
        require(before.get("count", 0) > 0 and after.get("count", 0) > 0,
                f"(b) slow link: rank {dst}'s link waits {sorted(waits)}")
        wait_ms = {"before": 1e3 * before["sum"] / before["count"],
                   "after": 1e3 * after["sum"] / after["count"]}
        kinds = {k: [round(e["ts"] - slow["t0"], 3) for e in slow["events"] if e["kind"] == k]
                 for k in ("link_degraded", "incident_opened", "schedule_repaired")}
        print("  (b) the scrape taken while the incident was open (obs.top.render):")
        for line in top.render(seen).splitlines():
            print("      " + line)
        print(f"  (b) slow link {src} -> {dst} ({delay} s a frame), world 3, schedule ring, "
              f"{DIAG_VERSIONS['slow link']} versions: one incident {inc['class']} "
              f"{inc['subject']} (rule link-wait-attributed), {tele['n_schedule_repaired']} "
              f"repair(s), rings {slow['rings']}; s from the start: slow_link reports "
              f"{kinds['link_degraded']}, incident opened {kinds['incident_opened']}, repaired "
              f"{kinds['schedule_repaired']}; rank {dst}'s mean wait on its incoming link "
              f"{wait_ms['before']:.1f} ms ({src} -> {dst}) before the repair, "
              f"{wait_ms['after']:.1f} ms ({new_prev} -> {dst}) after; the scrape at the job's "
              f"end equal to telemetry.json's stream; states bitwise the totals; "
              f"{slow['elapsed']:.1f} s")

        rank, sleep = DIAG_STRAGGLER
        strag = self.diag_run(dj, "straggler", 4, work, want, straggler=DIAG_STRAGGLER)
        require(self.incidents_of(strag) == [("compute-straggler", {"rank": rank})],
                f"(c) straggler: incidents {self.incidents_of(strag)}")
        print(f"  (c) rank {rank} {sleep} s late to each contribution, world 4, "
              f"{DIAG_VERSIONS['straggler']} versions: one incident compute-straggler "
              f"{{'rank': {rank}}}, opened {strag['opened_s']} s from the start; states bitwise "
              f"the totals; {strag['elapsed']:.1f} s")

        t0 = time.perf_counter()
        obs = self.trace_obs
        doc, _, report = trace.export_job(obs)
        export_s = time.perf_counter() - t0
        require(trace.validate_chrome_trace(doc) == [], "the exported trace does not validate")
        tables = {}
        for name in os.listdir(obs):
            if name.endswith("-exit.jsonl"):
                tables[trace.parse_dump_name(name)["rank"]] = {
                    (e.fields["version"], e.fields["seqno"]): e.fields["op"]
                    for e in load_dump(os.path.join(obs, name))
                    if e.kind == "op_begin" and e.fields.get("seqno") is not None}
        require(set(tables) == set(range(DP_RANKS)), f"exit dumps of ranks {sorted(tables)}")
        for key, op in tables[0].items():
            require(all(t.get(key, op) == op for t in tables.values()),
                    f"collective {key} differs across ranks")
        job = trace.load_job(obs)
        require(set(job.clocks) == set(range(DP_RANKS)) and job.max_clock_err() < 0.5,
                f"clocks {job.clocks}")
        top_rank = report["top_stragglers"][0]["rank"] if report["top_stragglers"] else None
        require(top_rank == 0 and report["collectives_recovery_affected"] >= 1,
                f"straggler report: top {report['top_stragglers'][:1]}, recovery-affected "
                f"{report['collectives_recovery_affected']}")
        cp = critical.critical_path_report(job)
        gating = cp["top_gating_ranks"]
        require(bool(gating) and gating[0]["rank"] == 0, f"critical path: gating ranks {gating}")
        critical.fold_critical_path(obs, cp)
        folded = read_json(os.path.join(obs, "telemetry.json"))
        require("stragglers" in folded and "critical_path" in folded,
                "telemetry.json lacks stragglers or critical_path")
        shutil.rmtree(obs, ignore_errors=True)
        print(f"  trace of the recover phase's traced kill run: {len(doc['traceEvents'])} "
              f"events, valid; collectives {len(tables[0])} a rank, identities equal across "
              f"ranks; clock error <= {job.max_clock_err() * 1e3:.3f} ms; "
              f"{report['collectives_analyzed']} collectives analyzed, "
              f"{report['collectives_recovery_affected']} recovery-affected; top straggler rank "
              f"{top_rank} ({report['top_stragglers'][0]['lateness_total_s']:.3f} s late); "
              f"critical path gates {cp['rounds_by_gate']}, top gating rank {gating[0]}; "
              f"export {export_s * 1e3:.1f} ms; telemetry.json gained stragglers and "
              "critical_path")
        out.update(opened_s={k: r["opened_s"] for k, r in (("slow", slow), ("straggler", strag))},
                   link_wait_ms=wait_ms, export_ms=export_s * 1e3,
                   wall_s={k: r["elapsed"] for k, r in (("clean", clean), ("slow", slow),
                                                        ("straggler", strag))})
        return out

    # -- phases 15 and 16 ---------------------------------------------------------
    def job_run(self, dj, what: str, niter: int, work, **kw) -> dict:
        """One job of tests/workers/torch_diag_job.py for the quorum and
        failover phases: world 3, ``niter`` versions, every worker completed
        at the last version, and node_histograms_kernel (with its helpers)
        launched exactly once a contribution the workers made, with the
        counts set to 0 just before the run and read just after."""
        calls = [0]
        lock = threading.Lock()

        def counted(version, world, rank):
            with lock:
                calls[0] += 1
            return work(version, world, rank)

        self.clear_counts()
        try:
            out = dj.run_job(3, niter, counted, deadline_sec=90.0, **kw)
        except TimeoutError as e:
            raise PhaseFailed(f"{what}: {e}") from e
        counts = self.read_counts(calls[0])
        require(counts == {"node_histograms_kernel": calls[0]} and calls[0] > 0,
                f"{what}: launches {counts}, expected {calls[0]} (one a contribution)")
        for tid, res in sorted(out["results"].items()):
            require(res.completed and res.final_version == niter,
                    f"{what}: task {tid} did not complete: {res.error}")
        out["launches"] = calls[0]
        return out

    @staticmethod
    def equal_states(out, what: str) -> np.ndarray:
        states = [out["results"][t].state for t in sorted(out["results"])]
        require(all(np.array_equal(states[0], s) for s in states[1:]),
                f"{what}: the ranks' states differ")
        return states[0]

    @staticmethod
    def adjusted(out, totals, plain):
        """The totals less every contribution a quorum record excluded and
        no correction folded, in the plain version's histograms
        (tests/test_quorum.py's _adjusted_expected)."""
        ev = out["events"]
        folded = {(e["src_version"], e["rank"]) for e in ev if e["kind"] == "correction_folded"}
        want = totals.copy()
        for e in ev:
            if e["kind"] == "quorum_met":
                for r in e["excluded"]:
                    if (e["version"], r) not in folded:
                        want = want - plain(e["version"], e["world"], r)
        return want

    @staticmethod
    def kinds(events, kind: str) -> list:
        return [e for e in events if e["kind"] == kind]

    @staticmethod
    def cadence_ms(out, last: int = 9) -> float:
        """Rank 0's mean commit interval over versions 1 to ``last``, in ms."""
        ct = out["results"]["0"].commit_times
        return 1e3 * (ct[last] - ct[1]) / (last - 1)

    def quorum_phase(self):
        """Quorum rounds on the card (phase 15 of the module docstring)."""
        ew = worker_module("torch_elastic_worker")
        dj = worker_module("torch_diag_job")
        work, want, plain = self.diag_work(ew)
        out = {}
        t0 = time.perf_counter()

        n = QUORUM_VERSIONS["full"]
        full = self.job_run(dj, "quorum (a) full", n, work, quorum="1.0",
                            iter_sleep=QUORUM_SLEEP)
        require(np.array_equal(self.equal_states(full, "(a)"), want(n))
                and all(r.quorum_rounds == n for r in full["results"].values())
                and not self.kinds(full["events"], "quorum_met"),
                f"(a) full quorum: rounds {[r.quorum_rounds for r in full['results'].values()]}, "
                f"{len(self.kinds(full['events'], 'quorum_met'))} quorum_met")
        print(f"  (a) world 3, quorum 1.0, {n} versions: states bitwise the world-1 totals, "
              f"{n} quorum rounds a rank, no exclusion; launches {full['launches']}; "
              f"{full['elapsed']:.2f} s")

        n = QUORUM_VERSIONS["healing"]
        heal = self.job_run(dj, "quorum (b) healing", n, work, quorum="0.6", quorum_wait=0.12,
                            quorum_flag_after=0, straggler=QUORUM_HEALING,
                            iter_sleep=QUORUM_SLEEP)
        state = self.equal_states(heal, "(b)")
        qm = self.kinds(heal["events"], "quorum_met")
        late = self.kinds(heal["events"], "contribution_late")
        folded = self.kinds(heal["events"], "correction_folded")
        require(bool(qm) and all(e["excluded"] == [2] for e in qm) and late and folded
                and max(e["version"] for e in qm) < n,
                f"(b) healing straggler: quorum_met {[(e['version'], e['excluded']) for e in qm]}"
                f", {len(late)} late, {len(folded)} folded")
        require(np.array_equal(state, self.adjusted(heal, want(n), plain)),
                "(b) healing straggler: the state differs from the record-adjusted totals")
        print(f"  (b) world 3, quorum 0.6, rank 2 {QUORUM_HEALING[1]} s late up to version "
              f"{QUORUM_HEALING[2]}, {n} versions: {len(qm)} rounds excluded [2] (versions "
              f"{[e['version'] for e in qm]}), {len(late)} late block(s), {len(folded)} "
              f"correction(s) folded, rank 2 skipped "
              f"{heal['results']['2'].skipped_contributions}; states bitwise equal and the "
              f"record-adjusted totals; launches {heal['launches']}; {heal['elapsed']:.2f} s")

        n = QUORUM_VERSIONS["persistent"]
        runs = {}
        for name, kw in (("quorum", dict(quorum="0.6", quorum_wait=0.1, quorum_flag_after=3)),
                         ("exact", {})):
            runs[name] = self.job_run(dj, f"quorum (c) {name}", n, work,
                                      straggler=QUORUM_PERSISTENT, iter_sleep=QUORUM_SLEEP,
                                      **kw)
        q, e = runs["quorum"], runs["exact"]
        require(np.array_equal(self.equal_states(e, "(c) exact"), want(n)),
                "(c) exact: the state differs from the totals")
        require(np.array_equal(self.equal_states(q, "(c)"), self.adjusted(q, want(n), plain)),
                "(c) persistent straggler: the state differs from the record-adjusted totals")
        flagged = [x for x in self.kinds(q["events"], "link_degraded") if x.get("via") == "quorum"]
        skipped = q["results"]["2"].skipped_contributions
        cad = {k: self.cadence_ms(r) for k, r in runs.items()}
        require(skipped > 0 and flagged and flagged[0]["dst"] == 2
                and cad["quorum"] < 0.5 * cad["exact"],
                f"(c) persistent straggler: rank 2 skipped {skipped}, flags "
                f"{[(x['src'], x['dst']) for x in flagged]}, cadence {cad}")
        print(f"  (c) world 3, rank 2 {QUORUM_PERSISTENT[1]} s late to every version, {n} "
              f"versions: rank 0's commit cadence {cad['quorum']:.1f} ms with quorum 0.6, "
              f"{cad['exact']:.1f} ms exact (ratio {cad['quorum'] / cad['exact']:.2f}); rank 2 "
              f"skipped {skipped} contribution(s); links flagged via quorum "
              f"{[(x['src'], x['dst']) for x in flagged]}, {q['n_repaired']} repair(s); "
              f"states the record-adjusted totals; launches {q['launches']} and "
              f"{e['launches']}; {q['elapsed']:.2f} s and {e['elapsed']:.2f} s")

        # (d) the unfolded histogram: blocks larger than the socket buffers,
        # which every rank posts at once
        t_wide = time.perf_counter()
        work, want, _plain = self.diag_work(ew, wide=True)
        n = QUORUM_VERSIONS["wide"]
        wide = {}
        for name, kw in (("quorum", dict(quorum="1.0")), ("exact", {})):
            wide[name] = self.job_run(dj, f"quorum (d) wide {name}", n, work,
                                      iter_sleep=QUORUM_SLEEP, **kw)
            require(np.array_equal(self.equal_states(wide[name], f"(d) {name}"), want(n)),
                    f"(d) wide {name}: the state differs from the world-1 totals")
        require(all(r.quorum_rounds == n for r in wide["quorum"]["results"].values()),
                f"(d) wide: rounds "
                f"{[r.quorum_rounds for r in wide['quorum']['results'].values()]}")
        block = int(want(n).nbytes)
        wide_cad = {k: self.cadence_ms(r, last=n) for k, r in wide.items()}
        wide_s = time.perf_counter() - t_wide
        print(f"  (d) world 3, {n} versions, each contribution the unfolded histogram "
              f"[{ELASTIC_NODES}, {N_FEATURES}, {self.n_bins}, 2] int64: quorum 1.0 and exact "
              f"states bitwise the world-1 totals, {n} quorum rounds a rank; launches "
              f"{wide['quorum']['launches']} and {wide['exact']['launches']}; "
              f"{wide['quorum']['elapsed']:.2f} s and {wide['exact']['elapsed']:.2f} s")
        print(f"  (d) block {block} bytes; rank 0's commit cadence {wide_cad['quorum']:.1f} ms "
              f"with quorum 1.0, {wide_cad['exact']:.1f} ms exact; run (d) {wide_s:.1f} s")
        out.update(cadence_ms=cad, skipped=skipped, excluded_rounds=len(qm),
                   wide_cadence_ms=wide_cad, wide_block_bytes=block, wide_s=wide_s,
                   wall_s=time.perf_counter() - t0)
        print(f"  quorum phase: {out['wall_s']:.1f} s", flush=True)
        return out

    def failover_phase(self):
        """The HA control plane on the card (phase 16 of the module
        docstring)."""
        ew = worker_module("torch_elastic_worker")
        dj = worker_module("torch_diag_job")
        work, want, plain = self.diag_work(ew)
        out = {}
        t0 = time.perf_counter()
        ha = dict(standby=True, takeover_sec=0.5, poll_sec=0.05)

        n = FAILOVER_VERSIONS["mid-wave"]
        wave = self.job_run(dj, "failover (a) mid-wave", n, work, kill_primary=FAILOVER_KILL,
                            hold_back=(2,), iter_sleep=FAILOVER_SLEEP, **ha)
        require(np.array_equal(self.equal_states(wave, "(a)"), want(n)),
                "(a) mid-wave: the state differs from the totals")
        pe = wave["promoted_events"]
        require(len(self.kinds(pe, "tracker_failover")) == 1 and self.kinds(pe, "wave")
                and not self.kinds(wave["events"], "lease_expired"),
                f"(a) mid-wave: promoted events {[x['kind'] for x in pe]}")
        print(f"  (a) world 3, {n} versions, primary killed {FAILOVER_KILL} s in with workers 0 "
              f"and 1 in the wave, worker 2 started after: one tracker_failover, the wave "
              f"closed on the promoted tracker, no lease_expired, states bitwise the totals; "
              f"launches {wave['launches']}; {wave['elapsed']:.2f} s")

        n = FAILOVER_VERSIONS["mid-run"]
        run = self.job_run(dj, "failover (b) mid-run", n, work, quorum="0.6", quorum_wait=0.12,
                           quorum_flag_after=0, straggler=QUORUM_HEALING, heartbeat_sec=0.2,
                           kill_primary=("freezes", FAILOVER_FREEZES),
                           iter_sleep=FAILOVER_SLEEP, **ha)
        recs, answers = run["primary_records"], run["promoted_answers"]
        require(len(recs) >= FAILOVER_FREEZES
                and all(answers.get(k) == r for k, r in recs.items()),
                f"(b) mid-run: {len(recs)} primary records, answers differ for "
                f"{[k for k, r in recs.items() if answers.get(k) != r]}")
        require(np.array_equal(self.equal_states(run, "(b)"), self.adjusted(run, want(n), plain)),
                "(b) mid-run: the state differs from the totals adjusted by both trackers' "
                "records")
        require(run["promoted_shutdowns"] == {"0", "1", "2"}
                and not self.kinds(run["events"], "lease_expired")
                and len(self.kinds(run["promoted_events"], "tracker_failover")) == 1,
                f"(b) mid-run: shutdowns on the promoted tracker {run['promoted_shutdowns']}, "
                f"{len(self.kinds(run['events'], 'lease_expired'))} lease_expired")
        fo = self.kinds(run["promoted_events"], "tracker_failover")[0]
        to_failover = fo["ts"] - run["t_kill_wall"]
        commits = sorted(t for r in run["results"].values() for t in r.commit_times.values()
                         if t > run["t_kill"])
        require(bool(commits), "(b) mid-run: no commit after the kill")
        to_commit = commits[0] - run["t_kill"]
        qm = [self.kinds(x, "quorum_met") for x in (run["primary_events"],
                                                    run["promoted_events"])]
        print(f"  (b) world 3, quorum 0.6, rank 2 {QUORUM_HEALING[1]} s late up to version "
              f"{QUORUM_HEALING[2]}, {n} versions, heartbeats 0.2 s, primary killed after "
              f"{len(recs)} frozen records: each answered the same by the promoted tracker; "
              f"quorum_met {len(qm[0])} on the primary, {len(qm[1])} on the promoted; states "
              f"the totals adjusted by both trackers' records; every shutdown on the promoted "
              f"tracker, no lease_expired; from the kill {to_failover:.3f} s to the takeover, "
              f"{to_commit:.3f} s to the next commit; launches {run['launches']}; "
              f"{run['elapsed']:.2f} s")

        n = FAILOVER_VERSIONS["file"]
        with tempfile.TemporaryDirectory() as tmp:
            filed = self.job_run(dj, "failover (c) file", n, work, kill_primary=FAILOVER_KILL,
                                 hold_back=(2,), iter_sleep=FAILOVER_SLEEP,
                                 journal_path=os.path.join(tmp, "job.journal"), **ha)
        require(np.array_equal(self.equal_states(filed, "(c)"), want(n)),
                "(c) file journal: the state differs from the totals")
        require(filed["file_bytes"] is not None
                and filed["standby_bytes"] == filed["file_bytes"]
                and len(self.kinds(filed["promoted_events"], "tracker_failover")) == 1,
                "(c) file journal: the standby's state at the takeover differs from "
                "read_journal + replay of the file")
        print(f"  (c) as (a) with a file journal the standby tails: states the totals; the "
              f"standby's state at the takeover ({len(filed['file_bytes'])} bytes) bitwise "
              f"read_journal + replay of the file; launches {filed['launches']}; "
              f"{filed['elapsed']:.2f} s")
        out.update(kill_to_failover_s=to_failover, kill_to_commit_s=to_commit,
                   wall_s=time.perf_counter() - t0)
        print(f"  failover phase: {out['wall_s']:.1f} s", flush=True)
        return out

    # -- phase 17 -----------------------------------------------------------------
    def relay_phase(self):
        """The reactor and the relay tier on the card (phase 17 of the module
        docstring)."""
        from collections import Counter

        ew = worker_module("torch_elastic_worker")
        dj = worker_module("torch_diag_job")
        work, want, _plain = self.diag_work(ew)
        out = {}
        t0 = time.perf_counter()

        n = RELAY_VERSIONS["serving"]
        ab = {}
        for reactor in (True, False):
            what = f"relay (a) {'reactor' if reactor else 'threaded'}"
            run = self.job_run(dj, what, n, work, quorum="1.0", iter_sleep=QUORUM_SLEEP,
                               reactor=reactor)
            require(np.array_equal(self.equal_states(run, what), want(n)),
                    f"{what}: the state differs from the world-1 totals")
            ab[reactor] = run
        tallies = {r: Counter(e["kind"] for e in ab[r]["telemetry"]["events"]) for r in ab}
        serving = {r: ab[r]["telemetry"]["serving"] for r in ab}
        require(tallies[True] == tallies[False],
                f"(a) the event kinds differ: reactor {dict(tallies[True])}, threaded "
                f"{dict(tallies[False])}")
        require(serving[True]["handler_threads_hwm"] == 0
                and serving[False]["handler_threads_hwm"] >= 1,
                f"(a) handler threads: reactor {serving[True]['handler_threads_hwm']}, "
                f"threaded {serving[False]['handler_threads_hwm']}")
        cad = {r: self.cadence_ms(ab[r]) for r in ab}
        print(f"  (a) world 3, quorum 1.0, {n} versions on each serving path: states bitwise "
              f"the world-1 totals, event kinds equal ({sum(tallies[True].values())} events); "
              f"reactor {ab[True]['elapsed']:.2f} s, rank 0's cadence {cad[True]:.1f} ms, "
              f"{serving[True]['accepts']} accepts, loop peak "
              f"{serving[True]['reactor_conns_hwm']}, 0 handler threads; threaded "
              f"{ab[False]['elapsed']:.2f} s, cadence {cad[False]:.1f} ms, "
              f"{serving[False]['accepts']} accepts, handler-thread peak "
              f"{serving[False]['handler_threads_hwm']}; launches {ab[True]['launches']} and "
              f"{ab[False]['launches']}")

        n = RELAY_VERSIONS["relayed"]
        rel = self.job_run(dj, "relay (b) relayed", n, work, quorum="1.0",
                           iter_sleep=QUORUM_SLEEP, relays=2, heartbeat_sec=RELAY_HB)
        tel = rel["telemetry"]
        require(np.array_equal(self.equal_states(rel, "(b)"), want(n)),
                "(b) relayed: the state differs from the world-1 totals")
        require(tel["n_relays_up"] == 2 and tel["serving"]["batch_msgs"] >= 3 * n
                and tel["serving"]["accepts"] <= 2 + n and tel["n_lease_expired"] == 0,
                f"(b) relayed: n_relays_up {tel['n_relays_up']}, serving {tel['serving']}, "
                f"n_lease_expired {tel['n_lease_expired']}")
        cad_b = self.cadence_ms(rel)
        clocks = {r["relay"]: r["rank_clock"] for r in rel["relays"]}
        require(all(c is not None and abs(c[0]) < 0.05 for c in clocks.values()),
                f"(b) relayed: a relayed rank's clock estimate is off the tracker's: {clocks}")
        print(f"  (b) world 3 behind 2 relays, quorum 1.0 (the reports ride the batches), "
              f"heartbeats {RELAY_HB} s, {n} versions: states bitwise the totals; root "
              f"accepts {tel['serving']['accepts']} (bound {2 + n}), {tel['serving']['batches']} "
              f"batches of {tel['serving']['batch_msgs']} messages, no lease_expired; rank 0's "
              f"cadence {cad_b:.1f} ms (direct {cad[True]:.1f} ms); {rel['elapsed']:.2f} s; "
              f"launches {rel['launches']}")
        for r in rel["relays"]:
            off, err = r["rank_clock"]
            print(f"      {r['relay']}: {json.dumps(r['stats'])}; its tracker-clock estimate "
                  f"err {1e3 * r['clock_err']:.3f} ms; a relayed rank's ClockSync offset "
                  f"{1e3 * off:.3f} ms, err {1e3 * err:.3f} ms (one host: the true offset is 0)")

        n = RELAY_VERSIONS["bounce"]
        os.environ["RABIT_TPU_RABIT_DIAG_WINDOW_SEC"] = RELAY_DIAG_WINDOW
        try:
            bounce = self.job_run(dj, "relay (c) bounce", n, work, iter_sleep=RELAY_BOUNCE_SLEEP,
                                  relays=2, heartbeat_sec=RELAY_HB, relay_bounce=RELAY_BOUNCE)
        finally:
            os.environ.pop("RABIT_TPU_RABIT_DIAG_WINDOW_SEC", None)
        ev = bounce["events"]
        require(np.array_equal(self.equal_states(bounce, "(c)"), want(n)),
                "(c) relay bounce: the state differs from the world-1 totals")
        t_stop = bounce["t_bounce_wall"]
        lost = [e for e in ev if e["kind"] == "relay_lost" and e["relay"] == "relay0"]
        up = [e for e in ev if e["kind"] == "relay_up" and e["relay"] == "relay0"
              and lost and e["ts"] > lost[0]["ts"]]
        # (a 0.1 s window may also see the link-wait noise of a loaded host:
        # other incidents are printed, the lost relay's is required)
        opened = [e for e in ev if e["kind"] == "incident_opened"]
        lost_inc = [e for e in opened if (e["class"], e.get("relay")) == ("lost-relay", "relay0")]
        resolved = [e for e in ev if e["kind"] == "incident_resolved"
                    and lost_inc and e["incident"] == lost_inc[0]["incident"]]
        require(bool(lost) and bool(up) and not self.kinds(ev, "lease_expired")
                and len(lost_inc) == 1 and len(resolved) == 1,
                f"(c) relay bounce: {len(lost)} relay_lost, {len(up)} relay_up after it, "
                f"{len(self.kinds(ev, 'lease_expired'))} lease_expired, incidents opened "
                f"{[(e['class'], e.get('relay')) for e in opened]}, the lost relay's resolved "
                f"{len(resolved)} time(s)")
        to_up = up[0]["ts"] - t_stop
        inc = lost_inc[0]
        others = [(e["class"], {k: e[k] for k in ("src", "dst", "rank") if k in e})
                  for e in opened if e is not inc]
        print(f"  (c) world 3 behind 2 relays, {n} versions, relay 0 stopped "
              f"{RELAY_BOUNCE[0]} s in and a new one on its port {RELAY_BOUNCE[1]} s later: "
              f"states bitwise the totals, no lease_expired; from the stop "
              f"{lost[0]['ts'] - t_stop:.3f} s to relay_lost, {to_up:.3f} s to relay_up; the "
              f"lost-relay incident opened {inc['ts'] - t_stop:.3f} s and resolved "
              f"{resolved[0]['ts'] - t_stop:.3f} s after the stop "
              f"(rabit_diag_window_sec {RELAY_DIAG_WINDOW}); other incidents {others}; "
              f"launches {bounce['launches']}; {bounce['elapsed']:.2f} s")

        relayed = getattr(self, "mid_tree_kill", None)
        if relayed is None:  # a run of this phase alone: the recover phase's runs, here
            self.clean_gbdt = self.recover_run("gbdt", "time_hop=1")
            relayed = self.recover_run("gbdt", "mock=1,1,2,0", relays=RELAYS)
        rt = relayed["telemetry"]
        require(np.array_equal(relayed["forest"], self.clean_gbdt["forest"]),
                "(d) native GBDT behind relays: the forest differs from the clean gbdt run's")
        require(relayed["restarts"] == 1 and rt["n_relays_up"] == RELAYS
                and rt["serving"]["accepts"] <= 4,
                f"(d) native GBDT behind relays: restarts {relayed['restarts']}, n_relays_up "
                f"{rt['n_relays_up']}, serving {rt['serving']}")
        rec_s = self.recovery_s(relayed)
        rclocks = {r: (c.get("offset_s"), c.get("err_s")) for r, c in rt["clocks"].items()}
        print(f"  (d) the recover phase's mid-tree kill run (its gbdt job, {DP_RANKS} native "
              f"workers behind {RELAYS} relays, rank 1 killed mid-tree): forest byte-identical "
              f"to the clean gbdt run's; restarts 1; root accepts {rt['serving']['accepts']}, "
              f"{rt['serving']['batches']} batches; launches {relayed['launches']}; from the "
              f"death to the restarted worker's next commit {rec_s:.2f} s; the ranks' clock "
              f"estimates through the relays {rclocks}; run {relayed['wall_s']:.1f} s")

        sweep = scale_sweep_module()
        recs = {r["arm"]: r for r in sweep.scale_sweep([RELAY_WORLD], hb_interval=0.4,
                                                       hb_beats=2, deadline_sec=60.0,
                                                       relays_for=lambda w: 2, emit=None)}
        acc = {a: r["tracker"]["accepts"] for a, r in recs.items()}
        require(set(recs) == set(sweep.ARMS) and acc["relayed"] <= 8
                and acc["threaded_direct"] >= RELAY_WORLD and acc["reactor_direct"] >= RELAY_WORLD
                and all(r["bootstrap"]["wave_completed"] == RELAY_WORLD
                        and r["recovery"]["wave_completed"] == RELAY_WORLD for r in recs.values()),
                f"(e) scale sweep: accepts {acc}")
        for arm, r in recs.items():
            print(f"  (e) world {RELAY_WORLD}, {arm}: accepts {acc[arm]}, handler-thread peak "
                  f"{r['tracker']['handler_threads_hwm']}, loop peak "
                  f"{r['tracker']['reactor_conns_hwm']}, heartbeat p99 "
                  f"{r['liveness']['rpc_p99_ms']} ms, bootstrap wave "
                  f"{r['bootstrap']['wave_latency_s']} s, recovery wave "
                  f"{r['recovery']['wave_latency_s']} s, lease_expired {r['lease_expired']}")
        out.update(cadence_ms={"reactor": cad[True], "threaded": cad[False], "relayed": cad_b},
                   bounce_to_relay_up_s=to_up, relayed_recovery_s=rec_s,
                   sweep={a: {"accepts": acc[a], "hb_p99_ms": r["liveness"]["rpc_p99_ms"],
                              "bootstrap_s": r["bootstrap"]["wave_latency_s"],
                              "recovery_s": r["recovery"]["wave_latency_s"]}
                          for a, r in recs.items()},
                   wall_s=time.perf_counter() - t0)
        print(f"  relay phase: {out['wall_s']:.1f} s", flush=True)
        return out

    # -- phase 18 -----------------------------------------------------------------
    def chaos_count_check(self):
        """node_histograms_kernel at the chaos runner's shapes ([n, 1] bins,
        every node id 0, g = h = 1, 8 bins, n below and past one 128-row
        block) against its plain version and np.bincount, exactly; these
        launches are comparisons and do not count."""
        torch = self.torch
        rng = np.random.RandomState(18)
        for n in CHAOS_SHAPES:
            data = rng.randint(0, 8, size=n)
            xb = torch.as_tensor(data.astype(np.int32).reshape(n, 1), device=self.dev)
            ones = torch.ones(n, device=self.dev)
            node = torch.zeros(n, dtype=torch.int32, device=self.dev)
            got = self.hist.node_histograms_kernel(xb, ones, ones, node, 1, 8)
            plain = self.hist.node_histograms_kernel_plain(xb, ones, ones, node, 1, 8)
            count = np.bincount(data, minlength=8)
            require(bool(torch.equal(got, plain))
                    and np.array_equal(got[0, 0, :, 0].cpu().numpy(), count),
                    f"chaos: node_histograms_kernel at [{n}, 1] x 8 bins differs from its "
                    f"plain version or np.bincount")

    def chaos_run(self, what: str, seed: int, **kw):
        """One run_elastic_schedule on the card, node_histograms_kernel (and
        its helpers) launched exactly once a contribution, with the counts
        set to 0 just before the run and read just after; prints its line."""
        from rabit_tpu_torch import chaos

        self.clear_counts()
        t0 = time.perf_counter()
        r = chaos.run_elastic_schedule(seed, device=self.dev.type, **kw)
        took = time.perf_counter() - t0
        counts = self.read_counts(r.n_contributions)
        require(counts == {"node_histograms_kernel": r.n_contributions} and r.n_contributions,
                f"chaos {what} seed {seed}: launches {counts}, expected {r.n_contributions} "
                "(one a contribution)")
        epochs = [e["epoch"] for e in r.epochs]
        require(r.outcome == "completed" and r.n_completed >= 1
                and epochs == sorted(set(epochs))
                and all(1 <= e["world"] <= r.world for e in r.epochs),
                f"chaos {what} seed {seed}: {r}")
        print(f"  ({what}) seed {seed}: world {r.world}, spares {r.n_spares}, died {r.n_died}, "
              f"worlds_seen {r.worlds_seen}, {r.outcome}; {r.n_contributions} launches; "
              f"{took:.2f} s", flush=True)
        return r, took

    def chaos_phase(self):
        """The schedule runners on the card (phase 18 of the module
        docstring)."""
        from rabit_tpu_torch import chaos

        t0 = time.perf_counter()
        self.chaos_count_check()
        boot = {}
        for seed in CHAOS_BOOT_SEEDS:
            t = time.perf_counter()
            r = chaos.run_schedule(seed)
            boot[seed] = time.perf_counter() - t
            require(r.completed and sorted(r.rank_of.values()) == list(range(r.world))
                    and r.epoch >= 0, f"chaos (a) seed {seed}: {r}")
            print(f"  (a) seed {seed}: world {r.world}, {r.rounds} round(s), epoch {r.epoch}, "
                  f"{r.stats.refused} refused, {r.stats.truncated} truncated, "
                  f"{r.stats.blackholed} blackholed, {r.outcome}; {boot[seed]:.2f} s",
                  flush=True)
        fuzz = {seed: self.chaos_run("b", seed)[1] for seed in CHAOS_ELASTIC_SEEDS}
        # (c) one schedule of each fault plane, with the JAX package's test
        # arguments (tests/test_relay.py, tests/test_ha.py, tests/test_quorum.py)
        runs = {
            "relay bounce": (7101, dict(world=3, relays=2, heartbeat_sec=0.3, niter=8,
                                        iter_sleep=0.15, deadline_sec=60.0,
                                        relay_fault=chaos.FaultSpec(relay_death=(0.8, 0.4)))),
            "tracker death": (9301, dict(world=3, niter=5, iter_sleep=0.1,
                                         failover=chaos.FaultSpec(tracker_death=0.05))),
            "straggler+quorum+kills": (9300, dict(world=4, straggler=(2, 0.25, 3), quorum="0.5",
                                                  niter=5, mix_faults=True, deadline_sec=45.0)),
        }
        planes = {}
        for what, (seed, kw) in runs.items():
            r, planes[what] = self.chaos_run(f"c: {what}", seed, **kw)
            if what == "relay bounce":
                require(r.n_spurious_expired == 0 and r.n_relay_lost >= 1,
                        f"chaos relay bounce: spurious expiries {r.n_spurious_expired}, "
                        f"relay_lost {r.n_relay_lost}")
            elif what == "tracker death":
                require(r.n_journal_gap == 0 and r.n_spurious_expired == 0
                        and (not r.primary_killed or r.n_failover <= 1),
                        f"chaos tracker death: journal gaps {r.n_journal_gap}, spurious "
                        f"expiries {r.n_spurious_expired}, failovers {r.n_failover}")
        out = {"bootstrap_s": {k: round(v, 3) for k, v in boot.items()},
               "elastic_s": {k: round(v, 3) for k, v in fuzz.items()},
               "planes_s": {k: round(v, 3) for k, v in planes.items()},
               "wall_s": time.perf_counter() - t0}
        print(f"  chaos phase: {out['wall_s']:.1f} s", flush=True)
        return out

    # -- phase 19 -----------------------------------------------------------------
    def delivery_subscribers(self, cluster, got: list, stop: threading.Event):
        """DELIVERY_SUBS subscriber threads, subscriber i behind relay i of
        ``cluster`` once its run has started them: each polls the version
        line and fetches every version it has not seen, appending
        ``(subscriber, line, sha256 of the blob, blob)`` to ``got``, until it
        holds version RECOVER_TREES (or ``stop``).  Returns the run's linger
        predicate: every subscriber holds the last version."""
        from rabit_tpu_torch.delivery import Subscriber, digest_of

        done = [threading.Event() for _ in range(DELIVERY_SUBS)]

        def follow(i: int) -> None:
            while not cluster.relays and not stop.wait(0.02):
                pass
            relay = cluster.relays[i % len(cluster.relays)]
            sub = Subscriber(relay.host, relay.port, task_id=f"chip-sub{i}", timeout=5.0,
                             poll_sec=DELIVERY_POLL)
            while not stop.is_set() and sub.seen_version < RECOVER_TREES:
                try:
                    line = sub.poll()
                    if int(line.get("version", 0)) > sub.seen_version:
                        line, blob = sub.fetch(line, deadline_sec=30.0)
                        got.append((i, line, digest_of(blob), blob))
                        continue
                except (ConnectionError, LookupError, TimeoutError) as e:
                    got.append((i, {"error": repr(e)}, "", b""))
                stop.wait(DELIVERY_POLL)
            done[i].set()

        for i in range(DELIVERY_SUBS):
            threading.Thread(target=follow, args=(i,), daemon=True,
                             name=f"chip-sub{i}").start()
        return lambda: all(d.is_set() for d in done)

    def delivery_phase(self):
        """The model-delivery plane on the card (phase 19 of the module
        docstring)."""
        from rabit_tpu_torch import api
        from rabit_tpu_torch.store import CheckpointStore

        t0 = time.perf_counter()
        got: list = []
        stop = threading.Event()
        with tempfile.TemporaryDirectory() as ckpt:
            try:
                run = self.recover_run(
                    "gbdt", "rabit_delivery_publish=1", f"rabit_checkpoint_dir={ckpt}",
                    f"mock=0,{DELIVERY_KILL - 1},-3,0", relays=RELAYS,
                    on_cluster=lambda c: self.delivery_subscribers(c, got, stop))
            finally:
                stop.set()
            committed = CheckpointStore(ckpt, 0).load_global(RECOVER_TREES)
        took_a = time.perf_counter() - t0
        errors = [g for g in got if "error" in g[1]]
        require(not errors, f"delivery (a): subscriber errors {[g[1] for g in errors]}")
        require(all(sha == line["digest"] for _, line, sha, _ in got),
                "delivery (a): a fetched blob's sha256 is not its line's digest")
        last = {}
        for i, line, _sha, blob in got:
            last[i] = (line, blob)
        require(sorted(last) == list(range(DELIVERY_SUBS))
                and all(line["version"] == RECOVER_TREES for line, _ in last.values()),
                f"delivery (a): the subscribers' last versions "
                f"{ {i: ln['version'] for i, (ln, _) in last.items()} }")
        blob = last[0][1]
        require(all(b == committed for _, b in last.values()),
                "delivery (a): the last version's bytes are not rank 0's committed blob")
        _base, gblob = api._unwrap(blob)
        decoded = np.concatenate([np.asarray(a, np.float32).reshape(-1)
                                  for a in pickle.loads(gblob)])
        require(decoded.tobytes() == run["forest"].tobytes(),
                "delivery (a): the published forest differs from the job's forest.npy")
        # the mock engine with obs off, held to the clean gbdt run (robust, obs on)
        clean = getattr(self, "clean_gbdt", None)
        require(clean is None or np.array_equal(run["forest"], clean["forest"]),
                "delivery (a): the forest differs from the recover phase's clean gbdt run's")
        trained = sum(len(st["ms"]) for st in run["stats"])
        want = {k: trained * DEPTH for k in ("node_histograms_kernel", *HELPERS)}
        require(run["restarts"] == 1 and run["launches"] == want,
                f"delivery (a): restarts {run['restarts']}, launches {run['launches']}, "
                f"expected {want}")
        versions = sorted({line["version"] for _, line, _, _ in got})
        print(f"  (a) gbdt job behind 2 relays, publisher killed in the commit window of "
              f"version {DELIVERY_KILL}: versions fetched {versions}, {len(got)} fetches "
              f"({len(blob)} B each), digests verified, the last forest byte-identical to "
              f"forest.npy; launches {run['launches']}; {took_a:.1f} s", flush=True)
        # (b) in a fresh interpreter: the swarm measures the relays, not this
        # process's threads and heap; the tool spawns the swarm's own process
        t = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "torch_delivery_bench.py"), "--arm", "swarm",
            *DELIVERY_SWARM], capture_output=True, text=True, timeout=300)
        took_b = time.perf_counter() - t
        try:
            swarm = json.loads(out.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError) as e:
            raise PhaseFailed(f"delivery (b): no record ({e}): {out.stderr[-2000:]}") from e
        require(swarm["polls"] > 0 and swarm["n_lat"] > 0
                and swarm["writer_cadence_ratio"] >= 0.70
                and swarm["failures"] <= swarm["polls"] * 0.05,
                f"delivery (b): {swarm}")
        print(f"  (b) swarm of {swarm['subs']} (spawned process) behind {swarm['relays']} "
              f"relays: polls {swarm['polls']}, failures {swarm['failures']}, "
              f"writer_cadence_ratio {swarm['writer_cadence_ratio']}, prop_p50_ms "
              f"{swarm['prop_p50_ms']:.3f}, prop_p99_ms {swarm['prop_p99_ms']:.3f}; CPU s in "
              f"the window: swarm {swarm['swarm_cpu_s']}, serving {swarm['serving_cpu_s']}; "
              f"{took_b:.1f} s", flush=True)
        bench = importlib.import_module("tools.torch_delivery_bench")
        t = time.perf_counter()
        fo = bench.run_failover(**DELIVERY_FAILOVER)
        took_c = time.perf_counter() - t
        require(fo["line_restored"] and fo["converged"] == DELIVERY_FAILOVER["n_subs"]
                and fo["subscriber_errors"] == 0, f"delivery (c): {fo}")
        print(f"  (c) failover: line_restored {fo['line_restored']}, converged "
              f"{fo['converged']}, subscriber_errors {fo['subscriber_errors']}, takeover "
              f"{fo['takeover_sec']} s; {took_c:.1f} s", flush=True)
        return {"versions": versions, "fetches": len(got), "blob_bytes": len(blob),
                "launches": run["launches"], "job_s": round(took_a, 3),
                "swarm": {k: swarm[k] for k in ("polls", "failures", "n_lat",
                                                "writer_cadence_ratio", "prop_p50_ms",
                                                "prop_p99_ms", "fetch_errors", "swarm_cpu_s",
                                                "serving_cpu_s")},
                "swarm_s": round(took_b, 3),
                "failover": {k: fo[k] for k in ("line_restored", "converged",
                                                "subscriber_errors", "takeover_sec")},
                "failover_s": round(took_c, 3), "wall_s": time.perf_counter() - t0}

    # -- phase 20 -----------------------------------------------------------------
    def service_takeover(self, fill) -> dict:
        """Run (b) of the service phase: a journaled CollectiveService, two
        admitted jobs of ElasticWorker threads, the service killed mid-run and
        a Standby(service=True) that restores both."""
        from rabit_tpu_torch.elastic.client import ElasticWorker
        from rabit_tpu_torch.ha import Standby
        from rabit_tpu_torch.service import CollectiveService

        bench = importlib.import_module("tools.torch_service_bench")
        jobs = ("tenantA.fit", "tenantB.fit")

        def contribution(v: int, world: int, rank: int) -> np.ndarray:
            time.sleep(SERVICE_TAKEOVER_SLEEP)
            return fill(v * (rank + 1))

        with tempfile.TemporaryDirectory() as tmp:
            svc = CollectiveService(quiet=True, journal=os.path.join(tmp, "svc.journal")).start()
            standby = Standby(primary=(svc.host, svc.port), takeover_sec=0.6, service=True,
                              journal=os.path.join(tmp, "standby.journal"), quiet=True).start()
            try:
                require(standby.wait_synced(5), "service (b): the standby never synced")
                addrs = [(svc.host, svc.port), (standby.host, standby.port)]
                for key in jobs:
                    svc.admit(key, 2)
                results: dict = {}
                workers = [ElasticWorker(addrs, str(i), contribution, SERVICE_TAKEOVER_ROUNDS,
                                         job=key, deadline_sec=60, heartbeat_sec=0.3,
                                         rpc_timeout=1.0, wave_timeout=15.0)
                           for key in jobs for i in range(2)]
                threads = [threading.Thread(
                    target=lambda w=w: results.__setitem__(w.task_id, w.run()), daemon=True)
                    for w in workers]
                for t in threads:
                    t.start()
                # both jobs mid-run: every worker's second contribution, on average
                deadline = time.monotonic() + 30
                while fill.n_calls < 2 * len(workers):
                    require(time.monotonic() < deadline, "service (b): the jobs never started")
                    time.sleep(0.01)
                killed = time.monotonic()
                svc.kill()
                require(standby.wait_promoted(10), "service (b): the standby never took over")
                takeover_s = time.monotonic() - killed
                promoted = standby.tracker
                require(isinstance(promoted, CollectiveService)
                        and promoted.live_jobs() == sorted(jobs),
                        f"service (b): the promoted tracker serves {promoted!r}")
                for t in threads:
                    t.join(timeout=70)
                expired = [e for key in jobs if promoted.partition(key) is not None
                           for e in promoted.partition(key).events
                           if e["kind"] == "lease_expired"]
                require(not expired, f"service (b): leases expired across the cut: {expired}")
            finally:
                standby.stop()
                svc.stop()
        want = bench.expected_state(2, SERVICE_TAKEOVER_ROUNDS)
        require(sorted(results) == sorted(f"{k}/{i}" for k in jobs for i in range(2)),
                f"service (b): results of {sorted(results)}")
        for tid, r in sorted(results.items()):
            require(r.completed and np.array_equal(r.state, want),
                    f"service (b): {tid} completed {r.completed} ({r.error}), state "
                    f"{r.state!r}, want {want!r}")
        after = [t for r in results.values() for t in r.commit_times.values() if t > killed]
        require(bool(after), "service (b): no commit after the kill")
        return {"takeover_s": takeover_s, "kill_to_commit_s": min(after) - killed}

    def service_phase(self):
        """The multi-tenant collective service on the card (phase 20 of the
        module docstring)."""
        bench = importlib.import_module("tools.torch_service_bench")
        t0 = time.perf_counter()
        fill = bench.DeviceFill(self.dev.type)
        self.clear_counts()
        recs = bench.bench_service(**SERVICE_BENCH, device=self.dev.type)
        by_mode = {r["mode"]: r for r in recs}
        n_a = by_mode["summary"]["contributions"]
        counts = self.read_counts(n_a)
        require(counts == {"node_histograms_kernel": n_a} and n_a > 0,
                f"service (a): launches {counts}, expected {n_a} (one a contribution)")
        clean, chaos, pooled = by_mode["clean"], by_mode["chaos"], by_mode["pooled"]
        require(clean["bitwise_ok"] and clean["completed"] and clean["jobs_per_sec"] > 0
                and clean["boot_p99_ms"] > 0, f"service (a) clean: {clean}")
        require(chaos["neighbors_bitwise_ok"] and chaos["victim_completed"],
                f"service (a) chaos: {chaos}")
        require(pooled["fits_completed"] == SERVICE_BENCH["pool_jobs"],
                f"service (a) pooled: {pooled}")
        require(by_mode["summary"]["wire_legacy_identical"], "service (a): the legacy hello changed")
        took_a = time.perf_counter() - t0
        print(f"  (a) bench_service, {SERVICE_BENCH['n_jobs']} jobs of world "
              f"{SERVICE_BENCH['world']} behind {SERVICE_BENCH['relays']} relay: clean "
              f"{clean['jobs_per_sec']} jobs/s, boot p50 {clean['boot_p50_ms']} ms, p99 "
              f"{clean['boot_p99_ms']} ms; chaos (straggler {chaos['straggle_s']} s): victim "
              f"{chaos['victim_wall_s']} s, neighbours' ratio max {chaos['neighbor_ratio_max']} "
              f"(bar {chaos['neighbor_ratio_bar']}, recorded); pooled {pooled['fits_completed']} "
              f"fits, {pooled['fits_per_sec']} fits/s, leases {pooled['leases_per_worker']}; "
              f"launches {counts}; {took_a:.1f} s", flush=True)
        t = time.perf_counter()
        self.clear_counts()
        n_before = fill.n_calls
        tk = self.service_takeover(fill)
        n_b = fill.n_calls - n_before
        counts_b = self.read_counts(n_b)
        require(counts_b == {"node_histograms_kernel": n_b} and n_b > 0,
                f"service (b): launches {counts_b}, expected {n_b} (one a contribution)")
        took_b = time.perf_counter() - t
        print(f"  (b) two jobs on a journaled service killed at their second round: a "
              f"Standby(service=True) took over {tk['takeover_s']:.3f} s after the kill, both "
              f"jobs restored and bitwise their closed form; from the kill to the next commit "
              f"{tk['kill_to_commit_s']:.3f} s; launches {counts_b}; {took_b:.1f} s", flush=True)
        return {"clean": {k: clean[k] for k in ("jobs_per_sec", "boot_p50_ms", "boot_p99_ms",
                                                 "wall_s")},
                "chaos": {k: chaos[k] for k in ("victim_wall_s", "neighbor_ratio_max",
                                                 "wall_s")},
                "pooled": {k: pooled[k] for k in ("fits_completed", "fits_per_sec",
                                                   "leases_per_worker")},
                "launches": {"a": n_a, "b": n_b}, "bench_s": round(took_a, 3),
                "takeover_s": round(tk["takeover_s"], 3),
                "kill_to_commit_s": round(tk["kill_to_commit_s"], 3),
                "wall_s": time.perf_counter() - t0}

    # -- phase 21 -----------------------------------------------------------------
    def surface_emulate(self, guide, world: int) -> str:
        """The hybrid guide program's world-``world`` job in this process:
        a thread a rank, the hop a float32 sum of the ranks' arrays in rank
        order (what the native engine's SUM gives two ranks).  Returns the
        forest's sha256.  A comparison: its launches do not count."""
        parts: list = [None] * world
        digests: list = [None] * world
        barrier = threading.Barrier(world)
        errors = []

        def rank(r: int) -> None:
            def hop(a):
                parts[r] = np.asarray(a, np.float32)
                barrier.wait()
                total = parts[0].copy()
                for p in parts[1:]:
                    total = total + p
                barrier.wait()
                return total

            try:
                state, _, _ = guide.train(r, world, self.dev, hop)
                digests[r] = guide.forest_digest(state.forest)
            except BaseException as e:  # noqa: BLE001 (reported below)
                errors.append(e)
                barrier.abort()

        threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        require(not errors and len(set(digests)) == 1 and digests[0],
                f"surface: the in-process world-{world} job: {errors or digests}")
        return digests[0]

    def surface_phase(self):
        """The user surface on the card (phase 21 of the module docstring)."""
        from rabit_tpu_torch import api

        root = os.path.dirname(os.path.abspath(__file__))
        bench = importlib.import_module("tools.torch_consensus_bench")
        guide = {n: load_module(f"torch_{n}", os.path.join(root, "guide", f"torch_{n}.py"))
                 for n in SURFACE_GUIDES}
        t0 = time.perf_counter()
        obs = tempfile.mkdtemp(prefix="rabit-surface-obs-")
        # (b) and (d) run beside (a) and (c): the launcher's CLI in a process
        # (and a session) of its own, its workers on the card
        job = subprocess.Popen(
            [sys.executable, "-m", "rabit_tpu_torch.tracker.launcher", "-n", "2",
             "--max-restarts", "3", "--timeout", "150", *SURFACE_LAUNCHER, "--",
             sys.executable, os.path.join(root, "guide", "torch_hybrid_gbdt.py"),
             "rabit_engine=mock", SURFACE_KILL], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True,
            env=dict(os.environ, RABIT_OBS_DIR=obs))
        lines: list[tuple[float, str]] = []  # (s from the job's start, line) of its output
        reader = threading.Thread(target=lambda: lines.extend(
            (time.perf_counter() - t0, ln.rstrip("\n")) for ln in job.stdout), daemon=True)
        reader.start()
        try:
            require(api._engine is None or getattr(api._engine, "_provisional", False),
                    "surface: the api is still initialized by an earlier phase")
            outs, counts_a = {}, {}
            for n, line in SURFACE_GUIDES.items():
                buf = io.StringIO()

                # as a user runs them; the hybrid one on this run's device (the card)
                argv = [f"rabit_torch_device={self.dev.type}"] if n == "hybrid_gbdt" else []

                def run(n=n, buf=buf, argv=argv):
                    with contextlib.redirect_stdout(buf):
                        require(guide[n].main(argv) == 0, f"surface (a): guide/torch_{n}.py failed")

                if n == "hybrid_gbdt":
                    _, counts_a = self.path(run)
                else:
                    run()
                outs[n] = buf.getvalue()
                require(line in outs[n], f"surface (a): guide/torch_{n}.py printed {outs[n]!r}")
            n_a = guide["hybrid_gbdt"].N_TREES * guide["hybrid_gbdt"].CFG_KW["depth"]
            require(counts_a == {"node_histograms_kernel": n_a},
                    f"surface (a): the hybrid program's launches {counts_a}, expected {n_a}")
            took_a = time.perf_counter() - t0
            print(f"  (a) the five guide programs solo in this process: each printed what "
                  f"tests/test_guide.py asserts; hybrid: "
                  f"{outs['hybrid_gbdt'].splitlines()[0].split('] ', 1)[1]}, launches "
                  f"{counts_a}; {took_a:.1f} s", flush=True)

            t = time.perf_counter()
            smoke, counts_c = self.path(lambda: bench.run_smoke(device=self.dev.type))
            n_c = smoke["n_contributions"]
            require(smoke["bitwise_identical"] and set(smoke["modes"]) == {
                "auto", "tree", "ring", "swing"} and counts_c == {"node_histograms_kernel": n_c},
                f"surface (c): run_smoke {smoke}, launches {counts_c}")
            rings = {}
            for mesh, world, ring in SURFACE_MESHES:
                with tempfile.TemporaryDirectory() as tmp:
                    mj, counts_m = self.path(lambda: bench.schedule_job(
                        world, SURFACE_VERSIONS, "swing", mesh, device=self.dev.type,
                        obs_dir=tmp))
                    with open(os.path.join(tmp, "telemetry.json")) as f:
                        tele = json.load(f)
                planned = [e["ring_order"] for e in mj["planned"]]
                filed = [e["ring_order"] for e in tele["events"]
                         if e["kind"] == "schedule_planned"]
                require(planned == filed == [ring] and tele["schedule"] == "swing"
                        and counts_m == {"node_histograms_kernel": mj["n_contributions"]}
                        and mj["n_contributions"] == world * SURFACE_VERSIONS,
                        f"surface (c): world {world} on {mesh}: planned {planned}, "
                        f"telemetry.json {filed}, launches {counts_m}")
                rings[mesh] = planned[0]
            took_c = time.perf_counter() - t
            print(f"  (c) run_smoke on the card: {sorted(smoke['modes'])} bitwise the closed "
                  f"form, launches {counts_c}; swing plans {rings} (events and telemetry.json); "
                  f"{took_c:.1f} s", flush=True)

            want = self.surface_emulate(guide["hybrid_gbdt"], 2)
            try:
                job.wait(timeout=180)
            except subprocess.TimeoutExpired as e:
                raise PhaseFailed("surface (b): the launcher's job did not end") from e
            took_b = time.perf_counter() - t0
            reader.join(10)
        finally:
            if job.poll() is None:
                os.killpg(job.pid, signal.SIGKILL)
                job.wait()
        out = "\n".join(ln for _, ln in lines)

        def first(text: str) -> float:  # s from the start to the first line holding text
            return next((round(t, 2) for t, ln in lines if text in ln), -1.0)

        timeline = {"died": first("[launcher] worker 1 died"),
                    "recovered": first("recovered at version"),
                    "report": first("hybrid gbdt: 3 trees"), "exited": round(took_b, 2)}
        require(job.returncode == 0, f"surface (b): the launcher exited {job.returncode}:\n"
                                     f"{out[-3000:]}")
        # the workers share the pipe, so two prints can meet on one line: match, not split
        reports = dict(re.findall(r"@node\[(\d+)\] hybrid gbdt: 3 trees, train-acc ([\d.]+)",
                                  out))
        digests = set(re.findall(r"forest sha256 ([0-9a-f]{64})", out))
        acc = set(reports.values())
        died = re.findall(r"\[launcher\] worker 1 died", out)
        require(sorted(reports) == ["0", "1"] and len(acc) == 1 and digests == {want}
                and len(died) == 1, f"surface (b): reports {reports}, digests {digests} (the "
                f"in-process job's {want}), deaths {len(died)}")
        with open(os.path.join(obs, "telemetry.json")) as f:
            tele = json.load(f)
        shutil.rmtree(obs, ignore_errors=True)
        planned = [e for e in tele["events"] if e["kind"] == "schedule_planned"]
        require(tele["restarts"] == {"1": 1} and tele["schedule"] == "swing" and planned
                and all(e["algo"] == "swing" and e["ring_order"] == [0, 1] for e in planned),
                f"surface (b)/(d): restarts {tele['restarts']}, schedule {tele['schedule']}, "
                f"plans {planned}")
        print(f"  (b) the launcher's CLI ({' '.join(SURFACE_LAUNCHER)}) ran the hybrid program "
              f"at world 2 with {SURFACE_KILL}: one restart, train-acc {acc.pop()} on both, "
              f"the forest the in-process world-2 job's ({want[:12]}); (d) telemetry.json: "
              f"schedule swing, {len(planned)} swing plans; {took_b:.1f} s from its start "
              f"(s from the start: {timeline})", flush=True)
        return {"launches": {"a": n_a, "c": n_c + sum(w * SURFACE_VERSIONS
                                                        for _, w, _ in SURFACE_MESHES)},
                "rings": rings, "a_s": round(took_a, 3), "b_s": round(took_b, 3),
                "b_timeline": timeline,
                "c_s": round(took_c, 3), "wall_s": time.perf_counter() - t0}

    # -- phase 22 -----------------------------------------------------------------
    def recovery_run(self, what: str, world: int, run) -> dict:
        """One in-thread scenario of tools/torch_recovery_bench.py on the card,
        its contribution counter made for ``world`` on the card, the launch
        counts set to 0 just before and read just after; prints its record."""
        bench = importlib.import_module("tools.torch_recovery_bench")
        counter = bench.contribution_counter(world, self.dev.type)
        self.clear_counts()
        t0 = time.perf_counter()
        rec = run(bench, counter)
        took = time.perf_counter() - t0
        counts = self.read_counts(counter.n_calls)
        require(counts == {"node_histograms_kernel": counter.n_calls} and counter.n_calls,
                f"recovery {what}: launches {counts}, expected {counter.n_calls} "
                "(one a contribution)")
        print(f"  ({what}) {json.dumps(rec)}; {counter.n_calls} launches; {took:.2f} s",
              flush=True)
        return {"record": rec, "launches": counter.n_calls, "wall_s": round(took, 3)}

    def recovery_phase(self):
        """The recovery bench's in-thread modes on the card (phase 22 of the
        module docstring)."""
        t0 = time.perf_counter()
        out = {}
        for what, world, relays in (("a: failover", 2, 0), ("b: failover, relay", 3, 1)):
            r = out[what] = self.recovery_run(what, world, lambda b, c, w=world, n=relays: (
                b._failover_once(w, relays=n, counter=c, **RECOVERY_FAILOVER)))
            rec = r["record"]
            require(rec["takeover_latency_s"] is not None and rec["takeover_latency_s"] < 3.0
                    and rec["first_wave_after_s"] is not None and rec["n_lease_expired"] == 1,
                    f"recovery {what}: {rec}")
        r = out["c: promote"] = self.recovery_run("c: promote", 3, lambda b, c: b._elastic_once(
            3, with_spare=True, grow_back=False, shrink_after_sec=1.0, counter=c))
        rec = r["record"]
        require(rec["promote_latency_s"] is not None and rec["epochs"]
                and rec["epochs"][-1]["world"] == 3, f"recovery (c) promote: {rec}")
        r = out["d: shrink, grow"] = self.recovery_run(
            "d: shrink, grow", 3, lambda b, c: b._elastic_once(
                3, with_spare=False, grow_back=True, shrink_after_sec=1.0, counter=c,
                **RECOVERY_GROW))
        rec = r["record"]
        worlds = [e["world"] for e in rec["epochs"]]
        require(rec["shrink_latency_s"] is not None and rec["grow_latency_s"] is not None
                and 2 in worlds and worlds[-1] == 3, f"recovery (d) shrink, grow: {rec}")
        out["wall_s"] = time.perf_counter() - t0
        print(f"  recovery phase: {out['wall_s']:.1f} s", flush=True)
        return out

    # -- phases 23-26 -------------------------------------------------------------
    @functools.cached_property
    def X(self):
        """slice_data's features on the card."""
        return self.xb.float() / 256

    def slice_rank_equal(self, key: str):
        """The key's value, required bitwise equal on every rank."""
        val = self.slice_runs[0][key]
        for run in self.slice_runs[1:]:
            require(run[key].tobytes() == val.tobytes(), f"the ranks' {key} differ")
        return val

    def linear_phase(self):
        """linear: LinearModel.fit on the card at the headline size (logistic,
        the LinearConfig defaults) bitwise its train_step loop, whose steps
        LIN_CHECKED are held teacher-forced against the CPU; train_step_dp on
        an NCCL group of one bitwise the loop; on the gloo world,
        train_step_dp (every step teacher-forced against the single-process
        step on the card) and LinearModel(engine_allreduce=api.allreduce),
        bitwise the dp weights."""
        torch = self.torch
        from rabit_tpu_torch.models import linear

        X, y = self.X, self.y
        Xh, yh = X.cpu().numpy(), y.cpu().numpy()
        cfg = linear.LinearConfig(n_features=N_FEATURES)
        linear.LinearModel(n_steps=2).fit(Xh, yh)  # warm-up
        t0 = time.perf_counter()
        model = linear.LinearModel().fit(Xh, yh)
        fit_ms = (time.perf_counter() - t0) * 1e3 / cfg.n_steps
        require(model.w.shape == (N_FEATURES + 1,) and np.isfinite(model.w).all(),
                f"LinearModel.fit gave {model.w}")
        state = linear.init_state(cfg)
        ws = [state.w]
        for _ in range(cfg.n_steps):
            state = linear.train_step(state, X, y, cfg)
            ws.append(state.w)
        require(ws[-1].cpu().numpy().tobytes() == model.w.tobytes(),
                "LinearModel.fit differs from its train_step loop")
        step_ms = cuda_ms(torch, lambda: linear.train_step(state, X, y, cfg), 20)
        Xc, yc = X.cpu(), y.cpu()
        cpu_err = max(tol_err(ws[i + 1].cpu(), linear.train_step(
            linear.LinearState(ws[i].cpu(), state.step.cpu()), Xc, yc, cfg).w, *LIN_TOL)
            for i in LIN_CHECKED)
        require(cpu_err <= 1, f"linear steps {LIN_CHECKED} on the card against the CPU: "
                              f"{cpu_err:.3f} of the tolerance")
        acc = float((model.predict(Xh) == yh).mean())
        with nccl_group_of_one():
            s = linear.init_state(cfg)
            for _ in range(cfg.n_steps):
                s = linear.train_step_dp(s, X, y, cfg)
            dp1_ms = cuda_ms(torch, lambda: linear.train_step_dp(s, X, y, cfg), 20)
        require(torch.equal(s.w, ws[-1]), "train_step_dp on one NCCL rank differs from "
                                          "train_step")
        dp_w = self.slice_rank_equal("lin_dp_w")
        hook_w = self.slice_rank_equal("lin_hook_w")
        require(hook_w.tobytes() == dp_w[-1].tobytes(),
                "the engine-hook fit differs from train_step_dp over the same group")
        dp_err = max(tol_err(torch.as_tensor(dp_w[i + 1], device=self.dev), linear.train_step(
            linear.LinearState(torch.as_tensor(dp_w[i], device=self.dev), state.step),
            X, y, cfg).w, *LIN_TOL) for i in range(cfg.n_steps))
        require(dp_err <= 1, f"train_step_dp over gloo against the single-process step: "
                             f"{dp_err:.3f} of the tolerance")
        r0 = self.slice_runs[0]
        self.slice_ms["linear"] = ms = {
            "fit": fit_ms, "train_step": step_ms, "dp_nccl1": dp1_ms,
            f"dp_gloo{DP_RANKS}": float(r0["lin_dp_ms"]),
            f"hook_gloo{DP_RANKS}": float(r0["lin_hook_ms"])}
        print(f"  LinearModel.fit ({self.n_rows} x {N_FEATURES}, logistic, {cfg.n_steps} "
              f"steps): bitwise its train_step loop; steps {LIN_CHECKED} within "
              f"{cpu_err:.3f} of rtol/atol {LIN_TOL} of the CPU's; train accuracy {acc:.4f}; "
              f"train_step_dp on NCCL world 1 bitwise; over gloo every step within "
              f"{dp_err:.3f} of the tolerance of the single-process step, the engine hook "
              "bitwise the dp weights")
        print("  linear ms/step " + json.dumps(ms))

    def kmeans_phase(self):
        """kmeans: KMeans(64, 20, seed=0).fit on the card at the headline
        size bitwise its train_iter loop, whose iterations KM_CHECKED are held
        teacher-forced against the CPU (assignments but for near ties;
        local_stats the f64 sums of the card's assignments, rounded); train_iter_dp
        on an NCCL group of one bitwise the loop; on the gloo world,
        train_iter_dp (the checked iterations teacher-forced: the ranks'
        assignments against the card's single-process ones but for near ties,
        the new centers the f64 means of the ranks' assignments) and
        KMeans(engine_allreduce=api.allreduce), bitwise the dp centers."""
        torch = self.torch
        from rabit_tpu_torch.models import kmeans
        from rabit_tpu_torch.ops import hist

        flips_of = worker_module("torch_models_worker").assign_flips
        X = self.X
        Xh = X.cpu().numpy()
        init = kmeans.KMeans(KM_K, 0, seed=0).fit(Xh).centers
        kmeans.KMeans(KM_K, 2, seed=0).fit(Xh)  # warm-up
        t0 = time.perf_counter()
        model = kmeans.KMeans(KM_K, KM_ITERS, seed=0).fit(Xh)
        fit_ms = (time.perf_counter() - t0) * 1e3 / KM_ITERS
        require(model.centers.shape == (KM_K, N_FEATURES)
                and np.isfinite(model.centers).all(), "KMeans.fit gave non-finite centers")
        cs = [torch.as_tensor(init, device=self.dev)]
        for _ in range(KM_ITERS):
            cs.append(kmeans.train_iter(cs[-1], X))
        require(cs[-1].cpu().numpy().tobytes() == model.centers.tobytes(),
                "KMeans.fit differs from its train_iter loop")
        c = cs[-1]
        a = kmeans.assign(X, c)
        vals = torch.cat([X, X.new_ones((len(X), 1))], 1)
        ms = {"fit": fit_ms, "train_iter": cuda_ms(torch, lambda: kmeans.train_iter(c, X), 5),
              "assign": cuda_ms(torch, lambda: kmeans.assign(X, c), 5),
              "segment_sum": cuda_ms(torch, lambda: hist.segment_sum(vals, a, KM_K), 5)}

        def f64_means(assign, centers):  # update() of the f64 sums, in f64
            sums = np.stack([np.bincount(assign, Xh[:, j].astype(np.float64), KM_K)
                             for j in range(N_FEATURES)], 1)
            n = np.bincount(assign, minlength=KM_K)[:, None]
            return np.where(n > 0, sums / np.maximum(n, 1), centers), sums, n

        flips, stats_err = 0, 0.0
        for i in KM_CHECKED:
            ci = cs[i]
            got = kmeans.assign(X, ci).cpu().numpy()
            flips += flips_of(Xh, ci.cpu().numpy(), got,
                              kmeans.assign(X.cpu(), ci.cpu()).numpy())
            _, sums, n = f64_means(got, ci.cpu().numpy())
            stats = kmeans.local_stats(X, ci).cpu().numpy()
            require(np.array_equal(stats[:, -1:], n), f"iteration {i}: counts differ")
            stats_err = max(stats_err, float(np.max(
                np.abs(stats[:, :-1] - sums) / (1e-30 + 2.0 ** -23 * np.abs(sums)))))
        require(stats_err <= 1, f"local_stats against the f64 sums: {stats_err:.3f} of an ulp")
        with nccl_group_of_one():
            c1 = cs[0]
            for _ in range(KM_ITERS):
                c1 = kmeans.train_iter_dp(c1, X)
            ms["dp_nccl1"] = cuda_ms(torch, lambda: kmeans.train_iter_dp(c, X), 5)
        require(torch.equal(c1, cs[-1]), "train_iter_dp on one NCCL rank differs from "
                                         "train_iter")
        dp_c = self.slice_rank_equal("km_dp_c")
        hook_c = self.slice_rank_equal("km_hook_c")
        require(hook_c.tobytes() == dp_c[-1].tobytes(),
                "the engine-hook fit differs from train_iter_dp over the same group")
        dp_flips, dp_err = 0, 0.0
        for i in KM_CHECKED:
            got = np.concatenate([run[f"km_dp_assign/{i}"] for run in self.slice_runs])
            ci = torch.as_tensor(dp_c[i], device=self.dev)
            dp_flips += flips_of(Xh, dp_c[i], got, kmeans.assign(X, ci).cpu().numpy())
            want, _, _ = f64_means(got, dp_c[i])
            dp_err = max(dp_err, float(np.max(
                np.abs(dp_c[i + 1] - want) / (1e-30 + 2.0 ** -21 * np.abs(want)))))
        require(dp_err <= 1, f"train_iter_dp over gloo against the f64 means: {dp_err:.3f} "
                             "of the tolerance")
        r0 = self.slice_runs[0]
        ms.update({f"dp_gloo{DP_RANKS}": float(r0["km_dp_ms"]),
                   f"hook_gloo{DP_RANKS}": float(r0["km_hook_ms"])})
        self.slice_ms["kmeans"] = ms
        print(f"  KMeans.fit ({self.n_rows} x {N_FEATURES}, K = {KM_K}, {KM_ITERS} "
              f"iterations, seed 0): bitwise its train_iter loop, inertia "
              f"{model.inertia(Xh):.6g}; iterations {KM_CHECKED}: {flips} assignments "
              f"differ from the CPU's, each a near tie (c = 2F); local_stats within "
              f"{stats_err:.3f} ulp of the f64 sums; train_iter_dp on NCCL world 1 bitwise; "
              f"over gloo {dp_flips} near-tie assignments differ, centers within "
              f"{dp_err:.3f} of 2^-21 of the f64 means; the engine hook bitwise the dp "
              "centers")
        print("  kmeans ms/iteration " + json.dumps(ms))

    def attention_phase(self):
        """attention: ring_attention and ulysses_attention at 8192 x 32 x
        128, f32 and bf16, causal and not, on an NCCL group of one here and
        on the gloo world (block 4096), each against the head-sliced
        reference (att_tol); ms a call, and the host-staged hops alone."""
        torch = self.torch
        from rabit_tpu_torch.parallel import ring

        torch.cuda.empty_cache()
        world1 = {}
        with nccl_group_of_one():
            attention_cases(torch, ring, 0, 1, world1)
        res = {"nccl1": world1, f"gloo{DP_RANKS}": self.slice_runs[0]}
        for where, out in [("nccl1", world1)] + [
                (f"gloo{DP_RANKS} rank {r}", run) for r, run in enumerate(self.slice_runs)]:
            for k in (k for k in out if k.startswith("err/")):
                require(float(out[k]) <= 1, f"{k[4:]} ({where}) against the reference: "
                                            f"{float(out[k]):.3f} of the tolerance")
        torch.cuda.empty_cache()
        self.slice_ms["attention"] = ms = {
            w: {k[3:]: float(v) for k, v in out.items() if k.startswith("ms/")}
            for w, out in res.items()}
        r0 = self.slice_runs[0]
        hops = {k[7:]: float(v) for k, v in r0.items() if k.startswith("hop_ms/")}
        ms["hops"] = hops
        worst = max(float(v) for out in [world1] + self.slice_runs
                    for k, v in out.items() if k.startswith("err/"))
        print(f"  ring_attention, ulysses_attention ({ATT_SEQ} x {ATT_HEADS} x {ATT_DIM}; "
              f"f32, bf16; causal and not; NCCL world 1 and gloo world {DP_RANKS}): every "
              f"output within {worst:.3f} of its tolerance of the f32 reference (rtol/atol "
              f"{ATT_F32}, bf16 rtol + 2^-8)")
        g = ms[f"gloo{DP_RANKS}"]
        for dname in ("f32", "bf16"):
            share = {f"ring/{c}": hops["ring"] / g[f"ring_attention/{dname}/{c}"]
                     for c in ("full", "causal")}
            share.update({f"ulysses/{c}": hops[f"ulysses/{dname}"]
                          / g[f"ulysses_attention/{dname}/{c}"] for c in ("full", "causal")})
            print(f"  {dname}: share of a call in host-staged hops (rank 0) " + json.dumps(share))
        print("  attention ms/call " + json.dumps(ms))

    def durable_phase(self):
        """durable: two-process gloo jobs on the card through the api with
        rabit_checkpoint_dir (tests/workers/torch_durable_worker.py's job,
        the headline data): one never stopped and one stopped at version
        DURABLE_STOP of DURABLE_STEPS, together; then a fresh job resuming a
        copy of the stopped one's directory, and another resuming a copy
        with rank 1's global files deleted (rank 0's broadcast serves the
        blob, rank 1 rebuilds its local model), together.  Both must end
        with the unstopped job's weights bit for bit."""
        t_phase = time.perf_counter()
        with tempfile.TemporaryDirectory() as ck:
            d = {k: os.path.join(ck, k) for k in ("clean", "stop", "resume", "missing")}
            t0 = time.perf_counter()
            first = run_ranks(_durable_rank, 4, self.n_rows, json.dumps(
                [[d["clean"], DURABLE_STEPS, 0], [d["stop"], DURABLE_STEPS, DURABLE_STOP]]))
            t1 = time.perf_counter() - t0
            frames = {f: os.path.getsize(os.path.join(d["stop"], f))
                      for f in sorted(os.listdir(d["stop"]))}
            shutil.copytree(d["stop"], d["resume"])
            shutil.copytree(d["stop"], d["missing"])
            for f in os.listdir(d["missing"]):
                if f.startswith("global_r1_"):
                    os.unlink(os.path.join(d["missing"], f))
            t0 = time.perf_counter()
            second = run_ranks(_durable_rank, 4, self.n_rows, json.dumps(
                [[d["resume"], DURABLE_STEPS, 0], [d["missing"], DURABLE_STEPS, 0]]))
            t2 = time.perf_counter() - t0
        clean, stopped, resumed, missing = first[:2], first[2:], second[:2], second[2:]
        w = clean[0]["w"].tobytes()
        for name, job, at, frm in (("unstopped", clean, DURABLE_STEPS, 0),
                                   ("stopped", stopped, DURABLE_STOP, 0),
                                   ("resumed", resumed, DURABLE_STEPS, DURABLE_STOP),
                                   ("resumed without rank 1's files", missing, DURABLE_STEPS,
                                    DURABLE_STOP)):
            for run in job:
                require(int(run["version"]) == at and int(run["resumed_from"]) == frm,
                        f"the {name} job ended at v{int(run['version'])} from "
                        f"v{int(run['resumed_from'])}, expected v{at} from v{frm}")
                if name != "stopped":
                    require(run["w"].tobytes() == w,
                            f"the {name} job's weights differ from the unstopped job's")
        require([int(r["rebuilt"]) for r in missing] == [0, 1],
                "rank 1 did not rebuild its lost local model")
        self.slice_ms["durable"] = {
            "phase_s": time.perf_counter() - t_phase, "first_round_s": t1,
            "second_round_s": t2, "frame_bytes": frames,
            "job_s": {k: float(j[0]["wall_s"]) for k, j in (
                ("unstopped", clean), ("stopped", stopped), ("resumed", resumed),
                ("missing", missing))}}
        print(f"  durable: stop at v{DURABLE_STOP} of {DURABLE_STEPS}, resumed by a fresh "
              "job, and again with rank 1's global files deleted: the unstopped job's "
              "weights bit for bit; rank 1 rebuilt its local model; frames on disk at the "
              "stop " + json.dumps(frames))
        print("  durable " + json.dumps(self.slice_ms["durable"]))

    # -- phase 28 -----------------------------------------------------------------
    def trace_phase(self, logdir: str):
        """One warm fused bf16 round and one warm hook-based bf16 round under
        profile.device_trace: each round's wall time, the device time in
        the port's kernels, the device time of every other kernel by the
        top aten op that launched it, and the time the device sat idle
        inside the round."""
        from torch.profiler import record_function

        from rabit_tpu_torch import _build, profile

        torch, gbdt = self.torch, self.gbdt
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES, n_trees=2, depth=DEPTH,
                              n_bins=self.n_bins)
        fused = gbdt.train_round_fused(gbdt.init_state(cfg, self.n_rows, self.dev),
                                       self.xb3, self.y, cfg)  # warm-up
        hook = gbdt.train_round(gbdt.init_state(cfg, self.n_rows, self.dev),
                                self.xb, self.y, cfg)  # warm-up
        runs = {"fused round": lambda: gbdt.train_round_fused(fused, self.xb3, self.y, cfg),
                "hook round": lambda: gbdt.train_round(hook, self.xb, self.y, cfg)}
        untraced_ms = {}
        for name, fn in runs.items():  # the same rounds, not traced
            self.sync()
            t0 = time.perf_counter()
            fn()
            self.sync()
            untraced_ms[name] = (time.perf_counter() - t0) * 1e3

        def rounds():
            with profile.device_trace(logdir, device=self.dev) as prof:
                for name, fn in runs.items():
                    with record_function(name):
                        fn()
                        self.sync()
            return prof

        prof, counts = self.path(rounds)
        want = {"hist_level0": 1, "hist_level": DEPTH - 1, "route_level": 1,
                "node_histograms_kernel": DEPTH}
        require(counts == want, f"trace launch counts {counts}, expected {want}")
        names = _build.kernel_names()
        out = {}
        for window in ("fused round", "hook round"):
            got = profile.split(prof.events(), names, window=window)
            require(got["busy_ms"] > 0, f"{window}: the trace saw no device time")
            got["untraced_ms"] = untraced_ms[window]
            out[window] = got
            port = sum(got["port_ms"].values())
            other = sorted(got["other_ms"].items(), key=lambda kv: -kv[1])
            print(f"  {window}: wall {got['window_ms']:.3f} ms traced ({untraced_ms[window]:.3f} "
                  f"not traced); device busy {got['busy_ms']:.3f} ms; the port's kernels "
                  f"{port:.3f} ms on the device "
                  + json.dumps({k: round(v, 4) for k, v in got["port_ms"].items()})
                  + f"; other kernels {sum(got['other_ms'].values()):.3f} ms by top op "
                  + json.dumps({k: round(v, 4) for k, v in other})
                  + f"; device idle {got['idle_ms']:.3f} ms traced "
                  f"({untraced_ms[window] - got['busy_ms']:.3f} not traced: its wall less the "
                  f"busy time); {got['launches']} device launches, copies and fills")
        print(f"  Chrome trace under {logdir}")
        return out

    # -- phase 27 -----------------------------------------------------------------
    def measure(self):
        torch, boost = self.torch, self.boost
        xb3, g3, h3 = self.xb3, self.g3, self.h3
        rows = xb3.shape[0] * xb3.shape[1]
        hist_bytes = lambda nodes: nodes * N_FEATURES * self.n_bins * 2 * 4
        flat_x = xb3.reshape(rows, N_FEATURES).long()
        feat_ids = torch.arange(N_FEATURES, device=self.dev)
        gh = torch.stack([g3.reshape(-1, 1).expand(rows, N_FEATURES),
                          h3.reshape(-1, 1).expand(rows, N_FEATURES)], -1).reshape(-1, 2)

        def library(node):  # one index_add_ builds the same histogram
            seg = ((node.reshape(-1, 1).long() * N_FEATURES + feat_ids) * self.n_bins
                   + flat_x).reshape(-1)
            n_seg = int(node.max()) + 1 if node.numel() else 1
            out = torch.zeros(n_seg * N_FEATURES * self.n_bins, 2, device=self.dev)
            return cuda_ms(torch, lambda: out.zero_().index_add_(0, seg, gh), 5)

        # hist_level0 / hist_level per level d = 0..7 (d = 0: the root), bf16
        # and i8; the report's hist_level is the bf16 mean over d = 1..5 (a
        # depth-6 tree's levels), with its index_add_ and plain times
        per = {"bf16": [], "i8": []}
        lms, pms, byts = [], [], []
        for d in range(DEEP):
            if d == 0:
                node3 = feat = thr = None
                run = lambda i8: boost.hist_level0(xb3, g3, h3, n_bins=self.n_bins, mxu_i8=i8)
            else:
                node3, feat, thr = self.level_inputs(d)
                run = lambda i8: boost.hist_level(xb3, node3, g3, h3, feat, thr, depth=d,
                                                  n_bins=self.n_bins, mxu_i8=i8)
            for i8 in (False, True):
                per["i8" if i8 else "bf16"].append(cuda_ms(torch, lambda: run(i8), 10))
            if d < DEPTH:  # the levels the report's figure averages, bf16
                self.device_fns["hist_level0" if d == 0 else "hist_level"].append(
                    functools.partial(run, False) if d == 0 else functools.partial(
                        boost.hist_level, xb3, node3, g3, h3, feat, thr, depth=d,
                        n_bins=self.n_bins))
            if d == 0:
                lms.append(library(torch.zeros(rows, device=self.dev, dtype=torch.int32)))
                self.plain_ms["hist_level0"] = cuda_ms(
                    torch, lambda: boost.hist_level0_plain(xb3, g3, h3, n_bins=self.n_bins), 1)
                byts.append(xb3.numel() * 4 + 2 * rows * 4 + hist_bytes(1))
            elif d < DEPTH:
                lms.append(library(run(False)[1]))
                pms.append(cuda_ms(torch, lambda: boost.hist_level_plain(
                    xb3, node3, g3, h3, feat, thr, depth=d, n_bins=self.n_bins), 1))
                byts.append(xb3.numel() * 4 + 4 * rows * 4 + hist_bytes(2 ** d))
        for mode, t in per.items():
            print(f"  {mode} histogram ms by level, hist_level0 then hist_level d=1..7: "
                  + ", ".join(f"{x:.4f}" for x in t))
        self.ms["hist_level0"] = per["bf16"][0]
        self.library_ms["hist_level0"] = lms[0]
        self.bound["hist_level0"] = (byts[0], 2.0 * rows * N_FEATURES)
        self.ms["hist_level"] = sum(per["bf16"][1:DEPTH]) / (DEPTH - 1)
        self.plain_ms["hist_level"] = sum(pms) / len(pms)
        self.library_ms["hist_level"] = sum(lms[1:]) / len(lms[1:])
        self.bound["hist_level"] = (sum(byts[1:]) / len(byts[1:]), 2.0 * rows * N_FEATURES)
        print("  index_add_ ms by level d=0..5: " + ", ".join(f"{x:.4f}" for x in lms))
        self.measure_helpers()
        # final passes at depth 6.  Per row a pass must read its node id (4
        # bytes) and its split bin, one 32-byte sector of its feature row
        # (the least the card reads for it), and write its leaf id (4); with
        # the margin it also reads and writes a float: 40 and 48 bytes a row.
        node3, feat, thr = self.level_inputs(DEPTH)
        leaf = torch.randn(2 ** DEPTH, device=self.dev)
        route = functools.partial(boost.route_level, xb3, node3, feat, thr, depth=DEPTH)
        self.ms["route_level"] = cuda_ms(torch, route, 50)
        self.device_fns["route_level"].append(route)
        self.plain_ms["route_level"] = cuda_ms(torch, lambda: boost.route_level_plain(
            xb3, node3, feat, thr, depth=DEPTH), 5)
        self.library_ms["route_level"] = None
        self.bound["route_level"] = (rows * (32 + 4 + 4), 2.0 * rows)
        m3 = self.margin3
        route = functools.partial(boost.route_margin_level, xb3, node3, m3, feat, thr,
                                  leaf, depth=DEPTH)
        self.ms["route_margin_level"] = cuda_ms(torch, route, 50)
        self.device_fns["route_margin_level"].append(route)
        self.plain_ms["route_margin_level"] = cuda_ms(
            torch, lambda: boost.route_margin_level_plain(
                xb3, node3, m3, feat, thr, leaf, depth=DEPTH), 5)
        self.library_ms["route_margin_level"] = None
        self.bound["route_margin_level"] = (rows * (32 + 4 + 4 + 4 + 4), 3.0 * rows)
        # node_histograms_kernel at the real round's node ids, d = 0..7, bf16
        # and i8; the report's figure is the bf16 mean over d = 0..5
        n = self.n_rows
        per = {"bf16": [], "i8": []}
        pms, lms, byts = [], [], []
        for d, (node, _, _, _) in enumerate(self.levels):
            args = (self.xb, self.g, self.h, node, 2 ** d, self.n_bins)
            for i8 in (False, True):
                per["i8" if i8 else "bf16"].append(cuda_ms(
                    torch, lambda: self.hist.node_histograms_kernel(*args, mxu_i8=i8), 10))
            if d < DEPTH:
                self.device_fns["node_histograms_kernel"].append(
                    functools.partial(self.hist.node_histograms_kernel, *args))
                pms.append(cuda_ms(torch, lambda: self.hist.node_histograms_kernel_plain(
                    *args), 1))
                lms.append(library(boost.block_rows(node)[0].reshape(-1)))
                byts.append(n * N_FEATURES * 4 + 3 * n * 4 + hist_bytes(2 ** d))
        for mode, t in per.items():
            print(f"  {mode} node_histograms_kernel ms by level d=0..7: "
                  + ", ".join(f"{x:.4f}" for x in t))
        print("  index_add_ ms by level d=0..5: " + ", ".join(f"{x:.4f}" for x in lms))
        k = "node_histograms_kernel"
        self.ms[k] = sum(per["bf16"][:DEPTH]) / DEPTH
        self.plain_ms[k] = sum(pms) / len(pms)
        self.library_ms[k] = sum(lms) / len(lms)
        self.bound[k] = (sum(byts) / len(byts), 2.0 * n * N_FEATURES)
        # leaf_fit at the real round's last level; the yardstick is one
        # index_add_ of the rows' (g, h) into the 2**depth leaves
        largs, _ = self.leaf_inputs()
        leaf_fit = functools.partial(boost.leaf_fit, *largs, depth=DEPTH)
        self.ms["leaf_fit"] = cuda_ms(torch, leaf_fit, 50)
        self.device_fns["leaf_fit"].append(leaf_fit)
        self.plain_ms["leaf_fit"] = cuda_ms(
            torch, lambda: boost.leaf_fit_plain(*largs, depth=DEPTH), 1)
        leaf_ids = boost.leaf_fit(*largs, depth=DEPTH)[1].reshape(-1).long()
        gh2 = torch.stack([g3.reshape(-1), h3.reshape(-1)], -1)
        out = torch.zeros(2 ** DEPTH, 2, device=self.dev)
        self.library_ms["leaf_fit"] = cuda_ms(
            torch, lambda: out.zero_().index_add_(0, leaf_ids, gh2), 50)
        self.bound["leaf_fit"] = (rows * (32 + 4 + 4 + 4 + 4) + 2 ** DEPTH * 8,
                                  4.0 * rows)
        # device times last: the profiler is attached to no event timing
        self.device_ms = {}
        for k, fns in self.device_fns.items():
            try:
                self.device_ms[k] = sum(device_ms(torch, fn, 10) for fn in fns) / len(fns)
            except PhaseFailed as e:  # not measured: the kernels line holds null
                print(f"  {k}: device time not measured ({e})")
                self.device_ms[k] = None

    def measure_helpers(self):
        """hist_prep and hist_partition alone, per level of the fused
        round's route mode (d = 1..7, seeded node ids, bf16), and their
        plain twins; the report's figures are the means over d = 1..5.
        Bounds: prep reads the node id, one 32-byte sector of the row's bins
        and writes node' (4 + 32 + 4 bytes a row); partition reads node',
        g and h and writes perm and the planes (4 + 8 + 4 + 8 bytes a
        row).  Neither has a single PyTorch call that computes it."""
        torch, boost = self.torch, self.boost
        xb3, g3, h3 = self.xb3, self.g3, self.h3
        rows = xb3.shape[0] * xb3.shape[1]
        t = {k: [] for k in ("prep", "partition", "prep_plain", "partition_plain",
                             "argsort")}
        for d in range(1, DEEP):
            node3, feat, thr = self.level_inputs(d)
            kw = dict(n_rows=rows, block=xb3.shape[1], n_nodes=2 ** d, i8=False)
            prep = lambda: boost.hist_prep("route", xb3, node3, g3, h3, feat, thr, **kw)
            key, counts, scale = prep()
            t["prep"].append(cuda_ms(torch, prep, 20))
            t["partition"].append(cuda_ms(torch, lambda: boost.hist_partition(
                key, g3, h3, counts, scale, **kw), 20))
            if d < DEPTH:
                self.device_fns["hist_prep"].append(functools.partial(
                    boost.hist_prep, "route", xb3, node3, g3, h3, feat, thr, **kw))
                self.device_fns["hist_partition"].append(functools.partial(
                    boost.hist_partition, key, g3, h3, counts, scale, **kw))
                t["prep_plain"].append(cuda_ms(torch, lambda: boost.hist_prep_plain(
                    "route", xb3, node3, g3, h3, feat, thr, **kw), 3))
                t["partition_plain"].append(cuda_ms(torch, lambda: boost.hist_partition_plain(
                    key, g3, h3, counts, scale, **kw), 3))
                t["argsort"].append(cuda_ms(torch, lambda: torch.argsort(
                    key.reshape(-1), stable=True), 20))
        for k in ("prep", "partition"):
            print(f"  hist_{k} ms by level d=1..7 (route, bf16): "
                  + ", ".join(f"{x:.4f}" for x in t[k]))
        print("  torch.argsort(stable) of the node ids, ms d=1..5 (the partition's "
              "order alone): " + ", ".join(f"{x:.4f}" for x in t["argsort"]))
        mean = lambda v: sum(v[:DEPTH - 1]) / (DEPTH - 1)
        for k, per_row in (("prep", 4 + 32 + 4), ("partition", 4 + 8 + 4 + 8)):
            name = "hist_" + k
            self.ms[name] = mean(t[k])
            self.plain_ms[name] = mean(t[k + "_plain"])
            self.library_ms[name] = None
            self.bound[name] = (rows * per_row, 2.0 * rows)

    def kernels_line(self):
        out = []
        for k in REPLACES:
            byts, ops = self.bound[k]
            t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
            out.append({
                "name": k, "route": "cuda", "source": SOURCE[k],
                "replaces": REPLACES[k], "launches": self.launches[k],
                "max_abs_err": self.err[k], "ms": self.ms[k],
                "device_ms": self.device_ms[k],
                "plain_ms": self.plain_ms[k], "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": self.library_ms[k],
            })
        return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000,
                    help="rows of the generated data set (default: the headline 1M)")
    ap.add_argument("--trace-dir", default="traces",
                    help="where the trace phase writes its Chrome trace (default: traces/)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    try:
        from rabit_tpu_torch import _build
        from rabit_tpu_torch.engine import native
        from rabit_tpu_torch.models import gbdt
        from rabit_tpu_torch.ops import boost, hist
    except ImportError as e:
        print(f"FAIL: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    # the plain versions' matmuls, and the products of phases 23-25 (exact f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase, t_phase = "device", time.perf_counter()
    took = {}  # each phase's wall seconds, printed as one line at the end

    def next_phase(name: str) -> str:  # prints the phase that ends and its wall time
        nonlocal t_phase
        took[phase] = time.perf_counter() - t_phase
        print(f"[{phase}] took {took[phase]:.1f} s", flush=True)
        t_phase = time.perf_counter()
        return name

    try:
        name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = nvidia_smi()
        print(f"[device] {name} x{count}; nvidia-smi: {smi}", flush=True)

        phase = next_phase("build")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            # g++ of the native engine beside the nvcc builds
            native_lib = pool.submit(native.build_lib)
            _build.build_all()
            print(f"[build] native engine: {native_lib.result().name} (g++)")
        for src, log in _build.ptxas_log.items():
            print(f"[build] csrc/{src}.cu, -Xptxas -v:")
            for line in ptxas_summary(log):
                print("  " + line)
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)

        phase = next_phase("kernels")
        smoke = Smoke(torch, boost, hist, gbdt, args.rows)
        print(f"[kernels] {args.rows} rows x {N_FEATURES} features x {N_BINS} bins")
        smoke.check_kernels()
        smoke.check_deep_levels()
        smoke.check_node_kernel()
        smoke.check_helpers()
        smoke.check_leaf_fit()
        smoke.check_large_hist()
        smoke.check_row_blocks()
        for n_bins in WIDE_BINS:
            print(f"[kernels] {n_bins} bins")
            Smoke(torch, boost, hist, gbdt, args.rows, n_bins=n_bins).check_wide_bins()

        phase = next_phase("main")
        wide = Smoke(torch, boost, hist, gbdt, args.rows, n_bins=WIDE_BINS[0])
        round_ms = {}
        for s in (smoke, wide):
            for i8 in (False, True):
                for fused_final in (False, True):
                    key = (("i8" if i8 else "bf16") + ("+fused_final" if fused_final else "")
                           + ("" if s is smoke else f" {s.n_bins} bins"))
                    round_ms[key] = s.main_path(i8, fused_final)
        smoke.user_entry()
        smoke.small_reference()
        for i8 in (False, True):
            smoke.deep_round(i8)
        print("[main] ms/round " + json.dumps(round_ms), flush=True)

        phase = next_phase("hook")
        smoke.hook_path()
        hook_ms = smoke.hook_rounds()
        hook_ms.update({f"{k} {wide.n_bins} bins": v for k, v in wide.hook_rounds().items()})
        print("[hook] train_round ms/round " + json.dumps(hook_ms), flush=True)
        for k, v in wide.launches.items():  # the wide data's main paths
            smoke.launches[k] += v

        phase = next_phase("leaf")
        smoke.leaf_path()

        phase = next_phase("dp")
        smoke.dp_single()
        smoke.dp_two_ranks()
        print("[dp] done", flush=True)

        phase = next_phase("engine")
        smoke.engine_phase()

        phase = next_phase("compress")
        smoke.compress_phase()

        phase = next_phase("hybrid")
        print(f"[hybrid] train_round_hybrid {smoke.hybrid_phase():.3f} ms/round", flush=True)

        phase = next_phase("recover")
        rec = smoke.recover_phase()
        print("[recover] " + json.dumps(rec), flush=True)

        phase = next_phase("liveness")
        print("[liveness] " + json.dumps(smoke.liveness_phase()), flush=True)

        phase = next_phase("elastic")
        print("[elastic] " + json.dumps(smoke.elastic_phase()), flush=True)

        phase = next_phase("diagnose")
        print("[diagnose] " + json.dumps(smoke.diagnose_phase()), flush=True)

        phase = next_phase("quorum")
        print("[quorum] " + json.dumps(smoke.quorum_phase()), flush=True)

        phase = next_phase("failover")
        print("[failover] " + json.dumps(smoke.failover_phase()), flush=True)

        phase = next_phase("relay")
        print("[relay] " + json.dumps(smoke.relay_phase()), flush=True)

        phase = next_phase("chaos")
        print("[chaos] " + json.dumps(smoke.chaos_phase()), flush=True)

        phase = next_phase("delivery")
        print("[delivery] " + json.dumps(smoke.delivery_phase()), flush=True)

        phase = next_phase("service")
        print("[service] " + json.dumps(smoke.service_phase()), flush=True)

        phase = next_phase("surface")
        print("[surface] " + json.dumps(smoke.surface_phase()), flush=True)

        phase = next_phase("recovery")
        print("[recovery] " + json.dumps(smoke.recovery_phase()), flush=True)

        phase = next_phase("linear")
        smoke.linear_phase()

        phase = next_phase("kmeans")
        smoke.kmeans_phase()

        phase = next_phase("attention")
        smoke.attention_phase()

        phase = next_phase("durable")
        smoke.durable_phase()

        phase = next_phase("report")
        report = run_ranks(_report_rank, 1, args.rows)[0]
        for k, v in json.loads(str(report["report"])).items():
            setattr(smoke, k, v)

        phase = next_phase("trace")
        smoke.trace_phase(args.trace_dir)
        next_phase("")
        print("[phases] " + json.dumps({**{k: round(v, 1) for k, v in took.items()},
                                         "total": round(sum(took.values()), 1)}))
        print(json.dumps(smoke.kernels_line()))
    except PhaseFailed as e:
        print(f"FAIL [{phase}]: {e}", file=sys.stderr)
        return 1
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
