"""Smoke run of spamtree_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

1. the card (nvidia-smi name and power limit) and the software versions;
   exits non-zero at once when CUDA is absent;
2. builds the kernels with nvcc for sm_90a, one nvcc per source, started
   together: K1 (csrc/inv_chol.cu), K3/K4 (csrc/thin_level.cu) and K6
   (csrc/ag10_cov.cu); prints
   each kernel's registers, shared memory and spills;
3. holds K1 against its plain PyTorch version at config 3's, config 5's,
   the trivariate and the q = 5 configuration's reference-level shapes (B
   up to 16384 at S = 25; S 70-75 and the 96-thread form's ends 65 and 96,
   and the 128-thread form at S 112-121 and its ends 97 and 128, in f32
   only, double stopping at 64) and more, f32 and f64, with and without
   L, each batch also with one non-SPD block that must come out ok=False;
   times both at the config-3 shapes, Linv alone (K1) and with L (the
   TPU's K2), and K1 at the trivariate and the q = 5 shapes; then holds
   K6 (csrc/ag10_cov.cu, the masked AG10 covariance blocks) against its
   plain version at every call shape of a sweep of config 3 (with and
   without four chains, f32 and f64) and of the q = 5, the trivariate and
   the climate configuration (f32), Kxc masked and Kcc identity-padded,
   and times both at those shapes;
4. runs spamtree(device="cuda") on bench config 1 (n=625) at keep=500,
   burn=500, thin=2 (the always-emit theta step; the bench's keep=1000,
   burn=1000 cut to keep the whole run near half its time limit);
5. runs config 3 (n=1e5, bivariate AG10) with burn=200, keep=100, thin=2.
   Both runs must give finite draws, RMSPE < 0.5 sd(y) on the held-out rows,
   acceptance in (0.05, 0.8), K1 launched twice per iteration on every
   reference level with S <= 128 (K1's float32 limit, ``chol.MAX_S``), and
   every covariance block on K6 (every path through ``run_config``);
6. holds K3 (thin_gibbs) and K4 (thin_decision) against their plain
   versions, f32 and f64, at config 3's thin level (aligned), config 1's
   (through lp_pos, repeated and shuffled parents, Bp != B), config 5's
   four thin levels through lp_pos on its 16384 parents, P=128 and P=384
   (the TPU's K5 layouts) and the gate's edge (S=512, P=1024), each with
   a partly masked block, with and without a block forced to r <= 0 that
   both versions must flag ok=False; times both at config 3's shape,
   K4 also at P=128 and P=384 with config 3's B (K5's layouts), and times
   the cuBLAS product LAi Kxc alone at config 3's shape, the yardstick of
   K4's product.  K3 also at config 5's four thin levels, wpar gathered
   through lp_pos from 16384 parents, and at one shape per variant of the
   kernel (its launcher picks a variant from S, P and the type; the variant
   is printed), each run twice to the same bits; K1, K3 and K4 are timed at
   config 5's shapes too, K3 and K4 over rotating inputs larger than the
   L2 cache, K3 also in f64 where its two rows capacities serve;
7. the accept-aware theta step (MCMCConfig(accept_aware=True)) with the
   fused level kernels on (SPAMTREE_LEVEL_KERNELS=1): config 1 (keep=250,
   burn=250, thin=2), config 3 with composed factor parts on (the default)
   and off (burn=200, keep=100, thin=2), and config 1 on the limited tree
   (keep=200, burn=200, thin=1).  Each must meet phase 5's checks, launch
   K3 on every thin level of every iteration, and K4 on every thin level
   whose parent hands it an assembled joint (none when every thin level's
   parent composes);
8. config 5 (n=1e6, bivariate, imbalanced margins, limited tree, chunk=50)
   at keep=100, burn=150, thin=1 (half its own keep=200, burn=300, to keep
   the whole run inside its time limit): the accept-aware step with the
   level kernels through prepare_fit / run_mcmc, then the always-emit step
   through spamtree() with the pipelined drain.  Every level must run in
   one chunk; K3 launches on each of the four thin levels of every
   iteration, K4 and K1 launch; the record line carries every level's (B,
   S, P).  The kernels record takes its launch counts from the
   accept-aware run, and its ms, bound and max_abs_err from the checks and
   timings at this run's level shapes; config 3's stand beside them as
   *_config3;
9. config 5 with collect="summary", summary_draws=20 (always-emit): 100
   draws summed on the device, 20 kept; phase 5's checks on yhat_mean;
10. config 5 with checkpoint_path (keep=50: the sequential drain, a save
   after every chunk), then resume_from with keep=100: the counts resumed
   exact, 50 more draws, RMSPE over both runs' draws; then config 1 on
   whether two uninterrupted runs give the same bits, and if they do a
   resumed run held bit for bit against an uninterrupted one (w, beta,
   tausq, theta), else the same in a subprocess under
   torch.use_deterministic_algorithms(True) (``--resume-bits``).  Each
   config-5 run's mcmc_time is printed split into iterations, saves and
   drains;
11. predict_recompute held against predict at phase 8's accept-aware
   model and final state, the same z (f32 tolerance); spamtree_predict on
   phase 8's always-emit fit at 10^4 held-out rows' coordinates, 50 draws:
   RMSPE < 0.5 sd(y), agreement with the fit's own prediction at those
   rows within tests/test_predict_new.py's envelope, K1 launched once per
   reference level that _joints_upto factors per draw (one on a limited
   tree).  Each of phases 8-15 reads the kernels' counts
   (``ops.kernel_counts``) over its run; K1 must launch in each;
12. bench config 2 (n=1e4, univariate, deep tree) at keep=250, burn=250,
   thin=2 (half its own keep=500, burn=500, for the time limit), the
   always-emit step: phase 5's checks, and RMSPE within 15 % of the JAX
   package's on the same data (JAX_RMSPE);
13. bench config 4 (n=6e4, q=3, imbalanced misaligned margins,
   mvbias=1.0) at keep=150, burn=250, thin=2 (half its own keep=300,
   burn=500), always-emit: the same;
14. config 4 with the accept-aware step, the level kernels on and no
   composed factor parts: K3 and K4 are first held against their plain
   versions, f32 and f64, at the model's own thin levels through its own
   lp_pos (K3's variant printed per shape), then the run must meet phase
   7's and 12's checks and launch K3 and K4 on every thin level of every
   iteration; after it K1, K3 and K4 are timed at its level shapes;
15. the oracle chain: tests/test_torch_oracle.py's univariate_parity, the
   port's float64 chain on the card against the dense NumPy oracle of the
   reference sampler on the host, with the assertions of
   tests/test_reference_oracle.py::test_posterior_parity_vs_dense_oracle;
   K1 must launch (in float64);
16. chains: K1 first held against its plain version at the batched
   chains' shapes -- config 3's and config 5's reference levels at C = 4
   built as contiguous (C, B, S, S) batches and folded to (C*B, S, S)
   views, (65536, 25) included, f32 and f64, one non-SPD block in one
   chain's slice that alone must come out ok=False -- and timed there
   against its bound; then configs 1 (keep=150, burn=150, thin=2: 600
   iterations) and 3 (keep=100, burn=200, thin=2) through
   spamtree(n_chains=C) at C = 1, 2 and 4, the always-emit step (C > 1:
   the batched step, every chain's accept resolved on the device).  Each
   chain must give finite draws, RMSPE < 0.5 sd(y) and acceptance in
   (0.05, 0.8), theta_rhat must be finite, and K1's launches must be the
   same at every C (one launch per level for all chains); each run prints
   its aggregate chain-iterations per second, ms per iteration, K1
   launches per iteration and peak memory.  Last, whether two batched
   runs of config 1 at C = 2 give the same bits (printed, not checked),
   after utils.diagnostics.time_phases' table at config 3 for one chain
   and for four;
17. multi-device sampling on the one card: (a) config 3 (keep=25,
   burn=50, thin=2) through spamtree(mesh=...) on a one-rank NCCL mesh,
   graphed (the default there), beside the same run in one process in
   the same worker, both under torch.use_deterministic_algorithms: the
   same bits; then on that rank config 3 prepared on the mesh and alone,
   and on both theta steps (accept-aware with the level kernels) the
   mesh's chain eager and graphed at phase 19's depth (60 iterations) from
   the same seeds (accept-aware without composed factor parts, so K4
   launches too), graphed once more under deterministic algorithms, and
   the one process's graphed chain: all the same bits, the same K1/K3/K4
   launches per iteration, 2-4 graph replays an iteration; then windows
   of phase 19's kind from one seed, the mesh graphed and eager and the
   one process graphed, each printing ms/it, busy ms/it, idle share,
   replays and nodes per iteration and the NCCL kernels in the trace
   (none on one rank: a one-rank NCCL communicator copies, see
   --probe-nccl), and the all-gathers per iteration that the eager window
   calls must be those the graphed one replays from its graphs; the
   capture's seconds and each path's peak memory; then config 1
   (keep=25, burn=25, thin=2) through spamtree(devices=["cuda:0"])
   against the same run in this process, with graph replays;
   (b) two gloo ranks on the card,
   a (1, 2) blocks mesh: first 4 always-emit and 4 accept-aware steps of
   config 3 (level kernels on, no composed factor parts; a narrow
   proposal, RAM adaptation off and every accept draw 0, so every
   proposal installs and no accept decision can fall inside the
   rounding) held step by step against the unsharded steps from the same
   start and draws (w, theta, logdet, and every level's H and prec after
   the last: f32 tolerance), each rank launching K1, K3 and K4 on its
   shards; then config 1 at phase 16's depth and config 3 at phase 5's,
   held to those phases' one-process runs, and config 3 in float64
   (keep=25, burn=50, thin=2) held to the same run in one process in the
   worker; (c) two gloo ranks, a (2, 1) chains mesh: config 3 (keep=25,
   burn=50, thin=2) with n_chains=2 under deterministic algorithms, each
   rank's chain held to that chain run alone in one process
   (run_mcmc_chains with its generator, the same batched numerics): the
   same bits.  Every run meets phase 5's checks (per chain, theta_rhat
   finite), each rank launches K1 on every reference level of every
   iteration, and the draws agree with the one-process run's within f32
   tolerance (the w draws cross as float16).  The one exception is (b)'s
   f32 config-3 run: the blocks mesh adds messages, logdet and quadratic
   forms in another order, so an accept decision inside the f32 rounding
   of log p can part the chains (the float64 run, where the rounding is
   2^-29 as small, must not part); where it parts, the gap between the
   theta means must be within 6 x the spread between the chain means of
   phase 16's four-chain run, and each chain's held-out RMSPE within 5 %
   of the one process's.  Each mesh run prints its ms per iteration,
   chain-iterations per second, each rank's peak memory, and a window of
   5 steps per rank (host ms per iteration, device-busy ms under
   torch.profiler, idle share; deterministic algorithms off) beside the
   one process's.  Over gloo on one card these times say what a second
   process costs, not what NVLink would give.  The gloo runs ((b), (c))
   run eager, as graphs=None resolves there, and each prints so;
   graphs=True on a gloo rank must raise the error that names gloo's
   host staging;
18. the accept-aware step under a chain axis: K4 first held against its
   plain version as thin_decision_chains runs it, one launch over C = 4
   chains' blocks folded into one batch (parents through c * Bp +
   lp_pos), f32 and f64, at config 3's thin level (4 x (1024, 68, 293),
   aligned), config 4's (4 x (1024, 42, 150) through lp_pos on 1024
   parents) and config 5's four (through lp_pos on 4 x 16384 parents),
   one chain with a failing block that alone must come out ok=False, and
   timed there against its bound (eager and graph-replay device ms); then
   run_mcmc_chains with MCMCConfig(accept_aware=True) and the level
   kernels on: config 3 at C = 2 and 4 with composed factor parts on and
   off (off: K4 runs) at keep=50, burn=100, thin=2 (half phase 16's
   depth, for the time limit), config 4 at C = 2 with them off at phase
   16's depth.  Each chain meets phase 5's checks, theta_rhat is finite,
   K1 launches three times per reference level per iteration (w-Gibbs,
   the decision sweep, the rebuild, which the batched step runs for every
   chain) at every C, K4 once per thin level it serves per iteration at
   every C (one fold for all chains), K3 never (chains carry no Gram
   blocks); each run prints chain-it/s, ms/it, K1 and K4 launches per
   iteration and peak memory beside the always-emit batched run at the
   same C: phase 16's at config 3, one run here at config 4's depth;
19. the iteration as replayed CUDA graphs, which every run above but the
   gloo mesh runs already uses (run_mcmc's and run_mcmc_chains' default
   on the card, alone or on an NCCL mesh): configs 1, 3 and 5, one
   chain, always-emit and accept-aware with the level kernels on, and
   config 3's batched chains at C = 2 and 4 on
   both steps, each run eager (graphs=False) and graphed from one prepared
   chain and the same generator seeds at keep=20, burn=10 (rounded to 20),
   thin=2 (60 iterations): the kept draws, the final state and the
   acceptance must be the same bits, each kernel's launches per iteration
   the same on both paths, one chain 2-4 graph replays an iteration and
   the chains one; at config 3's single always-emit chain two eager runs
   must give the same bits too (the messages are summed in a fixed
   order).  Each case prints, for both paths, ms/it and busy ms/it over a
   window of 10 iterations (traced with torch.profiler), idle share,
   kernels (graph kernel nodes) and replays per iteration, the capture's
   seconds and the peak device memory of the run, and one chain's install
   (graph I replayed alone) in device ms beside the bytes it copies and
   the device ms of those copies alone.  Then config 3's
   always-emit chain alone and at C = 2, and config 5's limited tree on
   both steps (accept-aware with the level kernels), graphed once more
   under torch.use_deterministic_algorithms (CUBLAS_WORKSPACE_CONFIG set),
   which must give the bits of the default graphed run and of the eager
   run and the same launches, with its own window; config 3's and config 5's
   always-emit chains graphed with the carry copied and donated
   (run_mcmc(donate=True)): the same bits, the carried state's bytes and
   each run's peak memory above its start; config 1 with the reference
   warmup past a burn of 20, whose capture falls inside the keep loop:
   the drain stays pipelined and the run has the bits of a checkpointed
   (sequential) run and of the eager one;
20. spamtree_predict's draws as replayed CUDA graphs: phase 8's config-5
   fit at phase 11's 10^4 held-out rows (50 draws) and phase 5's config-3
   fit, a full tree, at 2000 held-out rows (20 draws), each staged once
   (api.stage_predict) and drawn through model.predict.DrawRunner eager
   and graphed with the same seed: the same w_pred bits and the same K1
   launches per draw (one per reference level that _joints_upto factors)
   on both paths, and the graphed draws once more under
   torch.use_deterministic_algorithms with the same bits and launches;
   each prints ms/draw of the run, then ms/draw and busy ms/draw over a
   window of 10 more draws (traced with torch.profiler), idle share, the
   capture's seconds and the peak memory above the run's start;
21. the port's benchmark entry: ``python -m spamtree_tpu_torch.bench``
   in a subprocess at config 1 and config 3, each at bench.py's own depth
   (config 1 keep=1000, burn=1000, thin=2; config 3 keep=500, burn=1000,
   thin=2), one repeat: its JSON line must parse with bench.py's keys,
   RMSPE < 0.5 sd(y), acceptance in (0.05, 0.8), tflops_per_sec > 0 and
   bandwidth_util in (0, 1.05], and K1 must launch; config 1's work count
   of each part of the iteration on the card must equal the count of the
   same model staged on the CPU in f32 (``mcmc.part_work``).  The bench
   lines print in full;
22. K6 against its plain version at every distinct call that phases 4-20
   made in this process (``CovCalls``: by configuration, q, chains, shape,
   form and dtype; on the call's own coordinates, margins, masks and
   parameters where it was first made outside a graph's capture), and
   each distinct f32 call timed; configs 1-5 must all have made calls.

Kernel and plain times (the kernels record's ms and plain_ms) are CUDA
events around eager calls of the wrappers the sweeps call, host time
included; the device time of each, from a run of calls captured in a CUDA
graph and replayed, is printed beside them.  Every kernel's launch count
is set to 0 just before a run and read just after it (the timing phases
come before the runs or between them).  The line before the last is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --resume-bits

runs phase 10's config-1 check alone, under deterministic algorithms.

    python3 chip_smoke.py --chains

runs phases 1-2, 16 and 18 alone (~5 min).

    python3 chip_smoke.py --mesh

runs phases 1-2 and phase 17 alone, with its one-process runs (~6 min).

    python3 chip_smoke.py --graphs

runs phases 1-2, phase 19 and phase 20 alone (phase 20 after its own
config-5 and config-3 fits).

    python3 chip_smoke.py --probe-nccl

runs the probe of the mesh's collectives under capture, alone: on a
one-rank NCCL group, the list-form all_gather and the mesh's cat, sum
and AND (one all-gather into one tensor each) run eagerly, then
captured in a CUDA graph and replayed: whether each captures, the
replay's bits against the eager call's, and the device ops of both by
name.

    python3 chip_smoke.py --probe-writes

runs the probe that chose the row writes, alone: every candidate for
them at config 5's levels captured in a CUDA graph with deterministic
algorithms off and on -- index_put_, index_copy_ and scatter_ a level at
a time, put_rows once for all levels -- each held to index_put_'s bits,
with its device ms or the error of its capture; put_rows must capture in
both modes.

    python3 chip_smoke.py --times

runs phases 1-2 and the timings of phases 3 and 6 alone, at config 3's,
config 5's and the trivariate configuration's known levels, for comparing
two trees in one call (copy this script into the other tree and run it
there).

    python3 chip_smoke.py --cov

runs phases 1-2 and phase 3's check and timings of K6 alone (~1 min).

    python3 chip_smoke.py --bench

runs phases 1-2 and phase 21 alone.  Imports no jax; the data makers
are ``spamtree_tpu_torch.bench``'s, and the kernels' bounds their cost
functions (``ops.chol.inv_chol_cost``, ``ops.level.thin_gibbs_cost``,
``ops.level.thin_decision_cost``), which the fit's work count uses too.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# config-3 reference levels: (B, S) of each level's Cholesky batch
CONFIG3_SHAPES = [(1, 50), (4, 49), (16, 50), (64, 50), (256, 50), (1024, 47)]
CONFIG3_THIN = (1024, 68, 293)  # config 3's thin level (B, S, P)
# config 5: (B, S) of the reference levels, (B, S, P) of the thin levels,
# which all hang on the deepest reference level through lp_pos
CONFIG5_SHAPES = [(4 ** k, 25) for k in range(8)]
CONFIG5_THIN = [(6235, 23, 25), (5917, 29, 25), (3678, 37, 25), (554, 57, 25)]
# the trivariate configuration (benchmark triv_n1.5e5_ag10: three outcomes
# at each of config 3's sites): its reference levels, K1's 96-thread form
TRIV_SHAPES = [(1, 70), (4, 73), (16, 74), (64, 75), (256, 74), (1024, 70)]
# the q = 5 configuration's (q5_n2.5e5_ag10: five outcomes at each of
# config 3's sites): its reference levels, K1's 128-thread form
Q5_SHAPES = [(1, 112), (4, 119), (16, 121), (64, 120), (256, 121),
             (1024, 116)]
CHECK_SHAPES = (CONFIG3_SHAPES + CONFIG5_SHAPES + TRIV_SHAPES + Q5_SHAPES
                + [(1024, 64), (3, 7), (130, 33), (5, 65), (3, 96),
                   (3, 97), (2, 128)])
# kernel K6's calls (B, n1, n2, identity pad) in a sweep of config 3, of
# the q = 5, the trivariate and the climate configuration (the benchmark's
# cells), with their q: each reference level's Kcc and Kxc, the thin
# levels' and the prediction buckets' Kxc (a slab's B where a level runs
# in slabs).  The paths that run_config and the other phases take in this
# process are held at their own calls besides (``CovCalls``).
COV_CALLS = {
    "config3": (2, [(1, 46, 46, True), (4, 49, 49, True), (16, 50, 50, True),
                    (64, 50, 50, True), (256, 50, 50, True),
                    (1024, 47, 47, True), (4, 46, 49, False),
                    (16, 95, 50, False), (64, 145, 50, False),
                    (256, 195, 50, False), (1024, 245, 47, False),
                    (1024, 292, 70, False), (1024, 292, 23, False)]),
    "q5": (5, [(1, 110, 110, True), (4, 118, 118, True),
               (16, 119, 119, True), (64, 121, 121, True),
               (256, 122, 122, True), (344, 116, 116, True),
               (4, 110, 118, False), (16, 228, 119, False),
               (64, 347, 121, False), (256, 468, 122, False),
               (344, 590, 116, False), (256, 706, 182, False),
               (1032, 706, 47, False)]),
    "triv": (3, [(1, 67, 67, True), (4, 71, 71, True), (16, 73, 73, True),
                 (64, 74, 74, True), (256, 75, 75, True), (512, 69, 69, True),
                 (4, 67, 71, False), (16, 138, 73, False),
                 (64, 211, 74, False), (256, 285, 75, False),
                 (512, 360, 69, False), (512, 429, 103, False),
                 (1024, 429, 33, False)]),
    "climate": (2, [(4 ** k, 25, 25, True) for k in range(8)]
                + [(4 ** k, 25, 25, False) for k in range(1, 8)]
                + [(6159, 25, 23, False), (5958, 25, 29, False),
                   (3768, 25, 37, False), (499, 25, 55, False),
                   (7109, 25, 5, False), (6435, 25, 8, False),
                   (2350, 25, 11, False), (451, 25, 20, False)]),
}
# |K6 - plain| <= COV_RTOL * |plain|: the same IEEE operations in the same
# order and the same libm, so at most the libm's rounding of an exp
# (a few ulps) amplified by the exponent's size
COV_RTOL = {"float32": 4e-6, "float64": 1e-14}
# K3 once more per variant of its launcher (B, S, P): the flat variant at
# its gate's edges, both rows capacities, the tiled variant past them
K3_VARIANT_SHAPES = [(64, 48, 32), (64, 128, 12), (64, 1, 1), (64, 32, 128),
                     (64, 72, 320), (64, 73, 320), (64, 129, 3)]
# K3's timed shapes beside config 5's (the flat variant): config 3's (rows,
# the larger capacity), the smaller rows capacity at its edge and at config
# 1's thin level, and the tiled variant
K3_TIME_SHAPES = [CONFIG3_THIN, (1024, 32, 128), (16, 18, 69),
                  (1024, 73, 320)]
# the JAX package's held-out RMSPE and sd(y) at bench configs 2 and 4 on
# the same data (BENCH_RESULTS.md:61, :63); the port must come within 15 %
JAX_RMSPE = {2: (0.324, 1.53), 4: (0.369, 0.93)}
L2_BYTES = 50e6
TOL = {"float32": 1e-4, "float64": 1e-10}  # max|dLinv| <= TOL * max|Linv|
# the published H100 SXM peaks that bound a kernel: device memory rate and
# the FP32 rate outside the tensor cores (TF32 is barred by the package)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_FP64_S = 34e12
# K3 in float64, timed where its two rows capacities serve
K3_TIME_SHAPES_F64 = [(1024, 32, 128), CONFIG3_THIN]


_T0 = time.time()


_PHASE = [""]  # the phase running, which labels the K6 calls it makes


def _phase(name):
    _PHASE[0] = name
    print(f"== {name} (at {time.time() - _T0:.1f} s)", flush=True)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


@contextlib.contextmanager
def _env(**kv):
    """Set environment gates for a block and restore them after it."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _bound(nbytes, flops, peak_flops=PEAK_FP32_S):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over their type's rate (FP32 unless given)."""
    tb, tf = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * flops / peak_flops
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _event_times(torch, fns, reps):
    """CUDA-event ms per call of each of ``fns`` ({"kernel", "plain"}),
    in turns plain, kernel, kernel, plain; the minimum of each."""
    for f in fns.values():
        for _ in range(3):
            f()
    times = {k: [] for k in fns}
    for name in ("plain", "kernel", "kernel", "plain"):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fns[name]()
        e1.record()
        torch.cuda.synchronize()
        times[name].append(e0.elapsed_time(e1) / reps)
    return min(times["kernel"]), min(times["plain"])


def _graph_ms(torch, f, reps):
    """Device ms per call of ``f``: ``reps`` calls captured in one CUDA
    graph, replayed twice between CUDA events, the faster replay; the
    host's launch overhead drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            f()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            f()
    times = []
    for _ in range(2):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return min(times)


def card_info(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)


def build_kernels(chol, level, _build, torch):
    from spamtree_tpu_torch.ops import covariance

    t0 = time.time()
    with ThreadPoolExecutor(3) as ex:  # one nvcc per source, together
        list(ex.map(_build.load, ("inv_chol", "thin_level", "ag10_cov")))
    for dt in (torch.float32, torch.float64):
        chol._kernel(dt)
        level._kernel("thin_gibbs", dt)
        level._kernel("thin_decision", dt)
        covariance._kernel(dt)
    print(f"K1, K3, K4, K6 built/loaded in {time.time() - t0:.2f} s")
    for name, (secs, log) in _build.BUILD_LOG.items():
        print(f"nvcc {name}: {secs:.2f} s")
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "smem")):
                print(f"  {line.strip()}")


def _spd_batch(torch, B, S, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    M = torch.randn(B, S, S, generator=g, device="cuda", dtype=dtype)
    eye = torch.eye(S, device="cuda", dtype=dtype)
    return M @ M.mT + S * eye


def check_kernel(chol, torch):
    """K1 against inv_chol_plain; returns the largest f32 |dLinv| at
    config 5's, config 3's, the trivariate and the q = 5 reference-level
    shapes."""
    paths = {"config5": CONFIG5_SHAPES, "config3": CONFIG3_SHAPES,
             "triv": TRIV_SHAPES, "q5": Q5_SHAPES}
    max_err32 = {k: 0.0 for k in paths}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for B, S in CHECK_SHAPES:
            if S > chol.max_s(dtype):  # the callers take the plain route
                print(f"K1 {dname} B={B} S={S}: past the kernel's "
                      f"{dname} limit {chol.max_s(dtype)}, not run")
                continue
            for corrupt in (False, True):
                A = _spd_batch(torch, B, S, dtype, seed=B * 100 + S)
                good = torch.ones(B, dtype=torch.bool, device="cuda")
                if corrupt:  # one indefinite block
                    A[B // 2, 0, 1] = A[B // 2, 1, 0] = 10.0 * S
                    good[B // 2] = False
                linv_alone = chol.inv_chol(A)
                for write_l in (False, True):
                    out_k = chol.inv_chol(A, write_l=write_l)
                    out_p = chol.inv_chol_plain(A, write_l=write_l)
                    torch.cuda.synchronize()
                    linv = out_k[1] if write_l else out_k
                    _check(torch.equal(linv.isnan(), linv_alone.isnan())
                           and torch.equal(linv.nan_to_num(),
                                           linv_alone.nan_to_num()),
                           f"K1 Linv not bit-identical with and without L "
                           f"(or between calls): {dname} B={B} S={S} "
                           f"write_l={write_l}")
                    pairs = ([("L", out_k[0], out_p[0]),
                              ("Linv", out_k[1], out_p[1])] if write_l
                             else [("Linv", out_k, out_p)])
                    for what, k, p in pairs:
                        for x in (k, p):
                            d = torch.diagonal(x, dim1=-2, dim2=-1)
                            ok = torch.all(torch.isfinite(d) & (d > 0), dim=-1)
                            _check(torch.equal(ok, good),
                                   f"ok flags: {dname} B={B} S={S} {what}")
                        if not bool(good.any()):
                            continue
                        err = float((k[good] - p[good]).abs().max())
                        scale = float(p[good].abs().max())
                        _check(err <= TOL[dname] * scale,
                               f"K1 {what} disagrees: {dname} B={B} S={S} "
                               f"write_l={write_l} err={err} scale={scale}")
                        if dname == "float32" and what == "Linv":
                            for k, shapes in paths.items():
                                if (B, S) in shapes:
                                    max_err32[k] = max(max_err32[k], err)
            print(f"K1 ok {dname} B={B} S={S}", flush=True)
    print("K1 max |dLinv| f32 at " + ", ".join(
        f"{k}'s shapes: {v:.3e}" for k, v in max_err32.items()))
    return max_err32


def time_kernel(chol, torch, write_l=False, reps=50, shapes=CONFIG3_SHAPES,
                label="config-3"):
    """CUDA-event ms per eager call, kernel and plain, at ``shapes`` (a
    configuration's reference levels; f32), alternating plain, kernel,
    kernel, plain; with each shape's bound (A read once, Linv written once,
    and L with ``write_l``; S^3/3 flops for the factor and as many for its
    inverse) and the device ms of both in a CUDA graph."""
    rows = []
    name = "K2 (K1 with L)" if write_l else "K1"
    for B, S in shapes:
        A = _spd_batch(torch, B, S, torch.float32, seed=7)
        fns = {"kernel": lambda: chol.inv_chol(A, write_l=write_l),
               "plain": lambda: chol.inv_chol_plain(A, write_l=write_l)}
        k, p = _event_times(torch, fns, reps)
        gk, gp = (_graph_ms(torch, fns[n], reps) for n in ("kernel", "plain"))
        flops, nbytes = chol.inv_chol_cost(B, S, write_l, torch.float32)
        bound = _bound(nbytes, flops)
        rows.append((B, S, k, p, bound, gk, gp))
        print(f"{name} time B={B} S={S}: kernel {k:.4f} ms, plain {p:.4f} ms,"
              f" bound {bound[0]:.4f} ms ({bound[1]}); device time in a "
              f"CUDA graph: kernel {gk:.4f} ms, plain {gp:.4f} ms")
    print(f"{name} time summed over the {label} shapes: kernel "
          f"{sum(r[2] for r in rows):.4f} ms, plain "
          f"{sum(r[3] for r in rows):.4f} ms, bound "
          f"{sum(r[4][0] for r in rows):.4f} ms; device time in a CUDA "
          f"graph: kernel {sum(r[5] for r in rows):.4f} ms, plain "
          f"{sum(r[6] for r in rows):.4f} ms")
    return rows


def _cov_inputs(torch, cv, q, B, n1, n2, dtype, seed, C=None):
    """Seeded arguments of one K6 call on the card: coordinates in the unit
    square, margins, masks with a padded tail in each block, and the AG10
    parameters of ``C`` chains (None: no chain axis)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    spec = cv.make_cov_model(2, q)
    nt = spec.npars + spec.k
    theta = torch.rand((nt,) if C is None else (C, nt), generator=g,
                       device="cuda", dtype=torch.float64) * 1.7 + 0.3
    if q > 2:
        theta[..., 3 * q + 1] = 0.4  # beta_psi1 in (0, 1)

    def mask(n):
        keep = torch.randint(1, n + 1, (B, 1), generator=g, device="cuda")
        return torch.arange(n, device="cuda")[None, :] < keep

    coords = lambda n: torch.rand(B, n, 2, generator=g, device="cuda",
                                  dtype=torch.float64).to(dtype)
    ids = lambda n: torch.randint(0, q, (B, n), generator=g, device="cuda")
    return dict(cx1=coords(n1), mv1=ids(n1), cx2=coords(n2), mv2=ids(n2),
                m1=mask(n1), m2=mask(n2),
                params=cv.unpack_theta(theta.to(dtype), spec), spec=spec)


def _cov_fns(cv, d, eye):
    """{"kernel", "plain"}: the K6 call and its plain version on ``d``."""
    if eye:
        a = (d["cx1"], d["mv1"], d["cx1"], d["mv1"], d["params"], d["spec"],
             d["m1"])
        kw = dict(eye=True)
    else:
        a = (d["cx1"], d["mv1"], d["cx2"], d["mv2"], d["params"], d["spec"],
             d["m1"], d["m2"])
        kw = {}
    return {"kernel": lambda: cv.cov_block(*a, **kw),
            "plain": lambda: cv.cov_block_plain(*a, **kw)}


def check_cov_kernel(torch, times=True):
    """K6 against cov_block_plain at ``COV_CALLS`` (config 3 also with
    four chains and in f64); with ``times``, CUDA-event ms of eager calls,
    kernel and plain, and the device ms of both in a CUDA graph, at each
    f32 call of one chain, beside the call's bound (``cov_block_cost``).
    Returns {label: dict(ms, plain_ms, dev_ms, plain_dev_ms, bound_ms,
    max_rel_err, bit_equal, calls)}, times summed over the label's calls."""
    from spamtree_tpu_torch.ops import covariance as cv
    from spamtree_tpu_torch.ops import kernel_counts

    out = {}
    for label, (q, calls) in COV_CALLS.items():
        tot = dict(ms=0.0, plain_ms=0.0, dev_ms=0.0, plain_dev_ms=0.0,
                   bound_ms=0.0, max_rel_err=0.0, bit_equal=0, calls=0)
        cases = [("float32", None), ("float64", None), ("float32", 4)]
        for dname, C in cases if label == "config3" else cases[:1]:
            dtype = getattr(torch, dname)
            for i, (B, n1, n2, eye) in enumerate(calls):
                d = _cov_inputs(torch, cv, q, B, n1, n2, dtype, seed=i, C=C)
                fns = _cov_fns(cv, d, eye)
                before = kernel_counts.snapshot()
                k = fns["kernel"]()
                _check(kernel_counts.diff(before)["cov_launches"] == 1,
                       f"K6 {label} {(B, n1, n2)}: not one launch")
                p = fns["plain"]()
                torch.cuda.synchronize()
                _check(k.shape == p.shape and k.is_contiguous()
                       and torch.equal(k.isnan(), p.isnan())
                       and torch.equal(k == 0, p == 0),
                       f"K6 {label} {dname} C={C} {(B, n1, n2, eye)}: "
                       f"shape, NaNs or zeros differ from plain")
                rel = float(((k - p).abs() / p.abs().clamp_min(1e-300))
                            .nan_to_num().max())
                _check(rel <= COV_RTOL[dname],
                       f"K6 {label} {dname} C={C} {(B, n1, n2, eye)}: "
                       f"relative error {rel}")
                tot["max_rel_err"] = max(tot["max_rel_err"], rel)
                tot["bit_equal"] += int(torch.equal(k.nan_to_num(),
                                                    p.nan_to_num()))
                tot["calls"] += 1
                del k, p
                if not times or dname != "float32" or C is not None:
                    continue
                km, pm = _event_times(torch, fns, 10)
                gk = _graph_ms(torch, fns["kernel"], 10)
                gp = _graph_ms(torch, fns["plain"], 5)
                flops, nb = cv.cov_block_cost(1, B, n1, n2, q, 2,
                                              1 if eye else 2, dtype)
                bound = _bound(nb, flops)
                for key, v in (("ms", km), ("plain_ms", pm), ("dev_ms", gk),
                               ("plain_dev_ms", gp), ("bound_ms", bound[0])):
                    tot[key] += v
                print(f"K6 time {label} B={B} n1={n1} n2={n2} eye={eye}: "
                      f"kernel {km:.4f} ms, plain {pm:.4f} ms, bound "
                      f"{bound[0]:.4f} ms ({bound[1]}); device time in a "
                      f"CUDA graph: kernel {gk:.4f} ms, plain {gp:.4f} ms",
                      flush=True)
        print(f"K6 {label}: {tot['calls']} calls held against plain, "
              f"{tot['bit_equal']} to the bit, max relative error "
              f"{tot['max_rel_err']:.3e}; one sweep's calls summed (f32): "
              f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
              f"bound {tot['bound_ms']:.4f} ms; device time in a CUDA "
              f"graph: kernel {tot['dev_ms']:.4f} ms, plain "
              f"{tot['plain_dev_ms']:.4f} ms", flush=True)
        out[label] = tot
    return out


def _cov_label(phase):
    """The configuration a phase runs ("config<N>"), else the phase's
    first words."""
    m = re.search(r"config (\d)", phase)
    if m:
        return f"config{m.group(1)}"
    return re.sub(r"\W+", "_", phase.split(":")[0].split(",")[0]).strip("_")


class CovCalls:
    """The calls of kernel K6 that the paths make in this process, recorded
    while they run: installed, it wraps ``model.core.cov_block`` and keys
    each call by (label, q, chains, B, n1, n2, eye, dtype), the label
    being the configuration of the phase that made it (``_cov_label``).
    The first call of each key outside a CUDA graph's capture and a cost
    counter keeps a copy of its arguments, to be held against plain after
    the paths ran (``check_recorded_cov``); a key seen only inside a
    capture is held on seeded arguments of its shape.  Runs in other
    processes (the mesh ranks, the bench entry) are not recorded."""

    COPY_BYTES = 1 << 30  # copies kept in all, then shapes alone

    def __init__(self, torch):
        import inspect

        from spamtree_tpu_torch.model import core
        from spamtree_tpu_torch.utils import cost

        self.torch, self.core, self.cost = torch, core, cost
        self.fn = core.cov_block
        self.sig = inspect.signature(self.fn)
        self.calls = {}  # key -> copied arguments, or None
        self.copied = 0

    def install(self):
        self.core.cov_block = self
        return self

    def remove(self):
        self.core.cov_block = self.fn

    def __call__(self, *a, **kw):
        torch = self.torch
        x = self.sig.bind(*a, **kw)
        x.apply_defaults()
        x = x.arguments
        cx1, p = x["cx1"], x["params"]
        key = (_cov_label(_PHASE[0]), x["spec"].q,
               tuple(p.ai1.shape[:-1]), tuple(cx1.shape[:-2]),
               cx1.shape[-2], x["cx2"].shape[-2], bool(x["eye"]),
               str(cx1.dtype).split(".")[-1])
        if self.calls.get(key) is None:
            self.calls[key] = None
            names = ("cx1", "mv1", "cx2", "mv2", "m1", "m2")
            size = sum(x[n].nbytes for n in names if x[n] is not None)
            if (cx1.is_cuda and self.cost.active() is None
                    and not torch.cuda.is_current_stream_capturing()
                    and self.copied + size <= self.COPY_BYTES):
                d = {n: None if x[n] is None else x[n].clone() for n in names}
                d.update(params=type(p)(*(t.clone() for t in p)),
                         spec=x["spec"], eye=x["eye"], cov=x["cov"])
                self.calls[key] = d
                self.copied += size
        return self.fn(*a, **kw)


def check_recorded_cov(torch, rec):
    """K6 against cov_block_plain at every call ``rec`` recorded, on the
    call's own arguments where it kept them; each distinct f32 shape timed
    once (eager and graph-replayed, beside its bound).  Returns {label:
    dict(calls, real, bit_equal, max_rel_err, ms, plain_ms, dev_ms,
    plain_dev_ms, bound_ms)}, times summed over the label's distinct f32
    calls."""
    from spamtree_tpu_torch.ops import covariance as cv
    from spamtree_tpu_torch.ops import kernel_counts

    torch.cuda.synchronize()
    out, timed = {}, {}
    for i, (key, d) in enumerate(sorted(rec.calls.items(),
                                        key=lambda kv: kv[0])):
        label, q, chains, lead, n1, n2, eye, dname = key
        dtype = getattr(torch, dname)
        B = int(np.prod(lead))
        if d is None:
            d = _cov_inputs(torch, cv, q, B, n1, n2, dtype, seed=i,
                            C=chains[0] if chains else None)
            d.update(eye=eye, cov=cv.pairwise_cov)
            if eye:
                d.update(cx2=d["cx1"], mv2=d["mv1"], m2=None)
        _check(d["cov"] is cv.pairwise_cov,
               f"K6 {key}: the path handed another formula")
        a = (d["cx1"], d["mv1"], d["cx2"], d["mv2"], d["params"], d["spec"],
             d["m1"], d["m2"])
        fns = {"kernel": lambda: cv.cov_block(*a, eye=eye),
               "plain": lambda: cv.cov_block_plain(*a, eye=eye)}
        before = kernel_counts.snapshot()
        k = fns["kernel"]()
        _check(kernel_counts.diff(before)["cov_launches"] == 1,
               f"K6 {key}: not one launch")
        pl = fns["plain"]()
        torch.cuda.synchronize()
        _check(k.shape == pl.shape and k.is_contiguous()
               and torch.equal(k.isnan(), pl.isnan())
               and torch.equal(k == 0, pl == 0),
               f"K6 {key}: shape, NaNs or zeros differ from plain")
        rel = float(((k - pl).abs() / pl.abs().clamp_min(1e-300))
                    .nan_to_num().max())
        _check(rel <= COV_RTOL[dname], f"K6 {key}: relative error {rel}")
        t = out.setdefault(label, dict(calls=0, real=0, bit_equal=0,
                                       max_rel_err=0.0, ms=0.0, plain_ms=0.0,
                                       dev_ms=0.0, plain_dev_ms=0.0,
                                       bound_ms=0.0))
        t["calls"] += 1
        t["real"] += int(rec.calls[key] is not None)
        t["bit_equal"] += int(torch.equal(k.nan_to_num(), pl.nan_to_num()))
        t["max_rel_err"] = max(t["max_rel_err"], rel)
        del k, pl
        if dname != "float32":
            continue
        shape = key[1:]
        if shape not in timed:
            km, pm = _event_times(torch, fns, 5)
            gk = _graph_ms(torch, fns["kernel"], 5)
            gp = _graph_ms(torch, fns["plain"], 3)
            C = chains[0] if chains else 1
            flops, nb = cv.cov_block_cost(C, B, n1, n2, q, d["cx1"].shape[-1],
                                          1 if eye else 2, dtype)
            timed[shape] = (km, pm, gk, gp, _bound(nb, flops)[0])
        for name, v in zip(("ms", "plain_ms", "dev_ms", "plain_dev_ms",
                            "bound_ms"), timed[shape]):
            t[name] += v
    for label, t in sorted(out.items()):
        print(f"K6 at the paths' calls, {label}: {t['calls']} distinct "
              f"calls ({t['real']} on their own arguments) held against "
              f"plain, {t['bit_equal']} to the bit, max relative error "
              f"{t['max_rel_err']:.3e}; the distinct f32 calls summed: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms; device time in a CUDA graph: "
              f"kernel {t['dev_ms']:.4f} ms, plain {t['plain_dev_ms']:.4f} "
              f"ms", flush=True)
    return out


def _level_shapes(levels):
    """[(B, S, P)] of a list of LevelArrays."""
    return [tuple(lv.rows.shape) + (lv.prows.shape[1],) for lv in levels]


_DATA: dict = {}


def _data(bench, cfg_id):
    """A bench configuration's data, made once per process."""
    if cfg_id not in _DATA:
        _DATA[cfg_id] = bench.CONFIGS[cfg_id]["maker"]()
    return _DATA[cfg_id]


def run_config(bench, chol, torch, cfg_id, keep, burn, thin,
               chunk=200, limited=False, settings=None, draws=None, **kw):
    """The always-emit theta step through spamtree(); ``settings`` over
    dict(chunk=chunk), ``kw`` to spamtree (checkpoint_path, resume_from).
    Checks the run (``draws`` kept w draws, default keep; with
    collect="summary" yhat_mean stands in for the draws' mean) and returns
    (record, thin levels (B, S, P), the fit)."""
    import spamtree_tpu_torch
    from spamtree_tpu_torch.ops import kernel_counts

    c = bench.CONFIGS[cfg_id]
    y, y_full, miss, X, coords, mv = _data(bench, cfg_id)
    ybar = np.nanmean(y)
    settings = dict(chunk=chunk) | (settings or {})
    summary = settings.get("collect") == "summary"
    torch.cuda.reset_peak_memory_stats()
    start = kernel_counts.snapshot()
    t0 = time.time()
    out = spamtree_tpu_torch.spamtree(
        y - ybar, X, coords, mv_id=mv, cell_size=25,
        mcmc=dict(keep=keep, burn=burn, thin=thin),
        settings=settings, seed=1, device="cuda",
        limited_tree=limited, **kw)
    wall = time.time() - t0
    counts = kernel_counts.diff(start)
    launches = counts["k1_launches"]
    n_kept = out["theta_mcmc"].shape[1]
    iters = out["burn_actual"] + n_kept * thin
    order = out["order"]
    y_post = (out["yhat_mean"] if summary
              else out["yhat_mcmc"].mean(axis=0)) + ybar
    mo = miss[order]
    rmspe = float(np.sqrt(np.mean((y_post[mo] - y_full[order][mo]) ** 2)))
    sd = float(np.nanstd(y_full))
    n_ref = sum(1 for p in out["schedule"].levels
                if p.is_ref and p.S <= chol.MAX_S)
    res = dict(config=c["name"], step="always_emit", limited_tree=limited,
               collect=settings.get("collect", "all"),
               checkpoint="checkpoint_path" in kw,
               resumed_at=out["resumed_at_iteration"], n=len(y), iters=iters,
               ips=iters / out["mcmc_time"], mcmc_time=out["mcmc_time"],
               iter_s=out["iter_s"], save_s=out["save_s"],
               drain_s=out["mcmc_time"] - out["iter_s"] - out["save_s"],
               drain_work_s=out["drain_work_s"],
               setup_time=wall - out["mcmc_time"], rmspe=rmspe, sd_y=sd,
               accept=out["accept_ratio"], **counts, ref_levels_s64=n_ref,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               setup_breakdown=out["setup_breakdown"])
    print(json.dumps(res), flush=True)
    draws = n_kept if draws is None else draws
    for k in ("w_mcmc", "yhat_mcmc", "beta_mcmc", "tausq_mcmc", "theta_mcmc"):
        _check(out[k].size and np.isfinite(out[k]).all(), f"finite {k}")
    _check(out["w_mcmc"].shape == (draws, len(y)), "w_mcmc shape")
    _check(not summary or out["summary_count"] == n_kept,
           f"summary_count {out.get('summary_count')} != {n_kept} draws")
    _check(rmspe < 0.5 * sd, f"RMSPE {rmspe} >= 0.5 sd(y) {sd}")
    _check(0.05 < out["accept_ratio"] < 0.8,
           f"acceptance {out['accept_ratio']} outside (0.05, 0.8)")
    _check(n_ref > 0 and launches >= 2 * n_ref * iters,
           f"K1 launches {launches} < 2 x {n_ref} ref levels x {iters} its")
    _check(counts["cov_launches"] > 0 and counts["cov_plain_calls"] == 0,
           f"covariance blocks: {counts['cov_launches']} K6 launches, "
           f"{counts['cov_plain_calls']} plain calls")
    _check_reference(cfg_id, rmspe, sd)
    if settings == dict(chunk=200) and not kw and not limited:
        _keep_draws(cfg_id, 1, keep, burn, thin, out)
    thin_lvls = [(p.B, p.S, p.P) for p in out["schedule"].levels
                 if not p.is_ref and p.P > 0]
    return res, thin_lvls, out


def _check_reference(cfg_id, rmspe, sd):
    """RMSPE within 15 % of the JAX package's at the configs it recorded
    (the same data: sd(y) must match to 1 %)."""
    if cfg_id not in JAX_RMSPE:
        return
    r_ref, sd_ref = JAX_RMSPE[cfg_id]
    print(f"config {cfg_id}: RMSPE {rmspe:.4f} / sd(y) {sd:.4f} against the "
          f"JAX package's {r_ref} / {sd_ref}", flush=True)
    _check(abs(sd - sd_ref) < 0.01 * sd_ref,
           f"config {cfg_id}: sd(y) {sd} is not the reference data's {sd_ref}")
    _check(abs(rmspe - r_ref) < 0.15 * r_ref,
           f"config {cfg_id}: RMSPE {rmspe} not within 15 % of {r_ref}")


def run_accept_aware(bench, chol, level, torch, cfg_id, keep, burn, thin,
                     composed=True, limited=False, chunk=200, knobs=None,
                     check_levels=False):
    """prepare_fit (``knobs`` to it), then run_mcmc with the accept-aware
    theta step and the fused level kernels on; with ``check_levels`` K3
    and K4 are first held against their plain versions at the model's own
    thin levels and parent positions (lp_pos).  Returns the run's record
    (with ``level_err``, the check's f32 errors, when checked) and the
    model and final state."""
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model import core
    from spamtree_tpu_torch.model.mcmc import run_mcmc
    from spamtree_tpu_torch.ops import kernel_counts

    c = bench.CONFIGS[cfg_id]
    y, y_full, miss, X, coords, mv = _data(bench, cfg_id)
    ybar = np.nanmean(y)
    with _env(SPAMTREE_LEVEL_KERNELS="1",
              SPAMTREE_COMPOSED_FACTORS="1" if composed else "0"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        fit = prepare_fit(y - ybar, X, coords, mv_id=mv, cell_size=25,
                          mcmc=dict(keep=keep, burn=burn, thin=thin),
                          settings=dict(chunk=chunk), seed=1, device="cuda",
                          limited_tree=limited, **(knobs or {}))
        setup = time.time() - t0
        ms = fit.ms
        L = len(ms.levels)
        # which reference levels hand their thin children factor parts
        compose = {t: composed and core._compose_children(ms, t)
                   for t in range(L) if ms.level_is_ref[t]}
        for t, f in compose.items():
            print(f"ref level {t} (B, S, P) = "
                  f"{tuple(ms.levels[t].rows.shape)}+"
                  f"{ms.levels[t].prows.shape[1]}: composes children {f}")
        thin_lvls = [t for t in range(L) if not ms.level_is_ref[t]
                     and ms.levels[t].prows.shape[1] > 0]
        k3_lvls = [t for t in thin_lvls if ms.level_chunks[t] == 1
                   and ms.levels[t].prows.shape[1] <= level.MAX_P
                   and ms.levels[t].rows.shape[1] <= level.MAX_S]
        k4_lvls = [t for t in k3_lvls if ms.level_group_c[t] <= 1
                   and not compose[ms.level_lp[t]]]
        all_compose = all(compose[ms.level_lp[t]] for t in thin_lvls)
        level_err = None
        if check_levels:
            cases = []
            for t in thin_lvls:
                lv = ms.levels[t]
                B, S = lv.rows.shape
                al = ms.level_aligned[t]
                cases.append((f"{c['name']} thin level {t}", B, S,
                              lv.prows.shape[1], None if al else
                              ms.levels[ms.level_lp[t]].rows.shape[0],
                              None if al else lv.lp_pos))
            err = check_level_kernels(level, torch, cases=cases)
            level_err = {k: max(e[k] for e in err.values())
                         for k in ("k3", "k4")}
        start = kernel_counts.snapshot()
        res = run_mcmc(ms, fit.bounds, fit.cfg._replace(accept_aware=True),
                       fit.state, fit.gen, yhat_seed=1)
        counts = kernel_counts.diff(start)
    iters = res["burn_actual"] + keep * thin
    y_post = res["yhat"].mean(axis=0) + ybar
    mo = miss[fit.order]
    rmspe = float(np.sqrt(np.mean((y_post[mo] - y_full[fit.order][mo]) ** 2)))
    sd = float(np.nanstd(y_full))
    n_ref = sum(1 for t in range(L) if ms.level_is_ref[t]
                and ms.levels[t].rows.shape[1] <= chol.MAX_S)
    rec = dict(config=c["name"], step="accept_aware", level_kernels=True,
               composed=composed, limited_tree=limited, n=len(y), iters=iters,
               ips=iters / res["mcmc_time"], mcmc_time=res["mcmc_time"],
               setup_time=setup, rmspe=rmspe, sd_y=sd,
               accept=res["accept_ratio"], **counts, ref_levels_s64=n_ref,
               levels=_level_shapes(ms.levels),
               pred_buckets=_level_shapes(ms.pred_arrays or []),
               level_chunks=ms.level_chunks, pred_chunks=ms.pred_chunks,
               pred_in_carry=ms.pred_in_carry,
               thin_levels=_level_shapes(ms.levels[t] for t in thin_lvls),
               k3_levels=len(k3_lvls), k4_levels=len(k4_lvls),
               level_aligned=[ms.level_aligned[t] for t in thin_lvls],
               level_err=level_err,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               setup_breakdown=fit.setup_breakdown)
    print(json.dumps(rec), flush=True)
    for k in ("w", "yhat", "beta", "tausq", "theta"):
        _check(res[k].size and np.isfinite(res[k]).all(), f"finite {k}")
    _check(res["w"].shape == (keep, len(y)), "w shape")
    _check(rmspe < 0.5 * sd, f"RMSPE {rmspe} >= 0.5 sd(y) {sd}")
    _check(0.05 < res["accept_ratio"] < 0.8,
           f"acceptance {res['accept_ratio']} outside (0.05, 0.8)")
    k1, k3, k4 = (counts[k] for k in ("k1_launches", "k3_launches",
                                      "k4_launches"))
    _check(n_ref > 0 and k1 >= 2 * n_ref * iters,
           f"K1 launches {k1} < 2 x {n_ref} ref levels x {iters} its")
    _check(k3_lvls and k3 == len(k3_lvls) * iters,
           f"K3 launches {k3} != {len(k3_lvls)} thin levels x {iters} its")
    _check(k4 >= len(k4_lvls) * iters,
           f"K4 launches {k4} < {len(k4_lvls)} thin levels x {iters} its")
    _check((k4 == 0) == all_compose,
           f"K4 launches {k4} but every thin parent composes: {all_compose}")
    _check_reference(cfg_id, rmspe, sd)
    return rec, (ms, res["state"])


def run_resume(bench, chol, torch, kw5):
    """Phase 10 at config 5: run A keeps the first half of kw5's draws
    with a checkpoint after every chunk (the sequential drain), run B
    resumes from it with kw5's keep and returns the other half.  Returns
    (A's record, B's record, K1 launches over both)."""
    half = kw5["keep"] // 2
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "ck.npz")
        ra, _, fa = run_config(bench, chol, torch, 5,
                               **(kw5 | dict(keep=half)), checkpoint_path=ck)
        k1 = ra["k1_launches"]
        rb, _, fb = run_config(bench, chol, torch, 5, **kw5,
                               draws=kw5["keep"] - half, resume_from=ck)
        k1 += rb["k1_launches"]
    it_a = ra["iters"]
    _check(fb["resumed_at_iteration"] == it_a
           and fb["resumed_kept_already"] == half,
           f"resumed at {fb['resumed_at_iteration']} (A ran {it_a}) with "
           f"{fb['resumed_kept_already']} kept ({half})")
    _check(fb["burn_actual"] == 0
           and fb["w_mcmc"].shape[0] == kw5["keep"] - half,
           "run B repeated burn or returned another count of draws")
    y, y_full, miss, *_ = _data(bench, 5)
    ybar = np.nanmean(y)
    mo = miss[fb["order"]]
    y_post = np.concatenate([fa["yhat_mcmc"], fb["yhat_mcmc"]]).mean(0) + ybar
    rmspe = float(np.sqrt(np.mean((y_post[mo] - y_full[fb["order"]][mo]) ** 2)))
    sd = float(np.nanstd(y_full))
    print(f"resume: A {it_a} iterations, B {rb['iters']}; RMSPE over A's "
          f"and B's {kw5['keep']} yhat draws {rmspe:.4f} (sd(y) {sd:.4f})")
    _check(rmspe < 0.5 * sd, f"A+B RMSPE {rmspe} >= 0.5 sd(y) {sd}")
    return ra, rb, k1


_KEYS = ("w_mcmc", "beta_mcmc", "tausq_mcmc", "theta_mcmc")


def resume_bits(bench, torch):
    """Config 1 on the card: do two uninterrupted runs give the same bits?
    If so, hold a resumed run's w/beta/tausq/theta bit for bit against the
    uninterrupted run's and return True; else return False."""
    import spamtree_tpu_torch

    y, _, _, X, coords, mv = _data(bench, 1)
    kw = dict(mv_id=mv, cell_size=25, seed=1, device="cuda",
              settings=dict(chunk=10))
    run = lambda keep, **k: spamtree_tpu_torch.spamtree(
        y, X, coords, mcmc=dict(keep=keep, burn=20, thin=1), **kw, **k)
    f1, f2 = run(40), run(40)
    same = all(np.array_equal(f1[k], f2[k]) for k in _KEYS)
    print(f"config 1: two uninterrupted runs {'give' if same else 'differ in'}"
          f" the same bits (deterministic algorithms "
          f"{torch.are_deterministic_algorithms_enabled()})", flush=True)
    if not same:
        return False
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "ck.npz")
        run(20, checkpoint_path=ck)
        res = run(40, resume_from=ck)
    for k in _KEYS:  # w (keep, n); beta (p, keep, q); tausq, theta (k, keep)
        want = f1[k][20:] if k == "w_mcmc" else f1[k][:, 20:]
        _check(np.array_equal(res[k], want),
               f"config 1 resume differs from the uninterrupted run in {k}")
    print("config 1: the resumed run equals the uninterrupted one bit for "
          "bit (w, beta, tausq, theta)", flush=True)
    return True


def check_resume_bits(bench, torch):
    """resume_bits here, or where the card's runs differ in their bits, in
    a subprocess under torch.use_deterministic_algorithms(True) and
    CUBLAS_WORKSPACE_CONFIG=:4096:8 (``--resume-bits``)."""
    if resume_bits(bench, torch):
        return "bitwise"
    p = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--resume-bits"],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
        capture_output=True, text=True, timeout=600)
    print(p.stdout[-4000:], p.stderr[-4000:], flush=True)
    _check(p.returncode == 0, "config 1 resume under deterministic "
           "algorithms failed")
    return "bitwise under deterministic algorithms"


def check_predict_recompute(torch, ms, state):
    """predict_recompute against predict at a model and state of the
    main path (config 5's), the same z: f32 tolerance."""
    from spamtree_tpu_torch.model import core

    g = torch.Generator(device=ms.device).manual_seed(5)
    z = torch.randn(ms.n + 1, generator=g, device=ms.device, dtype=ms.dtype)
    a = core.predict(ms, state.pred_data, state.w, z)
    b = core.predict_recompute(ms, state.theta, state.w, z,
                               core.level_coords(ms))
    err = float((a - b).abs().max())
    scale = float(a.abs().max())
    print(f"predict_recompute vs predict at config 5: max |d| {err:.3e} "
          f"(max |w| {scale:.3e})", flush=True)
    _check(err <= TOL["float32"] * max(scale, 1.0),
           f"predict_recompute disagrees with predict: {err}")
    return err


def run_predict(bench, torch, fit, m=10_000, n_draws=50):
    """Phase 11: spamtree_predict on phase 8's always-emit fit at m of the
    held-out rows' coordinates."""
    import spamtree_tpu_torch
    from spamtree_tpu_torch.ops import kernel_counts

    y, y_full, miss, X, coords, mv = _data(bench, 5)
    ybar = np.nanmean(y)
    pick = np.sort(np.random.default_rng(0).choice(
        np.flatnonzero(miss), size=m, replace=False))
    start = kernel_counts.snapshot()
    t0 = time.time()
    pred = spamtree_tpu_torch.spamtree_predict(
        fit, y - ybar, X, coords, coords_new=coords[pick], x_new=X[pick],
        mv_id=mv, mv_id_new=mv[pick], n_draws=n_draws, seed=1,
        device="cuda")
    wall = time.time() - t0
    counts = kernel_counts.diff(start)
    yb = pred["yhat_pred"] + ybar
    rmspe = float(np.sqrt(np.mean((yb.mean(0) - y_full[pick]) ** 2)))
    sd = float(np.nanstd(y_full))
    # the fit's own in-fit prediction at the same rows
    inv = np.empty(len(y), dtype=np.int64)
    inv[fit["order"]] = np.arange(len(y))
    ya = fit["yhat_mcmc"][:, inv[pick]] + ybar
    env = np.sqrt(ya.var(0) / 40 + yb.var(0) / 40) + 0.05
    frac_off = float(np.mean(np.abs(ya.mean(0) - yb.mean(0)) > 4 * env))
    bd = pred["predict_breakdown"]
    # levels _joints_upto factors per draw: the prediction parent alone on
    # a limited tree, every reference level up to it on a full tree
    lv = fit["schedule"].levels
    pred_lp = fit["schedule"].pred_buckets[0].lp_level
    per_draw = 1 if fit["fit_config"]["limited_tree"] else pred_lp + 1
    rec = dict(phase="spamtree_predict", m=m, n_draws=n_draws, wall_s=wall,
               s_per_draw=bd["draws_s"] / n_draws, breakdown=bd,
               rmspe=rmspe, sd_y=sd, frac_off_envelope=frac_off,
               ref_levels=sum(p.is_ref for p in lv),
               k1_per_draw_expected=per_draw, **counts)
    print(json.dumps(rec), flush=True)
    _check(pred["w_pred"].shape == (n_draws, m)
           and np.isfinite(pred["yhat_pred"]).all(), "spamtree_predict output")
    _check(rmspe < 0.5 * sd, f"spamtree_predict RMSPE {rmspe} >= 0.5 sd {sd}")
    _check(frac_off < 0.08, f"spamtree_predict off the in-fit envelope at "
           f"{frac_off:.3f} of the rows")
    _check(counts["k1_launches"] == per_draw * n_draws,
           f"K1 launches {counts['k1_launches']} on the predict path, "
           f"{per_draw} x {n_draws} draws expected")
    return rec


def run_oracle(torch):
    """Phase 15: tests/test_torch_oracle.py's univariate_parity -- the
    dense NumPy oracle of the reference sampler on the host, the port's
    float64 chain (prior, starting values, tree and thresholds of
    tests/test_reference_oracle.py::test_posterior_parity_vs_dense_oracle)
    on the card, that test's assertions.  K1 must launch (in float64)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from test_torch_oracle import univariate_parity

    from spamtree_tpu_torch.ops import kernel_counts

    start = kernel_counts.snapshot()
    t0 = time.time()
    res = univariate_parity(device="cuda")
    rec = dict(phase="oracle_f64", dtype="float64", wall_s=time.time() - t0,
               **res, **kernel_counts.diff(start))
    print(json.dumps(rec), flush=True)
    _check(rec["k1_launches"] > 0, "K1 never launched in the f64 oracle run")
    return rec


CHAINS = (1, 2, 4)
K1_FOLD_C = 4  # the chain count K1's folded shapes are checked and timed at


def check_folded_k1(chol, torch, C=K1_FOLD_C):
    """Phase 16's K1 check at the batched chains' shapes: config 3's and
    config 5's reference levels with C chains, built as contiguous (C, B,
    S, S) batches and folded to (C*B, S, S) views (config 5's deepest level
    gives (65536, 25) at C = 4), f32 and f64, one non-SPD block in one
    chain's slice, which alone must come out ok=False.  Returns the largest
    f32 |dLinv| over config 3's and over config 5's shapes."""
    err32 = {"config3": 0.0, "config5": 0.0}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for label, shapes in (("config3", CONFIG3_SHAPES),
                              ("config5", CONFIG5_SHAPES)):
            for B, S in shapes:
                A = _spd_batch(torch, C * B, S, dtype,
                               seed=B * 100 + S).reshape(C, B, S, S)
                bad_c = C // 2
                A[bad_c, B // 2, 0, 1] = A[bad_c, B // 2, 1, 0] = 10.0 * S
                good = torch.ones(C, B, dtype=torch.bool, device="cuda")
                good[bad_c, B // 2] = False
                folded = A.reshape(C * B, S, S)
                _check(folded.data_ptr() == A.data_ptr(),
                       "the (C, B) fold copied")
                k = chol.inv_chol(folded)
                p = chol.inv_chol_plain(folded)
                torch.cuda.synchronize()
                for x in (k, p):
                    d = torch.diagonal(x, dim1=-2, dim2=-1)
                    ok = torch.all(torch.isfinite(d) & (d > 0), dim=-1)
                    _check(torch.equal(ok.reshape(C, B), good),
                           f"folded K1 ok flags: {dname} C={C} B={B} S={S}")
                g = good.reshape(-1)
                err = float((k[g] - p[g]).abs().max())
                scale = float(p[g].abs().max())
                _check(err <= TOL[dname] * scale,
                       f"folded K1 disagrees: {dname} C={C} B={B} S={S} "
                       f"err={err} scale={scale}")
                if dname == "float32":
                    err32[label] = max(err32[label], err)
        print(f"K1 folded ok {dname} at C={C}: (C*B, S) = " + ", ".join(
            f"({C * B}, {S})" for B, S in CONFIG3_SHAPES + CONFIG5_SHAPES),
            flush=True)
    print(f"K1 folded max |dLinv| f32: {err32}", flush=True)
    return err32


def run_chains(bench, torch, cfg_id, C, keep, burn, thin,
               chunk=200):
    """spamtree(n_chains=C), the always-emit step (C = 1: the single-chain
    run; C > 1: run_mcmc_chains, every chain's accept on the device).
    Checks each chain: finite draws, RMSPE < 0.5 sd(y) on the held-out
    rows, acceptance in (0.05, 0.8); theta_rhat finite for C > 1.  Returns
    the record (K1's launches counted from just before the call)."""
    import spamtree_tpu_torch
    from spamtree_tpu_torch.ops import kernel_counts

    c = bench.CONFIGS[cfg_id]
    y, y_full, miss, X, coords, mv = _data(bench, cfg_id)
    ybar = np.nanmean(y)
    torch.cuda.reset_peak_memory_stats()
    start = kernel_counts.snapshot()
    t0 = time.time()
    out = spamtree_tpu_torch.spamtree(
        y - ybar, X, coords, mv_id=mv, cell_size=25,
        mcmc=dict(keep=keep, burn=burn, thin=thin),
        settings=dict(chunk=chunk), seed=1, device="cuda", n_chains=C,
        **c["kwargs"])
    wall = time.time() - t0
    counts = kernel_counts.diff(start)
    iters = out["burn_actual"] + keep * thin
    # one chain: w/yhat (keep, n), theta (nt, keep); chains (keep, C, ...)
    yhat = out["yhat_mcmc"][:, None] if C == 1 else out["yhat_mcmc"]
    acc = (np.array([out["accept_ratio"]]) if C == 1
           else np.asarray(out["accept_by_chain"]))
    order = out["order"]
    mo = miss[order]
    sd = float(np.nanstd(y_full))
    rmspe = [float(np.sqrt(np.mean(((yhat[:, k].mean(0) + ybar)[mo]
                                    - y_full[order][mo]) ** 2)))
             for k in range(C)]
    rec = dict(phase="chains", config=c["name"], chains=C, n=len(y),
               iters=iters, keep=keep, burn=burn, thin=thin,
               chain_it_per_s=C * iters / out["mcmc_time"],
               ms_per_iter=1e3 * out["mcmc_time"] / iters,
               mcmc_time=out["mcmc_time"], iter_s=out["iter_s"],
               drain_work_s=out["drain_work_s"],
               setup_time=wall - out["mcmc_time"], rmspe=rmspe, sd_y=sd,
               accept_by_chain=acc.tolist(), **counts,
               k1_per_iter=counts["k1_launches"] / iters,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               theta_rhat=(out["theta_rhat"].tolist() if C > 1 else None))
    print(json.dumps(rec), flush=True)
    for k in ("w_mcmc", "yhat_mcmc", "beta_mcmc", "tausq_mcmc", "theta_mcmc"):
        _check(out[k].size and np.isfinite(out[k]).all(),
               f"config {cfg_id} C={C}: finite {k}")
    _check(yhat.shape == (keep, C, len(y)),
           f"config {cfg_id} C={C}: yhat shape {yhat.shape}")
    for k in range(C):
        _check(rmspe[k] < 0.5 * sd, f"config {cfg_id} chain {k} of {C}: "
               f"RMSPE {rmspe[k]} >= 0.5 sd(y) {sd}")
        _check(0.05 < acc[k] < 0.8, f"config {cfg_id} chain {k} of {C}: "
               f"acceptance {acc[k]} outside (0.05, 0.8)")
    _check(C == 1 or np.isfinite(out["theta_rhat"]).all(),
           f"config {cfg_id} C={C}: theta_rhat {out.get('theta_rhat')}")
    _check(counts["k1_launches"] > 0, f"config {cfg_id} C={C}: K1 idle")
    if chunk == 200:
        _keep_draws(cfg_id, C, keep, burn, thin, out)
    return rec


def chains_phase(bench, chol, torch):
    """Phase 16: K1 at the folded shapes, then configs 1 and 3 at C = 1, 2
    and 4; K1's launches must not grow with C (one launch per level for
    all chains); time_phases' table at config 3; then whether two batched
    runs give the same bits."""
    import spamtree_tpu_torch

    err = check_folded_k1(chol, torch)
    times = {label: time_kernel(
        chol, torch, shapes=[(K1_FOLD_C * B, S) for B, S in shapes],
        label=f"{label} x {K1_FOLD_C} chains folded")
        for label, shapes in (("config3", CONFIG3_SHAPES),
                              ("config5", CONFIG5_SHAPES))}
    runs = {}
    # config 1 cut from the bench's 3200 iterations to 600, config 3 at
    # phase 5's depth, to keep the phase near two minutes
    for cfg_id, kw in ((1, dict(keep=150, burn=150, thin=2)),
                       (3, dict(keep=100, burn=200, thin=2))):
        for C in CHAINS:
            _phase(f"chains: config {cfg_id}, n_chains={C}")
            runs[(cfg_id, C)] = run_chains(bench, torch, cfg_id,
                                           C, **kw)
        k1 = {C: runs[(cfg_id, C)]["k1_launches"] for C in CHAINS}
        _check(all(k1[C] == k1[1] for C in CHAINS),
               f"config {cfg_id}: K1 launches by chain count {k1} (they "
               f"must not grow with C)")
    for cfg_id in (1, 3):
        for C in CHAINS:
            r = runs[(cfg_id, C)]
            print(f"chains table: config {cfg_id} C={C}: "
                  f"{r['chain_it_per_s']:.2f} chain-it/s, "
                  f"{r['ms_per_iter']:.2f} ms/it, K1 "
                  f"{r['k1_per_iter']:.2f}/it, peak "
                  f"{r['peak_mem_bytes'] / 1e9:.2f} GB, accept "
                  f"{np.round(r['accept_by_chain'], 3).tolist()}", flush=True)
    # the per-phase table (utils.diagnostics) at config 3, one chain and
    # four chains batched
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.utils.diagnostics import time_phases

    y, _, _, X, coords, mv = _data(bench, 3)
    fit = prepare_fit(y - np.nanmean(y), X, coords, mv_id=mv, cell_size=25,
                      mcmc=dict(keep=1, burn=0), seed=1, device="cuda",
                      n_chains=4)
    st = fit.state
    one = st._replace(theta=st.theta[0], w=st.w[0],
                      tausq_inv=st.tausq_inv[0], XB=st.XB[0])
    phases = {C: time_phases(fit.ms, s, iters=5) for C, s in ((1, one),
                                                              (4, st))}
    print(json.dumps(dict(phase="time_phases", config=3, ms=phases)),
          flush=True)
    _check(all(np.isfinite(v) and v > 0 for t in phases.values()
               for v in t.values()), f"time_phases: {phases}")
    del fit, st, one
    y, _, _, X, coords, mv = _data(bench, 1)
    two = [spamtree_tpu_torch.spamtree(
        y, X, coords, mv_id=mv, cell_size=25, mcmc=dict(keep=40, burn=20),
        settings=dict(chunk=10), seed=1, device="cuda", n_chains=2)
        for _ in range(2)]
    same = all(np.array_equal(two[0][k], two[1][k]) for k in _KEYS)
    print(f"config 1, two batched runs at n_chains=2: "
          f"{'the same bits' if same else 'different bits'}", flush=True)
    return dict(err=err, times=times, runs=runs, same_bits=same)


def _level_inputs(torch, dtype, B, S, P, Bp, seed, bad, lp_pos=None):
    """K3 and K4 inputs at realistic magnitudes (M = LAi Kxc ~ N(0, 1),
    hk = sum_p M^2 ~ P with a heavy upper tail, kdiag = hk + (1.5 P, 3 P),
    so that r = kdiag - hk > 0 on every row of the largest batch at small P
    too, as on the model's path where the joint is a factor of the
    covariance that kdiag comes from): block 1 partly masked; with ``bad``
    block B-1 gets kdiag < 0, so r <= 0 there and its ok flag must be 0.
    ``lp_pos`` (into Bp parents) is drawn at random unless given."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda", dtype=dtype)

    def unif(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, **kw)

    rmask = torch.ones(B, S, device="cuda", dtype=dtype)
    rmask[1, S // 2:] = 0.0
    if lp_pos is None:
        lp_pos = (torch.arange(B, device="cuda") if Bp is None else
                  torch.randint(0, Bp, (B,), generator=g, device="cuda"))
    dec = dict(Kxc=torch.randn(B, P, S, **kw),
               joint=torch.randn(B if Bp is None else Bp, P, P, **kw) / P ** 0.5,
               lp_pos=lp_pos, wpar=torch.randn(B, P, **kw),
               w_r=torch.randn(B, S, **kw),
               prevH=torch.randn(B, S, P, **kw) / P ** 0.5,
               prevprec=unif(0.5, 2.0, B, S), rmask_f=rmask)
    M = dec["joint"][lp_pos] @ dec["Kxc"]
    dec["kdiag"] = torch.sum(M * M, dim=1) + unif(1.5, 3.0, B, S) * P
    if bad:
        dec["kdiag"][B - 1] = -1.0
    gib = dict(H=torch.randn(B, S, P, **kw) / P ** 0.5,
               prec=unif(0.5, 2.0, B, S), wpar=dec["wpar"],
               z=torch.randn(B, S, **kw), ti=unif(2.0, 5.0, B, S),
               resid=torch.randn(B, S, **kw), rmask_f=rmask)
    return dec, gib


def _close(k, p, tol):
    return bool(((k - p).abs() <= tol * p.abs().clamp(min=1.0)).all())


def check_level_kernels(level, torch, thin3=None, cases=None):
    """K3 and K4 against their plain versions, f32 and f64, at ``cases``
    [(name, B, S, P, Bp or None when aligned, lp_pos or None)]; by default
    config 3's thin level ``thin3``, config 1's, the K5 layouts, the gate's
    edge and config 5's four thin levels through lp_pos on its 16384
    parents.  Returns the largest f32 |d| of each (wu/msg; the per-block
    partials) per case name, {"config5": {"k3", "k4"}, "config3": ...}."""
    if cases is None:
        B3, S3, P3 = thin3
        cases = [("config3", B3, S3, P3, None, None),
                 ("config1", 16, 18, 69, 12, None),
                 ("p128", 64, 68, 128, None, None),
                 ("p384", 64, 68, 384, None, None),
                 ("edge", 8, 512, 1024, None, None)]
        cases += [("config5", *shp, CONFIG5_SHAPES[-1][0], None)
                  for shp in CONFIG5_THIN]
    err = {}
    for dname in ("float32", "float64"):
        dtype, tol = getattr(torch, dname), TOL[dname]
        for name, B, S, P, Bp, lp_pos in cases:
            for bad in (False, True):
                dec, gib = _level_inputs(torch, dtype, B, S, P, Bp,
                                         seed=B + S + P, bad=bad,
                                         lp_pos=lp_pos)
                aligned = Bp is None
                pk = level.thin_decision_partials(**dec, aligned=aligned)
                pp = level.thin_decision_partials_plain(**dec, aligned=aligned)
                lk = level.thin_decision_level(**dec, aligned=aligned)
                lp = level.thin_decision_level_plain(**dec, aligned=aligned)
                wk, mk = level.thin_gibbs_level(**gib)
                wp, mp = level.thin_gibbs_level_plain(**gib)
                torch.cuda.synchronize()
                what = f"{dname} {name} B={B} S={S} P={P} bad={bad}"
                okp = pp[:, 3].clone()
                _check(torch.equal(pk[:, 3], okp), f"K4 ok flags: {what}")
                _check(float(okp.min()) == (0.0 if bad else 1.0),
                       f"forced r <= 0 flags: {what}")
                _check(bool(lk[1]) == bool(lp[1]) == (not bad),
                       f"K4 level ok: {what}")
                _check(_close(pk, pp, tol), f"K4 partials disagree: {what}")
                for i in (0, 2, 3):
                    _check(_close(lk[i], lp[i], tol),
                           f"K4 level scalar {i} disagrees: {what}")
                _check(_close(wk, wp, tol) and _close(mk, mp, tol),
                       f"K3 disagrees: {what}")
                _check(bool((wk[1, S // 2:] == 0).all()), f"K3 mask: {what}")
                if dname == "float32":
                    e = err.setdefault(name, {"k3": 0.0, "k4": 0.0})
                    e["k4"] = max(e["k4"], float((pk - pp).abs().max()))
                    e["k3"] = max(e["k3"], float((wk - wp).abs().max()),
                                  float((mk - mp).abs().max()))
            print(f"K3/K4 ok {dname} {name} B={B} S={S} P={P} Bp={Bp}, K3 "
                  f"variant {_variant(level, S, P, dtype)}", flush=True)
    for path, e in err.items():
        print(f"K3 max |d| f32 at {path}: {e['k3']:.3e}; "
              f"K4 max |d partials| f32 at {path}: {e['k4']:.3e}")
    return err


def time_level_kernels(level, torch, thin3, reps=20):
    """CUDA-event ms per eager call of K3 and K4 (wrappers, as the sweeps
    call them) and their plain versions at config 3's thin level (f32,
    aligned), with the bound of each and the device ms of both in a CUDA
    graph: K3 reads H, wpar and five (B, S) vectors and writes wu and msg,
    4 B S P flops; K4 reads Kxc, the B parent slabs, prevH, wpar and four
    (B, S) vectors and writes (B, 4), 2 P^2 (S + 1) B + 6 P S B flops.  K4
    also at P=128 and P=384 with config 3's B (the TPU's K5 layouts, as
    "k5_p128", "k5_p384"); and the device ms of the cuBLAS product LAi Kxc
    alone at config 3's shape, the yardstick of K4's product."""
    B, S, P = thin3
    _, gib = _level_inputs(torch, torch.float32, B, S, P, None, seed=11,
                           bad=False)
    f32 = torch.float32
    cases = {"k3": (thin3, {
        "kernel": lambda: level.thin_gibbs_level(**gib),
        "plain": lambda: level.thin_gibbs_level_plain(**gib)},
        _bound(*level.thin_gibbs_cost(B, S, P, f32)[::-1]))}
    decs = {}
    for key, (b, s, p) in (("k4", thin3), ("k5_p128", (B, S, 128)),
                           ("k5_p384", (B, S, 384))):
        dec = decs[key] = _level_inputs(torch, torch.float32, b, s, p, None,
                                        seed=11, bad=False)[0]
        cases[key] = ((b, s, p), {
            "kernel": lambda dec=dec: level.thin_decision_level(
                **dec, aligned=True),
            "plain": lambda dec=dec: level.thin_decision_level_plain(
                **dec, aligned=True)},
            _bound(*level.thin_decision_cost(b, s, p, f32)[::-1]))
    out = {}
    for key, ((b, s, p), f, (bd, by)) in cases.items():
        k, pl = _event_times(torch, f, reps)
        gk, gp = (_graph_ms(torch, f[n], reps) for n in ("kernel", "plain"))
        out[key] = (k, pl, (bd, by), (b, s, p), gk, gp)
        print(f"{key.upper()} time B={b} S={s} P={p} f32: kernel {k:.4f} ms,"
              f" plain {pl:.4f} ms, bound {bd:.4f} ms ({by}); device time in"
              f" a CUDA graph: kernel {gk:.4f} ms, plain {gp:.4f} ms")
    LAi, Kxc = decs["k4"]["joint"], decs["k4"]["Kxc"]
    t = _graph_ms(torch, lambda: torch.bmm(LAi, Kxc), reps)
    bd = _bound(4 * (2 * B * P * S + B * P * P), 2 * B * P * P * S)[0]
    print(f"cuBLAS bmm(LAi, Kxc) alone, B={B} S={S} P={P} f32, device time "
          f"in a CUDA graph: {t:.4f} ms (bound {bd:.4f} ms)")
    return out


def _gibbs_inputs(torch, dtype, B, S, P, seed, Bp=None):
    """K3 inputs as ``_level_inputs`` makes them, block 2 masked whole; with
    ``Bp`` wpar is gathered from Bp parents' rows through a random lp_pos,
    as the unaligned thin levels read theirs."""
    gib = _level_inputs(torch, dtype, B, S, P, None, seed, bad=False)[1]
    gib["rmask_f"] = gib["rmask_f"].clone()
    gib["rmask_f"][min(2, B - 1)] = 0.0
    if Bp is not None:
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        lp_pos = torch.randint(0, Bp, (B,), generator=g, device="cuda")
        wj = torch.randn(Bp, P, generator=g, device="cuda", dtype=dtype)
        gib["wpar"] = wj[lp_pos]
    return gib


def _variant(level, S, P, dtype):
    """K3's variant at (S, P), where the package under test reports it."""
    f = getattr(level, "thin_gibbs_variant", None)
    return f(S, P, dtype) if f else "not reported"


def check_gibbs_shapes(level, torch):
    """K3 against its plain version, f32 and f64, at config 5's four thin
    levels (wpar through lp_pos from 16384 parents) and at one shape per
    variant; two runs on the same inputs must give the same bits."""
    cases = ([(f"config5 thin {i}", *shp, CONFIG5_SHAPES[-1][0])
              for i, shp in enumerate(CONFIG5_THIN)]
             + [("variant", *shp, None) for shp in K3_VARIANT_SHAPES]
             + [("edge", 8, 512, 1024, None),
                ("config3", *CONFIG3_THIN, None)])
    seen = set()
    for dname in ("float32", "float64"):
        dtype, tol = getattr(torch, dname), TOL[dname]
        for name, B, S, P, Bp in cases:
            gib = _gibbs_inputs(torch, dtype, B, S, P, seed=B + S + P, Bp=Bp)
            wk, mk = level.thin_gibbs_level(**gib)
            wk2, mk2 = level.thin_gibbs_level(**gib)
            wp, mp = level.thin_gibbs_level_plain(**gib)
            torch.cuda.synchronize()
            var = _variant(level, S, P, dtype)
            seen.add(var)
            what = f"{dname} {name} B={B} S={S} P={P} variant {var}"
            _check(torch.equal(wk, wk2) and torch.equal(mk, mk2),
                   f"K3 runs differ: {what}")
            _check(_close(wk, wp, tol) and _close(mk, mp, tol),
                   f"K3 disagrees: {what}")
            _check(bool((wk[gib["rmask_f"] <= 0.5] == 0).all()),
                   f"K3 mask: {what}")
            print(f"K3 ok {what}", flush=True)
    print(f"K3 variants checked: {sorted(seen)}")
    _check(len(seen) >= 5, f"K3 variants checked: {sorted(seen)}")


def _time_shapes(torch, kname, label, shapes, make, fns, bound, note=None,
                 reps=20, f64=False):
    """Time a level kernel and its plain version at each (B, S, P) of
    ``shapes``, f32 (or f64, as ``make`` makes them): CUDA events around
    eager wrapper calls and the device
    ms of the same calls in a CUDA graph.  The calls take ``make(shape,
    seed)``'s input sets in turn, enough of them that a pass over them
    exceeds the L2 cache: the sweeps find these arrays cold (H was written
    at the last accepted proposal).  ``bound(shape, inputs)`` gives the
    bytes and flops of one call.  Returns the sums over the shapes, and
    what bounds them ("bytes" if every shape is)."""
    tot = dict(ms=0.0, dev=0.0, plain=0.0, plain_dev=0.0, bound=0.0)
    bys = set()
    for shp in shapes:
        sets = [make(shp, 0)]
        nbytes, flops = bound(shp, sets[0])
        nsets = max(1, min(32, int(-(-2.4 * L2_BYTES // nbytes))))
        sets += [make(shp, seed) for seed in range(1, nsets)]
        turn = [0]

        def nxt():
            turn[0] = (turn[0] + 1) % nsets
            return sets[turn[0]]

        f = {k: (lambda fn=fn: fn(**nxt())) for k, fn in fns.items()}
        k, pl = _event_times(torch, f, reps)
        gk, gp = (_graph_ms(torch, f[n], reps) for n in ("kernel", "plain"))
        bd, by = _bound(nbytes, flops,
                        PEAK_FP64_S if f64 else PEAK_FP32_S)
        bys.add(by)
        for key, v in zip(tot, (k, gk, pl, gp, bd)):
            tot[key] += v
        B, S, P = shp
        print(f"{kname} time {label} B={B} S={S} P={P} "
              f"{'f64' if f64 else 'f32'}"
              f"{note(shp) if note else ''} ({nsets} input sets): kernel "
              f"{k:.4f} ms, plain {pl:.4f} ms, bound {bd:.4f} ms ({by}); "
              f"device time in a CUDA graph: kernel {gk:.4f} ms, plain "
              f"{gp:.4f} ms, bound / kernel {bd / gk:.2f}")
    print(f"{kname} time summed over the {label} shapes: kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain']:.4f} ms, bound "
          f"{tot['bound']:.4f} ms; device time in a CUDA graph: kernel "
          f"{tot['dev']:.4f} ms, plain {tot['plain_dev']:.4f} ms")
    tot["by"] = "bytes" if bys == {"bytes"} else "operations"
    return tot


def time_gibbs_shapes(level, torch, shapes, label, Bp=None, f64=False):
    """K3 at ``shapes``, with the variant its launcher takes at each.  The
    bound counts H, wpar and msg (B, P), and the five input vectors and wu
    (B, S), each once, and 4 B S P flops."""
    dtype = torch.float64 if f64 else torch.float32
    return _time_shapes(
        torch, "K3", label, shapes,
        lambda shp, seed: _gibbs_inputs(torch, dtype, *shp, seed=seed, Bp=Bp),
        {"kernel": level.thin_gibbs_level,
         "plain": level.thin_gibbs_level_plain},
        lambda shp, _: level.thin_gibbs_cost(*shp, dtype)[::-1],
        note=lambda shp: " variant " + _variant(level, shp[1], shp[2], dtype),
        f64=f64)


def time_decision_shapes(level, torch, shapes, Bp, label):
    """K4 (thin_decision_level, reduction included) at ``shapes`` through
    lp_pos on ``Bp`` parents.  The bound (``ops.level.thin_decision_cost``)
    counts Kxc, prevH, the parent slabs this lp_pos reads, wpar, four (B,
    S) vectors and lp_pos, and 2 P^2 (S + 1) B + 6 P S B flops."""
    def bound(shp, dec):
        slabs = int(torch.unique(dec["lp_pos"]).numel())
        return level.thin_decision_cost(*shp, torch.float32, slabs=slabs,
                                        aligned=False)[::-1]

    return _time_shapes(
        torch, "K4", label, shapes,
        lambda shp, seed: _level_inputs(torch, torch.float32, *shp, Bp,
                                        seed=seed, bad=False)[0],
        {"kernel": level.thin_decision_level,
         "plain": level.thin_decision_level_plain}, bound,
        note=lambda shp: f" Bp={Bp}")


def time_config5_kernels(chol, level, torch):
    """K1, K3 and K4 at config 5's level shapes; K3 also at config 3's and
    at one shape of each other variant, and in f64 at both rows capacities,
    over rotating inputs like the others."""
    Bp = CONFIG5_SHAPES[-1][0]
    return dict(
        k1=time_kernel(chol, torch, shapes=CONFIG5_SHAPES, label="config-5"),
        k3_variants=time_gibbs_shapes(level, torch, K3_TIME_SHAPES,
                                      "config-3 and per-variant"),
        k3_f64=time_gibbs_shapes(level, torch, K3_TIME_SHAPES_F64,
                                 "rows capacities", f64=True),
        k3=time_gibbs_shapes(level, torch, CONFIG5_THIN, "config-5", Bp=Bp),
        k4=time_decision_shapes(level, torch, CONFIG5_THIN, Bp, "config-5"))


# -- phase 18: the accept-aware step under a chain axis ----------------------

K4_FOLD_C = 4  # the chain count K4's folded shapes are checked and timed at
CONFIG4_THIN = (1024, 42, 150)  # config 4's thin level (B, S, P)
# phase 18's runs: (config, chains, composed factor parts), config 3 at
# half phase 16's depth (for the time limit), config 4 at phase 16's depth
# (its 15 theta parameters accept ~0.05 over its first 200 iterations, on
# either step)
AA_CHAIN_RUNS = ((3, 2, True), (3, 2, False), (3, 4, True), (3, 4, False),
                 (4, 2, False))
AA_DEPTH = {3: dict(keep=50, burn=100, thin=2),
            4: dict(keep=100, burn=200, thin=2)}


def _k4_fold_groups():
    """{label: ([(B, S, P)], Bp or None when aligned)}: config 3's thin
    level (aligned), config 4's through lp_pos on 1024 parents, config 5's
    four through lp_pos on its 16384."""
    return {"config3": ([CONFIG3_THIN], None),
            "config4": ([CONFIG4_THIN], CONFIG4_THIN[0]),
            "config5": (CONFIG5_THIN, CONFIG5_SHAPES[-1][0])}


def _chain_level_inputs(torch, dtype, B, S, P, Bp, seed, C=K4_FOLD_C,
                        bad=None):
    """K4 inputs of C chains (``_level_inputs`` per chain, seeds seed + c),
    stacked (C, ...) but for the level's lp_pos and rmask_f, which the
    chains share; with ``bad`` = c, chain c's block B // 2 gets kdiag < 0
    (r <= 0 on every row, so that chain alone must come out ok=False)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lp_pos = (None if Bp is None else
              torch.randint(0, Bp, (B,), generator=g, device="cuda"))
    per = [_level_inputs(torch, dtype, B, S, P, Bp, seed + c, bad=False,
                         lp_pos=lp_pos)[0] for c in range(C)]
    dec = {k: (per[0][k] if k in ("lp_pos", "rmask_f")
               else torch.stack([d[k] for d in per])) for k in per[0]}
    if bad is not None:
        dec["kdiag"][bad, B // 2] = -1.0
    return dec


def check_folded_k4(level, torch, C=K4_FOLD_C):
    """Phase 18's K4 check: thin_decision_chains (one launch over the C
    chains' folded blocks) against thin_decision_chains_plain, f32 and f64,
    at every shape of ``_k4_fold_groups``, one chain with a failing block,
    which alone must come out ok=False; the kernel's per-block partials of
    the same fold against the plain ones.  Returns the largest f32
    |d partials| per group."""
    from spamtree_tpu_torch.ops import kernel_counts

    err = {}
    bad = C // 2
    want = [c != bad for c in range(C)]
    for dname in ("float32", "float64"):
        dtype, tol = getattr(torch, dname), TOL[dname]
        for label, (shapes, Bp) in _k4_fold_groups().items():
            aligned = Bp is None
            for B, S, P in shapes:
                dec = _chain_level_inputs(torch, dtype, B, S, P, Bp,
                                          seed=B + S + P, C=C, bad=bad)
                start = kernel_counts.snapshot()
                k = level.thin_decision_chains(**dec, aligned=aligned)
                torch.cuda.synchronize()
                what = f"{dname} {label} C={C} B={B} S={S} P={P} Bp={Bp}"
                _check(kernel_counts.diff(start)["k4_launches"] == 1,
                       f"folded K4 launches once: {what}")
                p = level.thin_decision_chains_plain(**dec, aligned=aligned)
                folded = level._fold_chains(**dec)
                pk = level.thin_decision_partials(*folded, aligned=aligned)
                pp = level.thin_decision_partials_plain(*folded,
                                                        aligned=aligned)
                torch.cuda.synchronize()
                _check(k[1].tolist() == p[1].tolist() == want,
                       f"folded K4 ok by chain {k[1].tolist()}: {what}")
                _check(torch.equal(pk[:, 3], pp[:, 3]),
                       f"folded K4 block flags: {what}")
                _check(_close(pk, pp, tol),
                       f"folded K4 partials disagree: {what}")
                for i in (0, 2, 3):
                    _check(_close(k[i], p[i], tol),
                           f"folded K4 value {i} disagrees: {what}")
                if dname == "float32":
                    err[label] = max(err.get(label, 0.0),
                                     float((pk - pp).abs().max()))
                del dec, folded, pk, pp
            print(f"K4 folded ok {dname} {label} at C={C}: " + ", ".join(
                f"({C * B}, {S}, {P})" for B, S, P in shapes), flush=True)
    print(f"K4 folded max |d partials| f32: {err}", flush=True)
    return err


def time_folded_k4(level, torch, C=K4_FOLD_C):
    """thin_decision_chains and its plain version at each group of
    ``_k4_fold_groups`` (f32, C chains): CUDA events around eager calls and
    the device ms of the same calls replayed from a CUDA graph.  The bound
    counts Kxc and prevH, the parent slabs the fold reads, wpar, three
    (C, B, S) vectors, the shared rmask_f and lp_pos each once, and C B
    (2 P^2 (S + 1) + 6 P S) flops."""
    out = {}
    for label, (shapes, Bp) in _k4_fold_groups().items():
        aligned = Bp is None

        def bound(shp, dec):
            B, S, P = shp
            slabs = C * (B if aligned else
                         int(torch.unique(dec["lp_pos"]).numel()))
            nbytes = (4 * (2 * C * B * P * S + slabs * P * P + C * B * P
                           + 3 * C * B * S + B * S + 4 * C) + 8 * B)
            return nbytes, C * B * (2 * P * P * (S + 1) + 6 * P * S)

        out[label] = _time_shapes(
            torch, "K4 folded", f"{label} x {C} chains", shapes,
            lambda shp, seed: _chain_level_inputs(
                torch, torch.float32, *shp, Bp, seed=seed, C=C),
            {"kernel": lambda aligned=aligned, **d: level.thin_decision_chains(
                **d, aligned=aligned),
             "plain": lambda aligned=aligned, **d:
                 level.thin_decision_chains_plain(**d, aligned=aligned)},
            bound, note=lambda shp: f" Bp={Bp}")
    return out


def run_chains_accept_aware(bench, chol, level, torch, cfg_id, C, composed,
                            keep, burn, thin):
    """prepare_fit(n_chains=C), then run_mcmc_chains with the accept-aware
    step, the level kernels on and composed factor parts on or off.  Each
    chain must give finite draws, RMSPE < 0.5 sd(y) and acceptance in
    (0.05, 0.8); theta_rhat finite; K1 launched three times per reference
    level chunk (w-Gibbs, the decision sweep, the rebuild) and K4 once per
    thin level it serves in every iteration, whatever C; K3 never (chains
    carry no Gram blocks).  Returns the record."""
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model import core
    from spamtree_tpu_torch.model.mcmc import run_mcmc_chains
    from spamtree_tpu_torch.ops import kernel_counts
    from spamtree_tpu_torch.utils.summaries import rhat

    c = bench.CONFIGS[cfg_id]
    y, y_full, miss, X, coords, mv = _data(bench, cfg_id)
    ybar = np.nanmean(y)
    with _env(SPAMTREE_LEVEL_KERNELS="1",
              SPAMTREE_COMPOSED_FACTORS="1" if composed else "0"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        fit = prepare_fit(y - ybar, X, coords, mv_id=mv, cell_size=25,
                          mcmc=dict(keep=keep, burn=burn, thin=thin),
                          settings=dict(chunk=200), seed=1, device="cuda",
                          n_chains=C, **c["kwargs"])
        setup = time.time() - t0
        ms = fit.ms
        L = len(ms.levels)
        compose = {t: composed and core._compose_children(ms, t)
                   for t in range(L) if ms.level_is_ref[t]}
        k4_lvls = [t for t in range(L) if not ms.level_is_ref[t]
                   and ms.levels[t].prows.shape[1] > 0
                   and ms.level_chunks[t] == 1 and ms.level_group_c[t] <= 1
                   and ms.levels[t].prows.shape[1] <= level.MAX_P
                   and ms.levels[t].rows.shape[1] <= level.MAX_S
                   and not compose[ms.level_lp[t]]]
        k1_chunks = sum(ms.level_chunks[t] for t in range(L)
                        if ms.level_is_ref[t]
                        and ms.levels[t].rows.shape[1] <= chol.MAX_S)
        start = kernel_counts.snapshot()
        res = run_mcmc_chains(ms, fit.bounds,
                              fit.cfg._replace(accept_aware=True), fit.state,
                              fit.gen, yhat_seed=1)
        counts = kernel_counts.diff(start)
    iters = res["burn_actual"] + keep * thin
    mo = miss[fit.order]
    sd = float(np.nanstd(y_full))
    rmspe = [float(np.sqrt(np.mean(((res["yhat"][:, k].mean(0) + ybar)[mo]
                                    - y_full[fit.order][mo]) ** 2)))
             for k in range(C)]
    acc = np.asarray(res["accept_by_chain"])
    th_rhat = np.asarray(rhat(res["theta"]))
    rec = dict(phase="chains_accept_aware", config=c["name"], chains=C,
               composed=composed, n=len(y), iters=iters, keep=keep,
               burn=burn, thin=thin,
               chain_it_per_s=C * iters / res["mcmc_time"],
               ms_per_iter=1e3 * res["mcmc_time"] / iters,
               mcmc_time=res["mcmc_time"], setup_time=setup, rmspe=rmspe,
               sd_y=sd, accept_by_chain=acc.tolist(), **counts,
               k1_per_iter=counts["k1_launches"] / iters,
               k4_per_iter=counts["k4_launches"] / iters,
               k4_levels=len(k4_lvls), k1_level_chunks=k1_chunks,
               thin_levels=_level_shapes(ms.levels[t] for t in range(L)
                                         if not ms.level_is_ref[t]),
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               theta_rhat=th_rhat.tolist())
    print(json.dumps(rec), flush=True)
    what = f"config {cfg_id} accept-aware C={C} composed={composed}"
    for k in ("w", "yhat", "beta", "tausq", "theta"):
        _check(res[k].size and np.isfinite(res[k]).all(),
               f"{what}: finite {k}")
    _check(res["yhat"].shape == (keep, C, len(y)), f"{what}: yhat shape")
    for k in range(C):
        _check(rmspe[k] < 0.5 * sd, f"{what}, chain {k}: RMSPE {rmspe[k]} "
               f">= 0.5 sd(y) {sd}")
        _check(0.05 < acc[k] < 0.8,
               f"{what}, chain {k}: acceptance {acc[k]} outside (0.05, 0.8)")
    _check(np.isfinite(th_rhat).all(), f"{what}: theta_rhat {th_rhat}")
    _check(k1_chunks > 0 and counts["k1_launches"] == 3 * k1_chunks * iters,
           f"{what}: K1 launches {counts['k1_launches']} != 3 x "
           f"{k1_chunks} reference level chunks x {iters} its")
    _check(counts["k4_launches"] == len(k4_lvls) * iters,
           f"{what}: K4 launches {counts['k4_launches']} != "
           f"{len(k4_lvls)} thin levels x {iters} its")
    _check(composed or k4_lvls, f"{what}: no thin level takes K4")
    _check(counts["k3_launches"] == 0, f"{what}: K3 launched")
    return rec


def accept_aware_chains_phase(bench, chol, level, torch, ch):
    """Phase 18: K4 folded over K4_FOLD_C chains against its plain version
    and timed, then the accept-aware batched step at AA_CHAIN_RUNS, each
    beside the always-emit batched run at the same C: phase 16's (``ch``,
    where it ran), else one run here; K1's launches per iteration must not
    change with C."""
    _phase(f"accept-aware chains: K4 folded over {K4_FOLD_C} chains")
    err = check_folded_k4(level, torch)
    times = time_folded_k4(level, torch)
    runs = {}
    for cfg_id, C, composed in AA_CHAIN_RUNS:
        _phase(f"accept-aware chains: config {cfg_id}, n_chains={C}, "
               f"composed factors {composed}")
        runs[(cfg_id, C, composed)] = run_chains_accept_aware(
            bench, chol, level, torch, cfg_id, C, composed,
            **AA_DEPTH[cfg_id])
    # the always-emit batched runs beside them: phase 16's, and config 4's
    # at its own depth here
    beside = dict((ch or {}).get("runs", {}))
    for cfg_id, C, _ in AA_CHAIN_RUNS:
        if (cfg_id, C) not in beside:
            _phase(f"chains: config {cfg_id}, n_chains={C}, always-emit")
            beside[(cfg_id, C)] = run_chains(bench, torch,
                                             cfg_id, C, **AA_DEPTH[cfg_id])
    for cfg_id, composed in {(i, comp) for i, _, comp in AA_CHAIN_RUNS}:
        k1 = {C: r["k1_per_iter"] for (i, C, comp), r in runs.items()
              if (i, comp) == (cfg_id, composed)}
        _check(len(set(k1.values())) == 1,
               f"config {cfg_id} composed={composed}: K1 launches per "
               f"iteration by chain count {k1}")
    for (cfg_id, C, composed), r in runs.items():
        ae = beside[(cfg_id, C)]
        print(f"accept-aware chains table: config {cfg_id} C={C} composed="
              f"{composed}: {r['chain_it_per_s']:.2f} chain-it/s, "
              f"{r['ms_per_iter']:.2f} ms/it, K1 {r['k1_per_iter']:.2f}/it, "
              f"K4 {r['k4_per_iter']:.2f}/it, peak "
              f"{r['peak_mem_bytes'] / 1e9:.2f} GB, accept "
              f"{np.round(r['accept_by_chain'], 3).tolist()}; always-emit "
              f"({ae['iters']} its) {ae['chain_it_per_s']:.2f} chain-it/s, "
              f"{ae['ms_per_iter']:.2f} ms/it, peak "
              f"{ae['peak_mem_bytes'] / 1e9:.2f} GB, accept "
              f"{np.round(ae['accept_by_chain'], 3).tolist()}", flush=True)
    return dict(err=err, times=times, runs=runs,
                beside={k: v for k, v in beside.items()
                        if k not in (ch or {}).get("runs", {})})


# -- phase 17: multi-device sampling ----------------------------------------

# one-process runs that phase 17 reads, kept by run_config and run_chains:
# (config, chains, keep, burn, thin) -> draws
_ONE_PROCESS: dict = {}
_DRAW_KEYS = ("w_mcmc", "beta_mcmc", "tausq_mcmc", "theta_mcmc")
# a mesh run against its one-process run, max |d| <= tol x max |ref|: f32
# over a step or a chain; the w draws cross to the host as float16 (one
# ulp 2^-11 to 2^-10 of the value)
MESH_TOL = dict(w_mcmc=4e-3, beta_mcmc=1e-3, tausq_mcmc=1e-3,
                theta_mcmc=1e-3, step=1e-3)
# steps of each kind in phase 17b's step check
STEP_ITERS = 4
# the one run whose f32 chain may part from its one-process run (see
# _mesh_agrees): the gap between the two chains' theta means, pooled over
# the parameters, against the spread between the one-process run's
# SPREAD_C chains; under one parameter the ratio squared is F(1, 3), whose
# 0.99 quantile is 34.1 = 5.84 squared
SPREAD_C = 4
SPREAD_GATE = 6.0
# (config, keep, burn, thin) of phase 17's runs: phase 5's and phase 16's
# depths for the blocks mesh, held to those phases' one-process runs (a
# parting f32 chain to phase 16's four chains); shorter runs under the
# deterministic algorithms, which cost 1.3-1.9x (each mesh run beside its
# own one-process run, and the whole smoke run must stay inside its
# limit)
DEPTH3 = (3, 100, 200, 2)
DEPTH1 = (1, 150, 150, 2)
SHORT3 = (3, 25, 50, 2)
DEVICES1 = (1, 25, 25, 2)


def _yhat_means(out, C):
    """(C, n) posterior mean yhat of each chain of a spamtree output."""
    yh = out["yhat_mcmc"].mean(0)
    return yh[None] if C == 1 else yh


def _keep_draws(cfg_id, C, keep, burn, thin, out):
    _ONE_PROCESS[(cfg_id, C, keep, burn, thin)] = dict(
        {k: out[k] for k in _DRAW_KEYS}, yhat_mean=_yhat_means(out, C),
        order=out["order"], ms_per_iter=1e3 * out["mcmc_time"] / (
            out["burn_actual"] + keep * thin))


def _one_process(bench, cfg_id, C, keep, burn, thin):
    """The one-process run's draws at this depth: phase 5's or phase 16's,
    or run now (``--mesh``)."""
    import spamtree_tpu_torch

    key = (cfg_id, C, keep, burn, thin)
    if key not in _ONE_PROCESS:
        y, _, _, X, coords, mv = _data(bench, cfg_id)
        out = spamtree_tpu_torch.spamtree(
            y - np.nanmean(y), X, coords, mv_id=mv, cell_size=25,
            mcmc=dict(keep=keep, burn=burn, thin=thin),
            settings=dict(chunk=200), seed=1, device="cuda", n_chains=C)
        _keep_draws(*key, out)
    return _ONE_PROCESS[key]


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not ref.size:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _rmspe(bench, cfg_id, yhat_mean, order):
    """Held-out RMSPE of each chain's (C, n) posterior mean yhat."""
    y, y_full, miss, *_ = _data(bench, cfg_id)
    ybar = np.nanmean(y)
    mo = miss[order]
    return [float(np.sqrt(np.mean(((m + ybar)[mo] - y_full[order][mo]) ** 2)))
            for m in yhat_mean]


def _check_fit(bench, cfg_id, out, k1, thin, C, what):
    """Phase 5's checks on a spamtree output (chains: per chain, and a
    finite theta_rhat): finite draws, RMSPE < 0.5 sd(y) on the held-out
    rows, acceptance in (0.05, 0.8), K1 launched on every reference level
    with S <= ``chol.MAX_S`` of every iteration (``k1``: one rank's
    launches).
    Returns (RMSPE per chain, iterations)."""
    y, y_full, *_ = _data(bench, cfg_id)
    iters = out["burn_actual"] + out["w_mcmc"].shape[0] * thin
    yhat = out["yhat_mcmc"][:, None] if C == 1 else out["yhat_mcmc"]
    acc = (np.array([out["accept_ratio"]]) if C == 1
           else np.asarray(out["accept_by_chain"]))
    sd = float(np.nanstd(y_full))
    rmspe = _rmspe(bench, cfg_id, _yhat_means(out, C), out["order"])
    for k in ("w_mcmc", "yhat_mcmc", "beta_mcmc", "tausq_mcmc", "theta_mcmc"):
        _check(out[k].size and np.isfinite(out[k]).all(), f"{what}: finite {k}")
    _check(yhat.shape[1:] == (C, len(y)), f"{what}: yhat shape {yhat.shape}")
    for k in range(C):
        _check(rmspe[k] < 0.5 * sd,
               f"{what} chain {k}: RMSPE {rmspe[k]} >= 0.5 sd(y) {sd}")
        _check(0.05 < acc[k] < 0.8,
               f"{what} chain {k}: acceptance {acc[k]} outside (0.05, 0.8)")
    _check(C == 1 or np.isfinite(out["theta_rhat"]).all(),
           f"{what}: theta_rhat {out.get('theta_rhat')}")
    n_ref = out["n_ref"]
    _check(n_ref > 0 and k1 >= 2 * n_ref * iters,
           f"{what}: K1 launches {k1} < 2 x {n_ref} ref levels x {iters} its")
    return rmspe, iters


def _theta_kc(out, C):
    """(keep, C, n_theta) theta draws of a spamtree output."""
    th = np.asarray(out["theta_mcmc"], np.float64)
    return th.T[:, None] if C == 1 else th


def _mesh_agrees(bench, cfg_id, C, got, ref, what, spread=None):
    """A mesh run's draws against its one-process run's: max |d| / max
    |ref| of w, beta, tausq and theta within MESH_TOL, or the check fails.  With ``spread`` (the
    draws of a one-process run of SPREAD_C chains) the two chains may
    part -- where an accept decision, u < p, falls inside the f32 rounding
    of log p, which a blocks mesh's sums in another order move; the float64
    run of the same mesh shows that this is all that parts them -- and
    then the kept draw where theta first parts is printed, and the gap
    between the two chains' theta means, over the parameters in units of
    each one's within-chain sd, must be within SPREAD_GATE times the
    spread of the SPREAD_C chains' means, and each chain's held-out RMSPE
    within 5 % of the one-process chain's.  Returns the record."""
    errs = {k: _rel_err(got[k], ref[k]) for k in _DRAW_KEYS}
    same = all(np.array_equal(got[k], ref[k]) for k in _DRAW_KEYS)
    rec = dict(errs=errs, same_bits=same, parted_at_kept_draw=None)
    print(f"{what} against the one-process run: max |d| / max |ref| "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}"
          f"{' (the same bits)' if same else ''}", flush=True)
    if all(e <= MESH_TOL[k] for k, e in errs.items()):
        return rec
    _check(spread is not None, f"{what}: the draws differ from the "
           f"one-process run's beyond f32 tolerance {MESH_TOL}: {errs}")
    th = [_theta_kc(o, C) for o in (got, ref)]
    d = (np.abs(th[0] - th[1]).max(axis=(1, 2)) / np.abs(th[1]).max())
    rec["parted_at_kept_draw"] = int(np.argmax(d > MESH_TOL["theta_mcmc"]))
    ths = _theta_kc(spread, SPREAD_C)
    within = np.sqrt(ths.var(0).mean(0))  # (n_theta,)
    between = ths.mean(0).var(0, ddof=1)  # var of the chains' means
    live = within > 0
    gap = (th[0].mean(0) - th[1].mean(0))[:, live] / within[live]
    rec["theta_gap_over_spread"] = float(np.sqrt(
        (gap ** 2).sum(1).max()
        / (2 * between[live] / within[live] ** 2).sum()))
    rm = [_rmspe(bench, cfg_id, o, got["order"]) for o in (
        _yhat_means(got, C), ref["yhat_mean"])]
    rec["rmspe_mesh_one"] = rm
    print(f"{what}: the chains parted at kept draw "
          f"{rec['parted_at_kept_draw']}; theta means apart by "
          f"{rec['theta_gap_over_spread']:.2f} x the spread of the "
          f"one-process run's {SPREAD_C} chains (gate {SPREAD_GATE}); "
          f"held-out RMSPE {rm[0]} (mesh) / {rm[1]} (one process)",
          flush=True)
    _check(rec["theta_gap_over_spread"] <= SPREAD_GATE,
           f"{what}: theta means apart by {rec['theta_gap_over_spread']} x "
           f"the one-process chains' spread")
    _check(all(abs(a - b) <= 0.05 * b for a, b in zip(*rm)),
           f"{what}: RMSPE {rm[0]} against the one process's {rm[1]}")
    return rec


def _window(torch, bench, cfg_id, C, mesh=None, iters=5):
    """Host ms per iteration of the step (``thin=2``: predicting every
    other iteration; untraced, synchronised) and device-busy ms per
    iteration under torch.profiler, after three warm-up iterations, from
    the start ``spamtree`` makes at a fixed proposal (no tuner), on this
    rank of ``mesh``."""
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model.core import level_coords, tausq_shape
    from spamtree_tpu_torch.model.mcmc import (
        draw_chains,
        draw_step,
        make_step,
    )

    y, _, _, X, coords, mv = _data(bench, cfg_id)
    fit = prepare_fit(y - np.nanmean(y), X, coords, mv_id=mv, cell_size=25,
                      mcmc=dict(keep=1, burn=0), settings=dict(mcmcsd=1e-4),
                      seed=1, device="cuda", n_chains=C, mesh=mesh)
    ms = fit.ms
    step = make_step(ms, fit.bounds, fit.cfg, coords_cache=level_coords(ms),
                     chains=C > 1)
    nt = fit.state.theta.shape[-1]
    shape = tausq_shape(ms, fit.cfg.tausq_ab)
    draw = draw_chains if C > 1 else draw_step
    state = fit.state

    def run(k):
        nonlocal state
        for i in range(k):
            state = step(state, draw(ms, fit.gen, nt, shape), i % 2 == 1)
        torch.cuda.synchronize()

    run(3)
    t0 = time.time()
    run(iters)
    ms_it = 1e3 * (time.time() - t0) / iters
    busy = _trace_ops(torch, run, iters)["busy"]
    return dict(ms_per_iter=ms_it, busy_ms_per_iter=busy,
                idle=1.0 - busy / ms_it)


def _lean(out):
    """What phase 17 reads of a spamtree output (crosses from a worker)."""
    keep = _DRAW_KEYS + ("yhat_mcmc", "order", "accept_ratio", "burn_actual",
                         "mcmc_time", "iter_s", "setup_breakdown",
                         "accept_by_chain", "theta_rhat", "graph_replays")
    from spamtree_tpu_torch.ops.chol import MAX_S

    lean = {k: out[k] for k in keep if k in out}
    lean["n_ref"] = sum(1 for p in out["schedule"].levels
                        if p.is_ref and p.S <= MAX_S)
    return lean


def _rank_tensor(mesh, torch, values):
    """Every rank's ``values`` (a list of numbers), in rank order."""
    t = torch.tensor([values], dtype=torch.float64, device=mesh.device)
    return mesh.cat_chains(mesh.cat_blocks(t)).tolist()


def _mesh_step(mesh, cfg_id):
    """Phase 17b's step check, on a mesh rank: STEP_ITERS always-emit
    steps and STEP_ITERS accept-aware steps (level kernels on, no composed
    factor parts) of config ``cfg_id`` from spamtree's start at a narrow
    proposal (sd 1e-12: wider ones were refused at every step or most at
    config 3's start), RAM adaptation off, the draws from one seeded
    generator with every accept draw u = 0: every proposal installs on
    both sides, so no accept decision can fall inside the rounding, and
    the accept-aware step's rebuild runs at every step while w walks
    through STEP_ITERS Gibbs updates; on this rank's shards, with each
    rank's K1/K3/K4 launches per kind.  Rank 0 then runs the same steps
    unsharded from the same start and draws and returns, per kind, the
    largest max |d| / max |ref| over the steps of w, theta and logdet, and
    of every level's H and prec after the last step (the padding's dummy
    blocks cut off), and both sides' accepts."""
    import torch

    from spamtree_tpu_torch import bench
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model.core import level_coords, tausq_shape
    from spamtree_tpu_torch.model.mcmc import draw_step, make_step
    from spamtree_tpu_torch.ops import kernel_counts

    y, _, _, X, coords, mv = _data(bench, cfg_id)
    kw = dict(mv_id=mv, cell_size=25, mcmc=dict(keep=1, burn=0),
              settings=dict(mcmcsd=1e-12), seed=1, device=mesh.device)

    def walk(fit, accept_aware):
        cfg = fit.cfg._replace(accept_aware=accept_aware, adapting=False)
        step = make_step(fit.ms, fit.bounds, cfg,
                         coords_cache=level_coords(fit.ms))
        gen = torch.Generator(device=fit.ms.device).manual_seed(7)
        nt = fit.state.theta.shape[0]
        shape = tausq_shape(fit.ms, cfg.tausq_ab)
        st, trail = fit.state, []
        for _ in range(STEP_ITERS):
            d = draw_step(fit.ms, gen, nt, shape)
            st = step(st, d._replace(u=torch.zeros_like(d.u)), True)
            trail.append([x.detach().clone().cpu()
                          for x in (st.w, st.theta, st.logdetCi)])
        return st, trail

    got, counts = {}, {}
    with _env(SPAMTREE_LEVEL_KERNELS="1", SPAMTREE_COMPOSED_FACTORS="0"):
        fit = prepare_fit(y - np.nanmean(y), X, coords, mesh=mesh, **kw)
        for aa in (False, True):
            start = kernel_counts.snapshot()
            st, trail = walk(fit, aa)
            torch.cuda.synchronize()
            counts[aa] = _rank_tensor(mesh, torch, list(
                kernel_counts.diff(start).values()))
            got[aa] = (st, trail, [(mesh.cat_blocks(d.H),
                                    mesh.cat_blocks(d.prec))
                                   for d in st.leveldata])
        if mesh.rank != 0:
            return None
        ref = prepare_fit(y - np.nanmean(y), X, coords, **kw)
        errs = {}
        for aa in (False, True):
            st_r, trail_r = walk(ref, aa)
            st, trail, ld = got[aa]
            e = {k: max(_rel_err(a[i], b[i]) for a, b in zip(trail, trail_r))
                 for i, k in enumerate(("w", "theta", "logdet"))}
            e["accepted"] = [float(st.ram.accept_count),
                             float(st_r.ram.accept_count)]
            for t, ((H, prec), d) in enumerate(zip(ld, st_r.leveldata)):
                B = d.H.shape[0]
                e[f"H{t}"] = _rel_err(H[:B].cpu(), d.H.cpu())
                e[f"prec{t}"] = _rel_err(prec[:B].cpu(), d.prec.cpu())
            errs["accept_aware" if aa else "always_emit"] = e
    names = list(kernel_counts.snapshot())
    return dict(errs=errs, launches={
        ("accept_aware" if aa else "always_emit"): [
            dict(zip(names, map(int, r))) for r in c]
        for aa, c in counts.items()})


def _reference(mesh, y, X, coords, C, kw):
    """The one-process run a mesh run is held to, in this worker: on a
    mesh without a chains axis, rank 0 runs spamtree(n_chains=C) alone
    (the others wait at the next collective); on a chains axis, every
    chains rank runs its own chains alone -- spamtree's tuned start, then
    run_mcmc_chains with chain c's generator seeded seed + c, the batched
    step at the chain count of the rank -- and the draws are gathered over
    the chains ranks, so chain c of the mesh run is held to chain c run
    through the same numerics in one process.  Returns rank 0's draws
    (as spamtree lays them out) and ms per iteration."""
    import torch

    import spamtree_tpu_torch
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model.mcmc import run_mcmc_chains, stack_chain_states

    m = kw["mcmc"]
    iters = m["burn"] + m["keep"] * m["thin"]
    if mesh.n_chains == 1:
        if mesh.rank != 0:
            return None
        out = spamtree_tpu_torch.spamtree(y, X, coords, n_chains=C,
                                          device=mesh.device, **kw)
        return dict({k: out[k] for k in _DRAW_KEYS},
                    yhat_mean=_yhat_means(out, C),
                    ms_per_iter=1e3 * out["mcmc_time"] / iters)
    fit = prepare_fit(y, X, coords, device=mesh.device, **kw)
    own = C // mesh.n_chains
    c0 = mesh.chain_rank * own
    states, gens = stack_chain_states(fit.state,
                                      kw["seed"] + c0 + np.arange(own))
    res = run_mcmc_chains(fit.ms, fit.bounds, fit.cfg, states, gens,
                          yhat_seed=kw["seed"])
    draws = {k: mesh.cat_chains(torch.from_numpy(np.ascontiguousarray(
        res[k.removesuffix("_mcmc")])).to(mesh.device), 1).cpu().numpy()
        for k in _DRAW_KEYS}
    return (dict(draws, ms_per_iter=1e3 * res["mcmc_time"] / iters)
            if mesh.rank == 0 else None)


def _count_gathers(mesh):
    """Wrap ``mesh``'s collectives to count them: returns the count's
    one-element list."""
    calls, gather = [0], mesh._gather

    def counted(*a, **k):
        calls[0] += 1
        return gather(*a, **k)

    mesh._gather = counted
    return calls


def _count_replayed(gathers):
    """Wrap the graphs (``model.graph.Graph``) so that each capture keeps
    the all-gathers it issued (counted in ``gathers``) and each replay adds
    them to the returned one-element list: the all-gathers replayed from
    the graphs."""
    from spamtree_tpu_torch.model.graph import Graph

    replayed, init, replay = [0], Graph.__init__, Graph.replay

    def counted_init(self, *a, **k):
        g0 = gathers[0]
        init(self, *a, **k)
        self.gathers = gathers[0] - g0

    def counted_replay(self):
        replay(self)
        replayed[0] += self.gathers

    Graph.__init__ = counted_init
    Graph.replay = counted_replay
    return replayed


def _mesh_graphs(mesh, cfg_id):
    """Phase 17a's graphs on this rank of an NCCL mesh: config ``cfg_id``
    prepared once on the mesh and once in this process alone; for each
    theta step (accept-aware with the level kernels on and no composed
    factor parts: K1, K3 and K4 launch) the mesh's chain
    eager and graphed at GRAPH_DEPTH from the same seeds (``_graph_pair``),
    graphed once more under deterministic algorithms, and the one
    process's graphed chain: all the same bits, the same launches per
    iteration, 2-4 replays an iteration.  Then windows of GRAPH_WINDOW iterations from
    one seed (``_graph_window``): the mesh graphed and eager and the one
    process graphed, with the all-gathers an iteration that the eager
    mesh window calls and that the graphed one replays from its graphs
    (``_count_replayed``).  Returns the record."""
    import torch

    from spamtree_tpu_torch import bench
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.ops import chol, level

    y, _, _, X, coords, mv = _data(bench, cfg_id)
    kw = dict(mv_id=mv, cell_size=25, mcmc=GRAPH_DEPTH, seed=1,
              settings=dict(chunk=10, wire_dtype="none"), device=mesh.device)
    fits = {"mesh": prepare_fit(y - np.nanmean(y), X, coords, mesh=mesh,
                                **kw),
            "one": prepare_fit(y - np.nanmean(y), X, coords, **kw)}
    gathers = _count_gathers(mesh)
    replayed = _count_replayed(gathers)
    rec = {}
    for aa in (False, True):
        step = "accept_aware" if aa else "always_emit"
        cfg = {k: f.cfg._replace(accept_aware=aa) for k, f in fits.items()}
        # accept-aware: the level kernels on and no composed factor parts,
        # so that K1, K3 and K4 all launch
        with _env(SPAMTREE_LEVEL_KERNELS="1" if aa else "0",
                  SPAMTREE_COMPOSED_FACTORS="0" if aa else "1"):
            pair = _graph_pair(fits["mesh"], cfg["mesh"], 0, torch)
            one = _graph_pair(fits["one"], cfg["one"], 0, torch,
                              paths=(True,))[True]
            with _deterministic(torch):
                det = _graph_pair(fits["mesh"], cfg["mesh"], 0, torch,
                                  paths=(True,))[True]
            win = {}
            for name, fit_key, graphs in (("graphed", "mesh", True),
                                          ("eager", "mesh", False),
                                          ("one_process", "one", True)):
                win[name] = _graph_window(
                    torch, fits[fit_key], cfg[fit_key], 0, graphs,
                    count=lambda g=graphs: replayed[0] if g else gathers[0],
                    seed=21)
        g, e = pair[True], pair[False]
        iters = e["res"]["burn_actual"] + GRAPH_DEPTH["keep"] * GRAPH_DEPTH[
            "thin"]
        same = {"graphed_eager": _same_chain(e["res"], g["res"]),
                "graphed_one_process": _same_chain(one["res"], g["res"]),
                "det_graphed_graphed": _same_chain(g["res"], det["res"])}
        rec[step] = dict(
            iters=iters, same_bits={k: v[0] for k, v in same.items()},
            differs_in={k: v[1] for k, v in same.items() if not v[0]},
            launches_per_iter={k: {p: r["counts"][k] / iters for p, r in (
                ("eager", e), ("graphed", g), ("one_process", one),
                ("det_graphed", det))}
                for k in ("k1_launches", "k3_launches", "k4_launches")},
            replays_per_iter_run=g["res"]["graph_replays"] / iters,
            capture_s=g["res"]["compile_time_s"],
            peak_gb={"graphed": g["peak"] / 1e9, "eager": e["peak"] / 1e9,
                     "one_process_graphed": one["peak"] / 1e9},
            accept=e["res"]["accept_ratio"], window=win)
    return rec


def _gloo_refusal(mesh):
    """graphs=True on this gloo rank's CUDA model (config 1, a chain per
    chains rank): the error it raises, or None."""
    from spamtree_tpu_torch import bench
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model.mcmc import run_mcmc, run_mcmc_chains

    y, _, _, X, coords, mv = _data(bench, 1)
    C = mesh.n_chains
    fit = prepare_fit(y - np.nanmean(y), X, coords, mv_id=mv, cell_size=25,
                      mcmc=dict(keep=2, burn=0), seed=1, device=mesh.device,
                      mesh=mesh, n_chains=C)
    try:
        (run_mcmc_chains if C > 1 else run_mcmc)(
            fit.ms, fit.bounds, fit.cfg, fit.state, fit.gen, graphs=True)
    except ValueError as e:
        return str(e)
    return None


def mesh_job(mesh, runs, window_cfg=None, step_cfg=None,
             deterministic=True, graphs_cfg=None):
    """Rank job of phase 17, under torch.use_deterministic_algorithms if
    ``deterministic`` (the launch sets CUBLAS_WORKSPACE_CONFIG; an op
    without a deterministic version warns): ``_mesh_step`` at config
    ``step_cfg`` if given; then for each of ``runs`` ((config, keep, burn,
    thin, n_chains, float64, reference)) spamtree(mesh=...) with each
    rank's K1, K3 and K4 launches and peak device memory, and, where
    ``reference``, its one-process run here (``_reference``; else the
    caller holds it to one of its own); then, with the deterministic
    algorithms off, the step's window (``_window``) at config
    ``window_cfg`` on every rank; then on an NCCL mesh ``_mesh_graphs``
    at config ``graphs_cfg`` if given, and on a gloo mesh
    ``_gloo_refusal``."""
    import torch

    from spamtree_tpu_torch import bench
    import spamtree_tpu_torch
    from spamtree_tpu_torch.ops import kernel_counts

    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    step = None if step_cfg is None else _mesh_step(mesh, step_cfg)
    outs = []
    for cfg_id, keep, burn, thin, C, f64, with_ref in runs:
        y, _, _, X, coords, mv = _data(bench, cfg_id)
        kw = dict(mv_id=mv, cell_size=25,
                  mcmc=dict(keep=keep, burn=burn, thin=thin),
                  settings=dict(chunk=200), seed=1,
                  dtype=torch.float64 if f64 else torch.float32)
        start = kernel_counts.snapshot()
        torch.cuda.reset_peak_memory_stats()
        out = spamtree_tpu_torch.spamtree(y - np.nanmean(y), X, coords,
                                          n_chains=C, mesh=mesh, **kw)
        counted = kernel_counts.diff(start)
        ranks = _rank_tensor(mesh, torch, [
            *counted.values(), torch.cuda.max_memory_allocated()])
        ref = (_reference(mesh, y - np.nanmean(y), X, coords, C, kw)
               if with_ref else None)
        outs.append(dict(out=_lean(out), ref=ref, launches=[
            dict(zip(counted, map(int, r[:-1]))) for r in ranks],
            peak_bytes=[int(r[-1]) for r in ranks]))
    torch.use_deterministic_algorithms(False)
    win = None
    if window_cfg is not None:
        w = _window(torch, bench, window_cfg, runs[-1][4], mesh)
        win = _rank_tensor(mesh, torch, [w["ms_per_iter"],
                                         w["busy_ms_per_iter"], w["idle"]])
    graphs = refusal = None
    if mesh.backend == "nccl" and graphs_cfg is not None:
        graphs = _mesh_graphs(mesh, graphs_cfg)
    if mesh.backend == "gloo":
        refusal = _gloo_refusal(mesh)
    return (dict(step=step, runs=outs, window=win, graphs=graphs,
                 refusal=refusal) if mesh.rank == 0 else None)


def _mesh_launch(devices, runs, **kw):
    """mesh_job on one worker per device, with cuBLAS set up for the
    deterministic algorithms (NCCL for one device, else gloo)."""
    from spamtree_tpu_torch.parallel.launch import launch

    root = os.path.dirname(os.path.abspath(__file__))
    with _env(CUBLAS_WORKSPACE_CONFIG=":4096:8"):
        return launch("chip_smoke:mesh_job", dict(runs=runs, **{
            k: v for k, v in kw.items() if k != "n_chains"}), devices,
            n_chains=kw.get("n_chains", 1),
            backend="nccl" if len(devices) == 1 else "gloo", path=[root],
            timeout=900)


def _mesh_runs(bench, tag, shape, runs, res, info, one, spread,
               deterministic=True):
    """Phase 5's checks and ``_mesh_agrees`` on each of a mesh job's runs,
    against the job's own one-process run or else this process's (phase
    5's or 16's, ``_one_process``); the records (``one``: the one-process
    windows by chain count)."""
    recs = {}
    for (cfg_id, keep, burn, thin, C, f64, _), r in zip(runs, res["runs"]):
        what = (f"mesh ({tag}) config {cfg_id} n_chains={C}"
                f"{' float64' if f64 else ''}")
        out, ref = r["out"], r["ref"]
        if ref is None:
            ref = _one_process(bench, cfg_id, C, keep, burn, thin)
        k1 = [x["k1_launches"] for x in r["launches"]]
        rmspe, iters = _check_fit(bench, cfg_id, out, min(k1), thin, C, what)
        ref.setdefault("yhat_mean", None)
        errs = _mesh_agrees(bench, cfg_id, C, out, ref, what, spread=(
            spread if (cfg_id, keep, burn, thin, f64) == (*DEPTH3, False)
            and shape == [1, 2] else None))
        win = res["window"] if cfg_id == 3 and not f64 else None
        key = f"{tag}_config{cfg_id}{'_f64' if f64 else ''}"
        recs[key] = dict(
            phase=f"mesh_{tag}", config=cfg_id, mesh=shape,
            backend="nccl" if shape == [1, 1] else "gloo", chains=C,
            float64=f64, iters=iters, deterministic_algorithms=deterministic,
            ms_per_iter=1e3 * out["mcmc_time"] / iters,
            chain_it_per_s=C * iters / out["mcmc_time"],
            one_process_ms_per_iter=ref["ms_per_iter"],
            rmspe=rmspe, accept=out["accept_ratio"],
            launches_by_rank=r["launches"],
            k1_per_iter=[k / iters for k in k1],
            peak_bytes_by_rank=r["peak_bytes"], errs=errs,
            window_by_rank=win,
            one_process_window=one.get(C) if win else None,
            workers_start_s=info["start_s"],
            setup_breakdown=out["setup_breakdown"],
            graph_replays=out["graph_replays"])
        print(json.dumps(recs[key]), flush=True)
        graphed = out["graph_replays"] > 0
        print(f"{what}: ran {'graphed' if graphed else 'eager'} "
              f"({out['graph_replays']} graph replays)", flush=True)
        _check(graphed == (shape == [1, 1]), f"{what}: "
               f"{out['graph_replays']} graph replays on a "
               f"{'NCCL' if shape == [1, 1] else 'gloo'} mesh")
    return recs


def _gloo_refused(tag, res):
    """graphs=True on the gloo ranks of (``tag``) raised the named error."""
    msg = res["refusal"]
    print(f"mesh ({tag}): graphs=True on a gloo rank raised: {msg}",
          flush=True)
    _check(msg is not None and "gloo stages CUDA tensors through host "
           "memory" in msg, f"mesh ({tag}): graphs=True on a gloo rank "
           f"gave {msg!r}")


def _mesh_graphs_checks(rec):
    """Phase 17a's graph checks on ``_mesh_graphs``' record: every chain
    the same bits, the same launches per iteration, 2-4 replays an
    iteration, and the eager window's all-gathers replayed from the
    graphed window's graphs, none called (a one-rank NCCL communicator
    copies rather than launch a kernel, so the trace's NCCL kernels are
    printed, not checked); the table line of each step."""
    for step, r in rec.items():
        what = f"mesh (a) graphs, config 3, {step}"
        print(json.dumps(dict(phase="mesh_a_graphs", step=step, **r)),
              flush=True)
        wg, we, wo = (r["window"][k] for k in ("graphed", "eager",
                                               "one_process"))
        gathers, replayed = we["counted_per_iter"], wg["counted_per_iter"]
        print(f"mesh graphs table: config 3 {step}, one NCCL rank: graphed "
              f"{wg['ms_per_iter']:.2f} ms/it (busy "
              f"{wg['busy_ms_per_iter']:.2f}, idle {wg['idle']:.3f}, "
              f"{wg['replays_per_iter']:.2f} replays and "
              f"{wg['kernels_per_iter']:.1f} nodes an iteration, NCCL "
              f"kernels {wg['nccl_kernels_per_iter']:.1f} and all-gathers "
              f"{replayed:.2f} replayed an iteration, capture "
              f"{r['capture_s']:.2f} s, peak {r['peak_gb']['graphed']:.2f} "
              f"GB); eager {we['ms_per_iter']:.2f} ms/it (busy "
              f"{we['busy_ms_per_iter']:.2f}, idle {we['idle']:.3f}, "
              f"{gathers:.2f} all-gathers an iteration, peak "
              f"{r['peak_gb']['eager']:.2f} GB); one process graphed "
              f"{wo['ms_per_iter']:.2f} ms/it (busy "
              f"{wo['busy_ms_per_iter']:.2f}, idle {wo['idle']:.3f}, peak "
              f"{r['peak_gb']['one_process_graphed']:.2f} GB)", flush=True)
        _check(all(r["same_bits"].values()),
               f"{what}: the chains differ: {r['differs_in']}")
        for k, v in r["launches_per_iter"].items():
            _check(len(set(v.values())) == 1, f"{what}: {k} per iteration "
                   f"{v}")
        lp = {k: v["graphed"] for k, v in r["launches_per_iter"].items()}
        _check(lp["k1_launches"] > 0 and (step == "always_emit" or (
            lp["k3_launches"] > 0 and lp["k4_launches"] > 0)),
               f"{what}: launches {r['launches_per_iter']}")
        reps = r["replays_per_iter_run"]
        _check(2.0 <= reps <= 4.0, f"{what}: {reps} replays an iteration")
        _check(gathers > 0 and replayed == gathers, f"{what}: {gathers} "
               f"all-gathers an iteration eager, {replayed} replayed from "
               f"the graphs")
    return rec


def mesh_phase(bench, torch):
    """Phase 17: (a) config 3 (SHORT3) through spamtree(mesh=...) on a
    one-rank NCCL mesh, graphed, then that rank's graphed-against-eager
    check (``_mesh_graphs``), and config 1 (DEVICES1) through
    spamtree(devices=["cuda:0"]); (b) two gloo ranks on the one card, a
    (1, 2) blocks mesh:
    the step check (``_mesh_step``), then config 1 (phase 16's depth),
    config 3 at phase 5's depth, both held to those phases' runs, and
    config 3 in float64 (SHORT3); (c) two gloo ranks, a (2, 1) chains
    mesh: config 3 (SHORT3) with n_chains=2.  (a) and (c) and their
    one-process runs (``_reference``) run under deterministic algorithms,
    where they must give the same bits; every run meets
    phase 5's checks (per chain) and ``_mesh_agrees``, and each rank
    launches K1 on its shard of every reference level of every iteration;
    the accept-aware steps launch K3 and K4 on each rank; the NCCL runs
    replay graphs, the gloo runs none, and graphs=True on a gloo rank
    raises.  Prints each mesh run's ms per iteration, chain-iterations per
    second, idle share and peak memory per rank beside the one-process
    run's.  Returns the records."""
    import spamtree_tpu_torch

    rec = {}

    _phase("mesh (a): config 3, spamtree(mesh=...) on one NCCL rank; "
           "config 1, spamtree(devices=['cuda:0'])")
    runs_a = [(*SHORT3, 1, False, True)]
    res_a, info_a = _mesh_launch(["cuda:0"], runs_a, graphs_cfg=3)
    rec |= _mesh_runs(bench, "a", [1, 1], runs_a, res_a, info_a, {}, None)
    rec["a_graphs"] = _mesh_graphs_checks(res_a["graphs"])
    y, _, _, X, coords, mv = _data(bench, 1)
    t0 = time.time()
    out = spamtree_tpu_torch.spamtree(
        y - np.nanmean(y), X, coords, mv_id=mv, cell_size=25,
        mcmc=dict(zip(("keep", "burn", "thin"), DEVICES1[1:])),
        settings=dict(chunk=200),
        seed=1, devices=["cuda:0"])
    _check(out["mesh"] == dict(devices=["cuda:0"], chains=1, blocks=1),
           f"mesh (a): devices= built {out['mesh']}")
    print(f"mesh (a) config 1 through devices=: {out['graph_replays']} "
          f"graph replays", flush=True)
    _check(out["graph_replays"] > 0, "mesh (a) config 1 through devices=: "
           "no graph replayed")
    errs = _mesh_agrees(bench, 1, 1, _lean(out),
                        _one_process(bench, 1, 1, *DEVICES1[1:]),
                        "mesh (a) config 1 through devices=")
    rec["a_devices_config1"] = dict(
        phase="mesh_a_devices", config=1, wall_s=time.time() - t0,
        errs=errs, setup_breakdown=out["setup_breakdown"],
        graph_replays=out["graph_replays"])
    print(json.dumps(rec["a_devices_config1"]), flush=True)

    _phase("mesh (b): two gloo ranks on the card, (1, 2) blocks mesh")
    runs_b = [(*DEPTH1, 1, False, False), (*DEPTH3, 1, False, False),
              (*SHORT3, 1, True, True)]
    res_b, info_b = _mesh_launch(["cuda:0"] * 2, runs_b, window_cfg=3,
                                 step_cfg=3, deterministic=False)
    _gloo_refused("b", res_b)
    step = res_b["step"]
    print(json.dumps(dict(phase="mesh_b_step", config=3, **step)),
          flush=True)
    for mode, e in step["errs"].items():
        _check(e["accepted"][0] == e["accepted"][1]
               and e["accepted"][0] >= STEP_ITERS // 2,
               f"mesh (b) {mode} steps: accepted {e['accepted']} of "
               f"{STEP_ITERS}")
        bad = {k: v for k, v in e.items()
               if k != "accepted" and not v <= MESH_TOL["step"]}
        _check(not bad, f"mesh (b) {mode} steps against the unsharded "
               f"steps: {bad}")
    for r, c in enumerate(step["launches"]["accept_aware"]):
        k1_, k3_, k4_ = (c[k] for k in ("k1_launches", "k3_launches",
                                        "k4_launches"))
        print(f"mesh (b) accept-aware steps, rank {r}: K1 {k1_}, K3 {k3_}, "
              f"K4 {k4_}", flush=True)
        _check(k1_ > 0 and k3_ > 0 and k4_ > 0,
               f"mesh (b) accept-aware steps: rank {r} launched K1 {k1_}, "
               f"K3 {k3_}, K4 {k4_}")
    rec["b_step"] = step

    _phase("mesh (c): two gloo ranks on the card, (2, 1) chains mesh")
    runs_c = [(*SHORT3, 2, False, True)]
    res_c, info_c = _mesh_launch(["cuda:0"] * 2, runs_c, window_cfg=3,
                                 n_chains=2)
    _gloo_refused("c", res_c)

    _phase("mesh: the one-process windows and chains beside them")
    one = {C: _window(torch, bench, 3, C) for C in (1, 2)}
    spread = _one_process(bench, 3, SPREAD_C, *DEPTH3[1:])
    rec |= _mesh_runs(bench, "b", [1, 2], runs_b, res_b, info_b, one,
                      spread, deterministic=False)
    rec |= _mesh_runs(bench, "c", [2, 1], runs_c, res_c, info_c, one, None)
    for key in ("b_config3", "c_config3"):
        r = rec[key]
        o = one[r["chains"]]
        det = "" if r["deterministic_algorithms"] else "out"
        print(f"mesh table: {key}: {r['ms_per_iter']:.2f} ms/it (one "
              f"process {r['one_process_ms_per_iter']:.2f}, both with{det} "
              f"deterministic algorithms), {r['chain_it_per_s']:.2f} "
              f"chain-it/s; window ms/it by rank "
              f"{[round(w[0], 2) for w in r['window_by_rank']]}, idle by rank "
              f"{[round(w[2], 3) for w in r['window_by_rank']]}, peak GB by "
              f"rank {[round(b / 1e9, 2) for b in r['peak_bytes_by_rank']]}; "
              f"one process at C={r['chains']}: window {o['ms_per_iter']:.2f} "
              f"ms/it, idle {o['idle']:.3f}", flush=True)
    return rec


def _device_ops(torch, run, reps):
    """{name: [calls, device ms]} of the device work (kernels, copies,
    sets) of ``run()`` repeated ``reps`` times under torch.profiler, per
    call of ``run``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    return {e.key: [e.count / reps, e.self_device_time_total / 1e3 / reps]
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _trace_ops(torch, run, iters):
    """Per iteration of ``run(iters)`` under torch.profiler: device-busy
    ms, device ops (kernels, copies and sets: a graph's nodes when it
    replays) and NCCL kernels.  The profiler's ranges around eager
    collectives ("nccl:...") are not ops."""
    ops = {k: v for k, v in _device_ops(torch, lambda: run(iters), 1).items()
           if not k.startswith("nccl:")}
    per = lambda f: sum(c for k, (c, _) in ops.items() if f(k)) / iters
    return dict(busy=sum(ms for _, ms in ops.values()) / iters,
                nodes=per(lambda k: True),
                nccl=per(lambda k: "nccl" in k.lower()))


def probe_nccl_capture(torch):
    """``--probe-nccl``: on a one-rank NCCL group in this process, each
    form of all-gather -- the list form (``dist.all_gather``) and the
    mesh's collectives (one all-gather into one tensor) -- run eagerly on
    a side stream, then captured there in a CUDA graph (thread-local
    mode) and replayed: whether it captures, whether the replay gives the
    eager result, and the device work of the eager call and of a replay
    by name under torch.profiler.  Prints one JSON record."""
    import torch.distributed as dist

    from spamtree_tpu_torch.parallel.mesh import make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(1, 1, device="cuda:0")
            g = torch.Generator(device="cuda").manual_seed(1)
            x = torch.randn((1024, 68), generator=g, device="cuda")
            ok = torch.ones((), dtype=torch.bool, device="cuda")

            def list_form():
                parts = [torch.empty_like(x)]
                dist.all_gather(parts, x, group=mesh.blocks_group)
                return torch.cat(parts)

            cands = dict(
                list_all_gather=list_form,
                cat_blocks=lambda: mesh.cat_blocks(x, 1),
                sum_blocks=lambda: mesh.sum_blocks(x),
                all_blocks=lambda: mesh.all_blocks(ok))
            rec = dict(phase="nccl_capture_probe",
                       nccl=".".join(map(str, torch.cuda.nccl.version())),
                       torch=torch.__version__)
            side = torch.cuda.Stream()
            for name, f in cands.items():
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    want = f().clone()
                torch.cuda.current_stream().wait_stream(side)
                r = dict(eager_ops=_device_ops(torch, f, 5))
                try:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, stream=side,
                                          capture_error_mode="thread_local"):
                        out = f()
                    graph.replay()
                    torch.cuda.synchronize()
                    r["same_bits"] = bool(torch.equal(out, want))
                    r["replay_ops"] = _device_ops(torch, graph.replay, 5)
                except Exception as e:  # noqa: BLE001 (the probe's finding)
                    torch.cuda.synchronize()
                    r["error"] = f"{type(e).__name__}: {e}"[:400]
                rec[name] = r
        finally:
            dist.destroy_process_group()
    print(json.dumps(rec), flush=True)
    for name in cands:
        r = rec[name]
        print(f"nccl probe: {name}: "
              + ("captured, same bits " + str(r["same_bits"])
                 if "error" not in r else "not captured: " + r["error"])
              + f"; replay ops {r.get('replay_ops')}", flush=True)
    return rec


# -- phase 19: the iteration as replayed CUDA graphs -------------------------

# (keep, burn, thin) of each graphed-against-eager pair: 50 iterations
GRAPH_DEPTH = dict(keep=20, burn=10, thin=2)
GRAPH_WINDOW = 10  # iterations timed, then traced, per path
# (config, chains, accept-aware): one chain on both theta steps at configs
# 1, 3 and 5; config 3's batched chains at C = 2 and 4 on both
GRAPH_CASES = [(1, 0, False), (1, 0, True), (3, 0, False), (3, 0, True),
               (3, 2, False), (3, 2, True), (3, 4, False), (3, 4, True),
               (5, 0, False), (5, 0, True)]
# run once more graphed under deterministic algorithms: config 3 alone and
# chained, config 5's limited tree on both steps (K3/K4 when accept-aware)
GRAPH_DET_CASES = [(3, 0, False), (3, 2, False), (5, 0, False),
                   (5, 0, True)]
# run graphed with the carry copied and donated, peak memory beside
GRAPH_DONATE_CASES = [(3, 0, False), (5, 0, False)]


def _leaves(x):
    """Every tensor of a (nested) sampler state, in order."""
    if hasattr(x, "shape"):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in _leaves(y)]
    return []


def _graph_pair(fit, cfg, C, torch, paths=(False, True)):
    """run_mcmc (C = 0) or run_mcmc_chains eager, then graphed (``paths``),
    from one prepared chain with the same generator seeds: each run's
    result, launch counts and peak device memory."""
    from spamtree_tpu_torch.model.mcmc import (
        run_mcmc,
        run_mcmc_chains,
        stack_chain_states,
    )
    from spamtree_tpu_torch.ops import kernel_counts

    out = {}
    for graphs in paths:
        start = kernel_counts.snapshot()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if C:
            states, gens = stack_chain_states(fit.state, 1 + np.arange(C))
            res = run_mcmc_chains(fit.ms, fit.bounds, cfg, states, gens,
                                  yhat_seed=1, graphs=graphs)
        else:
            gen = torch.Generator(device=fit.ms.device).manual_seed(11)
            res = run_mcmc(fit.ms, fit.bounds, cfg, fit.state, gen,
                           yhat_seed=1, graphs=graphs)
        torch.cuda.synchronize()
        out[graphs] = dict(res=res, counts=kernel_counts.diff(start),
                           peak=torch.cuda.max_memory_allocated())
    return out


def _same_chain(a, b):
    """(the same bits?, what differs): the kept draws and the final state."""
    diff = [k for k in ("w", "beta", "tausq", "theta")
            if not np.array_equal(a[k], b[k])]
    la, lb = _leaves(a["state"]), _leaves(b["state"])
    diff += [f"state leaf {i}" for i, (x, y) in enumerate(zip(la, lb))
             if not bool(((x == y) | (x.isnan() & y.isnan())).all())]
    if a["accept_ratio"] != b["accept_ratio"]:
        diff.append("accept_ratio")
    return not diff and len(la) == len(lb), diff


class Iterations:
    """``it(k)``: k more iterations of one chain (predicting every other
    one, as thin=2 keeps), synchronised at the end -- replayed CUDA graphs
    (``mcmc.StepRunner``, ``runner``) with ``graphs``, else the eager step.
    ``fit`` from ``api.prepare_fit``; ``chains`` C > 0: C chains stacked
    from its state, generators seeded 1..C (one chain: ``fit.gen``).
    ``replays``: the runner's (0 eager)."""

    def __init__(self, torch, fit, cfg, chains, graphs, n_iters):
        from spamtree_tpu_torch.model.core import level_coords, tausq_shape
        from spamtree_tpu_torch.model.mcmc import (
            StepRunner,
            draw_chains,
            draw_step,
            make_step,
            stack_chain_states,
        )

        ms = fit.ms
        shape = tausq_shape(ms, cfg.tausq_ab)
        nt = fit.state.theta.shape[-1]
        state, gens = fit.state, fit.gen
        if chains:
            state, gens = stack_chain_states(fit.state, 1 + np.arange(chains))
        draw = ((lambda out=None: draw_chains(ms, gens, nt, shape, out=out))
                if chains else
                (lambda out=None: draw_step(ms, gens, nt, shape, out=out)))
        self.sync = torch.cuda.synchronize
        self.runner = self.step = None
        if graphs:
            self.runner = StepRunner(ms, fit.bounds, cfg, state, draw,
                                     chains=chains, n_iters=n_iters)
        else:
            self.step = make_step(ms, fit.bounds, cfg,
                                  coords_cache=level_coords(ms),
                                  chains=bool(chains))
            self.state, self.draw = state, draw

    def __call__(self, k: int):
        for i in range(k):
            if self.runner is not None:
                self.runner.step(i % 2 == 1)
            else:
                self.state = self.step(self.state, self.draw(), i % 2 == 1)
        self.sync()

    @property
    def replays(self):
        return self.runner.replays if self.runner is not None else 0


def _graph_window(torch, fit, cfg, C, graphs, count=None, seed=None):
    """ms per iteration (host clock, synchronised) over GRAPH_WINDOW
    iterations after three warm-up ones (the graphs captured at the
    first), then device-busy ms, kernels (graph kernel nodes when graphed)
    and graph replays per iteration over GRAPH_WINDOW traced ones; and,
    graphed, one chain's install (part I) replayed alone: device ms per
    replay, the bytes it copies (read and written) and the device ms of
    those copies alone (eager copy_ into spare tensors).  With ``seed``
    (one chain) the chain's generator is seeded with it, and the traced
    iterations are the timed ones run again from the same start, so the
    idle share compares the same iterations (the next ones may accept
    more or less often).  ``count``: a counter read around the traced
    iterations (its change per iteration is ``counted_per_iter``)."""
    def start():
        if seed is not None:
            fit.gen.manual_seed(seed)
        it = Iterations(torch, fit, cfg, C, graphs, 3 + 2 * GRAPH_WINDOW)
        it(3)
        return it

    it = start()
    t0 = time.time()
    it(GRAPH_WINDOW)
    ms_it = 1e3 * (time.time() - t0) / GRAPH_WINDOW
    if seed is not None:
        if it.runner is not None:
            it.runner.release()
        it = start()
    reps = it.replays
    c0 = count() if count else 0
    ops = _trace_ops(torch, it, GRAPH_WINDOW)
    busy = ops["busy"]
    rec = dict(ms_per_iter=ms_it, busy_ms_per_iter=busy,
               idle=1.0 - busy / ms_it, kernels_per_iter=ops["nodes"],
               nccl_kernels_per_iter=ops["nccl"],
               replays_per_iter=(it.replays - reps) / GRAPH_WINDOW)
    if count:
        rec["counted_per_iter"] = (count() - c0) / GRAPH_WINDOW
    r = it.runner
    if graphs and not C and "I" in r.graphs:
        st = r.state
        installed = _leaves((st.theta, st.logdetCi, st.leveldata, st.gram,
                             st.pred_data))
        rec["install_bytes"] = 2 * sum(x.numel() * x.element_size()
                                       for x in installed)
        # the whole install (the Gram blocks and prediction operators
        # formed, then copied), and its copies alone into spare tensors
        spare = [torch.empty_like(x) for x in installed]
        for key, fn in (("install_ms", r.graphs["I"].replay),
                        ("install_copy_ms", lambda: [
                            d.copy_(x) for d, x in zip(spare, installed)])):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(10):
                fn()
            e1.record()
            torch.cuda.synchronize()
            rec[key] = e0.elapsed_time(e1) / 10
        del spare
    if r is not None:
        r.release()
    return rec


@contextlib.contextmanager
def _deterministic(torch):
    """torch.use_deterministic_algorithms(True) for a block, with the
    cuBLAS workspace setting it asks for."""
    with _env(CUBLAS_WORKSPACE_CONFIG=":4096:8"):
        torch.use_deterministic_algorithms(True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def _det_case(fit, cfg, C, torch, pair, what):
    """Phase 19's graphed run once more under deterministic algorithms:
    the bits of the default graphed run and of the eager one, the same
    launches, and a window (ms/it, busy, idle)."""
    import torch.utils.deterministic as tud

    with _deterministic(torch):
        d = _graph_pair(fit, cfg, C, torch, paths=(True,))[True]
        win = _graph_window(torch, fit, cfg, C, True)
        # the same without deterministic mode's NaN fill of every new
        # tensor, which the graphs replay too
        fill = tud.fill_uninitialized_memory
        tud.fill_uninitialized_memory = False
        try:
            win_nofill = _graph_window(torch, fit, cfg, C, True)
        finally:
            tud.fill_uninitialized_memory = fill
    same_g = _same_chain(pair[True]["res"], d["res"])
    same_e = _same_chain(pair[False]["res"], d["res"])
    rec = dict(same_as_graphed=same_g[0], same_as_eager=same_e[0],
               differs_in=same_g[1], counts=d["counts"],
               capture_s=d["res"]["compile_time_s"], peak_gb=d["peak"] / 1e9,
               window=win, window_no_fill=win_nofill)
    print(json.dumps(dict(phase="graphs_deterministic", case=what, **rec)),
          flush=True)
    print(f"graphs table: {what}, deterministic algorithms: graphed "
          f"{win['ms_per_iter']:.2f} ms/it (busy {win['busy_ms_per_iter']:.2f}"
          f", idle {win['idle']:.3f}, {win['kernels_per_iter']:.1f} kernel "
          f"nodes, capture {rec['capture_s']:.2f} s, peak "
          f"{rec['peak_gb']:.2f} GB; without the NaN fill of new tensors "
          f"{win_nofill['ms_per_iter']:.2f} ms/it, busy "
          f"{win_nofill['busy_ms_per_iter']:.2f}, "
          f"{win_nofill['kernels_per_iter']:.1f} nodes); same bits as the "
          f"default graphed run {same_g[0]}, as the eager run {same_e[0]}",
          flush=True)
    _check(same_g[0] and same_e[0], f"graphs, {what}, deterministic: the "
           f"chain differs in {same_g[1]} / {same_e[1]}")
    _check(d["counts"] == pair[True]["counts"],
           f"graphs, {what}, deterministic: launches {d['counts']}")
    _check(d["res"]["graph_replays"] > 0, f"graphs, {what}, deterministic: "
           "no graph replayed")
    return rec


def _donate_pair(fit, cfg, torch, what):
    """run_mcmc graphed with the carry copied (donate=False) and donated (a
    copy of the prepared state given up, made before the run), from one
    prepared chain and the same seed: the carried state's bytes, each
    run's peak device memory above what was allocated at its start, and
    the same bits."""
    from spamtree_tpu_torch.model.core import _tree_map
    from spamtree_tpu_torch.model.mcmc import run_mcmc

    st = fit.state
    carried = _leaves((st.w, st.beta, st.tausq_inv, st.XB, st.theta,
                       st.leveldata, st.pred_data, st.logdetCi, st.gram,
                       st.ram.paramsd, st.ram.prodparam))
    nbytes = sum(x.numel() * x.element_size() for x in carried)
    out = {}
    for donate in (False, True):
        given = (_tree_map(lambda x: x.clone() if hasattr(x, "clone") else x,
                           st) if donate else st)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=fit.ms.device).manual_seed(11)
        res = run_mcmc(fit.ms, fit.bounds, cfg, given, gen, yhat_seed=1,
                       donate=donate)
        torch.cuda.synchronize()
        out[donate] = dict(res=res, peak=torch.cuda.max_memory_allocated()
                           - base, peak_abs=torch.cuda.max_memory_allocated())
        del given
    same, diff = _same_chain(out[False]["res"], out[True]["res"])
    fall = out[False]["peak"] - out[True]["peak"]
    rec = dict(state_bytes=nbytes, peak_cloned=out[False]["peak"],
               peak_donated=out[True]["peak"],
               peak_abs_cloned=out[False]["peak_abs"],
               peak_abs_donated=out[True]["peak_abs"],
               fall_over_state=fall / nbytes, same_bits=same)
    print(json.dumps(dict(phase="graphs_donate", case=what, **rec)),
          flush=True)
    print(f"graphs table: {what}, donated carry: carried state "
          f"{nbytes / 1e9:.3f} GB; the run's peak above its start "
          f"{out[False]['peak'] / 1e9:.3f} GB copied, "
          f"{out[True]['peak'] / 1e9:.3f} GB donated (fell by "
          f"{fall / nbytes:.3f} x the state); same bits {same}", flush=True)
    _check(same, f"graphs, {what}: the donated run differs in {diff}")
    return rec


def _late_capture_drain(bench, torch, tmp):
    """Config 1 with the reference warmup and burn = 20, keep = 40, thin =
    1, chunk = 4: the capture at iteration G0 + 1 falls inside the keep
    loop while the drain thread works; the run must still drain pipelined
    and give the bits of a checkpointed (sequential) run and of the eager
    one."""
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model import mcmc

    y, _, _, X, coords, mv = _data(bench, 1)
    fit = prepare_fit(y - np.nanmean(y), X, coords, mv_id=mv, cell_size=25,
                      mcmc=dict(keep=40, burn=20, thin=1), seed=1,
                      settings=dict(chunk=4, wire_dtype="none",
                                    ram_reference_warmup=True),
                      device="cuda", **bench.CONFIGS[1].get("kwargs", {}))
    seen, loop = [], mcmc._drain_loop

    def spy(n, dispatch, drain, pipeline):
        seen.append(pipeline)
        return loop(n, dispatch, drain, pipeline)

    mcmc._drain_loop = spy
    try:
        runs = [mcmc.run_mcmc(
            fit.ms, fit.bounds, fit.cfg, fit.state,
            torch.Generator(device="cuda").manual_seed(11), yhat_seed=1,
            graphs=g, checkpoint_path=ck)
            for g, ck in ((None, None), (None, os.path.join(tmp, "ck.pt")),
                          (False, None))]
    finally:
        mcmc._drain_loop = loop
    same = [_same_chain(runs[0], r)[0] for r in runs[1:]]
    rec = dict(pipelined=seen, same_as_sequential=same[0],
               same_as_eager=same[1], replays=runs[0]["graph_replays"],
               it=runs[0]["state"].it)
    print(json.dumps(dict(phase="late_capture_drain", **rec)), flush=True)
    _check(seen == [True, False, True] and all(same)
           and runs[0]["graph_replays"] > 0 and runs[0]["state"].it > 51,
           f"late capture with the pipelined drain: {rec}")
    return rec


def _row_write_inputs(torch, n=1_000_000, pad=0.05, seed=3):
    """A write of config 5's levels (CONFIG5_SHAPES, CONFIG5_THIN) into an
    (n+1,) w: each level's (B, S) rows, distinct real rows with a share
    ``pad`` of the slots padded to the sentinel n, and its values, masked
    to 0 there as gibbs_w's are."""
    rng = np.random.default_rng(seed)
    shapes = CONFIG5_SHAPES + [(b, s_) for b, s_, _ in CONFIG5_THIN]
    slots = sum(b * s_ for b, s_ in shapes)
    real = rng.uniform(size=slots) >= pad
    flat = np.full(slots, n, dtype=np.int64)
    flat[real] = rng.choice(n, size=int(real.sum()), replace=False)
    rows, vals, o = [], [], 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    for b, s_ in shapes:
        r = torch.as_tensor(flat[o: o + b * s_].reshape(b, s_),
                            device="cuda")
        o += b * s_
        rows.append(r)
        vals.append(torch.where(r < n, torch.randn(
            (b, s_), generator=g, device="cuda"), 0.0))
    return n, rows, vals, flat


def probe_row_writes(torch):
    """``--probe-writes``: every candidate for gibbs_w's row writes
    at config 5's levels, captured in a CUDA graph with deterministic
    algorithms off and then on -- ``index_put_`` (the write put_rows
    replaced), ``index_copy_`` and ``scatter_``, one call a level, and
    ``put_rows``, one gather through a RowTable for all levels.  Each is
    first run eagerly and held bitwise to index_put_'s result; a capture
    that fails is reported with its error, then the card is checked to
    still run.  Prints one JSON record: device ms per write of all levels
    (replayed), or the error; put_rows must capture in both modes and
    give index_put_'s bits."""
    from types import SimpleNamespace

    from spamtree_tpu_torch.model.core import put_rows, row_table

    n, rows, vals, flat = _row_write_inputs(torch)
    table = row_table(flat, n, "cuda")
    ms = SimpleNamespace(mesh=None)
    w0 = torch.randn(n + 1, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(1))
    w = w0.clone()
    frows = [r.reshape(-1) for r in rows]
    fvals = [v.reshape(-1) for v in vals]
    cands = {
        "put_rows": lambda: w.copy_(put_rows(ms, w, vals, table)),
        "index_put_": lambda: [w.index_put_((r,), v)
                               for r, v in zip(frows, fvals)],
        "index_copy_": lambda: [w.index_copy_(0, r, v)
                                for r, v in zip(frows, fvals)],
        "scatter_": lambda: [w.scatter_(0, r, v)
                             for r, v in zip(frows, fvals)],
    }
    w.copy_(w0)
    cands["index_put_"]()
    want = w.clone()
    rec = dict(phase="row_write_probe", n=n, levels=len(rows),
               slots=int(flat.size), bytes_w=4 * (n + 1))
    for det in (False, True):
        torch.use_deterministic_algorithms(det)
        for name, f in cands.items():
            key = f"{name}_{'det' if det else 'default'}"
            w.copy_(w0)
            f()
            torch.cuda.synchronize()
            same = bool(torch.equal(w, want))
            try:
                rec[key] = dict(ms=_graph_ms(torch, f, 10), same_bits=same)
            except Exception as e:  # noqa: BLE001 (the probe's finding)
                ok = float(torch.ones(8, device="cuda").sum()) == 8.0
                rec[key] = dict(error=f"{type(e).__name__}: {e}"[:300],
                                same_bits=same, card_runs_after=ok)
    torch.use_deterministic_algorithms(False)
    print(json.dumps(rec), flush=True)
    print("row writes, device ms per write of config 5's "
          f"{rec['levels']} levels: " + ", ".join(
              f"{k} {v['ms']:.4f}" if "ms" in v else f"{k} not captured"
              for k, v in rec.items() if isinstance(v, dict)), flush=True)
    for mode in ("default", "det"):
        r = rec[f"put_rows_{mode}"]
        _check("ms" in r and r["same_bits"],
               f"put_rows under the {mode} mode: {r}")
    return rec


def graphs_phase(bench, torch):
    """Phase 19: for each of GRAPH_CASES, one prepared chain per config run
    eager (graphs=False) and graphed (the default) at GRAPH_DEPTH from the
    same generator seeds: the same bits (kept draws, final state,
    acceptance) and each kernel's launches the same on both paths; at
    config 3's single always-emit chain two eager runs too, which must give
    the same bits (the fixed-order message sums).  Then a window of each
    path: ms/it, busy ms/it, idle share, kernels and graph replays per
    iteration, capture seconds, peak GB, one chain's install cost.
    Returns the records."""
    from spamtree_tpu_torch.api import prepare_fit

    recs = {}
    fits = {}
    for cfg_id, C, aa in GRAPH_CASES:
        c = bench.CONFIGS[cfg_id]
        what = (f"config {cfg_id}, "
                + (f"C = {C}" if C else "single chain") + ", "
                + ("accept-aware, level kernels" if aa else "always-emit"))
        _phase(f"graphs: {what}")
        if cfg_id not in fits:
            fits.clear()  # one configuration's model on the card at a time
            y, _, _, X, coords, mv = _data(bench, cfg_id)
            fits[cfg_id] = prepare_fit(
                y - np.nanmean(y), X, coords, mv_id=mv, cell_size=25,
                mcmc=GRAPH_DEPTH, settings=dict(chunk=10, wire_dtype="none"),
                seed=1, device="cuda", **c.get("kwargs", {}))
        fit = fits[cfg_id]
        cfg = fit.cfg._replace(accept_aware=aa)
        with _env(SPAMTREE_LEVEL_KERNELS="1" if aa else "0"):
            pair = _graph_pair(fit, cfg, C, torch)
            repeat = None
            if (cfg_id, C, aa) == (3, 0, False):
                again = _graph_pair(fit, cfg, C, torch)[False]["res"]
                repeat = _same_chain(pair[False]["res"], again)[0]
            win = {g: _graph_window(torch, fit, cfg, C, g)
                   for g in (True, False)}
        e, g = pair[False], pair[True]
        iters = e["res"]["burn_actual"] + GRAPH_DEPTH["keep"] * GRAPH_DEPTH[
            "thin"]
        same, diff = _same_chain(e["res"], g["res"])
        per_it = {k: {p: pair[p]["counts"][k] / iters for p in (False, True)}
                  for k in ("k1_launches", "k3_launches", "k4_launches")}
        rec = dict(
            phase="graphs", config=cfg_id, chains=C,
            step="accept_aware" if aa else "always_emit", iters=iters,
            same_bits=same, differs_in=diff, eager_repeats_bits=repeat,
            launches_per_iter=per_it,
            capture_s=g["res"]["compile_time_s"],
            replays_per_iter_run=g["res"]["graph_replays"] / iters,
            peak_gb={"graphed": g["peak"] / 1e9, "eager": e["peak"] / 1e9},
            accept=e["res"]["accept_ratio"],
            graphed=win[True], eager=win[False])
        print(json.dumps(rec), flush=True)
        wg, we = win[True], win[False]
        print(f"graphs table: {what}: graphed {wg['ms_per_iter']:.2f} ms/it "
              f"(busy {wg['busy_ms_per_iter']:.2f}, idle {wg['idle']:.3f}, "
              f"{wg['replays_per_iter']:.2f} replays and "
              f"{wg['kernels_per_iter']:.1f} kernel nodes an iteration, "
              f"capture {rec['capture_s']:.2f} s, peak "
              f"{rec['peak_gb']['graphed']:.2f} GB); eager "
              f"{we['ms_per_iter']:.2f} ms/it (busy "
              f"{we['busy_ms_per_iter']:.2f}, idle {we['idle']:.3f}, "
              f"{we['kernels_per_iter']:.1f} kernels, peak "
              f"{rec['peak_gb']['eager']:.2f} GB)"
              + (f"; install {wg['install_ms']:.3f} ms, its copies "
                 f"{wg['install_copy_ms']:.3f} ms for "
                 f"{wg['install_bytes'] / 1e9:.3f} GB" if "install_ms" in wg
                 else ""), flush=True)
        _check(same, f"graphs, {what}: the graphed chain differs from the "
               f"eager one in {diff}")
        _check(repeat is not False, f"graphs, {what}: two eager runs differ")
        for k, v in per_it.items():
            _check(v[False] == v[True], f"graphs, {what}: {k} per iteration "
                   f"{v[True]} graphed, {v[False]} eager")
        if (cfg_id, C, aa) in GRAPH_DET_CASES:
            with _env(SPAMTREE_LEVEL_KERNELS="1" if aa else "0"):
                rec["deterministic"] = _det_case(fit, cfg, C, torch, pair,
                                                 what)
        if (cfg_id, C, aa) in GRAPH_DONATE_CASES:
            rec["donate"] = _donate_pair(fit, cfg, torch, what)
        _check(per_it["k1_launches"][True] > 0, f"graphs, {what}: no K1")
        _check(not aa or C or per_it["k3_launches"][True] > 0,
               f"graphs, {what}: no K3 with the level kernels on")
        reps = rec["replays_per_iter_run"]
        _check((reps <= 1.0) if C else (2.0 <= reps <= 4.0),
               f"graphs, {what}: {reps} replays an iteration")
        recs[(cfg_id, C, aa)] = rec
    fits.clear()
    _phase("graphs: a capture inside the keep loop, pipelined drain")
    with tempfile.TemporaryDirectory() as tmp:
        recs["late_capture"] = _late_capture_drain(bench, torch, tmp)
    return recs


# -- phase 20: spamtree_predict's draws as replayed CUDA graphs -------------

# (config, new rows m, draws): phase 8's config-5 fit as phase 11 predicts
# from it, and phase 5's config-3 fit (a full tree: K1 at every reference
# level up to the prediction parent, several shapes in one graph)
PREDICT_CASES = [(5, 10_000, 50), (3, 2000, 20)]
PREDICT_WINDOW = 10  # draws timed, then traced, per path


def _predict_path(torch, st, graphs, n_draws):
    """spamtree_predict's draws of a staged prediction through a
    DrawRunner, eager or graphed: the draws, the run's launches, seconds
    and peak device memory above its start, then PREDICT_WINDOW more draws
    timed on the host clock and PREDICT_WINDOW traced (busy ms, kernels
    per draw)."""
    from spamtree_tpu_torch.api import predict_draws
    from spamtree_tpu_torch.model.predict import DrawRunner
    from spamtree_tpu_torch.ops import kernel_counts

    r = DrawRunner(st.ms, st.theta_draws.shape[1], st.new_pos, st.cc,
                   graphs=graphs)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = kernel_counts.snapshot()
    t0 = time.time()
    w = predict_draws(st, r, seed=1)
    wall = time.time() - t0
    counts = kernel_counts.diff(start)
    peak = torch.cuda.max_memory_allocated() - base

    def window(k):
        predict_draws(st._replace(sel=st.sel[:k]), r, seed=2)

    window(2)
    t0 = time.time()
    window(PREDICT_WINDOW)
    ms_draw = 1e3 * (time.time() - t0) / PREDICT_WINDOW
    ops = _trace_ops(torch, window, PREDICT_WINDOW)
    busy, kernels = ops["busy"], ops["nodes"]
    rec = dict(ms_per_draw_run=1e3 * wall / n_draws, ms_per_draw=ms_draw,
               busy_ms_per_draw=busy, idle=1.0 - busy / ms_draw,
               kernels_per_draw=kernels, capture_s=r.capture_s,
               replays=r.replays, peak_gb=peak / 1e9, **counts,
               k1_per_draw=counts["k1_launches"] / n_draws)
    r.release()
    return w, rec


def predict_phase(bench, torch, fits):
    """Phase 20: for each of PREDICT_CASES, the prediction staged once
    (stage_predict) from the fit in ``fits`` at m held-out rows, then its
    draws eager (graphs=False) and graphed (spamtree_predict's default on
    the card) with the same seed: the same w_pred bits and K1 launches per
    draw on both paths, one launch per reference level that _joints_upto
    factors; each path's ms/draw, busy ms/draw, idle share, capture
    seconds and peak memory."""
    from spamtree_tpu_torch.api import stage_predict

    recs = {}
    for cfg_id, m, n_draws in PREDICT_CASES:
        what = f"config {cfg_id}, m = {m}, {n_draws} draws"
        _phase(f"predict: {what}, eager and graphed")
        fit = fits[cfg_id]
        y, _, miss, X, coords, mv = _data(bench, cfg_id)
        pick = np.sort(np.random.default_rng(0).choice(
            np.flatnonzero(miss), size=m, replace=False))
        st = stage_predict(fit, y - np.nanmean(y), X, coords,
                           coords_new=coords[pick], x_new=X[pick], mv_id=mv,
                           mv_id_new=mv[pick], n_draws=n_draws,
                           device="cuda")
        out = {g: _predict_path(torch, st, g, n_draws)
               for g in (False, True)}
        with _deterministic(torch):
            out["det"] = _predict_path(torch, st, True,
                                       n_draws)
        limited = fit["fit_config"]["limited_tree"]
        per_draw = (1 if limited
                    else fit["schedule"].pred_buckets[0].lp_level + 1)
        same = bool(np.array_equal(out[False][0], out[True][0]))
        same_det = bool(np.array_equal(out["det"][0], out[True][0]))
        e, g, d = out[False][1], out[True][1], out["det"][1]
        rec = dict(phase="predict_graphs", config=cfg_id, m=m,
                   n_draws=n_draws, limited_tree=limited, same_bits=same,
                   deterministic_same_bits=same_det,
                   k1_per_draw_expected=per_draw, stage=st.breakdown,
                   eager=e, graphed=g, graphed_deterministic=d)
        print(json.dumps(rec), flush=True)
        print(f"predict table: {what}: graphed {g['ms_per_draw']:.2f} "
              f"ms/draw (busy {g['busy_ms_per_draw']:.2f}, idle "
              f"{g['idle']:.3f}, capture {g['capture_s']:.2f} s, peak "
              f"{g['peak_gb']:.2f} GB, the run's {g['ms_per_draw_run']:.2f} "
              f"ms/draw); eager {e['ms_per_draw']:.2f} ms/draw (busy "
              f"{e['busy_ms_per_draw']:.2f}, idle {e['idle']:.3f}, peak "
              f"{e['peak_gb']:.2f} GB, the run's {e['ms_per_draw_run']:.2f}"
              f"); K1 {g['k1_per_draw']:.2f} / {e['k1_per_draw']:.2f} a draw; "
              f"graphed under deterministic algorithms "
              f"{d['ms_per_draw']:.2f} ms/draw (busy "
              f"{d['busy_ms_per_draw']:.2f}), same bits {same_det}",
              flush=True)
        _check(same, f"predict, {what}: graphed w_pred differs from eager")
        _check(np.isfinite(out[True][0]).all()
               and out[True][0].shape == (n_draws, m),
               f"predict, {what}: w_pred")
        _check(e["k1_launches"] == g["k1_launches"] == per_draw * n_draws,
               f"predict, {what}: K1 launches {g['k1_launches']} graphed, "
               f"{e['k1_launches']} eager, {per_draw} x {n_draws} expected")
        _check(g["replays"] > 0 and g["capture_s"] > 0,
               f"predict, {what}: no graph replayed")
        _check(same_det and d["k1_launches"] == g["k1_launches"]
               and d["replays"] > 0, f"predict, {what}: graphed under "
               f"deterministic algorithms: same bits {same_det}, K1 "
               f"{d['k1_launches']}, {d['replays']} replays")
        recs[cfg_id] = rec
        del st
    return recs


def _predict_fits(bench, chol, torch):
    """Phase 20's fits when it runs alone (``--graphs``): phase 8's
    config-5 run and phase 5's config-3 run."""
    c5 = bench.CONFIGS[5]
    _phase("predict: config 5 fit (phase 8's)")
    fit5 = run_config(bench, chol, torch, 5, keep=c5["keep"] // 2,
                      burn=c5["burn"] // 2, thin=c5["thin"],
                      chunk=c5["chunk"],
                      limited=c5["kwargs"]["limited_tree"])[2]
    _phase("predict: config 3 fit (phase 5's)")
    fit3 = run_config(bench, chol, torch, 3, keep=100, burn=200,
                      thin=2)[2]
    return {5: fit5, 3: fit3}


# -- phase 21: the port's benchmark entry -----------------------------------

# the keys of bench.py's JSON line at one repeat and one chain, in order
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "baseline_note",
              "vs_cpu_1thread_est", "rmspe", "sd_y", "n", "iters", "accept",
              "mcmc_time_s", "setup_time_s", "setup_breakdown_s", "repeats",
              "ips_runs", "ips_min", "ips_max", "tflops_per_sec",
              "bandwidth_util"]


def _bench_entry(cfg_id):
    """``python -m spamtree_tpu_torch.bench --config cfg_id --repeats 1``
    at the config's own depth in a subprocess, its output printed; returns
    (the JSON line, the run line's record)."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "spamtree_tpu_torch.bench", "--config",
         str(cfg_id), "--repeats", "1"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    for line in proc.stdout.splitlines():
        print(f"  {line}")
    print(f"  (config {cfg_id}: {time.time() - t0:.1f} s, exit "
          f"{proc.returncode})", flush=True)
    _check(proc.returncode == 0, f"bench config {cfg_id} exited "
           f"{proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    run = [json.loads(x[len("bench run: "):]) for x in lines
           if x.startswith("bench run: ")]
    _check(len(run) == 1, f"bench config {cfg_id}: {len(run)} run lines")
    return json.loads(lines[-1]), run[0]


def bench_phase(bench, torch):
    """Phase 21: configs 1 and 3 through the bench entry, checked; config
    1's per-part work on the card against the same model staged on the
    CPU.  Returns {cfg_id: the run line's record}."""
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model.mcmc import part_work

    runs = {}
    for cfg_id in (1, 3):
        _phase(f"bench: python -m spamtree_tpu_torch.bench --config "
               f"{cfg_id} --repeats 1")
        line, run = _bench_entry(cfg_id)
        what = f"bench config {cfg_id}"
        _check(list(line) == BENCH_KEYS, f"{what}: keys {list(line)}")
        _check(line["rmspe"] < 0.5 * line["sd_y"],
               f"{what}: RMSPE {line['rmspe']} >= 0.5 sd(y) {line['sd_y']}")
        _check(0.05 < line["accept"] < 0.8,
               f"{what}: acceptance {line['accept']}")
        _check(line["tflops_per_sec"] > 0,
               f"{what}: tflops_per_sec {line['tflops_per_sec']}")
        _check(0 < line["bandwidth_util"] <= 1.05,
               f"{what}: bandwidth_util {line['bandwidth_util']}")
        _check(run["k1_launches"] > 0, f"{what}: K1 never launched")
        runs[cfg_id] = run
    _phase("bench: config 1's work per part, the card against the CPU")
    c = bench.CONFIGS[1]
    y, _, _, X, coords, mv = _data(bench, 1)
    fit = prepare_fit(y - np.nanmean(y), X, coords, mv_id=mv, cell_size=25,
                      mcmc=dict(keep=c["keep"], burn=c["burn"],
                                thin=c["thin"]),
                      settings=dict(chunk=200), device="cpu")
    cpu = {k: dict(flops=v.work.flops, bytes=v.work.bytes) for k, v in
           part_work(fit.ms, fit.bounds, fit.cfg, fit.state).items()}
    card = {k: dict(flops=v["flops"], bytes=v["bytes"])
            for k, v in runs[1]["part_work"].items()}
    for k in card:
        print(f"  part {k}: card {card[k]}, CPU {cpu.get(k)}")
    _check(card == cpu, f"config 1's work per part differs: card {card}, "
           f"CPU {cpu}")
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spamtree_tpu_torch import bench
    import spamtree_tpu_torch  # noqa: F401  (sets the f32 precision pins)
    from spamtree_tpu_torch.ops import _build, chol, level

    if sys.argv[1:] == ["--probe-nccl"]:
        probe_nccl_capture(torch)
        return 0
    if sys.argv[1:] == ["--probe-writes"]:
        with _env(CUBLAS_WORKSPACE_CONFIG=":4096:8"):
            probe_row_writes(torch)
        return 0
    _phase("card")
    card_info(torch)
    _phase("build K1, K3, K4, K6")
    build_kernels(chol, level, _build, torch)
    if sys.argv[1:] == ["--resume-bits"]:
        torch.use_deterministic_algorithms(True)
        return 0 if resume_bits(bench, torch) else 1
    if sys.argv[1:] == ["--chains"]:
        ch = chains_phase(bench, chol, torch)
        accept_aware_chains_phase(bench, chol, level, torch, ch)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        mesh_phase(bench, torch)
        return 0
    if sys.argv[1:] == ["--graphs"]:
        graphs_phase(bench, torch)
        predict_phase(bench, torch,
                      _predict_fits(bench, chol, torch))
        return 0
    if sys.argv[1:] == ["--bench"]:
        bench_phase(bench, torch)
        return 0
    if sys.argv[1:] == ["--cov"]:
        _phase("K6 vs plain")
        check_cov_kernel(torch)
        return 0
    if sys.argv[1:] == ["--times"]:
        _phase("K1, K2, K3, K4, K6 times")
        time_kernel(chol, torch)
        time_kernel(chol, torch, write_l=True)
        time_kernel(chol, torch, shapes=TRIV_SHAPES, label="triv")
        time_kernel(chol, torch, shapes=Q5_SHAPES, label="q5")
        time_level_kernels(level, torch, CONFIG3_THIN)
        time_config5_kernels(chol, level, torch)
        check_cov_kernel(torch)
        return 0
    _phase("K1 vs plain")
    max_err = check_kernel(chol, torch)
    rows = time_kernel(chol, torch)
    time_kernel(chol, torch, write_l=True)
    triv_rows = time_kernel(chol, torch, shapes=TRIV_SHAPES, label="triv")
    q5_rows = time_kernel(chol, torch, shapes=Q5_SHAPES, label="q5")
    _phase("K6 vs plain")
    cov = check_cov_kernel(torch)
    rec = CovCalls(torch).install()  # every path's K6 calls from here
    _phase("config 1")
    # cut from the bench's keep=1000, burn=1000 (3200 iterations) to keep
    # the whole run near half its time limit
    run_config(bench, chol, torch, 1, keep=500, burn=500, thin=2)
    _phase("config 3")
    r3, thin3, fit3 = run_config(bench, chol, torch, 3, keep=100,
                                 burn=200, thin=2)
    _check(len(thin3) == 1, f"config 3 thin levels {thin3}")
    _phase(f"K3/K4 vs plain (config 3 thin level {thin3[0]})")
    lerr = check_level_kernels(level, torch, thin3[0])
    ltimes = time_level_kernels(level, torch, thin3[0])
    check_gibbs_shapes(level, torch)
    t5 = time_config5_kernels(chol, level, torch)
    _phase("config 1, accept-aware, level kernels")
    run_accept_aware(bench, chol, level, torch, 1, keep=250, burn=250, thin=2)
    _phase("config 3, accept-aware, level kernels, composed factors")
    run_accept_aware(bench, chol, level, torch, 3, keep=100, burn=200, thin=2)
    _phase("config 3, accept-aware, level kernels, no composed factors")
    a3, _ = run_accept_aware(bench, chol, level, torch, 3, keep=100,
                             burn=200, thin=2, composed=False)
    _check(a3["k4_launches"] > 0, "K4 never launched at config 3")
    _phase("config 1, limited tree, accept-aware, level kernels")
    run_accept_aware(bench, chol, level, torch, 1, keep=200, burn=200, thin=1,
                     limited=True)
    c5 = bench.CONFIGS[5]
    # configs 5, 2 and 4 at half their own depth (keep and burn), to keep
    # the whole run inside its time limit on a slow host (1041.7 s before
    # the cut, the limit 1200 s)
    kw5 = dict(keep=c5["keep"] // 2, burn=c5["burn"] // 2, thin=c5["thin"],
               chunk=c5["chunk"], limited=c5["kwargs"]["limited_tree"])
    _phase("config 5, limited tree, accept-aware, level kernels")
    a5, (ms5, state5) = run_accept_aware(bench, chol, level, torch, 5, **kw5)
    lv5 = [tuple(x) for x in a5["levels"]]
    _check([x[:2] for x in lv5[:len(CONFIG5_SHAPES)]] == CONFIG5_SHAPES
           and lv5[len(CONFIG5_SHAPES):] == CONFIG5_THIN
           and a5["thin_levels"] == CONFIG5_THIN,
           f"config 5 levels {lv5} are not the shapes the kernels were "
           f"checked and timed at")
    _check(set(a5["level_chunks"]) == {1} and set(a5["pred_chunks"]) == {1}
           and a5["pred_in_carry"], "config 5: a level runs in several chunks")
    # K3 ran on each of them in every iteration (checked with the run)
    _check(a5["k3_levels"] == a5["k4_levels"] == len(CONFIG5_THIN)
           and a5["k4_launches"] > 0,
           f"config 5: K3 on {a5['k3_levels']} levels, K4 on "
           f"{a5['k4_levels']}, {a5['k4_launches']} K4 launches")
    _phase("config 5, limited tree, always-emit (pipelined drain)")
    r8, _, fit8 = run_config(bench, chol, torch, 5, **kw5)

    # phases 9-11 at config 5's full width, each launching K1
    _phase("config 5, collect='summary', summary_draws=20")
    r9, _, _ = run_config(bench, chol, torch, 5, **kw5,
                          settings=dict(collect="summary", summary_draws=20),
                          draws=20)
    _check(r9["k1_launches"] > 0, "K1 never launched in the summary run")
    _phase("config 5, checkpoint every chunk, then resume")
    r10a, r10b, k1_10 = run_resume(bench, chol, torch, kw5)
    _phase("config 1, resume bit for bit")
    print(f"config 1 resume: {check_resume_bits(bench, torch)}")
    for name, r in (("always-emit, pipelined drain", r8),
                    ("collect='summary'", r9),
                    ("checkpointed, sequential drain (run A)", r10a),
                    ("resumed (run B)", r10b)):
        print(f"config 5 {name}: {r['iters']} iterations, mcmc_time "
              f"{r['mcmc_time']:.2f} s = iterations {r['iter_s']:.2f} s + "
              f"saves {r['save_s']:.2f} s + drains {r['drain_s']:.2f} s "
              f"(the drains' own work {r['drain_work_s']:.2f} s), "
              f"{r['ips']:.2f} it/s, peak {r['peak_mem_bytes'] / 1e9:.2f} GB",
              flush=True)
    _phase("config 5, predict_recompute vs predict; spamtree_predict")
    check_predict_recompute(torch, ms5, state5)
    del ms5, state5
    r11 = run_predict(bench, torch, fit8)
    print(f"spamtree_predict: {r11['s_per_draw'] * 1e3:.2f} ms per draw, "
          f"K1 launches {r11['k1_launches']} for {r11['n_draws']} draws, "
          f"setup {r11['breakdown']}", flush=True)

    c2, c4 = bench.CONFIGS[2], bench.CONFIGS[4]
    _phase("config 2, always-emit")
    r2, _, _ = run_config(bench, chol, torch, 2, keep=c2["keep"] // 2,
                          burn=c2["burn"] // 2, thin=c2["thin"])
    kw4 = dict(keep=c4["keep"] // 2, burn=c4["burn"] // 2, thin=c4["thin"])
    _phase(f"config 4 ({c4['kwargs']}), always-emit")
    r4, thin4, _ = run_config(bench, chol, torch, 4, **kw4,
                              **c4["kwargs"])
    _phase(f"config 4 ({c4['kwargs']}), accept-aware, level kernels, no "
           f"composed factors; K3/K4 vs plain at its thin levels {thin4}")
    a4, _ = run_accept_aware(bench, chol, level, torch, 4, **kw4,
                             composed=False, knobs=c4["kwargs"],
                             check_levels=True)
    _check(a4["thin_levels"] == thin4 and a4["k3_levels"]
           == a4["k4_levels"] == len(thin4) > 0,
           f"config 4: K3 on {a4['k3_levels']} and K4 on {a4['k4_levels']} "
           f"of the thin levels {a4['thin_levels']} ({thin4})")
    t4 = dict(k1=time_kernel(chol, torch, shapes=[
        (b, s) for b, s, p in a4["levels"] if (b, s, p) not in thin4],
        label="config-4"),
        k3=time_gibbs_shapes(level, torch, thin4, "config-4"),
        k4=time_decision_shapes(level, torch, thin4, None, "config-4"))
    _phase("oracle chain, float64, on the card")
    ro = run_oracle(torch)
    _phase("chains: K1 at the folded (C*B, S) shapes")
    ch = chains_phase(bench, chol, torch)
    mesh = mesh_phase(bench, torch)
    aa = accept_aware_chains_phase(bench, chol, level, torch, ch)
    graphs_phase(bench, torch)
    r20 = predict_phase(bench, torch, {5: fit8, 3: fit3})
    del fit8, fit3
    r21 = bench_phase(bench, torch)
    rec.remove()
    _phase("K6 vs plain at every path's calls")
    cov_paths = check_recorded_cov(torch, rec)
    _check({"config1", "config2", "config3", "config4", "config5"}
           <= set(cov_paths), f"K6 calls recorded in {sorted(cov_paths)}")
    del rec
    print(f"chip_smoke: every phase passed in {time.time() - _T0:.1f} s",
          flush=True)

    # One entry per kernel.  launches, ms, plain_ms, bound_ms, bound_by and
    # max_abs_err belong to one path, config 5's accept-aware run: ms is the
    # mean over that path's levels of one eager call at the level's shape
    # (each level launches its kernel equally often, so launches x ms is the
    # run's time in the kernel), and likewise plain_ms and bound_ms.  The
    # same for config 3's path stands beside them as *_config3 (K1's launches
    # from the always-emit run, K3's and K4's from the accept-aware run
    # without composed factors; at (1024, 68, 293) the yardstick of the
    # earlier records).  launches_paths: each kernel's launches in each run
    # of config 5 (the four of phases 8-10 through spamtree(), run A and B
    # of the resume together), in spamtree_predict, and in the runs of
    # phases 12-15 and 21 (the bench entry's subprocesses, which count
    # their own); K1 alone runs on the paths of phases 9-13, 15 and 21,
    # the level kernels being off there.  *_config4: config 4's accept-aware
    # run (phase 14): its launches, K3's and K4's f32 errors at its thin
    # levels, and each kernel's mean ms, plain ms and bound per launch at
    # its level shapes, timed after the run.
    paths = {"config5_always_emit": r8, "config5_summary": r9,
             "config5_predict": r11, "config2": r2, "config4": r4,
             "config5_predict_graphed": r20[5]["graphed"],
             "config3_predict_graphed": r20[3]["graphed"],
             "config4_accept_aware": a4, "oracle_f64": ro,
             "bench_config1": r21[1], "bench_config3": r21[3]} | {
                 f"config{i}_chains{C}": r for (i, C), r in ch["runs"].items()}
    # phase 17: each mesh run's launches per rank (each rank counts its
    # own, in its own process)
    for mode, by_rank in mesh["b_step"]["launches"].items():
        for r, c in enumerate(by_rank):
            paths[f"mesh_b_step_{mode}_rank{r}"] = c
    for key in ("a_config3", "b_config1", "b_config3", "b_config3_f64",
                "c_config3"):
        for r, c in enumerate(mesh[key]["launches_by_rank"]):
            paths[f"mesh_{key}_rank{r}"] = c
    # phase 18: the accept-aware batched runs, and the always-emit ones
    # it ran beside them
    for (i, C, comp), r in aa["runs"].items():
        paths[f"config{i}_accept_aware_chains{C}_"
              f"{'composed' if comp else 'joint'}"] = r
    for (i, C), r in aa["beside"].items():
        paths[f"config{i}_chains{C}"] = r
    def k1_path(rs):
        n = len(rs)
        return dict(ms=sum(r[2] for r in rs) / n,
                    plain_ms=sum(r[3] for r in rs) / n,
                    bound_ms=sum(r[4][0] for r in rs) / n,
                    bound_by=("bytes" if all(r[4][1] == "bytes" for r in rs)
                              else "operations"))

    def level_path(t, n):
        return dict(ms=t["ms"] / n, plain_ms=t["plain"] / n,
                    bound_ms=t["bound"] / n, bound_by=t["by"])

    def level_path5(key):
        return level_path(t5[key], len(CONFIG5_THIN))

    def level_path3(key):
        k, pl, (bd, by) = ltimes[key][:3]
        return dict(ms=k, plain_ms=pl, bound_ms=bd, bound_by=by)

    def entry(name, source, replaces, launches5, launches3, err5, err3,
              path5, path3, key, path4, err4=None):
        lp = {"config5_accept_aware": launches5} | {
            k: r[f"{key}_launches"] for k, r in paths.items()}
        lp["config5_resume"] = (k1_10 if key == "k1" else
                                r10a[f"{key}_launches"]
                                + r10b[f"{key}_launches"])
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    path="config5", launches=launches5, max_abs_err=err5,
                    **path5, library_ms=None, launches_config3=launches3,
                    max_abs_err_config3=err3,
                    **{f"{k}_config3": v for k, v in path3.items()},
                    launches_config4=a4[f"{key}_launches"],
                    **({} if err4 is None else
                       {"max_abs_err_config4": err4}),
                    **{f"{k}_config4": v for k, v in path4.items()},
                    launches_paths=lp)

    level_src = "spamtree_tpu_torch/csrc/thin_level.cu"
    k1 = entry(
        "inv_chol", "spamtree_tpu_torch/csrc/inv_chol.cu",
        "spamtree_tpu/ops/pallas_chol.py:107", a5["k1_launches"],
        r3["k1_launches"], max_err["config5"], max_err["config3"],
        k1_path(t5["k1"]), k1_path(rows), "k1", k1_path(t4["k1"]))
    # phase 3: K1 at the trivariate configuration's reference levels (mean
    # per level, as above), its 96-thread form, and at the q = 5
    # configuration's, its 128-thread form
    for label, trows in (("triv", triv_rows), ("q5", q5_rows)):
        k1.update({f"{k}_{label}": v for k, v in k1_path(trows).items()})
        k1[f"max_abs_err_{label}"] = max_err[label]
    # phase 16: K1 at config 3's and config 5's reference levels folded
    # over K1_FOLD_C chains (mean per level, as above), and its launches
    # in the batched runs of config 3
    for label in ("config3", "config5"):
        k1.update({f"{k}_{label}_c{K1_FOLD_C}": v for k, v in
                   k1_path(ch["times"][label]).items()})
        k1[f"max_abs_err_{label}_c{K1_FOLD_C}"] = ch["err"][label]
    k3, k4 = (entry(
        name, level_src, replaces, a5[f"{key}_launches"],
        a3[f"{key}_launches"], lerr["config5"][key], lerr["config3"][key],
        level_path5(key), level_path3(key), key,
        level_path(t4[key], len(thin4)), a4["level_err"][key])
        for name, key, replaces in (
            ("thin_gibbs", "k3", "spamtree_tpu/ops/pallas_level.py:306"),
            ("thin_decision", "k4", "spamtree_tpu/ops/pallas_level.py:186")))
    # phase 18: K4 folded over K4_FOLD_C chains at config 3's, config 4's
    # and config 5's thin levels (mean per level), and its device ms
    for label, (shapes, _) in _k4_fold_groups().items():
        t = aa["times"][label]
        c = f"{label}_c{K4_FOLD_C}"
        k4.update({f"{k}_{c}": v
                   for k, v in level_path(t, len(shapes)).items()})
        k4[f"device_ms_{c}"] = t["dev"] / len(shapes)
        k4[f"max_abs_err_{c}"] = aa["err"][label]
    # K6: one sweep's calls at config 3's and the q = 5 configuration's
    # shapes (f32, one chain), times summed; its launches in config 3's
    # always-emit run and each path's
    k6 = dict(name="ag10_cov", route="cuda",
              source="spamtree_tpu_torch/csrc/ag10_cov.cu", replaces=None,
              launches_config3=r3["cov_launches"],
              launches_paths={k: r.get("cov_launches") for k, r in
                              paths.items() if isinstance(r, dict)})
    for label, t in cov.items():
        k6.update({f"{k}_{label}": v for k, v in t.items()})
    k6["paths"] = cov_paths
    print(json.dumps({"kernels": [k1, k3, k4, k6]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
