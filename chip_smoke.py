#!/usr/bin/env python
"""Smoke check of the PyTorch/CUDA port (``nfisam_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``
(``--profile`` adds one solve under ``torch.profiler``).
It needs one CUDA card and the CUDA toolkit (``nvcc``), imports nothing
of JAX or of the JAX package, and exits non-zero if any phase fails:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel source (``nfisam_tpu_torch/csrc``: the
   specialised AR inverse and the generic one, in parallel); print each
   instantiation's registers, local memory, shared memory, weight slots
   and block shape (the generic kernel's nine at every generic shape of
   the cases, with its lanes a sample and how it holds the weights), and
   fail if one uses local memory (a stack frame or spills);
3. kernel vs plain: each case against the plain PyTorch version on the
   card, through the kernel ``kernel_variant`` names (the solver's shapes
   and edge cases, the 128 bucket, the JAX tests' shapes, the flow
   options' shapes, the utilization profile's n=262144 chain draw, and
   the corners of the generic kernel's plan: the 256
   bucket, h and K above 32, d=1, an odd h*d, n=999, a ring of weight
   slots), the generic kernel against the specialised one on the same
   inputs at (16, 8, 9), then both kernels timed with CUDA events at the
   main path's shapes, at d=32, 64 and 128, with every column pinned, and
   the generic kernel at ``--hidden 16``, at (16, 8, 9), at
   ``pad_dim_multiple=4``'s (12, 8, 9) n=2000 and at the 256 bucket, and
   the specialised kernel at the utilization profile's largest batch
   (n=262144, every dim inverted): a call as the host sees it (the kernel
   lines' ``ms``), and the kernel's device time alone; then the masked
   inverse's gradient (the kernel's forward, the implicit-function VJP)
   against autograd through the plain inverse at n=1000 and n=25, within
   1e-4; and the card's generator seeded from a key with both words set
   takes its 64-bit word whole (``utils.keys.generator_seed``);
4. case1 by the sequential ``NFiSAM`` (6 poses, 2 landmarks, 6 steps)
   at the journal configuration (2000 training samples per clique, K=9,
   hidden 8, lr 0.025, <= 2000 Adam iterations with the w=25/tol=0.04
   plateau stop, 1000 posterior draws, pose_first) for seeds 1-3, then
   the gates: median over seeds of the mean joint translation MMD against
   the committed posteriors in ``data/case1_ref`` <= 2x the reference
   run1's, and the kernel's z-space roundtrip residual on trained cliques
   <= max(4x the plain version's, 1e-3);
5. case1 by ``ParallelNFiSAM`` (the JAX package's bench.py solver:
   wavefront training, the fused posterior pass) for seeds 1-3, the same
   MMD gate; its seed-1 solve gives the kernel line's launch count;
6. plaza1's first 5 incremental steps (5 poses a step) through the plaza
   runner (``nfisam_tpu_torch.scripts.plaza_family_run``: ``ParallelNFiSAM``
   at the plaza configuration, 2000 training samples, K=9, hidden 8, lr
   0.01, w=50/tol=0.01, 1000 posterior draws, seed 0; mode repair off),
   per-step times, cliques trained and launches; gate: max posterior-mean
   translation error against the ``.fg``'s ground truth <= max(3x the
   JAX package's truth-initialised MAP floor's max error over the prefix,
   15 m), the port's own floor over the prefix printed beside it;
7. 8 disjoint robots of 4 poses, each ranging a landmark that has a
   tight prior, by ``ParallelNFiSAM`` and by ``NFiSAM`` (512 posterior
   draws, 768 training samples, <= 700 iterations, K=7, lr 0.03); gates:
   a bucket of 8 cliques trained in one batched loop, and the per-robot
   range posteriors' mean and std of the two solvers within 0.5 m;
8. the mode-repair graph of the JAX package's ``tests/test_mode_repair.py``
   (a landmark prior biased to the mirror mode, then a range that
   contradicts it) by ``ParallelNFiSAM`` at that test's settings (K=6,
   2000 training samples, <= 600 iterations, lr 0.03, mode repair on)
   for seeds 0-4; gates: for every seed the repair log is exactly ["L1"]
   and more than 90% of L1's samples lie at x > 0, and the median over
   seeds of the median |X1 - L1| is < 2.5 m, and every seed's < 3.0 m;
9. the separator trap (``separator_repair_graph``: the same mirror trap
   with L1 also in the separators of cliques below its own; one variant
   reaches them only by deep pruning, the other only by ``no_recycle``)
   at those settings, seed 0, with mode repair on and off; gates: on, the
   log is ["L1"] and every clique holding L1 retrains at the
   contradicting update; off, the log is empty and the separator-only
   cliques keep their models;
10. case1_da (case1 with its 4 ranges as two-way ambiguous data
   associations) through the case1_da runner
   (``nfisam_tpu_torch.scripts.case1_da_run``: ``ParallelNFiSAM`` at
   ``scripts/case1_da_run.py``'s configuration, one pose a step, 2000
   training samples, <= 2000 iterations, K=9, lr 0.025, 1000 posterior
   draws, mode repair on, through the run harness, the hypothesis weights
   read back from the run directory) for seeds 0-2; gates per seed: every
   pose's posterior-mean error < 3 m and the posterior weight on X1->L1
   and on X4->L2 > 0.7;
11. plaza1_ada0.2's first 5 incremental steps (5 poses a step) through
   the plaza runner with mode repair on; the runner's DA snapshots (the
   true-association weight and the resolved fraction, at steps 0 and 4)
   and the repair log are printed; gate: as plaza1's, with this prefix's
   floor;
12. the MAP floors at full size: the truth-initialised banked floor
   (``IncrementalGaussNewtonMAP``) over the whole plaza1 and 1101-pose
   Manhattan graphs, ``GaussNewtonMAP`` from the truth over the whole
   manhattan_plaza graph; gates: RMSE within 0.01 m of the JAX package's
   CPU band in the port's dtype (its banked program in float64), and a
   final NLL no higher than that band's nor than the JAX package's own
   float32 figure (``map_gate``); then the banked
   MAP's Hessian-vector products timed at plaza1's truth (an eager
   ``jvp`` of ``grad`` against the assembled sparse Hessian, which must
   agree within 1e-6);
13. the Manhattan-scale runner's smoke (the g8 graph, ccolamd, one pose a
   step, 2000 training samples, <= 500 iterations, K=9, lr 0.01, mode
   repair on) for its first 11 steps with the incremental MAP solved each
   step; per-step wall, surgery, fit, posterior and floor times, launches
   and cliques by dim bucket; gate: raw translation RMSE <= 40 m and the
   posterior anchored in the incremental MAP's gauge <= 2x that MAP's
   RMSE;
14. on each of those solvers' final state, the fused pass against the
   per-clique walk from the same key stream: max |diff| <= 1e-6 of the
   samples' scale, and both passes' times;
15. (inside 12) plaza1's truth floor solved twice in one process: both
   solves must give the same RMSE and final NLL bit for bit, and the
   product timing sets the fixed-order CSR product beside cuSPARSE's;
16. the eight-node R^2 displacement chain of the JAX package's
   ``examples/toy_examples/r2_relative_eight_nodes.py``, through the
   port's module of it (``nfisam_tpu_torch.examples``; natural
   ordering, K=8, 1500 training samples, <= 800 iterations, lr 0.03,
   1000 draws) by ``NFiSAM`` for seeds 0-2, against its exact Gaussian
   posterior (``gaussian_displacement_graph_moments``); gates: every
   variable's sample-mean error and the relative error of its sample
   variances within 2x the JAX package's worst over the same seeds on
   the CPU;
17. case1 by ``ParallelNFiSAM`` at the bench configuration, seed 1, from
   a copy of the checkpoint store the JAX package wrote on the CPU
   (``tests/torch_data/case1_jax_ckpt``): gates: no clique trained,
   kernel launches, and the mean joint MMD over steps 0-5 <= 2x the
   reference run1's, so the card's kernel draws through the JAX
   package's own flows;
18. the command line at full width: ``nfisam_tpu_torch.cli.main(["solve",
   ...])`` on lawnmower_4x4 (16 poses, 3 landmarks, 6 ambiguous ranges)
   at ``scripts/manhattan_run.py``'s configuration with a checkpoint
   directory, in this process; the run read back from its artifacts
   (step times, translation and landmark RMSE against the ``.fg``'s
   truth, the ambiguous factors' weights); gate: translation RMSE <=
   1.25x the worst of the JAX CLI's own runs over seeds 0-4 on the CPU.
   Then ``solve`` again from the same checkpoint directory (gates: no
   clique trained, every posterior mean within 1.0 m of the first run's),
   and ``python -m nfisam_tpu_torch baseline`` and ``mmd`` in
   subprocesses, which must exit 0;
19. the reference samplers at full width: ``nfisam_tpu_torch.cli.main(
   ["reference", "--sampler", "nested", ...])`` on the whole case1 graph
   (22 dims) at the command's defaults (1000 live points, rslice, 25
   replaced an iteration, dlogz 0.05) for seeds 1-3; gates per seed: logz
   within max(3.5 logzerr, 0.35) of the brute-force evidence -19.462, the
   MMD of the translation columns to the committed ``ns_step5.sample``
   within max(0.12, 1.25x the JAX CLI's worst on the CPU), and the
   ``--out`` files parse as the JAX CLI's; niter, ncall, eff, wall time
   and host reads printed; the kernel Stein discrepancy of 1000 of seed
   1's samples on the card (float32) and on the CPU (float64), which must
   agree to 1e-4 relative; before it, the samplers' inner evaluations
   timed eager and replayed from CUDA graphs;
20. (cut for time, PERF.md §4: ``dynamic_ns_phase``, dynamic nested
   sampling at the protocol behind ``ns_step5.sample``, runs alone)
21. ``reference --sampler nuts`` and ``--sampler smc`` on case1 (seed 0):
   finite samples and the MMD to ``ns_step5.sample`` within 1.25x the JAX
   CLI's worst over seeds 0-2 on the CPU; then the closed-form Gaussian
   graph of ``tests/test_samplers.py`` by all three samplers (means atol
   0.1, variances rtol 0.15) and its ring graph's analytic arc by nested
   sampling (400 live) and SMC (4000; the NUTS ring oracle is cut for
   time);
22. the nested clique-sampling path (``local_sampling_method="nested"``):
   the loop graph of ``tests/test_solver_e2e.py`` at its settings and
   gate, then case1's first 3 steps (cut for time) by ``NFiSAM`` at the
   bench configuration, seed 1; gates: the mean joint MMD over the steps
   <= 2x the reference run1's (the JAX package meets it on the CPU),
   kernel launches, and each flow prior's ``unif_to_sample`` through the
   kernel against the plain inverse at the path's batch of 50 rows;
23. the flow options on case1 at the bench configuration, steps 0-5:
   ``cli.main(["solve", ..., "--hidden", "16", "--training-set-frac",
   "0.9"])`` for seeds 1-3 (the generic kernel; the validation stop), and
   ``ParallelNFiSAM`` with ``pad_dim_multiple=4`` (the generic kernel)
   and with ``dim_bucket_floor=128`` (every clique at d=128, h=64, the
   specialised kernel), seed 1; Adam iterations per clique, the cliques
   the validation rule stopped and the launches by kernel printed; gate:
   the mean joint MMD (the median over seeds for the command line) <=
   max(2x reference run1's, 1.25x the JAX package's worst on the CPU at
   the same options);
24. R^2 odometry: ``GaussNewtonMAP``, ``IncrementalGaussNewtonMAP`` and
   ``baseline`` (the eight-node chain written by the port's ``.fg``
   writer) on the eight-node chain and on the JAX package's closed-form
   MAP test graph, every estimate within 1e-3 m of the exact mean; then
   ``examples/toy_examples/r2_range_incremental.py``'s 4 steps by
   ``NFiSAM`` through the port's module of it, with mode repair on,
   seeds 0-2: L1's mean range to X0, X2
   and X3 within 0.5 m of 5.0, 4.0 and 5.0, the repair log printed beside
   the JAX package's on the CPU;
25. ``python -m nfisam_tpu_torch.parallel.dryrun multihost``: 2 ranks on
   this card (gloo) solve a 4-robot graph, each training its chunk of
   every bucket (300 iterations, 600 training samples, 500 draws, K=6),
   beside single-rank solves at seeds 3, 4 and 5; gates: disjoint,
   non-empty chunks, the ranks' moments within 1e-5, the worst
   translation MMD to the same-seed single rank < 0.05, the worst
   range-posterior MMD to seed 4 < max(2x seed 5's, 0.552), the kernel
   launched in every process, the fused pass equal to the walk;
26. ``python -m nfisam_tpu_torch.parallel.dryrun multichip 4``: 4 ranks
   on this card solve case1 (2 steps of 3 poses) at the journal
   configuration on a (2, 2) (clique, data) mesh and the 8 robots
   (K=6, <= 700 iterations, 768 samples, 512 draws) on a (4, 1) mesh,
   ``data_parallel_mesh`` and ``sample_mesh`` set, beside one world-1
   process; gates: case1's joint translation MMD to world 1 < 0.05 on a
   500-row subsample and the fused pass's rows split 2 ways; a bucket of
   >= 4 cliques and each robot's range mean and width within 0.5 m of
   world 1; the ranks' samples equal; the kernel launched in every
   process; the fused pass equal to the walk;
27. the headline Manhattan stream's first ``MANHATTAN_G16_STEPS`` steps
   (``nfisam_tpu_torch.scripts.manhattan_scale_run`` at the JAX
   package's headline flags: the g16 random walk, pose_first, the
   runner's configuration, the incremental MAP solved each step); per-step
   wall, surgery, fit, posterior and floor times, launches and cliques by
   dim bucket; gates: the runner's accuracy gate, the anchored RMSE <= 2x
   the JAX package's worst over seeds 0-2 on the CPU at the same prefix,
   finite samples, the fused pass equal to the walk, and the specialised
   kernel launched at (32, 16, 9) (the 32 bucket's flow);
28. the plaza runner's other streams in one child (``PLAZA_FAMILY``:
   plaza2, plaza1_ada0.4, plaza1_ada0.6 and plaza1_ada0.6 with
   ``--defer-da``, mode repair on), each cut to ``PLAZA_FAMILY_STEPS``;
   gates: the runner's divergence rule with the JAX package's float32
   floor over the prefix and its DA resolution rule, finite samples, the
   fused pass equal to the walk, the specialised kernel launched;
29. the random_4x4 sweep's ``run_seed`` on files 0 and 1 in one child
   (16 poses a file, one a step); gates: each file's translation RMSE <=
   1.25x the JAX package's worst on that file over solver seeds 0-2 on
   the CPU, finite samples, the fused pass equal to the walk, launches;
30. the manhattan_plaza runner (``nfisam_tpu_torch.scripts.
   manhattan_plaza_run``: the run harness, 500 iterations a fit, one pose
   a step) cut to ``MANHATTAN_PLAZA_STEPS`` in a child; gates: the
   runner's 1.1x rule against ``GaussNewtonMAP`` over the prefix from
   the truth where it applies, translation RMSE <= 2x the JAX package's
   CPU worst over seeds 0-2 at the prefix, finite samples, the fused pass
   equal to the walk, launches, and the run directory's files those of
   the JAX package's harness without the plots;
31. in one child: the case1_da runner's oracle, dynamic nested sampling
   over the whole case1_da graph at the JAX script's arguments (1000 live
   points, 3 batches, key [0, 7]) and each mixture's posterior weights on
   its samples; then the lawnmower_4x4 runner
   (``nfisam_tpu_torch.scripts.manhattan_run``) in its steady pass at seed
   1 (16 steps, ``scripts/manhattan_run.py``'s configuration); gates: the
   oracle's logz within max(3.5 logzerr, 0.35) of the mean of the JAX
   script's own oracle on the CPU over keys [0-2, 7], its weight on each
   true association at least the JAX CPU worst less 0.05; the pass's
   translation RMSE <= 1.25x the JAX script's CPU worst over seeds 1-5,
   finite samples, the fused pass equal to the walk, launches;
32. in one child, the repo's examples through the port's modules
   (``nfisam_tpu_torch.examples``), each at the JAX example's
   configuration: eight_pose_circle (an SE(2) loop closure, natural
   ordering, K=9, one batch solve), five_node_range_incremental (SE(2)
   poses and a range landmark, K=8, 4 steps), run_nfisam (case1 by
   ``NFiSAM`` through the run harness at the journal configuration) then
   its MMD through the example's ``compute_mmd``,
   generate_reference_solution (static nested sampling, 1000 live
   points, on case1's first 4 of 6 prefixes: cut for time, PERF.md §4)
   and generate_and_run (a
   lawnmower world generated at seed 1, its ``.fg`` written, solved 5
   poses a step); gates: every pose's posterior mean (translation and
   heading) within 2x the JAX example's CPU worst distance from
   ``GaussNewtonMAP`` of the graph, every std finite and > 0; at each
   five-node step the poses within 2x the JAX worst distance from that
   step's MAP, and L1's share on each side of the x-axis inside the JAX
   band widened by 0.1; run_nfisam's mean joint MMD <= 2x the reference
   run1's; each NS step's joint MMD to ``data/case1_ref`` <= 2x the JAX
   example's worst; the ``.fg``'s sha256 the JAX example's and the
   translation RMSE <= 1.25x the JAX worst over solver seeds 0-2; the
   fused pass equal to the walk and launches for every solver.

Phases 25-32 and 11 (plaza1_ada0.2) run in child processes, started
after the kernel checks (which are timed alone on the card) and joined
before step 14's fused-pass checks, where the host has at least
``PARALLEL_MIN_CORES`` usable cores and the card is in the ``Default``
compute mode; otherwise phase 11 runs in this process and phases 25-32
one after another after phase 24.  The host's core counts and the
compute mode are printed first.  The children's launched shapes join
this process's for the final check.

Each solve's kernel launches are counted from 0 just before it and read
just after; the specialised kernel line's ``launches`` are
lawnmower_4x4's (18) and phases 27-32's, the generic kernel line's phase
23's seed-1 solve through the command line; the phase-22 case1 solve's
are printed and must be > 0.  The output ends with one ``{"kernels":
[...]}`` JSON line (both kernels), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from nfisam_tpu_torch.examples.manhattan_world_with_range import \
    generate_and_run as gar
from nfisam_tpu_torch.examples.small_range_gaussian_problem import (
    compute_mmd, generate_reference_solution, run_nfisam)
from nfisam_tpu_torch.examples.toy_examples import (
    eight_pose_circle, five_node_range_incremental, r2_range_incremental,
    r2_relative_eight_nodes as r8)
# the R^2 toys' graphs and arguments (the CPU tests read them here too)
from nfisam_tpu_torch.examples.toy_examples.r2_range_incremental import (
    R2_RANGE_ARGS, r2_range_graph)
from nfisam_tpu_torch.examples.toy_examples.r2_relative_eight_nodes import (
    EIGHT_NODE_ARGS, eight_node_graph)
from nfisam_tpu_torch.scripts import case1_da_run as cdr
from nfisam_tpu_torch.scripts import manhattan_plaza_run as mpr
from nfisam_tpu_torch.scripts import manhattan_run as mr
from nfisam_tpu_torch.scripts import plaza_family_run as pfr
from nfisam_tpu_torch.scripts import random_4x4_sweep as r44
from nfisam_tpu_torch.scripts.manhattan_scale_run import (
    ANCHORED_FACTOR, RMSE_BOUND_M, floor_from_truth, host_samples,
    manhattan_gate, parse_args, point_errors, run_incremental,
    solve_manhattan)

HERE = os.path.dirname(os.path.abspath(__file__))
CASE1_FG = os.path.join(HERE, "data", "case1_factor_graph.fg")
REF_DIR = os.path.join(HERE, "data", "case1_ref")
SEEDS = (1, 2, 3)
MMD_STEPS = (0, 1, 2, 3, 4, 5)
MMD_SUBSET = 500
MMD_GATE_FACTOR = 2.0
KERNEL_TOL = 1e-5               # atol and rtol of the kernel check
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the journal-paper case1 configuration (the JAX package's bench.py)
BENCH_ARGS = dict(posterior_sample_num=1000, local_sample_num=2000,
                  flow_iterations=2000, num_knots=9, learning_rate=0.025,
                  hidden_dim=8, average_window=25, loss_delta_tol=0.04,
                  elimination_method="pose_first", mode_repair=False)
# plaza1 (778 poses, 4 landmarks, the three case1 factor types) at the
# configuration of the JAX package's plaza runs
# (scripts/plaza_family_run.py: 5 poses a step, default w=50/tol=0.01
# plateau stop, seed 0), cut to its first PLAZA_STEPS incremental steps
# (5 of 156: with the data-association phases the whole run must stay
# inside its time limit on a slow host; no fewer, since after 4 steps two
# landmarks still sit on their range rings, and the JAX package's
# posterior misses L3 by 78 m there too)
PLAZA1_FG = os.path.join(HERE, "data", "plaza1_factor_graph.fg")
PLAZA_ARGS = {**pfr.solver_args(0), "mode_repair": False}
PLAZA_STEPS = 5
# the absolute floor of the plaza runs' gate on the max posterior-mean
# translation error (scripts/plaza_family_run.py)
PLAZA_GATE_M = pfr.GATE_M
# the robots graph: R disjoint robots of T poses (__graft_entry__.py), at
# that entry's solver settings with K=7 (the entry's K=6 would move the
# numbers of earlier runs)
ROBOTS, ROBOT_STEPS = 8, 4
ROBOT_ARGS = dict(posterior_sample_num=512, local_sample_num=768,
                  flow_iterations=700, num_knots=7, hidden_dim=8,
                  learning_rate=0.03, elimination_method="pose_first",
                  seed=0, mode_repair=False)
# gates: the two solvers' per-robot range posteriors (mean and std, m),
# and the fused pass against the per-clique walk (relative to the scale)
ROBOT_GATE_M = 0.5
FUSED_TOL = 1e-6
# the mode-repair graph at the settings and gates of the JAX package's
# tests/test_mode_repair.py
REPAIR_ARGS = dict(posterior_sample_num=500, local_sample_num=2000,
                   flow_iterations=600, num_knots=6, hidden_dim=8,
                   learning_rate=0.03, elimination_method="pose_first",
                   seed=0, mode_repair=True)
# the distance gates: the median over seeds of the median |X1 - L1| below
# the JAX test's 2.5 m, and every seed's below 3.0 m.  The posterior of L1
# is an extrapolation (its prior puts almost none of 2000 training samples
# near the truth), and the JAX package's own solve reads 1.68 to 2.77 m
# over seeds 0-4 (``python tests/test_torch_mode_repair.py``, CPU), so one
# seed's 2.5 m bound tests the seed; a landmark left in the wrong mode
# reads about 7 m, which the per-seed bound catches on any seed
REPAIR_SEEDS = (0, 1, 2, 3, 4)
REPAIR_GATE_M = 2.5
REPAIR_SEED_GATE_M = 3.0
REPAIR_HALF_PLANE = 0.9
# the separator trap's poses (the truth; L1 at (4, 0))
SEPARATOR_TRUTH = {"X0": (0.0, 0.0), "X1": (0.0, 1.0), "X2": (0.0, 2.0),
                   "X3": (3.0, 2.0)}
# case1_da through its runner (scripts/case1_da_run.py's configuration,
# mode repair on), gated as the JAX package's tests/test_ada_e2e.py; the
# association of each observer by the geometry of the ground truth
CASE1_DA_FG = cdr.DATA
DA_SEEDS = (0, 1, 2)
DA_POSE_GATE_M = 3.0
DA_WEIGHT_GATE = 0.7
DA_TRUE = cdr.TRUE_ASSOC
DA_GATED = ("X1", "X4")
# phase 31: the case1_da runner's oracle (key [0, 7]) and the lawnmower_4x4
# runner's steady pass at seed MANHATTAN_RUN_SEED.  The JAX script's own
# oracle on the CPU for the keys [s, 7], s = 0-2 (python
# tests/test_torch_case1_da_run.py): the mean logz (-22.0906, -22.0959,
# -22.1617) and each true association's worst weight; the gates: logz
# within max(LOGZ_ERR_FACTOR x logzerr, LOGZ_FLOOR) of that mean, each
# weight >= the worst less DA_ORACLE_WEIGHT_MARGIN
JAX_DA_ORACLE_LOGZ = -22.116073151472325
JAX_DA_ORACLE_WORST = {"X1": 0.9999999980915593, "X2": 0.9724571544320356,
                       "X3": 0.9703278001759651, "X4": 0.9999999988456485}
DA_ORACLE_WEIGHT_MARGIN = 0.05
# the JAX script's steady runs for seeds 1-5 on the CPU (python
# tests/test_torch_manhattan_run.py): translation RMSE 4.152, 3.972,
# 2.993, 5.257, 3.704 m; the gate: <= LAWNMOWER_GATE_FACTOR x the worst
MANHATTAN_RUN_SEED = 1
JAX_MANHATTAN_RUN_WORST = 5.257
# the JAX package's weights on the true association, taken on a TPU
# (BENCHMARKS.md, case1_da section): a reference, not a port's number
DA_TPU_WEIGHTS = {"X1": 0.996, "X2": 0.875, "X3": 0.817, "X4": 0.991}
# plaza1_ada0.2 (plaza1 with 20% of its ranges ambiguous over the 4
# landmarks) at the plaza configuration with mode repair on, cut to its
# first PLAZA_ADA_STEPS steps (5 of 156: with the MAP and Manhattan-scale
# phases the whole run must stay inside its time limit on a slow host)
PLAZA_ADA_FG = os.path.join(HERE, "data", "plaza1_ada0.2_factor_graph.fg")
PLAZA_ADA_ARGS = {**PLAZA_ARGS, "mode_repair": True}
PLAZA_ADA_STEPS = 5
# the MAP floors at full size: the truth-initialised banked floor
# (plaza_family_run.py's map_floor recipe: 15 warm LM-CG iterations) over
# the whole plaza1 and 1101-pose Manhattan graphs, and GaussNewtonMAP from
# the truth column over the whole manhattan_plaza graph
MANHATTAN_SCALE_FG = os.path.join(
    HERE, "data", "manhattan_scale_g16_l6_ada0.2_rp1_rw.fg")
MANHATTAN_PLAZA_FG = os.path.join(HERE, "data",
                                  "manhattan_plaza_factor_graph.fg")
# the full-size MAP cases: label -> (graph, solver), the solver "banked"
# for the truth-initialised IncrementalGaussNewtonMAP floor, "laplace" for
# GaussNewtonMAP from the truth column
MAP_CASES = {
    "plaza1 truth floor": (PLAZA1_FG, "banked"),
    "manhattan g16 truth floor": (MANHATTAN_SCALE_FG, "banked"),
    "manhattan_plaza Laplace MAP": (MANHATTAN_PLAZA_FG, "laplace"),
}
# the case solved twice in one process, which must give the same bits
REPEAT_MAP_CASE = "plaza1 truth floor"
# each case's figures from the JAX package on the CPU (``JAX_PLATFORMS=cpu
# python tests/test_torch_map.py``): its own solve from the truth (RMSE m,
# max error m, LM iterations, final NLL), and the band ((RMSE lo, hi), (NLL
# lo, hi)) over the truth and three starts moved by 2e-7 of themselves of
# its solve in the port's dtype: its banked LM-CG program in float64
# (``test_torch_map.JaxFloat64MAP``; the port's ``MAP_DTYPE``), and
# GaussNewtonMAP in float32, as in both packages
JAX_MAP_FLOORS = {
    "plaza1 truth floor": (0.31164272078311206, 1.106602455073327, 15,
                           -5115.55419921875),
    "manhattan g16 truth floor": (1.0613879826757084, 3.3519659412475225,
                                  10, -3287.762451171875),
    "manhattan_plaza Laplace MAP": (7.545495228381698, 14.216541655043805,
                                    100, -477.1616516113281),
}
JAX_MAP_BANDS = {
    "plaza1 truth floor": ((0.38566065871435345, 0.3919802502185818),
                           (-5118.428332128017, -5118.38011183169)),
    "manhattan g16 truth floor": ((1.0630196156523468, 1.0631021658017803),
                                  (-3287.7709831176926, -3287.770727888295)),
    "manhattan_plaza Laplace MAP": ((7.545495228381698, 7.575012279267921),
                                    (-477.1619873046875, -477.1614990234375)),
}
# the gates on each card figure (PERF.md gives the readings each limit was
# set from): RMSE within MAP_RMSE_TOL_M of its JAX_MAP_BANDS band, and a
# final NLL no higher than that band's by MAP_BAND_NLL_RTOL of it nor than
# the JAX package's own solve's by MAP_NLL_RTOL.  A banked floor solved in
# float32 stops at its iteration cap wherever its rounding takes it
# (plaza1: the JAX package's 0.2817-0.3117 m, the port's 0.3486-0.3641 m
# on the card at NLL -5117.52 to -5117.91), which the first two gates fail
MAP_RMSE_TOL_M = 0.01
MAP_BAND_NLL_RTOL = 2e-6
MAP_NLL_RTOL = 1e-5
# the JAX package's truth-initialised floor over each plaza prefix's nodes
# and factors: its max error (m) on the CPU (same script), which bounds the
# divergence gate as in plaza_family_run.py.  Its float32 solve stops at
# its 15-iteration cap near the truth start; the port's float64 floor
# (printed beside) goes on farther (plaza1 max 3.2-3.3 m, JAX's own in
# float64 2.15 m), so it would loosen the bound.  The plaza family's at
# PLAZA_FAMILY_STEPS: ``JAX_PLATFORMS=cpu python
# tests/test_torch_plaza_family.py --steps N --floors``
JAX_PREFIX_FLOOR_MAX = {"plaza1": 0.9797327337812113,
                        "plaza1_ada0.2": 1.006755522254178,
                        "plaza2": 0.8168075546115748,
                        "plaza1_ada0.4": 0.913322461983286,
                        "plaza1_ada0.6": 1.0991732382380441,
                        "plaza1_ada0.6_deferda": 1.122777384976389}
# the plaza runner's other streams (nfisam_tpu_torch/scripts/
# plaza_family_run.py, the JAX package's scripts/plaza_family_run.py:
# PLAZA_ARGS with mode repair on, the runner's default), in one child:
# label -> (dataset, --defer-da), each cut to PLAZA_FAMILY_STEPS[label]
# steps: PLAZA_STEPS, or the smallest longer prefix where the JAX
# package's own CPU runs at PLAZA_STEPS fail the runner's divergence gate
# (``JAX_PLATFORMS=cpu python tests/test_torch_plaza_family.py``, each
# step's max error).  At 5 steps the JAX package's plaza1_ada0.4 misses
# by 111.3 / 34.2 / 110.0 m over seeds 0-2 and plaza1_ada0.6 by 80.8 /
# 16.0 / 108.9 m, with --defer-da 100.4 / 87.2 / 86.8 m; plaza2 passes for
# seeds 0-2 (3.71 / 6.57 / 4.43 m) but not seed 3 (17.64 m: L3 on its
# range ring from 5 ranges along a 2 m path; the port's seeds 0-7 on the
# card 18.21, 8.27, 2.54, 5.10, 8.54, 7.57, 4.74, 3.63 m).  Gates: the
# runner's divergence rule at the prefix with the JAX package's float32
# floor (JAX_PREFIX_FLOOR_MAX) and its resolution rule (the ada streams:
# those JAX runs meet it, JAX_PLAZA_FAMILY), finite samples, the fused
# pass equal to the walk, launches of the specialised kernel
PLAZA_FAMILY = {"plaza2": ("plaza2", False),
                "plaza1_ada0.4": ("plaza1_ada0.4", False),
                "plaza1_ada0.6": ("plaza1_ada0.6", False),
                "plaza1_ada0.6_deferda": ("plaza1_ada0.6", True)}
PLAZA_FAMILY_STEPS = {"plaza2": 6, "plaza1_ada0.4": 7, "plaza1_ada0.6": 6,
                      "plaza1_ada0.6_deferda": 6}
# label -> the JAX package's CPU runs at that prefix over seeds 0-2 (and 3
# for plaza2): (max posterior-mean errors m, last DA resolutions)
JAX_PLAZA_FAMILY = {
    "plaza2": ((2.5881504288380763, 3.678218765756142, 5.140943931056928,
                5.224159703352074), None),
    "plaza1_ada0.4": ((5.891907379356887, 2.83217577428406,
                       3.689497862971998), (1.0, 0.923, 1.0)),
    "plaza1_ada0.6": ((3.5991471573093565, 10.627988895230445,
                       3.8606240442223583), (0.857, 0.929, 0.857)),
    "plaza1_ada0.6_deferda": ((7.093219235191531, 3.376387663567736,
                               3.0433499467967966), (0.786, 0.857, 0.857))}
# the random_4x4 sweep (nfisam_tpu_torch/scripts/random_4x4_sweep.py, the
# JAX package's scripts/random_4x4_sweep.py: 16 poses a file, one a step,
# PLAZA_ARGS' settings, mode repair on) on RANDOM_4X4_FILES in one child;
# gate: each file's translation RMSE <= LAWNMOWER_GATE_FACTOR x the worst
# of the JAX package's runs of that file over solver seeds 0-2 on the CPU
# (``JAX_PLATFORMS=cpu python tests/test_torch_random_4x4.py``), finite
# samples, the fused pass equal to the walk, launches.  Files 0 and 1:
# with file 2 the script in turn was projected to ~1,077 s of phases, at
# its 1,080 s limit (PERF.md §4)
RANDOM_4X4_FILES = (0, 1)
JAX_RANDOM_4X4_WORST = {0: 4.258713847160365, 1: 13.554290557949342}
# the manhattan_plaza runner (nfisam_tpu_torch/scripts/manhattan_plaza_run.py,
# the JAX package's scripts/manhattan_plaza_run.py: the run harness, 500
# iterations with no plateau stop, one pose a step) cut to
# MANHATTAN_PLAZA_STEPS of 136 steps in a child; gates: the runner's 1.1x
# rule against GaussNewtonMAP over the prefix from the truth column (the
# smallest prefix of >= 30 steps at which the JAX package's own runs over
# solver seeds 0-2 on the CPU meet it, ``JAX_PLATFORMS=cpu python
# tests/test_torch_manhattan_plaza.py``),
# translation RMSE <= MANHATTAN_PARITY_FACTOR x the worst of those runs at
# the prefix, finite samples, the fused pass equal to the walk, launches,
# and the run directory's artifact set that of the JAX package's harness
# without its plots.  At 30 steps the JAX package's seed 0 reads 8.1099 m
# against a floor of 6.9812 m (1.1617x); at 31 its seeds read 7.1612,
# 3.7534 and 4.9292 m against 7.0444 m (<= 1.0166x)
MANHATTAN_PLAZA_STEPS = 31
JAX_MANHATTAN_PLAZA_WORST = 7.161159029249161
# the Manhattan-scale runner (nfisam_tpu_torch/scripts/manhattan_scale_run.py,
# the JAX package's scripts/manhattan_scale_run.py) at its configuration
# (:197-202: ParallelNFiSAM, one pose a step, 2000 training samples, <= 500
# iterations, K=9, h=8, lr 0.01, 1000 draws, seed 0, mode repair on), with
# the warm-started incremental MAP solved every step, and its accuracy gate
# (:433-436: raw translation RMSE <= 40 m, the posterior anchored in the
# incremental MAP's gauge <= 2x that MAP's raw RMSE).  Its smoke: the g8
# graph (--grid 8 --landmarks 6: 64 poses, 6 landmarks, 114 factors, 8 ADA)
# under ccolamd, cut to MANHATTAN_STEPS: at step 11 both packages raise (the
# simulation of the leaf clique {L3 | X11} has no prior to start from;
# ROADMAP §C)
MANHATTAN_G8_FG = os.path.join(HERE, "data",
                               "manhattan_scale_g8_l6_ada0.2_s60.fg")
MANHATTAN_STEPS = 11
MANHATTAN_G8_ARGV = ["--grid", "8", "--landmarks", "6", "--limit-steps",
                     str(MANHATTAN_STEPS)]
# the runner's headline stream (its docstring's first command, the JAX
# script's :33-35: data/manhattan_scale_g16_l6_ada0.2_rp1_rw.fg, 1101 poses,
# 6 landmarks, 2202 factors, 236 ADA; pose_first), in a child process, cut
# to its first MANHATTAN_G16_STEPS of 1101 steps.  pose_first trains one
# clique a step; on the card the 32 bucket (h=16: the specialised kernel at
# MANHATTAN_G16_SHAPE) trains from step 16 on (PERF.md §5), so 48 steps
# train 31 there.  Fewer steps would gate the seed, not the port: at 40
# the JAX package's own anchored posterior exceeds 2x its incremental MAP
# for two of seeds 0-2 (7.948 and 4.979 against 4.840 m), at 48 for none.
# Gates: the runner's accuracy gate, and parity: anchored <=
# MANHATTAN_PARITY_FACTOR x the worst of the JAX package's runner loop at
# the same prefix over seeds 0-2 on the CPU (``JAX_PLATFORMS=cpu python
# tests/test_torch_manhattan_scale.py``)
MANHATTAN_G16_STEPS = 48
MANHATTAN_G16_ARGV = ["--grid", "16", "--landmarks", "6", "--range-prob",
                      "1.0", "--sensing", "0", "--traj", "random_walk",
                      "--waypoints", "1100", "--ordering", "pose_first",
                      "--limit-steps", str(MANHATTAN_G16_STEPS)]
MANHATTAN_G16_SHAPE = (32, 16, 9)
JAX_MANHATTAN_G16_WORST = 3.5875400165335942
MANHATTAN_PARITY_FACTOR = 2.0
# the eight-node R^2 chain (the port's examples.toy_examples.
# r2_relative_eight_nodes, EIGHT_NODE_ARGS) at that example's configuration,
# seeds 0-2; its gate is 2x the JAX package's worst over the same seeds on
# the CPU (``JAX_PLATFORMS=cpu python tests/test_torch_oracles.py``): the
# sample-mean error (m) and the relative error of a sample variance
EIGHT_NODE_SEEDS = (0, 1, 2)
JAX_EIGHT_NODE_WORST = (0.07326130467005305, 0.15221419708862693)
EIGHT_NODE_GATE_FACTOR = 2.0
# the checkpoint store the JAX package wrote on the CPU of case1 at
# BENCH_ARGS, seed 1 (``JAX_PLATFORMS=cpu python
# tests/test_torch_checkpoint.py``)
CASE1_JAX_CKPT = os.path.join(HERE, "tests", "torch_data",
                              "case1_jax_ckpt")
# lawnmower_4x4 through the command line at scripts/manhattan_run.py's
# configuration; gate: translation RMSE <= 1.25x the worst of the JAX
# CLI's own runs of the same command over seeds 0-4 on the CPU
# (``JAX_PLATFORMS=cpu python tests/test_torch_cli.py``), with the JAX
# package's TPU figure (BENCHMARKS.md:43, median [min, max] over 5 seeds)
# printed beside it; a rerun from the same checkpoint directory trains
# nothing and moves no posterior mean by more than 1.0 m
# (tests/test_checkpoint.py's bound)
LAWNMOWER_FG = os.path.join(HERE, "data", "lawnmower_4x4_factor_graph.fg")
JAX_LAWNMOWER_WORST = 5.256669996679982
LAWNMOWER_GATE_FACTOR = 1.25
TPU_LAWNMOWER_RMSE = "3.28 [1.65, 4.21]"
RERUN_MEAN_GATE_M = 1.0


# the reference samplers on case1 (the step-5 graph: 6 SE(2) poses, 2
# landmarks, 22 dims) through ``cli.main(["reference", ...])`` at the
# command's defaults (1000 samples; nested: rslice, 25 replaced an
# iteration, dlogz 0.05).  Gates: nested logz within max(3.5 logzerr,
# 0.35) of the brute-force evidence (BENCHMARKS.md:203-214, 24M prior
# draws: -19.462 +- 0.014; tests/test_nested_dynamic.py's rule), and the
# MMD of the translation columns against the committed nested-sampling
# posterior ns_step5.sample (``ns_step5_mmd``) within
# max(NS_PAIR_TOL, 1.25x) the JAX CLI's worst on the CPU (nested, seeds
# 1-3: ``python tests/test_torch_reference_cli.py``; NUTS and SMC, seeds
# 0-2: ``python tests/test_torch_nuts_smc.py``); NS_PAIR_TOL is
# scripts/make_case1_step45_refs.py's seed-pair tolerance
NS_STEP5 = os.path.join(REF_DIR, "ns_step5.sample")
CASE1_TRUE_LOGZ = -19.462
LOGZ_ERR_FACTOR = 3.5
LOGZ_FLOOR = 0.35
NS_PAIR_TOL = 0.12
SAMPLER_GATE_FACTOR = 1.25
JAX_REFERENCE_MMD_WORST = {"nested": 0.053653769126314324,
                           "nuts": 0.056412739954757984,
                           "smc": 0.5176674053363012}
# dynamic NS at the protocol behind ns_step5.sample
# (scripts/make_case1_step45_refs.py:80-84), seed 11: ``dynamic_ns_phase``,
# cut from ``main`` for time (PERF.md §4), run alone from ``python3 -c``.
# The KSD of KSD_ROWS nested-sampling draws under the case1 joint (a
# Gaussian kernel of precision I / KSD_BANDWIDTH2), on the card in float32
# and on the CPU in float64, agreeing to KSD_RTOL
DYNAMIC_SEED = 11
DYNAMIC_LIVE = 1200
DYNAMIC_ITERS = 6000
KSD_ROWS = 1000
KSD_BANDWIDTH2 = 4.0
KSD_RTOL = 1e-4
# the closed-form Gaussian graph and the ring graph of
# tests/test_samplers.py, at its settings and tolerances
ORACLE_RUNS = [("nested", {"live_points": 600, "max_iters": 2500}),
               ("smc", {"num_samples": 4000}),
               ("nuts", {"num_samples": 3000, "num_warmup": 500})]
# (the NUTS ring oracle, 12000 draws of 8 chains, is cut for time:
# PERF.md §4)
RING_RUNS = [("nested", {"live_points": 400, "max_iters": 1500}),
             ("smc", {"num_samples": 4000})]
ORACLE_MEAN_ATOL = 0.1
ORACLE_VAR_RTOL = 0.15
# the nested clique-sampling path: the graph of tests/test_solver_e2e.py's
# test_nested_clique_training_path at its settings and gate, then case1 by
# NFiSAM at BENCH_ARGS with local_sampling_method="nested", seed 1, cut to
# its first NESTED_CASE1_STEPS steps for time (PERF.md §4); gate: mean
# joint MMD over those steps <= 2x reference run1's over them
# (MMD_GATE_FACTOR), which the JAX package meets on the CPU (its per-step
# MMDs, ``python tests/test_torch_nested.py``: JAX_NESTED_CASE1_PER_STEP);
# ``unif_to_sample`` through the kernel against the plain inverse within
# UNIF_TOL in the flow's normalized coordinates (a trained flow's spline
# inverse in float32: up to 2.3e-5 on case1's flow priors, PERF.md)
CLIQUE_PATH_ARGS = dict(posterior_sample_num=200, local_sample_num=300,
                        flow_iterations=150, num_knots=6, learning_rate=0.03,
                        elimination_method="natural", seed=7,
                        local_sampling_method="nested", mode_repair=False)
CLIQUE_PATH_GATE_M = 0.3
NESTED_CASE1_STEPS = 3
JAX_NESTED_CASE1_PER_STEP = (0.003115918619895512, 0.01339189816177117,
                             0.015118439277995634, 0.03693024935573878,
                             0.03652499273192855, 0.04692143332966488)
UNIF_TOL = 1e-4
# the flow options on case1 at the bench configuration (phase 23): the
# command line with a wider conditioner and a held-out tenth (the
# validation stop) for seeds 1-3, and ``ParallelNFiSAM`` with each
# bucketing option, seed 1 (``dim_bucket_floor=128`` puts every clique in
# the 128 bucket, h=64); gate: the mean joint MMD over steps 0-5 (the
# median over seeds for the command line) <= max(MMD_GATE_FACTOR x the
# reference run1's, OPTIONS_GATE_FACTOR x the JAX package's worst over
# the same seeds and options on the CPU: ``JAX_PLATFORMS=cpu python
# tests/test_torch_flow_options.py``)
OPTIONS_ARGV = ["--hidden", "16", "--training-set-frac", "0.9"]
OPTIONS_SEEDS = (1, 2, 3)
OPTION_SOLVES = {"pad_dim_multiple=4": dict(pad_dim_multiple=4),
                 "dim_bucket_floor=128": dict(dim_bucket_floor=128)}
OPTIONS_GATE_FACTOR = 1.25
JAX_OPTIONS_MMD_WORST = {
    "--hidden 16 --training-set-frac 0.9": 0.029407787030947975,
    "pad_dim_multiple=4": 0.02606030271347153,
    "dim_bucket_floor=128": 0.031920495555511}
# R^2 odometry (phase 24): both MAP solvers and ``baseline`` on the
# eight-node chain and the closed-form graph of the JAX package's
# tests/test_map_solver.py, every estimate within R2_MAP_TOL_M of the
# exact mean; then examples/toy_examples/r2_range_incremental.py's 4 steps
# (the port's examples.toy_examples.r2_range_incremental) by ``NFiSAM``
# with mode repair on (its configuration, R2_RANGE_ARGS: 500 draws, 1000
# training samples, <= 800 iterations, K=8, lr 0.03, pose_first), seeds
# 0-2; gate: L1's posterior mean range to X0, X2, X3 within R2_RANGE_GATE_M
# of the measured 5.0, 4.0, 5.0 m.  The JAX package's repair logs on the
# CPU over the same seeds (``JAX_PLATFORMS=cpu python
# tests/test_torch_r2_odometry.py``) are printed beside the port's, not
# gated: the JAX package reads an asynchronous snapshot
R2_MAP_TOL_M = 1e-3
R2_RANGE_SEEDS = (0, 1, 2)
R2_RANGE_MEASURED = {"X0": 5.0, "X2": 4.0, "X3": 5.0}
R2_RANGE_GATE_M = 0.5
JAX_R2_RANGE_REPAIR_LOGS = ([], [], [])
# phase 32: the repo's examples through the port's modules
# (nfisam_tpu_torch.examples), each at the JAX example's configuration, in
# one child.  The constants are the JAX examples' own code on the CPU over
# seeds 0-2 (keys [s, 7] for the sampler), printed by ``JAX_PLATFORMS=cpu
# python tests/test_torch_examples.py eight_pose|five_node|ns_reference|
# generate_and_run``:
# - eight_pose_circle: every pose's posterior-mean translation and wrapped
#   heading within EXAMPLE_GATE_FACTOR x the JAX worst distance from
#   ``GaussNewtonMAP`` of the graph (m, rad); every std finite and > 0;
# - five_node_range_incremental: at each step the poses' means within
#   EXAMPLE_GATE_FACTOR x the JAX worst distance from that step's MAP (m);
#   at step 3 L1's share of samples on each side of the x-axis inside the
#   JAX band of those shares (its two modes are mirror images, so the band
#   holds both sides' shares) widened by FIVE_NODE_BAND_MARGIN;
# - run_nfisam: its mean joint MMD over steps 0-5 against data/case1_ref
#   through the example's compute_mmd <= MMD_GATE_FACTOR x the reference
#   run1's through the same (bench.py's case1 gate);
# - generate_reference_solution: each step's joint MMD against
#   data/case1_ref's posterior of that step <= EXAMPLE_GATE_FACTOR x the
#   JAX example's worst; cut for the schedule to its first
#   NS_REFERENCE_STEPS of 6 steps (beside the main path its 6 steps took
#   260.3 s and the script 1011.7 s of phases; alone steps 0-3 take 26.5
#   of the 6 steps' 65.8 s; PERF.md §4-§5, where the 6 steps run through
#   the tool);
# - generate_and_run (the graph and the solver at GENERATE_RUN_SEED): the
#   factor_graph.fg's sha256 the JAX example's, the translation RMSE <=
#   LAWNMOWER_GATE_FACTOR x the JAX worst over solver seeds 0-2.
EXAMPLE_GATE_FACTOR = 2.0
JAX_EIGHT_POSE_WORST = (0.6463688588997117, 0.06727072449440807)
JAX_FIVE_NODE_WORST = (0.011621664200335738, 0.023484043364788973,
                       0.06465731790435666, 0.8497882687501032)
JAX_FIVE_NODE_L1_SIDES = (0.194, 0.806)
FIVE_NODE_BAND_MARGIN = 0.1
NS_REFERENCE_STEPS = 4
JAX_NS_REFERENCE_MMD = (0.002333892411136842, 0.023686277821234978,
                        0.024401832953917926, 0.04061446874501069,
                        0.03391216375870396, 0.051074103909216045)
GENERATE_RUN_SEED = 1
JAX_GENERATE_FG_SHA256 = ("b9218f5efe0b20623af2225de511364a9ef46e284d8fdbb3"
                          "610038ed4060dbae")
JAX_GENERATE_RUN_WORST = 9.320458826402447


def lawnmower_argv(seed: int, out: str, ckpt: str = None) -> list:
    """``solve`` of lawnmower_4x4 at scripts/manhattan_run.py:51-54's
    configuration, for either package's command line."""
    argv = ["solve", "--fg", LAWNMOWER_FG, "--out", out,
            "--incremental-step", "1", "--knots", "9", "--iters", "2000",
            "--train-samples", "2000", "--posterior-samples", "1000",
            "--lr", "0.02", "--hidden", "8", "--elimination", "pose_first",
            "--parallel", "--seed", str(seed)]
    return argv + (["--checkpoint-dir", ckpt] if ckpt else [])


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def log_elapsed(t_start: float) -> None:
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")


# --------------------------------------------------------------------------
# the solves and their gates (device-agnostic, so the tests can drive them)
# --------------------------------------------------------------------------
def solve_case1(seed: int, device, parallel: bool = False, **overrides):
    """One incremental case1 solve, by ``NFiSAM`` or, with ``parallel``,
    by ``ParallelNFiSAM`` (the JAX package's bench.py solver).  Returns
    (total_s, per-step timings, per-step host samples, solver)."""
    from nfisam_tpu_torch.io import (graph_file_parser,
                                     group_nodes_factors_incrementally)
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import NFiSAM, NFiSAMArgs

    nodes, _, factors = graph_file_parser(CASE1_FG)
    batches = group_nodes_factors_incrementally(nodes, factors,
                                                incremental_step=1)
    args = NFiSAMArgs(**{**BENCH_ARGS, **overrides, "seed": seed})
    solver = (ParallelNFiSAM if parallel else NFiSAM)(args, device=device)
    steps, per_step = run_incremental(solver, batches, device)
    return float(sum(s["s"] for s in steps)), steps, per_step, solver


def robots_graph(core, factors, R: int = ROBOTS, T: int = ROBOT_STEPS):
    """R disjoint robot-and-landmark subproblems (the JAX package's
    multi-chip dry run, ``__graft_entry__.py``): robot r drives T poses
    5 m apart from (0, 10r), ranges its landmark at (25, 10r) from its
    first and last pose (sigma 0.4 m), and the landmark has a tight prior
    (covariance 0.25 I).  ``core`` and ``factors`` are the package's
    modules of those names.  Returns (variables, factors)."""
    cov3 = np.diag([0.01, 0.01, 0.001])
    vars_, fs = [], []
    for r in range(R):
        rid = chr(ord("A") + r)
        xs = [core.SE2Variable(f"{rid}{t}") for t in range(T)]
        lm = core.R2Variable(f"L{r + 1}", core.VariableType.Landmark)
        vars_ += xs
        start = np.array([0.0, 10.0 * r, 0.0])
        lm_true = np.array([25.0, 10.0 * r])
        fs.append(factors.UnarySE2ApproximateGaussianPriorFactor(
            xs[0], start, cov3))
        for a, b in zip(xs, xs[1:]):
            fs.append(factors.SE2RelativeGaussianLikelihoodFactor(
                a, b, np.array([5.0, 0.0, 0.0]), cov3))
        for t in (0, T - 1):
            pos = start[:2] + np.array([5.0 * t, 0.0])
            fs.append(factors.SE2R2RangeGaussianLikelihoodFactor(
                xs[t], lm, float(np.linalg.norm(lm_true - pos)), 0.4))
        fs.append(factors.UnaryR2GaussianPriorFactor(
            lm, lm_true, covariance=np.eye(2) * 0.25))
        vars_.append(lm)
    return vars_, fs


def solve_robots(device, parallel: bool, R: int = ROBOTS,
                 T: int = ROBOT_STEPS, **overrides):
    """The robots graph by ``ParallelNFiSAM`` or by ``NFiSAM``.  Returns
    (per-step timings, last step's host samples, solver)."""
    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors
    from nfisam_tpu_torch.io import group_nodes_factors_incrementally
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import NFiSAM, NFiSAMArgs

    vars_, fs = robots_graph(core, factors, R, T)
    batches = group_nodes_factors_incrementally(vars_, fs,
                                                incremental_step=R * T + 1)
    args = NFiSAMArgs(**{**ROBOT_ARGS, **overrides})
    solver = (ParallelNFiSAM if parallel else NFiSAM)(args, device=device)
    timings, per_step = run_incremental(solver, batches, device)
    return timings, per_step[-1], solver


def range_moments(samples, R: int = ROBOTS, T: int = ROBOT_STEPS):
    """Per robot, the mean and std (m) of the posterior range from its
    last pose to its landmark: (R, 2)."""
    out = []
    for r in range(R):
        d = np.linalg.norm(samples[f"{chr(ord('A') + r)}{T - 1}"][:, :2] -
                           samples[f"L{r + 1}"][:, :2], axis=1)
        out.append((d.mean(), d.std()))
    return np.array(out)


def repair_graph(core, factors):
    """The JAX package's mode-repair graph (``tests/test_mode_repair.py``)
    in the package whose ``core`` and ``factors`` modules are given: true
    L1 = (4, 0) under a prior biased to (-4, 0), so step 1 (X0 ranging L1
    at 4 m) commits to the mirror mode; step 2 drives to (3, 0) and ranges
    L1 at 1 m, ~19 sigma off that mode.  Returns the two (variables,
    factors) steps."""
    cov3 = np.diag([0.01, 0.01, 0.001])
    x0, x1 = core.SE2Variable("X0"), core.SE2Variable("X1")
    l1 = core.R2Variable("L1", core.VariableType.Landmark)
    step1 = (
        [x0, l1],
        [factors.UnarySE2ApproximateGaussianPriorFactor(x0, np.zeros(3),
                                                        cov3),
         factors.UnaryR2GaussianPriorFactor(l1, np.array([-4.0, 0.0]),
                                            covariance=np.eye(2) * 4.0),
         factors.SE2R2RangeGaussianLikelihoodFactor(x0, l1, 4.0, 0.3)])
    step2 = (
        [x1],
        [factors.SE2RelativeGaussianLikelihoodFactor(
            x0, x1, np.array([3.0, 0.0, 0.0]), cov3),
         factors.SE2R2RangeGaussianLikelihoodFactor(x1, l1, 1.0, 0.3)])
    return [step1, step2]


def solve_repair(device, **overrides):
    """The mode-repair graph by ``ParallelNFiSAM`` with mode repair on.
    Returns (per-step timings, last step's host samples, solver)."""
    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import NFiSAMArgs

    solver = ParallelNFiSAM(NFiSAMArgs(**{**REPAIR_ARGS, **overrides}),
                            device=device)
    timings, per_step = run_incremental(
        solver, repair_graph(core, factors), device)
    return timings, per_step[-1], solver


def separator_repair_graph(core, factors, x0_ranges: bool = True):
    """The mode-repair graph's mirror trap where the landmark also sits in
    separators: X0, X1, X2 walk up the y axis (1 m apart) and range L1
    (true (4, 0), prior biased to (-4, 0)); under pose_first elimination
    the root holds X1, X2, L1.  Step 2 turns to X3 = (3, 2) and ranges L1
    at its true 2.236 m, about 17 sigma off the mirror mode.  With
    ``x0_ranges`` X0's clique holds L1 only in its separator, so only deep
    pruning reaches it; without, X0 does not range L1 and the old root
    re-forms as a clique with L1 in its separator, so only ``no_recycle``
    keeps its model out.  Returns the two (variables, factors) steps."""
    cov3 = np.diag([0.01, 0.01, 0.001])
    xs = [core.SE2Variable(f"X{i}") for i in range(4)]
    l1 = core.R2Variable("L1", core.VariableType.Landmark)
    rng = [factors.SE2R2RangeGaussianLikelihoodFactor(
        x, l1, float(np.hypot(4.0 - px, py)), 0.3)
        for x, (px, py) in zip(xs, SEPARATOR_TRUTH.values())]
    if not x0_ranges:
        rng[0] = None
    odom = [factors.SE2RelativeGaussianLikelihoodFactor(
        xs[i], xs[i + 1], np.array(d), cov3)
        for i, d in enumerate([(1.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                               (0.0, -3.0, 0.0)])]
    step1 = (
        xs[:3] + [l1],
        [factors.UnarySE2ApproximateGaussianPriorFactor(
            xs[0], np.array([0.0, 0.0, np.pi / 2]), cov3),
         factors.UnaryR2GaussianPriorFactor(l1, np.array([-4.0, 0.0]),
                                            covariance=np.eye(2) * 4.0)]
        + odom[:2] + [f for f in rng[:3] if f is not None])
    step2 = ([xs[3]], [odom[2], rng[3]])
    return [step1, step2]


def solve_separator_repair(device, x0_ranges: bool = True, **overrides):
    """The separator trap by ``ParallelNFiSAM`` at the mode-repair graph's
    settings.  Returns (per-step timings, last step's host samples,
    solver)."""
    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import NFiSAMArgs

    solver = ParallelNFiSAM(NFiSAMArgs(**{**REPAIR_ARGS, **overrides}),
                            device=device)
    timings, per_step = run_incremental(
        solver, separator_repair_graph(core, factors, x0_ranges), device)
    return timings, per_step[-1], solver


def separator_repair_cliques(solver) -> tuple:
    """After the last update: (cliques of the physical tree holding L1,
    those holding it only in their separator, those of either kind that
    the update did not train), each by its variables' names."""
    def name(c):
        return "".join(sorted(str(v.name) for v in c.vars))

    holding = sorted(name(c) for c in solver.physical_bayes_tree.clique_nodes
                     if "L1" in {str(v.name) for v in c.vars})
    sep_only = sorted(
        name(c) for c in solver.physical_bayes_tree.clique_nodes
        if "L1" in {str(v.name) for v in c.separator})
    return holding, sep_only, [c for c in holding
                               if c not in solver._temp_training_loss]


def repair_gates(solver, samples) -> tuple:
    """(repair log, median |X1 - L1| m, share of L1 samples at x > 0)."""
    d = np.linalg.norm(samples["X1"][:, :2] - samples["L1"][:, :2], axis=1)
    return (list(solver.mode_repair_log), float(np.median(d)),
            float(np.mean(samples["L1"][:, 0] > 0)))


def solve_case1_da(seed: int, device, case_dir: str, **overrides):
    """One case1_da solve through the case1_da runner (``run_incrementally``
    and the hypothesis weights read back from its run directory).  Returns
    (per-step timings read back, last step's host samples and the ground
    truth by name, observer -> {candidate: final weight}, the solver, its
    kernel launches)."""
    from nfisam_tpu_torch.factors import BinaryFactorMixture

    run_dir, solver, batches, _, launches = cdr.solve(
        case_dir, device, seed, verbose=False, **overrides)
    _, truth, factors, _ = cdr.load_graph()
    per_step = cdr.read_hypoweights(run_dir, len(batches))
    candidates = {str(f.observer_var.name): [str(v.name)
                                             for v in f.observed_vars]
                  for f in factors if isinstance(f, BinaryFactorMixture)}
    weights = {obs: dict(zip(candidates[obs], ws))
               for obs, ws in per_step[max(per_step)].items()}
    return (cdr.step_rows(run_dir, len(batches)),
            host_samples(solver._samples),
            {str(v.name): np.asarray(t) for v, t in truth.items()},
            weights, solver, launches)


def fused_vs_per_clique(solver):
    """The fused pass and the per-clique walk on the solver's final state,
    each pair drawn from the same key stream (rewound between the two),
    in turns: fused, walk, then walk, fused.  Returns (max |fused - walk|
    / max(1, max |sample|) over both pairs, fused seconds, per-clique
    seconds; each time the mean of two and ending in a synchronize)."""
    from nfisam_tpu_torch.solver import LazySamples

    sync = torch.cuda.synchronize if solver.device.type == "cuda" \
        else (lambda: None)
    passes = {"fused": solver.sample_posterior,
              "walk": solver.sample_posterior_per_clique}
    seconds = {"fused": 0.0, "walk": 0.0}
    worst = 0.0
    for order in (("fused", "walk"), ("walk", "fused")):
        keys = copy.deepcopy(solver._keys)
        out = {}
        for which in order:
            solver._keys = copy.deepcopy(keys)
            sync()
            t0 = time.perf_counter()
            out[which] = passes[which]()
            sync()
            seconds[which] += (time.perf_counter() - t0) / 2
        fused, walk = out["fused"], out["walk"]
        if not isinstance(fused, LazySamples) or set(fused) != set(walk):
            raise SystemExit("the fused posterior pass did not run on "
                             "every variable")
        diff = max(float((fused[v] - walk[v]).abs().max()) for v in walk)
        scale = max(1.0, max(float(walk[v].abs().max()) for v in walk))
        worst = max(worst, diff / scale)
    return worst, seconds["fused"], seconds["walk"]


def translation_errors(samples, truth):
    """(max, RMSE) of the posterior-mean translation error (m) over the
    variables with a ground truth; values are (n, dim) samples by name."""
    rmse, worst = point_errors({name: np.asarray(x)[:, :2].mean(0)
                                for name, x in samples.items()}, truth)
    return worst, rmse


def laplace_from_truth(m, truth) -> dict:
    """``GaussNewtonMAP`` of either package (``m``) from the ground-truth
    column (``scripts/manhattan_plaza_run.py``'s floor, started where the
    GTSAM harness starts).  Returns {"rmse", "max", "iters", "nll", "s"}."""
    x0 = np.concatenate([np.asarray(truth[v], np.float32)[:v.dim]
                         for v in m.joint.vars])
    seconds = []
    m.solve(x0=x0, timer=seconds)
    rmse, worst = point_errors(m.results(), truth)
    return dict(rmse=rmse, max=worst, iters=m.iterations,
                nll=m.final_nll, s=seconds[0])


def map_case(label: str, parse, new_solver) -> dict:
    """One of ``MAP_CASES`` through a package's parser
    (``parse(path) -> (nodes, truth, factors)``) and the case's MAP solver:
    ``new_solver()`` for a banked floor, ``new_solver(nodes, factors)`` for
    a Laplace MAP."""
    path, kind = MAP_CASES[label]
    nodes, truth, factors = parse(path)
    if kind == "laplace":
        return laplace_from_truth(new_solver(nodes, factors), truth)
    m = new_solver()
    m.update(nodes, factors)
    return floor_from_truth(m, truth)


def plaza_floor_gate(label: str, worst: float, floor: dict) -> None:
    """``scripts/plaza_family_run.py``'s divergence gate: max error <=
    max(3x the JAX package's floor max error over the prefix, 15 m), with
    the port's own floor (``floor``) printed beside it."""
    bound = max(pfr.FLOOR_FACTOR * JAX_PREFIX_FLOOR_MAX[label],
                PLAZA_GATE_M)
    log(f"{label} gate: max posterior-mean translation error {worst:.3f} m"
        f" (<= max({pfr.FLOOR_FACTOR} x the JAX package's floor max "
        f"{JAX_PREFIX_FLOOR_MAX[label]:.4f}, {PLAZA_GATE_M}) = "
        f"{bound:.3f}); the port's truth-initialised MAP floor over the "
        f"prefix: RMSE {floor['rmse']:.4f} m, max {floor['max']:.4f} m, "
        f"{floor['iters']} LM iterations, NLL {floor['nll']:.4f}, "
        f"{floor['s']:.3f} s")
    if pfr.divergence_reasons(worst, JAX_PREFIX_FLOOR_MAX[label], None):
        raise SystemExit(f"{label} divergence gate failed")


def _ref_block(mat, order, name2dim, names):
    pos, cur = {}, 0
    for n in order:
        pos[n] = cur
        cur += name2dim[n]
    return np.hstack([mat[:, pos[n]:pos[n] + 2] for n in names])


def accuracy_gate(per_step, name2dim, steps=MMD_STEPS):
    """Joint translation MMD of one solve and of the reference's run1
    against the committed posteriors (dynesty at steps 0-3, nested
    sampling at 4-5), 500-sample subsets from ``default_rng(0)``, averaged
    over ``steps``.  Returns (ours, reference run1, per-step ours)."""
    from nfisam_tpu_torch.eval import mmd

    rng = np.random.default_rng(0)

    def pick(A):
        return A[rng.choice(len(A), min(MMD_SUBSET, len(A)), replace=False)]

    ours, refs = [], []
    for step in steps:
        src = "dyn" if step <= 3 else "ns"
        dyn = np.loadtxt(os.path.join(REF_DIR, f"{src}_step{step}.sample"))
        with open(os.path.join(REF_DIR, f"{src}_step{step}_ordering")) as f:
            dyn_order = f.read().split()
        run1 = np.loadtxt(os.path.join(REF_DIR, f"run1_step{step}"))
        with open(os.path.join(REF_DIR, f"run1_step{step}_ordering")) as f:
            run1_order = f.read().split()
        dyn_block = _ref_block(dyn, dyn_order, name2dim, dyn_order)
        run1_block = _ref_block(run1, run1_order, name2dim, dyn_order)
        our_block = np.hstack([per_step[step][n][:, :2] for n in dyn_order])
        ours.append(mmd(pick(our_block), pick(dyn_block)))
        refs.append(mmd(pick(run1_block), pick(dyn_block)))
    return float(np.mean(ours)), float(np.mean(refs)), ours


def median_gate(per_step_by_seed, name2dim):
    """(median-seed MMD, reference run1 MMD, per-seed results)."""
    results = [accuracy_gate(ps, name2dim) for ps in per_step_by_seed]
    med = int(np.argsort([r[0] for r in results])[len(results) // 2])
    return results[med][0], results[med][1], results


def roundtrip_residuals(solver, inverse_fn, max_cliques: int = 3):
    """z-space residual |forward(inverse(z)) - z| of ``inverse_fn`` and of
    the plain inverse on up to ``max_cliques`` trained single-flow clique
    models (first 2 columns pinned).  Returns (fn's, plain's, count)."""
    from nfisam_tpu_torch.flows import stack_forward, stack_inverse_masked_plain

    worst_fn = worst_plain = 0.0
    checked = 0
    for adapter in solver._clique_density_model.values():
        model = adapter.model
        cfg = model.cfg
        if cfg.num_flows != 1:
            continue        # the identity below holds per flow
        rng = np.random.default_rng(0)
        z = torch.as_tensor(rng.normal(size=(256, cfg.dim)).astype(
            np.float32), device=model.device)
        prefix = torch.zeros_like(z)
        invert = torch.as_tensor(np.arange(cfg.dim) >= 2, device=z.device)
        with torch.no_grad():
            x_fn = inverse_fn(model.flow_params, z, prefix, invert, cfg)
            x_pl = stack_inverse_masked_plain(model.flow_params, z, prefix,
                                              invert, cfg)
            z_fn, _ = stack_forward(model.flow_params, x_fn, cfg)
            z_pl, _ = stack_forward(model.flow_params, x_pl, cfg)
        keep = invert.cpu().numpy()
        worst_fn = max(worst_fn, float(
            (z_fn - z).abs().cpu().numpy()[:, keep].max()))
        worst_plain = max(worst_plain, float(
            (z_pl - z).abs().cpu().numpy()[:, keep].max()))
        checked += 1
        if checked >= max_cliques:
            break
    return worst_fn, worst_plain, checked


# --------------------------------------------------------------------------
# the kernel against its plain version
# --------------------------------------------------------------------------
def random_flow(rng, d, h, K, num_flows, device):
    """Deterministic flow parameters (biases included) from a numpy RNG."""
    p = 3 * K
    flows = []
    for _ in range(num_flows):
        flows.append({
            "W1": rng.uniform(-1, 1, (d, h, d)) /
            np.sqrt(np.maximum(np.arange(d), 1))[:, None, None],
            "b1": rng.uniform(-0.3, 0.3, (d, h)),
            "W2": rng.uniform(-1, 1, (d, h, h)) / np.sqrt(h),
            "b2": rng.uniform(-0.3, 0.3, (d, h)),
            "W3": rng.uniform(-1, 1, (d, p, h)) / np.sqrt(h),
            "b3": rng.uniform(-0.5, 0.5, (d, p))})
    from nfisam_tpu_torch.flows import flow_params_from_numpy
    return flow_params_from_numpy(flows, device)


# (name, n, dim, hidden, knots, flows, sep_dim, circular dims[, z scale])
KERNEL_CASES = [
    ("main n=1000 sep0", 1000, 16, 8, 9, 1, 0, ()),
    ("main n=1000 sep1", 1000, 16, 8, 9, 1, 1, ()),
    ("main n=1000 sep8", 1000, 16, 8, 9, 1, 8, ()),
    ("main n=2000 sep0", 2000, 16, 8, 9, 1, 0, ()),
    ("main n=2000 sep1", 2000, 16, 8, 9, 1, 1, ()),
    ("main n=2000 sep8", 2000, 16, 8, 9, 1, 8, ()),
    ("d32 h16", 1000, 32, 16, 9, 1, 4, ()),
    ("circular", 1000, 16, 8, 9, 1, 2, (2, 5, 9)),
    ("2-flow stack", 1000, 16, 8, 9, 2, 3, ()),
    ("odd n K7", 999, 16, 8, 7, 1, 5, ()),
    ("d64 h32 K12 odd n", 777, 64, 32, 12, 1, 6, (7,)),
    ("n=1", 1, 16, 8, 9, 1, 2, ()),
    ("n=17", 17, 16, 8, 9, 1, 2, ()),
    ("all pinned sep16", 1000, 16, 8, 9, 1, 16, ()),
    ("sep15", 1000, 16, 8, 9, 1, 15, ()),
    ("circular first inverted", 1000, 16, 8, 9, 1, 3, (3, 11)),
    ("z beyond the tail bound", 1000, 16, 8, 9, 1, 2, (), 6.0),
    ("d32 h16 K12", 1000, 32, 16, 12, 1, 4, ()),
    ("d64 h32 K7", 500, 64, 32, 7, 1, 3, ()),
    ("d64 h32 K9", 500, 64, 32, 9, 1, 0, (10,)),
    ("K5 n=1000 sep2", 1000, 16, 8, 5, 1, 2, ()),
    ("K6 n=1000 sep2", 1000, 16, 8, 6, 1, 2, ()),
    ("K8 n=1000 sep2", 1000, 16, 8, 8, 1, 2, ()),
    ("K10 n=1000 sep2", 1000, 16, 8, 10, 1, 2, ()),
    ("d32 h16 K8", 1000, 32, 16, 8, 1, 4, ()),
    ("d64 h32 K8", 1000, 64, 32, 8, 1, 3, ()),
    # nested clique sampling: a flow prior's unif_to_sample on a batch of
    # replaced points (8-50 rows) with its observation columns pinned
    ("ns n=8 sep2", 8, 16, 8, 9, 1, 2, ()),
    ("ns n=25 sep4", 25, 16, 8, 9, 1, 4, ()),
    ("ns n=50 sep6", 50, 16, 8, 9, 1, 6, ()),
    ("ns n=25 sep3 K6", 25, 16, 8, 6, 1, 3, ()),
    # the 128 bucket (specialised, a 2-slot ring) with circular dims and
    # pinned columns
    ("d128 h64 K7", 1000, 128, 64, 7, 1, 6, (7,)),
    ("d128 h64 K9", 1000, 128, 64, 9, 1, 6, (7, 70)),
    ("d128 h64 K12 odd n", 777, 128, 64, 12, 1, 6, (100,)),
    # the generic kernel: the JAX tests' shapes (test_checkpoint.py:18,
    # test_mesh.py:24, test_prewarm.py:25, test_flows.py:95,151), --hidden
    # 16, scale_hidden_with_dim=False, pad_dim_multiple=4, K=20
    ("generic d5 h4 K6", 1000, 5, 4, 6, 1, 2, ()),
    ("generic d4 h4 K5", 1000, 4, 4, 5, 1, 1, ()),
    ("generic d8 h4 K5", 1000, 8, 4, 5, 1, 3, ()),
    ("generic d8 h8 K9", 1000, 8, 8, 9, 1, 3, ()),
    ("generic d2 h8 K8 2 flows", 1000, 2, 8, 8, 2, 0, ()),
    ("generic d5 h8 K8 2 flows", 1000, 5, 8, 8, 2, 1, (3,)),
    ("generic d16 h16 K9", 1000, 16, 16, 9, 1, 2, ()),
    ("generic d16 h16 K9 n=2000", 2000, 16, 16, 9, 1, 2, ()),
    ("generic d16 h4 K9", 1000, 16, 4, 9, 1, 2, ()),
    ("generic d12 h8 K9", 1000, 12, 8, 9, 1, 3, (4,)),
    ("generic d16 h8 K20", 1000, 16, 8, 20, 1, 2, (6,)),
    ("generic d16 h16 K9 n=25", 25, 16, 16, 9, 1, 4, ()),
    # the corners of its launch plan (``make_plan``): the 256 bucket
    # (weights through L2, 4 lane chunks a layer) with a circular dim past
    # 128, h and K above the 32 lanes (two chunks each), d=1, an odd h*d
    # (slices off the 16-byte grain), n not a multiple of 8 samples, a
    # 2-flow stack, and a ring of weight slots
    ("generic d256 h128 K9 circ", 1000, 256, 128, 9, 1, 6, (200,)),
    ("generic d8 h40 K40", 1000, 8, 40, 40, 1, 2, (5,)),
    ("generic d1 h3 K2", 1000, 1, 3, 2, 1, 0, ()),
    ("generic d7 h5 K3", 1000, 7, 5, 3, 1, 2, (4,)),
    ("generic d16 h16 K9 n=999", 999, 16, 16, 9, 1, 3, ()),
    ("generic d16 h16 K9 2 flows", 1000, 16, 16, 9, 2, 5, (9,)),
    ("generic d64 h48 K9 ring", 500, 64, 48, 9, 1, 3, (10,)),
    ("generic d12 h8 K8", 1000, 12, 8, 8, 1, 3, (4,)),
    ("generic d24 h16 K9", 1000, 24, 16, 9, 1, 4, (20,)),
    # the utilization profile's fused chain at its largest batch
    # (``profile_utilization.PASS_N``): every dim inverted
    ("chain n=262144 sep0", 262144, 16, 8, 9, 1, 0, ()),
]
# the shapes the timings are taken at: a case1 root clique's posterior
# draw (n=1000) and a separator-factor draw in simulation (n=2000), d=16,
# h=8, K=9, 1 flow, 2 observation columns pinned; the first is the
# kernel line's; then K=6 (the mode-repair graph's), the d=32 and d=64 dim
# buckets at n=1000, every column pinned (no dim step: the launch, the
# loads and the store alone), a nested-sampling batch (n=25), where the
# launch is the cost, the d=128 bucket, the generic kernel at
# ``--hidden 16`` (its line's), the generic kernel at the first case's
# shape and inputs (``FORCED_GENERIC``: what run-time shapes cost beside
# the specialised kernel), at ``pad_dim_multiple=4``'s (12, 8, 9) n=2000
# draw, and at the 256 bucket; then the utilization profile's fused chain
# at its largest batch (n=262144, every dim inverted)
TIMED_CASES = [("timed n=1000 sep2", 1000, 16, 8, 9, 1, 2, ()),
               ("timed K6 n=1000 sep2", 1000, 16, 8, 6, 1, 2, ()),
               ("timed n=2000 sep2", 2000, 16, 8, 9, 1, 2, ()),
               ("timed d32 n=1000 sep2", 1000, 32, 16, 9, 1, 2, ()),
               ("timed d64 n=1000 sep2", 1000, 64, 32, 9, 1, 2, ()),
               ("timed n=1000 all pinned", 1000, 16, 8, 9, 1, 16, ()),
               ("timed ns n=25 sep4", 25, 16, 8, 9, 1, 4, ()),
               ("timed d128 n=1000 sep2", 1000, 128, 64, 9, 1, 2, ()),
               ("timed generic d16 h16 n=1000 sep2", 1000, 16, 16, 9, 1, 2,
                ()),
               ("timed generic d16 h8 n=1000 sep2", 1000, 16, 8, 9, 1, 2, ()),
               ("timed generic d12 h8 n=2000 sep2", 2000, 12, 8, 9, 1, 2, ()),
               ("timed generic d256 h128 n=1000 sep2", 1000, 256, 128, 9, 1,
                2, ()),
               ("timed chain n=262144 sep0", 262144, 16, 8, 9, 1, 0, ())]
GENERIC_TIMED = "timed generic d16 h16 n=1000 sep2"
# timed cases launched through the generic kernel at a specialised shape
FORCED_GENERIC = {"timed generic d16 h8 n=1000 sep2"}
# the generic kernel's instantiations (lanes a sample; the weights staged
# with d, h, K within the lanes ("one"), staged, or read through L2) and
# a shape that launches each, for the build report beside every generic
# shape of the cases
GENERIC_INSTANCES = {(8, "one"): (7, 5, 3), (16, "one"): (16, 16, 9),
                     (32, "one"): (16, 8, 20), (8, "staged"): (12, 8, 8),
                     (16, "staged"): (24, 16, 9), (32, "staged"): (8, 40, 40),
                     (8, "l2"): (4000, 8, 8), (16, "l2"): (3000, 16, 9),
                     (32, "l2"): (256, 128, 9)}
# the gradient of the masked inverse (``MaskedStackInverse``: the kernel's
# forward, the implicit-function VJP) against autograd through the plain
# inverse: the main path's shape, a nested-sampling batch and a 2-flow
# stack (the backward walks the flows in reverse); |diff| <= GRAD_RTOL
# (|plain| + its largest entry)
GRAD_CASES = [("grad n=1000 sep2", 1000, 16, 8, 9, 1, 2, ()),
              ("grad ns n=25 sep4", 25, 16, 8, 9, 1, 4, ()),
              ("grad 2 flows n=1000 sep3", 1000, 16, 8, 9, 2, 3, ())]
GRAD_RTOL = 1e-4
# cycles of the sleep kernel that holds the stream while a call is queued
# (~1 ms), so that the events time the device's work alone
HOLD_CYCLES = 2_000_000


def make_case(case, device, seed):
    from nfisam_tpu_torch.flows import NSFConfig

    _, n, d, h, K, flows, sep, circ, *z_scale = case
    rng = np.random.default_rng(seed)
    circular = tuple(i in circ for i in range(d)) if circ else ()
    cfg = NSFConfig(dim=d, num_knots=K, hidden_dim=h, num_flows=flows,
                    circular=circular)
    params = random_flow(rng, d, h, K, flows, device)
    z = torch.as_tensor((rng.normal(size=(n, d)) *
                         (z_scale[0] if z_scale else 1.5)).astype(np.float32),
                        device=device)
    mask = np.arange(d) >= sep
    xp = rng.normal(size=(n, d)).astype(np.float32) * 0.8
    xp[:, mask] = 0.0
    return (cfg, params, z, torch.as_tensor(xp, device=device),
            torch.as_tensor(mask, device=device))


def ar_inverse_work(n: int, cfg, invert) -> tuple:
    """(bytes, FLOPs) the masked inverse of one flow must move and do at
    this shape: z, x_prefix and the weights read once, the output written
    once; for each inverted dim i and sample, the three layers (2 FLOPs a
    multiply-add, W1 over the i visible inputs), the tanh's, and the
    spline (two K-bin softmaxes, K+1 softplus derivatives, the knots, the
    bin search and select, the quadratic root), counted one FLOP an
    operation, transcendentals included."""
    d, h, K = cfg.dim, cfg.hidden_dim, cfg.num_knots
    p = 3 * K
    weights = d * (h * d + h + h * h + h + p * h + p)
    nbytes = 4 * (3 * n * d + weights) + d
    spline = 2 * (5 * K) + 4 * (K + 1) + 2 * 3 * (K - 1) + 2 * K + 8 * K + 25
    per_dim = [2 * h * i + h + 2 * h * h + 2 * h + 2 * p * h + p + spline
               for i in range(d) if invert[i]]
    return nbytes, float(n * sum(per_dim))


def time_cuda(fn, warmup: int = 5, repeats: int = 30,
              hold: bool = False) -> float:
    """Median milliseconds of ``fn()`` over ``repeats`` CUDA-event-timed
    calls after ``warmup`` untimed ones.  With ``hold`` a sleep kernel
    keeps the stream busy while the call is queued, so the events time the
    device's work alone; without, they also take in the host's time to
    issue the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_entry(variant: str, worst: float, timed) -> dict:
    """One kernel's entry of the ``{"kernels": [...]}`` line (its launches
    filled in from the main path's run)."""
    from nfisam_tpu_torch.flows.ar_inverse import ARInverseKernel

    ms, plain_ms, bytes_ms, flops_ms = timed
    return {"name": {"specialized": "ar_inverse_masked",
                     "generic": "ar_inverse_generic"}[variant],
            "route": "cuda",
            "source": os.path.relpath(ARInverseKernel.sources[variant], HERE),
            "replaces": "nfisam_tpu/flows/ar_inverse_pallas.py:168",
            "launches": None,
            "max_abs_err": worst,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None}


def compare_case(case, device, seed: int) -> tuple:
    """The kernel that ``case`` goes to against the plain version on its
    inputs, within atol and rtol ``KERNEL_TOL``; fails the run if they
    disagree.  Returns (variant, max |kernel - plain|)."""
    from nfisam_tpu_torch.flows import (stack_inverse_masked_cuda,
                                        stack_inverse_masked_plain)
    from nfisam_tpu_torch.flows.ar_inverse import kernel_variant

    cfg, params, z, xp, mask = make_case(case, device, seed=seed)
    variant = kernel_variant(cfg.dim, cfg.hidden_dim, cfg.num_knots)
    with torch.no_grad():
        got = stack_inverse_masked_cuda(params, z, xp, mask, cfg)
        torch.cuda.synchronize()
        ref = stack_inverse_masked_plain(params, z, xp, mask, cfg)
    err = (got - ref).abs()
    bad = err > KERNEL_TOL + KERNEL_TOL * ref.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    log(f"ar_inverse {case[0]} ({variant}): max |kernel - plain| "
        f"{max_err:.3e}, finite {bool(torch.isfinite(got).all())}")
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise SystemExit(f"ar_inverse kernel disagrees with its plain "
                         f"version on {case[0]}: max err {max_err:.3e}")
    return variant, max_err


def check_generic_vs_specialized(device) -> None:
    """The generic kernel at the specialised kernel's main shape (16, 8,
    9), n=1000, on the same inputs as the specialised kernel: each within
    atol and rtol ``KERNEL_TOL`` of the plain version and of the other;
    fails the run if not."""
    from nfisam_tpu_torch.flows import (stack_inverse_masked_cuda,
                                        stack_inverse_masked_plain)

    case = ("generic vs specialised d16 h8 K9", 1000, 16, 8, 9, 1, 2, (6,))
    cfg, params, z, xp, mask = make_case(case, device, seed=11)
    with torch.no_grad():
        got = {v: stack_inverse_masked_cuda(params, z, xp, mask, cfg, v)
               for v in ("specialized", "generic")}
        torch.cuda.synchronize()
        ref = stack_inverse_masked_plain(params, z, xp, mask, cfg)
    spec, gen = got["specialized"], got["generic"]
    errs = {"generic - specialized": (gen - spec, spec),
            "generic - plain": (gen - ref, ref),
            "specialized - plain": (spec - ref, ref)}
    worst = {k: float(e.abs().max()) for k, (e, _) in errs.items()}
    log(f"ar_inverse {case[0]}: max |{'|, |'.join(worst)}| "
        f"{', '.join(f'{v:.3e}' for v in worst.values())}")
    for name, (e, base) in errs.items():
        if bool((e.abs() > KERNEL_TOL + KERNEL_TOL * base.abs()).any()) or \
                not bool(torch.isfinite(gen).all()):
            raise SystemExit(f"ar_inverse {case[0]}: {name} beyond atol + "
                             f"rtol {KERNEL_TOL} ({worst[name]:.3e})")


# the (variant, n, d, h, K) the children launched at, joined to this
# process's ``launched_shapes`` by ``check_launched_shapes``
CHILD_SHAPES: set = set()


def check_launched_shapes(device) -> None:
    """Every (d, h, K) a path of this run launched a kernel at (the
    wrapper's ``launched_shapes``, cleared after the kernel checks, and
    the children's ``CHILD_SHAPES``), held
    against the plain version at the fewest and the most samples it was
    launched with (a third of the dims pinned, the middle one circular),
    where ``KERNEL_CASES`` has no case of that (n, d, h, K)."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    checked = {(n, d, h, K) for _, n, d, h, K, *_ in KERNEL_CASES}
    ns: dict = {}
    for variant, n, d, h, K in ar_inverse_kernel.launched_shapes | \
            CHILD_SHAPES:
        ns.setdefault((variant, d, h, K), set()).add(n)
    cases = []
    for (variant, d, h, K), seen in sorted(ns.items()):
        for n in sorted({min(seen), max(seen)}):
            if (n, d, h, K) not in checked:
                cases.append((f"launched {variant} n={n} d{d} h{h} K{K}", n,
                              d, h, K, 1, d // 3,
                              (d // 2,) if d > 1 else ()))
    for i, case in enumerate(cases):
        compare_case(case, device, seed=500 + i)
    log(f"ar_inverse: every launched (d, h, K) checked: "
        f"{ {k: sorted(v) for k, v in sorted(ns.items())} } (variant, d, "
        f"h, K): launched n; {len(cases)} shape(s) beyond KERNEL_CASES")


def check_ar_inverse(device) -> list:
    """Both AR-inverse kernels against their plain version on every case
    (each case goes to the kernel ``kernel_variant`` names), then both
    timed at ``TIMED_CASES``.  Launches here are not counted as the main
    path's: the caller resets the counts before each solve.  Returns the
    two kernels' entries: the specialised kernel's error at the main
    path's shapes, the generic kernel's over its cases."""
    from nfisam_tpu_torch.flows import (stack_inverse_masked_cuda,
                                        stack_inverse_masked_plain)
    from nfisam_tpu_torch.flows.ar_inverse import kernel_variant

    worst = dict.fromkeys(("specialized", "generic"), 0.0)
    worst_main = 0.0
    for i, case in enumerate(KERNEL_CASES):
        variant, max_err = compare_case(case, device, seed=100 + i)
        worst[variant] = max(worst[variant], max_err)
        if case[0].startswith("main"):
            worst_main = max(worst_main, max_err)
    log(f"ar_inverse: max |kernel - plain| {worst_main:.3e} at the main "
        f"path's shapes, {worst['specialized']:.3e} over the specialised "
        f"kernel's cases, {worst['generic']:.3e} over the generic "
        f"kernel's, within atol {KERNEL_TOL} + rtol {KERNEL_TOL}")

    check_generic_vs_specialized(device)

    timed = {}
    for case in TIMED_CASES:
        cfg, params, z, xp, mask = make_case(case, device, seed=7)
        variant = ("generic" if case[0] in FORCED_GENERIC else
                   kernel_variant(cfg.dim, cfg.hidden_dim, cfg.num_knots))
        with torch.no_grad():
            def call():
                return stack_inverse_masked_cuda(params, z, xp, mask, cfg,
                                                 variant)
            ms = time_cuda(call)
            device_ms = time_cuda(call, hold=True)
            # the plain version takes 0.2-0.6 s a call at d >= 128, where
            # the kernel checks above have already run it: time it once
            slow = cfg.dim >= 128
            plain_ms = time_cuda(lambda: stack_inverse_masked_plain(
                params, z, xp, mask, cfg), warmup=0 if slow else 2,
                repeats=1 if slow else 10)
        nbytes, flops = ar_inverse_work(z.shape[0], cfg, mask.cpu().numpy())
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        flops_ms = 1e3 * flops / F32_FLOP_PER_S
        log(f"ar_inverse {case[0]} ({variant}): "
            f"kernel {ms:.5f} ms a call, {device_ms:.5f} ms on the device; "
            f"plain {plain_ms:.3f} ms; bound {max(bytes_ms, flops_ms):.6f} "
            f"ms ({nbytes} B -> {bytes_ms:.6f} ms, {flops:.3e} FLOP -> "
            f"{flops_ms:.6f} ms)")
        timed[case[0]] = (ms, plain_ms, bytes_ms, flops_ms)
    return [kernel_entry("specialized", worst_main,
                         timed[TIMED_CASES[0][0]]),
            kernel_entry("generic", worst["generic"],
                         timed[GENERIC_TIMED])]


def check_unif_gradient(device) -> float:
    """``MaskedStackInverse`` with the kernel's forward against autograd
    through the plain inverse, at ``GRAD_CASES``: the VJP of a fixed
    random cotangent.  Returns the worst |diff| over the largest
    entry."""
    from nfisam_tpu_torch.flows import (stack_inverse_masked_cuda,
                                        stack_inverse_masked_plain)
    from nfisam_tpu_torch.flows.ar_inverse import \
        stack_inverse_masked_differentiable

    worst = 0.0
    for i, case in enumerate(GRAD_CASES):
        cfg, params, z, xp, mask = make_case(case, device, seed=300 + i)
        w = torch.as_tensor(np.random.default_rng(i).normal(
            size=tuple(z.shape)).astype(np.float32), device=device)
        grads = []
        for run in (lambda zz: stack_inverse_masked_differentiable(
                        params, zz, xp, mask, cfg, stack_inverse_masked_cuda),
                    lambda zz: stack_inverse_masked_plain(params, zz, xp,
                                                          mask, cfg)):
            zz = z.clone().requires_grad_(True)
            (g,) = torch.autograd.grad((run(zz) * w).sum(), zz)
            grads.append(g)
        got, ref = grads
        diff = (got - ref).abs()
        scale = float(ref.abs().max())
        rel = float(diff.max()) / scale
        log(f"unif gradient {case[0]}: max |kernel VJP - autograd of "
            f"plain| {float(diff.max()):.3e}, {rel:.3e} of the largest "
            f"entry {scale:.3f}")
        if bool((diff > GRAD_RTOL * (ref.abs() + scale)).any()) or \
                not bool(torch.isfinite(got).all()):
            raise SystemExit(f"the masked inverse's gradient disagrees "
                             f"with autograd through the plain version on "
                             f"{case[0]}")
        worst = max(worst, rel)
    return worst


def build_report() -> None:
    """Each AR-inverse instantiation's block shape, registers, local
    memory, dynamic shared memory and weight slots, as the runtime reads
    them from the built cubin (ptxas's figures: spills and a stack frame
    are local memory), failing if any uses local memory: the specialised
    kernel's 28, then the generic kernel's 9 (lanes a sample x weights
    staged with one chunk, staged, or through L2) at every generic shape
    of the cases and timings and at ``GENERIC_INSTANCES``, failing if a
    generic instantiation was not reached."""
    from nfisam_tpu_torch.flows.ar_inverse import (SUPPORTED_DIM_HIDDEN,
                                                   SUPPORTED_KNOTS,
                                                   ar_inverse_kernel,
                                                   kernel_variant)

    def describe(info):
        return (f"{info['threads']} threads ({info['samples']} samples) a "
                f"block, {info['registers']} registers, "
                f"{info['local_bytes']} B local (stack and spills), "
                f"{info['smem_bytes']} B dynamic shared memory, "
                f"{info['slots']} weight slots")

    local = []
    for d, h in SUPPORTED_DIM_HIDDEN:
        for K in SUPPORTED_KNOTS:
            info = ar_inverse_kernel.info(d, h, K)
            log(f"ar_inverse d={d} h={h} K={K}: {describe(info)}")
            if info["local_bytes"]:
                local.append((d, h, K))
    shapes = {(d, h, K) for _, _, d, h, K, *_ in KERNEL_CASES + TIMED_CASES
              if kernel_variant(d, h, K) == "generic"}
    shapes |= set(GENERIC_INSTANCES.values())
    seen = set()
    for d, h, K in sorted(shapes):
        info = ar_inverse_kernel.info(d, h, K)
        # the instantiation the C side's ``pick`` launches for this plan
        one = info["slots"] > 0 and max(d, h, K) <= info["group"]
        seen.add((info["group"], "l2" if info["staging"] == "l2" else
                  "one" if one else "staged"))
        log(f"ar_inverse_generic d={d} h={h} K={K}: {info['group']} lanes "
            f"a sample, weights {info['staging']}"
            f"{', one chunk' if one else ''}; {describe(info)}")
        if info["local_bytes"]:
            local.append(("generic", d, h, K))
    if seen != set(GENERIC_INSTANCES):
        raise SystemExit(f"ar_inverse_generic: instantiations reported "
                         f"{sorted(seen)}, expected "
                         f"{sorted(GENERIC_INSTANCES)}")
    if local:
        raise SystemExit(f"ar_inverse instantiations with local memory "
                         f"(stack or spills): {local}")


def check_generator_seed(device) -> None:
    """The card's generator takes a key's 64-bit word ``hi << 32 | lo``
    whole (``utils.keys.generator_seed``: only the CPU's seed is folded),
    so the card's streams do not depend on the CPU's fold."""
    from nfisam_tpu_torch.utils.keys import torch_generator

    key = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    seed = torch_generator(key, device).initial_seed()
    log(f"generator: key {key.tolist()} seeds the card's generator with "
        f"{seed:#x}")
    if seed != 0x12345678 << 32 | 0x9ABCDEF0:
        raise SystemExit("generator: the card's seed is not the key's "
                         "64-bit word")


def profile_solve(device) -> None:
    """One more seed-1 ``ParallelNFiSAM`` solve under ``torch.profiler``:
    the device's busy share of the solve's wall time and the kernels that
    fill it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _, _, _ = solve_case1(SEEDS[0], device, parallel=True)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_s = sum(dev_us(e) for e in rows) / 1e6
    if busy_s == 0.0:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile (seed {SEEDS[0]}, profiler on): wall {wall:.3f} s, "
        f"device busy {busy_s:.3f} s ({100 * busy_s / wall:.1f}%), "
        f"{sum(e.count for e in rows)} kernel launches")
    for e in sorted(rows, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:9.2f} ms {e.count:7d}x  {e.key[:90]}")


def check_finite(samples: dict, where: str) -> None:
    for name, x in samples.items():
        if not np.isfinite(x).all():
            raise SystemExit(f"non-finite posterior samples of {name} "
                             f"({where})")


def log_steps(steps) -> None:
    for i, st in enumerate(steps):
        log(f"  step {i}: {st['s']:.3f} s (surgery {st['surgery_s']:.4f}, "
            f"fit {st['fit_s']:.3f}, posterior {st['posterior_s']:.4f}); "
            f"cliques trained {st['trained']}, ar_inverse launches "
            f"{st['launches']}; Adam iterations {st['iters']}")


def case1_phase(device, parallel: bool, name2dim):
    """case1 for every seed by ``NFiSAM`` or ``ParallelNFiSAM``, each
    solve's kernel launches counted, then the median MMD gate.  Returns
    (launches per seed, the last seed's solver)."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    label = "ParallelNFiSAM" if parallel else "NFiSAM"
    per_step_by_seed, launches, solver = [], [], None
    for seed in SEEDS:
        ar_inverse_kernel.reset_launches()
        total, steps, per_step, solver = solve_case1(seed, device, parallel)
        launches.append(ar_inverse_kernel.launches)
        log(f"case1 {label} seed {seed}: total {total:.3f} s, posterior "
            f"{sum(st['posterior_s'] for st in steps)} s, ar_inverse "
            f"launches {launches[-1]}")
        log_steps(steps)
        if launches[-1] == 0:
            raise SystemExit(f"the case1 {label} solve never launched the "
                             f"ar_inverse kernel")
        for step, samples in enumerate(per_step):
            check_finite(samples, f"case1 {label} step {step} seed {seed}")
        per_step_by_seed.append(per_step)

    mmd_joint, ref_mmd, results = median_gate(per_step_by_seed, name2dim)
    for seed, (ours, _, per) in zip(SEEDS, results):
        log(f"case1 {label} seed {seed} joint MMD {ours:.4f}, per step "
            f"{[round(x, 4) for x in per]}")
    log(f"case1 {label} accuracy gate: median joint MMD {mmd_joint:.4f} vs "
        f"{MMD_GATE_FACTOR}x reference run1 {ref_mmd:.4f}")
    if not mmd_joint <= MMD_GATE_FACTOR * ref_mmd:
        raise SystemExit(f"case1 {label} accuracy gate failed")
    return launches, solver


def plaza_prefix(dataset: str, steps: int, device, defer_da: bool = False,
                 **overrides) -> tuple:
    """The plaza runner's solve (``plaza_family_run.solve_plaza``) of a
    stream's first ``steps`` steps, its kernel launches counted from 0:
    (the runner's result, per-step timings, last step's host samples by
    name, the truth by name, the port's floor over the prefix, the solver,
    launches)."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    argv = [dataset, "--limit-steps", str(steps), "--device", str(device)]
    ar_inverse_kernel.reset_launches()
    out = pfr.solve_plaza(pfr.parse_args(
        argv + (["--defer-da"] if defer_da else [])), **overrides)
    return out + (ar_inverse_kernel.launches,)


def plaza_phase(device):
    """The plaza1 prefix through the plaza runner (mode repair off), its
    kernel launches counted, then the translation-error gate.  Returns
    the solver."""
    _, steps, samples, truth, floor, solver, launches = plaza_prefix(
        "plaza1", PLAZA_STEPS, device, **PLAZA_ARGS)
    worst, rmse = translation_errors(samples, truth)
    log(f"plaza1 first {PLAZA_STEPS} steps, ParallelNFiSAM: total "
        f"{sum(st['s'] for st in steps):.3f} s, ar_inverse launches "
        f"{launches}; bucket log {solver.bucket_log}")
    log_steps(steps)
    log(f"plaza1: RMSE {rmse:.3f} m over {len(samples)} variables")
    check_finite(samples, "plaza1")
    if launches == 0:
        raise SystemExit("the plaza1 solve never launched the ar_inverse "
                         "kernel")
    plaza_floor_gate("plaza1", worst, floor)
    return solver


def robots_phase(device):
    """The robots graph by ``ParallelNFiSAM`` and by ``NFiSAM``, kernel
    launches counted per solver; gates: the batched trainer ran a bucket
    of ``ROBOTS`` cliques, and the two solvers' per-robot range posteriors
    agree.  Returns (parallel solver, sequential solver)."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    moments, solvers = [], []
    for parallel in (True, False):
        label = "ParallelNFiSAM" if parallel else "NFiSAM"
        ar_inverse_kernel.reset_launches()
        steps, samples, solver = solve_robots(device, parallel)
        launches = ar_inverse_kernel.launches
        log(f"robots R={ROBOTS} T={ROBOT_STEPS} {label}: total "
            f"{sum(st['s'] for st in steps):.3f} s, ar_inverse launches "
            f"{launches}")
        log_steps(steps)
        check_finite(samples, f"robots {label}")
        if launches == 0:
            raise SystemExit(f"the robots {label} solve never launched the "
                             f"ar_inverse kernel")
        moments.append(range_moments(samples))
        solvers.append(solver)
    buckets = solvers[0].bucket_log
    dmu, dsd = np.abs(moments[0] - moments[1]).max(axis=0)
    log(f"robots gate: bucket log {buckets}; range posterior mean "
        f"{np.round(moments[0][:, 0], 3).tolist()} vs "
        f"{np.round(moments[1][:, 0], 3).tolist()}, worst |dmean| {dmu:.3f} "
        f"m, worst |dstd| {dsd:.3f} m (< {ROBOT_GATE_M})")
    if max(b for _, _, b in buckets) < ROBOTS:
        raise SystemExit(f"no bucket reached {ROBOTS} cliques: the batched "
                         f"trainer did not run at full width")
    if not (dmu < ROBOT_GATE_M and dsd < ROBOT_GATE_M):
        raise SystemExit("robots gate failed: the two solvers' range "
                         "posteriors differ")
    return solvers


def repair_phase(device):
    """The mode-repair graph for every seed of ``REPAIR_SEEDS``, each
    solve's kernel launches counted; gates: every seed's repair log,
    half-plane share and median |X1 - L1|, and the median of those over
    seeds.
    Returns the solvers."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    solvers, medians = [], []
    for seed in REPAIR_SEEDS:
        ar_inverse_kernel.reset_launches()
        steps, samples, solver = solve_repair(device, seed=seed)
        launches = ar_inverse_kernel.launches
        log_, med, share = repair_gates(solver, samples)
        log(f"mode-repair graph seed {seed}, ParallelNFiSAM "
            f"K={REPAIR_ARGS['num_knots']}: total "
            f"{sum(st['s'] for st in steps):.3f} s, ar_inverse launches "
            f"{launches}; repair log {log_} (== ['L1']), median |X1 - L1| "
            f"{med:.4f} m (< {REPAIR_SEED_GATE_M}), L1 at x > 0 "
            f"{share:.4f} (> {REPAIR_HALF_PLANE})")
        log_steps(steps)
        check_finite(samples, f"mode-repair graph seed {seed}")
        if launches == 0:
            raise SystemExit("the mode-repair solve never launched the "
                             "ar_inverse kernel")
        if not (log_ == ["L1"] and share > REPAIR_HALF_PLANE
                and med < REPAIR_SEED_GATE_M):
            raise SystemExit(f"mode-repair gates failed (seed {seed})")
        solvers.append(solver)
        medians.append(med)
    log(f"mode-repair gate: median over seeds {list(REPAIR_SEEDS)} of the "
        f"median |X1 - L1| {float(np.median(medians)):.4f} m (< "
        f"{REPAIR_GATE_M}); per seed {[round(m, 4) for m in medians]}")
    if not float(np.median(medians)) < REPAIR_GATE_M:
        raise SystemExit("mode-repair distance gate failed")
    return solvers


def separator_repair_phase(device):
    """Both variants of the separator trap with mode repair on (launches
    counted) and off.  Gates: with repair on the log is ["L1"] and every
    clique holding L1 retrained at the contradicting update; with it off
    the log is empty and the separator-only cliques kept their models (so
    the gate can fail).  Returns the repair-on solvers."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    solvers = []
    for x0_ranges in (True, False):
        label = ("separator trap, X0 " +
                 ("ranges L1" if x0_ranges else "does not range L1"))
        for on in (True, False):
            ar_inverse_kernel.reset_launches()
            steps, samples, solver = solve_separator_repair(
                device, x0_ranges, mode_repair=on)
            launches = ar_inverse_kernel.launches
            holding, sep_only, kept = separator_repair_cliques(solver)
            d = np.linalg.norm(samples["X3"][:, :2] - samples["L1"], axis=1)
            err = {k: round(float(np.linalg.norm(
                samples[k][:, :2].mean(0) - xy)), 4)
                for k, xy in SEPARATOR_TRUTH.items()}
            log(f"{label}, mode repair {'on' if on else 'off'}: total "
                f"{sum(st['s'] for st in steps):.3f} s, ar_inverse launches "
                f"{launches}; repair log {solver.mode_repair_log}; cliques "
                f"holding L1 {holding}, L1 only in the separator {sep_only},"
                f" kept their models {kept}; median |X3 - L1| "
                f"{float(np.median(d)):.4f} m (true 2.2361), L1 at x > 0 "
                f"{float(np.mean(samples['L1'][:, 0] > 0)):.4f}; pose "
                f"posterior-mean errors (m) {err}")
            log_steps(steps)
            check_finite(samples, label)
            if launches == 0:
                raise SystemExit(f"{label}: the solve never launched the "
                                 f"ar_inverse kernel")
            if not sep_only:
                raise SystemExit(f"{label}: no clique holds L1 only in "
                                 f"its separator")
            if on and not (solver.mode_repair_log == ["L1"] and not kept):
                raise SystemExit(f"{label}: mode repair did not retrain "
                                 f"every clique holding L1")
            if not on and not (solver.mode_repair_log == [] and kept):
                raise SystemExit(f"{label}: with mode repair off every "
                                 f"clique holding L1 retrained anyway")
            if on:
                solvers.append((label, solver))
    return solvers


def case1_da_phase(device):
    """case1_da for every seed through its runner, each solve's kernel
    launches counted from 0 just before it, then the per-seed gates.
    Returns the solvers."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    solvers = []
    case_dir = tempfile.mkdtemp(prefix="case1_da_")
    try:
        for seed in DA_SEEDS:
            ar_inverse_kernel.reset_launches()
            steps, samples, truth, weights, solver, _ = \
                solve_case1_da(seed, device, case_dir)
            launches = ar_inverse_kernel.launches
            log(f"case1_da ParallelNFiSAM seed {seed} (the case1_da runner):"
                f" total {sum(st['s'] for st in steps):.3f} s, ar_inverse "
                f"launches {launches}; repair log {solver.mode_repair_log};"
                f" bucket log {solver.bucket_log}")
            for i, st in enumerate(steps):
                log(f"  step {i}: {st['s']:.3f} s (surgery "
                    f"{st['surgery_s']:.4f}, fit {st['fit_s']:.3f}, "
                    f"posterior {st['posterior_s']:.4f}); cliques trained "
                    f"{st['trained']}; Adam iterations {st['iters']}")
            check_finite(samples, f"case1_da seed {seed}")
            if launches == 0:
                raise SystemExit(f"the case1_da solve (seed {seed}) never "
                                 f"launched the ar_inverse kernel")
            pose_err = {name: float(np.linalg.norm(
                samples[name][:, :2].mean(0) - truth[name][:2]))
                for name in samples if name.startswith("X")}
            log(f"case1_da seed {seed}: pose posterior-mean errors (m) "
                f"{ {k: round(v, 4) for k, v in sorted(pose_err.items())} } "
                f"(< {DA_POSE_GATE_M})")
            for obs, lmk in DA_TRUE.items():
                gated = f" (gate > {DA_WEIGHT_GATE})" if obs in DA_GATED \
                    else ""
                log(f"case1_da seed {seed}: {obs}->{lmk} weight "
                    f"{weights[obs][lmk]:.4f} (all {weights[obs]}); the JAX "
                    f"package on a TPU: {DA_TPU_WEIGHTS[obs]}{gated}")
            if max(pose_err.values()) >= DA_POSE_GATE_M:
                raise SystemExit(f"case1_da seed {seed}: pose-error gate "
                                 f"failed")
            if not all(weights[obs][DA_TRUE[obs]] > DA_WEIGHT_GATE
                       for obs in DA_GATED):
                raise SystemExit(f"case1_da seed {seed}: weight gate failed")
            solvers.append(solver)
    finally:
        shutil.rmtree(case_dir, ignore_errors=True)
    return solvers


def plaza_ada_phase(device):
    """The plaza1_ada0.2 prefix through the plaza runner (mode repair on),
    its kernel launches counted, its DA snapshots, then the
    translation-error gate.  Returns the solver."""
    result, steps, samples, truth, floor, solver, launches = plaza_prefix(
        "plaza1_ada0.2", PLAZA_ADA_STEPS, device, **PLAZA_ADA_ARGS)
    worst, rmse = translation_errors(samples, truth)
    log(f"plaza1_ada0.2 first {PLAZA_ADA_STEPS} steps, ParallelNFiSAM: "
        f"total {sum(st['s'] for st in steps):.3f} s, ar_inverse launches "
        f"{launches}; {len(solver.physical_bayes_tree.clique_nodes)} "
        f"cliques; repair log {solver.mode_repair_log}; bucket log "
        f"{solver.bucket_log}")
    log_steps(steps)
    for snap in result["hypo_curve"]:
        log(f"  step {snap['step']}: DA true-association mean weight "
            f"{snap['mean_true_weight']} over {snap['n']} factors, resolved "
            f"(> {pfr.RESOLVED_WEIGHT}) {snap['resolved_frac']}")
    log(f"plaza1_ada0.2: RMSE {rmse:.3f} m over {len(samples)} variables")
    check_finite(samples, "plaza1_ada0.2")
    if launches == 0:
        raise SystemExit("the plaza1_ada0.2 solve never launched the "
                         "ar_inverse kernel")
    plaza_floor_gate("plaza1_ada0.2", worst, floor)
    return solver


def map_floor_phase(device) -> None:
    """The MAP floors at full size (``MAP_CASES``), each held by
    ``map_gate`` to the port's and the JAX package's CPU figures from the
    same start."""
    from nfisam_tpu_torch.io import graph_file_parser
    from nfisam_tpu_torch.solver import (GaussNewtonMAP,
                                         IncrementalGaussNewtonMAP)

    for label, (path, kind) in MAP_CASES.items():
        if kind == "laplace":
            def new_solver(n, f):
                return GaussNewtonMAP(n, f, device=device)
        else:
            def new_solver():
                return IncrementalGaussNewtonMAP(device=device)
        r = map_case(label, graph_file_parser, new_solver)
        j_rmse, j_max, j_iters, j_nll = JAX_MAP_FLOORS[label]
        (b_lo, b_hi), (n_lo, n_hi) = JAX_MAP_BANDS[label]
        log(f"{label} ({os.path.basename(path)}): RMSE {r['rmse']:.4f} m, "
            f"max error {r['max']:.4f} m, {r['iters']} LM iterations, final "
            f"NLL {r['nll']:.4f}, {r['s']:.3f} s; the JAX package on the "
            f"CPU: RMSE {j_rmse:.4f}, max {j_max:.4f}, {j_iters} "
            f"iterations, NLL {j_nll:.4f}; in the port's dtype RMSE "
            f"{b_lo:.4f}-{b_hi:.4f}, NLL {n_lo:.4f} to {n_hi:.4f} (gates: "
            f"RMSE within {MAP_RMSE_TOL_M} of that band, NLL <= its top + "
            f"{MAP_BAND_NLL_RTOL} x |NLL| and <= JAX's + {MAP_NLL_RTOL} x "
            f"|NLL|)")
        if not map_gate(label, r):
            raise SystemExit(f"{label}: MAP floor gate failed")
        if label == REPEAT_MAP_CASE:
            again = map_case(label, graph_file_parser, new_solver)
            log(f"{label} again in this process: RMSE {again['rmse']!r} m, "
                f"NLL {again['nll']!r} (first {r['rmse']!r}, {r['nll']!r}); "
                f"{again['s'] / again['iters']:.4f} s an LM iteration "
                f"(first {r['s'] / r['iters']:.4f})")
            if (again["rmse"], again["nll"]) != (r["rmse"], r["nll"]):
                raise SystemExit(f"{label}: two solves in one process "
                                 f"differ")
    time_map_products(device)


def time_map_products(device, timer=None) -> float:
    """The banked MAP's Hessian-vector products at plaza1's truth (D =
    2342, in ``MAP_DTYPE``), each timed by ``timer(fn, warmup, repeats)``
    (``time_cuda`` by default): one eager ``jvp`` of ``grad`` (the JAX
    package's product), the sparse Hessian's assembly (once an LM
    iteration), one product with it, and an LM step's 300-iteration CG on
    it, each product both as the solver takes it (``SparseHessian.mv``,
    summed in a fixed order) and as cuSPARSE's ``torch.mv`` does.  Fails
    unless the products agree within 1e-6 of the largest entry; returns
    the largest difference."""
    from nfisam_tpu_torch.io import graph_file_parser
    from nfisam_tpu_torch.solver import IncrementalGaussNewtonMAP
    from nfisam_tpu_torch.solver import banked_joint as bj

    timer = timer or time_cuda
    nodes, truth, factors = graph_file_parser(PLAZA1_FG)
    m = IncrementalGaussNewtonMAP(device=device)
    m.update(nodes, factors)
    banks = m.banks.to_device(device, bj.MAP_DTYPE)
    x = torch.as_tensor(np.concatenate(
        [np.asarray(truth[v], np.float64)[:v.dim] for v in m.vars]),
        dtype=bj.MAP_DTYPE, device=device)
    v = torch.ones_like(x)
    grad = torch.func.grad(lambda y: bj._banked_nll(y, banks))
    hessian = bj.SparseHessian(banks, m.dim)
    H = hessian.at(x)
    b = -grad(x)
    jvp_ms = timer(lambda: torch.func.jvp(grad, (x,), (v,)), 2, 5)
    at_ms = timer(lambda: hessian.at(x), 2, 5)
    mv_ms = timer(lambda: hessian.mv(H, v), 5, 30)
    lib_ms = timer(lambda: torch.mv(H, v), 5, 30)
    cg_ms = timer(lambda: bj.conjugate_gradient(
        lambda p: hessian.mv(H, p) + bj.MAP_INIT_DAMPING * p, b,
        bj.MAP_CG_ITERS), 1, 3)
    lib_cg_ms = timer(lambda: bj.conjugate_gradient(
        lambda p: torch.mv(H, p) + bj.MAP_INIT_DAMPING * p, b,
        bj.MAP_CG_ITERS), 1, 3)
    hv = torch.func.jvp(grad, (x,), (v,))[1]
    diff = max(float((hessian.mv(H, v) - hv).abs().max() / hv.abs().max()),
               float((torch.mv(H, v) - hv).abs().max() / hv.abs().max()))
    log(f"banked MAP products at plaza1's truth (D = {m.dim}, "
        f"{H.values().numel()} stored entries, {bj.MAP_DTYPE}): eager jvp "
        f"of grad {jvp_ms:.3f} ms a product; sparse Hessian assembly "
        f"{at_ms:.3f} ms, a fixed-order product with it {mv_ms:.4f} ms "
        f"(cuSPARSE's torch.mv {lib_ms:.4f} ms), {bj.MAP_CG_ITERS}-iteration "
        f"CG on it {cg_ms:.3f} ms (with torch.mv {lib_cg_ms:.3f} ms); max "
        f"|difference| of the products {diff:.3e} of the largest entry")
    if not diff <= 1e-6:
        raise SystemExit("the sparse Hessian disagrees with jvp of grad")
    return diff


def map_gate(label: str, r: dict) -> bool:
    """A MAP case's result against the JAX package's CPU figures (the
    gates above ``MAP_RMSE_TOL_M``)."""
    j_nll = JAX_MAP_FLOORS[label][3]
    (lo, hi), (_, n_hi) = JAX_MAP_BANDS[label]
    rmse, nll = r["rmse"], r["nll"]
    return bool(np.isfinite(nll) and
                lo - MAP_RMSE_TOL_M <= rmse <= hi + MAP_RMSE_TOL_M and
                nll <= n_hi + MAP_BAND_NLL_RTOL * abs(n_hi) and
                nll <= j_nll + MAP_NLL_RTOL * abs(j_nll))


def log_manhattan_steps(steps) -> None:
    for i, st in enumerate(steps):
        dims: dict = {}
        for d, _, b in st["buckets"]:
            dims[d] = dims.get(d, 0) + b
        log(f"  step {i}: wall {st['s']:.3f} s (surgery "
            f"{st['surgery_s']:.4f}, fit {st['fit_s']:.3f}, posterior "
            f"{st['posterior_s']:.4f}), floor {st['floor_s']:.4f} s "
            f"({st['floor_iters']} LM iterations, NLL "
            f"{st['floor_nll']:.4f}); ar_inverse launches {st['launches']}; "
            f"cliques trained by padded dim {dims}")


def manhattan_phase(device):
    """The Manhattan-scale smoke (the runner's ``solve_manhattan`` at
    ``MANHATTAN_G8_ARGV``), its kernel launches counted; the runner's
    read-out and its accuracy gate.  Returns the solver."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    ar_inverse_kernel.reset_launches()
    t0 = time.perf_counter()
    _, steps, m, samples, solver = solve_manhattan(
        parse_args(MANHATTAN_G8_ARGV + ["--device", str(device)]))
    total = time.perf_counter() - t0
    launches = ar_inverse_kernel.launches
    log(f"manhattan g8 first {MANHATTAN_STEPS} steps, ParallelNFiSAM "
        f"(ccolamd) + IncrementalGaussNewtonMAP: total {total:.3f} s, "
        f"ar_inverse launches {launches}; "
        f"{len(solver.physical_bayes_tree.clique_nodes)} cliques; repair "
        f"events {len(solver.mode_repair_log)} {solver.mode_repair_log}")
    log_manhattan_steps(steps)
    log(f"manhattan g8: {scale_line(m)}")
    check_finite(samples, "manhattan g8")
    if launches == 0:
        raise SystemExit("the manhattan solve never launched the "
                         "ar_inverse kernel")
    if not manhattan_gate(m):
        raise SystemExit("manhattan accuracy gate failed")
    return solver


def scale_line(m: dict) -> str:
    """The runner's read-out ``m`` as the Manhattan phases print it."""
    return (f"raw translation RMSE {m['trans_rmse']:.4f} m (<= "
            f"{RMSE_BOUND_M}), Kabsch-aligned {m['aligned_trans_rmse']:.4f} "
            f"m, anchored {m['anchored_trans_rmse']:.4f} m (<= "
            f"{ANCHORED_FACTOR} x incremental MAP "
            f"{m['incremental_map_rmse']:.4f} m), truth-initialised floor "
            f"{m['map_floor_rmse']:.4f} m, 95% coverage "
            f"{m['coverage_95_frac']:.4f}")


# --------------------------------------------------------------------------
# this slice's paths: the eight-node oracle, case1 from the JAX package's
# checkpoint store, lawnmower_4x4 through the command line
# --------------------------------------------------------------------------
def eight_node_errors(samples: dict, oracle) -> tuple:
    """Per variable (in order): the sample mean's distance from the exact
    posterior mean, and the largest relative error of a sample variance
    against the exact one.  ``samples`` by variable name."""
    from nfisam_tpu_torch.eval import gaussian_displacement_graph_moments

    xs = oracle[0]
    mean, cov = gaussian_displacement_graph_moments(*oracle)
    mean_err, var_err = [], []
    for i, v in enumerate(xs):
        s = np.asarray(samples[str(v.name)], np.float64)
        mean_err.append(float(np.linalg.norm(s.mean(0) -
                                             mean[2 * i:2 * i + 2])))
        var_err.append(float(np.max(np.abs(
            np.var(s, axis=0, ddof=1) / np.diag(cov)[2 * i:2 * i + 2] -
            1.0))))
    return mean_err, var_err


def solve_eight_nodes(seed: int, device, **overrides):
    """The eight-node chain by ``NFiSAM`` in one step (the example
    module's ``solve``).  Returns (timings, host samples, solver,
    closed-form arguments)."""
    return r8.solve(seed, device, **overrides)


def eight_node_phase(device):
    """The eight-node oracle for every seed, each solve's launches
    counted; gates against 2x the JAX package's worst.  Returns the last
    seed's solver."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    mean_gate = EIGHT_NODE_GATE_FACTOR * JAX_EIGHT_NODE_WORST[0]
    var_gate = EIGHT_NODE_GATE_FACTOR * JAX_EIGHT_NODE_WORST[1]
    solver = None
    for seed in EIGHT_NODE_SEEDS:
        ar_inverse_kernel.reset_launches()
        steps, samples, solver, oracle = solve_eight_nodes(seed, device)
        launches = ar_inverse_kernel.launches
        check_finite(samples, f"eight-node seed {seed}")
        mean_err, var_err = eight_node_errors(samples, oracle)
        log(f"eight-node R2 chain seed {seed}, NFiSAM: {steps[0]['s']:.3f} s "
            f"(fit {steps[0]['fit_s']:.3f}, posterior "
            f"{steps[0]['posterior_s']:.4f}), cliques trained "
            f"{steps[0]['trained']}, Adam iterations {steps[0]['iters']}, "
            f"ar_inverse launches {launches}; sample-mean error per "
            f"variable {[round(e, 4) for e in mean_err]} m (<= {mean_gate:.4f}"
            f" = {EIGHT_NODE_GATE_FACTOR} x the JAX package's worst "
            f"{JAX_EIGHT_NODE_WORST[0]:.4f}), relative variance error "
            f"{[round(e, 4) for e in var_err]} (<= {var_gate:.4f})")
        if launches == 0:
            raise SystemExit("the eight-node solve never launched the "
                             "ar_inverse kernel")
        if max(mean_err) > mean_gate or max(var_err) > var_gate:
            raise SystemExit(f"eight-node seed {seed}: the posterior is "
                             f"off its closed form")
    return solver


def case1_jax_checkpoint_phase(device, name2dim):
    """case1 by ``ParallelNFiSAM`` from a copy of the JAX package's
    checkpoint store: every clique loads, none trains, and the kernel
    draws the posterior through the JAX package's flows.  Returns the
    solver."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        shutil.copytree(CASE1_JAX_CKPT, ckpt)
        ar_inverse_kernel.reset_launches()
        total, steps, per_step, solver = solve_case1(
            SEEDS[0], device, parallel=True, checkpoint_dir=ckpt)
        launches = ar_inverse_kernel.launches
    trained = sum(st["trained"] for st in steps)
    for step, samples in enumerate(per_step):
        check_finite(samples, f"case1 from the JAX store step {step}")
    ours, ref, per = accuracy_gate(per_step, name2dim)
    log(f"case1 from the JAX package's checkpoint store (seed {SEEDS[0]}), "
        f"ParallelNFiSAM: total {total:.3f} s, cliques trained {trained}, "
        f"ar_inverse launches {launches}; joint MMD {ours:.4f} (<= "
        f"{MMD_GATE_FACTOR} x reference run1 {ref:.4f}), per step "
        f"{[round(x, 4) for x in per]}")
    log_steps(steps)
    if trained:
        raise SystemExit("case1 from the JAX store trained cliques")
    if launches == 0:
        raise SystemExit("case1 from the JAX store never launched the "
                         "ar_inverse kernel")
    if not ours <= MMD_GATE_FACTOR * ref:
        raise SystemExit("case1 from the JAX store: accuracy gate failed")
    return solver


def run_rmse(run_dir: str, fg: str) -> dict:
    """A ``solve`` run read back from its artifacts alone: the last step's
    samples and ordering, the per-step times and the hypothesis weights.
    Returns {"trans", "landmark" (RMSE m of the posterior means'
    translation against the ``.fg``'s truth, all variables and landmarks
    only), "means" {name: mean}, "step_s", "steps", "weights" {factor:
    weights}, "trained" (cliques trained a step)}."""
    from nfisam_tpu_torch.io import graph_file_parser

    nodes, truth, _ = graph_file_parser(fg)
    dims = {str(v.name): v.dim for v in nodes}
    truth = {str(v.name): np.asarray(t) for v, t in truth.items()}
    steps = sorted(int(f[4:]) for f in os.listdir(run_dir)
                   if f.startswith("step") and f[4:].isdigit())
    last = os.path.join(run_dir, f"step{steps[-1]}")
    X = np.loadtxt(last, ndmin=2)
    with open(last + "_ordering") as f:
        names = f.read().split()
    means, col = {}, 0
    for n in names:
        means[n] = X[:, col:col + dims[n]].mean(0)
        col += dims[n]
    errs = {n: float(np.linalg.norm(means[n][:2] - truth[n][:2]))
            for n in names if n in truth}
    lmk = [e for n, e in errs.items() if n.startswith("L")]
    weights = {}
    if os.path.exists(last + ".hypoweights"):
        with open(last + ".hypoweights") as f:
            for line in f:
                name, w = line.strip().split(" : ")
                weights[name] = [float(x) for x in w.split(",")]
    trained = []
    for i in steps:
        with open(os.path.join(run_dir, f"step{i}_step_training_loss")) as f:
            trained.append(len(json.loads(f.read())))
    with open(os.path.join(run_dir, "step_timing")) as f:
        step_s = [float(t) for t in f.read().split()]
    return {"trans": float(np.sqrt(np.mean(np.square(list(errs.values()))))),
            "landmark": float(np.sqrt(np.mean(np.square(lmk)))) if lmk
            else float("nan"),
            "means": means, "step_s": step_s, "steps": len(steps),
            "weights": weights, "trained": trained}


def solve_lawnmower(device, tmp: str, extra_argv=()) -> dict:
    """lawnmower_4x4 through ``cli.main`` in this process (``extra_argv``
    appended: a later flag wins), then again from the same checkpoint
    directory, then ``baseline`` of the graph and ``mmd`` of the first
    run's last step against its Laplace samples through ``python -m
    nfisam_tpu_torch``.  Returns {"first", "rerun" (``run_rmse``), "wall"
    (s), "launches" (the first run's), "moved" (the largest
    posterior-mean move of the rerun, m), "commands" [(name, exit code,
    seconds, last output line)]}."""
    from nfisam_tpu_torch import cli
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    out, ckpt = os.path.join(tmp, "runs"), os.path.join(tmp, "ckpt")
    dev_args = [] if torch.device(device).type == "cuda" else \
        ["--device", str(device)]
    argv = lawnmower_argv(0, out, ckpt) + dev_args + list(extra_argv)
    ar_inverse_kernel.reset_launches()
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise SystemExit("lawnmower_4x4: solve exited non-zero")
    wall = time.perf_counter() - t0
    launches = ar_inverse_kernel.launches
    first = run_rmse(os.path.join(out, "run1"), LAWNMOWER_FG)
    if cli.main(argv) != 0:
        raise SystemExit("lawnmower_4x4 rerun: solve exited non-zero")
    rerun = run_rmse(os.path.join(out, "run2"), LAWNMOWER_FG)
    moved = max(float(np.linalg.norm(rerun["means"][n] - first["means"][n]))
                for n in first["means"])
    laplace = os.path.join(tmp, "laplace.txt")
    last = os.path.join(out, "run1", f"step{first['steps'] - 1}")
    commands = []
    for args in (["baseline", "--fg", LAWNMOWER_FG, "--out", laplace] +
                 dev_args, ["mmd", last, laplace]):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nfisam_tpu_torch", *args], cwd=HERE,
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
        commands.append((args[0], proc.returncode, time.perf_counter() - t0,
                         (proc.stdout.strip().splitlines() or [""])[-1]))
    return dict(first=first, rerun=rerun, wall=wall, launches=launches,
                moved=moved, commands=commands)


def lawnmower_phase(device) -> int:
    """``solve_lawnmower`` at full width and its gates.  Returns the first
    run's kernel launches."""

    with tempfile.TemporaryDirectory() as tmp:
        r = solve_lawnmower(device, tmp)
    first, rerun = r["first"], r["rerun"]
    bound = LAWNMOWER_GATE_FACTOR * JAX_LAWNMOWER_WORST
    log(f"lawnmower_4x4 via cli.main solve (seed 0): {first['steps']} steps "
        f"in {r['wall']:.3f} s, per step "
        f"{[round(t, 3) for t in first['step_s']]} s, cliques trained per "
        f"step {first['trained']}, ar_inverse launches {r['launches']}")
    log(f"lawnmower_4x4: translation RMSE {first['trans']:.4f} m (<= "
        f"{bound:.4f} = {LAWNMOWER_GATE_FACTOR} x the JAX CLI's worst over "
        f"seeds 0-4 on the CPU, {JAX_LAWNMOWER_WORST:.4f}), landmark RMSE "
        f"{first['landmark']:.4f} m; the JAX package on a TPU "
        f"(BENCHMARKS.md, a TPU figure): {TPU_LAWNMOWER_RMSE} m")
    for name, w in first["weights"].items():
        log(f"  hypothesis weights {name}: {[round(x, 4) for x in w]}")
    log(f"lawnmower_4x4 rerun from the checkpoint directory: "
        f"{sum(rerun['step_s']):.3f} s of steps, cliques trained "
        f"{sum(rerun['trained'])}, translation RMSE {rerun['trans']:.4f} m, "
        f"largest posterior-mean move {r['moved']:.4f} m (<= "
        f"{RERUN_MEAN_GATE_M})")
    for name, rc, seconds, tail in r["commands"]:
        log(f"python -m nfisam_tpu_torch {name}: exit {rc} in "
            f"{seconds:.1f} s; {tail}")
    if r["launches"] == 0:
        raise SystemExit("the lawnmower solve never launched the "
                         "ar_inverse kernel")
    if not all(np.isfinite(m).all() for m in first["means"].values()):
        raise SystemExit("lawnmower_4x4: non-finite posterior means")
    if not first["trans"] <= bound:
        raise SystemExit("lawnmower_4x4: accuracy gate failed")
    if sum(rerun["trained"]) or not r["moved"] <= RERUN_MEAN_GATE_M:
        raise SystemExit("lawnmower_4x4 rerun: the checkpoint gate failed")
    if any(rc != 0 for _, rc, _, _ in r["commands"]):
        raise SystemExit("python -m nfisam_tpu_torch exited non-zero")
    return r["launches"]


# --------------------------------------------------------------------------
# the reference samplers
# --------------------------------------------------------------------------
def ring_graph(core, factors):
    """The range-only graph of ``tests/test_samplers.py`` in the package
    whose ``core`` and ``factors`` are given: a tight prior on X0, a 5 m
    range to L1 and a broad prior on L1, so L1's posterior is an arc."""
    x0, l1 = core.R2Variable("X0"), core.R2Variable("L1")
    cov = np.eye(2) * 0.01
    return [x0, l1], [
        factors.UnaryR2GaussianPriorFactor(x0, np.zeros(2), covariance=cov),
        factors.R2RangeGaussianLikelihoodFactor(x0, l1, 5.0, 0.2),
        factors.UnaryR2GaussianPriorFactor(
            l1, np.array([5.0, 0.0]), covariance=np.eye(2) * 9.0)]


def gaussian_graph(core, factors):
    """X0 -- X1 with an extra (cycle-forming) prior on X1
    (``tests/test_samplers.py``).  Returns (variables, factors, closed-form
    (mean, covariance))."""
    from nfisam_tpu_torch.eval import gaussian_displacement_graph_moments

    x0, x1 = core.R2Variable("X0"), core.R2Variable("X1")
    cov = np.eye(2) * 0.5
    fs = [factors.UnaryR2GaussianPriorFactor(x0, np.zeros(2), covariance=cov),
          factors.R2RelativeGaussianLikelihoodFactor(
              x0, x1, np.array([2.0, 1.0]), covariance=cov),
          factors.UnaryR2GaussianPriorFactor(x1, np.array([2.5, 1.0]),
                                             covariance=cov)]
    moments = gaussian_displacement_graph_moments(
        [x0, x1], {(x0, x1): (np.array([2.0, 1.0]), cov)},
        {x0: (np.zeros(2), cov), x1: (np.array([2.5, 1.0]), cov)})
    return [x0, x1], fs, moments


def ring_errors(s) -> dict:
    """The ring posterior's statistics minus the analytic arc's
    (``tests/test_samplers.py``: radius 5 +- 0.2, E[cos th] = 0.792,
    E[sin th] = 0, std(th) = 0.697) and their bounds there."""
    d = s[:, 2:] - s[:, :2]
    r = np.linalg.norm(d, axis=1)
    th = np.arctan2(d[:, 1], d[:, 0])
    return {"r mean": (abs(r.mean() - 5.0), 0.15),
            "r std": (abs(r.std() - 0.2), 0.1),
            "cos mean": (abs(np.cos(th).mean() - 0.792), 0.06),
            "sin mean": (abs(np.sin(th).mean()), 0.06),
            "th std": (abs(th.std() - 0.697), 0.1)}


def ns_step5_mmd(samples, dims) -> float:
    """MMD of the translation columns of ``samples`` (columns of the
    variables ``dims`` [(name, dim)], in order) against the committed
    nested-sampling posterior ``ns_step5.sample``, both cut to 500-row
    subsets with one ``default_rng(0)``, ours first, as
    scripts/make_case1_step45_refs.py picks them."""
    from nfisam_tpu_torch.eval import mmd

    ref = np.loadtxt(NS_STEP5)
    with open(NS_STEP5.replace(".sample", "_ordering")) as f:
        order = f.read().split()
    name2dim = dict(dims)
    names = [n for n, _ in dims]
    ours, col = [], 0
    for _, d in dims:
        ours.append(np.asarray(samples)[:, col:col + 2])
        col += d
    rng = np.random.default_rng(0)

    def pick(A):
        return A[rng.choice(len(A), min(MMD_SUBSET, len(A)), replace=False)]

    return float(mmd(pick(np.hstack(ours)),
                     pick(_ref_block(ref, order, name2dim, names))))


def run_reference(sampler: str, seed: int, device, out: str,
                  samples: int = 1000) -> dict:
    """``cli.main(["reference", ...])`` on case1 at the command's
    defaults (``samples`` 1000).  Returns {"s" wall, "summary" (the
    printed dict), "samples", "order" (the ``_ordering`` file's names),
    "host_reads" by kind}."""
    import ast
    import contextlib
    import io

    from nfisam_tpu_torch import cli
    from nfisam_tpu_torch.samplers.nested import HOST_READS

    argv = ["reference", "--fg", CASE1_FG, "--sampler", sampler,
            "--samples", str(samples), "--seed", str(seed), "--out", out]
    if torch.device(device).type != "cuda":
        argv += ["--device", str(device)]
    HOST_READS.clear()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"reference --sampler {sampler} exited {rc}")
    line = text.getvalue().splitlines()[0]
    with open(out + "_ordering") as f:
        order = f.read().split()
    return {"s": wall, "summary": ast.literal_eval(line.split("; ", 1)[1]),
            "samples": np.loadtxt(out, ndmin=2), "order": order,
            "host_reads": dict(HOST_READS)}


def reference_gate(label: str, r: dict, dims, bound: float,
                   logz: bool) -> float:
    """The gates of one reference run: parsed artifacts of the case1
    joint's shape and order, finite samples, the MMD to ns_step5 within
    ``bound`` and, for nested sampling, logz near the brute-force
    evidence.  Returns the MMD."""
    names = [n for n, _ in dims]
    x = r["samples"]
    if r["order"] != names or x.shape[1] != sum(d for _, d in dims):
        raise SystemExit(f"{label}: the --out files do not parse as the "
                         f"JAX CLI's ({x.shape}, {r['order']})")
    if not np.isfinite(x).all():
        raise SystemExit(f"{label}: non-finite samples")
    m = ns_step5_mmd(x, dims)
    summ = r["summary"]
    msg = (f"{label}: {x.shape[0]} samples in {r['s']:.3f} s, MMD to "
           f"ns_step5 {m:.4f} (<= {bound:.4f}); {summ}; host reads "
           f"{r['host_reads']}")
    if logz:
        err = abs(summ["logz"] - CASE1_TRUE_LOGZ)
        tol = max(LOGZ_ERR_FACTOR * summ["logzerr"], LOGZ_FLOOR)
        reads = r["host_reads"]
        msg += (f"; |logz - ({CASE1_TRUE_LOGZ})| = {err:.4f} (<= "
                f"{tol:.4f}); host reads an iteration "
                f"{sum(reads.values()) / reads.get('ns_iteration', 1):.2f}")
        log(msg)
        if not err <= tol:
            raise SystemExit(f"{label}: logz off the brute-force evidence")
    else:
        log(msg)
    if not m <= bound:
        raise SystemExit(f"{label}: MMD to ns_step5 above its bound")
    return m


def case1_dims():
    from nfisam_tpu_torch.io import graph_file_parser

    nodes, _, factors = graph_file_parser(CASE1_FG)
    return nodes, factors, [(str(v.name), v.dim) for v in nodes]


def time_sampler_evals(device) -> None:
    """The samplers' inner evaluations on the case1 joint, eager and
    replayed from a CUDA graph (median ms of CUDA-event-timed calls):
    nested sampling's batch of 25 ``loglike(ptform(u))``, and NUTS's
    value and gradient at 4 chains by ``log_pdf`` and by factor banks,
    and a NUTS subtree.  Card numbers only: nothing on another device."""
    if torch.device(device).type != "cuda":
        return
    from nfisam_tpu_torch.samplers import GlobalMCMCSampler
    from nfisam_tpu_torch.factors.factors import value_and_grad_rows
    from nfisam_tpu_torch.utils.cuda_graph import CudaGraphed

    nodes, factors, _ = case1_dims()
    joint = GlobalMCMCSampler(nodes, factors, device=device).joint
    u = torch.rand((25, joint.dim), device=device)
    q = joint.sample(np.array([0, 1], np.uint32), 4, device)
    banked = GlobalMCMCSampler(nodes, factors, device=device).log_density()
    fns = {"NS batch of 25": (lambda u: joint.loglike(joint.ptform(u)), u),
           "NUTS value and gradient, log_pdf": (
               lambda q: value_and_grad_rows(joint.log_pdf, q), q),
           "NUTS value and gradient, banks": (
               lambda q: value_and_grad_rows(banked, q), q)}
    for name, (fn, x) in fns.items():
        graphed = CudaGraphed(fn)
        eager_ms = time_cuda(lambda: fn(x), repeats=20)
        graph_ms = time_cuda(lambda: graphed(x), repeats=20)
        log(f"{name} on case1: eager {eager_ms:.4f} ms a call, CUDA graph "
            f"{graph_ms:.4f} ms")
    # a NUTS subtree of 32 leapfrog steps at 4 chains, by banks
    from nfisam_tpu_torch.samplers.nuts import _subtree

    run = _subtree(banked, 8)
    lp, g = value_and_grad_rows(banked, q)
    p = torch.randn_like(q)
    args = (q, p, g, lp, torch.full((4, 1), 0.02, device=device),
            torch.ones((4, 1), device=device), torch.ones(q.shape[1],
                                                          device=device),
            torch.rand((32, 4), device=device), torch.zeros(4, device=device),
            torch.zeros(4, device=device))
    graphed = CudaGraphed(run)
    eager_ms = time_cuda(lambda: run(*args), warmup=2, repeats=5)
    graph_ms = time_cuda(lambda: graphed(*args), warmup=4, repeats=10)
    log(f"NUTS subtree of 32 steps on case1: eager {eager_ms:.4f} ms, CUDA "
        f"graph {graph_ms:.4f} ms ({graph_ms / 32:.4f} ms a step)")


def reference_nested_phase(device, samples: int = 1000) -> None:
    """Phase 19: ``reference --sampler nested`` on case1 for seeds 1-3."""

    from nfisam_tpu_torch.samplers import StructuredJointFactor

    time_sampler_evals(device)
    nodes, factors, dims = case1_dims()
    bound = max(NS_PAIR_TOL, SAMPLER_GATE_FACTOR *
                JAX_REFERENCE_MMD_WORST["nested"])
    with tempfile.TemporaryDirectory() as tmp:
        for seed in SEEDS:
            r = run_reference("nested", seed, device,
                              os.path.join(tmp, f"ns{seed}.txt"), samples)
            reference_gate(f"reference --sampler nested seed {seed}", r,
                           dims, bound, logz=True)
            if seed == SEEDS[0]:
                ksd_check(StructuredJointFactor(factors, nodes),
                          r["samples"], device,
                          f"reference --sampler nested seed {seed}")


def dynamic_ns_phase(device, seed: int = DYNAMIC_SEED) -> None:
    """Dynamic NS on case1 at the ns_step5.sample protocol, its gates,
    and the KSD of its samples on the card and on the CPU (cut from
    ``main`` for time)."""
    from nfisam_tpu_torch.samplers import GlobalNestedSampler
    from nfisam_tpu_torch.samplers.nested import HOST_READS

    nodes, factors, dims = case1_dims()
    HOST_READS.clear()
    summ = {}
    t0 = time.perf_counter()
    sampler = GlobalNestedSampler(nodes, factors, device=device)
    x = sampler.sample(key=np.array([0, seed], np.uint32),
                       live_points=DYNAMIC_LIVE, max_iters=DYNAMIC_ITERS,
                       dynamic=True, res_summary=summ)
    wall = time.perf_counter() - t0
    r = {"s": wall, "summary": summ, "samples": x,
         "order": [n for n, _ in dims], "host_reads": dict(HOST_READS)}
    reference_gate(f"dynamic NS seed {seed} ({DYNAMIC_LIVE} live, "
                   f"<= {DYNAMIC_ITERS} iterations)", r, dims,
                   max(NS_PAIR_TOL, SAMPLER_GATE_FACTOR *
                       JAX_REFERENCE_MMD_WORST["nested"]), logz=True)
    ksd_check(sampler.joint, x, device, "dynamic-NS")


def ksd_check(joint, x, device, label: str) -> None:
    """The KSD of KSD_ROWS rows of ``x`` under ``joint``: on the card in
    float32 and on the CPU in float64 (the score is the joint's float32
    gradient on each device); the U statistics must agree to KSD_RTOL."""
    from nfisam_tpu_torch.eval import gaussian_kernel_stein_discrepancy

    rows = x[np.random.default_rng(0).choice(len(x), KSD_ROWS,
                                             replace=False)]
    P = np.eye(x.shape[1]) / KSD_BANDWIDTH2
    t0 = time.perf_counter()
    card = gaussian_kernel_stein_discrepancy(
        joint, P, torch.as_tensor(rows, device=device))
    card_s = time.perf_counter() - t0
    cpu = gaussian_kernel_stein_discrepancy(
        joint, P, torch.as_tensor(rows), dtype=torch.float64)
    rel = abs(card[0] - cpu[0]) / max(abs(cpu[0]), 1e-30)
    log(f"KSD of {KSD_ROWS} {label} samples: card float32 U {card[0]!r} V "
        f"{card[3]!r} p {card[1]} ({card_s:.3f} s); CPU float64 U "
        f"{cpu[0]!r} V {cpu[3]!r} p {cpu[1]}; relative difference of U "
        f"{rel:.3e} (<= {KSD_RTOL})")
    if not (np.isfinite([card[0], cpu[0]]).all() and rel <= KSD_RTOL):
        raise SystemExit("KSD: the card and the CPU disagree")


def sampler_by_name(name: str):
    from nfisam_tpu_torch.samplers import (GlobalMCMCSampler,
                                           GlobalNestedSampler,
                                           GlobalSMCSampler)
    return {"nested": GlobalNestedSampler, "nuts": GlobalMCMCSampler,
            "smc": GlobalSMCSampler}[name]


def nuts_smc_phase(device, samples: int = 1000) -> None:
    """Phase 21: ``reference --sampler nuts`` and ``smc`` on case1 (seed
    0), then the closed-form Gaussian graph for all three samplers and
    the ring graph's arc for NS and SMC."""

    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors

    _, _, dims = case1_dims()
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("nuts", "smc"):
            r = run_reference(name, 0, device, os.path.join(tmp, name),
                              samples)
            reference_gate(f"reference --sampler {name} seed 0", r, dims,
                           SAMPLER_GATE_FACTOR *
                           JAX_REFERENCE_MMD_WORST[name], logz=False)
    vars_, fs, (mu, Sigma) = gaussian_graph(core, factors)
    for name, kw in ORACLE_RUNS:
        t0 = time.perf_counter()
        s = sampler_by_name(name)(vars_, fs, device=device).sample(**kw)
        mean_err = float(np.abs(s.mean(0) - mu).max())
        var_err = float(np.abs(np.diag(np.cov(s.T)) / np.diag(Sigma) -
                               1).max())
        log(f"closed-form Gaussian graph, {name} {kw}: "
            f"{time.perf_counter() - t0:.3f} s, mean error {mean_err:.4f} "
            f"(<= {ORACLE_MEAN_ATOL}), relative variance error "
            f"{var_err:.4f} (<= {ORACLE_VAR_RTOL})")
        if not (mean_err <= ORACLE_MEAN_ATOL and var_err <= ORACLE_VAR_RTOL):
            raise SystemExit(f"{name}: off the closed-form posterior")
    vars_, fs = ring_graph(core, factors)
    for name, kw in RING_RUNS:
        t0 = time.perf_counter()
        s = sampler_by_name(name)(vars_, fs, device=device).sample(**kw)
        errs = ring_errors(s)
        log(f"ring graph, {name} {kw}: {time.perf_counter() - t0:.3f} s, "
            f"{ {k: round(e, 4) for k, (e, _) in errs.items()} } (bounds "
            f"{ {k: b for k, (_, b) in errs.items()} })")
        if any(e > b for e, b in errs.values()):
            raise SystemExit(f"{name}: off the ring's analytic arc")


def clique_path_graph(core, factors, solver, device):
    """The graph of ``test_nested_clique_training_path`` through
    ``solver`` (``run_incremental``): an extra prior closes a loop, so the
    clique's joint needs the nested sampler."""
    xs = [core.R2Variable(f"X{i}") for i in range(2)]
    cov = np.eye(2) * 0.25
    fs = [factors.UnaryR2GaussianPriorFactor(xs[0], np.zeros(2),
                                             covariance=cov),
          factors.R2RelativeGaussianLikelihoodFactor(
              xs[0], xs[1], np.array([1.0, 1.0]), covariance=cov),
          factors.UnaryR2GaussianPriorFactor(
              xs[1], np.array([1.2, 1.0]), covariance=cov)]
    return run_incremental(solver, [(xs, fs)], device)


def flow_prior_check(solver, n: int) -> tuple:
    """Each ``FlowsPriorFactor`` the solver pushed up its tree:
    ``unif_to_sample`` of n unit-cube rows through the kernel against the
    same map through the plain inverse, on the card, compared as the
    kernel check compares them: in the flow's normalized coordinates
    (the samples less the flow's mean, over its std; angles wrapped),
    within atol + rtol KERNEL_TOL.  Returns (worst normalized |kernel -
    plain|, factors checked)."""
    from nfisam_tpu_torch.core.geometry import wrap_angle
    from nfisam_tpu_torch.flows import stack_inverse_masked_plain
    from nfisam_tpu_torch.solver.nfisam import FlowsPriorFactor

    worst, checked = 0.0, 0
    rng = np.random.default_rng(0)
    for f in solver._implicit_factors.values():
        if not isinstance(f, FlowsPriorFactor):
            continue
        m, sep = f._flow_model, f._obs_dim
        u = torch.as_tensor(rng.uniform(0.01, 0.99, (n, f.dim)).astype(
            np.float32), device=solver.device)
        got = f.unif_to_sample(u)
        ref = f._unif_to_sample(u, stack_inverse_masked_plain)
        mean, std = m.mean[sep:sep + f.dim], m.std[sep:sep + f.dim]
        circ = m.circ_mask[sep:sep + f.dim]
        diff = torch.where(circ, wrap_angle(got - ref), got - ref) / std
        ref_n = torch.where(circ, wrap_angle(ref - mean), ref - mean) / std
        err = float(diff.abs().max())
        bad = diff.abs() > UNIF_TOL + UNIF_TOL * ref_n.abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise SystemExit(f"unif_to_sample through the kernel disagrees "
                             f"with the plain inverse on {f}: normalized "
                             f"max |diff| {err:.3e}, {int(bad.sum())} "
                             f"entries beyond the tolerance")
        worst = max(worst, err)
        checked += 1
    return worst, checked


def nested_clique_phase(device, steps: int = NESTED_CASE1_STEPS):
    """Phase 22: the nested clique-sampling path, kernel launches counted
    from 0 just before each solve.  Returns the case1 solver."""
    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors
    from nfisam_tpu_torch.flows import ar_inverse_kernel
    from nfisam_tpu_torch.samplers.nested import HOST_READS
    from nfisam_tpu_torch.solver import NFiSAM, NFiSAMArgs

    solver = NFiSAM(NFiSAMArgs(**CLIQUE_PATH_ARGS), device=device)
    st, per_step = clique_path_graph(core, factors, solver, device)
    m1 = per_step[-1]["X1"].mean(0)
    err = float(np.linalg.norm(m1 - np.array([1.1, 1.0])))
    log(f"nested clique path, the loop graph by NFiSAM: {st[0]['s']:.3f} s, "
        f"X1 mean {np.round(m1, 4).tolist()}, |X1 mean - (1.1, 1.0)| "
        f"{err:.4f} m (<= {CLIQUE_PATH_GATE_M})")
    if not err <= CLIQUE_PATH_GATE_M:
        raise SystemExit("nested clique path: the loop graph's mean is off")

    from nfisam_tpu_torch.io import group_nodes_factors_incrementally

    nodes, factors_, _ = case1_dims()
    name2dim = {str(v.name): v.dim for v in nodes}
    batches = group_nodes_factors_incrementally(nodes, factors_, 1)[:steps]
    solver = NFiSAM(NFiSAMArgs(**{**BENCH_ARGS, "seed": SEEDS[0],
                                  "local_sampling_method": "nested"}),
                    device=device)
    HOST_READS.clear()
    ar_inverse_kernel.reset_launches()
    steps_t, per_step = run_incremental(solver, batches, device)
    launches = ar_inverse_kernel.launches
    total = sum(st["s"] for st in steps_t)
    log(f"case1 NFiSAM nested clique sampling seed {SEEDS[0]}: total "
        f"{total:.3f} s, ar_inverse launches {launches}, host reads "
        f"{dict(HOST_READS)}")
    log_steps(steps_t)
    for step, samples in enumerate(per_step):
        check_finite(samples, f"case1 nested step {step}")
    ours, ref, per = accuracy_gate(per_step, name2dim,
                                   MMD_STEPS[:len(per_step)])
    jax_mmd = float(np.mean(JAX_NESTED_CASE1_PER_STEP[:len(per_step)]))
    bound = MMD_GATE_FACTOR * ref
    if jax_mmd > bound:
        bound = SAMPLER_GATE_FACTOR * jax_mmd
    log(f"case1 nested clique sampling, steps 0-{len(per_step) - 1}: mean "
        f"joint MMD {ours:.4f} (<= {bound:.4f}; the JAX package on the CPU "
        f"{jax_mmd:.4f}), per step {[round(x, 4) for x in per]}")
    if launches == 0:
        raise SystemExit("the nested clique path never launched the "
                         "ar_inverse kernel")
    if not ours <= bound:
        raise SystemExit("case1 nested clique sampling: accuracy gate "
                         "failed")
    n = max(BENCH_ARGS["local_sample_num"] // 40, 8)
    worst, checked = flow_prior_check(solver, n)
    log(f"unif_to_sample at n={n} through the kernel vs the plain inverse "
        f"on {checked} flow priors: normalized max |diff| {worst:.3e}")
    if checked == 0:
        raise SystemExit("no flow prior to check unif_to_sample on")
    return solver, launches


# --------------------------------------------------------------------------
# the flow options and R^2 odometry
# --------------------------------------------------------------------------
def case1_options_argv(seed: int, out: str) -> list:
    """``solve`` of case1 at the bench configuration (``BENCH_ARGS``'
    counts, K, lr and ordering; ``ParallelNFiSAM``) with ``OPTIONS_ARGV``,
    for either package's command line."""
    return ["solve", "--fg", CASE1_FG, "--out", out, "--incremental-step",
            "1", "--knots", "9", "--iters", "2000", "--train-samples",
            "2000", "--posterior-samples", "1000", "--lr", "0.025",
            "--elimination", "pose_first", "--parallel", "--seed",
            str(seed)] + OPTIONS_ARGV


def run_per_step(run_dir: str, name2dim) -> tuple:
    """A ``solve`` run's per-step samples {name: (n, dim)} read back from
    its artifacts, and each step's Adam iterations a trained clique."""
    steps = sorted(int(f[4:]) for f in os.listdir(run_dir)
                   if f.startswith("step") and f[4:].isdigit())
    per_step, iters = [], []
    for i in steps:
        path = os.path.join(run_dir, f"step{i}")
        X = np.loadtxt(path, ndmin=2)
        with open(path + "_ordering") as f:
            names = f.read().split()
        cols = np.cumsum([0] + [name2dim[n] for n in names])
        per_step.append({n: X[:, cols[k]:cols[k + 1]]
                         for k, n in enumerate(names)})
        with open(path + "_step_training_loss") as f:
            iters.append([len(c) for c in json.loads(f.read()).values()])
    return per_step, iters


def solve_case1_options(seed: int, device, tmp: str, extra_argv=()) -> tuple:
    """case1 through ``cli.main`` with ``OPTIONS_ARGV`` (``extra_argv``
    appended).  Returns (wall s, per-step samples, per-step Adam
    iterations, launches by kernel variant)."""
    from nfisam_tpu_torch import cli
    from nfisam_tpu_torch.flows import ar_inverse_kernel
    from nfisam_tpu_torch.io import graph_file_parser

    nodes, _, _ = graph_file_parser(CASE1_FG)
    name2dim = {str(v.name): v.dim for v in nodes}
    out = os.path.join(tmp, f"seed{seed}")
    dev_args = [] if torch.device(device).type == "cuda" else \
        ["--device", str(device)]
    ar_inverse_kernel.reset_launches()
    t0 = time.perf_counter()
    if cli.main(case1_options_argv(seed, out) + dev_args +
                list(extra_argv)) != 0:
        raise SystemExit(f"case1 with {OPTIONS_ARGV}: solve exited "
                         f"non-zero")
    wall = time.perf_counter() - t0
    launches = dict(ar_inverse_kernel.variant_launches)
    per_step, iters = run_per_step(os.path.join(out, "run1"), name2dim)
    return wall, per_step, iters, launches


def options_gate(label: str, mmd_joint: float, ref_mmd: float) -> None:
    """A phase-23 solve's gate: its MMD <= max(MMD_GATE_FACTOR x
    reference run1's, OPTIONS_GATE_FACTOR x the JAX package's worst on
    the CPU)."""
    jax_worst = JAX_OPTIONS_MMD_WORST[label]
    bound = max(MMD_GATE_FACTOR * ref_mmd, OPTIONS_GATE_FACTOR * jax_worst)
    log(f"case1 {label}: mean joint MMD over steps 0-5 {mmd_joint:.4f} (<= "
        f"{bound:.4f}; the JAX package's worst on the CPU "
        f"{jax_worst:.4f})")
    if not mmd_joint <= bound:
        raise SystemExit(f"case1 {label}: accuracy gate failed")


def options_phase(device, name2dim) -> int:
    """Phase 23: the flow options on case1 at the bench configuration,
    kernel launches counted by variant from 0 just before each solve.
    Returns the generic kernel's launches in the command line's seed-1
    solve (the kernel line's)."""

    from nfisam_tpu_torch.flows import ar_inverse_kernel

    max_iters = BENCH_ARGS["flow_iterations"]
    label = " ".join(OPTIONS_ARGV)
    per_seed, generic_launches = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in OPTIONS_SEEDS:
            wall, per_step, iters, launches = solve_case1_options(
                seed, device, tmp)
            flat = [t for step in iters for t in step]
            stopped = sum(t < max_iters for t in flat)
            log(f"case1 via cli.main {label} seed {seed}: {wall:.3f} s, "
                f"Adam iterations per clique per step {iters}, "
                f"{stopped} of {len(flat)} cliques stopped by the "
                f"validation rule, ar_inverse launches {launches}")
            if launches["generic"] == 0:
                raise SystemExit(f"case1 {label}: the generic kernel was "
                                 f"never launched")
            for step, samples in enumerate(per_step):
                check_finite(samples, f"case1 {label} step {step}")
            generic_launches.append(launches["generic"])
            per_seed.append(per_step)
    mmd_joint, ref_mmd, results = median_gate(per_seed, name2dim)
    for seed, (ours, _, per) in zip(OPTIONS_SEEDS, results):
        log(f"case1 {label} seed {seed} joint MMD {ours:.4f}, per step "
            f"{[round(x, 4) for x in per]}")
    options_gate(label, mmd_joint, ref_mmd)

    for label, overrides in OPTION_SOLVES.items():
        ar_inverse_kernel.reset_launches()
        total, steps, per_step, solver = solve_case1(
            OPTIONS_SEEDS[0], device, parallel=True, **overrides)
        launches = dict(ar_inverse_kernel.variant_launches)
        buckets = sorted({(d, h) for st in steps for d, _, _ in st["buckets"]
                          for h in [solver._flow_config(d, []).hidden_dim]})
        log(f"case1 ParallelNFiSAM {label} seed {OPTIONS_SEEDS[0]}: total "
            f"{total:.3f} s, (dim, hidden) buckets {buckets}, ar_inverse "
            f"launches {launches}")
        log_steps(steps)
        if sum(launches.values()) == 0:
            raise SystemExit(f"case1 {label}: no ar_inverse launch")
        if label.startswith("dim_bucket_floor") and (
                buckets != [(128, 64)] or launches["specialized"] == 0):
            raise SystemExit(f"case1 {label}: not every clique ran the "
                             f"d=128 specialised kernel")
        for step, samples in enumerate(per_step):
            check_finite(samples, f"case1 {label} step {step}")
        ours, ref, per = accuracy_gate(per_step, name2dim)
        log(f"case1 {label} per step {[round(x, 4) for x in per]}")
        options_gate(label, ours, ref)
    return generic_launches[0]


def closed_form_graph(core, factors):
    """The graph of the JAX package's ``tests/test_map_solver.py::
    test_map_matches_closed_form_gaussian`` in the package whose ``core``
    and ``factors`` are given: two R^2 nodes, a prior on each and an
    odometry factor.  Returns (variables, factors, the closed form's
    arguments)."""
    x0, x1 = core.R2Variable("X0"), core.R2Variable("X1")
    cov = np.eye(2) * 0.5
    fs = [factors.UnaryR2GaussianPriorFactor(x0, np.zeros(2),
                                             covariance=cov),
          factors.R2RelativeGaussianLikelihoodFactor(
              x0, x1, np.array([2.0, 1.0]), covariance=cov),
          factors.UnaryR2GaussianPriorFactor(x1, np.array([2.5, 1.0]),
                                             covariance=cov)]
    oracle = ([x0, x1], {(x0, x1): (np.array([2.0, 1.0]), cov)},
              {x0: (np.zeros(2), cov), x1: (np.array([2.5, 1.0]), cov)})
    return [x0, x1], fs, oracle


def incremental_estimate(m, xs, fs) -> np.ndarray:
    """``IncrementalGaussNewtonMAP`` step by step (a node and the factors
    it closes), solved each step; returns the stacked estimate."""
    for i, x in enumerate(xs):
        m.update([x], [f for f in fs if x in f.vars and
                       all(v in xs[:i + 1] for v in f.vars)])
        m.solve()
    res = m.results()
    return np.concatenate([np.asarray(res[v])[:v.dim] for v in xs])


def baseline_estimate(device, xs, fs, tmp: str) -> np.ndarray:
    """``baseline`` of the graph written to a ``.fg`` by the port's
    writer, through ``cli.main`` in this process: the MAP it prints."""
    import contextlib
    import io

    from nfisam_tpu_torch import cli
    from nfisam_tpu_torch.io import write_factor_graph_to_file

    path = os.path.join(tmp, "r2_chain.fg")
    write_factor_graph_to_file(xs, fs, {}, path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["baseline", "--fg", path, "--device", str(device)])
    if rc != 0:
        raise SystemExit("baseline exited non-zero on the R^2 chain")
    printed = {}
    for line in out.getvalue().splitlines():
        name, _, rest = line.strip().partition(": [")
        if rest:
            printed[name] = np.array(rest.rstrip("]").split(), float)
    return np.concatenate([printed[str(v.name)] for v in xs])


def r2_map_errors(device, tmp: str) -> dict:
    """Each MAP solver's largest distance from the exact mean on the two
    R^2 odometry graphs (and ``baseline`` on the eight-node chain):
    {(graph, solver): m}."""
    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors
    from nfisam_tpu_torch.eval import gaussian_displacement_graph_moments
    from nfisam_tpu_torch.solver import (GaussNewtonMAP,
                                         IncrementalGaussNewtonMAP)

    errs = {}
    for graph, build in (("eight-node chain", eight_node_graph),
                         ("closed form", closed_form_graph)):
        xs, fs, oracle = build(core, factors)
        mu = np.asarray(gaussian_displacement_graph_moments(*oracle)[0])
        ests = {"GaussNewtonMAP": GaussNewtonMAP(xs, fs, device=device)
                .solve()[0],
                "IncrementalGaussNewtonMAP": incremental_estimate(
                    IncrementalGaussNewtonMAP(device=device), xs, fs)}
        if graph == "eight-node chain":
            ests["baseline"] = baseline_estimate(device, xs, fs, tmp)
        for name, est in ests.items():
            d = np.asarray(est, np.float64).reshape(-1, 2) - mu.reshape(-1, 2)
            errs[(graph, name)] = float(np.linalg.norm(d, axis=1).max())
    return errs


def r2_ranges(samples: dict) -> dict:
    """L1's posterior mean range to each measured pose."""
    return {x: float(np.linalg.norm(samples["L1"] - samples[x][:, :2],
                                    axis=1).mean())
            for x in R2_RANGE_MEASURED}


def solve_r2_range(seed: int, device, **overrides) -> tuple:
    """The R^2 range example by ``NFiSAM`` at its configuration (the
    example module's ``solve``).  Returns (per-step timings, last step's
    samples, repair log)."""
    steps, per_step, solver = r2_range_incremental.solve(seed, device,
                                                         **overrides)
    return steps, per_step[-1], list(solver.mode_repair_log)


def r2_odometry_phase(device) -> None:
    """Phase 24: R^2 odometry in the MAP solvers and ``baseline``, then the
    R^2 range example with mode repair on, kernel launches counted from 0
    just before each solve."""

    from nfisam_tpu_torch.flows import ar_inverse_kernel

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        errs = r2_map_errors(device, tmp)
    for (graph, name), err in errs.items():
        log(f"R^2 odometry, {graph} by {name}: largest distance from the "
            f"exact mean {err:.3e} m (<= {R2_MAP_TOL_M})")
    log(f"R^2 odometry MAP solves: {time.perf_counter() - t0:.3f} s")
    if not all(e <= R2_MAP_TOL_M for e in errs.values()):
        raise SystemExit("R^2 odometry: a MAP estimate is off the exact "
                         "mean")
    worst = 0.0
    for i, seed in enumerate(R2_RANGE_SEEDS):
        ar_inverse_kernel.reset_launches()
        steps, samples, repair_log = solve_r2_range(seed, device)
        launches = ar_inverse_kernel.launches
        check_finite(samples, f"R^2 range example seed {seed}")
        ranges = r2_ranges(samples)
        jax_log = JAX_R2_RANGE_REPAIR_LOGS[i]
        log(f"R^2 range example seed {seed}: "
            f"{sum(st['s'] for st in steps):.3f} s, L1's mean range "
            f"{ {x: round(r, 4) for x, r in ranges.items()} } (measured "
            f"{R2_RANGE_MEASURED}), repair log {repair_log} (the JAX "
            f"package's on the CPU: {jax_log}), ar_inverse launches "
            f"{launches}")
        log_steps(steps)
        if launches == 0:
            raise SystemExit("the R^2 range example never launched the "
                             "ar_inverse kernel")
        worst = max(worst, max(abs(r - R2_RANGE_MEASURED[x])
                               for x, r in ranges.items()))
    log(f"R^2 range example: worst |mean range - measured| {worst:.4f} m "
        f"(<= {R2_RANGE_GATE_M})")
    if not worst <= R2_RANGE_GATE_M:
        raise SystemExit("R^2 range example: a mean range is off its "
                         "measurement")


# --------------------------------------------------------------------------
# phases in child processes, side by side with the main process's
# --------------------------------------------------------------------------
# a host with at least this many usable cores and the card in the
# ``Default`` compute mode runs plaza1_ada0.2 and phases 25-32 in child
# processes beside the main process's phases, at most MAX_CHILDREN at
# once and at CHILD_NICENESS (all seven at once slowed the main path:
# PERF.md §5); else one after another
PARALLEL_MIN_CORES = 4
MAX_CHILDREN = 4
CHILD_NICENESS = 10
DRYRUN = [sys.executable, "-m", "nfisam_tpu_torch.parallel.dryrun"]


def host_readings() -> tuple:
    """(os.cpu_count(), usable cores, the card's compute mode)."""
    usable = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else os.cpu_count()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    return os.cpu_count(), usable, mode[0] if mode else "unknown"


def start_child(label: str, argv: list, tmp: str) -> dict:
    """Start ``argv`` in a child process from the repository root, its
    output to a file, its gate readings to ``<tmp>/<label>.json`` (the
    ``--result`` argument appended)."""
    result = os.path.join(tmp, f"{label.replace(' ', '_')}.json")
    out = open(os.path.join(tmp, f"{label.replace(' ', '_')}.log"), "w")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    # a session of its own, so ``stop_children`` reaches the processes the
    # child starts too (the dry runs' ranks)
    proc = subprocess.Popen(argv + ["--result", result], cwd=HERE, env=env,
                            stdout=out, stderr=subprocess.STDOUT,
                            start_new_session=True)
    # below the main path's CPU priority (the processes it starts inherit
    # it): the main path is host-bound and sets the script's wall
    os.setpriority(os.PRIO_PROCESS, proc.pid, CHILD_NICENESS)
    log(f"{label}: started in a child process (pid {proc.pid})")
    return {"label": label, "proc": proc, "out": out, "result": result,
            "t0": time.perf_counter()}


def start_children(phases: list, tmp: str, limit: int) -> tuple:
    """Start the child processes of ``phases`` ((label, argv), in that
    order), at most ``limit`` running at once: a thread starts the next
    one as an earlier one exits.  Returns (the children started, a list
    the thread fills; the thread, whose ``stop`` event ends the queue and
    which has started them all once it has ended)."""
    children, stop = [], threading.Event()

    def run():
        for label, argv in phases:
            while not stop.is_set() and sum(
                    c["proc"].poll() is None for c in children) >= limit:
                stop.wait(1.0)
            if stop.is_set():
                return
            children.append(start_child(label, argv, tmp))
    starter = threading.Thread(target=run, daemon=True)
    starter.stop = stop
    starter.start()
    return children, starter


def join_child(child: dict) -> dict:
    """Wait for a child, print its output (each line marked with its
    label) and return its gate readings; SystemExit if it failed."""
    rc = child["proc"].wait()
    child["out"].close()
    with open(child["out"].name) as fh:
        for line in fh.read().splitlines():
            print(f"# [{child['label']}] {line.lstrip('# ')}", flush=True)
    log(f"{child['label']}: child exited {rc}; joined "
        f"{time.perf_counter() - child['t0']:.1f} s after its start")
    if rc != 0 or not os.path.exists(child["result"]):
        raise SystemExit(f"{child['label']} failed (exit code {rc})")
    with open(child["result"]) as fh:
        return json.load(fh)


def child_phases(with_plaza_ada: bool) -> list:
    """(label, argv) of phases 25 and 26 (the dry runs of
    ``nfisam_tpu_torch.parallel``: 2 ranks chunking buckets, 4 ranks on a
    (clique, data) mesh, all on this card), ``with_plaza_ada`` of
    plaza1_ada0.2, and of the runners' phases: the headline Manhattan
    prefix (27), the plaza family (28), random_4x4 (29), manhattan_plaza
    (30), the case1_da oracle with the lawnmower_4x4 runner (31) and the
    examples (32)."""
    phases = [("phase 25 multihost", DRYRUN + ["multihost"]),
              ("phase 26 multichip 4", DRYRUN + ["multichip", "4"])]
    this = [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--child"]
    if with_plaza_ada:
        phases.append(("plaza1_ada0.2", this + ["plaza_ada"]))
    phases += [(label, this + [name])
               for name, (label, _, _) in RUNNER_CHILDREN.items()]
    return phases


def plaza_ada_child(result: str) -> int:
    """plaza1_ada0.2 as a child process: the phase, the fused pass against
    the walk on its final state, and its launches and launched shapes to
    ``result``."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel
    from nfisam_tpu_torch.utils.cuda_build import build_all_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all_kernels()
    device = torch.device("cuda")
    t0 = time.perf_counter()
    solver = plaza_ada_phase(device)
    launches = ar_inverse_kernel.launches
    rel, fused_s, walk_s = fused_vs_per_clique(solver)
    with open(result, "w") as fh:
        json.dump({"launches": launches, "fused_vs_walk": rel,
                   "fused_s": fused_s, "walk_s": walk_s,
                   "launched_shapes": sorted(
                       ar_inverse_kernel.launched_shapes),
                   "wall_s": time.perf_counter() - t0}, fh)
    return 0


def manhattan_g16_readings(device, steps: int = MANHATTAN_G16_STEPS,
                           **overrides) -> dict:
    """The headline Manhattan prefix (``MANHATTAN_G16_ARGV``, its first
    ``steps`` steps; ``overrides`` of the runner's solver arguments): the
    runner's solve with the kernel's launches counted from 0, its per-step
    lines, and the fused pass against the walk on the final state.
    Returns the readings ``manhattan_g16_report`` gates (JSON-able): the
    read-out, per-step timings, launches by kernel, launched shapes,
    finite samples and the wall."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    ar_inverse_kernel.reset_launches()
    ar_inverse_kernel.clear_shapes()
    t0 = time.perf_counter()
    _, steps_t, m, samples, solver = solve_manhattan(parse_args(
        MANHATTAN_G16_ARGV + ["--limit-steps", str(steps), "--device",
                              str(device)]), **overrides)
    wall = time.perf_counter() - t0
    launches = dict(ar_inverse_kernel.variant_launches)
    shapes = sorted(ar_inverse_kernel.launched_shapes)
    log_manhattan_steps(steps_t)
    rel, fused_s, walk_s = fused_vs_per_clique(solver)
    return {"metrics": m, "steps": steps_t, "launches": launches,
            "launched_shapes": shapes, "fused_vs_walk": rel,
            "fused_s": fused_s, "walk_s": walk_s,
            "cliques": len(solver.physical_bayes_tree.clique_nodes),
            "repairs": list(map(str, solver.mode_repair_log)),
            "finite": all(bool(np.isfinite(x).all())
                          for x in samples.values()),
            "wall_s": wall}


def manhattan_g16_report(r: dict) -> None:
    """The headline prefix's readings from its child, and its gates: the
    runner's accuracy gate, JAX parity, finite samples, the fused pass
    equal to the walk, the specialised kernel launched at
    MANHATTAN_G16_SHAPE."""
    m, steps = r["metrics"], r["steps"]
    at32 = sum(1 for st in steps if any(d == 32 for d, _, _ in st["buckets"]))
    reached = [s for s in r["launched_shapes"] if s[0] == "specialized"
               and tuple(s[2:]) == MANHATTAN_G16_SHAPE]
    parity = MANHATTAN_PARITY_FACTOR * JAX_MANHATTAN_G16_WORST
    walls = [st["s"] for st in steps]
    log(f"manhattan g16 pose_first first {len(steps)} steps, "
        f"ParallelNFiSAM + IncrementalGaussNewtonMAP: {r['wall_s']:.3f} s "
        f"in the child, median step {np.median(walls):.3f} s, floor "
        f"{sum(st['floor_s'] for st in steps):.3f} s in all; ar_inverse "
        f"launches by kernel {r['launches']}; {r['cliques']} cliques; "
        f"steps training at the 32 bucket {at32}; repair events "
        f"{len(r['repairs'])} {r['repairs']}")
    log(f"manhattan g16: {scale_line(m)}; anchored <= "
        f"{MANHATTAN_PARITY_FACTOR} x the JAX package's worst over seeds "
        f"0-2 on the CPU {JAX_MANHATTAN_G16_WORST:.4f} = {parity:.4f}")
    log(f"manhattan g16: fused pass vs per-clique walk on the final state, "
        f"max |diff| {r['fused_vs_walk']:.3e} of the samples' scale; "
        f"posterior_s fused {r['fused_s']} s, per-clique {r['walk_s']} s "
        f"(in turns); launched at {MANHATTAN_G16_SHAPE}: n in "
        f"{sorted({s[1] for s in reached})}")
    if not r["finite"]:
        raise SystemExit("manhattan g16: non-finite samples")
    if not reached:
        raise SystemExit(f"manhattan g16 never launched the specialised "
                         f"kernel at {MANHATTAN_G16_SHAPE}")
    if not r["fused_vs_walk"] <= FUSED_TOL:
        raise SystemExit("manhattan g16: the fused posterior pass "
                         "disagrees with the per-clique walk")
    if not manhattan_gate(m):
        raise SystemExit("manhattan g16 accuracy gate failed")
    if not m["anchored_trans_rmse"] <= parity:
        raise SystemExit("manhattan g16 JAX-parity gate failed")


def _kernel_readings(solver, samples) -> dict:
    """The checks every new child makes on a final state, JSON-able: the
    fused pass against the walk, finite samples, the launches by kernel
    since the last reset."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    launches = dict(ar_inverse_kernel.variant_launches)
    rel, fused_s, walk_s = fused_vs_per_clique(solver)
    return {"launches": launches, "fused_vs_walk": rel, "fused_s": fused_s,
            "walk_s": walk_s, "finite": all(bool(np.isfinite(x).all())
                                            for x in samples.values())}


def _kernel_gates(label: str, r: dict) -> None:
    if not r["finite"]:
        raise SystemExit(f"{label}: non-finite samples")
    if not r["launches"]["specialized"] > 0:
        raise SystemExit(f"{label} never launched the specialised kernel")
    if not r["fused_vs_walk"] <= FUSED_TOL:
        raise SystemExit(f"{label}: the fused posterior pass disagrees with "
                         f"the per-clique walk")


def _child_shapes(readings: dict) -> list:
    from nfisam_tpu_torch.flows import ar_inverse_kernel
    readings["launched_shapes"] = sorted(ar_inverse_kernel.launched_shapes)
    return readings


def plaza_family_readings(device, steps: dict = None, **overrides) -> dict:
    """Each stream of ``PLAZA_FAMILY`` through the plaza runner, cut to
    ``steps[label]`` (default ``PLAZA_FAMILY_STEPS``; ``overrides`` of
    the runner's solver arguments): its result, the port's floor over the
    prefix, the max and RMS posterior-mean error unrounded, each step's
    split, and the kernel readings on its final state (JSON-able)."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    steps = steps or PLAZA_FAMILY_STEPS
    ar_inverse_kernel.clear_shapes()
    streams = {}
    for label, (dataset, defer_da) in PLAZA_FAMILY.items():
        t0 = time.perf_counter()
        result, timings, samples, truth, floor, solver, _ = plaza_prefix(
            dataset, steps[label], device, defer_da, **overrides)
        wall = time.perf_counter() - t0
        worst, rmse = translation_errors(samples, truth)
        log_steps(timings)
        streams[label] = {
            "result": result, "max_err": worst, "trans_rmse": rmse,
            "floor": {k: v for k, v in floor.items() if k != "est"},
            "cliques": len(solver.physical_bayes_tree.clique_nodes),
            "repairs": list(map(str, solver.mode_repair_log)),
            "wall_s": wall, **_kernel_readings(solver, samples)}
    return _child_shapes({"streams": streams, "launches": {
        k: sum(r["launches"][k] for r in streams.values())
        for k in ("specialized", "generic")}})


def plaza_family_report(r: dict) -> None:
    """The plaza-family readings and their gates: the runner's divergence
    rule with the JAX package's floor (JAX_PREFIX_FLOOR_MAX) and its
    resolution rule, and the kernel gates."""
    for label, st in r["streams"].items():
        res, fl = st["result"], st["floor"]
        jax_floor = JAX_PREFIX_FLOOR_MAX[label]
        resolved = res["hypo_final"]["resolved_frac"] \
            if "hypo_final" in res else None
        log(f"{label} first {res['n_steps']} steps (plaza runner, "
            f"ParallelNFiSAM, mode repair on): {st['wall_s']:.1f} s in the "
            f"child, solve_s {res['solve_s']}, median step "
            f"{res['median_step_s']} s; launches {st['launches']}; "
            f"{st['cliques']} cliques; repair events {len(st['repairs'])} "
            f"{st['repairs']}; DA snapshots {res['hypo_curve']}")
        log(f"{label} gate: max posterior-mean translation error "
            f"{st['max_err']:.3f} m, RMSE {st['trans_rmse']:.3f} m (<= "
            f"max({pfr.FLOOR_FACTOR} x the JAX package's floor max "
            f"{jax_floor:.4f}, {pfr.GATE_M}) = "
            f"{max(pfr.FLOOR_FACTOR * jax_floor, pfr.GATE_M):.3f}); the "
            f"port's floor over the prefix: RMSE {fl['rmse']:.4f} m, max "
            f"{fl['max']:.4f} m, {fl['iters']} LM iterations; the JAX "
            f"package on the CPU, seeds 0-2: {JAX_PLAZA_FAMILY.get(label)}")
        log(f"{label}: DA resolution {resolved} (>= {pfr.RESOLUTION_GATE});"
            f" fused pass vs walk {st['fused_vs_walk']:.3e}; posterior_s "
            f"fused {st['fused_s']} s, per-clique {st['walk_s']} s")
        _kernel_gates(label, st)
        reasons = pfr.divergence_reasons(st["max_err"], jax_floor, resolved)
        if reasons:
            raise SystemExit(f"{label} divergence gate failed: "
                             f"{'; '.join(reasons)}")


def random_4x4_readings(device, files=RANDOM_4X4_FILES, limit_steps: int = 0,
                        **overrides) -> dict:
    """The random_4x4 sweep's ``run_seed`` on each of ``files`` (each cut to
    ``limit_steps``, 0: whole; ``overrides`` of its solver arguments), in
    that order: each file's record, its translation RMSE unrounded and the
    kernel readings on its final state (JSON-able)."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    ar_inverse_kernel.clear_shapes()
    out = {}
    for k in files:
        ar_inverse_kernel.reset_launches()
        record, timings, samples, truth, solver = r44.run_seed(
            k, device, limit_steps, **overrides)
        log_steps(timings)
        out[str(k)] = {"record": record,
                       "trans_rmse": translation_errors(samples, truth)[1],
                       **_kernel_readings(solver, samples)}
    return _child_shapes({"files": out, "launches": {
        k: sum(r["launches"][k] for r in out.values())
        for k in ("specialized", "generic")}})


def random_4x4_report(r: dict) -> None:
    """The random_4x4 readings and their gates: each file's RMSE <=
    LAWNMOWER_GATE_FACTOR x the JAX package's CPU worst on that file, and
    the kernel gates."""
    for k, st in r["files"].items():
        rec, bound = st["record"], LAWNMOWER_GATE_FACTOR * \
            JAX_RANDOM_4X4_WORST[int(k)]
        log(f"random_4x4_seed{k} (the sweep's run_seed, {rec['n_steps']} "
            f"steps): {rec['total_s']} s, median step "
            f"{rec['median_step_s']} s; launches {st['launches']}; "
            f"landmark RMSE {rec['landmark_rmse']} m")
        log(f"random_4x4_seed{k} gate: translation RMSE "
            f"{st['trans_rmse']:.4f} m (<= {LAWNMOWER_GATE_FACTOR} x the JAX "
            f"package's worst over seeds 0-2 on the CPU "
            f"{JAX_RANDOM_4X4_WORST[int(k)]:.4f} = {bound:.4f}); fused pass "
            f"vs walk {st['fused_vs_walk']:.3e}")
        _kernel_gates(f"random_4x4_seed{k}", st)
        if not st["trans_rmse"] <= bound:
            raise SystemExit(f"random_4x4_seed{k} gate failed")


def manhattan_plaza_artifacts(batches) -> set:
    """The files the JAX package's ``run_incrementally`` writes into a run
    directory for ``batches``, the plots aside: the parameters and the
    timers, and a step's samples, ordering, split timing, training losses
    and clique dim timing, with its hypothesis weights from the first step
    that brings a mixture factor."""
    files = {"parameters", "step_timing", "step_list",
             "posterior_sampling_timer", "fitting_timer"}
    mixed = False
    for i, (_, fs) in enumerate(batches):
        mixed = mixed or any(hasattr(f, "posterior_weights") for f in fs)
        files |= {f"step{i}{x}" for x in ("", "_ordering", "_split_timing",
                                          "_step_training_loss",
                                          "_dim_time")}
        if mixed:
            files.add(f"step{i}.hypoweights")
    return files


def manhattan_plaza_readings(device, steps: int = MANHATTAN_PLAZA_STEPS,
                             **overrides) -> dict:
    """The manhattan_plaza runner cut to ``steps`` steps (``overrides`` of
    its solver arguments) in a case directory of its own: its result, its
    translation RMSE and both floors unrounded, the run directory's files
    (plots aside), the last step's artifact finite, and the kernel readings
    on the final state (JSON-able)."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    ar_inverse_kernel.clear_shapes()
    ar_inverse_kernel.reset_launches()
    case_dir = tempfile.mkdtemp(prefix="manhattan_plaza_")
    try:
        t0 = time.perf_counter()
        result, rmse, floor, solver = mpr.solve_manhattan_plaza(
            mpr.parse_args(["--limit-steps", str(steps), "--device",
                            str(device)]), case_dir, **overrides)
        wall = time.perf_counter() - t0
        run_dir = result["run_dir"]
        files = sorted(f for f in os.listdir(run_dir)
                       if not f.endswith(".png"))
        last = np.loadtxt(os.path.join(run_dir, f"step{steps - 1}"))
        with open(os.path.join(run_dir, "step_timing")) as fh:
            step_s = [float(t) for t in fh.read().split()]
        readings = {"result": result, "trans_rmse": rmse, "floor": floor,
                    "files": files, "wall_s": wall, "step_s": step_s,
                    "artifact_finite": bool(np.isfinite(last).all()),
                    **_kernel_readings(solver, host_samples(
                        solver._samples))}
    finally:
        shutil.rmtree(case_dir, ignore_errors=True)
    return _child_shapes(readings)


def manhattan_plaza_report(r: dict, steps: int = MANHATTAN_PLAZA_STEPS
                           ) -> None:
    """The manhattan_plaza readings and their gates: the runner's 1.1x rule
    against the floor from the truth over the prefix, JAX parity, the
    artifact set, and the kernel gates."""
    from nfisam_tpu_torch.io import (graph_file_parser,
                                     group_nodes_factors_incrementally)

    res, fl = r["result"], r["floor"]
    nodes, _, factors = graph_file_parser(mpr.DATA)
    expected = manhattan_plaza_artifacts(group_nodes_factors_incrementally(
        nodes, factors, incremental_step=1)[:steps])
    parity = MANHATTAN_PARITY_FACTOR * JAX_MANHATTAN_PLAZA_WORST
    log(f"manhattan_plaza first {res['n_steps']} steps (the run harness, "
        f"ParallelNFiSAM, 500 iterations a fit): {r['wall_s']:.1f} s in the "
        f"child; total_s {res['total_s']}, solve_s {res['solve_s']} (fit "
        f"{res['fit_s']}, posterior {res['posterior_s']}), outside the "
        f"steps {res['outside_solve_s']} s, median step "
        f"{res['median_step_s']} s; launches {r['launches']}; "
        f"{len(r['files'])} artifact files")
    log(f"manhattan_plaza gate: translation RMSE {r['trans_rmse']:.4f} m, "
        f"landmark {res['landmark_rmse']} m; GaussNewtonMAP over the prefix "
        f"from the truth {fl['truth'][0]:.4f} m "
        f"({r['trans_rmse'] / fl['truth'][0]:.4f}x, <= {mpr.FLOOR_GATE}), "
        f"from the best of 512 "
        f"draws {fl['draws'][0]:.4f} m; <= {MANHATTAN_PARITY_FACTOR} x the "
        f"JAX package's worst over seeds 0-2 on the CPU "
        f"{JAX_MANHATTAN_PLAZA_WORST:.4f} = {parity:.4f}; fused pass vs "
        f"walk {r['fused_vs_walk']:.3e}")
    _kernel_gates("manhattan_plaza", r)
    if not r["artifact_finite"]:
        raise SystemExit("manhattan_plaza: non-finite samples in the run "
                         "directory")
    if set(r["files"]) != expected:
        raise SystemExit(f"manhattan_plaza: the run directory holds "
                         f"{sorted(set(r['files']) ^ expected)} against the "
                         f"JAX package's artifact set")
    if not r["trans_rmse"] <= mpr.FLOOR_GATE * fl["truth"][0]:
        raise SystemExit("manhattan_plaza floor gate failed")
    if not r["trans_rmse"] <= parity:
        raise SystemExit("manhattan_plaza JAX-parity gate failed")


def oracle_lawnmower_readings(device, live_points: int = cdr.ORACLE_LIVE,
                              rehearse: bool = False) -> dict:
    """Phase 31: the case1_da runner's oracle (``oracle_weights``, key
    [0, 7], ``live_points`` live points), then the lawnmower_4x4 runner's
    steady pass at ``MANHATTAN_RUN_SEED`` (``run_once``; with
    ``rehearse``, its ``--rehearse`` sizes): the oracle's weights on the true
    associations, its summary and seconds; the pass's record, its
    translation RMSE unrounded, and the kernel readings on its final state
    (JSON-able)."""
    from nfisam_tpu_torch.factors import BinaryFactorMixture
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    ar_inverse_kernel.clear_shapes()
    nodes, _, factors, _ = cdr.load_graph()
    weights, summ, oracle_s = cdr.oracle_weights(nodes, factors, device, 0,
                                                 live_points)
    true_w = {}
    for f in factors:
        if isinstance(f, BinaryFactorMixture):
            obs = str(f.observer_var.name)
            names = [str(v.name) for v in f.observed_vars]
            true_w[obs] = weights[obs][names.index(DA_TRUE[obs])]
    ar_inverse_kernel.reset_launches()
    t0 = time.perf_counter()
    record, samples, solver = mr.run_once(
        f"seed{MANHATTAN_RUN_SEED}",
        mr.parse_args([str(MANHATTAN_RUN_SEED)]
                      + (["--rehearse"] if rehearse else [])), device)
    steady_s = time.perf_counter() - t0
    truth, _ = mr.load_stream()
    return _child_shapes({
        "oracle": {"true_weights": true_w, "weights": weights,
                   "summary": summ, "s": oracle_s},
        "steady": {k: v for k, v in record.items() if k != "step_times"},
        "steady_s": steady_s,
        "trans_rmse": translation_errors(samples, {
            str(v.name): np.asarray(t) for v, t in truth.items()})[1],
        **_kernel_readings(solver, samples)})


def oracle_lawnmower_report(r: dict) -> None:
    """Phase 31's readings and gates: the oracle's logz within max(3.5
    logzerr, 0.35) of the JAX script's CPU mean, its weight on each true
    association >= the JAX CPU worst less 0.05; the steady pass's
    translation RMSE <= 1.25x the JAX script's CPU worst over seeds 1-5;
    the kernel gates."""
    o, st = r["oracle"], r["steady"]
    summ = o["summary"]
    tol = max(LOGZ_ERR_FACTOR * summ["logzerr"], LOGZ_FLOOR)
    log(f"case1_da oracle (dynamic nested sampling, key [0, 7], "
        f"{summ['nlive']} live, {cdr.ORACLE_BATCHES} batches): {o['s']:.1f} "
        f"s, niter {summ['niter']}, ncall {summ['ncall']}, logz "
        f"{summ['logz']:.4f} +- {summ['logzerr']:.4f} (within {tol:.3f} of "
        f"the JAX script's CPU mean {JAX_DA_ORACLE_LOGZ:.4f}); weights "
        f"{o['weights']}")
    failed = not abs(summ["logz"] - JAX_DA_ORACLE_LOGZ) <= tol
    for obs, w in o["true_weights"].items():
        bound = JAX_DA_ORACLE_WORST[obs] - DA_ORACLE_WEIGHT_MARGIN
        log(f"case1_da oracle: {obs}->{DA_TRUE[obs]} weight {w:.4f} (>= "
            f"{bound:.4f}, the JAX CPU worst less {DA_ORACLE_WEIGHT_MARGIN})")
        failed |= not w >= bound
    if failed:
        raise SystemExit("phase 31: the case1_da oracle's gate failed")
    bound = LAWNMOWER_GATE_FACTOR * JAX_MANHATTAN_RUN_WORST
    log(f"manhattan_run steady seed {MANHATTAN_RUN_SEED} ({st['n_steps']} "
        f"steps): {r['steady_s']:.1f} s (total_s {st['total_s']}, surgery "
        f"{st['surgery_s']}, fit {st['fit_s']}, posterior "
        f"{st['posterior_s']}), median step {st['median_step_s']} s, "
        f"posterior_samples_per_sec_per_chip "
        f"{st['posterior_samples_per_sec_per_chip']}, landmark RMSE "
        f"{st['landmark_rmse']} m; launches {r['launches']}")
    log(f"manhattan_run gate: translation RMSE {r['trans_rmse']:.4f} m (<= "
        f"{LAWNMOWER_GATE_FACTOR} x the JAX script's worst over seeds 1-5 "
        f"on the CPU {JAX_MANHATTAN_RUN_WORST} = {bound:.4f}); fused pass vs "
        f"walk {r['fused_vs_walk']:.3e}")
    _kernel_gates("manhattan_run", r)
    if not r["trans_rmse"] <= bound:
        raise SystemExit("phase 31: the manhattan_run gate failed")


def _json_summary(summary: dict) -> dict:
    return {k: v.item() if hasattr(v, "item") else v
            for k, v in summary.items()}


def examples_readings(device, ns_steps: int = NS_REFERENCE_STEPS,
                      ns_live: int = generate_reference_solution.LIVE_POINTS,
                      **overrides) -> dict:
    """Phase 32: each example module's ``run`` at the JAX example's
    configuration (``overrides`` of the solvers' arguments; the NS
    reference cut to ``ns_steps`` at ``ns_live`` live points), in a
    directory of its own: each example's printed lines, its readings
    unrounded, its seconds and, for a solver, the kernel readings on its
    final state (JSON-able)."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    ar_inverse_kernel.clear_shapes()
    out = {}
    tmp = tempfile.mkdtemp(prefix="examples_")

    def timed(label, fn, *args, **kw):
        ar_inverse_kernel.reset_launches()
        t0 = time.perf_counter()
        r = fn(*args, **kw)
        out[label] = {"s": time.perf_counter() - t0, "lines": r["lines"]}
        return r

    try:
        r = timed("eight_pose_circle", eight_pose_circle.run, device,
                  **overrides)
        out["eight_pose_circle"].update(
            trans_err=r["trans_err"], heading_err=r["heading_err"],
            std=r["std"], **_kernel_readings(r["solver"], r["samples"]))
        r = timed("five_node_range_incremental",
                  five_node_range_incremental.run, device, **overrides)
        out["five_node_range_incremental"].update(
            pose_err=r["pose_err"], l1_above=r["l1_above"],
            **_kernel_readings(r["solver"], r["per_step"][-1]))
        r = timed("run_nfisam", run_nfisam.run, device, tmp, **overrides)
        ours, run1 = [], []
        for step in range(len(r["steps"])):
            src = "dyn" if step <= 3 else "ns"
            ref = os.path.join(REF_DIR, f"{src}_step{step}")
            ours.append(compute_mmd.compute(
                os.path.join(r["run_dir"], f"step{step}"), ref)[0])
            run1.append(compute_mmd.compute(
                os.path.join(REF_DIR, f"run1_step{step}"), ref)[0])
        out["run_nfisam"].update(
            mmd=ours, run1_mmd=run1, steps=r["steps"],
            **_kernel_readings(r["solver"],
                               host_samples(r["solver"]._samples)))
        r = timed("generate_reference_solution",
                  generate_reference_solution.run, device, tmp, ns_steps,
                  ns_live)
        name2var = compute_mmd.name_to_var()
        mmds = []
        for step, (samples, order) in enumerate(r["samples"]):
            src = "dyn" if step <= 3 else "ns"
            ref = os.path.join(REF_DIR, f"{src}_step{step}")
            mmds.append(compute_mmd.mmds(
                samples, order, np.loadtxt(ref + ".sample"),
                compute_mmd.read_ordering(ref + "_ordering"), name2var)[0])
        out["generate_reference_solution"].update(
            mmd=mmds, steps=[{**row, "summary": _json_summary(row["summary"])}
                             for row in r["steps"]],
            launches=dict(ar_inverse_kernel.variant_launches))
        r = timed("generate_and_run", gar.run, device, tmp,
                  seed=GENERATE_RUN_SEED, **overrides)
        out["generate_and_run"].update(
            fg_sha256=r["fg_sha256"], trans_rmse=r["trans_rmse"],
            steps=r["steps"], **_kernel_readings(r["solver"], r["samples"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _child_shapes({"examples": out, "launches": {
        k: sum(e["launches"][k] for e in out.values())
        for k in ("specialized", "generic")}})


def examples_report(r: dict) -> None:
    """Phase 32's readings and gates (``EXAMPLE_GATE_FACTOR`` and the JAX
    examples' CPU figures), and the kernel gates of every solver."""
    ex = r["examples"]
    for label, e in ex.items():
        log(f"{label}: {e['s']:.1f} s in the child; launches "
            f"{e['launches']}; it prints:")
        for line in e["lines"]:
            log(f"  {line}")
    e = ex["eight_pose_circle"]
    bound = [EXAMPLE_GATE_FACTOR * w for w in JAX_EIGHT_POSE_WORST]
    worst = (max(e["trans_err"].values()), max(e["heading_err"].values()))
    stds = np.array(list(e["std"].values()))
    log(f"eight_pose_circle gate: worst posterior-mean distance from "
        f"GaussNewtonMAP {worst[0]:.4f} m, heading {worst[1]:.4f} rad (<= "
        f"{EXAMPLE_GATE_FACTOR} x the JAX example's worst over seeds 0-2 on "
        f"the CPU {JAX_EIGHT_POSE_WORST} = {bound[0]:.4f} m, {bound[1]:.4f} "
        f"rad); by pose {e['trans_err']}; stds in [{stds.min():.4f}, "
        f"{stds.max():.4f}]; fused pass vs walk {e['fused_vs_walk']:.3e}")
    _kernel_gates("eight_pose_circle", e)
    if not (worst[0] <= bound[0] and worst[1] <= bound[1]):
        raise SystemExit("eight_pose_circle: a posterior mean is off the "
                         "MAP")
    if not (np.isfinite(stds).all() and (stds > 0).all()):
        raise SystemExit("eight_pose_circle: a std is not finite and > 0")
    e = ex["five_node_range_incremental"]
    _kernel_gates("five_node_range_incremental", e)
    for step, errs in enumerate(e["pose_err"]):
        bound = EXAMPLE_GATE_FACTOR * JAX_FIVE_NODE_WORST[step]
        log(f"five_node_range_incremental gate, step {step}: worst pose "
            f"distance from the step's GaussNewtonMAP "
            f"{max(errs.values()):.4f} m (<= {EXAMPLE_GATE_FACTOR} x the JAX "
            f"example's worst {JAX_FIVE_NODE_WORST[step]:.4f} = "
            f"{bound:.4f}); {errs}")
        if not max(errs.values()) <= bound:
            raise SystemExit(f"five_node_range_incremental step {step}: a "
                             f"pose mean is off the MAP")
    lo = JAX_FIVE_NODE_L1_SIDES[0] - FIVE_NODE_BAND_MARGIN
    hi = JAX_FIVE_NODE_L1_SIDES[1] + FIVE_NODE_BAND_MARGIN
    sides = (e["l1_above"], 1.0 - e["l1_above"])
    log(f"five_node_range_incremental gate: L1's share above and below the "
        f"x-axis at step 3 {sides[0]:.4f} / {sides[1]:.4f} (in [{lo:.4f}, "
        f"{hi:.4f}], the JAX band {JAX_FIVE_NODE_L1_SIDES} widened by "
        f"{FIVE_NODE_BAND_MARGIN}); fused pass vs walk "
        f"{e['fused_vs_walk']:.3e}")
    if not all(lo <= x <= hi for x in sides):
        raise SystemExit("five_node_range_incremental: L1's modes are off "
                         "the JAX band")
    e = ex["run_nfisam"]
    ours, run1 = float(np.mean(e["mmd"])), float(np.mean(e["run1_mmd"]))
    log(f"run_nfisam: steps {[round(st['s'], 3) for st in e['steps']]} s; "
        f"cliques trained {[st['trained'] for st in e['steps']]}")
    log(f"run_nfisam gate (compute_mmd): mean joint MMD over steps 0-"
        f"{len(e['mmd']) - 1} {ours:.4f} (<= {MMD_GATE_FACTOR} x the "
        f"reference run1's {run1:.4f} = {MMD_GATE_FACTOR * run1:.4f}); per "
        f"step {[round(x, 4) for x in e['mmd']]}; fused pass vs walk "
        f"{e['fused_vs_walk']:.3e}")
    _kernel_gates("run_nfisam", e)
    if not ours <= MMD_GATE_FACTOR * run1:
        raise SystemExit("run_nfisam: the MMD gate failed")
    e = ex["generate_reference_solution"]
    for step, (x, row) in enumerate(zip(e["mmd"], e["steps"])):
        bound = EXAMPLE_GATE_FACTOR * JAX_NS_REFERENCE_MMD[step]
        log(f"generate_reference_solution gate, step {step}: {row['s']:.1f}"
            f" s, {row['n']} samples, {row['summary']}; joint MMD to "
            f"data/case1_ref {x:.4f} (<= {EXAMPLE_GATE_FACTOR} x the JAX "
            f"example's worst {JAX_NS_REFERENCE_MMD[step]:.4f} = "
            f"{bound:.4f})")
        if not x <= bound:
            raise SystemExit(f"generate_reference_solution step {step}: "
                             f"the MMD gate failed")
    e = ex["generate_and_run"]
    bound = LAWNMOWER_GATE_FACTOR * JAX_GENERATE_RUN_WORST
    log(f"generate_and_run gate: factor_graph.fg sha256 {e['fg_sha256']} "
        f"(the JAX example's {JAX_GENERATE_FG_SHA256}); translation RMSE "
        f"{e['trans_rmse']:.4f} m (<= {LAWNMOWER_GATE_FACTOR} x the JAX "
        f"example's worst over solver seeds 0-2 on the CPU "
        f"{JAX_GENERATE_RUN_WORST:.4f} = {bound:.4f}); steps "
        f"{[round(st['s'], 3) for st in e['steps']]} s; fused pass vs walk "
        f"{e['fused_vs_walk']:.3e}")
    _kernel_gates("generate_and_run", e)
    if e["fg_sha256"] != JAX_GENERATE_FG_SHA256:
        raise SystemExit("generate_and_run: factor_graph.fg is not the JAX "
                         "example's")
    if not e["trans_rmse"] <= bound:
        raise SystemExit("generate_and_run: the RMSE gate failed")


def runner_child(readings_fn, result: str) -> int:
    """A runner's phase (27-32) as a child process: the kernels built,
    then ``readings_fn(device)``'s readings and its seconds to
    ``result``."""
    from nfisam_tpu_torch.utils.cuda_build import build_all_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all_kernels()
    t0 = time.perf_counter()
    readings = readings_fn(torch.device("cuda"))
    readings["child_s"] = time.perf_counter() - t0
    with open(result, "w") as fh:
        json.dump(readings, fh)
    return 0


# the runners' phases in child processes: --child name -> (label,
# readings, report)
RUNNER_CHILDREN = {
    "manhattan_g16": ("manhattan g16 pose_first", manhattan_g16_readings,
                      manhattan_g16_report),
    "plaza_family": ("phase 28 plaza family", plaza_family_readings,
                     plaza_family_report),
    "random_4x4": ("phase 29 random_4x4", random_4x4_readings,
                   random_4x4_report),
    "manhattan_plaza": ("phase 30 manhattan_plaza", manhattan_plaza_readings,
                        manhattan_plaza_report),
    "oracle_lawnmower": ("phase 31 oracle and lawnmower",
                         oracle_lawnmower_readings, oracle_lawnmower_report),
    "examples": ("phase 32 examples", examples_readings, examples_report),
}


def stop_children(children: list) -> None:
    """Kill every child still running, with the processes it started."""
    for child in children:
        if child["proc"].poll() is None:
            os.killpg(child["proc"].pid, signal.SIGKILL)
            child["proc"].wait()


def report_children(children: list) -> int:
    """Join the children, print their readings and fail on any gate: the
    dry runs gate themselves (a launch in every rank included); plaza1_
    ada0.2's fused pass and the runners' phases' gates (27-32) are held
    here, and those children's launched shapes join ``CHILD_SHAPES`` for
    ``check_launched_shapes``.  Returns the runners' phases' launches of
    the specialised kernel (0 if none was among the children)."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    reports = {label: report for label, _, report in
               RUNNER_CHILDREN.values()}
    runner_launches = 0
    for child in children:
        r = join_child(child)
        label = child["label"]
        if label in reports:
            reports[label](r)
            runner_launches += r["launches"]["specialized"]
            CHILD_SHAPES.update(tuple(s) for s in r["launched_shapes"])
            if "child_s" in r:
                log(f"{label}: {r['child_s']:.1f} s of the phase in the "
                    f"child")
        elif label == "plaza1_ada0.2":
            log(f"plaza1_ada0.2: fused pass vs per-clique walk on the final "
                f"state, max |diff| {r['fused_vs_walk']:.3e} of the samples' "
                f"scale; posterior_s fused {r['fused_s']} s, per-clique "
                f"{r['walk_s']} s (in turns); {r['launches']} launches; "
                f"{r['wall_s']:.1f} s in the child")
            if not r["fused_vs_walk"] <= FUSED_TOL:
                raise SystemExit("plaza1_ada0.2: the fused posterior pass "
                                 "disagrees with the per-clique walk")
            CHILD_SHAPES.update(tuple(s) for s in r["launched_shapes"])
        else:
            launches = r["launches"]
            log(f"{label}: ar_inverse launches by process {launches}; "
                f"{r['wall_s']:.1f} s")
    return runner_launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one solve with torch.profiler")
    parser.add_argument("--child", choices=["plaza_ada"] +
                        list(RUNNER_CHILDREN),
                        help="run one phase as a child of the main run")
    parser.add_argument("--result", help="a child's gate readings (JSON)")
    opts = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    if opts.child == "plaza_ada":
        return plaza_ada_child(opts.result)
    if opts.child:
        return runner_child(RUNNER_CHILDREN[opts.child][1], opts.result)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    cpu_count, usable, compute_mode = host_readings()
    log(f"os.cpu_count() {cpu_count}")
    log(f"len(os.sched_getaffinity(0)) {usable}")
    log(f"compute mode {compute_mode}")
    side_by_side = usable >= PARALLEL_MIN_CORES and compute_mode == "Default"
    log(f"plaza1_ada0.2 and phases 25-32: "
        f"{'side by side, in child processes' if side_by_side else 'one after another'}"
        f" (needs >= {PARALLEL_MIN_CORES} usable cores and the Default "
        f"compute mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    from nfisam_tpu_torch.utils.cuda_build import build_all_kernels

    build_s, built = build_all_kernels()
    log(f"build: {len(built)} kernel source(s) in {build_s:.1f} s")
    build_report()

    entries = check_ar_inverse(device)
    grad_rel = check_unif_gradient(device)
    log(f"unif gradient: worst {grad_rel:.3e} of the largest entry (<= "
        f"{GRAD_RTOL})")
    check_generator_seed(device)
    log_elapsed(t_start)
    from nfisam_tpu_torch.flows import ar_inverse_kernel
    ar_inverse_kernel.clear_shapes()
    # the kernels were timed above, alone on the card; from here on child
    # processes may share it
    child_tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    children, starter = start_children(
        child_phases(True) if side_by_side else [], child_tmp, MAX_CHILDREN)
    try:
        return run_phases(opts, device, kind, smi, entries, children,
                          starter, child_tmp, side_by_side, t_start)
    finally:
        starter.stop.set()
        starter.join()
        stop_children(children)
        shutil.rmtree(child_tmp, ignore_errors=True)


def run_phases(opts, device, kind, smi, entries, children, starter,
               child_tmp, side_by_side, t_start) -> int:
    """The main path's phases, the children joined (``starter`` has
    started them all once it has ended), the checks on the final states
    and the result lines."""
    from nfisam_tpu_torch.io import graph_file_parser

    nodes, _, _ = graph_file_parser(CASE1_FG)
    name2dim = {str(v.name): v.dim for v in nodes}
    _, seq_solver = case1_phase(device, False, name2dim)

    from nfisam_tpu_torch.flows import stack_inverse_masked_cuda
    res_k, res_p, checked = roundtrip_residuals(seq_solver,
                                                stack_inverse_masked_cuda)
    log(f"roundtrip residual on {checked} trained cliques: kernel "
        f"{res_k:.3e}, plain {res_p:.3e}")
    if checked == 0 or not res_k <= max(4.0 * res_p, 1e-3):
        raise SystemExit("roundtrip residual gate failed")

    launches, par_solver = case1_phase(device, True, name2dim)
    log_elapsed(t_start)
    plaza_solver = plaza_phase(device)
    log_elapsed(t_start)
    robot_solvers = robots_phase(device)
    log_elapsed(t_start)
    repair_solvers = repair_phase(device)
    log_elapsed(t_start)
    separator_solvers = separator_repair_phase(device)
    log_elapsed(t_start)
    da_solvers = case1_da_phase(device)
    log_elapsed(t_start)
    plaza_ada_solver = None if side_by_side else plaza_ada_phase(device)
    log_elapsed(t_start)
    map_floor_phase(device)
    log_elapsed(t_start)
    manhattan_solver = manhattan_phase(device)
    log_elapsed(t_start)
    eight_node_solver = eight_node_phase(device)
    log_elapsed(t_start)
    restored_solver = case1_jax_checkpoint_phase(device, name2dim)
    log_elapsed(t_start)
    entries[0]["launches"] = lawnmower_phase(device)
    log_elapsed(t_start)
    reference_nested_phase(device)
    log_elapsed(t_start)
    nuts_smc_phase(device)
    log_elapsed(t_start)
    nested_solver, _ = nested_clique_phase(device)
    log_elapsed(t_start)
    entries[1]["launches"] = options_phase(device, name2dim)
    log_elapsed(t_start)
    r2_odometry_phase(device)
    log_elapsed(t_start)
    if side_by_side:
        starter.join()
        entries[0]["launches"] += report_children(children)
    else:
        for label, argv in child_phases(False):
            children.append(start_child(label, argv, child_tmp))
            entries[0]["launches"] += report_children(children[-1:])
    log_elapsed(t_start)

    finals = [("case1 NFiSAM", seq_solver),
              ("case1 ParallelNFiSAM", par_solver),
              ("plaza1 ParallelNFiSAM", plaza_solver),
              ("robots ParallelNFiSAM", robot_solvers[0]),
              ("robots NFiSAM", robot_solvers[1])]
    finals += [(f"mode-repair graph seed {seed}", solver)
               for seed, solver in zip(REPAIR_SEEDS, repair_solvers)]
    finals += separator_solvers
    finals += [(f"case1_da seed {seed}", solver)
               for seed, solver in zip(DA_SEEDS, da_solvers)]
    if plaza_ada_solver is not None:
        finals.append(("plaza1_ada0.2", plaza_ada_solver))
    finals.append(("manhattan g8", manhattan_solver))
    finals.append(("eight-node chain", eight_node_solver))
    finals.append(("case1 from the JAX store", restored_solver))
    finals.append(("case1 nested clique sampling", nested_solver))
    for label, solver in finals:
        rel, fused_s, walk_s = fused_vs_per_clique(solver)
        log(f"{label}: fused pass vs per-clique walk on the final state, "
            f"max |diff| {rel:.3e} of the samples' scale; posterior_s "
            f"fused {fused_s} s, per-clique {walk_s} s (in turns)")
        if not rel <= FUSED_TOL:
            raise SystemExit(f"{label}: the fused posterior pass disagrees "
                             f"with the per-clique walk ({rel:.3e})")
    check_launched_shapes(device)
    if opts.profile:
        profile_solve(device)
    log(f"every phase passed in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
