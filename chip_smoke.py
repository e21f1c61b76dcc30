#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpcgpu_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--phase 15]

From the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit:

1. prints the card's name and power limit (nvidia-smi) and the versions;
2. builds the hand-written kernels (csrc/*.cu, one nvcc per source, all at
   once, sm_90a) twice, for the 7-joint IIWA and for two joints (the
   sources of K1-K5, -DMPC_NJ=2), every source of both at once, and prints
   the build time and ptxas' register / spill report, with the registers,
   stack and spills of K1, K2 (at each group size), K3's three kernels and
   the megakernels that run K3's stage bodies and K2's merit contribution
   (K5, K5g, K9p, K9pg, K9b, K10) picked out, and those of the two-joint
   build's K1-K5; a spill, or K5 or K9p past MEGA_MAX_REGS registers,
   fails the run;
3. checks each kernel K1-K7, K7s, K9p, K9b and K10 against its plain
   PyTorch version on the card at the slice's N = 64 inputs from fixture
   0_0 (K6 and K7 also on a seeded well-conditioned system, K7s also at
   N = 128, 256 and 1024 with its library yardstick at 128 and 256, K2
   also at N = 2, 256 and 1024 on seeded steps and
   twice on the same inputs (bit-equal), K5, K9p and K10 also at larger
   carried rhos where their CGs exit before the cap, K10 with two arms
   from seeded perturbations and its shared CG exit shown to decide, four K9p
   launches against one K5 launch (bit-equal), the split BCR paths against
   K7 and K6), and the arm-batched K1 launch against single K1 launches
   (bit-equal), with the tolerances of the JAX package's own kernel tests
   (the exact BCR solves by relative residual on the slice's systems), and
   times both (CUDA events, median after warm-up), K1's, K2's and K3's
   device times (torch.profiler) beside the one-thread recursions'; the
   first launches of the cluster forms (K5, K9p, K6, K7, K7s, K9b, and
   K10 at every cluster size the card admits for two arms at N = 64, and
   in its one-block form, and K4 and K4b in their cluster form) run under
   a watchdog that ends the process if they hang;
4. runs three closed loops -- fixture pair 0_0, N = 64,
   SolverConfig.for_knots(64, sqp_max_iter=4), PCG cap 40, exit tol
   5e-5, lam warm-started by 5 solves at tol 1e-11, simulate_mpc_scan for
   16 control updates -- each once through the kernels and once through
   the plain modules:
   - the staged pcg loop (K3, K4 -- the plan's form at N = 64, the
     cluster form --, K2, K1 per update);
   - the bench's default, linsys="auto" with megakernel and
     megakernel_solve (K2, K5, K1 per update), timed: CUDA-event update
     median, host clock per update, device time by kernel
     (torch.profiler);
   - the same with the failover forced (both thresholds -1, the latch
     read every 8 updates): K5 for 8 updates, then K3, K6, K2 per SQP
     iteration, timed as the default;
   and checks tracking errors, their agreement, SQP iterations, rho
   bails, failed_over and each run's kernel launch counts (set to 0 just
   before the run, read just after);
5. runs the multi-arm loops from the same warm duals, two arms from
   seeded start perturbations: simulate_mpc_scan_packed for 16 updates
   through the kernels (K10 and the arm-batched K1, one launch each per
   update) and through the plain modules, checked and timed as the auto
   loop; simulate_mpc_scan_batched (plain modules, no kernel) for 8
   updates; and the packed loop's arm-updates/s over B = 1, 2, 4, 8, 16
   arms with K10's device time per call;
6. runs the remaining sqp_solve configurations' loops, 8 updates each,
   through the kernels and the plain modules: the staged bcr loop (K3,
   K7, K2; K1) at N = 64 and at N = 128 (one K7 an SQP iteration), and
   at N = 128 again with bcr_dz's split path forced (two K7s launches an
   SQP iteration, the residual as tensor glue, as past K7's fit), the
   per-iteration megakernel loops (K2, then K9p or K9b per SQP
   iteration; K1), the pcg_pallas backend (plain stages and K4b, the
   cluster form), and the
   dense and qdldl oracles against each other;
7. prints the linear-solve comparison (the reference's TIME_LINSYS) on
   the slice's warm system: each backend's time per solve, CG iterations
   and relative residual;
8. runs the long horizons (N = 128-1024, fixture 0_0's rows repeated past
   its 666 by np.resize, for_knots(N), PCG cap
   PCGConfig.tpu_tuned_max_iter(N), exit tol default_pcg_exit_tols(N)[0]):
   prints the fits and the kernels' grids at N = 64-1024; checks K3 at
   N = 2 and at N = 256, 512 and 1024 (it serves the TPU's tiled K8); K4
   and K4b in both forms -- the cluster form (K4, K4b) where it fits and
   the joined form (K4g, K4bg) -- at N = 2, 3, 7, 64, 128, 256, 512 and
   1024 against the plain CG (and at N = 256 on the seeded random system,
   where the CG exits early), their first launches under the watchdog,
   printing each form's plan (C, G, place, grid) and a CG step's device
   time per form and N (a solve less the same solve with the CG capped at
   0, over its steps), and K4 and K4g bit for bit against K9p's and K9pg's
   dual solve on the card's K3 system; the cluster K6 at N = 128-512 (the former
   K6l's horizons), K5g (its CG joined across every co-resident cluster)
   at N = 64-512 beside the cluster K5 on the same inputs and at N = 657,
   1000 and 1024, at its plan's cluster size and every other one the card
   admits (its first launches under the watchdog), at rho 1e-3 and at
   rhos where CGs exit before the cap, K9pg at N = 256 and 1024 (four
   launches bit-equal to one K5g launch), each against its plain version
   and timed; and runs 8-update loops through
   the kernels and the plain modules, warm duals, checked and timed as in
   4: auto at N = 128, 256 and 512 (K2, K5, K1) and at N = 1024, past the
   cluster form's fit (K2, K5g, K1), and at N = 256 staged pcg (K3, K4,
   K2), the forced failover (K5 for 4 updates, then K3, K6, K2), the
   per-iteration megakernel (K2, K9p; at N = 1024 K9pg) and pcg_pallas
   (the plain stages and K4b), and at N = 512, past the cut of K4's plan,
   staged pcg (K3, K4g, K2) and pcg_pallas (the plain stages and K4bg);
9. runs the sharded paths, the JAX package's dryrun_multichip legs on one
   card (8 in-process shards, mpcgpu_tpu_torch/parallel): K11 (the
   banded SpMV over every local shard in one launch, with the halo rows
   outside them) against its plain version and bit for bit against one
   launch per shard, on the 8 shards of fixture 0_0's N = 512 Schur
   system and on random bands with nonzero outer halos, timed beside a
   torch.sparse BSR product of the whole system; the sharded CG with K11
   (pcg_sharded_cuda) and with the plain SpMV (pcg_sharded) against K4bg
   and the plain CG at N = 512, to convergence on the seeded random
   system and at the cap on 0_0's, timed and profiled; sharded_sqp_solve
   at N = 512 (sqp_max_iter 4, cap 16) whole, explicit and fused against
   the single-device sqp_solve; the knot-sharded closed loop at N = 512
   (sqp_max_iter 2, cap 8, K11's CG) against the single-device loop; 8
   arms over 8 groups against simulate_mpc_scan_batched; 2 groups of 2
   packed arms (K10, K1) against the unsharded packed loops; and the
   torch.distributed form, 2 gloo ranks with CUDA tensors
   (tests/torch_ranks.py), bit-equal to the in-process mesh of 2 shards;
10. the cluster forms (K5 and K9p's stair-PCG, K6's BCR-PCG across one
   thread-block cluster): prints each form's cluster size as the plan
   chooses it and as the kernel reads it (%cluster_nctarank), ptxas'
   registers and shared memory, the grid and where the stair bands go;
   checks K5 at N = 2, 4, 64, 128, 256 and 512 and K6 at every power of 2
   up to 512, at every cluster size the card admits, against the plain
   versions (CG counts, accepts and bails identical), and K6's factor
   against K7's cluster factor, bit for bit; and
   times a CG step (the profiler's device
   time of a solve less that of the same solve with the CG capped at 0,
   over its CG steps) and the stages at N = 64-512 for the cluster K5
   (stair bands on chip and in L2; the one-thread recursions' beside
   them) beside K5g, and K5g's at N = 1024 with its plan, and for K6
   (the solve less the solve with the CG capped at 0) at N = 64-512;
11. K10's forms (each arm's CG across a thread-block cluster of its own,
   the exit shared through tagged words; the one-block form past that
   fit): prints ptxas' lines of both kernels and the plan (form, C, stair
   placement, grid) for each (N, B) checked; checks the cluster form
   against the plain version at B = 2 for N = 2 and 5 at rhos 0.1, 0.3,
   for N = 64, 128 and 256 at rhos 0.3, 0.1 (at N = 128 and 256 at exit
   tol 1e-4: the CGs exit before the cap, the shared CG count decides)
   and at rho 1e-3 (every CG at the cap), as for the largest N its fit
   admits, at N = 7 beside the one-block form and C = 2, each holding
   lam to the float64 plain version, and at B = 1 and 16 at N = 64, the
   one-block form at
   the first pack past the cluster fit at N = 16 (every arm from one
   start: they come out bit-equal), and two launches on the
   same inputs (bit-equal); times K10 (device time a call, and a CG step
   as in 10, beside K5's at the same N: the shared exit's part) at B = 2,
   N = 64, 128, 256 and the one-block form at N = 64; and runs the packed
   two-arm loop at N = 128 (cap 24, tol 1e-5, warm duals, 8 updates)
   through the kernels and the plain modules, checked (sqp_iters, bails
   and shared CG counts equal, tracking within 5e-3 m) and timed;
12. the cluster BCR forms (K7 and K7s one cluster, K9b's refined BCR
   solve and dz across the first cluster of its launch): prints their
   ptxas lines, fits and K9b's plan (C, grid) at each N; checks K7 at
   N = 2, 4, 64, 128, 256, 512 and 1024 at every cluster size the card
   admits against the plain version (tight on the seeded system, by
   residual on fixture 0_0's), its factor bit-equal to K7s's, and the
   forced split path against it at N = 64 and 128; K7s at N = 2, 64, 128,
   256 and 1024 likewise (its factor bit-equal to K7's), and K9b at N = 2,
   4, 64, 256 and 512 against the plain iteration (first launches under
   the watchdog; no kernel on the card runs the one-block factor, which
   tests/test_torch_csrc_host.py holds the cluster forms to); and prints
   their device times a launch (K7 at N = 64-1024 beside the split path
   at 128, K7s at N = 128 and 256, K9b at 64, 256 and 512);
13. the real-time host loop (sim.simulate_mpc, the plant run for each
   solve's wall time on the host clock around a device sync): fixture
   0_0 at N = 32 (the flagship driver's default) and 64 with the
   whole-solve kernel (K2, K5, K1 an update), warm-up solves at a CG
   cap of 10000, RT_TIMESTEPS timesteps (several hundred updates),
   printing the solve time's p50, p95 and max, the share over the 2000
   us budget, the
   updates past the rollout's 2.2 ms window, the tracking errors, SQP
   iterations and the CG cap-exit rate beside the card's name and power
   limit; the host loop at the constant period against simulate_mpc_scan
   (sqp_iters and bails equal, tracking errors within 1e-3 m); auto on
   pair 1_0 (its end-effector trace by forward kinematics, the default
   thresholds, 512 updates) with the update it failed over at beside the
   JAX record; the fine-grained mode at N = 32 with pcg_pallas (the plain
   phases, K4b) and each phase's device time; sqp_solve_timeboxed in a
   2000 us box (K2, then K9p an iteration) against
   calibrated_iteration_budget of the measured iteration time; and the
   flagship driver examples/track_iiwa_pcg_torch.py in-process, its
   .result files checked; every run's launch counts checked;
14. the second robot: the planar 2R arm (models/planar2r.py; nq = 2, nx =
   4) with its synthesized fixture (utils/synth.py: q0 = [0.4, 0.6],
   amplitude 0.35, dt 0.05, 4 N rows), qd_cost 1e-3, r_cost 1e-4, 3 SQP
   iterations, CG cap 30, exit tol 1e-6, at N = 16 (the JAX hardware
   gate's) and 64: K3, K4, K2, K1 and K5 of the two-joint build, each
   against its plain version (first launches under the watchdog) at
   scripts/tpu_kernel_regression.py:520-553's tolerances (K3's bands and
   stair within 1e-4 of their largest entry, gamma 1e-3; sqp_solve staged
   within 1e-2 of plain, the whole solve within 1e-3 of staged in X and
   1e-2 in lam, equal SQP iterations and accepts), each one's device us a
   call; then 6-update closed loops from cold duals, staged (K3, K4, K2;
   K1) and the whole solve (K2, K5; K1), each beside the plain loop (mean
   tracking error under 0.1 m, SQP iterations and bails equal), their
   launches per update; the kernels line gets K1-K5 at nq = 2 (N = 64,
   N = 16 beside it, launches from the N = 64 loops);
15. the solver knobs (`knob_phase`; tests/torch_systems.py KNOB_CASES:
   joint tracking with q_cost 2, the Gauss-Newton Hessian, semi-implicit
   Euler and the angle wrap, each alone, and joint + semi-implicit + wrap
   and eepos + Gauss-Newton + semi-implicit + wrap): K3 and K2 under each
   case against their plain versions at N = 64 (the slice's perturbed
   start; under the wrap joints 0 and 3 within 0.03 of +-3.14159, where
   the wrap changes the defects), first launches under the watchdog, at
   the default checks' tolerances (K3 rtol, atol 3e-3; K2 2e-4), K3 held
   to the float64 plain version where the end-effector position block is
   near singular (the Gauss-Newton Hessian; eepos under the wrap cases'
   moved joints: torch_systems.within_twice_plain, entry by entry);
   K2's, K3's and K5's device us a call under each combination beside the
   default's; one SQP iteration of K5, K9p, K9b and K10 (two arms) under
   both combinations at N = 64 against their plain versions (decisions
   and CG counts equal; X, U, lam against the float64 plain version by
   within_twice_plain; K9b at rho 0.1, its duals within three times the
   float64 solve's residual, its X, U and merit against the plain
   iteration given its duals); 8-update closed loops from cold duals under both combinations
   -- the whole solve (K2, K5), staged pcg (K3, K4, K2), the per-iteration
   pcg and bcr kernels (K9p, K9b) and the packed two-arm loop (K10), each
   with K1 -- each beside the plain loop of its linsys (SQP iterations and
   bails equal; the CG routes' plant path within KNOB_PATH_TOL; the bcr
   loop's path held to the plain bcr loop run in float64 by
   within_twice_plain), their launches checked; K5g and K9pg at N = 1024
   under the first combination, one SQP iteration against the plain
   version with the float64 one as the yardstick; the kernels line gets
   each knob kernel's checks, device us and launches.  Every check of the
   phase runs before it fails; `python3 chip_smoke.py --phase 15` runs it
   alone after building the IIWA library;
16. prints one JSON line of the kernels (with each one's launches on
   phase 13's paths, and phase 14's for the nq = 2 forms), then the
   result line.

A watchdog (faulthandler) ends the process with a traceback and a
non-zero exit code if the run passes SCRIPT_DEADLINE seconds, and sooner
if a cluster form's first launches hang.

Any failed build, launch or check ends the run with a non-zero exit code
before the result line.  Without CUDA it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import faulthandler
import functools
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
import unittest.mock
from pathlib import Path
from typing import NamedTuple

N_KNOTS = 64
N_UPDATES = 16
SQP_ITERS = 4
WARM_SOLVES = 5
REPS = 20
ARMS = 2                        # the packed loop's pack (bench.py --batch 2)
BATCHED_UPDATES = 8
SWEEP_ARMS = (1, 2, 4, 8, 16)
NEW_UPDATES = 8                 # the loops of this file's phase 6
LONG_KNOTS = 128                # the staged bcr loop past N = 64
# K7s against its plain version past N = 64 (phase 3), its library
# yardstick where the staged bcr loops launch it
K7S_KNOTS = (128, 256, 1024)
K7S_LIBRARY_KNOTS = (128, 256)
# phase 12, the cluster BCR forms: K7, K7s and K9b at every admitted
# cluster size, K7's and K9b's device times at the horizons named, and
# the forced split path against K7
K7_KNOTS = (2, 4, 64, 128, 256, 512, 1024)
K7_TIMED_KNOTS = (64, 128, 256, 1024)
K7_SPLIT_KNOTS = (128,)         # and N = 64 in phase 3
K7S_CLUSTER_KNOTS = (2, 64, 128, 256, 1024)
K9B_KNOTS = (2, 4, 64, 256, 512, 1024)
K9B_TIMED_KNOTS = (64, 256, 512, 1024)
# phase 8, the long horizons: K3 (K8's counterpart), the grid-CG kernels
# and the loops
LONG_K3_KNOTS = (256, 512, 1024)
LONG_CG_KNOTS = (64, 128, 256, 512, 1024)
# K4 and K4b in both forms (the cluster form where it fits, the joined
# form K4g, K4bg), and a CG step's device time per form at these
K4_KNOTS = (2, 3, 7, 32, 64, 128, 256, 512, 1024)
K4_STEP_KNOTS = (64, 128, 256, 512, 1024)
LONG_MEGA_KNOTS = (64, 128, 256, 512)
# K5g's own horizons, past K5's cluster fit: just past it, an uneven cut
# of the knots over the blocks, and the auto loop's
JOINED_KNOTS = (657, 1000, 1024)
LONG_BCR_KNOTS = (128, 256, 512)  # K6 past N = 64, the former K6l's horizons
LONG_AUTO_KNOTS = (128, 256, 512)
LONG_LOOP_KNOT = 256            # the staged, failover and per-iteration loops
GRID_LOOP_KNOT = 1024           # past the cluster form's fit: K5g, K9pg
KNOB_PATH_TOL = 5e-11           # phase 15: a CG route's knob loop's plant
                                # path against the plain loop's (rad, rad/s;
                                # 1.09e-11 at most on the H100)
JOINED_LOOP_KNOT = 512          # past K4's cut: K4g, K4bg in the loops
LONG_UPDATES = 8                # the first horizon shift is at update 7
# phase 9, the sharded paths (__graft_entry__.dryrun_multichip's legs)
SHARD_KNOTS, SHARDS = 512, 8    # 64 knots a shard
SHARD_SQP_ITERS = 4             # the at-scale solve (cap tpu_tuned(512) = 16)
SHARD_LOOP_ITERS, SHARD_LOOP_CAP = 2, 8
SHARD_UPDATES = 3
ARMS_KNOTS, ARMS_GROUPS, ARMS_UPDATES = 8, 8, 2
PACKED_GROUPS, PACKED_ARMS, PACKED_UPDATES = 2, 2, 2
GLOO_RANKS = 2
# phase 10, the cluster forms
CLUSTER_KNOTS = (2, 4, 32, 64, 128, 256, 512)
CLUSTER_BCR_KNOTS = (2, 4, 8, 16, 32, 64, 128, 256, 512)
CLUSTER_STEP_KNOTS = (64, 128, 256, 512, 1024)   # 1024: K5g alone
# phase 11, K10's forms: the cluster form at two arms (and the largest N
# its fit admits), the packs at N = 64, the horizons timed; at N = 7 the
# cluster form beside the one-block form and C = 2, each holding lam to
# the float64 plain version
K10_KNOTS = (2, 5, 64, 128, 256)
K10_F64_KNOT = 7
# the exit tolerance of the count check at rhos 0.3, 0.1 where the
# horizon's own (1e-5) runs every CG to the cap: at 1e-4 the CGs of SQP
# iterations 1 and 4 (N = 128) and 4 (N = 256) exit before it, every
# exit's eta 4-14% off the tolerance (tools/packed_exit_probe.py)
K10_EARLY_TOL = {128: 1e-4, 256: 1e-4}
K10_ARMS = (1, 16)
K10_STEP_KNOTS = (64, 128, 256)
K10_LOOP_KNOT = 128
SCRIPT_DEADLINE = 1150          # s; the run's limit is 1200
# phase 14, the second robot: the planar 2R arm (models/planar2r.py, nq =
# 2) with the synthesized fixture and the solver of the JAX hardware gate
# (scripts/tpu_kernel_regression.py:481-556): 4 N rows, 3 SQP iterations,
# CG cap 30, exit tol 1e-6, at its N = 16 and the main path's N = 64
NQ2 = 2
NQ2_KNOTS = (16, 64)
NQ2_Q0, NQ2_AMPLITUDE, NQ2_DT = (0.4, 0.6), 0.35, 0.05
NQ2_QD_COST, NQ2_R_COST = 1e-3, 1e-4
NQ2_SQP_ITERS, NQ2_CAP, NQ2_TOL = 3, 30, 1e-6
NQ2_UPDATES = 6
# the kernels of the two-joint build whose ptxas lines phase 2 prints
NQ2_PTXAS = ("K1", "K2 G = 8", "K2 G = 16", "K2 G = 32", "K3 stage 1",
             "K3 stage 2", "K3 stage 3", "K4", "K4g", "K5", "K5g")
# phase 13, the real-time host loop (sim.simulate_mpc): fixture 0_0 at
# the flagship driver's default N = 32 and at N = 64,
# const_update_freq=False, the whole-solve kernel, RT_WARMUP warm-up
# solves (each CG capped at 10000, as the reference's REMOVE_JITTERS),
# RT_TIMESTEPS trajectory timesteps
# (several hundred updates); the host loop against the scan for
# EQ_UPDATES constant-period updates; auto on pair 1_0 for the JAX
# record's 512 updates; the fine-grained mode for FG_UPDATES updates; the
# 2000 us box BOX_SOLVES times at sqp_max_iter BOX_SQP_ITERS
RT_KNOTS = (32, 64)
RT_WARMUP = 2
RT_TIMESTEPS = 30
EQ_UPDATES = 64
AUTO_PAIR_UPDATES = 512
FG_UPDATES = 8
BOX_US = 2000.0
BOX_SOLVES = 8
BOX_SQP_ITERS = 40
# The kernels' numbers with the one-thread recursions, before lanedyn.cuh's
# warp-cooperative forms (an NVIDIA H100 80GB HBM3 at 700 W, PERF.md
# section 6), printed beside this run's: K1's and K3's device times per
# call (the auto and the staged loops), and K5's stages (a solve with the
# CG capped at 0, phase 10) per N; then K2's device time (the check's
# inputs) and K5's stages with K2's one-thread merit contribution, the
# last one-thread recursion (the same card and limit)
ONE_THREAD_US = {"K1": 170.7, "K3": 48.7, "K2": 19.6}
ONE_THREAD_K5_STAGES_US = {64: 347.9, 128: 365.9, 256: 573.4, 512: 795.5}
ONE_THREAD_MERIT_K5_STAGES_US = {64: 284.9, 128: 307.8, 256: 478.0,
                                 512: 651.0}
# K2 against its plain version at these horizons (N = 64: the check's
# inputs; the others a seeded step)
K2_KNOTS = (2, 32, 64, 256, 1024)
# the kernels whose ptxas resource lines phase 2 prints: K1, K2 at each
# group size, K3's three, the megakernels that run K3's stage bodies and
# K2's merit contribution, K7's and K7s's cluster kernels, K4's four forms
# and K11 (with the one-thread
# recursions:
# rollout_kernel 165 registers and 704 bytes of stack, k3_perknot 128 and
# 176, sqp_mega_kernel 202 and 896)
PTXAS_KERNELS = (("K1", "14rollout_kernel"), ("K2 G = 8", "12merit_kernelILi8E"),
                 ("K2 G = 16", "12merit_kernelILi16E"),
                 ("K2 G = 32", "12merit_kernelILi32E"),
                 ("K3 stage 1", "10k3_perknot"),
                 ("K3 stage 2", "8k3_theta"), ("K3 stage 3", "8k3_stair"),
                 ("K5", "15sqp_mega_kernelE"), ("K5g", "20sqp_mega_grid_kernel"),
                 ("K9p", "24sqp_iter_mega_pcg_kernelE"),
                 ("K9pg", "29sqp_iter_mega_pcg_grid_kernel"),
                 ("K9b", "24sqp_iter_mega_bcr_kernel"),
                 ("K7", "13bcr_dz_kernel"), ("K7s", "16bcr_solve_kernel"),
                 ("K10", "22sqp_mega_packed_kernel"),
                 ("K10 cluster form", "30sqp_mega_packed_cluster_kernel"),
                 ("K4", "21pcg_dz_cluster_kernel"),
                 ("K4b", "24pcg_solve_cluster_kernel"),
                 ("K4g", "20pcg_dz_joined_kernel"),
                 ("K4bg", "23pcg_solve_joined_kernel"),
                 ("K11", "16spmv_halo_kernel"))
MEGA_MAX_REGS = 202             # K5's and K9p's count with the one-thread
                                # recursions, which sets their grid
FIRST_LAUNCH_DEADLINE = 240     # s for the first launches of a cluster form

# The least time the card could take for a kernel's work: the
# larger of the bytes a function must move (inputs read once, outputs
# written once) over the H100's 3.35 TB/s and its operations over the
# 67 TFLOP/s float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
F32 = 4
TAB = 1680          # model-table floats (lanedyn.cuh TAB_SIZE)
# the megakernels' dynamic shared floats at the least: the merit stage's
# 16 groups of 8 lanes (merit.cuh AREA_FLOATS each)
MERIT_AREAS_FLOATS = 16 * 724
NX, NU = 14, 7
# Operations of the device library's routines per call, counted by hand
# from csrc/lanedyn.cuh (a multiply-add counts 2; sin, cos and a division
# 1): ABA forward dynamics, end-effector FK, one knot of one merit
# candidate (FK + ABA + cost and defect), one knot of K3's three stages
# (CRBA, RNEA, FK + Jacobian, 14 RNEA tangents, 7x7 and 14x14 inverses,
# the Schur products, theta^-1, the stair products), one 14x14
# Gauss-Jordan inverse, one 14x14 product and one 14x14 matrix-vector.
OPS_ABA, OPS_FK, OPS_MERIT_KNOT = 11_900, 1_220, 13_300
OPS_K3_KNOT, OPS_GJ14, OPS_MM14, OPS_MV14 = 120_000, 5_490, 5_488, 392


class Dims(NamedTuple):
    """A robot's widths, table floats and the operation counts above."""
    nx: int
    nu: int
    tab: int
    aba: int
    fk: int
    merit_knot: int
    k3_knot: int
    gj: int
    mm: int
    mv: int


IIWA = Dims(NX, NU, TAB, OPS_ABA, OPS_FK, OPS_MERIT_KNOT, OPS_K3_KNOT,
            OPS_GJ14, OPS_MM14, OPS_MV14)


def dims_for(nj: int) -> Dims:
    """The counts for a robot of nj joints (nx = 2 nj), from the IIWA's:
    the dense algebra by its order in nx (a product and a Gauss-Jordan
    inverse 2 nx^3, a matrix-vector product 2 nx^2); ABA, FK and a merit
    knot linear in nj; K3's knot its dense part (six products, B R^-1 B',
    two nx inverses, the nq inverse, A's product and the vectors: 50,274 at
    nx = 14) plus its recursions, the tangents' 2 nj directions over nj
    joints making them quadratic in nj (69,726 at 7 joints)."""
    if nj == 7:
        return IIWA
    nx, nu, r = 2 * nj, nj, nj / 7
    mm, mv = 2 * nx ** 3, 2 * nx ** 2

    def dense(x, u):
        return (6 * 2 * x ** 3 + 2 * x * x * u + 2 * 2 * x ** 3
                + 2 * u ** 3 + 2 * u * u * x + 8 * x * x)

    recursions = (OPS_K3_KNOT - dense(14, 7)) * r * r
    return Dims(nx, nu, 240 * nj, round(OPS_ABA * r), round(OPS_FK * r),
                round(OPS_MERIT_KNOT * r), round(recursions + dense(nx, nu)),
                mm, mm, mv)


def _spmv_ops(n, d=IIWA):
    return d.mv * (3 * n - 2)


def _dz_ops(n, d=IIWA):
    return 2 * (n * d.nx * 2 * d.nx + (n - 1) * d.nu * (d.nx + d.nu))


def _cg_ops(n, its, apply_ops, d=IIWA):
    """CG from a warm start: the first residual and apply, then per
    iteration one S product, one preconditioner apply, two dots and
    three axpys."""
    return (_spmv_ops(n, d) + apply_ops) * (1 + its) + its * 10 * d.nx * n


def _merits_ops(n, cands, d=IIWA):
    return cands * ((n - 1) * d.merit_knot + d.fk + 50)


def _bcr_factor_ops(n):
    levels = n.bit_length() - 1
    return sum((n >> (l + 1)) * (OPS_GJ14 + 7 * OPS_MM14)
               for l in range(levels)) + OPS_GJ14


def _bcr_apply_ops(n):
    return (n - 1) * 5 * OPS_MV14 + OPS_MV14


def _k3_no_stair_ops(n):
    """K3's stages without theta^-1 and the four stair products."""
    return n * (OPS_K3_KNOT - OPS_GJ14 - 4 * OPS_MM14)


def _knot_schur_floats(n, d=IIWA):
    """K3's outputs: SL SD SU PL PD PU Qinv A, Rinv, B, gamma, q, r."""
    return n * (8 * d.nx * d.nx + d.nu * d.nu + d.nx * d.nu + 2 * d.nx
                + d.nu)


def _k7_work(n):
    """(bytes, operations) of K7 at N = n: S's bands, gamma and the dz
    blocks read, lam, dX and dU written; the factor, two applies, the
    residual's product and dz."""
    return (F32 * (n * (5 * NX * NX + NX * NU + NU * NU + 2 * NX + NU)
                   + 2 * n * NX + (n - 1) * NU),
            _bcr_factor_ops(n) + 2 * _bcr_apply_ops(n) + _spmv_ops(n)
            + _dz_ops(n))


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _event_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of one call of fn, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _max_err(pairs) -> float:
    return max(float((g.double() - w.double()).abs().max()) for g, w in pairs)


def _assert_close(name, pairs, rtol, atol):
    import torch

    for i, (g, w) in enumerate(pairs):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: output {i} is not finite")
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name} output {i}: {m}")


_TAGS = {"K5g": "sqp_mega_grid_kernel", "K9pg": "sqp_iter_mega_pcg_grid_kernel",
         "K4g": "pcg_dz_joined_kernel", "K4bg": "pcg_solve_joined_kernel",
         "K10": "sqp_mega_packed_cluster_kernel",
         "K10 one-block": "sqp_mega_packed_kernel", "K5": "sqp_mega_kernel",
         "K9p": "sqp_iter_mega_pcg_kernel", "K9b": "sqp_iter_mega_bcr_kernel",
         "K6": "bcr_pcg_dz_kernel",
         "K7": "bcr_dz_kernel",
         "K7s": "bcr_solve_kernel", "K3": "k3_", "K4": "pcg_dz_cluster_kernel",
         "K4b": "pcg_solve_cluster_kernel", "K2": "merit_kernel",
         "K1": "rollout_kernel", "K11": "spmv_halo_kernel"}


_END = time.monotonic() + SCRIPT_DEADLINE


@contextlib.contextmanager
def _watchdog(seconds: float):
    """End the process (traceback, exit code 1) if the block runs past
    `seconds`, or the script past SCRIPT_DEADLINE: a kernel that hangs the
    card never returns to Python, and the process's end frees the card."""
    faulthandler.dump_traceback_later(
        max(1.0, min(seconds, _END - time.monotonic())), exit=True)
    try:
        yield
    finally:
        faulthandler.dump_traceback_later(
            max(1.0, _END - time.monotonic()), exit=True)


def _device_events(run):
    """(start us, end us, name) of every device kernel of one call of run
    (torch.profiler, CUPTI), sorted by start.  run is called twice: once in
    the profiler's warm-up step, whose events it discards (a session has
    lost its first kernels' records without it), then in its active
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    # the step's own range ("ProfilerStep#1") is no kernel
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep"))


def _by_kernel(evs) -> dict:
    """{kernel id or "torch glue": (device us, device kernels)}."""
    groups: dict = {}
    for s, e, name in evs:
        key = next((k for k, t in _TAGS.items() if t in name), "torch glue")
        t, n = groups.get(key, (0.0, 0))
        groups[key] = (t + e - s, n + 1)
    return groups


def _device_us(run, kid: str, calls: int = 5, per_call: int = 1,
               tries: int = 3):
    """The profiler's device time (us) of kernel kid per call of run (which
    launches it per_call times), averaged over the launches the profile of
    `calls` calls recorded: on the card a profile has kept only 2 of 5
    identical launches, or none, so one that kept none is taken again, up
    to tries times.  None if none recorded any."""
    for _ in range(tries):
        t, count = _by_kernel(_device_events(
            lambda: [run() for _ in range(calls)])).get(kid, (0.0, 0))
        if count:
            return t / count * per_call
    return None


def _us(t) -> str:
    return "not profiled" if t is None else f"{t:.1f} us"


# device kernels per counted launch (K3 is three launches)
_DEVICE_KERNELS = {"K3": 3}


def _missing_records(groups: dict, counts: dict) -> dict:
    """{kernel id: (records kept, launches made)} for each kernel of which
    a profile of one call kept fewer records than counts' launches make."""
    missing = {}
    for kid, launches in counts.items():
        made = launches * _DEVICE_KERNELS.get(kid, 1)
        kept = groups.get(kid, (0.0, 0))[1]
        if kept != made:
            missing[kid] = (kept, made)
    return missing


def _device_breakdown(run, n_updates: int, counts: dict,
                      tries: int = 3) -> tuple:
    """Print where the device time of one call of run goes: busy span and
    idle share, and device time by kernel; return (_by_kernel's groups,
    complete).  counts are the launches one call makes: a profile that
    kept fewer of a kernel's records (the card's profiler has dropped
    some) is taken again, up to tries times, and a breakdown still short
    is printed as incomplete -- its busy time undercounts and its idle
    share overcounts."""
    for attempt in range(1, tries + 1):
        evs = _device_events(run)
        groups = _by_kernel(evs)
        missing = _missing_records(groups, counts)
        if not missing:
            break
        print(f"profile attempt {attempt}: records kept / launches made "
              f"{missing}")
    complete = not missing
    if not complete:
        print(f"profile INCOMPLETE after {tries} attempts: the busy time "
              f"and idle share below miss {missing}")
    if not evs:
        print("profile: the profiler recorded no device events")
        return {}, complete
    busy, (cs, ce) = 0.0, evs[0][:2]
    for s, e, _ in evs[1:]:
        if s > ce:
            busy, cs, ce = busy + ce - cs, s, e
        else:
            ce = max(ce, e)
    busy += ce - cs
    span = evs[-1][1] - evs[0][0]
    print(f"profile: {len(evs)} device events, span {span / 1e3:.3f} ms, busy "
          f"{busy / 1e3:.3f} ms ({busy / 1e3 / n_updates:.4f} ms/update), "
          f"idle share {1 - busy / span:.3f}")
    groups = _by_kernel(evs)
    for key, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {key:10s} {t / 1e3:8.3f} ms  {100 * t / busy:5.1f}%  "
              f"{n:5d} device kernels  {t / n:8.2f} us each")
    return groups, complete


def knob_phase(model, xu, ee, cfg, counted, card: str, systems) -> dict:
    """Phase 15, the solver knobs (tests/torch_systems.py KNOB_CASES:
    joint tracking with q_cost 2, the Gauss-Newton Hessian, semi-implicit
    Euler and the angle wrap, each alone, and the two combinations) through
    the kernels that take them, at the slice's N = 64 on fixture 0_0 (xu,
    ee as load_fixture_pair gives them).  model is the IIWA on the card,
    cfg the slice's fused configuration, counted(label, run, want) runs
    `run` with every launch count set to 0 just before and checks the
    counts read just after against want (returning run's output and the
    counts), card nvidia-smi's name and power-limit line, systems the
    module tests/torch_systems.py.  Every check runs; the phase then
    raises AssertionError naming each one that failed.  Returns each knob
    kernel's entry of the kernels line, by kernel id."""
    import types

    import numpy as np
    import torch
    from mpcgpu_tpu_torch.config import default_pcg_exit_tols
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.ops.cuda import _lib, launch_counts
    from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
    from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
    from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
    # K5, K9 and K10 share one module
    from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k5
    from mpcgpu_tpu_torch.sim import (arm_starts, simulate_mpc_scan,
                                      simulate_mpc_scan_packed)
    from mpcgpu_tpu_torch.utils.trajfiles import horizon_slices

    t_phase = time.perf_counter()
    dev = model.Xc.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    KC, COMBOS = systems.KNOB_CASES, ("joint_semi_wrap", "gn_semi_wrap")
    SOLVE_TOLS = systems.SOLVE_TOLS
    n, na, cc = N_KNOTS, cfg.num_alphas, cfg.cost
    model64 = iiwa14(device=dev, dtype=torch.float64)
    on_card = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    X, U, goals, xs = (on_card(a) for a in horizon_slices(xu, ee, n))
    # the slice's perturbed start (knot 0 kept), so that the CGs iterate
    pert = torch.as_tensor(0.02 * np.random.default_rng(5).normal(
        size=(n, NX)), dtype=torch.float32, device=dev)
    pert[0] = 0.0
    Xp = X + pert
    rho, rho_lo = (torch.tensor(r, device=dev) for r in (cfg.rho_init, 1e-3))
    one = torch.tensor(1.0, device=dev)
    cap, tol = cfg.pcg.max_iter, default_pcg_exit_tols(n)[0]
    k5_kw = dict(dt=cfg.timestep, qd_cost=cc.qd_cost, r_cost=cc.r_cost,
                 gravity=cfg.gravity, mu=cfg.merit_mu, num_alphas=na,
                 rho_factor=cfg.rho_factor, rho_min=cfg.rho_min,
                 rho_max=cfg.rho_max, rho_reset=cfg.rho_reset)
    xu_d, ee_d = on_card(xu), on_card(ee)
    none = dict.fromkeys(launch_counts(), 0)
    k4_kid = "K4" if k4.pcg_plan(n).form == k4.CLUSTER else "K4g"
    failed = []

    def held(name, check, *args):
        """check(*args), or None with the failure noted."""
        try:
            return check(*args)
        except AssertionError as e:
            failed.append(f"{name}: {e}"[:600])
            print(f"FAILED {failed[-1]}", flush=True)
            return None

    def expect(ok, name):
        if not ok:
            failed.append(name)
            print(f"FAILED {name}", flush=True)

    def knob_start(knob, n_k=N_KNOTS, seed=5, move=True):
        """torch_systems.knob_start on the card."""
        return tuple(on_card(a) for a in systems.knob_start(
            xu, ee, n_k, knob, seed, move))

    def merit_at(kn, Xm, Um, gm, xsm, c=cfg):
        return k2.line_search_merits_reference(
            model, Xm, Um, torch.zeros_like(Xm), torch.zeros_like(Um), na, gm,
            xsm, c.timestep, c.merit_mu, c.cost.qd_cost, c.cost.r_cost,
            c.gravity, knobs=kn)[na]

    # (a) K3 and K2 under each case against their plain versions, from the
    # slice's perturbed start (under the wrap joints 0 and 3 moved to
    # within 0.03 of +-3.14159, where the wrap changes the defects; under
    # joint tracking the state rows as goals), first launches under the
    # watchdog.  K3 at the default check's rtol 3e-3, atol 3e-3 where the
    # end-effector position block is well conditioned; where it is near
    # singular -- the Gauss-Newton J'J (rank 3), and under the wrap cases'
    # moved joints the rank-1 g_q g_q' of an end effector far from its
    # goals, each beside rho = 1e-3 -- against the float64 plain version
    # at those tolerances, each entry widened by twice the float32 plain
    # version's largest distance to it in the entry's row
    # (torch_systems.within_twice_plain; the two float32 forms part there
    # in a few S entries by 1e-2 to 0.16).  K2 at its 2e-4, 2e-4.
    rng = np.random.default_rng(5)
    step = [on_card((0.05 * rng.normal(size=shape)).astype(np.float32))
            for shape in ((n, NX), (n - 1, NU))]
    knob_err = {}
    for knob, kn in KC.items():
        Xk, Uk, gk, xsk = knob_start(knob)
        if kn.angle_wrap:
            expect(systems.wrap_changes_defects(
                model, Xk, Uk, cfg.timestep, kn.integrator_type),
                f"knobs {knob}: the wrap changes no defect")
        a3k = (model, Xk, Uk, gk, xsk, rho, cfg.timestep, cc.qd_cost,
               cc.r_cost, cfg.gravity)
        a2k = (model, Xk, Uk, *step, na, gk, xsk, cfg.timestep, cfg.merit_mu,
               cc.qd_cost, cc.r_cost, cfg.gravity)
        with _watchdog(FIRST_LAUNCH_DEADLINE):
            ksk, m2k = (k3.form_kkt_schur(*a3k, knobs=kn),
                        k2.line_search_merits(*a2k, knobs=kn))
            sync()
        pairs3 = list(zip(ksk, k3.form_kkt_schur_reference(*a3k, knobs=kn)))
        if kn.hessian == "gauss_newton" or (kn.tracking == "eepos"
                                            and kn.angle_wrap):
            rep = held(f"K3 under {knob}", systems.within_twice_plain, ksk,
                       k3.KnotSchur(*(w for _, w in pairs3)),
                       k3.form_kkt_schur_reference(
                           model64, *systems.as_float64(a3k[1:]), knobs=kn),
                       systems.K3_TOLS, True)
            e3 = {"against": "float64", "report": rep}
        else:
            held(f"K3 under {knob}", _assert_close, f"K3 under {knob}",
                 pairs3, 3e-3, 3e-3)
            e3 = {"against": "plain", "max_abs_err": _max_err(pairs3)}
        pairs2 = [(m2k, k2.line_search_merits_reference(*a2k, knobs=kn))]
        held(f"K2 under {knob}", _assert_close, f"K2 under {knob}", pairs2,
             2e-4, 2e-4)
        knob_err[knob] = {"K3": e3, "K2": {"against": "plain",
                                           "max_abs_err": _max_err(pairs2)}}
    print(f"knobs: K3 and K2 against their plain versions at N = {n}: "
          f"{json.dumps(knob_err)}")

    # (b) device us a call on the slice's perturbed start (the wrap does
    # not fire there; the state rows as goals under joint tracking), beside
    # the default knobs on the same inputs; K5's CG counts printed beside
    # its time, since its work follows them
    state_goals = on_card(xu[:n, :NX])
    knob_us = {}
    for label in ("default",) + COMBOS:
        kn = KC.get(label, _lib.DEFAULT_KNOBS)
        gl = state_goals if kn.tracking == "joint" else goals
        a3t = (model, Xp, U, gl, xs, rho, cfg.timestep, cc.qd_cost,
               cc.r_cost, cfg.gravity)
        a2t = (model, Xp, U, *step, na, gl, xs, cfg.timestep, cfg.merit_mu,
               cc.qd_cost, cc.r_cost, cfg.gravity)
        a5t = (model, Xp, U, gl, xs, torch.zeros_like(Xp), rho, 1.0,
               merit_at(kn, Xp, U, gl, xs), cap, tol, SQP_ITERS)
        o5 = k5.sqp_solve_mega_pcg(*a5t, **k5_kw, knobs=kn)
        knob_us[label] = {
            "K3": _device_us(lambda: k3.form_kkt_schur(*a3t, knobs=kn), "K3",
                             per_call=3),
            "K2": _device_us(lambda: k2.line_search_merits(*a2t, knobs=kn),
                             "K2"),
            "K5": _device_us(lambda: k5.sqp_solve_mega_pcg(
                *a5t, **k5_kw, knobs=kn), "K5"),
            "K5_cg_iters": o5.pcg_iters.tolist()}
    print(f"knobs: {card}: device us a call (K5 with its CG iterations): "
          f"{json.dumps(knob_us)}")

    # (c) one SQP iteration of K5, K9p, K9b and K10 (two arms, the second
    # from seed 6, rhos 1e-3 and 0.1) under each combination at N = 64,
    # cold duals, rho 1e-3, from the moved start of (a): the decisions and
    # CG counts of the plain version, X, U and lam against the float64
    # plain version (torch_systems.within_twice_plain at the solves'
    # default rtol, atol).  K9b as its default check judges it, at rho
    # 0.1: its duals by relative residual, within three times the float64
    # plain solve's rounded to float32 (torch_systems.
    # residual_near_float64), its X, U and merit at rtol 1e-3, atol 2e-4
    # against the plain iteration given its own duals.  Its exact float32
    # solve of these systems (condition ~1e7) parts from the plain one in
    # the duals, and dz carries that through Q^-1: at rho 1e-3 (entries to
    # 1e3) the iteration given its duals parts by up to 2.4 times that
    # tolerance, and X parts from float64 by up to 6.7 times twice the
    # plain version's distance at rho 0.1 (PERF.md §6)
    knob_solve = {kid: {} for kid in ("K5", "K9p", "K9b", "K10")}
    for combo in COMBOS:
        kn = KC[combo]
        kw = dict(k5_kw, knobs=kn)
        Xk, Uk, gk, xsk = knob_start(combo)
        m0 = merit_at(kn, Xk, Uk, gk, xsk)
        lam0 = torch.zeros_like(Xk)
        Xb = torch.stack([Xk, knob_start(combo, seed=6)[0]])
        cases = (
            ("K5", k5.sqp_solve_mega_pcg, k5.sqp_solve_mega_pcg_reference,
             (Xk, Uk, gk, xsk, lam0, rho_lo, 1.0, m0, cap, tol, 1),
             ("sqp_iters", "bailed", "accepted", "pcg_iters")),
            ("K9p", k5.sqp_iter_mega_pcg, k5.sqp_iter_mega_pcg_reference,
             (Xk, Uk, gk, xsk, lam0, rho_lo, one, m0, cap, tol),
             ("accept", "bail", "pcg_iters")),
            ("K9b", k5.sqp_iter_mega, k5.sqp_iter_mega_reference,
             (Xk, Uk, gk, xsk, torch.tensor(0.1, device=dev), one, m0),
             ("accept", "bail")),
            ("K10", k5.sqp_solve_mega_pcg_packed,
             k5.sqp_solve_mega_pcg_packed_reference,
             (Xb, Uk.expand(2, n - 1, NU).contiguous(),
              gk.expand((2,) + gk.shape), Xb[:, 0].contiguous(),
              torch.zeros_like(Xb), torch.tensor([1e-3, 0.1], device=dev),
              torch.ones(2, device=dev), cap, tol, 1),
             ("sqp_iters", "bailed", "pcg_iters_total")))
        for kid, run, plain, args, same in cases:
            name = f"{kid} N = {n} under {combo}"
            with _watchdog(FIRST_LAUNCH_DEADLINE):
                got = run(model, *args, **kw)
                sync()
            want = plain(model, *args, **kw)
            want64 = plain(model64, *systems.as_float64(args), **kw)
            for f in same:
                expect(torch.equal(getattr(got, f), getattr(want, f)),
                       f"{name}: {f} differs from the plain version's")
            row = {"max_abs_err": _max_err([(getattr(got, f), getattr(
                       want, f)) for f in ("X", "U", "lam")]),
                   **{f: getattr(got, f).tolist() for f in same}}
            if kid != "K9b":
                row["float64"] = held(name, systems.within_twice_plain, got,
                                      want, want64, SOLVE_TOLS)
            else:
                given, ks = systems.bcr_iteration_given_lam(
                    model, *args, got.lam, **kw)
                row["residual"] = held(f"{name}: lam",
                                       systems.residual_near_float64, ks,
                                       got.lam, want.lam, want64.lam)
                pairs = [(getattr(got, f), getattr(given, f))
                         for f in ("X", "U", "merit")]
                held(f"{name}, given its lam", _assert_close,
                     f"{name}, given its lam", pairs, 1e-3, 2e-4)
                row["given_max_abs_err"] = _max_err(pairs)
            knob_solve[kid][combo] = row
    print(f"knobs: one SQP iteration at N = {n}: {json.dumps(knob_solve)}")

    # (d) the closed loops, cold duals, from the slice's start along the
    # fixture (the state rows as the goals' trace under joint tracking);
    # each fused loop against the plain loop of its linsys: sqp_iters and
    # rho bails equal (the CG totals are printed, not compared: PERF.md);
    # the CG routes' plant path within KNOB_PATH_TOL of the plain loop's;
    # the exact BCR's (K9b's), whose float32 solves of the near-singular
    # Gauss-Newton system part from the plain ones, held to the plain bcr
    # loop run in float64: within_twice_plain on the path at X's rtol, atol
    u8, s = NEW_UPDATES, SQP_ITERS
    dq = torch.as_tensor(0.02 * np.random.default_rng(11).normal(
        size=(ARMS, NX // 2)), dtype=torch.float32, device=dev)
    Xs2, Us2, lams2 = arm_starts(X, U, torch.zeros_like(X), dq)
    knob_loops, knob_counts = {}, {}
    for combo in COMBOS:
        kn = KC[combo]
        base = dataclasses.replace(
            cfg, integrator_type=kn.integrator_type, angle_wrap=kn.angle_wrap,
            cost=dataclasses.replace(cc, tracking=kn.tracking,
                                     hessian=kn.hessian, q_cost=kn.q_cost))
        plain_k = dataclasses.replace(base, fused_stages=False)
        trace = (xu_d[:, :NX].contiguous() if kn.tracking == "joint"
                 else ee_d)

        def go(run_cfg, linsys, timing=False, packed=False):
            if packed:
                return simulate_mpc_scan_packed(
                    model, run_cfg, xu_d, trace, Xs2, Us2, lams2,
                    cfg.rho_init, tol, u8, timing=timing)
            return simulate_mpc_scan(model, run_cfg, xu_d, trace, X, U,
                                     torch.zeros_like(X), rho, tol, u8,
                                     linsys, timing=timing)

        plain_out = {"pcg": go(plain_k, "pcg"), "bcr": go(plain_k, "bcr"),
                     "packed": go(plain_k, "pcg", packed=True)}
        bcr64 = simulate_mpc_scan(
            model64, dataclasses.replace(plain_k, dtype="float64"),
            xu_d.double(), trace.double(), X.double(), U.double(),
            torch.zeros_like(X, dtype=torch.float64), rho.double(), tol, u8,
            "bcr")
        for label, run_cfg, linsys, want in (
                ("whole solve", dataclasses.replace(
                    base, megakernel=True, megakernel_solve=True), "pcg",
                 {**none, "K1": u8, "K2": u8, "K5": u8}),
                ("staged pcg", base, "pcg",
                 {**none, "K1": u8, "K2": u8 + u8 * s, "K3": u8 * s,
                  k4_kid: u8 * s}),
                ("pcg per-iteration", dataclasses.replace(
                    base, megakernel=True), "pcg",
                 {**none, "K1": u8, "K2": u8, "K9p": u8 * s}),
                ("bcr per-iteration", dataclasses.replace(
                    base, megakernel=True), "bcr",
                 {**none, "K1": u8, "K2": u8, "K9b": u8 * s}),
                ("packed, 2 arms", base, "packed",
                 {**none, "K1": u8, "K10": u8})):
            is_packed = linsys == "packed"
            with _watchdog(FIRST_LAUNCH_DEADLINE):
                go(run_cfg, "pcg" if is_packed else linsys, packed=is_packed)
                sync()
            tag = f"{label} under {combo}"
            out, counts = counted(tag, lambda: go(
                run_cfg, "pcg" if is_packed else linsys, True, is_packed),
                want)
            ref = plain_out["packed" if is_packed else linsys]
            expect(bool(torch.isfinite(out["tracking_errors"]).all()
                        and torch.isfinite(out["final_xs"]).all()),
                   f"{tag}: not finite")
            summary = {
                "sqp_iters": out["sqp_iters"].tolist(),
                "rho_bailed": out["rho_bailed"].tolist(),
                "pcg_iters_total": out["pcg_iters_total"].tolist(),
                "plain_pcg_iters_total": ref["pcg_iters_total"].tolist(),
                "path_vs_plain_max": _max_err([(out["tracking_path"],
                                                ref["tracking_path"])]),
                "mean_err_m": float(out["tracking_errors"].mean()),
                "plain_mean_err_m": float(ref["tracking_errors"].mean()),
                "update_ms_median": statistics.median(out["update_ms"])}
            for key in ("sqp_iters", "rho_bailed"):
                expect(torch.equal(out[key], ref[key]),
                       f"{tag}: {key} differs from the plain loop's")
            if linsys == "bcr":
                summary["float64_sqp_iters"] = bcr64["sqp_iters"].tolist()
                summary["float64_mean_err_m"] = float(
                    bcr64["tracking_errors"].mean())
                summary["path"] = held(
                    f"{tag}: path", systems.within_twice_plain,
                    *(types.SimpleNamespace(path=o["tracking_path"])
                      for o in (out, ref, bcr64)),
                    {"path": SOLVE_TOLS["X"]})
            else:
                expect(summary["path_vs_plain_max"] <= KNOB_PATH_TOL,
                       f"{tag}: the path parts from the plain loop's by "
                       f"{summary['path_vs_plain_max']}, more than "
                       f"{KNOB_PATH_TOL}")
            print(f"{tag}: {json.dumps(summary)}")
            knob_loops[tag], knob_counts[f"{tag} loop"] = summary, counts

    # (e) K5g and K9pg at N = 1024 under the first combination: one SQP
    # iteration each from the repeated fixture's perturbed start (its
    # joints where the fixture has them: the wrap's branch runs, and the
    # step is accepted), against the plain version with the float64 plain
    # version as the yardstick (torch_systems.within_twice_plain), the
    # decisions and CG counts equal
    n_g, combo = GRID_LOOP_KNOT, COMBOS[0]
    kn = KC[combo]
    Xg, Ug, gg, xsg = knob_start(combo, n_g, seed=0, move=False)
    cg = slice_cfg(n_g)
    kw_g = dict(dt=cg.timestep, qd_cost=cg.cost.qd_cost,
                r_cost=cg.cost.r_cost, gravity=cg.gravity, mu=cg.merit_mu,
                num_alphas=na, rho_factor=cg.rho_factor, rho_min=cg.rho_min,
                rho_max=cg.rho_max, rho_reset=cg.rho_reset, knobs=kn)
    m0g = merit_at(kn, Xg, Ug, gg, xsg, cg)
    tol_g = default_pcg_exit_tols(n_g)[0]
    grid_pairs = (
        ("K5g", k5.sqp_solve_mega_pcg_grid, k5.sqp_solve_mega_pcg_reference,
         (Xg, Ug, gg, xsg, torch.zeros_like(Xg), rho, 1.0, m0g,
          cg.pcg.max_iter, tol_g, 1),
         ("sqp_iters", "bailed", "accepted", "pcg_iters")),
        ("K9pg", k5.sqp_iter_mega_pcg_grid, k5.sqp_iter_mega_pcg_reference,
         (Xg, Ug, gg, xsg, torch.zeros_like(Xg), rho, one, m0g,
          cg.pcg.max_iter, tol_g),
         ("accept", "bail", "pcg_iters")))
    knob_grid = {}
    for kid, run, plain, a_g, same in grid_pairs:
        name = f"{kid} N = {n_g} under {combo}"
        with _watchdog(FIRST_LAUNCH_DEADLINE):
            o_g = run(model, *a_g, **kw_g)
            sync()
        p_g = plain(model, *a_g, **kw_g)
        p64 = plain(model64, *systems.as_float64(a_g), **kw_g)
        for f in same:
            expect(torch.equal(getattr(o_g, f), getattr(p_g, f)),
                   f"{name}: {f} differs from the plain version's")
        knob_grid[kid] = {
            "max_abs_err": _max_err([(o_g.X, p_g.X), (o_g.U, p_g.U),
                                     (o_g.lam, p_g.lam)]),
            "float64": held(name, systems.within_twice_plain, o_g, p_g, p64,
                            SOLVE_TOLS),
            **{f: getattr(o_g, f).tolist() for f in same}}
    print(f"knobs: K5g and K9pg at N = {n_g} under {combo}: "
          f"{json.dumps(knob_grid)}")

    # the kernels line: each knob-taking kernel's checks, its device us
    # under each combination and its launches in this phase's loops
    entries = {}
    for kid in ("K1", "K2", "K3", k4_kid, "K5", "K9p", "K9b", "K10"):
        entry = {"launches": {p: c[kid] for p, c in knob_counts.items()
                              if c.get(kid)}}
        expect(bool(entry["launches"]), f"{kid} was launched in no knob loop")
        if kid in ("K2", "K3"):
            entry["checks"] = {k: e[kid] for k, e in knob_err.items()}
        if kid in knob_solve:
            entry["checks"] = knob_solve[kid]
        if kid in ("K2", "K3", "K5"):
            entry["device_us"] = {k: u[kid] for k, u in knob_us.items()}
        entries[kid] = entry
    for kid, row in knob_grid.items():
        entries[kid] = {"checks": {combo: row}}
    print(f"phase 15 (solver knobs): {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError(f"phase 15: {len(failed)} checks failed: "
                             + "; ".join(failed))
    return entries


def slice_cfg(n: int, **kw):
    """The slice's fused configuration at n knots: SQP_ITERS SQP
    iterations, the PCG cap of the JAX package's sweeps."""
    from mpcgpu_tpu_torch.config import PCGConfig, SolverConfig

    return SolverConfig.for_knots(
        n, sqp_max_iter=SQP_ITERS, fused_stages=True,
        pcg=PCGConfig(max_iter=PCGConfig.tpu_tuned_max_iter(n)), **kw)


def load_systems(repo: Path):
    """tests/torch_systems.py, loaded by path: the machine may have
    another package named "tests"."""
    spec = importlib.util.spec_from_file_location(
        "_torch_systems", repo / "tests" / "torch_systems.py")
    systems = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(systems)
    return systems


def knob_phase_alone() -> int:
    """`python3 chip_smoke.py --phase 15`: the IIWA library built, then
    phase 15 alone, its kernels-line entries printed as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs a CUDA card")
    faulthandler.dump_traceback_later(max(1.0, _END - time.monotonic()),
                                      exit=True)
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.ops.cuda import (_lib, launch_counts,
                                           reset_launch_counts)
    from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    _lib.build_all(force=True, counts=(7,))
    print(f"build: {time.perf_counter() - t0:.1f} s")

    def counted(label, run, want):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"{label}: launches {counts}")
        if counts != want:
            raise AssertionError(f"{label}: launch counts {counts}, expected "
                                 f"{want}")
        return out, counts

    xu, ee = load_fixture_pair(repo / "tests" / "fixtures", 0, 0)
    entries = knob_phase(iiwa14(device=torch.device("cuda", 0)), xu, ee,
                         slice_cfg(N_KNOTS), counted, card,
                         load_systems(repo))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"knobs": entries}))
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs a CUDA card")
    faulthandler.dump_traceback_later(max(1.0, _END - time.monotonic()),
                                      exit=True)
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from mpcgpu_tpu_torch.config import (PCGConfig, SolverConfig,
                                         default_pcg_exit_tols)
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.linsys.qdldl_host import (_btd_upper_csc,
                                                    _cached_solver)
    from mpcgpu_tpu_torch.ops.btridiag import BlockTri, spmv, to_dense
    from mpcgpu_tpu_torch.ops.cuda import (_lib, form_launch_counts,
                                           launch_counts)
    from mpcgpu_tpu_torch.ops.cuda import bcr_kernel as k6
    from mpcgpu_tpu_torch.ops.cuda import bcr_kernel as k7
    from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
    from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
    from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
    from mpcgpu_tpu_torch.ops.cuda import reset_launch_counts
    from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import compute_dz_knots
    from mpcgpu_tpu_torch.ops.cuda import rollout_kernel as k1
    from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k5
    from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k9
    from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k10
    from mpcgpu_tpu_torch.ops.schur import SchurData
    from mpcgpu_tpu_torch.sim import (arm_starts, max_substeps_for,
                                      simulate_mpc_scan,
                                      simulate_mpc_scan_batched,
                                      simulate_mpc_scan_packed)
    from mpcgpu_tpu_torch import sqp as sqp_module
    from mpcgpu_tpu_torch.sqp import get_linsys_backend, iterate, sqp_solve
    from mpcgpu_tpu_torch.utils.trajfiles import horizon_slices, load_fixture_pair
    # the tests' seeded systems (the well-conditioned K6 system, the knob
    # cases)
    systems = load_systems(repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")

    # ---- 2. build: the IIWA's library and the two-joint one, every
    # source of both compiled at once
    t0 = time.perf_counter()
    lib_path, lib2_path = _lib.build_all(force=True, counts=(7, NQ2))
    lib, lib2 = _lib.library(), _lib.library(NQ2)
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}, "
          f"{lib2_path.name}")
    build_log = lib_path.with_suffix(".log").read_text()
    for line in build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    def ptxas_of(log, kids, tag=""):
        found = _lib.ptxas_resources(log, [frag for kid, frag in PTXAS_KERNELS
                                           if kid in kids])
        lines = {}
        for kid, fragment in PTXAS_KERNELS:
            if kid not in kids:
                continue
            regs, stack = found[fragment]
            lines[kid] = f"{regs} | {stack}"
            print(f"ptxas {kid}{tag}: {lines[kid]}")
            if "0 bytes spill stores, 0 bytes spill loads" not in stack:
                raise AssertionError(f"{kid}{tag} spills: {stack}")
            if kid in ("K5", "K9p") and int(regs.split()[1]) > MEGA_MAX_REGS:
                raise AssertionError(f"{kid}{tag} above {MEGA_MAX_REGS} "
                                     f"registers (its co-resident grid "
                                     f"shrinks): {regs}")
        return lines

    ptxas_k = ptxas_of(build_log, [kid for kid, _ in PTXAS_KERNELS])
    ptxas_k2 = ptxas_of(lib2_path.with_suffix(".log").read_text(), NQ2_PTXAS,
                        f" (nq = {NQ2})")

    # ---- 3. each kernel against its plain version, slice inputs
    model = iiwa14(device=dev)
    xu, ee = load_fixture_pair(repo / "tests" / "fixtures", 0, 0)
    X, U, goals, xs = (torch.as_tensor(a, device=dev)
                       for a in horizon_slices(xu, ee, N_KNOTS))
    n = N_KNOTS
    cap = PCGConfig.tpu_tuned_max_iter(N_KNOTS)
    tol = default_pcg_exit_tols(N_KNOTS)[0]
    cfg = slice_cfg(N_KNOTS)
    cc = cfg.cost
    rho = torch.tensor(cfg.rho_init, device=dev)
    print(f"slice: N={N_KNOTS} sqp_max_iter={SQP_ITERS} pcg cap={cap} "
          f"tol={tol:g} r_cost={cc.r_cost:g} updates={N_UPDATES}")
    print(f"fit: K4 at N = {n} takes plan {tuple(k4.pcg_plan(n))} (form, "
          f"C, G, place, grid), K6 (one "
          f"cluster) power-of-2 N <= {k6.check_bcr_fit(n)}, K5 (its CG "
          f"across a cluster) N <= {lib.mpc_mega_max_knots(k5.SOLVE_PCG)} "
          f"(grid {k5.check_mega_fit(n)} blocks at N = {n})")
    print(f"fit: K7 (one cluster, C = {lib.mpc_bcr_dz_cluster(n, 0)} at "
          f"N = {n}) power-of-2 N <= {k7.check_bcr_dz_fit(n)}, K7s power-of-2 "
          f"N <= {k7.check_bcr_solve_fit(n)}, K9p N <= "
          f"{lib.mpc_mega_max_knots(k9.ITER_PCG)} (grid "
          f"{k9.check_mega_fit(n, kind=k9.ITER_PCG)}), K9b N <= "
          f"{lib.mpc_mega_max_knots(k9.ITER_BCR)} (grid "
          f"{k9.check_mega_fit(n, kind=k9.ITER_BCR)})")

    kernels = []

    def record(kid, name, source, replaces, err, run, plain, ops, nbytes,
               **extra):
        ms, plain_ms = _event_ms(run), _event_ms(plain)
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"{kid} {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {bound_ms:.6f} ms "
              f"({bound_by}: {nbytes} B, {ops} operations)")
        kernels.append({"name": f"{kid} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": 0, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None, **extra})

    def checked(name, pairs, rtol, atol):
        _assert_close(name, pairs, rtol, atol)
        return _max_err(pairs)

    k3_args = (model, X, U, goals, xs, rho, cfg.timestep, cc.qd_cost,
               cc.r_cost, cfg.gravity)
    ks = k3.form_kkt_schur(*k3_args)
    ks_ref = k3.form_kkt_schur_reference(*k3_args)
    sync()
    k3_dev = _device_us(lambda: k3.form_kkt_schur(*k3_args), "K3",
                        per_call=3)
    print(f"K3 device time per call (three launches): {_us(k3_dev)} "
          f"(one-thread recursions: {ONE_THREAD_US['K3']} us)")
    record("K3", "form_kkt_schur", "mpcgpu_tpu_torch/csrc/kkt_schur.cu",
           "mpcgpu_tpu/ops/pallas/kkt_schur_kernel.py:379",
           checked("K3", list(zip(ks, ks_ref)), 3e-3, 3e-3),
           lambda: k3.form_kkt_schur(*k3_args),
           lambda: k3.form_kkt_schur_reference(*k3_args),
           n * OPS_K3_KNOT,
           F32 * (n * NX + (n - 1) * NU + n * 6 + 1 + TAB
                  + _knot_schur_floats(n)),
           device_us=k3_dev,
           ptxas={k: ptxas_k[k] for k in ("K3 stage 1", "K3 stage 2",
                                          "K3 stage 3")})

    lam0 = torch.zeros_like(X)
    with _watchdog(FIRST_LAUNCH_DEADLINE):   # K4's cluster form's first launch
        k4_out = k4.pcg_dz(ks_ref, lam0, cap, tol)
        sync()
    k4_ref = k4.pcg_dz_reference(ks_ref, lam0, cap, tol)
    it, it_ref = int(k4_out[3]), int(k4_ref[3])
    print(f"K4 CG iterations: kernel {it} (hit {bool(k4_out[4])}), plain "
          f"{it_ref} (hit {bool(k4_ref[4])})")
    if not (abs(it - it_ref) <= 2 or it == it_ref == cap):
        raise AssertionError(f"K4 iteration counts disagree: {it} vs {it_ref}")
    record("K4", "pcg_dz", "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
           "mpcgpu_tpu/ops/pallas/pcg_kernel.py:318",
           checked("K4", list(zip(k4_out[:3], k4_ref[:3])), 5e-3, 5e-3),
           lambda: k4.pcg_dz(ks_ref, lam0, cap, tol),
           lambda: k4.pcg_dz_reference(ks_ref, lam0, cap, tol),
           _cg_ops(n, it, _spmv_ops(n)) + _dz_ops(n),
           F32 * (_knot_schur_floats(n) + n * NX + 2 * n * NX
                  + (n - 1) * NU) + 5)

    dX, dU = k4_ref[1], k4_ref[2]
    k2_args = (model, X, U, dX, dU, cfg.num_alphas, goals, xs, cfg.timestep,
               cfg.merit_mu, cc.qd_cost, cc.r_cost, cfg.gravity)
    # K2 against the plain merits at every horizon of K2_KNOTS (2e-4), and
    # two launches on the same inputs: the same bits
    err2 = {}
    for n_m in K2_KNOTS:
        if n_m == n:
            a_m = k2_args
        else:
            rows = np.resize(np.arange(xu.shape[0]), n_m)
            gen = np.random.default_rng(n_m)
            on_card = lambda a: torch.as_tensor(
                np.ascontiguousarray(a, dtype=np.float32), device=dev)
            a_m = (model, on_card(xu[rows, :NX]), on_card(xu[rows[:-1], NX:]),
                   on_card(0.05 * gen.normal(size=(n_m, NX))),
                   on_card(0.05 * gen.normal(size=(n_m - 1, NU))),
                   cfg.num_alphas, on_card(ee[rows]), on_card(xu[0, :NX]),
                   *k2_args[8:])
        m = k2.line_search_merits(*a_m)
        m_again = k2.line_search_merits(*a_m)
        m_ref = k2.line_search_merits_reference(*a_m)
        sync()
        if not torch.equal(m, m_again):
            raise AssertionError(f"K2 N = {n_m}: two launches on the same "
                                 f"inputs differ")
        err2[n_m] = checked(f"K2 N = {n_m}", [(m, m_ref)], 2e-4, 2e-4)
        print(f"K2 N = {n_m}: max_abs_err {err2[n_m]:.3e} against plain, "
              f"two launches bit-equal")
    k2_dev = _device_us(lambda: k2.line_search_merits(*k2_args), "K2")
    print(f"K2 device time per call: {_us(k2_dev)} (one-thread merit "
          f"contribution: {ONE_THREAD_US['K2']} us)")
    record("K2", "line_search_merits", "mpcgpu_tpu_torch/csrc/merit.cu",
           "mpcgpu_tpu/ops/pallas/merit_kernel.py:145",
           max(err2.values()),
           lambda: k2.line_search_merits(*k2_args),
           lambda: k2.line_search_merits_reference(*k2_args),
           _merits_ops(n, cfg.num_alphas + 1),
           F32 * (2 * (n * NX + (n - 1) * NU) + n * 6 + NX + TAB
                  + cfg.num_alphas + 1),
           max_abs_err_by_n=err2, deterministic=True, device_us=k2_dev,
           ptxas={k: ptxas_k[k] for k in ("K2 G = 8", "K2 G = 16",
                                          "K2 G = 32")})

    period = cfg.simulation_period_us
    k1_args = (model, cfg, xs, U, goals[0], period, period,
               max_substeps_for(cfg))
    r = k1.plant_rollout(*k1_args)
    r_ref = k1.plant_rollout_reference(*k1_args)
    # the arm-batched launch (one block per arm) against one single launch
    # per arm: bit-equal, the same per-arm arithmetic in the same order
    gen = np.random.default_rng(9)
    x_arms = xs + torch.as_tensor(0.01 * gen.normal(size=(ARMS, NX)),
                                  dtype=torch.float32, device=dev)
    U_arms = U + torch.as_tensor(0.01 * gen.normal(size=(ARMS, n - 1, NU)),
                                 dtype=torch.float32, device=dev)
    k1_arm_args = (model, cfg, x_arms, U_arms, goals[0], period, period,
                   max_substeps_for(cfg))
    r_arms = k1.plant_rollout(*k1_arm_args)
    r_one = [k1.plant_rollout(model, cfg, x_arms[a], U_arms[a], *k1_args[4:])
             for a in range(ARMS)]
    sync()
    for a, (x1, e1) in enumerate(r_one):
        if not (torch.equal(r_arms[0][a], x1) and torch.equal(r_arms[1][a], e1)):
            raise AssertionError(f"K1 arm-batched launch, arm {a}: not "
                                 f"bit-equal to a single launch")
    k1_arms_ms = _event_ms(lambda: k1.plant_rollout(*k1_arm_args))
    print(f"K1 arm-batched ({ARMS} arms, one launch): bit-equal to {ARMS} "
          f"single launches; {k1_arms_ms:.4f} ms per call")
    k1_dev = _device_us(lambda: k1.plant_rollout(*k1_args), "K1")
    print(f"K1 device time per call: {_us(k1_dev)} (one-thread "
          f"recursions: {ONE_THREAD_US['K1']} us)")
    # K1 at the real-time loop's shapes (phase 13): N = 32, the plant run
    # for a solve time under the period and for one past the rollout's
    # 2.2 ms window (11 substeps and the remainder), from the previous
    # update's time
    err1 = checked("K1", list(zip(r, r_ref)), 1e-4, 1e-5)
    for n_r, off_us, sim_us in ((RT_KNOTS[0], period, 1300.0),
                                (RT_KNOTS[0], 1300.0, 2600.0)):
        a_r = (model, cfg, xs, U[:n_r - 1].contiguous(), goals[0], off_us,
               sim_us, max_substeps_for(cfg))
        err1 = max(err1, checked(
            f"K1 N = {n_r}, {sim_us:g} us after {off_us:g}",
            list(zip(k1.plant_rollout(*a_r),
                     k1.plant_rollout_reference(*a_r))), 1e-4, 1e-5))
    print(f"K1 at N = {RT_KNOTS[0]}, 1300 and 2600 us plant times: "
          f"max_abs_err {err1:.3e} against plain")
    steps = int(period * 1e-6 / cfg.sim_step_time + 1e-9) + 1  # + remainder
    record("K1", "plant_rollout", "mpcgpu_tpu_torch/csrc/rollout.cu",
           "mpcgpu_tpu/ops/pallas/rollout_kernel.py:92", err1,
           lambda: k1.plant_rollout(*k1_args),
           lambda: k1.plant_rollout_reference(*k1_args),
           steps * (OPS_ABA + 60) + OPS_FK,
           F32 * (NX + (n - 1) * NU + 6 + TAB + NX + 1),
           arm_batched_ms=k1_arms_ms, arm_batched_arms=ARMS,
           device_us=k1_dev,
           ptxas=ptxas_k["K1"])

    def perturbed(seed):
        """X with a seeded perturbation (knot 0 kept), so that the CG
        loops iterate."""
        pert = torch.as_tensor(0.02 * np.random.default_rng(seed).normal(
            size=(n, NX)), dtype=torch.float32, device=dev)
        pert[0] = 0.0
        return X + pert

    Xp = perturbed(5)
    # K6 on a well-conditioned system (the JAX BCR tests' tolerances), and
    # on the slice's K3 system at the perturbed start without the stair
    # preconditioner, which is judged by residual: its condition (~1e7)
    # puts any two float32 solves ~1e-3 of |lam| apart.
    ks_rand = systems.random_knot_schur(n, device=dev)
    with _watchdog(FIRST_LAUNCH_DEADLINE):
        k6_out = k6.bcr_pcg_dz(ks_rand, lam0, cap, tol)
        sync()
    k6_ref = k6.bcr_pcg_dz_reference(ks_rand, lam0, cap, tol)
    sync()
    scale = k6_ref[0].abs().max()
    checked("K6 lam/max|lam|", [(k6_out[0] / scale, k6_ref[0] / scale)], 0,
            2e-5)
    err6 = checked("K6 dz", list(zip(k6_out[1:3], k6_ref[1:3])), 1e-3, 2e-4)
    err6 = max(err6, _max_err([(k6_out[0], k6_ref[0])]))
    if abs(int(k6_out[3]) - int(k6_ref[3])) > 1:
        raise AssertionError(f"K6 iteration counts disagree: "
                             f"{int(k6_out[3])} vs {int(k6_ref[3])}")
    ks_np = k3.form_kkt_schur_reference(model, Xp, *k3_args[2:],
                                        precond=False)
    k6_slice = k6.bcr_pcg_dz(ks_np, lam0, cap, tol)
    k6_slice_ref = k6.bcr_pcg_dz_reference(ks_np, lam0, cap, tol)
    sync()
    S = BlockTri(ks_np.SL, ks_np.SD, ks_np.SU)
    res = [float((spmv(S, o[0]) - ks_np.gamma).abs().max()
                 / ks_np.gamma.abs().max()) for o in (k6_slice, k6_slice_ref)]
    its6 = int(k6_slice[3]), int(k6_slice_ref[3])
    print(f"K6 random system: CG {int(k6_out[3])} vs {int(k6_ref[3])} "
          f"iterations; slice system: CG {its6[0]} vs {its6[1]}, relative "
          f"residual kernel {res[0]:.3e} plain {res[1]:.3e}")
    if max(res) >= 1e-3 or abs(its6[0] - its6[1]) > 1:
        raise AssertionError(f"K6 on the slice system: residuals {res}, "
                             f"iterations {its6}")
    err6_slice = _max_err(list(zip(k6_slice[:3], k6_slice_ref[:3])))
    record("K6", "bcr_pcg_dz", "mpcgpu_tpu_torch/csrc/bcr_pcg_dz.cu",
           "mpcgpu_tpu/ops/pallas/bcr_kernel.py:267", err6,
           lambda: k6.bcr_pcg_dz(ks_np, lam0, cap, tol),
           lambda: k6.bcr_pcg_dz_reference(ks_np, lam0, cap, tol),
           _bcr_factor_ops(n) + _cg_ops(n, its6[0], _bcr_apply_ops(n))
           + _dz_ops(n),
           F32 * (n * (5 * NX * NX + NX * NU + NU * NU + 3 * NX + NU)
                  + 2 * n * NX + (n - 1) * NU) + 5,
           max_abs_err_slice=err6_slice)

    # K5: 4 SQP iterations from the perturbed start, cold duals
    merit0 = k2.line_search_merits_reference(
        model, Xp, U, torch.zeros_like(Xp), torch.zeros_like(U),
        cfg.num_alphas, goals, xs, cfg.timestep, cfg.merit_mu, cc.qd_cost,
        cc.r_cost, cfg.gravity)[cfg.num_alphas]
    k5_kw = dict(dt=cfg.timestep, qd_cost=cc.qd_cost, r_cost=cc.r_cost,
                 gravity=cfg.gravity, mu=cfg.merit_mu,
                 num_alphas=cfg.num_alphas, rho_factor=cfg.rho_factor,
                 rho_min=cfg.rho_min, rho_max=cfg.rho_max,
                 rho_reset=cfg.rho_reset)

    def k5_pair(rho0, lam_rtol, lam_atol):
        """K5 and its plain version from the perturbed start at carried
        rho0: X, U at the JAX megakernel test's rtol 1e-3, atol 1e-5,
        decisions identical, CG iterations within 2 per SQP iteration."""
        args = (model, Xp, U, goals, xs, lam0,
                torch.tensor(rho0, device=dev), 1.0, merit0, cap, tol,
                SQP_ITERS)
        with _watchdog(FIRST_LAUNCH_DEADLINE):
            out = k5.sqp_solve_mega_pcg(*args, **k5_kw)
            sync()
        ref = k5.sqp_solve_mega_pcg_reference(*args, **k5_kw)
        sync()
        print(f"K5 at rho {rho0:g}: pcg iters {out.pcg_iters.tolist()} vs "
              f"{ref.pcg_iters.tolist()}, accepted {out.accepted.tolist()} "
              f"vs {ref.accepted.tolist()}, sqp_iters {int(out.sqp_iters)} "
              f"vs {int(ref.sqp_iters)}, bailed {bool(out.bailed)} vs "
              f"{bool(ref.bailed)}, lam err "
              f"{_max_err([(out.lam, ref.lam)]):.3e}")
        for f in ("accepted", "sqp_iters", "bailed"):
            if not torch.equal(getattr(out, f), getattr(ref, f)):
                raise AssertionError(f"K5 at rho {rho0:g}: {f} differs from "
                                     f"the plain version")
        if int((out.pcg_iters - ref.pcg_iters).abs().max()) > 2:
            raise AssertionError(f"K5 at rho {rho0:g}: CG iteration counts "
                                 f"differ by more than 2")
        err = max(checked(f"K5 X, U at rho {rho0:g}",
                          [(out.X, ref.X), (out.U, ref.U)], 1e-3, 1e-5),
                  checked(f"K5 lam at rho {rho0:g}", [(out.lam, ref.lam)],
                          lam_rtol, lam_atol))
        return args, out, ref, err

    # at the slice's rho every CG stops at the cap, on a system of
    # condition ~1e7 where two float32 CG loops summing in different orders
    # part by up to 5.4e-4 in lam: lam at atol 1e-3
    k5_args, k5_out, _, err5 = k5_pair(cfg.rho_init, 0, 1e-3)
    # at rhos the schedule reaches after rejected steps the CGs exit before
    # the cap, the exit every block must take alike: lam at the JAX
    # megakernel test's rtol 1e-3, atol 1e-4
    for rho_early in (0.1, 0.3):
        _, _, ref, err = k5_pair(rho_early, 1e-3, 1e-4)
        its = ref.pcg_iters
        if not bool(((its >= 0) & (its < cap)).any()):
            raise AssertionError(f"K5 at rho {rho_early:g}: no CG exited "
                                 f"before the cap")
        err5 = max(err5, err)
    run_its = [int(i) for i in k5_out.pcg_iters.tolist() if i >= 0]
    record("K5", "sqp_solve_mega_pcg", "mpcgpu_tpu_torch/csrc/sqp_mega.cu",
           "mpcgpu_tpu/ops/pallas/sqp_megakernel.py:1027", err5,
           lambda: k5.sqp_solve_mega_pcg(*k5_args, **k5_kw),
           lambda: k5.sqp_solve_mega_pcg_reference(*k5_args, **k5_kw),
           sum(n * OPS_K3_KNOT + _cg_ops(n, i, _spmv_ops(n)) + _dz_ops(n)
               + _merits_ops(n, cfg.num_alphas) for i in run_its),
           F32 * (2 * (2 * n * NX + (n - 1) * NU) + n * 6 + NX + TAB + 2
                  + 3) + 4 * (2 + 3 * SQP_ITERS))

    # K10: two arms, K5's perturbed start and a second seeded one, cold
    # duals, each held against the plain version and, for the shared CG
    # exit, each arm solved alone by K5's plain version
    b = ARMS
    Xb = torch.stack([Xp, perturbed(6)])
    Ub = U.expand(b, n - 1, NU).contiguous()
    goals_b = goals.expand((b,) + goals.shape)
    xs_b = xs.expand(b, NX).contiguous()
    lam0_b = torch.zeros(b, n, NX, device=dev)
    merit0_b = [k2.line_search_merits_reference(
        model, Xb[a], U, torch.zeros_like(Xp), torch.zeros_like(U),
        cfg.num_alphas, goals, xs, cfg.timestep, cfg.merit_mu, cc.qd_cost,
        cc.r_cost, cfg.gravity)[cfg.num_alphas] for a in range(b)]

    def k10_pair(rhos, lam_rtol, lam_atol):
        """K10 and its plain version at per-arm rhos: X, U at rtol 1e-3,
        atol 1e-5, sqp_iters, bails and the shared CG count equal; returns
        the lone arms' CG totals too."""
        args = (model, Xb, Ub, goals_b, xs_b, lam0_b,
                torch.tensor(rhos, device=dev), torch.ones(b, device=dev),
                cap, tol, SQP_ITERS)
        out = k10.sqp_solve_mega_pcg_packed(*args, **k5_kw)
        ref = k10.sqp_solve_mega_pcg_packed_reference(*args, **k5_kw)
        alone = [k5.sqp_solve_mega_pcg_reference(
            model, Xb[a], U, goals, xs, lam0, torch.tensor(rhos[a], device=dev),
            1.0, merit0_b[a], cap, tol, SQP_ITERS, **k5_kw).pcg_iters
            for a in range(b)]
        sync()
        alone = [int(i.clamp(min=0).sum()) for i in alone]
        print(f"K10 at rhos {rhos}: sqp_iters {out.sqp_iters.tolist()} vs "
              f"{ref.sqp_iters.tolist()}, bailed {out.bailed.tolist()} vs "
              f"{ref.bailed.tolist()}, shared CG total "
              f"{int(out.pcg_iters_total)} vs {int(ref.pcg_iters_total)} "
              f"(each arm alone: {alone}), lam err "
              f"{_max_err([(out.lam, ref.lam)]):.3e}")
        for f in ("sqp_iters", "bailed", "pcg_iters_total"):
            if not torch.equal(getattr(out, f), getattr(ref, f)):
                raise AssertionError(f"K10 at rhos {rhos}: {f} differs from "
                                     f"the plain version")
        err = max(checked(f"K10 X, U at rhos {rhos}",
                          [(out.X, ref.X), (out.U, ref.U)], 1e-3, 1e-5),
                  checked(f"K10 lam at rhos {rhos}", [(out.lam, ref.lam)],
                          lam_rtol, lam_atol))
        return args, out, alone, err

    # K10's first launches: the cluster form at every cluster size the card
    # admits for these arms, and the one-block form, under the watchdog,
    # each against the plain version: decisions equal, X and U at rtol
    # 1e-3, atol 1e-4 and lam at atol 1e-3 (phase 10's tolerances for K5's
    # cluster forms at rho 1e-3, where every CG stops at the cap)
    tab = _lib.model_tables(model)
    first_args = (Xb, Ub, goals_b, xs_b, lam0_b,
                  torch.full((b,), cfg.rho_init, device=dev),
                  torch.ones(b, device=dev), cap, tol, SQP_ITERS)
    first_ref = k10.sqp_solve_mega_pcg_packed_reference(model, *first_args,
                                                        **k5_kw)
    for c in (16, 8, 4, 2, -1):
        try:
            plan = k10.packed_plan(n, b, cfg.num_alphas, lib, c)
        except ValueError:
            print(f"K10 first launch: no plan for cluster {c}")
            continue
        with _watchdog(FIRST_LAUNCH_DEADLINE):
            out = k10._launch_packed(lib, tab, *first_args, grid=plan.grid,
                                     stream=_lib.stream_of(Xb),
                                     cluster=plan.cluster, stair=plan.stair,
                                     **k5_kw)
            sync()
        label = f"K10 first launch, plan {tuple(plan)}"
        if int(k10.sqp_solve_mega_pcg_packed.cluster_size) != plan.cluster:
            raise AssertionError(f"{label}: the kernel read cluster size "
                                 f"{int(k10.sqp_solve_mega_pcg_packed.cluster_size)}")
        for f in ("sqp_iters", "bailed", "pcg_iters_total"):
            if not torch.equal(getattr(out, f), getattr(first_ref, f)):
                raise AssertionError(f"{label}: {f} differs from the plain "
                                     f"version")
        err_xu = checked(f"{label} X, U", [(out.X, first_ref.X),
                                           (out.U, first_ref.U)], 1e-3, 1e-4)
        err_lam = checked(f"{label} lam", [(out.lam, first_ref.lam)], 0, 1e-3)
        print(f"{label}: max error {err_xu:.3e} (X, U), {err_lam:.3e} (lam)")
    # the cold start of K5's check, every CG at the cap: lam at atol 1e-3
    k10_args, k10_out, _, err10 = k10_pair((cfg.rho_init,) * b, 0, 1e-3)
    # rhos where the CGs exit before the cap: lam at rtol 1e-3, atol 1e-4
    shared_decided = False
    for rhos in ((0.1, 0.3), (0.3, 0.1)):
        _, out, alone, err = k10_pair(rhos, 1e-3, 1e-4)
        err10 = max(err10, err)
        shared_decided |= min(alone) < int(out.pcg_iters_total)
    if not shared_decided:
        raise AssertionError("K10: no arm alone left the CG before the pack: "
                             "the shared exit was never exercised")
    # K10 with one arm on K5's cold start runs K5's CG iterations in one
    # block, with a grid barrier after each (the shared exit); K5 runs them
    # across a cluster: the difference per CG iteration is the cluster's
    # gain plus the shared exit's cost
    b1_args = (model, Xp[None], U[None], goals[None], xs[None], lam0[None],
               torch.tensor([cfg.rho_init], device=dev),
               torch.ones(1, device=dev), cap, tol, SQP_ITERS)
    b1 = k10.sqp_solve_mega_pcg_packed(*b1_args, **k5_kw)
    b1_ms = _event_ms(lambda: k10.sqp_solve_mega_pcg_packed(*b1_args,
                                                            **k5_kw))
    k5_ms = next(k["ms"] for k in kernels if k["name"].startswith("K5 "))
    b1_its = int(b1.pcg_iters_total)
    barrier_us = 1e3 * (b1_ms - k5_ms) / b1_its
    print(f"K10 with one arm on K5's start: {b1_ms:.4f} ms per call, "
          f"{b1_its} CG iterations, against the cluster K5's {k5_ms:.4f} "
          f"ms, {sum(run_its)}: {barrier_us:.2f} us more per CG iteration")
    # operations: per arm K5's at the shared CG count (every arm steps it),
    # over SQP_ITERS solves of the CG, plus the incumbent merit
    tot10 = int(k10_out.pcg_iters_total)
    cg10 = _cg_ops(n, tot10, _spmv_ops(n)) + (SQP_ITERS - 1) * 2 * _spmv_ops(n)
    record("K10", "sqp_solve_mega_pcg_packed",
           "mpcgpu_tpu_torch/csrc/sqp_mega_packed.cu",
           "mpcgpu_tpu/ops/pallas/sqp_megakernel.py:843", err10,
           lambda: k10.sqp_solve_mega_pcg_packed(*k10_args, **k5_kw),
           lambda: k10.sqp_solve_mega_pcg_packed_reference(*k10_args, **k5_kw),
           b * (SQP_ITERS * (n * OPS_K3_KNOT + _dz_ops(n)
                             + _merits_ops(n, cfg.num_alphas))
                + cg10 + _merits_ops(n, 1)),
           F32 * (2 * b * (2 * n * NX + (n - 1) * NU) + n * 6 + b * NX + TAB
                  + 4 * b) + 4 * (2 * b + 1),
           arms=b, grid=k10.packed_plan(n, b, cfg.num_alphas, lib).grid,
           one_arm_ms=b1_ms, us_per_cg_iter_over_cluster_k5=barrier_us)

    # ---- the kernels of the remaining sqp_solve configurations
    def residual_pair(label, ks_sys, got_lam, plain_lam):
        """The exact solvers on the slice's systems (condition ~1e7) are
        held by relative residual: the kernel's within 2x of the plain
        solve's."""
        res = (systems.relative_residual(ks_sys, got_lam),
               systems.relative_residual(ks_sys, plain_lam))
        print(f"{label}: relative residual kernel {res[0]:.3e} plain "
              f"{res[1]:.3e}")
        if not res[0] <= 2 * res[1]:
            raise AssertionError(f"{label}: the kernel's relative residual "
                                 f"{res[0]:.3e} is over twice the plain "
                                 f"solve's {res[1]:.3e}")
        return res

    def tight_bcr(label, got, want):
        """tests/test_bcr.py:62-74 on a well-conditioned system: lam scaled
        by its largest entry at atol 2e-5, dz at rtol 1e-3, atol 2e-4."""
        whole = isinstance(got, tuple)   # (lam, dX, dU, ...) or lam
        lam_g, lam_w = (got[0], want[0]) if whole else (got, want)
        scale = lam_w.abs().max()
        checked(f"{label} lam/max|lam|", [(lam_g / scale, lam_w / scale)], 0,
                2e-5)
        err = _max_err([(lam_g, lam_w)])
        if whole:
            err = max(err, checked(f"{label} dz", list(zip(got[1:3], want[1:3])),
                                   1e-3, 2e-4))
        return err

    # K4b: K4's CG without the dz, on K3's system (the "pcg_pallas" solve)
    S_ref = BlockTri(ks_ref.SL, ks_ref.SD, ks_ref.SU)
    P_ref = BlockTri(ks_ref.PL, ks_ref.PD, ks_ref.PU)
    k4b_args = (S_ref, P_ref, ks_ref.gamma, lam0, cap, tol)
    with _watchdog(FIRST_LAUNCH_DEADLINE):
        k4b_out = k4.pcg_solve(*k4b_args)
        sync()
    k4b_ref = k4.pcg_solve_reference(*k4b_args)
    it, it_ref = int(k4b_out[1]), int(k4b_ref[1])
    print(f"K4b CG iterations: kernel {it} (hit {bool(k4b_out[2])}), plain "
          f"{it_ref} (hit {bool(k4b_ref[2])})")
    if not (abs(it - it_ref) <= 2 or it == it_ref == cap):
        raise AssertionError(f"K4b iteration counts disagree: {it} vs "
                             f"{it_ref}")
    record("K4b", "pcg_solve", "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
           "mpcgpu_tpu/ops/pallas/pcg_kernel.py:187",
           checked("K4b", [(k4b_out[0], k4b_ref[0])], 5e-3, 5e-3),
           lambda: k4.pcg_solve(*k4b_args),
           lambda: k4.pcg_solve_reference(*k4b_args),
           _cg_ops(n, it, _spmv_ops(n)),
           F32 * (6 * n * NX * NX + 3 * n * NX) + 5)

    # K7 and K7s: tight on the seeded random system, by residual on the
    # slice's K3 system without the stair (ks_np, the perturbed start); the
    # first K7 launch under the watchdog
    with _watchdog(FIRST_LAUNCH_DEADLINE):
        k7_out = k7.bcr_dz(ks_rand)
        sync()
    k7_ref = k7.bcr_dz_reference(ks_rand)
    sync()
    if int(k7_out[3]) != 0 or bool(k7_out[4]):
        raise AssertionError("K7 reports CG iterations")
    err7 = tight_bcr("K7 random system", k7_out, k7_ref)
    res7 = residual_pair("K7 slice system", ks_np, k7.bcr_dz(ks_np)[0],
                         k7.bcr_dz_reference(ks_np)[0])
    record("K7", "bcr_dz", "mpcgpu_tpu_torch/csrc/bcr_dz.cu",
           "mpcgpu_tpu/ops/pallas/bcr_kernel.py:318", err7,
           lambda: k7.bcr_dz(ks_np), lambda: k7.bcr_dz_reference(ks_np),
           *_k7_work(n)[::-1], residual=res7[0], residual_plain=res7[1])

    def k7s_pair(ks_sys):
        # the cluster kernel's first launches under the watchdog
        with _watchdog(FIRST_LAUNCH_DEADLINE):
            out = k7.bcr_solve(ks_sys.SL, ks_sys.SD, ks_sys.SU, ks_sys.gamma)
            sync()
        ref = k7.bcr_solve_reference(ks_sys.SL, ks_sys.SD, ks_sys.SU,
                                     ks_sys.gamma)
        sync()
        return out, ref

    def chol_ms_of(ks_sys):
        """K7s's library yardstick: torch.linalg.cholesky + cholesky_solve
        on the dense S, the same function on the same inputs."""
        dense = to_dense(BlockTri(ks_sys.SL, ks_sys.SD, ks_sys.SU))
        g_col = ks_sys.gamma.reshape(-1, 1)
        return _event_ms(lambda: torch.cholesky_solve(
            g_col, torch.linalg.cholesky(dense)))

    err7s = tight_bcr("K7s random system", *k7s_pair(ks_rand))
    errs7s = {}
    for n_long in K7S_KNOTS:
        ks_long = systems.random_knot_schur(n_long, device=dev)
        errs7s[f"max_abs_err_n{n_long}"] = tight_bcr(
            f"K7s random system, N = {n_long}", *k7s_pair(ks_long))
        if n_long in K7S_LIBRARY_KNOTS:
            S_l = (ks_long.SL, ks_long.SD, ks_long.SU)
            errs7s[f"ms_n{n_long}"] = _event_ms(
                lambda: k7.bcr_solve(*S_l, ks_long.gamma))
            errs7s[f"library_ms_n{n_long}"] = chol_ms_of(ks_long)
            print(f"K7s N = {n_long}: kernel {errs7s[f'ms_n{n_long}']:.4f} ms, "
                  f"library yardstick (the dense Cholesky pair, "
                  f"{n_long * NX} x {n_long * NX}) "
                  f"{errs7s[f'library_ms_n{n_long}']:.4f} ms")
    res7s = residual_pair("K7s slice system", ks_np, *k7s_pair(ks_np))
    S_np = BlockTri(ks_np.SL, ks_np.SD, ks_np.SU)
    chol_ms = chol_ms_of(ks_np)
    print(f"K7s library yardstick: torch.linalg.cholesky + cholesky_solve on "
          f"the dense S ({n * NX} x {n * NX}): {chol_ms:.4f} ms")
    record("K7s", "bcr_solve", "mpcgpu_tpu_torch/csrc/bcr_dz.cu",
           "mpcgpu_tpu/ops/pallas/bcr_kernel.py:361", err7s,
           lambda: k7.bcr_solve(*S_np, ks_np.gamma),
           lambda: k7.bcr_solve_reference(*S_np, ks_np.gamma),
           _bcr_factor_ops(n) + _bcr_apply_ops(n),
           F32 * (3 * n * NX * NX + 2 * n * NX),
           library_ms=chol_ms, residual=res7s[0], residual_plain=res7s[1],
           **errs7s)

    # the split paths at N = 64, forced, against K7 and K6 (random system)
    tight_bcr("split bcr_dz (K7s, residual, K7s) vs K7",
              k7.bcr_dz(ks_rand, split=True), k7_out)
    split6 = k6.bcr_pcg_dz(ks_rand, lam0, cap, tol, split=True)
    sync()
    tight_bcr("split bcr_pcg_dz (CG glue, K7s applies) vs K6", split6, k6_out)
    print(f"split bcr_pcg_dz: {int(split6[3])} CG iterations, K6 "
          f"{int(k6_out[3])}")
    if abs(int(split6[3]) - int(k6_out[3])) > 1:
        raise AssertionError("split bcr_pcg_dz: CG counts differ from K6's")

    # K9p: one iteration from K5's perturbed start, cold duals
    one = torch.tensor(1.0, device=dev)

    def k9p_pair(rho0, lam_rtol, lam_atol):
        args = (model, Xp, U, goals, xs, lam0, torch.tensor(rho0, device=dev),
                one, merit0, cap, tol)
        with _watchdog(FIRST_LAUNCH_DEADLINE):
            out = k9.sqp_iter_mega_pcg(*args, **k5_kw)
            sync()
        ref = k9.sqp_iter_mega_pcg_reference(*args, **k5_kw)
        sync()
        print(f"K9p at rho {rho0:g}: CG {int(out.pcg_iters)} vs "
              f"{int(ref.pcg_iters)}, accept {bool(out.accept)} vs "
              f"{bool(ref.accept)}, bail {bool(out.bail)} vs "
              f"{bool(ref.bail)}, lam err {_max_err([(out.lam, ref.lam)]):.3e}")
        for f in ("accept", "bail"):
            if not torch.equal(getattr(out, f), getattr(ref, f)):
                raise AssertionError(f"K9p at rho {rho0:g}: {f} differs")
        if abs(int(out.pcg_iters) - int(ref.pcg_iters)) > 2:
            raise AssertionError(f"K9p at rho {rho0:g}: CG counts differ by "
                                 f"more than 2")
        err = max(checked(f"K9p X, U at rho {rho0:g}",
                          [(out.X, ref.X), (out.U, ref.U)], 1e-3, 1e-5),
                  checked(f"K9p lam at rho {rho0:g}", [(out.lam, ref.lam)],
                          lam_rtol, lam_atol))
        return args, out, err

    k9p_args, k9p_out, err9p = k9p_pair(cfg.rho_init, 0, 1e-3)
    for rho_early in (0.1, 0.3):
        err9p = max(err9p, k9p_pair(rho_early, 1e-3, 1e-4)[2])

    # four K9p launches (sqp.iterate's masked loop) against one K5 launch
    # from the same start: the JAX package finds its whole-solve and
    # per-iteration kernels equal to about 1e-5 with identical decisions
    def k9p_step(Xc, Uc, lamc, rhoc, drhoc, meritc):
        return k9.sqp_iter_mega_pcg(model, Xc, Uc, goals, xs, lamc, rhoc,
                                    drhoc, meritc, cap, tol, **k5_kw)

    (Xi, Ui, lami, _, _, _, itsi, bailedi, pcgi, _, acci) = iterate(
        Xp, U, lam0, torch.tensor(cfg.rho_init, device=dev), one, merit0,
        SQP_ITERS, k9p_step)
    sync()
    print(f"K9p x {SQP_ITERS} vs K5: pcg iters {pcgi.tolist()} vs "
          f"{k5_out.pcg_iters.tolist()}, accepted {acci.tolist()} vs "
          f"{k5_out.accepted.tolist()}, X err {_max_err([(Xi, k5_out.X)]):.3e}")
    if not (torch.equal(acci, k5_out.accepted)
            and torch.equal(itsi, k5_out.sqp_iters)
            and torch.equal(bailedi, k5_out.bailed)):
        raise AssertionError("K9p x 4 and K5 take different decisions")
    if int((pcgi - k5_out.pcg_iters).abs().max()) > 2:
        raise AssertionError("K9p x 4 and K5: CG counts differ by more than 2")
    checked("K9p x 4 vs K5 X, U", [(Xi, k5_out.X), (Ui, k5_out.U)], 1e-3, 1e-5)
    checked("K9p x 4 vs K5 lam", [(lami, k5_out.lam)], 0, 1e-3)
    # the same body with the same cluster size, sums that do not depend on
    # the grid: bit for bit
    if not all(torch.equal(a, b) for a, b in ((Xi, k5_out.X), (Ui, k5_out.U),
                                              (lami, k5_out.lam),
                                              (pcgi, k5_out.pcg_iters))):
        raise AssertionError(f"{SQP_ITERS} K9p launches and one K5 launch "
                             f"are not bit-equal")
    print(f"{SQP_ITERS} K9p launches bit-equal to one K5 launch at N = {n}")
    it9 = int(k9p_out.pcg_iters)
    iter_bytes = F32 * (2 * (2 * n * NX + (n - 1) * NU) + 6 * n + NX + TAB
                        + 6) + 20
    record("K9p", "sqp_iter_mega_pcg", "mpcgpu_tpu_torch/csrc/sqp_mega.cu",
           "mpcgpu_tpu/ops/pallas/sqp_megakernel.py:960", err9p,
           lambda: k9.sqp_iter_mega_pcg(*k9p_args, **k5_kw),
           lambda: k9.sqp_iter_mega_pcg_reference(*k9p_args, **k5_kw),
           n * OPS_K3_KNOT + _cg_ops(n, it9, _spmv_ops(n)) + _dz_ops(n)
           + _merits_ops(n, cfg.num_alphas), iter_bytes,
           grid=k9.check_mega_fit(n, kind=k9.ITER_PCG))

    # K9b: one iteration with the refined BCR; its solve by residual, the
    # stages after it against the plain iteration given the kernel's lam
    k9b_args = (model, Xp, U, goals, xs, torch.tensor(cfg.rho_init,
                                                      device=dev), one, merit0)
    with _watchdog(FIRST_LAUNCH_DEADLINE):   # its stage 4 across a cluster
        k9b_out = k9.sqp_iter_mega(*k9b_args, **k5_kw)
        sync()
    k9b_ref = k9.sqp_iter_mega_reference(*k9b_args, **k5_kw)
    sync()
    for f in ("accept", "bail"):
        if not torch.equal(getattr(k9b_out, f), getattr(k9b_ref, f)):
            raise AssertionError(f"K9b: {f} differs from the plain iteration")
    if int(k9b_out.pcg_iters) != 0 or bool(k9b_out.hit_max):
        raise AssertionError("K9b reports CG iterations")
    given, ks_b = systems.bcr_iteration_given_lam(*k9b_args, k9b_out.lam,
                                                  **k5_kw)
    res9b = residual_pair("K9b lam", ks_b, k9b_out.lam, k9b_ref.lam)
    err9b = checked("K9b X, U, merit against the plain iteration given its "
                    "lam", [(k9b_out.X, given.X), (k9b_out.U, given.U),
                            (k9b_out.merit, given.merit)], 1e-3, 2e-4)
    err9b_plain = _max_err([(k9b_out.X, k9b_ref.X), (k9b_out.U, k9b_ref.U)])
    print(f"K9b: accept {bool(k9b_out.accept)}, X, U against the "
          f"independent plain iteration within {err9b_plain:.3e}")
    k5_ms = next(k["ms"] for k in kernels if k["name"].startswith("K5 "))
    record("K9b", "sqp_iter_mega", "mpcgpu_tpu_torch/csrc/sqp_mega.cu",
           "mpcgpu_tpu/ops/pallas/sqp_megakernel.py:901", err9b,
           lambda: k9.sqp_iter_mega(*k9b_args, **k5_kw),
           lambda: k9.sqp_iter_mega_reference(*k9b_args, **k5_kw),
           _k3_no_stair_ops(n) + _bcr_factor_ops(n) + 2 * _bcr_apply_ops(n)
           + _spmv_ops(n) + _dz_ops(n) + _merits_ops(n, cfg.num_alphas),
           iter_bytes - F32 * n * NX,
           grid=k9.check_mega_fit(n, kind=k9.ITER_BCR),
           max_abs_err_vs_plain=err9b_plain, residual=res9b[0],
           residual_plain=res9b[1], k5_ms_per_iteration=k5_ms / SQP_ITERS)
    k9b_ms = kernels[-1]["ms"]
    print(f"K9b {k9b_ms:.4f} ms per launch against K5's {k5_ms:.4f} ms for "
          f"{SQP_ITERS} iterations ({k5_ms / SQP_ITERS:.4f} ms each)")

    # ---- 4. the closed loops, through the kernels and the plain modules
    xu_d = torch.as_tensor(xu, device=dev)
    ee_d = torch.as_tensor(ee, device=dev)

    def warm_lam(run_cfg, start):
        Xs, Us, goals_s, xs_s = start
        lam = torch.zeros_like(Xs)
        r0 = torch.tensor(cfg.rho_init, device=dev)
        for _ in range(WARM_SOLVES):      # warm-start lam (bench.py:161-176)
            res = sqp_solve(model, run_cfg, Xs, Us, lam, goals_s, xs_s, r0,
                            1e-11)
            lam, r0 = res.lam, res.rho
        return lam

    form_counts = {}

    def counted(label, run, want):
        """Run once with every launch count set to 0 just before; check
        and return the counts read just after (each form's of K10 kept in
        form_counts[label])."""
        sync()
        reset_launch_counts()
        out = run()
        sync()
        counts = launch_counts()
        form_counts[label] = form_launch_counts()["K10"]
        print(f"{label}: launches {counts}, K10's forms "
              f"{form_counts[label]}")
        if want is not None and counts != want:
            raise AssertionError(f"{label}: launch counts {counts}, expected "
                                 f"{want}")
        return out, counts

    def host_and_device(label, again, n_updates, counts, profile=True):
        """The host clock per update, then (profile) the device breakdown
        of a call that makes counts' launches: (_by_kernel's groups,
        complete)."""
        sync()
        t0 = time.perf_counter()
        again()
        t_enqueue = time.perf_counter() - t0
        sync()
        t_wall = time.perf_counter() - t0
        print(f"{label} host clock: enqueue "
              f"{1e3 * t_enqueue / n_updates:.3f} ms/update, to the end "
              f"of the device work {1e3 * t_wall / n_updates:.3f} "
              f"ms/update")
        return (_device_breakdown(again, n_updates, counts) if profile
                else ({}, True))

    start64 = (X, U, goals, xs)

    def run_loop(label, run_cfg, linsys, want=None, detail=False,
                 n_updates=N_UPDATES, start=start64, warm=True, exit_tol=tol,
                 traj=(xu_d, ee_d)):
        """One closed loop from start (X, U, goals, xs) along traj (the
        fixture's rows), lam warm-started or zero: launch counts, the host
        clock and device breakdown when detail (detail="host": the host
        clock only), and a summary."""
        Xs, Us = start[:2]
        xu_t, ee_t = traj
        lam = warm_lam(run_cfg, start) if warm else torch.zeros_like(Xs)
        simulate_mpc_scan(model, run_cfg, xu_t, ee_t, Xs, Us, lam, rho,
                          exit_tol, 2, linsys)
        out, counts = counted(label, lambda: simulate_mpc_scan(
            model, run_cfg, xu_t, ee_t, Xs, Us, lam, rho, exit_tol, n_updates,
            linsys, timing=True), want)

        def again():
            return simulate_mpc_scan(model, run_cfg, xu_t, ee_t, Xs, Us, lam,
                                     rho, exit_tol, n_updates, linsys)

        groups, complete = host_and_device(
            label, again, n_updates, counts,
            detail != "host") if detail else ({}, True)
        errs = out["tracking_errors"]
        if tuple(errs.shape) != (n_updates,) or not torch.isfinite(errs).all():
            raise AssertionError(f"{label}: tracking errors not finite: {errs}")
        if not torch.isfinite(out["final_xs"]).all():
            raise AssertionError(f"{label}: final state not finite")
        shifted = out["shifted"].to(dev)
        summary = {
            "mean_err_m": float(errs.mean()),
            "mean_err_at_shifts_m": float(errs[shifted].mean()),
            "n_shifts": int(shifted.sum()),
            "update_ms_median": statistics.median(out["update_ms"]),
            "sqp_iters": out["sqp_iters"].tolist(),
            "pcg_iters_total": out["pcg_iters_total"].tolist(),
            "rho_bailed": int(out["rho_bailed"].sum()),
        }
        if "failed_over" in out:
            summary["failed_over"] = out["failed_over"].tolist()
        if groups:
            summary["device_ms_per_update"] = {
                k: t / 1e3 / n_updates for k, (t, _) in groups.items()}
            summary["profile_complete"] = complete
        print(f"{label}: {json.dumps(summary)}")
        return summary, counts

    def compare(label, fused, plain, bound=True):
        # sqp_iters and rho bails must match; the CG totals are printed,
        # not compared: on fixture 0_0's condition ~1e7 systems the float32
        # trajectories part after some updates (PERF.md).  The exact-dual
        # backends track worse by design (about 0.32 m on 0_0 over a long
        # run in the JAX package), so they are held to their pair only.
        for key in ("sqp_iters", "rho_bailed"):
            if fused[key] != plain[key]:
                raise AssertionError(f"{label} {key}: fused {fused[key]} vs "
                                     f"plain {plain[key]}")
        for key in ("mean_err_m", "mean_err_at_shifts_m"):
            a, b = fused[key], plain[key]
            if bound and not (a < 0.1 and b < 0.1):
                raise AssertionError(f"{label} {key} not under 0.1 m: fused "
                                     f"{a}, plain {b}")
            if abs(a - b) > 5e-3:
                raise AssertionError(f"{label} {key}: fused {a} vs plain {b} "
                                     f"differ by more than 5e-3 m")

    plain_cfg = dataclasses.replace(cfg, fused_stages=False)
    u, s = N_UPDATES, SQP_ITERS
    none = dict.fromkeys(launch_counts(), 0)
    k4_kid = lambda n_k, dz=True: (
        ("K4" if dz else "K4b") if k4.pcg_plan(n_k, dz=dz).form == k4.CLUSTER
        else ("K4g" if dz else "K4bg"))
    staged, staged_counts = run_loop(
        "staged pcg, fused", cfg, "pcg", detail=True,
        want={**none, "K1": u, "K2": u + u * s, "K3": u * s,
              k4_kid(n): u * s})
    compare("staged pcg", staged, run_loop("staged pcg, plain", plain_cfg,
                                           "pcg")[0])

    mega_cfg = dataclasses.replace(cfg, megakernel=True,
                                   megakernel_solve=True)
    auto, auto_counts = run_loop(
        "auto, fused", mega_cfg, "auto", detail=True,
        want={**none, "K1": u, "K2": u, "K5": u})
    auto_plain = run_loop("auto, plain", plain_cfg, "auto")[0]
    compare("auto", auto, auto_plain)
    for label, sm in (("fused", auto), ("plain", auto_plain)):
        if any(sm["failed_over"]):
            raise AssertionError(f"auto, {label}: the latch tripped on 0_0")

    trip = dict(failover_bail_rate=-1.0, failover_err_threshold_m=-1.0,
                failover_check_every=8)
    half = u // 2
    fo, fo_counts = run_loop(
        "forced failover, fused", dataclasses.replace(mega_cfg, **trip),
        "auto", detail=True,
        want={**none, "K1": u, "K2": half + half * (1 + s), "K3": half * s,
              "K5": half, "K6": half * s})
    fo_plain = run_loop("forced failover, plain",
                        dataclasses.replace(plain_cfg, **trip), "auto")[0]
    compare("forced failover", fo, fo_plain)
    for label, sm in (("fused", fo), ("plain", fo_plain)):
        if sm["failed_over"] != [False] * half + [True] * half:
            raise AssertionError(f"forced failover, {label}: failed_over "
                                 f"{sm['failed_over']}")

    # ---- 5. the multi-arm loops: the arms start from seeded perturbations
    # of the fixture start's joint positions, with the warm duals
    lam_w = warm_lam(mega_cfg, start64)
    dq = torch.as_tensor(0.02 * np.random.default_rng(11).normal(
        size=(max(SWEEP_ARMS), NX // 2)), dtype=torch.float32, device=dev)

    def run_packed(label, run_cfg, arms, n_updates, want=None,
                   detail=False):
        Xs, Us, lams = arm_starts(X, U, lam_w, dq[:arms])

        def again(n_up=n_updates, timing=False):
            return simulate_mpc_scan_packed(model, run_cfg, xu_d, ee_d, Xs,
                                            Us, lams, cfg.rho_init, tol, n_up,
                                            timing=timing)

        again(2)
        out, counts = counted(label, lambda: again(timing=True), want)
        errs = out["tracking_errors"]
        if (tuple(errs.shape) != (arms, n_updates)
                or not torch.isfinite(errs).all()
                or not torch.isfinite(out["final_xs"]).all()):
            raise AssertionError(f"{label}: tracking errors or final states "
                                 f"not finite: {errs}")
        shifted = out["shifted"].to(dev)
        summary = {
            "mean_err_m": errs.mean(1).tolist(),
            "mean_err_at_shifts_m": errs[:, shifted].mean(1).tolist(),
            "update_ms_median": statistics.median(out["update_ms"]),
            "sqp_iters": out["sqp_iters"].tolist(),
            "pcg_iters_total": out["pcg_iters_total"].tolist(),
            "rho_bailed": out["rho_bailed"].sum(1).tolist(),
        }
        print(f"{label}: {json.dumps(summary)}")
        if detail:
            groups, complete = host_and_device(label, again, n_updates,
                                               counts)
            t, calls = groups.get("K10", (0.0, 0))
            summary["profile_complete"] = complete
            summary["k10_device_ms"] = t / 1e3 / calls if calls else None
        return summary, counts, again

    main_packed = f"packed, {ARMS} arms, fused"
    packed, packed_counts, _ = run_packed(
        main_packed, cfg, ARMS, N_UPDATES,
        want={**none, "K1": u, "K10": u}, detail=True)
    if form_counts[main_packed] != {"cluster": u, "one_block": 0}:
        raise AssertionError(f"{main_packed}: K10's forms launched "
                             f"{form_counts[main_packed]}, expected the "
                             f"cluster form {u} times")
    packed_plain = run_packed(f"packed, {ARMS} arms, plain", plain_cfg, ARMS,
                              N_UPDATES, want=none)[0]
    for key in ("sqp_iters", "rho_bailed"):
        if packed[key] != packed_plain[key]:
            raise AssertionError(f"packed {key}: fused {packed[key]} vs "
                                 f"plain {packed_plain[key]}")
    for key in ("mean_err_m", "mean_err_at_shifts_m"):
        for a, (x1, x2) in enumerate(zip(packed[key], packed_plain[key])):
            if not (x1 < 0.1 and x2 < 0.1) or abs(x1 - x2) > 5e-3:
                raise AssertionError(f"packed {key} arm {a}: fused {x1} vs "
                                     f"plain {x2} (each under 0.1 m, within "
                                     f"5e-3 m)")

    Xs, Us, lams = arm_starts(X, U, lam_w, dq[:ARMS])
    simulate_mpc_scan_batched(model, cfg, xu_d, ee_d, Xs, Us, lams,
                              cfg.rho_init, tol, 2)
    batched, _ = counted(
        f"batched, {ARMS} arms (plain modules)",
        lambda: simulate_mpc_scan_batched(
            model, cfg, xu_d, ee_d, Xs, Us, lams, cfg.rho_init, tol,
            BATCHED_UPDATES, timing=True), none)
    errs = batched["tracking_errors"]
    if (tuple(errs.shape) != (ARMS, BATCHED_UPDATES)
            or not torch.isfinite(errs).all()):
        raise AssertionError(f"batched: tracking errors {errs}")
    print(f"batched, {ARMS} arms: update median "
          f"{statistics.median(batched['update_ms']):.3f} ms, mean errors "
          f"{errs.mean(1).tolist()}, sqp_iters "
          f"{batched['sqp_iters'].tolist()}")

    # arm-updates/s of the packed loop over B, and K10's device time
    sweep = []
    for arms in SWEEP_ARMS:
        sm, counts, again = run_packed(
            f"sweep, {arms} arms", cfg, arms, N_UPDATES,
            want={**none, "K1": u, "K10": u})
        # the profiler may drop a record of the cooperative launch (it
        # showed 15 of 16 once); the time per call is over those it kept
        t, calls = _by_kernel(_device_events(again)).get("K10", (0.0, 0))
        if not calls:
            raise AssertionError(f"sweep, {arms} arms: the profile shows no "
                                 f"K10 kernel")
        row = {"metric": f"iiwa_mpc_batched_throughput_n{n}_b{arms}",
               "arms": arms,
               "arm_updates_per_s": arms * 1e3 / sm["update_ms_median"],
               "update_ms_median": sm["update_ms_median"],
               "k10_device_ms": t / 1e3 / calls, "k10_profiled": calls,
               "cg_iters_per_update": statistics.mean(sm["pcg_iters_total"]),
               "grid": k10.packed_plan(n, arms, cfg.num_alphas, lib).grid}
        print(f"sweep: {json.dumps(row)}")
        sweep.append(row)

    # ---- 6. the remaining sqp_solve configurations, 8 updates each
    u8 = NEW_UPDATES
    bcr_fused, bcr_counts = run_loop(
        "staged bcr, fused", cfg, "bcr", detail=True, n_updates=u8,
        want={**none, "K1": u8, "K2": u8 + u8 * s, "K3": u8 * s,
              "K7": u8 * s})
    bcr_plain = run_loop("bcr, plain", plain_cfg, "bcr", n_updates=u8)[0]
    compare("staged bcr", bcr_fused, bcr_plain, bound=False)

    # N = 128, one K7 launch an SQP iteration; the exact solve ignores lam,
    # so no warm start
    start_l = tuple(torch.as_tensor(a, device=dev)
                    for a in horizon_slices(xu, ee, LONG_KNOTS))
    cfg_l = SolverConfig.for_knots(
        LONG_KNOTS, sqp_max_iter=SQP_ITERS, fused_stages=True,
        pcg=PCGConfig(max_iter=PCGConfig.tpu_tuned_max_iter(LONG_KNOTS)))
    long_fused, long_counts_bcr = run_loop(
        f"staged bcr N={LONG_KNOTS}, fused", cfg_l, "bcr", detail=True,
        n_updates=u8, start=start_l, warm=False,
        want={**none, "K1": u8, "K2": u8 + u8 * s, "K3": u8 * s,
              "K7": u8 * s})
    long_plain = run_loop(
        f"bcr N={LONG_KNOTS}, plain", dataclasses.replace(
            cfg_l, fused_stages=False), "bcr", n_updates=u8, start=start_l,
        warm=False)[0]
    compare(f"staged bcr N={LONG_KNOTS}", long_fused, long_plain, bound=False)
    # the same loop with bcr_dz's split path forced (K7s, the residual as
    # tensor glue, K7s: what the loop runs past K7's fit, where K2 and the
    # fixture's loops do not reach): K7s's launches in a closed loop
    with unittest.mock.patch.object(sqp_module, "bcr_dz", functools.partial(
            k7.bcr_dz, split=True)):
        split_fused, split_counts = run_loop(
            f"staged bcr N={LONG_KNOTS}, split path forced", cfg_l, "bcr",
            n_updates=u8, start=start_l, warm=False,
            want={**none, "K1": u8, "K2": u8 + u8 * s, "K3": u8 * s,
                  "K7s": 2 * u8 * s})
    compare(f"staged bcr N={LONG_KNOTS}, split path", split_fused,
            long_plain, bound=False)

    # the per-iteration megakernels: K2, then K9p / K9b per SQP iteration
    iter_cfg = dataclasses.replace(cfg, megakernel=True)
    pcg_plain8 = run_loop("pcg, plain", plain_cfg, "pcg", n_updates=u8)[0]
    k9p_loop, k9p_counts = run_loop(
        "pcg per-iteration megakernel, fused", iter_cfg, "pcg", detail=True,
        n_updates=u8, want={**none, "K1": u8, "K2": u8, "K9p": u8 * s})
    compare("pcg per-iteration megakernel", k9p_loop, pcg_plain8)
    k9b_loop, k9b_counts = run_loop(
        "bcr per-iteration megakernel, fused", iter_cfg, "bcr", detail=True,
        n_updates=u8, want={**none, "K1": u8, "K2": u8, "K9b": u8 * s})
    compare("bcr per-iteration megakernel", k9b_loop, bcr_plain, bound=False)

    # pcg_pallas: the plain stages on the card with K4b as the solve.  The
    # plain-stage loops are host-bound (about 10,000 small glue kernels
    # per update): the host clock only, as profiling them costs minutes
    pp_loop, pp_counts = run_loop(
        "pcg_pallas, plain stages + K4b", plain_cfg, "pcg_pallas",
        detail="host", n_updates=u8,
        want={**none, k4_kid(n, dz=False): u8 * s})
    compare("pcg_pallas", pp_loop, pcg_plain8)

    # the oracles: the dense Cholesky and the host LDL', each against the
    # other
    dense_loop = run_loop("dense, plain stages", plain_cfg, "dense",
                          detail="host", n_updates=u8, want=none)[0]
    qdldl_loop = run_loop("qdldl, plain stages", plain_cfg, "qdldl",
                          detail="host", n_updates=u8, want=none)[0]
    compare("dense vs qdldl", dense_loop, qdldl_loop, bound=False)

    # ---- 7. the linear-solve comparison (the reference's TIME_LINSYS,
    # settings.cuh:109-118): every backend on the slice's warm system
    lam_warm = warm_lam(cfg, start64)
    ks_w = k3.form_kkt_schur(*k3_args)
    S_w = BlockTri(ks_w.SL, ks_w.SD, ks_w.SU)
    P_w = BlockTri(ks_w.PL, ks_w.PD, ks_w.PU)
    sd_w = SchurData(S=S_w, Pinv=P_w, gamma=ks_w.gamma, Qinv=None, Rinv=None)
    solvers = {
        "pcg (K4)": lambda: k4.pcg_dz(ks_w, lam_warm, cap, tol),
        "pcg_pallas (K4b)": lambda: k4.pcg_solve(S_w, P_w, ks_w.gamma,
                                                 lam_warm, cap, tol),
        "bcr (K7)": lambda: k7.bcr_dz(ks_w),
        "bcr_pcg (K6)": lambda: k6.bcr_pcg_dz(ks_w, lam_warm, cap, tol),
        "dense (torch.linalg)": lambda: get_linsys_backend("dense")(
            None, sd_w, lam_warm, tol)}
    compare_rows = {}
    for name, solve in solvers.items():
        out = solve()
        it = out[3] if len(out) == 5 else out[1]
        compare_rows[name] = {
            "ms": _event_ms(solve), "cg_iters": int(it),
            "rel_residual": systems.relative_residual(ks_w, out[0])}
    g_norm = float(ks_w.gamma.norm())

    def median_ms(fn):
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    nb = n * NX * NX
    bands = lambda: torch.cat([ks_w.SD.reshape(-1), ks_w.SU.reshape(-1),
                               ks_w.gamma.reshape(-1)]).cpu().numpy()
    host = bands()
    csc = _btd_upper_csc(None, host[:nb].reshape(n, NX, NX),
                         host[nb:2 * nb].reshape(n, NX, NX))
    g_host = host[2 * nb:].reshape(n, NX)
    solver = _cached_solver(n, NX)
    x_host = solver.solve_csc(*csc, g_host)
    lam_q = torch.as_tensor(x_host, device=dev)
    compare_rows["qdldl (host LDL')"] = {
        "ms": median_ms(lambda: solver.solve_csc(*csc, g_host)),
        "cg_iters": 0, "rel_residual": systems.relative_residual(ks_w, lam_q),
        "d2h_ms": median_ms(bands),
        "assembly_ms": median_ms(lambda: _btd_upper_csc(
            None, host[:nb].reshape(n, NX, NX),
            host[nb:2 * nb].reshape(n, NX, NX))),
        "h2d_ms": median_ms(lambda: (torch.as_tensor(x_host, device=dev),
                                     sync()))}
    # relative residuals are against |gamma|, which is small at the
    # slice's start (a point of the reference trajectory); the absolute
    # residual is rel_residual * gamma_norm
    print(json.dumps({"linsys_compare": {
        "n": n, "system": "fixture 0_0 slice start, warm lam, rho 1e-3",
        "cap": cap, "tol": tol, "gamma_norm": g_norm,
        "solvers": compare_rows}}))

    # ---- 8. long horizons: K3 as the TPU's tiled K8, the grid-CG kernels
    # K4g, K4bg, K5g, K9pg, the cluster K5 and K6 at N = 128-512, and the
    # loops at N = 128-1024
    def long_start(n_l, seed=None):
        """Fixture 0_0's first n_l knots (its rows repeated past the last,
        np.resize), every knot but 0 moved by a seeded 0.02-scale normal
        draw when seed is given."""
        rows = np.resize(np.arange(xu.shape[0]), n_l)
        Xl = xu[rows, :NX].copy()
        if seed is not None:
            pert = 0.02 * np.random.default_rng(seed).normal(size=(n_l, NX))
            pert[0] = 0.0
            Xl = (Xl + pert).astype(np.float32)
        on_card = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                            device=dev)
        return (on_card(Xl), on_card(xu[rows[:-1], NX:]), on_card(ee[rows]),
                on_card(xu[0, :NX]))

    long_cfg = slice_cfg

    def long_system(n_l):
        """(K3's plain system at the perturbed start, cap, exit tol) at
        n_l; at N = 64, K4's check inputs."""
        if n_l == n:
            return ks_ref, cap, tol
        Xl, Ul, gl, xsl = long_start(n_l, seed=0)
        cl = long_cfg(n_l)
        return (k3.form_kkt_schur_reference(
            model, Xl, Ul, gl, xsl, rho, cl.timestep, cl.cost.qd_cost,
            cl.cost.r_cost, cl.gravity), cl.pcg.max_iter,
            default_pcg_exit_tols(n_l)[0])

    # K4's cluster form: the longest horizon it fits and the plan's cut
    # (both bisected: each holds up to an N and not past it)
    def last_knot(holds):
        lo, hi = 2, 1 << 16
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if holds(mid) else (lo, mid)
        return lo

    k4_fit = last_knot(lambda m: k4.pcg_plan(m, form=k4.CLUSTER).form)
    k4_cut = last_knot(lambda m: k4.pcg_plan(m).form == k4.CLUSTER)
    print(f"ceilings: K4 and K4b's cluster form N <= {k4_fit}, the plan's cut "
          f"N <= {k4_cut} (the joined form K4g, K4bg past it, N <= 65536); "
          f"one cluster: K5 N <= {lib.mpc_mega_max_knots(k5.SOLVE_PCG)}, "
          f"K9p N <= {lib.mpc_mega_max_knots(k9.ITER_PCG)}, K6 power-of-2 "
          f"N <= {lib.mpc_bcr_max_knots()}; the grid kinds K5g, K9pg "
          f"N <= {lib.mpc_mega_max_knots(k5.SOLVE_PCG_GRID)}; K9b N <= "
          f"{lib.mpc_mega_max_knots(k9.ITER_BCR)}")
    # K10: its horizon for a pack of ARMS, and the largest pack at N = 64
    # (every arm needs a co-resident cluster, or block, of its own)
    def plan_or_none(n_p, b_p):
        try:
            return k10.packed_plan(n_p, b_p, cfg.num_alphas, lib)
        except ValueError:
            return None

    k10_arms = max((b for b in range(1, 1025) if plan_or_none(n, b)),
                   default=0)
    print(f"ceilings: K10 N <= "
          f"{lib.mpc_mega_packed_max_knots(ARMS, cfg.num_alphas)} at B = "
          f"{ARMS}, B <= {k10_arms} at N = {n}")
    grids = {}
    for n_l in sorted({64, 128, 256, 512, 1024, *LONG_CG_KNOTS,
                       *LONG_MEGA_KNOTS}):
        grids[n_l] = {"K4g": k4.pcg_plan(n_l, form=k4.JOINED).grid,
                      "K4bg": k4.pcg_plan(n_l, dz=False,
                                          form=k4.JOINED).grid,
                      "K5": lib.mpc_mega_grid(n_l, k5.SOLVE_PCG),
                      "K5g": lib.mpc_mega_grid(n_l, k5.SOLVE_PCG_GRID),
                      "K9pg": lib.mpc_mega_grid(n_l, k9.ITER_PCG_GRID)}
        forms = (k4_kid(n_l),
                 "K5" if k5.pcg_kind(n_l) == k5.SOLVE_PCG else "K5g")
        print(f"N = {n_l}: grids {grids[n_l]}; pcg_dz takes {forms[0]}, "
              f"sqp_solve_mega_pcg {forms[1]}")

    # K8: K3 at the tiled kernel's horizons, S's bands per band (entries to
    # 4.5e4, float32 noise 2.5e-2), the other blocks at rtol = atol = 3e-3
    k8_extra, k8_case = {}, None
    for n_l in (2, *LONG_K3_KNOTS):
        label = f"K8 (K3) N = {n_l}" if n_l % 128 == 0 else f"K3 N = {n_l}"
        Xl, Ul, gl, xsl = long_start(n_l, seed=0)
        cl = long_cfg(n_l)
        a = (model, Xl, Ul, gl, xsl, rho, cl.timestep, cl.cost.qd_cost,
             cl.cost.r_cost, cl.gravity)
        got, want = k3.form_kkt_schur(*a), k3.form_kkt_schur_reference(*a)
        sync()
        band_rel = 0.0
        for f in ("SL", "SD", "SU"):
            g, w = getattr(got, f), getattr(want, f)
            rel = float((g - w).abs().max() / w.abs().max())
            if not (torch.isfinite(g).all() and rel <= 1e-5):
                raise AssertionError(f"{label} {f}: max error {rel:.3e} "
                                     f"of the band's largest entry")
            band_rel = max(band_rel, rel)
        rest = [(getattr(got, f), getattr(want, f)) for f in
                k3.KnotSchur._fields if f not in ("SL", "SD", "SU")]
        err = checked(label, rest, 3e-3, 3e-3)
        dev_us = _device_us(lambda: k3.form_kkt_schur(*a), "K3", per_call=3)
        k8_extra[f"device_us_n{n_l}"] = dev_us
        print(f"{label}: S bands within {band_rel:.2e} of their "
              f"largest entry, the rest within {err:.2e}; {_us(dev_us)} of "
              f"device time")
        k8_extra[f"band_rel_err_n{n_l}"] = band_rel
        if n_l == LONG_LOOP_KNOT:
            k8_case = (a, max(err, _max_err(list(zip(got, want)))))
        else:
            k8_extra[f"ms_n{n_l}"] = _event_ms(lambda: k3.form_kkt_schur(*a))
    a, err = k8_case
    n_l = LONG_LOOP_KNOT
    record("K8", "form_kkt_schur_tiled as K3", "mpcgpu_tpu_torch/csrc/kkt_schur.cu",
           "mpcgpu_tpu/ops/pallas/kkt_schur_kernel.py:508", err,
           lambda: k3.form_kkt_schur(*a),
           lambda: k3.form_kkt_schur_reference(*a), n_l * OPS_K3_KNOT,
           F32 * (n_l * NX + (n_l - 1) * NU + n_l * 6 + 1 + TAB
                  + _knot_schur_floats(n_l)), n=n_l, **k8_extra)

    # K4 and K4b in both forms against the plain CG at every horizon of
    # K4_KNOTS (at N = 64 on K4's check inputs), with K4's tolerances: the
    # cluster form (K4, K4b) where it fits and the joined form (K4g, K4bg)
    # in the plan's C, G and place, each form's first launches under the
    # watchdog; and at N = LONG_LOOP_KNOT on the seeded well-conditioned
    # system, where the CG exits before the cap (the exit every block must
    # take alike).  lam, the CG count and the hit against the plain CG; dX
    # and dU against the plain primal step from the kernel's own lam (rtol
    # 1e-3, atol 2e-4, K9b's precedent) and, from N = 16, against the plain
    # solve's: below that, on the fixture's first knots at rho 1e-3 (29 CG
    # steps at N = 7), the float32 and float64 plain versions themselves
    # part by 4.9e-3 in dX (on the CPU), K4's whole tolerance.
    K4_FORMS = (("K4", True, k4.CLUSTER), ("K4b", False, k4.CLUSTER),
                ("K4g", True, k4.JOINED), ("K4bg", False, k4.JOINED))

    def k4_forms(label, n_l, ks_l, cap_l, tol_l):
        lam0_l = torch.zeros(n_l, NX, device=dev)
        S_l = BlockTri(ks_l.SL, ks_l.SD, ks_l.SU)
        P_l = BlockTri(ks_l.PL, ks_l.PD, ks_l.PU)
        systems_l = {True: ks_l, False: k4._solve_system(S_l, P_l, ks_l.gamma)}
        plains = {True: lambda: k4.pcg_dz_reference(ks_l, lam0_l, cap_l,
                                                    tol_l),
                  False: lambda: k4.pcg_solve_reference(
                      S_l, P_l, ks_l.gamma, lam0_l, cap_l, tol_l)}
        refs = {dz: plain() for dz, plain in plains.items()}
        row = {}
        for kid, dz, form in K4_FORMS:
            plan = k4.pcg_plan(n_l, dz=dz, form=form)
            if not plan.form:
                continue            # the cluster form past its fit
            nv = 3 if dz else 1

            def run(c=cap_l, plan=plan, dz=dz):
                return k4._launch(lib, systems_l[dz], lam0_l, c, tol_l,
                                  _lib.stream_of(lam0_l), plan, dz)

            with _watchdog(FIRST_LAUNCH_DEADLINE):
                out = run()
                sync()
            ref = refs[dz]
            it, it_ref = int(out[nv]), int(ref[nv])
            if not (abs(it - it_ref) <= 2 or it == it_ref == cap_l):
                raise AssertionError(f"{kid} {label}: CG iterations {it} vs "
                                     f"{it_ref}")
            if bool(out[nv + 1]) != bool(ref[nv + 1]):
                raise AssertionError(f"{kid} {label}: hit differs")
            err = checked(f"{kid} {label}", [(out[0], ref[0])], 5e-3, 5e-3)
            if dz:
                err = max(err, checked(
                    f"{kid} {label} dz of its lam",
                    list(zip(out[1:3], compute_dz_knots(ks_l, out[0]))),
                    1e-3, 2e-4))
                if n_l >= 16:
                    err = max(err, checked(f"{kid} {label} dz",
                                           list(zip(out[1:3], ref[1:3])),
                                           5e-3, 5e-3))
            row[kid] = {"err": err, "iters": it, "iters_plain": it_ref,
                        "plan": tuple(plan), "run": run, "plain": plains[dz],
                        "cluster_read": int(k4._wrapper(dz, form)
                                            .cluster_size)}
            if row[kid]["cluster_read"] != plan.cluster:
                raise AssertionError(f"{kid} {label}: the kernel read C = "
                                     f"{row[kid]['cluster_read']}, planned "
                                     f"{plan.cluster}")
        print(f"K4 forms {label}: " + "; ".join(
            f"{kid} plan {r['plan']} CG {r['iters']} (plain "
            f"{r['iters_plain']}) err {r['err']:.2e}"
            for kid, r in row.items()))
        return row

    k4_rows = {n_l: k4_forms(f"N = {n_l}", n_l, *long_system(n_l))
               for n_l in K4_KNOTS}
    early = k4_forms(f"N = {LONG_LOOP_KNOT}, random system", LONG_LOOP_KNOT,
                     systems.random_knot_schur(LONG_LOOP_KNOT, device=dev),
                     300, 1e-9)
    if not early["K4g"]["iters"] < 300:
        raise AssertionError("K4g on the random system: no exit before the cap")
    # a CG step's device time per form and N: the solve less the same solve
    # with the CG capped at 0 (the band loads, the first residual and apply,
    # dz), over its steps
    k4_steps = {}
    for n_l in K4_STEP_KNOTS:
        for kid in ("K4", "K4g"):
            case = k4_rows[n_l].get(kid)
            if case is None:
                continue
            full = _device_us(case["run"], kid)
            base = _device_us(lambda: case["run"](0), kid)
            step = (None if full is None or base is None
                    else (full - base) / case["iters"])
            k4_steps[f"{kid} N={n_l}"] = {"plan": case["plan"],
                                          "device_us": full,
                                          "cap0_device_us": base,
                                          "cg_steps": case["iters"],
                                          "cg_step_us": step}
            print(f"{kid} N = {n_l}, plan {case['plan']}: {_us(full)} a "
                  f"call, {_us(base)} with the CG capped at 0, a CG step "
                  f"{_us(step)} over {case['iters']} steps")
    for kid in ("K4g", "K4bg"):
        n_l = JOINED_LOOP_KNOT
        case = k4_rows[n_l][kid]
        its = case["iters"]
        cg_ops = _cg_ops(n_l, its, _spmv_ops(n_l))
        record(kid, "pcg_dz_grid" if kid == "K4g" else "pcg_solve_grid",
               "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
               "mpcgpu_tpu/ops/pallas/pcg_kernel.py:318" if kid == "K4g"
               else "mpcgpu_tpu/ops/pallas/pcg_kernel.py:187",
               max(max(r[kid]["err"] for r in k4_rows.values()),
                   early[kid]["err"]), case["run"], case["plain"],
               cg_ops + _dz_ops(n_l) if kid == "K4g" else cg_ops,
               F32 * (_knot_schur_floats(n_l) + 3 * n_l * NX
                      + (n_l - 1) * NU) + 5 if kid == "K4g"
               else F32 * (6 * n_l * NX * NX + 3 * n_l * NX) + 5,
               n=n_l, plan=case["plan"],
               iters_by_n={str(m): r[kid]["iters"]
                           for m, r in k4_rows.items()},
               plan_by_n={str(m): r[kid]["plan"] for m, r in k4_rows.items()},
               iters_random_system=early[kid]["iters"],
               cg_steps={k: v for k, v in k4_steps.items()})

    # K6 past N = 64, the forced failover's BCR-PCG at the horizons the
    # former K6l (K6 with S read from L2) served: on the seeded random
    # system at K6's tolerances, and on fixture 0_0's system without the
    # stair at the horizon's cap and exit tol by residual, as K6 on the
    # slice's (each solve within 1e-3 of |gamma|); CG counts within 1
    k6l_rows = {}
    for n_l in LONG_BCR_KNOTS:
        lam0_l = torch.zeros(n_l, NX, device=dev)
        ks_r = systems.random_knot_schur(n_l, device=dev)
        out = k6.bcr_pcg_dz(ks_r, lam0_l, cap, tol)
        ref = k6.bcr_pcg_dz_reference(ks_r, lam0_l, cap, tol)
        sync()
        err = tight_bcr(f"K6 N = {n_l}, random system", out, ref)
        its_r = int(out[3]), int(ref[3])
        Xl, Ul, gl, xsl = long_start(n_l, seed=0)
        cl = long_cfg(n_l)
        ks_f = k3.form_kkt_schur_reference(
            model, Xl, Ul, gl, xsl, rho, cl.timestep, cl.cost.qd_cost,
            cl.cost.r_cost, cl.gravity, precond=False)
        cap_f, tol_f = cl.pcg.max_iter, default_pcg_exit_tols(n_l)[0]
        run = (lambda k=ks_f, l0=lam0_l, c=cap_f, t=tol_f:
               k6.bcr_pcg_dz(k, l0, c, t))
        plain = (lambda k=ks_f, l0=lam0_l, c=cap_f, t=tol_f:
                 k6.bcr_pcg_dz_reference(k, l0, c, t))
        out_f, ref_f = run(), plain()
        sync()
        S_f = BlockTri(ks_f.SL, ks_f.SD, ks_f.SU)
        res = [float((spmv(S_f, o[0]) - ks_f.gamma).abs().max()
                     / ks_f.gamma.abs().max()) for o in (out_f, ref_f)]
        its_f = int(out_f[3]), int(ref_f[3])
        print(f"K6 N = {n_l}: CG {its_r[0]} vs {its_r[1]} (random system), "
              f"{its_f[0]} vs {its_f[1]} (fixture system, relative residual "
              f"kernel {res[0]:.3e} plain {res[1]:.3e})")
        if (max(res) >= 1e-3 or abs(its_r[0] - its_r[1]) > 1
                or abs(its_f[0] - its_f[1]) > 1):
            raise AssertionError(f"K6 N = {n_l}: residuals {res}, CG counts "
                                 f"{its_r}, {its_f}")
        k6l_rows[n_l] = {"err": err, "iters": its_f[0], "run": run,
                         "plain": plain, "ms": _event_ms(run),
                         "us": _device_us(run, "K6"), "ks": ks_f,
                         "cap": cap_f, "tol": tol_f,
                         "err_fixture": _max_err(list(zip(out_f[:3],
                                                          ref_f[:3])))}
    print(f"K6 (cluster, past N = 64) ms per call by N: "
          f"{ {m: r['ms'] for m, r in k6l_rows.items()} }; device us per call "
          f"{ {m: r['us'] for m, r in k6l_rows.items()} }")
    row, n_l = k6l_rows[LONG_LOOP_KNOT], LONG_LOOP_KNOT
    record("K6l", "bcr_pcg_dz (the cluster K6 at the former K6l's horizons)",
           "mpcgpu_tpu_torch/csrc/bcr_pcg_dz.cu",
           "mpcgpu_tpu/ops/pallas/bcr_kernel.py:267",
           max(r["err"] for r in k6l_rows.values()), row["run"], row["plain"],
           _bcr_factor_ops(n_l) + _cg_ops(n_l, row["iters"],
                                          _bcr_apply_ops(n_l))
           + _dz_ops(n_l),
           F32 * (n_l * (5 * NX * NX + NX * NU + NU * NU + 3 * NX + NU)
                  + 2 * n_l * NX + (n_l - 1) * NU) + 5,
           n=n_l, ms_by_n={str(m): r["ms"] for m, r in k6l_rows.items()},
           device_us_by_n={str(m): r["us"] for m, r in k6l_rows.items()},
           iters_by_n={str(m): r["iters"] for m, r in k6l_rows.items()},
           max_abs_err_fixture={str(m): r["err_fixture"]
                                for m, r in k6l_rows.items()})

    # K5g against its plain version from the perturbed start at every
    # horizon (at N = 64 on K5's inputs, beside K5): at rho 1e-3 every CG
    # stops at the cap (lam at atol 1e-3, as K5's), at the larger rhos the
    # schedule reaches some CG exits before it (lam at rtol 1e-3, atol
    # 1e-4, against the float64 plain version: at N = 64, rho 0.3, K5g at
    # C = 16 parts from the float32 plain version by 1.03 times that
    # tolerance while it is 8.8e-5 from the float64 plain version and the
    # float32 plain version 1.5e-4, on the NVIDIA H100 80GB HBM3 at 700 W;
    # both distances and the ratio to the float32 plain version are
    # printed); X, U at rtol 1e-3, atol 1e-5, decisions identical, CG
    # counts within 2 per SQP iteration
    def long_kw(n_l):
        return dict(k5_kw, r_cost=long_cfg(n_l).cost.r_cost)

    def long_mega_args(n_l, rho0):
        if n_l == n:
            return (*k5_args[:6], torch.tensor(rho0, device=dev),
                    *k5_args[7:]), k5_kw
        Xl, Ul, gl, xsl = long_start(n_l, seed=5)
        cl = long_cfg(n_l)
        kw_l = long_kw(n_l)
        m0 = k2.line_search_merits_reference(
            model, Xl, Ul, torch.zeros_like(Xl), torch.zeros_like(Ul),
            cl.num_alphas, gl, xsl, cl.timestep, cl.merit_mu,
            cl.cost.qd_cost, cl.cost.r_cost, cl.gravity)[cl.num_alphas]
        return ((model, Xl, Ul, gl, xsl, torch.zeros_like(Xl),
                 torch.tensor(rho0, device=dev), 1.0, m0, cl.pcg.max_iter,
                 default_pcg_exit_tols(n_l)[0], SQP_ITERS), kw_l)

    def k5g_plans(n_l):
        """{C: K5g's plan at that cluster size}: the plan's own C, and at
        K5g's own horizons (past K5's fit) every other size the card
        admits for it."""
        own = k5.grid_plan(n_l, lib)
        plans = {own.cluster: own}
        for c in ((16, 8, 4) if n_l in JOINED_KNOTS else ()):
            plan = k5.grid_plan(n_l, lib, c)
            if plan.grid > 0 and c not in plans:
                plans[c] = plan
        return plans

    model64 = iiwa14(device=dev, dtype=torch.float64)

    def k5g_pair(n_l, rho0, lam_rtol, lam_atol, exit_tol=None):
        """K5g (the wrapper, the plan's C; then every other C of
        k5g_plans) against the plain version (lam, at rtol lam_rtol > 0,
        against the float64 plain version)."""
        args, kw_l = long_mega_args(n_l, rho0)
        if exit_tol is not None:
            args = (*args[:10], exit_tol, *args[11:])
        ref = k5.sqp_solve_mega_pcg_reference(*args, **kw_l)
        lam64 = None
        if lam_rtol:
            lam64 = k5.sqp_solve_mega_pcg_reference(
                model64, *(a.double() if torch.is_tensor(a) else a
                           for a in args[1:]), **kw_l).lam.to(torch.float32)
        err, out0 = 0.0, None
        for c, plan in k5g_plans(n_l).items():
            with _watchdog(FIRST_LAUNCH_DEADLINE):
                out = (k5.sqp_solve_mega_pcg_grid(*args, **kw_l)
                       if out0 is None else
                       k5._launch(lib, tab, *args[1:], grid=plan.grid,
                                  stream=_lib.stream_of(args[1]),
                                  kind=k5.SOLVE_PCG_GRID, cluster=c, **kw_l))
                sync()
            read = int(k5.sqp_solve_mega_pcg_grid.cluster_size)
            label = (f"K5g N = {n_l} at rho {rho0:g}, tol {args[10]:g}, "
                     f"C = {c} (read {read}), G = {plan.clusters}, place "
                     f"{plan.place}")
            ratio = ((out.lam - ref.lam).abs()
                     / (1e-4 + 1e-3 * ref.lam.abs())).max().item()
            print(f"{label}: pcg iters {out.pcg_iters.tolist()} vs "
                  f"{ref.pcg_iters.tolist()}, accepted "
                  f"{out.accepted.tolist()}, sqp_iters {int(out.sqp_iters)} "
                  f"vs {int(ref.sqp_iters)}, lam err "
                  f"{_max_err([(out.lam, ref.lam)]):.3e} (the JAX tolerance "
                  f"ratio {ratio:.3f})"
                  + ("" if lam64 is None else
                     f", from the float64 plain version "
                     f"{_max_err([(out.lam, lam64)]):.3e} (the float32 plain "
                     f"version: {_max_err([(ref.lam, lam64)]):.3e})"))
            if read != c:
                raise AssertionError(f"{label}: the kernel read "
                                     f"%cluster_nctarank = {read}")
            for f in ("accepted", "sqp_iters", "bailed"):
                if not torch.equal(getattr(out, f), getattr(ref, f)):
                    raise AssertionError(f"{label}: {f} differs from the "
                                         f"plain version")
            if int((out.pcg_iters - ref.pcg_iters).abs().max()) > 2:
                raise AssertionError(f"{label}: CG counts differ by more "
                                     f"than 2")
            err = max(err, checked(f"{label} X, U",
                                   [(out.X, ref.X), (out.U, ref.U)],
                                   1e-3, 1e-5),
                      checked(f"{label} lam", [(out.lam, ref.lam)], 0,
                              lam_atol) if lam64 is None else
                      checked(f"{label} lam against the float64 plain "
                              f"version", [(out.lam, lam64)], lam_rtol,
                              lam_atol))
            out0 = out0 or out
        return args, kw_l, out0, ref, err

    k5g_rows, err5g = {}, 0.0
    for n_l in (*LONG_MEGA_KNOTS, *JOINED_KNOTS):
        args, kw_l, out, _, err = k5g_pair(n_l, cfg.rho_init, 0, 1e-3)
        err5g, exited = max(err5g, err), False
        # CGs that exit before the cap: at the larger rhos the schedule
        # reaches, at this N's exit tol, or where those stay at the cap, at
        # the loosest tol of the reference's sweep (default_pcg_exit_tols).
        # Past K5's fit not at rho 1 and tol 1e-5: there every CG stops at
        # the cap (40 at N = 657) on a system where float32 solves part in
        # lam by more than the JAX tolerance, the plain float32 version
        # from the float64 one among them (as the host build's arithmetic
        # shows), which is no longer that tolerance's regime
        loose = max(default_pcg_exit_tols(n_l))
        for rho_early, tol_e in (((0.3, None), (0.3, loose))
                                 if n_l in JOINED_KNOTS else
                                 ((0.3, None), (1.0, None), (0.3, loose),
                                  (1.0, loose))):
            if exited and tol_e is not None:
                break
            _, _, _, ref, e = k5g_pair(n_l, rho_early, 1e-3, 1e-4, tol_e)
            err5g = max(err5g, e)
            its_e = ref.pcg_iters
            exited |= bool(((its_e >= 0) & (its_e < args[9])).any())
        if not exited:
            raise AssertionError(f"K5g N = {n_l}: no CG exited before the "
                                 f"cap at rho 0.3 or 1, tol {args[10]:g} or "
                                 f"{loose:g}")
        run = (lambda a=args, k=kw_l: k5.sqp_solve_mega_pcg_grid(*a, **k))
        # the cluster form on the same inputs (where it fits), the direct
        # comparison
        run_c = (lambda a=args, k=kw_l: k5.sqp_solve_mega_pcg(*a, **k))
        fits = k5.pcg_kind(n_l) == k5.SOLVE_PCG
        k5g_rows[n_l] = {"args": args, "kw": kw_l, "run": run,
                         "ms": _event_ms(run), "us": _device_us(run, "K5g"),
                         "cluster_ms": _event_ms(run_c) if fits else None,
                         "cluster_us": (_device_us(run_c, "K5") if fits
                                        else None),
                         "plan": tuple(k5.grid_plan(n_l)),
                         "cg_iters": [int(i) for i in out.pcg_iters.tolist()
                                      if i >= 0]}
    print(f"K5g (joined form) ms per call by N: "
          f"{ {m: r['ms'] for m, r in k5g_rows.items()} }; device us per call "
          f"{ {m: r['us'] for m, r in k5g_rows.items()} }; K5 (cluster form) "
          f"on the same inputs: ms "
          f"{ {m: r['cluster_ms'] for m, r in k5g_rows.items()} }, device us "
          f"{ {m: r['cluster_us'] for m, r in k5g_rows.items()} }")
    row = k5g_rows[GRID_LOOP_KNOT]
    n_l, args, kw_l = GRID_LOOP_KNOT, row["args"], row["kw"]
    na = cfg.num_alphas
    record("K5g", "sqp_solve_mega_pcg_grid", "mpcgpu_tpu_torch/csrc/sqp_mega.cu",
           "mpcgpu_tpu/ops/pallas/sqp_megakernel.py:1027", err5g, row["run"],
           lambda: k5.sqp_solve_mega_pcg_reference(*args, **kw_l),
           sum(n_l * OPS_K3_KNOT + _cg_ops(n_l, i, _spmv_ops(n_l))
               + _dz_ops(n_l) + _merits_ops(n_l, na) for i in row["cg_iters"]),
           F32 * (2 * (2 * n_l * NX + (n_l - 1) * NU) + n_l * 6 + NX + TAB
                  + 5) + 4 * (2 + 3 * SQP_ITERS),
           n=n_l, grid=grids[n_l]["K5g"],
           plan_by_n={str(m): r["plan"] for m, r in k5g_rows.items()},
           ms_by_n={str(m): r["ms"] for m, r in k5g_rows.items()},
           cg_iters_by_n={str(m): r["cg_iters"] for m, r in k5g_rows.items()},
           device_us_by_n={str(m): r["us"] for m, r in k5g_rows.items()},
           cluster_ms_by_n={str(m): r["cluster_ms"]
                            for m, r in k5g_rows.items()},
           cluster_device_us_by_n={str(m): r["cluster_us"]
                                   for m, r in k5g_rows.items()})

    # K9pg at N = 256 and 1024: one iteration against the plain iteration;
    # four launches against one K5g launch, bit for bit (the same body and
    # plan, sums that depend on the plan alone)
    err9pg, k9pg_rows, k9pg_lam = 0.0, {}, {}
    for n_l in (LONG_LOOP_KNOT, GRID_LOOP_KNOT):
        args5, kw_l = k5g_rows[n_l]["args"], k5g_rows[n_l]["kw"]
        (_, Xl, Ul, gl, xsl, lam0_l, _, _, m0, cap_l, tol_l, _) = args5
        for rho0, lam_rtol, lam_atol in ((cfg.rho_init, 0, 1e-3),
                                         (0.3, 1e-3, 1e-4)):
            a9 = (model, Xl, Ul, gl, xsl, lam0_l,
                  torch.tensor(rho0, device=dev), one, m0, cap_l, tol_l)
            with _watchdog(FIRST_LAUNCH_DEADLINE):
                out = k9.sqp_iter_mega_pcg_grid(*a9, **kw_l)
                sync()
            ref = k9.sqp_iter_mega_pcg_reference(*a9, **kw_l)
            sync()
            label = f"K9pg N = {n_l} at rho {rho0:g}"
            print(f"{label}: CG {int(out.pcg_iters)} vs "
                  f"{int(ref.pcg_iters)}, accept {bool(out.accept)} vs "
                  f"{bool(ref.accept)}")
            for f in ("accept", "bail"):
                if not torch.equal(getattr(out, f), getattr(ref, f)):
                    raise AssertionError(f"{label}: {f} differs")
            if abs(int(out.pcg_iters) - int(ref.pcg_iters)) > 2:
                raise AssertionError(f"{label}: CG counts differ by more "
                                     f"than 2")
            err9pg = max(err9pg, checked(f"{label} X, U", [(out.X, ref.X),
                                                           (out.U, ref.U)],
                                         1e-3, 1e-5),
                         checked(f"{label} lam", [(out.lam, ref.lam)],
                                 lam_rtol, lam_atol))
            if rho0 == cfg.rho_init:
                k9pg_rows[n_l] = (a9, kw_l, int(out.pcg_iters))
                k9pg_lam[n_l] = out.lam

        def k9pg_step(Xc, Uc, lamc, rhoc, drhoc, meritc, gl=gl, xsl=xsl,
                      cap_l=cap_l, tol_l=tol_l, kw_l=kw_l):
            return k9.sqp_iter_mega_pcg_grid(model, Xc, Uc, gl, xsl, lamc,
                                             rhoc, drhoc, meritc, cap_l,
                                             tol_l, **kw_l)

        k5g_once = k5.sqp_solve_mega_pcg_grid(*args5, **kw_l)
        four = iterate(Xl, Ul, lam0_l, torch.tensor(cfg.rho_init, device=dev),
                       one, m0, SQP_ITERS, k9pg_step)
        sync()
        pairs = {"X": (four[0], k5g_once.X), "U": (four[1], k5g_once.U),
                 "lam": (four[2], k5g_once.lam),
                 "rho": (four[3], k5g_once.rho),
                 "merit": (four[5], k5g_once.merit),
                 "sqp_iters": (four[6], k5g_once.sqp_iters),
                 "pcg_iters": (four[8], k5g_once.pcg_iters),
                 "accepted": (four[10], k5g_once.accepted)}
        unequal = [f for f, (x, y) in pairs.items() if not torch.equal(x, y)]
        if unequal:
            raise AssertionError(f"{SQP_ITERS} K9pg launches and one K5g "
                                 f"launch differ in {unequal} at N = {n_l}")
        print(f"{SQP_ITERS} K9pg launches bit-equal to one K5g launch at "
              f"N = {n_l}")
    # K4 and K4g against K9p's and K9pg's dual solve: the card's K3 at the
    # iteration's start, then K4 at the plan K9p launches (C, the stair's
    # place) or K4g at K5g's plan (C, G, place): lam and the CG count bit
    # for bit (stage 4 is the body K4 and K4g launch)
    def dual_equal(label, a9, kw_l, lam9, its9, plan):
        _, Xl, Ul, gl, xsl, lam0_l, rho_l, _, _, cap_l, tol_l = a9
        ks_l = k3.form_kkt_schur(model, Xl, Ul, gl, xsl, rho_l, kw_l["dt"],
                                 kw_l["qd_cost"], kw_l["r_cost"],
                                 kw_l["gravity"])
        got = k4._launch(lib, ks_l, lam0_l, cap_l, tol_l, _lib.stream_of(Xl),
                         plan)
        sync()
        if not (torch.equal(got[0], lam9) and int(got[3]) == its9):
            raise AssertionError(f"{label}: lam or the CG count differs from "
                                 f"the megakernel's dual solve")
        print(f"{label}, plan {tuple(plan)}: lam and the CG count ({its9}) "
              f"bit-equal")

    for n_l in (n, LONG_LOOP_KNOT):
        args5, kw_l = long_mega_args(n_l, cfg.rho_init)
        a9 = (*args5[:7], one, *args5[8:11])
        out = k9.sqp_iter_mega_pcg(*a9, **kw_l)
        plan9 = (ctypes.c_int * 3)()
        lib.mpc_mega_cluster_plan(n_l, k9.ITER_PCG, 0, -1, plan9)
        dual_equal(f"K4 against K9p at N = {n_l}", a9, kw_l, out.lam,
                   int(out.pcg_iters), k4.PcgPlan(
                       k4.CLUSTER, plan9[0], 1, 3 if plan9[1] else 2,
                       plan9[0]))
    for n_l in (LONG_LOOP_KNOT, GRID_LOOP_KNOT):
        a9, kw_l, its9 = k9pg_rows[n_l]
        gp = k5.grid_plan(n_l)
        dual_equal(f"K4g against K9pg at N = {n_l}", a9, kw_l,
                   k9pg_lam[n_l], its9, k4.PcgPlan(
                       k4.JOINED, gp.cluster, gp.clusters, gp.place, gp.grid))
    n_l = GRID_LOOP_KNOT
    a9_main, kw_l, it9g = k9pg_rows[n_l]
    record("K9pg", "sqp_iter_mega_pcg_grid", "mpcgpu_tpu_torch/csrc/sqp_mega.cu",
           "mpcgpu_tpu/ops/pallas/sqp_megakernel.py:960", err9pg,
           lambda: k9.sqp_iter_mega_pcg_grid(*a9_main, **kw_l),
           lambda: k9.sqp_iter_mega_pcg_reference(*a9_main, **kw_l),
           n_l * OPS_K3_KNOT + _cg_ops(n_l, it9g, _spmv_ops(n_l))
           + _dz_ops(n_l) + _merits_ops(n_l, na),
           F32 * (2 * (2 * n_l * NX + (n_l - 1) * NU) + 6 * n_l + NX + TAB
                  + 6) + 20,
           n=n_l, grid=grids[n_l]["K9pg"], plan=tuple(k5.grid_plan(n_l)),
           bit_equal_to_k5g_at_n=[LONG_LOOP_KNOT, GRID_LOOP_KNOT],
           device_us=_device_us(
               lambda: k9.sqp_iter_mega_pcg_grid(*a9_main, **kw_l), "K9pg"))

    # the loops at long horizons, each through the kernels and the plain
    # modules, from the horizon's start with warm duals
    long_counts, long_sm = {}, {}

    def long_pair(label, n_l, cfg_l, linsys, want, n_updates, detail=True):
        tol_l = default_pcg_exit_tols(n_l)[0]
        start_l = long_start(n_l)
        # past the fixture's 666 rows, its rows repeated (np.resize), as
        # long_start's
        rows = np.resize(np.arange(xu.shape[0]), n_l + xu.shape[0])
        traj_l = ((xu_d, ee_d) if n_l <= xu.shape[0] else
                  (xu_d[torch.as_tensor(rows, device=dev)],
                   ee_d[torch.as_tensor(rows, device=dev)]))
        fused, counts = run_loop(f"{label}, fused", cfg_l, linsys, want=want,
                                 detail=detail, n_updates=n_updates,
                                 start=start_l, exit_tol=tol_l, traj=traj_l)
        # (megakernel and megakernel_solve act only with fused_stages)
        plain_cfg_l = dataclasses.replace(cfg_l, fused_stages=False,
                                          megakernel=False,
                                          megakernel_solve=False)
        plain_linsys = "pcg" if linsys == "pcg_pallas" else linsys
        key = (n_l, plain_cfg_l, plain_linsys, n_updates)
        if key not in long_sm:
            long_sm[key] = run_loop(f"{label}, plain", plain_cfg_l,
                                    plain_linsys, n_updates=n_updates,
                                    start=start_l, exit_tol=tol_l,
                                    traj=traj_l)[0]
        compare(label, fused, long_sm[key])
        if linsys == "auto" and fused["failed_over"] != long_sm[key]["failed_over"]:
            raise AssertionError(f"{label}: failed_over {fused['failed_over']} "
                                 f"vs plain {long_sm[key]['failed_over']}")
        long_counts[label] = counts
        return fused

    for n_l in (*LONG_AUTO_KNOTS, GRID_LOOP_KNOT):
        u_l = LONG_UPDATES
        solve = "K5g" if k5.pcg_kind(n_l) == k5.SOLVE_PCG_GRID else "K5"
        sm = long_pair(f"auto N={n_l}", n_l,
                       long_cfg(n_l, megakernel=True, megakernel_solve=True),
                       "auto", {**none, "K1": u_l, "K2": u_l, solve: u_l},
                       u_l)
        if any(sm["failed_over"]):
            raise AssertionError(f"auto N={n_l}: the latch tripped on 0_0")
    n_l, u_l = LONG_LOOP_KNOT, LONG_UPDATES
    for n_k in (n_l, JOINED_LOOP_KNOT):     # K4 at 256, K4g past the cut
        long_pair(f"staged pcg N={n_k}", n_k, long_cfg(n_k), "pcg",
                  {**none, "K1": u_l, "K2": u_l + u_l * s, "K3": u_l * s,
                   k4_kid(n_k): u_l * s}, u_l)
    half_l = u_l // 2
    sm = long_pair(
        f"forced failover N={n_l}", n_l,
        long_cfg(n_l, megakernel=True, megakernel_solve=True,
                 **dict(trip, failover_check_every=half_l)), "auto",
        {**none, "K1": u_l, "K2": half_l + half_l * (1 + s), "K5": half_l,
         "K3": half_l * s, "K6": half_l * s}, u_l)
    if sm["failed_over"] != [False] * half_l + [True] * half_l:
        raise AssertionError(f"forced failover N={n_l}: failed_over "
                             f"{sm['failed_over']}")
    for n_i, kid in ((n_l, "K9p"), (GRID_LOOP_KNOT, "K9pg")):
        long_pair(f"pcg per-iteration megakernel N={n_i}", n_i,
                  long_cfg(n_i, megakernel=True), "pcg",
                  {**none, "K1": u_l, "K2": u_l, kid: u_l * s}, u_l)
    # the plain stages on the card with K4b (K4bg past the cut) as the
    # solve: host-bound, the host clock only (profiling their glue costs
    # minutes)
    for n_k in (n_l, JOINED_LOOP_KNOT):
        long_pair(f"pcg_pallas N={n_k}", n_k,
                  dataclasses.replace(long_cfg(n_k), fused_stages=False),
                  "pcg_pallas", {**none, k4_kid(n_k, dz=False): u_l * s},
                  u_l, detail="host")

    # ---- 9. the sharded paths (dryrun_multichip's legs) on 8 in-process
    # shards of one card: K11, the sharded CGs, the N = 512 solve and
    # closed loop, the arms loops, and the gloo form
    from mpcgpu_tpu_torch.ops.cuda import spmv_halo_kernel as k11
    from mpcgpu_tpu_torch.ops.pcg import pcg
    from mpcgpu_tpu_torch.parallel.pcg_sharded import pcg_sharded
    from mpcgpu_tpu_torch.parallel.pcg_sharded_cuda import pcg_sharded_cuda
    from mpcgpu_tpu_torch.parallel.sharded import (
        arms_mesh, horizon_mesh, register_sharded_pcg, sharded_sqp_solve,
        simulate_mpc_scan_arms_sharded, simulate_mpc_scan_packed_arms_sharded,
        simulate_mpc_scan_sharded)
    t_phase = time.perf_counter()
    n_s, nl = SHARD_KNOTS, SHARD_KNOTS // SHARDS
    mesh = horizon_mesh(SHARDS, device=dev)
    f32 = torch.float32

    def rand(seed, *shape):
        return torch.as_tensor(np.random.default_rng(seed).normal(size=shape),
                               dtype=f32, device=dev)

    def k11_pair(label, bands, x, xl, xr):
        """K11 and its plain version: within 1e-5 of max|y| (float32 sums
        of 42 products in another order)."""
        got = k11.spmv_halo(*bands, x, xl, xr)
        want = k11.spmv_halo_reference(*bands, x, xl, xr)
        sync()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= 1e-5 * scale):
            raise AssertionError(f"K11 {label}: max error {err:.3e} against "
                                 f"max|y| {scale:.3e}")
        return err

    def k11_shards(label, bands, xs, xl, xr):
        """K11 over every shard in one launch: bit-equal to one launch per
        shard (its neighbours' edge rows, xl and xr at the ends), within
        1e-5 of max|y| of the plain version; returns the largest error."""
        before = k11.spmv_halo.launches
        got = k11.spmv_halo_shards(bands, xs, xl, xr)
        if k11.spmv_halo.launches != before + 1:
            raise AssertionError(f"K11 {label}: not one launch")
        last, err = len(xs) - 1, 0.0
        for i, (b, x) in enumerate(zip(bands, xs)):
            halos = (xs[i - 1][-1] if i > 0 else xl,
                     xs[i + 1][0] if i < last else xr)
            err = max(err, k11_pair(f"{label}, shard {i}", b, x, *halos))
            if not torch.equal(got[i], k11.spmv_halo(*b, x, *halos)):
                raise AssertionError(f"K11 {label}: shard {i} differs from "
                                     f"its own launch")
        return err

    # K11 over the 8 shards of 0_0's N = 512 Schur system (phase 8's
    # perturbed start) times a seeded x, the outer halos the global edges'
    # zeros (Mesh.outer_halos); and over 8 shards of random bands with
    # nonzero outer halos
    ks_s, cap_s, tol_s = long_system(n_s)
    S_s = BlockTri(ks_s.SL, ks_s.SD, ks_s.SU)
    P_s = BlockTri(ks_s.PL, ks_s.PD, ks_s.PU)
    x_s = rand(12, n_s, NX)
    shard_bands = list(zip(*(mesh.shard(t) for t in S_s)))
    x_sh = mesh.shard(x_s)
    outer = mesh.outer_halos(x_sh)
    err11 = k11_shards("0_0's S", shard_bands, x_sh, *outer)
    rb = [(rand(13 + 4 * i, nl, NX, NX), rand(14 + 4 * i, nl, NX, NX),
           rand(15 + 4 * i, nl, NX, NX)) for i in range(SHARDS)]
    xb = [rand(16 + 4 * i, nl, NX) for i in range(SHARDS)]
    err11 = max(err11, k11_shards("random bands", rb, xb, rand(50, NX),
                                  rand(51, NX)))
    k11_args = (shard_bands, x_sh, *outer)

    # the library yardstick: one torch.sparse BSR (block 14) product of the
    # whole banded S with x, the same work as one K11 launch over every
    # shard; torch.bmm of the stacked bands against the unfolded x where
    # the card's build refuses BSR
    pad = torch.cat([outer[0], x_s.reshape(-1), outer[1]])
    try:
        idx = torch.arange(n_s, device=dev)
        cols = (idx[:, None] + torch.arange(-1, 2, device=dev)).reshape(-1)
        keep = (cols >= 0) & (cols < n_s)
        bsr = torch.sparse_bsr_tensor(
            torch.cat([idx.new_zeros(1), keep.view(n_s, 3).sum(1).cumsum(0)]),
            cols[keep],
            torch.stack(tuple(S_s), 1).reshape(3 * n_s, NX, NX)[keep],
            size=(n_s * NX, n_s * NX))
        col = x_s.reshape(-1, 1)
        lib_run = lambda: bsr @ col
        lib_y = lib_run().reshape(n_s, NX)
        lib_name = "torch.sparse BSR (block 14) of the whole S @ x"
    except (RuntimeError, NotImplementedError) as e:
        print(f"K11 library yardstick: BSR refused ({e}); timing torch.bmm")
        stacked = torch.cat(tuple(S_s), dim=2)                 # (N, 14, 42)
        win = pad.view(n_s + 2, NX).unfold(0, 3, 1).transpose(1, 2)
        win = win.reshape(n_s, 3 * NX, 1).contiguous()
        lib_run = lambda: torch.bmm(stacked, win)
        lib_y = lib_run().reshape(n_s, NX)
        lib_name = "torch.bmm of the (N, 14, 42) stacked bands"
    sync()
    want = torch.cat(k11.spmv_halo_shards_reference(*k11_args))
    if float((lib_y - want).abs().max()) > 1e-5 * float(want.abs().max()):
        raise AssertionError(f"K11 library yardstick ({lib_name}) computes "
                             f"another product")
    lib_ms = _event_ms(lib_run)
    k11_us = _device_us(lambda: k11.spmv_halo_shards(*k11_args), "K11")
    one_args = (*shard_bands[0], x_sh[0], outer[0], x_sh[1][0])
    k11_one_us = _device_us(lambda: k11.spmv_halo(*one_args), "K11")
    print(f"K11 over {SHARDS} shards of nl = {nl}: max error {err11:.3e}; "
          f"{_us(k11_us)} of device time per launch ({_us(k11_one_us)} for "
          f"one shard); library ({lib_name}) {lib_ms:.4f} ms")
    record("K11", "spmv_halo", "mpcgpu_tpu_torch/csrc/spmv_halo.cu",
           "mpcgpu_tpu/parallel/pcg_sharded_pallas.py:74", err11,
           lambda: k11.spmv_halo_shards(*k11_args),
           lambda: k11.spmv_halo_shards_reference(*k11_args),
           2 * (3 * n_s - 2) * NX * NX,
           F32 * ((3 * n_s - 2) * NX * NX + 2 * n_s * NX + 2 * NX),
           library_ms=lib_ms, library=lib_name, shards=SHARDS, nl=nl,
           device_us=k11_us, device_us_one_shard=k11_one_us,
           ms_one_shard=_event_ms(lambda: k11.spmv_halo(*one_args)))

    # the sharded CGs against K4bg and the plain CG at N = 512: to
    # convergence on the JAX parallel test's random system (seed 7, the
    # stair; tests/test_parallel.py:100-107's residual rule, iterations
    # within 3), and at the cap on 0_0's system (K4g's rtol = atol = 5e-3)
    def cg_runs(S, P, gamma, cap_c, tol_c):
        lam0_c = torch.zeros_like(gamma)
        a = (S, P, gamma, lam0_c, cap_c, tol_c)
        return {"pcg_sharded_cuda": lambda: pcg_sharded_cuda(mesh, *a),
                "pcg_sharded": lambda: pcg_sharded(mesh, *a),
                "K4bg": lambda: k4.pcg_solve_grid(*a),
                "plain": lambda: tuple(pcg(*a))}

    sys7 = {f: torch.as_tensor(v, device=dev) for f, v in
            systems.random_system(n_s, seed=7, precond=True).items()}
    S7 = BlockTri(sys7["SL"], sys7["SD"], sys7["SU"])
    P7 = BlockTri(sys7["PL"], sys7["PD"], sys7["PU"])
    outs7 = {k: run() for k, run in cg_runs(S7, P7, sys7["gamma"], 400,
                                           1e-10).items()}
    sync()
    gnorm = float(sys7["gamma"].norm())
    res7 = {k: float((sys7["gamma"] - spmv(S7, o[0])).norm())
            for k, o in outs7.items()}
    its7 = {k: int(o[1]) for k, o in outs7.items()}
    print(f"sharded CG, random system N = {n_s}: iterations {its7}, "
          f"relative residuals { {k: r / gnorm for k, r in res7.items()} }")
    for k in ("pcg_sharded_cuda", "pcg_sharded", "K4bg"):
        if (bool(outs7[k][2]) or abs(its7[k] - its7["plain"]) > 3
                or not res7[k] / gnorm < 1e-4
                or not res7[k] < 3 * res7["plain"] + 1e-6 * gnorm):
            raise AssertionError(f"{k} on the random system: iterations "
                                 f"{its7[k]} vs {its7['plain']}, residual "
                                 f"{res7[k]:.3e} vs {res7['plain']:.3e}")
    runs_s = cg_runs(S_s, P_s, ks_s.gamma, cap_s, tol_s)
    outs_s = {k: run() for k, run in runs_s.items()}
    sync()
    its_s = {k: int(o[1]) for k, o in outs_s.items()}
    for k in ("pcg_sharded_cuda", "pcg_sharded", "K4bg"):
        if abs(its_s[k] - its_s["plain"]) > 3:
            raise AssertionError(f"{k} on 0_0's system: {its_s[k]} CG "
                                 f"iterations vs {its_s['plain']}")
        checked(f"{k} on 0_0's N = {n_s} system",
                [(outs_s[k][0], outs_s["plain"][0])], 5e-3, 5e-3)
    cg_ms = {k: _event_ms(run, reps=5, warmup=1) for k, run in runs_s.items()}
    k4bg_us = _device_us(runs_s["K4bg"], "K4bg")
    k11_cg = 2 + 2 * cap_s      # one launch an SpMV over the 8 shards
    sync()
    reset_launch_counts()
    runs_s["pcg_sharded_cuda"]()
    sync()
    if k11.spmv_halo.launches != k11_cg:
        raise AssertionError(f"pcg_sharded_cuda launched K11 "
                             f"{k11.spmv_halo.launches} times, expected "
                             f"{k11_cg}")
    groups, complete = _device_breakdown(runs_s["pcg_sharded_cuda"], 1,
                                         {"K11": k11_cg})
    print(f"sharded CG, 0_0's system N = {n_s}, cap {cap_s}: iterations "
          f"{its_s}; ms per solve {cg_ms}; K4bg {_us(k4bg_us)} of device "
          f"time; {k11_cg} K11 launches per solve")

    # sharded_sqp_solve at N = 512, the at-scale leg, against the
    # single-device plain sqp_solve (X, U at rtol 2e-3, atol 2e-4,
    # __graft_entry__.py:160,167; decisions equal): from the slice's start
    # (the JAX leg's, where every step may be rejected) and from phase 8's
    # perturbed start (knot 0 kept), where steps are accepted
    cfg5 = SolverConfig.for_knots(n_s, sqp_max_iter=SHARD_SQP_ITERS,
                                  pcg=PCGConfig(max_iter=cap_s))
    slice5 = tuple(torch.as_tensor(a, device=dev)
                   for a in horizon_slices(xu, ee, n_s))
    solve_ms = {}
    for start_name, (X5, U5, g5, xs5) in (("slice", slice5),
                                          ("perturbed",
                                           long_start(n_s, seed=5))):
        solve_args = (X5, U5, torch.zeros_like(X5), g5, xs5, cfg.rho_init,
                      1e-4)
        ref5 = sqp_solve(model, cfg5, *solve_args)
        sync()
        if start_name == "perturbed" and not bool(ref5.stats.accepted.any()):
            raise AssertionError("the at-scale solve from the perturbed "
                                 "start accepted no step")
        for mode, kw, want in (
                ("whole", {}, none),
                ("explicit", dict(explicit_pcg=True), none),
                ("fused", dict(fused_pcg=True),
                 {**none, "K11": SHARD_SQP_ITERS * k11_cg})):
            label = f"sharded_sqp_solve N={n_s} {mode}, {start_name} start"
            t0 = time.perf_counter()
            res5, _ = counted(label, lambda kw=kw: sharded_sqp_solve(
                model, cfg5, mesh, *solve_args, **kw), want)
            solve_ms[f"{mode}_{start_name}"] = 1e3 * (time.perf_counter()
                                                      - t0)
            err5s = checked(f"{label} X, U", [(res5.X, ref5.X),
                                              (res5.U, ref5.U)], 2e-3, 2e-4)
            for f in ("accepted", "sqp_iters", "rho_bailed"):
                if not torch.equal(getattr(res5.stats, f),
                                   getattr(ref5.stats, f)):
                    raise AssertionError(f"{label}: {f} differs from the "
                                         f"single-device solve")
            print(f"{label}: X, U within {err5s:.3e} and lam within "
                  f"{_max_err([(res5.lam, ref5.lam)]):.3e} of the "
                  f"single-device solve, accepted "
                  f"{res5.stats.accepted.tolist()}, CG iterations "
                  f"{res5.stats.pcg_iters.tolist()} vs "
                  f"{ref5.stats.pcg_iters.tolist()}, "
                  f"{solve_ms[f'{mode}_{start_name}']:.1f} ms")

    # the knot-sharded closed loop at N = 512 through K11's CG, from the
    # perturbed plan (knot 0 kept: the measured state), against the
    # single-device loop (tests/test_parallel.py:311-316's tolerances)
    cfg_loop = SolverConfig.for_knots(
        n_s, sqp_max_iter=SHARD_LOOP_ITERS,
        pcg=PCGConfig(max_iter=SHARD_LOOP_CAP))
    fused_name = register_sharded_pcg(mesh, fused=True)
    u_s = SHARD_UPDATES
    per_update = SHARD_LOOP_ITERS * (2 + 2 * SHARD_LOOP_CAP)
    X5, U5 = long_start(n_s, seed=5)[:2]     # the perturbed plan
    loop_args = (xu_d, ee_d, X5, U5, torch.zeros_like(X5), cfg.rho_init,
                 1e-5, u_s)
    t0 = time.perf_counter()
    out_sh, shard_loop_counts = counted(
        f"knot-sharded loop N={n_s}, K11",
        lambda: simulate_mpc_scan_sharded(model, cfg_loop, mesh, *loop_args,
                                          fused_name),
        {**none, "K11": u_s * per_update})
    loop_ms = 1e3 * (time.perf_counter() - t0) / u_s
    t0 = time.perf_counter()
    out_ref = simulate_mpc_scan(model, cfg_loop, *loop_args)
    sync()
    loop_ref_ms = 1e3 * (time.perf_counter() - t0) / u_s
    checked(f"knot-sharded loop N={n_s} final_xs",
            [(out_sh["final_xs"], out_ref["final_xs"])], 2e-4, 2e-5)
    checked(f"knot-sharded loop N={n_s} tracking errors",
            [(out_sh["tracking_errors"], out_ref["tracking_errors"])], 2e-3,
            2e-4)
    if not torch.equal(out_sh["sqp_iters"], out_ref["sqp_iters"]):
        raise AssertionError("knot-sharded loop: sqp_iters differ")
    print(f"knot-sharded loop N={n_s} ({u_s} updates): host clock "
          f"{loop_ms:.1f} ms per update (single-device plain loop "
          f"{loop_ref_ms:.1f}); tracking errors "
          f"{out_sh['tracking_errors'].tolist()}, CG iterations "
          f"{out_sh['pcg_iters_total'].tolist()} (single-device "
          f"{out_ref['pcg_iters_total'].tolist()}); {per_update} K11 "
          f"launches per update")

    # 8 arms over 8 groups (plain modules, as the JAX leg) against the
    # batched loop (the JAX dryrun's rtol 1e-5, atol 1e-6)
    n_a = ARMS_KNOTS
    cfg_a = SolverConfig.for_knots(n_a, sqp_max_iter=2,
                                   pcg=PCGConfig(max_iter=10))
    Xa, Ua = (torch.as_tensor(a, device=dev)
              for a in horizon_slices(xu, ee, n_a)[:2])
    arms_in = arm_starts(Xa, Ua, torch.zeros_like(Xa),
                         0.02 * rand(19, ARMS_GROUPS, NX // 2))
    out_a, _ = counted(
        f"arms over {ARMS_GROUPS} groups",
        lambda: simulate_mpc_scan_arms_sharded(
            model, cfg_a, arms_mesh(ARMS_GROUPS, device=dev), xu_d, ee_d,
            *arms_in, cfg.rho_init, 1e-5, ARMS_UPDATES), none)
    ref_a = simulate_mpc_scan_batched(model, cfg_a, xu_d, ee_d, *arms_in,
                                      cfg.rho_init, 1e-5, ARMS_UPDATES)
    sync()
    err_a = checked("arms sharded vs batched", [
        (out_a[k], ref_a[k]) for k in ("tracking_errors", "final_xs")],
        1e-5, 1e-6)
    if not torch.equal(out_a["sqp_iters"], ref_a["sqp_iters"]):
        raise AssertionError("arms sharded: sqp_iters differ from batched")

    # 2 groups of 2 packed arms (K10 and the arm-batched K1) against the
    # unsharded packed loop per group (tests/test_parallel.py:274-282)
    g_p, b_p, u_p = PACKED_GROUPS, PACKED_ARMS, PACKED_UPDATES
    packed_in = arm_starts(X, U, lam_w, dq[:g_p * b_p])
    out_p, _ = counted(
        f"packed arms over {g_p} groups",
        lambda: simulate_mpc_scan_packed_arms_sharded(
            model, cfg, arms_mesh(g_p, device=dev), xu_d, ee_d, *packed_in,
            cfg.rho_init, tol, u_p),
        {**none, "K10": g_p * u_p, "K1": g_p * u_p})
    bit_equal = True
    for g in range(g_p):
        sl = slice(g * b_p, (g + 1) * b_p)
        ref_p = simulate_mpc_scan_packed(
            model, cfg, xu_d, ee_d, *(t[sl].contiguous() for t in packed_in),
            cfg.rho_init, tol, u_p)
        sync()
        pairs = [(out_p[k][sl], ref_p[k]) for k in ("tracking_errors",
                                                   "final_xs")]
        checked(f"packed arms group {g}", pairs, 1e-5, 1e-6)
        if not torch.equal(out_p["sqp_iters"][sl], ref_p["sqp_iters"]):
            raise AssertionError(f"packed arms group {g}: sqp_iters differ")
        bit_equal &= all(torch.equal(a, b) for a, b in pairs)
    print(f"arms: {ARMS_GROUPS} arms over {ARMS_GROUPS} groups within "
          f"{err_a:.3e} of the batched loop; {g_p} x {b_p} packed arms "
          f"{'bit-equal to' if bit_equal else 'within tolerance of'} the "
          f"unsharded packed loops")

    # the torch.distributed form: GLOO_RANKS gloo ranks with CUDA tensors
    # on this card, one shard each, against the in-process mesh of as many
    # shards, bit for bit (NCCL needs a GPU per rank: not checked here):
    # the CGs on the seeded random system with the stair, the solve on the
    # slice's start
    spec = importlib.util.spec_from_file_location(
        "_torch_ranks", repo / "tests" / "torch_ranks.py")
    ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks)
    cpu = lambda t: t.detach().cpu()
    sys_g = {f: torch.as_tensor(v) for f, v in
             systems.random_system(n, seed=11, precond=True).items()}
    gloo_cap = 400             # the random system's CG converges first
    case = {"device": "cuda",
            "pcg": {"S": tuple(sys_g[f] for f in ("SL", "SD", "SU")),
                    "P": tuple(sys_g[f] for f in ("PL", "PD", "PU")),
                    "gamma": sys_g["gamma"], "lam0": cpu(lam0),
                    "max_iter": gloo_cap, "tol": 1e-10},
            "sqp": {"X": cpu(X), "U": cpu(U), "lam": cpu(lam0),
                    "goals": cpu(goals), "xs": cpu(xs),
                    "rho": cfg.rho_init, "tol": tol, "sqp_max_iter": 2,
                    "cap": cap}}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        rank_outs = ranks.run_ranks(case, GLOO_RANKS, workdir, timeout=300)
    gloo_s = time.perf_counter() - t0
    for r, out in enumerate(rank_outs):
        for key in ("pcg_sharded", "pcg_sharded_cuda", "sqp_fused"):
            a, b = out[key]["ranks"], out[key]["in_process"]
            pairs = (list(zip(a, b)) if isinstance(a, tuple)
                     else [(a[f], b[f]) for f in a])
            if not all(torch.equal(x, y) for x, y in pairs):
                raise AssertionError(f"gloo rank {r}, {key}: not bit-equal "
                                     f"to the in-process mesh")
        if out["k11_launches"] != 2 + 2 * gloo_cap:   # one shard a rank
            raise AssertionError(f"gloo rank {r}: {out['k11_launches']} K11 "
                                 f"launches, expected {2 + 2 * gloo_cap}")
        if not 0 < int(out["pcg_sharded_cuda"]["ranks"][1]) < gloo_cap:
            raise AssertionError(f"gloo rank {r}: the CG did not iterate to "
                                 f"convergence")
    print(f"gloo, {GLOO_RANKS} ranks with CUDA tensors on one card: "
          f"pcg_sharded, pcg_sharded_cuda and sharded_sqp_solve(fused_pcg) "
          f"bit-equal to the in-process mesh of {GLOO_RANKS} shards on every "
          f"rank, CG iterations "
          f"{int(rank_outs[0]['pcg_sharded_cuda']['ranks'][1])}, "
          f"{rank_outs[0]['k11_launches']} K11 launches per rank; "
          f"{gloo_s:.1f} s with the ranks' start")
    k11_entry = next(k for k in kernels if k["name"].startswith("K11 "))
    k11_entry.update(
        launches_per_cg_step=2, launches_per_update=per_update,
        sharded_cg_ms=cg_ms, sharded_cg_iters=its_s,
        k4bg_device_us=k4bg_us,
        sharded_cg_device_ms={k: t / 1e3 for k, (t, _) in groups.items()},
        sharded_cg_profile_complete=complete,
        sharded_solve_ms=solve_ms, sharded_loop_ms_per_update=loop_ms,
        plain_loop_ms_per_update=loop_ref_ms, gloo_ranks_bit_equal=True)
    print(f"phase 9 (sharded paths): {time.perf_counter() - t_phase:.1f} s")

    # ---- 10. the cluster forms: K5's dual solve (K9p shares its body) and
    # K6 across one thread-block cluster
    t_phase = time.perf_counter()

    def mega_plan(n_c, kind=k5.SOLVE_PCG, cluster=0, stair=-1):
        """(C, stair bands on chip, grid) of a cluster launch, or None."""
        plan = (ctypes.c_int * 3)()
        ok = lib.mpc_mega_cluster_plan(n_c, kind, cluster, stair, plan)
        return tuple(plan) if ok else None

    def cluster_smem_kb(n_c, c, stair):
        """A block's dynamic shared memory in KB: pcg_common.cuh's
        cluster_cg_floats, or the merit stage's groups where those take
        more."""
        nk = -(-n_c // c)
        return F32 * max((6 if stair else 3) * nk * NX * NX
                         + 8 * (nk + 2) * NX + 34, MERIT_AREAS_FLOATS) / 1024

    cluster_kernels = (("K5", "15sqp_mega_kernelE"),
                       ("K9p", "24sqp_iter_mega_pcg_kernelE"),
                       ("K6", "17bcr_pcg_dz_kernelE"))
    found = _lib.ptxas_resources(build_log, [f for _, f in cluster_kernels])
    for kid, fragment in cluster_kernels:
        print(f"{kid} (cluster form) ptxas: {found[fragment][0]}")
    for n_c in CLUSTER_KNOTS:
        c, on, grid = mega_plan(n_c)
        print(f"K5 N = {n_c}: C = {c}, grid {grid}, stair bands "
              f"{'on chip' if on else 'in L2'}, "
              f"{cluster_smem_kb(n_c, c, on):.1f} KB of dynamic shared "
              f"memory a block; K6 C = {lib.mpc_bcr_cluster(n_c, 0)}")

    # K5 against the plain version at every horizon and admitted cluster
    # size: decisions and CG counts identical; X, U at rtol 1e-3, atol
    # 1e-5 (atol 1e-4 at rho 1e-3: lam's float32 deviation on the condition
    # ~1e7 system passes through Qinv, entries to 1/rho, and the grid form
    # K5g is 5.6e-5 from the plain version at N = 2, bit for bit where the
    # cluster form is); lam at atol 1e-3 at rho 1e-3, else rtol 1e-3, atol
    # 1e-4
    tab = _lib.model_tables(model)
    err5c, k5_read = 0.0, {}
    for n_c in CLUSTER_KNOTS:
        for rho0 in (cfg.rho_init, 0.3):
            args, kw_c = long_mega_args(n_c, rho0)
            ref = k5.sqp_solve_mega_pcg_reference(*args, **kw_c)
            for c in (16, 8):
                plan = mega_plan(n_c, cluster=c)
                if plan is None:
                    continue
                with _watchdog(FIRST_LAUNCH_DEADLINE):
                    out = k5._launch(lib, tab, *args[1:], grid=plan[2],
                                     stream=_lib.stream_of(args[1]),
                                     cluster=c, **kw_c)
                    sync()
                label = f"K5 cluster C = {c}, N = {n_c}, rho {rho0:g}"
                read = int(k5.sqp_solve_mega_pcg.cluster_size)
                k5_read[f"{n_c}/{c}"] = read
                if read != c:
                    raise AssertionError(f"{label}: the kernel read "
                                         f"%cluster_nctarank = {read}")
                for f in ("pcg_iters", "accepted", "sqp_iters", "bailed"):
                    if not torch.equal(getattr(out, f), getattr(ref, f)):
                        raise AssertionError(
                            f"{label}: {f} {getattr(out, f).tolist()} vs "
                            f"plain {getattr(ref, f).tolist()}")
                x_atol = 1e-4 if rho0 == cfg.rho_init else 1e-5
                lam_tol = (0, 1e-3) if rho0 == cfg.rho_init else (1e-3, 1e-4)
                err = max(checked(f"{label} X, U", [(out.X, ref.X),
                                                    (out.U, ref.U)],
                                  1e-3, x_atol),
                          checked(f"{label} lam", [(out.lam, ref.lam)],
                                  *lam_tol))
                err5c = max(err5c, err)
                print(f"{label}: kernel read C = {read}; CG "
                      f"{out.pcg_iters.tolist()} as plain, accepted "
                      f"{out.accepted.tolist()}; max error {err:.3e}")

    # K6 against the plain version (the seeded random system, K6's
    # tolerances) at every power of 2 up to 512 and admitted cluster size,
    # CG counts and hit identical; its factor against K7's cluster factor,
    # bit for bit (no kernel on the card runs the one-block factor)
    err6c, k6_read = 0.0, {}
    for n_c in CLUSTER_BCR_KNOTS:
        ks_r = systems.random_knot_schur(n_c, device=dev)
        lam0_c = torch.zeros(n_c, NX, device=dev)
        ref = k6.bcr_pcg_dz_reference(ks_r, lam0_c, 40, 5e-5)
        size = lib.mpc_bcr_scratch_floats(n_c)
        k7_fac = torch.zeros(size, device=dev)
        k7._launch_dz(lib, ks_r, _lib.stream_of(lam0_c), scratch=k7_fac)
        for c in (16, 8):
            if lib.mpc_bcr_cluster(n_c, c) != c:
                continue
            fac = torch.zeros(size, device=dev)
            with _watchdog(FIRST_LAUNCH_DEADLINE):
                out = k6._launch(lib, ks_r, lam0_c, 40, 5e-5,
                                 _lib.stream_of(lam0_c), scratch=fac,
                                 cluster=c)
                sync()
            label = f"K6 cluster C = {c}, N = {n_c}"
            read = int(k6.bcr_pcg_dz.cluster_size)
            k6_read[f"{n_c}/{c}"] = read
            if read != c:
                raise AssertionError(f"{label}: the kernel read "
                                     f"%cluster_nctarank = {read}")
            if int(out[3]) != int(ref[3]) or bool(out[4]) != bool(ref[4]):
                raise AssertionError(f"{label}: CG {int(out[3])} (hit "
                                     f"{bool(out[4])}) vs plain {int(ref[3])}"
                                     f" ({bool(ref[4])})")
            if not torch.equal(fac, k7_fac):
                raise AssertionError(f"{label}: the factors differ from "
                                     f"K7's")
            err6c = max(err6c, tight_bcr(label, out, ref))
            print(f"{label}: kernel read C = {read}; CG {int(out[3])} as "
                  f"plain; factors bit-equal to K7's")

    # a CG step's device time: a solve less the same solve with the CG
    # capped at 0 (the stages, or the factor, the first residual and
    # apply and dz), over its CG steps (every K5 CG at the cap at rho 1e-3)
    def step_us(run, run0, tag, steps):
        full, base = _device_us(run, tag), _device_us(run0, tag)
        if full is None or base is None or not steps:
            return full, base, None
        return full, base, (full - base) / steps

    steps5 = {}
    for n_c in CLUSTER_STEP_KNOTS:
        args, kw_c = long_mega_args(n_c, cfg.rho_init)
        args0 = (*args[:9], 0, *args[10:])
        forms = {"K5g": (k5.SOLVE_PCG_GRID, -1, "K5g")}
        for stair, name in ((-1, "K5"), (1, "K5 stair on chip"),
                            (0, "K5 stair in L2")):
            if mega_plan(n_c, stair=stair) is not None:
                forms[name] = (k5.SOLVE_PCG, stair, "K5")
        row = {}
        for name, (kind, stair, tag) in forms.items():
            grid = k5.check_mega_fit(n_c, lib, kind, stair)

            def go(a, kd=kind, st=stair, g=grid):
                return k5._launch(lib, tab, *a[1:], grid=g,
                                  stream=_lib.stream_of(a[1]), kind=kd,
                                  stair=st, **kw_c)

            its = int(go(args).pcg_iters.clamp(min=0).sum())
            full, base, step = step_us(lambda: go(args), lambda: go(args0),
                                       tag, its)
            row[name] = {"grid": grid, "device_us": full, "stages_us": base,
                         "cg_steps": its, "cg_step_us": step}
            if kind == k5.SOLVE_PCG_GRID:
                row[name]["plan"] = plan = k5.grid_plan(n_c, lib)
                print(f"N = {n_c} K5g plan: C = {plan.cluster}, G = "
                      f"{plan.clusters} clusters, grid {plan.grid}, place "
                      f"{plan.place} (3: S's and the stair's bands and the "
                      f"vectors on chip; 0: all in L2)")
            before = (f" (one-thread recursions: "
                      f"{ONE_THREAD_K5_STAGES_US[n_c]} us; one-thread merit "
                      f"contribution: {ONE_THREAD_MERIT_K5_STAGES_US[n_c]} "
                      f"us)"
                      if name == "K5" and n_c in ONE_THREAD_K5_STAGES_US
                      else "")
            print(f"N = {n_c} {name}: grid {grid}, {_us(full)} a solve, "
                  f"{_us(base)} with the CG capped at 0{before}, {its} CG steps: "
                  f"{'not profiled' if step is None else f'{step:.2f} us'} "
                  f"a CG step")
        steps5[str(n_c)] = row

    steps6 = {}
    for n_c in (n, *LONG_BCR_KNOTS):
        if n_c == n:
            ks_c, cap_c, tol_c = ks_np, cap, tol
        else:
            r6 = k6l_rows[n_c]
            ks_c, cap_c, tol_c = r6["ks"], r6["cap"], r6["tol"]
        lam0_c = torch.zeros(n_c, NX, device=dev)
        its = int(k6.bcr_pcg_dz(ks_c, lam0_c, cap_c, tol_c)[3])
        full, base, step = step_us(
            lambda: k6.bcr_pcg_dz(ks_c, lam0_c, cap_c, tol_c),
            lambda: k6.bcr_pcg_dz(ks_c, lam0_c, 0, tol_c), "K6", its)
        steps6[str(n_c)] = {"device_us": full, "no_cg_us": base,
                            "cg_steps": its, "cg_step_us": step}
        print(f"K6 N = {n_c}: {_us(full)} a solve, {_us(base)} with the CG "
              f"capped at 0 (factor, first apply, dz), {its} CG steps: "
              f"{'not profiled' if step is None else f'{step:.2f} us'} a "
              f"CG step")
    for k in kernels:
        kid = k["name"].split()[0]
        if kid == "K5":
            k.update(cluster_check_max_abs_err=err5c,
                     cluster_size_read=k5_read, cg_step_by_n=steps5)
        elif kid == "K6":
            k.update(cluster_check_max_abs_err=err6c,
                     cluster_size_read=k6_read, cg_step_by_n=steps6)
    print(f"phase 10 (cluster forms): {time.perf_counter() - t_phase:.1f} s")

    # ---- 11. K10's forms: each arm's CG across a thread-block cluster of
    # its own (the cluster form), and the one-block form past that fit
    t_phase = time.perf_counter()
    found = _lib.ptxas_resources(build_log, ["22sqp_mega_packed_kernel",
                                             "30sqp_mega_packed_cluster_kernel"])
    for frag, (regs, stack) in found.items():
        print(f"K10 ptxas {frag[2:]}: {regs} | {stack}")

    def packed_args(n_p, b_p, rhos, same=False, tol_p=None):
        """b_p arms at horizon n_p as phase 8 starts them (long_start,
        seeds 5 + a, or seed 5 for every arm when same), cold duals, the
        horizon's cap and exit tolerance (or tol_p)."""
        starts = [long_start(n_p, seed=5 if same else 5 + a)
                  for a in range(b_p)]
        X0, U0, g0, xs0 = starts[0]
        cl = long_cfg(n_p)
        return ((model, torch.stack([st[0] for st in starts]),
                 U0.expand(b_p, n_p - 1, NU).contiguous(),
                 g0.expand((b_p,) + g0.shape), xs0.expand(b_p, NX).contiguous(),
                 torch.zeros(b_p, n_p, NX, device=dev),
                 torch.tensor(rhos, device=dev), torch.ones(b_p, device=dev),
                 cl.pcg.max_iter, tol_p or default_pcg_exit_tols(n_p)[0],
                 SQP_ITERS), long_kw(n_p))

    def packed_launch(args, kw_p, plan, cap_p=None):
        a = (*args[1:8], args[8] if cap_p is None else cap_p, *args[9:])
        return k10._launch_packed(lib, tab, *a, grid=plan.grid,
                                  stream=_lib.stream_of(args[1]),
                                  cluster=plan.cluster, stair=plan.stair,
                                  **kw_p)

    def plan_text(plan):
        form = (f"cluster form, C = {plan.cluster}, stair bands "
                f"{'on chip' if plan.stair else 'in L2'}"
                if plan.cluster else "one-block form")
        return f"{form}, grid {plan.grid}"

    def k10_form_check(n_p, b_p, rhos, cluster=0, same=False, f64=False,
                       tol_p=None):
        """K10 in the planned form (cluster 0) or a forced one (2-16 that
        cluster size, -1 the one-block form) against the plain version:
        sqp_iters, bails and the shared CG count equal; X, U at rtol 1e-3,
        atol 1e-5 (1e-4 at rho 1e-3, phase 10's K5 precedent at long
        horizons); lam at atol 1e-3 where every rho is 1e-3 (every CG at
        the cap, on a system of condition ~1e7), else at the JAX megakernel
        test's rtol 1e-3, atol 1e-4 -- with f64, against the float64 plain
        version."""
        args, kw_p = packed_args(n_p, b_p, rhos, same, tol_p)
        plan = k10.packed_plan(n_p, b_p, cfg.num_alphas, lib, cluster)
        with _watchdog(FIRST_LAUNCH_DEADLINE):
            out = packed_launch(args, kw_p, plan)
            sync()
        label = f"K10 N = {n_p}, B = {b_p}, rhos {rhos[:2]}"
        read = int(k10.sqp_solve_mega_pcg_packed.cluster_size)
        if read != plan.cluster:
            raise AssertionError(f"{label}: the kernel read cluster size "
                                 f"{read}, planned {plan.cluster}")
        ref = k10.sqp_solve_mega_pcg_packed_reference(*args, **kw_p)
        for f in ("sqp_iters", "bailed", "pcg_iters_total"):
            if not torch.equal(getattr(out, f), getattr(ref, f)):
                raise AssertionError(
                    f"{label}: {f} {getattr(out, f).tolist()} vs plain "
                    f"{getattr(ref, f).tolist()}")
        cold = max(rhos) <= cfg.rho_init
        err = checked(f"{label} X, U", [(out.X, ref.X), (out.U, ref.U)],
                      1e-3, 1e-4 if cold else 1e-5)
        lam_err = _max_err([(out.lam, ref.lam)])
        note = ""
        if f64:
            ref64 = k10.sqp_solve_mega_pcg_packed_reference(
                iiwa14(device=dev, dtype=torch.float64),
                *(a.double() if torch.is_tensor(a) else a for a in args[1:]),
                **kw_p)
            lam64 = ref64.lam.to(torch.float32)
            err64 = checked(f"{label} lam against the float64 plain version",
                            [(out.lam, lam64)], 1e-3, 1e-4)
            own = _max_err([(ref.lam, lam64)])
            ratio = ((out.lam - ref.lam).abs() / (1e-4 + 1e-3 * ref.lam.abs())
                     ).max().item()
            note = (f"; lam {err64:.3e} from the float64 plain version (the "
                    f"float32 plain version: {own:.3e}), the JAX tolerance "
                    f"ratio against the float32 plain version {ratio:.3f}")
        else:
            checked(f"{label} lam", [(out.lam, ref.lam)],
                    *((0, 1e-3) if cold else (1e-3, 1e-4)))
        if same and not all(torch.equal(t, t[:1].expand_as(t))
                            for t in (out.X, out.U, out.lam)):
            raise AssertionError(f"{label}: arms with the same inputs "
                                 f"differ")
        print(f"{label}: {plan_text(plan)}, read C = {read}; shared CG "
              f"{int(out.pcg_iters_total)} as plain (cap "
              f"{args[8] * SQP_ITERS}), sqp_iters {out.sqp_iters.tolist()}; "
              f"max error {max(err, lam_err):.3e}{note}")
        return plan, out, max(err, lam_err)

    # The shared CG count is compared at rhos where the CGs exit before the
    # cap (0.1, 0.3 below N = 64; 0.3, 0.1 from N = 64, at N = 128 and 256
    # with K10_EARLY_TOL), and from N = 64 also at rho 1e-3, every CG at
    # the cap.  At N = 64, rhos 0.1, 0.3, SQP iteration 4's exit falls
    # within 0.07% of the tolerance, where the forms' etas scatter by about
    # 0.1%: some sizes C take 3 more steps (tools/packed_exit_probe.py).
    # At N = 7 two float32 solves part in lam by more than the JAX
    # tolerance (the one-block form and C = 16 from the plain version, on
    # the NVIDIA H100 80GB HBM3 at 700 W), so each form holds lam to the
    # float64 plain version there, at that tolerance.
    n_top = lib.mpc_mega_packed_max_knots(ARMS, cfg.num_alphas)
    err10c, forms10 = 0.0, {}
    for n_p in (*K10_KNOTS, n_top):
        early = (0.1, 0.3) if n_p < n else (0.3, 0.1)
        for rhos in (early,) + (((cfg.rho_init,) * ARMS,) if n_p >= n
                                else ()):
            if n_p == n_top and rhos == early:
                continue
            plan, out, err = k10_form_check(
                n_p, ARMS, rhos,
                tol_p=K10_EARLY_TOL.get(n_p) if rhos == early else None)
            if rhos == early and (int(out.pcg_iters_total)
                                  >= long_cfg(n_p).pcg.max_iter * SQP_ITERS):
                raise AssertionError(f"K10 N = {n_p} at rhos {rhos}: every "
                                     f"CG stopped at the cap")
            if not plan.cluster:
                raise AssertionError(f"K10 N = {n_p}, B = {ARMS}: the plan "
                                     f"is not the cluster form")
            err10c = max(err10c, err)
            forms10[f"N={n_p},B={ARMS}"] = plan_text(plan)
    for cluster in (0, 2, -1):
        plan, _, err = k10_form_check(K10_F64_KNOT, ARMS, (0.1, 0.3),
                                      cluster, f64=True)
        if cluster == 0:
            err10c = max(err10c, err)
            forms10[f"N={K10_F64_KNOT},B={ARMS}"] = plan_text(plan)
    for b_p in K10_ARMS:
        plan, _, err = k10_form_check(n, b_p, (cfg.rho_init,) * b_p)
        err10c = max(err10c, err)
        forms10[f"N={n},B={b_p}"] = plan_text(plan)
    for b_p in SWEEP_ARMS:
        forms10.setdefault(f"N={n},B={b_p}", plan_text(
            k10.packed_plan(n, b_p, cfg.num_alphas, lib)))
    # the one-block form past the cluster fit: the first pack at N = 16
    # that no co-resident clusters of 2 hold, every arm from the same
    # start, so that all exit their CGs together and come out bit-equal.
    # From 133 different starts some arms converge before the pack's
    # exit and step on, as the JAX kernel's do, and float32 drift there
    # differs between any two implementations (X parted from the plain
    # version by 6.0e-3, an NVIDIA H100 80GB HBM3 at 700 W).
    b_one = next((b_p for b_p in range(2, 1025)
                  if getattr(plan_or_none(16, b_p), "cluster", -1) == 0),
                 None)
    if b_one is None:
        raise AssertionError("K10: no pack at N = 16 takes the one-block "
                             "form")
    plan, _, err = k10_form_check(16, b_one, (cfg.rho_init,) * b_one,
                                  same=True)
    err10c = max(err10c, err)
    forms10[f"N=16,B={b_one}"] = plan_text(plan)
    for key, text in forms10.items():
        print(f"K10 plan {key}: {text}")
    print(f"K10 ceilings: N <= {n_top} at B = {ARMS}; the one-block form "
          f"from B = {b_one} at N = 16")
    # two launches on the same inputs: equal bits
    args, kw_p = packed_args(n, ARMS, (0.1, 0.3))
    plan = k10.packed_plan(n, ARMS, cfg.num_alphas, lib)
    one, two = packed_launch(args, kw_p, plan), packed_launch(args, kw_p, plan)
    sync()
    if not all(torch.equal(x, y) for x, y in zip(one, two)):
        raise AssertionError("K10: two launches on the same inputs differ")
    print(f"K10 N = {n}, B = {ARMS}: two launches bit-equal")

    # device time a call and a CG step (the solve less the solve with the
    # CG capped at 0, over the shared CG steps) at the cold start, beside
    # K5's step at the same N (phase 10): the difference is the shared
    # exit's part; and the one-block form at N = 64
    steps10 = {}
    for n_p, cluster in [(n_p, 0) for n_p in K10_STEP_KNOTS] + [(n, -1)]:
        args, kw_p = packed_args(n_p, ARMS, (cfg.rho_init,) * ARMS)
        plan = k10.packed_plan(n_p, ARMS, cfg.num_alphas, lib, cluster)
        its = int(packed_launch(args, kw_p, plan).pcg_iters_total)
        full, base, step = step_us(
            lambda: packed_launch(args, kw_p, plan),
            lambda: packed_launch(args, kw_p, plan, 0),
            "K10" if plan.cluster else "K10 one-block", its)
        k5_step = steps5.get(str(n_p), {}).get("K5", {}).get("cg_step_us")
        row = {"plan": plan_text(plan), "device_us": full, "stages_us": base,
               "cg_steps": its, "cg_step_us": step, "k5_cg_step_us": k5_step}
        share = (f"; K5's step {k5_step:.2f} us: the shared exit and the "
                 f"rest {100 * (step - k5_step) / step:.0f}% of K10's"
                 if step and k5_step else "")
        print(f"K10 N = {n_p}, B = {ARMS}, {plan_text(plan)}: {_us(full)} a "
              f"solve, {_us(base)} with the CG capped at 0, {its} shared CG "
              f"steps: {'not profiled' if step is None else f'{step:.2f} us'}"
              f" a CG step{share}")
        steps10[f"{n_p}/{'cluster' if plan.cluster else 'block'}"] = row

    # the one-block form's call at the K10 check's inputs (phase 3)
    k10_entry = next(k for k in kernels if k["name"].startswith("K10 "))
    plan_one = k10.packed_plan(n, ARMS, cfg.num_alphas, lib, -1)
    one_ms = _event_ms(lambda: k10._launch_packed(
        lib, tab, *k10_args[1:], grid=plan_one.grid,
        stream=_lib.stream_of(Xb), cluster=0, **k5_kw))

    # the packed two-arm loop at N = 128: warm duals, seeded arm starts
    n_l = K10_LOOP_KNOT
    cfg_pl = long_cfg(n_l)
    tol_pl = default_pcg_exit_tols(n_l)[0]
    start_pl = long_start(n_l)
    lam_pl = warm_lam(dataclasses.replace(cfg_pl, megakernel=True,
                                          megakernel_solve=True), start_pl)
    Xs_pl, Us_pl, lams_pl = arm_starts(start_pl[0], start_pl[1], lam_pl,
                                       dq[:ARMS])

    def packed_loop(run_cfg, n_up=LONG_UPDATES, timing=False):
        return simulate_mpc_scan_packed(model, run_cfg, xu_d, ee_d, Xs_pl,
                                        Us_pl, lams_pl, cfg.rho_init, tol_pl,
                                        n_up, timing=timing)

    packed_loop(cfg_pl, 2)
    pl_fused, _ = counted(
        f"packed N = {n_l}, {ARMS} arms, fused",
        lambda: packed_loop(cfg_pl, timing=True),
        {**none, "K1": LONG_UPDATES, "K10": LONG_UPDATES})
    pl_plain = packed_loop(dataclasses.replace(cfg_pl, fused_stages=False))
    for key in ("sqp_iters", "rho_bailed", "pcg_iters_total"):
        if not torch.equal(pl_fused[key].cpu(), pl_plain[key].cpu()):
            raise AssertionError(f"packed N = {n_l} {key}: fused "
                                 f"{pl_fused[key].tolist()} vs plain "
                                 f"{pl_plain[key].tolist()}")
    err_f = pl_fused["tracking_errors"].mean(1).tolist()
    err_p = pl_plain["tracking_errors"].mean(1).tolist()
    for a, (x1, x2) in enumerate(zip(err_f, err_p)):
        if not (x1 < 0.1 and x2 < 0.1) or abs(x1 - x2) > 5e-3:
            raise AssertionError(f"packed N = {n_l} arm {a}: mean error fused "
                                 f"{x1} vs plain {x2} (each under 0.1 m, "
                                 f"within 5e-3 m)")
    t_pl, calls_pl = _by_kernel(_device_events(
        lambda: packed_loop(cfg_pl))).get("K10", (0.0, 0))
    med_pl = statistics.median(pl_fused["update_ms"])
    packed_long = {"knots": n_l, "arms": ARMS, "updates": LONG_UPDATES,
                   "update_ms_median": med_pl,
                   "arm_updates_per_s": ARMS * 1e3 / med_pl,
                   "k10_device_ms": t_pl / 1e3 / calls_pl if calls_pl else None,
                   "mean_err_m": err_f, "plain_mean_err_m": err_p,
                   "sqp_iters": pl_fused["sqp_iters"].tolist(),
                   "pcg_iters_total": pl_fused["pcg_iters_total"].tolist()}
    print(f"packed N = {n_l}, {ARMS} arms: {json.dumps(packed_long)}")
    k10_entry.update(
        cluster_forms_max_abs_err=err10c, plans=forms10, cg_steps=steps10,
        packed_loop_n128=packed_long,
        form_launches_on_the_main_path=form_counts[main_packed],
        one_block_form={"ms": one_ms, "plain_ms": k10_entry["plain_ms"],
                        "bound_ms": k10_entry["bound_ms"],
                        "bound_by": k10_entry["bound_by"],
                        "plan": plan_text(plan_one),
                        "launches_on_the_main_path":
                            form_counts[main_packed]["one_block"],
                        "checked_past_the_cluster_fit": f"N = 16, B = {b_one}"})
    print(f"phase 11 (K10's forms): {time.perf_counter() - t_phase:.1f} s")

    # ---- 12. the cluster BCR forms: K7 and K7s (one cluster) and K9b (its
    # refined BCR solve and dz across the first cluster of its cooperative
    # launch).  No kernel on the card runs the one-block factor any more:
    # the forms are held to each other here and to the plain versions, and
    # tests/test_torch_csrc_host.py holds them to the one-block forms
    t_phase = time.perf_counter()
    bcr_forms = (("K7", "13bcr_dz_kernel"), ("K7s", "16bcr_solve_kernel"),
                 ("K9b", "24sqp_iter_mega_bcr_kernel"))
    found = _lib.ptxas_resources(build_log, [f for _, f in bcr_forms])
    for kid, fragment in bcr_forms:
        print(f"{kid} (cluster form) ptxas: {found[fragment][0]}")
    n9 = lib.mpc_mega_max_knots(k9.ITER_BCR)
    print(f"fit: K7 power-of-2 N <= {k7.check_bcr_dz_fit(2)}, K7s power-of-2 "
          f"N <= {k7.check_bcr_solve_fit(2)}; K9b's cluster form N <= {n9}, "
          f"power-of-2 N <= {1 << (n9.bit_length() - 1)}")
    # K7 at every admitted cluster size: tight against the plain refined
    # solve on the seeded random system (tests/test_bcr.py:62-74), by
    # residual on fixture 0_0's system at phase 8's perturbed start; its
    # factor against K7s's, bit for bit; its first launches at each N under
    # the watchdog; the forced split path (K7s, residual, K7s) against it
    err7c, k7_read, k7_res, k7_facs = 0.0, {}, {}, {}
    for n_c in K7_KNOTS:
        ks_r = systems.random_knot_schur(n_c, device=dev)
        st = _lib.stream_of(ks_r.gamma)
        ref = k7.bcr_dz_reference(ks_r)
        ks_f = long_system(n_c)[0]
        ref_f = k7.bcr_dz_reference(ks_f)[0]
        size = lib.mpc_bcr_scratch_floats(n_c)
        fac_s = torch.zeros(size, device=dev)
        k7._launch_solve(lib, ks_r.SL, ks_r.SD, ks_r.SU, ks_r.gamma, st,
                         scratch=fac_s)
        for c in (16, 8):
            if lib.mpc_bcr_dz_cluster(n_c, c) != c:
                continue
            fac = torch.zeros(size, device=dev)
            with _watchdog(FIRST_LAUNCH_DEADLINE):
                out = k7._launch_dz(lib, ks_r, st, scratch=fac, cluster=c)
                sync()
            label = f"K7 cluster C = {c}, N = {n_c}"
            read = int(k7.bcr_dz.cluster_size)
            k7_read[f"{n_c}/{c}"] = read
            if read != c:
                raise AssertionError(f"{label}: the kernel read "
                                     f"%cluster_nctarank = {read}")
            if int(out[3]) != 0 or bool(out[4]):
                raise AssertionError(f"{label}: reports CG iterations")
            err7c = max(err7c, tight_bcr(label, out, ref))
            if not torch.equal(fac, fac_s):
                raise AssertionError(f"{label}: the factors differ from "
                                     f"K7s's")
            k7_res[f"{n_c}/{c}"] = residual_pair(
                f"{label}, fixture 0_0", ks_f,
                k7._launch_dz(lib, ks_f, st, cluster=c)[0], ref_f)[0]
            print(f"{label}: kernel read C = {read}; factors bit-equal to "
                  f"K7s's")
        if n_c in K7_SPLIT_KNOTS:
            tight_bcr(f"split bcr_dz (K7s, residual, K7s) vs K7, N = {n_c}",
                      k7.bcr_dz(ks_r, split=True), k7.bcr_dz(ks_r))
        k7_facs[n_c] = fac_s
    # K7s at every admitted cluster size against the plain version (the
    # seeded random system, K6's tolerances); its factor against K7's
    # cluster factor, bit for bit
    err7sc, k7s_read = 0.0, {}
    for n_c in K7S_CLUSTER_KNOTS:
        ks_r = systems.random_knot_schur(n_c, device=dev)
        ref = k7.bcr_solve_reference(ks_r.SL, ks_r.SD, ks_r.SU, ks_r.gamma)
        size = lib.mpc_bcr_scratch_floats(n_c)
        k7_fac = torch.zeros(size, device=dev)
        k7._launch_dz(lib, ks_r, _lib.stream_of(ks_r.gamma), scratch=k7_fac)
        for c in (16, 8):
            if lib.mpc_bcr_solve_cluster(n_c, c) != c:
                continue
            fac = torch.zeros(size, device=dev)
            with _watchdog(FIRST_LAUNCH_DEADLINE):
                out = k7._launch_solve(lib, ks_r.SL, ks_r.SD, ks_r.SU,
                                       ks_r.gamma, _lib.stream_of(ks_r.gamma),
                                       scratch=fac, cluster=c)
                sync()
            label = f"K7s cluster C = {c}, N = {n_c}"
            read = int(k7.bcr_solve.cluster_size)
            k7s_read[f"{n_c}/{c}"] = read
            if read != c:
                raise AssertionError(f"{label}: the kernel read "
                                     f"%cluster_nctarank = {read}")
            err7sc = max(err7sc, tight_bcr(label, out, ref))
            if not torch.equal(fac, k7_fac):
                raise AssertionError(f"{label}: the factors differ from "
                                     f"K7's")
            print(f"{label}: kernel read C = {read}; factors bit-equal to "
                  f"K7's")
    # K9b at every admitted cluster size against the plain iteration, as in
    # phase 3: accept and bail equal, no CG; lam by residual; X, U and merit
    # against the plain iteration given the kernel's lam
    err9bc, k9b_read, k9b_plans, k9b_inputs = 0.0, {}, {}, {}
    for n_c in K9B_KNOTS:
        args, kw_c = long_mega_args(n_c, cfg.rho_init)
        a9 = (*args[:5], args[6], torch.tensor(1.0, device=dev), args[8])
        k9b_inputs[n_c] = (a9, kw_c)
        ref = k9.sqp_iter_mega_reference(*a9, **kw_c)
        own = mega_plan(n_c, k9.ITER_BCR)
        k9b_plans[n_c] = {"C": own[0], "grid": own[2]}
        print(f"K9b N = {n_c}: plan C = {own[0]}, grid {own[2]}")
        for c in (16, 8):
            plan = mega_plan(n_c, k9.ITER_BCR, c)
            if plan is None:
                continue
            with _watchdog(FIRST_LAUNCH_DEADLINE):
                out = k9._launch_iter(
                    lib, k9.ITER_BCR, tab, *a9[1:5], None, *a9[5:], 0, 0.0,
                    **kw_c, grid=plan[2], stream=_lib.stream_of(a9[1]),
                    cluster=c)
                sync()
            label = f"K9b cluster C = {c}, N = {n_c}"
            read = int(k9.sqp_iter_mega.cluster_size)
            k9b_read[f"{n_c}/{c}"] = read
            if read != c:
                raise AssertionError(f"{label}: the kernel read "
                                     f"%cluster_nctarank = {read}")
            for f in ("accept", "bail"):
                if not torch.equal(getattr(out, f), getattr(ref, f)):
                    raise AssertionError(f"{label}: {f} differs from the "
                                         f"plain iteration")
            if int(out.pcg_iters) != 0 or bool(out.hit_max):
                raise AssertionError(f"{label}: reports CG iterations")
            given, ks_b = systems.bcr_iteration_given_lam(*a9, out.lam,
                                                          **kw_c)
            residual_pair(label, ks_b, out.lam, ref.lam)
            err9bc = max(err9bc, checked(
                f"{label} X, U, merit against the plain iteration given its "
                f"lam", [(out.X, given.X), (out.U, given.U),
                         (out.merit, given.merit)], 1e-3, 2e-4))
            print(f"{label}: kernel read C = {read}, grid {plan[2]}; accept "
                  f"{bool(out.accept)} as plain")
    # device times a launch (the profiler), where the paths launch them;
    # K7 beside the split path it replaced at N = 128 (CUDA events, a call)
    bcr_us, k7_ms, k7_bounds = {}, {}, {}
    for n_c in K7_TIMED_KNOTS:
        ks_r = systems.random_knot_schur(n_c, device=dev)
        bcr_us[f"K7 N={n_c}"] = _device_us(lambda: k7.bcr_dz(ks_r), "K7")
        k7_ms[f"N={n_c}"] = _event_ms(lambda: k7.bcr_dz(ks_r))
        if n_c in K7_SPLIT_KNOTS:
            k7_ms[f"split N={n_c}"] = _event_ms(
                lambda: k7.bcr_dz(ks_r, split=True))
        k7_bounds[f"N={n_c}"] = _bound(*_k7_work(n_c))[0]
    print(f"K7 a call (ms, events): {k7_ms}; bounds (ms): {k7_bounds}")
    for n_c in K7S_LIBRARY_KNOTS:
        ks_r = systems.random_knot_schur(n_c, device=dev)
        bcr_us[f"K7s N={n_c}"] = _device_us(
            lambda: k7.bcr_solve(ks_r.SL, ks_r.SD, ks_r.SU, ks_r.gamma),
            "K7s")
    for n_c in K9B_TIMED_KNOTS:
        a9, kw_c = k9b_inputs[n_c]
        bcr_us[f"K9b N={n_c}"] = _device_us(
            lambda: k9.sqp_iter_mega(*a9, **kw_c), "K9b")
    for key, t in bcr_us.items():
        print(f"{key}: {_us(t)} a launch (device)")
    for k in kernels:
        kid = k["name"].split()[0]
        if kid == "K7":
            k.update(cluster_forms_max_abs_err=err7c, cluster_read=k7_read,
                     fixture_residuals=k7_res, call_ms=k7_ms,
                     bound_ms_by_n=k7_bounds,
                     device_us={key: t for key, t in bcr_us.items()
                                if key.startswith("K7 ")})
        elif kid == "K7s":
            k.update(cluster_forms_max_abs_err=err7sc,
                     cluster_read=k7s_read,
                     device_us={key: t for key, t in bcr_us.items()
                                if key.startswith("K7s")})
        elif kid == "K9b":
            k.update(cluster_forms_max_abs_err=err9bc,
                     cluster_read=k9b_read, plans=k9b_plans,
                     device_us={key: t for key, t in bcr_us.items()
                                if key.startswith("K9b")})
    print(f"phase 12 (cluster BCR forms): {time.perf_counter() - t_phase:.1f} "
          f"s")


    # ---- 13. the real-time host loop (sim.simulate_mpc) and what hangs
    # off it: the plant run for the measured solve time, the host loop
    # against the scan, the auto latch on pair 1_0, the fine-grained mode,
    # the wall-clock box and the flagship driver
    t_phase = time.perf_counter()
    from mpcgpu_tpu_torch.sim import simulate_mpc
    from mpcgpu_tpu_torch.sqp import (calibrated_iteration_budget,
                                      sqp_iteration, sqp_solve_timeboxed)
    card = smi.stdout.strip().splitlines()[0]
    window_us = max_substeps_for(cfg) * cfg.sim_step_time * 1e6
    host_paths = {}

    def rt_cfg(n_k, **kw):
        """The bench's solver at horizon n_k: sqp_max_iter SQP_ITERS, the
        tpu_tuned CG cap, the whole-solve kernel."""
        return SolverConfig.for_knots(n_k, **{
            "sqp_max_iter": SQP_ITERS,
            "pcg": PCGConfig(max_iter=PCGConfig.tpu_tuned_max_iter(n_k)),
            "fused_stages": True, "megakernel": True,
            "megakernel_solve": True, **kw})

    def per_update(counts, u_k):
        return {k: round(v / u_k, 3) for k, v in counts.items() if v}

    # the real-time loop: the plant runs for each solve's wall time
    rt_summary = {}
    for n_k in RT_KNOTS:
        c = rt_cfg(n_k)
        tol_k = default_pcg_exit_tols(n_k)[0]
        label = f"real-time loop N={n_k}"
        with _watchdog(FIRST_LAUNCH_DEADLINE):
            rec, counts = counted(label, lambda: simulate_mpc(
                model, c, xu, ee, pcg_exit_tol=tol_k,
                warmup_iters=RT_WARMUP, max_timesteps=RT_TIMESTEPS,
                const_update_freq=False), None)
        u_k = rec.control_updates
        solves = u_k + RT_WARMUP + 1
        if counts != {**none, "K1": u_k, "K2": solves, "K5": solves}:
            raise AssertionError(f"{label}: launch counts {counts}")
        st = np.asarray(rec.sqp_times_us)
        te = np.asarray(rec.tracking_errors)
        if (rec.timesteps != RT_TIMESTEPS or not np.isfinite(te).all()
                or not np.isfinite(rec.final_tracking_error)):
            raise AssertionError(f"{label}: {rec.timesteps} timesteps, "
                                 f"errors {te}")
        rt_summary[n_k] = {
            "updates": u_k, "solve_us_p50": float(np.percentile(st, 50)),
            "solve_us_p95": float(np.percentile(st, 95)),
            "solve_us_max": float(st.max()),
            "share_over_budget": float(np.mean(st > BOX_US)),
            "updates_past_rollout_window": int(np.sum(st > window_us)),
            "mean_err_m": float(te.mean()),
            "final_err_m": rec.final_tracking_error,
            "sqp_iters_mean": float(np.mean(rec.sqp_iters)),
            "rho_bails": int(np.sum(rec.sqp_exits)),
            "cg_cap_exit_rate": float(np.mean(rec.pcg_exits)),
            "launches_per_update": per_update(counts, u_k)}
        host_paths[label] = counts
        print(f"{label}: {card}: {json.dumps(rt_summary[n_k])}")
        if rt_summary[n_k]["mean_err_m"] > 0.1:
            raise AssertionError(f"{label}: mean tracking error over 0.1 m")

    # the host loop against the scan: constant period, the same updates
    c = rt_cfg(N_KNOTS)
    label = f"host loop, constant period N={N_KNOTS}"
    rec, counts = counted(label, lambda: simulate_mpc(
        model, c, xu, ee, pcg_exit_tol=tol, warmup_iters=0,
        max_control_updates=EQ_UPDATES), {**none, "K1": EQ_UPDATES,
                                          "K2": EQ_UPDATES,
                                          "K5": EQ_UPDATES})
    host_paths[label] = counts
    Xh, Uh = (torch.as_tensor(a, device=dev)
              for a in horizon_slices(xu, ee, N_KNOTS)[:2])
    scan = simulate_mpc_scan(model, c, xu_d, ee_d, Xh, Uh,
                             torch.zeros_like(Xh), rho, tol, EQ_UPDATES)
    scan_errs = scan["tracking_errors"][scan["shifted"].to(dev)]
    eq_err = float((torch.as_tensor(rec.tracking_errors, device=dev)
                    - scan_errs).abs().max())
    if (rec.sqp_iters != scan["sqp_iters"].tolist()
            or rec.sqp_exits != scan["rho_bailed"].tolist() or eq_err > 1e-3
            or len(rec.tracking_errors) != len(scan_errs)):
        raise AssertionError(f"{label}: against the scan: sqp_iters "
                             f"{rec.sqp_iters} / {scan['sqp_iters'].tolist()}"
                             f", tracking errors differ by {eq_err}")
    print(f"{label}: equal to simulate_mpc_scan in sqp_iters and bails, "
          f"tracking errors within {eq_err:.3e} m over "
          f"{len(rec.tracking_errors)} shifts")

    # auto on pair 1_0: the FK-made trace, the default thresholds
    xu10, ee10 = load_fixture_pair(repo / "tests" / "fixtures", 1, 0,
                                   model=model)
    jax_10 = json.loads((repo / "results" / "round4" / "tpu_all_pairs.json")
                        .read_text())["rows"]["1_0"]["auto"]
    label = f"auto on pair 1_0, N={N_KNOTS}"
    with _watchdog(FIRST_LAUNCH_DEADLINE):
        rec10, counts = counted(label, lambda: simulate_mpc(
            model, c, xu10, ee10, pcg_exit_tol=tol, warmup_iters=0,
            max_control_updates=AUTO_PAIR_UPDATES, linsys="auto"), None)
    u10, fo = rec10.control_updates, rec10.failed_over
    n_fo = int(sum(fo))
    if (u10 != AUTO_PAIR_UPDATES or fo != [False] * (u10 - n_fo) + [True] * n_fo
            or not np.isfinite(rec10.tracking_errors).all()):
        raise AssertionError(f"{label}: {u10} updates, failed_over {fo}")
    it_fo = n_fo * SQP_ITERS   # the staged loop runs every iteration
    want = {**none, "K1": u10, "K2": u10 + it_fo, "K5": u10 - n_fo,
            "K3": it_fo, "K6": it_fo}
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, expected "
                             f"{want}")
    host_paths[label] = counts
    auto10 = {"updates": u10,
              "failed_over_at": (u10 - n_fo) if n_fo else None,
              "failover_rate": n_fo / u10,
              "mean_err_m": float(np.mean(rec10.tracking_errors)),
              "rho_bail_rate": float(np.mean(rec10.sqp_exits)),
              "launches_per_update": per_update(counts, u10)}
    print(f"{label}: {card}: {json.dumps(auto10)}; the JAX record "
          f"(results/round4/tpu_all_pairs.json, its scan, 512 updates): "
          f"failed over {jax_10['failed_over']}, failover_rate "
          f"{jax_10['failover_rate']} (from about update "
          f"{round(512 * (1 - jax_10['failover_rate']))}), mean error "
          f"{jax_10['avg_tracking_error_m']} m")

    # the fine-grained mode: the plain phases, K4b as pcg_pallas's solve
    c32 = rt_cfg(32)
    label = "fine-grained loop N=32, pcg_pallas"
    with _watchdog(FIRST_LAUNCH_DEADLINE):   # K4b's first launch at N = 32
        rec_fg, counts = counted(label, lambda: simulate_mpc(
            model, c32, xu, ee, pcg_exit_tol=default_pcg_exit_tols(32)[0],
            warmup_iters=0, max_control_updates=FG_UPDATES,
            linsys="pcg_pallas", fine_grained_timing=True), None)
    k4b_kid = k4_kid(32, dz=False)
    if counts != {**none, "K1": FG_UPDATES,
                  k4b_kid: sum(rec_fg.sqp_iters)}:
        raise AssertionError(f"{label}: launch counts {counts}")
    host_paths[label] = counts
    # the median over the updates: the first one also pays the plain
    # modules' first calls
    phases = {k: [float(np.median(getattr(rec_fg, f"{k}_times_us"))),
                  float(getattr(rec_fg, f"{k}_times_us")[0])]
              for k in ("kkt", "schur", "linsys", "dz", "line_search")}
    print(f"{label}: {card}: device us an update by phase, [median, first "
          f"update] (CUDA events, {np.mean(rec_fg.sqp_iters):.2f} SQP "
          f"iterations an update): {json.dumps(phases)}; launches per "
          f"update {per_update(counts, FG_UPDATES)}")

    # the 2000 us box: K9p an iteration, each finished before the clock
    # is read again
    cbox = rt_cfg(N_KNOTS, sqp_max_iter=BOX_SQP_ITERS)
    lam_box = warm_lam(mega_cfg, start64)
    sqp_iteration(model, cbox, X, U, lam_box, goals, xs, rho, 1.0,
                  float("inf"), tol)
    one = torch.ones((), device=dev)
    inf = torch.full((), float("inf"), device=dev)
    it_us = []
    for _ in range(REPS):
        sync()
        t0 = time.perf_counter()
        sqp_iteration(model, cbox, X, U, lam_box, goals, xs, rho, one, inf,
                      tol)
        sync()
        it_us.append((time.perf_counter() - t0) * 1e6)
    per_iter_us = statistics.median(it_us)
    label = f"time box {BOX_US:.0f} us N={N_KNOTS}"
    boxes, counts = counted(label, lambda: [sqp_solve_timeboxed(
        model, cbox, X, U, lam_box, goals, xs, rho, tol, max_time_us=BOX_US)
        for _ in range(BOX_SOLVES)], None)
    box_iters = [int(b.stats.sqp_iters) for b in boxes]
    if counts != {**none, "K2": BOX_SOLVES,
                  "K9p": BOX_SOLVES + sum(box_iters)}:
        raise AssertionError(f"{label}: launch counts {counts}")
    host_paths[label] = counts
    budget = calibrated_iteration_budget(BOX_US, per_iter_us,
                                         cap=BOX_SQP_ITERS)
    print(f"{label}: {card}: iterations run {box_iters} (rho bails "
          f"{[bool(b.stats.rho_bailed) for b in boxes]}); an iteration "
          f"{per_iter_us:.1f} us on the host clock (median of {REPS}, "
          f"K9p, synced), calibrated_iteration_budget {budget}")

    # the flagship driver, in-process: a few timesteps, one tolerance
    spec = importlib.util.spec_from_file_location(
        "_track_iiwa_pcg_torch", repo / "examples" / "track_iiwa_pcg_torch.py")
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    with tempfile.TemporaryDirectory() as out_dir:
        _, counts = counted("driver track_iiwa_pcg_torch", lambda: driver.main(
            ["--max-timesteps", "2", "--warmup-iters", "1", "--tols",
             "5e-6", "--output-dir", out_dir]), None)
        dumps = sorted(p.name for p in Path(out_dir).iterdir())
    kinds = ("pcg_iters", "pcg_exits", "sqp_times", "sqp_iters", "sqp_exits",
             "tracking_errors", "tracking_path", "stats")
    missing = [k for k in kinds if f"32_PCG_5e-06_0_{k}.result" not in dumps]
    if missing or "32_PCG_5e-06_overall_stats.csv" not in dumps or not (
            counts["K1"] and counts["K5"] == counts["K2"]
            == counts["K1"] + 2):
        raise AssertionError(f"driver: files {dumps} (missing {missing}), "
                             f"launches {counts}")
    host_paths["driver track_iiwa_pcg_torch"] = counts
    print(f"driver track_iiwa_pcg_torch: {len(dumps)} files, launches "
          f"{counts}")
    print(f"phase 13 (real-time host loop): "
          f"{time.perf_counter() - t_phase:.1f} s")

    # ---- 14. the second robot: the planar 2R arm (nq = 2, nx = 4) with
    # its synthesized fixture, through the two-joint build of K1-K5 (lib2):
    # each kernel against its plain version at N = 16 and 64 (the JAX
    # hardware gate's tolerances), then the closed loops
    t_phase = time.perf_counter()
    from mpcgpu_tpu_torch.config import CostConfig
    from mpcgpu_tpu_torch.models.planar2r import planar2r
    from mpcgpu_tpu_torch.utils.synth import synthesize_tracking_fixture
    model2, d2 = planar2r(device=dev), dims_for(NQ2)
    nx2, nu2 = d2.nx, d2.nu

    def rel(got, want):
        """The largest error relative to the target's largest entry."""
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max().clamp_min(1e-12))

    nq2 = {}     # per N: errors, device us, loop summaries
    nq2_counts = {}
    for n2 in NQ2_KNOTS:
        tag = f"nq={NQ2} N={n2}"
        xu2, ee2 = synthesize_tracking_fixture(
            model2, q0=NQ2_Q0, amplitude=NQ2_AMPLITUDE, n_steps=4 * n2,
            dt=NQ2_DT)
        X2, U2, g2, xs2 = (torch.as_tensor(a, device=dev) for a in
                           horizon_slices(xu2, ee2, n2, nx=nx2))
        cfg2 = SolverConfig(
            knot_points=n2, state_size=nx2, control_size=nu2,
            timestep=NQ2_DT, sqp_max_iter=NQ2_SQP_ITERS,
            pcg=PCGConfig(max_iter=NQ2_CAP),
            cost=CostConfig(qd_cost=NQ2_QD_COST, r_cost=NQ2_R_COST))
        staged2 = dataclasses.replace(cfg2, fused_stages=True)
        mega2 = dataclasses.replace(staged2, megakernel=True,
                                    megakernel_solve=True)
        c2 = cfg2.cost
        rho2 = torch.tensor(cfg2.rho_init, device=dev)
        lam2 = torch.zeros_like(X2)
        res = {}
        # K3: S's and the stair's bands within 1e-4 of their largest
        # entry, the rest at K3's rtol 3e-3, atol 3e-3; gamma within 1e-3
        # of its largest entry at the gate's N = 16, and at every N no
        # farther from the float64 plain version than the float32 plain
        # version is, plus that 1e-3 (gamma = Q^-1 q - ... - c cancels
        # terms 1/rho larger: at N = 64 both float32 forms part from the
        # float64 one by about 4e-3 of its largest entry)
        a3 = (model2, X2, U2, g2, xs2, rho2, NQ2_DT, c2.qd_cost, c2.r_cost,
              cfg2.gravity)
        with _watchdog(FIRST_LAUNCH_DEADLINE):
            ks2 = k3.form_kkt_schur(*a3)
            sync()
        ks2_ref = k3.form_kkt_schur_reference(*a3)
        g64 = k3.form_kkt_schur_reference(
            planar2r(device=dev, dtype=torch.float64),
            *(t.double() for t in (X2, U2, g2, xs2, rho2)),
            *a3[6:]).gamma
        e3 = {f: rel(getattr(ks2, f), getattr(ks2_ref, f))
              for f in ("SL", "SD", "SU", "PL", "PD", "PU", "gamma")}
        e3["gamma_f64"] = rel(ks2.gamma, g64)
        e3["plain_gamma_f64"] = rel(ks2_ref.gamma, g64)
        if (max(e3[f] for f in ("SL", "SD", "SU", "PL", "PD", "PU")) >= 1e-4
                or (n2 == NQ2_KNOTS[0] and e3["gamma"] >= 1e-3)
                or e3["gamma_f64"] >= e3["plain_gamma_f64"] + 1e-3):
            raise AssertionError(f"K3 {tag}: relative errors {e3}")
        res["K3"] = checked(f"K3 {tag}", list(zip(ks2, ks2_ref)), 3e-3, 3e-3)
        print(f"K3 {tag}: relative errors {json.dumps(e3)}")
        # K4 on the plain K3's system
        with _watchdog(FIRST_LAUNCH_DEADLINE):
            k4o = k4.pcg_dz(ks2_ref, lam2, NQ2_CAP, NQ2_TOL)
            sync()
        k4r = k4.pcg_dz_reference(ks2_ref, lam2, NQ2_CAP, NQ2_TOL)
        its2 = int(k4o[3]), int(k4r[3])
        if not (abs(its2[0] - its2[1]) <= 2 or its2[0] == its2[1] == NQ2_CAP):
            raise AssertionError(f"K4 {tag}: CG iterations {its2}")
        res["K4"] = checked(f"K4 {tag}", list(zip(k4o[:3], k4r[:3])), 5e-3,
                            5e-3)
        plan2 = k4.pcg_plan(n2, lib2)
        print(f"K4 {tag}: plan {tuple(plan2)} (form, C, G, place, grid), "
              f"CG iterations {its2[0]} vs plain {its2[1]}")
        # K2 at the plain K4's step, twice bit-equal
        a2 = (model2, X2, U2, k4r[1], k4r[2], cfg2.num_alphas, g2, xs2,
              NQ2_DT, cfg2.merit_mu, c2.qd_cost, c2.r_cost, cfg2.gravity)
        m2, m2b = k2.line_search_merits(*a2), k2.line_search_merits(*a2)
        sync()
        if not torch.equal(m2, m2b):
            raise AssertionError(f"K2 {tag}: two launches differ")
        res["K2"] = checked(f"K2 {tag}",
                            [(m2, k2.line_search_merits_reference(*a2))],
                            2e-4, 2e-4)
        # K1: one control period from the fixture start under the plan U
        period2 = cfg2.simulation_period_us
        a1 = (model2, cfg2, xs2, U2, g2[0], period2, period2,
              max_substeps_for(cfg2))
        res["K1"] = checked(f"K1 {tag}", list(zip(
            k1.plant_rollout(*a1), k1.plant_rollout_reference(*a1))), 1e-4,
            1e-5)
        # the solves through sqp_solve: plain, staged (K3, K4, K2), whole
        # (K2, K5); K5 also against its own plain version
        solve = lambda c: sqp_solve(model2, c, X2, U2, lam2, g2, xs2, rho2,
                                    NQ2_TOL)
        r_plain = solve(cfg2)
        r_staged, counts_s = counted(f"sqp_solve staged {tag}",
                                     lambda: solve(staged2), None)
        with _watchdog(FIRST_LAUNCH_DEADLINE):
            r_mega, counts_m = counted(f"sqp_solve whole {tag}",
                                       lambda: solve(mega2), None)
        s2 = NQ2_SQP_ITERS
        k4id = "K4" if plan2.form == k4.CLUSTER else "K4g"
        if (counts_s != {**none, "K2": 1 + s2, "K3": s2, k4id: s2}
                or counts_m != {**none, "K2": 1, "K5": 1}):
            raise AssertionError(f"sqp_solve {tag}: launches {counts_s}, "
                                 f"{counts_m}")
        e5 = {"staged_vs_plain_x": rel(r_staged.X, r_plain.X),
              "whole_vs_staged_x": rel(r_mega.X, r_staged.X),
              "whole_vs_staged_lam": rel(r_mega.lam, r_staged.lam),
              "sqp_iters": [int(r.stats.sqp_iters)
                            for r in (r_plain, r_staged, r_mega)],
              "accepts_equal": bool(torch.equal(r_mega.stats.accepted,
                                                r_staged.stats.accepted))}
        print(f"sqp_solve {tag}: {json.dumps(e5)}")
        if not (e5["staged_vs_plain_x"] < 1e-2
                and e5["whole_vs_staged_x"] < 1e-3
                and e5["whole_vs_staged_lam"] < 1e-2
                and e5["sqp_iters"][1] == e5["sqp_iters"][2]
                and e5["accepts_equal"]):
            raise AssertionError(f"sqp_solve {tag}: {e5}")
        merit2 = k2.line_search_merits_reference(
            model2, X2, U2, torch.zeros_like(X2), torch.zeros_like(U2),
            cfg2.num_alphas, g2, xs2, NQ2_DT, cfg2.merit_mu, c2.qd_cost,
            c2.r_cost, cfg2.gravity)[cfg2.num_alphas]
        a5 = (model2, X2, U2, g2, xs2, lam2, rho2, 1.0, merit2, NQ2_CAP,
              NQ2_TOL, s2)
        kw5 = dict(dt=NQ2_DT, qd_cost=c2.qd_cost, r_cost=c2.r_cost,
                   gravity=cfg2.gravity, mu=cfg2.merit_mu,
                   num_alphas=cfg2.num_alphas, rho_factor=cfg2.rho_factor,
                   rho_min=cfg2.rho_min, rho_max=cfg2.rho_max,
                   rho_reset=cfg2.rho_reset)
        o5 = k5.sqp_solve_mega_pcg(*a5, **kw5)
        p5 = k5.sqp_solve_mega_pcg_reference(*a5, **kw5)
        sync()
        for f in ("accepted", "sqp_iters", "bailed"):
            if not torch.equal(getattr(o5, f), getattr(p5, f)):
                raise AssertionError(f"K5 {tag}: {f} differs from plain")
        if int((o5.pcg_iters - p5.pcg_iters).abs().max()) > 2 \
                or rel(o5.X, p5.X) >= 1e-2:
            raise AssertionError(f"K5 {tag}: CG iterations {o5.pcg_iters} "
                                 f"vs {p5.pcg_iters}, X {rel(o5.X, p5.X)}")
        res["K5"] = _max_err([(o5.X, p5.X), (o5.U, p5.U), (o5.lam, p5.lam)])
        print(f"K5 {tag}: CG iterations {o5.pcg_iters.tolist()} vs plain "
              f"{p5.pcg_iters.tolist()}, X within {rel(o5.X, p5.X):.3e} of "
              f"the largest entry, cluster size "
              f"{int(k5.sqp_solve_mega_pcg.cluster_size)}, grid "
              f"{k5.check_mega_fit(n2, lib2)}, fit N <= "
              f"{lib2.mpc_mega_max_knots(k5.SOLVE_PCG)}")
        # device time of one call of each kernel
        dev_us = {
            "K1": _device_us(lambda: k1.plant_rollout(*a1), "K1"),
            "K2": _device_us(lambda: k2.line_search_merits(*a2), "K2"),
            "K3": _device_us(lambda: k3.form_kkt_schur(*a3), "K3",
                             per_call=3),
            "K4": _device_us(lambda: k4.pcg_dz(ks2_ref, lam2, NQ2_CAP,
                                               NQ2_TOL), k4id),
            "K5": _device_us(lambda: k5.sqp_solve_mega_pcg(*a5, **kw5),
                             "K5")}
        print(f"{tag}: {card}: device us a call "
              f"{json.dumps({k: v and round(v, 1) for k, v in dev_us.items()})}")
        # the closed loops: staged (K3, K4, K2; K1) and the whole solve
        # (K2, K5; K1), each beside the plain loop, cold duals
        xu2_d, ee2_d = (torch.as_tensor(a, device=dev) for a in (xu2, ee2))
        u2 = NQ2_UPDATES

        def loop2(c, timing=False):
            return simulate_mpc_scan(model2, c, xu2_d, ee2_d, X2, U2, lam2,
                                     rho2, NQ2_TOL, u2, timing=timing)

        loops = {}
        for label, c, want in (
                ("staged pcg", staged2, {**none, "K1": u2, "K2": u2 + u2 * s2,
                                         "K3": u2 * s2, k4id: u2 * s2}),
                ("whole solve", mega2, {**none, "K1": u2, "K2": u2,
                                        "K5": u2}),
                ("plain", cfg2, none)):
            loop2(c)
            out, counts = counted(f"{label} loop {tag}",
                                  lambda: loop2(c, c.fused_stages), want)
            errs = out["tracking_errors"]
            if not torch.isfinite(errs).all() or float(errs.mean()) >= 0.10:
                raise AssertionError(f"{label} loop {tag}: tracking errors "
                                     f"{errs.tolist()}")
            loops[label] = {
                "mean_err_m": float(errs.mean()),
                "sqp_iters": out["sqp_iters"].tolist(),
                "rho_bailed": int(out["rho_bailed"].sum()),
                "pcg_iters_total": out["pcg_iters_total"].tolist(),
                "launches_per_update": per_update(counts, u2),
                "path": out["tracking_path"]}
            if c.fused_stages:
                loops[label]["update_ms_median"] = statistics.median(
                    out["update_ms"])
                nq2_counts[f"{label} loop {tag}"] = counts
        for label in ("staged pcg", "whole solve"):
            f, p = loops[label], loops["plain"]
            if (f["sqp_iters"], f["rho_bailed"]) != (p["sqp_iters"],
                                                     p["rho_bailed"]):
                raise AssertionError(f"{label} loop {tag}: sqp_iters / bails "
                                     f"differ from the plain loop")
            f["path_vs_plain_max"] = _max_err([(f["path"], p["path"])])
        for sm in loops.values():
            del sm["path"]
        print(f"loops {tag}: {card}: {json.dumps(loops)}")
        nq2[n2] = dict(err=res, device_us=dev_us, relerr_k3=e3, solve=e5,
                       loops=loops, args=dict(K1=a1, K2=a2, K3=a3, K5=a5),
                       ks=ks2_ref, lam=lam2, its=its2[0], kw5=kw5,
                       run_its=[int(i) for i in o5.pcg_iters.tolist()
                                if i >= 0], k4id=k4id)

    # the kernels line: each nq = 2 kernel at the main path's N = 64, its
    # N = 16 numbers beside it, its launches from the N = 64 loops
    n2 = NQ2_KNOTS[-1]
    e, a = nq2[n2], nq2[n2]["args"]
    by_n = lambda kid: {str(k): {"max_abs_err": v["err"][kid],
                                 "device_us": v["device_us"][kid]}
                        for k, v in nq2.items()}
    src, pal = "mpcgpu_tpu_torch/csrc/", "mpcgpu_tpu/ops/pallas/"
    steps2 = int(cfg2.simulation_period_us * 1e-6 / cfg2.sim_step_time
                 + 1e-9) + 1
    ks2_ref, lam2 = e["ks"], e["lam"]
    entries = (
        ("K1", "plant_rollout", "rollout.cu", "rollout_kernel.py:92",
         lambda: k1.plant_rollout(*a["K1"]),
         lambda: k1.plant_rollout_reference(*a["K1"]),
         steps2 * (d2.aba + 60) + d2.fk,
         F32 * (nx2 + (n2 - 1) * nu2 + 6 + d2.tab + nx2 + 1)),
        ("K2", "line_search_merits", "merit.cu", "merit_kernel.py:145",
         lambda: k2.line_search_merits(*a["K2"]),
         lambda: k2.line_search_merits_reference(*a["K2"]),
         _merits_ops(n2, 9, d2),
         F32 * (2 * (n2 * nx2 + (n2 - 1) * nu2) + n2 * 6 + nx2 + d2.tab
                + 9)),
        ("K3", "form_kkt_schur", "kkt_schur.cu", "kkt_schur_kernel.py:379",
         lambda: k3.form_kkt_schur(*a["K3"]),
         lambda: k3.form_kkt_schur_reference(*a["K3"]),
         n2 * d2.k3_knot,
         F32 * (n2 * nx2 + (n2 - 1) * nu2 + n2 * 6 + 1 + d2.tab
                + _knot_schur_floats(n2, d2))),
        ("K4", "pcg_dz", "pcg_dz.cu", "pcg_kernel.py:318",
         lambda: k4.pcg_dz(ks2_ref, lam2, NQ2_CAP, NQ2_TOL),
         lambda: k4.pcg_dz_reference(ks2_ref, lam2, NQ2_CAP, NQ2_TOL),
         _cg_ops(n2, e["its"], _spmv_ops(n2, d2), d2) + _dz_ops(n2, d2),
         F32 * (_knot_schur_floats(n2, d2) + n2 * nx2 + 2 * n2 * nx2
                + (n2 - 1) * nu2) + 5),
        ("K5", "sqp_solve_mega_pcg", "sqp_mega.cu",
         "sqp_megakernel.py:1027",
         lambda: k5.sqp_solve_mega_pcg(*a["K5"], **e["kw5"]),
         lambda: k5.sqp_solve_mega_pcg_reference(*a["K5"], **e["kw5"]),
         sum(n2 * d2.k3_knot + _cg_ops(n2, i, _spmv_ops(n2, d2), d2)
             + _dz_ops(n2, d2) + _merits_ops(n2, 8, d2)
             for i in e["run_its"]),
         F32 * (2 * (2 * n2 * nx2 + (n2 - 1) * nu2) + n2 * 6 + nx2 + d2.tab
                + 5) + 4 * (2 + 3 * NQ2_SQP_ITERS)))
    ptx2 = {"K1": ptxas_k2["K1"], "K2": ptxas_k2["K2 G = 8"],
            "K3": ptxas_k2["K3 stage 1"], "K4": ptxas_k2["K4"],
            "K5": ptxas_k2["K5"]}
    for kid, name, source, replaces, run, plain, ops, nbytes in entries:
        record(kid, f"{name} nq={NQ2}", src + source, pal + replaces,
               max(v["err"][kid] for v in nq2.values()), run, plain, ops,
               nbytes, nq=NQ2, knots=n2, by_knots=by_n(kid),
               device_us=e["device_us"][kid], ptxas=ptx2[kid])
        lkid = e["k4id"] if kid == "K4" else kid
        path, count = next(((p, c[lkid]) for p, c in nq2_counts.items()
                            if f"N={n2}" in p and c[lkid]), ("none", 0))
        if not count:
            raise AssertionError(f"{kid} nq={NQ2} was launched in no loop")
        kernels[-1].update(launches=count, path=path,
                           launches_per_update=count / NQ2_UPDATES)
    print(f"phase 14 (second robot, nq = {NQ2}): "
          f"{time.perf_counter() - t_phase:.1f} s")

    # ---- 15. the solver knobs (knob_phase)
    main_entry = {k["name"].split()[0]: k for k in kernels if "nq" not in k}
    for kid, entry in knob_phase(model, xu, ee, cfg, counted, card,
                                 systems).items():
        main_entry[kid]["knobs"] = entry

    # each kernel's launches: the first run of this slice's paths that
    # launched it (the default auto loop, its failover branch, the staged
    # loop, the packed loop, then this file's phase 6 loops)
    paths = (("auto", auto_counts), ("failover", fo_counts),
             ("staged", staged_counts), ("packed", packed_counts),
             ("staged bcr", bcr_counts),
             (f"staged bcr N={LONG_KNOTS}", long_counts_bcr),
             (f"staged bcr N={LONG_KNOTS}, split path forced", split_counts),
             ("pcg per-iteration megakernel", k9p_counts),
             ("bcr per-iteration megakernel", k9b_counts),
             ("pcg_pallas", pp_counts), *long_counts.items(),
             (f"knot-sharded loop N={SHARD_KNOTS}", shard_loop_counts))
    for k in kernels:
        if k.get("nq") == NQ2:   # phase 14's own loops counted these
            continue
        kid = k["name"].split()[0]
        # K8's horizons (N % 128 == 0) run K3, the former K6l's the cluster
        # K6: their launches on those paths
        if kid == "K8":
            found = ((p, c["K3"]) for p, c in long_counts.items() if c["K3"])
        elif kid == "K6l":
            found = ((p, c["K6"]) for p, c in long_counts.items()
                     if c["K6"] and "failover" in p)
        else:
            found = ((p, c[kid]) for p, c in paths if c[kid])
        path, count = next(found, ("none", 0))
        if not count:
            raise AssertionError(f"{kid} was launched in no closed loop")
        k["launches"], k["path"] = count, path
        k["host_loop_launches"] = {p: c[kid] for p, c in host_paths.items()
                                   if c.get(kid)}

    k10_entry["device_ms"] = packed["k10_device_ms"]
    k10_entry["sweep"] = sweep
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--phase", "15"]):
        raise SystemExit("usage: python3 chip_smoke.py [--phase 15]")
    sys.exit(knob_phase_alone() if sys.argv[1:] else main())
