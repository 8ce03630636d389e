"""Smoke test of the PyTorch/CUDA port (`dmosopt_tpu_torch`) on one GPU.

Run from the root of a checkout, with one CUDA device visible:

    python3 chip_smoke.py

It imports nothing of JAX nor of the JAX package. Phases, in order:

1. the card's name and power limit (nvidia-smi), and a check that TF32
   is off for float32 matrix products;
2. each hand-written kernel is built from the checkout and held
   against its plain PyTorch version on the same inputs on the card:
   the standalone Triton SBX and polynomial-mutation kernels at
   (100, 30) and (65536, 256), and the fused NSGA-II offspring kernel
   at the step of each path driven below (the quick start's 100 pairs
   of 30 genes from a population of 200, pool 100; the direct EA's 50
   pairs from a population of 100, pool 50; the file-backed run's 50
   pairs of 10 genes from a population of 100, pool 50) and at 65536
   pairs of 256 genes (population 131072, pool 65536), plus once with a live pool
   smaller than the pool, as an adaptive population size passes it,
   and the mutation kernel at the Lorenz run's (20480, 3) in its box;
   the SBX and mutation kernels at the constrained run's children call
   (100 pairs of 2 genes in TNK's box), and the fused kernel at the
   constrained run's step (50 pairs of 2 genes) and at the SA run's (50
   pairs of 10 genes) with distinct per-gene distribution indices, as the
   sensitivity analysis sets them; and the fused kernel's bucket launch
   (a leading tenants axis, one launch for the bucket) at ``bench.py``
   Config 11's 64 tenants of 8 pairs of 4 genes, at 16 tenants of the
   quick start's step and at Config 12's widest bucket (16 tenants of 8
   pairs of 7 genes, phase 15), with rates and per-gene indices that
   differ between tenants, and at phase 16's AGE-MOEA buckets (Config
   2's 3 tenants of 50 pairs of 30 genes, 16 DTLZ2 tenants of 50 pairs
   of 14 genes, population 100, pool 50), and the fused kernel at phase
   18's runner steps (32 pairs of 12 and of 24 genes from a population
   of 64, pool 32).
   For each it prints the device
   time per launch, the plain version's, the host time per call of
   both, the bytes the function must move, GB/s, and the bound;
3. direct NSGA-II on ZDT1 (pop 100, dim 30, 300 generations) on the
   card, held to the reference test's front oracle, with the kernel
   launch counters reset just before it and read just after;
4. the README quick start through `dmosopt_tpu_torch.run()` at full
   width (ZDT1 dim 30, pop 200, 100 generations, 3 epochs, 3 initial
   points per dimension, `gpr` defaults), with the counters reset just
   before it and read just after, and its result checked: archive size,
   finite values, a non-dominated returned set that is closer to the
   front than the initial design. Both runs must launch the fused
   offspring kernel once per generation and the standalone kernels
   never;
5. the host-objective run of ``examples/example_zdt1_file.py`` at its
   full width (ZDT1 of a parameter dict, 10 parameters, pop 100, 50
   generations, 5 initial points per dimension, 2 epochs, seed 21) on a
   thread pool of 4 workers in the default ``overlap_io`` pipeline,
   with the counters reset just before it and read just after: it must
   launch the fused kernel once per generation and the standalone ones
   never, archive every evaluated row once, and leave no thread behind.
   The chip machine has no h5py, so the run has no store and this phase
   no save-and-resume step (the CPU tests hold that path). Then the same
   configuration with an objective that sleeps 20 ms per call, in the
   ``serial`` and ``speculative`` pipelines in turns (serial,
   speculative, speculative, serial), printing each epoch's wall time,
   GP fit time and the wall the driver spent draining evaluations;
6. the many-objective run of ``examples/example_dtlz_many_objective.py``
   at full width (DTLZ2 with 5 objectives and 14 parameters as a
   batched torch objective, AGE-MOEA, pop 100, 100 generations, the
   "fast" adaptive termination, 5 initial points per dimension, 3
   epochs, resample fraction 0.5, seed 7, `gpr` defaults), with the
   counters reset just before it and read just after: the fused kernel
   must launch once per generation the criterion let run (the sum of
   the epochs' counts) and the standalone kernels never; the run
   evaluates at most 70 + 2 x 50 rows and the archive keeps each
   distinct one once, all finite; the
   returned set is non-dominated and on or outside the unit sphere
   (the DTLZ2 front); and the resampled rows dominate more hypervolume
   (reference point 2.5 per objective) than each of 20 seeded sets of
   as many uniform random points, drawn and evaluated on the card, and
   at least 1.07 times their median. The JAX package's resamples read
   1.09-1.13 times that median at this configuration; random
   resampling, a surrogate that predicts noise and a selection that
   keeps random survivors read about 1.00, 0.93 and 1.04. The median distance
   of the returned set to the sphere is printed beside the initial
   design's; it is no gate, since the JAX package does not bring it
   below the design's at this configuration either. Each epoch's
   wall, GP fit and its Adam steps, EA time, generations, stop reasons,
   the host time in termination checks and the kernel launches are
   printed;
7. the large-population run of ``examples/example_lorenz.py`` at full
   width (estimate (b, r, s) of the Lorenz system from a trajectory:
   ``benchmarks/lorenz.py``'s 3-objective function as a batched torch
   objective, pop 4096, ``["cmaes", "smpso"]`` over 2 epochs, no
   surrogate, 100 initial points per parameter, resample fraction 0.25,
   seed 0), cut to LORENZ_GENERATIONS generations an epoch (the example
   runs 50: an objective call is 4000 eager RK4 steps, about 2 s on the
   card whatever the batch), with the counters reset just before it and
   read just after: the mutation kernel must launch once per SMPSO
   generation (its turbulence step on all five swarms' 20 480 parents)
   and the others never; every evaluation is counted (the design, each
   optimizer's initial population, every generation's offspring), the
   archive is finite and holds each row once, the returned set is
   non-dominated, the objective reads 0 on every axis at the true
   parameters, the returned set's least total error (the sum of the
   objectives) is below the initial design's, and the final archive's
   median total error is below LORENZ_MEDIAN_BAR times that of as many
   uniform random points (the JAX package reads 0.80-0.82 at this depth,
   seeds 0-2, ``tools/lorenz_quality.py``; SMPSO with random survivors
   reads about 1.0). Each epoch's wall, generations, the time of its
   rank calls, archive dedupes and objective calls, and the extra device
   memory of its largest rank call are printed, and one rank of 45 056
   rows (the archive's full size) is timed with its peak memory, which
   must stay under 4 GB;
8. ``bench.py``'s Config 5 loop on the card: CMA-ES and SMPSO at pop
   4096 on the 2-objective Lorenz function (error and prior) through
   ``run_ea_loop``, one warm-up generation, then CONFIG5_GENERATIONS
   timed ones (the bench times 10), printing seconds and evaluations a
   second and kernel launches a generation (SMPSO one mutation launch,
   CMA-ES none); then the JAX package's CMA-ES and TRS solution-quality
   oracles (``tests/test_optimizers.py::test_cmaes_trs_solution_quality_oracles``:
   pop 200, 250 generations, ZDT1 dim 30 and DTLZ2 dim 12 with 3
   objectives) with its median and within-0.05 bars;
9. the constrained run of ``examples/example_tnk.py`` at full width (TNK
   as a host objective returning ``(y, c)``, 2 parameters in [1e-6, pi],
   the ``logreg`` feasibility model, NSGA-II, pop 100, 50 generations,
   20 initial points per parameter, 4 epochs, resample fraction 0.5,
   seed 1, `gpr` defaults) with a ``dynamic_initial_sampling`` hook
   that, while fewer than TNK_QUOTA evaluated rows are feasible, proposes
   200 SBX/mutation children of the feasible rows made on the card
   (`ParamSpacePoints` with parents), with the counters reset just
   before it and read just after: the fused kernel launches once per
   generation, SBX once and mutation twice per hook round that made
   children (at least one: the design holds fewer feasible rows than
   the quota), a feasibility model is fitted in each of the 4 epochs,
   every returned point is feasible and the set non-dominated, and the
   archive holds each row once, all finite. The resamples' feasible
   share and the returned set's hypervolume against (1.2, 1.2) are
   printed and not gated: at this configuration neither moves when the
   feasibility rank is replaced by noise, and the JAX package's readings
   span the noise copy's (``tools/tnk_quality.py``, PERF.md section 6).
   Then ``bench.py``'s Config 3 (AGE-MOEA with ``logreg``, pop 100, 100
   generations, 8 initial points per parameter, 5 epochs, resample 0.25,
   `gpr` with 4 starts and 100 steps, seed 42) with the same launch,
   feasibility and archive checks, printing its wall;
10. the sensitivity-guided run of ``examples/example_zdt1_sa.py`` at full
   width (ZDT1 with 10 parameters as a batched torch objective, NSGA-II,
   pop 100, 50 generations, 5 initial points per parameter, 3 epochs,
   resample fraction 0.5, seed 3, FAST sensitivity at 10 000 samples a
   parameter), with the counters reset just before it and read just
   after: the fused kernel launches once per generation and the
   standalone kernels never; each epoch's ``di_mutation`` vector is
   printed and held, with ``di_crossover``, against `analyze_sensitivity`
   recomputed from the epoch's fit moved to the host (1e-4 relative),
   beside the time of the 100 000-row surrogate evaluation on the card;
   DGSM runs once on the last fit, timed; the returned set is
   non-dominated and closer to the ZDT1 front than the initial design;
11. the reusing surrogate, ``bench.py`` Configs 8 and 9 on the card. (a)
   Config 9 Part A: at archives of 512, 2048 and 8192 rows in 30
   dimensions (nested), the posterior at fixed hyperparameters and the
   ``solve``, ``matmul`` and ``nystrom`` (512 inducing rows) predictors'
   time for 128 queries (best of 2, synchronized), cache builds and
   bytes, and the Nyström probe's ``distill_error``; every served
   regime is held to a float64 solve of the same posterior on the card
   (PREDICT_BARS). (b) Config 8 Part A: `gpr` fits (8 starts x 200
   steps) over 6 archives of 120 to 280 rows, cold and then with a warm
   refit controller, after one warm-up fit, printing the walls and the
   warm ``path_history``, which must start cold and reach warm and a
   rank update (0 Adam steps); the cold fits all run Adam; the warm
   schedule again with the matmul predictor, held after every rank
   update to a fresh solve of the updated fit. (c) Part B: the
   zdt1_agemoea_gpr run (``refit_params``: ZDT1 with 30 parameters as a
   batched torch objective, AGE-MOEA, pop 100, 100 generations, 8
   initial points per parameter, resample 0.25, `gpr` at 4 x 100, seed
   42; 3 epochs where the bench runs 5, a cut that pays for phase 15)
   cold, with ``surrogate_refit="warm"`` and with
   ``predictor="matmul"``, printing each run's wall and ``within_0.05``;
   each launches the fused kernel 300 times and the standalone kernels
   never, and keeps a distinct finite archive; the warm run's refit
   history starts cold and moves on. ``within_0.05`` is not gated: runs
   whose surrogate stays the first epoch's read within the cold runs'
   range (``tools/refit_quality.py``);
12. the sparse and deep surrogates, each run through run() with the
   counters reset just before it and read just after, launching the
   fused offspring kernel once per generation and the standalone
   kernels never, with phase 4's checks (every evaluation counted, a
   finite archive of distinct rows, a non-dominated returned set closer
   to the ZDT1 front than the design). (a) ZDT1 with 30 parameters,
   NSGA-II, pop 200, 100 generations, 2 epochs and a design of 150
   points per parameter (4500 rows, timed with and without its SLH
   decorrelation): past the 4096-row threshold every epoch fits `gpr`
   as `svgp` (1125 inducing rows, batch 256, 400 Adam steps); printed
   with it the sparse fit's ms an Adam step and kernel launches a step,
   ms a predict of 200 queries, the dense `gpr` fit's ms an Adam step
   at the 4096-row threshold, and the surrogate's error on the inner
   EA's offspring of the last 10 generations of each epoch (mean
   absolute error against ZDT1 over the design's standard deviation,
   averaged over the objectives). (b) At the quick start's width (3
   points per parameter), 2 epochs each: `vgp`, `svgp`, `spv`, `siv`,
   `crv`, `mdgp`, `mdspp`, `mdgp` with early stopping (its steps
   printed) and `egp` with ``large_n_threshold`` 64, which must be
   fitted as `svgp`; the `svgp` run's offspring error must stay under
   SPARSE_ERROR_BAR in both epochs, which a fit with a zeroed
   variational mean fails (``tools/sparse_quality.py``). (c) The same
   with `svgp` and ``optimize_mean_variance``: the resampled rows carry
   4 finite prediction columns. Each epoch's surrogate, fit wall, Adam
   steps, EA wall and logged accuracy are printed.

13. several problems and the problem-batched tenant core, each run
   through run() with the counters reset just before it and read just
   after. (a) ``bench.py`` Config 11 as the bench defines it
   (``bench.py:1044-1197``: ZDT1 with 4 parameters as a batched torch
   objective, pop 16, 8 generations, 2 epochs, `gpr` with 2 starts and 40
   steps, seed 0, random seed 17, resample fraction 0.5, 3 initial points
   per parameter, ``tenant_batching=True``) at 1, 16 and 64 problems,
   best of 2, printing the wall, tenants/s and the wall over one
   problem's: every problem of T > 1 is routed "batched" in both epochs,
   the fused kernel launches once a generation for the whole bucket (16
   a run at every T) and the standalone kernels never, and each
   problem's archive holds each row once, all finite, with a
   non-dominated returned set. (b) 16 problems at the quick start's
   width (2 epochs) against one problem's run, phase 4's quality gate on
   every problem. (c) 3 problems with ``feature_dtypes``, sequential, a
   caller's evaluator (used and not closed) and a
   ``surrogate_custom_training`` hook (called for every problem's every
   epoch, its model serving the fit): the feature records of each
   returned set.

14. telemetry on the card, each run through run() with the counters
   reset just before it and read just after. (a) The quick start with
   the default telemetry and a ``torch.profiler`` capture of epoch 1
   (``profile_dir``, ``profile_epochs=[1]``): the span tree, the epoch
   and generation counters, a device-clock ``device_busy_fraction`` in
   (0, 1], ``gp_fit`` and ``ea_scan`` rows with device time, and
   ``launch_offspring``'s kernel once a generation among the captured
   kernel events; printed with the overlap ratio and every row's device
   time. (b) The quick start with ``telemetry=False`` and with the
   default, interleaved, best of 2 each: both walls, printed without a
   gate. (c) ``bench.py`` Config 11 at 16 problems with a capture of
   epoch 1: the bucket's rows and each tenant's device seconds, whose
   sum must be within 5% of the bucket rows'.

15. the ask/tell service (`dmosopt_tpu_torch.OptimizationService`) on the
   card, every tenant a batched torch objective, with the counters reset
   just before each ``run()`` and read just after. (a) ``bench.py``
   Config 12 as the bench defines it (``bench.py:1200-1338``: ZDT1 at
   dims 4, 5, 6 and 7, round-robin, four static buckets, pop 16, 8
   generations, 2 epochs, 3 initial points per parameter, `gpr` with 2
   starts and 40 steps, ``min_bucket`` 2, seeds 100 + i) at T = 16 and
   64, lockstep against ``scheduler=True``, interleaved, best of 2,
   printing both walls, ``scheduler_speedup`` and the task graph's nodes
   at the last step: every tenant completes its epochs and streams a
   finite non-dominated front each epoch, the fused kernel launches 64
   times a run (4 buckets x 2 epochs x 8 generations) and the standalone
   kernels never, and each tenant's last front agrees between the modes
   within FRONT_RTOL (printed: bitwise or not). (b) One capture of step 1
   at T = 64 in each mode, the profiler warmed first: every bucket's
   ``gp_fit`` and ``ea_scan`` rows join with device time above 0 (under
   the scheduler their spans open on worker threads); both busy
   fractions and their ratio are printed, ungated. (c) T = 16 under the
   scheduler with a `FaultPlan` (two tenants' first batches raise once,
   a third's first three rows come back NaN, all in one bucket) and a
   skipping `EvalPolicy` with retries, through `FaultyEvaluator` over
   `TorchBatchEvaluator`: the clean buckets' tenants' last fronts agree
   with the fault-free run's within FRONT_RTOL, the faulty tenants report
   degraded or quarantined points. (d) The same service with
   ``exporter=True``: ``/metrics`` scraped after its first step parses
   with the port's parser and equals the registry's counters and gauges,
   ``/healthz`` answers, and ``close()`` joins the exporter's thread.
   (e) 16 tenants at the quick start's width (ZDT1 dim 30, pop 200, 100
   generations, 2 epochs) in one bucket under the scheduler: one fused
   launch a generation. The chip machine has no h5py, so no phase saves
   a front or a checkpoint; the CPU tests hold those paths.

16. AGE-MOEA buckets at full width, each run through run() with the
   counters reset just before it and read just after. (a) ``bench.py``
   Config 2 (``bench.py:274-333``: dim 30, pop 100, 100 generations, 8
   initial points per parameter, resample 0.25, `gpr` with 4 starts and
   100 steps, seed 42) with ZDT1, ZDT2 and ZDT3 as the three problems of
   one run with ``tenant_batching=True`` (each problem's objective a
   batched torch function of its own evaluator), CONFIG2_EPOCHS epochs
   where the bench runs 5, 10 and 5: every problem routed "batched" in
   every epoch, one fused launch a generation for the bucket and the
   standalone kernels never, each archive finite and holding each row
   once, each returned set non-dominated and closer to its front than
   its initial design; ZDT1's and ZDT2's ``within_0.05`` printed. (b) 16
   problems of the many-objective example's width (DTLZ2 with 5
   objectives and 14 parameters as a batched torch objective, AGE-MOEA,
   pop 100, 100 generations, no termination, 2 epochs) in one bucket:
   one launch a generation, and the resamples' exact hypervolume
   (reference point 2.5 per objective) over the median of 20 seeded
   sets of as many random points, the median over the tenants at least
   DTLZ2_HV_BAR; the same bucket with a survival that keeps random
   survivors must fall below that bar. The same problems with
   ``tenant_batching=False``, cut to DTLZ2_SEQ_EPOCHS epoch of
   DTLZ2_SEQ_GENERATIONS generations, give one tenant's sequential ms a
   generation beside the bucket's; both walls are printed.

17. the mesh on one card (one H100, so one device a rank). (a) The quick
   start through ``run(mesh=create_mesh(1))`` on a one-process NCCL
   group, with ``surrogate_mesh`` routing every epoch's fit to the
   row-sharded tiled Cholesky (`models.gp_sharded`): the routed fits
   counted (``gp_shard_fits_total``, no fall-back), the fused kernel
   once a generation, and phase 4's checks of the result. (b)
   ``bench.py`` Config 10's real-device cell at N = 8192 (dim 8, one
   objective, 2 starts, CONFIG10_ITERS Adam steps): `fit_gp_sharded` at
   world size 1 against `fit_gp_batch`, both walls printed (each after
   a warm-up call), the NMLL within rtol 5e-3 (atol 5e-3) and a
   128-query posterior within the CPU tests' tolerances (mean atol 2e-2,
   variance rtol 0.35). (c) Two ranks on the one card over gloo, which
   the mesh feeds through host copies, started by
   `parallel.loopback.launch_loopback_cluster`: the sharded rank of
   16 384 rows x 3 objectives bitwise equal to the single-device rank,
   and the sharded fit at 2048 rows within the same tolerances of
   `fit_gp_batch`.
18. the benchmark runner, the `dmosopt` shim and the CLI. (a)
   `benchmarks.runner.BenchmarkRunner` on the card at its defaults:
   ``run_tier(1)`` (DTLZ2, DTLZ1, DTLZ7 at 3 objectives and MaF2 at 5;
   AGE-MOEA, pop 64, 50 generations, 4 epochs, `gpr` with 4 starts and
   100 steps), then tier 3's MaF2 at 15 objectives, each with the
   counters reset just before it and read just after: the fused kernel
   once a generation the epochs report and the standalone ones never,
   each exact hypervolume trajectory monotone, and MaF2 at 15 objectives
   estimated by FPRAS on the card within three times the sum of the two
   half-widths of the port's CPU estimate of the same archive; each
   problem's wall, final hypervolume, method, half-width and trajectory
   printed. (b) The quick start's dict through
   `dmosopt_tpu_torch.dmosopt.run`, cut to SHIM_EPOCHS epochs, with phase
   4's checks. (c) An `OptimizationService` on the card with a status
   file and no checkpoint steps two ZDT1 tenants twice (one bucket, one
   launch a generation), and ``python -m dmosopt_tpu_torch.cli status``
   renders the file in a subprocess, as JSON (both tenants at epoch 2)
   and as the table. The fleet, the fleet rollup and the CLI's store
   commands need h5py, which the machine lacks; the phase says so on a
   line of its own.

``python3 chip_smoke.py --phases 2,9,10`` runs the named phases only
(phase 1 always), without the kernels and result lines.

The line before the last is a JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``. Any failed check raises, so
the script then exits non-zero without the ``ok`` line. Without a CUDA
device it exits with code 2 and prints no result.
"""

import json
import os
import subprocess
import sys
import time

# tolerances of the kernel-vs-plain comparison (float32): the kernels
# compute x**pw as exp2(pw*log2(x)) with the hardware's approximate
# exp2/log2 (relative error ~1e-7) and may contract a*b+c into one FMA.
# Mutation children are p + (ub-lb)*delta with |delta| <= 1, so their
# error stays near 1e-7. An SBX child is 0.5*((1-beta)*p1 + (1+beta)*p2)
# with beta up to ~3e3 as u -> 1, whose two products round at ~beta*ulp
# before they cancel, so SBX, and the offspring that hold SBX children,
# are held to 1e-4. The offspring kernel's operator tags must be exact.
ATOL = {"mutation": 1e-5, "sbx": 1e-4, "offspring": 1e-4}
# published H100 SXM peaks (NVIDIA data sheet), for the bound: HBM3
# bandwidth and float32 (non-tensor-core) FLOP rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# floating-point operations per element of each kernel (counted from
# the kernel source: pw, the power(s), the select, the children, clips);
# an offspring gene needs SBX's on a crossover slot, two mutations'
# otherwise
FLOPS_PER_ELEMENT = {"mutation": 20, "sbx": 25}
SHAPES = {"main": (100, 30), "large": (65536, 256)}
# the Lorenz run (phase 7): pop 4096, 5 swarms, 3 parameters in the
# sorted-key order (b, r, s) of examples/example_lorenz.py's box
LORENZ_POP, LORENZ_SWARMS = 4096, 5
LORENZ_MUTATION_SHAPE = (LORENZ_SWARMS * LORENZ_POP, 3)
LORENZ_BOX = ([1.0, 15.0, 5.0], [10.0, 35.0, 15.0])
LORENZ_SPACE = {"s": [5.0, 15.0], "r": [15.0, 35.0], "b": [1.0, 10.0]}
# generations per epoch in phase 7 (the example runs 50) and timed
# generations per optimizer in phase 8 (the bench runs 10): an objective
# call is 4000 eager RK4 steps, about 2e5 launches, whatever the batch
LORENZ_GENERATIONS = 5
CONFIG5_GENERATIONS = 3
# the Lorenz run's final archive must hold a median total error (the sum
# of the three objectives) below this fraction of as many uniform random
# points' (tools/lorenz_quality.py; PERF.md section 6)
LORENZ_MEDIAN_BAR = 0.9
# the children call of the constrained run's hook (phase 9): 100 pairs
# of TNK's 2 genes in its box
CHILDREN_SHAPE = (100, 2)
# offspring step shapes: (npairs, n, population, pool size); the SA run's
# step (phase 10) takes non-uniform per-gene distribution indices
OFFSPRING_SHAPES = {
    "main": (100, 30, 200, 100),
    "direct": (50, 30, 100, 50),
    "file": (50, 10, 100, 50),
    "many_objective": (50, 14, 100, 50),
    "constrained": (50, 2, 100, 50),
    "sa": (50, 10, 100, 50),
    # phase 18's runner: AGE-MOEA at pop 64 at each problem's width
    # (moo_benchmarks.generate_problem_space): tier 1's DTLZ2 (12
    # variables), DTLZ1 (7), DTLZ7 (22) and MaF2 at 5 objectives (14), and
    # tier 3's MaF2 at 15 objectives (24)
    "runner": (32, 12, 64, 32),
    "runner_dtlz1": (32, 7, 64, 32),
    "runner_dtlz7": (32, 22, 64, 32),
    "runner_maf2_m5": (32, 14, 64, 32),
    "runner_m15": (32, 24, 64, 32),
    "large": (65536, 256, 131072, 65536),
}
# the bucket launch of the problem-batched core: (tenants, (npairs, n,
# population, pool size)) at bench.py Config 11's step (pop 16, dim 4),
# at 16 tenants of the quick start's step, at the widest bucket of
# Config 12 at T = 64 (phase 15: 16 tenants of dim 7), and at phase 16's
# AGE-MOEA buckets
BUCKET_SHAPES = {
    "bucket_config11": (64, (8, 4, 16, 8)),
    "bucket_quick16": (16, (100, 30, 200, 100)),
    "bucket_config12": (16, (8, 7, 16, 8)),
    # AGE-MOEA buckets (phase 16): bench.py Config 2's three ZDT problems
    # and 16 DTLZ2 problems, pop 100 (50 pairs, a pool of 50)
    "bucket_age_config2": (3, (50, 30, 100, 50)),
    "bucket_age_dtlz2": (16, (50, 14, 100, 50)),
}
# calls queued per timing round: the kernels launch once per call, the
# standalone plain versions 15-25 times, the plain offspring step ~55
TIMING_CALLS = {"kernel": 100, "mutation": 12, "sbx": 12, "offspring": 6}


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def _device_ms_per_call(torch, fn, calls, rounds=5):
    """(device ms, host ms) of one call of ``fn``: the device time is the
    median over ``rounds`` of the time of ``calls`` back-to-back calls
    between one pair of CUDA events, divided by ``calls`` (an event pair
    around each call would add its own few microseconds to a kernel of
    about that length); the host time is the median time the host took
    to queue one call. Each round is queued behind a sleep kernel, so
    the host's launch overhead opens no gaps between the calls on the
    device; the check below fails the run if the sleep ended before the
    host had queued them all (it does when the stream's launch queue
    fills, so ``calls`` times the launches per call must stay in the
    hundreds)."""
    fn()
    torch.cuda.synchronize()
    event = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    per_call, host = [], []
    for _ in range(rounds):
        before, after, start, end = event(), event(), event(), event()
        t_sleep = time.perf_counter()
        before.record()
        torch.cuda._sleep(300_000_000)
        after.record()
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        enqueue_ms = (t1 - t_sleep) * 1e3
        sleep_ms = before.elapsed_time(after)
        assert enqueue_ms < sleep_ms, ("timing window not covered", enqueue_ms, sleep_ms)
        per_call.append(start.elapsed_time(end) / calls)
        host.append((t1 - t0) * 1e3 / calls)
    return sorted(per_call)[rounds // 2], sorted(host)[rounds // 2]


def _kernel_inputs(torch, name, B, n, seed, box=None):
    """Operands the main path hands the kernel, in its layout: uniforms,
    parents in the box (the unit box, or ``box``'s (lower, upper) rows),
    the bounds as the two (strided) columns of an (n, 2) tensor, di of 20
    (mutation) or 1 (SBX), rate 1/n."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=g, device="cuda")  # noqa: E731
    lo, hi = (torch.zeros(n, device="cuda"), torch.ones(n, device="cuda")) if box is None \
        else (torch.tensor(box[0], device="cuda"), torch.tensor(box[1], device="cuda"))
    bounds = torch.stack([lo, hi], dim=1)
    xlb, xub = bounds[:, 0], bounds[:, 1]
    if name == "mutation":
        di = torch.full((n,), 20.0, device="cuda")
        rate = torch.full((), 1.0 / n, device="cuda")
        return (rand(B, n), xlb + rand(B, n) * (xub - xlb), di, xlb, xub, rate)
    di = torch.full((n,), 1.0, device="cuda")
    return (rand(B, n), rand(B, n), rand(B, n), di, xlb, xub)


def _offspring_inputs(torch, npairs, n, pop, poolsize, seed, live=None,
                      per_gene_di=False):
    """Operands of the main path's offspring step, in its layout: a
    population in the unit box, a mating pool of distinct rows, the pair
    and gene uniforms as views of one draw, the pool size as 0-d device
    tensors (``live`` of the pool's slots, shift bound at least 2, when
    given, as an adaptive population size passes it), the default
    NSGA-II rates (pc 0.9, pm 0.1, rate 1/n, di 1 and 20) as device
    tensors, and the bounds as the strided columns of an (n, 2) tensor.
    With ``per_gene_di`` the distribution indices are distinct per gene
    in [1, 20], as the SA run's sensitivity sets them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    parm = torch.rand((pop, n), generator=g, device=dev)
    pool_idx = torch.randperm(pop, generator=g, device=dev)[:poolsize]
    draws = torch.rand(3 * npairs * (n + 1), generator=g, device=dev)
    r = draws[: 3 * npairs].view(3, npairs)
    u = draws[3 * npairs:].view(3, npairs, n)
    bounds = torch.stack([torch.zeros(n, device=dev), torch.ones(n, device=dev)], dim=1)
    pool_n = shift_hi = torch.tensor(poolsize, dtype=torch.int32, device=dev)
    if live is not None:
        pool_n = torch.tensor(live, dtype=torch.int32, device=dev)
        shift_hi = torch.clamp(pool_n, min=2)
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    di_x, di_m = torch.full((n,), 1.0, device=dev), torch.full((n,), 20.0, device=dev)
    if per_gene_di:
        di_m = 1.0 + 19.0 * torch.rand(n, generator=g, device=dev)
        di_x = di_m[torch.randperm(n, generator=g, device=dev)]
    return (parm, pool_idx, r, u, pool_n, shift_hi, scalar(0.9), scalar(0.1),
            scalar(1.0 / n), di_x, di_m, bounds[:, 0], bounds[:, 1])


def _offspring_work(torch, V, args, is_x, quiet=False):
    """(bytes, flops) the offspring step must move and do on these
    inputs: each pair's three uniforms, the gene uniforms its operator
    uses (one on a crossover slot, two on a mutation slot), the distinct
    pool slots and population rows it gathers, the per-gene vectors and
    rates once, the offspring and tags written once."""
    parm, pool_idx, r, u, pool_n, shift_hi = args[:6]
    npairs, n = u.shape[1], u.shape[2]
    i1, i2 = V._pair_indices(r, pool_n, shift_hi)
    slots = torch.unique(torch.cat([i1, i2]))
    rows = torch.unique(pool_idx[slots]).numel()
    nx = int(is_x.sum())
    nm = npairs - nx
    parts = {
        "pair uniforms": 4 * r.numel(),
        "gene uniforms used": 4 * n * (nx + 2 * nm),
        "pool slots": 8 * slots.numel(),
        "population rows": 4 * n * rows,
        "per-gene vectors and rates": 4 * 4 * n + 3 * 4,
        "offspring and tags": 4 * 2 * npairs * n + npairs,
    }
    if not quiet:
        print(f"   offspring {npairs}x{n}: {nx} crossover and {nm} mutation slots, "
              f"{rows} distinct rows gathered for {2 * npairs} parents; bytes {parts}")
    flops = n * (FLOPS_PER_ELEMENT["sbx"] * nx + 2 * FLOPS_PER_ELEMENT["mutation"] * nm)
    return sum(parts.values()), flops


def _row(torch, name, label, shape, err, kernel_fn, plain_fn, nbytes, flops):
    ms, host_ms = _device_ms_per_call(torch, kernel_fn, calls=TIMING_CALLS["kernel"])
    plain_ms, plain_host_ms = _device_ms_per_call(
        torch, plain_fn, calls=TIMING_CALLS[name]
    )
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    flops_ms = 1e3 * flops / F32_FLOPS_PER_S
    row = {
        "shape": list(shape), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "host_ms": host_ms, "plain_host_ms": plain_host_ms, "bytes": nbytes,
        "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
    }
    print(
        f"kernel {name} {label} {shape}: max_abs_err {err:.3e} (atol "
        f"{ATOL[name]:g}), {ms * 1e3:.2f} us/launch, plain {plain_ms * 1e3:.2f} us; "
        f"host {host_ms * 1e3:.2f} us/call, plain {plain_host_ms * 1e3:.2f} us/call; "
        f"{nbytes} B, {row['gb_per_s']:.1f} GB/s, bound "
        f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}, "
        f"{row['bound_ms'] / ms:.3f} of it reached)"
    )
    return row


def _check_offspring(torch, V, K, label, shape, live=None):
    """The fused kernel against `_offspring_core` on one input set:
    offspring within ATOL, operator tags bit-equal. Returns the args,
    the error and the tags."""
    npairs, n, pop, poolsize = shape
    args = _offspring_inputs(torch, npairs, n, pop, poolsize, seed=npairs + n,
                             live=live, per_gene_di=label == "sa")
    got, got_x = K.launch_offspring(*args)
    want, want_x = V._offspring_core(*args)
    torch.cuda.synchronize()
    assert got.shape == (2 * npairs, n) and bool(torch.isfinite(got).all()), label
    assert torch.equal(got_x, want_x), ("offspring operator tags differ", label)
    assert 0 < int(got_x.sum()) < npairs, ("one operator only", label)
    err = float((got - want).abs().max())
    assert err <= ATOL["offspring"], ("offspring", label, err)
    return args, err, got_x


def _bucket_inputs(torch, T, shape, seed):
    """A bucket's stacked operands, as the batched core hands them to one
    launch: each tenant's population, pool and uniforms from its own
    seed, per-gene distribution indices and bounds columns of a (T, n,
    2) tensor, and per-tenant rates that differ between tenants."""
    npairs, n, pop, poolsize = shape
    per = [_offspring_inputs(torch, npairs, n, pop, poolsize, seed=seed + t,
                             per_gene_di=True) for t in range(T)]
    args = [torch.stack([a[k] for a in per]) for k in range(13)]
    frac = torch.arange(T, device="cuda", dtype=torch.float32) / max(T - 1, 1)
    args[6] = 0.6 + 0.35 * frac  # crossover rates
    args[7] = 0.1 + 0.3 * frac  # mutation rates
    args[8] = (1.0 + (torch.arange(T, device="cuda") % 3).float()) / n
    bounds = torch.stack([args[11], args[12]], dim=2)  # (T, n, 2)
    args[11], args[12] = bounds[..., 0], bounds[..., 1]
    return args


def _check_bucket(torch, V, K, label, T, shape):
    """The fused kernel's bucket launch against `_offspring_core` on the
    same stacked operands: offspring within ATOL, tags bit-equal."""
    npairs, n = shape[:2]
    args = _bucket_inputs(torch, T, shape, seed=npairs + n + T)
    got, got_x = K.launch_offspring(*args)
    want, want_x = V._offspring_core(*args)
    torch.cuda.synchronize()
    assert got.shape == (T, 2 * npairs, n) and bool(torch.isfinite(got).all()), label
    assert torch.equal(got_x, want_x), ("bucket operator tags differ", label)
    assert 0 < int(got_x.sum()) < T * npairs, ("one operator only", label)
    err = float((got - want).abs().max())
    assert err <= ATOL["offspring"], ("bucket offspring", label, err)
    nbytes = flops = 0
    for t in range(T):
        b, f = _offspring_work(torch, V, [a[t] for a in args], got_x[t], quiet=True)
        nbytes, flops = nbytes + b, flops + f
    return args, err, nbytes, flops


def check_kernels(torch, V):
    """Phase 2: every kernel against its plain version, timed."""
    from dmosopt_tpu_torch.ops import _variation_kernels as K

    kernels = {
        "mutation": (K.launch_mutation, V._mutation_core, 72),
        "sbx": (K.launch_sbx, V._sbx_core, 90),
    }
    report = {}
    for name, (kernel, plain, line) in kernels.items():
        rows = {}
        # the constrained run's children call, one SBX and two mutation
        # launches on its parent pairs in TNK's box
        shapes = dict(SHAPES, children=CHILDREN_SHAPE)
        if name == "mutation":
            # SMPSO's turbulence step in the Lorenz run: all swarms' parents
            shapes["lorenz"] = LORENZ_MUTATION_SHAPE
        for label, (B, n) in shapes.items():
            box = {"lorenz": LORENZ_BOX, "children": ([TNK_BOX[0]] * n, [TNK_BOX[1]] * n)}.get(label)
            args = _kernel_inputs(torch, name, B, n, seed=B + n, box=box)
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            assert all(bool(torch.isfinite(a).all()) for a in got), name
            assert err <= ATOL[name], (name, label, err, ATOL[name])
            # each input read once, each output written once (a strided
            # bounds column is n words read)
            nbytes = sum(t.numel() * t.element_size() for t in (*args, *got))
            rows[label] = _row(
                torch, name, label, (B, n), err, lambda: kernel(*args),
                lambda: plain(*args), nbytes, FLOPS_PER_ELEMENT[name] * B * n,
            )
        report[name] = {
            "name": name,
            "route": "triton",
            "source": "dmosopt_tpu_torch/ops/_variation_kernels.py",
            "replaces": f"dmosopt_tpu/ops/variation.py:{line}",
            "rows": rows,
        }

    rows = {}
    for label, shape in OFFSPRING_SHAPES.items():
        args, err, is_x = _check_offspring(torch, V, K, label, shape)
        nbytes, flops = _offspring_work(torch, V, args, is_x)
        rows[label] = _row(
            torch, "offspring", label, shape, err, lambda: K.launch_offspring(*args),
            lambda: V._offspring_core(*args), nbytes, flops,
        )
        npairs, n = shape[:2]
        # every uniform and both parents' genes read once per pair, as a
        # chain of separate launches would have to read them
        all_bytes = 4 * (3 * npairs + 3 * npairs * n + 2 * npairs * n
                         + 2 * npairs * n + 4 * n) + npairs
        print(f"   offspring {label}: {all_bytes} B counting every uniform and "
              f"both parents per pair; bound {1e6 * all_bytes / HBM_BYTES_PER_S:.3f} us")
        rows[label]["bytes_all_uniforms_and_parents"] = all_bytes
    _, err, _ = _check_offspring(torch, V, K, "main, live pool 37 of 100",
                                 OFFSPRING_SHAPES["main"], live=37)
    print(f"kernel offspring main, live pool 37 of 100: max_abs_err {err:.3e}")
    for label, (T, shape) in BUCKET_SHAPES.items():
        # one launch for a bucket of T tenants (the batched core)
        args, err, nbytes, flops = _check_bucket(torch, V, K, label, T, shape)
        before = K.KERNEL_LAUNCHES["offspring"]
        K.launch_offspring(*args)
        assert K.KERNEL_LAUNCHES["offspring"] == before + 1, "one launch a bucket"
        rows[label] = _row(
            torch, "offspring", label, (T,) + tuple(shape), err,
            lambda: K.launch_offspring(*args), lambda: V._offspring_core(*args),
            nbytes, flops,
        )
    report["offspring"] = {
        "name": "offspring",
        "route": "triton",
        "source": "dmosopt_tpu_torch/ops/_variation_kernels.py",
        # one launch in place of both Pallas kernels and the ops around
        # them in the JAX generation (dmosopt_tpu/optimizers/nsga2.py:161-192)
        "replaces": "dmosopt_tpu/ops/variation.py:90",
        "also_replaces": "dmosopt_tpu/ops/variation.py:72",
        "rows": rows,
    }
    return report


def direct_ea(torch, V):
    """Phase 3: NSGA-II on ZDT1 with the reference test's oracle."""
    import numpy as np

    from dmosopt_tpu_torch import sampling
    from dmosopt_tpu_torch.benchmarks.zdt import distance_to_front, zdt1, zdt1_pareto
    from dmosopt_tpu_torch.optimizers.base import run_ea_loop
    from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2

    popsize, dim, gens = 100, 30, 300
    bounds = np.stack([np.zeros(dim), np.ones(dim)], axis=1)
    x0 = sampling.lh(popsize * 2, dim, 1)
    y0 = zdt1(torch.as_tensor(x0, device="cuda")).cpu().numpy()
    opt = NSGA2(popsize=popsize, nInput=dim, nOutput=2, model=None)
    opt.initialize_strategy(x0, y0, bounds, random=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.synchronize()
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    state = run_ea_loop(opt, opt.state, gen, gens, zdt1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)
    print(f"direct EA kernel launches: {launches}")
    assert launches == {"offspring": gens, "sbx": 0, "mutation": 0}, launches
    y = state.population_obj.cpu().numpy()
    dists = distance_to_front(y, zdt1_pareto(1000))
    on = y[dists <= 0.01]
    print(
        f"direct EA: {gens} generations in {dt:.3f} s ({gens / dt:.1f} gens/s), "
        f"{len(on)} of {popsize} within 0.01 of the front"
    )
    assert len(on) >= 30, len(on)
    assert on[:, 0].max() - on[:, 0].min() > 0.5


# the README quick start: dim, pop, generations, initial points per
# parameter, epochs
QUICK_START = (30, 200, 100, 3, 3)


def quick_start_params(opt_id, **over):
    """The README quick start's run() parameters (ZDT1 as a batched torch
    objective, NSGA-II, `gpr` defaults, seed 0)."""
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1

    dim, pop, gens, n_initial, n_epochs = QUICK_START
    params = {
        "opt_id": opt_id,
        "obj_fun": zdt1,
        "torch_objective": True,
        "space": {f"x{i}": [0.0, 1.0] for i in range(dim)},
        "problem_parameters": {},
        "objective_names": ["f1", "f2"],
        "population_size": pop,
        "num_generations": gens,
        "n_initial": n_initial,
        "n_epochs": n_epochs,
        "optimizer_name": "nsga2",
        "surrogate_method_name": "gpr",
        "random_seed": 0,
    }
    params.update(over)
    return params


def quick_start(torch, V):
    """Phase 4: the README quick start through run(); returns the
    kernel launch counts of this run."""
    import dmosopt_tpu_torch
    from dmosopt_tpu_torch.driver import dopt_dict

    n_epochs = QUICK_START[4]
    params = quick_start_params("zdt1_quick_start")
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    best = dmosopt_tpu_torch.run(params, verbose=False)
    wall = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)

    dopt = dopt_dict["zdt1_quick_start"]
    for s in dopt.epoch_stats:
        print(
            f"epoch {s['epoch']}: {s['epoch_s']:.3f} s, GP fit "
            f"{s['train_s']:.3f} s ({s['objective']['n_steps']} Adam steps), "
            f"EA {s['optimize_s']:.3f} s "
            f"({s['n_generations'] / s['optimize_s']:.1f} gens/s)"
        )
    print(f"run(): {wall:.3f} s for {n_epochs} epochs")

    print(f"quick start kernel launches: {launches}")
    _check_quick_start(dopt, best, launches, n_epochs, "quick start")
    return launches


def _check_quick_start(dopt, best, launches, n_epochs, label):
    """Phase 4's checks of a quick start run of ``n_epochs`` epochs: the
    fused kernel once a generation and the standalone ones never, the
    evaluation count, the archive, and a non-dominated returned set
    closer to the front than the initial design."""
    import numpy as np

    from dmosopt_tpu_torch.benchmarks.zdt import distance_to_front, zdt1_pareto

    dim, pop, gens, n_initial, _ = QUICK_START
    n_gen = sum(s["n_generations"] for s in dopt.epoch_stats)
    assert n_gen == n_epochs * gens, n_gen
    assert launches == {"offspring": n_gen, "sbx": 0, "mutation": 0}, launches

    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    n0 = n_initial * dim
    n_resample = int(pop * dopt.resample_fraction)
    # the JAX driver's epoch accounting: every epoch but the last enqueues
    # its resample batch (driver.py:1428-1490)
    assert dopt.eval_count == n0 + (n_epochs - 1) * n_resample, dopt.eval_count
    _check_archive(x_all, y_all, dopt.eval_count, label)

    y = np.column_stack([v for _, v in best[1]])
    assert y.shape[0] > 0 and np.all(np.isfinite(y))
    le = np.all(y[:, None, :] <= y[None, :, :], axis=2)
    lt = np.any(y[:, None, :] < y[None, :, :], axis=2)
    assert not np.any(le & lt), "returned set is dominated"
    front = zdt1_pareto(1000)
    d_best = float(np.median(distance_to_front(y, front)))
    d_init = float(np.median(distance_to_front(y_all[:n0], front)))
    print(
        f"{label}: archive {x_all.shape[0]} rows, {y.shape[0]} returned; "
        f"median distance to the front {d_best:.4f} (initial design {d_init:.4f})"
    )
    assert d_best < d_init, (d_best, d_init)


FILE_DIM = 10


def _example_zdt1(pp):
    """examples/example_zdt1_file.py's objective: ZDT1 of a parameter dict."""
    import numpy as np

    x = np.array([pp[f"x{i + 1}"] for i in range(FILE_DIM)])
    f1 = x[0]
    g = 1.0 + 9.0 / (FILE_DIM - 1) * np.sum(x[1:])
    return np.array([f1, g * (1.0 - np.sqrt(f1 / g))])


def _sleepy_zdt1(pp):
    time.sleep(0.02)
    return _example_zdt1(pp)


def _file_params(opt_id, obj_fun, **over):
    """examples/example_zdt1_file.py's parameters, without its store."""
    params = {
        "opt_id": opt_id,
        "obj_fun": obj_fun,
        "problem_parameters": {},
        "space": {f"x{i + 1}": [0.0, 1.0] for i in range(FILE_DIM)},
        "objective_names": ["y1", "y2"],
        "population_size": 100,
        "num_generations": 50,
        "optimizer_name": "nsga2",
        "surrogate_method_name": "gpr",
        "n_initial": 5,
        "n_epochs": 2,
        "random_seed": 21,
        "n_eval_workers": 4,
    }
    params.update(over)
    return params


def _check_archive(x_all, y_all, n_evals, label):
    """The archive keeps each distinct evaluated row once, all finite.
    It may hold fewer rows than were evaluated: the resample dedupe
    compares candidate i only with archived rows j < i (the JAX
    package's semantics), so a candidate equal to a later archived row
    is evaluated again and the archive drops the repeat."""
    import numpy as np

    assert np.all(np.isfinite(x_all)) and np.all(np.isfinite(y_all))
    assert x_all.shape[0] <= n_evals, (x_all.shape, n_evals)
    d2 = ((x_all[:, None, :] - x_all[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    assert d2.min() > 0.0, label
    print(f"{label}: {n_evals} evaluations, {x_all.shape[0]} archived rows "
          f"({n_evals - x_all.shape[0]} re-evaluated archive points)")


def _check_file_run(dopt, n_epochs):
    """Archive of the example's run: the initial design plus a resample
    batch per epoch but the last, each distinct row archived once."""
    import numpy as np

    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    n0 = 5 * FILE_DIM
    n_resample = int(100 * dopt.resample_fraction)
    assert dopt.eval_count == n0 + (n_epochs - 1) * n_resample, dopt.eval_count
    _check_archive(x_all, y_all, dopt.eval_count, "file-backed run")
    assert [s["epoch"] for s in dopt.epoch_stats] == list(range(n_epochs))
    assert not dopt._inflight


def file_backed(torch, V, smi):
    """Phase 5: the example's host-objective run on a thread pool, and
    the serial and speculative pipelines with a slow objective."""
    import threading

    import dmosopt_tpu_torch
    from dmosopt_tpu_torch.driver import dopt_dict

    threads_before = threading.active_count()
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    dmosopt_tpu_torch.run(_file_params("zdt1_file", _example_zdt1), verbose=False)
    wall = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)
    dopt = dopt_dict["zdt1_file"]
    n_gen = sum(s["n_generations"] for s in dopt.epoch_stats)
    print(f"file-backed run kernel launches: {launches}")
    assert n_gen == 2 * 50, n_gen
    assert launches == {"offspring": n_gen, "sbx": 0, "mutation": 0}, launches
    _check_file_run(dopt, 2)
    assert dopt.pipeline.mode == "overlap_io"
    threads_after = threading.active_count()
    assert threads_after == threads_before, (threads_before, threads_after)
    st = dopt.pipeline_stats
    print(
        f"[{smi}] file-backed run (4 workers, overlap_io): run() {wall:.3f} s, "
        f"{dopt.eval_count} evaluations, drain wall {st['eval_wait_s']:.4f} s, "
        f"evaluation overlapped with other work {st['eval_overlap_s']:.4f} s; "
        f"threads {threads_before} before, {threads_after} after"
    )

    for turn, mode in enumerate(("serial", "speculative", "speculative", "serial")):
        opt_id = f"zdt1_file_{mode}_{turn}"
        t0 = time.perf_counter()
        dmosopt_tpu_torch.run(
            _file_params(opt_id, _sleepy_zdt1, pipeline=mode), verbose=False
        )
        wall = time.perf_counter() - t0
        dopt = dopt_dict[opt_id]
        _check_file_run(dopt, 2)
        st = dopt.pipeline_stats
        if mode == "speculative":
            assert st["quorum_returns"] == 1 and st["stragglers"] > 0, st
        for s in dopt.epoch_stats:
            n_steps = s["objective"]["n_steps"]
            print(
                f"[{smi}] {mode} (turn {turn}) epoch {s['epoch']}: "
                f"{s['epoch_s']:.3f} s, GP fit {s['train_s']:.3f} s "
                f"({n_steps} Adam steps, {1e3 * s['train_s'] / n_steps:.2f} ms "
                f"each), evaluation drain {s['eval_wait_s']:.3f} s"
            )
        print(
            f"[{smi}] {mode} (turn {turn}): run() {wall:.3f} s; quorum returns "
            f"{st['quorum_returns']}, stragglers {st['stragglers']}, evaluation "
            f"overlapped with other work {st['eval_overlap_s']:.3f} s"
        )
    assert threading.active_count() == threads_before
    return launches


def many_objective(torch, V, smi):
    """Phase 6: examples/example_dtlz_many_objective.py's configuration
    through run(); returns the kernel launch counts of this run."""
    import numpy as np

    import dmosopt_tpu_torch
    from dmosopt_tpu_torch.benchmarks.moo_benchmarks import (
        generate_problem_space, get_problem,
    )
    from dmosopt_tpu_torch.driver import dopt_dict
    from dmosopt_tpu_torch.hv import hypervolume_exact

    n_obj, pop, n_initial, n_epochs = 5, 100, 5, 3
    space = generate_problem_space("dtlz2", n_obj)
    n_x = len(space)
    assert n_x == 14, n_x
    params = {
        "opt_id": "dmosopt_dtlz2",
        "obj_fun": get_problem("dtlz2", n_obj),
        "torch_objective": True,
        "problem_parameters": {},
        "space": space,
        "objective_names": [f"f{i + 1}" for i in range(n_obj)],
        "population_size": pop,
        "num_generations": 100,
        "optimizer_name": "age",
        "surrogate_method_name": "gpr",
        "termination_conditions": {"strategy": "fast"},
        "n_initial": n_initial,
        "n_epochs": n_epochs,
        "resample_fraction": 0.5,
        "random_seed": 7,
    }
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    best = dmosopt_tpu_torch.run(params, verbose=False)
    wall = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)

    dopt = dopt_dict["dmosopt_dtlz2"]
    for s in dopt.epoch_stats:
        crit_s = s["termination_s"] - s["termination_wait_s"]
        print(
            f"[{smi}] many-objective epoch {s['epoch']}: {s['epoch_s']:.3f} s, "
            f"GP fit {s['train_s']:.3f} s ({s['objective']['n_steps']} Adam "
            f"steps), EA {s['optimize_s']:.3f} s over {s['n_generations']} "
            f"generations, stopped by {s['stop_reasons']}; "
            f"{s['termination_checks']} termination checks: "
            f"{s['termination_s']:.3f} s, of it {s['termination_wait_s']:.3f} s "
            f"waiting for the population copy and {crit_s:.3f} s in the "
            f"criteria on the host; kernel launches {s['kernel_launches']}"
        )
        assert s["kernel_launches"]["offspring"] == s["n_generations"], s
    print(f"[{smi}] many-objective run(): {wall:.3f} s for {n_epochs} epochs")

    n_gen = sum(s["n_generations"] for s in dopt.epoch_stats)
    print(f"many-objective run kernel launches: {launches} ({n_gen} generations)")
    assert n_gen > 0
    assert launches == {"offspring": n_gen, "sbx": 0, "mutation": 0}, launches

    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    n0 = n_initial * n_x
    n_resample = int(pop * dopt.resample_fraction)
    # the initial design, then a resample batch from every epoch but the
    # last; the dedupe may drop candidates, never add rows
    assert n0 < dopt.eval_count <= n0 + (n_epochs - 1) * n_resample, dopt.eval_count
    _check_archive(x_all, y_all, dopt.eval_count, "many-objective run")

    y = np.column_stack([v for _, v in best[1]])
    assert y.shape[0] > 0 and np.all(np.isfinite(y))
    le = np.all(y[:, None, :] <= y[None, :, :], axis=2)
    lt = np.any(y[:, None, :] < y[None, :, :], axis=2)
    assert not np.any(le & lt), "returned set is dominated"
    norm = np.linalg.norm(y, axis=1)
    assert np.all(norm**2 >= 1 - 1e-5), float(np.min(norm**2))
    # the resampled rows must dominate more volume than every one of 20
    # seeded sets of as many uniform random points, and 1.07 times their
    # median (exact 5-d hypervolume, reference point 2.5 per objective)
    ref = np.full(n_obj, 2.5)
    y_res = y_all[n0:]
    hv_res = hypervolume_exact(y_res, ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    f = get_problem("dtlz2", n_obj)
    hv_random = np.array([
        hypervolume_exact(
            f(torch.rand(len(y_res), n_x, generator=gen, device="cuda")).cpu().numpy(),
            ref,
        )
        for _ in range(20)
    ])
    hv_best = hypervolume_exact(y, ref)
    hv_init = hypervolume_exact(y_all[:n0], ref)
    gap_best = float(np.median(norm - 1))
    gap_init = float(np.median(np.linalg.norm(y_all[:n0], axis=1) - 1))
    print(
        f"many-objective: archive {x_all.shape[0]} rows, {y.shape[0]} returned; "
        f"min ||f||^2 {float(np.min(norm**2)):.4f} (front: 1); median "
        f"||f|| - 1 {gap_best:.4f} (initial design {gap_init:.4f}); hypervolume "
        f"of the {len(y_res)} resampled rows {hv_res:.4f}, of as many random "
        f"points (median, largest of 20) {np.median(hv_random):.4f} "
        f"{hv_random.max():.4f}; returned set {hv_best:.4f}, initial design "
        f"{hv_init:.4f} (ratio {hv_best / hv_init:.4f})"
    )
    bar = max(hv_random.max(), 1.07 * np.median(hv_random))
    assert hv_res > bar, (hv_res, bar)
    return launches


# the constrained run (phase 9): examples/example_tnk.py's box, its
# initial design (20 points per parameter), the hook's feasibility quota,
# and the reference point of the returned set's hypervolume
TNK_BOX = (1e-6, 3.141592653589793)
TNK_N0 = 20 * 2
TNK_QUOTA = 10
TNK_REF = (1.2, 1.2)
# children of each hook round, one entry per round that made children
TNK_HOOK_ROUNDS = []


def tnk_obj(pp):
    """examples/example_tnk.py's objective: (x1, x2) with constraints
    c >= 0 feasible."""
    import numpy as np

    x1, x2 = pp["x1"], pp["x2"]
    c1 = x1**2 + x2**2 - 1.0 - 0.1 * np.cos(16.0 * np.arctan2(x1, x2 + 1e-12))
    c2 = 0.5 - (x1 - 0.5) ** 2 - (x2 - 0.5) ** 2
    return np.array([x1, x2]), np.array([c1, c2])


def tnk_params(opt_id, obj_fun, seed=1, **over):
    """examples/example_tnk.py's parameters."""
    params = {
        "opt_id": opt_id, "obj_fun": obj_fun, "problem_parameters": {},
        "space": {"x1": list(TNK_BOX), "x2": list(TNK_BOX)},
        "objective_names": ["f1", "f2"], "constraint_names": ["c1", "c2"],
        "feasibility_method_name": "logreg", "population_size": 100,
        "num_generations": 50, "optimizer_name": "nsga2",
        "surrogate_method_name": "gpr", "n_initial": 20, "n_epochs": 4,
        "resample_fraction": 0.5, "random_seed": seed,
    }
    params.update(over)
    return params


def tnk_space(sampler):
    """The sampler's box as a `ParamSpacePoints` space."""
    return {k: [float(lo), float(hi)] for k, lo, hi in
            zip(sampler["param_names"], sampler["xlb"], sampler["xub"])}


def quota_parents(evaluated_samples, quota, iteration, max_rounds):
    """The parents of the hook's next round: the feasible evaluated rows
    (the 4 rows of largest least constraint while fewer than 2 are
    feasible), or None once ``quota`` rows are feasible or after
    ``max_rounds`` rounds."""
    import numpy as np

    x = np.array([e.parameters for e in evaluated_samples])
    c = np.array([e.constraints for e in evaluated_samples])
    feasible = np.all(c > 0.0, axis=1)
    if feasible.sum() >= quota or iteration >= max_rounds:
        return None
    if feasible.sum() >= 2:
        return x[feasible]
    return x[np.argsort(-c.min(axis=1))[:4]]


def tnk_quota_sampler(file_path, iteration, evaluated_samples, next_samples, sampler,
                      quota=TNK_QUOTA, n_children=200, max_rounds=8, device=None,
                      **_):
    """Epoch-0 ``dynamic_initial_sampling`` hook of the constrained run:
    while fewer than ``quota`` evaluated rows are feasible, propose
    ``n_children`` SBX/mutation children of the feasible rows
    (`ParamSpacePoints` with parents, made on ``device``); then None."""
    import numpy as np

    from dmosopt_tpu_torch.constrained_sampling import ParamSpacePoints

    parents = quota_parents(evaluated_samples, quota, iteration, max_rounds)
    if parents is None:
        return None
    names = list(sampler["param_names"])
    ps = ParamSpacePoints(
        n_children, tnk_space(sampler), seed=iteration, device=device,
        parents={"params": np.array(names), "values": parents},
    )
    TNK_HOOK_ROUNDS.append(ps.values.shape[0])
    return np.column_stack([ps.as_dict()[k] for k in names])


def hypervolume_2d(y, ref):
    """Area dominated by the 2-objective points ``y`` up to ``ref``."""
    import numpy as np

    y = y[(y[:, 0] < ref[0]) & (y[:, 1] < ref[1])]
    area, best = 0.0, ref[1]
    for f1, f2 in y[np.argsort(y[:, 0], kind="stable")]:
        if f2 < best:
            area += (ref[0] - f1) * (best - f2)
            best = f2
    return float(area)


def tnk_quality(evaluated, n_pre, y_best):
    """(feasible share of the rows evaluated after the first ``n_pre``,
    hypervolume of the returned set against TNK_REF); ``evaluated`` rows
    are (x1, x2, c1, c2) in evaluation order."""
    import numpy as np

    resampled = evaluated[n_pre:]
    share = float(np.mean(np.all(resampled[:, 2:] > 0.0, axis=1)))
    return share, hypervolume_2d(y_best, TNK_REF)


class _Instrument:
    """Per-epoch wall time of the Lorenz run's rank calls, archive
    dedupes and objective calls, and the extra device memory of its
    largest rank call. Each timed call is bracketed by device syncs, so
    queued work is not counted in it (the run's own timing shifts by
    those syncs only). Patches the port's modules for the duration of a
    ``with`` block and restores them after."""

    def __init__(self, torch):
        self.torch = torch
        self.total = {"rank": [0, 0.0], "dedupe": [0, 0.0], "objective": [0, 0.0]}
        self.rank_peak = (0, 0)  # (rows, extra bytes) of the largest rank call
        self.epochs = []
        self._patches = []

    def timed(self, bucket, fn, rank_rows=False):
        torch = self.torch

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            if rank_rows:
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.total[bucket][0] += 1
            self.total[bucket][1] += time.perf_counter() - t0
            if rank_rows:
                rows = args[0].shape[-2]  # rows of one set
                extra = torch.cuda.max_memory_allocated() - base
                if rows >= self.rank_peak[0]:
                    self.rank_peak = (rows, max(extra, self.rank_peak[1])
                                      if rows == self.rank_peak[0] else extra)
            return out

        return wrapped

    def patch(self, obj, name, value):
        self._patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __enter__(self):
        from dmosopt_tpu_torch import driver, moasmo, strategy
        from dmosopt_tpu_torch.ops import dominance, sort
        from dmosopt_tpu_torch.optimizers import cmaes, survival, trs

        rank = self.timed("rank", dominance.non_dominated_rank, rank_rows=True)
        for mod in (sort, survival, cmaes, trs):
            self.patch(mod, "non_dominated_rank", rank)
        dedupe = self.timed("dedupe", moasmo.get_duplicates)
        for mod in (moasmo, strategy):
            self.patch(mod, "get_duplicates", dedupe)
        run_epoch = driver.DistOptimizer.run_epoch
        inst = self

        def timed_epoch(dopt, *args, **kwargs):
            before = {k: list(v) for k, v in inst.total.items()}
            inst.rank_peak = (0, 0)
            out = run_epoch(dopt, *args, **kwargs)
            inst.epochs.append({
                **{k: (v[0] - before[k][0], v[1] - before[k][1])
                   for k, v in inst.total.items()},
                "rank_peak": inst.rank_peak,
            })
            return out

        self.patch(driver.DistOptimizer, "run_epoch", timed_epoch)
        return self

    def __exit__(self, *exc):
        for obj, name, value in reversed(self._patches):
            setattr(obj, name, value)
        return False


def lorenz_run(torch, V, smi):
    """Phase 7: examples/example_lorenz.py's configuration through run()
    at pop 4096, cut to LORENZ_GENERATIONS generations an epoch; returns
    the kernel launch counts of this run."""
    import numpy as np

    import dmosopt_tpu_torch
    from dmosopt_tpu_torch.benchmarks.lorenz import lorenz_objectives
    from dmosopt_tpu_torch.driver import dopt_dict

    pop, gens, S = LORENZ_POP, LORENZ_GENERATIONS, LORENZ_SWARMS
    n0 = 100 * 3
    design = []
    with _Instrument(torch) as inst:
        timed_objective = inst.timed("objective", lorenz_objectives)

        def objective(x):
            y = timed_objective(x)
            if not design:  # the first call evaluates the initial design
                design.append(y.cpu().numpy())
            return y

        params = {
            "opt_id": "dmosopt_lorenz", "obj_fun": objective, "torch_objective": True,
            "problem_parameters": {}, "space": LORENZ_SPACE,
            "objective_names": ["x", "y", "z"], "population_size": pop,
            "num_generations": gens, "optimizer_name": ["cmaes", "smpso"],
            "surrogate_method_name": None, "n_initial": 100, "n_epochs": 2,
            "resample_fraction": 0.25, "random_seed": 0,
        }
        V.reset_kernel_launches()
        t0 = time.perf_counter()
        best = dmosopt_tpu_torch.run(params, verbose=False)
        wall = time.perf_counter() - t0
        launches = dict(V.KERNEL_LAUNCHES)

    dopt = dopt_dict["dmosopt_lorenz"]
    for name, s, e in zip(("cmaes", "smpso"), dopt.epoch_stats, inst.epochs):
        rows, extra = e["rank_peak"]
        print(
            f"[{smi}] Lorenz epoch {s['epoch']} ({name}): {s['epoch_s']:.3f} s, "
            f"{s['n_generations']} generations; rank {e['rank'][1]:.3f} s in "
            f"{e['rank'][0]} calls, dedupe {e['dedupe'][1]:.3f} s in "
            f"{e['dedupe'][0]} calls, objective {e['objective'][1]:.3f} s in "
            f"{e['objective'][0]} calls; largest rank call {rows} rows, "
            f"{extra / 1e9:.3f} GB of extra device memory at its peak; kernel "
            f"launches {s['kernel_launches']}"
        )
        assert s["n_generations"] == gens, s
    print(f"[{smi}] Lorenz run(): {wall:.3f} s for 2 epochs (objective "
          f"{inst.total['objective'][1]:.3f} s in {inst.total['objective'][0]} calls)")
    print(f"Lorenz run kernel launches: {launches}")
    assert launches == {"offspring": 0, "sbx": 0, "mutation": gens}, launches
    assert [s["kernel_launches"]["mutation"] for s in dopt.epoch_stats] == [0, gens]
    assert all(e["rank_peak"][1] < 4e9 for e in inst.epochs), inst.epochs

    # the design, each optimizer's initial population (SMPSO's S*P), then
    # every generation's offspring (CMA-ES P/2, SMPSO 2*S*P)
    n_evals = n0 + pop + gens * pop // 2 + S * pop + gens * 2 * S * pop
    assert dopt.eval_count == n_evals, (dopt.eval_count, n_evals)
    assert dopt.optimizer_dict[0].stats.get("n_quarantined", 0) == 0
    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    assert np.all(np.isfinite(x_all)) and np.all(np.isfinite(y_all))
    assert np.unique(x_all, axis=0).shape[0] == x_all.shape[0], "repeated archive rows"
    assert x_all.shape[0] <= pop + 2 * S * pop

    y = np.column_stack([v for _, v in best[1]])
    assert y.shape[0] > 0 and np.all(np.isfinite(y))
    le = np.all(y[:, None, :] <= y[None, :, :], axis=2)
    lt = np.any(y[:, None, :] < y[None, :, :], axis=2)
    assert not np.any(le & lt), "returned set is dominated"

    # the true (b, r, s) and as many uniform random points as the archive
    # holds, in one call: the first row must read 0 on every axis
    gen = torch.Generator(device="cuda").manual_seed(0)
    lo = torch.tensor(LORENZ_BOX[0], device="cuda")
    hi = torch.tensor(LORENZ_BOX[1], device="cuda")
    x_rand = lo + torch.rand((len(y_all), 3), generator=gen, device="cuda") * (hi - lo)
    true = torch.tensor([[8.0 / 3.0, 28.0, 10.0]], device="cuda")
    y_check = lorenz_objectives(torch.cat([true, x_rand])).cpu().numpy()
    assert np.all(y_check[0] == 0.0), y_check[0]
    design_best = float(design[0].sum(axis=1).min())
    best_total = float(y.sum(axis=1).min())
    median_archive = float(np.median(y_all.sum(axis=1)))
    median_random = float(np.median(y_check[1:].sum(axis=1)))
    print(
        f"[{smi}] Lorenz: {dopt.eval_count} evaluations, archive {x_all.shape[0]} "
        f"rows, {y.shape[0]} returned; least total error: design ({design[0].shape[0]} "
        f"points) {design_best:.6f}, returned {best_total:.6f}; median total error: "
        f"archive {median_archive:.6f}, as many random points {median_random:.6f} "
        f"(ratio {median_archive / median_random:.4f}, bar {LORENZ_MEDIAN_BAR}); "
        f"objective at the true parameters {y_check[0].tolist()}"
    )
    assert design[0].shape[0] == n0
    assert best_total < design_best, (best_total, design_best)

    # one rank at the archive's full size, pop + 2*S*pop rows: the final
    # archive topped up with the random points' objectives
    from dmosopt_tpu_torch.ops import non_dominated_rank

    n_full = pop + 2 * S * pop
    Y = torch.as_tensor(np.concatenate([y_all, y_check[1:]])[:n_full], device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = non_dominated_rank(Y)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    extra = torch.cuda.max_memory_allocated() - base
    print(f"[{smi}] rank of {n_full} Lorenz objective rows: {dt:.3f} s, "
          f"{int(r.max()) + 1} fronts, {extra / 1e9:.3f} GB of extra device memory "
          f"at its peak (the dense form's (n, n) int32 and bool: "
          f"{n_full * n_full * 5 / 1e9:.3f} GB)")
    assert extra < 4e9, extra
    assert median_archive < LORENZ_MEDIAN_BAR * median_random, (median_archive, median_random)
    return launches


def config5_loop(torch, V, smi):
    """Phase 8: bench.py's Config 5 loop on the card (CMA-ES and SMPSO at
    pop 4096 on the 2-objective Lorenz function, one warm-up generation,
    then CONFIG5_GENERATIONS timed ones), then the JAX package's CMA-ES
    and TRS solution-quality oracles."""
    import numpy as np

    from dmosopt_tpu_torch import sampling
    from dmosopt_tpu_torch.benchmarks.lorenz import lorenz_error_prior
    from dmosopt_tpu_torch.moasmo import offspring_per_generation
    from dmosopt_tpu_torch.optimizers.base import run_ea_loop
    from dmosopt_tpu_torch.optimizers.cmaes import CMAES
    from dmosopt_tpu_torch.optimizers.smpso import SMPSO

    pop, T = LORENZ_POP, CONFIG5_GENERATIONS
    lb, ub = np.array([5.0, 15.0, 1.0]), np.array([15.0, 35.0, 10.0])
    bounds = np.stack([lb, ub], 1)
    for name, cls in (("cmaes", CMAES), ("smpso", SMPSO)):
        n0 = pop * LORENZ_SWARMS if name == "smpso" else pop
        x0 = lb + sampling.lh(n0, 3, 42) * (ub - lb)
        y0 = lorenz_error_prior(torch.as_tensor(x0, dtype=torch.float32, device="cuda"))
        opt = cls(popsize=pop, nInput=3, nOutput=2, model=None)
        opt.initialize_strategy(x0, y0.cpu().numpy(), bounds, random=1)
        noff = offspring_per_generation(opt)
        gen = torch.Generator(device="cuda")
        st = run_ea_loop(opt, opt.state, gen.manual_seed(3), 1, lorenz_error_prior)
        torch.cuda.synchronize()
        V.reset_kernel_launches()
        t0 = time.perf_counter()
        st = run_ea_loop(opt, opt.state, gen.manual_seed(4), T, lorenz_error_prior)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / T
        launches = {k: v / T for k, v in V.KERNEL_LAUNCHES.items()}
        _, y = opt.get_population_strategy(st)
        assert bool(torch.isfinite(y).all())
        print(f"[{smi}] Config 5 {name}: pop {pop}, {noff} evaluations a generation, "
              f"{sec:.4f} s a generation, {noff / sec:.1f} evaluations/s over {T} "
              f"generations; kernel launches a generation {launches}")
        want = {"offspring": 0, "sbx": 0, "mutation": 1 if name == "smpso" else 0}
        assert launches == want, launches
    quality_oracles(torch, smi)


def quality_oracles(torch, smi):
    """tests/test_optimizers.py::test_cmaes_trs_solution_quality_oracles
    of the JAX package on the card: direct 250-generation loops at pop
    200 on ZDT1 (dim 30) and DTLZ2 (dim 12, 3 objectives), with its
    median and within-0.05 bars."""
    import numpy as np

    from dmosopt_tpu_torch import sampling
    from dmosopt_tpu_torch.benchmarks.moo_benchmarks import dtlz2
    from dmosopt_tpu_torch.benchmarks.zdt import distance_to_front, zdt1, zdt1_pareto
    from dmosopt_tpu_torch.optimizers.base import run_ea_loop
    from dmosopt_tpu_torch.optimizers.cmaes import CMAES
    from dmosopt_tpu_torch.optimizers.trs import TRS

    pop, ngen = 200, 250
    front = zdt1_pareto(1000)

    def sphere(y):
        return np.abs(np.linalg.norm(y, axis=1) - 1.0)

    def dtlz2_3(X):
        return dtlz2(X, n_obj=3)

    cases = [
        ("cmaes", CMAES, "zdt1", 30, 2, zdt1, lambda y: distance_to_front(y, front), 0.175, 5),
        ("trs", TRS, "zdt1", 30, 2, zdt1, lambda y: distance_to_front(y, front), 0.5, 0),
        ("cmaes", CMAES, "dtlz2", 12, 3, dtlz2_3, sphere, 0.2, 20),
        ("trs", TRS, "dtlz2", 12, 3, dtlz2_3, sphere, 0.05, 100),
    ]
    for name, cls, prob, dim, nobj, obj, dist, med_bar, within_bar in cases:
        x0 = sampling.lh(pop, dim, 21).astype(np.float32)
        y0 = obj(torch.as_tensor(x0, device="cuda")).cpu().numpy()
        opt = cls(popsize=pop, nInput=dim, nOutput=nobj, model=None)
        bounds = np.stack([np.zeros(dim), np.ones(dim)], 1)
        opt.initialize_strategy(x0, y0, bounds, random=21)
        t0 = time.perf_counter()
        st = run_ea_loop(opt, opt.state, torch.Generator(device="cuda").manual_seed(21),
                         ngen, obj)
        y = (st.parents_y if name == "cmaes" else st.population_obj).cpu().numpy()
        dt = time.perf_counter() - t0
        d = dist(y)
        print(f"[{smi}] oracle {name} {prob}: median {np.median(d):.4f} (bar {med_bar}), "
              f"{int((d <= 0.05).sum())} within 0.05 (bar {within_bar}); {ngen} "
              f"generations in {dt:.3f} s")
        assert np.median(d) < med_bar, (name, prob, float(np.median(d)))
        assert (d <= 0.05).sum() >= within_bar, (name, prob, int((d <= 0.05).sum()))


def _check_feasibility_epochs(dopt, n_epochs, label, smi):
    """A feasibility model was fitted (both classes seen, at least one
    classifier trained) in every epoch; prints each epoch's times."""
    assert len(dopt.epoch_stats) == n_epochs, dopt.epoch_stats
    for s in dopt.epoch_stats:
        print(
            f"[{smi}] {label} epoch {s['epoch']}: {s['epoch_s']:.3f} s, feasibility "
            f"fit {s['feasibility_s']:.3f} s ({s.get('feasibility')}), GP fit "
            f"{s['train_s']:.3f} s, EA {s['optimize_s']:.3f} s over "
            f"{s['n_generations']} generations; kernel launches {s['kernel_launches']}"
        )
        assert s.get("feasibility", {}).get("n_fitted", 0) >= 1, (label, s)
        assert s["kernel_launches"]["offspring"] == s["n_generations"], s


def _check_returned(best, label):
    """The returned set is feasible (every constraint > 0), finite and
    non-dominated; returns its objectives."""
    import numpy as np

    y = np.column_stack([v for _, v in best[1]])
    c = np.column_stack([v for _, v in best[2]])
    assert y.shape[0] > 0 and np.all(np.isfinite(y)), label
    assert np.all(c > 0.0), (label, c.min())
    le = np.all(y[:, None, :] <= y[None, :, :], axis=2)
    lt = np.any(y[:, None, :] < y[None, :, :], axis=2)
    assert not np.any(le & lt), f"{label}: returned set is dominated"
    return y


def bench_tnk_obj(pp):
    """bench.py Config 3's TNK objective."""
    import numpy as np

    x1, x2 = pp["x1"], pp["x2"]
    theta = np.arctan2(x2, x1)
    c1 = x1**2 + x2**2 - 1.0 - 0.1 * np.cos(16.0 * theta)
    c2 = 0.5 - (x1 - 0.5) ** 2 - (x2 - 0.5) ** 2
    return np.array([x1, x2]), np.array([c1, c2])


def constrained_run(torch, V, smi):
    """Phase 9: examples/example_tnk.py's configuration with the
    feasibility-quota hook, then bench.py's Config 3; returns the kernel
    launch counts of the TNK run."""
    import numpy as np

    import dmosopt_tpu_torch
    from dmosopt_tpu_torch.driver import dopt_dict

    evaluated = []

    def objective(pp):
        y, c = tnk_obj(pp)
        evaluated.append(np.concatenate([[pp["x1"], pp["x2"]], c]))
        return y, c

    params = tnk_params(
        "dmosopt_tnk", objective,
        dynamic_initial_sampling=f"{__name__}.tnk_quota_sampler",
    )
    TNK_HOOK_ROUNDS.clear()
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    best = dmosopt_tpu_torch.run(params, verbose=False, return_constraints=True)
    wall = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)
    dopt = dopt_dict["dmosopt_tnk"]
    _check_feasibility_epochs(dopt, 4, "constrained run", smi)
    n_gen = sum(s["n_generations"] for s in dopt.epoch_stats)
    rounds = len(TNK_HOOK_ROUNDS)
    n_hook = sum(TNK_HOOK_ROUNDS)
    print(f"constrained run kernel launches: {launches}; {rounds} hook round(s) "
          f"made {n_hook} children")
    assert n_gen == 4 * 50, n_gen
    assert rounds >= 1, "the initial design met the feasibility quota on its own"
    assert launches == {"offspring": n_gen, "sbx": rounds, "mutation": 2 * rounds}, launches

    ev = np.asarray(evaluated)
    n_pre = TNK_N0 + n_hook
    n_feasible_pre = int(np.all(ev[:n_pre, 2:] > 0.0, axis=1).sum())
    assert n_feasible_pre >= TNK_QUOTA, n_feasible_pre
    assert n_pre < dopt.eval_count <= n_pre + 3 * 50, dopt.eval_count
    assert len(ev) == dopt.eval_count
    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    _check_archive(x_all, y_all, dopt.eval_count, "constrained run")
    y = _check_returned(best, "constrained run")
    share, hv = tnk_quality(ev, n_pre, y)
    print(
        f"[{smi}] constrained run(): {wall:.3f} s for 4 epochs; {len(ev)} evaluations "
        f"({TNK_N0} design, {n_hook} hook children, {n_feasible_pre} feasible before "
        f"the first fit); {y.shape[0]} returned points, all feasible; resamples' "
        f"feasible share {share:.4f}, returned set's hypervolume {hv:.6f} "
        f"(reference point {TNK_REF}; printed, not gated: a noise feasibility rank "
        f"reads within the JAX package's range, tools/tnk_quality.py)"
    )

    # bench.py Config 3: AGE-MOEA through the feasibility path
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    best3 = dmosopt_tpu_torch.run({
        "opt_id": "bench_tnk", "obj_fun": bench_tnk_obj,
        "objective_names": ["f1", "f2"], "constraint_names": ["c1", "c2"],
        "space": {"x1": [1e-12, float(np.pi)], "x2": [1e-12, float(np.pi)]},
        "problem_parameters": {}, "n_initial": 8, "n_epochs": 5,
        "population_size": 100, "num_generations": 100, "resample_fraction": 0.25,
        "optimizer_name": "age", "surrogate_method_name": "gpr",
        "surrogate_method_kwargs": {"n_starts": 4, "n_iter": 100, "seed": 0},
        "feasibility_method_name": "logreg", "random_seed": 42,
    }, verbose=False, return_constraints=True)
    wall3 = time.perf_counter() - t0
    launches3 = dict(V.KERNEL_LAUNCHES)
    dopt3 = dopt_dict["bench_tnk"]
    _check_feasibility_epochs(dopt3, 5, "Config 3", smi)
    n_gen3 = sum(s["n_generations"] for s in dopt3.epoch_stats)
    assert n_gen3 == 5 * 100, n_gen3
    assert launches3 == {"offspring": n_gen3, "sbx": 0, "mutation": 0}, launches3
    x3, y3 = dopt3.optimizer_dict[0].get_evals()
    _check_archive(x3, y3, dopt3.eval_count, "Config 3")
    yb3 = _check_returned(best3, "Config 3")
    print(f"[{smi}] Config 3 (AGE-MOEA, logreg): run() {wall3:.3f} s for 5 epochs, "
          f"{dopt3.eval_count} evaluations, {yb3.shape[0]} returned points")
    return launches


def _cpu_copy(torch, sm):
    """The fitted surrogate with its fit moved to the host (its predictor,
    built on the card, is left behind: the copy builds its own)."""
    import copy

    cpu = copy.copy(sm)
    cpu.device = torch.device("cpu")
    cpu._xlb_t, cpu._xrg_t = sm._xlb_t.cpu(), sm._xrg_t.cpu()
    cpu._predictor_obj = None
    cpu.fit = copy.copy(sm.fit)
    for k, v in vars(sm.fit).items():
        if isinstance(v, torch.Tensor):
            setattr(cpu.fit, k, v.cpu())
    return cpu


def sa_run(torch, V, smi):
    """Phase 10: examples/example_zdt1_sa.py's configuration (FAST
    sensitivity setting per-gene distribution indices); each epoch's
    indices are held against `analyze_sensitivity` recomputed on the
    host from the epoch's fit, and DGSM runs once on the last fit.
    Returns the kernel launch counts of the run."""
    import numpy as np

    import dmosopt_tpu_torch
    from dmosopt_tpu_torch import moasmo
    from dmosopt_tpu_torch.benchmarks.zdt import distance_to_front, zdt1, zdt1_pareto
    from dmosopt_tpu_torch.driver import dopt_dict
    from dmosopt_tpu_torch.sa import SA_DGSM, SA_FAST

    dim, n_initial = 10, 5
    calls = []
    analyze = moasmo.analyze_sensitivity

    def recorded(sm, *args, **kwargs):
        out = analyze(sm, *args, **kwargs)
        calls.append((sm, args, kwargs, out))
        return out

    params = {
        "opt_id": "dmosopt_zdt1_sa", "obj_fun": zdt1, "torch_objective": True,
        "problem_parameters": {},
        "space": {f"x{i + 1}": [0.0, 1.0] for i in range(dim)},
        "objective_names": ["y1", "y2"], "population_size": 100,
        "num_generations": 50, "optimizer_name": "nsga2",
        "surrogate_method_name": "gpr", "sensitivity_method_name": "fast",
        "sensitivity_method_kwargs": {}, "n_initial": n_initial, "n_epochs": 3,
        "resample_fraction": 0.5, "random_seed": 3,
    }
    moasmo.analyze_sensitivity = recorded
    try:
        V.reset_kernel_launches()
        t0 = time.perf_counter()
        best = dmosopt_tpu_torch.run(params, verbose=False)
        wall = time.perf_counter() - t0
        launches = dict(V.KERNEL_LAUNCHES)
    finally:
        moasmo.analyze_sensitivity = analyze
    dopt = dopt_dict["dmosopt_zdt1_sa"]
    n_gen = sum(s["n_generations"] for s in dopt.epoch_stats)
    print(f"SA run kernel launches: {launches}")
    assert n_gen == 3 * 50, n_gen
    assert launches == {"offspring": n_gen, "sbx": 0, "mutation": 0}, launches
    assert len(calls) == 3, len(calls)

    lb, ub = np.zeros(dim), np.ones(dim)
    design = SA_FAST(lb, ub, list(params["space"]), params["objective_names"]).sample()
    for s, (sm, args, kwargs, out) in zip(dopt.epoch_stats, calls):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sm.evaluate(design)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t1
        host = analyze(_cpu_copy(torch, sm), *args, **kwargs)
        for key in ("di_mutation", "di_crossover"):
            np.testing.assert_allclose(out[key], host[key], rtol=1e-4, atol=0)
        assert np.all(s["di_mutation"] == out["di_mutation"])
        print(
            f"[{smi}] SA epoch {s['epoch']}: {s['epoch_s']:.3f} s, GP fit "
            f"{s['train_s']:.3f} s, sensitivity {s['sensitivity_s']:.3f} s (the "
            f"{design.shape[0]}-row surrogate evaluation {eval_s * 1e3:.2f} ms), EA "
            f"{s['optimize_s']:.3f} s; di_mutation {np.round(out['di_mutation'], 4).tolist()} "
            f"(host recomputation within 1e-4 relative); kernel launches "
            f"{s['kernel_launches']}"
        )
        assert s["kernel_launches"]["offspring"] == s["n_generations"], s

    sm = calls[-1][0]
    dgsm = SA_DGSM(lb, ub, list(params["space"]), params["objective_names"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = dgsm.analyze(sm)
    dgsm_s = time.perf_counter() - t1
    s1 = np.vstack([res["S1"][k] for k in params["objective_names"]])
    assert s1.shape == (2, dim) and np.all(np.isfinite(s1)), s1

    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    _check_archive(x_all, y_all, dopt.eval_count, "SA run")
    y = np.column_stack([v for _, v in best[1]])
    assert y.shape[0] > 0 and np.all(np.isfinite(y))
    le = np.all(y[:, None, :] <= y[None, :, :], axis=2)
    lt = np.any(y[:, None, :] < y[None, :, :], axis=2)
    assert not np.any(le & lt), "returned set is dominated"
    front = zdt1_pareto(1000)
    d_best = float(np.median(distance_to_front(y, front)))
    d_init = float(np.median(distance_to_front(y_all[: n_initial * dim], front)))
    print(
        f"[{smi}] SA run(): {wall:.3f} s for 3 epochs; DGSM on the last fit "
        f"{dgsm_s:.3f} s (S1 max {float(s1.max()):.4f}); {y.shape[0]} returned "
        f"points, median distance to the front {d_best:.4f} (initial design "
        f"{d_init:.4f})"
    )
    assert d_best < d_init, (d_best, d_init)
    return launches


# bench.py Configs 8 and 9 Part B (phase 11): zdt1_agemoea_gpr
REFIT_DIM, REFIT_EPOCHS, REFIT_POP, REFIT_GENERATIONS = 30, 5, 100, 100
# phase 11 (c) cuts Part B from the bench's 5 epochs to 3 (about 23 s of
# the script), so that phase 15 fits the script's time
PART_B_EPOCHS = 3


def refit_params(opt_id, obj_fun, mode, **over):
    """bench.py's zdt1_agemoea_gpr configuration (Configs 8 and 9 Part
    B): ZDT1 with 30 parameters, AGE-MOEA, pop 100, 100 generations, 8
    initial points per parameter, 5 epochs, resample 0.25, `gpr` with 4
    starts and 100 steps, seed 0, ``random_seed`` 42. ``mode`` "cold" is
    the default fit, "warm" sets ``surrogate_refit="warm"``, "matmul"
    the ``predictor="matmul"`` regime."""
    kwargs = {"n_starts": 4, "n_iter": 100, "seed": 0}
    if mode == "matmul":
        kwargs["predictor"] = "matmul"
    params = {
        "opt_id": opt_id, "obj_fun": obj_fun, "objective_names": ["f1", "f2"],
        "space": {f"x{i:02d}": [0.0, 1.0] for i in range(REFIT_DIM)},
        "problem_parameters": {}, "n_initial": 8, "n_epochs": REFIT_EPOCHS,
        "population_size": REFIT_POP, "num_generations": REFIT_GENERATIONS,
        "resample_fraction": 0.25, "optimizer_name": "age",
        "surrogate_method_name": "gpr", "surrogate_method_kwargs": kwargs,
        "surrogate_refit": "warm" if mode == "warm" else None, "random_seed": 42,
    }
    params.update(over)
    return params


def within_front(y, tol=0.05):
    """bench.py's ``within_0.05``: returned points within ``tol`` of the
    ZDT1 front (500 points of it)."""
    from dmosopt_tpu_torch.benchmarks.zdt import distance_to_front, zdt1_pareto

    return int((distance_to_front(y, zdt1_pareto(500)) < tol).sum())


# bench.py Config 9 Part A (phase 11): archive sizes, queries per
# predict (one inner-EA generation's batch), Nyström inducing rows
PREDICT_SIZES, PREDICT_QUERIES, NYSTROM_M = (512, 2048, 8192), 128, 512
# each served predictor against a float64 solve of the same posterior:
# the largest error of the mean over y_std and of the variance over the
# prior variance, at most these, the bars tests/test_torch_predictor.py
# holds a rank update's predictor to. The regimes' float32 errors there
# are at most 2.2e-5 and 3.7e-6, a stale cache's about 0.1 and 0.13
# (PERF.md section 6)
PREDICT_BARS = {"mean": 2e-3, "var": 2e-5}
# bench.py Config 8 Part A: dim, fits, first archive, rows appended a fit
REFIT_FITS, REFIT_N0, REFIT_K = 6, 120, 32


def _best_ms(torch, fn, reps=2):
    """Best wall of ``reps`` synchronized calls of ``fn`` after one
    warm-up call, in ms."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _predict_errors(pred, oracle, fit):
    """(mean, var) errors of a prediction against the float64 oracle,
    normalized by y_std and by the prior variance (amp + noise) y_std²."""
    ys = fit.y_std.double()
    prior = (fit.amp.double() + fit.noise.double()) * ys * ys
    em = float(((pred[0].double() - oracle[0]).abs() / ys).max())
    ev = float(((pred[1].double() - oracle[1]).abs() / prior).max())
    return em, ev


def _check_errors(label, errs):
    assert errs[0] <= PREDICT_BARS["mean"] and errs[1] <= PREDICT_BARS["var"], (
        label, errs, PREDICT_BARS)


def config9_predict(torch, smi):
    """Phase 11 (a): bench.py Config 9 Part A. At each archive size the
    posterior at fixed hyperparameters (amp 1, ls 0.5, noise 1e-6) of
    ZDT1-like targets in 30 dimensions, and each regime's predict of 128
    queries timed (best of 2, synchronized) with its cache build and
    bytes; every served regime is held to a float64 solve of the same
    posterior."""
    import numpy as np

    from dmosopt_tpu_torch.models import gp
    from dmosopt_tpu_torch.models import predictor as pr

    dim, d = REFIT_DIM, 2
    rng = np.random.default_rng(5)
    Xq = torch.as_tensor(rng.uniform(size=(PREDICT_QUERIES, dim)), dtype=torch.float32,
                         device="cuda")
    # nested archives: each size's rows start with the previous size's
    X_all = rng.uniform(size=(max(PREDICT_SIZES), dim)).astype(np.float32)
    rows = {}
    for N in PREDICT_SIZES:
        X = X_all[:N]
        Y = np.column_stack([X[:, 0], np.sum((X - 0.5) ** 2, axis=1)])
        Yn = (Y - Y.mean(0)) / Y.std(0)

        def posterior(dt):
            t = lambda a: torch.as_tensor(a, dtype=dt, device="cuda")  # noqa: E731
            amp, ls, noise = t(np.ones(d)), t(np.full((d, 1), 0.5)), t(np.full(d, 1e-6))
            mask = t(np.ones(N))
            L, alpha, nmll = gp.posterior_from_params(
                t(X), t(Yn), mask, amp, ls, noise, kernel="matern52", rel_jitter=1e-4)
            return gp.GPFit(X=t(X), L=L, alpha=alpha, amp=amp, ls=ls, noise=noise,
                            y_mean=t(np.zeros(d)), y_std=t(np.ones(d)), nmll=nmll,
                            train_mask=mask)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = posterior(torch.float32)
        torch.cuda.synchronize()
        posterior_s = time.perf_counter() - t0
        fit64 = posterior(torch.float64)
        oracle = gp.gp_predict(fit64, Xq.double())
        del fit64

        solve_ms = _best_ms(torch, lambda: gp.gp_predict(fit, Xq))
        errs = {"solve": _predict_errors(gp.gp_predict(fit, Xq), oracle, fit)}

        t0 = time.perf_counter()
        mm = pr.GPPredictor(fit, "matern52", "matmul", rel_jitter=1e-4)
        matmul_build_s = time.perf_counter() - t0
        matmul_ms = _best_ms(torch, lambda: mm.predict_normalized(Xq))
        errs["matmul"] = _predict_errors(mm.predict_normalized(Xq), oracle, fit)

        m = min(NYSTROM_M, N)
        z_idx = torch.as_tensor(np.round(np.linspace(0, N - 1, m)).astype(np.int64),
                                device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nc = pr.build_nystrom_cache(fit, z_idx, kernel="matern52", rel_jitter=1e-4)
        torch.cuda.synchronize()
        nystrom_build_s = time.perf_counter() - t0
        nystrom_ms = _best_ms(torch, lambda: pr.gp_predict_nystrom(nc, Xq))
        ny = pr.GPPredictor(fit, "matern52", "nystrom", rel_jitter=1e-4)
        errs[f"nystrom (serving {ny.regime})"] = _predict_errors(
            ny.predict_normalized(Xq), oracle, fit)
        raw = _predict_errors(pr.gp_predict_nystrom(nc, Xq), oracle, fit)
        row = {
            "n_queries": PREDICT_QUERIES, "posterior_build_s": posterior_s,
            "solve_ms": solve_ms, "matmul_ms": matmul_ms, "nystrom_ms": nystrom_ms,
            "matmul_build_s": matmul_build_s, "nystrom_build_s": nystrom_build_s,
            "matmul_cache_bytes": mm.cache_bytes(),
            "nystrom_cache_bytes": sum(t.numel() * t.element_size() for t in nc),
            "nystrom_m": m, "distill_error": ny.distill_error, "nystrom_regime": ny.regime,
            "errors": errs, "nystrom_kernel_errors": raw,
        }
        rows[N] = row
        print(f"[{smi}] Config 9 N={N}: predict of {PREDICT_QUERIES} queries solve "
              f"{solve_ms:.3f} ms, matmul {matmul_ms:.3f} ms, nystrom {nystrom_ms:.3f} ms "
              f"(m={m}); builds: posterior {posterior_s:.3f} s, matmul {matmul_build_s:.3f} s, "
              f"nystrom {nystrom_build_s:.3f} s; cache bytes matmul "
              f"{row['matmul_cache_bytes']}, nystrom {row['nystrom_cache_bytes']}; "
              f"distill_error {ny.distill_error} (serving {ny.regime}); errors against "
              f"the float64 solve (mean/y_std, var/prior) {errs}; the distilled kernel's "
              f"own {raw}")
        for label, e in errs.items():
            _check_errors(f"Config 9 N={N} {label}", e)
        del fit, mm, nc, ny
    return rows


def _zdt1_pool(torch):
    """bench.py Config 8 Part A's archive: uniform rows in 30 dimensions,
    ZDT1 objectives, N0 + 5k rows."""
    import numpy as np

    from dmosopt_tpu_torch.benchmarks.zdt import zdt1

    rng = np.random.default_rng(7)
    X = rng.uniform(size=(REFIT_N0 + (REFIT_FITS - 1) * REFIT_K, REFIT_DIM))
    Y = zdt1(torch.as_tensor(X.astype(np.float32), device="cuda")).cpu().numpy()
    return X, Y


def config8_refit(torch, smi):
    """Phase 11 (b): bench.py Config 8 Part A. Surrogate fits over a
    growing archive (120 rows, 32 more a fit, 6 fits, `gpr` with 8 starts
    and 200 steps), cold and then with a warm controller, after one
    warm-up fit; then the warm schedule again with the matmul predictor,
    whose predictions after every rank update are held to a fresh solve
    of the updated fit. Returns the walls and the warm path history."""
    import numpy as np

    from dmosopt_tpu_torch import moasmo
    from dmosopt_tpu_torch.models import gp
    from dmosopt_tpu_torch.models.refit import SurrogateRefitConfig, SurrogateRefitController

    X_pool, Y_pool = _zdt1_pool(torch)
    zl, zu = np.zeros(REFIT_DIM), np.ones(REFIT_DIM)
    Xq = torch.as_tensor(np.random.default_rng(9).uniform(size=(64, REFIT_DIM)),
                         dtype=torch.float32, device="cuda")

    def fits(ctrl, **extra):
        out = []
        for e in range(REFIT_FITS):
            n = REFIT_N0 + e * REFIT_K
            info = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sm = moasmo.train(
                REFIT_DIM, 2, zl, zu, X_pool[:n], Y_pool[:n], None,
                surrogate_method_kwargs={"n_starts": 8, "n_iter": 200, "seed": 0, **extra},
                info=info, surrogate_refit=ctrl, device="cuda",
            )
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0, info.get("refit_path", "cold"),
                        info["fit_n_steps"], sm))
        return out

    warm = lambda: SurrogateRefitController(SurrogateRefitConfig("warm"))  # noqa: E731
    moasmo.train(REFIT_DIM, 2, zl, zu, X_pool[:REFIT_N0], Y_pool[:REFIT_N0], None,
                 surrogate_method_kwargs={"n_starts": 8, "n_iter": 200, "seed": 0},
                 device="cuda")
    cold = fits(None)
    ctrl = warm()
    hot = fits(ctrl)
    cold_tail = sum(w for w, *_ in cold[1:])
    warm_tail = sum(w for w, *_ in hot[1:])
    for label, runs in (("cold", cold), ("warm", hot)):
        print(f"[{smi}] Config 8 {label} fits: " + "; ".join(
            f"N={REFIT_N0 + i * REFIT_K} {w:.3f} s {p} ({n} Adam steps)"
            for i, (w, p, n, _) in enumerate(runs)))
    print(f"[{smi}] Config 8: fit walls for epochs 2-{REFIT_FITS} cold {cold_tail:.3f} s, "
          f"warm {warm_tail:.3f} s (speedup {cold_tail / max(warm_tail, 1e-9):.2f}); "
          f"warm path_history {ctrl.path_history}")
    assert all(p == "cold" and n > 0 for _, p, n, _ in cold), cold
    hist = ctrl.path_history
    assert hist[0] == "cold" and "warm" in hist, hist
    assert {"rank", "rank_refactor"} & set(hist), hist
    assert all(n == 0 for _, p, n, _ in hot if p.startswith("rank")), hot

    # the same schedule with the matmul predictor: after every rank update
    # the served predictions must be a fresh solve's of the updated fit
    ctrl_mm = warm()
    checked = []
    for w, p, n, sm in fits(ctrl_mm, predictor="matmul"):
        if p.startswith("rank"):
            errs = _predict_errors(sm.predict_normalized(Xq), gp.gp_predict(sm.fit, Xq),
                                   sm.fit)
            checked.append((p, sm.predictor_regime, errs))
            _check_errors(f"Config 8 matmul after {p}", errs)
    print(f"[{smi}] Config 8 matmul predictor after each rank update, against a fresh "
          f"solve of the updated fit (mean/y_std, var/prior): {checked}")
    assert ctrl_mm.path_history == hist, (ctrl_mm.path_history, hist)
    assert any(p == "rank" for p, *_ in checked), checked
    return {"cold_s": cold_tail, "warm_s": warm_tail, "path_history": hist}


def refit_e2e(torch, V, smi):
    """Phase 11 (c): bench.py Configs 8 and 9 Part B, zdt1_agemoea_gpr
    cold (Config 9's solve), warm and with the matmul predictor; each
    launches the fused offspring kernel once a generation (300) and the
    standalone kernels never. ``within_0.05`` is printed, not gated: runs
    whose surrogate stays the first epoch's read within the cold runs'
    range in both packages (tools/refit_quality.py, seeds 42-44), so no
    bar on it can fail a stale predictor. Returns the launch counts of
    the three runs."""
    import numpy as np

    import dmosopt_tpu_torch
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1
    from dmosopt_tpu_torch.driver import dopt_dict

    n_gen = PART_B_EPOCHS * REFIT_GENERATIONS
    out, launches = {}, {}
    for mode in ("cold", "warm", "matmul"):
        opt_id = f"zdt1_agemoea_gpr_{mode}"
        V.reset_kernel_launches()
        t0 = time.perf_counter()
        best = dmosopt_tpu_torch.run(
            refit_params(opt_id, zdt1, mode, torch_objective=True,
                         n_epochs=PART_B_EPOCHS), verbose=False)
        wall = time.perf_counter() - t0
        launches[mode] = dict(V.KERNEL_LAUNCHES)
        dopt = dopt_dict[opt_id]
        y = np.column_stack([v for _, v in best[1]])
        within = within_front(y)
        paths = [s.get("refit_path") for s in dopt.epoch_stats]
        regimes = [s.get("gp_predictor") for s in dopt.epoch_stats]
        out[mode] = within
        print(f"[{smi}] Part B {mode}: run() {wall:.3f} s, {y.shape[0]} returned, "
              f"within_0.05 {within}; GP fits " + ", ".join(
                  f"{s['train_s']:.3f}" for s in dopt.epoch_stats)
              + f" s; refit paths {paths}; predictor {regimes}; kernel launches "
              f"{launches[mode]}")
        assert sum(s["n_generations"] for s in dopt.epoch_stats) == n_gen
        assert launches[mode] == {"offspring": n_gen, "sbx": 0, "mutation": 0}, launches
        x_all, y_all = dopt.optimizer_dict[0].get_evals()
        _check_archive(x_all, y_all, dopt.eval_count, f"Part B {mode}")
        if mode == "warm":
            hist = dopt.optimizer_dict[0].refit_controller.path_history
            assert hist[0] == "cold" and len(set(hist)) > 1, hist
        if mode == "matmul":
            assert set(regimes) == {"matmul"}, regimes
    print(f"[{smi}] Part B within_0.05 (printed, not gated): {out}")
    return launches


def reusing_surrogate(torch, V, smi):
    """Phase 11: bench.py Configs 9 and 8 Part A, then Part B."""
    config9_predict(torch, smi)
    config8_refit(torch, smi)
    return refit_e2e(torch, V, smi)


# the sparse and deep surrogates (phase 12): (a) a run whose design
# alone passes the dense-kernel threshold of 4096 rows (150 points per
# parameter of ZDT1's 30: 4500 rows), so every epoch reroutes `gpr` to
# `svgp` (1125 inducing rows, batch 256, 400 Adam steps); (b) each new
# registry name at the quick start's width; (c) mean-variance
SPARSE_DIM, SPARSE_POP, SPARSE_GENERATIONS, SPARSE_EPOCHS = 30, 200, 100, 2
SPARSE_N_INITIAL = 150
SPARSE_NAMES = ("vgp", "svgp", "spv", "siv", "crv", "mdgp", "mdspp")
# the quality gate: both epochs of (b)'s `svgp` run must read a surrogate
# error on the inner EA's offspring of their last SPARSE_LAST_GENERATIONS
# generations (the mean over the objectives of the mean absolute error
# against ZDT1 over the standard deviation of the design's objective
# values) below this bar, which a fit whose variational mean is zeroed
# fails. The large-archive run is printed, not gated: at 4500 rows the
# sparse fit of both packages settles on the all-noise solution (a
# lengthscale near 0.23, an amplitude near 0.016, noise near 0.64) and
# predicts the archive mean, as the zeroed copy does; and its resampled
# rows are archived rows in both packages, whose logged predictions are
# their archived values (tools/sparse_quality.py; PERF.md section 6)
SPARSE_ERROR_BAR = 0.75
SPARSE_LAST_GENERATIONS = 10
# Adam steps timed for the dense `gpr` fit at the threshold's 4096 rows
DENSE_STEPS = (5, 10)


def sparse_params(opt_id, obj_fun, n_initial=None, **over):
    """Phase 12's configuration: ZDT1 with 30 parameters, NSGA-II, pop
    200, 100 generations, 2 epochs, ``n_initial`` points per parameter
    (150: 4500 rows, rerouted to `svgp`), `gpr` defaults, seed 0."""
    params = {
        "opt_id": opt_id, "obj_fun": obj_fun, "objective_names": ["f1", "f2"],
        "space": {f"x{i:02d}": [0.0, 1.0] for i in range(SPARSE_DIM)},
        "problem_parameters": {},
        "n_initial": SPARSE_N_INITIAL if n_initial is None else n_initial,
        "n_epochs": SPARSE_EPOCHS,
        "population_size": SPARSE_POP, "num_generations": SPARSE_GENERATIONS,
        "optimizer_name": "nsga2", "surrogate_method_name": "gpr", "random_seed": 0,
    }
    params.update(over)
    return params


def new_rows(rows, archive):
    """Mask of ``rows`` that equal, in float32, neither a row of
    ``archive`` nor an earlier row of ``rows``: the EA works in float32,
    so an archived row it resamples comes back rounded. Host numpy."""
    import numpy as np

    seen = {r.tobytes() for r in np.asarray(archive, np.float32)}
    new = np.zeros(len(rows), dtype=bool)
    for i, r in enumerate(np.asarray(rows, np.float32)):
        new[i] = r.tobytes() not in seen
        seen.add(r.tobytes())
    return new


def zdt1_host(x):
    """ZDT1 of the rows of ``x`` in float64 numpy, for either package's
    host copies of its rows."""
    import numpy as np

    x = np.asarray(x, np.float64)
    f1 = x[:, 0]
    g = 1.0 + 9.0 * np.mean(x[:, 1:], axis=1)
    return np.column_stack([f1, g * (1.0 - np.sqrt(f1 / g))])


def offspring_mae(res, last=SPARSE_LAST_GENERATIONS):
    """Per-objective mean absolute error of the surrogate's values (mean
    columns) of the inner EA's offspring of the last ``last`` generations
    of an epoch (its `EpochResults` ``x``, ``y`` and ``gen_index``),
    against ZDT1 of those rows."""
    import numpy as np

    gen = np.asarray(res.gen_index)
    rows = gen > max(int(gen.max()) - last, 0)
    x, pred = np.asarray(res.x)[rows], np.asarray(res.y)[rows][:, :2]
    return [float(v) for v in np.mean(np.abs(zdt1_host(x) - pred), axis=0)]


class capture_epoch_results:
    """Keep each epoch's `EpochResults` that ``driver_cls`` hands its
    ``_finish_problem_epoch`` (either package's driver), for the
    duration of a ``with`` block."""

    def __init__(self, driver_cls):
        self.cls, self.results = driver_cls, []

    def __enter__(self):
        self.original = original = self.cls._finish_problem_epoch
        results = self.results

        def finish(dopt, problem_id, epoch, advance_epoch, res, *args):
            results.append(res)
            return original(dopt, problem_id, epoch, advance_epoch, res, *args)

        self.cls._finish_problem_epoch = finish
        return self

    def __exit__(self, *exc):
        self.cls._finish_problem_epoch = self.original
        return False


def sparse_error(mae, y_design):
    """The gate's reading: the mean over the objectives of a per-objective
    mean absolute error over the standard deviation of the design's
    objective values."""
    import numpy as np

    return float(np.mean(np.asarray(mae) / np.std(np.asarray(y_design), axis=0)))


def _check_front_run(dopt, best, n0, label):
    """Phase 4's checks of a run's result, for archives too large for a
    pairwise distance matrix: every evaluation but the design's first
    epoch counted, the archive finite and each row once, the returned
    set finite and non-dominated, and closer to the ZDT1 front than the
    design (median distance). Returns (returned, design) distances."""
    import numpy as np

    from dmosopt_tpu_torch.benchmarks.zdt import distance_to_front, zdt1_pareto

    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    n_resample = int(dopt.population_size * dopt.resample_fraction)
    n_epochs = len(dopt.epoch_stats)
    assert n0 < dopt.eval_count <= n0 + (n_epochs - 1) * n_resample, (label, dopt.eval_count)
    assert np.all(np.isfinite(x_all)) and np.all(np.isfinite(y_all)), label
    assert np.unique(x_all, axis=0).shape[0] == x_all.shape[0] <= dopt.eval_count, label
    y = np.column_stack([v for _, v in best[1]])
    assert y.shape[0] > 0 and np.all(np.isfinite(y)), label
    le = np.all(y[:, None, :] <= y[None, :, :], axis=2)
    lt = np.any(y[:, None, :] < y[None, :, :], axis=2)
    assert not np.any(le & lt), f"{label}: returned set is dominated"
    front = zdt1_pareto(1000)
    d_best = float(np.median(distance_to_front(y, front)))
    d_init = float(np.median(distance_to_front(y_all[:n0], front)))
    assert d_best < d_init, (label, d_best, d_init)
    return d_best, d_init


def _sparse_run(torch, V, smi, label, params, n0):
    """One phase-12 run through run(): the fused kernel launches once a
    generation and the standalone kernels never; phase 4's checks; each
    epoch's surrogate, fit wall, Adam steps, EA wall and accuracy
    printed. Returns (launches, the DistOptimizer, each epoch's
    `EpochResults`)."""
    import dmosopt_tpu_torch
    from dmosopt_tpu_torch.driver import DistOptimizer, dopt_dict

    V.reset_kernel_launches()
    t0 = time.perf_counter()
    with capture_epoch_results(DistOptimizer) as cap:
        best = dmosopt_tpu_torch.run(params, verbose=False)
    wall = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)
    dopt = dopt_dict[params["opt_id"]]
    n_gen = sum(s["n_generations"] for s in dopt.epoch_stats)
    assert n_gen == SPARSE_GENERATIONS * len(dopt.epoch_stats), (label, n_gen)
    assert launches == {"offspring": n_gen, "sbx": 0, "mutation": 0}, (label, launches)
    d_best, d_init = _check_front_run(dopt, best, n0, label)
    for s in dopt.epoch_stats:
        fit = s.get("objective", {})
        print(f"[{smi}] {label} epoch {s['epoch']}: {s['surrogate']} on {s['n_train']} rows, "
              f"fit {s['train_s']:.3f} s ({fit.get('n_steps')} Adam steps, "
              f"early stopped {s.get('fit_early_stopped')}), EA {s['optimize_s']:.3f} s; "
              f"accuracy {s.get('surrogate_accuracy')}")
    print(f"[{smi}] {label}: run() {wall:.3f} s, {dopt.eval_count} evaluations, "
          f"median distance to the front {d_best:.4f} (design {d_init:.4f}); kernel "
          f"launches {launches}")
    return launches, dopt, cap.results


def _fit_step_readings(torch, smi, X, Y, **fit_kw):
    """ms an Adam step of `fit_svgp` at the run's shapes (the difference of
    two fits of 20 and 60 steps over 40, synchronized), the kernel
    launches a step (torch.profiler's cudaLaunchKernel count over 10
    profiled steps, those of a 0-step fit taken off), and ms a predict of
    200 queries on the 60-step fit (median of 5, synchronized)."""
    from dmosopt_tpu_torch.models.svgp import fit_svgp, svgp_predict

    def fit(n_iter):
        return fit_svgp(torch.Generator(device="cuda").manual_seed(0), X, Y,
                        n_iter=n_iter, **fit_kw)

    def walled(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    fit(2)
    t20, _ = walled(lambda: fit(20))
    t60, fitted = walled(lambda: fit(60))
    ms_step = 1e3 * (t60 - t20) / 40

    def launches(n_iter):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fit(n_iter)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)

    per_step = (launches(10) - launches(0)) / 10
    Xq = torch.rand((200, X.shape[1]), generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    predict_ms = sorted(walled(lambda: svgp_predict(fitted, Xq))[0] for _ in range(5))[2] * 1e3
    print(f"[{smi}] svgp fit at N={X.shape[0]}, {fit_kw}: {ms_step:.3f} ms an Adam step, "
          f"{per_step:.1f} kernel launches a step; predict of 200 queries {predict_ms:.3f} ms")
    return ms_step, per_step, predict_ms


def sparse_large_archive(torch, V, smi):
    """Phase 12 (a): 4500 design rows, `gpr` rerouted to `svgp` every
    epoch, its surrogate error printed; the fit's and the predict's
    readings; the design time; the dense `gpr` fit at the threshold's
    4096 rows. Returns the launch counts."""
    import numpy as np

    from dmosopt_tpu_torch import moasmo, sampling
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1
    from dmosopt_tpu_torch.models.gp import GPR_Matern

    n0 = SPARSE_N_INITIAL * SPARSE_DIM
    t0 = time.perf_counter()
    sampling.slh(n0, SPARSE_DIM, np.random.default_rng(0), maxiter=5)
    t1 = time.perf_counter()
    sampling.slh(n0, SPARSE_DIM, np.random.default_rng(0), maxiter=0)
    t2 = time.perf_counter()
    print(f"[{smi}] design of {n0} rows (SLH, 5 decorrelation rounds): {t1 - t0:.3f} s, "
          f"of it {t1 - t0 - (t2 - t1):.3f} s the decorrelation")

    params = sparse_params("sparse_large_archive", zdt1, torch_objective=True)
    launches, dopt, results = _sparse_run(torch, V, smi, "large archive", params, n0)
    stats = dopt.epoch_stats
    assert [s["surrogate"] for s in stats] == ["svgp"] * SPARSE_EPOCHS, stats
    # a quarter of the deduplicated rows (1125 for the design), at least 100
    assert all(s["objective"]["n_inducing"] == max(int(0.25 * s["n_train"]), 100)
               for s in stats), [s["objective"] for s in stats]
    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    acc = stats[1]["surrogate_accuracy"]
    x_fold = dopt.optimizer_dict[0].folded_evals[0]
    n_new = int(new_rows(x_fold, x_all[:n0]).sum())
    errors = [sparse_error(offspring_mae(res), y_all[:n0]) for res in results]
    print(f"[{smi}] large archive: {n_new} of {acc['n_rows']} resampled rows not in "
          f"the design, the logged error on all of them {acc['mae']}; error on the "
          f"last {SPARSE_LAST_GENERATIONS} generations' offspring, epochs 0 and 1: "
          f"{errors} (bar {SPARSE_ERROR_BAR})")

    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.rand((n0, SPARSE_DIM), generator=gen, device="cuda")
    Yz = zdt1(X)
    Y = (Yz - Yz.mean(0)) / Yz.std(0)
    readings = _fit_step_readings(torch, smi, X, Y, n_inducing=n0 // 4,
                                  share_kernel=True, share_inducing=True)

    # the dense fit at the threshold, where it stays dense
    n_dense = moasmo.LARGE_N_THRESHOLD
    xd, yd = X[:n_dense].cpu().numpy(), Yz[:n_dense].cpu().numpy()
    walls = []
    for n_iter in DENSE_STEPS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        GPR_Matern(xd, yd, SPARSE_DIM, 2, np.zeros(SPARSE_DIM), np.ones(SPARSE_DIM),
                   n_iter=n_iter, seed=0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    dense_ms = 1e3 * (walls[1] - walls[0]) / (DENSE_STEPS[1] - DENSE_STEPS[0])
    print(f"[{smi}] dense gpr fit at N={n_dense} (8 starts): {dense_ms:.3f} ms an Adam "
          f"step (fits of {DENSE_STEPS[0]} and {DENSE_STEPS[1]} steps: "
          f"{walls[0]:.3f} s, {walls[1]:.3f} s); svgp at N={n0}: {readings[0]:.3f} ms")
    return launches


def sparse_names(torch, V, smi):
    """Phase 12 (b): each new name through run() at the quick start's
    width, mdgp once more with early stopping, and egp past a threshold
    of 64 rows (rerouted to svgp). Returns each run's launch counts and
    the `svgp` run's offspring errors (the quality gate's reading)."""
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1

    n0 = 3 * SPARSE_DIM
    runs = [(name, name, {}) for name in SPARSE_NAMES]
    runs += [("mdgp_early_stopping", "mdgp", {"early_stopping": True}),
             ("egp_rerouted", "egp", {"large_n_threshold": 64})]
    out, gate = {}, None
    for label, name, kw in runs:
        params = sparse_params(f"sparse_{label}", zdt1, n_initial=3, torch_objective=True,
                               surrogate_method_name=name, surrogate_method_kwargs=kw)
        out[label], dopt, results = _sparse_run(torch, V, smi, label, params, n0)
        routed = "svgp" if label == "egp_rerouted" else name
        assert [s["surrogate"] for s in dopt.epoch_stats] == [routed] * SPARSE_EPOCHS
        acc = dopt.epoch_stats[1]["surrogate_accuracy"]
        assert acc["n_rows"] > 0 and all(map(lambda v: v == v, acc["mae"])), acc
        _, y_all = dopt.optimizer_dict[0].get_evals()
        errors = [sparse_error(offspring_mae(r), y_all[:n0]) for r in results]
        print(f"[{smi}] {label}: error on the last {SPARSE_LAST_GENERATIONS} "
              f"generations' offspring, epochs 0 and 1: {errors}; on the resampled "
              f"rows {sparse_error(acc['mae'], y_all[:n0]):.4f}")
        if label == "svgp":
            gate = errors
        if label == "mdgp_early_stopping":
            print(f"[{smi}] mdgp with early stopping: Adam steps "
                  f"{[s['fit_n_steps'] for s in dopt.epoch_stats]}, early stopped "
                  f"{[s['fit_early_stopped'] for s in dopt.epoch_stats]}")
    return out, gate


def sparse_mean_variance(torch, V, smi):
    """Phase 12 (c): the quick start with ``optimize_mean_variance`` and
    `svgp`: the EA ranks 4 columns, the resampled rows carry 4 finite
    prediction columns (variances non-negative), and the accuracy log
    reads the 2 mean columns."""
    import numpy as np

    from dmosopt_tpu_torch.benchmarks.zdt import zdt1

    params = sparse_params("sparse_mean_variance", zdt1, n_initial=3, torch_objective=True,
                           surrogate_method_name="svgp", optimize_mean_variance=True)
    launches, dopt, _ = _sparse_run(torch, V, smi, "mean-variance", params, 3 * SPARSE_DIM)
    strat = dopt.optimizer_dict[0]
    pred = strat.folded_evals[2]
    assert pred.shape[1] == 4 and np.all(np.isfinite(pred)), pred.shape
    assert np.all(pred[:, 2:] >= 0.0)
    acc = dopt.epoch_stats[1]["surrogate_accuracy"]
    assert len(acc["mae"]) == 2, acc
    print(f"[{smi}] mean-variance: {pred.shape[0]} resampled rows with {pred.shape[1]} "
          f"prediction columns, variances {pred[:, 2:].min():.3e} to {pred[:, 2:].max():.3e}")
    return launches


def sparse_surrogates(torch, V, smi):
    """Phase 12: the sparse and deep surrogates. The quality gate is held
    last, after every run printed its readings. Returns each run's kernel
    launch counts."""
    launches = {"large_archive": sparse_large_archive(torch, V, smi)}
    names, gate = sparse_names(torch, V, smi)
    launches.update(names)
    launches["mean_variance"] = sparse_mean_variance(torch, V, smi)
    print(f"[{smi}] quality gate: svgp's offspring errors {gate} (bar {SPARSE_ERROR_BAR})")
    assert max(gate) < SPARSE_ERROR_BAR, ("svgp surrogate error", gate)
    return launches


# the problem-batched core (phase 13): bench.py Config 11
# (bench.py:1044-1197), its tenant counts, and the quick start's width
# at 16 tenants
CONFIG11_TENANTS = (1, 16, 64)
WIDE_TENANTS, WIDE_EPOCHS = 16, 2
FEATURE_PROBLEMS = (0, 1, 2)
CUSTOM_TRAINING_CALLS = []


def config11_params(opt_id, T, **over):
    """bench.py Config 11's parameters, with a torch objective."""
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1

    params = {
        "opt_id": opt_id, "obj_fun": zdt1, "torch_objective": True,
        "objective_names": ["f1", "f2"],
        "space": {f"x{i}": [0.0, 1.0] for i in range(4)},
        "problem_parameters": {}, "n_initial": 3, "n_epochs": 2,
        "population_size": 16, "num_generations": 8, "resample_fraction": 0.5,
        "optimizer_name": "nsga2", "surrogate_method_name": "gpr",
        "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 40, "seed": 0},
        "random_seed": 17, "tenant_batching": True,
    }
    if T > 1:
        params["problem_ids"] = set(range(T))
    params.update(over)
    return params


def _non_dominated(y):
    import numpy as np

    le = np.all(y[:, None, :] <= y[None, :, :], axis=2)
    lt = np.any(y[:, None, :] < y[None, :, :], axis=2)
    return not np.any(le & lt)


def _check_tenants(dopt, best, label):
    """Every tenant's archive holds each row once, all finite, and its
    returned set is finite and non-dominated. Returns the tenants'
    archives."""
    import numpy as np

    best = best if dopt.has_problem_ids else {0: best}
    archives = {}
    for pid in sorted(dopt.problem_ids):
        x_all, y_all = dopt.optimizer_dict[pid].get_evals()
        assert np.all(np.isfinite(x_all)) and np.all(np.isfinite(y_all)), (label, pid)
        d2 = ((x_all[:, None, :] - x_all[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        assert d2.min() > 0.0, (label, pid, "a row archived twice")
        y = np.column_stack([v for _, v in best[pid][1]])
        assert y.shape[0] > 0 and np.all(np.isfinite(y)), (label, pid)
        assert _non_dominated(y), (label, pid, "returned set is dominated")
        archives[pid] = (x_all, y_all, y)
    return archives


def _tenant_run(torch, V, params):
    """One run through run(), counts reset just before and read just
    after: (wall, launches, the driver, the returned sets)."""
    import dmosopt_tpu_torch
    from dmosopt_tpu_torch.driver import dopt_dict

    torch.cuda.synchronize()
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    best = dmosopt_tpu_torch.run(params, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, dict(V.KERNEL_LAUNCHES), dopt_dict[params["opt_id"]], best


def config11(torch, V, smi):
    """Phase 13 (a): bench.py Config 11 at T = 1, 16 and 64, best of 2."""
    walls, launches, gens = {}, {}, 2 * 8
    for T in CONFIG11_TENANTS:
        best_wall = float("inf")
        for rep_ in range(2):
            wall, counts, dopt, best = _tenant_run(
                torch, V, config11_params(f"config11_{T}_{rep_}", T))
            best_wall = min(best_wall, wall)
            if T > 1:
                routes = [set(s["routing"].values()) for s in dopt.epoch_stats]
                assert routes == [{"batched"}] * 2, (T, routes)
            # one fused launch a generation, for the whole bucket
            assert counts == {"offspring": gens, "sbx": 0, "mutation": 0}, (T, counts)
            _check_tenants(dopt, best, f"config11 T={T}")
        walls[T], launches[T] = best_wall, counts
        print(f"[{smi}] config 11 T={T}: wall {best_wall:.3f} s (best of 2), "
              f"{T / best_wall:.3f} tenants/s, wall_vs_single "
              f"{best_wall / walls[1]:.3f}, offspring launches {counts['offspring']} "
              f"({counts['offspring'] / gens:g} a generation)")
    return walls, launches


def wide_tenants(torch, V, smi):
    """Phase 13 (b): 16 tenants at the quick start's width, batched,
    against one tenant's wall; phase 4's quality gate on every tenant."""
    import numpy as np

    from dmosopt_tpu_torch.benchmarks.zdt import distance_to_front, zdt1, zdt1_pareto

    dim, pop, gens = 30, 200, 100
    over = dict(space={f"x{i}": [0.0, 1.0] for i in range(dim)}, population_size=pop,
                num_generations=gens, n_initial=3, n_epochs=WIDE_EPOCHS,
                surrogate_method_kwargs={}, random_seed=0, resample_fraction=0.25,
                obj_fun=zdt1)
    single, counts1, _, _ = _tenant_run(torch, V, config11_params("wide_1", 1, **over))
    wall, counts, dopt, best = _tenant_run(
        torch, V, config11_params("wide_16", WIDE_TENANTS, **over))
    assert counts1 == counts == {"offspring": WIDE_EPOCHS * gens, "sbx": 0,
                                 "mutation": 0}, (counts1, counts)
    assert all(set(s["routing"].values()) == {"batched"} for s in dopt.epoch_stats)
    archives = _check_tenants(dopt, best, "wide tenants")
    front = zdt1_pareto(1000)
    n0 = 3 * dim
    ratios = []
    for pid, (_, y_all, y) in archives.items():
        d_best = float(np.median(distance_to_front(y, front)))
        d_init = float(np.median(distance_to_front(y_all[:n0], front)))
        assert d_best < d_init, (pid, d_best, d_init)
        ratios.append(d_best / d_init)
    for s in dopt.epoch_stats:
        p0 = s["problems"][0]
        print(f"[{smi}] 16 tenants epoch {s['epoch']}: {s['epoch_s']:.3f} s, bucket fit "
              f"{16 * p0['cost_fit_seconds']:.3f} s ({p0['objective']['n_steps']} Adam "
              f"steps), bucket EA {16 * p0['cost_ea_seconds']:.3f} s")
    print(f"[{smi}] 16 tenants at the quick start's width, {WIDE_EPOCHS} epochs: "
          f"{wall:.3f} s against one tenant's {single:.3f} s ({wall / single:.2f}x, "
          f"16x would be {16 * single:.3f} s); median distance to the front over the "
          f"design's, per tenant {min(ratios):.3f}-{max(ratios):.3f}")
    return wall, single, counts


def custom_gpr_training(optimizer_cls, Xinit, Yinit, C, xlb, xub, file_path,
                        options=None, **kwargs):
    """A ``surrogate_custom_training`` hook: fits the `gpr` surrogate the
    options name with the hook's own kwargs, and records its call."""
    from dmosopt_tpu_torch.models.gp import GPR_Matern

    sm = GPR_Matern(Xinit, Yinit, len(xlb), Yinit.shape[1], xlb, xub,
                    **{**options["surrogate_method_kwargs"], **kwargs})
    CUSTOM_TRAINING_CALLS.append((sorted(options), Xinit.shape, sm))
    return optimizer_cls, sm, None, None


def _zdt1_features(x):
    """ZDT1 of (B, n) rows with two features: the sum of the rows'
    parameters and g."""
    import torch

    from dmosopt_tpu_torch.benchmarks.zdt import zdt1

    g = 1.0 + 9.0 / (x.shape[1] - 1) * x[:, 1:].sum(dim=1)
    return zdt1(x), torch.stack([x.sum(dim=1), g], dim=1)


class _CountingEvaluator:
    """An evaluator the caller builds: a batched torch evaluator over the
    problems with features that counts its calls and any close."""

    def __init__(self, torch):
        from dmosopt_tpu_torch.parallel.evaluator import TorchBatchEvaluator

        self.inner = TorchBatchEvaluator(_zdt1_features, torch.device("cuda"),
                                         problem_ids=list(FEATURE_PROBLEMS))
        self.batches = self.closed = 0

    def evaluate_batch(self, space_vals_list):
        self.batches += 1
        return self.inner.evaluate_batch(space_vals_list)

    def close(self):
        self.closed += 1


def feature_problems(torch, V, smi):
    """Phase 13 (c): three problems with feature_dtypes, sequential, an
    external evaluator and a custom-training hook; returns the launches."""
    import numpy as np

    evaluator = _CountingEvaluator(torch)
    CUSTOM_TRAINING_CALLS.clear()
    params = config11_params(
        "feature_problems", 1, problem_ids=set(FEATURE_PROBLEMS), tenant_batching=False,
        obj_fun=_zdt1_features, evaluator=evaluator,
        feature_dtypes=[("x_sum", "<f8"), ("g", "<f8")],
        surrogate_custom_training=f"{__name__}.custom_gpr_training",
        surrogate_custom_training_kwargs={"n_iter": 30},
    )
    import dmosopt_tpu_torch
    from dmosopt_tpu_torch.driver import dopt_dict

    V.reset_kernel_launches()
    t0 = time.perf_counter()
    best = dmosopt_tpu_torch.run(params, verbose=False, return_features=True)
    wall = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)
    dopt = dopt_dict["feature_problems"]
    assert sorted(best) == list(FEATURE_PROBLEMS), sorted(best)
    assert evaluator.batches > 0 and evaluator.closed == 0, vars(evaluator)
    # the hook ran for every problem's every epoch, and its model served
    assert len(CUSTOM_TRAINING_CALLS) == 2 * len(FEATURE_PROBLEMS), len(CUSTOM_TRAINING_CALLS)
    assert all(s["problems"][p]["objective"]["n_iter_max"] == 30
               for s in dopt.epoch_stats for p in FEATURE_PROBLEMS)
    for pid, (prms, res, ftrs) in best.items():
        x = np.column_stack([v for _, v in prms])
        assert ftrs.dtype.names == ("x_sum", "g") and ftrs.shape == (x.shape[0],), ftrs.dtype
        np.testing.assert_allclose(ftrs["x_sum"], x.sum(axis=1), rtol=1e-5)
        assert _non_dominated(np.column_stack([v for _, v in res]))
    assert launches == {"offspring": 2 * 8 * len(FEATURE_PROBLEMS), "sbx": 0,
                        "mutation": 0}, launches
    print(f"[{smi}] 3 problems with features: {wall:.3f} s, returned "
          f"{[len(best[p][2]) for p in FEATURE_PROBLEMS]} feature records, hook calls "
          f"{len(CUSTOM_TRAINING_CALLS)}, evaluator batches {evaluator.batches}, "
          f"closed {evaluator.closed}")
    return launches


def tenant_core(torch, V, smi):
    """Phase 13: the several-problem run and the batched tenant core.
    Returns each run's launch counts."""
    walls, launches = config11(torch, V, smi)
    wall, single, wide = wide_tenants(torch, V, smi)
    feats = feature_problems(torch, V, smi)
    out = {f"config11_T{T}": c for T, c in launches.items()}
    out.update(wide_16=wide, features=feats)
    return out


# phase 14: the span tree every epoch of a surrogate run opens (the
# epoch's children; the background writer's h5_write spans are roots of
# their own thread, and this store-less run writes none)
EPOCH_CHILDREN = {"eval_dispatch", "eval_drain", "gp_fit", "ea_scan", "resample"}
# the device-clock rows phase 14 (a) gates on, and the name of
# launch_offspring's kernel in a captured trace
TRACED_ROWS = ("gp_fit", "ea_scan")
OFFSPRING_KERNEL_NAME = "offspring_kernel"
# tenant device seconds must sum to the bucket rows' within this share
TENANT_SECONDS_RTOL = 0.05


def _span_tree(tel):
    """{(span name, parent name or None)}: the captured run's span tree."""
    spans = tel.tracer.spans()
    by_id = {sp.span_id: sp.name for sp in spans}
    return {(sp.name, by_id.get(sp.parent_id)) for sp in spans}


def _captured_rows(tel, label):
    """The ledger's program rows, printed with their device seconds;
    returns {(program, bucket): row}."""
    rows = {(r.program, r.bucket): r for r in tel.ledger.program_rows()}
    for (prog, bucket), r in sorted(rows.items(), key=lambda kv: (kv[0][0], kv[0][1] or "")):
        print(f"  {label} row {prog}{'' if bucket is None else f' [{bucket}]'}: "
              f"device {r.device_time_s * 1e3:.3f} ms of host {r.host_time_s * 1e3:.3f} ms, "
              f"{r.n_joined}/{r.n_spans} spans joined")
    return rows


def telemetry_quick_start(torch, V, smi, profile_dir):
    """Phase 14 (a): the quick start with the default telemetry and a
    capture of epoch 1; returns the kernel launch counts of the run."""
    import dmosopt_tpu_torch
    from dmosopt_tpu_torch.driver import dopt_dict

    dim, pop, gens, n_initial, n_epochs = QUICK_START
    params = quick_start_params(
        "telemetry_quick_start",
        telemetry={"profile_dir": profile_dir, "profile_epochs": [1]},
    )
    torch.cuda.synchronize()
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    dmosopt_tpu_torch.run(params, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)
    tel = dopt_dict["telemetry_quick_start"].telemetry
    assert launches == {"offspring": n_epochs * gens, "sbx": 0, "mutation": 0}, launches

    tree = _span_tree(tel)
    assert {(n, "epoch") for n in EPOCH_CHILDREN} <= tree, tree
    assert ("epoch", None) in tree, tree
    counters = tel.registry.snapshot()["counters"]
    assert counters["ea_generations_total"][""] == n_epochs * gens, counters
    assert counters["epochs_total"][""] == n_epochs, counters

    cap = tel.ledger.last_capture
    assert tel.ledger.captures == 1, tel.ledger.captures
    busy, overlap = cap.device_busy_fraction, cap.device_overlap_ratio
    assert busy is not None and 0.0 < busy <= 1.0, busy
    rows = _captured_rows(tel, "quick start epoch 1")
    for name in TRACED_ROWS:
        assert rows[(name, None)].device_time_s > 0.0, (name, rows[(name, None)])
    kernels = {k: v for k, v in cap.device_events.items() if OFFSPRING_KERNEL_NAME in k}
    assert kernels, sorted(cap.device_events)[:20]
    n_off = sum(int(v[0]) for v in kernels.values())
    # epoch 1 ran `gens` generations, one fused launch each
    assert n_off == gens, (n_off, kernels)
    top = sorted(cap.device_events.items(), key=lambda kv: -kv[1][1])[:5]
    print(f"[{smi}] telemetry (a) quick start {wall:.3f} s with a capture of epoch 1: "
          f"device_busy_fraction {busy:.4f}, device_overlap_ratio {overlap:.4f}, "
          f"window {cap.window_s:.3f} s, device busy {cap.device_busy_s:.4f} s, "
          f"{cap.n_device_lanes} device lane(s), {cap.n_joined}/{cap.n_spans} spans joined; "
          f"{n_off} {OFFSPRING_KERNEL_NAME} events, "
          f"{sum(v[1] for v in kernels.values()) * 1e3:.3f} ms")
    print("  top device events: " + "; ".join(
        f"{name[:60]} x{int(c)} {t * 1e3:.3f} ms" for name, (c, t) in top))
    return launches


def telemetry_overhead(torch, V, smi):
    """Phase 14 (b): the quick start with telemetry=False and with the
    default, interleaved (off, on, on, off), best of 2 each; printed."""
    import dmosopt_tpu_torch

    walls = {"off": [], "on": []}
    for i, mode in enumerate(("off", "on", "on", "off")):
        over = {"telemetry": False} if mode == "off" else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dmosopt_tpu_torch.run(quick_start_params(f"telemetry_{mode}_{i}", **over),
                              verbose=False)
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
    off, on = min(walls["off"]), min(walls["on"])
    print(f"[{smi}] telemetry (b) quick start wall, best of 2: telemetry=False "
          f"{off:.3f} s ({walls['off'][0]:.3f}, {walls['off'][1]:.3f}), default "
          f"{on:.3f} s ({walls['on'][0]:.3f}, {walls['on'][1]:.3f}); "
          f"on/off {on / off:.4f}")
    return off, on


def telemetry_bucket(torch, V, smi, profile_dir):
    """Phase 14 (c): bench.py Config 11 at 16 problems with a capture of
    epoch 1: the bucket rows and each tenant's device seconds, which
    must sum to the bucket rows' within TENANT_SECONDS_RTOL."""
    from dmosopt_tpu_torch.tenants import bucket_label

    T = 16
    params = config11_params(
        "telemetry_config11", T,
        telemetry={"profile_dir": profile_dir, "profile_epochs": [1]},
    )
    wall, counts, dopt, best = _tenant_run(torch, V, params)
    assert counts == {"offspring": 2 * 8, "sbx": 0, "mutation": 0}, counts
    _check_tenants(dopt, best, "telemetry config 11")
    tel = dopt.telemetry
    label = bucket_label(4, 2, 16)
    rows = _captured_rows(tel, f"config 11 T={T} epoch 1")
    bucket_rows = [rows[(name, label)] for name in TRACED_ROWS]
    bucket_s = sum(r.device_time_s for r in bucket_rows)
    tenant = tel.ledger.tenant_device_seconds()
    tenant_s = sum(v for phases in tenant.values() for v in phases.values())
    assert len(tenant) == T, sorted(tenant)
    assert bucket_s > 0.0 and abs(tenant_s - bucket_s) <= TENANT_SECONDS_RTOL * bucket_s, (
        tenant_s, bucket_s)
    cap = tel.ledger.last_capture
    print(f"[{smi}] telemetry (c) config 11 T={T}: wall {wall:.3f} s, "
          f"device_busy_fraction {cap.device_busy_fraction:.4f}, bucket rows' device "
          f"{bucket_s * 1e3:.3f} ms, tenants' device seconds sum {tenant_s * 1e3:.3f} ms "
          f"({tenant_s / bucket_s:.4f} of it)")
    for pid in sorted(tenant, key=int)[:3]:
        print(f"  tenant {pid}: " + ", ".join(
            f"{ph} {v * 1e3:.4f} ms" for ph, v in sorted(tenant[pid].items())))
    return counts


def telemetry_phase(torch, V, smi):
    """Phase 14: telemetry on the card. Returns each run's launches."""
    import tempfile

    with tempfile.TemporaryDirectory() as profile_dir:
        quick = telemetry_quick_start(torch, V, smi, profile_dir)
        telemetry_overhead(torch, V, smi)
        bucket = telemetry_bucket(torch, V, smi, profile_dir)
    return {"quick_start": quick, "config11_T16": bucket}


# bench.py Config 12 (phase 15): T tenants of ZDT1 at dims 4-7,
# round-robin (four static buckets), pop 16, 8 generations, 2 epochs, 3
# initial points per parameter, `gpr` with 2 starts and 40 steps, seeds
# 100 + i; lockstep against the task-graph scheduler
CONFIG12_TENANTS = (16, 64)
CONFIG12_DIMS = (4, 5, 6, 7)
CONFIG12 = dict(population_size=16, num_generations=8, n_epochs=2, n_initial=3)
CONFIG12_SMK = {"n_starts": 2, "n_iter": 40, "seed": 0}
# the run's fused launches: each bucket's generation loop launches the
# offspring kernel once a generation for all its tenants
# (`tenants.run_bucket_epoch`), every tenant rides a bucket (T / 4 >= 2
# = min_bucket), and the buckets run every epoch: 4 x 2 x 8
CONFIG12_LAUNCHES = len(CONFIG12_DIMS) * CONFIG12["n_epochs"] * CONFIG12["num_generations"]
# scheduler and lockstep fronts must agree to this relative tolerance
FRONT_RTOL = 1e-5
# (c)'s fault plan: two tenants' first batches raise once at the torch
# evaluator's result layer and a third's first three rows come back
# NaN, all three in the d4 bucket (tenants 0, 4, 8; tenant 12 is their
# bucket-mate), so the other three buckets hold only clean tenants
FAULT_RAISE = ("tg_16_0", "tg_16_4")
FAULT_NAN = ("tg_16_8", 3)
FAULT_BUCKET_MATE = "tg_16_12"


def _service_submit(svc, T, i, seed_base=100, dims=CONFIG12_DIMS, **over):
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1

    dim = dims[i % len(dims)]
    kw = dict(CONFIG12, surrogate_method_kwargs=dict(CONFIG12_SMK),
              random_seed=seed_base + i)
    kw.update(over)
    return svc.submit(zdt1, {f"x{j}": [0.0, 1.0] for j in range(dim)}, ["f1", "f2"],
                      opt_id=f"tg_{T}_{i}", torch_objective=True, **kw)


def _service_run(torch, V, T, scheduler, telemetry=False, **svc_kw):
    """One Config 12 service run on the card, the launch counts reset
    just before `run()` and read just after: (wall, launches, {opt_id:
    fronts}, introspect snapshot, telemetry)."""
    from dmosopt_tpu_torch.service import OptimizationService

    svc = OptimizationService(min_bucket=2, scheduler=scheduler, telemetry=telemetry,
                              device="cuda", **svc_kw)
    handles = [_service_submit(svc, T, i) for i in range(T)]
    torch.cuda.synchronize()
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    svc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)
    fronts = {h.opt_id: h.updates() for h in handles}
    for h in handles:
        assert h.done and h.error is None, (h.opt_id, h.error)
    snap = svc.introspect()
    tel = svc.telemetry
    svc.close()
    return wall, launches, fronts, snap, tel


def _check_fronts(fronts, n_epochs, label):
    """Every tenant streamed one front an epoch, each finite and
    non-dominated."""
    import numpy as np

    for opt_id, ups in fronts.items():
        assert [u.epoch for u in ups] == list(range(n_epochs)), (label, opt_id)
        for u in ups:
            assert u.x.shape[0] == u.y.shape[0] > 0, (label, opt_id, u.epoch)
            assert np.all(np.isfinite(u.x)) and np.all(np.isfinite(u.y)), (label, opt_id)
            assert _non_dominated(u.y), (label, opt_id, u.epoch, "dominated front")


def _front_agreement(a, b, opt_ids):
    """(all bitwise, worst relative difference) of the tenants' last
    fronts; raises when a pair differs in shape or beyond FRONT_RTOL."""
    import numpy as np

    bitwise, worst = True, 0.0
    for k in opt_ids:
        ua, ub = a[k][-1], b[k][-1]
        for xa, xb in ((ua.x, ub.x), (ua.y, ub.y)):
            assert xa.shape == xb.shape, (k, xa.shape, xb.shape)
            bitwise = bitwise and np.array_equal(xa, xb)
            rel = np.abs(xa - xb) / np.maximum(np.abs(xb), 1e-30)
            worst = max(worst, float(rel.max()) if rel.size else 0.0)
    assert worst <= FRONT_RTOL, ("fronts differ", worst)
    return bitwise, worst


def config12(torch, V, smi):
    """Phase 15 (a): bench.py Config 12, lockstep against the scheduler
    at T = 16 and 64, interleaved, best of 2. Returns the launches of
    each mode's last run at each T and the T = 16 scheduler fronts."""
    from dmosopt_tpu_torch.parallel.taskgraph import resolve_concurrency

    launches, ref16 = {}, None
    for T in CONFIG12_TENANTS:
        walls = {"lockstep": [], "scheduler": []}
        fronts, snaps = {}, {}
        for _rep in range(2):
            for mode, sched in (("lockstep", None), ("scheduler", True)):
                wall, counts, fr, snap, _ = _service_run(torch, V, T, sched)
                assert counts == {"offspring": CONFIG12_LAUNCHES, "sbx": 0,
                                  "mutation": 0}, (T, mode, counts)
                assert snap["tenant_counts"] == {"completed": T}, (T, mode, snap["tenant_counts"])
                _check_fronts(fr, CONFIG12["n_epochs"], f"config 12 T={T} {mode}")
                walls[mode].append(wall)
                fronts[mode], snaps[mode] = fr, snap
                launches[f"config12_T{T}_{mode}"] = counts
        bitwise, worst = _front_agreement(fronts["scheduler"], fronts["lockstep"],
                                          sorted(fronts["lockstep"]))
        lock, sched = min(walls["lockstep"]), min(walls["scheduler"])
        nodes = snaps["scheduler"]["scheduler"]["last_graph"]["nodes"]
        kinds = {}
        for n in nodes:
            kinds[n["kind"]] = kinds.get(n["kind"], 0) + 1
        assert kinds.get("bucket") == len(CONFIG12_DIMS), kinds
        print(f"[{smi}] config 12 T={T}: lockstep {lock:.3f} s "
              f"({', '.join(f'{w:.3f}' for w in walls['lockstep'])}), scheduler "
              f"{sched:.3f} s ({', '.join(f'{w:.3f}' for w in walls['scheduler'])}) at "
              f"concurrency {resolve_concurrency(True)}; scheduler_speedup "
              f"{lock / sched:.3f}; graph nodes at the last step {len(nodes)} {kinds}; "
              f"offspring launches {CONFIG12_LAUNCHES} a run (4 buckets x 2 epochs x 8 "
              f"generations); last fronts {'bitwise equal' if bitwise else 'equal'} "
              f"(worst relative difference {worst:.3e})")
        if T == 16:
            ref16 = fronts["scheduler"]
    return launches, ref16


def _warm_profiler(torch):
    """Start and stop torch.profiler once on the card: the first start in
    a process costs seconds that are not the captured step's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (torch.ones(64, device="cuda") * 2.0).sum().item()
    torch.cuda.synchronize()


def config12_device(torch, V, smi, profile_dir):
    """Phase 15 (b): one capture of step 1 (epoch 1) at T = 64 in each
    mode. Every bucket's gp_fit and ea_scan rows must join their
    annotation windows with device time above 0 (under the scheduler the
    spans open on worker threads). Prints each mode's busy fraction and
    their ratio, ungated."""
    from dmosopt_tpu_torch.tenants import bucket_label

    _warm_profiler(torch)
    T = max(CONFIG12_TENANTS)
    labels = [bucket_label(d, 2, CONFIG12["population_size"]) for d in CONFIG12_DIMS]
    busy, launches = {}, {}
    for mode, sched in (("lockstep", None), ("scheduler", True)):
        sub = os.path.join(profile_dir, mode)
        wall, counts, fronts, snap, tel = _service_run(
            torch, V, T, sched, telemetry={"profile_dir": sub, "profile_epochs": [1]})
        assert counts == {"offspring": CONFIG12_LAUNCHES, "sbx": 0, "mutation": 0}, counts
        _check_fronts(fronts, CONFIG12["n_epochs"], f"config 12 capture {mode}")
        assert tel.ledger.captures == 1, tel.ledger.captures
        cap = tel.ledger.last_capture
        rows = _captured_rows(tel, f"config 12 T={T} {mode} step 1")
        for label in labels:
            for name in TRACED_ROWS:
                row = rows.get((name, label))
                assert row is not None and row.n_joined >= 1, (mode, name, label, row)
                assert row.device_time_s > 0.0, (mode, name, label, row)
        assert cap.device_busy_fraction is not None and 0.0 < cap.device_busy_fraction <= 1.0
        busy[mode] = cap.device_busy_fraction
        launches[f"config12_capture_{mode}"] = counts
        print(f"[{smi}] config 12 T={T} {mode} with a capture of step 1: wall {wall:.3f} s, "
              f"device_busy_fraction {cap.device_busy_fraction:.4f}, window "
              f"{cap.window_s:.3f} s, device busy {cap.device_busy_s:.4f} s, "
              f"{cap.n_joined}/{cap.n_spans} spans joined")
    print(f"[{smi}] config 12 T={T}: device_busy_fraction scheduler/lockstep "
          f"{busy['scheduler'] / busy['lockstep']:.4f}")
    return launches


def _scrape(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def service_faults(torch, V, smi, ref):
    """Phase 15 (c) and (d): Config 12 at T = 16 under the scheduler with
    a fault plan, through `FaultyEvaluator` over `TorchBatchEvaluator` on
    the card, under a skipping policy with retries; the clean buckets'
    tenants equal the fault-free scheduler run's (``ref``) within
    FRONT_RTOL; the faulty tenants report what the policy says. The same
    service serves /metrics, scraped once after its first step and held
    to the registry's snapshot, and /healthz; close() joins its thread."""
    import numpy as np

    from dmosopt_tpu_torch.service import EvalPolicy, OptimizationService
    from dmosopt_tpu_torch.telemetry.exposition import parse_openmetrics, samples_as_snapshot

    T = 16
    plan = {"seed": 11, "rules": [
        *({"kind": "raise", "target": t, "count": 1} for t in FAULT_RAISE),
        {"kind": "nan", "target": FAULT_NAN[0], "count": FAULT_NAN[1]}]}
    os.environ["DMOSOPT_FAULT_PLAN"] = json.dumps(plan)
    try:
        svc = OptimizationService(
            min_bucket=2, scheduler=True, device="cuda", exporter=True,
            eval_policy=EvalPolicy(retries=2, on_eval_failure="skip"),
        )
    finally:
        del os.environ["DMOSOPT_FAULT_PLAN"]
    handles = [_service_submit(svc, T, i) for i in range(T)]
    assert type(svc._pending[0].evaluator).__name__ == "FaultyEvaluator"
    port, thread = svc.exporter.port, svc.exporter._thread
    torch.cuda.synchronize()
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    svc.step()
    status, body = _scrape(port, "/metrics")
    snap_reg = svc.telemetry.registry.snapshot()
    assert status == 200, status
    back = samples_as_snapshot(parse_openmetrics(body))
    n_series = 0
    for name, series in snap_reg["counters"].items():
        family = name[: -len("_total")] if name.endswith("_total") else name
        assert back["counters"][family] == series, name
        n_series += len(series)
    assert back["gauges"] == snap_reg["gauges"]
    n_series += sum(len(s) for s in snap_reg["gauges"].values())
    hz_status, hz_body = _scrape(port, "/healthz")
    assert hz_status in (200, 503) and "status" in json.loads(hz_body), (hz_status, hz_body)
    svc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)
    fronts = {h.opt_id: h.updates() for h in handles}
    snap = svc.introspect()
    reg = svc.telemetry.registry
    svc.close()
    assert svc.exporter is None and not thread.is_alive(), "exporter thread left running"

    assert launches == {"offspring": CONFIG12_LAUNCHES, "sbx": 0, "mutation": 0}, launches
    assert snap["tenant_counts"] == {"completed": T}, snap["tenant_counts"]
    by_id = {t["opt_id"]: t for t in snap["tenants"]}
    for t in FAULT_RAISE:
        # a torch batch fails at the result layer, where no attempt is
        # retried: the point is skipped and the tenant goes on degraded
        assert by_id[t].get("degraded") is True and by_id[t]["eval_failures_total"] == 1, by_id[t]
        assert reg.counter_value("tenant_eval_failures_total", tenant=t) == 1.0
    nan_t, nan_n = FAULT_NAN
    assert by_id[nan_t]["points_quarantined_total"] == nan_n, by_id[nan_t]
    faulty = set(FAULT_RAISE) | {nan_t}
    _check_fronts(fronts, CONFIG12["n_epochs"], "faults")
    clean = sorted(k for k in fronts
                   if int(k.rsplit("_", 1)[1]) % len(CONFIG12_DIMS) != 0)
    bitwise, worst = _front_agreement(fronts, ref, clean)
    mate = FAULT_BUCKET_MATE
    mate_equal = (np.array_equal(fronts[mate][-1].x, ref[mate][-1].x)
                  and np.array_equal(fronts[mate][-1].y, ref[mate][-1].y))
    print(f"[{smi}] config 12 T={T} scheduler with faults: wall {wall:.3f} s; "
          f"{sorted(faulty)} report "
          + ", ".join(f"{t}: degraded {by_id[t].get('degraded')}, failures "
                      f"{by_id[t].get('eval_failures_total', 0)}, quarantined "
                      f"{by_id[t].get('points_quarantined_total', 0)}" for t in sorted(faulty))
          + f"; the {len(clean)} tenants of the clean buckets' last fronts "
          f"{'bitwise equal' if bitwise else 'equal'} to the fault-free run's (worst "
          f"relative difference {worst:.3e}); the faulty bucket's mate {FAULT_BUCKET_MATE} "
          f"{'bitwise equal' if mate_equal else 'differs (its bucket fit shares one convergence stop)'}")
    print(f"[{smi}] exporter: /metrics scraped after step 1, {n_series} counter and gauge "
          f"series equal to the registry's; /healthz {hz_status} "
          f"{json.loads(hz_body).get('status')}; thread joined on close")
    return launches


def service_wide(torch, V, smi):
    """Phase 15 (e): 16 tenants at the quick start's width (ZDT1 dim 30,
    pop 200, 100 generations, 2 epochs, `gpr` defaults) in one bucket
    under the scheduler: one fused launch a generation for the bucket."""
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1
    from dmosopt_tpu_torch.service import OptimizationService

    T, dim, gens, n_epochs = WIDE_TENANTS, 30, 100, WIDE_EPOCHS
    svc = OptimizationService(min_bucket=2, scheduler=True, device="cuda")
    handles = [
        svc.submit(zdt1, {f"x{j}": [0.0, 1.0] for j in range(dim)}, ["f1", "f2"],
                   opt_id=f"wide_{i}", torch_objective=True, n_epochs=n_epochs,
                   population_size=200, num_generations=gens, n_initial=3,
                   surrogate_method_kwargs={}, random_seed=i)
        for i in range(T)
    ]
    torch.cuda.synchronize()
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    svc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)
    reg = svc.telemetry.registry
    fronts = {h.opt_id: h.updates() for h in handles}
    assert all(h.done and h.error is None for h in handles)
    svc.close()
    assert launches == {"offspring": n_epochs * gens, "sbx": 0, "mutation": 0}, launches
    assert reg.counter_value("tenants_batched_total") == T * n_epochs
    _check_fronts(fronts, n_epochs, "wide service")
    print(f"[{smi}] service, 16 tenants at the quick start's width in one bucket under "
          f"the scheduler, {n_epochs} epochs: {wall:.3f} s, offspring launches "
          f"{launches['offspring']} ({launches['offspring'] // (n_epochs * gens)} a "
          f"generation); phase 13 (b) runs the same through run()")
    return launches


def service_phase(torch, V, smi):
    """Phase 15: the ask/tell service on the card. Returns each run's
    launches."""
    import tempfile

    launches, ref16 = config12(torch, V, smi)
    with tempfile.TemporaryDirectory() as profile_dir:
        launches.update(config12_device(torch, V, smi, profile_dir))
    launches["faults_T16"] = service_faults(torch, V, smi, ref16)
    launches["wide16"] = service_wide(torch, V, smi)
    return launches


# phase 16: AGE-MOEA buckets. (a) bench.py Config 2 (bench.py:274-333)
# as the three problems of one run, its 5/10/5 epochs cut to 3;
# (b) 16 DTLZ2 problems of the many-objective example's width
CONFIG2_EPOCHS = 3
DTLZ2_TENANTS, DTLZ2_EPOCHS = 16, 2
# the sequential comparison of (b), cut to this depth (16 tenants one
# after another at full depth would take minutes): its ms a generation
# is compared, not its wall
DTLZ2_SEQ_GENERATIONS, DTLZ2_SEQ_EPOCHS = 10, 1
DTLZ2_HV_BAR = 1.07


class _ProblemsEvaluator:
    """One batched torch objective per problem (ZDT1-3 for Config 2's
    three problems), each a `TorchBatchEvaluator` of its own: the driver
    hands an evaluator rounds of ``{problem_id: row}``."""

    def __init__(self, torch, fns):
        from dmosopt_tpu_torch.parallel.evaluator import TorchBatchEvaluator

        self.inner = {pid: TorchBatchEvaluator(fn, torch.device("cuda"), problem_ids=[pid])
                      for pid, fn in fns.items()}

    def evaluate_batch(self, space_vals_list):
        results = [dict() for _ in space_vals_list]
        for pid, ev in self.inner.items():
            idx = [i for i, sv in enumerate(space_vals_list) if pid in sv]
            if idx:
                out = ev.evaluate_batch([{pid: space_vals_list[i][pid]} for i in idx])
                for i, o in zip(idx, out):
                    results[i][pid] = o[pid]
                    results[i]["time"] = o["time"]
        return results


def config2_buckets(torch, V, smi):
    """Phase 16 (a): bench.py Config 2's ZDT1, ZDT2 and ZDT3 (dim 30,
    AGE-MOEA, pop 100, 100 generations, 8 initial points per parameter,
    resample 0.25, `gpr` with 4 starts and 100 steps, seed 42) as the
    three problems of one run with ``tenant_batching=True``."""
    import numpy as np

    from dmosopt_tpu_torch.benchmarks.zdt import (
        distance_to_front, zdt1, zdt1_pareto, zdt2, zdt2_pareto, zdt3, zdt3_pareto,
    )

    fns = {0: zdt1, 1: zdt2, 2: zdt3}
    fronts = {0: zdt1_pareto(500), 1: zdt2_pareto(500), 2: zdt3_pareto(500)}
    dim, gens = 30, 100
    params = config11_params(
        "config2_age", 3, problem_ids={0, 1, 2}, obj_fun=zdt1,
        evaluator=_ProblemsEvaluator(torch, fns),
        space={f"x{i:02d}": [0.0, 1.0] for i in range(dim)}, n_initial=8,
        n_epochs=CONFIG2_EPOCHS, population_size=100, num_generations=gens,
        resample_fraction=0.25, optimizer_name="age",
        surrogate_method_kwargs={"n_starts": 4, "n_iter": 100, "seed": 0},
        random_seed=42,
    )
    wall, launches, dopt, best = _tenant_run(torch, V, params)
    routes = [set(s["routing"].values()) for s in dopt.epoch_stats]
    assert routes == [{"batched"}] * CONFIG2_EPOCHS, routes
    assert launches == {"offspring": CONFIG2_EPOCHS * gens, "sbx": 0, "mutation": 0}, launches
    archives = _check_tenants(dopt, best, "config 2")
    n0 = 8 * dim
    within = {}
    for pid, (_, y_all, y) in archives.items():
        d_best = float(np.median(distance_to_front(y, fronts[pid])))
        d_init = float(np.median(distance_to_front(y_all[:n0], fronts[pid])))
        assert d_best < d_init, (pid, d_best, d_init)
        within[pid] = int((distance_to_front(y, fronts[pid]) < 0.05).sum())
        print(f"[{smi}] config 2 zdt{pid + 1}: {y.shape[0]} returned, median distance "
              f"to the front {d_best:.4f} (initial design {d_init:.4f}), "
              f"within_0.05 {within[pid]}")
    for s in dopt.epoch_stats:
        p0 = s["problems"][0]
        print(f"[{smi}] config 2 epoch {s['epoch']}: {s['epoch_s']:.3f} s, bucket fit "
              f"{3 * p0['cost_fit_seconds']:.3f} s ({p0['objective']['n_steps']} Adam "
              f"steps), bucket EA {3 * p0['cost_ea_seconds']:.3f} s "
              f"({1e3 * 3 * p0['cost_ea_seconds'] / gens:.2f} ms a generation)")
    print(f"[{smi}] config 2 (3 AGE-MOEA problems, one bucket, {CONFIG2_EPOCHS} epochs): "
          f"{wall:.3f} s, offspring launches {launches['offspring']} (one a generation "
          f"for the bucket); within_0.05 zdt1 {within[0]}, zdt2 {within[1]}")
    return launches


def _dtlz2_params(opt_id, **over):
    from dmosopt_tpu_torch.benchmarks.moo_benchmarks import (
        generate_problem_space, get_problem,
    )

    n_obj = 5
    params = {
        "opt_id": opt_id, "obj_fun": get_problem("dtlz2", n_obj), "torch_objective": True,
        "problem_parameters": {}, "space": generate_problem_space("dtlz2", n_obj),
        "objective_names": [f"f{i + 1}" for i in range(n_obj)],
        "population_size": 100, "num_generations": 100, "optimizer_name": "age",
        "surrogate_method_name": "gpr", "n_initial": 5, "n_epochs": DTLZ2_EPOCHS,
        "resample_fraction": 0.5, "random_seed": 7,
        "problem_ids": set(range(DTLZ2_TENANTS)), "tenant_batching": True,
    }
    params.update(over)
    return params


def _resample_hv_ratio(dopt, random_sets):
    """Median over the tenants of the resampled rows' exact hypervolume
    (reference 2.5 per objective) over the median of as many rows of
    each random set."""
    import numpy as np

    from dmosopt_tpu_torch.hv import hypervolume_exact

    ref = np.full(5, 2.5)
    n0 = 5 * 14
    ratios = []
    for pid in sorted(dopt.problem_ids):
        _, y_all = dopt.optimizer_dict[pid].get_evals()
        k = y_all.shape[0] - n0
        hv_random = [hypervolume_exact(r[:k], ref) for r in random_sets]
        ratios.append(hypervolume_exact(y_all[n0:], ref) / np.median(hv_random))
    return float(np.median(ratios)), ratios


def dtlz2_buckets(torch, V, smi):
    """Phase 16 (b): 16 DTLZ2 problems (5 objectives, 14 parameters, a
    batched torch objective; AGE-MOEA, pop 100, 100 generations, no
    termination, 2 epochs) in one bucket, against the same problems
    without batching at a cut depth, and against a bucket whose survival
    keeps random survivors, which must fail the hypervolume gate."""
    import numpy as np

    from dmosopt_tpu_torch.benchmarks.moo_benchmarks import get_problem
    from dmosopt_tpu_torch.optimizers import agemoea

    gens, T = 100, DTLZ2_TENANTS
    wall, launches, dopt, best = _tenant_run(torch, V, _dtlz2_params("dtlz2_bucket"))
    routes = [set(s["routing"].values()) for s in dopt.epoch_stats]
    assert routes == [{"batched"}] * DTLZ2_EPOCHS, routes
    assert launches == {"offspring": DTLZ2_EPOCHS * gens, "sbx": 0, "mutation": 0}, launches
    _check_tenants(dopt, best, "dtlz2 bucket")
    # 20 seeded sets of random points, drawn and evaluated on the card;
    # a tenant is compared with as many of each set's rows as it resampled
    n_res = int(100 * 0.5) * (DTLZ2_EPOCHS - 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    f = get_problem("dtlz2", 5)
    random_sets = [f(torch.rand(n_res, 14, generator=gen, device="cuda")).cpu().numpy()
                   for _ in range(20)]
    ratio, ratios = _resample_hv_ratio(dopt, random_sets)
    bucket_ms = 1e3 * sum(T * s["problems"][0]["cost_ea_seconds"]
                          for s in dopt.epoch_stats) / (DTLZ2_EPOCHS * gens)

    # the mutated copy: survival keeps random rows (the valid ones first)
    orig = agemoea.environmental_selection

    def random_survivors(x, y, pop, x_keys=None, mask=None):
        perm, rank, crowd = orig(x, y, pop, x_keys=x_keys, mask=mask)
        key = torch.where(crowd > -torch.inf, torch.rand(crowd.shape, device=crowd.device), 2.0)
        return torch.argsort(key, dim=-1), rank, crowd

    agemoea.environmental_selection = random_survivors
    try:
        _, _, dopt_bad, _ = _tenant_run(torch, V, _dtlz2_params("dtlz2_random_survivors"))
    finally:
        agemoea.environmental_selection = orig
    ratio_bad, _ = _resample_hv_ratio(dopt_bad, random_sets)

    seq_wall, seq_launches, dopt_seq, _ = _tenant_run(torch, V, _dtlz2_params(
        "dtlz2_sequential", tenant_batching=False, num_generations=DTLZ2_SEQ_GENERATIONS,
        n_epochs=DTLZ2_SEQ_EPOCHS))
    assert seq_launches["offspring"] == T * DTLZ2_SEQ_EPOCHS * DTLZ2_SEQ_GENERATIONS, seq_launches
    seq_ms = [1e3 * p["optimize_s"] / p["n_generations"]
              for s in dopt_seq.epoch_stats for p in s["problems"].values()]
    print(f"[{smi}] {T} DTLZ2 problems, AGE-MOEA, one bucket, {DTLZ2_EPOCHS} epochs: "
          f"{wall:.3f} s, offspring launches {launches['offspring']}, bucket "
          f"{bucket_ms:.2f} ms a generation for {T} tenants; sequential "
          f"(tenant_batching=False), its depth cut to {DTLZ2_SEQ_EPOCHS} epoch of "
          f"{DTLZ2_SEQ_GENERATIONS} generations against the bucket's {DTLZ2_EPOCHS} "
          f"of {gens}, so only ms a generation compare: {seq_wall:.3f} s, one tenant "
          f"{np.median(seq_ms):.2f} ms a generation (median of {T}; {T} tenants "
          f"{T * np.median(seq_ms):.2f} ms), {seq_launches['offspring']} launches")
    print(f"[{smi}] {T} DTLZ2 problems: resamples' hypervolume over the random sets' "
          f"median, median over the tenants {ratio:.4f} (per tenant "
          f"{min(ratios):.4f}-{max(ratios):.4f}; bar {DTLZ2_HV_BAR}); the "
          f"random-survivor bucket {ratio_bad:.4f}")
    assert ratio >= DTLZ2_HV_BAR, (ratio, DTLZ2_HV_BAR)
    assert ratio_bad < DTLZ2_HV_BAR, ("the gate passes random survivors", ratio_bad)
    return launches, seq_launches


def age_buckets(torch, V, smi):
    """Phase 16: AGE-MOEA buckets at full width. Returns each run's
    launches."""
    out = {"config2": config2_buckets(torch, V, smi)}
    out["dtlz2_bucket"], out["dtlz2_sequential"] = dtlz2_buckets(torch, V, smi)
    return out


# phase 17: the mesh on one card. (b) is bench.py Config 10's
# real-device cell (bench.py:1340-1434) at one device
CONFIG10_N, CONFIG10_ITERS = 8192, 8
QUICK_MESH_MIN_POINTS = 64


def mesh_quick_start(torch, V, smi):
    """Phase 17 (a): the quick start through run(mesh=create_mesh(1)) on
    a one-process NCCL group, with the row-sharded fit routed
    (``surrogate_mesh`` from QUICK_MESH_MIN_POINTS rows). At world size 1
    every collective returns its operand, so no NCCL collective runs,
    and the generation loop keeps the blocked single-device rank."""
    import numpy as np

    from dmosopt_tpu_torch.benchmarks.zdt import distance_to_front, zdt1_pareto
    from dmosopt_tpu_torch.parallel.mesh import create_mesh, initialize_distributed

    dim, pop, gens, n_initial, n_epochs = QUICK_START
    initialize_distributed()  # device None: this card, an NCCL group
    mesh = create_mesh(1)
    params = quick_start_params(
        "zdt1_quick_start_mesh", mesh=mesh,
        surrogate_method_kwargs={"surrogate_mesh": {"min_points": QUICK_MESH_MIN_POINTS}})
    wall, launches, dopt, best = _tenant_run(torch, V, params)
    n_gen = sum(s["n_generations"] for s in dopt.epoch_stats)
    assert n_gen == n_epochs * gens and launches == {"offspring": n_gen, "sbx": 0,
                                                     "mutation": 0}, launches
    assert all(s["objective"].get("sharded") is True for s in dopt.epoch_stats), \
        dopt.epoch_stats
    reg = dopt.telemetry.registry
    assert reg.counter_value("gp_shard_fits_total") == n_epochs
    assert reg.counter_value("gp_shard_fallbacks_total") == 0
    x_all, y_all = dopt.optimizer_dict[0].get_evals()
    n0 = n_initial * dim
    _check_archive(x_all, y_all, dopt.eval_count, "mesh quick start")
    y = np.column_stack([v for _, v in best[1]])
    assert y.shape[0] > 0 and np.all(np.isfinite(y)) and _non_dominated(y)
    front = zdt1_pareto(1000)
    d_best = float(np.median(distance_to_front(y, front)))
    d_init = float(np.median(distance_to_front(y_all[:n0], front)))
    assert d_best < d_init, (d_best, d_init)
    for s in dopt.epoch_stats:
        print(f"[{smi}] mesh quick start epoch {s['epoch']}: {s['epoch_s']:.3f} s, "
              f"sharded GP fit {s['train_s']:.3f} s ({s['objective']['n_steps']} Adam "
              f"steps, tile {s['objective']['shard_tile']}), EA {s['optimize_s']:.3f} s")
    print(f"[{smi}] mesh quick start (world size 1, an NCCL group; no collective "
          f"runs at one rank): {wall:.3f} s, sharded fits "
          f"{reg.counter_value('gp_shard_fits_total'):g}, offspring launches "
          f"{launches['offspring']}; median distance to the front {d_best:.4f} "
          f"(initial design {d_init:.4f})")
    return launches, mesh


def config10(torch, V, smi, mesh):
    """Phase 17 (b): bench.py Config 10 at N = 8192 (dim 8, one
    objective, 2 starts, CONFIG10_ITERS Adam steps, no convergence
    stop): `fit_gp_sharded` on the one-device mesh against
    `fit_gp_batch`, each timed after a warm-up call."""
    import numpy as np

    from dmosopt_tpu_torch.models import gp, gp_sharded

    N = CONFIG10_N
    rng = np.random.default_rng(0)
    Xh = rng.uniform(size=(N, 8)).astype(np.float32)
    y = np.sin(3.0 * Xh[:, 0]) + Xh.sum(1)
    X = torch.as_tensor(Xh, device="cuda")
    Y = torch.as_tensor(((y - y.mean()) / y.std())[:, None].astype(np.float32), device="cuda")
    kw = dict(n_starts=2, n_iter=CONFIG10_ITERS, convergence_tol=None)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    sharded, t_sh = timed(lambda: gp_sharded.fit_gp_sharded(
        torch.Generator(device="cuda").manual_seed(1), X, Y, mesh=mesh, **kw))
    single, t_one = timed(lambda: gp.fit_gp_batch(
        torch.Generator(device="cuda").manual_seed(1), X, Y, **kw))
    Xq = torch.as_tensor(rng.uniform(size=(128, 8)).astype(np.float32), device="cuda")
    (m1, v1), (m0, v0) = gp.gp_predict(sharded, Xq), gp.gp_predict(single, Xq)
    mean_err = float((m1 - m0).abs().max())
    n1, n0 = float(sharded.nmll[0]), float(single.nmll[0])
    print(f"[{smi}] config 10 N={N} (one device, tile "
          f"{gp_sharded.default_chol_tile(N)}, {CONFIG10_ITERS} Adam steps x 2 starts): "
          f"sharded fit {t_sh:.3f} s, fit_gp_batch {t_one:.3f} s; NMLL {n1:.3f} against "
          f"{n0:.3f}; 128-query mean max error {mean_err:.3e}")
    assert abs(n1 - n0) <= 5e-3 + 5e-3 * abs(n0), (n1, n0)
    assert mean_err <= 2e-2, mean_err
    np.testing.assert_allclose(v1.cpu().numpy(), v0.cpu().numpy(), rtol=0.35, atol=1e-4)
    return t_sh, t_one


def two_ranks(torch, smi):
    """Phase 17 (c): two ranks on the one card over gloo (NCCL refuses
    two ranks on one device), through the port's loopback cluster: the
    sharded rank of 16 384 rows x 3 objectives bitwise equal to the
    single-device rank, the sharded fit at 2048 rows within tolerance of
    `fit_gp_batch`."""
    import tempfile

    from dmosopt_tpu_torch.parallel.loopback import launch_loopback_cluster
    from dmosopt_tpu_torch.testing import multihost

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "two_ranks.json")
        t0 = time.perf_counter()
        results = launch_loopback_cluster(multihost.__file__, n_processes=2, timeout=600,
                                          extra_args=("chip", path))
        wall = time.perf_counter() - t0
        for rc, out in results:
            assert rc == 0 and "MULTIHOST_OK" in out, out[-4000:]
        with open(path) as f:
            rec = json.load(f)
    assert rec["rank_equal"], rec
    n1, n0 = rec["nmll_sharded"], rec["nmll_single"]
    assert abs(n1 - n0) <= 5e-3 + 5e-3 * abs(n0), rec
    assert rec["mean_max_abs_err"] <= 2e-2, rec
    print(f"[{smi}] two ranks on one card over gloo ({wall:.1f} s with start-up): sharded "
          f"rank of {rec['rank_rows']} x 3 bitwise equal to the single-device rank "
          f"({rec['rank_fronts']} fronts, {rec['sharded_rank_s']:.3f} s); sharded fit at "
          f"{rec['fit_rows']} rows {rec['sharded_fit_s']:.3f} s, NMLL {n1:.4f} against "
          f"{n0:.4f}, 128-query mean max error {rec['mean_max_abs_err']:.3e}")
    return rec


def mesh_phase(torch, V, smi):
    """Phase 17: the mesh on one card. Returns the quick start's launches."""
    import torch.distributed as dist

    try:
        launches, mesh = mesh_quick_start(torch, V, smi)
        config10(torch, V, smi, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    two_ranks(torch, smi)
    return {"mesh_quick_start": launches}


# phase 18: the runner, the shim and the CLI. (a) runs the runner's tier 1
# at its defaults and tier 3's MaF2 at 15 objectives, whose hypervolume
# the runner estimates by FPRAS on the card; (b) the quick start through
# the `dmosopt` shim, cut to SHIM_EPOCHS epochs; (c) the CLI's `status`
# in a subprocess on a service's status file
RUNNER_FPRAS = ("maf2", 15)
SHIM_EPOCHS = 2
STATUS_TENANTS, STATUS_STEPS = 2, 2


def runner_tiers(torch, V, smi):
    """Phase 18 (a): `BenchmarkRunner(device=None).run_tier(1)` at its
    defaults (DTLZ2, DTLZ1, DTLZ7 at 3 objectives, MaF2 at 5; AGE-MOEA,
    pop 64, 50 generations, 4 epochs, `gpr` with 4 starts and 100
    steps), then MaF2 at 15 objectives, each with the counts reset just
    before it and read just after: the fused kernel once a generation
    the epochs report and the standalone ones never, every exact
    trajectory monotone, and MaF2 at 15 objectives estimated by FPRAS on
    the card within three times the sum of the two half-widths of the
    port's CPU estimate of the same archive."""
    import tempfile

    from dmosopt_tpu_torch.benchmarks import runner as R
    from dmosopt_tpu_torch.driver import dopt_dict

    engines = []

    class RecordingHyperVolume(R.AdaptiveHyperVolume):
        """The runner's engine, kept to read its reference point."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            engines.append(self)

    plain = R.AdaptiveHyperVolume
    R.AdaptiveHyperVolume = RecordingHyperVolume
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            runner = R.BenchmarkRunner(output_dir=tmp)  # device None: the card
            problems = list(runner.TIERS[1])
            torch.cuda.synchronize()
            V.reset_kernel_launches()
            t0 = time.perf_counter()
            results = runner.run_tier(1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out["tier1"] = dict(V.KERNEL_LAUNCHES)
            V.reset_kernel_launches()
            t1 = time.perf_counter()
            results.append(runner.run_single_benchmark(*RUNNER_FPRAS))
            torch.cuda.synchronize()
            wall_fpras = time.perf_counter() - t1
            out["maf2_m15"] = dict(V.KERNEL_LAUNCHES)
            runner.save_summary()
            assert len(os.listdir(tmp)) == len(problems) + 2  # results + summary
    finally:
        R.AdaptiveHyperVolume = plain
    problems.append(RUNNER_FPRAS)

    gens = {}
    for (name, n_obj), res in zip(problems, results):
        dopt = dopt_dict[f"{name}_m{n_obj}"]
        gens[name, n_obj] = sum(s["n_generations"] for s in dopt.epoch_stats)
        assert len(res.hv_trajectory) == res.final_epoch == 4, res
        assert res.termination_reason == "epoch_budget", res
        assert all(v > 0 for v in res.hv_trajectory), res.hv_trajectory
        if res.hv_method == "exact":
            traj = res.hv_trajectory
            assert all(b >= a for a, b in zip(traj, traj[1:])), (name, traj)
        print(f"[{smi}] runner {name} m{n_obj} (n_var {res.n_variables}): "
              f"{res.computation_time_seconds:.3f} s, final_hv {res.final_hv!r}, "
              f"hv_method {res.hv_method}, hv_ci {res.hv_ci!r}, {gens[name, n_obj]} "
              f"generations, archive {res.n_archive}; trajectory {res.hv_trajectory}")
    n_tier1 = sum(gens[p] for p in problems[:-1])
    assert out["tier1"] == {"offspring": n_tier1, "sbx": 0, "mutation": 0}, out
    assert out["maf2_m15"] == {"offspring": gens[RUNNER_FPRAS], "sbx": 0,
                               "mutation": 0}, out
    assert [r.hv_method for r in results] == ["exact"] * 4 + ["fpras"], results

    # the 15-objective archive's hypervolume, estimated again on the CPU
    res = results[-1]
    y = dopt_dict["maf2_m15"].optimizer_dict[0].y
    ref = engines[-1].ref_point
    cpu = plain(ref, epsilon=0.05, device="cpu")
    t2 = time.perf_counter()
    est, ci = map(float, cpu.compute_hypervolume_with_confidence(y))
    cpu_s = time.perf_counter() - t2
    assert cpu.last_method == "fpras" and res.hv_ci > 0 and ci > 0
    gap = abs(res.final_hv - est)
    print(f"[{smi}] runner maf2 m15: the card's FPRAS {res.final_hv!r} (ci {res.hv_ci!r}, "
          f"{engines[-1].last_n_samples} samples) against the CPU's {est!r} (ci {ci!r}, "
          f"{cpu.last_n_samples} samples, {cpu_s:.3f} s) on the archive's "
          f"{y.shape[0]} rows: gap {gap!r}, bar {3.0 * (res.hv_ci + ci)!r}")
    assert gap <= 3.0 * (res.hv_ci + ci), (res.final_hv, est, res.hv_ci, ci)
    print(f"[{smi}] runner tier 1 (4 problems, AGE-MOEA, pop 64, 50 generations, 4 "
          f"epochs): {wall:.3f} s, offspring launches {out['tier1']['offspring']} for "
          f"{n_tier1} generations; maf2 m15 {wall_fpras:.3f} s, "
          f"{out['maf2_m15']['offspring']} launches for {gens[RUNNER_FPRAS]} generations")
    return out


def shim_quick_start(torch, V, smi):
    """Phase 18 (b): the quick start's dict through the `dmosopt` shim,
    cut to SHIM_EPOCHS epochs, with phase 4's checks."""
    from dmosopt_tpu_torch import dmosopt, driver

    assert dmosopt.dopt_dict is driver.dopt_dict and dmosopt.run is driver.run
    params = quick_start_params("zdt1_shim", n_epochs=SHIM_EPOCHS)
    torch.cuda.synchronize()
    V.reset_kernel_launches()
    t0 = time.perf_counter()
    best = dmosopt.run(params, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(V.KERNEL_LAUNCHES)
    _check_quick_start(dmosopt.dopt_dict["zdt1_shim"], best, launches, SHIM_EPOCHS,
                       "shim quick start")
    print(f"[{smi}] dmosopt shim quick start ({SHIM_EPOCHS} epochs): {wall:.3f} s, "
          f"offspring launches {launches['offspring']}")
    return launches


def cli_status(torch, V, smi):
    """Phase 18 (c): a service on the card with a status file and no
    checkpoint steps STATUS_TENANTS ZDT1 tenants STATUS_STEPS times; the
    CLI's `status` renders the file in a subprocess, which loads no
    click (the machine has none)."""
    import tempfile

    from dmosopt_tpu_torch.benchmarks.zdt import zdt1
    from dmosopt_tpu_torch.service import OptimizationService

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "status.json")
        svc = OptimizationService(status_path=path, device="cuda")
        for i in range(STATUS_TENANTS):
            svc.submit(zdt1, {f"x{j}": [0.0, 1.0] for j in range(4)}, ["f1", "f2"],
                       opt_id=f"status_{i}", torch_objective=True, n_epochs=4,
                       population_size=16, num_generations=8, n_initial=3,
                       surrogate_method_kwargs={"n_starts": 2, "n_iter": 40, "seed": 0},
                       random_seed=i)
        torch.cuda.synchronize()
        V.reset_kernel_launches()
        for _ in range(STATUS_STEPS):
            svc.step()
        torch.cuda.synchronize()
        launches = dict(V.KERNEL_LAUNCHES)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        runs = [subprocess.run([sys.executable, "-m", "dmosopt_tpu_torch.cli", "status",
                                "-p", path, *extra], capture_output=True, text=True,
                               timeout=120, env=env)
                for extra in (["--as-json"], [])]
        svc.close()
    for r in runs:
        assert r.returncode == 0, r.stdout + r.stderr
    snap = json.loads(runs[0].stdout)
    epochs = {t["opt_id"]: t["epoch"] for t in snap["tenants"]}
    assert epochs == {f"status_{i}": STATUS_STEPS for i in range(STATUS_TENANTS)}, epochs
    assert snap["steps"] == STATUS_STEPS and snap["checkpoint_path"] is None
    for i in range(STATUS_TENANTS):
        assert f"status_{i}" in runs[1].stdout
    # one bucket of both tenants: one launch a generation for the bucket
    assert launches == {"offspring": STATUS_STEPS * 8, "sbx": 0, "mutation": 0}, launches
    print(runs[1].stdout.rstrip())
    print(f"[{smi}] cli status (python -m dmosopt_tpu_torch.cli, no click): exit 0, "
          f"tenants at epochs {epochs}, offspring launches {launches['offspring']}")
    return launches


def runner_phase(torch, V, smi):
    """Phase 18: the runner, the shim and the CLI. Returns each run's
    launches."""
    import importlib.util

    out = runner_tiers(torch, V, smi)
    out["shim_quick_start"] = shim_quick_start(torch, V, smi)
    out["cli_status_service"] = cli_status(torch, V, smi)
    print(f"[{smi}] not run on this machine: the fleet (its workers checkpoint to "
          f"HDF5), the fleet rollup and the CLI's analyze, train, onestep, telemetry "
          f"and fleet (they read HDF5 stores); h5py importable: "
          f"{importlib.util.find_spec('h5py') is not None}. The CPU tests hold them "
          f"(tests/test_torch_fleet.py, tests/test_torch_cli.py).")
    return out


def _requested_phases(argv):
    """The phases of ``--phases 2,9,10``, or None for the whole script."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: python3 chip_smoke.py [--phases 2,9,10]")
    return {int(p) for p in argv[1].split(",")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dmosopt_tpu_torch.ops import variation as V

    smi = _smi_line()
    print(smi)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"TF32 off for float32 matmul"
    )

    phases = _requested_phases(sys.argv[1:])
    if phases is not None:
        # a partial run (``--phases 2,9``): the named phases' checks only,
        # with no kernels line and no result line
        runs = {2: check_kernels, 3: direct_ea, 4: quick_start, 5: file_backed,
                6: many_objective, 7: lorenz_run, 8: config5_loop,
                9: constrained_run, 10: sa_run, 11: reusing_surrogate,
                12: sparse_surrogates, 13: tenant_core, 14: telemetry_phase,
                15: service_phase, 16: age_buckets, 17: mesh_phase,
                18: runner_phase}
        for p in sorted(phases):
            t0 = time.perf_counter()
            fn = runs[p]
            fn(torch, V) if p <= 4 else fn(torch, V, smi)
            print(f"[{smi}] phase {p} {time.perf_counter() - t0:.1f} s")
        print(f"partial run of phases {sorted(phases)} passed")
        return 0

    t0 = time.perf_counter()
    report = check_kernels(torch, V)
    print(f"kernels built and checked in {time.perf_counter() - t0:.1f} s")
    direct_ea(torch, V)
    launches = quick_start(torch, V)
    launches_file = file_backed(torch, V, smi)
    launches_many = many_objective(torch, V, smi)
    t0 = time.perf_counter()
    launches_lorenz = lorenz_run(torch, V, smi)
    t1 = time.perf_counter()
    config5_loop(torch, V, smi)
    t2 = time.perf_counter()
    launches_constrained = constrained_run(torch, V, smi)
    t3 = time.perf_counter()
    launches_sa = sa_run(torch, V, smi)
    t4 = time.perf_counter()
    launches_refit = reusing_surrogate(torch, V, smi)
    t5 = time.perf_counter()
    launches_sparse = sparse_surrogates(torch, V, smi)
    t6 = time.perf_counter()
    launches_tenants = tenant_core(torch, V, smi)
    t7 = time.perf_counter()
    launches_telemetry = telemetry_phase(torch, V, smi)
    t8 = time.perf_counter()
    launches_service = service_phase(torch, V, smi)
    t9 = time.perf_counter()
    launches_age = age_buckets(torch, V, smi)
    t10 = time.perf_counter()
    launches_mesh = mesh_phase(torch, V, smi)
    t11 = time.perf_counter()
    launches_runner = runner_phase(torch, V, smi)
    t12 = time.perf_counter()
    print(f"[{smi}] phase 7 {t1 - t0:.1f} s, phase 8 {t2 - t1:.1f} s, phase 9 "
          f"{t3 - t2:.1f} s, phase 10 {t4 - t3:.1f} s, phase 11 {t5 - t4:.1f} s, "
          f"phase 12 {t6 - t5:.1f} s, phase 13 {t7 - t6:.1f} s, phase 14 {t8 - t7:.1f} s, "
          f"phase 15 {t9 - t8:.1f} s, phase 16 {t10 - t9:.1f} s, phase 17 "
          f"{t11 - t10:.1f} s, phase 18 {t12 - t11:.1f} s")
    assert "jax" not in sys.modules and "dmosopt_tpu" not in sys.modules

    kernels = []
    for name, rep in report.items():
        # the top-level numbers are at the shape of the kernel's driven
        # path: the Lorenz run's for the mutation kernel (its largest),
        # the constrained run's children call for SBX (its only one), the
        # quick start's for the fused step
        top = {"mutation": "lorenz", "sbx": "children"}.get(name, "main")
        main_row = rep["rows"][top]
        kernels.append({
            "name": rep["name"], "route": rep["route"], "source": rep["source"],
            "replaces": rep["replaces"], "launches": launches[name],
            "launches_file_run": launches_file[name],
            "launches_many_objective_run": launches_many[name],
            "launches_lorenz_run": launches_lorenz[name],
            "launches_constrained_run": launches_constrained[name],
            "launches_sa_run": launches_sa[name],
            "launches_refit_runs": {m: n[name] for m, n in launches_refit.items()},
            "launches_sparse_runs": {m: n[name] for m, n in launches_sparse.items()},
            "launches_tenant_runs": {m: n[name] for m, n in launches_tenants.items()},
            "launches_telemetry_runs": {m: n[name] for m, n in launches_telemetry.items()},
            "launches_service_runs": {m: n[name] for m, n in launches_service.items()},
            "launches_age_bucket_runs": {m: n[name] for m, n in launches_age.items()},
            "launches_mesh_runs": {m: n[name] for m, n in launches_mesh.items()},
            "launches_runner_runs": {m: n[name] for m, n in launches_runner.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rep["rows"].values()),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None, "shape": main_row["shape"],
            "host_ms": main_row["host_ms"], "plain_host_ms": main_row["plain_host_ms"],
            "large": rep["rows"]["large"],
            **{k: rep["rows"][k] for k in ("main", "direct", "file", "many_objective",
                                           "constrained", "sa", "children", "runner",
                                           "runner_dtlz1", "runner_dtlz7",
                                           "runner_maf2_m5", "runner_m15",
                                           *BUCKET_SHAPES)
               if k in rep["rows"] and k != top},
            **({"also_replaces": rep["also_replaces"]} if "also_replaces" in rep else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
