"""Drive the PyTorch port's GPR serving, training and prediction paths, CVI,
SDE variational inference, the natural-gradient family and multi-output
GPR once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. device: a CUDA card must be present (no CPU fallback); print its name and
   power limit as nvidia-smi reports them;
2. build the CUDA kernels from the sources in the checkout (one nvcc unit
   per kernel family, dtype and state dim 1..6, one per (dtype, d, o) of
   the filters and one of the Koopman backwards at o x o sites, and one per
   family and dtype for d = 7..12, compiled in parallel);
3. hold each of the seven kernels against its plain PyTorch version on the
   card: N = 4099 and N = 1e6 with batch () and (3,), d in {1, 2, 3}
   (Matern12/32/52), float64 and float32, plus one masked case; the uniform
   kernels on a uniform grid, the general ones (filter, smoother scan,
   filter scan, general Koopman backward) on a jittered grid.  Then the
   same at d = 7..12 (Sums of Matern kernels, the d = 7..12 kernels of
   csrc/wide_scan.cuh and csrc/general_adjoint.cuh): float64 at N = 4099,
   batch (3,), and float32 at d = 9, N = 1e5 (the uniform Koopman backward
   takes d <= 6 only); and the shapes of the multi-level scan of the warp
   totals, in float64: d = 9 at N = 1e5 (2,084 totals, five levels) and at
   N = 50 (seven totals: a full and a partial group), d = 7 and d = 12 with
   batch (3,) and a mask; then the chunk edges of the staged passes (d = 9
   at N = 1, 5, 9, 47, 50 in float64 and float32; d = 12 at N = 50 in
   float64, batch (3,)) and the filter scan on random prebuilt elements
   (nonzero A and J at step 0; d = 7, 9, 12, float64); then the general
   filter and the general Koopman backward at d = 1, 2, 3, 6 (a Sum of two
   Matern52 at d = 6), N in EDGE_NS (the edges of a thread's run of steps,
   of a warp's and of a block's at d <= 2: 1, 7, 8, 9, 255, 256, 257, 2047,
   2048, 2049, 4099), batch (3,), a mask and GPR's stride-0 emission row
   and lam, in float64 and float32; and beside them, at the same N, batch
   and dtypes, the uniform filter at d = 1, 2, 3, 6 with a mask and GPR's
   stride-0 lam, the uniform smoother and Koopman backward (the latter with
   and without the site gradients) on the same problems, the filter scan
   on random prebuilt elements at d = 1, 2, 3, 4, 6 (d = 4 above its
   staged tile), and the smoother scan at d = 1..6 (d = 5, 6 above its
   staged tile) on the general problems' RTS elements and on random
   prebuilt elements; and at the same N the general filter at o x o
   sites, o = 2..d for d = 2..6 (multi_output_problem: identity emission
   rows, H and lam per step with a mask (the element form), or stride 0
   (the rank-o route) with a mask and without; float32 on benign sites,
   by check_f32_wide's rule), and in float64 at o = d = 2 on the
   natural-gradient inversion's indefinite sites (natgrad_filter_problem);
   and kernels 1, 3 and 7 (and 4 beside them) at o x o sites, o = 2..d for
   d = 2..6, N in O_EDGE_NS, batch (3,), per-step sites with a mask and a
   random dense H, scaled to the states' spread and not, and GPR's
   stride-0 H and lam with a mask and without, float64 and float32
   (multi_output_kernels, O_KERNEL_SITES), kernel 3 with and without the
   site gradients and gHc (ADJ_ASKS) and kernel 7 with all six outputs and
   GPR's three (both without any observation term: their lean pass 3);
   and kernels 4 and 7 at o = 2..12 above d = 6 (csrc/wide_info.cuh) at
   O_WIDE's (d, o), N in CHUNK_EDGES, on the same sites, and kernel 4 at
   o = d = 9 on the inversion's indefinite sites, and at o = d = 7, 9, 12
   at N in NATGRAD_WIDE_NS;
4. the slice at full size, T = 1e6, float32, flagship GPR (Matern32(0.5,
   1.0), noise Cholesky 0.2), each path with the launch counters set to 0
   just before it and read just after:
   a. serving on a uniform grid: loss() three times and
      posterior_marginals() twice (filter and smoother kernels), against
      float64 and against the sequential numpy oracle at N = 500;
   b. training on a uniform grid: 5 Adam steps of training.fit (one filter
      and one adjoint launch a step), decreasing losses, float32 gradients
      against float64, and float64 gradients at N = 500 against central
      finite differences of the numpy oracle's log-likelihood;
   c. an irregular grid (linspace(0, 100, T) jittered by up to 0.4 of the
      spacing): loss(), posterior_marginals() and 5 fit steps through the
      general filter, the smoother scan (marginals) and the general Koopman
      backward (one launch a step), against float64, and at N = 500 against
      the numpy oracle (value, marginals, finite-difference gradients);
   d. the composite model (bench.py's d9 config: Matern52(0.5, 1) +
      Matern52(2, 0.5) + Matern52(8, 0.25), state dim 9, noise Cholesky
      0.2) at T = 1e5, float32: serving on a uniform grid (loss() through
      the general filter, as the JAX package routes d > 6;
      posterior_marginals() through the uniform filter and smoother), 5
      fit steps (general filter, general Koopman backward), and
      loss().backward() and posterior_marginals() on the jittered grid;
      float32 against float64 (kernel path and plain path) within the
      measured d9 bounds, and at N = 500 float64 against the numpy oracle
      and central differences;
   e. the ops filter API on the jittered grid (the flagship at T = 1e6, the
      d9 model at T = 1e5): make_filter_elements from the model's prior
      steps and sites, then parallel_filter (the filter-scan kernel),
      against the general filter kernel's moments on the same inputs and
      against float64; and KalmanFilterWithSparseSites with 30% of the
      flagship's grid points unobserved: -log_likelihood().backward()
      through the general filter and the general Koopman backward with
      that mask, against float64;
   f. the posterior and prediction: gpr.posterior (one filter and one
      smoother launch: kernels 1 + 2 on the uniform grid, 4 + 5 on the
      jittered one), then predict_f and predict_y at 1e5 new points
      (prediction_points: 98% inside, 1% exact hits, 0.5% past each end)
      and sample_f (16 draws at 1e3 points), for the flagship at T = 1e6
      on both grids and the d9 model at T = 1e5 (1e4 points, jittered
      grid), float32 and float64: float64 on the kernel path against the
      plain path, float32 against float64 by check_f32_wide's rule,
      sample_f's moments (256 draws, float64) within 5 standard errors of
      predict_f; the linear mean function on the flagship (loss() and
      predict_f against the flagship's on the residual); condense() on
      4e's sparse-site problem (its log-likelihood against the grid
      filter's); and float64 against a dense GP (tests/tools/dense_gp.py)
      at N = 500;
   g. CVI, bench config 4 (Matern32(0.5, 1), a Gaussian likelihood of
      variance 0.04, learning rate 0.5, y = sin(2x) + 0.2 N on
      linspace(0, 1000, T), seed 0), on the uniform and the jittered grid,
      float32 and float64: 5 full iterations (update_sites(), loss(),
      backward(): kernels 1 x2, 2, 3 a uniform iteration, 4 x2, 5, 7 a
      jittered one), the float64 kernel path within 1e-9 of the plain
      path (ELBO, sites, gradients) and float32 against float64; the
      float32 marginals of the initial sites (precision 2e-10) against the
      prior's; learning rate 1 and one update against GPR (ELBO and
      predict_f, float64); and the Bernoulli and Poisson likelihoods, 10
      updates each on the uniform grid: the classic ELBO may not fall
      after the fifth (float64), the float64 kernel path within 1e-9 of
      the plain path; in float32 each update's marginals from the kernels
      against the plain version's at the same sites, the sites and
      predict_log_density at 1e4 points after the last against the
      float64 plain run (check_f32_wide), and the ELBO at the float32
      sites against float64 at the same sites;
   h. SDE variational inference, bench config 5 (DoubleWellSDE(q=0.5),
      n = 16384 on linspace(0, 8, n + 1), observation noise 0.2): 4
      iterations of linearize_sde, the Kalman filter of the linearised
      prior and its posterior state-space model (kernels 4 and 5 at d = 1
      once each), the posterior's linear drift and the KL surrogate, in
      float32 and float64: the KL falls, the float64 kernel path within
      1e-9 of the plain path, float32 against float64;
   i. the natural-gradient family in float64: bench config 2 (a VGP,
      Matern32(0.5, 1), Bernoulli, T = 1e5 on linspace(0, 100, T)) and
      bench config 3 (an SVGP, Gaussian likelihood 0.04, N = 1e5 data,
      M = 2048 inducing points), three steps of
      SSMNaturalGradient(gamma=0.5, naturals_engine="parallel") each:
      kernels 4 (o = 2) and 5 once a step, the ELBO rising at every
      step; the first step against the plain path (TOL_NG, the ELBO
      TOL_NG_ELBO), and at N = 256 the parallel engine against the
      sequential one;
   j. multi-output GPR, the slice mo3 (an IndependentMultiOutput of
      Matern32(0.5, 1), Matern32(1, 1) and Matern32(2, 1): d = 6, o = 3,
      with a full 3 x 3 noise Cholesky) at T = 1e6 on both grids, float64
      and float32: a loss and its backward, posterior_marginals(),
      gpr.posterior with predict_f (both output covariances) and predict_y
      at 1e5 new points and sample_f (kernels 1 and 3 at o = 3 and 2 on the
      uniform grid, 4 and 7 at o = 3 and 5 on the jittered one), and
      FIT_STEPS fit steps in float32; float64 within 1e-9 of the plain path,
      float32 against float64 (TOL_MO3_F32_*), float64 at N = 500 against
      the numpy oracle and its finite differences; and a Product kernel's
      loss and gradient (kernels 1 and 3);
   k. GP factor analysis at o > d (fa12, fa6c; phase_factor_analysis);
   l. multi-output GPR above d = 6 at T = 1e5 (mo9: the d9 model's three
      Matern52 children as an IndependentMultiOutput, o = 3; fa9: the same
      as the latents of fa12's twelve outputs), both grids: kernels 4 and
      7 at (9, 3) and (9, 12), 5 at d = 9 (phase_wide_multi_output);
5. times, kernel path against plain path, with CUDA events after a warm-up
   (median of several runs): serving requests (gpr.posterior and
   predict_f at 1e5 points among them), training steps on both
   grids, general-grid requests, the d9 requests and training step, the
   CVI iteration on both grids, the SDE VI iteration and one
   natural-gradient step of configs 2 and 3 (median of 3 a turn; with
   each wrapper's device time per iteration in its own kernels, which
   must add up to all of the port's kernels in the trace); each
   kernel's device time per call from a torch.profiler trace (the wrapper's
   call time also holds its host work), at the flagship's d = 2 and at the
   d9 model's d = 9 (kernel 4 also at o = d = 2 on config 2's synthetic
   model, float64; kernels 1, 3, 4 and 7 at o = 3 and the smoothers at
   d = 6 on mo3's inputs, whose requests and training steps are timed
   too; the same at o > d on fa12's and fa6c's and above d = 6 on mo9's
   and fa9's), beside its bound: the least time an H100 needs for
   the bytes the call must move (each input read once, each output written
   once) or for the operations of the sequential Kalman recursion it
   computes, whichever is larger; and each kernel route's device time per
   pass (the profiler's rows under ``mf::``, one JSON line).

The plain path swaps every kernel wrapper for its plain version
(``plain_path``).  The line before the last is a JSON summary of the
kernels; the last line is ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T_FULL = 1_000_000
T_D9 = 100_000
FIT_STEPS = 5
#: the d9 model's children, (lengthscale, variance) of each Matern52
D9 = ((0.5, 1.0), (2.0, 0.5), (8.0, 0.25))
# float64: the kernels and the plain versions compose the same elements in
# different orders, so they agree to a few hundred ulps of the largest entry.
TOL_F64 = 1e-9
# float32: the two bracketings of ~log2(N) compositions, each with a d x d
# inverse of (I + C J), differ by float32 roundoff amplified by those
# inverses; the likelihood is a sum of N terms and is compared relatively.
TOL_F32_MOMENTS = 1e-3
TOL_F32_LOGLIK = 1e-4
# The adjoint's summed gradients (Fc, cc, Qc, Hc over N steps) are compared
# against the sum of their terms' magnitudes, the scale that bounds a sum's
# error: each term carries the scan's differences (TOL_F32_MOMENTS), and
# the terms' signs cancel in the sum.  Per-step outputs are normwise.
# f32 kernel path against the f64 kernel path for the T = 1e6 GPR loss; the
# JAX package measured 9.6e-7 for the same comparison on its own kernels.
TOL_F32_VS_F64_LOSS = 1e-5
# f32 hyperparameter gradients against f64; the JAX package's parity run
# measured 2.0e-6 for its f32 kernels (BENCH_r05.json).
TOL_F32_VS_F64_GRAD = 1e-4
# float32 at d = 9 (phase 3): the d9 model's filtered covariances are ill
# conditioned at dt = 1e-3 (the lengthscale-8 block is nearly
# deterministic), so two float32 bracketings may differ by more than
# TOL_F32_MOMENTS.  There each output of a kernel passes if it is within the
# tolerance of its plain version or, against float64, no less accurate than
# the plain version up to this factor.
F32_NO_WORSE = 2.0
# float64 gradients against central differences (h = 1e-5) of the numpy
# oracle's log-likelihood: truncation ~h^2, roundoff ~1e-16 |ll| / h.
TOL_FD = 1e-6
FD_STEP = 1e-5
# The d9 model in float32 against float64 at T = 1e5.  Its process noise is
# the generic Q = P_inf - A P_inf A^T (as in the JAX package), which loses
# Q[0, 0] of the lengthscale-0.5 block in float32 at dt = 1e-3 (about
# 5e-13 of P_inf[0, 0]); the JAX package's own XLA path differs from its
# float64 by 3.7e-5 in the loss.  Measured on an H100 (PERF.md), kernel
# path / plain path: loss 2.4e-5 / 2.2e-5 (uniform grid), 1.2e-6 / 1.8e-6
# (jittered); marginals up to 5.3e-3 / 7.0e-3; gradients 3.8e-4 / 3.9e-4
# normwise (the lengthscale-8 child's variance 2.3e-2 on its own).  The
# bounds are about 4x the largest of these.
TOL_D9_F32_VS_F64_LOSS = 1e-4
TOL_D9_F32_VS_F64_GRAD = 2e-3
TOL_D9_F32_MOMENTS = 3e-2
#: phase-3 step counts at the chunk edges of the staged d = 7..12 passes
#: (8 steps a warp at these N): one step; a run that ends inside a chunk;
#: a second warp of one step; runs of six and seven warps
CHUNK_EDGES = (1, 5, 9, 47, 50)
KERNEL_NAMES = {1: "Matern12", 2: "Matern32", 3: "Matern52"}
#: phase-3 step counts at the edges of the d <= 6 passes of the general
#: filter and Koopman backward: a thread's run of 8 steps, a warp's 256 and
#: a block's 2,048 at d <= 2 in float32, and two blocks
EDGE_NS = (1, 7, 8, 9, 255, 256, 257, 2047, 2048, 2049, 4099)
#: children past the d9 model's Matern52s for the phase-3 Sums at d = 4..12
SUM_EXTRA = {4: ("Matern12",), 5: ("Matern32",), 6: ("Matern52",), 7: ("Matern12",),
             8: ("Matern32",), 9: (), 10: ("Matern12",), 11: ("Matern32",),
             12: ("Matern52",)}
#: phase 4f: new points of a flagship request and of a d9 request, points
#: and draws of sample_f, draws (calls x draws) of the moment check, and
#: the linear mean function's coefficient
N_NEW = 100_000
N_NEW_D9 = 10_000
N_SAMPLE_POINTS = 1_000
SAMPLES = 16
SAMPLE_CALLS = 16
COEF = 0.01
#: phase 4g, bench config 4 (bench.py:262-267, :318-324): the grid's end,
#: the learning rate, full iterations of the Gaussian CVI, site updates of
#: the Bernoulli and Poisson CVI, and the points of predict_log_density;
#: the data's seed by likelihood
CVI_END = 1000.0
CVI_LR = 0.5
CVI_ITERS = 5
CVI_UPDATES = 10
N_PLD = 10_000
CVI_SEEDS = {"Gaussian": 0, "Bernoulli": 1, "Poisson": 2}
#: the classic ELBO of a non-Gaussian CVI may fall by no more than this,
#: relative, from the fifth site update on (the rule of
#: tests/integration/models/test_cvi.py::test_cvi_poisson_improves)
TOL_ELBO_FALL = 1e-6
#: float32 q(f) from the initial sites (precision 2e-10) against the
#: prior's mean 0 and variance 1, max abs: a few float32 roundings of the
#: filter's and the smoother's compositions
TOL_CVI_FIRST_F32 = 1e-4
#: phase 4h, bench config 5: the path's points and the VI iterations
SDE_N = 16_384
SDE_ITERS = 4
#: the SDE's KL surrogate in float32 against float64, relative: the
#: posterior's linear drift divides A_post - 1 (float32 roundoff ~6e-8) by
#: dt = 4.9e-4; measured on an H100 at n = 16384: 1.2e-6 (PERF.md)
TOL_SDE_F32_KL = 1e-4
#: phase 4i, bench configs 2 and 3 (benchmarks/run_all.py:186-257): T = 1e5
#: points on linspace(0, 100, T), the SVGP's inducing points, natural-
#: gradient steps (gamma 0.5, the parallel engine) on the card in float64,
#: and the N at which the sequential engine (a loop over the states) is
#: held against the parallel one
NG_T = 100_000
NG_M = 2048
NG_GAMMA = 0.5
NG_STEPS = 3
NG_SMALL_N = 256
#: a natural-gradient step on the kernel path against the plain path, and
#: the parallel engine against the sequential one: the new SSM's fields
#: (the offsets b_k = m_{k+1} - A_k m_k on the scale of the means they are
#: differences of) and the new q's marginals; and the ELBO at the new q,
#: relative.  Any two float64 inversions of bench config 2's naturals
#: differ by more than 1e-8: under the CPU shim at T = 1e5 the kernel path,
#: the plain path and the sequential engine differ pairwise by up to 3.5e-8
#: in q's marginal means (the synthetic model's lam ~ 1e9 is indefinite),
#: and by 6.6e-8 at T = 4000; their ELBOs by 2e-10 and 3.6e-10
TOL_NG = 2e-7
TOL_NG_ELBO = 1e-8
#: phase 3 on the natgrad inversion's sites: a kernel output may differ
#: from the plain version's by up to this many times the plain version's
#: own change under a one-ulp perturbation of its inputs (at d = 2,
#: N = 2048: 5.2e-8 in m_f on the CPU; on an H100 the kernel differed
#: from the plain version by up to 3.2 times that spread over EDGE_NS)
COND_FACTOR = 10.0
#: phase 4j, the multi-output slice "mo3": an IndependentMultiOutput of
#: three Matern32 children (lengthscale, variance), d = 6, o = 3, with a
#: full noise Cholesky (so that the sites' lam is not diagonal)
MO3 = ((0.5, 1.0), (1.0, 1.0), (2.0, 1.0))
MO3_CHOL = ((0.2, 0.0, 0.0), (0.05, 0.2, 0.0), (0.02, 0.05, 0.2))
MO3_SPEC = ("IndependentMultiOutput", ("Matern32",) * 3)
#: mo3 in float32 against float64 on the kernel path at T = 1e6: the loss
#: (relative), the six gradients (normwise), the marginals and predictions
#: (normwise).  The flagship's bounds; measured on an H100 (PERF.md),
#: uniform / jittered grid: loss 7.2e-7 / 1.4e-7, gradients 1.0e-5 /
#: 2.5e-6, marginals and predictions up to 9.5e-5 / 2.1e-4
TOL_MO3_F32_LOSS = 1e-5
TOL_MO3_F32_GRAD = 1e-4
TOL_MO3_F32_MOMENTS = 1e-3
#: phase 4j's Product kernel: steps on the uniform grid
PRODUCT_T = 100_000
#: phase 4k, GP factor analysis (FactorAnalysisKernel, o > d): fa12, three
#: Matern32 latents (lengthscale, variance; d = 6) mixed into 12 outputs by
#: a seeded trainable loading and the time-varying weights A(t) =
#: diag(1 + 0.5 sin(2 pi t / p_i)) of FA12_PERIODS, with a full seeded
#: noise Cholesky (kernels 4, 7 at (6, 12) and 5 on both grids); fa6c, two
#: Matern32 latents (d = 4) into 6 outputs with identity weights and the
#: noise 0.1 I of docs/examples/factor_analysis.py (kernels 1, 3 at (4, 6)
#: and 2 on the uniform grid, 4, 7 and 5 on the jittered one)
FA12 = ((0.5, 1.0), (1.0, 1.0), (2.0, 1.0))
FA12_O = 12
FA12_PERIODS = tuple(np.linspace(5.0, 50.0, FA12_O))
FA6C = ((0.5, 1.0), (1.0, 1.0))
FA6C_O = 6
#: new points of phase 4k's predict_f, and the steps of its float64 runs
#: (the float64 kernel path against the plain path, float32 against
#: float64): float64 at T = 1e6 on both paths took ~30 s of the time limit
#: a (configuration, grid)
N_NEW_FA = 100_000
T_FA_F64 = 100_000
#: phase 4k's Adam learning rate.  The loss's curvature along the loading
#: grows with N (o N observations of every entry), and Adam's first step
#: moves each parameter by the learning rate: at T = 1e6 a step of 1e-3
#: raised fa12's float32 loss (an H100 run), one of 1e-4 lowers it at every
#: step (a CPU run at T = 3e5)
FA_FIT_LR = 1e-4
#: phase 3, kernels 1, 3, 7 and 4 at o > d (the run-time-o sources; kernels
#: 1 and 3 to o = 6)
O_OVER_D = ((1, 2), (2, 5), (4, 6), (3, 12), (6, 12))
#: phase 3's o x o pairs at o = 2..d: the smallest and the largest o at each
#: d and mo3's (6, 3); (4, 3), (5, 3), (5, 4), (6, 4) and (6, 5), the same
#: templates at other (d, o), were cut for the time limit in PR 19 (the
#: card took 1103 and 1112 s without this cut; the cuda tests keep every
#: pair)
O_PAIRS = ((2, 2), (3, 2), (3, 3), (4, 2), (4, 4), (5, 2), (5, 5), (6, 2), (6, 3), (6, 6))
#: phase 3, kernels 4 and 7 at o = 2..12 for d = 7..12 (csrc/wide_info.cuh,
#: run-time d and o): the smallest wide d at the smallest o, mo9's (9, 3),
#: fa9's (9, 12), (12, 5) and (12, 12), at the chunk and warp edges
#: (CHUNK_EDGES), both dtypes, with per-step sites and stride-0 ones;
#: kernel 4 also at (9, 9) on the natural-gradient inversion's indefinite
#: per-step sites (float64)
O_WIDE = ((7, 2), (9, 3), (9, 12), (12, 5), (12, 12))
#: phase 3, kernel 4's element form on the natural-gradient inversion's
#: indefinite sites at d = 7, 9 and 12 beyond the chunk edges: float64's
#: ill-conditioned range, where the plain version's own one-ulp spread of
#: the log-likelihood reaches 1e-9 to 3e-8
NATGRAD_WIDE_NS = (200, 300)
#: phase 4l, the multi-output models of the d9 model's three Matern52
#: children (D9, d = 9) at T_D9: mo9, an IndependentMultiOutput of them with
#: mo3's noise Cholesky (o = 3), and fa9, a FactorAnalysisKernel of them as
#: latents with fa12's weights, seeded loading and noise Cholesky (o = 12);
#: kernels 4 and 7 at (9, 3) and (9, 12) and kernel 5 on both grids (the
#: uniform grid through the materialised route: kernels 1 and 3 take o = 1
#: only above d = 6), predict_f at N_NEW_WIDE new points
MO9_SPEC = ("IndependentMultiOutput", ("Matern52",) * 3)
FA9_O = 12
N_NEW_WIDE = 10_000
#: gpr_outputs' predictions, held at the exact hits and ends in phase 4l
WIDE_PREDICTIONS = ("f mean", "f var", "f cov", "y mean", "y cov")
#: mo9 and fa9 in float32 (phase 4l, T = T_D9), the kernel path against
#: the plain path (check_f32_wide: an output beyond its bound passes if its
#: error against float64 is no worse than F32_NO_WORSE times the plain
#: path's): the loss (relative), the gradients (normwise), the marginals
#: and predictions at the exact hits and ends (normwise).  The Matern52
#: children's generic Q loses digits in float32 (TOL_D9_F32_*).  Each is
#: about 4x the largest of the first H100 runs (PERF.md), uniform /
#: jittered grid: mo9's loss 7.2e-7 / 2.9e-7, gradients 3.3e-4 / 8.9e-4,
#: marginals 9.2e-5 / 1.2e-4, predictions 2.7e-5 / 1.3e-5; fa9's loss
#: 7.2e-7 / 4.5e-7, gradients 6.3e-5 / 7.4e-4, marginals 5.9e-4 / 4.6e-4,
#: predictions 1.1e-4 / 1.7e-5
TOL_MO9_F32_LOSS = 3e-6
TOL_MO9_F32_GRAD = 4e-3
TOL_MO9_F32_MOMENTS = 5e-4
TOL_FA9_F32_LOSS = 3e-6
TOL_FA9_F32_GRAD = 3e-3
TOL_FA9_F32_MOMENTS = 2.5e-3
#: fa12 and fa6c in float32 against float64 (phase 4k, T = T_FA_F64): the
#: loss (relative), the gradients (normwise), the marginals and predictions
#: (normwise), mo3's bounds; an output beyond its bound passes by
#: check_f32_wide's rule (no worse than F32_NO_WORSE times the plain path's
#: float32 error).  On an H100 at T = 1e6 fa12's uniform-grid loading
#: gradient sat 3.3e-4 off float64 on the kernel path, a sum over 1e6
#: steps near the loss's optimum (the plain path's was not measured then)
TOL_FA_F32_LOSS = 1e-5
TOL_FA_F32_GRAD = 1e-4
TOL_FA_F32_MOMENTS = 1e-3
#: phase 3, kernels 1, 3 and 7 at o x o sites: the edges of a thread's run
#: of steps, a warp's, a block's and two blocks' (of every tiling they use;
#: 4099: two of pass 1's 4,096-step blocks of kernel 1's rank-o route at
#: d >= 4 in float32; 2049 and 4099: two and three of the 2,048-step
#: pass-1 blocks of kernels 3 and 7 at d >= 4, with a short last run)
O_EDGE_NS = (1, 9, 257, 2049, 4099)
#: the o x o cases' sites, (const_sites, masked): per-step H and lam with a
#: mask (the element form), stride-0 ones with a mask and without (the
#: rank-o routes of kernels 1 and 4; a mask changes only the likelihood)
O_SITES = ((False, True), (True, True), (True, False))
#: the same for kernels 1, 3 and 7, (const_sites, masked, scaled): the
#: per-step sites' dense H scaled to the states' spread and not
O_KERNEL_SITES = ((False, True, True), (False, True, False), (True, True, True),
                  (True, False, True))
DEVICE = torch.device("cuda")
#: the H100's memory rate and float32 and float64 rates outside the tensor
#: cores (NVIDIA's data sheet, SXM part, at a 700 W power limit)
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_F64_FLOPS = 34e12
#: the launch counters the paths read: (module, wrapper name)
COUNTED = (("cs", "filter_pipeline_uniform"), ("cs", "smoother_pipeline_uniform"),
           ("adj", "adjoint_pipeline_uniform"), ("cs", "filter_pipeline"),
           ("cs", "smoother_scan"), ("cs", "filter_scan"),
           ("adj", "adjoint_pipeline"))
#: the gradients the GPR backward asks of the general Koopman backward
GPR_NEEDS = (True, True, True, False, False, False)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_diff(got: torch.Tensor, want: torch.Tensor, scale=None) -> float:
    """max |got - want| over max |want|, or over max ``scale`` (normwise, so
    near-zero entries do not dominate)."""
    ref = want if scale is None else scale
    den = ref.abs().max().clamp_min(torch.finfo(want.dtype).tiny)
    return float((got - want).abs().max() / den)


def check(tag: str, diffs: dict, tols: dict) -> None:
    log(f"  {tag}: max rel diff "
        + " ".join(f"{k}={v:.3e}" for k, v in diffs.items()))
    for key, val in diffs.items():
        if not (np.isfinite(val) and val <= tols[key]):
            raise AssertionError(f"{tag}: {key} differs by {val:.3e} > {tols[key]:g}")


def check_f32_wide(tag: str, outs: dict, tols: dict) -> None:
    """outs: name -> (kernel output, plain output, float64 reference of the
    plain version on the same inputs[, the scale of rel_diff or None]).
    Each output passes within its tolerance of the plain version, or if its
    error against float64 is at most F32_NO_WORSE times the plain
    version's."""
    def scale(sc, f64=False):
        return None if not sc or sc[0] is None else sc[0].double() if f64 else sc[0]
    diffs = {k: rel_diff(kk, pp, scale(sc)) for k, (kk, pp, _, *sc) in outs.items()}
    errs = {k: (rel_diff(kk.double(), rr, scale(sc, True)),
                rel_diff(pp.double(), rr, scale(sc, True)))
            for k, (kk, pp, rr, *sc) in outs.items()}
    log(f"  {tag}: max rel diff "
        + " ".join(f"{k}={v:.3e}" for k, v in diffs.items())
        + "; against float64, kernel / plain: "
        + " ".join(f"{k}={a:.3e}/{b:.3e}" for k, (a, b) in errs.items()))
    for key, val in diffs.items():
        err_k, err_p = errs[key]
        if not (val <= tols[key] or err_k <= F32_NO_WORSE * err_p):
            raise AssertionError(f"{tag}: {key} differs by {val:.3e} > {tols[key]:g} "
                                 f"and its float64 error {err_k:.3e} exceeds "
                                 f"{F32_NO_WORSE:g} x the plain version's {err_p:.3e}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def modules():
    from markovflow_tpu_torch import kalman_filter, training
    from markovflow_tpu_torch.ops import adjoint, cuda_scan
    return cuda_scan, adjoint, kalman_filter, training


def counted(cs, adj):
    """The wrappers whose launch counters the paths read, by kernel name."""
    mods = {"cs": cs, "adj": adj}
    return {name: getattr(mods[mod], name) for mod, name in COUNTED}


@contextlib.contextmanager
def launches_of(cs, adj, out: dict):
    """Set every launch counter to 0, run the block, store the counts."""
    wrappers = counted(cs, adj)
    for w in wrappers.values():
        w.launches = 0
    yield
    torch.cuda.synchronize()
    out.update({k: w.launches for k, w in wrappers.items()})


@contextlib.contextmanager
def plain_path(cs, adj, kf):
    """Swap every kernel wrapper for its plain PyTorch version (in the
    modules that call them), for the plain-path timings."""
    def adjoint_plain(*args, site_grads=True, hc_grad=True):
        return adj.adjoint_pipeline_uniform_plain(*args)

    def gadjoint_plain(*args, needs=None):
        return adj.adjoint_pipeline_plain(*args)
    swaps = {"filter_pipeline_uniform": cs.filter_pipeline_uniform_plain,
             "smoother_pipeline_uniform": cs.smoother_pipeline_uniform_plain,
             "filter_pipeline": cs.filter_pipeline_plain,
             "smoother_scan": cs.smoother_scan_plain,
             "filter_scan": cs.filter_scan_plain}
    saved = []
    for mod in (cs, kf):
        for name, fn in swaps.items():
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, fn)
    for name, fn in (("adjoint_pipeline_uniform", adjoint_plain),
                     ("adjoint_pipeline", gadjoint_plain)):
        saved.append((adj, name, getattr(adj, name)))
        setattr(adj, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# Problems
# ---------------------------------------------------------------------------
def jittered_grid(n, seed=0, end=100.0):
    """linspace(0, end, n), each point moved by up to 0.4 of the spacing."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, end, n)
    return x + 0.4 * (end / max(n - 1, 1)) * rng.uniform(-1.0, 1.0, n)


def sites(n, batch, dtype, rng, masked):
    """Sites of y = sin(2x) + 0.2 noise (noise variance 0.04) on any grid."""
    dev = DEVICE
    x = np.linspace(0.0, 100.0, n)
    y = np.sin(2.0 * x) + 0.2 * rng.standard_normal(batch + (n,))
    nu = torch.as_tensor(y / 0.04, dtype=dtype, device=dev)[..., None, None, :]
    lam = torch.full((1, 1, 1), 1.0 / 0.04, dtype=dtype,
                     device=dev).expand(batch + (1, 1, n))
    maskf = None
    if masked:
        maskf = torch.as_tensor(rng.random(batch + (n,)) > 0.3, dtype=dtype,
                                device=dev)[..., None, None, :]
    return nu, lam, maskf


def sum_kernel(d, dtype, device=DEVICE):
    """A Sum of Matern kernels of state dim d = 4..12: the d9 model's
    Matern52s (the first for d <= 6, the first two for d < 9), then
    SUM_EXTRA[d]."""
    from markovflow_tpu_torch import kernels

    base = 1 if d <= 6 else (2 if d < 9 else 3)
    kids = [kernels.Matern52(lengthscale=ell, variance=var, dtype=dtype,
                             device=device) for ell, var in D9[:base]]
    kids += [getattr(kernels, name)(lengthscale=1.0, variance=0.3, dtype=dtype,
                                    device=device) for name in SUM_EXTRA[d]]
    k = kernels.Sum(kids)
    assert k.state_dim == d
    return k


def emission_row(k, d, dtype):
    """The kernel's emission row as [1, d, 1]: [1, 0, ...] for a Matern,
    the children's rows side by side for a Sum."""
    if d <= 3:
        h = torch.zeros((1, d, 1), dtype=dtype, device=DEVICE)
        h[0, 0, 0] = 1.0
        return h
    tp = torch.zeros((1,), dtype=dtype, device=DEVICE)
    return k.generate_emission_model(tp).emission_matrix.movedim(-3, -1)


def uniform_problem(d, n, batch, dtype, seed, masked=False):
    """Constant Matern prior steps on linspace(0, 100, n) with sites; for
    d >= 4 those of a Sum (sum_kernel), made in float64 and cast, as
    general_problem makes them."""
    from markovflow_tpu_torch import kernels

    dev = DEVICE
    kdtype = dtype if d <= 3 else torch.float64
    k = (getattr(kernels, KERNEL_NAMES[d])(lengthscale=0.5, variance=1.0,
                                          dtype=kdtype, device=dev)
         if d <= 3 else sum_kernel(d, kdtype))
    dt = torch.full((1,), 100.0 / max(n - 1, 1), dtype=kdtype, device=dev)
    with torch.no_grad():
        fc, cc, qc, mu0, p0 = (x.to(dtype) for x in k.prior_const_tl(dt))
    hc = emission_row(k, d, dtype)
    nu, lam, maskf = sites(n, batch, dtype, np.random.default_rng(seed), masked)
    return (fc, cc, qc, mu0, p0, hc, nu, lam, maskf)


def general_problem(d, n, batch, dtype, seed, masked=False):
    """Per-step Matern prior steps (a Sum's for d >= 4) on a jittered grid,
    one emission row expanded over the steps, and sites.  The prior steps
    are made in float64 and cast: Matern52's generic process noise cancels
    in float32 at these small steps, and the check is of the kernels."""
    from markovflow_tpu_torch import kernels

    dev = DEVICE
    k = (getattr(kernels, KERNEL_NAMES[d])(lengthscale=0.5, variance=1.0,
                                          dtype=torch.float64, device=dev)
         if d <= 3 else sum_kernel(d, torch.float64))
    tp = torch.as_tensor(jittered_grid(n, seed), device=dev)
    with torch.no_grad():
        F, c, Q = (x.to(dtype) for x in k.prior_arrays_tl(tp))
    h = emission_row(k, d, dtype)
    nu, lam, maskf = sites(n, batch, dtype, np.random.default_rng(seed), masked)
    return (F, c, Q, h.expand(1, d, n), nu, lam, maskf)


def adjoint_sum_scales(adj, args, m_f, p_f, gscale):
    """The sums of the magnitudes of the terms of the adjoint's six summed
    gradients (the scale of each sum's error), from the plain stages."""
    from markovflow_tpu_torch.ops.kalman import _materialize_uniform

    fc, cc, qc, mu0, p0, hc, nu, lam, maskf = args
    n = nu.shape[-1]
    F, c, Q, H = _materialize_uniform(fc, cc, qc, mu0, p0, hc, n)
    mk = (torch.ones(nu.shape[:-3] + (n,), dtype=nu.dtype, device=nu.device)
          if maskf is None else maskf[..., 0, 0, :])
    g_f, g_c, g_q, g_h, _, _ = adj._adjoint_grads(F, c, Q, H, nu, lam, mk, m_f, p_f)
    gg = gscale.abs()[..., None, None, None]

    def mag(x):
        return (gg * x.abs()).sum(-1, keepdim=True)
    return (mag(g_f[..., 1:]), mag(g_c[..., 1:]), mag(g_q[..., 1:]),
            gg * g_c[..., :1].abs(), gg * g_q[..., :1].abs(), mag(g_h))


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------
ADJ_OUT = ("gFc", "gcc", "gQc", "gmu0", "gP0", "gHc", "gnu", "glam")
GADJ_OUT = ("gF", "gc", "gQ", "gH", "gnu", "glam")
#: kernel 3's calls at o x o sites, (site_grads, hc_grad) -> the tag of
#: their outputs: all eight, no site gradients, and neither gHc nor the
#: site gradients (as GPR's backward asks: the lean pass 3).  With the site
#: gradients and without gHc the kernel runs as with all eight, and the
#: wrapper returns None for gHc (tests/port/test_torch_adjoint.py holds that)
ADJ_ASKS = {(True, True): "", (False, True): " (no site grads)", (False, False): " (GPR's)"}


def phase_kernels_vs_plain(cs, adj):
    log("phase 3: kernels against their plain versions on the card")
    cases = [(n, batch, d, dtype, False)
             for dtype in (torch.float64, torch.float32)
             for n in (4099, T_FULL) for batch in ((), (3,)) for d in (1, 2, 3)]
    cases.append((4099, (3,), 2, torch.float64, True))
    cases.append((4099, (3,), 2, torch.float32, True))
    # the d = 7..12 kernels: float64 at N = 4099, float32 at d = 9, N = 1e5;
    # then the shapes of the multi-level pass 2 (csrc/wide_scan.cuh): 2,084
    # warp totals at d = 9, N = 1e5; a partial group at N = 50; a batch
    # and a mask at d = 7 and d = 12
    cases += [(4099, (3,), d, torch.float64, False) for d in range(7, 13)]
    cases.append((T_D9, (), 9, torch.float32, False))
    cases += [(T_D9, (), 9, torch.float64, False), (50, (), 9, torch.float64, False),
              (4099, (3,), 7, torch.float64, True), (4099, (3,), 12, torch.float64, True)]
    # the staged passes of kernels 2, 5 and 6 at d = 7..12: runs of steps
    # that end inside a chunk (CH = 4 in float32, 2 in float64) and N below
    # CH; d = 12 in float64 with a batch, the most shared memory a warp
    cases += [(n, (), 9, dtype, False) for n in CHUNK_EDGES
              for dtype in (torch.float64, torch.float32)]
    cases.append((50, (3,), 12, torch.float64, False))
    for i, (n, batch, d, dtype, masked) in enumerate(cases):
        kernels_vs_plain_case(cs, adj, i, n, batch, d, dtype, masked)
    # the filter scan's moments-only pass 3 on elements no model makes
    for n, batch, d in ((4099, (3,), 7), (4099, (3,), 9), (4099, (3,), 12), (47, (), 9)):
        filter_scan_random_case(cs, n, batch, d)
    # the d <= 6 passes where a thread's, a warp's or a block's run of steps
    # ends: the general filter and Koopman backward, the uniform filter, the
    # uniform smoother and Koopman backward, the filter scan (also at d = 4,
    # where it reads each step where it lies) and the smoother scan (d = 4,
    # its last staged d, 160 threads a block in float64; d = 5 and 6, where
    # it reads each step where it lies)
    for dtype in (torch.float64, torch.float32):
        for n in EDGE_NS:
            for d in (1, 2, 3, 6):
                general_edges_case(cs, adj, n, d, dtype)
                uniform_edges_case(cs, n, d, dtype)
                uniform_pair_edges_case(cs, adj, n, d, dtype)
            for d in (1, 2, 3, 4, 6):
                filter_scan_random_case(cs, n, (3,), d, dtype)
            for d in range(1, 7):
                smoother_scan_edges_case(cs, n, d, dtype)
            # the general filter at o = 2..d: H and lam stored at every
            # step, and stride 0 with a mask and without (definite sites;
            # the indefinite ones of the natural-gradient inversion
            # follow)
            for d, o in O_PAIRS:
                for const_sites, masked in O_SITES:
                    multi_output_case(cs, n, (3,), d, o, dtype, const_sites, masked)
            # at o = d = 2 on the inversion's own indefinite sites (the bench
            # configs' Matern32; a Matern52's synthetic model at N = 2049
            # is past float64: the plain version and the kernel, composing
            # in two orders, differ by 1e-2)
            if dtype == torch.float64:
                natgrad_filter_case(cs, n, (3,), 2)
        # kernels 1, 3 and 7 at o = 2..d: per-step sites with a dense H,
        # scaled to the states' spread and not, and GPR's stride-0 H and lam
        # with a mask and without; then at o > d (kernels 1 and 3 to o = 6).
        # The unscaled dense H runs in float32 only (the float32 fault it
        # was added for, PR 16): in float64 it is cut for the time limit
        # since PR 19 (the cuda tests keep it)
        o_sites = [v for v in O_KERNEL_SITES
                   if dtype == torch.float32 or v[0] or v[2]]
        for n in O_EDGE_NS:
            for d, o in O_PAIRS:
                for const_sites, masked, scaled in o_sites:
                    multi_output_kernels_case(cs, adj, n, (3,), d, o, dtype, const_sites,
                                              masked, scaled)
            for d, o in O_OVER_D:
                for const_sites, masked, scaled in o_sites:
                    multi_output_kernels_case(cs, adj, n, (3,), d, o, dtype, const_sites,
                                              masked, scaled)
        # kernels 4 and 7 at o = 2..12 above d = 6 (csrc/wide_info.cuh), at
        # the chunk and warp edges of the wide passes; kernel 4 at (9, 9) on
        # the natural-gradient inversion's indefinite per-step sites (its
        # element form)
        for n in CHUNK_EDGES:
            for d, o in O_WIDE:
                for const_sites, masked, scaled in o_sites:
                    multi_output_kernels_case(cs, adj, n, (3,), d, o, dtype, const_sites,
                                              masked, scaled)
            if dtype == torch.float64:
                natgrad_filter_case(cs, n, (3,), 9)
        # kernel 4's element form on the inversion's sites above d = 6 at
        # NATGRAD_WIDE_NS (a warp's steps folded in order left the
        # log-likelihood 15x the plain version's one-ulp spread at d = 9,
        # N = 200 and 90x at d = 7, N = 300; folded as a binary tree, 4x at most)
        if dtype == torch.float64:
            for n in NATGRAD_WIDE_NS:
                for d in (7, 9, 12):
                    natgrad_filter_case(cs, n, (3,), d)


def general_edges_case(cs, adj, n, d, dtype):
    """The general filter and Koopman backward against their plain versions
    at N = n, batch (3,), with a mask and the stride-0 emission row and lam
    of GPR (general_problem's)."""
    f64 = dtype == torch.float64
    tol_m = TOL_F64 if f64 else TOL_F32_MOMENTS
    gargs = general_problem(d, n, (3,), dtype, seed=n, masked=True)
    assert n == 1 or gargs[3].stride(-1) == gargs[5].stride(-1) == 0
    gscale = torch.linspace(1.0, -0.5, 3, dtype=dtype, device=DEVICE)
    with torch.no_grad():
        m_k, p_k, ll_k = cs.filter_pipeline(*gargs)
        m_p, p_p, ll_p = cs.filter_pipeline_plain(*gargs)
        ga_k = adj.adjoint_pipeline(*gargs, m_p, p_p, gscale)
        ga_p = adj.adjoint_pipeline_plain(*gargs, m_p, p_p, gscale)
    torch.cuda.synchronize()
    diffs = {"m_f": rel_diff(m_k, m_p), "P_f": rel_diff(p_k, p_p),
             "loglik": rel_diff(ll_k, ll_p),
             **{name: rel_diff(g, w) for name, g, w in zip(GADJ_OUT, ga_k, ga_p)}}
    tols = {k: tol_m for k in diffs}
    tols["loglik"] = TOL_F64 if f64 else TOL_F32_LOGLIK
    check(f"general edges N={n} batch=(3,) d={d} {str(dtype)[6:]} masked", diffs, tols)


def uniform_edges_case(cs, n, d, dtype):
    """The uniform filter against its plain version at N = n, batch (3,),
    with a mask and GPR's stride-0 lam (uniform_problem's)."""
    f64 = dtype == torch.float64
    args = uniform_problem(d, n, (3,), dtype, seed=n, masked=True)
    assert n == 1 or args[7].stride(-1) == 0
    with torch.no_grad():
        got, want = cs.filter_pipeline_uniform(*args), cs.filter_pipeline_uniform_plain(*args)
    torch.cuda.synchronize()
    tol_m = TOL_F64 if f64 else TOL_F32_MOMENTS
    check(f"uniform edges N={n} batch=(3,) d={d} {str(dtype)[6:]} masked",
          {k: rel_diff(g, w) for k, g, w in zip(("m_f", "P_f", "loglik"), got, want)},
          {"m_f": tol_m, "P_f": tol_m, "loglik": TOL_F64 if f64 else TOL_F32_LOGLIK})


def uniform_pair_edges_case(cs, adj, n, d, dtype):
    """The uniform smoother and Koopman backward against their plain versions
    at N = n, batch (3,), from the plain filter's moments of
    uniform_problem's problem with a mask and GPR's stride-0 lam; the
    backward with the site gradients and without them (as the main path
    calls it), its sums against the magnitudes of their terms."""
    f64 = dtype == torch.float64
    args = uniform_problem(d, n, (3,), dtype, seed=n, masked=True)
    assert n == 1 or args[7].stride(-1) == 0
    gscale = torch.linspace(1.0, -0.5, 3, dtype=dtype, device=DEVICE)
    with torch.no_grad():
        m_p, p_p, _ = cs.filter_pipeline_uniform_plain(*args)
        s_k = cs.smoother_pipeline_uniform(*args[:3], m_p, p_p)
        s_p = cs.smoother_pipeline_uniform_plain(*args[:3], m_p, p_p)
        a_k = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gscale)
        a_k0 = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gscale, site_grads=False)
        a_p = adj.adjoint_pipeline_uniform_plain(*args, m_p, p_p, gscale)
        scales = adjoint_sum_scales(adj, args, m_p, p_p, gscale) + (None, None)
    torch.cuda.synchronize()
    assert a_k0[6] is None and a_k0[7] is None
    diffs = {"m_s": rel_diff(s_k[0], s_p[0]), "P_s": rel_diff(s_k[1], s_p[1]),
             **{name: rel_diff(g, w, sc) for name, g, w, sc in zip(ADJ_OUT, a_k, a_p, scales)},
             **{name + " (no site grads)": rel_diff(g, w, sc)
                for name, g, w, sc in zip(ADJ_OUT[:6], a_k0, a_p, scales)}}
    tol = TOL_F64 if f64 else TOL_F32_MOMENTS
    check(f"uniform smoother, Koopman backward edges N={n} batch=(3,) d={d} "
          f"{str(dtype)[6:]} masked", diffs, dict.fromkeys(diffs, tol))


def random_contractions(rng, shape, d):
    """Random d x d matrices of spectral radius at most 0.95, [*shape, d, d]."""
    a = 0.8 * np.eye(d) + 0.3 * rng.standard_normal(shape + (d, d)) / np.sqrt(d)
    return a * (0.95 / np.maximum(np.abs(np.linalg.eigvals(a)).max(-1), 0.95))[..., None, None]


def psd(x):
    """x x^T over the last two axes."""
    return x @ np.swapaxes(x, -1, -2)


def random_filter_elements(d, n, batch, dtype, device=DEVICE, seed=0):
    """Prebuilt filtering elements that no model makes: a random contraction A
    and random PSD C and J at every step, step 0 included (where
    make_filter_elements_tl has A = 0 and J = 0), random b and eta.  The
    cuda tests and the CPU shim run (tests/) take them from here."""
    rng = np.random.default_rng(seed + 11 * d)
    a = random_contractions(rng, batch + (n,), d)
    lc = 0.3 * rng.standard_normal(batch + (n, d, d)) + np.eye(d)
    lj = 0.3 * rng.standard_normal(batch + (n, d, d)) / np.sqrt(d)
    t = lambda x: torch.as_tensor(np.moveaxis(x, -3, -1), dtype=dtype,  # noqa: E731
                                  device=device)
    return (t(a), t(rng.standard_normal(batch + (n, d, 1))), t(psd(lc)), t(psd(lj)),
            t(rng.standard_normal(batch + (n, d, 1))))


def random_smoother_elements(d, n, batch, dtype, device=DEVICE, seed=0):
    """Prebuilt smoothing elements that no model makes: a random contraction E
    and a random PSD L at every step, the last included (where
    smoother_elements_tl has E = 0), random g."""
    rng = np.random.default_rng(seed + 13 * d)
    e = random_contractions(rng, batch + (n,), d)
    ll = 0.3 * rng.standard_normal(batch + (n, d, d)) + np.eye(d)
    t = lambda x: torch.as_tensor(np.moveaxis(x, -3, -1), dtype=dtype,  # noqa: E731
                                  device=device)
    return t(e), t(rng.standard_normal(batch + (n, d, 1))), t(psd(ll))


def multi_output_sites(d, o, n, batch, dtype, seed, device=DEVICE, const_sites=False,
                       dense_h=None, masked=True):
    """Sites at o x o: the emission H [o, d, N] (the first o rows of I, or
    with ``dense_h`` I's rows plus 0.5 N(0, 1) entries times ``dense_h``
    [d], the prior's standard deviation of the first state over each
    state's, so that H x mixes the states in units of their spread), nu
    [o, 1, N] and
    lam = U diag(e) U^T [o, o, N] with a random orthogonal U and e in
    [1, 25] (float64 with identity rows) or in [0.04, 1] (float32, or a
    dense H: with e in [1, 25] and H's entries unscaled, the plain
    version's outputs moved by up to 8e-8 when its float64 inputs moved by
    one ulp, at d = 3, o = 3, N = 1100), and a mask (None unless
    ``masked``); H and lam stored at every step, or with ``const_sites``
    one H and one lam expanded (stride 0)."""
    rng = np.random.default_rng(seed + 17 * d + o)
    steps = 1 if const_sites else n
    u, _ = np.linalg.qr(rng.standard_normal(batch + (steps, o, o)))
    scale = 1.0 if dtype == torch.float64 and dense_h is None else 0.04
    lam = (u * rng.uniform(scale, 25.0 * scale, batch + (steps, 1, o))) @ np.swapaxes(u, -1, -2)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    lam = t(np.moveaxis(0.5 * (lam + np.swapaxes(lam, -1, -2)), -3, -1))
    nu = t(5.0 * rng.standard_normal(batch + (o, 1, n)))
    maskf = t(rng.random(batch + (1, 1, n)) > 0.3) if masked else None
    h = np.eye(o, d)[..., None]
    if dense_h is not None:
        h = h + 0.5 * rng.standard_normal((o, d, steps)) * np.asarray(dense_h)[:, None]
    h = t(h).expand(o, d, n)
    if const_sites:
        lam = lam.expand(batch + (o, o, n))
    else:
        h = h.contiguous()
    return h, nu, lam, maskf


def multi_output_problem(d, o, n, batch, dtype, seed, device=DEVICE, const_sites=False,
                         dense_h=False, scaled=True, masked=True):
    """The general filter's inputs at o x o sites: the per-step Matern prior
    of a jittered grid (a Sum's for d >= 4, made in float64 and cast) and
    multi_output_sites' H, sites and mask: the first o rows of I as H (the
    natural-gradient inversion's identity emission) unless ``dense_h``,
    lam's eigenvalues in [1, 25] (float64) or in [0.04, 1] (float32, held
    on these benign sites only: at the larger ones both versions cancel
    most digits of the prior's covariance, as o observed states update
    it).  The indefinite sites of that inversion are
    natgrad_filter_problem's.  The cuda tests and the CPU shim run (tests/)
    take them from here.  ``scaled=False`` leaves the dense H's entries
    unscaled (dense_scales)."""
    k = multi_output_kernel(d, device)
    tp = torch.as_tensor(jittered_grid(n, seed), device=device)
    with torch.no_grad():
        F, c, Q = (x.to(dtype) for x in k.prior_arrays_tl(tp))
    return (F, c, Q) + multi_output_sites(d, o, n, batch, dtype, seed, device, const_sites,
                                          dense_scales(k, dense_h, scaled), masked)


def multi_output_kernel(d, device=DEVICE):
    """The prior of the o x o problems: a Matern kernel for d <= 3, a Sum
    (sum_kernel) above, float64."""
    from markovflow_tpu_torch import kernels

    return (getattr(kernels, KERNEL_NAMES[d])(lengthscale=0.5, variance=1.0,
                                             dtype=torch.float64, device=device)
            if d <= 3 else sum_kernel(d, torch.float64, device))


def state_scales(k):
    """The prior's standard deviation of the first state over each
    state's, [d] (numpy)."""
    with torch.no_grad():
        var = torch.diagonal(k.steady_state_covariance).cpu().numpy()
    return np.sqrt(var[0] / var)


def dense_scales(k, dense_h, scaled=True):
    """multi_output_sites' ``dense_h`` for the prior of kernel k: None
    (identity rows), state_scales(k), or with ``scaled=False`` ones: 0.5
    N(0, 1) entries whatever each state's spread (a Matern52's f'', of
    variance ~400, then dominates H x)."""
    if not dense_h:
        return None
    return state_scales(k) if scaled else np.ones(k.state_dim)


def multi_output_uniform_problem(d, o, n, batch, dtype, seed, device=DEVICE,
                                 const_sites=False, dense_h=False, scaled=True, masked=True):
    """The uniform filter's and Koopman backward's inputs at o x o sites:
    the constant Matern prior steps of linspace(0, 100, n) (a Sum's for
    d >= 4, made in float64 and cast), multi_output_sites' H (its first
    step as Hc [o, d, 1]), sites and mask."""
    k = multi_output_kernel(d, device)
    dt = torch.full((1,), 100.0 / max(n - 1, 1), dtype=torch.float64, device=device)
    with torch.no_grad():
        consts = tuple(x.to(dtype) for x in k.prior_const_tl(dt))
    h, nu, lam, maskf = multi_output_sites(d, o, n, batch, dtype, seed, device, const_sites,
                                           dense_scales(k, dense_h, scaled), masked)
    return consts + (h[..., :1].contiguous(), nu, lam, maskf)


def uniform_kernels_take(cs, adj, d, o) -> bool:
    """Whether kernels 1 and 3 take o x o sites at (d, o): o = 2..6 at
    d <= 6 (o > d by the run-time-o sources), o = 1 only above."""
    return d <= adj.UNIFORM_ADJOINT_MAX_STATE_DIM and o <= max(d, cs.UNIFORM_MAX_OUTPUT_DIM)


def multi_output_kernels(cs, adj, d, o, n, batch, dtype, seed, device=DEVICE,
                         const_sites=False, dense_h=False, scaled=True, masked=True):
    """Kernels 1, 3 and 7 (and kernel 4, whose moments kernel 7 reads) at
    o x o sites on multi_output_uniform_problem's and multi_output_problem's
    inputs, beside their plain versions: name -> (kernel output, plain
    output, scale or None), the scale of kernel 3's summed gradients being
    the summed magnitudes of their terms (adjoint_sum_scales); kernel 3
    with and without the site gradients and gHc (ADJ_ASKS), kernel 7 with
    all six outputs and with GPR_NEEDS ("(GPR's)": the lean pass 3).  With
    float32 inputs also the plain versions in float64 on the same inputs:
    name -> float64 output.  The cuda tests and the CPU shim run (tests/)
    take them from here.  At o > d (the run-time-o sources) kernels 1 and 3
    run only to o = cs.UNIFORM_MAX_OUTPUT_DIM, and above d =
    adj.UNIFORM_ADJOINT_MAX_STATE_DIM not at all (kernels 4 and 7 only), as
    their wrappers take them."""
    args = multi_output_uniform_problem(d, o, n, batch, dtype, seed, device, const_sites,
                                        dense_h, scaled, masked)
    gargs = multi_output_problem(d, o, n, batch, dtype, seed, device, const_sites, dense_h,
                                 scaled, masked)
    gscale = torch.linspace(1.0, -0.5, max(1, math.prod(batch)), dtype=dtype,
                            device=device).reshape(batch)
    out, ref = {}, {}
    f32 = dtype == torch.float32
    uniform = uniform_kernels_take(cs, adj, d, o)
    with torch.no_grad():
        if uniform:
            m_p, p_p, ll_p = cs.filter_pipeline_uniform_plain(*args)
            for name, g, w in zip(("uniform m_f", "uniform P_f", "uniform loglik"),
                                  cs.filter_pipeline_uniform(*args), (m_p, p_p, ll_p)):
                out[name] = (g, w, None)
            scales = adjoint_sum_scales(adj, args, m_p, p_p, gscale) + (None, None)
            a_p = adj.adjoint_pipeline_uniform_plain(*args, m_p, p_p, gscale)
            for (site_grads, hc_grad), tail in ADJ_ASKS.items():
                a_k = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gscale,
                                                   site_grads=site_grads, hc_grad=hc_grad)
                asked = (True,) * 5 + (hc_grad,) + (site_grads,) * 2
                assert all((g is not None) == a for g, a in zip(a_k, asked)), tail
                for name, g, w, sc in zip(ADJ_OUT, a_k, a_p, scales):
                    if g is not None:
                        out["uniform " + name + tail] = (g, w, sc)
        gm_p, gp_p, gll_p = cs.filter_pipeline_plain(*gargs)
        for name, g, w in zip(("m_f", "P_f", "loglik"), cs.filter_pipeline(*gargs),
                              (gm_p, gp_p, gll_p)):
            out[name] = (g, w, None)
        ga_p = adj.adjoint_pipeline_plain(*gargs, gm_p, gp_p, gscale)
        for needs, tail in ((None, ""), (GPR_NEEDS, " (GPR's)")):
            kw = {} if needs is None else {"needs": needs}
            for name, g, w in zip(GADJ_OUT, adj.adjoint_pipeline(*gargs, gm_p, gp_p, gscale, **kw),
                                  ga_p):
                if g is not None:
                    out[name + tail] = (g, w, None)
        if f32:
            g64 = [None if x is None else x.double() for x in gargs]
            if uniform:
                a64 = [None if x is None else x.double() for x in args]
                m6, p6, ll6 = cs.filter_pipeline_uniform_plain(*a64)
                a6 = adj.adjoint_pipeline_uniform_plain(*a64, m_p.double(), p_p.double(),
                                                        gscale.double())
                ref.update(zip(("uniform m_f", "uniform P_f", "uniform loglik"), (m6, p6, ll6)))
                ref.update(("uniform " + k + tail, v) for k, v in zip(ADJ_OUT, a6)
                           for tail in ADJ_ASKS.values())
            gm6, gp6, gll6 = cs.filter_pipeline_plain(*g64)
            ga6 = adj.adjoint_pipeline_plain(*g64, gm_p.double(), gp_p.double(),
                                             gscale.double())
            ref.update(zip(("m_f", "P_f", "loglik"), (gm6, gp6, gll6)))
            ref.update((k + tail, v) for k, v in zip(GADJ_OUT, ga6) for tail in ("", " (GPR's)"))
    return out, ref


def natgrad_filter_problem(d, n, batch, seed, device=DEVICE):
    """The general filter's inputs at o = d as the natural-gradient
    inversion makes them (ssm_gaussian_transformations.
    synthetic_filter_inputs_tl), float64: the naturals of a Matern prior on
    a jittered grid (a Sum's for d >= 4) plus those of random sites on the
    first state (precision in [0.1, 5], as a Bernoulli VGP's), so that lam
    is indefinite and ~dt^-3 in scale."""
    from markovflow_tpu_torch import kernels
    from markovflow_tpu_torch.ssm_gaussian_transformations import (
        ssm_to_naturals_tl, synthetic_filter_inputs_tl)

    rng = np.random.default_rng(seed + 19 * d)
    k = (getattr(kernels, KERNEL_NAMES[d])(lengthscale=0.5, variance=1.0,
                                          dtype=torch.float64, device=device)
         if d <= 3 else sum_kernel(d, torch.float64, device))
    tp = torch.as_tensor(jittered_grid(n, seed), device=device)
    with torch.no_grad():
        th_lin, th_diag, th_sub = ssm_to_naturals_tl(k.state_space_model(tp))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)  # noqa: E731
    prec = t(rng.uniform(0.1, 5.0, batch + (n,)))
    th_diag = th_diag - 0.5 * prec[..., None, None, :] * t(np.eye(d, 1) @ np.eye(1, d))[..., None]
    th_lin = th_lin + t(np.eye(d, 1))[..., None] * (prec * t(rng.standard_normal(batch + (n,))))[..., None, None, :]
    return synthetic_filter_inputs_tl(th_lin, th_diag, th_sub.expand(batch + th_sub.shape))


def natgrad_filter_case(cs, n, batch, d):
    """The general filter at o = d on natgrad_filter_problem's indefinite
    sites against its plain version, float64.  These filtered moments are
    ill conditioned: each output passes within TOL_F64 of the plain
    version's, or within COND_FACTOR times the plain version's own change
    when its inputs move by one ulp (random, relative; the larger of two
    draws), the float64 sensitivity of the problem itself."""
    args = natgrad_filter_problem(d, n, batch, seed=n)
    g = torch.Generator(device=args[0].device).manual_seed(n)
    with torch.no_grad():
        got, want = cs.filter_pipeline(*args), cs.filter_pipeline_plain(*args)
        moved = [cs.filter_pipeline_plain(*(
            x * (1.0 + 2.2e-16 * torch.randn(x.shape, generator=g, dtype=x.dtype,
                                              device=x.device)) for x in args))
            for _ in range(2)]
    torch.cuda.synchronize()
    names = ("m_f", "P_f", "loglik")
    diffs = {k: rel_diff(gg, w) for k, gg, w in zip(names, got, want)}
    spread = {k: max(rel_diff(m[i], want[i]) for m in moved) for i, k in enumerate(names)}
    log(f"  general filter o={d} N={n} batch={batch} d={d} float64 natgrad's indefinite "
        f"lam: max rel diff " + " ".join(f"{k}={v:.3e}" for k, v in diffs.items())
        + "; the plain version's one-ulp spread "
        + " ".join(f"{k}={v:.3e}" for k, v in spread.items()))
    for k, v in diffs.items():
        if not (np.isfinite(v) and (v <= TOL_F64 or v <= COND_FACTOR * spread[k])):
            raise AssertionError(f"natgrad sites N={n} d={d}: {k} differs by {v:.3e} > "
                                 f"{TOL_F64:g} and > {COND_FACTOR:g} x the plain version's "
                                 f"one-ulp spread {spread[k]:.3e}")
    return diffs, spread


def multi_output_kernels_case(cs, adj, n, batch, d, o, dtype, const_sites, masked=True,
                              scaled=True):
    """Kernels 1, 3 and 7 (and 4 beside them) at o x o sites against their
    plain versions (multi_output_kernels): per-step sites with a random
    dense H, scaled to the states' spread or not (``scaled``), or GPR's
    stride-0 H and lam (identity rows; kernels 1 and 4 then take their
    rank-o routes), with a mask or, as GPR feeds them, without
    (``masked``); float64 within
    TOL_F64, float32 within TOL_F32_MOMENTS (the log-likelihoods
    TOL_F32_LOGLIK) of the plain version or, against float64, no less
    accurate than it up to F32_NO_WORSE; kernel 3's sums against the
    summed magnitudes of their terms."""
    out, ref = multi_output_kernels(cs, adj, d, o, n, batch, dtype, seed=n, device=DEVICE,
                                    const_sites=const_sites, dense_h=not const_sites,
                                    scaled=scaled, masked=masked)
    torch.cuda.synchronize()
    kernels = "1, 3, 7" if uniform_kernels_take(cs, adj, d, o) else "4, 7"
    tag = (f"kernels {kernels} o={o} N={n} batch={batch} d={d} {str(dtype)[6:]} "
           + ("masked" if masked else "maskless")
           + (" stride-0 H, lam" if const_sites else " dense H per step")
           + ("" if scaled or const_sites else " unscaled"))
    if not ref:
        check(tag, {k: rel_diff(g, w, sc) for k, (g, w, sc) in out.items()},
              dict.fromkeys(out, TOL_F64))
        return
    check_f32_wide(tag, {k: (g, w, ref[k], sc) for k, (g, w, sc) in out.items()},
                   {k: TOL_F32_LOGLIK if k.endswith("loglik") else TOL_F32_MOMENTS
                    for k in out})


def multi_output_case(cs, n, batch, d, o, dtype, const_sites, masked=True):
    """The general filter at o x o sites against its plain version (with a
    mask or, as GPR feeds it, without: ``masked``; stride-0 lam takes the
    rank-o route); in float32 by check_f32_wide's rule."""
    args = multi_output_problem(d, o, n, batch, dtype, seed=n, const_sites=const_sites,
                                masked=masked)
    with torch.no_grad():
        got, want = cs.filter_pipeline(*args), cs.filter_pipeline_plain(*args)
        ref = (cs.filter_pipeline_plain(*(None if x is None else x.double() for x in args))
               if dtype == torch.float32 else None)
    torch.cuda.synchronize()
    tag = (f"general filter o={o} N={n} batch={batch} d={d} {str(dtype)[6:]} "
           + ("masked" if masked else "maskless") + (" stride-0 H, lam" if const_sites else ""))
    names = ("m_f", "P_f", "loglik")
    if ref is None:
        check(tag, {k: rel_diff(g, w) for k, g, w in zip(names, got, want)},
              dict.fromkeys(names, TOL_F64))
    else:
        check_f32_wide(tag, {k: v for k, *v in zip(names, got, want, ref)},
                       {"m_f": TOL_F32_MOMENTS, "P_f": TOL_F32_MOMENTS,
                        "loglik": TOL_F32_LOGLIK})


def filter_scan_random_case(cs, n, batch, d, dtype=torch.float64):
    """The filter-scan kernel against its plain version on random prebuilt
    elements."""
    elems = random_filter_elements(d, n, batch, dtype, DEVICE)
    with torch.no_grad():
        got, want = cs.filter_scan(*elems), cs.filter_scan_plain(*elems)
    torch.cuda.synchronize()
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32_MOMENTS
    check(f"filter scan, random elements N={n} batch={batch} d={d} {str(dtype)[6:]}",
          {"m_f": rel_diff(got[0], want[0]), "P_f": rel_diff(got[1], want[1])},
          {"m_f": tol, "P_f": tol})


def smoother_scan_edges_case(cs, n, d, dtype):
    """The smoother scan against its plain version at N = n, batch (3,), on
    the RTS elements of general_problem's problem with a mask (from the
    plain filter's moments) and on random prebuilt elements."""
    from markovflow_tpu_torch.ops.kalman import smoother_elements_tl

    gargs = general_problem(d, n, (3,), dtype, seed=n, masked=True)
    with torch.no_grad():
        m_p, p_p, _ = cs.filter_pipeline_plain(*gargs)
        inputs = {"RTS": smoother_elements_tl(*gargs[:3], m_p, p_p)[:3],
                  "random": random_smoother_elements(d, n, (3,), dtype, DEVICE, seed=n)}
        outs = {name: (cs.smoother_scan(*e), cs.smoother_scan_plain(*e))
                for name, e in inputs.items()}
    torch.cuda.synchronize()
    diffs = {f"{name} {leg}": rel_diff(k, w) for name, (got, want) in outs.items()
             for leg, k, w in zip(("m_s", "P_s"), got, want)}
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32_MOMENTS
    check(f"smoother scan edges N={n} batch=(3,) d={d} {str(dtype)[6:]}", diffs,
          dict.fromkeys(diffs, tol))


def kernels_vs_plain_case(cs, adj, i, n, batch, d, dtype, masked):
    """Every kernel against its plain version on the problems of case i:
    a uniform-grid and a jittered-grid problem of state dim d, N = n."""
    from markovflow_tpu_torch.ops.kalman import (make_filter_elements_tl,
                                                 smoother_elements_tl)

    f64 = dtype == torch.float64
    tol_m = TOL_F64 if f64 else TOL_F32_MOMENTS
    tol_ll = TOL_F64 if f64 else TOL_F32_LOGLIK
    tag = (f"N={n} batch={batch} d={d} {str(dtype)[6:]}"
           + (" masked" if masked else ""))
    # kernels 1-3 on a uniform grid
    args = uniform_problem(d, n, batch, dtype, seed=i, masked=masked)
    fc, cc, qc = args[:3]
    gscale = torch.linspace(1.0, -0.5, max(1, int(np.prod(batch))),
                            dtype=dtype, device=DEVICE).reshape(batch)
    with_adjoint = d <= adj.UNIFORM_ADJOINT_MAX_STATE_DIM
    with torch.no_grad():
        m_k, p_k, ll_k = cs.filter_pipeline_uniform(*args)
        m_p, p_p, ll_p = cs.filter_pipeline_uniform_plain(*args)
        ms_k, ps_k = cs.smoother_pipeline_uniform(fc, cc, qc, m_p, p_p)
        ms_p, ps_p = cs.smoother_pipeline_uniform_plain(fc, cc, qc, m_p, p_p)
        a_k = a_p = scales = ()
        if with_adjoint:
            a_k = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gscale)
            a_p = adj.adjoint_pipeline_uniform_plain(*args, m_p, p_p, gscale)
            scales = adjoint_sum_scales(adj, args, m_p, p_p, gscale) + (None, None)
    torch.cuda.synchronize()
    diffs = {"m_f": rel_diff(m_k, m_p), "P_f": rel_diff(p_k, p_p),
             "loglik": rel_diff(ll_k, ll_p), "m_s": rel_diff(ms_k, ms_p),
             "P_s": rel_diff(ps_k, ps_p)}
    diffs.update({name: rel_diff(g, w, s) for name, g, w, s in
                  zip(ADJ_OUT, a_k, a_p, scales)})
    tols = {k: tol_m for k in diffs}
    tols["loglik"] = tol_ll
    wide32 = d > adj.UNIFORM_ADJOINT_MAX_STATE_DIM and not f64
    if wide32:
        a64 = [None if x is None else x.double() for x in args]
        with torch.no_grad():
            r_m, r_p, r_ll = cs.filter_pipeline_uniform_plain(*a64)
            r_ms, r_ps = cs.smoother_pipeline_uniform_plain(
                *a64[:3], m_p.double(), p_p.double())
        check_f32_wide("uniform " + tag, {
            "m_f": (m_k, m_p, r_m), "P_f": (p_k, p_p, r_p),
            "loglik": (ll_k, ll_p, r_ll), "m_s": (ms_k, ms_p, r_ms),
            "P_s": (ps_k, ps_p, r_ps)}, tols)
    else:
        check("uniform " + tag, diffs, tols)
    del args, m_k, p_k, m_p, p_p, ms_k, ps_k, ms_p, ps_p, a_k, a_p, scales
    # kernels 4-7 on a jittered grid: the general filter, the smoother
    # scan, the filter scan (of the problem's filtering elements) and the
    # general Koopman backward (all six gradients)
    gargs = general_problem(d, n, batch, dtype, seed=i, masked=masked)
    with torch.no_grad():
        m_k, p_k, ll_k = cs.filter_pipeline(*gargs)
        m_p, p_p, ll_p = cs.filter_pipeline_plain(*gargs)
        elems = smoother_elements_tl(*gargs[:3], m_p, p_p)[:3]
        ms_k, ps_k = cs.smoother_scan(*elems)
        ms_p, ps_p = cs.smoother_scan_plain(*elems)
        felems = make_filter_elements_tl(*gargs[:6])
        fs_k, fs_p = cs.filter_scan(*felems), cs.filter_scan_plain(*felems)
        ga_k = adj.adjoint_pipeline(*gargs, m_p, p_p, gscale)
        ga_p = adj.adjoint_pipeline_plain(*gargs, m_p, p_p, gscale)
    torch.cuda.synchronize()
    outs = {"m_f": (m_k, m_p), "P_f": (p_k, p_p), "loglik": (ll_k, ll_p),
            "m_s": (ms_k, ms_p), "P_s": (ps_k, ps_p), "scan m_f": (fs_k[0], fs_p[0]),
            "scan P_f": (fs_k[1], fs_p[1]), **dict(zip(GADJ_OUT, zip(ga_k, ga_p)))}
    tols = {k: tol_m for k in outs}
    tols["loglik"] = tol_ll
    if wide32:
        g64 = [None if x is None else x.double() for x in gargs]
        with torch.no_grad():
            r_m, r_p, r_ll = cs.filter_pipeline_plain(*g64)
            refs = [r_m, r_p, r_ll, *cs.smoother_scan_plain(*(e.double() for e in elems)),
                    *cs.filter_scan_plain(*(e.double() for e in felems)),
                    *adj.adjoint_pipeline_plain(*g64, m_p.double(), p_p.double(),
                                                gscale.double())]
        check_f32_wide("general " + tag, {k: (kk, pp, r) for (k, (kk, pp)), r
                                          in zip(outs.items(), refs)}, tols)
    else:
        check("general " + tag, {k: rel_diff(kk, pp) for k, (kk, pp) in outs.items()},
              tols)


# ---------------------------------------------------------------------------
# Phase 4
# ---------------------------------------------------------------------------
def flagship_data(n, uniform=True):
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 100.0, n) if uniform else jittered_grid(n, 0)
    y = (np.sin(2.0 * x) + 0.2 * rng.standard_normal(n))[:, None]
    return x, y


def flagship_params(lengthscale=0.5, variance=1.0):
    from markovflow_tpu_torch.utils.bijectors import positive

    return {"kernel.lengthscale": positive().inverse(np.asarray(lengthscale)),
            "kernel.variance": positive().inverse(np.asarray(variance)),
            "chol_obs_covariance": np.asarray([[0.2]])}


def d9_params():
    """The d9 model's parameters under the JAX Sum's attribute paths."""
    from markovflow_tpu_torch.utils.bijectors import positive

    params = {"chol_obs_covariance": np.asarray([[0.2]])}
    for i, (ell, var) in enumerate(D9):
        params[f"kernel.kernels[{i}].lengthscale"] = positive().inverse(np.asarray(ell))
        params[f"kernel.kernels[{i}].variance"] = positive().inverse(np.asarray(var))
    return params


def build_gpr(n, dtype, uniform=True, d9=False):
    """The flagship GPR, or the d9 model (bench.py's d9 config, whose data
    are the flagship's), on a uniform or the jittered grid."""
    from markovflow_tpu_torch.convert import gpr_from_numpy

    x, y = flagship_data(n, uniform)
    model = gpr_from_numpy(d9_params() if d9 else flagship_params(), x, y,
                           device=DEVICE, dtype=dtype,
                           kernel=("Matern52",) * 3 if d9 else "Matern32")
    if model._uniform_grid != uniform:
        raise AssertionError(f"the grid was detected as uniform="
                             f"{model._uniform_grid}, not {uniform}")
    return model


def hyper(model):
    """label -> unconstrained hyperparameter tensor of a model's kernel (a
    factor analysis kernel's latents' and its loading)."""
    k = model.kernel
    if hasattr(k, "_loading"):
        return {**{f"latents[{i}].{name}": getattr(c, name).unconstrained
                   for i, c in enumerate(k._inner.kernels)
                   for name in ("lengthscale", "variance")},
                "loading": k._loading.unconstrained}
    if not hasattr(k, "kernels"):
        return {name: getattr(k, name).unconstrained
                for name in ("lengthscale", "variance")}
    return {f"kernels[{i}].{name}": getattr(c, name).unconstrained
            for i, c in enumerate(k.kernels) for name in ("lengthscale", "variance")}


def load_numpy_oracle(name="numpy_kalman"):
    """tests/tools/<name>.py (the numpy Kalman oracle, or the dense GP),
    loaded by path (its package imports JAX)."""
    path = ROOT / "tests" / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def oracle_steps(model):
    """(mu0, P0, A [N-1, d, d], b [N-1, d], Q [N-1, d, d]) of a float64
    model's prior on its own grid, as numpy arrays for the oracle."""
    with torch.no_grad():
        F, c, Q = (x.cpu().numpy() for x in
                   model.kernel.prior_arrays_tl(model.time_points))
    steps = lambda x: np.moveaxis(x[..., 1:], -1, 0)
    return c[:, 0, 0], Q[..., 0], steps(F), steps(c)[:, :, 0], steps(Q)


def oracle_loglik(npk, model, y):
    mu0, p0, a, b, q = oracle_steps(model)
    h = model.kernel.generate_emission_model(
        model.time_points[:1]).emission_matrix[0].cpu().numpy()
    return npk.kalman_filter(mu0, p0, a, b, q, h, np.asarray([[0.04]]), y)


def check_fd_gradients(npk, n, uniform, d9=False):
    """float64 gradients of the loss at N = n against central differences
    of the numpy oracle's log-likelihood in the unconstrained parameters."""
    model = build_gpr(n, torch.float64, uniform, d9)
    model.loss().backward()
    _, y = flagship_data(n, uniform)
    errs = {}
    for name, p in hyper(model).items():
        got = float(p.grad)
        lls = []
        for sign in (1.0, -1.0):
            with torch.no_grad():
                p.add_(sign * FD_STEP)
                lls.append(oracle_loglik(npk, model, y)[-1])
                p.sub_(sign * FD_STEP)
        want = -(lls[0] - lls[1]) / (2.0 * FD_STEP)
        errs[name] = abs(got - want) / abs(want)
    grid = "uniform" if uniform else "jittered"
    log(f"  N={n} f64 {grid} gradients vs central differences of the numpy "
        f"oracle: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {TOL_FD:g})")
    if not all(v <= TOL_FD for v in errs.values()):
        raise AssertionError("gradients disagree with finite differences")


def check_oracle_values(npk, n, uniform, d9=False):
    """float64 value and marginals at N = n against the numpy oracle."""
    small = build_gpr(n, torch.float64, uniform, d9)
    with torch.no_grad():
        ll = float(small.log_likelihood())
        m_s, p_s = small.kalman.posterior_marginals()
    _, y = flagship_data(n, uniform)
    mf, pf, _, _, ll_ref = oracle_loglik(npk, small, y)
    _, _, a, b, q = oracle_steps(small)
    ms_ref, ps_ref, _ = npk.rts_smoother(mf, pf, a, b, q)
    e_ll = abs(ll - ll_ref) / abs(ll_ref)
    e_m = float(np.abs(m_s.cpu().numpy() - ms_ref).max())
    e_p = float(np.abs(p_s.cpu().numpy() - ps_ref).max())
    grid = "uniform" if uniform else "jittered"
    log(f"  N={n} f64 {grid} vs sequential numpy oracle: loglik rel {e_ll:.3e}, "
        f"m_s abs {e_m:.3e}, P_s abs {e_p:.3e} (tol 1e-9)")
    if not (e_ll <= 1e-9 and e_m <= 1e-9 and e_p <= 1e-9):
        raise AssertionError("the port disagrees with the numpy oracle")


def check_marginals(marginals, n=T_FULL, d=2):
    for m_s, p_s in marginals:
        if m_s.shape != (n, d) or p_s.shape != (n, d, d):
            raise AssertionError(f"bad marginal shapes {m_s.shape} {p_s.shape}")
        if not (torch.isfinite(m_s).all() and torch.isfinite(p_s).all()):
            raise AssertionError("non-finite posterior marginals")


def f32_vs_f64(uniform, d9, loss32, marg32):
    """The float32 loss, marginals and gradients against the same model in
    float64, on the current path: (loss rel diff, marginal m and P diffs
    normwise, per-parameter gradient rel diffs, gradients normwise).  The
    float32 gradients come from a fresh model."""
    n = T_D9 if d9 else T_FULL
    model64 = build_gpr(n, torch.float64, uniform, d9)
    loss64 = model64.loss()
    loss64.backward()
    with torch.no_grad():
        m64, p64 = model64.kalman.posterior_marginals()
    fresh = build_gpr(n, torch.float32, uniform, d9)
    fresh.loss().backward()
    loss32, loss64 = float(loss32.detach()), float(loss64.detach())
    g32 = {k: float(v.grad) for k, v in hyper(fresh).items()}
    g64 = {k: float(v.grad) for k, v in hyper(model64).items()}
    rel_g = {k: abs(g32[k] - g64[k]) / abs(g64[k]) for k in g64}
    norm_g = (max(abs(g32[k] - g64[k]) for k in g64)
              / max(abs(v) for v in g64.values()))
    return (abs(loss32 - loss64) / abs(loss64), loss64,
            rel_diff(marg32[0].double(), m64), rel_diff(marg32[1].double(), p64),
            rel_g, norm_g)


def check_f32_vs_f64(model, uniform, loss32, marg32, d9=False):
    """The float32 model's loss, marginals and gradients against the same
    model in float64 (both on the kernel path); for the d9 model the
    gradients are compared normwise (its six gradients span four orders of
    magnitude) against the measured d9 bounds."""
    rel, loss64, rel_m, rel_p, rel_g, norm_g = f32_vs_f64(uniform, d9, loss32, marg32)
    tol_loss, tol_m, tol_g = ((TOL_D9_F32_VS_F64_LOSS, TOL_D9_F32_MOMENTS,
                               TOL_D9_F32_VS_F64_GRAD) if d9 else
                              (TOL_F32_VS_F64_LOSS, TOL_F32_MOMENTS,
                               TOL_F32_VS_F64_GRAD))
    log(f"  loss (f64) = {loss64!r}; f32 vs f64: loss {rel:.3e} "
        f"(tol {tol_loss:g}); marginals m {rel_m:.3e}, P {rel_p:.3e} "
        f"(tol {tol_m:g}); gradients "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel_g.items())
        + (f", normwise {norm_g:.3e}" if d9 else "") + f" (tol {tol_g:g})")
    if not rel <= tol_loss:
        raise AssertionError(f"f32 loss differs from f64 by {rel:.3e}")
    if not (rel_m <= tol_m and rel_p <= tol_m):
        raise AssertionError("f32 marginals differ from f64")
    if not (norm_g <= tol_g if d9 else all(v <= tol_g for v in rel_g.values())):
        raise AssertionError("f32 gradients differ from f64")
    return rel_g


def check_fit(losses):
    vals = [float(v) for v in losses]
    log(f"  fit losses: {vals!r}")
    if len(vals) != FIT_STEPS or not all(np.isfinite(vals)):
        raise AssertionError(f"bad fit losses {vals}")
    if not all(b < a for a, b in zip(vals, vals[1:])):
        raise AssertionError(f"the fit losses do not decrease: {vals}")


def expect_launches(path, got, want):
    log(f"  launches during {path}: {got}")
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")


def no_launches(**counts):
    """Expected launch counts: the given ones, 0 for every other kernel."""
    return {name: counts.get(name, 0) for _, name in COUNTED}


def phase_serving(cs, adj, npk):
    log(f"phase 4a: GPR serving on a uniform grid at T = {T_FULL}, float32")
    model = build_gpr(T_FULL, torch.float32)
    counts = {}
    with launches_of(cs, adj, counts), torch.no_grad():
        losses = [model.loss() for _ in range(3)]
        marginals = [model.kalman.posterior_marginals() for _ in range(2)]
    expect_launches("the uniform requests", counts,
                    no_launches(filter_pipeline_uniform=5,
                                smoother_pipeline_uniform=2))
    for loss in losses:
        if loss.shape != () or not torch.isfinite(loss):
            raise AssertionError(f"bad loss {loss}")
    check_marginals(marginals)
    log(f"  loss (f32) = {float(losses[0])!r}")
    model64 = build_gpr(T_FULL, torch.float64)
    with torch.no_grad():
        loss64 = model64.loss()
        m64, p64 = model64.kalman.posterior_marginals()
    rel = abs(float(losses[0]) - float(loss64)) / abs(float(loss64))
    rel_m = rel_diff(marginals[0][0].double(), m64)
    rel_p = rel_diff(marginals[0][1].double(), p64)
    log(f"  loss (f64) = {float(loss64)!r}; f32 vs f64 loss rel diff = "
        f"{rel:.3e} (tol {TOL_F32_VS_F64_LOSS:g}); marginals m {rel_m:.3e}, "
        f"P {rel_p:.3e} (tol {TOL_F32_MOMENTS:g})")
    if not rel <= TOL_F32_VS_F64_LOSS:
        raise AssertionError(f"f32 loss differs from f64 by {rel:.3e}")
    if not (rel_m <= TOL_F32_MOMENTS and rel_p <= TOL_F32_MOMENTS):
        raise AssertionError("f32 marginals differ from f64")
    check_oracle_values(npk, 500, uniform=True)
    return model, counts


def phase_training_uniform(cs, adj, training, npk):
    log(f"phase 4b: GPR training on a uniform grid at T = {T_FULL}, float32")
    model = build_gpr(T_FULL, torch.float32)
    counts = {}
    with launches_of(cs, adj, counts):
        _, losses = training.fit(model, num_steps=FIT_STEPS)
    expect_launches(f"{FIT_STEPS} uniform fit steps", counts,
                    no_launches(filter_pipeline_uniform=FIT_STEPS,
                                adjoint_pipeline_uniform=FIT_STEPS))
    check_fit(losses)
    fresh = build_gpr(T_FULL, torch.float32)
    loss32 = fresh.loss()
    with torch.no_grad():
        marg32 = fresh.kalman.posterior_marginals()
    rel_g = check_f32_vs_f64(fresh, True, loss32, marg32)
    check_fd_gradients(npk, 500, uniform=True)
    return counts, rel_g


def phase_general(cs, adj, training, npk):
    log(f"phase 4c: GPR on a jittered grid at T = {T_FULL}, float32")
    model = build_gpr(T_FULL, torch.float32, uniform=False)
    counts = {}
    with launches_of(cs, adj, counts):
        with torch.no_grad():
            loss = model.loss()
            marginals = [model.kalman.posterior_marginals()]
        _, losses = training.fit(model, num_steps=FIT_STEPS)
    expect_launches(f"a loss, marginals and {FIT_STEPS} fit steps", counts,
                    no_launches(filter_pipeline=2 + FIT_STEPS, smoother_scan=1,
                                adjoint_pipeline=FIT_STEPS))
    if loss.shape != () or not torch.isfinite(loss):
        raise AssertionError(f"bad loss {loss}")
    check_marginals(marginals)
    check_fit(losses)
    log(f"  loss (f32) = {float(loss)!r}")
    rel_g = check_f32_vs_f64(model, False, loss, marginals[0])
    check_oracle_values(npk, 500, uniform=False)
    check_fd_gradients(npk, 500, uniform=False)
    return counts, rel_g


def phase_d9(cs, adj, kf, training, npk):
    """The d9 model at T = 1e5, float32, on the kernel path; returns the
    launch counts of its three paths."""
    log(f"phase 4d: the d9 model (Sum of three Matern52, state dim 9) at "
        f"T = {T_D9}, float32")
    counts = {}
    model = build_gpr(T_D9, torch.float32, d9=True)
    counts["d9 serving"] = {}
    with launches_of(cs, adj, counts["d9 serving"]), torch.no_grad():
        loss = model.loss()
        marginals = model.kalman.posterior_marginals()
    expect_launches("a d9 loss() and posterior_marginals()", counts["d9 serving"],
                    no_launches(filter_pipeline=1, filter_pipeline_uniform=1,
                                smoother_pipeline_uniform=1))
    if loss.shape != () or not torch.isfinite(loss):
        raise AssertionError(f"bad loss {loss}")
    check_marginals([marginals], T_D9, 9)
    log(f"  loss (f32) = {float(loss)!r}")
    check_f32_vs_f64(model, True, loss, marginals, d9=True)
    fit_model = build_gpr(T_D9, torch.float32, d9=True)
    counts["d9 training"] = {}
    with launches_of(cs, adj, counts["d9 training"]):
        _, losses = training.fit(fit_model, num_steps=FIT_STEPS)
    expect_launches(f"{FIT_STEPS} d9 fit steps", counts["d9 training"],
                    no_launches(filter_pipeline=FIT_STEPS, adjoint_pipeline=FIT_STEPS))
    check_fit(losses)
    jit = build_gpr(T_D9, torch.float32, uniform=False, d9=True)
    counts["d9 jittered"] = {}
    with launches_of(cs, adj, counts["d9 jittered"]):
        jloss = jit.loss()
        jloss.backward()
        with torch.no_grad():
            jmarg = jit.kalman.posterior_marginals()
    expect_launches("a d9 jittered loss().backward() and posterior_marginals()",
                    counts["d9 jittered"],
                    no_launches(filter_pipeline=2, smoother_scan=1,
                                adjoint_pipeline=1))
    check_marginals([jmarg], T_D9, 9)
    log(f"  jittered loss (f32) = {float(jloss.detach())!r}")
    check_f32_vs_f64(jit, False, jloss, jmarg, d9=True)
    # the same comparison on the plain path: what the reference's formulas
    # give in float32, without the kernels
    with plain_path(cs, adj, kf):
        for uniform in (True, False):
            plain = build_gpr(T_D9, torch.float32, uniform, d9=True)
            ploss = plain.loss()
            with torch.no_grad():
                pmarg = plain.kalman.posterior_marginals()
            rel, _, rel_m, rel_p, rel_g, norm_g = f32_vs_f64(uniform, True, ploss, pmarg)
            log(f"  plain path, {'uniform' if uniform else 'jittered'} grid: f32 vs "
                f"f64 loss {rel:.3e}; marginals m {rel_m:.3e}, P {rel_p:.3e}; "
                f"gradients " + ", ".join(f"{k} {v:.3e}" for k, v in rel_g.items())
                + f", normwise {norm_g:.3e}")
    for uniform in (True, False):
        check_oracle_values(npk, 500, uniform, d9=True)
        check_fd_gradients(npk, 500, uniform, d9=True)
    return counts


def ops_inputs(model):
    """A model's prior steps, emission and sites in the time-middle layout
    of the ops API: F [N, d, d], c [N, d], Q [N, d, d], H [N, 1, d],
    nu [N, 1], lam [N, 1, 1]; and the same in the time-last layout."""
    kal = model.kalman
    with torch.no_grad():
        F, c, Q = kal.prior_tl
        H = kal._emission_tl()
        nu, lam, _ = kal._site_nats_tl()
    tl = (F, c, Q, H, nu, lam)
    tm = lambda x: x.movedim(-1, -3)            # noqa: E731
    vec = lambda x: x[..., 0, :].movedim(-1, -2)  # noqa: E731
    return (tm(F), vec(c), tm(Q), tm(H), vec(nu), tm(lam)), tl


def sparse_sites_run(kf, dtype, x, y, idx):
    """KalmanFilterWithSparseSites for the flagship's kernel on the grid x
    with sites at x[idx] (y / 0.04, precision 1 / 0.04): the loss
    -log_likelihood(), after its backward, and the gradients of the
    kernel's two hyperparameters and of the sites' two naturals."""
    from markovflow_tpu_torch import kernels

    k = kernels.Matern32(lengthscale=0.5, variance=1.0, dtype=dtype, device=DEVICE)
    tp = torch.as_tensor(x, dtype=dtype, device=DEVICE)
    nat1 = torch.as_tensor(y[idx, None] / 0.04, dtype=dtype, device=DEVICE)
    nat2 = torch.full((idx.size, 1, 1), -0.5 / 0.04, dtype=dtype, device=DEVICE)
    nat1.requires_grad_(True)
    nat2.requires_grad_(True)
    f = kf.KalmanFilterWithSparseSites(
        k.generate_emission_model(tp), kf.UnivariateGaussianSitesNat(nat1, nat2),
        x.size, torch.as_tensor(idx, device=DEVICE), None,
        prior_tl=k.prior_arrays_tl(tp))
    loss = -f.log_likelihood()
    loss.backward()
    return loss.detach(), [k.lengthscale.unconstrained.grad,
                           k.variance.unconstrained.grad, nat1.grad, nat2.grad]


def phase_ops(cs, adj, kf):
    """The ops filter API through the filter-scan kernel and the sparse-site
    filter through the general Koopman backward; returns the launch counts
    of its paths."""
    from markovflow_tpu_torch.ops import kalman

    log(f"phase 4e: the ops filter API and the sparse-site filter on the jittered "
        f"grid, float32")
    counts = {}
    for path, n, d9 in (("ops", T_FULL, False), ("ops d9", T_D9, True)):
        model = build_gpr(n, torch.float32, uniform=False, d9=d9)
        args, tl = ops_inputs(model)
        counts[path] = {}
        with launches_of(cs, adj, counts[path]), torch.no_grad():
            m_f, p_f = kalman.parallel_filter(kalman.make_filter_elements(*args))
        expect_launches(f"parallel_filter at T = {n}" + (" (d9)" if d9 else ""),
                        counts[path], no_launches(filter_scan=1))
        d = model.kernel.state_dim
        if m_f.shape != (n, d) or p_f.shape != (n, d, d):
            raise AssertionError(f"bad filtered shapes {m_f.shape} {p_f.shape}")
        with torch.no_grad():
            gm, gp, _ = cs.filter_pipeline(*tl)
            args64, _ = ops_inputs(build_gpr(n, torch.float64, uniform=False, d9=d9))
            m64, p64 = kalman.parallel_filter(kalman.make_filter_elements(*args64))
        tol = TOL_D9_F32_MOMENTS if d9 else TOL_F32_MOMENTS
        check(f"T={n} d={d} parallel_filter vs the general filter kernel, and vs f64",
              {"m_f": rel_diff(m_f, gm[..., 0, :].movedim(-1, -2)),
               "P_f": rel_diff(p_f, gp.movedim(-1, -3)),
               "m_f f64": rel_diff(m_f.double(), m64),
               "P_f f64": rel_diff(p_f.double(), p64)},
              {"m_f": tol, "P_f": tol, "m_f f64": tol, "P_f f64": tol})
    x, y = flagship_data(T_FULL, uniform=False)
    idx = np.sort(np.random.default_rng(1).choice(T_FULL, int(0.7 * T_FULL),
                                                  replace=False))
    counts["sparse"] = {}
    with launches_of(cs, adj, counts["sparse"]):
        loss, grads = sparse_sites_run(kf, torch.float32, x, y[:, 0], idx)
    expect_launches("a sparse-site -log_likelihood().backward()", counts["sparse"],
                    no_launches(filter_pipeline=1, adjoint_pipeline=1))
    if not (torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)):
        raise AssertionError("non-finite sparse-site loss or gradients")
    loss64, grads64 = sparse_sites_run(kf, torch.float64, x, y[:, 0], idx)
    diffs = {"loss": rel_diff(loss.double(), loss64)}
    diffs.update({name: rel_diff(g.double(), w) for name, g, w in
                  zip(("lengthscale", "variance", "nat1", "nat2"), grads, grads64)})
    log(f"  sparse sites: {idx.size} of {T_FULL} grid points observed; "
        f"loss (f64) = {float(loss64)!r}")
    check("sparse sites f32 vs f64", diffs,
          {"loss": TOL_F32_VS_F64_LOSS, "lengthscale": TOL_F32_VS_F64_GRAD,
           "variance": TOL_F32_VS_F64_GRAD, "nat1": TOL_F32_MOMENTS,
           "nat2": TOL_F32_MOMENTS})
    return counts


# ---------------------------------------------------------------------------
# Phase 4f
# ---------------------------------------------------------------------------
def prediction_points(n_new, x, seed=0, end=100.0):
    """n_new new time points from seed: 98% uniform in [0, end], 1% equal
    to training points x (exact hits), 0.5% in [-5, 0) and 0.5% in
    (end, end + 5]; and the slice of each kind."""
    rng = np.random.default_rng(seed)
    n_hit, n_side = n_new // 100, n_new // 200
    n_in = n_new - n_hit - 2 * n_side
    pts = np.concatenate([rng.uniform(0.0, end, n_in),
                          x[rng.choice(x.size, n_hit, replace=False)],
                          rng.uniform(-5.0, 0.0, n_side),
                          end + 5.0 - 5.0 * rng.random(n_side)])
    edges = np.cumsum([0, n_in, n_hit, n_side, n_side])
    kinds = {k: slice(int(a), int(b)) for k, a, b in
             zip(("inner", "hits", "left", "right"), edges[:-1], edges[1:])}
    return pts, kinds


def predictions(post, tn):
    """predict_f's mean and variance and predict_y's variance, [N*] each."""
    f_mean, f_var = post.predict_f(tn)
    _, y_var = post.predict_y(tn)
    return {"f mean": f_mean[..., 0], "f var": f_var[..., 0], "y var": y_var[..., 0]}


def check_finite(tag, outs):
    bad = {k: int((~torch.isfinite(v)).sum()) for k, v in outs.items()}
    if any(bad.values()):
        raise AssertionError(f"{tag}: non-finite predictions {bad}")


def posterior_run(cs, adj, counts, path, model, tn, expect):
    """gpr.posterior with the launch counters set to 0 just before it
    (one filter and one smoother launch expected), then predict_f and
    predict_y at tn (no launch); returns (posterior, predictions)."""
    counts[path] = {}
    with launches_of(cs, adj, counts[path]), torch.no_grad():
        post = model.posterior
    expect_launches(f"{path}: gpr.posterior", counts[path], no_launches(**expect))
    got = {}
    with launches_of(cs, adj, got), torch.no_grad():
        outs = predictions(post, tn)
    expect_launches(f"{path}: predict_f, predict_y", got, no_launches())
    return post, outs


def rebuild_error(post):
    """The posterior SSM's covariances rebuilt from its clamped factors by
    the affine scan (the JAX package's route) against the smoother's, which
    the port's predictions read: max abs difference over max entry."""
    with torch.no_grad():
        _, rebuilt = post.dist.rebuilt_marginals_tl()
        _, exact = post.dist.marginals_tl()
    return rel_diff(rebuilt.double(), exact.double())


def plain_predictions(cs, adj, kf, model, tn):
    with plain_path(cs, adj, kf), torch.no_grad():
        return predictions(model.posterior, tn)


def phase_prediction(cs, adj, kf, dense):
    """GPR's posterior, predict_f, predict_y and sample_f on both grids at
    T = 1e6 (the flagship) and on the jittered grid at T = 1e5 (the d9
    model), float32 and float64; the linear mean function; condense; and
    float64 against a dense GP at N = 500."""
    log(f"phase 4f: posterior and prediction at T = {T_FULL} (flagship) and "
        f"T = {T_D9} (d9 model), float32 and float64")
    counts = {}
    for uniform in (True, False):
        grid = "uniform" if uniform else "jittered"
        x, _ = flagship_data(T_FULL, uniform)
        pts, kinds = prediction_points(N_NEW, x)
        expect = ({"filter_pipeline_uniform": 1, "smoother_pipeline_uniform": 1} if uniform
                  else {"filter_pipeline": 1, "smoother_scan": 1})
        outs, plain = {}, {}
        for dtype in (torch.float64, torch.float32):
            name = str(dtype)[6:]
            model = build_gpr(T_FULL, dtype, uniform)
            tn = torch.as_tensor(pts, dtype=dtype, device=DEVICE)
            post, outs[dtype] = posterior_run(cs, adj, counts, f"posterior {grid} {name}",
                                              model, tn, expect)
            check_finite(f"{grid} {name}", outs[dtype])
            plain[dtype] = plain_predictions(cs, adj, kf, model, tn)
            log(f"  {grid} {name}: {N_NEW} points; the posterior SSM's covariances "
                f"rebuilt from its factors vs the smoother's: {rebuild_error(post):.3e}")
            if dtype == torch.float64:
                check(f"{grid} float64 predictions, kernel path vs plain path",
                      {k: rel_diff(outs[dtype][k], plain[dtype][k]) for k in outs[dtype]},
                      dict.fromkeys(outs[dtype], TOL_F64))
                if uniform:
                    check_sampling(post, tn[kinds["inner"]][:N_SAMPLE_POINTS])
            else:
                sample_run(cs, adj, post, tn[:N_SAMPLE_POINTS])
            del model, post
        for kind, sl in kinds.items():
            errs = {k: rel_diff(outs[torch.float32][k][sl].double(),
                                outs[torch.float64][k][sl]) for k in outs[torch.float32]}
            log(f"  {grid} f32 vs f64 at the {kind} points: "
                + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
        check_f32_wide(f"{grid} predictions f32 (kernel / plain) vs f64",
                       {k: (outs[torch.float32][k], plain[torch.float32][k],
                            outs[torch.float64][k]) for k in outs[torch.float32]},
                       dict.fromkeys(outs[torch.float32], TOL_F32_MOMENTS))
    counts.update(d9_prediction(cs, adj, kf))
    counts.update(linear_mean_run(cs, adj, kf))
    counts.update(condense_run(cs, adj, kf))
    for uniform in (True, False):
        check_dense_gp(dense, uniform)
    return counts


def sample_run(cs, adj, post, tn):
    """sample_f with SAMPLES draws at tn, from a seeded generator on the
    card: no launch, finite, of the expected shape."""
    got = {}
    g = torch.Generator(device=DEVICE).manual_seed(0)
    with launches_of(cs, adj, got), torch.no_grad():
        draws = post.sample_f(tn, SAMPLES, generator=g)
    expect_launches(f"sample_f ({SAMPLES} draws at {tn.numel()} points)", got,
                    no_launches())
    if draws.shape != (SAMPLES, tn.numel(), 1) or not torch.isfinite(draws).all():
        raise AssertionError(f"bad draws {tuple(draws.shape)}")


def check_sampling(post, tn):
    """The mean and variance of SAMPLE_CALLS x SAMPLES draws of sample_f
    at each point within 5 standard errors of predict_f's."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    with torch.no_grad():
        draws = torch.cat([post.sample_f(tn, SAMPLES, generator=g)[..., 0]
                           for _ in range(SAMPLE_CALLS)])
        mean, var = (v[..., 0] for v in post.predict_f(tn))
    n = draws.shape[0]
    z_mean = float(((draws.mean(0) - mean).abs() / torch.sqrt(var / n)).max())
    z_var = float(((draws.var(0) - var).abs() / (var * math.sqrt(2.0 / (n - 1)))).max())
    log(f"  sample_f: {n} draws at {tn.numel()} points; largest |mean - predict_f| "
        f"{z_mean:.2f} standard errors, |variance - predict_f| {z_var:.2f} (bound 5)")
    if not (z_mean <= 5.0 and z_var <= 5.0):
        raise AssertionError("sample_f's moments disagree with predict_f")


def d9_prediction(cs, adj, kf):
    """The d9 model's posterior (the general filter and the smoother scan
    on the jittered grid) and predict_f at N_NEW_D9 points.  Between the
    grid points the reference's generic Matern52 process noise
    P_inf - A P_inf A^T has no digits left at these sub-grid steps, in
    float64 too, and the conditional statistics invert it (ROADMAP queue
    3): there the predictions are counted, non-finite ones included, and
    printed.  The exact hits (the smoother's moments) and the points past
    either end are checked: finite, float64 against the smoother's
    marginals and the plain path, float32 against float64 by the rule."""
    counts = {}
    x, _ = flagship_data(T_D9, uniform=False)
    pts, kinds = prediction_points(N_NEW_D9, x)
    held = np.r_[kinds["hits"], kinds["left"], kinds["right"]]
    outs, plain = {}, {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        model = build_gpr(T_D9, dtype, uniform=False, d9=True)
        tn = torch.as_tensor(pts, dtype=dtype, device=DEVICE)
        post, outs[dtype] = posterior_run(cs, adj, counts, f"d9 posterior {name}", model,
                                          tn, {"filter_pipeline": 1, "smoother_scan": 1})
        plain[dtype] = plain_predictions(cs, adj, kf, model, tn)
        inner = {k: int((~torch.isfinite(v[kinds["inner"]])).sum())
                 for k, v in outs[dtype].items()}
        log(f"  d9 {name}: non-finite predictions between the grid points: {inner}; "
            f"rebuilt covariances vs the smoother's: {rebuild_error(post):.3e}")
        check_finite(f"d9 {name} exact hits and ends",
                     {k: v[held] for k, v in outs[dtype].items()})
        if dtype == torch.float64:
            with torch.no_grad():
                m_s, p_s = model.kalman.posterior_marginals()
                h = model.kernel.generate_emission_model(model.time_points[:1]).emission_matrix[0]
            idx = torch.as_tensor(np.searchsorted(x, pts[kinds["hits"]]), device=DEVICE)
            hit_mean = (m_s[idx] * h[0]).sum(-1)
            hit_var = (h[0] * (p_s[idx] * h[0]).sum(-1)).sum(-1)
            check("d9 float64 at the exact hits vs the smoother's marginals",
                  {"f mean": rel_diff(outs[dtype]["f mean"][kinds["hits"]], hit_mean),
                   "f var": rel_diff(outs[dtype]["f var"][kinds["hits"]], hit_var)},
                  {"f mean": TOL_F64, "f var": TOL_F64})
            diffs = {k: rel_diff(v[held], plain[dtype][k][held]) for k, v in outs[dtype].items()}
            log("  d9 float64 between the grid points, kernel path vs plain path: "
                + " ".join(f"{k}={finite_rel_diff(v[kinds['inner']], plain[dtype][k][kinds['inner']])}"
                           for k, v in outs[dtype].items()))
            check("d9 float64 at the exact hits and ends, kernel path vs plain path", diffs,
                  dict.fromkeys(diffs, TOL_F64))
        del model, post
    log("  d9 f32 vs f64 between the grid points: " + " ".join(
        f"{k}={finite_rel_diff(v[kinds['inner']].double(), outs[torch.float64][k][kinds['inner']])}"
        for k, v in outs[torch.float32].items()))
    check_f32_wide("d9 predictions f32 (kernel / plain) vs f64 at the exact hits and ends",
                   {k: (v[held], plain[torch.float32][k][held],
                        outs[torch.float64][k][held]) for k, v in outs[torch.float32].items()},
                   dict.fromkeys(outs[torch.float32], TOL_D9_F32_MOMENTS))
    return counts


def finite_rel_diff(got, want) -> str:
    """rel_diff over the entries finite on both sides, and how many those
    are, for the log."""
    ok = torch.isfinite(got) & torch.isfinite(want)
    if not bool(ok.any()):
        return f"none of {ok.numel()} finite"
    return f"{rel_diff(got[ok], want[ok]):.3e} over {int(ok.sum())} of {ok.numel()}"


def linear_mean_run(cs, adj, kf):
    """The flagship at T = 1e6 with the linear mean function 0.01 t on data
    y + 0.01 t: loss() and the posterior's predict_f; in float64 the loss
    equals the flagship's on y and predict_f's mean is the flagship's plus
    0.01 t, within 1e-9; float32 against float64."""
    from markovflow_tpu_torch.convert import gpr_from_numpy

    counts = {}
    x, y = flagship_data(T_FULL)
    pts, _ = prediction_points(N_NEW, x)
    params = {**flagship_params(), "mean_function.coefficient": np.asarray(COEF)}
    outs, losses, plain = {}, {}, {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        model = gpr_from_numpy(params, x, y + COEF * x[:, None], device=DEVICE, dtype=dtype,
                               mean_function="Linear")
        tn = torch.as_tensor(pts, dtype=dtype, device=DEVICE)
        path = f"linear mean {name}"
        counts[path] = {}
        with launches_of(cs, adj, counts[path]), torch.no_grad():
            losses[dtype] = model.loss()
            outs[dtype] = predictions(model.posterior, tn)
        expect_launches(f"{path}: loss() and predict_f", counts[path],
                        no_launches(filter_pipeline_uniform=2, smoother_pipeline_uniform=1))
        check_finite(path, outs[dtype])
        plain[dtype] = plain_predictions(cs, adj, kf, model, tn)
        if dtype == torch.float64:
            base = build_gpr(T_FULL, dtype)
            with torch.no_grad():
                base_loss = base.loss()
                base_f = predictions(base.posterior, tn)
            check("linear mean float64 vs the flagship on y",
                  {"loss": rel_diff(losses[dtype], base_loss),
                   "f mean": rel_diff(outs[dtype]["f mean"] - COEF * tn, base_f["f mean"]),
                   "f var": rel_diff(outs[dtype]["f var"], base_f["f var"])},
                  {"loss": TOL_F64, "f mean": TOL_F64, "f var": TOL_F64})
            del base
        del model
    rel = abs(float(losses[torch.float32]) - float(losses[torch.float64])) / abs(
        float(losses[torch.float64]))
    log(f"  linear mean: loss f32 vs f64 {rel:.3e} (tol {TOL_F32_VS_F64_LOSS:g})")
    if not rel <= TOL_F32_VS_F64_LOSS:
        raise AssertionError("linear mean: f32 loss differs from f64")
    check_f32_wide("linear mean predictions f32 (kernel / plain) vs f64",
                   {k: (v, plain[torch.float32][k], outs[torch.float64][k])
                    for k, v in outs[torch.float32].items()},
                   dict.fromkeys(outs[torch.float32], TOL_F32_MOMENTS))
    return counts


def sparse_filter(kf, dtype, x, y, idx):
    """Phase 4e's sparse-site filter (the flagship's kernel on the grid x,
    sites at x[idx]), without gradients."""
    from markovflow_tpu_torch import kernels

    k = kernels.Matern32(lengthscale=0.5, variance=1.0, dtype=dtype, device=DEVICE)
    tp = torch.as_tensor(x, dtype=dtype, device=DEVICE)
    nat1 = torch.as_tensor(y[idx, None] / 0.04, dtype=dtype, device=DEVICE)
    nat2 = torch.full((idx.size, 1, 1), -0.5 / 0.04, dtype=dtype, device=DEVICE)
    return kf.KalmanFilterWithSparseSites(
        k.generate_emission_model(tp), kf.UnivariateGaussianSitesNat(nat1, nat2),
        x.size, torch.as_tensor(idx, device=DEVICE), None,
        prior_tl=k.prior_arrays_tl(tp))


def condense_run(cs, adj, kf):
    """condense() on phase 4e's sparse-site problem (70% of 1e6 jittered
    grid points observed): the condensed filter's log_likelihood (the
    general filter on the M observed points) against the grid filter's,
    float64 within 1e-9 relative; float32 against float64 by the rule."""
    counts = {}
    x, y = flagship_data(T_FULL, uniform=False)
    idx = np.sort(np.random.default_rng(1).choice(T_FULL, int(0.7 * T_FULL),
                                                  replace=False))
    lls, plain = {}, {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        f = sparse_filter(kf, dtype, x, y[:, 0], idx)
        path = f"condense {name}"
        counts[path] = {}
        with launches_of(cs, adj, counts[path]), torch.no_grad():
            cond = f.condense()
            lls[dtype] = cond.log_likelihood()
        expect_launches(f"{path}: condense() and its log_likelihood()", counts[path],
                        no_launches(filter_pipeline=1))
        with torch.no_grad():
            grid_ll = f.log_likelihood()
            with plain_path(cs, adj, kf):
                plain[dtype] = f.condense().log_likelihood()
        rel = rel_diff(lls[dtype], grid_ll)
        log(f"  condense {name}: {idx.size} of {T_FULL} points; log-likelihood "
            f"{float(lls[dtype])!r}, the grid filter's {float(grid_ll)!r} (rel {rel:.3e})")
        if dtype == torch.float64 and not rel <= TOL_F64:
            raise AssertionError(f"condensed log-likelihood differs by {rel:.3e}")
        del f, cond
    check_f32_wide("condensed log-likelihood f32 (kernel / plain) vs f64",
                   {"loglik": (lls[torch.float32], plain[torch.float32], lls[torch.float64])},
                   {"loglik": TOL_F32_VS_F64_LOSS})
    return counts


def check_dense_gp(dense, uniform):
    """float64 predict_f and predict_y at N = 500 against the dense GP in
    numpy (tests/tools/dense_gp.py), within 1e-8."""
    n = 500
    model = build_gpr(n, torch.float64, uniform)
    x, y = flagship_data(n, uniform)
    pts, _ = prediction_points(1000, x)
    with torch.no_grad():
        got = predictions(model.posterior, torch.as_tensor(pts, dtype=torch.float64,
                                                          device=DEVICE))
    mean, cov, _ = dense.dense_posterior([("Matern32", 0.5, 1.0)], 0.04, x, y[:, 0], pts)
    var = np.diag(cov)
    errs = {"f mean": float(np.abs(got["f mean"].cpu().numpy() - mean).max()),
            "f var": float(np.abs(got["f var"].cpu().numpy() - var).max()),
            "y var": float(np.abs(got["y var"].cpu().numpy() - var - 0.04).max())}
    check(f"N={n} f64 {'uniform' if uniform else 'jittered'} predictions vs the dense GP "
          f"(max abs)", errs, dict.fromkeys(errs, 1e-8))


# ---------------------------------------------------------------------------
# Phase 4g
# ---------------------------------------------------------------------------
def cvi_targets(x, likelihood, rng):
    """Observations at x for a likelihood: y = sin(2x) + 0.2 N (Gaussian,
    bench config 4), (sin(2x) + 0.3 N > 0) (Bernoulli, the VGP config's
    rule, benchmarks/run_all.py:198-200) or Poisson counts of rate
    exp(sin(2x)) (tests/integration/models/test_cvi.py)."""
    f = np.sin(2.0 * x)
    if likelihood == "Gaussian":
        y = f + 0.2 * rng.standard_normal(x.size)
    elif likelihood == "Bernoulli":
        y = (f + 0.3 * rng.standard_normal(x.size) > 0).astype(np.float64)
    else:
        y = rng.poisson(np.exp(f)).astype(np.float64)
    return y[:, None]


def cvi_data(n, likelihood="Gaussian", uniform=True, seed=None):
    """Bench config 4's grid, linspace(0, CVI_END, n) or its jittered twin,
    and observations from ``seed`` (by default CVI_SEEDS[likelihood])."""
    x = (np.linspace(0.0, CVI_END, n) if uniform
         else jittered_grid(n, 0, end=CVI_END))
    seed = CVI_SEEDS[likelihood] if seed is None else seed
    return x, cvi_targets(x, likelihood, np.random.default_rng(seed))


def build_cvi(n, dtype, likelihood="Gaussian", uniform=True, lr=CVI_LR, seed=None):
    """Bench config 4's CVI (Matern32(0.5, 1), Gaussian likelihood of
    variance 0.04, learning rate 0.5), or the same kernel with another
    likelihood, from the JAX initial sites."""
    from markovflow_tpu_torch.convert import cvi_from_numpy
    from markovflow_tpu_torch.utils.bijectors import positive

    x, y = cvi_data(n, likelihood, uniform, seed)
    params = {**flagship_params(),
              "likelihood.variance": positive().inverse(np.asarray(0.04))}
    model = cvi_from_numpy(params, x, y, dtype=dtype, device=DEVICE,
                           likelihood=likelihood, learning_rate=lr)
    if model._uniform_grid != uniform:
        raise AssertionError(f"the grid was detected as uniform={model._uniform_grid}")
    return model


def cvi_iterations(model, iters):
    """``iters`` full iterations (update_sites(), then loss().backward());
    the ELBO and the kernel's hyperparameter gradients of each, and the
    sites after the last."""
    elbos, grads = [], []
    for _ in range(iters):
        model.update_sites()
        for p in model.parameters():
            p.grad = None
        loss = model.loss()
        loss.backward()
        elbos.append(float(-loss.detach()))
        grads.append({k: float(v.grad) for k, v in hyper(model).items()})
    sites = tuple(x.detach() for x in model.sites.natural_parameters)
    return elbos, grads, sites


def rel_list(got, want, floor=0.0):
    """The largest |a - b| / max(|b|, floor) over the pairs."""
    return max(abs(a - b) / max(abs(b), floor) for a, b in zip(got, want))


def rel_grads(got, want):
    return max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want) for k in w)


def cvi_config4(cs, adj, kf, uniform):
    """Bench config 4 at T = 1e6 on one grid: CVI_ITERS full iterations in
    float64 and float32 on the kernel path (launch counts), float64 on the
    plain path; the f32 sites' first marginals against the prior's."""
    grid = "uniform" if uniform else "jittered"
    expect = ({"filter_pipeline_uniform": 2, "smoother_pipeline_uniform": 1,
               "adjoint_pipeline_uniform": 1} if uniform else
              {"filter_pipeline": 2, "smoother_scan": 1, "adjoint_pipeline": 1})
    counts, runs = {}, {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        model = build_cvi(T_FULL, dtype, uniform=uniform)
        if dtype == torch.float32:
            first_marginals(cs, adj, model, grid)
        path = f"cvi {grid} {name}"
        counts[path] = {}
        with launches_of(cs, adj, counts[path]):
            runs[dtype] = cvi_iterations(model, CVI_ITERS)
        expect_launches(f"{path}: {CVI_ITERS} iterations", counts[path],
                        no_launches(**{k: v * CVI_ITERS for k, v in expect.items()}))
        log(f"  {path}: ELBO {runs[dtype][0]!r}")
        del model
    with plain_path(cs, adj, kf):
        plain = cvi_iterations(build_cvi(T_FULL, torch.float64, uniform=uniform), CVI_ITERS)
    (e64, g64, s64), (e32, g32, s32) = runs[torch.float64], runs[torch.float32]
    check(f"cvi {grid} float64, kernel path vs plain path ({CVI_ITERS} iterations)",
          {"ELBO": rel_list(e64, plain[0]), "gradients": rel_grads(g64, plain[1]),
           "nat1": rel_diff(s64[0], plain[2][0]), "lam": rel_diff(s64[1], plain[2][1])},
          dict.fromkeys(("ELBO", "gradients", "nat1", "lam"), TOL_F64))
    # the ELBO is a sum of T terms of order one; in the first iterations
    # they cancel (the ELBO crosses zero), so its float32 error is measured
    # against T where T exceeds it
    check(f"cvi {grid} float32 vs float64 (check_f32_vs_f64's rule; the ELBO "
          f"over max(|ELBO|, T))",
          {"ELBO": rel_list(e32, e64, T_FULL), "gradients": rel_grads(g32, g64),
           "nat1": rel_diff(s32[0].double(), s64[0]), "lam": rel_diff(s32[1].double(), s64[1])},
          {"ELBO": TOL_F32_VS_F64_LOSS, "gradients": TOL_F32_VS_F64_GRAD,
           "nat1": TOL_F32_MOMENTS, "lam": TOL_F32_MOMENTS})
    return counts


def first_marginals(cs, adj, model, grid):
    """q(f) from the initial sites (precision 2e-10, below float32's
    resolution against the prior's variance 1): the prior's marginals,
    mean 0 and variance 1, on the kernel path."""
    got = {}
    with launches_of(cs, adj, got), torch.no_grad():
        f_mu, f_var = model._f_marginals()
    want = ({"filter_pipeline_uniform": 1, "smoother_pipeline_uniform": 1}
            if grid == "uniform" else {"filter_pipeline": 1, "smoother_scan": 1})
    expect_launches(f"cvi {grid} float32: the first marginals", got, no_launches(**want))
    check(f"cvi {grid} float32: the first marginals vs the prior's (max abs)",
          {"f mean": float(f_mu.abs().max()), "f var": float((f_var - 1.0).abs().max())},
          {"f mean": TOL_CVI_FIRST_F32, "f var": TOL_CVI_FIRST_F32})


def cvi_exactness(uniform):
    """Learning rate 1 and a Gaussian likelihood: one update puts the
    exact likelihood factors in the sites, so elbo() is the GPR's
    log_likelihood() and the posteriors agree (float64)."""
    from markovflow_tpu_torch.convert import gpr_from_numpy

    grid = "uniform" if uniform else "jittered"
    x, y = cvi_data(T_FULL, uniform=uniform)
    cvi = build_cvi(T_FULL, torch.float64, uniform=uniform, lr=1.0).update_sites()
    gpr = gpr_from_numpy(flagship_params(), x, y, device=DEVICE, dtype=torch.float64)
    pts, _ = prediction_points(N_NEW, x, end=CVI_END)
    tn = torch.as_tensor(pts, dtype=torch.float64, device=DEVICE)
    with torch.no_grad():
        elbo, ll = cvi.elbo(), gpr.log_likelihood()
        fc, vc = cvi.posterior.predict_f(tn)
        fg, vg = gpr.posterior.predict_f(tn)
    log(f"  cvi {grid} lr = 1: ELBO {float(elbo)!r}, GPR log-likelihood {float(ll)!r}")
    check(f"cvi {grid} lr = 1, one update, vs GPR (float64; predict_f at {N_NEW} points)",
          {"ELBO": rel_diff(elbo, ll), "f mean": rel_diff(fc, fg), "f var": rel_diff(vc, vg)},
          dict.fromkeys(("ELBO", "f mean", "f var"), TOL_F64))


def sites_of(model, nat1, lam):
    """``model`` at the sites (nat1, lam), cast to its dtype."""
    dtype = model.observations.dtype
    model.sites = model.sites.replace_nats(nat1.to(dtype), -0.5 * lam.to(dtype))
    return model


def held_marginals(cs, adj, kf, model, twin, tag):
    """q(f) at ``model``'s float32 sites from the kernels, held against the
    plain version in float32 and in float64 (``twin``) at the same sites
    by check_f32_wide.  These kernel launches are a comparison's and fall
    outside every count."""
    with torch.no_grad():
        got = model._f_marginals()
        with plain_path(cs, adj, kf):
            plain = model._f_marginals()
            ref = sites_of(twin, *model.sites.natural_parameters)._f_marginals()
    check_f32_wide(tag, {"f mean": (got[0], plain[0], ref[0]),
                         "f var": (got[1], plain[1], ref[1])},
                   dict.fromkeys(("f mean", "f var"), TOL_F32_MOMENTS))


def non_gaussian_run(cs, adj, model, counts, pts, y_new, hold=None):
    """CVI_UPDATES site updates (launches counted into ``counts``), the
    classic ELBO after each from the fifth, then the ELBO, the sites,
    predict_log_density at pts and the posterior's process-noise factors'
    zero pivots (where psd_cholesky clamped Q_post).  ``hold``: (kf, the
    float64 twin, tag) to hold each update's float32 marginals
    (``held_marginals``)."""
    classic = []
    with torch.no_grad():
        for i in range(CVI_UPDATES):
            if hold is not None:
                kf, twin, tag = hold
                held_marginals(cs, adj, kf, model, twin, f"{tag}, update {i + 1}: q(f)")
            got = {}
            with launches_of(cs, adj, got):
                model.update_sites()
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
            if i >= 4:
                classic.append(float(model.classic_elbo()))
        dtype = model.observations.dtype
        pld = model.predict_log_density((torch.as_tensor(pts, dtype=dtype, device=DEVICE),
                                         torch.as_tensor(y_new, dtype=dtype, device=DEVICE)))
        chol_q = model.dist_q.cholesky_process_covariances
        clamped = int((torch.diagonal(chol_q, dim1=-2, dim2=-1) == 0).any(-1).sum())
        return {"classic": classic, "ELBO": float(model.elbo()), "pld": pld,
                "sites": [x.detach() for x in model.sites.natural_parameters],
                "clamped": clamped}


def f32_elbo_parts(cs, adj, kf, likelihood, runs):
    """The float32 ELBO against float64's after CVI_UPDATES updates, in two
    parts for each path: its evaluation at the path's own float32 sites
    against float64 at the same sites (held within TOL_F32_VS_F64_LOSS),
    and what those sites move the float64 ELBO by (printed, with lam's
    elementwise relative error: a few sites far off carry the ELBO's
    error, ROADMAP queue 3).  All over max(|ELBO|, T): the ELBO crosses
    zero in the first iterations."""
    ref = runs[torch.float64][1]
    twin = build_cvi(T_FULL, torch.float64, likelihood)
    lam64 = ref["sites"][1]
    log(f"  cvi {likelihood} float64: {int((lam64 < 0).sum())} sites of negative precision")
    for tag, run in zip(("kernel", "plain"), runs[torch.float32]):
        with torch.no_grad(), plain_path(cs, adj, kf):
            at = float(sites_of(twin, *run["sites"]).elbo())
        rel = (run["sites"][1].double() - lam64).abs() / lam64.abs()
        log(f"  cvi {likelihood} float32 ({tag} path): ELBO vs float64 "
            f"{rel_list([run['ELBO']], [ref['ELBO']], T_FULL):.3e}; its float32 sites move the "
            f"float64 ELBO by {rel_list([at], [ref['ELBO']], T_FULL):.3e}; lam's elementwise "
            f"relative error: median {float(rel.median()):.3e}, max {float(rel.max()):.3e}")
        check(f"cvi {likelihood} float32 ({tag} path): the ELBO at its own float32 sites vs "
              f"float64 at the same sites (over max(|ELBO|, T))",
              {"ELBO": rel_list([run["ELBO"]], [at], T_FULL)}, {"ELBO": TOL_F32_VS_F64_LOSS})


def cvi_non_gaussian(cs, adj, kf, likelihood):
    """CVI_UPDATES site updates on the uniform grid at T = 1e6 in float64
    and float32 on the kernel path and the plain path, the classic ELBO
    after each from the fifth.  Float64: the classic ELBO falls by no more
    than TOL_ELBO_FALL relative, and the kernel path is within TOL_F64 of
    the plain path.  Float32: each update's marginals (``held_marginals``),
    the sites and predict_log_density (at N_PLD points) after the last
    against the float64 plain run (check_f32_wide), and the ELBO's
    evaluation (``f32_elbo_parts``).  The float32 classic ELBO's KL takes
    the log-det of the posterior's process noise, whose factor psd_cholesky
    clamps to 0 where Q_post ~ dt^3 lies below float32's roundoff (ROADMAP
    queue 3): its non-finite values are counted and printed."""
    counts, runs = {}, {}
    x, _ = cvi_data(T_FULL, likelihood)
    pts, _ = prediction_points(N_PLD, x, end=CVI_END)
    y_new = cvi_targets(pts, likelihood, np.random.default_rng(7))
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        path = f"cvi {likelihood} {name}"
        counts[path] = {}
        hold = (None if dtype == torch.float64 else
                (kf, build_cvi(T_FULL, torch.float64, likelihood), f"{path} kernel path"))
        kernel = non_gaussian_run(cs, adj, build_cvi(T_FULL, dtype, likelihood),
                                  counts[path], pts, y_new, hold)
        expect_launches(f"{path}: {CVI_UPDATES} site updates", counts[path],
                        no_launches(filter_pipeline_uniform=CVI_UPDATES,
                                    smoother_pipeline_uniform=CVI_UPDATES))
        with plain_path(cs, adj, kf):
            plain = non_gaussian_run(cs, adj, build_cvi(T_FULL, dtype, likelihood), {},
                                     pts, y_new)
        runs[dtype] = (kernel, plain)
        for tag, run in (("kernel", kernel), ("plain", plain)):
            log(f"  {path} ({tag} path): classic ELBO after updates 5..{CVI_UPDATES} "
                f"{run['classic']!r}; ELBO {run['ELBO']!r}; mean predict_log_density at "
                f"{N_PLD} points {float(run['pld'].mean())!r}; steps whose Q_post factor "
                f"has a clamped pivot: {run['clamped']}")
        check_finite(path, {"nat1": kernel["sites"][0], "lam": kernel["sites"][1],
                            "ELBO": torch.as_tensor(kernel["ELBO"]),
                            "predict_log_density": kernel["pld"]})
        if kernel["pld"].shape != (N_PLD,):
            raise AssertionError(f"predict_log_density has shape {tuple(kernel['pld'].shape)}")
        if dtype == torch.float64:
            check_finite(f"{path} classic ELBO", {"classic": torch.as_tensor(kernel["classic"])})
            c = kernel["classic"]
            falls = [(a - b) / abs(a) for a, b in zip(c, c[1:])]
            log(f"  {path}: largest relative fall of the classic ELBO {max(falls):.3e} "
                f"(tol {TOL_ELBO_FALL:g}; negative: it rose at every update)")
            if not max(falls) <= TOL_ELBO_FALL:
                raise AssertionError(f"{path}: the classic ELBO falls")
            check(f"{path}, kernel path vs plain path ({CVI_UPDATES} updates)",
                  {"ELBO": rel_list([kernel["ELBO"]], [plain["ELBO"]]),
                   "classic ELBO": rel_list(kernel["classic"], plain["classic"]),
                   "nat1": rel_diff(kernel["sites"][0], plain["sites"][0]),
                   "lam": rel_diff(kernel["sites"][1], plain["sites"][1])},
                  dict.fromkeys(("ELBO", "classic ELBO", "nat1", "lam"), TOL_F64))
        else:
            bad = {tag: sum(not np.isfinite(v) for v in run["classic"])
                   for tag, run in (("kernel", kernel), ("plain", plain))}
            log(f"  {path}: non-finite classic ELBOs (the KL's log-det of clamped "
                f"Q_post factors; ROADMAP queue 3): kernel path {bad['kernel']}, plain path "
                f"{bad['plain']} of {len(kernel['classic'])}")
    (k32, p32), ref = runs[torch.float32], runs[torch.float64][1]
    check_f32_wide(f"cvi {likelihood} float32 after {CVI_UPDATES} updates, against the "
                   f"float64 plain run",
                   {"nat1": (k32["sites"][0], p32["sites"][0], ref["sites"][0]),
                    "lam": (k32["sites"][1], p32["sites"][1], ref["sites"][1]),
                    "predict_log_density": (k32["pld"], p32["pld"], ref["pld"])},
                   dict.fromkeys(("nat1", "lam", "predict_log_density"), TOL_F32_MOMENTS))
    f32_elbo_parts(cs, adj, kf, likelihood, runs)
    return counts


def phase_cvi(cs, adj, kf):
    """Bench config 4 (CVI) at T = 1e6 on both grids, the exactness check
    against GPR, and the Bernoulli and Poisson likelihoods."""
    log(f"phase 4g: CVI (bench config 4) at T = {T_FULL}, float32 and float64")
    counts = {}
    for uniform in (True, False):
        counts.update(cvi_config4(cs, adj, kf, uniform))
        cvi_exactness(uniform)
    for likelihood in ("Bernoulli", "Poisson"):
        counts.update(cvi_non_gaussian(cs, adj, kf, likelihood))
    return counts


# ---------------------------------------------------------------------------
# Phase 4h
# ---------------------------------------------------------------------------
def sde_problem(dtype, n):
    """Bench config 5 (benchmarks/run_all.py:135-183): DoubleWellSDE(q=0.5)
    on linspace(0, 8, n + 1), the truth by Euler-Maruyama from x0 = 1 and
    observations with noise 0.2, both drawn in float64 from a seeded
    generator on the card and cast; the initial path N(0, 1) at the n
    points after the first, the initial state N(1, 0.25)."""
    from markovflow_tpu_torch import sde as sde_mod

    kw = dict(dtype=torch.float64, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(7)
    ts = torch.as_tensor(np.linspace(0.0, 8.0, n + 1), **kw)
    truth = sde_mod.euler_maruyama(sde_mod.DoubleWellSDE(q=0.5, **kw),
                                   torch.ones((1, 1), **kw), ts, g)[0]
    obs = truth + 0.2 * torch.randn(truth.shape, generator=g, **kw)
    kw["dtype"] = dtype
    ts = ts.to(dtype)
    return {"sde": sde_mod.DoubleWellSDE(q=0.5, **kw), "ts": ts,
            "obs": obs.to(dtype)[None], "dt": float(ts[1] - ts[0]),
            "path": sde_mod.Gaussian(torch.zeros((1, n, 1), **kw),
                                     torch.ones((1, n, 1, 1), **kw)),
            "init": sde_mod.Gaussian(torch.ones((1, 1), **kw),
                                     0.25 * torch.ones((1, 1, 1), **kw)),
            "emission": torch.ones((1, n + 1, 1, 1), **kw),
            "chol": torch.full((1, 1), 0.2, **kw)}


def sde_iteration(kf, prob, path):
    """One VI iteration of bench config 5: linearize_sde along the path,
    the Kalman filter of the linearised prior, its posterior state-space
    model (the general filter and the smoother scan), the posterior's
    linear drift and the KL surrogate.  Returns (KL, the posterior's path
    at the path's points after the first)."""
    from markovflow_tpu_torch import sde as sde_mod
    from markovflow_tpu_torch.emission_model import EmissionModel

    prior = sde_mod.linearize_sde(prob["sde"], prob["ts"], path, prob["init"])
    post = kf.KalmanFilter(EmissionModel(prob["emission"]), prob["obs"], prob["chol"],
                           prior_tl=prior.prior_tl()).posterior_state_space_model()
    means, covs = post.marginals
    drift = sde_mod.LinearDrift.from_ssm(post, prob["dt"])
    kl = sde_mod.squared_drift_difference_along_Gaussian_path(
        prob["sde"], sde_mod.LinearDrift(A=drift.A[0, :, :, 0], b=drift.b[0]),
        sde_mod.Gaussian(means[0, 1:], covs[0, 1:]), prob["dt"])
    return kl, sde_mod.Gaussian(means[..., 1:, :], covs[..., 1:, :, :])


def sde_vi(kf, prob):
    """SDE_ITERS iterations from the initial path, each from the last's
    posterior path: the KLs and the last path."""
    kls, path = [], prob["path"]
    with torch.no_grad():
        for _ in range(SDE_ITERS):
            kl, path = sde_iteration(kf, prob, path)
            kls.append(float(kl))
    return kls, path


def phase_sde(cs, adj, kf):
    """Bench config 5 (SDE variational inference) at n = SDE_N in float64
    and float32 on the kernel path, float64 on the plain path."""
    log(f"phase 4h: SDE VI (bench config 5, DoubleWell) at n = {SDE_N}, float32 and float64")
    counts, runs = {}, {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        prob = sde_problem(dtype, SDE_N)
        path = f"sde {name}"
        counts[path] = {}
        with launches_of(cs, adj, counts[path]):
            runs[dtype] = sde_vi(kf, prob)
        expect_launches(f"{path}: {SDE_ITERS} VI iterations", counts[path],
                        no_launches(filter_pipeline=SDE_ITERS, smoother_scan=SDE_ITERS))
        kls, q = runs[dtype]
        log(f"  {path}: KL by iteration {kls!r}")
        check_finite(path, {"KL": torch.as_tensor(kls), "mean": q.mu, "var": q.cov})
        if not kls[-1] < kls[0]:
            raise AssertionError(f"{path}: the KL does not fall from iteration 1 to {SDE_ITERS}")
        if dtype == torch.float64:
            with plain_path(cs, adj, kf):
                pkls, pq = sde_vi(kf, prob)
            check("sde float64, kernel path vs plain path",
                  {"KL": rel_list(kls, pkls), "mean": rel_diff(q.mu, pq.mu),
                   "var": rel_diff(q.cov, pq.cov)}, dict.fromkeys(("KL", "mean", "var"), TOL_F64))
    (k64, q64), (k32, q32) = runs[torch.float64], runs[torch.float32]
    check("sde float32 vs float64", {"KL": rel_list(k32, k64),
                                     "mean": rel_diff(q32.mu.double(), q64.mu),
                                     "var": rel_diff(q32.cov.double(), q64.cov)},
          {"KL": TOL_SDE_F32_KL, "mean": TOL_F32_MOMENTS, "var": TOL_F32_MOMENTS})
    return counts


def vgp_config2(n):
    """Bench config 2 (benchmarks/run_all.py:186-220): a VGP with
    Matern32(0.5, 1) and a Bernoulli likelihood of the labels
    sin(2x) + 0.3 N(0, 1) > 0 on linspace(0, n / 1000, n) (numpy seed 1),
    float64, on the card."""
    from markovflow_tpu_torch import kernels, likelihoods
    from markovflow_tpu_torch.models import VariationalGaussianProcess

    rng = np.random.default_rng(1)
    x = np.linspace(0.0, n / 1000.0, n)
    y = (np.sin(2.0 * x) + 0.3 * rng.standard_normal(n) > 0).astype(np.float64)[:, None]
    k = kernels.Matern32(lengthscale=0.5, variance=1.0, dtype=torch.float64, device=DEVICE)
    vgp = VariationalGaussianProcess((x, torch.as_tensor(y, device=DEVICE)), k,
                                     likelihoods.Bernoulli())
    return vgp, lambda m: m.loss()


def svgp_config3(n, m):
    """Bench config 3 (benchmarks/run_all.py:223-257): an SVGP with
    Matern32(0.5, 1), a Gaussian likelihood of variance 0.04, the data
    y = sin(2x) + 0.2 N(0, 1) on linspace(0, n / 1000, n) (numpy seed 2)
    and m inducing points on linspace(-0.01, n / 1000 + 0.01, m), float64,
    on the card."""
    from markovflow_tpu_torch import kernels, likelihoods
    from markovflow_tpu_torch.models import SparseVariationalGaussianProcess

    kw = dict(dtype=torch.float64, device=DEVICE)
    rng = np.random.default_rng(2)
    span = n / 1000.0
    x = np.linspace(0.0, span, n)
    y = np.sin(2.0 * x) + 0.2 * rng.standard_normal(n)
    data = (torch.as_tensor(x, **kw), torch.as_tensor(y[:, None], **kw))
    svgp = SparseVariationalGaussianProcess(
        kernels.Matern32(lengthscale=0.5, variance=1.0, **kw),
        likelihoods.Gaussian(variance=0.04, **kw),
        torch.as_tensor(np.linspace(-0.01, span + 0.01, m), **kw))
    return svgp, lambda mm: mm.loss(data)


def natgrad_steps(model, loss_of, steps, engine="parallel"):
    """``steps`` natural-gradient steps (gamma NG_GAMMA) of q from the
    model's initial q: the SSMs after each step."""
    from markovflow_tpu_torch.ssm_natgrad import SSMNaturalGradient

    opt = SSMNaturalGradient(gamma=NG_GAMMA, naturals_engine=engine)
    step = opt.make_step(lambda s: loss_of(model.with_dist_q(s)))
    ssm, state, out = model.dist_q.non_trainable_copy(), None, []
    for _ in range(steps):
        ssm, state, _ = step(ssm, state)
        out.append(ssm)
    return out


def elbo_of(model, loss_of, ssm) -> float:
    with torch.no_grad():
        return -float(loss_of(model.with_dist_q(ssm)))


def ssm_diffs(got, want) -> dict:
    """Two SSMs' fields, each on its largest entry (the offsets on the
    means'), and their marginals."""
    with torch.no_grad():
        (mg, pg), (mw, pw) = got.marginals, want.marginals
        return {"mu0": rel_diff(got.initial_mean, want.initial_mean),
                "chol_P0": rel_diff(got.cholesky_initial_covariance,
                                    want.cholesky_initial_covariance),
                "A": rel_diff(got.state_transitions, want.state_transitions),
                "b": rel_diff(got.state_offsets, want.state_offsets, mw),
                "chol_Q": rel_diff(got.cholesky_process_covariances,
                                   want.cholesky_process_covariances),
                "means": rel_diff(mg, mw), "covs": rel_diff(pg, pw)}


def phase_natgrad(cs, adj, kf):
    """Bench configs 2 and 3 at full size in float64: NG_STEPS natural-
    gradient steps on the kernel path (kernels 4 at o = d = 2 and 5, once
    each a step), the ELBO rising; the first step against the plain path;
    and at N = NG_SMALL_N the parallel engine against the sequential
    one."""
    log(f"phase 4i: natural gradients, VGP (bench config 2, T = {NG_T}) and SVGP "
        f"(bench config 3, N = {NG_T}, M = {NG_M}), float64")
    counts = {}
    for path, (model, loss_of) in (("natgrad vgp", vgp_config2(NG_T)),
                                   ("natgrad svgp", svgp_config3(NG_T, NG_M))):
        counts[path] = {}
        with launches_of(cs, adj, counts[path]):
            ssms = natgrad_steps(model, loss_of, NG_STEPS)
        expect_launches(f"{path}: {NG_STEPS} steps", counts[path],
                        no_launches(filter_pipeline=NG_STEPS, smoother_scan=NG_STEPS))
        elbos = [elbo_of(model, loss_of, s)
                 for s in [model.dist_q.non_trainable_copy()] + ssms]
        log(f"  {path}: ELBO at q0 and after each step {elbos!r}")
        if not all(b > a for a, b in zip(elbos, elbos[1:])):
            raise AssertionError(f"{path}: the ELBO does not rise at every step")
        with torch.no_grad():
            check_finite(path, {"means": ssms[-1].marginal_means,
                                "covs": ssms[-1].marginal_covariances})
        with plain_path(cs, adj, kf):
            plain = natgrad_steps(model, loss_of, 1)[0]
        diffs = ssm_diffs(ssms[0], plain)
        diffs["ELBO"] = abs(elbos[1] - elbo_of(model, loss_of, plain)) / abs(elbos[1])
        check(f"{path}: one step, kernel path vs plain path", diffs,
              {**dict.fromkeys(diffs, TOL_NG), "ELBO": TOL_NG_ELBO})
    for path, (model, loss_of) in (("natgrad vgp", vgp_config2(NG_SMALL_N)),
                                   ("natgrad svgp", svgp_config3(NG_SMALL_N, NG_SMALL_N // 2))):
        par, seq = (natgrad_steps(model, loss_of, 1, engine)[0]
                    for engine in ("parallel", "sequential"))
        diffs = ssm_diffs(par, seq)
        e_par, e_seq = elbo_of(model, loss_of, par), elbo_of(model, loss_of, seq)
        diffs["ELBO"] = abs(e_par - e_seq) / abs(e_seq)
        check(f"{path} at N = {NG_SMALL_N}: one step, parallel engine (kernels) vs "
              f"sequential engine", diffs, {**dict.fromkeys(diffs, TOL_NG), "ELBO": TOL_NG_ELBO})
    return counts


# ---------------------------------------------------------------------------
# Phase 4j
# ---------------------------------------------------------------------------
def mo3_data(n, uniform=True):
    """mo3's data: x as the flagship's, y [n, 3] of sin(2x), sin(x) and
    sin(x / 2) plus noise of MO3_CHOL's covariance, from seed 0."""
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 100.0, n) if uniform else jittered_grid(n, 0)
    f = np.stack([np.sin(2.0 * x / 2.0 ** i) for i in range(3)], axis=-1)
    return x, f + rng.standard_normal((n, 3)) @ np.asarray(MO3_CHOL).T


def mo3_params():
    """mo3's parameters under the JAX IndependentMultiOutput's paths."""
    from markovflow_tpu_torch.utils.bijectors import positive

    params = {"chol_obs_covariance": np.asarray(MO3_CHOL)}
    for i, (ell, var) in enumerate(MO3):
        params[f"kernel.kernels[{i}].lengthscale"] = positive().inverse(np.asarray(ell))
        params[f"kernel.kernels[{i}].variance"] = positive().inverse(np.asarray(var))
    return params


def build_mo3(n, dtype, uniform=True, device=None):
    """The multi-output GPR mo3 on a uniform or the jittered grid, on
    ``device`` (DEVICE unless given)."""
    from markovflow_tpu_torch.convert import gpr_from_numpy

    x, y = mo3_data(n, uniform)
    model = gpr_from_numpy(mo3_params(), x, y, device=device or DEVICE, dtype=dtype,
                           kernel=MO3_SPEC)
    if model._uniform_grid != uniform:
        raise AssertionError(f"the grid was detected as uniform={model._uniform_grid}")
    return model


def gpr_outputs(model, tn):
    """A float64 or float32 multi-output GPR model's (mo3, fa12, fa6c) loss,
    gradients, smoothed marginals and, from gpr.posterior, predict_f
    (diagonal and full output covariances) and predict_y at tn: name ->
    tensor (gradients by hyperparameter under "grad ...")."""
    loss = model.loss()
    loss.backward()
    out = {"loss": loss.detach()}
    out.update((f"grad {k}", v.grad.clone()) for k, v in hyper(model).items())
    with torch.no_grad():
        out["marginal means"], out["marginal covs"] = model.kalman.posterior_marginals()
        post = model.posterior
        out["f mean"], out["f var"] = post.predict_f(tn)
        _, out["f cov"] = post.predict_f(tn, full_output_cov=True)
        out["y mean"], out["y cov"] = post.predict_y(tn)
    return out


def mo3_oracle(npk, model, y):
    """The numpy oracle's filter of a float64 mo3 model at its grid: H [3, 6],
    R = L L^T [3, 3]."""
    mu0, p0, a, b, q = oracle_steps(model)
    h = model.kernel.generate_emission_model(
        model.time_points[:1]).emission_matrix[0].cpu().numpy()
    chol = np.asarray(MO3_CHOL)
    return npk.kalman_filter(mu0, p0, a, b, q, h, chol @ chol.T, y), (a, b, q)


def check_mo3_oracle(npk, n, uniform):
    """float64 mo3 at N = n against the numpy oracle: log-likelihood and
    smoothed marginals within 1e-9, gradients within TOL_FD of central
    differences of the oracle's log-likelihood."""
    model = build_mo3(n, torch.float64, uniform)
    _, y = mo3_data(n, uniform)
    loss = model.loss()
    loss.backward()
    with torch.no_grad():
        m_s, p_s = model.kalman.posterior_marginals()
    (mf, pf, _, _, ll_ref), (a, b, q) = mo3_oracle(npk, model, y)
    ms_ref, ps_ref, _ = npk.rts_smoother(mf, pf, a, b, q)
    errs = {"loglik": abs(-float(loss.detach()) - ll_ref) / abs(ll_ref),
            "m_s": float(np.abs(m_s.cpu().numpy() - ms_ref).max()),
            "P_s": float(np.abs(p_s.cpu().numpy() - ps_ref).max())}
    fd = {}
    for name, prm in hyper(model).items():
        lls = []
        for sign in (1.0, -1.0):
            with torch.no_grad():
                prm.add_(sign * FD_STEP)
                lls.append(mo3_oracle(npk, model, y)[0][-1])
                prm.sub_(sign * FD_STEP)
        want = -(lls[0] - lls[1]) / (2.0 * FD_STEP)
        fd[name] = abs(float(prm.grad) - want) / abs(want)
    grid = "uniform" if uniform else "jittered"
    check(f"mo3 N={n} f64 {grid} vs the numpy oracle", errs, dict.fromkeys(errs, 1e-9))
    check(f"mo3 N={n} f64 {grid} gradients vs central differences of the oracle", fd,
          dict.fromkeys(fd, TOL_FD))


def phase_multi_output(cs, adj, kf, training, npk):
    """The multi-output slice mo3 (IndependentMultiOutput of three Matern32,
    d = 6, o = 3, a full noise Cholesky) at T = 1e6 on both grids, float32
    and float64: serving (loss() and posterior_marginals()), a loss and its
    backward, gpr.posterior with predict_f (both output covariances) and
    predict_y at 1e5 new points and sample_f, and FIT_STEPS fit steps in
    float32, each with its launch counts (kernels 1, 2, 3 on the uniform
    grid, 4, 5, 7 on the jittered one, every one at o = 3 but the
    smoothers); float64 against the plain path, float32 against float64,
    float64 at N = 500 against the numpy oracle; and a Product kernel's loss
    and gradient."""
    log(f"phase 4j: multi-output GPR mo3 (IndependentMultiOutput of three Matern32, "
        f"d = 6, o = 3) at T = {T_FULL}, float32 and float64")
    counts = {}
    for uniform in (True, False):
        grid = "uniform" if uniform else "jittered"
        filt, smooth, back = (("filter_pipeline_uniform", "smoother_pipeline_uniform",
                               "adjoint_pipeline_uniform") if uniform else
                              ("filter_pipeline", "smoother_scan", "adjoint_pipeline"))
        x, _ = mo3_data(T_FULL, uniform)
        pts, _ = prediction_points(N_NEW, x)
        outs = {}
        for dtype in (torch.float64, torch.float32):
            name = str(dtype)[6:]
            model = build_mo3(T_FULL, dtype, uniform)
            tn = torch.as_tensor(pts, dtype=dtype, device=DEVICE)
            path = f"mo3 {grid} {name}"
            counts[path] = {}
            with launches_of(cs, adj, counts[path]):
                outs[name] = gpr_outputs(model, tn)
            # loss + backward; marginals; gpr.posterior
            expect_launches(f"{path}: loss, backward, marginals, posterior", counts[path],
                            no_launches(**{filt: 3, back: 1, smooth: 2}))
            check_finite(path, {k: v for k, v in outs[name].items()})
            with torch.no_grad():
                draws = model.posterior.sample_f(
                    tn[:N_SAMPLE_POINTS], SAMPLES,
                    generator=torch.Generator(device=DEVICE).manual_seed(0))
            if draws.shape != (SAMPLES, N_SAMPLE_POINTS, 3):
                raise AssertionError(f"{path}: sample_f shape {tuple(draws.shape)}")
            check_finite(path + " sample_f", {"draws": draws})
            if dtype == torch.float32:
                fpath = f"mo3 {grid} training {name}"
                counts[fpath] = {}
                with launches_of(cs, adj, counts[fpath]):
                    _, losses = training.fit(model, num_steps=FIT_STEPS)
                expect_launches(f"{fpath}: {FIT_STEPS} fit steps", counts[fpath],
                                no_launches(**{filt: FIT_STEPS, back: FIT_STEPS}))
                check_fit(losses)
            del model
        log(f"  mo3 {grid}: loss (f64) = {float(outs['float64']['loss'])!r}, "
            f"(f32) = {float(outs['float32']['loss'])!r}")
        with plain_path(cs, adj, kf):
            tn = torch.as_tensor(pts, dtype=torch.float64, device=DEVICE)
            plain = gpr_outputs(build_mo3(T_FULL, torch.float64, uniform), tn)
        k64, k32 = outs["float64"], outs["float32"]
        check(f"mo3 {grid} f64: kernel path vs plain path",
              {k: rel_diff(k64[k], plain[k]) for k in plain}, dict.fromkeys(plain, TOL_F64))
        grads = [k for k in k64 if k.startswith("grad")]
        gscale = torch.stack([k64[k].abs() for k in grads]).max()
        diffs = {k: rel_diff(k32[k].double(), k64[k], gscale if k in grads else None)
                 for k in k64}
        tols = {k: (TOL_MO3_F32_LOSS if k == "loss" else TOL_MO3_F32_GRAD if k in grads
                    else TOL_MO3_F32_MOMENTS) for k in k64}
        check(f"mo3 {grid}: f32 vs f64 on the kernel path (gradients normwise)", diffs, tols)
        del outs, plain
        check_mo3_oracle(npk, 500, uniform)
    counts.update(product_run(cs, adj, kf))
    return counts


def product_run(cs, adj, kf):
    """A Product of Matern12(0.7, 1.3) and Matern32(1.1, 0.4) (d = 2, o = 1)
    at T = PRODUCT_T on the uniform grid, float64: loss() and its backward
    through kernels 1 and 3, against the plain path."""
    from markovflow_tpu_torch.convert import gpr_from_numpy
    from markovflow_tpu_torch.utils.bijectors import positive

    x, y = flagship_data(PRODUCT_T)
    params = {"chol_obs_covariance": np.asarray([[0.2]])}
    for i, (ell, var) in enumerate(((0.7, 1.3), (1.1, 0.4))):
        params[f"kernel.kernels[{i}].lengthscale"] = positive().inverse(np.asarray(ell))
        params[f"kernel.kernels[{i}].variance"] = positive().inverse(np.asarray(var))
    spec = ("Product", ("Matern12", "Matern32"))
    runs, counts = {}, {"product": {}}
    for tag, ctx in (("kernel", launches_of(cs, adj, counts["product"])),
                     ("plain", plain_path(cs, adj, kf))):
        with ctx:
            model = gpr_from_numpy(params, x, y, device=DEVICE, dtype=torch.float64,
                                   kernel=spec)
            loss = model.loss()
            loss.backward()
        runs[tag] = {"loss": loss.detach(),
                     **{f"grad {k}": v.grad for k, v in hyper(model).items()}}
    expect_launches("product: loss and backward", counts["product"],
                    no_launches(filter_pipeline_uniform=1, adjoint_pipeline_uniform=1))
    check(f"product Matern12 x Matern32 T={PRODUCT_T} f64: kernel path vs plain path",
          {k: rel_diff(runs["kernel"][k], runs["plain"][k]) for k in runs["plain"]},
          dict.fromkeys(runs["plain"], TOL_F64))
    return counts


# ---------------------------------------------------------------------------
# Phase 4k
# ---------------------------------------------------------------------------
def fa_weights(o, periods=None):
    """A factor analysis weight function on torch time points [..., N]:
    A(t) = diag(1 + 0.5 sin(2 pi t / p_i)) [..., N, o, o] for the given
    periods, or the identity expanded along time (stride 0: a constant
    emission)."""
    def weight_fn(t):
        eye = torch.eye(o, dtype=t.dtype, device=t.device)
        if periods is None:
            return eye.expand(tuple(t.shape) + (o, o))
        p = torch.as_tensor(periods, dtype=t.dtype, device=t.device)
        return (1.0 + 0.5 * torch.sin(2.0 * math.pi * t[..., None] / p))[..., :, None] * eye
    return weight_fn


#: the latents' kind of each factor analysis configuration
FA_KIND = {"fa12": "Matern32", "fa6c": "Matern32", "fa9": "Matern52"}


def fa_config(name):
    """(latents, output dim, periods or None, loading [o, latents], noise
    Cholesky [o, o]) of fa12, fa9 (fa12's with the d9 model's children) or
    fa6c, from seeds."""
    if name in ("fa12", "fa9"):
        rng = np.random.default_rng(12)
        loading = rng.standard_normal((FA12_O, len(FA12)))
        chol = (np.tril(0.05 * rng.standard_normal((FA12_O, FA12_O)), -1)
                + np.diag(rng.uniform(0.15, 0.3, FA12_O)))
        return FA12 if name == "fa12" else D9, FA12_O, FA12_PERIODS, loading, chol
    rng = np.random.default_rng(6)
    return FA6C, FA6C_O, None, 0.5 * rng.standard_normal((FA6C_O, len(FA6C))), 0.1 * np.eye(FA6C_O)


def fa_data(name, n, uniform=True):
    """x as the flagship's; y [n, o] = A(x) B g(x) plus noise of the
    configuration's covariance, with g_k(x) = sin(2 x / 2^k), from seed 1."""
    latents, o, periods, loading, chol = fa_config(name)
    rng = np.random.default_rng(1)
    x = np.linspace(0.0, 100.0, n) if uniform else jittered_grid(n, 0)
    f = np.stack([np.sin(2.0 * x / 2.0 ** i) for i in range(len(latents))], axis=-1) @ loading.T
    if periods is not None:
        f = f * (1.0 + 0.5 * np.sin(2.0 * np.pi * x[:, None] / np.asarray(periods)))
    return x, f + rng.standard_normal((n, o)) @ chol.T


def build_fa(name, n, dtype, uniform=True, device=None):
    """GPR on the factor analysis kernel of fa12, fa9 or fa6c (its loading
    trainable), on a uniform or the jittered grid, on ``device`` (DEVICE
    unless given)."""
    from markovflow_tpu_torch.convert import gpr_from_numpy
    from markovflow_tpu_torch.utils.bijectors import positive

    latents, o, periods, loading, chol = fa_config(name)
    params = {"chol_obs_covariance": chol, "kernel._loading": loading}
    for i, (ell, var) in enumerate(latents):
        params[f"kernel._inner.kernels[{i}].lengthscale"] = positive().inverse(np.asarray(ell))
        params[f"kernel._inner.kernels[{i}].variance"] = positive().inverse(np.asarray(var))
    x, y = fa_data(name, n, uniform)
    model = gpr_from_numpy(params, x, y, device=device or DEVICE, dtype=dtype,
                           kernel=("FactorAnalysisKernel", (FA_KIND[name],) * len(latents)),
                           weight_fn=fa_weights(o, periods))
    if model._uniform_grid != uniform:
        raise AssertionError(f"the grid was detected as uniform={model._uniform_grid}")
    return model


def fa_kernels(name, uniform):
    """(filter, smoother, backward) wrappers a factor analysis path runs:
    the uniform ones only where the emission is constant in time (fa6c on
    the uniform grid), the general ones otherwise (fa12 on both grids)."""
    if uniform and name == "fa6c":
        return "filter_pipeline_uniform", "smoother_pipeline_uniform", "adjoint_pipeline_uniform"
    return "filter_pipeline", "smoother_scan", "adjoint_pipeline"


def phase_factor_analysis(cs, adj, kf, training):
    """GP factor analysis at o > d on both grids: fa12 (a time-varying
    emission, d = 6, o = 12: kernels 4 and 7 at (6, 12) and kernel 5 on
    both grids, the uniform grid through the materialised route) and fa6c
    (a constant emission, d = 4, o = 6: kernels 1, 3 and 2 on the uniform
    grid, 4, 7 and 5 on the jittered one).  At T = 1e6 in float32 each path
    runs loss() and its backward (the loading's gradient through gH or
    gHc), posterior_marginals(), gpr.posterior with predict_f (both output
    covariances) and predict_y at 1e5 new points, and sample_f, with its
    launch counts, and FIT_STEPS fit steps (Adam, FA_FIT_LR, on the
    latents' hyperparameters and the loading: the loss falls).  At T =
    T_FA_F64 the same outputs in float64 on the kernel path against the
    plain path (TOL_F64), and in float32 on both paths against float64
    (check_f32_wide's rule with the TOL_FA_F32_* bounds)."""
    log(f"phase 4k: GP factor analysis (fa12: d = 6, o = {FA12_O}, time-varying weights; "
        f"fa6c: d = 4, o = {FA6C_O}, identity weights) at T = {T_FULL}, float32, and "
        f"T = {T_FA_F64}, float64 and float32")
    counts = {}
    for name in ("fa12", "fa6c"):
        o = fa_config(name)[1]
        for uniform in (True, False):
            grid = "uniform" if uniform else "jittered"
            filt, smooth, back = fa_kernels(name, uniform)
            expect = no_launches(**{filt: 3, back: 1, smooth: 2})
            x, _ = fa_data(name, T_FULL, uniform)
            pts, _ = prediction_points(N_NEW_FA, x)
            model = build_fa(name, T_FULL, torch.float32, uniform)
            tn = torch.as_tensor(pts, dtype=torch.float32, device=DEVICE)
            path = f"{name} {grid} float32"
            counts[path] = {}
            with launches_of(cs, adj, counts[path]):
                out = gpr_outputs(model, tn)
            expect_launches(f"{path}: loss, backward, marginals, posterior", counts[path],
                            expect)
            check_finite(path, out)
            log(f"  {path}: loss = {float(out['loss'])!r}")
            with torch.no_grad():
                draws = model.posterior.sample_f(
                    tn[:N_SAMPLE_POINTS], SAMPLES,
                    generator=torch.Generator(device=DEVICE).manual_seed(0))
            if draws.shape != (SAMPLES, N_SAMPLE_POINTS, o):
                raise AssertionError(f"{path}: sample_f shape {tuple(draws.shape)}")
            check_finite(path + " sample_f", {"draws": draws})
            fpath = f"{name} {grid} training float32"
            counts[fpath] = {}
            b0 = model.kernel.loading.detach().clone()
            opt = torch.optim.Adam([q for q in model.parameters() if q.requires_grad],
                                   lr=FA_FIT_LR)
            with launches_of(cs, adj, counts[fpath]):
                _, losses = training.fit(model, num_steps=FIT_STEPS, optimizer=opt)
            expect_launches(f"{fpath}: {FIT_STEPS} fit steps", counts[fpath],
                            no_launches(**{filt: FIT_STEPS, back: FIT_STEPS}))
            check_fit(losses)
            if torch.equal(model.kernel.loading.detach(), b0):
                raise AssertionError(f"{fpath}: the loading did not move")
            del model, out
            # float64 and float32 at T_FA_F64, kernel path and plain path
            x, _ = fa_data(name, T_FA_F64, uniform)
            pts, _ = prediction_points(N_NEW_FA // 10, x)
            runs = {}
            for dtype in (torch.float64, torch.float32):
                dname = str(dtype)[6:]
                tn = torch.as_tensor(pts, dtype=dtype, device=DEVICE)
                path = f"{name} {grid} T={T_FA_F64} {dname}"
                counts[path] = {}
                with launches_of(cs, adj, counts[path]):
                    runs[("kernel", dname)] = gpr_outputs(
                        build_fa(name, T_FA_F64, dtype, uniform), tn)
                expect_launches(f"{path}: loss, backward, marginals, posterior",
                                counts[path], expect)
                with plain_path(cs, adj, kf):
                    runs[("plain", dname)] = gpr_outputs(
                        build_fa(name, T_FA_F64, dtype, uniform), tn)
            k64, p64 = runs[("kernel", "float64")], runs[("plain", "float64")]
            check(f"{name} {grid} T={T_FA_F64} f64: kernel path vs plain path",
                  {k: rel_diff(k64[k], p64[k]) for k in p64}, dict.fromkeys(p64, TOL_F64))
            grads = [k for k in k64 if k.startswith("grad")]
            gscale = torch.stack([p64[k].abs().max() for k in grads]).max()
            k32, p32 = runs[("kernel", "float32")], runs[("plain", "float32")]
            check_f32_wide(
                f"{name} {grid} T={T_FA_F64}: f32 vs f64, kernel path and plain path "
                "(gradients normwise)",
                {k: (k32[k], p32[k], p64[k], gscale if k in grads else None) for k in p64},
                {k: (TOL_FA_F32_LOSS if k == "loss" else TOL_FA_F32_GRAD if k in grads
                     else TOL_FA_F32_MOMENTS) for k in p64})
            del runs
    return counts


# ---------------------------------------------------------------------------
# Phase 4l
# ---------------------------------------------------------------------------
def build_mo9(n, dtype, uniform=True, device=None):
    """The multi-output GPR mo9 (an IndependentMultiOutput of the d9
    model's three Matern52 children, mo3's data and noise Cholesky) on a
    uniform or the jittered grid, on ``device`` (DEVICE unless given)."""
    from markovflow_tpu_torch.convert import gpr_from_numpy
    from markovflow_tpu_torch.utils.bijectors import positive

    params = {"chol_obs_covariance": np.asarray(MO3_CHOL)}
    for i, (ell, var) in enumerate(D9):
        params[f"kernel.kernels[{i}].lengthscale"] = positive().inverse(np.asarray(ell))
        params[f"kernel.kernels[{i}].variance"] = positive().inverse(np.asarray(var))
    x, y = mo3_data(n, uniform)
    model = gpr_from_numpy(params, x, y, device=device or DEVICE, dtype=dtype, kernel=MO9_SPEC)
    if model._uniform_grid != uniform:
        raise AssertionError(f"the grid was detected as uniform={model._uniform_grid}")
    return model


def build_wide(name, n, dtype, uniform=True, device=None):
    """mo9 or fa9 (phase 4l)."""
    if name == "mo9":
        return build_mo9(n, dtype, uniform, device)
    return build_fa(name, n, dtype, uniform, device)


def wide_data(name, n, uniform=True):
    return mo3_data(n, uniform) if name == "mo9" else fa_data(name, n, uniform)


def phase_wide_multi_output(cs, adj, kf, training):
    """Multi-output GPR above state dim 6 on both grids, at T_D9: mo9 (d = 9,
    o = 3: a constant emission and noise precision, kernels 4 and 7 at
    (9, 3) through the d-space fold with J made once a warp) and fa9 (d = 9,
    o = 12: fa12's time-varying weights and trainable loading, kernels 4
    and 7 at (9, 12), H staged a step); kernel 5 at d = 9 on both; the
    uniform grid through the materialised route, since kernels 1 and 3 take
    o = 1 only above d = 6.  In float32 each path runs loss() and its
    backward, posterior_marginals(), gpr.posterior with predict_f (both
    output covariances) and predict_y at N_NEW_WIDE new points, with its
    launch counts, and FIT_STEPS fit steps (Adam; fa9 at FA_FIT_LR, mo9 at
    1e-2: the loss falls).  The same outputs in
    float64 on the kernel path against the plain path (TOL_F64), and in
    float32 on both paths against float64 (check_f32_wide's rule with the
    TOL_MO9_F32_* and TOL_FA9_F32_* bounds).  The predictions are held as
    d9_prediction holds the d9 model's: at the exact hits and past either
    end; between the grid points the Matern52 children's process noise
    P_inf - A P_inf A^T has no digits left at sub-grid steps (ROADMAP queue
    3), so there the non-finite ones are counted and the differences
    printed."""
    log(f"phase 4l: mo9 (IndependentMultiOutput of three Matern52, d = 9, o = 3) and fa9 "
        f"(FactorAnalysisKernel of three Matern52 latents, d = 9, o = {FA9_O}) at T = {T_D9}, "
        "float32 and float64")
    counts = {}
    expect = no_launches(filter_pipeline=3, adjoint_pipeline=1, smoother_scan=2)
    for name in ("mo9", "fa9"):
        tols = ((TOL_MO9_F32_LOSS, TOL_MO9_F32_GRAD, TOL_MO9_F32_MOMENTS) if name == "mo9"
                else (TOL_FA9_F32_LOSS, TOL_FA9_F32_GRAD, TOL_FA9_F32_MOMENTS))
        for uniform in (True, False):
            grid = "uniform" if uniform else "jittered"
            x, _ = wide_data(name, T_D9, uniform)
            pts, kinds = prediction_points(N_NEW_WIDE, x)
            held = np.r_[kinds["hits"], kinds["left"], kinds["right"]]

            def at_held(out):
                return {k: v[held] if k in WIDE_PREDICTIONS else v for k, v in out.items()}

            def inner(out):
                return {k: v[kinds["inner"]] for k, v in out.items() if k in WIDE_PREDICTIONS}
            runs = {}
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype)[6:]
                tn = torch.as_tensor(pts, dtype=dtype, device=DEVICE)
                model = build_wide(name, T_D9, dtype, uniform)
                path = f"{name} {grid} {dname}"
                counts[path] = {}
                with launches_of(cs, adj, counts[path]):
                    runs[("kernel", dname)] = gpr_outputs(model, tn)
                expect_launches(f"{path}: loss, backward, marginals, posterior", counts[path],
                                expect)
                check_finite(path, at_held(runs[("kernel", dname)]))
                log(f"  {path}: non-finite predictions between the grid points: " + str(
                    {k: int((~torch.isfinite(v)).sum())
                     for k, v in inner(runs[("kernel", dname)]).items()}))
                log(f"  {path}: loss = {float(runs[('kernel', dname)]['loss'])!r}")
                if dtype == torch.float32:
                    fpath = f"{name} {grid} training {dname}"
                    counts[fpath] = {}
                    lr = FA_FIT_LR if name == "fa9" else 1e-2
                    opt = torch.optim.Adam([q for q in model.parameters() if q.requires_grad],
                                           lr=lr)
                    with launches_of(cs, adj, counts[fpath]):
                        _, losses = training.fit(model, num_steps=FIT_STEPS, optimizer=opt)
                    expect_launches(f"{fpath}: {FIT_STEPS} fit steps", counts[fpath],
                                    no_launches(filter_pipeline=FIT_STEPS,
                                                adjoint_pipeline=FIT_STEPS))
                    check_fit(losses)
                del model
                with plain_path(cs, adj, kf):
                    runs[("plain", dname)] = gpr_outputs(build_wide(name, T_D9, dtype, uniform),
                                                         tn)
            log(f"  {name} {grid} f64 between the grid points, kernel path vs plain path: "
                + " ".join(f"{k}={finite_rel_diff(v, inner(runs[('plain', 'float64')])[k])}"
                           for k, v in inner(runs[("kernel", "float64")]).items()))
            k64, p64 = (at_held(runs[(path, "float64")]) for path in ("kernel", "plain"))
            check(f"{name} {grid} T={T_D9} f64: kernel path vs plain path (predictions at the "
                  "exact hits and ends)",
                  {k: rel_diff(k64[k], p64[k]) for k in p64}, dict.fromkeys(p64, TOL_F64))
            grads = [k for k in k64 if k.startswith("grad")]
            gscale = torch.stack([p64[k].abs().max() for k in grads]).max()
            k32, p32 = (at_held(runs[(path, "float32")]) for path in ("kernel", "plain"))
            check_f32_wide(
                f"{name} {grid} T={T_D9}: f32 vs f64, kernel path and plain path "
                "(gradients normwise; predictions at the exact hits and ends)",
                {k: (k32[k], p32[k], p64[k], gscale if k in grads else None) for k in p64},
                {k: (tols[0] if k == "loss" else tols[1] if k in grads else tols[2])
                 for k in p64})
            del runs
    return counts


# ---------------------------------------------------------------------------
# Phase 5
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds per call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pass_label(key: str) -> str:
    """A kernel's profiler name without its return type, arguments and
    namespaces: ``wide_scan_level<WideFilterOp<float>, false, true, float>``."""
    key = key.removeprefix("void ").replace("mf::", "")
    depth = 0
    for i, ch in enumerate(key):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return key[:i]
    return key


def kernel_device_ms(fn, reps: int = 10):
    """Device milliseconds per call spent in the port's own CUDA kernels
    (namespace ``mf::``), from a torch.profiler trace of ``reps`` calls (0.0
    when the trace holds no device time), and per kernel of those (a pass):
    label -> (device ms per call, launches per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, passes = 0.0, {}
    for evt in prof.key_averages():
        if "mf::" in evt.key:
            for name in ("self_device_time_total", "self_cuda_time_total"):
                if hasattr(evt, name):
                    t = getattr(evt, name)
                    us += t
                    passes[pass_label(evt.key)] = (t / reps / 1e3, evt.count / reps)
                    break
    return us / reps / 1e3, passes


@contextlib.contextmanager
def labelled_wrappers(cs, adj, kf):
    """Wrap every kernel wrapper, in the modules that call it, in a
    profiler range named ``kernel <wrapper>``, so that a trace gives each
    kernel's device time within a path."""
    saved = []
    for mod in (cs, kf, adj):
        for _, name in COUNTED:
            fn = getattr(mod, name, None)
            if fn is None:
                continue

            def labelled(*args, _fn=fn, _name=name, **kw):
                with torch.profiler.record_function(f"kernel {_name}"):
                    return _fn(*args, **kw)
            # a wrapper counts its launches on the name it is called by in
            # its own module, here this stand-in
            labelled.launches = 0
            saved.append((mod, name, fn))
            setattr(mod, name, labelled)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def device_ms_by_kernel(cs, adj, kf, fn, reps: int = 10):
    """Device milliseconds per call of ``fn``: in all the port's kernels
    together (``kernel_device_ms``); per wrapper, in the ``mf::`` kernels
    inside its span on the card's timeline (the trace's device-side
    ``kernel <wrapper>`` annotation; a kernel inside two goes to the
    shorter); and in all the ``mf::`` kernels of that trace, which the
    wrappers' parts must add up to."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    total, _ = kernel_device_ms(fn, reps)
    with labelled_wrappers(cs, adj, kf):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e for e in on_card if e.name.startswith("kernel ")]
    ours = [e for e in on_card if "mf::" in e.name]
    per = {}
    for e in ours:
        around = [w for w in spans if w.time_range.start <= e.time_range.start
                  and e.time_range.end <= w.time_range.end]
        if around:
            name = min(around, key=lambda w: w.time_range.elapsed_us()).name[len("kernel "):]
            per[name] = per.get(name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    traced = sum(e.time_range.elapsed_us() for e in ours) / reps / 1e3
    return total, per, traced


def cvi_step(model):
    """One full CVI iteration: update_sites(), then loss().backward()."""
    def step():
        model.update_sites()
        for p in model.parameters():
            p.grad = None
        model.loss().backward()
    return step


def train_step(model, lr=1e-2):
    """One Adam step of loss().backward() (the factor analysis models at
    FA_FIT_LR, as their fits in phases 4k and 4l take it)."""
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=lr)

    def step():
        opt.zero_grad(set_to_none=True)
        model.loss().backward()
        opt.step()
    return step


def stored_bytes(x) -> int:
    """Bytes of the distinct values of a tensor: an expanded axis (stride 0)
    holds one value."""
    return math.prod(n for n, st in zip(x.shape, x.stride()) if st != 0) * x.element_size()


def step_flops(name: str, d: int, o: int = 1, obs: bool = True, js_step: bool = True) -> int:
    """Operations of one step of the sequential recursion that a kernel's
    function computes (counting a d x d product as 2 d^3 and a d x d
    inverse as 2 d^3): the least arithmetic of the function, whatever the
    kernel's parallel scan adds (each associative composition costs ~2x a
    sequential step).
      filter: predict F P F^T (4 d^3), update and likelihood (6 d^2); at
        o > 1 also H P H^T and P H^T (2 d^2 o + 2 d o^2), the o x o solve
        for the gain (2 o^2 (o + 1) + 2 o^3), the update P H^T lz H P
        (2 d o^2 + 2 d^2 o) and the likelihood's lam S lam and two o x o
        eliminations (8 o^3);
      RTS smoother: Pp (4 d^3), its inverse and the gain (4 d^3), the
        smoothed covariance G (Ps - Pp) G^T (4 d^3), the means;
      smoother scan of prebuilt (E, g, L): E P E^T + L, E m + g;
      filter scan of prebuilt (A, b, C, J, eta): (I + C J)^-1 and
        A M C A^T (10 d^3), the means;
      Koopman backward, per step: Pp and L = F (I - K H) (6 d^3), the
        suffix E NDK E^T (4 d^3), N F P (4 d^3); the uniform one also the
        smoothed covariance for its summed gH (4 d^3); at o > 1 also
        H Pp H^T and Pp H^T (2 d^2 o + 2 d o^2), the o x o solve for
        Zt lam and e (2 o^2 (o + 1) + 2 o^3), W H, F Pp H^T, their product
        and H^T W H (2 d o^2 + 6 d^2 o), and the observation terms:
        Pp NDK Pp H^T (4 d^2 o), lam H A and H A H^T (4 d o^2) and lam^-1
        (4 o^3).  With obs False (a backward that writes no gH, gnu or
        glam) neither the observation terms nor the uniform one's smoothed
        covariance count.
    At o > d the site folded into state space (csrc/info_scan.cuh):
      filter: predict (4 d^3), M = I + Pp J and its inverse (4 d^3), the
        covariance and mean after the site (4 d^3, 4 d^2), h = H^T nu
        (2 d o), the likelihood's lam^-1 nu, e = y - H mp and e^T lam e
        (4 o^2 + 2 d o) and v^T X v (2 d^2); the general filter also
        J = H^T lam H a step (2 d o^2 + 2 d^2 o; the uniform one's H and
        lam are constant, its J made once);
      Koopman backward: Pp, M^-1, L = F M^-1 and H^T W H (12 d^3), the
        suffix's L^T NDK L (4 d^3), N F P (2 d^3), J a step for the
        general one; the observation terms (the smoothed covariance 4 d^3,
        lam H and A (lam H)^T: 2 d o^2 + 2 d^2 o).
    The same at every o > 1 above d = 6 (csrc/wide_info.cuh).  J counts a
    step only where H or lam changes with the step (``js_step``): made once
    otherwise, as the kernels make it."""
    d2, d3 = d * d, d ** 3
    if o > d or (o > 1 and d > 6):
        js = 2 * d * o * o + 2 * d2 * o
        js_general = js if js_step else 0
        if name in ("filter_pipeline", "filter_pipeline_uniform"):
            return (12 * d3 + 6 * d2 + 4 * d * o + 4 * o * o
                    + (js_general if name == "filter_pipeline" else 0))
        return (18 * d3 + 2 * d2 + (js_general if name == "adjoint_pipeline" else 0)
                + (4 * d3 + js if obs else 0))
    if name in ("filter_pipeline", "filter_pipeline_uniform") and o > 1:
        return (4 * d3 + 4 * d2 * o + 4 * d * o * o + 2 * o * o * (o + 1) + 10 * o ** 3
                + 6 * d2)
    extra = (12 * d2 * o + 8 * d * o * o + 2 * o * o * (o + 1) + 6 * o ** 3) if o > 1 else 0
    if not obs:
        extra -= (4 * d2 * o + 4 * d * o * o + 4 * o ** 3) if o > 1 else 0
        extra -= 4 * d3 if name == "adjoint_pipeline_uniform" else 0
    return extra + {"filter_pipeline_uniform": 4 * d3 + 6 * d2,
            "filter_pipeline": 4 * d3 + 6 * d2,
            "smoother_pipeline_uniform": 12 * d3 + 6 * d2,
            "smoother_scan": 4 * d3 + 2 * d2,
            "filter_scan": 10 * d3 + 6 * d2,
            "adjoint_pipeline": 14 * d3 + 6 * d2,
            "adjoint_pipeline_uniform": 18 * d3 + 6 * d2}[name]


def bound(name, inputs, outputs, d, steps):
    """(bound_ms, bound_by) of one call: the larger of its bytes (each
    input read once, each output written once) over the H100's memory rate
    and its operations (step_flops per step, at the call's output dim)
    over the H100's rate for its dtype; a Koopman backward's observation
    terms count only where the call wrote gH, gnu or glam, and J a step only
    where H or lam changes with the step."""
    nbytes = sum(stored_bytes(x) for x in list(inputs) + list(outputs)
                 if isinstance(x, torch.Tensor))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    # the output dim of a filter's or a backward's lam [..., o, o, N]
    lam_at = {"filter_pipeline": 5, "adjoint_pipeline": 5, "filter_pipeline_uniform": 7,
              "adjoint_pipeline_uniform": 7}
    o = inputs[lam_at[name]].shape[-3] if name in lam_at else 1
    # a backward's gH, gnu and glam (the uniform one's gHc, gnu and glam)
    obs_at = {"adjoint_pipeline": slice(3, 6), "adjoint_pipeline_uniform": slice(5, 8)}
    obs = name not in obs_at or any(x is not None for x in outputs[obs_at[name]])
    rate = H100_F64_FLOPS if inputs[0].dtype == torch.float64 else H100_F32_FLOPS
    # the general kernels make J = H^T lam H once where H and lam have step
    # stride 0
    js_step = name not in ("filter_pipeline", "adjoint_pipeline") or not (
        inputs[3].stride(-1) == 0 and inputs[5].stride(-1) == 0)
    t_ops = step_flops(name, d, o, obs, js_step) * steps / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_calls(cs, adj, uni, gen, needs=GPR_NEEDS, scan=True):
    """Each kernel on the inputs of a uniform-grid and a jittered-grid model
    (the uniform ones only where ``uni`` is not None; the uniform adjoint up
    to d = 6), called as the main path calls it: name -> (kernel call,
    plain call, inputs).  The filter scan takes the jittered model's
    filtering elements; the two Koopman backwards write only what the GPR
    backward asks for (``needs``, the general one's; the uniform one sums
    gHc where needs[3], as a trainable emission asks).  ``scan=False``
    leaves out the filter scan, which no GPR path runs."""
    from markovflow_tpu_torch.ops.kalman import (make_filter_elements_tl,
                                                 smoother_elements_tl)

    k_gen = gen.kalman
    F, c, Q = (x.detach() for x in k_gen.prior_tl)
    H = k_gen._emission_tl().detach()
    gnu, glam, _ = k_gen._site_nats_tl()
    gargs = (F, c, Q, H, gnu, glam)
    gs = torch.ones((), dtype=gnu.dtype, device=DEVICE)
    with torch.no_grad():
        gm_fp, gp_fp, _ = cs.filter_pipeline_plain(*gargs)
        elems = smoother_elements_tl(F, c, Q, gm_fp, gp_fp)[:3]
        felems = make_filter_elements_tl(*gargs) if scan else None
    calls = {
        "filter_pipeline": (lambda: cs.filter_pipeline(*gargs),
                            lambda: cs.filter_pipeline_plain(*gargs), gargs),
        "smoother_scan": (lambda: cs.smoother_scan(*elems),
                          lambda: cs.smoother_scan_plain(*elems), elems),
        "adjoint_pipeline": (
            lambda: adj.adjoint_pipeline(*gargs, None, gm_fp, gp_fp, gs, needs=needs),
            lambda: adj.adjoint_pipeline_plain(*gargs, None, gm_fp, gp_fp, gs),
            gargs + (gm_fp, gp_fp, gs)),
    }
    if scan:
        calls["filter_scan"] = (lambda: cs.filter_scan(*felems),
                                lambda: cs.filter_scan_plain(*felems), felems)
    if uni is None:
        return calls
    k_uni = uni.kalman
    Fc, cc, Qc, mu0, P0 = (x.detach() for x in k_uni.prior_const_tl)
    hc = k_uni._const_emission_tl().detach()
    nu, lam, _ = k_uni._site_nats_tl()
    args = (Fc, cc, Qc, mu0, P0, hc, nu, lam)
    with torch.no_grad():
        m_fp, p_fp, _ = cs.filter_pipeline_uniform_plain(*args)
    calls["filter_pipeline_uniform"] = (lambda: cs.filter_pipeline_uniform(*args),
                                        lambda: cs.filter_pipeline_uniform_plain(*args),
                                        args)
    calls["smoother_pipeline_uniform"] = (
        lambda: cs.smoother_pipeline_uniform(Fc, cc, Qc, m_fp, p_fp),
        lambda: cs.smoother_pipeline_uniform_plain(Fc, cc, Qc, m_fp, p_fp),
        (Fc, cc, Qc, m_fp, p_fp))
    if Fc.shape[-3] <= adj.UNIFORM_ADJOINT_MAX_STATE_DIM:
        # as the GPR backward calls it: no site gradients, gHc where the
        # emission is trainable
        calls["adjoint_pipeline_uniform"] = (
            lambda: adj.adjoint_pipeline_uniform(*args, None, m_fp, p_fp, gs,
                                                 site_grads=False, hc_grad=needs[3]),
            lambda: adj.adjoint_pipeline_uniform_plain(*args, None, m_fp, p_fp, gs),
            args + (m_fp, p_fp, gs))
    return calls


def natgrad_kernel_calls(cs):
    """Kernel 4 at o = d = 2 as bench config 2's natural-gradient step calls
    it: on the synthetic model of the naturals of q after one step (T =
    NG_T, float64).  name -> (kernel call, plain call, inputs)."""
    from markovflow_tpu_torch.ssm_gaussian_transformations import (
        ssm_to_naturals_tl, synthetic_filter_inputs_tl)

    model, loss_of = vgp_config2(NG_T)
    q1 = natgrad_steps(model, loss_of, 1)[0]
    with torch.no_grad():
        syn = synthetic_filter_inputs_tl(*ssm_to_naturals_tl(q1))
    return {"filter_pipeline": (lambda: cs.filter_pipeline(*syn),
                                lambda: cs.filter_pipeline_plain(*syn), syn)}


def compare_call(kfn, pfn):
    """A kernel call's outputs against its plain version's: the max abs
    difference and the largest plain entry, over the per-step and summed
    arrays both return (not the log-likelihood, a sum of N terms)."""
    with torch.no_grad():
        got, want = kfn(), pfn()
    pairs = [(g, w) for g, w in zip(got, want) if g is not None and g.dim() >= 3]
    return (max(float((g - w).abs().max()) for g, w in pairs),
            max(float(w.abs().max()) for _, w in pairs), got)


def phase_times(cs, adj, kf, card, counts):
    log(f"phase 5: times at T = {T_FULL} (flagship) and T = {T_D9} (d9 model), "
        f"float32, on {card}")
    uni = build_gpr(T_FULL, torch.float32)
    gen = build_gpr(T_FULL, torch.float32, uniform=False)
    d9u = build_gpr(T_D9, torch.float32, d9=True)
    d9j = build_gpr(T_D9, torch.float32, uniform=False, d9=True)
    mo3u = build_mo3(T_FULL, torch.float32)
    mo3j = build_mo3(T_FULL, torch.float32, uniform=False)
    # mo3's kernels: 1, 3, 4 and 7 at o = 3, the smoothers at d = 6
    mo3_calls = {k: v for k, v in kernel_calls(cs, adj, mo3u, mo3j).items()
                 if k != "filter_scan"}
    # GP factor analysis: fa12's kernels 4 and 7 at (6, 12) and 5 at d = 6;
    # fa6c's 1, 3 and 4, 7 at (4, 6), 2 and 5 at d = 4; each backward as the
    # GPR backward calls it with a trainable loading (gH, or gHc)
    fa = {f"{name} {grid}": build_fa(name, T_FULL, torch.float32, grid == "uniform")
          for name in ("fa12", "fa6c") for grid in ("uniform", "jittered")}
    fa_needs = (True, True, True, True, False, False)
    # mo9's and fa9's kernels 4 and 7 at (9, 3) and (9, 12), 5 at d = 9
    # (T_D9), as their GPR backwards call them (fa9's with gH)
    wide = {f"{name} {grid}": build_wide(name, T_D9, torch.float32, grid == "uniform")
            for name in ("mo9", "fa9") for grid in ("uniform", "jittered")}
    sets = {"": (kernel_calls(cs, adj, uni, gen), 2, T_FULL),
            " d=9": (kernel_calls(cs, adj, d9u, d9j), 9, T_D9),
            " o=2": (natgrad_kernel_calls(cs), 2, NG_T),
            " o=3": (mo3_calls, 6, T_FULL),
            " fa12": (kernel_calls(cs, adj, None, fa["fa12 jittered"], fa_needs, scan=False),
                      6, T_FULL),
            " fa6c": (kernel_calls(cs, adj, fa["fa6c uniform"], fa["fa6c jittered"], fa_needs,
                                   scan=False), 4, T_FULL),
            " mo9": (kernel_calls(cs, adj, None, wide["mo9 jittered"], scan=False), 9, T_D9),
            " fa9": (kernel_calls(cs, adj, None, wide["fa9 jittered"], fa_needs, scan=False),
                     9, T_D9)}
    with torch.no_grad():
        tn = torch.as_tensor(prediction_points(N_NEW, flagship_data(T_FULL)[0])[0],
                             dtype=torch.float32, device=DEVICE)
        tn_wide = torch.as_tensor(prediction_points(N_NEW_WIDE, mo3_data(T_D9)[0])[0],
                                  dtype=torch.float32, device=DEVICE)
        held = {"uniform": uni.posterior, "jittered": gen.posterior,
                "mo3 uniform": mo3u.posterior, "mo3 jittered": mo3j.posterior,
                **{tag: m.posterior for tag, m in fa.items()},
                **{tag: m.posterior for tag, m in wide.items()}}
    requests = {
        # predict_f runs no kernel: its plain path is the same code
        "uniform posterior": lambda: uni.posterior,
        "uniform predict_f (1e5 points)": lambda: held["uniform"].predict_f(tn),
        "jittered posterior": lambda: gen.posterior,
        "jittered predict_f (1e5 points)": lambda: held["jittered"].predict_f(tn),
        "uniform loss()": lambda: uni.loss(),
        "uniform posterior_marginals()": lambda: uni.kalman.posterior_marginals(),
        "jittered loss()": lambda: gen.loss(),
        "jittered posterior_marginals()": lambda: gen.kalman.posterior_marginals(),
        "d9 loss()": lambda: d9u.loss(),
        "d9 posterior_marginals()": lambda: d9u.kalman.posterior_marginals(),
        "d9 jittered loss()": lambda: d9j.loss(),
        "d9 jittered posterior_marginals()": lambda: d9j.kalman.posterior_marginals(),
        "mo3 uniform loss()": lambda: mo3u.loss(),
        "mo3 uniform posterior_marginals()": lambda: mo3u.kalman.posterior_marginals(),
        "mo3 uniform posterior": lambda: mo3u.posterior,
        "mo3 uniform predict_f (1e5 points)": lambda: held["mo3 uniform"].predict_f(tn),
        "mo3 jittered loss()": lambda: mo3j.loss(),
        "mo3 jittered posterior_marginals()": lambda: mo3j.kalman.posterior_marginals(),
        "mo3 jittered posterior": lambda: mo3j.posterior,
        "mo3 jittered predict_f (1e5 points)": lambda: held["mo3 jittered"].predict_f(tn),
    }
    for tag, m in fa.items():
        requests[f"{tag} loss()"] = m.loss
        requests[f"{tag} posterior_marginals()"] = lambda m=m: m.kalman.posterior_marginals()
        requests[f"{tag} posterior"] = lambda m=m: m.posterior
        requests[f"{tag} predict_f (1e5 points)"] = lambda tag=tag: held[tag].predict_f(tn)
    for tag, m in wide.items():
        requests[f"{tag} loss()"] = m.loss
        requests[f"{tag} posterior_marginals()"] = lambda m=m: m.kalman.posterior_marginals()
        requests[f"{tag} posterior"] = lambda m=m: m.posterior
        requests[f"{tag} predict_f (1e4 points)"] = lambda tag=tag: held[tag].predict_f(tn_wide)
    sde_prob = sde_problem(torch.float32, SDE_N)
    sde_key = f"SDE VI iteration (n={SDE_N})"
    requests[sde_key] = lambda: sde_iteration(kf, sde_prob, sde_prob["path"])
    steps = {"uniform training step": train_step(uni),
             "jittered training step": train_step(gen),
             "d9 training step": train_step(d9u),
             "d9 jittered training step": train_step(d9j),
             "mo3 uniform training step": train_step(mo3u),
             "mo3 jittered training step": train_step(mo3j),
             "uniform CVI iteration": cvi_step(build_cvi(T_FULL, torch.float32)),
             "jittered CVI iteration": cvi_step(build_cvi(T_FULL, torch.float32,
                                                          uniform=False)),
             **{f"{tag} training step": train_step(m, FA_FIT_LR) for tag, m in fa.items()},
             **{f"{tag} training step": train_step(m, FA_FIT_LR if "fa9" in tag else 1e-2)
                for tag, m in wide.items()}}
    calls = {name + tag: fns for tag, (c, _, _) in sets.items()
             for name, fns in c.items()}
    natgrad = {}
    for key, (model, loss_of) in (
            (f"VGP natgrad step (config 2, T={NG_T}, float64)", vgp_config2(NG_T)),
            (f"SVGP natgrad step (config 3, N={NG_T}, M={NG_M}, float64)",
             svgp_config3(NG_T, NG_M))):
        natgrad[key] = functools.partial(natgrad_steps, model, loss_of, 1)
    # turns: plain, kernel, kernel, plain; the medians of both turns
    t = {}
    def reps_of(key, turn):
        """(calls, warm-up calls) a turn: the factor analysis paths' plain
        calls take 0.5-2 s each, and mo9's near that, so they run fewer; the
        others 3 / 1 (20 / 3 before mo9's and fa9's paths, 5 / 1 before
        phase 3 took back its full-length batched cases: the time limit)."""
        if key.startswith(("fa", "mo9")):
            return (3, 1) if turn == "kernel" else (1, 0)
        return (3, 1) if turn == "kernel" else (1, 1)
    for turn in ("plain", "kernel", "kernel", "plain"):
        reps = 3 if turn == "kernel" else 1
        ctx = plain_path(cs, adj, kf) if turn == "plain" else contextlib.nullcontext()
        with ctx:
            with torch.no_grad():
                for key, fn in requests.items():
                    t.setdefault((turn, key), []).append(cuda_ms(fn, *reps_of(key, turn)))
            for key, fn in steps.items():
                t.setdefault((turn, key), []).append(cuda_ms(fn, *reps_of(key, turn)))
            for key, fn in natgrad.items():
                t.setdefault((turn, key), []).append(cuda_ms(fn, 3, warmup=1))
        with torch.no_grad():
            for key, (kfn, pfn, _) in calls.items():
                t.setdefault((turn, key), []).append(
                    cuda_ms(kfn if turn == "kernel" else pfn, reps))
    ms = {k: statistics.median(v) for k, v in t.items()}
    for key in list(requests) + list(steps) + list(natgrad):
        n_k, n_p = ((3, 3) if key in natgrad else
                    (reps_of(key, "kernel")[0], reps_of(key, "plain")[0]))
        log(f"  {key}: kernel path {ms[('kernel', key)]!r} ms, plain path "
            f"{ms[('plain', key)]!r} ms (CUDA events, median of the turns' medians of "
            f"{n_k} / {n_p} calls)  [{card}]")
    for key, fn in (("uniform CVI iteration", steps["uniform CVI iteration"]),
                    ("jittered CVI iteration", steps["jittered CVI iteration"]),
                    ("mo3 uniform training step", steps["mo3 uniform training step"]),
                    ("mo3 jittered training step", steps["mo3 jittered training step"]),
                    *((f"{tag} training step", steps[f"{tag} training step"])
                      for tag in list(fa) + list(wide)),
                    (sde_key, requests[sde_key]), *natgrad.items()):
        ctx = torch.no_grad() if key.startswith("SDE") else contextlib.nullcontext()
        with ctx:
            total, per, traced = device_ms_by_kernel(
                cs, adj, kf, fn,
                reps=3 if key in natgrad else 5)
        log(f"  {key}: device ms per iteration in the port's kernels {total!r} "
            f"(torch.profiler); by wrapper, in its own kernels: " + (", ".join(
                f"{k} {v!r}" for k, v in per.items()) or "not measured") + f"  [{card}]")
        own_sum = sum(per.values())
        log(f"  {key}: the wrappers' mf:: kernels add up to {own_sum!r} ms of the "
            f"{traced!r} ms of mf:: kernels in the same trace")
        if per and not abs(own_sum - traced) <= 1e-6 * traced:
            raise AssertionError(f"{key}: mf:: kernels ran outside the wrappers' ranges")
    dev, passes, errs, largest, bounds = {}, {}, {}, {}, {}
    for tag, (c, d, n) in sets.items():
        for name, (kfn, pfn, inputs) in c.items():
            key = name + tag
            with torch.no_grad():
                dev[key], passes[key] = kernel_device_ms(kfn)
            errs[key], largest[key], outputs = compare_call(kfn, pfn)
            bounds[key] = bound(name, inputs, outputs, d, n)
    for key in calls:
        src = "on the device per call (torch.profiler)"
        if dev[key] <= 0.0:
            dev[key] = ms[("kernel", key)]
            src = "per wrapper call (the profiler saw no device time)"
        log(f"  {key} kernel: max abs diff from its plain version "
            f"{errs[key]:.3e} (largest entry {largest[key]:.3e})")
        log(f"  {key} kernel: {dev[key]!r} ms {src}; bound {bounds[key][0]!r} ms "
            f"({bounds[key][1]}); wrapper call {ms[('kernel', key)]!r} ms, plain "
            f"version {ms[('plain', key)]!r} ms (CUDA events, median per call)  [{card}]")
        log(f"  {key} kernel per pass: " + "; ".join(
            f"{label} {t!r} ms x{count:g}" for label, (t, count) in passes[key].items()))
    log(json.dumps({"passes": {key: {label: {"ms": t, "launches": count}
                                     for label, (t, count) in passes[key].items()}
                               for key in calls}, "card": card}))
    source = "markovflow_tpu_torch/ops/csrc/"
    # (name, source at d <= 6, source at d = 7..12, TPU kernel, paths at d = 2,
    # paths at d = 9)
    d9_paths = ("d9 serving", "d9 training", "d9 jittered")
    d9_post = ("d9 posterior float64", "d9 posterior float32")
    both = ("float64", "float32")
    uni_post = tuple(f"{p} {t}" for p in ("posterior uniform", "linear mean") for t in both)
    gen_post = tuple(f"posterior jittered {t}" for t in both)
    condensed = tuple(f"condense {t}" for t in both)
    cvi_uni = tuple(f"cvi {p} {t}" for p in ("uniform", "Bernoulli", "Poisson") for t in both)
    cvi_gen = tuple(f"cvi jittered {t}" for t in both)
    sde = tuple(f"sde {t}" for t in both)
    natgrad_paths = ("natgrad vgp", "natgrad svgp")
    mo3_uni = tuple(f"mo3 uniform {t}" for t in both) + ("mo3 uniform training float32",)
    mo3_gen = tuple(f"mo3 jittered {t}" for t in both) + ("mo3 jittered training float32",)
    rows = [("filter_pipeline_uniform", "uniform_scan.cuh", "wide_scan.cuh",
             "pallas_scan.py:1036", ("serving", "product") + uni_post + cvi_uni, d9_paths),
            ("smoother_pipeline_uniform", "uniform_scan.cuh", "wide_scan.cuh",
             "pallas_scan.py:1457", ("serving",) + uni_post + cvi_uni, d9_paths),
            ("adjoint_pipeline_uniform", "adjoint_scan.cuh", None,
             "pallas_scan.py:1229", ("training", "product") + cvi_uni, ()),
            ("filter_pipeline", "general_scan.cuh", "wide_scan.cuh",
             "pallas_scan.py:849", ("general", "sparse") + gen_post + condensed
             + cvi_gen + sde, d9_paths + d9_post),
            ("smoother_scan", "general_scan.cuh", "wide_scan.cuh",
             "pallas_scan.py:1313", ("general",) + gen_post + cvi_gen + sde + natgrad_paths,
             d9_paths + d9_post),
            ("filter_scan", "general_scan.cuh", "wide_scan.cuh",
             "pallas_scan.py:793", ("ops",), ("ops d9",)),
            ("adjoint_pipeline", "general_adjoint.cuh", "general_adjoint.cuh",
             "pallas_scan.py:681", ("general", "sparse") + cvi_gen, d9_paths)]
    # mo3's paths by kernel: kernels 1, 3, 4 and 7 at o = 3, the smoothers
    # at d = 6
    mo3_paths = {"filter_pipeline_uniform": mo3_uni, "smoother_pipeline_uniform": mo3_uni,
                 "adjoint_pipeline_uniform": mo3_uni, "filter_pipeline": mo3_gen,
                 "smoother_scan": mo3_gen, "adjoint_pipeline": mo3_gen}
    # the factor analysis paths by kernel: fa12's both grids run kernels 4,
    # 5 and 7; fa6c's uniform grid 1, 2 and 3, its jittered one 4, 5 and 7
    # (every run of phase 4k: T = 1e6 float32 and its fit, T = T_FA_F64)
    def fa_runs(name, grids):
        return tuple(k for g in grids for k in counts if k.startswith(f"{name} {g} "))
    fa_paths = {" fa12": {k: fa_runs("fa12", ("uniform", "jittered"))
                          for k in ("filter_pipeline", "smoother_scan", "adjoint_pipeline")},
                " fa6c": {**{k: fa_runs("fa6c", ("uniform",)) for k in (
                    "filter_pipeline_uniform", "smoother_pipeline_uniform",
                    "adjoint_pipeline_uniform")}, **{k: fa_runs("fa6c", ("jittered",)) for k in (
                        "filter_pipeline", "smoother_scan", "adjoint_pipeline")}},
                # mo9's and fa9's paths (phase 4l) run kernels 4, 5 and 7 on
                # both grids
                **{f" {name}": {k: fa_runs(name, ("uniform", "jittered"))
                                for k in ("filter_pipeline", "smoother_scan", "adjoint_pipeline")}
                   for name in ("mo9", "fa9")}}
    fa_dims = {" fa12": (6, FA12_O), " fa6c": (4, FA6C_O), " mo9": (9, 3), " fa9": (9, FA9_O)}
    # the sources of the filters and backwards at o > d <= 6 and above d = 6
    fa_src = {" fa12": "info_scan.cuh", " fa6c": "info_scan.cuh", " mo9": "wide_info.cuh",
              " fa9": "wide_info.cuh"}
    out = []
    for name, src, wide_src, rep, paths, wide_paths in rows:
        tags = [("", src, paths), (" d=9", wide_src, wide_paths)]
        if name == "filter_pipeline":
            # kernel 4 at o = d = 2: the natural-gradient inversion's
            tags.append((" o=2", "general_scan.cuh", natgrad_paths))
        if name in mo3_paths:
            tags.append((" o=3", src, mo3_paths[name]))
        for fa_tag, by_kernel in fa_paths.items():
            if name in by_kernel:
                smoother = name.startswith("smoother")
                tags.append((fa_tag, (wide_src if fa_dims[fa_tag][0] > 6 else src) if smoother
                             else fa_src[fa_tag], by_kernel[name]))
        for tag, file, run in tags:
            if file is None:
                continue
            key = name + tag
            # the filters and the backwards name their output dim, the
            # smoothers mo3's state dim
            if tag in fa_dims:
                d_fa, o_fa = fa_dims[tag]
                label = (f"{name} d={d_fa}" if name.startswith("smoother")
                         else f"{name} o={o_fa}") + f" ({tag[1:]})"
            elif name in ("smoother_pipeline_uniform", "smoother_scan"):
                label = name + " d=6" if tag == " o=3" else key
            elif name != "filter_scan" and tag in ("", " d=9"):
                label = key.replace(name, name + " o=1")
            else:
                label = key
            out.append({"name": label, "route": "cuda", "source": source + file,
                        "replaces": "markovflow_tpu/ops/" + rep,
                        "launches": sum(counts[path].get(name, 0) for path in run),
                        "max_abs_err": errs[key], "ms": dev[key],
                        "plain_ms": ms[("plain", key)], "bound_ms": bounds[key][0],
                        "bound_by": bounds[key][1], "library_ms": None})
    return out


def log_unit_seconds(cs) -> None:
    """The slowest nvcc units of the build, when this run built the library."""
    path = cs._BUILD_ROOT / cs._source_hash() / "unit_seconds.json"
    if path.is_file():
        secs = json.loads(path.read_text())
        slow = sorted(secs.items(), key=lambda kv: -kv[1])[:8]
        log(f"  {len(secs)} units, {sum(secs.values()):.1f} s of nvcc in all; slowest: "
            + "; ".join(f"{unit} {t:.1f} s" for unit, t in slow))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs, adj, kf, training = modules()
    npk = load_numpy_oracle()
    t_start = time.perf_counter()
    card = card_line()
    log(f"phase 1: device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    t0 = time.perf_counter()
    cs.build_kernels()
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    log_unit_seconds(cs)
    t0 = time.perf_counter()
    phase_kernels_vs_plain(cs, adj)
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = {}
    _, counts["serving"] = phase_serving(cs, adj, npk)
    counts["training"], _ = phase_training_uniform(cs, adj, training, npk)
    counts["general"], _ = phase_general(cs, adj, training, npk)
    counts.update(phase_d9(cs, adj, kf, training, npk))
    counts.update(phase_ops(cs, adj, kf))
    counts.update(phase_prediction(cs, adj, kf, load_numpy_oracle("dense_gp")))
    counts.update(phase_cvi(cs, adj, kf))
    counts.update(phase_sde(cs, adj, kf))
    counts.update(phase_natgrad(cs, adj, kf))
    counts.update(phase_multi_output(cs, adj, kf, training, npk))
    t1 = time.perf_counter()
    counts.update(phase_factor_analysis(cs, adj, kf, training))
    log(f"  phase 4k took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    counts.update(phase_wide_multi_output(cs, adj, kf, training))
    log(f"  phase 4l took {time.perf_counter() - t1:.1f} s")
    log(f"  phase 4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels = phase_times(cs, adj, kf, card, counts)
    log(f"  phase 5 took {time.perf_counter() - t0:.1f} s; "
        f"whole run {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
