#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multimodalmusig_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--theta-parent DIR]

Phases, each of which fails the run (non-zero exit) on any error:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the four kernels with nvcc for sm_90a, one nvcc
     process each, started together: the fused η side (csrc/estep_eta.cu),
     the λ Newton/PCG solve (csrc/lambda_newton.cu; both include
     csrc/lambda_solve.cuh), the θ moments (csrc/theta_moments.cu) and the
     mixture log-likelihoods (csrc/mixture_ll.cu);
     prints the build times and ptxas reports;
  3. λ kernel against its plain PyTorch version, both on the card, on seeded
     SPD problems, with a repeat launch bit-identical: the f32 CAVI budgets
     from a warm start at (100, 560) with MK = 14 (the main path's shape),
     19, 32, 40 and 128 and at (1000, 560, 14) and (1, 560, 19); the cold
     defaults at (100, 560, 14), at ragged D with MK = 19, 40 and 128, either
     side of each layout boundary of `launch_geometry` (MK 16/17, 20/21 and
     32/33, ragged D) and of the few-problem/thread crossover (R = 1, D = 6143 and
     6144 at MK = 14); the R = 1 entry `maximize_lambda_fused` (B2) at
     (560, 14); a dead lane (all-NaN Σ⁻¹) on every layout at MK 14, 19 and
     40; prints the layout, both times (median of 20 CUDA-event timings)
     and the bound at each timed shape and for B2;
  4. η kernel against its plain PyTorch version (ETA_CASES), a repeat
     launch bit-identical, printing the layout `launch_geometry(R, D, MK)`
     picked: (100, 560, K=(7, 7)) at the f32 CAVI budgets and the cold
     defaults and (1000, 560, (7, 7)), K=(20, 20) and (64, 64) at (100,
     560), a ragged M=3 case with odd D, a document with no counts in one
     modality, MK = 128 in three modalities; every layout and either side
     of each boundary: MK 16/17 (thread/pair), 28/29 (pair at P = 14/one
     thread at P = 32), MK 32 on the pair at P = 16 (R = 90) and on one
     thread (R = 100), 32/33 ragged (warp/block), the few-problem
     crossovers at MK 14 ((16, 560)/(18, 560)) and MK 17 (R = 1, D = 3167
     and 3168); above MK 32 K=(32, 32) at (100, 560), K=(20, 12, 8) at
     (100, 2800) (cold defaults), either side of every P of split4 and
     split8 (MK 33, 40/41, 48/49, 56/57, 64/65, 80/81, 96/97, 112/113, 128 at
     (30, 557)) and of the few-problem crossover at MK 40 and 128 (R = 1,
     BLOCK_CROSS); PCAWG's K=(7, 7, 5) at (100, 2800), (1000, 2800) and R = 1
     (MK 29–32 and PCAWG's R ≥ 100 at the cold defaults: ETA_CASES says
     why);
     R = 1 at D = 560, 448, 112, 280 and 2800; one modality (M = 1,
     K = (7,)) at R = 1 and 100; the K selection's K = (5, 5) and (9, 9) at
     (100, 448) and at R = 1 on the 112; prints max |Δ| of ζ, ν and λ, and
     both times and the bound at each R = 100 shape and at ETA_TIMED (the
     R = 1000 and R = 1 ones); then with `lam_prev` (the secant start of
     `lambda_extrap`, c = 1) at ETA_EXTRAP_CASES (every layout, either side
     of its boundaries), each with a small swing λ − λ_prev and one large
     enough that the ±4 clip binds on most entries, with bit-identical
     repeat launches, and timed at (100, 560, K=(7, 7));
  5. θ kernel against its plain PyTorch version at the BRCA shapes
     (100, 560, 96, 7) and (100, 560, 48, 7), at R = 1 and at the ragged
     (3, 33, 128, 11), (2, 8, 5, 2) and (7, 101, 96, 7), at phase 16's
     rank shapes (1, 280, 96, 7), (1, 560, 48, 7) and (1, 560, 24, 7), at the K
     selection's (1, 560, 96, 9) and (100, 448, 48, 5) with log-weights near
     -30 on rare terms, at (100, 560, 96, 7) with LDA's logits (digammas
     of γ = α + counts and of λ = η + counts, down to about -17 and -22),
     and above K = 8 (the split layout) at (100, 560, 96 and 48, 20), (100,
     560, 96, 64), both with rare terms at V = 96, (1000, 560, 96, 20),
     (1, 560, 96, 20), (1, 560, 96, 64) with rare terms, (7, 101, 48, 33)
     and (3, 29, 128, 128) with rare terms, with bit-identical repeat
     launches; prints both times and the bound at the (100, ...) shapes;
  6. main path: the best-of-100 MMCTM K=(7, 7), α=0.1 restart fit on the
     bundled BRCA-EU SNV+SV counts (D=560), float32, tol 1e-5, maxiter 1000,
     through `fit_restarts(...)` on the card, warm, then timed in turns on
     the fused η route and on the "split" route (`ctm_base._eta_route`
     forced): fused, split, split, fused. Checks that the fused runs launch
     the η kernel and the split runs the λ kernel once per CAVI iteration,
     the θ kernel twice, that at least 99 lanes are finite and that the best
     ll per modality is within 5e-3 of the JAX package's value; a short fit
     on the card is also held against the same fit in float64 on the CPU;
  7. single model: `MMCTM([7, 7], [0.1, 0.1], X).fit(maxiter=30,
     verbose=False)` on the card, the η kernel at R = 1; prints its layout;
  8. IMMCTM path: `fit_immctm_restarts([7, 7], [0.1, 0.1], features, X,
     restarts=100, maxiter=1000, tol=1e-5)` on the same counts, with the
     SNV terms factored into substitution × context and the SV terms into
     type × size/region (tools/families_bench.py:66-77), once warm and once
     timed, with the gates of phase 6 against the JAX package's IMMCTM
     value, and its own short card-vs-CPU check; then the same with
     `compact_schedule="auto"`, warm and timed, with the same gates;
  9. compaction: `fit_restarts` at tol 1e-5, warm and then timed, arms in
     turns: R=100 with (178,), R=100 `fit_restarts_auto`, R=100 with
     `chunk_iters=100`, R=1000 with (139, 57, 39) (the pins of
     bench.py:68-70), R=1000 `fit_restarts_auto` and R=1000 unchunked;
     prints each arm's wall, lane-iterations, boundaries and finite lanes,
     the auto arms' pilot, boundary seconds, lane-iterations per second,
     derived schedule and whether the schedule memo served it, the chunked
     arm's progress calls; gates: one η and two θ launches per CAVI
     iteration, at least 99% finite lanes and the ll gate of phase 6, and
     progress that rises to (R, R);
 10. two-stage: `fit_mmctm_restarts([7, 7], [0.1, 0.1], docs, restarts=100)`
     on the card, warm and then timed; prints the stage-1 winners, their
     f64 scores and the selected ll; the selected lane must be finite and
     converged, no more than 5e-3 below the JAX package's two-stage fit
     per modality, and the η kernel must run once per CAVI iteration;
     prints the η layouts each stage ran;
 11. CLI: `cli.main` in this process on the bundled TSVs with --restarts
     1000 --auto-compact --progress and every output, warm and then timed:
     exit 0, one η and two θ launches per CAVI iteration, the selected ll
     within the gate of phase 10, `load_model` of the checkpoint on the card
     gives back the fitted state and ll, the signature probabilities sum to
     1 per (modality, topic) and the proportions per (sample, modality),
     within 1e-6; then `python3 -m multimodalmusig_tpu_torch.cli ...
     --restarts 100` as a process of its own, without --device, must exit 0;
 12. inference, MMCTM: `train_test_split_docs(docs, 0.2, seed=0)` (448 /
     112 documents), `fit_mmctm_restarts([7, 7], [0.1, 0.1], train, V=(96,
     48), restarts=100)`, then `fit_heldout(test, model)`, `transform(model,
     docs)` with fit_gaussian False and True and `predict_modality_eta(Xobs,
     m, model)` for m = 1 and 2 on the 112, each warm and then timed;
     IMMCTM: the same five calls on the IMMCTM phase's selected model.
     Prints each call's wall, CAVI iterations, ms per iteration and η
     layout. Gates:
     finite outputs; one η launch per CAVI iteration and one θ launch per
     observed modality per iteration; a 30-iteration run of each call's
     loop (tol 0) on the card within the stated tolerances of the same run
     in float64 on the CPU from the same trained state; the held-out ll of
     the K=(7, 7) model no more than HELDOUT_SLACK below the JAX package's;
 13. K selection: `select_k_mmctm([(5, 5), (7, 7), (9, 9)], docs, [0.1, 0.1],
     restarts=100, maxiter=1000)` on the card, warm and then timed; prints
     the curve, the chosen K, the wall and the η layouts run; every
     held-out ll finite, one η and two θ launches per CAVI iteration;
 14. LDA and ILDA: `fit_lda_restarts(7, 0.1, 0.1, docs_snv, restarts=100,
     maxiter=1000, tol=1e-5)` on the SNV counts alone, uncut and with
     `compact_schedule="auto"`, the same for `fit_ilda_restarts` with the
     SNV terms factored into substitution × context (J = (6, 16),
     tools/families_bench.py:66-71), and an R=1000 LDA "auto" arm, each warm
     and then timed; prints each arm's wall, CAVI iterations,
     lane-iterations, boundaries and peak device memory. Gates: two θ
     launches per CAVI iteration (no η, no λ), at least 99% finite lanes,
     the selected ll no more than LL_SLACK below the JAX package's, and a
     short card fit of each family against float64 on the CPU; then, on the
     448 / 112 split, `fit_heldout` and `transform` of an R=100 model of
     each family, warm and then timed: one θ launch per CAVI iteration and
     30 iterations of each loop against float64 on the CPU; and an LDA and
     an ILDA checkpoint round trip on the card;
 15. θ launches: one θ call at each BRCA shape runs exactly one device
     kernel (torch.profiler), checked after the timed paths;
 16. multi-device (parallel/sharding.py; ranks are processes of their own,
     which this process's profiler does not slow): on the BRCA-EU counts,
     f32, tol 1e-5, (a) `shmap_fit_restarts(SEED, X, config, [0.1, 0.1],
     restarts=100)` on two ranks sharing the card (gloo) and on one rank
     (NCCL); (b) `fit_immctm_restarts`, `fit_lda_restarts` and
     `fit_ilda_restarts` with phase 8's and phase 14's arguments and
     `devices=[cuda:0, cuda:0]`; (c) `sharded_data_parallel_fit` over
     `make_mesh(1, 2, [cuda:0, cuda:0])` (280 documents a rank) of one
     seeded init, and the same init fit by one rank (mesh (1, 1));
     (d) `sharded_fit_restarts(make_mesh(2, 1, [cuda:0, cuda:0]), ...)` at
     R=100; (e) `sharded_vocab_parallel_fit([cuda:0, cuda:0], ...)` of
     (c)'s init, each rank holding half of every vocabulary ((48, 24)
     items) and running the θ kernel on it, the η kernel on all 560
     documents. Prints each arm's backend, ranks per card, the ranks'
     start-up and the fit's seconds. Gates: phase 6's and phase 14's ll
     gates; the pick within LL_SLACK of the same fit in this process; on
     every rank one η and two θ launches per CAVI iteration of its loop
     (LDA and ILDA two θ, no η); for (c) and (e), the first 30 iterations'
     lls within DP_LL_RTOL (c) or VOCAB_LL_RTOL (e) of the one-process fit
     and every rank stopping at the same iteration; for (e), the final
     ELBO within VOCAB_ELBO_RTOL of the one-process fit's and the
     replicated state the same in every bit on both ranks (the join raises
     otherwise).
 17. the λ solve's options (models/ctm_base.CTMBaseConfig), after phase 10,
     on the same counts, f32, tol 1e-5: `fit_restarts` R=100 with
     `lambda_extrap=1.0` against the default, `fit_mmctm_restarts(...,
     lambda_extrap=1.0)` against the default and `fit_immctm_restarts(...,
     lambda_extrap=1.0)` against the default, each warm and then timed in
     turns (default, extrap, extrap, default), and `fit_restarts` R=100 with
     `lambda_solver="chol"`, warm and then timed; prints each arm's wall,
     iterations (median and maximum), CAVI steps, launches and lls. Gates:
     the ll gates of phases 6, 8 and 10; the extrap arms one η and two θ
     launches per CAVI iteration, the chol arm two θ launches and no η or λ
     launch (the direct Cholesky direction is plain PyTorch, as in the JAX
     package).
 18. PCAWG scale, after phase 13: `fit_restarts(SEED, X, config, [0.1, 0.1,
     0.1], restarts=100)` on the synthetic PCAWG-scale corpus of
     tools/pcawg_bench.py:27 (copied here as `pcawg_corpus`, from
     np.random.default_rng(0): D=2800, V=(96, 48, 24), K=(7, 7, 5), MK 19),
     f32, tol 1e-5, maxiter 1000, warm and then timed; prints its wall,
     CAVI iterations, B3 launches and layouts. Gates: at least 99% finite
     lanes; one η and three θ launches per CAVI iteration.
 19. K=(20, 20), after phase 18: `fit_mmctm_restarts([20, 20], [0.1, 0.1],
     docs, restarts=100)` on the BRCA-EU counts, f32 (MK 40: stage 1 a
     restart batch on split4, stage 2 R = 1 on the block layout), warm and
     then timed in turns: `launch_geometry` as it is, patched to the block
     layout above MK 32 (`block_layout`), the block layout, as it is;
     prints each arm's wall, CAVI steps, ms per step and the η layouts of
     each stage. Gates: at least 99 of 100 stage-1 lanes finite, the
     selected lane converged, one η and two θ launches per CAVI iteration,
     the selected ll per modality no more than 5e-3 below the JAX
     package's two-stage fit of the same call (JAX_CPU_TWO_STAGE_LL_K20).
 20. K = 20 on the θ kernel's split layout, after phase 14: (a) `fit_restarts(SEED,
     X, config, [0.1, 0.1], restarts=1000)` with K=(20, 20) on the BRCA-EU
     counts, f32, tol 1e-5, maxiter 1000, uncut; (b) `fit_lda_restarts(20,
     0.1, 0.1, docs_snv, restarts=100)`; each warm and then timed in turns
     with an earlier commit's θ kernel when `--theta-parent DIR` names one
     (`git archive` of it unpacked at DIR; parent, this, this, parent), else
     this kernel twice; prints each run's wall, CAVI steps, ms per step and
     peak memory. Gates: at least 99% finite lanes; the pick (the picked
     lane's ll per modality; LDA's selected ll) within LL_SLACK of the
     parent's run in this call and of PARENT_K20_PICKS; launches per step:
     (a) one η and two θ, (b) two θ, and nothing else.
 21. the mixture log-likelihoods (ops/ll_kernel.py), after phase 5: the
     kernel against the float64 plain expression (relative gap at most
     LL_RTOL per lane and modality) and a repeat launch bit-identical at
     LL_SHAPES, then, at (100, 2780, K=(7, 7, 5)) and (1000, 560, (7, 7)),
     the kernel's and the plain float32 chain's times (median of 20
     CUDA-event timings) beside the bound: the larger of its bytes at
     3.35 TB/s and its operations (2·K·V + 2·V a cell) at 67 TFLOP/s.
     Each driven path reports the ll wrapper's calls in this process over
     the whole phase (`mixture_ll`: eager calls and graph captures). After
     phase 15, one more main-path fit (phase 2's, fused η route) under the
     program's tracer and torch.profiler: every ll call takes the kernel
     (`lls.plain` 0, `lls.kernel` > 0 and equal to the wrapper's calls),
     and the card runs `mixture_ll_kernel` once per eager call and once
     per tail-graph replay: `lls.kernel` + `graph.replays.tail` times.
The last two lines of standard output are a JSON summary of the kernels and
{"ok": true, "device": {...}}.
"""

import collections
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

SEED = 147959412
RESTARTS = 100
TOL = 1e-5
MAXITER = 1000
KERNEL_ATOL = 5e-5
STATIONARITY_TOL = 1e-2
THETA_RTOL, THETA_ATOL = 2e-5, 1e-4
LL_SLACK = 5e-3
# Best finite ll per modality of the JAX package's best-of-16 fit of the same
# workload on the CPU, float32 (16/16 lanes finite):
#   fit_restarts(jax.random.key(147959412), X,
#                MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=jnp.float32),
#                jnp.asarray([0.1, 0.1], jnp.float32), restarts=16,
#                maxiter=1000, tol=1e-5)   # multimodalmusig_tpu.parallel.restarts
JAX_CPU_BEST_LL = (-3.93717622756958, -3.035710334777832)
# The same for IMMCTM with the features of `brca_features` (16/16 finite):
#   model = IMMCTM([7, 7], [0.1, 0.1], [feats_snv, feats_sv], docs, dtype=jnp.float32)
#   _immctm_restarts_from_keys(jax.random.split(jax.random.key(147959412), 16),
#       model.Xdense, model.F, model.state.alpha, config=model.config,
#       maxiter=1000, tol=1e-5)   # the runner of fit_immctm_restarts
JAX_CPU_BEST_IMMCTM_LL = (-3.955171585083008, -3.0439767837524414)
# The selected model's ll of the JAX package's two-stage fit of the same
# workload on the CPU, float32 (stage 1 at tol 1e-4, stage 2 at 1e-5):
#   fit_mmctm_restarts([7, 7], [0.1, 0.1], docs, restarts=16,
#                      dtype=jnp.float32)   # multimodalmusig_tpu.parallel.restarts
JAX_CPU_TWO_STAGE_LL = (-3.9388527870178223, -3.034494638442993)
# The same at K = (20, 20) (phase 19; MK 40, B3's split4 range):
#   fit_mmctm_restarts([20, 20], [0.1, 0.1], docs, restarts=16,
#                      dtype=jnp.float32)   # multimodalmusig_tpu.parallel.restarts
K20 = (20, 20)
JAX_CPU_TWO_STAGE_LL_K20 = (-3.930232048034668, -3.015367031097412)
# Phase 20's picks with the θ kernel before its chunk layout (the tile
# layout padded to a power of two at K > 8), on an NVIDIA H100 80GB HBM3 at
# 700 W: the R=1000 MMCTM K=(20, 20) fit's picked lane, ll per modality, and
# the R=100 LDA K=20 fit's selected ll.
PARENT_K20_PICKS = {"MMCTM K=(20, 20) R=1000": [-3.929126739501953, -3.0120770931243896],
                    "LDA K=20 R=100": [-3.9291162490844727]}
# The selected ll of the JAX package's best-of-16 LDA and ILDA fits of the
# BRCA-EU SNV counts on the CPU, float32 (16/16 lanes finite in each; the
# ILDA features as `brca_features` gives them for SNV, J = (6, 16)):
#   fit_lda_restarts(7, 0.1, 0.1, docs_snv, restarts=16, maxiter=1000, tol=1e-5,
#                    dtype=jnp.float32)   # multimodalmusig_tpu.parallel.restarts
#   fit_ilda_restarts(7, 0.1, 0.1, feats_snv, docs_snv, restarts=16, maxiter=1000,
#                     tol=1e-5, dtype=jnp.float32)
JAX_CPU_LDA_LL = -3.9380016326904297
JAX_CPU_ILDA_LL = -3.956483840942383
# (family, restarts, compact_schedule) of the LDA and ILDA phase, in turns
LDA_ARMS = (("LDA", 100, None), ("LDA", 100, "auto"), ("ILDA", 100, None),
            ("ILDA", 100, "auto"), ("LDA", 1000, "auto"))
ETA_RTOL, ETA_ATOL = 2e-5, 2e-6
# The held-out ll per modality of the JAX package's K=(7, 7) model on the
# same split, on the CPU, float32 (seeds 1 and 2 gave (-4.186100006103516,
# -3.006852626800537) and (-4.185704708099365, -3.010918378829956), a spread
# of 6.5e-4 and 4.8e-3, so the slack is the floor of 5e-3):
#   train, test = train_test_split_docs(docs, 0.2, seed=0)   # model_selection
#   model = fit_mmctm_restarts([7, 7], [0.1, 0.1], train, V=(96, 48), restarts=16,
#                              dtype=jnp.float32)   # multimodalmusig_tpu.parallel.restarts
#   fit_heldout(test, model).ll                     # multimodalmusig_tpu.models.mmctm
JAX_CPU_HELDOUT_LL = (-4.185447692871094, -3.011613130569458)
HELDOUT_SLACK = 5e-3
# A 30-iteration inference loop (tol 0) in float32 on the card against the
# same loop in float64 on the CPU: the largest |Δ| of the proportions or of
# η, and the largest relative |Δ| of the per-iteration lls
# (the largest seen on an H100: 7.3e-5, 2.4e-5 and 1.4e-7, PERF.md §2)
INFER_PROPS_ATOL, INFER_ETA_ATOL, INFER_LL_RTOL = 2.5e-4, 2.5e-4, 1e-6
# the K selection's candidates
K_CANDIDATES = ((5, 5), (7, 7), (9, 9))
# (restarts, how the fit is cut) of the compaction phase, in turns: the JAX
# package's pinned schedules (bench.py:68-70), the schedule fit_restarts_auto
# derives at both counts, a boundary every 100 iterations, and R=1000 unchunked
COMPACTION_ARMS = ((100, dict(compact_schedule=(178,))), (100, "auto"),
                   (100, dict(chunk_iters=100)), (1000, dict(compact_schedule=(139, 57, 39))),
                   (1000, "auto"), (1000, {}))
# restarts of the CLI phase: the CLI's default
CLI_RESTARTS = 1000
# The data-parallel fit's first 30 iterations against the one-process fit
# from the same init, f32 on the card: the largest relative |Δ| of the lls,
# 3× the largest seen on an H100 (3.05e-7 over two ranks, 1.2e-7 on one;
# PERF.md §6)
DP_LL_RTOL = 9.2e-7
DP_ITERS = 30
# The vocab-sharded fit's first 30 iterations against the one-process fit
# from the same init, f32 on the card: the largest relative |Δ| of the lls,
# 3× the largest seen on an H100 (1.553e-7 over two ranks in three runs;
# PERF.md §6)
VOCAB_LL_RTOL = 4.66e-7
# Its final ELBO against the one-process fit's, f32 on the card: 3× the
# largest relative |Δ| seen on an H100 (3.58e-7, 5 of 13977267, in four
# runs; PERF.md §2)
VOCAB_ELBO_RTOL = 1.08e-6
# The card's published peaks (H100 SXM, 700 W): memory rate and float32
# rate outside the tensor cores, for the kernels' bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of `fn()` by CUDA events, one event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def spd_problem(gen, R, D, MK, device):
    """Seeded λ problems as in tests/test_pallas_kernels.py: well-posed SPD
    Σ⁻¹ = I + 0.05·AAᵀ/MK per lane, counts-scale Ndivζ and sumθ."""
    import torch

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, dtype=torch.float64)

    A = torch.randn(R, MK, MK, generator=gen, dtype=torch.float64)
    invS = torch.eye(MK, dtype=torch.float64) + 0.05 * (A @ A.mT) / MK
    args = (
        torch.zeros(R, D, MK, dtype=torch.float64),
        u(0.5, 1.5, R, D, MK),
        u(1.0, 10.0, R, D, MK),
        u(0.0, 5.0, R, D, MK),
        torch.randn(R, MK, generator=gen, dtype=torch.float64),
        invS,
    )
    return [a.to(device=device, dtype=torch.float32) for a in args]


def lambda_phase(lk):
    """B1 against its plain version at every shape below (and a repeat
    launch bit-identical), timed at the shapes marked so, then B2 (the R = 1
    entry), then a dead lane on every layout. Returns the largest error, the
    main-path shape's (ms, plain ms) and one record per timed shape."""
    import torch
    from multimodalmusig_tpu_torch.ops.solvers import (
        CG_F32_CAVI, LAMBDA_NITER_F32_CAVI, LAMBDA_POLISH_F32_CAVI, lambda_grad,
    )

    cavi = dict(n_iter=LAMBDA_NITER_F32_CAVI, cg_iter=CG_F32_CAVI,
                polish_iter=LAMBDA_POLISH_F32_CAVI)
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    timings = {}
    shapes = []
    # (label, shape, budgets, warm start and timed)
    for label, (R, D, MK), budgets, timed in (
        ("main-path shape, f32 CAVI budgets, warm start", (RESTARTS, 560, 14), cavi, True),
        ("main-path shape, cold defaults", (RESTARTS, 560, 14), {}, False),
        ("R=1000, f32 CAVI budgets, warm start", (1000, 560, 14), cavi, True),
        ("MK=19 (PCAWG), f32 CAVI budgets, warm start", (RESTARTS, 560, 19), cavi, True),
        ("MK=32, f32 CAVI budgets, warm start", (RESTARTS, 560, 32), cavi, True),
        ("ragged D=33, MK=19, cold defaults", (3, 33, 19), {}, False),
        ("MK=40, f32 CAVI budgets, warm start", (RESTARTS, 560, 40), cavi, True),
        ("ragged D=37, MK=40, cold defaults", (3, 37, 40), {}, False),
        ("MK=128, f32 CAVI budgets, warm start", (RESTARTS, 560, 128), cavi, True),
        ("ragged D=29, MK=128, cold defaults", (3, 29, 128), {}, False),
        ("MK=16, the thread layout's last, ragged D", (30, 559, 16), {}, False),
        ("MK=17, the pair layout's first, ragged D", (30, 559, 17), {}, False),
        ("MK=20, the pair layout's last, ragged D", (30, 559, 20), {}, False),
        ("MK=21, the thread layout's first above the pair, ragged D", (30, 559, 21), {}, False),
        ("MK=32, the thread layout's last, ragged D", (60, 557, 32), {}, False),
        ("MK=33, the block layout's first, ragged D", (3, 37, 33), {}, False),
        ("R=1, D=6143: the warp group's last count at MK=14", (1, 6143, 14), {}, False),
        ("R=1, D=6144: the thread layout's first count at MK=14", (1, 6144, 14), {}, False),
        ("R=1, MK=19, f32 CAVI budgets, warm start", (1, 560, 19), cavi, True),
    ):
        lam0, nu, ndz, st, mu, invS = spd_problem(gen, R, D, MK, "cuda")
        if timed:
            # a CAVI-like warm start: near the optimum of the previous iterate
            opt = lk.maximize_lambda_restarts_plain(lam0, nu, ndz, st, mu, invS)
            noise = torch.randn(R, D, MK, generator=gen, dtype=torch.float64)
            lam0 = opt + 0.05 * noise.to(device="cuda", dtype=torch.float32)
        args = (lam0, nu, ndz, st, mu, invS)
        geo = tuple(lk.launch_geometry(R, D, MK))
        got = lk.maximize_lambda_restarts(*args, **budgets)
        again = lk.maximize_lambda_restarts(*args, **budgets)
        want = lk.maximize_lambda_restarts_plain(*args, **budgets)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        g = lambda_grad(got, nu, ndz, st, mu.unsqueeze(-2), invS)
        gmax = float(g.abs().max())
        print(f"λ kernel vs plain [{label}] (R, D, MK)=({R}, {D}, {MK}), layout {geo}: "
              f"max|kernel - plain| = {err:.3e}, max|grad| at kernel result = {gmax:.3e}, "
              f"repeat launch bit-identical: {bool(torch.equal(got, again))}")
        if not torch.isfinite(got).all():
            fail(f"λ kernel result not finite [{label}]")
        if err > KERNEL_ATOL:
            fail(f"λ kernel disagrees with its plain version by {err:.3e} > {KERNEL_ATOL} [{label}]")
        if gmax > STATIONARITY_TOL:
            fail(f"λ kernel result not stationary: |g| = {gmax:.3e} [{label}]")
        if not torch.equal(got, again):
            fail(f"two λ kernel launches on the same inputs differ [{label}]")
        max_err = max(max_err, err)
        if timed:
            ms = cuda_ms(lambda: lk.maximize_lambda_restarts(*args, **budgets))
            plain_ms = cuda_ms(lambda: lk.maximize_lambda_restarts_plain(*args, **budgets))
            bound_ms, bound_by = lambda_bound(R, D, MK, 3, 4, 1)
            timings[(R, MK)] = (ms, plain_ms)
            shapes.append({"kernel": "B1", "shape": [R, D, MK], "budgets": "cavi",
                           "layout": list(geo), "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by})
            print(f"λ time at ({R}, {D}, {MK}), f32 CAVI budgets, layout {geo}: kernel "
                  f"{ms:.4f} ms, plain PyTorch {plain_ms:.4f} ms (median of 20 CUDA-event "
                  f"timings); bound {bound_ms:.6f} ms ({bound_by}), {ms / bound_ms:.1f}x")

    # the R = 1 entry (B2, the TPU kernel's maximize_lambda_fused, one shared
    # μ/Σ⁻¹), at the cold defaults: 7 Newton steps, PCG min(14, 10), polish 2
    args = tuple(t[0] for t in spd_problem(gen, 1, 560, 14, "cuda"))
    got = lk.maximize_lambda_fused(*args)
    want = lk.maximize_lambda_restarts_plain(*(t[None] for t in args))[0]
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    geo = tuple(lk.launch_geometry(1, 560, 14))
    print(f"λ kernel R = 1 entry maximize_lambda_fused (560, 14), cold defaults, layout {geo}: "
          f"max|kernel - plain| = {err:.3e}")
    if not torch.isfinite(got).all() or err > KERNEL_ATOL:
        fail(f"the R = 1 λ entry disagrees with its plain version by {err:.3e}")
    max_err = max(max_err, err)
    b2_ms = cuda_ms(lambda: lk.maximize_lambda_fused(*args))
    b2_plain_ms = cuda_ms(lambda: lk.maximize_lambda_restarts_plain(*(t[None] for t in args)))
    b2_bound_ms, b2_by = lambda_bound(1, 560, 14, 7, 10, 2)
    shapes.append({"kernel": "B2", "shape": [560, 14], "budgets": "cold", "layout": list(geo),
                   "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound_ms,
                   "bound_by": b2_by})
    print(f"B2 (maximize_lambda_fused) time at (560, 14), cold defaults: kernel {b2_ms:.4f} ms, "
          f"plain PyTorch {b2_plain_ms:.4f} ms (median of 20 CUDA-event timings); bound "
          f"{b2_bound_ms:.6f} ms ({b2_by}); one PyTorch call: none")

    # a dead lane (an all-NaN Σ⁻¹, a failed Cholesky) on every layout: NaN,
    # and the other lanes bit-identical to the run without it
    for MK in (14, 19, 40):
        args = spd_problem(gen, 3, 70, MK, "cuda")
        invS = args[5].clone()
        invS[1] = float("nan")
        for geo in lk._candidate_geometries(MK):
            alive = lk._launch_at(geo, *args, **cavi)
            dead = lk._launch_at(geo, *args[:5], invS, **cavi)
            ok = bool(torch.isnan(dead[1]).all() and torch.equal(dead[[0, 2]], alive[[0, 2]]))
            print(f"λ kernel dead lane at MK={MK}, layout {tuple(geo)}: stays NaN and apart: {ok}")
            if not ok:
                fail(f"a dead lane leaked or revived at MK={MK} on layout {tuple(geo)}")
    return max_err, timings[(RESTARTS, 14)], shapes


def solve_flops(MK, n_iter, cg_iter, polish_iter):
    """Float operations of one (restart, document) λ solve
    (csrc/lambda_solve.cuh), each add, multiply, divide, exp and sqrt
    counted once: a matvec 2·MK², a PCG iteration a matvec and 12·MK plus
    4·MK to start; a Newton step 2 matvecs, a PCG, 6 dot products and 16
    line-search candidates of 4·MK; a polish step a matvec, a PCG, 3 dot
    products or maxima and 6·MK."""
    mv = 2 * MK * MK
    pcg = cg_iter * (mv + 12 * MK) + 4 * MK
    newton = 2 * mv + pcg + 6 * 2 * MK + 16 * 4 * MK
    polish = mv + pcg + 3 * 2 * MK + 6 * MK
    return n_iter * newton + polish_iter * polish


def bound(n_bytes, flops):
    """(ms, "bytes" or "operations"): the least time of the card for this
    work, at its published memory rate and float32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lambda_bound(R, D, MK, n_iter, cg_iter, polish_iter):
    """The λ kernel: reads λ, ν, Ndivζ, sumθ (R, D, MK), μ (R, MK) and
    Σ⁻¹ (R, MK, MK) once and writes λ (R, D, MK)."""
    n_bytes = 4 * (5 * R * D * MK + R * MK + R * MK * MK)
    return bound(n_bytes, R * D * solve_flops(MK, n_iter, cg_iter, polish_iter))


def eta_bound(R, D, K, n_iter, cg_iter, polish_iter, nu_n_iter, lam_prev=False):
    """The η kernel: reads λ, ν, sumθ (R, D, MK), N (D, M), μ and Σ⁻¹ once
    and writes ζ (R, D, M), ν and λ (R, D, MK); per problem, besides the λ
    solve, ζ and N/ζ take 4·MK operations, the ν setup 3·MK, each
    fixed-point sweep 7·MK and each of the 4 Newton steps 16·MK. With
    `lam_prev` it also reads λ_prev (R, D, MK) and forms the secant start,
    5·MK operations."""
    MK, M = sum(K), len(K)
    n_bytes = 4 * ((6 if lam_prev else 5) * R * D * MK + D * M + R * MK + R * MK * MK
                   + R * D * M)
    nu = (4 + 3 + 7 * nu_n_iter + 4 * 16 + (5 if lam_prev else 0)) * MK
    return bound(n_bytes, R * D * (solve_flops(MK, n_iter, cg_iter, polish_iter) + nu))


def theta_bound(R, D, V, K):
    """The θ kernel, per modality: reads λ's block (R, D, K), logw (R, V, K)
    and X (D, V) once and writes sumθ (R, D, K) and the scatter (R, K, V).
    The least work is the factorized schedule's (ctm_base.theta_moments):
    per (r, d, v) cell three K-wide contractions of 2·K operations and one
    division, and per λ and logw entry a subtraction of the max and an
    exp."""
    n_bytes = 4 * (2 * R * D * K + 2 * R * V * K + D * V)
    return bound(n_bytes, R * (6 * D * V * K + D * V + 2 * (D * K + V * K)))


def eta_problem(gen, R, D, K, zero_count=False):
    """The λ problems of `spd_problem` with a starting λ near 0, document
    counts N (D, M) and, optionally, a document with no counts in its second
    modality (its sumθ there 0 too)."""
    import torch

    MK = sum(K)
    _, nu, _, st, mu, invS = spd_problem(gen, R, D, MK, "cpu")
    lam = 0.5 * torch.randn(R, D, MK, generator=gen)
    N = torch.randint(0, 200, (D, len(K)), generator=gen).float()
    if zero_count:
        N[0, 1] = 0.0
        st[:, 0, K[0]:K[0] + K[1]] = 0.0
    return [t.to("cuda") for t in (lam, nu, N, st, mu, invS)]


# launch_geometry's few-problem crossover (ops/estep_kernel.py
# _few_problems) at MK 40 and 128: the block layout below, split4 or split8
# from there
BLOCK_CROSS = {40: 1000, 128: 1500}
# (label, (R, D, K), CAVI budgets or the cold defaults, a zero-count
# modality) of the η phase: the main path, every layout and either side of
# each boundary of `launch_geometry`, the inference, rank, K selection and
# PCAWG shapes.
ETA_CASES = (
    ("main-path shape", (RESTARTS, 560, (7, 7)), True, False),
    ("main-path shape", (RESTARTS, 560, (7, 7)), False, False),
    ("main-path shape at R=1000", (1000, 560, (7, 7)), True, False),
    ("K=(20, 20)", (RESTARTS, 560, (20, 20)), True, False),
    ("K=(64, 64)", (RESTARTS, 560, (64, 64)), True, False),
    ("ragged M=3, odd D=37", (3, 37, (3, 4, 5)), False, False),
    ("zero counts in one modality", (2, 9, (3, 2)), False, True),
    ("MK=128 in three modalities", (3, 29, (40, 50, 38)), False, False),
    ("MK=16, the thread layout's last MK", (RESTARTS, 560, (8, 8)), True, False),
    ("MK=17, the pair layout's first", (RESTARTS, 560, (9, 8)), True, False),
    ("PCAWG's MK=19", (RESTARTS, 560, (10, 9)), True, False),
    ("MK=28, the pair's last at P=14", (RESTARTS, 560, (14, 14)), True, False),
    # MK 29–32, and PCAWG's hundreds of thousands of problems, at the cold
    # defaults: at the CAVI budgets from λ ~ 0.5·N(0, 1) about one problem in
    # 10^4 at MK 29–32 (one in 10^6 at MK 19) sits at a near-tie of the line
    # search, where the step taken depends on the order of the sums, on the
    # pair as on the warp layout (tests/test_torch_cuda.py
    # test_eta_kernel_at_a_line_search_tie)
    ("MK=29, one thread at P=32", (RESTARTS, 560, (15, 14)), False, False),
    ("MK=32, one thread at P=32", (RESTARTS, 560, (16, 16)), False, False),
    ("MK=32, the pair at P=16", (90, 560, (16, 16)), False, False),
    ("MK=32, the warp layout's last", (3, 50, (16, 16)), False, False),
    ("MK=33 at few problems, the block layout", (3, 50, (17, 16)), False, False),
    # MK 33–128: split4 (P = 10, 12, 14, 16) and split8 (the same P) either
    # side of each boundary, at a ragged D; the few-problem crossovers
    ("MK=33, split4's first (P=10)", (30, 557, (17, 16)), True, False),
    ("MK=40, split4 P=10's last", (30, 557, (20, 20)), True, False),
    ("MK=41, split4 P=12's first", (30, 557, (21, 20)), True, False),
    ("MK=48, split4 P=12's last", (30, 557, (24, 24)), True, False),
    ("MK=49, split4 P=14's first", (30, 557, (25, 24)), True, False),
    ("MK=56, split4 P=14's last", (30, 557, (28, 28)), True, False),
    ("MK=57, split4 P=16's first", (30, 557, (29, 28)), True, False),
    ("MK=64, split4's last", (30, 557, (32, 32)), True, False),
    ("MK=65, split8's first (P=10)", (30, 557, (33, 32)), True, False),
    ("MK=80, split8 P=10's last", (30, 557, (40, 40)), True, False),
    ("MK=81, split8 P=12's first", (30, 557, (41, 40)), True, False),
    ("MK=96, split8 P=12's last", (30, 557, (48, 48)), True, False),
    ("MK=97, split8 P=14's first", (30, 557, (49, 48)), True, False),
    ("MK=112, split8 P=14's last", (30, 557, (56, 56)), True, False),
    ("MK=113, split8 P=16's first", (30, 557, (57, 56)), True, False),
    ("MK=128, split8 P=16", (30, 557, (64, 64)), True, False),
    ("K=(32, 32)", (RESTARTS, 560, (32, 32)), True, False),
    # at the CAVI budgets one problem of these 280,000 sits at a near-tie of
    # the line search (the block layout as split4), so the cold defaults
    ("three modalities K=(20, 12, 8) at D=2800", (RESTARTS, 2800, (20, 12, 8)), False, False),
    ("few-problem crossover at MK=40, below", (1, BLOCK_CROSS[40] - 1, (20, 20)), True, False),
    ("few-problem crossover at MK=40, above", (1, BLOCK_CROSS[40], (20, 20)), True, False),
    ("few-problem crossover at MK=128, below", (1, BLOCK_CROSS[128] - 1, (64, 64)), True, False),
    ("few-problem crossover at MK=128, above", (1, BLOCK_CROSS[128], (64, 64)), True, False),
    ("stage 2 of the K=(20, 20) fit, R=1", (1, 560, (20, 20)), True, False),
    ("PCAWG, K=(7, 7, 5)", (RESTARTS, 2800, (7, 7, 5)), False, False),
    ("PCAWG at R=1000", (1000, 2800, (7, 7, 5)), False, False),
    ("R=1 (stage 2, MMCTM.fit)", (1, 560, (7, 7)), True, False),
    ("R=1 at the 448 training documents", (1, 448, (7, 7)), True, False),
    ("R=1 at the 112 held-out documents", (1, 112, (7, 7)), True, False),
    ("R=1 at a data rank's 280 documents", (1, 280, (7, 7)), True, False),
    ("R=1 at D=2800", (1, 2800, (7, 7)), True, False),
    ("PCAWG at R=1", (1, 2800, (7, 7, 5)), True, False),
    ("few-problem crossover at MK=14, below", (16, 560, (7, 7)), True, False),
    ("few-problem crossover at MK=14, above", (18, 560, (7, 7)), True, False),
    ("few-problem crossover at MK=17, below", (1, 3167, (9, 8)), True, False),
    ("few-problem crossover at MK=17, above", (1, 3168, (9, 8)), True, False),
    ("one modality (M = 1), R=1", (1, 560, (7,)), True, False),
    ("one modality (M = 1)", (RESTARTS, 560, (7,)), True, False),
    ("K selection's MK=10", (RESTARTS, 448, (5, 5)), True, False),
    ("K selection's MK=10, R=1 at the 112 held-out documents", (1, 112, (5, 5)), True, False),
    ("K selection's MK=18", (RESTARTS, 448, (9, 9)), True, False),
    ("K selection's MK=18, R=1 at the 112 held-out documents", (1, 112, (9, 9)), True, False),
)
# the η phase's timed shapes besides those at R = RESTARTS: the main path's
# at R = 1000, and R = 1 at stage 2's, inference's, a rank's and PCAWG's D,
# and phase 19's stage 2
ETA_TIMED = {(1000, 560, (7, 7)), (1, 560, (7, 7)), (1, 448, (7, 7)), (1, 112, (7, 7)),
             (1, 280, (7, 7)), (1, 2800, (7, 7, 5)), (1, 560, (20, 20))}


# (label, (R, D, K), CAVI budgets or the cold defaults) of the checks with
# `lam_prev`: every layout, either side of its boundaries.
ETA_EXTRAP_CASES = (
    ("main-path shape", (RESTARTS, 560, (7, 7)), True),
    ("MK=16, the thread layout's last MK", (RESTARTS, 560, (8, 8)), True),
    ("MK=17, the pair layout's first", (RESTARTS, 560, (9, 8)), True),
    ("K selection's MK=18 on the pair", (RESTARTS, 448, (9, 9)), True),
    ("MK=29, one thread at P=32, cold defaults", (RESTARTS, 560, (15, 14)), False),
    ("MK=32, the pair at P=16, cold defaults", (90, 560, (16, 16)), False),
    ("MK=32, the warp layout's last, cold defaults", (3, 50, (16, 16)), False),
    ("MK=33 at few problems, the block layout, cold defaults", (3, 50, (17, 16)), False),
    ("MK=40, split4", (30, 557, (20, 20)), True),
    ("MK=128, split8", (30, 557, (64, 64)), True),
    ("R=1", (1, 560, (7, 7)), True),
    ("PCAWG at R=1", (1, 2800, (7, 7, 5)), True),
    ("few-problem crossover at MK=14, below", (16, 560, (7, 7)), True),
    ("few-problem crossover at MK=14, above", (18, 560, (7, 7)), True),
    ("few-problem crossover at MK=17, below", (1, 3167, (9, 8)), True),
    ("few-problem crossover at MK=17, above", (1, 3168, (9, 8)), True),
)


def eta_check(ek, label, args, K, kw):
    """The η kernel against its plain version on `args`, with a repeat
    launch bit-identical; returns the largest |Δ|."""
    import torch

    got = ek.estep_eta_fused(*args, K, **kw)
    again = ek.estep_eta_fused(*args, K, **kw)
    want = ek.estep_eta_fused_plain(*args, K, **kw)
    torch.cuda.synchronize()
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    R, D, MK = args[0].shape
    print(f"{label} (R, D, K)=({R}, {D}, {K}), layout {tuple(ek.launch_geometry(R, D, MK))}: "
          f"max|Δζ| = {errs[0]:.3e}, max|Δν| = {errs[1]:.3e}, max|Δλ| = {errs[2]:.3e}, "
          f"repeat launch bit-identical: {same}")
    if not all(torch.isfinite(g).all() for g in got):
        fail(f"{label}: result not finite")
    for name, g, w in zip(("ζ", "ν"), got, want):
        if not bool(((g - w).abs() <= ETA_ATOL + ETA_RTOL * w.abs()).all()):
            fail(f"{label}: {name} disagrees with its plain version beyond rtol {ETA_RTOL}, "
                 f"atol {ETA_ATOL}")
    if errs[2] > KERNEL_ATOL:
        fail(f"{label}: λ disagrees with its plain version by {errs[2]:.3e} > {KERNEL_ATOL}")
    if not same:
        fail(f"{label}: a repeat launch differs")
    return max(errs)


def eta_phase(ek):
    """B3 against its plain version at ETA_CASES, timed at R = RESTARTS and
    at ETA_TIMED, then with `lam_prev`. Returns the largest error, the
    main-path shape's (ms, plain ms) and one record per timed shape."""
    import torch

    cavi = dict(n_iter=3, cg_iter=4, polish_iter=1, nu_n_iter=4)
    gen = torch.Generator().manual_seed(2)
    max_err = 0.0
    shapes = []
    for label, (R, D, K), at_cavi, zero in ETA_CASES:
        budgets = cavi if at_cavi else {}
        budget_name = "f32 CAVI budgets" if at_cavi else "cold defaults"
        args = eta_problem(gen, R, D, K, zero)
        max_err = max(max_err, eta_check(ek, f"η kernel vs plain [{label}, {budget_name}]",
                                         args, K, budgets))
        if R == RESTARTS or (R, D, K) in ETA_TIMED:
            ms = cuda_ms(lambda: ek.estep_eta_fused(*args, K, **budgets))
            plain_ms = cuda_ms(lambda: ek.estep_eta_fused_plain(*args, K, **budgets), reps=5)
            MK = sum(K)
            steps = ((3, 4, 1, 4) if budgets else (7, min(MK, 10), 2, 8))
            bound_ms, bound_by = eta_bound(R, D, K, *steps)
            geo = list(ek.launch_geometry(R, D, MK))
            shapes.append({"shape": [R, D, list(K)], "budgets": "cavi" if budgets else "cold",
                           "layout": geo, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by})
            print(f"η time at ({R}, {D}, {K}), {budget_name}, layout {tuple(geo)}: kernel "
                  f"{ms:.4f} ms, plain PyTorch {plain_ms:.4f} ms (median of 20 and 5 CUDA-event "
                  f"timings, the wrapper's host time included); bound {bound_ms:.6f} ms "
                  f"({bound_by})")
    max_err = max(max_err, eta_extrap_checks(ek, gen, cavi))
    main = next(x for x in shapes if x["shape"] == [RESTARTS, 560, [7, 7]]
                and x["budgets"] == "cavi")
    return max_err, (main["ms"], main["plain_ms"]), shapes


def eta_extrap_checks(ek, gen, cavi):
    """The η kernel with `lam_prev` (the secant start, c = 1) against its
    plain version at the main-path shape, on every layout and either side
    of its boundaries, with a swing λ − λ_prev of 0.3 and of 8 (the ±4 clip
    binds on most entries), repeats bit-identical; timed at the main-path
    shape. Returns the largest |Δ|."""
    import torch

    max_err = 0.0
    for label, (R, D, K), at_cavi in ETA_EXTRAP_CASES:
        budgets = cavi if at_cavi else {}
        args = eta_problem(gen, R, D, K)
        for swing in (0.3, 8.0):
            noise = torch.randn(args[0].shape, generator=gen).to(args[0].device)
            lam_prev = args[0] - swing * noise
            clipped = float(((args[0] - lam_prev).abs() > 4.0).float().mean())
            kw = dict(budgets, lam_prev=lam_prev, extrap=1.0)
            max_err = max(max_err, eta_check(
                ek, f"η kernel with lam_prev vs plain [{label}, swing {swing}, clip binds on "
                f"{clipped:.3f} of the entries]", args, K, kw))
        if R == RESTARTS and K == (7, 7):
            kw = dict(budgets, lam_prev=lam_prev, extrap=1.0)
            ms = cuda_ms(lambda: ek.estep_eta_fused(*args, K, **kw))
            base_ms = cuda_ms(lambda: ek.estep_eta_fused(*args, K, **budgets))
            plain_ms = cuda_ms(lambda: ek.estep_eta_fused_plain(*args, K, **kw))
            bound_ms, bound_by = eta_bound(R, D, K, 3, 4, 1, 4, lam_prev=True)
            print(f"η time with lam_prev at ({R}, {D}, {K}), f32 CAVI budgets: kernel "
                  f"{ms:.4f} ms (without lam_prev {base_ms:.4f} ms), plain PyTorch "
                  f"{plain_ms:.4f} ms (median of 20 CUDA-event timings); bound "
                  f"{bound_ms:.6f} ms ({bound_by})")
    return max_err


@contextlib.contextmanager
def eta_layouts(ek):
    """While active, records the η kernel's launches by shape and layout:
    yields a Counter of ((R, D, MK), layout) -> launches, read from the
    wrapper's call of `launch_geometry`."""
    seen = collections.Counter()
    pick = ek.launch_geometry

    def spy(R, D, MK):
        geo = pick(R, D, MK)
        seen[((R, D, MK), tuple(geo))] += 1
        return geo

    ek.launch_geometry = spy
    try:
        yield seen
    finally:
        ek.launch_geometry = pick


def layouts_line(seen):
    """The layouts of an `eta_layouts` record, each with its launches and
    the (R, D, MK) shapes it ran."""
    by_layout = collections.defaultdict(lambda: [0, set()])
    for (shape, geo), n in seen.items():
        by_layout[geo][0] += n
        by_layout[geo][1].add(shape)
    return "; ".join(f"{geo}: {n} launches at (R, D, MK) {sorted(shapes)}"
                     for geo, (n, shapes) in sorted(by_layout.items()))


def lda_logits(gen, R, D, V, K, X):
    """LDA's θ-kernel inputs: E[ln θ] and E[ln β], the digammas of γ = α +
    counts (each document's counts split over the topics by weights u^8, u
    uniform, so most topics get almost none) and of λ = η + counts (each
    term's counts split alike), α = η = 0.1, as an LDA fit has them."""
    import torch

    def split(totals, *shape):
        w = torch.rand(*shape, generator=gen) ** 8
        return 0.1 + totals * w / w.sum(dim=-1, keepdim=True)

    gamma = split(X.sum(dim=1)[None, :, None], R, D, K)
    lam = split(X.sum(dim=0)[None, :, None], R, V, K)
    dg = torch.special.digamma
    return dg(gamma) - dg(gamma.sum(dim=-1, keepdim=True)), dg(lam) - dg(lam.sum(dim=-2,
                                                                                keepdim=True))


def theta_problem(gen, R, D, V, K, logits="ctm"):
    """The θ kernel's inputs on the card: those of tests/test_pallas_kernels.py
    per restart lane ("ctm": λ ~ 2·N(0, 1), log ϕ ~ N(0, 1) - 4, counts 0..29),
    with log ϕ about -30 on every fifth (rare) term in all topics but the
    first ("rare"), or LDA's logits (`lda_logits`, "lda")."""
    import torch

    lam = 2.0 * torch.randn(R, D, K, generator=gen)
    logw = torch.randn(R, V, K, generator=gen) - 4.0
    if logits == "rare":  # log ϕ about -30 in all topics but the one that owns it
        logw[:, ::5, 1:] -= 26.0
    X = torch.randint(0, 30, (D, V), generator=gen).float()
    if logits == "lda":
        lam, logw = lda_logits(gen, R, D, V, K, X)
    return [t.to("cuda") for t in (lam, logw, X)]


def theta_phase(tk):
    import torch

    gen = torch.Generator().manual_seed(1)
    max_err = 0.0
    timings = {}
    # (R, D, V, K, logits): the K selection's two with rare terms, K = 9 (the
    # split layout) and K = 5; the LDA and ILDA fits' with LDA's; phase 16
    # (c)'s data ranks' and (e)'s vocab ranks' (V = 48 and 24); K 20–128
    # (the split layout): phase 19's and 20's K = 20 and K = 64 at R = 100,
    # with rare terms too, R = 1000, R = 1, ragged D and V = 128
    for R, D, V, K, logits in ((RESTARTS, 560, 96, 7, "ctm"), (RESTARTS, 560, 48, 7, "ctm"),
                               (3, 33, 128, 11, "ctm"), (2, 8, 5, 2, "ctm"),
                               (1, 560, 96, 7, "ctm"), (7, 101, 96, 7, "ctm"),
                               (1, 280, 96, 7, "ctm"), (1, 560, 48, 7, "ctm"),
                               (1, 560, 24, 7, "ctm"),
                               (1, 560, 96, 9, "rare"), (RESTARTS, 448, 48, 5, "rare"),
                               (RESTARTS, 560, 96, 7, "lda"),
                               (RESTARTS, 560, 96, 20, "ctm"), (RESTARTS, 560, 48, 20, "ctm"),
                               (RESTARTS, 560, 96, 64, "ctm"), (RESTARTS, 560, 96, 20, "rare"),
                               (RESTARTS, 560, 96, 64, "rare"), (1000, 560, 96, 20, "ctm"),
                               (1, 560, 96, 20, "ctm"), (1, 560, 96, 64, "rare"),
                               (7, 101, 48, 33, "ctm"), (3, 29, 128, 128, "rare")):
        args = theta_problem(gen, R, D, V, K, logits)
        if logits == "lda":
            print(f"θ kernel LDA logits: E[ln θ] down to {float(args[0].min()):.2f}, E[ln β] "
                  f"down to {float(args[1].min()):.2f}")
        got = tk.theta_moments_fused(*args)
        again = tk.theta_moments_fused(*args)
        want = tk.theta_moments_fused_plain(*args)
        torch.cuda.synchronize()
        for name, g, a, w in zip(("sumθ", "scatter"), got, again, want):
            err = float((g - w).abs().max())
            excess = float(((g - w).abs() - (THETA_ATOL + THETA_RTOL * w.abs())).max())
            print(f"θ kernel vs plain (R, D, V, K)=({R}, {D}, {V}, {K}), {logits} logits, {name}: "
                  f"max|kernel - plain| = {err:.3e}, repeat launch bit-identical: "
                  f"{bool(torch.equal(g, a))}")
            if not torch.isfinite(g).all():
                fail(f"θ kernel {name} not finite at {(R, D, V, K)}, {logits} logits")
            if excess > 0:
                fail(f"θ kernel {name} disagrees with its plain version beyond rtol "
                     f"{THETA_RTOL}, atol {THETA_ATOL} at {(R, D, V, K)}, {logits} logits")
            if not torch.equal(g, a):
                fail(f"two θ kernel launches on the same inputs differ at {(R, D, V, K)}")
            max_err = max(max_err, err)
        if R == RESTARTS:
            ms = cuda_ms(lambda: tk.theta_moments_fused(*args))
            plain_ms = cuda_ms(lambda: tk.theta_moments_fused_plain(*args))
            timings[(V, K, logits)] = (ms, plain_ms)
            bound_ms, bound_by = theta_bound(R, D, V, K)
            print(f"θ time at ({R}, {D}, {V}, {K}), {logits} logits: kernel {ms:.4f} ms, plain "
                  f"PyTorch {plain_ms:.4f} ms (median of 20 CUDA-event timings); bound "
                  f"{bound_ms:.6f} ms ({bound_by})")
    return max_err, timings[(96, 7, "ctm")]


# (R, D, K, V) of the ll phase: the cells' shapes (BRCA at R = 100 and
# 1000, PCAWG at R = 100), R = 1 (stage 2, inference), ragged D and the
# largest K and V the kernel takes; the first two are timed
LL_SHAPES = (((RESTARTS, 2780, (7, 7, 5), (96, 48, 83)), (1000, 560, (7, 7), (96, 48)),
              (RESTARTS, 560, (7, 7), (96, 48)), (1, 560, (7, 7), (96, 48)),
              (1, 2780, (7, 7, 5), (96, 48, 83)), (7, 101, (20, 3), (96, 5)),
              (3, 29, (128, 128), (128, 128))))
# the kernel against the float64 plain expression, per lane and modality:
# half of `correct`'s step_ll limit (portbench/configs, 2e-6)
LL_RTOL = 1e-6


def ll_problem(gen, R, D, K, V):
    """The ll kernel's inputs on the card: counts 0..9 with about a third
    of the cells zero, softmax props of λ ~ 2·N(0, 1), ϕ rows of
    exp(N(0, 1)) normalized."""
    import torch

    X, props, phi = [], [], []
    for k, v in zip(K, V):
        counts = torch.randint(0, 10, (D, v), generator=gen).float()
        X.append(counts * (torch.rand(D, v, generator=gen) > 0.3))
        props.append(torch.softmax(2.0 * torch.randn(R, D, k, generator=gen), -1))
        w = torch.randn(R, k, v, generator=gen).exp()
        phi.append(w / w.sum(-1, keepdim=True))
    return [[t.to("cuda") for t in ts] for ts in (X, props, phi)]


def ll_bound(R, D, K, V):
    """The ll kernel: reads props (R, D, K_m), ϕ (R, K_m, V_m) and the
    counts (D, V_m) once and writes (R, M); per (r, d, v) cell a K-term
    mixture (2·K operations) and its count's term (2 operations)."""
    n_bytes = 4 * (R * D * sum(K) + R * sum(k * v for k, v in zip(K, V)) + D * sum(V)
                   + R * len(K))
    return bound(n_bytes, R * D * sum(2 * k * v + 2 * v for k, v in zip(K, V)))


def ll_phase(llk):
    import torch

    gen = torch.Generator().manual_seed(2)
    max_rel = 0.0
    timings = {}
    for i, (R, D, K, V) in enumerate(LL_SHAPES):
        X, props, phi = ll_problem(gen, R, D, K, V)
        got = llk.mixture_lls(X, props, phi)
        again = llk.mixture_lls(X, props, phi)
        want = torch.stack(llk.mixture_lls_plain([x.double() for x in X],
                                                 [p.double() for p in props],
                                                 [f.double() for f in phi]), dim=-1)
        torch.cuda.synchronize()
        rel = float(((got.double() - want).abs() / want.abs().clamp_min(1e-30)).max())
        print(f"ll kernel vs float64 (R, D, K, V)=({R}, {D}, {K}, {V}), geometry "
              f"{tuple(llk.launch_geometry(R, D, len(K)))}: max relative gap {rel:.3e}, repeat "
              f"launch bit-identical: {bool(torch.equal(got, again))}")
        if not torch.isfinite(got).all():
            fail(f"ll kernel not finite at {(R, D, K, V)}")
        if rel > LL_RTOL:
            fail(f"ll kernel disagrees with the float64 expression beyond rtol {LL_RTOL} at "
                 f"{(R, D, K, V)}")
        if not torch.equal(got, again):
            fail(f"two ll kernel launches on the same inputs differ at {(R, D, K, V)}")
        max_rel = max(max_rel, rel)
        if i < 2:
            ms = cuda_ms(lambda: llk.mixture_lls(X, props, phi))
            plain_ms = cuda_ms(lambda: llk.mixture_lls_plain(X, props, phi))
            bound_ms, bound_by = ll_bound(R, D, K, V)
            timings[(R, D)] = (ms, plain_ms, bound_ms, bound_by)
            print(f"ll time at ({R}, {D}, {K}, {V}): kernel {ms:.4f} ms, plain PyTorch chain "
                  f"{plain_ms:.4f} ms (median of 20 CUDA-event timings); bound "
                  f"{bound_ms:.6f} ms ({bound_by})")
    return max_rel, timings


def ll_launch_check(mt, llk, X):
    """The main path's own ll launches: phase 2's fit once more, fused η
    route, under the program's tracer and torch.profiler, every count set
    to 0 just before. It runs after the timed paths, as the θ check does.
    A session that records no device event is tried again, up to three.
    Returns the device launches of `mixture_ll_kernel` in the fit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodalmusig_tpu_torch.utils import profiling

    config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=torch.float32)
    kw = dict(restarts=RESTARTS, maxiter=MAXITER, tol=TOL)
    for session in range(3):
        torch.cuda.synchronize()
        llk.LAUNCHES = 0
        profiling.reset()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof, profiling.tracing():
                with_eta_route("fused", lambda: mt.fit_restarts(SEED, X, config, [0.1, 0.1],
                                                                **kw).ll.cpu())
                torch.cuda.synchronize()
            counts = dict(profiling.totals()["counts"])
        finally:
            profiling.reset()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        device = sum("mixture_ll_kernel" in n for n in names)
        finish = sum("mixture_ll_finish" in n for n in names)
        kernel, plain = counts.get("lls.kernel", 0), counts.get("lls.plain", 0)
        replays = counts.get("graph.replays.tail", 0)
        print(f"main path ll launches, session {session + 1}: lls.kernel {kernel}, lls.plain "
              f"{plain}, wrapper calls {llk.LAUNCHES}, tail captures "
              f"{counts.get('graph.captures.tail', 0)} and replays {replays}; on the card "
              f"mixture_ll_kernel {device}, mixture_ll_finish {finish} ({len(names)} device "
              f"kernels in all)")
        if names:
            break
    if plain != 0 or kernel <= 0 or llk.LAUNCHES != kernel:
        fail(f"the main path's lls did not all take the kernel: lls.kernel {kernel}, lls.plain "
             f"{plain}, wrapper calls {llk.LAUNCHES}")
    if not names:
        fail("three profiler sessions of the main path recorded no device kernel")
    if device != kernel + replays or finish != device:
        fail(f"the card ran mixture_ll_kernel {device} and mixture_ll_finish {finish} times, "
             f"not once per eager call and tail replay: {kernel} + {replays}")
    return device


def theta_launch_check(tk):
    """One θ call per BRCA modality under torch.profiler, both in one
    session: exactly one device kernel each (no second pass, no memset of
    the arrival counters), so two in all. It runs after the timed paths:
    the profiler, once started, slows the launches that follow it. A
    session that records no device event at all (seen now and then on the
    chip machine, PERF.md §7) is a miss of the profiler, not a count: it is
    tried again, up to three sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(3)
    calls = []
    for V in (96, 48):
        calls.append([t.to("cuda") for t in (2.0 * torch.randn(RESTARTS, 560, 7, generator=gen),
                                             torch.randn(RESTARTS, V, 7, generator=gen) - 4.0,
                                             torch.randint(0, 30, (560, V), generator=gen).float())])
        tk.theta_moments_fused(*calls[-1])
    torch.cuda.synchronize()
    for session in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for args in calls:
                tk.theta_moments_fused(*args)
                torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"θ kernel device kernels in one call at each of {(RESTARTS, 560, 96, 7)} and "
              f"{(RESTARTS, 560, 48, 7)}, session {session + 1}: {len(names)} in all")
        if names:
            break
    if len(names) != len(calls) or not all("theta_moments_kernel" in n for n in names):
        fail(f"two θ calls ran {len(names)} device kernels, not one each: {names}")


def rank_launch_gate(label, info, iters_per_rank, eta):
    """Each rank's launches: one η (if `eta`) and two θ launches per CAVI
    iteration of its loop, which ends at loop_iterations of its slowest
    lane; no λ launch. Returns the launches summed over the ranks."""
    for r, (launches, max_iters) in enumerate(zip(info["launches"], iters_per_rank)):
        n = loop_iterations(max_iters)
        want = {"estep_eta": n if eta else 0, "lambda_newton": 0, "theta_moments": 2 * n}
        if launches != want:
            fail(f"{label}: rank {r} launched {launches}, not {want} for its {n} CAVI "
                 f"iterations")
    return {k: sum(lc[k] for lc in info["launches"]) for k in info["launches"][0]}


def rank_line(label, wall, info):
    split = info["startup_split"]
    print(f"{label}: backend {info['backend']}, ranks {info['ranks']}, "
          f"{info['ranks_per_device']} a card: wall {wall:.4f} s = ranks' start-up "
          f"{info['startup_s']:.4f} s (the largest over the ranks of: interpreter and imports "
          f"{split['imports']:.4f}, CUDA context, handles and kernel load {split['device']:.4f}, "
          f"process group with the wait for the other ranks {split['group']:.4f}) + fit "
          f"{info['fit_s']:.4f} s + gather; "
          f"launches per rank {info['launches']}")


def slices(n_iters, ranks):
    """The iteration count of each rank's slowest lane: the lanes padded to a
    multiple of the ranks by cycling them, in contiguous slices
    (parallel/_ranks.py `lane_slices`)."""
    import numpy as np

    n_iters = np.asarray(n_iters)
    padded = n_iters[np.arange(-(-len(n_iters) // ranks) * ranks) % len(n_iters)]
    return [int(part.max()) for part in padded.reshape(ranks, -1)]


def multi_device_phase(mt, X, docs, docs_snv, features):
    """Phase 16: the restart fan-out, the family fan-outs, the data-parallel
    fit, the mesh and the vocab-sharded fit, each on ranks that share the
    card (and the fan-out on one NCCL rank), against the same fits in this
    process. Returns the launches summed over every rank."""
    import numpy as np
    import torch
    from multimodalmusig_tpu_torch.models import mmctm as mm
    from multimodalmusig_tpu_torch.parallel import sharding

    two = ["cuda:0", "cuda:0"]
    config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=torch.float32)
    kw = dict(restarts=RESTARTS, maxiter=MAXITER, tol=TOL)
    total = {"estep_eta": 0, "lambda_newton": 0, "theta_moments": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    def timed(fn):
        info = {}
        t0 = time.perf_counter()
        out = fn(info)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, info

    # (a) the MMCTM restart fan-out
    one = mt.fit_restarts(SEED, X, config, [0.1, 0.1], **kw)
    one_best = np.max(np.where(np.isfinite(one.ll.cpu().numpy()), one.ll.cpu().numpy(), -np.inf),
                      axis=0)
    for devices in (two, ["cuda:0"]):
        res, wall, info = timed(lambda i: sharding.shmap_fit_restarts(
            SEED, X, config, [0.1, 0.1], devices=devices, run_info=i, **kw))
        label = f"multi-device (a): shmap_fit_restarts R={RESTARTS} on {devices}"
        rank_line(label, wall, info)
        ll = res.ll.cpu().double().numpy()
        ll_gates(label, ll, JAX_CPU_BEST_LL)
        best = np.max(np.where(np.isfinite(ll), ll, -np.inf), axis=0)
        print(f"{label}: best ll per modality {best.tolist()}, one process {one_best.tolist()}; "
              f"iterations max {int(res.n_iters.max())}")
        if not np.all(np.abs(best - one_best) <= LL_SLACK):
            fail(f"{label}: best ll {best.tolist()} is not within {LL_SLACK} of the one-process "
                 f"fit's {one_best.tolist()}")
        add(rank_launch_gate(label, info, slices(res.n_iters.cpu(), len(devices)), eta=True))

    # (b) the family fan-outs, with phase 8's and phase 14's arguments
    fits = (
        ("IMMCTM", lambda **k: mt.fit_immctm_restarts([7, 7], [0.1, 0.1], features, docs,
                                                      **kw, **k), True),
        ("LDA", lambda **k: mt.fit_lda_restarts(7, 0.1, 0.1, docs_snv, **kw, **k), False),
        ("ILDA", lambda **k: mt.fit_ilda_restarts(7, 0.1, 0.1, features[0], docs_snv, **kw, **k),
         False),
    )
    for family, fit, eta in fits:
        single = fit()
        model, wall, _ = timed(lambda i: fit(devices=two))
        info = model.rank_info
        label = f"multi-device (b): fit_{family.lower()}_restarts R={RESTARTS} on {two}"
        rank_line(label, wall, info)
        ll = model.restart_result.ll.cpu().double().numpy()
        picked, ref = np.atleast_1d(model.ll), np.atleast_1d(single.ll)
        print(f"{label}: selected ll {picked.tolist()}, one process {ref.tolist()}")
        if family == "IMMCTM":
            ll_gates(label, ll, JAX_CPU_BEST_IMMCTM_LL)
        else:
            jax_ll = JAX_CPU_LDA_LL if family == "LDA" else JAX_CPU_ILDA_LL
            if np.isfinite(ll).sum() < 0.99 * len(ll) or not picked[0] >= jax_ll - LL_SLACK:
                fail(f"{label}: {int(np.isfinite(ll).sum())} finite lanes, selected ll "
                     f"{picked[0]} against the JAX value {jax_ll}")
        if not (np.isfinite(picked).all() and np.all(np.abs(picked - ref) <= LL_SLACK)):
            fail(f"{label}: the pick {picked.tolist()} is not within {LL_SLACK} of the "
                 f"one-process pick {ref.tolist()}")
        add(rank_launch_gate(label, info, slices(model.restart_result.n_iters.cpu(), 2), eta))

    def one_fit_gate(label, res, single, rtol):
        """A split fit of one init against the same init fit in this
        process; returns its iterations."""
        n, n1 = int(res.n_iters[0]), int(single.n_iters[0])
        got, want = (r.ll_history[0, :DP_ITERS].cpu().double().numpy() for r in (res, single))
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        print(f"{label}: {n} iterations (one process {n1}), final ll {res.ll[0].tolist()} (one "
              f"process {single.ll[0].tolist()}), elbo {float(res.elbo[0])} ({float(single.elbo[0])}); "
              f"first {DP_ITERS} iterations' lls against the one-process fit: max relative "
              f"difference {rel:.3e}")
        if not (torch.isfinite(res.ll).all() and rel <= rtol
                and np.all(np.abs(res.ll[0].cpu().numpy() - single.ll[0].cpu().numpy())
                           <= LL_SLACK)):
            fail(f"{label}: the fit disagrees with the one-process fit (relative {rel:.3e} > "
                 f"{rtol}, or final lls more than {LL_SLACK} apart)")
        return n

    # (c) the data-parallel fit of one init, and the same init on one rank
    Xt = mm.counts_tensors(X, config, "cuda")
    state = mm.init_with_alpha(torch.Generator().manual_seed(SEED), config, Xt, [0.1, 0.1],
                               device="cuda")
    single = mm.fit(state, Xt, config, maxiter=MAXITER, tol=TOL)
    for devices in (two, ["cuda:0"]):
        res, wall, info = timed(lambda i: sharding.sharded_data_parallel_fit(
            sharding.make_mesh(1, len(devices), devices), state, X, config, maxiter=MAXITER,
            tol=TOL, run_info=i))
        label = (f"multi-device (c): sharded_data_parallel_fit over {len(devices)} data "
                 f"rank(s) on {devices}, {560 // len(devices)} documents a rank")
        rank_line(label, wall, info)
        n = one_fit_gate(label, res, single, DP_LL_RTOL)
        add(rank_launch_gate(label, info, [n] * len(devices), eta=True))

    # (d) the restart x data mesh, two restart rows
    mesh = sharding.make_mesh(2, 1, two)
    res, wall, info = timed(lambda i: sharding.sharded_fit_restarts(
        mesh, SEED, X, config, [0.1, 0.1], run_info=i, **kw))
    label = f"multi-device (d): sharded_fit_restarts on a mesh {mesh.shape} of {two}"
    rank_line(label, wall, info)
    ll = res.ll.cpu().double().numpy()
    ll_gates(label, ll, JAX_CPU_BEST_LL)
    best = np.max(np.where(np.isfinite(ll), ll, -np.inf), axis=0)
    if not np.all(np.abs(best - one_best) <= LL_SLACK):
        fail(f"{label}: best ll {best.tolist()} is not within {LL_SLACK} of the one-process "
             f"fit's {one_best.tolist()}")
    add(rank_launch_gate(label, info, slices(res.n_iters.cpu(), 2), eta=True))

    # (e) the vocab-sharded fit of (c)'s init, half of every vocabulary a rank
    res, wall, info = timed(lambda i: sharding.sharded_vocab_parallel_fit(
        two, state, X, config, maxiter=MAXITER, tol=TOL, run_info=i))
    label = (f"multi-device (e): sharded_vocab_parallel_fit over {two}, "
             f"{tuple(v // 2 for v in config.V)} vocabulary items a rank")
    rank_line(label, wall, info)
    if [tuple(g.shape) for g in res.state.gamma] != [(1, k, v) for k, v in zip(config.K, config.V)]:
        fail(f"{label}: the joined γ has shapes {[tuple(g.shape) for g in res.state.gamma]}")
    n = one_fit_gate(label, res, single, VOCAB_LL_RTOL)
    elbo, one_elbo = float(res.elbo[0]), float(single.elbo[0])
    rel = abs(elbo - one_elbo) / abs(one_elbo)
    print(f"{label}: elbo against the one-process fit's: relative difference {rel:.3e}")
    if not (np.isfinite(elbo) and rel <= VOCAB_ELBO_RTOL):
        fail(f"{label}: elbo {elbo} is not within {VOCAB_ELBO_RTOL} (relative) of the "
             f"one-process fit's {one_elbo}")
    add(rank_launch_gate(label, info, [n] * 2, eta=True))
    return total


def load_brca():
    """The BRCA-EU counts as dense (D, V_m) arrays, and the term names."""
    from multimodalmusig_tpu_torch.utils.data import BRCA_FILES, brca_counts_path
    from multimodalmusig_tpu_torch.utils.fast_tsv import read_counts_tsv

    tables = [read_counts_tsv(brca_counts_path(f)) for f in BRCA_FILES]
    return [t[0].T for t in tables], [t[1] for t in tables]


def brca_features(snv_terms, sv_terms):
    """(V, 2) 1-based feature tables as tools/families_bench.py:66-77 derives
    them: substitution × trinucleotide context for the SNV terms
    ("A[C->A]G"), type × size/region for the SV terms ("del:<10kb:0-1")."""
    import numpy as np

    subs = sorted({t.split("[")[1].split("]")[0] for t in snv_terms})
    ctx = sorted({t.split("[")[0] + "_" + t.split("]")[1] for t in snv_terms})
    snv = np.array([[subs.index(t.split("[")[1].split("]")[0]) + 1,
                     ctx.index(t.split("[")[0] + "_" + t.split("]")[1]) + 1] for t in snv_terms])
    svt = sorted({t.split(":")[0] for t in sv_terms})
    svr = sorted({":".join(t.split(":")[1:]) for t in sv_terms})
    sv = np.array([[svt.index(t.split(":")[0]) + 1, svr.index(":".join(t.split(":")[1:])) + 1]
                   for t in sv_terms])
    return [snv, sv]


def reset_counts(kernels):
    for k in kernels:
        k.LAUNCHES = 0


def ll_gates(label, ll, reference):
    """Prints and checks the quality gates of an (R, M) ll: at least 99% of
    the lanes finite, and the best ll per modality no more than LL_SLACK
    below the JAX package's CPU value."""
    import numpy as np

    finite = np.isfinite(ll).all(axis=1)
    best = np.max(np.where(np.isfinite(ll), ll, -np.inf), axis=0)
    print(f"{label}: finite lanes {int(finite.sum())}/{len(ll)}, best ll per modality "
          f"{best.tolist()} (JAX CPU best-of-16 {list(reference)})")
    if finite.sum() < 0.99 * len(ll):
        fail(f"{label}: only {int(finite.sum())}/{len(ll)} lanes finite")
    for m, (b, ref) in enumerate(zip(best, reference)):
        if not b >= ref - LL_SLACK:
            fail(f"{label}: modality {m}: best ll {b} worse than the JAX value {ref} "
                 f"by more than {LL_SLACK}")


# the f32 CAVI budgets on both sides of a card-vs-CPU check, so only the
# precision differs
CAVI_BUDGETS = dict(lambda_n_iter=3, lambda_cg_iter=4, lambda_polish_iter=1, nu_n_iter=4)


def reference_phase(label, fit):
    """A short fit on the card (f32, kernel path) against the same fit from
    the same seed in float64 on the CPU (plain path): `fit(dtype, device)`
    returns the (R, maxiter, M) ll history."""
    import numpy as np
    import torch

    out = [fit(torch.float32, "cuda").cpu().double().numpy(),
           fit(torch.float64, "cpu").cpu().double().numpy()]
    rel = float(np.max(np.abs(out[0] - out[1]) / np.abs(out[1])))
    print(f"{label} reference check: 2 lanes x 10 iterations, f32 on the card vs f64 on "
          f"the CPU: max relative ll difference {rel:.3e}")
    if not rel < 1e-4:
        fail(f"{label} card fit disagrees with the f64 CPU fit: relative difference {rel:.3e}")


def mmctm_short_fit(mt, X):
    def fit(dtype, device):
        config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtype, **CAVI_BUDGETS)
        return mt.fit_restarts(SEED, X, config, [0.1, 0.1], restarts=2, maxiter=10,
                               tol=0.0, device=device).ll_history
    return fit


def immctm_short_fit(mt, X, features):
    import torch
    from multimodalmusig_tpu_torch.models import ilda, immctm

    J = tuple(tuple(int(v) for v in f.max(axis=0)) for f in features)

    def fit(dtype, device):
        config = immctm.IMMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtype, J=J,
                                     **CAVI_BUDGETS)
        F = tuple(ilda.feature_onehots(f, j, dtype, device) for f, j in zip(features, J))
        state = immctm.init(torch.Generator().manual_seed(SEED), config, [[0.1, 0.1]] * 2,
                            restarts=2, device=device)
        return mt.fit_immctm_restarts_from_states(state, X, F, config, maxiter=10,
                                                  tol=0.0).ll_history
    return fit


def sync_probe(mt, X):
    """Counts device→host syncs inside one step of the fit, of a fit with
    autoα and without the Σ update, and of the inference E-step (frozen
    ln ϕ, no scatter); fails on any."""
    import torch
    from multimodalmusig_tpu_torch.models import mmctm as mm

    config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=torch.float32)
    Xt = mm.counts_tensors(X, config, "cuda")
    N = mm.counts_per_doc(Xt)
    state = mm.init_with_alpha(torch.Generator().manual_seed(SEED), config, Xt,
                               [0.1, 0.1], restarts=RESTARTS, device="cuda")
    logw = mm.unsmoothed_logw(mm.phi_point(state.gamma))
    steps = {
        "the fit's CAVI step": mm.fit_step_fn(Xt, N, config),
        "a CAVI step with autoα and no Σ update": mm.fit_step_fn(Xt, N, config, autoalpha=True,
                                                               update_sigma=False),
        "a CAVI step with lambda_extrap": mm.fit_step_fn(
            Xt, N, dataclasses.replace(config, lambda_extrap=1.0)),
        "the inference E-step": lambda s: mm.e_step_moments(s, Xt, N, config, logw=logw,
                                                            want_scatter=False),
    }
    for label, step in steps.items():
        step(state)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message).splitlines()[0] for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        print(f"device->host syncs inside {label}: {len(syncs)} {syncs[:3]}")
        if syncs:
            fail(f"{label} syncs the host {len(syncs)} times")


def loop_iterations(max_n_iters, maxiter=MAXITER):
    """Iterations the CAVI host loop runs for a batch whose slowest lane ends
    after `max_n_iters`: it reads `done.all()` every DONE_CHECK_EVERY
    iterations, so it stops at the next multiple, or at maxiter."""
    from multimodalmusig_tpu_torch.models import ctm_base

    every = ctm_base.DONE_CHECK_EVERY
    return min(maxiter, -(-int(max_n_iters) // every) * every)


def with_eta_route(route, fn):
    """fn() with `ctm_base._eta_route` forced to `route` (None: as it is)."""
    from multimodalmusig_tpu_torch.models import ctm_base

    saved = ctm_base._eta_route
    if route is not None:
        ctm_base._eta_route = lambda *a: route
    try:
        return fn()
    finally:
        ctm_base._eta_route = saved


def main_path_phase(mt, kernels, X):
    """The R=100 fit, warm on both η routes, then timed in turns fused,
    split, split, fused. Returns the launches of the timed runs."""
    import numpy as np
    import torch

    ek, lk, tk = kernels
    config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=torch.float32)
    kw = dict(restarts=RESTARTS, maxiter=MAXITER, tol=TOL)
    for route in ("fused", "split"):
        t0 = time.perf_counter()
        with_eta_route(route, lambda: mt.fit_restarts(SEED, X, config, [0.1, 0.1], **kw).ll.cpu())
        print(f"main path warm-up run, {route} η route: {time.perf_counter() - t0:.3f} s")

    total = {"estep_eta": 0, "lambda_newton": 0, "theta_moments": 0}
    walls = {"fused": [], "split": []}
    for route in ("fused", "split", "split", "fused"):
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        res = with_eta_route(route, lambda: mt.fit_restarts(SEED, X, config, [0.1, 0.1], **kw))
        ll = res.ll.cpu().double().numpy()
        wall = time.perf_counter() - t0
        launches = {"estep_eta": ek.LAUNCHES, "lambda_newton": lk.LAUNCHES,
                    "theta_moments": tk.LAUNCHES}
        walls[route].append(wall)
        iters = res.n_iters.cpu().numpy()
        n = loop_iterations(iters.max())
        print(f"main path, {route} η route: R={RESTARTS} BRCA-EU MMCTM K=(7, 7) f32 tol={TOL}: "
              f"wall {wall:.4f} s, {n} CAVI iterations, {1000 * wall / n:.4f} ms per CAVI "
              f"iteration; kernel launches {launches}")
        print(f"main path, {route} η route: iterations median {float(np.median(iters)):.1f} "
              f"max {int(iters.max())}, converged {int(res.converged.sum())}/{RESTARTS}, "
              f"pick_optimal_restart={int(mt.pick_optimal_restart(res.ll))}")
        if tuple(res.ll.shape) != (RESTARTS, 2) or tuple(res.ll_history.shape) != (RESTARTS, MAXITER, 2):
            fail(f"unexpected result shapes {tuple(res.ll.shape)}, {tuple(res.ll_history.shape)}")
        want = ({"estep_eta": n, "lambda_newton": 0} if route == "fused"
                else {"estep_eta": 0, "lambda_newton": n})
        want["theta_moments"] = 2 * n
        if launches != want:
            fail(f"the {route} route's launches {launches} are not one η (fused) or λ (split) "
                 f"launch and two θ launches per CAVI iteration: {want}")
        ll_gates(f"main path, {route} η route", ll, JAX_CPU_BEST_LL)
        total = {k: total[k] + launches[k] for k in total}
    print(f"main path walls in turns: fused {walls['fused']} s, split {walls['split']} s")
    return total


def single_model_phase(mt, ek, X):
    import numpy as np
    import torch

    docs = [[mt.make_count_matrix(X[m][d]) for m in range(2)] for d in range(X[0].shape[0])]
    ek.LAUNCHES = 0
    model = mt.MMCTM([7, 7], [0.1, 0.1], docs)
    with eta_layouts(ek) as seen:
        history = model.fit(maxiter=30, verbose=False)  # tol 1e-4
    torch.cuda.synchronize()
    launches = ek.LAUNCHES
    print(f"single model on {model.device}: {len(history)} iterations, final ll {model.ll}, "
          f"elbo {model.elbo}, {launches} η-kernel launches at R = 1; η layouts "
          f"{layouts_line(seen)}")
    if model.device.type != "cuda":
        fail("the MMCTM wrapper did not default to the card")
    if not (np.isfinite(model.ll).all() and np.isfinite(model.elbo)):
        fail("single-model fit is not finite")
    if launches != loop_iterations(len(history), maxiter=30):
        fail("single-model fit did not launch the η kernel once per iteration")
    return launches


def immctm_phase(mt, kernels, X, features):
    import numpy as np
    import torch

    ek, lk, tk = kernels
    docs = [[mt.make_count_matrix(X[m][d]) for m in range(2)] for d in range(X[0].shape[0])]
    kw = dict(restarts=RESTARTS, maxiter=MAXITER, tol=TOL)
    t0 = time.perf_counter()
    mt.fit_immctm_restarts([7, 7], [0.1, 0.1], features, docs, **kw)
    print(f"IMMCTM path warm-up run: {time.perf_counter() - t0:.3f} s")

    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    model = mt.fit_immctm_restarts([7, 7], [0.1, 0.1], features, docs, **kw)
    res = model.restart_result
    ll = res.ll.cpu().double().numpy()
    wall = time.perf_counter() - t0
    launches = {"estep_eta": ek.LAUNCHES, "lambda_newton": lk.LAUNCHES,
                "theta_moments": tk.LAUNCHES}

    iters = res.n_iters.cpu().numpy()
    n = loop_iterations(iters.max())
    print(f"IMMCTM path: R={RESTARTS} BRCA-EU IMMCTM K=(7, 7) J={model.J} f32 tol={TOL}: "
          f"wall {wall:.4f} s (fit, f64 re-score and selection), {n} CAVI iterations, "
          f"{1000 * wall / n:.4f} ms per CAVI iteration; kernel launches {launches}")
    print(f"IMMCTM path: iterations median {float(np.median(iters)):.1f} max {int(iters.max())}, "
          f"converged {int(res.converged.sum())}/{RESTARTS}, selected lane ll {model.ll}")
    if tuple(res.ll.shape) != (RESTARTS, 2) or len(model.ll) != 2:
        fail(f"unexpected IMMCTM result shapes {tuple(res.ll.shape)}, {model.ll}")
    if launches != {"estep_eta": n, "lambda_newton": 0, "theta_moments": 2 * n}:
        fail(f"the IMMCTM path did not launch the η kernel once and the θ kernel twice per "
             f"CAVI iteration: {launches}")
    ll_gates("IMMCTM path", ll, JAX_CPU_BEST_IMMCTM_LL)
    if not np.isfinite(model.ll).all():
        fail(f"the selected IMMCTM lane is not finite: {model.ll}")

    # compact_schedule="auto": the first 50 lanes run uncut as the pilot
    t0 = time.perf_counter()
    mt.fit_immctm_restarts([7, 7], [0.1, 0.1], features, docs, compact_schedule="auto", **kw)
    print(f"IMMCTM auto-compacted warm-up run: {time.perf_counter() - t0:.3f} s")
    total = dict(launches)
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    model = mt.fit_immctm_restarts([7, 7], [0.1, 0.1], features, docs, compact_schedule="auto",
                                   **kw)
    res = model.restart_result
    ll = res.ll.cpu().double().numpy()
    wall = time.perf_counter() - t0
    launches = {"estep_eta": ek.LAUNCHES, "lambda_newton": lk.LAUNCHES,
                "theta_moments": tk.LAUNCHES}
    info = model.compact_info
    print(f"IMMCTM path, compact_schedule=\"auto\": wall {wall:.4f} s (fit, f64 re-score and "
          f"selection); pilot P={info['pilot_restarts']}, boundary "
          f"{info['boundary_s'] * 1e3:.4f} ms, {info['lane_iters_per_s']:.0f} lane-iters/s, "
          f"derived schedule {info['schedule']}, schedule_memo_hit "
          f"{info['schedule_memo_hit']}; iterations max {int(res.n_iters.max())}, selected lane "
          f"ll {model.ll}; kernel launches {launches}")
    if (launches["estep_eta"] <= 0 or launches["lambda_newton"] != 0
            or launches["theta_moments"] != 2 * launches["estep_eta"]):
        fail(f"the auto-compacted IMMCTM path did not launch the η kernel once and the θ "
             f"kernel twice per CAVI iteration: {launches}")
    ll_gates("IMMCTM path, auto-compacted", ll, JAX_CPU_BEST_IMMCTM_LL)
    if not np.isfinite(model.ll).all():
        fail(f"the selected auto-compacted IMMCTM lane is not finite: {model.ll}")
    return {k: total[k] + launches[k] for k in total}, model


@contextlib.contextmanager
def counting_fits():
    """While active, counts what the CAVI loops run, the inference loops
    included: `steps` (CAVI iterations), `lane_iters` (the batch size summed
    over the steps), `loops` (`run_cavi` calls of models/mmctm.py: one per
    uncut or cut MMCTM fit), `calls` (`run_cavi_from`
    calls; boundaries are calls - loops) and `loop_s` (the seconds of those
    calls, each ended by a synchronize: its caller reads the carry on the
    host right after). Wraps the step function `ctm_base.run_cavi_from` is
    given, `ctm_base.run_cavi_from`, `mmctm.run_cavi` and `lda.run_cavi`
    (the LDA and ILDA fits' loop)."""
    import torch
    from multimodalmusig_tpu_torch.models import ctm_base
    from multimodalmusig_tpu_torch.models import lda as lda_mod
    from multimodalmusig_tpu_torch.models import mmctm as mm

    count = dict.fromkeys(("steps", "lane_iters", "loops", "calls", "loop_s"), 0)
    run, run_from = mm.run_cavi, ctm_base.run_cavi_from

    def counting_run(*a, **k):
        count["loops"] += 1
        return run(*a, **k)

    def counting_run_from(carry, maxiter, tol, step_fn, *a, **k):
        def step(state):
            count["steps"] += 1
            count["lane_iters"] += ctm_base.lanes_of(state)[0]
            return step_fn(state)
        count["calls"] += 1
        t0 = time.perf_counter()
        out = run_from(carry, maxiter, tol, step, *a, **k)
        torch.cuda.synchronize()
        count["loop_s"] += time.perf_counter() - t0
        return out

    mm.run_cavi, ctm_base.run_cavi_from = counting_run, counting_run_from
    lda_mod.run_cavi = counting_run
    try:
        yield count
    finally:
        mm.run_cavi, ctm_base.run_cavi_from = run, run_from
        lda_mod.run_cavi = run


def check_fused_launches(label, launches, steps):
    """The fused route's launches: one η and two θ per CAVI iteration, no λ."""
    want = {"estep_eta": steps, "lambda_newton": 0, "theta_moments": 2 * steps}
    if steps <= 0 or launches != want:
        fail(f"{label} did not launch the η kernel once and the θ kernel twice per CAVI "
             f"iteration: {launches}, {steps} iterations")


def compaction_phase(mt, kernels, X):
    """The compaction arms, warm and then timed, in turns. Lane-iterations
    (the batch size summed over the CAVI steps run) and boundaries come from
    `counting_fits`. The "auto" arms print their derivation; the chunked arm
    its progress calls."""
    import numpy as np
    import torch

    ek, lk, tk = kernels
    config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=torch.float32)

    def name(cut):
        return cut if cut == "auto" else (", ".join(f"{k}={v}" for k, v in cut.items())
                                          or "unchunked")

    def run(R, cut):
        progress = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cut == "auto":
            res, info = mt.fit_restarts_auto(SEED, X, config, [0.1, 0.1], restarts=R,
                                             maxiter=MAXITER, tol=TOL)
        else:
            res, info = mt.fit_restarts(SEED, X, config, [0.1, 0.1], restarts=R, maxiter=MAXITER,
                                        tol=TOL, progress=lambda d, t: progress.append((d, t)),
                                        **cut), None
        ll = res.ll.cpu().double().numpy()
        return time.perf_counter() - t0, res, ll, info, progress

    total = {"estep_eta": 0, "lambda_newton": 0, "theta_moments": 0}
    with counting_fits() as count:
        for R, cut in COMPACTION_ARMS:
            wall, _, _, info, _ = run(R, cut)
            print(f"compaction warm-up, R={R} {name(cut)}: {wall:.3f} s"
                  + (f", derived schedule {info['schedule']}" if info else ""))
        for R, cut in COMPACTION_ARMS:
            reset_counts(kernels)
            count.update(dict.fromkeys(count, 0))
            wall, res, ll, info, progress = run(R, cut)
            launches = {"estep_eta": ek.LAUNCHES, "lambda_newton": lk.LAUNCHES,
                        "theta_moments": tk.LAUNCHES}
            iters = res.n_iters.cpu().numpy()
            finite = int(np.isfinite(ll).all(axis=1).sum())
            label = f"compaction R={R} {name(cut)}"
            print(f"{label}: wall {wall:.4f} s, lane-iterations {count['lane_iters']}, "
                  f"boundaries {count['calls'] - count['loops']}, CAVI iterations "
                  f"{count['steps']}, finite lanes {finite}/{R}, lane iterations needed "
                  f"{int(iters.sum())} (median {float(np.median(iters)):.1f}, max "
                  f"{int(iters.max())}), converged {int(res.converged.sum())}/{R}; kernel "
                  f"launches {launches}")
            if info is not None:
                print(f"{label}: pilot P={info['pilot_restarts']} (iterations median "
                      f"{info['pilot_iters_median']:.1f}, max {info['pilot_iters_max']}, "
                      f"{info['pilot_warm_s']:.4f} s), boundary {info['boundary_s'] * 1e3:.4f} "
                      f"ms, {info['lane_iters_per_s']:.0f} lane-iters/s, boundary cost "
                      f"{info['boundary_cost_lane_iters']:.1f} lane-iters, derived schedule "
                      f"{info['schedule']}, schedule_memo_hit {info['schedule_memo_hit']}")
            if "chunk_iters" in cut:
                print(f"{label}: progress calls {progress}")
                done = [d for d, _ in progress]
                if done != sorted(done) or progress[-1] != (R, R) or len(progress) < 2:
                    fail(f"{label}: progress calls {progress} do not rise to ({R}, {R})")
            check_fused_launches(label, launches, count["steps"])
            ll_gates(label, ll, JAX_CPU_BEST_LL)
            total = {k: total[k] + launches[k] for k in total}
    return total


def two_stage_phase(mt, kernels, X):
    import numpy as np
    import torch
    from multimodalmusig_tpu_torch.parallel.restarts import select_modality_winners_f64

    ek, lk, tk = kernels
    docs = [[mt.make_count_matrix(X[m][d]) for m in range(2)] for d in range(X[0].shape[0])]
    t0 = time.perf_counter()
    mt.fit_mmctm_restarts([7, 7], [0.1, 0.1], docs, restarts=RESTARTS, maxiter=MAXITER)
    print(f"two-stage warm-up run: {time.perf_counter() - t0:.3f} s")

    torch.cuda.synchronize()
    reset_counts(kernels)
    with eta_layouts(ek) as seen:
        t0 = time.perf_counter()
        model = mt.fit_mmctm_restarts([7, 7], [0.1, 0.1], docs, restarts=RESTARTS,
                                      maxiter=MAXITER)
        wall = time.perf_counter() - t0
    launches = {"estep_eta": ek.LAUNCHES, "lambda_newton": lk.LAUNCHES,
                "theta_moments": tk.LAUNCHES}
    print(f"two-stage: η layouts {layouts_line(seen)}")
    stage1 = model.restart_result
    n1, n2 = loop_iterations(stage1.n_iters.max()), loop_iterations(len(model.ll_history))
    print(f"two-stage: fit_mmctm_restarts R={RESTARTS} BRCA-EU K=(7, 7) f32 (stage 1 tol 1e-4, "
          f"stage 2 tol 1e-5) on {model.device}: wall {wall:.4f} s (both stages, f64 re-scores, "
          f"selection); CAVI iterations stage 1 {n1}, stage 2 {n2}; kernel launches {launches}")
    best_m, info = select_modality_winners_f64(stage1, model.Xdense, model.config)
    cand = list(info["rescored_lanes"])
    scores = [float(info["ll_f64"][cand.index(best_m[m]), m]) for m in range(2)]
    print(f"two-stage: stage-1 winners per modality {best_m.tolist()} of {len(cand)} re-scored "
          f"lanes, their f64 ll {scores}; stage 1 converged {int(stage1.converged.sum())}/"
          f"{RESTARTS}, iterations max {int(stage1.n_iters.max())}")
    print(f"two-stage: selected model ll {model.ll}, converged {model.converged}, "
          f"{len(model.ll_history)} stage-2 iterations, elbo {model.elbo} "
          f"(JAX CPU two-stage best-of-16 {list(JAX_CPU_TWO_STAGE_LL)})")
    if launches != {"estep_eta": n1 + n2, "lambda_newton": 0, "theta_moments": 2 * (n1 + n2)}:
        fail(f"the two-stage path did not launch the η kernel once and the θ kernel twice per "
             f"CAVI iteration: {launches}")
    if not (np.isfinite(model.ll).all() and model.converged):
        fail(f"the selected two-stage model is not finite and converged: {model.ll}")
    for m, (b, ref) in enumerate(zip(model.ll, JAX_CPU_TWO_STAGE_LL)):
        if not b >= ref - LL_SLACK:
            fail(f"two-stage: modality {m}: selected ll {b} worse than the JAX value {ref} "
                 f"by more than {LL_SLACK}")
    return launches


def launches_now(kernels):
    ek, lk, tk = kernels
    return {"estep_eta": ek.LAUNCHES, "lambda_newton": lk.LAUNCHES, "theta_moments": tk.LAUNCHES}


def solver_options_phase(mt, kernels, X, features):
    """Phase 17: the λ solve's options at full width. `lambda_extrap=1.0`
    against the default on `fit_restarts` R=100, the two-stage
    `fit_mmctm_restarts` and `fit_immctm_restarts`, each warm and then timed
    in turns default, extrap, extrap, default; `lambda_solver="chol"` on
    `fit_restarts` R=100, warm and then timed. Returns the timed runs'
    launches."""
    import numpy as np
    import torch

    docs = [[mt.make_count_matrix(X[m][d]) for m in range(2)] for d in range(X[0].shape[0])]
    base = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=torch.float32)
    kw = dict(restarts=RESTARTS, maxiter=MAXITER, tol=TOL)

    def restarts_fit(**options):
        res = mt.fit_restarts(SEED, X, dataclasses.replace(base, **options), [0.1, 0.1], **kw)
        iters = res.n_iters.cpu().numpy()
        return res.ll.cpu().double().numpy(), iters, loop_iterations(iters.max()), None

    def two_stage_fit(**options):
        model = mt.fit_mmctm_restarts([7, 7], [0.1, 0.1], docs, restarts=RESTARTS,
                                      maxiter=MAXITER, **options)
        iters = model.restart_result.n_iters.cpu().numpy()
        steps = loop_iterations(iters.max()) + loop_iterations(len(model.ll_history))
        return np.asarray([model.ll]), iters, steps, model

    def immctm_fit(**options):
        model = mt.fit_immctm_restarts([7, 7], [0.1, 0.1], features, docs, **kw, **options)
        res = model.restart_result
        iters = res.n_iters.cpu().numpy()
        return res.ll.cpu().double().numpy(), iters, loop_iterations(iters.max()), model

    def gate(label, path, ll, model):
        if path == "restarts":
            ll_gates(label, ll, JAX_CPU_BEST_LL)
        elif path == "IMMCTM":
            ll_gates(label, ll, JAX_CPU_BEST_IMMCTM_LL)
            if not np.isfinite(model.ll).all():
                fail(f"{label}: the selected lane is not finite: {model.ll}")
        else:
            print(f"{label}: selected model ll {model.ll}, converged {model.converged} (JAX CPU "
                  f"two-stage best-of-16 {list(JAX_CPU_TWO_STAGE_LL)})")
            if not (np.isfinite(model.ll).all() and model.converged):
                fail(f"{label}: the selected model is not finite and converged: {model.ll}")
            for m, (b, ref) in enumerate(zip(model.ll, JAX_CPU_TWO_STAGE_LL)):
                if not b >= ref - LL_SLACK:
                    fail(f"{label}: modality {m}: selected ll {b} worse than the JAX value "
                         f"{ref} by more than {LL_SLACK}")

    def timed(label, path, fit, options, want):
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        ll, iters, steps, model = fit(**options)
        wall = time.perf_counter() - t0
        launches = launches_now(kernels)
        print(f"{label}: wall {wall:.4f} s, {steps} CAVI iterations ({1000 * wall / steps:.4f} "
              f"ms each), iterations median {float(np.median(iters)):.1f} max "
              f"{int(iters.max())}, best in-fit ll per modality "
              f"{np.max(np.where(np.isfinite(ll), ll, -np.inf), axis=0).tolist()}; kernel "
              f"launches {launches}")
        if launches != want(steps):
            fail(f"{label}: launches {launches}, not {want(steps)} over {steps} CAVI iterations")
        gate(label, path, ll, model)
        return wall, launches, ll, iters

    def fused(steps):
        return {"estep_eta": steps, "lambda_newton": 0, "theta_moments": 2 * steps}

    total = {"estep_eta": 0, "lambda_newton": 0, "theta_moments": 0}
    for path, fit in (("restarts", restarts_fit), ("two-stage", two_stage_fit),
                      ("IMMCTM", immctm_fit)):
        for options in ({}, {"lambda_extrap": 1.0}):
            t0 = time.perf_counter()
            fit(**options)
            print(f"λ options, {path} warm-up, {options or 'default'}: "
                  f"{time.perf_counter() - t0:.3f} s")
        walls, runs = {"default": [], "extrap": []}, {}
        for arm in ("default", "extrap", "extrap", "default"):
            options = {"lambda_extrap": 1.0} if arm == "extrap" else {}
            wall, launches, ll, iters = timed(f"λ options, {path}, {arm}", path, fit, options,
                                              fused)
            walls[arm].append(wall)
            runs.setdefault(arm, (ll, iters))
            total = {k: total[k] + launches[k] for k in total}
        (ll_d, it_d), (ll_e, it_e) = runs["default"], runs["extrap"]
        print(f"λ options, {path}: walls in turns default {walls['default']} s, extrap "
              f"{walls['extrap']} s; lanes whose iteration count differs "
              f"{int((it_d != it_e).sum())}/{len(it_d)}, lane-iterations default "
              f"{int(it_d.sum())}, extrap {int(it_e.sum())}; largest |Δ final ll| "
              f"{float(np.nanmax(np.abs(ll_d - ll_e))):.3e}")

    t0 = time.perf_counter()
    restarts_fit(lambda_solver="chol")
    print(f"λ options, restarts warm-up, chol: {time.perf_counter() - t0:.3f} s")
    _, launches, _, _ = timed("λ options, restarts, chol", "restarts", restarts_fit,
                        {"lambda_solver": "chol"},
                        lambda steps: {"estep_eta": 0, "lambda_newton": 0,
                                       "theta_moments": 2 * steps})
    return {k: total[k] + launches[k] for k in total}


def tensors(state):
    """Every tensor of a (nested) state, in field order."""
    if isinstance(state, tuple):
        return [t for x in state for t in tensors(x)]
    return [state]


def read_table(path):
    """A tab-separated table as (header, rows)."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    return rows[0], rows[1:]


def check_cli_outputs(label, out, model, terms):
    """The CLI's files: μ, Σ and its correlation parse at (MK,) and (MK, MK),
    the signature probabilities sum to 1 per (modality, topic) and the
    proportions per (sample, modality), both within 1e-6."""
    import numpy as np

    MK = sum(model.K)
    shapes = [np.loadtxt(os.path.join(out, f)).shape for f in ("mean.tsv", "cov.tsv", "cor.tsv")]
    if shapes != [(MK,), (MK, MK), (MK, MK)]:
        fail(f"{label}: mean/cov/cor shapes {shapes}")
    head, rows = read_table(os.path.join(out, "sigs.tsv"))
    sums = {}
    for modality, k, _, _, p in rows:
        sums[(modality, k)] = sums.get((modality, k), 0.0) + float(p)
    sig_err = max(abs(v - 1.0) for v in sums.values())
    if (head != ["modality", "topic", "value", "term", "probability"] or len(sums) != MK
            or len(rows) != sum(k * len(t) for k, t in zip(model.K, terms)) or sig_err > 1e-6):
        fail(f"{label}: the signature table is malformed or does not sum to 1 (max |Σ - 1| "
             f"{sig_err:.3e})")
    head, rows = read_table(os.path.join(out, "props.tsv"))
    props = np.array([[float(x) for x in r[1:]] for r in rows])
    blocks = np.split(props, np.cumsum(model.K)[:-1])
    prop_err = max(float(np.abs(b.sum(axis=0) - 1.0).max()) for b in blocks)
    if props.shape != (MK, model.D) or len(head) != model.D + 1 or prop_err > 1e-6:
        fail(f"{label}: the proportion table {props.shape} is malformed or does not sum to 1 "
             f"(max |Σ - 1| {prop_err:.3e})")
    print(f"{label}: outputs parse; max |Σ - 1| of the signature probabilities {sig_err:.3e}, "
          f"of the proportions {prop_err:.3e}")


def cli_phase(mt, kernels, terms):
    """`cli.main` in this process, on the bundled counts, with --restarts
    1000 --auto-compact --progress and every output: warm, then timed. The
    fitted model is caught on its way out of `fit_mmctm_restarts` to hold
    the checkpoint against it."""
    import tempfile

    import numpy as np
    import torch
    from multimodalmusig_tpu_torch import cli
    from multimodalmusig_tpu_torch.models import ctm_base
    from multimodalmusig_tpu_torch.models import mmctm as mm
    from multimodalmusig_tpu_torch.parallel import restarts as rs
    from multimodalmusig_tpu_torch.utils.data import BRCA_FILES, brca_counts_path

    ek, lk, tk = kernels
    fit, caught = rs.fit_mmctm_restarts, {}

    def catching_fit(*a, **k):
        caught["model"] = fit(*a, **k)
        return caught["model"]

    with tempfile.TemporaryDirectory() as out:
        argv = ([brca_counts_path(f) for f in BRCA_FILES]
                + ["-k", "7", "7", "-m", "SNV", "SV", "--restarts", str(CLI_RESTARTS),
                   "--maxiter", str(MAXITER), "--auto-compact", "--progress"]
                + [a for f in ("model.npz", "mean.tsv", "cov.tsv", "cor.tsv", "sigs.tsv",
                               "props.tsv")
                   for a in (f"--{f.split('.')[0]}", os.path.join(out, f))])
        rs.fit_mmctm_restarts = catching_fit
        try:
            with counting_fits() as count:
                t0 = time.perf_counter()
                if cli.main(argv) != 0:
                    fail("the CLI warm-up run did not exit 0")
                print(f"CLI warm-up run: {time.perf_counter() - t0:.3f} s")
                torch.cuda.synchronize()
                reset_counts(kernels)
                count.update(dict.fromkeys(count, 0))
                t0 = time.perf_counter()
                rc = cli.main(argv)
                wall = time.perf_counter() - t0
        finally:
            rs.fit_mmctm_restarts = fit
        launches = {"estep_eta": ek.LAUNCHES, "lambda_newton": lk.LAUNCHES,
                    "theta_moments": tk.LAUNCHES}
        model = caught["model"]
        info = model.compact_info
        print(f"CLI: run-mmctm-torch --restarts {CLI_RESTARTS} --auto-compact, BRCA-EU K=(7, 7), on "
              f"{model.device}: rc {rc}, wall {wall:.4f} s (TSV reads, both stages, f64 "
              f"re-scores, selection, every output written); CAVI iterations {count['steps']}, "
              f"lane-iterations {count['lane_iters']}, boundaries "
              f"{count['calls'] - count['loops']}; kernel launches {launches}")
        print(f"CLI: pilot P={info['pilot_restarts']}, boundary {info['boundary_s'] * 1e3:.4f} "
              f"ms, {info['lane_iters_per_s']:.0f} lane-iters/s, derived schedule "
              f"{info['schedule']}, schedule_memo_hit {info['schedule_memo_hit']}; selected "
              f"model ll {model.ll}, converged {model.converged} (JAX CPU two-stage "
              f"best-of-16 {list(JAX_CPU_TWO_STAGE_LL)})")
        if rc != 0 or model.device.type != "cuda":
            fail(f"the CLI run exited {rc} on {model.device}")
        check_fused_launches("the CLI run", launches, count["steps"])
        if not (np.isfinite(model.ll).all() and model.converged):
            fail(f"the CLI's selected model is not finite and converged: {model.ll}")
        for m, (b, ref) in enumerate(zip(model.ll, JAX_CPU_TWO_STAGE_LL)):
            if not b >= ref - LL_SLACK:
                fail(f"CLI: modality {m}: selected ll {b} worse than the JAX value {ref} by "
                     f"more than {LL_SLACK}")

        loaded = mt.load_model(os.path.join(out, "model.npz"))
        leaves = list(zip(tensors(loaded.state), tensors(model.state)))
        with ctm_base.full_f32_matmuls():
            again = mm.modality_loglikelihoods(loaded.Xdense, mm.props_from(loaded.state.lam,
                                                                            loaded.config),
                                               mm.phi_point(loaded.state.gamma))[0]
        rel = float(np.max(np.abs(again.cpu().double().numpy() - model.ll) / np.abs(model.ll)))
        print(f"CLI: load_model of the checkpoint on {loaded.device}: ll {loaded.ll}, "
              f"{len(leaves)} state tensors equal: {all(torch.equal(a, b) for a, b in leaves)}, "
              f"ll recomputed from the loaded state on the card within {rel:.3e} relative")
        if (loaded.device.type != "cuda" or loaded.ll != model.ll
                or not all(torch.equal(a, b) for a, b in leaves) or rel > 1e-6):
            fail("the CLI's checkpoint does not give back the fitted model on the card")
        check_cli_outputs("CLI", out, model, terms)
    return launches


def cli_subprocess_phase():
    """`python3 -m multimodalmusig_tpu_torch.cli` in a process of its own,
    without --device: it must run on the card and exit 0."""
    import tempfile

    from multimodalmusig_tpu_torch.utils.data import BRCA_FILES, brca_counts_path

    with tempfile.TemporaryDirectory() as out:
        cmd = ([sys.executable, "-m", "multimodalmusig_tpu_torch.cli"]
               + [brca_counts_path(f) for f in BRCA_FILES]
               + ["-k", "7", "7", "-m", "SNV", "SV", "--restarts", "100", "--verbose",
                  "--props", os.path.join(out, "props.tsv")])
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        last = (proc.stdout.strip().splitlines() or [""])[-1]
        print(f"CLI subprocess (--restarts 100, no --device): rc {proc.returncode}, "
              f"{wall:.2f} s with the interpreter's start; last line: {last}")
        if proc.returncode != 0 or not os.path.exists(os.path.join(out, "props.tsv")):
            fail(f"the CLI subprocess failed: {proc.stderr[-2000:]}")


def _sub_model(model, modalities, X, dtype, device):
    """A fresh wrapper of `model`'s family over X for the given modalities."""
    cls = type(model)
    third = model.features if hasattr(model, "features") else model.V
    return cls([model.K[i] for i in modalities], [model.alpha[i] for i in modalities],
               [third[i] for i in modalities], X, dtype=dtype, device=device)


def cast_state(x, dtype, device):
    """A (nested) state's tensors on `device` in `dtype`."""
    if isinstance(x, tuple):
        parts = [cast_state(y, dtype, device) for y in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x.to(device=device, dtype=dtype)


def inference_reference_check(label, model, test, docs):
    """30 iterations (tol 0) of each inference loop from `model`'s trained
    state: float32 on the card against float64 on the CPU, both at the f32
    CAVI budgets, so only the precision differs. Compares the proportions
    (η for the predictions) and the per-iteration lls."""
    import dataclasses

    import numpy as np
    import torch
    from multimodalmusig_tpu_torch.models import immctm as im
    from multimodalmusig_tpu_torch.models import mmctm as mm

    mod = im if hasattr(model, "features") else mm

    def props(result):
        """Every document's proportions, the modalities side by side."""
        return torch.cat(mm.props_from(result.state.lam, model.config), dim=-1)[0]

    def runs(dtype, device):
        trained = cast_state(model.state, dtype, device)
        full_cfg = dataclasses.replace(model.config, dtype=dtype, **CAVI_BUDGETS)
        out = {}

        def loop(fn, X, modalities=(0, 1)):
            w = _sub_model(model, modalities, X, dtype, device)
            F = (w.F,) if mod is im else ()
            return fn(w, F, dataclasses.replace(w.config, **CAVI_BUDGETS))

        kw = dict(maxiter=30, tol=0.0)
        r = loop(lambda w, F, c: mod.fit_heldout_states(
            trained, w.state, w.Xdense, *F, c, **kw), test)
        out["fit_heldout"] = (props(r), r.ll_history[0])
        for fg in (False, True):
            r = loop(lambda w, F, c: mod.transform_states(
                trained, w.state, w.Xdense, *F, c, fit_gaussian=fg, **kw), docs)
            out[f"transform, fit_gaussian={fg}"] = (props(r), r.ll_history[0])
        for m in (1, 2):
            Xobs = [[doc[2 - m]] for doc in test]
            eta, _, _ = loop(lambda w, F, c: mod.predict_modality_eta_states(
                trained, w.state, w.Xdense, m - 1, *F, full_cfg, c, **kw), Xobs, (2 - m,))
            out[f"predict_modality_eta, m={m}"] = (eta[0], None)
        return {k: tuple(None if t is None else t.cpu().double().numpy() for t in v)
                for k, v in out.items()}

    got, want = runs(torch.float32, "cuda"), runs(torch.float64, "cpu")
    for name in want:
        (a, la), (b, lb) = got[name], want[name]
        err = float(np.max(np.abs(a - b)))
        what = "η" if la is None else "proportions"
        rel = None if la is None else float(np.max(np.abs(la - lb) / np.abs(lb)))
        print(f"{label} reference check, {name}: 30 iterations, f32 on the card vs f64 on the "
              f"CPU: max |Δ {what}| {err:.3e}"
              + ("" if rel is None else f", max relative ll difference {rel:.3e}"))
        atol = INFER_ETA_ATOL if la is None else INFER_PROPS_ATOL
        if not (np.isfinite(a).all() and err <= atol and (rel is None or rel <= INFER_LL_RTOL)):
            fail(f"{label} {name}: the card run disagrees with the f64 CPU run ({what} "
                 f"{err:.3e} > {atol} or ll {rel} > {INFER_LL_RTOL})")


def output_finite(out):
    """Whether an inference call's output is finite: η, or the new model's
    lls, ELBO and λ."""
    import numpy as np
    import torch

    if isinstance(out, list):
        return bool(np.isfinite(np.stack(out)).all())
    return bool(np.isfinite(out.ll).all() and np.isfinite(out.elbo)
                and torch.isfinite(out.state.lam).all())


def inference_phase(mt, kernels, label, model, test, docs):
    """fit_heldout on `test`, transform of `docs` (fit_gaussian False and
    True) and predict_modality_eta of each modality from the other on
    `test`, warm and then timed, each with its launch gate; then the
    card-vs-CPU check. Returns (the timed calls' launches, the held-out
    model)."""
    import torch

    ek, lk, tk = kernels
    obs = {1: [[doc[1]] for doc in test], 2: [[doc[0]] for doc in test]}
    calls = (
        ("fit_heldout(test, model)", lambda: mt.fit_heldout(test, model), 2),
        ("transform(model, docs)", lambda: mt.transform(model, docs), 2),
        ("transform(model, docs, fit_gaussian=True)",
         lambda: mt.transform(model, docs, fit_gaussian=True), 2),
        ("predict_modality_eta(Xobs, 1, model)", lambda: mt.predict_modality_eta(obs[1], 1, model), 1),
        ("predict_modality_eta(Xobs, 2, model)", lambda: mt.predict_modality_eta(obs[2], 2, model), 1),
    )
    for _, call, _ in calls:
        call()
    total = {"estep_eta": 0, "lambda_newton": 0, "theta_moments": 0}
    heldout = None
    for name, call, n_obs in calls:
        torch.cuda.synchronize()
        reset_counts(kernels)
        with counting_fits() as count, eta_layouts(ek) as seen:
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"estep_eta": ek.LAUNCHES, "lambda_newton": lk.LAUNCHES,
                    "theta_moments": tk.LAUNCHES}
        n = count["steps"]
        summary = "η finite" if isinstance(out, list) else f"ll {out.ll}, converged {out.converged}"
        loop_ms = 1000 * count["loop_s"]
        print(f"{label}: {name} on {model.device}: wall {wall:.4f} s (the new model's set-up, "
              f"the loop, the final ELBO), {n} CAVI iterations, {1000 * wall / n:.4f} ms per CAVI "
              f"iteration; the loop alone {loop_ms:.4f} ms, {loop_ms / n:.4f} ms per CAVI "
              f"iteration (R = 1); {summary}; kernel launches {launches}; η layouts "
              f"{layouts_line(seen)}")
        if not output_finite(out):
            fail(f"{label}: {name} gave a non-finite output")
        if n <= 0 or launches != {"estep_eta": n, "lambda_newton": 0, "theta_moments": n_obs * n}:
            fail(f"{label}: {name} did not launch the η kernel once and the θ kernel once per "
                 f"observed modality per CAVI iteration: {launches}, {n} iterations")
        if name.startswith("fit_heldout"):
            heldout = out
        total = {k: total[k] + launches[k] for k in total}
    inference_reference_check(label, model, test, docs)
    return total, heldout


def mmctm_inference_phase(mt, kernels, docs):
    """The MMCTM model of the 448 training documents, the five inference
    calls, and the held-out ll gate against the JAX package's."""
    train, test = mt.train_test_split_docs(docs, 0.2, seed=0)
    t0 = time.perf_counter()
    model = mt.fit_mmctm_restarts([7, 7], [0.1, 0.1], train, V=(96, 48), restarts=RESTARTS)
    print(f"MMCTM inference: {len(train)} training and {len(test)} held-out documents; "
          f"fit_mmctm_restarts R={RESTARTS} on the training split: {time.perf_counter() - t0:.3f} "
          f"s, ll {model.ll}")
    launches, heldout = inference_phase(mt, kernels, "MMCTM inference", model, test, docs)
    print(f"MMCTM inference: held-out ll {heldout.ll} (JAX CPU {list(JAX_CPU_HELDOUT_LL)}, "
          f"slack {HELDOUT_SLACK})")
    for m, (b, ref) in enumerate(zip(heldout.ll, JAX_CPU_HELDOUT_LL)):
        if not b >= ref - HELDOUT_SLACK:
            fail(f"MMCTM inference: modality {m}: held-out ll {b} worse than the JAX value {ref} "
                 f"by more than {HELDOUT_SLACK}")
    return launches


def k_selection_phase(mt, kernels, docs):
    """select_k_mmctm over K_CANDIDATES at R=100, warm and then timed."""
    import numpy as np
    import torch

    ek, lk, tk = kernels
    kw = dict(restarts=RESTARTS, maxiter=MAXITER)
    t0 = time.perf_counter()
    mt.select_k_mmctm(K_CANDIDATES, docs, [0.1, 0.1], **kw)
    print(f"K selection warm-up run: {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    reset_counts(kernels)
    with counting_fits() as count, eta_layouts(ek) as seen:
        t0 = time.perf_counter()
        best, curve = mt.select_k_mmctm(K_CANDIDATES, docs, [0.1, 0.1], **kw)
        wall = time.perf_counter() - t0
    launches = {"estep_eta": ek.LAUNCHES, "lambda_newton": lk.LAUNCHES,
                "theta_moments": tk.LAUNCHES}
    n = count["steps"]
    print(f"K selection: select_k_mmctm({list(K_CANDIDATES)}, docs, restarts={RESTARTS}, "
          f"maxiter={MAXITER}) on the card: wall {wall:.4f} s (split, three two-stage fits, "
          f"three held-out fits), {n} CAVI iterations; chosen K {best}; curve {curve}; kernel "
          f"launches {launches}")
    print(f"K selection: η layouts {layouts_line(seen)}")
    if not np.isfinite([ll for _, ll in curve]).all():
        fail(f"K selection: a held-out ll is not finite: {curve}")
    check_fused_launches("K selection", launches, n)
    return launches


def pcawg_corpus(D=2800, V=(96, 48, 24), K=(7, 7, 5), mean_counts=(3000, 250, 120)):
    """The synthetic PCAWG-scale corpus of tools/pcawg_bench.py:27
    (synthesize_corpus) from np.random.default_rng(0): per modality K
    topics ~ Dirichlet(0.3) over V terms, D documents' proportions ~
    Dirichlet(0.5), Poisson(mean) counts per document drawn multinomially."""
    import numpy as np

    rng = np.random.default_rng(0)
    X = []
    for v, k, mean_n in zip(V, K, mean_counts):
        topics = rng.dirichlet(np.full(v, 0.3), size=k)  # (K, V)
        props = rng.dirichlet(np.full(k, 0.5), size=D)  # (D, K)
        P = props @ topics
        N = rng.poisson(mean_n, size=D)
        counts = np.stack([rng.multinomial(n, p) for n, p in zip(N, P)])
        X.append(counts.astype(np.float32))
    return X


def pcawg_phase(mt, kernels):
    """An R=100 MMCTM fit at PCAWG scale (D=2800, V=(96, 48, 24), K=(7, 7,
    5), MK 19; tools/pcawg_bench.py's corpus, α=0.1, f32, tol 1e-5), warm
    and then timed; prints its wall, steps, B3 launches and layouts. Gates:
    at least 99% finite lanes; one η and three θ launches (one per
    modality) per CAVI iteration."""
    import numpy as np
    import torch

    ek, lk, tk = kernels
    K, V = (7, 7, 5), (96, 48, 24)
    X = pcawg_corpus(V=V, K=K)
    config = mt.MMCTMConfig(K=K, V=V, D=X[0].shape[0], dtype=torch.float32)
    kw = dict(restarts=RESTARTS, maxiter=MAXITER, tol=TOL)
    t0 = time.perf_counter()
    mt.fit_restarts(SEED, X, config, [0.1, 0.1, 0.1], **kw).ll.cpu()
    print(f"PCAWG warm-up run: {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    reset_counts(kernels)
    with eta_layouts(ek) as seen:
        t0 = time.perf_counter()
        res = mt.fit_restarts(SEED, X, config, [0.1, 0.1, 0.1], **kw)
        ll = res.ll.cpu().double().numpy()
        wall = time.perf_counter() - t0
    launches = launches_now(kernels)
    iters = res.n_iters.cpu().numpy()
    n = loop_iterations(iters.max())
    finite = int(np.isfinite(ll).all(axis=1).sum())
    print(f"PCAWG scale: fit_restarts R={RESTARTS} D={config.D} V={V} K={K} f32 tol={TOL} on "
          f"{res.ll.device}: wall {wall:.4f} s, {n} CAVI iterations, {1000 * wall / n:.4f} ms "
          f"per CAVI iteration; iterations median {float(np.median(iters)):.1f} max "
          f"{int(iters.max())}, converged {int(res.converged.sum())}/{RESTARTS}; finite lanes "
          f"{finite}/{RESTARTS}; best ll per modality {np.nanmax(ll, axis=0).tolist()}; kernel "
          f"launches {launches} (B3 {launches['estep_eta']}); η layouts {layouts_line(seen)}")
    if finite < 0.99 * RESTARTS:
        fail(f"PCAWG scale: only {finite} of {RESTARTS} lanes finite")
    want = {"estep_eta": n, "lambda_newton": 0, "theta_moments": 3 * n}
    if launches != want:
        fail(f"PCAWG scale: launches {launches} are not one η and one θ launch per modality per "
             f"CAVI iteration: {want}")
    return launches


def block_layout(pick):
    """`launch_geometry` with every MK above 32 sent to the block layout (a
    BlockGroup of 64 or 128 lanes per problem), as it was before split4 and
    split8."""
    from multimodalmusig_tpu_torch.ops import estep_kernel as ek

    def geometry(R, D, MK):
        if MK <= ek.GROUP_MAX_MK:
            return pick(R, D, MK)
        P = ek._group_P(MK)
        return ek.EtaGeometry("block", P, 256 // P)

    return geometry


def k20_two_stage_phase(mt, kernels, docs):
    """Phase 19: `fit_mmctm_restarts([20, 20], [0.1, 0.1], docs,
    restarts=100)` (MK 40: stage 1 a restart batch, stage 2 R = 1), warm on
    both arms, then timed in turns: `launch_geometry` as it is, patched to
    the block layout, the block layout, as it is. Prints each arm's wall,
    CAVI steps, ms per step and the η layouts of each stage. Gates: at least
    99 of 100 stage-1 lanes finite, the selected lane converged, one η (and
    two θ) launches per CAVI iteration, the selected ll per modality no more
    than LL_SLACK below JAX_CPU_TWO_STAGE_LL_K20."""
    import numpy as np
    import torch

    ek, lk, tk = kernels
    pick = ek.launch_geometry
    arms = {"rule": pick, "block": block_layout(pick)}

    def fit(arm):
        """The fit with `arm`'s layouts, and its η launches by layout."""
        ek.launch_geometry = arms[arm]
        try:
            with eta_layouts(ek) as seen:
                model = mt.fit_mmctm_restarts(list(K20), [0.1, 0.1], docs, restarts=RESTARTS,
                                              maxiter=MAXITER)
            return model, seen
        finally:
            ek.launch_geometry = pick

    for arm in arms:
        t0 = time.perf_counter()
        fit(arm)
        print(f"K=(20, 20) two-stage warm-up run, {arm} layouts: {time.perf_counter() - t0:.3f} s")
    total = {"estep_eta": 0, "lambda_newton": 0, "theta_moments": 0}
    walls = {arm: [] for arm in arms}
    for arm in ("rule", "block", "block", "rule"):
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        model, seen = fit(arm)
        wall = time.perf_counter() - t0
        launches = launches_now(kernels)
        walls[arm].append(wall)
        stage1 = model.restart_result
        n1, n2 = loop_iterations(stage1.n_iters.max()), loop_iterations(len(model.ll_history))
        finite = int(np.isfinite(stage1.ll.cpu().double().numpy()).all(axis=1).sum())
        stage1_seen = collections.Counter({k: v for k, v in seen.items() if k[0][0] > 1})
        stage2_seen = collections.Counter({k: v for k, v in seen.items() if k[0][0] == 1})
        print(f"K=(20, 20) two-stage, {arm} layouts: fit_mmctm_restarts R={RESTARTS} BRCA-EU f32 "
              f"(stage 1 tol 1e-4, stage 2 tol 1e-5): wall {wall:.4f} s, CAVI iterations stage 1 "
              f"{n1}, stage 2 {n2}, {1000 * wall / (n1 + n2):.4f} ms per CAVI iteration; stage 1 "
              f"finite lanes {finite}/{RESTARTS}, converged {int(stage1.converged.sum())}/"
              f"{RESTARTS}; selected ll {model.ll}, converged {model.converged} (JAX CPU "
              f"two-stage best-of-16 {list(JAX_CPU_TWO_STAGE_LL_K20)}); kernel launches {launches}")
        print(f"K=(20, 20) two-stage, {arm} layouts: stage 1 η layouts {layouts_line(stage1_seen)}; "
              f"stage 2 η layouts {layouts_line(stage2_seen)}")
        if finite < RESTARTS - 1:
            fail(f"K=(20, 20) two-stage ({arm}): only {finite} of {RESTARTS} stage-1 lanes finite")
        if not (np.isfinite(model.ll).all() and model.converged):
            fail(f"K=(20, 20) two-stage ({arm}): the selected model is not finite and converged: "
                 f"{model.ll}")
        if launches != {"estep_eta": n1 + n2, "lambda_newton": 0, "theta_moments": 2 * (n1 + n2)}:
            fail(f"K=(20, 20) two-stage ({arm}) did not launch the η kernel once and the θ kernel "
                 f"twice per CAVI iteration: {launches}, {n1 + n2} iterations")
        for m, (b, ref) in enumerate(zip(model.ll, JAX_CPU_TWO_STAGE_LL_K20)):
            if not b >= ref - LL_SLACK:
                fail(f"K=(20, 20) two-stage ({arm}): modality {m}: selected ll {b} worse than the "
                     f"JAX value {ref} by more than {LL_SLACK}")
        total = {k: total[k] + launches[k] for k in total}
    print(f"K=(20, 20) two-stage walls in turns: rule {walls['rule']} s, block {walls['block']} s")
    return total


def parent_theta_kernel(tree):
    """The θ kernel module of an earlier commit unpacked at `tree` (e.g. a
    `git archive` of the parent), imported as a package of its own, so its
    kernel builds from its sources into its own _build/ and counts its own
    launches."""
    import importlib
    import importlib.util

    root = os.path.join(os.path.abspath(tree), "multimodalmusig_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "theta_parent", os.path.join(root, "__init__.py"), submodule_search_locations=[root])
    package = importlib.util.module_from_spec(spec)
    sys.modules["theta_parent"] = package
    spec.loader.exec_module(package)
    return importlib.import_module("theta_parent.ops.theta_kernel")


def with_theta_kernel(module, fn):
    """`fn()` with every θ call of the fits launched through `module`'s
    wrapper (ctm_base.theta_moments_one calls theta_kernel.theta_moments_fused)."""
    from multimodalmusig_tpu_torch.ops import theta_kernel as tk

    wrapper = tk.theta_moments_fused
    tk.theta_moments_fused = module.theta_moments_fused
    try:
        return fn()
    finally:
        tk.theta_moments_fused = wrapper


def k20_theta_phase(mt, kernels, X, docs_snv, parent_tk):
    """Phase 20: B4 above K = 8 on two fits, each warm and then timed in
    turns with the parent's B4 (`parent_tk`, from --theta-parent) where
    given (parent, this, this, parent), else this B4 twice: (a) the R=1000
    MMCTM K=(20, 20) fit of the BRCA-EU counts, uncut; (b) the R=100 LDA
    K=20 fit of the SNV counts (two B4 launches a step, no B3). Prints each
    run's wall, steps, ms per step and peak memory. Gates: at least 99% of
    the lanes finite; the pick (the picked lane's ll per modality, LDA's
    selected ll) within LL_SLACK of the parent's run in this call, and of
    PARENT_K20_PICKS (recorded with the parent's B4); the launches per step:
    (a) one η, two θ, no λ; (b) two θ."""
    import numpy as np
    import torch

    ek, lk, tk = kernels
    config = mt.MMCTMConfig(K=K20, V=(96, 48), D=560, dtype=torch.float32)
    arms = {"this": tk, "parent": parent_tk} if parent_tk is not None else {"this": tk}
    order = ("parent", "this", "this", "parent") if parent_tk is not None else ("this", "this")

    def mmctm_run():
        res = mt.fit_restarts(SEED, X, config, [0.1, 0.1], restarts=1000, maxiter=MAXITER,
                              tol=TOL)
        ll = res.ll.cpu().double().numpy()
        lane = int(mt.pick_optimal_restart(res.ll))
        return dict(steps=loop_iterations(res.n_iters.max()), finite=int(
            np.isfinite(ll).all(axis=1).sum()), lanes=len(ll), pick=ll[lane].tolist())

    def lda_run():
        with counting_fits() as count:
            model = mt.fit_lda_restarts(20, 0.1, 0.1, docs_snv, restarts=RESTARTS,
                                        maxiter=MAXITER, tol=TOL)
        ll = model.restart_result.ll.cpu().double().numpy()
        return dict(steps=count["steps"], finite=int(np.isfinite(ll).sum()), lanes=len(ll),
                    pick=[float(model.ll)])

    fits = {"MMCTM K=(20, 20) R=1000": (mmctm_run, True), "LDA K=20 R=100": (lda_run, False)}
    total = {"estep_eta": 0, "lambda_newton": 0, "theta_moments": 0}
    for label, (run, eta) in fits.items():
        for arm, module in arms.items():
            t0 = time.perf_counter()
            with_theta_kernel(module, run)
            print(f"phase 20 {label} warm-up run, {arm} B4: {time.perf_counter() - t0:.3f} s")
        picks, walls = {}, {arm: [] for arm in arms}
        for arm in order:
            module = arms[arm]
            torch.cuda.synchronize()
            reset_counts(kernels)
            module.LAUNCHES = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = with_theta_kernel(module, run)
            wall = time.perf_counter() - t0
            n = out["steps"]
            launches = {"estep_eta": ek.LAUNCHES, "lambda_newton": lk.LAUNCHES,
                        "theta_moments": module.LAUNCHES}
            walls[arm].append(wall)
            picks.setdefault(arm, out["pick"])
            print(f"phase 20 {label}, {arm} B4: wall {wall:.4f} s, {n} CAVI iterations, "
                  f"{1000 * wall / n:.4f} ms per CAVI iteration, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; finite lanes "
                  f"{out['finite']}/{out['lanes']}; pick {out['pick']}; kernel launches "
                  f"{launches}")
            if out["finite"] < 0.99 * out["lanes"]:
                fail(f"phase 20 {label} ({arm} B4): only {out['finite']}/{out['lanes']} lanes "
                     f"finite")
            want = {"estep_eta": n if eta else 0, "lambda_newton": 0, "theta_moments": 2 * n}
            if n <= 0 or launches != want:
                fail(f"phase 20 {label} ({arm} B4): launches {launches}, not {want} for {n} "
                     f"CAVI iterations")
            for ref_label, ref in (("the parent's B4 in this run", picks.get("parent")),
                                   ("PARENT_K20_PICKS", PARENT_K20_PICKS[label])):
                if ref is not None and not np.allclose(out["pick"], ref, rtol=0, atol=LL_SLACK):
                    fail(f"phase 20 {label} ({arm} B4): pick {out['pick']} not within "
                         f"{LL_SLACK} of {ref_label}, {ref}")
            if arm == "this":
                total = {k: total[k] + launches[k] for k in total}
        print(f"phase 20 {label} walls in turns: " + ", ".join(
            f"{arm} B4 {walls[arm]} s" for arm in arms))
    return total


def lda_short_fit(mt, X_snv, features=None):
    """A short LDA fit (ILDA with `features`) of the SNV counts, 2 lanes x
    10 iterations from SEED, for `reference_phase`."""
    import torch
    from multimodalmusig_tpu_torch.models import ilda, lda

    def fit(dtype, device):
        gen = torch.Generator().manual_seed(SEED)
        if features is None:
            config = lda.LDAConfig(K=7, V=96, D=560, alpha=0.1, eta=0.1, dtype=dtype)
            state = lda.init(gen, config, restarts=2, device=device)
            return mt.fit_lda_restarts_from_states(state, X_snv, config, maxiter=10,
                                                   tol=0.0).ll_history
        J = tuple(int(v) for v in features.max(axis=0))
        config = ilda.ILDAConfig(K=7, V=96, D=560, J=J, alpha=0.1, eta=(0.1, 0.1), dtype=dtype)
        state = ilda.init(gen, config, restarts=2, device=device)
        F = ilda.feature_onehots(features, J, dtype, device)
        return mt.fit_ilda_restarts_from_states(state, X_snv, F, config, maxiter=10,
                                                tol=0.0).ll_history
    return fit


def lda_fit(mt, family, docs, features, **kw):
    """fit_lda_restarts or fit_ilda_restarts of `docs` at K = 7, α = η = 0.1."""
    if family == "LDA":
        return mt.fit_lda_restarts(7, 0.1, 0.1, docs, **kw)
    return mt.fit_ilda_restarts(7, 0.1, 0.1, features, docs, **kw)


def launches_of(kernels):
    ek, lk, tk = kernels
    return {"estep_eta": ek.LAUNCHES, "lambda_newton": lk.LAUNCHES, "theta_moments": tk.LAUNCHES}


def lda_phase(mt, kernels, docs, features):
    """The LDA_ARMS, warm and then timed, in turns, with their gates.
    Returns the timed runs' launches."""
    import numpy as np
    import torch

    def run(family, R, cut):
        kw = dict(restarts=R, maxiter=MAXITER, tol=TOL)
        if cut is not None:
            kw["compact_schedule"] = cut
        return lda_fit(mt, family, docs, features, **kw)

    total = {"estep_eta": 0, "lambda_newton": 0, "theta_moments": 0}
    with counting_fits() as count:
        for family, R, cut in LDA_ARMS:
            t0 = time.perf_counter()
            run(family, R, cut)
            print(f"{family} R={R} {cut or 'uncut'} warm-up run: {time.perf_counter() - t0:.3f} s")
        for family, R, cut in LDA_ARMS:
            torch.cuda.synchronize()
            reset_counts(kernels)
            count.update(dict.fromkeys(count, 0))
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = run(family, R, cut)
            wall = time.perf_counter() - t0
            launches = launches_of(kernels)
            peak = torch.cuda.max_memory_allocated() / 2**20
            res = model.restart_result
            ll = res.ll.cpu().double().numpy()
            iters = res.n_iters.cpu().numpy()
            label = f"{family} R={R} {cut or 'uncut'}"
            ref = JAX_CPU_LDA_LL if family == "LDA" else JAX_CPU_ILDA_LL
            print(f"{label}: BRCA-EU SNV K=7 f32 tol={TOL} on {model.device}: wall {wall:.4f} s "
                  f"(fit, f64 re-score and selection), CAVI iterations {count['steps']}, "
                  f"lane-iterations {count['lane_iters']}, boundaries "
                  f"{count['calls'] - count['loops']}, peak device memory {peak:.1f} MiB; "
                  f"iterations median {float(np.median(iters)):.1f} max {int(iters.max())}, "
                  f"finite lanes {int(np.isfinite(ll).sum())}/{R}, converged "
                  f"{int(res.converged.sum())}/{R}; selected ll {model.ll} (JAX CPU "
                  f"best-of-16 {ref}); kernel launches {launches}")
            if cut == "auto":
                info = model.compact_info
                print(f"{label}: pilot P={info['pilot_restarts']}, boundary "
                      f"{info['boundary_s'] * 1e3:.4f} ms, {info['lane_iters_per_s']:.0f} "
                      f"lane-iters/s, derived schedule {info['schedule']}, schedule_memo_hit "
                      f"{info['schedule_memo_hit']}")
            want = {"estep_eta": 0, "lambda_newton": 0, "theta_moments": 2 * count["steps"]}
            if count["steps"] <= 0 or launches != want:
                fail(f"{label} did not launch the θ kernel twice per CAVI iteration: {launches}, "
                     f"{count['steps']} iterations")
            if np.isfinite(ll).sum() < 0.99 * R:
                fail(f"{label}: only {int(np.isfinite(ll).sum())}/{R} lanes finite")
            if not (np.isfinite(model.ll) and model.ll >= ref - LL_SLACK):
                fail(f"{label}: selected ll {model.ll} worse than the JAX value {ref} by more "
                     f"than {LL_SLACK}")
            total = {k: total[k] + launches[k] for k in total}
    return total


def lda_inference_reference_check(label, model, test, docs):
    """30 iterations (tol 0) of `fit_heldout` and `transform` from `model`'s
    trained state: float32 on the card against float64 on the CPU. Compares
    θ and the per-iteration lls."""
    import numpy as np
    import torch
    from multimodalmusig_tpu_torch.models import ilda, lda

    mod, extra = (ilda, (model.features,)) if isinstance(model, ilda.ILDA) else (lda, (model.V,))

    def runs(dtype, device):
        trained = cast_state(model.state, dtype, device)
        out = {}
        for name, X in (("fit_heldout", test), ("transform", docs)):
            w = type(model)(model.K, model.alpha, model.eta, *extra, X, dtype=dtype,
                            device=device)
            F = (w.F,) if mod is ilda else ()
            if name == "fit_heldout":
                r = mod.fit_heldout_states(trained, w.state, w.Xdense, *F, w.config, maxiter=30,
                                           tol=0.0)
                theta = lda.theta_point(r.state)
            else:
                theta, r = mod.transform_states(trained, w.state, w.Xdense, *F, w.config,
                                                maxiter=30, tol=0.0)
            out[name] = (theta[0].cpu().double().numpy(), r.ll_history[0].cpu().double().numpy())
        return out

    got, want = runs(torch.float32, "cuda"), runs(torch.float64, "cpu")
    for name in want:
        (a, la), (b, lb) = got[name], want[name]
        err = float(np.max(np.abs(a - b)))
        rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
        print(f"{label} reference check, {name}: 30 iterations, f32 on the card vs f64 on the "
              f"CPU: max |Δ θ| {err:.3e}, max relative ll difference {rel:.3e}")
        if not (np.isfinite(a).all() and err <= INFER_PROPS_ATOL and rel <= INFER_LL_RTOL):
            fail(f"{label} {name}: the card run disagrees with the f64 CPU run (θ {err:.3e} > "
                 f"{INFER_PROPS_ATOL} or ll {rel:.3e} > {INFER_LL_RTOL})")


def lda_inference_phase(mt, kernels, docs, features):
    """For each family, an R=100 model of the 448 training documents, then
    `fit_heldout` of the 112 and `transform` of the 560, warm and then
    timed, one θ launch per CAVI iteration; the card-vs-CPU check; and a
    checkpoint round trip on the card. Returns the timed calls' launches."""
    import tempfile

    import numpy as np
    import torch

    train, test = mt.train_test_split_docs(docs, 0.2, seed=0)
    total = {"estep_eta": 0, "lambda_newton": 0, "theta_moments": 0}
    for family in ("LDA", "ILDA"):
        t0 = time.perf_counter()
        kw = dict(V=96) if family == "LDA" else {}
        model = lda_fit(mt, family, train, features, restarts=RESTARTS, **kw)
        print(f"{family} inference: {len(train)} training and {len(test)} held-out documents; "
              f"fit_{family.lower()}_restarts R={RESTARTS} on the training split: "
              f"{time.perf_counter() - t0:.3f} s, ll {model.ll}")
        calls = (("fit_heldout(test, model)", lambda: mt.fit_heldout(test, model)),
                 ("transform(model, docs)", lambda: mt.transform(model, docs)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # a fold-in that stops at maxiter warns
            for _, call in calls:
                call()
            for name, call in calls:
                torch.cuda.synchronize()
                reset_counts(kernels)
                with counting_fits() as count:
                    t0 = time.perf_counter()
                    out = call()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                launches = launches_of(kernels)
                n = count["steps"]
                finite = (np.isfinite(out).all() if isinstance(out, np.ndarray)
                          else np.isfinite(out.ll) and np.isfinite(out.elbo))
                summary = (f"θ {out.shape}" if isinstance(out, np.ndarray)
                           else f"ll {out.ll}, converged {out.converged}")
                print(f"{family} inference: {name} on {model.device}: wall {wall:.4f} s, {n} CAVI "
                      f"iterations, {1000 * wall / max(n, 1):.4f} ms per CAVI iteration; the loop "
                      f"alone {1000 * count['loop_s']:.4f} ms; {summary}; kernel launches "
                      f"{launches}")
                if not finite:
                    fail(f"{family} inference: {name} gave a non-finite output")
                if n <= 0 or launches != {"estep_eta": 0, "lambda_newton": 0, "theta_moments": n}:
                    fail(f"{family} inference: {name} did not launch the θ kernel once per CAVI "
                         f"iteration: {launches}, {n} iterations")
                total = {k: total[k] + launches[k] for k in total}
        lda_inference_reference_check(f"{family} inference", model, test, docs)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "model.npz")
            mt.save_model(path, model)
            loaded = mt.load_model(path)
        same = all(torch.equal(a, b) for a, b in zip(tensors(loaded.state), tensors(model.state)))
        again = mt.calculate_loglikelihood(loaded)
        print(f"{family} checkpoint: load_model on {loaded.device}: ll {loaded.ll}, state tensors "
              f"equal: {same}, ll recomputed from the loaded state {again}")
        if (loaded.device.type != "cuda" or type(loaded) is not type(model)
                or loaded.ll != model.ll or not same or abs(again - model.ll) > 1e-6 * abs(model.ll)):
            fail(f"the {family} checkpoint does not give back the fitted model on the card")
    return total


def main(argv=None):
    import argparse

    import torch

    p = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    p.add_argument("--theta-parent", metavar="DIR",
                   help="an earlier commit unpacked at DIR: phase 20 runs its θ kernel in turns "
                        "with this one")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import multimodalmusig_tpu_torch as mt
    from multimodalmusig_tpu_torch.ops import estep_kernel as ek
    from multimodalmusig_tpu_torch.ops import lambda_kernel as lk
    from multimodalmusig_tpu_torch.ops import ll_kernel as llk
    from multimodalmusig_tpu_torch.ops import theta_kernel as tk

    kernels = (ek, lk, tk)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}); nvidia-smi: {smi}")

    def timed_build(kernel):
        t0 = time.perf_counter()
        return kernel.build(), time.perf_counter() - t0

    parent_tk = parent_theta_kernel(args.theta_parent) if args.theta_parent else None
    with ThreadPoolExecutor(5) as pool:  # one nvcc per source, started together
        builds = list(pool.map(timed_build,
                               [*kernels, llk, *([parent_tk] if parent_tk else [])]))
    for lib, sec in builds:
        print(f"build: {sec:.2f} s ({lib})")
        with open(lib.rsplit("/", 1)[0] + "/build.log") as f:
            print("build log:\n" + f.read().strip())

    lam_err, (lam_ms, lam_plain_ms), lam_shapes = lambda_phase(lk)
    eta_err, (eta_ms, eta_plain_ms), eta_shapes = eta_phase(ek)
    theta_err, (theta_ms, theta_plain_ms) = theta_phase(tk)
    ll_rel, ll_times = ll_phase(llk)
    X, terms = load_brca()
    features = brca_features(*terms)
    reference_phase("MMCTM", mmctm_short_fit(mt, X))
    reference_phase("IMMCTM", immctm_short_fit(mt, X, features))
    reference_phase("LDA", lda_short_fit(mt, X[0]))
    reference_phase("ILDA", lda_short_fit(mt, X[0], features[0]))
    sync_probe(mt, X)
    docs = [[mt.make_count_matrix(X[m][d]) for m in range(2)] for d in range(X[0].shape[0])]
    docs_snv = [doc[0] for doc in docs]

    def with_ll(phase):
        """phase(), with the ll wrapper's calls in this process over the whole
        phase beside the launches it returns (first of a pair)."""
        llk.LAUNCHES = 0
        out = phase()
        (out[0] if isinstance(out, tuple) else out)["mixture_ll"] = llk.LAUNCHES
        return out

    immctm_launches, immctm_model = with_ll(lambda: immctm_phase(mt, kernels, X, features))
    paths = {"IMMCTM": immctm_launches}
    for label, phase in {
        "main path (fused and split)": lambda: main_path_phase(mt, kernels, X),
        "single model": lambda: {"estep_eta": single_model_phase(mt, ek, X),
                                 "lambda_newton": 0, "theta_moments": 0},
        "compaction": lambda: compaction_phase(mt, kernels, X),
        "two-stage": lambda: two_stage_phase(mt, kernels, X),
        "λ solve options": lambda: solver_options_phase(mt, kernels, X, features),
        "CLI": lambda: cli_phase(mt, kernels, terms),
        "inference, MMCTM": lambda: mmctm_inference_phase(mt, kernels, docs),
        "inference, IMMCTM": lambda: inference_phase(
            mt, kernels, "IMMCTM inference", immctm_model,
            mt.train_test_split_docs(docs, 0.2, seed=0)[1], docs),
        "K selection": lambda: k_selection_phase(mt, kernels, docs),
        "PCAWG scale": lambda: pcawg_phase(mt, kernels),
        "K=(20, 20) two-stage": lambda: k20_two_stage_phase(mt, kernels, docs),
        "LDA and ILDA": lambda: lda_phase(mt, kernels, docs_snv, features[0]),
        "inference, LDA and ILDA": lambda: lda_inference_phase(mt, kernels, docs_snv,
                                                               features[0]),
        "K=20 θ (phase 20)": lambda: k20_theta_phase(mt, kernels, X, docs_snv, parent_tk),
    }.items():
        out = with_ll(phase)
        paths[label] = out[0] if isinstance(out, tuple) else out
    cli_subprocess_phase()
    theta_launch_check(tk)
    ll_main_launches = ll_launch_check(mt, llk, X)
    paths["multi-device"] = with_ll(lambda: multi_device_phase(mt, X, docs, docs_snv, features))
    if paths["main path (fused and split)"]["mixture_ll"] <= 0:
        fail("the main path made no call of the ll kernel")
    launches = {k: sum(p[k] for p in paths.values()) for k in ("estep_eta", "lambda_newton",
                                                                "theta_moments")}
    print(f"kernel launches on the driven paths: {paths}")
    if min(launches.values()) <= 0:
        fail(f"a kernel was launched no time on the driven paths: {launches}")

    eta_bound_ms, eta_by = eta_bound(RESTARTS, 560, (7, 7), 3, 4, 1, 4)
    lam_bound_ms, lam_by = lambda_bound(RESTARTS, 560, 14, 3, 4, 1)
    theta_bound_ms, theta_by = theta_bound(RESTARTS, 560, 96, 7)
    print(f"bounds at the main-path shapes: η {eta_bound_ms:.5f} ms ({eta_by}), "
          f"λ {lam_bound_ms:.5f} ms ({lam_by}), θ {theta_bound_ms:.5f} ms ({theta_by}); "
          f"script time {time.perf_counter() - t_start:.1f} s")
    ll_ms, ll_plain_ms, ll_bound_ms, ll_by = ll_times[(RESTARTS, 2780)]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "estep_eta",
        "route": "cuda",
        "source": "multimodalmusig_tpu_torch/csrc/estep_eta.cu",
        "replaces": "tools/pallas_experiments/estep_kernel.py:117",
        "launches": launches["estep_eta"],
        "max_abs_err": eta_err,
        "ms": eta_ms,
        "plain_ms": eta_plain_ms,
        "bound_ms": eta_bound_ms,
        "bound_by": eta_by,
        "library_ms": None,
        "shapes": eta_shapes,
    }, {
        "name": "lambda_newton",
        "route": "cuda",
        "source": "multimodalmusig_tpu_torch/csrc/lambda_newton.cu",
        "replaces": "multimodalmusig_tpu/ops/pallas/lambda_kernel.py:264",
        "launches": launches["lambda_newton"],
        "max_abs_err": lam_err,
        "ms": lam_ms,
        "plain_ms": lam_plain_ms,
        "bound_ms": lam_bound_ms,
        "bound_by": lam_by,
        "library_ms": None,
        "shapes": lam_shapes,
    }, {
        "name": "theta_moments",
        "route": "cuda",
        "source": "multimodalmusig_tpu_torch/csrc/theta_moments.cu",
        "replaces": "tools/pallas_experiments/theta_kernel.py:83",
        "launches": launches["theta_moments"],
        "max_abs_err": theta_err,
        "ms": theta_ms,
        "plain_ms": theta_plain_ms,
        "bound_ms": theta_bound_ms,
        "bound_by": theta_by,
        "library_ms": None,
    }, {
        "name": "mixture_ll",
        "route": "cuda",
        "source": "multimodalmusig_tpu_torch/csrc/mixture_ll.cu",
        "replaces": None,
        "wrapper_calls": sum(p["mixture_ll"] for p in paths.values()),
        "main_path_launches": ll_main_launches,
        "max_rel_err": ll_rel,
        "ms": ll_ms,
        "plain_ms": ll_plain_ms,
        "bound_ms": ll_bound_ms,
        "bound_by": ll_by,
        "library_ms": None,
        "shapes": {f"{r},{d}": t for (r, d), t in ll_times.items()},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
