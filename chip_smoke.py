#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. Card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. Build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   one process per source, started together); build seconds.  The
   segmented sweeps' geometry at each shape they run (segment length L,
   segments S, columns C or rows R a block; for the row and plane sweeps
   the route, rows a group, ring depth, columns a block and the grid, as
   the wrappers launch them on this card) goes to the record.
3. Kernels against their plain PyTorch versions on the card, each with its
   max abs error against the stated tolerance, its time (CUDA events,
   median of 20 launches), its bound and a library call as a yardstick
   the port never calls.  The 2D solver's kernels at 1024x1024 float64, a
   ragged 1021x1019 and float32 (yardsticks: circular-padded ``F.conv2d``
   for the stencil, ``torch.linalg.lu_solve`` on a dense LU of the cyclic
   band for the two sweeps); the batched-1D stencil (the ``_D4``/``_D2``
   and ``cube_laplacian`` plans along x and along y) and the standalone
   RHS at the same shapes (yardstick: circular pad + ``F.conv1d``; none
   for the RHS); the 3D stencil and the plane-layout sweep at 256^3
   float64, a ragged 61x67x71 and float32 (yardsticks: circular pad +
   ``F.conv3d``; ``lu_solve`` broadcast over the planes); the WENO5
   advection RHS at 1024x1024 float64, 1021x1019 and float32, on the
   rotating blob and on a random field (no yardstick: no single PyTorch
   call computes it).  The column sweep also at a long M (40000 rows of
   64 columns, no shared-memory tile fits: the kernel's device-memory
   route), checked and timed, and so the row sweep (3 rows of 40000), the
   plane sweep ((2, 6000, 16)) and the fused RHS + x-sweep (3 rows of
   40000: the device-memory route in float64, a tile in float32).  The
   row sweep is also checked on the 3D x-sweep's (65536, 256) rows (256^3,
   ragged, float32) and timed there beside 1024^2, with its bound, plain
   version and ``lu_solve`` yardstick.  A user's point function given as
   CUDA source (``w[0] w[1] - c[0] w[2]``, not a sum of terms) is built
   at Create into its own copy of the stencil libraries and checked on
   each stencil kernel (a 2D plan and a batched-1D plan at 1024^2, a 3D
   plan at 256^3; periodic and np with out_init).  The stencils run with
   their plans' Create-time taps.  The 2D and batched-1D kernels also at
   the edges of their geometry, through plans in weighted, cube and user
   mode, float64 and float32, periodic and np with and without out_init:
   one row, one column, halos wider than the extent, 1021x1019; the
   stacks (1, 1), (3, 40000), (65536, 16) and 1024^2 along x and along y;
   and streamed plans (row and line windows) equal bit for bit to their
   monolithic launch.  The grid-limit shapes, the smallest ny at which
   the first launchers asked for more than 65535 blocks in grid.y:
   ``stencil2d`` and ``ch_rhs`` at 524281x8, ``weno5_advect`` at
   1048561x8, ``stencil3d`` at (1, 524281, 8) on its direct route and
   (1, 2097121, 8) on its tile route.  The standalone RHS (``ch_rhs``,
   a staged tile) also at one row, one column and 3x5 in both dtypes, its
   row chunks bit for bit its monolithic launch, and, as an observation,
   whether it equals bit for bit the RHS the fused kernel assembles
   (``ch_rhs_xsweep`` with the identity band).  The z windows of
   ``stencil3d`` and the plane windows of ``penta_mid`` (the slabs of the
   streamed 3D path) bit for bit their whole launches.  Timed besides: the 5x5 biharmonic
   plan (yardstick circular pad + ``F.conv2d``) and ``stencil1d_batch``
   along y (circular pad + ``F.conv2d`` with a (5, 1) kernel).
   The stacked ``stencil2d`` (the serving engine's rank-2 buckets): a
   ``(B, ny, nx)`` stack in one launch (``Stencil2D.apply_stacked``)
   equal bit for bit to its B single launches, and within the stencil
   tolerance of its plain version, at B = 1, 3, 32 at 1024^2 float64 for
   the 5x3 and 5x5 plans, B = 64 at 64^2, 1021x1019, float32, ``bc='np'``
   with and without out_init, and B = 80 at 1024^2 (81920 blocks, more
   than grid.y could hold); timed at (32, 1024, 1024) against its bound
   (0.160 ms), its plain version and a batched circular-pad ``F.conv2d``,
   and at (32, 64, 64) against 32 single launches (CUDA events).
4. Paths, each run with the launch counts set to 0 just before it and
   read just after:
   a. Main path: the 1024x1024 float64 Cahn–Hilliard solver, bootstrap
      plus 20 steps through ``ch_evolve`` from a band-limited deep quench,
      in ``rhs_mode='fused'`` on the kernels (launch counts asserted) and
      on the plain versions (``backend='torch'``), and in
      ``rhs_mode='stencil'``; fields compared, finite, mass conserved.
      Then, as an observation that fails nothing, the same run from the
      full-resolution deep quench.
   b. ``rhs_mode='batch1d'``: the same run on the batched-1D kernel
      (launch counts asserted), against its plain run and the fused run;
      mass conserved.  ``CahnHilliardADI.rhs`` in fused mode (the
      standalone RHS kernel) against its plain version and the stencil
      mode's RHS.
   c. 3D: the LOD diffusion step of ``examples/diffusion3d_adi.py`` at
      256^3 float64 through ``create``/``compute`` (x-, plane- and
      z-sweeps), 20 steps, each held to the exact discrete decay of the
      separable mode; the Laplacian plan's residual as a diagnostic;
      against the ``backend='torch'`` run.
   d. WENO: the experiment of ``examples/weno_advection.py`` at
      ``AdvectionConfig``'s default 512^2 float64 through
      ``WenoAdvection2D.run`` (the Gaussian blob, one revolution of
      solid-body rotation at CFL 0.4: 8043 RK3 steps, 24129 launches
      asserted), its L2 error within 1e-3 relative of the reference's and
      its extrema bounded; then 100 RK3 steps at 1024^2 on the kernel
      against ``backend='torch'``.
   e. Streaming: the 1024^2 float64 solver in ``rhs_mode='fused'`` and
      ``'batch1d'`` with ``streams=4`` and a ``max_tile_bytes`` that cuts
      every sweep into 8 chunks, bootstrap plus 20 steps, equal bit for bit
      to the monolithic runs of 4a and 4b, launch counts asserted (chunks
      times launches per step).
   f. 3D streaming: the LOD run of 4c with its operator and Laplacian plan
      created with ``streams=4, max_tile_bytes=20_000_000`` (8 chunks in
      each: z-slabs of 32 planes, 8192 rows, 32 planes, 8192 columns),
      equal bit for bit to 4c's run, launch counts asserted.
   g. Spectral (``backend='fft'``, ``torch.fft`` on the card, as the
      reference's ``jnp.fft``): the 5x5 biharmonic plan and the
      hyperdiffusion ADI operator at 1024^2 float64 (``alpha`` the main
      path's beta) against the same plans on the kernels, within scale 50,
      with 0 kernel launches, and the x-sweep's residual against the
      cyclic band; the stencil-mode solver with ``op_full``/``op_half`` on
      fft, bootstrap plus 20 steps from 4a's start field, within scale 2000
      of 4a's stencil-mode run, mean kept to 1e-12, launching ``stencil2d``
      only; the 3D LOD run of 4c with the operator and the Laplacian plan
      on fft, each step within 1e-10 of the exact decay, 0 launches.
   h. Examples: ``examples/torch_quickstart.py``,
      ``torch_cahn_hilliard_adi.py``, ``torch_diffusion3d_adi.py`` and
      ``torch_weno_advection.py`` as subprocesses, started together, at
      their default arguments (the Cahn–Hilliard script at ``--n 128``:
      at its default 256^2 its bootstrap overflows, as the reference
      script's does); each must exit 0 and print its result line (logs in
      ``chiprun_out/example_*.log``).
   i. Serving: ``python -m repro_torch.serve --requests 48`` (the CLI at
      its defaults, on the card) must verify and exit 0 (log in
      ``chiprun_out/serve_cli.log``); then 128 requests round-robin over
      the CLI's four classes raised to the paper's grid (``laplacian`` and
      ``biharmonic`` at 1024^2, ``laplacian`` lines of 1024,
      ``hyperdiffusion`` ADI at 1024^2 with alpha 0.1; float64, fields on
      the card) through ``ServeEngine(max_batch=32)``: every result bit for
      bit the port's sequential ``create``/``compute`` on the card, 0
      degrades and 0 retries, one ``stencil2d`` launch per rank-2 bucket
      (not per member), one ``stencil1d_batch`` per line bucket, one
      ``penta_rows`` and one ``penta_cols`` per ADI member (asserted);
      requests/s and p50/p99 latency.  Then the same stream with a
      ``'kernel.dispatch'`` ``backend_error`` at hit 1 (its class, and no
      other, degrades to ``backend='torch'``, within the float64 scale-10
      tolerance of the kernels' results) and with a
      ``'serve.bucket_compute'`` ``transient`` at hit 1 (retried once, the
      clean results bit for bit).
   j. The self-healing long run: ``resilient_evolve`` of 4a's solver from
      its start field, 64 steps in chunks of 16 (checkpoints under
      ``chiprun_out``, removed after): the clean run bit for bit
      ``ch_evolve``'s, a run with an ``'evolve.step'`` crash at hit 2 and a
      NaN at hit 3 healed to the same bits (rollbacks and failures
      listed), the last checkpoint read back bit for bit; the commit time
      of a chunk's pair (16 MB) and ms/step beside ``ch_evolve``'s.
   k. Tuning and lint, with a fresh cache under ``chiprun_out/tune_cache``
      (removed after): ``tune='force'`` Creates (``backend='auto'``, so
      fft races too) of the 1024^2 biharmonic plan and hyperdiffusion
      operator, of 4c's 256^3 operator (the ``penta_rows``, ``penta_mid``
      and ``penta_cols`` geometries) and Laplacian plan, of the 1024^2
      batched ``_D4`` plan, and of 4e's streamed fused solver (its
      streamed operators and plans race fft alone, and the (streams x
      chunk_rows) grid of the fused RHS + x-sweep races); each race's
      candidates with their times (CUDA events) and spreads, pruned
      candidates and winner, a kernel race without the stream hold
      failing the phase; each
      tuned Compute bit for bit the untuned one when a kernel geometry
      wins, within the fft scale when fft wins; the tuned streamed run bit
      for bit 4e's, and both streamed steps' ms/step in turns; a second
      ``tune='cached'`` Create of each with 0 measurements; a fresh
      1024^2 solver (every plan and operator of 4a, ``lint='warn'``)
      warning exactly ``SOLVER_LINT``, the reference's four
      ``adi_band_singular`` findings and no plan finding, a register with
      a wrong declared derivative raising
      ``LintError`` under ``lint='error'``, and the concurrency lint of
      ``src/repro_torch`` finding nothing.
   l. Distribution, in a one-rank NCCL world (``HashStore``; one card, so
      the halo exchange is the local wrap and a reshard a no-op), on the
      (1, 1) ``(data, model)`` and (1, 1, 1) ``(pod, data, model)``
      meshes: ``distributed_stencil_apply`` of the 5x5 biharmonic plan and
      an x-only (2, 1) plan at 1024^2 float64, periodic and ``np`` with
      out_init, overlap on and off, each against the plan's single-device
      Compute (scale 10; bit for bit printed as an observation), with
      ``stencil2d`` launches asserted (1; the interior plus one a
      non-empty band with overlap) and no collective counted; an
      (8, 1024, 1024) ensemble in one stacked launch;
      ``DistributedCahnHilliard`` at ``CHConfig()`` from 4a's (c1, c0),
      20 steps against 4a's fused run (scale 20 x 10), the mass summed by
      ``dist.all_reduce`` kept to 1e-10, one ``ch_rhs``, ``penta_rows``
      and ``penta_cols`` a step asserted; 8 fields for 5 steps
      (``penta_mid`` over the stack) against 8 single runs (scale 5 x
      10); ``stream_stencil_apply_dist`` in chunks of 128 rows on 4
      streams, bit for bit the unstreamed apply; the distributed step's
      ms/step beside the fused step's, in turns (an observation).
   m. The audit gate (``repro_torch.analysis``): ``run_audit(device=
      'cuda')`` over the full matrix of the four built-in operators, 44
      cells run (15 torch, 14 fft, 14 cuda and the fused CH cell on the
      kernels) with no violation, the sync-debug call and the profiler's
      kernel list included; the cost audit's counted vectors at the
      default shapes within their budgets; the six seeds, each failing
      closed with its rule on its designated torch cell and on the cuda
      counterpart; and the cuda cells at the paths' shapes
      (``CARD_SHAPES``: 1024^2, (1024, 1024) lines, 256^3) with their
      device time against the floor's time on the H100's peaks
      (``device_time_budget``), printed with each family's ratio.
   n. LM serving (``repro_torch.models``, ``repro_torch.launch.cells``;
      no kernel of the nine, 0 launches asserted; run after phase 5's
      timings): (1) each of the ten reduced configs in float32 on the same
      weights on the card and on the CPU, prefill logits of 64 tokens and
      8 decode steps within the CPU tests' logits tolerance, TF32 off
      (asserted); (2) at the published widths in float32, cut in depth as
      ``LM_CONFIGS`` says, at the serving shape (4 requests of 128 tokens;
      RWKV's chunked WKV in the prefill), decode after a chunked prefill
      against ``prefill_serve``'s last logits, one more token from a cache
      filled by
      ``cells.cache_from_prefill`` against the chunked cache's, and
      nemotron's int8 cache within 5% of the logit range with the same
      argmax or a near-tie; (3) in each config's bf16 policy at its serving
      depth (smollm-135m and whisper-base whole, llava-next-mistral-7b and
      rwkv6-7b at 32 layers, phi3.5-moe and jamba at 8 of 32, nemotron at
      2 of 96), 4 requests of 128 tokens (random patches for the VLM,
      zero frames for whisper) through ``make_prefill_step``, 32 greedy
      tokens each through ``make_serve_step`` (every step's logits finite,
      every token in the vocabulary), and one request through
      ``greedy_generate``, gated: the state rebuilt through the decode
      step (rwkv6, jamba, whisper) against the prefill's logits (jamba's,
      whose bf16 router may pick another expert on either path, recorded
      only), and
      ``greedy_generate``'s tokens against the batched ones up to the
      first differing token, which must be a near-tie (``LM_BF16_SCALE``);
      prefill tokens/s, decode ms a step at batch 4 (with the host's
      enqueue time a step) and 1, peak memory at init and while serving,
      and seconds a config.
   o. LM training (``repro_torch.optim``, ``repro_torch.data``,
      ``cells.make_train_step``, ``launch.train.train_loop``; no kernel of
      the nine, 0 launches asserted; run after 4n): (a) the ten reduced
      configs in float32 (TF32 off) at 2x64 on the same weights and batch
      on the card and the CPU: loss, every gradient leaf, params and
      state after one ``make_train_step`` (accum 2), and one update of
      each of adamw, adafactor and adamw8bit on the CPU's grads, each leaf
      within ``tolerance_for(float32, 10)`` norm-wise, adamw8bit's int8
      codes equal or one apart at a rounding tie (counted); (b)
      smollm-135m at its published widths and depth in bf16 with remat
      'full': 10 steps of ``train_loop`` at 8x4096 (accum 2), every loss
      finite and in (0, 3 ln V), and a learning gate (30 steps of a
      constant-lr adamw on one repeated 4x512 batch halve the loss); (c)
      remat 'full', 'dots' and 'none' at 4x512: losses and grads within
      ``tolerance_for(bfloat16)`` of each other, peak memory full < none
      and dots <= none; (d) exact resume, bit for bit, in a fresh
      process (``--lm-resume``) with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``
      and deterministic algorithms; (e) whisper-base whole and
      llava-next-mistral-7b, rwkv6-7b and phi3.5-moe at 2 of 32 layers,
      3 steps of ``train_loop`` each at train_4k's sequence (nemotron and
      jamba recorded as not trained, by the memory reckoning in the
      phase's comment); tokens/s, ms a step (host clock and CUDA
      events), host enqueue, peak GiB and model FLOP/s as a share of 989
      TFLOP/s bf16 for each config.
   p. LM sharding in a one-rank NCCL world (re-initialised after 4l's
      is torn down) on a (1, 1) data x model mesh: smollm-135m whole and
      phi3.5-moe at 1 of 32 layers in bf16, the sharded train step
      (params by the inferred specs, state by ``state_specs``, accum 2)
      and the decode with the cache over ('model',) against the
      unsharded ones, each timed; DTensor's collective counts; 0 kernel
      launches.
   q. The dry-run: ``python -m repro_torch.launch.dryrun`` in
      subprocesses, three cells on the fake 256- and 512-rank worlds;
      every record ``ok`` and fitting 80 GiB.
5. Timing: ms/step of the fused step over 200 steps after 20 of warm-up,
   of the stencil-mode step on the penta and on the fft sweeps and of the
   batched-1D step, of the 3D LOD step on the kernels, streamed and on
   fft, of the WENO RK3 step at
   1024^2 and of the streamed fused and batched-1D steps (host clock,
   CUDA events, and the host's enqueue time per step); each piece of the
   steps timed alone; and one ``torch.profiler`` window over 20 fused
   steps: device time by kernel name, the device-busy share and the gaps
   between kernels (trace in ``chiprun_out/fused_trace.json``).
6. The ``spectral`` JSON line (phases 4g and 4h and the fft steps'
   timings), the ``tune`` JSON line (phase 4k: each tuned object's
   choices and races, the cached Creates, the streamed ms/step, the
   checks and the lint), the ``dist`` JSON line (phase 4l: checks,
   bit-for-bit observations, mass drift, ms/step, launches), the
   ``audit`` JSON line (phase 4m: cells run, each family's worst device
   time, floor time and ratio, the fitted factors, the seeds' findings,
   the card and its power limit), the ``lm`` JSON line (phase 4n: the
   card and its power limit, the card-against-CPU error, each config's
   consistency error and limit, its serving numbers and its two bf16
   cross-checks), the ``lm_train`` JSON line (phase 4o: the card, the
   worst card-against-CPU share of its limit, the adamw8bit ties, the
   learning gate, the remat peaks, the resume and each trained config's
   numbers), the ``lm_shard`` JSON line (phase 4p: LM sharding in a
   one-rank NCCL world on a (1, 1) mesh, smollm-135m whole and
   phi3.5-moe at 1 layer in bf16: the sharded train step and the
   sequence-sharded decode against the unsharded ones, each path's ms
   a step, tokens/s and decode ms a token, the worst share of each
   tolerance, DTensor's collective counts, 0 kernel launches), the
   ``dryrun`` JSON line (phase 4q: ``python -m repro_torch.launch.dryrun``
   in subprocesses for smollm-135m x {train_4k, decode_32k} and rwkv6-7b
   x long_500k on the fake 256- and 512-rank worlds: each record's peak
   a device against 80 GiB, flops, bytes, collective bytes and roofline
   terms, records under ``chiprun_out/dryrun/``), the ``kernels``
   JSON line (each
   kernel's launches on the main path, and under ``paths`` on every path
   that launched it, the serving stream, the resilient run, the tuning
   Creates, phase 4l's distributed calls and phase 4m's audit included;
   ``stencil2d`` also carries its stacked timings), the card line, and
   the result line.

A full record goes to ``chiprun_out/chip_smoke.json`` and the nvcc logs to
``chiprun_out/nvcc_build.log`` and ``chiprun_out/nvcc_build_point_fn.log``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

N_MAIN = 1024
RAGGED = (1021, 1019)
N_STEPS = 20
N_TIMED = 200
N_TIMED_B1D = 50
N3 = 256  # the 3D path's box: 134 MB per float64 field
N_WENO_CHECK = 100  # RK3 steps of the 1024^2 kernel-vs-plain WENO run
# The stacked stencil2d (phase 3): the serving engine's largest bucket, and a
# stack whose B x tiles (80 x 1024 at 1024^2) exceeds 65535 blocks.
STACK_B = 32
STACK_MANY = 80
# Serving (phase 4i): the CLI's four classes raised to the paper's grid.
SERVE_CLASSES = [
    ("laplacian", (1024, 1024), None, None),
    ("biharmonic", (1024, 1024), None, None),
    ("laplacian", (1024,), None, None),
    ("hyperdiffusion", (1024, 1024), "adi", 0.1),
]
SERVE_N = 128
SERVE_MAX_BATCH = 32
SERVE_CLI_TIMEOUT_S = 300
# The self-healing long run (phase 4j)
N_RESILIENT = 64
CKPT_EVERY = 16
N_COMMITS = 5
# The reference's L2 error after one revolution at 512^2:
# examples/weno_advection.py --n 512 (backend='jnp', jax 0.9.0, float64,
# CPU), which prints 5.720e-08.
WENO_L2_REF = 5.720e-08
WENO_L2_RTOL = 1e-3
WENO_BOUND = 5e-3  # tests/test_weno.py: min >= -5e-3, max <= 1 + 5e-3
# Streaming (phase 4e): four streams and a budget that cuts every sweep of
# the 1024^2 float64 step into 8 chunks (128 rows, lines or columns).
STREAMS = 4
TILE_BYTES = 1_100_000
N_CHUNKS = 8
RAGGED_3D = (61, 67, 71)
LONG_M = (40000, 64)  # a column sweep whose (M, C) tile fits no block
LONG_ROWS = (3, 40000)  # a row sweep whose row fits no block beside the factors
LONG_MID = (2, 6000, 16)  # a plane sweep whose one-column tile fits no block
N_TIMED_3D = 20
# 3D streaming (phase 4f): the budget that cuts the 256^3 float64 LOD step
# and its Laplacian plan into 8 chunks each
TILE_BYTES_3D = 20_000_000
LOD = dict(D=0.5, dt=2e-3)  # examples/diffusion3d_adi.py defaults

# Published H100 SXM peaks, from NVIDIA's H100 SXM data sheet: HBM3
# bandwidth, float32 and float64 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

# Tolerances, as tolerance_for(dtype, scale) held norm-wise:
#   max|kernel - plain| <= atol + rtol * max|plain|.
# stencil2d: one pass of <= 25 products on the main path (110 in the
#   wide-halo edge case); FMA contraction and summation order move each
#   output by a few ulp of the largest term -> scale 10.
# penta_*: a serial recurrence over M = 1024 steps forward and back; the
#   kernel's FMAs round each step differently and the difference is carried
#   through L^{-1} and U^{-1} (cond(L) <= 1 + 16 beta, about 4.5e4 here)
#   -> scale 100.
# ch_rhs_xsweep: the RHS weights the biharmonic by k_bih ~ 2.8e3 at 1024^2,
#   but max|plain| already carries that factor, so only the recurrence's
#   own rounding is left (relative to max|plain|, the same ~3e-6 in float32
#   as penta_*) -> scale 10, which keeps the float32 limit (0.26 at 1024^2)
#   under what the nonlinear term k_lap * lap(c^3 - c) adds after the
#   x-solve, so a kernel that dropped it fails.
# stencil1d_batch, stencil3d: one pass of <= 5 (<= 27; 61 on the 3D
#   direct route's grid-limit case) products, as stencil2d -> scale 10.
# ch_rhs: the RHS alone, about 60 operations per point whose terms carry
#   k_bih ~ 2.8e3 at 1024^2; max|plain| already carries that factor, so
#   what is left is a few ulp of the summation -> scale 10.  Phase 3 also
#   checks that the nonlinear term k_lap lap(c^3 - c) alone exceeds each
#   limit, so a kernel that dropped it would fail.
# penta_mid: the recurrence of penta_cols over M = 256 steps and its
#   closure -> scale 100, as penta_*.
# weno5_advect: the same expressions in both versions, about 170 flops a
#   point; nvcc contracts products into FMAs and torch computes c / x for a
#   Python scalar c as c * (1 / x) (and x / c on the card as x * (1 / c)),
#   so an output moves by a few ulp of the largest term -> scale 10.  The
#   smoothness indicators square differences of nearly equal values, which
#   the ulp-level moves reach only through weights that they change by
#   parts in 1e12 (float64) -> no extra margin.
# Main path: 21 steps each within the fused tolerance -> scale 21 * 10;
#   the batched-1D run is held to the same limit, against its plain run
#   and against the fused run (its RHS differs from the fused one by
#   summation order only).
# 3D path: 20 steps of three sweeps, each within the recurrence tolerance
#   -> scale 20 * 100 against the plain run.
# WENO path: 100 RK3 steps, each within the RHS tolerance -> scale 100 * 10
#   against the plain run.  Against the exact decay of
#   the separable mode: |amp / (amp0 g^k) - 1| <= 1e-10 (the cyclic sweeps
#   keep the mode to rounding; 20 steps of 3 sweeps at cond ~ 1 + 4 r,
#   r ~ 1.7, leave it near 1e-14).
SCALE = {"stencil2d": 10, "penta_rows": 100, "penta_cols": 100,
         "ch_rhs_xsweep": 10, "ch_rhs": 10, "stencil1d_batch": 10,
         "stencil3d": 10, "penta_mid": 100, "weno5_advect": 10}
SCALE_MAIN = (N_STEPS + 1) * SCALE["ch_rhs_xsweep"]
SCALE_3D = N_STEPS * SCALE["penta_mid"]
SCALE_WENO = N_WENO_CHECK * SCALE["weno5_advect"]
MASS_DRIFT_MAX = 1e-10
DECAY_MAX = 1e-10
# The spectral phase (4g), as tests/test_spectral.py holds the reference:
# one apply or one solve against the kernels -> scale 50 (up to 25 taps a
# point, and each transform spreads a few ulp over every output); 20 CH
# steps whose per-step differences compound -> scale 2000; the mean of the
# field (the k = 0 mode, which every sweep keeps) to 1e-12.
SCALE_FFT = 50
SCALE_CH_FFT = 2000
FFT_MEAN_DRIFT_MAX = 1e-12
# The example scripts (phase 4h): their arguments and the label each must
# print.  Each runs at its defaults but the Cahn-Hilliard script: at its
# (and the reference's) default --n 256, dt 2e-3, the eq. 3 bootstrap
# grows grid-scale noise by up to 1 + 16 beta_half (about 270) and the
# cubic term overflows, so the run turns to NaN and fit_power_law raises,
# as examples/cahn_hilliard_adi.py does on the CPU (ROADMAP.md, Faults);
# at --n 128 the run stays in the coarsening regime to t = 8.
EXAMPLES = {
    "examples/torch_quickstart.py": ((), "[registry] laplacian max|err|"),
    "examples/torch_cahn_hilliard_adi.py": (("--n", "128"), "# max|grad^2 mu|"),
    "examples/torch_diffusion3d_adi.py": ((), "# final amp"),
    "examples/torch_weno_advection.py": ((), "L2 error after"),
}
EXAMPLE_TIMEOUT_S = 300

KERNEL_INFO = {
    "ch_rhs_xsweep": ("src/repro_torch/kernels/csrc/fused_ch.cu",
                      "src/repro/kernels/fused_ch.py:199"),
    "penta_cols": ("src/repro_torch/kernels/csrc/penta.cu",
                   "src/repro/kernels/penta.py:298"),
    "penta_rows": ("src/repro_torch/kernels/csrc/penta.cu",
                   "src/repro/kernels/penta.py:375"),
    "stencil2d": ("src/repro_torch/kernels/csrc/stencil2d.cu",
                  "src/repro/kernels/stencil2d.py:153"),
    "ch_rhs": ("src/repro_torch/kernels/csrc/fused_ch.cu",
               "src/repro/kernels/fused_ch.py:104"),
    "stencil1d_batch": ("src/repro_torch/kernels/csrc/stencil1d_batch.cu",
                        "src/repro/kernels/stencil1d_batch.py:116"),
    "stencil3d": ("src/repro_torch/kernels/csrc/stencil3d.cu",
                  "src/repro/kernels/stencil3d.py:111"),
    "penta_mid": ("src/repro_torch/kernels/csrc/penta.cu",
                  "src/repro/kernels/penta.py:427"),
    "weno5_advect": ("src/repro_torch/kernels/csrc/weno.cu",
                     "src/repro/kernels/weno.py:65"),
}


# A user's point function, not a sum of per-window terms: the plain
# version here, the CUDA source that the stencil kernels are built with.
MIXED_SOURCE = """
template <typename T>
__device__ T point_fn(const T* w, const T* c) {
  return w[0] * w[1] - c[0] * w[2];
}
"""


def mixed_point_fn(windows, coeffs):
    return windows[0] * windows[1] - coeffs[0] * windows[2]



class PhaseError(RuntimeError):
    pass


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def band_limited_quench(n: int, *, seed: int, modes: int = 64):
    """The paper's deep-quench IC drawn on a ``modes`` x ``modes`` grid and
    carried onto ``n`` x ``n`` with its spectrum zero-padded.

    The eq. 3 bootstrap treats delta_y^4 explicitly in its first half step,
    so a mode with k_x = 0 grows by up to 1 + 16 beta_half (about 3.4e4 at
    1024^2, dt = 1e-3) before the y-solve divides it back; the cubic term
    evaluated on that intermediate field then overflows (phase 4 shows
    it; the reference grows the same noise alike at 192^2, ROADMAP.md,
    Faults).  A field without grid-scale modes
    keeps the bootstrap finite, and the run stays in the paper's regime:
    amplitude ~0.1 noise resolved at 64^2."""
    import torch
    from repro_torch.core.cahn_hilliard import deep_quench_ic

    spec = torch.fft.rfft2(deep_quench_ic(modes, modes, seed=seed))
    big = torch.zeros((n, n // 2 + 1), dtype=spec.dtype, device=spec.device)
    h = modes // 2
    big[:h, : h + 1] = spec[:h, : h + 1]
    big[-h:, : h + 1] = spec[-h:, : h + 1]
    return torch.fft.irfft2(big, s=(n, n)) * (n * n) / (modes * modes)


def short_name(name: str) -> str:
    """A kernel's name without its namespace and template arguments' tail."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:70]


def kernel_rows(fn, n: int = 20) -> list:
    """One ``torch.profiler`` (CUPTI) window over ``n`` calls of ``fn``:
    ``[(kernel, launches, device ms a call)]`` for every device activity
    recorded (kernels and copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count, e.self_device_time_total / n / 1e3)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]


def device_ms(fn, n: int = 20, warmup: int = 3) -> float | None:
    """Mean device time of the kernels ``fn`` launches, per call, in ms:
    their durations as ``torch.profiler`` records them over ``n`` calls.
    Unlike CUDA events around a call, it leaves out the time the card
    waits for the host to enqueue the launch.  A window counts only when
    every kernel in it was recorded a multiple of ``n`` times (a window
    that lost activity records reads short: once a kernel at 0.7 of its
    byte bound); None when three windows in a row do not."""
    for _ in range(warmup):
        fn()
    for _ in range(3):
        rows = kernel_rows(fn, n)
        if rows and all(count % n == 0 for _, count, _ in rows):
            return sum(ms for _, _, ms in rows)
    return None


def time_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def profile_fused(solver, pair) -> dict:
    """One ``torch.profiler`` window over N_STEPS fused steps: device time
    by kernel name (``key_averages``), and from the exported trace the
    device-busy share of the span from the first kernel's start to the
    last one's end and the gaps between kernels, by the kernel before the
    gap.  An observation: nothing here fails the run, and a trace without
    device activity is reported as such."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    evolve = solver.make_evolve(N_STEPS)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            evolve(*pair)
            torch.cuda.synchronize()
        trace_path = OUT / "fused_trace.json"
        prof.export_chrome_trace(str(trace_path))
        averages = prof.key_averages()
    except Exception as exc:  # noqa: BLE001 - an observation, not a gate
        print(f"[prof] torch.profiler failed: {exc!r}")
        return dict(error=repr(exc))
    by_name = {}
    for e in averages:
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and str(e.device_type).endswith("CUDA"):
            k = short_name(e.key)
            got = by_name.setdefault(k, dict(count=0, device_us=0.0))
            got["count"] += e.count
            got["device_us"] += us
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    spans = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                    short_name(ev.get("name", "")))
                   for ev in events
                   if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in ev)
    out = dict(steps=N_STEPS, by_kernel=by_name)
    if not spans:
        print("[prof] key_averages and the trace show no device activity; "
              "phase 5's CUDA events stand")
        return dict(out, device_activity=False)
    busy, gaps, end = 0.0, {}, spans[0][0]
    prev = None
    for t0, t1, name in spans:
        if prev is not None and t0 > end:
            gaps[prev] = gaps.get(prev, 0.0) + (t0 - end)
        busy += max(0.0, t1 - max(t0, end))
        if t1 > end:
            end, prev = t1, name
    span = end - spans[0][0]
    out.update(device_activity=True, kernels_in_trace=len(spans), span_us=span,
               busy_us=busy, busy_share=busy / span,
               gap_us_by_previous_kernel=gaps, device_us_per_step=busy / N_STEPS,
               span_us_per_step=span / N_STEPS)
    print(f"[prof] {N_STEPS} fused steps ({len(spans)} kernels in the trace): "
          f"device busy {busy:.1f} of {span:.1f} us from the first kernel's "
          f"start to the last one's end (busy share {busy / span:.3f}; "
          f"{span / N_STEPS:.2f} us a step; the profiler slows the host, so "
          f"the share without it is higher)")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1]["device_us"]):
        print(f"[prof]   {v['device_us']:9.1f} us in {v['count']:4d} launches "
              f"({v['device_us'] / v['count']:.2f} us each)  {k}")
    for k, v in sorted(gaps.items(), key=lambda kv: -kv[1]):
        print(f"[prof]   gap after {k}: {v:.1f} us in all")
    return out


def run_examples() -> dict:
    """Run the port's example scripts as subprocesses, all started
    together, with the arguments of ``EXAMPLES`` (the card, ``--backend
    auto``); each must exit 0 and print its quantities.  Their output goes to
    ``chiprun_out/example_<name>.log``; a script past its time limit is
    killed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {
        path: subprocess.Popen(
            [sys.executable, str(ROOT / path), *EXAMPLES[path][0]], cwd=ROOT,
            env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for path in EXAMPLES
    }
    out, failed = {}, []
    for path, proc in procs.items():
        try:
            text, _ = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += f"\n(killed after {EXAMPLE_TIMEOUT_S} s)"
        name = Path(path).stem
        (OUT / f"example_{name}.log").write_text(text)
        lines = [ln for ln in text.splitlines() if EXAMPLES[path][1] in ln]
        out[name] = dict(rc=proc.returncode, line=lines[-1] if lines else None)
        print(f"[examples] {name}: rc {proc.returncode}; "
              f"{lines[-1] if lines else 'no result line'}", flush=True)
        if proc.returncode != 0 or not lines:
            failed.append(name)
    print(f"[examples] four scripts in {time.perf_counter() - t0:.1f} s "
          f"(run together; logs in chiprun_out/example_*.log)", flush=True)
    if failed:
        raise PhaseError(f"example scripts failed: {failed}")
    return out


def serve_cli() -> dict:
    """``python -m repro_torch.serve`` at its documented defaults (48
    requests, the card) as a subprocess: it must verify bit for bit against
    sequential create/compute and exit 0 (log in
    ``chiprun_out/serve_cli.log``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.serve", "--requests", "48"],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=SERVE_CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise PhaseError(f"serve CLI did not finish in {SERVE_CLI_TIMEOUT_S} s"
                         ) from exc
    text = proc.stdout + proc.stderr
    (OUT / "serve_cli.log").write_text(text)
    lines = {k: next((ln for ln in proc.stdout.splitlines() if k in ln), None)
             for k in ("req/s", "latency", "verify")}
    print(f"[serve] CLI at its defaults: rc {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; {lines['verify']}", flush=True)
    print(f"[serve]   {lines['req/s']}\n[serve]   {lines['latency']}")
    if proc.returncode != 0 or not (lines["verify"] and "bit-identical"
                                    in lines["verify"]):
        raise PhaseError(f"serve CLI failed (rc {proc.returncode}): see "
                         "chiprun_out/serve_cli.log")
    return dict(rc=proc.returncode, **lines)


def serve_phase(counts_of, expect, dev) -> dict:
    """Phase 4i: the CLI at its defaults, then a stream at the paper's grid
    (SERVE_CLASSES round-robin, SERVE_N requests, fields on the card) held
    bit for bit to sequential create/compute on the card, 0 degrades and 0
    retries, one stencil2d launch per stacked rank-2 bucket, one
    stencil1d_batch per line bucket, one penta_rows and one penta_cols per
    ADI member; then an injected kernel failure (degrades its class, within
    the stencil tolerance of the kernels' results) and an injected
    transient bucket fault (retried to the same results)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.runtime import chaos
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.cli import build_requests, sequential_reference
    from repro_torch.util import tolerance_for

    out = dict(cli=serve_cli())
    host = build_requests(SERVE_N, seed=0, steps=1, classes=SERVE_CLASSES)
    requests = [dataclasses.replace(r, field=r.field.to(dev)) for r in host]
    del host
    torch.cuda.synchronize()

    def served(plan=None):
        """``(results, stats, launches, seconds)`` of one engine over the
        stream, after a warm-up of one request a class."""
        with ServeEngine(max_batch=SERVE_MAX_BATCH, device=dev) as engine:
            engine.solve_many(requests[:len(SERVE_CLASSES)])
            engine.metrics.reset()
            ctx = (chaos.injected(plan) if plan is not None
                   else contextlib.nullcontext())
            with ctx:
                t0 = time.perf_counter()
                (results, stats), launches = counts_of(
                    lambda: (engine.solve_many(requests), engine.stats()))
                seconds = time.perf_counter() - t0
        return results, stats, launches, seconds

    results, stats, launches, seconds = served()
    refs = sequential_reference(requests, device=dev)
    same = [bool(torch.equal(r.out, ref)) for r, ref in zip(results, refs)]

    def buckets(rank, mode=None):
        return round(sum(1 / r.batch_size for r in results
                         if len(r.request.shape) == rank
                         and r.request.mode == mode))

    n_adi = sum(1 for r in results if r.request.mode == "adi")
    b2, b1 = buckets(2), buckets(1)
    expect(launches, dict(stencil2d=b2, stencil1d_batch=b1, penta_rows=n_adi,
                          penta_cols=n_adi), "served stream")
    n2 = sum(1 for r in results if len(r.request.shape) == 2
             and r.request.mode is None)
    lat = stats["latency"]
    out["stream"] = dict(
        requests=len(results), seconds=seconds,
        req_per_s=len(results) / seconds, p50_ms=lat["p50_s"] * 1e3,
        p99_ms=lat["p99_s"] * 1e3, mean_ms=lat["mean_s"] * 1e3,
        batches=stats["batches"], largest_batch=stats["largest_batch"],
        rank2_buckets=b2, rank2_requests=n2, line_buckets=b1, adi_members=n_adi,
        launches=launches, degraded=stats["degraded"], retries=stats["retries"],
        bit_for_bit=all(same))
    print(f"[serve] {len(results)} requests over {len(SERVE_CLASSES)} classes "
          f"at 1024^2 float64 on the card: {seconds:.3f} s, "
          f"{len(results) / seconds:.1f} req/s, p50 {lat['p50_s'] * 1e3:.2f} "
          f"ms, p99 {lat['p99_s'] * 1e3:.2f} ms; {stats['batches']} buckets "
          f"(largest {stats['largest_batch']}); launches {launches}: "
          f"stencil2d {b2} for {n2} rank-2 requests, stencil1d_batch {b1}, "
          f"penta_rows = penta_cols = {n_adi} ADI members", flush=True)
    print(f"[serve] bit for bit sequential create/compute: {sum(same)}/"
          f"{len(same)}; degraded {stats['degraded']}, retries "
          f"{stats['retries']}", flush=True)
    if not all(same) or stats["degraded"] or stats["retries"] or b2 >= n2:
        raise PhaseError(f"served stream: {out['stream']}")
    # where a bucket's time goes: its stack built on the card from 8
    # members, and its one download of 8 x 8 MB (host clock to the
    # synchronize, median of 5)
    members = [r.field for r in requests[:4 * 8:4]]

    def host_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    stack8 = torch.stack(members)
    out["bucket_pieces_ms"] = {
        "stack 8 members on the card": host_ms(lambda: torch.stack(members)),
        "download 8 x 8 MB": host_ms(lambda: stack8.cpu()),
    }
    del stack8, members
    print(f"[serve] a bucket of 8 at 1024^2: {out['bucket_pieces_ms']} (ms, "
          "host clock, median of 5)", flush=True)

    # an injected kernel failure at the first launch: its class degrades
    plan = chaos.FaultPlan(seed=1).add("kernel.dispatch", "backend_error", at=1)
    inj, inj_stats, _, _ = served(plan)
    first = requests[0]
    cls = lambda r: (r.operator, r.shape, r.mode)  # noqa: E731
    tol = tolerance_for(torch.float64, scale=10)
    worst, wrong = 0.0, []
    for r, clean in zip(inj, results):
        if cls(r.request) == cls(first):
            err = float((r.out - clean.out).abs().max())
            worst = max(worst, err / (tol["atol"] + tol["rtol"] *
                                      float(clean.out.abs().max())))
            if not r.degraded:
                wrong.append(r.tag)
        elif r.degraded or not torch.equal(r.out, clean.out):
            wrong.append(r.tag)
    n_first = sum(1 for r in requests if cls(r) == cls(first))
    out["injected_backend_error"] = dict(
        fired=plan.fired(), degraded=inj_stats["degraded"],
        degraded_classes=inj_stats["degraded_classes"],
        worst_err_over_limit=worst, wrong=wrong)
    print(f"[serve] injected kernel.dispatch backend_error at hit 1: "
          f"{plan.fired()}; degraded {inj_stats['degraded']} of {n_first} "
          f"{first.operator} {first.shape} requests "
          f"({inj_stats['degraded_classes']} class), their results within "
          f"{worst:.3f} of the float64 scale-10 limit of the kernels'; other "
          f"classes bit for bit and not degraded", flush=True)
    if (wrong or worst > 1.0 or inj_stats["degraded"] != n_first
            or inj_stats["degraded_classes"] != 1):
        raise PhaseError(f"injected backend_error: {out['injected_backend_error']}")

    # an injected transient bucket fault: retried to the same results
    plan = chaos.FaultPlan(seed=1).add("serve.bucket_compute", "transient", at=1)
    tr, tr_stats, _, _ = served(plan)
    tr_same = all(torch.equal(a.out, b.out) for a, b in zip(tr, results))
    out["injected_transient"] = dict(fired=plan.fired(),
                                     retries=tr_stats["retries"],
                                     degraded=tr_stats["degraded"],
                                     bit_for_bit=tr_same)
    print(f"[serve] injected serve.bucket_compute transient at hit 1: retries "
          f"{tr_stats['retries']}, degraded {tr_stats['degraded']}, results "
          f"bit for bit the clean run's {tr_same}", flush=True)
    if tr_stats["retries"] != 1 or tr_stats["degraded"] or not tr_same:
        raise PhaseError(f"injected transient: {out['injected_transient']}")
    return out


def resilient_phase(solver, c0, counts_of) -> dict:
    """Phase 4j: ``resilient_evolve`` of the 1024^2 fused solver, 64 steps in
    chunks of 16, into a directory under ``chiprun_out``: a clean run bit
    for bit ``ch_evolve``; a run with a crash at chunk boundary 2 and a NaN
    at 3 healed to the same bits; the last checkpoint read back bit for bit;
    the commit time of a chunk's pair and ms/step beside ``ch_evolve``'s."""
    import tempfile

    import torch
    from repro_torch.checkpoint import Checkpointer, restore_pytree
    from repro_torch.core.cahn_hilliard import ch_evolve
    from repro_torch.runtime import chaos
    from repro_torch.runtime.resilient import resilient_evolve

    out = {}
    steps = N_RESILIENT
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (want, _), n_evolve = counts_of(lambda: ch_evolve(solver, c0, steps))
    evolve_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=OUT) as root:
        t0 = time.perf_counter()
        clean, n_clean = counts_of(lambda: resilient_evolve(
            solver, c0, steps, directory=f"{root}/clean",
            checkpoint_every=CKPT_EVERY))
        clean_s = time.perf_counter() - t0
        plan = (chaos.FaultPlan(seed=3).add("evolve.step", "crash", at=2)
                .add("evolve.step", "nan", at=3))
        with chaos.injected(plan):
            healed, n_healed = counts_of(lambda: resilient_evolve(
                solver, c0, steps, directory=f"{root}/healed",
                checkpoint_every=CKPT_EVERY))
        back, manifest = restore_pytree({"c": c0, "c_prev": c0},
                                        f"{root}/healed")
        c_prev = ch_evolve(solver, c0, steps - 1)[0]
        read_back = (bool(torch.equal(back["c"], healed.c_final))
                     and bool(torch.equal(back["c_prev"], c_prev))
                     and back["c"].device == c0.device)
        # the commit of one chunk's pair (2 x 8 MB): a copy to the host on
        # this thread, then the writer's atomic save, waited for
        ckpt = Checkpointer(f"{root}/timed", keep_last=1)
        commits = []
        for k in range(N_COMMITS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save_async({"c": want, "c_prev": c_prev}, k)
            ckpt.wait()
            commits.append((time.perf_counter() - t0) * 1e3)
        ckpt.close()
    same_clean = bool(torch.equal(clean.c_final, want))
    same_healed = bool(torch.equal(healed.c_final, want))
    out.update(
        steps=steps, checkpoint_every=CKPT_EVERY,
        clean=dict(bit_for_bit_ch_evolve=same_clean, restarts=clean.restarts,
                   rollbacks=clean.rollbacks, seconds=clean_s,
                   ms_per_step=clean_s * 1e3 / (steps + 1), launches=n_clean),
        healed=dict(bit_for_bit=same_healed, restarts=healed.restarts,
                    rollbacks=healed.rollbacks, failures=healed.failures,
                    fired=plan.fired(), launches=n_healed),
        ch_evolve=dict(seconds=evolve_s, ms_per_step=evolve_s * 1e3 / (steps + 1),
                       launches=n_evolve),
        read_back=dict(bit_for_bit=read_back, step=manifest["step"]),
        commit_ms=dict(median=statistics.median(commits), all=commits))
    print(f"[resilient] {N_MAIN}^2 float64 fused, {steps} steps in chunks of "
          f"{CKPT_EVERY}: clean run bit for bit ch_evolve {same_clean} "
          f"(restarts {clean.restarts}); crash at hit 2 + nan at hit 3 "
          f"{plan.fired()}: healed bit for bit {same_healed}, restarts "
          f"{healed.restarts}, rollbacks {healed.rollbacks}, failures "
          f"{healed.failures}; checkpoint step {manifest['step']} read back "
          f"bit for bit {read_back}", flush=True)
    print(f"[resilient] ms/step (host clock, bootstrap included): resilient "
          f"{out['clean']['ms_per_step']:.3f}, ch_evolve "
          f"{out['ch_evolve']['ms_per_step']:.3f}; commit of a chunk's pair "
          f"(16 MB) {out['commit_ms']['median']:.2f} ms median of "
          f"{N_COMMITS}; launches clean {n_clean}", flush=True)
    if not (same_clean and same_healed and read_back
            and healed.rollbacks >= 1 and len(healed.failures) == 2
            and clean.restarts == 0):
        raise PhaseError(f"resilient run: {out}")
    return out


# Tuning and lint (phase 4k): the kernels whose launch geometry the tuner
# races on the main path's shapes (the fused RHS + x-sweep through the
# streamed-geometry race)
TUNED_KERNELS = ("stencil2d", "stencil1d_batch", "stencil3d", "penta_cols",
                 "penta_rows", "penta_mid", "ch_rhs_xsweep")
# (rule, severity) of each lint finding a fresh 1024^2 solver's Create
# emits: the reference's band lint calls I + beta delta^4 near-singular
# (circulant symbol min |lambda| ~ 1e-4 relative to its largest
# coefficient) on both sweeps of op_full and op_half, and no plan has a
# finding.  tests/test_torch_analysis.py holds the reference's Create at
# this shape to the same list.
SOLVER_LINT = [("adi_band_singular", "warning")] * 4


def analytic_floors(bounds: dict) -> dict:
    """The closed-form floors of ``repro_torch.analysis.cost`` for each
    kernel at its main path's float64 shape, in ms on this card's published
    peaks (max of bytes over HBM bandwidth and flops over the float64
    peak), beside the bound this script computes from the kernel's own
    traffic (``bounds``: name -> bound_ms).  The floors are the
    reference's formulas, kept for parity: ``expected_penta`` counts six
    field passes a sweep where a sweep kernel moves two, and
    ``expected_stencil`` one input field where the CH RHS reads two."""
    from repro_torch.analysis import cost as C

    def ms(e):
        return max(e.bytes / HBM_BYTES_PER_S,
                   e.flops / PEAK_FLOPS["float64"]) * 1e3

    n2, n3 = (N_MAIN, N_MAIN), (N3,) * 3
    floors = {
        "stencil2d": ("expected_stencil(1024^2, 13 taps, halo 2)",
                      C.expected_stencil(n2, 13, 8, halo=2)),
        "stencil1d_batch": ("expected_stencil(1024^2, 5 taps, halo 2)",
                            C.expected_stencil(n2, 5, 8, halo=2)),
        "stencil3d": ("expected_stencil(256^3, 7 taps, halo 1)",
                      C.expected_stencil(n3, 7, 8, halo=1)),
        "ch_rhs": ("expected_stencil(1024^2, 34 taps, halo 2)",
                   C.expected_stencil(n2, 34, 8, halo=2)),
        "penta_cols": ("expected_penta(1024^2, 1 sweep)",
                       C.expected_penta(n2, 8)),
        "penta_rows": ("expected_penta(1024^2, 1 sweep)",
                       C.expected_penta(n2, 8)),
        "penta_mid": ("expected_penta(256^3, 1 sweep)",
                      C.expected_penta(n3, 8)),
        "ch_rhs_xsweep": ("expected_stencil(34 taps) + expected_penta(1 "
                          "sweep), 1024^2", None),
    }
    rhs, sweep = C.expected_stencil(n2, 34, 8, halo=2), C.expected_penta(n2, 8)
    out = {}
    for name, (what, e) in floors.items():
        floor = ms(e) if e is not None else ms(rhs) + ms(sweep)
        out[name] = dict(floor=what, floor_ms=floor,
                         bound_ms=bounds.get(name),
                         ratio=floor / bounds[name] if bounds.get(name)
                         else None)
    step_bound = bounds.get("ch_rhs_xsweep", 0) + bounds.get("penta_cols", 0)
    out["fused CH step"] = dict(
        floor="expected_ch_step(1024^2)",
        floor_ms=ms(C.expected_ch_step(n2, 8)), bound_ms=step_bound or None,
        ratio=ms(C.expected_ch_step(n2, 8)) / step_bound if step_bound
        else None)
    out["fft apply"] = dict(floor="expected_fft(1024^2)",
                            floor_ms=ms(C.expected_fft(n2, 8)),
                            bound_ms=None, ratio=None)
    return out


def tune_summary(tuning: dict) -> dict:
    """The ``tune`` JSON line: each tuned object's choices and its races
    (kernel, winner, its microseconds, how many candidates raced and how
    many the prior pruned), the cached Creates, the streamed steps' median
    ms/step, the checks and the lint; the full record is in
    ``chip_smoke.json``."""
    out = {
        name: dict(choice=tuning[name]["choice"],
                   races=[dict(kernel=r["kernel"], winner=r["winner"],
                               us=r["us"], measured=len(r["measured"]),
                               pruned=len(r["pruned"]))
                          for r in tuning[name]["races"]])
        for name in tuning["objects"]}
    out.update(cached=tuning["cached"],
               ms_per_step_median={w: tuning[f"ms_per_step_{w}_median"]
                                   for w in ("untuned", "tuned")},
               checks=tuning["checks"], lint=tuning["lint"])
    return out


def tuning_phase(ctx: dict, counts_of) -> dict:
    """Phase 4k: Create-time tuning and lint on the card, with a fresh cache
    under ``chiprun_out/tune_cache`` (removed after).

    ``tune='force'`` Creates of the 1024^2 float64 biharmonic plan and
    hyperdiffusion operator (``backend='auto'``, so fft races too), of the
    256^3 LOD operator and Laplacian plan of 4c, and of the streamed fused
    solver of 4e (``streams=4``, ``max_tile_bytes`` of 4e): each race's
    candidates with their times (CUDA events), the pruned candidates and
    the winner.  Each tuned Compute against the untuned one: bit for bit
    when a kernel geometry wins, within the fft scale where fft wins; the
    tuned streamed solver's 20 steps bit for bit 4e's fused run (the fft
    CH scale where a sweep went to fft), and its ms/step beside the
    untuned one's, in turns.  The streamed solver's plans and operators
    stream at this shape, so they race fft alone (pruned or lost) and the
    batched-1D plan is raced alone, unstreamed.  A second
    ``tune='cached'`` Create of each measures nothing.  Then lint: a fresh
    1024^2 solver (every plan and operator of 4a through
    ``create(lint='warn')``) warns exactly :data:`SOLVER_LINT`, the
    reference's findings on the same bands (no plan finding); a register
    declaring the wrong derivative raises ``LintError`` under
    ``lint='error'``; the concurrency lint finds nothing in
    ``src/repro_torch``."""
    import shutil
    import warnings

    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch import analysis as an
    from repro_torch import tune as T
    from repro_torch.analysis.concurrency import lint_paths
    from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig, ch_evolve
    from repro_torch.launch import stream as S
    from repro_torch.util import tolerance_for

    cache_dir = OUT / "tune_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)
    env_before = os.environ.get(T.ENV_VAR)
    os.environ[T.ENV_VAR] = str(cache_dir)
    out: dict = dict(checks={})
    shape2, shape3 = (N_MAIN, N_MAIN), (N3,) * 3
    stream_cfg = dict(nx=N_MAIN, ny=N_MAIN, streams=STREAMS,
                      max_tile_bytes=TILE_BYTES)
    specs = {
        "biharmonic plan": lambda tune: rt.create(
            "biharmonic", shape2, tune=tune),
        "hyperdiffusion operator": lambda tune: rt.create(
            "hyperdiffusion", shape2, mode="adi", alpha=ctx["beta_full"],
            tune=tune),
        "3D LOD operator": lambda tune: rt.create(
            "diffusion", shape3, mode="adi", alpha=ctx["r3"], cyclic=True,
            tune=tune),
        "3D Laplacian plan": lambda tune: rt.create(
            "laplacian", shape3, bc="periodic", h=ctx["h3"], tune=tune),
        "batch D4 plan": lambda tune: rt.create(
            "biharmonic", shape2, mode="batch", tune=tune),
        "streamed fused solver": lambda tune: CahnHilliardADI(
            CHConfig(tune=tune, **stream_cfg)),
    }
    out["objects"] = list(specs)

    def cfgs(obj):
        """The tuned choices of a plan, operator or solver."""
        if isinstance(obj, CahnHilliardADI):
            plans = ("plan_bih", "plan_lap_cube", "plan_init_a", "plan_init_b",
                     "plan_d4_1d", "plan_d2_1d", "plan_lap_cube_1d")
            return dict(op_full=cfgs(obj.op_full), op_half=cfgs(obj.op_half),
                        stream=dict(streams=obj._streams_eff,
                                    chunk_rows=obj._chunk_rows_eff),
                        **{p: cfgs(getattr(obj, p)) for p in plans})
        if hasattr(obj, "y_cfg"):
            return {k: getattr(obj, k) for k in ("x_cfg", "y_cfg", "z_cfg")
                    if getattr(obj, k, None) is not None}
        return dict(backend=obj.backend, geometry=obj.geometry)

    def uses_fft(c):
        if isinstance(c, dict):
            return c.get("backend") == "fft" or any(uses_fft(v)
                                                    for v in c.values())
        return False

    try:
        made, cached = {}, {}
        for name, make in specs.items():
            T.reset_stats()
            made[name], launches = counts_of(lambda m=make: m("force"))
            races = [dict(r) for r in T.stats.races]
            out[name] = dict(choice=cfgs(made[name]), launches=launches,
                             races=races)
            # a second tune='cached' Create measures nothing and gets the
            # winners just stored (a later Create of the same problem, as
            # the streamed solver's operators are, may store others)
            T.reset_stats()
            again = make("cached")
            cached[name] = dict(measure_runs=T.stats.measure_runs,
                                cache_hits=T.stats.cache_hits,
                                cache_misses=T.stats.cache_misses,
                                same_winners=cfgs(again) == out[name]["choice"])
            del again
            for r in races:
                print(f"[tune] {name}: {r['kernel']} {tuple(r['shape'])}: "
                      f"winner {r['winner']} {r['us']:.2f} us (held "
                      f"{r['held']}, default kept on the spread "
                      f"{r['kept_default']}); " + "; ".join(
                          f"{m['config']} {m['us']:.2f} +{m['spread_us']:.2f}"
                          for m in r["measured"])
                      + (f"; pruned {r['pruned']}" if r["pruned"] else ""),
                      flush=True)
            if any(r["held"] is False and r["kernel"] != "ch_stream_geometry"
                   for r in races):
                raise PhaseError(f"{name}: a kernel race ran without the "
                                 "stream hold (no torch.cuda._sleep)")
        totals = {k: sum(out[n]["launches"][k] for n in specs)
                  for k in out[next(iter(specs))]["launches"]}
        out["launches"] = totals
        missing = [k for k in TUNED_KERNELS if not totals.get(k)]
        if missing:
            raise PhaseError(f"tuning launched no {missing}: {totals}")
        print(f"[tune] launches while tuning: {totals}")

        # the tuned Computes against the untuned ones
        gen = torch.Generator(device="cuda").manual_seed(23)
        x2 = torch.randn(shape2, generator=gen, device="cuda",
                         dtype=torch.float64)
        fft2 = tolerance_for("float64", scale=SCALE_FFT)
        d4 = rt.create("biharmonic", shape2, mode="batch")
        pairs = (("biharmonic plan", ctx["plan_bih"], x2),
                 ("hyperdiffusion operator", ctx["op_full"], x2),
                 ("3D LOD operator", ctx["op3"], ctx["u3"]),
                 ("3D Laplacian plan", ctx["lap3"], ctx["u3"]),
                 # the lines of apply_along_y, the layout it was tuned on
                 ("batch D4 plan", d4, x2.T))
        for name, untuned, x in pairs:
            got, want = rt.compute(made[name], x), rt.compute(untuned, x)
            if uses_fft(out[name]["choice"]):
                ctx["compare"](f"tuned {name} (fft won) vs untuned", got, want,
                               fft2, out["checks"])
            elif not bool(torch.equal(got, want)):
                raise PhaseError(f"tuned {name} differs from the untuned one "
                                 f"by {float((got - want).abs().max()):.3e}")
            out["checks"][f"tuned {name} equal to untuned"] = bool(
                torch.equal(got, want))
        solver_t = made["streamed fused solver"]
        (c_t, _), n_t = counts_of(lambda: ch_evolve(solver_t, ctx["c0"],
                                                    N_STEPS))
        if uses_fft(out["streamed fused solver"]["choice"]):
            ctx["compare"]("tuned streamed solver (fft won) vs 4e", c_t,
                           ctx["c_sf"], tolerance_for(
                               "float64", scale=SCALE_CH_FFT), out["checks"])
        else:
            same = bool(torch.equal(c_t, ctx["c_sf"]))
            out["checks"]["tuned streamed solver equal to 4e"] = same
            rows = solver_t._chunk_rows_eff or S.choose_chunk_rows(
                N_MAIN, N_MAIN, 8, top=2, bottom=2, left=2, right=2,
                max_tile_bytes=TILE_BYTES, streams=solver_t._streams_eff)
            if not same or n_t["ch_rhs_xsweep"] != N_STEPS * (N_MAIN // rows):
                raise PhaseError(f"tuned streamed solver: equal {same}, "
                                 f"launches {n_t}")
        out["streamed fused solver"]["run_launches"] = n_t
        print(f"[tune] tuned streamed solver {out['streamed fused solver']['choice']['stream']}: "
              f"bootstrap + {N_STEPS} steps, launches {n_t}; checks "
              f"{out['checks']}", flush=True)

        # ms/step, untuned (4e) and tuned streamed steps in turns
        def ms_per_step(s):
            ev = s.make_evolve(N_TIMED)
            pair = (s.initial_step(ctx["c0"]), ctx["c0"].clone())
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            ev(*pair)
            end.record()
            torch.cuda.synchronize()
            return dict(events=start.elapsed_time(end) / N_TIMED,
                        host=(time.perf_counter() - t0) * 1e3 / N_TIMED)

        # three rounds of (untuned, tuned, tuned, untuned): the steps are
        # host-bound, so one pair reads the host's noise
        turns = [("untuned", ctx["s_fused"]), ("tuned", solver_t),
                 ("tuned", solver_t), ("untuned", ctx["s_fused"])] * 3
        ms_per_step(solver_t)  # warm-up
        timed = [(who, ms_per_step(s)) for who, s in turns]
        out["ms_per_step"] = timed
        for who in ("untuned", "tuned"):
            ev = [t["events"] for w, t in timed if w == who]
            out[f"ms_per_step_{who}_median"] = statistics.median(ev)
            print(f"[tune] streamed fused step {who}: "
                  + ", ".join(f"{v:.4f}" for v in ev) + " ms/step (events), "
                  f"median {statistics.median(ev):.4f}")

        out["cached"] = cached
        print(f"[tune] cached Creates: {cached}")
        if any(c["measure_runs"] or not c["same_winners"]
               for c in cached.values()):
            raise PhaseError(f"cached Creates: {cached}")

        # lint: the main path warns exactly the reference's findings; a
        # wrong declaration raises under lint='error'; the locking
        # discipline holds
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            CahnHilliardADI(CHConfig(nx=N_MAIN, ny=N_MAIN))
        found = [str(w.message) for w in caught
                 if issubclass(w.category, an.StencilLintWarning)]
        rules = sorted(re.match(r"(\w+) \((\w+)\):", m).groups()
                       for m in found)
        try:
            rt.register_operator(
                "_chip_smoke_wrong_derivative",
                weights=lambda ndim=1, h=1.0: np.array([1.0, -2.0, 1.0]),
                derivative=4, lint="error")
            raised = []
        except an.LintError as e:
            raised = [str(f) for f in e.findings]
        concurrency = [str(f) for f in lint_paths([ROOT / "src" / "repro_torch"])]
        out["lint"] = dict(warnings_on_main_path=found,
                           wrong_derivative_findings=raised,
                           concurrency_findings=concurrency)
        for m in found:
            print(f"[lint] main path: {m}")
        print(f"[lint] main path: {len(found)} warnings {rules} (expected "
              f"{sorted(SOLVER_LINT)}); wrong derivative under "
              f"lint='error': LintError with {len(raised)} findings; "
              f"concurrency lint of src/repro_torch: {len(concurrency)} "
              "findings", flush=True)
        if (rules != sorted(SOLVER_LINT) or not raised or concurrency
                or "_chip_smoke_wrong_derivative" in rt.operator_names()):
            raise PhaseError(f"lint: {out['lint']}")
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        if env_before is None:
            os.environ.pop(T.ENV_VAR, None)
        else:
            os.environ[T.ENV_VAR] = env_before
    return out


# Distribution (phase 4l): one rank on the card, so the exchange is the
# local wrap and a reshard is a no-op; the multi-rank paths run on the CPU
# (tests/test_torch_domain.py).  Tolerances: a distributed apply against
# the same plan's single-device Compute -> the stencil's scale 10; the
# distributed CH run (the standalone RHS, then penta_rows, where 4a fuses
# them) against 4a's fused run -> 20 steps x 10; the ensemble's 5 steps
# against single runs -> 5 x 10.
DIST_STEPS = 20
DIST_ENS = 8
DIST_ENS_STEPS = 5
DIST_CHUNK_ROWS = 128
DIST_TIMED = 200


def dist_phase(ctx: dict, counts_of) -> dict:
    """Phase 4l: ``repro_torch.core.domain``, ``core.dist_ch`` and
    ``stream_stencil_apply_dist`` in a one-rank NCCL world (a
    ``HashStore``: no port); every distributed call's launches are summed
    into ``launches``, the comparisons' are not."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch as rt
    from repro_torch.core import domain as D
    from repro_torch.core.dist_ch import DistributedCahnHilliard
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.stream import stream_stencil_apply_dist
    from repro_torch.util import tolerance_for

    compare, solver, c0, c_fused = (ctx[k] for k in ("compare", "solver",
                                                     "c0", "c_fused"))
    n = N_MAIN
    dev = torch.device("cuda", torch.cuda.current_device())
    out = dict(checks={}, bit_for_bit={}, launch_counts={})
    total = dict.fromkeys(_build.LAUNCHES, 0)

    def run(fn, what, want_launches):
        """``fn()`` with its launches counted, asserted (``want_launches``
        names the kernels it launches; the rest must not launch) and added
        to the phase's total; no collective may be counted at one rank."""
        D.reset_collectives()
        res, got = counts_of(fn)
        want = dict(dict.fromkeys(got, 0), **want_launches)
        out["launch_counts"][what] = got
        if got != want:
            raise PhaseError(f"{what}: launches {got}, expected {want}")
        if any(D.COLLECTIVES.values()):
            raise PhaseError(f"{what}: collectives {D.COLLECTIVES} at one rank")
        for k, v in got.items():
            total[k] += v
        return res

    def bitwise(name, a, b):
        same = bool(torch.equal(a, b))
        out["bit_for_bit"][name] = same
        print(f"[dist] {name}: bit for bit {same}")
        return same

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        dd = D.DomainDecomposition(make_mesh_for())
        dd3 = D.DomainDecomposition(
            init_device_mesh("cuda", (1, 1, 1),
                             mesh_dim_names=("pod", "data", "model")),
            ensemble_axis="pod")
        gen = torch.Generator(device=dev).manual_seed(11)
        x = torch.randn((n, n), dtype=torch.float64, device=dev, generator=gen)
        init = torch.randn((n, n), dtype=torch.float64, device=dev,
                           generator=gen)
        w_asym = torch.randn(4, dtype=torch.float64, generator=torch.Generator()
                             .manual_seed(12)).numpy()
        tol = tolerance_for("float64", scale=SCALE["stencil2d"])

        # -- the stencils: 5x5 biharmonic and the x-only (2, 1) plan
        plans = {}
        for bc in ("periodic", "np"):
            plans[f"biharmonic {bc}"] = (
                solver.plan_bih if bc == "periodic" else
                rt.create("biharmonic", (n, n), mode="xy", bc=bc))
            plans[f"x-asym {bc}"] = rt.create(
                w_asym, (n, n), mode="x", bc=bc, lint="off",
                extents=dict(left=2, right=1))
        for name, plan in plans.items():
            ini = init if plan.bc == "np" else None
            want = plan.apply(x, ini)
            bands = sum(h > 0 for h in (plan.top, plan.bottom, plan.left,
                                        plan.right))
            for overlap in (True, False):
                got = run(lambda p=plan, i=ini, o=overlap:
                          D.distributed_stencil_apply(p, x, dd, i, overlap=o),
                          f"{name} overlap={overlap}",
                          dict(stencil2d=1 + bands if overlap else 1))
                label = f"{name} overlap={overlap} vs single-device"
                compare(label, got.to_local(), want, tol, out["checks"])
                bitwise(label, got.to_local(), want)

        # the ensemble: one stacked launch (5 with the overlap's bands)
        ens = torch.randn((DIST_ENS, n, n), dtype=torch.float64, device=dev,
                          generator=gen)
        want = solver.plan_bih.apply_stacked(ens)
        for overlap, k in ((False, 1), (True, 5)):
            got = run(lambda o=overlap: D.distributed_stencil_apply(
                solver.plan_bih, ens, dd3, overlap=o),
                f"ensemble overlap={overlap}", dict(stencil2d=k))
            label = f"ensemble {tuple(ens.shape)} overlap={overlap}"
            compare(label, got.to_local(), want, tol, out["checks"])
            bitwise(label, got.to_local(), want)
        del ens, want

        # -- the solver: 4a's start, 20 steps, against 4a's fused run
        dsolver = DistributedCahnHilliard(solver.cfg, dd)
        c1 = solver.initial_step(c0)
        step_launches = dict(ch_rhs=1, penta_rows=1, penta_cols=1)
        run(lambda: dsolver.step(c1, c0), "dist step", step_launches)
        c_d, _ = run(lambda: dsolver.multi_step(c1, c0, DIST_STEPS),
                     f"dist CH {DIST_STEPS} steps",
                     {k: DIST_STEPS for k in step_launches})
        c_d = c_d.to_local()
        compare(f"dist CH {DIST_STEPS} steps vs 4a fused", c_d, c_fused,
                tolerance_for("float64",
                              scale=DIST_STEPS * SCALE["ch_rhs_xsweep"]),
                out["checks"])
        mass = c_d.sum()
        dist.all_reduce(mass)  # the global sum, over the NCCL group
        drift = abs(float(mass) - ctx["m0"]) / ctx["a0"]
        out["mass_drift"] = drift
        print(f"[dist] CH mass drift (all_reduce) {drift:.3e} <= "
              f"{MASS_DRIFT_MAX:.0e}")
        if not drift <= MASS_DRIFT_MAX:
            raise PhaseError(f"dist CH mass drift {drift:.3e}")

        # the ensemble of 8 fields: penta_mid over the (8, ny, nx) stack
        e0 = torch.stack([band_limited_quench(n, seed=s)
                          for s in range(DIST_ENS)])
        e1 = torch.stack([solver.initial_step(e) for e in e0])
        dsolver3 = DistributedCahnHilliard(solver.cfg, dd3)
        e_d, _ = run(lambda: dsolver3.multi_step(e1, e0, DIST_ENS_STEPS),
                     f"dist CH ensemble {DIST_ENS_STEPS} steps",
                     dict(ch_rhs=DIST_ENS_STEPS, penta_rows=DIST_ENS_STEPS,
                          penta_mid=DIST_ENS_STEPS))
        singles = []
        for m in range(DIST_ENS):
            a, b = e1[m], e0[m]
            for _ in range(DIST_ENS_STEPS):
                a, b = solver.step(a, b)
            singles.append(a)
        compare(f"dist CH ensemble of {DIST_ENS} vs single runs",
                e_d.to_local(), torch.stack(singles),
                tolerance_for("float64",
                              scale=DIST_ENS_STEPS * SCALE["ch_rhs_xsweep"]),
                out["checks"])
        del e0, e1, e_d, singles

        # -- streaming: chunks of 128 rows on a pool of 4 streams
        for bc in ("periodic", "np"):
            plan = rt.create("biharmonic", (n, n), mode="xy", bc=bc,
                             streams=STREAMS)
            ini = init if bc == "np" else None
            got = run(lambda p=plan, i=ini: stream_stencil_apply_dist(
                p, x, dd, i, chunk_rows=DIST_CHUNK_ROWS),
                f"streamed {bc}", dict(stencil2d=n // DIST_CHUNK_ROWS))
            whole = D.distributed_stencil_apply(plan, x, dd, ini,
                                                overlap=False)
            if not bitwise(f"streamed {bc} vs unstreamed distributed apply",
                           got.to_local(), whole.to_local()):
                raise PhaseError(f"streamed {bc}: not bit for bit")

        # -- timing: the distributed step beside the fused step, in turns
        def timed(run_steps, carry):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            carry = run_steps(carry)
            end.record()
            t_enq = time.perf_counter()
            torch.cuda.synchronize()
            return carry, dict(
                host=(time.perf_counter() - t0) * 1e3 / DIST_TIMED,
                events=start.elapsed_time(end) / DIST_TIMED,
                host_enqueue=(t_enq - t0) * 1e3 / DIST_TIMED)

        evolve = solver.make_evolve(DIST_TIMED)
        fused = lambda p: evolve(*p)
        dstep = lambda p: dsolver.multi_step(*p, DIST_TIMED)
        fused((c1.clone(), c0.clone()))  # warm-up
        dstep((c1, c0))
        times = {"fused": [], "dist": []}
        for name in ("fused", "dist", "dist", "fused"):
            fn = fused if name == "fused" else dstep
            _, t = timed(fn, (c1.clone(), c0.clone()))
            times[name].append(t)
        out["ms_per_step"] = times
        for name, ts in times.items():
            for t in ts:
                print(f"[dist] {name} step: {t['events']:.4f} ms/step (events), "
                      f"host {t['host']:.4f}, enqueue {t['host_enqueue']:.4f}")
        # where a step's device time goes: one profiler window of 20 steps
        # each, after the timing; an observation (a window may lose
        # records, so each row keeps its count of 20)
        out["device_ms"] = {}
        for name, fn in (("dist", lambda: dsolver.step(c1, c0)),
                         ("fused", lambda: solver.step(c1, c0))):
            rows = kernel_rows(fn)
            out[f"{name}_device_rows"] = rows
            out["device_ms"][name] = sum(ms for _, _, ms in rows)
            for k, cnt, ms in rows:
                print(f"[dist-prof] {name}: {short_name(k)}: {cnt} of 20, "
                      f"{ms:.4f} ms a step")
        print(f"[dist] device ms a step (profiler): {out['device_ms']}")
    finally:
        dist.destroy_process_group()
    out["launches"] = total
    return out


# The audit gate on the card (phase 4m): the four built-in operators (the
# registry's, before any test registers more)
AUDIT_OPERATORS = ("biharmonic", "diffusion", "hyperdiffusion", "laplacian")


def audit_phase(counts_of) -> dict:
    """Phase 4m: ``run_audit(device='cuda')`` over the full matrix (44
    cells run: the 15 torch, 14 fft and 14 cuda cells the reference runs
    under the backend map, and the fused CH cell on the kernels), the
    cost audit's counted vectors at the default shapes, the six seeds
    (``SEED_RULES``) on their designated torch cells and on the cuda
    counterparts (the launch record must carry the kernels' own work into
    the vector), and the
    cost audit of the cuda cells at the paths' shapes (``CARD_SHAPES``)
    with their device time against the floor's.  Any violation of a clean
    run (a kernel list that no profiler window recorded among them), and
    any seed that does not fail closed with its rule, fails the phase.
    The phase's launches, the seeds' included, are summed into
    ``launches``."""
    import torch

    from repro_torch.analysis import audit as A
    from repro_torch.kernels import _build

    total = dict.fromkeys(_build.LAUNCHES, 0)

    def counted(fn):
        out, launches = counts_of(fn)
        for k, v in launches.items():
            total[k] += v
        return out

    def problems(report):
        return [f"{r.family}/{r.operator}/{r.backend}: {f}"
                for r in report.violations for f in r.findings]

    t0 = time.perf_counter()
    cache = A.CellArtifacts()
    report = counted(lambda: A.run_audit(operators=AUDIT_OPERATORS,
                                         cache=cache, device="cuda"))
    matrix = [r for r in report.results if r.rules != ("rebuild_budget",)]
    ran = sorted(f"{r.family}/{r.operator}/{r.backend}" for r in matrix
                 if r.skipped is None)
    by_backend = {b: sum(c.endswith("/" + b) for c in ran)
                  for b in A.BACKENDS}
    print(f"[audit] run_audit(device='cuda'): {len(ran)} of {len(matrix)} "
          f"cells run ({by_backend}), {len(report.violations)} violation(s)",
          flush=True)
    if problems(report):
        raise PhaseError(f"the card audit is not clean: {problems(report)}")
    if len(ran) != 44 or by_backend != {"torch": 15, "cuda": 15, "fft": 14}:
        raise PhaseError(f"the card audit ran {by_backend}, expected 15 "
                         "torch, 15 cuda (the fused CH cell included), 14 fft")
    cost = counted(lambda: A.run_cost_audit(operators=AUDIT_OPERATORS,
                                            cache=cache, device="cuda"))
    if problems(cost):
        raise PhaseError(f"the card's cost audit is not clean: "
                         f"{problems(cost)}")
    counted_ratios = {}
    for r in cost.results:
        if r.skipped is None:
            m, e = r.measured, r.expected
            counted_ratios[r.cell] = dict(
                flops=m.flops / e.flops, bytes=m.bytes / e.bytes,
                peak_memory=m.peak_memory / e.peak_memory,
                step_bytes=max((lp.per_trip_bytes / e.step_bytes
                                for lp in m.loops), default=None))
    for cell, v in sorted(counted_ratios.items()):
        if cell.endswith("/cuda"):
            print(f"[audit] counted {cell}: " + ", ".join(
                f"{k} {x:.3f}x" for k, x in v.items() if x is not None))

    seeds = {}
    for seed, (rule, family, op) in A.SEED_RULES.items():
        for backend in ("torch", "cuda"):
            kw = dict(operators=(op,), families=(family,),
                      backends=(backend,), seed_violation=seed, device="cuda")
            if seed in A.COST_SEEDS:
                rep = counted(lambda: A.run_cost_audit(**kw))
            else:
                rep = counted(lambda: A.run_audit(retrace=False, **kw))
            rules = sorted({f.rule for r in rep.results for f in r.findings})
            seeds[f"{seed}/{backend}"] = rules
            print(f"[audit] seed {seed} in {family}/{op}/{backend}: "
                  f"findings {rules}")
            if rep.ok or rule not in rules:
                raise PhaseError(f"seed {seed} on {backend} did not fail "
                                 f"closed with {rule}: {rules}")

    timed = counted(lambda: A.run_cost_audit(
        operators=AUDIT_OPERATORS, backends=("cuda",), shapes=A.CARD_SHAPES,
        device="cuda"))
    device = {}
    for r in timed.results:
        if r.skipped is None:
            d = r.to_dict()
            device[r.cell] = dict(
                shape=list(A.CARD_SHAPES[r.family]),
                device_ms=r.measured.device_ms,
                floor_ms=d["floor_ms"], ratio=d["device_time_bloat"],
                factor=A.CARD_FACTORS[r.family])
            print(f"[audit] device {r.cell} at {A.CARD_SHAPES[r.family]}: "
                  f"{r.measured.device_ms:.4f} ms (held-stream events) "
                  f"against the floor's {d['floor_ms']:.4f} ms "
                  f"({d['device_time_bloat']:.3f}x; factor "
                  f"{A.CARD_FACTORS[r.family]})")
    if problems(timed):
        raise PhaseError(f"the cost audit at the paths' shapes is not clean: "
                         f"{problems(timed)}")
    families = {}
    for cell, v in device.items():
        fam = cell.split("/")[0]
        worst = families.get(fam)
        if worst is None or v["ratio"] > worst["ratio"]:
            families[fam] = dict(v, cell=cell)
    seconds = time.perf_counter() - t0
    print(f"[audit] phase 4m: {seconds:.1f} s", flush=True)
    torch.cuda.synchronize()
    return dict(cells_run=len(ran), by_backend=by_backend,
                violations=len(report.violations),
                counted=counted_ratios,
                seeds=seeds, device=device, families=families,
                factors=dict(A.CARD_FACTORS), meta=timed.meta,
                launches=total, seconds=seconds)


# LM serving (phase 4n): the LM substrate's serving path
# (repro_torch.models, repro_torch.launch.cells).  Each published config runs
# at its own widths, cut in depth where the table says: (arch, layers served
# in bf16, layers of the float32 consistency check).  The depth cuts keep a
# config on one card: bf16 weights (ArchConfig.param_count at the cut depth)
# of 0.3 GiB (smollm), 0.2 (whisper), 13.5 (llava), 14.1 (rwkv6), 19.9
# (phi3.5-moe), 24.8 (jamba: one period of 8 layers, the period that the
# hybrid's stack needs) and 30.4 (nemotron); float32 doubles them, so the
# 7B-class models run their consistency check at 2 layers.
LM_CONFIGS = (
    ("smollm-135m", 30, 30),
    ("whisper-base", 6, 6),
    ("llava-next-mistral-7b", 32, 2),
    ("rwkv6-7b", 32, 2),
    ("phi3.5-moe-42b-a6.6b", 8, 2),
    ("jamba-v0.1-52b", 8, 8),
    ("nemotron-4-340b", 2, 2),
)
LM_SEED = 0
LM_BATCH = 4  # requests served together
LM_PROMPT = 128  # prompt tokens a request
LM_NEW = 32  # greedy tokens a request
# Prompt tokens of the card-against-CPU check: 64 takes RWKV's chunked WKV
# in the prefill (s % 32 == 0 and s > 32, models/ssm.py), as the serving
# prompt of 128 does; the decode step takes the per-step recurrence.  The
# float32 consistency check runs at the serving shape, LM_BATCH x
# LM_PROMPT.
LM_CPU_PROMPT = 64
LM_CPU_STEPS = 8  # decode steps of the card-against-CPU check
# Tolerances.  Card against CPU (reduced configs, float32): the CPU tests'
# logits tolerance, tolerance_for(float32, 10) held elementwise
# (tests/_torch_lm_common.py: up to 8 layers whose products the two
# devices sum in another order).  Consistency at full width (float32, TF32
# off): decode after chunked prefill against prefill_serve's last logits,
# held norm-wise (max|a - b| <= atol + rtol max|b|) at
# tolerance_for(float32, 100): up to 30 layers of products of length up to
# 73728 that the two paths sum in another order (flash against decode
# attention, a (B*S, d) product against a (B, d) one).  The int8 cache
# (nemotron) against the exact decode: within 5% of the logit range with
# the same argmax, the reference's test_int8_kv_cache_decode_close, a
# differing argmax of a request allowed only at a near-tie within that
# limit (the rule below).
# bf16 serving (the config's own policy) holds two pairs of paths to each
# other: the state rebuilt through the decode step against the batched
# prefill's last logits (rwkv6, jamba, whisper), and greedy_generate
# (batch 1, the prompt through the decode step) against the batched
# serving's tokens.  Logits norm-wise at tolerance_for(bfloat16, 5): bf16's
# 2e-2 baseline, and up to 32 layers whose products and attention the two
# paths round at another shape (a (B*S, d) product against a (B, d) one,
# flash against decode attention, the chunked WKV against its per-step
# recurrence); the float32 check above holds the same pairs tightly, at
# the same shapes.  Not for an MoE config: its router's logits are bf16
# (as the reference's, models/moe.py), so two paths can tie and pick
# another expert for a token, which moves that request's logits by O(1);
# its rebuilt logits are recorded, and its tokens held by the rule below.
# A differing argmax is a near-tie (the CPU tests' rule): the logits that
# chose one token must put the other within that limit of it; past the
# first differing token the contexts differ and the tokens are not compared.
LM_SELF_SCALE = 100
LM_BF16_SCALE = 5


def _lm_to(tree, device):
    if isinstance(tree, dict):
        return {k: _lm_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_lm_to(v, device) for v in tree)
    return tree.to(device)


def _lm_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_lm_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_lm_numel(v) for v in tree)
    return tree.numel()


def _lm_batch(cfg, rng, B, S, device, dtype=None):
    """Token ids from a numpy seed; random ``patches`` for the VLM, zero
    ``frames`` for whisper (as ``greedy_generate`` uses them)."""
    import torch

    batch = {"tokens": torch.as_tensor(
        rng.integers(1, cfg.vocab, (B, S)).astype("int32"), device=device)}
    dt = dtype or cfg.dtype_policy.cdt
    if cfg.family == "vlm":
        batch["patches"] = (torch.as_tensor(rng.standard_normal(
            (B, cfg.img_tokens, cfg.d_model)).astype("float32"),
            device=device) * 0.1).to(dt)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                                      dtype=torch.float32, device=device)
    return batch


def _lm_limit(ref, tol) -> float:
    """The norm-wise limit ``atol + rtol max|ref|``."""
    return tol["atol"] + tol["rtol"] * float(ref.abs().max())


def _lm_near_tie(chose, other, limit) -> tuple[bool, float]:
    """``chose`` are the logits (V,) that picked their argmax; the other path
    picked ``other``.  A near-tie when ``other``'s logit lies within
    ``limit`` of the maximum.  Returns (near tie, gap)."""
    gap = float(chose.max() - chose[other])
    return gap <= limit, gap


def _lm_cross(model, params, batch, cache):
    """whisper: the encoder's cross K/V into the cache."""
    _, (xk, xv) = model.prefill_serve(params, batch)
    return dict(cache, xk=xk, xv=xv)


def _lm_free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def lm_phase(counts_of) -> dict:
    """Phase 4n: the LM serving path on the card.  (1) Each of the ten
    reduced configs in float32 on the same weights on the card and on the
    CPU: prefill logits of ``LM_CPU_PROMPT`` tokens and 8 decode steps
    within the CPU tests' logits tolerance (TF32 off, asserted).  (2) At
    the published widths, float32, at ``LM_CONFIGS``' check depth and the
    serving shape (4 x 128; RWKV's chunked WKV against its per-step
    recurrence): decode after chunked prefill against prefill_serve's last
    logits; for the attention
    families, one more token decoded from a cache filled by
    ``cells.cache_from_prefill`` against the chunked cache's; nemotron's
    int8 cache against its exact one.  (3) In each config's bf16 policy at
    ``LM_CONFIGS``' serving depth: 4 requests of 128 tokens through
    ``make_prefill_step``, 32 greedy tokens each through
    ``make_serve_step`` (every step's logits finite, checked on the card),
    one request through ``greedy_generate``; the rebuilt state's logits
    against the prefill's (not gated for an MoE config) and both paths'
    tokens under the near-tie rule at ``LM_BF16_SCALE``; prefill tokens/s,
    decode ms a step at batch 4 and 1, peak memory, seconds.  The nine
    kernels are launched 0 times (asserted).  Any failure raises."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch import cells
    from repro_torch.models import transformer as tf
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import DTypePolicy
    from repro_torch.runtime.sharding import Shardings
    from repro_torch.util import tolerance_for

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise PhaseError("phase 4n needs torch.backends.cuda.matmul."
                         "allow_tf32 False")
    print(f"[lm] allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}",
          flush=True)
    sh = Shardings.none()
    dev = torch.device("cuda")
    card = card_line()
    rec: dict = dict(card=card, cpu_vs_card=[], consistency=[], serving=[])

    def run():
        # -- (1) card against CPU, reduced configs, float32 --------------------
        tol = tolerance_for(torch.float32, scale=10)
        for arch in list_archs():
            cfg = get_config(arch).reduced()
            mc, mg = build_model(cfg, device="cpu"), build_model(cfg,
                                                                 device=dev)
            pc = mc.init(LM_SEED)
            pg = _lm_to(pc, dev)
            bc = _lm_batch(cfg, np.random.default_rng(LM_SEED), 2,
                           LM_CPU_PROMPT, "cpu")
            bg = _lm_to(bc, dev)
            pairs = [(mc.prefill_logits(pc, bc), mg.prefill_logits(pg, bg))]
            cc, cg = mc.init_cache(2, LM_CPU_STEPS), mg.init_cache(
                2, LM_CPU_STEPS)
            if cfg.family == "encdec":
                cc, cg = _lm_cross(mc, pc, bc, cc), _lm_cross(mg, pg, bg, cg)
            for i in range(LM_CPU_STEPS):
                lc, cc = mc.decode(pc, bc["tokens"][:, i], i, cc)
                lg, cg = mg.decode(pg, bg["tokens"][:, i], i, cg)
                pairs.append((lc, lg))
            worst, ok = 0.0, True
            for cpu, card_out in pairs:
                g = card_out.cpu()
                worst = max(worst, float((g - cpu).abs().max()))
                ok &= bool(torch.isclose(g, cpu, **tol).all())
            rec["cpu_vs_card"].append(dict(arch=arch, max_abs_err=worst,
                                           ok=ok))
            print(f"[lm] card vs CPU {arch} (reduced, float32): prefill of "
                  f"{LM_CPU_PROMPT} tokens + {LM_CPU_STEPS} decode steps, "
                  f"max|err| {worst:.3e} "
                  f"({'ok' if ok else 'FAIL'} at rtol=atol={tol['rtol']:.0e})",
                  flush=True)
            if not ok:
                raise PhaseError(f"{arch}: card logits differ from the CPU's")

        # -- (2) consistency at full width, float32 ----------------------------
        f32 = DTypePolicy("float32", "float32", "float32")
        stol = tolerance_for(torch.float32, scale=LM_SELF_SCALE)
        for arch, _, depth in LM_CONFIGS:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                                      dtype_policy=f32)
            int8 = cfg.cache_dtype == "int8"
            if cfg.moe is not None:  # no capacity drop in the prefill
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=8.0))
            exact = dataclasses.replace(cfg, cache_dtype="bfloat16")
            model = build_model(exact, device=dev)
            params = model.init(LM_SEED)
            B, S = LM_BATCH, LM_PROMPT
            batch = _lm_batch(exact, np.random.default_rng(LM_SEED + 1), B,
                              S, dev)
            toks = batch["tokens"]
            if exact.family == "vlm":  # the decode step takes no image
                ref, kvs = tf.prefill(params, exact, toks)
            else:
                ref, kvs = cells.make_prefill_step(model, sh=sh)(params,
                                                                 batch)
            cache = model.init_cache(B, S + 2)
            if exact.family == "encdec":
                cache = _lm_cross(model, params, batch, cache)
            for i in range(S):
                lg, cache = model.decode(params, toks[:, i], i, cache)
            scale = float(ref.abs().max())
            err = float((lg - ref).abs().max())
            limit = stol["atol"] + stol["rtol"] * scale
            row = dict(arch=arch, layers=depth, batch=B, prompt=S,
                       max_abs_err=err, limit=limit, max_abs_logit=scale)
            ok = err <= limit and bool(torch.isfinite(lg).all())
            nxt = torch.argmax(lg, dim=-1)
            if exact.family in ("dense", "moe", "vlm"):
                filled = cells.cache_from_prefill(
                    model, model.init_cache(B, S + 2), kvs)
                la, _ = model.decode(params, nxt, S, filled)
                lb, _ = model.decode(params, nxt, S, cache)
                row["prefill_cache_err"] = float((la - lb).abs().max())
                ok &= row["prefill_cache_err"] <= (
                    stol["atol"] + stol["rtol"] * float(lb.abs().max()))
            if int8:
                mq = build_model(cfg, device=dev)
                cq = mq.init_cache(B, S + 2)
                for i in range(S):
                    lq, cq = mq.decode(params, toks[:, i], i, cq)
                rng_ = float(ref.max() - ref.min())
                row["int8_max_abs_err"] = float((lq - ref).abs().max())
                row["int8_limit"] = 0.05 * rng_
                picked = lq.argmax(-1)
                row["int8_argmax_same"] = int((picked == ref.argmax(-1))
                                              .sum())
                ties = [_lm_near_tie(ref[b], int(picked[b]),
                                     row["int8_limit"]) for b in range(B)]
                row["int8_gaps"] = [gap for _, gap in ties]
                ok &= (row["int8_max_abs_err"] < row["int8_limit"]
                       and all(tie for tie, _ in ties))
                del mq, cq
            row["seconds"] = time.perf_counter() - t0
            row["ok"] = ok
            rec["consistency"].append(row)
            print(f"[lm] consistency {arch} ({depth} of "
                  f"{get_config(arch).n_layers} layers, float32, {B}x{S}): "
                  f"decode vs prefill_serve max|err| {err:.3e} (limit "
                  f"{limit:.3e})"
                  + (f", prefill-filled cache {row['prefill_cache_err']:.3e}"
                     if "prefill_cache_err" in row else "")
                  + (f", int8 cache {row['int8_max_abs_err']:.3e} (limit "
                     f"{row['int8_limit']:.3e}, argmax same "
                     f"{row['int8_argmax_same']} of {B})" if int8 else "")
                  + f"; {row['seconds']:.1f} s", flush=True)
            del model, params, cache, kvs, batch
            _lm_free()
            if not ok:
                raise PhaseError(f"{arch}: decode disagrees with prefill at "
                                 f"full width: {row}")

        # -- (3) serving in each config's bf16 policy --------------------------
        for arch, depth, _ in LM_CONFIGS:
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            cfg = dataclasses.replace(get_config(arch), n_layers=depth)
            model = build_model(cfg, device=dev)
            params = model.init(LM_SEED)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            peak_init = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            weights_gib = _lm_numel(params) * 2 / 2**30
            rng = np.random.default_rng(LM_SEED + 2)
            batch = _lm_batch(cfg, rng, LM_BATCH, LM_PROMPT, dev)
            toks = batch["tokens"]
            prefill = cells.make_prefill_step(model, sh=sh)
            n_pos = LM_PROMPT + (cfg.img_tokens if cfg.family == "vlm" else 0)
            prefill_s = []
            for _ in range(2):  # the first call includes cuBLAS set-up
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                logits, kvs = prefill(params, batch)
                torch.cuda.synchronize()
                prefill_s.append(time.perf_counter() - t1)
            finite = torch.isfinite(logits).all()
            # the decode cache: from the prefill's K/V, or rebuilt through
            # the decode step (recurrent and encoder-decoder families)
            max_seq = n_pos + LM_NEW + 1
            cache = model.init_cache(LM_BATCH, max_seq)
            checked = {"finite": torch.ones((), dtype=torch.bool,
                                            device=dev)}

            def decode(p, token, pos, c, sh_=sh, _m=model, _ok=checked):
                lg, c = _m.decode(p, token, pos, c, sh_)
                _ok["finite"] &= torch.isfinite(lg).all()
                _ok["last"] = lg
                return lg, c

            serve = cells.make_serve_step(
                dataclasses.replace(model, decode=decode), sh=sh)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rebuilt_s = None
            if cfg.family in ("dense", "moe", "vlm"):
                cache = cells.cache_from_prefill(model, cache, kvs)
                token = torch.argmax(logits, dim=-1).to(torch.int32)
                first = logits
            else:
                if cfg.family == "encdec":
                    cache = dict(cache, xk=kvs[0], xv=kvs[1])
                for i in range(LM_PROMPT):
                    token, cache = serve(params, cache, toks[:, i], i)
                torch.cuda.synchronize()
                rebuilt_s = time.perf_counter() - t1
                first = checked["last"]
            rebuilt_token = token
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out, chose = [token], [first[0]]  # the logits behind each token
            for j in range(LM_NEW):
                token, cache = serve(params, cache, token, n_pos + j)
                out.append(token)
                chose.append(checked["last"][0])
            enqueue_b4 = (time.perf_counter() - t1) / LM_NEW
            torch.cuda.synchronize()
            decode_b4 = (time.perf_counter() - t1) / LM_NEW
            gen = torch.stack(out, dim=1)
            del cache, kvs
            prompt1 = [int(t) for t in toks[0].tolist()]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            g1 = cells.greedy_generate(arch=cfg, prompt_tokens=prompt1,
                                       max_new_tokens=LM_NEW, params=params,
                                       device=dev)
            greedy_s = time.perf_counter() - t1
            peak_serving = torch.cuda.max_memory_allocated() / 2**30

            # -- the bf16 cross-checks, untimed.  The MoE decode step is
            # dropless and the prefill drops what overflows capacity_factor,
            # so an MoE config is held to a prefill at capacity_factor 8.0
            # (none dropped), as the float32 check above and the CPU tests
            # do; how far the drops move the prefill's logits is recorded.
            bf16_tol = tolerance_for(torch.bfloat16, scale=LM_BF16_SCALE)
            drop_effect = None
            ref_logits = logits
            if cfg.moe is not None:
                check = build_model(dataclasses.replace(
                    cfg, moe=dataclasses.replace(cfg.moe,
                                                 capacity_factor=8.0)),
                    device=dev)
                ref_logits, ref_kvs = cells.make_prefill_step(check, sh=sh)(
                    params, batch)
                drop_effect = float((ref_logits.float() - logits.float())
                                    .abs().max())
                if cfg.family == "moe":  # its batched tokens, none dropped
                    cache = cells.cache_from_prefill(
                        check, check.init_cache(LM_BATCH, max_seq), ref_kvs)
                    token = torch.argmax(ref_logits, -1).to(torch.int32)
                    out, chose = [token], [ref_logits[0]]
                    for j in range(LM_NEW):
                        token, cache = serve(params, cache, token, n_pos + j)
                        out.append(token)
                        chose.append(checked["last"][0])
                    gen = torch.stack(out, dim=1)
                    del cache
                del ref_kvs
            ok = bool(finite) and bool(checked["finite"])
            in_vocab = bool(((gen >= 0) & (gen < cfg.vocab)).all())
            in_vocab &= all(0 <= t < cfg.vocab for t in g1)
            ok &= in_vocab and len(g1) == LM_PROMPT + LM_NEW
            rebuild = None
            if rebuilt_s is not None:
                # the rebuilt state's last logits against the prefill's
                pre, reb = ref_logits.float(), first.float()
                limit = _lm_limit(pre, bf16_tol)
                ties = [_lm_near_tie(pre[b], int(rebuilt_token[b]), limit)
                        for b in range(LM_BATCH)]
                rebuild = dict(
                    seconds=rebuilt_s,
                    max_abs_err=float((reb - pre).abs().max()), limit=limit,
                    argmax_same=int((rebuilt_token == pre.argmax(-1)).sum()),
                    gaps=[gap for _, gap in ties])
                rebuild["logits_gated"] = cfg.moe is None
                rebuild["ok"] = ((rebuild["max_abs_err"] <= limit
                                  or cfg.moe is not None)
                                 and all(tie for tie, _ in ties))
                ok &= rebuild["ok"]
            # greedy_generate against the batched serving's first request, up
            # to their first differing token (the VLM's greedy_generate takes
            # no image, so its tokens are not the batched ones')
            greedy = None
            if cfg.family != "vlm":
                batched = [int(t) for t in gen[0, :LM_NEW].tolist()]
                diff = [j for j in range(LM_NEW)
                        if g1[LM_PROMPT + j] != batched[j]]
                greedy = dict(first_difference=diff[0] if diff else None,
                              ok=True)
                if diff:
                    j = diff[0]
                    row_j = chose[j].float()
                    limit = _lm_limit(row_j, bf16_tol)
                    tie, gap = _lm_near_tie(row_j, g1[LM_PROMPT + j], limit)
                    greedy.update(gap=gap, limit=limit, ok=tie)
                ok &= greedy["ok"]
            del logits, first, checked, chose, ref_logits
            row = dict(
                arch=arch, family=cfg.family, layers=depth,
                published_layers=get_config(arch).n_layers,
                cut=depth != get_config(arch).n_layers,
                weights_gib=weights_gib, batch=LM_BATCH, prompt=LM_PROMPT,
                positions=n_pos, new_tokens=LM_NEW, init_s=init_s,
                prefill_s=prefill_s,
                prefill_tokens_per_s=LM_BATCH * n_pos / prefill_s[1],
                state_rebuild=rebuild,
                decode_ms_b4=decode_b4 * 1e3,
                decode_enqueue_ms_b4=enqueue_b4 * 1e3,
                decode_tokens_per_s_b4=LM_BATCH / decode_b4,
                greedy_s=greedy_s,
                decode_ms_b1=greedy_s / (LM_PROMPT + LM_NEW) * 1e3,
                greedy_vs_batched=greedy,
                capacity_drop_max_abs=drop_effect,
                peak_gib=peak_serving, peak_init_gib=peak_init,
                seconds=time.perf_counter() - t0, ok=ok, card=card)
            rec["serving"].append(row)
            print(f"[lm] serve {arch} ({depth} of {row['published_layers']} "
                  f"layers, {cfg.dtype_policy.params}, {weights_gib:.1f} GiB "
                  f"weights): prefill {LM_BATCH}x{n_pos} "
                  f"{row['prefill_tokens_per_s']:.0f} tokens/s "
                  f"({prefill_s[1] * 1e3:.2f} ms; first call "
                  f"{prefill_s[0] * 1e3:.1f} ms)"
                  + (f", state rebuilt through decode in "
                     f"{rebuild['seconds']:.2f} s (last logits vs prefill "
                     f"max|err| {rebuild['max_abs_err']:.3e}, limit "
                     f"{rebuild['limit']:.3e}"
                     f"{'' if rebuild['logits_gated'] else ' (not gated: MoE)'}"
                     f"; argmax same "
                     f"{rebuild['argmax_same']} of {LM_BATCH}, gaps "
                     f"{', '.join(f'{g:.3e}' for g in rebuild['gaps'])})"
                     if rebuild is not None else "")
                  + (f"; capacity drops move the prefill's logits by "
                     f"{drop_effect:.3e}" if drop_effect is not None else "")
                  + f"; decode {row['decode_ms_b4']:.2f} ms/step at batch "
                  f"{LM_BATCH} (host enqueue {row['decode_enqueue_ms_b4']:.2f}"
                  f"), {row['decode_ms_b1']:.2f} ms/step at batch 1 "
                  f"(greedy_generate, {LM_PROMPT}+{LM_NEW} steps"
                  + ("" if greedy is None else
                     ", its tokens the batched ones'" if greedy[
                         "first_difference"] is None else
                     f", first differs from the batched at new token "
                     f"{greedy['first_difference']}: gap {greedy['gap']:.3e}"
                     f", limit {greedy['limit']:.3e}")
                  + f"); peak {row['peak_gib']:.1f} GiB serving, "
                  f"{peak_init:.1f} GiB at init; {row['seconds']:.1f} s "
                  f"[{card}]", flush=True)
            del model, params, batch, toks, gen
            _lm_free()
            if not ok:
                raise PhaseError(f"{arch}: serving gate failed: {row}")

    def run_inference():
        with torch.inference_mode():
            run()

    _, launches = counts_of(run_inference)
    if any(launches.values()):
        raise PhaseError(f"the LM path launched kernels: {launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[lm] phase 4n: {rec['seconds']:.1f} s; kernel launches "
          f"{sum(launches.values())}", flush=True)
    return rec


# LM training (phase 4o): the LM substrate's training path
# (repro_torch.optim, repro_torch.data, repro_torch.launch.cells'
# make_train_step, repro_torch.launch.train's train_loop).  No kernel of
# the nine is on it: 0 launches asserted.
#
# (a) Card against CPU: the ten reduced configs in float32 (TF32 off) at
# B=2, S=64 (RWKV's chunked WKV), the same weights and step-keyed batch:
# loss, every gradient leaf, and the params and optimizer state after one
# make_train_step with accum=2, each leaf norm-wise within
# tolerance_for(float32, 10) of the CPU's (the CPU tests' gradient
# tolerance, tests/test_torch_lm_train.py); then one update of each
# optimizer on the CPU's grads, the same tolerance, adamw8bit's int8 codes
# equal or one apart at a rounding tie (the value before rounding within
# LM_TIE of a half-integer, on the CPU), ties counted.
# (b) smollm-135m at its published widths and depth (30 layers, d_model
# 576, vocab 49152), bf16, remat 'full', at train_4k's sequence of 4096:
# global batch 8 (train_4k's 256 cut to 8: one card, and the phase's time),
# accum 2, 10 steps of train_loop; then the learning gate.
# (c) remat 'full', 'dots' and 'none' at seq 512, batch 4 on the same
# smollm: loss and grads within tolerance_for(bfloat16) norm-wise, peaks
# full < none and dots <= none.
# (d) exact resume, bit for bit: reduced smollm in float32, 4 straight
# steps against 2, a checkpoint, a restore and 2 more, in a fresh process
# with CUBLAS_WORKSPACE_CONFIG=:4096:8 set before CUDA starts and
# torch.use_deterministic_algorithms(True) (the embedding's backward
# scatters with atomics otherwise).
# (e) The other configs the card can hold, at their widths and train_4k's
# sequence (whisper: 448 tokens and 1500 frames; llava: 4096 - 576 = 3520
# text tokens after its 576 patches), 3 steps of train_loop each with the
# config's own optimizer and remat.  Depth is cut by
#   params(depth) x (2 weights + 2 grads + optimizer bytes: adamw 8,
#   adafactor ~0, adamw8bit 2) + accumulation buffer (params x 4 in
#   float32, x 2 in bf16) + activations <= 70 GiB,
# params counted on the config's tree at the cut depth, embeddings included:
#   whisper-base full (6 + 6): 0.087 B x 12 = 1.0 GiB, accum 1;
#   llava-next-mistral-7b 2 of 32: 0.698 B x 12 = 7.8 GiB + 2.6 GiB;
#   rwkv6-7b 2 of 32: 0.977 B x 12 = 10.9 GiB + 3.6 GiB;
#   phi3.5-moe 2 of 32: 2.863 B x 12 = 32.0 GiB + 10.7 GiB;
#   nemotron-4-340b 1 of 96: 12.891 B x 4 = 48.0 GiB + 24.0 GiB of bf16
#   accumulation = 72 GiB before activations: not trained;
#   jamba-v0.1-52b, one period of 8 layers (its smallest unit): 13.295 B x
#   12 = 148.6 GiB: not trained (waits for LM sharding and more than one
#   card).
# The 7B-class models would fit deeper (llava about 24 of 32 layers by the
# same reckoning); 2 layers keep the phase near its time target, as the
# host-bound steps grow with the layers.  Batch 2, accum 2 where the config
# accumulates (its own 4, 8 or 16 need a batch of that many).
LM_TRAIN_SEQ = 4096  # train_4k's sequence (cells.SHAPES)
LM_TRAIN_BATCH = 8
LM_TRAIN_ACCUM = 2
LM_TRAIN_STEPS = 10
LM_LEARN = dict(steps=30, batch=4, seq=512, lr=1e-3)
LM_REMAT = dict(seq=512, batch=4)
LM_TRAIN_CONFIGS = (  # (arch, layers or None for all, batch, accum)
    ("whisper-base", None, 2, 1),
    ("llava-next-mistral-7b", 2, 2, 2),
    ("rwkv6-7b", 2, 2, 2),
    ("phi3.5-moe-42b-a6.6b", 2, 2, 2),
)
LM_NOT_TRAINED = {
    "nemotron-4-340b": "1 of 96 layers: 12.891 B params x (2 + 2 + 0 "
                       "adafactor) = 48.0 GiB + 24.0 GiB bf16 accumulation "
                       "> 70 GiB before activations",
    "jamba-v0.1-52b": "one period of 8 layers: 13.295 B params x 12 = "
                      "148.6 GiB under adamw; waits for LM sharding and "
                      "more than one card",
}
LM_TRAIN_STEPS_E = 3
LM_TIE = 1e-3
H100_BF16_FLOPS = 989e12  # dense bf16, NVIDIA's H100 SXM data sheet


def _lm_train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x active params x positions,
    plus attention's two block products as the port computes them
    (unmasked; forward and the backward's two: 3 x 4 B H S^2 hd a layer).
    whisper: the encoder's positions (enc_seq frames) and the decoder's
    (``seq`` tokens) apart, with the decoder's cross attention."""
    h, hd = cfg.n_heads, cfg.hd
    if cfg.family == "encdec":
        d, ff = cfg.d_model, cfg.d_ff
        attn = 4 * d * h * hd
        mlp = d * ff * (3 if cfg.gated_mlp else 2)
        n_enc = cfg.enc_layers * (attn + mlp)
        n_dec = cfg.n_layers * (2 * attn + mlp) + cfg.vocab * d
        t_enc = cfg.enc_seq
        return (6 * batch * (n_enc * t_enc + n_dec * seq)
                + 12 * batch * h * hd * (cfg.enc_layers * t_enc**2
                                         + cfg.n_layers * (seq**2
                                                           + seq * t_enc)))
    pos = seq + (cfg.img_tokens if cfg.family == "vlm" else 0)
    n_attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}.get(
        cfg.family, cfg.n_layers)
    return (6 * cfg.active_param_count() * batch * pos
            + 12 * n_attn * batch * h * hd * pos**2)


def _lm_timed_train_loop(**kw):
    """``train_loop(**kw)`` with each step timed: CUDA events around the
    step and the host's enqueue (until the step returned, before the loss
    is read), beside the loop's own host-clock ``dt``.  Returns (metrics,
    [(event ms, enqueue ms)])."""
    import torch

    from repro_torch.launch import train as train_mod

    marks = []
    make = train_mod.make_train_step

    def timed_make(model, **k):
        step = make(model, **k)

        def timed(params, state, batch):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            out = step(params, state, batch)
            e1.record()
            marks.append((e0, e1, (time.perf_counter() - t0) * 1e3))
            return out

        timed.optimizer = step.optimizer
        return timed

    train_mod.make_train_step = timed_make
    try:
        metrics = train_mod.train_loop(**kw)
    finally:
        train_mod.make_train_step = make
    torch.cuda.synchronize()
    return metrics, [(e0.elapsed_time(e1), enq) for e0, e1, enq in marks]


def _lm_train_row(arch, cfg, metrics, marks, *, published_layers, batch,
                  seq, accum, peak, seconds, card):
    """The numbers of one config's run: steady steps (the first one,
    with cuBLAS set-up and the allocator's growth, apart)."""
    steady = slice(1, None) if len(metrics) > 1 else slice(None)
    host_ms = statistics.mean(m["dt"] * 1e3 for m in metrics[steady])
    event_ms = statistics.mean(e for e, _ in marks[steady])
    enqueue_ms = statistics.mean(q for _, q in marks[steady])
    flops = _lm_train_flops(cfg, batch, seq)
    return dict(
        arch=arch, family=cfg.family, layers=cfg.n_layers,
        published_layers=published_layers, batch=batch, seq=seq, accum=accum,
        optimizer=cfg.optimizer, remat=cfg.remat,
        dtype=cfg.dtype_policy.params,
        losses=[m["loss"] for m in metrics],
        first_step_ms=metrics[0]["dt"] * 1e3, ms_host=host_ms,
        ms_events=event_ms, enqueue_ms=enqueue_ms,
        tokens_per_s=batch * seq / (host_ms / 1e3),
        model_flops=flops, flops_share=flops / (event_ms / 1e3)
        / H100_BF16_FLOPS, peak_gib=peak, seconds=seconds, card=card)


def _lm_print_train(row, what):
    print(f"[lm_train] {what}: {row['tokens_per_s']:.0f} tokens/s, "
          f"{row['ms_host']:.1f} ms/step (host clock; CUDA events "
          f"{row['ms_events']:.1f}, host enqueue {row['enqueue_ms']:.1f}; "
          f"first step {row['first_step_ms']:.0f} ms), model FLOP/s "
          f"{row['flops_share'] * 100:.2f}% of 989 TFLOP/s bf16, peak "
          f"{row['peak_gib']:.2f} GiB; losses "
          f"{', '.join(f'{x:.4f}' for x in row['losses'])}; "
          f"{row['seconds']:.1f} s [{row['card']}]", flush=True)


def lm_resume_worker(out_path: str) -> int:
    """Phase 4o (d), run as ``chip_smoke.py --lm-resume OUT``: in a fresh
    process, deterministic algorithms on, reduced smollm-135m in float32,
    4 straight steps against 2, a checkpoint, a restore and 2 more (the
    reference's tests/test_checkpoint.py::TestExactResume).  Writes
    {"bit_for_bit", "leaves", "differing"} to ``out_path``."""
    import shutil

    import torch

    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.configs import get_config
    from repro_torch.data import make_source
    from repro_torch.launch.cells import value_and_grad
    from repro_torch.models.api import build_model
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime.sharding import Shardings
    from repro_torch.util import tree_leaves

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, device=dev)
    opt = get_optimizer("adamw", 1e-3)
    src = make_source(cfg, global_batch=4, seq_len=16, seed=0)

    def step(params, state, i):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in src.get_batch(i).items()}
        _, g = value_and_grad(model, params, batch, Shardings.none())
        return opt.update(g, state, params)

    p0 = model.init(0)
    s0 = opt.init(p0)
    p, s = p0, s0
    for i in range(4):
        p, s = step(p, s, i)
    q, t = p0, s0
    for i in range(2):
        q, t = step(q, t, i)
    ckpt = OUT / "lm_resume_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        save_pytree({"params": q, "opt": t}, str(ckpt), 2)
        restored, _ = restore_pytree({"params": q, "opt": t}, str(ckpt))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    q, t = restored["params"], restored["opt"]
    for i in range(2, 4):
        q, t = step(q, t, i)
    a, b = tree_leaves({"p": p, "s": s}), tree_leaves({"p": q, "s": t})
    differing = [i for i, (x, y) in enumerate(zip(a, b, strict=True))
                 if not torch.equal(x, y)]
    Path(out_path).write_text(json.dumps(dict(
        bit_for_bit=not differing, leaves=len(a), differing=differing)))
    return 0


def lm_train_phase(counts_of) -> dict:
    """Phase 4o: LM training on the card, (a) to (e) as the comment above
    says.  Every gate raises ``PhaseError``; the nine kernels are launched
    0 times (asserted)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, list_archs
    from repro_torch.data import make_source
    from repro_torch.launch import cells
    from repro_torch.models.api import build_model
    from repro_torch.optim import get_optimizer
    from repro_torch.optim import optimizers as optim_mod
    from repro_torch.runtime.sharding import Shardings
    from repro_torch.util import tolerance_for, tree_leaves, tree_map

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise PhaseError("phase 4o needs torch.backends.cuda.matmul."
                         "allow_tf32 False")
    sh = Shardings.none()
    dev = torch.device("cuda")
    card = card_line()
    rec: dict = dict(card=card, cpu_vs_card=[], not_trained=LM_NOT_TRAINED)

    def normwise(got, want, tol):
        """(max|got - want|, its limit atol + rtol max|want|), on the CPU."""
        got, want = got.detach().float().cpu(), want.detach().float().cpu()
        err = float((got - want).abs().max()) if want.numel() else 0.0
        return err, tol["atol"] + tol["rtol"] * (
            float(want.abs().max()) if want.numel() else 0.0)

    def trees_close(got, want, tol, what):
        worst = 0.0
        for i, (x, y) in enumerate(zip(tree_leaves(got), tree_leaves(want),
                                       strict=True)):
            if x.dtype == torch.int8:
                continue
            err, limit = normwise(x, y, tol)
            worst = max(worst, err / limit)
            if not (err <= limit and bool(torch.isfinite(x).all())):
                raise PhaseError(f"{what} leaf {i}: card differs from the "
                                 f"CPU by {err:.3e} (limit {limit:.3e})")
        return worst

    def quantized_inputs(fn):
        """``fn()`` with every ``_quantize`` input recorded, in order."""
        seen = []
        quantize = optim_mod._quantize

        def recording(x):
            seen.append(x.detach().float().cpu())
            return quantize(x)

        optim_mod._quantize = recording
        try:
            out = fn()
        finally:
            optim_mod._quantize = quantize
        return out, seen

    def codes_ties(q_card, q_cpu, x_cpu, s_cpu):
        """Codes equal, or one apart where the CPU's value before rounding
        is within ``LM_TIE`` of a half-integer; returns the ties."""
        d = q_card.cpu().int() - q_cpu.int()
        off = d != 0
        if not off.any():
            return 0
        n = x_cpu.numel()
        xf = torch.nn.functional.pad(x_cpu.reshape(-1), (0, (-n) % 256))
        r = (xf.reshape(-1, 256) / torch.clamp(s_cpu, min=1e-20)).abs()
        near = ((r - r.floor()) - 0.5).abs() < LM_TIE
        if d.abs().max() > 1 or not bool(near[off].all()):
            raise PhaseError("adamw8bit: int8 codes differ away from a "
                             "rounding tie")
        return int(off.sum())

    def run():
        # -- (a) card against CPU, reduced configs, float32 --------------------
        tol = tolerance_for(torch.float32, scale=10)
        ties_total = 0
        for arch in list_archs():
            t0 = time.perf_counter()
            cfg = get_config(arch).reduced()
            host = build_model(cfg, device="cpu").init(LM_SEED)
            batch = make_source(cfg, global_batch=2, seq_len=64,
                                seed=LM_SEED).get_batch(0)
            def on(d):
                model = build_model(cfg, device=d)
                params = tree_map(lambda p: p.to(d), host)
                b = {k: torch.as_tensor(v, device=d)
                     for k, v in batch.items()}
                loss, grads = cells.value_and_grad(model, params, b, sh)
                step = cells.make_train_step(model, sh=sh, accum=2, lr=1e-3)
                stepped = step(params, step.optimizer.init(params), b)
                return dict(params=params, loss=loss, grads=grads,
                            stepped=stepped)

            c, g = on("cpu"), on(dev)
            row = dict(arch=arch, ties=0)
            err, limit = normwise(g["loss"], c["loss"], tol)
            if not err <= limit:
                raise PhaseError(f"{arch}: loss {err:.3e} off the CPU's")
            row["loss_err"] = err
            row["grads_worst_share"] = trees_close(g["grads"], c["grads"],
                                                   tol, f"{arch} grads")
            row["step_worst_share"] = max(
                trees_close(g["stepped"][0], c["stepped"][0], tol,
                            f"{arch} stepped params"),
                trees_close(g["stepped"][1], c["stepped"][1], tol,
                            f"{arch} stepped state"))
            # one update of each optimizer on the CPU's grads
            for name in ("adamw", "adafactor", "adamw8bit"):
                opt = get_optimizer(name, 1e-3)
                s_cpu, s_card = opt.init(c["params"]), opt.init(g["params"])
                (pc, sc), xc = quantized_inputs(lambda: opt.update(
                    c["grads"], s_cpu, c["params"]))
                (pg, sg), _ = quantized_inputs(lambda: opt.update(
                    tree_map(lambda x: x.to(dev), c["grads"]), s_card,
                    g["params"]))
                row[f"{name}_worst_share"] = max(
                    trees_close(pg, pc, tol, f"{arch} {name} params"),
                    trees_close(sg, sc, tol, f"{arch} {name} state"))
                if name == "adamw8bit":
                    # a moment's leaves are each param's (q, s); _quantize
                    # saw each param's m, then its sqrt(v), in that order
                    mc, vc = tree_leaves(sc["m"]), tree_leaves(sc["v"])
                    mg, vg = tree_leaves(sg["m"]), tree_leaves(sg["v"])
                    for j in range(len(mc) // 2):
                        row["ties"] += codes_ties(mg[2 * j], mc[2 * j],
                                                  xc[2 * j], mc[2 * j + 1])
                        row["ties"] += codes_ties(vg[2 * j], vc[2 * j],
                                                  xc[2 * j + 1], vc[2 * j + 1])
            ties_total += row["ties"]
            row["seconds"] = time.perf_counter() - t0
            rec["cpu_vs_card"].append(row)
            print(f"[lm_train] card vs CPU {arch} (reduced, float32, 2x64): "
                  f"loss |err| {row['loss_err']:.3e}; worst leaf err/limit "
                  f"grads {row['grads_worst_share']:.3f}, make_train_step "
                  f"accum 2 {row['step_worst_share']:.3f}, adamw "
                  f"{row['adamw_worst_share']:.3f}, adafactor "
                  f"{row['adafactor_worst_share']:.3f}, adamw8bit "
                  f"{row['adamw8bit_worst_share']:.3f} (int8 codes one apart "
                  f"at a tie: {row['ties']}); {row['seconds']:.1f} s",
                  flush=True)
            del c, g
        rec["adamw8bit_ties"] = ties_total
        print(f"[lm_train] adamw8bit rounding ties over the ten configs: "
              f"{ties_total}", flush=True)
        _lm_free()

        # -- (b) smollm-135m at full width and depth, seq 4096 ------------------
        t0 = time.perf_counter()
        full = get_config("smollm-135m")
        torch.cuda.reset_peak_memory_stats()
        metrics, marks = _lm_timed_train_loop(
            arch=full, steps=LM_TRAIN_STEPS, global_batch=LM_TRAIN_BATCH,
            seq_len=LM_TRAIN_SEQ, accum=LM_TRAIN_ACCUM, log_every=0,
            seed=LM_SEED, device=dev)
        row = _lm_train_row(
            "smollm-135m", full, metrics, marks,
            published_layers=full.n_layers, batch=LM_TRAIN_BATCH,
            seq=LM_TRAIN_SEQ, accum=LM_TRAIN_ACCUM,
            peak=torch.cuda.max_memory_allocated() / 2**30,
            seconds=time.perf_counter() - t0, card=card)
        row["cut"] = (f"global batch {LM_TRAIN_BATCH} of train_4k's 256 "
                      f"(accum {LM_TRAIN_ACCUM}); depth and widths published")
        _lm_print_train(row, f"smollm-135m ({full.n_layers} of "
                        f"{full.n_layers} layers, bf16, remat "
                        f"full, {LM_TRAIN_BATCH}x{LM_TRAIN_SEQ}, accum "
                        f"{LM_TRAIN_ACCUM}, {LM_TRAIN_STEPS} steps of "
                        "train_loop)")
        bound = 3 * math.log(full.vocab)
        if not all(math.isfinite(x) and 0 < x < bound for x in row["losses"]):
            raise PhaseError(f"smollm-135m: a loss outside (0, {bound:.2f}): "
                             f"{row['losses']}")
        rec["smollm"] = row
        _lm_free()

        # the learning gate: a constant-lr adamw on one repeated batch
        t0 = time.perf_counter()
        model = build_model(full, device=dev)
        params = model.init(LM_SEED)
        opt = get_optimizer("adamw", LM_LEARN["lr"])
        state = opt.init(params)
        toks = torch.arange(LM_LEARN["seq"], dtype=torch.int32,
                            device=dev).tile(LM_LEARN["batch"], 1) + 5
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
        losses = []
        for _ in range(LM_LEARN["steps"]):
            loss, g = cells.value_and_grad(model, params, batch, sh)
            params, state = opt.update(g, state, params)
            losses.append(loss)
        losses = [float(x) for x in losses]
        learn = dict(losses=losses, first=losses[0], last=losses[-1],
                     ok=losses[-1] < 0.5 * losses[0],
                     seconds=time.perf_counter() - t0, **LM_LEARN)
        rec["learning"] = learn
        print(f"[lm_train] learning gate smollm-135m (full width, bf16, "
              f"adamw lr {LM_LEARN['lr']} constant, one repeated "
              f"{LM_LEARN['batch']}x{LM_LEARN['seq']} batch): loss "
              f"{learn['first']:.4f} -> {learn['last']:.4f} in "
              f"{LM_LEARN['steps']} steps ({'ok' if learn['ok'] else 'FAIL'}"
              f": below half the first); {learn['seconds']:.1f} s",
              flush=True)
        if not learn["ok"]:
            raise PhaseError(f"smollm-135m did not learn: {losses}")
        del model, params, state, g, opt
        _lm_free()

        # -- (c) remat modes -----------------------------------------------------
        bf16 = tolerance_for(torch.bfloat16)
        host = build_model(full, device=dev).init(LM_SEED + 1)
        b = make_source(full, global_batch=LM_REMAT["batch"],
                        seq_len=LM_REMAT["seq"], seed=LM_SEED).get_batch(0)
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        remat = {}
        base_peak = None
        for mode in ("none", "full", "dots"):
            model = build_model(dataclasses.replace(full, remat=mode),
                                device=dev)
            _lm_free()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss, grads = cells.value_and_grad(model, host, b, sh)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            remat[mode] = dict(loss=loss, grads=grads, peak_gib=peak)
            base_peak = base / 2**30
        def share(x, y):
            err, limit = normwise(x, y, bf16)
            return err / limit

        worst = {m: max(share(x, y) for x, y in zip(
            tree_leaves(remat[m]["grads"]), tree_leaves(remat["none"]["grads"])))
            for m in ("full", "dots")}
        loss_ok = all(share(remat[m]["loss"], remat["none"]["loss"]) <= 1.0
                      for m in ("full", "dots"))
        peaks = {m: remat[m]["peak_gib"] for m in remat}
        rec["remat"] = dict(peaks_gib=peaks, grads_worst_share=worst,
                            losses={m: float(remat[m]["loss"])
                                    for m in remat},
                            resident_gib=base_peak, **LM_REMAT)
        print(f"[lm_train] remat smollm-135m {LM_REMAT['batch']}x"
              f"{LM_REMAT['seq']} bf16: peak above the resident "
              f"{base_peak:.2f} GiB: none {peaks['none']:.3f} GiB, full "
              f"{peaks['full']:.3f}, dots {peaks['dots']:.3f}; grads' worst "
              f"err/limit against none at tolerance_for(bfloat16): full "
              f"{worst['full']:.3f}, dots {worst['dots']:.3f}", flush=True)
        if not (loss_ok and max(worst.values()) <= 1.0):
            raise PhaseError(f"remat changed the loss or grads: {worst}")
        if not (peaks["full"] < peaks["none"]
                and peaks["dots"] <= peaks["none"]):
            raise PhaseError(f"remat peaks out of order: {peaks}")
        del remat, host, model, loss, grads
        _lm_free()

        # -- (d) exact resume in a deterministic process ------------------------
        t0 = time.perf_counter()
        out_json = OUT / "lm_resume.json"
        out_json.unlink(missing_ok=True)
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--lm-resume",
             str(out_json)], env=env, capture_output=True, text=True,
            timeout=600)
        if res.returncode != 0 or not out_json.exists():
            raise PhaseError(f"the resume process failed: {res.stderr[-2000:]}")
        resume = json.loads(out_json.read_text())
        resume["seconds"] = time.perf_counter() - t0
        rec["resume"] = resume
        print(f"[lm_train] exact resume (reduced smollm-135m, float32, "
              f"deterministic algorithms, CUBLAS_WORKSPACE_CONFIG=:4096:8): 4 "
              f"straight steps against 2 + checkpoint + restore + 2: "
              f"{'bit for bit' if resume['bit_for_bit'] else 'DIFFER'} over "
              f"{resume['leaves']} leaves; {resume['seconds']:.1f} s",
              flush=True)
        if not resume["bit_for_bit"]:
            raise PhaseError(f"the resumed run differs: {resume}")

        # -- (e) the other configs the card holds -------------------------------
        rec["configs"] = []
        for arch, layers, B, accum in LM_TRAIN_CONFIGS:
            t0 = time.perf_counter()
            pub = get_config(arch)
            cfg = pub if layers is None else dataclasses.replace(
                pub, n_layers=layers)
            seq = {"encdec": 448, "vlm": LM_TRAIN_SEQ - cfg.img_tokens}.get(
                cfg.family, LM_TRAIN_SEQ)
            torch.cuda.reset_peak_memory_stats()
            metrics, marks = _lm_timed_train_loop(
                arch=cfg, steps=LM_TRAIN_STEPS_E, global_batch=B,
                seq_len=seq, accum=accum, log_every=0, seed=LM_SEED,
                device=dev)
            row = _lm_train_row(
                arch, cfg, metrics, marks, published_layers=pub.n_layers,
                batch=B, seq=seq, accum=accum,
                peak=torch.cuda.max_memory_allocated() / 2**30,
                seconds=time.perf_counter() - t0, card=card)
            rec["configs"].append(row)
            _lm_print_train(
                row, f"{arch} ({cfg.n_layers} of {pub.n_layers} layers, "
                f"{cfg.dtype_policy.params}, {cfg.optimizer}, remat "
                f"{cfg.remat}, {B}x{seq}"
                + (f" + {cfg.enc_seq} frames" if cfg.family == "encdec"
                   else f" after {cfg.img_tokens} patches"
                   if cfg.family == "vlm" else "")
                + f", accum {accum}, {LM_TRAIN_STEPS_E} steps of train_loop)")
            bound = 3 * math.log(cfg.vocab)
            if not all(math.isfinite(x) and 0 < x < bound
                       for x in row["losses"]):
                raise PhaseError(f"{arch}: a loss outside (0, {bound:.2f}): "
                                 f"{row['losses']}")
            _lm_free()
        for arch, why in LM_NOT_TRAINED.items():
            print(f"[lm_train] {arch}: not trained ({why})", flush=True)

    _, launches = counts_of(run)
    if any(launches.values()):
        raise PhaseError(f"the LM training path launched kernels: {launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[lm_train] phase 4o: {rec['seconds']:.1f} s; kernel launches "
          f"{sum(launches.values())}", flush=True)
    return rec


# LM sharding (phase 4p): repro_torch.runtime.sharding, the models on
# DTensors, the sequence-sharded flash decode and make_train_step with
# param_specs, in a one-rank NCCL world (a HashStore; phase 4l's world is
# torn down first) on a (1, 1) data x model mesh.  One card is one rank:
# every redistribution is local and no collective moves data; the
# multi-rank checks run on the CPU's gloo worlds
# (tests/test_torch_sharding_*.py).  What the phase measures is the
# layer's own cost on one rank: the sharded step beside the unsharded one
# at the same shape, each timed over LM_SHARD_TIMED steps after its first
# (one after the other: phi3.5-moe's two copies of params and state do not
# fit together).
#   smollm-135m, published widths and depth, bf16: train step at 4o's
#   shape, batch 8 x 4096 tokens (train_4k's sequence), accum 2; decode of
#   8 tokens at batch 4 at the end of a 32768-position cache (decode_32k's
#   length and layout: the cache over ('model',)), its earlier positions
#   filled with random keys and values from the seed as a prefill would;
#   phi3.5-moe cut to 1 of 32 layers, bf16: train step at batch 2 x 512,
#   accum 2; decode as smollm's at batch 2.  (At 4o's 2 layers the
#   unsharded step takes ~60 GiB and the sharded one ran out of the 80 in
#   an earlier version that copied each product's weight: phi3.5-moe stays
#   at 1 layer and 2 x 512.)
# Gates: sharded against unsharded norm-wise, the loss and every param
# after the step within tolerance_for(bfloat16) (the one-rank sharded
# path runs the same products through other code: the local regions, the
# vocab-parallel cross entropy).  Decode: the same decode in float32 (the
# bf16 weights and cache cast up), sharded against unsharded, within
# tolerance_for(float32, 10) (the flash decode's merge of partial maxima
# and sums against one softmax; a key masked wrongly among the random
# positions would miss by orders more); in bf16 both decodes finite and
# the sharded one's largest distance from the float32 logits at most
# LM_SHARD_BF16_RATIO times the unsharded one's.  (The two bf16 decodes
# round in different places, the sequence-sharded flash decode its
# unnormalised weights and the unsharded decode the softmax, as the
# reference's two paths do; over 30 bf16 layers against a random cache
# each lies about as far from the float32 logits as
# tolerance_for(bfloat16, 2) allows, on either side of it, so the bf16
# gate compares the two distances, which the phase prints.)  0 launches
# of the nine kernels.
LM_SHARD_CONFIGS = (  # (arch, layers or None, batch, seq, decode batch)
    ("smollm-135m", None, 8, 4096, 4),
    ("phi3.5-moe-42b-a6.6b", 1, 2, 512, 2),
)
LM_SHARD_CACHE = 32768  # decode_32k's cache length
LM_SHARD_DECODE = 8  # tokens decoded at the cache's end
LM_SHARD_TIMED = 2
LM_SHARD_BF16_RATIO = 1.5
LM_SHARD_ACCUM = 2


def lm_shard_phase(counts_of) -> dict:
    """Phase 4p (the comment above): every gate raises ``PhaseError``."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import dp_axes_of, make_mesh_for
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import DTypePolicy
    from repro_torch.runtime.sharding import (
        P, Shardings, distribute, infer_param_specs, map_with_path,
        shard_params, spec_placements,
    )
    from repro_torch.util import tolerance_for, tree_leaves, tree_map

    t_phase = time.perf_counter()
    card = card_line()
    tol = tolerance_for(torch.bfloat16)
    f32_tol = tolerance_for(torch.float32, scale=10)
    rec: dict = dict(card=card, configs=[], tolerance=tol,
                     decode_f32_tolerance=f32_tol,
                     decode_bf16_ratio=LM_SHARD_BF16_RATIO)
    launches = {}

    def normwise(got, want, what, tol=tol):
        got, want = got.detach().float().cpu(), want.detach().float().cpu()
        err = float((got - want).abs().max())
        limit = tol["atol"] + tol["rtol"] * float(want.abs().max())
        if not (err <= limit and bool(torch.isfinite(got).all())):
            raise PhaseError(f"{what}: differs by {err:.3e} "
                             f"(limit {limit:.3e})")
        return err / limit

    def whole(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n, out

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh_for()
        n_tok = LM_SHARD_DECODE
        for arch, layers, batch, seq, dec_b in LM_SHARD_CONFIGS:
            t0 = time.perf_counter()
            cfg = get_config(arch)
            if layers is not None:
                cfg = dataclasses.replace(cfg, n_layers=layers)
            model = build_model(cfg, device="cuda")
            sh = Shardings(mesh=mesh, dp_axes=dp_axes_of(mesh))
            specs = infer_param_specs(model.init(LM_SEED), mesh)
            gen = torch.Generator(device="cpu").manual_seed(LM_SEED)
            toks = torch.randint(1, cfg.vocab, (batch, seq + 1),
                                 generator=gen, dtype=torch.int32)
            plain_batch = {"tokens": toks[:, :-1].cuda(),
                           "labels": toks[:, 1:].cuda()}
            dbatch = {k: distribute_tensor(v, mesh, spec_placements(
                P(sh.dp_axes), mesh)) for k, v in plain_batch.items()}
            # donated, as train_loop's step (one copy of params and state)
            plain = cells.make_train_step(model, sh=Shardings.none(),
                                          accum=LM_SHARD_ACCUM, donate=True)
            sharded = cells.make_train_step(model, sh=sh,
                                            accum=LM_SHARD_ACCUM,
                                            param_specs=specs, donate=True)
            # the unsharded step, its params kept on the host, then timed
            p0 = model.init(LM_SEED)
            s0 = plain.optimizer.init(p0)
            (q0, _, m0), got0 = counts_of(lambda: plain(p0, s0, plain_batch))
            loss0 = m0["loss"].detach().cpu()
            host0 = [x.detach().cpu() for x in tree_leaves(q0)]
            ms = {}
            ms["plain"], _ = timed(lambda: plain(q0, s0, plain_batch),
                                   LM_SHARD_TIMED)
            del p0, s0, q0, m0
            torch.cuda.empty_cache()
            p1 = shard_params(model.init(LM_SEED), mesh, specs)
            s1 = sharded.optimizer.init(p1)
            comm = CommDebugMode()
            with comm:
                (q1, _, m1), got1 = counts_of(
                    lambda: sharded(p1, s1, dbatch))
            worst = normwise(whole(m1["loss"]), loss0, f"{arch} loss")
            for i, (a, b) in enumerate(zip(tree_leaves(q1), host0,
                                           strict=True)):
                worst = max(worst, normwise(whole(a), b, f"{arch} param {i}"))
            train_counts = {str(k): v for k, v in
                            comm.get_comm_counts().items()}
            ms["sharded"], _ = timed(lambda: sharded(q1, s1, dbatch),
                                     LM_SHARD_TIMED)
            del q1, s1, p1, m1, host0
            torch.cuda.empty_cache()
            # decode: the cache over ('model',), the batch over dp
            dsh = cells.make_shardings(cfg, mesh, "decode_32k")
            params = model.init(LM_SEED)
            dparams = shard_params(model.init(LM_SEED), mesh, specs)
            # the cache's positions before the decoded ones as a prefill
            # leaves them: random keys and values from the seed
            cgen = torch.Generator(device="cuda").manual_seed(LM_SEED)
            cache = tree_map(lambda x: torch.randn(
                x.shape, generator=cgen, dtype=x.dtype, device=x.device)
                if x.is_floating_point() else x,
                model.init_cache(dec_b, LM_SHARD_CACHE))
            dcache = distribute(tree_map(torch.clone, cache), map_with_path(
                lambda n, x: cells._cache_spec_for(n, x, dsh, mesh), cache),
                mesh)
            # the same decode in float32 (the bf16 weights and cache cast
            # up), unsharded and sharded
            f32 = build_model(dataclasses.replace(
                cfg, dtype_policy=DTypePolicy("float32", "float32",
                                              "float32")), device="cuda")

            def up(x):
                return x.float() if x.is_floating_point() else x

            params32, cache32 = tree_map(up, params), tree_map(up, cache)
            dparams32 = shard_params(tree_map(up, params), mesh, specs)
            dcache32 = distribute(tree_map(up, cache), map_with_path(
                lambda n, x: cells._cache_spec_for(n, x, dsh, mesh), cache),
                mesh)
            dec_ms = {"plain": 0.0, "sharded": 0.0}
            f32_worst, bf16_err = 0.0, {"plain": 0.0, "sharded": 0.0}
            dec_gap = 0.0
            dcomm = CommDebugMode()
            for i in range(n_tok):
                pos = LM_SHARD_CACHE - n_tok + i
                tok = toks[:dec_b, i].cuda()
                dtok = distribute_tensor(tok, mesh, spec_placements(
                    P(dsh.dp_axes), mesh))
                t, (lg0, cache) = timed(
                    lambda: model.decode(params, tok, pos, cache), 1)
                dec_ms["plain"] += t
                with dcomm:
                    t, ((lg1, dcache), got) = timed(lambda: counts_of(
                        lambda: model.decode(dparams, dtok, pos, dcache,
                                             dsh)), 1)
                dec_ms["sharded"] += t
                got1 = {k: got1.get(k, 0) + v for k, v in got.items()}
                lg32, cache32 = f32.decode(params32, tok, pos, cache32)
                dlg32, dcache32 = f32.decode(dparams32, dtok, pos, dcache32,
                                             dsh)
                f32_worst = max(f32_worst, normwise(
                    whole(dlg32), lg32, f"{arch} float32 decode's logits "
                    f"at {pos}", f32_tol))
                for name, lg in (("plain", lg0), ("sharded", whole(lg1))):
                    if not bool(torch.isfinite(lg).all()):
                        raise PhaseError(f"{arch} {name} decode: not finite")
                    bf16_err[name] = max(bf16_err[name], float(
                        (lg.float() - lg32).abs().max()))
                dec_gap = max(dec_gap, float(
                    (whole(lg1).float() - lg0.float()).abs().max()))
            if bf16_err["sharded"] > LM_SHARD_BF16_RATIO * bf16_err["plain"]:
                raise PhaseError(
                    f"{arch} sharded bf16 decode: {bf16_err['sharded']:.3e} "
                    f"from the float32 decode, over {LM_SHARD_BF16_RATIO}x "
                    f"the unsharded one's {bf16_err['plain']:.3e}")
            del f32, params32, cache32, dparams32, dcache32
            for k, v in list(got0.items()) + list(got1.items()):
                launches[k] = launches.get(k, 0) + v
            tokens = batch * seq
            row = dict(
                arch=arch, layers=cfg.n_layers, batch=batch, seq=seq,
                accum=LM_SHARD_ACCUM, dtype=cfg.dtype_policy.params,
                train_worst_share=worst, decode_f32_worst_share=f32_worst,
                decode_bf16_err_plain=bf16_err["plain"],
                decode_bf16_err_sharded=bf16_err["sharded"],
                decode_bf16_gap=dec_gap,
                ms_plain=ms["plain"], ms_sharded=ms["sharded"],
                tokens_per_s_plain=tokens / (ms["plain"] / 1e3),
                tokens_per_s_sharded=tokens / (ms["sharded"] / 1e3),
                decode_tokens=n_tok, decode_batch=dec_b,
                decode_cache=LM_SHARD_CACHE,
                decode_ms_plain=dec_ms["plain"] / n_tok,
                decode_ms_sharded=dec_ms["sharded"] / n_tok,
                train_comm_counts=train_counts,
                decode_comm_counts={str(k): v for k, v in
                                    dcomm.get_comm_counts().items()},
                seconds=time.perf_counter() - t0)
            rec["configs"].append(row)
            print(f"[lm_shard] {arch} ({cfg.n_layers} layers, bf16) on a "
                  f"(1, 1) mesh: train step at {batch}x{seq} accum "
                  f"{LM_SHARD_ACCUM}: sharded {row['ms_sharded']:.1f} ms "
                  f"({row['tokens_per_s_sharded']:.0f} tokens/s) vs "
                  f"unsharded {row['ms_plain']:.1f} ms "
                  f"({row['tokens_per_s_plain']:.0f} tokens/s); decode "
                  f"{row['decode_ms_sharded']:.2f} vs "
                  f"{row['decode_ms_plain']:.2f} ms a token at batch "
                  f"{dec_b} against {LM_SHARD_CACHE} positions; worst "
                  f"share of the limit: train {worst:.3f}, float32 decode "
                  f"{f32_worst:.3f}; bf16 decode from float32's: unsharded "
                  f"{bf16_err['plain']:.3e}, sharded "
                  f"{bf16_err['sharded']:.3e}; collectives "
                  f"{train_counts} / {row['decode_comm_counts']}; "
                  f"{row['seconds']:.1f} s [{card}]", flush=True)
            del params, dparams, cache, dcache, model
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if any(launches.values()):
        raise PhaseError(f"LM sharding launched kernels: {launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[lm_shard] phase 4p: {rec['seconds']:.1f} s; kernel launches "
          f"{sum(launches.values())}", flush=True)
    return rec


# The LM dry-run (phase 4q): python -m repro_torch.launch.dryrun in a
# subprocess (a fake process group of 256 and 512 ranks in one process,
# FakeTensorMode; nothing runs on the card), three cells on both production
# meshes: smollm-135m x {train_4k, decode_32k}, rwkv6-7b x long_500k.  The
# records go to chiprun_out/dryrun/ and their summary on the `dryrun` JSON
# line.  Gates: exit 0, every record `ok` and fitting 80 GiB.
DRYRUN_CELLS = (("smollm-135m", "train_4k"), ("smollm-135m", "decode_32k"),
                ("rwkv6-7b", "long_500k"))


def dryrun_phase() -> dict:
    t0 = time.perf_counter()
    out = OUT / "dryrun"
    if out.exists():
        shutil.rmtree(out)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    records = []
    for arch, shape in DRYRUN_CELLS:
        cell_out = out / f"{arch}_{shape}"
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--both-meshes", "--out", str(cell_out)],
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
        (OUT / f"dryrun_{arch}_{shape}.log").write_text(
            proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise PhaseError(f"dryrun {arch} x {shape} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
        (path,) = cell_out.glob("dryrun_*.json")
        records.extend(json.loads(path.read_text()))
    summary = []
    for r in records:
        if r["status"] != "ok" or not r["memory"]["fits_h100"]:
            raise PhaseError(f"dryrun record {r}")
        summary.append(dict(
            arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
            trace_s=round(r["trace_s"], 2),
            peak_gib=r["memory"]["peak_per_device"] / 2**30,
            flops_per_device=r["hlo_costs"]["flops_per_device"],
            bytes_per_device=r["hlo_costs"]["bytes_per_device"],
            collective_bytes_per_device=r["hlo_costs"][
                "collective_bytes_per_device"],
            dominant=r["roofline"]["dominant"],
            t_compute=r["roofline"]["t_compute"],
            t_memory=r["roofline"]["t_memory"],
            t_collective=r["roofline"]["t_collective"]))
        print(f"[dryrun] {r['arch']} x {r['shape']} @ {r['mesh']}: peak "
              f"{summary[-1]['peak_gib']:.2f} GiB/device, dominant "
              f"{r['roofline']['dominant']}, traced in "
              f"{r['trace_s']:.1f} s", flush=True)
    rec = dict(cells=summary, seconds=time.perf_counter() - t0)
    print(f"[dryrun] phase 4q: {rec['seconds']:.1f} s", flush=True)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.core.cahn_hilliard import (
        CahnHilliardADI, CHConfig, ch_evolve, deep_quench_ic,
    )
    from repro_torch.kernels import _build, ops
    from repro_torch.core.adi import apply_along_x, apply_along_y
    from repro_torch.core.cahn_hilliard import cube_laplacian_point_fn
    from repro_torch.kernels import penta as P
    from repro_torch.kernels.ref import (
        ch_coefficients, laplacian_ref, penta_dense_cyclic,
    )
    from repro_torch.core.weno import (
        AdvectionConfig, WenoAdvection2D, gaussian_blob, solid_body_rotation,
    )
    from repro_torch.kernels.fused_ch import xsweep_rows_per_block
    from repro_torch.kernels import stencil1d_batch as S1
    from repro_torch.kernels import stencil2d as S2
    from repro_torch.kernels import stencil3d as S3
    from repro_torch.kernels.stencil2d import cuda_point_fn
    from repro_torch.launch import stream as S
    from repro_torch.util import ceil_div, tolerance_for

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    record: dict = {}

    # -- 1. card -------------------------------------------------------------
    card = card_line()
    record["card"] = card
    record["versions"] = dict(torch=torch.__version__, cuda=torch.version.cuda,
                              python=sys.version.split()[0])
    print(f"[card] {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build ------------------------------------------------------------
    info = _build.build()
    (OUT / "nvcc_build.log").write_text(info["log"])
    record["build_seconds"] = info["seconds"]
    print(f"[build] {info['seconds']:.1f} s -> {info['dir']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or (
                "spill" in line and "0 bytes spill stores, 0 bytes spill loads"
                not in line):
            print(f"[build]   {line.strip()}")
    smem, sms = _build.device_info(torch.device("cuda"))
    print(f"[build] opt-in shared memory {smem} B per block, {sms} SMs")

    def cols_geometry(M, isz):
        L = P.segment_length(M)
        return dict(M=M, L=L, S=ceil_div(M, L),
                    C=P.cols_per_block(M, isz, smem))

    def rows_geometry(nx, isz, n_rows):
        L = P.segment_length(nx)
        geo = xsweep_rows_per_block(nx, isz, n_rows, smem, sms)
        return dict(nx=nx, L=L, S=ceil_div(nx, L), **geo._asdict())

    def penta_rows_geometry(B, M, dtype, cyclic=True):
        L = P.segment_length(M)
        geo = P.rows_geometry_on(torch.device("cuda"), getattr(torch, dtype),
                                 M, B, cyclic=cyclic)
        return dict(B=B, M=M, L=L, S=ceil_div(M, L), **geo._asdict())

    def penta_mid_geometry(shape, dtype):
        L = P.segment_length(shape[1])
        geo = P.mid_geometry_on(torch.device("cuda"), getattr(torch, dtype),
                                *shape)
        return dict(shape=shape, L=L, S=ceil_div(shape[1], L), **geo._asdict())

    seg_geometry = {
        f"penta_rows ({N_MAIN}, {N_MAIN}) float64":
            penta_rows_geometry(N_MAIN, N_MAIN, "float64"),
        f"penta_rows {RAGGED} float64": penta_rows_geometry(*RAGGED, "float64"),
        f"penta_rows ({N_MAIN}, {N_MAIN}) float32":
            penta_rows_geometry(N_MAIN, N_MAIN, "float32"),
        f"penta_rows ({N3 * N3}, {N3}) float64, 3D x-sweep":
            penta_rows_geometry(N3 * N3, N3, "float64"),
        f"penta_rows ({N_MAIN // N_CHUNKS}, {N_MAIN}) float64, a streamed "
        "chunk": penta_rows_geometry(N_MAIN // N_CHUNKS, N_MAIN, "float64"),
        f"penta_rows {LONG_ROWS} float64, long M":
            penta_rows_geometry(*LONG_ROWS, "float64"),
        f"penta_mid ({N3}, {N3}, {N3}) float64":
            penta_mid_geometry((N3,) * 3, "float64"),
        f"penta_mid {RAGGED_3D} float64": penta_mid_geometry(RAGGED_3D,
                                                             "float64"),
        f"penta_mid ({N3}, {N3}, {N3}) float32":
            penta_mid_geometry((N3,) * 3, "float32"),
        f"penta_mid {LONG_MID} float64, long M":
            penta_mid_geometry(LONG_MID, "float64"),
        "penta_cols (1024, 1024) float64": cols_geometry(N_MAIN, 8),
        "penta_cols (1021, 1019) float64": cols_geometry(RAGGED[0], 8),
        "penta_cols (1024, 1024) float32": cols_geometry(N_MAIN, 4),
        f"penta_cols ({N3}, {N3 * N3}) float64, 3D z-sweep":
            cols_geometry(N3, 8),
        f"penta_cols {LONG_M} float64, long M": cols_geometry(LONG_M[0], 8),
        "ch_rhs_xsweep 1024^2 float64": rows_geometry(N_MAIN, 8, N_MAIN),
        "ch_rhs_xsweep 1021x1019 float64": rows_geometry(RAGGED[1], 8,
                                                         RAGGED[0]),
        "ch_rhs_xsweep 1024^2 float32": rows_geometry(N_MAIN, 4, N_MAIN),
        f"ch_rhs_xsweep 1024^2 float64, a streamed chunk of "
        f"{N_MAIN // N_CHUNKS} rows": rows_geometry(N_MAIN, 8,
                                                    N_MAIN // N_CHUNKS),
        f"ch_rhs_xsweep {LONG_ROWS} float64, long rows":
            rows_geometry(LONG_ROWS[1], 8, LONG_ROWS[0]),
        f"ch_rhs_xsweep {LONG_ROWS} float32, long rows":
            rows_geometry(LONG_ROWS[1], 4, LONG_ROWS[0]),
        f"stencil3d ({N3}, {N3}, {N3}) float64, 7-point":
            S3.stencil3d_geometry((N3,) * 3, (1,) * 6, 8, smem, sms)._asdict(),
        f"stencil3d {RAGGED_3D} float64, 7-point":
            S3.stencil3d_geometry(RAGGED_3D, (1,) * 6, 8, smem, sms)._asdict(),
        f"stencil2d ({N_MAIN}, {N_MAIN}) float64, 5x5":
            S2.stencil2d_geometry((N_MAIN, N_MAIN), (2,) * 4, 8, smem,
                                  sms)._asdict(),
        f"stencil1d_batch ({N_MAIN}, {N_MAIN}) float64, _D4 along x":
            S1.stencil1d_batch_geometry(N_MAIN, N_MAIN, (2, 2), False, 8, smem,
                                        sms)._asdict(),
        f"stencil1d_batch ({N_MAIN}, {N_MAIN}) float64, _D4 along y":
            S1.stencil1d_batch_geometry(N_MAIN, N_MAIN, (2, 2), True, 8, smem,
                                        sms)._asdict(),
    }
    record["segment_geometry"] = seg_geometry
    for name, geo in seg_geometry.items():
        print(f"[build] geometry {name}: {geo}")

    # -- 3. kernels against their plain versions -----------------------------
    dev = torch.device("cuda")
    cfg = CHConfig(nx=N_MAIN, ny=N_MAIN, dtype="float64")
    solver = CahnHilliardADI(cfg)
    beta_full = (2.0 / 3.0) * cfg.D * cfg.gamma * cfg.dt / cfg.dx**4
    beta_half = 0.5 * cfg.D * cfg.gamma * cfg.dt / cfg.dx**4
    ch_kw = dict(dt=cfg.dt, D=cfg.D, gamma=cfg.gamma, inv_h2=solver.inv_h2,
                 inv_h4=solver.inv_h4)
    plans = {
        "init_a 5x3": solver.plan_init_a,
        "init_b 3x5": solver.plan_init_b,
        "lap_cube 3x3 fn": solver.plan_lap_cube,
        "bih 5x5": solver.plan_bih,
    }

    def fields(ny, nx, dtype, seeds=(1, 2)):
        return [deep_quench_ic(ny, nx, seed=s, dtype=dtype) for s in seeds]

    def stencil_call(plan, data, out_init=None, bc="periodic"):
        def run(backend):
            return ops.stencil_apply(
                data, plan.coeffs.to(data.dtype), out_init,
                point_fn=plan.point_fn, bc=bc, backend=backend,
                taps=plan.taps, **plan._halo_kwargs(),
            )
        return run

    cases = []  # (kernel, label, dtype, run(backend))
    for dtype, (ny, nx), tag in (("float64", (N_MAIN, N_MAIN), "main"),
                                 ("float64", RAGGED, "ragged"),
                                 ("float32", (N_MAIN, N_MAIN), "f32")):
        cn, cm = fields(ny, nx, dtype)
        rhs = (torch.rand((ny, nx), generator=torch.Generator().manual_seed(3),
                          dtype=torch.float64) * 2 - 1).to(dev, getattr(torch, dtype))
        op = rt.create("hyperdiffusion", (ny, nx), mode="adi", alpha=beta_full,
                       dtype=dtype)
        for name, plan in plans.items():
            if tag != "main" and name == "bih 5x5":
                continue
            cases.append(("stencil2d", f"{name} periodic {tag}", dtype,
                          stencil_call(plan, cn)))
        if tag != "f32":
            init = torch.full_like(cn, 7.0)
            cases.append(("stencil2d", f"init_a 5x3 np+out_init {tag}", dtype,
                          stencil_call(solver.plan_init_a, cn, init, "np")))
            cases.append(("stencil2d", f"lap_cube 3x3 fn np {tag}", dtype,
                          stencil_call(solver.plan_lap_cube, cn, None, "np")))
        cases.append(("penta_rows", f"cyclic rows {tag}", dtype,
                      lambda b, op=op, r=rhs: P.cyclic_penta_solve_factored_rows(
                          op.fac_x, r, backend=b)))
        cases.append(("penta_rows", f"plain-band rows {tag}", dtype,
                      lambda b, op=op, r=rhs: P.penta_solve_factored_rows(
                          op.fac_x.band, r, backend=b)))
        cases.append(("penta_cols", f"cyclic cols {tag}", dtype,
                      lambda b, op=op, r=rhs: P.cyclic_penta_solve_factored(
                          op.fac_y, r, backend=b)))
        cases.append(("penta_cols", f"plain-band cols {tag}", dtype,
                      lambda b, op=op, r=rhs: P.penta_solve_factored(
                          op.fac_y.band, r, backend=b)))
        cases.append(("ch_rhs_xsweep", f"fused {tag}", dtype,
                      lambda b, op=op, cn=cn, cm=cm: ops.ch_rhs_xsweep(
                          cn, cm, op.fac_x, backend=b, **ch_kw)))

    # the batched-1D plans (along x, and along y on the transposed view)
    # and the standalone RHS, at the same 2D shapes
    plans_1d = {"d4": solver.plan_d4_1d, "d2": solver.plan_d2_1d,
                "lap_cube fn": solver.plan_lap_cube_1d}

    def batch_call(plan, data, out_init=None, bc="periodic"):
        def run(backend):
            return ops.stencil_apply_batch1d(
                data, plan.coeffs.to(data.dtype), out_init,
                point_fn=plan.point_fn, bc=bc, backend=backend,
                taps=plan.taps, **plan._halo_kwargs(),
            )
        return run

    k_lap = ch_coefficients(**ch_kw)[2]
    nl_term = {}  # label -> max|k_lap lap(c^3 - c)|, what a dropped term moves
    for dtype, (ny, nx), tag in (("float64", (N_MAIN, N_MAIN), "main"),
                                 ("float64", RAGGED, "ragged"),
                                 ("float32", (N_MAIN, N_MAIN), "f32")):
        cn, cm = fields(ny, nx, dtype)
        init = torch.full_like(cn, 7.0)
        for name, plan in plans_1d.items():
            for axis, data, oi in (("x", cn, init), ("y", cn.T, init.T)):
                for bc in ("periodic", "np"):
                    cases.append((
                        "stencil1d_batch", f"{name} along {axis} {bc} {tag}",
                        dtype, batch_call(plan, data, oi if bc == "np" else None,
                                          bc)))
        cases.append(("ch_rhs", f"rhs {tag}", dtype,
                      lambda b, cn=cn, cm=cm: ops.ch_rhs(cn, cm, backend=b,
                                                         **ch_kw)))
        nl_term[f"rhs {tag}"] = float(
            (k_lap * laplacian_ref(cn**3 - cn, 1.0)).abs().max())

    # the 3D path's kernels: the 7-point Laplacian plan and the plane-layout
    # y-sweep of the LOD diffusion operator, at 256^3, ragged and float32
    h3 = 2.0 * math.pi / N3
    lap3 = rt.create("laplacian", (N3,) * 3, bc="periodic", h=h3)

    def box3(shape, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        u = torch.rand(shape, generator=g, device=dev, dtype=torch.float64)
        return (2.0 * u - 1.0).to(getattr(torch, dtype))

    def stencil3d_call(plan, data, out_init=None, bc="periodic", point_fn=None):
        def run(backend):
            return ops.stencil_apply_3d(
                data, plan.coeffs.to(data.dtype), out_init,
                point_fn=point_fn or plan.point_fn, halos=plan.halos, bc=bc,
                backend=backend, taps=None if point_fn else plan.taps,
            )
        return run

    for dtype, shape, tag in (("float64", (N3,) * 3, "main"),
                              ("float64", RAGGED_3D, "ragged"),
                              ("float32", (N3,) * 3, "f32")):
        u = box3(shape, dtype, 5)
        cases.append(("stencil3d", f"lap 7-pt periodic {tag}", dtype,
                      stencil3d_call(lap3, u)))
        if tag != "f32":
            cases.append(("stencil3d", f"lap 7-pt np+out_init {tag}", dtype,
                          stencil3d_call(lap3, u, torch.full_like(u, 7.0), "np")))
        if tag == "ragged":
            cases.append(("stencil3d", f"lap_cube fn periodic {tag}", dtype,
                          stencil3d_call(lap3, u,
                                         point_fn=cube_laplacian_point_fn)))
        r = LOD["D"] * LOD["dt"] / (2.0 * math.pi / shape[2]) ** 2
        for cyclic in ((True,) if tag == "f32" else (True, False)):
            op3 = rt.create("diffusion", shape, mode="adi", alpha=r,
                            cyclic=cyclic, dtype=dtype)
            solve = (P.cyclic_penta_solve_factored_mid if cyclic
                     else P.penta_solve_factored_mid)
            cases.append(("penta_mid",
                          f"{'cyclic' if cyclic else 'plain-band'} mid {tag}",
                          dtype, lambda b, s=solve, f=op3.fac_y, u=u: s(
                              f, u, backend=b)))
            # the 3D x-sweep: rows of nx, nz * ny of them
            rows_solve = (P.cyclic_penta_solve_factored_rows if cyclic
                          else P.penta_solve_factored_rows)
            cases.append(("penta_rows",
                          f"{'cyclic' if cyclic else 'plain-band'} rows 3D "
                          f"{tag}", dtype,
                          lambda b, s=rows_solve, f=op3.fac_x,
                          u=u.reshape(-1, shape[2]): s(f, u, backend=b)))

    # the WENO5 RHS: the path's inputs (the Gaussian blob of
    # examples/weno_advection.py under solid-body rotation) and a random
    # field with velocities of both signs, some exactly 0
    blob = dict(x0=math.pi + 1.0, y0=math.pi, sigma=0.4)

    def weno_inputs(ny, nx, dtype, kind):
        acfg = AdvectionConfig(nx=nx, ny=ny)
        if kind == "blob":
            u, v = solid_body_rotation(acfg, dtype=dtype)
            return acfg, (gaussian_blob(acfg, dtype=dtype, **blob), u, v)
        g = torch.Generator(device=dev).manual_seed(7)
        q, u, v = (torch.rand((3, ny, nx), generator=g, device=dev,
                              dtype=torch.float64) * 2 - 1).to(getattr(torch, dtype))
        u[::3] = 0.0
        return acfg, (q.contiguous(), (2 * u).contiguous(), (2 * v).contiguous())

    def weno_call(acfg, q, u, v):
        return lambda b: ops.weno_advect(q, u, v, dx=acfg.dx, dy=acfg.dy,
                                         backend=b)

    for dtype, (ny, nx), tag in (("float64", (N_MAIN, N_MAIN), "main"),
                                 ("float64", RAGGED, "ragged"),
                                 ("float32", (N_MAIN, N_MAIN), "f32")):
        for kind in ("blob", "random"):
            acfg, qs = weno_inputs(ny, nx, dtype, kind)
            cases.append(("weno5_advect", f"{kind} {tag}", dtype,
                          weno_call(acfg, *qs)))

    # the column sweep at a long M: no (M, C) tile fits a block, so the
    # kernel runs each column in device memory
    fac_long = P.cyclic_penta_factor(
        *P.hyperdiffusion_diagonals(LONG_M[0], beta_full), device=dev)
    rhs_long = (torch.rand(LONG_M, generator=torch.Generator().manual_seed(4),
                           dtype=torch.float64) * 2 - 1).to(dev)

    def long_cols(b):
        return P.cyclic_penta_solve_factored(fac_long, rhs_long, backend=b)

    cases.append(("penta_cols", f"cyclic cols long M {LONG_M[0]}x{LONG_M[1]}",
                  "float64", long_cols))

    # the row and plane sweeps at a long M: neither a row nor a one-column
    # tile fits a block beside the factors, so each line is solved in
    # device memory
    rhs_long_rows = (torch.rand(LONG_ROWS, generator=torch.Generator()
                                .manual_seed(8), dtype=torch.float64)
                     * 2 - 1).to(dev)
    fac_long_mid = P.cyclic_penta_factor(
        *P.hyperdiffusion_diagonals(LONG_MID[1], beta_full), device=dev)
    rhs_long_mid = (torch.rand(LONG_MID, generator=torch.Generator()
                               .manual_seed(9), dtype=torch.float64)
                    * 2 - 1).to(dev)

    def long_rows(b):
        return P.cyclic_penta_solve_factored_rows(fac_long, rhs_long_rows,
                                                  backend=b)

    def long_mid(b):
        return P.cyclic_penta_solve_factored_mid(fac_long_mid, rhs_long_mid,
                                                 backend=b)

    cases.append(("penta_rows", f"cyclic rows long M {LONG_ROWS[0]}x"
                  f"{LONG_ROWS[1]}", "float64", long_rows))
    cases.append(("penta_rows", f"plain-band rows long M {LONG_ROWS[0]}x"
                  f"{LONG_ROWS[1]}", "float64",
                  lambda b: P.penta_solve_factored_rows(
                      fac_long.band, rhs_long_rows, backend=b)))
    cases.append(("penta_mid", "cyclic mid long M "
                  + "x".join(map(str, LONG_MID)), "float64", long_mid))

    # the fused RHS + x-sweep on rows too long for shared memory in float64
    # (the device-memory route; float32 rows of 40000 still fit a block), at
    # the main path's spacing
    for dtype in ("float64", "float32"):
        cn_l, cm_l = (
            (torch.rand(LONG_ROWS, generator=torch.Generator().manual_seed(s),
                        dtype=torch.float64) - 0.5).to(dev, getattr(torch, dtype))
            for s in (10, 11))
        fac_l = P.cyclic_penta_factor(
            *P.hyperdiffusion_diagonals(LONG_ROWS[1], beta_full, dtype),
            device=dev)
        cases.append(("ch_rhs_xsweep", f"fused long rows {LONG_ROWS[0]}x"
                      f"{LONG_ROWS[1]} {dtype}", dtype,
                      lambda b, cn=cn_l, cm=cm_l, f=fac_l: ops.ch_rhs_xsweep(
                          cn, cm, f, backend=b, **ch_kw)))

    # a user's point function (CUDA source, built at Create into its own
    # copy of the stencil libraries) on each stencil kernel, through the
    # plans at the main paths' shapes, periodic and np with out_init
    user_fn = cuda_point_fn(MIXED_SOURCE)(mixed_point_fn)
    t0 = time.perf_counter()
    user_plans = {
        "stencil2d": ((N_MAIN, N_MAIN), None,
                      dict(left=1, right=0, top=2, bottom=1)),
        "stencil1d_batch": ((N_MAIN, N_MAIN), "batch", dict(left=2, right=1)),
        "stencil3d": ((N3,) * 3, None,
                      dict(front=1, back=0, top=0, bottom=1, left=1, right=1)),
    }
    nwins = set()
    for kernel, (shape, mode, extents) in user_plans.items():
        data_u = box3(shape, "float64", 12)
        init_u = torch.full_like(data_u, 7.0)
        for bc in ("periodic", "np"):
            kw = dict(bc=bc, mode=mode, coeffs=[0.7, -1.3], extents=extents)
            plan_u = rt.create(user_fn, shape, **kw)
            plain_u = rt.create(user_fn, shape, backend="torch", **kw)
            nwins.add(plan_u.num_sten)
            oi = init_u if bc == "np" else None
            cases.append((kernel, f"user fn {bc}", "float64",
                          lambda b, p=plan_u, q=plain_u, d=data_u, o=oi:
                          (p if b == "cuda" else q).apply(d, o)))
    record["user_point_fn_build_seconds"] = time.perf_counter() - t0
    user_builds = [_build.point_fn_build(MIXED_SOURCE, n) for n in sorted(nwins)]
    (OUT / "nvcc_build_point_fn.log").write_text(
        "\n".join(b["log"] for b in user_builds))
    print(f"[build] user point function over {sorted(nwins)} windows: 3 "
          f"libraries each, built at Create in "
          f"{record['user_point_fn_build_seconds']:.1f} s -> "
          f"{[b['dir'] for b in user_builds]}", flush=True)

    # the redesigned 2D and batched-1D kernels at the edges of their
    # geometry, through plans (Create-time taps, or the user's source): ny
    # = 1, nx = 1, halos wider than the extent, both dtypes, periodic and
    # np with and without out_init; the batch stacks along x and along y;
    # each streamed plan bit for bit its monolithic launch (`streamed`)
    streamed = []  # (kernel, label, run(): (streamed, monolithic))

    def edge_plans(kind, extents, bc, dtype, batch, **kw):
        nw = (sum(extents[:2]) + 1) * (1 if batch else sum(extents[2:]) + 1)
        w = torch.linspace(-1.0, 1.0, nw, dtype=torch.float64).numpy().copy()
        w[1::3] = 0.0
        ext = dict(zip(("left", "right", "top", "bottom"), extents))
        mode = "batch" if batch else None
        if kind == "weighted":
            fn, coeffs = (w if batch else w.reshape(ext["top"] + ext["bottom"]
                                                     + 1, -1)), None
            mode = mode or "xy"
        elif kind == "cube":
            fn, coeffs = cube_laplacian_point_fn, w
        else:
            fn, coeffs = user_fn, [0.7, -1.3]
        return [rt.create(fn, (8, 8), bc=bc, mode=mode, coeffs=coeffs,
                          extents=ext, dtype=dtype, backend=b, **kw)
                for b in ("cuda", "torch")]

    def edge_field(shape, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        u = torch.rand(shape, generator=g, device=dev, dtype=torch.float64)
        return (u - 0.5).to(getattr(torch, dtype))

    for dtype in ("float64", "float32"):
        for shape, extents in (((1, 37), (2, 1, 0, 0)), ((29, 1), (0, 0, 1, 2)),
                               ((3, 5), (7, 2, 4, 6)),
                               ((1021, 1019), (2, 2, 2, 2))):
            data_e = edge_field(shape, dtype, 50)
            # a user build a window count: the 110 windows of the wide
            # halos are left to the library's point functions
            kinds = ("weighted", "cube") if shape == (3, 5) else (
                "weighted", "cube", "user")
            for kind in kinds:
                for bc in ("periodic", "np", "np+out_init"):
                    k_plan, p_plan = edge_plans(kind, extents, bc[:2] if
                                                bc != "periodic" else bc,
                                                dtype, False)
                    oi = edge_field(shape, dtype, 51) if bc == "np+out_init" \
                        else None
                    cases.append(("stencil2d", f"{kind} {bc} {shape} {dtype}",
                                  dtype, lambda b, k=k_plan, q=p_plan, d=data_e,
                                  o=oi: (k if b == "cuda" else q).apply(d, o)))
        for shape in ((1, 1), (3, 40000), (65536, 16), (N_MAIN, N_MAIN)):
            data_e = edge_field(shape, dtype, 52)
            for kind in ("weighted", "cube", "user"):
                for bc in ("periodic", "np+out_init"):
                    k_plan, p_plan = edge_plans(kind, (3, 1), bc[:2] if
                                                bc != "periodic" else bc,
                                                dtype, True)
                    oi = edge_field(shape, dtype, 53) if bc != "periodic" \
                        else None
                    for along in (apply_along_x, apply_along_y):
                        cases.append((
                            "stencil1d_batch", f"{kind} {bc} {shape} "
                            f"{along.__name__} {dtype}", dtype,
                            lambda b, k=k_plan, q=p_plan, d=data_e, o=oi,
                            a=along: a(k if b == "cuda" else q, d, o)))
    # streamed windows: row chunks of a ragged 2D field, line chunks of the
    # many short lines and of 1024^2 along y
    for kind in ("weighted", "cube", "user"):
        for batch, shape, extents, along in (
                (False, (1021, 1019), (2, 2, 2, 2), None),
                (True, (65536, 16), (3, 1), apply_along_x),
                (True, (65536, 16), (3, 1), apply_along_y),
                (True, (N_MAIN, N_MAIN), (3, 1), apply_along_y)):
            mono = edge_plans(kind, extents, "np", "float64", batch)[0]
            chunked = edge_plans(kind, extents, "np", "float64", batch,
                                 streams=STREAMS, max_tile_bytes=TILE_BYTES)[0]
            d_s = edge_field(shape, "float64", 54)
            o_s = edge_field(shape, "float64", 55)
            apply = (lambda p, d, o: p.apply(d, o)) if along is None else along
            streamed.append((
                "stencil1d_batch" if batch else "stencil2d",
                f"{kind} {shape} {'' if along is None else along.__name__}",
                lambda a=apply, m=mono, c=chunked, d=d_s, o=o_s:
                (a(c, d, o), a(m, d, o))))
    # the grid-limit shapes: the smallest ny at which the first launchers
    # asked for more than 65535 blocks in grid.y (8-row tiles: 524281;
    # 16 rows: 1048561; 32 rows: 2097121), a narrow nx, float64
    tall = [edge_field((524281, 8), "float64", s) for s in (56, 57)]
    bih_tall = rt.create("biharmonic", tall[0].shape)
    cases.append(("stencil2d", "biharmonic plan 524281x8", "float64",
                  lambda b: ops.stencil_apply(
                      tall[0], bih_tall.coeffs, backend=b, taps=bih_tall.taps,
                      **bih_tall._halo_kwargs())))
    cases.append(("ch_rhs", "rhs 524281x8", "float64",
                  lambda b: ops.ch_rhs(*tall, backend=b, **ch_kw)))
    q_tall = [edge_field((1048561, 8), "float64", s) for s in (58, 59, 60)]
    cases.append(("weno5_advect", "random 1048561x8", "float64",
                  lambda b: ops.weno_advect(*q_tall, dx=0.1, dy=0.1,
                                            backend=b)))
    for shape, halos, route in (((1, 524281, 8), (30, 30, 0, 0, 0, 0),
                                 "direct"),
                                ((1, 2097121, 8), (1,) * 6, "tile")):
        nwin = (halos[0] + halos[1] + 1) * (halos[2] + halos[3] + 1)
        plan3 = rt.create(torch.linspace(0.1, 1.0, nwin, dtype=torch.float64)
                          .reshape(-1, halos[2] + halos[3] + 1, 1).numpy()
                          if route == "direct" else lap3.coeffs.reshape(
                              3, 3, 3).cpu().numpy(), shape, mode="xyz")
        if S3.stencil3d_geometry(shape, halos, 8, smem, sms).route != route:
            raise PhaseError(f"stencil3d {shape} {halos}: not the {route} route")
        u_tall = edge_field(shape, "float64", 61)
        cases.append(("stencil3d", f"{route} route {'x'.join(map(str, shape))}",
                      "float64", lambda b, p=plan3, u=u_tall: ops.stencil_apply_3d(
                          u, p.coeffs, halos=p.halos, backend=b, taps=p.taps)))

    # the standalone RHS at the edges of its staged tile: one row, one
    # column, a tile smaller than its halo, each a periodic box of length
    # 2 pi at its own spacing (as tests/test_torch_kernels_cuda.py); its
    # row chunks bit for bit the monolithic launch.  (At the 1024^2 spacing
    # a 1x1 field's biharmonic, 0 in exact arithmetic, is the rounding of
    # terms of k_bih ~ 2.8e3, which max|plain| does not carry.)
    for dtype in ("float64", "float32"):
        for shape in ((1, 1), (1, 8), (8, 1), (3, 5)):
            cn_e, cm_e = (edge_field(shape, dtype, s) for s in (62, 63))
            h_e = 2.0 * math.pi / shape[1]
            kw_e = dict(ch_kw, inv_h2=h_e**-2, inv_h4=h_e**-4)
            cases.append(("ch_rhs", f"rhs {shape} {dtype}", dtype,
                          lambda b, x=cn_e, y=cm_e, k=kw_e: ops.ch_rhs(
                              x, y, backend=b, **k)))
    cn_s, cm_s = fields(N_MAIN, N_MAIN, "float64")
    streamed.append(("ch_rhs", f"rows in {N_CHUNKS} chunks {N_MAIN}^2",
                     lambda: (S.stream_ch_rhs(cn_s, cm_s, streams=STREAMS,
                                              chunk_rows=N_MAIN // N_CHUNKS,
                                              **ch_kw),
                              ops.ch_rhs(cn_s, cm_s, **ch_kw))))
    # the streamed 3D path's windows: z-slabs of the 3D stencil (tile route:
    # the 7-point plan; direct route: front = back = 13) and plane chunks of
    # the plane sweep, at 256^3 and ragged, each window into one output
    for shape, wins in (((N3,) * 3, [(k, k + N3 // N_CHUNKS)
                                    for k in range(0, N3, N3 // N_CHUNKS)]),
                        (RAGGED_3D, [(0, 1), (1, 7), (7, 30), (30, 61)])):
        u_w = box3(shape, "float64", 64)
        init_w = box3(shape, "float64", 65)
        tag = "x".join(map(str, shape))
        for halos, route in (((1,) * 6, "tile"), ((13, 13, 0, 0, 0, 0),
                                                  "direct")):
            nw = (halos[0] + halos[1] + 1) * (halos[2] + halos[3] + 1) * (
                halos[4] + halos[5] + 1)
            coeffs_w = lap3.coeffs if route == "tile" else torch.linspace(
                -1.0, 1.0, nw, dtype=torch.float64, device=dev)
            taps_w = lap3.taps if route == "tile" else None
            if S3.stencil3d_geometry(shape, halos, 8, smem, sms).route != route:
                raise PhaseError(f"stencil3d {shape} {halos}: not the {route} "
                                 "route")
            for bc in ("periodic", "np"):
                def win3(h=halos, c=coeffs_w, t=taps_w, u=u_w, bc=bc, w=wins,
                         o=init_w):
                    kw = dict(halos=h, bc=bc, taps=t)
                    got = torch.full_like(u, float("nan"))
                    for win in w:
                        S3.stencil3d_cuda(u, c, o, planes=win, out=got, **kw)
                    return got, S3.stencil3d_cuda(u, c, o, **kw)
                streamed.append(("stencil3d", f"{route} z windows {bc} {tag}",
                                 win3))
        fac_w = P.cyclic_penta_factor(*P.diffusion_diagonals(shape[1], 1.7),
                                      device=dev)
        for cyclic in (True, False):
            def winmid(f=fac_w, cyc=cyclic, u=u_w, w=wins):
                wmat = f.w if cyc else None
                got = torch.full_like(u, float("nan"))
                for win in w:
                    P.penta_mid_cuda(f.band, u, wmat, planes=win, out=got)
                return got, P.penta_mid_cuda(f.band, u, wmat)
            streamed.append(("penta_mid", f"{'cyclic' if cyclic else 'plain'}"
                             f" plane windows {tag}", winmid))

    checks, failures = [], []
    for kernel, label, dtype, run in cases:
        got = run("cuda")
        want = run("torch")
        torch.cuda.synchronize()
        tol = tolerance_for(dtype, scale=SCALE[kernel])
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        limit = tol["atol"] + tol["rtol"] * scale
        ok = bool(torch.isfinite(got).all()) and err <= limit
        checks.append(dict(kernel=kernel, label=label, dtype=dtype,
                           max_abs_err=err, limit=limit, max_abs_ref=scale,
                           ok=ok))
        print(f"[check] {'ok ' if ok else 'BAD'} {kernel:14s} {label:32s} "
              f"max|err| {err:.3e} <= {limit:.3e} (max|ref| {scale:.3e})",
              flush=True)
        if not ok:
            failures.append(f"{kernel} {label}")
    for kernel, label, run in streamed:
        got, want = run()
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        checks.append(dict(kernel=kernel, label=f"streamed {label}",
                           dtype="float64", bit_for_bit=same, ok=same,
                           max_abs_err=float((got - want).abs().max())))
        print(f"[check] {'ok ' if same else 'BAD'} {kernel:14s} streamed "
              f"{label}: equal to the monolithic launch bit for bit: {same}",
              flush=True)
        if not same:
            failures.append(f"{kernel} streamed {label}")
    for c in checks:
        if c["kernel"] != "ch_rhs" or c["label"] not in nl_term:
            continue
        moved = nl_term[c["label"]]
        c["dropped_nonlinear_term_moves"] = moved
        print(f"[check] ch_rhs {c['label']}: dropping k_lap lap(c^3 - c) would "
              f"move it by {moved:.3e} > limit {c['limit']:.3e}")
        if not moved > c["limit"]:
            failures.append(f"ch_rhs {c['label']}: limit cannot catch a "
                            "dropped nonlinear term")
    # observation: the standalone RHS against the RHS the fused kernel
    # assembles in shared memory (the identity band: its solve is exact)
    ones, zeros = (torch.full((N_MAIN,), v, dtype=torch.float64, device=dev)
                   for v in (1.0, 0.0))
    identity = P.CyclicPentaFactors(
        P.PentaFactors(zeros, zeros, ones, zeros, zeros),
        torch.zeros((N_MAIN, 4), dtype=torch.float64, device=dev),
        torch.eye(4, dtype=torch.float64, device=dev),
        torch.zeros((N_MAIN, 4), dtype=torch.float64, device=dev))
    rhs_pair = (ops.ch_rhs(cn_s, cm_s, **ch_kw),
                ops.ch_rhs_xsweep(cn_s, cm_s, identity, **ch_kw))
    record["ch_rhs_equals_fused_rhs"] = dict(
        bit_for_bit=bool(torch.equal(*rhs_pair)),
        max_abs_diff=float((rhs_pair[0] - rhs_pair[1]).abs().max()))
    print(f"[check] ch_rhs {N_MAIN}^2 float64 against the fused kernel's RHS "
          f"(ch_rhs_xsweep, identity band): bit for bit "
          f"{record['ch_rhs_equals_fused_rhs']['bit_for_bit']}, max|diff| "
          f"{record['ch_rhs_equals_fused_rhs']['max_abs_diff']:.3e} "
          "(observation)")
    del rhs_pair, identity
    record["checks"] = checks
    if failures:
        (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
        raise PhaseError(f"kernels disagree with their plain versions: {failures}")

    # timings at the main path's shapes (float64)
    cn, cm = fields(N_MAIN, N_MAIN, "float64")
    rhs = deep_quench_ic(N_MAIN, N_MAIN, seed=3)
    N = N_MAIN * N_MAIN
    isz = 8
    n_fac = 9 * N_MAIN * isz  # five factors and the (M, 4) Woodbury matrix
    # the 2D and batched-1D plans sum their Create-time taps: 2 flops a
    # tap a point, less the first product's add
    a = solver.plan_init_a
    bih = solver.plan_bih
    BIH = "stencil2d 5x5 biharmonic"
    ALONG_Y = "stencil1d_batch d4 along y (transposed view)"
    timed = {
        "stencil2d": (stencil_call(a, cn), 2 * N * isz,
                      (2 * len(a.taps.weights) - 1) * N),
        BIH: (stencil_call(bih, cn), 2 * N * isz,
              (2 * len(bih.taps.weights) - 1) * N),
        "penta_rows": (
            lambda b: P.cyclic_penta_solve_factored_rows(
                solver.op_half.fac_x, rhs, backend=b),
            2 * N * isz + n_fac, 17 * N),
        "penta_cols": (
            lambda b: P.cyclic_penta_solve_factored(
                solver.op_full.fac_y, rhs, backend=b),
            2 * N * isz + n_fac, 17 * N),
        "ch_rhs_xsweep": (
            lambda b: ops.ch_rhs_xsweep(cn, cm, solver.op_full.fac_x,
                                        backend=b, **ch_kw),
            3 * N * isz + n_fac, 64 * N),
    }
    # the new kernels at their paths' shapes: the batched-1D _D4 plan along
    # x and the RHS at 1024^2, the 3D Laplacian and the cyclic plane-layout
    # sweep at 256^3; all float64
    N3c = N3**3
    ROWS_3D = f"penta_rows ({N3 * N3}, {N3})"
    r3 = LOD["D"] * LOD["dt"] / h3**2
    u3 = box3((N3,) * 3, "float64", 6)
    op3 = rt.create("diffusion", (N3,) * 3, mode="adi", alpha=r3, cyclic=True)
    d4 = solver.plan_d4_1d
    timed.update({
        "stencil1d_batch": (batch_call(d4, cn), 2 * N * isz,
                            (2 * len(d4.taps.weights) - 1) * N),
        ALONG_Y: (batch_call(d4, cn.T), 2 * N * isz,
                  (2 * len(d4.taps.weights) - 1) * N),
        "ch_rhs": (lambda b: ops.ch_rhs(cn, cm, backend=b, **ch_kw),
                   3 * N * isz, 88 * N),
        "stencil3d": (stencil3d_call(lap3, u3), 2 * N3c * isz,
                      (2 * lap3.num_sten - 1) * N3c),
        "penta_mid": (
            lambda b: P.cyclic_penta_solve_factored_mid(op3.fac_y, u3, backend=b),
            2 * N3c * isz + 9 * N3 * isz, 17 * N3c),
        # the row sweep on the 3D x-sweep's rows, beside its 1024^2 entry
        ROWS_3D: (
            lambda b: P.cyclic_penta_solve_factored_rows(
                op3.fac_x, u3.reshape(-1, N3), backend=b),
            2 * N3c * isz + 9 * N3 * isz, 17 * N3c),
    })
    # the WENO5 RHS on the blob at 1024^2: q, u, v read and the output
    # written; about 170 flops a point on the upwind-only design (two phi of
    # ~71 operations, 12 differences, the products and selects)
    acfg_w, qs_w = weno_inputs(N_MAIN, N_MAIN, "float64", "blob")
    timed["weno5_advect"] = (weno_call(acfg_w, *qs_w), 4 * N * isz, 170 * N)
    timings = {}
    for kernel, (run, nbytes, flops) in timed.items():
        # ms: the kernel's device time (profiler); event_ms: CUDA events
        # around one call, which include the card's wait for the host's
        # enqueue once the kernel is shorter than the wrapper's host time
        event_ms = time_ms(lambda run=run: run("cuda"))
        dev_ms = device_ms(lambda run=run: run("cuda"))
        ms = event_ms if dev_ms is None else dev_ms
        plain_ms = time_ms(lambda run=run: run("torch"), n=5, warmup=1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["float64"] * 1e3
        timings[kernel] = dict(
            ms=ms, event_ms=event_ms, device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, flops=flops, library_ms=None,
        )
    # yardstick for the weighted periodic stencil: circular pad + conv2d
    w_box = a.coeffs.reshape(a.top + a.bottom + 1, a.left + a.right + 1)

    def conv():
        x = torch.nn.functional.pad(
            cn[None, None], (a.left, a.right, a.top, a.bottom), mode="circular")
        return torch.nn.functional.conv2d(x, w_box[None, None])[0, 0]

    # yardstick for the sweeps: a dense LU of the cyclic band, factored
    # outside the timed window; lu_solve(left=False) solves X A^T = rhs,
    # i.e. A x = r for every row r of rhs (row layout).
    def dense_lu(beta, transpose=False):
        A = penta_dense_cyclic(*(torch.as_tensor(d, device=dev) for d in
                                 P.hyperdiffusion_diagonals(N_MAIN, beta)))
        return torch.linalg.lu_factor(A.mT if transpose else A)

    lu_cols = dense_lu(beta_full)
    lu_rows = dense_lu(beta_half, transpose=True)
    # the plane layout: the dense LU of the cyclic y band, broadcast over
    # the z planes (lu_solve broadcasts LU (M, M) against rhs (P, M, N))
    dense3 = penta_dense_cyclic(
        *(torch.as_tensor(d, device=dev) for d in P.diffusion_diagonals(N3, r3)))
    lu_mid = torch.linalg.lu_factor(dense3)
    lu_rows3 = torch.linalg.lu_factor(dense3.mT)
    F = torch.nn.functional
    w_d4 = d4.coeffs.view(1, 1, -1)
    w_lap3 = lap3.coeffs.view(1, 1, 3, 3, 3)
    lib = {
        "penta_cols": lambda: torch.linalg.lu_solve(*lu_cols, rhs),
        "penta_rows": lambda: torch.linalg.lu_solve(*lu_rows, rhs, left=False),
        "penta_mid": lambda: torch.linalg.lu_solve(*lu_mid, u3),
        ROWS_3D: lambda: torch.linalg.lu_solve(*lu_rows3, u3.reshape(-1, N3),
                                               left=False),
        # circular pad + conv1d over the rows as a batch of 1-channel lines
        "stencil1d_batch": lambda: F.conv1d(
            F.pad(cn[:, None, :], (d4.left, d4.right), mode="circular"),
            w_d4)[:, 0],
        # along y: circular pad of the rows and a (5, 1) kernel
        ALONG_Y: lambda: F.conv2d(
            F.pad(cn[None, None], (0, 0, d4.left, d4.right), mode="circular"),
            d4.coeffs.view(1, 1, -1, 1))[0, 0].T,
        BIH: lambda: F.conv2d(
            F.pad(cn[None, None], (bih.left, bih.right, bih.top, bih.bottom),
                  mode="circular"),
            bih.coeffs.view(1, 1, bih.top + bih.bottom + 1, -1))[0, 0],
        "stencil3d": lambda: F.conv3d(
            F.pad(u3[None, None], (1,) * 6, mode="circular"), w_lap3)[0, 0],
    }
    lib_err = {}
    for kernel, fn in lib.items():
        lib_err[kernel] = float((fn() - timed[kernel][0]("cuda")).abs().max())
        timings[kernel]["library_ms"] = time_ms(fn)
    fac_l = P.cyclic_penta_factor(
        *P.hyperdiffusion_diagonals(LONG_ROWS[1], beta_full), device=dev)
    cn_l, cm_l = cn[:LONG_ROWS[0]].repeat(1, 40)[:, :LONG_ROWS[1]].contiguous(), \
        cm[:LONG_ROWS[0]].repeat(1, 40)[:, :LONG_ROWS[1]].contiguous()

    def long_fused(b):
        return ops.ch_rhs_xsweep(cn_l, cm_l, fac_l, backend=b, **ch_kw)

    for name, fn in ((f"penta_cols long M {LONG_M}", long_cols),
                     (f"penta_rows long M {LONG_ROWS}", long_rows),
                     (f"penta_mid long M {LONG_MID}", long_mid),
                     (f"ch_rhs_xsweep long rows {LONG_ROWS}", long_fused)):
        timings[f"{name} (device-memory route)"] = dict(
            ms=time_ms(lambda fn=fn: fn("cuda"), n=5, warmup=1),
            device_ms=device_ms(lambda fn=fn: fn("cuda"), n=5, warmup=1))
    # the step's elementwise glue, c_{n+1} = 2 c_n - c_{n-1} + v, in place
    buf = cm.clone()
    timings["glue"] = dict(ms=time_ms(
        lambda: buf.neg_().add_(cn, alpha=2.0).add_(rhs)))
    conv_err = float((conv() - stencil_call(a, cn)("cuda")).abs().max())
    timings["stencil2d"]["library_ms"] = time_ms(conv)
    record["timings"] = timings
    for kernel, t in timings.items():
        if kernel == "glue":
            print(f"[time] step glue (3 in-place torch ops) {t['ms']:.4f} ms")
            continue
        if "plain_ms" not in t:
            d_ms = t.get("device_ms")
            how = "" if d_ms is None else f", device {d_ms:.4f} ms"
            print(f"[time] {kernel} {t['ms']:.4f} ms (events){how}")
            continue
        lib = "" if t["library_ms"] is None else f" library {t['library_ms']:.4f} ms"
        how = ("device time not in the profiler trace: ms is CUDA events"
               if t["device_ms"] is None else f"events {t['event_ms']:.4f} ms")
        print(f"[time] {kernel:14s} {t['ms']:.4f} ms ({how}; plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']}){lib}")
    print(f"[time] conv2d yardstick agrees with stencil2d to {conv_err:.2e}")
    for kernel, e in lib_err.items():
        print(f"[time] library yardstick agrees with {kernel} to {e:.2e}")
    record["library_max_abs_diff"] = dict(lib_err, stencil2d=conv_err)

    # -- 3s. the stacked stencil2d launch (the serving engine's buckets) -----
    # A (B, ny, nx) stack is one launch; each member must equal its own
    # single-field launch bit for bit (the tile geometry does not depend on
    # B), and the stack its plain version within the stencil tolerance.
    stacked = dict(checks=[], timings={})

    def stack_plan(kind, shape, dtype, bc="periodic"):
        if kind == "5x3":
            return rt.create(solver_init_a_w, shape, bc=bc, dtype=dtype)
        if kind in ("cube", "user"):
            fn, c = ((cube_laplacian_point_fn, solver.plan_lap_cube.coeffs.cpu())
                     if kind == "cube" else (user_fn, [0.7, -1.3]))
            return rt.create(fn, shape, bc=bc, dtype=dtype, coeffs=c,
                             extents=dict(left=1, right=1, top=1, bottom=1))
        return rt.create("biharmonic", shape, bc=bc, dtype=dtype)

    solver_init_a_w = solver.plan_init_a.coeffs.reshape(5, 3).cpu().numpy()
    stack_cases = [(b, (N_MAIN, N_MAIN), k, "float64", "periodic")
                   for b in (1, 3, 32) for k in ("5x3", "5x5")]
    stack_cases += [(64, (64, 64), "5x5", "float64", "periodic"),
                    (5, RAGGED, "5x3", "float64", "periodic"),
                    (5, (N_MAIN, N_MAIN), "5x5", "float32", "periodic"),
                    (5, RAGGED, "5x3", "float64", "np"),
                    (5, RAGGED, "5x3", "float64", "np+out_init"),
                    (3, (N_MAIN, N_MAIN), "5x5", "float32", "np+out_init"),
                    (3, (N_MAIN, N_MAIN), "cube", "float64", "periodic"),
                    (5, RAGGED, "cube", "float32", "np+out_init"),
                    (3, (N_MAIN, N_MAIN), "user", "float64", "periodic"),
                    (5, RAGGED, "user", "float32", "np"),
                    (STACK_MANY, (N_MAIN, N_MAIN), "5x3", "float64", "periodic")]
    for B, shape, kind, dtype, bc in stack_cases:
        plan = stack_plan(kind, shape, dtype, bc[:2] if bc != "periodic" else bc)
        geo = S2.stencil2d_geometry(shape, plan.halo, 4 if dtype == "float32"
                                    else 8, smem, sms, B)
        x = edge_field((B,) + shape, dtype, 70)
        oi = edge_field((B,) + shape, dtype, 71) if bc == "np+out_init" else None
        n0 = _build.LAUNCHES["stencil2d"]
        got = plan.apply_stacked(x, oi)
        one_launch = _build.LAUNCHES["stencil2d"] == n0 + 1
        singles = torch.stack([plan.apply(x[b], None if oi is None else oi[b])
                               for b in range(B)])
        plain = ops.stencil_apply(x, plan.coeffs, oi, backend="torch",
                                  point_fn=plan.point_fn, bc=plan.bc,
                                  **plan._halo_kwargs())
        torch.cuda.synchronize()
        same = bool(torch.equal(got, singles))
        tol = tolerance_for(dtype, scale=SCALE["stencil2d"])
        err = float((got - plain).abs().max())
        limit = tol["atol"] + tol["rtol"] * float(plain.abs().max())
        ok = same and one_launch and err <= limit
        label = f"B={B} {shape[0]}x{shape[1]} {kind} {dtype} {bc}"
        stacked["checks"].append(dict(label=label, grid=geo.grid, route=geo.route,
                                      bit_for_bit_singles=same,
                                      one_launch=one_launch, max_abs_err=err,
                                      limit=limit, ok=ok))
        print(f"[stack] {'ok ' if ok else 'BAD'} {label}: grid {geo.grid} "
              f"blocks ({geo.route}), one launch {one_launch}, bit for bit "
              f"the {B} single launches {same}, kernel vs plain "
              f"{err:.3e} <= {limit:.3e}", flush=True)
        if not ok:
            failures.append(f"stacked stencil2d {label}")
        del x, oi, got, singles, plain
    if not any(c["grid"] > 65535 for c in stacked["checks"]):
        failures.append("no stacked case exceeded 65535 blocks")
    if failures:
        record["stacked_stencil2d"] = stacked
        (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
        raise PhaseError(f"stacked stencil2d failed: {failures}")
    # time: the stacked launch at (32, 1024, 1024) against its bound, the
    # plain version and a batched conv2d; and at (32, 64, 64) against 32
    # single launches (CUDA events around each whole set)
    for B, shape in ((STACK_B, (N_MAIN, N_MAIN)), (STACK_B, (64, 64))):
        plan = stack_plan("5x5", shape, "float64")
        x = edge_field((B,) + shape, "float64", 72)
        n_pts = B * shape[0] * shape[1]
        t_bytes = 2 * n_pts * 8 / HBM_BYTES_PER_S * 1e3
        t_ops = (2 * len(plan.taps.weights) - 1) * n_pts / PEAK_FLOPS["float64"] * 1e3
        members = list(x.unbind(0))
        w5 = plan.coeffs.view(1, 1, 5, 5)
        entry = dict(
            ms=device_ms(lambda: plan.apply_stacked(x)),
            event_ms=time_ms(lambda: plan.apply_stacked(x)),
            singles_event_ms=time_ms(lambda: [plan.apply(m) for m in members]),
            plain_ms=time_ms(lambda: ops.stencil_apply(
                x, plan.coeffs, backend="torch", **plan._halo_kwargs()),
                n=5, warmup=1),
            library_ms=time_ms(lambda: F.conv2d(
                F.pad(x[:, None], (2, 2, 2, 2), mode="circular"), w5)[:, 0]),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        key = f"({B}, {shape[0]}, {shape[1]})"
        stacked["timings"][key] = entry
        dev_txt = ("not in the trace" if entry["ms"] is None
                   else f"{entry['ms']:.4f} ms")
        print(f"[stack] 5x5 biharmonic stack {key} float64: device {dev_txt}, "
              f"events {entry['event_ms']:.4f} ms, {B} single launches "
              f"{entry['singles_event_ms']:.4f} ms (events), bound "
              f"{entry['bound_ms']:.4f} ms by {entry['bound_by']}, plain "
              f"{entry['plain_ms']:.3f} ms, batched conv2d "
              f"{entry['library_ms']:.4f} ms", flush=True)
        del x, members
    record["stacked_stencil2d"] = stacked

    # -- 4. main path --------------------------------------------------------
    c0 = band_limited_quench(N_MAIN, seed=0)
    m0, a0 = float(c0.sum()), float(c0.abs().sum())

    def counts_of(fn):
        _build.reset_launches()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(_build.LAUNCHES)

    def expect(got, want, what):
        """Launch counts: ``want`` names the kernels the run launches; every
        other kernel must not have launched."""
        want = dict(dict.fromkeys(_build.LAUNCHES, 0), **want)
        if got != want:
            raise PhaseError(f"{what}: launches {got}, expected {want}")

    def compare(name, got, want, tol, into):
        """Fail unless ``got`` is finite and within ``tol`` of ``want``
        (norm-wise, as the kernel checks)."""
        err = float((got - want).abs().max())
        limit = tol["atol"] + tol["rtol"] * float(want.abs().max())
        into[name] = dict(max_abs_err=err, limit=limit)
        print(f"[paths] {name}: max|diff| {err:.3e} <= {limit:.3e}")
        if not (bool(torch.isfinite(got).all()) and err <= limit):
            raise PhaseError(f"{name}: differ by {err:.3e} (limit {limit:.3e})")

    def mass_drift(name, c, into):
        """Fail unless the (N_MAIN, N_MAIN) field ``c`` is finite and keeps
        the plain sum of the start field: |sum c - sum c0| / sum|c0|."""
        if tuple(c.shape) != (N_MAIN, N_MAIN) or not bool(torch.isfinite(c).all()):
            raise PhaseError(f"{name}: bad field")
        drift = abs(float(c.sum()) - m0) / a0
        into[f"mass drift {name}"] = drift
        print(f"[paths] {name}: relative mass drift {drift:.3e} "
              f"(|sum c - sum c0| / sum|c0|) <= {MASS_DRIFT_MAX:.0e}")
        if not drift <= MASS_DRIFT_MAX:
            raise PhaseError(f"{name}: mass drift {drift:.3e}")

    _, n_boot = counts_of(lambda: solver.initial_step(c0))
    expect(n_boot, dict(stencil2d=4, penta_cols=1, penta_rows=1,
                        ch_rhs_xsweep=0), "bootstrap")
    _, n_step = counts_of(lambda: solver.step(c0, c0))
    expect(n_step, dict(stencil2d=0, penta_cols=1, penta_rows=0,
                        ch_rhs_xsweep=1), "fused step")

    t0 = time.perf_counter()
    (c_fused, _), main_launches = counts_of(lambda: ch_evolve(solver, c0, N_STEPS))
    main_s = time.perf_counter() - t0
    expect(main_launches, dict(stencil2d=4, penta_cols=1 + N_STEPS, penta_rows=1,
                               ch_rhs_xsweep=N_STEPS), "main path (fused)")
    print(f"[main] fused: bootstrap + {N_STEPS} steps in {main_s:.3f} s, "
          f"launches {main_launches}", flush=True)

    plain = CahnHilliardADI(CHConfig(nx=N_MAIN, ny=N_MAIN, backend="torch"))
    (c_plain, _), n_plain = counts_of(lambda: ch_evolve(plain, c0, N_STEPS))
    expect(n_plain, dict.fromkeys(main_launches, 0), "backend='torch' run")

    stencil = CahnHilliardADI(CHConfig(nx=N_MAIN, ny=N_MAIN, rhs_mode="stencil"))
    (c_sten, _), n_sten = counts_of(lambda: ch_evolve(stencil, c0, N_STEPS))
    expect(n_sten, dict(stencil2d=4 + 2 * N_STEPS, penta_cols=1 + N_STEPS,
                        penta_rows=1 + N_STEPS, ch_rhs_xsweep=0),
           "rhs_mode='stencil' run")

    tol = tolerance_for("float64", scale=SCALE_MAIN)
    main_checks = {}
    compare("fused kernels vs plain", c_fused, c_plain, tol, main_checks)
    compare("stencil vs fused", c_fused, c_sten, tol, main_checks)
    for name, c in (("fused", c_fused), ("stencil", c_sten), ("plain", c_plain)):
        mass_drift(name, c, main_checks)
    record["main"] = dict(launches=main_launches, seconds=main_s, **main_checks)

    # observation: the full-resolution deep quench through the same path
    c_deep = deep_quench_ic(N_MAIN, N_MAIN, seed=0)
    boot = solver.initial_step(c_deep)
    c_end, _ = ch_evolve(solver, c_deep, N_STEPS)
    deep = dict(boot_max_abs=float(boot.abs().max()),
                end_max_abs=float(c_end.abs().nan_to_num(float("inf")).max()),
                end_finite=bool(torch.isfinite(c_end).all()))
    record["main"]["full_resolution_deep_quench"] = deep
    print(f"[main] full-resolution deep quench (not checked): max|c| "
          f"{deep['boot_max_abs']:.3e} after the bootstrap, "
          f"{deep['end_max_abs']:.3e} after {N_STEPS} steps, finite "
          f"{deep['end_finite']}")

    # -- 4b. rhs_mode='batch1d' and the fused-mode RHS -----------------------
    b1d = CahnHilliardADI(CHConfig(nx=N_MAIN, ny=N_MAIN, rhs_mode="batch1d"))
    _, n_boot = counts_of(lambda: b1d.initial_step(c0))
    expect(n_boot, dict(stencil1d_batch=10, penta_cols=1, penta_rows=1),
           "batch1d bootstrap")
    _, n_step = counts_of(lambda: b1d.step(c0, c0))
    expect(n_step, dict(stencil1d_batch=6, penta_cols=1, penta_rows=1),
           "batch1d step")
    t0 = time.perf_counter()
    (c_b1d, _), b1d_launches = counts_of(lambda: ch_evolve(b1d, c0, N_STEPS))
    b1d_s = time.perf_counter() - t0
    expect(b1d_launches, dict(stencil1d_batch=10 + 6 * N_STEPS,
                              penta_cols=1 + N_STEPS, penta_rows=1 + N_STEPS),
           "rhs_mode='batch1d' run")
    print(f"[b1d] batch1d: bootstrap + {N_STEPS} steps in {b1d_s:.3f} s, "
          f"launches {b1d_launches}", flush=True)
    b1d_plain = CahnHilliardADI(CHConfig(nx=N_MAIN, ny=N_MAIN, rhs_mode="batch1d",
                                         backend="torch"))
    (c_b1d_plain, _), n_plain = counts_of(lambda: ch_evolve(b1d_plain, c0, N_STEPS))
    expect(n_plain, {}, "batch1d backend='torch' run")
    b1d_checks = {}
    compare("batch1d kernels vs plain", c_b1d, c_b1d_plain, tol, b1d_checks)
    compare("batch1d vs fused", c_b1d, c_fused, tol, b1d_checks)
    for name, c in (("batch1d", c_b1d), ("batch1d plain", c_b1d_plain)):
        mass_drift(name, c, b1d_checks)

    # CahnHilliardADI.rhs in fused mode: the standalone RHS kernel
    c1 = solver.initial_step(c0)
    rhs_k, rhs_launches = counts_of(lambda: solver.rhs(c1, c0))
    expect(rhs_launches, dict(ch_rhs=1), "fused-mode rhs")
    rhs_tol = tolerance_for("float64", scale=SCALE["ch_rhs"])
    compare("fused-mode rhs kernel vs plain", rhs_k, plain.rhs(c1, c0), rhs_tol,
            b1d_checks)
    compare("fused-mode rhs vs stencil-mode rhs", rhs_k, stencil.rhs(c1, c0),
            rhs_tol, b1d_checks)
    record["batch1d"] = dict(launches=b1d_launches, seconds=b1d_s,
                             rhs_launches=rhs_launches, **b1d_checks)

    # -- 4c. 3D: the LOD diffusion step of examples/diffusion3d_adi.py -------
    x3 = torch.arange(N3, device=dev, dtype=torch.float64) * h3
    s3 = torch.sin(x3)
    c3_0 = s3[:, None, None] * s3[None, :, None] * s3[None, None, :]
    amp0 = float(c3_0.abs().max())
    g = float(1.0 / (1.0 + 4.0 * r3 * math.sin(h3 / 2.0) ** 2) ** 3)
    op3_plain = rt.create("diffusion", (N3,) * 3, mode="adi", alpha=r3,
                          cyclic=True, backend="torch")
    lap3_plain = rt.create("laplacian", (N3,) * 3, bc="periodic", h=h3,
                           backend="torch")
    diag_steps = [k for k in range(1, N_STEPS + 1)
                  if k == 1 or k % max(N_STEPS // 8, 1) == 0]

    def lod_run(op, lap):
        c, worst, rows = c3_0.clone(), 0.0, []
        for k in range(1, N_STEPS + 1):
            c = rt.compute(op, c)
            amp = float(c.abs().max())
            dev_k = abs(amp / (amp0 * g**k) - 1.0)
            worst = max(worst, dev_k)
            if not dev_k <= DECAY_MAX:
                raise PhaseError(f"3D LOD step {k}: |amp/exact - 1| = {dev_k:.3e}")
            if k in diag_steps:
                res = float(((1.0 - 1.0 / g) / LOD["dt"] * c
                             - LOD["D"] * rt.compute(lap, c)).abs().max())
                rows.append((k, amp, amp / (amp0 * g**k), res))
        return c, worst, rows

    t0 = time.perf_counter()
    (c3, worst3, rows3), lod_launches = counts_of(lambda: lod_run(op3, lap3))
    lod_s = time.perf_counter() - t0
    expect(lod_launches, dict(penta_rows=N_STEPS, penta_mid=N_STEPS,
                              penta_cols=N_STEPS, stencil3d=len(diag_steps)),
           "3D LOD run")
    print(f"[3d] LOD diffusion {N3}^3 float64, dt {LOD['dt']}, D {LOD['D']}, "
          f"r {r3:.4f}: {N_STEPS} steps in {lod_s:.3f} s, launches "
          f"{lod_launches}", flush=True)
    print("[3d] step, amp, amp/exact_discrete, lap_residual")
    for k, amp, ratio, res in rows3:
        print(f"[3d] {k:4d} {amp:.6e} {ratio:.15f} {res:.3e}")
    print(f"[3d] max over {N_STEPS} steps of |amp/exact_discrete - 1| = "
          f"{worst3:.3e} <= {DECAY_MAX:.0e}")
    (c3_plain, worst3_plain, _), n_plain = counts_of(
        lambda: lod_run(op3_plain, lap3_plain))
    expect(n_plain, {}, "3D backend='torch' run")
    lod_checks = dict(decay_max_dev=worst3, decay_max_dev_plain=worst3_plain)
    compare("3D kernels vs plain", c3, c3_plain,
            tolerance_for("float64", scale=SCALE_3D), lod_checks)
    record["lod3d"] = dict(launches=lod_launches, seconds=lod_s,
                           diagnostics=rows3, **lod_checks)
    del c3_plain, op3_plain, lap3_plain

    # -- 4d. WENO: the experiment of examples/weno_advection.py --------------
    acfg = AdvectionConfig()  # 512^2, CFL 0.4
    weno = WenoAdvection2D(acfg)
    q0 = gaussian_blob(acfg, **blob)
    u0, v0 = solid_body_rotation(acfg)
    t0 = time.perf_counter()
    (qT, n_rev), weno_launches = counts_of(
        lambda: weno.run(q0, u0, v0, 2 * math.pi))
    weno_s = time.perf_counter() - t0
    expect(weno_launches, dict(weno5_advect=3 * 8043), "WENO revolution")
    if n_rev != 8043:
        raise PhaseError(f"WENO revolution took {n_rev} steps, expected 8043")
    l2 = float(torch.sqrt(torch.mean((qT - q0) ** 2)))
    q_min, q_max = float(qT.min()), float(qT.max())
    l2_dev = abs(l2 / WENO_L2_REF - 1.0)
    print(f"[weno] {acfg.nx}^2 float64, one revolution: {n_rev} RK3 steps in "
          f"{weno_s:.3f} s, launches {weno_launches}", flush=True)
    print(f"[weno] L2 error {l2:.6e} (reference {WENO_L2_REF:.3e}, relative "
          f"{l2_dev:.2e} <= {WENO_L2_RTOL:.0e}); min {q_min:+.3e}, max "
          f"{q_max:.6f}")
    if not (bool(torch.isfinite(qT).all()) and l2_dev <= WENO_L2_RTOL):
        raise PhaseError(f"WENO L2 error {l2:.6e} vs reference {WENO_L2_REF}")
    if not (q_min >= -WENO_BOUND and q_max <= 1.0 + WENO_BOUND):
        raise PhaseError(f"WENO extrema {q_min}, {q_max} out of bounds")
    weno_checks = dict(l2=l2, l2_ref=WENO_L2_REF, l2_rel_dev=l2_dev,
                       min=q_min, max=q_max)
    # kernel against plain: 100 RK3 steps at 1024^2 (99.5 CFL steps, so
    # that ceil gives exactly 100)
    acfg_w = AdvectionConfig(nx=N_MAIN, ny=N_MAIN)
    q1 = gaussian_blob(acfg_w, **blob)
    u1, v1 = solid_body_rotation(acfg_w)
    w_k = WenoAdvection2D(acfg_w)
    w_p = WenoAdvection2D(AdvectionConfig(nx=N_MAIN, ny=N_MAIN, backend="torch"))
    dt_w = w_k.dt_cfl(u1, v1)
    t_w = (N_WENO_CHECK - 0.5) * dt_w
    (q_k, n_k), n_wk = counts_of(lambda: w_k.run(q1, u1, v1, t_w, dt=dt_w))
    expect(n_wk, dict(weno5_advect=3 * N_WENO_CHECK), "WENO 1024^2 run")
    (q_p, n_p), n_wp = counts_of(lambda: w_p.run(q1, u1, v1, t_w, dt=dt_w))
    expect(n_wp, {}, "WENO backend='torch' run")
    if not n_k == n_p == N_WENO_CHECK:
        raise PhaseError(f"WENO 1024^2 runs took {n_k} and {n_p} steps")
    compare("WENO kernels vs plain (1024^2, 100 steps)", q_k, q_p,
            tolerance_for("float64", scale=SCALE_WENO), weno_checks)
    record["weno"] = dict(launches=weno_launches, seconds=weno_s,
                          steps=n_rev, **weno_checks)
    del q_p, w_p

    # -- 4e. streaming: the 1024^2 solver in row and column chunks ------------
    isz8 = 8
    geometry = {
        "rows, halo 2 (fused RHS + x-sweep, 5x5 plans)": S.n_chunks_for(
            N_MAIN, N_MAIN, isz8, halos=(2, 2, 2, 2), max_tile_bytes=TILE_BYTES,
            streams=STREAMS),
        "rows, no halo (x-sweep)": S.n_chunks_for(
            N_MAIN, N_MAIN, isz8, max_tile_bytes=TILE_BYTES, streams=STREAMS),
        "lines, halo 2 (batched-1D _D4)": S.n_chunks_for(
            N_MAIN, N_MAIN, isz8, halos=(0, 0, 2, 2), max_tile_bytes=TILE_BYTES,
            streams=STREAMS),
        "columns (y-sweep)": N_MAIN // S.choose_chunk_cols(
            N_MAIN, N_MAIN, isz8, max_tile_bytes=TILE_BYTES),
    }
    if set(geometry.values()) != {N_CHUNKS}:
        raise PhaseError(f"streaming geometry {geometry}, expected {N_CHUNKS} "
                         "chunks per sweep")
    K = N_CHUNKS
    stream_cfg = dict(nx=N_MAIN, ny=N_MAIN, streams=STREAMS,
                      max_tile_bytes=TILE_BYTES)
    s_fused = CahnHilliardADI(CHConfig(**stream_cfg))
    t0 = time.perf_counter()
    (c_sf, _), sf_launches = counts_of(lambda: ch_evolve(s_fused, c0, N_STEPS))
    sf_s = time.perf_counter() - t0
    expect(sf_launches, dict(stencil2d=4 * K, penta_rows=K,
                             penta_cols=K * (1 + N_STEPS),
                             ch_rhs_xsweep=K * N_STEPS), "streamed fused run")
    s_b1d = CahnHilliardADI(CHConfig(rhs_mode="batch1d", **stream_cfg))
    t0 = time.perf_counter()
    (c_sb, _), sb_launches = counts_of(lambda: ch_evolve(s_b1d, c0, N_STEPS))
    sb_s = time.perf_counter() - t0
    expect(sb_launches, dict(stencil1d_batch=K * (10 + 6 * N_STEPS),
                             penta_rows=K * (1 + N_STEPS),
                             penta_cols=K * (1 + N_STEPS)),
           "streamed batch1d run")
    stream_checks = {}
    for name, got, want in (("fused", c_sf, c_fused), ("batch1d", c_sb, c_b1d)):
        same = bool(torch.equal(got, want))
        stream_checks[f"{name} equal to monolithic"] = same
        print(f"[stream] {name}: streams {STREAMS}, {K} chunks a sweep, "
              f"bootstrap + {N_STEPS} steps equal to the monolithic run bit "
              f"for bit: {same}", flush=True)
        if not same:
            raise PhaseError(f"streamed {name} run differs from the monolithic "
                             f"run by {float((got - want).abs().max()):.3e}")
    print(f"[stream] launches fused {sf_launches}; batch1d {sb_launches}")
    record["stream"] = dict(geometry=geometry, streams=STREAMS,
                            max_tile_bytes=TILE_BYTES, fused_launches=sf_launches,
                            batch1d_launches=sb_launches, fused_seconds=sf_s,
                            batch1d_seconds=sb_s, **stream_checks)

    # -- 4f. 3D streaming: the LOD run in z-slabs, row, plane and column chunks
    geometry3 = {
        "z-slabs (7-point Laplacian plan)": N3 // S.choose_chunk_rows(
            N3, (N3 + 2) ** 2, isz8, top=1, bottom=1,
            max_tile_bytes=TILE_BYTES_3D, streams=STREAMS),
        "rows (x-sweep)": N3 * N3 // S.choose_chunk_rows(
            N3 * N3, N3, isz8, max_tile_bytes=TILE_BYTES_3D, streams=STREAMS),
        "planes (y-sweep)": N3 // S.choose_chunk_rows(
            N3, N3 * N3, isz8, max_tile_bytes=TILE_BYTES_3D, streams=STREAMS),
        "columns (z-sweep)": N3 * N3 // S.choose_chunk_cols(
            N3, N3 * N3, isz8, max_tile_bytes=TILE_BYTES_3D),
    }
    if set(geometry3.values()) != {N_CHUNKS}:
        raise PhaseError(f"3D streaming geometry {geometry3}, expected "
                         f"{N_CHUNKS} chunks each")
    knobs3 = dict(streams=STREAMS, max_tile_bytes=TILE_BYTES_3D)
    op3s = rt.create("diffusion", (N3,) * 3, mode="adi", alpha=r3,
                     cyclic=True, **knobs3)
    lap3s = rt.create("laplacian", (N3,) * 3, bc="periodic", h=h3, **knobs3)
    t0 = time.perf_counter()
    (c3s, worst3s, rows3s), lod_s_launches = counts_of(
        lambda: lod_run(op3s, lap3s))
    lod_ss = time.perf_counter() - t0
    expect(lod_s_launches, dict(penta_rows=K * N_STEPS, penta_mid=K * N_STEPS,
                                penta_cols=K * N_STEPS,
                                stencil3d=K * len(diag_steps)),
           "streamed 3D LOD run")
    same3 = bool(torch.equal(c3s, c3)) and rows3s == rows3
    print(f"[stream3d] LOD {N3}^3 float64, streams {STREAMS}, max_tile_bytes "
          f"{TILE_BYTES_3D}: chunks {geometry3}; {N_STEPS} steps in "
          f"{lod_ss:.3f} s, launches {lod_s_launches}; field and Laplacian "
          f"residuals equal to the monolithic run (4c) bit for bit: {same3}",
          flush=True)
    if not same3:
        raise PhaseError("streamed 3D run differs from the monolithic run by "
                         f"{float((c3s - c3).abs().max()):.3e}")
    record["stream3d"] = dict(geometry=geometry3, streams=STREAMS,
                              max_tile_bytes=TILE_BYTES_3D,
                              launches=lod_s_launches, seconds=lod_ss,
                              decay_max_dev=worst3s, equal_to_monolithic=same3)
    del c3s

    # -- 4g. spectral: backend='fft' through create/compute at full width ----
    # torch.fft on CUDA tensors (cuFFT), as the reference's jnp.fft: no
    # kernel of the port may launch, and nothing may leave the card
    spec_tol = tolerance_for("float64", scale=SCALE_FFT)
    spectral: dict = dict(checks={})
    gen = torch.Generator(device=dev).manual_seed(19)
    x_fft = torch.randn((N_MAIN, N_MAIN), generator=gen, device=dev,
                        dtype=torch.float64)

    def on_card(name, out, like):
        if not (out.is_cuda and out.dtype == like.dtype
                and out.shape == like.shape):
            raise PhaseError(f"{name}: {out.device} {out.dtype} "
                             f"{tuple(out.shape)}, expected the input's")

    bih_fft = rt.create("biharmonic", (N_MAIN, N_MAIN), backend="fft")
    op_fft = rt.create("hyperdiffusion", (N_MAIN, N_MAIN), mode="adi",
                       alpha=beta_full, backend="fft")
    op_penta = rt.create("hyperdiffusion", (N_MAIN, N_MAIN), mode="adi",
                         alpha=beta_full)
    for name, fft_plan, direct in (
            ("biharmonic plan", bih_fft, solver.plan_bih),
            ("hyperdiffusion operator", op_fft, op_penta)):
        got, n_fft = counts_of(lambda p=fft_plan: rt.compute(p, x_fft))
        expect(n_fft, {}, f"fft {name}")
        on_card(f"fft {name}", got, x_fft)
        compare(f"fft {name} vs the kernels ({N_MAIN}^2)", got,
                rt.compute(direct, x_fft), spec_tol, spectral["checks"])
    # the x-sweep's residual: the cyclic band I + beta delta_x^4 applied to
    # its solution gives back the right-hand side
    w_x = op_fft.solve_x(x_fft)
    band_w = w_x + beta_full * (
        w_x.roll(2, 1) - 4.0 * w_x.roll(1, 1) + 6.0 * w_x
        - 4.0 * w_x.roll(-1, 1) + w_x.roll(-2, 1))
    compare(f"fft x-sweep residual A w vs rhs (beta {beta_full:.1f})", band_w,
            x_fft, spec_tol, spectral["checks"])
    del x_fft, w_x, band_w

    # Cahn-Hilliard: the stencil-mode solver with spectral implicit sweeps
    ch_fft = CahnHilliardADI(CHConfig(nx=N_MAIN, ny=N_MAIN, rhs_mode="stencil"))
    ch_fft.op_full = dataclasses.replace(ch_fft.op_full, backend="fft")
    ch_fft.op_half = dataclasses.replace(ch_fft.op_half, backend="fft")
    t0 = time.perf_counter()
    (c_fft, _), ch_fft_launches = counts_of(lambda: ch_evolve(ch_fft, c0, N_STEPS))
    ch_fft_s = time.perf_counter() - t0
    expect(ch_fft_launches, dict(stencil2d=4 + 2 * N_STEPS),
           "rhs_mode='stencil' run with fft sweeps")
    on_card("fft CH run", c_fft, c0)
    compare("CH fft sweeps vs penta sweeps (stencil mode)", c_fft, c_sten,
            tolerance_for("float64", scale=SCALE_CH_FFT), spectral["checks"])
    mass_drift("stencil, fft sweeps", c_fft, spectral["checks"])
    mean_drift = abs(float(c_fft.mean()) - float(c0.mean()))
    spectral["checks"]["CH mean drift"] = mean_drift
    print(f"[spectral] CH fft run: bootstrap + {N_STEPS} steps in "
          f"{ch_fft_s:.3f} s, launches {ch_fft_launches}; |mean c - mean c0| "
          f"{mean_drift:.3e} <= {FFT_MEAN_DRIFT_MAX:.0e}", flush=True)
    if not mean_drift <= FFT_MEAN_DRIFT_MAX:
        raise PhaseError(f"CH fft run: mean drift {mean_drift:.3e}")

    # 3D: the LOD step of examples/torch_diffusion3d_adi.py --backend fft
    op3f = rt.create("diffusion", (N3,) * 3, mode="adi", alpha=r3,
                     cyclic=True, backend="fft")
    lap3f = rt.create("laplacian", (N3,) * 3, bc="periodic", h=h3,
                      backend="fft")
    t0 = time.perf_counter()
    (c3f, worst3f, rows3f), lod_fft_launches = counts_of(
        lambda: lod_run(op3f, lap3f))
    lod_fft_s = time.perf_counter() - t0
    expect(lod_fft_launches, {}, "3D LOD run with fft sweeps and Laplacian")
    on_card("fft 3D run", c3f, c3_0)
    print(f"[spectral] 3D LOD {N3}^3 float64 on fft: {N_STEPS} steps in "
          f"{lod_fft_s:.3f} s, launches {lod_fft_launches}; max |amp/exact "
          f"- 1| {worst3f:.3e} <= {DECAY_MAX:.0e}", flush=True)
    for k, amp, ratio, res in rows3f:
        print(f"[spectral] 3d {k:4d} {amp:.6e} {ratio:.15f} {res:.3e}")
    compare("3D fft vs penta", c3f, c3, tolerance_for("float64", scale=SCALE_3D),
            spectral["checks"])
    spectral.update(
        ch=dict(launches=ch_fft_launches, seconds=ch_fft_s),
        lod3d=dict(launches=lod_fft_launches, seconds=lod_fft_s,
                   decay_max_dev=worst3f, diagnostics=rows3f),
    )
    del c3f

    # -- 4h. the example scripts, at their default arguments -----------------
    spectral["examples"] = run_examples()

    # -- 4i. serving: the engine on the card ---------------------------------
    serve = serve_phase(counts_of, expect,
                        torch.device("cuda", torch.cuda.current_device()))
    record["serve"] = serve

    # -- 4j. the self-healing long run ---------------------------------------
    resilient = resilient_phase(solver, c0, counts_of)
    record["resilient"] = resilient

    # -- 4k. tuning and lint ---------------------------------------------------
    tuning = tuning_phase(dict(
        beta_full=beta_full, r3=r3, h3=h3, plan_bih=solver.plan_bih,
        op_full=solver.op_full, op3=op3, lap3=lap3, u3=u3, c0=c0,
        s_fused=s_fused, c_sf=c_sf, compare=compare), counts_of)
    record["tune"] = tuning

    # -- 4l. distribution: a one-rank NCCL world ------------------------------
    dist_rec = dist_phase(dict(compare=compare, solver=solver, c0=c0,
                               c_fused=c_fused, m0=m0, a0=a0), counts_of)
    record["dist"] = dist_rec

    # -- 4m. the audit gate on the card ---------------------------------------
    audit_rec = audit_phase(counts_of)
    record["audit"] = audit_rec

    # -- 5. timing -----------------------------------------------------------
    def per_step(run, carry, steps):
        """ms/step of ``carry = run(carry)`` (one call does ``steps`` steps):
        host clock to the synchronize, CUDA events, host enqueue time."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        carry = run(carry)
        end.record()
        t_enqueued = time.perf_counter()
        torch.cuda.synchronize()
        out = dict(host=(time.perf_counter() - t0) * 1e3 / steps,
                   events=start.elapsed_time(end) / steps,
                   host_enqueue=(t_enqueued - t0) * 1e3 / steps, steps=steps)
        return carry, out

    def pair_of(s):
        return s.make_evolve(N_STEPS)(s.initial_step(c0), c0.clone())

    step_times = {}
    for name, s_, steps in (("fused", solver, N_TIMED),
                            ("stencil", stencil, N_TIMED_B1D),
                            ("stencil fft", ch_fft, N_TIMED_B1D),
                            ("batch1d", b1d, N_TIMED_B1D),
                            ("fused streamed", s_fused, N_TIMED),
                            ("batch1d streamed", s_b1d, N_TIMED_B1D)):
        evolve = s_.make_evolve(steps)
        pair, step_times[name] = per_step(lambda p, e=evolve: e(*p), pair_of(s_),
                                          steps)
        if not bool(torch.isfinite(pair[0]).all()):
            raise PhaseError(f"timed {name} run produced non-finite values")
    del pair

    def lod_steps(c):
        for _ in range(N_TIMED_3D):
            c = rt.compute(op3, c)
        return c

    c3 = lod_steps(c3_0.clone())  # warm-up
    c3, step_times["lod3d"] = per_step(lod_steps, c3, N_TIMED_3D)
    if not bool(torch.isfinite(c3).all()):
        raise PhaseError("timed 3D run produced non-finite values")

    def lod_steps_streamed(c):
        for _ in range(N_TIMED_3D):
            c = rt.compute(op3s, c)
        return c

    c3 = lod_steps_streamed(c3_0.clone())  # warm-up
    c3, step_times["lod3d streamed"] = per_step(lod_steps_streamed, c3,
                                                N_TIMED_3D)
    if not bool(torch.isfinite(c3).all()):
        raise PhaseError("timed streamed 3D run produced non-finite values")

    def lod_steps_fft(c):
        for _ in range(N_TIMED_3D):
            c = rt.compute(op3f, c)
        return c

    c3 = lod_steps_fft(c3_0.clone())  # warm-up (cuFFT builds its plans)
    c3, step_times["lod3d fft"] = per_step(lod_steps_fft, c3, N_TIMED_3D)
    if not bool(torch.isfinite(c3).all()):
        raise PhaseError("timed fft 3D run produced non-finite values")

    def weno_steps(steps):
        def run(q):
            q, n = w_k.run(q, u1, v1, (steps - 0.5) * dt_w, dt=dt_w)
            assert n == steps
            return q
        return run

    q_w = weno_steps(N_STEPS)(q1)  # warm-up
    q_w, step_times["weno"] = per_step(weno_steps(N_TIMED), q_w, N_TIMED)
    if not bool(torch.isfinite(q_w).all()):
        raise PhaseError("timed WENO run produced non-finite values")
    # where the batched-1D, 3D, WENO and streamed steps go: each piece timed
    # alone at the step's shapes (CUDA events, median of 20)
    wbuf = [q1.clone() for _ in range(6)]

    def weno_glue():
        """The Runge–Kutta glue of WenoAdvection2D.run, the RHS results
        given (scaled by 1.0 so repeated calls stay bounded)."""
        r0, r1, r2, q, qa, qb = wbuf
        torch.add(q, r0.mul_(1.0), out=qa)
        r1.mul_(1.0).add_(qa).mul_(0.25)
        torch.mul(q, 0.75, out=qb).add_(r1)
        r2.mul_(1.0).add_(qb).mul_(2.0 / 3.0)
        q.div_(3.0).add_(r2)

    b1d_rhs = b1d.rhs(c1, c0)
    pieces = {
        "batch1d rhs: 6 stencil1d_batch + elementwise": lambda: b1d.rhs(c1, c0),
        f"batch1d x-sweep: penta_rows ({N_MAIN}, {N_MAIN})":
            lambda: b1d.op_full.solve_x(b1d_rhs),
        f"batch1d y-sweep: penta_cols ({N_MAIN}, {N_MAIN})":
            lambda: b1d.op_full.solve_y(b1d_rhs),
        f"3D x-sweep: penta_rows ({N3 * N3}, {N3})": lambda: op3.solve_x(u3),
        f"3D y-sweep: penta_mid ({N3}, {N3}, {N3})": lambda: op3.solve_y(u3),
        f"3D z-sweep: penta_cols ({N3}, {N3 * N3})": lambda: op3.solve_z(u3),
        f"streamed 3D x-sweep: penta_rows, {K} row chunks":
            lambda: op3s.solve_x(u3),
        f"streamed 3D y-sweep: penta_mid, {K} plane chunks":
            lambda: op3s.solve_y(u3),
        f"streamed 3D z-sweep: penta_cols, {K} column chunks":
            lambda: op3s.solve_z(u3),
        f"3D Laplacian plan: stencil3d ({N3}, {N3}, {N3})":
            lambda: lap3.apply(u3),
        f"streamed 3D Laplacian plan: stencil3d, {K} z-slabs":
            lambda: lap3s.apply(u3),
        f"WENO RHS: weno5_advect ({N_MAIN}, {N_MAIN})":
            lambda: w_k.rhs(q1, u1, v1),
        "WENO RK3 glue (12 torch ops, as in run)": weno_glue,
        f"streamed fused: stream_ch_rhs_xsweep, {K} chunks":
            lambda: s_fused._fused_xsweep(c1, c0),
        f"streamed y-sweep: penta_cols, {K} column chunks":
            lambda: s_fused.op_full.solve_y(c1),
        f"fft biharmonic plan: rfft2 * symbol, irfft2 ({N_MAIN}, {N_MAIN})":
            lambda: bih_fft.apply(c1),
        f"fft x-sweep: rfft / symbol, irfft ({N_MAIN}, {N_MAIN})":
            lambda: ch_fft.op_full.solve_x(c1),
        f"fft y-sweep: rfft / symbol, irfft ({N_MAIN}, {N_MAIN})":
            lambda: ch_fft.op_full.solve_y(c1),
        f"fft 3D x-sweep ({N3}, {N3}, {N3})": lambda: op3f.solve_x(u3),
        f"fft 3D y-sweep ({N3}, {N3}, {N3})": lambda: op3f.solve_y(u3),
        f"fft 3D z-sweep ({N3}, {N3}, {N3})": lambda: op3f.solve_z(u3),
        f"fft 3D Laplacian plan ({N3}, {N3}, {N3})": lambda: lap3f.apply(u3),
    }
    breakdown = {name: dict(events=time_ms(fn), device=device_ms(fn))
                 for name, fn in pieces.items()}
    record["step_breakdown_ms"] = breakdown
    for name, t in breakdown.items():
        how = "not in the trace" if t["device"] is None else f"{t['device']:.4f} ms"
        print(f"[time] {name}: {t['events']:.4f} ms (events), device {how}")
    # the fft pieces by device activity (cuFFT's kernels, torch's
    # elementwise passes and copies), one profiler window each; an
    # observation, kept even where a window lost records
    fft_rows = {}
    for name, fn in pieces.items():
        if name.startswith("fft"):
            rows = kernel_rows(fn)
            fft_rows[name] = [dict(kernel=short_name(k), launches=c, ms=ms)
                              for k, c, ms in rows]
            print(f"[fft-prof] {name}: {sum(ms for *_, ms in rows):.4f} ms of "
                  f"device activity a call in {len(rows)} rows")
            for k, c, ms in sorted(rows, key=lambda r: -r[2]):
                print(f"[fft-prof]   {c:3d} x {ms * 20 / c:.4f} ms  {short_name(k)}")
    record["fused_profile"] = profile_fused(solver, pair_of(solver))
    record["ms_per_step"] = step_times["fused"]
    record["ms_per_step_stencil"] = step_times["stencil"]
    record["ms_per_step_batch1d"] = step_times["batch1d"]
    record["ms_per_step_lod3d"] = step_times["lod3d"]
    record["ms_per_step_lod3d_streamed"] = step_times["lod3d streamed"]
    record["ms_per_step_weno"] = step_times["weno"]
    record["ms_per_step_streamed"] = {k: step_times[f"{k} streamed"]
                                      for k in ("fused", "batch1d")}
    for name, what in (("fused", f"fused step at {N_MAIN}^2 float64"),
                       ("stencil", f"stencil-mode step at {N_MAIN}^2 float64"),
                       ("stencil fft", f"stencil-mode step with fft sweeps at "
                        f"{N_MAIN}^2 float64"),
                       ("batch1d", f"batch1d step at {N_MAIN}^2 float64"),
                       ("lod3d", f"3D LOD step at {N3}^3 float64"),
                       ("lod3d streamed", f"3D LOD step at {N3}^3 float64, "
                        f"streams {STREAMS}, {K} chunks a sweep"),
                       ("lod3d fft", f"3D LOD step on fft at {N3}^3 float64"),
                       ("weno", f"WENO RK3 step at {N_MAIN}^2 float64"),
                       ("fused streamed", f"fused step at {N_MAIN}^2 float64, "
                        f"streams {STREAMS}, {K} chunks"),
                       ("batch1d streamed", f"batch1d step at {N_MAIN}^2 "
                        f"float64, streams {STREAMS}, {K} chunks")):
        t = step_times[name]
        print(f"[time] {what}: {t['host']:.4f} ms/step (host clock), "
              f"{t['events']:.4f} ms/step (CUDA events), host enqueue "
              f"{t['host_enqueue']:.4f} ms/step; {t['steps']} steps after "
              f"warm-up")

    # -- 4n. LM serving, after phase 5's timings -------------------------------
    # (its seconds of large bf16 products and host-bound decode loops would
    # otherwise run just before the host-bound steps timed above)
    lm_rec = lm_phase(counts_of)
    record["lm"] = lm_rec

    # -- 4o. LM training -----------------------------------------------------
    train_rec = lm_train_phase(counts_of)
    record["lm_train"] = train_rec

    # -- 4p. LM sharding on a one-rank NCCL world ------------------------------
    shard_rec = lm_shard_phase(counts_of)
    record["lm_shard"] = shard_rec

    # -- 4q. the LM dry-run in a subprocess ------------------------------------
    dry_rec = dryrun_phase()
    record["dryrun"] = dry_rec

    # -- 6. result lines -----------------------------------------------------
    # launches: each kernel's count from the run of the path it serves
    path_launches = dict(
        ch_rhs_xsweep=main_launches, penta_cols=main_launches,
        penta_rows=main_launches, stencil2d=main_launches,
        stencil1d_batch=b1d_launches, ch_rhs=rhs_launches,
        stencil3d=lod_launches, penta_mid=lod_launches,
        weno5_advect=weno_launches,
    )
    # and each kernel's count on every path that launched it, the serving
    # stream and the clean resilient run included
    by_path = dict(main=main_launches, batch1d=b1d_launches, rhs=rhs_launches,
                   lod3d=lod_launches, weno=weno_launches,
                   serve=serve["stream"]["launches"],
                   resilient=resilient["clean"]["launches"],
                   tune=tuning["launches"], dist=dist_rec["launches"],
                   audit=audit_rec["launches"])
    kernels = []
    for name, counts in path_launches.items():
        if not counts[name] > 0:
            raise PhaseError(f"{name} was not launched on its path")
        source, replaces = KERNEL_INFO[name]
        t = timings[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name],
            max_abs_err=max(c["max_abs_err"] for c in checks
                            if c["kernel"] == name and "main" in c["label"]),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            paths={p: c[name] for p, c in by_path.items() if c[name]},
        ))
        if name == "stencil2d":
            kernels[-1]["stacked"] = stacked["timings"]
    record["kernels"] = kernels
    floors = analytic_floors({k["name"]: k["bound_ms"] for k in kernels})
    record["tune"]["floors"] = floors
    for name, f in floors.items():
        bound = "-" if f["bound_ms"] is None else f"{f['bound_ms']:.4f}"
        print(f"[floors] {name}: {f['floor']} {f['floor_ms']:.4f} ms; "
              f"bound {bound} ms")
    spectral["ms_per_step"] = {
        k: step_times[k] for k in ("stencil", "stencil fft", "lod3d", "lod3d fft")}
    spectral["step_breakdown_ms"] = {k: v for k, v in breakdown.items()
                                     if k.startswith("fft")}
    spectral["fft_device_rows"] = fft_rows
    record["spectral"] = spectral
    dist_rec["fused_ms_per_step_phase5"] = step_times["fused"]
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"spectral": spectral}))
    print(json.dumps({"tune": tune_summary(tuning)}))
    print(json.dumps({"dist": {k: dist_rec[k] for k in (
        "checks", "bit_for_bit", "mass_drift", "ms_per_step", "device_ms",
        "fused_ms_per_step_phase5", "launches")}}))
    print(json.dumps({"audit": {
        **{k: audit_rec[k] for k in ("cells_run", "by_backend", "families",
                                     "factors", "seeds")},
        "card": audit_rec["meta"]["card"],
        "power_limit": audit_rec["meta"]["power_limit"]}}))
    print(json.dumps({"lm": {
        "card": lm_rec["card"], "seconds": lm_rec["seconds"],
        "launches": sum(lm_rec["launches"].values()),
        "cpu_vs_card_max_abs_err": max(
            r["max_abs_err"] for r in lm_rec["cpu_vs_card"]),
        "consistency": {r["arch"]: {k: r[k] for k in (
            "layers", "prompt", "max_abs_err", "limit")}
            for r in lm_rec["consistency"]},
        "serving": {r["arch"]: {
            **{k: r[k] for k in (
                "layers", "published_layers", "weights_gib",
                "prefill_tokens_per_s", "decode_ms_b4",
                "decode_enqueue_ms_b4", "decode_ms_b1", "peak_gib",
                "peak_init_gib", "seconds", "greedy_vs_batched")},
            "state_rebuild": None if r["state_rebuild"] is None else {
                k: r["state_rebuild"][k] for k in (
                    "max_abs_err", "limit", "logits_gated", "argmax_same",
                    "gaps", "ok")}}
            for r in lm_rec["serving"]}}}))
    print(json.dumps({"lm_train": {
        "card": train_rec["card"], "seconds": train_rec["seconds"],
        "launches": sum(train_rec["launches"].values()),
        "cpu_vs_card_worst_share": max(
            max(v for k, v in r.items() if k.endswith("_share"))
            for r in train_rec["cpu_vs_card"]),
        "adamw8bit_ties": train_rec["adamw8bit_ties"],
        "learning": {k: train_rec["learning"][k] for k in (
            "first", "last", "ok", "steps", "batch", "seq", "lr")},
        "remat": {k: train_rec["remat"][k] for k in (
            "peaks_gib", "grads_worst_share", "resident_gib")},
        "resume": train_rec["resume"],
        "configs": {r["arch"]: {k: r[k] for k in (
            "layers", "published_layers", "batch", "seq", "accum",
            "optimizer", "remat", "tokens_per_s", "ms_host", "ms_events",
            "enqueue_ms", "first_step_ms", "flops_share", "peak_gib",
            "losses", "seconds")}
            for r in [train_rec["smollm"], *train_rec["configs"]]},
        "not_trained": train_rec["not_trained"]}}))
    print(json.dumps({"lm_shard": {
        "card": shard_rec["card"], "seconds": shard_rec["seconds"],
        "launches": sum(shard_rec["launches"].values()),
        "configs": {r["arch"]: {k: r[k] for k in (
            "layers", "batch", "seq", "accum", "ms_plain", "ms_sharded",
            "tokens_per_s_plain", "tokens_per_s_sharded",
            "decode_ms_plain", "decode_ms_sharded", "decode_batch",
            "decode_cache", "train_worst_share", "decode_f32_worst_share",
            "decode_bf16_err_plain", "decode_bf16_err_sharded",
            "train_comm_counts", "decode_comm_counts")}
            for r in shard_rec["configs"]}}}))
    print(json.dumps({"dryrun": dry_rec}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lm-resume"]:
        sys.exit(lm_resume_worker(sys.argv[2]))
    sys.exit(main())
