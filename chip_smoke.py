#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vog_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --dist   # card, build, [dist gt5 prod] and [model axis gt5 prod] alone, on every card
    python3 chip_smoke.py --dcode  # card, build, [dcode srl bert-base] and [dcode pipeline] alone
    python3 chip_smoke.py --wide   # card, build, [wide shapes] alone

Phases, each printing its own lines; any failure exits non-zero before
the last line:

1. card: ``nvidia-smi`` name and power limit, the device name (TF32 is
   off by PyTorch's default for matmuls, and ``get_model`` turns both
   switches off from ``misc.matmul_precision``);
2. build: nvcc builds every kernel of ``vog_tpu_torch/csrc`` (in parallel);
3. kernels: each of the four forward kernels against its plain PyTorch version on
   the card, at the serving path's shapes (GT5 SPAT, B=16): bitwise for
   the gather in f32/bf16/int8, max |err| <= 1e-4 * max(1, max|ref|) and
   |err| / |ref| <= 1e-3 (norms over the tensor) for the fp32 kernels (sums
   run in another order); then CUDA-event times of the kernel, the plain
   version and the library call where one exists (``index_select`` for
   the gather, also at the smallest serve bucket of 4 rows; SDPA for the
   flash attention, and for the mm attention on its query repeated over
   the A args with a float mask, checked against the kernel first; median
   of 15 runs of 10 back-to-back calls, each timed twice: queued behind a
   sleep kernel, so that the events time the card alone, and as the host
   issues them, so that a call costs the larger of the card's time and
   the host's issue of it), and the bound of each kernel: the larger of
   its bytes over 3.35 TB/s and its operations over 165 TFLOP/s, the
   H100 SXM peaks (the operations at
   the rate of the fastest route that meets the fp32 parity limits,
   3xTF32 on the tensor cores: 495 / 3 TFLOP/s); and each forward
   kernel's launch called directly, without its ``torch.library`` op,
   with the host's issue (the wrapper's route before the op);
4. serve: 15,000-row bf16 feature tables made on the card from a seed,
   full-width VOGNet (GT5 production widths, random weights from a seed),
   96 ``vid_rows`` requests from 8 concurrent clients through
   ``ServingLoop`` (max_batch 16, buckets, pipelined): one pass of the
   requests discarded after the prewarm, then three timed passes.  Checks
   finite outputs of the right shapes, that all four kernels launched, and
   that the scores of a few requests agree with the same weights run on
   the CPU through the plain path; prints each pass's p50/p95 latency and
   requests/s and their medians;
5. profile: one B=16 batch, its host wall time, its forward's stream span
   (as the host issues it, and queued behind a sleep) and its device time
   by kernel (torch.profiler), the device's busy time (the union of the
   kernels' intervals; their summed times beside it), and the idle share
   of each span;
6. backward kernels: each of the three, flash and mm in both of their
   modes ("recompute" and "emit"), against its plain backward on the
   card at the GT5 shapes (flash with and without the frame bias, a batch
   row with every key masked; the head with the upstream gradient zeroed
   on the rows within 2e-5 of a ReLU kink), and each plain backward
   against torch.autograd of its plain forward, within phase 3's limits;
   their times, library calls (SDPA's backward; for mm with the float
   mask's gradient) and bounds as in phase 3; then ``[threads gt5]``:
   every wrapper's forward and backward (through autograd, both modes of
   flash and mm), at both precisions, from a fresh thread bitwise as from
   the main thread (``thread_calls``, ``fresh_thread_mismatches``);
7. train: the production recipe (``configs/gt5_production.yml``: B=16,
   lr 5e-4 cosine after 100 warm-up steps, pos_weight 5, skip_nonfinite 50,
   grad_clip 1, dropout 0.1) at full width, fp32 activations, batches
   drawn from the device tables.  (a) the first step on the card against
   the same step on the CPU plain path (same weights and batch, dropout 0,
   TF32 off): loss within 1e-4 relative, every parameter's gradient within
   1e-4 * max(1, max|g|) and 1e-2 relative; as a control, the same card
   step with the head's db1 and the mm attention's dfb zeroed must fail
   that comparison; (b) 30 steps: every loss finite, no step dropped by
   the guard, the first and last loss, the median step time and samples/s,
   the launches per step of all seven kernels (each > 0) and one profiled
   step's device idle share, and the peak memory of a step; (c) the state
   after (b) through (a)'s comparison once more.  Both comparisons are
   kink-aware (``kink_keep``);
8. dispatch gt5: the production recipe's dispatch (``steps_per_dispatch``
   16, ``eval_batches_per_dispatch`` 10) with index-only batches against
   annotation tables made from a seed (40,000 annotations): 37 steps as
   CUDA-graph dispatches of 16, 16 and 5 bitwise against 37 eager steps
   (the 7 kernels launched by the replays), freeze on NaN (skip_nonfinite
   0: a dispatch of 16 with a NaN row first read by step 6 ends bitwise at
   the eager state after step 5; a control without it does not), 10 eval
   batches as one dispatch bitwise against 10 eager eval steps, and the
   times eager against graph: train step, eval batches/s, serve with
   ``cuda_graphs`` off and on, the peak memory of a captured step;
9. P100 (T=4000, B=2), after the GT5 tables are freed: the int8 store of
   the JAX package's single-chip P100 run (5,549 rows, 11,557 MB) made on
   the card, then phases 3-6 at P100 shapes (serve: 16 requests, 4
   clients, max_batch 2, scores against the plain path on the card,
   ``plain_kernels``), and phase 7 with the JAX package's P100 recipe for
   10 steps in each backward-mode pair (``MODE_PAIRS``: flash recompute +
   mm emit, flash emit + mm recompute), compared with the plain path on
   the card; then the peak memory of one step in the other two mode
   combinations; and one CUDA-graph dispatch of 8 steps bitwise against 8
   eager steps, with its step time and the peak memory of a captured step.

The production numerics (``mdl.dtype`` bfloat16, ``misc.matmul_precision``
"default": bf16 activations, one TF32 pass for every fp32 product and
kernel; each phase that switches precision restores "highest" after it):

10. kernels default, in each regime after phase 6: each kernel's "default"
    variant (launches counted as ``name@default``), forward and backward
    in both modes, against its plain version at "highest" on the same
    inputs: relative max-diff (max |err| / max(1, max|ref|)) within 2e-2
    forward and 5e-2 for every gradient, the JAX package's bounds for its
    "default" kernels, and |err| / |ref| <= 5e-3 (Frobenius); the head
    backward given its own row pass's ReLU decisions
    (``head_bwd_given``).  Times both ways, the plain version and the
    library call under TF32, the bound at 495 TFLOP/s (TF32 dense);
11. serve gt5 prod, after phase 8: the production model in bf16 with
    "default", 96 requests as phase 4: scores within 2e-2 x max|score| of
    the CPU plain path in the same numerics (bf16 itself moves a score by
    about 1.3e-2 of max|score|: the CPU's bf16 against its fp32, printed
    beside it) and 3e-2 x max|score| of the card's fp32 "highest" scores
    (the JAX package's bf16 bound), p50 / p95 / req/s beside phase 4's;
12. dispatch gt5 prod: ``configs/gt5_production.yml`` as it is (bf16,
    "default", half_feats, index-only, K=16, E=10; ``prod_cfg``): 37
    graph steps bitwise against 37 eager steps launching the "default"
    variants and no other, fp32 parameters and optimizer state; the first
    step against the CPU plain path in the same numerics (loss, the whole
    gradient's and each leaf's cosine: ``PROD_*``), which a zeroed head
    db1 and mm dfb on the card must fail; step ms, samples/s, device busy
    and idle, our kernels' and the other ops' device ms, the peak memory
    of a captured step, beside phase 8's;
13. dispatch p100 prod, after phase 9: the P100 recipe in bf16 with
    "default", two CUDA-graph dispatches of 8 in each backward-mode pair:
    losses finite, none dropped, the pair's "default" kernels launched and
    no other; step ms and the peak memory of a captured step beside phase
    9's dispatch.

The training entry point (after phase 12, once the GT5 random tables are
freed, before P100):

14. learner gt5 prod (``phase_learner``, ``learner_runs``): a fixture
    written by the port's writer at the recipe's widths, BASELINE.md's GT5
    curve set (5,600 segments: 3,920 / 1,400 / 280), trained through
    ``python -m vog_tpu_torch.cli.train``'s ``main`` with
    ``configs/gt5_production.yml`` for 6 epochs of a cosine over 24: a
    SIGTERM after dispatch 10 of epoch 1, a resume to the end of epoch 1
    bitwise at a Learner's state after two epochs uninterrupted, and a
    resume to the end; every logged loss finite and no non-finite step,
    every "default" kernel of the path launched (counts per epoch), each
    epoch's acc beside the JAX package's curve and the learnability bound
    (acc past 0.4 by epoch 5, best at least 0.6), ``cli.eval`` on "best"
    and ``offline.eval_fun`` on the predictions agreeing with the Learner;
    table build, epoch time, samples/s beside phase 12's, the idle share
    of a profiled epoch, eval batches/s, checkpoint saves and the peak
    memory, each with the card.  Saves run with the yml's
    ``train.async_ckpt`` (true): every epoch's save asynchronous, the
    SIGTERM's the one blocking save; printed: the seconds each save
    blocked the loop (its queued host copy), the writer thread's seconds,
    and one save's block against a plain synchronous ``.cpu()`` copy of
    the same state;
15. learner keys gt5 (``phase_learner_keys``): on the same fixture,
    ``misc.checkify`` (K 16 forced to 1): 4 checked eager steps pass and
    are timed beside the same steps unchecked and phase 12's graphed step,
    and a step with the feature table NaN must raise naming its op;
    ``misc.profile_dir``: one epoch whose Chrome trace covers its second
    dispatch and must name every kernel of the path (``KERNEL_SYMBOLS``);
    ``misc.tensorboard_dir``: the "off" line without ``tensorboard`` on the
    host (an event file with it);
16. serve cli gt5 prod (``phase_serve_cli``): ``python -m
    vog_tpu_torch.cli.serve``'s ``main`` on that run's "best" checkpoint
    (``--selftest=96 --concurrency=8``, its JSON line), the CLI's predictor
    bitwise ``Predictor.from_checkpoint`` on 16 valid requests, and its
    HTTP mode on a loopback port answering as the in-process call;
17. export gt5 prod (``phase_export``): ``cli.export`` of "best" at B=16,
    with the bf16 tables inside and in the int8 encoding: each program's
    forward ops by node, each replay through its CUDA graph and eagerly
    against the live eager predictor (bitwise, both), a B=16 call of the
    graphed replay, the eager replay and the live graphed predictor timed
    in one call, ``cli.serve --artifact`` (graphed) beside the live loop,
    and a ``ServingLoop`` with buckets around it refused.

Data parallelism across processes (after phase 17, before P100):

18. dist gt5 prod (``phase_dist``), each world spawned from here
    (``run_world``; a rank that fails or a world past 600 s fails the
    run), each rank's shard of one random bf16 table (3,000 rows a rank,
    ``dist_tables``) and index-only batches of train.bs x world rows:
    (a) an NCCL world of every card (``dist_nccl_rank``): the production
    recipe's graphed dispatch of K=16 (the gradient's all-reduce, the
    loss's count and the sharded store's all-gather and reduce-scatters
    captured) bitwise its 16 eager steps, at world 1 bitwise the
    single-device dispatch, at world > 1 the first step in fp32 "highest"
    against one process on the global batch (compare_step's bounds); step
    ms, samples/s, the nccl kernels' share of a profiled step; (b) a gloo
    world of 2 ranks on card 0 (``dist_gloo_rank``, fp32, dropout 0.1,
    eager K=1): 3 steps and one eval through ``gather_eval`` against one
    process on the global batches (losses 1e-4, the first step's
    gradients, eval sums); in both, the ranks' states bitwise equal
    (``state_digest``) and every kernel of the path launched.

The mesh's model axis (after phase 18):

19. model axis gt5 prod (``phase_model_axis``), each world spawned from
    here as phase 18's: (a) with more than one card, an NCCL world of
    every card (``model_axis_nccl_rank``): meshes (1, n) tensor-parallel,
    (n/2, 2) tensor x data parallel and (1, n) with the ring, each the
    production recipe's graphed dispatch of K=16 (the data and model
    groups' collectives and the ring's P2P captured) bitwise its eager
    steps, the ranks' whole and gathered states equal, the fp32 "highest"
    first step against one process on the global batch (compare_step's
    bounds), step ms and samples/s beside the single card's dispatch in
    the same call; then [sp p100 serve] (``sp_p100_serve``): a P100
    ``Predictor`` (T=4000, B=2) on n model ranks with the ring, p50 / p95
    beside the single card's graphed predictor and its scores within 2e-4
    of max|score| (fp32); (b) a gloo world of 2 ranks on card 0, mesh
    (1, 2) (``model_axis_gloo_rank``, fp32, dropout 0.1, eager): 3
    tensor-parallel steps (every kernel at 2 heads a rank), the ring with
    ``decomposed_mm`` on and off, one serve flush through the follower,
    each against one process on the card; the ranks' whole parameters and
    gathered states bitwise equal, and a rerun's.

The offline dataset construction (after phase 19, before P100; alone with
``--dcode``):

20. dcode srl bert-base (``phase_dcode_srl``): the BERT-SRL tagger at
    BERT-base width (random weights from seed 0, a synthetic 30,522-piece
    vocab, 4,096 synthetic captions of 10-30 words with words out of the
    vocab), fp32 "highest": (a) 256 frames through the flash kernel
    against the same tagger's plain path on the card (last hidden state
    within 1e-4 x max|h|, tags equal), then every caption through
    ``tag_sentences`` (sentences/s, frames/s, launches), ``flash_fwd`` at
    the run's median batch beside its plain version, SDPA and its bound;
    (b) one fine-tune step of 16 golden frames at full width, every
    gradient against the plain path on the card (``grad_faults``); (c) the
    golden harness at the tests' width reaching exact 1.0;
21. dcode pipeline (``phase_dcode_pipeline``): ``run_pipeline`` with the
    rule tagger and with phase 20's saved tagger (``bert:``), over a P100
    fixture of 64 videos, then ``--gt5-from``: every GT box with a P100
    proposal at IoU >= 0.5 keeps one in the GT5 pack; the built dataset
    opens with ``get_data``, serves a batch through a ``Predictor`` and
    takes a train step; none of transformers, tokenizers, safetensors or
    h5py imported.

The attention kernels' wide shapes (after phase 21, before P100; alone
with ``--wide``):

22. wide shapes (``phase_wide``): the production model with ``WIDE``'s
    keys (2 heads: head dim 256; ``temp`` over 4 videos of 20 frames: 80
    frames, T=400; 10 args: the mm kernels in two launches of 5; a second
    mm layer, whose flash attention carries the 80-frame bias), fp32
    "highest": (a) ``wide_kernel_rows``: the flash kernels at the second
    mm layer's shape and the mm kernels at the first's, forward and both
    backward modes, against their plain versions (phase 3's limits),
    timed beside them, SDPA with the bias as a float mask and the bounds;
    the flash forward at the BERT-SRL tagger's shape (the dh-64 instance)
    beside SDPA; (b) 32 requests from 4 clients on 2,000 random bf16 rows,
    scores against the plain path on the card; (c) phase 7 at 5 steps
    (first step and trained state against the plain path on the card,
    with its control), the mm kernels launched twice a call, and 2 steps
    in the other backward-mode pair (flash emit, mm recompute).  Every
    wide row's launches are counted on (b) and (c).  Past head dim 128 the
    flash backward and the mm forward are the cluster instances
    (``csrc/cluster.cuh``): their rows carry the cluster's size and passes,
    ptxas's registers and spill stores of the instances (``[build]``; a
    spill store fails the run) and ``cudaOccupancyMaxActiveClusters``,
    and, with the flash forward's rows, the host's time to issue one
    wrapper call (``host_ms``).  The head-dim-256 flash backward is also
    split by kernel (torch.profiler) beside the DK 128 instance on its
    first 128 columns (the same shape at half the work, no cluster).

No thread may warn that it ran cuBLAS without a current CUDA context
(``watch_context_warnings``).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# H100 SXM, 3xTF32 on the tensor cores (495 TFLOP/s TF32 dense / 3): the
# fastest route that meets the port's fp32 parity limits (fp32 FMA outside
# the tensor cores runs at 67 TFLOP/s)
PEAK_FLOP_PER_S = 495e12 / 3
TOL = 1e-4  # fp32 kernels: max |err| <= TOL * max(1, max|ref|)
REL_TOL = 1e-3  # and |err| / |ref| (norms over the tensor): a zeroed or halved result fails
# a whole train step card vs CPU: each gradient's |err| / |ref| (a zeroed or
# halved leaf gives 1 or 0.5; the end-to-end chain reaches ~1e-3 on the
# input projections' weights)
TRAIN_REL_TOL = 1e-2
WORST_REL = {}  # check name (first word) -> worst relative error of check_close


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


MAX_SLEEP_CYCLES = 1 << 30  # ~0.6 s at the H100's clock


def time_ms(fn, reps: int = 15, inner: int = 10, warm: int = 3, queued: bool = True) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call, after warm-up.

    ``queued`` (device time): the calls are queued behind a sleep kernel,
    so the host has issued them all before the card reaches the first
    event, and the events time the card alone.  A rep in which the card
    reached the first event before the host had queued the last call is
    run again with a sleep twice as long; one that still does behind the
    longest sleep fails the run.  Not ``queued`` (issue included): no
    sleep, so a call costs the larger of the card's time and the host's
    issue of it (a Python wrapper can take longer to issue than a small
    kernel takes to run)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts, cycles = [], 1 << 21
    while len(ts) < reps:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        caught_up = queued and s.query()
        e.synchronize()
        if caught_up:
            if cycles >= MAX_SLEEP_CYCLES:
                fail(f"time_ms: the card caught up with the host behind a sleep of {cycles} cycles")
            cycles *= 2
            continue
        ts.append(s.elapsed_time(e) / inner)
    return statistics.median(ts)


# time_ms's (reps, inner) at GT5, and at P100, whose calls each take
# milliseconds (the plain versions tens of them)
TIMING = {"gt5": (15, 10), "p100": (7, 3)}


def timings(kernel, plain, library=None, reps: int = 15, inner: int = 10) -> dict:
    """A kernel's wrapper, its plain version and the library call (None:
    none), each timed both ways of ``time_ms``: device time (``ms``,
    ``plain_ms``, ``library_ms``) and with the host's issue (``issue_ms``,
    ``plain_issue_ms``, ``library_issue_ms``)."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[key + "ms"] = None if fn is None else time_ms(fn, reps, inner)
        out[key + "issue_ms"] = None if fn is None else time_ms(fn, reps, inner, queued=False)
    return out


def host_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """The host's time to issue one call of ``fn`` (a wrapper: its checks,
    allocations, C entry and launches), without the card's: median over
    ``reps`` of ``calls`` back-to-back calls queued behind a sleep kernel,
    so that the host never waits for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        torch.cuda._sleep(1 << 26)  # ~40 ms: longer than the calls' issue
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        ts.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return statistics.median(ts)


def fmt_times(t: dict, lib: str = "library") -> str:
    """``timings`` as ``ms=... plain=... <lib>=...``, device time and, after
    the slash, with the host's issue."""
    def pair(key):
        return "none" if t[key + "ms"] is None else f"{t[key + 'ms']:.4f}/{t[key + 'issue_ms']:.4f}"
    host = f" host={t['host_ms']:.4f}" if t.get("host_ms") is not None else ""
    return f"ms={pair('')} plain={pair('plain_')} {lib}={pair('library_')}{host}"


def fmt_direct(t: dict) -> str:
    """The kernel's launch called directly, without its op's dispatcher
    (``direct_issue_ms``), with the host's issue: the wrapper's route
    before the ``torch.library`` op."""
    return f" direct launch (no op) w/ issue={t['direct_issue_ms']:.4f}"


def bound_ms(n_bytes: float, n_flops: float, peak: float = PEAK_FLOP_PER_S):
    tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def rel_err(got, ref) -> float:
    """|got - ref| / |ref| over the whole tensor (Frobenius norms); when
    ``ref`` is zero, 0 if ``got`` is too, else inf."""
    d = float((got.double() - ref.double()).norm())
    n = float(ref.double().norm())
    return d / n if n > 0 else (0.0 if d == 0 else float("inf"))


def check_close(name, got, ref) -> float:
    err, rel = max_err(got, ref), rel_err(got, ref)
    lim = TOL * max(1.0, float(ref.abs().max()))
    key = name.split()[0]
    WORST_REL[key] = max(WORST_REL.get(key, 0.0), rel)
    if not (err <= lim and rel <= REL_TOL):
        fail(f"{name}: max |err| {err:.3e} (limit {lim:.3e}), relative err {rel:.3e} (limit {REL_TOL:.0e})")
    return err


def check_yardstick(name, got, ref) -> float:
    """A library call timed beside a kernel computes the same function:
    |err| / |ref| <= 1e-2 (a wrong mask, scale or layout gives an error of
    order 1; the library's own rounding is not held to the kernels'
    limits).  -> the relative error."""
    rel = rel_err(got, ref)
    if not rel <= 1e-2:
        fail(f"{name}: the library call differs from the kernel, relative err {rel:.3e}")
    return rel


# The "default" variants (one TF32 pass) against their plain versions at
# "highest": the JAX package's bounds for its "default" kernels (relative
# max-diff max |err| / max(1, max |ref|), BASELINE.md: 2e-2 forward, 5e-2
# gradients) and |err| / |ref| <= 5e-3 (Frobenius); their bound is at the
# H100 SXM's TF32 dense peak
DEFAULT_FWD_TOL, DEFAULT_GRAD_TOL, DEFAULT_FRO_TOL = 2e-2, 5e-2, 5e-3
TF32_FLOP_PER_S = 495e12
WORST_DEFAULT = {}  # check name (first word) -> (worst relative max-diff, worst Frobenius)


def check_default(name, got, ref, fwd: bool) -> tuple:
    """-> (max |err|, relative max-diff, Frobenius relative err) of a
    "default" kernel's output against its plain version at "highest";
    fails outside DEFAULT_{FWD,GRAD}_TOL or DEFAULT_FRO_TOL."""
    err = max_err(got, ref)
    rel, fro = err / max(1.0, float(ref.abs().max())), rel_err(got, ref)
    key = name.split()[0]
    w = WORST_DEFAULT.get(key, (0.0, 0.0))
    WORST_DEFAULT[key] = (max(w[0], rel), max(w[1], fro))
    lim = DEFAULT_FWD_TOL if fwd else DEFAULT_GRAD_TOL
    if not (rel <= lim and fro <= DEFAULT_FRO_TOL):
        fail(f"{name}: relative max-diff {rel:.3e} (limit {lim:.0e}), Frobenius {fro:.3e} "
             f"(limit {DEFAULT_FRO_TOL:.0e})")
    return err, rel, fro


@contextlib.contextmanager
def tf32(on: bool):
    """Both TF32 switches (what ``apply_matmul_precision`` sets) on or off
    inside the block, restored after."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def mm_sdpa_inputs(qm, cn, mask, fb, fid):
    """One scaled_dot_product_attention call that computes the shared-QK
    multi-arg attention: the query repeated over the A args, (B, H, A*T, dh),
    and a float mask fb[h, fid_i, fid_j] + cn[b, h, a, j] with masked keys
    at NEG (B, H, A*T, T)."""
    import torch

    from vog_tpu_torch.kernels.mm_attention import NEG

    B, H, T, dh = qm.shape
    A = cn.shape[2]
    fidl = fid.long()
    bias = fb[:, fidl][:, :, fidl]  # (H, T, T)
    m = bias[None, :, None] + cn[:, :, :, None, :]  # (B, H, A, T, T)
    m = torch.where((mask > 0)[:, None, None, None, :], m, torch.full_like(m, NEG))
    q_rep = qm[:, :, None].expand(B, H, A, T, dh).reshape(B, H, A * T, dh).contiguous()
    return q_rep, m.reshape(B, H, A * T, T).contiguous()


def phase_card():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"[card] device={name} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    return name, card


PTXAS: dict = {}  # library stem -> {kernel function: (registers, spill store bytes)}
# the head backward's narrow kernels (csrc/grounding_head.cu): gated on spills as the cluster instances
WGMMA_BWD_INSTANCES = ("head_bwd_rows_wg", "head_bwd_w_wg", "head_bwd_prep", "head_bwd_finish")
# the mm backward's and forward's wgmma kernels and their passes before them
# (csrc/mm_attention.cu, the library mm_attention_wg@default): gated the same way
WGMMA_MM_INSTANCES = ("mm_bwd_dkv_wg", "mm_bwd_prep_wg", "mm_fwd_wg", "mm_fwd_prep_wg")


def phase_build():
    from vog_tpu_torch.kernels import _build

    secs = _build.build_all()
    print(f"[build] {len(_build.LIBRARIES)} libraries ({len(_build.SOURCES)} sources, the three with TF32 "
          f"products at \"highest\" and at \"default\", {', '.join(_build.CLUSTER_SOURCES)} also for its "
          f"{_build.CLUSTER} instances) built in {secs:.1f} s into {_build.build_dir()}", flush=True)
    for lib in _build.LIBRARIES:
        stem = _build.lib_stem(*lib)
        log = _build.build_dir() / f"{stem}.log"
        if not log.exists():
            continue
        fn, spill = "?", ""
        for line in log.read_text().splitlines():  # ptxas -v: properties, spills, then registers
            if "Function properties for" in line:
                # the mangled name, short: "mm_bwd_dqILi8EE" is mm_bwd_dq<8>
                fn = line.rsplit(" ", 1)[-1].split("_cu_", 1)[-1][8:].split("Ev", 1)[0].lstrip("0123456789")
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line:
                print(f"[build] {stem} {fn}: {line.split(':', 1)[-1].strip()}; {spill}", flush=True)
                regs = int(line.split("Used", 1)[1].split()[0])
                stores = int(spill.split(" bytes spill stores")[0].rsplit(" ", 1)[-1]) if "spill stores" in spill else 0
                PTXAS.setdefault(stem, {})[fn] = (regs, stores)
            elif line.startswith("[nvcc]"):
                print(f"[build] {stem}: nvcc took {line.split(' ', 1)[1]}", flush=True)
    cl = {(stem, fn): v for stem, fns in PTXAS.items() for fn, v in fns.items() if "_cl" in fn}
    spilled = {k: v for k, v in cl.items() if v[1]}
    print(f"[build] cluster instances (csrc/cluster.cuh): {len(cl)}, at most {max((v[0] for v in cl.values()), default=0)} "
          f"registers, spill stores {sum(v[1] for v in cl.values())} bytes", flush=True)
    if not cl or spilled:
        fail(f"[build] the cluster instances must build and spill nothing: {len(cl)} built, spills {spilled}")
    wg = {(stem, fn): v for stem, fns in PTXAS.items() for fn, v in fns.items()
          if any(k in fn for k in WGMMA_BWD_INSTANCES)}
    print("[build] the head backward's narrow (wgmma) instances: "
          + ", ".join(f"{stem} {fn[:fn.index('E')] if 'E' in fn else fn} {r} registers, {st} bytes spilled"
                      for (stem, fn), (r, st) in wg.items()), flush=True)
    built = {(stem, k) for stem, fn in wg for k in WGMMA_BWD_INSTANCES if k in fn}
    if len(built) != 2 * len(WGMMA_BWD_INSTANCES) or any(v[1] for v in wg.values()):
        fail(f"[build] the head backward's narrow instances must build at both precisions and spill nothing: {wg}")
    mm_stem = _build.lib_stem("mm_attention.cu", "default", _build.WG)
    mm = {re.sub(r"ILi(\d+)E.*", r"<\1>", fn).split("E", 1)[0]: v for fn, v in PTXAS.get(mm_stem, {}).items()
          if fn.startswith(WGMMA_MM_INSTANCES)}  # mm_fwd_wg<A>: an instance an arg count
    print(f"[build] the mm backward's and forward's wgmma instances ({mm_stem}): "
          + ", ".join(f"{fn} {r} registers, {st} bytes spilled" for fn, (r, st) in mm.items()), flush=True)
    if {k for k in WGMMA_MM_INSTANCES if any(fn.startswith(k) for fn in mm)} != set(WGMMA_MM_INSTANCES) \
            or any(v[1] for v in mm.values()):
        fail(f"[build] the mm backward's and forward's wgmma instances must build and spill nothing: {mm}")


def cluster_info(family: str, dh: int, prec: str, A: int = 5, F: int = 1, part: str = "bwd") -> dict:
    """A row's cluster design past head dim 128 (``family`` "flash" or
    "mm", ``part`` "fwd": flash_fwd_cl / mm_fwd_cl, or "bwd": the dkv and
    dq kernels, flash_bwd_*_cl / mm_bwd_*_cl): the plan (blocks a cluster,
    passes, the padded head dim), ptxas's registers and spill stores of the
    library's instances (``[build]``), and ``cudaOccupancyMaxActiveClusters``
    of the one-pass instances at this shape (the mm instances of 5 args,
    or of a launch's most where it takes more: 7 forward, 8 backward)."""
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.kernels import _cluster as cluster

    plan = cluster.cluster_plan(dh, A)
    I = _build.I
    if family == "flash":
        lib = _build.lib_stem("attention.cu", prec)
        names = ("flash_fwd_cl",) if part == "fwd" else ("flash_bwd_dkv_cl", "flash_bwd_dq_cl")
        fn = _build.function("attention.cu", "vog_flash_clusters", [I] * 3, prec)
        occ = [fn(0, plan.cluster, F, which) for which in ((2,) if part == "fwd" else (0, 1))]
    else:
        lib = _build.lib_stem("mm_attention.cu", prec, _build.CLUSTER)
        names = ("mm_fwd_cl",) if part == "fwd" else ("mm_bwd_dkv_cl", "mm_bwd_dq_cl")
        fn = _build.function("mm_attention.cu", "vog_mm_clusters", [I] * 3, prec, _build.CLUSTER)
        groups = plan.groups if part == "fwd" else plan.bwd_groups
        most = max(a1 - a0 for a0, a1 in groups)  # a launch's args
        wide = (7 if part == "fwd" else 8) if most > 5 else 5
        occ = [fn(0, wide, plan.cluster, which) for which in ((0,) if part == "fwd" else (1, 2))]
    inst = [v for f, v in PTXAS.get(lib, {}).items() if f.startswith(names)]
    return dict(cluster=plan.cluster, passes=plan.passes, dh_pad=plan.dh_pad, instances=len(inst),
                max_registers=max((v[0] for v in inst), default=None), spill_stores=sum(v[1] for v in inst),
                max_active_clusters=occ)


def fmt_cluster(c: dict) -> str:
    return (f"cluster {c['cluster']} x {c['passes']} pass(es), dh {c['dh_pad']}, {c['instances']} instances <= "
            f"{c['max_registers']} registers, {c['spill_stores']} spill bytes, max active clusters "
            f"{c['max_active_clusters']}")


# [wide shapes]: the production model at the shapes the attention kernels
# took last: 2 heads (head dim 256), ``temp`` over 4 videos of 20 frames
# (80 frames, T = 400), 10 args (the mm kernels in groups of 5 + 5), and a
# second mm layer, whose flash attention carries the 80-frame bias
WIDE = {"mdl.n_heads": 2, "ds.conc_type": "temp", "ds.num_frms": 20, "ds.max_srl_args": 10,
        "mdl.mm_tx_layers": 2}


def serve_cfg(exp_setting: str = "gt5", wide=False):
    """The production model (fp32 activations, matmul precision
    "highest"); GT5 with bf16 tables, or P100 (100 proposals a frame,
    T = 4000) with int8 tables, as the JAX package's single-chip P100 run;
    ``wide``: True for the keys of ``WIDE``, or a dict of keys (``WIDER``)."""
    from vog_tpu_torch.config import Cfg, post_proc_config

    cfg = Cfg()  # production widths: vis 512, 4 heads, lstm 256, emb 300, role 128
    cfg.mdl.name = "vog"
    cfg.mdl.decomposed_mm = True
    cfg.mdl.head_type = "fused"
    cfg.mdl.obj_tx_layers = 1
    cfg.mdl.mm_tx_layers = 1
    cfg.mdl.dtype = "float32"
    cfg.ds.conc_type = "spat"
    cfg.ds.exp_setting = exp_setting
    cfg.misc.half_feats = exp_setting == "gt5"
    cfg.misc.int8_feats = exp_setting == "p100"
    for key, v in (WIDE if wide is True else wide or {}).items():
        group, name = key.split(".")
        setattr(getattr(cfg, group), name, v)
    return post_proc_config(cfg)


def phase_kernels(cfg, tables, B: int = 16):
    """Each kernel against its plain version on the card at the serving
    path's shapes; returns the kernel table rows (without launches)."""
    import torch

    from vog_tpu_torch.config import kernel_precision
    from vog_tpu_torch.data.device_store import _pack_rows
    from vog_tpu_torch.kernels import attention, grounding_head, gather, mm_attention

    tag = cfg.ds.exp_setting
    reps, inner = TIMING[tag]
    prec = kernel_precision()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    V, F, P, A = cfg.ds.num_cmp, cfg.ds.num_frms, cfg.ds.num_prop_per_frm, cfg.ds.max_srl_args
    D, H = cfg.mdl.vis_dim, cfg.mdl.n_heads
    dh, T = D // H, F * V * P
    rows = torch.randint(0, tables.n_rows, (B, V), generator=g, device=dev, dtype=torch.int32)
    rows[0, 1] = rows[0, 0]  # a duplicate row
    out = []

    # -- gather: bitwise in the resident tables' type (and their int8
    # scales), f32 and int8 ------------------------------------------------
    feats = tables.tables["feats"]
    for name, t in tables.tables.items():
        if not torch.equal(gather.gather_rows(t, rows), gather.gather_rows_plain(t, rows)):
            fail(f"gather_rows {name} ({t.dtype}): not bitwise equal to the plain version")
    n_small = min(512, (256 << 20) // (F * P * cfg.ds.prop_dim * 4))  # at most 256 MB of f32 rows
    small = torch.randn((n_small, F, P, cfg.ds.prop_dim), generator=g, device=dev) * 0.3
    for dt, int8 in ((torch.float32, False), (torch.int8, True)):
        t = _pack_rows({"feats": small}, dt, int8)["feats"]
        r = torch.randint(-5, n_small + 8, (B, V), generator=g, device=dev, dtype=torch.int32)  # out of range too
        if not torch.equal(gather.gather_rows(t, r), gather.gather_rows_plain(t, r)):
            fail(f"gather_rows {t.dtype}: not bitwise equal to the plain version")
    # time over 8 row sets (8 x 13 MB > the 50 MB L2), so each call reads
    # cold rows; at B and at the smallest serve bucket (B=1, 4 rows), each
    # beside index_select; the table row keeps B
    row_bytes = feats[0].numel() * feats.element_size()
    times = {}
    for nb in (B, 1):
        sets = [torch.randint(0, tables.n_rows, (nb, V), generator=g, device=dev, dtype=torch.int32)
                for _ in range(8)]
        turn = [0]

        def nxt():
            turn[0] = (turn[0] + 1) % len(sets)
            return sets[turn[0]]

        times[nb] = timings(lambda: gather.gather_rows(feats, nxt()),
                            lambda: gather.gather_rows_plain(feats, nxt()),
                            lambda: torch.index_select(feats, 0, nxt().reshape(-1)), reps, inner)
        times[nb]["direct_issue_ms"] = time_ms(lambda: gather._gather_rows_cuda(feats, nxt()), reps, inner,
                                               queued=False)
        times[nb]["bound_ms"] = bound_ms(2 * nb * V * row_bytes + nbytes(sets[0]), 0)[0]
    t, b1 = times[B], times[1]
    out.append(dict(name="gather_rows", route="cuda", source="vog_tpu_torch/csrc/gather.cu",
                    replaces="vog_tpu/kernels/gather.py:79", max_abs_err=0.0, bound_by="bytes", **t,
                    shape=f"{feats.dtype} table {tuple(feats.shape)}, rows {tuple(rows.shape)}",
                    **{"b1_" + k: x for k, x in b1.items()}))
    print(f"[kernels {tag}] gather_rows bitwise ({', '.join(tables.tables)} as resident; f32, int8); "
          f"device/with issue: B={B}: "
          f"{fmt_times(t, 'index_select')} bound={t['bound_ms']:.4f}{fmt_direct(t)}; B=1 ({V} rows): "
          f"{fmt_times(b1, 'index_select')} bound={b1['bound_ms']:.4f}{fmt_direct(b1)}", flush=True)

    # -- flash attention: no bias (object transformer) and with bias -----
    q, k, v = (torch.randn((B, H, T, dh), generator=g, device=dev) for _ in range(3))
    mask = (torch.rand((B, T), generator=g, device=dev) > 0.2).float()
    mask[:, 0] = 1.0
    mask[B - 1] = 0.0  # one batch row with every key masked
    fid_spat = (torch.arange(T, device=dev) // (V * P)).to(torch.int32)
    fb = torch.randn((H, F, F), generator=g, device=dev) * 0.5
    fid_mixed = torch.randint(0, F, (T,), generator=g, device=dev, dtype=torch.int32)
    err = 0.0
    for bias, fid in ((None, None), (fb, fid_spat), (fb, fid_mixed)):
        o, lse = attention.flash_attention_fwd(q, k, v, mask, bias, fid)
        ro, rl = attention.flash_attention_plain(q, k, v, mask, bias, fid)
        # the lse of the all-masked row is -1e30 + log T: checked on the others
        err = max(err, check_close("flash_attention", o, ro),
                  check_close("flash_attention lse", lse[: B - 1], rl[: B - 1]))
    bmask = (mask > 0)[:, None, None, :]
    t = timings(lambda: attention.flash_attention_fwd(q, k, v, mask),
                lambda: attention.flash_attention_plain(q, k, v, mask),
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bmask),
                reps, inner)
    t["direct_issue_ms"] = time_ms(lambda: attention._flash_fwd_cuda(q, k, v, mask, None, None, prec), reps, inner,
                                   queued=False)
    fl = 4.0 * B * H * T * T * dh
    bms, by = bound_ms(nbytes(q, k, v, mask) + nbytes(q) + B * H * T * 4, fl)
    out.append(dict(name="flash_attention", route="cuda", source="vog_tpu_torch/csrc/attention.cu",
                    replaces="vog_tpu/kernels/attention.py:286", max_abs_err=err, **t,
                    bound_ms=bms, bound_by=by, shape=f"q,k,v {tuple(q.shape)} f32, no bias"))
    print(f"[kernels {tag}] flash_attention max_err={err:.3e} (no bias, spat bias, mixed-frame bias) "
          f"{fmt_times(t, 'sdpa')} bound={bms:.4f}{fmt_direct(t)}", flush=True)

    # -- mm shared-QK attention -------------------------------------------
    qm = q * (1.0 / dh**0.5)
    cn = -3.0 * torch.rand((B, H, A, T), generator=g, device=dev)
    err = 0.0
    for fid in (fid_spat, fid_mixed):
        got = mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid)
        ref = mm_attention.mm_attention_plain(qm, k, v, cn, mask, fb, fid)
        err = max(err, check_close("mm_shared_qk_attention", got[0], ref[0]))
        for x, y in zip(got[1:], ref[1:]):  # row max and denominator
            err = max(err, check_close("mm_shared_qk_attention stats", x[: B - 1], y[: B - 1]))
    q_rep, fmask = mm_sdpa_inputs(qm, cn, mask, fb, fid_spat)  # the 51 MB mask, built once
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q_rep, k, v, attn_mask=fmask, scale=1.0)
    ref = mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid_spat)[0]
    lib_rel = check_yardstick("mm_shared_qk_attention sdpa", sdpa().reshape(ref.shape), ref)
    t = timings(lambda: mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid_spat),
                lambda: mm_attention.mm_attention_plain(qm, k, v, cn, mask, fb, fid_spat), sdpa,
                reps, inner)
    t["direct_issue_ms"] = time_ms(lambda: mm_attention._mm_fwd_cuda(qm, k, v, cn, mask, fb, fid_spat, prec), reps,
                                   inner, queued=False)
    del q_rep, fmask
    fl = 2.0 * B * H * T * T * dh * (1 + A)
    out_b = B * H * A * T * (dh + 2) * 4
    bms, by = bound_ms(nbytes(qm, k, v, cn, mask, fb, fid_spat) + out_b, fl)
    out.append(dict(name="mm_shared_qk_attention", route="cuda", source="vog_tpu_torch/csrc/mm_attention.cu",
                    replaces="vog_tpu/kernels/mm_attention.py:315", max_abs_err=err, **t,
                    bound_ms=bms, bound_by=by, shape=f"qm,km,vm {tuple(qm.shape)}, A={A} f32",
                    library=f"SDPA, query repeated over A, float mask (B,H,A*T,T); rel err vs kernel {lib_rel:.2e}"))
    print(f"[kernels {tag}] mm_shared_qk_attention max_err={err:.3e} {fmt_times(t, 'sdpa')} "
          f"(sdpa rel err vs kernel {lib_rel:.2e}) bound={bms:.4f}{fmt_direct(t)}", flush=True)

    # -- fused grounding head ----------------------------------------------
    Dh = D // 2
    vis = torch.relu(torch.randn((B, T, D), generator=g, device=dev))
    arg = torch.relu(torch.randn((B, A, D), generator=g, device=dev))
    wx = torch.randn((D, D), generator=g, device=dev) / D**0.5
    w1 = torch.randn((D, Dh), generator=g, device=dev) / D**0.5
    b1 = torch.randn((Dh,), generator=g, device=dev) * 0.1
    w2 = torch.randn((Dh,), generator=g, device=dev) / Dh**0.5
    b2 = torch.randn((), generator=g, device=dev)
    wv = vis @ (torch.randn((D, D), generator=g, device=dev) / D**0.5)
    wl = arg @ (torch.randn((D, D), generator=g, device=dev) / D**0.5)
    args = (vis, arg, wv, wl, wx, w1, b1, w2, b2)
    err = check_close("fused_grounding_head", grounding_head.fused_grounding_head(*args),
                      grounding_head.grounding_head_plain(*args))
    t = timings(lambda: grounding_head.fused_grounding_head(*args),
                lambda: grounding_head.grounding_head_plain(*args), None, reps, inner)
    t["direct_issue_ms"] = time_ms(lambda: grounding_head._head_fwd_cuda(*args, prec), reps, inner, queued=False)
    fl = 2.0 * B * A * T * (D * D + D * Dh + Dh)
    bms, by = bound_ms(nbytes(*args) + B * A * T * 4, fl)
    out.append(dict(name="fused_grounding_head", route="cuda", source="vog_tpu_torch/csrc/grounding_head.cu",
                    replaces="vog_tpu/kernels/grounding_head.py:190", max_abs_err=err, **t,
                    bound_ms=bms, bound_by=by, shape=f"vis {tuple(vis.shape)}, A={A} f32"))
    print(f"[kernels {tag}] fused_grounding_head max_err={err:.3e} {fmt_times(t)} bound={bms:.4f}{fmt_direct(t)}",
          flush=True)
    return out


def make_requests(cfg, n: int, n_rows: int, vocab: int, seed: int):
    import numpy as np

    ds = cfg.ds
    V, F, P, A, L = ds.num_cmp, ds.num_frms, ds.num_prop_per_frm, ds.max_srl_args, ds.max_seq_len
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        xy = rng.uniform(0, 0.5, (V, F, P, 2))
        wh = rng.uniform(0.1, 0.5, (V, F, P, 2))
        boxes = np.concatenate([xy, xy + wh, wh[..., :1] * wh[..., 1:]], -1).astype(np.float32)
        pmask = np.ones((V, F, P), np.uint8)
        pmask[rng.integers(0, V), :, P - 1] = 0  # a padded proposal slot
        seq_len = int(rng.integers(6, L))
        tokens = np.zeros((L,), np.int32)
        tokens[:seq_len] = rng.integers(2, vocab, seq_len)
        starts = rng.integers(0, seq_len - 1, A)
        spans = np.stack([starts, np.minimum(starts + rng.integers(0, 3, A), seq_len - 1)], -1)
        reqs.append({
            "vid_rows": rng.integers(0, n_rows, (V,)).astype(np.int32),
            "prop_boxes": boxes,
            "prop_mask": pmask,
            "tokens": tokens,
            "seq_len": np.int32(seq_len),
            "verb_idx": np.int32(rng.integers(0, seq_len)),
            "srl_roles": rng.integers(1, ds.num_roles, (A,)).astype(np.int32),
            "srl_spans": spans.astype(np.int32),
            "srl_arg_mask": (np.arange(A) < rng.integers(2, A + 1)).astype(np.uint8),
        })
    return reqs


SERVE_PASSES = 3  # timed passes of the requests, after a discarded one


def cpu_outputs(cfg, sd, sub, tables) -> dict:
    """The Predictor's outputs for the request batch ``sub`` through the
    plain path on the CPU, with the weights ``sd`` and the features
    gathered from the card's tables (bf16 -> f32 is exact)."""
    import torch

    from vog_tpu_torch.data.device_store import gather_from_tables
    from vog_tpu_torch.serve import Predictor

    cpu = Predictor(cfg, {k: v.cpu() for k, v in sd.items()}, 5000, device="cpu")
    with torch.no_grad():
        g = gather_from_tables(
            {"vid_rows": torch.from_numpy(sub["vid_rows"]).cuda(),
             "prop_mask": torch.from_numpy(sub["prop_mask"]).cuda()}, tables.tables)
    full = {k: v for k, v in sub.items() if k != "vid_rows"}
    full["props"] = g["props"].cpu().numpy()
    full["seg_feats"] = g["seg_feats"].cpu().numpy()
    return cpu(full)


def phase_serve(cfg, tables, card: str, n_requests: int = 96, clients: int = 8, max_batch: int = 16,
                buckets=(1, 2, 4, 8), ref_on: str = "cpu", n_ref: int = 4, cuda_graphs: bool = True,
                score_tol=None, label: str = ""):
    """``n_requests`` vid_rows requests from ``clients`` threads through
    ``ServingLoop``: one pass discarded after ``prewarm``, then
    ``SERVE_PASSES`` timed passes (p50 / p95 / req/s of each, and their
    medians), the launches counted over the timed passes; every result
    checked for shape and finiteness, and the scores of the first ``n_ref`` against the same
    weights on the plain path: on the CPU (``ref_on="cpu"``), or on the
    card with every float kernel swapped for its plain version
    (``"plain"``: a T=4000 plain forward on the host is slow), within
    2e-4 * max(1, max|score|) (fp32), or ``score_tol`` * max|score| (the
    production numerics: the plain path in the same numerics).
    ``cuda_graphs``: the Predictor's forward as a CUDA graph per bucket
    (its default), or eager.  The float kernels must launch in the variant
    of ``misc.matmul_precision``, and no other."""
    import numpy as np
    import torch

    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.serving import ServingLoop

    prod = cfg.misc.matmul_precision == "default"
    tag = cfg.ds.exp_setting + label + (" prod" if prod else "") + ("" if cuda_graphs else ", cuda_graphs off")
    vocab = 5000
    pred = Predictor(cfg, None, vocab, tables=tables.tables, device="cuda", cuda_graphs=cuda_graphs)
    flushes = [0]
    dispatch = pred.dispatch

    def counted(batch):
        flushes[0] += 1
        return dispatch(batch)

    pred.dispatch = counted
    reqs = make_requests(cfg, n_requests, tables.n_rows, vocab, seed=0)
    loop = ServingLoop(pred, max_batch=max_batch, max_wait_ms=2.0, pipeline_depth=2,
                       bucket_sizes=list(buckets))

    def run_pass():
        """Every request once, from ``clients`` threads -> (results,
        latencies ms, wall s)."""
        results, lat, errors = [None] * n_requests, [0.0] * n_requests, []

        def client(c):
            try:
                for i in range(c, n_requests, clients):
                    t0 = time.perf_counter()
                    results[i] = loop(reqs[i])
                    lat[i] = (time.perf_counter() - t0) * 1e3
            except BaseException as e:  # re-raised below, after the threads end
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return results, lat, wall

    try:
        loop.prewarm(reqs[0])
        torch.cuda.synchronize()
        run_pass()  # discarded: the first pass after prewarm pays one-off costs
        _build.reset_counts()
        flushes[0] = 0
        passes = [run_pass() for _ in range(SERVE_PASSES)]
        counts = dict(_build.launches)
    finally:
        loop.close()
    results = passes[0][0]

    ds = cfg.ds
    V, F, P, A = ds.num_cmp, ds.num_frms, ds.num_prop_per_frm, ds.max_srl_args
    for out in (o for res, _, _ in passes for o in res):
        if out is None:
            fail("a request got no response")
        shapes = {"scores": (A, V, F, P), "pred_vid": (A, F), "pred_prop": (A, F),
                  "pred_box": (A, F, 4), "pred_score": (A, F)}
        for k, s in shapes.items():
            if out[k].shape != s:
                fail(f"{k} shape {out[k].shape} != {s}")
            if not np.isfinite(out[k]).all():
                fail(f"{k} is not finite")
    names = path_names(cfg, FWD_NAMES)
    for n in sorted(names):
        if counts.get(n, 0) <= 0:
            fail(f"kernel {n} was not launched on the serving path (counts {counts})")
    if set(counts) - set(names):
        fail(f"the serving path launched kernels of another precision or path: {counts}")

    sub = {k: np.stack([r[k] for r in reqs[:n_ref]]) for k in reqs[0]}
    sub["batch_mask"] = np.ones((n_ref,), np.uint8)
    if ref_on == "cpu":
        ref = cpu_outputs(cfg, pred.model.state_dict(), sub, tables)
    else:  # the same predictor on the card, eager (a replayed graph runs the kernels it captured),
        # its float kernels swapped for their plain versions
        undo = plain_kernels(FAMILIES)
        graphs, pred.cuda_graphs = pred.cuda_graphs, False
        try:
            ref = pred(sub)
        finally:
            pred.cuda_graphs = graphs
            undo()
    valid = sub["prop_mask"][:, None].astype(bool).repeat(A, 1)
    got = np.stack([results[i]["scores"] for i in range(n_ref)])
    top = float(np.abs(ref["scores"][valid]).max())
    err = float(np.abs(got[valid] - ref["scores"][valid]).max())
    # fp32 on both sides, sums in another order; or the production numerics on both
    tol = 2e-4 * max(1.0, top) if score_tol is None else score_tol * top
    if not err <= tol:
        fail(f"served scores differ from the plain path ({ref_on}): {err:.3e} > {tol:.3e}")
    cand = ref["scores"].transpose(0, 1, 3, 2, 4).reshape(n_ref, A, F, V * P)
    top2 = np.sort(cand, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
    for k in ("pred_vid", "pred_prop"):
        gk = np.stack([results[i][k] for i in range(n_ref)])
        if not np.array_equal(gk[clear], ref[k][clear]):
            fail(f"{k} differs from the plain path ({ref_on}) where the top-2 margin exceeds {2 * tol:.2e}")
    per = [dict(p50_ms=float(np.percentile(lat, 50)), p95_ms=float(np.percentile(lat, 95)),
                requests_per_s=n_requests / wall) for _, lat, wall in passes]
    med = {k: statistics.median(p[k] for p in per) for k in per[0]}
    print(f"[serve {tag}] {n_requests} requests, {clients} clients, max_batch {max_batch}, "
          f"{SERVE_PASSES} passes after a discarded one: p50 / p95 ms, req/s by pass: "
          + "; ".join(f"{p['p50_ms']:.2f} / {p['p95_ms']:.2f}, {p['requests_per_s']:.1f}" for p in per)
          + f"; median p50={med['p50_ms']:.2f} ms p95={med['p95_ms']:.2f} ms "
          f"{med['requests_per_s']:.1f} req/s on {card}", flush=True)
    print(f"[serve {tag}] launches on the serving path: {counts} over {flushes[0]} flushes "
          f"({SERVE_PASSES} passes); score max err "
          f"{err:.3e} against the plain path ({ref_on}) (tol {tol:.2e}), {int(clear.sum())}/{clear.size} "
          f"argmaxes compared", flush=True)
    return pred, reqs, counts, dict(med, passes=per, n_requests=n_requests, flushes=flushes[0],
                                    score_err=err, score_tol=tol)


KINK_EPS = 2e-5  # a ReLU input this close to 0 may take either side in another rounding
# the mm layer's FFN: 2,048 ReLUs a logit (the head has 768).  Sized by
# ``tools/train_parity_spread.py --regime p100`` (six seeds, both backward-
# mode pairs, trained states): at KINK_EPS the mask zeroes 7.1-7.9 % of the
# P100 logits, over MAX_KINK_SHARE; at 5e-6 3.2-3.7 %, with the kernels'
# worst relative gradient error at most 3.0e-3, under TRAIN_REL_TOL
FFN_KINK_EPS = 5e-6
MAX_KINK_SHARE = 0.05  # a check fails when more of its rows or logits than this are zeroed


def near_kinks(vis, arg, wv, wl, wx, w1, b1, eps: float = KINK_EPS):
    """(B, A, T) True where a pre-activation of the grounding head (z0 or z1,
    computed in fp64 from these inputs) lies within ``eps`` of its ReLU's kink."""
    import torch

    with torch.no_grad():
        d = lambda t: t.double()  # noqa: E731
        z0 = d(wv)[:, None] + d(wl)[:, :, None] + torch.matmul(d(vis)[:, None] * d(arg)[:, :, None], d(wx))
        z1 = torch.matmul(torch.relu(z0), d(w1)) + d(b1)
        return (z0.abs() < eps).any(-1) | (z1.abs() < eps).any(-1)


def away_from_kinks(vis, arg, wv, wl, wx, w1, b1, g, eps: float = KINK_EPS):
    """``g`` with zeros on the (b, a, t) rows of the grounding head where a
    pre-activation (z0 or z1, computed in fp64) lies within ``eps`` of its
    ReLU's kink, and the share of rows zeroed.  There two right
    implementations that round differently may take different sides of the
    kink and their gradients differ by a whole term; a check of the head's
    backward compares on the other rows only."""
    import torch

    near = near_kinks(vis, arg, wv, wl, wx, w1, b1, eps)
    return torch.where(near, torch.zeros_like(g), g), float(near.double().mean())


# the rows of each backward function, one a mode: (mode, its name, the TPU
# kernel it replaces), the JAX package's default mode first
BWD_MODES = {
    "flash_attention_bwd": (
        ("recompute", "flash_attention_bwd", "vog_tpu/kernels/attention.py:344"),
        ("emit", "flash_attention_bwd_emit", "vog_tpu/kernels/attention.py:165")),
    "mm_shared_qk_attention_bwd": (
        ("emit", "mm_shared_qk_attention_bwd", "vog_tpu/kernels/mm_attention.py:383"),
        ("recompute", "mm_shared_qk_attention_bwd_recompute", "vog_tpu/kernels/mm_attention.py:238")),
}


# each backward's outputs, for the checks' messages
OUT_NAMES = {
    "flash_attention_bwd": ("dq", "dk", "dv", "dfb"),
    "mm_shared_qk_attention_bwd": ("dq", "dk", "dv", "dcn", "dfb"),
    "fused_grounding_head_bwd": ("dvis", "darg", "dwv", "dwl", "dwx", "dw1", "db1", "dw2", "db2"),
}
OUT_NAMES.update({name: OUT_NAMES[fn] for fn, modes in BWD_MODES.items() for _, name, _ in modes})


def phase_kernels_bwd(cfg, B: int = 16):
    """Each backward kernel, in each of its modes, against its plain
    backward, and each plain backward against autograd of its plain
    forward, on the card at the training path's shapes; the two modes of a
    function against each other; returns the kernel table rows (one a
    mode: the modes compute the same function and share its bound)."""
    import torch

    from vog_tpu_torch.kernels import attention, grounding_head, mm_attention

    tag = cfg.ds.exp_setting
    reps, inner = TIMING[tag]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    V, F, P, A = cfg.ds.num_cmp, cfg.ds.num_frms, cfg.ds.num_prop_per_frm, cfg.ds.max_srl_args
    D, H = cfg.mdl.vis_dim, cfg.mdl.n_heads
    dh, T = D // H, F * V * P
    out = []

    def autograd_of(fwd, args, diff, cot):
        xs = [a.detach().clone().requires_grad_(i in diff) if a is not None else None
              for i, a in enumerate(args)]
        return torch.autograd.grad(fwd(*xs), [xs[i] for i in diff], cot)

    def mode_rows(fn, got_by_mode, timed, lib, lib_note, bound, base):
        """One row a mode of ``fn``'s backward (the plain version and the
        library call timed once for both); prints the modes' gap."""
        gap = max(max_err(x, y) for x, y in zip(*got_by_mode.values()))
        shared = timings(None, lambda: timed(None, plain=True), lib, reps, inner)
        for mode, name, replaces in BWD_MODES[fn]:
            t = {**shared, **{k: v for k, v in timings(lambda: timed(mode), None, None, reps, inner).items()
                               if k in ("ms", "issue_ms")}}
            out.append(dict(name=name, mode=mode, replaces=replaces, max_abs_err=base[mode], **t,
                            bound_ms=bound[0], bound_by=bound[1], modes_max_abs_diff=gap, library=lib_note,
                            **base["row"]))
            print(f"[kernels-bwd {tag}] {name} ({mode}) max_err={base[mode]:.3e} {fmt_times(t, 'sdpa-bwd')} "
                  f"bound={bound[0]:.4f}", flush=True)
        print(f"[kernels-bwd {tag}] {fn}: max |emit - recompute| {gap:.3e} over the outputs", flush=True)

    # -- flash attention backward -----------------------------------------
    q, k, v = (torch.randn((B, H, T, dh), generator=g, device=dev) for _ in range(3))
    mask = (torch.rand((B, T), generator=g, device=dev) > 0.2).float()
    mask[:, 0] = 1.0
    mask[B - 1] = 0.0  # one batch row with every key masked
    fid_spat = (torch.arange(T, device=dev) // (V * P)).to(torch.int32)
    fid_mixed = torch.randint(0, F, (T,), generator=g, device=dev, dtype=torch.int32)
    fb = torch.randn((H, F, F), generator=g, device=dev) * 0.5
    do = torch.randn((B, H, T, dh), generator=g, device=dev)
    err = {"recompute": 0.0, "emit": 0.0}
    for bias, fid in ((None, None), (fb, fid_spat), (fb, fid_mixed)):
        o, lse = attention.flash_attention_fwd(q, k, v, mask, bias, fid)
        ref = attention.flash_attention_bwd_plain(q, k, v, mask, bias, fid, o, lse, do)
        diff = (0, 1, 2) if bias is None else (0, 1, 2, 4)
        auto = autograd_of(lambda *a: attention.flash_attention_plain(*a)[0],
                           (q, k, v, mask, bias, fid), diff, do)
        for out_name, y, z in zip(OUT_NAMES["flash_attention_bwd"], ref, auto):
            check_close(f"flash_attention_bwd_plain {out_name} vs autograd", y, z)
        got = {}
        for mode, name, _ in BWD_MODES["flash_attention_bwd"]:
            # without a bias the frame-bias gradient is not returned (autograd gives none)
            got[mode] = attention.flash_attention_bwd(q, k, v, mask, bias, fid, o, lse, do,
                                                      bwd_mode=mode)[: len(diff)]
            for out_name, x, y in zip(OUT_NAMES[name], got[mode], ref):
                err[mode] = max(err[mode], check_close(f"{name} {out_name}", x, y))
    o, lse = attention.flash_attention_fwd(q, k, v, mask)
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    sd = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=(mask > 0)[:, None, None, :])
    fl = 10.0 * B * H * T * T * dh  # S, dP, dV, dK, dQ: 2*T*T*dh each, from the saved o and lse
    bound = bound_ms(nbytes(q, k, v, o, do, lse, mask) + 3 * nbytes(q), fl)
    err["row"] = dict(route="cuda", source="vog_tpu_torch/csrc/attention.cu",
                      shape=f"q,k,v {tuple(q.shape)} f32, no bias (checked also with bias)")
    mode_rows("flash_attention_bwd", got,
              lambda mode, plain=False: (attention.flash_attention_bwd_plain if plain else
                                         attention.flash_attention_bwd)(
                  q, k, v, mask, None, None, o, lse, do, bwd_mode=mode),
              lambda: torch.autograd.grad(sd, (qs, ks, vs), do, retain_graph=True),
              "SDPA backward, no bias", bound, err)
    del qs, ks, vs, sd

    # -- mm shared-QK attention backward ----------------------------------
    qm = q * (1.0 / dh**0.5)
    cn = -3.0 * torch.rand((B, H, A, T), generator=g, device=dev)
    gm = torch.randn((B, H, A, T, dh), generator=g, device=dev)
    err = {"recompute": 0.0, "emit": 0.0}
    for fid in (fid_spat, fid_mixed):
        fwd = mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid)
        ref = mm_attention.mm_attention_bwd_plain(qm, k, v, cn, mask, fb, fid, *fwd, gm)
        auto = autograd_of(lambda *a: mm_attention.mm_attention_plain(*a)[0],
                           (qm, k, v, cn, mask, fb, fid), (0, 1, 2, 3, 5), gm)
        for out_name, y, z in zip(OUT_NAMES["mm_shared_qk_attention_bwd"], ref, auto):
            check_close(f"mm_shared_qk_attention_bwd_plain {out_name} vs autograd", y, z)
        del auto
        got = {}
        for mode, name, _ in BWD_MODES["mm_shared_qk_attention_bwd"]:
            got[mode] = mm_attention.mm_attention_bwd(qm, k, v, cn, mask, fb, fid, *fwd, gm, bwd_mode=mode)
            for out_name, x, y in zip(OUT_NAMES[name], got[mode], ref):
                err[mode] = max(err[mode], check_close(f"{name} {out_name}", x, y))
        del ref
    fwd = mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid_spat)
    # yardstick: SDPA's backward over the repeated query, k, v and the float
    # mask (whose gradient carries dcn and dfb)
    q_rep, fmask = mm_sdpa_inputs(qm, cn, mask, fb, fid_spat)
    leaves = [x.detach().clone().requires_grad_() for x in (q_rep, k, v, fmask)]
    del q_rep, fmask
    sd = torch.nn.functional.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)
    check_yardstick("mm_shared_qk_attention_bwd sdpa", sd.detach().reshape(fwd[0].shape), fwd[0])
    gsd = gm.reshape(sd.shape)
    lib = lambda: torch.autograd.grad(sd, leaves, gsd, retain_graph=True)  # noqa: E731
    try:
        if lib()[3] is None:
            raise RuntimeError("no gradient for the float mask")
        lib_note = "SDPA backward, grads of q (repeated), k, v and the float mask"
    except RuntimeError as e:  # the backend gives the mask no gradient
        lib, lib_note = None, f"none: SDPA gives the float mask no gradient ({str(e)[:120]})"
    fl = 2.0 * B * H * T * T * dh * (3 + 2 * A)
    bound = bound_ms(nbytes(qm, k, v, cn, mask, fb, gm, *fwd) + 3 * nbytes(q) + nbytes(cn), fl)
    err["row"] = dict(route="cuda", source="vog_tpu_torch/csrc/mm_attention.cu",
                      shape=f"qm,km,vm {tuple(qm.shape)}, A={A} f32")
    mode_rows("mm_shared_qk_attention_bwd", got,
              lambda mode, plain=False: (mm_attention.mm_attention_bwd_plain if plain else
                                         mm_attention.mm_attention_bwd)(
                  qm, k, v, cn, mask, fb, fid_spat, *fwd, gm, bwd_mode=mode),
              lib, lib_note, bound, err)
    del leaves, sd, gsd, lib, got

    # -- fused grounding head backward ------------------------------------
    Dh = D // 2
    vis = torch.relu(torch.randn((B, T, D), generator=g, device=dev))
    arg = torch.relu(torch.randn((B, A, D), generator=g, device=dev))
    wx = torch.randn((D, D), generator=g, device=dev) / D**0.5
    w1 = torch.randn((D, Dh), generator=g, device=dev) / D**0.5
    b1 = torch.randn((Dh,), generator=g, device=dev) * 0.1
    w2 = torch.randn((Dh,), generator=g, device=dev) / Dh**0.5
    b2 = torch.randn((1,), generator=g, device=dev)
    wv = vis @ (torch.randn((D, D), generator=g, device=dev) / D**0.5)
    wl = arg @ (torch.randn((D, D), generator=g, device=dev) / D**0.5)
    args = (vis, arg, wv, wl, wx, w1, b1, w2, b2)
    gh, kink = away_from_kinks(*args[:7], torch.randn((B, A, T), generator=g, device=dev))
    if kink > 0.05:
        fail(f"fused_grounding_head_bwd: {kink:.3f} of the rows lie near a ReLU kink")
    got = grounding_head.grounding_head_bwd(*args, gh)
    ref = grounding_head.grounding_head_bwd_plain(*args, gh)
    auto = autograd_of(grounding_head.grounding_head_plain, args, tuple(range(9)), gh)
    err = 0.0
    for out_name, x, y, z in zip(OUT_NAMES["fused_grounding_head_bwd"], got, ref, auto):
        err = max(err, check_close(f"fused_grounding_head_bwd {out_name}", x, y))
        check_close(f"fused_grounding_head_bwd_plain {out_name} vs autograd", y, z)
    t = timings(lambda: grounding_head.grounding_head_bwd(*args, gh),
                lambda: grounding_head.grounding_head_bwd_plain(*args, gh), None, reps, inner)
    fl = 6.0 * B * A * T * (D * D + D * Dh)
    bms, by = bound_ms(2 * nbytes(*args) + nbytes(gh), fl)
    out.append(dict(name="fused_grounding_head_bwd", route="cuda",
                    source="vog_tpu_torch/csrc/grounding_head.cu",
                    replaces="vog_tpu/kernels/grounding_head.py:218", max_abs_err=err, **t,
                    bound_ms=bms, bound_by=by,
                    shape=f"vis {tuple(vis.shape)}, A={A} f32, all 9 grads; {kink:.4f} of rows near a kink"))
    print(f"[kernels-bwd {tag}] fused_grounding_head_bwd max_err={err:.3e} {fmt_times(t)} "
          f"bound={bms:.4f} (g zeroed on {kink:.4f} of rows near a ReLU kink)", flush=True)
    return out


def thread_calls(B: int, H: int, T: int, dh: int, F: int, A: int, D: int, seed: int = 3) -> dict:
    """Every kernel wrapper on seeded inputs on the card: the four forwards
    (through their ops) and each backward through autograd, flash and mm
    in both modes -> {name: a call returning a tuple of tensors}."""
    import torch

    from vog_tpu_torch.kernels import attention, gather, grounding_head, mm_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    table = rnd(64, 40, 128).to(torch.bfloat16)
    rows = torch.randint(0, 64, (B, 4), generator=g, device=dev, dtype=torch.int32)
    q, k, v, do = rnd(B, H, T, dh), rnd(B, H, T, dh), rnd(B, H, T, dh), rnd(B, H, T, dh)
    mask = (torch.rand((B, T), generator=g, device=dev) > 0.2).float()
    mask[:, 0] = 1.0
    fb = rnd(H, F, F) * 0.5
    fid = torch.randint(0, F, (T,), generator=g, device=dev, dtype=torch.int32)
    qm, cn, gm = q * dh**-0.5, -3.0 * torch.rand((B, H, A, T), generator=g, device=dev), rnd(B, H, A, T, dh)
    Dh = D // 2
    vis, arg = torch.relu(rnd(B, T, D)), torch.relu(rnd(B, A, D))
    head = (vis, arg, vis @ (rnd(D, D) / D**0.5), arg @ (rnd(D, D) / D**0.5), rnd(D, D) / D**0.5,
            rnd(D, Dh) / D**0.5, rnd(Dh) * 0.1, rnd(Dh) / Dh**0.5, rnd(1))
    gh = rnd(B, A, T)

    def grad_of(fn, leaves, cot):
        xs = [x.detach().clone().requires_grad_() for x in leaves]
        return torch.autograd.grad(fn(*xs), xs, cot)

    calls = {
        "gather_rows": lambda: (gather.gather_rows(table, rows),),
        "flash_attention": lambda: attention.flash_attention_fwd(q, k, v, mask, fb, fid),
        "mm_shared_qk_attention": lambda: mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid),
        "fused_grounding_head": lambda: (grounding_head.grounding_head_fwd(*head),),
        "fused_grounding_head_bwd": lambda: grad_of(grounding_head.fused_grounding_head, head, gh),
    }
    for mode in ("recompute", "emit"):
        calls[f"flash_attention_bwd ({mode})"] = lambda mode=mode: grad_of(
            lambda q_, k_, v_, fb_: attention.flash_attention(q_, k_, v_, mask, fb_, fid, bwd_mode=mode),
            (q, k, v, fb), do)
        calls[f"mm_shared_qk_attention_bwd ({mode})"] = lambda mode=mode: grad_of(
            lambda q_, k_, v_, cn_, fb_: mm_attention.mm_shared_qk_attention(q_, k_, v_, cn_, mask, fb_, fid,
                                                                            bwd_mode=mode),
            (qm, k, v, cn, fb), gm)
    return calls


def fresh_thread_mismatches(calls: dict) -> list:
    """Run every call on this thread, then all of them again on a fresh
    ``threading.Thread`` (its backwards on autograd's worker thread) ->
    the names whose outputs are not bitwise the first run's."""
    import torch

    first = {n: [t.clone() for t in fn()] for n, fn in calls.items()}
    torch.cuda.synchronize()
    again, errors = {}, []

    def body():
        try:
            for n, fn in calls.items():
                again[n] = fn()
            torch.cuda.synchronize()
        except BaseException as e:  # surfaced on the calling thread below
            errors.append(e)

    th = threading.Thread(target=body)
    th.start()
    th.join()
    if errors:
        raise errors[0]
    return [n for n in calls if len(again[n]) != len(first[n])
            or not all(torch.equal(a, b) for a, b in zip(first[n], again[n]))]


def phase_threads(cfg) -> None:
    """[threads gt5]: every kernel wrapper and its backward, at both
    precisions, from a fresh thread bitwise as from the main thread (the
    device guard of each C entry point, ``csrc/device.cuh``)."""
    V, F, P, A = cfg.ds.num_cmp, cfg.ds.num_frms, cfg.ds.num_prop_per_frm, cfg.ds.max_srl_args
    D, H = cfg.mdl.vis_dim, cfg.mdl.n_heads
    for prec, on in (("highest", False), ("default", True)):
        with tf32(on):
            calls = thread_calls(16, H, F * V * P, D // H, F, A, D)
            bad = fresh_thread_mismatches(calls)
        if bad:
            fail(f"[threads gt5] {prec}: not bitwise on a fresh thread: {bad}")
        print(f"[threads gt5] {prec}: {len(calls)} wrappers ({', '.join(calls)}) on a fresh thread bitwise as on "
              "the main thread", flush=True)


def head_bwd_given(args, g, h_kernel, dz1_kernel):
    """The plain head backward in fp64 with the ReLU decisions of the
    kernel's row pass ([z0 > 0] from its h, [z1 > 0] from its dz1 where
    g w2 != 0) -> (the 9 gradients, the shares of z0 and z1 whose decision
    differs from fp64's).  One TF32 pass moves a pre-activation by ~1e-3 of
    its terms, so some lie across a kink from fp64 (a few 1e-4 of them,
    with most rows touching one); through such an element a whole term of a
    gradient flips.  Given the kernel's decisions the comparison holds its
    arithmetic, as the fp32 checks zero the cotangent near a kink
    (``away_from_kinks``)."""
    import torch

    vis, arg, wv, wl, wx, w1, b1, w2, b2 = (a.double() for a in args)
    cross = vis[:, None] * arg[:, :, None]
    z0 = wv[:, None] + wl[:, :, None] + torch.matmul(cross, wx)
    h = torch.relu(z0)
    z1 = torch.matmul(h, w1) + b1
    gg = g.double()[..., None]
    m0, m1 = h_kernel > 0, dz1_kernel != 0
    live = (gg * w2) != 0
    flips = (float((m0 != (z0 > 0)).double().mean()), float(((m1 != (z1 > 0)) & live).double().mean()))
    dz1 = torch.where(m1, gg * w2, torch.zeros_like(z1))
    dz0 = torch.where(m0, torch.matmul(dz1, w1.t()), torch.zeros_like(z0))
    dcross = torch.matmul(dz0, wx.t())
    D, Dh = wx.shape[0], w1.shape[1]
    grads = ((dcross * arg[:, :, None]).sum(1), (dcross * vis[:, None]).sum(2), dz0.sum(1), dz0.sum(2),
             torch.matmul(cross.reshape(-1, D).t(), dz0.reshape(-1, D)),
             torch.matmul(h.reshape(-1, D).t(), dz1.reshape(-1, Dh)), dz1.reshape(-1, Dh).sum(0),
             (torch.relu(z1) * gg).reshape(-1, Dh).sum(0), g.double().sum().reshape(b2.shape))
    return grads, flips


def phase_kernels_default(cfg, B: int = 16):
    """[kernels <tag> default]: each kernel's "default" variant (one TF32
    pass; the products around it with TF32 on), forward and backward in
    both modes, against its plain version at "highest" (TF32 off) on the
    same inputs (``check_default``); the head backward given its row pass's
    ReLU decisions (``head_bwd_given``).  Times as phases 3 and 6, with the
    plain version and the library call under TF32, and the bound at
    495 TFLOP/s.  -> the kernel table rows (without launches)."""
    import torch

    from vog_tpu_torch.kernels import attention, grounding_head, mm_attention

    tag = cfg.ds.exp_setting
    reps, inner = TIMING[tag]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    V, F, P, A = cfg.ds.num_cmp, cfg.ds.num_frms, cfg.ds.num_prop_per_frm, cfg.ds.max_srl_args
    D, H = cfg.mdl.vis_dim, cfg.mdl.n_heads
    dh, T = D // H, F * V * P
    d = "default"
    out = []

    def plain(fn):
        with tf32(False):
            return fn()

    def kern(fn):
        with tf32(True):
            return fn()

    def row(name, src, replaces, errs, t, fl, nb, shape, library=None):
        bms, by = bound_ms(nb, fl, TF32_FLOP_PER_S)
        r = dict(name=f"{name}@default", precision=d, route="cuda", source=f"vog_tpu_torch/csrc/{src}",
                 replaces=replaces, max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
                 frobenius_rel_err=max(e[2] for e in errs), **t, bound_ms=bms, bound_by=by, shape=shape,
                 library=library)
        out.append(r)
        print(f"[kernels {tag} default] {r['name']} relative max-diff {r['max_rel_err']:.3e} Frobenius "
              f"{r['frobenius_rel_err']:.3e} (max |err| {r['max_abs_err']:.3e}) {fmt_times(t, 'library')} "
              f"bound={bms:.4f} (TF32)", flush=True)

    def wg_row(errs, t, shared):
        """The emit backward's dk/dv/dcn kernel, mm_bwd_dkv_wg, as a row of
        its own: its device ms a launch from a profiler run of the emit
        backward (``launch_ms``; its split by kernel, ``bwd_by_kernel``,
        beside it), errors the emit backward's (dk, dv, dcn, and dq and dfb
        through its comb), the plain backward's time beside it;
        its bound: its products, 2 BH T^2 dh (2 + 2A), and its bytes (the
        row matrices, g, the statistics in; dk, dv, dcn, bf16 comb out).
        No PyTorch call computes dk, dv, dcn and comb alone."""
        call = lambda: mm_attention.mm_attention_bwd(  # noqa: E731
            qm, k, v, cn, mask, fb, fid_spat, *fwd, gm, bwd_mode="emit", precision=d)
        split = kern(lambda: bwd_by_kernel(call, reps, inner))
        ms = kern(lambda: launch_ms(call, (mm_attention.NAME_WG,), reps))[mm_attention.NAME_WG]
        if ms is None:
            fail(f"[kernels {tag} default] no device time of {mm_attention.NAME_WG} in the profile: {split}")
        bms, by = bound_ms(nbytes(qm, k, v, cn, mask, fb, fid_spat, gm, fwd[1], fwd[2]) + 2 * nbytes(cn)
                           + 2 * nbytes(qm) + B * H * T * T * 2, 2.0 * B * H * T * T * dh * (2 + 2 * A),
                           TF32_FLOP_PER_S)
        r = dict(name=f"{mm_attention.NAME_WG}@default", precision=d, route="cuda",
                 source="vog_tpu_torch/csrc/mm_attention.cu", replaces="vog_tpu/kernels/mm_attention.py:430",
                 max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
                 frobenius_rel_err=max(e[2] for e in errs), ms=ms, issue_ms=None,
                 plain_ms=shared["plain_ms"], plain_issue_ms=shared["plain_issue_ms"], library_ms=None,
                 library_issue_ms=None, bound_ms=bms, bound_by=by, by_kernel=split["by_kernel"],
                 emit_backward_ms=t["ms"], shape=f"qm,km,vm {tuple(qm.shape)}, A={A}, emit, comb bf16", library=None)
        out.append(r)
        print(f"[kernels {tag} default] {r['name']} (the emit backward's dk/dv/dcn kernel: its checks above) "
              f"device ms={ms:.4f} (a launch, profiler; the emit backward {t['ms']:.4f}: "
              + ", ".join(f"{kk} {vv:.4f}" for kk, vv in split["by_kernel"].items())
              + f") plain backward={shared['plain_ms']:.4f} bound={bms:.4f} ({by}, TF32) library=none", flush=True)

    def wg_fwd_row(errs, t):
        """The forward's kernel on the "wg" route, mm_fwd_wg (its pass before
        it, mm_fwd_prep_wg, rounds km to TF32), as a row of its own: the
        "default" forward's device and with-issue ms (the wrapper's row
        above: one prep pass, then a launch of mm_fwd_wg a group of
        ``fwd_groups``), the kernel's own device ms a launch and the pass's
        from a profiler run (``launch_ms``; the run fails without them),
        errors the forward's (out, row max, den), the plain version's and
        SDPA x A's times beside it; its bound, for the whole call: 2 BH T^2
        dh (1 + A) operations at 495 TFLOP/s against its bytes (qm, km, vm,
        cn, mask, frames in; out, row max, den out)."""
        call = lambda: mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid_spat, precision=d)  # noqa: E731
        groups = mm_attention.fwd_groups(A, dh, d)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        got = kern(lambda: launch_ms(call, (mm_attention.NAME_FWD_WG, "mm_fwd_prep_wg"), reps))
        kms, pms = got[mm_attention.NAME_FWD_WG], got["mm_fwd_prep_wg"]
        if kms is None or pms is None:
            fail(f"[kernels {tag} default] no device time of {mm_attention.NAME_FWD_WG} or its prep pass in the "
                 f"profile: {got}")
        bms, by = bound_ms(nbytes(qm, k, v, cn, mask, fb, fid_spat) + B * H * A * T * (dh + 2) * 4,
                           2.0 * B * H * T * T * dh * (1 + A), TF32_FLOP_PER_S)
        r = dict(name=f"{mm_attention.NAME_FWD_WG}@default", precision=d, route="cuda",
                 source="vog_tpu_torch/csrc/mm_attention.cu", replaces="vog_tpu/kernels/mm_attention.py:322",
                 max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
                 frobenius_rel_err=max(e[2] for e in errs), ms=t["ms"], issue_ms=t["issue_ms"],
                 kernel_ms=kms, prep_ms=pms, plain_ms=t["plain_ms"], plain_issue_ms=t["plain_issue_ms"],
                 library_ms=t["library_ms"], library_issue_ms=t["library_issue_ms"], bound_ms=bms, bound_by=by,
                 waves=-(-T // mm_attention.FW_ROWS) * B * H / sms,
                 launches_a_call=len(groups), shape=f"qm,km,vm {tuple(qm.shape)}, A={A} f32, {len(groups)} "
                 f"launch(es) of mm_fwd_wg ({'+'.join(str(a1 - a0) for a0, a1 in groups)} args)",
                 library="SDPA, query repeated over A, float mask, TF32")
        out.append(r)
        print(f"[kernels {tag} default] {r['name']} (the \"default\" forward at dh <= 128: its checks above) "
              f"device ms={r['ms']:.4f} w/ issue {r['issue_ms']:.4f} a call (profiler: mm_fwd_wg {kms:.4f} a "
              f"launch, {len(groups)} a call, mm_fwd_prep_wg {pms:.4f}; {r['waves']:.2f} waves of 64-row blocks) "
              f"plain={r['plain_ms']:.4f} sdpa x A={r['library_ms']:.4f} bound={bms:.4f} ({by}, TF32)", flush=True)

    # -- flash attention, forward and backward ----------------------------
    q, k, v = (torch.randn((B, H, T, dh), generator=g, device=dev) for _ in range(3))
    mask = (torch.rand((B, T), generator=g, device=dev) > 0.2).float()
    mask[:, 0] = 1.0
    fid_spat = (torch.arange(T, device=dev) // (V * P)).to(torch.int32)
    fb = torch.randn((H, F, F), generator=g, device=dev) * 0.5
    fid_mixed = torch.randint(0, F, (T,), generator=g, device=dev, dtype=torch.int32)
    errs = []
    for bias, fid in ((None, None), (fb, fid_spat), (fb, fid_mixed)):
        o, lse = kern(lambda: attention.flash_attention_fwd(q, k, v, mask, bias, fid, precision=d))
        ro, rl = plain(lambda: attention.flash_attention_plain(q, k, v, mask, bias, fid))
        errs += [check_default("flash_attention@default", o, ro, True),
                 check_default("flash_attention@default lse", lse, rl, True)]
    bmask = (mask > 0)[:, None, None, :]
    t = kern(lambda: timings(lambda: attention.flash_attention_fwd(q, k, v, mask, precision=d),
                             lambda: attention.flash_attention_plain(q, k, v, mask),
                             lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bmask),
                             reps, inner))
    row("flash_attention", "attention.cu", "vog_tpu/kernels/attention.py:286", errs, t,
        4.0 * B * H * T * T * dh, nbytes(q, k, v, mask) + nbytes(q) + B * H * T * 4,
        f"q,k,v {tuple(q.shape)} f32, no bias (checked also with bias)", "SDPA, bool mask, TF32")
    do = torch.randn((B, H, T, dh), generator=g, device=dev)
    ro, rl = plain(lambda: attention.flash_attention_plain(q, k, v, mask))
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    sd = kern(lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=bmask))
    shared = kern(lambda: timings(
        None, lambda: attention.flash_attention_bwd_plain(q, k, v, mask, None, None, ro, rl, do),
        lambda: torch.autograd.grad(sd, (qs, ks, vs), do, retain_graph=True), reps, inner))
    for mode, name, replaces in BWD_MODES["flash_attention_bwd"]:
        errs = []
        for bias, fid in ((None, None), (fb, fid_spat)):
            bo, bl = plain(lambda: attention.flash_attention_plain(q, k, v, mask, bias, fid))
            ref = plain(lambda: attention.flash_attention_bwd_plain(q, k, v, mask, bias, fid, bo, bl, do))
            got = kern(lambda: attention.flash_attention_bwd(q, k, v, mask, bias, fid, bo, bl, do,
                                                             bwd_mode=mode, precision=d))
            n = 3 if bias is None else 4
            errs += [check_default(f"{name}@default {on}", x, y, False)
                     for on, x, y in zip(OUT_NAMES[name][:n], got[:n], ref[:n])]
        t = {**shared, **{kk: vv for kk, vv in kern(lambda: timings(
            lambda: attention.flash_attention_bwd(q, k, v, mask, None, None, ro, rl, do, bwd_mode=mode,
                                                  precision=d), None, None, reps, inner)).items()
            if kk in ("ms", "issue_ms")}}
        row(name, "attention.cu", replaces, errs, t, 10.0 * B * H * T * T * dh,
            nbytes(q, k, v, ro, do, rl, mask) + 3 * nbytes(q),
            f"q,k,v {tuple(q.shape)} f32, {mode}" + (", ds bf16" if mode == "emit" else ""),
            "SDPA backward, no bias, TF32")
    del qs, ks, vs, sd

    # -- mm shared-QK attention, forward and backward ---------------------
    qm = q * (1.0 / dh**0.5)
    cn = -3.0 * torch.rand((B, H, A, T), generator=g, device=dev)
    errs = []
    for fid in (fid_spat, fid_mixed):
        got = kern(lambda: mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid, precision=d))
        ref = plain(lambda: mm_attention.mm_attention_plain(qm, k, v, cn, mask, fb, fid))
        errs += [check_default(f"mm_shared_qk_attention@default {on}", x, y, True)
                 for on, x, y in zip(("out", "max", "den"), got, ref)]
    q_rep, fmask = mm_sdpa_inputs(qm, cn, mask, fb, fid_spat)
    t = kern(lambda: timings(
        lambda: mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid_spat, precision=d),
        lambda: mm_attention.mm_attention_plain(qm, k, v, cn, mask, fb, fid_spat),
        lambda: torch.nn.functional.scaled_dot_product_attention(q_rep, k, v, attn_mask=fmask, scale=1.0),
        reps, inner))
    row("mm_shared_qk_attention", "mm_attention.cu", "vog_tpu/kernels/mm_attention.py:315", errs, t,
        2.0 * B * H * T * T * dh * (1 + A),
        nbytes(qm, k, v, cn, mask, fb, fid_spat) + B * H * A * T * (dh + 2) * 4,
        f"qm,km,vm {tuple(qm.shape)}, A={A} f32", "SDPA, query repeated over A, float mask, TF32")
    if mm_attention.fwd_route(d, dh) == "wg":
        wg_fwd_row(errs, t)
    gm = torch.randn((B, H, A, T, dh), generator=g, device=dev)
    fwd = plain(lambda: mm_attention.mm_attention_plain(qm, k, v, cn, mask, fb, fid_spat))
    leaves = [x.detach().clone().requires_grad_() for x in (q_rep, k, v, fmask)]
    del q_rep, fmask
    sd = kern(lambda: torch.nn.functional.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                                                       scale=1.0))
    gsd = gm.reshape(sd.shape)
    lib = lambda: torch.autograd.grad(sd, leaves, gsd, retain_graph=True)  # noqa: E731
    try:
        if kern(lib)[3] is None:
            raise RuntimeError("no gradient for the float mask")
    except RuntimeError:
        lib = None
    shared = kern(lambda: timings(
        None, lambda: mm_attention.mm_attention_bwd_plain(qm, k, v, cn, mask, fb, fid_spat, *fwd, gm),
        lib, reps, inner))
    del leaves, sd, gsd, lib
    wg_fed = lambda mode: (mode == "emit" and mm_attention.bwd_route(mode, d, dh) == "wg"  # noqa: E731
                           and mm_attention.fwd_route(d, dh) == "wg")
    for mode, name, replaces in BWD_MODES["mm_shared_qk_attention_bwd"]:
        errs = []
        for fid in (fid_spat, fid_mixed):
            fw = plain(lambda: mm_attention.mm_attention_plain(qm, k, v, cn, mask, fb, fid))
            ref = plain(lambda: mm_attention.mm_attention_bwd_plain(qm, k, v, cn, mask, fb, fid, *fw, gm))
            got = kern(lambda: mm_attention.mm_attention_bwd(qm, k, v, cn, mask, fb, fid, *fw, gm,
                                                             bwd_mode=mode, precision=d))
            errs += [check_default(f"{name}@default {on}", x, y, False)
                     for on, x, y in zip(OUT_NAMES[name], got, ref)]
            if wg_fed(mode):  # fed by the "default" forward's out, row max and denominator (mm_fwd_wg's)
                fk = kern(lambda: mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid, precision=d))
                got = kern(lambda: mm_attention.mm_attention_bwd(qm, k, v, cn, mask, fb, fid, *fk, gm,
                                                                 bwd_mode=mode, precision=d))
                fed = [check_default(f"{name}@default {on} (fed by {mm_attention.NAME_FWD_WG})", x, y, False)
                       for on, x, y in zip(OUT_NAMES[name], got, ref)]
                errs += fed
                print(f"[kernels {tag} default] {name}@default fed by {mm_attention.NAME_FWD_WG}'s out, row max and "
                      f"den: relative max-diff {max(e[1] for e in fed):.3e} Frobenius {max(e[2] for e in fed):.3e} "
                      f"(limits {DEFAULT_GRAD_TOL:.0e}, {DEFAULT_FRO_TOL:.0e})", flush=True)
                del fk
            del fw, ref, got
        t = {**shared, **{kk: vv for kk, vv in kern(lambda: timings(
            lambda: mm_attention.mm_attention_bwd(qm, k, v, cn, mask, fb, fid_spat, *fwd, gm, bwd_mode=mode,
                                                  precision=d), None, None, reps, inner)).items()
            if kk in ("ms", "issue_ms")}}
        row(name, "mm_attention.cu", replaces, errs, t, 2.0 * B * H * T * T * dh * (3 + 2 * A),
            nbytes(qm, k, v, cn, mask, fb, gm, *fwd) + 3 * nbytes(q) + nbytes(cn),
            f"qm,km,vm {tuple(qm.shape)}, A={A} f32, {mode}" + (", comb bf16" if mode == "emit" else ""),
            "SDPA backward over the repeated query and the float mask, TF32" if shared["library_ms"] else None)
        if mode == "emit" and mm_attention.bwd_route(mode, d, dh) == "wg":
            wg_row(errs, t, shared)
    del fwd, gm

    # -- fused grounding head, forward and backward -----------------------
    Dh = D // 2
    vis = torch.relu(torch.randn((B, T, D), generator=g, device=dev))
    arg = torch.relu(torch.randn((B, A, D), generator=g, device=dev))
    wx = torch.randn((D, D), generator=g, device=dev) / D**0.5
    w1 = torch.randn((D, Dh), generator=g, device=dev) / D**0.5
    b1 = torch.randn((Dh,), generator=g, device=dev) * 0.1
    w2 = torch.randn((Dh,), generator=g, device=dev) / Dh**0.5
    b2 = torch.randn((1,), generator=g, device=dev)
    wv = vis @ (torch.randn((D, D), generator=g, device=dev) / D**0.5)
    wl = arg @ (torch.randn((D, D), generator=g, device=dev) / D**0.5)
    args = (vis, arg, wv, wl, wx, w1, b1, w2, b2)
    got = kern(lambda: grounding_head.grounding_head_fwd(*args, precision=d))
    errs = [check_default("fused_grounding_head@default", got,
                          plain(lambda: grounding_head.grounding_head_plain(*args)), True)]
    t = kern(lambda: timings(lambda: grounding_head.grounding_head_fwd(*args, precision=d),
                             lambda: grounding_head.grounding_head_plain(*args), None, reps, inner))
    row("fused_grounding_head", "grounding_head.cu", "vog_tpu/kernels/grounding_head.py:190", errs, t,
        2.0 * B * A * T * (D * D + D * Dh + Dh), nbytes(*args) + B * A * T * 4, f"vis {tuple(vis.shape)}, A={A} f32")
    gh = torch.randn((B, A, T), generator=g, device=dev)
    scratch = {}
    got = kern(lambda: grounding_head.grounding_head_bwd(*args, gh, precision=d, scratch=scratch))
    ref, flips = head_bwd_given(args, gh, scratch["h"], scratch["dz1"])
    del scratch
    errs = [check_default(f"fused_grounding_head_bwd@default {on}", x, y, False)
            for on, x, y in zip(OUT_NAMES["fused_grounding_head_bwd"], got, ref)]
    raw = rel_err(got[0], plain(lambda: grounding_head.grounding_head_bwd_plain(*args, gh))[0])
    del ref
    t = kern(lambda: timings(lambda: grounding_head.grounding_head_bwd(*args, gh, precision=d),
                             lambda: grounding_head.grounding_head_bwd_plain(*args, gh), None, reps, inner))
    row("fused_grounding_head_bwd", "grounding_head.cu", "vog_tpu/kernels/grounding_head.py:218", errs, t,
        6.0 * B * A * T * (D * D + D * Dh), 2 * nbytes(*args) + nbytes(gh),
        f"vis {tuple(vis.shape)}, A={A} f32, all 9 grads, given the kernel's ReLU decisions")
    print(f"[kernels {tag} default] fused_grounding_head_bwd@default: ReLU decisions off fp64's on "
          f"{flips[0]:.2e} of z0 and {flips[1]:.2e} of z1; dvis Frobenius against the plain backward's own "
          f"decisions {raw:.3e} (what those flips add)", flush=True)
    out[-1].update(relu_flip_share_z0=flips[0], relu_flip_share_z1=flips[1], raw_dvis_frobenius=raw)
    return out


TRAIN_STEPS = 30
P100_TRAIN_STEPS = 10
FWD_NAMES = ("gather_rows", "flash_attention", "mm_shared_qk_attention", "fused_grounding_head")
KERNEL_NAMES = FWD_NAMES + ("flash_attention_bwd", "mm_shared_qk_attention_bwd", "fused_grounding_head_bwd")
# the backward-mode pairs of the P100 train phase: (VOG_FLASH_BWD, VOG_MM_BWD)
# -> the kernels the step must launch, and those it must not
MODE_PAIRS = {
    ("recompute", "emit"): (KERNEL_NAMES, ("flash_attention_bwd_emit", "mm_shared_qk_attention_bwd_recompute")),
    ("emit", "recompute"): (FWD_NAMES + ("flash_attention_bwd_emit", "mm_shared_qk_attention_bwd_recompute",
                                         "fused_grounding_head_bwd"),
                            ("flash_attention_bwd", "mm_shared_qk_attention_bwd")),
}


def train_cfg(dropout: float, exp_setting: str = "gt5", wide=False):
    """The serving model with the production training recipe: GT5's
    (``configs/gt5_production.yml``), or the JAX package's P100 learnability
    recipe (BASELINE.md: B=2, lr 1e-3 cosine after 100 warm-up steps,
    pos_weight 20, skip_nonfinite 3, grad_clip 1); ``wide``: as ``serve_cfg``."""
    cfg = serve_cfg(exp_setting, wide)
    t = cfg.train
    if exp_setting == "gt5":
        t.bs, t.lr, t.pos_weight, t.skip_nonfinite = 16, 5e-4, 5.0, 50
    else:
        t.bs, t.lr, t.pos_weight, t.skip_nonfinite = 2, 1e-3, 20.0, 3
    t.lr_schedule, t.warmup_steps, t.total_steps, t.grad_clip = "cosine", 100, 1000, 1.0
    cfg.mdl.dropout = dropout
    return cfg


FAMILIES = ("flash", "mm", "head")


def plain_kernels(families=FAMILIES):
    """Swap the wrappers of ``families`` (forward and backward) for their
    plain versions, on every device; -> undo."""
    from vog_tpu_torch.kernels import attention, grounding_head, mm_attention

    swaps = {"flash": [(attention, "flash_attention_fwd", attention.flash_attention_plain),
                       (attention, "flash_attention_bwd", attention.flash_attention_bwd_plain)],
             "mm": [(mm_attention, "mm_attention_fwd", mm_attention.mm_attention_plain),
                    (mm_attention, "mm_attention_bwd", mm_attention.mm_attention_bwd_plain)],
             "head": [(grounding_head, "grounding_head_fwd", grounding_head.grounding_head_plain),
                      (grounding_head, "grounding_head_bwd", grounding_head.grounding_head_bwd_plain)]}
    swaps = [s for f in families for s in swaps[f]]
    real = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)

    def undo():
        for m, n, f in real:
            setattr(m, n, f)
    return undo


def make_train_batches(cfg, n: int, B: int, n_rows: int, vocab: int, seed: int):
    """``n`` batches of ``B`` requests with targets: a few positive
    proposals of the positive video for each valid arg."""
    import numpy as np

    ds = cfg.ds
    V, F, P, A = ds.num_cmp, ds.num_frms, ds.num_prop_per_frm, ds.max_srl_args
    rng = np.random.default_rng(seed + 1)
    out = []
    for i in range(n):
        reqs = make_requests(cfg, B, n_rows, vocab, seed=seed + 100 * i)
        b = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
        t = np.zeros((B, V, A, F, P), np.uint8)
        pos = rng.integers(0, V, B)
        hit = rng.uniform(size=(B, A, F, P)) > 0.9
        t[np.arange(B), pos] = hit
        b["targets"] = t * b["srl_arg_mask"][:, None, :, None, None]
        b["batch_mask"] = np.ones((B,), np.uint8)
        out.append(b)
    return out


def random_ann_arrays(cfg, n_anns: int, n_vids: int, seed: int):
    """Per-annotation and per-video arrays of the annotation tables'
    schema (``vog_tpu_torch.data.ann_store.pack_ann_tables``) made from a
    seed: valid token spans, one or two annotated frames for each valid
    arg, a few positive proposals in each."""
    import numpy as np

    ds = cfg.ds
    L, A, F, P = ds.max_seq_len, ds.max_srl_args, ds.num_frms, ds.num_prop_per_frm
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.5, (n_vids, F, P, 2))
    wh = rng.uniform(0.1, 0.5, (n_vids, F, P, 2))
    boxes = np.concatenate([xy, xy + wh, wh[..., :1] * wh[..., 1:]], -1).astype(np.float32)
    pmask = np.ones((n_vids, F, P), np.uint8)
    pmask[rng.uniform(size=n_vids) < 0.3, :, P - 1] = 0  # a padded proposal slot
    seq = rng.integers(6, L + 1, n_anns)
    tokens = rng.integers(2, 5000, (n_anns, L)).astype(np.int32) * (np.arange(L) < seq[:, None])
    starts = rng.integers(0, seq[:, None] - 1, (n_anns, A))
    spans = np.stack([starts, np.minimum(starts + rng.integers(0, 3, (n_anns, A)), seq[:, None] - 1)], -1)
    amask = (np.arange(A) < rng.integers(2, A + 1, n_anns)[:, None]).astype(np.uint8)
    # one or two annotated frames an arg, as in ASRL
    rank = rng.uniform(size=(n_anns, A, F)).argsort(-1).argsort(-1)
    fmask = (rank < rng.integers(1, 3, (n_anns, A, 1))).astype(np.uint8) * amask[:, :, None]
    gxy = rng.uniform(0, 0.5, (n_anns, A, F, 2))
    gt = np.concatenate([gxy, gxy + rng.uniform(0.1, 0.5, (n_anns, A, F, 2))], -1).astype(np.float32)
    anns = {
        "tokens": tokens.astype(np.int32), "seq_len": seq.astype(np.int32),
        "verb_idx": rng.integers(0, seq).astype(np.int32),
        "srl_roles": rng.integers(1, ds.num_roles, (n_anns, A)).astype(np.int32),
        "srl_spans": spans.astype(np.int32), "srl_arg_mask": amask, "gt_frame_mask": fmask,
        "pos_targets": ((rng.uniform(size=(n_anns, A, F, P)) > 0.9) * fmask[..., None]).astype(np.uint8),
        "gt_boxes": gt,
    }
    return anns, {"prop_boxes": boxes, "prop_mask": pmask}


def make_index_batches(cfg, n: int, B: int, n_anns: int, n_rows: int, seed: int):
    """``n`` index-only batches of ``B`` samples (``ann_row``, ``vid_rows``,
    ``pos_vid``, ``ann_idx`` int32, ``batch_mask`` uint8), each group of V
    distinct videos."""
    import numpy as np

    V = cfg.ds.num_cmp
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = rng.integers(0, n_anns, B).astype(np.int32)
        vids = np.stack([rng.choice(n_rows, V, replace=False) for _ in range(B)]).astype(np.int32)
        out.append({"ann_row": rows, "vid_rows": vids, "pos_vid": rng.integers(0, V, B).astype(np.int32),
                    "ann_idx": rows.copy(), "batch_mask": np.ones((B,), np.uint8)})
    return out


def kink_keep(model, vis, arg, mm, ff1):
    """-> ((B, A, T) float: 0 on the logits whose grounding-head
    pre-activation (z0 or z1), ``mm_head`` ReLU input (the mm layer's
    output) lies within KINK_EPS of a kink, or a ReLU input of the mm
    layer's FFN (``ff1``'s output, (B*A, T, 4D); the logit's own token, as
    the mm layer is the last) within FFN_KINK_EPS, in fp64 from this
    forward's values, else 1; the share of zeros and the share that the FFN
    alone adds).  Through such a logit alone, a
    rounding difference can flip a whole term of the gradient.  Both eps
    are the production width's (D 512); a wider model's logit reaches
    proportionally more ReLUs, so they fall as 512 / D there: the share of
    logits zeroed stays near the production model's, and more of them are
    compared."""
    import torch

    hd = model.head
    scale = min(1.0, 512 / hd.fuse_cross_kernel.shape[0])
    with torch.no_grad():
        d = lambda t: t.detach().double()  # noqa: E731
        wv = torch.matmul(d(vis), d(hd.fuse_vis_kernel)) + d(hd.fuse_vis_bias)
        wl = torch.matmul(d(arg), d(hd.fuse_lang_kernel))
        near = near_kinks(vis, arg, wv, wl, hd.fuse_cross_kernel, hd.head1_kernel, hd.head1_bias,
                          KINK_EPS * scale)
        near |= (d(mm).reshape(*near.shape, -1).abs() < KINK_EPS * scale).any(-1)
        lin = model.mm_tx.layers[-1].ff1
        z = torch.matmul(d(ff1), d(lin.weight).t()) + d(lin.bias)
        near_ff = (z.reshape(*near.shape, -1).abs() < FFN_KINK_EPS * scale).any(-1)
        added = float((near_ff & ~near).double().mean())
        near |= near_ff
    return (~near).float(), float(near.double().mean()), added


def step_grads(cfg, sd, batch, tables, dev: str, keep=None, plain: bool = False):
    """One train step from the weights ``sd`` on ``dev`` (``plain``: with
    every float kernel swapped for its plain version) -> (loss, every
    parameter's gradient on the CPU, keep, (share, the FFN's part of it));
    ``batch`` holds
    ``vid_rows`` into the card's ``tables`` (gathered here for the CPU).
    The cotangent of the model's logits is multiplied by ``keep``: by the
    given one, or, when None, by ``kink_keep`` of this step's own forward
    (returned with its shares of zeros)."""
    import torch

    from vog_tpu_torch.data.device_store import gather_from_tables
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_train_step

    b = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    if dev == "cpu":
        b, tables = {k: v.cpu() for k, v in gather_from_tables(b, tables).items()}, None
    model = get_model(cfg, 5000, device=dev, train=True)
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
    seen, used = {}, {}

    def on_logits(mod, inputs, logits):
        k, share, ffn = ((keep, None, None) if keep is not None else
                         kink_keep(model, seen["vis"], seen["arg"], seen["mm"], seen["ff1"]))
        used.update(keep=k, share=share, ffn_share=ffn)
        k = k.to(logits.device)
        logits.register_hook(lambda gr: gr * k)

    hooks = [model.head.register_forward_hook(lambda m, i, o: seen.update(vis=i[0], arg=i[1])),
             model.mm_tx.register_forward_hook(lambda m, i, o: seen.update(mm=o)),
             model.mm_tx.layers[-1].ff1.register_forward_hook(lambda m, i, o: seen.update(ff1=i[0])),
             model.register_forward_hook(on_logits)]
    undo = plain_kernels() if plain else (lambda: None)
    try:
        _, aux = make_train_step(cfg)(TrainState.create(cfg, model), b, seed=0, tables=tables)
    finally:
        undo()
        for hk in hooks:
            hk.remove()
    grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
    share = None if used["share"] is None else (used["share"], used["ffn_share"])
    return float(aux["loss"]), grads, used["keep"].cpu(), share


def grad_faults(got, ref):
    """-> [(leaf, max |err|, relative err)] of the leaves outside either
    limit: max |err| <= TOL * max(1, max|g|) and rel_err <= TRAIN_REL_TOL."""
    out = []
    for k, r in ref.items():
        err, rel = max_err(got[k], r), rel_err(got[k], r)
        if not (err <= TOL * max(1.0, float(r.abs().max())) and rel <= TRAIN_REL_TOL):
            out.append((k, err, rel))
    return out


def compare_step(cfg, sd, batch, tables, what: str, ref_on: str = "cpu"):
    """One train step on the card and on the plain path from the same
    weights ``sd`` and batch (dropout 0): on the CPU (``ref_on="cpu"``) or
    on the card with every float kernel swapped for its plain version
    (``"plain"``).  Kink-aware: the plain step's forward finds the logits
    near a ReLU kink (``kink_keep``, at most MAX_KINK_SHARE of them) and
    both steps zero their cotangent.  Loss within 1e-4 relative, every
    gradient within both limits of ``grad_faults``.  -> (loss, max |err|,
    worst relative err and its leaf, the smallest leaf by max|g|, the plain
    path's gradients, keep, share)."""
    lp, gp, keep, (share, ffn) = step_grads(cfg, sd, batch, tables, "cpu" if ref_on == "cpu" else "cuda",
                                            plain=ref_on != "cpu")
    print(f"[train] {what}: {share:.4f} of the logits near a ReLU kink, {ffn:.4f} of them by the mm "
          f"layer's FFN alone", flush=True)
    if share > MAX_KINK_SHARE:
        fail(f"train {what}: {share:.3f} of the logits lie near a ReLU kink")
    lc, gc, _, _ = step_grads(cfg, sd, batch, tables, "cuda", keep)
    if not abs(lc - lp) <= 1e-4 * abs(lp):
        fail(f"train {what}: card loss {lc:.7f} != plain ({ref_on}) loss {lp:.7f}")
    bad = grad_faults(gc, gp)
    if bad:
        fail(f"train {what}: gradients differ from the plain path ({ref_on}) (leaf, max |err|, rel): {bad}")
    rels = {k: rel_err(gc[k], r) for k, r in gp.items()}
    worst = max(rels, key=rels.get)
    small = min((k for k in gp if gp[k].abs().max() > 0), key=lambda k: float(gp[k].abs().max()))
    return (lc, max(max_err(gc[k], r) for k, r in gp.items()), (worst, rels[worst]),
            (small, float(gp[small].abs().max()), rels[small]), gp, keep, share)


def planted_zero_control(cfg, sd, batch, tables, gp, keep):
    """The card step once more, with ``keep`` as the comparison applied it,
    and two backward kernels' smallest outputs set to zero (the head's db1,
    the mm attention's dfb); ``grad_faults`` against the CPU gradients
    ``gp`` must name the leaves they feed, or the comparison could not see
    such a fault.  -> the leaves named."""
    import torch

    from vog_tpu_torch.kernels import grounding_head, mm_attention

    def zeroed(fn, i):
        def run(*a, **kw):
            out = list(fn(*a, **kw))
            out[i] = torch.zeros_like(out[i])
            return tuple(out)
        return run

    real = grounding_head.grounding_head_bwd, mm_attention.mm_attention_bwd
    grounding_head.grounding_head_bwd = zeroed(real[0], 6)  # db1
    mm_attention.mm_attention_bwd = zeroed(real[1], 4)  # dfb
    try:
        _, gc, _, _ = step_grads(cfg, sd, batch, tables, "cuda", keep)
    finally:
        grounding_head.grounding_head_bwd, mm_attention.mm_attention_bwd = real
    named = [k for k, _, _ in grad_faults(gc, gp)]
    for leaf in ("head1_bias", "rpe_table"):
        if not any(k.endswith(leaf) for k in named):
            fail(f"train: a zeroed {leaf} gradient passed the card-vs-plain comparison (faults {named})")
    return named


def phase_train(tables, card: str, exp_setting: str = "gt5", steps: int = TRAIN_STEPS,
                ref_on: str = "cpu", launched=KERNEL_NAMES, absent=(), label: str = "", wide=False):
    """(a) first step card vs the plain path (``ref_on``: the CPU, or the
    card with the plain versions), (b) ``steps`` production-recipe steps
    from the device tables, every kernel of ``launched`` launched and none
    of ``absent``, one step's peak memory, (c) the trained state against
    the plain path again.  ``wide``: the model of ``WIDE`` (True) or of a
    dict of keys (``serve_cfg``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_train_step

    cfg, parity = train_cfg(0.1, exp_setting, wide), train_cfg(0.0, exp_setting, wide)
    B, tag = cfg.train.bs, f"{exp_setting}{label}"
    batches = make_train_batches(cfg, steps + 1, B, tables.n_rows, 5000, seed=11)
    model = get_model(cfg, 5000, device="cuda", seed=3, train=True)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("train: get_model left TF32 on (misc.matmul_precision is 'highest')")
    sd0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    loss_a, err_a, worst_a, small_a, gp, keep, kink_a = compare_step(parity, sd0, batches[0], tables.tables,
                                                                     "first step", ref_on)
    print(f"[train {tag}] (a) first step card vs plain path ({ref_on}): loss {loss_a:.6f}, max grad err {err_a:.3e}, "
          f"worst relative err {worst_a[1]:.3e} ({worst_a[0]}); smallest leaf {small_a[0]} max|g| "
          f"{small_a[1]:.3e} relative err {small_a[2]:.3e}; cotangent zeroed on {kink_a:.4f} of the logits "
          f"(near a ReLU kink) ({time.perf_counter() - t0:.1f} s)", flush=True)
    named_a = planted_zero_control(parity, sd0, batches[0], tables.tables, gp, keep)
    print(f"[train {tag}] (a) control: zeroed head db1 and mm dfb on the card are rejected on {named_a}", flush=True)

    state = TrainState.create(cfg, model)
    step = make_train_step(cfg)
    dev_batches = [{k: torch.as_tensor(v).cuda() for k, v in b.items()} for b in batches]
    state, _ = step(state, dev_batches[-1], seed=0, tables=tables.tables)  # warm-up, not counted
    torch.cuda.synchronize()
    losses, times = [], []
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        state, aux = step(state, dev_batches[i], seed=0, tables=tables.tables)
        losses.append(aux["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            peak = torch.cuda.max_memory_allocated()
    counts = dict(_build.launches)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        fail(f"train: a non-finite loss in {losses}")
    if int(state.opt_state["total_notfinite"]) != 0:
        fail(f"train: the guard dropped {int(state.opt_state['total_notfinite'])} steps")
    for n in launched:
        if counts.get(n, 0) <= 0:
            fail(f"kernel {n} was not launched on the train path {tag} (counts {counts})")
    for n in absent:
        if counts.get(n, 0):
            fail(f"kernel {n} was launched on the train path {tag}, whose mode does not run it ({counts})")
    if any("@" in n for n in counts):
        fail(f"the fp32 / \"highest\" train path {tag} launched a \"default\" variant ({counts})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, dev_batches[0], seed=0, tables=tables.tables)
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    by_symbol = {}
    by_kernel, other = device_time_by_kernel(prof, 1, by_symbol)
    ksum = sum(by_kernel.values()) + sum(other.values())
    busy = device_busy_ms(prof, 1, ksum)
    med = statistics.median(times)
    idle = max(0.0, 1 - busy / med)  # against the unprofiled median step
    per_step = {n: c / steps for n, c in counts.items()}
    print(f"[train {tag}] (b) {steps} steps, B={B}, production recipe: loss first {losses[0]:.5f} last "
          f"{losses[-1]:.5f}, all finite; median step {med:.2f} ms, {B / med * 1e3:.1f} samples/s on {card}; "
          f"peak memory of a step {peak / 1e9:.3f} GB ({(peak - resident) / 1e9:.3f} GB above the "
          f"{resident / 1e9:.3f} GB resident before it)", flush=True)
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    print(f"[train {tag}] (b) launches per step {per_step}; one profiled step: device busy {busy:.2f} ms "
          f"(kernel times summed {ksum:.2f} ms), idle share {idle:.2f} of the median step (span with the "
          f"profiler on {span:.2f} ms); ours "
          + ", ".join(f"{k}={v:.3f}" for k, v in by_kernel.items())
          + f"; other {sum(other.values()):.3f} ms in {len(other)} ops: "
          + "; ".join(f"{k[:40]}={v:.3f}" for k, v in top), flush=True)
    print(f"[train {tag}] (b) our kernels by symbol: " + ", ".join(f"{k}={v:.3f}" for k, v in by_symbol.items()),
          flush=True)

    sd = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    if not all(torch.isfinite(v).all() for v in sd.values()):
        fail("train: the state after the run holds non-finite values")
    loss_c, err_c, worst_c, small_c, gp, keep, kink_c = compare_step(parity, sd, batches[1], tables.tables,
                                                                     "trained state", ref_on)
    print(f"[train {tag}] (c) trained state card vs plain path ({ref_on}): loss {loss_c:.6f}, max grad err {err_c:.3e}, "
          f"worst relative err {worst_c[1]:.3e} ({worst_c[0]}); smallest leaf {small_c[0]} max|g| "
          f"{small_c[1]:.3e} relative err {small_c[2]:.3e}; cotangent zeroed on {kink_c:.4f} of the logits "
          f"(near a ReLU kink)", flush=True)
    named_c = planted_zero_control(parity, sd, batches[1], tables.tables, gp, keep)
    print(f"[train {tag}] (c) control: zeroed head db1 and mm dfb on the card are rejected on {named_c}", flush=True)
    return counts, dict(steps=steps, batch=B, loss_first=losses[0], loss_last=losses[-1],
                        peak_memory_gb=peak / 1e9, resident_gb=resident / 1e9,
                        median_step_ms=med, samples_per_s=B / med * 1e3, step_ms=times,
                        launches_per_step=per_step, profiled_step_ms=span, device_busy_ms=busy,
                        kernel_time_sum_ms=ksum,
                        idle_share=idle, kernels_ms=by_kernel, other_device_ms=sum(other.values()),
                        top_other=[[k[:60], v] for k, v in top], ours_by_symbol=by_symbol,
                        first_step_grad_err=err_a, trained_grad_err=err_c, first_step_worst_rel=worst_a,
                        trained_worst_rel=worst_c, first_step_smallest_leaf=small_a,
                        trained_smallest_leaf=small_c, kink_share_first=kink_a, kink_share_trained=kink_c,
                        planted_zero_rejected=[named_a, named_c])


# each wrapper's __global__ functions in vog_tpu_torch/csrc, by function: a
# backward's two modes share their symbols (its emit mode's products over ds
# or comb are cuBLAS calls, counted among the other ops)
KERNEL_SYMBOLS = {"gather_rows": ("gather_rows_k",), "flash_attention": ("flash_fwd",),
                  "mm_shared_qk_attention": ("mm_fwd_prep_wg", "mm_fwd_wg", "mm_fwd"),
                  "fused_grounding_head": ("head_fwd",),
                  "flash_attention_bwd": ("flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq"),
                  "mm_shared_qk_attention_bwd": ("mm_bwd_delta", "mm_bwd_prep_wg", "mm_bwd_dkv_wg", "mm_bwd_dkv",
                                                 "mm_bwd_dq"),
                  "fused_grounding_head_bwd": ("head_bwd_rows", "head_bwd_w", "head_bwd_prep", "head_bwd_finish")}


def device_time_by_kernel(prof, reps: int, by_symbol=None):
    """-> (ms per rep of each of our kernels, ms per rep of every other
    device op) from a torch.profiler run; ``by_symbol``, a dict, also gets
    our kernels' ms by their own symbol (a wrapper may launch several)."""
    import torch

    by_kernel = {k: 0.0 for k in KERNEL_SYMBOLS}
    other = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = us / 1e3 / reps
        hit = [(k, sym) for k, syms in KERNEL_SYMBOLS.items() for sym in syms if sym in e.key]
        if hit:
            by_kernel[hit[0][0]] += ms
            if by_symbol is not None:
                by_symbol[hit[0][1]] = by_symbol.get(hit[0][1], 0.0) + ms
        else:
            other[e.key] = other.get(e.key, 0.0) + ms
    return by_kernel, other


def device_busy_ms(prof, reps: int, kernel_sum: float) -> float:
    """ms per rep during which the card ran at least one kernel or copy: the
    union of the device events' intervals in a torch.profiler run, so that
    kernels running at once on two streams (the head backward's two parts)
    count once.  ``kernel_sum``, the sum of their times, when the trace
    holds no device intervals."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start)
    if not spans:
        return kernel_sum
    total, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            total, lo, hi = total + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (total + hi - lo) / 1e3 / reps


def phase_profile(pred, reqs, B: int = 16, reps: int = 5):
    """Where the time of one B=16 batch goes: host wall of a whole call
    (upload, forward, copy back), the forward's stream span (CUDA events
    around one forward as the host issues it; the idle share is against
    this span), the same span with the forward queued behind a sleep (the
    card's time alone, host gaps removed), and the device time by kernel
    from torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = {k: np.stack([r[k] for r in reqs[:B]]) for k in reqs[0]}
    batch["batch_mask"] = np.ones((B,), np.uint8)
    walls = []
    for i in range(reps + 2):
        t0 = time.perf_counter()
        pred(batch)
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    with torch.inference_mode():
        dev = {k: pred._upload(v) for k, v in batch.items()}
        span = time_ms(lambda: pred.predict(dev), reps=5, inner=1, queued=False)
        queued_span = time_ms(lambda: pred.predict(dev), reps=5, inner=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                pred.predict(dev)
            torch.cuda.synchronize()
    by_kernel, other = device_time_by_kernel(prof, reps)
    by_kernel = {k: v for k, v in by_kernel.items() if not k.endswith("_bwd")}
    ksum = sum(by_kernel.values()) + sum(other.values())
    busy = device_busy_ms(prof, reps, ksum)
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    out = dict(batch=B, call_wall_ms=statistics.median(walls), forward_span_ms=span,
               device_busy_ms=busy, kernel_time_sum_ms=ksum, idle_share=max(0.0, 1.0 - busy / span),
               kernels_ms=by_kernel,
               queued_span_ms=queued_span, queued_idle_share=max(0.0, 1.0 - busy / queued_span),
               other_device_ms=sum(other.values()), top_other=[[k[:60], v] for k, v in top])
    print(f"[profile] B={B}: call wall {out['call_wall_ms']:.3f} ms, forward span {span:.3f} ms, "
          f"device busy {busy:.3f} ms (kernel times summed {ksum:.3f}; idle {out['idle_share']:.2f}); "
          f"queued behind a sleep: span "
          f"{queued_span:.3f} ms (idle {out['queued_idle_share']:.2f}); ours "
          + ", ".join(f"{k}={v:.3f}" for k, v in by_kernel.items())
          + f"; other {out['other_device_ms']:.3f} ms: "
          + "; ".join(f"{k[:40]}={v:.3f}" for k, v in top), flush=True)
    return out


@contextlib.contextmanager
def bwd_modes(flash: str, mm: str):
    """The backward modes that the attention wrappers resolve from the
    environment, as the JAX package's VOG_FLASH_BWD / VOG_MM_BWD."""
    old = {k: os.environ.get(k) for k in ("VOG_FLASH_BWD", "VOG_MM_BWD")}
    os.environ.update(VOG_FLASH_BWD=flash, VOG_MM_BWD=mm)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def step_peak(tables, modes) -> tuple:
    """Peak memory of one P100 production-recipe step (after a warm-up step)
    with the backward ``modes`` (flash, mm) -> (peak GB, GB above what was
    resident before the step)."""
    import torch

    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_train_step

    cfg = train_cfg(0.1, "p100")
    batches = [{k: torch.as_tensor(v).cuda() for k, v in b.items()}
               for b in make_train_batches(cfg, 2, cfg.train.bs, tables.n_rows, 5000, seed=11)]
    state = TrainState.create(cfg, get_model(cfg, 5000, device="cuda", seed=3, train=True))
    step = make_train_step(cfg)
    with bwd_modes(*modes):
        state, _ = step(state, batches[1], seed=0, tables=tables.tables)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, _ = step(state, batches[0], seed=0, tables=tables.tables)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak / 1e9, (peak - resident) / 1e9


# [dispatch gt5]: the production recipe's dispatch (configs/gt5_production.yml
# steps_per_dispatch 16, eval_batches_per_dispatch 10): 37 steps in groups of
# 16, 16 and an epoch-tail of 5; ~40k annotations (the real ASRL size the
# JAX package's ann_store.py sizes its tables for)
DISPATCH_GROUPS = (16, 16, 5)
DISPATCH_TIMED = 4  # dispatches of K timed after the checks
N_ANNS = 40000
P100_DISPATCH_K = 8  # the JAX package's P100 run used K = 8


def stack_batches(batches):
    import numpy as np

    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def states_equal(a, b) -> list:
    """-> the names of the state tensors (parameters, both moments, the
    guard counters, the step count) that differ bitwise."""
    import torch

    ta, tb = a.tensors(), b.tensors()
    return [k for k in ta if not torch.equal(ta[k], tb[k])]


def profiled_busy(fn, reps: int, split=None) -> tuple:
    """``fn`` once under torch.profiler -> (device busy ms per rep, kernel
    times summed per rep); busy is None when the trace holds no device
    time.  ``split``, a dict, gets ``ours`` and ``other``
    (``device_time_by_kernel``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_symbol = {}
    by_kernel, other = device_time_by_kernel(prof, reps, by_symbol)
    if split is not None:
        split.update(ours=by_kernel, other=other, by_symbol=by_symbol)
    ksum = sum(by_kernel.values()) + sum(other.values())
    busy = device_busy_ms(prof, reps, ksum)
    return (busy if busy > 0 else None), ksum


def dispatch_by_symbol(tables, dispatches: int = 3) -> dict:
    """The production recipe's graphed dispatch (``prod_cfg``, K=16) on
    ``tables``: ``dispatches`` dispatches (the first captures), then one
    under torch.profiler -> device ms a step by kernel symbol (ours) and
    the busy ms a step ("busy") and the other ops' sum ("other")."""
    import torch

    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.data.ann_store import AnnTables
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, dispatch_sizes, make_multi_train_step

    cfg = prod_cfg()
    K, _ = dispatch_sizes(cfg)
    try:
        anns, vids = random_ann_arrays(cfg, N_ANNS, tables.n_rows, seed=21)
        all_tables = {**tables.tables, **AnnTables.from_arrays(cfg, anns, vids, device="cuda").tables}
        batches = make_index_batches(cfg, K * (dispatches + 1), cfg.train.bs, N_ANNS, tables.n_rows, seed=24)
        state = TrainState.create(cfg, get_model(cfg, 5000, device="cuda", seed=3, train=True))
        multi = make_multi_train_step(cfg)
        for i in range(dispatches):
            multi(state, stack_batches(batches[i * K:(i + 1) * K]), 0, all_tables)[1]["loss"].cpu()
        split = {}
        nxt = stack_batches(batches[dispatches * K:])
        busy, _ = profiled_busy(lambda: multi(state, nxt, 0, all_tables)[1]["loss"].cpu(), K, split)
        out = dict(split["by_symbol"], busy=busy, other=sum(split["other"].values()))
        print("[bwd split] the production dispatch (K=16, graphed), device ms a step: "
              + ", ".join(f"{k}={v:.4f}" for k, v in out.items() if v is not None), flush=True)
        return out
    finally:
        apply_matmul_precision(serve_cfg())


def phase_dispatch(tables, card: str) -> dict:
    """[dispatch gt5]: the production recipe's dispatch at full width (GT5
    widths, B=16, SPAT, dropout 0.1, skip_nonfinite 50, fp32), index-only
    batches against annotation tables made from a seed.  (1) 37 steps as
    CUDA-graph dispatches of 16, 16 and 5, bitwise against 37 eager steps
    (parameters, both moments, guard counters, step count, and every aux);
    (2) freeze on NaN (skip_nonfinite 0, a NaN feature row first read by
    step 6): the state after a dispatch of 16 bitwise the eager state after
    step 5, and a control without the NaN not; (3) E=10 eval batches as one
    dispatch (compact form) bitwise against 10 eager eval steps, and
    ``finalize_metrics``; (4) times, eager against graph: the train step
    (host clock to a synchronize: eager a step, graph a dispatch over K),
    samples/s, device busy from torch.profiler and the idle share; eval
    batches/s; serve p50 / p95 / req/s with ``cuda_graphs`` off and on
    (``phase_serve``); the peak memory of a captured step."""
    import numpy as np
    import torch

    from vog_tpu_torch.data.ann_store import AnnTables, ann_table_bytes
    from vog_tpu_torch.evaluation import finalize_metrics
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import (TrainState, dispatch_sizes, make_eval_step, make_multi_eval_step,
                                     make_multi_train_step, make_train_step)

    cfg = train_cfg(0.1)
    cfg.train.steps_per_dispatch, cfg.train.eval_batches_per_dispatch = 16, 10
    K, E = dispatch_sizes(cfg)
    B, n_steps = cfg.train.bs, sum(DISPATCH_GROUPS)
    t0 = time.perf_counter()
    anns, vids = random_ann_arrays(cfg, N_ANNS, tables.n_rows, seed=21)
    ann = AnnTables.from_arrays(cfg, anns, vids, device="cuda")
    del anns, vids
    ann_bytes = sum(nbytes(t) for t in ann.tables.values())
    if ann_bytes != ann_table_bytes(cfg, N_ANNS, tables.n_rows):
        fail(f"dispatch: annotation tables hold {ann_bytes} bytes, not ann_table_bytes's")
    all_tables = {**tables.tables, **ann.tables}
    batches = make_index_batches(cfg, n_steps + K * (DISPATCH_TIMED + 1) + E, B, N_ANNS, tables.n_rows, seed=22)
    per_batch = sum(v.nbytes for v in batches[0].values())
    print(f"[dispatch gt5] annotation tables: {N_ANNS} annotations, {tables.n_rows} videos, "
          f"{ann_bytes / 1e6:.2f} MB on the card ({time.perf_counter() - t0:.1f} s); an index-only batch of "
          f"{B}: {per_batch} bytes ({per_batch / 1e6:.6f} MB), a dispatch of {K}: {K * per_batch / 1e6:.6f} MB",
          flush=True)

    def dev(b):
        return {k: torch.as_tensor(v).cuda() for k, v in b.items()}

    def fresh(c):
        return TrainState.create(c, get_model(c, 5000, device="cuda", seed=3, train=True))

    # (1) graph train against eager, 37 steps
    step, multi = make_train_step(cfg), make_multi_train_step(cfg)
    eager, graph = fresh(cfg), fresh(cfg)
    e_aux, e_ms = [], []
    for b in batches[:n_steps]:
        db = dev(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e_aux.append(step(eager, db, 0, all_tables)[1])
        torch.cuda.synchronize()
        e_ms.append((time.perf_counter() - t0) * 1e3)
    g_aux, off, capture_s = [], 0, None
    for i, n in enumerate(DISPATCH_GROUPS):
        if i == 1:
            _build.reset_counts()
        t0 = time.perf_counter()
        _, aux = multi(graph, stack_batches(batches[off:off + n]), 0, all_tables)
        losses = aux["loss"].cpu()  # the host's one read a dispatch
        if i == 0:
            capture_s = time.perf_counter() - t0
        g_aux.append(aux)
        off += n
    counts = dict(_build.launches)
    diff = states_equal(graph, eager)
    if diff:
        fail(f"dispatch: {len(diff)} state tensors of the graph run differ from the eager steps: {diff[:5]}")
    for k in e_aux[0]:
        if not torch.equal(torch.cat([a[k] for a in g_aux]), torch.stack([a[k] for a in e_aux])):
            fail(f"dispatch: the graph's aux {k} differs from the eager steps'")
    if int(graph.step) != n_steps or not torch.isfinite(losses).all():
        fail(f"dispatch: step count {int(graph.step)} or a non-finite loss {losses.tolist()}")
    replays = sum(DISPATCH_GROUPS[1:])
    for n in KERNEL_NAMES:
        if counts.get(n, 0) <= 0:
            fail(f"kernel {n} was not launched by the graph dispatches (counts {counts})")
    if any("@" in n for n in counts):
        fail(f"the fp32 / \"highest\" dispatch launched a \"default\" variant ({counts})")
    cap = next(iter(graph.graphs.values()))
    print(f"[dispatch gt5] (1) {n_steps} steps as CUDA-graph dispatches of {'+'.join(map(str, DISPATCH_GROUPS))} "
          f"bitwise equal to {n_steps} eager steps (parameters, both moments, guard counters, step count "
          f"{int(graph.step)}, every aux); capture with its warm-up {capture_s:.2f} s; launches per replayed "
          f"step {({k: v / replays for k, v in counts.items()})}; peak memory of a captured step "
          f"{cap.peak_bytes / 1e9:.3f} GB (the graph's pool; a static input of {cap.static.nbytes} bytes)",
          flush=True)

    # (4a) train times: eager a step, graph a dispatch of K over K
    d_ms, off = [], n_steps
    for _ in range(DISPATCH_TIMED):
        t0 = time.perf_counter()
        _, aux = multi(graph, stack_batches(batches[off:off + K]), 0, all_tables)
        aux["loss"].cpu()
        d_ms.append((time.perf_counter() - t0) * 1e3)
        off += K
    e_med, g_med = statistics.median(e_ms), statistics.median(d_ms) / K
    eb = dev(batches[off])
    e_busy, e_ksum = profiled_busy(lambda: step(eager, eb, 0, all_tables), 1)
    nxt = stack_batches(batches[off:off + K])
    g_busy, g_ksum = profiled_busy(lambda: multi(graph, nxt, 0, all_tables)[1]["loss"].cpu(), K)

    def idle(busy, med):
        return None if busy is None else max(0.0, 1 - busy / med)

    def fmt(x, unit=""):
        return "not measured" if x is None else f"{x:.2f}{unit}"

    train = dict(eager_step_ms=e_med, graph_step_ms=g_med, eager_samples_per_s=B / e_med * 1e3,
                 graph_samples_per_s=B / g_med * 1e3, eager_busy_ms=e_busy, graph_busy_ms=g_busy,
                 eager_kernel_sum_ms=e_ksum, graph_kernel_sum_ms=g_ksum, eager_idle=idle(e_busy, e_med),
                 graph_idle=idle(g_busy, g_med), eager_step_ms_all=e_ms, graph_dispatch_ms=d_ms,
                 capture_s=capture_s, peak_captured_step_gb=cap.peak_bytes / 1e9,
                 launches_per_step={k: v / replays for k, v in counts.items()})
    print(f"[dispatch gt5] (4) train step, host clock to a synchronize: eager median {e_med:.2f} ms "
          f"({B / e_med * 1e3:.1f} samples/s, busy {fmt(e_busy, ' ms')}, idle {fmt(idle(e_busy, e_med))}); "
          f"graph median {g_med:.2f} ms a step over {DISPATCH_TIMED} dispatches of {K} ({B / g_med * 1e3:.1f} "
          f"samples/s, busy {fmt(g_busy, ' ms')} a step, idle {fmt(idle(g_busy, g_med))}); dispatch ms "
          + ", ".join(f"{x:.1f}" for x in d_ms) + f" on {card}", flush=True)

    # (2) freeze on NaN
    cfg0 = train_cfg(0.1)
    cfg0.train.skip_nonfinite = 0
    fb = make_index_batches(cfg0, K, B, N_ANNS, tables.n_rows, seed=23)
    bad = int(fb[5]["vid_rows"][0, 0])
    for b in fb[:5]:
        b["vid_rows"][b["vid_rows"] == bad] = (bad + 1) % tables.n_rows  # step 6 is the first to read it
    ref, frozen = fresh(cfg0), fresh(cfg0)
    step0 = make_train_step(cfg0)
    for b in fb[:5]:
        step0(ref, dev(b), 0, all_tables)
    start = frozen.snapshot()
    row = tables.tables["feats"][bad].clone()
    multi0 = make_multi_train_step(cfg0)
    try:
        tables.tables["feats"][bad] = float("nan")
        _, aux = multi0(frozen, stack_batches(fb), 0, all_tables)
    finally:
        tables.tables["feats"][bad] = row
    losses = aux["loss"].cpu()
    diff = states_equal(frozen, ref)
    if diff or int(frozen.step) != 5 or not (torch.isnan(losses[5]) and torch.isfinite(losses[:5]).all()):
        fail(f"dispatch: the frozen state differs from the eager state after step 5 ({diff[:5]}), step "
             f"{int(frozen.step)}, losses {losses.tolist()}")
    frozen.restore(start)
    multi0(frozen, stack_batches(fb), 0, all_tables)
    control = states_equal(frozen, ref)
    if not control or int(frozen.step) != K:
        fail("dispatch: the control without the NaN equals the eager state after step 5")
    print(f"[dispatch gt5] (2) freeze on NaN (skip_nonfinite 0, NaN in feature row {bad}, first read by step 6): "
          f"after a dispatch of {K} the state is bitwise the eager state after step 5, step count "
          f"{5}; loss of step 6 {losses[5].item()}; the control without the NaN differs in "
          f"{len(control)} of {len(ref.tensors())} state tensors (step count {int(frozen.step)})", flush=True)
    del ref, frozen, start

    # (3) eval: E batches as one dispatch against E eager eval steps
    eb_stack = stack_batches(batches[-E:])
    ev_step, ev_multi = make_eval_step(cfg), make_multi_eval_step(cfg)
    got = ev_multi(graph, eb_stack, all_tables)
    ref_ev = [ev_step(graph, dev(b), all_tables) for b in batches[-E:]]
    for k in got:
        if not torch.equal(got[k], torch.stack([r[k] for r in ref_ev])):
            fail(f"dispatch: eval output {k} of the graph differs from the eager eval steps")
    sums = {k: float(got[k].sum()) for k in ("n_pairs", "n_acc", "n_vacc", "n_queries", "n_strict", "n_cons")}
    metrics = finalize_metrics(sums)
    e_ev, g_ev = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [ev_step(graph, dev(b), all_tables) for b in batches[-E:]]
        float(torch.stack([o["n_pairs"] for o in outs]).sum())
        e_ev.append(E / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        float(ev_multi(graph, eb_stack, all_tables)["n_pairs"].sum())
        g_ev.append(E / (time.perf_counter() - t0))
    ev = dict(eager_batches_per_s=statistics.median(e_ev), graph_batches_per_s=statistics.median(g_ev),
              metrics=metrics, n_overflow=float(got["n_overflow"].sum()),
              loss=float(got["loss_sum"].sum() / got["n_batch"].sum()))
    print(f"[dispatch gt5] (3) {E} eval batches (compact, {got['pair_arg'].shape[-1]} pairs a query) as one "
          f"dispatch bitwise equal to {E} eager eval steps; finalize_metrics {metrics}, overflow "
          f"{ev['n_overflow']:.0f}, loss {ev['loss']:.5f}; eval batches/s (host clock, median of 3): eager "
          f"{ev['eager_batches_per_s']:.1f}, graph {ev['graph_batches_per_s']:.1f}", flush=True)
    del graph, eager
    gc.collect()
    torch.cuda.empty_cache()

    # (4b) serve, cuda_graphs off then on
    serve = {}
    for on in (False, True):
        pred, _, _, serve[on] = phase_serve(serve_cfg(), tables, card, cuda_graphs=on)
        del pred
    print(f"[dispatch gt5] (4) serve, cuda_graphs off / on: p50 {serve[False]['p50_ms']:.2f} / "
          f"{serve[True]['p50_ms']:.2f} ms, p95 {serve[False]['p95_ms']:.2f} / {serve[True]['p95_ms']:.2f} ms, "
          f"{serve[False]['requests_per_s']:.1f} / {serve[True]['requests_per_s']:.1f} req/s on {card}", flush=True)
    return dict(train=train, eval=ev, serve_eager=serve[False], serve_graph=serve[True],
                ann_table_mb=ann_bytes / 1e6, index_batch_bytes=per_batch)


def phase_dispatch_p100(tables, card: str) -> dict:
    """One dispatch of K=8 P100 steps (the JAX package's P100 recipe, the
    default backward modes) as a CUDA graph, bitwise against 8 eager steps;
    then one more dispatch timed (host clock, over K), against the eager
    steps' median; the peak memory of a captured step."""
    import torch

    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_multi_train_step, make_train_step

    cfg = train_cfg(0.1, "p100")
    K, B = P100_DISPATCH_K, cfg.train.bs
    batches = make_train_batches(cfg, 2 * K, B, tables.n_rows, 5000, seed=31)

    def fresh():
        return TrainState.create(cfg, get_model(cfg, 5000, device="cuda", seed=3, train=True))

    eager, graph = fresh(), fresh()
    step, multi = make_train_step(cfg), make_multi_train_step(cfg)
    e_ms = []
    for b in batches[:K]:
        db = {k: torch.as_tensor(v).cuda() for k, v in b.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(eager, db, 0, tables.tables)
        torch.cuda.synchronize()
        e_ms.append((time.perf_counter() - t0) * 1e3)
    multi(graph, stack_batches(batches[:K]), 0, tables.tables)[1]["loss"].cpu()
    diff = states_equal(graph, eager)
    if diff:
        fail(f"dispatch p100: {len(diff)} state tensors of the graph run differ from the eager steps: {diff[:5]}")
    t0 = time.perf_counter()
    multi(graph, stack_batches(batches[K:]), 0, tables.tables)[1]["loss"].cpu()
    g_ms = (time.perf_counter() - t0) * 1e3 / K
    cap = next(iter(graph.graphs.values()))
    e_med = statistics.median(e_ms)
    print(f"[dispatch p100] {K} steps as one CUDA-graph dispatch bitwise equal to {K} eager steps (flash "
          f"recompute, mm emit); step, host clock: eager median {e_med:.2f} ms, graph {g_ms:.2f} ms a step "
          f"({B / g_ms * 1e3:.1f} samples/s); peak memory of a captured step {cap.peak_bytes / 1e9:.3f} GB "
          f"on {card}", flush=True)
    return dict(eager_step_ms=e_med, graph_step_ms=g_ms, eager_step_ms_all=e_ms,
                peak_captured_step_gb=cap.peak_bytes / 1e9)


def variant_name(name: str, cfg) -> str:
    """A kernel's launch counter under ``cfg``'s ``misc.matmul_precision``:
    the gather (a copy) has one variant, the float kernels ``name`` at
    "highest" and ``name@default`` at "default"."""
    from vog_tpu_torch.kernels import _build

    return name if name == "gather_rows" else _build.variant(name, cfg.misc.matmul_precision)


def path_names(cfg, names=KERNEL_NAMES) -> set:
    """The launch counters that a run of ``cfg`` shows for the wrappers
    ``names``: each one's ``variant_name``; where the mm forward takes
    mm_fwd_wg (``mm_attention.fwd_route`` "wg": a one-pass precision, head
    dim <= 128) and where the mm backward's emit mode takes mm_bwd_dkv_wg
    (``mm_attention.bwd_route`` "wg"), that kernel's counter beside its
    wrapper's."""
    from vog_tpu_torch.kernels import mm_attention

    out = {variant_name(n, cfg) for n in names}
    dh = cfg.mdl.vis_dim // cfg.mdl.n_heads
    if "mm_shared_qk_attention" in names and mm_attention.fwd_route(cfg.misc.matmul_precision, dh) == "wg":
        out.add(variant_name(mm_attention.NAME_FWD_WG, cfg))
    if "mm_shared_qk_attention_bwd" in names and \
            mm_attention.bwd_route("emit", cfg.misc.matmul_precision, dh) == "wg":
        out.add(variant_name(mm_attention.NAME_WG, cfg))
    return out


def prod_cfg(exp_setting: str = "gt5", dropout: float = 0.1):
    """The production recipe's numerics on ``train_cfg``: bf16 activations
    and matmul precision "default".  At GT5 with steps_per_dispatch 16 and
    eval_batches_per_dispatch 10 this is ``configs/gt5_production.yml`` as
    it is (vog, SPAT, B=16, lr 5e-4 cosine after 100 warm-up steps,
    pos_weight 5, skip_nonfinite 50, half_feats, device and annotation
    tables), built here because the card's host has no PyYAML; total_steps
    1000 for the cosine (the yml leaves it to the CLI's epochs)."""
    cfg = train_cfg(dropout, exp_setting)
    cfg.mdl.dtype, cfg.misc.matmul_precision = "bfloat16", "default"
    if exp_setting == "gt5":
        cfg.train.steps_per_dispatch, cfg.train.eval_batches_per_dispatch = 16, 10
    return cfg


# bf16 + "default" on the card against the CPU plain path in the same
# numerics, of max|score|.  One TF32 pass on the card and exact fp32 on the
# CPU send some bf16 roundings different ways: a reading of 1.118e-2 (H100
# 80GB HBM3, 700 W), as large as bf16 itself moves the scores (the CPU's
# bf16 scores against its fp32 ones on the same weights, which
# phase_serve_prod prints beside it)
PROD_SERVE_TOL = 2e-2
PROD_VS_FP32_TOL = 3e-2  # bf16 against fp32 scores: the JAX package's bound (tests/test_bf16_mode.py)


def phase_serve_prod(tables, card: str, serve32: dict) -> tuple:
    """[serve gt5 prod]: the production model in bf16 with "default"
    precision, 96 requests as [serve gt5]: scores against the CPU plain path
    in the same numerics within 1e-2 * max|score|, and against the card's
    fp32 / "highest" scores of the same weights within 3e-2 * max|score|;
    p50 / p95 / req/s beside the fp32 readings of this run.  -> (launch
    counts, readings)."""
    import numpy as np

    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.serve import Predictor

    cfg32 = serve_cfg()
    cfg = serve_cfg()
    cfg.mdl.dtype, cfg.misc.matmul_precision = "bfloat16", "default"
    reqs = make_requests(cfg, 8, tables.n_rows, 5000, seed=0)  # the first requests of phase_serve
    sub = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    sub["batch_mask"] = np.ones((len(reqs),), np.uint8)
    pred32 = Predictor(cfg32, None, 5000, tables=tables.tables, device="cuda")  # the same seeded weights
    s32 = pred32(sub)["scores"]
    cpu32 = cpu_outputs(cfg32, pred32.model.state_dict(), sub, tables)["scores"]
    del pred32
    try:
        pred, _, counts, serve = phase_serve(cfg, tables, card, score_tol=PROD_SERVE_TOL)
        s16 = pred(sub)["scores"]
        cpu16 = cpu_outputs(cfg, pred.model.state_dict(), sub, tables)["scores"]
        del pred
    finally:
        apply_matmul_precision(cfg32)  # the phases after this one run fp32 / "highest"
    valid = sub["prop_mask"][:, None].astype(bool).repeat(cfg.ds.max_srl_args, 1)
    top = float(np.abs(s32[valid]).max())
    err = float(np.abs(s16[valid] - s32[valid]).max())
    floor = float(np.abs(cpu16[valid] - cpu32[valid]).max()) / float(np.abs(cpu32[valid]).max())
    if not err <= PROD_VS_FP32_TOL * top:
        fail(f"serve prod: bf16 scores differ from fp32 by {err:.3e} > {PROD_VS_FP32_TOL} x {top:.3e}")
    serve.update(vs_fp32_err=err, vs_fp32_scale=top, cpu_bf16_vs_fp32=floor)
    print(f"[serve gt5 prod] bf16 + default against fp32 + highest (same weights, {len(reqs)} requests): max "
          f"|score diff| {err:.3e} = {err / top:.3e} of max|score| (limit {PROD_VS_FP32_TOL}); on the CPU, bf16 "
          f"against fp32 {floor:.3e} of max|score| (what bf16 moves a score); card against the CPU plain path "
          f"in bf16 {serve['score_err']:.3e} (limit {serve['score_tol']:.3e}); p50 / p95 ms, req/s: "
          f"prod {serve['p50_ms']:.2f} / {serve['p95_ms']:.2f}, {serve['requests_per_s']:.1f}; fp32 "
          f"{serve32['p50_ms']:.2f} / {serve32['p95_ms']:.2f}, {serve32['requests_per_s']:.1f} on {card}",
          flush=True)
    return counts, serve


# the first production step, card against CPU (the same seeded weights
# and batch): twice the worst of the first readings (H100 80GB HBM3, 700 W:
# loss 1.594e-4 relative, whole-gradient cosine 1 - 2.06e-6, worst leaf
# lang.bilstm.bwd.weight_ih_l0 1 - 1.63e-4), from a first bound of 1e-2,
# 0.999 and 0.99
PROD_LOSS_TOL = 3.2e-4  # loss, relative
PROD_COS = 1 - 4.2e-6  # cosine of the whole gradient
PROD_LEAF_COS = 1 - 3.3e-4  # cosine of each leaf's gradient


def grad_cosines(got, ref) -> tuple:
    """-> (the whole gradient's cosine, {leaf: cosine} over the leaves whose
    reference gradient is not zero)."""
    import torch

    def cos(a, b):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        n = float(a.norm() * b.norm())
        return float(a @ b) / n if n > 0 else 0.0

    leaves = {k: cos(got[k], r) for k, r in ref.items() if r.abs().max() > 0}
    whole = cos(torch.cat([got[k].reshape(-1) for k in ref]), torch.cat([r.reshape(-1) for r in ref.values()]))
    return whole, leaves


def prod_step_check(cfg, sd, batch, tables) -> dict:
    """The first production-numerics step on the card against the same step
    on the CPU plain path in the same numerics (dropout 0, same weights and
    batch): loss within PROD_LOSS_TOL relative, the whole gradient's cosine
    >= PROD_COS, each leaf's >= PROD_LEAF_COS; then the planted control (the
    head's db1 and the mm attention's dfb zeroed on the card) must fail it
    on those leaves.  -> the readings."""
    import torch

    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.kernels import grounding_head, mm_attention

    B, A = cfg.train.bs, cfg.ds.max_srl_args
    T = cfg.ds.num_frms * cfg.ds.num_prop_per_frm * cfg.ds.num_cmp
    keep = torch.ones((B, A, T))  # no kink mask: the cosines absorb a flipped ReLU
    t0 = time.perf_counter()
    lp, gp, _, _ = step_grads(cfg, sd, batch, tables, "cpu", keep)
    lc, gc, _, _ = step_grads(cfg, sd, batch, tables, "cuda", keep)
    whole, leaves = grad_cosines(gc, gp)
    worst = min(leaves, key=leaves.get)
    dl = abs(lc - lp) / abs(lp)
    if not (dl <= PROD_LOSS_TOL and whole >= PROD_COS and leaves[worst] >= PROD_LEAF_COS):
        fail(f"dispatch prod: first step card vs CPU: loss {lc:.6f} vs {lp:.6f} ({dl:.2e}), gradient cosine "
             f"{whole:.6f}, worst leaf {worst} {leaves[worst]:.6f}")
    flat = all(g.dtype == torch.float32 for g in gc.values())
    if not flat:
        fail("dispatch prod: a gradient is not fp32 in bf16 mode")

    def zeroed(fn, i):
        def run(*a, **kw):
            out = list(fn(*a, **kw))
            out[i] = torch.zeros_like(out[i])
            return tuple(out)
        return run

    real = grounding_head.grounding_head_bwd, mm_attention.mm_attention_bwd
    grounding_head.grounding_head_bwd = zeroed(real[0], 6)  # db1
    mm_attention.mm_attention_bwd = zeroed(real[1], 4)  # dfb
    try:
        _, gz, _, _ = step_grads(cfg, sd, batch, tables, "cuda", keep)
    finally:
        grounding_head.grounding_head_bwd, mm_attention.mm_attention_bwd = real
    _, zl = grad_cosines(gz, gp)
    named = sorted(k for k, c in zl.items() if c < PROD_LEAF_COS)
    for leaf in ("head1_bias", "rpe_table"):
        if not any(k.endswith(leaf) for k in named):
            fail(f"dispatch prod: a zeroed {leaf} gradient passed the card-vs-CPU comparison ({named})")
    apply_matmul_precision(cfg)  # step_grads's models applied it; keep the phase's numerics
    out = dict(loss_card=lc, loss_cpu=lp, loss_rel_err=dl, grad_cosine=whole, worst_leaf=worst,
               worst_leaf_cosine=leaves[worst], planted_zero_rejected=named, secs=time.perf_counter() - t0)
    print(f"[dispatch gt5 prod] first step card vs CPU plain path, both bf16 + default: loss {lc:.6f} vs "
          f"{lp:.6f} (relative {dl:.3e}, limit {PROD_LOSS_TOL:.1e}); whole-gradient cosine 1 - {1 - whole:.3e} "
          f"(limit 1 - {1 - PROD_COS:.1e}); worst leaf {worst} cosine 1 - {1 - leaves[worst]:.3e} (limit 1 - "
          f"{1 - PROD_LEAF_COS:.1e}); control: zeroed "
          f"head db1 and mm dfb rejected on {named} ({out['secs']:.1f} s)", flush=True)
    return out


def phase_dispatch_prod(tables, card: str, fp32: dict) -> tuple:
    """[dispatch gt5 prod]: ``configs/gt5_production.yml`` as it is
    (``prod_cfg``): bf16, "default", half_feats, index-only batches, K=16,
    E=10.  (1) 37 steps as CUDA-graph dispatches of 16, 16 and 5 bitwise
    against 37 eager steps, launching the "default" kernels and no
    "highest" one; (2) the first step against the CPU plain path in the
    same numerics (``prod_step_check``) with its planted control; (3) step
    ms, samples/s, device busy and idle (torch.profiler), the peak memory of
    a captured step, beside [dispatch gt5]'s fp32 readings of this run.
    -> (launch counts per replayed step, readings)."""
    import torch

    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.data.ann_store import AnnTables
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, dispatch_sizes, make_multi_train_step, make_train_step

    cfg = prod_cfg()
    K, E = dispatch_sizes(cfg)
    B, n_steps = cfg.train.bs, sum(DISPATCH_GROUPS)
    anns, vids = random_ann_arrays(cfg, N_ANNS, tables.n_rows, seed=21)
    all_tables = {**tables.tables, **AnnTables.from_arrays(cfg, anns, vids, device="cuda").tables}
    del anns, vids
    batches = make_index_batches(cfg, n_steps + K * (DISPATCH_TIMED + 1), B, N_ANNS, tables.n_rows, seed=24)

    def fresh():
        return TrainState.create(cfg, get_model(cfg, 5000, device="cuda", seed=3, train=True))

    try:
        step, multi = make_train_step(cfg), make_multi_train_step(cfg)
        eager, graph = fresh(), fresh()
        e_aux, e_ms = [], []
        for b in batches[:n_steps]:
            db = {k: torch.as_tensor(v).cuda() for k, v in b.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e_aux.append(step(eager, db, 0, all_tables)[1])
            torch.cuda.synchronize()
            e_ms.append((time.perf_counter() - t0) * 1e3)
        g_aux, off = [], 0
        for i, n in enumerate(DISPATCH_GROUPS):
            if i == 1:
                _build.reset_counts()
            _, aux = multi(graph, stack_batches(batches[off:off + n]), 0, all_tables)
            aux["loss"].cpu()
            g_aux.append(aux)
            off += n
        counts = dict(_build.launches)
        diff = states_equal(graph, eager)
        if diff:
            fail(f"dispatch prod: {len(diff)} state tensors of the graph run differ from the eager steps: {diff[:5]}")
        for k in e_aux[0]:
            if not torch.equal(torch.cat([a[k] for a in g_aux]), torch.stack([a[k] for a in e_aux])):
                fail(f"dispatch prod: the graph's aux {k} differs from the eager steps'")
        losses = torch.cat([a["loss"] for a in g_aux]).cpu()
        if not torch.isfinite(losses).all() or int(graph.opt_state["total_notfinite"]) != 0:
            fail(f"dispatch prod: a non-finite loss or a dropped step ({losses.tolist()})")
        if not all(t.dtype == torch.float32 for t in graph.tensors().values() if t.is_floating_point()):
            fail("dispatch prod: a parameter or optimizer tensor is not fp32 in bf16 mode")
        replays = sum(DISPATCH_GROUPS[1:])
        want = path_names(cfg)
        if set(counts) != want:
            fail(f"dispatch prod: launched {sorted(counts)}, expected exactly {sorted(want)}")
        per_step = {k: v / replays for k, v in counts.items()}
        cap = next(iter(graph.graphs.values()))
        print(f"[dispatch gt5 prod] (1) {n_steps} steps (configs/gt5_production.yml: bf16, default, half_feats, "
              f"index-only, K={K}, E={E}) as CUDA-graph dispatches of {'+'.join(map(str, DISPATCH_GROUPS))} "
              f"bitwise equal to {n_steps} eager steps; losses first {float(losses[0]):.5f} last "
              f"{float(losses[-1]):.5f}; launches per replayed step {per_step}; peak memory of a captured step "
              f"{cap.peak_bytes / 1e9:.3f} GB (fp32: {fp32['peak_captured_step_gb']:.3f} GB)", flush=True)

        d_ms = []
        for _ in range(DISPATCH_TIMED):
            t0 = time.perf_counter()
            multi(graph, stack_batches(batches[off:off + K]), 0, all_tables)[1]["loss"].cpu()
            d_ms.append((time.perf_counter() - t0) * 1e3)
            off += K
        e_med, g_med = statistics.median(e_ms), statistics.median(d_ms) / K
        nxt = stack_batches(batches[off - K:off])
        split = {}
        g_busy, g_ksum = profiled_busy(lambda: multi(graph, nxt, 0, all_tables)[1]["loss"].cpu(), K, split)
        idle = None if g_busy is None else max(0.0, 1 - g_busy / g_med)
        top = sorted(split["other"].items(), key=lambda kv: -kv[1])[:8]
        readings = dict(eager_step_ms=e_med, graph_step_ms=g_med, graph_samples_per_s=B / g_med * 1e3,
                        graph_busy_ms=g_busy, graph_kernel_sum_ms=g_ksum, graph_idle=idle,
                        graph_dispatch_ms=d_ms, peak_captured_step_gb=cap.peak_bytes / 1e9,
                        launches_per_step=per_step, kernels_ms=split["ours"],
                        other_device_ms=sum(split["other"].values()), top_other=[[k[:60], v] for k, v in top])
        fmt = lambda x, u="": "not measured" if x is None else f"{x:.2f}{u}"  # noqa: E731
        print(f"[dispatch gt5 prod] (3) train step, host clock to a synchronize: eager median {e_med:.2f} ms, "
              f"graph {g_med:.2f} ms a step ({B / g_med * 1e3:.1f} samples/s, busy {fmt(g_busy, ' ms')}, idle "
              f"{fmt(idle)}); fp32 in this run: eager {fp32['eager_step_ms']:.2f} ms, graph "
              f"{fp32['graph_step_ms']:.2f} ms ({fp32['graph_samples_per_s']:.1f} samples/s, busy "
              f"{fmt(fp32['graph_busy_ms'], ' ms')}, idle {fmt(fp32['graph_idle'])}) on {card}", flush=True)
        print(f"[dispatch gt5 prod] (3) device ms a step by kernel: ours "
              + ", ".join(f"{k}={v:.3f}" for k, v in split["ours"].items())
              + f"; other {readings['other_device_ms']:.3f} ms in {len(split['other'])} ops: "
              + "; ".join(f"{k[:40]}={v:.3f}" for k, v in top), flush=True)
        readings["kernels_by_symbol_ms"] = split["by_symbol"]
        print("[dispatch gt5 prod] (3) device ms a step by kernel symbol: "
              + ", ".join(f"{k}={v:.4f}" for k, v in split["by_symbol"].items()), flush=True)
        del graph, eager
        gc.collect()
        torch.cuda.empty_cache()

        # (2) the first step against the CPU plain path, both in the production numerics
        parity = prod_cfg(dropout=0.0)
        tb = make_train_batches(parity, 1, B, tables.n_rows, 5000, seed=11)[0]
        sd = {k: v.detach().cpu() for k, v in
              get_model(parity, 5000, device="cuda", seed=3, train=True).state_dict().items()}
        readings["first_step"] = prod_step_check(parity, sd, tb, tables.tables)
    finally:
        apply_matmul_precision(serve_cfg())  # the phases after this one run fp32 / "highest"
    return counts, readings


# [learner gt5 prod]: the training entry point end to end at the recipe's
# widths, on a fixture written by the port's writer (the recipe's 15,000
# segments cut to 3,200; 2 epochs, not 10)
# [learner gt5 prod]: one fixture of BASELINE.md's GT5 curve set, 5,600
# segments in generate_scaled's proportions (70 / 25 / 5 %)
LEARNER_SEGS = (3920, 1400, 280)  # train / valid / test segments
LEARNER_EPOCHS = 6  # the curve's epochs
LEARNER_HORIZON = 24  # the cosine's epochs (train.total_steps), BASELINE.md's curve
LEARNER_CUT = 10  # SIGTERM after this dispatch of epoch 1, then resume
# the learnability bound, stated in PERF.md before the run: acc first past
# CURVE_PASS_ACC at epoch CURVE_PASS_BY or earlier, the best acc over the
# epochs at least CURVE_BEST_ACC, no non-finite step
CURVE_PASS_ACC, CURVE_PASS_BY, CURVE_BEST_ACC = 0.4, 5, 0.6
# the JAX package's curve on this recipe and data (BASELINE.md §GT5
# learnability curves, B=16 row, a TPU v5e run): acc by epoch
JAX_CURVE = {0: 0.083, 4: 0.735}


def read_events(tmp: Path, uid: str, kind: str) -> list:
    with open(tmp / "ext_logs" / f"{uid}.events.jsonl") as f:
        return [r for r in map(json.loads, f) if r["event"] == kind]


def release_card() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_learner(card: str, dispatch_prod: dict) -> tuple:
    """``learner_runs`` and ``phase_learner_keys``, then ``phase_serve_cli``
    and ``phase_export`` on its "best" checkpoint, in the yml's numerics; the phases after them run
    "highest".  -> (the learner's readings, the serve CLI's, the export's)."""
    import tempfile

    from vog_tpu_torch.config import apply_matmul_precision

    try:
        with tempfile.TemporaryDirectory(prefix="vog_learner_") as tmp:
            tmp = Path(tmp)
            learner = learner_runs(card, dispatch_prod, tmp)
            learner["keys"] = phase_learner_keys(card, tmp, dispatch_prod)
            serve = phase_serve_cli(card, tmp)
            export = phase_export(card, tmp, serve)
            return learner, serve, export
    finally:
        apply_matmul_precision(serve_cfg())


def learner_argv(tmp: Path, uid: str, *more) -> list:
    """``cli.train``-style arguments of the learner phase's runs: the yml
    as it is on the fixture, the curve's epochs, the cosine over
    ``LEARNER_HORIZON`` epochs (``tmp / "horizon"`` holds its steps)."""
    total = int((tmp / "horizon").read_text())
    return [uid, f"--cfg={ROOT / 'configs' / 'gt5_production.yml'}", f"--ds.data_dir={tmp / 'data'}",
            f"--train.epochs={LEARNER_EPOCHS}", f"--train.total_steps={total}", f"--misc.tmp_path={tmp / 'runs'}",
            *more]


def learner_runs(card: str, dispatch_prod: dict, tmp: Path) -> dict:
    """[learner gt5 prod]: ``python -m vog_tpu_torch.cli.train <uid>
    --cfg=configs/gt5_production.yml --ds.data_dir=<dir>`` through
    ``cli.train.main`` at the recipe's full widths, nothing else overridden
    but ``train.epochs``, ``train.total_steps`` and ``misc.tmp_path``.
    (1) ``generate_scaled`` writes the fixture (prop 2048, seg 3072, GloVe
    300, 10 frames, 5 proposals; ``LEARNER_SEGS``); the cosine's horizon is
    ``LEARNER_HORIZON`` epochs of its train split; (2) a Learner's
    ``validate()`` before training, then three epochs of it: the first
    captures the graphs, the second traced (device busy), the third
    untraced (wall), for the card's idle share; its state after two epochs
    is kept; (3) the curve run "curve": a SIGTERM after dispatch
    ``LEARNER_CUT`` of epoch 1, a resume to the end of epoch 1, whose state
    must be bitwise (2)'s after two epochs, and a resume to the end of
    ``LEARNER_EPOCHS``: every logged loss finite, no non-finite step, every
    "default" kernel of the path launched (counts per epoch), each epoch's
    acc beside ``JAX_CURVE``, the learnability bound (``CURVE_*``), the
    final acc above the untrained model's, "best" and "last" written,
    ``cli.eval`` on "best" giving the best epoch's acc again,
    ``offline.eval_fun`` on the last predictions file giving the Learner's
    metrics.  -> the readings, and the last resume's launch counts."""
    import signal

    import torch

    from vog_tpu_torch.cli import eval as eval_cli
    from vog_tpu_torch.cli import train as train_cli
    from vog_tpu_torch.data.fixtures import generate_scaled
    from vog_tpu_torch.data.loader import get_data
    from vog_tpu_torch.evaluation.offline import eval_fun
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.train import learner as learner_mod

    tag = "[learner gt5 prod]"
    out = {}
    data, runs = tmp / "data", tmp / "runs"
    t0 = time.perf_counter()
    generate_scaled(data, *LEARNER_SEGS, verbose=False)
    n_anns = {s: sum(1 for _ in open(data / f"anns_{s}.jsonl")) for s in ("train", "valid", "test")}
    out["fixture_s"] = time.perf_counter() - t0
    out["fixture_bytes"] = sum(f.stat().st_size for f in data.iterdir())
    out["split"] = {"segments": dict(zip(("train", "valid", "test"), LEARNER_SEGS)), "queries": n_anns}
    (tmp / "horizon").write_text("0")
    cfg = train_cli.build_cfg(train_cli.parse_argv(learner_argv(tmp, "x"))[1])
    n_steps = len(get_data(cfg).train_dl)
    K = cfg.train.steps_per_dispatch
    (tmp / "horizon").write_text(str(LEARNER_HORIZON * n_steps))
    argv = lambda uid, *more: learner_argv(tmp, uid, *more)  # noqa: E731
    print(f"{tag} (1) fixture by the port's writer: {'/'.join(map(str, LEARNER_SEGS))} train/valid/test "
          f"segments, {n_anns} queries, {out['fixture_bytes'] / 1e9:.3f} GB on disk "
          f"(featpack.bin {(data / 'featpack.bin').stat().st_size / 1e9:.3f} GB), written in "
          f"{out['fixture_s']:.1f} s; {n_steps} steps an epoch, train.total_steps "
          f"{LEARNER_HORIZON * n_steps} ({LEARNER_HORIZON} epochs)", flush=True)

    # (2) the untrained model's acc; an epoch that captures the graphs;
    # then an epoch with its eval under the tracer (the device's busy
    # time; the tracer slows the host, so its wall is not the epoch's)
    # and the next one untraced (the wall): the idle share of one
    # Learner's work.  No "best" save in either, so both do the same.
    lrn, _ = train_cli.build(argv("untrained"))
    acc0 = lrn.validate()["acc"]
    lrn.fit(epochs=1)
    lrn.best_metric = math.inf
    t0 = time.perf_counter()
    busy, ksum = profiled_busy(lambda: lrn.fit(epochs=1), 1)
    traced = (time.perf_counter() - t0) * 1e3
    two_epochs = {k: v.to("cpu", copy=True) for k, v in lrn.state.tensors().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lrn.fit(epochs=1)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    # what a save blocks the loop for: a plain synchronous host copy of the
    # state, against the Learner's (queued into pinned buffers on the
    # dispatches' stream; the writer thread waits for it and writes)
    t0 = time.perf_counter()
    plain_copy = {k: v.to("cpu", copy=True) for k, v in lrn.state.tensors().items()}
    out["plain_copy_s"] = time.perf_counter() - t0
    del plain_copy
    lrn.save("probe", blocking=False)
    lrn.wait_for_checkpoints()
    probe = read_events(runs, "untrained", "save")[-1]
    out["probe_save"] = {k: probe[k] for k in ("copy_s", "write_s", "bytes")}
    print(f"{tag} (2) a save's block: a plain synchronous .cpu() copy of the state {out['plain_copy_s']:.4f} s; "
          f"the Learner's queued copy into pinned buffers {probe['copy_s']:.4f} s, then its writer thread "
          f"{probe['write_s']:.4f} s ({probe['bytes'] / 1e6:.1f} MB) on {card}", flush=True)
    del lrn
    if busy is not None and busy > wall:
        fail(f"{tag} device busy {busy:.1f} ms over the traced epoch exceeds the untraced epoch's wall "
             f"{wall:.1f} ms")
    out.update(untrained_acc=acc0, profiled_busy_ms=busy, epoch_and_eval_ms=wall,
               idle=None if busy is None else 1 - busy / wall)
    print(f"{tag} (2) untrained acc {acc0:.4f}; an epoch with its eval under torch.profiler: device busy "
          f"{'not measured' if busy is None else f'{busy:.1f} ms'} (kernel sum {ksum:.1f} ms; traced wall "
          f"{traced:.1f} ms, the tracer's); the next epoch with its eval untraced: wall {wall:.1f} ms, "
          f"on {card}", flush=True)
    release_card()

    # (3) the curve: SIGTERM after dispatch LEARNER_CUT of epoch 1, a
    # resume to the end of epoch 1 (against (2)'s state), a resume to the end
    real, cut = learner_mod.make_multi_train_step, -(-n_steps // K) + LEARNER_CUT

    def cut_after(*args):
        multi, calls = real(*args), [0]

        def dispatch(*a, **kw):
            res = multi(*a, **kw)
            calls[0] += 1
            if calls[0] == cut:
                os.kill(os.getpid(), signal.SIGTERM)
            return res

        return dispatch

    t0 = time.perf_counter()
    learner_mod.make_multi_train_step = cut_after
    try:
        train_cli.main(argv("curve"))
    finally:
        learner_mod.make_multi_train_step = real
    release_card()
    last = runs / "models" / "curve" / "last.pt"
    meta = torch.load(last, weights_only=True)["meta"]
    if (meta["epoch"], meta["batch_in_epoch"]) != (1, LEARNER_CUT * K):
        fail(f"{tag} the SIGTERM save is at epoch {meta['epoch']} batch {meta['batch_in_epoch']}, expected "
             f"epoch 1 batch {LEARNER_CUT * K}")
    train_cli.main(argv("curve", "--train.resume=true", "--train.epochs=2"))
    release_card()
    a = torch.load(last, weights_only=True)["state"]
    diff = {k: float((a[k].double() - two_epochs[k].double()).abs().max()) for k in a
            if not torch.equal(a[k], two_epochs[k])}
    out["resume_max_abs_diff"] = max(diff.values(), default=0.0)
    print(f"{tag} (3) SIGTERM after dispatch {LEARNER_CUT} of epoch 1 (batch {meta['batch_in_epoch']}), resumed "
          f"to the end of epoch 1: the state against (2)'s after two epochs uninterrupted: "
          f"{len(a) - len(diff)}/{len(a)} tensors bitwise, max abs diff {out['resume_max_abs_diff']:.3e}",
          flush=True)
    if diff:
        fail(f"{tag} resume is not bitwise: {sorted(diff.items(), key=lambda kv: -kv[1])[:5]}")
    _build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    m = train_cli.main(argv("curve", "--train.resume=true"))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["last_resume_s"] = time.perf_counter() - t1
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    counts = dict(_build.launches)
    release_card()
    losses = [v for r in read_events(runs, "curve", "log") for v in r["losses"]]
    if not losses or not all(map(math.isfinite, losses)):
        fail(f"{tag} a logged loss is not finite: {[v for v in losses if not math.isfinite(v)][:5]}")
    state = torch.load(last, weights_only=True)["state"]
    out["nonfinite_steps"] = int(state["opt:total_notfinite"])
    if out["nonfinite_steps"]:
        fail(f"{tag} {out['nonfinite_steps']} non-finite steps")
    epochs = read_events(runs, "curve", "epoch")[-(LEARNER_EPOCHS - 2):]  # the last resume's, whole epochs
    want = path_names(cfg)
    missing = [k for k in sorted(want) if not counts.get(k)]
    if missing:
        fail(f"{tag} kernels of the path never launched: {missing} (launched {counts})")
    records = [json.loads(line) for line in open(runs / "ext_logs" / "curve.jsonl")]
    accs = [r["acc"] for r in records]
    if [r["epoch"] for r in records] != list(range(LEARNER_EPOCHS)):
        fail(f"{tag} eval records of epochs {[r['epoch'] for r in records]}, expected 0..{LEARNER_EPOCHS - 1}")
    for r in records:
        jax_acc = JAX_CURVE.get(r["epoch"])
        print(f"{tag} (3) epoch {r['epoch']}: acc {r['acc']:.4f}"
              + (f" (the JAX package: {jax_acc:.3f}, BASELINE.md)" if jax_acc is not None else ""), flush=True)
    passed = next((i for i, x in enumerate(accs) if x > CURVE_PASS_ACC), None)
    out.update(curve=accs, first_past_bound=passed, best_acc=max(accs))
    print(f"{tag} (3) the bound: acc first past {CURVE_PASS_ACC} at epoch {passed} (bound: {CURVE_PASS_BY} or "
          f"earlier), best {max(accs):.4f} (bound: {CURVE_BEST_ACC}), {out['nonfinite_steps']} non-finite steps "
          "(bound: 0)", flush=True)
    if passed is None or passed > CURVE_PASS_BY or max(accs) < CURVE_BEST_ACC:
        fail(f"{tag} the learnability bound is missed: acc by epoch {accs}")
    if m["acc"] <= acc0:
        fail(f"{tag} final acc {m['acc']:.4f} is not above the untrained model's {acc0:.4f}")
    for t in ("best", "last"):
        if not (runs / "models" / "curve" / f"{t}.pt").is_file():
            fail(f"{tag} no {t} checkpoint")
    evals = read_events(runs, "curve", "eval")
    offline = eval_fun(evals[-1]["pred_file"], "valid", cfg)
    keys = ("acc", "vacc", "strict_acc", "cons", "num_pairs", "num_queries")
    if {k: offline[k] for k in keys} != {k: m[k] for k in keys}:
        fail(f"{tag} offline.eval_fun {offline} differs from the Learner's metrics {m}")
    tables = read_events(runs, "curve", "tables")
    saves = read_events(runs, "curve", "save")
    # train.async_ckpt (the yml's default, true): the epochs' saves return
    # once their copy is queued; the SIGTERM save blocks
    sig = [s for s in saves if s["blocking"]]
    if len(sig) != 1 or (sig[0]["epoch"], sig[0]["batch_in_epoch"]) != (1, LEARNER_CUT * K):
        fail(f"{tag} expected one blocking save, the SIGTERM's: {[(s['tag'], s['blocking']) for s in saves]}")
    if sum(not s["blocking"] for s in saves) < LEARNER_EPOCHS:
        fail(f"{tag} the epochs' saves did not run asynchronously: {[(s['tag'], s['blocking']) for s in saves]}")
    best = max(records, key=lambda r: r["acc"])
    again = eval_cli.main(argv("curve", "--tag=best"))
    release_card()
    if again["acc"] != best["acc"]:
        fail(f"{tag} cli.eval on best gives acc {again['acc']} against the best epoch's {best['acc']}")
    out.update(metrics=m, losses_first_last=[losses[0], losses[-1]], launches=counts,
               launches_per_epoch=[e["kernel_launches"] for e in epochs],
               eval_launches=[e["kernel_launches"] for e in evals[-len(epochs):]],
               epoch_s=[e["seconds"] for e in epochs], samples_per_s=[e["samples_per_s"] for e in epochs],
               loader_wait_s=[e["loader_wait_s"] for e in epochs], dispatch_s=[e["dispatch_s"] for e in epochs],
               pairs_per_s=[e["pairs_per_s"] for e in epochs], dispatches=[e["dispatches"] for e in epochs],
               lr_end=[e["lr_end"] for e in epochs],
               tables=[{k: t[k] for k in ("table", "bytes", "seconds")} for t in tables],
               eval_batches_per_s=[e["batches_per_s"] for e in evals],
               saves=[{k: s[k] for k in ("tag", "bytes", "blocking", "copy_s", "write_s", "seconds")}
                      for s in saves])
    print(f"{tag} (3) cli.train: {len(losses)} logged losses finite, first {losses[0]:.5f} last {losses[-1]:.5f}; "
          f"acc {m['acc']:.4f} (untrained {acc0:.4f}), best {best['acc']:.4f} (epoch {best['epoch']}) again by "
          f"cli.eval on best; offline.eval_fun on {Path(evals[-1]['pred_file']).name} equal; the three runs "
          f"{out['run_s']:.1f} s", flush=True)
    for i, (e, ev) in enumerate(zip(epochs, evals[-len(epochs):])):
        print(f"{tag} (3) epoch {LEARNER_EPOCHS - len(epochs) + i} (learning rate at its end {e['lr_end']:.4e}) "
              "launches, train: " + ", ".join(f"{k}={v}" for k, v in sorted(e["kernel_launches"].items()))
              + "; its eval: " + ", ".join(f"{k}={v}" for k, v in sorted(ev["kernel_launches"].items())),
              flush=True)

    # (4) the numbers, each with the card
    feats = next(t for t in out["tables"] if t["table"] == "features")
    ann = next(t for t in out["tables"] if t["table"] == "annotations")
    save = [s for s in out["saves"] if not s["blocking"]]
    sig = next(s for s in out["saves"] if s["blocking"])
    for line in (
        f"table build: features {feats['seconds']:.2f} s, {feats['bytes'] / 1e9:.3f} GB; annotations "
        f"{ann['seconds']:.2f} s, {ann['bytes'] / 1e9:.4f} GB",
        "epoch wall s of the last resume (host blocked on the loader; in the dispatches and their reads): "
        + ", ".join(f"{v:.2f} ({w:.2f}; {d:.2f})" for v, w, d in zip(out["epoch_s"], out["loader_wait_s"],
                                                                   out["dispatch_s"])),
        "samples/s: " + ", ".join(f"{v:.1f}" for v in out["samples_per_s"])
        + f"; [dispatch gt5 prod] samples/s in this call: {dispatch_prod['graph_samples_per_s']:.1f}",
        "pairs/s: " + ", ".join(f"{v:.1f}" for v in out["pairs_per_s"]),
        "idle share over one epoch and its eval: "
        + ("not measured" if out["idle"] is None else f"{out['idle']:.3f} (device busy "
           f"{out['profiled_busy_ms']:.1f} ms traced, wall {out['epoch_and_eval_ms']:.1f} ms of the same "
           "Learner's next epoch untraced)"),
        "eval batches/s: " + ", ".join(f"{v:.1f}" for v in out["eval_batches_per_s"]),
        f"asynchronous saves (train.async_ckpt), the loop blocked by each one's host copy, s: "
        + ", ".join(f"{s['tag']} {s['copy_s']:.4f}" for s in save)
        + f"; their writes {statistics.median(s['write_s'] for s in save):.3f} s median "
        f"({min(s['write_s'] for s in save):.3f}-{max(s['write_s'] for s in save):.3f}) on the writer thread, "
        f"{save[0]['bytes'] / 1e6:.1f} MB; the SIGTERM save (blocking) {sig['seconds']:.3f} s",
        f"peak memory of the last resume: {out['peak_memory_gb']:.3f} GB",
    ):
        print(f"{tag} (4) {line} on {card}", flush=True)
    return out


CHECKIFY_STEPS = 4  # checked eager steps timed, after one untimed


def phase_learner_keys(card: str, tmp: Path, dispatch_prod: dict) -> dict:
    """[learner keys gt5]: the Learner's single-device keys at the recipe's
    widths on the learner phase's fixture, through ``cli.train.build``.
    ``misc.checkify``: K forced to 1; ``CHECKIFY_STEPS`` checked eager steps
    pass clean and are timed against the same steps eager unchecked and the
    graphed step of ``[dispatch gt5 prod]``; the next step with the feature
    table NaN must raise ``CheckifyError`` naming its op.
    ``misc.profile_dir``: an epoch whose trace covers its second dispatch,
    which must name every kernel of the path (``KERNEL_SYMBOLS``) and that
    dispatch's annotation, and not the first's.  ``misc.tensorboard_dir``:
    without the ``tensorboard`` package the "off" line must be logged, with
    it an event file written.  -> the readings."""
    import importlib.util

    import torch

    from vog_tpu_torch.cli import train as train_cli
    from vog_tpu_torch.train import make_train_step
    from vog_tpu_torch.train.checkify import CheckifyError

    tag = "[learner keys gt5]"
    out = {}
    argv = lambda uid, *more: learner_argv(tmp, uid, *more)  # noqa: E731

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    lrn, _ = train_cli.build(argv("checkify", "--misc.checkify=true"))
    if lrn.K != 1 or "train.steps_per_dispatch disabled" not in lrn.log_file.read_text():
        fail(f"{tag} misc.checkify left K={lrn.K} (the recipe's 16 must drop to 1, logged)")
    it = iter(lrn.data.train_dl)
    batches = [next(it) for _ in range(CHECKIFY_STEPS + 2)]
    it.close()
    run = lambda b, tables: lrn._train_multi(lrn.state, b, lrn.seed, tables)  # noqa: E731
    run(batches[0], lrn._tables)  # the first: kernels loaded, cuDNN's plans
    losses, checked = [], []
    for b in batches[1:-1]:
        checked.append(timed(lambda: losses.append(float(run(b, lrn._tables)[1]["loss"][0]))))
    if not all(map(math.isfinite, losses)):
        fail(f"{tag} a checked step's loss is not finite: {losses}")
    step = make_train_step(lrn.cfg)
    eager = [timed(lambda: step(lrn.state, {k: torch.as_tensor(v[0]).to(lrn.device) for k, v in b.items()},
                                lrn.seed, lrn._tables)) for b in batches[1:-1]]
    nan_tables = {**lrn._tables, "feats": torch.full_like(lrn._tables["feats"], float("nan"))}
    try:
        run(batches[-1], nan_tables)
        fail(f"{tag} a step with the feature table NaN passed misc.checkify")
    except CheckifyError as e:
        msg = str(e)
    if "nan generated by" not in msg:
        fail(f"{tag} the NaN step raised without naming its op: {msg}")
    out.update(checkify_step_ms=checked, eager_step_ms=eager, checkify_losses=losses, checkify_nan_error=msg)
    print(f"{tag} misc.checkify: {len(checked)} checked eager steps (K 16 -> 1, logged), losses finite "
          f"({', '.join(f'{v:.5f}' for v in losses)}); step ms checked {statistics.median(checked):.2f} "
          f"({', '.join(f'{v:.2f}' for v in checked)}), the same steps eager unchecked "
          f"{statistics.median(eager):.2f}, [dispatch gt5 prod]'s graphed step "
          f"{dispatch_prod['graph_step_ms']:.2f} in this call; the feature table NaN: {msg} on {card}", flush=True)
    del lrn, nan_tables, step
    release_card()

    prof_dir, tb_dir = tmp / "prof", tmp / "tb"
    lrn, _ = train_cli.build(argv("traced", f"--misc.profile_dir={prof_dir}", f"--misc.tensorboard_dir={tb_dir}"))
    K = lrn.K
    lrn.cfg.misc.profile_steps = K  # the trace covers the second dispatch alone
    t0 = time.perf_counter()
    lrn.fit(epochs=1)
    out["traced_epoch_s"] = time.perf_counter() - t0
    trace = prof_dir / "traced.ep0.trace.json"
    if not trace.is_file():
        fail(f"{tag} misc.profile_dir wrote no {trace.name} (found {sorted(p.name for p in prof_dir.glob('*'))})")
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    names = {e.get("name") for e in events}
    missing = {k: syms for k, syms in KERNEL_SYMBOLS.items()
               if not any(sym in name for sym in syms for name in kernels)}
    if missing or f"train dispatch at it {K}" not in names or "train dispatch at it 0" in names:
        fail(f"{tag} the trace of the second dispatch misses kernels {missing} or its annotation "
             f"({sorted(n for n in names if n and n.startswith('train dispatch'))})")
    out.update(trace_bytes=trace.stat().st_size, trace_kernel_names=len(kernels),
               trace_kernel_events=sum(e.get("cat") == "kernel" for e in events))
    print(f"{tag} misc.profile_dir: {trace.name}, {out['trace_bytes'] / 1e6:.1f} MB, the second dispatch "
          f"(\"train dispatch at it {K}\", not the first): {out['trace_kernel_events']} kernel events of "
          f"{len(kernels)} names, among them every kernel of the path ("
          + ", ".join(sorted({sym for syms in KERNEL_SYMBOLS.values() for sym in syms
                              if any(sym in n for n in kernels)})) + f"); the epoch with it {out['traced_epoch_s']:.1f} s",
          flush=True)
    log = lrn.log_file.read_text()
    if importlib.util.find_spec("tensorboard") is None:
        if "misc.tensorboard_dir set but tensorboard missing — off" not in log:
            fail(f"{tag} without tensorboard the Learner did not log the mirror off")
        out["tensorboard"] = "off (package missing), logged"
    else:
        files = list((tb_dir / "traced").glob("events.out.tfevents.*"))
        if not files:
            fail(f"{tag} tensorboard is installed but no event file was written under {tb_dir / 'traced'}")
        out["tensorboard"] = f"{len(files)} event file(s)"
    print(f"{tag} misc.tensorboard_dir: {out['tensorboard']}; training went on (the epoch's eval acc "
          f"{json.loads(open(tmp / 'runs' / 'ext_logs' / 'traced.jsonl').readlines()[-1])['acc']:.4f})",
          flush=True)
    del lrn
    release_card()
    return out


def valid_requests(data, n: int) -> list:
    from vog_tpu_torch.serving import batch_to_requests

    reqs = []
    for batch in data.valid_dl:
        reqs.extend(batch_to_requests(batch))
        if len(reqs) >= n:
            break
    return reqs[:n]


def stack_requests(reqs: list) -> dict:
    import numpy as np

    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    batch["batch_mask"] = np.ones((len(reqs),), np.uint8)
    return batch


def phase_serve_cli(card: str, tmp: Path) -> dict:
    """[serve cli gt5 prod]: ``python -m vog_tpu_torch.cli.serve curve
    --cfg=configs/gt5_production.yml --tag=best --selftest=96
    --concurrency=8`` through ``cli.serve.main`` on the learner phase's
    "best" checkpoint (its JSON line, the four "default" forward kernels
    launched); the CLI's predictor (``_build_predictor``) against
    ``Predictor.from_checkpoint`` in this process on 16 valid requests,
    bitwise; and the HTTP mode on a loopback port, in a thread: four
    ``POST /predict`` calls through urllib give the in-process call's
    ``pred_*``.  -> the selftest's readings."""
    import urllib.request

    import numpy as np

    from vog_tpu_torch.cli import serve as serve_cli
    from vog_tpu_torch.cli.train import build_cfg, parse_argv
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.serving import ServingLoop

    tag = "[serve cli gt5 prod]"
    _build.reset_counts()
    out = serve_cli.main(learner_argv(tmp, "curve", "--tag=best", "--selftest=96", "--concurrency=8"))
    counts = dict(_build.launches)
    release_card()
    cfg = build_cfg(parse_argv(learner_argv(tmp, "curve"))[1])
    want = sorted(path_names(cfg, FWD_NAMES))
    if [k for k in want if not counts.get(k)]:
        fail(f"{tag} forward kernels not launched by the selftest: {counts}")
    print(f"{tag} selftest (its JSON line above): p50 {out['p50_ms']:.3f} ms, p95 {out['p95_ms']:.3f} ms, "
          f"p99 {out['p99_ms']:.3f} ms, {out['requests_per_sec']:.1f} req/s; launches {counts} on {card}",
          flush=True)

    pred, data = serve_cli._build_predictor(cfg, "curve", "best", random_init=False)
    ref = Predictor.from_checkpoint(cfg, tmp / "runs" / "models" / "curve" / "best.pt", tables=pred.tables,
                                    glove=data.vocab.vectors)
    batch = stack_requests(valid_requests(data, 16))
    got, want_out = pred(batch), ref(batch)
    bad = [k for k in want_out if not np.array_equal(got[k], want_out[k])]
    if bad:
        fail(f"{tag} the CLI's predictor differs from Predictor.from_checkpoint on {bad}")
    del ref
    loop = ServingLoop(pred, max_batch=cfg.train.bs, max_wait_ms=2.0)
    srv = serve_cli._http_server(loop, 0, "127.0.0.1")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/predict"
        for r in valid_requests(data, 4):
            body = json.dumps({k: np.asarray(v).tolist() for k, v in r.items()}).encode()
            with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"), timeout=120) as f:
                resp = json.loads(f.read())
            direct = loop(r)
            for k in ("pred_vid", "pred_prop", "pred_box", "pred_score"):
                if not np.array_equal(np.asarray(resp[k], direct[k].dtype), direct[k]):
                    fail(f"{tag} HTTP {k} differs from the in-process call")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        loop.close()
    del pred, loop
    release_card()
    print(f"{tag} the CLI's predictor bitwise Predictor.from_checkpoint on 16 valid requests (every output); "
          "POST /predict on 127.0.0.1 gives the in-process pred_* for 4 requests", flush=True)
    return out


def phase_export(card: str, tmp: Path, live_serve: dict) -> dict:
    """[export gt5 prod]: ``cli.export`` of the "best" checkpoint at B=16,
    with the bf16 tables inside, and in the int8 encoding without tables
    (size, seconds); each program's nodes by target, every forward op of
    its path there (the gather only with tables); each artifact's replay,
    through its CUDA graph and eagerly (``cuda_graphs=False``), against the
    live ``Predictor(cuda_graphs=False)`` on 16 valid requests (the int8
    one given the request the artifact decodes): bitwise, both; the three
    B=16 calls with the host's issue in this call (``time_ms``): the graphed
    replay, the eager replay, the live graphed predictor; ``cli.serve
    --artifact --selftest=96 --concurrency=8`` (graphed) beside the live
    loop's selftest, with the four "default" forward kernels launched; a
    ``ServingLoop`` with ``bucket_sizes`` around the artifact raises.  ->
    the readings."""
    import numpy as np
    import torch

    from vog_tpu_torch.cli import export as export_cli
    from vog_tpu_torch.cli import serve as serve_cli
    from vog_tpu_torch.cli.train import build_cfg, parse_argv
    from vog_tpu_torch.data.device_store import DeviceFeatureTables
    from vog_tpu_torch.data.loader import get_data
    from vog_tpu_torch.export import ExportedPredictor, encode_features, forward_op_counts
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.serving import ServingLoop

    tag = "[export gt5 prod]"
    base = learner_argv(tmp, "curve", "--tag=best", "--batch=16")
    cfg = build_cfg(parse_argv(learner_argv(tmp, "curve"))[1])
    arts = {"bf16 tables": (tmp / "exports" / "tables", ["--with_tables"]),
            "int8": (tmp / "exports" / "int8", ["--encoding=int8"])}
    out = {}
    for name, (path, extra) in arts.items():
        r = export_cli.main(base + [f"--out={path}", *extra])
        release_card()
        nodes = {}
        for node in torch.export.load(str(path / "program.pt2")).graph.nodes:
            if node.op == "call_function":
                nodes[str(node.target)] = nodes.get(str(node.target), 0) + 1
        ops = forward_op_counts(torch.export.load(str(path / "program.pt2")).graph)
        # every forward op of the path as a node (the gather only with tables)
        if [k for k, v in ops.items() if (v > 0) != (k != "gather_rows" or name == "bf16 tables")]:
            fail(f"{tag} {name}: the program's forward ops {ops} (by target: {nodes})")
        out[name] = dict(bytes=r["bytes"], seconds=r["seconds"], self_check_max_abs_diff=r["max_abs_diff"],
                         ops=ops, nodes=sum(nodes.values()))
        print(f"{tag} {name}: exported in {r['seconds']:.1f} s, {r['bytes'] / 1e6:.1f} MB; program nodes by "
              f"target: forward ops {ops}, {sum(nodes.values())} call nodes of {len(nodes)} targets; the CLI's "
              f"self-check max |dscore| {r['max_abs_diff']:.3g}", flush=True)

    # the replays against the live predictor, eager
    data = get_data(cfg)
    store = data.valid_dl.ds.store
    dft = DeviceFeatureTables.from_store(cfg, store, half=cfg.misc.half_feats, int8=cfg.misc.int8_feats)
    best = tmp / "runs" / "models" / "curve" / "best.pt"
    live = Predictor.from_checkpoint(cfg, best, tables=dft.tables, glove=data.vocab.vectors, cuda_graphs=False)
    feats_reqs = valid_requests(data, 16)  # features in the request
    for dl in (data.valid_dl,):
        dl.ds.device_rows = dft.rows
    rows_reqs = valid_requests(data, 16)
    for name, reqs in (("bf16 tables", rows_reqs), ("int8", feats_reqs)):
        rep = ExportedPredictor(arts[name][0])
        eager = ExportedPredictor(arts[name][0], cuda_graphs=False)
        batch = stack_requests(reqs)
        if name == "int8":
            q = encode_features(batch, "int8")
            decoded = {**batch, "props": q["props"].astype(np.float32) * q["props_scale"][..., None],
                       "seg_feats": q["seg_feats"].astype(np.float32) * q["seg_scale"][..., None]}
        else:
            decoded = batch
        want = live(decoded)
        rep(batch)  # the capture
        _build.reset_counts()
        got = rep(batch)
        counts = dict(_build.launches)
        got_eager = eager(batch)
        bad = {way: [k for k in want if not np.array_equal(g[k], want[k])]
               for way, g in (("graphed", got), ("eager", got_eager))}
        out[name].update(bitwise=not any(bad.values()), launches=counts, graphs=len(rep.graphs))
        print(f"{tag} {name}: the replay through its CUDA graph ({len(rep.graphs)} captured) and eagerly, each "
              f"against the live Predictor(cuda_graphs=False) on 16 valid requests: "
              + ("bitwise, both" if not any(bad.values()) else f"outputs differ: {bad}")
              + f"; launches of one graphed replay {counts}", flush=True)
        if any(bad.values()) or len(rep.graphs) != 1:
            fail(f"{tag} {name}: a replay is not bitwise the live eager predictor's ({bad})")
        if name == "bf16 tables":
            try:
                ServingLoop(rep, max_batch=rep.batch_size, bucket_sizes=[1, 2, 4, 8])
                fail(f"{tag} a ServingLoop with bucket_sizes around the artifact did not raise")
            except ValueError as e:
                print(f"{tag} ServingLoop(bucket_sizes=[1, 2, 4, 8]) around the artifact raises: {e}", flush=True)
            graphed_live = Predictor.from_checkpoint(cfg, best, tables=dft.tables, glove=data.vocab.vectors)
            times = {way: time_ms(lambda p=p: p(batch), queued=False)
                     for way, p in (("artifact graphed", rep), ("artifact eager", eager),
                                    ("live graphed", graphed_live))}
            out["b16_call_ms"] = times
            print(f"{tag} a B=16 call with the host's issue (time_ms): "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
                  + f"; the graphed replay / the live graphed {times['artifact graphed'] / times['live graphed']:.2f}x"
                  f" on {card}", flush=True)
            del graphed_live
        del rep, eager
    del live, dft
    release_card()

    _build.reset_counts()
    art = serve_cli.main(learner_argv(tmp, "curve", f"--artifact={arts['bf16 tables'][0]}", "--selftest=96",
                                      "--concurrency=8"))
    counts = dict(_build.launches)
    release_card()
    if [k for k in sorted(path_names(cfg, FWD_NAMES)) if not counts.get(k)]:
        fail(f"{tag} forward kernels not launched by the artifact's selftest: {counts}")
    out["serve"] = art
    print(f"{tag} cli.serve --artifact --selftest=96 --concurrency=8: p50 {art['p50_ms']:.3f} ms, p95 "
          f"{art['p95_ms']:.3f} ms, {art['requests_per_sec']:.1f} req/s (fixed B=16 graphed, no buckets) against the "
          f"live loop's p50 {live_serve['p50_ms']:.3f} ms, p95 {live_serve['p95_ms']:.3f} ms, "
          f"{live_serve['requests_per_sec']:.1f} req/s (CUDA graphs, buckets) in this call; launches {counts} "
          f"on {card}", flush=True)
    return out


def phase_dispatch_p100_prod(tables, card: str, fp32: dict) -> tuple:
    """[dispatch p100 prod]: the P100 recipe in bf16 with "default"
    precision, one CUDA-graph dispatch of K=8 in each backward-mode pair
    (``MODE_PAIRS``): losses finite, no step dropped, the "default" kernels
    of the pair launched and no other; the step time of a second dispatch
    (host clock, over K) and the peak memory of a captured step beside
    [dispatch p100]'s fp32 readings.  -> (launch counts by pair, readings)."""
    import torch

    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_multi_train_step

    cfg = prod_cfg("p100")
    K, B = P100_DISPATCH_K, cfg.train.bs
    batches = make_train_batches(cfg, 2 * K, B, tables.n_rows, 5000, seed=31)
    counts, out = {}, {}
    try:
        for (fm, mm), (launched, absent) in MODE_PAIRS.items():
            key = f"flash {fm}, mm {mm}"
            with bwd_modes(fm, mm):
                state = TrainState.create(cfg, get_model(cfg, 5000, device="cuda", seed=3, train=True))
                multi = make_multi_train_step(cfg)
                _build.reset_counts()
                losses = multi(state, stack_batches(batches[:K]), 0, tables.tables)[1]["loss"].cpu()
                counts[key] = dict(_build.launches)
                t0 = time.perf_counter()
                losses = torch.cat([losses, multi(state, stack_batches(batches[K:]), 0,
                                                  tables.tables)[1]["loss"].cpu()])
                g_ms = (time.perf_counter() - t0) * 1e3 / K
            if not torch.isfinite(losses).all() or int(state.opt_state["total_notfinite"]) != 0:
                fail(f"dispatch p100 prod ({key}): a non-finite loss or a dropped step ({losses.tolist()})")
            want = path_names(cfg, launched)
            got = {k for k, v in counts[key].items() if v}
            if got != want:
                fail(f"dispatch p100 prod ({key}): launched {sorted(got)}, expected {sorted(want)}")
            cap = next(iter(state.graphs.values()))
            out[key] = dict(graph_step_ms=g_ms, samples_per_s=B / g_ms * 1e3,
                            peak_captured_step_gb=cap.peak_bytes / 1e9, loss_first=float(losses[0]),
                            loss_last=float(losses[-1]))
            print(f"[dispatch p100 prod] ({key}) bf16 + default, {2 * K} steps as two CUDA-graph dispatches of "
                  f"{K}: losses finite (first {float(losses[0]):.5f}, last {float(losses[-1]):.5f}), none "
                  f"dropped; graph {g_ms:.2f} ms a step ({B / g_ms * 1e3:.1f} samples/s), peak memory of a "
                  f"captured step {cap.peak_bytes / 1e9:.3f} GB; fp32 dispatch of this run (flash recompute, mm "
                  f"emit): {fp32['graph_step_ms']:.2f} ms, {fp32['peak_captured_step_gb']:.3f} GB on {card}",
                  flush=True)
            del state, multi
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        apply_matmul_precision(serve_cfg("p100"))
    return counts, out


# the JAX package's single-chip P100 run (BASELINE.md, "P100 at the largest
# single-chip-feasible scale"): 5,549 videos, an int8 store of 11,557 MB
P100_ROWS = 5549
P100_STORE_MB = 11557


def p100_tables(cfg):
    """The P100 int8 device tables at the JAX package's single-chip size,
    made on the card from a seed, 64 rows (0.5 GB of fp32) a chunk."""
    import torch

    from vog_tpu_torch.data.device_store import DeviceFeatureTables

    t0 = time.perf_counter()
    tables = DeviceFeatureTables.random(cfg, P100_ROWS, seed=0, int8=True, device="cuda", chunk_rows=64)
    torch.cuda.synchronize()
    ds = cfg.ds
    F, P = ds.num_frms, ds.num_prop_per_frm
    want = P100_ROWS * (F * P * ds.prop_dim + F * P * 4 + F * ds.seg_dim + F * 4)  # int8 rows, f32 scales
    got = sum(nbytes(t) for t in tables.tables.values())
    if got != want or abs(got / 1e6 - P100_STORE_MB) > 1.0:
        fail(f"P100 tables hold {got} bytes; expected {want} (the JAX package's {P100_STORE_MB} MB)")
    print(f"[tables p100] {P100_ROWS} rows int8 with f32 scales, {got / 1e6:.1f} MB on the card (the JAX "
          f"package's single-chip store: {P100_STORE_MB} MB), built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return tables


# PyTorch's warning that a thread ran cuBLAS with no current CUDA context,
# as recorded by ``watch_context_warnings``; the run fails on one
# [dist gt5 prod]: data parallelism across processes (vog_tpu_torch/train/dist.py)
DIST_ROWS = 3000  # feature-table rows a rank (a few thousand, not the serve phases' 15,000)
DIST_CHUNK = 250  # rows made by one generator: a shard's rows are the full table's
DIST_ANNS = 4000
DIST_GLOO_STEPS = 3
DIST_TIMEOUT = 600  # seconds a world may run before it is killed
EXIT_GRACE = 30.0  # seconds a world's ranks may take to exit once every rank has written its result


def dist_tables(cfg, first: int, n: int, device):
    """Rows [first, first + n) of one global random table (bf16 under
    ``half_feats``): each chunk of DIST_CHUNK rows from its own seeded
    generator, so a rank's shard holds bitwise the rows of the full table
    (``first`` a multiple of DIST_CHUNK)."""
    import torch

    from vog_tpu_torch.data.device_store import DeviceFeatureTables

    t = DeviceFeatureTables(cfg, n, half=cfg.misc.half_feats, device=device)
    fs, ss = t.shapes["feats"], t.shapes["seg"]
    for i0 in range(0, n, DIST_CHUNK):
        g = torch.Generator(device=device)
        g.manual_seed(1_000_003 + (first + i0) // DIST_CHUNK)
        m = min(DIST_CHUNK, n - i0)
        t.write(i0, torch.randn((m, *fs), generator=g, device=device) * 0.3,
                torch.randn((m, *ss), generator=g, device=device) * 0.3)
    return t


def _world_entry(rank, fn, world, backend, tmp, args):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        with open(f"{tmp}/result{rank}.part", "w") as f:
            json.dump(out, f)
        os.replace(f"{tmp}/result{rank}.part", f"{tmp}/result{rank}.json")  # whole when it has its name
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, backend: str, *args, timeout: float = DIST_TIMEOUT) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined in
    one ``backend`` group (rank r on card r under nccl, every rank on card
    0 under gloo) -> each rank's JSON result, in rank order.  A rank that
    raises, or a world past ``timeout`` seconds (killed), raises."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="vog_world_")
    try:
        ctx = mp.start_processes(_world_entry, args=(fn, world, backend, tmp, args), nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        done_at = None
        while not ctx.join(timeout=1.0):
            now = time.monotonic()
            if done_at is None and all(os.path.exists(f"{tmp}/result{r}.json") for r in range(world)):
                done_at = now  # every rank has its result: the rest is the group's teardown
            if done_at is not None and now > done_at + EXIT_GRACE:
                print(f"[world] {backend} world of {world}: every rank wrote its result but a rank had not "
                      f"exited {EXIT_GRACE:.0f} s later (the group's teardown); killed", flush=True)
                for p in ctx.processes:
                    p.kill()
                break
            if now > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"a {backend} world of {world} ranks ran past {timeout} s")
        out = []
        for r in range(world):
            with open(f"{tmp}/result{r}.json") as f:
                out.append(json.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def state_digest(state) -> str:
    """One hash of every state tensor's bytes: ranks whose digests agree hold
    bitwise the same state."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for k, v in state.tensors().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dist_setup(rank, world, cfg, n_rows, n_anns, n_batches, dev):
    """This rank's shard of the feature tables, the replicated annotation
    tables, and ``n_batches`` global index-only batches of train.bs x world
    rows -> (mesh, tables, global batches, this rank's rows of each)."""
    from vog_tpu_torch.data.ann_store import AnnTables
    from vog_tpu_torch.train.dist import local_batch_rows, make_mesh

    mesh = make_mesh(cfg)
    shard = dist_tables(cfg, rank * n_rows, n_rows, dev)
    anns, vids = random_ann_arrays(cfg, n_anns, n_rows * world, seed=21)
    tables = {**shard.tables, **AnnTables.from_arrays(cfg, anns, vids, device=dev).tables}
    batches = make_index_batches(cfg, n_batches, cfg.train.bs * world, n_anns, n_rows * world, seed=24)
    lo, hi = local_batch_rows(mesh, cfg.train.bs * world)
    return mesh, tables, batches, [{k: v[lo:hi] for k, v in b.items()} for b in batches]


def _full_tables(cfg, world, n_rows, n_anns, dev):
    """The replicated tables of one process: every rank's rows."""
    from vog_tpu_torch.data.ann_store import AnnTables

    anns, vids = random_ann_arrays(cfg, n_anns, n_rows * world, seed=21)
    return {**dist_tables(cfg, 0, n_rows * world, dev).tables,
            **AnnTables.from_arrays(cfg, anns, vids, device=dev).tables}


def _leaf_grads(state) -> dict:
    return {k: v.detach().cpu().clone() for k, v in state.leaves(state.flat.grad).items()}


def dist_nccl_rank(rank, world, cfg, cfg32, n_rows, n_anns):
    """(a) One rank of the NCCL world: the production recipe's graphed
    dispatch of K steps (the gradient's all-reduce, the loss's count and
    the sharded store's all-gather and reduce-scatters captured) bitwise
    against K eager steps of this world; at world 1 bitwise against the
    single-device dispatch; then a timed and a profiled dispatch.  With
    ``cfg32`` (world > 1) the first step in fp32 / "highest" against one
    process on the global batch (rank 0), within compare_step's bounds.
    Last, rank 0 alone times the single-device dispatch on its batches
    (the one card's step beside the world's, in this call)."""
    import torch

    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, dispatch_sizes, make_multi_train_step, make_train_step
    from vog_tpu_torch.train.dist import shard_batch_local

    dev = torch.device("cuda", rank)
    apply_matmul_precision(cfg)
    K, _ = dispatch_sizes(cfg)
    mesh, tables, batches, local = _dist_setup(rank, world, cfg, n_rows, n_anns, 3 * K, dev)

    def fresh(c):
        return TrainState.create(c, get_model(c, 5000, device=dev, seed=3, train=True))

    step, multi = make_train_step(cfg, mesh, shard_store=True), make_multi_train_step(cfg, mesh, shard_store=True)
    one = make_multi_train_step(cfg)  # the single-device dispatch
    eager, graph = fresh(cfg), fresh(cfg)
    e_aux, e_ms = [], []
    for b in local[:K]:
        db = shard_batch_local(b, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e_aux.append(step(eager, db, 0, tables)[1])
        torch.cuda.synchronize()
        e_ms.append((time.perf_counter() - t0) * 1e3)
    _build.reset_counts()
    _, g_aux = multi(graph, stack_batches(local[:K]), 0, tables)  # capture, then K replays
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    diff = states_equal(graph, eager)
    if diff:
        raise RuntimeError(f"rank {rank}: the graphed dispatch's state differs from {K} eager steps: {diff[:5]}")
    for k in e_aux[0]:
        if not torch.equal(g_aux[k], torch.stack([a[k] for a in e_aux])):
            raise RuntimeError(f"rank {rank}: the graphed dispatch's aux {k} differs from the eager steps'")
    losses = g_aux["loss"].cpu()
    if not torch.isfinite(losses).all():
        raise RuntimeError(f"rank {rank}: a non-finite loss {losses.tolist()}")
    out = {"counts": counts, "losses": losses.tolist(), "eager_step_ms": statistics.median(e_ms),
           "peak_captured_step_gb": next(iter(graph.graphs.values())).peak_bytes / 1e9}
    single, full = (fresh(cfg) if world == 1 else None), None
    if world == 1:  # the single-device dispatch on the same tables (the one shard is the table)
        one(single, stack_batches(local[:K]), 0, tables)
        diff = states_equal(single, graph)
        if diff:
            raise RuntimeError(f"the world-1 nccl dispatch differs from the single-device dispatch: {diff[:5]}")
        out["single_bitwise"] = True
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    nxt = stack_batches(local[K:2 * K])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multi(graph, nxt, 0, tables)[1]["loss"].cpu()
    out["graph_step_ms"] = (time.perf_counter() - t0) * 1e3 / K
    out["samples_per_s"] = cfg.train.bs * world / out["graph_step_ms"] * 1e3
    split = {}
    busy, _ = profiled_busy(lambda: multi(graph, stack_batches(local[2 * K:3 * K]), 0, tables)[1]["loss"].cpu(),
                            K, split)
    nccl = {k[:60]: v for k, v in split["other"].items() if "nccl" in k.lower()}
    out.update(busy_ms=busy, nccl_ms=nccl, nccl_ms_total=sum(nccl.values()), digest=state_digest(graph))
    del graph
    gc.collect()
    torch.cuda.empty_cache()

    if cfg32 is not None:  # the first step against one process on the global batch, fp32 "highest"
        apply_matmul_precision(cfg32)
        st = fresh(cfg32)
        _, aux = make_train_step(cfg32, mesh, shard_store=True)(st, shard_batch_local(local[0], dev), 0, tables)
        got = (float(aux["loss"]), _leaf_grads(st))
        del st
        if rank == 0:
            full = _full_tables(cfg32, world, n_rows, n_anns, dev)
            ref = fresh(cfg32)
            _, raux = make_train_step(cfg32)(ref, shard_batch_local(batches[0], dev), 0, full)
            lp, gp = float(raux["loss"]), _leaf_grads(ref)
            if not abs(got[0] - lp) <= 1e-4 * abs(lp):
                raise RuntimeError(f"world {world}: first loss {got[0]:.7f} != one process's {lp:.7f}")
            bad = grad_faults(got[1], gp)
            if bad:
                raise RuntimeError(f"world {world}: gradients differ from one process's (leaf, max |err|, rel): "
                                   f"{bad[:5]}")
            out["fp32_first_step"] = {"loss": got[0], "one_process_loss": lp,
                                      "max_abs_err": max(max_err(got[1][k], r) for k, r in gp.items()),
                                      "worst_rel": max(rel_err(got[1][k], r) for k, r in gp.items())}
            del ref
    if rank == 0:  # the single-device dispatch on this rank's batches, timed as the world's
        apply_matmul_precision(cfg)
        if single is None:
            full = full if full is not None else _full_tables(cfg, world, n_rows, n_anns, dev)
            single = fresh(cfg)
            one(single, stack_batches(local[:K]), 0, full)  # the capture
        tabs = tables if world == 1 else full
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one(single, stack_batches(local[K:2 * K]), 0, tabs)[1]["loss"].cpu()
        out["single_card_step_ms"] = (time.perf_counter() - t0) * 1e3 / K
        out["single_card_samples_per_s"] = cfg.train.bs / out["single_card_step_ms"] * 1e3
    return out


def dist_gloo_rank(rank, world, cfg, n_rows, n_anns, steps):
    """(b) One rank of a gloo world sharing card 0: every kernel, eager
    single steps with the row-sharded store (collectives staged through the
    host) on this rank's rows, one eval through ``gather_eval``; rank 0
    then runs one process on the global batches with the full tables and
    compares the losses, the first step's gradients and the eval sums."""
    import torch

    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_eval_step, make_train_step
    from vog_tpu_torch.train.dist import shard_batch_local
    from vog_tpu_torch.train.multihost import gather_eval

    dev = torch.device("cuda", 0)
    apply_matmul_precision(cfg)
    mesh, tables, batches, local = _dist_setup(rank, world, cfg, n_rows, n_anns, steps, dev)
    sum_keys = ("n_pairs", "n_acc", "n_vacc", "n_queries", "n_strict", "n_cons", "loss_sum", "n_batch")

    def fresh():
        return TrainState.create(cfg, get_model(cfg, 5000, device=dev, seed=3, train=True))

    def run(state, train_step, eval_step, bs, tabs):
        ev = eval_step(state, shard_batch_local(bs[0], dev), tabs)
        sums = {k: float(ev[k]) for k in sum_keys}
        losses, grads, ms = [], None, []
        for b in bs:
            db = shard_batch_local(b, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, aux = train_step(state, db, 0, tabs)
            losses.append(float(aux["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            if grads is None:
                grads = _leaf_grads(state)
        return sums, losses, grads, ms

    state = fresh()
    _build.reset_counts()
    sums, losses, grads, ms = run(state, make_train_step(cfg, mesh, shard_store=True),
                                  make_eval_step(cfg, mesh, shard_store=True), local, tables)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    sums, preds = gather_eval(sums, [int(i) for i in local[0]["ann_idx"]], mesh.group)
    if preds != [int(i) for i in batches[0]["ann_idx"]]:
        raise RuntimeError(f"rank {rank}: gather_eval's predictions are not the global batch's in rank order")
    out = {"counts": counts, "losses": losses, "step_ms": statistics.median(ms),
           "samples_per_s": cfg.train.bs * world / statistics.median(ms) * 1e3, "sums": sums,
           "digest": state_digest(state)}
    del state
    gc.collect()
    if rank == 0:
        full = _full_tables(cfg, world, n_rows, n_anns, dev)
        rsums, rlosses, rgrads, _ = run(fresh(), make_train_step(cfg), make_eval_step(cfg), batches, full)
        for i, (a, b) in enumerate(zip(losses, rlosses)):
            if not abs(a - b) <= 1e-4 * abs(b):
                raise RuntimeError(f"gloo world: step {i} loss {a:.7f} != one process's {b:.7f}")
        bad = grad_faults(grads, rgrads)
        if bad:
            raise RuntimeError(f"gloo world: first-step gradients differ from one process's: {bad[:5]}")
        for k in sum_keys:
            lim = 1e-4 * abs(rsums[k]) if k == "loss_sum" else (0 if k in ("n_pairs", "n_queries", "n_batch")
                                                                 else 1)
            if not abs(sums[k] - rsums[k]) <= lim:
                raise RuntimeError(f"gloo world: eval {k} {sums[k]} != one process's {rsums[k]}")
        out["one_process"] = {"losses": rlosses, "sums": rsums,
                              "max_abs_err": max(max_err(grads[k], r) for k, r in rgrads.items())}
    return out


def dist_cfgs(world: int):
    """-> ((a)'s production recipe and its fp32 "highest" twin for the
    world > 1 parity step, or None), (b)'s fp32 recipe: each with
    ``misc.multihost`` and the row-sharded store."""
    a = prod_cfg()
    b = train_cfg(0.1)
    for c in (a, b):
        c.misc.multihost, c.ds.device_store = True, "shard"
    b.train.steps_per_dispatch = 1
    a32 = None
    if world > 1:
        a32 = prod_cfg(dropout=0.0)
        a32.mdl.dtype, a32.misc.matmul_precision = "float32", "highest"
        a32.misc.multihost, a32.ds.device_store = True, "shard"
    return a, a32, b


def phase_dist(card: str) -> dict:
    """[dist gt5 prod]: (a) an NCCL world of every card (``dist_nccl_rank``)
    and (b) a gloo world of 2 ranks on card 0 (``dist_gloo_rank``), each
    spawned from here; the ranks' states bitwise equal (digests), every
    kernel of the path launched in each world; backend, world, step ms and
    samples/s printed."""
    import torch

    from vog_tpu_torch.config import apply_matmul_precision

    release_card()
    world = torch.cuda.device_count()
    a, a32, b = dist_cfgs(world)
    t0 = time.perf_counter()
    try:
        ra = run_world(dist_nccl_rank, world, "nccl", a, a32, DIST_ROWS, DIST_ANNS)
    except Exception as e:
        fail(f"dist nccl world of {world}: {e}")
    ta = time.perf_counter() - t0
    want = path_names(a)
    r0 = ra[0]
    if set(r0["counts"]) != want or min(r0["counts"].values()) <= 0:
        fail(f"dist nccl: launched {r0['counts']}, expected each of {sorted(want)}")
    if len({r["digest"] for r in ra}) != 1:
        fail("dist nccl: the ranks' states differ after the dispatches")
    K = len(r0["losses"])
    share = r0["nccl_ms_total"] / r0["graph_step_ms"]
    print(f"[dist gt5 prod] (a) backend nccl, world {world} (spawned, rank r on card r; "
          f"{DIST_ROWS} rows a rank, row-sharded bf16 store): a graphed dispatch of K={K} bitwise equal to {K} "
          f"eager steps{' and to the single-device dispatch' if world == 1 else ''}; the ranks' states bitwise "
          f"equal; step ms eager {r0['eager_step_ms']:.2f}, graph {r0['graph_step_ms']:.2f} "
          f"({r0['samples_per_s']:.1f} samples/s, global batch {a.train.bs * world}); device busy "
          f"{r0['busy_ms'] if r0['busy_ms'] is None else round(r0['busy_ms'], 3)} ms a step, nccl kernels "
          f"{r0['nccl_ms_total']:.3f} ms ({share:.3f} of the step: {r0['nccl_ms']}); peak memory of a captured "
          f"step {r0['peak_captured_step_gb']:.3f} GB; launches (the capture's warm-up step and {K} replays) "
          f"{r0['counts']}; the single-device dispatch on rank 0's batches in this call: "
          f"{r0['single_card_step_ms']:.2f} ms a step ({r0['single_card_samples_per_s']:.1f} samples/s); world "
          f"run {ta:.1f} s on {card}", flush=True)
    if "fp32_first_step" in r0:
        f = r0["fp32_first_step"]
        print(f"[dist gt5 prod] (a) fp32 highest first step of the world of {world} against one process on the "
              f"global batch of {a.train.bs * world}: loss {f['loss']:.7f} vs {f['one_process_loss']:.7f}, "
              f"max |err| {f['max_abs_err']:.2e}, worst relative {f['worst_rel']:.2e}", flush=True)
    t0 = time.perf_counter()
    try:
        rb = run_world(dist_gloo_rank, 2, "gloo", b, DIST_ROWS, DIST_ANNS, DIST_GLOO_STEPS)
    except Exception as e:
        fail(f"dist gloo world of 2: {e}")
    tb = time.perf_counter() - t0
    want_b = set(KERNEL_NAMES)
    if set(rb[0]["counts"]) != want_b or min(rb[0]["counts"].values()) <= 0:
        fail(f"dist gloo: launched {rb[0]['counts']}, expected each of {sorted(want_b)}")
    if rb[0]["digest"] != rb[1]["digest"]:
        fail(f"dist gloo: the two ranks' states differ after {DIST_GLOO_STEPS} steps")
    one = rb[0]["one_process"]
    print(f"[dist gt5 prod] (b) backend gloo, world 2 on one card (fp32, dropout 0.1, row-sharded store, eager "
          f"K=1): {DIST_GLOO_STEPS} losses {rb[0]['losses']} vs one process {one['losses']}, first-step gradient "
          f"max |err| {one['max_abs_err']:.2e}; eval sums through gather_eval {rb[0]['sums']} vs {one['sums']}; "
          f"the ranks' states bitwise equal; step ms {rb[0]['step_ms']:.2f} ({rb[0]['samples_per_s']:.1f} "
          f"samples/s, global batch {b.train.bs * 2}); world run {tb:.1f} s on {card}", flush=True)
    apply_matmul_precision(serve_cfg())
    return {"nccl": {"world": world, **{k: v for k, v in r0.items() if k != "digest"}, "seconds": ta},
            "gloo": {"world": 2, **{k: v for k, v in rb[0].items() if k != "digest"}, "seconds": tb}}


# [model axis gt5 prod]: tensor parallelism and the sequence-parallel ring
# (vog_tpu_torch/train/dist.py, model/parallel.py, kernels/ring_attention.py)
MA_ROWS = 3000  # feature-table rows, replicated on each card (a few thousand, as [dist gt5 prod])
MA_ANNS = 4000
MA_STEPS = 3  # (b)'s eager TP steps, run twice (the rerun's gathered state bitwise the first's)
MA_REQUESTS = 16  # (b)'s requests through the follower: one flush of max_batch 16
SP_P100_ROWS = 64  # [sp p100 serve]: random int8 P100 rows a card holds (8.2 MB a row)
SP_P100_REQUESTS = 16
SP_SERVE_TOL = 2e-4  # of max|score|: the ring against the single-card predictor, fp32


def _whole_leaf_grads(state, cfg) -> dict:
    """The step's gradient by parameter, each sharded leaf gathered over the
    model axis (a collective of the model group) -> host tensors."""
    from vog_tpu_torch.train.dist import gather_tensor, tp_rule

    tp = getattr(state.model, "tp", None)
    return {k: (v if tp is None else gather_tensor(v, tp_rule(k, cfg), tp)).detach().cpu().clone()
            for k, v in state.leaves(state.flat.grad).items()}


def _digest(tensors) -> str:
    import hashlib

    import torch

    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def whole_digest(state) -> str:
    """The hash of the state gathered whole (a collective of the model group)."""
    return _digest(state.whole_tensors())


def replicated_digest(state, cfg) -> str:
    """The hash of this rank's whole (unsharded) parameters."""
    from vog_tpu_torch.train.dist import tp_rule

    return _digest({k: p for k, p in state.model.named_parameters() if tp_rule(k, cfg) is None})


def ma_cfg(base, mesh_model: int, sp: bool = False, decomposed: bool = True):
    import copy

    c = copy.deepcopy(base)
    c.misc.multihost, c.misc.mesh_model, c.misc.mesh_data = True, mesh_model, -1
    c.mdl.sp_attention, c.mdl.decomposed_mm = sp, decomposed
    return c


def _step_runs(c, mesh, batches, tables, dev):
    """Eager train steps of ``c`` on ``mesh`` (None: one process) from the
    seed-3 model -> (state, losses, the first step's whole gradients, ms a
    step)."""
    import torch

    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_train_step
    from vog_tpu_torch.train.dist import shard_batch_local

    st = TrainState.create(c, get_model(c, 5000, device=dev, seed=3, train=True, mesh=mesh))
    step = make_train_step(c, mesh)
    losses, grads, ms = [], None, []
    for b in batches:
        db = shard_batch_local(b, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, aux = step(st, db, 0, tables)
        losses.append(float(aux["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if grads is None:
            grads = _whole_leaf_grads(st, c)
    return st, losses, grads, ms


def _against_one(what, losses, grads, ref_losses, ref_grads) -> dict:
    """Losses within 1e-4 relative and every gradient within
    ``grad_faults``' limits of one process's, else raise."""
    for i, (a, b) in enumerate(zip(losses, ref_losses)):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise RuntimeError(f"{what}: step {i} loss {a:.7f} != one process's {b:.7f}")
    bad = grad_faults(grads, ref_grads)
    if bad:
        raise RuntimeError(f"{what}: first-step gradients differ from one process's: {bad[:5]}")
    return {"losses": losses, "one_process_losses": ref_losses,
            "max_abs_err": max(max_err(grads[k], r) for k, r in ref_grads.items()),
            "worst_rel": max(rel_err(grads[k], r) for k, r in ref_grads.items())}


def ring_ms(mesh, dev, B: int, H: int, T: int, dh: int, reps: int = 5) -> dict:
    """The ring's forward and forward + backward ms at one attention
    layer's shapes (this rank's T/m block), every model rank timing it
    together."""
    import torch

    from vog_tpu_torch.kernels.ring_attention import ring_attention

    g = torch.Generator(device=dev).manual_seed(mesh.rank)
    n = T // mesh.model
    q, k, v = (torch.randn(B, H, n, dh, device=dev, generator=g, requires_grad=True) for _ in range(3))
    mask = torch.ones(B, n, device=dev)

    def fwd():
        with torch.no_grad():
            ring_attention(q, k, v, mask, None, None, mesh)

    def fwd_bwd():
        ring_attention(q, k, v, mask, None, None, mesh).sum().backward()

    out = {}
    for name, fn in (("fwd_ms", fwd), ("fwd_bwd_ms", fwd_bwd)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def model_axis_gloo_rank(rank, world, tp_cfg, sp_cfgs, serve_c, n_rows, n_anns, steps):
    """(b) One rank of a gloo world of 2 on card 0, mesh (1, 2), fp32: the
    TP eager steps (every kernel at 2 heads), twice (the rerun's gathered
    state bitwise the first's); one step with the ring for each of
    ``sp_cfgs``; one serve flush through the follower.  Rank 0 holds each
    against one process on the card."""
    import numpy as np
    import torch

    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.serving import ServingLoop
    from vog_tpu_torch.train.dist import make_mesh

    dev = torch.device("cuda", 0)
    apply_matmul_precision(tp_cfg)
    tables = _full_tables(tp_cfg, 1, n_rows, n_anns, dev)
    batches = make_index_batches(tp_cfg, steps, tp_cfg.train.bs, n_anns, n_rows, seed=24)
    mesh = make_mesh(tp_cfg)
    _build.reset_counts()
    st, losses, grads, ms = _step_runs(tp_cfg, mesh, batches, tables, dev)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    out = {"mesh": [mesh.data, mesh.model], "backend": mesh.backend, "counts": counts,
           "step_ms": statistics.median(ms), "samples_per_s": tp_cfg.train.bs / statistics.median(ms) * 1e3,
           "replicated": replicated_digest(st, tp_cfg), "gathered": whole_digest(st)}
    del st
    st, rerun, _, _ = _step_runs(tp_cfg, mesh, batches, tables, dev)
    out["rerun_gathered"], out["rerun_losses"] = whole_digest(st), rerun
    del st
    if rank == 0:
        one, l1, g1, ms1 = _step_runs(ma_cfg(tp_cfg, 1), None, batches, tables, dev)
        del one
        out["tp"] = _against_one("model axis gloo tp", losses, grads, l1, g1)
        out["one_process_step_ms"] = statistics.median(ms1)
    gc.collect()
    out["sp"] = {}
    for c in sp_cfgs:
        key = "decomposed" if c.mdl.decomposed_mm else "materialised"
        m_sp = make_mesh(c)
        _build.reset_counts()
        st, l_sp, g_sp, ms_sp = _step_runs(c, m_sp, batches[:1], tables, dev)
        rec = {"counts": dict(_build.launches), "step_ms": ms_sp[0], "replicated": replicated_digest(st, c)}
        del st
        if rank == 0:
            one, l1, g1, _ = _step_runs(ma_cfg(c, 1, sp=False, decomposed=c.mdl.decomposed_mm), None, batches[:1],
                                        tables, dev)
            del one
            rec.update(_against_one(f"model axis gloo sp ({key})", l_sp, g_sp, l1, g1))
        out["sp"][key] = rec
        gc.collect()
    H, dh = tp_cfg.mdl.n_heads, tp_cfg.mdl.vis_dim // tp_cfg.mdl.n_heads
    out["ring"] = ring_ms(m_sp, dev, tp_cfg.train.bs, H, 200, dh)

    apply_matmul_precision(serve_c)
    m_serve = make_mesh(serve_c)
    sd = get_model(ma_cfg(serve_c, 1, sp=False), 5000, device=dev, seed=3).state_dict()
    pred = Predictor(serve_c, sd, 5000, tables=tables, device=dev, cuda_graphs=False, mesh=m_serve)
    if m_serve.model_index != 0:
        out["followed"] = pred.follow()
        return out
    reqs = make_requests(serve_c, MA_REQUESTS, n_rows, 5000, seed=31)
    loop = ServingLoop(pred, max_batch=MA_REQUESTS, max_wait_ms=200.0)
    try:
        got = [f.result(timeout=300) for f in [loop.submit(r) for r in reqs]]
    finally:
        loop.close()
        pred.close()
    one = Predictor(ma_cfg(serve_c, 1, sp=False), sd, 5000, tables=tables, device=dev, cuda_graphs=False)
    want = one(stack_requests(reqs) | {"batch_mask": np.ones(len(reqs), np.uint8)})
    valid = want["scores"] > -1e29
    scale = float(np.abs(want["scores"][valid]).max())
    err = max(float(np.abs(g["scores"] - want["scores"][i]).max()) for i, g in enumerate(got))
    if not err <= SP_SERVE_TOL * scale:
        raise RuntimeError(f"model axis gloo serve: the follower's flush scores differ from one predictor's by "
                           f"{err:.3e} (limit {SP_SERVE_TOL * scale:.3e})")
    out["serve"] = {"requests": len(got), "max_abs_err": err, "limit": SP_SERVE_TOL * scale}
    return out


def model_axis_nccl_rank(rank, world, meshes, n_rows, n_anns):
    """(a) One rank of an NCCL world of every card, one mesh after another
    (``meshes``: (the production recipe on it, its fp32 "highest" twin)):
    the graphed dispatch of K steps (both axes' collectives and the ring's
    P2P captured) bitwise K eager steps; a timed and a profiled dispatch;
    the fp32 first step against one process on the global batch (rank 0);
    rank 0 times the single-card dispatch on its batches in the same call.
    Then [sp p100 serve]."""
    import torch

    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, dispatch_sizes, make_multi_train_step, make_train_step
    from vog_tpu_torch.train.dist import local_batch_rows, make_mesh, shard_batch_local

    dev = torch.device("cuda", rank)
    results = []
    tables = None
    for cfg, cfg32 in meshes:
        apply_matmul_precision(cfg)
        K, _ = dispatch_sizes(cfg)
        mesh = make_mesh(cfg)
        if tables is None:
            tables = _full_tables(cfg, 1, n_rows, n_anns, dev)
        gbs = cfg.train.bs * mesh.data
        batches = make_index_batches(cfg, 3 * K, gbs, n_anns, n_rows, seed=24)
        lo, hi = local_batch_rows(mesh, gbs)
        local = [{k: v[lo:hi] for k, v in b.items()} for b in batches]

        def fresh(c, m=mesh):
            return TrainState.create(c, get_model(c, 5000, device=dev, seed=3, train=True, mesh=m))

        step, multi = make_train_step(cfg, mesh), make_multi_train_step(cfg, mesh)
        eager, graph = fresh(cfg), fresh(cfg)
        e_aux, e_ms = [], []
        for b in local[:K]:
            db = shard_batch_local(b, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e_aux.append(step(eager, db, 0, tables)[1])
            torch.cuda.synchronize()
            e_ms.append((time.perf_counter() - t0) * 1e3)
        _build.reset_counts()
        _, g_aux = multi(graph, stack_batches(local[:K]), 0, tables)  # capture, then K replays
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        diff = states_equal(graph, eager)
        if diff:
            raise RuntimeError(f"rank {rank} mesh {mesh.data}x{mesh.model}: the graphed dispatch's state differs "
                               f"from {K} eager steps: {diff[:5]}")
        for k in e_aux[0]:
            if not torch.equal(g_aux[k], torch.stack([a[k] for a in e_aux])):
                raise RuntimeError(f"rank {rank}: the graphed dispatch's aux {k} differs from the eager steps'")
        losses = g_aux["loss"].cpu()
        if not torch.isfinite(losses).all():
            raise RuntimeError(f"rank {rank}: a non-finite loss {losses.tolist()}")
        out = {"mesh": [mesh.data, mesh.model], "sp": bool(cfg.mdl.sp_attention), "counts": counts,
               "losses": losses.tolist(), "eager_step_ms": statistics.median(e_ms),
               "peak_captured_step_gb": next(iter(graph.graphs.values())).peak_bytes / 1e9}
        del eager
        release_card()
        nxt = stack_batches(local[K:2 * K])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(graph, nxt, 0, tables)[1]["loss"].cpu()
        out["graph_step_ms"] = (time.perf_counter() - t0) * 1e3 / K
        out["samples_per_s"] = gbs / out["graph_step_ms"] * 1e3
        split = {}
        busy, _ = profiled_busy(lambda: multi(graph, stack_batches(local[2 * K:3 * K]), 0, tables)[1]["loss"].cpu(),
                                K, split)
        nccl = {k[:60]: v for k, v in split["other"].items() if "nccl" in k.lower()}
        out.update(busy_ms=busy, nccl_ms=nccl, nccl_ms_total=sum(nccl.values()),
                   replicated=replicated_digest(graph, cfg), gathered=whole_digest(graph))
        del graph
        release_card()

        apply_matmul_precision(cfg32)  # the first step against one process on the global batch
        st, l32, g32, _ = _step_runs(cfg32, make_mesh(cfg32), local[:1], tables, dev)
        del st
        if rank == 0:
            ref, lp, gp, _ = _step_runs(ma_cfg(cfg32, 1, sp=False), None, batches[:1], tables, dev)
            del ref
            out["fp32_first_step"] = _against_one(f"mesh {mesh.data}x{mesh.model}", l32, g32, lp, gp)
            apply_matmul_precision(cfg)  # the single-card dispatch on rank 0's batches, timed as the world's
            one = make_multi_train_step(ma_cfg(cfg, 1, sp=False))
            single = fresh(ma_cfg(cfg, 1, sp=False), None)
            one(single, stack_batches(local[:K]), 0, tables)  # the capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one(single, stack_batches(local[K:2 * K]), 0, tables)[1]["loss"].cpu()
            out["single_card_step_ms"] = (time.perf_counter() - t0) * 1e3 / K
            out["single_card_samples_per_s"] = cfg.train.bs / out["single_card_step_ms"] * 1e3
            del single
        release_card()
        results.append(out)
    del tables
    release_card()
    return {"meshes": results, "sp_p100_serve": sp_p100_serve(rank, world)}


def _serve_pass(loop, reqs, clients: int) -> list:
    """Every request of ``reqs`` from ``clients`` threads -> (latencies
    in ms, responses in request order)."""
    lat, got = [0.0] * len(reqs), [None] * len(reqs)

    def client(i0):
        for i in range(i0, len(reqs), clients):
            t0 = time.perf_counter()
            got[i] = loop(reqs[i])
            lat[i] = (time.perf_counter() - t0) * 1e3

    ts = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return lat, got


def sp_p100_serve(rank, world) -> dict:
    """[sp p100 serve]: a ``Predictor`` at P100 (T=4000, B=2) on a model
    axis of every card with the ring (fp32), rank 0 serving 16 requests
    from 4 clients (one pass discarded, one timed) and the others
    following; rank 0 then serves them through the single-card graphed
    predictor in the same call, and the ring's scores must be its within
    SP_SERVE_TOL x max|score|."""
    import numpy as np
    import torch

    from vog_tpu_torch.config import apply_matmul_precision
    from vog_tpu_torch.data.device_store import DeviceFeatureTables
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.serving import ServingLoop
    from vog_tpu_torch.train.dist import make_mesh

    dev = torch.device("cuda", rank)
    cfg = ma_cfg(serve_cfg("p100"), world, sp=True)
    apply_matmul_precision(cfg)
    tables = DeviceFeatureTables.random(cfg, SP_P100_ROWS, seed=0, int8=True, device=dev, chunk_rows=16).tables
    mesh = make_mesh(cfg)
    sd = get_model(ma_cfg(cfg, 1, sp=False), 5000, device=dev, seed=3).state_dict()
    pred = Predictor(cfg, sd, 5000, tables=tables, device=dev, cuda_graphs=False, mesh=mesh)
    if mesh.model_index != 0:
        return {"followed": pred.follow()}
    reqs = make_requests(cfg, SP_P100_REQUESTS, SP_P100_ROWS, 5000, seed=41)
    out = {}
    for name, p in (("ring", pred), ("single", None)):
        if p is None:
            p = Predictor(ma_cfg(cfg, 1, sp=False), sd, 5000, tables=tables, device=dev)
        loop = ServingLoop(p, max_batch=2, bucket_sizes=[1, 2])
        try:
            loop.prewarm(reqs[0])
            _serve_pass(loop, reqs, 4)  # discarded
            lat, got = _serve_pass(loop, reqs, 4)
        finally:
            loop.close()
            if name == "ring":
                pred.close()
        out[name] = {"p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                     "scores": [g["scores"] for g in got]}
    ring, single = out["ring"].pop("scores"), out["single"].pop("scores")
    valid = np.concatenate([s[s > -1e29] for s in single])
    scale = float(np.abs(valid).max())
    err = max(float(np.abs(a - b).max()) for a, b in zip(ring, single))
    if not err <= SP_SERVE_TOL * scale:
        raise RuntimeError(f"[sp p100 serve]: the ring's scores differ from the single card's by {err:.3e} "
                           f"(limit {SP_SERVE_TOL * scale:.3e})")
    out["max_abs_err"], out["limit"] = err, SP_SERVE_TOL * scale
    return out


def phase_model_axis(card: str) -> dict:
    """[model axis gt5 prod]: (a) with more than one card, an NCCL world of
    every card (``model_axis_nccl_rank``) on meshes (1, n), (n/2, 2) and
    (1, n) with the ring, then [sp p100 serve]; (b) a gloo world of 2 ranks
    on card 0, mesh (1, 2) (``model_axis_gloo_rank``).  Every rank's
    failure fails the run; mesh, backend, step ms, samples/s and the ring's
    ms printed."""
    import torch

    from vog_tpu_torch.config import apply_matmul_precision

    release_card()
    n = torch.cuda.device_count()
    out = {}
    if n > 1:
        meshes = []
        for m, sp in ((n, False), (2, False), (n, True)):
            a32 = prod_cfg(dropout=0.0)
            a32.mdl.dtype, a32.misc.matmul_precision = "float32", "highest"
            meshes.append((ma_cfg(prod_cfg(), m, sp=sp), ma_cfg(a32, m, sp=sp)))
        t0 = time.perf_counter()
        try:
            ra = run_world(model_axis_nccl_rank, n, "nccl", meshes, MA_ROWS, MA_ANNS)
        except Exception as e:
            fail(f"model axis nccl world of {n}: {e}")
        ta = time.perf_counter() - t0
        for i, r0 in enumerate(ra[0]["meshes"]):
            mesh = f"({r0['mesh'][0]}, {r0['mesh'][1]}){' sp' if r0['sp'] else ''}"
            if len({r["meshes"][i]["gathered"] for r in ra}) != 1 or \
                    len({r["meshes"][i]["replicated"] for r in ra}) != 1:
                fail(f"model axis nccl {mesh}: the ranks' states differ after the dispatches")
            # every kernel of the path at H/m heads; with the ring, the object layer's flash is not on it
            want = path_names(meshes[i][0], [k for k in KERNEL_NAMES
                                             if not (r0["sp"] and k.startswith("flash_attention"))])
            if set(r0["counts"]) != want or min(r0["counts"].values()) <= 0:
                fail(f"model axis nccl {mesh}: launched {r0['counts']}, expected each of {sorted(want)}")
            f = r0["fp32_first_step"]
            print(f"[model axis gt5 prod] (a) mesh {mesh}, backend nccl: a graphed dispatch of "
                  f"K={len(r0['losses'])} bitwise its eager steps, the ranks' gathered and whole states equal; "
                  f"step ms eager {r0['eager_step_ms']:.2f}, graph {r0['graph_step_ms']:.2f} "
                  f"({r0['samples_per_s']:.1f} samples/s, global batch {16 * r0['mesh'][0]}), nccl kernels "
                  f"{r0['nccl_ms_total']:.3f} ms ({r0['nccl_ms']}); device busy {r0['busy_ms']} ms a step; peak "
                  f"memory of a captured step {r0['peak_captured_step_gb']:.3f} GB; launches {r0['counts']}; fp32 "
                  f"first step: loss {f['losses'][0]:.7f} vs one process {f['one_process_losses'][0]:.7f}, max "
                  f"|err| {f['max_abs_err']:.2e}, worst relative {f['worst_rel']:.2e}; the single card's dispatch "
                  f"in this call {r0['single_card_step_ms']:.2f} ms a step ({r0['single_card_samples_per_s']:.1f} "
                  f"samples/s) on {card}", flush=True)
        s = ra[0]["sp_p100_serve"]
        print(f"[sp p100 serve] {n} model ranks, the ring (fp32, eager, T=4000, B=2, 16 requests from 4 clients, "
              f"max_batch 2): p50 {s['ring']['p50_ms']:.2f} ms, p95 {s['ring']['p95_ms']:.2f} ms; the single "
              f"card's graphed predictor in this call: p50 {s['single']['p50_ms']:.2f} ms, p95 "
              f"{s['single']['p95_ms']:.2f} ms; scores max |err| {s['max_abs_err']:.3e} (limit "
              f"{s['limit']:.3e}); followers {[r['sp_p100_serve'].get('followed') for r in ra[1:]]} flushes; "
              f"world run {ta:.1f} s on {card}", flush=True)
        out["nccl"] = {"world": n, "meshes": [{k: v for k, v in r.items() if k not in ("gathered", "replicated")}
                                              for r in ra[0]["meshes"]], "sp_p100_serve": s, "seconds": ta}
    tp_c = ma_cfg(train_cfg(0.1), 2)
    tp_c.train.steps_per_dispatch = 1
    sp_cs = [ma_cfg(train_cfg(0.1), 2, sp=True, decomposed=dec) for dec in (True, False)]
    serve_c = ma_cfg(serve_cfg(), 2, sp=True)
    t0 = time.perf_counter()
    try:
        rb = run_world(model_axis_gloo_rank, 2, "gloo", tp_c, sp_cs, serve_c, MA_ROWS, MA_ANNS, MA_STEPS)
    except Exception as e:
        fail(f"model axis gloo world of 2: {e}")
    tb = time.perf_counter() - t0
    r0, r1 = rb
    want = set(KERNEL_NAMES)
    if set(r0["counts"]) != want or min(r0["counts"].values()) <= 0:
        fail(f"model axis gloo tp: launched {r0['counts']}, expected each of {sorted(want)}")
    for what in ("replicated", "gathered"):
        if r0[what] != r1[what]:
            fail(f"model axis gloo tp: the two ranks' {what} states differ after {MA_STEPS} steps")
    if r0["gathered"] != r0["rerun_gathered"] or r0["rerun_losses"] != r0["tp"]["losses"]:
        fail("model axis gloo tp: a rerun of the steps does not give bitwise the same gathered state")
    for key in r0["sp"]:
        if r0["sp"][key]["replicated"] != r1["sp"][key]["replicated"]:
            fail(f"model axis gloo sp ({key}): the two ranks' whole parameters differ")
    if r1.get("followed", 0) < 1:
        fail(f"model axis gloo serve: the follower followed {r1.get('followed')} flushes")
    tp, sp = r0["tp"], r0["sp"]
    print(f"[model axis gt5 prod] (b) mesh (1, 2), backend gloo on one card (fp32, dropout 0.1, eager, the "
          f"collectives and the ring's P2P staged through the host): TP {MA_STEPS} losses {tp['losses']} vs one "
          f"process {tp['one_process_losses']}, first-step gradient max |err| {tp['max_abs_err']:.2e}, worst "
          f"relative {tp['worst_rel']:.2e}; the ranks' whole and gathered states bitwise equal, and a rerun's; "
          f"step ms {r0['step_ms']:.2f} ({r0['samples_per_s']:.1f} samples/s; one process "
          f"{r0['one_process_step_ms']:.2f} ms); launches at 2 heads {r0['counts']}; sp: "
          + "; ".join(f"{k} loss {v['losses'][0]:.7f} vs {v['one_process_losses'][0]:.7f}, max |err| "
                      f"{v['max_abs_err']:.2e}, step ms {v['step_ms']:.2f}, launches {v['counts']}"
                      for k, v in sp.items())
          + f"; the ring at one object-layer's shapes (16, 4, 100 of 200, 128): fwd {r0['ring']['fwd_ms']:.2f} ms, "
          f"fwd+bwd {r0['ring']['fwd_bwd_ms']:.2f} ms; one serve flush of {r0['serve']['requests']} requests "
          f"through the follower: scores max |err| {r0['serve']['max_abs_err']:.3e} (limit "
          f"{r0['serve']['limit']:.3e}); world run {tb:.1f} s on {card}", flush=True)
    out["gloo"] = {k: v for k, v in r0.items() if k not in ("gathered", "replicated", "rerun_gathered")}
    out["gloo"]["seconds"] = tb
    apply_matmul_precision(serve_cfg())
    return out


# -- offline dataset construction (dcode) -------------------------------------
DCODE_CAPTIONS = 4096  # synthetic captions of 10-30 words tagged by [dcode srl bert-base]
DCODE_CHECK_FRAMES = 256  # frames of (a)'s kernel-against-plain check
DCODE_STEP_FRAMES = 16  # golden frames of (b)'s fine-tune step
DCODE_VIDEOS = (40, 12, 12)  # [dcode pipeline]'s P100 fixture: train / valid / test videos
DCODE_NOUNS = ("man", "woman", "dog", "horse", "ball", "car", "bike", "boat", "guitar", "table", "chair", "cup",
               "girl", "boy", "rope", "board", "water", "field", "crowd", "camera")
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512)  # structured-prediction-srl-bert's encoder


def synthetic_vocab(n: int = 30522, seed: int = 0) -> list:
    """A WordPiece vocab of ``n`` entries in BERT-base uncased's layout
    ([PAD], [unused*], [UNK], [CLS], [SEP], [MASK], characters, words,
    ``##`` pieces): the verb lexicon, the golden set's words and the
    captions' nouns, then random letter words and pieces from ``seed``."""
    import string

    import numpy as np

    from vog_tpu_torch.dcode.golden_srl import golden_vocab
    from vog_tpu_torch.dcode.srl_tagger import LOC_PREPS, STOP, VERB_LEXICON

    chars = list(string.ascii_lowercase + string.digits + string.punctuation)
    words = sorted(set(golden_vocab()[5:]) | set(VERB_LEXICON) | STOP | LOC_PREPS | set(DCODE_NOUNS))
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars
             + words + ["##" + c for c in chars] + ["##s", "##es", "##ing", "##ed", "##er", "##ly"])
    seen = set(vocab)
    rng = np.random.default_rng(seed)
    letters = np.array(list(string.ascii_lowercase))
    while len(vocab) < n:
        w = "".join(rng.choice(letters, size=int(rng.integers(2, 10))))
        if rng.uniform() < 0.3:
            w = "##" + w[:4]
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    return vocab


def synthetic_captions(vocab: list, n: int, seed: int = 0) -> list:
    """``n`` captions of 10-30 words: subject, a lexicon verb, object and
    place phrases, filler from the vocab, a second verb in some, and words
    out of the vocab (random letters, split into pieces; accented and
    symbol words, some of them [UNK])."""
    import numpy as np

    from vog_tpu_torch.dcode.srl_tagger import VERB_LEXICON

    rng = np.random.default_rng(seed)
    verbs = np.array(sorted(VERB_LEXICON))
    fill = np.array([w for w in vocab[1000:] if not w.startswith("##")])
    nouns = np.array(DCODE_NOUNS)
    odd = np.array(["café", "naïve", "señor", "über", "ø", "→", "😀", "日本", "x-ray", "rock'n'roll"])
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out = []
    for _ in range(n):
        words = ["the", str(rng.choice(nouns)), str(rng.choice(verbs)), "the", str(rng.choice(nouns)),
                 "near", "the", str(rng.choice(nouns))]
        target = int(rng.integers(10, 31))
        while len(words) < target:
            r = rng.uniform()
            if r < 0.55:
                words.append(str(rng.choice(fill)))
            elif r < 0.75:
                words.append("".join(rng.choice(letters, size=int(rng.integers(6, 15)))))
            elif r < 0.85:
                words.append(str(rng.choice(odd)))
            else:
                words += ["and", str(rng.choice(verbs))]
        out.append(" ".join(words[:target]))
    return out


def dcode_tagger(cfg_kw: dict, vocab: list, seed: int, dev: str):
    """A ``BertSrlTagger`` of random weights from ``seed`` (BERT's
    initialisation, the head PyTorch's), dropout 0."""
    import torch

    from vog_tpu_torch.dcode.bert import BertConfig, BertModel
    from vog_tpu_torch.dcode.srl_tagger import BertSrlTagger
    from vog_tpu_torch.dcode.wordpiece import WordPieceTokenizer

    cfg = BertConfig(vocab_size=len(vocab), hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                     **{k: v for k, v in cfg_kw.items() if k != "vocab_size"})
    torch.manual_seed(seed)
    bert = BertModel(cfg).init_weights(torch.Generator().manual_seed(seed))
    return BertSrlTagger(bert, WordPieceTokenizer(vocab), device=dev)


def phase_dcode_srl(card: str, tmp: Path) -> dict:
    """[dcode srl bert-base]: the BERT-SRL tagger at BERT-base width
    (``BERT_BASE``; random weights from seed 0, dropout 0), a synthetic
    30,522-piece vocab and ``DCODE_CAPTIONS`` synthetic captions, fp32
    "highest".  (a) ``DCODE_CHECK_FRAMES`` frames through the flash kernel
    against the same tagger's plain path on the card (``plain_kernels``):
    the last hidden state within 1e-4 x max|h| on the real tokens, the
    tags equal; then every caption through ``tag_sentences`` (the launches
    counted from 0 just before it), sentences/s and frames/s; ``flash_fwd``
    at the run's median batch shape beside its plain version, SDPA and its
    bound; (b) one fine-tune step (``frame_loss``) of ``DCODE_STEP_FRAMES``
    golden frames at full width: every gradient against the plain path on
    the card (``grad_faults``; the key projections' biases, whose gradient
    is zero in exact arithmetic, by the absolute limit alone), the
    backward launched; (c) the golden harness at the tests' width
    (``finetune_srl``, 300 epochs at most) reaching exact 1.0, the flash
    kernels launched.  Saves (a)'s tagger to ``tmp / "srl_bert_base"``."""
    import torch

    from vog_tpu_torch.dcode import srl_finetune
    from vog_tpu_torch.dcode.golden_srl import golden_examples, golden_vocab
    from vog_tpu_torch.dcode.srl_tagger import BATCH_FRAMES, predicates_of
    from vog_tpu_torch.kernels import _build, attention

    tag = "[dcode srl bert-base]"
    out = {}
    t0 = time.perf_counter()
    vocab = synthetic_vocab()
    captions = synthetic_captions(vocab, DCODE_CAPTIONS)
    tagger = dcode_tagger(BERT_BASE, vocab, 0, "cuda")
    frames = [(c.split(), v) for c in captions for v in predicates_of(c.split())]
    n_unk = sum(tagger.tokenizer.word_pieces(w) == [tagger.tokenizer.unk_id] for c in captions for w in c.split())
    n_words = sum(len(c.split()) for c in captions)
    print(f"{tag} tagger built in {time.perf_counter() - t0:.1f} s: vocab {len(vocab)}, {len(captions)} captions, "
          f"{n_words} words ({n_unk} of them [UNK]), {len(frames)} candidate frames", flush=True)

    # (a) the kernel against the plain path on the card
    check = frames[:DCODE_CHECK_FRAMES]
    batch, _ = tagger.encode(check)
    with torch.no_grad():
        h = tagger.bert(**batch)
        tags = tagger.frame_tags(check)
        undo = plain_kernels(("flash",))
        try:
            h_plain = tagger.bert(**batch)
            tags_plain = tagger.frame_tags(check)
        finally:
            undo()
    real = batch["attention_mask"] > 0
    err = max_err(h[real], h_plain[real])
    scale = float(h_plain[real].abs().max())
    if not err <= TOL * scale:
        fail(f"{tag} last hidden state through the kernel differs from the plain path: {err:.3e} > {TOL} x {scale:.3f}")
    if tags != tags_plain:
        fail(f"{tag} tags through the kernel differ from the plain path on "
             f"{sum(a != b for a, b in zip(tags, tags_plain))} of {len(check)} frames")
    print(f"{tag} (a) {len(check)} frames (T={batch['input_ids'].shape[1]}): last hidden state max |err| {err:.3e} "
          f"(limit {TOL} x {scale:.3f}), tags equal", flush=True)
    tagger.tag_sentences(captions[:256])  # warm-up
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    tagged = tagger.tag_sentences(captions)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_build.launches)
    if not counts.get("flash_attention"):
        fail(f"{tag} tagging launched no flash kernel: {counts}")
    t0 = time.perf_counter()
    tagger._encodings(frames)  # the host's WordPiece part of the run, alone
    tok_s = time.perf_counter() - t0
    out["tagging"] = dict(seconds=dt, tokenize_s=tok_s, sentences_per_s=len(captions) / dt, frames_per_s=len(frames) / dt,
                          frames=len(frames), sentences=len(captions), tagged=sum(t is not None for t in tagged),
                          launches=counts, launches_per_1000_sentences=1000 * counts["flash_attention"] / len(captions))
    print(f"{tag} (a) tag_sentences: {len(captions)} sentences, {len(frames)} frames in {dt:.3f} s: "
          f"{len(captions) / dt:.1f} sentences/s, {len(frames) / dt:.1f} frames/s, "
          f"{out['tagging']['tagged']} with a frame (WordPiece alone {tok_s:.3f} s); launches {counts} "
          f"({out['tagging']['launches_per_1000_sentences']:.1f} flash a 1,000 sentences) on {card}", flush=True)

    # flash_fwd at the run's median batch (frame_tags sorts the frames by length, longest first)
    encodings = tagger._encodings(frames)
    lengths = sorted((len(encodings[tuple(w)].input_ids) for w, _ in frames), reverse=True)
    chunks = [lengths[i:i + BATCH_FRAMES] for i in range(0, len(lengths), BATCH_FRAMES)]
    mid = chunks[len(chunks) // 2]
    B, T, H, dh = len(mid), max(mid), BERT_BASE["num_attention_heads"], 64
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((B, H, T, dh), generator=g, device="cuda") for _ in range(3))
    lens = torch.tensor(mid, device="cuda")
    mask = (torch.arange(T, device="cuda")[None] < lens[:, None]).float()
    o = attention.flash_attention_fwd(q, k, v, mask)[0]
    ref = attention.flash_attention_plain(q, k, v, mask)[0]
    ferr = check_close("flash_attention dcode", o, ref)
    bmask = (mask > 0)[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bmask)  # noqa: E731
    lib_rel = check_yardstick("flash_attention dcode sdpa", sdpa(), o)
    t = timings(lambda: attention.flash_attention_fwd(q, k, v, mask),
                lambda: attention.flash_attention_plain(q, k, v, mask), sdpa)
    # the work this batch needs: every real query against every real key
    fl = 4.0 * H * dh * float((lens.double() ** 2).sum())
    bms, by = bound_ms(nbytes(q, k, v, mask) + nbytes(q) + B * H * T * 4, fl)
    out["flash"] = dict(shape=f"q,k,v ({B}, {H}, {T}, {dh}) f32, {int(lens.sum())} real tokens", max_abs_err=ferr,
                        sdpa_rel_err=lib_rel, bound_ms=bms, bound_by=by, **t)
    print(f"{tag} flash_attention at the median batch ({B}, {H}, {T}, {dh}): max_err={ferr:.3e} "
          f"{fmt_times(t, 'sdpa')} bound={bms:.4f} ({by})", flush=True)
    del q, k, v, o, ref, h, h_plain

    # (b) one fine-tune step of golden frames at full width, against the plain path
    step_tagger = dcode_tagger(BERT_BASE, vocab, 1, "cuda")
    ex = golden_examples()[:DCODE_STEP_FRAMES]
    sbatch, labels = srl_finetune.encode_examples(step_tagger, ex)

    def step(plain: bool):
        undo = plain_kernels(("flash",)) if plain else (lambda: None)
        step_tagger.model.train()
        step_tagger.model.zero_grad(set_to_none=True)
        try:
            loss = srl_finetune.frame_loss(step_tagger, sbatch, labels)
            loss.backward()
        finally:
            undo()
            step_tagger.model.eval()
        return float(loss.detach()), {n: p.grad.detach().cpu().clone() for n, p in step_tagger.model.named_parameters()
                             if p.grad is not None}

    lp, gp = step(True)
    _build.reset_counts()
    lc, gc_ = step(False)
    torch.cuda.synchronize()
    step_counts = dict(_build.launches)
    if not (step_counts.get("flash_attention") and step_counts.get("flash_attention_bwd")):
        fail(f"{tag} (b) the fine-tune step launched no flash kernel forward and backward: {step_counts}")
    if not abs(lc - lp) <= 1e-4 * abs(lp):
        fail(f"{tag} (b) fine-tune loss {lc:.7f} != plain {lp:.7f}")
    zero_exact = [n for n in gp if n.endswith("attention.self.key.bias")]
    bad = grad_faults({n: gc_[n] for n in gp if n not in zero_exact}, {n: gp[n] for n in gp if n not in zero_exact})
    bad += [(n, max_err(gc_[n], gp[n]), None) for n in zero_exact
            if not max_err(gc_[n], gp[n]) <= TOL * max(1.0, float(gp[n].abs().max()))]
    if bad:
        fail(f"{tag} (b) fine-tune gradients differ from the plain path (leaf, max |err|, rel): {bad}")
    rels = {n: rel_err(gc_[n], gp[n]) for n in gp if n not in zero_exact}
    worst = max(rels, key=rels.get)
    out["finetune_step"] = dict(frames=len(ex), shape=tuple(sbatch["input_ids"].shape), loss=lc, loss_plain=lp,
                                leaves=len(gp), worst_rel=(worst, rels[worst]),
                                key_bias_max_abs=max(float(gp[n].abs().max()) for n in zero_exact),
                                launches=step_counts)
    print(f"{tag} (b) fine-tune step, {len(ex)} golden frames {tuple(sbatch['input_ids'].shape)}: loss {lc:.6f} "
          f"(plain {lp:.6f}), {len(gp)} gradients within compare_step's limits, worst relative {rels[worst]:.2e} "
          f"({worst}); the key biases' (zero in exact arithmetic) max |g| "
          f"{out['finetune_step']['key_bias_max_abs']:.2e}; launches {step_counts}", flush=True)
    del step_tagger, gp, gc_
    # flash_bwd (recompute, the default) at (b)'s shape, from random q, k, v, do and (b)'s padding
    m = sbatch["attention_mask"].float()
    Bb, Tb = m.shape
    q, k, v, do = (torch.randn((Bb, H, Tb, dh), generator=g, device="cuda") for _ in range(4))
    o, lse = attention.flash_attention_fwd(q, k, v, m)
    got = attention.flash_attention_bwd(q, k, v, m, None, None, o, lse, do)[:3]
    ref = attention.flash_attention_bwd_plain(q, k, v, m, None, None, o, lse, do)[:3]
    berr = max(check_close("flash_attention_bwd dcode", x, y) for x, y in zip(got, ref))
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    sd = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=(m > 0)[:, None, None, :])
    sdpa_bwd = lambda: torch.autograd.grad(sd, (qs, ks, vs), do, retain_graph=True)  # noqa: E731
    lib_rel = check_yardstick("flash_attention_bwd dcode sdpa", torch.cat([x.flatten() for x in sdpa_bwd()]),
                              torch.cat([x.flatten() for x in got]))
    t = timings(lambda: attention.flash_attention_bwd(q, k, v, m, None, None, o, lse, do),
                lambda: attention.flash_attention_bwd_plain(q, k, v, m, None, None, o, lse, do), sdpa_bwd)
    # S, dP, dV, dK, dQ over the real query and key pairs, from the saved o and lse
    fl = 10.0 * H * dh * float((m.sum(1).double() ** 2).sum())
    bms, by = bound_ms(nbytes(q, k, v, o, do, lse, m) + 3 * nbytes(q), fl)
    out["finetune_step"]["flash_bwd"] = dict(shape=f"q,k,v ({Bb}, {H}, {Tb}, {dh}) f32, {int(m.sum())} real tokens",
                                             max_abs_err=berr, sdpa_rel_err=lib_rel, bound_ms=bms, bound_by=by, **t)
    print(f"{tag} flash_attention_bwd (recompute) at (b)'s shape ({Bb}, {H}, {Tb}, {dh}): max_err={berr:.3e} "
          f"{fmt_times(t, 'sdpa-bwd')} bound={bms:.4f} ({by})", flush=True)
    del q, k, v, do, o, lse, qs, ks, vs, sd
    release_card()

    # (c) the golden harness at the tests' width, on the card
    small = dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=2, intermediate_size=96,
                 max_position_embeddings=64)
    golden = dcode_tagger(small, golden_vocab(), 0, "cuda")
    _build.reset_counts()
    t0 = time.perf_counter()
    hist = srl_finetune.finetune_srl(golden, golden_examples(), lr=5e-4, max_epochs=300, seed=0)
    torch.cuda.synchronize()
    gdt = time.perf_counter() - t0
    gcounts = dict(_build.launches)
    if hist[-1] != 1.0:
        fail(f"{tag} (c) the golden harness ended at exact {hist[-1]:.3f} after {len(hist)} epochs")
    if not (gcounts.get("flash_attention") and gcounts.get("flash_attention_bwd")):
        fail(f"{tag} (c) the golden fine-tune launched no flash kernel forward and backward: {gcounts}")
    out["golden"] = dict(epochs=len(hist), seconds=gdt, launches=gcounts)
    print(f"{tag} (c) golden harness: exact 1.0 after {len(hist)} epochs ({len(golden_examples())} frames), "
          f"{gdt:.1f} s; launches {gcounts}", flush=True)
    srl_finetune.save_tagger(tagger, str(tmp / "srl_bert_base"))
    del tagger, golden
    release_card()
    return out


def dcode_raw(src: Path, out: Path) -> Path:
    """The pipeline's raw inputs made from a fixture's annotations: one
    caption a query (its verb inflected), the AE phrase boxes of its
    arguments, and one caption with no verb."""
    out.mkdir(parents=True)
    caps, ae = [], {}
    suffix = {0: "", 1: "s", 2: "ing"}
    for split in ("train", "valid", "test"):
        with open(src / f"anns_{split}.jsonl") as f:
            anns = [json.loads(ln) for ln in f if ln.strip()]
        for ann in anns:
            toks = list(ann["tokens"])
            toks[ann["verb_idx"]] += suffix[ann["ann_idx"] % 3]
            caps.append({"vid_seg": ann["vid_seg"], "sentence": " ".join(toks), "split": split})
            ae[ann["vid_seg"]] = [{"tokens": ["the", a["lemma"]], "frame": b["frame"], "box": b["box"]}
                                  for a in ann["args"] for b in a["boxes"]]
    caps.append({"vid_seg": caps[0]["vid_seg"], "sentence": "nothing to see here", "split": "train"})
    with open(out / "captions.jsonl", "w") as f:
        f.write("\n".join(json.dumps(c) for c in caps) + "\n")
    with open(out / "ae_annots.json", "w") as f:
        json.dump(ae, f)
    return out


def gt5_coverage(p100: Path, gt5: Path, k: int = 5) -> tuple:
    """Every GT box of the GT5 dataset's annotations, in a frame with at
    most ``k`` GT boxes, that has a P100 proposal at IoU >= 0.5 keeps one
    in the GT5 pack -> (GT boxes checked, those in frames of more than k,
    failures)."""
    import numpy as np

    from vog_tpu_torch.data.boxes import iou_matrix
    from vog_tpu_torch.data.featpack import PackedFeatureStore

    src, dst = PackedFeatureStore(p100), PackedFeatureStore(gt5)
    gts = {}
    for split in ("train", "valid", "test"):
        with open(gt5 / f"anns_{split}.jsonl") as f:
            for ann in (json.loads(ln) for ln in f if ln.strip()):
                for a in ann["args"]:
                    for b in a["boxes"]:
                        gts.setdefault((ann["vid_seg"], int(b["frame"])), []).append(np.asarray(b["box"], np.float32))
    checked = crowded = 0
    bad = []
    for (vid, fr), boxes in sorted(gts.items()):
        if len(boxes) > k:
            crowded += len(boxes)
            continue
        before, after = src.get_meta(vid)[0][fr], dst.get_meta(vid)[0][fr]
        for gt in boxes:
            if iou_matrix(before, gt[None]).max() >= 0.5:
                checked += 1
                if not iou_matrix(after, gt[None]).max() >= 0.5:
                    bad.append((vid, fr))
    return checked, crowded, bad


def phase_dcode_pipeline(card: str, tmp: Path) -> dict:
    """[dcode pipeline]: ``run_pipeline`` on this machine as installed
    (no transformers, tokenizers, safetensors or h5py in the process),
    over a P100 fixture of ``DCODE_VIDEOS`` videos at full feature widths
    written by the port's writer (100 proposals a frame) and captions made
    from its annotations (``dcode_raw``), with ``--tagger=rule`` and with
    ``--tagger=bert:<[dcode srl bert-base]'s saved tagger>`` on the card:
    first into a P100 dataset beside the fixture's store, then from it with
    ``--gt5-from`` into a GT5 one.  Checks: every GT box with a P100
    proposal at IoU >= 0.5 keeps one in the GT5 pack (``gt5_coverage``);
    the bert GT5 dataset opens with ``get_data``, one valid batch runs
    through a ``Predictor`` (finite outputs of the batch's shape) and one
    train batch through a train step (a finite loss).  The GT5 build's
    seconds, each pipeline's, the tagger's launches."""
    import numpy as np
    import torch

    from vog_tpu_torch.data.fixtures import generate_fixture
    from vog_tpu_torch.data.loader import get_data
    from vog_tpu_torch.dcode.gt5_builder import build_gt5
    from vog_tpu_torch.dcode.pipeline import run_pipeline
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.train import TrainState, make_train_step

    tag = "[dcode pipeline]"
    t0 = time.perf_counter()
    fx = tmp / "p100_fixture"
    n_tr, n_va, n_te = DCODE_VIDEOS
    generate_fixture(fx, n_train=n_tr, n_valid=n_va, n_test=n_te, num_props=100, seed=0)
    raw = dcode_raw(fx, tmp / "raw")
    print(f"{tag} P100 fixture of {sum(DCODE_VIDEOS)} videos (100 proposals a frame, feats 2048, seg 3072) "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    out = {}
    for name, spec in (("rule", "rule"), ("bert", f"bert:{tmp / 'srl_bert_base'}")):
        p100, gt5 = tmp / f"p100_{name}", tmp / f"gt5_{name}"
        p100.mkdir()
        for f in ("featpack.bin", "featpack.json", "vid_dims.json", "glove.txt"):
            os.symlink(fx / f, p100 / f)
        _build.reset_counts()
        t0 = time.perf_counter()
        counts = run_pipeline(raw, p100, tagger=spec, device="cuda")
        t1 = time.perf_counter()
        run_pipeline(raw, gt5, tagger=spec, gt5_from=str(p100), device="cuda")
        t2 = time.perf_counter()
        launches = dict(_build.launches)
        if name == "bert" and not launches.get("flash_attention"):
            fail(f"{tag} the bert: tagger launched no flash kernel: {launches}")
        t3 = time.perf_counter()
        build_gt5(p100, tmp / f"gt5_only_{name}")
        gt5_s = time.perf_counter() - t3
        checked, crowded, bad = gt5_coverage(p100, gt5)
        if bad or not checked:
            fail(f"{tag} {name}: {len(bad)} GT boxes lost their IoU >= 0.5 proposal in the GT5 pack "
                 f"(of {checked} checked): {bad[:5]}")
        out[name] = dict(queries=counts, pipeline_s=t1 - t0, pipeline_gt5_s=t2 - t1, gt5_build_s=gt5_s,
                         gt_checked=checked, gt_in_crowded_frames=crowded, launches=launches)
        print(f"{tag} --tagger={name}: queries {counts}, the pipeline {t1 - t0:.2f} s, with --gt5-from "
              f"{t2 - t1:.2f} s (the GT5 build alone {gt5_s:.2f} s); {checked} GT boxes keep an IoU >= 0.5 "
              f"proposal ({crowded} in frames of more than 5 GT boxes not checked); launches {launches}", flush=True)
    present = [m for m in ("transformers", "tokenizers", "safetensors", "h5py") if m in sys.modules]
    if present:
        fail(f"{tag} the pipeline imported {present}")

    cfg = serve_cfg()
    cfg.ds.data_dir = str(tmp / "gt5_bert")
    cfg.misc.half_feats = False
    data = get_data(cfg)
    batch = stack_requests(valid_requests(data, 4))
    pred = Predictor(cfg, None, len(data.vocab), device="cuda", cuda_graphs=False, glove=data.vocab.vectors)
    res = pred(batch)
    bad = [k for k, v in res.items() if not np.isfinite(np.asarray(v, np.float64)).all()]
    if bad or res["pred_vid"].shape[0] != 4:
        fail(f"{tag} Predictor on the built dataset: non-finite {bad} or shapes "
             f"{ {k: np.shape(v) for k, v in res.items()} }")
    del pred
    model = get_model(cfg, len(data.vocab), device="cuda", glove=data.vocab.vectors, train=True)
    tb = next(iter(data.train_dl))
    tb = {k: torch.as_tensor(np.asarray(v)).cuda() for k, v in tb.items()}
    _, aux = make_train_step(cfg)(TrainState.create(cfg, model), tb, seed=0, tables=None)
    loss = float(aux["loss"])
    if not math.isfinite(loss):
        fail(f"{tag} a train step on the built dataset gave loss {loss}")
    out["dataset"] = dict(train=len(data.train_dl.ds), valid=len(data.valid_dl.ds), test=len(data.test_dl.ds),
                          loss=loss)
    print(f"{tag} the bert: GT5 dataset opens with get_data ({out['dataset']['train']} / {out['dataset']['valid']} / "
          f"{out['dataset']['test']} queries); 4 valid requests through a Predictor, finite; one train step, "
          f"loss {loss:.5f} on {card}", flush=True)
    del model
    release_card()
    return out


def phase_dcode(card: str) -> dict:
    """[dcode srl bert-base] then [dcode pipeline], in one temp dir, fp32
    "highest"."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="vog_dcode_") as tmp:
        srl = phase_dcode_srl(card, Path(tmp))
        return {"srl": srl, "pipeline": phase_dcode_pipeline(card, Path(tmp))}


CONTEXT_WARNINGS: list = []


WIDE_ROWS = 2000  # feature-table rows of [wide shapes] (20 frames a row: 0.8 GB in bf16)
WIDE_STEPS = 5  # production-recipe steps of its train phase (b)
WIDE_SWAPPED_STEPS = 2  # steps in the other backward-mode pair (flash emit, mm recompute)
WIDE_REQUESTS = 32
TAGGER_ATTN = (256, 12, 35, 64)  # the BERT-SRL tagger's flash call at BERT-base width (dcode/bert.py)
WIDE_TIMING = (7, 3)  # time_ms's (reps, inner): each call takes milliseconds, the plain versions more


def wide_kernel_rows(cfg) -> tuple:
    """[wide shapes] kernels: the flash kernels at the second mm layer's
    shape (B x A sequences, head dim 256, the 80-frame bias) and the mm
    kernels at the first's (A = 10: two launches of 5 args), forward and
    both backward modes, each against its plain version on the card
    (phase 3's limits), then timed beside it, the one library call that
    computes the same function (SDPA with the bias as a float mask; its
    backward with the mask's gradient) and the bound; each recompute
    backward split by kernel beside the DK 128 instance on the first 128
    columns (``bwd_by_kernel``); and the flash forward at the BERT-SRL
    tagger's shape (head dim 64: the instance without padded k-steps)
    beside SDPA.  -> (the kernel table rows, without launches; the
    tagger's timings and the splits)."""
    import torch

    from vog_tpu_torch.kernels import attention, mm_attention
    from vog_tpu_torch.kernels.attention import NEG

    tag = "[wide shapes]"
    reps, inner = WIDE_TIMING
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    V, F, P, A = cfg.ds.num_cmp, cfg.ds.num_frms, cfg.ds.num_prop_per_frm, cfg.ds.max_srl_args
    H, dh, B = cfg.mdl.n_heads, cfg.mdl.vis_dim // cfg.mdl.n_heads, cfg.train.bs
    frames, T = V * F, V * F * P  # temp: the videos' frames in turn
    fid = (torch.arange(T, device=dev) // P).to(torch.int32)
    fb = torch.randn((H, frames, frames), generator=g, device=dev) * 0.5
    inst = f"dh{dh},F{frames}"
    rows = []

    def add(name, source, replaces, err, t, bound, shape, lib_note, cl=None):
        rows.append(dict(name=f"{name}[{inst}]", kernel=name, route="cuda", source=source, replaces=replaces,
                         max_abs_err=err, **t, bound_ms=bound[0], bound_by=bound[1], shape=shape,
                         library=lib_note, **({} if cl is None else {"cluster": cl})))
        print(f"{tag} {name}[{inst}] max_err={err:.3e} {fmt_times(t, 'sdpa')} bound={bound[0]:.4f} ({shape})"
              + ("" if cl is None else f"; {fmt_cluster(cl)}"), flush=True)

    # -- flash: the second mm layer's call (B*A sequences, the 80-frame bias)
    Bf = B * A
    q, k, v, do = (torch.randn((Bf, H, T, dh), generator=g, device=dev) for _ in range(4))
    mask = (torch.rand((Bf, T), generator=g, device=dev) > 0.2).float()
    mask[:, 0] = 1.0
    o, lse = attention.flash_attention_fwd(q, k, v, mask, fb, fid)
    ro, rl = attention.flash_attention_plain(q, k, v, mask, fb, fid)
    err = max(check_close("flash_attention", o, ro), check_close("flash_attention lse", lse, rl))
    fidl = fid.long()
    fmask = (fb[:, fidl][:, :, fidl][None]
             + torch.where(mask > 0, 0.0, NEG)[:, None, None, :]).contiguous()  # (Bf, H, T, T)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=fmask)  # noqa: E731
    lib_rel = check_yardstick("flash_attention sdpa", sdpa(), o)
    t = timings(lambda: attention.flash_attention_fwd(q, k, v, mask, fb, fid),
                lambda: attention.flash_attention_plain(q, k, v, mask, fb, fid), sdpa, reps, inner)
    t["host_ms"] = host_ms(lambda: attention.flash_attention_fwd(q, k, v, mask, fb, fid))
    shape = f"q,k,v {tuple(q.shape)} f32, ({frames}, {frames}) frame bias"
    add("flash_attention", "vog_tpu_torch/csrc/attention.cu", "vog_tpu/kernels/attention.py:286", err, t,
        bound_ms(nbytes(q, k, v, mask, fb, fid) + nbytes(q) + nbytes(lse), 4.0 * Bf * H * T * T * dh), shape,
        f"SDPA, the bias and key mask as a float mask (Bf,H,T,T); rel err vs kernel {lib_rel:.2e}",
        cluster_info("flash", dh, "highest", F=frames, part="fwd"))
    ref = attention.flash_attention_bwd_plain(q, k, v, mask, fb, fid, ro, rl, do)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, fmask)]
    sd = torch.nn.functional.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
    lib = lambda: torch.autograd.grad(sd, leaves, do, retain_graph=True)  # noqa: E731
    bound = bound_ms(nbytes(q, k, v, o, do, lse, mask, fb, fid) + 3 * nbytes(q) + nbytes(fb),
                     10.0 * Bf * H * T * T * dh)
    shared = timings(None, lambda: attention.flash_attention_bwd_plain(q, k, v, mask, fb, fid, ro, rl, do),
                     lib, reps, inner)
    for mode, name, replaces in BWD_MODES["flash_attention_bwd"]:
        got = attention.flash_attention_bwd(q, k, v, mask, fb, fid, ro, rl, do, bwd_mode=mode)
        err = max(check_close(f"{name} {n}", x, y) for n, x, y in zip(OUT_NAMES[name], got, ref))
        del got
        call = lambda: attention.flash_attention_bwd(q, k, v, mask, fb, fid, ro, rl, do, bwd_mode=mode)  # noqa: E731
        t = {**shared, **{key: x for key, x in timings(call, None, None, reps, inner).items()
                          if key in ("ms", "issue_ms")}, "host_ms": host_ms(call)}
        add(name, "vog_tpu_torch/csrc/attention.cu", replaces, err, t, bound, shape,
            "SDPA backward, grads of q, k, v and the float mask",
            cluster_info("flash", dh, "highest", F=frames, part="bwd"))
    dk256 = bwd_by_kernel(lambda: attention.flash_attention_bwd(q, k, v, mask, fb, fid, ro, rl, do), reps, inner)
    half = [x[..., :128].contiguous() for x in (q, k, v, do)]  # the same shape at half the work: DK 128, no cluster
    o_h, lse_h = attention.flash_attention_fwd(*half[:3], mask, fb, fid)
    dk128 = bwd_by_kernel(lambda: attention.flash_attention_bwd(*half[:3], mask, fb, fid, o_h, lse_h, half[3]),
                          reps, inner)
    probe = dict(shape=f"{tuple(q.shape)}, recompute, fp32", dk256=dk256, dk128_first_columns=dk128)
    print(f"{tag} flash_attention_bwd[{inst}] recompute by kernel: {fmt_by_kernel(dk256)}; the DK 128 instance "
          f"on its first 128 columns: {fmt_by_kernel(dk128)}; {dk256['ms'] / dk128['ms']:.3f}x", flush=True)
    del q, k, v, do, o, lse, ro, rl, fmask, leaves, sd, lib, ref, half, o_h, lse_h

    # -- mm: the first mm layer's call (A args in groups of at most 8) ----
    qm = torch.randn((B, H, T, dh), generator=g, device=dev) * dh ** -0.5
    km, vm = (torch.randn((B, H, T, dh), generator=g, device=dev) for _ in range(2))
    cn = -3.0 * torch.rand((B, H, A, T), generator=g, device=dev)
    mask = (torch.rand((B, T), generator=g, device=dev) > 0.2).float()
    mask[:, 0] = 1.0
    fwd = mm_attention.mm_attention_fwd(qm, km, vm, cn, mask, fb, fid)
    rf = mm_attention.mm_attention_plain(qm, km, vm, cn, mask, fb, fid)
    err = max(check_close("mm_shared_qk_attention", x, y) for x, y in zip(fwd, rf))
    q_rep, fm = mm_sdpa_inputs(qm, cn, mask, fb, fid)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q_rep, km, vm, attn_mask=fm, scale=1.0)
    lib_rel = check_yardstick("mm_shared_qk_attention sdpa", sdpa().reshape(fwd[0].shape), fwd[0])
    t = timings(lambda: mm_attention.mm_attention_fwd(qm, km, vm, cn, mask, fb, fid),
                lambda: mm_attention.mm_attention_plain(qm, km, vm, cn, mask, fb, fid), sdpa, reps, inner)
    t["host_ms"] = host_ms(lambda: mm_attention.mm_attention_fwd(qm, km, vm, cn, mask, fb, fid))
    groups = "+".join(str(a1 - a0) for a0, a1 in mm_attention.fwd_groups(A, dh, "highest"))
    shape = f"qm,km,vm {tuple(qm.shape)}, A={A} ({groups}) f32, ({frames}, {frames}) frame bias"
    add("mm_shared_qk_attention", "vog_tpu_torch/csrc/mm_attention.cu", "vog_tpu/kernels/mm_attention.py:315",
        err, t, bound_ms(nbytes(qm, km, vm, cn, mask, fb, fid) + B * H * A * T * (dh + 2) * 4,
                         2.0 * B * H * T * T * dh * (1 + A)), shape,
        f"SDPA, query repeated over A, float mask (B,H,A*T,T); rel err vs kernel {lib_rel:.2e}",
        cluster_info("mm", dh, "highest", A=A, part="fwd"))
    gm = torch.randn(fwd[0].shape, generator=g, device=dev)
    ref = mm_attention.mm_attention_bwd_plain(qm, km, vm, cn, mask, fb, fid, *rf, gm)
    leaves = [x.detach().clone().requires_grad_() for x in (q_rep, km, vm, fm)]
    del q_rep, fm
    sd = torch.nn.functional.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)
    gsd = gm.reshape(sd.shape)
    lib = lambda: torch.autograd.grad(sd, leaves, gsd, retain_graph=True)  # noqa: E731
    bound = bound_ms(nbytes(qm, km, vm, cn, mask, fb, gm, *fwd) + 3 * nbytes(qm) + nbytes(cn),
                     2.0 * B * H * T * T * dh * (3 + 2 * A))
    shared = timings(None, lambda: mm_attention.mm_attention_bwd_plain(qm, km, vm, cn, mask, fb, fid, *rf, gm),
                     lib, reps, inner)
    bgroups = "+".join(str(a1 - a0) for a0, a1 in mm_attention.bwd_groups(A, dh))
    bshape = shape.replace(f"({groups})", f"({bgroups})")
    for mode, name, replaces in BWD_MODES["mm_shared_qk_attention_bwd"]:
        got = mm_attention.mm_attention_bwd(qm, km, vm, cn, mask, fb, fid, *rf, gm, bwd_mode=mode)
        err = max(check_close(f"{name} {n}", x, y) for n, x, y in zip(OUT_NAMES[name], got, ref))
        del got
        call = lambda: mm_attention.mm_attention_bwd(qm, km, vm, cn, mask, fb, fid, *rf, gm, bwd_mode=mode)  # noqa: E731
        t = {**shared, **{key: x for key, x in timings(call, None, None, reps, inner).items()
                          if key in ("ms", "issue_ms")}, "host_ms": host_ms(call)}
        add(name, "vog_tpu_torch/csrc/mm_attention.cu", replaces, err, t, bound, bshape,
            "SDPA backward, grads of q (repeated), k, v and the float mask",
            cluster_info("mm", dh, "highest", A=A, part="bwd"))
    mm256 = bwd_by_kernel(lambda: mm_attention.mm_attention_bwd(qm, km, vm, cn, mask, fb, fid, *rf, gm,
                                                                bwd_mode="recompute"), reps, inner)
    half = [x[..., :128].contiguous() for x in (qm, km, vm)]  # the same shape at half the work: DK 128, no cluster
    rf_h = mm_attention.mm_attention_fwd(*half, cn, mask, fb, fid)
    g_h = gm[..., :128].contiguous()
    mm128 = bwd_by_kernel(lambda: mm_attention.mm_attention_bwd(*half, cn, mask, fb, fid, *rf_h, g_h,
                                                                bwd_mode="recompute"), reps, inner)
    mm_probe = dict(shape=f"{tuple(qm.shape)}, A={A}, recompute, fp32", dk256=mm256, dk128_first_columns=mm128)
    print(f"{tag} mm_shared_qk_attention_bwd_recompute[{inst}] by kernel: {fmt_by_kernel(mm256)}; the DK 128 "
          f"instance on its first 128 columns: {fmt_by_kernel(mm128)}; {mm256['ms'] / mm128['ms']:.3f}x", flush=True)
    del qm, km, vm, cn, fwd, rf, gm, ref, leaves, sd, gsd, lib, half, rf_h, g_h

    # -- the tagger's flash forward: head dim 64 -------------------------
    Bt, Ht, Tt, dt = TAGGER_ATTN
    q, k, v = (torch.randn((Bt, Ht, Tt, dt), generator=g, device=dev) for _ in range(3))
    mask = (torch.arange(Tt, device=dev)[None] < torch.randint(8, Tt + 1, (Bt, 1), generator=g,
                                                                device=dev)).float()  # padded sentences
    o, lse = attention.flash_attention_fwd(q, k, v, mask)
    ro, rl = attention.flash_attention_plain(q, k, v, mask)
    err = max(check_close("flash_attention", o, ro), check_close("flash_attention lse", lse, rl))
    bmask = (mask > 0)[:, None, None, :]
    t = timings(lambda: attention.flash_attention_fwd(q, k, v, mask),
                lambda: attention.flash_attention_plain(q, k, v, mask),
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bmask),
                *TIMING["gt5"])
    bms, by = bound_ms(nbytes(q, k, v, mask) + nbytes(q) + Bt * Ht * Tt * 4, 4.0 * Bt * Ht * Tt * Tt * dt)
    tagger = dict(shape=f"q,k,v {tuple(q.shape)} f32, no bias", max_abs_err=err, **t, bound_ms=bms, bound_by=by)
    print(f"{tag} flash_attention at the tagger's shape {TAGGER_ATTN} (dh 64 instance) max_err={err:.3e} "
          f"{fmt_times(t, 'sdpa')} bound={bms:.4f}", flush=True)
    return rows, dict(tagger_flash=tagger, flash_bwd_by_kernel=probe, mm_bwd_by_kernel=mm_probe)


def bwd_by_kernel(fn, reps: int, inner: int, issue: bool = False) -> dict:
    """A backward wrapper's device ms a call (``time_ms``) and its kernels'
    (``flash_bwd_delta``, ``flash_bwd_dkv``, ``flash_bwd_dq``, or the mm
    backward's ``mm_bwd_*``; the cluster instances under the same names,
    and the wrapper's other device ops)
    from a torch.profiler run of ``reps`` calls, taken again (up to three
    runs) while the trace holds no device time; ``by_kernel`` is empty
    when none held any.  Also ``other`` (the other device ops by name, ms
    a call), ``busy_ms`` (the union of the trace's device intervals a
    call: kernels on two streams at once count once) and, with ``issue``,
    ``issue_ms`` (``time_ms`` with the host's issue)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ms = time_ms(fn, reps, inner)
    by_symbol, other, busy = {}, {}, None
    for _ in range(3):  # a profiler run can come back without device events (seen after earlier ones)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        _, other = device_time_by_kernel(prof, reps, by_symbol)
        if by_symbol:
            by_symbol["other ops"] = sum(other.values())  # the wrapper's padding, delta's reduction, ...
            busy = device_busy_ms(prof, reps, sum(by_symbol.values()))
            break
    out = dict(ms=ms, by_kernel=by_symbol, other={k[:60]: v for k, v in other.items()}, busy_ms=busy)
    if issue:
        out["issue_ms"] = time_ms(fn, reps, inner, queued=False)
    return out


def launch_ms(fn, symbols, reps: int, tries: int = 3) -> dict:
    """Device ms of one launch of each kernel whose name holds one of
    ``symbols``, from a torch.profiler run of ``reps`` calls of ``fn``: its
    device time over its own launch count, so a trace that lost some calls'
    events (a P100 backward's, after earlier profiles) still gives a
    launch's time.  A trace that holds none of some symbol's events (seen
    at P100 after earlier profiles) is taken again, up to ``tries`` runs;
    None for a symbol no run held."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    got = dict.fromkeys(symbols)
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for sym in [k for k, v in got.items() if v is None]:
            us, n = 0.0, 0
            for e in prof.key_averages():
                if sym in e.key and e.device_type == torch.autograd.DeviceType.CUDA:
                    us += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
                    n += e.count
            got[sym] = us / 1e3 / n if n else None
        if all(v is not None for v in got.values()):
            break
    return got


def head_inputs(B: int, A: int, T: int, D: int, Dh: int, seed: int = 4) -> tuple:
    """The head's nine operands and a cotangent on the card, made from
    ``seed`` as phase_kernels_default makes them (vis and arg past a ReLU,
    the stems from random projections)."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    vis = torch.relu(torch.randn((B, T, D), generator=g, device=dev))
    arg = torch.relu(torch.randn((B, A, D), generator=g, device=dev))
    wx = torch.randn((D, D), generator=g, device=dev) / D**0.5
    w1 = torch.randn((D, Dh), generator=g, device=dev) / D**0.5
    b1 = torch.randn((Dh,), generator=g, device=dev) * 0.1
    w2 = torch.randn((Dh,), generator=g, device=dev) / Dh**0.5
    b2 = torch.randn((1,), generator=g, device=dev)
    wv = vis @ (torch.randn((D, D), generator=g, device=dev) / D**0.5)
    wl = arg @ (torch.randn((D, D), generator=g, device=dev) / D**0.5)
    gh = torch.randn((B, A, T), generator=g, device=dev)
    return (vis, arg, wv, wl, wx, w1, b1, w2, b2), gh


def mm_inputs(B: int, H: int, T: int, dh: int, A: int, F: int, seed: int = 4) -> tuple:
    """The mm attention's operands (qm, k, v, cn, mask, fb, fid: the SPAT
    frame ids of ``F`` frames), its plain forward's outputs at "highest"
    and a cotangent (B, H, A, T, dh) on the card, made from ``seed``."""
    import torch

    from vog_tpu_torch.kernels import mm_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    qm = torch.randn((B, H, T, dh), generator=g, device=dev) * dh**-0.5
    k, v = (torch.randn((B, H, T, dh), generator=g, device=dev) for _ in range(2))
    mask = (torch.rand((B, T), generator=g, device=dev) > 0.2).float()
    mask[:, 0] = 1.0
    fid = (torch.arange(T, device=dev) // (T // F)).to(torch.int32)
    fb = torch.randn((H, F, F), generator=g, device=dev) * 0.5
    cn = -3.0 * torch.rand((B, H, A, T), generator=g, device=dev)
    gm = torch.randn((B, H, A, T, dh), generator=g, device=dev)
    with tf32(False):
        fwd = mm_attention.mm_attention_plain(qm, k, v, cn, mask, fb, fid)
    return (qm, k, v, cn, mask, fb, fid), fwd, gm


def phase_bwd_split(card: str) -> dict:
    """[bwd split]: the production recipe's two costliest kernels by the
    Learner's launches, at "default", split by kernel (``bwd_by_kernel``:
    device ms and with issue, each kernel's device ms from a torch.profiler
    run, the other device ops by name, the union of the device intervals)
    at GT5 (B=16) and P100 (B=2): the head backward (its row and weight
    kernels; with two streams the union is below their sum) and the mm
    backward in emit mode (mm_bwd_prep_wg, mm_bwd_dkv_wg, then the widening of
    comb and the two cuBLAS products, dq and dfb, among the other ops).
    -> {regime: {kernel: split}}."""
    import torch

    from vog_tpu_torch.kernels import grounding_head, mm_attention

    out = {}
    for tag, B in (("gt5", 16), ("p100", 2)):
        cfg = serve_cfg(tag)
        reps, inner = TIMING[tag]
        V, F, P, A = cfg.ds.num_cmp, cfg.ds.num_frms, cfg.ds.num_prop_per_frm, cfg.ds.max_srl_args
        D, H = cfg.mdl.vis_dim, cfg.mdl.n_heads
        T = F * V * P
        args, gh = head_inputs(B, A, T, D, D // 2)
        with tf32(True):
            head = bwd_by_kernel(lambda: grounding_head.grounding_head_bwd(*args, gh, precision="default"),
                                 reps, inner, issue=True)
        del args, gh
        ops, fwd, gm = mm_inputs(B, H, T, D // H, A, F)
        with tf32(True):
            mm = bwd_by_kernel(lambda: mm_attention.mm_attention_bwd(*ops, *fwd, gm, bwd_mode="emit",
                                                                     precision="default"), reps, inner, issue=True)
        del ops, fwd, gm
        torch.cuda.empty_cache()
        out[tag] = {"fused_grounding_head_bwd@default": head, "mm_shared_qk_attention_bwd@default": mm}
        for name, b in out[tag].items():
            top = sorted(b["other"].items(), key=lambda kv: -kv[1])[:6]
            busy = "not measured" if b["busy_ms"] is None else f"{b['busy_ms']:.4f}"
            print(f"[bwd split] {tag} B={B} {name}: device {fmt_by_kernel(b)}, w/ issue {b['issue_ms']:.4f} ms, "
                  f"busy (union) {busy} ms; other ops: " + "; ".join(f"{k} {v:.4f}" for k, v in top)
                  + f" ({card})", flush=True)
    return out


def fmt_by_kernel(b: dict) -> str:
    return f"{b['ms']:.4f} ms (" + ", ".join(f"{k} {v:.4f}" for k, v in b["by_kernel"].items()) + ")"


def phase_wide(card: str) -> tuple:
    """[wide shapes]: the production model at ``WIDE``'s shapes (head dim
    256, 80 frames, 10 args) on ``WIDE_ROWS`` random bf16 table rows:
    ``wide_kernel_rows``; then serving (``WIDE_REQUESTS`` requests from 4
    clients, max_batch 8, scores against the plain path on the card) and
    training (phase 7 at ``WIDE_STEPS`` steps: the first step and the
    trained state against the plain path on the card, with its control,
    and ``WIDE_SWAPPED_STEPS`` steps in the other backward-mode pair), each
    launching every kernel of its path: the mm attention's forward and
    backward twice a call (args 5 + 5).  -> (the kernel table rows with
    their launches on these paths, the phase's results)."""
    import numpy as np
    import torch

    from vog_tpu_torch.data.device_store import DeviceFeatureTables
    from vog_tpu_torch.kernels import _build, mm_attention
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_train_step

    tag = "[wide shapes]"
    t_phase = time.perf_counter()
    cfg = serve_cfg(wide=True)
    print(f"{tag} {WIDE}: head dim {cfg.mdl.vis_dim // cfg.mdl.n_heads}, "
          f"{cfg.ds.num_cmp * cfg.ds.num_frms} frames, T = "
          f"{cfg.ds.num_cmp * cfg.ds.num_frms * cfg.ds.num_prop_per_frm}, A = {cfg.ds.max_srl_args}", flush=True)
    rows, probes = wide_kernel_rows(train_cfg(0.1, wide=True))
    gc.collect()
    torch.cuda.empty_cache()
    tables = DeviceFeatureTables.random(cfg, WIDE_ROWS, seed=0, half=True, device="cuda")
    pred, _, serve_counts, serve = phase_serve(cfg, tables, card, n_requests=WIDE_REQUESTS, clients=4,
                                               max_batch=8, ref_on="plain", n_ref=4, label=" wide")
    del pred
    train_counts, train = phase_train(tables, card, "gt5", WIDE_STEPS, "plain", label=" wide", wide=True)
    groups = len(mm_attention.arg_groups(cfg.ds.max_srl_args))
    for name in ("mm_shared_qk_attention", "mm_shared_qk_attention_bwd"):
        if train_counts.get(name) != groups * WIDE_STEPS:
            fail(f"{tag} {name}: {train_counts.get(name)} launches in {WIDE_STEPS} steps, not {groups} a step")
    # the other backward-mode pair: the emit flash and recompute mm kernels on the train path
    swapped = train_cfg(0.1, wide=True)
    model = get_model(swapped, 5000, device="cuda", seed=5, train=True)
    state, step = TrainState.create(swapped, model), make_train_step(swapped)
    batches = make_train_batches(swapped, WIDE_SWAPPED_STEPS, swapped.train.bs, tables.n_rows, 5000, seed=12)
    with bwd_modes("emit", "recompute"):
        _build.reset_counts()
        for b in batches:
            state, aux = step(state, {k: torch.as_tensor(x).cuda() for k, x in b.items()}, seed=0,
                              tables=tables.tables)
            if not np.isfinite(float(aux["loss"])):
                fail(f"{tag} a non-finite loss in the emit / recompute pair")
        torch.cuda.synchronize()
        swapped_counts = dict(_build.launches)
    for name in ("flash_attention_bwd_emit", "mm_shared_qk_attention_bwd_recompute"):
        if swapped_counts.get(name, 0) <= 0:
            fail(f"{tag} {name} was not launched by the emit / recompute pair ({swapped_counts})")
    del state, model, step, tables
    gc.collect()
    torch.cuda.empty_cache()
    runs = (serve_counts, train_counts, swapped_counts)
    for r in rows:
        r["launches"] = sum(c.get(r["kernel"], 0) for c in runs)
        if r["launches"] <= 0:
            fail(f"{tag} {r['name']} was launched no time on the wide paths")
    secs = time.perf_counter() - t_phase
    print(f"{tag} launches: serve {serve_counts}; train {train_counts}; emit / recompute pair {swapped_counts}; "
          f"{secs:.1f} s on {card}", flush=True)
    return rows, dict(serve=serve, train=train, **probes, serve_launches=serve_counts,
                      train_launches=train_counts, swapped_launches=swapped_counts, seconds=secs)


# [wider shapes]: what the kernels take past the widths of their narrow
# paths.  (a) the kernels against their plain versions on the card, both
# precisions, forward and every gradient: the head at B = 2, A = 5, T = 200
# and each D of WIDER_HEAD_D (300: padded to 320; the rest past 512: its
# wide path), the flash and mm kernels at each head dim of WIDER_DH (their
# wide path; 2 heads, 1 at 1024) at GT5's T = 200 (10 frames) and at the
# wide T = 400 (80 frames), B = 2 (sized for the run's time); (b) the
# production model at ``WIDER``'s widths (D 1024, Dh 512, head dim 512,
# GT5 SPAT) served and trained on the card.
WIDER = {"mdl.vis_dim": 1024, "mdl.n_heads": 2}
WIDER_HEAD_D = (300, 1024, 2080, 4096)
WIDER_DH = (384, 512, 1024)
WIDER_ATTN = ((2, 200, 10), (2, 400, 80))  # (B, T, frames): GT5's SPAT, the wide temp
WIDER_TIMING = (3, 2)  # time_ms's (reps, inner): a row's few calls, the widest tens of milliseconds
WIDER_ROWS = 2000  # feature-table rows of (b) (GT5: 10 frames a row)
WIDER_REQUESTS = 32
WIDER_STEPS = 3  # fp32 "highest" steps of (b), the first against the plain path
WIDER_OTHER_STEPS = 2  # steps in each of the other runs of (b): the swapped modes, the production numerics
WIDER_FLIP_LIMIT = 1e-3  # of z0 or z1: a head backward's ReLU decisions off fp64's (a broken row pass: ~0.5)


def wider_kernel_rows() -> list:
    """[wider shapes] (a): each kernel of the wide paths against its plain
    version on the card, at "highest" within phase 3's limits
    (``check_close``) and at "default" within phase 9's
    (``check_default``); the head backward given its row pass's ReLU
    decisions (``head_bwd_given``, in fp64: no kink mask at any D), each
    row timed beside its plain version, the one library call that computes
    the same function (SDPA; for mm over the query repeated A times) and
    its bound.  -> the kernel table rows, without launches."""
    import torch

    from vog_tpu_torch.kernels import _cluster as cluster
    from vog_tpu_torch.kernels import attention, grounding_head, mm_attention
    from vog_tpu_torch.kernels.attention import NEG

    tag = "[wider shapes]"
    reps, inner = WIDER_TIMING
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    rows = []

    def run(prec, fn):  # the kernel's precision, and the TF32 switches its path runs with
        with tf32(prec == "default"):
            return fn()

    def check(prec, name, got, ref, fwd):
        """-> (max |err|, the row's relative err) within the precision's limits."""
        if prec == "highest":
            return check_close(name, got, ref), rel_err(got, ref)
        err, _, fro = check_default(name, got, ref, fwd)
        return err, fro

    def add(name, prec, inst, source, replaces, errs, t, fl, nb, shape, library, cl=None):
        peak = PEAK_FLOP_PER_S if prec == "highest" else TF32_FLOP_PER_S
        bms, by = bound_ms(nb, fl, peak)
        kernel = name if prec == "highest" else f"{name}@default"
        rows.append(dict(name=f"{kernel}[{inst}]", kernel=kernel, precision=prec, route="cuda",
                         source=f"vog_tpu_torch/csrc/{source}", replaces=replaces,
                         max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs), **t,
                         bound_ms=bms, bound_by=by, shape=shape, library=library,
                         **({} if cl is None else {"cluster": cl})))
        print(f"{tag} {kernel}[{inst}] max_err={rows[-1]['max_abs_err']:.3e} rel={rows[-1]['max_rel_err']:.3e} "
              f"{fmt_times(t, 'library')} bound={bms:.4f} ({shape})" + ("" if cl is None else f"; {fmt_cluster(cl)}"),
              flush=True)

    # -- the fused head at B = 2, A = 5, T = 200 --------------------------
    B, A, T = 2, 5, 200
    for D in WIDER_HEAD_D:
        Dh = D // 2
        vis = torch.relu(torch.randn((B, T, D), generator=g, device=dev))
        arg = torch.relu(torch.randn((B, A, D), generator=g, device=dev))
        wx = torch.randn((D, D), generator=g, device=dev) / D**0.5
        w1 = torch.randn((D, Dh), generator=g, device=dev) / D**0.5
        b1 = torch.randn((Dh,), generator=g, device=dev) * 0.1
        w2 = torch.randn((Dh,), generator=g, device=dev) / Dh**0.5
        b2 = torch.randn((1,), generator=g, device=dev)
        wv = vis @ (torch.randn((D, D), generator=g, device=dev) / D**0.5)
        wl = arg @ (torch.randn((D, D), generator=g, device=dev) / D**0.5)
        args = (vis, arg, wv, wl, wx, w1, b1, w2, b2)
        gh = torch.randn((B, A, T), generator=g, device=dev)
        inst = f"D{D}"
        shape = f"vis {tuple(vis.shape)}, A={A}, D {D}, Dh {Dh} f32" + (
            f" (padded to {-(-D // 32) * 32})" if D % 32 else "")
        for prec in ("highest", "default"):
            ref = run("highest", lambda: grounding_head.grounding_head_plain(*args))
            got = run(prec, lambda: grounding_head.grounding_head_fwd(*args, precision=prec))
            errs = [check(prec, f"fused_grounding_head {inst} {prec}", got, ref, True)]
            t = run(prec, lambda: timings(lambda: grounding_head.grounding_head_fwd(*args, precision=prec),
                                          lambda: grounding_head.grounding_head_plain(*args), None, reps, inner))
            add("fused_grounding_head", prec, inst, "grounding_head.cu", "vog_tpu/kernels/grounding_head.py:190",
                errs, t, 2.0 * B * A * T * (D * D + D * Dh + Dh), nbytes(*args) + B * A * T * 4, shape, None)
            scratch = {}
            got = run(prec, lambda: grounding_head.grounding_head_bwd(*args, gh, precision=prec, scratch=scratch))
            ref, flips = head_bwd_given(args, gh, scratch["h"], scratch["dz1"])
            del scratch
            if max(flips) > WIDER_FLIP_LIMIT:
                fail(f"fused_grounding_head_bwd {inst} {prec}: ReLU decisions off fp64's on {flips[0]:.2e} of z0, "
                     f"{flips[1]:.2e} of z1 (limit {WIDER_FLIP_LIMIT:.0e})")
            errs = [check(prec, f"fused_grounding_head_bwd {inst} {prec} {on}", x, y.float(), False)
                    for on, x, y in zip(OUT_NAMES["fused_grounding_head_bwd"], got, ref)]
            del got, ref
            t = run(prec, lambda: timings(lambda: grounding_head.grounding_head_bwd(*args, gh, precision=prec),
                                          lambda: grounding_head.grounding_head_bwd_plain(*args, gh), None,
                                          reps, inner))
            add("fused_grounding_head_bwd", prec, inst, "grounding_head.cu", "vog_tpu/kernels/grounding_head.py:218",
                errs, t, 6.0 * B * A * T * (D * D + D * Dh), 2 * nbytes(*args) + nbytes(gh),
                shape + f", all 9 grads, given the kernel's ReLU decisions (off fp64's on {flips[0]:.1e} of z0, "
                f"{flips[1]:.1e} of z1)", None)
        del args, vis, arg, wv, wl, wx, w1, gh

    # -- flash and mm attention past head dim 256 --------------------------
    for dh in WIDER_DH:
        H = 1 if dh >= 1024 else 2
        plan = cluster.cluster_plan(dh, A)
        path = f"the cluster instances, {plan.cluster} blocks a cluster, {plan.passes} pass(es)"
        for B, T, frames in WIDER_ATTN:
            inst = f"dh{dh},T{T},F{frames}"
            fid = (torch.arange(T, device=dev) // (T // frames)).to(torch.int32)
            fb = torch.randn((H, frames, frames), generator=g, device=dev) * 0.5
            mask = (torch.rand((B, T), generator=g, device=dev) > 0.2).float()
            mask[:, 0] = 1.0
            fidl = fid.long()
            keymask = torch.where(mask > 0, 0.0, NEG)[:, None, None, :]
            # flash: q, k, v (B, H, T, dh), the frame bias
            q, k, v, do = (torch.randn((B, H, T, dh), generator=g, device=dev) for _ in range(4))
            fmask = (fb[:, fidl][:, :, fidl][None] + keymask).contiguous()
            shape = f"q,k,v {tuple(q.shape)} f32, ({frames}, {frames}) frame bias; {path}"
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=fmask)  # noqa: E731
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, fmask)]
            sd = torch.nn.functional.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
            sdpa_bwd = lambda: torch.autograd.grad(sd, leaves, do, retain_graph=True)  # noqa: E731
            for prec in ("highest", "default"):
                ro, rl = run("highest", lambda: attention.flash_attention_plain(q, k, v, mask, fb, fid))
                o, lse = run(prec, lambda: attention.flash_attention_fwd(q, k, v, mask, fb, fid, precision=prec))
                errs = [check(prec, f"flash_attention {inst} {prec}", o, ro, True),
                        check(prec, f"flash_attention {inst} {prec} lse", lse, rl, True)]
                check_yardstick("flash_attention sdpa", run(prec, sdpa), ro)
                t = run(prec, lambda: timings(
                    lambda: attention.flash_attention_fwd(q, k, v, mask, fb, fid, precision=prec),
                    lambda: attention.flash_attention_plain(q, k, v, mask, fb, fid), sdpa, reps, inner))
                t["host_ms"] = run(prec, lambda: host_ms(
                    lambda: attention.flash_attention_fwd(q, k, v, mask, fb, fid, precision=prec)))
                add("flash_attention", prec, inst, "attention.cu", "vog_tpu/kernels/attention.py:286", errs, t,
                    4.0 * B * H * T * T * dh, nbytes(q, k, v, mask, fb, fid) + nbytes(q) + nbytes(lse), shape,
                    "SDPA, the bias and key mask as a float mask", cluster_info("flash", dh, prec, F=frames, part="fwd"))
                ref = run("highest", lambda: attention.flash_attention_bwd_plain(q, k, v, mask, fb, fid, ro, rl, do))
                shared = run(prec, lambda: timings(
                    None, lambda: attention.flash_attention_bwd_plain(q, k, v, mask, fb, fid, ro, rl, do),
                    sdpa_bwd, reps, inner))
                for mode, name, replaces in BWD_MODES["flash_attention_bwd"]:
                    got = run(prec, lambda: attention.flash_attention_bwd(q, k, v, mask, fb, fid, ro, rl, do,
                                                                          bwd_mode=mode, precision=prec))
                    errs = [check(prec, f"{name} {inst} {prec} {on}", x, y, False)
                            for on, x, y in zip(OUT_NAMES[name], got, ref)]
                    del got
                    call = lambda: attention.flash_attention_bwd(  # noqa: E731
                        q, k, v, mask, fb, fid, ro, rl, do, bwd_mode=mode, precision=prec)
                    t = {**shared, **{kk: vv for kk, vv in run(prec, lambda: timings(
                        call, None, None, reps, inner)).items() if kk in ("ms", "issue_ms")},
                        "host_ms": run(prec, lambda: host_ms(call))}
                    add(name, prec, inst, "attention.cu", replaces, errs, t, 10.0 * B * H * T * T * dh,
                        nbytes(q, k, v, ro, do, rl, mask, fb, fid) + 3 * nbytes(q) + nbytes(fb),
                        shape + f", {mode}", "SDPA backward, grads of q, k, v and the float mask",
                        cluster_info("flash", dh, prec, F=frames, part="bwd"))
                del ref
            del q, k, v, do, fmask, leaves, sd
            # mm: qm, km, vm (B, H, T, dh), A = 5 args, the frame bias
            qm = torch.randn((B, H, T, dh), generator=g, device=dev) * dh ** -0.5
            km, vm = (torch.randn((B, H, T, dh), generator=g, device=dev) for _ in range(2))
            cn = -3.0 * torch.rand((B, H, A, T), generator=g, device=dev)
            gm = torch.randn((B, H, A, T, dh), generator=g, device=dev)
            q_rep, fm = mm_sdpa_inputs(qm, cn, mask, fb, fid)
            groups = "+".join(str(a1 - a0) for a0, a1 in mm_attention.bwd_groups(A, dh))
            # past dh 128 either precision's groups
            fgroups = "+".join(str(a1 - a0) for a0, a1 in mm_attention.fwd_groups(A, dh, "highest"))
            shape = f"qm,km,vm {tuple(qm.shape)}, A={A} ({groups}) f32, ({frames}, {frames}) frame bias; {path}"
            fshape = f"qm,km,vm {tuple(qm.shape)}, A={A} ({fgroups}) f32, ({frames}, {frames}) frame bias; {path}"
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q_rep, km, vm, attn_mask=fm, scale=1.0)
            leaves = [x.detach().clone().requires_grad_() for x in (q_rep, km, vm, fm)]
            sd = torch.nn.functional.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)
            gsd = gm.reshape(sd.shape)
            sdpa_bwd = lambda: torch.autograd.grad(sd, leaves, gsd, retain_graph=True)  # noqa: E731
            for prec in ("highest", "default"):
                rf = run("highest", lambda: mm_attention.mm_attention_plain(qm, km, vm, cn, mask, fb, fid))
                got = run(prec, lambda: mm_attention.mm_attention_fwd(qm, km, vm, cn, mask, fb, fid, precision=prec))
                errs = [check(prec, f"mm_shared_qk_attention {inst} {prec} {on}", x, y, True)
                        for on, x, y in zip(("out", "max", "den"), got, rf)]
                check_yardstick("mm_shared_qk_attention sdpa", run(prec, sdpa).reshape(rf[0].shape), rf[0])
                del got
                t = run(prec, lambda: timings(
                    lambda: mm_attention.mm_attention_fwd(qm, km, vm, cn, mask, fb, fid, precision=prec),
                    lambda: mm_attention.mm_attention_plain(qm, km, vm, cn, mask, fb, fid), sdpa, reps, inner))
                t["host_ms"] = run(prec, lambda: host_ms(
                    lambda: mm_attention.mm_attention_fwd(qm, km, vm, cn, mask, fb, fid, precision=prec)))
                add("mm_shared_qk_attention", prec, inst, "mm_attention.cu", "vog_tpu/kernels/mm_attention.py:315",
                    errs, t, 2.0 * B * H * T * T * dh * (1 + A),
                    nbytes(qm, km, vm, cn, mask, fb, fid) + B * H * A * T * (dh + 2) * 4, fshape,
                    "SDPA, query repeated over A, float mask (B,H,A*T,T)", cluster_info("mm", dh, prec, A=A, part="fwd"))
                ref = run("highest", lambda: mm_attention.mm_attention_bwd_plain(qm, km, vm, cn, mask, fb, fid,
                                                                                 *rf, gm))
                shared = run(prec, lambda: timings(
                    None, lambda: mm_attention.mm_attention_bwd_plain(qm, km, vm, cn, mask, fb, fid, *rf, gm),
                    sdpa_bwd, reps, inner))
                for mode, name, replaces in BWD_MODES["mm_shared_qk_attention_bwd"]:
                    got = run(prec, lambda: mm_attention.mm_attention_bwd(qm, km, vm, cn, mask, fb, fid, *rf, gm,
                                                                          bwd_mode=mode, precision=prec))
                    errs = [check(prec, f"{name} {inst} {prec} {on}", x, y, False)
                            for on, x, y in zip(OUT_NAMES[name], got, ref)]
                    del got
                    call = lambda: mm_attention.mm_attention_bwd(  # noqa: E731
                        qm, km, vm, cn, mask, fb, fid, *rf, gm, bwd_mode=mode, precision=prec)
                    t = {**shared, **{kk: vv for kk, vv in run(prec, lambda: timings(
                        call, None, None, reps, inner)).items() if kk in ("ms", "issue_ms")},
                        "host_ms": run(prec, lambda: host_ms(call))}
                    add(name, prec, inst, "mm_attention.cu", replaces, errs, t, 2.0 * B * H * T * T * dh * (3 + 2 * A),
                        nbytes(qm, km, vm, cn, mask, fb, gm, *rf) + 3 * nbytes(qm) + nbytes(cn), shape + f", {mode}",
                        "SDPA backward, grads of q (repeated), k, v and the float mask",
                        cluster_info("mm", dh, prec, A=A, part="bwd"))
                del rf, ref
            del qm, km, vm, cn, gm, q_rep, fm, leaves, sd, gsd
    return rows


def phase_wider(card: str) -> tuple:
    """[wider shapes]: (a) ``wider_kernel_rows``; (b) the production model
    at ``WIDER``'s widths (D 1024, Dh 512, head dim 512) on ``WIDER_ROWS``
    random bf16 table rows: ``WIDER_REQUESTS`` requests served from 4
    clients (max_batch 8, scores against the plain path on the card),
    ``WIDER_STEPS`` fp32 "highest" train steps (phase 7: the first step and
    the trained state against the plain path on the card, with its
    control), then ``WIDER_OTHER_STEPS`` eager steps in the other
    backward-mode pair and in each pair at the production numerics (bf16,
    "default"), so that every row's kernel runs on the model's path.
    -> (the rows with their launches on (b), the part's results)."""
    import numpy as np
    import torch

    from vog_tpu_torch.data.device_store import DeviceFeatureTables
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_train_step

    tag = "[wider shapes]"
    t_part = time.perf_counter()
    rows = wider_kernel_rows()
    secs_a = time.perf_counter() - t_part
    gc.collect()
    torch.cuda.empty_cache()
    cfg = serve_cfg(wide=WIDER)
    print(f"{tag} (b) {WIDER}: D {cfg.mdl.vis_dim}, Dh {cfg.mdl.vis_dim // 2}, head dim "
          f"{cfg.mdl.vis_dim // cfg.mdl.n_heads}, T = {cfg.ds.num_cmp * cfg.ds.num_frms * cfg.ds.num_prop_per_frm}, "
          f"A = {cfg.ds.max_srl_args}", flush=True)
    tables = DeviceFeatureTables.random(cfg, WIDER_ROWS, seed=0, half=True, device="cuda")
    pred, _, serve_counts, serve = phase_serve(cfg, tables, card, n_requests=WIDER_REQUESTS, clients=4,
                                               max_batch=8, ref_on="plain", n_ref=4, label=" wider")
    del pred
    train_counts, train = phase_train(tables, card, "gt5", WIDER_STEPS, "plain", label=" wider", wide=WIDER)
    other_counts = {}
    for numerics in ("fp32", "prod"):
        for fm, mm in (("emit", "recompute"), ("recompute", "emit")) if numerics == "prod" else (("emit", "recompute"),):
            c = train_cfg(0.1, wide=WIDER)
            if numerics == "prod":
                c.mdl.dtype, c.misc.matmul_precision = "bfloat16", "default"
            model = get_model(c, 5000, device="cuda", seed=5, train=True)
            state, step = TrainState.create(c, model), make_train_step(c)
            batches = make_train_batches(c, WIDER_OTHER_STEPS, c.train.bs, tables.n_rows, 5000, seed=13)
            with bwd_modes(fm, mm):
                _build.reset_counts()
                for b in batches:
                    state, aux = step(state, {k: torch.as_tensor(x).cuda() for k, x in b.items()}, seed=0,
                                      tables=tables.tables)
                    if not np.isfinite(float(aux["loss"])):
                        fail(f"{tag} a non-finite loss in the {numerics} steps (flash {fm}, mm {mm})")
                torch.cuda.synchronize()
                other_counts[f"{numerics}: flash {fm}, mm {mm}"] = dict(_build.launches)
            del model, state, step
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # "highest" for what follows
    del tables
    gc.collect()
    torch.cuda.empty_cache()
    runs = (serve_counts, train_counts, *other_counts.values())
    for r in rows:
        r["launches"] = sum(c.get(r["kernel"], 0) for c in runs)
        if r["launches"] <= 0:
            fail(f"{tag} {r['name']} was launched no time on (b)'s paths")
    secs = time.perf_counter() - t_part
    print(f"{tag} launches: serve {serve_counts}; train {train_counts}; other steps {other_counts}; "
          f"(a) {secs_a:.1f} s, all {secs:.1f} s on {card}", flush=True)
    return rows, dict(serve=serve, train=train, serve_launches=serve_counts, train_launches=train_counts,
                      other_launches=other_counts, seconds_a=secs_a, seconds=secs)


def run_wide(card: str) -> tuple:
    """``phase_wide`` and then ``phase_wider``, with their own worst
    relative errors: each [wide shapes] row gets its kernel's
    (``max_rel_err``; a [wider shapes] row carries its own), and the other
    phases' are kept."""
    kept, kept_default = dict(WORST_REL), dict(WORST_DEFAULT)
    WORST_REL.clear()
    rows, wide = phase_wide(card)
    for r in rows:
        r["max_rel_err"] = WORST_REL.get(r["kernel"], 0.0)
    wider_rows, wide["wider"] = phase_wider(card)
    rows = rows + wider_rows
    WORST_REL.clear()
    WORST_REL.update(kept)
    WORST_DEFAULT.clear()
    WORST_DEFAULT.update(kept_default)
    return rows, wide


def watch_context_warnings() -> None:
    """Record every shown warning that a thread found no current CUDA
    context (autograd's worker thread before the device's context is bound
    there: ``vog_tpu_torch/device.py``); it is still shown."""
    import warnings

    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "no current CUDA context" in str(message):
            CONTEXT_WARNINGS.append(f"{filename}:{lineno}: {message}")
        shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show


def main() -> int:
    name, card = phase_card()
    watch_context_warnings()
    if not (ROOT / "vog_tpu_torch").is_dir():
        fail("vog_tpu_torch is not beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import torch

    from vog_tpu_torch.data.device_store import DeviceFeatureTables

    for k in ("VOG_FLASH_BWD", "VOG_MM_BWD"):  # the GT5 phases run the JAX package's default modes
        os.environ.pop(k, None)
    phase_build()
    if "--dist" in sys.argv[1:]:  # [dist gt5 prod] and [model axis gt5 prod] alone, on every card
        print(json.dumps({"dist": phase_dist(card), "model_axis": phase_model_axis(card), "card": card}),
              flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--dcode" in sys.argv[1:]:  # [dcode srl bert-base] and [dcode pipeline] alone
        print(json.dumps({"dcode": phase_dcode(card), "card": card}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--bwd-split" in sys.argv[1:]:  # [bwd split] alone, and the production dispatch's kernels by symbol
        split = phase_bwd_split(card)
        rows = 2000
        tables = DeviceFeatureTables.random(serve_cfg(), rows, seed=0, half=True, device="cuda")
        print(json.dumps({"bwd_split": split, "dispatch_by_symbol": dispatch_by_symbol(tables), "card": card}),
              flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--wide" in sys.argv[1:]:  # [wide shapes] alone
        wide_rows, wide = run_wide(card)
        print(json.dumps({"kernels": wide_rows, "wide": wide, "card": card}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # -- GT5 (T = 200, B = 16) ---------------------------------------------
    cfg = serve_cfg()
    t0 = time.perf_counter()
    tables = DeviceFeatureTables.random(cfg, 15000, seed=0, half=True, device="cuda")
    torch.cuda.synchronize()
    gb = sum(nbytes(t) for t in tables.tables.values()) / 1e9
    print(f"[tables gt5] 15000 rows bf16, {gb:.2f} GB on the card, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rows_gt5 = phase_kernels(cfg, tables)
    pred, reqs, counts_gt5, serve_gt5 = phase_serve(cfg, tables, card)
    prof_gt5 = phase_profile(pred, reqs)
    del pred, reqs
    rows_gt5 += phase_kernels_bwd(cfg)
    phase_threads(cfg)
    rows_def_gt5 = phase_kernels_default(cfg)
    bwd_split = phase_bwd_split(card)
    train_counts_gt5, train_gt5 = phase_train(tables, card)
    dispatch_gt5 = phase_dispatch(tables, card)
    serve_prod_counts, serve_prod = phase_serve_prod(tables, card, serve_gt5)
    dispatch_prod_counts, dispatch_prod = phase_dispatch_prod(tables, card, dispatch_gt5["train"])
    worst_gt5, worst_def_gt5 = dict(WORST_REL), dict(WORST_DEFAULT)
    WORST_REL.clear()
    WORST_DEFAULT.clear()
    del tables  # the Learner's own tables and the P100 checks below need the room
    gc.collect()
    torch.cuda.empty_cache()
    learner, serve_cli, export = phase_learner(card, dispatch_prod)
    dist = phase_dist(card)
    model_axis = phase_model_axis(card)
    dcode = phase_dcode(card)
    wide_rows, wide = run_wide(card)

    # -- P100 (T = 4000, B = 2) --------------------------------------------
    cfg = serve_cfg("p100")
    tables = p100_tables(cfg)
    rows = phase_kernels(cfg, tables, B=2)
    pred, reqs, counts, serve = phase_serve(cfg, tables, card, n_requests=16, clients=4, max_batch=2,
                                            buckets=(1, 2), ref_on="plain", n_ref=2)
    prof = phase_profile(pred, reqs, B=2)
    del pred, reqs
    gc.collect()
    torch.cuda.empty_cache()
    rows += phase_kernels_bwd(cfg, B=2)
    rows_def = phase_kernels_default(cfg, B=2)
    train, train_counts = {}, {}
    for (fm, mm), (launched, absent) in MODE_PAIRS.items():
        key = f"flash {fm}, mm {mm}"
        with bwd_modes(fm, mm):
            train_counts[key], train[key] = phase_train(tables, card, "p100", P100_TRAIN_STEPS, "plain",
                                                        launched, absent, label=f" ({key})")
    dispatch_p100 = phase_dispatch_p100(tables, card)
    p100_prod_counts, dispatch_p100_prod = phase_dispatch_p100_prod(tables, card, dispatch_p100)
    peaks = {f"flash {fm}, mm {mm}": step_peak(tables, (fm, mm))
             for fm, mm in (("recompute", "recompute"), ("emit", "emit"))}
    print("[train p100] peak memory of one step, GB (above the resident): "
          + "; ".join(f"{k}: {v['peak_memory_gb']:.3f} ({v['peak_memory_gb'] - v['resident_gb']:.3f})"
                      for k, v in train.items())
          + "; " + "; ".join(f"{k}: {p:.3f} ({a:.3f})" for k, (p, a) in peaks.items()), flush=True)

    print("[kernels] worst relative err by check: gt5 " + ", ".join(f"{k}={v:.2e}" for k, v in worst_gt5.items())
          + "; p100 " + ", ".join(f"{k}={v:.2e}" for k, v in WORST_REL.items()), flush=True)
    print("[kernels default] worst (relative max-diff, Frobenius) by check: gt5 "
          + ", ".join(f"{k}=({a:.2e}, {b:.2e})" for k, (a, b) in worst_def_gt5.items()) + "; p100 "
          + ", ".join(f"{k}=({a:.2e}, {b:.2e})" for k, (a, b) in WORST_DEFAULT.items()), flush=True)

    def launches(name, serve_counts, train_runs):
        """-> (launches on the serving path or the first train run that
        launches ``name``, that run's steps)."""
        if name in serve_counts:
            return serve_counts[name], None
        for c, steps in train_runs:
            if c.get(name):
                return c[name], steps
        return 0, None

    gt5 = {r["name"]: r for r in rows_gt5}
    runs = [(c, P100_TRAIN_STEPS) for c in train_counts.values()]
    for r in rows:
        r["max_rel_err"] = WORST_REL.get(r["name"], 0.0)  # the gather is checked bitwise
        # forward kernels: launches on the serving path; backward: on the train path that runs them
        r["launches"], steps = launches(r["name"], counts, runs)
        r["train_launches_per_step"] = None if steps is None else r["launches"] / steps
        g = gt5[r["name"]]
        g["max_rel_err"] = worst_gt5.get(r["name"], 0.0)
        g["launches"], steps = launches(r["name"], counts_gt5, [(train_counts_gt5, TRAIN_STEPS)])
        r["gt5"] = {k: g.get(k) for k in ("shape", "launches", "max_abs_err", "max_rel_err", "ms", "issue_ms",
                                          "plain_ms", "plain_issue_ms", "library_ms", "library_issue_ms",
                                          "bound_ms", "bound_by")}
    # the "default" variants: launches on the production paths (GT5: the
    # forward kernels on [serve gt5 prod], the backward on [dispatch gt5
    # prod]; P100: [dispatch p100 prod], both mode pairs)
    def prod_launches(name, counts_list):
        return sum(c.get(name, 0) for c in counts_list)

    gt5_def = {r["name"]: r for r in rows_def_gt5}
    keys = ("shape", "launches", "max_abs_err", "max_rel_err", "frobenius_rel_err", "ms", "issue_ms", "plain_ms",
            "plain_issue_ms", "library_ms", "library_issue_ms", "bound_ms", "bound_by")
    for r in rows_def:
        r["launches"] = prod_launches(r["name"], list(p100_prod_counts.values()))
        gd = gt5_def[r["name"]]
        gd["launches"] = prod_launches(r["name"], [serve_prod_counts, dispatch_prod_counts])
        r["gt5"] = {k: gd.get(k) for k in keys}
        # the training entry point's run ([learner gt5 prod]), counted from 0 just before it
        r["gt5"]["learner_launches"] = learner["launches"].get(r["name"], 0)
        # [dist gt5 prod] (a): rank 0's graphed dispatch in the nccl world, counted from 0 just before it
        r["gt5"]["dist_nccl_launches"] = dist["nccl"]["counts"].get(r["name"], 0)
        if r["name"] in bwd_split["p100"]:  # [bwd split]: the two costliest backwards by kernel
            r["split"], r["gt5"]["split"] = bwd_split["p100"][r["name"]], bwd_split["gt5"][r["name"]]
    for r in rows:  # [dist gt5 prod] (b): rank 0's eager steps in the gloo world (fp32)
        r["gt5"]["dist_gloo_launches"] = dist["gloo"]["counts"].get(r["name"], 0)
        # [model axis gt5 prod] (b): rank 0's eager TP steps at 2 heads a rank, counted from 0 just before them
        r["gt5"]["model_axis_gloo_launches"] = model_axis["gloo"]["counts"].get(r["name"], 0)
    for r in rows:  # the BERT-SRL tagger's flash launches: tag_sentences, and (c)'s finetune_srl
        if r["name"] == "flash_attention":
            r["dcode"] = {"launches": dcode["srl"]["tagging"]["launches"]["flash_attention"], **dcode["srl"]["flash"]}
        elif r["name"] == "flash_attention_bwd":
            r["dcode"] = {"launches": dcode["srl"]["golden"]["launches"]["flash_attention_bwd"],
                          "step_launches": dcode["srl"]["finetune_step"]["launches"]["flash_attention_bwd"],
                          **dcode["srl"]["finetune_step"]["flash_bwd"]}
    rows += rows_def + wide_rows
    if CONTEXT_WARNINGS:
        fail(f"a thread ran cuBLAS with no current CUDA context: {CONTEXT_WARNINGS}")
    print("[threads] no warning of a thread without a current CUDA context in the run", flush=True)
    print(json.dumps({"kernels": rows, "serve": serve, "profile": prof, "train": train,
                      "peak_memory_gb": {k: list(v) for k, v in peaks.items()},
                      "gt5": {"serve": serve_gt5, "profile": prof_gt5, "train": train_gt5},
                      "dispatch": {"gt5": dispatch_gt5, "p100": dispatch_p100},
                      "prod": {"serve_gt5": serve_prod, "dispatch_gt5": dispatch_prod,
                               "dispatch_p100": dispatch_p100_prod},
                      "learner": {k: v for k, v in learner.items() if k != "launches"},
                      "serve_cli": serve_cli, "export": export, "dist": dist, "model_axis": model_axis,
                      "dcode": dcode, "wide": wide, "card": card}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
