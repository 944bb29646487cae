#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vog_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before
the last line:

1. card: ``nvidia-smi`` name and power limit, the device name; TF32 off;
2. build: nvcc builds every kernel of ``vog_tpu_torch/csrc`` (in parallel);
3. kernels: each of the four kernels against its plain PyTorch version on
   the card, at the serving path's shapes (GT5 SPAT, B=16): bitwise for
   the gather in f32/bf16/int8, max |err| <= 1e-4 * max(1, max|ref|) for
   the fp32 kernels (sums run in another order); then CUDA-event times of
   the kernel, the plain version and the library call where one exists
   (median of 15 runs of 10 back-to-back calls),
   and the bound of each kernel (bytes over 3.35 TB/s or fp32 operations
   over 67 TFLOP/s, the H100 SXM peaks);
4. serve: 15,000-row bf16 feature tables made on the card from a seed,
   full-width VOGNet (GT5 production widths, random weights from a seed),
   96 ``vid_rows`` requests from 8 concurrent clients through
   ``ServingLoop`` (max_batch 16, buckets, pipelined).  Checks finite
   outputs of the right shapes, that all four kernels launched, and that
   the scores of a few requests agree with the same weights run on the CPU
   through the plain path; prints p50/p95 latency and requests/s;
5. profile: one B=16 batch, its host wall time, its forward's stream span
   and its device time by kernel (torch.profiler), and the idle share.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOP_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
TOL = 1e-4  # fp32 kernels: max |err| <= TOL * max(1, max|ref|)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 15, inner: int = 10, warm: int = 3) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call, after warm-up."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / inner)
    return statistics.median(ts)


def bound_ms(n_bytes: float, n_flops: float):
    tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def check_close(name, got, ref) -> float:
    err = max_err(got, ref)
    lim = TOL * max(1.0, float(ref.abs().max()))
    if not err <= lim:
        fail(f"{name}: max |err| {err:.3e} > {lim:.3e}")
    return err


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, card


def phase_build():
    from vog_tpu_torch.kernels import _build

    secs = _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernels built in {secs:.1f} s into {_build.build_dir()}", flush=True)
    for src in _build.SOURCES:
        log = _build.build_dir() / f"{Path(src).stem}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    print(f"[build] {src}: {line.strip()}", flush=True)


def serve_cfg():
    from vog_tpu_torch.config import Cfg, post_proc_config

    cfg = Cfg()  # production widths: vis 512, 4 heads, lstm 256, emb 300, role 128
    cfg.mdl.name = "vog"
    cfg.mdl.decomposed_mm = True
    cfg.mdl.head_type = "fused"
    cfg.mdl.obj_tx_layers = 1
    cfg.mdl.mm_tx_layers = 1
    cfg.mdl.dtype = "float32"
    cfg.ds.conc_type = "spat"
    cfg.ds.exp_setting = "gt5"
    cfg.misc.half_feats = True
    return post_proc_config(cfg)


def phase_kernels(cfg, tables, B: int = 16):
    """Each kernel against its plain version on the card at the serving
    path's shapes; returns the kernel table rows (without launches)."""
    import torch

    from vog_tpu_torch.data.device_store import _pack_rows
    from vog_tpu_torch.kernels import attention, grounding_head, gather, mm_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    V, F, P, A = cfg.ds.num_cmp, cfg.ds.num_frms, cfg.ds.num_prop_per_frm, cfg.ds.max_srl_args
    D, H = cfg.mdl.vis_dim, cfg.mdl.n_heads
    dh, T = D // H, F * V * P
    rows = torch.randint(0, tables.n_rows, (B, V), generator=g, device=dev, dtype=torch.int32)
    rows[0, 1] = rows[0, 0]  # a duplicate row
    out = []

    # -- gather: bitwise in bf16 (the resident tables), f32 and int8 ------
    feats, seg = tables.tables["feats"], tables.tables["seg"]
    for name, t in (("bf16 feats", feats), ("bf16 seg", seg)):
        if not torch.equal(gather.gather_rows(t, rows), gather.gather_rows_plain(t, rows)):
            fail(f"gather_rows {name}: not bitwise equal to the plain version")
    small = torch.randn((512, F, P, cfg.ds.prop_dim), generator=g, device=dev) * 0.3
    for dt, int8 in ((torch.float32, False), (torch.int8, True)):
        t = _pack_rows({"feats": small}, dt, int8)["feats"]
        r = torch.randint(-5, 520, (B, V), generator=g, device=dev, dtype=torch.int32)  # out of range too
        if not torch.equal(gather.gather_rows(t, r), gather.gather_rows_plain(t, r)):
            fail(f"gather_rows {t.dtype}: not bitwise equal to the plain version")
    # time over 8 row sets (8 x 13 MB > the 50 MB L2), so each call reads cold rows
    sets = [torch.randint(0, tables.n_rows, (B, V), generator=g, device=dev, dtype=torch.int32)
            for _ in range(8)]
    turn = [0]

    def nxt():
        turn[0] = (turn[0] + 1) % len(sets)
        return sets[turn[0]]

    flat = rows.reshape(-1)
    ms = time_ms(lambda: gather.gather_rows(feats, nxt()))
    plain = time_ms(lambda: gather.gather_rows_plain(feats, nxt()))
    lib = time_ms(lambda: torch.index_select(feats, 0, nxt().reshape(-1)))
    row_bytes = feats[0].numel() * feats.element_size()
    bms, by = bound_ms(2 * flat.numel() * row_bytes + nbytes(rows), 0)
    out.append(dict(name="gather_rows", route="cuda", source="vog_tpu_torch/csrc/gather.cu",
                    replaces="vog_tpu/kernels/gather.py:79", max_abs_err=0.0, ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib,
                    shape=f"bf16 table {tuple(feats.shape)}, rows {tuple(rows.shape)}"))
    print(f"[kernels] gather_rows bitwise (bf16 feats+seg, f32, int8) ms={ms:.4f} plain={plain:.4f} "
          f"index_select={lib:.4f} bound={bms:.4f}", flush=True)

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
    ms = time_ms(lambda: attention.flash_attention_fwd(q, k, v, mask))
    plain = time_ms(lambda: attention.flash_attention_plain(q, k, v, mask))
    bmask = (mask > 0)[:, None, None, :]
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bmask))
    fl = 4.0 * B * H * T * T * dh
    bms, by = bound_ms(nbytes(q, k, v, mask) + nbytes(q) + B * H * T * 4, fl)
    out.append(dict(name="flash_attention", route="cuda", source="vog_tpu_torch/csrc/attention.cu",
                    replaces="vog_tpu/kernels/attention.py:286", max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib, shape=f"q,k,v {tuple(q.shape)} f32, no bias"))
    print(f"[kernels] flash_attention max_err={err:.3e} (no bias, spat bias, mixed-frame bias) "
          f"ms={ms:.4f} plain={plain:.4f} sdpa={lib:.4f} bound={bms:.4f}", flush=True)

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
    ms = time_ms(lambda: mm_attention.mm_attention_fwd(qm, k, v, cn, mask, fb, fid_spat))
    plain = time_ms(lambda: mm_attention.mm_attention_plain(qm, k, v, cn, mask, fb, fid_spat))
    fl = 2.0 * B * H * T * T * dh * (1 + A)
    out_b = B * H * A * T * (dh + 2) * 4
    bms, by = bound_ms(nbytes(qm, k, v, cn, mask, fb, fid_spat) + out_b, fl)
    out.append(dict(name="mm_shared_qk_attention", route="cuda", source="vog_tpu_torch/csrc/mm_attention.cu",
                    replaces="vog_tpu/kernels/mm_attention.py:315", max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=None, shape=f"qm,km,vm {tuple(qm.shape)}, A={A} f32"))
    print(f"[kernels] mm_shared_qk_attention max_err={err:.3e} ms={ms:.4f} plain={plain:.4f} "
          f"bound={bms:.4f}", flush=True)

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
    ms = time_ms(lambda: grounding_head.fused_grounding_head(*args))
    plain = time_ms(lambda: grounding_head.grounding_head_plain(*args))
    fl = 2.0 * B * A * T * (D * D + D * Dh + Dh)
    bms, by = bound_ms(nbytes(*args) + B * A * T * 4, fl)
    out.append(dict(name="fused_grounding_head", route="cuda", source="vog_tpu_torch/csrc/grounding_head.cu",
                    replaces="vog_tpu/kernels/grounding_head.py:190", max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=None, shape=f"vis {tuple(vis.shape)}, A={A} f32"))
    print(f"[kernels] fused_grounding_head max_err={err:.3e} ms={ms:.4f} plain={plain:.4f} "
          f"bound={bms:.4f}", flush=True)
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


def phase_serve(cfg, tables, card: str, n_requests: int = 96, clients: int = 8):
    import numpy as np
    import torch

    from vog_tpu_torch.data.device_store import gather_from_tables
    from vog_tpu_torch.kernels import _build
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.serving import ServingLoop

    vocab = 5000
    pred = Predictor(cfg, None, vocab, tables=tables.tables, device="cuda")
    flushes = [0]
    dispatch = pred.dispatch

    def counted(batch):
        flushes[0] += 1
        return dispatch(batch)

    pred.dispatch = counted
    reqs = make_requests(cfg, n_requests, tables.n_rows, vocab, seed=0)
    loop = ServingLoop(pred, max_batch=16, max_wait_ms=2.0, pipeline_depth=2, bucket_sizes=[1, 2, 4, 8])
    results, lat = [None] * n_requests, [0.0] * n_requests
    errors = []
    try:
        loop.prewarm(reqs[0])
        torch.cuda.synchronize()

        def client(c):
            try:
                for i in range(c, n_requests, clients):
                    t0 = time.perf_counter()
                    results[i] = loop(reqs[i])
                    lat[i] = (time.perf_counter() - t0) * 1e3
            except BaseException as e:  # re-raised below, after the loop closes
                errors.append(e)

        _build.reset_counts()
        flushes[0] = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
    finally:
        loop.close()
    if errors:
        raise errors[0]

    ds = cfg.ds
    V, F, P, A = ds.num_cmp, ds.num_frms, ds.num_prop_per_frm, ds.max_srl_args
    for out in results:
        if out is None:
            fail("a request got no response")
        shapes = {"scores": (A, V, F, P), "pred_vid": (A, F), "pred_prop": (A, F),
                  "pred_box": (A, F, 4), "pred_score": (A, F)}
        for k, s in shapes.items():
            if out[k].shape != s:
                fail(f"{k} shape {out[k].shape} != {s}")
            if not np.isfinite(out[k]).all():
                fail(f"{k} is not finite")
    names = ("gather_rows", "flash_attention", "mm_shared_qk_attention", "fused_grounding_head")
    for n in names:
        if counts.get(n, 0) <= 0:
            fail(f"kernel {n} was not launched on the serving path (counts {counts})")

    # the same weights through the plain path on the CPU, features gathered
    # from the card's tables (bf16 -> f32 is exact)
    n_ref = 4
    sd = {k: v.cpu() for k, v in pred.model.state_dict().items()}
    cpu = Predictor(cfg, sd, vocab, device="cpu")
    sub = {k: np.stack([r[k] for r in reqs[:n_ref]]) for k in reqs[0]}
    with torch.no_grad():
        g = gather_from_tables(
            {"vid_rows": torch.from_numpy(sub["vid_rows"]).cuda(),
             "prop_mask": torch.from_numpy(sub["prop_mask"]).cuda()}, tables.tables)
    full = {k: v for k, v in sub.items() if k != "vid_rows"}
    full["props"] = g["props"].cpu().numpy()
    full["seg_feats"] = g["seg_feats"].cpu().numpy()
    full["batch_mask"] = np.ones((n_ref,), np.uint8)
    ref = cpu(full)
    valid = sub["prop_mask"][:, None].astype(bool).repeat(A, 1)
    got = np.stack([results[i]["scores"] for i in range(n_ref)])
    scale = max(1.0, float(np.abs(ref["scores"][valid]).max()))
    err = float(np.abs(got[valid] - ref["scores"][valid]).max())
    tol = 2e-4 * scale  # fp32 on both sides, sums in another order
    if not err <= tol:
        fail(f"served scores differ from the CPU plain path: {err:.3e} > {tol:.3e}")
    cand = ref["scores"].transpose(0, 1, 3, 2, 4).reshape(n_ref, A, F, V * P)
    top2 = np.sort(cand, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
    for k in ("pred_vid", "pred_prop"):
        gk = np.stack([results[i][k] for i in range(n_ref)])
        if not np.array_equal(gk[clear], ref[k][clear]):
            fail(f"{k} differs from the CPU plain path where the top-2 margin exceeds {2 * tol:.2e}")
    p50, p95 = np.percentile(lat, 50), np.percentile(lat, 95)
    rps = n_requests / wall
    print(f"[serve] {n_requests} requests, {clients} clients, max_batch 16: p50={p50:.2f} ms "
          f"p95={p95:.2f} ms {rps:.1f} req/s on {card}", flush=True)
    print(f"[serve] launches on the serving path: {counts} over {flushes[0]} flushes; CPU-vs-card score max err {err:.3e} "
          f"(tol {tol:.2e}), {int(clear.sum())}/{clear.size} argmaxes compared", flush=True)
    return pred, reqs, counts, dict(p50_ms=p50, p95_ms=p95, requests_per_s=rps,
                                    n_requests=n_requests, flushes=flushes[0])


KERNEL_SYMBOLS = {"gather_rows": "gather_", "flash_attention": "flash_fwd",
                  "mm_shared_qk_attention": "mm_fwd", "fused_grounding_head": "head_fwd"}


def phase_profile(pred, reqs, B: int = 16, reps: int = 5):
    """Where the time of one B=16 batch goes: host wall of a whole call
    (upload, forward, copy back), the forward's stream span (CUDA events),
    and the device time by kernel from torch.profiler."""
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
        span = time_ms(lambda: pred.predict(dev), reps=5, inner=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                pred.predict(dev)
            torch.cuda.synchronize()
    by_kernel = {k: 0.0 for k in KERNEL_SYMBOLS}
    other = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = us / 1e3 / reps
        hit = [k for k, sym in KERNEL_SYMBOLS.items() if sym in e.key]
        if hit:
            by_kernel[hit[0]] += ms
        else:
            other[e.key] = other.get(e.key, 0.0) + ms
    busy = sum(by_kernel.values()) + sum(other.values())
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    out = dict(batch=B, call_wall_ms=statistics.median(walls), forward_span_ms=span,
               device_busy_ms=busy, idle_share=max(0.0, 1.0 - busy / span), kernels_ms=by_kernel,
               other_device_ms=sum(other.values()), top_other=[[k[:60], v] for k, v in top])
    print(f"[profile] B={B}: call wall {out['call_wall_ms']:.3f} ms, forward span {span:.3f} ms, "
          f"device busy {busy:.3f} ms (idle {out['idle_share']:.2f}); ours "
          + ", ".join(f"{k}={v:.3f}" for k, v in by_kernel.items())
          + f"; other {out['other_device_ms']:.3f} ms: "
          + "; ".join(f"{k[:40]}={v:.3f}" for k, v in top), flush=True)
    return out


def main() -> int:
    name, card = phase_card()
    if not (ROOT / "vog_tpu_torch").is_dir():
        fail("vog_tpu_torch is not beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import torch

    from vog_tpu_torch.data.device_store import DeviceFeatureTables

    phase_build()
    cfg = serve_cfg()
    t0 = time.perf_counter()
    tables = DeviceFeatureTables.random(cfg, 15000, seed=0, half=True, device="cuda")
    torch.cuda.synchronize()
    gb = sum(nbytes(t) for t in tables.tables.values()) / 1e9
    print(f"[tables] 15000 rows bf16, {gb:.2f} GB on the card, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rows = phase_kernels(cfg, tables)
    pred, reqs, counts, serve = phase_serve(cfg, tables, card)
    for r in rows:
        r["launches"] = counts.get(r["name"], 0)
    prof = phase_profile(pred, reqs)
    print(json.dumps({"kernels": rows, "serve": serve, "profile": prof, "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
