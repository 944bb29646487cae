"""Time the head backward, the mm backward (emit) and the mm forward of
the package at ``--root`` on the card, and the production recipe's graphed
train step, so that two trees can be compared in one call (parent, change,
change, parent):

    git archive <parent> | tar -x -C <parent dir>
    VOG_TORCH_BUILD_DIR=<build dir> python3 tools/bwd_ab.py --root <parent dir> --label P1
    VOG_TORCH_BUILD_DIR=<build dir> python3 tools/bwd_ab.py --root . --label N1

(one build directory: the trees' unchanged sources build once).  Each
kernel row: device ms (``chip_smoke.time_ms`` behind a sleep kernel) and
with the host's issue, at GT5 (B=16, T=200) and P100 (B=2, T=4000), A=5,
D=512, "default" and "highest", on inputs made from seed 4, and the mm
backward's and forward's kernels each (``chip_smoke.bwd_by_kernel``: a
profiler run; at "default" the forward is mm_fwd_prep_wg + mm_fwd_wg since
the "wg" route, mm_fwd before it);
the step:
host ms of a graphed dispatch of 16 production steps (``prod_cfg``) on
2,000 random table rows, the median of 4 over 16.  Prints one line a
reading and, last, one JSON object with all of them and the card's name
and power limit (nvidia-smi)."""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--label", default="run")
    ap.add_argument("--no-step", action="store_true")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from vog_tpu_torch.kernels import grounding_head, mm_attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    out = {"label": opts.label, "root": opts.root, "card": card, "rows": {}}

    def inputs(B, T, seed=4):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        A, D, H = 5, 512, 4
        Dh, dh = D // 2, D // H
        r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
        vis, arg = torch.relu(r(B, T, D)), torch.relu(r(B, A, D))
        head = (vis, arg, vis @ (r(D, D) / D**0.5), arg @ (r(D, D) / D**0.5), r(D, D) / D**0.5, r(D, Dh) / D**0.5,
                r(Dh) * 0.1, r(Dh) / Dh**0.5, r(1)), r(B, A, T)
        qm, k, v = r(B, H, T, dh) * dh**-0.5, r(B, H, T, dh), r(B, H, T, dh)
        mask = (torch.rand((B, T), generator=g, device=dev) > 0.2).float()
        mask[:, 0] = 1.0
        F = 10
        fid = (torch.arange(T, device=dev) // (T // F)).to(torch.int32)
        ops = (qm, k, v, -3.0 * torch.rand((B, H, A, T), generator=g, device=dev), mask, r(H, F, F) * 0.5, fid)
        with cs.tf32(False):
            fwd = mm_attention.mm_attention_plain(*ops)
        return head, (ops, fwd, r(B, H, A, T, dh))

    for tag, B, T, (reps, inner) in (("gt5", 16, 200, (15, 10)), ("p100", 2, 4000, (7, 3))):
        (hargs, hg), (ops, fwd, gm) = inputs(B, T)
        for prec in ("default", "highest"):
            calls = {
                "head_bwd": lambda: grounding_head.grounding_head_bwd(*hargs, hg, precision=prec),
                "mm_bwd_emit": lambda: mm_attention.mm_attention_bwd(*ops, *fwd, gm, bwd_mode="emit", precision=prec),
                "mm_fwd": lambda: mm_attention.mm_attention_fwd(*ops, precision=prec),
            }
            for name, fn in calls.items():
                with cs.tf32(prec == "default"):
                    ms = cs.time_ms(fn, reps, inner)
                    issue = cs.time_ms(fn, reps, inner, queued=False)
                    # each kernel's device ms from a profiler run (the mm backward's and forward's kernels)
                    split = cs.bwd_by_kernel(fn, reps, inner)["by_kernel"] if name.startswith("mm_") else {}
                key = f"{name} {tag} {prec}"
                out["rows"][key] = {"ms": ms, "issue_ms": issue, "by_kernel": split}
                print(f"[{opts.label}] {key}: device {ms:.4f} ms, w/ issue {issue:.4f} ms"
                      + "".join(f", {k} {v:.4f}" for k, v in split.items()) + f" ({card})", flush=True)
        del hargs, hg, ops, fwd, gm
        torch.cuda.empty_cache()

    if not opts.no_step:
        from vog_tpu_torch.config import apply_matmul_precision
        from vog_tpu_torch.data.ann_store import AnnTables
        from vog_tpu_torch.data.device_store import DeviceFeatureTables
        from vog_tpu_torch.model.grounding import get_model
        from vog_tpu_torch.train import TrainState, dispatch_sizes, make_multi_train_step

        cfg = cs.prod_cfg()
        K, _ = dispatch_sizes(cfg)
        tables = DeviceFeatureTables.random(cs.serve_cfg(), 2000, seed=0, half=True, device="cuda")
        anns, vids = cs.random_ann_arrays(cfg, cs.N_ANNS, tables.n_rows, seed=21)
        all_tables = {**tables.tables, **AnnTables.from_arrays(cfg, anns, vids, device="cuda").tables}
        batches = cs.make_index_batches(cfg, K * 7, cfg.train.bs, cs.N_ANNS, tables.n_rows, seed=24)
        state = TrainState.create(cfg, get_model(cfg, 5000, device="cuda", seed=3, train=True))
        multi = make_multi_train_step(cfg)
        ts = []
        for i in range(7):
            t0 = time.perf_counter()
            multi(state, cs.stack_batches(batches[i * K:(i + 1) * K]), 0, all_tables)[1]["loss"].cpu()
            if i >= 3:  # the first captures the graph
                ts.append((time.perf_counter() - t0) * 1e3 / K)
        apply_matmul_precision(cs.serve_cfg())
        out["step_ms"] = statistics.median(ts)
        print(f"[{opts.label}] production dispatch (K={K}, graphed, 2,000 table rows): {out['step_ms']:.3f} ms a step "
              f"({', '.join(f'{t:.3f}' for t in ts)}) ({card})", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
