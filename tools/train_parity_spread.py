#!/usr/bin/env python3
"""Spread of chip_smoke.py's train comparison (c) over seeds, on one GPU.

    python3 tools/train_parity_spread.py [--root DIR] [--seeds 3,4,5,6,7,8,9,10]

For each seed s: the production recipe's model from weights seed s,
trained on the card from batches of seed s + 8 as chip_smoke.py's phase
(b) trains it (a warm-up step, 30 steps, one more step on the first
batch: s = 3 is chip_smoke.py's own state), then one step of the trained
state on the card and on the CPU plain path on the second batch, as
chip_smoke.py's (c) compares them: kink-aware, the cotangent zeroed on
the logits near a ReLU kink (``chip_smoke.kink_keep`` of the CPU step's
forward).  Prints, per seed, the share of logits zeroed, the loss and the
worst relative gradient error (Frobenius norm over each leaf) with its
leaf: with the card's kernels, with every float kernel's wrapper
(forward and backward) replaced on the card by its plain version, and
with one family's (flash, mm, head) replaced at a time, so that a
kernel's share of the error shows; and, with the kernels, the comparison
without the kink mask ("unmasked", as (c) was before it).  Reports,
fails nothing.

``--root`` takes another checkout of the repository (its ``chip_smoke.py``
and ``vog_tpu_torch``), so that two trees are measured by the same code.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def worst(gc, gp, rel_err):
    rels = {k: rel_err(gc[k], r) for k, r in gp.items()}
    k = max(rels, key=rels.get)
    return k, rels[k]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seeds", default="3,4,5,6,7,8,9,10")
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.root).resolve()))
    import torch

    import chip_smoke as cs
    from vog_tpu_torch.data.device_store import DeviceFeatureTables
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_train_step

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    tables = DeviceFeatureTables.random(cs.serve_cfg(), 15000, seed=0, half=True, device="cuda").tables
    cfg, parity = cs.train_cfg(0.1), cs.train_cfg(0.0)
    out = []
    for s in (int(x) for x in a.seeds.split(",")):
        t0 = time.perf_counter()
        batches = cs.make_train_batches(cfg, cs.TRAIN_STEPS + 1, 16, 15000, 5000, seed=s + 8)
        model = get_model(cfg, 5000, device="cuda", seed=s, train=True)
        state, step = TrainState.create(cfg, model), make_train_step(cfg)
        dev = [{k: torch.as_tensor(v).cuda() for k, v in b.items()} for b in batches]
        state, _ = step(state, dev[-1], seed=0, tables=tables)
        for i in range(cs.TRAIN_STEPS):
            state, aux = step(state, dev[i], seed=0, tables=tables)
        loss = float(aux["loss"])
        state, _ = step(state, dev[0], seed=0, tables=tables)  # chip_smoke.py's profiled step
        sd = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        lp, gp, keep, (share, _) = cs.step_grads(parity, sd, batches[1], tables, "cpu")
        r = dict(seed=s, last_train_loss=loss, cpu_loss=lp, kink_share=share)
        fams_by_name = (("kernels", ()), ("plain", cs.FAMILIES), *((f + " plain", (f,)) for f in cs.FAMILIES))
        for name, fams in fams_by_name:
            undo = cs.plain_kernels(fams)
            try:
                lc, gc, _, _ = cs.step_grads(parity, sd, batches[1], tables, "cuda", keep)
            finally:
                undo()
            r[name] = (*worst(gc, gp, cs.rel_err), lc)
        ones = torch.ones_like(keep)
        _, gp1, _, _ = cs.step_grads(parity, sd, batches[1], tables, "cpu", ones)
        lc, gc, _, _ = cs.step_grads(parity, sd, batches[1], tables, "cuda", ones)
        r["unmasked"] = (*worst(gc, gp1, cs.rel_err), lc)
        out.append(r)
        skip = ("seed", "last_train_loss", "cpu_loss", "kink_share")
        print(f"[spread] seed {s}: loss of the 30th step {loss:.6f}; (c) CPU loss {lp:.6f}, cotangent zeroed "
              f"on {share:.4f} of the logits; worst relative err (leaf, card loss): "
              + "; ".join(f"{k} {r[k][1]:.3e} ({r[k][0]}, {r[k][2]:.6f})" for k in r if k not in skip)
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"root": a.root, "spread": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
