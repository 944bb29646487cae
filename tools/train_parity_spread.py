#!/usr/bin/env python3
"""Spread of chip_smoke.py's train comparison (c) over seeds, on one GPU.

    python3 tools/train_parity_spread.py [--regime gt5|p100] [--root DIR] [--seeds 3,4,5]

For each seed s: the regime's recipe model from weights seed s, trained on
the card from batches of seed s + 8 as chip_smoke.py's phase (b) trains
it (a warm-up step, the phase's steps, one more step on the first batch:
s = 3 is chip_smoke.py's own state), then one step of the trained state
with the card's kernels and on the plain path on the second batch, as
chip_smoke.py's (c) compares them: kink-aware, the cotangent zeroed on
the logits near a ReLU kink (``chip_smoke.kink_keep`` of the plain
step's forward).

  * ``gt5`` (the default): the production recipe at B=16, 30 steps, the
    plain path on the CPU (``chip_smoke.train_cfg``);
  * ``p100``: the JAX package's P100 recipe at B=2 on the single-chip int8
    store (``chip_smoke.p100_tables``), 10 steps, the plain path on the
    card (every float kernel swapped for its plain version: a T=4000
    step on the host is slow), in each backward-mode pair of
    chip_smoke.py's P100 train phase (``MODE_PAIRS``).

Prints, per seed, the share of logits zeroed, the loss and the worst
relative gradient error (Frobenius norm over each leaf) with its leaf:
with the card's kernels, with every float kernel's wrapper (forward and
backward) replaced on the card by its plain version (GT5 only: at P100
that is the reference itself), and with one family's (flash, mm, head)
replaced at a time, so that a kernel's share of the error shows; with the
kernels, the comparison without the kink mask ("unmasked", as (c) was
before it); and the mask with the mm layer's FFN at the head's eps
(``chip_smoke.KINK_EPS``) in place of ``FFN_KINK_EPS`` ("ffn at
<eps>": its share of zeroed logits and the kernels' worst error), which
sizes ``FFN_KINK_EPS``.  Reports, fails nothing.

``--root`` takes another checkout of the repository (its ``chip_smoke.py``
and ``vog_tpu_torch``), so that two trees are measured by the same code.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

SEEDS = {"gt5": "3,4,5,6,7,8,9,10", "p100": "3,4,5,6,7,8"}


def worst(gc, gp, rel_err):
    rels = {k: rel_err(gc[k], r) for k, r in gp.items()}
    k = max(rels, key=rels.get)
    return k, rels[k]


def spread_seed(cs, s: int, regime: str, tables, n_rows: int) -> dict:
    """One seed's row: the trained state, then (c)'s comparison every way."""
    import torch

    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import TrainState, make_train_step

    p100 = regime == "p100"
    cfg, parity = cs.train_cfg(0.1, regime), cs.train_cfg(0.0, regime)
    steps = cs.P100_TRAIN_STEPS if p100 else cs.TRAIN_STEPS
    ref_dev = "cuda" if p100 else "cpu"  # chip_smoke.py's ref_on: "plain" at P100, "cpu" at GT5
    batches = cs.make_train_batches(cfg, steps + 1, cfg.train.bs, n_rows, 5000, seed=s + 8)
    model = get_model(cfg, 5000, device="cuda", seed=s, train=True)
    state, step = TrainState.create(cfg, model), make_train_step(cfg)
    dev = [{k: torch.as_tensor(v).cuda() for k, v in b.items()} for b in batches]
    state, _ = step(state, dev[-1], seed=0, tables=tables)
    for i in range(steps):
        state, aux = step(state, dev[i], seed=0, tables=tables)
    loss = float(aux["loss"])
    state, _ = step(state, dev[0], seed=0, tables=tables)  # chip_smoke.py's profiled step
    sd = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    del state, model, dev
    torch.cuda.empty_cache()

    def ref(keep=None):
        return cs.step_grads(parity, sd, batches[1], tables, ref_dev, keep, plain=p100)

    lp, gp, keep, (share, ffn) = ref()
    r = dict(seed=s, last_train_loss=loss, ref_loss=lp, kink_share=share, ffn_share=ffn)
    fams_by_name = (("kernels", ()), *((("plain", cs.FAMILIES),) if not p100 else ()),
                    *((f + " plain", (f,)) for f in cs.FAMILIES))
    for name, fams in fams_by_name:
        undo = cs.plain_kernels(fams)
        try:
            lc, gc, _, _ = cs.step_grads(parity, sd, batches[1], tables, "cuda", keep)
        finally:
            undo()
        r[name] = (*worst(gc, gp, cs.rel_err), lc)
    ones = torch.ones_like(keep)
    _, gp1, _, _ = ref(ones)
    lc, gc, _, _ = cs.step_grads(parity, sd, batches[1], tables, "cuda", ones)
    r["unmasked"] = (*worst(gc, gp1, cs.rel_err), lc)
    # the FFN masked at the head's eps: its share and the kernels' error
    eps = cs.FFN_KINK_EPS
    cs.FFN_KINK_EPS = cs.KINK_EPS
    try:
        _, gp2, keep2, (share2, ffn2) = ref()
    finally:
        cs.FFN_KINK_EPS = eps
    lc, gc, _, _ = cs.step_grads(parity, sd, batches[1], tables, "cuda", keep2)
    r[f"ffn at {cs.KINK_EPS:g}"] = (*worst(gc, gp2, cs.rel_err), lc)
    r["ffn_eps_share"] = (share2, ffn2)
    return r


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--regime", choices=tuple(SEEDS), default="gt5")
    ap.add_argument("--seeds", default=None)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.root).resolve()))
    import torch

    import chip_smoke as cs
    from vog_tpu_torch.data.device_store import DeviceFeatureTables

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    card = cs.phase_card()[1]
    if a.regime == "p100":
        tables, n_rows = cs.p100_tables(cs.serve_cfg("p100")).tables, cs.P100_ROWS
        pairs = list(cs.MODE_PAIRS)
    else:
        tables, n_rows = DeviceFeatureTables.random(cs.serve_cfg(), 15000, seed=0, half=True,
                                                    device="cuda").tables, 15000
        pairs = [None]  # the JAX package's default modes
    out = []
    skip = ("seed", "last_train_loss", "ref_loss", "kink_share", "ffn_share", "ffn_eps_share", "modes")
    for pair in pairs:
        label = f"flash {pair[0]}, mm {pair[1]}" if pair else "default modes"
        for s in (int(x) for x in (a.seeds or SEEDS[a.regime]).split(",")):
            t0 = time.perf_counter()
            with cs.bwd_modes(*pair) if pair else contextlib.nullcontext():
                r = spread_seed(cs, s, a.regime, tables, n_rows)
            r["modes"] = label
            out.append(r)
            share2, ffn2 = r["ffn_eps_share"]
            print(f"[spread {a.regime}] ({label}) seed {s}: loss of the last train step {r['last_train_loss']:.6f}; "
                  f"(c) plain loss {r['ref_loss']:.6f}, cotangent zeroed on {r['kink_share']:.4f} of the logits "
                  f"({r['ffn_share']:.4f} by the mm layer's FFN alone at {cs.FFN_KINK_EPS:g}; at "
                  f"{cs.KINK_EPS:g}: {share2:.4f}, {ffn2:.4f}); worst relative err (leaf, card loss): "
                  + "; ".join(f"{k} {r[k][1]:.3e} ({r[k][0]}, {r[k][2]:.6f})" for k in r if k not in skip)
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"root": a.root, "regime": a.regime, "card": card, "spread": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
