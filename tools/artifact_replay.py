#!/usr/bin/env python3
"""Time an exported artifact's replay on the card beside the live predictor.

    python3 tools/artifact_replay.py [--batch=16] [--rows=2000]

The production model (``chip_smoke.prod_cfg``: the widths and numerics of
``configs/gt5_production.yml``, random weights from a seed) with random
bf16 feature tables, exported with its tables at one batch size
(``vog_tpu_torch/export.py``), and one batch of ``vid_rows`` requests.
Each of these is timed as a whole call (upload, forward, copies back,
the host's wait), with CUDA events around back-to-back calls (median of
15 x 10, ``chip_smoke.time_ms`` with the host's issue):

  * the live ``Predictor`` with ``cuda_graphs`` off and on;
  * the artifact's ``ExportedPredictor``: its replay through the CUDA
    graph of the loaded program (the default), and eagerly
    (``cuda_graphs=False``, its LSTM weights laid out in cuDNN's one
    buffer);
  * the eager replay with the LSTM weights as the loaded program holds
    them (separate tensors: cuDNN copies them into one at each call).

It checks each replay against the live eager predictor (bitwise) and
prints one line per reading and a JSON line with the card's name and
power limit.  Needs the card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> dict:
    args = dict(a[2:].split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    B, n_rows = int(args.get("batch", 16)), int(args.get("rows", 2000))

    import numpy as np
    import torch

    from chip_smoke import make_requests, prod_cfg, time_ms
    from vog_tpu_torch.data.device_store import DeviceFeatureTables
    from vog_tpu_torch.export import ExportedPredictor, export_predictor
    from vog_tpu_torch.serve import Predictor

    if not torch.cuda.is_available():
        raise SystemExit("artifact_replay: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = prod_cfg()
    vocab = 5000
    tables = DeviceFeatureTables.random(cfg, n_rows, seed=0, half=True).tables
    live = Predictor(cfg, None, vocab, tables=tables, cuda_graphs=False)
    graphed = Predictor(cfg, live.model.state_dict(), vocab, tables=tables)
    reqs = make_requests(cfg, B, n_rows, vocab, seed=3)
    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    batch["batch_mask"] = np.ones((B,), np.uint8)
    ds = cfg.ds
    batch["targets"] = np.zeros((B, ds.num_cmp, ds.max_srl_args, ds.num_frms, ds.num_prop_per_frm), np.uint8)
    ref = live(batch)
    out = {"card": card, "batch": B, "rows": n_rows}
    with tempfile.TemporaryDirectory(prefix="vog_artifact_") as tmp:
        path = export_predictor(live, B, Path(tmp) / "art", with_tables=True)
        art_graphed = ExportedPredictor(path)
        flat = ExportedPredictor(path, cuda_graphs=False)
        loose = ExportedPredictor(path, cuda_graphs=False)
        loose.program = torch.export.load(str(path / "program.pt2")).module()  # as loaded, not laid out
        for name, pred in (("live eager", live), ("live graphed", graphed), ("artifact graphed", art_graphed),
                           ("artifact eager", flat), ("artifact eager, LSTM weights as loaded", loose)):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the loose program's cuDNN copy warns at each call
                got = pred(batch)
                ms = time_ms(lambda: pred(batch), queued=False)
            same = all(np.array_equal(got[k], ref[k]) for k in ref)
            out[name] = {"ms": ms, "bitwise_live_eager": same}
            print(f"[artifact replay] {name}: {ms:.4f} ms a B={B} call with the host's issue; outputs "
                  f"{'bitwise' if same else 'not bitwise'} the live eager predictor's; on {card}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
