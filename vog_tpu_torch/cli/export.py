"""Export a checkpoint to a standalone serving artifact (counterpart of
vog_tpu/cli/export.py)::

  python -m vog_tpu_torch.cli.export <uid> [--tag=last] [--batch=8] \\
      [--out=<misc.tmp_path>/exports/<uid>.vogx] [--encoding=f32|bf16|int8] \\
      [--with_tables] [--platforms=gpu|cpu] [--random_init] [overrides...]

The artifact (``vog_tpu_torch/export.py``) holds the forward as an exported
program with the weights inside and replays without the model code or a
checkpoint::

    from vog_tpu_torch.export import ExportedPredictor
    pred = ExportedPredictor("<artifact dir>")
    out = pred(request_batch)        # the live Predictor's contract

``--encoding`` ships the request features 2x (bf16) or 4x (int8) smaller;
``--with_tables`` puts the device feature tables in the artifact, and
requests carry ``vid_rows``.  ``--platforms`` names the one device type
the program is for, which is the one it is exported on (``misc.platform``:
the card unless ``cpu``).  After the export the CLI checks the artifact
against the live predictor (``cuda_graphs`` off) on one random request
batch and prints the largest score difference.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np

from vog_tpu_torch.cli.train import PLATFORMS, build_cfg, device_of, parse_argv


def random_request(spec: Dict, n_rows: int, vocab_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """One random request batch of ``spec`` (``export.request_spec`` in
    the f32 encoding), as the JAX CLI's self-check makes it."""
    rng = np.random.default_rng(seed)
    req = {}
    for k, (shape, dt) in spec.items():
        if k == "vid_rows":
            req[k] = rng.integers(0, n_rows, shape).astype(dt) if n_rows else np.zeros(shape, dt)
        elif dt.kind == "f":
            req[k] = rng.normal(scale=0.3, size=shape).astype(dt)
        elif k == "tokens":
            req[k] = rng.integers(1, vocab_size, shape).astype(dt)
        elif k in ("srl_arg_mask", "prop_mask"):
            req[k] = np.ones(shape, dt)
        elif k == "seq_len":
            req[k] = np.full(shape, 4, dt)
        elif k == "srl_spans":
            req[k] = np.tile(np.array([0, 1], dt), shape[:-1] + (1,))
        else:
            req[k] = np.ones(shape, dt)
    return req


def main(argv=None) -> Dict:
    uid, overrides, flags = parse_argv(sys.argv[1:] if argv is None else argv)
    tag = overrides.pop("tag", "last")
    batch = int(overrides.pop("batch", 8))
    out = overrides.pop("out", None)
    platforms = overrides.pop("platforms", None)
    encoding = overrides.pop("encoding", "f32")
    cfg = build_cfg(overrides)
    device = device_of(cfg)
    if platforms is not None and [PLATFORMS.get(p, p) for p in platforms.split(",")] != [device or "cuda"]:
        raise SystemExit(f"--platforms={platforms}: the program replays on the device type it is exported "
                         f"on, here {device or 'cuda'} (misc.platform={cfg.misc.platform!r})")

    from vog_tpu_torch.data.device_store import DeviceFeatureTables
    from vog_tpu_torch.data.loader import get_data
    from vog_tpu_torch.export import ExportedPredictor, export_predictor, request_spec
    from vog_tpu_torch.serve import Predictor

    data = get_data(cfg)
    glove = data.vocab.vectors
    with_tables = "with_tables" in flags
    tables = rows = None
    if with_tables:
        dft = DeviceFeatureTables.from_store(cfg, data.train_dl.ds.store, half=cfg.misc.half_feats,
                                             int8=cfg.misc.int8_feats, device=device)
        tables, rows = dft.tables, dft.rows
    # the live predictor eager: the export traces its forward, and the
    # self-check compares with it
    if "random_init" in flags:
        pred = Predictor(cfg, None, len(data.vocab), tables=tables, device=device, cuda_graphs=False,
                         glove=glove)
    else:
        ckpt = Path(cfg.misc.tmp_path) / "models" / uid / f"{tag}.pt"
        pred = Predictor.from_checkpoint(cfg, ckpt, tables=tables, device=device, glove=glove,
                                         cuda_graphs=False)

    out = Path(out) if out else Path(cfg.misc.tmp_path) / "exports" / f"{uid}.vogx"
    t0 = time.perf_counter()
    path = export_predictor(pred, batch, out, feature_encoding=encoding, with_tables=with_tables, rows=rows)
    seconds = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    print(f"exported {path} ({size / 1e6:.1f} MB, batch={batch}) in {seconds:.1f} s", flush=True)

    # self-check on one random request at the f32 schema: the artifact
    # encodes it itself, so a difference is the encoding's quantization
    n_rows = int(next(iter(tables.values())).shape[0]) if tables else 0
    req = random_request(request_spec(cfg, batch, vid_rows=with_tables), n_rows, len(data.vocab))
    live = pred(req)
    replay = ExportedPredictor(path, device=device)(req)
    d = float(np.max(np.abs(live["scores"] - replay["scores"])))
    print(f"self-check vs live predictor: max |dscore| = {d:.3g}", flush=True)
    return {"path": str(path), "max_abs_diff": d, "bytes": size, "seconds": seconds}


if __name__ == "__main__":
    main()
