"""Serving process (counterpart of vog_tpu/cli/serve.py): request queue ->
micro-batcher -> Predictor, around ``vog_tpu_torch.serving.ServingLoop``.
Two modes.

Self-test (the loop under concurrent clients)::

  python -m vog_tpu_torch.cli.serve <uid> --cfg=configs/gt5_production.yml \\
      --ds.data_dir=<dir> --selftest=96 --concurrency=8 [--serve.batch=16] [--serve.wait_ms=2]

  Requests come from the valid split (``vid_rows`` requests when the
  device store is on); prints one JSON line with p50/p95/p99/mean latency
  in ms and requests/s.

HTTP endpoint (one ``POST /predict`` a query)::

  python -m vog_tpu_torch.cli.serve <uid> --ds.data_dir=<dir> --port=8400

  Body: {"<field>": <nested list>, ...} with the single-query request
  schema (``vid_rows`` (V,) or ``props`` / ``seg_feats``, ``prop_boxes``,
  ``prop_mask``, ``tokens``, ``seq_len``, ``verb_idx``, ``srl_roles``,
  ``srl_spans``, ``srl_arg_mask``, ``targets`` (zeros at inference)).
  Response: {"pred_vid", "pred_prop", "pred_box", "pred_score"} per (arg,
  frame).

The weights come from the port checkpoint ``<misc.tmp_path>/models/<uid>/<tag>.pt``
(``--tag``, default ``last``; ``Predictor.from_checkpoint``), or fresh
ones with ``--random_init``; ``--artifact=<dir>`` serves an exported
artifact instead (``vog_tpu_torch/export.py``: fixed batch size, no
buckets).  ``--serve.batch`` (default ``train.bs``), ``--serve.wait_ms``,
``--serve.pipeline`` and ``--serve.buckets`` (powers of two below the
batch, each prewarmed, which captures its CUDA graph) shape the loop.
It runs on the card; ``--misc.platform=cpu`` runs the plain path on the
CPU, and without a GPU nothing else runs.

The sequence-parallel ring across processes::

  torchrun --nproc-per-node M -m vog_tpu_torch.cli.serve <uid> ... \
      --misc.multihost=true --misc.mesh_model=M --mdl.sp_attention=true --selftest=16

  Every rank builds the Predictor on the mesh's model axis (the weights
  whole); rank 0 runs the loop and the clients, the others follow its
  flushes (``Predictor.follow``) and return {"followed": n}.  The forward
  is eager (no CUDA graphs).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from vog_tpu_torch.cli.train import build_cfg, device_of, parse_argv
from vog_tpu_torch.data.loader import get_data


def _build_predictor(cfg, uid: str, tag: str, random_init: bool):
    """-> (the live Predictor, the data): the feature tables on the device
    from the dataset's store when ``ds.device_store`` resolves on (the
    loaders then emit ``vid_rows``), the weights from the uid's checkpoint
    or fresh; under ``misc.multihost`` on the mesh's model axis (the
    ring)."""
    from vog_tpu_torch.data.device_store import DeviceFeatureTables, use_device_store
    from vog_tpu_torch.serve import Predictor
    from vog_tpu_torch.train.dist import init_distributed, make_mesh

    device = init_distributed(cfg, device_of(cfg))
    mesh = make_mesh(cfg)
    if mesh.data > 1:
        raise ValueError(f"misc.mesh_data={mesh.data}: cli.serve runs the model axis only (one predictor, its "
                         "attention on the ring); set misc.mesh_data=1")
    on_axis = {"mesh": mesh, "cuda_graphs": False} if mesh.model > 1 else {}
    data = get_data(cfg)
    glove = data.vocab.vectors
    tables = None
    store = data.valid_dl.ds.store
    n_videos = len(store.videos())
    if use_device_store(cfg, n_videos, device):
        dft = DeviceFeatureTables.from_store(cfg, store, half=cfg.misc.half_feats, int8=cfg.misc.int8_feats,
                                             device=device)
        tables = dft.tables
        for dl in (data.train_dl, data.valid_dl, data.test_dl):
            if dl is not None:
                dl.ds.device_rows = dft.rows
        print(f"device store: {n_videos} videos resident", flush=True)
    if random_init:
        pred = Predictor(cfg, None, len(data.vocab), tables=tables, device=device, glove=glove, **on_axis)
    else:
        ckpt = Path(cfg.misc.tmp_path) / "models" / uid / f"{tag}.pt"
        pred = Predictor.from_checkpoint(cfg, ckpt, tables=tables, device=device, glove=glove, **on_axis)
    return pred, data


def _selftest(loop, data, n_requests: int, concurrency: int) -> Dict:
    """Concurrent clients over the valid split's requests; each request's
    latency from submit to its response."""
    from vog_tpu_torch.serving import batch_to_requests

    reqs: List[Dict] = []
    for batch in data.valid_dl:
        reqs.extend(batch_to_requests(batch))
        if len(reqs) >= min(n_requests, 256):
            break
    lat: List[float] = []
    lock = threading.Lock()

    def client(worker_idx: int):
        rng = np.random.default_rng(worker_idx)
        for _ in range(n_requests // concurrency):
            r = reqs[int(rng.integers(len(reqs)))]
            t0 = time.perf_counter()
            loop(r)  # submit + wait
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)

    loop(reqs[0])  # warm-up outside the timed window
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    arr = np.asarray(lat) * 1e3
    return {
        "metric": "serving_request_latency",
        "n_requests": len(lat),
        "concurrency": concurrency,
        "p50_ms": float(np.percentile(arr, 50)),
        "p95_ms": float(np.percentile(arr, 95)),
        "p99_ms": float(np.percentile(arr, 99)),
        "mean_ms": float(arr.mean()),
        "requests_per_sec": len(lat) / wall,
    }


def _http_server(loop, port: int, host: str = "0.0.0.0"):
    """The ``POST /predict`` server around ``loop`` (port 0: a free one)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 (stdlib API name)
            if self.path != "/predict":
                self.send_error(404)
                return
            try:
                body = self.rfile.read(int(self.headers["Content-Length"]))
                req = {k: np.asarray(v) for k, v in json.loads(body).items()}
                out = loop(req)
                # the full score grid stays on the server
                resp = json.dumps({k: np.asarray(v).tolist() for k, v in out.items() if k != "scores"}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(resp)))
                self.end_headers()
                self.wfile.write(resp)
            except Exception as e:  # the client gets the error
                self.send_error(400, str(e))

        def log_message(self, *a):  # no access log
            pass

    return ThreadingHTTPServer((host, port), Handler)


def _serve_http(loop, port: int) -> None:
    srv = _http_server(loop, port)
    print(f"serving on :{srv.server_address[1]} (POST /predict)", flush=True)
    srv.serve_forever()


def main(argv=None) -> Dict:
    uid, overrides, flags = parse_argv(sys.argv[1:] if argv is None else argv)
    tag = overrides.pop("tag", "last")
    port = int(overrides.pop("port", 0))
    selftest = int(overrides.pop("selftest", 0))
    concurrency = int(overrides.pop("concurrency", 8))
    max_batch = int(overrides.pop("serve.batch", 0))
    wait_ms = float(overrides.pop("serve.wait_ms", 2.0))
    pipeline_depth = int(overrides.pop("serve.pipeline", 2))
    buckets_raw = str(overrides.pop("serve.buckets", "true")).lower()
    if buckets_raw in ("true", "1", "yes", "on"):
        buckets = True
    elif buckets_raw in ("false", "0", "no", "off"):
        buckets = False
    else:
        raise SystemExit(f"--serve.buckets: unrecognized value {buckets_raw!r}")
    artifact = overrides.pop("artifact", None)
    cfg = build_cfg(overrides)

    from vog_tpu_torch.serving import ServingLoop, batch_to_requests

    if artifact:
        # the exported program at its one batch size, no model code; the
        # splits still load for --selftest's requests
        from vog_tpu_torch.export import ExportedPredictor

        pred = ExportedPredictor(artifact, device=device_of(cfg))
        data = get_data(cfg)
        if pred.manifest["with_tables"] and pred.rows:
            # requests carry vid_rows, from the artifact's own video -> row map
            for dl in (data.train_dl, data.valid_dl, data.test_dl):
                if dl is not None:
                    dl.ds.device_rows = pred.rows
        max_batch = pred.batch_size
        buckets = False  # a fixed-shape program
        print(f"serving exported artifact {artifact}", flush=True)
    else:
        pred, data = _build_predictor(cfg, uid, tag, "random_init" in flags)
        if pred.mesh is not None and pred.mesh.model_index != 0:  # a follower of rank 0's flushes
            out = {"followed": pred.follow()}
            print(json.dumps(out), flush=True)
            return out
    max_batch = max_batch or cfg.train.bs
    # powers of two below max_batch: light load pads to a small bucket
    # instead of the full batch (one CUDA graph a bucket)
    bucket_sizes = None
    if buckets:
        bucket_sizes, b = [], 1
        while b < max_batch:
            bucket_sizes.append(b)
            b *= 2
    loop = ServingLoop(pred, max_batch=max_batch, max_wait_ms=wait_ms, pipeline_depth=pipeline_depth,
                       bucket_sizes=bucket_sizes)
    if bucket_sizes:
        first = next(iter(data.valid_dl), None)
        if first is None:
            print("valid split is empty; skipping bucket prewarm", flush=True)
        else:
            t0 = time.perf_counter()
            loop.prewarm(batch_to_requests(first)[0])
            print(f"prewarmed buckets {loop.bucket_sizes} in {time.perf_counter() - t0:.1f}s", flush=True)
    try:
        if selftest:
            out = _selftest(loop, data, selftest, concurrency)
            print(json.dumps(out), flush=True)
            return out
        if port:
            _serve_http(loop, port)
        raise SystemExit("pass --selftest=N or --port=P")
    finally:
        loop.close()
        if getattr(pred, "mesh", None) is not None:
            pred.close()


if __name__ == "__main__":
    main()
