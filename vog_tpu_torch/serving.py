"""Serving loop: request queue -> micro-batcher -> Predictor -> responses.

Counterpart of vog_tpu/serving.py around the port's ``Predictor``.
Clients submit single-query requests; a dispatcher thread coalesces up to
``max_batch`` of them (waiting at most ``max_wait_ms`` once the first is
queued), pads the tail by repeating a row, runs ONE Predictor call, and
resolves each request's Future with its row slice.  With
``bucket_sizes`` a flush of n requests pads to the smallest bucket >= n,
so light load pays small-batch compute instead of the full batch shape.

Pipelined mode: ``Predictor.dispatch`` returns as soon as the batch's
forward and output copies are enqueued on the card, and a completion
thread waits for each flush (``Predictor.fetch``) in dispatch order, so
flush N+1's host work and upload overlap flush N's compute.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

from vog_tpu_torch.serve import Predictor


class ServingLoop:
    """Micro-batching dispatcher around a ``Predictor``.

    Requests are dicts with the canonical batch keys WITHOUT the leading
    batch dim (one query each) — e.g. ``vid_rows (V,)`` in device-store
    mode, or ``props (V,F,P,D)`` full-feature.  Responses are the
    Predictor output slice for that row: pred_vid/pred_prop/pred_box/
    pred_score (+ the canonical score grid row).
    """

    def __init__(
        self,
        predictor: Predictor,
        max_batch: int,
        max_wait_ms: float = 2.0,
        queue_depth: int = 1024,
        pipeline_depth: int = 2,
        bucket_sizes: Optional[List[int]] = None,
    ):
        self.predictor = predictor
        self.max_batch = int(max_batch)
        # batch-size buckets: a flush of n requests pads to the smallest
        # bucket >= n instead of always to max_batch, so light load pays
        # bucket-sized compute.  None = a single shape (max_batch).
        if bucket_sizes:
            # fail fast: a fixed-shape predictor (ExportedPredictor, an
            # exported program at one batch size) cannot serve the smaller
            # buckets; without this its first sub-max flush would fail as
            # per-request Future exceptions instead of here
            fixed_bs = getattr(predictor, "batch_size", None)
            if fixed_bs is not None:
                raise ValueError(
                    "bucket_sizes is incompatible with a fixed-shape "
                    f"predictor (batch_size={fixed_bs}); pass "
                    "bucket_sizes=None"
                )
            bs = sorted({int(b) for b in bucket_sizes if 0 < int(b) <= self.max_batch})
            self.bucket_sizes = bs + ([] if bs and bs[-1] == self.max_batch else [self.max_batch])
        else:
            self.bucket_sizes = [self.max_batch]
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._closed = threading.Event()
        # pipelined mode: the dispatcher enqueues Predictor.dispatch
        # results and a completion thread waits for each one (fetch), so
        # flush N+1's dispatch overlaps flush N's compute and copy back.
        # Predictors without dispatch/fetch are called inline.
        self._pipelined = pipeline_depth > 1 and all(
            hasattr(predictor, a) for a in ("dispatch", "fetch")
        )
        self._completer: Optional[threading.Thread] = None
        if self._pipelined and hasattr(predictor, "ring_depth"):
            # up to pipeline_depth + 1 flushes are dispatched and not yet
            # fetched: one being fetched, pipeline_depth - 1 queued, one
            # dispatched and waiting to queue
            predictor.ring_depth = max(predictor.ring_depth, pipeline_depth + 1)
        if self._pipelined:
            self._pipe: "queue.Queue" = queue.Queue(maxsize=pipeline_depth - 1)
            self._completer = threading.Thread(target=self._complete, daemon=True)
            self._completer.start()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------------
    def submit(self, request: Dict[str, np.ndarray]) -> Future:
        """Enqueue one request; the Future resolves to its response dict."""
        if self._closed.is_set():
            raise RuntimeError("ServingLoop is closed")
        fut: Future = Future()
        self._q.put((request, fut))
        return fut

    def __call__(self, request: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Blocking convenience: submit + wait."""
        return self.submit(request).result()

    def prewarm(self, request: Dict[str, np.ndarray]) -> None:
        """Run one padded call per bucket up front, bypassing the queue, so
        the first client of a bucket pays no warm-up (kernel build, CUDA
        context, allocator growth, and a graphed Predictor's capture of the
        bucket's CUDA graph)."""
        for b in self.bucket_sizes:
            batch = {k: np.stack([request[k]] * b) for k in request}
            if "batch_mask" not in batch:
                batch["batch_mask"] = np.ones((b,), np.uint8)
            self.predictor(batch)

    def close(self) -> None:
        self._closed.set()
        self._worker.join(timeout=30.0)
        if self._completer is not None:
            self._pipe.put(None)  # sentinel after the last dispatched flush
            self._completer.join(timeout=30.0)
        # fail anything still queued
        try:
            while True:
                _, fut = self._q.get_nowait()
                fut.set_exception(RuntimeError("ServingLoop closed"))
        except queue.Empty:
            pass

    # -- dispatcher ---------------------------------------------------------
    def _collect(self) -> List:
        """Block for the first request, then drain up to max_batch within
        the wait budget (micro-batching window)."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        items = [first]
        deadline = _monotonic() + self.max_wait_s
        while len(items) < self.max_batch:
            remaining = deadline - _monotonic()
            if remaining <= 0:
                break
            try:
                items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _run(self) -> None:
        while not (self._closed.is_set() and self._q.empty()):
            items = self._collect()
            if not items:
                continue
            reqs = [r for r, _ in items]
            futs = [f for _, f in items]
            try:
                # pad the tail to the smallest bucket >= n by repeating
                # the last request (responses for pad rows are discarded)
                n = len(reqs)
                target = next(b for b in self.bucket_sizes if b >= n)
                padded = reqs + [reqs[-1]] * (target - n)
                batch = {
                    k: np.stack([r[k] for r in padded]) for k in padded[0]
                }
                if "batch_mask" not in batch:  # assemble_batch needs it
                    batch["batch_mask"] = np.ones((target,), np.uint8)
                if self._pipelined:
                    # async enqueue; the completion thread fetches + resolves
                    self._pipe.put((self.predictor.dispatch(batch), futs))
                else:
                    out = self.predictor(batch)
                    self._resolve(out, futs)
            except BaseException as e:  # resolve, never strand a client
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)

    def _complete(self) -> None:
        """Completion stage of the pipelined mode: blocking device->host
        fetch of each in-flight flush, in dispatch order."""
        while True:
            item = self._pipe.get()
            if item is None:
                return
            out_dev, futs = item
            try:
                self._resolve(self.predictor.fetch(out_dev), futs)
            except BaseException as e:
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)

    @staticmethod
    def _resolve(out: Dict[str, np.ndarray], futs: List[Future]) -> None:
        for i, fut in enumerate(futs):
            fut.set_result({k: v[i] for k, v in out.items()})


def _monotonic() -> float:
    import time

    return time.monotonic()


def batch_to_requests(batch: Dict[str, np.ndarray]) -> List[Dict]:
    """Split a canonical loader batch into per-query serving requests
    (drops loader-only fields the Predictor doesn't consume)."""
    skip = {"batch_mask", "ann_idx"}
    n = len(next(iter(batch.values())))
    return [
        {k: np.asarray(v[i]) for k, v in batch.items() if k not in skip}
        for i in range(n)
    ]
