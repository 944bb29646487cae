"""Batch iterators and ``get_data`` (counterpart of vog_tpu/data/loader.py,
batch for batch).

Batches are static-shaped (drop_last on train; eval pads the final short
batch and carries a ``batch_mask``), so every step replays the same CUDA
graph.  The order of an epoch is a function of (seed, epoch), a sample's
generator of (seed, epoch, index), so a mid-epoch resume seeks to a batch
without building the ones before it.  A background thread builds the
batches (and runs ``transform`` on them, which the Learner uses to stack a
dispatch's group) while the card runs the previous dispatch; the queue is
bounded and the thread stops when the consumer leaves.  Data-parallel
input sharding (the JAX package's ``local_rows``, the DistributedSampler's
split): every rank builds the same epoch order and only its rows
[lo, hi) of each global batch, each sample's generator keyed on (seed,
epoch, index) as in the full batch, so the rows are bitwise the full
batch's; ``get_data(cfg, mesh)`` sizes the global batch as ``train.bs``
times the world, and the Learner sets each rank's rows.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from vog_tpu_torch.data.dataset import AnetSRLDataset, get_vocab
from vog_tpu_torch.data.featpack import open_store
from vog_tpu_torch.data.vocab import Vocab


def collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts -> dict of (B, …) arrays (reference
    ``BatchCollator``)."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchIterator:
    """Deterministic, epoch-seeded batch iterator over AnetSRLDataset."""

    def __init__(
        self,
        dataset: AnetSRLDataset,
        batch_size: int,
        shuffle: bool,
        drop_last: bool,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        # seekable iterator state: the next __iter__ starts at this batch
        # (mid-epoch resume skips consumed batches WITHOUT constructing
        # them — per-sample RNG is keyed on (seed, epoch, sample idx), not
        # on a sequential stream, so skipping preserves determinism)
        self.start_batch = 0
        # producer-side batch transform, applied IN the prefetch worker
        # thread (or inline when prefetch=0), so it overlaps the previous
        # dispatch on the card
        self.transform: Optional[Callable[[Dict], Dict]] = None
        # >1: yield GROUPS of `group` consecutive batches (the final group
        # of an epoch may be short).  The transform then receives the list
        # — the Learner stacks it here for the fused multi-step dispatch
        # (train.steps_per_dispatch).
        self.group: int = 1
        # data-parallel input sharding: (start, stop) builds only rows
        # [start, stop) of each global batch, the rank's (train/dist.py
        # §local_batch_rows); None = the full batch
        self.local_rows: Optional[tuple] = None

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def _index_batches(self, epoch: int) -> List[np.ndarray]:
        idxs = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 7_919 + epoch)
            rng.shuffle(idxs)
        nb = len(self)
        return [idxs[i * self.bs : (i + 1) * self.bs] for i in range(nb)]

    def _make_batch(self, batch_idxs: np.ndarray, epoch: int) -> Dict[str, np.ndarray]:
        def build(i: int) -> Dict:
            return self.ds.__getitem__(
                int(i), np.random.default_rng([self.seed, epoch, int(i)])
            )

        # global batch mask (final eval batch may be short of self.bs)
        bm = np.zeros((self.bs,), np.uint8)
        bm[: len(batch_idxs)] = 1
        lo, hi = self.local_rows if self.local_rows is not None else (0, self.bs)
        # keyed per sample, so rows [lo, hi) alone are bitwise the full batch's
        samples = [build(i) for i in batch_idxs[lo:hi]]
        n_pad = (hi - lo) - len(samples)
        if n_pad > 0:  # pad to the local static shape
            donor = samples[-1] if samples else build(batch_idxs[-1])
            samples = samples + [donor] * n_pad
        batch = collate(samples)
        batch["batch_mask"] = bm[lo:hi]
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self.epoch
        self.epoch += 1
        start = self.start_batch
        self.start_batch = 0
        batches = self._index_batches(epoch)[start:]
        tf = self.transform if self.transform is not None else (lambda b: b)
        if self.group > 1:
            g = self.group
            units = [batches[i : i + g] for i in range(0, len(batches), g)]
            make = lambda u: tf([self._make_batch(b, epoch) for b in u])
        else:
            units = batches
            make = lambda b: tf(self._make_batch(b, epoch))
        if self.prefetch <= 0:
            for u in units:
                yield make(u)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        SENTINEL = object()
        failure: List[BaseException] = []
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up once the consumer is gone, so an
            # early generator close can't strand the worker on q.put
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for u in units:
                    if stop.is_set() or not _put(make(u)):
                        return
            except BaseException as e:  # propagate to the consumer
                failure.append(e)
            finally:
                _put(SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    break
                yield item
        finally:
            # runs on normal exhaustion AND on early close (break /
            # GeneratorExit): signal the worker, drain anything queued,
            # and reap the thread
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=30.0)
        if failure:
            raise failure[0]


@dataclass
class DataWrap:
    """The three split iterators and the vocabulary (reference
    ``utils/trn_utils.py §DataWrap``)."""

    train_dl: BatchIterator
    valid_dl: BatchIterator
    test_dl: Optional[BatchIterator]
    vocab: Vocab


def get_data(cfg, mesh=None) -> DataWrap:
    """Build the three split iterators (reference ``get_data(cfg)``) over
    ``open_store``'s store.  ``mesh`` (train/dist.py): the global batch is
    ``train.bs`` times its data axis (``misc.mesh_data``)."""
    vocab = get_vocab(cfg)
    store = open_store(cfg.ds.data_dir)
    bs = cfg.train.bs * (mesh.data if mesh is not None else 1)

    def mk(split: str, shuffle: bool, drop_last: bool) -> BatchIterator:
        ds = AnetSRLDataset(cfg, split, vocab, store)
        return BatchIterator(ds, bs, shuffle=shuffle, drop_last=drop_last, seed=cfg.train.seed)

    return DataWrap(
        train_dl=mk("train", True, True),
        valid_dl=mk("valid", False, False),
        test_dl=mk("test", False, False),
        vocab=vocab,
    )
