"""CUDA graphs: the port's counterpart of one compiled dispatch.

``vog_tpu`` runs K train steps (``lax.scan`` under ``jax.jit``) as one
program a dispatch; in PyTorch the counterpart is a CUDA graph.  Here one
train step (or eval step, or serving forward) is captured once for each
batch shape, and a dispatch of K steps is

  * one host-to-device copy of the stacked batch, from a persistent pinned
    buffer into the graph's static input (``StaticBatch``: every field of
    a step in one byte row, K rows);
  * K replays of the one-step graph, each reading the row that a device
    counter (``slot``) points at and advancing it.

Why one step replayed K times and not K steps captured in one graph: the
capture costs one step's time and pool memory, not K; an epoch's shorter
tail group replays the same graph fewer times (no capture for its
length); and a replay costs the host a few microseconds, so the K
launches stay far below the step's device time.  The outputs of step i
land in row i of persistent output buffers, so the host reads the
stacked aux once a dispatch and waits nowhere else.

What capture needs, and how it is met:

  * the state lives in fixed tensors, written in place (train/state.py),
    and dropout's mask is a pure function of the step tensor
    (model/transformer.py), so a replay advances the state as an eager
    step does;
  * a warm-up step on the capture's stream before the capture builds the
    kernels, sets their attributes, creates the head backward's second
    stream and its events (``csrc/grounding_head.cu §side_stream``) and
    the cuBLAS / cuDNN handles; the warm-up's state changes are undone
    from a snapshot.  Under capture the head backward forks onto its
    second stream and joins back by ``cudaEventRecord`` /
    ``cudaStreamWaitEvent``, which capture turns into graph edges;
  * the kernel wrappers launch on the current stream
    (``kernels/_build.py §stream_ptr``), which is the capture stream;
  * no host read, host copy or fresh pinned buffer inside the step; the
    allocations of the captured step go to the graph's private pool.

A capture records the kernels' variant ("highest" or "default",
``config.kernel_precision``) and cuBLAS's TF32 switch in force at capture
time, so every cache key holds ``numerics_key`` (the precision and the
model's activation dtype): a process that changes ``misc.matmul_precision``
captures anew rather than replay the old numerics.

A step with collectives (the mesh's data and model axes, train/dist.py)
captures them too: NCCL's kernels join the graph like any other, after
the warm-up step has created each group's communicator (the data group's,
the model group's, the ring's P2P pairs); such a capture runs in
"thread_local" mode, so the process groups' watchdog thread may query
their events meanwhile.

A capture or replay that fails raises; nothing falls back to an eager
loop.  Launch counts: the capture's launches do not run, so they are
taken back from ``_build.launches`` and added again at every replay.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vog_tpu_torch.config.defaults import kernel_precision
from vog_tpu_torch.kernels import _build

ALIGN = 16  # bytes: every field of a row starts at a 16-byte boundary
Spec = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def step_spec(stacked: Dict[str, Any]) -> Spec:
    """Per-step shapes and dtypes of a stacked (K, ...) batch."""
    out = {}
    for k, v in stacked.items():
        t = _as_tensor(v)
        out[k] = (tuple(t.shape[1:]), t.dtype)
    return out


def _spec_key(spec: Spec) -> tuple:
    return tuple((k, s, str(d)) for k, (s, d) in spec.items())


def numerics_key(model) -> tuple:
    """What a capture fixes of the numerics: the kernels' precision (with
    it cuBLAS's and cuDNN's TF32 switches) and the model's activation
    dtype."""
    return (kernel_precision(), str(model.dt))


def tables_key(tables: Optional[Dict[str, torch.Tensor]]) -> tuple:
    """The captured addresses of the tables: new tables need a new graph."""
    if tables is None:
        return ()
    return tuple((k, v.data_ptr(), tuple(v.shape), str(v.dtype)) for k, v in sorted(tables.items()))


class StaticBatch:
    """A graph's static input: ``capacity`` rows of one step's fields, as
    bytes on the device, with ``ring`` pinned host copies to stage into.
    ``load`` writes a stacked host batch's first n steps into a pinned copy
    (host memcpy) and moves them with ONE host-to-device copy;
    ``fields(row)`` views a row as the step's typed tensors."""

    def __init__(self, spec: Spec, capacity: int, device: torch.device, ring: int = 2):
        self.spec, self.capacity = spec, int(capacity)
        self.layout = {}
        off = 0
        for k, (shape, dtype) in spec.items():
            nb = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            self.layout[k] = (off, nb, shape, dtype)
            off += -(-nb // ALIGN) * ALIGN
        self.row_bytes = max(off, ALIGN)
        self.dev = torch.zeros((self.capacity, self.row_bytes), dtype=torch.uint8, device=device)
        self.pinned = [torch.zeros((self.capacity, self.row_bytes), dtype=torch.uint8).pin_memory()
                       for _ in range(ring)]
        self.events = [None] * ring
        self._next = 0

    @property
    def nbytes(self) -> int:
        return self.capacity * self.row_bytes

    def fields(self, row: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: row[o:o + nb].view(dtype).view(shape) for k, (o, nb, shape, dtype) in self.layout.items()}

    def _check(self, k: str, t: torch.Tensor, n: int) -> None:
        shape, dtype = self.spec[k]
        if t.dtype != dtype or tuple(t.shape[1:]) != shape or t.shape[0] < n:
            raise ValueError(f"static input {k}: got {t.dtype} {tuple(t.shape)}, the graph was captured "
                             f"for {dtype} (n, {', '.join(map(str, shape))})")

    def load(self, stacked: Dict[str, Any], n: int, slot: Optional[int] = None) -> None:
        """Rows [0, n) from ``stacked``; ``slot`` picks the pinned copy (else
        the next in turn, after its last copy has left)."""
        if set(stacked) != set(self.spec):
            raise ValueError(f"static input keys {sorted(stacked)} != captured {sorted(self.spec)}")
        if not 1 <= n <= self.capacity:
            raise ValueError(f"{n} steps do not fit the static input's {self.capacity} rows")
        ts = {k: _as_tensor(v) for k, v in stacked.items()}
        if slot is None:
            slot, self._next = self._next, (self._next + 1) % len(self.pinned)
        if self.events[slot] is not None:
            self.events[slot].synchronize()  # its last copy to the device has left
        pin = self.pinned[slot].numpy()
        for k, t in ts.items():
            self._check(k, t, n)
            o, nb = self.layout[k][:2]
            pin[:n, o:o + nb] = t[:n].contiguous().numpy().view(np.uint8).reshape(n, nb)
        self.dev[:n].copy_(self.pinned[slot][:n], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.dev.device))
        self.events[slot] = ev


def _warm_up(capture: "torch.cuda.graph", fn: Callable[[], Any]) -> Any:
    """``fn`` once, outside the capture, on the stream that ``capture``
    will capture on (torch.cuda.graphs asks for a side stream; this one's
    cuBLAS workspace is then made once, not at every capture), joined back
    to the current stream."""
    cur = torch.cuda.current_stream()
    side = capture.capture_stream
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


class _Captured:
    """A one-step graph over a ``StaticBatch`` of ``capacity`` rows and a
    device row counter; ``body(fields) -> {name: tensor}`` is the step,
    whose outputs land in row ``slot`` of persistent (capacity, ...)
    buffers."""

    def __init__(self, device: torch.device, stacked: Dict[str, Any], capacity: int,
                 body: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
                 before_warm_up: Callable[[], Any] = None, after_warm_up: Callable[[Any], None] = None,
                 reset: Callable[[], None] = None, capture_error_mode: str = "global"):
        self.device, self.capacity, self.reset = device, int(capacity), reset
        self.static = StaticBatch(step_spec(stacked), capacity, device)
        self.slot = torch.zeros((), dtype=torch.int64, device=device)
        self.static.load(stacked, 1)  # row 0: a real batch for the warm-up
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph, capture_error_mode=capture_error_mode)
        saved = before_warm_up() if before_warm_up else None
        outs = _warm_up(capture, lambda: body(self._fields()))
        if after_warm_up:
            after_warm_up(saved)
        self.out = {k: torch.zeros((self.capacity,) + tuple(v.shape), dtype=v.dtype, device=device)
                    for k, v in outs.items()}
        del outs, saved
        torch.cuda.synchronize(device)
        before = dict(_build.launches)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        with capture:
            outs = body(self._fields())
            for k, v in outs.items():
                self.out[k].index_copy_(0, self.slot.view(1), v.reshape((1,) + tuple(v.shape)))
            self.slot.add_(1)
        # the step's own allocations at their peak, in the graph's pool
        self.peak_bytes = torch.cuda.max_memory_allocated(device) - base
        self.launches = _build.take_counts_since(before)

    def _fields(self) -> Dict[str, torch.Tensor]:
        return self.static.fields(self.static.dev.index_select(0, self.slot.view(1))[0])

    def __call__(self, stacked: Dict[str, Any], n: int) -> Dict[str, torch.Tensor]:
        """Steps [0, n) of ``stacked``: one copy in, n replays; -> the
        outputs with a leading n axis (fresh tensors)."""
        self.static.load(stacked, n)
        self.slot.zero_()
        if self.reset:
            self.reset()
        for _ in range(n):
            self.graph.replay()
        _build.add_counts(self.launches, n)
        return {k: v[:n].clone() for k, v in self.out.items()}


def train_graph(step: Callable, freeze: bool, state, stacked: Dict[str, Any], seed: int,
                tables: Optional[Dict[str, torch.Tensor]], collectives: bool = False) -> _Captured:
    """The captured train step of (``step``, batch shapes, seed, tables,
    ``numerics_key``) on ``state``, captured at first use (cached in ``state.graphs``; a longer
    dispatch than the cached capacity captures anew).  With ``freeze`` a
    device flag carries the poison from replay to replay, cleared at each
    dispatch.  ``collectives``: the step holds a process group's (captured
    in "thread_local" mode)."""
    n = len(next(iter(stacked.values())))
    key = ("train", id(step), freeze, _spec_key(step_spec(stacked)), int(seed), tables_key(tables),
           numerics_key(state.model))
    g = state.graphs.get(key)
    if g is not None and g.capacity >= n:
        return g
    state.graphs.pop(key, None)
    dev = state.step.device
    frozen = torch.zeros((), dtype=torch.bool, device=dev) if freeze else None

    def body(batch):
        aux, poisoned = step(state, batch, seed, tables, frozen)
        if frozen is not None:
            frozen.copy_(poisoned)
        return aux

    g = _Captured(dev, stacked, n, body, before_warm_up=state.snapshot, after_warm_up=state.restore,
                  reset=frozen.zero_ if freeze else None,
                  capture_error_mode="thread_local" if collectives else "global")
    g.step = step  # keeps id(step) unique while the graph is cached
    state.graphs[key] = g
    return g


def eval_graph(step: Callable, state, stacked: Dict[str, Any],
               tables: Optional[Dict[str, torch.Tensor]], collectives: bool = False) -> _Captured:
    """The captured eval step (cached as ``train_graph``); the state is
    only read."""
    n = len(next(iter(stacked.values())))
    key = ("eval", id(step), _spec_key(step_spec(stacked)), tables_key(tables), numerics_key(state.model))
    g = state.graphs.get(key)
    if g is not None and g.capacity >= n:
        return g
    state.graphs.pop(key, None)
    g = _Captured(state.step.device, stacked, n, lambda batch: step(state, batch, tables),
                  capture_error_mode="thread_local" if collectives else "global")
    g.step = step
    state.graphs[key] = g
    return g


class ServeGraph:
    """The serving forward captured for one bucket shape: a one-row
    ``StaticBatch`` with ``ring`` pinned staging copies, and ``ring``
    pinned host copies of the outputs.  Ring slot r is taken by
    ``dispatch`` and given back by ``release`` (after the host has copied
    it out), so flush N + ring never overwrites flush N before its fetch."""

    def __init__(self, forward: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
                 batch: Dict[str, Any], device: torch.device, ring: int):
        self.ring = int(ring)
        stacked = {k: _as_tensor(v)[None] for k, v in batch.items()}
        self.static = StaticBatch(step_spec(stacked), 1, device, ring=self.ring)
        self.static.load(stacked, 1, slot=0)
        fields = self.static.fields(self.static.dev[0])
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the serving loop's completion thread may wait on an
        # event while a new bucket is captured
        capture = torch.cuda.graph(self.graph, capture_error_mode="thread_local")
        with torch.inference_mode():
            _warm_up(capture, lambda: forward(fields))
        torch.cuda.synchronize(device)
        before = dict(_build.launches)
        with capture:
            with torch.inference_mode():
                self.out = forward(fields)
        self.launches = _build.take_counts_since(before)
        self.host = [{k: torch.empty(v.shape, dtype=v.dtype).pin_memory() for k, v in self.out.items()}
                     for _ in range(self.ring)]
        self._busy = [False] * self.ring
        self._cv = threading.Condition()
        self._next = 0

    def dispatch(self, batch: Dict[str, Any]):
        """Copy ``batch`` in, replay, queue the copies out -> (ring slot,
        host outputs, event)."""
        r, self._next = self._next, (self._next + 1) % self.ring
        with self._cv:
            while self._busy[r]:
                self._cv.wait()
            self._busy[r] = True
        try:
            self.static.load({k: _as_tensor(v)[None] for k, v in batch.items()}, 1, slot=r)
            self.graph.replay()
            for k, v in self.out.items():
                self.host[r][k].copy_(v, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.static.dev.device))
        except BaseException:
            self.release(r)
            raise
        _build.add_counts(self.launches, 1)
        return r, self.host[r], ev

    def release(self, r: int) -> None:
        with self._cv:
            self._busy[r] = False
            self._cv.notify_all()
