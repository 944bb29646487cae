"""Learner: the trainer runtime (counterpart of vog_tpu/train/learner.py,
one card a process, data-parallel across processes).

Reference parity: ``utils/trn_utils.py §Learner``: epochs of train and
validate, the smoothed loss, txt and json-lines logs under
``tmp/{txt_logs,models,predictions,ext_logs}/{uid}…``, best and last
checkpoints, resume, and predictions pickles scored by the evaluator.

Setup, as the JAX Learner: the model from ``get_model`` with the
vocabulary's GloVe table; the feature tables on the device from the
dataset's store (``ds.device_store``; "auto" from the card's free memory,
``data/device_store.py §use_device_store``) and, with them, the
annotation tables (``ds.ann_store``), every split's dataset then emitting
index-only samples; ``train.total_steps`` derived for the cosine; K train
steps and E eval batches a dispatch (``dispatch_sizes``), each dispatch one
``make_multi_train_step`` / ``make_multi_eval_step`` call (CUDA graph
replays on the card).  The loader's thread stacks a dispatch's K batches
while the card runs the previous dispatch.

Each dispatch's aux (K losses, grad norms, the guard's count) is read once
on the host, and before anything else happens: a guard past
``train.skip_nonfinite`` raises ``FloatingPointError`` at that dispatch,
before any save (the JAX Learner checks at log points only, after the
periodic save), and so does a non-finite loss without the guard when
``misc.check_nans``.  Then a SIGTERM (flagged by the handler) saves "last"
and returns; then the periodic save; then logging.

Checkpoints are one torch file a tag (``models/{uid}/{tag}.pt``): the
parameters, Adam's flat moments, the guard counters and the int32 step
(``TrainState.tensors``), with epoch, ``batch_in_epoch``, ``best_metric``
and seed.  ``save`` copies the state to host buffers (pinned on the card;
the copy is queued on the stream that the next dispatch runs on, so it
lands before that dispatch writes the state in place), and one writer
thread (``CheckpointWriter``) writes the file, serialised: a temporary
file, fsync'd, renamed into place, so a reader never sees a torn file,
and the meta inside the file never pairs with another save's tensors.
With ``train.async_ckpt`` the periodic and the epoch's saves return once
the copy is queued (the JAX Learner blocks on its epoch saves); the
SIGTERM save blocks.  A write that failed raises at the next ``save`` or
``wait_for_checkpoints``, which ``load`` and the end of ``fit`` call.
``train.resume`` loads "last" (or ``resume_path``) and ``fit`` continues
mid-epoch from ``batch_in_epoch``, bitwise the uninterrupted run.

``misc.checkify`` runs each train step eagerly under the checks of
``train/checkify.py`` (a NaN from any op, an integer division by zero),
one step a dispatch, no graph; the step raises ``CheckifyError`` naming
the first failing op and its module.  ``misc.profile_dir``: a
``torch.profiler`` trace (CPU, and CUDA on the card) from the second
dispatch of each epoch (the first captures the graphs) until
``misc.profile_steps`` steps are covered, each dispatch annotated, written
as a Chrome trace ``{profile_dir}/{uid}.ep{epoch}.trace.json``.
``misc.tensorboard_dir``: the JAX Learner's scalars (``train/loss``,
``train/loss_smooth`` at each log point, ``valid/<metric>`` a validation)
at its step numbers, through ``torch.utils.tensorboard`` into
``{tensorboard_dir}/{uid}``; without the ``tensorboard`` package the
mirror logs that it is off and training goes on.

Besides the JAX Learner's txt and json-lines logs, ``ext_logs/{uid}.events.jsonl``
gets one record a log point (the dispatch's losses), an epoch (wall time,
the host's time blocked on the loader and in the dispatches, samples/s,
the learning rate at its end, kernel launches), an eval (batches, seconds, kernel launches),
a table build, a save (when its file lands: bytes, the seconds the loop
was blocked by its copy and the writer's seconds) and a profiler trace.

Data parallelism (``mesh``, train/dist.py; ``misc.multihost`` under
torchrun): every rank runs the same Learner on its data index's rows of
each global batch of ``train.bs`` x ``data`` (``get_data(cfg, mesh)`` sizes it, the
Learner sets the loaders' ``local_rows``); the steps reduce the loss's counts and the
gradient over the ranks (train/state.py), so the ranks' states stay
bitwise equal; ``ds.device_store`` may row-shard the feature tables
("shard", or "auto" when only a rank's share fits).  Only rank 0 logs,
writes the events, TensorBoard, profiles, checkpoints and predictions (the
JAX Learner's ``_is_main``); the eval sums and predictions go through
``gather_eval``; every rank waits at a barrier before a load (rank 0's
writes landed first); a SIGTERM on any rank stops every rank after the
same dispatch (one all-reduce of the flag a dispatch).

The model axis (``misc.mesh_model`` = m > 1): the model is built with
the mesh (``get_model(..., mesh=)``): tensor parallelism, and the
sequence-parallel ring under ``mdl.sp_attention``, as the JAX Learner
applies ``param_shardings`` and installs the ring.  A save gathers the
sharded parameters and moments over the model group of data index 0
(``TrainState.whole_tensors``), so the file is the one a single process
writes; a load reads the whole file on every rank and keeps the rank's
part (``TrainState.local_tensors``).  The eval gather runs over the data
group.
A ``vog_tpu`` orbax checkpoint loads after ``tools/orbax_to_torch_port.py``.
"""

from __future__ import annotations

import json
import os
import pickle
import signal
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from vog_tpu_torch.config import apply_matmul_precision
from vog_tpu_torch.data.ann_store import AnnTables, ann_table_bytes
from vog_tpu_torch.data.device_store import DeviceFeatureTables, device_store_mode
from vog_tpu_torch.data.loader import DataWrap, collate
from vog_tpu_torch.device import DeviceLike, resolve_device
from vog_tpu_torch.evaluation import finalize_metrics
from vog_tpu_torch.kernels import _build
from vog_tpu_torch.model.grounding import get_model
from vog_tpu_torch.train.checkify import make_checked_train_step
from vog_tpu_torch.train.dist import Mesh, local_batch_rows, make_mesh
from vog_tpu_torch.train.multihost import gather_eval
from vog_tpu_torch.train.progress import ProgressBar, progress_enabled
from vog_tpu_torch.train.state import (
    TrainState,
    dispatch_sizes,
    make_multi_eval_step,
    make_multi_train_step,
)


class SmoothenValue:
    """EMA loss smoothing — reference ``utils/trn_utils.py §SmoothenValue``."""

    def __init__(self, beta: float = 0.9):
        self.beta = beta
        self.n = 0
        self.mov_avg = 0.0
        self.smooth = 0.0

    def add_value(self, val: float) -> None:
        self.n += 1
        self.mov_avg = self.beta * self.mov_avg + (1 - self.beta) * val
        self.smooth = self.mov_avg / (1 - self.beta**self.n)


def _launched_since(before: Dict[str, int]) -> Dict[str, int]:
    """Kernel launches counted since the snapshot ``before`` of
    ``_build.launches``."""
    return {k: v - before.get(k, 0) for k, v in _build.launches.items() if v > before.get(k, 0)}


class CheckpointWriter:
    """Checkpoint files written by one thread, in the order saved.

    ``submit`` copies the tensors into a set of host buffers (pinned when
    they lie on the card, the copy queued on the current stream, which the
    dispatches that write the state run on after it) and returns; the
    thread waits for the copy, then writes, fsyncs and renames the file.
    At most ``RING`` buffer sets exist; a save that finds none free waits
    for the oldest write.  A failed write is raised by the next ``submit``
    or ``wait``, once."""

    RING = 2

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: List[Future] = []
        self._free: List[Dict[str, torch.Tensor]] = []
        self._sets = 0
        self._lock = threading.Lock()

    def _raise_done(self) -> None:
        """Drop the finished writes; raise the first that failed."""
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()

    def _buffers(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        while True:
            with self._lock:
                if self._free:
                    return self._free.pop()
                if self._sets < self.RING:
                    self._sets += 1
                    pin = any(v.is_cuda for v in tensors.values())
                    return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin) for k, v in tensors.items()}
            self._pending.pop(0).result()  # the oldest write gives its set back

    def submit(self, path: Path, tensors: Dict[str, torch.Tensor], meta: Dict, done) -> None:
        """Queue ``{"state": tensors, "meta": meta}`` for ``path``; ``done(bytes,
        copy_s, write_s)`` runs on the writer thread once the file has its
        name (``copy_s``: the seconds this call blocked)."""
        t0 = time.perf_counter()
        self._raise_done()
        host = self._buffers(tensors)
        event = None
        for k, v in tensors.items():
            host[k].copy_(v.detach(), non_blocking=v.is_cuda)
            if v.is_cuda and event is None:
                event = torch.cuda.Event()
        if event is not None:
            event.record(torch.cuda.current_stream(next(v.device for v in tensors.values() if v.is_cuda)))
        copy_s = time.perf_counter() - t0

        def write() -> None:
            try:
                t1 = time.perf_counter()
                if event is not None:
                    event.synchronize()
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                with open(tmp, "wb") as f:
                    torch.save({"state": host, "meta": meta}, f)
                    f.flush()
                    os.fsync(f.fileno())  # durable before it takes the name
                os.replace(tmp, path)
                done(path.stat().st_size, copy_s, time.perf_counter() - t1)
            finally:
                with self._lock:
                    self._free.append(host)

        self._pending.append(self._pool.submit(write))

    def wait(self) -> None:
        """Block until every queued write has landed; raise the first
        failure among them."""
        pending, self._pending = self._pending, []
        errors = []
        for f in pending:
            try:
                f.result()
            except Exception as e:  # every write is waited for before the first failure is raised
                errors.append(e)
        if errors:
            raise errors[0]


class Learner:
    SUM_KEYS = ("n_pairs", "n_acc", "n_vacc", "n_queries", "n_strict", "n_cons")

    def __init__(self, uid: str, data: DataWrap, cfg, device: DeviceLike = None, mesh: Optional[Mesh] = None):
        self.uid, self.data, self.cfg = uid, data, cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(cfg)
        self.main = self.mesh.rank == 0  # rank 0 alone writes files
        tmp = Path(cfg.misc.tmp_path)
        self.dirs = {k: tmp / k for k in ("models", "txt_logs", "predictions", "ext_logs")}
        for d in self.dirs.values():
            d.mkdir(parents=True, exist_ok=True)
        self.log_file = self.dirs["txt_logs"] / f"{uid}.txt"
        self.json_log = self.dirs["ext_logs"] / f"{uid}.jsonl"
        self.events_log = self.dirs["ext_logs"] / f"{uid}.events.jsonl"
        self.ckpt_dir = (self.dirs["models"] / uid).absolute()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.seed = int(cfg.train.seed)
        self.bs = int(cfg.train.bs)
        self.global_bs = self.bs * self.mesh.data
        if data.train_dl.bs != self.global_bs:
            raise ValueError(f"the loaders build batches of {data.train_dl.bs} rows, the world's global batch is "
                             f"{self.global_bs} (train.bs x {self.mesh.data}): build them with get_data(cfg, mesh)")
        if self.mesh.data > 1:
            rows = local_batch_rows(self.mesh, self.global_bs)
            for dl in (data.train_dl, data.valid_dl, data.test_dl):
                if dl is not None:
                    dl.local_rows = rows
        self._preempted = False
        self._writer = CheckpointWriter()
        self._events_lock = threading.Lock()  # the writer thread records its saves too
        self._tb_writer = None if cfg.misc.tensorboard_dir else False  # False: off; None: not opened yet
        self.best_metric = -float("inf")
        self.epoch = 0
        self.batch_in_epoch = 0

        # the cosine needs the true horizon: total_steps 0 means derive it
        if cfg.train.lr_schedule == "cosine" and cfg.train.total_steps == 0:
            cfg.train.total_steps = cfg.train.epochs * len(data.train_dl)

        # device-resident feature tables, then the annotation tables: the
        # batches shrink to vid_rows, then to four int32 fields a sample
        self._tables: Optional[Dict[str, torch.Tensor]] = None
        splits = {s: dl.ds for s, dl in (("train", data.train_dl), ("valid", data.valid_dl),
                                         ("test", data.test_dl)) if dl is not None}
        store = data.train_dl.ds.store
        n_videos = len(store.videos())
        want_ann = cfg.ds.ann_store != "off"
        ann_bytes = ann_table_bytes(cfg, sum(len(d) for d in splits.values()), n_videos) if want_ann else 0
        mode = device_store_mode(cfg, n_videos, self.device, ann_bytes, self.mesh)
        self.shard_store = mode == "shard"
        if mode != "off":
            t0 = time.perf_counter()
            dft = DeviceFeatureTables.from_store(cfg, store, half=cfg.misc.half_feats, int8=cfg.misc.int8_feats,
                                                 device=self.device,
                                                 shard=(self.mesh.data_index, self.mesh.data) if self.shard_store
                                                 else None)
            self._sync()
            nb = sum(v.nbytes for v in dft.tables.values())
            dt = time.perf_counter() - t0
            self._tables = dict(dft.tables)
            for d in splits.values():
                d.device_rows = dft.rows
            how = f"row-sharded /{self.mesh.data}: {dft.n_rows} rows a rank, " if self.shard_store else ""
            self.log(f"device feature store: {n_videos} videos resident ({how}{nb / 1e6:.0f} MB, {dft.dtype}) "
                     f"built in {dt:.2f} s")
            self.event("tables", table="features", videos=n_videos, bytes=nb, seconds=dt, sharded=self.shard_store)
            if want_ann:
                t0 = time.perf_counter()
                ann = AnnTables.from_datasets(cfg, splits, dft.rows, device=self.device)
                self._sync()
                nb, dt = sum(v.nbytes for v in ann.tables.values()), time.perf_counter() - t0
                self._tables.update(ann.tables)
                for s, d in splits.items():
                    d.index_only = True
                    d.ann_row_offset = ann.split_offset[s]
                self.log(f"device annotation store: {ann.n_anns} anns resident ({nb / 1e6:.1f} MB) built in "
                         f"{dt:.2f} s — index-only input path")
                self.event("tables", table="annotations", anns=ann.n_anns, bytes=nb, seconds=dt)
        else:
            self.log(f"device feature store off (ds.device_store={cfg.ds.device_store}): features travel "
                     "with each batch")
            if cfg.ds.ann_store == "on":
                self.log("ds.ann_store=on ignored: requires an active ds.device_store")

        apply_matmul_precision(cfg)
        self.model = get_model(cfg, len(data.vocab), device=self.device, seed=self.seed, train=True,
                               glove=data.vocab.vectors, mesh=self.mesh)
        self.state = TrainState.create(cfg, self.model)

        self.K, self.E = dispatch_sizes(cfg)
        if cfg.misc.checkify:
            # the checks read the host once a step, and a graph cannot
            # check its ops: one eager step a dispatch, as the JAX Learner
            if self.K > 1:
                self.log("train.steps_per_dispatch disabled: incompatible with misc.checkify (per-step error "
                         "sync) — using single-step dispatch")
            self.K = 1
            self._train_multi = make_checked_train_step(cfg, self.mesh, self.shard_store)
        else:
            self._train_multi = make_multi_train_step(cfg, self.mesh, self.shard_store)
        self._eval_multi = make_multi_eval_step(cfg, self.mesh, self.shard_store)
        # the loader's thread groups K batches and stacks them into one
        # (K, B, ...) batch (K=1: one batch, ungrouped), while the card
        # runs the previous dispatch
        data.train_dl.group = self.K
        data.train_dl.transform = lambda b: collate(b if isinstance(b, list) else [b])

        if cfg.train.resume:
            self.load(cfg.train.resume_path or None)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- logging --------------------------------------------------------------
    def log(self, msg: str) -> None:
        if not self.main:
            return
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        with open(self.log_file, "a") as f:
            f.write(line + "\n")

    def log_json(self, record: Dict) -> None:
        if not self.main:
            return
        with open(self.json_log, "a") as f:
            f.write(json.dumps(record) + "\n")

    def event(self, kind: str, **fields) -> None:
        """One record of the Learner's own readings (events.jsonl)."""
        if not self.main:
            return
        line = json.dumps({"event": kind, "epoch": self.epoch, **fields}) + "\n"
        with self._events_lock, open(self.events_log, "a") as f:
            f.write(line)

    def _tb_scalars(self, scalars: Dict, step: int) -> None:
        """The TensorBoard mirror (``misc.tensorboard_dir``): each int or
        float of ``scalars`` at ``step``, flushed."""
        if not self.main:
            return
        if self._tb_writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self.log("misc.tensorboard_dir set but tensorboard missing — off")
                self._tb_writer = False
            else:
                self._tb_writer = SummaryWriter(str(Path(self.cfg.misc.tensorboard_dir) / self.uid))
        if self._tb_writer is False:
            return
        for k, v in scalars.items():
            if isinstance(v, (int, float)):
                self._tb_writer.add_scalar(k, v, step)
        self._tb_writer.flush()

    # -- checkpointing --------------------------------------------------------
    def ckpt_path(self, tag: str) -> Path:
        return self.ckpt_dir / f"{tag}.pt"

    def save(self, tag: str = "last", blocking: bool = True) -> Path:
        """Write ``models/{uid}/{tag}.pt``: the state's tensors and the meta
        (``CheckpointWriter``).  ``blocking``: return once the file has its
        name; else once the host copy is queued.  A record "save" follows
        when the file lands.  Rank 0 alone writes, the whole model's
        tensors: on the model axis the ranks of data index 0 gather them
        first."""
        path = self.ckpt_path(tag)
        if self.mesh.data_index != 0:
            return path
        tensors = self.state.whole_tensors()
        if not self.main:
            return path
        meta = {"epoch": self.epoch, "batch_in_epoch": self.batch_in_epoch, "best_metric": self.best_metric,
                "seed": self.seed, "uid": self.uid}

        def done(nbytes: int, copy_s: float, write_s: float) -> None:
            self.event("save", epoch=meta["epoch"], tag=tag, bytes=nbytes, blocking=blocking, copy_s=copy_s,
                       write_s=write_s, seconds=copy_s + write_s, batch_in_epoch=meta["batch_in_epoch"])

        self._writer.submit(path, tensors, meta, done)
        if blocking:
            self._writer.wait()
        return path

    def wait_for_checkpoints(self) -> None:
        """Block until every queued save has landed (raising a write's
        failure); ``load`` and the end of ``fit`` call it."""
        self._writer.wait()

    def load(self, path: Optional[str] = None, tag: str = "last") -> None:
        """Restore a checkpoint of this port (``path``, else ``tag`` of
        this uid) into the state, in place (captured graphs stay valid);
        a tensor missing or of another shape raises.  A file of parameters
        and step alone (``tools/orbax_to_torch_port.py``'s fallback)
        restores those and keeps the optimizer's fresh state, as the JAX
        Learner's fallback does, and logs it.  Every rank waits at a barrier
        until rank 0's writes have landed, then reads the file."""
        self.wait_for_checkpoints()
        self.mesh.barrier()
        ckpt = Path(path).absolute() if path else self.ckpt_path(tag)
        payload = torch.load(ckpt, map_location="cpu", weights_only=True)
        saved, cur = self.state.local_tensors(payload["state"]), self.state.tensors()
        if set(saved) == {k for k in cur if not k.startswith("opt:")}:
            cur = {k: v for k, v in cur.items() if k in saved}
            self.log(f"checkpoint {ckpt} holds parameters and step only: the optimizer's moments and "
                     "counters start fresh")
        if set(saved) != set(cur):
            raise ValueError(f"checkpoint {ckpt} holds other tensors: missing "
                             f"{sorted(set(cur) - set(saved))[:5]}, extra {sorted(set(saved) - set(cur))[:5]}")
        with torch.no_grad():
            for k, v in cur.items():
                if v.shape != saved[k].shape or v.dtype != saved[k].dtype:
                    raise ValueError(f"checkpoint {ckpt}: {k} is {saved[k].dtype} {tuple(saved[k].shape)}, "
                                     f"the model's {v.dtype} {tuple(v.shape)}")
                v.copy_(saved[k])
        meta = payload["meta"]
        self.epoch = int(meta["epoch"])
        self.batch_in_epoch = int(meta["batch_in_epoch"])
        self.best_metric = float(meta["best_metric"])
        self.log(f"resumed from {ckpt} at step {int(self.state.step)} (epoch {self.epoch}, "
                 f"batch {self.batch_in_epoch})")

    # -- preemption -----------------------------------------------------------
    def _install_preempt(self):
        """Trap SIGTERM to set a flag that ``fit`` reads after every
        dispatch (then a blocking save of "last" and a return).  -> the
        previous handler, or None when off or off the main thread."""
        if not self.cfg.train.save_on_preempt or threading.current_thread() is not threading.main_thread():
            return None
        self._preempted = False

        def handler(signum, frame):
            self._preempted = True

        return {signal.SIGTERM: signal.signal(signal.SIGTERM, handler)}

    def _preempted_anywhere(self) -> bool:
        """This rank's SIGTERM flag, or'ed over the ranks (each dispatch), so
        every rank leaves ``fit`` after the same dispatch."""
        if self.mesh.group is None:
            return self._preempted
        flag = torch.tensor([int(self._preempted)], dtype=torch.int32, device=self.device)
        return bool(self.mesh.all_reduce_(flag, "world").item())

    @staticmethod
    def _restore_preempt(prev) -> None:
        for sig, h in (prev or {}).items():
            signal.signal(sig, h)

    # -- train ----------------------------------------------------------------
    def fit(self, epochs: Optional[int] = None) -> Dict:
        """Train ``epochs`` epochs from the current position (a resumed
        epoch's rest counts as one); None: to the end of ``train.epochs``,
        so a resumed run ends where the uninterrupted one does (the JAX
        Learner runs ``train.epochs`` more epochs after a resume, past its
        cosine's horizon)."""
        if epochs is None:
            epochs = self.cfg.train.epochs - self.epoch
        # resume replays the epoch's order and seeks past consumed batches
        self.data.train_dl.epoch = self.epoch
        prev = self._install_preempt()
        try:
            metrics = self._fit_loop(epochs)
        except BaseException:
            try:  # the loop's error goes up; a write that failed as well is logged
                self.wait_for_checkpoints()
            except Exception as e:
                self.log(f"a checkpoint write failed too: {e!r}")
            raise
        finally:
            self._restore_preempt(prev)
        self.wait_for_checkpoints()
        return metrics

    def _check_dispatch(self, lo: np.ndarray, aux: Dict[str, np.ndarray], at: str) -> None:
        """The guard's give-up (and, without the guard, a non-finite loss
        under ``misc.check_nans``) raises at the dispatch that shows it."""
        t = self.cfg.train
        gnf = aux.get("guard_notfinite")
        if gnf is not None and int(np.max(gnf)) > t.skip_nonfinite:
            raise FloatingPointError(
                f"skip_nonfinite guard gave up: > {t.skip_nonfinite} consecutive non-finite steps at {at} — "
                "params are poisoned; lower train.lr or raise train.skip_nonfinite")
        if t.skip_nonfinite == 0 and not np.all(np.isfinite(lo)) and self.cfg.misc.check_nans:
            gn = np.asarray(aux["grad_norm"]).reshape(-1)
            raise FloatingPointError(f"non-finite loss {lo.tolist()} at {at} (grad_norm={gn.tolist()}); "
                                     "the dispatch froze the state at its last finite step")

    def _fit_loop(self, epochs: int) -> Dict:
        cfg = self.cfg
        smooth = SmoothenValue()
        metrics: Dict = {}
        skip = self.batch_in_epoch
        host_step = int(self.state.step) if cfg.train.ckpt_every_steps else 0
        show_bar = progress_enabled(cfg.misc.progress)
        wait = not cfg.train.async_ckpt
        for ep_i in range(epochs):
            t0 = time.perf_counter()
            launches0 = dict(_build.launches)
            n_seen = n_disp = 0
            prof = None
            self.data.train_dl.start_batch = skip
            it_pos = skip  # batch index; a dispatch advances it by its K
            bar = ProgressBar(len(self.data.train_dl), desc=f"ep {self.epoch}", enabled=show_bar)
            bar.n = skip
            waited = in_dispatch = 0.0  # host s blocked on the loader; in the dispatches and their reads
            t_end = time.perf_counter()
            for stacked in self.data.train_dl:
                t_got = time.perf_counter()
                waited += t_got - t_end
                i = it_pos
                kb = int(stacked["batch_mask"].shape[0])  # an epoch's last group may be short
                self.batch_in_epoch = i + kb
                if cfg.misc.profile_dir and n_disp == 1 and self.main:  # the first dispatch captures the graphs
                    prof = self._start_profile()
                with torch.profiler.record_function(f"train dispatch at it {i}") if prof else nullcontext():
                    _, aux = self._train_multi(self.state, stacked, self.seed, self._tables)
                aux = {k: v.cpu().numpy() for k, v in aux.items()}  # the dispatch's one host read
                if prof is not None and i + kb > cfg.misc.profile_steps:
                    self._stop_profile(prof)
                    prof = None
                in_dispatch += time.perf_counter() - t_got
                n_seen += self.global_bs * kb
                n_disp += 1
                host_step += kb
                it_pos += kb
                bar.update(kb)
                lo = aux["loss"].reshape(-1)
                at = f"ep {self.epoch} it {it_pos - 1}"
                self._check_dispatch(lo, aux, at)
                if self._preempted_anywhere():
                    bar.close("preempted")
                    if prof is not None:
                        self._stop_profile(prof)
                    self.log(f"SIGTERM: saving at ep {self.epoch} batch {self.batch_in_epoch} and leaving fit()")
                    self.save("last", blocking=True)
                    return metrics
                every = cfg.train.ckpt_every_steps
                if every and host_step // every > (host_step - kb) // every:
                    self.save("last", blocking=wait)
                if i == 0 or it_pos // cfg.train.log_every > i // cfg.train.log_every:
                    # the JAX Learner's TensorBoard step
                    tb_step = host_step if every else it_pos + self.epoch * len(self.data.train_dl)
                    self._log_point(lo, aux, smooth, bar, at, tb_step)
                t_end = time.perf_counter()
            if prof is not None:
                self._stop_profile(prof)
            dt = time.perf_counter() - t0
            pairs = n_seen * cfg.ds.num_cmp
            bar.close(f"{pairs / max(dt, 1e-9):.0f} pairs/s")
            self.event("epoch", seconds=dt, loader_wait_s=waited, dispatch_s=in_dispatch, samples=n_seen,
                       dispatches=n_disp, lr_end=float(self.state.tx.lr(self.state.opt_state["count"])),
                       samples_per_s=n_seen / max(dt, 1e-9), pairs_per_s=pairs / max(dt, 1e-9),
                       kernel_launches=_launched_since(launches0))
            # eval every eval_every epochs and always after the last
            do_eval = ep_i == epochs - 1 or self.epoch % max(cfg.train.eval_every, 1) == 0
            if do_eval:
                metrics = self.validate()
                metrics.update(epoch=self.epoch, train_time_s=round(dt, 2),
                               pairs_per_sec=round(pairs / max(dt, 1e-9), 2))
                self.log(f"ep {self.epoch} metrics {metrics}")
                self.log_json(metrics)
                self._tb_scalars({f"valid/{k}": v for k, v in metrics.items()}, self.epoch)
            else:
                self.log(f"ep {self.epoch} done in {dt:.1f}s (eval skipped; eval_every={cfg.train.eval_every})")
            skip = 0
            self.batch_in_epoch = 0
            self.epoch += 1  # the checkpoint's meta names the next epoch to run
            # the best metric is updated before "last" is saved, so a resume
            # from it knows this epoch's (the JAX Learner saves first: a
            # worse later epoch then overwrites "best" after a resume)
            improved = do_eval and metrics["acc"] > self.best_metric
            if improved:
                self.best_metric = metrics["acc"]
            self.save("last", blocking=wait)
            if improved:
                self.save("best", blocking=wait)
        return metrics

    def _start_profile(self):
        """``misc.profile_dir``: a torch.profiler trace from here (CPU, and
        CUDA on the card)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        """End the trace after the card has run what it covers, and write
        it as ``{profile_dir}/{uid}.ep{epoch}.trace.json``."""
        self._sync()
        prof.stop()
        out = Path(self.cfg.misc.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{self.uid}.ep{self.epoch}.trace.json"
        prof.export_chrome_trace(str(path))
        self.log(f"profiler trace written to {path}")
        self.event("profile", path=str(path), batch_in_epoch=self.batch_in_epoch)

    def _log_point(self, lo: np.ndarray, aux: Dict[str, np.ndarray], smooth: SmoothenValue, bar, at: str,
                   tb_step: int) -> None:
        loss = float(lo[-1])
        self.event("log", it=int(at.rsplit(" ", 1)[1]), losses=[float(v) for v in lo],
                   grad_norms=[float(v) for v in np.asarray(aux["grad_norm"]).reshape(-1)])
        if not np.all(np.isfinite(lo)):
            how = "update dropped by skip_nonfinite" if self.cfg.train.skip_nonfinite > 0 else \
                "the dispatch froze the state"
            self.log(f"{at} non-finite loss ({how})")
            return
        gnf = aux.get("guard_notfinite")
        nbad = int(np.max(gnf)) if gnf is not None else 0
        if nbad > 0:
            self.log(f"{at}: {nbad} consecutive non-finite GRAD step(s) with finite loss — updates dropped "
                     "by skip_nonfinite, params frozen")
        for v in lo:
            smooth.add_value(float(v))
        bar.update(0, loss=loss, smooth=smooth.smooth)
        self.log(f"{at} loss {loss:.4f} smooth {smooth.smooth:.4f}")
        self._tb_scalars({"train/loss": loss, "train/loss_smooth": smooth.smooth}, tb_step)

    # -- eval -----------------------------------------------------------------
    def _run_eval(self, dl, split: str) -> Dict:
        sums = {k: 0.0 for k in self.SUM_KEYS}
        sums["loss_sum"] = 0.0
        sums["n_batch"] = 0.0
        preds: List[Dict] = []
        n_props = int(self.cfg.ds.num_prop_per_frm)
        max_b = self.cfg.train.num_eval_batches
        if max_b and len(dl) > max_b:
            self.log(f"eval[{split}] TRUNCATED to {max_b}/{len(dl)} batches (train.num_eval_batches) — "
                     "metrics are partial")
        t0 = time.perf_counter()
        launches0 = dict(_build.launches)
        n_batches = 0

        def consume(out: Dict[str, np.ndarray], batch: Dict[str, np.ndarray]) -> None:
            for k in sums:
                sums[k] += float(out[k])
            ann_idx, bm, pos_vid = batch["ann_idx"], batch["batch_mask"], batch["pos_vid"]
            if "pair_valid" in out:
                if out["n_overflow"] > 0:
                    self.log(f"eval[{split}] WARNING: {int(out['n_overflow'])} considered pairs exceeded "
                             "train.eval_max_pairs — predictions payload truncated (metrics unaffected)")
                valid = out["pair_valid"]
                for b in range(len(ann_idx)):
                    if bm[b] == 0:
                        continue
                    k = valid[b] > 0
                    preds.append({"ann_idx": int(ann_idx[b]), "pred_vid": out["pair_vid"][b][k].tolist(),
                                  "pred_prop": out["pair_prop"][b][k].tolist(),
                                  "iou": out["pair_iou"][b][k].tolist(),
                                  "arg_idx": out["pair_arg"][b][k].tolist(),
                                  "frame_idx": out["pair_frame"][b][k].tolist(),
                                  "scores": out["pair_scores"][b][k].tolist(),
                                  "pos_vid": int(pos_vid[b]), "num_props": n_props})
            else:  # full grids (train.eval_max_pairs = 0)
                for b in range(len(ann_idx)):
                    if bm[b] == 0:
                        continue
                    sel = out["considered"][b] > 0
                    ai, fi = np.nonzero(sel)
                    preds.append({"ann_idx": int(ann_idx[b]), "pred_vid": out["pred_vid"][b][sel].tolist(),
                                  "pred_prop": out["pred_prop"][b][sel].tolist(),
                                  "iou": out["pred_iou"][b][sel].tolist(), "arg_idx": ai.tolist(),
                                  "frame_idx": fi.tolist(), "scores": out["cand_scores"][b, ai, fi].tolist(),
                                  "pos_vid": int(pos_vid[b]), "num_props": n_props})

        group: List[Dict] = []

        def flush() -> None:
            if not group:
                return
            out = self._eval_multi(self.state, collate(group), self._tables)
            out = {k: v.cpu().numpy() for k, v in out.items()}  # one host read a dispatch
            for e, b in enumerate(group):
                consume({k: v[e] for k, v in out.items()}, b)
            group.clear()

        for i, batch in enumerate(dl):
            if max_b and i >= max_b:
                break
            group.append(batch)
            n_batches += 1
            if len(group) == self.E:
                flush()
        flush()
        if self.mesh.data_group is not None:  # the data indices' sums and predictions, in order
            sums, preds = gather_eval(sums, preds, self.mesh.data_group)
        dt = time.perf_counter() - t0
        pred_file = self.dirs["predictions"] / f"{self.uid}_{split}_{self.epoch}.pkl"
        if self.main:
            with open(pred_file, "wb") as f:
                pickle.dump(preds, f)
        self.event("eval", split=split, batches=n_batches, seconds=dt, batches_per_s=n_batches / max(dt, 1e-9),
                   pred_file=str(pred_file), kernel_launches=_launched_since(launches0))
        metrics = finalize_metrics(sums)
        metrics["val_loss"] = sums["loss_sum"] / max(sums["n_batch"], 1.0)
        return metrics

    def validate(self) -> Dict:
        return self._run_eval(self.data.valid_dl, "valid")

    def testing(self) -> Dict:
        return self._run_eval(self.data.test_dl, "test")

