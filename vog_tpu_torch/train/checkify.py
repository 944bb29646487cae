"""``misc.checkify``: the JAX package's sanitizer mode on the port's eager
train step (counterpart of ``jax.experimental.checkify`` with
``float_checks | div_checks``, as vog_tpu/train/learner.py compiles it in).

``Checker`` is a context manager.  Inside it every aten op (and every
``torch.ops.vog`` forward kernel) runs through a ``TorchDispatchMode``
that

  * checks each floating output for a NaN, and
  * checks the divisor of each division whose divisor is an integer
    (``div``, ``floor_divide``, ``remainder``, ``fmod``; a zero divisor is
    replaced by one for the op itself, so the step runs on to the end as
    the JAX step does, whose integer division by zero is defined);

each check leaves one boolean on the op's device and the op's name, and
nothing is read back to the host per op.  ``Checker.check`` reads the
flags once, after the step, and raises ``CheckifyError`` naming the first
op that failed, the module it ran in (for an op of the backward, the
autograd node and the module whose forward made it) and its index among
the checked ops, as ``jax.experimental.checkify.check_error`` raises the
first error.  Neither uninitialised allocations (``empty`` and its kin)
nor ops that return a view of an input (a slice, a reshape) are checked:
an allocation's contents are not values of the step yet, and a view makes
no value of its own (JAX checks the primitives that can make a NaN).

The backward kernels are raw launches into buffers that an aten op
allocated and the kernel then fills, so the dispatch mode never sees
their values: each backward wrapper hands its kernels' outputs to
``check_kernel_outputs``, which checks them under the active ``Checker``
and does nothing without one.

The dispatch mode lives in the thread's dispatch state, which autograd
carries to its worker thread, so the backward is checked too.  A checked
step runs eagerly: a check of every op cannot be captured in a CUDA graph
(the Learner runs one step a dispatch under the key, as the JAX Learner
ignores ``train.steps_per_dispatch`` under checkify).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# allocations whose contents are not values yet
UNCHECKED = {aten.empty.memory_format, aten.empty_like.default, aten.empty_strided.default,
             aten.new_empty.default, aten.new_empty_strided.default}
# divisions: checked for a zero divisor when the divisor is an integer
DIVISIONS = {"div", "div_", "floor_divide", "floor_divide_", "remainder", "remainder_", "fmod", "fmod_"}
MODULE = "checkify_module"  # an autograd node's metadata key: the module whose forward made it


class CheckifyError(RuntimeError):
    """A check of ``misc.checkify`` failed: a NaN or an integer division by
    zero, named by its op and module."""


class _Tagger(TorchFunctionMode):
    """Tags the autograd node of each output made in a module's forward
    with that module's name, so a check in the backward can name it."""

    def __init__(self, checker: "Checker"):
        super().__init__()
        self.checker = checker

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        where = self.checker.module()
        if where is not None:
            for t in tree_leaves(out):
                fn = getattr(t, "grad_fn", None) if isinstance(t, torch.Tensor) else None
                if fn is not None and MODULE not in fn.metadata:
                    fn.metadata[MODULE] = where
        return out


class _Checks(TorchDispatchMode):
    def __init__(self, checker: "Checker"):
        super().__init__()
        self.checker = checker

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in DIVISIONS and len(args) > 1:
            args = (args[0], self.checker.divisor(args[1], func)) + tuple(args[2:])
        out = func(*args, **kwargs)
        if func not in UNCHECKED and not func.is_view:
            self.checker.nan(func, out if out is not None else args[0])
        return out


class Checker:
    """The checks of ``misc.checkify`` over the code run inside it (on any
    thread autograd runs it on).  ``model``: the module whose submodules'
    names the errors give."""

    def __init__(self, model: Optional[torch.nn.Module] = None):
        self.names = {id(m): n or type(m).__name__ for n, m in model.named_modules()} if model is not None else {}
        self.flags: List[torch.Tensor] = []
        self.where: List[Tuple[str, str, str]] = []  # (what, op, place) by flag
        self._stack: List[str] = []
        self._modes: Tuple[Any, ...] = ()
        self._hooks: Tuple[Any, ...] = ()

    # -- where an op runs -----------------------------------------------------
    def module(self) -> Optional[str]:
        return self._stack[-1] if self._stack else None

    def _place(self) -> str:
        node = torch._C._current_autograd_node()
        if node is not None:  # an op of the backward
            mod = node.metadata.get(MODULE)
            if mod is None:  # a custom Function's node: its inputs' module
                mod = next((f.metadata.get(MODULE) for f, _ in node.next_functions
                            if f is not None and f.metadata.get(MODULE)), None)
            return f"the backward of {node.name()}" + (f" (module {mod})" if mod else "")
        mod = self.module()
        return f"module {mod}" if mod else "the step outside any module"

    def _push(self, mod, args) -> None:
        self._stack.append(self.names.get(id(mod), type(mod).__name__))

    def _pop(self, mod, args, out) -> None:
        self._stack.pop()

    # -- the checks -----------------------------------------------------------
    def _record(self, flag: torch.Tensor, what: str, op: str) -> None:
        self.flags.append(flag.reshape(()))
        self.where.append((what, op, self._place()))

    def nan(self, func, out) -> None:
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel() and t.device.type != "meta":
                with torch.no_grad():
                    self._record(torch.isnan(t).any(), "nan generated by", str(func))

    def divisor(self, d, func):
        """Flag a zero integer divisor; -> the divisor the op runs with."""
        if isinstance(d, bool) or not isinstance(d, (int, torch.Tensor)):
            return d
        if isinstance(d, int):
            if d == 0:
                self._record(torch.ones((), dtype=torch.bool), "division by zero in", str(func))
                return 1
            return d
        if d.is_floating_point() or d.is_complex() or d.dtype == torch.bool:
            return d
        with torch.no_grad():
            zero = d == 0
            self._record(zero.any(), "division by zero in", str(func))
            return torch.where(zero, torch.ones_like(d), d)

    def kernel_outputs(self, name: str, tensors) -> None:
        for t in tensors:
            if t is not None and t.is_floating_point() and t.numel():
                with torch.no_grad():
                    self._record(torch.isnan(t).any(), "nan generated by", f"kernel {name}")

    # -- the context and the one read -----------------------------------------
    def __enter__(self) -> "Checker":
        from torch.nn.modules import module as nn_module

        self._hooks = (nn_module.register_module_forward_pre_hook(self._push),
                       nn_module.register_module_forward_hook(self._pop, always_call=True))
        self._modes = (_Tagger(self), _Checks(self))
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        for m in reversed(self._modes):
            m.__exit__(*exc)
        for h in self._hooks:
            h.remove()
        self._modes, self._hooks = (), ()
        self._stack.clear()

    def check(self) -> None:
        """Read the flags (one host read a device) and raise the first
        failure, if any; the flags are cleared."""
        flags, where = self.flags, self.where
        self.flags, self.where = [], []
        if not flags:
            return
        by_dev: Dict[torch.device, List[int]] = {}
        for i, f in enumerate(flags):
            by_dev.setdefault(f.device, []).append(i)
        bad = []
        for idx in by_dev.values():
            hit = torch.stack([flags[i] for i in idx]).nonzero()
            if hit.numel():
                bad.append(idx[int(hit[0, 0])])
        if bad:
            i = min(bad)
            what, op, place = where[i]
            raise CheckifyError(f"checkify: {what} {op} in {place} (check {i + 1} of {len(flags)} in the step)")


def check_kernel_outputs(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """A raw kernel's outputs, checked for a NaN under the active
    ``Checker`` (the dispatch mode never sees the values a kernel writes);
    nothing without one."""
    if torch._C._len_torch_dispatch_stack() == 0:
        return
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, _Checks):
            mode.checker.kernel_outputs(name, tensors)
            return


def make_checked_train_step(cfg, mesh=None, shard_store: bool = False):
    """-> ``multi_step(state, stacked, seed, tables=None) -> (state, auxs)``,
    ``make_multi_train_step``'s signature: each step of the stacked host
    batch uploaded and run eagerly by ``make_train_step``'s step under a
    ``Checker``, which raises ``CheckifyError`` after the step (its one
    host read); every aux with a leading step axis.  ``mesh``,
    ``shard_store``: as ``make_train_step``."""
    from vog_tpu_torch.train.state import make_train_step

    step = make_train_step(cfg, mesh, shard_store)

    def multi_step(state, stacked: Dict[str, Any], seed: int, tables=None):
        dev = state.step.device
        auxs = []
        for i in range(len(next(iter(stacked.values())))):
            batch = {k: torch.as_tensor(v[i]).to(dev) for k, v in stacked.items()}
            with Checker(state.model) as checker:
                _, aux = step(state, batch, seed, tables)
            checker.check()
            auxs.append(aux)
        return state, {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}

    return multi_step
