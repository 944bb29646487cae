"""Convert a vog_tpu Learner checkpoint (orbax) into a checkpoint of the
PyTorch port (vog_tpu_torch), for ``Predictor.from_checkpoint``,
``cli.serve`` / ``cli.export`` and ``Learner.load``.

Usage (on a host with JAX; the card's host has none)::

  python tools/orbax_to_torch_port.py <ckpt_dir> <out.pt> [--cfg=configs/gt5_production.yml] \\
      [--key=value ...]

``<ckpt_dir>`` is an orbax directory written by ``vog_tpu.train.Learner``
(``tmp/models/<uid>/best``); the overrides are the ``cli.train`` ones the
checkpoint was trained with (they fix the model's widths).  Put the output
at ``<tmp_path>/models/<uid>/<tag>.pt`` to serve it with
``python -m vog_tpu_torch.cli.serve <uid> --tag=<tag>``.

As ``vog_tpu/train/learner.py §load`` reads it: first against the JAX
Learner's template state (params, optimizer state, step).  Then the port's
file holds every tensor of its ``TrainState``: the parameters through
``interop/from_jax.py §params_from_jax``; Adam's two moments through the
same mapping (a moment has its parameter's layout), flattened in the port
model's parameter order into ``opt:mu`` / ``opt:nu``; Adam's count and the
non-finite guard's two counters; the step; and the epoch, batch and best
metric of ``<ckpt_dir>.meta.json``.  A resume then continues the JAX run's
optimizer.  On a structure mismatch (another optimizer wrapper, or the
pre-round-2 head names, folded as ``_migrate_head_params`` folds them,
leaves the model no longer has dropped) it falls back to params and step,
as the JAX Learner does: the port's ``Learner.load`` then starts the
moments fresh and says so.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _tree_np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _adam_and_guard(opt_state) -> Tuple[object, object]:
    """-> (optax's ScaleByAdamState, the skip-nonfinite guard's state or
    None) of the JAX Learner's optimizer state."""
    import jax
    import optax

    from vog_tpu.train.state import SkipNonfiniteState

    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    adam = [x for x in jax.tree.leaves(opt_state, is_leaf=is_adam) if is_adam(x)]
    if len(adam) != 1:
        raise ValueError(f"expected one Adam state in the optimizer state, found {len(adam)}")
    return adam[0], opt_state if isinstance(opt_state, SkipNonfiniteState) else None


def restore(ckpt_dir: Path, jcfg) -> Tuple[Dict, object, int, bool, list]:
    """-> (params, optimizer state or None, step, full, dropped leaves):
    against the JAX Learner's template state, else params + step from the
    raw tree (head names folded, stale leaves dropped)."""
    import jax
    import orbax.checkpoint as ocp
    from flax import traverse_util

    from vog_tpu.train.learner import Learner as JaxLearner
    from vog_tpu.train.state import init_state

    ckptr = ocp.StandardCheckpointer()
    raw = ckptr.restore(ckpt_dir)  # the raw tree: the embedding gives the vocabulary's size
    glove = np.zeros(np.shape(raw["params"]["lang"]["embed"]), np.float32)
    state = init_state(jcfg, glove, jax.random.PRNGKey(0), 1)
    target = {"params": state.params, "opt_state": state.opt_state, "step": state.step}
    try:
        restored = ckptr.restore(ckpt_dir, target)
        return _tree_np(restored["params"]), restored["opt_state"], int(restored["step"]), True, []
    except (ValueError, KeyError, TypeError):
        params = JaxLearner._migrate_head_params(raw["params"])
        cur = set(traverse_util.flatten_dict(state.params))
        flat = traverse_util.flatten_dict(params)
        stale = [p for p in flat if p not in cur]
        for p in stale:
            del flat[p]
        return _tree_np(traverse_util.unflatten_dict(flat)), None, int(np.asarray(raw["step"])), False, stale


def convert(ckpt_dir, out_path, jcfg, pcfg, uid: str = "converted") -> Dict:
    """Write the port checkpoint ``out_path`` from the orbax directory
    ``ckpt_dir``; -> a summary (``full``: the optimizer state came too)."""
    from vog_tpu_torch.interop.from_jax import params_from_jax
    from vog_tpu_torch.model.grounding import get_model

    ckpt_dir = Path(ckpt_dir).absolute()
    params, opt_state, step, full, stale = restore(ckpt_dir, jcfg)
    sd = params_from_jax(params, pcfg)
    state = {f"param:{k}": torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    if full:
        adam, guard = _adam_and_guard(opt_state)
        # the port's moments: one flat vector each, in its parameter order
        names = [n for n, _ in get_model(pcfg, int(sd["lang.embed.weight"].shape[0]), device="cpu")
                 .named_parameters()]
        for key, moment in (("mu", adam.mu), ("nu", adam.nu)):
            msd = params_from_jax(_tree_np(moment), pcfg)
            state[f"opt:{key}"] = torch.cat([torch.as_tensor(np.asarray(msd[n], np.float32)).reshape(-1)
                                             for n in names])
        zero = np.zeros((), np.int32)
        for key, value in (("count", adam.count),
                           ("notfinite_count", zero if guard is None else guard.notfinite_count),
                           ("total_notfinite", zero if guard is None else guard.total_notfinite)):
            state[f"opt:{key}"] = torch.tensor(np.asarray(value, np.int32))
    state["step"] = torch.tensor(np.asarray(step, np.int32))
    meta = {"epoch": 0, "batch_in_epoch": 0, "best_metric": -float("inf")}
    meta_f = ckpt_dir.parent / f"{ckpt_dir.name}.meta.json"
    if meta_f.exists():
        meta.update({k: v for k, v in json.loads(meta_f.read_text()).items() if k in meta})
    meta.update(seed=int(pcfg.train.seed), uid=uid, converted_from=str(ckpt_dir))
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state": state, "meta": meta}, out_path)
    return {"full": full, "stale": ["/".join(p) for p in stale], "step": step, "tensors": len(state)}


def _cfgs(overrides: Dict[str, str]):
    """The JAX package's and the port's Cfg of the same overrides."""
    from vog_tpu import config as jconfig
    from vog_tpu_torch import config as pconfig

    out = []
    for mod in (jconfig, pconfig):
        over = dict(overrides)
        cfg = mod.get_default_cfg(over.pop("cfg", None))
        mod.update_from_dict(cfg, over)
        out.append(mod.post_proc_config(cfg))
    return out


def main(argv=None) -> Dict:
    args = sys.argv[1:] if argv is None else argv
    pos = [a for a in args if not a.startswith("--")]
    if len(pos) != 2:
        raise SystemExit(__doc__)
    overrides = dict(a[2:].split("=", 1) for a in args if a.startswith("--"))
    jcfg, pcfg = _cfgs(overrides)
    out = convert(pos[0], pos[1], jcfg, pcfg, uid=Path(pos[1]).parent.name)
    how = ("params, Adam's moments and counters, the guard's counters and the step" if out["full"] else
           "params and step only (the optimizer state's structure differs; a resume starts the moments fresh)")
    print(f"wrote {pos[1]}: {out['tensors']} tensors, {how}, step {out['step']}"
          + (f"; dropped stale leaves {out['stale']}" if out["stale"] else ""), flush=True)
    return out


if __name__ == "__main__":
    main()
