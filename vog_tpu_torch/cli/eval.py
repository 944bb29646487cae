"""Eval-only entry point (counterpart of vog_tpu/cli/eval.py)::

  python -m vog_tpu_torch.cli.eval <uid> [--split=valid|test] [--tag=last|best] [overrides...]
  python -m vog_tpu_torch.cli.eval <uid> --pred_file=tmp/predictions/...pkl [--split=valid] [overrides...]

The first form loads the uid's checkpoint ``models/{uid}/{tag}.pt`` when
there is one (else it scores the fresh model, and says so), scores the
split, writes the predictions pickle and returns the metric dict.  The
second re-scores a saved predictions file offline
(``evaluation/offline.py §eval_fun``): no model, no checkpoint, no card.
Under torchrun with ``--misc.multihost=true`` the first form scores the
split data-parallel, as ``cli.train`` trains.
"""

from __future__ import annotations

import sys
from typing import Dict

from vog_tpu_torch.cli.train import build_cfg, device_of, parse_argv
from vog_tpu_torch.data.loader import get_data
from vog_tpu_torch.train.dist import init_distributed, make_mesh
from vog_tpu_torch.train.learner import Learner


def main(argv=None) -> Dict:
    uid, overrides, flags = parse_argv(sys.argv[1:] if argv is None else argv)
    split = overrides.pop("split", "valid")
    tag = overrides.pop("tag", "last")
    pred_file = overrides.pop("pred_file", None)
    cfg = build_cfg(overrides)
    if pred_file:
        from vog_tpu_torch.evaluation.offline import eval_fun

        m = eval_fun(pred_file, split, cfg)
        print(f"rescored {pred_file} [{split}]: {m}", flush=True)
        return m
    device = init_distributed(cfg, device_of(cfg))
    mesh = make_mesh(cfg)
    learner = Learner(uid, get_data(cfg, mesh), cfg, device=device, mesh=mesh)
    ckpt = learner.ckpt_path(tag)
    if ckpt.exists():
        learner.load(tag=tag)
    else:
        learner.log(f"no checkpoint at {ckpt}; evaluating the fresh model")
    m = learner.testing() if split == "test" else learner.validate()
    learner.log(f"{split} metrics: {m}")
    return m


if __name__ == "__main__":
    main()
