"""Training entry point (counterpart of vog_tpu/cli/train.py).

Reference parity: ``code/main_dist.py §main_dist``, a CLI taking a uid and
dotted config overrides, building data, model and Learner and calling fit
(or validate only)::

  python -m vog_tpu_torch.cli.train <uid> [--cfg=configs/gt5_production.yml]
      [--ds.data_dir=<dir>] [--train.epochs=5] [--only_val] [--only_test]
      [--misc.platform=cpu]

It runs on the card; ``--misc.platform=cpu`` (the JAX CLI's own key) runs
the plain PyTorch path on the CPU instead, and without a GPU nothing else
runs.  ``misc.matmul_precision`` is applied before the model is built.

Data-parallel, one process a card (``train/dist.py``)::

  torchrun --nproc-per-node N -m vog_tpu_torch.cli.train <uid> ... --misc.multihost=true

joins the process group (nccl; gloo with ``--misc.platform=cpu``) before
the mesh and the data, as the JAX CLI initialises ``jax.distributed``;
the global batch is ``train.bs`` x N.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Set, Tuple

from vog_tpu_torch.config import apply_matmul_precision, get_default_cfg, post_proc_config, update_from_dict
from vog_tpu_torch.data.loader import get_data
from vog_tpu_torch.train.dist import init_distributed, make_mesh
from vog_tpu_torch.train.learner import Learner

PLATFORMS = {"": None, "gpu": "cuda", "cpu": "cpu"}  # misc.platform, JAX's names


def parse_argv(argv) -> Tuple[str, Dict[str, str], Set[str]]:
    """-> (uid, ``--key=value`` overrides, ``--flag`` flags)."""
    uid, overrides, flags = None, {}, set()
    for a in argv:
        if a.startswith("--"):
            if "=" in a:
                k, v = a[2:].split("=", 1)
                overrides[k] = v
            else:
                flags.add(a[2:])
        elif uid is None:
            uid = a
        else:
            raise SystemExit(f"unexpected positional arg: {a}")
    return uid or "dbg", overrides, flags


def device_of(cfg) -> Optional[str]:
    """``misc.platform`` -> the device the entry points run on (None: the
    card, which raises without a GPU)."""
    p = cfg.misc.platform
    if p not in PLATFORMS:
        raise ValueError(f"misc.platform={p!r}: the port runs on {', '.join(repr(k) for k in PLATFORMS)}")
    return PLATFORMS[p]


def build_cfg(overrides: Dict[str, str]):
    yml = overrides.pop("cfg", None)
    cfg = get_default_cfg(yml)
    update_from_dict(cfg, overrides)
    post_proc_config(cfg)
    apply_matmul_precision(cfg)
    return cfg


def build(argv) -> Tuple[Learner, Set[str]]:
    """The Learner of a command line -> (learner, flags)."""
    uid, overrides, flags = parse_argv(argv)
    cfg = build_cfg(overrides)
    device = init_distributed(cfg, device_of(cfg))
    mesh = make_mesh(cfg)
    data = get_data(cfg, mesh)
    learner = Learner(uid, data, cfg, device=device, mesh=mesh)
    learner.log(f"uid={uid} device={learner.device} cfg={cfg.to_json()}")
    return learner, flags


def main(argv=None) -> Dict:
    learner, flags = build(sys.argv[1:] if argv is None else argv)
    if "only_val" in flags:
        m = learner.validate()
    elif "only_test" in flags:
        m = learner.testing()
    else:
        m = learner.fit()
    learner.log(f"final metrics: {m}")
    return m


if __name__ == "__main__":
    main()
