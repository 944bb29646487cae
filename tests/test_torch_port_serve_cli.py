"""The port's serving entry point, ``vog_tpu_torch.cli.serve``, on the CPU
(``--misc.platform=cpu``) at small widths, on a checkpoint that
``cli.train`` wrote:

  * ``--selftest=N`` prints and returns the JSON fields of the JAX CLI's
    output (``vog_tpu.cli.serve`` with ``--random_init``), with finite
    latencies and N requests;
  * the CLI's predictor (``_build_predictor``: the device tables from the
    store, ``Predictor.from_checkpoint`` on ``models/<uid>/<tag>.pt``)
    scores the valid split's requests bitwise as a ``Predictor`` built by
    ``from_checkpoint`` directly;
  * the HTTP mode on a loopback port answers ``POST /predict`` with the
    in-process call's ``pred_*``;
  * ``--artifact`` serves ``cli.export``'s artifact (its batch, no
    buckets);
  * without the flag and without a GPU it raises.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from tests.conftest import SMALL
from vog_tpu.cli import serve as jserve_cli
from vog_tpu_torch.cli import export as export_cli
from vog_tpu_torch.cli import serve as serve_cli
from vog_tpu_torch.cli import train as train_cli
from vog_tpu_torch.cli.train import build_cfg, parse_argv
from vog_tpu_torch.data.fixtures import generate_fixture
from vog_tpu_torch.serve import Predictor
from vog_tpu_torch.serving import ServingLoop, batch_to_requests

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A fixture written by the port's writer and one epoch of cli.train."""
    d = tmp_path_factory.mktemp("serve_cli")
    generate_fixture(d / "data", n_train=16, n_valid=12, n_test=4, num_props=5, seed=3, **SMALL)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    def args(uid, *extra):
        return [uid, f"--ds.data_dir={d / 'data'}", f"--misc.tmp_path={d / 'tmp'}",
                f"--cfg={ROOT}/configs/gt5_production.yml", f"--ds.prop_dim={SMALL['prop_dim']}",
                f"--ds.seg_dim={SMALL['seg_dim']}", f"--ds.glove_dim={SMALL['glove_dim']}",
                f"--mdl.emb_dim={SMALL['glove_dim']}", "--mdl.lstm_dim=16", "--mdl.vis_dim=32",
                "--mdl.role_dim=8", "--mdl.n_heads=2", "--train.bs=2", "--misc.progress=off", *extra]

    train_cli.main(args("srv", "--misc.platform=cpu", "--train.epochs=1", "--train.steps_per_dispatch=2",
                        "--train.eval_batches_per_dispatch=2"))
    yield args
    # the recipe's yml turns the TF32 switches on; later tests expect PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def test_selftest_json_fields_match_the_jax_cli(run, capsys):
    out = serve_cli.main(run("srv", "--misc.platform=cpu", "--selftest=8", "--concurrency=2", "--tag=best"))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    ref = jserve_cli.main(run("srv", "--misc.platform=cpu", "--selftest=4", "--concurrency=2", "--random_init",
                              "--ds.device_store=off", "--ds.ann_store=off"))
    assert set(out) == set(ref)
    assert out["n_requests"] == 8 and out["concurrency"] == 2 and out["metric"] == ref["metric"]
    for k in ("p50_ms", "p95_ms", "p99_ms", "mean_ms", "requests_per_sec"):
        assert np.isfinite(out[k]) and out[k] > 0, k


def _requests(data, n):
    reqs = []
    for batch in data.valid_dl:
        reqs.extend(batch_to_requests(batch))
        if len(reqs) >= n:
            return reqs[:n]
    return reqs


def test_cli_predictor_equals_from_checkpoint_and_http(run):
    argv = run("srv", "--misc.platform=cpu")
    cfg = build_cfg(parse_argv(argv)[1])
    pred, data = serve_cli._build_predictor(cfg, "srv", "last", random_init=False)
    assert pred.tables is not None  # the yml's device store
    ref = Predictor.from_checkpoint(cfg, f"{cfg.misc.tmp_path}/models/srv/last.pt", tables=pred.tables,
                                    device="cpu", glove=data.vocab.vectors)
    reqs = _requests(data, 4)
    assert "vid_rows" in reqs[0]
    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    batch["batch_mask"] = np.ones(len(reqs), np.uint8)
    got, want = pred(batch), ref(batch)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    loop = ServingLoop(pred, max_batch=2, max_wait_ms=2.0)
    srv = serve_cli._http_server(loop, 0, "127.0.0.1")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/predict"
        for r in reqs[:3]:
            body = json.dumps({k: np.asarray(v).tolist() for k, v in r.items()}).encode()
            with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"), timeout=60) as f:
                resp = json.loads(f.read())
            direct = loop(r)
            assert set(resp) == {"pred_vid", "pred_prop", "pred_box", "pred_score"}
            for k in resp:
                np.testing.assert_array_equal(np.asarray(resp[k], direct[k].dtype), direct[k], err_msg=k)
    finally:
        srv.shutdown()
        srv.server_close()
        loop.close()


def test_serve_an_exported_artifact(run, tmp_path):
    art = tmp_path / "art"
    ex = export_cli.main(run("srv", "--misc.platform=cpu", "--batch=2", f"--out={art}", "--with_tables"))
    assert ex["max_abs_diff"] == 0.0 and (art / "program.pt2").is_file()
    out = serve_cli.main(run("srv", "--misc.platform=cpu", f"--artifact={art}", "--selftest=4",
                             "--concurrency=2"))
    assert out["n_requests"] == 4 and np.isfinite(out["p50_ms"])


def test_serve_needs_a_gpu_without_the_platform_flag(run):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(run("srv", "--selftest=2"))
