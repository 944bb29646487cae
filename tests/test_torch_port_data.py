"""The port's data path against the JAX package's, on the CPU, from inputs
made from a numpy seed.  Every comparison is exact (bitwise, or equal
Python values):

  * vocab, boxes and contrastive sampling (the same draws from the same
    generator);
  * the fixture writer: every file of ``generate_fixture`` and
    ``generate_scaled`` byte for byte the JAX fixture's after
    ``build_featpack`` (the pack, annotations, ``glove.txt``, cs_dicts,
    ``vid_dims.json``); the packed store's reads;
  * ``AnetSRLDataset.__getitem__`` for every index of every split, on the
    packed store and on the h5 form, plain, with ``device_rows`` and
    index-only;
  * two epochs of ``BatchIterator`` batches, with a ``start_batch`` seek,
    ``group=3``, a transform in the prefetch thread;
  * ``DeviceFeatureTables.from_store`` in f32, bf16 and int8 against the
    JAX package's tables and ``rows``; ``AnnTables.from_datasets`` against
    ``DeviceAnnTables``;
  * ``eval_fun`` on one predictions pickle;
  * the two repairs: the yml reader against ``yaml.safe_load`` (and the
    recipe's ``Cfg`` with PyYAML absent), ``get_model(glove=)`` against the
    JAX ``LangEncoder``'s ``embed``.
"""

import dataclasses
import filecmp
import pickle
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

from tests.conftest import SMALL, small_cfg
from tests.test_torch_port_model import port_cfg
from vog_tpu.data import boxes as jboxes
from vog_tpu.data import contrastive as jcs
from vog_tpu.data import vocab as jvocab
from vog_tpu.data.dataset import AnetSRLDataset as JDataset
from vog_tpu.data.dataset import FeatureStore as JFeatureStore
from vog_tpu.data.featpack import PackedFeatureStore as JPacked
from vog_tpu.data.featpack import build_featpack as jbuild_featpack
from vog_tpu.data.fixtures import generate_fixture as jgenerate_fixture
from vog_tpu.data.fixtures import generate_scaled as jgenerate_scaled
from vog_tpu.data.loader import BatchIterator as JBatchIterator
from vog_tpu_torch.config import defaults as pdefaults
from vog_tpu_torch.data import boxes as pboxes
from vog_tpu_torch.data import contrastive as pcs
from vog_tpu_torch.data import vocab as pvocab
from vog_tpu_torch.data.ann_store import AnnTables
from vog_tpu_torch.data.dataset import AnetSRLDataset as PDataset
from vog_tpu_torch.data.dataset import FeatureStore as PFeatureStore
from vog_tpu_torch.data.device_store import DeviceFeatureTables
from vog_tpu_torch.data.featpack import PackedFeatureStore as PPacked
from vog_tpu_torch.data.fixtures import generate_fixture as pgenerate_fixture
from vog_tpu_torch.data.fixtures import generate_scaled as pgenerate_scaled
from vog_tpu_torch.data.loader import BatchIterator as PBatchIterator
from vog_tpu_torch.data.loader import get_data as pget_data

FILES = ("anns_train.jsonl", "anns_valid.jsonl", "anns_test.jsonl", "cs_dict_train.json", "cs_dict_valid.json",
         "cs_dict_test.json", "featpack.bin", "featpack.json", "glove.txt", "vid_dims.json")
SPLITS = ("train", "valid", "test")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(JAX fixture, h5 form plus its pack; the port's fixture), same seed."""
    kw = dict(n_train=14, n_valid=6, n_test=5, num_props=5, seed=7, **SMALL)
    j = tmp_path_factory.mktemp("jax_fx")
    jgenerate_fixture(j, **kw)
    jbuild_featpack(j)
    p = tmp_path_factory.mktemp("port_fx")
    pgenerate_fixture(p, **kw)
    return j, p


def _equal(a, b, where=""):
    """Exact equality of nested dicts / arrays / scalars, dtype included."""
    if isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (where, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x, y, equal_nan=True), where


def test_vocab_boxes_contrastive_equal_jax(dirs):
    jdir, pdir = dirs
    jv, pv = jvocab.Vocab.from_glove_txt(jdir / "glove.txt"), pvocab.Vocab.from_glove_txt(pdir / "glove.txt")
    assert jv.itos == pv.itos and np.array_equal(jv.vectors, pv.vectors)
    toks = ["The", "man", "zzz", "ball", "<pad>"]
    assert jv.encode(toks) == pv.encode(toks)
    assert pvocab.ROLE_LIST == jvocab.ROLE_LIST
    assert [pvocab.role_to_id(r) for r in ("ARG0", "ARGM-LOC", "nope")] == \
        [jvocab.role_to_id(r) for r in ("ARG0", "ARGM-LOC", "nope")]
    anns = pvocab.load_annotations(pdir / "anns_train.jsonl")
    assert anns == jvocab.load_annotations(jdir / "anns_train.jsonl")
    assert pvocab.build_word_list(anns) == jvocab.build_word_list(anns)

    rng = np.random.default_rng(0)
    a = np.sort(rng.uniform(0, 50, (7, 4)).reshape(7, 2, 2), axis=1).reshape(7, 4)
    b = np.sort(rng.uniform(0, 50, (5, 4)).reshape(5, 2, 2), axis=1).reshape(5, 4)
    a[0, 2] = a[0, 0]  # a degenerate box
    _equal(pboxes.iou_matrix(a, b), jboxes.iou_matrix(a, b))
    _equal(pboxes.normalize_boxes(a, 640.0, 480.0), jboxes.normalize_boxes(a, 640.0, 480.0))
    assert pboxes.iou_single(a[1], b[2]) == jboxes.iou_single(a[1], b[2])

    for cap in (0, 2):
        pd, jd = pcs.build_cs_dict(anns, max_partners=cap, seed=3), jcs.build_cs_dict(anns, max_partners=cap, seed=3)
        assert pd == jd
        for train in (True, False):
            ps = pcs.ContrastiveSampler(pd, len(anns), 4, is_train=train, seed=5)
            js = jcs.ContrastiveSampler(jd, len(anns), 4, is_train=train, seed=5)
            for i in range(len(anns)):
                r1, r2 = (np.random.default_rng([1, i]), np.random.default_rng([1, i])) if train else (None, None)
                assert ps.sample_group(i, r1) == js.sample_group(i, r2)


@pytest.mark.parametrize("scaled", [False, True])
def test_fixture_files_equal_jax_after_build_featpack(tmp_path, scaled):
    if scaled:
        kw = dict(n_train_segs=7, n_valid_segs=3, n_test_segs=2, num_props=6, max_partners=3, seed=4,
                  verbose=False, **SMALL)
        jgenerate_scaled(tmp_path / "j", **kw)  # fp16 features in the h5
        pgenerate_scaled(tmp_path / "p", **kw)
    else:
        kw = dict(n_train=6, n_valid=3, n_test=2, seed=11, **SMALL)
        jgenerate_fixture(tmp_path / "j", **kw)
        pgenerate_fixture(tmp_path / "p", **kw)
    jbuild_featpack(tmp_path / "j")
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == sorted(FILES)
    for f in FILES:
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "p" / f, shallow=False), f


def test_packed_store_reads_equal_jax(dirs):
    jdir, pdir = dirs
    js, ps = JPacked(jdir), PPacked(pdir)
    vids = ps.videos()
    assert vids == js.videos() == sorted(vids)
    for v in vids[:4]:
        _equal(ps.get(v), js.get(v), v)
        _equal(ps.get_meta(v), js.get_meta(v), v)
        _equal(ps.get_feats(v), js.get_feats(v), v)
        assert ps.dims(v) == js.dims(v)
    _equal(ps.gather_many(vids[::3], fields=("seg", "boxes")), js.gather_many(vids[::3], fields=("seg", "boxes")))


def _datasets(jdir, pdir, split, h5=False):
    cfg = small_cfg(jdir, **{"ds.conc_type": "spat"})
    pcfg = port_cfg(cfg)
    pcfg.ds.data_dir = str(pdir)
    jstore = JFeatureStore(jdir) if h5 else JPacked(jdir)
    pstore = PFeatureStore(jdir) if h5 else PPacked(pdir)
    jv, pv = jvocab.Vocab.from_glove_txt(jdir / "glove.txt"), pvocab.Vocab.from_glove_txt(pdir / "glove.txt")
    return cfg, pcfg, JDataset(cfg, split, jv, jstore), PDataset(pcfg, split, pv, pstore)


@pytest.mark.parametrize("h5", [False, True])
def test_dataset_items_equal_jax(dirs, h5):
    jdir, pdir = dirs
    for split in SPLITS:
        _, _, jd, pd = _datasets(jdir, pdir, split, h5=h5)
        rows = {v: i for i, v in enumerate(pd.store.videos())}
        for mode in ("plain", "rows", "index_only"):
            if mode != "plain":
                jd.device_rows = pd.device_rows = rows
            jd.index_only = pd.index_only = mode == "index_only"
            jd.ann_row_offset = pd.ann_row_offset = 3
            for i in range(len(pd)):
                r = (lambda: np.random.default_rng([2, 0, i])) if split == "train" else (lambda: None)
                _equal(pd.__getitem__(i, r()), jd.__getitem__(i, r()), f"{split}[{i}] {mode}")


def test_batch_iterator_two_epochs_seek_and_group_equal_jax(dirs):
    jdir, pdir = dirs
    _, _, jd, pd = _datasets(jdir, pdir, "train")
    tf = lambda u: {k: np.stack([b[k] for b in u]) for k in u[0]}  # noqa: E731
    got = {}
    for name, cls, ds in (("j", JBatchIterator, jd), ("p", PBatchIterator, pd)):
        it = cls(ds, 3, shuffle=True, drop_last=True, seed=9, prefetch=2)
        it.group, it.transform = 3, tf
        out = [list(it), list(it)]  # epochs 0 and 1
        it.epoch, it.start_batch = 1, 2  # resume epoch 1 at batch 2
        out.append(list(it))
        ev = cls(ds, 4, shuffle=False, drop_last=False, seed=9, prefetch=0)  # a padded last batch
        out.append(list(ev))
        got[name] = out
    assert len(got["p"][0]) == 2 and len(got["p"][2]) == 1  # 4 batches in groups of 3; 2 after the seek
    _equal(got["p"], got["j"])
    # the seek lands on the batches the uninterrupted epoch built there
    _equal({k: v[2:] for k, v in got["p"][1][0].items()},
           {k: v[:1] for k, v in got["p"][2][0].items()})


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_device_tables_from_store_equal_jax(dirs, mode):
    from vog_tpu.data.device_store import DeviceFeatureTables as JTables

    jdir, pdir = dirs
    cfg, pcfg, _, _ = _datasets(jdir, pdir, "train")
    half, int8 = mode == "bf16", mode == "int8"
    jt = JTables(cfg, JPacked(jdir), half=half, int8=int8)
    pt = DeviceFeatureTables.from_store(pcfg, PPacked(pdir), half=half, int8=int8, device="cpu", chunk_rows=4)
    assert pt.rows == jt.rows
    assert sorted(pt.tables) == sorted(jt.tables)
    for k, t in pt.tables.items():
        ref = np.asarray(jax.device_get(jt.tables[k]))
        got = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        if t.dtype == torch.bfloat16:
            ref = ref.view(np.int16)
        _equal(got, ref, k)


def test_device_store_choice_and_size(dirs):
    """``ds.device_store``: "on" / "off" as set, "auto" off on the CPU (on
    the card it reads the free memory), "shard" refused; ``table_bytes``
    is the size of the tables ``from_store`` builds."""
    from vog_tpu_torch.data.device_store import table_bytes, use_device_store

    jdir, pdir = dirs
    _, pcfg, _, _ = _datasets(jdir, pdir, "train")
    cpu = torch.device("cpu")
    for want, on in (("on", True), ("off", False), ("auto", False)):
        pcfg.ds.device_store = want
        assert use_device_store(pcfg, 10, cpu) is on
    pcfg.ds.device_store = "shard"
    with pytest.raises(ValueError, match="ds.device_store"):
        use_device_store(pcfg, 10, cpu)
    store = PPacked(pdir)
    for half, int8 in ((False, False), (True, False), (False, True)):
        pcfg.misc.half_feats, pcfg.misc.int8_feats = half, int8
        t = DeviceFeatureTables.from_store(pcfg, store, half=half, int8=int8, device="cpu")
        assert sum(v.nbytes for v in t.tables.values()) == table_bytes(pcfg, len(store.videos()))


def test_ann_tables_from_datasets_equal_jax(dirs):
    from vog_tpu.data.ann_store import DeviceAnnTables

    jdir, pdir = dirs
    jds, pds = {}, {}
    for split in SPLITS:
        cfg, pcfg, jds[split], pds[split] = _datasets(jdir, pdir, split)
    rows = {v: i for i, v in enumerate(PPacked(pdir).videos())}
    jt = DeviceAnnTables(cfg, jds, rows)
    pt = AnnTables.from_datasets(pcfg, pds, rows, device="cpu")
    assert pt.split_offset == jt.split_offset and pt.n_anns == jt.n_anns
    _equal({k: v.numpy() for k, v in pt.tables.items()}, {k: np.asarray(v) for k, v in jt.tables.items()})


def test_eval_fun_equal_jax(dirs, tmp_path):
    """One predictions pickle, made from a seed in the Learner's format,
    scored by both packages' ``eval_fun``: the same metrics."""
    from vog_tpu.evaluation.offline import eval_fun as jeval
    from vog_tpu_torch.evaluation.offline import eval_fun as peval

    jdir, pdir = dirs
    cfg, pcfg, _, pd = _datasets(jdir, pdir, "valid")
    rng = np.random.default_rng(5)
    preds = []
    V, P = pcfg.ds.num_cmp, pcfg.ds.num_prop_per_frm
    for i in range(len(pd)):
        it = pd[i]
        sel = (it["gt_frame_mask"] * it["srl_arg_mask"][:, None]) > 0
        ai, fi = np.nonzero(sel)
        scores = rng.normal(size=(len(ai), V * P)).astype(np.float32)
        # plant the right answer in half the pairs so the metrics are not 0
        right = np.argmax(it["targets"][it["pos_vid"]][ai, fi].reshape(len(ai), P), axis=-1) + it["pos_vid"] * P
        for j in range(0, len(ai), 2):
            scores[j, right[j]] = 9.0
        preds.append({"ann_idx": i, "arg_idx": ai.tolist(), "frame_idx": fi.tolist(), "scores": scores.tolist(),
                      "pos_vid": int(it["pos_vid"]), "num_props": P})
    f = tmp_path / "preds.pkl"
    with open(f, "wb") as fh:
        pickle.dump(preds, fh)
    got, ref = peval(f, "valid", pcfg), jeval(f, "valid", cfg)
    assert got == ref and got["acc"] > 0


def test_get_data_prefers_the_pack(dirs):
    jdir, pdir = dirs
    _, pcfg, _, _ = _datasets(jdir, pdir, "train")
    data = pget_data(pcfg)
    assert isinstance(data.train_dl.ds.store, PPacked)
    assert len(data.train_dl) == 14 // pcfg.train.bs and len(data.valid_dl) == 3
    assert data.train_dl.shuffle and not data.valid_dl.shuffle


# -- the repairs ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["anet_srl_cfg.yml", "gt5_production.yml"])
def test_yml_reader_equals_pyyaml(name, monkeypatch):
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "configs" / name
    assert pdefaults.load_yml(str(path)) == yaml.safe_load(path.read_text())
    want = pdefaults.get_default_cfg(str(path))
    monkeypatch.setitem(sys.modules, "yaml", None)  # PyYAML absent: `import yaml` raises
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    got = pdefaults.get_default_cfg(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "gt5_production.yml":
        assert got.ds.device_store == "on" and got.train.lr == 5e-4 and got.mdl.dtype == "bfloat16"


def test_yml_reader_subset_cases_and_refusals():
    ok = ["a: 1\nb: -2\nc: 1.0e-4\nd: 0.5\ne: 1.\nf: +3", "a: true\nb: false\nc: null\nd:",
          "a: 'on'\nb: \"on\"\nc: \"x y\"\nd: plain text", "a:\n  b:\n    c: 1\n  d: 2\ne: 3",
          "# c\na: 1  # trailing\n    # indented comment\nb: x#y"]
    for text in ok:
        assert pdefaults.read_yaml_subset(text) == yaml.safe_load(text), text
    bad = {"a: 1e-4": 1, "a: [1, 2]": 1, "a:\n  - 1": 2, "a: &x 1": 1, "a: |": 1, "a:\n\tb: 1": 2,
           "a: 1\na: 2": 2, "a: b: c": 1, "a:\n    b: 1\n  c: 2": 3, "a: 0x10": 1, "a: 2020-01-01": 1,
           "x: 1\n---\na: 1": 2, "a: {b: 1}": 1, "a: !tag x": 1, "a: -.5": 1, "a: .5": 1,
           "a: 1\nb: on": 2, "a: Off": 1, "a: yes": 1, "a: True": 1, "a: ~": 1, "a: NULL": 1,
           "a: .inf": 1, "a: .nan": 1, "a: \"x\\ty\"": 1, "a: 'it''s'": 1}
    for text, line in bad.items():
        with pytest.raises(pdefaults.YamlSubsetError, match=f"<yml>:{line}:"):
            pdefaults.read_yaml_subset(text)


def test_get_model_glove_sets_the_embedding_as_jax():
    from vog_tpu.config import Cfg as JCfg
    from vog_tpu.config import post_proc_config as jpost
    from vog_tpu.train.state import init_state
    from vog_tpu_torch.model.grounding import get_model

    cfg = JCfg()
    cfg.ds.conc_type = "spat"
    cfg.mdl.emb_dim, cfg.mdl.lstm_dim, cfg.mdl.vis_dim, cfg.mdl.role_dim, cfg.mdl.n_heads = 24, 8, 16, 4, 2
    cfg.ds.prop_dim, cfg.ds.seg_dim = 32, 24
    jpost(cfg)
    glove = np.random.default_rng(3).normal(size=(37, 24)).astype(np.float32)
    glove[:2] = 0.0
    jembed = np.asarray(init_state(cfg, glove, jax.random.PRNGKey(0), 2).params["lang"]["embed"])
    pcfg = port_cfg(cfg)
    model = get_model(pcfg, 37, device="cpu", glove=glove)
    w = model.lang.embed.weight.detach().numpy()
    assert w.dtype == jembed.dtype and np.array_equal(w, jembed)
    # frozen unless mdl.train_embeddings, as the JAX stop_gradient
    tok = torch.tensor([[2, 3, 4, 0]])
    out = model.lang(tok, torch.tensor([3]), torch.tensor([[[0, 1]]]), torch.tensor([[2]]), torch.tensor([1]))
    out["arg_rep"].float().sum().backward()
    assert model.lang.embed.weight.grad is None
    with pytest.raises(ValueError, match="glove table"):
        get_model(pcfg, 36, device="cpu", glove=glove)
