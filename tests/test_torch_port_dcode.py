"""The port's offline dataset construction (``vog_tpu_torch/dcode/``)
against the JAX package's ``vog_tpu/dcode/``, on the CPU, from inputs
made from numpy seeds.  Every comparison is exact:

  * the rule tagger, ``align_query`` / ``build_asrl``, ``gt5_select``
    (seeded boxes and scores, GT sets from 0 to more than k) and the
    ``cs_builder`` CLI give equal outputs;
  * ``build_gt5``: the port reads the pack that ``build_featpack`` made of
    the JAX fixture that the JAX package's ``build_gt5`` reads as h5, and the GT5
    pack's arrays equal its ``roi_feats.h5`` (and ``seg_feats/``) bitwise,
    the copied files byte for byte;
  * ``run_pipeline`` and its CLI with the rule tagger, with and without
    ``--gt5-from``, and with a ``bert:`` tagger directory, write files
    byte-equal to the JAX pipeline's.
"""

import filecmp
import json
import shutil

import h5py
import numpy as np
import pytest
import torch

from tests.conftest import SMALL
from vog_tpu.data.fixtures import generate_fixture as jgenerate_fixture
from vog_tpu.dcode import align_args as jalign
from vog_tpu.dcode import cs_builder as jcs
from vog_tpu.dcode import gt5_builder as jgt5
from vog_tpu.dcode import pipeline as jpipe
from vog_tpu.dcode import srl_tagger as jtag
from vog_tpu_torch.data.featpack import PackedFeatureStore, build_featpack
from vog_tpu_torch.dcode import align_args as palign
from vog_tpu_torch.dcode import cs_builder as pcs
from vog_tpu_torch.dcode import gt5_builder as pgt5
from vog_tpu_torch.dcode import pipeline as ppipe
from vog_tpu_torch.dcode import srl_tagger as ptag

WORDS = sorted(set(ptag.VERB_LEXICON) | ptag.STOP | ptag.LOC_PREPS | {
    "man", "woman", "dog", "balls", "horse", "car", "Park", "The", "A", "RIDES", "nothing", "here"})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ``bert:`` pipeline's tagger on one intra-op thread: its many
    small ops, with the suite's workers sharing the cores, otherwise wait
    on descheduled pool threads (26 s for a 13 s test among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_host_constants_equal_jax():
    assert ptag.VERB_LEXICON == jtag.VERB_LEXICON
    assert (ptag.STOP, ptag.LOC_PREPS) == (jtag.STOP, jtag.LOC_PREPS)
    assert ptag.SRL_TAGSET == jtag.SRL_TAGSET and ptag.SRL_ROLES == jtag.SRL_ROLES
    assert palign.KEEP_ROLES == jalign.KEEP_ROLES


@pytest.mark.parametrize("seed", range(4))
def test_rule_tagger_and_alignment_equal_jax(seed):
    rng = np.random.default_rng(seed)
    sentences = [list(rng.choice(WORDS, size=int(rng.integers(1, 12)))) for _ in range(200)]
    srls = []
    for s in sentences:
        got, want = ptag.tag_sentence_rule_based(s), jtag.tag_sentence_rule_based(s)
        assert got == want, s
        if got is not None:
            srls.append(dict(got, vid_seg=f"v{len(srls) % 7}"))
    ae = {f"v{i}": [{"tokens": list(rng.choice(WORDS, size=int(rng.integers(1, 4)))),
                     "frame": int(rng.integers(10)), "box": rng.uniform(0, 50, 4).tolist()}
                    for _ in range(int(rng.integers(0, 6)))] for i in range(7)}
    for q in srls:
        assert palign.align_query(q, ae[q["vid_seg"]]) == jalign.align_query(q, ae[q["vid_seg"]])
    assert palign.build_asrl(srls, ae) == jalign.build_asrl(srls, ae)
    assert len(palign.build_asrl(srls, ae)) > 0
    # the BIO decoders
    roles = ["O"] + [f"{p}-{r}" for r in ("V", "ARG0", "ARG1", "ARGM-LOC") for p in "BI"]
    for _ in range(200):
        tags = list(rng.choice(roles, size=8))
        assert ptag.repair_bio(tags) == jtag.repair_bio(tags)
        words = list(rng.choice(WORDS, size=8))
        assert ptag.frame_from_tags(words, tags) == jtag.frame_from_tags(words, tags)
        pred = {"words": words, "verbs": [{"tags": tags}, {"tags": list(rng.choice(roles, size=8))}]}
        assert ptag._allennlp_to_schema(pred) == jtag._allennlp_to_schema(pred)


@pytest.mark.parametrize("n_gt", [0, 1, 3, 5, 8])
def test_gt5_select_equals_jax(n_gt):
    rng = np.random.default_rng(n_gt)
    for P, k in ((20, 5), (3, 5), (100, 5), (12, 3)):
        boxes = rng.uniform(0, 50, (P, 4)).astype(np.float32)
        boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 30, (P, 2))
        scores = rng.uniform(size=P).astype(np.float32)
        # GT boxes: jittered copies of some detections (IoU >= 0.5) and random ones
        gts = [boxes[int(rng.integers(P))] + rng.uniform(-1, 1, 4).astype(np.float32) if rng.uniform() < 0.7
               else rng.uniform(0, 50, 4).astype(np.float32) for _ in range(n_gt)]
        got, want = pgt5.gt5_select(boxes, scores, gts, k), jgt5.gt5_select(boxes, scores, gts, k)
        assert got.dtype == want.dtype and np.array_equal(got, want), (P, k)


@pytest.fixture(scope="module")
def p100(tmp_path_factory):
    """-> (the JAX fixture with 20 proposals a frame, in h5 form; a copy
    with the pack ``build_featpack`` made of it)."""
    root = tmp_path_factory.mktemp("dcode_p100")
    jgenerate_fixture(root / "h5", n_train=8, n_valid=4, n_test=4, num_props=20, prop_dim=SMALL["prop_dim"],
                      seg_dim=SMALL["seg_dim"], glove_dim=SMALL["glove_dim"], seed=3)
    shutil.copytree(root / "h5", root / "pack")
    build_featpack(root / "pack")
    return root / "h5", root / "pack"


def _same_files(a, b, names):
    for n in names:
        assert filecmp.cmp(a / n, b / n, shallow=False), n


def _gt5_equal(jdir, pdir):
    """The port's GT5 pack against the JAX package's h5 + seg_feats,
    bitwise, and every other file byte for byte."""
    store = PackedFeatureStore(pdir)
    with h5py.File(jdir / "roi_feats.h5", "r") as h5:
        assert sorted(store.videos()) == sorted(h5.keys())
        for v in h5.keys():
            feats, boxes, scores, seg = store.get(v)
            for name, got in (("feats", feats), ("boxes", boxes), ("scores", scores)):
                want = np.asarray(h5[v][name])
                assert got.dtype == want.dtype and np.array_equal(got, want), (v, name)
            assert np.array_equal(seg, np.load(jdir / "seg_feats" / f"{v}.npy")), v
    names = sorted(p.name for p in jdir.iterdir() if p.suffix in (".jsonl", ".json", ".txt"))
    assert "vid_dims.json" in names and "anns_train.jsonl" in names
    _same_files(jdir, pdir, names)


@pytest.mark.parametrize("k", [5, 3])
def test_build_gt5_equals_jax(p100, tmp_path, k):
    h5_dir, pack_dir = p100
    jgt5.build_gt5(h5_dir, tmp_path / "j", k=k)
    pgt5.build_gt5(pack_dir, tmp_path / "p", k=k)
    _gt5_equal(tmp_path / "j", tmp_path / "p")


def test_cs_builder_equals_jax(p100, tmp_path, capsys):
    h5_dir, _ = p100
    for d in ("j", "p"):
        (tmp_path / d).mkdir()
        for split in ("train", "valid"):
            shutil.copy(h5_dir / f"anns_{split}.jsonl", tmp_path / d)
    jcs.main(str(tmp_path / "j"))
    want = capsys.readouterr().out
    pcs.main(str(tmp_path / "p"))
    assert capsys.readouterr().out == want.replace(str(tmp_path / "j"), str(tmp_path / "p"))
    _same_files(tmp_path / "j", tmp_path / "p", ["cs_dict_train.json", "cs_dict_valid.json"])
    assert not (tmp_path / "p" / "cs_dict_test.json").exists()


def _raw_dir(src, out):
    """Captions and AE boxes made from a fixture's annotations (inflected
    verbs, a caption with no verb, an unknown split left out)."""
    out.mkdir()
    caps, ae = [], {}
    rng = np.random.default_rng(0)
    for split in ("train", "valid", "test"):
        for ann in map(json.loads, (src / f"anns_{split}.jsonl").read_text().splitlines()):
            toks = list(ann["tokens"])
            toks[ann["verb_idx"]] += str(rng.choice(["", "s", "ing"]))
            caps.append({"vid_seg": ann["vid_seg"], "sentence": " ".join(toks), "split": split})
            ae[ann["vid_seg"]] = [{"tokens": ["the", a["lemma"]], "frame": b["frame"], "box": b["box"]}
                                  for a in ann["args"] for b in a["boxes"]]
    caps.append({"vid_seg": caps[0]["vid_seg"], "sentence": "nothing to see here"})
    (out / "captions.jsonl").write_text("\n".join(json.dumps(c) for c in caps) + "\n")
    (out / "ae_annots.json").write_text(json.dumps(ae))
    return out


@pytest.mark.parametrize("gt5", [False, True])
def test_pipeline_rule_equals_jax(p100, tmp_path, capsys, gt5):
    h5_dir, pack_dir = p100
    raw = _raw_dir(h5_dir, tmp_path / "raw")
    want = jpipe.run_pipeline(raw, tmp_path / "j", tagger="rule", gt5_from=str(h5_dir) if gt5 else None)
    got = ppipe.run_pipeline(raw, tmp_path / "p", tagger="rule", gt5_from=str(pack_dir) if gt5 else None)
    assert got == want and sum(got.values()) > 0
    if gt5:
        _gt5_equal(tmp_path / "j", tmp_path / "p")
    else:
        _same_files(tmp_path / "j", tmp_path / "p",
                    [f"{f}_{s}.{x}" for s in want for f, x in (("anns", "jsonl"), ("cs_dict", "json"))])
    # the CLIs
    capsys.readouterr()
    jpipe.main([str(raw), str(tmp_path / "jc"), "--tagger=rule", "--gt5-k=5"])
    ppipe.main([str(raw), str(tmp_path / "pc"), "--tagger=rule", "--gt5-k=5", "--misc.platform=cpu"])
    _same_files(tmp_path / "jc", tmp_path / "pc", sorted(p.name for p in (tmp_path / "jc").iterdir()))
    with pytest.raises(SystemExit):
        ppipe.main([str(raw), str(tmp_path / "x"), "--misc.platform=tpu"])
    with pytest.raises(ValueError):
        ppipe.run_pipeline(raw, tmp_path / "x", tagger="crf")


def test_pipeline_bert_tagger_equals_jax(p100, tmp_path):
    """``--tagger=bert:<dir>`` on a directory the JAX package's
    ``save_tagger`` wrote (a tiny random BERT whose vocab covers the
    captions): the same annotation files, the port tagging all captions'
    frames in padded batches on the CPU."""
    import transformers

    from vog_tpu.dcode.srl_finetune import save_tagger

    h5_dir, _ = p100
    raw = _raw_dir(h5_dir, tmp_path / "raw")
    words = sorted({w.lower() for c in (raw / "captions.jsonl").read_text().splitlines()
                    for w in json.loads(c)["sentence"].split()})
    (tmp_path / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    cfg = transformers.BertConfig(vocab_size=len(words) + 5, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=64, max_position_embeddings=64)
    torch.manual_seed(1)
    ref = jtag.BertSrlTagger(transformers.BertModel(cfg),
                             transformers.BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt")))
    model_dir = save_tagger(ref, str(tmp_path / "tagger"))
    want = jpipe.run_pipeline(raw, tmp_path / "j", tagger=f"bert:{model_dir}")
    got = ppipe.run_pipeline(raw, tmp_path / "p", tagger=f"bert:{model_dir}", device="cpu")
    assert got == want and sum(got.values()) > 0
    _same_files(tmp_path / "j", tmp_path / "p", sorted(p.name for p in (tmp_path / "j").iterdir()))
