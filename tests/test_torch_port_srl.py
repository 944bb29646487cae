"""The port's BERT-SRL tagger (``vog_tpu_torch/dcode/``: WordPiece
tokenizer, BERT, tagger, weights in and out, fine-tune) against the JAX
package's ``vog_tpu/dcode/`` (``transformers``), on the CPU, with weights
and inputs made from seeds:

  * the tokenizer's ``input_ids`` and ``word_ids`` equal
    ``BertTokenizerFast``'s (splits into ``##`` pieces, accents,
    punctuation, CJK, ``[UNK]``, specials inside a word, over-long words,
    truncation), and a seeded fuzz of such words;
  * the BERT's last hidden state within 1e-5 x max(1, max|h|) of
    ``transformers.BertModel``'s (widths 32 and 48, 2 layers, a padded
    batch);
  * the tagger's tags equal the reference's on ``test_srl_bert.py``'s tiny
    tagger, the verb indicator changes the frames there, and batched
    tagging equals frame-at-a-time;
  * saved tagger directories load both ways with logits within 1e-5, and
    the safetensors reader and writer against each other in every dtype;
  * 3 epochs of ``finetune_srl`` at dropout 0 from the same weights: the
    per-epoch losses within 1e-5 relative and the same exact-match
    history;
  * the golden harness: the port's fine-tune reaches exact 1.0 on the
    golden set within 300 epochs, through the full inference path.
"""

import json

import numpy as np
import pytest
import torch
import transformers

from vog_tpu.dcode import srl_finetune as jft
from vog_tpu.dcode import srl_tagger as jtag
from vog_tpu.dcode.golden_srl import golden_examples as jgolden_examples
from vog_tpu_torch.dcode import srl_finetune as pft
from vog_tpu_torch.dcode import srl_tagger as ptag
from vog_tpu_torch.dcode.bert import BertConfig, BertModel, load_safetensors, save_safetensors
from vog_tpu_torch.dcode.golden_srl import golden_examples, golden_vocab
from vog_tpu_torch.dcode.wordpiece import WordPieceTokenizer
from vog_tpu_torch.interop.from_transformers import bert_srl_from_reference

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
TINY_WORDS = SPECIALS + [  # test_srl_bert.py's vocab
    "the", "a", "man", "woman", "dog", "ball", "car", "park",
    "throws", "catches", "rides", "near", "in", "red", "big",
]
PIECES = ["the", "man", "run", "ning", "cafe", "play", "er", "s", "a", "b", "中", "国", "'", "-", ",", "é"]
TOK_VOCAB = SPECIALS + PIECES + ["##" + p for p in PIECES] + ["##ing", "##ed"]
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's BERT runs on one intra-op thread: its many small ops,
    with the suite's workers sharing the cores, otherwise wait on
    descheduled pool threads (the golden harness, ~5 s alone, took 407 s
    among the workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vocab_dir(tmp_path, words):
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    return tmp_path


def _hf_tok(d):
    return transformers.BertTokenizerFast(vocab_file=str(d / "vocab.txt"), do_lower_case=True)


def _hf_bert(width, vocab, seed, dropout=0.1, max_pos=64):
    cfg = transformers.BertConfig(
        vocab_size=vocab, hidden_size=width, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=2 * width, max_position_embeddings=max_pos, type_vocab_size=2,
        hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    torch.manual_seed(seed)
    return transformers.BertModel(cfg).eval()


def _port_tagger(ref, d):
    """The port's tagger with the reference tagger's weights (numpy, as
    ``state_dict()`` gives them) and the same vocab, on the CPU."""
    sd = bert_srl_from_reference({k: v.numpy() for k, v in ref.bert.state_dict().items()},
                                 {k: v.numpy() for k, v in ref.head.state_dict().items()},
                                 ref.bert.config.to_dict())
    cfg = BertConfig.from_dict(ref.bert.config.to_dict())
    tagger = ptag.BertSrlTagger(BertModel(cfg), WordPieceTokenizer.from_dir(d), tagset=ref.tagset, device="cpu")
    tagger.model.load_state_dict(sd, strict=True)
    return tagger


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """-> (reference tagger, port tagger, vocab dir): test_srl_bert.py's
    tiny tagger (seed 0) and its port."""
    d = _vocab_dir(tmp_path_factory.mktemp("tiny_srl"), TINY_WORDS)
    tok = _hf_tok(d)
    ref = jtag.BertSrlTagger(_hf_bert(32, len(TINY_WORDS), 0), tok)
    return ref, _port_tagger(ref, d), d


# -- tokenizer ------------------------------------------------------------
TOKEN_CASES = {
    "pieces": (["the", "running", "players", "cafes"], 64),
    "accents": (["Café", "ÉRÉ", "naïve", "résumé"], 64),
    "punct": (["man's", "play-er", "a,b", "¿run?", "«the»", "$5+6", "run..."], 64),
    "cjk": (["中国", "the中man", "日本"], 64),
    "unk": (["zzz", "the", "xyzzy", "##s"], 64),
    "specials": (["x[SEP]y", "[UNK]", "the[MASK]", "[cls]"], 64),
    "long": (["a" * 100, "a" * 101, "the" + "s" * 200], 64),
    "controls": (["the​man", "\x07run", "a b", "́"], 64),
    "truncation": (["running", "the", "players", "man", "cafes", "run"], 7),
    "truncation_cls_only": (["the", "man"], 2),
}


@pytest.mark.parametrize("case", sorted(TOKEN_CASES))
def test_tokenizer_matches_bert_tokenizer_fast(tmp_path, case):
    words, max_length = TOKEN_CASES[case]
    d = _vocab_dir(tmp_path, TOK_VOCAB)
    ref = _hf_tok(d)(words, is_split_into_words=True, truncation=True, max_length=max_length)
    got = WordPieceTokenizer.from_dir(d).encode_words(words, max_length)
    assert got.input_ids == ref["input_ids"]
    assert got.word_ids == ref.word_ids()
    assert got.attention_mask == ref["attention_mask"]


def test_tokenizer_fuzz_and_files(tmp_path):
    """A seeded fuzz of words drawn from letters, accents, punctuation,
    CJK, controls and specials; then the port's saved files load in
    ``transformers.AutoTokenizer`` with the same ids."""
    rng = np.random.default_rng(0)
    d = _vocab_dir(tmp_path, TOK_VOCAB)
    ref, port = _hf_tok(d), WordPieceTokenizer.from_dir(d)
    alphabet = list("themanrunigcafplyrsbTHEMAN") + [
        "é", "É", "ñ", "中", "国", "日", "'", "-", ",", ".", "$", "+", "~", "¿", "«", "​", "\x07",
        " ", "́", "ǅ", "İ", "ß", "Σ", "[SEP]", "[UNK]", "##"]
    cases = []
    for _ in range(400):
        words = ["".join(rng.choice(alphabet, size=int(rng.integers(1, 12))))
                 for _ in range(int(rng.integers(1, 8)))]
        cases.append((words, int(rng.integers(3, 30))))
    for words, ml in cases:
        r = ref(words, is_split_into_words=True, truncation=True, max_length=ml)
        g = port.encode_words(words, ml)
        assert (g.input_ids, g.word_ids) == (r["input_ids"], r.word_ids()), words
    port.save(tmp_path / "saved")
    back = transformers.AutoTokenizer.from_pretrained(str(tmp_path / "saved"))
    for words, ml in cases[:50]:
        r = back(words, is_split_into_words=True, truncation=True, max_length=ml)
        assert port.encode_words(words, ml).input_ids == r["input_ids"]


# -- BERT -----------------------------------------------------------------
@pytest.mark.parametrize("width", [32, 48])
def test_bert_last_hidden_state_matches_transformers(width):
    rng = np.random.default_rng(width)
    vocab = 40
    ref = _hf_bert(width, vocab, seed=width)
    port = BertModel(BertConfig.from_dict(ref.config.to_dict())).eval()
    sd = bert_srl_from_reference({k: v.numpy() for k, v in ref.state_dict().items()}, None, ref.config.to_dict())
    port.load_state_dict({k[len("bert."):]: v for k, v in sd.items()}, strict=True)
    B, T = 4, 13
    ids = rng.integers(5, vocab, (B, T))
    lens = np.array([T, 9, 5, 2])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    ids = np.where(mask > 0, ids, 0)
    types = (rng.uniform(size=(B, T)) < 0.3).astype(np.int64) * mask
    args = [torch.from_numpy(a) for a in (ids, mask, types)]
    with torch.no_grad():
        want = ref(input_ids=args[0], attention_mask=args[1], token_type_ids=args[2]).last_hidden_state
        got = port(*args)
    real = torch.from_numpy(mask > 0)
    err = float((got - want)[real].abs().max())
    assert err <= TOL * max(1.0, float(want[real].abs().max())), err


def test_bert_refuses_other_activations_and_positions():
    for key, val in (("hidden_act", "gelu_new"), ("position_embedding_type", "relative_key")):
        with pytest.raises(ValueError, match=f"config.json {key}="):
            BertConfig.from_dict({key: val})


def test_bert_training_with_attention_dropout_takes_bert_product(monkeypatch):
    """In training with attention dropout the layer runs BERT's own
    product (the kernel has no dropout); at attention dropout 0 and in
    eval it runs ``flash_attention``."""
    from vog_tpu_torch.kernels import attention

    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    ids = torch.randint(5, 30, (2, 6), generator=torch.Generator().manual_seed(0))
    for p, train, want in ((0.1, True, 0), (0.1, False, 2), (0.0, True, 2)):
        cfg = BertConfig(vocab_size=30, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=32, max_position_embeddings=16, attention_probs_dropout_prob=p)
        model = BertModel(cfg).train(train)
        calls.clear()
        model(ids, generator=torch.Generator().manual_seed(1))
        assert len(calls) == want, (p, train)


# -- the tagger -----------------------------------------------------------
SENTENCES = [
    "the man throws the ball near the car",
    "a woman rides the red car in the park",
    "the dog catches a ball",
    "no verbs here at all",
    "the big man throws a ball and catches the red ball",
    "Café man rides the dog's car",
]


def test_tagger_tags_equal_reference(tiny):
    ref, port, _ = tiny
    for s in SENTENCES:
        words = s.split()
        for v in range(len(words)):
            assert port._word_tags(words, v) == ref._word_tags(words, v), (s, v)
        assert port.tag_sentence(words) == ref.tag_sentence(words), s
    assert ptag.tag_sentences_bert(SENTENCES, tagger=port) == jtag.tag_sentences_bert(SENTENCES, tagger=ref)
    with pytest.raises(ValueError):
        ptag.tag_sentences_bert(["x"])


def test_tagger_verb_indicator_changes_frames(tiny):
    _, port, _ = tiny
    words = "the man throws the ball near the car".split()
    t0, t1 = port._word_tags(words, 2), port._word_tags(words, 4)
    assert t0[2] == "B-V" and t1[4] == "B-V"
    free0 = [t for i, t in enumerate(t0) if i not in (2, 4)]
    free1 = [t for i, t in enumerate(t1) if i not in (2, 4)]
    assert free0 != free1 or t0 != t1


@pytest.mark.parametrize("batch_frames", [1, 3, 256])
def test_batched_tagging_equals_frame_at_a_time(tiny, batch_frames, monkeypatch):
    _, port, _ = tiny
    monkeypatch.setattr(ptag, "BATCH_FRAMES", batch_frames)
    rng = np.random.default_rng(batch_frames)
    words = [w for w in TINY_WORDS[5:]]
    sentences = [" ".join(rng.choice(words, size=int(rng.integers(3, 12)))) for _ in range(30)]
    frames = [(s.split(), v) for s in sentences for v in ptag.predicates_of(s.split())]
    assert len(frames) > 10
    assert port.frame_tags(frames) == [port._word_tags(w, v) for w, v in frames]
    assert port.tag_sentences(sentences) == [port.tag_sentence(s.split()) for s in sentences]


def _logits(tagger, words, v, port):
    if port:
        batch, _ = tagger.encode([(words, v)])
        with torch.no_grad():
            return tagger.model(**batch)[0].numpy()
    enc = tagger.tokenizer(list(words), is_split_into_words=True, return_tensors="pt")
    ind = torch.tensor([[1 if w == v else 0 for w in enc.word_ids(0)]])
    with torch.no_grad():
        hid = tagger.bert(input_ids=enc["input_ids"], attention_mask=enc["attention_mask"],
                          token_type_ids=ind).last_hidden_state
        return tagger.head(hid)[0].numpy()


def test_from_pretrained_both_ways(tiny, tmp_path):
    """The JAX package's ``save_tagger`` directory (transformers'
    ``model.safetensors``) loads in the port, and the port's in the JAX
    package, with logits within 1e-5 and equal tags."""
    ref, port, _ = tiny
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jft.save_tagger(ref, jdir)
    pft.save_tagger(port, pdir)
    from_jax = ptag.BertSrlTagger.from_pretrained(jdir, device="cpu")
    from_port = jtag.BertSrlTagger.from_pretrained(pdir)
    assert from_jax.tagset == from_port.tagset == ref.tagset
    assert json.load(open(tmp_path / "port" / "config.json"))["hidden_act"] == "gelu"
    for s in SENTENCES[:3]:
        words = s.split()
        want = _logits(ref, words, 2, port=False)
        for got in (_logits(from_jax, words, 2, port=True), _logits(from_port, words, 2, port=False)):
            assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())
        assert from_jax._word_tags(words, 2) == from_port._word_tags(words, 2) == ref._word_tags(words, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64])
def test_safetensors_roundtrip(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    ts = {"a.weight": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g), "s": torch.randn((), generator=g),
          "e": torch.zeros(0, 4)}
    ts = {k: (v * 100).to(dtype) for k, v in ts.items()}
    save_safetensors(ts, tmp_path / "m.safetensors")
    back = load_safetensors(tmp_path / "m.safetensors")
    assert set(back) == set(ts)
    for k, v in ts.items():
        assert back[k].dtype == dtype and back[k].shape == v.shape and torch.equal(back[k], v)
    raw = (tmp_path / "m.safetensors").read_bytes()
    n = int.from_bytes(raw[:8], "little")
    assert (8 + n) % 8 == 0 and json.loads(raw[8:8 + n])["__metadata__"] == {"format": "pt"}


def test_interop_checks_keys_and_shapes(tiny):
    ref, _, _ = tiny
    bert = {k: v.numpy() for k, v in ref.bert.state_dict().items()}
    head = {k: v.numpy() for k, v in ref.head.state_dict().items()}
    cfg = ref.bert.config.to_dict()
    sd = bert_srl_from_reference(bert, head, cfg)
    assert len(sd) == len(bert) + 2 - sum(k.endswith("position_ids") for k in bert)
    with pytest.raises(KeyError, match="missing"):
        bert_srl_from_reference({k: v for k, v in bert.items() if "pooler" not in k}, head, cfg)
    with pytest.raises(ValueError, match="shape"):
        bert_srl_from_reference({**bert, "pooler.dense.bias": np.zeros(3, np.float32)}, head, cfg)
    with pytest.raises(ValueError, match="shape"):
        bert_srl_from_reference(bert, {**head, "bias": np.zeros(3, np.float32)}, cfg)


# -- fine-tune ------------------------------------------------------------
def _golden_pair(tmp_path, seed, width=48):
    d = _vocab_dir(tmp_path, golden_vocab())
    ref = jtag.BertSrlTagger(_hf_bert(width, len(golden_vocab()), seed, dropout=0.0), _hf_tok(d))
    return ref, _port_tagger(ref, d)


def _epoch_losses(monkeypatch, fn, n_steps):
    """-> (fn's return value, the mean cross-entropy of each epoch)."""
    seen = []
    real = torch.nn.functional.cross_entropy

    def record(*a, **k):
        out = real(*a, **k)
        seen.append(float(out.detach()))
        return out

    monkeypatch.setattr(torch.nn.functional, "cross_entropy", record)
    hist = fn()
    monkeypatch.setattr(torch.nn.functional, "cross_entropy", real)
    return hist, [float(np.mean(seen[i:i + n_steps])) for i in range(0, len(seen), n_steps)]


def test_finetune_tracks_reference(tmp_path, monkeypatch):
    """Three epochs of the golden set at dropout 0 from the same weights:
    the per-epoch losses within 1e-5 relative, the same exact-match
    history."""
    ref, port = _golden_pair(tmp_path, seed=0)
    examples = golden_examples()
    assert examples == jgolden_examples()
    kw = dict(lr=5e-4, max_epochs=3, target_exact=2.0, seed=0)
    jhist, jloss = _epoch_losses(monkeypatch, lambda: jft.finetune_srl(ref, examples, **kw), len(examples))
    phist, ploss = _epoch_losses(monkeypatch, lambda: pft.finetune_srl(port, examples, **kw), len(examples))
    assert phist == jhist and len(ploss) == 3
    for a, b in zip(ploss, jloss):
        assert abs(a - b) <= TOL * abs(b), (ploss, jloss)


def test_golden_harness_exact(tmp_path):
    """The port's fine-tune of a fresh tiny BERT reaches exact 1.0 on the
    golden set within 300 epochs, and its frames are the gold ones."""
    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=len(golden_vocab()), hidden_size=48, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=96, max_position_embeddings=64)
    d = _vocab_dir(tmp_path, golden_vocab())
    tagger = ptag.BertSrlTagger(BertModel(cfg).init_weights(torch.Generator().manual_seed(0)),
                                WordPieceTokenizer.from_dir(d), device="cpu")
    examples = golden_examples()
    hist = pft.finetune_srl(tagger, examples, lr=5e-4, max_epochs=300, seed=0)
    assert hist[-1] == 1.0, hist[-5:]
    for words, v, tags in examples:
        want = ptag.frame_from_tags(words, tags)
        got = tagger.tag_sentence(words, predicates=[v])
        assert got["verb_idx"] == want["verb_idx"] == v
        assert sorted((a["role"], tuple(a["span"])) for a in got["args"]) == sorted(
            (a["role"], tuple(a["span"])) for a in want["args"])
    loaded = ptag.BertSrlTagger.from_pretrained(pft.save_tagger(tagger, str(tmp_path / "ft")), device="cpu")
    assert pft.exact_match(loaded, examples) == 1.0
