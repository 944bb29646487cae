"""SRL tagging of caption sentences (counterpart of
vog_tpu/dcode/srl_tagger.py).

Three taggers share one output schema:

  * ``BertSrlTagger`` / ``tag_sentences_bert``: the allennlp
    structured-prediction-srl-bert architecture (a BERT encoder with the
    verb indicator fed through ``token_type_ids``, a linear BIO tag head,
    the first word piece of each word carrying its tag, the predicate
    forced to B-V, ``repair_bio``) on the port's own BERT
    (``dcode/bert.py``, its attention the flash kernel on the card),
    WordPiece tokenizer (``dcode/wordpiece.py``) and safetensors reader.
    It runs on the card unless the caller asks for the CPU, and
    ``tag_sentences`` tags every candidate (sentence, predicate) frame in
    padded batches, each sentence keeping its first frame with arguments,
    as the frame-at-a-time ``tag_sentence`` does;
  * ``tag_sentences_allennlp``: the reference's exact dependency,
    imported at call time; it raises without allennlp;
  * ``tag_sentence_rule_based``: a dependency-free tagger for fixtures, a
    tiny verb lexicon and template heuristics.

Output schema per sentence (the annotation files' schema,
``data/fixtures.py``):
  {"tokens": [...], "verb_idx": int, "verb_lemma": str,
   "args": [{"role": str, "span": [s, e], "lemma": str}, ...]}
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vog_tpu_torch.dcode.bert import BertConfig, BertModel, load_safetensors
from vog_tpu_torch.dcode.wordpiece import Encoding, WordPieceTokenizer
from vog_tpu_torch.device import DeviceLike, resolve_device

# minimal verb lexicon: surface form -> lemma (extend for real data)
VERB_LEXICON: Dict[str, str] = {}
for v in (
    "throw", "catch", "ride", "play", "hold", "push", "pull", "watch",
    "run", "jump", "walk", "sit", "stand", "eat", "drink", "open",
    "close", "carry", "kick", "hit", "climb", "swim", "dance", "sing",
):
    VERB_LEXICON[v] = v
    VERB_LEXICON[v + "s"] = v
    VERB_LEXICON[v + "es"] = v  # sibilant stems: catches, pushes, watches
    VERB_LEXICON[v + "ing"] = v
    VERB_LEXICON[v + "ed"] = v
    if v.endswith("e"):  # riding, danced
        VERB_LEXICON[v[:-1] + "ing"] = v
        VERB_LEXICON[v + "d"] = v

STOP = {"the", "a", "an", "is", "are", "was", "were", "being", "been"}
LOC_PREPS = {"near", "on", "in", "at", "under", "behind", "beside", "by"}


def tag_sentence_rule_based(tokens: Sequence[str]) -> Optional[Dict]:
    """Heuristic SRL: first lexicon verb = V; noun-ish chunk before it =
    ARG0; chunk after = ARG1; prep-introduced chunk = ARGM-LOC."""
    toks = [t.lower() for t in tokens]
    verb_idx = next((i for i, t in enumerate(toks) if t in VERB_LEXICON), None)
    if verb_idx is None:
        return None
    args = []

    def noun_span(lo: int, hi: int) -> Optional[tuple]:
        content = [i for i in range(lo, hi) if toks[i] not in STOP and toks[i] not in LOC_PREPS]
        if not content:
            return None
        return content[0], content[-1]

    pre = noun_span(0, verb_idx)
    if pre:
        args.append({"role": "ARG0", "span": list(pre), "lemma": toks[pre[1]]})
    loc_start = next(
        (i for i in range(verb_idx + 1, len(toks)) if toks[i] in LOC_PREPS), None
    )
    post_end = loc_start if loc_start is not None else len(toks)
    post = noun_span(verb_idx + 1, post_end)
    if post:
        args.append({"role": "ARG1", "span": list(post), "lemma": toks[post[1]]})
    if loc_start is not None:
        loc = noun_span(loc_start + 1, len(toks))
        if loc:
            args.append({"role": "ARGM-LOC", "span": list(loc), "lemma": toks[loc[1]]})
    return {
        "tokens": list(tokens),
        "verb_idx": verb_idx,
        "verb_lemma": VERB_LEXICON[toks[verb_idx]],
        "args": args,
    }


def tag_sentences_allennlp(sentences: Sequence[str], cuda_device: int = -1) -> List[Dict]:
    """BERT-SRL via allennlp (the reference's tagger), imported here; raises
    without it."""
    try:
        from allennlp.predictors.predictor import Predictor  # type: ignore
    except ImportError as e:  # pragma: no cover - env without allennlp
        raise ImportError(
            "allennlp is required for BERT-SRL tagging (reference dcode "
            "stage 1). Install allennlp + structured-prediction-srl-bert, "
            "use BertSrlTagger with a local model directory, or "
            "tag_sentence_rule_based for fixture-scale data."
        ) from e
    predictor = Predictor.from_path(
        "https://storage.googleapis.com/allennlp-public-models/"
        "structured-prediction-srl-bert.2020.12.15.tar.gz",
        cuda_device=cuda_device,
    )
    out = []
    for s in sentences:
        pred = predictor.predict(sentence=s)
        out.append(_allennlp_to_schema(pred))
    return out


def frame_from_tags(words: Sequence[str], tags: Sequence[str]) -> Optional[Dict]:
    """One verb frame of per-word BIO tags -> our schema dict (or None if
    the frame has no verb or no arguments).  Shared by the allennlp and
    transformers paths so both decode identically."""
    spans: Dict[str, List[int]] = {}
    for i, t in enumerate(tags):
        if t == "O":
            continue
        role = t.split("-", 1)[1]
        spans.setdefault(role, []).append(i)
    if "V" not in spans:
        return None
    verb_idx = spans["V"][0]
    args = [
        {"role": r, "span": [min(ix), max(ix)], "lemma": words[max(ix)].lower()}
        for r, ix in spans.items()
        if r != "V"
    ]
    if not args:
        return None
    return {
        "tokens": list(words),
        "verb_idx": verb_idx,
        "verb_lemma": words[verb_idx].lower(),
        "args": args,
    }


def _allennlp_to_schema(pred: Dict) -> Optional[Dict]:
    """Convert allennlp SRL output (BIO tags per verb) to our schema,
    keeping the first verb frame with arguments."""
    words = pred["words"]
    for frame in pred.get("verbs", []):
        out = frame_from_tags(words, frame["tags"])
        if out is not None:
            return out
    return None


# BIO tagset: allennlp's srl-bert uses the full PropBank inventory; we keep
# the roles ASRL retains downstream (ARG0/1/2/4 and the kept ARGM
# modifiers): a fine-tune onto this tagset is a strict label-subset of the
# PropBank one.
SRL_ROLES = ("V", "ARG0", "ARG1", "ARG2", "ARG4", "ARGM-LOC", "ARGM-TMP",
             "ARGM-MNR", "ARGM-DIR")
SRL_TAGSET: List[str] = ["O"] + [f"{p}-{r}" for r in SRL_ROLES for p in ("B", "I")]


def repair_bio(tags: List[str]) -> List[str]:
    """Constrained-decode repair: an I-X with no open B-X/I-X of the same
    role becomes B-X (the cheap equivalent of allennlp's transition-
    constrained viterbi; identical on well-formed sequences)."""
    out: List[str] = []
    prev_role = None
    for t in tags:
        if t.startswith("I-"):
            role = t[2:]
            if prev_role != role:
                t = "B-" + role
        out.append(t)
        prev_role = t[2:] if t != "O" else None
    return out




Frame = Tuple[Sequence[str], int]  # (words, predicate index)
BATCH_FRAMES = 256  # frames a padded batch of ``BertSrlTagger.frame_tags``


def predicates_of(words: Sequence[str]) -> List[int]:
    """Candidate predicates: the positions of lexicon verbs (allennlp
    takes them from POS tags; the reference has no POS tagger)."""
    return [i for i, w in enumerate(words) if w.lower() in VERB_LEXICON]


class SrlNet(nn.Module):
    """BERT + the linear BIO head: (B, T) ids, mask and verb indicator ->
    per-wordpiece tag logits (B, T, tags)."""

    def __init__(self, bert: BertModel, head: nn.Linear):
        super().__init__()
        self.bert = bert
        self.head = head

    def forward(self, input_ids, attention_mask, token_type_ids, generator=None):
        return self.head(self.bert(input_ids, attention_mask, token_type_ids, generator))


class BertSrlTagger:
    """BERT token-classification SRL, the allennlp srl-bert architecture:
    the verb indicator rides in ``token_type_ids`` (1 on the predicate's
    word pieces), a linear head scores BIO tags per word piece, and the
    first word piece of each word carries the word's tag.  Runs on
    ``device`` (None: the card)."""

    def __init__(self, bert: BertModel, tokenizer: WordPieceTokenizer, head: Optional[nn.Linear] = None,
                 tagset: Sequence[str] = tuple(SRL_TAGSET), device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.tagset = list(tagset)
        if head is None:
            head = nn.Linear(bert.config.hidden_size, len(self.tagset))
        if head.out_features != len(self.tagset):
            raise ValueError(f"head scores {head.out_features} tags, the tagset has {len(self.tagset)}")
        self.model = SrlNet(bert, head).to(self.device).eval()

    @property
    def bert(self) -> BertModel:
        return self.model.bert

    @property
    def head(self) -> nn.Linear:
        return self.model.head

    @classmethod
    def from_pretrained(cls, model_dir: str | Path, device: DeviceLike = None) -> "BertSrlTagger":
        """Load a fine-tuned SRL model directory (what the JAX package's
        ``srl_finetune.save_tagger`` or this port's writes): ``config.json``,
        ``model.safetensors`` (or ``pytorch_model.bin``), ``vocab.txt`` and
        ``tokenizer_config.json``, and optionally ``srl_head.pt`` (the
        linear head's state dict) and ``srl_tagset.txt`` (one tag a line)."""
        from vog_tpu_torch.interop.from_transformers import bert_srl_from_reference

        model_dir = Path(model_dir)
        with open(model_dir / "config.json") as f:
            config = json.load(f)
        if (model_dir / "model.safetensors").exists():
            state = load_safetensors(model_dir / "model.safetensors")
        else:
            state = torch.load(model_dir / "pytorch_model.bin", map_location="cpu", weights_only=True)
        tagset = list(SRL_TAGSET)
        tag_file = model_dir / "srl_tagset.txt"
        if tag_file.exists():
            with open(tag_file) as f:
                tagset = [ln.strip() for ln in f if ln.strip()]
        head_file = model_dir / "srl_head.pt"
        head_state = (torch.load(head_file, map_location="cpu", weights_only=True)
                      if head_file.exists() else None)
        sd = bert_srl_from_reference(
            {k: v.float().numpy() for k, v in state.items() if v.is_floating_point()},
            None if head_state is None else {k: v.float().numpy() for k, v in head_state.items()}, config)
        cfg = BertConfig.from_dict(config)
        model = SrlNet(BertModel(cfg), nn.Linear(cfg.hidden_size, len(tagset)))
        model.load_state_dict(sd, strict=head_state is not None)  # without srl_head.pt the head stays fresh
        return cls(model.bert, WordPieceTokenizer.from_dir(model_dir), model.head, tagset, device)

    def encode(self, frames: Sequence[Frame], encodings: Optional[Dict[tuple, Encoding]] = None
               ) -> Tuple[Dict[str, torch.Tensor], List[List]]:
        """One padded batch of frames -> ({input_ids, attention_mask,
        token_type_ids}: (N, T) on the device, each frame's word ids).
        ``encodings``: the sentences' ``encode_words`` by their words, where
        the caller has them."""
        if encodings is None:
            encodings = self._encodings(frames)
        encs = [encodings[tuple(w)] for w, _ in frames]
        T = max(len(e.input_ids) for e in encs)
        ids = np.full((len(encs), T), self.tokenizer.pad_id, np.int64)
        mask = np.zeros((len(encs), T), np.int64)
        ind = np.zeros((len(encs), T), np.int64)
        for i, (e, (_, v)) in enumerate(zip(encs, frames)):
            n = len(e.input_ids)
            ids[i, :n], mask[i, :n] = e.input_ids, 1
            ind[i, :n] = [1 if w == v else 0 for w in e.word_ids]  # the verb indicator
        batch = {"input_ids": ids, "attention_mask": mask, "token_type_ids": ind}
        return {k: torch.from_numpy(a).to(self.device) for k, a in batch.items()}, [e.word_ids for e in encs]

    def _encodings(self, frames: Sequence[Frame]) -> Dict[tuple, Encoding]:
        """Each sentence of ``frames`` tokenized once (its frames share it)."""
        out: Dict[tuple, Encoding] = {}
        for words, _ in frames:
            key = tuple(words)
            if key not in out:
                out[key] = self.tokenizer.encode_words(key, self.bert.config.max_position_embeddings)
        return out

    def _decode(self, words: Sequence[str], verb_idx: int, word_ids: List, pred: np.ndarray) -> List[str]:
        tags = ["O"] * len(words)
        seen = set()
        for pos, w in enumerate(word_ids):
            if w is None or w in seen:
                continue
            seen.add(w)
            tags[w] = self.tagset[int(pred[pos])]
        # the frame's predicate position is always V (allennlp decodes with
        # this constraint; without it an untrained head emits garbage there)
        tags[verb_idx] = "B-V"
        return repair_bio(tags)

    def frame_tags(self, frames: Sequence[Frame]) -> List[List[str]]:
        """Per-word BIO tags of each (words, predicate) frame, run in padded
        batches of up to ``BATCH_FRAMES`` frames of similar length."""
        encodings = self._encodings(frames)
        order = sorted(range(len(frames)), key=lambda i: -len(encodings[tuple(frames[i][0])].input_ids))
        out: List[Optional[List[str]]] = [None] * len(frames)
        for lo in range(0, len(order), BATCH_FRAMES):
            chunk = order[lo:lo + BATCH_FRAMES]
            batch, word_ids = self.encode([frames[i] for i in chunk], encodings)
            with torch.no_grad():
                pred = self.model(**batch).argmax(-1).cpu().numpy()
            for j, i in enumerate(chunk):
                words, v = frames[i]
                out[i] = self._decode(words, v, word_ids[j], pred[j])
        return out

    def _word_tags(self, words: Sequence[str], verb_idx: int) -> List[str]:
        """Per-word BIO tags for one (sentence, predicate) frame."""
        return self.frame_tags([(words, verb_idx)])[0]

    def tag_sentence(
        self, words: Sequence[str], predicates: Optional[Sequence[int]] = None
    ) -> Optional[Dict]:
        """Tag one whitespace-tokenized sentence, a frame at a time.
        ``predicates`` overrides predicate identification (default:
        ``predicates_of``).  Returns the first frame with arguments, like
        ``_allennlp_to_schema``."""
        if predicates is None:
            predicates = predicates_of(words)
        for v in predicates:
            out = frame_from_tags(words, self._word_tags(words, v))
            if out is not None:
                out["verb_lemma"] = VERB_LEXICON.get(words[v].lower(), words[v].lower())
                return out
        return None

    def tag_sentences(self, sentences: Sequence[str]) -> List[Optional[Dict]]:
        """``tag_sentence`` of each sentence, every candidate frame of all
        of them tagged in padded batches."""
        words = [s.split() for s in sentences]
        cands = [(i, v) for i, ws in enumerate(words) for v in predicates_of(ws)]
        tags = self.frame_tags([(words[i], v) for i, v in cands])
        out: List[Optional[Dict]] = [None] * len(sentences)
        for (i, v), t in zip(cands, tags):
            if out[i] is None:
                fr = frame_from_tags(words[i], t)
                if fr is not None:
                    fr["verb_lemma"] = VERB_LEXICON.get(words[i][v].lower(), words[i][v].lower())
                    out[i] = fr
        return out


def tag_sentences_bert(
    sentences: Sequence[str], model_dir: Optional[str] = None,
    tagger: Optional[BertSrlTagger] = None, device: DeviceLike = None,
) -> List[Optional[Dict]]:
    """Dcode stage 1 via BERT-SRL.  Pass ``model_dir`` for a local
    fine-tune (see ``BertSrlTagger.from_pretrained``), or a prebuilt
    ``tagger``."""
    if tagger is None:
        if model_dir is None:
            raise ValueError(
                "tag_sentences_bert needs model_dir (a local fine-tuned BERT) "
                "or an explicit tagger; for fixtures use tag_sentence_rule_based."
            )
        tagger = BertSrlTagger.from_pretrained(model_dir, device)
    return tagger.tag_sentences(sentences)
