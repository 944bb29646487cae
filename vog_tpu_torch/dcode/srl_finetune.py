"""Fine-tune the BERT-SRL tagger (counterpart of
vog_tpu/dcode/srl_finetune.py).

The trainer of ``dcode/srl_tagger.py §BertSrlTagger``: BERT with the verb
indicator in ``token_type_ids`` and a linear BIO head, cross-entropy on
the first word piece of each word (the convention the tagger decodes
with), Adam over BERT and the head jointly, one frame a step.  On the
card the attention runs the flash kernel forward and backward, but in
training with ``attention_probs_dropout_prob > 0`` (``dcode/bert.py``).
Dropout draws from a generator seeded with ``seed``.

Used for the golden-fixture fidelity harness (``dcode/golden_srl.py``:
a tiny BERT must reproduce every gold tag sequence exactly through the
real inference path) and by users with SRL data (CoNLL-2012 style
(words, predicate, tags) triples) who want a local checkpoint for
``tag_sentences_bert(model_dir=...)``.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import torch

from vog_tpu_torch.dcode.bert import save_safetensors
from vog_tpu_torch.dcode.srl_tagger import BertSrlTagger

# one training example: (words, predicate index, per-word BIO tags)
Example = Tuple[Sequence[str], int, Sequence[str]]

IGNORE = -100  # wordpiece positions that carry no word label


def encode_examples(tagger: BertSrlTagger, examples: Sequence[Example]):
    """Tokenize frames the way the tagger does -> (their padded batch,
    labels (N, T)): the FIRST wordpiece of each word carries the word's
    tag id, every other position (and the padding) IGNORE."""
    batch, word_ids = tagger.encode([(words, v) for words, v, _ in examples])
    tag_id = {t: i for i, t in enumerate(tagger.tagset)}
    labels = torch.full(batch["input_ids"].shape, IGNORE, dtype=torch.long)
    for i, ((_, _, tags), wids) in enumerate(zip(examples, word_ids)):
        seen = set()
        for pos, w in enumerate(wids):
            if w is not None and w not in seen:
                seen.add(w)
                labels[i, pos] = tag_id[tags[w]]
    return batch, labels.to(tagger.device)


def frame_loss(tagger: BertSrlTagger, batch, labels, generator=None) -> torch.Tensor:
    """Cross-entropy of the tag logits over the labelled word pieces."""
    logits = tagger.model(**batch, generator=generator)
    return torch.nn.functional.cross_entropy(
        logits.view(-1, logits.shape[-1]),
        labels.view(-1),
        ignore_index=IGNORE,
    )


def exact_match(tagger: BertSrlTagger, examples: Sequence[Example]) -> float:
    """Fraction of examples whose decoded per-word tags (incl. the forced
    B-V + repair_bio, i.e. the REAL inference path) equal the gold tags."""
    got = tagger.frame_tags([(words, v) for words, v, _ in examples])
    hit = sum(1 for g, (_, _, tags) in zip(got, examples) if g == list(tags))
    return hit / max(len(examples), 1)


def finetune_srl(
    tagger: BertSrlTagger,
    examples: Sequence[Example],
    lr: float = 5e-4,
    max_epochs: int = 200,
    target_exact: float = 1.0,
    seed: int = 0,
    verbose: bool = False,
) -> List[float]:
    """Fine-tune ``tagger`` (BERT + head jointly) on BIO-tagged frames.
    Stops once the decoded exact-match over ``examples`` reaches
    ``target_exact`` (checked each epoch through the real inference
    path).  Returns the per-epoch exact-match trajectory."""
    gen = torch.Generator(device=tagger.device).manual_seed(seed)
    for t in tags_missing(tagger, examples):
        raise ValueError(f"gold tag {t!r} not in tagger.tagset")
    params = list(tagger.bert.parameters()) + list(tagger.head.parameters())
    opt = torch.optim.Adam(params, lr=lr)
    encoded = [encode_examples(tagger, [ex]) for ex in examples]  # one frame a step
    history: List[float] = []
    for epoch in range(max_epochs):
        tagger.model.train()
        for batch, labels in encoded:
            loss = frame_loss(tagger, batch, labels, gen)
            opt.zero_grad()
            loss.backward()
            opt.step()
        tagger.model.eval()
        em = exact_match(tagger, examples)
        history.append(em)
        if verbose:
            print(f"epoch {epoch}: exact={em:.3f}", flush=True)
        if em >= target_exact:
            break
    return history


def tags_missing(tagger: BertSrlTagger, examples: Sequence[Example]) -> List[str]:
    known = set(tagger.tagset)
    return sorted({t for _, _, tags in examples for t in tags} - known)


def save_tagger(tagger: BertSrlTagger, out_dir: str) -> str:
    """Write a directory that both taggers' ``from_pretrained`` load:
    ``config.json`` + ``model.safetensors`` (a ``transformers`` BertModel),
    ``vocab.txt`` + ``tokenizer_config.json``, ``srl_head.pt``,
    ``srl_tagset.txt``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(tagger.bert.config.to_dict(), f, indent=2)
    save_safetensors(tagger.bert.state_dict(), os.path.join(out_dir, "model.safetensors"))
    tagger.tokenizer.save(out_dir)
    torch.save({k: v.cpu() for k, v in tagger.head.state_dict().items()}, os.path.join(out_dir, "srl_head.pt"))
    with open(os.path.join(out_dir, "srl_tagset.txt"), "w") as f:
        f.write("\n".join(tagger.tagset) + "\n")
    return out_dir
