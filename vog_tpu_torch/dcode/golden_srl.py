"""Golden BIO fixture set for the BERT-SRL fidelity harness (copy of
vog_tpu/dcode/golden_srl.py, the same frames in the same order).

~56 sentences with hand-constructed gold BIO tags (every role the ASRL
schema keeps, span lengths 1-3, same-sentence multi-predicate frames that
force the verb indicator to matter) fine-tune a tiny BERT
(``dcode/srl_finetune.py``) until the whole inference path (wordpiece
alignment, the indicator in ``token_type_ids``, argmax decode, forced
B-V, ``repair_bio``, ``frame_from_tags``) reproduces the gold tags and
schema frames exactly.

The fixtures are explicit data, not random: each template writes its
tags structurally next to its words, so a reader can check every BIO
sequence by eye.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

Example = Tuple[List[str], int, List[str]]


def _frame(*chunks: Tuple[Sequence[str], str]) -> Example:
    """Build (words, verb_idx, tags) from (words, role) chunks; role '' =
    outside, 'V' = the predicate (single word)."""
    words: List[str] = []
    tags: List[str] = []
    verb_idx = -1
    for chunk_words, role in chunks:
        for j, w in enumerate(chunk_words):
            words.append(w)
            if role == "":
                tags.append("O")
            elif role == "V":
                verb_idx = len(words) - 1
                tags.append("B-V")
            else:
                tags.append(("B-" if j == 0 else "I-") + role)
    assert verb_idx >= 0
    return words, verb_idx, tags


def golden_examples() -> List[Example]:
    ex: List[Example] = []
    subjects = [
        ("the", "man"), ("the", "big", "man"), ("a", "woman"),
        ("the", "old", "woman"), ("the", "dog"), ("a", "small", "dog"),
        ("the", "boy"), ("the", "girl"),
    ]
    verbs = ["throws", "catches", "kicks", "holds"]
    objects = [("the", "ball"), ("a", "red", "ball"), ("the", "cup"),
               ("a", "car"), ("the", "bike")]
    places = [("in", "the", "park"), ("near", "the", "house"),
              ("in", "the", "yard")]

    # 1) ARG0 V ARG1: 8 subject spans x alternating verbs/objects
    for i, s in enumerate(subjects):
        ex.append(_frame(
            (s, "ARG0"),
            ((verbs[i % len(verbs)],), "V"),
            (objects[i % len(objects)], "ARG1"),
        ))

    # 2) + ARGM-LOC tail: 6
    for i in range(6):
        ex.append(_frame(
            (subjects[i], "ARG0"),
            ((verbs[(i + 1) % len(verbs)],), "V"),
            (objects[(i + 2) % len(objects)], "ARG1"),
            (places[i % len(places)], "ARGM-LOC"),
        ))

    # 3) ARGM-TMP lead: 6 (single-word B- span at position 0)
    for i, tmp in enumerate(["today", "yesterday", "now"] * 2):
        ex.append(_frame(
            ((tmp,), "ARGM-TMP"),
            (subjects[(i + 3) % len(subjects)], "ARG0"),
            ((verbs[i % len(verbs)],), "V"),
            (objects[(i + 1) % len(objects)], "ARG1"),
        ))

    # 4) ARGM-MNR: 5
    for i, mnr in enumerate(["quickly", "gently", "slowly", "quickly", "gently"]):
        ex.append(_frame(
            (subjects[i], "ARG0"),
            ((mnr,), "ARGM-MNR"),
            ((verbs[(i + 2) % len(verbs)],), "V"),
            (objects[i % len(objects)], "ARG1"),
        ))

    # 5) ditransitive ARG2 recipient: 5 ("gives the ball to the girl")
    recipients = [("to", "the", "girl"), ("to", "the", "boy"),
                  ("to", "a", "woman"), ("to", "the", "man"),
                  ("to", "the", "dog")]
    for i in range(5):
        ex.append(_frame(
            (subjects[(i + 2) % len(subjects)], "ARG0"),
            (("gives",), "V"),
            (objects[(i + 3) % len(objects)], "ARG1"),
            (recipients[i], "ARG2"),
        ))

    # 6) ARG4 goal + ARGM-DIR: 4 ("carries the cup forward to the house")
    for i in range(4):
        ex.append(_frame(
            (subjects[(i + 1) % len(subjects)], "ARG0"),
            (("carries",), "V"),
            (objects[(i + 1) % len(objects)], "ARG1"),
            (("forward" if i % 2 == 0 else "away",), "ARGM-DIR"),
            (("to", "the", "house") if i % 2 == 0 else ("to", "the", "park"),
             "ARG4"),
        ))

    # 7) multi-predicate sentences: SAME words, two frames whose gold tags
    # differ only through the verb indicator — the hard fidelity case
    for s, o1, o2 in [
        (("the", "man"), ("the", "ball"), ("the", "cup")),
        (("the", "woman"), ("a", "car"), ("the", "bike")),
        (("the", "dog"), ("the", "cup"), ("a", "red", "ball")),
    ]:
        words1, v1, tags1 = _frame(
            (s, "ARG0"), (("holds",), "V"), (o1, "ARG1"),
            (("and",), ""), (("throws",), ""), (o2, ""),
        )
        # second frame over the same sentence: holds-clause outside,
        # throws-clause tagged (subject is shared ARG0)
        words2, v2, tags2 = _frame(
            (s, "ARG0"), (("holds",), ""), (o1, ""),
            (("and",), ""), (("throws",), "V"), (o2, "ARG1"),
        )
        assert words1 == words2
        ex.append((words1, v1, tags1))
        ex.append((words2, v2, tags2))

    # 8) frames with an O gap between predicate and argument: 4
    for i in range(4):
        ex.append(_frame(
            (subjects[i], "ARG0"),
            (("really",), ""),
            ((verbs[i % len(verbs)],), "V"),
            (objects[(i + 2) % len(objects)], "ARG1"),
            (places[(i + 1) % len(places)], "ARGM-LOC"),
        ))

    return ex


def golden_vocab() -> List[str]:
    """Wordpiece vocab covering every golden word whole (no subword
    splits), plus the BERT specials — deterministic order."""
    words = sorted({w for ws, _, _ in golden_examples() for w in ws})
    return ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words


if __name__ == "__main__":
    exs = golden_examples()
    roles = sorted({t[2:] for _, _, tags in exs for t in tags if t != "O"})
    multi = sum(
        1 for _, _, tags in exs if any(t.startswith("I-") for t in tags)
    )
    print(f"{len(exs)} golden frames, roles={roles}, "
          f"{multi} with multi-word (I-) spans, vocab={len(golden_vocab())}")
