"""BERT's uncased WordPiece tokenizer for words already split (the
``is_split_into_words=True`` path of ``transformers.BertTokenizerFast``
that the reference tagger and its trainer take).

Each word goes through the steps of the fast tokenizer, in its order:

  1. the special tokens of the vocab (``[CLS]``, ``[SEP]``, ``[PAD]``,
     ``[UNK]``, ``[MASK]``) are cut out of the raw word and kept whole;
  2. the rest is normalised: control characters (Unicode ``C*`` but tab,
     newline and carriage return) and U+0000 / U+FFFD dropped, whitespace
     made a space, CJK ideographs set apart by spaces, accents stripped
     (NFD, then every ``Mn`` dropped) and the text lower-cased a
     character at a time;
  3. it is split on whitespace, and every punctuation character (Unicode
     ``P*`` and the ASCII symbols ``$+<=>^`|~``) stands alone;
  4. each piece is matched greedily, longest first, against the vocab,
     later pieces with ``##``; a piece of more than 100 characters, or one
     with no match, is one ``[UNK]``.

A sequence is ``[CLS]`` + the words' pieces (cut to ``max_length - 2``)
+ ``[SEP]``; ``word_ids`` gives each position's word (None for the two
specials).  The files are the ones ``save_pretrained`` writes:
``vocab.txt`` and ``tokenizer_config.json`` (``do_lower_case``,
``strip_accents``, ``tokenize_chinese_chars``); ``save`` writes both so
that ``transformers.AutoTokenizer`` loads them.
"""

from __future__ import annotations

import json
import re
import unicodedata
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
MAX_CHARS = 100  # a longer piece is one [UNK]
ASCII_PUNCT = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
              (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(c: str) -> bool:
    o = ord(c)
    return any(lo <= o <= hi for lo, hi in CJK_RANGES)


def _is_punct(c: str) -> bool:
    return c in ASCII_PUNCT or (c > "\x7f" and unicodedata.category(c).startswith("P"))


@dataclass
class Encoding:
    """One sequence: ``input_ids`` and ``attention_mask`` (lists of
    ints) and ``word_ids`` (the word of each position, None for
    ``[CLS]`` / ``[SEP]``)."""

    input_ids: List[int]
    attention_mask: List[int]
    word_ids: List[Optional[int]]


class WordPieceTokenizer:
    def __init__(self, vocab: Sequence[str], do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None, tokenize_chinese_chars: bool = True):
        self.vocab: Dict[str, int] = {}
        for i, tok in enumerate(vocab):
            self.vocab[tok] = i  # a repeated token keeps its last line, as BertTokenizer reads it
        self.tokens = list(vocab)
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        for s in ("[UNK]", "[CLS]", "[SEP]"):
            if s not in self.vocab:
                raise ValueError(f"vocab has no {s}")
        specials = sorted((s for s in SPECIALS if s in self.vocab), key=len, reverse=True)
        self._special_re = re.compile("(" + "|".join(re.escape(s) for s in specials) + ")")

    @property
    def unk_id(self) -> int:
        return self.vocab["[UNK]"]

    @property
    def pad_id(self) -> int:
        return self.vocab.get("[PAD]", 0)

    # -- normalisation and pre-tokenisation --------------------------------
    def normalize(self, text: str) -> str:
        if text.isascii() and text.isprintable():  # no controls, accents or CJK: case alone
            return text.lower() if self.do_lower_case else text
        out = []
        for c in text:
            if c in ("\x00", "\ufffd") or (c not in "\t\n\r" and unicodedata.category(c).startswith("C")):
                continue
            if c in "\t\n\r" or unicodedata.category(c) in ("Zs", "Zl", "Zp"):
                out.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(c):
                out.append(f" {c} ")
            else:
                out.append(c)
        text = "".join(out)
        strip = self.do_lower_case if self.strip_accents is None else self.strip_accents
        if strip:
            text = "".join(c for c in unicodedata.normalize("NFD", text) if unicodedata.category(c) != "Mn")
        if self.do_lower_case:
            text = "".join(c.lower() for c in text)
        return text

    @staticmethod
    def pre_tokenize(text: str) -> List[str]:
        pieces: List[str] = []
        for chunk in text.split():
            cur = ""
            for c in chunk:
                if _is_punct(c):
                    if cur:
                        pieces.append(cur)
                    pieces.append(c)
                    cur = ""
                else:
                    cur += c
            if cur:
                pieces.append(cur)
        return pieces

    def wordpiece(self, piece: str) -> List[int]:
        if len(piece) > MAX_CHARS:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(piece):
            end = len(piece)
            while start < end:
                sub = piece[start:end] if start == 0 else "##" + piece[start:end]
                if sub in self.vocab:
                    ids.append(self.vocab[sub])
                    break
                end -= 1
            if start == end:
                return [self.unk_id]
            start = end
        return ids

    def word_pieces(self, word: str) -> List[int]:
        """The ids of one word (special tokens cut out first)."""
        ids: List[int] = []
        for part in self._special_re.split(word):
            if part in self.vocab and part in SPECIALS:
                ids.append(self.vocab[part])
            elif part:
                for piece in self.pre_tokenize(self.normalize(part)):
                    ids.extend(self.wordpiece(piece))
        return ids

    def encode_words(self, words: Sequence[str], max_length: Optional[int] = None) -> Encoding:
        """``[CLS]`` + the pieces of ``words`` + ``[SEP]``, the pieces cut
        to ``max_length - 2`` (``truncation=True``)."""
        ids: List[int] = []
        wids: List[Optional[int]] = []
        for w, word in enumerate(words):
            p = self.word_pieces(word)
            ids += p
            wids += [w] * len(p)
        if max_length is not None:
            keep = max(max_length - 2, 0)
            ids, wids = ids[:keep], wids[:keep]
        ids = [self.vocab["[CLS]"]] + ids + [self.vocab["[SEP]"]]
        wids = [None] + wids + [None]
        return Encoding(ids, [1] * len(ids), wids)

    # -- files -------------------------------------------------------------
    @classmethod
    def from_dir(cls, model_dir: str | Path) -> "WordPieceTokenizer":
        """``vocab.txt`` and, where present, ``tokenizer_config.json``."""
        model_dir = Path(model_dir)
        with open(model_dir / "vocab.txt", encoding="utf-8") as f:
            vocab = [ln.rstrip("\n") for ln in f]
        cfg = {}
        if (model_dir / "tokenizer_config.json").exists():
            with open(model_dir / "tokenizer_config.json") as f:
                cfg = json.load(f)
        return cls(vocab, do_lower_case=cfg.get("do_lower_case", True),
                   strip_accents=cfg.get("strip_accents"),
                   tokenize_chinese_chars=cfg.get("tokenize_chinese_chars", True))

    def save(self, out_dir: str | Path) -> None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "vocab.txt", "w", encoding="utf-8") as f:
            f.write("\n".join(self.tokens) + "\n")
        specials = {k: s for k, s in (("unk_token", "[UNK]"), ("sep_token", "[SEP]"), ("pad_token", "[PAD]"),
                                      ("cls_token", "[CLS]"), ("mask_token", "[MASK]")) if s in self.vocab}
        cfg = {"tokenizer_class": "BertTokenizer", "do_lower_case": self.do_lower_case,
               "strip_accents": self.strip_accents, "tokenize_chinese_chars": self.tokenize_chinese_chars,
               "do_basic_tokenize": True, "never_split": None, **specials}
        with open(out_dir / "tokenizer_config.json", "w") as f:
            json.dump(cfg, f, indent=2)
        with open(out_dir / "special_tokens_map.json", "w") as f:
            json.dump(specials, f, indent=2)
