"""BERT WordPiece tokenizer (self-contained, no network).

The port's own copy of xlxmert_tpu/data/tokenization.py: the pure-Python
implementation of bert-base-uncased tokenization (lowercase, accent
stripping, punctuation/CJK splitting, then greedy longest-match
wordpiece) with the reference's encoding convention. The JAX package's
tests hold that module to transformers.BertTokenizer token for token;
tests/test_torch_serve_cli.py holds this copy to it.

The vocabulary is loaded from a standard `vocab.txt` (one token per line,
id = line number).
"""
from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List

import numpy as np


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens = text.split()
        out: List[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punct(tok))
        return [t for t in out if t]

    @staticmethod
    def _clean(text: str) -> str:
        return "".join(
            " " if _is_whitespace(c) else c
            for c in text
            if ord(c) != 0 and ord(c) != 0xFFFD and not _is_control(c))

    @staticmethod
    def _pad_cjk(text: str) -> str:
        return "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        out: List[List[str]] = []
        new_word = True
        for c in tok:
            if _is_punctuation(c):
                out.append([c])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(c)
        return ["".join(x) for x in out]


class WordpieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars = max_chars

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        out: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            out.append(cur)
            start = end
        return out


class Tokenizer:
    """Full BERT tokenizer with the reference's encoding convention:
    [CLS] tokens[:max-2] [SEP], padded with [PAD]=0
    (lxmert_data.py:27-41 / HF `tokenizer(sent, max_length, truncation)`)."""

    def __init__(self, vocab, do_lower_case: bool = True):
        if isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab: Dict[str, int] = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordpieceTokenizer(vocab)
        self.pad_id = vocab.get("[PAD]", 0)
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.unk_id = vocab.get("[UNK]")
        self.mask_id = vocab.get("[MASK]")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    def encode(self, text: str, max_length: int = 20) -> List[int]:
        toks = self.tokenize(text)[: max_length - 2]
        return ([self.cls_id] + self.convert_tokens_to_ids(toks)
                + [self.sep_id])

    def encode_batch(self, texts: List[str], max_length: int = 20) -> np.ndarray:
        """Fixed-shape (B, max_length) int32 id matrix, zero-padded —
        static shapes for jit (the reference pads dynamically per batch;
        SURVEY.md §7 static-shape discipline)."""
        out = np.full((len(texts), max_length), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, max_length)
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids: Iterable[int]) -> str:
        toks = [self.ids_to_tokens.get(int(i), "[UNK]") for i in ids]
        return " ".join(toks).replace(" ##", "")
