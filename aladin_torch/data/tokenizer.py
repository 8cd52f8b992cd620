"""BERT WordPiece tokenizer (host-side, dependency-free).

The reference tokenizes with the vendored pytorch_transformers BertTokenizer
loaded from the OSCAR checkpoint dir (ref:alad/train.py:211-212). This is a
from-scratch implementation of the same algorithm - basic tokenization
(cleaning, CJK spacing, lowercasing + accent stripping, punctuation splits)
followed by greedy longest-match WordPiece - verified against HuggingFace's
BertTokenizer in tests.

Tokenization is pure host-side preprocessing; ids enter the device path as
int32 arrays. A copy of aladin_tpu/data/tokenizer.py without the native C++
fast path (not ported yet): every call takes the pure-Python tokenizer.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, Iterable, List

NEVER_SPLIT = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
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
    # ASCII ranges treated as punctuation even when unicode disagrees ($, ^, `)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True, never_split: Iterable[str] = NEVER_SPLIT):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split)

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        out: List[str] = []
        for tok in text.split():
            if tok in self.never_split:
                out.append(tok)
                continue
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            out.extend(self._split_punct(tok))
        return " ".join(out).split()

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _space_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text) if unicodedata.category(ch) != "Mn"
        )

    def _split_punct(self, tok: str) -> List[str]:
        if tok in self.never_split:
            return [tok]
        out: List[List[str]] = []
        new_word = True
        for ch in tok:
            if _is_punctuation(ch):
                out.append([ch])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(ch)
        return ["".join(x) for x in out]


class WordpieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]", max_chars: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars = max_chars

    def tokenize(self, token: str) -> List[str]:
        if len(token) > self.max_chars:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces


def encode_trunc_any(tok, text: str, max_tokens: int) -> List[int]:
    """First ``max(0, max_tokens)`` WordPiece ids of ``text`` through ANY
    BERT-style tokenizer — the single shared tensorizer hot-path entry
    (DisentangledTensorizer, CaptionTensorizer, decode_inputs). Dispatches
    to the tokenizer's fast ``encode_trunc`` when it has one; otherwise
    tokenize -> truncate -> ids. The clamp matters: joint tensorizers can
    compute a negative remaining-room budget, which must mean 'no tokens',
    not Python's take-all-but-the-tail slice."""
    if max_tokens <= 0:
        return []
    if hasattr(tok, "encode_trunc"):
        return tok.encode_trunc(text, max_tokens)
    return tok.convert_tokens_to_ids(tok.tokenize(text)[:max_tokens])


class BertWordPieceTokenizer:
    """Drop-in equivalent of BertTokenizer for the data path.

    ``from_pretrained`` reads ``vocab.txt`` from an OSCAR checkpoint dir,
    matching the reference's tokenizer source (ref:alad/train.py:211-212).
    """

    cls_token = "[CLS]"
    sep_token = "[SEP]"
    pad_token = "[PAD]"
    unk_token = "[UNK]"
    mask_token = "[MASK]"

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True):
        self.vocab = vocab
        self.basic = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece = WordpieceTokenizer(vocab)

    @classmethod
    def from_pretrained(cls, dir_or_file: str, do_lower_case: bool = True):
        path = dir_or_file
        if os.path.isdir(path):
            path = os.path.join(path, "vocab.txt")
        return cls(load_vocab(path), do_lower_case=do_lower_case)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        """Matches pytorch_transformers: unknown entries (including non-str
        artifacts like the reference's int-0 CLS-slot bug, SURVEY-noted) map
        to [UNK]."""
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) if isinstance(t, str) else unk for t in tokens]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def encode_trunc(self, text: str, max_tokens: int) -> List[int]:
        """First ``max_tokens`` WordPiece ids of ``text`` — equivalent to
        ``tokenize()[:max_tokens]`` converted to ids (greedy WordPiece is
        left-to-right, so id-level and token-level truncation coincide).
        This is the tensorizer hot path."""
        if max_tokens <= 0:  # callers may compute a non-positive budget
            return []
        return self.convert_tokens_to_ids(self.tokenize(text)[:max_tokens])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
