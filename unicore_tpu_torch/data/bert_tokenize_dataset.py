"""WordPiece tokenization view over a dataset of raw strings (counterpart
of ``unicore_tpu/data/bert_tokenize_dataset.py``).

The JAX package tokenizes with ``tokenizers.BertWordPieceTokenizer(vocab,
lowercase=True)``, a package the machine with the card does not have.
:class:`BertWordPieceTokenizer` here is the same function in pure Python,
with no feature added:

- the vocabulary is the file's lines, id = line number;
- special tokens of the vocabulary ([UNK], [SEP], [CLS], [PAD], [MASK])
  that occur verbatim in the text are split out first and map to their ids;
- the rest is normalized as BERT's normalizer does with ``lowercase=True``:
  control characters dropped, whitespace to spaces, CJK ideographs padded
  with spaces, lower case, accents stripped (NFD, combining marks removed);
- then split on whitespace and around every punctuation character;
- each word becomes greedy longest-match-first WordPiece pieces (``##``
  continuations); a word with an unmatchable remainder, or of more than
  100 characters, becomes [UNK];
- [CLS] ... [SEP] is added, and the dataset view truncates the ids to
  ``max_seq_len`` afterwards, exactly as the JAX view slices them.
"""

import re
import unicodedata
from typing import Dict, List

import numpy as np

from .base_wrapper_dataset import BaseWrapperDataset

_SPECIALS = ("[UNK]", "[SEP]", "[CLS]", "[PAD]", "[MASK]")
_MAX_WORD_CHARS = 100


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch) in ("Cc", "Cf", "Cn", "Co")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class BertWordPieceTokenizer:
    """``tokenizers.BertWordPieceTokenizer(vocab_path, lowercase=True)``'s
    ``encode(text).ids`` in pure Python."""

    def __init__(self, vocab_path: str):
        vocab: Dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f.read().splitlines()):
                vocab[line.rstrip()] = i
        self.vocab = vocab
        self.unk_id = vocab["[UNK]"]
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        specials = [t for t in _SPECIALS if t in vocab]
        self._special_re = re.compile(
            "(" + "|".join(re.escape(t) for t in specials) + ")"
        )

    @staticmethod
    def _normalize(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_whitespace(ch):
                out.append(" ")
            elif _is_cjk(cp):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        text = "".join(out).lower()
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _pre_tokenize(text: str) -> List[str]:
        words = []
        for chunk in text.split():
            cur = []
            for ch in chunk:
                if _is_punctuation(ch):
                    if cur:
                        words.append("".join(cur))
                        cur = []
                    words.append(ch)
                else:
                    cur.append(ch)
            if cur:
                words.append("".join(cur))
        return words

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > _MAX_WORD_CHARS:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    piece = self.vocab[sub]
                    break
                end -= 1
            if piece is None:
                return [self.unk_id]
            ids.append(piece)
            start = end
        return ids

    def encode_ids(self, text: str) -> List[int]:
        ids = [self.cls_id]
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self.vocab and part in _SPECIALS:
                ids.append(self.vocab[part])
                continue
            for word in self._pre_tokenize(self._normalize(part)):
                ids.extend(self._wordpiece(word))
        ids.append(self.sep_id)
        return ids


class BertTokenizeDataset(BaseWrapperDataset):
    def __init__(self, dataset, dict_path: str, max_seq_len: int = 512):
        super().__init__(dataset)
        self.tokenizer = BertWordPieceTokenizer(dict_path)
        self.max_seq_len = max_seq_len

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return True  # tokenization is epoch-independent

    def __getitem__(self, index: int):
        text = self.dataset[index].replace("<unk>", "[UNK]")
        ids = np.asarray(self.tokenizer.encode_ids(text), dtype=np.int64)
        return ids[: self.max_seq_len]
