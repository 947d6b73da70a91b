"""Symbol table mapping token strings to consecutive integer ids
(counterpart of ``unicore_tpu/data/dictionary.py``).

BERT-style special tokens ([CLS]/[PAD]/[SEP]/[UNK]), out-of-vocabulary
lookups resolving to unk, and the ``<symbol> <count>`` text-file round-trip
(including the ``#overwrite`` flag).
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)


class Dictionary:
    """Symbols are assigned ids in insertion order; lookups of unknown
    symbols return the unk id once unk has been registered."""

    def __init__(
        self,
        *,
        bos="[CLS]",
        pad="[PAD]",
        eos="[SEP]",
        unk="[UNK]",
        extra_special_symbols=None,
    ):
        self.bos_word = bos
        self.pad_word = pad
        self.eos_word = eos
        self.unk_word = unk
        self.symbols = []
        self.count = []
        self.indices = {}
        self.specials = {bos, pad, eos, unk}

    # -- container protocol -------------------------------------------------

    def __len__(self):
        return len(self.symbols)

    def __contains__(self, sym):
        return sym in self.indices

    def __getitem__(self, idx):
        """Id -> symbol; out-of-range ids render as the unk symbol."""
        return self.symbols[idx] if 0 <= idx < len(self.symbols) else self.unk_word

    def __eq__(self, other):
        return self.indices == other.indices

    # -- lookups ------------------------------------------------------------

    def index(self, sym):
        """Symbol -> id, falling back to unk for unregistered symbols."""
        assert isinstance(sym, str)
        idx = self.indices.get(sym)
        if idx is not None:
            return idx
        if self.unk_word not in self.indices:
            raise KeyError(
                f"'{sym}' not in dictionary and unk symbol "
                f"'{self.unk_word}' is missing too"
            )
        return self.unk()

    def vec_index(self, a):
        """Elementwise symbol -> id over an array of strings."""
        return np.vectorize(self.index)(a)

    def special_index(self):
        return [self.index(s) for s in self.specials]

    def bos(self):
        return self.index(self.bos_word)

    def pad(self):
        return self.index(self.pad_word)

    def eos(self):
        return self.index(self.eos_word)

    def unk(self):
        return self.index(self.unk_word)

    # -- construction -------------------------------------------------------

    def add_symbol(self, word, n=1, overwrite=False, is_special=False):
        """Register a symbol (or bump its count if already present and not
        overwriting); returns its id."""
        if is_special:
            self.specials.add(word)
        existing = self.indices.get(word)
        if existing is not None and not overwrite:
            self.count[existing] += n
            return existing
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.count.append(n)
        return idx

    # -- text-file round-trip ----------------------------------------------

    @classmethod
    def load(cls, f):
        """Build a dictionary from a ``<symbol> <count>``-per-line file."""
        d = cls()
        d.add_from_file(f)
        return d

    def add_from_file(self, f):
        """Merge symbols from a text file (path or open handle).

        Each line is ``<symbol> [<count>] [#overwrite]``; a missing count
        defaults to the line's distance from the end (preserving relative
        order as frequency).
        """
        if isinstance(f, str):
            try:
                with open(f, "r", encoding="utf-8") as fd:
                    self.add_from_file(fd)
            except UnicodeError:
                raise Exception(f"Incorrect encoding detected in {f}")
            return

        lines = f.readlines()
        for line_no, raw in enumerate(lines):
            word, _, field = raw.rstrip().rpartition(" ")
            if not word:
                word, field = field, str(len(lines) - line_no)
            overwrite = field == "#overwrite"
            if overwrite:
                word, _, field = word.rpartition(" ")
            try:
                n = int(field)
            except ValueError:
                raise ValueError(
                    "Incorrect dictionary format, expected "
                    "'<token> <cnt> [flags]'"
                )
            if word in self and not overwrite:
                logger.info(
                    f"Duplicate word found when loading Dictionary: "
                    f"'{word}', index is {self.indices[word]}."
                )
            else:
                self.add_symbol(word, n=n, overwrite=overwrite)

    def save(self, f):
        """Write ``<symbol> <count>`` lines (path or open handle)."""
        if isinstance(f, str):
            with open(f, "w", encoding="utf-8") as fd:
                return self.save(fd)
        for symbol, n in zip(self.symbols, self.count):
            print(f"{symbol} {n}", file=f)
