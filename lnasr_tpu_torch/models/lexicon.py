"""Pronunciation lexicon.

The reference's ``Lexicon`` is a pure stub (``lnasr/lexicon.py:11-18``:
``__init__`` and ``map`` both ``pass``); this is the real component. A
lexicon maps words to pronunciation unit sequences (phones, or the word
itself for whole-word models) and, together with per-unit acoustic models,
composes each word into one left-to-right HMM for the decoder
(:mod:`lnasr_tpu_torch.models.decoder`). The port's own copy of the JAX
package's ``models/lexicon.py``.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple


class Lexicon(dict):
    """``word -> tuple of pronunciation units``.

    Construct from a dict, or parse the standard text format
    (``word unit1 unit2 ...`` per line, ``#``-comments) used by classic
    ASR lexica.
    """

    def __init__(self, entries: Optional[Mapping[str, Sequence[str]]] = None):
        super().__init__()
        if entries:
            for word, units in entries.items():
                self[word] = tuple(units)

    @classmethod
    def load(cls, filename: str) -> "Lexicon":
        lex = cls()
        with open(filename, "r", encoding="utf-8") as fp:
            for line in fp:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                lex[parts[0]] = tuple(parts[1:]) if len(parts) > 1 else (parts[0],)
        return lex

    def save(self, filename: str) -> None:
        with open(filename, "w", encoding="utf-8") as fp:
            for word, units in self.items():
                fp.write(f"{word} {' '.join(units)}\n")

    @classmethod
    def whole_word(cls, words: Sequence[str]) -> "Lexicon":
        """Each word pronounced as itself (whole-word acoustic models)."""
        return cls({w: (w,) for w in words})

    def map(self, word: str) -> Tuple[str, ...]:
        """Pronunciation units of ``word`` (the reference's stubbed method)."""
        return self[word]

    def units(self) -> List[str]:
        """All distinct pronunciation units, sorted."""
        out = set()
        for units in self.values():
            out.update(units)
        return sorted(out)
