"""Chinese word segmentation as a 4-state HMM.

The port of the JAX package's ``models/seg.py``. States are B/M/E/S
(begin/middle/end/single), observations are unicode code points (65,536
symbols). Training is supervised count estimation over space-segmented
corpora (:meth:`HMM.from_counts`, float64); decoding is the Viterbi scan
of the discrete HMM.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.models.hmm import HMM
from lnasr_tpu_torch.utils.text import PUNCTUATION_UNICODE

STATES = "BMES"
STATE_INDEX = {s: i for i, s in enumerate(STATES)}
N_SYMBOLS = 65536


class SegDataSet:
    """Auto-labels space-segmented corpora with B/M/E/S states from the
    types of each character's neighbours."""

    TYPE_LEFT, TYPE_SPACE, TYPE_PUNCT, TYPE_CHAR, TYPE_RIGHT = range(5)

    # rows: previous char type; cols: next char type (for TYPE_CHAR chars)
    STATE_TABLE = [
        " SSBS",  # prev = left boundary
        " SSBS",  # prev = space
        " SSBS",  # prev = punctuation
        " EEME",  # prev = character
    ]

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def char_type(cls, ch: str) -> int:
        if ch == " ":
            return cls.TYPE_SPACE
        if ch in PUNCTUATION_UNICODE:
            return cls.TYPE_PUNCT
        return cls.TYPE_CHAR

    @classmethod
    def mark(cls, line: str) -> Dict[str, str]:
        """Label one space-segmented line -> {'data': chars, 'state': BMES}."""
        text = ""
        state = ""
        n = len(line)
        for k, ch in enumerate(line):
            ctype = cls.char_type(ch)
            if ctype == cls.TYPE_PUNCT:
                text += ch
                state += "S"
            elif ctype == cls.TYPE_CHAR:
                prev_t = cls.TYPE_LEFT if k == 0 else cls.char_type(line[k - 1])
                next_t = cls.TYPE_RIGHT if k == n - 1 else cls.char_type(line[k + 1])
                text += ch
                state += cls.STATE_TABLE[prev_t][next_t]
        return {"data": text, "state": state}

    def __iter__(self) -> Iterator[Dict[str, str]]:
        with open(self.path, "r", encoding="utf-8") as fp:
            for line in fp:
                line = line.strip()
                if len(line) > 1:
                    yield self.mark(line)


class Seg:
    """HMM word segmenter with supervised count training, on one device
    (CUDA by default)."""

    def __init__(self, model: Optional[HMM] = None, device="cuda"):
        self.model = model
        self.device = resolve_device(device)

    @staticmethod
    def _encode(text: str) -> np.ndarray:
        return np.fromiter((ord(c) for c in text), dtype=np.int64, count=len(text))

    @staticmethod
    def _encode_states(state: str) -> np.ndarray:
        return np.fromiter((STATE_INDEX[s] for s in state), dtype=np.int64, count=len(state))

    def train(self, samples: Iterable[Dict[str, str]]) -> "Seg":
        """Accumulate transition, emission and initial counts over labelled
        samples, then normalize (add-one smoothing on the emissions)."""
        trans = np.zeros((4, 4), np.float64)
        emit = np.zeros((4, N_SYMBOLS), np.float64)
        init = np.zeros(4, np.float64)
        for sample in samples:
            codes = self._encode(sample["data"])
            states = self._encode_states(sample["state"])
            if len(codes) == 0:
                continue
            np.add.at(trans, (states[:-1], states[1:]), 1.0)
            np.add.at(emit, (states, codes), 1.0)
            init[states[0]] += 1.0
        self.model = HMM.from_counts(trans, emit, init, emit_add_one=True, device=self.device)
        return self

    def segment_states(self, text: str) -> str:
        """Decode the B/M/E/S state string for ``text``."""
        if not text:
            return ""
        path = self.model.decode(self._encode(text)).cpu().numpy()
        return "".join(STATES[i] for i in path)

    def segment(self, text: str) -> List[str]:
        """Split ``text`` into words at E/S boundaries."""
        states = self.segment_states(text)
        words: List[str] = []
        current = ""
        for ch, st in zip(text, states):
            current += ch
            if st in ("E", "S"):
                words.append(current)
                current = ""
        if current:
            words.append(current)
        return words

    def save(self, filename: str) -> None:
        self.model.save(filename)

    def load(self, filename: str) -> "Seg":
        """Load a model file of either package (float32, as the JAX
        package's ``Seg.load``)."""
        self.model = HMM(device=self.device).load(filename)
        return self


def render_segmentation(data: str, state: str) -> Tuple[str, str]:
    """Text and its BMES labels with spaces at word boundaries, the labels
    padded under double-width (CJK) characters."""
    widths = [
        (126, 1), (159, 0), (687, 1), (710, 0), (711, 1), (727, 0), (733, 1),
        (879, 0), (1154, 1), (1161, 0), (4347, 1), (4447, 2), (7467, 1),
        (7521, 0), (8369, 1), (8426, 0), (9000, 1), (9002, 2), (11021, 1),
        (12350, 2), (12351, 1), (12438, 2), (12442, 0), (19893, 2), (19967, 1),
        (55203, 2), (63743, 1), (64106, 2), (65039, 1), (65059, 0), (65131, 2),
        (65279, 1), (65376, 2), (65500, 1), (65510, 2), (120831, 1),
        (262141, 2), (1114109, 1),
    ]

    def char_width(o: int) -> int:
        if o in (0xE, 0xF):
            return 0
        for bound, width in widths:
            if o <= bound:
                return width
        return 1

    out_text = ""
    out_state = ""
    for ch, st in zip(data, state):
        out_text += ch
        out_state += st
        if st in ("E", "S"):
            out_text += " "
            out_state += " "
        if char_width(ord(ch)) == 2:
            out_state += " "
    return out_text, out_state
