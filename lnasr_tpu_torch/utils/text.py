"""Text constants shared by the tokenizer and the segmenter.

Same punctuation inventory as the reference (``lnasr/utils.py:13-49``);
the port's own copy of the JAX package's ``utils/text.py``.
"""

PUNCTUATION_ASCII = frozenset(".,?!\"':;()[]{}")

PUNCTUATION_UNICODE = frozenset(
    "。，？！：；、"
    "‘’“”—《》"
    "（）【】"
)
