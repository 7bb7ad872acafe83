"""Optional text normalization applied before encoding.

A copy of ``retrieval_scaling_tpu/utils/text_normalize.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_pipeline.py`` holds it to
the original.

Behavioral analog of the reference's vendored normalizer
(reference: contriever/src/normalize_text.py, applied at
src/embed.py:36,55 and src/search.py:72-73 behind the ``normalize_text``
flag): unicode canonicalization, quote/dash/whitespace unification, and
accent stripping.
"""

from __future__ import annotations

import re
import unicodedata

_QUOTES = {
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
    "´": "'", "`": "'", "«": '"', "»": '"',
}
_DASHES = {"‐": "-", "‑": "-", "‒": "-", "–": "-", "—": "-", "―": "-"}
_WS_RE = re.compile(r"\s+")


def strip_accents(text: str) -> str:
    decomposed = unicodedata.normalize("NFD", text)
    return "".join(c for c in decomposed if unicodedata.category(c) != "Mn")


def normalize(text: str) -> str:
    text = unicodedata.normalize("NFC", text)
    for src, dst in _QUOTES.items():
        text = text.replace(src, dst)
    for src, dst in _DASHES.items():
        text = text.replace(src, dst)
    text = strip_accents(text)
    return _WS_RE.sub(" ", text).strip()
