"""ASCII transliteration (replacement for the ``unidecode`` dependency).

The reference cleaners call ``unidecode`` (reference: text/cleaners.py:64-65)
to fold arbitrary Unicode to ASCII before symbol lookup. This module covers
the cases that occur in speech-corpus text: Latin diacritics via NFKD
decomposition plus an explicit map for typographic punctuation and a few
common non-decomposable letters.
"""

import unicodedata

# Characters NFKD cannot fold, mapped the way unidecode does.
_CHAR_MAP = {
    "‘": "'", "’": "'", "‚": ",", "‛": "'",
    "“": '"', "”": '"', "„": '"',
    "–": "-", "—": "--", "―": "--", "−": "-",
    "…": "...",
    " ": " ", "«": '"', "»": '"',
    "ß": "ss", "æ": "ae", "Æ": "AE",
    "ø": "o", "Ø": "O", "œ": "oe", "Œ": "OE",
    "ð": "d", "Ð": "D", "þ": "th", "Þ": "Th",
    "đ": "d", "Đ": "D", "ł": "l", "Ł": "L",
    "£": "£",  # pound sign is consumed by the number expander first
}


def ascii_fold(text: str) -> str:
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        if ch in _CHAR_MAP:
            out.append(_CHAR_MAP[ch])
            continue
        folded = unicodedata.normalize("NFKD", ch)
        folded = folded.encode("ascii", "ignore").decode("ascii")
        out.append(folded)
    return "".join(out)
