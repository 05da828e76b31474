"""Text -> symbol-ID codec (reference: text/__init__.py:15-53).

``text_to_sequence`` produces the integer sequences that index the symbol
embedding table; IDs are byte-compatible with the reference so checkpoints
and filelists interoperate. ARPAbet sequences may be embedded in curly braces
("{HH AW1 S}" syntax).
"""

import re

from gantron_tpu_torch.text import cleaners as _cleaners_mod
from gantron_tpu_torch.text.symbols import symbols

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def text_to_sequence(text, cleaner_names):
    """Convert a text string to the list of symbol IDs it represents."""
    sequence = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence):
    """Inverse codec; ARPAbet symbols are re-wrapped in curly braces."""
    result = ""
    for symbol_id in sequence:
        s = _id_to_symbol.get(int(symbol_id))
        if s is None:
            continue
        if len(s) > 1 and s[0] == "@":
            s = "{%s}" % s[1:]
        result += s
    return result.replace("}{", " ")


def _clean_text(text, cleaner_names):
    for name in cleaner_names:
        cleaner = getattr(_cleaners_mod, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _symbols_to_sequence(syms):
    return [_symbol_to_id[s] for s in syms if _should_keep_symbol(s)]


def _arpabet_to_sequence(text):
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep_symbol(s):
    return s in _symbol_to_id and s != "_" and s != "~"
