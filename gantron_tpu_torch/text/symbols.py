"""Symbol table for text input.

Byte-compatible with the reference table (reference: text/symbols.py:9-18):
pad ``_``, special ``-``, punctuation, ASCII letters, then ARPAbet phonemes
prefixed with ``@``. Symbol *indices* feed the embedding table, so the order
must never change.
"""

from gantron_tpu_torch.text.cmudict import valid_symbols

_pad = "_"
_punctuation = "!'(),.:;? "
_special = "-"
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

# "@" prefix keeps ARPAbet symbols distinct from uppercase letters.
_arpabet = ["@" + s for s in valid_symbols]

symbols = [_pad] + list(_special) + list(_punctuation) + list(_letters) + _arpabet
