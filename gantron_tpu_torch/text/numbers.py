"""Number verbalization (digits/ordinals/currency -> words).

Functional equivalent of the reference text/numbers.py:64-71, which delegates
to the ``inflect`` package (not available here). The verbalizer below
re-implements the subset of inflect semantics the cleaners rely on:

  * cardinals with an optional "and" word and ", "-separated scale groups,
  * ordinal suffix handling ("101st" -> "one hundred and first"),
  * two-digit grouping with zero="oh" for year-like numbers
    (2047 -> "twenty forty-seven", 1904 -> "nineteen oh four").
"""

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = ["", " thousand", " million", " billion", " trillion",
           " quadrillion", " quintillion"]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n, zero="zero"):
    """Words for 0 <= n < 100."""
    if n == 0:
        return zero
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones == 0:
        return _TENS[tens]
    return _TENS[tens] + "-" + _ONES[ones]


def _three_digits(n, andword):
    """Words for 1 <= n < 1000."""
    hundreds, rest = divmod(n, 100)
    if hundreds == 0:
        return _two_digits(rest)
    out = _ONES[hundreds] + " hundred"
    if rest:
        sep = f" {andword} " if andword else " "
        out += sep + _two_digits(rest)
    return out


def number_to_words(num, andword="and", zero="zero", group=0):
    """Convert an int (or digit string, optionally with an ordinal suffix)."""
    if isinstance(num, str):
        m = re.fullmatch(r"([0-9]+)(st|nd|rd|th)", num)
        if m:
            return _ordinalize(number_to_words(int(m.group(1)), andword=andword))
        num = int(num)

    if group == 2:
        digits = str(num)
        if len(digits) % 2 == 1:
            digits = "0" + digits
        chunks = [digits[i:i + 2] for i in range(0, len(digits), 2)]
        words = []
        for chunk in chunks:
            n = int(chunk)
            if n == 0:
                words.append(f"{zero} {zero}")
            elif n < 10 and chunk[0] == "0":
                words.append(f"{zero} {_ONES[n]}")
            else:
                words.append(_two_digits(n))
        return ", ".join(words)

    if num == 0:
        return zero

    groups = []  # list of (scale_index, 0 <= value < 1000), most significant first
    scale = 0
    while num > 0:
        num, rem = divmod(num, 1000)
        if rem:
            groups.append((scale, rem))
        scale += 1
    groups.reverse()

    parts = [_three_digits(value, andword) + _SCALES[scale]
             for scale, value in groups]
    if len(parts) > 1 and andword and groups[-1][0] == 0 and groups[-1][1] < 100:
        # "one thousand and five" rather than "one thousand, five"
        return ", ".join(parts[:-1]) + f" {andword} " + parts[-1]
    return ", ".join(parts)


def _ordinalize(words):
    """Convert the final word of a cardinal phrase to its ordinal form."""
    head, _, last = words.rpartition(" ")
    prefix, _, final = last.rpartition("-")
    if final in _ORDINAL_IRREGULAR:
        final = _ORDINAL_IRREGULAR[final]
    elif final.endswith("y"):
        final = final[:-1] + "ieth"
    else:
        final = final + "th"
    last = (prefix + "-" + final) if prefix else final
    return (head + " " + last) if head else last


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"  # unexpected format
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m):
    return number_to_words(m.group(0))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words(num, andword="", zero="oh",
                               group=2).replace(", ", " ")
    return number_to_words(num, andword="")


def normalize_numbers(text):
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
