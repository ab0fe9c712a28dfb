"""English number verbalization (the port's copy of
``caiman_asr_tpu/data/text/numbers.py``; reference: data/text/ito/numbers.py,
which wraps the ``inflect`` package; this is a self-contained equivalent).

Expands in order: currency with magnitude words ($3.5 million), commas in
numbers, currency ($ / £), times (3:05), decimals, ordinals, plain numbers.
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [
    (10**12, "trillion"), (10**9, "billion"), (10**6, "million"), (10**3, "thousand"),
]

_ORDINAL_MAP = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[rem] if rem else "")
    if n < 1000:
        hund, rem = divmod(n, 100)
        out = _ONES[hund] + " hundred"
        return out + (" " + number_to_words(rem) if rem else "")
    for value, name in _SCALE:
        if n >= value:
            major, rem = divmod(n, value)
            out = number_to_words(major) + " " + name
            return out + (" " + number_to_words(rem) if rem else "")
    return " ".join(number_to_words(int(d)) for d in str(n))  # very large


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORDINAL_MAP:
        last = _ORDINAL_MAP[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


_COMMA_NUM_RE = re.compile(r"([0-9][0-9\,]+[0-9])")
_DECIMAL_RE = re.compile(r"([0-9]+\.[0-9]+)")
_POUNDS_RE = re.compile(r"£([0-9\,]*[0-9]+)")
_DOLLARS_RE = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ORDINAL_RE = re.compile(r"([0-9]+)(st|nd|rd|th)")
_NUMBER_RE = re.compile(r"[0-9]+")
_TIME_RE = re.compile(r"\b([0-9]{1,2}):([0-9]{2})\b")
_MAGNITUDE_DOLLARS_RE = re.compile(
    r"\$([0-9]+(?:\.[0-9]+)?) (million|billion|trillion|thousand)"
)


def _expand_dollars_text(amount: str) -> str:
    parts = amount.split(".")
    if len(parts) > 2:
        return amount + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1].ljust(2, "0")[:2]) if len(parts) > 1 and parts[1] else 0
    d_unit = "dollar" if dollars == 1 else "dollars"
    c_unit = "cent" if cents == 1 else "cents"
    if dollars and cents:
        return f"{number_to_words(dollars)} {d_unit} {number_to_words(cents)} {c_unit}"
    if dollars:
        return f"{number_to_words(dollars)} {d_unit}"
    if cents:
        return f"{number_to_words(cents)} {c_unit}"
    return "zero dollars"


def _expand_time(m: re.Match) -> str:
    hours, minutes = int(m.group(1)), int(m.group(2))
    if minutes == 0:
        return f"{number_to_words(hours)} o'clock"
    if minutes < 10:
        return f"{number_to_words(hours)} oh {number_to_words(minutes)}"
    return f"{number_to_words(hours)} {number_to_words(minutes)}"


def _expand_decimal(m: re.Match) -> str:
    whole, frac = m.group(1).split(".")
    digits = " ".join(number_to_words(int(d)) for d in frac)
    return f"{number_to_words(int(whole))} point {digits}"


def verbalize_numbers(text: str) -> str:
    """Expand all numeric forms to words (reference normalize_numbers)."""
    text = _MAGNITUDE_DOLLARS_RE.sub(
        lambda m: f"{m.group(1)} {m.group(2)} dollars", text
    )
    text = _COMMA_NUM_RE.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _POUNDS_RE.sub(lambda m: f"{number_to_words(int(m.group(1)))} pounds", text)
    text = _DOLLARS_RE.sub(lambda m: _expand_dollars_text(m.group(1)), text)
    text = _TIME_RE.sub(_expand_time, text)
    text = _DECIMAL_RE.sub(_expand_decimal, text)
    text = _ORDINAL_RE.sub(lambda m: ordinal_to_words(int(m.group(1))), text)
    text = _NUMBER_RE.sub(lambda m: number_to_words(int(m.group(0))), text)
    return text
