"""User meta-tokens (<EOS>, <star>, ...) from a config's ``user_tokens:``
block (``caiman_asr_tpu/utils/user_tokens.py``).

A user token must look like ``<tag>``; the tokenizer was trained with it as
a user-defined piece, so it resolves to one id. The train step takes the ids
of ``eos`` and ``star`` (-1 when a config has none).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Union

_TAG_RE = re.compile(r"^<[^<>\s]+>$")


def is_tag(s: str) -> bool:
    return bool(_TAG_RE.match(s))


def get_all_user_tokens(user_tokens: Optional[dict]) -> Dict[str, str]:
    """The configured tokens by name, None entries dropped; raises on a
    token that is not ``<tag>``-shaped."""
    out = {}
    for k, v in (user_tokens or {}).items():
        if v is None:
            continue
        if not isinstance(v, str) or not is_tag(v):
            raise ValueError(f"user token {k}={v!r} must look like <tag>")
        out[k] = v
    return out


def get_user_token(name: str, user_tokens: Optional[dict],
                   tokenizer=None) -> Optional[Union[int, str]]:
    """The token's string, or its id when a tokenizer (``data/tokenizer``)
    is given; None when the config has no such token. Raises when the
    token does not tokenize to a single piece."""
    toks = get_all_user_tokens(user_tokens)
    if name not in toks:
        return None
    sym = toks[name]
    if tokenizer is None:
        return sym
    ids = tokenizer.tokenize(sym)
    # the piece itself is the last id (a word-marker piece may precede it)
    if not ids:
        raise ValueError(f"user token {name}={sym!r} is not in the vocab")
    piece = tokenizer.id_to_piece(ids[-1])
    if piece.lstrip("▁") != sym:
        raise ValueError(
            f"user token {name}={sym!r} does not tokenize to a single piece "
            f"(got {[tokenizer.id_to_piece(i) for i in ids]}); retrain the "
            "sentencepiece model with user_symbols including it"
        )
    return ids[-1]


def user_token_idx(name: str, user_tokens: Optional[dict], tokenizer) -> int:
    """The id ``make_train_step`` takes for ``name`` (``eos_idx``,
    ``star_idx``): -1 when the config has no such token or it does not
    resolve to one piece (then with a warning, as the JAX trainer does)."""
    try:
        idx = get_user_token(name, user_tokens, tokenizer)
    except ValueError as e:
        print(f"WARNING: user token '{name}' disabled: {e}")
        return -1
    return -1 if idx is None else idx
