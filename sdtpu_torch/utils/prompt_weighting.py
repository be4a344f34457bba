"""Weighted-prompt parsing — the community ``(word:1.3)`` emphasis syntax.

Beyond-reference capability (the reference passes prompts through
verbatim, ``pipeline.mojo:13``).  Grammar (the A1111/compel convention,
which LoRA-era prompt libraries expect — supporting it is what makes
community prompts portable):

* ``(text)`` — weight x1.1 per nesting level
* ``[text]`` — weight /1.1 per nesting level
* ``(text:1.5)`` — explicit weight for the bracketed span
* ``\\(`` ``\\)`` ``\\[`` ``\\]`` — literal brackets

The parser emits ``[(fragment, weight)]``; the tokenizer assigns each
fragment's weight to its BPE tokens (``bpe.py:encode_weighted``) and the
pipeline scales the encoded hidden states per token, renormalizing to the
unweighted per-row mean MAGNITUDE so overall conditioning strength is
preserved.  (A1111/lpw renormalize to the signed mean; that denominator
is a near-total cancellation for LayerNorm-final encoders and turns
reduction noise into a random scale — see
``pipeline.py:apply_token_weights``.)
"""

from __future__ import annotations

import re
from typing import List, Tuple

_TOKEN_RE = re.compile(
    r"""
    \\[\\()\[\]]      # escaped bracket or backslash -> literal
  | \(                # open emphasis
  | \[                # open de-emphasis
  | :\s*([+-]?[\d.]+)\s*\)   # ":1.5)" explicit-weight close
  | \)
  | \]
  | [^\\()\[\]:]+     # plain text run
  | :                 # a bare colon is just text
    """,
    re.VERBOSE,
)


def parse_prompt_attention(text: str) -> List[Tuple[str, float]]:
    """``"a (cat:1.5) [dog]"`` -> ``[("a ", 1.0), ("cat", 1.5),
    (" ", 1.0), ("dog", 1/1.1)]`` (adjacent equal-weight fragments
    merged).  Unbalanced opens are closed at end-of-string with their
    implicit x1.1 / /1.1."""
    res: List[List] = []
    round_pos: List[int] = []
    square_pos: List[int] = []

    def scale(from_pos: int, mult: float) -> None:
        for i in range(from_pos, len(res)):
            res[i][1] *= mult

    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0)
        explicit = m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_pos.append(len(res))
        elif tok == "[":
            square_pos.append(len(res))
        elif explicit is not None:
            if round_pos:
                scale(round_pos.pop(), float(explicit))
            else:  # stray ":1.5)" with no open paren: literal text
                res.append([tok, 1.0])
        elif tok == ")":
            if round_pos:
                scale(round_pos.pop(), 1.1)
            else:
                res.append([tok, 1.0])
        elif tok == "]":
            if square_pos:
                scale(square_pos.pop(), 1.0 / 1.1)
            else:
                res.append([tok, 1.0])
        else:
            res.append([tok, 1.0])
    for pos in round_pos:
        scale(pos, 1.1)
    for pos in square_pos:
        scale(pos, 1.0 / 1.1)
    if not res:
        return [("", 1.0)]
    merged: List[List] = [res[0]]
    for frag, w in res[1:]:
        if w == merged[-1][1]:
            merged[-1][0] += frag
        else:
            merged.append([frag, w])
    return [(frag, w) for frag, w in merged]
