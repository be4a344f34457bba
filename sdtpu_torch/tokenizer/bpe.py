"""Exact CLIP BPE tokenizer, pure Python, host-side.

The reference approximates CLIP tokenization with a llama2.c-style
greedy-score pair merger over a repacked binary vocab
(``helpers/utils.mojo:228-327``, asset built by ``tokenizer_creation.py``)
and diverges from real CLIP in several ways it must not (SURVEY.md §5.1
item 8): spaces hand-replaced with ``</w>`` (``pipeline.mojo:39-40``), no
BOS/EOS, zero-padding, merge-rank bugs.  This module implements the actual
OpenAI CLIP algorithm — byte-to-unicode mapping, the CLIP split regex,
lowercasing + whitespace cleanup, rank-ordered BPE merges with ``</w>``
word-end markers, BOS/EOS framing and EOS padding — verified token-for-token
against HF ``transformers.CLIPTokenizer`` in tests.

Tokenization is OUTSIDE the jit boundary by design: it is string work that
belongs on the host; the device program starts at the (B, 77) int32 ids.
"""

from __future__ import annotations

import functools
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

BOS_TOKEN = "<|startoftext|>"
EOS_TOKEN = "<|endoftext|>"

# CLIP's split pattern; \p{L}/\p{N} rewritten for the stdlib re module:
# [^\W\d_] == unicode letters, \d == decimal digits, (?:_|[^\s\w])+ == runs
# of everything else that isn't whitespace.
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:_|[^\s\w])+",
    re.IGNORECASE,
)

_WHITESPACE = re.compile(r"\s+")


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable unicode char mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPTokenizer:
    """Vocab + ranked merges -> encode/decode.

    ``vocab`` maps token string -> id (including ``</w>`` variants and the
    special tokens); ``merges`` is the ordered merge list (rank = position).
    """

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_id = self.vocab[BOS_TOKEN]
        self.eos_id = self.vocab[EOS_TOKEN]
        self._bpe_cache: Dict[str, List[str]] = {}
        # textual-inversion placeholders: literal string -> id sequence,
        # matched before BPE (``add_placeholder``)
        self.placeholders: Dict[str, List[int]] = {}

    def add_placeholder(self, token: str, ids: List[int]) -> None:
        """Register a placeholder (e.g. a textual-inversion concept like
        ``<cat-toy>``) that encodes to ``ids`` verbatim, bypassing BPE.
        Matched case-insensitively, longest-first."""
        self.placeholders[token.lower()] = [int(i) for i in ids]

    # -- construction -----------------------------------------------------

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str) -> "CLIPTokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = []
        for line in lines:
            if not line or line.startswith("#version"):
                continue
            a, b = line.split()
            merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTokenizer":
        """Load from a local HF tokenizer directory: either
        ``vocab.json`` + ``merges.txt`` or a combined ``tokenizer.json``."""
        vj = os.path.join(path, "vocab.json")
        mt = os.path.join(path, "merges.txt")
        if os.path.exists(vj) and os.path.exists(mt):
            return cls.from_files(vj, mt)
        tj = os.path.join(path, "tokenizer.json")
        if os.path.exists(tj):
            with open(tj, encoding="utf-8") as f:
                data = json.load(f)
            model = data["model"]
            merges = [
                tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                for m in model["merges"]
            ]
            return cls(model["vocab"], merges)
        raise FileNotFoundError(
            f"no vocab.json+merges.txt or tokenizer.json under {path}"
        )

    @staticmethod
    def default_assets_dir() -> str:
        """Repo-level asset location written by ``tools/prepare_tokenizer.py``
        (override with ``$SDTPU_TOKENIZER_DIR``) — the analogue of the
        reference reading ``tokenizer_clip.bin`` next to the binary
        (``pipeline.mojo:32-34``)."""
        env = os.environ.get("SDTPU_TOKENIZER_DIR")
        if env:
            return env
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        )))
        return os.path.join(pkg_root, "assets", "tokenizer")

    @classmethod
    def from_default_assets(cls) -> Optional["CLIPTokenizer"]:
        """The installed asset tokenizer, or None when no assets exist (the
        offline environment without network/checkpoints)."""
        path = cls.default_assets_dir()
        try:
            return cls.from_pretrained(path)
        except FileNotFoundError:
            return None

    # -- core BPE ----------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if bigram not in self.ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = list(word)
        self._bpe_cache[token] = result
        return result

    def tokenize(self, text: str) -> List[str]:
        text = _WHITESPACE.sub(" ", text).strip().lower()
        out: List[str] = []
        for tok in _PAT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            out.extend(self._bpe(mapped))
        return out

    def _encode_body(self, text: str) -> List[int]:
        if not self.placeholders:
            return [self.vocab[t] for t in self.tokenize(text)]
        pattern = "|".join(
            re.escape(p)
            for p in sorted(self.placeholders, key=len, reverse=True)
        )
        ids: List[int] = []
        for part in re.split(f"({pattern})", text.lower()):
            if part in self.placeholders:
                ids += self.placeholders[part]
            elif part.strip():
                ids += [self.vocab[t] for t in self.tokenize(part)]
        return ids

    def encode(
        self,
        text: str,
        *,
        max_length: Optional[int] = 77,
        pad: bool = True,
    ) -> List[int]:
        """BOS + tokens + EOS, truncated to ``max_length`` (EOS kept last)
        and EOS-padded — the SD convention the reference's zero-padding
        breaks (``clip.mojo:90-92``)."""
        ids = [self.bos_id]
        ids += self._encode_body(text)
        if max_length is not None and len(ids) > max_length - 1:
            ids = ids[: max_length - 1]
        ids.append(self.eos_id)
        if pad and max_length is not None:
            ids += [self.eos_id] * (max_length - len(ids))
        return ids

    def encode_weighted(
        self,
        text: str,
        *,
        max_length: Optional[int] = 77,
        pad: bool = True,
    ):
        """Like :meth:`encode` but parses ``(word:1.3)`` emphasis syntax
        (``sdtpu_torch/utils/prompt_weighting.py``): returns ``(ids, weights)``
        with one float weight per id (BOS/EOS/padding weigh 1.0)."""
        from sdtpu_torch.utils.prompt_weighting import parse_prompt_attention

        ids = [self.bos_id]
        weights = [1.0]
        for frag, w in parse_prompt_attention(text):
            fids = self._encode_body(frag)
            ids += fids
            weights += [w] * len(fids)
        if max_length is not None and len(ids) > max_length - 1:
            ids = ids[: max_length - 1]
            weights = weights[: max_length - 1]
        ids.append(self.eos_id)
        weights.append(1.0)
        if pad and max_length is not None:
            n = max_length - len(ids)
            ids += [self.eos_id] * n
            weights += [1.0] * n
        return ids, weights

    def encode_long(
        self,
        text: str,
        *,
        window: int = 77,
        num_windows: Optional[int] = None,
    ) -> List[int]:
        """Chunked encoding for prompts longer than one CLIP window (the
        A1111/community "long prompt" scheme): body tokens are split into
        ``window - 2``-token chunks, each wrapped ``[BOS] chunk [EOS]`` and
        EOS-padded, then concatenated — the text encoder runs once per
        window (each with its own position embeddings) and the hidden
        states concatenate into a (n*window)-token cross-attention context.

        Returns ``n * window`` ids where n = ceil(len(body)/(window-2)),
        floored at 1 — so a short prompt returns exactly :meth:`encode`'s
        output.  ``num_windows`` forces n (padding with empty windows =
        ``[BOS] [EOS]...``, the uncond row): CFG and batching need cond and
        uncond rows chunked to the same length."""
        body = self._encode_body(text)
        cap = window - 2
        n = max(1, -(-len(body) // cap))
        if num_windows is not None:
            if num_windows < n:
                body = body[: num_windows * cap]
            n = num_windows
        ids: List[int] = []
        for k in range(n):
            chunk = body[k * cap: (k + 1) * cap]
            row = [self.bos_id] + chunk + [self.eos_id]
            row += [self.eos_id] * (window - len(row))
            ids += row
        return ids

    def encode_weighted_long(
        self,
        text: str,
        *,
        window: int = 77,
        num_windows: Optional[int] = None,
    ):
        """:meth:`encode_long` with ``(word:1.3)`` emphasis parsing:
        returns ``(ids, weights)`` spanning all windows (BOS/EOS/padding
        weigh 1.0)."""
        from sdtpu_torch.utils.prompt_weighting import parse_prompt_attention

        body: List[int] = []
        w_body: List[float] = []
        for frag, w in parse_prompt_attention(text):
            fids = self._encode_body(frag)
            body += fids
            w_body += [w] * len(fids)
        cap = window - 2
        n = max(1, -(-len(body) // cap))
        if num_windows is not None:
            if num_windows < n:
                body = body[: num_windows * cap]
                w_body = w_body[: num_windows * cap]
            n = num_windows
        ids: List[int] = []
        weights: List[float] = []
        for k in range(n):
            chunk = body[k * cap: (k + 1) * cap]
            w_chunk = w_body[k * cap: (k + 1) * cap]
            pad = window - 2 - len(chunk)
            ids += [self.bos_id] + chunk + [self.eos_id] * (pad + 1)
            weights += [1.0] + w_chunk + [1.0] * (pad + 1)
        return ids, weights

    def num_windows(self, text: str, *, window: int = 77) -> int:
        """How many CLIP windows :meth:`encode_long` would use for ``text``
        (serving buckets on this so coalesced rows share a shape)."""
        return max(1, -(-len(self._encode_body(text)) // (window - 2)))

    def decode(self, ids: Sequence[int], *, skip_special: bool = True) -> str:
        tokens = []
        for i in ids:
            tok = self.ids_to_tokens.get(int(i), "")
            if skip_special and tok in (BOS_TOKEN, EOS_TOKEN):
                continue
            tokens.append(tok)
        text = "".join(tokens).replace("</w>", " ")
        data = bytearray(self.byte_decoder.get(c, ord(" ")) for c in text)
        return data.decode("utf-8", errors="replace").strip()
