"""The CLIP BPE encoder of ``native/tokenizer.cpp`` over ctypes.

Counterpart of ``sdtpu/tokenizer/native.py``, over the native library of
``utils/native_safetensors.py`` (built on first use into ``build/``).  As
in the JAX package, ASCII text padded to a ``max_length`` takes the native
path and any other text (or an unpadded encode) takes the port's
``tokenizer/bpe.py``, the oracle the native path is tested against token
for token.  A library that does not build, vocabulary files it cannot
read, or a token it does not know raise: nothing falls back quietly.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

from sdtpu_torch.tokenizer.bpe import CLIPTokenizer
from sdtpu_torch.utils.native_safetensors import load_library


class NativeCLIPTokenizer:
    """:meth:`CLIPTokenizer.encode` with a native path for ASCII text."""

    def __init__(self, vocab_file: str, merges_file: str):
        self.fallback = CLIPTokenizer.from_files(vocab_file, merges_file)
        self._lib = load_library()
        handle = self._lib.sdtpu_tokenizer_create(os.fsencode(vocab_file),
                                                  os.fsencode(merges_file))
        if not handle:
            raise OSError(f"the native tokenizer cannot read {vocab_file} / {merges_file}")
        self._handle = ctypes.c_void_p(handle)

    @property
    def native_available(self) -> bool:
        return self._handle is not None

    @property
    def bos_id(self) -> int:
        return self.fallback.bos_id

    @property
    def eos_id(self) -> int:
        return self.fallback.eos_id

    def encode(self, text: str, *, max_length: Optional[int] = 77,
               pad: bool = True) -> List[int]:
        if not (text.isascii() and max_length is not None and pad):
            return self.fallback.encode(text, max_length=max_length, pad=pad)
        buf = (ctypes.c_int64 * max_length)()
        n = self._lib.sdtpu_tokenizer_encode(self._handle, text.encode(), buf, max_length)
        if n <= 0:
            raise ValueError(f"the native tokenizer met a symbol not in its vocabulary: {text!r}")
        return list(buf[:n])

    def decode(self, ids, **kw) -> str:
        return self.fallback.decode(ids, **kw)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.sdtpu_tokenizer_destroy(self._handle)
            self._handle = None
