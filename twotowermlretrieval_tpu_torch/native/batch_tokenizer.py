"""ctypes wrapper: numpy-in / numpy-out native batch tokenization (the
port's copy of the JAX package's ``native/batch_tokenizer.py``)."""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np

from twotowermlretrieval_tpu_torch.native import get_lib

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _blob(items: List[bytes]) -> Tuple[bytes, np.ndarray]:
    """The byte strings concatenated, and their n+1 int64 offsets."""
    offsets = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(b) for b in items], out=offsets[1:])
    return b"".join(items), offsets


class NativeVocab:
    """A C++ hash-map vocabulary bound to the native encode_batch."""

    def __init__(self, word_to_idx: Dict[str, int], unk_id: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native tokenizer library unavailable")
        self._lib = lib
        blob, offsets = _blob([word.encode("utf-8") for word in word_to_idx])
        ids = np.fromiter(word_to_idx.values(), np.int32, len(word_to_idx))
        self._handle = lib.vocab_create(blob, offsets.ctypes.data_as(_I64P),
                                        ids.ctypes.data_as(_I32P), len(ids), unk_id)
        if not self._handle:
            raise RuntimeError("vocab_create failed")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.vocab_free(self._handle)
            self._handle = None

    def size(self) -> int:
        return int(self._lib.vocab_size(self._handle))

    def encode_batch(
        self, texts: Sequence[str], max_len: int, pad_id: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (tokens [B, max_len] int32 pad-filled, lengths [B] int32,
        ok [B] uint8: rows with ok=0 must be re-encoded in Python)."""
        blob, offsets = _blob([str(t).encode("utf-8", errors="surrogatepass") for t in texts])
        n = len(offsets) - 1
        tokens = np.full((n, max_len), pad_id, np.int32)
        lengths = np.zeros(n, np.int32)
        ok = np.zeros(n, np.uint8)
        self._lib.encode_batch(
            self._handle, blob, offsets.ctypes.data_as(_I64P), n, max_len, pad_id,
            tokens.ctypes.data_as(_I32P), lengths.ctypes.data_as(_I32P),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return tokens, lengths, ok
