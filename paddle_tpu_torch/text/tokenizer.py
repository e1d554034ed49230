"""Tokenizers: native (C++) wordpiece with a pure-Python twin (a copy of
the reference's ``text/tokenizer.py`` and ``text/fast_tokenizer.cpp``).

The algorithm is BERT's BasicTokenizer + WordpieceTokenizer, the core of
PaddleNLP's faster_tokenizer.  The C++ library (``fast_tokenizer.cpp``) is
compiled with ``g++`` at first use (never at import) into the package's
git-ignored ``_build/`` directory and loaded through ctypes.  Where no
compiler is available the Python implementation serves the same ids (held
equal by the tests), so nothing hard-requires the native path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional

import numpy as np

__all__ = ["WordpieceTokenizer", "load_vocab", "native_available"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO_PATH = os.path.join(os.path.dirname(_HERE), "_build",
                        "libfast_tokenizer.so")
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the C++ tokenizer; None when unavailable."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            src = os.path.join(_HERE, "fast_tokenizer.cpp")
            stale = (not os.path.exists(_SO_PATH)
                     or os.path.getmtime(_SO_PATH) < os.path.getmtime(src))
            if stale:  # rebuild on source change, not just absence
                # a temporary file promoted by os.replace: another process
                # never loads a half-written library
                os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
                tmp = "%s.%d.tmp" % (_SO_PATH, os.getpid())
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", src,
                     "-o", tmp],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _SO_PATH)
            lib = ctypes.CDLL(_SO_PATH)
            lib.ft_create.restype = ctypes.c_void_p
            lib.ft_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int32, ctypes.c_int32]
            lib.ft_destroy.argtypes = [ctypes.c_void_p]
            lib.ft_tokenize.restype = ctypes.c_int32
            lib.ft_tokenize.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib = None
    return _lib


def native_available() -> bool:
    return _load_native() is not None


def load_vocab(path: str) -> Dict[str, int]:
    """One token per line → {token: line_index} (BERT vocab.txt format)."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_punct(ch: str) -> bool:
    o = ord(ch)
    return (33 <= o <= 47) or (58 <= o <= 64) or (91 <= o <= 96) \
        or (123 <= o <= 126)


class WordpieceTokenizer:
    """Basic + wordpiece tokenization; native C++ hot path when possible.

    ``use_native=None`` auto-selects; ``False`` forces the Python
    implementation (used by the parity tests).
    """

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 do_lower_case: bool = True, max_chars_per_word: int = 100,
                 use_native: Optional[bool] = None):
        self.vocab = dict(vocab)
        self.unk_token = unk_token
        self.unk_id = self.vocab.get(unk_token, 0)
        self.do_lower_case = do_lower_case
        self.max_chars_per_word = max_chars_per_word
        self._handle = None
        lib = _load_native() if use_native in (None, True) else None
        if use_native is True and lib is None:
            raise RuntimeError("native tokenizer requested but the C++ "
                               "library could not be built/loaded")
        if lib is not None:
            items = sorted(self.vocab.items(), key=lambda kv: kv[1])
            arr = (ctypes.c_char_p * len(items))(
                *[k.encode("utf-8") for k, _ in items])
            self._handle = lib.ft_create(arr, len(items), self.unk_id)
            self._lib = lib

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            try:
                self._lib.ft_destroy(h)
            except Exception:  # pragma: no cover - interpreter teardown
                pass

    # -- python reference implementation --------------------------------
    def _basic(self, text: str) -> List[str]:
        out: List[str] = []
        cur = ""
        for ch in text:
            if ch.isspace():
                if cur:
                    out.append(cur)
                    cur = ""
            elif _is_punct(ch):
                if cur:
                    out.append(cur)
                    cur = ""
                out.append(ch)
            else:
                cur += ch.lower() if self.do_lower_case and ch.isascii() \
                    else ch
        if cur:
            out.append(cur)
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word.encode("utf-8")) > self.max_chars_per_word:
            return [self.unk_id]
        # byte-wise greedy match, mirroring the C++ implementation exactly
        b = word.encode("utf-8")
        start, pieces = 0, []
        while start < len(b):
            end = len(b)
            cur = None
            while start < end:
                sub = b[start:end].decode("utf-8", errors="surrogateescape")
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> np.ndarray:
        """text → int32 id array."""
        if self._handle:
            buf_len = max(16, len(text) * 2 + 8)
            buf = (ctypes.c_int32 * buf_len)()
            n = self._lib.ft_tokenize(
                self._handle, text.encode("utf-8"),
                1 if self.do_lower_case else 0, buf, buf_len)
            return np.frombuffer(buf, dtype=np.int32, count=n).copy()
        ids: List[int] = []
        for w in self._basic(text):
            ids.extend(self._wordpiece(w))
        return np.asarray(ids, np.int32)
