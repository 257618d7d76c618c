"""Plain-brotli comparison codec (ctypes over the system libbrotli).

The reference CLI optionally runs regular brotli q11/lgwin24 beside
Brotli-G so users can compare ratio and bandwidth
(sample/brotlig_cli.cpp:47-52, 532-624). This module provides the same
comparison path against the system libbrotlienc/libbrotlidec when
present; `available()` is False otherwise and callers skip the mode.
"""
from __future__ import annotations

import ctypes
import ctypes.util

_enc = None
_dec = None
_checked = False

# reference defaults: quality 11, window 24 (brotlig_cli.cpp:47-52)
QUALITY = 11
LGWIN = 24

_MODE_GENERIC = 0
_OP_FINISH = 2
_PARAM_QUALITY = 1
_PARAM_LGWIN = 2


def _load():
    global _enc, _dec, _checked
    if _checked:
        return _enc
    _checked = True
    try:
        enc = ctypes.CDLL(ctypes.util.find_library("brotlienc")
                          or "libbrotlienc.so.1")
        dec = ctypes.CDLL(ctypes.util.find_library("brotlidec")
                          or "libbrotlidec.so.1")
    except OSError:
        return None
    enc.BrotliEncoderCompress.restype = ctypes.c_int
    enc.BrotliEncoderCompress.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_size_t, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
    enc.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
    enc.BrotliEncoderMaxCompressedSize.argtypes = [ctypes.c_size_t]
    dec.BrotliDecoderDecompress.restype = ctypes.c_int
    dec.BrotliDecoderDecompress.argtypes = [
        ctypes.c_size_t, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
    _enc, _dec = enc, dec
    return _enc


def available() -> bool:
    return _load() is not None


def compress(data: bytes, quality: int = QUALITY,
             lgwin: int = LGWIN) -> bytes:
    enc = _load()
    if enc is None:
        raise RuntimeError("system libbrotli not available")
    cap = ctypes.c_size_t(
        max(enc.BrotliEncoderMaxCompressedSize(len(data)), 64))
    out = ctypes.create_string_buffer(cap.value)
    ok = enc.BrotliEncoderCompress(quality, lgwin, _MODE_GENERIC,
                                   len(data), data, ctypes.byref(cap), out)
    if not ok:
        raise RuntimeError("brotli compression failed")
    return out.raw[: cap.value]


def decompress(data: bytes, expected_size: int) -> bytes:
    if _load() is None:
        raise RuntimeError("system libbrotli not available")
    cap = ctypes.c_size_t(max(expected_size, 64))
    out = ctypes.create_string_buffer(cap.value)
    rc = _dec.BrotliDecoderDecompress(len(data), data, ctypes.byref(cap),
                                      out)
    if rc != 1:  # BROTLI_DECODER_RESULT_SUCCESS
        raise ValueError("brotli decompression failed")
    return out.raw[: cap.value]
