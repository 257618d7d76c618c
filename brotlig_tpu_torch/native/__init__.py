"""The port's host C++: ctypes bindings over its own copy of the native
stager (brotlig_stage.cpp), CPU decoder (brotlig_core.cpp) and encoder
(brotlig_encode.cpp), with the function names of brotlig_tpu.native.

The sources are copies of brotlig_tpu/native/*.cpp, unchanged: the port's
containers and staged buffers are byte-identical to the JAX package's
(tests/test_torch_native.py). g++ builds them, with the same flags, into
the gitignored brotlig_tpu_torch/_build/ the first time a function here is
called; nothing is built at import. The library is built for the host it
runs on (-march=native), so a copy built on one machine is not carried to
another.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np
from numpy import ctypeslib as np_ctypeslib

from ..format import constants as C
from ..format.errors import Aborted, MessageType

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "brotlig_core.cpp"),
         os.path.join(_DIR, "brotlig_encode.cpp"),
         os.path.join(_DIR, "brotlig_stage.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libbrotlig_native.so")
_lock = threading.Lock()
_lib = None

# Progress/abort callback into the native encoder pool:
# fn(msg_type, pages_done, pages_total) -> nonzero aborts.
FEEDBACK_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int,
                               ctypes.c_uint32, ctypes.c_uint32)


def _build() -> None:
    """g++ into a private temporary, then an atomic rename: concurrent
    first uses (test workers) never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-o", tmp] + _SRCS + ["-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIB_PATH)


def _load():
    """The loaded library, built first if missing or older than a source;
    raises when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(LIB_PATH)
                or any(os.path.getmtime(LIB_PATH) < os.path.getmtime(s)
                       for s in _SRCS)):
            _build()
        lib = ctypes.CDLL(LIB_PATH)
        c_u64, c_int, c_u32 = ctypes.c_uint64, ctypes.c_int, ctypes.c_uint32
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64ref = ctypes.POINTER(ctypes.c_uint64)
        u32a = np_ctypeslib.ndpointer(dtype="uint32", flags="C")
        u64a = np_ctypeslib.ndpointer(dtype="uint64", flags="C")
        i32a = np_ctypeslib.ndpointer(dtype="int32", flags="C")
        sigs = {
            "blg_decompressed_size": (c_u64, [ctypes.c_char_p, c_u64]),
            "blg_decode": (c_int, [ctypes.c_char_p, c_u64, u8p, c_u64,
                                   u64ref, c_int]),
            "blg_decode_page": (c_int, [ctypes.c_char_p, c_u64, u8p, c_u64]),
            "blg_encode": (c_int, [ctypes.c_char_p, c_u64, u8p, c_u64,
                                   u64ref, c_u32, c_int, c_int, c_int]),
            "blg_encode_ex": (c_int, [ctypes.c_char_p, c_u64, u8p, c_u64,
                                      u64ref, c_u32, c_int, c_int, c_int,
                                      FEEDBACK_FN]),
            "blg_encode_page_cmds": (c_int, [ctypes.c_char_p, c_u64, c_int,
                                             c_int, u32a, u32a, u32a, c_u64,
                                             u8p, c_u64, u64ref]),
            "blg_parse_page": (c_int, [ctypes.c_char_p, c_u64, c_int, c_int,
                                       u32a, u32a, u32a, c_u64, u64ref,
                                       u64ref]),
            "blg_stage_pages": (c_int, [ctypes.c_char_p, c_u64, u64a, u64a,
                                        c_u32, c_u32, i32a, i32a, c_int]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library builds and loads on this host."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def has_encoder() -> bool:
    return available()


def decompressed_size(data: bytes) -> int:
    return int(_load().blg_decompressed_size(data, len(data)))


def decode(data: bytes, num_threads: int = 0) -> bytes:
    """Decode a non-preconditioned container with the native decoder.

    Raises NotImplementedError for preconditioned streams and ValueError on
    corrupt input."""
    lib = _load()
    padded = data + b"\x00" * 16  # slack for the 64-bit bit-reader loads
    n = decompressed_size(data)
    # The output allocation follows the header-claimed size (up to 65535
    # pages x 128 KiB): require the page table those pages imply, and a
    # payload byte per page, before trusting it.
    if n:
        num_pages = int.from_bytes(data[2:4], "little")
        precon = bool(data[6] & 0x10)  # bit 20 of the header bits word
        table_off = 8 + (8 if precon else 0)
        if len(data) < table_off + 4 * num_pages:
            raise ValueError("corrupt stream (truncated page table)")
        if len(data) < table_off + 4 * num_pages + num_pages:
            raise ValueError("corrupt stream (payload too small for "
                             "claimed page count)")
    out = (ctypes.c_uint8 * max(n, 1))()
    out_size = ctypes.c_uint64(0)
    rc = lib.blg_decode(padded, len(data), out, n,
                        ctypes.byref(out_size), num_threads)
    if rc == 2:
        raise NotImplementedError("preconditioned stream")
    if rc != 0:
        raise ValueError(f"corrupt stream (native decoder rc={rc})")
    return bytes(bytearray(out)[: out_size.value])


def encode(data: bytes, page_size: int = 65536, max_chain: int = 64,
           num_threads: int = 0, quality: int = 11,
           feedback=None) -> bytes:
    """Compress a container with the native encoder (no preconditioning).

    quality >= 10 uses the two-pass cost-model optimal parse; lower values
    use the greedy-lazy parse.

    feedback(msg_type, text) -> bool mirrors BROTLIG_Feedback_Proc
    (reference BrotligEncoder.cpp:402-409): called from the worker pool
    after every encoded page; returning True aborts (raises Aborted)."""
    lib = _load()
    cap = C.max_compressed_size(len(data), page_size=page_size)
    out = (ctypes.c_uint8 * cap)()
    out_size = ctypes.c_uint64(0)
    if feedback is None:
        rc = lib.blg_encode(data, len(data), out, cap,
                            ctypes.byref(out_size), page_size, max_chain,
                            num_threads, quality)
    else:
        cb_error: list = []

        def _cb(msg_type, done, total):
            try:
                return 1 if feedback(MessageType(msg_type),
                                     f"pages {done}/{total}") else 0
            except Exception as e:  # don't unwind through C
                cb_error.append(e)
                return 1
        c_cb = FEEDBACK_FN(_cb)
        rc = lib.blg_encode_ex(data, len(data), out, cap,
                               ctypes.byref(out_size), page_size, max_chain,
                               num_threads, quality, c_cb)
        if cb_error:
            raise cb_error[0]
        if rc == 5:
            raise Aborted("encode aborted by feedback callback")
    if rc != 0:
        raise ValueError(f"native encode failed (rc={rc})")
    return bytes(bytearray(out)[: out_size.value])


def encode_page_cmds(data: bytes, is_last: bool, ins, cpy, dist,
                     isdelta: bool = False) -> bytes:
    """Serialize one page from external (ins, cpy, dist) command arrays.

    Returns the compressed page, or the raw page bytes when incompressible
    (len == page size)."""
    lib = _load()
    n = len(data)
    cap = max(2 * n + 64, 1024)
    out = (ctypes.c_uint8 * cap)()
    out_size = ctypes.c_uint64(0)
    ins = np.ascontiguousarray(ins, dtype=np.uint32)
    cpy = np.ascontiguousarray(cpy, dtype=np.uint32)
    dist = np.ascontiguousarray(dist, dtype=np.uint32)
    rc = lib.blg_encode_page_cmds(data, n, int(is_last), int(isdelta),
                                  ins, cpy, dist, len(ins), out, cap,
                                  ctypes.byref(out_size))
    if rc != 0:
        raise ValueError(f"native page encode failed (rc={rc})")
    return bytes(bytearray(out)[: out_size.value])


def parse_page(data: bytes, max_chain: int = 64, quality: int = 11):
    """The q11-winning command stream (ins, cpy, dist arrays, tail) of one
    page."""
    lib = _load()
    cap = len(data) // 2 + 64
    ins = np.zeros(cap, dtype=np.uint32)
    cpy = np.zeros(cap, dtype=np.uint32)
    dist = np.zeros(cap, dtype=np.uint32)
    ncmds = ctypes.c_uint64(0)
    tail = ctypes.c_uint64(0)
    rc = lib.blg_parse_page(data, len(data), max_chain, quality, ins, cpy,
                            dist, cap, ctypes.byref(ncmds),
                            ctypes.byref(tail))
    if rc != 0:
        raise ValueError(f"parse failed (rc={rc})")
    k = ncmds.value
    return ins[:k], cpy[:k], dist[:k], int(tail.value)


def stage_pages(payload: bytes, offsets, sizes, wl: int,
                num_threads: int = 0, out=None):
    """Parse page headers + size tables and build the word-round-robin
    interleaved decode buffer on the host (the kernels' input layout; see
    brotlig_stage.cpp). Returns (buf3 [wl*32//128, P, 128] int32,
    npd [P, 4] int32 = (npostfix, ndirect, isdelta, 0)).

    out: optional (buf3, npd) numpy arrays of those shapes, C-contiguous
    int32, to write into instead of new ones (the decode pipeline passes
    views of page-locked buffers); the stager writes every element."""
    lib = _load()
    offs = np.ascontiguousarray(offsets, dtype=np.uint64)
    szs = np.ascontiguousarray(sizes, dtype=np.uint64)
    P = len(offs)
    wc = wl * 32 // 128
    if out is None:
        buf3 = np.zeros((wc, P, 128), dtype=np.int32)
        npd = np.zeros((P, 4), dtype=np.int32)
    else:
        buf3, npd = out
        for a, shape in ((buf3, (wc, P, 128)), (npd, (P, 4))):
            if (a.shape != shape or a.dtype != np.int32
                    or not a.flags.c_contiguous or not a.flags.writeable):
                raise ValueError(f"stage_pages: output {a.shape} {a.dtype}, "
                                 f"want a writable C-contiguous int32 "
                                 f"{shape}")
    rc = lib.blg_stage_pages(payload, len(payload), offs, szs, P, wl,
                             buf3, npd, num_threads)
    if rc != 0:
        raise ValueError("stage_pages: page bounds outside payload")
    return buf3, npd


def decode_page(data: bytes, out_size: int) -> bytes:
    lib = _load()
    padded = data + b"\x00" * 16
    out = (ctypes.c_uint8 * max(out_size, 1))()
    rc = lib.blg_decode_page(padded, len(data), out, out_size)
    if rc != 0:
        raise ValueError(f"corrupt page (native decoder rc={rc})")
    return bytes(bytearray(out)[:out_size])
