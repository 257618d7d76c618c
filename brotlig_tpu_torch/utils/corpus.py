"""The mixed corpus that the smoke test and the profile tools decode and
encode: the recipe of bench.py (make_corpus_pages), half real files and
half synthetic text, structured and repetitive pages. Made the same way
from the same files on every run, with numpy's generator seeded by the
page index."""
from __future__ import annotations

import glob
import os

import numpy as np

# the checkout's root, above this package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PAGE = 64 * 1024


def real_bytes(min_len: int) -> bytes:
    """At least min_len bytes of real files: the checkout's Python and C++
    sources and notes, then system binaries and libraries, repeated to
    length."""
    picks = (sorted(glob.glob(os.path.join(ROOT, "brotlig_tpu", "**", "*.py"),
                              recursive=True))
             + sorted(glob.glob(os.path.join(ROOT, "brotlig_tpu", "native",
                                             "*.cpp")))
             + [os.path.join(ROOT, "SURVEY.md"), os.path.join(ROOT, "PERF.md")]
             + sorted(glob.glob("/usr/bin/*"))[:40]
             + sorted(glob.glob("/usr/lib/x86_64-linux-gnu/*.so*"))[:40])
    buf = bytearray()
    for f in picks:
        try:
            with open(f, "rb") as fh:
                buf += fh.read(2 << 20)
        except OSError:
            continue
        if len(buf) >= min_len:
            break
    if not buf:
        buf = bytearray(b"fallback " * 8)
    while len(buf) < min_len:
        buf += buf[: min_len - len(buf)]
    return bytes(buf)


def corpus(n_pages: int, page: int = PAGE) -> bytes:
    """n_pages pages of `page` bytes: pages 0, 2, 4 of every six are real
    files, 1 text of common words, 3 structured bytes, 5 a repeated random
    pattern."""
    words = [b"the ", b"of ", b"and ", b"compression ", b"stream ",
             b"page ", b"huffman ", b"entropy ", b"decode ", b"brotli "]
    real = real_bytes(((n_pages + 1) // 2) * page)
    nextreal = 0
    pages = []
    for i in range(n_pages):
        r = np.random.default_rng(i)
        kind = i % 6
        if kind in (0, 2, 4):
            pages.append(real[nextreal * page:(nextreal + 1) * page])
            nextreal += 1
        elif kind == 1:
            buf = bytearray()
            while len(buf) < page:
                buf += words[int(r.integers(0, len(words)))]
            pages.append(bytes(buf[:page]))
        elif kind == 3:
            a = (r.integers(0, 16, page) + (np.arange(page) // 256) % 64) % 256
            pages.append(a.astype(np.uint8).tobytes())
        else:
            pat = r.integers(0, 256, 173, dtype=np.uint8).tobytes()
            pages.append((pat * (page // len(pat) + 1))[:page])
    return b"".join(pages)
