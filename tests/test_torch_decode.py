"""The port's torch wavefront (the plain version of the fused decode kernel)
against the JAX package's XLA wavefront, and the port's stream decoder
against the input and the native CPU decoder. Exact equality: the format
is lossless."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from brotlig_tpu import native
from brotlig_tpu.api import decode_cpu
from brotlig_tpu.format.headers import parse_container
from brotlig_tpu.ops import decode as JD
from brotlig_tpu.ops import tables as JT
from brotlig_tpu.refimpl.codec import encode

from brotlig_tpu_torch.format.errors import Aborted
from brotlig_tpu_torch.ops import decode as TD
from brotlig_tpu_torch.ops import decode_kernel, tables_kernel
from brotlig_tpu_torch.ops.decode import decode_stream, staged_batches
from brotlig_tpu_torch.state import (Staged, tables_from_jax,
                                     tables_from_lengths)
from test_ops_decode import batch
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)
from test_roundtrip import make_data

PS = 32768
MC = JD.max_cmds_for(PS)
KINDS = ("text", "structured", "repetitive", "zeros", "text")


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.fixture(scope="module")
def pages():
    """32 KiB pages of several kinds, one container, and its page blobs."""
    data = b"".join(make_data(k, PS, seed=i) for i, k in enumerate(KINDS))
    blob = native.encode(data, page_size=PS)
    info = parse_container(blob)
    comp = [blob[int(info.offsets[i]): int(info.offsets[i] + info.sizes[i])]
            for i in range(len(KINDS))]
    assert all(len(c) < PS for c in comp)
    return data, blob, comp


@pytest.fixture(scope="module")
def jax_symbols(pages):
    words, sizes = batch(pages[2], PS)
    return words, sizes, JD._stage_symbols(words, sizes, PS, MC)


def test_stage_symbols_matches_jax(jax_symbols):
    words, sizes, want = jax_symbols
    got = TD._stage_symbols(_t(words), _t(sizes), PS, MC)
    ncmds = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), ncmds)
    for g, w in zip(got[2:], want[2:9]):       # commands, npostfix, ...
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the literal queue up to each page's literal count (past it, the JAX
    # slot compaction leaves unspecified values)
    n_lit = np.asarray(want[2]).sum(axis=1)
    for p, n in enumerate(n_lit):
        np.testing.assert_array_equal(got[1][p, :n].numpy(),
                                      np.asarray(want[1])[p, :n])


def test_decode_pages_matches_jax(pages, jax_symbols):
    data, _, _ = pages
    words, sizes, _ = jax_symbols
    want, want_isd = JD.decode_pages(words, sizes, PS, MC, variant="xla")
    got, isd = TD.decode_pages(_t(words), _t(sizes), PS, MC)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(isd.numpy(), np.asarray(want_isd))
    assert got.numpy().tobytes() == data


def test_decode_step_from_jax_tables(pages, jax_symbols):
    """The port's decode step fed the exact tables the JAX loader read
    (state.tables_from_jax), so a decode mismatch shows on its own."""
    data, blob, _ = pages
    group, st = next(staged_batches(blob, parse_container(blob), 256, "cpu"))
    buf3 = st.buf.numpy()
    tl = min(tables_kernel.TABLE_WORDS, buf3.shape[0] * 4)
    view, bp0 = JT.stream_view_from_interleaved(jnp.asarray(buf3), tl)
    bp, lens, trivs = bp0, [], []
    for A in tables_kernel.ALPHABETS:
        ln, triv, bp = JT.load_table(view, bp, A)
        lens.append(np.asarray(ln))
        trivs.append(np.asarray(triv))
    tabs = tables_from_jax(*lens, np.stack(trivs, axis=1),
                           np.asarray(bp - bp0))
    out, ncmds, status = decode_kernel.decode_fused(st.buf, st.npd, tabs, PS)
    assert int(status.abs().sum()) == 0
    for row, i in enumerate(group):
        assert out[row].numpy().tobytes() == data[i * PS:(i + 1) * PS]
    # ncmds agrees with the JAX wavefront on the same pages (the fixture's
    # run over all of them, in container order)
    np.testing.assert_array_equal(ncmds.numpy(),
                                  np.asarray(jax_symbols[2][0])[group])


def test_garbage_pages_flagged():
    """All-zero streams never reach a sentinel and cover past the page:
    the plain decode stops at its bounds and flags every page."""
    st = Staged(torch.zeros((8, 3, 128), dtype=torch.int32),
                torch.zeros((3, 4), dtype=torch.int32))
    tabs = tables_from_lengths(*tables_kernel.load_tables_plain(st.buf))
    _, _, status = decode_kernel.decode_fused(st.buf, st.npd, tabs, PS)
    assert bool((status & TD.ST_OVERRUN != 0).all())


def test_corrupt_page_raises(pages):
    _, blob, _ = pages
    info = parse_container(blob)
    off = int(info.offsets[0])
    bad = bytearray(blob)
    bad[off: off + int(info.sizes[0])] = bytes(int(info.sizes[0]))
    with pytest.raises(ValueError, match="corrupt stream"):
        decode_stream(bytes(bad), "cpu")


@pytest.mark.parametrize("kind,n", [
    ("text", 1000), ("text", 65537), ("repetitive", 200_000),
    ("random", 80_000), ("zeros", 131072), ("structured", 100_000),
])
def test_stream_roundtrip(kind, n):
    data = make_data(kind, n, seed=n)
    blob = encode(data)
    got = decode_stream(blob, "cpu")
    assert got == data
    assert got == decode_cpu(blob)


@pytest.mark.parametrize("page_size", [32768, 65536, 131072])
def test_stream_page_sizes(page_size):
    data = make_data("text", 2 * page_size + 1234, seed=page_size)
    blob = native.encode(data, page_size=page_size)
    assert decode_stream(blob, "cpu") == data == decode_cpu(blob)


def test_short_last_batch_and_feedback():
    """Six compressed pages in batches of 4: the last batch is short;
    feedback sees monotone progress, and returning True aborts."""
    data = b"".join(make_data(k, PS, seed=i) for i, k in
                    enumerate(("text", "structured", "text", "repetitive",
                               "text", "structured")))
    blob = native.encode(data, page_size=PS)
    assert len(parse_container(blob).compressed_page_indices()) == 6
    seen = []
    got = decode_stream(blob, "cpu", batch_pages=4,
                        feedback=lambda p: (seen.append(p), False)[1])
    assert got == data
    assert seen == [400 / 6, 100.0]
    with pytest.raises(Aborted):
        decode_stream(blob, "cpu", batch_pages=4, feedback=lambda p: True)


def test_pipeline_order_feedback_and_abort(monkeypatch):
    """Ten compressed pages in five batches of two: each batch is staged
    while the batch before it is the last launched, batches drain two
    behind their launch and in order, the feedback values are those of
    decode_stream_jax (drained * 100 / n), an abort at the third drain
    raises, and the next decode is whole again."""
    from brotlig_tpu_torch import state
    data = b"".join(make_data("repetitive", PS, seed=i) for i in range(10))
    blob = native.encode(data, page_size=PS)
    n = len(parse_container(blob).compressed_page_indices())
    assert n == 10
    log = []
    stage, launch = state.StagingBuffers.stage, TD.decode_batch

    def logged(name, fn):
        def run(*args, **kwargs):
            log.append(name)
            return fn(*args, **kwargs)
        return run
    monkeypatch.setattr(state.StagingBuffers, "stage", logged("stage", stage))
    monkeypatch.setattr(TD, "decode_batch", logged("launch", launch))
    seen = []

    def feedback(p):
        log.append("drain")
        seen.append(p)
        return False
    assert decode_stream(blob, "cpu", batch_pages=2, feedback=feedback) \
        == data
    assert seen == [d * 100.0 / n for d in (2, 4, 6, 8, 10)]
    sl = ["stage", "launch"]
    assert log == sl * 3 + ["drain"] + sl + ["drain"] + sl + ["drain"] * 3

    calls = []
    with pytest.raises(Aborted):
        decode_stream(blob, "cpu", batch_pages=2,
                      feedback=lambda p: (calls.append(p), len(calls) == 3)[1])
    assert calls == seen[:3]
    assert decode_stream(blob, "cpu", batch_pages=2) == data
