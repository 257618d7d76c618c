"""The port's copy of the host C++ (brotlig_tpu_torch.native) against
brotlig_tpu.native: byte-identical containers, staged buffers and decoded
output on a small mixed input."""
import numpy as np
import pytest

from brotlig_tpu import native as jax_native
from brotlig_tpu.format.headers import parse_container

from brotlig_tpu_torch import native
from test_roundtrip import make_data


@pytest.fixture(scope="module")
def data():
    return b"".join(make_data(k, 40_000, seed=i) for i, k in
                    enumerate(("text", "structured", "repetitive", "random",
                               "zeros")))


@pytest.mark.parametrize("quality", [1, 11])
def test_encode_blobs_identical(data, quality):
    got = native.encode(data, page_size=32768, quality=quality)
    assert got == jax_native.encode(data, page_size=32768, quality=quality)
    assert native.decompressed_size(got) == len(data)


def test_stage_pages_and_decode_identical(data):
    blob = jax_native.encode(data, page_size=32768)
    info = parse_container(blob)
    idx = info.compressed_page_indices()
    offs = np.array([int(info.offsets[i]) for i in idx], np.uint64)
    szs = np.array([int(info.sizes[i]) for i in idx], np.uint64)
    buf3, npd = native.stage_pages(blob, offs, szs, 256)
    want_buf3, want_npd = jax_native.stage_pages(blob, offs, szs, 256)
    np.testing.assert_array_equal(buf3, want_buf3)
    np.testing.assert_array_equal(npd, want_npd)
    out = native.decode(blob)
    assert out == jax_native.decode(blob) == data
    page = bytes(blob[int(info.offsets[idx[0]]):
                      int(info.offsets[idx[0]] + info.sizes[idx[0]])])
    assert native.decode_page(page, 32768) == \
        jax_native.decode_page(page, 32768) == data[idx[0] * 32768:
                                                    (idx[0] + 1) * 32768]


def test_page_commands_identical(data):
    page = data[:32768]
    got = native.parse_page(page)
    want = jax_native.parse_page(page)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    assert native.encode_page_cmds(page, True, *got[:3]) == \
        jax_native.encode_page_cmds(page, True, *want[:3])


def test_encode_feedback_abort():
    from brotlig_tpu_torch.format.errors import Aborted
    with pytest.raises(Aborted):
        native.encode(make_data("text", 100_000), page_size=32768,
                      feedback=lambda kind, text: True)
