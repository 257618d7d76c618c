"""The port's encode surface on the CPU, with no JAX: round trips of the
hybrid and full-device routes (q1, and q11 with a narrowed DP parse)
through the port's decoder and the native one, preconditioned textures,
feedback and abort, the refusals, the serializer's independence of its
command bucket, encode_archives and the command line."""
import numpy as np
import pytest
import torch

import brotlig_tpu_torch as bt
from brotlig_tpu_torch import cli, native
from brotlig_tpu_torch.format import constants as C
from brotlig_tpu_torch.format.errors import Aborted, MessageType
from brotlig_tpu_torch.format.precondition import DataConditionParams
from brotlig_tpu_torch.ops import encode as TE
from brotlig_tpu_torch.ops import encode_pack as TP
from brotlig_tpu_torch.parallel.runtime import encode_archives
from test_roundtrip import make_data
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

S = 32768


def mixed(n: int, seed: int) -> bytes:
    """Text, structured and random thirds, n bytes."""
    k = n // 3
    return (make_data("text", k, seed) + make_data("structured", k, seed)
            + make_data("random", n - 2 * k, seed))


def rows(datas, width: int = S):
    arr = np.zeros((len(datas), width), np.uint8)
    sizes = np.zeros(len(datas), np.int64)
    for i, d in enumerate(datas):
        arr[i, :len(d)] = np.frombuffer(d, np.uint8)
        sizes[i] = len(d)
    return torch.from_numpy(arr), torch.from_numpy(sizes)


@pytest.mark.parametrize("backend,quality", [("hybrid", 11), ("full", 1)])
@pytest.mark.parametrize("n", [0, 1, 2 * S, 2 * S + 777])
def test_round_trip_32k_pages(backend, quality, n):
    """Empty, 1-byte, page-multiple and 3-page inputs decode to themselves
    with the native decoder; the 3-page one also with the port's CPU
    decode."""
    data = mixed(n, seed=n % 7) if n > 1 else b"Q" * n
    blob = bt.encode(data, page_size=S, backend=backend, quality=quality,
                     device="cpu")
    assert native.decode(blob) == data
    assert bt.decompressed_size(blob) == n
    if n > 2 * S:
        assert bt.decode(blob, device="cpu") == data


@pytest.mark.parametrize("backend,quality", [("hybrid", 11), ("full", 1)])
@pytest.mark.parametrize("page_size", [65536, 131072])
def test_round_trip_large_pages(backend, quality, page_size):
    data = mixed(page_size // 2 + 5000, seed=3)
    blob = bt.encode(data, page_size=page_size, backend=backend,
                     quality=quality, device="cpu")
    assert native.decode(blob) == data


def test_native_backend_is_the_native_encoder():
    data = mixed(50000, seed=4)
    assert bt.encode(data, page_size=S, backend="native", quality=5) == \
        native.encode(data, page_size=S, quality=5)


def bc1_texture(w: int, h: int, seed: int):
    """A BC1 texture (correlated endpoints, low-entropy indices) and its
    swizzle + delta parameters."""
    r = np.random.default_rng(seed)
    nblocks = (w // 4) * (h // 4)
    c0 = (r.integers(0, 64, nblocks) * 1024
          + np.arange(nblocks) % 1024).astype("<u2")
    blocks = np.zeros((nblocks, 8), np.uint8)
    blocks[:, 0:2] = c0.view(np.uint8).reshape(-1, 2)
    blocks[:, 2:4] = (c0.astype(np.uint32) * 3 // 4).astype("<u2") \
        .view(np.uint8).reshape(-1, 2)
    blocks[:, 4:8] = r.integers(0, 4, (nblocks, 4)).astype(np.uint8) * 0x55
    params = DataConditionParams(
        precondition=True, swizzle=True, delta_encode=True,
        format=C.DATA_FORMAT_BC1, width_in_pixels=w, height_in_pixels=h)
    return blocks.tobytes(), params


@pytest.mark.parametrize("backend,quality", [("hybrid", 11), ("full", 1)])
def test_preconditioned_round_trip(backend, quality):
    """A BC1 texture of two 32 KiB pages (the last one partial), plus a
    random one whose pages are all stored raw (their conditioned, non-delta
    bytes)."""
    tex, params = bc1_texture(256, 448, seed=1)
    blob = bt.encode(tex, page_size=S, dc_params=params, backend=backend,
                     quality=quality, device="cpu")
    assert len(blob) < len(tex)
    assert bt.decode(blob, device="cpu") == tex
    noise = np.random.default_rng(2).integers(0, 256, len(tex),
                                              dtype=np.uint8).tobytes()
    _, params = bc1_texture(256, 448, seed=1)
    blob = bt.encode(noise, page_size=S, dc_params=params, backend=backend,
                     quality=quality, device="cpu")
    assert len(blob) > len(noise)
    assert bt.decode(blob, device="cpu") == noise


@pytest.mark.parametrize("backend,quality", [("hybrid", 11), ("full", 1)])
def test_feedback_per_batch_and_abort(backend, quality):
    data = bytes(S + 100)
    seen = []

    def feedback(kind, text):
        seen.append((kind, text))
        return False
    TE_stream = TE.encode_stream if backend == "hybrid" else \
        TP.encode_stream_full
    kw = {} if backend == "hybrid" else {"quality": quality}
    blob = TE_stream(data, page_size=S, batch_pages=1, feedback=feedback,
                     device="cpu", **kw)
    assert native.decode(blob) == data
    assert seen == [(MessageType.PROGRESS, "pages 1/2"),
                    (MessageType.PROGRESS, "pages 2/2")]
    with pytest.raises(Aborted):
        bt.encode(data, page_size=S, backend=backend, quality=quality,
                  feedback=lambda kind, text: True, device="cpu")


def test_refusals():
    data = b"abc" * 100
    with pytest.raises(ValueError, match="backend"):
        bt.encode(data, backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="page size"):
        bt.encode(data, page_size=4096, device="cpu")


def small_dp(monkeypatch):
    """The DP parse narrowed for the CPU (W 64, R 2, one cost-model
    iteration): its plain version takes ~12 s a 32 KiB page an iteration
    at the defaults. tests/test_torch_parse_dp.py holds it to the JAX
    package; these tests show the q11 route is wired."""
    from brotlig_tpu_torch.ops import parse_dp
    monkeypatch.setattr(parse_dp, "WINDOW", 64)
    monkeypatch.setattr(parse_dp, "ROUNDS", 2)
    monkeypatch.setenv("BLG_DP_ITERS", "1")


def test_full_q11_round_trip(monkeypatch):
    """encode(backend="full", quality=11) on the CPU: one 32 KiB page of
    text and structured data, decoded by the native decoder and by the
    port's CPU decode; the DP parse makes it smaller than the q1 tier."""
    small_dp(monkeypatch)
    data = make_data("text", S // 2, 1) + make_data("structured", S // 2, 2)
    blob = bt.encode(data, page_size=S, backend="full", quality=11,
                     device="cpu")
    assert native.decode(blob) == data
    assert bt.decode(blob, device="cpu") == data
    q1 = bt.encode(data, page_size=S, backend="full", quality=1,
                   device="cpu")
    assert len(blob) < len(q1)


def test_encode_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for backend, quality in (("hybrid", 11), ("full", 1)):
        with pytest.raises(RuntimeError, match="cuda"):
            bt.encode(b"abc", backend=backend, quality=quality)


def test_commands_reproduce_their_bytes():
    """Both tiers' commands are valid LZ77 over each row: copies of >= 4
    bytes from inside the page that reproduce the page."""
    datas = [make_data("text", 12000, 1), make_data("structured", 9000, 2),
             make_data("repetitive", 6000, 3), b"x" * 10000]
    pages, sizes = rows(datas, width=S // 2)
    for max_cmds, fast in ((S // 2 + 2, False), (S // 4 + 16, True)):
        ins, cpy, dist, nc = TE.find_commands(pages, sizes, max_cmds, fast)
        for r, d in enumerate(datas):
            out = bytearray()
            for i, c, dd in zip(*(x[r, :int(nc[r])].tolist()
                                  for x in (ins, cpy, dist))):
                out += d[len(out): len(out) + i]
                assert c >= 4 and 1 <= dd <= len(out)
                for _ in range(c):
                    out.append(out[-dd])
            assert bytes(out) == d[:len(out)]
    assert int(nc[3]) == 1 and int(cpy[3, 0]) == 9999   # one run


def test_match_len_forms_agree():
    """_match_len (both sides gathered) equals _match_len_at (a row shift)
    at the positions themselves, and a byte-by-byte LCP capped at 64."""
    datas = [make_data("repetitive", 5000, 1), make_data("text", 7000, 2)]
    pages, sizes = rows(datas, width=8192)
    q = TE._quads(pages)
    P, W = q.shape
    iota = torch.arange(W).expand(P, W)
    rng = np.random.default_rng(0)
    cand = torch.from_numpy(rng.integers(-1, W, (P, W))).minimum(iota - 1)
    limit = sizes[:, None]
    a = TE._match_len(q, iota, cand, limit)
    assert torch.equal(a, TE._match_len_at(q, cand, limit, 0))
    for r, d in enumerate(datas):
        for p in rng.integers(0, W, 50).tolist():
            c = int(cand[r, p])
            n = 0
            while (c >= 0 and n < 64 and p + n < len(d)
                   and d[p + n] == d[c + n]):
                n += 1
            assert int(a[r, p]) == n


def test_pack_is_bucket_independent():
    """The serializer's bytes do not depend on the command bound it runs
    under, so the bucket ladder changes only its cost: every page packed
    alone at the full bound equals the partitioned pack (full text and
    structured pages need the 4096 and 8192 buckets)."""
    datas = [make_data("text", S, 1), make_data("structured", S, 1),
             make_data("text", 20000, 4), b"Q"]
    pages, sizes = rows(datas)
    max_cmds = S // 4 + 16
    cmds = TE.find_commands(pages, sizes, max_cmds, fast=True)
    buckets = {TP.command_bucket(int(n), max_cmds) for n in cmds[3]}
    assert buckets == {2048, 4096, 8192}
    isdelta = torch.tensor([0, 1, 0, 1])
    out, out_sizes = TP.pack_partitioned(pages, sizes, S, max_cmds, *cmds,
                                         isdelta)
    for r in range(len(datas)):
        one, one_size = TP.pack_pages_device(
            pages[r:r + 1], sizes[r:r + 1],
            *(c[r:r + 1] for c in cmds[:3]), cmds[3][r:r + 1], S, max_cmds,
            isdelta[r:r + 1])
        assert int(one_size[0]) == int(out_sizes[r])
        assert torch.equal(one[0], out[r])
        n, sz = len(datas[r]), int(out_sizes[r])
        if sz < n:
            assert native.decode_page(out[r, :sz].numpy().tobytes(), n) == \
                datas[r]


def test_encode_archives():
    datas = [mixed(20000, 1), b"", make_data("text", 40000, 2)]
    mine = encode_archives(datas, page_size=S, device="cpu")
    assert sorted(mine) == [0, 1, 2]
    assert [native.decode(mine[i]) for i in range(3)] == datas
    second = encode_archives(datas, page_size=S, process=(1, 2),
                             device="cpu")
    assert sorted(second) == [1]
    assert native.decode(second[1]) == b""


def test_cli_round_trip(tmp_path, capsys, monkeypatch):
    data = mixed(40000, seed=5)
    src = tmp_path / "file.bin"
    src.write_bytes(data)
    assert cli.main([str(src), "--device", "cpu", "--page-size",
                     str(S)]) == 0
    assert "ratio" in capsys.readouterr().out
    assert native.decode((tmp_path / "file.bin.brotlig").read_bytes()) \
        == data
    assert cli.main([str(tmp_path / "file.bin.brotlig"), "--device",
                     "cpu"]) == 0
    assert (tmp_path / "file.bin.out").read_bytes() == data
    full = tmp_path / "full.brotlig"
    assert cli.main([str(src), str(full), "--device", "cpu",
                     "--encode-backend", "full", "--quality", "1"]) == 0
    assert native.decode(full.read_bytes()) == data
    small_dp(monkeypatch)
    q11 = tmp_path / "q11.brotlig"
    assert cli.main([str(src), str(q11), "--device", "cpu",
                     "--encode-backend", "full"]) == 0
    assert native.decode(q11.read_bytes()) == data
