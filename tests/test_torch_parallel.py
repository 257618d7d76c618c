"""The port's multi-archive decode (brotlig_tpu_torch/parallel/runtime.py) on
the CPU: pooled batches against the inputs, the static archive assignment,
and the shared-storage flow."""
import numpy as np
import pytest

from brotlig_tpu import native
from brotlig_tpu.format import constants as C
from brotlig_tpu.format.headers import (PreconditionHeader, StreamHeader,
                                       pack_page_table)
from brotlig_tpu.format.precondition import (DataConditionParams, condition,
                                             delta_encode_page)

from brotlig_tpu_torch.format.headers import parse_container
from brotlig_tpu_torch.ops import decode as TD
from brotlig_tpu_torch.parallel import runtime
from test_roundtrip import make_data
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

PS = C.MIN_PAGE_SIZE


def precondition_container(tex: bytes, p: DataConditionParams) -> bytes:
    """A preconditioned container of `tex` made with the JAX package's
    numpy conditioning and native page packer (quicker than its Python
    encoder): each page delta-encoded where it has color spans, stored
    raw (as conditioned, non-delta bytes) where it does not compress."""
    assert p.initialize(len(tex))
    cond = condition(tex, p)
    pages = []
    for start in range(0, len(cond), PS):
        page = cond[start: start + PS]
        work, did = delta_encode_page(page, start, p)
        ins, cpy, dist, _ = native.parse_page(work)
        comp = native.encode_page_cmds(work, start + PS >= len(cond), ins,
                                       cpy, dist, isdelta=did)
        pages.append(page if len(comp) == len(page) else comp)
    ph = PreconditionHeader(p.swizzle, p.pitch_d3d12_aligned,
                            p.width_in_blocks[0], p.height_in_blocks[0],
                            p.format, p.num_mip_levels, p.pitch_in_bytes[0])
    return (StreamHeader.for_input(len(tex), PS, True).pack() + ph.pack()
            + pack_page_table([len(c) for c in pages]) + b"".join(pages))


def archive_mix():
    """tests/test_sharding.py's mix: five text, repetitive and structured
    archives, a preconditioned BC1 texture and a random (raw) archive."""
    rng = np.random.default_rng(7)
    datas = [make_data(["text", "repetitive", "structured"][i % 3],
                       30_000 + i * 7000, seed=50 + i) for i in range(5)]
    blobs = [native.encode(d, page_size=PS) for d in datas]
    tex = ((rng.integers(0, 8, 128 * 128 * 8)
            + np.arange(128 * 128 * 8) // 64) % 256).astype(np.uint8).tobytes()
    p = DataConditionParams(precondition=True, swizzle=True,
                            delta_encode=True, format=C.DATA_FORMAT_BC1,
                            width_in_pixels=512, height_in_pixels=512)
    datas.append(tex)
    blobs.append(precondition_container(tex, p))
    datas.append(rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes())
    blobs.append(native.encode(datas[-1], page_size=PS))
    return datas, blobs


def test_batched_multi_archive_pools_pages_once(monkeypatch):
    """Pages of seven archives pooled into batches of four: every archive
    equals its input; the job count does not divide by four, and no page
    is decoded twice (no padding rows)."""
    datas, blobs = archive_mix()
    n_comp = sum(len(parse_container(b).compressed_page_indices())
                 for b in blobs)
    assert n_comp % 4 != 0
    rows = []
    decode_batch = TD.decode_batch

    def counted(staged, *args, **kwargs):
        rows.append(staged.buf.shape[1])
        return decode_batch(staged, *args, **kwargs)
    monkeypatch.setattr(TD, "decode_batch", counted)
    outs = runtime.decode_archives_batched(blobs, batch_pages=4,
                                           device="cpu")
    for i, d in enumerate(datas):
        assert outs[i] == d, f"archive {i}"
    assert parse_container(blobs[5]).dc_params is not None
    assert sum(rows) == n_comp and max(rows) == 4
    assert len(rows) == -(-n_comp // 4)


def test_archive_interleaving(monkeypatch):
    """Static interleave covers all archives exactly once across procs."""
    seen = []
    for pid in range(3):
        monkeypatch.setattr(runtime, "process_info", lambda p=pid: (p, 3))
        seen.extend(runtime.my_archive_indices(10))
    assert sorted(seen) == list(range(10))
    assert runtime.my_archive_indices(5, process=(1, 2)) == [1, 3]
    monkeypatch.undo()
    assert runtime.process_info() == (0, 1)   # torch.distributed is off


def test_decode_archives_and_to_dir(tmp_path):
    """Shared-storage flow: outputs land as files keyed by archive index;
    decode_archives returns this process's share."""
    datas = [make_data("text", 5_000 + i * 900, seed=70 + i)
             for i in range(3)]
    blobs = [native.encode(d, page_size=PS) for d in datas]
    paths = runtime.decode_archives_to_dir(blobs, tmp_path / "out",
                                           batch_pages=2, process=(0, 1),
                                           device="cpu")
    assert len(paths) == 3
    for i, d in enumerate(datas):
        assert (tmp_path / "out" / f"archive_{i:05d}.bin").read_bytes() == d
    assert runtime.decode_archives(blobs, process=(1, 2), device="cpu") == \
        {1: datas[1]}


def test_batched_options_checked():
    with pytest.raises(ValueError):
        runtime.decode_archives_batched([], device="cpu", sweep_cw=100)
    assert runtime.decode_archives_batched([], device="cpu") == []
