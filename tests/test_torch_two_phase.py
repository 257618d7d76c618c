"""The port's two-phase decode route on the CPU: the plain versions of the
phase-A and sweep kernels against the JAX package's XLA phase A and
phase B, and decode(..., variant="two_phase") on the edge inputs of
tests/test_pallas_decode.py. Exact equality: the format is lossless.

The case helpers here are shared with tests/test_torch_kernels.py, which
holds the kernels to these plain versions on a GPU; this module imports
JAX only inside the tests that compare with it.
"""
import numpy as np
import pytest
import torch

from brotlig_tpu.format.headers import StreamHeader, pack_page_table
from brotlig_tpu.refimpl.page_encoder import encode_page

import brotlig_tpu_torch
from brotlig_tpu_torch import native
from brotlig_tpu_torch.ops import decode as TD
from brotlig_tpu_torch.ops.decode_kernel import stream_words_hint, wl_bucket
from brotlig_tpu_torch.ops.phase_a_kernel import phase_a_plain
from brotlig_tpu_torch.ops.sweep_kernel import (FAR_START, middle_stage,
                                                sweep_plain)
from brotlig_tpu_torch.ops.tables_kernel import load_tables_plain
from brotlig_tpu_torch.state import staged_from_numpy, tables_from_lengths
from test_roundtrip import make_data

PS = 32768


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """Run the module's tests on one torch thread: their tensors are small,
    so more threads cost more than they give, and the suite runs several
    worker processes at once. test_torch_decode and test_torch_tables
    import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stage(comps, device="cpu"):
    """Compressed page blobs -> state.Staged on `device`, in that order."""
    sizes = np.array([len(c) for c in comps], np.uint64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.uint64)
    wl = wl_bucket(stream_words_hint(comps))
    return staged_from_numpy(*native.stage_pages(b"".join(comps), offsets,
                                                 sizes, wl), device)


def one_page_container(comp: bytes, n: int, page_size: int) -> bytes:
    """A container holding one compressed page of n output bytes."""
    header = StreamHeader.for_input(n, page_size, False)
    return header.pack() + pack_page_table([len(comp)]) + comp


def mixed_pages():
    """tests/test_pallas_decode.py's mixed batch: 4 kinds x 3000 bytes,
    one page each, at 32 KiB pages. Returns (datas, comps)."""
    kinds = ["text", "repetitive", "structured", "zeros"]
    datas = [make_data(k, 3000, seed=i + 1) for i, k in enumerate(kinds)]
    return datas, [encode_page(d, is_last=True) for d in datas]


def edge_case(name: str):
    """The edge inputs of tests/test_pallas_decode.py as (data, page blob,
    page size)."""
    if name == "single_command":
        # one command covers the page: a tiled pattern of period 173
        r = np.random.default_rng(0)
        pat = r.integers(0, 256, 173, dtype=np.uint8).tobytes()
        data = (pat * (PS // len(pat) + 1))[:PS]
        return data, encode_page(data, is_last=True), PS
    if name == "dense_commands":
        # > 255 commands per 1024 output bytes: (ins 1, cpy 2, dist 1)
        ncmd = 6144 // 3
        r = np.random.default_rng(9)
        data = np.repeat(r.integers(0, 256, ncmd, dtype=np.uint8),
                         3).tobytes()
        blob = native.encode_page_cmds(
            data, True, np.ones(ncmd, np.uint32),
            np.full(ncmd, 2, np.uint32), np.ones(ncmd, np.uint32))
        return data, blob, PS
    if name == "max_page":
        data = make_data("text", 9000, seed=41) + \
            make_data("structured", 8192, seed=42)
        return data, encode_page(data, is_last=True), 131072
    if name == "chained_copies":
        # copies that chain across group boundaries at every cw: distance-1
        # runs longer than 2048 bytes, and copies whose source lies in the
        # previous 128-byte group
        r = np.random.default_rng(11)
        cmds = [(1, 3000, 1), (7, 130, 129), (2, 700, 3), (40, 1000, 160),
                (1, 2500, 1), (9, 333, 300), (5, 4100, 2), (64, 250, 200),
                (3, 2049, 1), (11, 126, 127)]
        out = bytearray()
        for ins, cpy, d in cmds:
            out += r.integers(0, 256, ins, dtype=np.uint8).tobytes()
            for _ in range(cpy):
                out.append(out[-d])
        ins, cpy, dist = (np.array(c, np.uint32) for c in zip(*cmds))
        data = bytes(out)
        return data, native.encode_page_cmds(data, True, ins, cpy, dist), PS
    raise ValueError(name)


EDGE_CASES = ("single_command", "dense_commands", "max_page",
              "chained_copies")


def plain_phase_a(comps, page_size: int, device="cpu"):
    st = stage(comps, device)
    tabs = tables_from_lengths(*load_tables_plain(st.buf))
    return st, tabs, phase_a_plain(st.buf, st.npd, tabs, page_size)


@pytest.fixture(scope="module")
def mixed():
    datas, comps = mixed_pages()
    assert all(c is not None for c in comps)
    return datas, comps, plain_phase_a(comps, PS)[2]


def test_phase_a_plain_matches_jax_xla(mixed):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from brotlig_tpu.ops.decode import _resolve_distances, _stage_symbols
    from test_ops_decode import batch

    _, comps, got = mixed
    mc = TD.max_cmds_for(PS)
    words, sizes = batch(comps, PS)
    ncmds, litbuf, ins, cpy, dcode, dextra, npf, ndi, *_ = \
        _stage_symbols(words, sizes, PS, mc)
    valid = jnp.arange(mc)[None, :] < ncmds[:, None]
    ins_m = jnp.where(valid, ins, 0)
    cpy_m = jnp.where(valid, cpy, 0)
    dist = np.asarray(_resolve_distances(ins_m, cpy_m, dcode, dextra, ncmds,
                                         npf, ndi, mc))
    ncmds, ins, cpy, litbuf = (np.asarray(a) for a in
                               (ncmds, ins_m, cpy_m, litbuf))

    np.testing.assert_array_equal(got.ncmds.numpy(), ncmds)
    assert int(got.status.abs().sum()) == 0
    for p, k in enumerate(ncmds):
        np.testing.assert_array_equal(got.ins[p, :k].numpy(), ins[p, :k])
        np.testing.assert_array_equal(got.cpy[p, :k].numpy(), cpy[p, :k])
        copies = cpy[p, :k] > 0          # a distance matters on copies
        np.testing.assert_array_equal(got.dist[p, :k].numpy()[copies],
                                      dist[p, :k][copies])
        nlit = int(ins[p, :k].sum())
        np.testing.assert_array_equal(got.litq[p, :nlit].numpy(),
                                      litbuf[p, :nlit])


def test_sweep_plain_matches_jax_phase_b(mixed):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from brotlig_tpu.ops.decode import _phase_b

    datas, _, a = mixed
    got = sweep_plain(a.ncmds, a.litq, a.ins, a.cpy, a.dist, PS).numpy()
    want = np.asarray(_phase_b(*(jnp.asarray(x.numpy().astype(np.int32))
                                 if x.dtype != torch.uint8
                                 else jnp.asarray(x.numpy())
                                 for x in (a.ncmds, a.litq, a.ins, a.cpy,
                                           a.dist)), PS))
    for p, d in enumerate(datas):
        n = len(d)
        np.testing.assert_array_equal(got[p, :n], want[p, :n])
        assert got[p, :n].tobytes() == d
        assert not got[p, n:].any()        # zero past the coverage


def test_middle_stage_lays_out_the_sweep_inputs(mixed):
    """What the sweep kernel reads, from the phase-A result: per page, the
    output, copy and literal starts of each command by exclusive cumsum,
    FAR_START past ncmds, and the bytes covered."""
    _, _, a = mixed
    got = middle_stage(a.ncmds, a.litq, a.ins, a.cpy, a.dist, PS)
    n = int(a.ncmds.max())
    assert got.st.shape == (len(a.ncmds), n)
    for p, k in enumerate(a.ncmds.tolist()):
        ins, cpy = a.ins[p, :k].numpy(), a.cpy[p, :k].numpy()
        st = np.cumsum(ins + cpy) - ins - cpy
        np.testing.assert_array_equal(got.st[p, :k].numpy(), st)
        assert (got.st[p, k:] == FAR_START).all()
        np.testing.assert_array_equal(got.cst[p, :k].numpy(), st + ins)
        np.testing.assert_array_equal(got.lst[p, :k].numpy(),
                                      np.cumsum(ins) - ins)
        np.testing.assert_array_equal(got.dist[p, :k].numpy(),
                                      a.dist[p, :k].numpy())
        assert int(got.total[p]) == int((ins + cpy).sum())


@pytest.mark.parametrize("cw", TD.VALID_SWEEP_CW)
@pytest.mark.parametrize("case", EDGE_CASES)
def test_two_phase_decode_edge_inputs(case, cw):
    data, comp, page_size = edge_case(case)
    blob = one_page_container(comp, len(data), page_size)
    assert brotlig_tpu_torch.decode(blob, device="cpu", variant="two_phase",
                                    sweep_cw=cw) == data


@pytest.mark.parametrize("variant", (None,) + TD.VALID_VARIANTS)
def test_every_variant_decodes_on_cpu(variant):
    data = make_data("text", PS, seed=3) + make_data("structured", 9000)
    blob = native.encode(data, page_size=PS)
    assert brotlig_tpu_torch.decode(blob, device="cpu", variant=variant,
                                    sweep_cw=512) == data


@pytest.mark.parametrize("variant,cw", [("bad", 1024), ("two_phase", 256),
                                        (None, 64)])
def test_bad_options_raise_the_jax_error(variant, cw):
    pytest.importorskip("jax")
    from brotlig_tpu.ops.decode import _check_opts
    with pytest.raises(ValueError) as want:
        _check_opts(variant, cw)
    blob = native.encode(make_data("text", 5000), page_size=PS)
    with pytest.raises(ValueError) as got:
        brotlig_tpu_torch.decode(blob, device="cpu", variant=variant,
                                 sweep_cw=cw)
    assert str(got.value) == str(want.value)
