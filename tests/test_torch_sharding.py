"""The port's multi-device and multi-process decode and encode on the CPU
(brotlig_tpu_torch/parallel/sharding.py, the gathers of
parallel/runtime.py), decode_cpu, env_decode_opts, entry.py and the
profile tools.

The references are the JAX package's host functions (its native decoder
and encoder, its Python decoder for preconditioned streams, its
environment parsing): this module compiles no JAX executable. Every
comparison is exact, tolerance 0: the format is lossless. The split runs
over "cpu" entries of a device list, where every kernel wrapper takes its
plain version; tests/test_torch_kernels.py runs it over the card.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from brotlig_tpu import api as japi
from brotlig_tpu import native as jnative
from brotlig_tpu.ops import decode as jdecode
from brotlig_tpu.parallel import runtime as jruntime

import brotlig_tpu_torch
from brotlig_tpu_torch import entry
from brotlig_tpu_torch.format.headers import parse_container
from brotlig_tpu_torch.ops import decode as TD
from brotlig_tpu_torch.parallel import runtime, sharding
from test_roundtrip import make_data
from test_torch_parallel import archive_mix
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS = 32768


def seven_pages():
    """Seven full 32 KiB pages of mixed kinds: shares of 3, 2 and 2 pages
    over three devices."""
    kinds = ("text", "repetitive", "zeros", "text", "repetitive", "zeros",
             "text")
    data = b"".join(make_data(k, PS, seed=20 + i)
                    for i, k in enumerate(kinds))
    return data, jnative.encode(data, page_size=PS, quality=1)


def raw_and_short_last():
    """Random (raw) pages at 1 and 3, on both sides of share edges, and a
    short last page."""
    parts = [make_data("text", PS, 1), make_data("random", PS, 2),
             make_data("zeros", PS, 3), make_data("random", PS, 4),
             make_data("text", PS, 5), make_data("repetitive", 5000, 6)]
    data = b"".join(parts)
    return data, jnative.encode(data, page_size=PS, quality=1)


def empty():
    return b"", jnative.encode(b"", page_size=PS)


@pytest.fixture(scope="module")
def bc1():
    """dryrun_multichip's BC1 container at 32 KiB pages: four pages,
    preconditioned (swizzle, delta), pages 0 and 2 raw, the last page
    short."""
    return entry.bc1_container(PS, 4, "cpu")


def count_rows(monkeypatch):
    """Record the pages of every batch that reaches the decode route."""
    rows = []
    decode_batch = TD.decode_batch

    def counted(staged, *args, **kwargs):
        rows.append(staged.buf.shape[1])
        return decode_batch(staged, *args, **kwargs)
    monkeypatch.setattr(TD, "decode_batch", counted)
    return rows


@pytest.mark.parametrize("case,n_dev", [
    ("seven_pages", 3), ("raw_and_short_last", 3), ("bc1", 3),
    ("empty", 3), ("more_devices_than_pages", 5)])
def test_decode_stream_sharded(case, n_dev, bc1, monkeypatch):
    """decode_stream_sharded over "cpu" shares equals the input and the
    JAX package's decode_cpu; every compressed page reaches the route
    exactly once (no padding rows, no dummy page)."""
    if case == "bc1":
        data, blob = bc1
        info = parse_container(blob)
        assert info.dc_params is not None and info.raw_page_indices()
        assert info.page_out_sizes[-1] < PS
    elif case == "more_devices_than_pages":
        data = make_data("text", PS + 700, 9)
        blob = jnative.encode(data, page_size=PS, quality=1)
    else:
        data, blob = {"seven_pages": seven_pages,
                      "raw_and_short_last": raw_and_short_last,
                      "empty": empty}[case]()
    if case == "raw_and_short_last":
        assert parse_container(blob).raw_page_indices() == [1, 3]
    n_comp = len(parse_container(blob).compressed_page_indices())
    rows = count_rows(monkeypatch)
    got = sharding.decode_stream_sharded(blob, ["cpu"] * n_dev,
                                         batch_pages=2)
    assert got == data
    assert got == japi.decode_cpu(blob)
    assert sum(rows) == n_comp
    # each share is its own run of batches of at most two pages
    shares = [hi - lo for lo, hi in sharding.shard_bounds(n_comp, n_dev)]
    assert len(rows) == sum(-(-n // 2) for n in shares)


def test_shard_bounds():
    assert sharding.shard_bounds(7, 3) == [(0, 3), (3, 5), (5, 7)]
    assert sharding.shard_bounds(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert sharding.shard_bounds(0, 2) == [(0, 0), (0, 0)]


def test_a_failing_share_fails_the_call(monkeypatch):
    """An error in one share propagates out of decode_stream_sharded, and
    a corrupt page raises ValueError("corrupt stream")."""
    _, blob = raw_and_short_last()
    calls = []
    decode_batch = TD.decode_batch

    def failing(staged, *args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("share failed")
        return decode_batch(staged, *args, **kwargs)
    monkeypatch.setattr(TD, "decode_batch", failing)
    with pytest.raises(RuntimeError, match="share failed"):
        sharding.decode_stream_sharded(blob, ["cpu"] * 3)
    monkeypatch.undo()
    info = parse_container(blob)
    off, n = int(info.offsets[4]), int(info.sizes[4])
    bad = bytearray(blob)
    bad[off: off + n] = bytes(n)        # an all-zero page overruns
    with pytest.raises(ValueError, match="corrupt stream"):
        sharding.decode_stream_sharded(bytes(bad), ["cpu"] * 3)


def test_decode_pages_sharded_equals_unsharded():
    """Both page decoders over two "cpu" shares equal the port's unsharded
    decode_pages, pages and delta flags."""
    pages, comps = entry.example_pages(3)
    words, sizes = entry.example_words(comps)
    want_out, want_isd = TD.decode_pages(
        torch.from_numpy(words.astype(np.int64)), torch.from_numpy(sizes),
        PS, TD.max_cmds_for(PS))
    for fn in (sharding.decode_pages_sharded,
               sharding.decode_pages_sharded_kernel):
        out, isd = fn(words, sizes, PS, ["cpu", "cpu"])
        assert torch.equal(out, want_out)
        assert torch.equal(isd, want_isd.to(torch.bool))
    assert out.numpy().tobytes() == b"".join(pages)


def test_no_path_hides_the_device(monkeypatch):
    """Without CUDA every entry point that defaults to the card raises,
    and so does a dry run over fewer devices than it asks for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, blob = seven_pages()
    with pytest.raises(RuntimeError):
        sharding.device_list()
    with pytest.raises(RuntimeError):
        sharding.device_list(["cpu", "cuda"])
    with pytest.raises(RuntimeError):
        sharding.decode_stream_sharded(blob)
    with pytest.raises(RuntimeError):
        entry.entry()
    with pytest.raises(RuntimeError):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError):
        entry.dryrun_multichip(3, devices=["cpu", "cpu"])


def test_decode_cpu_equals_jax(bc1):
    """decode_cpu equals brotlig_tpu.api.decode_cpu on plain containers
    (the native decoder) and on preconditioned ones (a page at a time,
    delta decoded and deconditioned on the host)."""
    datas, blobs = archive_mix()
    cases = [(datas[0], blobs[0]), (datas[5], blobs[5]),
             (datas[6], blobs[6]), bc1, raw_and_short_last()]
    assert parse_container(blobs[5]).dc_params is not None
    for data, blob in cases:
        got = brotlig_tpu_torch.decode_cpu(blob)
        assert got == japi.decode_cpu(blob) == data
        assert brotlig_tpu_torch.decode_cpu(blob, num_threads=1) == got


ENV_CASES = [
    {}, {"BLG_VARIANT": "two_phase"}, {"BLG_VARIANT": "xla"},
    {"BLG_VARIANT": "fused", "BLG_PALLAS": "0"}, {"BLG_PALLAS": "0"},
    {"BLG_FUSED": "0"}, {"BLG_PALLAS": "0", "BLG_FUSED": "0"},
    {"BLG_PALLAS": "1", "BLG_FUSED": "1"}, {"BLG_SWEEP_CW": "128"},
    {"BLG_SWEEP_CW": "512"}, {"BLG_SWEEP_CW": "1024"},
    {"BLG_FUSED": "0", "BLG_SWEEP_CW": "2048"}, {"BLG_VARIANT": "pallas"},
    {"BLG_SWEEP_CW": "100"}, {"BLG_SWEEP_CW": "wide"},
    {"BLG_VARIANT": "", "BLG_SWEEP_CW": "256"}]


@pytest.mark.parametrize("env", ENV_CASES,
                         ids=[",".join(f"{k}={v}" for k, v in e.items())
                              or "unset" for e in ENV_CASES])
def test_env_decode_opts_equals_jax(env, monkeypatch):
    """The BLG_* parsing equals the JAX package's, its errors included."""
    for k in ("BLG_VARIANT", "BLG_PALLAS", "BLG_FUSED", "BLG_SWEEP_CW"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def outcome(fn):
        try:
            return fn()
        except ValueError as e:
            return ("ValueError", str(e))
    assert outcome(TD.env_decode_opts) == outcome(jdecode.env_decode_opts)


def test_encode_archives_native_equals_jax():
    """encode_archives(backend="native") gives the JAX package's bytes
    (its default, the native q11 encoder), whole and by process share."""
    datas = [make_data(k, 9000 + 4000 * i, seed=60 + i)
             for i, k in enumerate(("text", "structured", "repetitive"))]
    for process in ((0, 1), (1, 2)):
        got = runtime.encode_archives(datas, page_size=PS, process=process,
                                      backend="native")
        assert got == jruntime.encode_archives(datas, page_size=PS,
                                               process=process)
    assert runtime.encode_archives_gather(
        datas, page_size=PS, process=(0, 1), backend="native") == \
        [jnative.encode(d, page_size=PS) for d in datas]


def test_entry_and_dryrun_on_cpu():
    """entry("cpu") decodes its example batch; dryrun_multichip runs its
    three steps over two "cpu" devices."""
    fn, args = entry.entry("cpu")
    pages, _ = entry.example_pages(2)
    assert fn(*args).numpy().tobytes() == b"".join(pages)
    entry.dryrun_multichip(2, devices=["cpu", "cpu"])


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


PROFILE_STAGES = {
    "decode": ("tables", "fused", "two_phase", "plain", "e2e"),
    "encode": ("matcher", "matcher_fast", "dp", "pack", "e2e_q1", "e2e_q11")}


@pytest.fixture(scope="module", autouse=True)
def profile_runs():
    """Both profile tools at 2 pages and one run a stage on the CPU (the
    DP narrowed further than tests/test_torch_encode_api.py's small_dp:
    W 32, R 1, one iteration), started in subprocesses when the module
    starts, so that they run beside its other tests (about 10 and 17 s);
    test_profile_tools_on_cpu reads them."""
    enc = ("import torch; torch.set_num_threads(1)\n"
           "from brotlig_tpu_torch.ops import parse_dp\n"
           "parse_dp.WINDOW, parse_dp.ROUNDS = 32, 1\n"
           "from brotlig_tpu_torch.tools import profile_encode\n"
           "profile_encode.main(['--device', 'cpu'])\n")
    env = _env(BENCH_PAGES="2", PROF_REPS="1", BLG_DP_ITERS="1")
    procs = {
        "decode": subprocess.Popen(
            [sys.executable, "-m", "brotlig_tpu_torch.tools.profile_decode",
             "--device", "cpu"], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "encode": subprocess.Popen(
            [sys.executable, "-c", enc], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


def test_profile_tools_on_cpu(profile_runs):
    """Each profile tool prints one JSON line with every stage's ms, its
    aten ops, and no CUDA kernels on the CPU."""
    for name, p in profile_runs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        res = json.loads(out.strip().splitlines()[-1])
        assert res["device"] == "cpu" and res["pages"] == 2
        assert tuple(res["ms"]) == PROFILE_STAGES[name]
        assert all(v > 0 for v in res["ms"].values())
        assert res["aten_ops"] > 0 and res["kernels"] is None


WORKER = """
import pickle, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, store, what = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=2, rank=rank)
from brotlig_tpu_torch.parallel import runtime
items = pickle.loads(open(sys.argv[4], "rb").read())
if what == "decode":
    out = runtime.decode_archives_gather(items, batch_pages=2,
                                         device="cpu")
else:
    out = runtime.encode_archives_gather(items, page_size=32768,
                                         backend="native", device="cpu")
dist.destroy_process_group()
open(sys.argv[5], "wb").write(pickle.dumps(out))
"""


def run_pair(tmp_path, what: str, items) -> list:
    """Two gloo ranks (a file:// store under tmp_path) run the gather
    `what` on `items`; returns each rank's output list."""
    (tmp_path / "worker.py").write_text(WORKER)
    (tmp_path / "items.pkl").write_bytes(pickle.dumps(items))
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(r),
         str(tmp_path / "store"), what, str(tmp_path / "items.pkl"),
         str(tmp_path / f"out_{r}.pkl")], env=_env(), cwd=REPO,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    return [pickle.loads((tmp_path / f"out_{r}.pkl").read_bytes())
            for r in range(2)]


def test_one_rank_group_exchanges(tmp_path, monkeypatch):
    """In a one-rank gloo group both gathers go through the exchange and
    give the local outputs."""
    import torch.distributed as dist
    datas = [make_data("text", 3000, 41), b"", make_data("zeros", 900, 42)]
    blobs = [jnative.encode(d, page_size=PS) for d in datas]
    exchanged = []
    gather = runtime._gather_owned

    def counted(*args):
        exchanged.append(1)
        return gather(*args)
    monkeypatch.setattr(runtime, "_gather_owned", counted)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        assert runtime.decode_archives_gather(blobs, device="cpu") == datas
        assert runtime.encode_archives_gather(
            datas, page_size=PS, backend="native") == blobs
    finally:
        dist.destroy_process_group()
    assert len(exchanged) == 2
    assert runtime.process_info() == (0, 1)


def test_two_process_decode_gather(tmp_path):
    """decode_archives_gather over two gloo processes hands every rank
    every archive, in order, equal to the inputs: a ragged spread of
    sizes (an empty archive, a short one, one of three pages), so the
    owners' shares differ."""
    datas = [make_data("text", 3 * PS - 100, 31), b"",
             make_data("structured", 700, 32),
             make_data("repetitive", PS + 9, 33),
             make_data("text", 20_000, 34)]
    blobs = [jnative.encode(d, page_size=PS, quality=1) for d in datas]
    for outs in run_pair(tmp_path, "decode", blobs):
        assert outs == datas


def test_two_process_encode_gather(tmp_path):
    """encode_archives_gather(backend="native") over two gloo processes
    hands every rank the JAX package's bytes for every input, in order."""
    datas = [make_data("text", 24_000 + 9000 * i, seed=70 + i)
             for i in range(4)] + [make_data("random", 3000, 75)]
    want = [jnative.encode(d, page_size=PS) for d in datas]
    for outs in run_pair(tmp_path, "encode", datas):
        assert outs == want
