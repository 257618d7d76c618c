"""The harness on the CPU: the files it finds by name, the generators, the
window's arithmetic, the rooflines' byte counts and the import guard."""
import ast
import json
import os
import re
import subprocess
import sys
import time

import pytest

from blgbench import harness, roofline
from blgbench.data import assets, textures
from blgbench.harness import Record
from blgbench.inputs import Item, texture_dc
from blgbench.tracing import Trace
from blgbench.reference.precondition import DataConditionParams

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SPEC = harness.benchmark()


def test_cells_find_their_files_by_name():
    assert SPEC["paths"] == ["blgbench"]
    for cfg in SPEC["configs"]:
        on_disk = harness.load(os.path.join(harness.ROOT, cfg["file"]))
        assert on_disk["name"] == cfg["name"]
        assert on_disk["source"] == cfg["source"]
        for key in cfg["reduced"]:
            assert key in on_disk
    for cell in SPEC["workloads"]:
        assert cell["chips"] == 1
        for folder, name in (("configs", cell["config"]),
                             ("traffic", cell["traffic"])):
            assert os.path.exists(os.path.join(harness.BENCH, folder,
                                               f"{name}.json"))
    for m in SPEC["per_layer"] + SPEC["end_to_end"]:
        assert callable(harness.metric_reader(m["name"]))


def test_spec_keeps_the_contract_shape():
    cells = {c["name"] for c in SPEC["workloads"]}
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for n in names + list(cells) + [c["name"] for c in SPEC["configs"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(
                SPEC, w, "end_to_end")}
    for c in cells:
        got = {m["name"] for m in harness.cell_metrics(SPEC, c, "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        assert harness.cell_metrics(SPEC, c, "per_layer")
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_generators_repeat_by_seed():
    big = 2 ** 33 + 7
    for kind in assets.KINDS:
        a = assets.make_asset(kind, 70001, big, 3)
        assert len(a) == 70001
        assert a == assets.make_asset(kind, 70001, big, 3)
        assert a != assets.make_asset(kind, 70001, big + 1, 3)
        assert a != assets.make_asset(kind, 70001, big, 4)
    for fmt in textures.BLOCK_BYTES:
        mips = textures.full_mips(256, 128)
        t = textures.make_texture(fmt, 256, 128, mips, big, 0)
        assert t == textures.make_texture(fmt, 256, 128, mips, big, 0)
        assert t != textures.make_texture(fmt, 256, 128, mips, big, 1)
        p = DataConditionParams(**texture_dc(
            {"format": fmt, "width": 256, "height": 128, "mips": "full",
             "swizzle": True, "delta": True}))
        assert p.initialize(len(t))           # the container's geometry


def test_texture_set_sizes():
    cfg = harness.load(os.path.join(harness.BENCH, "configs",
                                    "bc_textures_64k.json"))
    sizes = {t["name"]: textures.texture_size(
        t["format"], t["width"], t["height"],
        textures.full_mips(t["width"], t["height"])) / 2 ** 20
        for t in cfg["textures"]}
    assert round(sizes["bc1_4096"], 2) == 10.67
    assert round(sizes["bc5_4096"], 2) == 21.33
    assert round(sizes["bc3_2048"], 2) == 5.33
    assert sum(sizes.values()) * 2 ** 20 == cfg["texture_set_bytes"]


def test_window_closes_with_the_pass_in_flight():
    items = [Item(f"i{k}", bytes(1000 * (k + 1))) for k in range(2)]

    def call(it):
        time.sleep(0.05)
        return it.data
    records, kept, window_s = harness.window(items, call, 0.12,
                                             lambda k: k < 2, False)
    # 0.05, 0.10, 0.15 passes the deadline mid-pass, 0.20 ends the pass
    assert len(records) == 4
    assert records[2].t0 < records[0].t0 + 0.12 <= records[2].t1
    assert window_s == pytest.approx(records[-1].t1 - records[0].t0,
                                     abs=1e-3)
    assert sorted(kept) == [0, 1]
    rates = harness.quarter_rates(records, items)
    assert sum(rates) * window_s / 4 == pytest.approx(6000 / 1e6, rel=1e-2)


def test_window_counts_a_raising_call_as_failed():
    items = [Item("bad", b"y"), Item("ok", b"x")]

    def call(it):
        if it.name == "bad":
            raise ValueError("corrupt stream")
        return it.data
    records, kept, _ = harness.window(items, call, 0.0, lambda k: True,
                                      False)
    assert [r.ok for r in records] == [False, True] and list(kept) == [1]


def test_rates_and_ratio_readers():
    items = [Item("a", bytes(300)), Item("b", bytes(100))]
    records = [Record(0, 0, 1, True, 100), Record(1, 1, 2, True, 100),
               Record(0, 2, 3, True, 100), Record(1, 3, 4, False)]
    run = harness.Run(items, records, 2.0, 9.5)
    assert harness.metric_reader("ratio")(run) == 2.0
    assert harness.metric_reader("encode_mbps")(run) == 700 / 2.0 / 1e6
    assert harness.metric_reader("decode_gbps")(run) == 700 / 2.0 / 1e9
    assert harness.metric_reader("setup_s")(run) == 9.5
    assert harness.metric_reader("asset_p95_ms")(run) == pytest.approx(
        1000.0)
    assert harness.metric_reader("decode_gbps.resident")(run) == \
        700 / 2.0 / 1e9
    for m in SPEC["per_layer"] + SPEC["end_to_end"]:
        if m["source"] == "device_trace":
            assert harness.metric_reader(m["name"])(run) is None
    # 0.07 s of the card's time over 700 bytes: 1e8 ms a GB
    run.trace = Trace(2.0, 0.07)
    assert harness.metric_reader("decode_device_ms_per_gb")(run) == \
        pytest.approx(0.07e3 / (700 / 1e9))
    run.trace = Trace(2.0, 0.0)
    assert harness.metric_reader("decode_device_ms_per_gb")(run) is None


def test_roofline_bytes_from_the_page_table():
    import brotlig_tpu_torch as blg
    from brotlig_tpu_torch.format.headers import parse_container
    data = (assets.make_asset("text", 150000, 5, 0)
            + assets.make_asset("audio", 70000, 5, 1))
    blob = blg.encode(data, backend="native", quality=1)
    info = parse_container(blob)
    comp = info.compressed_page_indices()
    assert info.raw_page_indices()          # the random tail stays raw
    want = sum(int(info.sizes[i]) + info.page_out_sizes[i] for i in comp)
    assert roofline.decode_kernel_bytes(blob) == want
    assert roofline.precond_bytes(blob) == 0
    tex = textures.make_texture("bc1", 256, 256, 9, 5, 0)
    from brotlig_tpu_torch.format.precondition import \
        DataConditionParams as PortParams
    dc = PortParams(**texture_dc({"format": "bc1", "width": 256,
                                  "height": 256, "mips": 9,
                                  "swizzle": True, "delta": True}))
    tblob = blg.encode(tex, dc_params=dc, backend="hybrid", device="cpu")
    assert roofline.precond_bytes(tblob) == 2 * len(tex)
    assert roofline.share_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert roofline.share_pct(10, None) is None


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_reference_nothing_of_the_port():
    for dirpath, _, files in os.walk(harness.BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".", 1)[0] for m in _imports(path)}
            assert not tops & set(harness.FORBIDDEN), path
            if os.sep + "reference" in path:
                assert "brotlig_tpu_torch" not in tops, path


def test_a_run_loads_no_jax_module():
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from blgbench import harness\n"
        "spec = harness.benchmark()\n"
        "cell = harness.find(spec['workloads'], 'bundle64k_q11.stream', 'w')\n"
        "cfg = harness.load('blgbench/configs/bundle64k_q11.json')\n"
        "cfg['assets'] = [dict(a, bytes=4096) for a in cfg['assets'][:2]]\n"
        "traffic = dict(harness.load('blgbench/traffic/stream.json'),"
        " warmup_passes=1)\n"
        "r = harness.run_cell(cell, spec, 1, 0.01, True, device='cpu',"
        " config=cfg, traffic=traffic)\n"
        "print(json.dumps([r['correct'], harness.forbidden_modules(),"
        " sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'brotlig_tpu'))]))\n") % harness.ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, [], []]


def test_forbidden_modules_compare_whole_top_level_names():
    before = set(sys.modules)
    try:
        sys.modules["brotlig_tpu_torch_lookalike"] = object()
        assert harness.forbidden_modules() == []
        sys.modules["jax.numpy"] = object()
        assert harness.forbidden_modules() == ["jax"]
    finally:
        for m in set(sys.modules) - before:
            del sys.modules[m]


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    cmd = [sys.executable, "blgbench/run.py", "--workload",
           "bundle64k_q11.stream", "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    import torch
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0 and not out.stdout.strip()
    # a checkout of BENCHMARK.json and blgbench/ alone: no program
    import shutil
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "blgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from blgbench import harness\n"
        "spec = harness.benchmark()\n"
        "cell = harness.find(spec['workloads'], 'bundle64k_q11.stream', 'w')\n"
        "cfg = harness.load('blgbench/configs/bundle64k_q11.json')\n"
        "cfg['assets'] = cfg['assets'][:1]\n"
        "harness.run_cell(cell, spec, 1, 0.01, False, device='cpu',"
        " config=cfg)\n") % str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "No module named 'brotlig_tpu_torch'" in out.stderr
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
