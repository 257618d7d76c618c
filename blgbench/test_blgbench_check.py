"""How `correct` is decided, on the CPU: the plain decoder judges the
port's containers, every cell's run is correct as it stands, and the
control and each fault the cell can have turn it false."""
import os

import pytest

from blgbench import check, harness, reference
from blgbench.data import assets, textures
from blgbench.inputs import texture_dc

SPEC = harness.benchmark()


def small_config(cell: dict) -> dict:
    """The cell's configuration at a size the CPU route runs in seconds:
    the first entries, cut short; textures at 256 x 256."""
    cfg = harness.load(os.path.join(harness.BENCH, "configs",
                                    f"{cell['config']}.json"))
    if cfg["kind"] == "bundle":
        cfg["assets"] = [dict(a, bytes=a["bytes"] // 8)
                         for a in cfg["assets"][:5]]
    else:
        cfg["textures"] = [dict(t, width=256, height=256)
                           for t in cfg["textures"][3:]]
    return cfg


def small_traffic(cell: dict) -> dict:
    """The cell's traffic with one warm-up pass; an encode at quality 1,
    since the plain version of the quality-11 DP takes over a minute a
    page on the CPU."""
    traffic = harness.load(os.path.join(harness.BENCH, "traffic",
                                        f"{cell['traffic']}.json"))
    traffic["warmup_passes"] = 1
    if traffic["op"] == "encode":
        traffic["args"] = dict(traffic["args"], quality=1)
    return traffic


@pytest.mark.parametrize("kind", assets.KINDS)
def test_reference_decodes_the_ports_bundle_containers(kind):
    import brotlig_tpu_torch as blg
    data = assets.make_asset(kind, 100000, 2 ** 35 + 1, 2)
    for kw in (dict(backend="native", quality=11),
               dict(backend="full", quality=1, device="cpu"),
               dict(backend="hybrid", device="cpu")):
        blob = blg.encode(data, **kw)
        assert reference.decode(blob) == data, kw


@pytest.mark.parametrize("fmt", sorted(textures.BLOCK_BYTES))
def test_reference_decodes_the_ports_texture_containers(fmt):
    import brotlig_tpu_torch as blg
    from brotlig_tpu_torch.format.precondition import DataConditionParams
    t = {"format": fmt, "width": 256, "height": 256, "mips": "full",
         "swizzle": True, "delta": True}
    dc = texture_dc(t)
    tex = textures.make_texture(fmt, 256, 256, dc["num_mip_levels"], 11, 0)
    blob = blg.encode(tex, dc_params=DataConditionParams(**dc),
                      backend="hybrid", device="cpu")
    assert reference.decode(blob) == tex


def test_reference_is_the_ports_decoder_frozen():
    """Each copied file is its source with only the import lines and the
    first comment line changed."""
    port = os.path.join(harness.ROOT, "brotlig_tpu_torch")
    ref = os.path.join(harness.BENCH, "reference")
    pairs = [(os.path.join(port, "format", f), os.path.join(ref, f))
             for f in sorted(os.listdir(ref))
             if f.endswith(".py") and f not in ("__init__.py",
                                                "page_decoder.py")]
    pairs.append((os.path.join(port, "refimpl", "page_decoder.py"),
                  os.path.join(ref, "page_decoder.py")))
    for src, copy in pairs:
        a = open(src).read().splitlines()
        b = open(copy).read().splitlines()[1:]
        assert len(a) == len(b), copy
        for x, y in zip(a, b):
            if x != y:
                assert x.startswith("from ..") and y.startswith("from ."), y


def test_bad_bytes_counts_differences_and_length():
    assert check.bad_bytes(b"abcd", b"abcd") == 0
    assert check.bad_bytes(b"abXd", b"abcd") == 1
    assert check.bad_bytes(b"ab", b"abcd") == 2


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
@pytest.mark.parametrize("fault", [None, *check.FAULTS])
def test_a_run_is_correct_and_each_fault_is_caught(cell, fault):
    """The whole run after the look for a card, at a small size on the
    CPU: sound, it is correct; with the control ("lossy") or a fault
    planted in the timed path, `correct` comes out false."""
    c = harness.find(SPEC["workloads"], cell, "workload")
    r = harness.run_cell(c, SPEC, 2 ** 33 + 17, 0.05, False, fault,
                         device="cpu", config=small_config(c),
                         traffic=small_traffic(c))
    checks = r["checks"]
    assert checks["judged_calls"]["value"] >= 1
    if fault is None:
        assert r["correct"] and r["failed"] == 0
        assert checks["bad_bytes"]["value"] == 0
        # the CPU's trace holds no device interval: a metric read from
        # the device trace finds nothing there, and is left out
        assert set(r["metrics"]) == {
            m["name"] for m in harness.cell_metrics(SPEC, cell, "end_to_end")
            if m["source"] != "device_trace"}
    else:
        assert not r["correct"] and r["failed"] >= 1
        assert checks["bad_bytes"]["value"] > 0
    assert list(r)[-1] == "checks"
