"""The port's public API: import hygiene, device handling, and the errors
and format constants it shares with the JAX package."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import brotlig_tpu
import brotlig_tpu_torch
from brotlig_tpu import native
from brotlig_tpu.format import constants as C
from brotlig_tpu.format.headers import parse_container
from brotlig_tpu.format.precondition import DataConditionParams
from brotlig_tpu.refimpl.codec import encode
from test_roundtrip import make_data
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    """Every .py file of the port, and chip_smoke.py."""
    pkg = os.path.join(REPO, "brotlig_tpu_torch")
    found = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        found += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return found


def test_import_pulls_in_no_jax():
    """Importing the port and every module of it loads neither JAX nor
    any module of the JAX package."""
    mods = []
    for path in _port_sources()[1:]:
        mod = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(mod.removesuffix(".__init__"))
    for m in ("brotlig_tpu_torch.ops.sweep_kernel",
              "brotlig_tpu_torch.ops.precondition",
              "brotlig_tpu_torch.parallel",
              "brotlig_tpu_torch.parallel.runtime",
              "brotlig_tpu_torch.ops.encode",
              "brotlig_tpu_torch.ops.encode_pack",
              "brotlig_tpu_torch.ops.parse_dp",
              "brotlig_tpu_torch.ops.dp_kernel",
              "brotlig_tpu_torch.cli",
              "brotlig_tpu_torch.utils.brotli_codec",
              "brotlig_tpu_torch.parallel.sharding",
              "brotlig_tpu_torch.entry",
              "brotlig_tpu_torch.tools.profile_decode",
              "brotlig_tpu_torch.tools.profile_encode",
              "brotlig_tpu_torch.utils.corpus",
              "brotlig_tpu_torch.refimpl.codec",
              "brotlig_tpu_torch.ops.ref_parse_kernel"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', "
            "'brotlig_tpu') or m.startswith(('jax.', 'brotlig_tpu.')))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_package_sources_never_import_jax():
    imports_jax_package = re.compile(
        r"^\s*(import|from)\s+brotlig_tpu(\.|\s|$)", re.M)
    for path in _port_sources():
        with open(path) as fh:
            src = fh.read()
        assert "import jax" not in src and "from jax" not in src, path
        assert not imports_jax_package.search(src), path


def test_format_constants_equal_the_jax_package():
    from brotlig_tpu.format import constants as want
    from brotlig_tpu_torch.format import constants as got
    names = [n for n in dir(want) if n.isupper()]
    assert names == [n for n in dir(got) if n.isupper()]
    for n in names:
        assert getattr(got, n) == getattr(want, n), n
    for size in (0, 1, 70_000, 1 << 24):
        assert got.max_compressed_size(size) == want.max_compressed_size(size)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    blob = native.encode(make_data("text", 5000))
    with pytest.raises(RuntimeError, match="cuda"):
        brotlig_tpu_torch.decode(blob, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        brotlig_tpu_torch.decode(blob)          # the default device


def test_preconditioned_container_decodes():
    rng = np.random.default_rng(1)
    size = 32 * 32 * 8                      # 128x128 BC1: 32x32 blocks
    tex = ((rng.integers(0, 8, size=size) + np.arange(size) // 64) % 256) \
        .astype(np.uint8).tobytes()
    p = DataConditionParams(
        precondition=True, swizzle=True, delta_encode=True,
        format=C.DATA_FORMAT_BC1, width_in_pixels=128, height_in_pixels=128,
        num_mip_levels=1)
    blob = encode(tex, page_size=C.MIN_PAGE_SIZE, dc_params=p)
    assert parse_container(blob).dc_params is not None
    assert brotlig_tpu_torch.decode(blob, device="cpu") == tex


def test_bad_magic_same_error_as_jax_package():
    pytest.importorskip("jax")
    from brotlig_tpu.ops.decode import decode_stream_jax
    blob = bytearray(native.encode(make_data("text", 5000)))
    blob[1] ^= 0xFF
    with pytest.raises(ValueError) as want:
        decode_stream_jax(bytes(blob))
    with pytest.raises(ValueError) as got:
        brotlig_tpu_torch.decode(bytes(blob), device="cpu")
    # the port raises its own copy of the error class: same name, code
    # and message
    assert type(got.value).__name__ == type(want.value).__name__
    assert got.value.code == want.value.code
    assert str(got.value) == str(want.value)


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        brotlig_tpu_torch.decode(native.encode(b"x" * 100), device="meta")


def test_sizes_and_empty_input():
    data = make_data("structured", 70_000, seed=4)
    blob = native.encode(data)
    assert brotlig_tpu_torch.decompressed_size(blob) == len(data)
    assert brotlig_tpu_torch.max_compressed_size(len(data)) == \
        brotlig_tpu.max_compressed_size(len(data))
    assert brotlig_tpu_torch.decode(native.encode(b""), device="cpu") == b""
    assert brotlig_tpu_torch.decode(blob, device="cpu") == data
