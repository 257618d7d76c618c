"""The port's arith_lut and bits ops against the JAX package's, exhaustively
over every code and symbol, and on random word buffers. Exact equality."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from brotlig_tpu.format import constants as C
from brotlig_tpu.format import lut
from brotlig_tpu.ops import arith_lut as jax_lut
from brotlig_tpu.ops import bits as jax_bits

from brotlig_tpu_torch.ops import arith_lut, bits
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("name", ["insert_extra", "insert_base",
                                  "copy_extra", "copy_base"])
def test_length_code_tables(name):
    c = np.arange(24, dtype=np.int32)
    got = getattr(arith_lut, name)(_t(c)).numpy()
    np.testing.assert_array_equal(got, getattr(lut, name.upper()))
    np.testing.assert_array_equal(
        got, np.asarray(getattr(jax_lut, name)(jnp.asarray(c))))


def test_split_command_all_codes():
    sym = np.arange(C.NUM_COMMAND_SYMBOLS, dtype=np.int32)
    ic, cc = arith_lut.split_command(_t(sym))
    np.testing.assert_array_equal(ic.numpy(), lut.CMD_INSERT_CODE[:704])
    np.testing.assert_array_equal(cc.numpy(), lut.CMD_COPY_CODE[:704])
    jic, jcc = jax_lut.split_command(jnp.asarray(sym))
    np.testing.assert_array_equal(ic.numpy(), np.asarray(jic))
    np.testing.assert_array_equal(cc.numpy(), np.asarray(jcc))


def test_reverse_bits_15_every_value():
    v = np.arange(1 << 15, dtype=np.uint32)
    np.testing.assert_array_equal(
        bits.reverse_bits_15(_t(v)).numpy(),
        np.asarray(jax_bits.reverse_bits_15(jnp.asarray(v))))


@pytest.fixture(scope="module")
def words():
    rng = np.random.default_rng(5)
    return rng.integers(0, 1 << 32, size=(3, 40), dtype=np.uint64) \
        .astype(np.uint32)


@pytest.mark.parametrize("fn", ["peek_bits", "peek_bits_fused"])
@pytest.mark.parametrize("n", [0, 1, 5, 9, 15, 24, 30, 32])
def test_peek_bits(words, fn, n):
    rng = np.random.default_rng(n)
    pos = rng.integers(0, 32 * 38, size=(3, 32)).astype(np.int32)
    got = getattr(bits, fn)(_t(words), _t(pos), n).numpy()
    want = np.asarray(getattr(jax_bits, fn)(jnp.asarray(words),
                                            jnp.asarray(pos), n))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_fetch_window_and_extract(words):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 32 * 30, size=(3, 32)).astype(np.int32)
    win, sh = bits.fetch_window(_t(words), _t(pos), 6)
    jwin, jsh = jax_bits.fetch_window(jnp.asarray(words), jnp.asarray(pos), 6)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    np.testing.assert_array_equal(sh.numpy(), np.asarray(jsh))
    for delta in (0, 7, 31, 64, 100, 139):
        n = rng.integers(0, 31, size=(3, 32)).astype(np.int32)
        got = bits.extract_bits(win, sh, delta, _t(n), 6).numpy()
        want = np.asarray(jax_bits.extract_bits(jwin, jsh, delta,
                                                jnp.asarray(n), 6))
        np.testing.assert_array_equal(got, want.astype(np.int64))
