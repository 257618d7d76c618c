"""The port's windowed-DP parse (ops/parse_dp.py, ops/encode.py's
find_candidates) held to the JAX package's on the CPU, with tolerance 0:
the candidates, the six cost-model outputs, the plain dp_parse, backtrack
and find_commands_dp with the greedy fallback, plus the float32
unseen-symbol cost over every table total that a page can have.

The JAX functions are XLA only (no Pallas kernel: dp_parse is a lax.scan).
Each one is called at the shapes of tests/test_ops_encode.py::TestParseDP
(five 2048-byte pages of its five kinds and seeds, B 32, W 256, R 6,
max_cmds S // 2 + 2), so JAX compiles the executables that test compiles.
Each port module gets the JAX module's inputs, so a difference shows in
the module that makes it.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from brotlig_tpu.ops import arith_lut as JA
from brotlig_tpu.ops import encode as JE
from brotlig_tpu.ops import parse_dp as JD
from brotlig_tpu_torch.ops import arith_lut as TA
from brotlig_tpu_torch.ops import encode as TE
from brotlig_tpu_torch.ops import encode_pack as TP
from brotlig_tpu_torch.ops import parse_dp as TD
from test_roundtrip import make_data
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

S = 2048
B, W, R = 32, 256, 6
MAX_CMDS = S // 2 + 2
KINDS = [("text", S), ("structured", S - 97), ("repetitive", S),
         ("random", 1000), ("zeros", S)]
FORCED = 2                 # the page whose DP parse is made to overflow
MODEL = ("litq", "jointEq", "jointLq", "cand_len", "cand_dist", "dpackq")


def pages():
    """TestParseDP's pages: (uint8 [5, S], int32 sizes)."""
    arr = np.zeros((len(KINDS), S), np.uint8)
    sizes = np.zeros(len(KINDS), np.int32)
    for i, (kind, n) in enumerate(KINDS):
        arr[i, :n] = np.frombuffer(make_data(kind, n, seed=i + 20), np.uint8)
        sizes[i] = n
    return arr, sizes


def overflow(backtrack):
    """backtrack, with page FORCED reported as over max_cmds (rows zero,
    ncmds -1, as backtrack leaves an overflowing page)."""
    def run(*args):
        out = backtrack(*args)
        for x in out:
            x[FORCED] = 0
        out[3][FORCED] = -1
        return out
    return run


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs, each stage fed the one before."""
    arr, sizes = pages()
    ja, js = jnp.asarray(arr), jnp.asarray(sizes)
    greedy = JE.find_commands(ja, js, MAX_CMDS)
    cand = JE.find_candidates(ja, js, W)
    model = JD.build_cost_model(ja, js, *greedy, *cand, MAX_CMDS)
    litq, jE, jL, cl, _, dpk = model
    combined = np.asarray(JD.dp_parse(litq, cl, dpk, jE, jL, B, W, R))
    np_model = [np.asarray(x) for x in model]
    bt = JD.backtrack(combined, np_model[3], np_model[4], np_model[5], sizes,
                      MAX_CMDS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "backtrack", overflow(JD.backtrack))
        fcdp = JD.find_commands_dp(arr, sizes, MAX_CMDS, iters=2, B=B, W=W,
                                   R=R)
    return dict(arr=arr, sizes=sizes,
                greedy=[np.asarray(x) for x in greedy],
                cand=[np.asarray(x) for x in cand], model=np_model,
                combined=combined, backtrack=bt, fcdp=fcdp)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def port_cand(ref):
    """The port's find_candidates on the pages, once for every row."""
    return TE.find_candidates(t(ref["arr"]), t(ref["sizes"]), W)


@pytest.fixture(scope="module")
def port_model(ref):
    """The port's cost model on the JAX module's inputs, once for every
    output."""
    return TD.build_cost_model(t(ref["arr"]), t(ref["sizes"]),
                               *map(t, ref["greedy"]), *map(t, ref["cand"]))


@pytest.mark.parametrize("row", range(len(KINDS)))
def test_find_candidates_matches_jax(ref, port_cand, row):
    for g, w in zip(port_cand, ref["cand"]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g[row].numpy(), w[row])


@pytest.mark.parametrize("name", MODEL)
def test_build_cost_model_matches_jax(ref, port_model, name):
    i = MODEL.index(name)
    assert port_model[i].dtype == torch.int32
    np.testing.assert_array_equal(port_model[i].numpy(), ref["model"][i])


def test_dp_parse_plain_matches_jax(ref):
    litq, jE, jL, cl, _, dpk = map(t, ref["model"])
    got = TD.dp_parse(litq, cl, dpk, jE, jL, B, W, R)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref["combined"])


@pytest.mark.parametrize("max_cmds", [MAX_CMDS, 200])
def test_backtrack_matches_jax(ref, max_cmds):
    """At max_cmds 200 the text and structured pages overflow (ncmds
    -1)."""
    m = ref["model"]
    args = (ref["combined"], m[3], m[4], m[5], ref["sizes"])
    want = (ref["backtrack"] if max_cmds == MAX_CMDS
            else JD.backtrack(*args, max_cmds))
    got = TD.backtrack(*args, max_cmds)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert (got[3] < 0).any() == (max_cmds == 200)


def test_find_commands_dp_matches_jax(ref, monkeypatch):
    """Two cost-model iterations; page FORCED overflows in each and keeps
    its greedy commands."""
    monkeypatch.setattr(TD, "backtrack", overflow(TD.backtrack))
    got = TD.find_commands_dp(t(ref["arr"]), t(ref["sizes"]), MAX_CMDS,
                              iters=2, B=B, W=W, R=R)
    for g, w in zip(got, ref["fcdp"]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, ref["greedy"]):
        np.testing.assert_array_equal(g[FORCED], w[FORCED])
    assert not np.array_equal(got[3], ref["greedy"][3])


@pytest.mark.parametrize("pad", [2.0, 4.0])
def test_unseen_cost_every_total(pad):
    """round(2 * min(15, log2(total) + pad)) in float32 for every total in
    [1, 2^18): a log2 one ulp off would flip a half-bit."""
    total = np.arange(1, 1 << 18, dtype=np.int32)
    tot = jnp.asarray(total).astype(jnp.float32)
    want = np.asarray(jnp.round(2.0 * jnp.minimum(15.0, jnp.log2(tot) + pad)))
    got = torch.round(2.0 * TD.unseen_bits(torch.from_numpy(total), pad))
    np.testing.assert_array_equal(got.numpy(), want)


def test_insert_code_table_is_the_insert_code():
    """dp_parse_plain's table form of the insert code (a bucketize over
    INS_BASE) equals ins_code_vec over the whole clipped range."""
    v = torch.arange(0, (1 << 22) + 1)
    table = torch.bucketize(v, torch.tensor(TD.INS_BASE[1:]), right=True)
    assert torch.equal(table, TP.ins_code_vec(v))


def test_static_tables_match_the_jax_module():
    assert TD.CPY_BASE == JD.CPY_BASE
    assert (TD.COST_BITS, TD.LEN_BITS, TD.INF_Q) == \
        (JD.COST_BITS, JD.LEN_BITS, JD.INF_Q)
    np.testing.assert_array_equal(TD._CPY_EXTRA_Q, JD._CPY_EXTRA_Q)
    np.testing.assert_array_equal(
        TD._CPY_EXTRA_Q, 2 * TA.copy_extra(torch.arange(24)).numpy())
    np.testing.assert_array_equal(
        TA.insert_base(torch.arange(24)).numpy(), TD.INS_BASE)
    assert [TD._copy_code_static(x) for x in range(1100)] == \
        [JD._copy_code_static(x) for x in range(1100)]
    np.testing.assert_array_equal(
        TA.insert_extra(torch.arange(24)).numpy(),
        np.asarray(JA.insert_extra(jnp.arange(24))))


@pytest.mark.parametrize("b,w,r,s", [(64, 256, 6, S), (32, 1024, 6, S),
                                     (32, 240, 6, S), (48, 480, 6, 2000),
                                     (32, 256, -1, S)])
def test_dp_parse_refuses_bad_shapes(b, w, r, s):
    """The JAX module's asserts, raised as ValueError before any work."""
    z = torch.zeros((2, s), dtype=torch.int32)
    zk = torch.zeros((2, s, 12), dtype=torch.int32)
    zj = torch.zeros((2, 576), dtype=torch.int32)
    with pytest.raises(ValueError, match="dp_parse needs"):
        TD.dp_parse(z, zk, zk, zj, zj, b, w, r)
