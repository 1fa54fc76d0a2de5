"""Port parity for the mesh layer and the coefficient-sharded NTT
(heongpu_tpu_torch/parallel/{mesh,ntt_sharded,multihost}.py), on gloo ranks
on the CPU, and K1's split passes (hf_ntt_pass, kernels/csrc/ntt.cu) compiled
for the host.

One start of eight gloo ranks (tests/torch_parallel_ranks.py) runs every
rank-side case; the JAX side runs on the 8-device CPU mesh of
tests/conftest.py.  Every comparison is exact:
  * shard_array_limb_axis, ct_sharding and shard_pytree_limb_axis on a
    (2, 4) ('dp', 'limb') mesh: rank r's local shard equals the JAX array's
    shard on device r, for a limb count that divides the mesh and one that
    does not;
  * the sharded NTT at D = 2, 4, 8 and N = 2^10 (three limbs, a lead dim of
    two): each rank's forward block equals the JAX package's single-device
    transform's columns of that rank, and at D = 8 the JAX shard_map
    transform's shard on the same device; the inverse returns the input;
  * allreduce_shares on a party mesh of eight ranks, shares whose sum passes
    2^32 several times, equals the JAX package's uint32 psum;
  * a two-process run (the counterpart of tests/test_multihost.py's): the
    global mesh spans both processes and the share sums are right.
The split passes' source on the host (the g++ harness of
tests/test_torch_ntt_host_kernel.py) equals the plain passes and, through an
in-process exchange, ntt_fwd_plain / ntt_inv_plain, at D = 1, 2, 4, 8 at the
smallest N the entry takes for each D; it rejects the (N, D) it does not
take."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from heongpu_tpu.ops import ntt as jntt  # noqa: E402
from heongpu_tpu.parallel import mesh as jmesh  # noqa: E402
from heongpu_tpu.parallel import multihost as jmh  # noqa: E402
from heongpu_tpu.parallel import ntt_sharded as jns  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.utils import nt as tnt  # noqa: E402
from test_torch_ntt_host_kernel import host_lib  # noqa: E402,F401

torch.set_num_threads(2)

N, L, LEAD = 1 << 10, 3, 2
DS = (2, 4, 8)
WORLD = 8

pytestmark = pytest.mark.skipif(len(jax.devices()) < WORLD, reason="needs 8 CPU devices")


def _residues(rng, primes, shape):
    p = np.array(primes, np.uint64).reshape((-1,) + (1,) * (len(shape) - 1))
    return (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % p).astype(np.uint32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, and every rank's results of one start of eight gloo ranks."""
    rng = np.random.default_rng(17)
    primes = tnt.generate_ntt_primes(29, L, N)
    x = np.stack([_residues(rng, primes, (L, N)) for _ in range(LEAD)])
    arrays = {"limbs8": rng.integers(0, 1 << 29, (2, 8, 64), dtype=np.uint32),
              "limbs3": rng.integers(0, 1 << 29, (2, 3, 64), dtype=np.uint32)}
    ct = rng.integers(0, 1 << 29, (2, 8, 64), dtype=np.uint32)
    shares = (0xFFFFFFFF - rng.integers(0, 1 << 20, (WORLD, 16), dtype=np.uint64)).astype(
        np.uint32)
    inp = {"primes": primes, "x": interop._t(x, "cpu"), "ds": DS,
           "arrays": {k: interop._t(v, "cpu") for k, v in arrays.items()},
           "ct": interop._t(ct, "cpu"), "shares": interop._t(shares, "cpu")}
    out = ranks.spawn("ntt_mesh", WORLD, tmp_path_factory.mktemp("par_ntt"), inp)
    return dict(primes=primes, x=x, arrays=arrays, ct=ct, shares=shares), out


def _jax_shards(a):
    """{device index: numpy shard} of a JAX array."""
    devs = jax.devices()
    return {devs.index(s.device): np.asarray(s.data) for s in a.addressable_shards}


def test_shard_array_limb_axis_matches_jax(run):
    inp, out = run
    m = jmesh.make_mesh(WORLD, limb_shards=4)
    for name, a in inp["arrays"].items():
        want = _jax_shards(jmesh.shard_array_limb_axis(jnp.asarray(a), m))
        for r in range(WORLD):
            np.testing.assert_array_equal(interop.to_numpy(out[r][("limb", name)]), want[r])
        split = a.shape[1] % 4 == 0
        assert out[0][("limb", name)].shape[1] == (a.shape[1] // 4 if split else a.shape[1])


def test_ct_sharding_and_pytree_match_jax(run):
    inp, out = run
    m = jmesh.make_mesh(WORLD, limb_shards=4)
    want = _jax_shards(jax.device_put(jnp.asarray(inp["ct"]), jmesh.ct_sharding(m)))
    for r in range(WORLD):
        np.testing.assert_array_equal(interop.to_numpy(out[r]["ct_sharding"]), want[r])
        np.testing.assert_array_equal(interop.to_numpy(out[r]["ct_pytree"]), want[r])
        assert out[r]["global_mesh"] == [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.fixture(scope="module")
def jax_ntt(run):
    """The JAX package's single-device forward transform, (LEAD, L, N2, N1)."""
    inp, _ = run
    tb = jntt.build_ntt_tables(inp["primes"], N, use_mxu=False)
    y = np.asarray(jax.jit(lambda a: jntt.ntt_fwd(a, tb))(jnp.asarray(inp["x"])))
    return tb, y.reshape(LEAD, L, tb.n2, tb.n1)


@pytest.mark.parametrize("d", DS)
def test_sharded_ntt_matches_jax(run, jax_ntt, d):
    inp, out = run
    tb, y = jax_ntt
    c, w = tb.n1 // d, tb.n2 // d
    x4 = inp["x"].reshape(LEAD, L, tb.n1, tb.n2)
    for r in range(d):
        np.testing.assert_array_equal(interop.to_numpy(out[r][("fwd", d)]),
                                      y[..., r * c:(r + 1) * c])
        np.testing.assert_array_equal(interop.to_numpy(out[r][("inv", d)]),
                                      x4[..., r * w:(r + 1) * w])
    for r in range(d, WORLD):
        assert ("fwd", d) not in out[r]


def test_sharded_ntt_matches_jax_shard_map(run, jax_ntt):
    """D = 8: each rank's block equals the JAX shard_map transform's shard on
    the device of the same position, given its block or the whole as a
    DTensor."""
    inp, out = run
    tb, _ = jax_ntt
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("coef",))
    fwd, inv = jns.make_sharded_ntt(mesh, tb, lead_dims=1)
    x4 = jax.device_put(jns.to_four_step(jnp.asarray(inp["x"]), tb),
                        NamedSharding(mesh, P(None, None, None, "coef")))
    y4 = fwd(x4)
    want = _jax_shards(y4)
    back = _jax_shards(inv(y4))
    whole = np.asarray(y4)
    for r in range(WORLD):
        np.testing.assert_array_equal(interop.to_numpy(out[r][("fwd", WORLD)]), want[r])
        np.testing.assert_array_equal(interop.to_numpy(out[r][("inv", WORLD)]), back[r])
        local, full, inverse = out[r]["dtensor"]      # full, inverse: interop.to_numpy
        np.testing.assert_array_equal(interop.to_numpy(local), want[r])
        np.testing.assert_array_equal(full, whole)
        np.testing.assert_array_equal(inverse, np.asarray(x4))


def test_allreduce_shares_wraps_as_jax(run):
    inp, out = run
    shares = inp["shares"]
    pm = jmh.party_mesh()
    g = jax.device_put(jnp.asarray(shares), NamedSharding(pm, P("party", None)))
    want = _jax_shards(jmh.allreduce_shares(g, pm))
    exact = shares.astype(np.uint64).sum(axis=0)
    assert exact.max() > 4 * (1 << 32)      # the sum wraps several times
    for r in range(WORLD):
        got = interop.to_numpy(out[r]["shares"])
        np.testing.assert_array_equal(got, want[r][0])
        np.testing.assert_array_equal(got, (exact % (1 << 32)).astype(np.uint32))


def test_two_process_init_and_party_mesh(tmp_path):
    """Two processes join one group through init_process; the global mesh
    spans both and a party mesh sums their shares (float and wrapping words)."""
    floats = np.arange(2 * 8, dtype=np.float32).reshape(2, 8)
    words = np.array([[0xFFFFFFFF] * 4, [3] * 4], np.uint32)
    out = ranks.spawn("two_process", 2, tmp_path,
                      {"float": torch.from_numpy(floats), "words": interop._t(words, "cpu")})
    for r, o in enumerate(out):
        assert (o["world"], o["rank"], o["global_mesh"]) == (2, r, [[0, 1]])
        np.testing.assert_array_equal(o["float"].numpy(), floats.sum(axis=0))
        np.testing.assert_array_equal(interop.to_numpy(o["words"]), np.full(4, 2, np.uint32))


# ---------------------------------------------------------------------------
# K1's split passes, compiled for the host
# ---------------------------------------------------------------------------

# the smallest N the entry takes for each D (a rank's block must be whole tiles)
SPLIT_CASES = [(1, 1 << 8), (2, 1 << 13), (4, 1 << 14), (8, 1 << 15)]


def run_pass(lib, x, tb, inverse, pass_, d, rank):
    """The host-compiled split entry on CPU tensors, with the C arguments
    ntt_pass_cuda passes.  Returns (error code, output)."""
    shp_in, shp_out = tntt.pass_shapes(tb, inverse, pass_, d)
    lead = x.shape[1:-3] if pass_ == 2 else x.shape[:-3]
    out = torch.empty((shp_out[:1] + lead + shp_out[1:]) if pass_ == 1 else (lead + shp_out),
                      dtype=tm.I32)
    pre = "itw" if inverse else "tw"
    tabs = [getattr(tb, pre + k) for k in ("_mat", "_mat_sh", "1p", "1p_sh", "2p", "2p_sh")]
    err = lib.host_ntt_pass(int(inverse), pass_, x.data_ptr(), out.data_ptr(),
                            x.numel() // (tb.n // d), tb.num_limbs, tb.n1, tb.n2, d, rank,
                            tb.p.data_ptr(), *(t.data_ptr() for t in tabs), None)
    return err, out


def _split_transform(lib, x, tb, inverse, d):
    """Both passes on every rank's block with the exchange done in process;
    each pass held against ntt_pass_plain.  x: (L, N) -> (L, N)."""
    a, b = (tb.n2, tb.n1) if inverse else (tb.n1, tb.n2)
    blocks = x.view(tb.num_limbs, a, b)
    step = b // d
    sends = []
    for r in range(d):
        blk = blocks[..., r * step:(r + 1) * step].contiguous()
        err, s = run_pass(lib, blk, tb, inverse, 1, d, r)
        assert err == 0
        torch.testing.assert_close(s, tntt.ntt_pass_plain(blk, tb, inverse, 1, d, r),
                                   rtol=0, atol=0)
        sends.append(s)
    outs = []
    for r in range(d):
        recv = torch.stack([sends[s][r] for s in range(d)])
        err, o = run_pass(lib, recv, tb, inverse, 2, d, r)
        assert err == 0
        torch.testing.assert_close(o, tntt.ntt_pass_plain(recv, tb, inverse, 2, d, r),
                                   rtol=0, atol=0)
        outs.append(o)
    return torch.cat(outs, dim=-1).reshape(x.shape)


@pytest.mark.parametrize("d,n", SPLIT_CASES, ids=[f"d{d}_n{n}" for d, n in SPLIT_CASES])
def test_split_pass_source_on_host_matches_plain(host_lib, d, n):  # noqa: F811
    tb = tntt.build_ntt_tables(tnt.generate_ntt_primes(29, 2, n), n, device="cpu")
    rng = np.random.default_rng(n + d)
    x = interop._t(_residues(rng, tb.primes, (2, n)), "cpu")
    f = _split_transform(host_lib, x, tb, False, d)
    torch.testing.assert_close(f, tntt.ntt_fwd_plain(x, tb), rtol=0, atol=0)
    i = _split_transform(host_lib, f, tb, True, d)
    torch.testing.assert_close(i, x, rtol=0, atol=0)


def test_split_pass_source_on_host_rejects_other_splits(host_lib):  # noqa: F811
    """Blocks that are not whole tiles, a D that is no power of two, a rank or
    a pass out of range: the entry returns cudaErrorInvalidValue."""
    for n, d, rank, pass_ in ((1 << 12, 2, 0, 1), (1 << 13, 4, 0, 1), (1 << 14, 8, 0, 2),
                              (1 << 15, 16, 0, 1), (1 << 16, 32, 0, 2), (1 << 16, 3, 0, 1),
                              (1 << 16, 4, 4, 1), (1 << 16, 4, 0, 3)):
        tb = tntt.build_ntt_tables(tnt.generate_ntt_primes(29, 1, n), n, device="cpu")
        x = torch.zeros(n, dtype=tm.I32)
        for inverse in (False, True):
            err = host_lib.host_ntt_pass(int(inverse), pass_, x.data_ptr(), x.data_ptr(), 1, 1,
                                         tb.n1, tb.n2, d, rank, tb.p.data_ptr(),
                                         *([tb.p.data_ptr()] * 6), None)
            assert err == tntt.CUDA_ERROR_INVALID_VALUE, (n, d, rank, pass_)
