"""Port parity for the digit-sharded Method-II keyswitch
(heongpu_tpu_torch/parallel/keyswitch_sharded.py) on gloo ranks on the CPU.

The shape is tests/test_parallel.py's: N=512, 16 Q limbs ([29] + [25]*15),
alpha 4 (4 digits), four special primes, a relinearization key and a random
coefficient-domain poly from the JAX package.  One start of four gloo ranks
(tests/torch_parallel_ranks.py) runs the port's keyswitch2_sharded at k = 1,
2 and 4 ranks (each rank its Q limbs and its digits' key slices, one
butterfly all-reduce with modular adds, the per-limb tail on its own limbs),
and once more at k = 4 through DTensors placed by the mesh layer.  Every rank's
limb slice must equal, bit for bit, the JAX package's single-device
keyswitch2 (one compile) at every k, and the JAX package's
keyswitch2_sharded on its 4-device CPU mesh at k = 4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.ops import keyswitch2 as jks2  # noqa: E402
from heongpu_tpu.parallel import keyswitch_sharded as jkss  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.parallel import keyswitch_sharded as tkss  # noqa: E402

torch.set_num_threads(2)

CTX_ARGS = (512, [29] + [25] * 15)
CTX_KW = dict(sec_level="none", ks_type="II", alpha=4, p_count=4)
KS = (1, 2, 4)
WORLD = 4

pytestmark = pytest.mark.skipif(len(jax.devices()) < WORLD, reason="needs 4 CPU devices")


@pytest.fixture(scope="module")
def ref():
    """The JAX side: the context, a relinearization key, a random poly and its
    single-device keyswitch2 (jitted once)."""
    ctx = jckks.make_context(*CTX_ARGS, **CTX_KW)
    sk = jckks.keygen_secret(ctx, jrng.new_key(1))
    rk = jckks.keygen_relin(ctx, jrng.new_key(2), sk)
    R = np.random.default_rng(0)
    poly = np.stack([R.integers(0, p, ctx.n).astype(np.uint32) for p in ctx.q_primes])
    ks2 = ctx.ks2[0]
    f = jax.jit(lambda a, b, c: jks2.keyswitch2(a, b, c, ks2, ctx.ntt_qp_at(0),
                                                ctx.base_qp_at(0), in_ntt=False, out_ntt=True,
                                                ntt_q_level=ctx.ntt_q(0)))
    d0, d1 = f(jnp.asarray(poly), rk.k0, rk.k1)
    return ctx, rk, poly, np.asarray(d0), np.asarray(d1)


@pytest.fixture(scope="module")
def run(ref, tmp_path_factory):
    _, rk, poly, _, _ = ref
    t = lambda a: interop._t(np.asarray(a), "cpu")
    inp = {"ctx_args": CTX_ARGS, "ctx_kw": CTX_KW, "ks": KS, "poly": t(poly),
           "k0": t(rk.k0), "k1": t(rk.k1)}
    return ranks.spawn("keyswitch", WORLD, tmp_path_factory.mktemp("par_ks"), inp)


def test_stacked_convs_match_jax(ref):
    ctx, *_ = ref
    tctx = tckks.make_context(*CTX_ARGS, device="cpu", **CTX_KW)
    got, want = tkss.stack_convs(tctx.ks2[0]), jkss.stack_convs(ctx.ks2[0])
    assert (got.alpha, got.d, got.ka) == (want.alpha, want.d, want.ka) == (4, 4, 16)
    for name in ("qhat_inv", "qhat_inv_sh", "mat_mont", "gp"):
        np.testing.assert_array_equal(interop.to_numpy(getattr(got, name)),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("k", KS)
def test_sharded_keyswitch_matches_single_device(ref, run, k):
    _, _, _, d0, d1 = ref
    m = d0.shape[0] // k
    for r in range(k):
        s0, s1 = run[r][k]
        np.testing.assert_array_equal(interop.to_numpy(s0), d0[r * m:(r + 1) * m])
        np.testing.assert_array_equal(interop.to_numpy(s1), d1[r * m:(r + 1) * m])
    for r in range(k, WORLD):
        assert k not in run[r]


def test_sharded_keyswitch_matches_jax_shard_map(ref, run):
    """k = 4: each rank's slice equals the JAX package's keyswitch2_sharded's
    shard on the device of the same position, through local tensors and
    through DTensors."""
    ctx, rk, poly, d0, d1 = ref
    ks2 = ctx.ks2[0]
    sc = jkss.stack_convs(ks2)
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(1, WORLD), ("dp", "limb"))
    pq = jax.device_put(jnp.asarray(poly), NamedSharding(mesh, P("limb", None)))
    k0 = jax.device_put(rk.k0, NamedSharding(mesh, P("limb", None, None)))
    k1 = jax.device_put(rk.k1, NamedSharding(mesh, P("limb", None, None)))
    with mesh:
        s0, s1 = jax.jit(lambda a, b, c: jkss.keyswitch2_sharded(
            mesh, a, b, c, ks2, sc, ctx.ntt_qp_at(0), ctx.base_qp_at(0), ctx.ntt_q(0)))(
                pq, k0, k1)
    devs = jax.devices()
    for got_i, want in ((0, s0), (1, s1)):
        for sh in want.addressable_shards:
            r = devs.index(sh.device)
            np.testing.assert_array_equal(interop.to_numpy(run[r][WORLD][got_i]),
                                          np.asarray(sh.data))
            np.testing.assert_array_equal(interop.to_numpy(run[r]["dtensor"][got_i]),
                                          np.asarray(sh.data))
    for r in range(WORLD):
        np.testing.assert_array_equal(interop.to_numpy(run[r]["dtensor"][2]), d0)
        np.testing.assert_array_equal(interop.to_numpy(run[r]["dtensor"][3]), d1)
