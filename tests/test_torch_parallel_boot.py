"""Port parity for limb_align (models/ckks_boot.py leveled_boot_keys) and the
placement of a bootstrap key set on a limb mesh (parallel/mesh.py), on gloo
ranks on the CPU.

The configuration is tests/test_boot_sharded.py's: N=256, sixteen 29-bit Q
primes, scale 2^28, Method II with alpha 2 and four special primes, a secret
of Hamming weight 16 and BootConfig(taylor_degree=3, exp_squarings=1,
ctos_pieces=2, stoc_pieces=2), keys from Threefry keys 61 and 63 and
limb_align=4.  The port's Galois and relinearization keys must equal the JAX
package's bit for bit, every key's limb extent must divide 4, and placed by
shard_pytree_limb_axis on a 4-way limb mesh (one start of four gloo ranks,
tests/torch_parallel_ranks.py) every key must split 4 ways, rank r's shard
equal to the JAX shard on device r, and a rank must hold under 0.45 of the
set's bytes.  The reference's key generation runs compiled as one program
(test_torch_boot.keys_compiled): its keys are exact integers, the eager
run's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import ckks_boot as jboot  # noqa: E402
from heongpu_tpu.parallel import mesh as jmesh  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot as tboot  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402
from test_torch_boot import keys_compiled  # noqa: E402

torch.set_num_threads(2)

CTX_ARGS = (256, [29] * 16)
CTX_KW = dict(scale_bits=28, sec_level="none", ks_type="II", alpha=2, p_count=4)
CFG = dict(taylor_degree=3, exp_squarings=1, ctos_pieces=2, stoc_pieces=2)
ALIGN = 4

pytestmark = pytest.mark.skipif(len(jax.devices()) < ALIGN, reason="needs 4 CPU devices")


@pytest.fixture(scope="module")
def jax_keys():
    ctx = jckks.make_context(*CTX_ARGS, **CTX_KW)
    sk = jckks.keygen_secret(ctx, jrng.new_key(61), hamming_weight=16)
    keys = keys_compiled(jboot.generate_bootstrap_keys, ctx, jrng.new_key(63), sk,
                         jboot.BootConfig(**CFG), limb_align=ALIGN)
    return ctx, keys


@pytest.fixture(scope="module")
def port_keys():
    ctx = tckks.make_context(*CTX_ARGS, device="cpu", **CTX_KW)
    sk = tckks.keygen_secret(ctx, trng.new_key(61, device="cpu"), hamming_weight=16)
    keys = tboot.generate_bootstrap_keys(ctx, trng.new_key(63, device="cpu"), sk,
                                         tboot.BootConfig(**CFG), limb_align=ALIGN)
    return ctx, keys


@pytest.fixture(scope="module")
def run(port_keys, tmp_path_factory):
    return ranks.spawn("boot_keys", ALIGN, tmp_path_factory.mktemp("par_boot"),
                       {"keys": port_keys[1]})


def test_aligned_galois_keys_match_jax(jax_keys, port_keys):
    (_, jk), (_, tk) = jax_keys, port_keys
    assert set(tk.gk.keys) == set(jk.gk.keys)
    for elt, kk in tk.gk.keys.items():
        np.testing.assert_array_equal(interop.to_numpy(kk.k0), np.asarray(jk.gk.keys[elt].k0))
        np.testing.assert_array_equal(interop.to_numpy(kk.k1), np.asarray(jk.gk.keys[elt].k1))


def test_aligned_relin_key_matches_jax(jax_keys, port_keys):
    (_, jk), (_, tk) = jax_keys, port_keys
    for name in ("k0", "k1"):
        np.testing.assert_array_equal(interop.to_numpy(getattr(tk.rk, name)),
                                      np.asarray(getattr(jk.rk, name)))


def test_every_key_extent_divides_the_mesh(port_keys):
    """Every Galois and relin key's limb extent divides 4, and the alignment
    moved keys: some piece runs at a level whose extent 4 does not divide."""
    ctx, tk = port_keys
    for elt, kk in tk.gk.keys.items():
        assert kk.k0.shape[1] % ALIGN == 0, (elt, kk.k0.shape)
    assert tk.rk.k0.shape[1] % ALIGN == 0
    levels = {pc.level for pc in tk.ctos_pieces + tk.stoc_pieces}
    assert [lv for lv in levels if (ctx.active(lv) + len(ctx.p_primes)) % ALIGN]


def test_galois_keys_placed_four_ways_as_jax(jax_keys, port_keys, run):
    """Each Galois key splits 4 ways; rank r's shard of k0 equals the JAX
    shard on device r (shard_pytree_limb_axis on a 4-device mesh), its shard of
    k1 the same slice of the port's key."""
    (_, jk), (_, tk) = jax_keys, port_keys
    m = jmesh.make_mesh(ALIGN, limb_shards=ALIGN)
    jsh = jmesh.shard_pytree_limb_axis(jk, m)
    devs = jax.devices()
    for elt, kk in tk.gk.keys.items():
        q = kk.k0.shape[1] // ALIGN
        want = {devs.index(s.device): np.asarray(s.data)
                for s in jsh.gk.keys[elt].k0.addressable_shards}
        for r in range(ALIGN):
            got = run[r]["gk"][elt][0]
            assert got.shape[1] == q, (elt, kk.k0.shape, got.shape)
            np.testing.assert_array_equal(interop.to_numpy(got), want[r])
            torch.testing.assert_close(run[r]["gk"][elt][1], kk.k1[:, r * q:(r + 1) * q],
                                       rtol=0, atol=0)
    assert len(tk.gk.keys) >= 3


def test_relin_key_placed_four_ways(port_keys, run):
    _, tk = port_keys
    q = tk.rk.k0.shape[1] // ALIGN
    for r in range(ALIGN):
        for i, half in enumerate((tk.rk.k0, tk.rk.k1)):
            torch.testing.assert_close(run[r]["rk"][i], half[:, r * q:(r + 1) * q],
                                       rtol=0, atol=0)


def test_a_rank_holds_under_045_of_the_set(run):
    """Per-rank bytes of the whole placed set (keys, diagonals, tables: every
    tensor a DTensor) are under 0.45 of the set's."""
    for r in range(ALIGN):
        assert run[r]["all_dtensors"]
        assert run[r]["local_bytes"] < 0.45 * run[r]["total_bytes"], run[r]
