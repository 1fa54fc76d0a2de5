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
run's.

In the same start the ranks run the limb-sharded bootstrap
(parallel/boot_sharded.py) on those keys, every one split 4 ways (the
counterpart of tests/test_boot_sharded.py's sharded coeff_to_slot and
regular_bootstrap), on a set of the same configuration in inv_form, and on
a base_count 2 configuration (arcsin_order 1, piece_depth 2, Taylor degree
3, one squaring, limb_align=4: [29, 29] + [28]*22, the shortest such chain
that builds), and on a compressed set of the first configuration
(compress_keys=True: every Galois and relin key stripped to k0 and its
a_seed, each rank regenerating its own block of the uniform halves), each
on uniform residues at the last base_count limbs: each rank's shard of
mod_raise, coeff_to_slot and regular_bootstrap must equal the same rows of
the port's unsharded CPU path on the same keys, and no rank may receive a
row of a key (a stripped key's regenerated k1 included).  On the first set
the ranks also run negate, a rotation that only the power-of-two chain
reaches and switch_key; a stripped Galois key with no seed raises."""

from concurrent.futures import ThreadPoolExecutor

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
from heongpu_tpu_torch.ops import polyops as tpoly  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402
from test_torch_boot import keys_compiled  # noqa: E402

torch.set_num_threads(2)

CTX_ARGS = (256, [29] * 16)
CTX_KW = dict(scale_bits=28, sec_level="none", ks_type="II", alpha=2, p_count=4)
CFG = dict(taylor_degree=3, exp_squarings=1, ctos_pieces=2, stoc_pieces=2)
ALIGN = 4
BC2_ARGS = (256, [29, 29] + [28] * 22)
BC2_CFG = dict(CFG, base_count=2, arcsin_order=1, piece_depth=2)
STEPS = ("raised", "t0", "t1", "out")
CASES = ("aligned", "inv_form", "base_count2", "compressed")

pytestmark = pytest.mark.skipif(len(jax.devices()) < ALIGN, reason="needs 4 CPU devices")


@pytest.fixture(scope="module")
def port_keys():
    ctx = tckks.make_context(*CTX_ARGS, device="cpu", **CTX_KW)
    sk = tckks.keygen_secret(ctx, trng.new_key(61, device="cpu"), hamming_weight=16)
    keys = tboot.generate_bootstrap_keys(ctx, trng.new_key(63, device="cpu"), sk,
                                         tboot.BootConfig(**CFG), limb_align=ALIGN)
    return ctx, keys


@pytest.fixture(scope="module")
def boot_cases(port_keys):
    """The sharded bootstrap's cases: (context arguments, context, keys, input
    residues, extras) by name; the aligned case's extras are a switching key
    and a rotation step that only the power-of-two chain of level-0 keys
    reaches."""
    ctx, keys = port_keys
    g = trng.new_generator(19, "cpu")
    inv = tboot.generate_bootstrap_keys(ctx, g, tckks.keygen_secret(ctx, g, hamming_weight=16),
                                        tboot.BootConfig(**CFG), limb_align=ALIGN,
                                        inv_form=True)
    ctx2 = tckks.make_context(*BC2_ARGS, device="cpu", **CTX_KW)
    sk2 = tckks.keygen_secret(ctx2, g, hamming_weight=16)
    keys2 = tboot.generate_bootstrap_keys(ctx2, g, sk2, tboot.BootConfig(**BC2_CFG),
                                          limb_align=ALIGN)
    compressed = tboot.generate_bootstrap_keys(
        ctx, g, tckks.keygen_secret(ctx, g, hamming_weight=16), tboot.BootConfig(**CFG),
        limb_align=ALIGN, compress_keys=True)
    assert compressed.rk.k1 is None and all(kk.k1 is None for kk in compressed.gk.keys.values())
    swk = tckks.keygen_switch(ctx, g, tckks.keygen_secret(ctx, g), tckks.keygen_secret(ctx, g))
    rows = ctx.k + len(ctx.p_primes)
    pow2 = [s for s in (1 << j for j in range(7))
            if keys.gk.keys.get(tpoly.steps_to_galois_elt(s, ctx.n)) is not None
            and keys.gk.keys[tpoly.steps_to_galois_elt(s, ctx.n)].k0.shape[1] == rows]
    assert len(pow2) >= 2, pow2
    r = np.random.default_rng(19)
    out = {}
    for name, args, (cx, kk), extra in (
            ("aligned", CTX_ARGS, port_keys, {"swk": swk, "step": pow2[0] + pow2[1]}),
            ("inv_form", CTX_ARGS, (ctx, inv), {}),
            ("base_count2", BC2_ARGS, (ctx2, keys2), {}),
            ("compressed", CTX_ARGS, (ctx, compressed), {})):
        bc = kk.cfg.base_count
        c = np.stack([r.integers(0, int(q), (2, cx.n)) for q in cx.q_primes[:bc]], axis=1)
        out[name] = (args, cx, kk, torch.from_numpy(c.astype(np.int64)).to(torch.int32), extra)
    return out


@pytest.fixture(scope="module")
def ranks_running(port_keys, boot_cases, tmp_path_factory):
    """The gloo ranks, started before the JAX side compiles, as a future of
    their results."""
    cases = [{"name": name, "ctx_args": args, "ctx_kw": CTX_KW, "keys": keys, "c": c,
              "blocks": False, **extra} for name, (args, _, keys, c, extra) in boot_cases.items()]
    pool = ThreadPoolExecutor(1)
    yield pool.submit(ranks.spawn, "boot_keys_sharded", ALIGN,
                      tmp_path_factory.mktemp("par_boot"), {"keys": port_keys[1], "cases": cases})
    pool.shutdown()


@pytest.fixture(scope="module")
def jax_keys(ranks_running):
    ctx = jckks.make_context(*CTX_ARGS, **CTX_KW)
    sk = jckks.keygen_secret(ctx, jrng.new_key(61), hamming_weight=16)
    keys = keys_compiled(jboot.generate_bootstrap_keys, ctx, jrng.new_key(63), sk,
                         jboot.BootConfig(**CFG), limb_align=ALIGN)
    return ctx, keys


@pytest.fixture(scope="module")
def run(ranks_running):
    return ranks_running.result()


@pytest.fixture(scope="module")
def unsharded(boot_cases):
    """The port's unsharded CPU path on each case: mod_raise, coeff_to_slot
    and regular_bootstrap."""
    out = {}
    for name, (_, ctx, keys, c, extra) in boot_cases.items():
        ct = tckks.Ciphertext(c, 2, ctx.k - keys.cfg.base_count, keys.msg_scale)
        res = {"raised": tboot.mod_raise(ctx, ct, keys.cfg.base_count)}
        res["t0"], res["t1"] = tboot.coeff_to_slot(ctx, res["raised"], keys)
        res["out"] = tboot.regular_bootstrap(ctx, ct, keys)
        if extra:
            res["negate"] = tckks.negate(ctx, res["raised"])
            res["rotate"] = tckks.rotate(ctx, res["raised"], keys.gk, extra["step"])
            res["switch_key"] = tckks.switch_key(ctx, res["raised"], extra["swk"])
        out[name] = res
    return out


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


@pytest.mark.parametrize("case, step", [(c, s) for c in CASES for s in STEPS]
                         + [("aligned", s) for s in ("negate", "rotate", "switch_key")])
def test_sharded_bootstrap_matches_unsharded(unsharded, run, case, step):
    """Each rank's shard of the sharded mod_raise, coeff_to_slot (t0, t1) and
    regular_bootstrap (and, on the aligned keys, of negate, a rotation composed
    from the power-of-two keys and switch_key) equals the same rows of the
    unsharded CPU path, placed by shard_array_limb_axis's rule (sharded where
    4 divides the limbs)."""
    want = unsharded[case][step]
    for r in range(ALIGN):
        local, placements, level, scale = run[r]["sharded"][case]["steps"][step]
        rows = want.c.shape[-2]
        assert placements[1].is_shard() == (rows % ALIGN == 0), (rows, placements)
        m = rows // ALIGN if placements[1].is_shard() else rows
        lo = r * m if placements[1].is_shard() else 0
        torch.testing.assert_close(local, want.c[:, lo:lo + m], rtol=0, atol=0)
        assert (level, scale) == (want.level, want.scale)


@pytest.mark.parametrize("case", CASES)
def test_sharded_bootstrap_keeps_keys_split(run, case):
    """Every Galois key is split 4 ways on every rank, the ranks exchanged
    rows, and none of them was a key's; the misuses (a plain-tensor
    ciphertext, stripped Galois keys with no seed) raise."""
    for r in range(ALIGN):
        got = run[r]["sharded"][case]
        for e, (shape, rows) in got["key_local"].items():
            assert shape[1] * ALIGN == rows, (e, shape, rows)
        assert got["received_rows"] > 0 and got["received_key_rows"] == 0, got
        assert set(got["misuse"]) == {"plain_tensor", "stripped"}, got["misuse"]
