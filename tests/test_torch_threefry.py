"""The port's Threefry-2x32 against jax.random and the reference's sampling
facade on the CPU, bit for bit.

Under JAX's defaults (jax_threefry_partitionable, x64 off): PRNGKey at seeds
0, 81, 2^31+5, 2^34+7, 2^43+5 and -3 (the seed kept mod 2^32), split into 2,
3 and 5 keys, bits of shapes up to (3, 4, 256), each by the numpy host
version and by the plain int64 torch version; the facade's new_key, split,
bits32 and uniform_rns against the reference's rng; the moved, Montgomery
draw of a seeded key's uniform half against the reference's
ringkit._regen_a; its row ranges (a rank's block of a limb-sharded key)
against the same rows of the whole draw and of the reference's half; and
the six draws that once raised on a Threefry key (normal, randint,
permutation, fold_in, gaussian_rns, ternary_rns) against jax.random and the
reference's facade."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import ringkit as jring  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ringkit as tring  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402
from heongpu_tpu_torch.utils import threefry as ttf  # noqa: E402

torch.set_num_threads(2)

SEEDS = [0, 81, 2 ** 31 + 5, 2 ** 34 + 7, 2 ** 43 + 5, -3]
SHAPES = [(5,), (2, 7), (3, 4, 256)]
PRIMES = (536608769, 536215553, 1073479681)


def _u32(t):
    return t.numpy().astype(np.uint32) if t.dtype == torch.int64 else t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_bits_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    key = ttf.key_from_seed(seed)
    assert key == tuple(int(w) for w in np.asarray(k))
    for num in (2, 3, 5):
        want = np.asarray(jax.random.split(k, num))
        np.testing.assert_array_equal(np.array(ttf.split_np(key, num), np.uint32), want)
        np.testing.assert_array_equal(_u32(ttf.split_torch(key, num, "cpu")), want)
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(k, shape, jnp.uint32))
        np.testing.assert_array_equal(ttf.bits32_np(key, shape), want)
        np.testing.assert_array_equal(_u32(ttf.bits32(key, shape, "cpu")), want)


def test_seed_truncation_is_the_reference_hazard():
    """PRNGKey keeps the seed mod 2^32: seeds 2^43 apart draw the same bits."""
    assert ttf.key_from_seed(5) == ttf.key_from_seed(2 ** 34 + 5) == ttf.key_from_seed(2 ** 43 + 5)
    assert ttf.key_from_seed(-3) == (0, 4294967293)
    np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(2 ** 43 + 5)),
                                  np.asarray(jax.random.PRNGKey(5)))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_facade_matches_the_reference_rng(seed):
    jk, tk = jrng.new_key(seed), trng.new_key(seed, "cpu")
    assert tk.words == tuple(int(w) for w in np.asarray(jk)) and tk.device.type == "cpu"
    for a, b in zip(trng.split(tk, 3), np.asarray(jrng.split(jk, 3))):
        assert a.words == tuple(int(w) for w in b)
    np.testing.assert_array_equal(_u32(trng.bits32(tk, (4, 9), "cpu")),
                                  np.asarray(jrng.bits32(jk, (4, 9))))
    for shape in ((256,), (3, 64), (2, 4, 32)):
        np.testing.assert_array_equal(_u32(trng.uniform_rns(tk, PRIMES, shape, "cpu")),
                                      np.asarray(jrng.uniform_rns(jk, PRIMES, shape)))


def test_regenerated_half_matches_the_reference():
    """The moved, Montgomery-form draw of a seeded key's uniform half (one
    digit row and three) equals the reference's ringkit._regen_a."""
    jc = jckks.make_context(64, [29] * 3)
    tc = tckks.make_context(64, [29] * 3, device="cpu")
    for seed, d in ((7, None), (2 ** 34 + 9, 3)):
        want = np.asarray(jring._regen_a(jckks._ring(jc), seed, d))
        got = tring._seeded_a(tckks._ring(tc), seed, d, mont=True)
        np.testing.assert_array_equal(_u32(got), want)
        shape = (64,) if d is None else (d, 64)
        flat = ttf.uniform_rns_plain(ttf.key_from_seed(seed), tc.qp_primes, shape, "cpu")
        assert tuple(got.shape) == ((4, 64) if d is None else (3, 4, 64))
        if d is not None:
            assert not torch.equal(got.reshape(-1), flat.reshape(-1))


# (limbs, row ranges): each block of a 4-way split of 12 limbs (no remainder),
# an odd block, the last limb alone, and the whole draw
ROW_RANGES = [(12, [(0, 3), (3, 3), (6, 3), (9, 3)]), (54, [(13, 28), (53, 1), (0, 54)])]


@pytest.mark.parametrize("L,ranges", ROW_RANGES, ids=["split4_of_12", "odd_of_54"])
@pytest.mark.parametrize("shape", [(64,), (3, 64)], ids=["row", "digits"])
def test_row_range_equals_rows_of_the_whole_draw(L, ranges, shape):
    """uniform_rns_plain with rows=(first, count) hashes only those limbs'
    counters and gives the same rows as the whole draw, in both layouts and
    forms, at a seed the reference's compressed layout would use."""
    primes = tuple(PRIMES[i % 3] for i in range(L))
    key = ttf.key_from_seed(2 ** 34 + 13)
    for moved in ((False, True) if len(shape) == 2 else (False,)):
        for mont in (False, True):
            whole = ttf.uniform_rns_plain(key, primes, shape, "cpu", moved, mont)
            for lb, lc in ranges:
                got = ttf.uniform_rns(key, primes, shape, "cpu", moved, mont, rows=(lb, lc))
                want = whole[:, lb:lb + lc] if moved else whole[lb:lb + lc]
                torch.testing.assert_close(got, want, rtol=0, atol=0)
    for bad in ((-1, 2), (0, 0), (L - 1, 2)):
        with pytest.raises(ValueError, match="outside"):
            ttf.uniform_rns_plain(key, primes, shape, "cpu", rows=bad)


def test_row_range_of_a_key_matches_the_reference_rows():
    """ringkit.ensure_k1 with a row range regenerates the rows of a stripped
    key's half that the reference's ringkit._regen_a gives for the same seed."""
    jc = jckks.make_context(64, [29] * 7, ks_type="II", alpha=2, p_count=2)
    tc = tckks.make_context(64, [29] * 7, device="cpu", ks_type="II", alpha=2, p_count=2)
    seed, d = 2 ** 43 + 11, 4
    want = np.asarray(jring._regen_a(jckks._ring(jc), seed, d))
    kk = tring.KSKey(torch.zeros((d, 9, 64), dtype=torch.int32), None, seed)
    for lb, lc in ((0, 3), (3, 3), (6, 3), (2, 5)):
        got = tring.ensure_k1(tckks._ring(tc), kk, rows=(lb, lc))
        np.testing.assert_array_equal(_u32(got), want[:, lb:lb + lc])


def test_draws_not_ported_on_a_threefry_key_raise():
    """The six draws that raised on a Threefry key before jax.random's
    transforms were ported now give jax.random's numbers: normal within
    float32 rounding (1e-6), the rest bit for bit; a device with no Threefry
    route still raises."""
    tk, jk = trng.new_key(1, "cpu"), jrng.new_key(1)
    np.testing.assert_allclose(trng.normal(tk, (4,), "cpu").numpy(),
                               np.asarray(jax.random.normal(jk, (4,))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(trng.randint(tk, (4,), 0, 3, "cpu").numpy(),
                                  np.asarray(jax.random.randint(jk, (4,), 0, 3)))
    np.testing.assert_array_equal(trng.permutation(tk, 8, "cpu").numpy(),
                                  np.asarray(jax.random.permutation(jk, 8)))
    assert trng.fold_in(tk, 2).words == tuple(int(w) for w in np.asarray(jax.random.fold_in(jk, 2)))
    np.testing.assert_array_equal(_u32(trng.gaussian_rns(tk, PRIMES, (4,), "cpu")),
                                  np.asarray(jrng.gaussian_rns(jk, PRIMES, (4,))))
    np.testing.assert_array_equal(_u32(trng.ternary_rns(tk, PRIMES, (4,), "cpu")),
                                  np.asarray(jrng.ternary_rns(jk, PRIMES, (4,))))
    with pytest.raises(ValueError):
        trng.uniform_rns(tk, PRIMES, (4,), "meta")
    with pytest.raises(ValueError):
        trng.randint(trng.new_key(1, "meta"), (4,), 0, 3, "meta")
