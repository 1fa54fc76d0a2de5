"""The port's Threefry-2x32 against jax.random and the reference's sampling
facade on the CPU, bit for bit.

Under JAX's defaults (jax_threefry_partitionable, x64 off): PRNGKey at seeds
0, 81, 2^31+5, 2^34+7, 2^43+5 and -3 (the seed kept mod 2^32), split into 2,
3 and 5 keys, bits of shapes up to (3, 4, 256), each by the numpy host
version and by the plain int64 torch version; the facade's new_key, split,
bits32 and uniform_rns against the reference's rng; the moved, Montgomery
draw of a seeded key's uniform half against the reference's
ringkit._regen_a; and the draws the port does not have on a Threefry key
raise."""

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
from heongpu_tpu_torch.utils import errors as terrors  # noqa: E402
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


def test_draws_not_ported_on_a_threefry_key_raise():
    tk = trng.new_key(1, "cpu")
    for fn in (lambda: trng.normal(tk, (4,), "cpu"), lambda: trng.randint(tk, (4,), 0, 3, "cpu"),
               lambda: trng.permutation(tk, 8, "cpu"), lambda: trng.fold_in(tk, 2),
               lambda: trng.gaussian_rns(tk, PRIMES, (4,), "cpu"),
               lambda: trng.ternary_rns(tk, PRIMES, (4,), "cpu")):
        with pytest.raises(terrors.ParameterError, match="Threefry"):
            fn()
    with pytest.raises(ValueError):
        trng.uniform_rns(tk, PRIMES, (4,), "meta")
