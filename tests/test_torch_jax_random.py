"""The rest of jax.random over a Threefry key, in the port, against jax.random
and the reference's sampling facade on the CPU.

Under JAX's defaults (jax_threefry_partitionable, x64 off): fold_in; randint
(int32) at spans 3, 2, t, 2^31 (lo = -2^30, where jax's multiplier wraps to
0), [0, 2^10), ±2^13, the full int32 range and an empty range; the float32
uniform of normal's range, bit for bit; normal within 1e-6 (XLA's float32
log1p and its fused products differ from the port's in the last places of
about one word in twenty) with its rounded σ = 3.2 gaussian integers equal
everywhere; permutation at n = 1, 256, 4096 and 2^16 (0, 1, 2 and 2 sort
rounds); the facade's gaussian_rns, ternary_rns and ternary_hw; and CKKS and
BFV keygen and encryption on Threefry keys.  Residues equal: tolerance 0."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from heongpu_tpu.models import bfv as jbfv  # noqa: E402
from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.utils import params as jparams  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import bfv as tbfv  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402
from heongpu_tpu_torch.utils import threefry as ttf  # noqa: E402

torch.set_num_threads(2)

SEEDS = [0, 7, 2 ** 31 + 5, 1234]
PRIMES = (536608769, 536215553, 1073479681)
T = jparams.plain_modulus_for(256, 16)


def _u32(t):
    return interop.to_numpy(t)


def _keys(seed):
    return jax.random.PRNGKey(seed), trng.new_key(seed, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    jk, tk = _keys(seed)
    for data in (0, 1, 2, 99, 2 ** 31, 2 ** 32 - 1):
        want = tuple(int(w) for w in np.asarray(jax.random.fold_in(jk, data)))
        assert trng.fold_in(tk, data).words == ttf.fold_in_np(tk.words, data) == want
        assert trng.fold_in(tk, data).device == tk.device


RANGES = [(0, 3), (0, 2), (0, T), (-(1 << 30), 1 << 30), (0, 1 << 10), (-(1 << 13), 1 << 13),
          (-(2 ** 31), 2 ** 31 - 1), (5, 5), (9, 3)]


@pytest.mark.parametrize("lo,hi", RANGES, ids=[f"{a}_{b}" for a, b in RANGES])
def test_randint(lo, hi):
    for seed in SEEDS[:3]:
        jk, tk = _keys(seed)
        for shape in ((1000,), (3, 17)):
            want = np.asarray(jax.random.randint(jk, shape, lo, hi, jnp.int32))
            got = trng.randint(tk, shape, lo, hi, "cpu")
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_randint_span_wraps_as_jax_does():
    """jax's multiplier (2^16 mod span)^2 wraps to 0 in uint32 above a span of
    2^16, and a span that wraps to 0 leaves the remainders unreduced."""
    assert ttf._randint_span(-(1 << 30), 1 << 30) == (-(1 << 30), 1 << 31, 0)
    assert ttf._randint_span(0, 3) == (0, 3, 1)
    assert ttf._randint_span(0, 1 << 16)[2] == 0
    assert ttf._randint_span(3, 3)[1:] == (1, 0)
    assert ttf._randint_span(-(2 ** 31), 2 ** 31)[1] == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_normal(seed):
    jk, tk = _keys(seed)
    n = 1 << 16
    words = ttf.bits32(tk.words, (n,), "cpu")
    want_u = np.asarray(jax.random.uniform(jk, (n,), jnp.float32, ttf.NORMAL_LO, 1.0))
    np.testing.assert_array_equal(ttf.uniform_f32(words, ttf.NORMAL_LO, 1.0).numpy().view(
        np.uint32), want_u.view(np.uint32))
    want = np.asarray(jax.random.normal(jk, (n,), jnp.float32))
    got = trng.normal(tk, (n,), "cpu")
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got == want).mean() > 0.9
    gauss = lambda g: np.clip(np.round(g * np.float32(3.2)), -19.2, 19.2)
    np.testing.assert_array_equal(gauss(got), gauss(want))


def test_erf_inv_matches_lax_at_the_branch_and_the_ends():
    x = np.array([-0.9999999, -0.99, -0.9866, -0.5, 0.0, 1e-8, 0.3, 0.98657, 0.9999],
                 np.float32)
    got = ttf.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.lax.erf_inv(x)), rtol=2e-6, atol=1e-7)
    ends = ttf.erf_inv(torch.tensor([-1.0, 1.0])).numpy()
    assert np.isneginf(ends[0]) and np.isposinf(ends[1])


@pytest.mark.parametrize("n", [1, 256, 4096, 1 << 16])
def test_permutation(n):
    assert ttf.permutation_rounds(n) == {1: 0, 256: 1, 4096: 2, 1 << 16: 2}[n]
    for seed in SEEDS[:2]:
        jk, tk = _keys(seed)
        np.testing.assert_array_equal(trng.permutation(tk, n, "cpu").numpy(),
                                      np.asarray(jax.random.permutation(jk, n)))


@pytest.mark.parametrize("seed", SEEDS)
def test_facade_gaussian_ternary_and_hamming_weight(seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(_u32(trng.gaussian_rns(tk, PRIMES, (3, 256), "cpu")),
                                  np.asarray(jrng.gaussian_rns(jk, PRIMES, (3, 256))))
    np.testing.assert_array_equal(
        _u32(trng.gaussian_rns(tk, PRIMES, (256,), "cpu", noise_scale=T)),
        np.asarray(jrng.gaussian_rns(jk, PRIMES, (256,), noise_scale=T)))
    np.testing.assert_array_equal(_u32(trng.ternary_rns(tk, PRIMES, (2, 256), "cpu")),
                                  np.asarray(jrng.ternary_rns(jk, PRIMES, (2, 256))))
    for n, hw in ((256, 128), (4096, 64)):
        np.testing.assert_array_equal(trng.ternary_hw(tk, n, hw, "cpu").numpy(),
                                      np.asarray(jrng.ternary_hw(jk, n, hw)))


def test_ckks_keygen_and_encrypt_on_threefry_keys():
    jc = jckks.make_context(256, [29, 25, 25], sec_level="none")
    tc = tckks.make_context(256, [29, 25, 25], sec_level="none", device="cpu")
    jsk, tsk = jckks.keygen_secret(jc, jrng.new_key(4)), tckks.keygen_secret(tc, trng.new_key(4, "cpu"))
    np.testing.assert_array_equal(tsk.s_coeff.numpy(), np.asarray(jsk.s_coeff))
    np.testing.assert_array_equal(_u32(tsk.s_ntt_mont_qp), np.asarray(jsk.s_ntt_mont_qp))
    jpk = jckks.keygen_public(jc, jrng.new_key(5), jsk)
    tpk = tckks.keygen_public(tc, trng.new_key(5, "cpu"), tsk)
    np.testing.assert_array_equal(_u32(tpk.pk0), np.asarray(jpk.pk0))
    np.testing.assert_array_equal(_u32(tpk.pk1), np.asarray(jpk.pk1))
    jrk = jckks.keygen_relin(jc, jrng.new_key(6), jsk)
    trk = tckks.keygen_relin(tc, trng.new_key(6, "cpu"), tsk)
    np.testing.assert_array_equal(_u32(trk.k0), np.asarray(jrk.k0))
    # the reference's plaintext: the two encoders round the slots apart by up to 2
    jpt = jckks.encode(jc, np.linspace(-1, 1, 128))
    tpt = interop.plaintext_from_numpy(np.asarray(jpt.m), jpt.level, jpt.scale, device="cpu")
    jct = jckks.encrypt(jc, jpk, jpt, jrng.new_key(7))
    tct = tckks.encrypt(tc, tpk, tpt, trng.new_key(7, "cpu"))
    np.testing.assert_array_equal(_u32(tct.c), np.asarray(jct.c))


def test_bfv_keygen_and_encrypt_on_threefry_keys():
    jc = jbfv.make_context(256, T, q_bits=[29, 29], sec_level="none")
    tc = tbfv.make_context(256, T, q_bits=[29, 29], sec_level="none", device="cpu")
    jsk, tsk = jbfv.keygen_secret(jc, jrng.new_key(1)), tbfv.keygen_secret(tc, trng.new_key(1, "cpu"))
    jpk = jbfv.keygen_public(jc, jrng.new_key(2), jsk)
    tpk = tbfv.keygen_public(tc, trng.new_key(2, "cpu"), tsk)
    np.testing.assert_array_equal(_u32(tpk.pk0), np.asarray(jpk.pk0))
    m = np.arange(256) % T
    jct = jbfv.encrypt(jc, jpk, jbfv.encode(jc, m), jrng.new_key(3))
    tct = tbfv.encrypt(tc, tpk, tbfv.encode(tc, m), trng.new_key(3, "cpu"))
    np.testing.assert_array_equal(_u32(tct.c), np.asarray(jct.c))
    np.testing.assert_array_equal(tbfv.decode(tc, tbfv.decrypt(tc, tsk, tct)), m.astype(np.uint32))
