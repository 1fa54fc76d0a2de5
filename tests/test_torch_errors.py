"""Port of tests/test_errors.py: typed misuse errors of heongpu_tpu_torch
(the reference library raises std::invalid_argument on scale, level and size
mismatches; both packages validate on the host before any device work).

The same 13 checks on the port's CPU path, at the same N=256 shapes and
chains.  The port's error classes mirror the JAX package's (same names, same
ValueError base), and the scale-prime pairing check also holds the port's
primes and default scale equal to the JAX package's."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.utils import errors as jerrors  # noqa: E402
from heongpu_tpu_torch.models import bfv, ckks  # noqa: E402
from heongpu_tpu_torch.utils import errors, params, rng, storage  # noqa: E402

N = 256
CPU = "cpu"
key = lambda s: rng.new_key(s, device=CPU)


@pytest.fixture(scope="module")
def csetup():
    ctx = ckks.make_context(N, [29, 25, 25, 25], sec_level="none", device=CPU)
    sk = ckks.keygen_secret(ctx, key(1))
    pk = ckks.keygen_public(ctx, key(2), sk)
    z = np.random.default_rng(0).uniform(-1, 1, N // 2)
    ct = ckks.encrypt(ctx, pk, ckks.encode(ctx, z), key(3))
    return ctx, sk, pk, ct


def test_level_mismatch_add(csetup):
    ctx, sk, pk, ct = csetup
    low = ckks.mod_drop(ctx, ct, 1)
    with pytest.raises(errors.LevelMismatchError):
        ckks.add(ctx, ct, low)


def test_scale_mismatch_add(csetup):
    ctx, sk, pk, ct = csetup
    other = ckks.Ciphertext(ct.c, ct.size, ct.level, ct.scale * 2.0)
    with pytest.raises(errors.ScaleMismatchError):
        ckks.add(ctx, ct, other)


def test_size_mismatch_relin(csetup):
    ctx, sk, pk, ct = csetup
    rk = ckks.keygen_relin(ctx, key(4), sk)
    with pytest.raises(errors.CipherSizeError):
        ckks.relinearize(ctx, ct, rk)   # size 2, needs 3


def test_multiply_requires_size2(csetup):
    ctx, sk, pk, ct = csetup
    big = ckks.multiply(ctx, ct, ct)
    with pytest.raises(errors.CipherSizeError):
        ckks.multiply(ctx, big, ct)


def test_rescale_at_last_level(csetup):
    ctx, sk, pk, ct = csetup
    bottom = ckks.mod_drop(ctx, ct, ctx.k - 1)
    with pytest.raises(errors.LevelMismatchError):
        ckks.rescale(ctx, bottom)


def test_encrypt_nonzero_level(csetup):
    ctx, sk, pk, ct = csetup
    pt = ckks.encode(ctx, np.zeros(N // 2))
    low = ckks.mod_drop_plain(ctx, pt, 1)
    with pytest.raises(errors.LevelMismatchError):
        ckks.encrypt(ctx, pk, low, key(5))


def test_plain_level_scale_checks(csetup):
    ctx, sk, pk, ct = csetup
    pt = ckks.encode(ctx, np.zeros(N // 2))
    low = ckks.mod_drop_plain(ctx, pt, 1)
    with pytest.raises(errors.LevelMismatchError):
        ckks.add_plain(ctx, ct, low)
    odd = ckks.Plaintext(pt.m, pt.level, pt.scale * 4.0)
    with pytest.raises(errors.ScaleMismatchError):
        ckks.sub_plain(ctx, ct, odd)


def test_bfv_bad_plain_modulus():
    with pytest.raises(errors.ParameterError):
        bfv.make_context(N, 17, q_bits=[29, 29], sec_level="none", device=CPU)  # not 1 mod 2n


def test_bfv_domain_and_size():
    t = params.plain_modulus_for(N, 20)
    ctx = bfv.make_context(N, t, q_bits=[29, 29], sec_level="none", device=CPU)
    sk = bfv.keygen_secret(ctx, key(6))
    pk = bfv.keygen_public(ctx, key(7), sk)
    m = np.arange(N) % ctx.t
    ct = bfv.encrypt(ctx, pk, bfv.encode(ctx, m), key(8))
    ntt_ct = bfv.transform_to_ntt(ctx, ct)
    with pytest.raises(errors.NttDomainError):
        bfv.transform_to_ntt(ctx, ntt_ct)
    with pytest.raises(errors.NttDomainError):
        bfv.multiply_power_of_x(ctx, ntt_ct, 3)
    rk = bfv.keygen_relin(ctx, key(9), sk)
    with pytest.raises(errors.CipherSizeError):
        bfv.relinearize(ctx, ct, rk)


def test_storage_keep_initial_condition_rejected():
    opts = storage.ExecutionOptions(keep_initial_condition=False, device=CPU)
    with pytest.raises(ValueError):
        storage.run_with_storage(lambda x: x, [torch.zeros(4)], opts)


def test_errors_are_valueerrors():
    """All misuse errors subclass ValueError so generic handlers work, and the
    port has each of the JAX package's error classes."""
    for e in (errors.LevelMismatchError, errors.ScaleMismatchError,
              errors.CipherSizeError, errors.NttDomainError,
              errors.ParameterError):
        assert issubclass(e, ValueError)
        assert issubclass(getattr(jerrors, e.__name__), ValueError)


def test_methodI_shallow_key_at_full_level_raises(csetup):
    """A Method-I key generated at a deeper level (fewer limbs) must fail
    loudly at a shallower use level, not slice into a malformed key."""
    ctx, sk, pk, ct = csetup
    gk = ckks.keygen_galois(ctx, key(11), sk, steps=[1], level=2)
    with pytest.raises(errors.LevelMismatchError):
        ckks.rotate(ctx, ct, gk, 1)


def test_scale_prime_pairing_invariant():
    """Complementary pairing: consecutive consumed PAIRS multiply to ~the
    anchor squared, the base prime at index 0 never joins the pairing, and
    pair_scale_primes=False restores generation order + 2^scale_bits; the
    port's chains and scales are the JAX package's."""
    q_bits = [28] * 10          # uniform chain: base prime bit-size matches
    on = ckks.make_context(N, q_bits, scale_bits=28, sec_level="none", device=CPU)
    off = ckks.make_context(N, q_bits, scale_bits=28, sec_level="none",
                            pair_scale_primes=False, device=CPU)
    for got, pair in ((on, None), (off, False)):
        want = jckks.make_context(N, q_bits, scale_bits=28, sec_level="none",
                                  pair_scale_primes=pair)
        assert tuple(got.q_primes) == tuple(want.q_primes)
        assert got.default_scale == want.default_scale
    assert off.default_scale == 2.0 ** 28
    assert sorted(on.q_primes) == sorted(off.q_primes)
    assert on.q_primes[0] == off.q_primes[0]      # base prime untouched
    anchor = math.log2(on.default_scale)
    logs = [math.log2(p) for p in on.q_primes[1:]]
    assert abs(sum(logs) / len(logs) - anchor) < 1e-9
    # rescale consumes from the TOP of the chain: each consecutive pair of
    # consumed primes (k-1, k-2), (k-3, k-4), ... balances around anchor^2
    spread = max(logs) - min(logs)
    rev = logs[::-1]
    for i in range(0, len(rev) - 1, 2):
        off_pair = abs(rev[i] + rev[i + 1] - 2 * anchor)
        assert off_pair <= spread / 2 + 1e-9
