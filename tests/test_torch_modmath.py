"""Port parity: heongpu_tpu_torch.ops.modmath against heongpu_tpu.ops.modmath.

Random canonical residues (and raw 32-bit words where the reference takes
any word) from one numpy seed go through both; results must be
bit-identical."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from heongpu_tpu.ops import modmath as jm  # noqa: E402
from heongpu_tpu.utils import nt as jnt  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.utils import nt as tnt  # noqa: E402

torch.set_num_threads(2)

PRIMES = tnt.generate_ntt_primes(30, 2, 4096) + tnt.generate_ntt_primes(29, 2, 4096)
N = 2048


def _rand(rng, p, n=N):
    return rng.integers(0, p, size=n, dtype=np.uint32)


def _words(rng, n=N):
    return rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return tm.u32_to_i32(a)


def _np(t):
    return t.numpy().view(np.uint32)


def test_primes_match_reference():
    assert PRIMES == jnt.generate_ntt_primes(30, 2, 4096) + jnt.generate_ntt_primes(29, 2, 4096)


@pytest.mark.parametrize("p", PRIMES)
def test_elementwise_ops(p):
    rng = np.random.default_rng(p % 1000)
    a, b = _rand(rng, p), _rand(rng, p)
    a[:4] = [0, p - 1, 0, 1]
    b[:4] = [0, p - 1, p - 1, p - 1]
    pj, P = jnp.uint32(p), torch.tensor(p)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pinv, r2 = jnp.uint32(jm.mont_pinv(p)), jnp.uint32(jm.mont_r2(p))
    rinv, r1 = tm.mont_rinv(p), tm.mont_r1(p)
    w = int(b[7])
    two_p = (a.astype(np.uint64) + b) % (2 * p)      # a value in [0, 2p)
    cases = [
        (jm.add_mod(ja, jb, pj), tm.add_mod(_t(a), _t(b), P)),
        (jm.sub_mod(ja, jb, pj), tm.sub_mod(_t(a), _t(b), P)),
        (jm.neg_mod(ja, pj), tm.neg_mod(_t(a), P)),
        (jm.cond_sub(jnp.asarray(two_p.astype(np.uint32)), pj),
         tm.cond_sub(_t(two_p), P)),
        (jm.mont_mul(ja, jb, pj, pinv), tm.mont_mul(_t(a), _t(b), P, rinv)),
        (jm.to_mont(ja, pj, pinv, r2), tm.to_mont(_t(a), P, r1)),
        (jm.from_mont(ja, pj, pinv), tm.from_mont(_t(a), P, rinv)),
        (jm.mul_mod(ja, jb, pj, pinv, r2), tm.mul_mod(_t(a), _t(b), P)),
        (jm.shoup_mul(ja, jnp.uint32(w), jnp.uint32(jm.shoup(w, p)), pj),
         tm.shoup_mul(_t(a), w, P)),
    ]
    for want, got in cases:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("p", PRIMES)
def test_word_reductions(p):
    rng = np.random.default_rng(p % 997)
    x, hi, lo = _words(rng), _words(rng), _words(rng)
    x[:3] = [0, 0xFFFFFFFF, 0x80000000]
    mu = jnp.uint32(jm.barrett_mu(p))
    r1 = jm.mont_r1(p)
    P = torch.tensor(p)
    np.testing.assert_array_equal(
        _np(tm.barrett32(_t(x), P)),
        np.asarray(jm.barrett32(jnp.asarray(x), jnp.uint32(p), mu)))
    want = jm.reduce64(jnp.asarray(hi), jnp.asarray(lo), jnp.uint32(p), mu,
                       jnp.uint32(r1), jnp.uint32(jm.shoup(r1, p)))
    np.testing.assert_array_equal(_np(tm.reduce64(_t(hi), _t(lo), P)), np.asarray(want))
    # int64 words (the samplers' form) give the same answer as int32 bit patterns
    np.testing.assert_array_equal(
        _np(tm.reduce64(torch.from_numpy(hi.astype(np.int64)),
                        torch.from_numpy(lo.astype(np.int64)), P)),
        np.asarray(want))


def test_host_constants():
    for p in PRIMES:
        assert (tm.mont_pinv(p), tm.mont_r1(p), tm.mont_r2(p), tm.barrett_mu(p),
                tm.shoup(12345, p)) == (jm.mont_pinv(p), jm.mont_r1(p), jm.mont_r2(p),
                                        jm.barrett_mu(p), jm.shoup(12345, p))
        assert tm.mont_rinv(p) * (1 << 32) % p == 1
