"""Port parity on the DRBG path: heongpu_tpu_torch.utils.rng, keygen and
encrypt against the reference, from one AES-CTR DRBG seed.

Both packages draw the same bytes in the same order (the sampler draw order,
the float32 Box-Muller scale-and-round of the gaussian, the argsort-based
fixed-hamming-weight secret), so samples, keys and ciphertexts must be
bit-identical.  The torch.Generator source is checked for shape and range."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

SEED = bytes(range(32))
PRIMES = (536608769, 536215553, 1073479681)


def _np(t):
    t = t.cpu()
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _pair(tag: bytes):
    return jrng.new_drbg(SEED, tag), trng.new_drbg(SEED, tag)


def test_samplers_match_reference():
    jd, td = _pair(b"samplers")
    seq = [
        (lambda k: jrng.uniform_rns(k, PRIMES, (3, 64)),
         lambda k: trng.uniform_rns(k, PRIMES, (3, 64))),
        (lambda k: jrng.gaussian_rns(k, PRIMES, (4096,)),
         lambda k: trng.gaussian_rns(k, PRIMES, (4096,))),
        (lambda k: jrng.gaussian_rns(k, PRIMES, (2, 100), noise_scale=65537),
         lambda k: trng.gaussian_rns(k, PRIMES, (2, 100), noise_scale=65537)),
        (lambda k: jrng.ternary_rns(k, PRIMES, (512,)),
         lambda k: trng.ternary_rns(k, PRIMES, (512,))),
        (lambda k: jrng.ternary_hw(k, 512, 200), lambda k: trng.ternary_hw(k, 512, 200)),
        (lambda k: jrng.randint(k, (300,), 2, 9), lambda k: trng.randint(k, (300,), 2, 9)),
        (lambda k: jrng.permutation(k, 128), lambda k: trng.permutation(k, 128)),
        (lambda k: jrng.normal(k, (1000,)), lambda k: trng.normal(k, (1000,))),
    ]
    for i, (jf, tf) in enumerate(seq):
        want, got = np.asarray(jf(jd)), _np(tf(td))
        assert want.shape == got.shape, i
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=str(i))
    e = np.array([-7, -1, 0, 1, 2 ** 31 - 1, -(2 ** 31)], np.int32)
    np.testing.assert_array_equal(
        _np(trng.signed_to_rns(torch.from_numpy(e), PRIMES)),
        np.asarray(jrng.signed_to_rns(jrng.jnp.asarray(e), PRIMES)))


def test_generator_source_shapes_and_ranges():
    g = trng.new_generator(5)
    u = trng.uniform_rns(g, PRIMES, (2, 256))
    assert u.shape == (3, 2, 256) and u.dtype == torch.int32
    assert all(int(u[i].max()) < p and int(u[i].min()) >= 0 for i, p in enumerate(PRIMES))
    e = trng.gaussian_rns(g, PRIMES, (4096,)).to(torch.int64)
    centered = torch.where(e[0] > PRIMES[0] // 2, e[0] - PRIMES[0], e[0])
    assert int(centered.abs().max()) <= 19 and 2.5 < float(centered.double().std()) < 4.0
    s = trng.ternary_hw(g, 1024, 300)
    assert int((s != 0).sum()) == 300 and set(s.unique().tolist()) <= {-1, 0, 1}


@pytest.fixture(scope="module")
def keysets():
    """Keys and one ciphertext at N=256, [29]*4, Method II alpha=2, from one
    DRBG seed in each package (the reference's DRBG path runs eagerly)."""
    jctx = jckks.make_context(256, [29] * 4, ks_type="II", alpha=2)
    tctx = tckks.make_context(256, [29] * 4, ks_type="II", alpha=2)
    out = {}
    for name, m, ctx, d in (("jax", jckks, jctx, jrng.new_drbg(SEED, b"keys")),
                            ("torch", tckks, tctx, trng.new_drbg(SEED, b"keys"))):
        sk = m.keygen_secret(ctx, d)
        pk = m.keygen_public(ctx, d, sk)
        rk = m.keygen_relin(ctx, d, sk)
        pt = m.encode_host(ctx, np.linspace(-1, 1, 128))
        ct = m.encrypt(ctx, pk, pt, d)
        out[name] = dict(sk=sk, pk=pk, rk=rk, pt=pt, ct=ct, ctx=ctx)
    return out


def test_keygen_secret_matches(keysets):
    j, t = keysets["jax"], keysets["torch"]
    np.testing.assert_array_equal(t["sk"].s_coeff.numpy(), np.asarray(j["sk"].s_coeff))
    np.testing.assert_array_equal(_np(t["sk"].s_ntt_mont_qp), np.asarray(j["sk"].s_ntt_mont_qp))
    assert t["sk"].hamming_weight == j["sk"].hamming_weight


def test_keygen_public_and_relin_match(keysets):
    j, t = keysets["jax"], keysets["torch"]
    np.testing.assert_array_equal(_np(t["pk"].pk0), np.asarray(j["pk"].pk0))
    np.testing.assert_array_equal(_np(t["pk"].pk1), np.asarray(j["pk"].pk1))
    assert t["rk"].k0.shape == (2, 6, 256)
    np.testing.assert_array_equal(_np(t["rk"].k0), np.asarray(j["rk"].k0))
    np.testing.assert_array_equal(_np(t["rk"].k1), np.asarray(j["rk"].k1))


def test_encode_and_encrypt_match(keysets):
    j, t = keysets["jax"], keysets["torch"]
    np.testing.assert_array_equal(_np(t["pt"].m), np.asarray(j["pt"].m))
    assert (t["ct"].size, t["ct"].level, t["ct"].scale) == (
        j["ct"].size, j["ct"].level, j["ct"].scale)
    np.testing.assert_array_equal(_np(t["ct"].c), np.asarray(j["ct"].c))
    back = tckks.decode_host(t["ctx"], tckks.decrypt(t["ctx"], t["sk"], t["ct"]))
    assert np.abs(back - np.linspace(-1, 1, 128)).max() < 1e-3
