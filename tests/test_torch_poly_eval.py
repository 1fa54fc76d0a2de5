"""Port parity for homomorphic polynomial evaluation (models/poly_eval.py),
bit for bit against the JAX package on the CPU.

The context is the bootstrapping variants' v2 chain at N=256
(tests/test_ckks_boot_v2.py: [29] + [28]*18, scale 2^28) with Method II,
alpha 4 and p_count 6, the configuration chip_smoke.py runs at N=2^16.  The
input ciphertext and the relinearization key are the reference's (Threefry
keys), carried into the port by `interop`; encode_const is exact, so every
power and every evaluated polynomial must equal the reference's residues,
level and scale; the reference's gen_powers and eval_poly_bsgs run compiled
as one program each (exact, so with the eager run's residues, at a fraction
of the cost of compiling their ops one at a time on the CPU).  The
coefficient helpers are numpy on both sides and must give equal floats."""

import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import ckks_boot_ext as jext  # noqa: E402
from heongpu_tpu.models import poly_eval as jpe  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot_ext as text  # noqa: E402
from heongpu_tpu_torch.models import poly_eval as tpe  # noqa: E402

torch.set_num_threads(2)

N = 256
Q_BITS = [29] + [28] * 18
CTX_KW = dict(scale_bits=28, sec_level="none", ks_type="II", alpha=4, p_count=6)
V2 = text.BootConfigV2(cos_degree=24, double_angles=5, K=12)
ODD = lambda: tpe.cheb_to_monomial(tpe.chebyshev_interp_coeffs(lambda v: math.sin(2 * v), 15))


def _np(t):
    return interop.to_numpy(t)


def _same(got, want):
    assert (got.size, got.level, got.scale) == (want.size, want.level, want.scale)
    np.testing.assert_array_equal(_np(got.c), np.asarray(want.c))


@pytest.mark.parametrize("case", [
    ("cosine", lambda m: m.cosine_approx_coeffs(V2.R, V2.cos_degree)),
    ("cosine with a phase", lambda m: m.cosine_approx_coeffs(2.5, 23, phase=-math.pi / 2)),
    ("sine on [0, 3]", lambda m: m.chebyshev_interp_coeffs(math.sin, 11, 0.0, 3.0)),
    ("to monomial", lambda m: m.cheb_to_monomial(np.arange(1.0, 9.0) / 7)),
])
def test_coefficient_helpers_equal_reference(case):
    np.testing.assert_array_equal(case[1](tpe), case[1](jpe))


def test_cosine_coefficients_are_the_v2_keys():
    """The v2 keys carry the same cosine coefficients and configuration
    numbers as the reference's (evalmod_depth, R)."""
    ref = jext.BootConfigV2(cos_degree=24, double_angles=5, K=12)
    assert (V2.evalmod_depth, V2.R) == (ref.evalmod_depth, ref.R) == (11, ref.R)
    np.testing.assert_array_equal(tpe.cosine_approx_coeffs(V2.R, 24),
                                  jpe.cosine_approx_coeffs(ref.R, 24))


@pytest.fixture(scope="module")
def sides():
    """The reference's context, keys and an encryption of linspace(-1, 1)
    scaled into the cosine's interval, and the port's context with them
    carried across."""
    jctx = jckks.make_context(N, Q_BITS, **CTX_KW)
    tctx = tckks.make_context(N, Q_BITS, device="cpu", **CTX_KW)
    sk = jckks.keygen_secret(jctx, jrng.new_key(21), hamming_weight=16)
    pk = jckks.keygen_public(jctx, jrng.new_key(22), sk)
    rk = jckks.keygen_relin(jctx, jrng.new_key(23), sk)
    z = np.linspace(-1, 1, N // 2)
    jct = jckks.encrypt(jctx, pk, jckks.encode(jctx, z), jrng.new_key(24))
    tct = interop.ciphertext_from_numpy(np.asarray(jct.c), jct.size, jct.level, jct.scale,
                                        device="cpu")
    trk = interop.ks_key_from_numpy(np.asarray(rk.k0), np.asarray(rk.k1), device="cpu")
    tsk = interop.secret_key_from_numpy(np.asarray(sk.s_coeff), np.asarray(sk.s_ntt_mont_qp),
                                        sk.hamming_weight, device="cpu")
    return jctx, tctx, jct, tct, rk, trk, tsk, z


def test_gen_powers_match_reference(sides):
    jctx, tctx, jct, tct, rk, trk, _, _ = sides
    got = tpe.gen_powers(tctx, tct, 7, trk)
    want = jax.jit(lambda c: jpe.gen_powers(jctx, c, 7, rk))(jct)
    assert sorted(got) == sorted(want) == list(range(1, 8))
    for j in want:
        _same(got[j], want[j])
    assert [got[j].level for j in (1, 2, 3, 4, 5, 7)] == [0, 1, 2, 2, 3, 3]


@pytest.mark.parametrize("poly", ["cosine", "odd"])
def test_eval_poly_bsgs_matches_reference(sides, poly):
    """The v2 cosine (degree 24: two giant splits and a constant-only block)
    and an odd degree-15 sine, each evaluated from level 0."""
    jctx, tctx, jct, tct, rk, trk, tsk, z = sides
    if poly == "cosine":
        coeffs = tpe.cosine_approx_coeffs(2.5, 24)
        want_values = np.cos(2.5 * z)
    else:
        coeffs = ODD()
        want_values = np.sin(2 * z)
    got = tpe.eval_poly_bsgs(tctx, tct, coeffs, trk)
    _same(got, jax.jit(lambda c: jpe.eval_poly_bsgs(jctx, c, coeffs, rk))(jct))
    assert got.level <= 6  # log depth, not Horner's
    dec = tckks.decode(tctx, tckks.decrypt(tctx, tsk, got)).real
    assert np.abs(dec - want_values).max() < 1e-4


def test_constant_polynomial_raises(sides):
    _, tctx, _, tct, _, trk, _, _ = sides
    with pytest.raises(ValueError, match="constant"):
        tpe.eval_poly_bsgs(tctx, tct, [0.5, 0.0, 1e-40], trk)
