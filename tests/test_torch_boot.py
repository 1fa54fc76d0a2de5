"""Port parity for CKKS regular bootstrapping (models/ckks_boot.py), part 1:
the host DFT factorization, the key set from one DRBG seed, and
the port's own bootstrap against the reference's accuracy limits, on the
CPU.

The configuration is the minimal one that tests/test_boot_sharded.py builds
(N=256, sixteen 29-bit primes, alpha 2, p_count 4, Taylor degree 3, one
squaring, 2 + 2 pieces).  Galois and relin keys from one DRBG seed must equal
the reference's bit for bit.  The diagonal plaintexts come from the float64
encoder on one side and the df64 one on the other: the reference's df64
diagonals are off the exact value by up to 3 in a centered coefficient (the
port's equal a 120-bit DFT there), so they must agree within ±3, and within
±1 in all but 1% of the coefficients.  mod_raise and the evaluation blocks
are held bit for bit in tests/test_torch_boot_eval.py."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import ckks_boot as jboot  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot as tboot  # noqa: E402
from heongpu_tpu_torch.models import ringkit as tring  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.utils import errors as terrors  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

N = 256
CTX_KW = dict(scale_bits=28, sec_level="none", ks_type="II", alpha=2, p_count=4)
Q_BITS = [29] * 16
CFG = dict(taylor_degree=3, exp_squarings=1, ctos_pieces=2, stoc_pieces=2)


def _np(t):
    return interop.to_numpy(t)


# ---------------------------------------------------------------------------
# host factorization (numpy on both sides: equal exactly)
# ---------------------------------------------------------------------------

def _same_diags(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("n", [256, 1024])
def test_dft_factorization_matches_reference(n):
    half = n // 2
    for inverse in (False, True):
        length = 2
        while length <= half:
            _same_diags(tboot.sf_stage_diags(n, length, inverse),
                        jboot.sf_stage_diags(n, length, inverse))
            length *= 2
    a, b = tboot.sf_stage_diags(n, 4, True), tboot.sf_stage_diags(n, 2, True)
    _same_diags(tboot.compose_diags(a, b, half), jboot.compose_diags(a, b, half))
    for pieces, inverse, fold in ((2, True, 0.0123), (3, False, -0.37j), (2, False, 1.0)):
        got = tboot.build_dft_pieces(n, pieces, inverse, fold)
        want = jboot.build_dft_pieces(n, pieces, inverse, fold)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_diags(g, w)
            assert tboot._bsgs_split(list(g), half) == jboot._bsgs_split(list(w), half)


# ---------------------------------------------------------------------------
# the key set from one DRBG seed
# ---------------------------------------------------------------------------

def keys_compiled(fn, *args, **kw):
    """fn(*args, **kw) of the reference with its key generation
    (ckks_boot.leveled_boot_keys, which the key-set builders call) compiled
    as one program: the keys are exact integers and the DRBG draws at trace
    time in the eager order, so they are the eager run's keys, at a fraction
    of the cost of compiling its ops one at a time on the CPU."""
    eager = jboot.leveled_boot_keys

    def compiled(ctx, key, sk, pieces, aux_lvl, **k):
        return jax.jit(lambda s: eager(ctx, key, s, pieces, aux_lvl, **k))(sk)

    jboot.leveled_boot_keys = compiled
    try:
        return fn(*args, **kw)
    finally:
        jboot.leveled_boot_keys = eager


@pytest.fixture(scope="module")
def drbg_keys():
    jctx = jckks.make_context(N, Q_BITS, **CTX_KW)
    tctx = tckks.make_context(N, Q_BITS, device="cpu", **CTX_KW)
    jsk = jckks.keygen_secret(jctx, jrng.new_drbg(b"s" * 32), hamming_weight=16)
    tsk = tckks.keygen_secret(tctx, trng.new_drbg(b"s" * 32), hamming_weight=16)
    jkeys = keys_compiled(jboot.generate_bootstrap_keys, jctx, jrng.new_drbg(b"k" * 32), jsk,
                          jboot.BootConfig(**CFG))
    tkeys = tboot.generate_bootstrap_keys(tctx, trng.new_drbg(b"k" * 32), tsk,
                                          tboot.BootConfig(**CFG))
    return tctx, jkeys, tkeys


def test_boot_keys_from_one_drbg_seed_match(drbg_keys):
    tctx, jkeys, tkeys = drbg_keys
    assert dataclasses.asdict(tkeys.cfg) == dataclasses.asdict(jkeys.cfg)
    assert tkeys.msg_scale == jkeys.msg_scale and tkeys.out_level == jkeys.out_level
    assert sorted(map(str, tkeys.gk.keys)) == sorted(map(str, jkeys.gk.keys))
    for elt, jk in jkeys.gk.keys.items():
        tk = tkeys.gk.keys[elt]
        assert (tk.galois_elt, tk.inv_form) == (jk.galois_elt, jk.inv_form)
        for f in ("k0", "k1", "perm_ntt"):
            np.testing.assert_array_equal(_np(getattr(tk, f)), np.asarray(getattr(jk, f)))
    np.testing.assert_array_equal(_np(tkeys.rk.k0), np.asarray(jkeys.rk.k0))
    np.testing.assert_array_equal(_np(tkeys.rk.k1), np.asarray(jkeys.rk.k1))
    for got, want in zip(tkeys.mult_i + tkeys.mult_neg_i, jkeys.mult_i + jkeys.mult_neg_i):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_boot_diagonals_within_three_of_reference(drbg_keys):
    """Each piece's metadata equals the reference's; its diagonals, taken back
    to centered coefficients (from Montgomery form, inverse NTT), are within
    ±3 of the reference's df64-encoded ones, and within ±1 in 99% of them
    (the df64 encoder's own error: see the module docstring)."""
    tctx, jkeys, tkeys = drbg_keys
    pieces = list(zip(tkeys.ctos_pieces + tkeys.stoc_pieces, jkeys.ctos_pieces + jkeys.stoc_pieces))
    assert len(pieces) == 4
    for tp, jp in pieces:
        assert (tp.level, tp.n1, tp.pt_scale, tp.depth) == (jp.level, jp.n1, jp.pt_scale, jp.depth)
        assert [(g, b) for g, b, _ in tp.giants] == [(g, b) for g, b, _ in jp.giants]
        tb, base = tctx.ntt_qp_at(tp.level), tctx.base_qp_at(tp.level)
        q = np.asarray(tb.primes, np.int64)[:, None]
        back = lambda pts: tntt.ntt_inv(tm.from_mont(pts, base.col(), base.col("rinv")), tb)
        for (_, _, tpts), (_, _, jpts) in zip(tp.giants, jp.giants):
            got = _np(back(tpts)).astype(np.int64)
            want = _np(back(interop._t(np.asarray(jpts), "cpu"))).astype(np.int64)
            d = (got - want) % q
            d = np.abs(np.where(d > q // 2, d - q, d))
            assert d.max() <= 3 and (d > 1).mean() < 0.01


def test_compress_keys_is_not_ported(drbg_keys):
    """compress_keys=True (ported since this test was named): the set's
    Galois and relin keys are stored stripped, each with its seed, at the
    shapes of the full set, and each regenerates its uniform half over the
    basis it was made in.  No two keys share a Threefry key (their seeds
    differ mod 2^32).  A chain too short for the configuration raises."""
    tctx, _, tkeys = drbg_keys
    sk = tckks.keygen_secret(tctx, trng.new_generator(1, "cpu"))
    keys = tboot.generate_bootstrap_keys(tctx, trng.new_generator(2, "cpu"), sk,
                                         tboot.BootConfig(**CFG), compress_keys=True)
    assert sorted(map(str, keys.gk.keys)) == sorted(map(str, tkeys.gk.keys))
    for k, full in [(keys.rk, tkeys.rk)] + [(k, tkeys.gk.keys[e]) for e, k in keys.gk.keys.items()]:
        assert k.k1 is None and k.a_seed is not None and k.k0.shape == full.k0.shape
        assert tring.ensure_k1(tckks._key_ring(tctx, k), k).shape == full.k1.shape
    seeds = [keys.rk.a_seed] + [k.a_seed for k in keys.gk.keys.values()]
    assert len({s % 2 ** 32 for s in seeds}) == len(seeds)
    with pytest.raises(terrors.ParameterError, match="prime Q chain"):
        tboot.generate_bootstrap_keys(tctx, trng.new_generator(2, "cpu"), sk,
                                      tboot.BootConfig(taylor_degree=9, exp_squarings=6))


# ---------------------------------------------------------------------------
# the port's own bootstrap against the reference's accuracy limits
# ---------------------------------------------------------------------------

def _own_bootstrap(q_bits, ctx_kw, cfg, hw, seed, inv_form=False):
    ctx = tckks.make_context(N, q_bits, device="cpu", **ctx_kw)
    g = trng.new_generator(seed, "cpu")
    sk = tckks.keygen_secret(ctx, g, hamming_weight=hw)
    pk = tckks.keygen_public(ctx, g, sk)
    keys = tboot.generate_bootstrap_keys(ctx, g, sk, cfg, inv_form=inv_form)
    z = np.random.default_rng(99).uniform(-0.5, 0.5, N // 2)
    ct = tckks.encrypt(ctx, pk, tckks.encode(ctx, z, scale=keys.msg_scale), g)
    ct = tckks.mod_drop(ctx, ct, ctx.k - cfg.base_count - ct.level)
    fresh = tboot.regular_bootstrap(ctx, ct, keys)
    got = tckks.decode(ctx, tckks.decrypt(ctx, sk, fresh))
    return ctx, keys, sk, fresh, z, got


@pytest.mark.parametrize("inv_form", [False, True])
def test_own_regular_bootstrap_within_reference_limit(inv_form):
    """The configuration and limits of tests/test_ckks_boot.py's
    test_regular_bootstrap: within 5e-2, and the refreshed ciphertext
    squares within 1e-1; with normal and with inverse-form Galois keys."""
    ctx, keys, sk, fresh, z, got = _own_bootstrap(
        [29] + [28] * 18, dict(scale_bits=28, sec_level="none", ks_type="II"),
        tboot.BootConfig(taylor_degree=7, exp_squarings=4), 16, 61, inv_form)
    assert all(k.inv_form == inv_form for k in keys.gk.keys.values())
    assert fresh.level == keys.out_level and ctx.active(fresh.level) >= 2
    assert np.abs(got.real - z).max() < 5e-2
    sq = tckks.rescale(ctx, tckks.relinearize(ctx, tckks.multiply(ctx, fresh, fresh), keys.rk))
    assert np.abs(tckks.decode(ctx, tckks.decrypt(ctx, sk, sq)).real - z * z).max() < 1e-1


def test_own_precision_bootstrap_within_reference_limit():
    """The precision configuration of tests/test_ckks_boot.py (composite q0,
    composite-scale pieces, the arcsine term): within its 3e-5 limit."""
    _, _, _, _, z, got = _own_bootstrap(
        [29, 29] + [28] * 42, CTX_KW,
        tboot.BootConfig(taylor_degree=9, exp_squarings=5, base_count=2, arcsin_order=1,
                         piece_depth=2), 16, 61)
    assert np.isfinite(got).all() and np.abs(got.real - z).max() < 3e-5
