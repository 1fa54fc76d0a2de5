"""Port parity for the CKKS device encoder (ops/sfft.py, ops/compose.py) and
the rest of the CKKS surface that bootstrapping calls, against the JAX
package and a float64 numpy oracle on the CPU.

The port's special FFT runs in native float64, so it cannot equal the
reference's df64 one bit for bit.  It is held three ways:
  * bit for bit against a float64 numpy transcription of the same butterfly
    stages (each product, sum and difference correctly rounded the same way);
  * exactly (every residue) against a 120-bit mpmath DFT at scales up to 2^40;
  * within ±2 in the centered residue of each coefficient against the
    reference's df64 `encode_batch_rns` / `encode` at the contexts' default
    scales (~2^29), where the df64 path is accurate to ±1 of the exact value.
Decoding is held within 1e-9 of the big-int host oracle.  The exact parts
(compose, encode_const, sub_plain, mod_drop_plain, keygen_relin at a level,
fold_in with a DRBG) are held bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.ops import compose as jcompose  # noqa: E402
from heongpu_tpu.ops import ntt as jntt  # noqa: E402
from heongpu_tpu.utils import precision as jprecision  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.ops import compose as tcompose  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.ops import sfft as tsfft  # noqa: E402
from heongpu_tpu_torch.utils import errors as terrors  # noqa: E402
from heongpu_tpu_torch.utils import precision as tprecision  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

N, Q_BITS = 1024, [29] * 6


def _np(t):
    return interop.to_numpy(t)


def _slots(n, seed, kind):
    r = np.random.default_rng(seed)
    if kind == "linspace":
        return np.linspace(-1, 1, n // 2)
    if kind == "real":
        return r.uniform(-0.5, 0.5, n // 2)
    return r.uniform(-1, 1, n // 2) + 1j * r.uniform(-1, 1, n // 2)


def _centered_diff(a, b, primes):
    q = np.asarray([int(p) for p in primes], np.int64)[:, None]
    d = (np.asarray(a, np.int64) - np.asarray(b, np.int64)) % q
    return np.where(d > q // 2, d - q, d)


# ---------------------------------------------------------------------------
# the float64 numpy oracle: the same butterfly stages, transcribed
# ---------------------------------------------------------------------------

def _oracle_tables(n):
    """The reference's sfft tables (ops/sfft.py:build_tables), float64."""
    L = n.bit_length() - 1
    br = np.zeros(n, np.int64)
    for b in range(L):
        br |= ((np.arange(n) >> b) & 1) << (L - 1 - b)
    nat = np.empty(n // 2, np.int64)
    g5 = 1
    for j in range(n // 2):
        nat[j] = (g5 - 1) // 2
        g5 = g5 * 5 % (2 * n)
    inv_br = np.argsort(br)
    dit = [np.exp(-2j * np.pi * np.arange(1 << s) / (2 << s)) for s in range(L)]
    k = np.arange(n)
    return dict(enc=inv_br[nat], enc_c=inv_br[n - 1 - nat], dit=dit,
                twe=np.exp(-1j * np.pi * k / n) / n)


def _oracle_embed(zs, n):
    """(B, n/2) complex slots -> (B, n) float64 coefficients: DIT stages on
    (re, im) float64 arrays, products and sums one at a time."""
    t = _oracle_tables(n)
    B = zs.shape[0]
    re = np.zeros((B, n))
    im = np.zeros((B, n))
    re[:, t["enc"]] = zs.real
    re[:, t["enc_c"]] = zs.real
    im[:, t["enc"]] = zs.imag
    im[:, t["enc_c"]] = -zs.imag
    for s, w in enumerate(t["dit"]):
        m, g = 1 << s, n >> (s + 1)
        vr, vi = re.reshape(B, g, 2, m), im.reshape(B, g, 2, m)
        orr, oi = vr[:, :, 1], vi[:, :, 1]
        wr = w.real * orr - w.imag * oi
        wi = w.real * oi + w.imag * orr
        er, ei = vr[:, :, 0], vi[:, :, 0]
        re = np.concatenate([er + wr, er - wr], axis=-1).reshape(B, n)
        im = np.concatenate([ei + wi, ei - wi], axis=-1).reshape(B, n)
    return re * t["twe"].real - im * t["twe"].imag


def _oracle_rns(a, primes):
    """Round half to even, exact int64, reduce per prime: (B, L, n) uint32."""
    c = np.round(a).astype(np.int64)
    q = np.asarray([int(p) for p in primes], np.int64)[:, None]
    return (c[:, None, :] % q).astype(np.uint32)


@pytest.mark.parametrize("n", [256, 1024])
def test_sfft_tables_match_reference(n):
    from heongpu_tpu.ops import df64, sfft as jsfft
    ref = jsfft.build_tables(n)
    got = tsfft.build_tables(n, "cpu")
    for name in ("enc_pos", "enc_pos_conj", "dec_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    for name in ("dit_re", "dit_im", "dif_re", "dif_im", "twe_re", "twe_im", "twd_re", "twd_im"):
        np.testing.assert_allclose(getattr(got, name).numpy(), df64.to_f64(getattr(ref, name)),
                                   rtol=0, atol=1e-14)


@pytest.mark.parametrize("n,kind,scale_bits", [
    (256, "complex", 29), (1024, "linspace", 29), (1024, "complex", 40), (1024, "real", 56)])
def test_encode_batch_rns_equals_float64_oracle(n, kind, scale_bits):
    zs = np.stack([_slots(n, s, kind) for s in (1, 2, 3)])
    primes = tckks.make_context(n, [29] * 3 + [30], ks_type="II", device="cpu").q_primes
    scale = 2.0 ** scale_bits * 1.37
    got = tckks.encode_batch_rns(n, zs, primes, scale, "cpu")
    want = _oracle_rns(_oracle_embed(zs, n) * scale, primes)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("scale_bits", [29, 40])
def test_encode_batch_rns_exact_against_high_precision_dft(scale_bits):
    """Every residue equals round(a·scale) of a 120-bit DFT (N=256): the
    float64 transform loses nothing below 2^40."""
    mpmath = pytest.importorskip("mpmath")
    n = 256
    mpmath.mp.prec = 120
    z = _slots(n, 7, "complex")
    nat = tckks._slot_eval_nat(n)
    spec = [mpmath.mpc(0)] * n
    for j, e in enumerate(nat):
        spec[e] = mpmath.mpc(z[j].real, z[j].imag)
        spec[n - 1 - e] = mpmath.mpc(z[j].real, -z[j].imag)
    scale = mpmath.mpf(2.0 ** scale_bits * 1.37)
    exact = []
    for i in range(n):
        s = mpmath.fsum(spec[k] * mpmath.expj(-2 * mpmath.pi * k * i / n) for k in range(n))
        exact.append(int(mpmath.nint((s / n * mpmath.expj(-mpmath.pi * i / n)).real * scale)))
    primes = tckks.make_context(n, [29] * 3, ks_type="II", device="cpu").q_primes
    got = _np(tckks.encode_batch_rns(n, z[None], primes, float(scale), "cpu"))[0]
    want = np.array([[v % int(q) for v in exact] for q in primes], np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,q_bits,kind", [
    (256, [29] * 4, "complex"), (1024, [29] * 6, "linspace"), (1024, [29] * 6, "complex"),
    (1024, [29, 29] + [28] * 6, "real")])
def test_encode_within_two_of_reference_df64(n, q_bits, kind):
    """At the default scale the df64 path and the float64 one differ by at
    most ±2 in any centered residue; the NTT-domain plaintext is the forward
    transform of the batch encoder's residues."""
    ctx = tckks.make_context(n, q_bits, ks_type="II", device="cpu")
    jctx = jckks.make_context(n, q_bits)
    zs = np.stack([_slots(n, s, kind) for s in (4, 5)])
    scale = ctx.default_scale
    got = _np(tckks.encode_batch_rns(n, zs, ctx.q_primes, scale, "cpu"))
    ref = np.asarray(jckks.encode_batch_rns(n, zs, tuple(jctx.q_primes), scale))
    for b in range(2):
        assert np.abs(_centered_diff(got[b], ref[b], ctx.q_primes)).max() <= 2
    for level in ((2,) if len(q_bits) > 6 else (0,)):
        pt = tckks.encode(ctx, zs[0], level=level)
        jpt = jckks.encode(jctx, zs[0], level=level)
        assert (pt.level, pt.scale) == (jpt.level, jpt.scale)
        ka = ctx.active(level)
        coeff = _np(tntt.ntt_inv(pt.m, ctx.ntt_q(level)))
        np.testing.assert_array_equal(coeff, got[0][:ka])
        jcoeff = np.asarray(jntt.ntt_inv(jpt.m, jctx.ntt_q(level)))
        assert np.abs(_centered_diff(coeff, jcoeff, ctx.q_primes[:ka])).max() <= 2


def test_encode_coeff_equals_oracle():
    ctx = tckks.make_context(N, Q_BITS, ks_type="II", device="cpu")
    v = np.random.default_rng(8).uniform(-1, 1, N)
    for level in (0, 3):
        pt = tckks.encode_coeff(ctx, v, level=level)
        want = _oracle_rns((v * ctx.default_scale)[None], ctx.q_primes[:ctx.active(level)])[0]
        np.testing.assert_array_equal(_np(tntt.ntt_inv(pt.m, ctx.ntt_q(level))), want)
    jctx = jckks.make_context(N, Q_BITS)
    jpt = jckks.encode_coeff(jctx, v)
    jcoeff = np.asarray(jntt.ntt_inv(jpt.m, jctx.ntt_q(0)))
    coeff = _np(tntt.ntt_inv(tckks.encode_coeff(ctx, v).m, ctx.ntt_q(0)))
    assert np.abs(_centered_diff(coeff, jcoeff, ctx.q_primes)).max() <= 2


@pytest.mark.parametrize("q_bits,level", [([29] * 6, 0), ([29] * 6, 3), ([29, 29] + [28] * 6, 5)])
def test_decode_within_1e9_of_host_oracle(q_bits, level):
    ctx = tckks.make_context(N, q_bits, ks_type="II", device="cpu")
    z = _slots(N, 9, "complex")
    pt = tckks.encode_host(ctx, z, level=level)
    got = tckks.decode(ctx, pt)
    want = tckks.decode_host(ctx, pt)
    assert got.shape == (N // 2,) and np.abs(got - want).max() < 1e-9
    assert np.abs(got - z).max() < 1e-6
    coeffs = tckks.decode_coeff(ctx, tckks.encode_coeff(ctx, z.real, level=level))
    assert np.abs(coeffs[: N // 2] - z.real).max() < 1e-8
    # decode_coeff against the host big-int compose of the same plaintext
    ka = ctx.active(level)
    res = _np(tntt.ntt_inv(pt.m, ctx.ntt_q(level))).astype(object)
    primes = [int(q) for q in ctx.q_primes[:ka]]
    Q = int(np.prod(np.array(primes, dtype=object)))
    acc = sum(res[i] * ((pow(Q // q, -1, q) * (Q // q)) % Q) for i, q in enumerate(primes)) % Q
    host = np.array([(v - Q if v >= Q // 2 else v) / pt.scale for v in acc], np.float64)
    assert np.abs(tckks.decode_coeff(ctx, pt) - host).max() < 1e-9


# ---------------------------------------------------------------------------
# compose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 5])
def test_compose_matches_reference(k):
    primes = tckks.make_context(N, [29] * k, ks_type="II", device="cpu").q_primes
    targets = tckks.make_context(N, [29] * 8, ks_type="II", device="cpu").q_primes + (65537,)
    r = np.random.default_rng(k)
    x = np.stack([r.integers(0, int(q), (2, 64)) for q in primes], axis=1).astype(np.uint32)
    jt = jcompose.build_tables(list(primes))
    tt = tcompose.build_tables(primes, "cpu")
    xt = tm.u32_to_i32(x)
    got = tcompose.mod_primes_centered(xt, primes, targets, tt)
    want = jcompose.mod_primes_centered(jnp.asarray(x), primes, targets, jt)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    for t_mod in (65537, int(targets[3])):
        np.testing.assert_array_equal(
            _np(tcompose.mod_prime_centered(xt, primes, t_mod, tt)),
            np.asarray(jcompose.mod_prime_centered(jnp.asarray(x), primes, t_mod, jt)))
    got_l = float(tcompose.frac_log2_norm(xt, primes, tt))
    assert abs(got_l - float(jcompose.frac_log2_norm(jnp.asarray(x), primes, jt))) < 1e-3
    # small values: compose_small gives them exactly, frac_log2_norm their size
    v = r.integers(-(1 << 50), 1 << 50, (3, 64))
    small = tm.u32_to_i32(np.stack([v % int(q) for q in primes], axis=1).astype(np.uint32))
    np.testing.assert_array_equal(tcompose.compose_small(small, tt).numpy(), v.astype(np.float64))
    if k == 2:   # |v|/Q must stay above the float64 resolution of the sum
        got_s = float(tcompose.frac_log2_norm(small, primes, tt))
        assert abs(got_s - np.log2(np.abs(v).max())) < 1e-3


# ---------------------------------------------------------------------------
# the rest of the surface
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drbg_pair():
    """Secret keys from one DRBG seed on both sides, and both contexts."""
    jctx = jckks.make_context(N, Q_BITS, ks_type="II", alpha=2, p_count=3)
    tctx = tckks.make_context(N, Q_BITS, ks_type="II", alpha=2, p_count=3, device="cpu")
    jsk = jax.jit(lambda: jckks.keygen_secret(jctx, jrng.new_drbg(b"e" * 32),
                                              hamming_weight=32))()   # one program: exact
    tsk = tckks.keygen_secret(tctx, trng.new_drbg(b"e" * 32), hamming_weight=32)
    np.testing.assert_array_equal(_np(tsk.s_ntt_mont_qp), np.asarray(jsk.s_ntt_mont_qp))
    return jctx, tctx, jsk, tsk


def test_keygen_relin_at_level_and_fold_in(drbg_pair):
    jctx, tctx, jsk, tsk = drbg_pair
    jd, td = jrng.new_drbg(b"r" * 32), trng.new_drbg(b"r" * 32)
    assert trng.fold_in(td, 7) is td and jrng.fold_in(jd, 7) is jd
    for level in (2,):
        jrk = jax.jit(lambda s: jckks.keygen_relin(jctx, jrng.fold_in(jd, 1), s,
                                                   level=level))(jsk)   # one program: exact
        trk = tckks.keygen_relin(tctx, trng.fold_in(td, 1), tsk, level=level)
        assert trk.k0.shape == (-(-tctx.active(level) // 2), tctx.active(level) + 3, N)
        np.testing.assert_array_equal(_np(trk.k0), np.asarray(jrk.k0))
        np.testing.assert_array_equal(_np(trk.k1), np.asarray(jrk.k1))
    # a torch.Generator: fold_in derives a fresh, reproducible stream and
    # leaves the parent where it was
    g = trng.new_generator(5, "cpu")
    state = g.get_state().clone()
    a = torch.randint(0, 1 << 30, (8,), generator=trng.fold_in(g, 3))
    b = torch.randint(0, 1 << 30, (8,), generator=trng.fold_in(g, 3))
    c = torch.randint(0, 1 << 30, (8,), generator=trng.fold_in(g, 4))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(g.get_state(), state)


def test_encode_const_sub_plain_mod_drop_plain(drbg_pair):
    jctx, tctx, _, _ = drbg_pair
    r = np.random.default_rng(12)
    c = np.stack([r.integers(0, int(q), (2, N)) for q in tctx.q_primes], axis=1).astype(np.uint32)
    jct = jckks.Ciphertext(jnp.asarray(c), 2, 0, tctx.default_scale)
    ct = interop.ciphertext_from_numpy(c, 2, 0, tctx.default_scale, device="cpu")
    for value, scale, level in ((0.25 - 0.5j, jct.scale, 0), (-1.0 / 24.0, 2.0 ** 57 * 1.1, 1),
                                (3.0, 2.0 ** 70, 4)):
        pt = tckks.encode_const(tctx, value, scale, level=level)
        jpt = jckks.encode_const(jctx, value, scale, level=level)
        assert (pt.level, pt.scale) == (jpt.level, jpt.scale)
        np.testing.assert_array_equal(_np(pt.m), np.asarray(jpt.m))
    pt = tckks.encode_const(tctx, 0.25 - 0.5j, jct.scale)
    jpt = jckks.encode_const(jctx, 0.25 - 0.5j, jct.scale)
    np.testing.assert_array_equal(_np(tckks.sub_plain(tctx, ct, pt).c),
                                  np.asarray(jckks.sub_plain(jctx, jct, jpt).c))
    with pytest.raises(terrors.LevelMismatchError):
        tckks.sub_plain(tctx, ct, tckks.encode_const(tctx, 1.0, jct.scale, level=1))
    for levels in (1, 3):
        d = tckks.mod_drop_plain(tctx, pt, levels)
        jd = jckks.mod_drop_plain(jctx, jpt, levels)
        assert (d.level, d.scale) == (jd.level, jd.scale)
        np.testing.assert_array_equal(_np(d.m), np.asarray(jd.m))


def test_print_parameters_matches_reference(capsys):
    tckks.print_parameters(tckks.make_context(N, Q_BITS, ks_type="II", alpha=2, device="cpu"))
    got = capsys.readouterr().out
    jckks.print_parameters(jckks.make_context(N, Q_BITS, ks_type="II", alpha=2))
    assert got == capsys.readouterr().out and "poly_modulus_degree: 1024" in got


def test_precision_stats_match_reference():
    r = np.random.default_rng(13)
    e = r.uniform(-1, 1, 64) + 1j * r.uniform(-1, 1, 64)
    g = e + r.normal(0, 1e-6, 64) + 1j * r.normal(0, 1e-5, 64)
    got = tprecision.precision_stats(e, g)
    want = jprecision.precision_stats(e, g)
    assert [getattr(got, f) for f in got.__dataclass_fields__] == \
        [getattr(want, f) for f in want.__dataclass_fields__]
    assert str(got) == str(want)
