"""Port parity for the CKKS rotation path: polyops tables, Galois and switching
keys, apply_galois, rotate, conjugate, switch_key, hoisting and monomial
products, against the JAX package on the CPU.

At N=1024, [29]*6, Method II alpha=2 (p_count 2, and 3 for the inverse-form
keys), the reference's Threefry keys and ciphertexts are carried over with
`interop` and every op's residues must be bit-identical at levels 0 and 1.
Galois keys from one DRBG seed must equal the reference's.  A port-own run
(torch.Generator keys) must decode within 1e-3."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.ops import polyops as jpoly  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import bgv as tbgv  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import tfhe as ttfhe  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import polyops as tpoly  # noqa: E402
from heongpu_tpu_torch.utils import errors as terrors  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

N, Q_BITS, ALPHA = 1024, [29] * 6, 2
Z = np.random.default_rng(3).uniform(-1, 1, N // 2) + 1j * np.random.default_rng(4).uniform(
    -1, 1, N // 2)


def _np(t):
    return interop.to_numpy(t)


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _ct(c):
    return interop.ciphertext_from_numpy(np.asarray(c.c), c.size, c.level, c.scale, device="cpu")


def _gk(gk):
    """The reference's GaloisKey, element by element, as the port's."""
    fields = ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt", "galois_elt",
              "inv_form")
    return interop.galois_key_from_numpy(
        {e: {f: np.asarray(getattr(k, f)) for f in fields} for e, k in gk.keys.items()},
        device="cpu")


# ---------------------------------------------------------------------------
# polyops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 1024])
def test_polyops_match(n):
    rng = np.random.default_rng(n)
    primes = np.array([536608769, 536215553], np.int64)[:, None]
    x = (rng.integers(0, 1 << 31, (3, 2, n)) % primes).astype(np.uint32)
    p_j = jnp.asarray(primes.astype(np.uint32))
    for step in (1, 3, -1, 7, n // 4):
        assert tpoly.steps_to_galois_elt(step, n) == jpoly.steps_to_galois_elt(step, n)
    for g in (5, 25, 125, 2 * n - 1, jpoly.steps_to_galois_elt(-1, n)):
        src, neg = tpoly.galois_perm_coeff(g, n, "cpu")
        jsrc, jneg = jpoly.galois_perm_coeff(g, n)
        _eq(src, jsrc)
        _eq(neg, jneg)
        perm = tpoly.galois_perm_ntt(g, n, "cpu")
        _eq(perm, jpoly.galois_perm_ntt(g, n))
        _eq(tpoly.apply_galois_coeff(tm.u32_to_i32(x), src, neg, torch.from_numpy(primes)),
            jpoly.apply_galois_coeff(jnp.asarray(x), jsrc, jneg, p_j))
        _eq(tpoly.apply_galois_ntt(tm.u32_to_i32(x), perm),
            jpoly.apply_galois_ntt(jnp.asarray(x), jpoly.galois_perm_ntt(g, n)))
    for k in (1, -1, 5, n + 3, -2 * n + 1):
        src, neg = tpoly.negacyclic_shift_tables(k, n, "cpu")
        jsrc, jneg = jpoly.negacyclic_shift_tables(k, n)
        _eq(src, jsrc)
        _eq(neg, jneg)
        _eq(tpoly.negacyclic_shift(tm.u32_to_i32(x), src, neg, torch.from_numpy(primes)),
            jpoly.negacyclic_shift(jnp.asarray(x), jsrc, jneg, p_j))
    assert tpoly.GALOIS_CONJ == jpoly.GALOIS_CONJ


# ---------------------------------------------------------------------------
# the rotation ops against the reference, Threefry keys carried over
# ---------------------------------------------------------------------------

def _both_sides(p_count, steps, inv_form, seed):
    jctx = jckks.make_context(N, Q_BITS, ks_type="II", alpha=ALPHA, p_count=p_count)
    sk = jckks.keygen_secret(jctx, jrng.new_key(seed))
    pk = jckks.keygen_public(jctx, jrng.new_key(seed + 1), sk)
    gk = jckks.keygen_galois(jctx, jrng.new_key(seed + 2), sk, steps=steps, inv_form=inv_form)
    ct = jckks.encrypt(jctx, pk, jckks.encode_host(jctx, Z), jrng.new_key(seed + 3))
    tctx = tckks.make_context(N, Q_BITS, ks_type="II", alpha=ALPHA, p_count=p_count,
                              device="cpu")
    return dict(ctx=jctx, sk=sk, gk=gk, ct=ct), dict(ctx=tctx, gk=_gk(gk), ct=_ct(ct))


@pytest.fixture(scope="module")
def plain_keys():
    """Normal Galois keys (steps 1, 2 and conj) and a switching key."""
    j, t = _both_sides(ALPHA, [1, 2], False, 11)
    sk2 = jckks.keygen_secret(j["ctx"], jrng.new_key(20))
    j["swk"] = jckks.keygen_switch(j["ctx"], jrng.new_key(21), j["sk"], sk2)
    j["sk2"] = sk2
    t["swk"] = interop.ks_key_from_numpy(np.asarray(j["swk"].k0), np.asarray(j["swk"].k1),
                                         device="cpu")
    return j, t


@pytest.fixture(scope="module")
def inv_keys():
    """Inverse-form Galois keys (steps 1, 3 and conj) at p_count 3."""
    return _both_sides(3, [1, 3], True, 31)


def _at(side, m, level):
    return side["ct"] if level == 0 else m.mod_drop(side["ctx"], side["ct"], level)


def _same(got, want):
    assert (got.size, got.level, got.scale) == (want.size, want.level, want.scale)
    _eq(got.c, want.c)


def _check_rotations(j, t, level, steps, hoisted):
    jc, tc = _at(j, jckks, level), _at(t, tckks, level)
    g = tpoly.steps_to_galois_elt(1, N)
    _same(tckks.apply_galois(t["ctx"], tc, t["gk"].keys[g]),
          jckks.apply_galois(j["ctx"], jc, j["gk"].keys[g]))
    for step in steps:
        _same(tckks.rotate(t["ctx"], tc, t["gk"], step), jckks.rotate(j["ctx"], jc, j["gk"], step))
    _same(tckks.conjugate(t["ctx"], tc, t["gk"]), jckks.conjugate(j["ctx"], jc, j["gk"]))
    jd, td = jckks.hoist(j["ctx"], jc), tckks.hoist(t["ctx"], tc)
    _eq(td, jd)
    pc0 = tckks.p_scale_to_qtilde(t["ctx"], tc.c[0], level)
    _eq(pc0, jckks.p_scale_to_qtilde(j["ctx"], jc.c[0], level))
    for step in hoisted:
        e = tpoly.steps_to_galois_elt(step, N)
        tk, jk = t["gk"].keys[e], j["gk"].keys[e]
        _same(tckks.rotate_hoisted(t["ctx"], tc, td, tk),
              jckks.rotate_hoisted(j["ctx"], jc, jd, jk))
        for got, want in zip(
                tckks.rotate_hoisted_qtilde(t["ctx"], td, tk, pc0, level),
                jckks.rotate_hoisted_qtilde(j["ctx"], jd, jk, jckks.p_scale_to_qtilde(
                    j["ctx"], jc.c[0], level), level)):
            _eq(got, want)


@pytest.mark.parametrize("level", [0, 1])
def test_rotations_match_reference(plain_keys, level):
    j, t = plain_keys
    _check_rotations(j, t, level, (1, 3, 2), (1, 2))
    jc, tc = _at(j, jckks, level), _at(t, tckks, level)
    _same(tckks.switch_key(t["ctx"], tc, t["swk"]), jckks.switch_key(j["ctx"], jc, j["swk"]))
    for k in (N // 2, 3, -1):
        _same(tckks.multiply_power_of_x(t["ctx"], tc, k),
              jckks.multiply_power_of_x(j["ctx"], jc, k))


@pytest.mark.parametrize("level", [0, 1])
def test_inv_form_rotations_match_reference(inv_keys, level):
    j, t = inv_keys
    assert all(k.inv_form for k in t["gk"].keys.values())
    _check_rotations(j, t, level, (1, 3, 4), (1, 3))


def test_galois_key_and_tables_carry_over(plain_keys):
    j, t = plain_keys
    back = interop.to_numpy(t["gk"])
    assert set(back) == set(j["gk"].keys)
    for e, k in j["gk"].keys.items():
        for f in ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt"):
            want = np.asarray(getattr(k, f))
            np.testing.assert_array_equal(back[e][f].view(want.dtype), want, err_msg=f)
        assert (back[e]["galois_elt"], back[e]["inv_form"]) == (k.galois_elt, k.inv_form)
    for k in (N // 2, -5):
        for got, want in zip(tckks.monomial_mult_tables(t["ctx"], k),
                             jckks.monomial_mult_tables(j["ctx"], k)):
            _eq(got, want)


def test_switch_key_and_power_of_x_decode(plain_keys):
    j, t = plain_keys
    ctx = t["ctx"]
    sk2 = interop.secret_key_from_numpy(np.asarray(j["sk2"].s_coeff),
                                        np.asarray(j["sk2"].s_ntt_mont_qp),
                                        j["sk2"].hamming_weight, device="cpu")
    sk = interop.secret_key_from_numpy(np.asarray(j["sk"].s_coeff),
                                       np.asarray(j["sk"].s_ntt_mont_qp),
                                       j["sk"].hamming_weight, device="cpu")
    dec = lambda s, c: tckks.decode(ctx, tckks.decrypt(ctx, s, c))
    assert np.abs(dec(sk2, tckks.switch_key(ctx, t["ct"], t["swk"])) - Z).max() < 1e-3
    assert np.abs(dec(sk, tckks.multiply_power_of_x(ctx, t["ct"], N // 2)) - 1j * Z).max() < 1e-3
    assert np.abs(dec(sk, tckks.rotate(ctx, t["ct"], t["gk"], 3)) - np.roll(Z, -3)).max() < 1e-3
    assert np.abs(dec(sk, tckks.conjugate(ctx, t["ct"], t["gk"])) - np.conj(Z)).max() < 1e-3


# ---------------------------------------------------------------------------
# DRBG keygen, the port's own run, misuse and the device defaults
# ---------------------------------------------------------------------------

def test_keygen_galois_drbg_matches():
    seed = bytes(range(32))
    jctx = jckks.make_context(256, [29] * 4, ks_type="II", alpha=2)
    tctx = tckks.make_context(256, [29] * 4, ks_type="II", alpha=2, device="cpu")
    out = {}
    for name, m, ctx, d in (("jax", jckks, jctx, jrng.new_drbg(seed, b"galois")),
                            ("torch", tckks, tctx, trng.new_drbg(seed, b"galois"))):
        sk = m.keygen_secret(ctx, d)
        out[name] = (m.keygen_galois(ctx, d, sk, steps=[1, 1]),
                     m.keygen_galois(ctx, d, sk, steps=[3], include_conj=False, level=1,
                                     inv_form=True))
    for jg, tg in zip(out["jax"], out["torch"]):
        assert set(tg.keys) == set(jg.keys)
        for e, k in jg.keys.items():
            assert (tg.keys[e].galois_elt, tg.keys[e].inv_form) == (k.galois_elt, k.inv_form)
            _eq(tg.keys[e].k0, k.k0)
            _eq(tg.keys[e].k1, k.k1)
    assert out["torch"][1].keys[tpoly.steps_to_galois_elt(3, 256)].k0.shape == (2, 5, 256)


def test_port_own_rotation_decodes():
    ctx = tckks.make_context(N, Q_BITS, ks_type="II", alpha=ALPHA, device="cpu")
    g = trng.new_generator(9, "cpu")
    sk = tckks.keygen_secret(ctx, g)
    pk = tckks.keygen_public(ctx, g, sk)
    gk = tckks.keygen_galois(ctx, g, sk, steps=[1, 2, 4])
    ct = tckks.encrypt(ctx, pk, tckks.encode(ctx, Z), g)
    for step in (1, 7, -1):
        got = tckks.decode(ctx, tckks.decrypt(ctx, sk, tckks.rotate(ctx, ct, gk, step)))
        assert np.isfinite(got).all() and got.shape == (N // 2,)
        assert np.abs(got - np.roll(Z, -step)).max() < 1e-3, step


def test_rotation_misuse_raises(plain_keys):
    _, t = plain_keys
    ctx = t["ctx"]
    only_two = tckks.GaloisKey({e: k for e, k in t["gk"].keys.items()
                                if e == tpoly.steps_to_galois_elt(2, N)})
    with pytest.raises(ValueError):
        tckks.rotate(ctx, t["ct"], only_two, 1)
    # a key stored without its uniform half and with no seed to regenerate it
    g1 = tpoly.steps_to_galois_elt(1, N)
    stripped = tckks.GaloisKey({g1: dataclasses.replace(t["gk"].keys[g1], k1=None)})
    with pytest.raises(terrors.ParameterError):
        tckks.rotate(ctx, t["ct"], stripped, 1)
    with pytest.raises(terrors.ParameterError):
        tckks.keygen_galois(ctx, trng.new_generator(1, "cpu"), None, steps=[1], store_a=False)


def test_entry_points_default_to_the_card():
    fns = [tckks.make_context, ttfhe.make_context, ttfhe.keygen_secret, trng.new_generator,
           tbgv.make_context, trng.new_key]
    fns += [getattr(interop, f) for f in dir(interop) if f.endswith("_from_numpy")]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    # the BGV keygens draw on their context's device, and a Threefry key's draws on
    # the key's: the card unless the caller asks for the CPU
    for fn in (tbgv.keygen_secret, tbgv.keygen_public, tbgv.keygen_relin, tbgv.keygen_galois,
               tbgv.keygen_switch):
        assert "device" not in inspect.signature(fn).parameters, fn.__name__
    assert trng.new_key(3).device.type == "cuda"
    bctx = tbgv.make_context(256, 7681, q_bits=[29, 29], device="cpu")
    assert tbgv.keygen_secret(bctx, trng.new_drbg(b"d" * 32)).s_ntt_mont_qp.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tckks.make_context(256, [29] * 3)
