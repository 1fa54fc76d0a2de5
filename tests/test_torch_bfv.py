"""Port parity for BFV (Method-I keyswitching), against the JAX package on
the CPU.

At N=256 over four 29-bit Q primes, t = plain_modulus_for(256, 20): the
context tables; encode/decode; keys and a ciphertext from one DRBG seed; and,
with the reference's Threefry keys and ciphertexts carried over by `interop`,
decryption, the noise budget (within 1e-6 bits: the reference sums in df64),
the arithmetic, each BEHZ helper and the whole multiply, relinearize, the
rotations (normal and inverse-form keys, hoisted), switch_key, the monomial
product and the NTT transforms.  Every residue must be bit-identical.
tests/test_torch_bfv_method2.py runs the same tests under Method II."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import bfv as jbfv  # noqa: E402
from heongpu_tpu.utils import errors as jerrors  # noqa: E402
from heongpu_tpu.utils import params as jparams  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import bfv as tbfv  # noqa: E402
from heongpu_tpu_torch.models import ringkit as tring  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import polyops as tpoly  # noqa: E402
from heongpu_tpu_torch.utils import errors as terrors  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

N, Q_BITS = 256, [29] * 4
T = jparams.plain_modulus_for(N, 20)
HALF = N // 2


def _np(t):
    return interop.to_numpy(t)


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _ct(c):
    return interop.bfv_ciphertext_from_numpy(np.asarray(c.c), c.size, c.in_ntt, device="cpu")


def _same(got, want):
    assert (got.size, got.in_ntt) == (want.size, want.in_ntt)
    _eq(got.c, want.c)


def _gk(gk):
    fields = ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt", "galois_elt",
              "inv_form")
    return interop.galois_key_from_numpy(
        {e: {f: np.asarray(getattr(k, f)) for f in fields} for e, k in gk.keys.items()},
        device="cpu")


def _rand(primes, shape, seed):
    p = np.asarray(primes, np.int64)[:, None]
    return (np.random.default_rng(seed).integers(0, 1 << 62, shape) % p).astype(np.uint32)


def _rows(m):
    """The slot permutation of a row rotation by one step: each half left by 1."""
    return np.concatenate([np.roll(m[:HALF], -1), np.roll(m[HALF:], -1)])


def make_pair(method: dict):
    """The same context in both packages (keyswitching `method`), the
    reference's Threefry keys and two ciphertexts, and the port's copies of
    them."""
    jctx = jbfv.make_context(N, T, q_bits=Q_BITS, **method)
    sk = jbfv.keygen_secret(jctx, jrng.new_key(1))
    pk = jbfv.keygen_public(jctx, jrng.new_key(2), sk)
    rk = jbfv.keygen_relin(jctx, jrng.new_key(3), sk)
    gk = jbfv.keygen_galois(jctx, jrng.new_key(4), sk, steps=[1, 2])
    gki = jbfv.keygen_galois(jctx, jrng.new_key(5), sk, steps=[1], inv_form=True)
    sk2 = jbfv.keygen_secret(jctx, jrng.new_key(6))
    swk = jbfv.keygen_switch(jctx, jrng.new_key(7), sk, sk2)
    r = np.random.default_rng(8)
    m1, m2 = r.integers(0, T, N), r.integers(0, T, N)
    ct1 = jbfv.encrypt(jctx, pk, jbfv.encode(jctx, m1), jrng.new_key(9))
    ct2 = jbfv.encrypt(jctx, pk, jbfv.encode(jctx, m2), jrng.new_key(10))
    ks = lambda k: interop.ks_key_from_numpy(np.asarray(k.k0), np.asarray(k.k1), device="cpu")
    sec = lambda s: interop.secret_key_from_numpy(np.asarray(s.s_coeff),
                                                  np.asarray(s.s_ntt_mont_qp), s.hamming_weight,
                                                  device="cpu")
    j = dict(ctx=jctx, sk=sk, sk2=sk2, rk=rk, gk=gk, gki=gki, swk=swk, ct1=ct1, ct2=ct2)
    t = dict(ctx=tbfv.make_context(N, T, q_bits=Q_BITS, device="cpu", **method), sk=sec(sk),
             sk2=sec(sk2), rk=ks(rk), gk=_gk(gk), gki=_gk(gki), swk=ks(swk), ct1=_ct(ct1),
             ct2=_ct(ct2))
    return j, t, m1, m2


@pytest.fixture(scope="module")
def pair():
    return make_pair(dict(ks_type="I"))


def test_context_tables_match(pair):
    j, t, _, _ = pair
    jc, tc = j["ctx"], t["ctx"]
    for f in ("n", "k", "t", "gamma", "mt_bits", "bsk_k", "q_primes", "p_primes", "bsk_primes",
              "ks_type", "alpha", "q_mod_t", "half_t", "gamma_inv_t", "neg_qinv_mt",
              "binv_msk", "msk_half"):
        a, b = getattr(tc, f), getattr(jc, f)
        assert a == b if isinstance(a, (tuple, str)) else int(a) == int(b), f
    for f in ("delta_mont", "gt_qhatinv_mont", "gt_half_qhatinv", "dec_mat_mont", "dec_off",
              "slot_index", "conv_q_mt_mat", "mt_inv_bsk", "q_mod_bsk_mont", "t_mont_qbsk",
              "qinv_bsk", "conv_b_msk_mat", "b_mod_q"):
        np.testing.assert_array_equal(_np(getattr(tc, f)).astype(np.int64),
                                      np.asarray(getattr(jc, f)).astype(np.int64), f)
    for conv in ("conv_q_bsk", "conv_b_q"):
        for f in ("mat_mont", "qhat_inv"):
            _eq(getattr(getattr(tc, conv), f), getattr(getattr(jc, conv), f))
    _eq(tc.conv_q_bsk.mat_mont, jc.conv_tq_bsk.mat_mont)
    for f in ("psi", "tw_mat", "itw_mat", "ipsi_n"):
        _eq(getattr(tc.ntt_t, f), getattr(jc.ntt_t, f))
        _eq(getattr(tc.ntt_bsk, f), getattr(jc.ntt_qbsk.slice_limbs(jc.k, jc.k + jc.bsk_k + 1), f))
        _eq(getattr(tc.ntt_qp, f), getattr(jc.ntt_qp, f))
    assert [d.p_last for d in tc.enc_div] == [int(d.p_last) for d in jc.enc_div]
    assert [lv.groups for lv in tc.ks2] == [lv.groups for lv in jc.ks2]
    # the default chain (no q_bits): tc128's budget of 29-bit primes
    n = 4096
    tt = jparams.plain_modulus_for(n, 20)
    method = dict(ks_type=jc.ks_type, alpha=jc.alpha)
    jd, td = jbfv.make_context(n, tt, **method), tbfv.make_context(n, tt, device="cpu", **method)
    assert (td.q_primes, td.p_primes, td.bsk_primes, td.gamma) == (
        jd.q_primes, jd.p_primes, jd.bsk_primes, jd.gamma)


def test_encode_decode(pair):
    j, t, m1, _ = pair
    v = np.random.default_rng(11).integers(-T // 2, T // 2, N - 3)
    pt = tbfv.encode(t["ctx"], v)
    _eq(pt, jbfv.encode(j["ctx"], v))
    np.testing.assert_array_equal(tbfv.decode(t["ctx"], pt), jbfv.decode(j["ctx"],
                                                                          jbfv.encode(j["ctx"], v)))
    np.testing.assert_array_equal(tbfv.decode_signed(t["ctx"], pt), np.append(v, [0, 0, 0]))
    assert tbfv.decode(t["ctx"], tbfv.encode(t["ctx"], m1)).dtype == np.uint32


def test_drbg_keys_and_encrypt_match(pair):
    j, t, m1, _ = pair
    jc, tc = j["ctx"], t["ctx"]
    jd, td = jrng.new_drbg(b"b" * 32), trng.new_drbg(b"b" * 32)

    def reference():
        sk = jbfv.keygen_secret(jc, jd)
        pk = jbfv.keygen_public(jc, jd, sk)
        return (sk, pk, jbfv.keygen_relin(jc, jd, sk), jbfv.keygen_galois(jc, jd, sk, steps=[1]),
                jbfv.encrypt(jc, pk, jbfv.encode(jc, m1), jd))

    # the reference's chain compiled as one program (the DRBG draws at trace time,
    # in the eager order; exact, so the eager run's keys and ciphertext)
    jsk, jpk, jrk, jgk, jct = jax.jit(reference)()
    tsk = tbfv.keygen_secret(tc, td)
    _eq(tsk.s_coeff.to(torch.int64), np.asarray(jsk.s_coeff).astype(np.int64))
    _eq(tsk.s_ntt_mont_qp, jsk.s_ntt_mont_qp)
    tpk = tbfv.keygen_public(tc, td, tsk)
    _eq(tpk.pk0, jpk.pk0)
    _eq(tpk.pk1, jpk.pk1)
    trk = tbfv.keygen_relin(tc, td, tsk)
    _eq(trk.k0, jrk.k0)
    _eq(trk.k1, jrk.k1)
    tgk = tbfv.keygen_galois(tc, td, tsk, steps=[1])
    for e in jgk.keys:
        _eq(tgk.keys[e].k0, jgk.keys[e].k0)
        _eq(tgk.keys[e].k1, jgk.keys[e].k1)
    _same(tbfv.encrypt(tc, tpk, tbfv.encode(tc, m1), td), jct)


def test_decrypt_and_noise_budget(pair):
    j, t, m1, m2 = pair
    jc, tc = j["ctx"], t["ctx"]
    prod_j = jbfv.multiply(jc, j["ct1"], j["ct2"])
    prod_t = tbfv.multiply(tc, t["ct1"], t["ct2"])
    for name, jct, tct in (("fresh", j["ct1"], t["ct1"]), ("product", prod_j, prod_t)):
        got = tbfv.decrypt(tc, t["sk"], tct)
        _eq(got, jbfv.decrypt(jc, j["sk"], jct))
        nb, nb_ref = tbfv.noise_budget(tc, t["sk"], tct), jbfv.noise_budget(jc, j["sk"], jct)
        assert abs(nb - nb_ref) <= 1e-6 and nb > 0, (name, nb, nb_ref)
    np.testing.assert_array_equal(tbfv.decode(tc, tbfv.decrypt(tc, t["sk"], prod_t)),
                                  m1 * m2 % T)


def test_arithmetic(pair):
    j, t, m1, m2 = pair
    jc, tc = j["ctx"], t["ctx"]
    ja, jb, ta, tb = j["ct1"], j["ct2"], t["ct1"], t["ct2"]
    jp, tp = jbfv.encode(jc, m2), tbfv.encode(tc, m2)
    _same(tbfv.add(tc, ta, tb), jbfv.add(jc, ja, jb))
    _same(tbfv.sub(tc, ta, tb), jbfv.sub(jc, ja, jb))
    _same(tbfv.negate(tc, ta), jbfv.negate(jc, ja))
    _same(tbfv.add_plain(tc, ta, tp), jbfv.add_plain(jc, ja, jp))
    _same(tbfv.sub_plain(tc, ta, tp), jbfv.sub_plain(jc, ja, jp))
    _same(tbfv.multiply_plain(tc, ta, tp), jbfv.multiply_plain(jc, ja, jp))
    _eq(tbfv._plain_lift(tc, tp), jbfv._plain_lift(jc, jp))
    for k in (3, -5, N + 1):
        _same(tbfv.multiply_power_of_x(tc, ta, k), jbfv.multiply_power_of_x(jc, ja, k))
    tn, jn = tbfv.transform_to_ntt(tc, ta), jbfv.transform_to_ntt(jc, ja)
    _same(tn, jn)
    _same(tbfv.transform_from_ntt(tc, tn), jbfv.transform_from_ntt(jc, jn))
    with pytest.raises(terrors.NttDomainError):
        tbfv.multiply_power_of_x(tc, tn, 1)
    with pytest.raises(terrors.NttDomainError):
        tbfv.transform_from_ntt(tc, ta)
    want = {"add": m1 + m2, "sub": m1 - m2, "add_plain": m1 + m2, "multiply_plain": m1 * m2}
    for op, w in want.items():
        out = getattr(tbfv, op)(tc, ta, tb if op in ("add", "sub") else tp)
        np.testing.assert_array_equal(tbfv.decode(tc, tbfv.decrypt(tc, t["sk"], out)), w % T)


def test_behz_helpers_and_multiply(pair):
    j, t, _, _ = pair
    jc, tc = j["ctx"], t["ctx"]
    _eq(tbfv._behz_lift_to_bsk(tc, t["ct1"].c), jbfv._behz_lift_to_bsk(jc, j["ct1"].c))
    bsk = list(jc.bsk_primes)
    u_q, u_b = _rand(jc.q_primes, (3, jc.k, N), 12), _rand(bsk, (3, len(bsk), N), 13)
    _eq(tbfv._behz_scale_floor(tc, tm.u32_to_i32(u_q), tm.u32_to_i32(u_b)),
        jbfv._behz_scale_floor(jc, u_q, u_b))
    w = _rand(bsk, (3, len(bsk), N), 14)
    _eq(tbfv._behz_bsk_to_q(tc, tm.u32_to_i32(w)), jbfv._behz_bsk_to_q(jc, w))
    _same(tbfv.multiply(tc, t["ct1"], t["ct2"]), jbfv.multiply(jc, j["ct1"], j["ct2"]))
    with pytest.raises(terrors.CipherSizeError):
        tbfv.multiply(tc, tbfv.multiply(tc, t["ct1"], t["ct2"]), t["ct1"])


def test_relinearize(pair):
    j, t, m1, m2 = pair
    jc, tc = j["ctx"], t["ctx"]
    out = tbfv.relinearize(tc, tbfv.multiply(tc, t["ct1"], t["ct2"]), t["rk"])
    _same(out, jbfv.relinearize(jc, jbfv.multiply(jc, j["ct1"], j["ct2"]), j["rk"]))
    np.testing.assert_array_equal(tbfv.decode(tc, tbfv.decrypt(tc, t["sk"], out)), m1 * m2 % T)
    with pytest.raises(terrors.CipherSizeError):
        tbfv.relinearize(tc, t["ct1"], t["rk"])


def test_rotations_and_hoisting(pair):
    j, t, m1, _ = pair
    jc, tc, ja, ta = j["ctx"], t["ctx"], j["ct1"], t["ct1"]
    g1, g2 = (tpoly.steps_to_galois_elt(s, N) for s in (1, 2))
    _same(tbfv.apply_galois(tc, ta, t["gk"].keys[g1]), jbfv.apply_galois(jc, ja, j["gk"].keys[g1]))
    _same(tbfv.apply_galois(tc, ta, t["gki"].keys[g1]),
          jbfv.apply_galois(jc, ja, j["gki"].keys[g1]))
    rot3 = tbfv.rotate_rows(tc, ta, t["gk"], 3)
    _same(rot3, jbfv.rotate_rows(jc, ja, j["gk"], 3))
    want3 = _rows(_rows(_rows(m1)))
    np.testing.assert_array_equal(tbfv.decode(tc, tbfv.decrypt(tc, t["sk"], rot3)), want3)
    col = tbfv.rotate_columns(tc, ta, t["gk"])
    _same(col, jbfv.rotate_columns(jc, ja, j["gk"]))
    np.testing.assert_array_equal(tbfv.decode(tc, tbfv.decrypt(tc, t["sk"], col)),
                                  np.concatenate([m1[HALF:], m1[:HALF]]))
    d, d_ref = tbfv.hoist(tc, ta), jbfv.hoist(jc, ja)
    _eq(d, d_ref)
    for key, g in (("gk", g1), ("gk", g2), ("gki", g1)):
        _same(tbfv.rotate_rows_hoisted(tc, ta, d, t[key].keys[g]),
              jbfv.rotate_rows_hoisted(jc, ja, d_ref, j[key].keys[g]))
    with pytest.raises(ValueError):
        tbfv.rotate_rows(tc, ta, tring.GaloisKey({}), 1)


def test_switch_key(pair):
    j, t, m1, _ = pair
    jc, tc = j["ctx"], t["ctx"]
    out = tbfv.switch_key(tc, t["ct1"], t["swk"])
    _same(out, jbfv.switch_key(jc, j["ct1"], j["swk"]))
    np.testing.assert_array_equal(tbfv.decode(tc, tbfv.decrypt(tc, t["sk2"], out)), m1)


def test_seeded_inputs_raise(pair):
    _, t, _, _ = pair
    tc, sk = t["ctx"], t["sk"]
    # seeded keys are made now; a key stripped of its uniform half with no seed
    # to regenerate it from still raises where it is used
    g = trng.new_generator(3, "cpu")
    assert tbfv.keygen_relin(tc, g, sk, a_seed=7).a_seed == 7
    prod = tbfv.multiply(tc, t["ct1"], t["ct2"])
    for fn in (lambda: tbfv.relinearize(tc, prod, dataclasses.replace(t["rk"], k1=None)),
               lambda: tbfv.rotate_rows(tc, t["ct1"], tbfv.GaloisKey(
                   {e: dataclasses.replace(k, k1=None) for e, k in t["gk"].keys.items()}), 1)):
        with pytest.raises(terrors.ParameterError):
            fn()
    with pytest.raises(terrors.ParameterError):
        tbfv.make_context(N, T + 2, q_bits=Q_BITS, device="cpu")
    with pytest.raises(jerrors.ParameterError):
        jbfv.make_context(N, T + 2, q_bits=Q_BITS)


def test_print_parameters_and_defaults(pair, capsys):
    j, t, _, _ = pair
    tbfv.print_parameters(t["ctx"])
    got = capsys.readouterr().out
    jbfv.print_parameters(j["ctx"])
    assert got == capsys.readouterr().out
    import inspect
    for fn in (tbfv.make_context, interop.bfv_ciphertext_from_numpy,
               interop.bfv_plaintext_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    _eq(interop.bfv_plaintext_from_numpy(jbfv.encode(j["ctx"], [1, 2]), device="cpu"),
        jbfv.encode(j["ctx"], [1, 2]))
