"""Port parity for Method-I keyswitching, against the JAX package on the CPU.

The ringkit phases (digit broadcast, hoisted digits, the key MAC, the ÷P
finish, the whole keyswitch) on random residues at N=256 over four Q primes
and one special prime; the CKKS context with no ks_type (Method I in both
packages) with its primes, digits and DRBG keys; and the CKKS Method-I ops
(relinearize, rotate, conjugate, hoisted rotations with normal and
inverse-form keys, switch_key) at levels 0 and 1 with keys made at level 0,
the reference's Threefry keys and ciphertexts carried over with `interop`.
Every residue must be bit-identical.  Also the host copies the BFV slice
needs (params, nt, errors)."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import ringkit as jring  # noqa: E402
from heongpu_tpu.ops import ntt as jntt  # noqa: E402
from heongpu_tpu.ops import rns as jrns  # noqa: E402
from heongpu_tpu.utils import errors as jerrors  # noqa: E402
from heongpu_tpu.utils import nt as jnt  # noqa: E402
from heongpu_tpu.utils import params as jparams  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ringkit as tring  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.ops import polyops as tpoly  # noqa: E402
from heongpu_tpu_torch.ops import rns as trns  # noqa: E402
from heongpu_tpu_torch.utils import errors as terrors  # noqa: E402
from heongpu_tpu_torch.utils import nt as tnt  # noqa: E402
from heongpu_tpu_torch.utils import params as tparams  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

N, Q_BITS = 256, [29] * 4
Z = np.random.default_rng(5).uniform(-1, 1, N // 2) + 1j * np.random.default_rng(6).uniform(
    -1, 1, N // 2)


def _eq(got, want):
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))


def _rand(primes, shape, seed):
    p = np.asarray(primes, np.int64)[:, None]       # limbs on axis -2
    return (np.random.default_rng(seed).integers(0, 1 << 62, shape) % p).astype(np.uint32)


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------

def test_host_copies_match():
    for n in (1024, 4096, 32768):
        for lvl in ("tc128", "tc192", "none"):
            assert tparams.default_coeff_modulus(n, lvl) == jparams.default_coeff_modulus(n, lvl)
    for n, bits in ((256, 20), (1024, 17), (32768, 20)):
        assert tparams.plain_modulus_for(n, bits) == jparams.plain_modulus_for(n, bits)
    primes = jnt.generate_ntt_primes(29, 4, 256)
    assert tnt.crt_garner_coeffs(primes) == jnt.crt_garner_coeffs(primes)
    Q = int(np.prod([float(q) for q in primes]))
    for x in (0, 1, -1, 12345678901234567, -(Q // 3)):
        res = [x % q for q in primes]
        assert tnt.crt_compose(res, primes) == jnt.crt_compose(res, primes)
    for want in (False, True):
        with pytest.raises(terrors.NttDomainError) as got:
            terrors.check_ntt_domain(not want, want, "op")
        with pytest.raises(jerrors.NttDomainError) as ref:
            jerrors.check_ntt_domain(not want, want, "op")
        assert str(got.value) == str(ref.value)
    assert issubclass(terrors.NttDomainError, terrors.HEError)


# ---------------------------------------------------------------------------
# ringkit's Method-I phases on random residues
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ring_tables():
    q = jnt.generate_ntt_primes(29, 4, N)
    p = jnt.generate_ntt_primes(30, 1, N, exclude=set(q))
    j = dict(base_qp=jrns.Base.build(q + p), ntt_qp=jntt.build_ntt_tables(q + p, N),
             ntt_q=jntt.build_ntt_tables(q, N), div_p=jrns.DivRoundLastq.build(q, p[0]))
    t = dict(base_qp=trns.Base.build(q + p, "cpu"), ntt_qp=tntt.build_ntt_tables(q + p, N, "cpu"),
             ntt_q=tntt.build_ntt_tables(q, N, "cpu"),
             div_p=trns.DivRoundLastq.build(q, p[0], "cpu"))
    return q, p, j, t


def test_decompose_and_exact_sum(ring_tables):
    q, p, j, t = ring_tables
    x = _rand(q, (2, 4, N), 1)
    _eq(trns.decompose_to_base(tm.u32_to_i32(x), t["base_qp"]),
        jrns.decompose_to_base(x, j["base_qp"]))
    words = np.random.default_rng(2).integers(0, 1 << 32, (29, 3, N), dtype=np.uint64)
    words = words.astype(np.uint32)
    for axis in (0, 1, -2):
        hi, lo = jrns.sum_u32_axis64(words, axis)
        want = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(np.int64)
        np.testing.assert_array_equal(trns.sum_u32_axis64(tm.u32_to_i32(words), axis).numpy(),
                                      want)


@pytest.mark.parametrize("in_ntt", [False, True])
def test_keyswitch_core_phases(ring_tables, in_ntt):
    q, p, j, t = ring_tables
    qp = q + p
    poly = _rand(q, (4, N), 3 + in_ntt)
    k0, k1 = (np.stack([_rand(qp, (5, N), 10 * h + d) for d in range(4)]) for h in (1, 2))
    tp, tk0, tk1 = (tm.u32_to_i32(a) for a in (poly, k0, k1))
    d_ref = jring.hoist_digits(poly, j["base_qp"], j["ntt_qp"], in_ntt, j["ntt_q"])
    d = tring.hoist_digits(tp, t["base_qp"], t["ntt_qp"], in_ntt, t["ntt_q"])
    _eq(d, d_ref)
    acc_ref = jring.hoisted_mac(np.asarray(d_ref), k0, k1, j["base_qp"])
    acc = tring.hoisted_mac(d, tk0, tk1, t["base_qp"])
    _eq(acc, np.stack([np.asarray(a) for a in acc_ref]))
    for out_ntt in (False, True):
        _eq(tring.ks_finish(acc, t["ntt_qp"], t["div_p"], out_ntt, t["ntt_q"]),
            jring.ks_finish(np.stack([np.asarray(a) for a in acc_ref]), j["ntt_qp"],
                            j["div_p"], out_ntt, j["ntt_q"]))
    got = tring.keyswitch_core(tp, tk0, tk1, t["base_qp"], t["ntt_qp"], t["div_p"], in_ntt,
                               True, t["ntt_q"])
    want = jring.keyswitch_core(poly, k0, k1, j["base_qp"], j["ntt_qp"], j["div_p"], in_ntt,
                                True, j["ntt_q"])
    _eq(torch.stack(got), np.stack([np.asarray(w) for w in want]))
    for lvl in (4, 3, 1):
        _eq(tring.slice_key_level(tk0, lvl, 4), jring.slice_key_level(k0, lvl, 4))


def test_stripped_key_raises():
    kk = tring.KSKey(torch.zeros((1, 2, 4), dtype=torch.int32), None)
    with pytest.raises(terrors.ParameterError):
        tring.ensure_k1(None, kk)     # no seed: raises before it reads the ring
    assert tring.ensure_k1(None, tring.KSKey(kk.k0, kk.k0)) is kk.k0


# ---------------------------------------------------------------------------
# CKKS: the default context is Method I in both packages
# ---------------------------------------------------------------------------

def test_default_context_is_method_one():
    jctx = jckks.make_context(N, Q_BITS)
    tctx = tckks.make_context(N, Q_BITS, device="cpu")
    assert (tctx.ks_type, tctx.alpha, tctx.ks2) == (jctx.ks_type, jctx.alpha, jctx.ks2) == (
        "I", 1, ())
    assert tctx.q_primes == jctx.q_primes and tctx.p_primes == jctx.p_primes
    assert tckks._groups(tctx) is None and jckks._groups(jctx) is None
    def reference():
        sk = jckks.keygen_secret(jctx, jrng.new_drbg(b"m" * 32))
        return sk, jckks.keygen_relin(jctx, jrng.new_drbg(b"r" * 32), sk)

    # the reference's keygens compiled as one program (the DRBG draws at trace time)
    jsk, jrk = jax.jit(reference)()
    tsk = tckks.keygen_secret(tctx, trng.new_drbg(b"m" * 32))
    _eq(tsk.s_ntt_mont_qp, jsk.s_ntt_mont_qp)
    trk = tckks.keygen_relin(tctx, trng.new_drbg(b"r" * 32), tsk)
    assert tuple(trk.k0.shape) == np.asarray(jrk.k0).shape == (4, 5, N)   # one digit per Q prime
    _eq(trk.k0, jrk.k0)
    _eq(trk.k1, jrk.k1)
    # p_count as in the reference: more special primes than the one digit needs
    j3, t3 = jckks.make_context(N, Q_BITS, p_count=3), tckks.make_context(N, Q_BITS, p_count=3,
                                                                          device="cpu")
    assert (t3.alpha, t3.p_primes) == (j3.alpha, j3.p_primes) and len(t3.p_primes) == 3
    with pytest.raises(terrors.ParameterError):
        tckks.make_context(N, Q_BITS, ks_type="III", device="cpu")


# ---------------------------------------------------------------------------
# CKKS Method-I ops against the reference, keys carried over
# ---------------------------------------------------------------------------

def _gk(gk):
    fields = ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt", "galois_elt",
              "inv_form")
    return interop.galois_key_from_numpy(
        {e: {f: np.asarray(getattr(k, f)) for f in fields} for e, k in gk.keys.items()},
        device="cpu")


def _ct(c):
    return interop.ciphertext_from_numpy(np.asarray(c.c), c.size, c.level, c.scale, device="cpu")


@pytest.fixture(scope="module")
def method1():
    jctx = jckks.make_context(N, Q_BITS)

    def keys():
        sk = jckks.keygen_secret(jctx, jrng.new_key(41))
        pk = jckks.keygen_public(jctx, jrng.new_key(42), sk)
        return (jckks.keygen_relin(jctx, jrng.new_key(43), sk),
                jckks.keygen_galois(jctx, jrng.new_key(44), sk, steps=[1, 2]),
                jckks.keygen_galois(jctx, jrng.new_key(45), sk, steps=[1], inv_form=True),
                jckks.keygen_switch(jctx, jrng.new_key(47), sk,
                                    jckks.keygen_secret(jctx, jrng.new_key(46))),
                jckks.encrypt(jctx, pk, jckks.encode_host(jctx, Z), jrng.new_key(48)))

    rk, gk, gki, swk, ct = jax.jit(keys)()   # one program: exact, the eager ops' keys
    ks = lambda k: interop.ks_key_from_numpy(np.asarray(k.k0), np.asarray(k.k1), device="cpu")
    j = dict(ctx=jctx, rk=rk, gk=gk, gki=gki, swk=swk, ct=ct)
    t = dict(ctx=tckks.make_context(N, Q_BITS, device="cpu"), rk=ks(rk), gk=_gk(gk),
             gki=_gk(gki), swk=ks(swk), ct=_ct(ct))
    return j, t


def _same(got, want):
    assert (got.size, got.level, got.scale) == (want.size, want.level, want.scale)
    _eq(got.c, want.c)


@pytest.mark.parametrize("level", [0, 1])
def test_ckks_method1_ops(method1, level):
    j, t = method1
    jc, tc = j["ctx"], t["ctx"]
    g1 = tpoly.steps_to_galois_elt(1, N)
    gs = [tpoly.steps_to_galois_elt(step, N) for step in (1, 2)]

    def reference(ct, rk, gk, gki, swk):
        """The reference's side, compiled as one program (exact: its eager
        ops' residues)."""
        ja = jckks.mod_drop(jc, ct, level) if level else ct
        d_ref = jckks.hoist(jc, ja)
        return dict(relin=jckks.relinearize(jc, jckks.multiply(jc, ja, ja), rk),
                    rotate=[jckks.rotate(jc, ja, gk, step) for step in (1, 3)],
                    conj=jckks.conjugate(jc, ja, gk), switch=jckks.switch_key(jc, ja, swk),
                    hoist=d_ref,
                    hoisted=[jckks.rotate_hoisted(jc, ja, d_ref, gk.keys[g]) for g in gs],
                    hoisted_inv=jckks.rotate_hoisted(jc, ja, d_ref, gki.keys[g1]),
                    rotate_inv=jckks.rotate(jc, ja, gki, 1))

    ref = jax.jit(reference)(j["ct"], j["rk"], j["gk"], j["gki"], j["swk"])
    ta = tckks.mod_drop(tc, t["ct"], level) if level else t["ct"]
    _same(tckks.relinearize(tc, tckks.multiply(tc, ta, ta), t["rk"]), ref["relin"])
    for step, want in zip((1, 3), ref["rotate"]):
        _same(tckks.rotate(tc, ta, t["gk"], step), want)
    _same(tckks.conjugate(tc, ta, t["gk"]), ref["conj"])
    _same(tckks.switch_key(tc, ta, t["swk"]), ref["switch"])
    d = tckks.hoist(tc, ta)
    _eq(d, ref["hoist"])
    for g, want in zip(gs, ref["hoisted"]):
        _same(tckks.rotate_hoisted(tc, ta, d, t["gk"].keys[g]), want)
    _same(tckks.rotate_hoisted(tc, ta, d, t["gki"].keys[g1]), ref["hoisted_inv"])
    _same(tckks.rotate(tc, ta, t["gki"], 1), ref["rotate_inv"])


def test_key_from_a_deeper_level_raises(method1):
    j, t = method1
    jc, tc = j["ctx"], t["ctx"]
    jsk = jckks.keygen_secret(jc, jrng.new_key(51))
    tsk = tckks.keygen_secret(tc, trng.new_generator(51, "cpu"))
    jrk = jckks.keygen_relin(jc, jrng.new_key(52), jsk, level=1)
    trk = tckks.keygen_relin(tc, trng.new_generator(52, "cpu"), tsk, level=1)
    assert tuple(trk.k0.shape) == np.asarray(jrk.k0).shape == (3, 4, N)   # 3 digits, 3 + 1 limbs
    with pytest.raises(jerrors.LevelMismatchError) as ref:
        jckks.relinearize(jc, jckks.multiply(jc, j["ct"], j["ct"]), jrk)
    with pytest.raises(terrors.LevelMismatchError) as got:
        tckks.relinearize(tc, tckks.multiply(tc, t["ct"], t["ct"]), trk)
    assert str(got.value) == str(ref.value)
    # at level 1 the deeper key serves
    ta = tckks.mod_drop(tc, t["ct"])
    out = tckks.relinearize(tc, tckks.multiply(tc, ta, ta), trk)
    assert out.size == 2 and out.level == 1
