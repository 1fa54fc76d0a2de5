"""Port parity for BGV against the JAX package on the CPU.

At N=256 over four 29-bit Q primes (tests/test_bgv.py's chain), t =
plain_modulus_for(256, 20), keys and ciphertexts from one DRBG seed on both
sides: the context tables (primes, slot map, every t-exact division's
constants), the keys, encryption, decryption, the noise budget (the
reference's fractional CRT sum: against a big-integer CRT, within its
rounding inside the sum's window and a floor below it, and within 1e-4
bits of the reference's inside the window: see _check_budget), the arithmetic, multiply and
relinearize, mod_switch at levels 0-2 with the factor bookkeeping, the
rotations (a key at levels 0 and 1, a composed step and conjugation at
level 0, an inverse-form key at level 1), a switch key, and print_parameters.  Every residue and factor must be equal: tolerance 0."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from heongpu_tpu.models import bgv as jbgv  # noqa: E402
from heongpu_tpu.utils import params as jparams  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import bgv as tbgv  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.utils import errors as terrors  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

# the reference's ops, each compiled whole (eager, every primitive would compile
# on its own at each level's shapes)
J = {name: jax.jit(getattr(jbgv, name)) for name in (
    "add", "sub", "negate", "add_plain", "sub_plain", "multiply_plain", "multiply",
    "relinearize", "mod_switch", "apply_galois", "decrypt")}
J["rotate_rows"] = jax.jit(jbgv.rotate_rows, static_argnums=3)

N, Q_BITS = 256, [29] * 4
T = jparams.plain_modulus_for(N, 20)
HALF = N // 2


def _np(t):
    return interop.to_numpy(t)


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _same(got, want):
    assert (got.size, got.level, got.factor) == (want.size, want.level, want.factor)
    _eq(got.c, want.c)


def _rows(m, s=1):
    return np.concatenate([np.roll(m[:HALF], -s), np.roll(m[HALF:], -s)])


@pytest.fixture(scope="module")
def pair():
    """Both packages' contexts, and keys and two ciphertexts drawn from one
    DRBG seed on each side (so equal, held in test_keys_and_encrypt_match)."""
    jc = jbgv.make_context(N, T, q_bits=Q_BITS)
    tc = tbgv.make_context(N, T, q_bits=Q_BITS, device="cpu")
    out = {}
    for name, mod, ctx, d in (("j", jbgv, jc, jrng.new_drbg(b"g" * 32)),
                              ("t", tbgv, tc, trng.new_drbg(b"g" * 32))):
        sk = mod.keygen_secret(ctx, d)
        pk = mod.keygen_public(ctx, d, sk)
        rk = mod.keygen_relin(ctx, d, sk)
        gk = mod.keygen_galois(ctx, d, sk, steps=[1, 2])
        gki = mod.keygen_galois(ctx, d, sk, steps=[1], inv_form=True)
        r = np.random.default_rng(8)
        m1, m2 = r.integers(0, T, N), r.integers(0, T, N)
        ct1 = mod.encrypt(ctx, pk, mod.encode(ctx, m1), d)
        out[name] = dict(ctx=ctx, sk=sk, pk=pk, rk=rk, gk=gk, gki=gki, ct1=ct1)
    # the second ciphertext made by the port and carried over (encryption is
    # held on the first)
    ct2 = tbgv.encrypt(tc, out["t"]["pk"], tbgv.encode(tc, m2), trng.new_drbg(b"h" * 32))
    out["t"]["ct2"] = ct2
    out["j"]["ct2"] = jbgv.Ciphertext(jax.numpy.asarray(_np(ct2.c)), 2, 0, 1)
    return out["j"], out["t"], m1, m2


def test_context_tables_match(pair):
    j, t, _, _ = pair
    jc, tc = j["ctx"], t["ctx"]
    for f in ("n", "logn", "k", "t", "q_primes", "p_primes", "sec_level", "p_inv_t"):
        assert getattr(tc, f) == getattr(jc, f), f
    _eq(tc.slot_index.to(torch.int32), np.asarray(jc.slot_index))
    for f in ("psi", "tw_mat", "itw_mat", "ipsi_n"):
        _eq(getattr(tc.ntt_qp, f), getattr(jc.ntt_qp, f))
        _eq(getattr(tc.ntt_t, f), getattr(jc.ntt_t, f))
    stages = [(tc.enc_div.stages, jc.enc_div), (tc.div_p_lvl, jc.div_p_lvl),
              (tc.mod_sw, jc.mod_sw)]
    for ts, js in stages:
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            assert (a.p_last, a.half, a.neg_tinv) == (int(b.p_last), int(b.qlast_half),
                                                     int(b.neg_tinv))
            _eq(a.qbase.p, b.qbase.p)
            _eq(a.t_mod, b.t_mod)
            _eq(a.pinv_mod, b.qlast_inv)
    assert tc.enc_div.exact_t and all(s.chain.exact_t for s in tc.div_p_lvl + tc.mod_sw)


def test_keys_and_encrypt_match(pair):
    j, t, _, _ = pair
    _eq(t["sk"].s_ntt_mont_qp, j["sk"].s_ntt_mont_qp)
    for a, b in ((t["pk"].pk0, j["pk"].pk0), (t["pk"].pk1, j["pk"].pk1),
                 (t["rk"].k0, j["rk"].k0), (t["rk"].k1, j["rk"].k1)):
        _eq(a, b)
    for name in ("gk", "gki"):
        assert set(t[name].keys) == set(j[name].keys)
        for e, k in t[name].keys.items():
            jk = j[name].keys[e]
            _eq(k.k0, jk.k0)
            _eq(k.k1, jk.k1)
            assert (k.galois_elt, k.inv_form) == (jk.galois_elt, jk.inv_form)
    _same(t["ct1"], j["ct1"])


def _exact_budget(tc, sk, ct):
    """log2(Q / 2 max|phase|) by a big-integer CRT of the port's phase."""
    primes = [int(q) for q in tc.q_primes[:tc.active(ct.level)]]
    res = _np(tbgv._phase(tc, sk, ct)).astype(object)
    Q = int(np.prod(np.array(primes, dtype=object)))
    v = sum(res[i] * ((Q // q) * pow(Q // q, -1, q)) for i, q in enumerate(primes)) % Q
    big = max(abs(int(x) - Q) if x > Q // 2 else int(x) for x in v)
    return math.log2(Q) - 1 - math.log2(big)


def _check_budget(tc, sk, ct):
    """The noise budget reads the fractional CRT sum, as the reference's
    does.  Where the exact budget is below 40 bits (a phase above Q·2^-41,
    inside the sum's window of about Q·2^-44) it is within 2^(exact - 46)
    bits of it: the float64 sum's rounding, about Q·2^-52, against the
    phase.  Below the window it reads a floor of at least 40 bits and no
    more than the exact budget."""
    nb, exact = tbgv.noise_budget(tc, sk, ct), _exact_budget(tc, sk, ct)
    if exact < 40:
        assert abs(nb - exact) <= 2.0 ** (exact - 46), (nb, exact)
    else:
        assert 40 <= nb <= exact + 2.0 ** -6, (nb, exact)
    return nb


def test_decrypt_and_noise_budget(pair):
    """Decryption bit for bit.  The noise budget (_check_budget) for a fresh
    ciphertext, whose phase lies below the fractional sum's window: the
    port and the reference both read a floor there (the reference 59 bits
    on this chain, the port about 50; the exact budget is higher).  For a
    phase of about Q·2^-20, inside the window, the port is within 1e-4 bits
    of the reference (which returns float32, whose step at 100 is 7.6e-6)."""
    j, t, m1, m2 = pair
    jc, tc = j["ctx"], t["ctx"]
    for c, m in (("ct1", m1), ("ct2", m2)):
        dec = tbgv.decrypt(tc, t["sk"], t[c])
        _eq(dec, J["decrypt"](jc, j["sk"], j[c]))
        np.testing.assert_array_equal(tbgv.decode(tc, dec), m.astype(np.uint32))
        assert _check_budget(tc, t["sk"], t[c]) < _exact_budget(tc, t["sk"], t[c]) - 1
        assert jbgv.noise_budget(jc, j["sk"], j[c]) >= 43
    # a phase of about Q·2^-20: c0 plus a large constant, the same on both sides
    Q = int(np.prod(np.array(tc.q_primes, dtype=object)))
    big = np.array([(Q >> 20) % q for q in tc.q_primes], np.uint64)[:, None]
    c0 = ((np.asarray(j["ct1"].c[0]).astype(np.uint64) + big)
          % np.array(tc.q_primes, np.uint64)[:, None]).astype(np.uint32)
    c = np.stack([c0, np.asarray(j["ct1"].c[1])])
    jct = jbgv.Ciphertext(jbgv.jnp.asarray(c), 2, 0, 1)
    tct = interop.bgv_ciphertext_from_numpy(c, 2, 0, 1, device="cpu")
    nb = _check_budget(tc, t["sk"], tct)
    assert abs(nb - jbgv.noise_budget(jc, j["sk"], jct)) < 1e-4 and 18 < nb < 20
    v = np.random.default_rng(11).integers(0, T, N - 3)
    _eq(tbgv.encode(tc, v), jbgv.encode(jc, v))


def test_arithmetic(pair):
    j, t, m1, m2 = pair
    jc, tc = j["ctx"], t["ctx"]
    p2t, p2j = tbgv.encode(tc, m2), jbgv.encode(jc, m2)
    for name in ("add", "sub"):
        _same(getattr(tbgv, name)(tc, t["ct1"], t["ct2"]),
              J[name](jc, j["ct1"], j["ct2"]))
    _same(tbgv.negate(tc, t["ct1"]), J["negate"](jc, j["ct1"]))
    for name in ("add_plain", "sub_plain", "multiply_plain"):
        _same(getattr(tbgv, name)(tc, t["ct1"], p2t), J[name](jc, j["ct1"], p2j))
    prod_t = tbgv.multiply(tc, t["ct1"], t["ct2"])
    prod_j = J["multiply"](jc, j["ct1"], j["ct2"])
    _same(prod_t, prod_j)
    _eq(tbgv.decrypt(tc, t["sk"], prod_t), J["decrypt"](jc, j["sk"], prod_j))
    rel = tbgv.relinearize(tc, prod_t, t["rk"])
    _same(rel, J["relinearize"](jc, prod_j, j["rk"]))
    np.testing.assert_array_equal(tbgv.decode(tc, tbgv.decrypt(tc, t["sk"], rel)),
                                  (m1 * m2 % T).astype(np.uint32))
    _check_budget(tc, t["sk"], rel)
    with pytest.raises(terrors.ScaleMismatchError):
        tbgv.add(tc, tbgv.mod_switch(tc, t["ct1"]),
                 tbgv.Ciphertext(t["ct2"].c[:, :3], 2, 1, 1))


def test_mod_switch_levels_0_to_2(pair):
    """At levels 0, 1 and 2: multiply -> relinearize, decryption, add_plain
    and multiply_plain with the factor, then mod_switch of both operands; a
    mod switch of a relinearized product; mod_switch at the last limb
    raises."""
    j, t, m1, m2 = pair
    jc, tc = j["ctx"], t["ctx"]
    a_t, a_j, b_t, b_j = t["ct1"], j["ct1"], t["ct2"], j["ct2"]
    want = m1 * m2 % T
    for level in range(3):
        assert a_t.level == level
        rel_t = tbgv.relinearize(tc, tbgv.multiply(tc, a_t, b_t), t["rk"])
        rel_j = J["relinearize"](jc, J["multiply"](jc, a_j, b_j), j["rk"])
        _same(rel_t, rel_j)
        dec = tbgv.decrypt(tc, t["sk"], rel_t)
        _eq(dec, J["decrypt"](jc, j["sk"], rel_j))
        np.testing.assert_array_equal(tbgv.decode(tc, dec), want.astype(np.uint32))
        _check_budget(tc, t["sk"], rel_t)
        pt, pj = tbgv.encode(tc, m1), jbgv.encode(jc, m1)
        _same(tbgv.add_plain(tc, a_t, pt), J["add_plain"](jc, a_j, pj))
        _same(tbgv.multiply_plain(tc, a_t, pt), J["multiply_plain"](jc, a_j, pj))
        a_t, a_j = tbgv.mod_switch(tc, a_t), J["mod_switch"](jc, a_j)
        b_t, b_j = tbgv.mod_switch(tc, b_t), J["mod_switch"](jc, b_j)
        _same(a_t, a_j)
        _same(b_t, b_j)
    _same(tbgv.mod_switch(tc, tbgv.relinearize(tc, tbgv.multiply(tc, t["ct1"], t["ct2"]),
                                               t["rk"])),
          J["mod_switch"](jc, J["relinearize"](jc, J["multiply"](jc, j["ct1"], j["ct2"]),
                                               j["rk"])))
    with pytest.raises(terrors.LevelMismatchError):
        tbgv.mod_switch(tc, a_t)


def test_rotations_and_switch_key(pair):
    j, t, m1, _ = pair
    jc, tc = j["ctx"], t["ctx"]
    a_t, a_j = t["ct1"], j["ct1"]
    g1 = jbgv.polyops.steps_to_galois_elt(1, N)
    for level in range(2):
        out = tbgv.apply_galois(tc, a_t, t["gk"].keys[g1])
        _same(out, J["apply_galois"](jc, a_j, j["gk"].keys[g1]))
        np.testing.assert_array_equal(tbgv.decode(tc, tbgv.decrypt(tc, t["sk"], out)),
                                      _rows(m1).astype(np.uint32))
        if level == 0:
            r3 = tbgv.rotate_rows(tc, a_t, t["gk"], 3)
            _same(r3, J["rotate_rows"](jc, a_j, j["gk"], 3))
            np.testing.assert_array_equal(tbgv.decode(tc, tbgv.decrypt(tc, t["sk"], r3)),
                                          _rows(m1, 3).astype(np.uint32))
            conj = tbgv.apply_galois(tc, a_t, t["gk"].keys["conj"])
            _same(conj, J["apply_galois"](jc, a_j, j["gk"].keys["conj"]))
            a_t, a_j = tbgv.mod_switch(tc, a_t), J["mod_switch"](jc, a_j)
    # an inverse-form key at level 1 (the key sliced to the level basis)
    inv = tbgv.apply_galois(tc, a_t, t["gki"].keys[g1])
    _same(inv, J["apply_galois"](jc, a_j, j["gki"].keys[g1]))
    np.testing.assert_array_equal(tbgv.decode(tc, tbgv.decrypt(tc, t["sk"], inv)),
                                  _rows(m1).astype(np.uint32))
    # a switch key moves a ciphertext to another secret through the same keyswitch
    sk2 = tbgv.keygen_secret(tc, trng.new_drbg(b"s" * 32))
    swk = tbgv.keygen_switch(tc, trng.new_drbg(b"w" * 32), t["sk"], sk2)
    d0, d1 = tbgv._ks(tc, t["ct1"].c[1], swk, 0)
    moved = tbgv.Ciphertext(torch.stack([tm.add_mod(t["ct1"].c[0], d0, tc.base_q.col()), d1]),
                            2, 0, 1)
    np.testing.assert_array_equal(tbgv.decode(tc, tbgv.decrypt(tc, sk2, moved)),
                                  m1.astype(np.uint32))


def test_print_parameters_and_errors(pair, capsys):
    j, t, _, _ = pair
    tbgv.print_parameters(t["ctx"])
    got = capsys.readouterr().out
    jbgv.print_parameters(j["ctx"])
    assert got == capsys.readouterr().out
    with pytest.raises(terrors.ParameterError):
        tbgv.make_context(N, T + 2, q_bits=Q_BITS, device="cpu")
    with pytest.raises(terrors.ParameterError):
        tbgv.encode(t["ctx"], np.zeros(N + 1))
