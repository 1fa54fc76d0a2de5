"""Port parity for the logic gates over BFV and CKKS, against the JAX package
on the CPU.

BFV at N=256 over three 29-bit primes (t = plain_modulus_for(256, 17),
Method I) and CKKS at N=256 on [29, 28, 28, 28, 28] (scale 2^28, Method I,
the defaults of both packages): the reference's Threefry keys and
ciphertexts are carried over with `interop`, and every gate and plaintext
gate must return the reference's residues bit for bit and decrypt to its
truth table (CKKS within 1e-2)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import bfv as jbfv  # noqa: E402
from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import logic as jlogic  # noqa: E402
from heongpu_tpu.utils import params as jparams  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import bfv as tbfv  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import logic as tlogic  # noqa: E402

torch.set_num_threads(2)

N = 256
BITS_A = np.array([0, 0, 1, 1])
BITS_B = np.array([0, 1, 0, 1])
TRUTH = {"and": [0, 0, 0, 1], "or": [0, 1, 1, 1], "xor": [0, 1, 1, 0],
         "nand": [1, 1, 1, 0], "nor": [1, 0, 0, 0], "xnor": [1, 0, 0, 1]}


def _eq(got, want):
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))


def _ks(k):
    return interop.ks_key_from_numpy(np.asarray(k.k0), np.asarray(k.k1), device="cpu")


def _sk(s):
    return interop.secret_key_from_numpy(np.asarray(s.s_coeff), np.asarray(s.s_ntt_mont_qp),
                                         s.hamming_weight, device="cpu")


@pytest.fixture(scope="module")
def bfv_pair():
    t = jparams.plain_modulus_for(N, 17)
    jctx = jbfv.make_context(N, t, q_bits=[29, 29, 29])
    sk = jbfv.keygen_secret(jctx, jrng.new_key(1))
    pk = jbfv.keygen_public(jctx, jrng.new_key(2), sk)
    rk = jbfv.keygen_relin(jctx, jrng.new_key(3), sk)
    a, b = np.resize(BITS_A, N), np.resize(BITS_B, N)
    ca = jbfv.encrypt(jctx, pk, jbfv.encode(jctx, a), jrng.new_key(4))
    cb = jbfv.encrypt(jctx, pk, jbfv.encode(jctx, b), jrng.new_key(5))
    ct = lambda c: interop.bfv_ciphertext_from_numpy(np.asarray(c.c), c.size, c.in_ntt,
                                                     device="cpu")
    j = dict(ctx=jctx, rk=rk, a=ca, b=cb, pt=jbfv.encode(jctx, b))
    tctx = tbfv.make_context(N, t, q_bits=[29, 29, 29], device="cpu")
    tt = dict(ctx=tctx, sk=_sk(sk), rk=_ks(rk), a=ct(ca), b=ct(cb), pt=tbfv.encode(tctx, b))
    return j, tt


def _bfv_check(tt, out, want, name):
    got = tbfv.decode(tt["ctx"], tbfv.decrypt(tt["ctx"], tt["sk"], out))[:4]
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("gate", sorted(TRUTH))
def test_bfv_gates(bfv_pair, gate):
    j, t = bfv_pair
    out = getattr(tlogic, f"bfv_{gate}")(t["ctx"], t["a"], t["b"], t["rk"])
    want = getattr(jlogic, f"bfv_{gate}")(j["ctx"], j["a"], j["b"], j["rk"])
    assert (out.size, out.in_ntt) == (want.size, want.in_ntt)
    _eq(out.c, want.c)
    _bfv_check(t, out, TRUTH[gate], gate)


def test_bfv_not_and_plain_gates(bfv_pair):
    j, t = bfv_pair
    out = tlogic.bfv_not(t["ctx"], t["a"])
    _eq(out.c, jlogic.bfv_not(j["ctx"], j["a"]).c)
    _bfv_check(t, out, 1 - BITS_A, "not")
    for gate in ("and", "or", "xor"):
        out = getattr(tlogic, f"bfv_{gate}_plain")(t["ctx"], t["a"], t["pt"])
        _eq(out.c, getattr(jlogic, f"bfv_{gate}_plain")(j["ctx"], j["a"], j["pt"]).c)
        _bfv_check(t, out, TRUTH[gate], f"{gate}_plain")


@pytest.fixture(scope="module")
def ckks_pair():
    q_bits = [29, 28, 28, 28, 28]
    jctx = jckks.make_context(N, q_bits, scale_bits=28)
    sk = jckks.keygen_secret(jctx, jrng.new_key(6))
    pk = jckks.keygen_public(jctx, jrng.new_key(7), sk)
    rk = jckks.keygen_relin(jctx, jrng.new_key(8), sk)
    enc = lambda bits, k: jckks.encrypt(
        jctx, pk, jckks.encode_host(jctx, np.resize(bits, N // 2).astype(np.float64)),
        jrng.new_key(k))
    ca, cb = enc(BITS_A, 9), enc(BITS_B, 10)
    ct = lambda c: interop.ciphertext_from_numpy(np.asarray(c.c), c.size, c.level, c.scale,
                                                 device="cpu")
    j = dict(ctx=jctx, rk=rk, a=ca, b=cb)
    t = dict(ctx=tckks.make_context(N, q_bits, scale_bits=28, device="cpu"), sk=_sk(sk),
             rk=_ks(rk), a=ct(ca), b=ct(cb))
    return j, t


def _same_ckks(got, want):
    assert (got.size, got.level, got.scale) == (want.size, want.level, want.scale)
    _eq(got.c, want.c)


def _ckks_check(t, out, want, name):
    got = tckks.decode(t["ctx"], tckks.decrypt(t["ctx"], t["sk"], out))[:4].real
    assert np.abs(got - want).max() < 1e-2, (name, got)


@pytest.mark.parametrize("gate", sorted(TRUTH) + ["not"])
def test_ckks_gates(ckks_pair, gate):
    j, t = ckks_pair
    out = getattr(tlogic, f"ckks_{gate}")(t["ctx"], t["a"], t["b"], t["rk"])
    _same_ckks(out, getattr(jlogic, f"ckks_{gate}")(j["ctx"], j["a"], j["b"], j["rk"]))
    _ckks_check(t, out, 1 - BITS_A if gate == "not" else TRUTH[gate], gate)


def test_ckks_align_across_levels(ckks_pair):
    """Operands at different levels are brought together (_ckks_align), and
    _align_to lands a ciphertext on an exact (level, scale)."""
    j, t = ckks_pair
    jc, tc = j["ctx"], t["ctx"]
    ja, ta = jckks.mod_drop(jc, j["a"]), tckks.mod_drop(tc, t["a"])
    out = tlogic.ckks_and(tc, ta, t["b"], t["rk"])
    _same_ckks(out, jlogic.ckks_and(jc, ja, j["b"], j["rk"]))
    _ckks_check(t, out, TRUTH["and"], "and across levels")
    tl, jl = tlogic._ckks_align(tc, t["b"], ta), jlogic._ckks_align(jc, j["b"], ja)
    for g, w in zip(tl, jl):
        _same_ckks(g, w)
    scale = out.scale * 1.5
    _same_ckks(tlogic._align_to(tc, t["a"], 2, scale), jlogic._align_to(jc, j["a"], 2, scale))
