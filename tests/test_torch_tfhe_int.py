"""Port parity for huint/hint arithmetic over TFHE gate bootstrapping at
lwe_n=16 (a test-only chain length; everything else is STD128).

The reference's Threefry keys and huint4 ciphertexts are carried over with
`interop`; add and sub must give bit-identical sum bits and carry/borrow
ciphertexts (variances to a relative 1e-12) and decrypt to (x ± y) mod 2^W.
The other integer operations run on the port's own keys, with both key
kinds, and must decrypt to the right values."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import tfhe as jtfhe  # noqa: E402
from heongpu_tpu.models import tfhe_int as jint  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import tfhe, tfhe_int  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

LWE_N, W = 16, 4
XS, YS = np.array([9, 3]), np.array([12, 3])


def _same(got, want):
    np.testing.assert_array_equal(interop.to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(interop.to_numpy(got.b), np.asarray(want.b))
    assert got.variance == pytest.approx(want.variance, rel=1e-12)


def _hu(h):
    return interop.huint_from_numpy(np.asarray(h.bits.a), np.asarray(h.bits.b),
                                    h.bits.variance, h.width, h.count, device="cpu")


@pytest.fixture(scope="module")
def ref():
    jctx = jtfhe.make_context(lwe_n=LWE_N)
    sk = jtfhe.keygen_secret(jrng.new_key(21), lwe_n=LWE_N)
    # compiled as one program (exact: the eager run's key, for a fraction of the
    # cost of compiling its ops one at a time)
    bk = jax.jit(lambda s: jtfhe.keygen_boot(jctx, jrng.new_key(22), s))(sk)
    hx = jint.encrypt_huint(jctx, sk, XS, W, jrng.new_key(23))
    hy = jint.encrypt_huint(jctx, sk, YS, W, jrng.new_key(24))
    t = dict(ctx=tfhe.make_context(lwe_n=LWE_N, device="cpu"),
             sk=interop.tfhe_secret_key_from_numpy(np.asarray(sk.lwe), np.asarray(sk.rlwe),
                                                   device="cpu"),
             bk=interop.tfhe_boot_key_from_numpy(np.asarray(bk.bk), np.asarray(bk.ksk_a),
                                                 np.asarray(bk.ksk_b), device="cpu"),
             hx=_hu(hx), hy=_hu(hy))
    return dict(ctx=jctx, sk=sk, bk=bk, hx=hx, hy=hy), t


@pytest.fixture(scope="module")
def own():
    """The port's own keys (torch.Generator), both kinds, lwe_n=16."""
    ctx = tfhe.make_context(lwe_n=LWE_N, device="cpu")
    g = trng.new_generator(31, "cpu")
    sk = tfhe.keygen_secret(g, lwe_n=LWE_N, device="cpu")
    return ctx, g, sk, {"bk": tfhe.keygen_boot(ctx, g, sk),
                        "bk2": tfhe.keygen_boot_unrolled(ctx, g, sk)}


@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub_match_reference(ref, op):
    j, t = ref
    js, jc = getattr(jint, op)(j["ctx"], j["bk"], j["hx"], j["hy"])
    ts, tc = getattr(tfhe_int, op)(t["ctx"], t["bk"], t["hx"], t["hy"])
    assert (ts.width, ts.count) == (js.width, js.count)
    _same(ts.bits, js.bits)
    _same(tc, jc)
    got = tfhe_int.decrypt_huint(t["ctx"], t["sk"], ts).astype(np.int64)
    carry = tfhe.decrypt(t["ctx"], t["sk"], tc).astype(np.int64)
    if op == "add":
        np.testing.assert_array_equal(got, (XS + YS) % (1 << W))
        np.testing.assert_array_equal(carry, (XS + YS) >> W)
    else:
        np.testing.assert_array_equal(got, (XS - YS) % (1 << W))
        np.testing.assert_array_equal(carry, (XS >= YS).astype(np.int64))


def test_encrypt_decrypt_huint_matches_reference(ref):
    j, t = ref
    np.testing.assert_array_equal(tfhe_int.decrypt_huint(t["ctx"], t["sk"], t["hx"]),
                                  jint.decrypt_huint(j["ctx"], j["sk"], j["hx"]))
    assert list(tfhe_int.decrypt_huint(t["ctx"], t["sk"], t["hx"])) == list(XS)
    assert tfhe_int.bootstrap_rounds(8) == jint.bootstrap_rounds(8) == 5
    assert tfhe_int.bootstrap_rounds(256) == jint.bootstrap_rounds(256) == 10


@pytest.mark.parametrize("key", ["bk", "bk2"])
def test_unsigned_ops_decrypt(own, key):
    ctx, g, sk, keys = own
    bk = keys[key]
    xs, ys = np.array([200, 13, 255]), np.array([100, 13, 1])
    hx = tfhe_int.encrypt_huint(ctx, sk, xs, 8, g)
    hy = tfhe_int.encrypt_huint(ctx, sk, ys, 8, g)
    dec = lambda h: tfhe_int.decrypt_huint(ctx, sk, h).astype(np.int64)
    bit = lambda c: tfhe.decrypt(ctx, sk, c).astype(np.int64)
    s, c = tfhe_int.add(ctx, bk, hx, hy)
    np.testing.assert_array_equal(dec(s), (xs + ys) % 256)
    np.testing.assert_array_equal(bit(c), (xs + ys) >> 8)
    d, nb = tfhe_int.sub(ctx, bk, hx, hy)
    np.testing.assert_array_equal(dec(d), (xs - ys) % 256)
    np.testing.assert_array_equal(bit(nb), (xs >= ys).astype(np.int64))
    np.testing.assert_array_equal(bit(tfhe_int.eq(ctx, bk, hx, hy)), (xs == ys).astype(np.int64))
    np.testing.assert_array_equal(bit(tfhe_int.ge(ctx, bk, hy, hx)), (ys >= xs).astype(np.int64))
    np.testing.assert_array_equal(dec(tfhe_int.shift_left(hx, 3)), (xs << 3) % 256)
    np.testing.assert_array_equal(dec(tfhe_int.shift_right(hx, 2)), xs >> 2)
    np.testing.assert_array_equal(dec(tfhe_int.shift_left(hx, 9)), 0 * xs)
    sel_bits = np.array([True, False, True])
    sel = tfhe.encrypt(ctx, sk, sel_bits, g)
    np.testing.assert_array_equal(dec(tfhe_int.mux(ctx, bk, sel, hx, hy)),
                                  np.where(sel_bits, xs, ys))


@pytest.mark.parametrize("op", ["add", "sub", "eq", "ge", "mul", "ge_signed"])
def test_mismatched_operands_raise(own, op):
    ctx, g, sk, keys = own
    h4 = tfhe_int.encrypt_huint(ctx, sk, [3], 4, g)
    h8 = tfhe_int.encrypt_huint(ctx, sk, [3], 8, g)
    with pytest.raises(ValueError):
        getattr(tfhe_int, op)(ctx, keys["bk"], h4, h8)


def test_mul_decrypts(own):
    ctx, g, sk, keys = own
    xs, ys = np.array([13, 7]), np.array([11, 15])
    hx = tfhe_int.encrypt_huint(ctx, sk, xs, 4, g)
    hy = tfhe_int.encrypt_huint(ctx, sk, ys, 4, g)
    got = tfhe_int.decrypt_huint(ctx, sk, tfhe_int.mul(ctx, keys["bk"], hx, hy))
    np.testing.assert_array_equal(got.astype(np.int64), (xs * ys) % 16)


def test_signed_ops_decrypt(own):
    ctx, g, sk, keys = own
    bk = keys["bk"]
    xs = np.array([-5, 100, -128], object)
    ys = np.array([3, -100, 127], object)
    hx = tfhe_int.encrypt_hint(ctx, sk, xs, 8, g)
    hy = tfhe_int.encrypt_hint(ctx, sk, ys, 8, g)
    dec = lambda h: tfhe_int.decrypt_hint(ctx, sk, h)
    np.testing.assert_array_equal(dec(hx), xs)
    hs, _ = tfhe_int.add(ctx, bk, hx, hy)
    np.testing.assert_array_equal(
        dec(hs), np.array([((int(a) + int(b) + 128) % 256) - 128 for a, b in zip(xs, ys)], object))
    np.testing.assert_array_equal(
        dec(tfhe_int.neg(ctx, bk, hx)),
        np.array([((-int(a) + 128) % 256) - 128 for a in xs], object))
    np.testing.assert_array_equal(
        dec(tfhe_int.abs_(ctx, bk, hx)),
        np.array([abs(int(a)) if int(a) != -128 else -128 for a in xs], object))
    np.testing.assert_array_equal(
        tfhe.decrypt(ctx, sk, tfhe_int.ge_signed(ctx, bk, hx, hy)),
        np.array([int(a) >= int(b) for a, b in zip(xs, ys)]))
    np.testing.assert_array_equal(dec(tfhe_int.shift_right_arith(ctx, hx, 2)),
                                  np.array([int(a) >> 2 for a in xs], object))
