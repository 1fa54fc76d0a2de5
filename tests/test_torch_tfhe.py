"""Port parity for TFHE gate bootstrapping at lwe_n=16 (a test-only chain
length; N=1024, l=2, bg_bit=10 and the base-4 keyswitch are STD128's).

The reference's context is rebuilt by the port (tables and constants must
agree); its Threefry keys and ciphertexts are carried over with `interop`,
and every bootstrap, gate and MUX output must be bit-identical: a BootKey
against `bootstrap_raw`, a BootKey2 against the Pallas interpreter's
`bootstrap_fused2`.  One DRBG seed must give both packages the same keys
and ciphertexts.  Variances are floats, held to a relative 1e-12."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from heongpu_tpu.models import tfhe as jtfhe  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import tfhe  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import tfhe_kernel as tk  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

LWE_N = 16
B1 = np.array([True, True, False, False])
B2 = np.array([True, False, True, False])
SEL = np.array([True, False, False, True])
BITS8 = np.array([0, 1, 0, 1, 1, 0, 1, 1], bool)
EDGES = [0, 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, (1 << 32) - 1, 1 << 29, 3 << 29]


def _np(t):
    return interop.to_numpy(t)


def _ct(c):
    return interop.tfhe_ciphertext_from_numpy(np.asarray(c.a), np.asarray(c.b), c.variance,
                                              device="cpu")


def _same(got, want):
    """Bit-identical (a, b) and the same variance (relative 1e-12)."""
    np.testing.assert_array_equal(_np(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(_np(got.b), np.asarray(want.b))
    assert got.variance == pytest.approx(want.variance, rel=1e-12)


@pytest.fixture(scope="module")
def ref():
    """Reference context, Threefry keys and ciphertexts, and the port's
    context with the same keys and ciphertexts carried over."""
    jctx = jtfhe.make_context(lwe_n=LWE_N)
    sk = jtfhe.keygen_secret(jrng.new_key(1), lwe_n=LWE_N)
    # each key set compiled as one program (exact: the eager run's keys, for a
    # fraction of the cost of compiling its ops one at a time)
    bk = jax.jit(lambda s: jtfhe.keygen_boot(jctx, jrng.new_key(2), s))(sk)
    bk2 = jax.jit(lambda s: jtfhe.keygen_boot_unrolled(jctx, jrng.new_key(3), s))(sk)
    j = dict(ctx=jctx, sk=sk, bk=bk, bk2=bk2,
             ct8=jtfhe.encrypt(jctx, sk, BITS8, jrng.new_key(4)),
             ct3=jtfhe.encrypt(jctx, sk, BITS8[:3], jrng.new_key(5)),
             c1=jtfhe.encrypt(jctx, sk, B1, jrng.new_key(6)),
             c2=jtfhe.encrypt(jctx, sk, B2, jrng.new_key(7)),
             sel=jtfhe.encrypt(jctx, sk, SEL, jrng.new_key(8)))
    t = dict(ctx=tfhe.make_context(lwe_n=LWE_N, device="cpu"),
             sk=interop.tfhe_secret_key_from_numpy(np.asarray(sk.lwe), np.asarray(sk.rlwe),
                                                   device="cpu"),
             bk=interop.tfhe_boot_key_from_numpy(np.asarray(bk.bk), np.asarray(bk.ksk_a),
                                                 np.asarray(bk.ksk_b), device="cpu"),
             bk2=interop.tfhe_boot_key2_from_numpy(np.asarray(bk2.bk2), np.asarray(bk2.ksk_a),
                                                   np.asarray(bk2.ksk_b), device="cpu"))
    for name in ("ct8", "ct3", "c1", "c2", "sel"):
        t[name] = _ct(j[name])
    return j, t


def test_context_matches(ref):
    j, t = ref
    jc, tc = j["ctx"], t["ctx"]
    assert tc.primes == jc.primes
    assert (tc.n, tc.N, tc.k, tc.l, tc.bg_bit, tc.ks_base_bit, tc.ks_length) == \
        (jc.n, jc.N, jc.k, jc.l, jc.bg_bit, jc.ks_base_bit, jc.ks_length)
    for f in ("psi", "tw_mat", "itw_mat", "pinv", "r1"):
        np.testing.assert_array_equal(_np(getattr(tc.ntt, f)), np.asarray(getattr(jc.ntt, f)))
    for a, b in zip(tc.ntt.tw1 + tc.ntt.tw2 + tc.ntt.itw1 + tc.ntt.itw2,
                    jc.ntt.tw1 + jc.ntt.tw2 + jc.ntt.itw1 + jc.ntt.itw2):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(_np(tc.omega_bits), np.asarray(jc.omega_bits))
    P = tc.p1p2
    assert P % (1 << 32) == int(jc.p1p2_mod32)
    assert (P // 2) >> 32 == int(jc.p1p2_half_hi)
    assert (P // 2) & 0xFFFFFFFF == int(jc.p1p2_half_lo)
    assert tc.p1_inv_p2 == int(jc.p1_inv_p2) and tc.offset == int(jc.offset)


def test_encrypt_decrypt(ref):
    j, t = ref
    for name, bits in (("ct8", BITS8), ("c1", B1), ("sel", SEL)):
        np.testing.assert_array_equal(tfhe.decrypt(t["ctx"], t["sk"], t[name]), bits)
        np.testing.assert_array_equal(tfhe.decrypt(t["ctx"], t["sk"], t[name]),
                                      np.asarray(jtfhe.decrypt(j["ctx"], j["sk"], j[name])))
    own = tfhe.encrypt(t["ctx"], t["sk"], BITS8, trng.new_generator(5, "cpu"))
    assert own.a.dtype == torch.int32 and own.variance == tfhe.SIGMA_KS ** 2
    np.testing.assert_array_equal(tfhe.decrypt(t["ctx"], t["sk"], own), BITS8)


def test_drbg_keys_and_encrypt_match_reference(ref):
    j, t = ref
    seed = bytes(range(32))
    jd, td = jrng.new_drbg(seed), trng.new_drbg(seed)
    jsk = jtfhe.keygen_secret(jd, lwe_n=LWE_N)
    tsk = tfhe.keygen_secret(td, lwe_n=LWE_N, device="cpu")
    pairs = [(tsk.lwe, jsk.lwe), (tsk.rlwe, jsk.rlwe)]
    # the reference's keygens compiled as one program each (the DRBG draws at trace
    # time, in the eager order)
    jbk = jax.jit(lambda s: jtfhe.keygen_boot(j["ctx"], jd, s))(jsk)
    tbk = tfhe.keygen_boot(t["ctx"], td, tsk)
    pairs += [(tbk.bk, jbk.bk), (tbk.ksk_a, jbk.ksk_a), (tbk.ksk_b, jbk.ksk_b)]
    jbk2 = jax.jit(lambda s: jtfhe.keygen_boot_unrolled(j["ctx"], jd, s))(jsk)
    tbk2 = tfhe.keygen_boot_unrolled(t["ctx"], td, tsk)
    pairs += [(tbk2.bk2, jbk2.bk2), (tbk2.ksk_a, jbk2.ksk_a), (tbk2.ksk_b, jbk2.ksk_b)]
    jct = jtfhe.encrypt(j["ctx"], jsk, BITS8, jd)
    tct = tfhe.encrypt(t["ctx"], tsk, BITS8, td)
    pairs += [(tct.a, jct.a), (tct.b, jct.b)]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert tct.variance == jct.variance


@pytest.mark.parametrize("batch,keyswitch", [(8, True), (8, False), (3, True), (3, False)])
def test_bootstrap_matches_raw(ref, batch, keyswitch):
    j, t = ref
    name = "ct8" if batch == 8 else "ct3"
    want = jtfhe.bootstrap_raw(j["ctx"], j["bk"], j[name], keyswitch=keyswitch)
    got = tfhe.bootstrap(t["ctx"], t["bk"], t[name], keyswitch=keyswitch)
    assert isinstance(got, tfhe.Ciphertext if keyswitch else tfhe.NLwe)
    _same(got, want)
    if keyswitch:
        np.testing.assert_array_equal(tfhe.decrypt(t["ctx"], t["sk"], got), BITS8[:batch])


def test_bootstrap_unrolled_matches_fused2(ref):
    j, t = ref
    want = jtfhe.bootstrap_fused2(j["ctx"], j["bk2"], j["ct8"], tile=8, interpret=True)
    got = tfhe.bootstrap(t["ctx"], t["bk2"], t["ct8"])
    _same(got, want)
    np.testing.assert_array_equal(tfhe.decrypt(t["ctx"], t["sk"], got), BITS8)


def test_wrappers_run_the_plain_chains_on_cpu(ref):
    """On CPU tensors the chain wrappers return the plain chains' canonical
    NTT-domain accumulators."""
    _, t = ref
    ctx = t["ctx"]
    acc, a_t = tfhe._boot_prologue(ctx, t["ct8"])
    out = tk.blind_rotate(acc, a_t, t["bk"].bk, ctx)
    assert torch.equal(out, tfhe.blind_rotate_plain(acc, a_t, t["bk"].bk, ctx))
    assert out.shape == acc.shape and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < max(ctx.primes)


GATES = {"NAND": lambda a, b: ~(a & b), "AND": lambda a, b: a & b,
         "OR": lambda a, b: a | b, "NOR": lambda a, b: ~(a | b),
         "XOR": lambda a, b: a ^ b, "XNOR": lambda a, b: ~(a ^ b)}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_matches_reference(ref, gate):
    j, t = ref
    want = getattr(jtfhe, gate)(j["ctx"], j["bk"], j["c1"], j["c2"])
    got = getattr(tfhe, gate)(t["ctx"], t["bk"], t["c1"], t["c2"])
    _same(got, want)
    np.testing.assert_array_equal(tfhe.decrypt(t["ctx"], t["sk"], got), GATES[gate](B1, B2))
    assert got.variance == pytest.approx(tfhe.bootstrap_output_variance(t["ctx"]), rel=1e-12)


def test_not_matches_reference(ref):
    j, t = ref
    got = tfhe.NOT(t["ctx"], t["c1"])
    _same(got, jtfhe.NOT(j["ctx"], j["c1"]))
    np.testing.assert_array_equal(tfhe.decrypt(t["ctx"], t["sk"], got), ~B1)


def test_mux_matches_reference_and_cost(ref, monkeypatch):
    """MUX: one 2B bootstrap without a keyswitch, then one keyswitch."""
    j, t = ref
    want = jtfhe.MUX(j["ctx"], j["bk"], j["sel"], j["c1"], j["c2"])
    boots, switches = [], []
    orig_boot, orig_ks = tfhe._bootstrap, tfhe.lwe_keyswitch
    monkeypatch.setattr(tfhe, "_bootstrap", lambda ctx, bk, ct, keyswitch=True: boots.append(
        (ct.a.shape[0], keyswitch)) or orig_boot(ctx, bk, ct, keyswitch=keyswitch))
    monkeypatch.setattr(tfhe, "lwe_keyswitch", lambda ctx, bk, s: switches.append(
        s.a.shape[0]) or orig_ks(ctx, bk, s))
    got = tfhe.MUX(t["ctx"], t["bk"], t["sel"], t["c1"], t["c2"])
    assert boots == [(8, False)] and switches == [4]
    _same(got, want)
    np.testing.assert_array_equal(tfhe.decrypt(t["ctx"], t["sk"], got), np.where(SEL, B1, B2))


def test_unrolled_gates_decrypt(ref):
    """Gates and MUX through a BootKey2 (the plain key-unrolled chain)."""
    _, t = ref
    ctx, sk, bk2 = t["ctx"], t["sk"], t["bk2"]
    for gate, fn in GATES.items():
        got = getattr(tfhe, gate)(ctx, bk2, t["c1"], t["c2"])
        np.testing.assert_array_equal(tfhe.decrypt(ctx, sk, got), fn(B1, B2))
        assert got.variance == pytest.approx(tfhe.bootstrap_output_variance(ctx, 4), rel=1e-12)
    got = tfhe.MUX(ctx, bk2, t["sel"], t["c1"], t["c2"])
    np.testing.assert_array_equal(tfhe.decrypt(ctx, sk, got), np.where(SEL, B1, B2))


def test_variance_functions_match_reference(ref):
    j, t = ref
    for u in (1, 4):
        assert tfhe.blind_rotate_variance(t["ctx"], u) == pytest.approx(
            jtfhe.blind_rotate_variance(j["ctx"], u), rel=1e-12)
        assert tfhe.bootstrap_output_variance(t["ctx"], u) == pytest.approx(
            jtfhe.bootstrap_output_variance(j["ctx"], u), rel=1e-12)
    assert tfhe.keyswitch_variance(t["ctx"]) == pytest.approx(
        jtfhe.keyswitch_variance(j["ctx"]), rel=1e-12)
    assert tfhe.noise_margin_bits(t["ct8"]) == pytest.approx(
        jtfhe.noise_margin_bits(j["ct8"]), rel=1e-12)
    assert tfhe.noise_margin_bits(t["ct8"]) > 1


def test_torus_wrap_and_shift_edges(ref):
    """uint32 semantics in int32 storage: wrapping sums and negations,
    logical shifts and unsigned compares at 0, 2^31 - 1, 2^31, 2^32 - 1."""
    j, t = ref
    jc, tc = j["ctx"], t["ctx"]
    v = np.array(EDGES, np.uint32)
    tv = tm.u32_to_i32(v)
    jv = jnp.asarray(v)
    np.testing.assert_array_equal(_np(tfhe._torus_to_rns(tc, tv)),
                                  np.asarray(jtfhe._torus_to_rns(jc, jv)))
    np.testing.assert_array_equal(_np(tfhe._modswitch(tv, tc.N)),
                                  np.asarray(jtfhe._modswitch(jv, jc.N)))
    d = np.resize(v, (2, 2, 8))
    np.testing.assert_array_equal(tfhe._decompose(tc, tm.u32_to_i32(d)).numpy(),
                                  np.asarray(jtfhe._decompose(jc, jnp.asarray(d))))
    # residues whose CRT value sits at and around floor(P/2)
    P = tc.p1p2
    vals = [0, 1, P // 2 - 1, P // 2, P // 2 + 1, P - 1]
    r = np.array([[x % p for x in vals] for p in tc.primes], np.uint32)
    np.testing.assert_array_equal(_np(tfhe._rns_to_torus(tc, tm.u32_to_i32(r))),
                                  np.asarray(jtfhe._rns_to_torus(jc, jnp.asarray(r))))
    # gate pre-computations, NOT and decrypt on edge words
    n = tc.n
    a = np.resize(v, (len(EDGES), n)).astype(np.uint32)
    c = jtfhe.Ciphertext(jnp.asarray(a), jnp.asarray(v), variance=1e-9)
    tcx = _ct(c)
    _same(tfhe._lin(tcx, tcx, -1, -1, tfhe.MU, 1),
          jtfhe.Ciphertext(-(c.a + c.a), jtfhe.MU - c.b - c.b, variance=2e-9))
    _same(tfhe._lin(tcx, tcx, 2, 2, 2 * tfhe.MU, 4),
          jtfhe.Ciphertext(jnp.uint32(2) * (c.a + c.a),
                           jnp.uint32(2) * (c.b + c.b) + jnp.uint32(2) * jtfhe.MU,
                           variance=8e-9))
    _same(tfhe.NOT(tc, tcx), jtfhe.NOT(jc, c))
    np.testing.assert_array_equal(tfhe.decrypt(tc, t["sk"], tcx),
                                  np.asarray(jtfhe.decrypt(jc, j["sk"], c)))
    # sample extract and the keyswitch's rounding shift on edge words
    acc_t = np.resize(v, (3, 2, tc.N)).astype(np.uint32)
    ta, tb = tfhe._sample_extract(tc, tm.u32_to_i32(acc_t))
    ja, jb = jtfhe._sample_extract(jc, jnp.asarray(acc_t))
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))
    got = tfhe.lwe_keyswitch(tc, t["bk"], tfhe.NLwe(ta, tb, 0.5))
    _same(got, jtfhe.lwe_keyswitch(jc, j["bk"], jtfhe.NLwe(ja, jb, 0.5)))


def test_interop_round_trip(ref):
    j, t = ref
    d = interop.to_numpy(t["bk2"])
    np.testing.assert_array_equal(d["bk2"], np.asarray(j["bk2"].bk2))
    np.testing.assert_array_equal(d["ksk_b"], np.asarray(j["bk2"].ksk_b))
    c = interop.to_numpy(t["ct8"])
    np.testing.assert_array_equal(c["a"], np.asarray(j["ct8"].a))
    assert c["a"].dtype == np.uint32 and c["variance"] == j["ct8"].variance
    np.testing.assert_array_equal(interop.to_numpy(t["sk"])["rlwe"], np.asarray(j["sk"].rlwe))


def test_chain_wrappers_reject_bad_input(ref):
    _, t = ref
    ctx = t["ctx"]
    acc, a_t = tfhe._boot_prologue(ctx, t["ct8"])
    bk = t["bk"].bk
    with pytest.raises(ValueError):
        tk.blind_rotate(acc.to(torch.int64), a_t, bk, ctx)
    with pytest.raises(ValueError):
        tk.blind_rotate(acc, a_t.t().contiguous().t(), bk, ctx)
    with pytest.raises(ValueError):
        tk.blind_rotate(acc, a_t[:, :12].contiguous(), bk[:12].contiguous(), ctx)
    with pytest.raises(ValueError):
        tk.blind_rotate2(acc, a_t, bk, ctx)
    with pytest.raises(ValueError):
        tk.blind_rotate_cuda(acc, a_t, bk, ctx)
    with pytest.raises(ValueError):
        tfhe.make_context(lwe_n=12, device="cpu")


def test_port_imports_no_jax():
    code = ("import sys, heongpu_tpu_torch.models.tfhe, heongpu_tpu_torch.models.tfhe_int, "
            "heongpu_tpu_torch.ops.tfhe_kernel, heongpu_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'heongpu_tpu.'))"
            " or m == 'heongpu_tpu']; print(bad); sys.exit(1 if bad else 0)")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
