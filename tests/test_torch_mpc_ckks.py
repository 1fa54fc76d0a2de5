"""Port parity for CKKS multiparty computation against the JAX package on
the CPU.

Three parties at N=256 on tests/test_mpc.py's CKKS chain ([29, 25, 25, 25],
one special prime), every key, share and mask drawn from `rng.new_key(seed)`
Threefry keys on both sides: the collective public key, the collective
relinearization key (both rounds), encryption, multiply -> relinearize ->
rescale with the collective key, threshold decryption (partials and fuse)
at levels 0 and 1, collective bootstrapping of a ciphertext dropped two
levels back to level 0 (both stages, the coordinator's exact centered CRT
lift held against a big-integer CRT too), and 2-of-3 Shamir decryption.
Every residue must be equal (tolerance 0); each decryption decodes within
the reference tests' 5e-2 (tests/test_mpc.py, tests/test_threshold.py: the
parties' flooding noise of ±2^13 a coefficient).  The reference side runs
once for the module, its entry points jitted."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import mpc as jmpc  # noqa: E402
from heongpu_tpu.models import ringkit as jring  # noqa: E402
from heongpu_tpu.ops import modmath as jmm  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import mpc as tmpc  # noqa: E402
from heongpu_tpu_torch.models import ringkit as tring  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

N, Q_BITS, PARTIES = 256, [29, 25, 25, 25], 3
SEED_CRS = 777
TOL = 5e-2
GROUP = (1, 3)

J = {name: jax.jit(getattr(jmpc, name)) for name in (
    "pk_share", "relin_round1", "relin_round2", "ckks_decrypt_partial")}
J["ckks_colboot_participant"] = jax.jit(jmpc.ckks_colboot_participant, static_argnums=3)
J["partial_threshold"] = jax.jit(jmpc.ckks_decrypt_partial_threshold, static_argnums=3)


def _eq(got, want):
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))


def _flow(side, ref=None):
    """One side's whole protocol run: {name: result}.  The port encrypts
    the reference's plaintext (`ref`'s): the two encoders round the same
    slots apart by up to 2 (tests/test_torch_encoder.py)."""
    if side == "j":
        ckks, mpc, ring_mod, add = jckks, jmpc, jring, jmm.add_mod
        ctx = jckks.make_context(N, Q_BITS, sec_level="none")
        key = jrng.new_key
        f = lambda name: J[name] if name in J else getattr(jmpc, name)
    else:
        ckks, mpc, ring_mod, add = tckks, tmpc, tring, tm.add_mod
        ctx = tckks.make_context(N, Q_BITS, sec_level="none", device="cpu")
        key = lambda s: trng.new_key(s, "cpu")
        f = lambda name: getattr(tmpc, name)
    ring = ckks._ring(ctx)
    p = ring.base_qp.p[:, None] if side == "j" else ring.base_qp.col()
    sks = [ring_mod.keygen_secret(ring, key(400 + i)) for i in range(PARTIES)]
    a = mpc.crs_uniform(ring, SEED_CRS + 4, (N,))
    pk = mpc.pk_assemble(ring, [f("pk_share")(ring, sk, a, key(410 + i))
                                for i, sk in enumerate(sks)], a)
    a_d = mpc.relin_crs(ring, SEED_CRS + 6)
    r1 = [f("relin_round1")(ring, sk, a_d, key(460 + i)) for i, sk in enumerate(sks)]
    shares1 = [s for s, _ in r1]
    d0, d1 = shares1[0]
    for s in shares1[1:]:
        d0, d1 = add(d0, s[0], p), add(d1, s[1], p)
    r2 = [f("relin_round2")(ring, sk, eph, d0, d1, key(470 + i))
          for i, (sk, (_, eph)) in enumerate(zip(sks, r1))]
    rk = mpc.relin_assemble(ring, shares1, r2)
    z = np.random.default_rng(55).uniform(-1, 1, N // 2)
    if ref is None:
        pt = ckks.encode(ctx, z)
    else:
        pt = interop.plaintext_from_numpy(np.asarray(ref["pt"].m), ref["pt"].level,
                                          ref["pt"].scale, device="cpu")
    ct = ckks.encrypt(ctx, pk, pt, key(420))
    prod = ckks.rescale(ctx, ckks.relinearize(ctx, ckks.multiply(ctx, ct, ct), rk))
    partials = lambda c, s0: [f("ckks_decrypt_partial")(ctx, sk, c, key(s0 + i))
                              for i, sk in enumerate(sks)]
    o = dict(ctx=ctx, sks=sks, a=a, pk=pk, rk=rk, z=z, pt=pt, ct=ct, prod=prod)
    o["partials"] = partials(ct, 430)
    o["fused"] = mpc.ckks_decrypt_fuse(ctx, ct, o["partials"])
    o["prod_fused"] = mpc.ckks_decrypt_fuse(ctx, prod, partials(prod, 480))
    ct2 = ckks.mod_drop(ctx, ct, 2)
    boot = [f("ckks_colboot_participant")(ctx, sk, ct2, SEED_CRS + 5, key(440 + i))
            for i, sk in enumerate(sks)]
    fresh = mpc.ckks_colboot_coordinator(ctx, ct2, boot, SEED_CRS + 5)
    o.update(boot=boot, fresh=fresh,
             fresh_fused=mpc.ckks_decrypt_fuse(ctx, fresh, partials(fresh, 450)))
    shares = mpc.shamir_share_secret(ctx, key(13), sks[0], 3, 2)
    single_pk = ring_mod.keygen_public(ring, key(12), sks[0])
    ct_s = ckks.encrypt(ctx, single_pk, pt, key(14))
    partial_t = f("partial_threshold") if side == "j" else mpc.ckks_decrypt_partial_threshold
    parts = [partial_t(ctx, shares[i - 1], ct_s, GROUP, key(60 + i)) for i in GROUP]
    o.update(shamir=shares, ct_s=ct_s, shamir_partials=parts,
             shamir_fused=mpc.ckks_decrypt_fuse(ctx, ct_s, parts))
    return o


@functools.lru_cache(maxsize=None)
def flows():
    j = _flow("j")
    return j, _flow("t", j)


def _decode_err(t, pt, want):
    return float(np.abs(tckks.decode(t["ctx"], pt).real - want).max())


def test_collective_public_and_relin_keys():
    j, t = flows()
    _eq(t["a"], j["a"])
    for name in ("pk0", "pk1"):
        _eq(getattr(t["pk"], name), getattr(j["pk"], name))
    for name in ("k0", "k1"):
        _eq(getattr(t["rk"], name), getattr(j["rk"], name))


def test_encrypt_mult_relin_rescale_and_threshold_decrypt():
    j, t = flows()
    _eq(t["ct"].c, j["ct"].c)
    _eq(t["prod"].c, j["prod"].c)
    for a, b in zip(t["partials"], j["partials"]):
        _eq(a, b)
    for name in ("fused", "prod_fused"):
        _eq(t[name].m, j[name].m)
        assert (t[name].level, t[name].scale) == (j[name].level, j[name].scale)
    assert _decode_err(t, t["fused"], t["z"]) < TOL
    assert t["prod_fused"].level == 1
    assert _decode_err(t, t["prod_fused"], t["z"] ** 2) < TOL


def test_collective_bootstrap_to_level_0():
    j, t = flows()
    for (a0, a1), (b0, b1) in zip(t["boot"], j["boot"]):
        _eq(a0, b0)
        _eq(a1, b1)
    assert t["fresh"].level == j["fresh"].level == 0
    assert t["fresh"].scale == j["fresh"].scale
    _eq(t["fresh"].c, j["fresh"].c)
    _eq(t["fresh_fused"].m, j["fresh_fused"].m)
    assert _decode_err(t, t["fresh_fused"], t["z"]) < TOL


def test_shamir_2_of_3():
    j, t = flows()
    for a, b in zip(t["shamir"], j["shamir"]):
        assert (a.index, a.threshold) == (b.index, b.threshold)
        _eq(a.s_ntt_mont_qp, b.s_ntt_mont_qp)
    _eq(t["ct_s"].c, j["ct_s"].c)
    for a, b in zip(t["shamir_partials"], j["shamir_partials"]):
        _eq(a, b)
    _eq(t["shamir_fused"].m, j["shamir_fused"].m)
    assert _decode_err(t, t["shamir_fused"], t["z"]) < TOL


@pytest.mark.parametrize("k_in", [1, 2, 4])
def test_crt_relift_is_the_exact_centered_crt(k_in):
    """The coordinator's lift on random residues, with the values at the
    centering threshold floor(Q/2) and its neighbours, against Python big
    integers."""
    primes = (536608769, 33550849, 33540097, 1073479681)[:k_in]
    out = (536608769, 536215553, 33550849, 786433)
    Q = 1
    for q in primes:
        Q *= q
    r = np.random.default_rng(k_in)
    vals = [int(v) * 2 ** 62 % Q for v in r.integers(0, 2 ** 62, 250, dtype=np.int64)]
    vals += [0, Q - 1, Q // 2 - 1, Q // 2, Q // 2 + 1, 1]
    x = torch.tensor([[v % q for v in vals] for q in primes], dtype=torch.int32)
    got = tmpc.crt_relift(x, primes, out).numpy()
    cent = [v - Q if v >= Q // 2 else v for v in vals]
    want = np.array([[c % q for c in cent] for q in out], np.int64)
    np.testing.assert_array_equal(got, want)
