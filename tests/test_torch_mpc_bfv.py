"""Port parity for BFV multiparty computation against the JAX package on the
CPU.

Three parties at N=256 over three 29-bit Q primes and t =
plain_modulus_for(256, 16) (tests/test_mpc.py's chain, at N=256), every key,
share and mask drawn from `rng.new_key(seed)` Threefry keys on both sides:
the common reference strings, the collective public key (shares and
assembly), both rounds of the collective relinearization key and its
assembly, a collective Galois key for a row rotation by 1, encryption,
multiply -> relinearize and the rotation with the collective keys, threshold
decryption (partials and fuse), collective bootstrapping (both stages) and
the noise budget under the joint key Σ s_i after it, and 3-of-5 Shamir
decryption (the dealer's shares, partials of the groups (2, 4, 5) and
(1, 3, 5)).  Every residue must be equal: tolerance 0; every decryption
exact.  The two groups tests/test_threshold.py refuses are refused
(ParameterError here, an assertion there).  The reference side runs once
for the module, its entry points jitted."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from heongpu_tpu.models import bfv as jbfv  # noqa: E402
from heongpu_tpu.models import mpc as jmpc  # noqa: E402
from heongpu_tpu.models import ringkit as jring  # noqa: E402
from heongpu_tpu.ops import modmath as jmm  # noqa: E402
from heongpu_tpu.ops import ntt as jntt  # noqa: E402
from heongpu_tpu.ops import polyops as jpoly  # noqa: E402
from heongpu_tpu.utils import params as jparams  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import bfv as tbfv  # noqa: E402
from heongpu_tpu_torch.models import mpc as tmpc  # noqa: E402
from heongpu_tpu_torch.models import ringkit as tring  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.utils import errors as terrors  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

N, Q_BITS, PARTIES = 256, [29] * 3, 3
T = jparams.plain_modulus_for(N, 16)
SEED_CRS = 777
GROUPS = ((2, 4, 5), (1, 3, 5))

J = {name: jax.jit(getattr(jmpc, name)) for name in (
    "pk_share", "relin_round1", "relin_round2", "bfv_decrypt_partial")}
J["galois_share"] = jax.jit(jmpc.galois_share, static_argnums=2)
J["bfv_colboot_participant"] = jax.jit(jmpc.bfv_colboot_participant, static_argnums=3)
J["bfv_colboot_coordinator"] = jax.jit(jmpc.bfv_colboot_coordinator, static_argnums=3)
J["partial_threshold"] = jax.jit(jmpc.bfv_decrypt_partial_threshold, static_argnums=3)
J["fuse"] = jax.jit(jmpc.bfv_decrypt_fuse)


def _eq(got, want):
    """Equal words; a signed reference array (int32) compared as signed."""
    got, want = interop.to_numpy(got), np.asarray(want)
    np.testing.assert_array_equal(got.view(want.dtype) if want.dtype == np.int32 else got, want)


def _flow(side):
    """One side's whole protocol run: {name: result}."""
    if side == "j":
        bfv, mpc, ring_mod = jbfv, jmpc, jring
        ctx = jbfv.make_context(N, T, q_bits=Q_BITS, sec_level="none")
        key = jrng.new_key
        f = lambda name: J[name] if name in J else getattr(jmpc, name)
    else:
        bfv, mpc, ring_mod = tbfv, tmpc, tring
        ctx = tbfv.make_context(N, T, q_bits=Q_BITS, sec_level="none", device="cpu")
        key = lambda s: trng.new_key(s, "cpu")
        f = lambda name: getattr(tmpc, name)
    ring = bfv._ring(ctx)
    o = {"ctx": ctx}
    sks = [ring_mod.keygen_secret(ring, key(200 + i)) for i in range(PARTIES)]
    a = mpc.crs_uniform(ring, SEED_CRS, (N,))
    pks = [f("pk_share")(ring, sk, a, key(210 + i)) for i, sk in enumerate(sks)]
    pk = mpc.pk_assemble(ring, pks, a)
    a_d = mpc.relin_crs(ring, SEED_CRS + 1)
    r1 = [f("relin_round1")(ring, sk, a_d, key(240 + i)) for i, sk in enumerate(sks)]
    shares1 = [s for s, _ in r1]
    p = ring.base_qp.p[:, None] if side == "j" else ring.base_qp.col()
    add = jmm.add_mod if side == "j" else tm.add_mod
    d0, d1 = shares1[0]
    for s in shares1[1:]:
        d0, d1 = add(d0, s[0], p), add(d1, s[1], p)
    r2 = [f("relin_round2")(ring, sk, eph, d0, d1, key(250 + i))
          for i, (sk, (_, eph)) in enumerate(zip(sks, r1))]
    rk = mpc.relin_assemble(ring, shares1, r2)
    g = jpoly.steps_to_galois_elt(1, N)
    a_g = mpc.relin_crs(ring, SEED_CRS + 2)
    gshares = [f("galois_share")(ring, sk, g, a_g, key(280 + i)) for i, sk in enumerate(sks)]
    gk1 = mpc.galois_assemble(ring, g, gshares, a_g)
    r = np.random.default_rng(55)
    m1, m2 = r.integers(0, T, N), r.integers(0, T, N)
    ct1 = bfv.encrypt(ctx, pk, bfv.encode(ctx, m1), key(260))
    ct2 = bfv.encrypt(ctx, pk, bfv.encode(ctx, m2), key(261))
    prod = bfv.relinearize(ctx, bfv.multiply(ctx, ct1, ct2), rk)
    rot = bfv.apply_galois(ctx, ct1, gk1)
    fuse = f("fuse") if side == "j" else mpc.bfv_decrypt_fuse
    partials = lambda ct, s0: [f("bfv_decrypt_partial")(ctx, sk, ct, key(s0 + i))
                               for i, sk in enumerate(sks)]
    o.update(sks=sks, a=a, pk_shares=pks, pk=pk, a_d=a_d, round1=r1, round2=r2, rk=rk,
             g=g, a_g=a_g, galois_shares=gshares, gk1=gk1, m1=m1, m2=m2, ct1=ct1, prod=prod,
             rot=rot)
    o["prod_partials"] = partials(prod, 270)
    o["prod_fused"] = fuse(ctx, prod, o["prod_partials"])
    o["rot_fused"] = fuse(ctx, rot, partials(rot, 295))
    boot = [f("bfv_colboot_participant")(ctx, sk, ct1, SEED_CRS + 3, key(310 + i))
            for i, sk in enumerate(sks)]
    fresh = f("bfv_colboot_coordinator")(ctx, ct1, boot, SEED_CRS + 3)
    o.update(boot_shares=boot, fresh=fresh, fresh_fused=fuse(ctx, fresh, partials(fresh, 320)))
    # Shamir 3 of 5 over one party's key, from its own dealer key
    shares = mpc.shamir_share_secret(ctx, key(3), sks[0], 5, 3)
    single_pk = ring_mod.keygen_public(ring, key(2), sks[0])
    ct = bfv.encrypt(ctx, single_pk, bfv.encode(ctx, m2), key(4))
    pt = f("partial_threshold") if side == "j" else mpc.bfv_decrypt_partial_threshold
    o.update(shamir=shares, shamir_ct=ct)
    for grp in GROUPS:
        parts = [pt(ctx, shares[i - 1], ct, grp, key(50 + i)) for i in grp]
        o[f"partials_{grp}"] = parts
        o[f"fused_{grp}"] = fuse(ctx, ct, parts)
    return o


@functools.lru_cache(maxsize=None)
def flows():
    return _flow("j"), _flow("t")


def _joint_sk(side, o):
    """The oracle joint key Σ s_i of one side, as tests/test_mpc.py builds it."""
    s_sum = sum(np.asarray(interop.to_numpy(sk.s_coeff)).astype(np.int64) for sk in o["sks"])
    s_sum = s_sum.astype(np.int32)
    ring = (jbfv if side == "j" else tbfv)._ring(o["ctx"])
    if side == "j":
        s_rns = jrng.signed_to_rns(jnp.asarray(s_sum), ring.qp_primes)
        p, pinv, r2, *_ = ring.base_qp.bview()
        return jring.SecretKey(jnp.asarray(s_sum),
                               jmm.to_mont(jntt.ntt_fwd(s_rns, ring.ntt_qp), p, pinv, r2), 0)
    s = torch.from_numpy(s_sum)
    s_ntt = tntt.ntt_fwd(trng.signed_to_rns(s, ring.qp_primes), ring.ntt_qp)
    return tring.SecretKey(s, tm.to_mont(s_ntt, ring.base_qp.col(), ring.base_qp.col("r1")), 0)


def test_party_keys_crs_and_collective_public_key():
    j, t = flows()
    for a, b in zip(t["sks"], j["sks"]):
        _eq(a.s_coeff, b.s_coeff)
        _eq(a.s_ntt_mont_qp, b.s_ntt_mont_qp)
    for name in ("a", "a_d", "a_g"):
        _eq(t[name], j[name])
    assert tuple(t["a_d"].shape) == (3, 4, N)
    for a, b in zip(t["pk_shares"], j["pk_shares"]):
        _eq(a, b)
    _eq(t["pk"].pk0, j["pk"].pk0)
    _eq(t["pk"].pk1, j["pk"].pk1)


def test_collective_relin_key_both_rounds():
    j, t = flows()
    for (ts, te), (js, je) in zip(t["round1"], j["round1"]):
        _eq(ts[0], js[0])
        _eq(ts[1], js[1])
        _eq(te.u_mont, je.u_mont)
    for a, b in zip(t["round2"], j["round2"]):
        _eq(a[0], b[0])
        _eq(a[1], b[1])
    _eq(t["rk"].k0, j["rk"].k0)
    _eq(t["rk"].k1, j["rk"].k1)


def test_collective_galois_key():
    j, t = flows()
    for a, b in zip(t["galois_shares"], j["galois_shares"]):
        _eq(a, b)
    for name in ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt"):
        _eq(getattr(t["gk1"], name), getattr(j["gk1"], name))
    assert t["gk1"].galois_elt == j["gk1"].galois_elt == t["g"]


def test_mult_relin_rotate_and_threshold_decrypt():
    j, t = flows()
    _eq(t["ct1"].c, j["ct1"].c)
    _eq(t["prod"].c, j["prod"].c)
    _eq(t["rot"].c, j["rot"].c)
    for a, b in zip(t["prod_partials"], j["prod_partials"]):
        _eq(a, b)
    ctx = t["ctx"]
    _eq(t["prod_fused"], j["prod_fused"])
    np.testing.assert_array_equal(tbfv.decode(ctx, t["prod_fused"]),
                                  (t["m1"] * t["m2"] % T).astype(np.uint32))
    _eq(t["rot_fused"], j["rot_fused"])
    half = N // 2
    want = np.concatenate([np.roll(t["m1"][:half], -1), np.roll(t["m1"][half:], -1)])
    np.testing.assert_array_equal(tbfv.decode(ctx, t["rot_fused"]), want.astype(np.uint32))


def test_collective_bootstrap_and_joint_noise_budget():
    j, t = flows()
    for (a0, a1), (b0, b1) in zip(t["boot_shares"], j["boot_shares"]):
        _eq(a0, b0)
        _eq(a1, b1)
    _eq(t["fresh"].c, j["fresh"].c)
    assert (t["fresh"].size, t["fresh"].in_ntt) == (j["fresh"].size, j["fresh"].in_ntt)
    _eq(t["fresh_fused"], j["fresh_fused"])
    np.testing.assert_array_equal(tbfv.decode(t["ctx"], t["fresh_fused"]),
                                  t["m1"].astype(np.uint32))
    nb_t = tbfv.noise_budget(t["ctx"], _joint_sk("t", t), t["fresh"])
    nb_j = jbfv.noise_budget(j["ctx"], _joint_sk("j", j), j["fresh"])
    assert abs(nb_t - nb_j) < 1e-6 and nb_t > 5


def test_shamir_3_of_5_shares_and_decryption():
    j, t = flows()
    for a, b in zip(t["shamir"], j["shamir"]):
        assert (a.index, a.threshold) == (b.index, b.threshold)
        _eq(a.s_ntt_mont_qp, b.s_ntt_mont_qp)
    _eq(t["shamir_ct"].c, j["shamir_ct"].c)
    for grp in GROUPS:
        for a, b in zip(t[f"partials_{grp}"], j[f"partials_{grp}"]):
            _eq(a, b)
        _eq(t[f"fused_{grp}"], j[f"fused_{grp}"])
        np.testing.assert_array_equal(tbfv.decode(t["ctx"], t[f"fused_{grp}"]),
                                      t["m2"].astype(np.uint32))


def test_threshold_refuses_what_the_reference_refuses():
    j, t = flows()
    ctx, shares, ct = t["ctx"], t["shamir"], t["shamir_ct"]
    key = trng.new_key(99, "cpu")
    # fewer than t participants, and a t-subset the party is not in
    for grp in ((1, 2), (2, 3, 4)):
        with pytest.raises(terrors.ParameterError):
            tmpc.bfv_decrypt_partial_threshold(ctx, shares[0], ct, grp, key)
        with pytest.raises(AssertionError):
            jmpc.bfv_decrypt_partial_threshold(j["ctx"], j["shamir"][0], j["shamir_ct"], grp,
                                               jrng.new_key(99))
    for n_parties, threshold in ((3, 0), (3, 4)):
        with pytest.raises(terrors.ParameterError):
            tmpc.shamir_share_secret(ctx, key, t["sks"][0], n_parties, threshold)


def test_smudge_noise_both_splits():
    """_smudge_noise at the 30 + 10-bit split (bits=40, BFV) and in one draw
    (bits=13, CKKS) equals the reference's, within ±2^bits."""
    primes = (536608769, 536215553, 1073479681)
    for bits in (40, 13, 30):
        want = np.asarray(jmpc._smudge_noise(jrng.new_key(5), primes, N, bits))
        got = tmpc._smudge_noise(trng.new_key(5, "cpu"), primes, N, "cpu", bits)
        _eq(got, want)
        q = primes[0]
        v = np.asarray(want[0]).astype(np.int64)
        v = np.where(v > q // 2, v - q, v)
        assert np.abs(v).max() <= 1 << bits

