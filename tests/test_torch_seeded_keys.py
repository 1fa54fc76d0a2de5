"""Port parity for seed-expanded keys against the JAX package on the CPU.

At N=256 over four 29-bit Q primes, keys from one DRBG seed on both sides
with public seeds `a_seed`: the uniform halves come from the port's
Threefry (utils/threefry.py), the reference's from jax.random, and must be
equal bit for bit, as must every k0 and every seed.  CKKS keys under
Method I (public, relin, Galois stored stripped) and Method II (relin),
BFV keys; stripped keys regenerated (ensure_k1, expand_seeded) equal to the
stored halves and to the reference's regeneration; a relinearization and a
rotation with stripped keys give the reference's residues; ensure_k1
without a seed, or on a ring of another basis, raises; and
leveled_boot_keys(compress_keys=True) at two key levels equals the
reference's keygens under the port's seed layout, whose seeds stay apart
mod 2^32 where the reference's collide.
Tolerance 0: every value compared is an integer residue or a seed."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from heongpu_tpu.models import bfv as jbfv  # noqa: E402
from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import ckks_boot as jboot  # noqa: E402
from heongpu_tpu.models import ringkit as jring  # noqa: E402
from heongpu_tpu.utils import params as jparams  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import bfv as tbfv  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot as tboot  # noqa: E402
from heongpu_tpu_torch.models import ringkit as tring  # noqa: E402
from heongpu_tpu_torch.ops import polyops as tpoly  # noqa: E402
from heongpu_tpu_torch.utils import errors as terrors  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

N, Q_BITS = 256, [29] * 4
T = jparams.plain_modulus_for(N, 20)
G1 = tpoly.steps_to_galois_elt(1, N)


def _np(t):
    return interop.to_numpy(t)


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _same_key(t, j):
    """A port key and a reference key: k0, k1 (both None when stripped), a_seed."""
    _eq(t.k0, j.k0)
    assert (t.k1 is None) == (j.k1 is None)
    if t.k1 is not None:
        _eq(t.k1, j.k1)
    assert t.a_seed == j.a_seed


def _drbg_pair(tag: bytes):
    return jrng.new_drbg(tag * 32), trng.new_drbg(tag * 32)


@pytest.fixture(scope="module")
def ckks1():
    """Method-I CKKS contexts and DRBG keys with public seeds on both sides."""
    jc = jckks.make_context(N, Q_BITS)
    tc = tckks.make_context(N, Q_BITS, device="cpu")
    jd, td = _drbg_pair(b"k")
    out = {}
    for name, mod, ctx, d in (("j", jckks, jc, jd), ("t", tckks, tc, td)):
        sk = mod.keygen_secret(ctx, d)
        out[name] = dict(ctx=ctx, sk=sk, pk=mod.keygen_public(ctx, d, sk, a_seed=11),
                         rk=mod.keygen_relin(ctx, d, sk, a_seed=2 ** 40 + 12),
                         gk=mod.keygen_galois(ctx, d, sk, steps=[1, -1], a_seed=13,
                                              store_a=False))
    return out["j"], out["t"]


def test_ckks_method1_seeded_keys_match(ckks1):
    j, t = ckks1
    _eq(t["pk"].pk0, j["pk"].pk0)
    _eq(t["pk"].pk1, j["pk"].pk1)
    assert t["pk"].a_seed == j["pk"].a_seed == 11
    _same_key(t["rk"], j["rk"])
    assert t["rk"].a_seed == 2 ** 40 + 12
    assert set(t["gk"].keys) == set(j["gk"].keys)
    for e, k in t["gk"].keys.items():
        _same_key(k, j["gk"].keys[e])
        assert k.k1 is None
    # a_seed + i per listed element, the conjugation key after them
    assert t["gk"].keys[G1].a_seed == 13 and t["gk"].keys["conj"].a_seed == 15


def test_strip_and_expand_round_trip(ckks1):
    j, t = ckks1
    tc, jc = t["ctx"], j["ctx"]
    ring, jr = tckks._ring(tc), jckks._ring(jc)
    for key in (t["pk"], t["rk"]):
        stripped = tring.strip_seeded(key)
        half = "pk1" if isinstance(key, tring.PublicKey) else "k1"
        assert getattr(stripped, half) is None
        back = tring.expand_seeded(stripped, ring)
        torch.testing.assert_close(getattr(back, half), getattr(key, half), rtol=0, atol=0)
    torch.testing.assert_close(tring.ensure_k1(ring, tring.strip_seeded(t["rk"])), t["rk"].k1,
                               rtol=0, atol=0)
    assert tring.ensure_k1(ring, t["rk"]) is t["rk"].k1
    # the Galois set stored stripped, expanded by both packages
    t_full, j_full = tring.expand_seeded(t["gk"], ring), jring.expand_seeded(j["gk"], jr)
    for e, k in t_full.keys.items():
        _same_key(k, j_full.keys[e])
        assert k.k1 is not None
    assert tring.strip_seeded(tbfv.Ciphertext) is tbfv.Ciphertext   # anything else passes


def test_stripped_keys_keyswitch_like_the_reference(ckks1):
    """relinearize and rotate with stripped keys, the k1 halves regenerated
    inside the keyswitch, on a ciphertext the port made and carried over."""
    j, t = ckks1
    tc, jc = t["ctx"], j["ctx"]
    z = np.linspace(-1, 1, N // 2)
    ct = tckks.encrypt(tc, t["pk"], tckks.encode(tc, z), trng.new_drbg(b"e" * 32))
    jct = jckks.Ciphertext(jax.numpy.asarray(_np(ct.c)), ct.size, ct.level, ct.scale)
    rk_t, rk_j = tring.strip_seeded(t["rk"]), jring.strip_seeded(j["rk"])
    got = tckks.relinearize(tc, tckks.multiply(tc, ct, ct), rk_t)
    _eq(got.c, jckks.relinearize(jc, jckks.multiply(jc, jct, jct), rk_j).c)
    torch.testing.assert_close(got.c, tckks.relinearize(tc, tckks.multiply(tc, ct, ct),
                                                        t["rk"]).c, rtol=0, atol=0)
    rot = tckks.rotate(tc, ct, t["gk"], 1)
    _eq(rot.c, jckks.apply_galois(jc, jct, j["gk"].keys[G1]).c)
    dec = tckks.decode(tc, tckks.decrypt(tc, t["sk"], rot))
    assert np.abs(dec.real - np.roll(z, -1)).max() < 1e-3


def test_ensure_k1_without_seed_or_on_another_ring_raises(ckks1):
    _, t = ckks1
    ring = tckks._ring(t["ctx"])
    with pytest.raises(terrors.ParameterError, match="no a_seed"):
        tring.ensure_k1(ring, tring.KSKey(t["rk"].k0, None))
    with pytest.raises(terrors.ParameterError, match="ring"):
        tring.ensure_k1(tckks._ring_at(t["ctx"], 1), tring.strip_seeded(t["rk"]))
    with pytest.raises(terrors.ParameterError):
        tckks.keygen_galois(t["ctx"], trng.new_generator(1, "cpu"), t["sk"], steps=[1],
                            store_a=False)


def test_ckks_method2_seeded_relin_matches():
    jc = jckks.make_context(N, Q_BITS, ks_type="II", alpha=2)
    tc = tckks.make_context(N, Q_BITS, ks_type="II", alpha=2, device="cpu")
    jd, td = _drbg_pair(b"m")
    jsk, tsk = jckks.keygen_secret(jc, jd), tckks.keygen_secret(tc, td)
    jrk = jckks.keygen_relin(jc, jd, jsk, a_seed=31)
    trk = tckks.keygen_relin(tc, td, tsk, a_seed=31)
    _same_key(trk, jrk)
    assert tuple(trk.k0.shape) == (2, 6, N)
    tpk = tckks.keygen_public(tc, td, tsk)
    ct = tckks.encrypt(tc, tpk, tckks.encode(tc, np.linspace(-1, 1, N // 2)), td)
    jct = jckks.Ciphertext(jax.numpy.asarray(_np(ct.c)), ct.size, ct.level, ct.scale)
    _eq(tckks.relinearize(tc, tckks.multiply(tc, ct, ct), tring.strip_seeded(trk)).c,
        jckks.relinearize(jc, jckks.multiply(jc, jct, jct), jring.strip_seeded(jrk)).c)


def test_bfv_seeded_keys_match():
    jc = jbfv.make_context(N, T, q_bits=Q_BITS)
    tc = tbfv.make_context(N, T, q_bits=Q_BITS, device="cpu")
    jd, td = _drbg_pair(b"b")
    keys = {}
    for name, mod, ctx, d in (("j", jbfv, jc, jd), ("t", tbfv, tc, td)):
        sk = mod.keygen_secret(ctx, d)
        keys[name] = dict(sk=sk, pk=mod.keygen_public(ctx, d, sk, a_seed=41),
                          rk=mod.keygen_relin(ctx, d, sk, a_seed=42),
                          gk=mod.keygen_galois(ctx, d, sk, steps=[1], a_seed=43))
    j, t = keys["j"], keys["t"]
    _eq(t["pk"].pk1, j["pk"].pk1)
    _eq(t["pk"].pk0, j["pk"].pk0)
    _same_key(t["rk"], j["rk"])
    for e, k in t["gk"].keys.items():
        _same_key(k, j["gk"].keys[e])
    m = np.random.default_rng(3).integers(0, T, N)
    ct = tbfv.encrypt(tc, t["pk"], tbfv.encode(tc, m), td)
    jct = jbfv.Ciphertext(jax.numpy.asarray(_np(ct.c)), ct.size, ct.in_ntt)
    rel = tbfv.relinearize(tc, tbfv.multiply(tc, ct, ct), tring.strip_seeded(t["rk"]))
    _eq(rel.c, jbfv.relinearize(jc, jbfv.multiply(jc, jct, jct), jring.strip_seeded(j["rk"])).c)
    np.testing.assert_array_equal(tbfv.decode(tc, tbfv.decrypt(tc, t["sk"], rel)),
                                  (m * m % T).astype(np.uint32))


def test_compressed_boot_keys_match(ckks1):
    """leveled_boot_keys(compress_keys=True) on pieces at levels 0 and 1: the
    Galois keys by level group, conj and relin, all stripped, equal to the
    reference's keygens called in the reference's draw order (seed0 from the
    DRBG: bits64 >> 33) with the port's seeds: conj seed0, relin seed0 + 1,
    the j-th key of group i seed0 + (i+1)·2^16 + j.  No two keys share a
    Threefry key (a seed mod 2^32), where the reference's own layout (group
    i at seed0 + i·2^34, conj + 2^43, relin + 2^44) gives the first key of
    each group, conj and relin one uniform half."""
    j, t = ckks1
    tc, jc = t["ctx"], j["ctx"]
    pieces = [types.SimpleNamespace(level=0, giants=((0, (1, 2), None), (4, (0, 1), None))),
              types.SimpleNamespace(level=1, giants=((0, (8,), None),))]
    jd, td = _drbg_pair(b"c")
    tgk, trk = tboot.leveled_boot_keys(tc, td, t["sk"], pieces, aux_lvl=1, compress_keys=True)
    seed0 = int(jd.bits64(1)[0] >> 33)
    want = {}
    for i, (lv, steps) in enumerate(((0, [1, 2, 4]), (1, [8]))):
        want.update(jckks.keygen_galois(jc, jd, j["sk"], steps=steps, level=lv,
                                        include_conj=False, a_seed=seed0 + ((i + 1) << 16),
                                        store_a=False).keys)
    want["conj"] = jckks.keygen_galois(jc, jd, j["sk"], steps=[], level=1, include_conj=True,
                                       a_seed=seed0, store_a=False).keys["conj"]
    jrk = jring.strip_seeded(jckks.keygen_relin(jc, jd, j["sk"], level=1, a_seed=seed0 + 1))
    assert set(tgk.keys) == set(want)
    for e, k in tgk.keys.items():
        _same_key(k, want[e])
        assert k.k1 is None
    _same_key(trk, jrk)
    assert trk.k1 is None
    seeds = [k.a_seed for k in tgk.keys.values()] + [trk.a_seed]
    assert 0 <= seed0 < 2 ** 31 and max(seeds) < 2 ** 32
    assert len({s % 2 ** 32 for s in seeds}) == len(seeds) == 6
    ref_seeds = [seed0 + (i << 34) for i in range(2)] + [seed0 + (1 << 43), seed0 + (1 << 44)]
    assert len({s % 2 ** 32 for s in ref_seeds}) == 1
    # the stripped relin key regenerates over its own (level-1) basis
    _eq(tring.ensure_k1(tckks._key_ring(tc, trk), trk),
        jring.ensure_k1(jckks._key_ring(jc, jrk), jrk))
