"""The port's serializer on the JAX package's largest objects, on the CPU:
the bootstrapping key sets, TFHE's boot keys, HUint and the contexts.

The key sets are the port's own, made at N=64 with compress_keys=True (so
their keys are stripped and carry seeds), and the JAX package's BootKeys and
BootKeysV2 holding the same arrays; TFHE's BootKey and BootKey2 and an HUint
hold seeded random words of their real shapes and dtypes at lwe_n 16 (the
reference's keygen is slow, and the wire does not care).  For each class the
port writes the reference's bytes, byte for byte; the reference's bytes load
in the port equal, field for field, to what interop builds from the same
object; and the reference's loader reads the port's bytes back to the
original (as it reads its own bytes: it makes every array a jax array, so
under x64 off BootKeysV2's float64 cosine coefficients come back float32).
The port's own BootKeysV2 (its cosine coefficients a float64 numpy array)
round-trips within the port, float64.

The reference's contexts (CKKS under both methods, BFV, BGV, TFHE) load as
the port's contexts rebuilt from their parameters, checked against every
stored table the port also builds; a context with one prime or one table
word changed raises ValueError.  A compressed key of the reference's own
seed layout (seeds at and above 2^32, which PRNGKey keeps mod 2^32) loads
stripped and expands in the port to the reference's uniform half.  Paths
outside the loader's tables still raise."""

import dataclasses
import functools
import io
import json
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from heongpu_tpu.models import bfv as jbfv  # noqa: E402
from heongpu_tpu.models import bgv as jbgv  # noqa: E402
from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import ckks_boot as jboot  # noqa: E402
from heongpu_tpu.models import ckks_boot_ext as jext  # noqa: E402
from heongpu_tpu.models import ringkit as jring  # noqa: E402
from heongpu_tpu.models import tfhe as jtfhe  # noqa: E402
from heongpu_tpu.models import tfhe_int as jtint  # noqa: E402
from heongpu_tpu.utils import params as jparams  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu.utils import serializer as jser  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import bfv as tbfv  # noqa: E402
from heongpu_tpu_torch.models import bgv as tbgv  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot as tboot  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot_ext as text  # noqa: E402
from heongpu_tpu_torch.models import ringkit as tring  # noqa: E402
from heongpu_tpu_torch.models import tfhe as ttfhe  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402
from heongpu_tpu_torch.utils import serializer as tser  # noqa: E402
from heongpu_tpu_torch.utils import threefry as ttf  # noqa: E402
from test_torch_serializer import _same  # noqa: E402

torch.set_num_threads(2)

N = 64
Q_BITS = [29] + [28] * 9
CTX_KW = dict(scale_bits=28, sec_level="none", ks_type="II", alpha=4, p_count=6)
LWE_N = 16
T = jparams.plain_modulus_for(N, 16)


def _u32(t):
    return None if t is None else interop.to_numpy(t)


def _ref_key(k):
    """A port KSKey or GaloisKeyOne as the reference's, seed and stripped half kept."""
    if isinstance(k, tring.KSKey):
        return jring.KSKey(_u32(k.k0), _u32(k.k1), k.a_seed)
    return jring.GaloisKeyOne(_u32(k.k0), _u32(k.k1), k.perm_coeff_src.numpy(),
                              _u32(k.perm_coeff_neg), k.perm_ntt.numpy(), k.galois_elt,
                              a_seed=k.a_seed, inv_form=k.inv_form)


def _ref_piece(p):
    return jboot.Piece(level=p.level, n1=p.n1, pt_scale=p.pt_scale, depth=p.depth,
                       giants=tuple((g, b, _u32(pts)) for g, b, pts in p.giants))


def _ref_set(keys):
    """The reference's BootKeys or BootKeysV2 holding a port set's arrays."""
    common = dict(gk=jring.GaloisKey({e: _ref_key(k) for e, k in keys.gk.keys.items()}),
                  rk=_ref_key(keys.rk), msg_scale=keys.msg_scale,
                  ctos_pieces=[_ref_piece(p) for p in keys.ctos_pieces],
                  stoc_pieces=[_ref_piece(p) for p in keys.stoc_pieces],
                  mult_i=tuple(_u32(t) for t in keys.mult_i),
                  mult_neg_i=tuple(_u32(t) for t in keys.mult_neg_i))
    if isinstance(keys, tboot.BootKeys):
        return jboot.BootKeys(cfg=jboot.BootConfig(**dataclasses.asdict(keys.cfg)), **common)
    swk = lambda k: None if k is None else _ref_key(k)
    return jext.BootKeysV2(cfg=jext.BootConfigV2(**dataclasses.asdict(keys.cfg)),
                           variant=keys.variant, cos_coeffs=keys.cos_coeffs,
                           swk_to_sparse=swk(keys.swk_to_sparse),
                           swk_to_dense=swk(keys.swk_to_dense), **common)


_GALOIS = ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt", "galois_elt",
           "inv_form", "a_seed")


def _piece_fields(p):
    return dict(level=p.level, n1=p.n1, pt_scale=p.pt_scale, depth=p.depth,
                giants=[(g, b, np.asarray(pts)) for g, b, pts in p.giants])


def _set_fields(k):
    """interop's keyword arguments for the reference's BootKeys or BootKeysV2."""
    rk = lambda kk: None if kk is None else {"k0": kk.k0, "k1": kk.k1, "a_seed": kk.a_seed}
    out = dict(gk={e: {f: getattr(g, f) for f in _GALOIS} for e, g in k.gk.keys.items()},
               rk=rk(k.rk), cfg=dataclasses.asdict(k.cfg), msg_scale=k.msg_scale,
               ctos_pieces=[_piece_fields(p) for p in k.ctos_pieces],
               stoc_pieces=[_piece_fields(p) for p in k.stoc_pieces],
               mult_i=list(k.mult_i), mult_neg_i=list(k.mult_neg_i), device="cpu")
    if isinstance(k, jext.BootKeysV2):
        out.update(variant=k.variant, cos_coeffs=k.cos_coeffs,
                   swk_to_sparse=rk(k.swk_to_sparse), swk_to_dense=rk(k.swk_to_dense))
    return out


def _port(name, obj):
    """interop's conversion of the reference's object `obj`."""
    if name == "boot_keys":
        return interop.boot_keys_from_numpy(**_set_fields(obj))
    if name == "boot_keys_v2":
        return interop.boot_keys_v2_from_numpy(**_set_fields(obj))
    if name == "boot_config":
        return tboot.BootConfig(**dataclasses.asdict(obj))
    if name == "boot_config_v2":
        return text.BootConfigV2(**dataclasses.asdict(obj))
    if name == "piece":
        return interop._boot_piece(_piece_fields(obj), "cpu")
    if name == "tfhe_boot_key":
        return interop.tfhe_boot_key_from_numpy(obj.bk, obj.ksk_a, obj.ksk_b, device="cpu")
    if name == "tfhe_boot_key2":
        return interop.tfhe_boot_key2_from_numpy(obj.bk2, obj.ksk_a, obj.ksk_b, device="cpu")
    if name == "huint":
        return interop.huint_from_numpy(obj.bits.a, obj.bits.b, obj.bits.variance, obj.width,
                                        obj.count, device="cpu")
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def port_sets():
    """The port's compressed BootKeys and BootKeysV2 (sparse switch keys
    too) at N=64, from one torch.Generator."""
    ctx = tckks.make_context(N, Q_BITS, device="cpu", **CTX_KW)
    g = trng.new_generator(8, "cpu")
    sk = tckks.keygen_secret(ctx, g, hamming_weight=16)
    v1 = tboot.generate_bootstrap_keys(ctx, g, sk, tboot.BootConfig(taylor_degree=3,
                                                                     exp_squarings=1),
                                       compress_keys=True)
    v2 = text.generate_bootstrap_keys_v2(ctx, g, tckks.keygen_secret(ctx, g), text.BootConfigV2(
        cos_degree=2, double_angles=1, K=12), sparse_hw=16, compress_keys=True)
    return v1, v2


@functools.lru_cache(maxsize=None)
def objects():
    """{name: (the reference's object, the port's)}."""
    v1, v2 = port_sets()
    r = np.random.default_rng(21)
    words = lambda *shape: np.asarray(r.integers(0, 2 ** 32, shape), np.uint32)
    n_big, base = 1024, 4
    ref = dict(boot_keys=_ref_set(v1), boot_keys_v2=_ref_set(v2),
               boot_config=jboot.BootConfig(taylor_degree=3, exp_squarings=1, base_count=2),
               boot_config_v2=jext.BootConfigV2(cos_degree=2, double_angles=1),
               piece=_ref_piece(v2.stoc_pieces[-1]),
               tfhe_boot_key=jtfhe.BootKey(words(LWE_N, 4, 2, 2, n_big),
                                           words(n_big, 8, base, LWE_N), words(n_big, 8, base)),
               tfhe_boot_key2=jtfhe.BootKey2(words(LWE_N // 2, 3, 4, 2, 2, n_big),
                                             words(n_big, 8, base, LWE_N), words(n_big, 8, base)),
               huint=jtint.HUint(jtfhe.Ciphertext(words(16, LWE_N), words(16), 0.375), 8, 2))
    return {name: (obj, _port(name, obj)) for name, obj in ref.items()}


NAMES = ["boot_keys", "boot_keys_v2", "boot_config", "boot_config_v2", "piece", "tfhe_boot_key",
         "tfhe_boot_key2", "huint"]


@pytest.mark.parametrize("name", NAMES)
def test_port_writes_the_reference_bytes(name):
    ref, port = objects()[name]
    assert tser.serialize(port) == jser.serialize(ref)


@pytest.mark.parametrize("name", NAMES)
def test_reference_bytes_load_in_the_port_and_back(name):
    ref, port = objects()[name]
    got = tser.deserialize(jser.serialize(ref), device="cpu")
    assert type(got) is type(port)
    _same(got, port)
    # the reference's loader makes every array a jax array, so under x64 off
    # it reads BootKeysV2.cos_coeffs back as float32: hold it to its own reload
    _same(jser.deserialize(tser.serialize(got)), jser.deserialize(jser.serialize(ref)))


def test_port_boot_keys_v2_round_trip():
    """The port's own BootKeysV2 (stripped keys, sparse switch keys, float64
    numpy cosine coefficients) and BootKeys, through the port's bytes."""
    for keys in port_sets():
        back = tser.deserialize(tser.serialize(keys), device="cpu")
        assert type(back) is type(keys)
        _same(back, keys)
        assert back.rk.k1 is None and back.rk.a_seed == keys.rk.a_seed
    v2 = port_sets()[1]
    back = tser.deserialize(tser.serialize(v2), device="cpu")
    assert isinstance(back.cos_coeffs, np.ndarray) and back.cos_coeffs.dtype == np.float64
    np.testing.assert_array_equal(back.cos_coeffs, v2.cos_coeffs)
    assert back.swk_to_sparse is not None and back.swk_to_dense is not None
    a = np.arange(5, dtype=np.float64)
    assert torch.equal(tser.deserialize(tser.serialize(a), device="cpu"), torch.from_numpy(a))


# (reference context, the port's make_context on the same parameters, the field
# of a prime list to doctor: one the rebuild derives rather than takes, as
# BFV takes its Q primes)
CONTEXTS = {
    "ckks_I": (lambda: jckks.make_context(N, [29, 25, 25, 25], sec_level="none"),
               lambda: tckks.make_context(N, [29, 25, 25, 25], sec_level="none", device="cpu"),
               "q_primes"),
    "ckks_II": (lambda: jckks.make_context(N, Q_BITS, **CTX_KW),
                lambda: tckks.make_context(N, Q_BITS, device="cpu", **CTX_KW), "p_primes"),
    "bfv": (lambda: jbfv.make_context(N, T, q_bits=[29, 29, 29], sec_level="none", ks_type="II",
                                      alpha=2),
            lambda: tbfv.make_context(N, T, q_bits=[29, 29, 29], sec_level="none", ks_type="II",
                                      alpha=2, device="cpu"), "p_primes"),
    "bgv": (lambda: jbgv.make_context(N, T, q_bits=[29, 29, 29], sec_level="none"),
            lambda: tbgv.make_context(N, T, q_bits=[29, 29, 29], sec_level="none",
                                      device="cpu"), "q_primes"),
    "tfhe": (lambda: jtfhe.make_context(LWE_N),
             lambda: ttfhe.make_context(LWE_N, device="cpu"), "primes"),
}


@functools.lru_cache(maxsize=None)
def context_bytes(name):
    return jser.serialize(CONTEXTS[name][0]())


def _array_paths(desc, path=""):
    """The dotted paths of a header's arrays, in blob order."""
    t = desc["t"]
    if t == "array":
        return [path]
    if t in ("tuple", "list"):
        return [p for i, d in enumerate(desc["items"]) for p in _array_paths(d, f"{path}[{i}]")]
    if t == "dict":
        return [p for k, v in zip(desc["keys"], desc["vals"])
                for p in _array_paths(v, f"{path}[{k}]")]
    if t == "obj":
        return [p for k, v in desc["fields"].items() for p in _array_paths(v, f"{path}.{k}")]
    return []


def _doctored(data, edit_header=None, flip_blob=None):
    """Serialized bytes with the header edited by edit_header(desc), or the
    first word of the blob at the dotted path flip_blob flipped."""
    raw = zlib.decompress(data)
    _, hlen = struct.unpack("<II", raw[4:12])
    desc = json.loads(raw[12:12 + hlen])
    if edit_header:
        edit_header(desc)
    header = json.dumps(desc).encode()
    body = bytearray(raw[12 + hlen:])
    if flip_blob:
        buf, starts = io.BytesIO(bytes(body)), []
        (count,) = struct.unpack("<I", buf.read(4))
        for _ in range(count):
            (ln,) = struct.unpack("<Q", buf.read(8))
            starts.append(buf.tell())
            buf.seek(ln, 1)
        body[starts[_array_paths(desc).index(flip_blob)]] ^= 1
    return zlib.compress(raw[:4] + struct.pack("<II", 1, len(header)) + header + bytes(body))


@pytest.mark.parametrize("name", CONTEXTS)
def test_reference_context_loads_rebuilt_and_checked(name):
    """The reference's context loads as the port's, equal in parameters and
    tables to the port's own context of the same parameters."""
    got = tser.deserialize(context_bytes(name), device="cpu")
    want = CONTEXTS[name][1]()
    assert type(got) is type(want) and got.device.type == "cpu"
    ref = CONTEXTS[name][0]()
    ntt = "ntt" if name == "tfhe" else "ntt_qp"
    for field in ("n", CONTEXTS[name][2], "sec_level", "default_scale", "ks_type", "alpha", "t"):
        if hasattr(ref, field):
            assert getattr(got, field) == getattr(ref, field) == getattr(want, field), field
    for table in ("psi", "tw_mat", "itw_mat_sh"):
        a = getattr(getattr(got, ntt), table)
        assert torch.equal(a, getattr(getattr(want, ntt), table)), table
        np.testing.assert_array_equal(interop.to_numpy(a), np.asarray(getattr(getattr(ref, ntt),
                                                                                 table)))


@pytest.mark.parametrize("name", CONTEXTS)
def test_doctored_reference_context_raises(name):
    """One prime of the stored list changed (the rebuild from the parameters
    still gives the original), or one word of the stored psi table flipped:
    ValueError naming the field."""
    field = CONTEXTS[name][2]

    def swap_prime(desc):
        item = desc["fields"][field]["items"][-1]
        item["v"] = int(item["v"]) - 2 * N
    with pytest.raises(ValueError, match=field):
        tser.deserialize(_doctored(context_bytes(name), edit_header=swap_prime), device="cpu")
    psi = ".ntt.psi" if name == "tfhe" else ".ntt_qp.psi"
    with pytest.raises(ValueError, match=psi.replace(".", r"\.") + ": the stored table differs"):
        tser.deserialize(_doctored(context_bytes(name), flip_blob=psi), device="cpu")


def test_reference_compressed_keys_expand_in_the_port():
    """A relin key and Galois keys of the reference, seeded as its compressed
    sets seed them (2^34 + 5, 2^43 + j: PRNGKey keeps the seed mod 2^32, as
    threefry.key_from_seed does), stripped and written by the reference,
    load stripped in the port and expand there to the reference's halves."""
    for seed in (2 ** 34 + 5, 2 ** 43 + 1, 2 ** 44):
        assert ttf.key_from_seed(seed) == tuple(int(w) for w in
                                                np.asarray(jax.random.PRNGKey(seed)))
    jctx = jckks.make_context(N, [29, 25, 25], sec_level="none", ks_type="II", alpha=2)
    tctx = tckks.make_context(N, [29, 25, 25], sec_level="none", ks_type="II", alpha=2,
                              device="cpu")
    sk = jckks.keygen_secret(jctx, jrng.new_key(3))
    rk = jckks.keygen_relin(jctx, jrng.new_key(4), sk, a_seed=2 ** 34 + 5)
    gk = jckks.keygen_galois(jctx, jrng.new_key(5), sk, steps=[1, 2], a_seed=2 ** 43 + 1)
    ring = jckks._ring(jctx)
    for full in (rk, gk):
        stripped = jring.strip_seeded(full)
        got = tser.deserialize(jser.serialize(stripped), device="cpu")
        halves = [got] if isinstance(got, tring.KSKey) else list(got.keys.values())
        assert all(h.k1 is None for h in halves)
        _same(tring.expand_seeded(got, tckks._ring(tctx)), jring.expand_seeded(stripped, ring))
        _same(tring.expand_seeded(got, tckks._ring(tctx)), full)


@pytest.mark.parametrize("path", [
    "heongpu_tpu.models.ckks_boot:build_dft_pieces",   # a reference function
    "heongpu_tpu.models.ckks:make_context",
    "heongpu_tpu.models.tfhe:FusedKey",                # a reference class outside the tables
    "heongpu_tpu.models.ckks_boot:BootKeys.out_level",
])
def test_loader_refuses_reference_paths_outside_its_tables(path):
    data = jser.serialize(objects()["boot_config"][0])
    raw = zlib.decompress(data).replace(b"heongpu_tpu.models.ckks_boot:BootConfig",
                                        path.encode())
    _, hlen = struct.unpack("<II", zlib.decompress(data)[4:12])
    hlen += len(path) - len("heongpu_tpu.models.ckks_boot:BootConfig")
    fixed = raw[:4] + struct.pack("<II", 1, hlen) + raw[12:]
    with pytest.raises(ValueError):
        tser.deserialize(zlib.compress(fixed), device="cpu")
