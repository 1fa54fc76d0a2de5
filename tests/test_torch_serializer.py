"""The port's serializer against the JAX package's on the CPU.

Objects of the reference at N=256 (a CKKS secret, public, relin and
Galois key, plaintext and ciphertext; a BFV and a BGV ciphertext and a BFV
plaintext; MPC's pk share, relin round-1 share and ephemeral secret, and a
Shamir ThresholdShare; a TFHE secret key and ciphertext) carried into
the port by interop: the port writes the reference's bytes for each
(identical framing, header and blobs); the reference's bytes load in the
port equal to interop's conversion, field for field, and the port's bytes
load in the reference equal to the original; files round-trip both ways.
Port contexts round-trip within the port and still compute.  Malformed
input raises ValueError."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from heongpu_tpu.models import bfv as jbfv  # noqa: E402
from heongpu_tpu.models import bgv as jbgv  # noqa: E402
from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import mpc as jmpc  # noqa: E402
from heongpu_tpu.models import ringkit as jring  # noqa: E402
from heongpu_tpu.models import tfhe as jtfhe  # noqa: E402
from heongpu_tpu.ops import polyops as jpoly  # noqa: E402
from heongpu_tpu.utils import params as jparams  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu.utils import serializer as jser  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import bfv as tbfv  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import mpc as tmpc  # noqa: E402
from heongpu_tpu_torch.models import ringkit as tring  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402
from heongpu_tpu_torch.utils import serializer as tser  # noqa: E402

torch.set_num_threads(2)

N = 256
T = jparams.plain_modulus_for(N, 16)


def _port(name, obj):
    """interop's conversion of the reference's object `obj`."""
    cpu = dict(device="cpu")
    if name == "sk":
        return interop.secret_key_from_numpy(obj.s_coeff, obj.s_ntt_mont_qp, obj.hamming_weight, **cpu)
    if name == "pk":
        return interop.public_key_from_numpy(obj.pk0, obj.pk1, obj.a_seed, **cpu)
    if name == "rk":
        return interop.ks_key_from_numpy(obj.k0, obj.k1, obj.a_seed, **cpu)
    if name == "gk":
        return interop.galois_key_from_numpy(
            {e: {f: getattr(k, f) for f in ("k0", "k1", "perm_coeff_src", "perm_coeff_neg",
                                            "perm_ntt", "galois_elt", "inv_form", "a_seed")}
             for e, k in obj.keys.items()}, **cpu)
    if name == "pt":
        return interop.plaintext_from_numpy(obj.m, obj.level, obj.scale, **cpu)
    if name == "ct":
        return interop.ciphertext_from_numpy(obj.c, obj.size, obj.level, obj.scale, **cpu)
    if name == "bfv_ct":
        return interop.bfv_ciphertext_from_numpy(obj.c, obj.size, obj.in_ntt, **cpu)
    if name == "bgv_ct":
        return interop.bgv_ciphertext_from_numpy(obj.c, obj.size, obj.level, obj.factor, **cpu)
    if name in ("bfv_pt", "pk_share"):
        return interop._t(np.asarray(obj), "cpu")
    if name == "round1":
        return tuple(interop._t(np.asarray(x), "cpu") for x in obj)
    if name == "eph":
        return interop.relin_ephemeral_from_numpy(obj.u_mont, **cpu)
    if name == "share":
        return interop.threshold_share_from_numpy(obj.index, obj.threshold, obj.s_ntt_mont_qp,
                                                  **cpu)
    if name == "tfhe_sk":
        return interop.tfhe_secret_key_from_numpy(obj.lwe, obj.rlwe, **cpu)
    if name == "tfhe_ct":
        return interop.tfhe_ciphertext_from_numpy(obj.a, obj.b, obj.variance, **cpu)
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def objects():
    """{name: (the reference's object, the port's)}.  The CKKS keys,
    plaintext and ciphertext, the pk share and the Shamir share are the
    reference's own; the rest hold random words of their real shapes and
    dtypes (the reference's keygens for them are slow, and the wire does not
    care)."""
    ctx = jckks.make_context(N, [29, 25, 25], sec_level="none")
    sk = jckks.keygen_secret(ctx, jrng.new_key(4))
    pk = jckks.keygen_public(ctx, jrng.new_key(5), sk)
    rk = jckks.keygen_relin(ctx, jrng.new_key(6), sk)
    pt = jckks.encode(ctx, np.linspace(-1, 1, N // 2))
    ct = jax.jit(jckks.encrypt)(ctx, pk, pt, jrng.new_key(7))
    ring = jckks._ring(ctx)
    a = jmpc.crs_uniform(ring, 777, (N,))
    r = np.random.default_rng(3)
    words = lambda *shape: np.asarray(r.integers(0, 2 ** 29, shape), np.uint32)
    g = jpoly.steps_to_galois_elt(1, N)
    gk = jring.GaloisKey({g: jring.GaloisKeyOne(
        words(3, 4, N), words(3, 4, N), *jpoly.galois_perm_coeff(g, N),
        jpoly.galois_perm_ntt(g, N), g, a_seed=2 ** 34 + 1, inv_form=True)})
    ref = dict(sk=sk, pk=pk, rk=rk, gk=gk, pt=pt, ct=ct,
               bfv_ct=jbfv.Ciphertext(words(2, 2, N), 2, False), bfv_pt=words(N),
               bgv_ct=jbgv.Ciphertext(words(3, 3, N), 3, 1, 7),
               pk_share=jmpc.pk_share(ring, sk, a, jrng.new_key(10)),
               round1=(words(3, 4, N), words(3, 4, N)), eph=jmpc.RelinEphemeral(words(4, N)),
               share=jmpc.shamir_share_secret(ctx, jrng.new_key(13), sk, 3, 2)[1],
               tfhe_sk=jtfhe.SecretKey(words(16) & 1, words(64) & 1),
               tfhe_ct=jtfhe.Ciphertext(np.asarray(r.integers(0, 2 ** 32, (3, 16)), np.uint32),
                                        np.asarray(r.integers(0, 2 ** 32, 3), np.uint32), 0.125))
    return {name: (obj, _port(name, obj)) for name, obj in ref.items()}


def _leaves(obj):
    """(path, value) pairs of an object of either package: arrays as numpy
    (the port's int32 residues as uint32 where the reference's are), scalars
    as they are."""
    if isinstance(obj, (tuple, list)):
        return [(f"[{i}]{p}", v) for i, x in enumerate(obj) for p, v in _leaves(x)]
    if isinstance(obj, dict):
        return [(f"[{k}]{p}", v) for k, x in sorted(obj.items(), key=lambda kv: str(kv[0]))
                for p, v in _leaves(x)]
    if obj is None or isinstance(obj, (int, float, str, bool)):
        return [("", obj)]
    if isinstance(obj, torch.Tensor):
        return [("", obj.numpy())]
    if hasattr(obj, "shape"):
        return [("", np.asarray(obj))]
    fields = obj.__dataclass_fields__ if hasattr(obj, "__dataclass_fields__") else ("keys",)
    return [(f".{k}{p}", v) for k in sorted(fields) for p, v in _leaves(getattr(obj, k))]


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape, path
            if x.dtype != y.dtype:      # int32 residue tensors against uint32 arrays
                x, y = x.view(np.uint32), y.view(np.uint32)
            np.testing.assert_array_equal(x, y, err_msg=path)
        else:
            assert x == y, path


NAMES = ["sk", "pk", "rk", "gk", "pt", "ct", "bfv_ct", "bfv_pt", "bgv_ct", "pk_share",
         "round1", "eph", "share", "tfhe_sk", "tfhe_ct"]


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
    _same(jser.deserialize(tser.serialize(got)), ref)


def test_files_round_trip_both_ways(tmp_path):
    ref, port = objects()["ct"]
    jser.save_to_file(ref, str(tmp_path / "ref.bin"))
    tser.save_to_file(port, str(tmp_path / "port.bin"))
    assert (tmp_path / "ref.bin").read_bytes() == (tmp_path / "port.bin").read_bytes()
    _same(tser.load_from_file(str(tmp_path / "ref.bin"), device="cpu"), port)
    _same(jser.load_from_file(str(tmp_path / "port.bin")), ref)


def test_loaded_keys_decrypt_in_the_port():
    """The reference's secret key and ciphertext, loaded from its bytes,
    decrypt in the port to the reference's decryption."""
    objs = objects()
    sk = tser.deserialize(jser.serialize(objs["sk"][0]), device="cpu")
    ct = tser.deserialize(jser.serialize(objs["ct"][0]), device="cpu")
    ctx = tckks.make_context(N, [29, 25, 25], sec_level="none", device="cpu")
    got = tckks.decode(ctx, tckks.decrypt(ctx, sk, ct))
    np.testing.assert_allclose(got.real, np.linspace(-1, 1, N // 2), atol=1e-3)


def test_port_contexts_round_trip_within_the_port():
    cctx = tckks.make_context(N, [29, 25, 25], sec_level="none", device="cpu")
    back = tser.deserialize(tser.serialize(cctx), device="cpu")
    assert back.q_primes == cctx.q_primes and back.n == cctx.n and back.device.type == "cpu"
    assert torch.equal(back.ntt_qp.p, cctx.ntt_qp.p)
    bctx = tbfv.make_context(N, T, q_bits=[29, 29], sec_level="none", device="cpu")
    bback = tser.deserialize(tser.serialize(bctx), device="cpu")
    key = trng.new_key(1, "cpu")
    sk = tbfv.keygen_secret(bback, key)
    pk = tbfv.keygen_public(bback, key, sk)
    m = np.arange(N) % T
    ct = tbfv.encrypt(bctx, pk, tbfv.encode(bctx, m), key)
    np.testing.assert_array_equal(tbfv.decode(bback, tbfv.decrypt(bback, sk, ct)),
                                  m.astype(np.uint32))


def test_mpc_shares_survive_the_wire():
    """A party's pk share and Shamir share made by the port, through bytes,
    assemble and decrypt as the originals do."""
    ctx = tbfv.make_context(N, T, q_bits=[29, 29], sec_level="none", device="cpu")
    ring = tbfv._ring(ctx)
    sks = [tring.keygen_secret(ring, trng.new_key(20 + i, "cpu")) for i in range(2)]
    a = tmpc.crs_uniform(ring, 5, (N,))
    wire = lambda x: tser.deserialize(tser.serialize(x), device="cpu")
    shares = [wire(tmpc.pk_share(ring, sk, a, trng.new_key(30 + i, "cpu")))
              for i, sk in enumerate(sks)]
    pk = tmpc.pk_assemble(ring, shares, a)
    m = np.arange(N) % T
    ct = wire(tbfv.encrypt(ctx, pk, tbfv.encode(ctx, m), trng.new_key(40, "cpu")))
    parts = [wire(tmpc.bfv_decrypt_partial(ctx, sk, ct, trng.new_key(50 + i, "cpu")))
             for i, sk in enumerate(sks)]
    np.testing.assert_array_equal(tbfv.decode(ctx, tmpc.bfv_decrypt_fuse(ctx, ct, parts)),
                                  m.astype(np.uint32))
    share = tmpc.shamir_share_secret(ctx, trng.new_key(60, "cpu"), sks[0], 3, 2)[2]
    back = wire(share)
    assert (back.index, back.threshold) == (3, 2)
    assert torch.equal(back.s_ntt_mont_qp, share.s_ntt_mont_qp)


def test_malformed_input_raises():
    import zlib
    with pytest.raises(ValueError, match="magic"):
        tser.deserialize(zlib.compress(b"XXXX" + bytes(16)), device="cpu")
    raw = zlib.decompress(jser.serialize(objects()["eph"][0])).replace(b"mpc:RelinEphemeral", b"mpc:RelinEphemerax")
    with pytest.raises(ValueError, match="no port class"):
        tser.deserialize(zlib.compress(raw), device="cpu")
    with pytest.raises(TypeError):
        tser.serialize(object())


def _renamed(data, old, new):
    """Serialized bytes with the class path `old` in their header replaced
    by `new`, the header length adjusted."""
    import struct
    import zlib
    raw = zlib.decompress(data)
    version, hlen = struct.unpack("<II", raw[4:12])
    header = raw[12:12 + hlen].replace(old.encode(), new.encode())
    return zlib.compress(raw[:4] + struct.pack("<II", version, len(header)) + header
                         + raw[12 + hlen:])


@pytest.mark.parametrize("path", [
    "heongpu_tpu_torch.utils.rng:os.system",              # a function behind a module attribute
    "heongpu_tpu_torch.models.mpc:ringkit.SecretKey",     # a port class behind a module attribute
    "heongpu_tpu_torch.models.mpc:torch.Tensor",          # a class that is not the port's
    "heongpu_tpu_torch.models.mpc:crs_uniform",           # a port function
    "heongpu_tpu_torch.utils.serializer:port_table",
    "os:system",
])
def test_loader_builds_only_table_classes(path):
    """A header naming anything but a class of the two tables raises
    ValueError before anything is called; the same bytes under the real
    path load."""
    data = tser.serialize(objects()["eph"][1])
    ref_path = "heongpu_tpu.models.mpc:RelinEphemeral"
    assert type(tser.deserialize(_renamed(data, ref_path, ref_path), device="cpu")) is \
        tmpc.RelinEphemeral
    with pytest.raises(ValueError):
        tser.deserialize(_renamed(data, ref_path, path), device="cpu")
