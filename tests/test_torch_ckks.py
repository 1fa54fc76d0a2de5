"""Port parity for the CKKS slice: multiply -> relinearize -> rescale ->
decrypt -> decode at N=1024, [29]*6, Method II alpha=2.

The reference's context is rebuilt by the port from the same parameters
(primes, default_scale and tables must agree); its Threefry keys and
ciphertexts are carried over with `interop`, and the residues must be
bit-identical after every op.  The port's own run (torch.Generator keys)
must decode within 1e-3, and importing the port must not import jax."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

N, Q_BITS, ALPHA = 1024, [29] * 6, 2
Z = np.linspace(-1.0, 1.0, N // 2)


def _np(t):
    return interop.to_numpy(t)


@pytest.fixture(scope="module")
def chain():
    """One reference chain and the port's context, keys and inputs."""
    jctx = jckks.make_context(N, Q_BITS, ks_type="II", alpha=ALPHA)
    sk = jckks.keygen_secret(jctx, jrng.new_key(1))
    pk = jckks.keygen_public(jctx, jrng.new_key(2), sk)
    rk = jckks.keygen_relin(jctx, jrng.new_key(3), sk)
    ct1 = jckks.encrypt(jctx, pk, jckks.encode_host(jctx, Z), jrng.new_key(4))
    ct2 = jckks.encrypt(jctx, pk, jckks.encode_host(jctx, Z[::-1].copy()), jrng.new_key(5))
    m = jckks.multiply(jctx, ct1, ct2)
    r = jckks.relinearize(jctx, m, rk)
    s = jckks.rescale(jctx, r)
    d = jckks.decrypt(jctx, sk, s)
    ref = dict(ctx=jctx, sk=sk, pk=pk, rk=rk, ct1=ct1, ct2=ct2, mul=m, relin=r,
               rescale=s, dec=d, decoded=jckks.decode_host(jctx, d))
    tctx = tckks.make_context(N, Q_BITS, ks_type="II", alpha=ALPHA, device="cpu")
    port = dict(
        ctx=tctx,
        sk=interop.secret_key_from_numpy(np.asarray(sk.s_coeff), np.asarray(sk.s_ntt_mont_qp),
                                         sk.hamming_weight, device="cpu"),
        rk=interop.ks_key_from_numpy(np.asarray(rk.k0), np.asarray(rk.k1), device="cpu"),
        ct1=interop.ciphertext_from_numpy(np.asarray(ct1.c), 2, 0, ct1.scale, device="cpu"),
        ct2=interop.ciphertext_from_numpy(np.asarray(ct2.c), 2, 0, ct2.scale, device="cpu"))
    return ref, port


def test_context_matches(chain):
    ref, port = chain
    j, t = ref["ctx"], port["ctx"]
    assert t.q_primes == j.q_primes and t.p_primes == j.p_primes
    assert t.default_scale == j.default_scale
    assert [lv.groups for lv in t.ks2] == [lv.groups for lv in j.ks2]
    for f in ("tw_mat", "itw_mat", "psi"):
        np.testing.assert_array_equal(_np(getattr(t.ntt_qp, f)), np.asarray(getattr(j.ntt_qp, f)))
    for a, b in zip(t.ntt_qp.tw1 + t.ntt_qp.itw2, j.ntt_qp.tw1 + j.ntt_qp.itw2):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(_np(t.slot_to_ntt), np.asarray(j.slot_to_ntt))
    np.testing.assert_array_equal(_np(t.conj_perm), np.asarray(j.conj_perm))
    lv = t.ks2[1]
    np.testing.assert_array_equal(_np(lv.convs[-1].mat_mont),
                                  np.asarray(j.ks2[1].convs[-1].mat_mont))
    np.testing.assert_array_equal(_np(t.ntt_qp_at(1).tw_mat), np.asarray(j.ntt_qp_at(1).tw_mat))
    np.testing.assert_array_equal(_np(t.base_qp_at(2).mu), np.asarray(j.base_qp_at(2).mu))
    np.testing.assert_array_equal(_np(t.div_p_at(2).pinv_mod), np.asarray(j.div_p_at(2).pinv_mod))


def test_ops_match_reference_residues(chain):
    ref, port = chain
    ctx = port["ctx"]
    m = tckks.multiply(ctx, port["ct1"], port["ct2"])
    np.testing.assert_array_equal(_np(m.c), np.asarray(ref["mul"].c))
    r = tckks.relinearize(ctx, m, port["rk"])
    np.testing.assert_array_equal(_np(r.c), np.asarray(ref["relin"].c))
    s = tckks.rescale(ctx, r)
    assert (s.level, s.scale) == (ref["rescale"].level, ref["rescale"].scale)
    np.testing.assert_array_equal(_np(s.c), np.asarray(ref["rescale"].c))
    d = tckks.decrypt(ctx, port["sk"], s)
    np.testing.assert_array_equal(_np(d.m), np.asarray(ref["dec"].m))
    got = tckks.decode_host(ctx, d)
    np.testing.assert_array_equal(got, ref["decoded"])
    assert np.abs(got - Z * Z[::-1]).max() < 1e-3
    # size-3 decrypt and the leveled linear ops agree too
    np.testing.assert_array_equal(
        _np(tckks.decrypt(ctx, port["sk"], m).m),
        np.asarray(jckks.decrypt(ref["ctx"], ref["sk"], ref["mul"]).m))


def test_linear_ops_match_reference(chain):
    ref, port = chain
    jctx, ctx = ref["ctx"], port["ctx"]
    a, b = port["ct1"], port["ct2"]
    ja, jb = ref["ct1"], ref["ct2"]
    pt = tckks.encode(ctx, Z, scale=a.scale)
    jpt = jckks.encode_host(jctx, Z, scale=ja.scale)
    np.testing.assert_array_equal(_np(pt.m), np.asarray(jpt.m))
    pairs = [
        (tckks.add(ctx, a, b), jckks.add(jctx, ja, jb)),
        (tckks.sub(ctx, a, b), jckks.sub(jctx, ja, jb)),
        (tckks.negate(ctx, a), jckks.negate(jctx, ja)),
        (tckks.add_plain(ctx, a, pt), jckks.add_plain(jctx, ja, jpt)),
        (tckks.multiply_plain(ctx, a, pt), jckks.multiply_plain(jctx, ja, jpt)),
        (tckks.mod_drop(ctx, a, 2), jckks.mod_drop(jctx, ja, 2)),
        # size-3 + size-2 pads the shorter operand (scale reset to match)
        (tckks.add(ctx, tckks.Ciphertext(tckks.multiply(ctx, a, b).c, 3, 0, a.scale), a),
         jckks.add(jctx, jckks.Ciphertext(jckks.multiply(jctx, ja, jb).c, 3, 0, ja.scale), ja)),
    ]
    for got, want in pairs:
        assert (got.size, got.level, got.scale) == (want.size, want.level, want.scale)
        np.testing.assert_array_equal(_np(got.c), np.asarray(want.c))


def test_interop_carries_keys_and_plaintexts(chain):
    ref, port = chain
    pk = interop.public_key_from_numpy(np.asarray(ref["pk"].pk0), np.asarray(ref["pk"].pk1),
                                       device="cpu")
    np.testing.assert_array_equal(interop.to_numpy(pk.pk0), np.asarray(ref["pk"].pk0))
    np.testing.assert_array_equal(interop.to_numpy(pk.pk1), np.asarray(ref["pk"].pk1))
    d = ref["dec"]
    pt = interop.plaintext_from_numpy(np.asarray(d.m), d.level, d.scale, device="cpu")
    np.testing.assert_array_equal(tckks.decode_host(port["ctx"], pt), ref["decoded"])
    sk = port["sk"]
    np.testing.assert_array_equal(sk.s_coeff.numpy(), np.asarray(ref["sk"].s_coeff))
    assert sk.s_coeff.dtype == torch.int32 and sk.hamming_weight == ref["sk"].hamming_weight


def test_port_own_run_decodes():
    ctx = tckks.make_context(N, Q_BITS, ks_type="II", alpha=ALPHA, device="cpu")
    g = trng.new_generator(7, "cpu")
    sk = tckks.keygen_secret(ctx, g)
    pk = tckks.keygen_public(ctx, g, sk)
    rk = tckks.keygen_relin(ctx, g, sk)
    c1 = tckks.encrypt(ctx, pk, tckks.encode(ctx, Z), g)
    c2 = tckks.encrypt(ctx, pk, tckks.encode(ctx, Z[::-1].copy()), g)
    out = tckks.rescale(ctx, tckks.relinearize(ctx, tckks.multiply(ctx, c1, c2), rk))
    got = tckks.decode(ctx, tckks.decrypt(ctx, sk, out))
    assert np.isfinite(got).all() and got.shape == (N // 2,)
    assert np.abs(got - Z * Z[::-1]).max() < 1e-3


def test_port_rejects_misuse(chain):
    _, port = chain
    ctx = port["ctx"]
    m = tckks.multiply(ctx, port["ct1"], port["ct2"])
    with pytest.raises(tckks.errors.CipherSizeError):
        tckks.multiply(ctx, m, port["ct1"])
    with pytest.raises(tckks.errors.LevelMismatchError):
        tckks.add(ctx, tckks.mod_drop(ctx, port["ct1"]), port["ct2"])
    with pytest.raises(tckks.errors.ParameterError):
        tckks.make_context(N, Q_BITS, ks_type="III", device="cpu")


def test_port_imports_no_jax():
    """Every module of heongpu_tpu_torch, imported in a fresh interpreter,
    loads neither jax nor the JAX package; the walk reaches the
    bootstrapping modules, BFV, the logic gates, the sharded bootstrap and
    the sharded bootstrapping variants."""
    code = ("import importlib, pkgutil, sys, heongpu_tpu_torch as pkg; "
            "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'heongpu_tpu_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "bad = [m for m in sys.modules if m in ('jax', 'heongpu_tpu') "
            "or m.startswith(('jax.', 'heongpu_tpu.'))]; "
            "need = {'heongpu_tpu_torch.' + m for m in "
            "('models.ckks_boot', 'models.ckks_boot_ext', 'models.poly_eval', 'models.bfv', "
            "'models.logic', 'parallel.ckks_sharded', 'parallel.boot_sharded', "
            "'parallel.boot_ext_sharded')}; "
            "print(len(mods), bad, need - set(mods)); "
            "sys.exit(1 if bad or len(mods) < 20 or need - set(mods) else 0)")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's import statements name neither jax nor the JAX
    package (read with ast, not run)."""
    import ast
    tree = ast.parse((Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "heongpu_tpu_torch.models" in names
    bad = [m for m in names if m.split(".")[0] in ("jax", "heongpu_tpu")]
    assert not bad, bad
