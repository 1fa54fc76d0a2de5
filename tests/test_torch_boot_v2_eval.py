"""Port parity for the CKKS bootstrapping variants (models/ckks_boot_ext.py),
part 2: the exact-integer evaluation, bit for bit against the JAX package on
the CPU.

For each variant the port makes one key set (a torch.Generator, the float64
encoder), the test builds the JAX package's BootKeysV2 from the same arrays,
and `interop.boot_keys_v2_from_numpy` carries that object back into the
port.  Everything downstream of the diagonals is exact, so eval_cos_engine,
regular_bootstrap_v2, slim_bootstrap, bit_bootstrap, gate_bootstrap, the
sparse-switch mod-raise and a less-key-mode matvec_piece must return the
reference's residues and metadata on the same input residues.

The reference runs each entry point under one jax.jit (`_ref`): op by op,
its cost on the CPU is the XLA compilation of each op at each distinct limb
count, about three times the one program's, which the suite's compilation
cache then keeps; the arithmetic is exact, so the residues are the same.  The
chain's length sets that cost, so the configuration is the smallest that runs every
code path of the module: N=64, nine primes ([29] + [28]*8), Method II with
alpha 4 (digits of 4, 4 and 1 limbs: a partial last digit, as at N=2^16)
and p_count 6, a degree-2 cosine (the giant-step split and the constant-only
block of poly_eval) and one double angle.  The v2 chain itself
([29] + [28]*18, degree 24, five double angles) is held in
tests/test_torch_poly_eval.py (the power basis and the cosine polynomial)
and tests/test_torch_boot_v2.py (the port's own variants within the
reference's limits)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import ckks_boot as jboot  # noqa: E402
from heongpu_tpu.models import ckks_boot_ext as jext  # noqa: E402
from heongpu_tpu.models import ringkit as jringkit  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot as tboot  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot_ext as text  # noqa: E402
from heongpu_tpu_torch.ops import polyops as tpoly  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402

torch.set_num_threads(2)

N = 64
Q_BITS = [29] + [28] * 8
CTX_KW = dict(scale_bits=28, sec_level="none", ks_type="II", alpha=4, p_count=6)
CFG = dict(cos_degree=2, double_angles=1, K=12)


def _np(t):
    return interop.to_numpy(t)


def _j(t):
    return jnp.asarray(_np(t))


def _reference_keys(keys):
    """The JAX package's BootKeysV2 holding the port keys' arrays."""
    gk = jringkit.GaloisKey({
        elt: jringkit.GaloisKeyOne(
            k0=_j(k.k0), k1=_j(k.k1), perm_coeff_src=jnp.asarray(k.perm_coeff_src.numpy()),
            perm_coeff_neg=jnp.asarray(k.perm_coeff_neg.numpy().astype(np.uint32)),
            perm_ntt=jnp.asarray(k.perm_ntt.numpy()), galois_elt=k.galois_elt,
            inv_form=k.inv_form)
        for elt, k in keys.gk.keys.items()})
    piece = lambda p: jboot.Piece(level=p.level, n1=p.n1, pt_scale=p.pt_scale, depth=p.depth,
                                  giants=tuple((g, b, _j(pts)) for g, b, pts in p.giants))
    swk = lambda k: None if k is None else jringkit.KSKey(_j(k.k0), _j(k.k1))
    return jext.BootKeysV2(
        gk=gk, rk=jringkit.KSKey(_j(keys.rk.k0), _j(keys.rk.k1)),
        cfg=jext.BootConfigV2(**dataclasses.asdict(keys.cfg)), msg_scale=keys.msg_scale,
        variant=keys.variant, ctos_pieces=[piece(p) for p in keys.ctos_pieces],
        stoc_pieces=[piece(p) for p in keys.stoc_pieces],
        mult_i=tuple(_j(t) for t in keys.mult_i), mult_neg_i=tuple(_j(t) for t in keys.mult_neg_i),
        cos_coeffs=keys.cos_coeffs, swk_to_sparse=swk(keys.swk_to_sparse),
        swk_to_dense=swk(keys.swk_to_dense))


def _carried(jkeys):
    """The reference's BootKeysV2 carried into the port."""
    fields = ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt", "galois_elt",
              "inv_form")
    piece = lambda p: dict(level=p.level, n1=p.n1, pt_scale=p.pt_scale, depth=p.depth,
                           giants=[(g, b, np.asarray(pts)) for g, b, pts in p.giants])
    swk = lambda k: None if k is None else {"k0": np.asarray(k.k0), "k1": np.asarray(k.k1)}
    return interop.boot_keys_v2_from_numpy(
        gk={e: {f: np.asarray(getattr(k, f)) for f in fields} for e, k in jkeys.gk.keys.items()},
        rk={"k0": np.asarray(jkeys.rk.k0), "k1": np.asarray(jkeys.rk.k1)},
        cfg=dataclasses.asdict(jkeys.cfg), msg_scale=jkeys.msg_scale, variant=jkeys.variant,
        ctos_pieces=[piece(p) for p in jkeys.ctos_pieces],
        stoc_pieces=[piece(p) for p in jkeys.stoc_pieces],
        mult_i=[np.asarray(t) for t in jkeys.mult_i],
        mult_neg_i=[np.asarray(t) for t in jkeys.mult_neg_i], cos_coeffs=jkeys.cos_coeffs,
        swk_to_sparse=swk(jkeys.swk_to_sparse), swk_to_dense=swk(jkeys.swk_to_dense),
        device="cpu")


def _ref(fn, *cts):
    """The reference's fn(*cts) on ciphertexts, compiled as one program."""
    return jax.jit(fn)(*cts)


def _same(got, want):
    assert (got.size, got.level, got.scale) == (want.size, want.level, want.scale)
    np.testing.assert_array_equal(_np(got.c), np.asarray(want.c))


@pytest.fixture(scope="module")
def sides():
    """Both contexts, the port's key sets by variant (made once), their
    reference and carried forms, and a maker of random input residues."""
    tctx = tckks.make_context(N, Q_BITS, device="cpu", **CTX_KW)
    jctx = jckks.make_context(N, Q_BITS, **CTX_KW)
    g = trng.new_generator(5, "cpu")
    sk = tckks.keygen_secret(tctx, g, hamming_weight=16)
    dense = tckks.keygen_secret(tctx, g)
    cfg = text.BootConfigV2(**CFG)
    made = {
        "regular": dict(variant="regular"),
        "slim": dict(variant="slim", msg_scale=2.0 ** 22),
        "bit": dict(variant="bit"),
        "gate": dict(variant="gate"),
        "sparse": dict(variant="regular", sparse_hw=16),
        "less_key": dict(variant="regular", less_key_mode=True),
    }
    keys = {}
    for name, kw in made.items():
        tk = text.generate_bootstrap_keys_v2(tctx, g, dense if name == "sparse" else sk, cfg, **kw)
        jk = _reference_keys(tk)
        keys[name] = (tk, jk, _carried(jk))
    r = np.random.default_rng(5)

    def residues(level, scale):
        """The same uniform residues at `level` on both sides (every block is
        exact, so any residues serve)."""
        c = np.stack([r.integers(0, int(q), (2, N)) for q in tctx.q_primes[:tctx.k - level]],
                     axis=1).astype(np.uint32)
        return (interop.ciphertext_from_numpy(c, 2, level, scale, device="cpu"),
                jckks.Ciphertext(jnp.asarray(c), 2, level, scale))

    return tctx, jctx, keys, residues


def test_keys_v2_carried_across_unchanged(sides):
    _, _, keys, _ = sides
    for tk, _, ck in keys.values():
        assert (ck.cfg, ck.msg_scale, ck.variant) == (tk.cfg, tk.msg_scale, tk.variant)
        np.testing.assert_array_equal(ck.cos_coeffs, tk.cos_coeffs)
        assert set(ck.gk.keys) == set(tk.gk.keys)
        for elt, k in tk.gk.keys.items():
            for f in ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt"):
                assert torch.equal(getattr(ck.gk.keys[elt], f), getattr(k, f))
        for tp, cp in zip(tk.ctos_pieces + tk.stoc_pieces, ck.ctos_pieces + ck.stoc_pieces):
            assert (tp.level, tp.n1, tp.pt_scale, tp.depth) == (cp.level, cp.n1, cp.pt_scale,
                                                                cp.depth)
            for (g, b, pts), (cg, cb, cpts) in zip(tp.giants, cp.giants):
                assert (g, b) == (cg, cb) and torch.equal(pts, cpts)
        for a, b in ((tk.swk_to_sparse, ck.swk_to_sparse), (tk.swk_to_dense, ck.swk_to_dense)):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a.k0, b.k0) and torch.equal(a.k1, b.k1)
    assert keys["sparse"][2].swk_to_dense is not None


def test_regular_bootstrap_v2_matches_reference(sides):
    tctx, jctx, keys, residues = sides
    _, jk, ck = keys["regular"]
    t, j = residues(tctx.k - 1, ck.msg_scale)
    out = text.regular_bootstrap_v2(tctx, t, ck)
    _same(out, _ref(lambda c: jext.regular_bootstrap_v2(jctx, c, jk), j))
    assert out.level == ck.stoc_pieces[-1].level + 1
    # the port's own keys (not carried) give the same residues
    assert torch.equal(text.regular_bootstrap_v2(tctx, t, keys["regular"][0]).c, out.c)


@pytest.mark.parametrize("phase", [-math.pi / 2, 0.0, text.GATE_TABLE["XOR"][0]])
def test_eval_cos_engine_matches_reference(sides, phase):
    tctx, jctx, keys, residues = sides
    _, jk, ck = keys["regular"]
    t, j = residues(ck.ctos_out_level, tctx.default_scale)
    _same(text.eval_cos_engine(tctx, t, ck, phase),
          _ref(lambda c: jext.eval_cos_engine(jctx, c, jk, phase), j))


@pytest.mark.parametrize("variant", ["slim", "bit"])
def test_slim_and_bit_bootstrap_match_reference(sides, variant):
    tctx, jctx, keys, residues = sides
    _, jk, ck = keys[variant]
    t, j = residues(ck.stoc_pieces[0].level, ck.msg_scale)
    run = {"slim": (text.slim_bootstrap, jext.slim_bootstrap),
           "bit": (text.bit_bootstrap, jext.bit_bootstrap)}[variant]
    _same(run[0](tctx, t, ck), _ref(lambda c: run[1](jctx, c, jk), j))


def test_gate_nand_matches_reference(sides):
    tctx, jctx, keys, residues = sides
    _, jk, ck = keys["gate"]
    lvl = ck.stoc_pieces[0].level
    (t1, j1), (t2, j2) = residues(lvl, ck.msg_scale), residues(lvl, ck.msg_scale)
    _same(text.gate_bootstrap(tctx, t1, t2, "NAND", ck),
          _ref(lambda a, b: jext.gate_bootstrap(jctx, a, b, "NAND", jk), j1, j2))


def test_sparse_switch_raise_matches_reference(sides):
    """switch to the sparse key at one limb, mod-raise, switch back at the
    full chain: two keyswitches around the raise."""
    tctx, jctx, keys, residues = sides
    _, jk, ck = keys["sparse"]
    t, j = residues(tctx.k - 1, ck.msg_scale)
    out = text._raise_maybe_sparse(tctx, t, ck)
    _same(out, _ref(lambda c: jext._raise_maybe_sparse(jctx, c, jk), j))
    assert not torch.equal(out.c, tboot.mod_raise(tctx, t).c)


def test_less_key_mode_piece_matches_reference(sides):
    """The second CtoS piece, whose giant step 28 has no key of its own: its
    rotation composes from the power-of-two chain (16 + 8 + 4), keyed at
    level 0 and sliced to the piece's level 1."""
    tctx, jctx, keys, residues = sides
    _, jk, ck = keys["less_key"]
    piece = ck.ctos_pieces[1]
    missing = [g for g, _, _ in piece.giants
               if g and tpoly.steps_to_galois_elt(g, N) not in ck.gk.keys]
    assert missing == [28] and piece.level == 1
    assert ck.gk.keys[tpoly.steps_to_galois_elt(16, N)].k0.shape[1] == tctx.k + 6
    t, j = residues(piece.level, ck.msg_scale)
    _same(tboot.matvec_piece(tctx, t, piece, ck.gk),
          _ref(lambda c: jboot.matvec_piece(jctx, c, jk.ctos_pieces[1], jk.gk), j))
