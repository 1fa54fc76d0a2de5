"""Port parity for the CKKS bootstrapping variants (models/ckks_boot_ext.py),
part 1: the key sets from one DRBG seed, the options that are not ported,
and the port's own variants against the reference's accuracy limits, on the
CPU.

The configuration is the JAX package's v2 test chain at N=256
(tests/test_ckks_boot_v2.py: [29] + [28]*18, scale 2^28, BootConfigV2(24,
5, 12), 2 + 2 pieces) with Method II, alpha 4 and p_count 6, as
chip_smoke.py runs it at N=2^16.  Galois, relinearization and sparse-switch
keys drawn from one DRBG seed must equal the reference's bit for bit, with
and without less-key mode; the diagonal plaintexts come from the float64
encoder on one side and the df64 one on the other, so they are held within
±3 (see tests/test_torch_boot.py).  The evaluation is held bit for bit in
tests/test_torch_boot_v2_eval.py."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import ckks_boot_ext as jext  # noqa: E402
from heongpu_tpu.utils import rng as jrng  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot as tboot  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot_ext as text  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.ops import polyops as tpoly  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402
from test_torch_boot import keys_compiled  # noqa: E402

torch.set_num_threads(2)

N = 256
Q_BITS = [29] + [28] * 18
CTX_KW = dict(scale_bits=28, sec_level="none", ks_type="II", alpha=4, p_count=6)
CFG = dict(cos_degree=24, double_angles=5, K=12)
# the reference's limits, tests/test_ckks_boot_v2.py
LIMITS = {"regular": 1e-2, "sparse": 1e-2, "less_key": 1e-2, "slim": 3e-2, "bit": 0.1,
          "gate": 0.1}


def _np(t):
    return interop.to_numpy(t)


# ---------------------------------------------------------------------------
# the key sets from one DRBG seed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drbg_keys():
    """A dense secret (hw N/2) and, from one DRBG seed each, the regular key
    set with sparse switch keys (hw 16) and the less-key-mode set, on both
    sides."""
    jctx = jckks.make_context(N, Q_BITS, **CTX_KW)
    tctx = tckks.make_context(N, Q_BITS, device="cpu", **CTX_KW)
    jsk = jckks.keygen_secret(jctx, jrng.new_drbg(b"s" * 32))
    tsk = tckks.keygen_secret(tctx, trng.new_drbg(b"s" * 32))
    out = {}
    for name, kw in (("sparse", dict(sparse_hw=16)), ("less_key", dict(less_key_mode=True))):
        jk = keys_compiled(jext.generate_bootstrap_keys_v2, jctx, jrng.new_drbg(b"k" * 32), jsk,
                           jext.BootConfigV2(**CFG), **kw)
        tk = text.generate_bootstrap_keys_v2(tctx, trng.new_drbg(b"k" * 32), tsk,
                                             text.BootConfigV2(**CFG), **kw)
        out[name] = (jk, tk)
    return tctx, out


def _galois_levels(ctx, gk):
    """{step or "conj": the level its key was made at}."""
    by_elt = {tpoly.steps_to_galois_elt(s, N): s for s in range(1, N // 2)}
    return {by_elt.get(e, e): ctx.k + len(ctx.p_primes) - k.k0.shape[1]
            for e, k in gk.keys.items()}


def _same_keys(jk, tk):
    assert sorted(map(str, tk.gk.keys)) == sorted(map(str, jk.gk.keys))
    for elt, j in jk.gk.keys.items():
        t = tk.gk.keys[elt]
        assert (t.galois_elt, t.inv_form) == (j.galois_elt, j.inv_form)
        for f in ("k0", "k1", "perm_ntt"):
            np.testing.assert_array_equal(_np(getattr(t, f)), np.asarray(getattr(j, f)))
    for t, j in ((tk.rk, jk.rk), (tk.swk_to_sparse, jk.swk_to_sparse),
                 (tk.swk_to_dense, jk.swk_to_dense)):
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_array_equal(_np(t.k0), np.asarray(j.k0))
            np.testing.assert_array_equal(_np(t.k1), np.asarray(j.k1))
    for got, want in zip(tk.mult_i + tk.mult_neg_i, jk.mult_i + jk.mult_neg_i):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert (tk.msg_scale, tk.variant, tk.ctos_out_level) == (jk.msg_scale, jk.variant,
                                                             jk.ctos_out_level)
    np.testing.assert_array_equal(tk.cos_coeffs, jk.cos_coeffs)


def test_v2_keys_with_sparse_switch_from_one_drbg_seed_match(drbg_keys):
    tctx, out = drbg_keys
    jk, tk = out["sparse"]
    _same_keys(jk, tk)
    assert tk.swk_to_sparse is not None and tk.swk_to_dense is not None
    levels = _galois_levels(tctx, tk.gk)
    # babies and giants at their shallowest piece level, conj and relin at p1
    assert levels["conj"] == 2 and {lv for s, lv in levels.items() if s != "conj"} == {0, 1, 13, 14}
    assert tk.rk.k0.shape == (5, 17 + 6, N)


def test_less_key_mode_keys_from_one_drbg_seed_match(drbg_keys):
    """Less-key mode: the babies at their levels, the power-of-two chain at
    level 0, no giant step; fewer keys than the standard set."""
    tctx, out = drbg_keys
    jk, tk = out["less_key"]
    _same_keys(jk, tk)
    std = out["sparse"][1]
    lv, std_lv = _galois_levels(tctx, tk.gk), _galois_levels(tctx, std.gk)
    assert all(lv[1 << j] == 0 for j in range(7))
    babies = {b for p in tk.ctos_pieces + tk.stoc_pieces for _, bs, _ in p.giants for b in bs if b}
    giants = {g for p in tk.ctos_pieces + tk.stoc_pieces for g, _, _ in p.giants if g}
    assert set(lv) - {"conj"} == babies | {1 << j for j in range(7)}
    assert set(std_lv) - {"conj"} == babies | giants
    assert len(tk.gk.keys) < len(std.gk.keys)


def test_v2_pieces_match_reference(drbg_keys):
    """Each piece's placement and scale equal the reference's (the last CtoS
    piece renormalizes to the default scale; StoC after EvalMod at level
    p1 + evalmod_depth); its diagonals are within ±3 of the reference's
    df64-encoded ones, and within ±1 in 99% of them."""
    tctx, out = drbg_keys
    jk, tk = out["sparse"]
    pieces = list(zip(tk.ctos_pieces + tk.stoc_pieces, jk.ctos_pieces + jk.stoc_pieces))
    assert [tp.level for tp, _ in pieces] == [0, 1, 13, 14]
    for tp, jp in pieces:
        assert (tp.level, tp.n1, tp.pt_scale, tp.depth) == (jp.level, jp.n1, jp.pt_scale, jp.depth)
        assert [(g, b) for g, b, _ in tp.giants] == [(g, b) for g, b, _ in jp.giants]
        tb, base = tctx.ntt_qp_at(tp.level), tctx.base_qp_at(tp.level)
        q = np.asarray(tb.primes, np.int64)[:, None]
        back = lambda pts: tntt.ntt_inv(tm.from_mont(pts, base.col(), base.col("rinv")), tb)
        for (_, _, tpts), (_, _, jpts) in zip(tp.giants, jp.giants):
            got = _np(back(tpts)).astype(np.int64)
            want = _np(back(interop._t(np.asarray(jpts), "cpu"))).astype(np.int64)
            d = (got - want) % q
            d = np.abs(np.where(d > q // 2, d - q, d))
            assert d.max() <= 3 and (d > 1).mean() < 0.01


def test_options_not_ported_raise():
    ctx = tckks.make_context(N, Q_BITS, device="cpu", **CTX_KW)
    sk = tckks.keygen_secret(ctx, trng.new_generator(1, "cpu"), hamming_weight=16)
    cfg = text.BootConfigV2(**CFG)
    # compress_keys=True is ported: the keys come stripped, each with a seed of its own
    keys = text.generate_bootstrap_keys_v2(ctx, trng.new_generator(2, "cpu"), sk, cfg,
                                           compress_keys=True)
    assert keys.rk.k1 is None and all(k.k1 is None and k.a_seed is not None
                                      for k in keys.gk.keys.values())
    seeds = [keys.rk.a_seed] + [k.a_seed for k in keys.gk.keys.values()]
    assert len({s % 2 ** 32 for s in seeds}) == len(seeds)
    # limb_align=2 is ported: each key is the plain run's key at the level that align
    # picks (the deepest at or above its own whose extent 2 divides; level 0 stays)
    p = len(ctx.p_primes)

    def align(lv):
        while lv > 0 and (ctx.active(lv) + p) % 2:
            lv -= 1
        return lv

    aligned = text.generate_bootstrap_keys_v2(ctx, trng.new_generator(2, "cpu"), sk, cfg,
                                              limb_align=2)
    boot = tboot.generate_bootstrap_keys(ctx, trng.new_generator(2, "cpu"), sk,
                                         tboot.BootConfig(taylor_degree=3, exp_squarings=1),
                                         limb_align=2)
    for keys, aux in ((aligned, len(aligned.ctos_pieces)),
                      (boot, len(boot.ctos_pieces) * boot.cfg.piece_depth)):
        pieces = [dataclasses.replace(pc, level=align(pc.level))
                  for pc in keys.ctos_pieces + keys.stoc_pieces]
        gk, rk = tboot.leveled_boot_keys(ctx, trng.new_generator(2, "cpu"), sk, pieces,
                                         aux_lvl=align(aux))
        assert set(gk.keys) == set(keys.gk.keys)
        for elt, kk in keys.gk.keys.items():
            assert torch.equal(kk.k0, gk.keys[elt].k0) and torch.equal(kk.k1, gk.keys[elt].k1)
            ext = kk.k0.shape[1]
            assert ext % 2 == 0 or ext == ctx.active(0) + p, (elt, ext)
        assert torch.equal(keys.rk.k0, rk.k0) and torch.equal(keys.rk.k1, rk.k1)
        assert any(align(pc.level) != pc.level for pc in keys.ctos_pieces + keys.stoc_pieces)


# ---------------------------------------------------------------------------
# the port's own variants against the reference's accuracy limits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def own():
    ctx = tckks.make_context(N, Q_BITS, device="cpu", **CTX_KW)
    g = trng.new_generator(71, "cpu")
    sk = tckks.keygen_secret(ctx, g, hamming_weight=16)
    pk = tckks.keygen_public(ctx, g, sk)
    return ctx, g, sk, pk


def _decoded(ctx, sk, ct):
    got = tckks.decode(ctx, tckks.decrypt(ctx, sk, ct))
    assert np.isfinite(got).all() and got.shape == (N // 2,)
    return got.real


@pytest.mark.parametrize("variant", ["regular", "slim", "bit", "sparse", "less_key"])
def test_own_variant_within_reference_limit(own, variant):
    """Each variant as tests/test_ckks_boot_v2.py runs it: regular and
    less-key mode on z ~ U(-0.5, 0.5) at the last limb, slim at msg_scale
    2^22 from its StoC level, bit on random bits at q0/2, and the sparse
    switch under a dense secret (hw N/2) with a sparse key of hw 16."""
    ctx, g, sk, pk = own
    cfg = text.BootConfigV2(**CFG)
    z = np.random.default_rng(7).uniform(-0.5, 0.5, N // 2)
    if variant == "sparse":
        sk = tckks.keygen_secret(ctx, g)
        pk = tckks.keygen_public(ctx, g, sk)
    kw = {"slim": dict(variant="slim", msg_scale=2.0 ** 22), "bit": dict(variant="bit"),
          "sparse": dict(sparse_hw=16), "less_key": dict(less_key_mode=True)}.get(variant, {})
    keys = text.generate_bootstrap_keys_v2(ctx, g, sk, cfg, **kw)
    if variant == "bit":
        z = np.random.default_rng(9).integers(0, 2, N // 2).astype(np.float64)
    ct = tckks.encrypt(ctx, pk, tckks.encode(ctx, z, scale=keys.msg_scale), g)
    if variant in ("slim", "bit"):
        ct = tckks.mod_drop(ctx, ct, keys.stoc_pieces[0].level)
        out = (text.slim_bootstrap if variant == "slim" else text.bit_bootstrap)(ctx, ct, keys)
    else:
        out = text.regular_bootstrap_v2(ctx, tckks.mod_drop(ctx, ct, ctx.k - 1), keys)
        assert out.level == 15 and ctx.active(out.level) == 4
    assert np.abs(_decoded(ctx, sk, out) - z).max() < LIMITS[variant]


@pytest.fixture(scope="module")
def gate_inputs(own):
    ctx, g, sk, pk = own
    keys = text.generate_bootstrap_keys_v2(ctx, g, sk, text.BootConfigV2(**CFG), variant="gate")
    q0 = int(ctx.q_primes[0])
    r = np.random.default_rng(10)
    b1, b2 = r.integers(0, 2, N // 2), r.integers(0, 2, N // 2)
    lvl = keys.stoc_pieces[0].level
    cts = [tckks.mod_drop(ctx, tckks.encrypt(ctx, pk, tckks.encode(ctx, b.astype(np.float64),
                                                                   scale=q0 / 3.0), g), lvl)
           for b in (b1, b2)]
    return keys, cts, b1.astype(bool), b2.astype(bool)


GATES = {"AND": lambda a, b: a & b, "OR": lambda a, b: a | b, "XOR": lambda a, b: a ^ b,
         "NAND": lambda a, b: ~(a & b), "NOR": lambda a, b: ~(a | b),
         "XNOR": lambda a, b: ~(a ^ b)}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_own_gate_matches_truth_table(own, gate_inputs, gate):
    ctx, _, sk, _ = own
    keys, (c1, c2), b1, b2 = gate_inputs
    out = text.gate_bootstrap(ctx, c1, c2, gate.lower(), keys)
    want = GATES[gate](b1, b2).astype(np.float64)
    assert np.abs(_decoded(ctx, sk, out) - want).max() < LIMITS["gate"]


def test_rotate_exact_composes_from_the_power_of_two_chain(own):
    """A step with no key of its own rotates through ckks.rotate's chain;
    a step with one is one keyswitch; both decode to the rotated slots."""
    ctx, g, sk, pk = own
    gk = tckks.keygen_galois(ctx, g, sk, steps=[1, 2, 4, 8, 16, 32, 64, 3])
    z = np.random.default_rng(3).uniform(-1, 1, N // 2)
    ct = tckks.encrypt(ctx, pk, tckks.encode(ctx, z), g)
    for step in (3, 7, 100):
        out = tboot.rotate_exact(ctx, ct, gk, step)
        if step != 3:
            assert torch.equal(out.c, tckks.rotate(ctx, ct, gk, step).c)
        assert np.abs(_decoded(ctx, sk, out) - np.roll(z, -step)).max() < 1e-3
    assert tboot.rotate_exact(ctx, ct, gk, N // 2) is ct
    with pytest.raises(ValueError):
        tboot.rotate_exact(ctx, ct, tckks.GaloisKey({}), 5)
