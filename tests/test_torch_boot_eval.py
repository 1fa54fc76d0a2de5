"""Port parity for CKKS regular bootstrapping (models/ckks_boot.py), part 2:
the exact-integer evaluation, bit for bit against the JAX package on the
CPU.

One key set and one set of diagonal plaintexts drive both sides: the port
generates them (a torch.Generator, the float64 encoder), the test builds the
JAX package's BootKeys from the same arrays, and `interop.boot_keys_from_numpy`
carries that BootKeys object back into the port.  Everything downstream of
the diagonals is exact, so mod_raise, matvec_piece, coeff_to_slot,
eval_exp_sin, slot_to_coeff and regular_bootstrap must return the
reference's residues.  The reference blocks run under jax.jit (its own
tests/test_boot_sharded.py does the same for coeff_to_slot); the reference's
regular_bootstrap is its four-line composition of those blocks (mod_raise,
coeff_to_slot, eval_exp_sin twice, slot_to_coeff), run here block by block,
and coeff_to_slot its composition of matvec_piece and ctos_finish.

The minimal configuration (tests/test_boot_sharded.py: N=256, sixteen 29-bit
primes, alpha 2, p_count 4, Taylor degree 3, one squaring, 2 + 2 pieces)
runs in the fast suite; the precision configuration of
tests/test_ckks_boot.py (44 primes, composite q0, composite-scale pieces, the
arcsine term) compiles for several minutes on the JAX side and is marked
slow.

The limb-sharded bootstrap (parallel/boot_sharded.py) is held against the
same reference chain: four gloo ranks (tests/torch_parallel_ranks.py, one
start, begun before the reference compiles) place the carried keys on a
1 x 4 ('dp', 'limb') mesh by shard_pytree_limb_axis (not generated with
limb_align, so the keys whose QP extent 4 divides split and the others stay
whole on every rank) and run mod_raise, coeff_to_slot, eval_exp_sin twice,
slot_to_coeff and regular_bootstrap on the input placed by
shard_array_limb_axis.  Each rank's shard must equal the same rows of the
reference's result, and no rank may receive a row of a key."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parallel_ranks as ranks  # noqa: E402
from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import ckks_boot as jboot  # noqa: E402
from heongpu_tpu.models import ringkit as jringkit  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot as tboot  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402
from test_torch_boot import XLA_FAST  # noqa: E402

torch.set_num_threads(2)

N = 256
WORLD = 4
MINIMAL = dict(q_bits=[29] * 16, ctx=dict(scale_bits=28, sec_level="none", ks_type="II",
                                          alpha=2, p_count=4),
               cfg=dict(taylor_degree=3, exp_squarings=1, ctos_pieces=2, stoc_pieces=2))
PRECISION = dict(q_bits=[29, 29] + [28] * 42, ctx=MINIMAL["ctx"],
                 cfg=dict(taylor_degree=9, exp_squarings=5, base_count=2, arcsin_order=1,
                          piece_depth=2))


def _np(t):
    return interop.to_numpy(t)


def _j(t):
    return jnp.asarray(_np(t))


def _reference_keys(keys):
    """The JAX package's BootKeys holding the port keys' arrays."""
    gk = jringkit.GaloisKey({
        elt: jringkit.GaloisKeyOne(
            k0=_j(k.k0), k1=_j(k.k1), perm_coeff_src=jnp.asarray(k.perm_coeff_src.numpy()),
            perm_coeff_neg=jnp.asarray(k.perm_coeff_neg.numpy().astype(np.uint32)),
            perm_ntt=jnp.asarray(k.perm_ntt.numpy()), galois_elt=k.galois_elt,
            inv_form=k.inv_form)
        for elt, k in keys.gk.keys.items()})
    piece = lambda p: jboot.Piece(level=p.level, n1=p.n1, pt_scale=p.pt_scale, depth=p.depth,
                                  giants=tuple((g, b, _j(pts)) for g, b, pts in p.giants))
    return jboot.BootKeys(
        gk=gk, rk=jringkit.KSKey(_j(keys.rk.k0), _j(keys.rk.k1)),
        cfg=jboot.BootConfig(**dataclasses.asdict(keys.cfg)), msg_scale=keys.msg_scale,
        ctos_pieces=[piece(p) for p in keys.ctos_pieces],
        stoc_pieces=[piece(p) for p in keys.stoc_pieces],
        mult_i=tuple(_j(t) for t in keys.mult_i), mult_neg_i=tuple(_j(t) for t in keys.mult_neg_i))


def _carried(jkeys):
    """The reference's BootKeys carried into the port."""
    fields = ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt", "galois_elt",
              "inv_form")
    piece = lambda p: dict(level=p.level, n1=p.n1, pt_scale=p.pt_scale, depth=p.depth,
                           giants=[(g, b, np.asarray(pts)) for g, b, pts in p.giants])
    return interop.boot_keys_from_numpy(
        gk={e: {f: np.asarray(getattr(k, f)) for f in fields} for e, k in jkeys.gk.keys.items()},
        rk={"k0": np.asarray(jkeys.rk.k0), "k1": np.asarray(jkeys.rk.k1)},
        cfg=dataclasses.asdict(jkeys.cfg), msg_scale=jkeys.msg_scale,
        ctos_pieces=[piece(p) for p in jkeys.ctos_pieces],
        stoc_pieces=[piece(p) for p in jkeys.stoc_pieces],
        mult_i=[np.asarray(t) for t in jkeys.mult_i],
        mult_neg_i=[np.asarray(t) for t in jkeys.mult_neg_i], device="cpu")


def _same(got, want):
    assert (got.size, got.level, got.scale) == (want.size, want.level, want.scale)
    np.testing.assert_array_equal(_np(got.c), np.asarray(want.c))


def _ct(c):
    return interop.ciphertext_from_numpy(np.asarray(c.c), c.size, c.level, c.scale, device="cpu")


def _both_sides(conf, seed):
    tctx = tckks.make_context(N, conf["q_bits"], device="cpu", **conf["ctx"])
    jctx = jckks.make_context(N, conf["q_bits"], **conf["ctx"])
    g = trng.new_generator(seed, "cpu")
    sk = tckks.keygen_secret(tctx, g, hamming_weight=16)
    keys = tboot.generate_bootstrap_keys(tctx, g, sk, tboot.BootConfig(**conf["cfg"]))
    jkeys = _reference_keys(keys)
    carried = _carried(jkeys)
    # the input: uniform residues over the last base_count limbs (every block
    # is exact, so any residues serve)
    bc = keys.cfg.base_count
    r = np.random.default_rng(seed)
    c = np.stack([r.integers(0, int(q), (2, N)) for q in tctx.q_primes[:bc]], axis=1)
    jct = jckks.Ciphertext(jnp.asarray(c.astype(np.uint32)), 2, tctx.k - bc, keys.msg_scale)
    return tctx, jctx, keys, jkeys, carried, jct


def _reference_chain(jctx, jkeys, jct):
    """The reference's blocks, each under jax.jit (XLA_FAST: exact integer
    arithmetic, the same bits at every optimization level), in
    regular_bootstrap's order; coeff_to_slot as the reference composes it,
    each CtoS piece's matvec_piece (w1: the first), then ctos_finish."""
    jit = lambda f: jax.jit(f, compiler_options=XLA_FAST)
    raised = jboot.mod_raise(jctx, jct, jkeys.cfg.base_count)
    w, ws = raised, []
    for i in range(len(jkeys.ctos_pieces)):
        w = jit(lambda c, k, i=i: jboot.matvec_piece(jctx, c, k.ctos_pieces[i], k.gk))(w, jkeys)
        ws.append(w)
    t0, t1 = jit(lambda c, k: jboot.ctos_finish(jctx, c, k))(w, jkeys)
    evalmod = jit(lambda c, k: jboot.eval_exp_sin(jctx, c, k))
    s0, s1 = evalmod(t0, jkeys), evalmod(t1, jkeys)
    out = jit(lambda a, b, k: jboot.slot_to_coeff(jctx, a, b, k))(s0, s1, jkeys)
    return dict(raised=raised, w1=ws[0], t0=t0, t1=t1, s0=s0, s1=s1, out=out)


@pytest.fixture(scope="module")
def sides():
    return _both_sides(MINIMAL, 5)


@pytest.fixture(scope="module")
def ranks_running(sides, tmp_path_factory):
    """The gloo ranks of the sharded bootstrap on the carried keys, started
    before the reference compiles (they need only the keys and the input),
    as a future of their results."""
    _, _, _, _, carried, jct = sides
    case = {"name": "carried", "ctx_args": (N, MINIMAL["q_bits"]), "ctx_kw": MINIMAL["ctx"],
            "keys": carried, "c": _ct(jct).c, "blocks": True}
    pool = ThreadPoolExecutor(1)
    yield pool.submit(ranks.spawn, "boot_sharded", WORLD, tmp_path_factory.mktemp("boot_sh"),
                      {"cases": [case]})
    pool.shutdown()


@pytest.fixture(scope="module")
def minimal(sides, ranks_running):
    """Both sides and the reference chain; it asks for ranks_running so that
    the ranks start before the reference compiles."""
    tctx, jctx, keys, jkeys, carried, jct = sides
    return tctx, jctx, keys, carried, jct, _reference_chain(jctx, jkeys, jct)


def test_keys_carried_across_unchanged(minimal):
    _, _, keys, carried, _, _ = minimal
    assert carried.cfg == keys.cfg and carried.out_level == keys.out_level
    for elt, k in keys.gk.keys.items():
        for f in ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt"):
            assert torch.equal(getattr(carried.gk.keys[elt], f), getattr(k, f))
    for tp, cp in zip(keys.ctos_pieces + keys.stoc_pieces, carried.ctos_pieces + carried.stoc_pieces):
        assert (tp.level, tp.n1, tp.pt_scale, tp.depth) == (cp.level, cp.n1, cp.pt_scale, cp.depth)
        for (g, b, pts), (cg, cb, cpts) in zip(tp.giants, cp.giants):
            assert (g, b) == (cg, cb) and torch.equal(pts, cpts)


def test_mod_raise_and_matvec_piece_match_reference(minimal):
    tctx, _, _, carried, jct, ref = minimal
    raised = tboot.mod_raise(tctx, _ct(jct), 1)
    _same(raised, ref["raised"])
    _same(tboot.matvec_piece(tctx, _ct(ref["raised"]), carried.ctos_pieces[0], carried.gk),
          ref["w1"])


def test_mod_raise_composite_base_matches_reference(minimal):
    tctx, jctx, _, _, _, _ = minimal
    r = np.random.default_rng(2)
    c = np.stack([r.integers(0, int(q), (2, N)) for q in tctx.q_primes[:2]], axis=1)
    jct = jckks.Ciphertext(jnp.asarray(c.astype(np.uint32)), 2, tctx.k - 2, 2.0 ** 56)
    _same(tboot.mod_raise(tctx, _ct(jct), 2), jboot.mod_raise(jctx, jct, 2))


def test_coeff_to_slot_matches_reference(minimal):
    tctx, _, _, carried, _, ref = minimal
    t0, t1 = tboot.coeff_to_slot(tctx, _ct(ref["raised"]), carried)
    _same(t0, ref["t0"])
    _same(t1, ref["t1"])


def test_eval_exp_sin_matches_reference(minimal):
    tctx, _, _, carried, _, ref = minimal
    _same(tboot.eval_exp_sin(tctx, _ct(ref["t0"]), carried), ref["s0"])
    _same(tboot.eval_exp_sin(tctx, _ct(ref["t1"]), carried), ref["s1"])


def test_slot_to_coeff_matches_reference(minimal):
    tctx, _, _, carried, _, ref = minimal
    _same(tboot.slot_to_coeff(tctx, _ct(ref["s0"]), _ct(ref["s1"]), carried), ref["out"])


def test_regular_bootstrap_matches_reference(minimal):
    tctx, _, keys, carried, jct, ref = minimal
    out = tboot.regular_bootstrap(tctx, _ct(jct), carried)
    _same(out, ref["out"])
    assert out.level == keys.out_level
    # the port's own keys (not carried) give the same residues
    assert torch.equal(tboot.regular_bootstrap(tctx, _ct(jct), keys).c, out.c)


@pytest.fixture(scope="module")
def sharded(ranks_running):
    return [r["carried"] for r in ranks_running.result()]


def _shard(full, placements, r):
    """Rank r's rows of a (size, L, N) result placed as `placements` on the
    1 x 4 mesh: its quarter where the limb axis is sharded, all rows where
    it is replicated; the layout must follow shard_array_limb_axis's rule."""
    rows = full.shape[-2]
    assert placements[1].is_shard() == (rows % WORLD == 0), (rows, placements)
    m = rows // WORLD
    return full[:, r * m:(r + 1) * m] if placements[1].is_shard() else full


@pytest.mark.parametrize("step", ("raised", "t0", "t1", "s0", "s1", "stoc", "out"))
def test_sharded_bootstrap_matches_reference(minimal, sharded, step):
    """Each rank's shard of the sharded mod_raise, coeff_to_slot (t0, t1),
    eval_exp_sin (s0, s1), slot_to_coeff (stoc) and regular_bootstrap (out)
    equals the same rows of the reference's blocks, level and scale too."""
    want = minimal[-1]["out" if step == "stoc" else step]
    full = np.asarray(want.c)
    for r in range(WORLD):
        local, placements, level, scale = sharded[r]["steps"][step]
        np.testing.assert_array_equal(_np(local), _shard(full, placements, r))
        assert (level, scale) == (want.level, want.scale)


def test_sharded_bootstrap_moves_no_key_row(minimal, sharded):
    """The carried keys split where 4 divides their QP extent and stay whole
    elsewhere; the ranks exchanged rows, none of them a key's; a plain-tensor
    ciphertext raises TypeError and a stripped key with no seed ParameterError."""
    _, _, keys, _, _, _ = minimal
    for r in range(WORLD):
        got = sharded[r]
        split = {e: rows for e, (shape, rows) in got["key_local"].items() if shape[1] < rows}
        assert split and len(split) < len(keys.gk.keys), got["key_local"]
        for e, (shape, rows) in got["key_local"].items():
            assert shape[1] == (rows // WORLD if rows % WORLD == 0 else rows), (e, shape, rows)
        assert got["received_rows"] > 0 and got["received_key_rows"] == 0, got
        assert "DTensor" in got["misuse"]["plain_tensor"]
        assert "no a_seed" in got["misuse"]["stripped"]


@pytest.mark.slow
def test_precision_config_regular_bootstrap_matches_reference():
    tctx, jctx, _, jkeys, carried, jct = _both_sides(PRECISION, 7)
    ref = _reference_chain(jctx, jkeys, jct)
    t0, t1 = tboot.coeff_to_slot(tctx, _ct(ref["raised"]), carried)
    _same(t0, ref["t0"])
    _same(t1, ref["t1"])
    _same(tboot.eval_exp_sin(tctx, _ct(ref["t0"]), carried), ref["s0"])
    _same(tboot.regular_bootstrap(tctx, _ct(jct), carried), ref["out"])
