"""Port parity for the bootstrapping variants on a limb-sharded ciphertext
(parallel/boot_ext_sharded.py), on four gloo ranks on the CPU.

The configuration is tests/test_torch_boot_v2_eval.py's: N=64, nine primes
([29] + [28]*8), Method II with alpha 4 and p_count 6, a secret of Hamming
weight 16 (a dense one for the sparse switch), BootConfigV2(cos_degree=2,
double_angles=1, K=12), with every key set made with limb_align=4.  That
chain builds under limb_align=4, but its level-0 extent (9 + 6 = 15 QP rows)
does not divide 4 and limb_align cannot move a key above level 0: the CtoS
keys, conj, relin, the two switch keys and less-key mode's power-of-two
chain stay whole on every rank, and the StoC keys (moved to extents 12 and
8) split 4 ways.  The ciphertexts walk
through levels whose limb count 4 divides (split) and levels where it does
not (replicated).

One start of four ranks (tests/torch_parallel_ranks.py, job boot_v2_sharded)
places each set on a 1 x 4 ('dp', 'limb') mesh and runs, on uniform
residues placed by shard_array_limb_axis: eval_poly_bsgs, eval_cos_engine
at the phase -π/2 (a shift) and 0 (none), regular_bootstrap_v2, slim, bit,
the six gates, the sparse-switch raise and regular_bootstrap_v2 on the
sparse set, in less-key mode the second CtoS piece (a giant step
composed from the power-of-two chain) and regular_bootstrap_v2, and
regular_bootstrap_v2 on a compressed set (compress_keys=True: every Galois
and relin key stripped to k0 and its a_seed).  Every rank's shard must
equal, bit for bit, the same rows of the port's unsharded CPU path on the
same keys and residues (tests/test_torch_boot_v2_eval.py holds that path
against the JAX package), and no rank may receive a row of a key (a
stripped key's regenerated k1 included); a plain-tensor ciphertext raises
TypeError and a set stripped with no seeds ParameterError.  The gate set is the JAX package's BootKeysV2 carried back by
interop.boot_keys_v2_from_numpy, and the sharded NAND gathered from the four
ranks must equal the JAX package's gate_bootstrap, compiled as one program
(XLA_FAST) while the ranks run.
"""

import math
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parallel_ranks as ranks  # noqa: E402
from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu.models import ckks_boot_ext as jext  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot as tboot  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot_ext as text  # noqa: E402
from heongpu_tpu_torch.models import poly_eval as tpe  # noqa: E402
from heongpu_tpu_torch.ops import polyops as tpoly  # noqa: E402
from heongpu_tpu_torch.utils import rng as trng  # noqa: E402
from test_torch_boot import XLA_FAST  # noqa: E402
from test_torch_boot_v2_eval import CFG, CTX_KW, N, Q_BITS, _carried, _reference_keys  # noqa: E402

torch.set_num_threads(2)

WORLD = 4
GATES = tuple(text.GATE_TABLE)
PHASES = {"shift": -math.pi / 2, "none": 0.0}
# the unsharded counterpart of parallel/boot_ext_sharded.py's names
UNSHARDED = types.SimpleNamespace(**vars(text), eval_poly_bsgs=tpe.eval_poly_bsgs)


def _np(t):
    return interop.to_numpy(t)


@pytest.fixture(scope="module")
def sides():
    """The port's context, its key sets by variant (limb_align=4; the gate set
    carried from the JAX package's), the reference's gate set and context,
    and each case's calls with their inputs: (name, keys, [(label, kind,
    inputs, args)]), inputs as (c, level, scale)."""
    tctx = tckks.make_context(N, Q_BITS, device="cpu", **CTX_KW)
    g = trng.new_generator(5, "cpu")
    sk = tckks.keygen_secret(tctx, g, hamming_weight=16)
    dense = tckks.keygen_secret(tctx, g)
    cfg = text.BootConfigV2(**CFG)
    made = {"regular": dict(variant="regular"), "slim": dict(variant="slim", msg_scale=2.0 ** 22),
            "bit": dict(variant="bit"), "gate": dict(variant="gate"),
            "sparse": dict(variant="regular", sparse_hw=16),
            "less_key": dict(variant="regular", less_key_mode=True),
            "compressed": dict(variant="regular", compress_keys=True)}
    keys = {name: text.generate_bootstrap_keys_v2(tctx, g, dense if name == "sparse" else sk, cfg,
                                                  limb_align=WORLD, **kw)
            for name, kw in made.items()}
    jgate = _reference_keys(keys["gate"])
    keys["gate"] = _carried(jgate)
    comp = keys["compressed"]
    assert comp.rk.k1 is None and all(kk.k1 is None for kk in comp.gk.keys.values())
    r = np.random.default_rng(20)

    def x(level, scale):
        c = np.stack([r.integers(0, int(q), (2, N)) for q in tctx.q_primes[:tctx.k - level]],
                     axis=1).astype(np.uint32)
        return interop.ciphertext_from_numpy(c, 2, level, scale, device="cpu").c, level, scale

    last = tctx.k - 1
    reg, lk = keys["regular"], keys["less_key"]
    t_in = x(reg.ctos_out_level, tctx.default_scale)
    stoc0 = lambda k: k.stoc_pieces[0].level
    gates_in = [x(stoc0(keys["gate"]), keys["gate"].msg_scale) for _ in range(2)]
    calls = {
        "regular": [("poly", "poly", [t_in], ())]
        + [(f"cos_{p}", "cos", [t_in], (phase,)) for p, phase in PHASES.items()]
        + [("regular", "regular", [x(last, reg.msg_scale)], ())],
        "slim": [("slim", "slim", [x(stoc0(keys["slim"]), keys["slim"].msg_scale)], ())],
        "bit": [("bit", "bit", [x(stoc0(keys["bit"]), keys["bit"].msg_scale)], ())],
        "gate": [(gate, "gate", gates_in, (gate,)) for gate in GATES],
        "sparse": [("raise", "raise", [x(last, keys["sparse"].msg_scale)], ()),
                   ("regular", "regular", [x(last, keys["sparse"].msg_scale)], ())],
        "less_key": [("piece", "piece", [x(lk.ctos_pieces[1].level, lk.msg_scale)], (1,)),
                     ("regular", "regular", [x(last, lk.msg_scale)], ())],
        "compressed": [("regular", "regular", [x(last, keys["compressed"].msg_scale)], ())],
    }
    cases = [{"name": name, "keys": keys[name], "calls": calls[name],
              "misuse": name == "regular"} for name in made]
    return tctx, keys, cases, jgate


@pytest.fixture(scope="module")
def ranks_running(sides, tmp_path_factory):
    """The gloo ranks, started before the reference compiles, as a future of
    their results."""
    _, _, cases, _ = sides
    pool = ThreadPoolExecutor(1)
    yield pool.submit(ranks.spawn, "boot_v2_sharded", WORLD, tmp_path_factory.mktemp("boot_v2"),
                      {"ctx_args": (N, Q_BITS), "ctx_kw": CTX_KW, "cases": cases})
    pool.shutdown()


@pytest.fixture(scope="module")
def reference_nand(sides, ranks_running):
    """The JAX package's NAND gate bootstrap on the carried gate set's inputs,
    one program; it asks for ranks_running so that the ranks start first."""
    _, _, cases, jgate = sides
    (_, _, inputs, _), = [c for c in next(c for c in cases if c["name"] == "gate")["calls"]
                          if c[0] == "NAND"]
    jctx = jckks.make_context(N, Q_BITS, **CTX_KW)
    a, b = (jckks.Ciphertext(jax.numpy.asarray(_np(c)), 2, lvl, s) for c, lvl, s in inputs)
    return jax.jit(lambda u, v: jext.gate_bootstrap(jctx, u, v, "NAND", jgate),
                   compiler_options=XLA_FAST)(a, b)


@pytest.fixture(scope="module")
def sharded(ranks_running):
    return ranks_running.result()


def _unsharded(tctx, keys, call):
    _, kind, inputs, args = call
    cts = [tckks.Ciphertext(c, 2, lvl, s) for c, lvl, s in inputs]
    return ranks.V2_CALLS[kind](UNSHARDED, tboot, tctx, cts, keys, *args)


def _check_shards(sharded, case, label, want):
    """Every rank's shard of `label` equals the same rows of want (its quarter
    where the limb axis is split, all rows where it is replicated: split
    exactly where 4 divides the limb count), level and scale too."""
    full = _np(want.c)
    rows = full.shape[-2]
    for r in range(WORLD):
        local, placements, level, scale = sharded[r][case]["steps"][label]
        assert placements[1].is_shard() == (rows % WORLD == 0), (label, rows, placements)
        m = rows // WORLD
        rows_r = full[:, r * m:(r + 1) * m] if placements[1].is_shard() else full
        np.testing.assert_array_equal(_np(local), rows_r)
        assert (level, scale) == (want.level, want.scale)


def _call(sides, case, label):
    tctx, keys, cases, _ = sides
    call = next(c for c in next(c for c in cases if c["name"] == case)["calls"] if c[0] == label)
    return _unsharded(tctx, keys[case], call)


def test_sharded_eval_poly_bsgs_matches_unsharded(sides, sharded):
    _check_shards(sharded, "regular", "poly", _call(sides, "regular", "poly"))


@pytest.mark.parametrize("phase", tuple(PHASES))
def test_sharded_eval_cos_engine_matches_unsharded(sides, sharded, phase):
    _check_shards(sharded, "regular", f"cos_{phase}", _call(sides, "regular", f"cos_{phase}"))


@pytest.mark.parametrize("case,label", [("regular", "regular"), ("slim", "slim"),
                                        ("bit", "bit"), ("sparse", "regular"),
                                        ("less_key", "regular"), ("compressed", "regular")])
def test_sharded_variant_matches_unsharded(sides, sharded, case, label):
    _check_shards(sharded, case, label, _call(sides, case, label))


@pytest.mark.parametrize("gate", GATES)
def test_sharded_gate_matches_unsharded(sides, sharded, gate):
    _check_shards(sharded, "gate", gate, _call(sides, "gate", gate))


def test_sharded_sparse_raise_matches_unsharded(sides, sharded):
    """The switch to the sparse key at one limb (replicated), the raise, the
    switch back over the full chain (whole keys of 15 QP rows)."""
    want = _call(sides, "sparse", "raise")
    _check_shards(sharded, "sparse", "raise", want)
    _, keys, _, _ = sides
    assert keys["sparse"].swk_to_sparse.k0.shape[1] % WORLD


def test_sharded_less_key_piece_matches_unsharded(sides, sharded):
    """The second CtoS piece, whose giant step 28 has no key of its own: the
    rotation composes from the power-of-two chain."""
    _, keys, _, _ = sides
    piece = keys["less_key"].ctos_pieces[1]
    assert [g for g, _, _ in piece.giants
            if g and tpoly.steps_to_galois_elt(g, N) not in keys["less_key"].gk.keys] == [28]
    _check_shards(sharded, "less_key", "piece", _call(sides, "less_key", "piece"))


def test_sharded_nand_gathered_matches_reference(sides, sharded, reference_nand):
    """The sharded NAND gate, gathered from the four ranks, equals the JAX
    package's gate_bootstrap on the same (carried) keys and inputs."""
    steps = [sharded[r]["gate"]["steps"]["NAND"] for r in range(WORLD)]
    local, placements, level, scale = steps[0]
    if placements[1].is_shard():
        got = np.concatenate([_np(s[0]) for s in steps], axis=-2)
    else:
        got = _np(local)
        assert all(np.array_equal(_np(s[0]), got) for s in steps)
    np.testing.assert_array_equal(got, np.asarray(reference_nand.c))
    assert (level, scale) == (reference_nand.level, reference_nand.scale)


def test_sharded_variants_move_no_key_row(sides, sharded):
    """Each set's keys split exactly where 4 divides their QP extent (some in
    every set but less-key mode's, whose power-of-two chain, babies included,
    is keyed at level 0), the ranks exchanged rows and none of them a key's;
    a plain-tensor ciphertext raises TypeError and a set stripped with no
    seeds ParameterError."""
    _, keys, cases, _ = sides
    for r in range(WORLD):
        for case in cases:
            got = sharded[r][case["name"]]
            split = [e for e, (shape, rows) in got["key_local"].items() if shape[1] < rows]
            assert bool(split) == (case["name"] != "less_key"), (case["name"], got["key_local"])
            for e, (shape, rows) in got["key_local"].items():
                assert shape[1] == (rows // WORLD if rows % WORLD == 0 else rows), (e, shape)
            assert got["received_rows"] > 0 and got["received_key_rows"] == 0, case["name"]
        misuse = sharded[r]["regular"]["misuse"]
        assert "DTensor" in misuse["plain_tensor"]
        assert "no a_seed" in misuse["stripped"]
