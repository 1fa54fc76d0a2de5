"""Port parity for the limb-sharded CKKS step (heongpu_tpu_torch/parallel/
ckks_sharded.py) on gloo ranks on the CPU.

Two shapes, as the JAX package runs its ordinary entry points on sharded
inputs: tests/test_parallel.py's Method-I case (N=1024, [29, 25, 25, 25], one
special prime: 5 QP rows, so the keys stay replicated on a limb axis of 4)
and __graft_entry__.py's Method-II case (N=1024, [29] + [25]*7, alpha 4,
p_count 4: 12 QP rows, the keys sharded 4 ways), each at limb = 4 and at
dp = 2 x limb = 2 with a batch of 2 ciphertext pairs.  In each, one start
of four gloo ranks (tests/torch_parallel_ranks.py) runs multiply ->
relinearize -> rescale -> multiply (the square) -> relinearize on random
residues made with numpy, the ciphertexts placed by ct_sharding and the key
by shard_pytree_limb_axis.  Every rank's shard of every op (levels 0 and 1;
after rescale the 7 or 3 limbs stay replicated) must equal, bit for bit, the
same rows of the JAX package's single-device step (jitted once a shape) and,
at limb = 4, of the JAX package's own run of that step on its 4-device CPU
mesh.  No rank may hold more than its block of a sharded key: its local
shards are the block, no DTensor is gathered in the step (full_tensor and
redistribute raise), and no row a rank receives is a row of the key."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from test_torch_boot import XLA_FAST  # noqa: E402

torch.set_num_threads(2)

WORLD = 4
N = 1024
CASES = {
    "method1_limb4": ((N, [29, 25, 25, 25]), dict(sec_level="none"), 4, False),
    "method1_dp2_limb2": ((N, [29, 25, 25, 25]), dict(sec_level="none"), 2, True),
    "method2_limb4": ((N, [29] + [25] * 7), dict(sec_level="none", ks_type="II", alpha=4,
                                                   p_count=4), 4, False),
    "method2_dp2_limb2": ((N, [29] + [25] * 7), dict(sec_level="none", ks_type="II",
                                                       alpha=4, p_count=4), 2, True),
}
OPS = ("mult0", "relin0", "rescale", "mult1", "relin1")

pytestmark = pytest.mark.skipif(len(jax.devices()) < WORLD, reason="needs 4 CPU devices")


def _residues(R, primes, lead):
    """Uniform residues (lead..., len(primes), N) as uint32."""
    return np.stack([R.integers(0, p, lead + (N,)) for p in primes], axis=-2).astype(np.uint32)


def _step(ctx):
    """The JAX package's step on (c1, c2, k0, k1): every op's result."""
    def step(c1, c2, k0, k1):
        rk = jckks.KSKey(k0, k1)
        a = jckks.Ciphertext(c1, 2, 0, ctx.default_scale)
        b = jckks.Ciphertext(c2, 2, 0, ctx.default_scale)
        out = {"mult0": jckks.multiply(ctx, a, b)}
        out["relin0"] = jckks.relinearize(ctx, out["mult0"], rk)
        out["rescale"] = jckks.rescale(ctx, out["relin0"])
        out["mult1"] = jckks.multiply(ctx, out["rescale"], out["rescale"])
        out["relin1"] = jckks.relinearize(ctx, out["mult1"], rk)
        return {k: v.c for k, v in out.items()}
    return step


@pytest.fixture(scope="module")
def inputs():
    """Per case: uniform residues over the JAX package's context primes."""
    R = np.random.default_rng(18)
    out = {}
    for name, (args, kw, limb, batched) in CASES.items():
        ctx = jckks.make_context(*args, **kw)
        d = ctx.k if ctx.ks_type == "I" else -(-ctx.k // ctx.alpha)
        lead = (2, 2) if batched else (2,)
        out[name] = (ctx, {"c1": _residues(R, ctx.q_primes, lead),
                           "c2": _residues(R, ctx.q_primes, lead),
                           "k0": _residues(R, ctx.qp_primes, (d,)),
                           "k1": _residues(R, ctx.qp_primes, (d,))})
    return out


@pytest.fixture(scope="module")
def ranks_running(inputs, tmp_path_factory):
    """The gloo ranks, started before the JAX side compiles (they need only
    the inputs), as a future of their results."""
    t = lambda a: interop._t(a, "cpu")
    cases = [{"name": name, "ctx_args": args, "ctx_kw": kw, "limb": limb, "batched": batched,
              **{k: t(v) for k, v in inputs[name][1].items()}}
             for name, (args, kw, limb, batched) in CASES.items()]
    pool = ThreadPoolExecutor(1)
    yield pool.submit(ranks.spawn, "ckks_step", WORLD, tmp_path_factory.mktemp("par_ckks"),
                      {"cases": cases})
    pool.shutdown()


@pytest.fixture(scope="module")
def ref(inputs, ranks_running):
    """Per case: the JAX single-device step's outputs (one per batch element,
    one compile per context), and at limb = 4 the JAX package's sharded run.
    XLA_FAST only cuts the compile time: the step is exact integer arithmetic,
    the same bits at every optimization level."""
    out, steps = {}, {}
    for name, (args, kw, limb, batched) in CASES.items():
        ctx, inp = inputs[name]
        key = (tuple(args[1]), tuple(sorted(kw.items())))
        if key not in steps:
            steps[key] = jax.jit(_step(ctx), compiler_options=XLA_FAST)
        f = steps[key]
        pairs = [(inp["c1"][i], inp["c2"][i]) for i in range(2)] if batched else \
            [(inp["c1"], inp["c2"])]
        single = [{k: np.asarray(v) for k, v in f(c1, c2, inp["k0"], inp["k1"]).items()}
                  for c1, c2 in pairs]
        sharded = None
        if limb == WORLD:
            mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(1, WORLD), ("dp", "limb"))
            ct_s = NamedSharding(mesh, P(None, "limb", None))
            rows = inp["k0"].shape[1]
            key_s = NamedSharding(mesh, P(None, "limb", None) if rows % WORLD == 0 else P())
            with mesh:
                sharded = jax.jit(_step(ctx), compiler_options=XLA_FAST)(
                    jax.device_put(jnp.asarray(inp["c1"]), ct_s),
                    jax.device_put(jnp.asarray(inp["c2"]), ct_s),
                    jax.device_put(jnp.asarray(inp["k0"]), key_s),
                    jax.device_put(jnp.asarray(inp["k1"]), key_s))
        out[name] = (inp, single, sharded)
    return out


@pytest.fixture(scope="module")
def run(ranks_running):
    return ranks_running.result()


def _block(rows: int, limb: int, j: int):
    """Mesh position j's rows of `rows` limbs: a block where they divide the
    limb axis, all of them where they do not."""
    if rows % limb:
        return slice(0, rows)
    m = rows // limb
    return slice(j * m, (j + 1) * m)


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_matches_jax_single_device(ref, run, name):
    _, single, _ = ref[name]
    _, _, limb, batched = CASES[name]
    levels = {"mult0": 0, "relin0": 0, "rescale": 1, "mult1": 1, "relin1": 1}
    for r in range(WORLD):
        dp_i, j = divmod(r, limb)
        want_all = single[dp_i]
        for op in OPS:
            local, placements, level = run[r][name]["steps"][op]
            got = interop.to_numpy(local)
            want = want_all[op]
            blk = _block(want.shape[-2], limb, j)
            if batched:
                assert got.shape[0] == 1, "a dp rank holds one of the batch's two pairs"
                got = got[0]
            np.testing.assert_array_equal(got, want[:, blk], err_msg=f"rank {r} {op}")
            assert level == levels[op]
            assert placements[-1].is_shard() == (want.shape[-2] % limb == 0)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[2] == WORLD])
def test_sharded_step_matches_jax_sharded_run(ref, run, name):
    """limb = 4: every rank's shard equals its own addressable shard of the
    JAX package's run on its 4-device mesh: GSPMD lays out every op's result
    as the port does (the limbs split while they divide 4, else replicated)."""
    _, _, sharded = ref[name]
    devs = jax.devices()
    for op in OPS:
        rows = sharded[op].shape[-2]
        for sh in sharded[op].addressable_shards:
            r = devs.index(sh.device)
            got = interop.to_numpy(run[r][name]["steps"][op][0])
            blk = _block(rows, WORLD, r)
            assert range(*sh.index[1].indices(rows)) == range(blk.start, blk.stop), (op, r)
            np.testing.assert_array_equal(got, np.asarray(sh.data), err_msg=f"rank {r} {op}")


@pytest.mark.parametrize("name", CASES)
def test_no_rank_holds_another_block_of_the_key(ref, run, name):
    inp, _, _ = ref[name]
    _, _, limb, _ = CASES[name]
    d, rows, n = inp["k0"].shape
    k = inp["c1"].shape[-2]
    p = rows - k
    local = (d, rows // limb, n) if rows % limb == 0 else (d, rows, n)
    for r in range(WORLD):
        rec = run[r][name]
        assert rec["key_local"] == (local, local)
        assert rec["received_key_rows"] == 0
        # ciphertext-sized traffic, per pair: each relinearize at most c2's ka rows
        # and the MAC'd pair's 2 (ka + p); rescale at most 2 (ka + 1)
        assert rec["received_rows"] <= (k + 2 * (k + p)) + 2 * (k + 1) + \
            ((k - 1) + 2 * (k - 1 + p))
    if name == "method2_limb4":
        assert rows % limb == 0 and local[1] == 3, "the Method-II key splits 4 ways"
