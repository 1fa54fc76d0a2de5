"""Port parity: heongpu_tpu_torch.ops.ntt against heongpu_tpu.ops.ntt.

Tables field by field, the storage order, and the plain transforms against
the reference's stage path, its Pallas kernel in interpret mode, and the
O(N^2) host DFT — all bit-identical.  The CUDA kernel is held against the
plain version in tests/test_torch_kernels.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from heongpu_tpu.ops import ntt as jntt  # noqa: E402
from heongpu_tpu.ops import ntt_pallas  # noqa: E402
from heongpu_tpu.utils import nt as jnt  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.utils import nt as tnt  # noqa: E402

torch.set_num_threads(2)

_TABLES = ("p", "pinv", "r2", "mu", "r1", "r1_sh", "psi", "psi_sh", "ipsi_n",
           "ipsi_n_sh", "tw_mat", "tw_mat_sh", "itw_mat", "itw_mat_sh")
_STAGES = ("tw1", "tw1_sh", "itw1", "itw1_sh", "tw2", "tw2_sh", "itw2", "itw2_sh")


def _np(t):
    return t.cpu().numpy().view(np.uint32)


def _both(n, limbs, bits=29):
    primes = tnt.generate_ntt_primes(bits, limbs, n)
    assert primes == jnt.generate_ntt_primes(bits, limbs, n)
    return primes, jntt.build_ntt_tables(primes, n), tntt.build_ntt_tables(primes, n, "cpu")


def _residues(primes, n, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    p = np.array(primes, np.uint64)[:, None]
    return (rng.integers(0, 1 << 62, size=lead + (len(primes), n), dtype=np.uint64)
            % p).astype(np.uint32)


def _assert_tables_equal(jt, tt):
    assert (jt.n, jt.logn, jt.n1, jt.n2) == (tt.n, tt.logn, tt.n1, tt.n2)
    for f in _TABLES:
        np.testing.assert_array_equal(_np(getattr(tt, f)), np.asarray(getattr(jt, f)), f)
    for f in _STAGES:
        js, ts = getattr(jt, f), getattr(tt, f)
        assert len(js) == len(ts), f
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(_np(b), np.asarray(a), f)


@pytest.mark.parametrize("n,limbs", [(256, 3), (2048, 2), (4096, 2)])
def test_tables_equal(n, limbs):
    _, jt, tt = _both(n, limbs)
    _assert_tables_equal(jt, tt)
    np.testing.assert_array_equal(tntt.eval_order(n), jntt.eval_order(n))
    np.testing.assert_array_equal(tntt.inv_eval_order(n), jntt.inv_eval_order(n))
    assert tntt.split_n(n) == jntt.split_n(n)


def test_slice_and_concat_tables():
    _, jt, tt = _both(1024, 4)
    _assert_tables_equal(jt.slice_limbs(1, 3), tt.slice_limbs(1, 3))
    cat = tt.slice_limbs(0, 1).concat(tt.slice_limbs(2, 4))
    assert cat.primes == tt.primes[:1] + tt.primes[2:]
    for f in _TABLES + ("tw1p", "itw2p_sh"):
        np.testing.assert_array_equal(
            _np(getattr(cat, f)), np.concatenate([_np(getattr(tt, f))[:1],
                                                  _np(getattr(tt, f))[2:]]))


@pytest.mark.parametrize("n,limbs,lead", [(256, 3, (2,)), (512, 2, (3,)),
                                          (1024, 3, ()), (2048, 2, (2, 2)),
                                          (4096, 2, (2,))])
def test_plain_matches_reference_stages(n, limbs, lead):
    primes, jt, tt = _both(n, limbs)
    x = _residues(primes, n, lead, seed=n)
    f_want = np.asarray(jax.jit(jntt.ntt_fwd)(jnp.asarray(x), jt))
    f_got = tntt.ntt_fwd(tm.u32_to_i32(x), tt)
    assert f_got.dtype == torch.int32 and f_got.shape == x.shape
    np.testing.assert_array_equal(_np(f_got), f_want)
    i_got = tntt.ntt_inv(tm.u32_to_i32(f_want), tt)
    i_want = jax.jit(jntt.ntt_inv)(jnp.asarray(f_want), jt)
    np.testing.assert_array_equal(_np(i_got), np.asarray(i_want))
    np.testing.assert_array_equal(_np(i_got), x)


# the shapes of tests/test_ntt_pallas.py: symmetric and asymmetric splits
@pytest.mark.parametrize("n,limbs", [(256, 3), (512, 3), (1024, 2), (2048, 4)])
def test_plain_matches_pallas_interpret(n, limbs):
    primes, jt, tt = _both(n, limbs)
    x = _residues(primes, n, (2,), seed=n + limbs)
    want_f = ntt_pallas.ntt_pallas(jnp.asarray(x), jt, inverse=False, interpret=True)
    np.testing.assert_array_equal(_np(tntt.ntt_fwd(tm.u32_to_i32(x), tt)), np.asarray(want_f))
    want_i = ntt_pallas.ntt_pallas(want_f, jt, inverse=True, interpret=True)
    np.testing.assert_array_equal(
        _np(tntt.ntt_inv(tm.u32_to_i32(np.asarray(want_f)), tt)), np.asarray(want_i))


def test_plain_matches_naive_dft():
    n = 64
    primes, _, tt = _both(n, 2)
    x = _residues(primes, n, seed=5)
    got = _np(tntt.ntt_fwd(tm.u32_to_i32(x), tt))
    eo = tntt.eval_order(n)
    for li, p in enumerate(primes):
        psi = int(_np(tt.psi)[li, 1])
        want = np.array(tntt.ntt_naive_host([int(v) for v in x[li]], p, psi), np.uint32)
        np.testing.assert_array_equal(got[li], want[eo])
        assert tntt.ntt_naive_host([1, 2, 3], p, psi) == jntt.ntt_naive_host([1, 2, 3], p, psi)


@pytest.mark.parametrize("n", [256, 2048])
def test_galois_tables_match(n):
    from heongpu_tpu.ops import polyops as jpoly
    from heongpu_tpu_torch.ops import polyops as tpoly
    for g in (5, 25, 2 * n - 1):
        for got, want in zip(tpoly.galois_perm_coeff(g, n, "cpu"), jpoly.galois_perm_coeff(g, n)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
        np.testing.assert_array_equal(tpoly.galois_perm_ntt(g, n, "cpu").numpy(),
                                      np.asarray(jpoly.galois_perm_ntt(g, n)))


def test_rejects_mismatched_shape():
    primes, _, tt = _both(256, 2)
    with pytest.raises(ValueError):
        tntt.ntt_fwd(torch.zeros((3, 256), dtype=torch.int32), tt)
