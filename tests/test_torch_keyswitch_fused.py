"""Port parity for the fused Method-II keyswitch core (ops/keyswitch_fused.py)
against the reference's Pallas kernel, run by the Pallas interpreter on the
CPU, and against the reference's staged path at the bench's digit structure.

Inputs are made with numpy from a seed and handed to both packages; every
comparison is exact (residues bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.ops import keyswitch2 as jks2  # noqa: E402
from heongpu_tpu.ops import keyswitch_pallas as jksp  # noqa: E402
from heongpu_tpu.ops import ntt as jntt  # noqa: E402
from heongpu_tpu.ops import rns as jrns  # noqa: E402
from heongpu_tpu.utils import nt as jnt  # noqa: E402
from heongpu_tpu_torch.ops import keyswitch2 as tks2  # noqa: E402
from heongpu_tpu_torch.ops import keyswitch_fused as tksf  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.ops import rns as trns  # noqa: E402

torch.set_num_threads(2)


def _setup(n, ka, alpha, p_count, seed):
    """Both packages' level tables and one (poly, k0, k1) input from a seed."""
    primes = jnt.generate_ntt_primes(29, ka + p_count, n)
    q, p = primes[:ka], primes[ka:]
    j = (jks2.build_ks2_level(q, p, ka, alpha), jntt.build_ntt_tables(primes, n),
         jrns.Base.build(primes), jntt.build_ntt_tables(q, n))
    t = (tks2.build_ks2_level(q, p, ka, alpha, "cpu"), tntt.build_ntt_tables(primes, n, "cpu"),
         trns.Base.build(primes, "cpu"), tntt.build_ntt_tables(q, n, "cpu"))
    rng = np.random.default_rng(seed)
    d = len(j[0].groups)
    poly = rng.integers(0, np.array(q)[:, None], (ka, n)).astype(np.uint32)
    k0, k1 = (rng.integers(0, np.array(primes)[None, :, None], (d, ka + p_count, n))
              .astype(np.uint32) for _ in range(2))
    return j, t, (poly, k0, k1)


def _t(a):
    return tm.u32_to_i32(np.asarray(a))


@pytest.mark.parametrize("ka,alpha,p_count", [(4, 2, 2), (5, 2, 2), (12, 4, 4), (11, 4, 4),
                                              (5, 2, 3)])
def test_build_fused_mat_matches(ka, alpha, p_count):
    (jl, *_), (tl, *_), _ = _setup(256, ka, alpha, p_count, 0)
    kqp = ka + p_count
    got = tksf.build_fused_mat(tl, kqp)
    assert got.shape == (len(tl.groups) * alpha, kqp) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(jksp.build_fused_mat(jl, kqp)))


@pytest.mark.parametrize("ka,alpha", [(4, 2), (5, 2)])
def test_fused_matches_pallas_interpreter(ka, alpha):
    j, t, (poly, k0, k1) = _setup(256, ka, alpha, alpha, 7)
    jp, tp = jnp.asarray(poly), _t(poly)
    for in_ntt, out_ntt in [(False, False), (True, True), (True, False), (False, True)]:
        want = jksp.keyswitch2_fused(jp, jnp.asarray(k0), jnp.asarray(k1), *j[:3],
                                     in_ntt, out_ntt, j[3], interpret=True)
        got = tksf.keyswitch2_fused(tp, _t(k0), _t(k1), *t[:3], in_ntt, out_ntt, t[3])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w),
                                          err_msg=str((in_ntt, out_ntt)))


@pytest.mark.parametrize("ka,alpha,p_count", [(12, 4, 4), (11, 4, 4), (5, 2, 3)])
def test_fused_matches_staged_reference(ka, alpha, p_count):
    """The bench's digit structure (3 digits of 4, a short last group at
    level 1) and p_count > alpha, at N=1024: the port's keyswitch2 (which
    routes a 2-D poly through the fused core) equals the reference's staged
    keyswitch2, and so does the port's own staged path on a batch of one."""
    j, t, (poly, k0, k1) = _setup(1024, ka, alpha, p_count, ka)
    staged_ref = jax.jit(jks2.keyswitch2, static_argnums=(6, 7))
    want = staged_ref(jnp.asarray(poly), jnp.asarray(k0), jnp.asarray(k1), *j[:3], True, True,
                      j[3])
    got = tks2.keyswitch2(_t(poly), _t(k0), _t(k1), *t[:3], True, True, t[3])
    staged = tks2.keyswitch2(_t(poly)[None], _t(k0), _t(k1), *t[:3], True, True, t[3])
    for g, s, w in zip(got, staged, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
        np.testing.assert_array_equal(s[0].numpy().view(np.uint32), np.asarray(w))


def test_core_dispatch_and_checks():
    """A CPU tensor takes the plain core; the CUDA wrapper refuses CPU
    tensors instead of falling back."""
    (jl, *_), (tl, tb, *_), (poly, k0, k1) = _setup(256, 4, 2, 2, 3)
    z = torch.cat([c.scaled_digits(_t(poly)[g[0]: g[-1] + 1])
                   for c, g in zip(tl.convs, tl.groups)])
    mat = tksf.build_fused_mat(tl, 6)
    got = tksf.keyswitch2_fused_core(z, mat, _t(k0), _t(k1), tb, tl.groups)
    assert got.shape == (2, 6, 256)
    torch.testing.assert_close(got, tksf.keyswitch2_fused_core_plain(z, mat, _t(k0), _t(k1),
                                                                     tb, tl.groups),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        tksf.keyswitch2_fused_cuda(z, mat, _t(k0), _t(k1), tb, tl.groups)
