"""Port parity: heongpu_tpu_torch.ops.rns / keyswitch2 against the reference.

BaseConv (with the scaling fused into the conversion, as K2 takes it, and
without), the lazy Montgomery MAC, DivRoundLastq and the ÷P chain
DivRoundChain on random residues, and
the staged Method-II keyswitch over all four in/out NTT-domain combinations
(the pattern of tests/test_keyswitch_fused.py), plus one combination against
the reference's fused Pallas keyswitch in interpret mode — all
bit-identical.  The CUDA kernels are held against the plain version in
tests/test_torch_kernels.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from heongpu_tpu.ops import keyswitch2 as jks2  # noqa: E402
from heongpu_tpu.ops import keyswitch_pallas as jksp  # noqa: E402
from heongpu_tpu.ops import ntt as jntt  # noqa: E402
from heongpu_tpu.ops import rns as jrns  # noqa: E402
from heongpu_tpu_torch.ops import keyswitch2 as tks2  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.ops import rns as trns  # noqa: E402
from heongpu_tpu_torch.utils import nt as tnt  # noqa: E402

torch.set_num_threads(2)

N = 256


def _np(t):
    return t.cpu().numpy().view(np.uint32)


def _t(a):
    return tm.u32_to_i32(np.asarray(a))


def _residues(rng, primes, shape):
    """shape (..., L, n) with limb axis -2 over `primes`."""
    p = np.array(primes, np.uint64)[:, None]
    return (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % p).astype(np.uint32)


PRIMES = tnt.generate_ntt_primes(29, 6, N) + tnt.generate_ntt_primes(30, 2, N)
# enough primes for the widest conversions (31 -> 29, 4 -> 54) and ÷P chains (48 + 6)
WIDE = tnt.generate_ntt_primes(29, 60, N) + tnt.generate_ntt_primes(30, 6, N)


def test_base_fields_match():
    jb, tb = jrns.Base.build(PRIMES), trns.Base.build(PRIMES, "cpu")
    for f in ("p", "pinv", "mu", "r1"):
        np.testing.assert_array_equal(_np(getattr(tb, f)), np.asarray(getattr(jb, f)), f)


# the three first cases, then widths that K2's callers give it: the alpha groups,
# BFV's lifts (5 -> 3 at N = 4096 with three Q primes, 14 -> 16 at N = 2^14, 29 -> 32
# and 31 -> 29 at N = 2^15), and 40 input limbs (two of the kernel's chunks)
@pytest.mark.parametrize("k_in,k_out", [(2, 8), (3, 5), (1, 4), (4, 16), (4, 54), (6, 7),
                                        (8, 11), (10, 8), (29, 32), (31, 29), (5, 3),
                                        (14, 16), (40, 12)])
def test_base_conv_matches(k_in, k_out):
    rng = np.random.default_rng(k_in * 10 + k_out)
    ins, outs = WIDE[:k_in], WIDE[-k_out:]
    jc, tc = jrns.BaseConv.build(ins, outs), trns.BaseConv.build(ins, outs, "cpu")
    np.testing.assert_array_equal(_np(tc.mat_mont), np.asarray(jc.mat_mont))
    np.testing.assert_array_equal(_np(tc.qhat_inv), np.asarray(jc.qhat_inv))
    np.testing.assert_array_equal(_np(tc.scale[1:]),
                                  np.stack([np.asarray(jc.qhat_inv), np.asarray(jc.qhat_inv_sh)]))
    x = _residues(rng, ins, (2, k_in, N))
    want = jc(jnp.asarray(x))
    got = tc(_t(x))
    assert got.shape == (2, k_out, N)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # the fused form K2 takes: the scaling inside the conversion
    fused = trns.base_conv_plain(_t(x), tc.mat_mont, tc.obase, tc.scale)
    np.testing.assert_array_equal(_np(fused), np.asarray(want))
    z = jc.scaled_digits(jnp.asarray(x))
    np.testing.assert_array_equal(_np(tc.scaled_digits(_t(x))), np.asarray(z))
    np.testing.assert_array_equal(_np(tc.convert_from_digits(_t(np.asarray(z)))),
                                  np.asarray(jc.convert_from_digits(z)))


@pytest.mark.parametrize("d", [1, 3, 17, 33])
def test_lazy_mac_mont_matches(d):
    """d > 16 crosses the reference's 16-product fold boundary."""
    rng = np.random.default_rng(d)
    base_j, base_t = jrns.Base.build(PRIMES), trns.Base.build(PRIMES, "cpu")
    dd = _residues(rng, PRIMES, (d, len(PRIMES), N))
    kk = _residues(rng, PRIMES, (d, len(PRIMES), N))
    want = jrns.lazy_mac_mont(jnp.asarray(dd), jnp.asarray(kk), base_j)
    np.testing.assert_array_equal(_np(trns.lazy_mac_mont(_t(dd), _t(kk), base_t)),
                                  np.asarray(want))
    got2 = trns.mac_keys(_t(dd), _t(kk), _t(dd), base_t)
    np.testing.assert_array_equal(_np(got2[0]), np.asarray(want))
    np.testing.assert_array_equal(
        _np(got2[1]), np.asarray(jrns.lazy_mac_mont(jnp.asarray(dd), jnp.asarray(dd), base_j)))


def test_div_round_lastq_matches():
    rng = np.random.default_rng(3)
    q, last = PRIMES[:5], PRIMES[5]
    jd, td = jrns.DivRoundLastq.build(q, last), trns.DivRoundLastq.build(q, last, "cpu")
    x = _residues(rng, q + [last], (2, 6, N))
    x[0, :, :3] = 0
    x[0, -1, 3] = last - 1
    np.testing.assert_array_equal(_np(td(_t(x))), np.asarray(jd(jnp.asarray(x))))


@pytest.mark.parametrize("p", [1, 4, 6])
@pytest.mark.parametrize("k", [12, 48])
def test_div_round_chain_matches(k, p):
    """The port's ÷P chain (DivRoundChain, plain path on the CPU) against the JAX
    package's DivRoundLastq stages applied one after another."""
    rng = np.random.default_rng(k * 10 + p)
    q, specials = WIDE[:k], WIDE[-p:]
    jstages, tstages, remaining = [], [], q + specials
    for sp in reversed(specials):
        remaining = remaining[:-1]
        jstages.append(jrns.DivRoundLastq.build(remaining, sp))
        tstages.append(trns.DivRoundLastq.build(remaining, sp, "cpu"))
    chain = trns.DivRoundChain.build(tstages)
    assert (chain.k, len(chain)) == (k, p)
    x = _residues(rng, q + specials, (2, k + p, N))
    x[0, :, :3] = 0
    x[1, :, :3] = np.array(q + specials, np.uint32)[:, None] - 1
    want = jnp.asarray(x)
    for stage in jstages:
        want = stage(want)
    got = chain(_t(x))
    assert got.shape == (2, k, N)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_div_round_chain_pieces_match():
    """A chain longer than one K6 launch takes (20 stages) cut into pieces of 16
    and 4: the pieces one after another equal the JAX package's stage loop."""
    rng = np.random.default_rng(20)
    q, specials = WIDE[:12], WIDE[-20:]
    jstages, tstages, remaining = [], [], q + specials
    for sp in reversed(specials):
        remaining = remaining[:-1]
        jstages.append(jrns.DivRoundLastq.build(remaining, sp))
        tstages.append(trns.DivRoundLastq.build(remaining, sp, "cpu"))
    chain = trns.DivRoundChain.build(tstages)
    assert [len(c) for c in chain.pieces] == [16, 4]
    assert [c.k for c in chain.pieces] == [16, 12]
    x = _residues(rng, q + specials, (2, 32, N))
    want = jnp.asarray(x)
    for stage in jstages:
        want = stage(want)
    got = _t(x)
    for piece in chain.pieces:
        got = piece(got)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(chain(_t(x))), np.asarray(want))


def test_div_round_chain_rejects_stages_out_of_order():
    q, specials = WIDE[:4], WIDE[-2:]
    first = trns.DivRoundLastq.build(q + specials[:1], specials[1], "cpu")
    with pytest.raises(ValueError, match="last limb"):
        trns.DivRoundChain.build([first, trns.DivRoundLastq.build(q, specials[1], "cpu")])


def _ks_setup(ka, alpha, seed=7):
    primes = tnt.generate_ntt_primes(29, ka + alpha, N)
    q_primes, p_primes = primes[:ka], primes[ka:]
    jl = jks2.build_ks2_level(q_primes, p_primes, ka, alpha)
    tl = tks2.build_ks2_level(q_primes, p_primes, ka, alpha, "cpu")
    assert jl.groups == tl.groups
    rng = np.random.default_rng(seed)
    d_t = len(tl.groups)
    poly = _residues(rng, q_primes, (ka, N))
    k0 = _residues(rng, primes, (d_t, ka + alpha, N))
    k1 = _residues(rng, primes, (d_t, ka + alpha, N))
    j = (jl, jntt.build_ntt_tables(primes, N), jrns.Base.build(primes),
         jntt.build_ntt_tables(q_primes, N))
    t = (tl, tntt.build_ntt_tables(primes, N, "cpu"), trns.Base.build(primes, "cpu"),
         tntt.build_ntt_tables(q_primes, N, "cpu"))
    return poly, k0, k1, j, t


@pytest.mark.parametrize("ka,alpha", [(4, 2), (5, 2)])
@pytest.mark.parametrize("in_ntt,out_ntt", [(False, False), (True, True),
                                            (True, False), (False, True)])
def test_keyswitch2_matches(ka, alpha, in_ntt, out_ntt):
    poly, k0, k1, (jl, jqp, jb, jq), (tl, tqp, tb, tq) = _ks_setup(ka, alpha)
    ks = jax.jit(jks2.keyswitch2, static_argnames=("in_ntt", "out_ntt"))
    want0, want1 = ks(jnp.asarray(poly), jnp.asarray(k0), jnp.asarray(k1), jl, jqp, jb,
                      in_ntt=in_ntt, out_ntt=out_ntt, ntt_q_level=jq)
    got0, got1 = tks2.keyswitch2(_t(poly), _t(k0), _t(k1), tl, tqp, tb,
                                 in_ntt, out_ntt, tq)
    np.testing.assert_array_equal(_np(got0), np.asarray(want0))
    np.testing.assert_array_equal(_np(got1), np.asarray(want1))


def test_keyswitch2_matches_fused_pallas_interpret():
    poly, k0, k1, (jl, jqp, jb, jq), (tl, tqp, tb, tq) = _ks_setup(5, 2, seed=11)
    want0, want1 = jksp.keyswitch2_fused(
        jnp.asarray(poly), jnp.asarray(k0), jnp.asarray(k1), jl, jqp, jb,
        True, True, jq, interpret=True)
    got0, got1 = tks2.keyswitch2(_t(poly), _t(k0), _t(k1), tl, tqp, tb, True, True, tq)
    np.testing.assert_array_equal(_np(got0), np.asarray(want0))
    np.testing.assert_array_equal(_np(got1), np.asarray(want1))
