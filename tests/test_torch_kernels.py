"""The hand-written CUDA kernels of heongpu_tpu_torch against their plain
torch versions, bit for bit, on the card.

Every test here needs a CUDA device (marker `cuda`) and skips without one.
This file imports no jax, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu_torch.ops import keyswitch2 as tks2  # noqa: E402
from heongpu_tpu_torch.ops import keyswitch_fused as tksf  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.ops import rns as trns  # noqa: E402
from heongpu_tpu_torch.utils import nt as tnt  # noqa: E402

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernels")
    return torch.device("cuda")


def _residues(rng, primes, shape, dev):
    p = np.array(primes, np.uint64)[:, None]
    x = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % p).astype(np.uint32)
    return tm.u32_to_i32(x).to(dev)


def _equal(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n,limbs,batch", [(256, 3, 2), (512, 3, 2), (1024, 2, 4),
                                           (2048, 4, 2), (4096, 2, 1), (8192, 2, 2),
                                           (16384, 2, 2), (32768, 2, 2), (65536, 12, 1),
                                           (65536, 12, 2), (65536, 16, 3)])
def test_ntt_kernel_matches_plain(dev, n, limbs, batch):
    primes = tnt.generate_ntt_primes(29, limbs, n)
    tb = tntt.build_ntt_tables(primes, n, device=dev)
    x = _residues(np.random.default_rng(n), primes, (batch, limbs, n), dev)
    f = tntt.ntt_fwd(x, tb)
    _equal(f, tntt.ntt_fwd_plain(x, tb))
    i = tntt.ntt_inv(f, tb)
    _equal(i, tntt.ntt_inv_plain(f, tb))
    _equal(i, x)


@pytest.mark.parametrize("n,d", [(256, 1), (8192, 2), (16384, 4), (32768, 8), (65536, 2),
                                 (65536, 16)])
def test_ntt_split_passes_match_plain_and_whole(dev, n, d):
    """K1's split entry: each pass on every rank's block equals its plain
    version, and with the exchange done by slicing the whole transform equals
    K1's, both ways (2 polys of 3 limbs)."""
    primes = tnt.generate_ntt_primes(29, 3, n)
    tb = tntt.build_ntt_tables(primes, n, device=dev)
    x = _residues(np.random.default_rng(n + d), primes * 2, (6, n), dev).view(2, 3, n)
    y = tntt.ntt_fwd(x, tb)
    for inverse, src, want in ((False, x, y), (True, y, x)):
        a, b = (tb.n2, tb.n1) if inverse else (tb.n1, tb.n2)
        blocks = src.view(2, 3, a, b)
        w = b // d
        sends = []
        for r in range(d):
            blk = blocks[..., r * w:(r + 1) * w].contiguous()
            sends.append(tntt.ntt_pass_cuda(blk, tb, inverse, 1, d, r))
            _equal(sends[-1], tntt.ntt_pass_plain(blk, tb, inverse, 1, d, r))
        outs = []
        for r in range(d):
            recv = torch.stack([s_[r] for s_ in sends])
            outs.append(tntt.ntt_pass_cuda(recv, tb, inverse, 2, d, r))
            _equal(outs[-1], tntt.ntt_pass_plain(recv, tb, inverse, 2, d, r))
        _equal(torch.cat(outs, dim=-1).reshape(2, 3, n), want)


def test_ntt_split_pass_rejects_partial_tiles(dev):
    for n, d in ((4096, 2), (8192, 4), (16384, 8), (32768, 16)):
        tb = tntt.build_ntt_tables(tnt.generate_ntt_primes(29, 1, n), n, device=dev)
        x = torch.zeros((1, tb.n1, tb.n2 // d), dtype=tm.I32, device=dev)
        with pytest.raises(ValueError, match="whole tiles"):
            tntt.ntt_pass_cuda(x, tb, False, 1, d, 0)


def test_ntt_kernel_leveled_tables(dev):
    n = 4096
    primes = tnt.generate_ntt_primes(29, 6, n)
    full = tntt.build_ntt_tables(primes, n, device=dev)
    tb = full.slice_limbs(0, 3).concat(full.slice_limbs(4, 6))
    x = _residues(np.random.default_rng(1), list(tb.primes), (2, 5, n), dev)
    _equal(tntt.ntt_fwd(x, tb), tntt.ntt_fwd_plain(x, tb))


@pytest.mark.parametrize("d,limbs,n", [(3, 16, 65536), (17, 4, 4096), (1, 2, 256)])
def test_mac_keys_kernel_matches_plain(dev, d, limbs, n):
    rng = np.random.default_rng(d)
    primes = tnt.generate_ntt_primes(29, limbs, n)
    base = trns.Base.build(primes, dev)
    dd, k0, k1 = (_residues(rng, primes, (d, limbs, n), dev) for _ in range(3))
    want = torch.stack([trns.lazy_mac_mont(dd, k0, base), trns.lazy_mac_mont(dd, k1, base)])
    _equal(trns.mac_keys(dd, k0, k1, base), want)


@pytest.mark.parametrize("k_in,k_out,n", [(4, 16, 65536), (2, 14, 65536), (3, 5, 256),
                                         (1, 5, 4096), (6, 4, 256), (8, 11, 32768),
                                         (10, 8, 32768), (29, 32, 32768), (31, 29, 32768),
                                         (5, 3, 4096), (14, 16, 16384), (16, 14, 16384),
                                         (40, 12, 4096), (62, 64, 65536)])
def test_base_conv_kernel_matches_plain(dev, k_in, k_out, n):
    """K2 base_conv at the widths its callers give it (BFV's lifts at N = 4096
    with three Q primes, 5 -> 3, and at N = 2^14 on the default chain, 14 -> 16 and
    16 -> 14; 40 and 62 input limbs in two chunks), unscaled (convert_from_digits)
    and with the scaling fused (BaseConv's call), B = 1 and 3."""
    rng = np.random.default_rng(k_in)
    primes = tnt.generate_ntt_primes(29, k_in + k_out, n)
    conv = trns.BaseConv.build(primes[:k_in], primes[k_in:], dev)
    z = _residues(rng, primes[:k_in], (k_in, n), dev)
    want = trns.lazy_mac_mont(z[:, None, :], conv.mat_mont[:, :, None], conv.obase)
    _equal(conv.convert_from_digits(z), want)
    z3 = _residues(rng, primes[:k_in] * 3, (3 * k_in, n), dev).view(3, k_in, n)
    _equal(conv(z3), trns.base_conv_plain(z3, conv.mat_mont, conv.obase, conv.scale))
    _equal(conv(z3), conv.convert_from_digits(conv.scaled_digits(z3)))


def test_base_conv_wrapper_rejects_odd_n(dev):
    primes = tnt.generate_ntt_primes(29, 10, 256)
    conv = trns.BaseConv.build(primes[:5], primes[5:], dev)
    with pytest.raises(ValueError, match="even N"):
        conv(torch.zeros((5, 255), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("k,p,n", [(12, 4, 65536), (48, 6, 65536), (30, 1, 32768), (1, 1, 256),
                                   (5, 2, 4096), (7, 3, 4096), (9, 5, 4096), (12, 8, 65536),
                                   (360, 16, 4096), (6, 20, 4096)])
def test_div_round_kernel_matches_plain(dev, k, p, n):
    """K6 against the stages one after another, with p = 1 to 20 special primes:
    360 + 16 limbs take a tile above 48 KB of shared memory, 20 stages two
    launches (16 and 4)."""
    from heongpu_tpu_torch import kernels
    q = tnt.generate_ntt_primes(29, k, n)
    specials = tnt.generate_ntt_primes(30, p, n)
    stages, remaining = [], q + specials
    for sp in reversed(specials):
        remaining = remaining[:-1]
        stages.append(trns.DivRoundLastq.build(remaining, sp, dev))
    chain = trns.DivRoundChain.build(stages)
    x = _residues(np.random.default_rng(k + p), (q + specials) * 2, (2 * (k + p), n), dev)
    x = x.view(2, k + p, n)
    before = kernels.launches["div_round"]
    got = chain(x)
    assert kernels.launches["div_round"] == before + len(chain.pieces)
    _equal(got, trns.div_round_chain_plain(x, chain))
    if p == 1:
        _equal(stages[0](x), got)


def test_div_round_wrapper_rejects_n_not_a_multiple_of_four(dev):
    """K6 copies 16 bytes at a time."""
    q = tnt.generate_ntt_primes(29, 3, 256)
    chain = trns.DivRoundChain.build([trns.DivRoundLastq.build(q[:2], q[2], dev)])
    with pytest.raises(ValueError, match="multiple of 4"):
        chain(torch.zeros((3, 254), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("k,p,n", [(29, 1, 32768), (1, 1, 256), (12, 3, 4096), (5, 20, 256)])
def test_div_exact_t_kernel_matches_plain(dev, k, p, n):
    """K6's t-exact mode (BGV's divisions) against the stages one after
    another: BGV's keyswitch ÷P on the 29-prime chain at N=2^15, a chain of 3,
    and one of 20 in two launches; columns whose centered v sits on either
    side of q_last/2."""
    from heongpu_tpu_torch import kernels
    t = tnt.generate_ntt_primes(20, 1, n)[0]
    q = tnt.generate_ntt_primes(29, k, n)
    specials = tnt.generate_ntt_primes(30, p, n)
    stages, remaining = [], q + specials
    for sp in reversed(specials):
        remaining = remaining[:-1]
        stages.append(trns.DivExactT.build(remaining, sp, t, dev))
    chain = trns.DivRoundChain.build(stages)
    x = _residues(np.random.default_rng(k + p), (q + specials) * 2, (2 * (k + p), n), dev)
    x = x.view(2, k + p, n)
    ql = specials[-1]
    for col, v in enumerate((0, ql // 2, ql // 2 + 1, ql - 1)):
        x[1, -1, col] = (-t * v) % ql
    before = kernels.launches["div_exact_t"], kernels.launches["div_round"]
    got = chain(x)
    assert (kernels.launches["div_exact_t"], kernels.launches["div_round"]) == (
        before[0] + len(chain.pieces), before[1])
    _equal(got, trns.div_round_chain_plain(x, chain))
    if p == 1:
        _equal(stages[0](x), got)


@pytest.mark.parametrize("limbs,shape,moved,mont", [
    (3, (256,), False, False), (5, (4, 256), True, True), (54, (12, 65536), True, True),
    (30, (29, 32768), True, True), (30, (32768,), False, True), (3, (2, 4, 100), False, False)])
def test_threefry_kernel_matches_plain(dev, limbs, shape, moved, mont):
    """K7 against the plain int64 Threefry draw: one row, d rows moved behind
    the limb axis (the regenerated key halves: the depth-48 bootstrap's
    (12, 54, 2^16), BGV's relin key (29, 30, 2^15)), a public key's row, and
    a draw of three axes."""
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.utils import threefry as ttf
    n = 65536 if limbs == 54 else 32768 if limbs == 30 else 256
    primes = tnt.generate_ntt_primes(29, limbs - 1, n) + tnt.generate_ntt_primes(30, 1, n)
    key = ttf.key_from_seed(2 ** 34 + limbs)
    before = kernels.launches["threefry_uniform"]
    got = ttf.uniform_rns(key, primes, shape, dev, moved=moved, mont=mont)
    assert kernels.launches["threefry_uniform"] == before + 1
    _equal(got, ttf.uniform_rns_plain(key, primes, shape, dev, moved=moved, mont=mont))


@pytest.mark.parametrize("shape", [(7,), (256,), (1 << 16,), (3, 4, 256), (1 << 20,)])
def test_threefry_bits_kernel_matches_plain(dev, shape):
    """K7's raw-words mode against the plain int64 Threefry words: odd,
    2^16 (a sort round of permutation at n = 2^16) and larger draws, one
    launch each through the dispatcher; randint and permutation on the card
    equal the CPU's, normal within 1e-6 (about one word in 65536 differs in
    its last places: the card's float64 log1p, rounded to float32) with its
    rounded σ = 3.2 gaussian integers equal (each of their word draws one
    launch)."""
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.utils import threefry as ttf
    key = ttf.key_from_seed(2 ** 34 + len(shape))
    before = kernels.launches["threefry_bits"]
    got = ttf.bits32(key, shape, dev)
    assert kernels.launches["threefry_bits"] == before + 1
    _equal(got, ttf.bits32_plain(key, shape, dev))
    n = shape[0]
    before = kernels.launches["threefry_bits"]
    draws = (ttf.randint(key, (n,), -(1 << 30), 1 << 30, dev), ttf.normal(key, (n,), dev),
             ttf.permutation(key, n, dev))
    assert kernels.launches["threefry_bits"] == before + 3 + ttf.permutation_rounds(n)
    assert torch.equal(draws[0].cpu(), ttf.randint(key, (n,), -(1 << 30), 1 << 30, "cpu"))
    assert torch.equal(draws[2].cpu(), ttf.permutation(key, n, "cpu"))
    want = ttf.normal(key, (n,), "cpu")
    torch.testing.assert_close(draws[1].cpu(), want, rtol=0, atol=1e-6)
    gauss = lambda g: torch.clamp(torch.round(g * 3.2), -19.2, 19.2)
    assert torch.equal(gauss(draws[1].cpu()), gauss(want))


def test_seeded_keys_on_card_match_cpu(dev):
    """A BGV relin key made seed-expanded on the card equals the CPU's (one
    DRBG seed), and a stripped copy regenerates its k1 with one K7 launch."""
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import bgv, ringkit
    from heongpu_tpu_torch.utils import rng
    out = {}
    for d in ("cpu", dev):
        ctx = bgv.make_context(1024, 12289, q_bits=[29] * 3, device=d)
        drbg = rng.new_drbg(b"q" * 32)
        sk = bgv.keygen_secret(ctx, drbg)
        out[str(d)] = (ctx, bgv.keygen_relin(ctx, drbg, sk, a_seed=2 ** 33 + 1))
    (_, rk_c), (ctx, rk_d) = out["cpu"], out[str(dev)]
    _equal(rk_d.k0.cpu(), rk_c.k0)
    _equal(rk_d.k1.cpu(), rk_c.k1)
    before = kernels.launches["threefry_uniform"]
    k1 = ringkit.ensure_k1(bgv._ring(ctx), ringkit.strip_seeded(rk_d))
    assert kernels.launches["threefry_uniform"] == before + 1
    _equal(k1, rk_d.k1)


def test_wrappers_reject_bad_input(dev):
    n = 256
    primes = tnt.generate_ntt_primes(29, 2, n)
    tb = tntt.build_ntt_tables(primes, n, device=dev)
    x = _residues(np.random.default_rng(0), primes, (2, n), dev)
    with pytest.raises(ValueError):
        tntt.ntt_cuda(x.to(torch.int64), tb, inverse=False)
    with pytest.raises(ValueError):
        tntt.ntt_cuda(x.t(), tb, inverse=False)
    with pytest.raises(ValueError):
        tntt.ntt_cuda(x.cpu(), tb, inverse=False)
    n = 128   # below the smallest shape the kernel is built for (n1 = 16)
    tb = tntt.build_ntt_tables(tnt.generate_ntt_primes(29, 2, n), n, device=dev)
    x = _residues(np.random.default_rng(0), tb.primes, (2, n), dev)
    for inverse in (False, True):
        with pytest.raises(ValueError, match=r"N = 2\^8 \.\. 2\^16"):
            tntt.ntt_cuda(x, tb, inverse)


def test_slice_on_card_matches_cpu(dev):
    """The CKKS slice at a small shape: keys from a CUDA generator, one
    multiply -> relinearize -> rescale on the card through the kernels, the
    same op on CPU copies through the plain path: identical residues."""
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.utils import rng

    n, q_bits = 4096, [29] * 6
    z = np.linspace(-1.0, 1.0, n // 2)
    ctx = ckks.make_context(n, q_bits, ks_type="II", alpha=2, device=dev)
    g = rng.new_generator(3, dev)
    sk = ckks.keygen_secret(ctx, g)
    pk = ckks.keygen_public(ctx, g, sk)
    rk = ckks.keygen_relin(ctx, g, sk)
    c1 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z), g)
    c2 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z[::-1].copy()), g)
    kernels.reset_launches()
    out = ckks.rescale(ctx, ckks.relinearize(ctx, ckks.multiply(ctx, c1, c2), rk))
    ckks_kernels = ("ntt_fwd", "ntt_inv", "keyswitch2_fused")
    assert all(kernels.launches[k] for k in ckks_kernels), kernels.launches
    assert np.abs(ckks.decode(ctx, ckks.decrypt(ctx, sk, out)) - z * z[::-1]).max() < 1e-3

    cctx = ckks.make_context(n, q_bits, ks_type="II", alpha=2, device="cpu")
    cpu = lambda c: ckks.Ciphertext(c.c.cpu(), c.size, c.level, c.scale)
    want = ckks.rescale(cctx, ckks.relinearize(
        cctx, ckks.multiply(cctx, cpu(c1), cpu(c2)), ckks.KSKey(rk.k0.cpu(), rk.k1.cpu())))
    _equal(out.c.cpu(), want.c)


@pytest.mark.parametrize("ka,alpha,p_count", [(4, 2, 2), (5, 2, 3), (12, 4, 4), (11, 4, 4)])
@pytest.mark.parametrize("n", [256, 2048, 4096, 32768, 65536])
def test_keyswitch_fused_kernel_matches_plain(dev, n, ka, alpha, p_count):
    """K5 against keyswitch2_fused_core_plain on the same inputs, on the card."""
    from heongpu_tpu_torch import kernels
    primes = tnt.generate_ntt_primes(29, ka + p_count, n)
    lvl = tks2.build_ks2_level(primes[:ka], primes[ka:], ka, alpha, dev)
    tb = tntt.build_ntt_tables(primes, n, device=dev)
    rng = np.random.default_rng(n + ka)
    d = len(lvl.groups)
    z = torch.cat([_residues(rng, primes[g[0]: g[-1] + 1], (len(g), n), dev) for g in lvl.groups])
    k0, k1 = (_residues(rng, primes, (d, ka + p_count, n), dev) for _ in range(2))
    mat = tksf.build_fused_mat(lvl, ka + p_count)
    before = kernels.launches["keyswitch2_fused"]
    got = tksf.keyswitch2_fused_core(z, mat, k0, k1, tb, lvl.groups)
    assert kernels.launches["keyswitch2_fused"] == before + 1
    _equal(got, tksf.keyswitch2_fused_core_plain(z, mat, k0, k1, tb, lvl.groups))


@pytest.mark.parametrize("ka,alpha,p_count", [(48, 4, 6), (46, 4, 6), (8, 4, 6)])
def test_keyswitch_fused_kernel_bootstrap_shapes(dev, ka, alpha, p_count):
    """K5 at the depth-48 bootstrap's shapes (N=2^13): 54-, 52- and 14-limb
    QP bases, 12 and 2 digits, against the plain core."""
    test_keyswitch_fused_kernel_matches_plain(dev, 8192, ka, alpha, p_count)


@pytest.mark.parametrize("d,limbs", [(12, 54), (12, 52), (2, 14)])
def test_mac_keys_kernel_bootstrap_shapes(dev, d, limbs):
    """K2 mac_keys over the bootstrap's hoisted digits (N=2^13)."""
    test_mac_keys_kernel_matches_plain(dev, d, limbs, 8192)


@pytest.mark.parametrize("k_in,k_out", [(4, 54), (4, 50), (2, 12)])
def test_base_conv_kernel_bootstrap_shapes(dev, k_in, k_out):
    """K2 base_conv of one digit group into the bootstrap's Q̃ bases (N=2^13)."""
    test_base_conv_kernel_matches_plain(dev, k_in, k_out, 8192)


def test_keyswitch_fused_wrapper_rejects_bad_input(dev):
    n, ka, alpha = 256, 4, 2
    primes = tnt.generate_ntt_primes(29, ka + alpha, n)
    lvl = tks2.build_ks2_level(primes[:ka], primes[ka:], ka, alpha, dev)
    tb = tntt.build_ntt_tables(primes, n, device=dev)
    rng = np.random.default_rng(0)
    z = _residues(rng, primes[:ka], (ka, n), dev)
    k0 = _residues(rng, primes, (2, ka + alpha, n), dev)
    mat = tksf.build_fused_mat(lvl, ka + alpha)
    for args in ((z.cpu(), mat, k0, k0), (z, mat, k0.transpose(1, 2).contiguous().transpose(1, 2), k0),
                 (z, mat, k0[:1].contiguous(), k0[:1].contiguous()), (z.to(torch.int64), mat, k0, k0)):
        with pytest.raises(ValueError):
            tksf.keyswitch2_fused_cuda(*args, tb, lvl.groups)
    n = 128   # below the smallest shape the kernel is built for (n1 = 16)
    tb = tntt.build_ntt_tables(tnt.generate_ntt_primes(29, ka + alpha, n), n, device=dev)
    z = _residues(rng, tb.primes[:ka], (ka, n), dev)
    k0 = _residues(rng, tb.primes, (2, ka + alpha, n), dev)
    with pytest.raises(ValueError, match="N >= 2"):
        tksf.keyswitch2_fused_cuda(z, mat, k0, k0, tb, lvl.groups)


def test_rotations_on_card_match_cpu(dev):
    """rotate (K5) and hoist + rotate_hoisted (K1, K2) on the card equal the
    CPU plain path on copies of the same keys and ciphertext, and decode."""
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.models import ringkit
    from heongpu_tpu_torch.ops import polyops
    from heongpu_tpu_torch.utils import rng

    n, q_bits = 4096, [29] * 6
    z = np.random.default_rng(3).uniform(0, 1, n // 2)
    ctx = ckks.make_context(n, q_bits, ks_type="II", alpha=2, device=dev)
    g = rng.new_generator(5, dev)
    sk = ckks.keygen_secret(ctx, g)
    pk = ckks.keygen_public(ctx, g, sk)
    gk = ckks.keygen_galois(ctx, g, sk, steps=[1, 2])
    ct = ckks.encrypt(ctx, pk, ckks.encode(ctx, z), g)
    kernels.reset_launches()
    rot = ckks.rotate(ctx, ct, gk, 3)
    d = ckks.hoist(ctx, ct)
    one = gk.keys[polyops.steps_to_galois_elt(1, n)]
    hro = ckks.rotate_hoisted(ctx, ct, d, one)
    assert all(kernels.launches[k] for k in ("keyswitch2_fused", "mac_keys", "base_conv")), \
        kernels.launches
    for got, step in ((rot, 3), (hro, 1)):
        err = np.abs(ckks.decode(ctx, ckks.decrypt(ctx, sk, got)) - np.roll(z, -step)).max()
        assert err < 1e-3, (step, err)

    cctx = ckks.make_context(n, q_bits, ks_type="II", alpha=2, device="cpu")
    cpu = lambda c: ckks.Ciphertext(c.c.cpu(), c.size, c.level, c.scale)
    cone = ringkit.GaloisKeyOne(*(t.cpu() for t in (one.k0, one.k1, one.perm_coeff_src,
                                                    one.perm_coeff_neg, one.perm_ntt)),
                                one.galois_elt, one.inv_form)
    _equal(ckks.apply_galois(cctx, cpu(ct), cone).c, ckks.apply_galois(ctx, ct, one).c.cpu())
    want = ckks.rotate_hoisted(cctx, cpu(ct), ckks.hoist(cctx, cpu(ct)), cone)
    _equal(hro.c.cpu(), want.c)


# ---------------------------------------------------------------------------
# TFHE: K1 on the 2-limb N=1024 table, K3/K4 (the blind rotation) against the
# plain chains, and gates through the kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tfhe_keys():
    """lwe_n -> (ctx, generator, sk, BootKey, BootKey2) on the card, built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernels")
    from heongpu_tpu_torch.models import tfhe
    from heongpu_tpu_torch.utils import rng
    cache = {}

    def get(lwe_n):
        if lwe_n not in cache:
            ctx = tfhe.make_context(lwe_n, device="cuda")
            g = rng.new_generator(lwe_n, "cuda")
            sk = tfhe.keygen_secret(g, lwe_n, device="cuda")
            cache[lwe_n] = (ctx, g, sk, tfhe.keygen_boot(ctx, g, sk),
                            tfhe.keygen_boot_unrolled(ctx, g, sk))
        return cache[lwe_n]
    return get


def test_ntt_kernel_tfhe_table(dev):
    from heongpu_tpu_torch.models import tfhe
    tb = tfhe.make_context(16, device=dev).ntt
    x = _residues(np.random.default_rng(7), list(tb.primes), (37, 2, 2, 1024), dev)
    f = tntt.ntt_fwd(x, tb)
    _equal(f, tntt.ntt_fwd_plain(x, tb))
    i = tntt.ntt_inv(f, tb)
    _equal(i, tntt.ntt_inv_plain(f, tb))
    _equal(i, x)


@pytest.mark.parametrize("unrolled", [False, True])
@pytest.mark.parametrize("lwe_n,batch", [(16, 1), (16, 8), (16, 37), (16, 132), (16, 133),
                                         (512, 1), (512, 8), (512, 37)])
def test_blind_rotate_kernel_matches_plain(tfhe_keys, lwe_n, batch, unrolled):
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import tfhe
    from heongpu_tpu_torch.ops import tfhe_kernel as tk
    ctx, g, sk, bk, bk2 = tfhe_keys(lwe_n)
    bits = np.random.default_rng(batch).integers(0, 2, batch)
    acc, a_t = tfhe._boot_prologue(ctx, tfhe.encrypt(ctx, sk, bits, g))
    key = bk2.bk2 if unrolled else bk.bk
    plain = tfhe.blind_rotate2_plain if unrolled else tfhe.blind_rotate_plain
    name = "blind_rotate2" if unrolled else "blind_rotate"
    before = kernels.launches[name]
    got = (tk.blind_rotate2 if unrolled else tk.blind_rotate)(acc, a_t, key, ctx)
    assert kernels.launches[name] == before + 1
    _equal(got, plain(acc, a_t, key, ctx))


@pytest.mark.parametrize("unrolled", [False, True])
def test_blind_rotate_kernel_random_accumulator(tfhe_keys, unrolled):
    """An accumulator of uniform random residues (its CRT lift over all of [0, P),
    across the P/2 wrap) and rotation amounts holding the X^a edges 0, 1, N-1, N,
    2N-1: the kernel equals the plain chain bit for bit."""
    from heongpu_tpu_torch.models import tfhe
    from heongpu_tpu_torch.ops import tfhe_kernel as tk
    ctx, _, _, bk, bk2 = tfhe_keys(16)
    rng = np.random.default_rng(17)
    acc = _residues(rng, list(ctx.primes), (5, 2, 2, ctx.N), dev=ctx.device)
    N = ctx.N
    a = np.resize(np.array([0, 1, N - 1, N, 2 * N - 1], np.int32), (5, ctx.n))
    a[3] = rng.integers(0, 2 * N, ctx.n)
    a_t = torch.from_numpy(a).to(ctx.device)
    key = bk2.bk2 if unrolled else bk.bk
    plain = tfhe.blind_rotate2_plain if unrolled else tfhe.blind_rotate_plain
    _equal(tk.blind_rotate_cuda(acc, a_t, key, ctx, unrolled), plain(acc, a_t, key, ctx))


@pytest.mark.parametrize("unrolled", [False, True])
def test_gates_on_card(tfhe_keys, unrolled):
    """Truth tables at STD128 (n=512) through the kernel path, B=64."""
    from heongpu_tpu_torch.models import tfhe
    ctx, g, sk, bk, bk2 = tfhe_keys(512)
    key = bk2 if unrolled else bk
    r = np.random.default_rng(3)
    x, y, s = (r.integers(0, 2, 64).astype(bool) for _ in range(3))
    cx, cy, cs = (tfhe.encrypt(ctx, sk, v, g) for v in (x, y, s))
    want = {"NAND": ~(x & y), "AND": x & y, "OR": x | y, "NOR": ~(x | y),
            "XOR": x ^ y, "XNOR": ~(x ^ y)}
    for gate, w in want.items():
        np.testing.assert_array_equal(tfhe.decrypt(ctx, sk, getattr(tfhe, gate)(ctx, key, cx, cy)),
                                      w, err_msg=gate)
    np.testing.assert_array_equal(tfhe.decrypt(ctx, sk, tfhe.MUX(ctx, key, cs, cx, cy)),
                                  np.where(s, x, y))


def test_blind_rotate_wrappers_reject_bad_input(tfhe_keys):
    from heongpu_tpu_torch.models import tfhe
    from heongpu_tpu_torch.ops import tfhe_kernel as tk
    ctx, g, sk, bk, _ = tfhe_keys(16)
    acc, a_t = tfhe._boot_prologue(ctx, tfhe.encrypt(ctx, sk, np.ones(4), g))
    for args in ((acc.cpu(), a_t.cpu(), bk.bk.cpu()),
                 (acc.to(torch.int64), a_t, bk.bk),
                 (acc, a_t.t().contiguous().t(), bk.bk),
                 (acc, a_t[:, :12].contiguous(), bk.bk[:12].contiguous()),
                 (acc, a_t, torch.empty(bk.bk.numel() + 1, dtype=torch.int32,
                                        device=acc.device)[1:].view(bk.bk.shape))):
        with pytest.raises(ValueError):
            tk.blind_rotate_cuda(*args, ctx)
