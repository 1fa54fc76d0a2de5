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


@pytest.mark.parametrize("n,limbs,batch", [(256, 3, 2), (2048, 4, 2), (4096, 2, 1),
                                           (32768, 2, 2), (65536, 12, 1),
                                           (65536, 16, 3)])
def test_ntt_kernel_matches_plain(dev, n, limbs, batch):
    primes = tnt.generate_ntt_primes(29, limbs, n)
    tb = tntt.build_ntt_tables(primes, n, device=dev)
    x = _residues(np.random.default_rng(n), primes, (batch, limbs, n), dev)
    f = tntt.ntt_fwd(x, tb)
    _equal(f, tntt.ntt_fwd_plain(x, tb))
    i = tntt.ntt_inv(f, tb)
    _equal(i, tntt.ntt_inv_plain(f, tb))
    _equal(i, x)


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


@pytest.mark.parametrize("k_in,k_out,n", [(4, 16, 65536), (2, 14, 65536), (3, 5, 256)])
def test_base_conv_kernel_matches_plain(dev, k_in, k_out, n):
    rng = np.random.default_rng(k_in)
    primes = tnt.generate_ntt_primes(29, k_in + k_out, n)
    conv = trns.BaseConv.build(primes[:k_in], primes[k_in:], dev)
    z = _residues(rng, primes[:k_in], (k_in, n), dev)
    want = trns.lazy_mac_mont(z[:, None, :], conv.mat_mont[:, :, None], conv.obase)
    _equal(conv.convert_from_digits(z), want)


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


def test_slice_on_card_matches_cpu(dev):
    """The CKKS slice at a small shape: keys from a CUDA generator, one
    multiply -> relinearize -> rescale on the card through the kernels, the
    same op on CPU copies through the plain path: identical residues."""
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.utils import rng

    n, q_bits = 4096, [29] * 6
    z = np.linspace(-1.0, 1.0, n // 2)
    ctx = ckks.make_context(n, q_bits, alpha=2, device=dev)
    g = rng.new_generator(3, dev)
    sk = ckks.keygen_secret(ctx, g)
    pk = ckks.keygen_public(ctx, g, sk)
    rk = ckks.keygen_relin(ctx, g, sk)
    c1 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z), g)
    c2 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z[::-1].copy()), g)
    kernels.reset_launches()
    out = ckks.rescale(ctx, ckks.relinearize(ctx, ckks.multiply(ctx, c1, c2), rk))
    assert all(kernels.launches.values()), kernels.launches
    assert np.abs(ckks.decode(ctx, ckks.decrypt(ctx, sk, out)) - z * z[::-1]).max() < 1e-3

    cctx = ckks.make_context(n, q_bits, alpha=2)
    cpu = lambda c: ckks.Ciphertext(c.c.cpu(), c.size, c.level, c.scale)
    want = ckks.rescale(cctx, ckks.relinearize(
        cctx, ckks.multiply(cctx, cpu(c1), cpu(c2)), ckks.KSKey(rk.k0.cpu(), rk.k1.cpu())))
    _equal(out.c.cpu(), want.c)
