"""The plain reference against the port's CPU path on tiny contexts defined
here (never cells): its transforms equal the port's, it decrypts and decodes
what the port encrypts, and it reads the port's TFHE samples as the port's
own decryption does."""

import numpy as np
import pytest
import torch

from fhebench.reference import ckks as rck
from fhebench.reference import ring
from fhebench.reference import tfhe as rtf
from heongpu_tpu_torch.models import ckks, tfhe, tfhe_int
from heongpu_tpu_torch.ops import ntt as nttm
from heongpu_tpu_torch.utils import nt, rng

from ..schemes.ckks import port_secret, secret_coeffs


@pytest.mark.parametrize("n", [16, 256, 1024])
def test_ring_transforms_equal_the_ports(n):
    primes = nt.generate_ntt_primes(29, 3, n)
    assert primes == ring.ntt_primes(29, 3, n)
    assert all(ring.psi(q, n) == nt.minimal_primitive_root_2n(2 * n, q) for q in primes)
    x = torch.randint(0, 1 << 28, (3, n), generator=torch.Generator().manual_seed(n))
    x = x % torch.tensor(primes)[:, None]
    ev = nttm.ntt_fwd(x.to(torch.int32), nttm.build_ntt_tables(primes, n, device="cpu"))
    r = ring.Ring(primes, n, "cpu")
    assert torch.equal(r.to_eval(x), ev.to(torch.int64))
    assert torch.equal(r.to_coeffs(ev), x)


@pytest.fixture(scope="module")
def small_ckks():
    n = 512
    ctx = ckks.make_context(n, [29, 29] + [28] * 6, scale_bits=28, ks_type="II", alpha=2,
                            p_count=2, device="cpu")
    s = secret_coeffs(np.random.default_rng(5), n, 32)
    sk = port_secret(ctx, torch.from_numpy(s).to(torch.int32), 32)
    g = rng.new_generator(11, "cpu")
    return ctx, s, sk, ckks.keygen_public(ctx, g, sk), g


@pytest.mark.parametrize("level", [0, 3])
def test_reference_decrypts_the_ports_encryption(small_ckks, level):
    ctx, s, sk, pk, g = small_ckks
    z = np.exp(2j * np.pi * np.random.default_rng(level).uniform(size=ctx.n // 2))
    ct = ckks.mod_drop(ctx, ckks.encrypt(ctx, pk, ckks.encode(ctx, z), g), level)
    coeffs, bad = rck.decrypt_coeffs(ct.c, torch.from_numpy(s), list(ctx.q_primes))
    assert bad == 0
    got = rck.decode(coeffs, ct.scale)
    assert np.abs(got - z).max() < 1e-3
    np.testing.assert_allclose(got, ckks.decode(ctx, ckks.decrypt(ctx, sk, ct)), atol=1e-9)


def test_reference_reads_a_rotation_and_a_product(small_ckks):
    ctx, s, sk, pk, g = small_ckks
    gk = ckks.keygen_galois(ctx, g, sk, steps=[2], include_conj=False)
    rk = ckks.keygen_relin(ctx, g, sk)
    d = np.random.default_rng(3)
    z, w = (np.exp(2j * np.pi * d.uniform(size=ctx.n // 2)) for _ in range(2))
    x, y = (ckks.encrypt(ctx, pk, ckks.encode(ctx, v), g) for v in (z, w))
    x = ckks.rescale(ctx, ckks.relinearize(ctx, ckks.multiply(ctx, x, y), rk))
    out = ckks.add(ctx, x, ckks.rotate(ctx, x, gk, 2))
    coeffs, bad = rck.decrypt_coeffs(out.c, torch.from_numpy(s), list(ctx.q_primes))
    want = rck.expected_slots([(0, "multiply", (0,)), (1, "rotate_add", (2,))],
                              {"input": z, 0: {0: w}})
    assert bad == 0 and np.abs(rck.decode(coeffs, out.scale) - want).max() < 1e-2


def test_reference_counts_limbs_that_disagree(small_ckks):
    ctx, s, sk, pk, g = small_ckks
    ct = ckks.encrypt(ctx, pk, ckks.encode(ctx, np.ones(ctx.n // 2)), g)
    c = ct.c.clone()
    c[0, 4, 7] = (int(c[0, 4, 7]) + 1) % int(ctx.q_primes[4])
    assert rck.decrypt_coeffs(c, torch.from_numpy(s), list(ctx.q_primes))[1] > 0


def test_reference_reads_tfhe_samples():
    ctx = tfhe.make_context(16, device="cpu")
    d = np.random.default_rng(9)
    s_lwe = d.integers(0, 2, 16)
    sk = tfhe.SecretKey(torch.from_numpy(s_lwe).to(torch.int32),
                        torch.from_numpy(d.integers(0, 2, 1024)).to(torch.int32))
    g = rng.new_generator(4, "cpu")
    bits = d.integers(0, 2, 40).astype(bool)
    ct = tfhe.encrypt(ctx, sk, bits, g)
    got, gaps = rtf.bits_and_gaps(rtf.phases(ct.a, ct.b, torch.from_numpy(s_lwe)))
    assert (got == bits).all() and (got == tfhe.decrypt(ctx, sk, ct)).all() and gaps.max() < 1e-3
    x = tfhe_int.encrypt_huint(ctx, sk, [3, 250, 17], 8, g)
    bits = rtf.bits_and_gaps(rtf.phases(x.bits.a, x.bits.b, torch.from_numpy(s_lwe)))[0]
    assert rtf.to_ints(bits, 8).tolist() == [3, 250, 17]
    assert (rtf.gate("NAND", [0, 0, 1, 1], [0, 1, 0, 1]) == [1, 1, 1, 0]).all()
