"""How far the CKKS encoders are from the exact embedding: the port's float64
special FFT and the JAX package's df64 one, each against a 120-bit mpmath DFT,
at N=256 on the CPU, and the gap between the two on the diagonal plaintexts
of the minimal bootstrap configuration (tests/test_boot_sharded.py).

    JAX_PLATFORMS=cpu python tests/encoder_gap.py

Prints one line per scale (the largest centered residue difference of each
encoder from the exact value, over one random complex slot vector) and one
line per bootstrap piece (the largest port-vs-reference difference, how many
coefficients differ by 2 or more, and, for the worst coefficient, each side's
difference from the exact value)."""

import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import mpmath  # noqa: E402

from heongpu_tpu.models import ckks as jckks  # noqa: E402
from heongpu_tpu_torch.models import ckks as tckks  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot as tboot  # noqa: E402

N = 256
mpmath.mp.prec = 120


def exact_coeff(z, i, scale):
    """round(a_i · scale) of the canonical embedding of slots z, 120 bits."""
    n = 2 * len(z)
    spec = [mpmath.mpc(0)] * n
    for j, e in enumerate(tckks._slot_eval_nat(n)):
        spec[e] = mpmath.mpc(z[j].real, z[j].imag)
        spec[n - 1 - e] = mpmath.mpc(z[j].real, -z[j].imag)
    s = mpmath.fsum(spec[k] * mpmath.expj(-2 * mpmath.pi * k * i / n) for k in range(n))
    return int(mpmath.nint((s / n * mpmath.expj(-mpmath.pi * i / n)).real * mpmath.mpf(scale)))


def centered(v, q):
    v %= q
    return v - q if v > q // 2 else v


def both(zs, primes, scale):
    ref = np.asarray(jckks.encode_batch_rns(N, zs, tuple(primes), scale)).astype(np.int64)
    got = tckks.encode_batch_rns(N, zs, primes, scale, "cpu").numpy().view(np.uint32)
    return got.astype(np.int64), ref


def main():
    primes = tckks.make_context(N, [29] * 3, device="cpu").q_primes
    r = np.random.default_rng(N)
    z = r.uniform(-1, 1, N // 2) + 1j * r.uniform(-1, 1, N // 2)
    q = int(primes[0])
    for bits in (29, 40, 50):
        scale = 2.0 ** bits * 1.37
        got, ref = both(z[None], primes, scale)
        ex = [exact_coeff(z, i, scale) for i in range(N)]
        port = max(abs(centered(int(got[0, 0, i]) - ex[i], q)) for i in range(N))
        dref = max(abs(centered(int(ref[0, 0, i]) - ex[i], q)) for i in range(N))
        print(f"scale 1.37*2^{bits}: port - exact max {port}, reference df64 - exact max {dref}")

    ctx = tckks.make_context(N, [29] * 16, scale_bits=28, ks_type="II", alpha=2, p_count=4,
                             device="cpu")
    cfg = tboot.BootConfig(taylor_degree=3, exp_squarings=1)
    q0, ms = int(ctx.q_primes[0]), ctx.default_scale
    c_in = 2 * math.pi * ms / ((1 << cfg.exp_squarings) * q0)
    c_out = (-0.5j) * q0 / (2 * math.pi * ms)
    ns = N // 2
    for kind, mats, levels in (("CtoS", tboot.build_dft_pieces(N, 2, True, c_in / 2), (0, 1)),
                               ("StoC", tboot.build_dft_pieces(N, 2, False, c_out), (6, 7))):
        for m, level in zip(mats, levels):
            ka = ctx.active(level)
            limbs = tuple(ctx.q_primes[:ka]) + tuple(ctx.p_primes)
            scale = float(ctx.q_primes[ka - 1])
            _, groups = tboot._bsgs_split(list(m), ns)
            vecs = np.stack([np.roll(m[(g + b) % ns], g) for g, bs in groups.items() for b in bs])
            got, ref = both(vecs, limbs, scale)
            qs = np.asarray(limbs, np.int64)[:, None]
            d = (got - ref) % qs
            d = np.abs(np.where(d > qs // 2, d - qs, d))
            b, li, i = np.unravel_index(d.argmax(), d.shape)
            ex = exact_coeff(vecs[b], i, scale)
            ql = int(limbs[li])
            print(f"{kind} piece at level {level}: max |port - reference| {d.max()}, "
                  f"{int((d >= 2).sum())} of {d.size} coefficients differ by 2 or more; worst "
                  f"coefficient: port - exact {centered(int(got[b, li, i]) - ex, ql)}, "
                  f"reference - exact {centered(int(ref[b, li, i]) - ex, ql)}")


if __name__ == "__main__":
    main()
