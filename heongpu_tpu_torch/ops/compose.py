"""CRT composition of small centered values, exact residues of a centered
[x]_Q mod other primes, and the log-magnitude of large values (port of
heongpu_tpu/ops/compose.py).

Everything rests on one fact: with y_i = [x_i·(Q/q_i)^{-1}]_{q_i},
[x]_Q = Σ_i y_i·(Q/q_i) − α·Q, and the centered representative has
α = round(Σ_i y_i/q_i).  The reference sums y_i/q_i in df64; here it is one
float64 sum, taken limb by limb in a fixed order so that the CPU and the
card round alike.  The products y_i·c (30-bit by 30-bit) are exact in int64
and reduced with `%`; the reference's 16-bit widening multiplies are not
ported.

  * compose_small: the exact centered value of [x]_Q when |[x]_Q| < 2^59
    (every decode), through a CRT over a fixed pair of 30-bit primes.
  * mod_primes_centered / mod_prime_centered: [x]_Q centered, reduced mod
    other primes, for any size of [x]_Q below Q/2 (mod-raise, decryption).
  * frac_log2_norm: log2 of the largest |[x]_Q| from the fractional part of
    the same sum (a noise budget in bits).
"""

from __future__ import annotations

import dataclasses
import math
from functools import reduce

import torch

from . import modmath as mm

_prod = lambda xs: reduce(lambda a, b: a * b, xs, 1)

# the reference's gamma pair: two ~30-bit primes coprime to every NTT prime
# below 2^30 (only CRT is needed of them)
_G1 = (1 << 30) - 35        # 1073741789, prime
_G2 = (1 << 30) - 77        # 1073741747, prime
_G1G2 = _G1 * _G2
_G1_INV_G2 = pow(_G1, -1, _G2)


@dataclasses.dataclass(frozen=True, eq=False)
class SmallComposeTables:
    """Per-prime-set constants on one device (int64 and float64 tensors)."""
    primes: tuple
    p: torch.Tensor             # (k,) the primes
    qhat_inv: torch.Tensor      # (k,) [(Q/q_i)^{-1}]_{q_i}
    qhat_g: torch.Tensor        # (2, k) [Q/q_i]_{g_j}
    q_g: torch.Tensor           # (2,) [Q]_{g_j}
    logq: float


def build_tables(primes, device) -> SmallComposeTables:
    primes = tuple(int(q) for q in primes)
    Q = _prod(primes)
    t = lambda v: torch.tensor(v, dtype=mm.I64, device=device)
    return SmallComposeTables(
        primes=primes, p=t(list(primes)),
        qhat_inv=t([pow(Q // q, -1, q) for q in primes]),
        qhat_g=t([[(Q // q) % g for q in primes] for g in (_G1, _G2)]),
        q_g=t([Q % g for g in (_G1, _G2)]),
        logq=float(sum(math.log2(q) for q in primes)))


def _y_and_frac(x, t: SmallComposeTables):
    """y (..., k, n) int64 and f = Σ_i y_i/q_i (..., n) float64, summed in limb
    order.  x: (..., k, n) residues."""
    y = torch.remainder(x.to(mm.I64) * t.qhat_inv[:, None], t.p[:, None])
    f = None
    for i, q in enumerate(t.primes):
        term = y[..., i, :].to(torch.float64) / float(q)
        f = term if f is None else f + term
    return y, f


def _mac_mod(y, alpha, consts, q_mod: int, target: int):
    """(Σ_i y_i·consts_i − alpha·q_mod) mod target, exactly."""
    acc = None
    for i in range(y.shape[-2]):
        term = torch.remainder(y[..., i, :] * int(consts[i]), target)
        acc = term if acc is None else acc + term
    return torch.remainder(acc - torch.remainder(alpha * q_mod, target), target)


def compose_small(x, t: SmallComposeTables):
    """The exact centered value of [x]_Q (|value| < g1·g2/2 ≈ 2^59 required),
    as float64 (..., n).  x: (..., k, n) residues."""
    y, f = _y_and_frac(x, t)
    alpha = torch.round(f).to(mm.I64)
    qg = t.qhat_g.tolist()
    r1 = _mac_mod(y, alpha, qg[0], int(t.q_g[0]), _G1)
    r2 = _mac_mod(y, alpha, qg[1], int(t.q_g[1]), _G2)
    # CRT: v = r1 + g1·[(r2 − r1)·g1^{-1}]_{g2} in [0, g1·g2), then centered
    k = torch.remainder(torch.remainder(r2 - r1, _G2) * _G1_INV_G2, _G2)
    v = r1 + k * _G1
    v = torch.where(v >= _G1G2 // 2, v - _G1G2, v)
    return v.to(torch.float64)


def mod_primes_centered(x, primes, targets, tabs: SmallComposeTables):
    """[x]_Q (centered) mod each target prime, sharing one y/alpha pass (the
    composite-q0 CKKS mod-raise).  x: (..., k, n) residues.  Returns
    (..., len(targets), n) int32."""
    y, f = _y_and_frac(x, tabs)
    alpha = torch.round(f).to(mm.I64)
    Q = _prod(int(q) for q in primes)
    outs = [_mac_mod(y, alpha, [(Q // int(q)) % int(g) for q in primes], Q % int(g), int(g))
            for g in targets]
    return torch.stack(outs, dim=-2).to(mm.I32)


def mod_prime_centered(x, primes, t_mod: int, tabs: SmallComposeTables):
    """[x]_Q (centered) mod t_mod for any |[x]_Q| < Q/2 (the BGV decryption
    compose).  x: (..., k, n) residues.  Returns (..., n) int32."""
    return mod_primes_centered(x, primes, (int(t_mod),), tabs)[..., 0, :]


def frac_log2_norm(x, primes, t: SmallComposeTables):
    """max_j log2(|[x]_Q|_j) over the last axis, from the fractional part of
    Σ y_i/q_i (≈ [x]_Q/Q; valid down to |v| ≈ Q·2^-50).  A 0-d float64
    tensor on x's device."""
    _, f = _y_and_frac(x, t)
    m = torch.max(torch.abs(f - torch.round(f)))
    return torch.log2(torch.clamp(m, min=2.0 ** -60)) + t.logq
