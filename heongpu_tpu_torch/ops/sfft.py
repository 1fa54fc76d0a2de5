"""Special FFT for the CKKS canonical embedding, in native float64 on the
tensors' device (port of heongpu_tpu/ops/sfft.py, whose df64 arithmetic
emulates the float64 that the card has).

The radix-2 transform runs as log2(n) vectorized butterfly stages over
float64 (re, im) tensor pairs, batched over leading axes, with the
reference's tables and stage order: the forward transform is
decimation-in-time with the bit-reversal permutation composed into the slot
scatter indices, and the inverse is decimation-in-frequency with the
bit-reversal composed into the final slot gather.

Every butterfly is written as separate real multiplies, adds and subtracts
(no torch.fft, no complex dtype, no fused multiply-add), each correctly
rounded, so the CPU and the card give the same bits, and a numpy transcription
of the same stages gives them too.

Conventions (models/ckks._embed_coeffs_from_slots):
  encode:  spec[nat(j)] = z_j, spec[conj] = conj(z_j);
           u = DFT_n(spec)/n;  a_i = Re(u_i * e^{-i*pi*i/n})
  decode:  spec = IDFT_n(a_i * e^{+i*pi*i/n}) * n;  z_j = spec[nat(j)]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

F64 = torch.float64


def _bitrev(n: int) -> np.ndarray:
    L = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, np.int64)
    for b in range(L):
        out |= ((idx >> b) & 1) << (L - 1 - b)
    return out


def _slot_nat_index(n: int) -> np.ndarray:
    """Natural eval index of slot j (the 5^j orbit; see ckks._slot_eval_nat)."""
    m2 = 2 * n
    out = np.empty(n // 2, np.int64)
    g5 = 1
    for j in range(n // 2):
        out[j] = (g5 - 1) // 2
        g5 = g5 * 5 % m2
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class SfftTables:
    """Per-n tables on one device: scatter / gather positions (int64) and
    float64 twiddles."""
    n: int
    enc_pos: torch.Tensor        # (n/2,) bit-reversed position of z_j
    enc_pos_conj: torch.Tensor   # (n/2,) ... of conj(z_j)
    dec_pos: torch.Tensor        # (n/2,) bit-reversed gather position of slot j
    dit_re: torch.Tensor         # (L, n/2): DIT stage s uses the first 2^s entries
    dit_im: torch.Tensor
    dif_re: torch.Tensor         # (L, n/2): DIF stage s uses the first n/2^(s+1)
    dif_im: torch.Tensor
    twe_re: torch.Tensor         # (n,) e^{-i pi k/n} / n (encode)
    twe_im: torch.Tensor
    twd_re: torch.Tensor         # (n,) e^{+i pi k/n} (decode)
    twd_im: torch.Tensor


def table_arrays(n: int) -> dict:
    """The tables as numpy arrays (the reference's builder, float64)."""
    L = n.bit_length() - 1
    br = _bitrev(n)
    inv_br = np.argsort(br)
    nat = _slot_nat_index(n)
    conj_nat = n - 1 - nat                      # position of psi^{-(2e+1)}
    half = n // 2
    dit_re = np.zeros((L, half), np.float64)
    dit_im = np.zeros((L, half), np.float64)
    dif_re = np.zeros((L, half), np.float64)
    dif_im = np.zeros((L, half), np.float64)
    for s in range(L):
        m = 1 << s
        k = np.arange(m)
        w = np.exp(-2j * np.pi * k / (2 * m))   # forward kernel
        dit_re[s, :m] = w.real
        dit_im[s, :m] = w.imag
        h = n >> (s + 1)
        k = np.arange(h)
        w = np.exp(+2j * np.pi * k / (2 * h))   # inverse kernel
        dif_re[s, :h] = w.real
        dif_im[s, :h] = w.imag
    k = np.arange(n)
    twe = np.exp(-1j * np.pi * k / n) / n
    twd = np.exp(+1j * np.pi * k / n)
    return dict(enc_pos=inv_br[nat], enc_pos_conj=inv_br[conj_nat], dec_pos=br[nat],
                dit_re=dit_re, dit_im=dit_im, dif_re=dif_re, dif_im=dif_im,
                twe_re=twe.real.copy(), twe_im=twe.imag.copy(),
                twd_re=twd.real.copy(), twd_im=twd.imag.copy())


def build_tables(n: int, device) -> SfftTables:
    return SfftTables(n=n, **{k: torch.from_numpy(v).to(device)
                              for k, v in table_arrays(n).items()})


def _cmul(ar, ai, br, bi):
    """(ar + i·ai)(br + i·bi), four products and two sums."""
    return ar * br - ai * bi, ar * bi + ai * br


def _fft_dit(re, im, tabs: SfftTables):
    """Forward DFT; input bit-reversed, output natural.  re/im: (..., n)."""
    n = tabs.n
    shp = re.shape[:-1]
    for s in range(n.bit_length() - 1):
        m = 1 << s
        g = n >> (s + 1)
        vr = re.reshape(shp + (g, 2, m))
        vi = im.reshape(shp + (g, 2, m))
        wr, wi = _cmul(tabs.dit_re[s, :m], tabs.dit_im[s, :m], vr[..., 1, :], vi[..., 1, :])
        er, ei = vr[..., 0, :], vi[..., 0, :]
        re = torch.cat([er + wr, er - wr], dim=-1).reshape(shp + (n,))
        im = torch.cat([ei + wi, ei - wi], dim=-1).reshape(shp + (n,))
    return re, im


def _fft_dif_inv(re, im, tabs: SfftTables):
    """Inverse-kernel DFT (no 1/n); input natural, output bit-reversed."""
    n = tabs.n
    shp = re.shape[:-1]
    for s in range(n.bit_length() - 1):
        h = n >> (s + 1)
        g = n // (2 * h)
        vr = re.reshape(shp + (g, 2, h))
        vi = im.reshape(shp + (g, 2, h))
        a0r, a1r, a0i, a1i = vr[..., 0, :], vr[..., 1, :], vi[..., 0, :], vi[..., 1, :]
        br, bi = _cmul(tabs.dif_re[s, :h], tabs.dif_im[s, :h], a0r - a1r, a0i - a1i)
        re = torch.stack([a0r + a1r, br], dim=-2).reshape(shp + (n,))
        im = torch.stack([a0i + a1i, bi], dim=-2).reshape(shp + (n,))
    return re, im


def embed_from_slots(z_re, z_im, tabs: SfftTables):
    """Slots (float64 (..., n/2) pairs) -> real coefficients (..., n),
    unscaled (device counterpart of ckks._embed_coeffs_from_slots)."""
    shp = z_re.shape[:-1]
    re = z_re.new_zeros(shp + (tabs.n,))
    im = z_re.new_zeros(shp + (tabs.n,))
    re[..., tabs.enc_pos] = z_re
    re[..., tabs.enc_pos_conj] = z_re
    im[..., tabs.enc_pos] = z_im
    im[..., tabs.enc_pos_conj] = -z_im
    ure, uim = _fft_dit(re, im, tabs)
    return ure * tabs.twe_re - uim * tabs.twe_im     # Re(u · twe), 1/n included


def slots_from_embed(a, tabs: SfftTables):
    """Real coefficients (float64 (..., n)) -> slot values as a float64
    (re, im) pair of (..., n/2) (device counterpart of
    ckks._slots_from_embed_coeffs)."""
    sre, sim = _fft_dif_inv(a * tabs.twd_re, a * tabs.twd_im, tabs)
    return sre[..., tabs.dec_pos], sim[..., tabs.dec_pos]
