"""TFHE gate bootstrapping (port of heongpu_tpu/models/tfhe.py).

The STD128 context (LWE n=512, TRLWE N=1024 k=1, l=2 bg_bit=10 gadget,
base-4 length-8 keyswitch), keys, LWE encrypt / decrypt, the blind rotation,
sample extraction, the N->n keyswitch, the seven two-input gates, NOT and
MUX, all batched over gates on a leading axis B as in the reference.

Torus words are int32 tensors that carry the reference's uint32 bits; the
CRT residues of the two < 2^30 NTT primes are int32 as everywhere in the
port.  Torus arithmetic is wraparound mod 2^32: it is done on int64 and
wrapped back with `_wrap`; right shifts and unsigned comparisons read the
word's unsigned value (`mm.as_u32`) and never act on a signed int32.

The n-step CMux chain runs in `ops/tfhe_kernel.py`: its wrappers launch the
hand-written CUDA kernels for CUDA tensors and the plain chains below
(`blind_rotate_plain`, `blind_rotate2_plain`) for CPU tensors.  The rest of
the bootstrap (prologue, epilogue, keyswitch) is plain torch, with its
transforms on the NTT kernel for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import modmath as mm
from ..ops import ntt as nttm
from ..ops import rns
from ..ops import tfhe_kernel as tk
from ..utils import nt, rng

I32, I64 = mm.I32, mm.I64
_MASK = 0xFFFFFFFF
_SIGN = 1 << 31

# STD128 parameters (reference host/tfhe/context.cu:36-57)
LWE_N = 512
TRLWE_N = 1024
TRLWE_K = 1
BK_L = 2
BG_BIT = 10
BG = 1 << BG_BIT
KS_BASE_BIT = 2
KS_BASE = 1 << KS_BASE_BIT
KS_LENGTH = 8
SIGMA_KS = math.sqrt(2.0 / math.pi) * (2.0 ** -15)
SIGMA_BK = math.sqrt(2.0 / math.pi) * 9.0e-9
MU = 1 << 29  # 1/8 of the torus

_RENORM = 8   # CMux steps between torus renormalisations of the accumulator
_RENORM2 = 4  # pair steps between renormalisations of the key-unrolled chain


def _wrap(x) -> torch.Tensor:
    """Any int64 tensor -> int32 with the bits of its value mod 2^32."""
    return (((x & _MASK) ^ _SIGN) - _SIGN).to(I32)


@dataclasses.dataclass(frozen=True, eq=False)
class TfheContext:
    n: int
    N: int
    k: int
    l: int
    bg_bit: int
    ks_base_bit: int
    ks_length: int
    primes: tuple
    ntt: nttm.NttTables          # CRT pair over N=1024
    base: rns.Base               # p, pinv, r1, rinv of the CRT pair
    p1p2: int                    # P = p1*p2
    p1_inv_p2: int               # p1^{-1} mod p2
    offset: int                  # gadget decomposition offset
    omega_bits: torch.Tensor     # (6, 4, 2, N) mont NTT-domain X^(c*4^g)
    omega_pows: torch.Tensor     # (2, 2N) mont psi^j: X^a at pos is psi^(e[pos]*a mod 2N)
    omega_exps: torch.Tensor     # (N,) e[pos] = 2*eval_order(N)[pos] + 1

    @property
    def device(self) -> torch.device:
        return self.ntt.device


def _omega_digit_tables(ntt: nttm.NttTables, N: int) -> np.ndarray:
    """NTT-domain (Montgomery form) values of the monomials X^(c·4^g) for
    radix-4 digits c ∈ [0,4) of the rotation amount, g = 0..5 (11 bits of
    amt < 2N): table[g, c, l, pos] = psi_l^((2·eo[pos]+1)·c·4^g mod 2N)·R."""
    psi_host = mm.as_u32(ntt.psi.cpu()).numpy().astype(np.uint64)   # (2, N)
    primes = np.asarray(ntt.primes, np.uint64)
    eo = nttm.eval_order(N).astype(np.int64)
    bits = (2 * N).bit_length() - 1                        # 11 for N=1024
    G = (bits + 1) // 2
    out = np.empty((G, 4, 2, N), np.uint64)
    for g in range(G):
        for c in range(4):
            e = ((2 * eo + 1) * (c << (2 * g))) % (2 * N)
            wrap = e >= N
            idx = np.where(wrap, e - N, e)
            v = psi_host[:, idx]
            v = np.where(wrap[None, :], primes[:, None] - v, v)
            out[g, c] = v * (np.uint64(1) << np.uint64(32)) % primes[:, None]
    return out.astype(np.uint32)


def _omega_pow_table(ntt: nttm.NttTables, N: int) -> np.ndarray:
    """Montgomery form of psi_l^j for j < 2N (psi^j = p - psi^(j-N) for
    j >= N), so that X^a at NTT position pos is the entry at
    (2·eo[pos]+1)·a mod 2N, the product of the six digit tables above."""
    psi = mm.as_u32(ntt.psi.cpu()).numpy().astype(np.uint64)       # (2, N)
    primes = np.asarray(ntt.primes, np.uint64)[:, None]
    pows = np.concatenate([psi, primes - psi], axis=1)
    return (pows * (np.uint64(1) << np.uint64(32)) % primes).astype(np.uint32)


def make_context(lwe_n: int = LWE_N, device="cuda") -> TfheContext:
    """STD128 TFHE context (reference host/tfhe/context.cu:36-57) on `device`.

    lwe_n < 512 is a TEST-ONLY knob: it shortens the CMux chain while
    keeping every code path — NOT a secure parameter set."""
    if lwe_n % _RENORM != 0:
        raise ValueError(f"TFHE lwe dimension n={lwe_n} must be a multiple of the "
                         f"CMux renormalisation period {_RENORM}")
    primes = nt.generate_ntt_primes(30, 2, TRLWE_N)
    p1, p2 = primes
    offset = sum((BG // 2) << (32 - (p + 1) * BG_BIT) for p in range(BK_L)) % (1 << 32)
    ntt = nttm.build_ntt_tables(primes, TRLWE_N, device=device)
    return TfheContext(
        n=lwe_n, N=TRLWE_N, k=TRLWE_K, l=BK_L, bg_bit=BG_BIT,
        ks_base_bit=KS_BASE_BIT, ks_length=KS_LENGTH, primes=tuple(primes),
        ntt=ntt, base=rns.Base.build(primes, device), p1p2=p1 * p2,
        p1_inv_p2=pow(p1, -1, p2), offset=offset,
        omega_bits=mm.u32_to_i32(_omega_digit_tables(ntt, TRLWE_N)).to(device),
        omega_pows=mm.u32_to_i32(_omega_pow_table(ntt, TRLWE_N)).to(device),
        omega_exps=torch.from_numpy(2 * nttm.eval_order(TRLWE_N) + 1).to(device))


# =========================================================================
# Keys and ciphertexts
# =========================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class SecretKey:
    lwe: torch.Tensor   # (n,) int32 binary
    rlwe: torch.Tensor  # (N,) int32 binary


@dataclasses.dataclass(frozen=True, eq=False)
class BootKey:
    """bk: (n, (k+1)l, k+1, 2, N) NTT+Montgomery TGSW rows;
    ksk: LWE_n(v * rlwe_j * 2^(32-(t+1)*basebit)) for v in [0, base)."""
    bk: torch.Tensor
    ksk_a: torch.Tensor  # (N, ks_length, base, n) torus
    ksk_b: torch.Tensor  # (N, ks_length, base) torus


@dataclasses.dataclass(frozen=True, eq=False)
class BootKey2:
    """2-bit key-unrolled bootstrapping key: for each LWE bit pair
    (s0, s1) = (s_2i, s_2i+1), three TGSWs encrypting s0, s1 and s0·s1, so
    the chain runs n/2 steps of
      acc += <D(acc), B0>·(X^a0−1) + <D(acc), B1>·(X^a1−1)
             + <D(acc), B01>·(X^a0−1)(X^a1−1).
    bk2: (n/2, 3, rows, comp, 2, N)."""
    bk2: torch.Tensor
    ksk_a: torch.Tensor
    ksk_b: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class Ciphertext:
    """Batched LWE samples.  `variance` tracks the torus-noise variance
    through linear pre-computations and resets at every bootstrap."""
    a: torch.Tensor  # (B, n) torus
    b: torch.Tensor  # (B,) torus
    variance: float = 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class NLwe:
    """Batched N-dimensional LWE samples under the TRLWE key: the sample-
    extracted blind-rotation output before the N->n keyswitch."""
    a: torch.Tensor  # (B, N) torus
    b: torch.Tensor  # (B,) torus
    variance: float = 0.0


def keygen_secret(key, lwe_n: int = LWE_N, device="cuda") -> SecretKey:
    k1, k2 = rng.split(key)
    lwe = rng.randint(k1, (lwe_n,), 0, 2, device)
    rlwe = rng.randint(k2, (TRLWE_N,), 0, 2, device)
    return SecretKey(lwe, rlwe)


def _torus_noise(key, shape, sigma, device) -> torch.Tensor:
    """round(normal·(σ·2^32)) in float32, half to even, as int32 bits."""
    g = rng.normal(key, shape, device) * torch.tensor(sigma * (2.0 ** 32),
                                                      dtype=torch.float32, device=device)
    return torch.round(g).to(I32)


def _torus_to_rns(ctx: TfheContext, v):
    """Torus words (..., N) -> residues (..., 2, N) of the centered value,
    which is the word read as a signed int32 (so signed gadget digits map
    the same way)."""
    return torch.remainder(v.to(I64)[..., None, :], ctx.base.col()).to(I32)


def _rns_to_torus(ctx: TfheContext, r):
    """(..., 2, N) residues -> the centered CRT value mod 2^32 (Torus32)."""
    p1, p2 = ctx.primes
    r1 = r[..., 0, :].to(I64)
    t = torch.remainder((r[..., 1, :].to(I64) - r1) * ctx.p1_inv_p2, p2)
    v = t * p1 + r1                                    # in [0, P), P < 2^60
    return _wrap(torch.where(v >= ctx.p1p2 // 2, v - ctx.p1p2, v))


def _mont(ctx: TfheContext, a, b):
    return mm.mont_mul(a, b, ctx.base.col(), ctx.base.col("rinv"))


def _to_mont(ctx: TfheContext, a):
    return mm.to_mont(a, ctx.base.col(), ctx.base.col("r1"))


def _polymul_rlwe_key_torus(ctx: TfheContext, a, s_ntt_mont):
    """Negacyclic a(X)*s(X) over Torus32 via the CRT NTT pair.

    a: (..., N) torus; s_ntt_mont: (2, N) NTT+mont of the binary key."""
    A = nttm.ntt_fwd(_torus_to_rns(ctx, a), ctx.ntt)
    return _rns_to_torus(ctx, nttm.ntt_inv(_mont(ctx, A, s_ntt_mont), ctx.ntt))


def _s_ntt_mont(ctx: TfheContext, sk: SecretKey):
    s_rns = rng.signed_to_rns(sk.rlwe, ctx.primes)
    return _to_mont(ctx, nttm.ntt_fwd(s_rns, ctx.ntt))


def _gadget(ctx: TfheContext) -> torch.Tensor:
    """(rows, comp, N): row (c, p) adds 2^(32-(p+1)*bgbit) to coefficient 0
    of component c."""
    rows = (ctx.k + 1) * ctx.l
    gad = torch.zeros((rows, 2, ctx.N), dtype=I64, device=ctx.device)
    for c in range(ctx.k + 1):
        for pdig in range(ctx.l):
            gad[c * ctx.l + pdig, c, 0] = 1 << (32 - (pdig + 1) * ctx.bg_bit)
    return gad


def _keygen_ks(ctx: TfheContext, k_ks_a, k_ks_e, sk: SecretKey):
    """LWE keyswitch key: LWE_n(v * s'_j * 2^(32-(t+1)*basebit)), with the
    v=0 slice zeroed so it adds nothing (its noise included)."""
    N, n, dev = ctx.N, ctx.n, ctx.device
    base = 1 << ctx.ks_base_bit
    ksk_a = rng.bits32(k_ks_a, (N, ctx.ks_length, base, n), dev)
    e_ks = _torus_noise(k_ks_e, (N, ctx.ks_length, base), SIGMA_KS, dev)
    shift = torch.tensor([1 << (32 - (t + 1) * ctx.ks_base_bit)
                          for t in range(ctx.ks_length)], dtype=I64, device=dev)
    v = torch.arange(base, dtype=I64, device=dev)
    msg = sk.rlwe.to(I64)[:, None, None] * shift[None, :, None] * v[None, None, :]
    ksk_b = (ksk_a * sk.lwe.to(I64)).sum(-1) + e_ks + msg
    ksk_a[:, :, 0, :] = 0
    ksk_b[:, :, 0] = 0
    return _wrap(ksk_a), _wrap(ksk_b)


def keygen_boot(ctx: TfheContext, key, sk: SecretKey) -> BootKey:
    """Bootstrapping key (TGSW(s_lwe_i) under the rlwe key, NTT domain) and
    LWE keyswitch key.  Reference analog: keygenerator.cu:61-180."""
    n, N, dev = ctx.n, ctx.N, ctx.device
    k_bk_a, k_bk_e, k_ks_a, k_ks_e = rng.split(key, 4)
    s_ntt_mont = _s_ntt_mont(ctx, sk)
    rows = (ctx.k + 1) * ctx.l                   # 4
    # TRLWE(0) for every (i, row): a uniform torus poly, b = a*s + e
    a = rng.bits32(k_bk_a, (n, rows, N), dev)
    e = _torus_noise(k_bk_e, (n, rows, N), SIGMA_BK, dev)
    b = _polymul_rlwe_key_torus(ctx, _wrap(a), s_ntt_mont).to(I64) + e
    trlwe = torch.stack([a, b], dim=2)           # (n, rows, comp, N)
    trlwe = _wrap(trlwe + sk.lwe.to(I64)[:, None, None, None] * _gadget(ctx)[None])
    bk = _to_mont(ctx, nttm.ntt_fwd(_torus_to_rns(ctx, trlwe), ctx.ntt))
    return BootKey(bk, *_keygen_ks(ctx, k_ks_a, k_ks_e, sk))


def keygen_boot_unrolled(ctx: TfheContext, key, sk: SecretKey) -> BootKey2:
    """BootKey2: the keygen_boot structure with message bits (s0, s1, s0·s1)
    per pair; 1.5x the key material for half the sequential chain."""
    n, N, dev = ctx.n, ctx.N, ctx.device
    k_bk_a, k_bk_e, k_ks_a, k_ks_e = rng.split(key, 4)
    s_ntt_mont = _s_ntt_mont(ctx, sk)
    rows = (ctx.k + 1) * ctx.l
    n2 = n // 2
    a = rng.bits32(k_bk_a, (n2, 3, rows, N), dev)
    e = _torus_noise(k_bk_e, (n2, 3, rows, N), SIGMA_BK, dev)
    b = _polymul_rlwe_key_torus(ctx, _wrap(a), s_ntt_mont).to(I64) + e
    s0 = sk.lwe[0::2].to(I64)
    s1 = sk.lwe[1::2].to(I64)
    msg = torch.stack([s0, s1, s0 * s1], dim=1)  # (n/2, 3) bits
    trlwe = torch.stack([a, b], dim=3)           # (n/2, 3, rows, comp, N)
    trlwe = _wrap(trlwe + msg[:, :, None, None, None] * _gadget(ctx)[None, None])
    bk2 = _to_mont(ctx, nttm.ntt_fwd(_torus_to_rns(ctx, trlwe), ctx.ntt))
    return BootKey2(bk2, *_keygen_ks(ctx, k_ks_a, k_ks_e, sk))


# =========================================================================
# LWE encrypt / decrypt
# =========================================================================

def encrypt(ctx: TfheContext, sk: SecretKey, bits, key) -> Ciphertext:
    """bits: (B,) bools -> batched LWE with mu = ±1/8."""
    dev = sk.lwe.device
    bits = torch.as_tensor(np.asarray(bits), device=dev).to(torch.bool)
    B = bits.shape[0]
    ka, ke = rng.split(key)
    a = rng.bits32(ka, (B, ctx.n), dev)
    e = _torus_noise(ke, (B,), SIGMA_KS, dev)
    mu = torch.where(bits, MU, -MU)
    b = (a * sk.lwe.to(I64)).sum(-1) + mu + e
    return Ciphertext(_wrap(a), _wrap(b), variance=SIGMA_KS ** 2)


def decrypt(ctx: TfheContext, sk: SecretKey, ct: Ciphertext) -> np.ndarray:
    phase = (ct.b.to(I64) - (ct.a.to(I64) * sk.lwe.to(I64)).sum(-1)) & _MASK
    return (phase < _SIGN).cpu().numpy()


# =========================================================================
# Gate bootstrapping pipeline
# =========================================================================

def _decompose(ctx: TfheContext, d):
    """Approximate signed gadget decomposition of (B, comp, N) torus into
    (B, comp*l, N) int32 digits in [-bg/2, bg/2), rows (comp, l) row-major."""
    u = (mm.as_u32(d) + ctx.offset) & _MASK
    digs = [((u >> (32 - (pdig + 1) * ctx.bg_bit)) & (BG - 1)) - BG // 2
            for pdig in range(ctx.l)]
    out = torch.stack(digs, dim=-2)                       # (B, comp, l, N)
    return out.reshape(d.shape[0], -1, d.shape[-1]).to(I32)


def _ext_mac(ctx: TfheContext, D, key_rows):
    """Σ_row D[:, row] · key[row] in the RNS-NTT domain: D (B, rows, 2, N),
    key_rows (rows, comp, 2, N) Montgomery -> (B, comp, 2, N)."""
    p = ctx.base.col()
    prod = torch.remainder(D.to(I64)[:, :, None] * key_rows.to(I64), p)
    return torch.remainder(torch.remainder(prod.sum(1), p) * ctx.base.col("rinv"),
                           p).to(I32)


def _digits_ntt(ctx: TfheContext, d_t):
    """Gadget digits of the (B, comp, N) torus d_t, forward transformed by
    the plain NTT: (B, rows, 2, N)."""
    return nttm.ntt_fwd_plain(_torus_to_rns(ctx, _decompose(ctx, d_t)), ctx.ntt)


def _external_product_ntt(ctx: TfheContext, bk_i, d):
    """TGSW (NTT+mont, (rows, comp, 2, N)) ⊡ TRLWE diff d (B, comp, N)
    torus, in the RNS-NTT domain (no inverse transform)."""
    return _ext_mac(ctx, _digits_ntt(ctx, d), bk_i)


def _omega_mont(ctx: TfheContext, amt):
    """NTT-domain Montgomery form of X^amt per batch element, the product of
    6 radix-4 digit-selected tables: amt (B,) int in [0, 2N) -> (B, 2, N)."""
    amt = amt.to(I64)
    w = ctx.omega_bits[0][amt & 3]
    for g in range(1, ctx.omega_bits.shape[0]):
        w = _mont(ctx, w, ctx.omega_bits[g][(amt >> (2 * g)) & 3])
    return w


def _modswitch(x, N: int):
    """Torus32 -> exponent of X in [0, 2N)."""
    sh = 32 - (2 * N).bit_length() + 1                    # 32 - log2(2N)
    return (((mm.as_u32(x) + (1 << (sh - 1))) & _MASK) >> sh).to(I32)


def _renorm_plain(ctx: TfheContext, acc):
    """Pull the accumulator's integer representative back to the torus (the
    CRT pair gives ~2^58 of headroom for ~2^52 of growth)."""
    t = _rns_to_torus(ctx, nttm.ntt_inv_plain(acc, ctx.ntt))
    return nttm.ntt_fwd_plain(_torus_to_rns(ctx, t), ctx.ntt)


def blind_rotate_plain(acc, a_t, bk, ctx: TfheContext):
    """The plain n-step CMux chain (the `outer` loop of the reference's
    bootstrap_raw): acc (B, 2, 2, N) NTT domain, a_t (B, n) rotation
    amounts, bk (n, rows, comp, 2, N) -> the final NTT-domain accumulator.
    Every transform is the plain one, whatever the device."""
    p = ctx.base.col()
    two_n = 2 * ctx.N
    n = bk.shape[0]
    for o in range(n // _RENORM):
        for j in range(_RENORM):
            i = o * _RENORM + j
            w = _omega_mont(ctx, torch.remainder(a_t[:, i], two_n))
            diff = mm.sub_mod(_mont(ctx, acc, w[:, None]), acc, p)
            d_t = _rns_to_torus(ctx, nttm.ntt_inv_plain(diff, ctx.ntt))
            acc = mm.add_mod(acc, _external_product_ntt(ctx, bk[i], d_t), p)
        acc = _renorm_plain(ctx, acc)
    return acc


def blind_rotate2_plain(acc, a_t, bk2, ctx: TfheContext):
    """The plain key-unrolled chain (the algebra of the reference's
    tfhe_kernel._make_kernel2, which has no plain-JAX path): n/2 pair steps
    of acc += Σ_t <D(acc), B_t>·u_t with u_j = X^a_j − 1 and u01 = u0·u1,
    D the NTT of the gadget digits of INTT(acc); renormalised every 4 pair
    steps.  Same layouts as blind_rotate_plain; bk2 (n/2, 3, rows, comp, 2, N)."""
    p = ctx.base.col()
    r1 = ctx.base.col("r1")
    two_n = 2 * ctx.N
    n2 = bk2.shape[0]
    for o in range(n2 // _RENORM2):
        for j in range(_RENORM2):
            i = o * _RENORM2 + j
            u0 = mm.sub_mod(_omega_mont(ctx, torch.remainder(a_t[:, 2 * i], two_n)), r1, p)
            u1 = mm.sub_mod(_omega_mont(ctx, torch.remainder(a_t[:, 2 * i + 1], two_n)),
                            r1, p)
            u01 = _mont(ctx, u0, u1)
            D = _digits_ntt(ctx, _rns_to_torus(ctx, nttm.ntt_inv_plain(acc, ctx.ntt)))
            for t, u in enumerate((u0, u1, u01)):
                acc = mm.add_mod(acc, _mont(ctx, _ext_mac(ctx, D, bk2[i, t]), u[:, None]), p)
        acc = _renorm_plain(ctx, acc)
    return acc


def blind_rotate_variance(ctx: TfheContext, unroll_factor: int = 1) -> float:
    """Noise variance of the blind rotation + sample extract alone (CGGI
    estimate: external products + decomposition error), i.e. the N-LWE
    sample BEFORE the base-4 keyswitch.  unroll_factor=4 for the 2-bit
    key-unrolled chain."""
    br = (ctx.n * (ctx.k + 1) * ctx.l * ctx.N * (BG / 2) ** 2 * SIGMA_BK ** 2
          + ctx.n * (1 + ctx.k * ctx.N) * (2.0 ** (-2 * ctx.bg_bit * ctx.l)) / 12)
    return br * unroll_factor


def keyswitch_variance(ctx: TfheContext) -> float:
    """Noise added by the N->n base-4 LWE keyswitch."""
    return ctx.N * ctx.ks_length * SIGMA_KS ** 2 \
        + ctx.N * (2.0 ** (-2 * ctx.ks_base_bit * ctx.ks_length)) / 12


def bootstrap_output_variance(ctx: TfheContext, unroll_factor: int = 1) -> float:
    """Fresh-output noise variance of one gate bootstrap (blind rotation +
    keyswitch)."""
    return blind_rotate_variance(ctx, unroll_factor) + keyswitch_variance(ctx)


def noise_margin_bits(ct: Ciphertext) -> float:
    """log2 of mu/(4*sigma): >0 means comfortable decryption margin."""
    sigma = max(math.sqrt(ct.variance), 1e-30)
    return math.log2((1.0 / 8.0) / (4.0 * sigma))


def _boot_prologue(ctx: TfheContext, ct: Ciphertext):
    """Initial NTT-domain accumulator (testvector rotated by X^{-b}) and the
    mod-switched per-step rotation amounts."""
    B, N = ct.a.shape[0], ctx.N
    b_t = _modswitch(ct.b, N)
    acc_t = torch.zeros((B, 2, N), dtype=I32, device=ct.a.device)
    acc_t[:, 1] = MU
    acc = nttm.ntt_fwd(_torus_to_rns(ctx, acc_t), ctx.ntt)
    w_b = _omega_mont(ctx, torch.remainder(2 * N - b_t.to(I64), 2 * N))
    acc = _mont(ctx, acc, w_b[:, None])
    return acc, _modswitch(ct.a, N)


def _sample_extract(ctx: TfheContext, acc_t):
    """Constant-coefficient sample extraction of the (B, 2, N) torus
    accumulator -> ((B, N) a, (B,) b) N-LWE parts."""
    rolled = torch.roll(acc_t[:, 0, :].flip(-1), 1, dims=-1).to(I64)
    ext_a = rolled.clone()
    ext_a[:, 1:] = -rolled[:, 1:]
    return _wrap(ext_a), acc_t[:, 1, 0].contiguous()


def lwe_keyswitch(ctx: TfheContext, bk, s: NLwe) -> Ciphertext:
    """Base-4 N->n LWE keyswitch (reference tfhe_key_switching_kernel).  The
    key gather materialises (B, N, n) words per digit."""
    sh0 = 32 - ctx.ks_base_bit * ctx.ks_length
    u = (mm.as_u32(s.a) + (1 << (sh0 - 1))) & _MASK
    rows = torch.arange(ctx.N, device=s.a.device)[None, :]
    out_a = torch.zeros((s.a.shape[0], ctx.n), dtype=I64, device=s.a.device)
    out_b = s.b.to(I64)
    for t in range(ctx.ks_length):
        dig = (u >> (32 - (t + 1) * ctx.ks_base_bit)) & (KS_BASE - 1)
        out_a = out_a - bk.ksk_a[:, t][rows, dig].sum(1)
        out_b = out_b - bk.ksk_b[:, t][rows, dig].sum(1)
    return Ciphertext(_wrap(out_a), _wrap(out_b),
                      variance=s.variance + keyswitch_variance(ctx))


def _boot_epilogue(ctx: TfheContext, bk, acc_t, keyswitch: bool = True,
                   unroll_factor: int = 1):
    """Sample extract at coefficient 0 (+ base-4 LWE keyswitch when
    keyswitch=True); acc_t is the final (B, 2, N) torus accumulator."""
    ext_a, b_out = _sample_extract(ctx, acc_t)
    s = NLwe(ext_a, b_out, variance=blind_rotate_variance(ctx, unroll_factor))
    if not keyswitch:
        return s
    return lwe_keyswitch(ctx, bk, s)


def _bootstrap(ctx: TfheContext, bk, ct: Ciphertext, keyswitch: bool = True):
    """Blind rotation + sample extract (+ keyswitch) for a batch of LWEs whose
    phase sign encodes the bit; returns fresh samples with payload ±mu.  A
    BootKey runs the n-step chain, a BootKey2 the n/2-step key-unrolled one;
    the chain wrappers pick the kernel or the plain chain by device."""
    acc, a_t = _boot_prologue(ctx, ct)
    if isinstance(bk, BootKey2):
        acc, unroll = tk.blind_rotate2(acc, a_t, bk.bk2, ctx), 4
    else:
        acc, unroll = tk.blind_rotate(acc, a_t, bk.bk, ctx), 1
    acc_t = _rns_to_torus(ctx, nttm.ntt_inv(acc, ctx.ntt))
    return _boot_epilogue(ctx, bk, acc_t, keyswitch=keyswitch, unroll_factor=unroll)


def bootstrap(ctx: TfheContext, bk, ct: Ciphertext, keyswitch: bool = True):
    """Gate bootstrap of a batch of LWE samples (see _bootstrap)."""
    return _bootstrap(ctx, bk, ct, keyswitch=keyswitch)


# =========================================================================
# Gates (reference operator.cuh:53-812)
# =========================================================================

def _lin(c1: Ciphertext, c2: Ciphertext, sa: int, sb: int, const: int, var_scale: int):
    """sa·(c1 + c2) with b-part offset `const`, wrapped to the torus."""
    a = sa * (c1.a.to(I64) + c2.a.to(I64))
    b = sb * (c1.b.to(I64) + c2.b.to(I64)) + const
    return Ciphertext(_wrap(a), _wrap(b), variance=var_scale * (c1.variance + c2.variance))


def NAND(ctx, bk, c1: Ciphertext, c2: Ciphertext) -> Ciphertext:
    return _bootstrap(ctx, bk, _lin(c1, c2, -1, -1, MU, 1))


def AND(ctx, bk, c1, c2) -> Ciphertext:
    return _bootstrap(ctx, bk, _lin(c1, c2, 1, 1, -MU, 1))


def OR(ctx, bk, c1, c2) -> Ciphertext:
    return _bootstrap(ctx, bk, _lin(c1, c2, 1, 1, MU, 1))


def NOR(ctx, bk, c1, c2) -> Ciphertext:
    return _bootstrap(ctx, bk, _lin(c1, c2, -1, -1, -MU, 1))


def XOR(ctx, bk, c1, c2) -> Ciphertext:
    return _bootstrap(ctx, bk, _lin(c1, c2, 2, 2, 2 * MU, 4))


def XNOR(ctx, bk, c1, c2) -> Ciphertext:
    return _bootstrap(ctx, bk, _lin(c1, c2, -2, -2, -2 * MU, 4))


def NOT(ctx, c1: Ciphertext) -> Ciphertext:
    """No bootstrap needed (reference operator.cuh:640)."""
    return Ciphertext(_wrap(-c1.a.to(I64)), _wrap(-c1.b.to(I64)), variance=c1.variance)


def MUX(ctx, bk, sel, c_true, c_false) -> Ciphertext:
    """sel ? c_true : c_false.

    Reference cost structure (operator.cuh:688-812): two blind rotations
    whose N-LWE outputs are combined linearly before the keyswitch, and one
    keyswitch.  The two rotations are independent, so they run as ONE
    batched 2B chain."""
    nsel = NOT(ctx, sel)
    t = _lin(sel, c_true, 1, 1, -MU, 1)
    f = _lin(nsel, c_false, 1, 1, -MU, 1)
    pre = Ciphertext(torch.cat([t.a, f.a]), torch.cat([t.b, f.b]),
                     variance=max(sel.variance + c_true.variance,
                                  nsel.variance + c_false.variance))
    s = _bootstrap(ctx, bk, pre, keyswitch=False)         # NLwe, batch 2B
    B = sel.a.shape[0]
    comb = NLwe(_wrap(s.a[:B].to(I64) + s.a[B:]), _wrap(s.b[:B].to(I64) + s.b[B:] + MU),
                variance=2 * s.variance)
    return lwe_keyswitch(ctx, bk, comb)


def print_parameters(ctx: TfheContext):
    """Reference HEContext::print_parameters analog (STD128 fixed set)."""
    print(f"/ TFHE parameters (STD128)\n"
          f"| LWE n: {ctx.n}   TRLWE N: {ctx.N} (k={ctx.k})\n"
          f"| TGSW: l={ctx.l}, bg_bit={ctx.bg_bit}\n"
          f"| keyswitch: base 2^{ctx.ks_base_bit}, length {ctx.ks_length}\n"
          f"| CRT NTT primes: {ctx.primes}\n"
          f"\\ sigmas: ks={SIGMA_KS:.3e}, bk={SIGMA_BK:.3e}")
