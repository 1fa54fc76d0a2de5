"""CKKS regular bootstrapping (port of heongpu_tpu/models/ckks_boot.py):
mod-raise, the factored CoeffToSlot / SlotToCoeff homomorphic DFT with
double-hoisted BSGS matrix-vector products, and EvalMod by a
scaled-exponential Taylor series with repeated squaring.

  * The homomorphic DFT is factored like the reference's encoding-matrix
    pieces: the special FFT on the 5^j slot orbit is a product of
    log2(n/2) sparse butterfly stages (3 generalized diagonals each);
    consecutive stages are merged numerically (host numpy) into `pieces`
    factors.  Bit-reversal is skipped on both sides: it cancels between
    CtoS and StoC because EvalMod acts slot by slot.
  * Each piece is a BSGS matvec with double hoisting: the input's digits are
    decomposed once (`ckks.hoist`: K2 base_conv and K1 on the card), every
    baby rotation is accumulated P-scaled over the extended basis Q̃ (K2
    mac_keys), and the exact ÷P runs once per giant step, whose rotation is
    one keyswitch (K5).
  * The diagonal plaintexts are encoded at key-generation time on the
    device (float64 special FFT, exact RNS reduction, K1, Montgomery form)
    over Q̃ at the level where the piece runs.
  * Multiplication by ±i is an NTT-domain pointwise product by X^(±n/2);
    the EvalMod entry constant 2πΔ/(2^r q0) is folded into the CtoS
    diagonals and the exit constant -i/2 · q0/(2πΔ) into the StoC ones.

Every step after the diagonals is exact integer arithmetic and returns the
reference's residues; the diagonals themselves come from the float64
encoder, which is exact where the reference's df64 one is off by up to 3 in
a centered coefficient (tests/encoder_gap.py).  compress_keys=True stores
the Galois and relin keys seed-expanded and stripped (leveled_boot_keys):
each use regenerates the key's uniform half (K7 on the card).  Its seeds
are the port's own, kept apart where the reference's collide, so such a
set and the residues of a bootstrap with it differ from the reference's.
The limb alignment of keys for a sharded mesh is not ported.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops import compose, polyops, rns
from ..ops import modmath as mm
from ..ops import ntt as nttm
from ..utils import errors, rng
from . import ckks, ringkit
from .ckks import Ciphertext, CkksContext


@dataclasses.dataclass(frozen=True, eq=True)
class BootConfig:
    """The reference's BootstrappingConfig{CtoS_piece, StoC_piece,
    taylor_number} with its precision knobs (see the reference's BootConfig
    for the reasoning behind base_count, arcsin_order and piece_depth)."""
    taylor_degree: int = 7
    exp_squarings: int = 5      # r: exp(theta/2^r) Taylor, then square r times
    ctos_pieces: int = 2
    stoc_pieces: int = 2
    base_count: int = 1         # primes forming the boot base Q0 = q0..q_{bc-1}
    arcsin_order: int = 0       # 1: the v - v^3/24 arcsine correction of the sine
    piece_depth: int = 1        # levels per CtoS/StoC piece (diagonal scale)


@dataclasses.dataclass(frozen=True, eq=False)
class Piece:
    """One factored-DFT matvec: BSGS plaintext diagonals over Q̃ at a fixed
    level.  giants: tuple of (giant step g, babies tuple, pts (nb, ka+p, n)
    int32, Montgomery NTT domain)."""
    level: int
    n1: int
    giants: Tuple[Tuple[int, Tuple[int, ...], torch.Tensor], ...]
    pt_scale: float
    depth: int = 1    # levels consumed (diagonals at the product of that many primes)


@dataclasses.dataclass
class BootKeys:
    gk: ringkit.GaloisKey
    rk: ringkit.KSKey
    cfg: BootConfig
    msg_scale: float
    ctos_pieces: List[Piece]
    stoc_pieces: List[Piece]
    mult_i: tuple               # X^(n/2) tables (slot-wise * i)
    mult_neg_i: tuple           # X^(-n/2) tables (slot-wise * -i)

    @property
    def out_level(self) -> int:
        last = self.stoc_pieces[-1]
        return last.level + last.depth


# =========================================================================
# Special-FFT stage factorization (host numpy, copied from the reference)
# =========================================================================

def sf_stage_diags(n: int, length: int, inverse: bool) -> Dict[int, np.ndarray]:
    """Diagonal dict {offset: (n/2,) complex} of one special-FFT butterfly
    stage on the 5^j slot orbit (the reference's E_diagonal factor
    matrices)."""
    half = n // 2
    M = 2 * n
    lenh = length // 2
    lenq = length * 4
    d: Dict[int, np.ndarray] = {}

    def add(off, pos, val):
        off %= half
        if off not in d:
            d[off] = np.zeros(half, np.complex128)
        d[off][pos] = val

    for i in range(0, half, length):
        for j in range(lenh):
            idx = pow(5, j, lenq) * (M // lenq) % M
            w = np.exp(2j * np.pi * idx / M)
            t0, t1 = i + j, i + j + lenh
            if not inverse:
                add(0, t0, 1.0)
                add(lenh, t0, w)
                add(0, t1, -w)
                add(-lenh, t1, 1.0)
            else:
                add(0, t0, 0.5)
                add(lenh, t0, 0.5)
                add(0, t1, -0.5 / w)
                add(-lenh, t1, 0.5 / w)
    return d


def compose_diags(A: Dict[int, np.ndarray], B: Dict[int, np.ndarray],
                  ns: int) -> Dict[int, np.ndarray]:
    """Diagonal dict of (apply B first, then A)."""
    C: Dict[int, np.ndarray] = {}
    for r, a in A.items():
        for s, b in B.items():
            off = (r + s) % ns
            C.setdefault(off, np.zeros(ns, np.complex128))
            C[off] += a * np.roll(b, -r)
    return {k: v for k, v in C.items() if np.max(np.abs(v)) > 1e-14}


def build_dft_pieces(n: int, num_pieces: int, inverse: bool,
                     fold: complex) -> List[Dict[int, np.ndarray]]:
    """Group the special-FFT stages into `num_pieces` merged factors, in
    application order, with `fold` distributed evenly across pieces.

    CtoS uses inverse=True (stages S_half^-1 .. S_2^-1); StoC inverse=False
    (S_2 .. S_half).  Bit-reversal is skipped on both sides (cancels)."""
    half = n // 2
    lens = [2]
    while lens[-1] < half:
        lens.append(lens[-1] * 2)
    if inverse:
        applied = [sf_stage_diags(n, L, True) for L in reversed(lens)]
    else:
        applied = [sf_stage_diags(n, L, False) for L in lens]
    num_pieces = min(num_pieces, len(applied))
    chunks = np.array_split(np.arange(len(applied)), num_pieces)
    per_piece = fold ** (1.0 / num_pieces)
    pieces = []
    for ch in chunks:
        mat = applied[ch[0]]
        for i in ch[1:]:
            mat = compose_diags(applied[i], mat, half)
        pieces.append({k: v * per_piece for k, v in mat.items()})
    return pieces


def _bsgs_split(offsets: Sequence[int], ns: int) -> Tuple[int, Dict]:
    """Pick n1 minimizing (#babies + 2*#giants); return giant->babies map."""
    best = None
    for bits in range(0, ns.bit_length()):
        n1 = 1 << bits
        babies = {r % n1 for r in offsets}
        giants = {(r // n1) * n1 for r in offsets}
        cost = len(babies) + 2 * len(giants)
        if best is None or cost < best[0]:
            best = (cost, n1)
    n1 = best[1]
    groups: Dict[int, List[int]] = {}
    for r in sorted(offsets):
        groups.setdefault((r // n1) * n1, []).append(r % n1)
    return n1, groups


# =========================================================================
# Key / plaintext generation
# =========================================================================

def encode_diags_qtilde(ctx: CkksContext, vecs, level: int, scale: float) -> torch.Tensor:
    """Batch-encode slot vectors over the extended basis Q̃ (active Q limbs +
    P) on the context's device: (B, ka+p, n) int32, coefficient domain."""
    ka = ctx.active(level)
    limbs = tuple(ctx.q_primes[:ka]) + tuple(ctx.p_primes)
    return ckks.encode_batch_rns(ctx.n, np.stack(vecs), limbs, scale, ctx.device)


def encode_diags_ntt_mont(ctx: CkksContext, vecs, level: int, scale: float) -> torch.Tensor:
    """The diagonal plaintexts (encode, NTT, Montgomery form) over Q̃, built in
    chunks of about 2^22 coefficients into one preallocated tensor, so the
    peak memory is the table and one chunk's workspace."""
    chunk = max(1, (1 << 22) // ctx.n)
    tb, base = ctx.ntt_qp_at(level), ctx.base_qp_at(level)
    p, r1 = base.col(), base.col("r1")
    buf = torch.empty((len(vecs), tb.num_limbs, ctx.n), dtype=mm.I32, device=ctx.device)
    for i in range(0, len(vecs), chunk):
        res = encode_diags_qtilde(ctx, vecs[i: i + chunk], level, scale)
        buf[i: i + chunk] = mm.to_mont(nttm.ntt_fwd(res, tb), p, r1)
    return buf


def _encoder(ctx: CkksContext):
    """_build_piece's batch_encode: the diagonals on the context's device."""
    return lambda vecs, level, scale: encode_diags_ntt_mont(ctx, vecs, level, scale)


def _build_piece(ctx: CkksContext, diags: Dict[int, np.ndarray], level: int,
                 batch_encode, scale_mult: float = 1.0, depth: int = 1) -> Piece:
    """The diagonals encoded by batch_encode(vecs, level, scale) at
    scale_mult times the product of the `depth` primes the piece's rescales
    drop: the piece multiplies the ciphertext's scale by scale_mult (1: it
    leaves it as it was)."""
    ns = ctx.n // 2
    ka = ctx.active(level)
    scale = scale_mult
    for j in range(depth):
        scale *= float(ctx.q_primes[ka - 1 - j])
    n1, groups = _bsgs_split(list(diags), ns)
    vecs = [np.roll(diags[(g + b) % ns], g) for g, babies in groups.items() for b in babies]
    pts_all = batch_encode(vecs, level, scale)
    giants = []
    idx = 0
    for g, babies in groups.items():
        giants.append((g, tuple(babies), pts_all[idx: idx + len(babies)]))
        idx += len(babies)
    return Piece(level=level, n1=n1, giants=tuple(giants), pt_scale=scale, depth=depth)


def _check_ported(limb_align: int):
    if limb_align != 1:
        raise errors.ParameterError(
            "limb_align != 1 aligns keys for sharding on a device mesh, which is not "
            "ported yet (ROADMAP.md, queue 1: the parallel slice)")


def leveled_boot_keys(ctx, key, sk, pieces, aux_lvl: int, compress_keys: bool = False,
                      extra_steps_lvl: dict = None, include_giants: bool = True,
                      limb_align: int = 1, inv_form: bool = False):
    """Galois + relin keys for a bootstrap pipeline, each rotation step's key
    generated at its shallowest use level (ckks.keygen_galois(level=)), so
    the deep StoC steps get small keys; conj and relin at aux_lvl.
    extra_steps_lvl {step: level} adds steps (less-key mode's power-of-two
    chain); include_giants=False leaves the giant steps to compose from it.
    The draw order is the reference's: level groups in order, then conj,
    then relin.  limb_align != 1 (keys cut to shard evenly on a limb mesh)
    raises errors.ParameterError.

    compress_keys=True makes every key seed-expanded and stores it stripped
    (k0 only).  Its seeds, from seed0 = _compress_seed(key) < 2^31: conj
    seed0, relin seed0 + 1, the j-th key of level group i seed0 + (i+1)·2^16
    + j.  They stay below 2^32 and apart, so every key draws its own uniform
    half (a Threefry key keeps a seed mod 2^32 only).  The reference's
    layout (group i at seed0 + i·2^34, conj seed0 + 2^43, relin seed0 +
    2^44) collides mod 2^32: the j-th key of every group, conj and relin
    share one uniform half, and from the difference of two such keys' k0
    anyone holding the set can recover the secret key.  So the port's compressed set is not the reference's
    bit for bit (ROADMAP.md, queue 3); its error halves are, key for key.
    """
    _check_ported(limb_align)
    step_lvl = dict(extra_steps_lvl or {})
    for pc in pieces:
        for g, babies, _ in pc.giants:
            for step in (g, *babies) if include_giants else babies:
                if step:
                    step_lvl[step] = min(step_lvl.get(step, 1 << 30), pc.level)
    by_level = {}
    for s, lv in step_lvl.items():
        by_level.setdefault(lv, []).append(s)
    seed0 = _compress_seed(key) if compress_keys else None
    at = lambda off: None if seed0 is None else seed0 + off
    if len(by_level) >= (1 << 15) - 1 or max(map(len, by_level.values()), default=0) >= 1 << 16:
        raise errors.ParameterError("the compressed seed layout holds fewer than 2^15 - 1 "
                                    "level groups of fewer than 2^16 keys each")
    gk_all = {}
    for i, lv in enumerate(sorted(by_level)):
        gk_l = ckks.keygen_galois(ctx, rng.fold_in(key, 100 + i), sk,
                                  steps=sorted(by_level[lv]), level=lv,
                                  include_conj=False, a_seed=at((i + 1) << 16),
                                  store_a=not compress_keys, inv_form=inv_form)
        gk_all.update(gk_l.keys)
    gk_c = ckks.keygen_galois(ctx, rng.fold_in(key, 99), sk, steps=[], level=aux_lvl,
                              include_conj=True, a_seed=at(0),
                              store_a=not compress_keys, inv_form=inv_form)
    gk_all[polyops.GALOIS_CONJ] = gk_c.keys[polyops.GALOIS_CONJ]
    rk = ckks.keygen_relin(ctx, rng.fold_in(key, 1), sk, a_seed=at(1), level=aux_lvl)
    if compress_keys:
        rk = ringkit.strip_seeded(rk)
    return ringkit.GaloisKey(gk_all), rk


def _compress_seed(key) -> int:
    """The public seed of a compressed key set, from the keygen source: a
    DRBG draws it from its own stream (bits64 >> 33, as the reference does,
    so the rest of the set draws the reference's errors); a torch.Generator
    gives the low 31 bits of a SHA-256 of its state (its state does not
    move).  The reference derives it from a JAX key's words, which the port
    does not take here."""
    if rng.is_drbg(key):
        return int(key.bits64(1)[0] >> 33)
    if rng.is_threefry(key):
        raise errors.ParameterError("a compressed key set is drawn from a DRBG or a "
                                    "torch.Generator, not a Threefry key")
    state = key.get_state().cpu().numpy().tobytes()
    return int.from_bytes(hashlib.sha256(state).digest()[:4], "little") & (2 ** 31 - 1)


def generate_bootstrap_keys(ctx: CkksContext, key, sk: ringkit.SecretKey,
                            cfg: BootConfig = None, msg_scale: float = None,
                            compress_keys: bool = False, limb_align: int = 1,
                            inv_form: bool = False) -> BootKeys:
    """Rotation / conj / relin keys and the factored-DFT plaintext tables with
    the EvalMod constants folded in.  compress_keys=True stores the Galois and
    relin keys stripped (leveled_boot_keys); limb_align != 1 raises
    errors.ParameterError (keys aligned for a limb mesh are not ported)."""
    cfg = cfg or BootConfig()
    _check_ported(limb_align)
    if msg_scale is None:
        # a composite base needs a composite scale (see BootConfig.base_count)
        msg_scale = float(ctx.default_scale) ** cfg.base_count
    msg_scale = float(msg_scale)
    n = ctx.n
    q0 = 1
    for qj in ctx.q_primes[:cfg.base_count]:
        q0 *= int(qj)
    c_in = 2 * math.pi * msg_scale / ((1 << cfg.exp_squarings) * q0)
    c_out = (-0.5j) * q0 / (2 * math.pi * msg_scale)

    ctos_mats = build_dft_pieces(n, cfg.ctos_pieces, True, c_in / 2)
    stoc_mats = build_dft_pieces(n, cfg.stoc_pieces, False, c_out)
    p1 = len(ctos_mats)
    pd = cfg.piece_depth
    # EvalMod's levels: bc for the leading multiply_plain, bc per Horner step
    # and per squaring, 3·bc for the arcsine term
    bc = cfg.base_count
    stoc_level0 = (p1 * pd + bc + (cfg.taylor_degree - 1) * bc + cfg.exp_squarings * bc
                   + (3 * bc if cfg.arcsin_order else 0))
    # the pipeline consumes stoc_level0 + stoc_pieces*pd levels and must
    # leave base_count limbs for the decrypt-capable output
    need = stoc_level0 + len(stoc_mats) * pd + bc
    if ctx.k < need:
        raise errors.ParameterError(
            f"bootstrap config needs a {need}-prime Q chain "
            f"(CtoS {p1}x{pd} + EvalMod {stoc_level0 - p1 * pd} + "
            f"StoC {len(stoc_mats)}x{pd} + {bc} base limb(s)); "
            f"context has {ctx.k}")
    enc = _encoder(ctx)
    ctos_pieces = [_build_piece(ctx, m, i * pd, enc, depth=pd) for i, m in enumerate(ctos_mats)]
    stoc_pieces = [_build_piece(ctx, m, stoc_level0 + i * pd, enc, depth=pd)
                   for i, m in enumerate(stoc_mats)]
    # conj is first used at ctos_finish (level p1*pd); relin at EvalMod
    gk, rk = leveled_boot_keys(ctx, key, sk, ctos_pieces + stoc_pieces, aux_lvl=p1 * pd,
                               compress_keys=compress_keys, limb_align=limb_align,
                               inv_form=inv_form)
    return BootKeys(gk=gk, rk=rk, cfg=cfg, msg_scale=msg_scale,
                    ctos_pieces=ctos_pieces, stoc_pieces=stoc_pieces,
                    mult_i=ckks.monomial_mult_tables(ctx, n // 2),
                    mult_neg_i=ckks.monomial_mult_tables(ctx, 2 * n - n // 2))


# =========================================================================
# Building blocks
# =========================================================================

def mod_raise(ctx: CkksContext, ct: Ciphertext, base_count: int = 1) -> Ciphertext:
    """Lift a base_count-limb ciphertext to the full chain (adds Q0·I(X)): the
    centered [x]_{Q0} of each coefficient, reduced mod every Q prime
    (base_count >= 2 composes it exactly, ops/compose.mod_primes_centered)."""
    if ctx.active(ct.level) != base_count:
        raise errors.LevelMismatchError(
            f"mod_raise expects {base_count} remaining limb(s), "
            f"got {ctx.active(ct.level)}")
    coeff = nttm.ntt_inv(ct.c, ctx.ntt_qp.slice_limbs(0, base_count))
    primes = tuple(int(q) for q in ctx.q_primes)
    if base_count == 1:
        q0 = primes[0]
        v = coeff[:, 0, :].to(mm.I64)
        centered = torch.where(v > (q0 >> 1), v - q0, v)
        p = torch.tensor(primes, dtype=mm.I64, device=ct.c.device)
        raised = torch.remainder(centered[:, None, :], p[:, None]).to(mm.I32)
    else:
        base = primes[:base_count]
        raised = compose.mod_primes_centered(coeff, base, primes,
                                             ckks._compose_tabs(base, ctx.device))
    return Ciphertext(nttm.ntt_fwd(raised, ctx.ntt_q(0)), 2, 0, ct.scale)


def rotate_exact(ctx, ct, gk: ringkit.GaloisKey, step: int):
    """Rotation by `step`: one keyswitch with the key made for exactly that
    step, or, where there is none (less-key mode), composed from the
    power-of-two chain (ckks.rotate)."""
    if step % (ctx.n // 2) == 0:
        return ct
    g = polyops.steps_to_galois_elt(step, ctx.n)
    if g in gk.keys:
        return ckks.apply_galois(ctx, ct, gk.keys[g])
    return ckks.rotate(ctx, ct, gk, step)


def matvec_piece(ctx: CkksContext, ct: Ciphertext, piece: Piece,
                 gk: ringkit.GaloisKey) -> Ciphertext:
    """Double-hoisted BSGS matvec: one digit decomposition for all babies,
    P-scaled accumulation in Q̃ per giant, one ÷P per giant, `depth`
    rescales."""
    if ct.level < piece.level:
        ct = ckks.mod_drop(ctx, ct, piece.level - ct.level)
    lvl = ct.level
    if lvl != piece.level:
        raise errors.LevelMismatchError(f"piece expects level {piece.level}, got {lvl}")
    base_qp = ctx.base_qp_at(lvl)
    d_ntt = ckks.hoist(ctx, ct)
    all_babies = sorted({b for _, babies, _ in piece.giants for b in babies})
    pc0 = ckks.p_scale_to_qtilde(ctx, ct.c[0], lvl)   # shared by all babies
    reps = {}
    for b in all_babies:
        if b == 0:
            reps[0] = (pc0, ckks.p_scale_to_qtilde(ctx, ct.c[1], lvl))
        else:
            gk1 = gk.keys[polyops.steps_to_galois_elt(b, ctx.n)]
            reps[b] = ckks.rotate_hoisted_qtilde(ctx, d_ntt, gk1, pc0, lvl)
    out = None
    for g, babies, pts in piece.giants:
        # Σ_b pts[b]·reps[b]·2^-32 for both halves: the key MAC with the
        # diagonals in the digits' place (the product is symmetric)
        pair = ckks.ks_finish_at(ctx, rns.mac_keys(
            pts, torch.stack([reps[b][0] for b in babies]),
            torch.stack([reps[b][1] for b in babies]), base_qp), lvl)
        ct_g = Ciphertext(pair, 2, lvl, ct.scale * piece.pt_scale)
        if g:
            ct_g = rotate_exact(ctx, ct_g, gk, g)
        out = ct_g if out is None else ckks.add(ctx, out, ct_g)
    for _ in range(piece.depth):
        out = ckks.rescale(ctx, out)
    return out


def _const_pt(ctx, ct, value, scale):
    # exact at any scale (the drifted EvalMod working scale exceeds the
    # float64 mantissa; see ckks.encode_const)
    return ckks.encode_const(ctx, value, scale, level=ct.level)


def _mul_ct(ctx, a, b, rk, times: int = 1) -> Ciphertext:
    out = ckks.relinearize(ctx, ckks.multiply(ctx, a, b), rk)
    for _ in range(times):
        out = ckks.rescale(ctx, out)
    return out


def eval_exp_sin(ctx, x: Ciphertext, keys: BootKeys) -> Ciphertext:
    """x holds theta/2^r slots (entry constant folded into CtoS): compute
    u = exp(i*x) by Horner Taylor, square r times, return u - conj(u) (the
    -i/2*q0/(2*pi*Delta) exit constant lives in the StoC diagonals)."""
    d = keys.cfg.taylor_degree
    r = keys.cfg.exp_squarings
    bc = keys.cfg.base_count
    coefs = [(1j ** j) / math.factorial(j) for j in range(d + 1)]

    def _next_primes(ct):
        """Product of the next bc primes to be consumed: plain-constant
        rescales stay bc-wide so the composite-pair prime alignment holds."""
        ka = ctx.active(ct.level)
        s = 1.0
        for j in range(bc):
            s *= float(ctx.q_primes[ka - 1 - j])
        return s

    acc = ckks.multiply_plain(ctx, x, _const_pt(ctx, x, coefs[d], _next_primes(x)))
    for _ in range(bc):
        acc = ckks.rescale(ctx, acc)
    acc = ckks.add_plain(ctx, acc, _const_pt(ctx, acc, coefs[d - 1], acc.scale))
    for j in range(d - 2, -1, -1):
        xj = ckks.mod_drop(ctx, x, acc.level - x.level)
        acc = _mul_ct(ctx, acc, xj, keys.rk, times=bc)
        acc = ckks.add_plain(ctx, acc, _const_pt(ctx, acc, coefs[j], acc.scale))
    for _ in range(r):
        acc = _mul_ct(ctx, acc, acc, keys.rk, times=bc)
    uc = ckks.conjugate(ctx, acc, keys.gk)
    v = ckks.sub(ctx, acc, uc)           # 2i*sin(theta)
    if keys.cfg.arcsin_order:
        # w = v*(1 - v^2/24): the s^3/6 arcsine term (see BootConfig)
        v2 = _mul_ct(ctx, v, v, keys.rk, times=bc)
        inner = ckks.multiply_plain(ctx, v2, _const_pt(ctx, v2, -1.0 / 24.0, _next_primes(v2)))
        for _ in range(bc):
            inner = ckks.rescale(ctx, inner)
        inner = ckks.add_plain(ctx, inner, _const_pt(ctx, inner, 1.0, inner.scale))
        vd = ckks.mod_drop(ctx, v, inner.level - v.level)
        v = _mul_ct(ctx, vd, inner, keys.rk, times=bc)
    return v


def ctos_finish(ctx, w: Ciphertext, keys: BootKeys):
    """Tail of coeff_to_slot after the factored-DFT pieces: t0 = w + conj(w),
    t1 = u + conj(u) with u = -i*w."""
    wc = ckks.conjugate(ctx, w, keys.gk)
    t0 = ckks.add(ctx, w, wc)
    u = ckks.multiply_by_monomial(ctx, w, keys.mult_neg_i)
    uc = ckks.conjugate(ctx, u, keys.gk)
    t1 = ckks.add(ctx, u, uc)
    return t0, t1


def coeff_to_slot(ctx, ct: Ciphertext, keys: BootKeys):
    """Returns t0 (low coefficients in slots) and t1 (high ones), both
    pre-scaled by the EvalMod entry constant: w = pieces(ct), then
    ctos_finish."""
    w = ct
    for piece in keys.ctos_pieces:
        w = matvec_piece(ctx, w, piece, keys.gk)
    return ctos_finish(ctx, w, keys)


def stoc_entry(ctx, s0: Ciphertext, s1: Ciphertext, keys: BootKeys):
    """Head of slot_to_coeff before the factored-DFT pieces: m = s0 + i*s1."""
    return ckks.add(ctx, s0, ckks.multiply_by_monomial(ctx, s1, keys.mult_i))


def slot_to_coeff(ctx, s0: Ciphertext, s1: Ciphertext, keys: BootKeys):
    """m = s0 + i*s1, then the forward factored DFT."""
    m = stoc_entry(ctx, s0, s1, keys)
    for piece in keys.stoc_pieces:
        m = matvec_piece(ctx, m, piece, keys.gk)
    return m


# =========================================================================
# Entry point
# =========================================================================

def regular_bootstrap(ctx: CkksContext, ct: Ciphertext, keys: BootKeys) -> Ciphertext:
    """Input: a message at the last base_count limbs.  Output: the same
    message at a fresh, low depth (the constants are folded so that the
    output value equals the input message; the drifted scale metadata stays
    authoritative)."""
    raised = mod_raise(ctx, ct, keys.cfg.base_count)
    t0, t1 = coeff_to_slot(ctx, raised, keys)
    s0 = eval_exp_sin(ctx, t0, keys)
    s1 = eval_exp_sin(ctx, t1, keys)
    return slot_to_coeff(ctx, s0, s1, keys)
