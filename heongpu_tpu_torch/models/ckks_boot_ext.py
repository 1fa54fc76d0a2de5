"""CKKS bootstrapping variants (port of heongpu_tpu/models/ckks_boot_ext.py):
the Chebyshev-cosine EvalMod ("v2"), slim, bit and gate bootstrapping,
sparse-secret switching around the mod-raise, and less-key mode.

  * EvalMod v2: a Chebyshev interpolation of cos on the mod-raise interval,
    evaluated in the power basis by baby-step/giant-step (poly_eval.py,
    depth ceil(log2 d) + 1), then r double-angle steps: cos(2^r·θ0) with
    θ0 = (2π·raw/q0 + φ − π/2)/2^r.  With φ = 0 that is sin(2π·raw/q0), the
    modular reduction.
  * Bit and gate bootstrapping reuse the cosine engine with a gate's phase φ
    and an affine output map, realised by scale metadata, negation and one
    add_plain (ePrint 2024/767: bits encoded at q0/2, gate inputs at q0/3).
  * Slim order (StoC, mod-raise, CtoS, EvalMod) places the StoC pieces at
    the end of the modulus chain; the piece levels are fixed at keygen.
  * Sparse-secret switching (ePrint 2020/1203): the main key stays dense, and
    a low-Hamming-weight temporary key wraps the mod-raise so that its
    overflow ||I|| stays small.
  * Less-key mode keys the power-of-two rotations at the shallowest piece
    level and no giant step: each giant rotation composes from that chain
    (ckks_boot.rotate_exact's fallback), fewer keys for more keyswitches.

Every step after the diagonals is exact integer arithmetic on the port's
CKKS surface and returns the reference's residues.  compress_keys=True
stores the Galois and relin keys stripped, as ckks_boot does; keys aligned
for a limb mesh (limb_align != 1) raise errors.ParameterError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from ..utils import rng
from . import ckks, ckks_boot, poly_eval, ringkit
from .ckks import Ciphertext, CkksContext
from .ckks_boot import Piece, _build_piece, _encoder, build_dft_pieces


@dataclasses.dataclass(frozen=True, eq=True)
class BootConfigV2:
    """The reference's BootstrappingConfigV2 {EncodingMatrixConfig,
    EvalModConfig}."""
    cos_degree: int = 24        # Chebyshev degree of the cos approximation
    double_angles: int = 5      # r: evaluate cos(θ/2^r), then double r times
    # R = 2π(K+1)/2^r must stay at about 3 or below: the power-basis
    # evaluation of cos(R·y) is well-conditioned only for small R (the
    # monomial coefficients grow like R^k/k!).
    K: int = 12                 # mod-raise overflow bound ||I||_inf
    ctos_pieces: int = 2
    stoc_pieces: int = 2
    base_count: int = 1         # primes in the boot base Q0 (see BootConfig)

    @property
    def evalmod_depth(self) -> int:
        m = max(1, self.cos_degree.bit_length())   # 2^m > degree
        return m + 1 + self.double_angles

    @property
    def R(self) -> float:
        """The Chebyshev half-interval: |θ0| <= 2π(K+1)/2^r."""
        return 2 * math.pi * (self.K + 1) / (1 << self.double_angles)


@dataclasses.dataclass
class BootKeysV2:
    gk: ringkit.GaloisKey
    rk: ringkit.KSKey
    cfg: BootConfigV2
    msg_scale: float
    variant: str                # 'regular' | 'slim' | 'bit' | 'gate'
    ctos_pieces: List[Piece]
    stoc_pieces: List[Piece]
    mult_i: tuple
    mult_neg_i: tuple
    cos_coeffs: np.ndarray      # power-basis coefficients of cos(R·y) on [-1, 1]
    # sparse-secret switching: dense key -> sparse key before the mod-raise,
    # sparse -> dense after it
    swk_to_sparse: Optional[ringkit.KSKey] = None
    swk_to_dense: Optional[ringkit.KSKey] = None

    @property
    def ctos_out_level(self) -> int:
        return len(self.ctos_pieces)


def _q0(ctx, base_count: int) -> int:
    q0 = 1
    for qj in ctx.q_primes[:base_count]:
        q0 *= int(qj)
    return q0


def generate_bootstrap_keys_v2(ctx: CkksContext, key, sk: ringkit.SecretKey,
                               cfg: BootConfigV2 = None, variant: str = "regular",
                               msg_scale: Optional[float] = None,
                               sparse_hw: Optional[int] = None,
                               less_key_mode: bool = False, compress_keys: bool = False,
                               limb_align: int = 1, inv_form: bool = False) -> BootKeysV2:
    """Keys and diagonal plaintexts for the v2 family, on the context's
    device.  Piece placement:
      regular: CtoS at levels 0..p1-1, StoC after EvalMod;
      slim / bit / gate: StoC at the chain's tail (ending on the boot base),
      CtoS at levels 0..p1-1 after the mod-raise; no trailing StoC."""
    cfg = cfg or BootConfigV2()
    ckks_boot._check_ported(limb_align)
    n = ctx.n
    q0 = _q0(ctx, cfg.base_count)
    if msg_scale is None:
        # bit and gate payloads are encoded at the ePrint 2024/767 scales; the
        # CtoS fold must be built against the actual input scale
        msg_scale = {"bit": q0 / 2.0, "gate": q0 / 3.0}.get(variant, ctx.default_scale)
    msg_scale = float(msg_scale)
    r = cfg.double_angles
    # t0 slots = f_fold·2·(raw coeff)/Δ must equal (2π·raw/q0)/(2^r·R)
    f_ctos = (2 * math.pi * msg_scale / ((1 << r) * q0 * cfg.R)) / 2

    ctos_mats = build_dft_pieces(n, cfg.ctos_pieces, True, f_ctos)
    p1 = len(ctos_mats)
    enc = _encoder(ctx)
    # the last CtoS piece renormalizes the working scale to default_scale, so
    # EvalMod's power ladder is well-scaled even when msg_scale << q0
    ctos_pieces = [
        _build_piece(ctx, m, lvl, enc,
                     scale_mult=(ctx.default_scale / msg_scale if lvl == p1 - 1 else 1.0))
        for lvl, m in enumerate(ctos_mats)]

    if variant == "regular":
        c_out = q0 / (2 * math.pi * msg_scale)
        stoc_mats = build_dft_pieces(n, cfg.stoc_pieces, False, c_out)
        lvl0 = p1 + cfg.evalmod_depth
    else:
        stoc_mats = build_dft_pieces(n, cfg.stoc_pieces, False, 1.0)
        lvl0 = ctx.k - cfg.base_count - len(stoc_mats)
        assert lvl0 >= 0, "chain too short for slim StoC placement"
    stoc_pieces = [_build_piece(ctx, m, lvl0 + i, enc) for i, m in enumerate(stoc_mats)]

    extra = {}
    if less_key_mode:
        # giants compose from the power-of-two chain, keyed at the shallowest
        # piece level
        min_lvl = min(pc.level for pc in ctos_pieces + stoc_pieces)
        j = 1
        while j < n // 2:
            extra[j] = min_lvl
            j *= 2
    gk, rk = ckks_boot.leveled_boot_keys(
        ctx, key, sk, ctos_pieces + stoc_pieces, aux_lvl=p1, compress_keys=compress_keys,
        extra_steps_lvl=extra, include_giants=not less_key_mode, limb_align=limb_align,
        inv_form=inv_form)
    swk_to_sparse = swk_to_dense = None
    if sparse_hw is not None:
        sk_sp = ckks.keygen_secret(ctx, rng.fold_in(key, 2), hamming_weight=sparse_hw)
        swk_to_sparse = ckks.keygen_switch(ctx, rng.fold_in(key, 3), sk, sk_sp)
        swk_to_dense = ckks.keygen_switch(ctx, rng.fold_in(key, 4), sk_sp, sk)
        assert cfg.K >= sparse_hw // 2 + 3, "cfg.K must cover the sparse-key mod-raise overflow"
    return BootKeysV2(gk=gk, rk=rk, cfg=cfg, msg_scale=msg_scale, variant=variant,
                      ctos_pieces=ctos_pieces, stoc_pieces=stoc_pieces,
                      mult_i=ckks.monomial_mult_tables(ctx, n // 2),
                      mult_neg_i=ckks.monomial_mult_tables(ctx, 2 * n - n // 2),
                      cos_coeffs=poly_eval.cosine_approx_coeffs(cfg.R, cfg.cos_degree),
                      swk_to_sparse=swk_to_sparse, swk_to_dense=swk_to_dense)


# =========================================================================
# The cosine EvalMod engine
# =========================================================================

def eval_cos_engine(ctx: CkksContext, t: Ciphertext, keys: BootKeysV2,
                    phase: float) -> Ciphertext:
    """Given t = A/(2^r·R) with A = 2π·raw/q0 (the CtoS fold), return
    cos(A + phase): shift by phase/(2^r·R), evaluate cos(R·y) as a
    polynomial, then double the angle r times."""
    cfg = keys.cfg
    r = cfg.double_angles
    shift = phase / ((1 << r) * cfg.R)
    y = t
    if abs(shift) > 1e-30:
        y = ckks.add_plain(ctx, t, ckks.encode_const(ctx, shift, t.scale, level=t.level))
    c = poly_eval.eval_poly_bsgs(ctx, y, keys.cos_coeffs, keys.rk)
    for _ in range(r):
        sq = ckks.rescale(ctx, ckks.relinearize(ctx, ckks.multiply(ctx, c, c), keys.rk))
        two_sq = ckks.add(ctx, sq, sq)
        one = ckks.encode_const(ctx, 1.0, two_sq.scale, level=two_sq.level)
        c = ckks.sub_plain(ctx, two_sq, one)
    return c


def eval_mod_sin(ctx, t: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    """The modular reduction: sin(2π·raw/q0) = cos(2π·raw/q0 − π/2)."""
    return eval_cos_engine(ctx, t, keys, phase=-math.pi / 2)


# =========================================================================
# Entry points
# =========================================================================

def regular_bootstrap_v2(ctx: CkksContext, ct: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    """Chebyshev-EvalMod regular bootstrapping: the input at the last
    base_count limbs, the output the same message at a fresh level.  With
    sparse switch keys the mod-raise runs under the temporary sparse key."""
    assert keys.variant == "regular"
    raised = _raise_maybe_sparse(ctx, ct, keys)
    t0, t1 = _coeff_to_slot(ctx, raised, keys)
    s0 = eval_mod_sin(ctx, t0, keys)
    s1 = eval_mod_sin(ctx, t1, keys)
    return _slot_to_coeff(ctx, s0, s1, keys)


def _raise_maybe_sparse(ctx, m: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    """The mod-raise, under the temporary sparse key where keys has one."""
    if keys.swk_to_sparse is not None:
        m = ckks.switch_key(ctx, m, keys.swk_to_sparse)
    raised = ckks_boot.mod_raise(ctx, m, keys.cfg.base_count)
    if keys.swk_to_dense is not None:
        raised = ckks.switch_key(ctx, raised, keys.swk_to_dense)
    return raised


def _apply_stoc(ctx, m: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    for piece in keys.stoc_pieces:
        m = ckks_boot.matvec_piece(ctx, m, piece, keys.gk)
    return m


def slim_bootstrap(ctx: CkksContext, ct: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    """Slot-payload refresh: StoC at the chain's tail, mod-raise, CtoS,
    EvalMod, recombine; the output stays in the slots.  The payload is
    encrypted at msg_scale << q0 (the sin(x) ≈ x error grows as
    (2π·msg_scale·|z|/q0)²/6), the same msg_scale as at keygen."""
    assert keys.variant == "slim"
    m = _apply_stoc(ctx, ct, keys)
    assert ctx.active(m.level) == keys.cfg.base_count, \
        "slim StoC must end on the boot base limbs"
    raised = _raise_maybe_sparse(ctx, m, keys)
    t0, t1 = _coeff_to_slot(ctx, raised, keys)
    s0 = eval_mod_sin(ctx, t0, keys)
    s1 = eval_mod_sin(ctx, t1, keys)
    out = ckks.add(ctx, s0, ckks.multiply_by_monomial(ctx, s1, keys.mult_i))
    # value = sin(2π·Δm/Q0) ≈ 2πΔ/Q0 · m: the exit constant goes into the scale
    out_scale = out.scale * 2 * math.pi * keys.msg_scale / _q0(ctx, keys.cfg.base_count)
    return Ciphertext(out.c, out.size, out.level, out_scale)


def _cos_affine_pair(ctx, m: Ciphertext, keys: BootKeysV2, phase: float, mul: float,
                     add: float) -> Ciphertext:
    """mul·cos(2π·raw/q0 + phase) + add of the StoC'd m, slot-wise."""
    raised = _raise_maybe_sparse(ctx, _apply_stoc(ctx, m, keys), keys)
    t0, t1 = _coeff_to_slot(ctx, raised, keys)
    outs = [_affine(ctx, eval_cos_engine(ctx, t, keys, phase=phase), mul=mul, add=add)
            for t in (t0, t1)]
    return ckks.add(ctx, outs[0], ckks.multiply_by_monomial(ctx, outs[1], keys.mult_i))


def bit_bootstrap(ctx: CkksContext, ct: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    """Refresh a ciphertext whose slots hold bits encoded at scale q0/2:
    b = (1 − cos(2π·raw/q0))/2, since raw = (q0/2)·b + q0·I."""
    assert keys.variant == "bit"
    return _cos_affine_pair(ctx, ct, keys, phase=0.0, mul=-0.5, add=0.5)


GATE_TABLE = {
    # gate: (phase φ such that cos(A + φ) = 1 exactly on the accepting sums,
    # mul, add), with A = 2π(I + s/3), s = b1 + b2; cos reads 1 (accept) or -1/2
    "AND": (-4 * math.pi / 3, 2 / 3, 1 / 3),
    "OR": (0.0, -2 / 3, 1 / 3 + 1 / 3),
    "XOR": (-2 * math.pi / 3, 2 / 3, 1 / 3),
    "NAND": (-4 * math.pi / 3, -2 / 3, 1 - 1 / 3),
    "NOR": (0.0, 2 / 3, 1 / 3),
    "XNOR": (-2 * math.pi / 3, -2 / 3, 1 - 1 / 3),
}


def gate_bootstrap(ctx: CkksContext, ct1: Ciphertext, ct2: Ciphertext, gate: str,
                   keys: BootKeysV2) -> Ciphertext:
    """A boolean gate with built-in refresh: the inputs hold bits at scale
    q0/3 in the slots; s = b1 + b2 in {0, 1, 2}; the gate's output is an
    affine map of cos(2π(I + s/3) + φ_gate)."""
    assert keys.variant == "gate"
    phase, mul, add = GATE_TABLE[gate.upper()]
    return _cos_affine_pair(ctx, ckks.add(ctx, ct1, ct2), keys, phase=phase, mul=mul, add=add)


def _affine(ctx, c: Ciphertext, mul: float, add: float) -> Ciphertext:
    """mul·c + add: the scale metadata takes |mul|, a negation its sign, and
    one add_plain the constant."""
    out = ckks.negate(ctx, c) if mul < 0 else c
    out = Ciphertext(out.c, out.size, out.level, out.scale / abs(mul))
    if abs(add) > 1e-30:
        out = ckks.add_plain(ctx, out, ckks.encode_const(ctx, add, out.scale, level=out.level))
    return out


def _coeff_to_slot(ctx, ct: Ciphertext, keys: BootKeysV2):
    w = ct
    for piece in keys.ctos_pieces:
        w = ckks_boot.matvec_piece(ctx, w, piece, keys.gk)
    return ckks_boot.ctos_finish(ctx, w, keys)


def _slot_to_coeff(ctx, s0: Ciphertext, s1: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    return _apply_stoc(ctx, ckks_boot.stoc_entry(ctx, s0, s1, keys), keys)
