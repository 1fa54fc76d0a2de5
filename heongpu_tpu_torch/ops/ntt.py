"""Negacyclic NTT/INTT over RNS primes (port of heongpu_tpu/ops/ntt.py).

The same four-step transform with the same tables and the same storage
order: N = N1·N2,

    N2 merged-negacyclic CT-DIT NTTs of size N1 (axis -2)
    ->  cross-twiddle tw_mat (psi^(i2)·w^(i2·br1(r)))  ->  transpose  ->
    N1 cyclic GS-DIF NTTs of size N2 (axis -2)

and the mirror chain for the inverse, with n^{-1}·psi^{-i} folded into
itw_mat and the merged inverse stage tables.  The NTT domain is held in the
reference's permutation-free storage order: position p holds the evaluation
at psi^(2j+1) with j = eval_order(n)[p].

`ntt_fwd` / `ntt_inv` launch the hand-written CUDA kernel
(kernels/csrc/ntt.cu) for CUDA tensors and run the plain int64 stage path
(`ntt_fwd_plain` / `ntt_inv_plain`) for CPU tensors.  Both return canonical
residues, so they agree bit for bit with each other and with the reference.
`ntt_pass` runs one of the two passes on one rank's block of a transform
sharded over d ranks (parallel/ntt_sharded.py): K1's split entry on the
card, the same stage functions on the CPU.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..utils import native, nt
from . import modmath as mm


def split_n(n: int) -> Tuple[int, int]:
    """N1·N2 = N with N1 = 2^(logn//2) ≤ N2."""
    logn = n.bit_length() - 1
    n1 = 1 << (logn // 2)
    return n1, n // n1


@lru_cache(maxsize=None)
def eval_order(n: int) -> np.ndarray:
    """eval_order[p] = j such that NTT-domain position p holds a(psi^(2j+1))."""
    n1, n2 = split_n(n)
    b1 = n1.bit_length() - 1
    b2 = n2.bit_length() - 1
    br1 = np.array([nt.bit_reverse(i, b1) for i in range(n1)], np.int64)
    br2 = np.array([nt.bit_reverse(i, b2) for i in range(n2)], np.int64)
    return (br2[:, None] * n1 + br1[None, :]).reshape(-1).astype(np.int32)


@lru_cache(maxsize=None)
def inv_eval_order(n: int) -> np.ndarray:
    """inv_eval_order[j] = storage position of the evaluation at psi^(2j+1)."""
    eo = eval_order(n)
    ieo = np.empty_like(eo)
    ieo[eo] = np.arange(n, dtype=np.int32)
    return ieo


_PACKED = ("tw1p", "tw1p_sh", "itw1p", "itw1p_sh",
           "tw2p", "tw2p_sh", "itw2p", "itw2p_sh")


@dataclasses.dataclass(frozen=True, eq=False)
class NttTables:
    """Per-prime-set NTT tables, int32 tensors on one device.

    Per-limb constants (L,); psi / ipsi_n / tw_mat tables (L, N).  The stage
    twiddles are packed once per direction: tw1p is (L, N1) with stage s
    (2^(s-1) twiddles of the size-N1 merged sub-transform) at columns
    [2^(s-1), 2^s), tw2p (L, N2) likewise for the size-N2 cyclic one; column
    0 is unused.  `tw1[s-1]` etc. are views of these, the reference's
    per-stage arrays.  Shoup companions (`*_sh`) are uint32 bit patterns."""
    n: int
    logn: int
    n1: int
    n2: int
    primes: Tuple[int, ...]
    p: torch.Tensor
    pinv: torch.Tensor
    r2: torch.Tensor
    mu: torch.Tensor
    r1: torch.Tensor
    r1_sh: torch.Tensor
    psi: torch.Tensor
    psi_sh: torch.Tensor
    ipsi_n: torch.Tensor
    ipsi_n_sh: torch.Tensor
    tw_mat: torch.Tensor
    tw_mat_sh: torch.Tensor
    itw_mat: torch.Tensor
    itw_mat_sh: torch.Tensor
    tw1p: torch.Tensor
    tw1p_sh: torch.Tensor
    itw1p: torch.Tensor
    itw1p_sh: torch.Tensor
    tw2p: torch.Tensor
    tw2p_sh: torch.Tensor
    itw2p: torch.Tensor
    itw2p_sh: torch.Tensor

    @property
    def num_limbs(self) -> int:
        return len(self.primes)

    @property
    def device(self) -> torch.device:
        return self.p.device

    @staticmethod
    def _stages(packed):
        log = packed.shape[1].bit_length() - 1
        return tuple(packed[:, 1 << (s - 1): 1 << s] for s in range(1, log + 1))

    tw1 = property(lambda self: self._stages(self.tw1p))
    tw1_sh = property(lambda self: self._stages(self.tw1p_sh))
    itw1 = property(lambda self: self._stages(self.itw1p))
    itw1_sh = property(lambda self: self._stages(self.itw1p_sh))
    tw2 = property(lambda self: self._stages(self.tw2p))
    tw2_sh = property(lambda self: self._stages(self.tw2p_sh))
    itw2 = property(lambda self: self._stages(self.itw2p))
    itw2_sh = property(lambda self: self._stages(self.itw2p_sh))

    def _tensor_fields(self):
        return [f.name for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def slice_limbs(self, lo: int, hi: int) -> "NttTables":
        """Tables restricted to limbs [lo, hi) — used for leveled ops."""
        kw = {f: getattr(self, f)[lo:hi] for f in self._tensor_fields()}
        return dataclasses.replace(self, primes=self.primes[lo:hi], **kw)

    def concat(self, other: "NttTables") -> "NttTables":
        """Tables over this limb set followed by `other`'s."""
        kw = {f: torch.cat([getattr(self, f), getattr(other, f)])
              for f in self._tensor_fields()}
        return dataclasses.replace(self, primes=self.primes + other.primes, **kw)


def pow_series(base: int, n: int, p: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod p as uint32, vectorised."""
    out = np.ones(n, dtype=np.uint64)
    e = np.arange(n, dtype=np.uint64)
    sq = np.uint64(base % p)
    pu = np.uint64(p)
    bit = 0
    while (1 << bit) < max(n, 2):
        mask = (e >> np.uint64(bit)) & np.uint64(1)
        out = np.where(mask == 1, out * sq % pu, out)
        sq = sq * sq % pu
        bit += 1
    return out.astype(np.uint32)


def shoup_np(w: np.ndarray, p: int) -> np.ndarray:
    """Vectorised floor(w * 2**32 / p)."""
    return ((w.astype(np.uint64) << np.uint64(32)) // np.uint64(p)).astype(np.uint32)


def _stage_tables(w_sub: int, size: int, p: int):
    """Cyclic sub-NTT stage twiddles: stage s (m = 2^s) uses
    w_m^t = w_sub^((size/m)·t), t < m/2."""
    logm = size.bit_length() - 1
    return [pow_series(pow(w_sub, size // (1 << s), p), 1 << (s - 1), p)
            for s in range(1, logm + 1)]


def _merged_stage_tables(psi_sub: int, size: int, p: int):
    """Merged-negacyclic stage twiddles: stage s (m = 2^(s-1) groups) uses
    S_i = psi_sub^(bitrev_log2(size)(m+i)) for i < m."""
    logm = size.bit_length() - 1
    pows = pow_series(psi_sub, size, p)
    out = []
    for s in range(1, logm + 1):
        m = 1 << (s - 1)
        idx = np.array([nt.bit_reverse(m + i, logm) for i in range(m)], np.int64)
        out.append(pows[idx])
    return out


def _pack(stages, size: int, p: int):
    """Per-stage arrays -> one (size,) row with stage s at [2^(s-1), 2^s),
    and its Shoup companion row."""
    row = np.zeros(size, np.uint32)
    for s, ts in enumerate(stages, start=1):
        row[1 << (s - 1): 1 << s] = ts
    return row, shoup_np(row, p)


def build_ntt_tables(primes, n: int, device, psis=None) -> NttTables:
    """Host-side table construction (numpy / python ints), copied from the
    reference's builder; the tensors are placed on `device`."""
    logn = n.bit_length() - 1
    assert 1 << logn == n
    n1, n2 = split_n(n)
    b1 = n1.bit_length() - 1
    L = len(primes)
    for p in primes:
        assert p < (1 << 30), "primes < 2**30 leave the lazy [0, 4p) headroom"
        assert (p - 1) % (2 * n) == 0
    if psis is None:
        psis = [nt.minimal_primitive_root_2n(2 * n, p) for p in primes]

    consts = {
        "p": list(primes),
        "pinv": [mm.mont_pinv(p) for p in primes],
        "r2": [mm.mont_r2(p) for p in primes],
        "mu": [mm.barrett_mu(p) for p in primes],
        "r1": [mm.mont_r1(p) for p in primes],
        "r1_sh": [mm.shoup(mm.mont_r1(p), p) for p in primes],
    }
    br1 = np.array([nt.bit_reverse(i, b1) for i in range(n1)], np.int64)
    big = {k: np.empty((L, n), np.uint32) for k in
           ("psi", "psi_sh", "ipsi_n", "ipsi_n_sh",
            "tw_mat", "tw_mat_sh", "itw_mat", "itw_mat_sh")}
    packed = {k: np.empty((L, n1 if k.endswith(("1p", "1p_sh")) else n2), np.uint32)
              for k in _PACKED}

    use_native = native.available()
    for li, (p, psi) in enumerate(zip(primes, psis)):
        w = psi * psi % p
        iw = pow(w, -1, p)
        pu = np.uint64(p)
        if use_native:
            (big["psi"][li], big["psi_sh"][li], big["ipsi_n"][li],
             big["ipsi_n_sh"][li]) = native.psi_tables(psi, n, p)
        else:
            big["psi"][li] = pow_series(psi, n, p)
            big["psi_sh"][li] = shoup_np(big["psi"][li], p)
            big["ipsi_n"][li] = (pow_series(pow(psi, -1, p), n, p).astype(np.uint64)
                                 * np.uint64(pow(n, -1, p)) % pu)
            big["ipsi_n_sh"][li] = shoup_np(big["ipsi_n"][li], p)
        pp, ip = big["psi"][li], big["ipsi_n"][li].astype(np.uint64)

        # cross twiddles with the folded negacyclic factors:
        #   fwd: tw_mat[r·N2 + i2] = psi^(i2) · w^(i2 · br1(r))
        #   inv: itw_mat[r·N2 + i2] = n^{-1}·psi^{-i2} · w^{-i2 · br1(r)}
        e = (np.arange(n2, dtype=np.int64)[None, :] * br1[:, None]) % n
        wp = pow_series(w, n, p).astype(np.uint64)
        tm = (wp[e] * pp[:n2].astype(np.uint64)[None, :] % pu).reshape(-1)
        big["tw_mat"][li] = tm.astype(np.uint32)
        big["tw_mat_sh"][li] = shoup_np(tm, p)
        iwp = pow_series(iw, n, p).astype(np.uint64)
        itm = (iwp[e] * ip[:n2][None, :] % pu).reshape(-1)
        big["itw_mat"][li] = itm.astype(np.uint32)
        big["itw_mat_sh"][li] = shoup_np(itm, p)

        psi1 = pow(psi, n2, p)   # psi1^2 = w1, order 2·n1 (negacyclic n1)
        w2 = pow(w, n1, p)       # order n2
        for name, stages, size in (
                ("tw1p", _merged_stage_tables(psi1, n1, p), n1),
                ("itw1p", _merged_stage_tables(pow(psi1, -1, p), n1, p), n1),
                ("tw2p", _stage_tables(w2, n2, p), n2),
                ("itw2p", _stage_tables(pow(w2, -1, p), n2, p), n2)):
            packed[name][li], packed[name + "_sh"][li] = _pack(stages, size, p)

    t = lambda a: mm.u32_to_i32(a).to(device)
    return NttTables(
        n=n, logn=logn, n1=n1, n2=n2, primes=tuple(int(p) for p in primes),
        **{k: t(v) for k, v in consts.items()},
        **{k: t(v) for k, v in big.items()},
        **{k: t(v) for k, v in packed.items()})


# ---------------------------------------------------------------------------
# plain int64 stage path (exact arithmetic, one reduction per butterfly)
# ---------------------------------------------------------------------------

def _merged_ct_stages(y, tws, p):
    """Merged-negacyclic CT-DIT stages along axis -2 of (..., L, S, W):
    stage s has m = 2^(s-1) groups of span t = S/(2m), group i's twiddle
    tws[s-1][:, i]: (u, v) -> (u + S·v, u − S·v).  Natural in, bit-reversed
    out."""
    shp = y.shape
    size = shp[-2]
    pb = p.view(-1, 1, 1, 1)
    for s in range(1, len(tws) + 1):
        m = 1 << (s - 1)
        z = y.reshape(shp[:-2] + (m, 2, size // (2 * m), shp[-1]))
        u, v = z[..., 0, :, :], z[..., 1, :, :]
        tt = torch.remainder(v * tws[s - 1].to(mm.I64)[:, :, None, None], pb)
        y = torch.stack([torch.remainder(u + tt, pb),
                         torch.remainder(u - tt, pb)], dim=-3).reshape(shp)
    return y


def _merged_gs_stages(y, tws, p):
    """Merged-negacyclic GS-DIF stages along axis -2 (inverse of the above,
    consumed largest stage first): (u, v) -> (u + v, (u − v)·S)."""
    shp = y.shape
    size = shp[-2]
    pb = p.view(-1, 1, 1, 1)
    for s in reversed(range(1, len(tws) + 1)):
        m = 1 << (s - 1)
        z = y.reshape(shp[:-2] + (m, 2, size // (2 * m), shp[-1]))
        u, v = z[..., 0, :, :], z[..., 1, :, :]
        tt = torch.remainder((u - v) * tws[s - 1].to(mm.I64)[:, :, None, None], pb)
        y = torch.stack([torch.remainder(u + v, pb), tt], dim=-3).reshape(shp)
    return y


def _gs_stages(y, tws, p):
    """Cyclic GS-DIF stages along axis -2 of (..., L, S, W), largest stage
    first: blocks of m = 2^s, twiddle indexed by the position j < m/2 inside
    the block.  Natural in, bit-reversed out."""
    shp = y.shape
    size = shp[-2]
    pb = p.view(-1, 1, 1, 1)
    for s in reversed(range(1, len(tws) + 1)):
        m = 1 << s
        z = y.reshape(shp[:-2] + (size // m, m, shp[-1]))
        u, v = z[..., : m // 2, :], z[..., m // 2:, :]
        tt = torch.remainder((u - v) * tws[s - 1].to(mm.I64)[:, None, :, None], pb)
        y = torch.cat([torch.remainder(u + v, pb), tt], dim=-2).reshape(shp)
    return y


def _ct_stages(y, tws, p):
    """Cyclic CT-DIT stages along axis -2: bit-reversed in, natural out."""
    shp = y.shape
    size = shp[-2]
    pb = p.view(-1, 1, 1, 1)
    for s in range(1, len(tws) + 1):
        m = 1 << s
        z = y.reshape(shp[:-2] + (size // m, m, shp[-1]))
        u, v = z[..., : m // 2, :], z[..., m // 2:, :]
        tt = torch.remainder(v * tws[s - 1].to(mm.I64)[:, None, :, None], pb)
        y = torch.cat([torch.remainder(u + tt, pb),
                       torch.remainder(u - tt, pb)], dim=-2).reshape(shp)
    return y


def _check(x, tb: NttTables):
    if x.shape[-1] != tb.n or x.ndim < 2 or x.shape[-2] != tb.num_limbs:
        raise ValueError(f"expected (..., {tb.num_limbs}, {tb.n}) residues, "
                         f"got {tuple(x.shape)}")
    if x.device != tb.device:
        raise ValueError(f"residues on {x.device}, tables on {tb.device}")


def ntt_fwd_plain(x, tb: NttTables):
    """Plain int64 forward transform: (..., L, N) residues -> NTT domain."""
    _check(x, tb)
    n1, n2 = tb.n1, tb.n2
    lead = x.shape[:-1]
    p = tb.p.to(mm.I64)
    y = _merged_ct_stages(x.to(mm.I64).reshape(lead + (n1, n2)), tb.tw1, p)
    y = torch.remainder(y.reshape(lead + (tb.n,)) * tb.tw_mat.to(mm.I64), p[:, None])
    y = y.reshape(lead + (n1, n2)).transpose(-1, -2)
    y = _gs_stages(y, tb.tw2, p)
    return y.reshape(lead + (tb.n,)).to(mm.I32)


def ntt_inv_plain(x, tb: NttTables):
    """Plain int64 inverse transform: NTT domain -> coefficient domain."""
    _check(x, tb)
    n1, n2 = tb.n1, tb.n2
    lead = x.shape[:-1]
    p = tb.p.to(mm.I64)
    y = _ct_stages(x.to(mm.I64).reshape(lead + (n2, n1)), tb.itw2, p)
    y = y.transpose(-1, -2).reshape(lead + (tb.n,))
    y = torch.remainder(y * tb.itw_mat.to(mm.I64), p[:, None])
    y = _merged_gs_stages(y.reshape(lead + (n1, n2)), tb.itw1, p)
    return y.reshape(lead + (tb.n,)).to(mm.I32)


# ---------------------------------------------------------------------------
# dispatch: CUDA tensors -> the hand-written kernel, CPU tensors -> plain
# ---------------------------------------------------------------------------

def ntt_cuda(x, tb: NttTables, inverse: bool):
    """Launch K1 (kernels/csrc/ntt.cu), two passes, on x."""
    from .. import kernels
    _check(x, tb)
    if not x.is_cuda:
        raise ValueError("ntt_cuda takes CUDA tensors")
    if x.dtype != mm.I32 or not x.is_contiguous():
        raise ValueError("ntt_cuda takes contiguous int32 residues")
    if max(tb.primes) >= 1 << 30:
        raise ValueError("the lazy butterflies need primes < 2**30")
    if not 256 <= tb.n <= 1 << 16:
        raise ValueError(f"the kernel takes N = 2^8 .. 2^16 (columns of n1 = 16 .. 256 "
                         f"points), got N={tb.n}")
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)
    if inverse:
        tabs = (tb.itw_mat, tb.itw_mat_sh, tb.itw1p, tb.itw1p_sh,
                tb.itw2p, tb.itw2p_sh)
    else:
        tabs = (tb.tw_mat, tb.tw_mat_sh, tb.tw1p, tb.tw1p_sh,
                tb.tw2p, tb.tw2p_sh)
    err = kernels.library().hf_ntt(
        int(inverse), x.data_ptr(), tmp.data_ptr(), out.data_ptr(),
        x.numel() // tb.n, tb.num_limbs, tb.n1, tb.n2, tb.p.data_ptr(),
        *(t.data_ptr() for t in tabs), kernels.stream_of(x))
    kernels.check(err, "ntt")
    kernels.launches["ntt_inv" if inverse else "ntt_fwd"] += 1
    return out


def _dispatch(x, tb, inverse):
    if x.is_cuda:
        return ntt_cuda(x, tb, inverse)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for tensors on {x.device}")
    return ntt_inv_plain(x, tb) if inverse else ntt_fwd_plain(x, tb)


def ntt_fwd(x, tb: NttTables):
    """Coefficient domain -> NTT domain (storage order eval_order).
    x: (..., L, N) residues < p."""
    return _dispatch(x, tb, inverse=False)


def ntt_inv(x, tb: NttTables):
    """NTT domain (storage order) -> coefficient domain."""
    return _dispatch(x, tb, inverse=True)


# ---------------------------------------------------------------------------
# one pass of a transform sharded over d ranks (parallel/ntt_sharded.py)
# ---------------------------------------------------------------------------

CUDA_ERROR_INVALID_VALUE = 1     # hf_ntt_pass's answer to an (N, d) it does not take


def pass_shapes(tb: NttTables, inverse: bool, pass_: int, d: int):
    """(in, out) trailing shapes of one pass on a rank's block, C = n1/d and
    W = n2/d, lead dims (and the limb axis L) before them, the exchange
    buffer's rank axis d in front of everything:
      forward 1: (L, n1, W) -> (d, L, W, C);  forward 2: (d, L, W, C) -> (L, n2, C);
      inverse 1: (L, n2, C) -> (d, L, C, W);  inverse 2: (d, L, C, W) -> (L, n1, W).
    Chunk j of a pass-1 output is what rank j needs, so one all-to-all of
    equal chunks between the passes is the whole exchange."""
    L, n1, n2 = tb.num_limbs, tb.n1, tb.n2
    if pass_ not in (1, 2) or d < 1 or d & (d - 1) or n1 % d:
        raise ValueError(f"no pass {pass_} over {d} ranks at N={tb.n}")
    c, w = n1 // d, n2 // d
    block, xchg = ((L, n2, c), (L, c, w)) if inverse else ((L, n1, w), (L, w, c))
    out = (L, n1, w) if inverse else (L, n2, c)
    return ((block, (d,) + xchg) if pass_ == 1 else ((d,) + xchg, out))


def _check_pass(x, tb, inverse, pass_, d, rank):
    shp_in, _ = pass_shapes(tb, inverse, pass_, d)
    if tuple(x.shape[-3:]) != shp_in[-3:] or (pass_ == 2 and (x.ndim < 4 or x.shape[0] != d)):
        raise ValueError(f"pass {pass_} over {d} ranks takes (..., {shp_in}) residues, "
                         f"got {tuple(x.shape)}")
    if not 0 <= rank < d:
        raise ValueError(f"rank {rank} outside [0, {d})")
    if x.device != tb.device:
        raise ValueError(f"residues on {x.device}, tables on {tb.device}")


def ntt_pass_plain(x, tb: NttTables, inverse: bool, pass_: int, d: int = 1, rank: int = 0):
    """Plain version of ntt_pass_cuda: the stage functions of ntt_fwd_plain /
    ntt_inv_plain on rank `rank`'s block, in pass_shapes' layouts."""
    _check_pass(x, tb, inverse, pass_, d, rank)
    L, n1, n2 = tb.num_limbs, tb.n1, tb.n2
    c, w = n1 // d, n2 // d
    p = tb.p.to(mm.I64)
    pl = p[:, None, None]
    y = x.to(mm.I64)
    if pass_ == 2:                       # (d, ..., L, a, b) -> (..., L, d*a, b)
        y = y.movedim(0, -3)
        y = y.reshape(y.shape[:-3] + (-1, y.shape[-1]))
    if not inverse and pass_ == 1:
        y = _merged_ct_stages(y, tb.tw1, p)
        twm = tb.tw_mat.view(L, n1, n2)[:, :, rank * w:(rank + 1) * w].to(mm.I64)
        y = torch.remainder(y * twm, pl)
    elif not inverse:
        y = _gs_stages(y, tb.tw2, p)
    elif pass_ == 1:
        y = _ct_stages(y, tb.itw2, p)
        itwm = tb.itw_mat.view(L, n1, n2)[:, rank * c:(rank + 1) * c, :].to(mm.I64)
        y = torch.remainder(y * itwm.transpose(-1, -2), pl)
    else:
        y = _merged_gs_stages(y, tb.itw1, p)
    if pass_ == 1:                       # (..., L, d*a, b) -> (d, ..., L, b, a)
        y = y.reshape(y.shape[:-2] + (d, -1, y.shape[-1])).movedim(-3, 0).transpose(-1, -2)
    return y.contiguous().to(mm.I32)


def ntt_pass_cuda(x, tb: NttTables, inverse: bool, pass_: int, d: int = 1, rank: int = 0):
    """Launch one pass of K1's split entry (hf_ntt_pass, kernels/csrc/ntt.cu) on
    rank `rank`'s block.  Raises ValueError for an (N, d) whose blocks are not
    whole tiles of the kernel (d <= 16 at N = 2^16, 8 at 2^15, 4 at 2^14, 2 at
    2^13, 1 below)."""
    from .. import kernels
    _check_pass(x, tb, inverse, pass_, d, rank)
    if not x.is_cuda or x.dtype != mm.I32 or not x.is_contiguous():
        raise ValueError("ntt_pass_cuda takes contiguous int32 CUDA residues")
    if max(tb.primes) >= 1 << 30:
        raise ValueError("the lazy butterflies need primes < 2**30")
    _, shp_out = pass_shapes(tb, inverse, pass_, d)
    lead = x.shape[1:-3] if pass_ == 2 else x.shape[:-3]
    out_shape = (shp_out[:1] + lead + shp_out[1:]) if pass_ == 1 else (lead + shp_out)
    out = torch.empty(out_shape, dtype=mm.I32, device=x.device)
    pre = "itw" if inverse else "tw"
    tabs = [getattr(tb, pre + k) for k in ("_mat", "_mat_sh", "1p", "1p_sh", "2p", "2p_sh")]
    rows = x.numel() // (tb.n // d)
    err = kernels.library().hf_ntt_pass(
        int(inverse), pass_, x.data_ptr(), out.data_ptr(), rows, tb.num_limbs, tb.n1, tb.n2,
        d, rank, tb.p.data_ptr(), *(t.data_ptr() for t in tabs), kernels.stream_of(x))
    if err == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"K1's split passes do not take N={tb.n} over {d} ranks: a rank's "
                         f"block must hold whole tiles")
    kernels.check(err, "ntt_pass")
    kernels.launches["ntt_pass"] += 1
    return out


def ntt_pass(x, tb: NttTables, inverse: bool, pass_: int, d: int = 1, rank: int = 0):
    """One pass of a transform sharded over d ranks on rank `rank`'s block
    (pass_shapes): K1's split entry for CUDA tensors, the plain stages for CPU
    tensors."""
    if x.is_cuda:
        return ntt_pass_cuda(x, tb, inverse, pass_, d, rank)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for tensors on {x.device}")
    return ntt_pass_plain(x, tb, inverse, pass_, d, rank)


def ntt_naive_host(a, p: int, psi: int):
    """O(N^2) reference for tests: evaluations at psi^(2j+1) in NATURAL j
    order, python ints.  NTT position p holds want[eval_order(n)[p]]."""
    n = len(a)
    out = []
    for j in range(n):
        pt = pow(psi, 2 * j + 1, p)
        acc = 0
        x = 1
        for i in range(n):
            acc = (acc + a[i] * x) % p
            x = x * pt % p
        out.append(acc)
    return out
