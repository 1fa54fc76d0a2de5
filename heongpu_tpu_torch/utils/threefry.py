"""Threefry-2x32, bit-identical to `jax.random` under JAX's defaults
(`jax_threefry_partitionable=True`, `jax_enable_x64=False`, the
`threefry2x32` implementation), and the uniform RNS draw of seed-expanded
keys on it (kernel K7, kernels/csrc/threefry.cu, on the card).

The JAX package's seeded keys (`a_seed`) draw their uniform half as
`rng.uniform_rns(jax.random.PRNGKey(a_seed), primes, shape)`; this module
reproduces those bits without JAX:

  * `key_from_seed(seed)` is `PRNGKey(seed)`: the key words (0, seed mod 2^32).
    With x64 off JAX keeps only the low 32 bits of the seed, so seeds that
    differ by a multiple of 2^32 give the same key (a negative seed wraps the
    same way: PRNGKey(-3) is (0, 4294967293)).
  * `split_np(key, num)`, `split_torch`: Threefry of the counters
    (i >> 32, i & 0xffffffff) for i < num, key i being the pair of output
    words.
  * `bits32(key, shape)`: Threefry of the row-major flat index of each element
    (its high and low words), the two output words XORed.

  * `fold_in_np(key, data)`: Threefry of the counter words (0, data mod 2^32).
  * `randint`, `normal` (float32, `uniform_f32` and `erf_inv`) and
    `permutation`: jax.random's transforms of those words (below), each a
    torch pass on the words' device.

Each comes as a numpy host version (`*_np`) or a plain int64 torch version.
K7 (kernels/csrc/threefry.cu) has two modes: `uniform_rns_cuda` launches its
uniform mode (`uniform_rns_plain` is its plain version), `bits32_cuda` its
raw-words mode (`bits32_plain`).  The dispatchers `bits32` and `uniform_rns`
launch K7 for a CUDA device and run the plain version only on the CPU, so
every Threefry draw on the card (the words of randint, normal and
permutation too) is a K7 launch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def key_from_seed(seed: int) -> tuple:
    """jax.random.PRNGKey(seed) under x64 off: (0, seed mod 2^32)."""
    return (0, int(seed) & MASK)


def _hash(k0: int, k1: int, x0, x1, rotl):
    """The 20 rounds of Threefry-2x32 on counter words x0, x1 (arrays of
    values below 2^32) under the key (k0, k1); `rotl(v, r)` rotates a word
    left by r bits.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _rotl_np(v, r):
    return ((v << np.uint64(r)) | (v >> np.uint64(32 - r))) & np.uint64(MASK)


def _rotl_torch(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK


def hash_np(key, x0, x1):
    """Threefry-2x32 of uint32 counter arrays x0, x1 (numpy, uint32 out)."""
    k0, k1 = (int(w) for w in key)
    y0, y1 = _hash(np.uint64(k0), np.uint64(k1), np.asarray(x0, np.uint64),
                   np.asarray(x1, np.uint64), _rotl_np)
    return y0.astype(np.uint32), y1.astype(np.uint32)


def _counters_np(count: int):
    i = np.arange(count, dtype=np.uint64)
    return i >> np.uint64(32), i & np.uint64(MASK)


def split_np(key, num: int = 2) -> list:
    """jax.random.split(key, num) as a list of (k0, k1) int pairs."""
    y0, y1 = hash_np(key, *_counters_np(num))
    return [(int(a), int(b)) for a, b in zip(y0, y1)]


def bits32_np(key, shape) -> np.ndarray:
    """jax.random.bits(key, shape, uint32)."""
    count = int(np.prod(shape)) if len(shape) else 1
    y0, y1 = hash_np(key, *_counters_np(count))
    return (y0 ^ y1).reshape(shape)


def hash_torch(key, x0, x1):
    """Threefry-2x32 of int64 counter tensors holding 32-bit words."""
    k0, k1 = (int(w) for w in key)
    return _hash(k0, k1, x0, x1, _rotl_torch)


def split_torch(key, num: int, device) -> torch.Tensor:
    """jax.random.split(key, num) by plain int64 torch passes: (num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=device)
    return torch.stack(hash_torch(key, i >> 32, i & MASK), dim=1)


def _count(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _words_plain(key, start: int, count: int, device) -> torch.Tensor:
    """The words start .. start + count - 1 of a jax.random.bits draw under
    `key` (int64 values below 2^32), by int64 torch passes on `device`."""
    i = torch.arange(start, start + count, dtype=torch.int64, device=device)
    y0, y1 = hash_torch(key, i >> 32, i & MASK)
    return y0 ^ y1


def bits32_plain(key, shape, device) -> torch.Tensor:
    """The plain version of K7's raw-words mode: the words of
    jax.random.bits(key, shape, uint32) as an int32 tensor with their bits,
    by int64 torch passes on `device`."""
    w = _words_plain(key, 0, _count(shape), device).reshape(tuple(shape))
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def bits32_cuda(key, shape, device) -> torch.Tensor:
    """Launch K7's raw-words mode: bits32_plain's words on the card, a few
    words a thread, an int32 tensor with their bits."""
    from .. import kernels
    count = _count(shape)
    if count >= 1 << 31:
        raise ValueError("K7 counts the words of one draw in 31 bits")
    out = torch.empty(tuple(shape), dtype=torch.int32, device=_cuda_device(device))
    if count == 0:
        return out
    err = kernels.library().hf_threefry_bits(out.data_ptr(), int(key[0]), int(key[1]), count,
                                             kernels.stream_of(out))
    kernels.check(err, "threefry_bits")
    kernels.launches["threefry_bits"] += 1
    return out


def bits32(key, shape, device) -> torch.Tensor:
    """jax.random.bits(key, shape, uint32) as int32 words: K7 on a CUDA
    device, its plain version on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return bits32_cuda(key, shape, dev)
    if dev.type != "cpu":
        raise ValueError(f"no Threefry kernel for tensors on {dev}")
    return bits32_plain(key, shape, dev)


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# jax.random's transforms of the words: fold_in, randint (int32), uniform
# (float32), normal and permutation, as jax.random computes them under x64 off
# ---------------------------------------------------------------------------

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def fold_in_np(key, data: int) -> tuple:
    """jax.random.fold_in(key, data): Threefry of the counter words
    (0, data mod 2^32), the two output words the new key."""
    y0, y1 = hash_np(key, [0], [int(data) & MASK])
    return int(y0[0]), int(y1[0])


def _randint_span(lo: int, hi: int):
    """(lo, span, multiplier) of jax.random.randint for int32 bounds: both
    clipped to int32; span = (hi - lo) mod 2^32, 1 when hi <= lo, one more
    (mod 2^32) when hi was above int32; multiplier = (2^16 mod span)^2 mod
    2^32 mod span, which is 0 for every span above 2^16.  A span of 0 leaves
    the remainders unreduced, as XLA's unsigned remainder by zero does."""
    out_of_range = hi > I32_MAX
    lo, hi = min(max(lo, I32_MIN), I32_MAX), min(max(hi, I32_MIN), I32_MAX)
    span = 1 if hi <= lo else (hi - lo) & MASK
    if out_of_range and hi > lo:
        span = (span + 1) & MASK
    rem = lambda a: a % span if span else a
    mult = rem((rem(1 << 16) ** 2) & MASK)
    return lo, span, mult


def randint(key, shape, lo: int, hi: int, device) -> torch.Tensor:
    """jax.random.randint(key, shape, lo, hi, int32): the key split in two,
    32 bits of each per element (the higher and the lower), the offset
    ((higher mod span)·multiplier + lower mod span) mod 2^32 mod span, added
    to lo in int32 (wrapping).  Two K7 launches on the card."""
    k1, k2 = split_np(key, 2)
    higher = (bits32(k1, shape, device).to(torch.int64) & MASK)
    lower = (bits32(k2, shape, device).to(torch.int64) & MASK)
    lo, span, mult = _randint_span(int(lo), int(hi))
    if span:
        higher, lower = torch.remainder(higher, span), torch.remainder(lower, span)
    off = (higher * mult + lower) & MASK      # each term below 2^32: no int64 overflow
    if span:
        off = torch.remainder(off, span)
    v = (off + lo) & MASK
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def uniform_f32(words, minval: float, maxval: float) -> torch.Tensor:
    """jax.random.uniform's float32 transform of the words: the top 23 bits
    as the mantissa of a float in [1, 2), minus 1, times (maxval - minval),
    plus minval, then at least minval; every step in float32."""
    w = words.to(torch.int64) & MASK
    f = ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - _f32(1.0, w.device)
    lo, hi = _f32(minval, w.device), _f32(maxval, w.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


# XLA's ErfInv32 (M. Giles, "Approximating the erfinv function"): a degree-8
# polynomial in w - 2.5 where w = -log1p(-x^2) < 5, in sqrt(w) - 3 elsewhere
ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x) -> torch.Tensor:
    """lax.erf_inv on float32 as XLA computes it (ErfInv32), each step in
    float32 but log1p and sqrt, which are taken in float64 and rounded to
    float32.  torch's float32 versions are not the same function on the card
    and on the CPU: their log1p differ in the last place, and the CPU's sqrt
    is not correctly rounded (1 ulp off in about 0.7% of words; the card's,
    numpy's and XLA's are).  A float64 sqrt rounded to float32 is the
    correctly rounded float32 sqrt.  The two float64 log1p may still differ
    in their last bit, which changes the float32 word only where it lies
    within one float64 ulp of a float32 rounding midpoint: about 2^-28 of
    the words, so the card and the CPU may differ by an ulp there."""
    dev = x.device
    f64 = lambda v: v.to(torch.float64)
    w = -torch.log1p(f64(x * -x)).to(torch.float32)
    lt = w < _f32(5.0, dev)
    w = torch.where(lt, w - _f32(2.5, dev), torch.sqrt(f64(w)).to(torch.float32) - _f32(3.0, dev))
    p = torch.where(lt, _f32(ERFINV_W_LT_5[0], dev), _f32(ERFINV_W_GE_5[0], dev))
    for a, b in zip(ERFINV_W_LT_5[1:], ERFINV_W_GE_5[1:]):
        p = torch.where(lt, _f32(a, dev), _f32(b, dev)) + p * w
    return torch.where(x.abs() == _f32(1.0, dev), x * _f32(float("inf"), dev), p * x)


NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key, shape, device) -> torch.Tensor:
    """jax.random.normal(key, shape, float32): sqrt(2)·erf_inv(u) of the
    uniform u in (-1, 1) from the key's words.  One K7 launch on the card."""
    u = uniform_f32(bits32(key, shape, device), NORMAL_LO, 1.0)
    return _f32(float(np.float32(np.sqrt(2))), u.device) * erf_inv(u)


def permutation_rounds(n: int) -> int:
    """jax.random.permutation's sort rounds for n elements:
    ceil(3·ln(max(1, n)) / ln(2^32 - 1)), in float64 as numpy computes it."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))


def permutation(key, n: int, device) -> torch.Tensor:
    """jax.random.permutation(key, n) (int64 indices): each round splits the
    key into (key, sub), draws 32-bit sort keys from sub and sorts the
    indices stably by them.  One K7 launch a round on the card."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(permutation_rounds(n)):
        key, sub = split_np(key, 2)
        sort_keys = bits32(sub, (n,), device).to(torch.int64) & MASK
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x


def _draw_dims(shape) -> tuple:
    """(d, n) of a draw shape: (n,) is one row, (d, ...) d rows of the rest."""
    if len(shape) == 1:
        return 1, int(shape[0])
    return int(shape[0]), int(np.prod(shape[1:]))


def _row_range(rows, L: int) -> tuple:
    """(first limb, limb count) of a draw's row range over L limbs: all of
    them when rows is None."""
    lb, lc = (0, L) if rows is None else (int(rows[0]), int(rows[1]))
    if lb < 0 or lc <= 0 or lb + lc > L:
        raise ValueError(f"rows {(lb, lc)} outside a draw of {L} limbs")
    return lb, lc


def uniform_rns_plain(key, primes, shape, device, moved: bool = False, mont: bool = False,
                      rows=None):
    """The plain version of K7: rng.uniform_rns(key, primes, shape) by int64
    torch passes on `device`: the key split into (hi, lo) keys, 32 bits of
    each per element of the draw layout (L,) + shape, (hi·2^32 + lo) mod p_l.
    moved=True returns a (d, n) draw with its limb axis moved behind the
    digit axis, (d, L, n), as the JAX package's `jnp.moveaxis(…, 0, 1)` gives
    it; mont=True multiplies by 2^32 mod p_l (Montgomery form).
    rows=(l_begin, l_count) gives only the limbs [l_begin, l_begin + l_count)
    of the whole draw over `primes`, hashing only their counters: the same
    rows as the whole draw's, L = l_count in the output.  int32 residues."""
    from ..ops import modmath as mm
    lb, lc = _row_range(rows, len(primes))
    k_hi, k_lo = split_np(key, 2)
    per_limb = _count(shape)
    out_shape = (lc,) + tuple(shape)
    hi, lo = (_words_plain(k, lb * per_limb, lc * per_limb, device).reshape(out_shape)
              for k in (k_hi, k_lo))
    p = torch.tensor([int(q) for q in primes[lb:lb + lc]], dtype=torch.int64,
                     device=device).reshape((-1,) + (1,) * len(shape))
    out = mm.reduce64(hi, lo, p)
    if mont:
        out = mm.to_mont(out, p, torch.remainder(torch.full_like(p, 1 << 32), p))
    return out.transpose(0, 1).contiguous() if moved else out


@functools.lru_cache(maxsize=None)
def _k7_table(primes: tuple, device: str) -> torch.Tensor:
    """K7's per-limb words (p, floor(2^32/p), 2^32 mod p, its Shoup
    companion), built once per prime list and device."""
    from ..ops import modmath as mm
    rows = [(q, mm.barrett_mu(q), mm.mont_r1(q), mm.shoup(mm.mont_r1(q), q)) for q in primes]
    return mm.u32_to_i32(np.array(rows, np.uint32)).to(device)


def uniform_rns_cuda(key, primes, shape, device, moved: bool = False, mont: bool = False,
                     rows=None):
    """Launch K7: uniform_rns_plain's function on the card, a few words a
    thread, written straight into the output layout; with rows=(l_begin,
    l_count) one launch over those limbs of the whole draw only."""
    from .. import kernels
    from ..ops import modmath as mm
    if moved and len(shape) != 2:
        raise ValueError(f"moved=True takes a (d, n) draw, not {tuple(shape)}")
    primes = tuple(int(q) for q in primes)
    if max(primes) >= 1 << 30:
        raise ValueError("K7 takes primes below 2^30")
    L, (d, n) = len(primes), _draw_dims(shape)
    if L * d * n >= 1 << 32:
        raise ValueError("K7 counts the elements of one draw in 32 bits")
    lb, lc = _row_range(rows, L)
    dev = _cuda_device(device)
    tab = _k7_table(primes, str(dev))
    k_hi, k_lo = split_np(key, 2)
    out_shape = (d, lc, n) if moved else (lc,) + tuple(shape)
    out = torch.empty(out_shape, dtype=mm.I32, device=dev)
    err = kernels.library().hf_threefry_uniform(
        out.data_ptr(), tab.data_ptr(), k_hi[0], k_hi[1], k_lo[0], k_lo[1], L, lb, lc, d, n,
        int(moved), int(mont), kernels.stream_of(out))
    kernels.check(err, "threefry_uniform")
    kernels.launches["threefry_uniform"] += 1
    return out


def uniform_rns(key, primes, shape, device, moved: bool = False, mont: bool = False,
                rows=None):
    """K7 on a CUDA device, its plain version on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return uniform_rns_cuda(key, primes, shape, dev, moved, mont, rows)
    if dev.type != "cpu":
        raise ValueError(f"no Threefry kernel for tensors on {dev}")
    return uniform_rns_plain(key, primes, shape, dev, moved, mont, rows)
