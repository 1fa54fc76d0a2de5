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

Each comes as a numpy host version (`*_np`) and a plain int64 torch version;
`uniform_rns_plain` is the plain version of K7's function and
`uniform_rns_cuda` launches K7.
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


def bits32(key, shape, device) -> torch.Tensor:
    """jax.random.bits(key, shape, uint32) as int64 values in [0, 2^32), by
    plain int64 torch passes on `device`."""
    count = int(np.prod(shape)) if len(shape) else 1
    i = torch.arange(count, dtype=torch.int64, device=device)
    y0, y1 = hash_torch(key, i >> 32, i & MASK)
    return (y0 ^ y1).reshape(tuple(shape))


def _draw_dims(shape) -> tuple:
    """(d, n) of a draw shape: (n,) is one row, (d, ...) d rows of the rest."""
    if len(shape) == 1:
        return 1, int(shape[0])
    return int(shape[0]), int(np.prod(shape[1:]))


def uniform_rns_plain(key, primes, shape, device, moved: bool = False, mont: bool = False):
    """The plain version of K7: rng.uniform_rns(key, primes, shape) by int64
    torch passes on `device`: the key split into (hi, lo) keys, 32 bits of
    each per element of the draw layout (L,) + shape, (hi·2^32 + lo) mod p_l.
    moved=True returns a (d, n) draw with its limb axis moved behind the
    digit axis, (d, L, n), as the JAX package's `jnp.moveaxis(…, 0, 1)` gives
    it; mont=True multiplies by 2^32 mod p_l (Montgomery form).  int32
    residues."""
    from ..ops import modmath as mm
    k_hi, k_lo = split_np(key, 2)
    full = (len(primes),) + tuple(shape)
    hi, lo = bits32(k_hi, full, device), bits32(k_lo, full, device)
    p = torch.tensor([int(q) for q in primes], dtype=torch.int64,
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


def uniform_rns_cuda(key, primes, shape, device, moved: bool = False, mont: bool = False):
    """Launch K7: uniform_rns_plain's function on the card, one thread per
    output word, written straight into the output layout."""
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
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    tab = _k7_table(primes, str(dev))
    k_hi, k_lo = split_np(key, 2)
    out_shape = (d, L, n) if moved else (L,) + tuple(shape)
    out = torch.empty(out_shape, dtype=mm.I32, device=dev)
    err = kernels.library().hf_threefry_uniform(
        out.data_ptr(), tab.data_ptr(), k_hi[0], k_hi[1], k_lo[0], k_lo[1], L, d, n,
        int(moved), int(mont), kernels.stream_of(out))
    kernels.check(err, "threefry_uniform")
    kernels.launches["threefry_uniform"] += 1
    return out


def uniform_rns(key, primes, shape, device, moved: bool = False, mont: bool = False):
    """K7 on a CUDA device, its plain version on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return uniform_rns_cuda(key, primes, shape, dev, moved, mont)
    if dev.type != "cpu":
        raise ValueError(f"no Threefry kernel for tensors on {dev}")
    return uniform_rns_plain(key, primes, shape, dev, moved, mont)
