"""Sampling facade: uniform / gaussian / ternary draws directly into RNS form
(port of heongpu_tpu/utils/rng.py).

Three sources behind one facade; every sampler takes any of them as `key`:

  * a `ThreefryKey` (`new_key(seed)`): the reference's JAX Threefry key,
    bit for bit (utils/threefry.py): every draw of this facade gives the
    reference's numbers from it (`normal` within float32 rounding, and the
    gaussian integers of `gaussian_rns` equal).  On the card a uniform RNS
    draw is one K7 launch in its uniform mode, and every other draw starts
    from K7's raw-words mode (`bits32` one launch, `normal` one, `randint`
    two, `permutation` one a sort round); the integer and float transforms
    after the words are torch passes.  It is the source of seed-expanded
    keys (`a_seed`) and of MPC's common reference strings;

  * a `CtrDrbg` (utils/drbg.py, NIST SP 800-90A AES-CTR): bytes drawn on the
    host in the reference's order and transformed as the reference does, so
    keys and ciphertexts from one DRBG seed are bit-identical to the JAX
    package's;
  * a `torch.Generator` (`new_generator`): the port's counterpart of the
    reference's default Threefry keys, drawing on the generator's device —
    the source for full-width runs on the card.  It gives other numbers than
    Threefry from the same seed.

The DRBG and the generator are streams: `split` hands back the same
source, and successive draws continue it.  A ThreefryKey splits as
jax.random.split does.  Samplers return int32 residues of shape (L,) + shape
on `device`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from ..ops import modmath as mm
from . import drbg as _drbg
from . import threefry

ERROR_STD_DEV = 3.2  # sigma of the centered discrete gaussian
GAUSS_TAIL = 6       # truncate at 6 sigma

CtrDrbg = _drbg.CtrDrbg


@dataclasses.dataclass(frozen=True)
class ThreefryKey:
    """A jax.random Threefry key: its two 32-bit words, and the device its
    draws go to."""
    words: tuple
    device: torch.device


def new_key(seed: int | None = None, device="cuda") -> ThreefryKey:
    """jax.random.PRNGKey(seed) (the words (0, seed mod 2^32)), drawing on
    `device` (the card unless the caller asks for the CPU); seeded from OS
    entropy when no seed is given."""
    if seed is None:
        seed = int.from_bytes(os.urandom(8), "little") >> 1
    return ThreefryKey(threefry.key_from_seed(seed), torch.device(device))


def is_threefry(key) -> bool:
    return isinstance(key, ThreefryKey)


def new_generator(seed: int, device="cuda") -> torch.Generator:
    """A seeded torch.Generator on `device` (the card unless the caller asks
    for the CPU)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def new_drbg(entropy: bytes | None = None,
             personalization: bytes = b"") -> _drbg.CtrDrbg:
    """AES-CTR DRBG source (see utils/drbg.py)."""
    return _drbg.CtrDrbg(entropy, personalization)


def is_drbg(key) -> bool:
    return isinstance(key, _drbg.CtrDrbg)


def split(key, num: int = 2):
    """A ThreefryKey splits as jax.random.split does; the streams hand back
    the source itself as every sub-key."""
    if is_threefry(key):
        return tuple(ThreefryKey(w, key.device) for w in threefry.split_np(key.words, num))
    return (key,) * num


def fold_in(key, data: int):
    """A sub-source for `data`.  A ThreefryKey folds `data` in as
    jax.random.fold_in does.  A DRBG passes through unchanged, as in the
    reference, so a DRBG key set is drawn in the reference's order.  A
    torch.Generator gives a new generator on its device, seeded from a hash
    of its current state and `data`; the parent's state does not move."""
    if is_threefry(key):
        return ThreefryKey(threefry.fold_in_np(key.words, data), key.device)
    if is_drbg(key):
        return key
    state = key.get_state().cpu().numpy().tobytes()
    digest = hashlib.sha256(state + int(data).to_bytes(8, "little", signed=True)).digest()
    return new_generator(int.from_bytes(digest[:8], "little") >> 1, key.device)


def _numel(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _gen_device(key, device):
    """The device of a generator's or a Threefry key's draws, which must be
    the one asked for."""
    d, g = torch.device(device), key.device
    if d.type != g.type or (None not in (d.index, g.index) and d.index != g.index):
        raise ValueError(f"generator on {key.device}, draws wanted on {device}")
    return key.device


def bits32(key, shape, device) -> torch.Tensor:
    """Raw uniform 32-bit words as int64 values in [0, 2^32)."""
    if is_drbg(key):
        w = key.bits32(_numel(shape)).astype(np.int64).reshape(shape)
        return torch.from_numpy(w).to(device)
    if is_threefry(key):
        return mm.as_u32(threefry.bits32(key.words, shape, _gen_device(key, device)))
    return torch.randint(0, 1 << 32, tuple(shape), generator=key,
                         device=_gen_device(key, device), dtype=mm.I64)


def randint(key, shape, lo: int, hi: int, device) -> torch.Tensor:
    """Uniform integers in [lo, hi) as int32."""
    if is_threefry(key):
        return threefry.randint(key.words, shape, lo, hi, _gen_device(key, device))
    if is_drbg(key):
        u = key.bits64(_numel(shape))
        v = (lo + (u % (hi - lo))).astype(np.int64).reshape(shape)
        return torch.from_numpy(v).to(device=device, dtype=mm.I32)
    return torch.randint(lo, hi, tuple(shape), generator=key,
                         device=_gen_device(key, device), dtype=mm.I32)


def normal(key, shape, device) -> torch.Tensor:
    """Standard normal draws as float32."""
    if is_threefry(key):
        return threefry.normal(key.words, shape, _gen_device(key, device))
    if is_drbg(key):
        n = _numel(shape)
        # Box-Muller over DRBG uniforms in (0, 1], float64 then float32
        u1 = (key.bits64(n).astype(np.float64) + 1.0) / 2.0 ** 64
        u2 = key.bits64(n).astype(np.float64) / 2.0 ** 64
        g = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
        return torch.from_numpy(g.reshape(shape)).to(device=device, dtype=torch.float32)
    return torch.randn(tuple(shape), generator=key,
                       device=_gen_device(key, device), dtype=torch.float32)


def permutation(key, n: int, device) -> torch.Tensor:
    if is_threefry(key):
        return threefry.permutation(key.words, n, _gen_device(key, device))
    if is_drbg(key):
        return torch.from_numpy(np.argsort(key.bits64(n)).astype(np.int64)).to(device)
    return torch.randperm(n, generator=key, device=_gen_device(key, device))


def _primes_col(primes, ndim: int, device):
    return torch.tensor([int(q) for q in primes], dtype=mm.I64,
                        device=device).reshape((-1,) + (1,) * ndim)


def uniform_rns(key, primes, shape, device) -> torch.Tensor:
    """Uniform in [0, p) independently per limb, from 64 random bits per
    element (bias < 2^-34); output (L,) + shape.  Over a ThreefryKey: the
    reference's bits, one K7 launch on the card."""
    if is_threefry(key):
        return threefry.uniform_rns(key.words, primes, shape, _gen_device(key, device))
    full = (len(primes),) + tuple(shape)
    k_hi, k_lo = split(key)
    hi = bits32(k_hi, full, device)
    lo = bits32(k_lo, full, device)
    return mm.reduce64(hi, lo, _primes_col(primes, len(shape), device))


def signed_to_rns(e, primes) -> torch.Tensor:
    """Lift signed integers to (L,) + e.shape residues."""
    return torch.remainder(e.to(mm.I64)[None],
                           _primes_col(primes, e.ndim, e.device)).to(mm.I32)


def gaussian_rns(key, primes, shape, device, sigma: float = ERROR_STD_DEV,
                 noise_scale: int = 1) -> torch.Tensor:
    """Centered discrete gaussian (sigma=3.2, cut at 6 sigma), the same noise
    on every limb.  Scale and rounding in float32 as the reference does."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    g = normal(key, tuple(shape), device) * f32(sigma)
    tail = f32(GAUSS_TAIL * sigma)
    e = torch.clamp(torch.round(g), -tail, tail).to(mm.I32)
    if noise_scale != 1:
        e = e * noise_scale
    return signed_to_rns(e, primes)


def ternary_rns(key, primes, shape, device) -> torch.Tensor:
    """Uniform ternary {-1, 0, 1}, lifted to every limb."""
    return signed_to_rns(randint(key, tuple(shape), 0, 3, device) - 1, primes)


def ternary_hw(key, n: int, hamming_weight: int, device) -> torch.Tensor:
    """Ternary secret with fixed hamming weight, int32 in {-1, 0, 1}."""
    k_pos, k_sign = split(key)
    perm = permutation(k_pos, n, device)
    signs = randint(k_sign, (n,), 0, 2, device) * 2 - 1
    mask = torch.zeros(n, dtype=mm.I32, device=device)
    mask[perm[:hamming_weight]] = 1
    return mask * signs
