"""NIST SP 800-90A CTR_DRBG (AES-128, no derivation function).

Verbatim copy of heongpu_tpu/utils/drbg.py (pure numpy, tied to no
framework): the port's DRBG-seeded samplers draw the same bytes in the same
order as the reference's, so keys and ciphertexts from one DRBG seed are
bit-identical across the two packages.
"""

from __future__ import annotations

import os

import numpy as np

# ---------------------------------------------------------------------------
# AES-128 block cipher (encrypt only; table-free, byte-sliced numpy)
# ---------------------------------------------------------------------------

def _build_sbox() -> np.ndarray:
    """FIPS-197 S-box built from GF(2^8) inversion + affine map."""
    # GF(2^8) exp/log tables over generator 3
    exp = np.zeros(512, np.uint8)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        # multiply by 3 = x * 2 ^ x
        x2 = ((x << 1) ^ (0x11B if x & 0x80 else 0)) & 0xFF
        x = x2 ^ x
    exp[255:510] = exp[:255]
    sbox = np.zeros(256, np.uint8)
    for b in range(256):
        inv = 0 if b == 0 else exp[255 - log[b]]
        s = inv
        for _ in range(4):
            inv = ((inv << 1) | (inv >> 7)) & 0xFF
            s ^= inv
        sbox[b] = s ^ 0x63
    return sbox


_SBOX = _build_sbox()
_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36],
                 np.uint8)


def _xtime(a: np.ndarray) -> np.ndarray:
    return (((a.astype(np.uint16) << 1) ^
             np.where(a & 0x80, 0x11B, 0)) & 0xFF).astype(np.uint8)


def _expand_key(key16: bytes) -> np.ndarray:
    """11 round keys, each 16 bytes (AES-128 key schedule)."""
    w = [np.frombuffer(key16, np.uint8)[i * 4:(i + 1) * 4].copy()
         for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1].copy()
        if i % 4 == 0:
            t = np.roll(t, -1)
            t = _SBOX[t]
            t[0] ^= _RCON[i // 4 - 1]
        w.append(w[i - 4] ^ t)
    return np.concatenate(w).reshape(11, 16)


def aes128_encrypt_blocks(key16: bytes, blocks: np.ndarray) -> np.ndarray:
    """Encrypt (n, 16) uint8 blocks under one AES-128 key, vectorized over n."""
    rk = _expand_key(key16)
    s = blocks.reshape(-1, 4, 4) ^ rk[0].reshape(4, 4)  # row = word (column-major state)
    for rnd in range(1, 11):
        s = _SBOX[s]                                     # SubBytes
        # ShiftRows on the column-major state: byte index b of word c comes
        # from word (c + b) mod 4
        s = np.stack([np.stack([s[:, (c + b) % 4, b] for b in range(4)], -1)
                      for c in range(4)], 1)
        if rnd < 10:                                     # MixColumns
            a = s
            t = a[:, :, 0] ^ a[:, :, 1] ^ a[:, :, 2] ^ a[:, :, 3]
            out = np.empty_like(a)
            for b in range(4):
                out[:, :, b] = (a[:, :, b] ^ t ^
                                _xtime(a[:, :, b] ^ a[:, :, (b + 1) % 4]))
            s = out
        s = s ^ rk[rnd].reshape(4, 4)                    # AddRoundKey
    return s.reshape(-1, 16)


# ---------------------------------------------------------------------------
# CTR_DRBG (SP 800-90A §10.2.1, AES-128, no df): seedlen = 256 bits
# ---------------------------------------------------------------------------

_SEEDLEN = 32   # bytes: keylen(16) + blocklen(16)
_RESEED_INTERVAL = 1 << 48


class CtrDrbg:
    """CTR_DRBG(AES-128, no derivation function).

    entropy inputs must be exactly 32 bytes (seedlen), as in the reference's
    RNGSeed(key_, nonce_, personalization_string_) path seeded from OpenSSL
    RAND_bytes."""

    def __init__(self, entropy: bytes | None = None,
                 personalization: bytes = b""):
        if entropy is None:
            entropy = os.urandom(_SEEDLEN)
        if len(entropy) != _SEEDLEN:
            raise ValueError(f"entropy must be {_SEEDLEN} bytes (no-df DRBG)")
        if len(personalization) > _SEEDLEN:
            raise ValueError("personalization string too long")
        seed = bytes(a ^ b for a, b in
                     zip(entropy, personalization.ljust(_SEEDLEN, b"\0")))
        self._key = b"\x00" * 16
        self._v = np.zeros(16, np.uint8)
        self._update(seed)
        self._reseed_counter = 1

    # -- internals --
    def _inc_v(self) -> None:
        v = self._v
        for i in range(15, -1, -1):
            v[i] = (int(v[i]) + 1) & 0xFF
            if v[i]:
                break

    def _raw_blocks(self, nblocks: int) -> np.ndarray:
        ctrs = np.empty((nblocks, 16), np.uint8)
        for i in range(nblocks):
            self._inc_v()
            ctrs[i] = self._v
        return aes128_encrypt_blocks(self._key, ctrs)

    def _update(self, provided: bytes) -> None:
        assert len(provided) == _SEEDLEN
        temp = self._raw_blocks(2).reshape(-1)[:_SEEDLEN]
        temp = temp ^ np.frombuffer(provided, np.uint8)
        self._key = temp[:16].tobytes()
        self._v = temp[16:].copy()

    # -- SP 800-90A interface --
    def reseed(self, entropy: bytes, additional: bytes = b"") -> None:
        if len(entropy) != _SEEDLEN:
            raise ValueError(f"entropy must be {_SEEDLEN} bytes")
        if len(additional) > _SEEDLEN:
            raise ValueError("additional input too long")
        seed = bytes(a ^ b for a, b in
                     zip(entropy, additional.ljust(_SEEDLEN, b"\0")))
        self._update(seed)
        self._reseed_counter = 1

    def generate(self, nbytes: int, additional: bytes = b"") -> bytes:
        if self._reseed_counter > _RESEED_INTERVAL:
            raise RuntimeError("reseed required")
        if additional:
            additional = additional.ljust(_SEEDLEN, b"\0")
            self._update(additional)
        else:
            additional = b"\x00" * _SEEDLEN
        nblocks = (nbytes + 15) // 16
        out = self._raw_blocks(nblocks).reshape(-1)[:nbytes].tobytes()
        self._update(additional)
        self._reseed_counter += 1
        return out

    # -- numpy conveniences for the rng facade --
    def bits32(self, count: int) -> np.ndarray:
        return np.frombuffer(self.generate(4 * count), np.uint32).copy()

    def bits64(self, count: int) -> np.ndarray:
        return np.frombuffer(self.generate(8 * count), np.uint64).copy()
