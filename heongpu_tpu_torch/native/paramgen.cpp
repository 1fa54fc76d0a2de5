// Native parameter engine: prime search, primitive roots, power-series
// twiddle tables, Shoup precomputations (a copy of the JAX package's
// heongpu_tpu/native/paramgen.cpp for the PyTorch port).
//
// The counterpart of the reference library's host-side native code (HEonGPU
// src/lib/util/util.cu prime and NTT-table generation): context generation
// is latency-bound host work, done here in C++ and reached through ctypes
// (heongpu_tpu_torch/utils/native.py), with a pure-Python path beside it.
//
// All routines are bit for bit equal to utils/nt.py and to the table code of
// ops/ntt.py: contexts built on either path are the same.

#include <cstdint>
#include <cstring>

using u32 = uint32_t;
using u64 = uint64_t;
using u128 = unsigned __int128;

extern "C" {

static inline u64 mulmod(u64 a, u64 b, u64 m) {
    return (u64)(((u128)a * b) % m);
}

static u64 powmod(u64 a, u64 e, u64 m) {
    u64 r = 1 % m;
    a %= m;
    while (e) {
        if (e & 1) r = mulmod(r, a, m);
        a = mulmod(a, a, m);
        e >>= 1;
    }
    return r;
}

// Deterministic Miller-Rabin for n < 3.3e24 (same witness set as nt.py).
int pg_is_prime(u64 n) {
    static const u64 small[] = {2,3,5,7,11,13,17,19,23,29,31,37};
    if (n < 2) return 0;
    for (u64 p : small) {
        if (n % p == 0) return n == p;
    }
    u64 d = n - 1;
    int r = 0;
    while ((d & 1) == 0) { d >>= 1; ++r; }
    for (u64 a : small) {
        u64 x = powmod(a, d, n);
        if (x == 1 || x == n - 1) continue;
        int ok = 0;
        for (int i = 0; i < r - 1; ++i) {
            x = mulmod(x, x, n);
            if (x == n - 1) { ok = 1; break; }
        }
        if (!ok) return 0;
    }
    return 1;
}

// Primes p ≡ 1 (mod 2n), p < 2^bit_size, descending (nt.generate_ntt_primes).
// exclude: sorted-free list of length n_excl.  Returns #found (≤ count).
int pg_generate_ntt_primes(u32 bit_size, u32 count, u64 n,
                           const u64* exclude, u32 n_excl, u64* out) {
    u64 m = 2 * n;
    u64 c = ((u64)1 << bit_size) - 1;
    c -= (c - 1) % m;
    u32 found = 0;
    u64 floor = (u64)1 << (bit_size - 1);
    while (found < count && c > floor) {
        int skip = 0;
        for (u32 i = 0; i < n_excl; ++i)
            if (exclude[i] == c) { skip = 1; break; }
        if (!skip && pg_is_prime(c)) out[found++] = c;
        c -= m;
    }
    return (int)found;
}

static void factorize(u64 n, u64* fs, int* nf) {
    *nf = 0;
    for (u64 d = 2; d * d <= n; ++d) {
        if (n % d == 0) {
            fs[(*nf)++] = d;
            while (n % d == 0) n /= d;
        }
    }
    if (n > 1) fs[(*nf)++] = n;
}

u64 pg_primitive_root(u64 p) {
    u64 phi = p - 1, fs[64];
    int nf;
    factorize(phi, fs, &nf);
    for (u64 g = 2;; ++g) {
        int ok = 1;
        for (int i = 0; i < nf; ++i)
            if (powmod(g, phi / fs[i], p) == 1) { ok = 0; break; }
        if (ok) return g;
    }
}

// Smallest primitive 2n-th root among the first few odd powers
// (nt.minimal_primitive_root_2n, identical scan).
u64 pg_minimal_primitive_root_2n(u64 n2, u64 p) {
    u64 g = pg_primitive_root(p);
    u64 w = powmod(g, (p - 1) / n2, p);
    u64 best = w, x = w;
    u64 w2 = mulmod(w, w, p);
    u64 kmax = n2 < 512 ? n2 : 512;
    for (u64 k = 3; k < kmax; k += 2) {
        x = mulmod(x, w2, p);
        if (powmod(x, n2 / 2, p) == p - 1 && x < best) best = x;
    }
    return best;
}

// out[i] = base^i mod p for i < n (uint32 out; p < 2^31).
void pg_pow_series(u64 base, u64 n, u64 p, u32* out) {
    u64 x = 1 % p;
    base %= p;
    for (u64 i = 0; i < n; ++i) {
        out[i] = (u32)x;
        x = mulmod(x, base, p);
    }
}

// Shoup companions: sh[i] = floor(w[i] * 2^32 / p).
void pg_shoup(const u32* w, u64 n, u64 p, u32* out) {
    for (u64 i = 0; i < n; ++i)
        out[i] = (u32)(((u64)w[i] << 32) / p);
}

// Fused per-limb core tables: psi powers + shoup, ipsi_n (= psi^-i * n^-1)
// + shoup.  Plays generate_ntt_table/generate_intt_table (util.cu).
void pg_psi_tables(u64 psi, u64 n, u64 p,
                   u32* psi_pows, u32* psi_sh, u32* ipsi_n, u32* ipsi_sh) {
    pg_pow_series(psi, n, p, psi_pows);
    pg_shoup(psi_pows, n, p, psi_sh);
    u64 ipsi = powmod(psi, p - 2, p);
    u64 ninv = powmod(n % p, p - 2, p);
    u64 x = ninv;
    for (u64 i = 0; i < n; ++i) {
        ipsi_n[i] = (u32)x;
        x = mulmod(x, ipsi, p);
    }
    pg_shoup(ipsi_n, n, p, ipsi_sh);
}

}  // extern "C"
