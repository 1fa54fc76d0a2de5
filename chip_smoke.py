#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (heongpu_tpu_torch) on one GPU.

Drives the CKKS main path once at full width — N=2^16, twelve 29-bit Q
primes, Method-II keyswitching with alpha=4 (four 30-bit special primes, a
16-limb QP basis, 3 digits) — through the port's public entry points:
keygen, encode, encrypt, a chain of K=10 multiply -> relinearize, and one
multiply -> relinearize -> rescale -> decrypt -> decode checked against
z·z[::-1].

Phases (each raises on failure, so the script exits non-zero):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from heongpu_tpu_torch/kernels/csrc;
  3. K1 (NTT) against its plain torch version on the card, bit for bit,
     forward and inverse, N in {2^11, 2^12, 2^15, 2^16};
  4. K2 (keyswitch MAC, base conversion) against the plain version;
  5. the main path, with launch counts reset just before it and read just
     after; the residues of one multiply -> relinearize -> rescale must
     equal the CPU (plain path) run on copies of the same keys and inputs;
  6. timings with CUDA events: the K=10 chain as ops/s, and each kernel
     against its plain version at the main-path shapes.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py   (one CUDA device; no arguments)
"""

import json
import subprocess
import sys
import time

import numpy as np

N = 1 << 16
Q_BITS = [29] * 12
ALPHA = 4
K_CHAIN = 10
# Decode limit for z*z[::-1] at this shape.  The fresh-encryption noise sets
# the floor: per coefficient 3.2*sqrt(hw + 2N/3) ~ 885 (hw = N/2), per slot
# component 885*sqrt(N/2)/scale ~ 3.1e-4 at scale ~ 2^29, so the product of
# two fresh ciphertexts has a max error over the 2^15 slots near 2e-3.  The
# limit leaves 2.5x over that floor; exactness is held by the bit-identical
# comparison with the CPU plain path.
TOL_DECODE = 5e-3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def rand_residues(primes, shape, gen, device):
    import torch
    p = torch.tensor(primes, dtype=torch.int64, device=device).view(-1, 1)
    x = torch.randint(0, 1 << 62, shape, generator=gen, device=device, dtype=torch.int64)
    return torch.remainder(x, p).to(torch.int32)


def max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "script runs the port on a CUDA GPU only")
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.kernels import build
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.ops import rns
    from heongpu_tpu_torch.utils import nt, rng

    dev = torch.device("cuda")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"card: {card}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    path, log = build.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {path.name}")
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print("  ptxas:", line.strip())

    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    errs = {"ntt_fwd": 0, "ntt_inv": 0, "mac_keys": 0, "base_conv": 0}

    def check_ntt(tb, rows, what):
        polys = rows // tb.num_limbs
        x = rand_residues(list(tb.primes) * polys, (rows, tb.n), gen, dev)
        x = x.view(polys, tb.num_limbs, tb.n)
        f = nttm.ntt_cuda(x, tb, inverse=False)
        e_f = max_err(f, nttm.ntt_fwd_plain(x, tb))
        i = nttm.ntt_cuda(f, tb, inverse=True)
        e_i = max(max_err(i, nttm.ntt_inv_plain(f, tb)), max_err(i, x))
        torch.cuda.synchronize()
        errs["ntt_fwd"] = max(errs["ntt_fwd"], e_f)
        errs["ntt_inv"] = max(errs["ntt_inv"], e_i)
        print(f"K1 ntt {what}: N={tb.n} rows={rows} limbs={tb.num_limbs} "
              f"fwd_err={e_f} inv_err={e_i}")
        if e_f or e_i:
            raise AssertionError(f"NTT kernel disagrees with the plain version ({what})")

    # -- 3. K1 against plain at small N ---------------------------------------
    for n in (1 << 11, 1 << 12, 1 << 15):
        tb = nttm.build_ntt_tables(nt.generate_ntt_primes(29, 4, n), n, device=dev)
        check_ntt(tb, 8, "small")

    # -- main-path context (the N=2^16 tables of phases 3-6) -----------------
    t0 = time.perf_counter()
    ctx = ckks.make_context(N, Q_BITS, ks_type="II", alpha=ALPHA, device=dev)
    print(f"context: N={N} q={len(ctx.q_primes)}x29b p={len(ctx.p_primes)}x30b "
          f"alpha={ALPHA} digits={len(ctx.ks2[0].groups)} "
          f"built in {time.perf_counter() - t0:.1f} s")
    check_ntt(ctx.ntt_q(0), 12, "12-limb Q table")
    check_ntt(ctx.ntt_q(0), 24, "12-limb Q table, 2 polys")
    check_ntt(ctx.ntt_qp, 16, "16-limb QP table")
    check_ntt(ctx.ntt_qp, 48, "16-limb QP table, 3 digits")
    check_ntt(ctx.ntt_qp_at(1), 30, "leveled concatenated 11+4-limb table")

    # -- 4. K2 against plain ----------------------------------------------------
    qp = list(ctx.qp_primes)
    d = rand_residues(qp * 3, (48, N), gen, dev).view(3, 16, N)
    k0 = rand_residues(qp * 3, (48, N), gen, dev).view(3, 16, N)
    k1 = rand_residues(qp * 3, (48, N), gen, dev).view(3, 16, N)
    got = rns.mac_keys_cuda(d, k0, k1, ctx.base_qp)
    want = torch.stack([rns.lazy_mac_mont(d, k0, ctx.base_qp),
                        rns.lazy_mac_mont(d, k1, ctx.base_qp)])
    errs["mac_keys"] = max_err(got, want)
    print(f"K2 mac_keys (3, 16, {N}): err={errs['mac_keys']}")
    conv_cases = [(ctx.ks2[0].convs[0], "4 -> 16"), (ctx.ks2[2].convs[2], "2 -> 14")]
    for conv, what in conv_cases:
        k_in = conv.mat_mont.shape[0]
        z = rand_residues([int(v) for v in conv.ibase.p.tolist()], (k_in, N), gen, dev)
        e = max_err(rns.base_conv_cuda(z, conv.mat_mont, conv.obase),
                    rns.lazy_mac_mont(z[:, None, :], conv.mat_mont[:, :, None], conv.obase))
        errs["base_conv"] = max(errs["base_conv"], e)
        print(f"K2 base_conv ({what}, {N}): err={e}")
    torch.cuda.synchronize()
    if errs["mac_keys"] or errs["base_conv"]:
        raise AssertionError("MAC kernels disagree with the plain version")

    # -- 5. the main path -------------------------------------------------------
    z = np.linspace(-1.0, 1.0, N // 2)
    kernels.reset_launches()
    t0 = time.perf_counter()
    g = rng.new_generator(1, dev)
    sk = ckks.keygen_secret(ctx, g)
    pk = ckks.keygen_public(ctx, g, sk)
    rk = ckks.keygen_relin(ctx, g, sk)
    ct1 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z), g)
    ct2 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z[::-1].copy()), g)
    out = ct1
    for _ in range(K_CHAIN):
        out = ckks.relinearize(ctx, ckks.multiply(ctx, out, ct2), rk)
        out = ckks.Ciphertext(out.c, 2, 0, ctx.default_scale)
    relin = ckks.relinearize(ctx, ckks.multiply(ctx, ct1, ct2), rk)
    res = ckks.rescale(ctx, relin)
    dec = ckks.decode(ctx, ckks.decrypt(ctx, sk, res))
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print(f"main path: {time.perf_counter() - t0:.1f} s, launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    if not np.isfinite(dec).all() or dec.shape != (N // 2,):
        raise AssertionError("decode gave non-finite values or the wrong shape")
    for t in (out.c, res.c):
        if int(t.min()) < 0 or int(t.max()) >= 1 << 30:
            raise AssertionError("residues out of range")
    dec_err = float(np.abs(dec - z * z[::-1]).max())
    fresh_err = float(np.abs(ckks.decode(ctx, ckks.decrypt(ctx, sk, ct1)) - z).max())
    print(f"decode max abs error vs z*z[::-1]: {dec_err:.3e} (limit {TOL_DECODE}); "
          f"fresh encrypt/decrypt of z: {fresh_err:.3e}")
    if not dec_err <= TOL_DECODE:
        raise AssertionError("decode error above the limit")

    # the same multiply -> relinearize -> rescale on the CPU (plain path)
    t0 = time.perf_counter()
    cctx = ckks.make_context(N, Q_BITS, ks_type="II", alpha=ALPHA, device="cpu")
    cpu = lambda c: ckks.Ciphertext(c.c.cpu(), c.size, c.level, c.scale)
    crk = ckks.KSKey(rk.k0.cpu(), rk.k1.cpu())
    c_relin = ckks.relinearize(cctx, ckks.multiply(cctx, cpu(ct1), cpu(ct2)), crk)
    c_res = ckks.rescale(cctx, c_relin)
    same = (torch.equal(c_relin.c, relin.c.cpu()) and torch.equal(c_res.c, res.c.cpu()))
    print(f"CPU plain path residues identical to the card's: {same} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("CPU and card residues differ")

    # -- 6. timings (CUDA events) ---------------------------------------------
    def chain():
        c = ct1
        for _ in range(K_CHAIN):
            c = ckks.relinearize(ctx, ckks.multiply(ctx, c, ct2), rk)
            c = ckks.Ciphertext(c.c, 2, 0, ctx.default_scale)
        return c

    chain_ms = cuda_ms(chain, reps=3, warm=1)
    ops_s = K_CHAIN / (chain_ms / 1e3)
    print(f"chain: K={K_CHAIN} mult+relin in {chain_ms:.3f} ms -> {ops_s:.3f} ops/s "
          f"[{card}]")

    x48 = rand_residues(qp * 3, (48, N), gen, dev).view(3, 16, N)
    f48 = nttm.ntt_cuda(x48, ctx.ntt_qp, inverse=False)
    x32 = f48[:2].contiguous()
    z4 = rand_residues(ctx.q_primes[:4], (4, N), gen, dev)
    conv = ctx.ks2[0].convs[0]
    timed = {
        "ntt_fwd": (lambda: nttm.ntt_cuda(x48, ctx.ntt_qp, False),
                    lambda: nttm.ntt_fwd_plain(x48, ctx.ntt_qp), "(3, 16, 2^16)"),
        "ntt_inv": (lambda: nttm.ntt_cuda(x32, ctx.ntt_qp, True),
                    lambda: nttm.ntt_inv_plain(x32, ctx.ntt_qp), "(2, 16, 2^16)"),
        "mac_keys": (lambda: rns.mac_keys_cuda(d, k0, k1, ctx.base_qp),
                     lambda: torch.stack([rns.lazy_mac_mont(d, k0, ctx.base_qp),
                                          rns.lazy_mac_mont(d, k1, ctx.base_qp)]),
                     "(3, 16, 2^16)"),
        "base_conv": (lambda: rns.base_conv_cuda(z4, conv.mat_mont, conv.obase),
                      lambda: rns.lazy_mac_mont(z4[:, None, :], conv.mat_mont[:, :, None],
                                                conv.obase), "(4 -> 16, 2^16)"),
    }
    times = {}
    for name, (kern, plain, shape) in timed.items():
        ms = cuda_ms(kern, reps=20)
        pms = cuda_ms(plain, reps=3)
        times[name] = (ms, pms)
        print(f"time {name} {shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms [{card}]")

    sources = {"ntt_fwd": ("heongpu_tpu_torch/kernels/csrc/ntt.cu",
                           "heongpu_tpu/ops/ntt_pallas.py:187"),
               "ntt_inv": ("heongpu_tpu_torch/kernels/csrc/ntt.cu",
                           "heongpu_tpu/ops/ntt_pallas.py:187"),
               "mac_keys": ("heongpu_tpu_torch/kernels/csrc/mac.cu",
                            "heongpu_tpu/ops/rns.py:123"),
               "base_conv": ("heongpu_tpu_torch/kernels/csrc/mac.cu",
                             "heongpu_tpu/ops/rns.py:199")}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in sources.items()],
        "chain_ops_per_s": ops_s, "decode_max_abs_err": dec_err,
        "fresh_decode_max_abs_err": fresh_err}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
