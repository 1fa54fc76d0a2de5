#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (heongpu_tpu_torch) on one GPU.

Drives the CKKS main path once at full width — N=2^16, twelve 29-bit Q
primes, Method-II keyswitching with alpha=4 (four 30-bit special primes, a
16-limb QP basis, 3 digits) — through the port's public entry points:
keygen, encode, encrypt, a chain of K=10 multiply -> relinearize, one
multiply -> relinearize -> rescale -> decrypt -> decode checked against
z·z[::-1], and a multiply -> relinearize at level 1.  Every keyswitch of one
poly runs K5, the fused keyswitch kernel.

Then drives the CKKS rotation path on the same context: Galois keys for
the steps 2^0..2^14 and conjugation, rotations (one step, a composed chain,
a negative step), conjugation, a rotate-and-sum over all 2^15 slots,
hoisted rotations (K1 and K2 base_conv / mac_keys), inverse-form keys, key
switching and a monomial product, each decoded against numpy.

Then drives the TFHE gate-bootstrapping path at full STD128 width (LWE
n=512, TRLWE N=1024, k=1, l=2, bg_bit=10, base-4 length-8 keyswitch): keys
from a seeded CUDA generator, the gates, NOT and MUX at B=64 against their
truth tables, huint8 add and sub, each with a BootKey (K3, the n-step chain)
and a BootKey2 (K4, the key-unrolled chain).

Phases (each raises on failure, so the script exits non-zero):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from heongpu_tpu_torch/kernels/csrc, and print
     the ptxas line (registers, stack, spills) of K3 and K4;
  3. K1 (NTT) against its plain torch version on the card, bit for bit,
     forward and inverse, N in {2^11, 2^12, 2^15, 2^16};
  4. K2 (keyswitch MAC, base conversion) against the plain version; K5
     (fused keyswitch) against keyswitch2_fused_core_plain at N=2^12 and at
     N=2^16, levels 0 and 1 (a short last digit group at level 1);
  5. the CKKS main path, with launch counts reset just before it and read
     just after (ntt_fwd, ntt_inv and keyswitch2_fused must launch); every
     kernel launch of it at a new input shape is kept and, when the path
     ends, held against the plain version on the same inputs
     (held_against_plain); the residues of one multiply -> relinearize ->
     rescale must equal the CPU (plain path) run on copies of the same keys
     and inputs;
  6. the CKKS rotation path, counts reset just before and read just after
     (keyswitch2_fused, mac_keys, base_conv, ntt_fwd and ntt_inv must
     launch), held against plain as in phase 5; each result decoded within
     TOL_DECODE plus the noise of the keyswitches it went through
     (keyswitch_noise), the rotate-and-sum within TOL_SUM; one rotate and one
     rotate_hoisted on the CPU plain path must equal the card's residues;
  7. timings with CUDA events: the K=10 chain as ops/s, each kernel against
     its plain version at the main-path shapes (K5 also against the staged
     route of K2 and K1 on the same inputs), rotate, rotate_hoisted and the
     rotate-and-sum; the device-idle share of one mult+relin and of one
     rotate from torch.profiler;
  8. K1 on the TFHE table (N=1024, 2 limbs; 8 and 512 rows); the STD128
     context and keys, with keygen's K1 launches held against plain as in
     phase 5; K3 and K4 against the plain chains at B=8, bit for bit;
  9. the TFHE main path, with launch counts reset just before it and read
     just after: blind_rotate, blind_rotate2, ntt_fwd and ntt_inv must
     each have launched, and each launch at a new shape (B=64 gates, the
     2B=128 MUX, every batch size of the huint8 rounds) is held against
     plain as in phase 5; one bootstrap per key kind on the CPU plain path
     (copies of the same keys and ciphertext, B=2) must equal the card's;
 10. TFHE timings with CUDA events (NAND at B=8 and B=64 against the plain
     chain on the card, K3/K4 against the plain chains, each output
     compared, with their microseconds per step and their per-SM bound,
     huint8 add and MUX at B=64) and, from torch.profiler, the
     device-idle share and the leading kernels of NAND at B=8 and B=64 and
     of a huint8 add.
The kernels' max_abs_err is the worst over every comparison above.  Each
kernel's bound_ms is the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and a lower count of its int32
operations over the card's int32 rate, from this run's timed inputs; K3 and
K4 also carry per_sm_bound_ms, the operations of one gate's chain over one
SM's share (1/132) of that rate, since each gate runs on one SM.
The last three lines are the kernels' JSON record, the card line and
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py   (one CUDA device; no arguments)
"""

import contextlib
import json
import re
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
# Rotate-and-sum limit: the slot sum carries (N/2)·e0/scale of the fresh
# noise, std about 2^15 · 885 / 2^29 ~ 0.054 (885 from the formula above), so
# 0.5 is about 9 sigma; exactness is held by the bit-identical comparison.
TOL_SUM = 0.5
# The level-1 square doubles the relative error of its input.
TOL_DECODE_L1 = 2 * TOL_DECODE
# A result that went through k keyswitches (rotations, conjugation, key
# switching) is held to TOL_DECODE + 4·sqrt(k)·keyswitch_noise(ctx): see there.
GAUSS_SIGMA = 3.2
TFHE_B = 64        # gates per batch on the TFHE main path
HUINT_COUNT = 8    # huint8 integers per add: 64 bit ciphertexts
GATES = {"NAND": lambda a, b: ~(a & b), "AND": lambda a, b: a & b,
         "OR": lambda a, b: a | b, "NOR": lambda a, b: ~(a | b),
         "XOR": lambda a, b: a ^ b, "XNOR": lambda a, b: ~(a ^ b)}


# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth, and the
# int32 rate as the published float32 rate over 4 (an FMA counts as 2 flops,
# and an SM has 64 INT32 lanes against 128 FP32 lanes).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
SMS = 132           # SMs of an H100 SXM; K3/K4 run one gate on one SM
# Lower counts of int32 instructions per unit of work, for the bounds.
BUTTERFLY_OPS = 6   # Shoup butterfly: a*w, umulhi(a, w'), the -q*p multiply-add, add, sub, select
SHOUP_OPS = 3       # Shoup product by a table constant
MAC_OPS = 2         # 32x32 -> 64-bit multiply-accumulate
FOLD_OPS = 10       # REDC of a 64-bit sum with the Barrett pre-reduction


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes_: int, ops: float):
    """(least ms, "bytes" or "operations") for moving nbytes_ and doing ops."""
    b_ms, o_ms = nbytes_ / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def transform_ops(rows: int, n: int) -> int:
    """Butterflies and cross-twiddle products of `rows` n-point transforms."""
    return rows * (n // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS + n * SHOUP_OPS)


def ptxas_summary(log: str, kernel: str) -> dict:
    """{function: its ptxas line of registers and spills} for the functions
    whose (mangled) name holds `kernel`, from the `nvcc -Xptxas -v` build log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if m:
            name = m.group(1)
        elif name and kernel in name and ("spill" in line or "registers" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


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


def device_idle_share(fn, reps: int):
    """(busy ms, wall ms, idle share, {kernel: ms}) per call of fn, over `reps`
    calls.  Busy is the union of the device events' intervals in a
    torch.profiler trace (only events on the card: a host op's self device
    time repeats its kernels'); wall is the host clock around an unprofiled,
    synchronized run.  Raises if the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    if not evts:
        raise AssertionError("torch.profiler recorded no device event")
    busy_us, end, per_kernel = 0.0, float("-inf"), {}
    for e in sorted(evts, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        if t > end:
            busy_us += t - max(s, end)
            end = t
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (t - s) / 1e3 / reps
    busy = busy_us / 1e3 / reps
    return busy, wall, 1.0 - busy / wall, per_kernel


def mac_keys_plain(d, k0, k1, base):
    """The plain version of K2's mac_keys."""
    import torch
    from heongpu_tpu_torch.ops import rns
    return torch.stack([rns.lazy_mac_mont(d, k0, base), rns.lazy_mac_mont(d, k1, base)])


def base_conv_plain(z, mat, obase):
    """The plain version of K2's base_conv."""
    from heongpu_tpu_torch.ops import rns
    return rns.lazy_mac_mont(z[..., :, None, :], mat[:, :, None], obase)


def kernel_wrappers():
    """(module, wrapper name, kernel name from its arguments, plain version)
    for every kernel wrapper of the port."""
    from heongpu_tpu_torch.models import tfhe
    from heongpu_tpu_torch.ops import keyswitch_fused as ksf
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.ops import rns
    from heongpu_tpu_torch.ops import tfhe_kernel as tk
    return [
        (nttm, "ntt_cuda", lambda x, tb, inverse: "ntt_inv" if inverse else "ntt_fwd",
         lambda x, tb, inverse: (nttm.ntt_inv_plain if inverse else nttm.ntt_fwd_plain)(x, tb)),
        (rns, "mac_keys_cuda", lambda *a: "mac_keys", mac_keys_plain),
        (rns, "base_conv_cuda", lambda *a: "base_conv", base_conv_plain),
        (ksf, "keyswitch2_fused_cuda", lambda *a: "keyswitch2_fused",
         ksf.keyswitch2_fused_core_plain),
        (tk, "blind_rotate_cuda",
         lambda acc, a_t, key, ctx, unrolled=False: "blind_rotate2" if unrolled else "blind_rotate",
         lambda acc, a_t, key, ctx, unrolled=False:
             (tfhe.blind_rotate2_plain if unrolled else tfhe.blind_rotate_plain)(acc, a_t, key, ctx)),
    ]


@contextlib.contextmanager
def held_against_plain(what, errs):
    """Runs the block with every kernel wrapper wrapped so that the first launch
    at each distinct set of input shapes keeps copies of its inputs and output.
    When the block ends, each kept output is held against the plain version on
    the same inputs: the kernels are checked at exactly the shapes, and on the
    data, that the block gave them.  The worst error goes into errs[kernel];
    any difference raises."""
    import torch
    first, saved = {}, []
    for mod, attr, namer, plain in kernel_wrappers():
        def recorded(*args, _fn=getattr(mod, attr), _namer=namer, _plain=plain):
            out = _fn(*args)
            shapes = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
            key = (_namer(*args), shapes)
            if key not in first:
                first[key] = (_plain, [a.clone() if isinstance(a, torch.Tensor) else a
                                       for a in args], out.clone())
            return out
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, recorded)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    for (name, shapes), (plain, args, out) in first.items():
        e = max_err(out, plain(*args))
        torch.cuda.synchronize()
        errs[name] = max(errs[name], e)
        print(f"{name} at a {what} shape {shapes[0]} against plain: err={e}")
        if e:
            raise AssertionError(f"{name} disagrees with its plain version at a {what} "
                                 f"shape {shapes}")
    if not first:
        raise AssertionError(f"{what} launched no kernel")


def require_launched(what, launches, names):
    """Raises unless each kernel in `names` launched on the path just run."""
    missing = [k for k in names if not launches[k]]
    if missing:
        raise AssertionError(f"{what} never launched {missing}: {launches}")


def print_profile(what, fn, reps, card, tim, key):
    """The idle share and leading kernels of fn, and the hand-written kernels'
    launches in one call of it."""
    import torch
    from heongpu_tpu_torch import kernels
    busy, wall, idle, per_kernel = device_idle_share(fn, reps)
    kernels.reset_launches()
    fn()
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    tim.update({f"{key}_busy_ms": busy, f"{key}_wall_ms": wall, f"{key}_idle_share": idle,
                f"{key}_launches": launches})
    print(f"profile {what} x{reps}: device busy {busy:.4f} ms, wall {wall:.4f} ms per call "
          f"-> idle share {idle:.4f}; kernel launches per call {launches} [{card}]")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  device {ms:.4f} ms/call: {name[:100]}")


def keyswitch_noise(ctx) -> float:
    """The scale of the error one Method-II keyswitch adds to the worst slot.

    The FastBconv digits are not centred: a digit's coefficients have a mean
    of about (alpha/2)·D, D its group's modulus, so Σ_j d_j·e_j / P holds
    (alpha/2)·(D/P)·(1 ⋆ e_j), a signed running sum of the key's gaussian
    error e_j.  That is a low-frequency error: evaluated at the slot root
    nearest X = 1 it is about (2N/π)·σ·sqrt(N).  So one keyswitch adds about
    sqrt(d)·(alpha/2)·(D/P)·(2N/π)·σ·sqrt(N)/scale to the worst slot: it grows
    as N^1.5 and falls with more special primes (p_count > alpha)."""
    lvl = ctx.ks2[0]
    d_max = max(np.prod([float(ctx.q_primes[i]) for i in g]) for g in lvl.groups)
    p_prod = float(np.prod([float(p) for p in ctx.p_primes]))
    alpha = max(len(g) for g in lvl.groups)
    n = ctx.n
    return (len(lvl.groups) ** 0.5 * alpha / 2 * d_max / p_prod * 2 * n / np.pi
            * GAUSS_SIGMA * n ** 0.5 / ctx.default_scale)


def fused_inputs(ctx, level, gen):
    """Random K5 inputs at a CKKS context's level: (z, mat, k0, k1, tables,
    groups), the arguments of keyswitch2_fused_cuda."""
    from heongpu_tpu_torch.ops import keyswitch_fused as ksf
    lvl, tb, ka = ctx.ks2[level], ctx.ntt_qp_at(level), ctx.active(level)
    d, kqp = len(lvl.groups), tb.num_limbs
    z = rand_residues(ctx.q_primes[:ka], (ka, ctx.n), gen, ctx.device)
    k0, k1 = (rand_residues(list(tb.primes) * d, (d * kqp, ctx.n), gen, ctx.device)
              .view(d, kqp, ctx.n) for _ in range(2))
    return z, ksf.build_fused_mat(lvl, kqp), k0, k1, tb, lvl.groups


def rotation_phase(ctx, cctx, sk, pk, card, errs):
    """Phase 6: the CKKS rotation path on the main-path context.  Returns
    (launch counts of the path, its record, a function that times it)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks, ringkit
    from heongpu_tpu_torch.ops import polyops
    from heongpu_tpu_torch.utils import rng

    n = ctx.n
    log_slots = n.bit_length() - 2
    z = np.random.default_rng(3).uniform(0, 1, n // 2)
    elt = lambda step: polyops.steps_to_galois_elt(step, n)
    ks_noise = keyswitch_noise(ctx)
    dec_errs = {}   # name -> (max abs decode error, keyswitches the result went through)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with held_against_plain("CKKS rotation path", errs):
        g = rng.new_generator(2, ctx.device)
        gk = ckks.keygen_galois(ctx, g, sk, steps=[1 << j for j in range(log_slots)])
        ct = ckks.encrypt(ctx, pk, ckks.encode(ctx, z), g)
        err = lambda c, want, k, s=sk: (
            float(np.abs(ckks.decode(ctx, ckks.decrypt(ctx, s, c)) - want).max()), k)
        for step in (1, 3, -1):
            # the chain walk applies one power-of-two key per set bit of the step
            dec_errs[f"rotate_{step}"] = err(ckks.rotate(ctx, ct, gk, step), np.roll(z, -step),
                                             bin(step % (n // 2)).count("1"))
        dec_errs["conjugate"] = err(ckks.conjugate(ctx, ct, gk), np.conj(z), 1)

        def rotate_and_sum():
            acc = ct
            for j in range(log_slots):
                acc = ckks.add(ctx, acc, ckks.rotate(ctx, acc, gk, 1 << j))
            return acc

        sum_err = err(rotate_and_sum(), z.sum(), log_slots)[0]
        d = ckks.hoist(ctx, ct)
        for step in (1, 2, 4, 8):
            dec_errs[f"rotate_hoisted_{step}"] = err(
                ckks.rotate_hoisted(ctx, ct, d, gk.keys[elt(step)]), np.roll(z, -step), 1)
        gki = ckks.keygen_galois(ctx, g, sk, steps=[1, 3], inv_form=True)
        # rotate walks power-of-two steps only: 3 = three applications of the step-1 key
        dec_errs["inv_form_rotate_3"] = err(ckks.rotate(ctx, ct, gki, 3), np.roll(z, -3), 3)
        dec_errs["inv_form_rotate_hoisted_1"] = err(
            ckks.rotate_hoisted(ctx, ct, d, gki.keys[elt(1)]), np.roll(z, -1), 1)
        sk2 = ckks.keygen_secret(ctx, g)
        swk = ckks.keygen_switch(ctx, g, sk, sk2)
        dec_errs["switch_key"] = err(ckks.switch_key(ctx, ct, swk), z, 1, sk2)
        dec_errs["power_of_x"] = err(ckks.multiply_power_of_x(ctx, ct, n // 2), 1j * z, 0)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        print(f"rotation path: {time.perf_counter() - t0:.1f} s, launches {launches}")
    limit = lambda k: TOL_DECODE + 4 * k ** 0.5 * ks_noise
    print(f"rotation path decode errors (limit {TOL_DECODE} + 4 sqrt(keyswitches) x "
          f"{ks_noise:.3e}): " + ", ".join(f"{name} {e:.3e} (k={k}, limit {limit(k):.3e})"
                                           for name, (e, k) in dec_errs.items())
          + f"; rotate-and-sum over {n // 2} slots vs {z.sum():.3f}: {sum_err:.4f} "
            f"(limit {TOL_SUM})")
    require_launched("rotation path", launches,
                     ("ntt_fwd", "ntt_inv", "keyswitch2_fused", "mac_keys", "base_conv"))
    if not (all(e <= limit(k) for e, k in dec_errs.values()) and sum_err <= TOL_SUM):
        raise AssertionError("a rotation decodes above its limit")

    # one rotate (K5) and one rotate_hoisted (K1, K2) on the CPU plain path,
    # on copies of the same key and ciphertext
    t0 = time.perf_counter()
    one = gk.keys[elt(1)]
    cone = ringkit.GaloisKeyOne(*(t.cpu() for t in (one.k0, one.k1, one.perm_coeff_src,
                                                    one.perm_coeff_neg, one.perm_ntt)),
                                one.galois_elt, one.inv_form)
    cct = ckks.Ciphertext(ct.c.cpu(), ct.size, ct.level, ct.scale)
    same = (torch.equal(ckks.rotate(ctx, ct, gk, 1).c.cpu(),
                        ckks.rotate(cctx, cct, ringkit.GaloisKey({one.galois_elt: cone}), 1).c)
            and torch.equal(ckks.rotate_hoisted(ctx, ct, d, one).c.cpu(),
                            ckks.rotate_hoisted(cctx, cct, ckks.hoist(cctx, cct), cone).c))
    print(f"rotate and rotate_hoisted by 1 on the CPU plain path identical to the card's: "
          f"{same} ({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("CPU and card rotation residues differ")
    record = {"decode_max_abs_err": {name: e for name, (e, _) in dec_errs.items()},
              "keyswitch_noise": ks_noise, "rotate_and_sum_max_abs_err": sum_err,
              "galois_keys": len(gk.keys), "galois_key_mb": 2 * nbytes(one.k0) / 1e6}

    def timings():
        tim = {"rotate_1_ms": cuda_ms(lambda: ckks.rotate(ctx, ct, gk, 1), reps=10)}

        def hoisted4():
            dd = ckks.hoist(ctx, ct)
            return [ckks.rotate_hoisted(ctx, ct, dd, gk.keys[elt(s)]) for s in (1, 2, 4, 8)]

        tim["rotate_hoisted_ms"] = cuda_ms(hoisted4, reps=5) / 4
        tim["rotate_and_sum_ms"] = cuda_ms(rotate_and_sum, reps=2, warm=1)
        print(f"time rotate by 1: {tim['rotate_1_ms']:.4f} ms; rotate_hoisted (hoist + 4 "
              f"rotations, per rotation): {tim['rotate_hoisted_ms']:.4f} ms; rotate-and-sum "
              f"({log_slots} rotations and adds): {tim['rotate_and_sum_ms']:.4f} ms [{card}]")
        print_profile("CKKS rotate by 1", lambda: ckks.rotate(ctx, ct, gk, 1), 5, card, tim,
                      "rotate_1")
        return tim

    return launches, record, timings


def tfhe_phases(dev, card, check_ntt, errs):
    """Phases 8-10: the TFHE gate-bootstrapping path at STD128 width.
    Returns (launch counts of its main path, kernel times, kernel bounds,
    TFHE timings, {kernel: its per-SM bound and time per step})."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import tfhe, tfhe_int
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.ops import tfhe_kernel as tk
    from heongpu_tpu_torch.utils import rng

    # -- 8. K1 on the TFHE table, context and keys, K3/K4 against plain ------
    t0 = time.perf_counter()
    ctx = tfhe.make_context(device=dev)
    check_ntt(ctx.ntt, 8, "TFHE 2-limb table")
    check_ntt(ctx.ntt, 8 * TFHE_B, f"TFHE 2-limb table, the accumulators of a {2 * TFHE_B}-gate MUX")
    g = rng.new_generator(11, dev)
    with held_against_plain("TFHE keygen", errs):
        sk = tfhe.keygen_secret(g, ctx.n, device=dev)
        bk = tfhe.keygen_boot(ctx, g, sk)
        bk2 = tfhe.keygen_boot_unrolled(ctx, g, sk)
        torch.cuda.synchronize()
    print(f"TFHE context and keys: n={ctx.n} N={ctx.N} l={ctx.l} bg_bit={ctx.bg_bit} "
          f"ks base 2^{ctx.ks_base_bit} x{ctx.ks_length}, primes {ctx.primes}, "
          f"bk {tuple(bk.bk.shape)}, bk2 {tuple(bk2.bk2.shape)}, "
          f"{time.perf_counter() - t0:.1f} s")

    r = np.random.default_rng(5)
    chains = {"blind_rotate": (bk.bk, tfhe.blind_rotate_plain, False),
              "blind_rotate2": (bk2.bk2, tfhe.blind_rotate2_plain, True)}
    prologue = {B: tfhe._boot_prologue(ctx, tfhe.encrypt(ctx, sk, r.integers(0, 2, B), g))
                for B in (8, TFHE_B)}
    for name, (key, plain, unrolled) in chains.items():
        acc, a_t = prologue[8]
        e = max_err(tk.blind_rotate_cuda(acc, a_t, key, ctx, unrolled), plain(acc, a_t, key, ctx))
        torch.cuda.synchronize()
        errs[name] = max(errs[name], e)
        print(f"K{4 if unrolled else 3} {name} (B=8, n={ctx.n}): err={e}")
        if e:
            raise AssertionError(f"{name} kernel disagrees with the plain chain")

    # -- 9. the TFHE main path ---------------------------------------------------
    x, y, s = (r.integers(0, 2, TFHE_B).astype(bool) for _ in range(3))
    xs, ys = r.integers(0, 256, HUINT_COUNT), r.integers(0, 256, HUINT_COUNT)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with held_against_plain("TFHE main path", errs):
        cx, cy, cs = (tfhe.encrypt(ctx, sk, v, g) for v in (x, y, s))
        hx = tfhe_int.encrypt_huint(ctx, sk, xs, 8, g)
        hy = tfhe_int.encrypt_huint(ctx, sk, ys, 8, g)
        wrong = []
        for kname, key in (("BootKey", bk), ("BootKey2", bk2)):
            outs = {gate: getattr(tfhe, gate)(ctx, key, cx, cy) for gate in GATES}
            outs["MUX"] = tfhe.MUX(ctx, key, cs, cx, cy)
            outs["NOT"] = tfhe.NOT(ctx, cx)
            want = {gate: fn(x, y) for gate, fn in GATES.items()}
            want.update(MUX=np.where(s, x, y), NOT=~x)
            for gate, ct in outs.items():
                if not (ct.a.shape == (TFHE_B, ctx.n) and
                        np.array_equal(tfhe.decrypt(ctx, sk, ct), want[gate])):
                    wrong.append(f"{gate}/{kname}")
            hs, carry = tfhe_int.add(ctx, key, hx, hy)
            hd, noborrow = tfhe_int.sub(ctx, key, hx, hy)
            dec = lambda h: tfhe_int.decrypt_huint(ctx, sk, h).astype(np.int64)
            bit = lambda c: tfhe.decrypt(ctx, sk, c).astype(np.int64)
            if not (np.array_equal(dec(hs), (xs + ys) % 256) and
                    np.array_equal(bit(carry), (xs + ys) >> 8)):
                wrong.append(f"huint8 add/{kname}")
            if not (np.array_equal(dec(hd), (xs - ys) % 256) and
                    np.array_equal(bit(noborrow), (xs >= ys).astype(np.int64))):
                wrong.append(f"huint8 sub/{kname}")
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        print(f"TFHE main path (B={TFHE_B} gates x 6 + NOT + MUX, huint8 add and sub of "
              f"{HUINT_COUNT}, both key kinds): {time.perf_counter() - t0:.1f} s, "
              f"launches {launches}, wrong: {wrong or 'none'}")
    if wrong:
        raise AssertionError(f"TFHE outputs decrypt wrong: {wrong}")
    require_launched("TFHE main path", launches,
                     ("ntt_fwd", "ntt_inv", "blind_rotate", "blind_rotate2"))

    # the same bootstrap on the CPU plain path, on copies of keys and input
    t0 = time.perf_counter()
    cctx = tfhe.make_context(device="cpu")
    ct2 = tfhe.encrypt(ctx, sk, np.array([1, 0]), g)
    cpu_ct = tfhe.Ciphertext(ct2.a.cpu(), ct2.b.cpu(), ct2.variance)
    for kname, key, ckey in (
            ("BootKey", bk, tfhe.BootKey(bk.bk.cpu(), bk.ksk_a.cpu(), bk.ksk_b.cpu())),
            ("BootKey2", bk2, tfhe.BootKey2(bk2.bk2.cpu(), bk2.ksk_a.cpu(), bk2.ksk_b.cpu()))):
        card_out = tfhe.bootstrap(ctx, key, ct2)
        cpu_out = tfhe.bootstrap(cctx, ckey, cpu_ct)
        same = (torch.equal(card_out.a.cpu(), cpu_out.a) and torch.equal(card_out.b.cpu(), cpu_out.b)
                and card_out.variance == cpu_out.variance)
        print(f"TFHE bootstrap (B=2, n={cctx.n}, {kname}) on the CPU plain path identical "
              f"to the card's: {same} ({time.perf_counter() - t0:.1f} s so far)")
        if not same:
            raise AssertionError("CPU and card TFHE outputs differ")

    # -- 10. timings --------------------------------------------------------------
    def plain_nand(key, c1, c2):
        """NAND with the plain chain in place of K3, on the card."""
        acc, a_t = tfhe._boot_prologue(ctx, tfhe._lin(c1, c2, -1, -1, tfhe.MU, 1))
        acc = tfhe.blind_rotate_plain(acc, a_t, key.bk, ctx)
        return tfhe._boot_epilogue(ctx, key, tfhe._rns_to_torus(ctx, nttm.ntt_inv(acc, ctx.ntt)))

    c8x = tfhe.Ciphertext(cx.a[:8], cx.b[:8], cx.variance)
    c8y = tfhe.Ciphertext(cy.a[:8], cy.b[:8], cy.variance)
    if not torch.equal(plain_nand(bk, c8x, c8y).a, tfhe.NAND(ctx, bk, c8x, c8y).a):
        raise AssertionError("the plain-chain NAND differs from the kernel path")
    tim = {}
    for B, (a1, a2) in ((8, (c8x, c8y)), (TFHE_B, (cx, cy))):
        ms = cuda_ms(lambda: tfhe.NAND(ctx, bk, a1, a2), reps=10)
        pms = cuda_ms(lambda: plain_nand(bk, a1, a2), reps=1, warm=1)
        tim[f"nand_b{B}_ms"], tim[f"nand_b{B}_plain_ms"] = ms, pms
        print(f"time NAND gate bootstrap B={B}: kernel path {ms:.4f} ms "
              f"({ms * 1e3 / B:.2f} us/gate), plain chain {pms:.4f} ms [{card}]")
    kt, per_step = {}, {}
    for name, (key, plain, unrolled) in chains.items():
        steps = ctx.n // 2 if unrolled else ctx.n
        # one gate's transforms on one SM: the least time of a chain that keeps each
        # gate on one SM, whatever B <= SMS
        sm_ms = bound(0, steps * transform_ops(12, ctx.N) * SMS)[0]
        for B in (8, TFHE_B):
            acc, a_t = prologue[B]
            e = max_err(tk.blind_rotate_cuda(acc, a_t, key, ctx, unrolled),
                        plain(acc, a_t, key, ctx))    # also the plain chain's warm-up
            errs[name] = max(errs[name], e)
            if e:
                raise AssertionError(f"{name} disagrees with the plain chain at B={B}")
            ms = cuda_ms(lambda: tk.blind_rotate_cuda(acc, a_t, key, ctx, unrolled), reps=10)
            pms = cuda_ms(lambda: plain(acc, a_t, key, ctx), reps=1, warm=0)
            kt[(name, B)] = (ms, pms)
            us = ms * 1e3 / steps
            tim[f"{name}_b{B}_ms"], tim[f"{name}_b{B}_plain_ms"] = ms, pms
            tim[f"{name}_b{B}_us_per_step"] = us
            print(f"time {name} (B={B}, n={ctx.n}): kernel {ms:.4f} ms = {us:.3f} us per "
                  f"{'pair ' if unrolled else ''}step ({steps}), plain {pms:.4f} ms, err={e}; "
                  f"per-SM bound {sm_ms:.4f} ms = {sm_ms * 1e3 / steps:.3f} us per "
                  f"{'pair ' if unrolled else ''}step [{card}]")
        per_step[name] = {"per_sm_bound_ms": sm_ms, "us_per_step": kt[(name, 8)][0] * 1e3 / steps,
                          "steps": steps}
    for kname, key in (("BootKey", bk), ("BootKey2", bk2)):
        ms = cuda_ms(lambda: tfhe_int.add(ctx, key, hx, hy), reps=3, warm=1)
        mux = cuda_ms(lambda: tfhe.MUX(ctx, key, cs, cx, cy), reps=5, warm=1)
        tim[f"huint8_add_{kname}_ms"], tim[f"mux_b{TFHE_B}_{kname}_ms"] = ms, mux
        print(f"time huint8 add x{HUINT_COUNT} ({kname}): {ms:.4f} ms; MUX B={TFHE_B} "
              f"({kname}): {mux:.4f} ms [{card}]")
    print_profile("NAND B=8", lambda: tfhe.NAND(ctx, bk, c8x, c8y), 5, card, tim, "nand_b8")
    print_profile(f"NAND B={TFHE_B}", lambda: tfhe.NAND(ctx, bk, cx, cy), 5, card, tim,
                  f"nand_b{TFHE_B}")
    print_profile(f"huint8 add x{HUINT_COUNT} (BootKey)", lambda: tfhe_int.add(ctx, bk, hx, hy),
                  2, card, tim, "huint8_add")
    # bounds at the timed B=8 inputs: each step (pair step for K4) runs 12 row
    # transforms of N=1024 points per gate (INTT of the 4 rows of X^a·acc - acc,
    # forward NTT of the 8 digit rows); the key is read once
    tb = ctx.ntt
    tabs = (ctx.omega_pows, ctx.omega_exps, tb.p, tb.pinv, tb.r1, tb.tw1p, tb.tw1p_sh, tb.tw2p,
            tb.tw2p_sh,
            tb.itw1p, tb.itw1p_sh, tb.itw2p, tb.itw2p_sh, tb.tw_mat, tb.tw_mat_sh,
            tb.itw_mat, tb.itw_mat_sh)
    acc, a_t = prologue[8]
    bounds = {}
    for name, (key, _, unrolled) in chains.items():
        steps = ctx.n // 2 if unrolled else ctx.n
        bounds[name] = bound(nbytes(acc, a_t, key, acc, *tabs),
                             acc.shape[0] * steps * transform_ops(12, ctx.N))
    return launches, {name: kt[(name, 8)] for name in chains}, bounds, tim, per_step


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "script runs the port on a CUDA GPU only")
    return run(torch.device("cuda"))


def run(dev) -> int:
    """All phases on `dev` (the card; main() checks that there is one)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.kernels import build
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.ops import keyswitch_fused as ksf
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.ops import rns
    from heongpu_tpu_torch.utils import nt, rng

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
    ptxas = {("blind_rotate2" if "Lb1E" in fn else "blind_rotate"): line
             for fn, line in ptxas_summary(log, "blind_rotate_kernel").items()}
    for name, line in ptxas.items():
        print(f"ptxas tfhe.cu {name}: {line}")
    if log and len(ptxas) != 2:
        raise AssertionError(f"no ptxas line for both blind-rotation kernels: {ptxas}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    errs = dict.fromkeys(kernels.launches, 0)

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

    # -- main-path context (the N=2^16 tables of phases 3-7) -----------------
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

    # -- 4. K2 and K5 against plain ----------------------------------------------
    qp = list(ctx.qp_primes)
    d = rand_residues(qp * 3, (48, N), gen, dev).view(3, 16, N)
    k0 = rand_residues(qp * 3, (48, N), gen, dev).view(3, 16, N)
    k1 = rand_residues(qp * 3, (48, N), gen, dev).view(3, 16, N)
    errs["mac_keys"] = max_err(rns.mac_keys_cuda(d, k0, k1, ctx.base_qp),
                               mac_keys_plain(d, k0, k1, ctx.base_qp))
    print(f"K2 mac_keys (3, 16, {N}): err={errs['mac_keys']}")
    conv_cases = [(ctx.ks2[0].convs[0], "4 -> 16"), (ctx.ks2[2].convs[2], "2 -> 14")]
    for conv, what in conv_cases:
        k_in = conv.mat_mont.shape[0]
        z = rand_residues([int(v) for v in conv.ibase.p.tolist()], (k_in, N), gen, dev)
        e = max_err(rns.base_conv_cuda(z, conv.mat_mont, conv.obase),
                    base_conv_plain(z, conv.mat_mont, conv.obase))
        errs["base_conv"] = max(errs["base_conv"], e)
        print(f"K2 base_conv ({what}, {N}): err={e}")
    torch.cuda.synchronize()
    if errs["mac_keys"] or errs["base_conv"]:
        raise AssertionError("MAC kernels disagree with the plain version")

    small = ckks.make_context(1 << 12, Q_BITS, ks_type="II", alpha=ALPHA, device=dev)
    for c, level in ((small, 0), (ctx, 0), (ctx, 1)):
        args = fused_inputs(c, level, gen)
        e = max_err(ksf.keyswitch2_fused_cuda(*args), ksf.keyswitch2_fused_core_plain(*args))
        torch.cuda.synchronize()
        errs["keyswitch2_fused"] = max(errs["keyswitch2_fused"], e)
        print(f"K5 keyswitch2_fused N={c.n} level {level}: z {tuple(args[0].shape)}, "
              f"keys {tuple(args[2].shape)}, groups {args[5]}: err={e}")
        if e:
            raise AssertionError("K5 disagrees with keyswitch2_fused_core_plain")

    # -- 5. the main path -------------------------------------------------------
    z = np.linspace(-1.0, 1.0, N // 2)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with held_against_plain("CKKS main path", errs):
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
        res1 = ckks.rescale(ctx, ckks.relinearize(ctx, ckks.multiply(ctx, res, res), rk))
        dec1 = ckks.decode(ctx, ckks.decrypt(ctx, sk, res1))
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        print(f"main path: {time.perf_counter() - t0:.1f} s, launches {launches}")
    require_launched("CKKS main path", launches, ("ntt_fwd", "ntt_inv", "keyswitch2_fused"))
    if not np.isfinite(dec).all() or dec.shape != (N // 2,):
        raise AssertionError("decode gave non-finite values or the wrong shape")
    for t in (out.c, res.c, res1.c):
        if int(t.min()) < 0 or int(t.max()) >= 1 << 30:
            raise AssertionError("residues out of range")
    dec_err = float(np.abs(dec - z * z[::-1]).max())
    dec1_err = float(np.abs(dec1 - (z * z[::-1]) ** 2).max())
    fresh_err = float(np.abs(ckks.decode(ctx, ckks.decrypt(ctx, sk, ct1)) - z).max())
    print(f"decode max abs error vs z*z[::-1]: {dec_err:.3e} (limit {TOL_DECODE}); "
          f"level-1 square: {dec1_err:.3e} (limit {TOL_DECODE_L1}); "
          f"fresh encrypt/decrypt of z: {fresh_err:.3e}")
    if not (dec_err <= TOL_DECODE and dec1_err <= TOL_DECODE_L1):
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

    # -- 6. the rotation path ---------------------------------------------------
    rot_launches, rot, time_rotations = rotation_phase(ctx, cctx, sk, pk, card, errs)

    # -- 7. timings (CUDA events) ---------------------------------------------
    def chain():
        c = ct1
        for _ in range(K_CHAIN):
            c = ckks.relinearize(ctx, ckks.multiply(ctx, c, ct2), rk)
            c = ckks.Ciphertext(c.c, 2, 0, ctx.default_scale)
        return c

    chain_ms = cuda_ms(chain, reps=3, warm=1)
    ops_s = K_CHAIN / (chain_ms / 1e3)
    print(f"chain: K={K_CHAIN} mult+relin (through K5) in {chain_ms:.3f} ms -> "
          f"{ops_s:.3f} ops/s [{card}]")

    x48 = rand_residues(qp * 3, (48, N), gen, dev).view(3, 16, N)
    f48 = nttm.ntt_cuda(x48, ctx.ntt_qp, inverse=False)
    x32 = f48[:2].contiguous()
    z4 = rand_residues(ctx.q_primes[:4], (4, N), gen, dev)
    conv = ctx.ks2[0].convs[0]
    fz, fmat, fk0, fk1, ftb, fgroups = fargs = fused_inputs(ctx, 0, gen)
    lvl = ctx.ks2[0]

    def staged():
        """K5's function by the staged route: K2 base_conv per digit, K1
        forward, K2 mac_keys, K1 inverse."""
        digits = torch.stack([rns.base_conv_cuda(fz[g[0]: g[-1] + 1], cv.mat_mont, cv.obase)
                              for cv, g in zip(lvl.convs, fgroups)])
        acc = rns.mac_keys_cuda(nttm.ntt_cuda(digits, ftb, False), fk0, fk1, ctx.base_qp)
        return nttm.ntt_cuda(acc, ftb, True)

    e = max(max_err(ksf.keyswitch2_fused_cuda(*fargs), staged()),
            max_err(staged(), ksf.keyswitch2_fused_core_plain(*fargs)))
    torch.cuda.synchronize()
    errs["keyswitch2_fused"] = max(errs["keyswitch2_fused"], e)
    if e:
        raise AssertionError("K5, the staged route and the plain core disagree")
    tb_f, tb_i = ctx.ntt_qp, ctx.ntt_qp
    ntt_tabs = lambda tb, inv: ((tb.itw_mat, tb.itw_mat_sh, tb.itw1p, tb.itw1p_sh, tb.itw2p,
                                 tb.itw2p_sh) if inv else (tb.tw_mat, tb.tw_mat_sh, tb.tw1p,
                                                           tb.tw1p_sh, tb.tw2p, tb.tw2p_sh))
    bq = ctx.base_qp
    kd, kqp = len(fgroups), ftb.num_limbs
    timed = {
        "ntt_fwd": (lambda: nttm.ntt_cuda(x48, ctx.ntt_qp, False),
                    lambda: nttm.ntt_fwd_plain(x48, ctx.ntt_qp), "(3, 16, 2^16)",
                    bound(2 * nbytes(x48) + nbytes(tb_f.p, *ntt_tabs(tb_f, False)),
                          transform_ops(48, N))),
        "ntt_inv": (lambda: nttm.ntt_cuda(x32, ctx.ntt_qp, True),
                    lambda: nttm.ntt_inv_plain(x32, ctx.ntt_qp), "(2, 16, 2^16)",
                    bound(2 * nbytes(x32) + nbytes(tb_i.p, *ntt_tabs(tb_i, True)),
                          transform_ops(32, N))),
        "mac_keys": (lambda: rns.mac_keys_cuda(d, k0, k1, bq),
                     lambda: mac_keys_plain(d, k0, k1, bq), "(3, 16, 2^16)",
                     bound(nbytes(d, k0, k1, d[:2], bq.p, bq.pinv, bq.mu),
                           2 * d.numel() * MAC_OPS + 2 * 16 * N * FOLD_OPS)),
        "base_conv": (lambda: rns.base_conv_cuda(z4, conv.mat_mont, conv.obase),
                      lambda: base_conv_plain(z4, conv.mat_mont, conv.obase),
                      "(4 -> 16, 2^16)",
                      bound(nbytes(z4, conv.mat_mont, d[0], conv.obase.p, conv.obase.pinv,
                                   conv.obase.mu), 4 * 16 * N * MAC_OPS + 16 * N * FOLD_OPS)),
        "keyswitch2_fused": (
            lambda: ksf.keyswitch2_fused_cuda(*fargs),
            lambda: ksf.keyswitch2_fused_core_plain(*fargs), "(level 0: z (12, 2^16), 3 digits)",
            bound(nbytes(fz, fmat, fk0, fk1, x32, ftb.p, ftb.pinv, ftb.mu,
                         *ntt_tabs(ftb, False), *ntt_tabs(ftb, True)),
                  transform_ops(kd * kqp + 2 * kqp, N) + kd * kqp * N * (ALPHA * MAC_OPS + FOLD_OPS)
                  + 2 * kd * kqp * N * MAC_OPS + 2 * kqp * N * FOLD_OPS)),
    }
    times, bounds = {}, {}
    for name, (kern, plain, shape, bnd) in timed.items():
        ms = cuda_ms(kern, reps=20)
        pms = cuda_ms(plain, reps=3)
        times[name], bounds[name] = (ms, pms), bnd
        print(f"time {name} {shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}) [{card}]")
    staged_ms = cuda_ms(staged, reps=20)
    print(f"time keyswitch2_fused staged route (3 base_conv + ntt_fwd + mac_keys + ntt_inv) "
          f"on the same inputs: {staged_ms:.4f} ms [{card}]")
    ckks_prof = {}
    print_profile("CKKS mult+relin", lambda: ckks.relinearize(ctx, ckks.multiply(ctx, ct1, ct2), rk),
                  5, card, ckks_prof, "mult_relin")
    rot.update(time_rotations())

    # -- 8-10. the TFHE path ------------------------------------------------------
    tfhe_launches, tfhe_times, tfhe_bounds, tfhe_tim, per_step = tfhe_phases(dev, card, check_ntt,
                                                                             errs)
    # each kernel's launches on the three paths, each counted from 0 just before its path
    ckks_launches = launches
    launches = {k: ckks_launches[k] + rot_launches[k] + tfhe_launches[k] for k in launches}
    times.update(tfhe_times)
    bounds.update(tfhe_bounds)

    sources = {"ntt_fwd": ("heongpu_tpu_torch/kernels/csrc/ntt.cu",
                           "heongpu_tpu/ops/ntt_pallas.py:187"),
               "ntt_inv": ("heongpu_tpu_torch/kernels/csrc/ntt.cu",
                           "heongpu_tpu/ops/ntt_pallas.py:187"),
               "mac_keys": ("heongpu_tpu_torch/kernels/csrc/mac.cu",
                            "heongpu_tpu/ops/rns.py:123"),
               "base_conv": ("heongpu_tpu_torch/kernels/csrc/mac.cu",
                             "heongpu_tpu/ops/rns.py:199"),
               "blind_rotate": ("heongpu_tpu_torch/kernels/csrc/tfhe.cu",
                                "heongpu_tpu/ops/tfhe_kernel.py:558"),
               "blind_rotate2": ("heongpu_tpu_torch/kernels/csrc/tfhe.cu",
                                 "heongpu_tpu/ops/tfhe_kernel.py:572"),
               "keyswitch2_fused": ("heongpu_tpu_torch/kernels/csrc/keyswitch.cu",
                                    "heongpu_tpu/ops/keyswitch_pallas.py:148")}
    kernels_rec = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name, (src, rep) in sources.items()]
    kernels_rec[-1]["staged_ms"] = staged_ms
    for k in kernels_rec:
        k.update(per_step.get(k["name"], {}))
        if k["name"] in ptxas:
            k["ptxas"] = ptxas[k["name"]]
    bad = [k["name"] for k in kernels_rec if not k["launches"] or k["max_abs_err"]]
    if bad:
        raise AssertionError(f"kernels not launched on their path or in error: {bad}")
    record = {"kernels": kernels_rec,
              "chain_ops_per_s": ops_s, "decode_max_abs_err": dec_err,
              "level1_decode_max_abs_err": dec1_err, "fresh_decode_max_abs_err": fresh_err,
              "ckks": ckks_prof, "rotation_launches": rot_launches, "rotation": rot,
              "tfhe_launches": tfhe_launches, "tfhe": tfhe_tim}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
