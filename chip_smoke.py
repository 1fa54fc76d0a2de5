#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (heongpu_tpu_torch) on one GPU.

Drives the CKKS main path once at full width — N=2^16, twelve 29-bit Q
primes, Method-II keyswitching with alpha=4 (four 30-bit special primes, a
16-limb QP basis, 3 digits) — through the port's public entry points:
keygen, encode, encrypt, a chain of K=10 multiply -> relinearize, and one
multiply -> relinearize -> rescale -> decrypt -> decode checked against
z·z[::-1].

Then drives the TFHE gate-bootstrapping path at full STD128 width (LWE
n=512, TRLWE N=1024, k=1, l=2, bg_bit=10, base-4 length-8 keyswitch): keys
from a seeded CUDA generator, the gates, NOT and MUX at B=64 against their
truth tables, huint8 add and sub, each with a BootKey (K3, the n-step chain)
and a BootKey2 (K4, the key-unrolled chain).

Phases (each raises on failure, so the script exits non-zero):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from heongpu_tpu_torch/kernels/csrc;
  3. K1 (NTT) against its plain torch version on the card, bit for bit,
     forward and inverse, N in {2^11, 2^12, 2^15, 2^16};
  4. K2 (keyswitch MAC, base conversion) against the plain version;
  5. the CKKS main path, with launch counts reset just before it and read
     just after; every kernel launch of it at a new input shape is kept and,
     when the path ends, held against the plain version on the same inputs
     (held_against_plain); the residues of one multiply -> relinearize ->
     rescale must equal the CPU (plain path) run on copies of the same keys
     and inputs;
  6. timings with CUDA events: the K=10 chain as ops/s, and each kernel
     against its plain version at the main-path shapes; the device-idle
     share of one mult+relin from torch.profiler;
  7. K1 on the TFHE table (N=1024, 2 limbs; 8 and 512 rows); the STD128
     context and keys, with keygen's K1 launches held against plain as in
     phase 5; K3 and K4 against the plain chains at B=8, bit for bit;
  8. the TFHE main path, with launch counts reset just before it and read
     just after: blind_rotate, blind_rotate2, ntt_fwd and ntt_inv must
     each have launched, and each launch at a new shape (B=64 gates, the
     2B=128 MUX, every batch size of the huint8 rounds) is held against
     plain as in phase 5; one bootstrap per key kind on the CPU plain path
     (copies of the same keys and ciphertext, B=2) must equal the card's;
  9. TFHE timings with CUDA events (NAND at B=8 and B=64 against the plain
     chain on the card, K3/K4 against the plain chains, each output
     compared, huint8 add and MUX at B=64) and, from torch.profiler, the
     device-idle share and the leading kernels of NAND at B=8 and B=64 and
     of a huint8 add.
The kernels' max_abs_err is the worst over every comparison above.
The last three lines are the kernels' JSON record, the card line and
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py   (one CUDA device; no arguments)
"""

import contextlib
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
TFHE_B = 64        # gates per batch on the TFHE main path
HUINT_COUNT = 8    # huint8 integers per add: 64 bit ciphertexts
GATES = {"NAND": lambda a, b: ~(a & b), "AND": lambda a, b: a & b,
         "OR": lambda a, b: a | b, "NOR": lambda a, b: ~(a | b),
         "XOR": lambda a, b: a ^ b, "XNOR": lambda a, b: ~(a ^ b)}


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
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.ops import rns
    from heongpu_tpu_torch.ops import tfhe_kernel as tk
    return [
        (nttm, "ntt_cuda", lambda x, tb, inverse: "ntt_inv" if inverse else "ntt_fwd",
         lambda x, tb, inverse: (nttm.ntt_inv_plain if inverse else nttm.ntt_fwd_plain)(x, tb)),
        (rns, "mac_keys_cuda", lambda *a: "mac_keys", mac_keys_plain),
        (rns, "base_conv_cuda", lambda *a: "base_conv", base_conv_plain),
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


def print_profile(what, fn, reps, card, tim, key):
    busy, wall, idle, per_kernel = device_idle_share(fn, reps)
    tim.update({f"{key}_busy_ms": busy, f"{key}_wall_ms": wall, f"{key}_idle_share": idle})
    print(f"profile {what} x{reps}: device busy {busy:.4f} ms, wall {wall:.4f} ms per call "
          f"-> idle share {idle:.4f} [{card}]")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  device {ms:.4f} ms/call: {name[:100]}")


def tfhe_phases(dev, card, check_ntt, errs):
    """Phases 7-9: the TFHE gate-bootstrapping path at STD128 width.
    Returns (launch counts of its main path, kernel times, TFHE timings)."""
    import torch
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import tfhe, tfhe_int
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.ops import tfhe_kernel as tk
    from heongpu_tpu_torch.utils import rng

    # -- 7. K1 on the TFHE table, context and keys, K3/K4 against plain ------
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

    # -- 8. the TFHE main path ---------------------------------------------------
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
        launches = {k: kernels.launches[k] for k in ("ntt_fwd", "ntt_inv", "blind_rotate",
                                                     "blind_rotate2")}
        print(f"TFHE main path (B={TFHE_B} gates x 6 + NOT + MUX, huint8 add and sub of "
              f"{HUINT_COUNT}, both key kinds): {time.perf_counter() - t0:.1f} s, "
              f"launches {launches}, wrong: {wrong or 'none'}")
    if wrong:
        raise AssertionError(f"TFHE outputs decrypt wrong: {wrong}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the TFHE path was never launched: {launches}")

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

    # -- 9. timings ---------------------------------------------------------------
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
    kt = {}
    for name, (key, plain, unrolled) in chains.items():
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
            tim[f"{name}_b{B}_ms"], tim[f"{name}_b{B}_plain_ms"] = ms, pms
            print(f"time {name} (B={B}, n={ctx.n}): kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"err={e} [{card}]")
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
    return launches, {name: kt[(name, 8)] for name in chains}, tim


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
        torch.cuda.synchronize()
        launches = {k: kernels.launches[k] for k in ("ntt_fwd", "ntt_inv", "mac_keys",
                                                     "base_conv")}
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
                     lambda: mac_keys_plain(d, k0, k1, ctx.base_qp), "(3, 16, 2^16)"),
        "base_conv": (lambda: rns.base_conv_cuda(z4, conv.mat_mont, conv.obase),
                      lambda: base_conv_plain(z4, conv.mat_mont, conv.obase),
                      "(4 -> 16, 2^16)"),
    }
    times = {}
    for name, (kern, plain, shape) in timed.items():
        ms = cuda_ms(kern, reps=20)
        pms = cuda_ms(plain, reps=3)
        times[name] = (ms, pms)
        print(f"time {name} {shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms [{card}]")
    ckks_prof = {}
    print_profile("CKKS mult+relin", lambda: ckks.relinearize(ctx, ckks.multiply(ctx, ct1, ct2), rk),
                  5, card, ckks_prof, "mult_relin")

    # -- 7-9. the TFHE path -------------------------------------------------------
    tfhe_launches, tfhe_times, tfhe_tim = tfhe_phases(dev, card, check_ntt, errs)
    launches.update(blind_rotate=tfhe_launches["blind_rotate"],
                    blind_rotate2=tfhe_launches["blind_rotate2"])
    times.update(tfhe_times)

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
                                 "heongpu_tpu/ops/tfhe_kernel.py:572")}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in sources.items()],
        "chain_ops_per_s": ops_s, "decode_max_abs_err": dec_err,
        "fresh_decode_max_abs_err": fresh_err,
        "ckks": ckks_prof, "tfhe_launches": tfhe_launches, "tfhe": tfhe_tim}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
