#!/usr/bin/env python3
"""Times the NTT kernel K1 (kernels/csrc/ntt.cu: the whole transform and the
split entry's passes), the ÷P kernel K6 (kernels/csrc/divround.cu, both
modes) and the Threefry kernel K7 (kernels/csrc/threefry.cu, both modes) on
one card, at the shapes chip_smoke.py times them (K7 also over one rank's
block of rows of the depth-48 key, where the root's K7 takes a row range),
with chip_smoke.py's own
shape builders and `time_kernels`: each shape held bit for bit against its
plain version, then timed (device ms from torch.profiler, corrected for
launches the trace dropped, CUDA events, the plain version) beside its
bound.  For K1 it also times a split transform over D = 2, 4, 8 ranks in one
process against K1 whole (`split_transform_ms`).

    python3 tools/kernel_bench.py [--root DIR] [--label NAME] [--kernels k1,k6,k7]
                                  [--variants] [--repeat R] [--out FILE]

--root DIR takes heongpu_tpu_torch from DIR (for instance an unpacked
`git archive` of another commit), its sources, wrappers and table builders,
so two versions are compared on the same card by running the script once for
each, in turns (a source without the split entry times K1 whole only).  Only
the chosen kernels' sources are compiled (one nvcc -c each, -Xptxas -v, all
started together, then a link), into a library the package's wrappers then
call.  --variants also builds K6's and K7's sources with other values of
their tuning macros (K7_THREADS, K7_WORDS, K7_BITS_THREADS, K7_BITS_WORDS,
K7_BITS_FMA_ADDS; K6_PER_THREAD, K6_COLUMN_ROWS_4, K6_COLUMN_ROWS_8) and
times each.  --repeat times each shape R times in a row, so the spread within
a run shows.  Beside K6 it times torch's copy of as many words as K6 writes
(a read and a write of each), the rate a plain contiguous stream reaches on
the card.

Prints chip_smoke.py's timing line for each kernel and shape (with "(k of m
launches traced)" where the profiler dropped launches), the ptxas lines and
the SASS mix of K7's kernels, and writes every record to --out as JSON.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
N16, N15 = 1 << 16, 1 << 15
# each kernel's source and C entry points
SOURCES = {"k1": "ntt.cu", "k6": "divround.cu", "k7": "threefry.cu"}
ENTRIES = {"k1": ("hf_ntt", "hf_ntt_pass"), "k6": ("hf_div_round", "hf_div_exact_t"),
           "k7": ("hf_threefry_uniform", "hf_threefry_bits")}
# (name, -D macros) of the builds --variants adds to K6's and K7's sources as they stand
VARIANTS = (("k7 words 2", {"K7_WORDS": 2}), ("k7 words 8", {"K7_WORDS": 8}),
            ("k7 threads 256", {"K7_THREADS": 256}),
            ("k7 bits words 4", {"K7_BITS_WORDS": 4}),
            ("k7 bits threads 128", {"K7_BITS_THREADS": 128}),
            ("k7 bits fma adds", {"K7_BITS_FMA_ADDS": 1}),
            ("k6 rows 8", {"K6_PER_THREAD": 8}), ("k6 rows 16", {"K6_PER_THREAD": 16}),
            ("k6 no column kernel", {"K6_COLUMN_ROWS_4": 0, "K6_COLUMN_ROWS_8": 0}))


def compile_lib(build, out_dir: Path, defines: dict, kinds) -> tuple[Path, str]:
    """nvcc -c of the sources of `kinds` with `defines`, all started together,
    linked into one shared library; returns (library, ptxas log)."""
    srcs = [build.CSRC / SOURCES[k] for k in kinds]
    objs = [out_dir / (src.stem + ".o") for src in srcs]

    def nvcc(cmd):
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=build.NVCC_TIMEOUT)
        if res.returncode:
            raise SystemExit(f"nvcc failed with {defines}:\n{res.stderr[-4000:]}")
        return res.stdout + res.stderr

    with ThreadPoolExecutor(len(srcs)) as pool:
        log = list(pool.map(lambda src, obj: nvcc(
            [build.nvcc(), *build.COMPILE_FLAGS, *(f"-D{k}={v}" for k, v in defines.items()),
             f"-I{build.CSRC}", "-c", "-o", str(obj), str(src)]), srcs, objs))
    lib = out_dir / "libbench.so"
    log.append(nvcc([build.nvcc(), *build.LINK_FLAGS, "-o", str(lib), *map(str, objs)]))
    return lib, "".join(log)


def load(build, lib: Path, kinds) -> ctypes.CDLL:
    """The library with the entry points of `kinds` that it holds typed as
    build.load types them (the package's wrappers call nothing else of it)."""
    dll = ctypes.CDLL(str(lib))
    for name in (n for k in kinds for n in ENTRIES[k]):
        if hasattr(dll, name):
            fn = getattr(dll, name)
            fn.argtypes = build.SIGNATURES[name]
            fn.restype = ctypes.c_int
    return dll


def k1_shapes(cs, ctx, dev, gen) -> tuple[dict, tuple]:
    """K1 at chip_smoke.py's K1 rows (fwd (3,16) and inv (2,16) over QP, the
    main path's fwd (2,12) and inv (1,12) over Q) and, where the package has
    the split entry, its passes at D = 2, 4, 8 on 12 rows (phase 19's shapes);
    also (Q tables, x, its transform) for the split transforms, or None."""
    from heongpu_tpu_torch.ops import ntt as nttm
    out = {}
    for tb, polys, inverse in ((ctx.ntt_qp, 3, False), (ctx.ntt_qp, 2, True),
                               (ctx.ntt_q(0), 2, False), (ctx.ntt_q(0), 1, True)):
        out.update(cs.ntt_shapes(tb, polys, inverse, gen, dev))
    if not hasattr(nttm, "ntt_pass_cuda"):
        return out, None
    tq = ctx.ntt_q(0)
    x = cs.rand_residues(list(tq.primes), (tq.num_limbs, tq.n), gen, dev)
    y = nttm.ntt_cuda(x, tq, False)
    out.update(cs.split_pass_shapes(tq, x, y))
    return out, (tq, x, y)


def shapes(cs, dev, gen, kinds) -> tuple[dict, tuple]:
    """({n: chip_smoke time_kernels entries}, K1's split-transform inputs or
    None): the kernels of `kinds` at the shapes chip_smoke.py times them, on
    contexts made from its constants as its phases make them (and K6 on the
    v2 chain at four levels)."""
    from heongpu_tpu_torch.models import bfv, bgv, ckks
    from heongpu_tpu_torch.utils import params

    def halves(ctx, chain, n):
        primes = list(ctx.qp_primes[:chain.k]) + list(ctx.p_primes[:len(chain)])
        return cs.rand_residues(primes, (len(primes), n), gen, dev).repeat(2, 1, 1)

    out, split = {N16: {}, N15: {}}, None
    # phase 7: the main path's context (K1's rows, phase 19's split passes, K6 on a
    # keyswitch's halves); phase 18 (c): MPC CKKS's draws
    ctx = ckks.make_context(N16, cs.Q_BITS, ks_type="II", alpha=cs.ALPHA, device=dev)
    if "k1" in kinds:
        entries, split = k1_shapes(cs, ctx, dev, gen)
        out[N16].update(entries)
    if "k6" in kinds:
        out[N16].update(cs.div_shapes(ctx.ks2[0].div_stages,
                                      halves(ctx, ctx.ks2[0].div_stages, N16),
                                      "main-path keyswitch"))
    if "k7" in kinds:
        out[N16].update(cs.threefry_bits_shapes((len(cs.Q_BITS), N16), dev,
                                                f"ckks ({len(cs.Q_BITS)}, N)"))
        out[N16].update(cs.threefry_bits_shapes((N16,), dev, "ckks (N,)"))
    if not {"k6", "k7"} & set(kinds):
        return out, split
    # phase 13: the depth-48 chain (K7 at its widest seeded key, 12 digits of 54 limbs)
    ctx = ckks.make_context(N16, cs.BOOT_Q_BITS, device=dev, **cs.BOOT_CTX)
    if "k7" in kinds:
        from heongpu_tpu_torch.utils import threefry
        qp, digits = list(ctx.qp_primes), (len(ctx.ks2[0].groups), N16)
        out[N16].update(cs.threefry_shapes(qp, digits, dev, "bootstrap key"))
        # one rank's block of the same key on a 4-way limb mesh, where the root's K7
        # takes a row range
        if "rows" in inspect.signature(threefry.uniform_rns_cuda).parameters:
            out[N16].update(cs.threefry_shapes(qp, digits, dev, "bootstrap key, a rank's block",
                                               rows=cs.k7_row_blocks(len(qp))[1]))
    if "k6" in kinds:
        out[N16].update(cs.div_shapes(ctx.ks2[0].div_stages,
                                      halves(ctx, ctx.ks2[0].div_stages, N16),
                                      "depth-48 keyswitch"))
        # phase 14: the v2 chain's p = 6 at 19, 16, 10 and 4 Q limbs
        ctx = ckks.make_context(N16, cs.V2_Q_BITS, device=dev, **cs.V2_CTX)
        for lvl in (0, 3, 9, 15):
            chain = ctx.ks2[lvl].div_stages
            out[N16].update(cs.div_shapes(chain, halves(ctx, chain, N16),
                                          f"v2 keyswitch k={chain.k}"))
    # phase 15 (b): BFV's Method-I ÷P; phase 18 (b): MPC BFV's draws
    ctx = bfv.make_context(cs.BFV_N, params.plain_modulus_for(cs.BFV_N, cs.BFV_T_BITS), device=dev)
    if "k6" in kinds:
        out[N15].update(cs.div_shapes(ctx.div_p.chain, halves(ctx, ctx.div_p.chain, N15),
                                      "Method I"))
    if "k7" in kinds:
        out[N15].update(cs.threefry_bits_shapes((ctx.k, N15), dev, f"bfv ({ctx.k}, N)"))
        out[N15].update(cs.threefry_bits_shapes((N15,), dev, "bfv (N,)"))
    # phase 17 (b): BGV's t-exact keyswitch and mod switch, its relin key's half
    ctx = bgv.make_context(cs.BGV_N, params.plain_modulus_for(cs.BGV_N, 20), q_bits=cs.BGV_Q_BITS,
                           sec_level=cs.BGV_SEC, device=dev)
    qp = list(ctx.qp_primes)
    if "k6" in kinds:
        out[N15].update(cs.exact_shapes(ctx.div_p_lvl[0].chain,
                                        halves(ctx, ctx.div_p_lvl[0].chain, N15), "keyswitch"))
        chain = ctx.mod_sw[0].chain
        x = cs.rand_residues(qp[:chain.k + 1], (chain.k + 1, N15), gen, dev).repeat(2, 1, 1)
        out[N15].update(cs.exact_shapes(chain, x, "mod_switch"))
    if "k7" in kinds:
        out[N15].update(cs.threefry_shapes(qp, (ctx.k, N15), dev, "BGV relin key"))
    return out, split


def print_sass(cs, name, lib):
    for kern in ("threefry_uniform", "threefry_bits"):
        m = cs.sass_mix(lib, f"{kern}_kernel")
        count = lambda pre: sum(v for k, v in m.items() if k.startswith(pre))
        print(f"SASS {name} {kern}: {sum(m.values())} instructions; {count('SHF.L.W')} funnel "
              f"shifts, {m.get('LOP3.LUT', 0)} LOP3, {count('IMAD')} IMAD, {count('IADD3')} "
              f"IADD3, {count('VIMNMX') + count('IMNMX')} IMNMX; "
              + json.dumps(dict(sorted(m.items(), key=lambda kv: -kv[1]))))


def copy_ms(cs, entry):
    """Device ms of torch's copy of as many words as a K6 entry writes."""
    import torch
    out = entry[0]()
    src = torch.empty_like(out)
    per_kernel = cs.device_idle_share(lambda: out.copy_(src), 20)[3]
    return sum(per_kernel.values()) if per_kernel else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--kernels", default="k1,k6,k7",
                    help="comma-separated subset of k1, k6, k7 (default all)")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    kinds = tuple(k for k in SOURCES if k in args.kernels.split(","))
    if not kinds:
        raise SystemExit(f"--kernels: none of {tuple(SOURCES)} in {args.kernels!r}")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA card")
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.kernels import build
    assert Path(build.__file__).resolve().is_relative_to(args.root.resolve())
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"{args.label}: heongpu_tpu_torch from {args.root}, kernels {kinds} [{card}]")

    # the variants rebuild K6's and K7's sources only and time only their shapes
    tuned = tuple(k for k in kinds if k != "k1")
    builds = [("base", {}, kinds)] + ([(n, d, tuned) for n, d in VARIANTS]
                                       if args.variants and tuned else [])
    tmp = Path(tempfile.mkdtemp(prefix="kernel_bench_"))
    dirs = [tmp / str(i) for i in range(len(builds))]
    for d in dirs:
        d.mkdir()
    with ThreadPoolExecutor(min(len(builds), os.cpu_count() or 1)) as pool:
        built = list(pool.map(lambda b, d: compile_lib(build, d, b[1], b[2]), builds, dirs))
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    cases, split = shapes(cs, dev, gen, kinds)
    kind_of = {"ntt_fwd": "k1", "ntt_inv": "k1", "ntt_pass": "k1", "div_round": "k6",
               "div_exact_t": "k6", "threefry_uniform": "k7", "threefry_bits": "k7"}
    records = {"label": args.label, "root": str(args.root), "card": card, "kernels": {},
               "split_transform_device_ms": []}
    errs = defaultdict(int)
    for (name, _, built_kinds), (lib, log) in zip(builds, built):
        for fn, line in cs.ptxas_summary(log, "_kernel").items():
            print(f"ptxas {name} {fn}: {line}")
        if k1 := cs.ptxas_summary(log, "ntt_"):
            spills = [fn for fn, line in k1.items() if re.search(r"[1-9]\d* bytes spill", line)]
            print(f"ptxas {name} K1: {len(k1)} pass instances, spilling: {spills or 'none'}")
        if "k7" in built_kinds:
            print_sass(cs, name, lib)
        kernels._lib = load(build, lib, built_kinds)
        for rep in range(args.repeat):
            for n, entries in cases.items():
                mine = {k: v for k, v in entries.items() if kind_of[k.split()[0]] in built_kinds}
                for label, rec in cs.time_kernels(mine, f"{args.label}, {name}", n, card,
                                                  errs).items():
                    records["kernels"].setdefault(f"{name} {label}", []).append(rec)
            if name == "base" and split:
                records["split_transform_device_ms"].append(
                    cs.split_transform_ms(*split, card, label=f" at {args.label}"))
        if name == "base" and "k6" in kinds:
            for label, entry in cases[N16].items():
                if label.startswith("div_round"):
                    ms = copy_ms(cs, entry)
                    records["kernels"][f"copy {label}"] = [{"device_ms": ms}]
                    print(f"time copy of the output's words at {label}: device "
                          f"{cs.fmt_ms(ms)} ms [{card}]")
    kernels._lib = None
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
