"""Where the fused keyswitch kernel K5 spends its time on the card.

Builds an instrumented copy of csrc/keyswitch.cu into the build directory:
thread 0 of every block reads the card's global timer (%globaltimer, ns) at
the kernel's start, before and after each grid-wide barrier and at its end,
so each block's time splits into phase A (digit build, forward pass 1), the
wait at the first barrier, phase B (forward pass 2, MAC, inverse pass 1),
the wait at the second barrier and phase C (inverse pass 2).  Runs K5 at the
chip_smoke bench shape (N=2^16, twelve 29-bit Q primes, alpha=4: level 0
with 3 digits over 16 limbs, and level 1) on random inputs, checks that the
instrumented copy returns the kernel's bits, and prints per phase the mean
and the largest time over the blocks, the kernel's time by CUDA events and
the card's name and power limit.

    python -m heongpu_tpu_torch.kernels.keyswitch_phases
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from . import build

STAMPS = 6          # start, A done, barrier 1 passed, B done, barrier 2 passed, end
MAX_BLOCKS = 1024
REPS = 20
# (text of csrc/keyswitch.cu, the same text with a stamp beside it); each must occur once
MARKS = (
    ("  cg::grid_group grid = cg::this_grid();\n",
     "  cg::grid_group grid = cg::this_grid();\n  STAMP(0);\n"),
    ("  grid.sync();\n  const int nb", "  STAMP(1);\n  grid.sync();\n  STAMP(2);\n  const int nb"),
    ("  grid.sync();\n  const int nc", "  STAMP(3);\n  grid.sync();\n  STAMP(4);\n  const int nc"),
    ("phase_c<L1, L2>(P, sm, it);\n}", "phase_c<L1, L2>(P, sm, it);\n  STAMP(5);\n}"),
    ('#include "ntt_cols.cuh"',
     '#include "ntt_cols.cuh"\n'
     f"__device__ unsigned long long g_stamp[{MAX_BLOCKS}][{STAMPS}];\n"
     "#define STAMP(k) if (threadIdx.x == 0) { unsigned long long now; "
     'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now)); '
     "g_stamp[blockIdx.x][k] = now; }\n//"),
)
READOUT = """
extern "C" int hf_stamp_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
}
"""


def instrumented_source() -> str:
    src = (build.CSRC / "keyswitch.cu").read_text()
    for old, new in MARKS:
        if src.count(old) != 1:
            raise RuntimeError(f"keyswitch.cu no longer holds the marker {old!r} once")
        src = src.replace(old, new)
    return src + READOUT


def build_instrumented() -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "keyswitch_phases.cu"
    so = build.BUILD_DIR / "libkeyswitch_phases.so"
    cu.write_text(instrumented_source())
    build._run([build.nvcc(), *build.COMPILE_FLAGS, f"-I{build.CSRC}", "-shared", "-o", str(so),
                str(cu)])
    lib = ctypes.CDLL(str(so))
    lib.hf_keyswitch2_fused.argtypes = build.SIGNATURES["hf_keyswitch2_fused"]
    lib.hf_keyswitch2_fused.restype = ctypes.c_int
    lib.hf_stamp_read.argtypes = [ctypes.c_void_p]
    lib.hf_stamp_read.restype = ctypes.c_int
    return lib


def main() -> int:
    from ..models import ckks
    from ..ops import keyswitch_fused as ksf
    from . import stream_of

    if not torch.cuda.is_available():
        raise SystemExit("keyswitch_phases times the kernel on a CUDA card; none is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    lib = build_instrumented()
    dev = torch.device("cuda")
    ctx = ckks.make_context(1 << 16, [29] * 12, ks_type="II", alpha=4, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    for level in (0, 1):
        lvl, tb, ka = ctx.ks2[level], ctx.ntt_qp_at(level), ctx.active(level)
        d, kqp, n = len(lvl.groups), tb.num_limbs, ctx.n
        rand = lambda primes, shape: torch.remainder(
            torch.randint(0, 1 << 62, shape, generator=gen, device=dev),
            torch.tensor(primes, device=dev).view(-1, 1)).to(torch.int32)
        z = rand(ctx.q_primes[:ka], (ka, n))
        k0, k1 = (rand(list(tb.primes) * d, (d * kqp, n)).view(d, kqp, n) for _ in range(2))
        mat = ksf.build_fused_mat(lvl, kqp)
        out = torch.empty((2, kqp, n), dtype=torch.int32, device=dev)
        s1 = torch.empty((d, kqp, n), dtype=torch.int32, device=dev)
        s2 = torch.empty_like(out)
        tabs = [getattr(tb, name) for name in ksf._TABLES]
        args = (z.data_ptr(), mat.data_ptr(), k0.data_ptr(), k1.data_ptr(), s1.data_ptr(),
                s2.data_ptr(), out.data_ptr(), ka, kqp, d, mat.shape[0] // d, tb.n1, tb.n2,
                *(t.data_ptr() for t in tabs), stream_of(z))
        if lib.hf_keyswitch2_fused(*args):
            raise RuntimeError("the instrumented K5 failed to launch")
        if not torch.equal(out, ksf.keyswitch2_fused_cuda(z, mat, k0, k1, tb, lvl.groups)):
            raise AssertionError("the instrumented K5 differs from the kernel")
        spans = []
        for _ in range(REPS):
            lib.hf_keyswitch2_fused(*args)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (MAX_BLOCKS * STAMPS))()
            if lib.hf_stamp_read(ctypes.addressof(buf)):
                raise RuntimeError("reading the instrumented K5's stamps failed")
            st = np.array(buf[:], np.float64).reshape(MAX_BLOCKS, STAMPS)
            st = st[st[:, 0] > 0]
            spans.append(np.diff(st, axis=1) / 1e3)           # (blocks, 5) in us
            spans[-1] = np.column_stack([spans[-1], (st[:, -1].max() - st[:, 0].min()) / 1e3
                                         * np.ones(len(st))])
        sp = np.stack(spans)                                   # (reps, blocks, 6)
        ksf_ms = _event_ms(lambda: ksf.keyswitch2_fused_cuda(z, mat, k0, k1, tb, lvl.groups))
        print(f"K5 level {level} (z {tuple(z.shape)}, {d} digits, {kqp} limbs, {sp.shape[1]} "
              f"blocks): kernel {ksf_ms:.4f} ms by CUDA events; instrumented, per launch, "
              f"mean over {REPS} launches [{card}]")
        names = ("A: digit build + forward pass 1", "wait at barrier 1",
                 "B: forward pass 2 + MAC + inverse pass 1", "wait at barrier 2",
                 "C: inverse pass 2", "first start to last end")
        for i, name in enumerate(names):
            v = sp[:, :, i]
            print(f"  {name:42s} mean over blocks {v.mean():8.2f} us, largest {v.max(1).mean():8.2f} us")
    return 0


def _event_ms(fn, reps: int = REPS) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


if __name__ == "__main__":
    raise SystemExit(main())
