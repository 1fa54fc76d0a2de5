"""Where a step of the TFHE blind-rotation kernels (K3, K4) spends its time on
the card.

Builds an instrumented copy of csrc/tfhe.cu into the build directory: thread 0
of block 0 reads clock64() after each block barrier of the chain and adds the
cycles since the previous one to the phase that just ended:
  A  the INTT of the rows to decompose (K3: X^a*acc - acc, formed as they load),
  B  the CRT to the torus,
  C  the gadget digits and their forward NTT, and the wait for the staged key,
  D  the external product,
  R-A, R-B, R-C  the same phases of a renormalisation.
Runs K3 and K4 at STD128 (n=512) on B=8 gates with keys from a seeded
generator, checks that the instrumented copy returns the kernel's bits, and
prints each phase's cycles and microseconds per step (per pair step for K4),
its share, and the card's name and power limit.

    python -m heongpu_tpu_torch.kernels.tfhe_phases
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from . import build

PHASES = ("A", "B", "C", "D", "R-A", "R-B", "R-C")  # by counter index
BATCH, REPS = 8, 5
# (text of csrc/tfhe.cu, the same text with the clock read after it); each must
# occur once
MARKS = (
    ("    __syncthreads();\n\n    // B. CRT",
     "    __syncthreads();\n    PHASE(renorm ? 4 : 0);\n\n    // B. CRT"),
    ("    crt_rows(tmp, L, T, renorm ? 0u : kOffset);\n    __syncthreads();\n",
     "    crt_rows(tmp, L, T, renorm ? 0u : kOffset);\n    __syncthreads();\n"
     "    PHASE(renorm ? 5 : 1);\n"),
    ("    if (renorm) {\n      __syncthreads();\n",
     "    if (renorm) {\n      __syncthreads();\n      PHASE(6);\n"),
    ("    __pipeline_wait_prior(0);\n    __syncthreads();\n",
     "    __pipeline_wait_prior(0);\n    __syncthreads();\n    PHASE(2);\n"),
    ("    __syncthreads();\n    if (i + 1 < steps) stage_key",
     "    __syncthreads();\n    PHASE(3);\n    if (i + 1 < steps) stage_key"),
    ("  while (i < steps) {", "  long long t_last = clock64();\n  while (i < steps) {"),
    ('#include "ntt_common.cuh"',
     '#include "ntt_common.cuh"\n__device__ unsigned long long g_phase[2][8];\n'
     "#define PHASE(k) if (t == 0 && gate == 0) { const long long now = clock64(); "
     "g_phase[UNROLLED][k] += now - t_last; t_last = now; }\n//"),
)
READOUT = """
extern "C" int hf_phase_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
extern "C" int hf_phase_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
"""


def instrumented_source() -> str:
    src = (build.CSRC / "tfhe.cu").read_text()
    for old, new in MARKS:
        if src.count(old) != 1:
            raise RuntimeError(f"tfhe.cu no longer holds the marker {old!r} once")
        src = src.replace(old, new)
    return src + READOUT


def build_instrumented() -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "tfhe_phases.cu"
    so = build.BUILD_DIR / "libtfhe_phases.so"
    cu.write_text(instrumented_source())
    build._run([build.nvcc(), *build.COMPILE_FLAGS, f"-I{build.CSRC}", "-shared", "-o", str(so),
                str(cu)])
    lib = ctypes.CDLL(str(so))
    lib.hf_blind_rotate.argtypes = build.SIGNATURES["hf_blind_rotate"]
    return lib


def main() -> int:
    from ..models import tfhe
    from ..ops import tfhe_kernel as tk
    from ..utils import rng

    if not torch.cuda.is_available():
        raise SystemExit("tfhe_phases times the kernels on a CUDA card; none is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    lib = build_instrumented()
    dev = torch.device("cuda")
    ctx = tfhe.make_context(device=dev)
    g = rng.new_generator(11, dev)
    sk = tfhe.keygen_secret(g, ctx.n, device=dev)
    keys = {"K3 blind_rotate": (tfhe.keygen_boot(ctx, g, sk).bk, False),
            "K4 blind_rotate2": (tfhe.keygen_boot_unrolled(ctx, g, sk).bk2, True)}
    bits = np.random.default_rng(5).integers(0, 2, BATCH)
    acc, a_t = tfhe._boot_prologue(ctx, tfhe.encrypt(ctx, sk, bits, g))
    stream = torch.cuda.current_stream().cuda_stream
    for name, (key, unrolled) in keys.items():
        out = torch.empty_like(acc)
        launch = tk.launch_args(acc, out, a_t, key, ctx, unrolled)
        lib.hf_blind_rotate(*launch, stream)
        if not torch.equal(out, tk.blind_rotate_cuda(acc, a_t, key, ctx, unrolled)):
            raise AssertionError(f"the instrumented {name} differs from the kernel")
        lib.hf_phase_reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            lib.hf_blind_rotate(*launch, stream)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / REPS
        buf = (ctypes.c_ulonglong * 16)()
        lib.hf_phase_read(buf)
        cyc = np.array(buf[:], np.float64).reshape(2, 8)[int(unrolled), :len(PHASES)] / REPS
        steps = ctx.n // 2 if unrolled else ctx.n
        ghz = cyc.sum() / (ms * 1e6)
        print(f"{name} (B={BATCH}, n={ctx.n}, instrumented): {ms:.4f} ms, "
              f"{ghz:.3f} GHz over the chain [{card}]")
        for phase, c in zip(PHASES, cyc):
            print(f"  {phase:4s} {c / steps:9.1f} cycles {c / steps / ghz / 1e3:7.3f} us per step, "
                  f"share {c / cyc.sum():.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
