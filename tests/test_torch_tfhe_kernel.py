"""The tables and checks around the TFHE blind-rotation kernels K3/K4, on the
CPU: the one-lookup X^a table equals the product of the six radix-4 digit
tables for every rotation amount, its exponents are 2·eval_order(N)+1, the
wrapper's arguments match the C entry point, and the chain wrappers reject
what the kernels cannot take.  No jax: the digit tables were held against the
JAX package's in tests/test_torch_tfhe.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu_torch.kernels import build  # noqa: E402
from heongpu_tpu_torch.models import tfhe  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.ops import tfhe_kernel as tk  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ctx():
    return tfhe.make_context(16, device="cpu")


def test_omega_exps_are_the_eval_order(ctx):
    want = 2 * tntt.eval_order(ctx.N).astype(np.int64) + 1
    assert ctx.omega_exps.dtype == torch.int32 and ctx.omega_exps.shape == (ctx.N,)
    np.testing.assert_array_equal(ctx.omega_exps.numpy(), want)


@pytest.mark.parametrize("limb", [0, 1])
def test_omega_pow_lookup_matches_digit_tables(ctx, limb):
    """For every rotation amount a in [0, 2N): the entry at (e[pos]·a) mod 2N
    equals _omega_mont(ctx, a), the product of the six digit tables."""
    two_n = 2 * ctx.N
    a = torch.arange(two_n, dtype=torch.int64)
    idx = (ctx.omega_exps.to(torch.int64)[None, :] * a[:, None]) & (two_n - 1)
    assert ctx.omega_pows.shape == (2, two_n)
    got = ctx.omega_pows[limb][idx]                               # (2N, N)
    torch.testing.assert_close(got, tfhe._omega_mont(ctx, a)[:, limb], rtol=0, atol=0)


def test_launch_args_match_the_c_signature(ctx):
    acc = torch.zeros((2, 2, 2, ctx.N), dtype=torch.int32)
    a_t = torch.zeros((2, ctx.n), dtype=torch.int32)
    key = torch.zeros((ctx.n, 4, 2, 2, ctx.N), dtype=torch.int32)
    args = tk.launch_args(acc, torch.empty_like(acc), a_t, key, ctx, False)
    assert len(args) + 1 == len(build.SIGNATURES["hf_blind_rotate"])
    inv, inv_sh = args[-2:]
    assert inv == ctx.p1_inv_p2 and inv_sh == (inv << 32) // ctx.primes[1] < 1 << 32


def _bad_inputs(ctx):
    """(acc, a_t, key, ctx, unrolled) cases the chain must reject."""
    N, n = ctx.N, ctx.n
    acc = torch.zeros((3, 2, 2, N), dtype=torch.int32)
    a_t = torch.zeros((3, n), dtype=torch.int32)
    bk = torch.zeros((n, 4, 2, 2, N), dtype=torch.int32)
    bk2 = torch.zeros((n // 2, 3, 4, 2, 2, N), dtype=torch.int32)
    return {
        "int64 acc": (acc.to(torch.int64), a_t, bk, ctx, False),
        "non-contiguous a_t": (acc, a_t.t().contiguous().t(), bk, ctx, False),
        "acc batch": (acc[:2].contiguous(), a_t, bk, ctx, False),
        "key steps": (acc, a_t, bk[:8].contiguous(), ctx, False),
        "n not a multiple of 8": (acc, a_t[:, :12].contiguous(), bk[:12].contiguous(), ctx, False),
        "BootKey for K4": (acc, a_t, bk, ctx, True),
        "BootKey2 for K3": (acc, a_t, bk2, ctx, False),
        "meta tensors": (acc.to("meta"), a_t.to("meta"), bk.to("meta"), ctx, False),
        "primes above 2**30": (acc, a_t, bk, dataclasses.replace(ctx, primes=(2**30 + 3, 2**30 + 5)),
                               False),
        "primes below 2**29": (acc, a_t, bk, dataclasses.replace(ctx, primes=(2**29 - 3, 2**29 - 5)),
                               False),
    }


@pytest.mark.parametrize("case", ["int64 acc", "non-contiguous a_t", "acc batch", "key steps",
                                  "n not a multiple of 8", "BootKey for K4", "BootKey2 for K3",
                                  "meta tensors", "primes above 2**30", "primes below 2**29"])
def test_chain_rejects_bad_input(ctx, case):
    acc, a_t, key, c, unrolled = _bad_inputs(ctx)[case]
    with pytest.raises(ValueError):
        tk._check(acc, a_t, key, c, unrolled)
    with pytest.raises(ValueError):
        tk.blind_rotate_cuda(acc, a_t, key, c, unrolled)


def test_cuda_wrapper_rejects_cpu_tensors(ctx):
    acc = torch.zeros((1, 2, 2, ctx.N), dtype=torch.int32)
    a_t = torch.zeros((1, ctx.n), dtype=torch.int32)
    key = torch.zeros((ctx.n, 4, 2, 2, ctx.N), dtype=torch.int32)
    tk._check(acc, a_t, key, ctx, False)
    with pytest.raises(ValueError, match="CUDA"):
        tk.blind_rotate_cuda(acc, a_t, key, ctx)
