"""CKKS cells: a context, a secret key and the keys the traffic's program
needs, all made from the seed; a pool of encrypted inputs; requests that run
the program through the port's CKKS operations; and the check of the
outputs against the plain reference (fhebench/reference/ckks.py).

The program (the traffic file's "program") is a list of steps, each
{"op": <name>, ...its parameters}.  Operation <name> is the module
fhebench/steps/ckks/<name>.py; its plain meaning is
fhebench/reference/steps/ckks/<name>.py.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from heongpu_tpu_torch.models import ckks, ringkit
from heongpu_tpu_torch.ops import modmath as mm
from heongpu_tpu_torch.ops import ntt as nttm
from heongpu_tpu_torch.utils import rng

from .. import steps
from ..reference import ckks as ref
from . import draws, timed


def secret_coeffs(draw: np.random.Generator, n: int, weight: int) -> np.ndarray:
    """A ternary secret with `weight` nonzero coefficients of random sign."""
    s = np.zeros(n, np.int64)
    s[draw.choice(n, weight, replace=False)] = draw.choice([-1, 1], weight)
    return s


def port_secret(ctx, s: torch.Tensor, weight: int) -> ringkit.SecretKey:
    """The port's secret key for the coefficients s, as its key generation
    lays one out (the evaluation domain over Q and P, Montgomery form)."""
    b = ctx.base_qp
    s_ev = nttm.ntt_fwd(rng.signed_to_rns(s, ctx.qp_primes), ctx.ntt_qp)
    return ringkit.SecretKey(s, mm.to_mont(s_ev, b.col(), b.col("r1")), weight)


def slots(draw: np.random.Generator, kind: str, count: int) -> np.ndarray:
    if kind == "real_uniform":
        return draw.uniform(-1.0, 1.0, count).astype(np.complex128)
    if kind == "unit_circle":
        return np.exp(2j * np.pi * draw.uniform(0.0, 1.0, count))
    raise ValueError(f"unknown slot distribution {kind!r}")


class Cell:
    """Set-up at construction; request(i) issues one request and returns
    (output ciphertext, record) without waiting for the device."""

    def __init__(self, config: dict, traffic: dict, seed: int, devices, spans):
        self.cfg, self.tr, self.spans = config, traffic, spans
        self.dev = torch.device(devices[0])
        self.setup_parts = parts = {}
        n = config["n"]
        with timed(parts, "context", self.dev):
            ctx = ckks.make_context(n, config["q_bits"], scale_bits=config["scale_bits"],
                                    ks_type=config["ks_type"], alpha=config["alpha"],
                                    p_count=config["p_count"], device=self.dev)
        if (list(ctx.q_primes), list(ctx.p_primes)) != (config["q_primes"], config["p_primes"]):
            raise RuntimeError("the port's context has other primes than the configuration")
        self.ctx = ctx
        self.program = [(step, steps.load("ckks", step["op"])) for step in traffic["program"]]
        with timed(parts, "keys", self.dev):
            self.s = secret_coeffs(draws(seed, 1), n, config["secret_hamming_weight"])
            sk = port_secret(ctx, torch.from_numpy(self.s).to(torch.int32).to(self.dev),
                             config["secret_hamming_weight"])
            g = rng.new_generator(seed % (1 << 63), self.dev)
            pk = ckks.keygen_public(ctx, g, sk)
            self.keys = {}
            for step, mod in self.program:
                if hasattr(mod, "keys"):
                    mod.keys(self, step, g, sk)
        with timed(parts, "inputs", self.dev):
            draw = draws(seed, 2)
            scale = 2.0 ** traffic["input_scale_bits"] if "input_scale_bits" in traffic else None
            first_step, first = self.program[0]
            self.pool = []
            for _ in range(traffic["pool"]):
                values = self.slots(draw)
                if hasattr(first, "encrypt_input"):
                    ct = first.encrypt_input(self, first_step, values, pk, g)
                else:
                    ct = ckks.encrypt(ctx, pk, ckks.encode(ctx, values, scale=scale), g)
                item = {"plain": {"input": values}, "ct": ct, "prepared": {}}
                for k, (step, mod) in enumerate(self.program):
                    if hasattr(mod, "prepare"):
                        item["plain"][k], item["prepared"][k] = mod.prepare(self, step, draw, pk, g)
                self.pool.append(item)
        self.request_draw = draws(seed, 3)
        limbs = ctx.k
        for step, mod in self.program:
            limbs = mod.limbs_out(self, step, limbs)
        self.limbs_out = limbs

    def slots(self, draw: np.random.Generator) -> np.ndarray:
        """One vector of slot values from the traffic's distribution."""
        return slots(draw, self.tr["slots"], self.cfg["n"] // 2)

    def warm_requests(self) -> list:
        """Request indices that together use every shape and key the window
        uses: each pool item, and every variant of each step."""
        variants = [mod.warm_variants(step) for step, mod in self.program
                    if hasattr(mod, "warm_variants")]
        return list(range(max([len(self.pool)] + variants)))

    def trace_meta(self) -> dict:
        return {"n": self.cfg["n"], "specials": len(self.cfg["p_primes"]),
                "alpha": self.cfg["alpha"]}

    def request(self, i: int, warm: bool = False):
        item = self.pool[i % len(self.pool)]
        x, program, work = item["ct"], [], Counter()
        for k, (step, mod) in enumerate(self.program):
            x, records, done = mod.run(self, step, x, item["prepared"].get(k), i, warm)
            program += [(k, step["op"], args) for args in records]
            work.update(done)
        return x, {"pool": i % len(self.pool), "program": program, "work": dict(work)}

    def release(self):
        """Drop the keys and the pool's ciphertexts (the messages stay)."""
        self.keys = {}
        for item in self.pool:
            item.pop("ct", None)
            item.pop("prepared", None)

    def judge(self, kept, limits: dict) -> tuple[dict, int]:
        """({number: value}, outputs judged wrong) over the kept outputs: the
        largest slot error against the program run on the plain slots, and the
        count of violated guarantees (a missing or malformed output, fewer
        limbs than the configuration guarantees, limbs that disagree, a slot
        that is not finite)."""
        s = torch.from_numpy(self.s)
        err, violations, wrong = 0.0, int(not kept), 0
        for out, rec in kept:
            e, bad = math.inf, (out is None or out.size != 2 or out.c.shape[1] < self.limbs_out)
            if not bad:
                coeffs, disagree = ref.decrypt_coeffs(out.c, s, self.cfg["q_primes"])
                got = ref.decode(coeffs, out.scale)
                e = float(np.abs(got - ref.expected_slots(rec["program"],
                                                          self.pool[rec["pool"]]["plain"])).max())
                bad = disagree > 0 or not math.isfinite(e)
            err = max(err, e)
            violations += bad
            wrong += bad or e > limits["slot_err_max"]
        return {"slot_err_max": err, "violations": violations}, wrong
