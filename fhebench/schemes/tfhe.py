"""TFHE cells: the configuration's context, a secret key drawn from the seed
and the bootstrapping key made from it, a pool of encrypted inputs, requests
that each run one operation of the port, and the check of the outputs
against the plain reference (fhebench/reference/tfhe.py).

The traffic's "op" names the operation: the module
fhebench/steps/tfhe/<op>.py, its plain meaning
fhebench/reference/steps/tfhe/<op>.py.  The bootstrapping key is made by the
port's tfhe.<keygen>, "keygen" given by the traffic or else the
configuration.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from heongpu_tpu_torch.models import tfhe
from heongpu_tpu_torch.utils import rng

from .. import steps
from ..reference import steps as ref_steps
from ..reference import tfhe as ref
from . import draws, timed

# Context fields the configuration states, by the configuration's key.
CONTEXT_KEYS = {"lwe_n": "n", "trlwe_n": "N", "trlwe_k": "k", "bk_l": "l", "bg_bit": "bg_bit",
                "ks_base_bit": "ks_base_bit", "ks_length": "ks_length"}


class Cell:
    """Set-up at construction; request(i) issues one request and returns
    (output, record) without waiting for the device."""

    def __init__(self, config: dict, traffic: dict, seed: int, devices, spans):
        self.cfg, self.tr, self.spans = config, traffic, spans
        dev = torch.device(devices[0])
        self.setup_parts = parts = {}
        with timed(parts, "context", dev):
            ctx = tfhe.make_context(config["lwe_n"], device=dev)
        if "ks_length" in config and config["ks_length"] != ctx.ks_length:
            ctx = dataclasses.replace(ctx, ks_length=config["ks_length"])
        stated = {k: config[k] for k in CONTEXT_KEYS} | {"primes": config["primes"]}
        made = {k: getattr(ctx, f) for k, f in CONTEXT_KEYS.items()} | {"primes": list(ctx.primes)}
        if made != stated:
            raise RuntimeError(f"the port's TFHE context {made} is not the configuration {stated}")
        self.ctx = ctx
        self.op = steps.load("tfhe", traffic["op"])
        self.plain_op = ref_steps.load("tfhe", traffic["op"])
        with timed(parts, "keys", dev):
            draw = draws(seed, 1)
            self.s_lwe = draw.integers(0, 2, config["lwe_n"])
            s_rlwe = draw.integers(0, 2, config["trlwe_n"])
            sk = tfhe.SecretKey(torch.from_numpy(self.s_lwe).to(torch.int32).to(dev),
                                torch.from_numpy(s_rlwe).to(torch.int32).to(dev))
            g = rng.new_generator(seed % (1 << 63), dev)
            self.bk = getattr(tfhe, traffic.get("keygen", config["keygen"]))(ctx, g, sk)
        with timed(parts, "inputs", dev):
            draw = draws(seed, 2)
            self.pool = [self.op.inputs(self, draw, sk, g) for _ in range(traffic["pool"])]

    def warm_requests(self) -> list:
        return list(range(len(self.pool)))

    def trace_meta(self) -> dict:
        return {"batch": self.tr.get("batch"), "lwe_n": self.cfg["lwe_n"],
                "big_n": self.cfg["trlwe_n"]}

    def request(self, i: int, warm: bool = False):
        out, work = self.op.run(self, self.pool[i % len(self.pool)])
        return out, {"pool": i % len(self.pool), "work": work}

    def release(self):
        """Drop the key and the pool's ciphertexts (the plain values stay)."""
        self.bk = None
        self.pool = [{"plain": item["plain"]} for item in self.pool]

    def judge(self, kept, limits: dict) -> tuple[dict, int]:
        """({number: value}, outputs judged wrong) over the kept outputs:
        wrong bits (gate outputs, or sum bits and carries), malformed or
        missing outputs, and the RMS distance of the outputs' phases from
        their bits' encodings as a share of the torus."""
        s = torch.from_numpy(self.s_lwe)
        wrong_bits, violations, sq, count, wrong = 0, int(not kept), 0.0, 0, 0
        for out, rec in kept:
            a, b = self.op.samples(out)
            want = self.plain_op.bits(self.tr, self.pool[rec["pool"]]["plain"])
            if a.shape != (want.size, self.cfg["lwe_n"]) or b.shape != (want.size,):
                violations += 1
                wrong += 1
                continue
            bits, gaps = ref.bits_and_gaps(ref.phases(a, b, s))
            bad = int((bits != want).sum())
            wrong_bits += bad
            sq += float((gaps ** 2).sum())
            count += gaps.size
            wrong += bad > 0
        return {"wrong_bits": wrong_bits, "violations": violations,
                "phase_rms": math.sqrt(sq / count) if count else math.inf}, wrong
