"""A run of each cell (its tiny twin on the CPU, past the harness's look for
a card) with the timed path broken underneath comes out not correct: once
for each fault the cell can have.  A step that returns its state unchanged;
half of the batch left out; an answer altered where it is produced.  (One
card: no exchange between chips to leave out.)  And each cell's control
reads at least three times what the sound program reads at the same size."""

import dataclasses
import json

import pytest
import torch

from fhebench import spec
from heongpu_tpu_torch.models import ckks, ckks_boot, tfhe, tfhe_int

from . import tiny


@pytest.fixture(scope="module")
def bench():
    return tiny.TinyBench()


ADD = tfhe_int.add


def _flip_one(ct: tfhe.Ciphertext) -> tfhe.Ciphertext:
    """ct with its first sample negated: its bit flips."""
    a, b = ct.a.clone(), ct.b.clone()
    a[0], b[0] = -a[0], -b[0]
    return dataclasses.replace(ct, a=a, b=b)


def _half(ct: tfhe.Ciphertext) -> tfhe.Ciphertext:
    keep = ct.a.shape[0] // 2
    return dataclasses.replace(ct, a=ct.a[:keep], b=ct.b[:keep])


def _nudge(ct: ckks.Ciphertext) -> ckks.Ciphertext:
    """ct with one residue of its first part moved by one."""
    c = ct.c.clone()
    c[0, 0, 3] += 1
    return dataclasses.replace(ct, c=c)


def _on_sum(fault, *args):
    """tfhe_int.add with `fault` applied to the sum's bit samples."""
    total, carry = ADD(*args)
    return dataclasses.replace(total, bits=fault(total.bits)), carry


NAND = tfhe.NAND
BOOT = ckks_boot.regular_bootstrap
ROTATE = ckks.rotate
FAULTS = {
    "std128.nand-b128": {
        "unchanged": (tfhe, "NAND", lambda ctx, bk, c1, c2: c1),
        "half_batch": (tfhe, "NAND", lambda *a: _half(NAND(*a))),
        "altered": (tfhe, "NAND", lambda *a: _flip_one(NAND(*a))),
    },
    "std128.huint8-add": {
        "unchanged": (tfhe_int, "add", lambda ctx, bk, x, y: (x, ADD(ctx, bk, x, y)[1])),
        "half_batch": (tfhe_int, "add", lambda *a: _on_sum(_half, *a)),
        "altered": (tfhe_int, "add", lambda *a: _on_sum(_flip_one, *a)),
    },
    "d48.boot": {
        "unchanged": (ckks_boot, "regular_bootstrap", lambda ctx, ct, keys: ct),
        "altered": (ckks_boot, "regular_bootstrap", lambda *a: _nudge(BOOT(*a))),
    },
    "d48.leveled": {
        "unchanged": (ckks, "rotate", lambda ctx, a, gk, step: a),
        "altered": (ckks, "rotate", lambda *a: _nudge(ROTATE(*a))),
    },
}
CASES = [(cell, fault) for cell, faults in FAULTS.items() for fault in faults]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_a_broken_path_is_not_correct(bench, monkeypatch, cell, fault):
    mod, name, broken = FAULTS[cell][fault]
    monkeypatch.setattr(mod, name, broken)
    result = tiny.run(bench, cell)
    assert result["attempted"] >= 1 and not result["correct"] and result["failed"] >= 1


def _chosen_control(cell: str) -> tuple[str, dict]:
    limits = spec.Bench().limits(cell)
    return limits["control"], limits["controls"][limits["control"]]


# The number each cell's control is read by, at the tiny sizes too.  d48.boot's
# control (EvalMod's Taylor series a degree lower) reads 16x the sound program
# only at N=2^16, where the mod-raise's overflow reaches further than at any N
# the CPU can hold (1.4x at N=1024); test_fhebench_card.py holds it there.
READ_BY = {"d48.leveled": "slot_err_max", "std128.nand-b128": "phase_rms",
           "std128.huint8-add": "phase_rms"}


@pytest.mark.parametrize("cell", sorted(READ_BY))
def test_the_control_reads_three_times_the_sound_program(bench, cell):
    name, overrides = _chosen_control(cell)
    sound = tiny.run(bench, cell)["checks"][READ_BY[cell]]["value"]
    control = tiny.run(bench, cell, overrides=overrides)["checks"][READ_BY[cell]]["value"]
    assert control >= 3 * sound, json.dumps({"control": name, "sound": sound, "read": control})
