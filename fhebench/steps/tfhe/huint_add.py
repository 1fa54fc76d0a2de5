"""One tfhe_int.add of two vectors of `count` encrypted integers of `width`
bits, the integers uniform."""

import torch

from heongpu_tpu_torch.models import tfhe_int


def inputs(cell, draw, sk, g):
    w = cell.tr["width"]
    x, y = draw.integers(0, 1 << w, (2, cell.tr["count"]))
    return {"plain": {"x": x, "y": y},
            "cx": tfhe_int.encrypt_huint(cell.ctx, sk, x.tolist(), w, g),
            "cy": tfhe_int.encrypt_huint(cell.ctx, sk, y.tolist(), w, g)}


def run(cell, item):
    with cell.spans("tfhe_int.add"):
        out = tfhe_int.add(cell.ctx, cell.bk, item["cx"], item["cy"])
    return out, {"adds": 1}


def samples(out):
    total, carry = out
    return torch.cat([total.bits.a, carry.a]), torch.cat([total.bits.b, carry.b])
