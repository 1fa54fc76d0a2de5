"""One bootstrapped gate (the port's tfhe.<gate>) over a batch of `batch`
independent bit pairs, the bits uniform."""

from heongpu_tpu_torch.models import tfhe


def inputs(cell, draw, sk, g):
    x, y = draw.integers(0, 2, (2, cell.tr["batch"])).astype(bool)
    return {"plain": {"x": x, "y": y}, "cx": tfhe.encrypt(cell.ctx, sk, x, g),
            "cy": tfhe.encrypt(cell.ctx, sk, y, g)}


def run(cell, item):
    name = cell.tr["gate"]
    with cell.spans(name):
        out = getattr(tfhe, name)(cell.ctx, cell.bk, item["cx"], item["cy"])
    return out, {"gates": cell.tr["batch"]}


def samples(out):
    return out.a, out.b
