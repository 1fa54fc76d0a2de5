"""Rotate by a step drawn from `steps` for each request (in turn while
warming up) and add the rotation to its input: one keyswitch."""

from heongpu_tpu_torch.models import ckks


def _key(step):
    return ("galois",) + tuple(step["steps"])


def keys(cell, step, g, sk):
    cell.keys[_key(step)] = ckks.keygen_galois(cell.ctx, g, sk, steps=step["steps"],
                                               include_conj=False)


def warm_variants(step):
    return len(step["steps"])


def run(cell, step, x, prepared, i, warm):
    ctx, sp, steps = cell.ctx, cell.spans, step["steps"]
    r = steps[i % len(steps)] if warm else int(cell.request_draw.choice(steps))
    with sp("rotate", marked=True, limbs=ctx.active(x.level)):
        y = ckks.rotate(ctx, x, cell.keys[_key(step)], r)
    with sp("add"):
        x = ckks.add(ctx, x, y)
    return x, [(r,)], {"keyswitches": 1}


def limbs_out(cell, step, limbs):
    return limbs
