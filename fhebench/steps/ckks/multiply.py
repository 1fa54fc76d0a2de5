"""`levels` times: multiply by that level's operand, relinearize, rescale.
The operands are fresh encryptions of slots drawn at set-up, operand l
dropped to level l: the program starts this step from a fresh level-0
ciphertext.  Each relinearize is one keyswitch."""

from heongpu_tpu_torch.models import ckks


def keys(cell, step, g, sk):
    if "relin" not in cell.keys:
        cell.keys["relin"] = ckks.keygen_relin(cell.ctx, g, sk)


def prepare(cell, step, draw, pk, g):
    ctx, plain, operands = cell.ctx, {}, []
    for level in range(step["levels"]):
        plain[level] = cell.slots(draw)
        ct = ckks.encrypt(ctx, pk, ckks.encode(ctx, plain[level]), g)
        operands.append(ckks.mod_drop(ctx, ct, level))
    return plain, operands


def run(cell, step, x, operands, i, warm):
    ctx, sp = cell.ctx, cell.spans
    for level in range(step["levels"]):
        with sp("multiply"):
            x = ckks.multiply(ctx, x, operands[level])
        with sp("relinearize", marked=True, limbs=ctx.active(x.level)):
            x = ckks.relinearize(ctx, x, cell.keys["relin"])
        with sp("rescale"):
            x = ckks.rescale(ctx, x)
    return x, [(level,) for level in range(step["levels"])], {"keyswitches": step["levels"]}


def limbs_out(cell, step, limbs):
    return limbs - step["levels"]
