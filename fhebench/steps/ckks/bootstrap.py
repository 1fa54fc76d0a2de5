"""One regular bootstrap (ckks_boot.regular_bootstrap) with the
configuration's whole bootstrapping key set.  Where the program starts with
it, the input is encoded at the keys' message scale, encrypted at level 0
and dropped to the bootstrap's base limbs."""

from heongpu_tpu_torch.models import ckks, ckks_boot


def keys(cell, step, g, sk):
    cell.keys["boot"] = ckks_boot.generate_bootstrap_keys(
        cell.ctx, g, sk, ckks_boot.BootConfig(**cell.cfg["boot"]))


def encrypt_input(cell, step, values, pk, g):
    ctx, keys = cell.ctx, cell.keys["boot"]
    ct = ckks.encrypt(ctx, pk, ckks.encode(ctx, values, scale=keys.msg_scale), g)
    return ckks.mod_drop(ctx, ct, ctx.k - keys.cfg.base_count - ct.level)


def run(cell, step, x, prepared, i, warm):
    with cell.spans("regular_bootstrap"):
        x = ckks_boot.regular_bootstrap(cell.ctx, x, cell.keys["boot"])
    return x, [()], {"bootstraps": 1}


def limbs_out(cell, step, limbs):
    return cell.cfg["guarantees"]["boot_limbs_out"]
