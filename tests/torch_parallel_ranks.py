"""Rank programs of the port's parallel tests (tests/test_torch_parallel_*.py).

`spawn(job, world, workdir, inputs)` starts `world` gloo ranks on the CPU, each
a `python -c` process on a free port of 127.0.0.1 that joins the group with the
port's parallel.multihost.init_process(device="cpu") and runs `job(rank, world,
inputs)`; the inputs go through workdir/inputs.pt, and each rank saves what it
computed as workdir/<job>_rank<r>.pt and its output as <job>_rank<r>.log.  The
ranks' standard streams go to those files: a rank inherits none of the test
runner's pipes (a pytest-xdist worker talks to its controller over its stdin
and stdout).  The tests hold the results against the JAX package in the pytest
process.  No jax here: the ranks import torch and the port only.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

RANK_TIMEOUT = 600   # seconds for a whole start; a rank that fails leaves the others waiting


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _main(rank, world, port, job, workdir):
    from heongpu_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.init_process(f"127.0.0.1:{port}", rank, world, device="cpu")
    try:
        out = globals()[job](rank, world, torch.load(os.path.join(workdir, "inputs.pt"),
                                                     weights_only=False))
        torch.save(out, os.path.join(workdir, f"{job}_rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(job: str, world: int, workdir, inputs: dict) -> list:
    """Run `job` on `world` ranks; returns each rank's result, by rank."""
    workdir = str(workdir)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path[:0] = {[here, os.path.dirname(here)]!r}; "
            f"import torch_parallel_ranks as r; "
            f"r._main(int(sys.argv[1]), {world}, {_free_port()}, {job!r}, {workdir!r})")
    procs = []
    for rank in range(world):
        with open(os.path.join(workdir, f"{job}_rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", code, str(rank)],
                                          stdin=subprocess.DEVNULL, stdout=log,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        logs = {r: open(os.path.join(workdir, f"{job}_rank{r}.log")).read()[-3000:]
                for r in failed}
        raise RuntimeError(f"ranks {failed} of {job} failed:\n{logs}")
    return [torch.load(os.path.join(workdir, f"{job}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _coef_mesh(d: int):
    """A 'coef' mesh over ranks 0 .. d-1 (every rank of the world builds it)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(d), mesh_dim_names=("coef",))


def ntt_mesh(rank, world, inp):
    """The sharded NTT at every D of inp["ds"] on rank `rank`'s block of
    inp["x"] (lead dim 1), at the last D also on the whole as a DTensor, and
    the mesh placements of inp["arrays"] on an
    (8 / 4, 4) ('dp', 'limb') mesh, a ciphertext and the wrapped share sum on
    a party mesh."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from heongpu_tpu_torch import interop
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.ops import ntt as nttm
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.parallel import multihost
    from heongpu_tpu_torch.parallel import ntt_sharded as ns

    out = {}
    x = inp["x"]
    tb = nttm.build_ntt_tables(inp["primes"], x.shape[-1], device="cpu")
    x4 = ns.to_four_step(x, tb)
    for d in inp["ds"]:
        mesh = _coef_mesh(d)
        if rank >= d:
            continue
        fwd, inv = ns.make_sharded_ntt(mesh, tb, lead_dims=1)
        w = tb.n2 // d
        y = fwd(x4[..., rank * w:(rank + 1) * w].contiguous())
        out[("fwd", d)] = y
        out[("inv", d)] = inv(y)
    # the global array as a DTensor sharded on its last axis, over every rank
    yd = fwd(distribute_tensor(x4, mesh, [Shard(x4.ndim - 1)]))
    out["dtensor"] = (yd.to_local(), interop.to_numpy(yd), interop.to_numpy(inv(yd)))
    m = meshlib.make_mesh(world, limb_shards=4, device="cpu")
    for name, a in inp["arrays"].items():
        out[("limb", name)] = meshlib.shard_array_limb_axis(a, m).to_local()
    ct = ckks.Ciphertext(inp["ct"], 2, 0, 1.0)
    out["ct_sharding"] = meshlib.ct_sharding(m).place(inp["ct"]).to_local()
    out["ct_pytree"] = meshlib.shard_pytree_limb_axis(ct, m).c.to_local()
    out["global_mesh"] = multihost.global_mesh(limb_shards=4, device="cpu").mesh.tolist()
    share = inp["shares"][rank]
    out["shares"] = multihost.allreduce_shares(share, multihost.party_mesh(device="cpu"))
    return out


def two_process(rank, world, inp):
    """The counterpart of the JAX package's two-process run: a global mesh
    over both processes, and share sums over a party mesh."""
    from heongpu_tpu_torch.parallel import multihost
    pm = multihost.party_mesh(device="cpu")
    return {"world": dist.get_world_size(), "rank": dist.get_rank(),
            "global_mesh": multihost.global_mesh(device="cpu").mesh.tolist(),
            "float": multihost.allreduce_shares(inp["float"][rank], pm),
            "words": multihost.allreduce_shares(inp["words"][rank], pm)}


def keyswitch(rank, world, inp):
    """keyswitch2_sharded at every k of inp["ks"] on the JAX package's
    test_parallel shape; each rank saves its limb slice of (d0, d1)."""
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.parallel import keyswitch_sharded as kss
    from heongpu_tpu_torch.parallel import mesh as meshlib

    ctx = ckks.make_context(*inp["ctx_args"], device="cpu", **inp["ctx_kw"])
    ks2 = ctx.ks2[0]
    sc = kss.stack_convs(ks2)
    out = {}
    for k in inp["ks"]:
        m = meshlib.make_mesh(k, device="cpu")
        if rank >= k:
            continue
        nq, nd = ks2.num_active // k, sc.d // k
        s0, s1 = kss.keyswitch2_sharded(
            m, inp["poly"][rank * nq:(rank + 1) * nq], inp["k0"][rank * nd:(rank + 1) * nd],
            inp["k1"][rank * nd:(rank + 1) * nd], ks2, sc, ctx.ntt_qp_at(0), ctx.base_qp_at(0),
            ctx.ntt_q(0))
        out[k] = (s0, s1)
    # the same through DTensors placed by the mesh layer, at the largest k
    m = meshlib.make_mesh(world, device="cpu")
    place = lambda t, axis: meshlib.shard_array_limb_axis(t, m, axis)
    d0, d1 = kss.keyswitch2_sharded(m, place(inp["poly"], 0), place(inp["k0"], 0),
                                    place(inp["k1"], 0), ks2, sc, ctx.ntt_qp_at(0),
                                    ctx.base_qp_at(0), ctx.ntt_q(0))
    out["dtensor"] = (d0.to_local(), d1.to_local(), d0.full_tensor(), d1.full_tensor())
    return out


def _key_rows(ctx, keys) -> set:
    """The rows of both halves of every key of `keys` (KSKeys and
    GaloisKeyOnes, None skipped), a stripped key's k1 regenerated whole on
    this rank, as bytes."""
    from heongpu_tpu_torch.models import ckks, ringkit
    halves = [h for kk in keys if kk is not None
              for h in (kk.k0, ringkit.ensure_k1(lambda: ckks._key_ring(ctx, kk), kk))]
    return {bytes(row.numpy()) for h in halves for row in h.reshape(-1, h.shape[-1])}


def _stripped_without_seed(kk):
    """A stripped key with no a_seed to regenerate its k1 from."""
    import dataclasses
    return dataclasses.replace(kk, k1=None, a_seed=None)


def boot_keys(rank, world, inp):
    """The limb_align=4 bootstrap key set placed on a 4-way limb mesh: each
    Galois and relin key's local shard, and the bytes of the set and of this
    rank's shards."""
    from torch.distributed.tensor import DTensor

    from heongpu_tpu_torch.parallel import mesh as meshlib

    m = meshlib.make_mesh(world, limb_shards=world, device="cpu")
    sh = meshlib.shard_pytree_limb_axis(inp["keys"], m)
    tensors = []
    meshlib.map_tensors(sh, tensors.append)
    return {"gk": {e: (k.k0.to_local(), k.k1.to_local()) for e, k in sh.gk.keys.items()},
            "rk": (sh.rk.k0.to_local(), sh.rk.k1.to_local()),
            "all_dtensors": all(isinstance(t, DTensor) for t in tensors),
            "total_bytes": sum(t.full_tensor().nbytes for t in tensors),
            "local_bytes": sum(t.to_local().nbytes for t in tensors)}


def ckks_step(rank, world, inp):
    """The limb-sharded CKKS step (parallel/ckks_sharded.py) for each case of
    inp["cases"]: multiply -> relinearize -> rescale -> multiply (a square) ->
    relinearize on a ('dp', 'limb') mesh of all the ranks, limb_shards
    case["limb"], the ciphertexts placed by ct_sharding (batched when
    case["batched"]) and the relin key by shard_pytree_limb_axis; a case with
    case["a_seed"] takes the relin key stripped (k1 None, regenerated from
    that seed) and also applies case["gk"], a stripped GaloisKeyOne, to the
    first relinearization's output ("galois"), and records the error of a
    stripped key with no seed.  Each rank saves every op's local shard and
    whether it is sharded on 'limb', its local key shapes, and what it
    received: the rows of every irecv buffer the step posted, checked here
    against every row of the whole key (a stripped key's k1 regenerated)."""
    from torch.distributed.tensor import DTensor

    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.parallel import ckks_sharded as cks
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.utils import errors

    received = []
    post = dist.batch_isend_irecv

    def spy(ops):
        received.extend(op.tensor for op in ops if op.op is dist.irecv)
        return post(ops)

    def refuse(*a, **k):
        raise AssertionError("the sharded step gathered a DTensor")

    dist.batch_isend_irecv = spy
    DTensor.full_tensor = DTensor.redistribute = refuse
    out = {}
    for case in inp["cases"]:
        ctx = ckks.make_context(*case["ctx_args"], device="cpu", **case["ctx_kw"])
        m = meshlib.make_mesh(world, limb_shards=case["limb"], device="cpu")
        key = ckks.KSKey(case["k0"], case["k1"], case.get("a_seed"))
        rk = meshlib.shard_pytree_limb_axis(key, m)
        gk = meshlib.shard_pytree_limb_axis(case.get("gk"), m)
        place = meshlib.ct_sharding(m, batched=case["batched"]).place
        a = ckks.Ciphertext(place(case["c1"]), 2, 0, ctx.default_scale)
        b = ckks.Ciphertext(place(case["c2"]), 2, 0, ctx.default_scale)
        received.clear()
        steps = {"mult0": cks.multiply(ctx, a, b)}
        steps["relin0"] = cks.relinearize(ctx, steps["mult0"], rk)
        steps["rescale"] = cks.rescale(ctx, steps["relin0"])
        steps["mult1"] = cks.multiply(ctx, steps["rescale"], steps["rescale"])
        steps["relin1"] = cks.relinearize(ctx, steps["mult1"], rk)
        if gk is not None:
            steps["galois"] = cks.apply_galois(ctx, steps["relin0"], gk)
        key_rows = _key_rows(ctx, [key, case.get("gk")])
        got_rows = [row for buf in received for row in buf.reshape(-1, buf.shape[-1])]
        misuse = {}
        if case.get("a_seed") is not None:
            try:
                cks.relinearize(ctx, steps["mult0"], _stripped_without_seed(rk))
            except errors.ParameterError as e:
                misuse["stripped"] = str(e)
        local = lambda t: None if t is None else tuple(t.to_local().shape)
        out[case["name"]] = {
            "steps": {op: (ct.c.to_local(), ct.c.placements, ct.level) for op, ct in steps.items()},
            "key_local": (local(rk.k0), local(rk.k1)),
            "received_rows": len(got_rows),
            "received_key_rows": sum(bytes(r.numpy()) in key_rows for r in got_rows),
            "misuse": misuse}
    return out


def boot_sharded(rank, world, inp):
    """The limb-sharded bootstrap (parallel/boot_sharded.py) for each case of
    inp["cases"] on a 1 x world ('dp', 'limb') mesh: the case's key set
    (case["keys"]) placed by shard_pytree_limb_axis, the input ciphertext
    (case["c"], at its last base_count limbs) by shard_array_limb_axis; the
    blocks in regular_bootstrap's order (mod_raise, coeff_to_slot,
    eval_exp_sin twice, slot_to_coeff) and regular_bootstrap itself, or
    only coeff_to_slot on the raised input and regular_bootstrap where
    case["blocks"] is False; with case["swk"], also negate, rotate by
    case["step"] and switch_key on the raised input.  Each rank saves every result's local shard,
    placements and level, its local key shapes, and what it received,
    checked here against every row of every key, a stripped key's k1
    regenerated (the rank spies on batch_isend_irecv; full_tensor and
    redistribute raise), and the errors of a plain-tensor ciphertext and of
    stripped Galois keys with no seed."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from heongpu_tpu_torch.models import ckks, ringkit
    from heongpu_tpu_torch.parallel import boot_sharded as bs
    from heongpu_tpu_torch.parallel import ckks_sharded as cks
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.utils import errors

    received = []
    post = dist.batch_isend_irecv

    def spy(ops):
        received.extend(op.tensor for op in ops if op.op is dist.irecv)
        return post(ops)

    def refuse(*a, **k):
        raise AssertionError("the sharded bootstrap gathered a DTensor")

    dist.batch_isend_irecv = spy
    DTensor.full_tensor = DTensor.redistribute = refuse
    out = {}
    m = meshlib.make_mesh(world, limb_shards=world, device="cpu")
    for case in inp["cases"]:
        ctx = ckks.make_context(*case["ctx_args"], device="cpu", **case["ctx_kw"])
        keys = meshlib.shard_pytree_limb_axis(case["keys"], m)
        bc = keys.cfg.base_count
        ct = ckks.Ciphertext(meshlib.shard_array_limb_axis(case["c"], m), 2, ctx.k - bc,
                             keys.msg_scale)
        received.clear()
        res = {"raised": bs.mod_raise(ctx, ct, bc)}
        res["t0"], res["t1"] = bs.coeff_to_slot(ctx, res["raised"], keys)
        if case["blocks"]:
            res["s0"] = bs.eval_exp_sin(ctx, res["t0"], keys)
            res["s1"] = bs.eval_exp_sin(ctx, res["t1"], keys)
            res["stoc"] = bs.slot_to_coeff(ctx, res["s0"], res["s1"], keys)
        res["out"] = bs.regular_bootstrap(ctx, ct, keys)
        if "swk" in case:
            # the ops the bootstrap does not reach: negate, a rotation composed
            # from the power-of-two keys, switch_key
            res["negate"] = cks.negate(ctx, res["raised"])
            res["rotate"] = cks.rotate(ctx, res["raised"], keys.gk, case["step"])
            res["switch_key"] = cks.switch_key(ctx, res["raised"],
                                               meshlib.shard_pytree_limb_axis(case["swk"], m))
        key_rows = _key_rows(ctx, [*case["keys"].gk.keys.values(), case["keys"].rk])
        got_rows = [row for buf in received for row in buf.reshape(-1, buf.shape[-1])]
        misuse = {}
        try:
            bs.regular_bootstrap(ctx, ckks.Ciphertext(case["c"], 2, ctx.k - bc, keys.msg_scale),
                                 keys)
        except TypeError as e:
            misuse["plain_tensor"] = str(e)
        # a stripped Galois key with no seed raises before any exchange
        gk = ringkit.GaloisKey({e: _stripped_without_seed(kk) for e, kk in keys.gk.keys.items()})
        try:
            bs.coeff_to_slot(ctx, res["raised"], dataclasses.replace(keys, gk=gk))
        except errors.ParameterError as e:
            misuse["stripped"] = str(e)
        out[case["name"]] = {
            "steps": {k: (v.c.to_local(), v.c.placements, v.level, v.scale)
                      for k, v in res.items()},
            "key_local": {e: (tuple(k.k0.to_local().shape), k.k0.shape[1])
                          for e, k in keys.gk.keys.items()},
            "received_rows": len(got_rows),
            "received_bytes": sum(buf.numel() * buf.element_size() for buf in received),
            "received_key_rows": sum(bytes(r.numpy()) in key_rows for r in got_rows),
            "misuse": misuse}
    return out


def boot_keys_sharded(rank, world, inp):
    """boot_keys on inp["keys"], then boot_sharded on inp["cases"], in one
    start of the ranks."""
    out = boot_keys(rank, world, inp)
    out["sharded"] = boot_sharded(rank, world, inp)
    return out


def boot_v2_sharded(rank, world, inp):
    """The bootstrapping variants on a limb-sharded ciphertext
    (parallel/boot_ext_sharded.py) on a 1 x world ('dp', 'limb') mesh.  For
    each case of inp["cases"] its key set (case["keys"]) is placed by
    shard_pytree_limb_axis and each of its calls (label, kind, inputs, args)
    runs V2_CALLS[kind] on the inputs ((c, level, scale) each, c placed by
    shard_array_limb_axis).  Each rank saves every result's local shard,
    placements, level and scale, and what it received, checked here against
    every row of every key of the case, a stripped key's k1 regenerated (the
    rank spies on batch_isend_irecv; full_tensor and redistribute raise);
    with case["misuse"], the errors of a plain-tensor ciphertext and of a
    key set stripped with no seeds on the input of the call labelled
    "regular"."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from heongpu_tpu_torch.models import ckks, ringkit
    from heongpu_tpu_torch.parallel import boot_ext_sharded as bes
    from heongpu_tpu_torch.parallel import boot_sharded as bs
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.utils import errors

    received = []
    post = dist.batch_isend_irecv

    def spy(ops):
        received.extend(op.tensor for op in ops if op.op is dist.irecv)
        return post(ops)

    def refuse(*a, **k):
        raise AssertionError("the sharded variants gathered a DTensor")

    dist.batch_isend_irecv = spy
    DTensor.full_tensor = DTensor.redistribute = refuse
    ctx = ckks.make_context(*inp["ctx_args"], device="cpu", **inp["ctx_kw"])
    m = meshlib.make_mesh(world, limb_shards=world, device="cpu")
    place = lambda c, level, scale: ckks.Ciphertext(meshlib.shard_array_limb_axis(c, m), 2,
                                                    level, scale)
    out = {}
    for case in inp["cases"]:
        keys = meshlib.shard_pytree_limb_axis(case["keys"], m)
        received.clear()
        res = {}
        for label, kind, inputs, args in case["calls"]:
            res[label] = V2_CALLS[kind](bes, bs, ctx, [place(*x) for x in inputs], keys, *args)
        key_rows = _key_rows(ctx, [*case["keys"].gk.keys.values(), case["keys"].rk,
                                   case["keys"].swk_to_sparse, case["keys"].swk_to_dense])
        got_rows = [row for buf in received for row in buf.reshape(-1, buf.shape[-1])]
        misuse = {}
        if case.get("misuse"):
            c, level, scale = next(x for lbl, _, x, _ in case["calls"] if lbl == "regular")[0]
            try:
                bes.regular_bootstrap_v2(ctx, ckks.Ciphertext(c, 2, level, scale), keys)
            except TypeError as e:
                misuse["plain_tensor"] = str(e)
            strip = _stripped_without_seed
            stripped = dataclasses.replace(
                keys, gk=ringkit.GaloisKey({e: strip(kk) for e, kk in keys.gk.keys.items()}),
                rk=strip(keys.rk))
            try:
                bes.regular_bootstrap_v2(ctx, place(c, level, scale), stripped)
            except errors.ParameterError as e:
                misuse["stripped"] = str(e)
        out[case["name"]] = {
            "steps": {k: (v.c.to_local(), v.c.placements, v.level, v.scale)
                      for k, v in res.items()},
            "key_local": {e: (tuple(k.k0.to_local().shape), k.k0.shape[1])
                          for e, k in keys.gk.keys.items()},
            "received_rows": len(got_rows),
            "received_key_rows": sum(bytes(r.numpy()) in key_rows for r in got_rows),
            "misuse": misuse}
    return out


# kind -> fn(module of the variants, module of the pieces, ctx, inputs, keys, *args): the
# calls of boot_v2_sharded; the tests give the unsharded modules for the same calls
V2_CALLS = {
    "poly": lambda ext, boot, ctx, x, keys: ext.eval_poly_bsgs(ctx, x[0], keys.cos_coeffs,
                                                               keys.rk),
    "cos": lambda ext, boot, ctx, x, keys, phase: ext.eval_cos_engine(ctx, x[0], keys, phase),
    "regular": lambda ext, boot, ctx, x, keys: ext.regular_bootstrap_v2(ctx, x[0], keys),
    "slim": lambda ext, boot, ctx, x, keys: ext.slim_bootstrap(ctx, x[0], keys),
    "bit": lambda ext, boot, ctx, x, keys: ext.bit_bootstrap(ctx, x[0], keys),
    "gate": lambda ext, boot, ctx, x, keys, gate: ext.gate_bootstrap(ctx, x[0], x[1], gate,
                                                                     keys),
    "raise": lambda ext, boot, ctx, x, keys: ext._raise_maybe_sparse(ctx, x[0], keys),
    "piece": lambda ext, boot, ctx, x, keys, i: boot.matvec_piece(ctx, x[0],
                                                                  keys.ctos_pieces[i], keys.gk),
}
