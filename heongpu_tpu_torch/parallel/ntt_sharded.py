"""Coefficient-sharded NTT over a device mesh (port of
heongpu_tpu/parallel/ntt_sharded.py): the four-step structure maps onto
several devices, both butterfly phases are independent across the sharded
axis, and the one transpose between them is an all-to-all.

Each rank of the mesh's 'coef' axis (D ranks) holds a block of the ring in
four-step form:
  forward  in:  (..., L, N1, N2/D)  columns [r·N2/D, (r+1)·N2/D) of (L, N1, N2)
  forward  out: (..., L, N2, N1/D)  columns [r·N1/D, (r+1)·N1/D) of (L, N2, N1)
(flattening the gathered output gives the NTT domain's storage order,
ops/ntt.py eval_order).  The inverse maps the second layout back to the
first.  Each transform is K1's two passes run apart (ops/ntt.py ntt_pass:
hf_ntt_pass on the card, the plain stages on the CPU) with one
all_to_all_single of equal chunks between them; the first pass writes the
exchange buffer's layout, so nothing is transposed around the collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..ops import ntt as nttm


def make_sharded_ntt(mesh: DeviceMesh, tb: nttm.NttTables, lead_dims: int = 0):
    """(fwd, inv) over this rank's block, shaped lead + (L, N1, N2/D) /
    lead + (L, N2, N1/D), sharded on the last axis of the ring over the mesh
    axis 'coef' (D ranks, dividing N1 and N2).  Each takes the local block or
    a DTensor of the global array sharded that way, and returns the same
    kind."""
    group = mesh.get_group("coef")
    d = mesh.size(mesh.mesh_dim_names.index("coef"))
    rank = mesh.get_local_rank("coef")
    if tb.n1 % d:
        raise ValueError(f"{d} ranks do not divide N1 = {tb.n1}")

    def transform(x, inverse):
        dt = isinstance(x, DTensor)
        loc = x.to_local() if dt else x
        if loc.ndim != lead_dims + 3:
            raise ValueError(f"expected {lead_dims} lead dims + (L, rows, cols), "
                             f"got {tuple(loc.shape)}")
        send = nttm.ntt_pass(loc.contiguous(), tb, inverse, 1, d, rank)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        y = nttm.ntt_pass(recv, tb, inverse, 2, d, rank)
        if not dt:
            return y
        return DTensor.from_local(y, mesh, x.placements, run_check=False)

    return (lambda x: transform(x, False)), (lambda x: transform(x, True))


def to_four_step(x, tb: nttm.NttTables):
    """(..., L, N) coefficient-domain -> forward-input layout (..., L, N1, N2)."""
    return x.reshape(x.shape[:-1] + (tb.n1, tb.n2))


def from_four_step_ntt(y):
    """Forward-output layout (..., L, N2, N1) -> flat (..., L, N) NTT-domain
    tensor in the framework's standard storage order."""
    return y.reshape(y.shape[:-2] + (-1,))
