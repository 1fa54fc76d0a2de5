"""heongpu_tpu_torch — the PyTorch + CUDA port of heongpu_tpu.

The JAX package `heongpu_tpu` is the reference; this package mirrors its
`ops/`, `models/` and `utils/` layout and module/function names, and returns
the same residues for the same inputs.  Residues are stored as torch.int32
(every canonical residue is below p < 2^30, so its bits equal the reference's
uint32 array); the plain torch paths compute in int64 and the hand-written
CUDA kernels (`kernels/`) read the same buffers as uint32.

This package never imports jax or heongpu_tpu.
"""

__version__ = "0.1.0"
