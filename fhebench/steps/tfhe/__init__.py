"""TFHE operations.  Each module gives

  inputs(cell, draw, sk, g) -> {"plain": {...}, ...}
      one pool item: its plain values and their encryptions;
  run(cell, item) -> (output, work)
      issue the operation without waiting for the device;
  samples(output) -> (a, b)
      the output's LWE samples, in the order of the reference's bits.

`cell` is the scheme's Cell (fhebench/schemes/tfhe.py): its ctx, cfg, tr,
spans and bk."""
