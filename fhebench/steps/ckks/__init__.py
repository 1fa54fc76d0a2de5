"""CKKS operations.  Each module gives

  run(cell, step, x, prepared, i, warm) -> (x, records, work)
      issue the operation on the ciphertext x without waiting for the
      device; `records` lists one tuple of arguments for each part of the
      operation the reference replays, `work` counts what it completed;
  limbs_out(cell, step, limbs) -> the Q limbs the output is guaranteed;

and may give
  keys(cell, step, g, sk)             make its keys into cell.keys;
  prepare(cell, step, draw, pk, g)    -> (plain, prepared): its own inputs
                                      for one pool item, drawn at set-up;
  encrypt_input(cell, step, values, pk, g)
                                      how the request's input is encrypted,
                                      where the program starts with it;
  warm_variants(step)                 requests it takes to warm every shape.

`cell` is the scheme's Cell (fhebench/schemes/ckks.py): its ctx, cfg, tr,
spans, keys, slots(draw) and request_draw."""
