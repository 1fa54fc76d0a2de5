"""Plain TFHE operations.  Each module gives bits(traffic, plain): the bits
the output's samples should hold, in the order of its samples."""
