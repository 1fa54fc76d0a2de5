"""The gate batch's share of its roofline, %: the blind rotation's least
time for the batch (fhebench/roofline.py, from shapes) over the device time
of the whole NAND call (every kernel of the slice, the markers aside)."""

from fhebench import roofline


def read(t):
    per_call = t.per_call(t.device_ms(), "NAND")
    if not per_call:
        return None
    m = t.meta
    return 100.0 * roofline.blind_rotate_bound(m["batch"], m["lwe_n"], m["big_n"])[0] / per_call
