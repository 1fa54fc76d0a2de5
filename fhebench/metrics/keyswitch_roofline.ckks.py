"""The keyswitch's share of its roofline, %: the least time of each traced
relinearize and rotate at its level (fhebench/roofline.py, from shapes),
summed, over the device time of every kernel launched inside those calls."""

from fhebench import roofline


def read(t):
    calls = [(meta, ms) for name, meta, ms in t.marked if name in ("relinearize", "rotate")]
    device_ms = sum(ms for _, ms in calls)
    if not calls or not device_ms:
        return None
    m = t.meta
    least = sum(roofline.keyswitch_bound(**roofline.keyswitch_shapes(
        m["n"], meta["limbs"], m["specials"], m["alpha"]))[0] for meta, _ in calls)
    return 100.0 * least / device_ms
