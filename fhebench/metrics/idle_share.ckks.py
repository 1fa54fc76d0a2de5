"""The device's idle share over the traced slice, %: 1 - the union of its
device events' intervals over the slice's wall time."""


def read(t):
    return t.idle_share_pct()
