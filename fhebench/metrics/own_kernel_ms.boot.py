"""Device ms a bootstrap spends in the port's hand-written kernels
(kernels/csrc: K1, K2, K5, K6), over the slice."""


def read(t):
    return t.per_call(t.device_ms("own"), "regular_bootstrap")
