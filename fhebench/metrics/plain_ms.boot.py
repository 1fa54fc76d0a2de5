"""Device ms a bootstrap spends in PyTorch's own kernels (the at:: names: the
int64 passes of ops/modmath, ops/polyops and models/ckks), over the slice."""


def read(t):
    return t.per_call(t.device_ms("plain"), "regular_bootstrap")
