"""Device ms an encrypted-integer add spends in PyTorch's own kernels (the
gates' prologue and epilogue, lwe_keyswitch, tfhe_int's linear steps), over
the slice."""


def read(t):
    return t.per_call(t.device_ms("plain"), "tfhe_int.add")
