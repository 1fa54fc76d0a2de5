"""A bootstrap keeps the slots."""


def slots(z, args, plain):
    return z
