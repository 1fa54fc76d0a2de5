"""The product with level l's operand."""


def slots(z, args, plain):
    return z * plain[args[0]]
