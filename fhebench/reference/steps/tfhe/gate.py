"""The gate on the plain bit pairs."""

from ...tfhe import gate


def bits(traffic, plain):
    return gate(traffic["gate"], plain["x"], plain["y"])
