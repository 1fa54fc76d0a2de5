"""The sum's `width` bits of each pair, least significant first, then each
pair's carry out."""

import numpy as np


def bits(traffic, plain):
    w = traffic["width"]
    total = plain["x"] + plain["y"]
    want = ((total % (1 << w))[:, None] >> np.arange(w)) & 1
    return np.concatenate([want.reshape(-1), total >> w]).astype(bool)
