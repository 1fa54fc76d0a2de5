"""The slots plus their rotation to the left by r."""

import numpy as np


def slots(z, args, plain):
    return z + np.roll(z, -args[0])
