"""Port parity for BFV under Method-II keyswitching (alpha 2: two digits of
two primes over four Q primes, two special primes): every test of
tests/test_torch_bfv.py on a Method-II pair of contexts, keys and
ciphertexts.  On the CPU a keyswitch of one poly takes the fused core's
plain version (K5's on the card)."""

import pytest

from test_torch_bfv import *  # noqa: F401,F403  (the tests, collected again here)
from test_torch_bfv import make_pair


@pytest.fixture(scope="module")
def pair():
    return make_pair(dict(ks_type="II", alpha=2))
