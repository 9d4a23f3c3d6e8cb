"""Golden vectors pinned from the reference Go stack, shared by the test
suite (tests/test_reference_vectors.py) and the bench device-path gate
(bench.py) so the pinned bytes and the fixture-share construction can
never silently diverge between the two.

Sources (all in the celestia-app repository):
- pkg/da/data_availability_header_test.go:29  MinDataAvailabilityHeader hash
- pkg/da/data_availability_header_test.go:45  2x2 "typical" DAH hash
- pkg/da/data_availability_header_test.go:51  128x128 "max square size" DAH hash

Share fixture construction mirrors generateShares/generateShare
(data_availability_header_test.go:247-263): every share is the version-0
namespace 0x00 || 18*0x00 || 10*0x01 followed by 0xFF to ShareSize.
"""

import numpy as np

from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.da.namespace import Namespace

# pkg/da/data_availability_header_test.go:29
MIN_DAH_HASH = bytes.fromhex(
    "3d96b7d238e7e0456f6af8e7cdf0a67bd6cf9c2089ecb559c659dcaa1f880353"
)
# pkg/da/data_availability_header_test.go:45 ("typical", squareSize=2)
DAH_2X2_HASH = bytes.fromhex(
    "b56e4d251ac266f4b91cc5464b3fc7efcbdc888064647496d13133f0dc65ac25"
)
# pkg/da/data_availability_header_test.go:51 ("max square size", 128)
DAH_128_HASH = bytes.fromhex(
    "0bd3abeeacfbb0b92dfbdac4a154868e3c4e79666f7fcf6c620bb90dd3a0dcf0"
)


def fixture_share() -> bytes:
    """generateShare(ns1) parity: ns1 = MustNewV0(10 x 0x01), remainder
    0xFF to ShareSize."""
    ns1 = Namespace.v0(b"\x01" * 10)
    share = ns1.raw + b"\xff" * (SHARE_SIZE - len(ns1.raw))
    assert len(share) == SHARE_SIZE
    return share


def fixture_shares(count: int) -> np.ndarray:
    share = fixture_share()
    return np.frombuffer(share * count, dtype=np.uint8).reshape(
        count, SHARE_SIZE
    )
