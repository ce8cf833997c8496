"""The roofline functions on hand-worked shapes."""

import pytest

from perfbench import roofline


def test_ivf_search_is_bound_by_its_products():
    # 4096 queries x 32 lists x 976.5625 rows x 128 = 1.6384e10 products
    t = 6 * 1.6384e10 / 495e12
    assert t == pytest.approx(1.98594e-4, rel=1e-5)
    assert roofline.ivf_search_s(4096, 1_000_000, 128, 1024, 32, 10) == \
        pytest.approx(t)
    # the bytes alone: 512e6 rows + queries + (Q, k) ids and distances
    assert roofline.least_s(512_000_000 + 2_097_152 + 327_680) == \
        pytest.approx(1.535597e-4, rel=1e-5)
