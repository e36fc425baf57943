"""``work.py``'s counts against values worked out by hand at the cells'
shapes."""

from __future__ import annotations

import pytest

from perfbench import work
from perfbench.reference import lenet5, resnet1m


def test_forward_flops_by_hand():
    # LeNet-5: conv 28*28*6 outputs of 5*5*1, conv 10*10*16 of 5*5*6, dense 400-120-84-10
    assert lenet5.forward_flops() == 2 * (117600 + 240000 + 48000 + 10080 + 840) == 833040
    # ResNet1M: stem 884,736 MACs; stage 1 six 3x3 32->32 convs at 32x32, 9,437,184 each;
    # stage 2 4,718,592 + 9,437,184 + 524,288 (1x1) + four 9,437,184; stage 3 the same
    macs = (884736 + 6 * 9437184 + 2 * (4718592 + 9437184 + 524288 + 4 * 9437184) + 1280)
    assert resnet1m.forward_flops() == 2 * macs == 324733440


def test_lenet5_gram_step_by_hand():
    d_z, d_x, D = 1000, 1280, 61706
    assert work.syrk(d_z, D).flops == 61_767_706_000
    assert work.matmul_nt(d_x, d_z, D).flops == 157_967_360_000
    assert work.syrk_backward(d_z, D).flops == 123_412_000_000
    assert work.matmul_nt_backward_b(d_x, d_z, D).flops == 157_967_360_000
    products = work.gram_step_products(d_z, d_x, D)
    assert products.flops == 501_114_426_000
    assert products.bound_s() == pytest.approx(501_114_426_000 / 495e12)   # 1.012 ms
    rows = (100 + 128) * 833040 * 21 + 2 * 100 * 833040 * 21
    assert work.gram_step_flops(100, 128, 10, D, 833040) == 501_114_426_000 + rows


def test_serve_batch_by_hand():
    S, B, d, D = 200, 256, 1000, 61706
    assert work.serve_products(S, d, D).flops == 2 * 24_682_400_000
    # B2 reads eps (S, D) and R (d, D) and writes (S, d): bytes bound 0.0883 ms
    assert work.matmul_nt(S, d, D).bytes == 4 * (S * D + d * D + S * d)
    assert work.matmul_nt(S, d, D).bound_s() == pytest.approx(4 * 74_247_200 / 3.35e12)
    assert work.serve_batch_flops(S, B, 100, 10, D, 833040) == (
        2 * 24_682_400_000 + 2 * 2 * S * d * d + B * 833040 + 2 * S * B * 833040)


def test_resnet1m_gram_step_is_bound_by_bytes():
    p = work.gram_step_products(500, 320, 1084586)
    # B1, B2 and its backward dB (two 2mnk), B1's backward (C + C^T) A
    assert p.flops == 500 * 501 * 1084586 + 2 * 2 * 320 * 500 * 1084586 + 2 * 500 * 500 * 1084586
    # each product reads its rows once and writes its output once: 13.6 GB over HBM
    assert p.bytes == 4 * ((500 * 1084586 + 500 * 500) + (320 * 1084586 + 500 * 1084586 + 320 * 500)
                           + (500 * 500 + 2 * 500 * 1084586) + (320 * 500 + 320 * 1084586 + 500 * 1084586))
    assert p.bound_s() == p.bytes / 3.35e12 > p.flops / 495e12
