"""The roofline's byte and flop counts against hand-computed values."""

import pytest
import torch

from benchmark import roofline


def test_stencil_counts_2d_bench_shape():
    # u and out: 1048 * 64^2 cells; gf: 1048 * 4 * 64; coef: 1048 * 4; h2: 1048 * 2
    nbytes, flops = roofline.stencil_counts(2, 1048, 64, 4)
    assert nbytes == 4 * (2 * 4292608 + 268288 + 4192 + 2096)
    assert flops == 1048 * (4096 * 9 + 4 * 64 * 3)


def test_stencil_counts_2d_published_shape():
    # 8320 patches of 16^2: u and out 2,129,920 cells; gf 8320 * 4 * 16
    nbytes, flops = roofline.stencil_counts(2, 8320, 16, 4)
    assert nbytes == 4 * (2 * 2129920 + 532480 + 33280 + 16640)
    assert flops == 8320 * (256 * 9 + 4 * 16 * 3)


def test_stencil_counts_3d_bench_shape():
    nbytes, flops = roofline.stencil_counts(3, 624, 32, 4)
    assert nbytes == 4 * (2 * 20447232 + 624 * 6 * 1024 + 624 * 6 + 624 * 3)
    assert flops == 624 * (32768 * 14 + 6 * 1024 * 3)


def test_stencil_bound_is_bytes_at_the_data_sheet_peaks():
    bw, peaks = roofline.card("NVIDIA H100 80GB HBM3")
    s, by = roofline.stencil_bound_s(2, 1048, 64, torch.float32, bw, peaks)
    assert by == "bytes"
    # 35.4 MB at 3.35 TB/s: 0.01058 ms
    assert s * 1e3 == pytest.approx(0.01058, rel=1e-3)
    s3, _ = roofline.stencil_bound_s(3, 624, 32, torch.float32, bw, peaks)
    assert s3 * 1e3 == pytest.approx(0.05341, rel=1e-3)


def test_apply_bytes_and_share():
    assert roofline.apply_bytes(4292608, 4) == 34340864
    assert roofline.share_pct(1.0, 4.0) == 25.0


def test_an_unknown_card_has_no_peaks():
    with pytest.raises(ValueError):
        roofline.card("some other card")
