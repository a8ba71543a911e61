"""The operation and byte counters against hand-worked values."""

import pytest

from portbench.harness import peaks


def test_k1_at_the_clip_gallery():
    flops, nbytes = peaks.k1_work(1, 7670, 512)
    assert flops == 2 * 7670 * 512 == 7_854_080
    assert nbytes == 4 * (512 + 7670 * 512 + 7670) == 15_740_888
    # bytes-bound: 15,740,888 B / 3.35e12 B/s
    assert peaks.least_seconds(flops, nbytes) == pytest.approx(4.69877e-6, rel=1e-5)


def test_k1_at_the_moment_gallery():
    flops, nbytes = peaks.k1_work(1, 1_466_542, 512)
    assert flops == 1_501_739_008
    assert nbytes == 4 * (512 + 1_466_542 * 512 + 1_466_542) == 3_009_346_232
    assert peaks.least_seconds(flops, nbytes) == pytest.approx(3_009_346_232 / 3.35e12)


def test_k2_at_one_clip():
    flops, nbytes = peaks.k2_work(32, 56, 56, 6)
    assert flops == 2 * 32 * 56 * 56 * 96 * 64 == 1_233_125_376
    assert nbytes == 4 * (602_112 + 6_144 + 64 + 1_605_632) == 8_855_808
    # operations-bound at the float32 rate, 165 TFLOP/s
    assert peaks.least_seconds(flops, nbytes) == pytest.approx(1_233_125_376 / 165e12)


def test_trunk_forward_flops_per_frame_and_clip():
    # one 112x112 frame: conv1 59,006,976 + layer1 231,211,008 + layer2 205,520,896
    # + layer3 205,520,896 + layer4 268,435,456
    per_frame = 59_006_976 + 231_211_008 + 205_520_896 + 205_520_896 + 268_435_456
    assert per_frame == 969_695_232
    assert peaks.trunk_forward_flops(1, 112) == per_frame
    assert peaks.trunk_forward_flops(32, 112) == 32 * per_frame == 31_030_247_424
    # the serving stem: a 4x4 conv over 56x56x6 space-to-depth input
    s2d_stem = 2 * 56 * 56 * 96 * 64
    assert peaks.trunk_forward_flops(1, 112, "yuv_s2d") == per_frame - 59_006_976 + s2d_stem


def test_training_counts_backward_twice_but_the_stem_once():
    fwd = peaks.trunk_forward_flops(1, 112)
    assert peaks.trunk_train_flops(1, 112) == 3 * fwd - 59_006_976


def test_peaks_are_the_data_sheet_s():
    assert peaks.FP32_FLOPS == peaks.TF32_FLOPS / 3 == 165e12
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
