"""The segment's work count (`benchmark.work`) against a count by hand."""

from benchmark import work


def test_level_shapes_follow_the_configuration_rule():
    assert work.level_shapes((128, 128)) == [(128, 128), (64, 64), (32, 32), (16, 16)]
    assert work.level_shapes((128, 128, 128)) == [(128,) * 3, (64,) * 3, (32,) * 3,
                                                  (16,) * 3, (8,) * 3]
    assert work.level_shapes((128, 128), dense_coarsest=False)[-1] == (16, 16)


def test_two_level_count_by_hand():
    # fine 8x8 (n = 64), coarse 4x4 dense (16 nodes), model_2 alone, nu = 3.
    # Apply on the fine level: (9 stencil points + 9 data channels) x 2 = 36 a node.
    apply0 = 36 * 64                              # 2304
    pre = 64 + 2 * (apply0 + 3 * 64)              # from zero, then 2 sweeps: 5056
    residual = apply0 + 64                        # 2368
    restrict = 2 * 3 * (4 * 8) + 2 * 3 * (4 * 4)  # axis 0 writes 4x8, axis 1 4x4: 288
    coarsest = 2 * 16 * 16                        # 512
    prolong = 2 * 2 * (8 * 4) + 2 * 2 * (8 * 8) + 64   # + the add: 448
    post = 3 * (apply0 + 3 * 64)                  # 7488
    cg = apply0 + 12 * 64                         # 3072
    want = pre + residual + restrict + coarsest + prolong + post + cg
    assert want == 19232
    assert work.lane_iteration_flops([(8, 8), (4, 4)], [2], 3) == want
    # x, r, x out, 9 data planes, the diagonal (64 each) and the 16x16 inverse,
    # 4 bytes each, and the 4-byte iteration count.
    assert work.lane_bytes([(8, 8), (4, 4)]) == 4 * (3 * 64 + 9 * 64 + 64 + 256) + 4


def test_three_levels_add_the_middle_level_and_its_lumped_data():
    shapes = [(8, 8), (4, 4), (2, 2)]
    assert work.lane_bytes(shapes) == 4 * (3 * 64 + 9 * 64 + 64 + 2 * 16 + 4 * 4) + 4
    two = work.lane_iteration_flops([(8, 8), (4, 4)], [2], 3)
    three = work.lane_iteration_flops(shapes, [2], 3)
    # the 4x4 level now smooths with a lumped (1-channel) apply of 2 x (9 + 1) a node
    apply1 = 20 * 16
    middle = (16 + 2 * (apply1 + 48)) + (apply1 + 16) + (2 * 3 * 8 + 2 * 3 * 4) \
        + 2 * 4 * 4 + (2 * 2 * 8 + 2 * 2 * 16 + 16) + 3 * (apply1 + 48)
    assert three - two == middle - 2 * 16 * 16


def test_least_seconds_takes_the_larger_bound():
    t, by = work.least_seconds(3.35e12, 67e12 / 2)
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = work.least_seconds(1.0, 67e12)
    assert by == "operations" and abs(t - 1.0) < 1e-12
