"""The frozen yardstick against the program's own arithmetic and PERF.md's
per-kernel bounds."""

import pytest

from benchmark.harness import yardstick


def test_conv_count_at_256():
    assert yardstick.modelb2_conv_flops(256) == 3_605_004_288


def test_conv_count_matches_the_program():
    from sifsr_tpu_torch.utils.flops import modelb2_conv_flops
    for hw in (64, 128, 256):
        assert yardstick.modelb2_conv_flops(hw) == modelb2_conv_flops(hw)


def test_int8_step_bounds_at_a_granule():
    """The prow step at 324 blocks: the bounds PERF.md's kernel table gives,
    kernel by kernel (ms). J's two launches are bound apart, ub1.conv1 by
    its operations (0.099) and ub2.conv1 by its bytes (0.152), where the
    table bounds their sums by bytes (0.228): 1.85 ms in all."""
    per = {}
    for entry, b, o in yardstick.int8_step_launches(324):
        per[entry] = per.get(entry, 0.0) + yardstick.launch_bound_s(b, o) * 1e3
    table = {"upsample_phases": 0.0079, "conv_i8_in1_split": 0.114, "conv_i8_exact": 0.431,
             "conv_i8_exact_dual": 0.304, "conv_i8_generic": 0.127, "conv_prow": 0.222,
             "conv_prow_split_pool": 0.133, "conv_prow_up2": 0.108,
             "conv_prow_dual_planes": 0.251, "conv_prow_up2_pack": 0.152}
    for k, v in table.items():
        assert per[k] == pytest.approx(v, rel=0.01, abs=2e-4), k
    assert sum(per.values()) == pytest.approx(1.853, abs=0.005)


def test_launches_per_step_are_the_program_counts():
    """chip_smoke.py's exact launch counts of the prow step (PR 16's log)."""
    assert yardstick.launches_per_step(324) == {
        "upsample_phases": 1, "conv_i8_in1_split": 1, "conv_i8_exact": 2,
        "conv_i8_exact_dual": 1, "conv_i8_generic": 1, "conv_prow": 6,
        "conv_prow_split_pool": 2, "conv_prow_up2": 2, "conv_prow_dual_planes": 2,
        "conv_prow_up2_pack": 1}
