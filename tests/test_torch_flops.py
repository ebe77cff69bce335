"""The port's FLOP counts (``sifsr_tpu_torch.utils.flops``) against the JAX
package's ``sifsr_tpu.utils.flops``, and ``op_flops`` of the float32 step
against the analytic count."""

import os

import numpy as np
import pytest
import torch

from sifsr_tpu.utils import flops as jax_flops

from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.inference import make_sr_step
from sifsr_tpu_torch.models.fused import InferenceModelB2
from sifsr_tpu_torch.models.packed import make_packed_sr_step, packed_step_params
from sifsr_tpu_torch.utils import flops

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
PLANS = [dict(hw=64), dict(hw=128), dict(hw=256),
         dict(hw=96, in_channels=3, downchannels=(8, 24, 48, 96))]


def test_modelb2_conv_flops_reference_config():
    assert flops.modelb2_conv_flops() == 3605004288.0


@pytest.mark.parametrize("plan", PLANS)
def test_conv_counts_equal_jax(plan):
    assert flops.modelb2_conv_list(**plan) == jax_flops.modelb2_conv_list(**plan)
    assert flops.modelb2_conv_flops(**plan) == jax_flops.modelb2_conv_flops(**plan)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("plan", [PLANS[2], PLANS[3]])
def test_conv_lane_bound_equals_jax(plan, backward):
    """The same arithmetic at JAX's default peak, which the port's function
    takes only as an argument."""
    assert (flops.conv_lane_bound_s(**plan, peak_flops=197e12, backward=backward)
            == jax_flops.conv_lane_bound_s(**plan, peak_flops=197e12, backward=backward))


def test_conv_lane_bound_needs_a_peak():
    with pytest.raises(TypeError, match="peak_flops"):
        flops.conv_lane_bound_s()


def _stats():
    return Statistics.from_json(os.path.join(ROOT, "data", "statistics_testset.json"))


def _blocks(n=2, size=16):
    rng = np.random.default_rng(0)
    return ((296.0 + 20.0 * rng.random((n, size, size))).astype(np.float32),
            (0.1 + 0.7 * rng.random((n, 4 * size, 4 * size))).astype(np.float32))


def test_op_flops_of_the_float32_step_bounds_the_analytic_count():
    """The counted FLOPs of the float32 step at 16² LST (64² NDVI) hold the
    convs and little more (the bicubic and bilinear matmuls): between the
    analytic conv count and 2.5x it, as JAX's cost analysis of its step."""
    lst, ndvi = _blocks()
    model = InferenceModelB2.from_variables(load_variables(os.path.join(ROOT, "weights",
                                                                        "modelB_1009")))
    total = flops.op_flops(make_sr_step(_stats(), torch.float32, "cpu", "explicit"), model, lst,
                           ndvi)
    conv = 2 * flops.modelb2_conv_flops(hw=64)
    assert conv <= total < 2.5 * conv, total / conv


def test_op_flops_counts_the_packed_convs_extra_macs():
    """The packed float32 step's level-0 convs do four times the MACs of the
    unpacked ones: op_flops sees them, the analytic count does not."""
    lst, ndvi = _blocks()
    params = packed_step_params(load_variables(os.path.join(ROOT, "weights", "modelB_1009")),
                                torch.float32, "cpu")
    total = flops.op_flops(make_packed_sr_step(_stats(), torch.float32, "cpu"), params, lst, ndvi)
    plan = flops.modelb2_conv_list(hw=64)
    level0 = sum(2 * n * ci * co * 9 for n, ci, co in plan if n == 64 * 64)
    packed_convs = 2 * (flops.modelb2_conv_flops(hw=64) + 3 * level0)
    assert packed_convs <= total < 1.25 * packed_convs, total / packed_convs
