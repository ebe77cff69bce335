"""The CPU side of the int8 step's CUDA graphs (``models.int8_serving``):
the key that decides whether a graph may be replayed, and the cached
device tables the graphs hold. The graphs themselves run on the card
(``tests/test_torch_cuda.py``)."""

import os

import numpy as np
import pytest
import torch

from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.kernels.resize_phases import _device_tables
from sifsr_tpu_torch.models import int8_serving
from sifsr_tpu_torch.ops.resize import _matrix

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SIZE = 16


@pytest.fixture(scope="module")
def setup():
    """(stats, prow/xla parameters for 16² LST blocks on the CPU, 2 blocks)."""
    sd = load_variables(os.path.join(ROOT, "weights", "modelB_1009"))
    stats = Statistics.from_json(os.path.join(ROOT, "data", "statistics_testset.json"))
    rng = np.random.default_rng(5)
    lst = (296.0 + 20.0 * rng.random((2, SIZE, SIZE))).astype(np.float32)
    ndvi = (0.1 + 0.7 * rng.random((2, 4 * SIZE, 4 * SIZE))).astype(np.float32)
    params = int8_serving.build_int8_serving_params(sd, lst, ndvi, stats, device="cpu")
    return stats, params, torch.from_numpy(lst), torch.from_numpy(ndvi)


@pytest.mark.parametrize("mid", ["prow", "xla"])
def test_cached_tables_are_those_the_step_fetches(setup, mid):
    """``_cached_tables`` fetches every table the step takes from the module
    caches (all hits after the step's call) and no other: a graph that
    holds them holds all the cached memory it reads."""
    stats, params, lst, ndvi = setup
    caches = (_device_tables, _matrix)
    for c in caches:
        c.cache_clear()
    step = int8_serving.make_int8_sr_step(stats, mid=mid, device="cpu")
    assert step.eager is step                 # the CPU step is the eager step
    step(params, lst, ndvi)
    used = [c.cache_info() for c in caches]
    held = int8_serving._cached_tables(lst, mid)
    after = [c.cache_info() for c in caches]
    assert [i.misses for i in after] == [i.misses for i in used]
    assert len({id(t) for t in held}) == sum(i.currsize for i in used) == (1 if mid == "prow"
                                                                            else 4)


def test_graph_key_follows_every_leaf_the_step_reads(setup):
    """The key of a call is the blocks' shapes and the identity of each leaf
    of the subtrees the step reads: the same tree gives the same key; a
    leaf swapped in, in a copy of the tree or in place, a number replaced
    or other block shapes give another; the subtree of the other mid chain
    does not count."""
    stats, params, lst, ndvi = setup
    graphs = int8_serving._GraphedStep(None, torch.device("cpu"), "prow")

    def key(tree, a=lst, b=ndvi):
        return graphs._key(tree, a, b)[0]

    base = key(params)
    assert key(params) == base
    assert key({**params, "mid": {}}) == base
    tree = {**params, "in1": dict(params["in1"])}
    assert key(tree) == base
    tree["in1"]["w"] = params["in1"]["w"].clone()
    assert key(tree) != base
    assert key({**params, "pm_scale": params["pm_scale"] + 0.0}) != base
    assert key(params, lst[:, :8], ndvi[:, :32]) != base
    assert key(params, lst[:1], ndvi[:1]) == base      # the rows are not in the key
