"""Data parallelism over torch.distributed (``sifsr_tpu_torch.parallel``)
against the single-process step on the global batch, the port's and the JAX
package's. Two gloo processes on the CPU (``chip_smoke.dp_worker``, the
harness chip_smoke.py phase 11 runs on the card) take one predef_filters
step at narrow widths on 2 of a global batch of 4 each, run a cross-rank
BatchNorm on a seeded input, and predict a small granule with a mesh."""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sifsr_tpu.models.unet import ModelB2 as JaxModelB2
from sifsr_tpu.train.state import create_train_state as jax_create_train_state
from sifsr_tpu.train.step import make_train_step as jax_make_train_step

from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.inference import predict_granule
from sifsr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from sifsr_tpu_torch.models.unet import ModelB2
from sifsr_tpu_torch.parallel import (Mesh, convert_batchnorm, make_mesh, make_parallel_apply,
                                      make_parallel_train_step, replicate, shard_batch)
from sifsr_tpu_torch.train import create_train_state, make_train_step

from chip_smoke import (DP_ALPHA, DP_GAMMA, DP_MEAN, DP_STD, dp_batch, run_dp_workers,
                        step_diffs, step_record)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
NARROW = (8, 16, 32, 64)
SPEC = dict(world=2, device="cpu", downchannels=list(NARROW), batch=4, hw=32, seed=0,
            threads=1, bn=True, granule_batch=4, keep_mosaic=True, tail_batch=6)
STATS = os.path.join(ROOT, "data", "statistics_testset.json")
WEIGHTS = os.path.join(ROOT, "weights", "modelB_1009")


def _granule():
    """A 128² LST / 512² NDVI granule: 4 blocks, one batch of 4, 2 a rank."""
    rng = np.random.default_rng(3)
    return ((300 + 5 * rng.random((128, 128))).astype(np.float32),
            (0.2 + 0.5 * rng.random((512, 512))).astype(np.float32))


def _tail_granule():
    """A 64x192 LST / 256x768 NDVI granule: 3 blocks, one batch at batch 6,
    which two ranks split as 2 rows each, one of them zero padding."""
    rng = np.random.default_rng(5)
    return ((300 + 5 * rng.random((64, 192))).astype(np.float32),
            (0.2 + 0.5 * rng.random((256, 768))).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    lst, ndvi = _granule()
    np.savez(tmp / "granule.npz", lst=lst, ndvi=ndvi)
    lst, ndvi = _tail_granule()
    np.savez(tmp / "tail.npz", lst=lst, ndvi=ndvi)
    return run_dp_workers(dict(SPEC, granule=str(tmp / "granule.npz"),
                               tail_granule=str(tmp / "tail.npz")), str(tmp), timeout=120)


@pytest.fixture(scope="module")
def single():
    """The port's single-process step on the global batch (one thread): the
    initial state dict, the metrics and ``step_record`` (post-step state and
    gradients)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = ModelB2(downchannels=NARROW)
        state = create_train_state(model, 1e-3, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
        init = {k: v.clone() for k, v in model.state_dict().items()}
        step = make_train_step(model, "predef_filters", DP_ALPHA, DP_GAMMA, DP_MEAN, DP_STD)
        batch = {k: torch.from_numpy(v) for k, v in dp_batch(4, 32, 0).items()}
        _, metrics = step(state, batch)
    finally:
        torch.set_num_threads(before)
    return init, {k: float(v) for k, v in metrics.items()}, step_record(model)


def test_ranks_are_identical(ranks):
    """Gradients averaged over the ranks and Adam applied identically: every
    parameter, BatchNorm statistic and metric is the same on both ranks."""
    r0, r1 = ranks
    assert int(r0["size"]) == int(r1["size"]) == 2
    keys = [k for k in r0 if k.startswith(("state/", "metric/"))]
    assert len(keys) > 100 and keys == [k for k in r1 if k.startswith(("state/", "metric/"))]
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_two_ranks_match_the_single_process_step(ranks, single):
    """Against the port's step on all 4: every metric (loss, ds and percep
    losses; PSNR and SSIM over the global batch's data range) within 1e-6
    relative past 1, the averaged gradients within 1e-5 (relative L2), the
    parameters at q999 < 1e-4 and max < 1e-3 (tests/test_torch_train.py),
    the BatchNorm statistics within 5e-5."""
    _, metrics, rec = single
    r0 = ranks[0]
    assert {k[len("metric/"):] for k in r0 if k.startswith("metric/")} == set(metrics)
    for k, v in metrics.items():
        assert abs(float(r0["metric/" + k]) - v) <= 1e-6 * max(1.0, abs(v)), k
    diffs = step_diffs(r0, rec)
    assert (diffs["grad_rel"] < 1e-5 and diffs["q999"] < 1e-4 and diffs["max"] < 1e-3
            and diffs["bn"] < 5e-5), diffs
    # the step moved the weights: the comparison is not of two idle models
    assert float(np.abs(r0["state/outlay.weight"] - single[0]["outlay.weight"].numpy()).max()) > 1e-4


def test_two_ranks_match_the_jax_single_process_step(ranks, single):
    """Against the JAX package's step on all 4 from the same initial
    variables: metrics within 1e-5 (relative past 1), BatchNorm statistics
    within 5e-5, the parameters at q999 < 1e-4, within 2e-5 wherever
    |gradient| >= 1e-5 and at most 2 lr apart (Adam's first update near its
    eps; see tests/test_torch_train_variants.py)."""
    init, _, rec = single
    grads = np.concatenate([np.abs(v).ravel() for k, v in rec.items() if k.startswith("grad/")])
    jax_model = JaxModelB2(downchannels=NARROW)
    jstate = jax_create_train_state(jax_model, 1e-3, variables=to_jax_variables(init))
    jstate, want = jax_make_train_step(jax_model, "predef_filters", DP_ALPHA, DP_GAMMA, DP_MEAN,
                                       DP_STD)(jstate, {k: jnp.asarray(v) for k, v in
                                                        dp_batch(4, 32, 0).items()})
    r0 = ranks[0]
    for k, v in want.items():
        assert abs(float(r0["metric/" + k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), k
    jsd = from_jax_variables(jax.device_get({"params": jstate.params,
                                             "batch_stats": jstate.batch_stats}))
    model = ModelB2(downchannels=NARROW)
    names = [n for n, _ in model.named_parameters()]
    diffs = np.concatenate([np.abs(r0["state/" + n] - jsd[n].numpy()).ravel() for n in names])
    assert diffs.shape == grads.shape and (grads >= 1e-5).mean() > 0.9
    assert float(np.quantile(diffs, 0.999)) < 1e-4
    assert float(diffs[grads >= 1e-5].max()) < 2e-5
    assert float(diffs.max()) <= 2e-3 + 1e-6
    for k, v in jsd.items():
        if k.endswith(("running_mean", "running_var")):
            assert float(np.abs(r0["state/" + k] - v.numpy()).max()) < 5e-5, k


def test_cross_rank_batchnorm_is_the_global_batchnorm(ranks):
    """CrossRankBatchNorm2d on each rank's 4 of 8 images gives nn.BatchNorm2d
    on all 8: outputs and input gradients within 1e-6 (rtol and atol), the
    affine gradients summed over the ranks within 1e-5, and the running
    statistics (unbiased variance of the global count) within 1e-6."""
    rng = np.random.default_rng(SPEC["seed"] + 1)
    x = rng.normal(1.5, 2.0, (8, 3, 6, 5)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    bn = torch.nn.BatchNorm2d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.0, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    got_y = np.concatenate([r["bn/y"] for r in ranks])
    got_g = np.concatenate([r["bn/x_grad"] for r in ranks])
    np.testing.assert_allclose(got_y, y.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_g, xt.grad.numpy(), rtol=1e-6, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r["bn/wb_grad"], np.stack([bn.weight.grad.numpy(),
                                                              bn.bias.grad.numpy()]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["bn/running_mean"], bn.running_mean.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r["bn/running_var"], bn.running_var.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_predict_granule_with_a_mesh_equals_no_mesh(ranks):
    """Each rank runs 2 of the batch of 4 blocks and assembles the whole
    mosaic: bit-equal to predict_granule without a mesh (float32, explicit
    pads), on both ranks."""
    lst, ndvi = _granule()
    want = predict_granule(load_variables(WEIGHTS), lst, ndvi, Statistics.from_json(STATS),
                           batch_size=4, compute_dtype=torch.float32, pad_impl="explicit",
                           device="cpu")
    for r in ranks:
        assert r["mosaic"].shape == want.shape == (512, 512)
        np.testing.assert_array_equal(r["mosaic"], want)


def test_predict_granule_mesh_pads_the_tail_to_the_group_only(ranks):
    """3 blocks at batch 6 over 2 ranks: the batch is padded to 4 rows, not
    to 6, so each rank steps 2; the mosaic is bit-equal to predict_granule
    without a mesh, which steps the 3 blocks unpadded."""
    lst, ndvi = _tail_granule()
    want = predict_granule(load_variables(WEIGHTS), lst, ndvi, Statistics.from_json(STATS),
                           batch_size=SPEC["tail_batch"], compute_dtype=torch.float32,
                           pad_impl="explicit", device="cpu")
    for r in ranks:
        assert int(r["tail_rows"]) == 2
        assert r["tail_mosaic"].shape == want.shape == (256, 768)
        np.testing.assert_array_equal(r["tail_mosaic"], want)


def test_predict_granule_mesh_refusals():
    """As in the JAX package, the mesh takes neither the integer wire nor
    device tiling; a batch must split evenly over the group. Each refusal
    comes before any collective."""
    lst, ndvi = _granule()
    mesh = Mesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    args = (load_variables(WEIGHTS), lst, ndvi, Statistics.from_json(STATS))
    kw = dict(compute_dtype=torch.float32, device="cpu", mesh=mesh)
    for extra, match in ((dict(batch_size=4, wire="int"), "wire"),
                         (dict(batch_size=4, mode="device_tiling_wire"), "wire"),
                         (dict(batch_size=4, device_tiling=True), "device_tiling"),
                         (dict(batch_size=4, mode="device_tiling"), "device_tiling"),
                         (dict(batch_size=3), "split")):
        with pytest.raises(ValueError, match=match):
            predict_granule(*args, **kw, **extra)


def test_shard_batch_and_step_wrappers_refuse_misuse():
    mesh = Mesh(group=None, rank=1, size=2, device=torch.device("cpu"))
    batch = {"a": np.arange(12, dtype=np.float32).reshape(4, 3), "b": torch.arange(4)}
    got = shard_batch(batch, mesh)
    assert torch.equal(got["a"], torch.tensor([[6.0, 7, 8], [9, 10, 11]]))
    assert torch.equal(got["b"], torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="split"):
        shard_batch({"a": np.zeros((3, 2))}, mesh)
    with pytest.raises(ValueError, match="make_train_step"):
        make_parallel_train_step(make_train_step(ModelB2(downchannels=NARROW), "predef_filters",
                                                 DP_ALPHA, DP_GAMMA, DP_MEAN, DP_STD), mesh)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_group_of_one_is_the_single_device_step():
    """On a gloo group of one process, make_mesh, replicate, the mesh train
    step through make_parallel_train_step, and make_parallel_apply give the
    single-device step's and forward's bits (a group of one reduces
    nothing, and its BatchNorm is nn.BatchNorm2d's)."""
    batch = dp_batch(2, 32, 6)
    outs = []
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        for use_mesh in (False, True):
            model = ModelB2(downchannels=NARROW)
            state = create_train_state(model, 1e-3, generator=torch.Generator().manual_seed(6),
                                       device="cpu")
            step = make_train_step(model, "predef_filters", DP_ALPHA, DP_GAMMA, DP_MEAN, DP_STD,
                                   mesh=mesh if use_mesh else None)
            if use_mesh:
                replicate(model, mesh)
                step = make_parallel_train_step(step, mesh)
                bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
                assert bns and all(type(m).__name__ == "CrossRankBatchNorm2d" for m in bns)
                assert convert_batchnorm(model, mesh) is model   # idempotent
            _, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            model.eval()
            apply = make_parallel_apply(lambda m, b: m(b["x"]), mesh) if use_mesh else (
                lambda m, b: m(torch.as_tensor(b["x"])))
            with torch.no_grad():
                y = apply(model, {"x": np.concatenate([batch["lst_up"], batch["ndvi"]], -1)})
            outs.append((metrics, model.state_dict(), y))
    finally:
        dist.destroy_process_group()
    (m0, s0, y0), (m1, s1, y1) = outs
    assert list(s0) == list(s1)
    for k in m0:
        assert float(m0[k]) == float(m1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert torch.equal(y0, y1)
