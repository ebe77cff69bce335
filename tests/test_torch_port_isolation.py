"""The port stands alone: no JAX, nothing of sifsr_tpu, no scikit-learn and
no matplotlib when it is imported (the card machine has neither), and no
silent CPU fallback when CUDA is asked for."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import sifsr_tpu_torch
for m in pkgutil.walk_packages(sifsr_tpu_torch.__path__, "sifsr_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "sifsr_tpu",
                                    "sklearn", "matplotlib"))
print(len([k for k in sys.modules if k.startswith("sifsr_tpu_torch")]))
print(bad)
print(all(m in sys.modules for m in ("sifsr_tpu_torch.data.native_loader",
                                     "sifsr_tpu_torch.data.datasets",
                                     "sifsr_tpu_torch.parallel",
                                     "sifsr_tpu_torch.parallel.mesh",
                                     "sifsr_tpu_torch.utils.flops",
                                     "sifsr_tpu_torch.tools.bf16_convergence")))
"""


def test_port_imports_no_jax_and_no_sifsr_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    n_modules, bad, new_modules = out.stdout.strip().splitlines()
    assert int(n_modules) >= 70
    assert bad == "[]", bad
    assert new_modules == "True"


def test_cuda_default_entry_points_raise_without_cuda(monkeypatch):
    """Entry points default to device='cuda' and raise when it is absent."""
    from sifsr_tpu_torch.data.statistics import Statistics
    from sifsr_tpu_torch.inference import make_sr_step, predict_granule
    from sifsr_tpu_torch.models.int8_serving import make_int8_sr_step
    from sifsr_tpu_torch.models.packed import make_packed_sr_step, packed_step_params
    from sifsr_tpu_torch.models.quantized_packed import (
        calibrate_packed_scales,
        make_int8_packed_sr_step,
        quantize_packed_params,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stats = Statistics(maxi=330.0, mini=260.0, mean_lst=300.0, std_lst=8.0,
                       mean_ndvi=0.35, std_ndvi=0.2)
    with pytest.raises(RuntimeError, match="cuda"):
        make_int8_sr_step(stats)
    for call in (lambda: make_packed_sr_step(stats),
                 lambda: make_packed_sr_step(stats, torch.float32),
                 lambda: make_int8_packed_sr_step(stats),
                 lambda: packed_step_params({}),
                 lambda: quantize_packed_params({}),
                 lambda: calibrate_packed_scales({}, {}, None, None, stats)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    with pytest.raises(RuntimeError, match="cuda"):
        make_sr_step(stats, torch.float32, "cuda:0")
    with pytest.raises(RuntimeError, match="cuda"):
        predict_granule({}, np.zeros((64, 64), np.float32), np.zeros((256, 256), np.float32),
                        stats)
    from sifsr_tpu_torch.parallel import Mesh

    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="cuda"):
        predict_granule({}, np.zeros((64, 64), np.float32), np.zeros((256, 256), np.float32),
                        stats, mesh=mesh)


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """train_loop, create_train_state, the batch preparation and
    cli.train.main run on the card unless the caller passes the CPU."""
    from sifsr_tpu_torch.cli import train as cli_train
    from sifsr_tpu_torch.config import HyperParams, TrainConfig
    from sifsr_tpu_torch.data import (
        ArrayDataset,
        degrade_batch_scale_invariance,
        make_synthetic_dataset,
        prepare_batch,
    )
    from sifsr_tpu_torch.models.unet import ModelB2
    from sifsr_tpu_torch.train import create_train_state, make_train_step, train_loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    full = make_synthetic_dataset(2, seed=0)
    ds = ArrayDataset(full.lst[:, :16, :16], full.ndvi[:, :64, :64], full.stats)
    config = TrainConfig(hyper=HyperParams(batch_size=2, n_epochs=1), recipe="scale_invariance")
    with pytest.raises(RuntimeError, match="cuda"):
        train_loop(config, ds, ds, log_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(ModelB2(), 1e-3)
    batch = next(ds.batches(2))
    with pytest.raises(RuntimeError, match="cuda"):
        prepare_batch(batch)
    with pytest.raises(RuntimeError, match="cuda"):
        degrade_batch_scale_invariance(batch, 295.0, 10.0)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(["--params", os.path.join(ROOT, "paramsB.json")])
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(["--params", os.path.join(ROOT, "paramsB.json"), "--streaming",
                        "--pad-impl", "fused"])
    # asked for the CPU, the same entry points run: a step follows the
    # device of the state it is given
    state, metrics = train_loop(config, ds, ds, log_fn=lambda s: None, device="cpu")
    assert np.isfinite(metrics["train_loss"]).all()
    model = ModelB2()
    state = create_train_state(model, 1e-3, device="cpu")
    step = make_train_step(model, "scale_invariance", 0.99, -0.5, 295.0, 10.0)
    prepped = degrade_batch_scale_invariance(batch, 295.0, 10.0, device="cpu")
    assert next(model.parameters()).device.type == prepped["lst"].device.type == "cpu"
    assert torch.isfinite(step(state, prepped)[1]["loss"])


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its plain version for CPU tensors only."""
    from sifsr_tpu_torch.kernels import conv_i8_exact

    x = torch.zeros((1, 8, 8, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_i8_exact(x, x, x, x)


def test_eval_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """LPIPS, the batched metric block, run_evaluation, make_sr_fn and
    cli.model_perf.main run on the card unless the caller asks for the CPU;
    asked for it, they run there."""
    from sifsr_tpu_torch.cli import model_perf
    from sifsr_tpu_torch.eval.device_metrics import device_metric_rows
    from sifsr_tpu_torch.eval.harness import run_evaluation
    from sifsr_tpu_torch.eval.lpips import LPIPS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    pairs = [(300 + rng.random((48, 52)), 300 + rng.random((48, 52)))]
    for call in (lambda: LPIPS(),
                 lambda: device_metric_rows(pairs),
                 lambda: run_evaluation(str(tmp_path), lambda lst, ndvi: lst),
                 lambda: model_perf.make_sr_fn("bicubic", "", ""),
                 lambda: model_perf.main(["--sr-type", "bicubic", "--dataset", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    missing = str(tmp_path / "none.pt")
    assert np.isnan(LPIPS(missing, missing, device="cpu")(pairs[0][0], pairs[0][1]))
    row, = device_metric_rows(pairs, device="cpu")
    assert np.isfinite(row["RMSE"])
    assert model_perf.make_sr_fn("bicubic", "", "", device="cpu")(
        np.full((64, 64), 300.0), None).shape == (256, 256)


def test_baselines_and_spectra_raise_without_cuda(monkeypatch, tmp_path):
    """DMS (dms_sharpen, its sharpener, its regression forest, the raster
    workflow, make_sr_fn's DMS) and ``compare_methods spectra`` run on the
    card unless the caller asks for the CPU; asked for it, they run there."""
    from sifsr_tpu_torch.baselines import DecisionTreeSharpener, dms_sharpen
    from sifsr_tpu_torch.baselines.dms_rasters import sharpen_rasters
    from sifsr_tpu_torch.baselines.forest import BaggedTrees
    from sifsr_tpu_torch.cli import compare_methods, model_perf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    ndvi = 0.3 + 0.2 * rng.random((32, 32))
    lst = 300.0 - 10.0 * ndvi.reshape(8, 4, 8, 4).mean(axis=(1, 3))
    gt_hr, gt_lr = (0.0, 250.0, 0.0, 0.0, 0.0, -250.0), (0.0, 1000.0, 0.0, 0.0, 0.0, -1000.0)
    (tmp_path / "bicubic").mkdir()
    for call in (lambda: dms_sharpen(lst, ndvi),
                 lambda: DecisionTreeSharpener(),
                 lambda: BaggedTrees(),
                 lambda: sharpen_rasters(lst, gt_lr, ndvi, gt_hr),
                 lambda: model_perf.make_sr_fn("DMS", "", ""),
                 lambda: compare_methods.main(["spectra", "--results-dir", str(tmp_path),
                                               "--models", "m"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert dms_sharpen(lst, ndvi, device="cpu").shape == (32, 32)
    assert sharpen_rasters(lst, gt_lr, ndvi, gt_hr, device="cpu").shape == (32, 32)
    assert BaggedTrees(device="cpu").device == torch.device("cpu")


_SMOKE_WRITER = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.write_aster_pairs({out!r}, 1)
print(sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "sifsr_tpu")))
"""


def test_chip_smoke_and_its_pair_writer_import_no_jax(tmp_path):
    """chip_smoke.py, with the ASTER pair writer its eval phase and the
    eval tests share, stands on the port alone."""
    out = subprocess.run([sys.executable, "-c", _SMOKE_WRITER.format(root=ROOT, out=str(tmp_path))],
                         cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "dataset.csv").exists() and (tmp_path / "data" / "0_data_dict.pkl").exists()
