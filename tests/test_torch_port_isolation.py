"""The port stands alone: no JAX, nothing of sifsr_tpu, and no silent CPU
fallback when CUDA is asked for."""

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
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "sifsr_tpu"))
print(len([k for k in sys.modules if k.startswith("sifsr_tpu_torch")]))
print(bad)
"""


def test_port_imports_no_jax_and_no_sifsr_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    n_modules, bad = out.stdout.strip().splitlines()
    assert int(n_modules) >= 40
    assert bad == "[]", bad


def test_cuda_default_entry_points_raise_without_cuda(monkeypatch):
    """Entry points default to device='cuda' and raise when it is absent."""
    from sifsr_tpu_torch.data.statistics import Statistics
    from sifsr_tpu_torch.inference import make_sr_step, predict_granule
    from sifsr_tpu_torch.models.int8_serving import make_int8_sr_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stats = Statistics(maxi=330.0, mini=260.0, mean_lst=300.0, std_lst=8.0,
                       mean_ndvi=0.35, std_ndvi=0.2)
    with pytest.raises(RuntimeError, match="cuda"):
        make_int8_sr_step(stats)
    with pytest.raises(RuntimeError, match="cuda"):
        make_sr_step(stats, torch.float32, "cuda:0")
    with pytest.raises(RuntimeError, match="cuda"):
        predict_granule({}, np.zeros((64, 64), np.float32), np.zeros((256, 256), np.float32),
                        stats)


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
