"""The port's training loop, checkpoints and command line: all three recipes
on synthetic data with the JAX loop's metric schema, the partial last batch,
the best state on an early stop, checkpoint resume, bf16, and
``cli.train.main`` on a GeoTIFF manifest."""

import csv
import json
import os
import pickle

import numpy as np
import pytest
import torch

from sifsr_tpu.train import loop as jax_loop

from sifsr_tpu_torch.cli import train as cli_train
from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.config import HyperParams, TrainConfig
from sifsr_tpu_torch.data import ArrayDataset, make_synthetic_dataset
from sifsr_tpu_torch.geo.tiff import write_geotiff
from sifsr_tpu_torch.models.unet import ModelB2
from sifsr_tpu_torch.train import EarlyStopping, create_train_state, train_loop
from sifsr_tpu_torch.train.checkpoint import CheckpointManager

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
RECIPES = ["predef_filters", "gradftm", "scale_invariance"]
MEAN, STD, ALPHA, GAMMA = 295.0, 10.0, 0.99, -0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and the
    float32 sums of a conv backward depend on the thread count, which the
    first Adam step amplifies where a gradient is near its eps of 1e-8."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



def _small_dataset(n, seed):
    """The synthetic pairs cropped to 32² LST / 128² NDVI, a quarter of the
    pixels, to keep a CPU epoch short; widths and depth are the model's own."""
    ds = make_synthetic_dataset(n, seed=seed)
    return ArrayDataset(ds.lst[:, :32, :32], ds.ndvi[:, :128, :128], ds.stats)


def _tiny_config(recipe, n_epochs=2, patience=5, **kw):
    return TrainConfig(
        hyper=HyperParams(batch_size=4, learning_rate=1e-3, n_epochs=n_epochs,
                          patience=patience, alpha=0.99, gamma=-0.5),
        recipe=recipe, seed=0, **kw)


@pytest.mark.parametrize("recipe", RECIPES)
def test_train_loop_all_recipes(recipe):
    """Two epochs on synthetic data: finite losses and the JAX loop's metric
    schema (the reference's lossdata keys)."""
    train_ds, val_ds = _small_dataset(8, 1), _small_dataset(4, 2)
    logs = []
    state, metrics = train_loop(_tiny_config(recipe), train_ds, val_ds, log_fn=logs.append,
                                device="cpu")
    want_keys = {f"{split}_{jax_loop._REF_NAMES[k]}" for split in ("train", "val")
                 for k in jax_loop._METRIC_KEYS[recipe]} | {"best_epoch"}
    assert set(metrics) == want_keys
    assert len(metrics["train_loss"]) == len(metrics["val_loss"]) == 2
    assert all(np.isfinite(v).all() for k, v in metrics.items())
    assert metrics["best_epoch"] in (1, 2)
    assert state.step == 4 and len(logs) == 2 and logs[0].startswith("epoch 1/2")
    if recipe != "scale_invariance":
        assert "train_dsloss" in metrics and "val_perceploss" in metrics


def test_training_reduces_loss_with_partial_last_batch():
    """drop_remainder=False: 10 samples at batch 4 give a tail batch of 2,
    and the epoch means take it in."""
    train_ds, val_ds = _small_dataset(10, 3), _small_dataset(5, 4)
    state, metrics = train_loop(_tiny_config("gradftm", n_epochs=3, step_metrics=False),
                                train_ds, val_ds, log_fn=lambda s: None, device="cpu")
    assert state.step == 9
    assert metrics["train_loss"][-1] < metrics["train_loss"][0]
    assert "train_psnr" not in metrics and "val_ssim" not in metrics


def test_loop_returns_best_state_on_early_stop(monkeypatch):
    """With patience 1 and a validation loss forced to rise, the loop stops
    and hands back the epoch-1 weights, not the last ones."""
    import sifsr_tpu_torch.train.loop as loop_mod

    real = loop_mod.make_eval_step
    calls = {"n": 0}

    def rising(*a, **kw):
        step = real(*a, **kw)

        def eval_step(state, batch):
            calls["n"] += 1
            m = step(state, batch)
            m["loss"] = m["loss"] * 0 + float(calls["n"])
            return m
        return eval_step

    monkeypatch.setattr(loop_mod, "make_eval_step", rising)
    seen = {}
    real_update = EarlyStopping.update

    def spy(self, epoch, value, state):
        seen[epoch] = {k: v.clone() for k, v in state.items()}
        return real_update(self, epoch, value, state)

    monkeypatch.setattr(EarlyStopping, "update", spy)
    state, metrics = train_loop(_tiny_config("scale_invariance", n_epochs=5, patience=1),
                                _small_dataset(4, 1), _small_dataset(2, 2),
                                log_fn=lambda s: None, device="cpu")
    assert metrics["best_epoch"] == 1 and len(metrics["val_loss"]) == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, seen[1][k]), k
    assert not torch.equal(seen[1]["outlay.weight"], seen[2]["outlay.weight"])


def test_checkpoint_resume(tmp_path):
    """Interrupt after 2 epochs; a fresh loop resumes and completes to 4 with
    the first run's history kept exactly, and lands where an uninterrupted
    4-epoch run lands (model, optimiser moments and step restored)."""
    ckpt = str(tmp_path / "ckpt")
    train_ds, val_ds = _small_dataset(8, 5), _small_dataset(4, 6)
    quiet = dict(log_fn=lambda s: None, device="cpu")
    _, metrics_a = train_loop(_tiny_config("predef_filters", n_epochs=2), train_ds, val_ds,
                              checkpoint_dir=ckpt, **quiet)
    logs = []
    state_b, metrics_b = train_loop(_tiny_config("predef_filters", n_epochs=4), train_ds, val_ds,
                                    checkpoint_dir=ckpt, log_fn=logs.append, device="cpu")
    assert any("resumed from epoch 2" in line for line in logs)
    assert len(metrics_b["train_loss"]) == 4
    assert metrics_b["train_loss"][:2] == metrics_a["train_loss"]
    assert state_b.step == 8
    assert sorted(os.listdir(ckpt)) == ["epoch_000002.pt", "epoch_000003.pt", "epoch_000004.pt"]

    state_c, metrics_c = train_loop(_tiny_config("predef_filters", n_epochs=4), train_ds, val_ds,
                                    **quiet)
    np.testing.assert_allclose(metrics_b["train_loss"], metrics_c["train_loss"], rtol=1e-5)
    for (k, b), c in zip(state_b.model.state_dict().items(), state_c.model.state_dict().values()):
        torch.testing.assert_close(b, c, rtol=1e-4, atol=1e-6, msg=k)


def test_checkpoint_manager_keeps_best_and_extra(tmp_path):
    model = ModelB2()
    state = create_train_state(model, 1e-3, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    assert mgr.latest_epoch() is None
    best = {k: v.clone() for k, v in model.state_dict().items()}
    for epoch in (1, 2, 3):
        state.step = 10 * epoch
        mgr.save_epoch(epoch, state, {"metrics": {"train_loss": [0.5] * epoch}, "best_epoch": 1},
                       best_state=best if epoch > 1 else None)
    assert mgr.latest_epoch() == 3 and mgr._epochs() == [2, 3]
    fresh = create_train_state(ModelB2(), 1e-3, generator=torch.Generator().manual_seed(9),
                               device="cpu")
    fresh, extra, got_best = mgr.restore_epoch(3, fresh)
    assert fresh.step == 30 and extra["metrics"]["train_loss"] == [0.5, 0.5, 0.5]
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v) and torch.equal(got_best[k], v)


def test_bf16_mixed_precision_learns():
    """bf16 compute dtype (float32 master weights and BN statistics): the
    step runs, the loss falls, and the parameters stay float32."""
    train_ds, val_ds = _small_dataset(8, 7), _small_dataset(4, 8)
    state, metrics = train_loop(_tiny_config("predef_filters", n_epochs=3, precision="bf16"),
                                train_ds, val_ds, log_fn=lambda s: None, device="cpu")
    assert state.model.dtype == torch.bfloat16 and state.model.precision == "default"
    assert metrics["train_loss"][-1] < metrics["train_loss"][0]
    assert all(v.dtype == torch.float32 for k, v in state.model.state_dict().items()
               if "num_batches_tracked" not in k)


def test_cli_train_main_on_geotiff_manifest(tmp_path, rng, capsys):
    """cli.train.main end to end on a three-patch GeoTIFF manifest (two
    Train, one Val), on the CPU: weights, lossdata, params copy and curves."""
    (tmp_path / "pairs").mkdir()
    rows = []
    for i in range(3):
        ndvi = (0.3 + 0.2 * rng.random((256, 256))).astype(np.float32)
        lst = (300.0 - 20.0 * ndvi[::4, ::4] + 0.05 * rng.normal(size=(64, 64))).astype(np.float32)
        lst_p = tmp_path / "pairs" / f"MOD21A1D_day.A2020{100 + i:03d}.{i}.tif"
        ndvi_p = tmp_path / "pairs" / f"MOD09GQ.A2020{100 + i:03d}.{i}.tif"
        write_geotiff(str(lst_p), lst)
        write_geotiff(str(ndvi_p), ndvi)
        rows.append({"LST": str(lst_p), "NDVI": str(ndvi_p), "split": "Train" if i < 2 else "Val"})
    with open(tmp_path / "ModisDatasetB.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["LST", "NDVI", "split"])
        w.writeheader()
        w.writerows(rows)
    with open(os.path.join(ROOT, "paramsB.json")) as f:
        params = json.load(f)
    params["hyperparameters"].update(batch_size=2, n_epochs=2)
    save_path = tmp_path / "run"
    params["save_parameters"]["save_path"] = str(save_path)
    (tmp_path / "params.json").write_text(json.dumps(params))
    (tmp_path / "statistics.json").write_text(json.dumps(
        dict(maxi=330.0, mini=260.0, mean_lst=295.0, std_lst=10.0, mean_ndvi=0.3, std_ndvi=0.25)))
    argv = ["--params", str(tmp_path / "params.json"), "--recipe", "gradftm",
            "--statistics", str(tmp_path / "statistics.json"),
            "--csv", str(tmp_path / "ModisDatasetB.csv"), "--device", "cpu"]
    cli_train.main(argv)
    out = capsys.readouterr().out
    assert "train=2 val=1" in out and "best epoch" in out
    files = set(os.listdir(save_path))
    assert {"modelB_state_dict.pt", "modelB_lossdata.pkl", "modelB_train_params.json",
            "modelB_loss.png", "modelB_dsloss.png", "modelB_psnr.png"} <= files
    with open(save_path / "modelB_lossdata.pkl", "rb") as f:
        metrics = pickle.load(f)
    assert len(metrics["train_loss"]) == 2 and np.isfinite(metrics["val_perceploss"]).all()
    ModelB2().load_state_dict(load_variables(str(save_path)), strict=True)
    # an existing save directory is not overwritten
    with pytest.raises(SystemExit) as stop:
        cli_train.main(argv)
    assert stop.value.code == 0
    assert "already exists" in capsys.readouterr().out
