"""Training steps of the port against the JAX package: one train and one
eval step of each recipe from the same converted variables, the torch golden
step, early stopping, rematerialisation, the seeded init and the final
weights file."""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sifsr_tpu.losses import losses as jax_losses
from sifsr_tpu.models.convert import load_torch_checkpoint as jax_load_torch_checkpoint
from sifsr_tpu.models.unet import ModelB2 as JaxModelB2
from sifsr_tpu.train.state import create_train_state as jax_create_train_state
from sifsr_tpu.train.step import make_eval_step as jax_make_eval_step
from sifsr_tpu.train.step import make_train_step as jax_make_train_step

from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data import make_synthetic_dataset
from sifsr_tpu_torch.data.datasets import prepare_batch
from sifsr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from sifsr_tpu_torch.models.unet import ModelB2
from sifsr_tpu_torch.train import (
    EarlyStopping,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from sifsr_tpu_torch.train.checkpoint import load_final, save_final

from conftest import require_golden

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
WEIGHTS = os.path.join(ROOT, "weights", "modelB_1009")
MEAN, STD, ALPHA, GAMMA = 295.0, 10.0, 0.99, -0.5
RECIPES = ["predef_filters", "gradftm", "scale_invariance"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and the
    float32 sums of a conv backward depend on the thread count, which the
    first Adam step amplifies where a gradient is near its eps of 1e-8."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _small_batch(rng, recipe):
    """Batch 2 at a small size (64² model input, 16² LST), seeded numpy."""
    hw = 64
    lst_hw = hw if recipe == "scale_invariance" else hw // 4
    return {
        "lst": rng.normal(size=(2, lst_hw, lst_hw, 1)).astype(np.float32),
        "lst_up": rng.normal(size=(2, hw, hw, 1)).astype(np.float32),
        "ndvi": rng.normal(size=(2, hw, hw, 1)).astype(np.float32),
    }


def _assert_params_close(got_tree, want_tree):
    """The bounds of the JAX package's golden-step test: Adam normalises by
    sqrt(v), so float32 summation-order noise in a tiny gradient is amplified
    toward the lr scale in a handful of elements; a real fault moves every
    weight at the lr scale (1e-3)."""
    got, want = dict(_leaves(got_tree["params"])), dict(_leaves(want_tree["params"]))
    assert got.keys() == want.keys()
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in got])
    assert float(np.quantile(diffs, 0.999)) < 1e-4
    assert float(diffs.max()) < 1e-3
    got, want = dict(_leaves(got_tree["batch_stats"])), dict(_leaves(want_tree["batch_stats"]))
    assert got.keys() == want.keys()
    assert max(float(np.abs(got[k] - want[k]).max()) for k in got) < 5e-5


@pytest.fixture()
def jax_kernel_ds_loss(monkeypatch):
    """The JAX side takes ds_loss through its Pallas kernel (interpret mode),
    as it does on a TPU; nothing in the package changes."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr("sifsr_tpu.pallas.fused_ops.pl.pallas_call", interp_call)
    monkeypatch.setattr(jax_losses, "ds_loss",
                        functools.partial(jax_losses.ds_loss, use_pallas=True))


@pytest.mark.parametrize("recipe", RECIPES)
def test_train_and_eval_step_match_jax(rng, recipe, jax_kernel_ds_loss):
    """One eval step, then one train step (train-mode BN, losses, backward,
    Adam, running statistics) from the modelB_1009 variables: every metric
    within 1e-5 (relative for the dB-scale PSNR), the post-step trees within
    the golden-step bounds."""
    batch = _small_batch(rng, recipe)
    jax_model = JaxModelB2()
    jax_vars = to_jax_variables(load_variables(WEIGHTS))   # exact: a transpose of the same floats
    jax_state = jax_create_train_state(jax_model, 1e-3, variables=jax_vars)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_eval = jax_make_eval_step(jax_model, recipe, ALPHA, GAMMA, MEAN, STD)(jax_state, jbatch)
    jax_state, want_train = jax_make_train_step(jax_model, recipe, ALPHA, GAMMA, MEAN, STD)(
        jax_state, jbatch)

    model = ModelB2()
    state = create_train_state(model, 1e-3, variables=load_variables(WEIGHTS), device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got_eval = make_eval_step(model, recipe, ALPHA, GAMMA, MEAN, STD)(state, tbatch)
    state, got_train = make_train_step(model, recipe, ALPHA, GAMMA, MEAN, STD)(state, tbatch)

    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dim() == 0 and not got[k].requires_grad
            assert abs(float(got[k]) - float(want[k])) <= 1e-5 * max(1.0, abs(float(want[k]))), k
    assert state.step == 1 == int(jax_state.step)
    _assert_params_close(to_jax_variables(state.model.state_dict()),
                         jax.device_get({"params": jax_state.params,
                                         "batch_stats": jax_state.batch_stats}))


def test_golden_train_step_from_repo_weights():
    """The torch reference's own step (golden/train_step_predef.npz: batch 4
    at full size, predef_filters) from weights/modelB_1009: losses 5e-5,
    post-step parameters and BN statistics at the bounds of
    tests/test_losses.py.

    modelB_1009 is a converged model: a third of its gradients lie below
    1e-7, next to Adam's eps of 1e-8, where the first update lr*g/(|g|+eps)
    turns float32 summation noise into differences of up to 2*lr. Which
    elements land there depends on the order of the conv backward's sums,
    that is on the intra-op thread count: 8 threads reproduce the golden's
    order (max 1e-4; one thread gives q999 1.5e-4 and max 1.5e-3). So the
    stated bounds are held at 8 threads, and a bound that no thread count
    moves is held beside them: where |gradient| >= 1e-6 the update is well
    conditioned, and every parameter there agrees to 2e-5."""
    fx = np.load(require_golden("train_step_predef.npz"))
    model = ModelB2()
    state = create_train_state(model, 1e-3, variables=load_variables(WEIGHTS), device="cpu")
    step = make_train_step(model, "predef_filters", alpha=0.99, gamma=-0.5, mean_lst=295.0,
                           std_lst=10.0, with_metrics=False)
    batch = {k: torch.from_numpy(np.ascontiguousarray(np.transpose(fx[k], (0, 2, 3, 1))))
             for k in ("lst", "lst_up", "ndvi")}
    torch.set_num_threads(8)
    try:
        state, metrics = step(state, batch)
    finally:
        torch.set_num_threads(1)
    assert set(metrics) == {"loss", "ds_loss", "percep_loss"}
    for k in metrics:
        assert abs(float(metrics[k]) - float(fx[k])) < 5e-5, k
    post = {k[len("post__"):]: fx[k] for k in fx.files if k.startswith("post__")}
    _assert_params_close(to_jax_variables(state.model.state_dict()), to_jax_variables(post))
    diffs, grads = [], []
    for name, p in model.named_parameters():
        diffs.append(np.abs(p.detach().numpy() - post[name]).ravel())
        grads.append(np.abs(p.grad.numpy()).ravel())
    diffs, grads = np.concatenate(diffs), np.concatenate(grads)
    assert (grads >= 1e-6).sum() > 50_000
    assert float(diffs[grads >= 1e-6].max()) < 2e-5
    assert float(diffs.max()) <= 2e-3 + 1e-6      # no first Adam step exceeds lr


def test_variables_roundtrip_is_identity():
    sd = load_variables(WEIGHTS)
    back = from_jax_variables(to_jax_variables(sd))
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    ModelB2().load_state_dict(back, strict=True)


def test_early_stopping_reference_semantics():
    """The model_checkpoint behaviour (utils.py:667-714), as the JAX test."""
    stopper = EarlyStopping(n_epochs=10, patience=2)
    stopper.update(1, 1.0, {"w": torch.zeros(1)})
    assert stopper.best_epoch == 1 and not stopper.should_stop
    stopper.update(2, 0.5, {"w": torch.ones(1)})            # improvement
    assert stopper.best_epoch == 2 and stopper.curr_patience == 0
    stopper.update(3, 0.5, {"w": torch.full((1,), 2.0)})    # tie counts AGAINST (>=)
    assert stopper.curr_patience == 1 and not stopper.should_stop
    stopper.update(4, 0.6, {"w": torch.full((1,), 3.0)})    # worse -> patience hit
    assert stopper.should_stop
    assert stopper.best_epoch == 2
    assert float(stopper.saved_state["w"][0]) == 1.0        # best state retained


def test_early_stopping_snapshot_survives_in_place_updates():
    """state_dict() returns live tensors that Adam and BatchNorm update in
    place: the best-state snapshot must be a copy, or the "best" weights
    silently become the last ones."""
    model = ModelB2()
    state = create_train_state(model, 1e-2, device="cpu")
    stopper = EarlyStopping(n_epochs=5, patience=5)
    stopper.update(1, 1.0, state.model.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, "scale_invariance", ALPHA, GAMMA, MEAN, STD, with_metrics=False)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 16, 16, 1)).astype(np.float32))
    step(state, {"lst": x, "lst_up": x, "ndvi": x})
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert "outlay.weight" in moved and "inbloc.bloc.1.running_mean" in moved
    for k, v in stopper.saved_state.items():
        assert torch.equal(v, before[k]), k
        assert v.data_ptr() != model.state_dict()[k].data_ptr()


def test_seeded_init_is_reproducible_and_lecun_scaled():
    a = create_train_state(ModelB2(), 1e-3, generator=torch.Generator().manual_seed(3), device="cpu")
    b = create_train_state(ModelB2(), 1e-3, generator=torch.Generator().manual_seed(3), device="cpu")
    c = create_train_state(ModelB2(), 1e-3, generator=torch.Generator().manual_seed(4), device="cpu")
    sa, sb, sc = (s.model.state_dict() for s in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["inbloc.bloc.0.weight"], sc["inbloc.bloc.0.weight"])
    w = sa["ub1.convbloc.bloc.0.weight"]            # fan_in 128 * 9
    assert abs(float(w.std()) * np.sqrt(128 * 9) - 1.0) < 0.05
    assert float(sa["outlay.bias"].abs().max()) == 0.0
    assert float(sa["db1.lastconv.1.running_var"].min()) == 1.0


def test_remat_step_identical():
    """remat recomputes the forward in the backward pass: same metrics,
    parameters and BN statistics (the recomputation must not update the
    running statistics a second time)."""
    batch = prepare_batch(next(make_synthetic_dataset(2, seed=5).batches(2, seed=0)), device="cpu")
    outs = {}
    for remat in (False, True):
        model = ModelB2()
        state = create_train_state(model, 1e-3, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
        step = make_train_step(model, "predef_filters", 0.99, -0.5, MEAN, STD, remat=remat)
        outs[remat] = (step(state, batch)[1], model.state_dict())
    (m0, s0), (m1, s1) = outs[False], outs[True]
    for k in m0:
        assert float(m0[k]) == float(m1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_unknown_recipe_raises():
    with pytest.raises(ValueError, match="recipe"):
        make_train_step(ModelB2(), "sr3", ALPHA, GAMMA, MEAN, STD)


def test_save_final_read_by_both_packages(tmp_path):
    """The final weights are interchangeable: the port's load_variables and
    the JAX package's load_torch_checkpoint both read save_final's file."""
    model = ModelB2()
    state = create_train_state(model, 1e-3, generator=torch.Generator().manual_seed(1), device="cpu")
    metrics = {"train_loss": [0.3, 0.2], "val_loss": [0.4, 0.3], "best_epoch": 2}
    save_final(str(tmp_path), "modelB", state, metrics, {"hyperparameters": {"batch_size": 4}})
    assert sorted(os.listdir(tmp_path)) == ["modelB_lossdata.pkl", "modelB_state_dict.pt",
                                            "modelB_train_params.json"]
    for loaded in (load_variables(str(tmp_path)), load_final(str(tmp_path), "modelB")):
        for k, v in model.state_dict().items():
            assert torch.equal(loaded[k], v), k
    want = dict(_leaves(to_jax_variables(model.state_dict())))
    got = dict(_leaves(jax_load_torch_checkpoint(str(tmp_path / "modelB_state_dict.pt"))))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    with open(tmp_path / "modelB_lossdata.pkl", "rb") as f:
        assert pickle.load(f) == metrics

