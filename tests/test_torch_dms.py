"""The port's Data-Mining Sharpener (``sifsr_tpu_torch.baselines.dms`` on
``baselines.forest``, torch on the CPU here) against the JAX package's
(scikit-learn's bagged trees) on the same seeded numpy inputs.

Every tree has scikit-learn's leaf count and split thresholds, and the
sharpened LST is within 1e-4 K (the residual correction's float32 bicubic
of T⁴ residuals is ``ops.resize``'s here and ``jnp``'s there), on
continuous LST and on LST in MODIS's 0.02 K steps, whose duplicate targets
tie candidate splits in exact arithmetic."""

import numpy as np
import pytest
import torch
from sklearn import ensemble, tree

from sifsr_tpu.baselines.dms import DecisionTreeSharpener as JaxSharpener
from sifsr_tpu.baselines.dms import LeafLinearTreeRegressor

from sifsr_tpu_torch.baselines.dms import DecisionTreeSharpener, dms_sharpen
from sifsr_tpu_torch.baselines.forest import BaggedTrees, bootstrap_counts

TOL_K = 1e-4


def _scene(seed, n, quantised=False):
    """A coarse (n, n) LST and its fine (4n, 4n) NDVI: smooth fields plus
    noise, anticorrelated, continuous values; ``quantised`` rounds the LST
    to MODIS's 0.02 K steps."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:4 * n, 0:4 * n]
    ndvi = (0.3 + 0.25 * np.sin(yy / 9.0) + 0.2 * np.cos(xx / 7.0)
            + 0.05 * rng.standard_normal((4 * n, 4 * n)))
    lst = 310.0 - 18.0 * ndvi + 0.5 * rng.standard_normal(ndvi.shape)
    lst = lst.reshape(n, 4, n, 4).mean(axis=(1, 3))
    if quantised:
        lst = np.round(lst / 0.02) * 0.02
    return lst.astype(np.float32), ndvi


def _sharpen(cls, ndvi, lst, mw, **kw):
    s = cls(factor=4, moving_window_size=mw, **kw).train(ndvi, lst)
    return s, s.residual_correction(s.apply(ndvi, lst if mw else None), lst)


def _assert_same_trees(port, ref):
    """Leaf counts and sorted thresholds of every tree of a fitted
    BaggedTrees against a fitted BaggingRegressor."""
    assert port.n_leaves() == [int(e.get_n_leaves()) for e in ref.estimators_]
    for i, e in enumerate(ref.estimators_):
        want = np.sort(e.tree_.threshold[e.tree_.feature >= 0])
        np.testing.assert_array_equal(port.thresholds(i), want)


CASES = {
    "16": dict(n=16, mw=0),
    "32": dict(n=32, mw=0),
    "16-window8": dict(n=16, mw=8),
    "32-no-leaf-ridge": dict(n=32, mw=0, per_leaf_linear_regression=False),
    "16-quantised": dict(n=16, mw=0, quantised=True),
    "32-quantised": dict(n=32, mw=0, quantised=True),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    opts = dict(CASES[request.param])
    n, mw, quantised = opts.pop("n"), opts.pop("mw"), opts.pop("quantised", False)
    lst, ndvi = _scene(3, n, quantised)
    if quantised:  # coarse pixels share values: 226 of 256 distinct, 554 of 1024
        assert np.unique(lst).size < 0.9 * lst.size
    ref, want = _sharpen(JaxSharpener, ndvi, lst, mw, **opts)
    port, got = _sharpen(DecisionTreeSharpener, ndvi, lst, mw, device="cpu", **opts)
    return request.param, ref, want, port, got


def test_dms_trees_equal_sklearn(case):
    name, ref, _, port, _ = case
    _assert_same_trees(port.reg, ref.reg)
    if name == "32-no-leaf-ridge":
        assert port.reg.n_leaves() == [30] * 10  # best-first, max_leaf_nodes=30
    elif name == "32":
        assert min(port.reg.n_leaves()) > 400  # full depth: the clone drops the options
    assert len(port.local_regs) == len(ref.local_regs)
    for (win_p, reg_p), (win_r, reg_r) in zip(port.local_regs, ref.local_regs):
        assert win_p == win_r
        assert (reg_p is None) == (reg_r is None)
        if reg_r is not None:
            _assert_same_trees(reg_p, reg_r)
    if name == "16-window8":
        assert sum(r is not None for _, r in port.local_regs) == 4


def test_dms_output_matches_jax(case):
    _, _, want, _, got = case
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL_K


def test_bootstrap_counts_equal_sklearn(case):
    """The weighted bootstrap draws of every tree (BaggingRegressor's
    estimators_samples_)."""
    _, ref, _, port, _ = case
    n = ref.reg.estimators_samples_[0].shape[0]
    want = np.stack([np.bincount(s, minlength=n) for s in ref.reg.estimators_samples_])
    np.testing.assert_array_equal(port.reg.counts_, want)


def test_dms_sharpen_matches_jax():
    from sifsr_tpu.baselines.dms import dms_sharpen as jax_dms_sharpen

    lst, ndvi = _scene(11, 16)
    got = dms_sharpen(lst, ndvi, factor=4, device="cpu")
    want = jax_dms_sharpen(lst, ndvi, factor=4)
    assert np.abs(got - want).max() <= TOL_K


@pytest.mark.parametrize("per_leaf", [True, False])
def test_nan_fine_ndvi_as_jax(per_leaf):
    """A NaN fine NDVI: with leaf ridges both packages refuse it
    (scikit-learn's Ridge.predict raises ValueError); without them the trees
    walk NaN to the side that held more training rows, the same values."""
    lst, ndvi = _scene(5, 16)
    ref = JaxSharpener(factor=4, per_leaf_linear_regression=per_leaf).train(ndvi, lst)
    port = DecisionTreeSharpener(factor=4, per_leaf_linear_regression=per_leaf,
                                 device="cpu").train(ndvi, lst)
    holed = ndvi.copy()
    holed[5, 7] = holed[40, 2] = np.nan
    if per_leaf:
        with pytest.raises(ValueError):
            ref.apply(holed)
        with pytest.raises(ValueError):
            port.apply(holed)
    else:
        want, got = ref.apply(holed), port.apply(holed)
        assert np.isfinite(got[5, 7]) and np.isfinite(got[40, 2])
        assert np.abs(got - want).max() <= TOL_K


def _two_feature_data(seed=8, n=300):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 2))
    y = 300.0 + 10.0 * x[:, 0] - 4.0 * x[:, 1] ** 2 + 0.2 * rng.standard_normal(n)
    return x, y, rng.random(n)


def test_two_features_partition_as_sklearn():
    """Two features (dms_rasters' multi-band case): every tree splits its
    drawn rows as scikit-learn's does. Where both features split a node's
    rows alike, scikit-learn takes the feature it visits first, in a random
    order, and the port the lower index: thresholds may differ there, the
    leaves of the drawn rows do not."""
    x, y, w = _two_feature_data()
    ref = ensemble.BaggingRegressor(tree.DecisionTreeRegressor(), n_estimators=10,
                                    random_state=4).fit(x, y, sample_weight=w)
    port = BaggedTrees(10, leaf_ridge=False, random_state=4, device="cpu").fit(x, y, w)
    assert port.n_leaves() == [int(e.get_n_leaves()) for e in ref.estimators_]
    values = port.trees_.value[port.trees_.apply(torch.as_tensor(x))].numpy()
    for i, e in enumerate(ref.estimators_):
        drawn = port.counts_[i] > 0
        np.testing.assert_allclose(values[i, drawn], e.predict(x[drawn]), rtol=0, atol=1e-9)


def test_duplicate_feature_takes_the_lower_index():
    """A feature that copies another ties it at every split: the port
    splits on feature 0 everywhere, the trees of the one-feature fit."""
    x, y, w = _two_feature_data()
    one = BaggedTrees(10, leaf_ridge=False, random_state=4, device="cpu").fit(x[:, :1], y, w)
    two = BaggedTrees(10, leaf_ridge=False, random_state=4, device="cpu").fit(
        np.repeat(x[:, :1], 2, axis=1), y, w)
    inner = ~two.trees_.leaf
    assert (two.trees_.feature[inner] == 0).all()
    assert two.n_leaves() == one.n_leaves()
    for i in range(10):
        np.testing.assert_array_equal(two.thresholds(i), one.thresholds(i))
    np.testing.assert_array_equal(two.predict(np.repeat(x[:, :1], 2, axis=1)),
                                  one.predict(x[:, :1]))


def test_two_feature_leaf_ridges_as_sklearn_ridge():
    """The leaf ridges on two features: each value group of a tree against
    scikit-learn's Ridge(alpha=1) fitted on the group's rows."""
    from sklearn.linear_model import Ridge

    x, y, w = _two_feature_data()
    port = BaggedTrees(3, random_state=4, device="cpu").fit(x, y, w)
    table, first, coef, intercept, lo, hi = port.groups_
    values = port.trees_.value[port.trees_.apply(torch.as_tensor(x))].numpy()
    for t in range(3):
        groups = np.unique(values[t])
        np.testing.assert_array_equal(table[t, :len(groups)].numpy(), groups)
        for k, v in enumerate(groups):
            sel = values[t] == v
            ridge = Ridge().fit(x[sel], y[sel])
            g = int(first[t]) + k
            np.testing.assert_allclose(coef[g].numpy(), ridge.coef_, rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(float(intercept[g]), ridge.intercept_, rtol=1e-12)
            span = y[sel].max() - y[sel].min()
            assert float(lo[g]) == y[sel].min() - 0.25 * span
            assert float(hi[g]) == y[sel].max() + 0.25 * span


def test_bootstrap_seeds_as_sklearn():
    """The draws follow RandomState(seed).randint(2**31 - 1) per tree, and
    RandomState(seeds[i]).choice(n, n, p=w / w.sum())."""
    w = np.linspace(0.0, 1.0, 50)
    counts = bootstrap_counts(w, 3, 7)
    seeds = np.random.RandomState(7).randint(2 ** 31 - 1, size=3)
    for c, s in zip(counts, seeds):
        idx = np.random.RandomState(s).choice(50, 50, replace=True, p=w / w.sum())
        np.testing.assert_array_equal(c, np.bincount(idx, minlength=50))
    assert counts[:, 0].sum() == 0  # weight 0 is never drawn
    assert counts.sum() == 150


def test_leaf_refinement_chain_as_sklearn():
    """The leaf ridges refine in place, groups in ascending value order: a
    refined value equal to a later group's value is refined again by that
    group, one equal to an earlier group's is not. Crafted groups against
    LeafLinearTreeRegressor.predict's loop."""
    values = np.array([1.0, 2.0, 3.0, 4.0])
    coef = np.array([0.0, 0.0, 0.0, 0.5])
    intercept = np.array([2.0, 3.0, 9.0, 0.0])  # 1 -> 2 -> 3 -> 9; 4 -> 0.5 x
    lo, hi = np.full(4, -100.0), np.full(4, 100.0)
    x = np.array([0.1, 0.2, 2.0, 4.0, 8.0])
    pred = np.array([1.0, 2.0, 4.0, 4.0, 3.0])

    want = pred.copy()
    for k, v in enumerate(values):
        sel = want == v
        want[sel] = np.clip(coef[k] * x[sel] + intercept[k], lo[k], hi[k])

    bt = BaggedTrees(1, device="cpu")
    d = torch.float64
    bt.groups_ = (torch.tensor(values[None], dtype=d), torch.tensor([0]),
                  torch.tensor(coef[:, None], dtype=d), torch.tensor(intercept, dtype=d),
                  torch.tensor(lo, dtype=d), torch.tensor(hi, dtype=d))
    got = bt._refine(torch.tensor(x[:, None], dtype=d), torch.tensor(pred[None], dtype=d))[0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [9.0, 9.0, 1.0, 2.0, 9.0])


def test_leaf_refinement_chain_on_a_fitted_forest():
    """At 64² coarse (this scene, seed 3) one pixel's refined value equals a
    later group's value exactly (a leaf of one row, value y, and its
    neighbour of value y - 1 ulp; the one-row group clips to [y, y]):
    LeafLinearTreeRegressor.predict's loop, over the port's own groups,
    gives the same bagged prediction on that pixel and 3,000 others.
    (Against scikit-learn itself the 64² fit is too slow for these tests;
    it was equal, bit for bit, when measured.)"""
    lst, ndvi = _scene(3, 64)
    reg = DecisionTreeSharpener(factor=4, device="cpu").train(ndvi, lst).reg
    table, first, coef, intercept, lo, hi = (t.numpy() for t in reg.groups_)
    x = ndvi.reshape(-1)
    values = reg.trees_.value[reg.trees_.apply(torch.as_tensor(x[:, None]))].numpy()
    # the pixels whose refined value lands on a later group's value
    chained = []
    for t in range(reg.n_estimators):
        g = first[t] + np.searchsorted(table[t], values[t])
        refined = np.clip(x * coef[g, 0] + intercept[g], lo[g], hi[g])
        later = np.isin(refined, table[t][np.isfinite(table[t])]) & (refined > values[t])
        chained.extend(np.flatnonzero(later).tolist())
    assert chained
    idx = np.unique(np.concatenate([chained, np.random.default_rng(0).choice(x.size, 3000)]))
    want = np.zeros(idx.size)
    for t in range(reg.n_estimators):
        y = values[t, idx].copy()
        for k, v in enumerate(table[t][np.isfinite(table[t])]):
            sel = y == v
            g = first[t] + k
            y[sel] = np.clip(x[idx][sel] * coef[g, 0] + intercept[g], lo[g], hi[g])
        want = want + y
    np.testing.assert_array_equal(reg.predict(x[idx]), want / reg.n_estimators)
