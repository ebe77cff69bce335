"""Data-Mining Sharpener (Gao et al. 2012), compact patch-aligned rebuild.

Port of ``sifsr_tpu/baselines/dms.py``. The numpy around the regressor is
the JAX package's, line for line; the regressor is ``baselines.forest``'s
``BaggedTrees``, fitted and applied in torch on ``device`` (default
``cuda``), and the bicubic x4 of the residuals is ``ops.resize``'s in
float32 on the same device, as the JAX package casts it.

Covers the configuration the reference's evaluation actually uses
(model_perf_aster_formatds.py:230-250 on already-aligned patches, i.e. the
behaviour of data_mining_sharpener_modified.py with movingWindowSize=0):

- training pairs: NDVI aggregated to the coarse grid (per-block mean) vs the
  coarse LST; sub-pixel homogeneity CV = mean over bands of (block std /
  block mean) selects/weights samples (auto threshold at the 80th percentile,
  heterogeneous samples' weights halved);
- regressor: bagged ensemble (default 10 trees) of decision trees with a
  ridge regression per leaf, extrapolation clamped to leaf_range * ratio
  beyond each leaf's target range. The tree options max_leaf_nodes=30,
  min_samples_leaf=10 hold only without leaf ridges: the JAX package's
  leaf-ridge tree keeps its options outside ``get_params``, so scikit-learn's
  bagging clones it with the defaults and grows every tree to full depth;
  the port does the same (ROADMAP.md §3);
- prediction: per fine pixel from its NDVI;
- residual (bias) correction in radiance space: coarse residual
  LST⁴ - blockmean(pred⁴), bicubic-upsampled x4, added to pred⁴, ^0.25.

The Gao 2012 §2.3 moving-window local-regression machinery
(data_mining_sharpener.py:649-872) is available via moving_window_size > 0:
per-window local models (trained on 25%-extended windows), combined with the
global model by inverse squared coarse residuals in radiance space. The
reference's patch evaluation disables it ("Only way to work with patches ==
removing local regs", model_perf_aster_formatds.py:235), so the eval harness
default stays 0.
"""

from __future__ import annotations

import numpy as np
import torch

from sifsr_tpu_torch.baselines.forest import BaggedTrees
from sifsr_tpu_torch.device import full_f32, resolve_device
from sifsr_tpu_torch.ops.resize import upsample_bicubic

__all__ = ["DecisionTreeSharpener", "dms_sharpen"]


def _aggregate_blocks(fine: np.ndarray, factor: int):
    """Per coarse-cell mean and std of a fine (H, W) or (H, W, B) image."""
    if fine.ndim == 2:
        fine = fine[..., None]
    h, w, b = fine.shape
    blocks = fine.reshape(h // factor, factor, w // factor, factor, b)
    return blocks.mean(axis=(1, 3)), blocks.std(axis=(1, 3))


class DecisionTreeSharpener:
    """Patch-aligned DMS. train() -> apply() -> residual_correction()."""

    def __init__(
        self,
        cv_homogeneity_threshold: float = 0.0,
        minimum_sample_number: int = 10,
        disaggregating_temperature: bool = True,
        per_leaf_linear_regression: bool = True,
        extrapolation_ratio: float = 0.25,
        n_estimators: int = 10,
        factor: int = 4,
        random_state: int | None = 0,
        moving_window_size: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.cv_threshold = cv_homogeneity_threshold
        self.auto_threshold = cv_homogeneity_threshold <= 0
        self.min_samples = minimum_sample_number
        self.disaggregating_temperature = disaggregating_temperature
        self.per_leaf = per_leaf_linear_regression
        self.extrapolation_ratio = extrapolation_ratio
        self.n_estimators = n_estimators
        self.factor = factor
        self.random_state = random_state
        # Gao 2012 §2.3 moving-window local regressors (reference
        # data_mining_sharpener.py:649-872): windows of moving_window_size
        # coarse px, training samples drawn from the window extended by 25%
        # on each side (:568), one local model per window, combined with the
        # global model by inverse squared coarse residuals at apply time.
        # 0 = global model only (the reference's patch-eval configuration,
        # model_perf_aster_formatds.py:235).
        self.moving_window_size = int(moving_window_size)
        self.moving_window_extension = self.moving_window_size * 0.25
        self.reg = None
        self.local_regs: list = []

    # ------------------------------------------------------------- training

    def _fit_window(self, mean, lst_coarse, cv, rows, cols):
        """Sample selection + bagged fit on one (extended) coarse window;
        returns None when the window lacks minimum_sample_number good px
        (reference :686-688)."""
        cv_w = cv[rows, cols]
        good = (
            np.isfinite(lst_coarse[rows, cols])
            & ~np.any(np.isnan(mean[rows, cols]), axis=-1)
            & (cv_w > 0)
            & (cv_w < 1000)
        )
        if good.sum() < self.min_samples:
            return None
        threshold = (
            np.percentile(cv_w[good], 80) if self.auto_threshold else self.cv_threshold
        )
        homogeneous = (cv_w < threshold) & (cv_w > 0)
        x = mean[rows, cols][good]
        y = np.asarray(lst_coarse, np.float64)[rows, cols][good]
        w = 1.0 / cv_w[good]
        if w.size > 1:
            rng_w = w.max() - w.min()
            w = (w - w.min()) / rng_w if rng_w > 0 else np.ones_like(w)
            w[~homogeneous[good]] /= 2.0

        # with leaf ridges the trees take the defaults (no leaf limit, one row
        # a leaf), as scikit-learn's clone leaves the JAX package's tree
        tree_opts = ({} if self.per_leaf else
                     {"max_leaf_nodes": 30, "min_samples_leaf": min(self.min_samples, 10)})
        reg = BaggedTrees(self.n_estimators, leaf_ridge=self.per_leaf,
                          extrapolation_ratio=self.extrapolation_ratio,
                          random_state=self.random_state, device=self.device, **tree_opts)
        reg.fit(x, y, sample_weight=w)
        return reg

    def train(self, ndvi_fine: np.ndarray, lst_coarse: np.ndarray) -> "DecisionTreeSharpener":
        mean, std = _aggregate_blocks(np.asarray(ndvi_fine, np.float64), self.factor)
        safe_mean = np.where(mean == 0, 1e-6, mean)
        cv = (std / safe_mean).mean(axis=-1)
        cv[np.isnan(cv)] = 1000.0
        gh, gw = cv.shape

        self.local_regs = []
        if self.moving_window_size > 0:
            m, ext = self.moving_window_size, self.moving_window_extension
            for y0 in range(0, gh, m):
                for x0 in range(0, gw, m):
                    rows = slice(int(max(y0 - ext, 0)), int(min(y0 + m + ext, gh)))
                    cols = slice(int(max(x0 - ext, 0)), int(min(x0 + m + ext, gw)))
                    reg = self._fit_window(mean, lst_coarse, cv, rows, cols)
                    # extents saved UNextended (reference :660-665)
                    self.local_regs.append(
                        ((slice(y0, min(y0 + m, gh)), slice(x0, min(x0 + m, gw))), reg)
                    )

        self.reg = self._fit_window(
            mean, lst_coarse, cv, slice(0, gh), slice(0, gw)
        )
        if self.reg is None:
            raise ValueError("not enough valid training samples for DMS")
        return self

    # -------------------------------------------------------------- predict

    def _predict_fine(self, reg, fine: np.ndarray) -> np.ndarray:
        h, w, b = fine.shape
        return reg.predict(fine.reshape(-1, b)).reshape(h, w)

    def apply(self, ndvi_fine: np.ndarray, lst_coarse: np.ndarray | None = None) -> np.ndarray:
        """Disaggregate. With moving windows trained, local predictions are
        combined with the global one by inverse squared coarse residuals in
        radiance space (reference :800-858); without lst_coarse the windowed
        prediction is used alone (:856-858). Windows that could not train a
        model fall back to the global prediction (NaN-robust deviation from
        the reference, which leaves NaN holes there)."""
        if self.reg is None:
            raise RuntimeError("call train() first")
        fine = np.asarray(ndvi_fine, np.float64)
        if fine.ndim == 2:
            fine = fine[..., None]
        full = self._predict_fine(self.reg, fine)
        if not any(reg is not None for _, reg in self.local_regs):
            return full

        f = self.factor
        windowed = full.copy()
        has_local = np.zeros(full.shape, bool)
        for (rows, cols), reg in self.local_regs:
            if reg is None:
                continue
            hr_rows = slice(rows.start * f, rows.stop * f)
            hr_cols = slice(cols.start * f, cols.stop * f)
            windowed[hr_rows, hr_cols] = self._predict_fine(
                reg, fine[hr_rows, hr_cols]
            )
            has_local[hr_rows, hr_cols] = True
        if lst_coarse is None:
            return windowed

        # combine by inverse squared coarse residuals (Gao 2012 §2.3)
        lst = np.asarray(lst_coarse, np.float64)
        if self.disaggregating_temperature:
            rw = lst**4 - _aggregate_blocks(windowed**4, f)[0][..., 0]
            rf = lst**4 - _aggregate_blocks(full**4, f)[0][..., 0]
        else:
            rw = lst - _aggregate_blocks(windowed, f)[0][..., 0]
            rf = lst - _aggregate_blocks(full, f)[0][..., 0]
        eps = 1e-12
        ww_lr = (1.0 / np.maximum(rw**2, eps)) / (
            (1.0 / np.maximum(rw**2, eps)) + (1.0 / np.maximum(rf**2, eps))
        )
        ww = np.asarray(self._upsample(ww_lr, f), np.float64)
        ww = np.clip(ww, 0.0, 1.0)
        ww[~has_local] = 0.0
        if self.disaggregating_temperature:
            return ((windowed**4) * ww + (full**4) * (1.0 - ww)) ** 0.25
        return windowed * ww + full * (1.0 - ww)

    def _upsample(self, lr: np.ndarray, factor: int) -> np.ndarray:
        """Bicubic x``factor`` in float32 on the device, back as float32."""
        x = torch.as_tensor(np.asarray(lr, np.float32), device=self.device)
        with full_f32():
            return upsample_bicubic(x, factor).cpu().numpy()

    def residual_correction(self, pred_fine: np.ndarray, lst_coarse: np.ndarray) -> np.ndarray:
        """Radiance-space bias correction (reference :1040-1084, :956-965)."""
        if self.disaggregating_temperature:
            pred_rad = np.asarray(pred_fine, np.float64) ** 4
            agg, _ = _aggregate_blocks(pred_rad, self.factor)
            residual_lr = np.asarray(lst_coarse, np.float64) ** 4 - agg[..., 0]
            residual_hr = self._upsample(residual_lr, self.factor)
            return np.power(np.maximum(residual_hr + pred_rad, 0.0), 0.25)
        agg, _ = _aggregate_blocks(np.asarray(pred_fine, np.float64), self.factor)
        residual_lr = lst_coarse - agg[..., 0]
        residual_hr = self._upsample(residual_lr, self.factor)
        return pred_fine + residual_hr


def dms_sharpen(lst_coarse: np.ndarray, ndvi_fine: np.ndarray, factor: int = 4,
                moving_window_size: int = 0,
                device: str | torch.device = "cuda") -> np.ndarray:
    """One-call DMS with the evaluation harness's options
    (model_perf_aster_formatds.py:230-250; movingWindowSize=0 there).
    moving_window_size > 0 enables the Gao 2012 §2.3 local regressors; the
    regressors are fitted and applied on ``device``."""
    sharpener = DecisionTreeSharpener(factor=factor,
                                      moving_window_size=moving_window_size,
                                      device=device)
    sharpener.train(ndvi_fine, lst_coarse)
    pred = sharpener.apply(ndvi_fine,
                           lst_coarse if moving_window_size > 0 else None)
    return sharpener.residual_correction(pred, lst_coarse)
