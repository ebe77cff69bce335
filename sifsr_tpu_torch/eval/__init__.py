"""Evaluation of the port: batched metrics on the device, the spectra, and
the ASTER evaluation harness (``eval.harness``)."""

from sifsr_tpu_torch.eval.metrics import (
    gradient_rmse,
    gssim,
    psnr,
    psnr_batch_mean,
    rmse,
    ssim,
    ssim_batch_mean,
    stratified_rmse,
)
from sifsr_tpu_torch.eval.spectra import afr, attenuation_spectrum, fro, frr, fru, pfr

__all__ = ["psnr", "psnr_batch_mean", "ssim", "ssim_batch_mean", "gssim", "rmse",
           "gradient_rmse", "stratified_rmse", "attenuation_spectrum", "pfr", "afr", "frr",
           "fro", "fru"]
