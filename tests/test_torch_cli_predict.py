"""The port's predict command line against the JAX package's, on the CPU:
HDF and GeoTIFF inputs written in tmp_path, ``--device cpu``, two 64x64 LST
blocks at ``--batch_size 2``.

Tolerances are the steps' own: the float32 outputs agree to rtol 1e-5 /
atol 2e-4 K (tests/test_torch_int8_serving.py); the int8 commands calibrate
each on its own blocks, so float32 summation order in the calibration can
move a scale by an ulp and flip int8 quanta: RMSE 0.02 K / max 0.5 K (the
same file's bound for separately calibrated steps).
"""

import os

import numpy as np
import pytest

from sifsr_tpu.cli import predict as jax_predict

from sifsr_tpu_torch.cli import predict
from sifsr_tpu_torch.geo.hdf4 import write_hdf4_sds
from sifsr_tpu_torch.geo.tiff import read_geotiff, write_geotiff

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
COMMON = ["--model_dir", os.path.join(ROOT, "weights", "modelB_1009"),
          "--statistics", os.path.join(ROOT, "data", "statistics_testset.json"),
          "--batch_size", "2"]
GT_LST = (0.0, 926.6, 0.0, 5559752.6, 0.0, -926.6)
GT_NDVI = (0.0, 231.65, 0.0, 5559752.6, 0.0, -231.65)


def _struct_meta(h, w, gt):
    return ("GROUP=GridStructure\n"
            f"\tXDim={w}\n\tYDim={h}\n"
            f"\tUpperLeftPointMtrs=({gt[0]:.6f},{gt[3]:.6f})\n"
            f"\tLowerRightMtrs=({gt[0] + w * gt[1]:.6f},{gt[3] + h * gt[5]:.6f})\n"
            "END_GROUP=GridStructure\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One scene as an HDF pair (MOD21A1D-like LST DN, MOD09GQ-like Red/NIR
    DN) and as GeoTIFFs of the values the HDF readers decode."""
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("scene")
    lst_dn = (14600 + 900 * rng.random((64, 128))).astype(np.uint16)      # 292-310 K
    base = 0.2 + 0.3 * rng.random((256, 512))
    red = (base * 10000).astype(np.int16)
    nir = ((base + 0.3) * 10000).astype(np.int16)
    paths = {k: str(d / v) for k, v in dict(
        lst_hdf="MOD21A1D.hdf", refl_hdf="MOD09GQ.hdf", lst_tif="lst.tif", ndvi_tif="ndvi.tif",
        redn_tif="red_nir.tif", nir_tif="nir.tif", red_tif="red.tif").items()}
    write_hdf4_sds(paths["lst_hdf"], {"LST_Day_1KM": lst_dn, "QC_Day": np.zeros((64, 128), np.uint8)},
                   struct_metadata=_struct_meta(64, 128, GT_LST), deflate=True)
    write_hdf4_sds(paths["refl_hdf"], {"sur_refl_b01_1": red, "sur_refl_b02_1": nir},
                   struct_metadata=_struct_meta(256, 512, GT_NDVI), deflate=True)
    lst, _ = predict._load_lst(paths["lst_hdf"])
    ndvi, _ = predict._load_ndvi(paths["refl_hdf"], None, False)
    redf, nirf = red.astype(np.float32) * np.float32(1e-4), nir.astype(np.float32) * np.float32(1e-4)
    write_geotiff(paths["lst_tif"], lst, geotransform=GT_LST)
    write_geotiff(paths["ndvi_tif"], ndvi, geotransform=GT_NDVI)
    from tests.test_geo_tiff import _build_multiband_tiff   # chunky 2-band, no geo tags

    with open(paths["redn_tif"], "wb") as f:
        f.write(_build_multiband_tiff(np.stack([redf, nirf], axis=-1)))
    write_geotiff(paths["nir_tif"], nirf, geotransform=GT_NDVI)
    write_geotiff(paths["red_tif"], redf, geotransform=GT_NDVI)
    return paths


def _run(main, tmp_path, name, inputs, *flags, device=True):
    out = tmp_path / name
    main(["--MOD21A1D_file_path", inputs[0], "--MOD09GQ_file_path", inputs[1],
          "--save_path", str(out), *COMMON, *flags, *(["--device", "cpu"] if device else [])])
    return read_geotiff(str(out / "prediction.tiff"))


def _close_int8(got, want):
    d = got - want
    assert np.sqrt((d ** 2).mean()) <= 0.02 and np.abs(d).max() <= 0.5


def test_predict_f32_from_hdf_matches_jax_cli(files, tmp_path, capsys):
    inputs = (files["lst_hdf"], files["refl_hdf"])
    flags = ("--f32", "--pad-impl", "explicit")
    want = _run(jax_predict.main, tmp_path, "jax", inputs, *flags, device=False)
    got = _run(predict.main, tmp_path, "port", inputs, *flags)
    assert "LST (64, 128), NDVI (256, 512)" in capsys.readouterr().out
    assert got.array.shape == want.array.shape == (256, 512) and got.array.dtype == np.float32
    np.testing.assert_allclose(got.array, want.array, rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(got.geotransform, want.geotransform, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.geotransform, GT_NDVI, rtol=0, atol=1e-3)
    assert got.geo_ascii == want.geo_ascii
    assert 280.0 < got.array.min() and got.array.max() < 330.0


def test_predict_pallas_from_geotiff_matches_jax_cli(files, tmp_path):
    """--pallas from GeoTIFFs (precomputed NDVI), both --up2-impl chains."""
    inputs = (files["lst_tif"], files["ndvi_tif"])
    outs = {}
    for impl in ("mxu", "vpu"):
        flags = ("--pallas", "--up2-impl", impl, "--ndvi_is_precomputed")
        want = _run(jax_predict.main, tmp_path, f"jax_{impl}", inputs, *flags, device=False)
        outs[impl] = _run(predict.main, tmp_path, f"port_{impl}", inputs, *flags)
        _close_int8(outs[impl].array, want.array)
        assert outs[impl].geotransform == want.geotransform
    # the two chains differ by one int8 quantum at round-boundary values only
    # (about one mid-chain value in 10^4), which later requantisations can absorb
    d = outs["mxu"].array - outs["vpu"].array
    assert np.abs(d).max() < 0.5 and np.sqrt((d ** 2).mean()) < 0.02


def test_predict_int8_matches_jax_cli(files, tmp_path):
    """--int8 (models.quantized) from the HDF pair."""
    inputs = (files["lst_hdf"], files["refl_hdf"])
    want = _run(jax_predict.main, tmp_path, "jax", inputs, "--int8", device=False)
    got = _run(predict.main, tmp_path, "port", inputs, "--int8")
    _close_int8(got.array, want.array)


def test_predict_input_forms_modes_and_defaults(files, tmp_path):
    """The GeoTIFF input forms give the HDF pair's result; every --mode and
    --wire gives the host pipeline's; the default (bf16, fused pads) stays
    within the bf16 bound of the float32 step."""
    ref = _run(predict.main, tmp_path, "ref", (files["lst_hdf"], files["refl_hdf"]), "--f32")
    two_band = _run(predict.main, tmp_path, "a", (files["lst_tif"], files["redn_tif"]), "--f32")
    # the tif forms compute NDVI in float64, the HDF reader in float32
    np.testing.assert_allclose(two_band.array, ref.array, rtol=0, atol=1e-3)
    pair = _run(predict.main, tmp_path, "b", (files["lst_tif"], files["nir_tif"]), "--f32",
                "--red_file_path", files["red_tif"])
    np.testing.assert_array_equal(pair.array, two_band.array)
    for i, flags in enumerate((("--mode", "host_pipeline"), ("--mode", "device_tiling"),
                               ("--device-tiling",), ("--mode", "auto"))):
        out = _run(predict.main, tmp_path, f"m{i}", (files["lst_hdf"], files["refl_hdf"]),
                   "--f32", *flags)
        np.testing.assert_array_equal(out.array, ref.array)
    wired = [_run(predict.main, tmp_path, f"w{i}", (files["lst_hdf"], files["refl_hdf"]),
                  "--f32", *flags).array
             for i, flags in enumerate((("--mode", "device_tiling_wire"), ("--wire", "int")))]
    np.testing.assert_array_equal(wired[0], wired[1])
    # half of WIRE_LST_STEP (the LST DN encode losslessly), plus the model's
    # response to NDVI rounded to 1e-4
    assert np.abs(wired[0] - ref.array).max() <= 0.012
    bf16 = _run(predict.main, tmp_path, "bf16", (files["lst_hdf"], files["refl_hdf"]))
    d = bf16.array - ref.array
    assert np.sqrt((d ** 2).mean()) < 0.1 and np.abs(d).max() < 0.5
    overlap = _run(predict.main, tmp_path, "ov", (files["lst_hdf"], files["refl_hdf"]), "--f32",
                   "--overlap", "8")
    assert overlap.array.shape == ref.array.shape
    # blended seams move the pixels near block borders only (white-noise input)
    assert np.isfinite(overlap.array).all() and np.abs(overlap.array - ref.array).mean() < 0.5


def test_predict_refuses_unusable_inputs_cleanly(files, tmp_path):
    """The JAX CLI's messages: a single-band MOD09GQ tif without a Red band,
    a multi-band LST; and cuda is the default device."""
    def run(*args):
        predict.main(["--save_path", str(tmp_path / "x"), *COMMON, "--device", "cpu", *args])

    with pytest.raises(SystemExit, match="single-band tif: pass the Red band"):
        run("--MOD21A1D_file_path", files["lst_tif"], "--MOD09GQ_file_path", files["nir_tif"])
    with pytest.raises(SystemExit, match="2-band TIFF: expected a single-band raster"):
        run("--MOD21A1D_file_path", files["redn_tif"], "--MOD09GQ_file_path", files["ndvi_tif"],
            "--ndvi_is_precomputed")
    with pytest.raises(SystemExit, match="expected exactly 2 bands"):
        run("--MOD21A1D_file_path", files["lst_tif"], "--MOD09GQ_file_path", files["redn_tif"],
            "--red_file_path", files["red_tif"])
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            predict.main(["--MOD21A1D_file_path", files["lst_tif"], "--MOD09GQ_file_path",
                          files["ndvi_tif"], "--ndvi_is_precomputed", "--save_path",
                          str(tmp_path / "y"), *COMMON])
