"""The port's bf16-vs-float32 convergence tool (``sifsr_tpu_torch.tools.
bf16_convergence``) on the CPU at a tiny size: the JSON schema of the
repository's ``tools/bf16_convergence.py``, its float32 curve equal to the
port's own ``train_loop`` on the same run, and the PNG it writes."""

import json
import struct
import zlib

import numpy as np
import pytest
import torch

from sifsr_tpu_torch.data.datasets import make_synthetic_dataset
from sifsr_tpu_torch.models.unet import ModelB2
from sifsr_tpu_torch.tools import bf16_convergence
from sifsr_tpu_torch.train.loop import train_loop

# the keys of tools/bf16_convergence.py's convergence.json
SUMMARY_KEYS = {"epochs", "final_val_f32", "final_val_bf16", "final_rel_diff", "mean_rel_diff",
                "max_rel_diff"}
CURVE_KEYS = {"train_loss", "val_loss", "best_epoch"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_train_loop.py: the float32
    sums of a conv backward depend on the thread count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _read_png(path):
    """An 8-bit RGB PNG of filter-0 rows (what write_png writes) -> (H, W, 3)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, at = {}, 8
    while at < len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        tag, body = data[at + 4:at + 8], data[at + 8:at + 8 + n]
        assert struct.unpack(">I", data[at + 8 + n:at + 12 + n])[0] == zlib.crc32(tag + body)
        chunks[tag] = body
        at += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, colour) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_tool_writes_the_jax_schema_and_the_loop_curve(tmp_path):
    """``main`` at 2 epochs on 8 / 4 pairs: convergence.json in the JAX
    tool's schema, its summary from its curves, the float32 curve equal to
    train_loop's on the same configuration and data, and the PNG."""
    out = tmp_path / "out"
    summary = bf16_convergence.main(["--device", "cpu", "--epochs", "2", "--n-train", "8",
                                     "--n-val", "4", "--out", str(out)])
    got = json.loads((out / "convergence.json").read_text())
    assert got.keys() == {"summary", "curves"} and got["summary"] == summary
    assert summary.keys() == SUMMARY_KEYS and summary["epochs"] == 2
    assert got["curves"].keys() == {"f32", "bf16"}
    for curve in got["curves"].values():
        assert curve.keys() == CURVE_KEYS and curve["best_epoch"] == 2
        assert len(curve["train_loss"]) == len(curve["val_loss"]) == 2
        assert np.isfinite(curve["train_loss"] + curve["val_loss"]).all()
    f32v, bf16v = (np.asarray(got["curves"][k]["val_loss"]) for k in ("f32", "bf16"))
    rel = np.abs(bf16v - f32v) / np.abs(f32v)
    assert summary["final_val_f32"] == f32v[-1] and summary["final_val_bf16"] == bf16v[-1]
    np.testing.assert_allclose([summary["final_rel_diff"], summary["mean_rel_diff"],
                                summary["max_rel_diff"]], [rel[-1], rel.mean(), rel.max()],
                               rtol=1e-12)

    _, metrics = train_loop(bf16_convergence.convergence_config(2),
                            make_synthetic_dataset(8, seed=11), make_synthetic_dataset(4, seed=12),
                            model=ModelB2(dtype=torch.float32, precision="highest"),
                            log_fn=lambda s: None, device="cpu")
    assert got["curves"]["f32"] == {"train_loss": metrics["train_loss"],
                                    "val_loss": metrics["val_loss"],
                                    "best_epoch": metrics["best_epoch"]}

    png = _read_png(out / "convergence.png")
    np.testing.assert_array_equal(png, bf16_convergence.plot_curves(got["curves"]))
    for colour in ((31, 119, 180), (255, 127, 14)):         # both validation curves are drawn
        assert (png == colour).all(axis=-1).any()


def test_plot_curves_leaves_out_points_that_are_not_positive(tmp_path):
    """A NaN, an Inf or a loss <= 0 is not drawn, and a single epoch plots;
    write_png's bytes decode to the image."""
    curves = {"f32": {"train_loss": [0.5, np.nan, 0.2, 0.1], "val_loss": [0.4, 0.3, np.inf, 0.2]},
              "bf16": {"train_loss": [0.5, -1.0, 0.2, 0.0], "val_loss": [0.35, 0.28, 0.25, 0.15]}}
    img = bf16_convergence.plot_curves(curves)
    assert img.shape == (495, 770, 3) and img.dtype == np.uint8
    assert (img == (255, 127, 14)).all(axis=-1).any()
    # f32's validation curve stops at epoch index 1 and starts again at 3
    blue = np.nonzero((img == (31, 119, 180)).all(axis=-1).any(axis=0))[0]
    at = [40 + e / 3 * 690 for e in (1, 3)]
    assert blue.size and not ((blue > at[0] + 1) & (blue < at[1] - 1)).any()
    bf16_convergence.write_png(str(tmp_path / "c.png"), img)
    np.testing.assert_array_equal(_read_png(tmp_path / "c.png"), img)
    one = {k: {"train_loss": [0.3], "val_loss": [0.2]} for k in ("f32", "bf16")}
    assert (bf16_convergence.plot_curves(one) == (255, 127, 14)).all(axis=-1).any()
