"""Fixed-seed bf16-vs-float32 convergence head-to-head.

Port of the repository's ``tools/bf16_convergence.py``, run for run: the
same seed and synthetic data, ModelB2 in float32 (precision 'highest': TF32
off) and in bf16 (precision 'default': bf16 compute, float32 master weights
and BatchNorm statistics) through the full predef_filters train loop
(``train.loop.train_loop``), writing ``convergence.json`` (the JAX tool's
schema: ``summary`` and ``curves``) and ``convergence.png`` into ``--out``
(by default not the JAX tool's ``results/bf16_vs_f32``, which stays as it is).

    python -m sifsr_tpu_torch.tools.bf16_convergence [--epochs 24]
        [--n-train 32] [--n-val 8] [--out results/bf16_vs_f32_torch] [--device cuda]

The PNG is drawn with numpy and zlib alone, so that it is written where
matplotlib is not installed: the four loss curves over the epochs on a log
axis with a grey line at each power of ten; validation loss in float32 blue
and in bf16 orange, the training losses in paler shades of the same.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from argparse import ArgumentParser
import numpy as np
import torch

from sifsr_tpu_torch.config import HyperParams, TrainConfig
from sifsr_tpu_torch.data.datasets import make_synthetic_dataset
from sifsr_tpu_torch.models.unet import ModelB2
from sifsr_tpu_torch.train.loop import train_loop

__all__ = ["convergence_config", "run", "main"]

# (compute dtype, precision) of each run, in the JAX tool's order
PRECISIONS = {"f32": (torch.float32, "highest"), "bf16": (torch.bfloat16, "default")}

# drawn in this order: the validation curves on top
_COLOURS = {("f32", "train_loss"): (158, 196, 222), ("bf16", "train_loss"): (255, 197, 140),
            ("f32", "val_loss"): (31, 119, 180), ("bf16", "val_loss"): (255, 127, 14)}


def convergence_config(epochs: int) -> TrainConfig:
    """The JAX tool's run: predef_filters at batch 8, lr 1e-3, alpha 0.99,
    gamma -0.5, seed 0, no early stop within ``epochs``."""
    return TrainConfig(
        hyper=HyperParams(batch_size=8, learning_rate=1e-3, n_epochs=epochs,
                          patience=epochs + 1, alpha=0.99, gamma=-0.5),
        recipe="predef_filters",
        seed=0,
    )


def run(epochs: int, n_train: int, n_val: int, out_dir: str,
        device: str | torch.device = "cuda") -> dict:
    """Both runs on ``make_synthetic_dataset(n_train, seed=11)`` /
    ``(n_val, seed=12)``; writes ``out_dir``/convergence.json and
    convergence.png and returns the summary: the last validation loss of
    each run and the relative difference of bf16's validation loss from
    float32's, last, mean and largest over the epochs."""
    cfg = convergence_config(epochs)
    train_ds = make_synthetic_dataset(n_train, seed=11)
    val_ds = make_synthetic_dataset(n_val, seed=12)

    curves = {}
    for name, (dtype, precision) in PRECISIONS.items():
        model = ModelB2(dtype=dtype, precision=precision)
        _, metrics = train_loop(cfg, train_ds, val_ds, model=model, device=device,
                                log_fn=lambda s, name=name: print(f"[{name}] {s}"))
        curves[name] = {
            "train_loss": [float(x) for x in metrics["train_loss"]],
            "val_loss": [float(x) for x in metrics["val_loss"]],
            "best_epoch": int(metrics["best_epoch"]),
        }

    f32v = np.asarray(curves["f32"]["val_loss"])
    bf16v = np.asarray(curves["bf16"]["val_loss"])
    rel = np.abs(bf16v - f32v) / np.maximum(np.abs(f32v), 1e-12)
    summary = {
        "epochs": epochs,
        "final_val_f32": float(f32v[-1]),
        "final_val_bf16": float(bf16v[-1]),
        "final_rel_diff": float(rel[-1]),
        "mean_rel_diff": float(rel.mean()),
        "max_rel_diff": float(rel.max()),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "convergence.json"), "w") as f:
        json.dump({"summary": summary, "curves": curves}, f, indent=1)
    write_png(os.path.join(out_dir, "convergence.png"), plot_curves(curves))
    print(json.dumps(summary))
    return summary


def plot_curves(curves: dict, height: int = 495, width: int = 770, margin: int = 40) -> np.ndarray:
    """The loss curves as an (height, width, 3) uint8 RGB image: epochs
    along x, log10 of the loss along y over whole powers of ten. Points
    that are not finite and positive are left out."""
    img = np.full((height, width, 3), 255, np.uint8)
    logs = {}
    for key in _COLOURS:
        v = np.asarray(curves[key[0]][key[1]], np.float64)
        logs[key] = np.where(np.isfinite(v) & (v > 0), np.log10(np.where(v > 0, v, 1.0)), np.nan)
    every = np.concatenate(list(logs.values()))
    lo, hi = (np.floor(np.nanmin(every)), np.ceil(np.nanmax(every))) if np.isfinite(every).any() \
        else (0.0, 1.0)
    hi = max(hi, lo + 1.0)
    x0, x1, y0, y1 = margin, width - margin, margin, height - margin

    def row(y):
        return y1 - (y - lo) / (hi - lo) * (y1 - y0)

    for decade in np.arange(lo, hi + 1):
        img[int(round(row(decade))), x0:x1 + 1] = 200
    img[y0:y1 + 1, (x0, x1)] = 0
    img[(y0, y1), x0:x1 + 1] = 0
    for key, colour in _COLOURS.items():
        y = logs[key]
        n = y.size
        t = np.linspace(0.0, n - 1, 4 * (x1 - x0))    # a few samples a pixel column
        ys = np.interp(t, np.arange(n), y)             # NaN next to a left-out point
        ok = np.isfinite(ys)
        cols = x0 + t[ok] / max(n - 1, 1) * (x1 - x0)
        rows = row(ys[ok])
        for d in (0, 1):                              # two pixels thick
            img[np.clip(np.round(rows).astype(int) + d, y0, y1),
                np.round(cols).astype(int)] = colour
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) uint8 RGB image as an 8-bit truecolour PNG."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def main(argv: list | None = None) -> dict:
    p = ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=24)
    p.add_argument("--n-train", type=int, default=32)
    p.add_argument("--n-val", type=int, default=8)
    p.add_argument("--out", default="results/bf16_vs_f32_torch")
    p.add_argument("--device", default="cuda", help="the device to train on (default cuda)")
    a = p.parse_args(argv)
    return run(a.epochs, a.n_train, a.n_val, a.out, a.device)


if __name__ == "__main__":
    main()
