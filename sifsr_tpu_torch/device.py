"""Device selection shared by the port's entry points."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_f32", "full_f32_convs", "resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for but absent.

    Nothing falls back silently: a CUDA request on a machine without a card
    is an error, and the CPU (the kernels' plain versions) must be asked for
    explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


@contextlib.contextmanager
def full_f32_convs(enable: bool = True):
    """Run float32 cuDNN convolutions in full float32 (no TF32) inside the
    block; cuDNN defaults to TF32, while the JAX float32 reference uses
    HIGHEST precision."""
    before = torch.backends.cudnn.allow_tf32
    if enable:
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


@contextlib.contextmanager
def full_f32(enable: bool = True):
    """Full float32 for cuDNN convolutions and for matmuls inside the block:
    ``full_f32_convs`` plus ``torch.backends.cuda.matmul.allow_tf32`` off (its
    default, which a caller may have changed). The training steps wrap their
    forward, losses, metrics and backward in it under precision='highest'."""
    before = torch.backends.cuda.matmul.allow_tf32
    if enable:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with full_f32_convs(enable):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
