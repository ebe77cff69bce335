"""Space-to-depth packed forms of the 256²-level layers.

Port of the parts of ``sifsr_tpu/models/packed.py:44-170`` that the int8
calibration mirror (``models.int8_serving._f32_packed_mirror``) runs. The JAX
package serves the 256² layers on a 2x2 space-to-depth packed layout
(N, 128, 128, 4C), packed channel ``(q*2 + r)*C + c`` for pixel phase
(q, r), to fill TPU lanes:

- a 3x3 conv C->D becomes a 3x3 conv 4C->4D with
  ``Wp[p+1, s+1, (q,r,c), (do,eo,k)] = W[2p+q-do+1, 2s+r-eo+1, c, k]``;
- the replicate pad replicates the outermost original row/column into both
  phase slots (``_replicate_pad_packed``);
- integer-factor resizes emit packed outputs through per-phase matrices.

The port's int8 kernels work on the unpacked NHWC tensors instead (the
packed conv equals the unpacked replicate-pad conv, weights and scales
included: ``tests/test_torch_int8_serving.py`` asserts it). The calibration
mirror keeps the packed graph so that its record matches JAX's tensor by
tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sifsr_tpu_torch.models.fused import fold_batchnorm
from sifsr_tpu_torch.ops.resize import resize_matrix

__all__ = ["pack_conv_weights", "pack_serving_params"]


def pack_conv_weights(w, b) -> tuple[np.ndarray, np.ndarray]:
    """HWIO (3,3,C,K) + bias (K,) -> packed (3,3,4C,4K) + bias (4K,)."""
    w = np.asarray(w)
    b = np.asarray(b)
    c_in, c_out = w.shape[2], w.shape[3]
    wp = np.zeros((3, 3, 4 * c_in, 4 * c_out), np.float32)
    for p in (-1, 0, 1):
        for s in (-1, 0, 1):
            for q in (0, 1):
                for r in (0, 1):
                    for do in (0, 1):
                        for eo in (0, 1):
                            dy = 2 * p + q - do + 1
                            dx = 2 * s + r - eo + 1
                            if 0 <= dy < 3 and 0 <= dx < 3:
                                wp[p + 1, s + 1,
                                   (q * 2 + r) * c_in : (q * 2 + r + 1) * c_in,
                                   (do * 2 + eo) * c_out : (do * 2 + eo + 1) * c_out] = w[dy, dx]
    bp = np.concatenate([b] * 4).astype(np.float32)
    return wp, bp


@functools.lru_cache(maxsize=None)
def _pad_perms(c: int) -> tuple:
    """Channel permutations of the packed replicate pad: the pad row/col takes
    the border packed pixel with its phase slot replaced by the outermost
    original row/col (q->0 at top, q->1 at bottom, r likewise)."""
    j = np.arange(4 * c)
    q, r, ch = j // (2 * c), (j // c) % 2, j % c
    return (
        tuple((r * c + ch).tolist()),            # top: (0, r, c)
        tuple(((2 + r) * c + ch).tolist()),      # bottom: (1, r, c)
        tuple((q * 2 * c + ch).tolist()),        # left: (q, 0, c)
        tuple(((q * 2 + 1) * c + ch).tolist()),  # right: (q, 1, c)
    )


def _replicate_pad_packed(x: torch.Tensor, c: int) -> torch.Tensor:
    """Packed-space replicate pad by one packed pixel on each side."""
    perm_top, perm_bottom, perm_left, perm_right = (list(p) for p in _pad_perms(c))
    x = torch.cat([x[:, :1, :, perm_top], x, x[:, -1:, :, perm_bottom]], dim=1)
    return torch.cat([x[:, :, :1, perm_left], x, x[:, :, -1:, perm_right]], dim=2)


@functools.lru_cache(maxsize=None)
def _phase_matrices(in_size: int, out_size: int, kind: str) -> np.ndarray:
    """(2, out_size//2, in_size) per-phase rows of a resampling matrix."""
    a = resize_matrix(in_size, out_size, kind)
    return np.stack([a[0::2], a[1::2]]).astype(np.float32)


def _packed_resize(x: torch.Tensor, phases) -> torch.Tensor:
    """(N, h, w, C) -> packed (N, H/2, W/2, 4C) of the resized image."""
    n, h, w, c = x.shape
    phases = torch.as_tensor(phases, dtype=x.dtype, device=x.device)
    t = torch.einsum("dih,nhwc->ndiwc", phases, x)
    y = torch.einsum("ejw,ndiwc->nijdec", phases, t)
    return y.reshape(n, y.shape[1], y.shape[2], 4 * c)


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), channel order (q, r, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def _depth_to_space(x: torch.Tensor, c: int) -> torch.Tensor:
    n, h, w, _ = x.shape
    x = x.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * h, 2 * w, c)


def _packed_concat(a: torch.Tensor, ca: int, b: torch.Tensor, cb: int) -> torch.Tensor:
    """Concat along the original channel dim inside each (q, r) slot."""
    n, h, w, _ = a.shape
    return torch.cat([a.reshape(n, h, w, 4, ca), b.reshape(n, h, w, 4, cb)],
                     dim=-1).reshape(n, h, w, 4 * (ca + cb))


def _to_numpy_tree(node):
    if isinstance(node, dict):
        return {k: _to_numpy_tree(v) for k, v in node.items()}
    return node.detach().cpu().numpy()


def pack_serving_params(state_dict: dict) -> dict:
    """ModelB2 state dict -> {'mid': the BN-folded tree, 'packed': the
    level-0 convs (inbloc, ub3.convbloc, outlay) packed}, float32 numpy on
    the host."""
    folded = _to_numpy_tree(fold_batchnorm(state_dict))

    def grab(tree):
        return tree["kernel"], tree["bias"]

    packed = {
        "in_conv1": pack_conv_weights(*grab(folded["inbloc"]["conv1"]["conv"])),
        "in_conv2": pack_conv_weights(*grab(folded["inbloc"]["conv2"]["conv"])),
        "ub3_conv1": pack_conv_weights(*grab(folded["ub3"]["convbloc"]["conv1"]["conv"])),
        "ub3_conv2": pack_conv_weights(*grab(folded["ub3"]["convbloc"]["conv2"]["conv"])),
        "outlay": pack_conv_weights(*grab(folded["outlay"]["conv"])),
    }
    return {"mid": folded, "packed": packed}
