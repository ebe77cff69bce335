"""Counted FLOP costs of ModelB2, the numerators of an MFU share.

Port of ``sifsr_tpu/utils/flops.py``. Two complementary counts:

- ``modelb2_conv_flops``: the *algorithmic* cost, a walk of the ModelB2
  channel plan summing 2·H·W·Cin·Cout·K² per conv (reference
  model.py:596-645). It is the "useful work" numerator of an MFU share: it
  leaves out resampling matmuls, padding and elementwise ops, and the extra
  MACs of a layout such as the space-to-depth packed convs, which are
  implementation detail, not model work.
- ``op_flops``: what PyTorch's FLOP counter sees in one call of a function
  (JAX's ``xla_flops``): an upper bound that also holds the bicubic resize
  matmuls and the einsums. The port's hand-written kernels count zero, as
  Pallas calls do under XLA's cost analysis, so an int8 path is measured
  against the analytic count.
"""

from __future__ import annotations

__all__ = ["modelb2_conv_flops", "modelb2_conv_list", "conv_lane_bound_s", "op_flops"]


def modelb2_conv_list(
    hw: int = 256,
    in_channels: int = 2,
    downchannels: tuple[int, ...] = (16, 32, 64, 128),
) -> list[tuple[int, int, int]]:
    """The (n_px, c_in, c_out) plan of every 3x3 conv in one ModelB2 forward
    (shared by the FLOP count and the lane-utilisation bound below)."""
    return _conv_plan(hw, in_channels, downchannels)


def conv_lane_bound_s(
    hw: int = 256,
    in_channels: int = 2,
    downchannels: tuple[int, ...] = (16, 32, 64, 128),
    *,
    peak_flops: float,
    backward: bool = True,
    k: int = 3,
) -> float:
    """Per-sample lower bound (seconds) on the conv time of one train step on
    an array whose output-channel dimension is 128 lanes wide: a conv with
    c_out < 128 uses at most c_out/128 of the array's ``peak_flops``
    (FLOP/s, required: the bound is only as good as the peak it is given).
    backward adds dL/dx (lanes = c_in; skipped for the input layer, which
    needs no data gradient) and dL/dw (lanes = c_out) at the same per-conv
    cost model."""
    convs = _conv_plan(hw, in_channels, downchannels)

    def t(n, ci, co, lanes):
        return (2 * n * ci * co * k * k) / (peak_flops * min(lanes, 128) / 128)

    total = sum(t(n, ci, co, co) for n, ci, co in convs)
    if backward:
        for i, (n, ci, co) in enumerate(convs):
            if i > 0:  # no gradient to the network input
                total += t(n, co, ci, ci)
            total += t(n, ci, co, co)
    return total


def modelb2_conv_flops(
    hw: int = 256,
    in_channels: int = 2,
    downchannels: tuple[int, ...] = (16, 32, 64, 128),
    k: int = 3,
) -> float:
    """Per-patch conv FLOPs (MAC·2) of one ModelB2 forward at ``hw``².

    Mirrors the reference ModelB_2 architecture (model.py:596-645,
    bilinear=1 so the last encoder floor is halved by upfactor=2): inbloc
    DoubleConv(in->c0) @hw², three DownBlock_pool (Res(DoubleConv c->c) +
    Conv c->c_next) at hw/2², hw/4², hw/8² (the last stays c2), three
    UpBlock (DoubleConv(2c -> c_skip), mid = in//2) back up, outlay Conv(c0
    -> 1) @hw²."""
    convs = _conv_plan(hw, in_channels, downchannels)
    return float(sum(2 * n * ci * co * k * k for n, ci, co in convs))


def _conv_plan(hw, in_channels, downchannels):
    c0, c1, c2, _ = downchannels
    # (H*W, Cin, Cout) per 3x3 conv
    return [
        # inbloc DoubleConvolution (model.py:596)
        (hw * hw, in_channels, c0),
        (hw * hw, c0, c0),
        # db1 @ hw/2 (model.py:597): Res(DoubleConv c0->c0) + Conv c0->c1
        ((hw // 2) ** 2, c0, c0),
        ((hw // 2) ** 2, c0, c0),
        ((hw // 2) ** 2, c0, c1),
        # db2 @ hw/4: Res(c1) + Conv c1->c2
        ((hw // 4) ** 2, c1, c1),
        ((hw // 4) ** 2, c1, c1),
        ((hw // 4) ** 2, c1, c2),
        # db3 @ hw/8: Res(c2) + Conv c2->c2 (bilinear upfactor halves c3)
        ((hw // 8) ** 2, c2, c2),
        ((hw // 8) ** 2, c2, c2),
        ((hw // 8) ** 2, c2, c2),
        # ub1 @ hw/4: concat(c2+c2) -> DoubleConv with mid = in//2
        # (bilinear UpBlock, reference model.py:208): 2c2 -> c2 -> c1
        ((hw // 4) ** 2, 2 * c2, c2),
        ((hw // 4) ** 2, c2, c1),
        # ub2 @ hw/2: concat(c1+c1) -> 2c1 -> c1 -> c0
        ((hw // 2) ** 2, 2 * c1, c1),
        ((hw // 2) ** 2, c1, c0),
        # ub3 @ hw: concat(c0+c0) -> 2c0 -> c0 -> c0 (mid = in//2 = c0)
        (hw * hw, 2 * c0, c0),
        (hw * hw, c0, c0),
        # outlay (model.py:605)
        (hw * hw, c0, 1),
    ]


def op_flops(fn, *args, **kwargs) -> float:
    """Total FLOPs that ``torch.utils.flop_counter.FlopCounterMode`` counts
    in one call of ``fn(*args, **kwargs)``: the counterpart of JAX's
    ``xla_flops``. Convolutions, matmuls and einsums count; a hand-written
    kernel launched through ``ctypes`` counts zero (on the CPU a wrapper
    runs its plain version, whose torch ops do count)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
