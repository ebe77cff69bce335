"""The benchmark's own yardstick: published peaks, the ModelB_2 conv count,
and the bytes and operations of every launch of the int8 serving step.

Frozen copies: the conv plan is ``sifsr_tpu_torch/utils/flops.py``'s
``_conv_plan`` and the per-launch byte/operation rules are those of
``chip_smoke.py`` phase 3 (``conv_bytes``/``conv_ops``), kept here so that a
change to the program cannot move the yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12

PEAK_BY_PRECISION = {"int8": PEAK_INT8_OPS_PER_S, "float32": PEAK_F32_FLOPS_PER_S}


def conv_plan(hw: int = 256, in_channels: int = 2,
              downchannels=(16, 32, 64, 128)) -> list[tuple[int, int, int]]:
    """(pixels, c_in, c_out) of every 3x3 conv of one ModelB_2 forward at hw²
    (bilinear decoder: the last encoder floor halved, mid = in // 2)."""
    c0, c1, c2, _ = downchannels
    h1, h2, h3 = (hw // 2) ** 2, (hw // 4) ** 2, (hw // 8) ** 2
    return [
        (hw * hw, in_channels, c0), (hw * hw, c0, c0),          # inbloc
        (h1, c0, c0), (h1, c0, c0), (h1, c0, c1),                # db1
        (h2, c1, c1), (h2, c1, c1), (h2, c1, c2),                # db2
        (h3, c2, c2), (h3, c2, c2), (h3, c2, c2),                # db3
        (h2, 2 * c2, c2), (h2, c2, c1),                          # ub1
        (h1, 2 * c1, c1), (h1, c1, c0),                          # ub2
        (hw * hw, 2 * c0, c0), (hw * hw, c0, c0),                # ub3
        (hw * hw, c0, 1),                                        # outlay
    ]


def modelb2_conv_flops(hw: int = 256, in_channels: int = 2,
                       downchannels=(16, 32, 64, 128)) -> float:
    """Conv FLOPs (2 x MACs) of one ModelB_2 forward on one hw² patch:
    3,605,004,288 at 256². Resampling, padding and elementwise work are
    left out: this is the model's useful work."""
    return float(sum(2 * n * ci * co * 9 for n, ci, co in conv_plan(hw, in_channels,
                                                                     downchannels)))


def _conv(n: int, px: int, cin: int, cout: int, out_bytes: int = 1,
          extra_in: int = 0, extra_out: int = 0) -> tuple[float, float]:
    """(bytes, ops) of one int8 3x3 conv over n images of px pixels: each
    input byte read once (``extra_in`` more channels read, as a residual),
    each output written once (``extra_out`` more bytes, as a pooled or
    phase-mean output), the int8 taps and a float32 scale and bias a
    channel."""
    data = n * px * (cin + extra_in + cout * out_bytes) + extra_out
    return float(data + 9 * cin * cout + 8 * cout), 2.0 * n * px * 9 * cin * cout


def int8_step_launches(n: int, lst_px: int = 64) -> list[tuple[str, float, float]]:
    """(kernel entry, bytes, ops) of every hand-written kernel launch of one
    ``mid='prow'`` int8 step on n LST blocks of lst_px² (the model at
    hw = 4 lst_px), in launch order."""
    hw = 4 * lst_px
    p0, p1, p2, p3 = hw * hw, (hw // 2) ** 2, (hw // 4) ** 2, (hw // 8) ** 2
    out = [("upsample_phases", float(n * lst_px * lst_px * 4 + n * p0), 0.0)]  # A: f32 in, int8 out
    out.append(("conv_i8_in1_split", *_conv(n, p0, 2, 16)))                       # D
    out.append(("conv_i8_exact", *_conv(n, p0, 16, 16, extra_out=n * p1 * 16)))  # B + phase mean
    for px, c in ((p1, 16), (p2, 32), (p3, 64)):                                  # db1..db3
        out.append(("conv_prow", *_conv(n, px, c, c)))                            # G
        out.append(("conv_prow", *_conv(n, px, c, c, extra_in=c)))                # G + residual
        if c < 64:
            out.append(("conv_prow_split_pool",                                   # H + 2x2 pool
                        *_conv(n, px, c, 2 * c, extra_out=n * (px // 4) * 2 * c)))
    # I: db3.last at 32² with its x2 to 64² (writes the upsampled output)
    b, o = _conv(n, p3, 64, 64)
    out.append(("conv_prow_up2", b + n * (p2 - p3) * 64, o))
    out.append(("conv_prow_dual_planes", *_conv(n, p2, 128, 64)))                # J: ub1.conv1
    b, o = _conv(n, p2, 64, 32)                                                   # I: ub1.conv2 x2
    out.append(("conv_prow_up2", b + n * (p1 - p2) * 32, o))
    out.append(("conv_prow_dual_planes", *_conv(n, p1, 64, 32)))                 # J: ub2.conv1
    b, o = _conv(n, p1, 32, 16)                                                   # K: ub2.conv2 x2
    out.append(("conv_prow_up2_pack", b + n * (p0 - p1) * 16, o))
    out.append(("conv_i8_exact_dual", *_conv(n, p0, 32, 16)))                    # C: ub3.conv1
    out.append(("conv_i8_exact", *_conv(n, p0, 16, 16)))                         # B: ub3.conv2
    out.append(("conv_i8_generic", *_conv(n, p0, 16, 1, out_bytes=4)))           # the outlay
    return out


def launch_bound_s(nbytes: float, ops: float, peak_ops: float = PEAK_INT8_OPS_PER_S) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak."""
    return max(nbytes / PEAK_HBM_BYTES_PER_S, ops / peak_ops)


def launches_per_step(n: int, lst_px: int = 64) -> dict[str, int]:
    counts: dict[str, int] = {}
    for entry, _, _ in int8_step_launches(n, lst_px):
        counts[entry] = counts.get(entry, 0) + 1
    return counts


# the __global__ functions of the port's CUDA sources that the int8 step's
# wrappers launch: a kernel event whose name holds one of them is mapped
INT8_STEP_KERNEL_NAMES = ("upsample_phases_kernel", "conv_in1_mma_kernel", "conv16_mma_kernel",
                          "conv16_outlay_mma_kernel", "conv_dual_mma_kernel",
                          "conv_prow_mma_kernel", "conv_up2_mma_kernel",
                          "conv_i8_generic_kernel")
