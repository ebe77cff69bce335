"""train_mfu: samples stepped in the window times three times ModelB_2's
conv FLOPs on a 256² patch (forward, and the two products of the
backward) over the window's seconds times the float32 peak. The losses'
convolutions (the PSF, the Sobel bank) and BatchNorm are left out."""

from benchmark.harness import yardstick


def read(rec):
    if rec.window_s <= 0 or not rec.samples:
        return None
    cfg = rec.cell.config
    flops = 3 * yardstick.modelb2_conv_flops(cfg["factor"] * cfg["lst_block"])
    return 100.0 * rec.samples * flops / (rec.window_s * yardstick.PEAK_F32_FLOPS_PER_S)
