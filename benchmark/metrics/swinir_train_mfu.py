"""swinir_train_mfu: samples stepped in the window times three times SwinIR's
forward FLOPs on one LR block (every Linear, the two attention products and
every conv: ``harness/swin_yardstick.py``) over the window's seconds times
the float32 peak. The losses' convolutions are left out."""

from benchmark.harness import swin_yardstick, yardstick


def read(rec):
    p = getattr(rec, "swinir", None)
    if p is None or rec.window_s <= 0 or not rec.samples:
        return None
    flops = 3 * swin_yardstick.swinir_forward_flops(p, rec.lr_px, rec.lr_px)
    return 100.0 * rec.samples * flops / (rec.window_s * yardstick.PEAK_F32_FLOPS_PER_S)
