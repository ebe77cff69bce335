"""hat_train_mfu: samples stepped in the window times three times HAT's
forward FLOPs on one LR block (every Linear, both attentions' products and
every conv: ``harness/hat_yardstick.py``) over the window's seconds times
the float32 peak. The losses' convolutions are left out."""

from benchmark.harness import hat_yardstick, yardstick


def read(rec):
    p = getattr(rec, "hat", None)
    if p is None or rec.window_s <= 0 or not rec.samples:
        return None
    flops = 3 * hat_yardstick.hat_forward_flops(p, rec.lr_px, rec.lr_px)
    return 100.0 * rec.samples * flops / (rec.window_s * yardstick.PEAK_F32_FLOPS_PER_S)
