"""serve_mfu: the model's useful work done in the window (the blocks
served times ModelB_2's conv FLOPs on a 256² patch) over the window's
seconds times the card's peak for the step's arithmetic."""

from benchmark.harness import yardstick


def read(rec):
    cfg = rec.cell.config
    if rec.window_s <= 0 or not rec.samples:
        return None
    peak = yardstick.PEAK_BY_PRECISION["int8" if cfg["precision"] == "int8" else "float32"]
    flops = yardstick.modelb2_conv_flops(cfg["factor"] * cfg["lst_block"])
    return 100.0 * rec.samples * flops / (rec.window_s * peak)
