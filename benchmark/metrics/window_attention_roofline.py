"""window_attention_roofline: the window attention's least time a step over
``window_attention_ms``. The least time is the larger of its bytes over HBM
bandwidth and its FLOPs over the float32 peak, for the windows x Swin
layers the program counts on its ``train_step`` roots (``swin_windows``)
and the work of one window (``harness/swin_yardstick.py``): the same work
whatever implements the attention."""

from benchmark.harness import core, program_spans, swin_yardstick


def read(rec):
    ms = core.load_part("metrics", "window_attention_ms").read(rec)
    roots = program_spans.window_roots(rec, "train_step")
    windows = program_spans.counter_sum(roots, "swin_windows")
    if ms is None or windows is None:
        return None
    p = rec.swinir
    nbytes, flops = swin_yardstick.window_attention_work(windows / len(roots), p["window_size"],
                                                         p["embed_dim"])
    return 100.0 * swin_yardstick.least_seconds(nbytes, flops) * 1e3 / ms
