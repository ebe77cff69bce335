"""ocab_attention_roofline: the overlapping cross-attention's least time a
step over ``ocab_attention_ms``. The least time is the larger of its bytes
over HBM bandwidth and its FLOPs over the float32 peak, for the OCAB
windows x groups the program counts on its ``train_step`` roots
(``ocab_windows``) and the work of one window
(``harness/hat_yardstick.py``, the map's bytes): the same work whatever
implements the attention."""

from benchmark.harness import core, hat_yardstick, program_spans, swin_yardstick


def read(rec):
    ms = core.load_part("metrics", "ocab_attention_ms").read(rec)
    roots = program_spans.window_roots(rec, "train_step")
    windows = program_spans.counter_sum(roots, "ocab_windows")
    if ms is None or windows is None:
        return None
    p = rec.hat
    nbytes, flops = hat_yardstick.ocab_attention_work(windows / len(roots), p["window_size"],
                                                      hat_yardstick.overlap_window(p),
                                                      p["embed_dim"])
    return 100.0 * swin_yardstick.least_seconds(nbytes, flops) * 1e3 / ms
