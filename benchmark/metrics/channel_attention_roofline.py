"""channel_attention_roofline: the channel-attention branch's least time a
step over ``channel_attention_ms``. The least time is the larger of its
bytes over HBM bandwidth and its FLOPs over the float32 peak, for the
samples x CAB branches the program counts on its ``train_step`` roots
(``cab_blocks``) and the work of the two 3x3 convs of one branch on the LR
grid (``harness/hat_yardstick.py``): the same work whatever implements
the branch."""

from benchmark.harness import core, hat_yardstick, program_spans, swin_yardstick


def read(rec):
    ms = core.load_part("metrics", "channel_attention_ms").read(rec)
    roots = program_spans.window_roots(rec, "train_step")
    blocks = program_spans.counter_sum(roots, "cab_blocks")
    if ms is None or blocks is None:
        return None
    p = rec.hat
    px = rec.lr_px + (-rec.lr_px) % p["window_size"]
    nbytes, flops = hat_yardstick.cab_work(blocks / len(roots), px, px, p["embed_dim"],
                                           p["compress_ratio"])
    return 100.0 * swin_yardstick.least_seconds(nbytes, flops) * 1e3 / ms
