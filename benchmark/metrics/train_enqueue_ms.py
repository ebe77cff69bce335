"""train_enqueue_ms: the mean, over the window's steps, of the program's
``train_step`` root: the host's time to enqueue the forward, the losses,
the backward, Adam and the step metrics."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.root_ms(program_spans.window_roots(rec, "train_step"))
