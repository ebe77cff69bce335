"""train_wait_ms: the mean, over the window's steps, of the time the
program's ``prepare_batch`` waits for the card in its ``wait`` span: the
stream's queued work (the previous step), synchronised under tracing
just before the pageable upload, which would wait for it anyway."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.span_ms(program_spans.window_roots(rec, "prepare_batch"), "wait")
