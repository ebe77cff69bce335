"""batch_pad_ms: the mean, over the window's requests, of the time the
program's ``predict_granule`` spends in its ``pad`` spans: each batch's
contiguous copy and its zero padding to the batch size (the program's
``tracing``, ``harness/program_spans.py``)."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.span_ms(program_spans.serving_roots(rec), "pad")
