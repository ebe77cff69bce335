"""device_wait_ms: the mean, over the window's requests, of the time the
program's ``predict_granule`` spends in its ``wait`` spans: the host
waiting for a batch's result on the device (the program's ``tracing``,
``harness/program_spans.py``)."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.span_ms(program_spans.serving_roots(rec), "wait")
