"""upload_ms: the mean, over the window's requests, of the time the program's
``predict_granule`` spends in its ``upload`` spans: the pinned staging
copy and the host-to-device enqueue (the program's ``tracing``,
``harness/program_spans.py``)."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.span_ms(program_spans.serving_roots(rec), "upload")
