"""tile_ms: the mean, over the window's requests, of the time the program's
``predict_granule`` spends in its ``tile`` spans: the NDVI clip, the
float32 cast, tiling into blocks, the coverage mask and the output's
allocation (the program's ``tracing``, ``harness/program_spans.py``)."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.span_ms(program_spans.serving_roots(rec), "tile")
