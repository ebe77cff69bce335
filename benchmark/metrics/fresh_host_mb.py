"""fresh_host_mb: the program's ``host_bytes`` counter per request, in MB
(1e6 bytes): the host arrays a ``predict_granule`` call creates (the NDVI
clip, casts that copy, the tile copies, the padding's zeros and the padded
batch, the output and the untiled mosaic; not torch's cached pinned
buffers), averaged over the window's requests."""

from benchmark.harness import program_spans


def read(rec):
    roots = program_spans.serving_roots(rec)
    total = program_spans.counter_sum(roots, "host_bytes")
    return None if total is None else total / len(roots) / 1e6
