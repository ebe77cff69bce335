"""train_upload_ms: the mean, over the window's steps, of the program's
``prepare_batch`` ``upload`` span: the pageable host-to-device copy of the
batch."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.span_ms(program_spans.window_roots(rec, "prepare_batch"), "upload")
