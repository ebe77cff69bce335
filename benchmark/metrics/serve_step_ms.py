"""serve_step_ms: the mean CUDA-event time of one serving-step call."""


def read(rec):
    times = [t.seconds() for _, t in rec.step_calls]
    if not times or None in times:
        return None
    return sum(times) / len(times) * 1e3
