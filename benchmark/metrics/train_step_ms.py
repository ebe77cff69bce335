"""train_step_ms: the mean CUDA-event time of one training step's calls,
``prepare_batch`` (upload, cubic x4) and the ``make_train_step`` step."""


def read(rec):
    times = [t.seconds() for t in rec.step_timers]
    if not times or None in times:
        return None
    return sum(times) / len(times) * 1e3
