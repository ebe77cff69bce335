"""granule_host_ms: the ``inference`` layer's own time in a request, the
host clock around one ``predict_granule`` call less the CUDA-event time of
the serving-step calls inside it (tiling, pinning, transfers, the mosaic),
averaged over the window's requests."""


def read(rec):
    reqs = [r for r in rec.requests if r.get("step_s") is not None]
    if not reqs:
        return None
    return sum(r["seconds"] - r["step_s"] for r in reqs) / len(reqs) * 1e3
