"""useful_block_share.aoi: the requests' blocks over the batch rows the
serving step ran (every batch is padded to ``batch_size`` rows)."""


def read(rec):
    rows = sum(r for r, _ in rec.step_calls)
    if not rows:
        return None
    return 100.0 * rec.samples / rows
