"""device_idle_share.serve: the share of the traced serving window in which
no operation ran on the device."""


def read(rec):
    t = rec.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
