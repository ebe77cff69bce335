"""channel_attention_ms: the device time of the kernels launched inside the
program's ``sifsr.hat.cab`` ranges (each HAB's channel-attention conv
branch, forward and backward), per training step of the traced window. It
is attributed by the program's ranges, not by kernel names."""


def read(rec):
    got = (rec.trace or {}).get("ranges", {}).get("sifsr.hat.cab")
    if not got or got["device_s"] <= 0 or not rec.steps:
        return None
    return got["device_s"] / rec.steps * 1e3
