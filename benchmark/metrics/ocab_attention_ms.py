"""ocab_attention_ms: the device time of the kernels launched inside the
program's ``sifsr.hat.ocab_attention`` ranges (each overlapping
cross-attention, forward and backward; the unfold of k and v and its
backward lie outside them), per training step of the traced window. It is
attributed by the program's ranges, not by kernel names."""


def read(rec):
    got = (rec.trace or {}).get("ranges", {}).get("sifsr.hat.ocab_attention")
    if not got or got["device_s"] <= 0 or not rec.steps:
        return None
    return got["device_s"] / rec.steps * 1e3
