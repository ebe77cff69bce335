"""int8_kernel_roofline: over the traced window, the sum of the int8 step's
hand-written kernel launches' bound times (the larger of bytes / HBM rate
and operations / int8 peak, from the benchmark's own table by launch and
shape) over the sum of those kernels' device time in the trace. Kernels
that map to no launch of the table are listed. Where the trace's mapped
launches are not the table's count (a launch renamed, moved into another
kernel or left out), the bound would count work whose time is not in the
sum: the reader returns nothing."""

from benchmark.harness import core, yardstick


def read(rec):
    if not rec.trace or not rec.step_calls:
        return None
    block = rec.cell.config["lst_block"]
    bound = sum(yardstick.launch_bound_s(b, o)
                for rows, _ in rec.step_calls
                for _, b, o in yardstick.int8_step_launches(rows, block))
    mapped, unmapped, n = 0.0, {}, 0
    for name, (count, sec) in rec.trace["kernels"].items():
        if any(k in name for k in yardstick.INT8_STEP_KERNEL_NAMES):
            mapped += sec
            n += count
        else:
            unmapped[name[:120]] = count
    want = sum(sum(yardstick.launches_per_step(rows, block).values())
               for rows, _ in rec.step_calls)
    core.log(f"int8_kernel_roofline: {n} mapped kernel launches in the trace, {want} in the "
             f"table; unmapped device operations: {unmapped}")
    if mapped <= 0 or n != want:
        return None
    return 100.0 * bound / mapped
