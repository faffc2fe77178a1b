"""The decode kernels (``nms``, ``match``, ``merge``) against their
roofline: their bytes at the cell's shapes and capacities over the
bandwidth (``roofline.decode_bound_s``; bytes bound all three), for the
traced batches, over their device time in the trace."""

from portbench.trace import DECODE_KERNELS


def read(run):
    tr = run["trace"]
    if not tr or run["decode_bound_s"] is None:
        return None
    kernel_s = sum(d for name, d in tr["kernels"]
                   if any(k in name for k in DECODE_KERNELS.values()))
    if kernel_s <= 0:
        return None
    return 100.0 * tr["batches"] * run["decode_bound_s"] / kernel_s
