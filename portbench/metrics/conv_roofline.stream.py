"""The forward's convs against their roofline: the least time the traced
batches' convs could take (each conv the larger of its FLOPs over the
bf16 peak and its bytes over the bandwidth, ``roofline.conv_bound_s``)
over the device time of the conv kernels in the trace."""

from portbench.trace import is_conv


def read(run):
    tr = run["trace"]
    if not tr or run["conv_bound_s"] is None:
        return None
    conv_s = sum(d for name, d in tr["kernels"] if is_conv(name))
    if conv_s <= 0:
        return None
    return 100.0 * tr["batches"] * run["conv_bound_s"] / conv_s
