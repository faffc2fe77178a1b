"""The whole step's share of the card's bf16 peak: frames completed in
the window times the forward's FLOPs a frame, over the window's length
and the peak."""


def read(run):
    if run["peak"] is None or not run["frames"]:
        return None
    rate = run["frames"] * run["flops_per_frame"] / run["window_s"]
    return 100.0 * rate / run["peak"][0]
