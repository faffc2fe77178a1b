"""Launches of the three decode kernels a batch, counted by kernel name
in the trace (3 when the profiler keeps every record)."""


def read(run):
    tr = run["trace"]
    if not tr or not tr["batches"]:
        return None
    return sum(tr["decode_counts"].values()) / tr["batches"]
