"""The 95th percentile, over the window's batches, of the time from the
dispatch thread's call until the collector holds the batch's people, by
the benchmark's clock (a tail of single readings, so a per-layer metric
without a bound)."""

import statistics


def read(run):
    waits = [r[4] - r[1] for r in run["records"]]
    if len(waits) < 20:
        return None
    return 1e3 * statistics.quantiles(waits, n=20)[-1]
