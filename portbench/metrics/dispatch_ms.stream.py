"""Host time in ``PoseEstimator.estimate_batch_async`` a batch (the
estimator: upload, preprocess, forward and decode launches, the packed
copy's enqueue), the mean over the window's batches, by the benchmark's
clock around the call."""


def read(run):
    spans = [r[2] - r[1] for r in run["records"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
