"""Host time a batch spends in ``collect_batch`` once its device work is
done (the packed buffer's conversion to ``Human``s,
``decode/device.py::packed_to_humans``), the mean over the window's
batches, by the benchmark's clock."""


def read(run):
    spans = [r[4] - r[3] for r in run["records"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
