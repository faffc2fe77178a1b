"""The closed-loop pipeline under a fast switch interval: every batch is
dispatched once, collected once, in order, and a timed window stops
dispatching when it closes."""

from __future__ import annotations

import sys
import threading

from portbench.run import drive

TRAFFIC = {"inflight": 4, "warm_batches": 3}


class Fake:
    """A program whose calls do a little Python work each."""

    def __init__(self):
        self.lock = threading.Lock()
        self.dispatched = []

    def dispatch(self, frames):
        with self.lock:
            self.dispatched.append(frames)
        return (frames, sum(range(200)))

    @staticmethod
    def wait(handle):
        pass

    @staticmethod
    def collect(handle):
        return [handle[0]] * 2

    @staticmethod
    def decoded(handle):
        return handle[0]


def test_every_batch_once_in_order():
    previous = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        program = Fake()
        res = drive(program, list(range(5)), TRAFFIC, n_batches=2000,
                    keep=lambda i: i % 7 == 0)
        timed = drive(Fake(), list(range(5)), TRAFFIC, seconds=0.3)
    finally:
        sys.setswitchinterval(previous)
    assert not res["errors"]
    assert [r[0] for r in res["records"]] == list(range(2000))
    assert program.dispatched == [i % 5 for i in range(2000)]
    assert all(r[1] <= r[2] <= r[3] <= r[4] for r in res["records"])
    assert sorted(res["kept"]) == list(range(0, 2000, 7))
    assert all(res["kept"][i][0] == i % 5 for i in res["kept"])
    assert timed["open"] is not None and not timed["errors"]
    assert abs(timed["close"] - timed["open"] - 0.3) < 1e-9
    inside = [r for r in timed["records"]
              if timed["open"] < r[4] <= timed["close"]]
    assert len(inside) > 10
    # dispatching stops at the close; what was in flight still drains
    assert max(r[1] for r in timed["records"]) < timed["close"] + 0.05
