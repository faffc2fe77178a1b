"""Readings that the benchmark's data files were set from, on the card.

    python -m portbench.calibrate sweep --workload vgg2016-crowd-b8 --seed 1
    python -m portbench.calibrate seeds --workload vgg2016-crowd-b8 \\
        --seeds 11,12,13 --seconds 2 [--control]

``sweep``: for each candidate ``peaks_per_part`` of the cell's traffic,
the peaks a part and people a frame that the reference decode finds in
the reference's float32 maps of the whole pool (the head shaped on its
first batch, as a run shapes it): how the traffic's head constants were
chosen, below the decode's capacities of 32 peaks a part and 32 people a
frame.

``seeds``: whole runs of the cell on several seeds in one process (the
program; with ``--control`` the configuration's lower-precision control
in its place; with ``--fault`` a fault of ``faults.py`` planted under
it), one JSON line each with every compared number: the readings the
limits in ``limits/<workload>.json`` were set from.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from portbench import catalog
from portbench.faults import FAULTS, planted

__all__ = ["main", "sweep"]


def sweep(name: str, seed: int, targets, device="cuda") -> list:
    import torch

    from portbench.params import Params, frame_pool, shape_head
    from portbench.reference import decode, family as family_of
    from portbench.reference.common import no_tf32, preprocess

    cell = catalog.workload(catalog.load_benchmark(), name)
    cfg = catalog.load_config(cell["config"])
    traffic = catalog.load_traffic(cell["traffic"])
    family = family_of(cfg["reference"])
    pool = frame_pool(traffic, seed, device)
    b = traffic["batch"]
    rows = []
    for target in targets:
        params = Params(family.param_specs(cfg), seed, device,
                        getattr(torch, cfg["dtype"]))
        shape_head(family, cfg, params, pool[:b],
                    {**traffic["head"], "peaks_per_part": target}, device)
        values = params.float32()
        per_part, people = [], []
        with torch.no_grad(), no_tf32():
            for s in range(0, len(pool), 8):
                x = torch.from_numpy(pool[s:s + 8]).to(device)
                out = family.forward(values, preprocess(x), cfg)
                xy, score, valid = decode.find_peaks(out["heat"])
                paf = out["paf"].float().cpu().numpy()
                per_part.append(valid.reshape(len(x), 18, -1).sum(-1))
                people += [len(decode.assemble(xy[i], score[i], valid[i],
                                               paf[i], *pool.shape[1:3]))
                           for i in range(len(x))]
        per_part = np.concatenate(per_part)
        rows.append({"peaks_per_part": target,
                     "peaks_max": int(per_part.max()),
                     "peaks_mean": float(per_part.mean()),
                     "people_max": max(people),
                     "people_mean": float(np.mean(people)),
                     "frames": len(pool)})
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("sweep", "seeds"))
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--targets", default="4,8,12,16,20,24")
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--keep-all", action="store_true",
                        help="check every batch of the window")
    parser.add_argument("--fault", choices=sorted(FAULTS), default=None,
                        help="plant a fault under the timed path")
    args = parser.parse_args(argv)
    from portbench.run import cache_dirs, execute

    cache_dirs(str(catalog.REPO))
    if args.mode == "sweep":
        for row in sweep(args.workload, args.seed,
                         [float(m) for m in args.targets.split(",")]):
            print(json.dumps(row), flush=True)
        return 0
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with planted(args.fault):
            result = execute(args.workload, seed, args.seconds, False,
                             control=args.control, t0=t0,
                             keep_all=args.keep_all)
        print(json.dumps({
            "seed": seed, "control": args.control, "fault": args.fault,
            "correct": result["correct"], "metrics": result["metrics"],
            "checks": result["checks"], **result["_diagnostics"],
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
