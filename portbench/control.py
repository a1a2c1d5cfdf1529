"""The readings that the limits of `limits/<workload>.json` are set from.

    python -m portbench.control --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--out readings.jsonl]

In one process: for each of `--seeds`, the program's run of the cell (its
set-up, a short window at the cell's load, the comparison with the float64
reference); for each of `--control-seeds`, the control: the reference
computed in the precision below the configuration's (float32 -> bfloat16)
put in the program's place, on the same inputs, compared in the same way
(the runner's `control_numbers`).
Each reading is one JSON line. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell, cfg, traffic, limits, e2e, _ = harness.cell_files(args.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else sys.stdout
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        nums = {}
        res = harness.run_cell(cfg, traffic, limits, e2e, seed, args.seconds, False, "cuda",
                               time.perf_counter(), numbers_out=nums)
        line = {"workload": args.workload, "who": "program", "seed": seed, "numbers": nums,
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), file=out, flush=True)
    import lws_torch
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t = time.perf_counter()
        drv = harness.kind(traffic["kind"]).Driver(lws_torch, cfg, traffic, seed, "cuda")
        drv.release()
        nums = drv.control_numbers("cuda")
        print(json.dumps({"workload": args.workload, "who": "control", "seed": seed,
                          "numbers": nums, "seconds": time.perf_counter() - t}),
              file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
