"""The readings that the limits in `slambench/limits/<cell>.json` are set
from: the program's compared numbers over many seeds, and in the same
runs the control's (the reference put in the program's place in
bfloat16, the precision below the float32 the program states); and each
fault of `slambench/faults.py` planted on `--fault-seeds`. Each is run as
the benchmark runs a cell, all in one process on the card.

    python -m slambench.limits --workload <cell> --seeds 1,2,3 \
        [--fault-seeds 7,8,9] [--faults unchanged,half] [--seconds 30] [--out FILE.jsonl]

Prints one JSON line per run: the seed, the control or fault, the numbers
(for the control's runs, the program's own under "sound") and the
end-to-end metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

from slambench import faults, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings for a cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default=",".join(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--short-seconds", type=float, default=12.0,
                    help="the window of the fault runs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.set_process_env()
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("slambench.limits: no CUDA device", file=sys.stderr)
        return 3
    runs = [(int(s), "bf16") for s in args.seeds.split(",") if s]
    runs += [(int(s), f) for f in args.faults.split(",") for s in args.fault_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    frames: dict = {}
    for seed, control in runs:
        with faults.plant(control) if control in faults.FAULTS else contextlib.nullcontext():
            seconds = args.seconds if control == "bf16" else args.short_seconds
            out_run = run.run_cell(Path.cwd(), args.workload, seed, seconds, False,
                                   control=None if control in faults.FAULTS else control,
                                   t_process=time.perf_counter(), frames_cache=frames)
        r = out_run["result"]
        line = json.dumps({"workload": args.workload, "seed": seed, "control": control,
                           "numbers": out_run["numbers"], "sound": out_run["sound"],
                           "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                           "attempted": r["attempted"], "failed": r["failed"],
                           "log": out_run["log"][:3]})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
