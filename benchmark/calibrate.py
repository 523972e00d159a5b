"""The readings that the comparison's limits are set from, on the card.

    python3 -m benchmark.calibrate --config <name> --traffic <name>
                                   --seeds 1 2 3 ... [--seconds 3]
                                   [--out PATH]

For each seed, one run of the configuration under the traffic mix, found
by their names as ``benchmark.run`` finds a cell's, as it makes it (a short
window at the cell's own load, every checked frame compared), in one
process: the program's numbers against the reference that the
configuration names (the lower readings) and the control's, that
reference's ``CONTROL`` (computed with its map and frames stored in
bfloat16) put in the program's place (the upper readings), with each
checked frame's counts and quantiles (``diag``).
Prints a JSON line a seed and writes them to ``--out``.  Not run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    lines = []
    for seed in args.seeds:
        res = run.run_cell(spec.load_config(args.config),
                           spec.load_traffic(args.traffic), seed,
                           args.seconds, False, "cuda", control=True)
        line = {"config": args.config, "traffic": args.traffic,
                "seed": seed,
                "program": {k: v[0] for k, v in res["check"].items()},
                "control": res["control"],
                "checked_frames": res["checked_frames"],
                "attempted": res["attempted"], "failed": res["failed"],
                "overflow": res["overflow"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "diag": res["diag"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
