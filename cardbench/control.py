#!/usr/bin/env python3
"""The control of a cell's check: the plain reference put in the
program's place, computed below the precision the configuration states
(its ``check.control``: ``wait_bits`` 16 holds ``wait_total`` in bfloat16,
``time_bits`` 16 holds the time columns in int16), and compared with the
reference as a run compares the program, on the same sample of clusters.

    python3 cardbench/control.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed with the numbers each control reads (both
controls, whichever the configuration names) and the limits.
Host only; the numbers are the control's readings that a cell's limits
are set below.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the precisions below the stated ones: each configuration's
# ``check.control`` is one of these
CONTROLS = {"wait_bf16": {"wait_bits": 16}, "time_int16": {"time_bits": 16}}


def readings(cell: str, seed: int) -> dict:
    from cardbench import harness

    manifest = harness.load_manifest()
    spec = harness.find_cell(manifest, cell)
    config = harness.load_config(spec["config"])
    traffic = harness.load_traffic(spec["traffic"])
    streams = harness.make_streams(config, traffic, seed)
    picks = harness.lane_picks(traffic["lanes"], config["clusters"]["count"],
                               config, seed)
    ref = harness.reference_leaves(config, streams, picks)
    out = {"cell": cell, "seed": seed, "clusters": len(picks),
           "limits": config["check"]["limits"]}
    for name, control in CONTROLS.items():
        ctl = harness.reference_leaves(config, streams, picks, **control)
        out[name] = harness.worst([harness.compare(ctl[k], ref[k])
                                   for k in picks])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
