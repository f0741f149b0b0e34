#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port on the card.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``cardbench/``
and the program (``multi_cluster_simulator_tpu_torch``). The cell's
configuration, traffic mix and metrics are found by name
(``cardbench/harness.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and with ``--trace 1`` the ``breakdown``), and last the numbers compared
with the plain reference, each with its limit, which are also the last
lines of standard error. Without a CUDA card, or with fewer cards than
the cell asks for, it prints no result and exits 2; it exits 3 if a JAX
module was loaded in the process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # caches of the libraries the program may build, at fixed paths inside
    # the checkout (the CUDA kernels land in build/kernels/ themselves)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    import torch

    from cardbench import harness

    # the program's host work is one thread's; idle pool threads would
    # only contend with it for the machine's cores
    torch.set_num_threads(1)

    manifest = harness.load_manifest()
    cell = harness.find_cell(manifest, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"cardbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), T0,
                           manifest)
    bad = harness.forbidden_modules()
    if bad:
        print(f"cardbench: modules loaded that the run must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    res, verdict, ctx = out["result"], out["verdict"], out["ctx"]
    w = ctx.window
    print(f"card: {_card_line()}")
    print(f"episodes {len(w.walls)} in {w.end - w.start:.6f} s; walls "
          f"min {min(w.walls):.6f} median {sorted(w.walls)[len(w.walls) // 2]:.6f} "
          f"max {max(w.walls):.6f} s; placed an episode {w.placed[-1]} of "
          f"{ctx.world.jobs}; setup {ctx.setup_s:.3f} s")
    print(f"episode walls (s): {[round(x, 6) for x in w.walls]}")
    print(f"checked {verdict['episodes_checked']} episodes x "
          f"{verdict['clusters_checked']} clusters against the plain "
          f"reference; seconds after the window: "
          f"{ {k: round(v, 3) for k, v in verdict['seconds'].items()} }")
    for name, n in res["checks"].items():
        print(f"check {name} {n['value']} limit {n['limit']}",
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
