"""The readings a cell's correctness limit is set from: the program's
``gap_max`` and its control's on each seed, in one process.

    python3 harvest_bench/control.py --workload <cell> --seeds 1 2 3 --seconds 15 \
        [--control-seeds 3] [--device cpu]

For each seed it runs the cell as ``run.py`` does (set-up, warm-up, a
window of ``--seconds`` at the cell's load), frees the engine, and reads
the sample's ``gap_max`` against the float32 reference (the lower reading)
and the control's (the upper reading): the reference put in the program's
place at the precision below the configuration's (``control`` in the
configuration file: ``Fp8`` below bfloat16, ``Bf16`` below the float32 of
the CPU rehearsal), at the same positions. One JSON line a seed, then one
with the largest program reading and the smallest control reading. The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harvest_bench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first n seeds only (default: all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    run.use_checkout()
    import torch

    from harvest_bench.harness.check import compare
    from harvest_bench.harness.spec import load_cell
    from harvest_bench.reference import common

    cell = load_cell(args.workload, rehearsal=args.device == "cpu")
    if not cell.rehearsal and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    section = cell.config["rehearsal"] if cell.rehearsal else cell.config
    control = getattr(common, section["control"])()
    lines = []
    with torch.no_grad():
        n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
        for i, seed in enumerate(args.seeds):
            s = run.serve(cell, seed, args.seconds, False, time.monotonic())
            finished = [x.req for x in s.window.finished]
            del s.window
            run.free_device()
            t = time.monotonic()
            numbers = compare(s.weights, cell.config, finished, seed,
                              cell.traffic["check"]["served_tokens"], cell.rehearsal,
                              control if i < n_control else None)
            numbers.update(seed=seed, control=control.name if i < n_control else None,
                           compare_s=time.monotonic() - t, finished=len(finished))
            del s
            run.free_device()
            print(json.dumps(numbers), flush=True)
            lines.append(numbers)
    summary = {"workload": cell.name, "seeds": args.seeds}
    for stat in ("gap_max", "gap_mean", "flip_share"):
        summary[stat] = {"lower": max(n[stat] for n in lines),
                         "upper": min((n["control_" + stat] for n in lines
                                       if "control_" + stat in n), default=None)}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for n in lines + [summary]:
                f.write(json.dumps(n) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
