"""Readings for the limits of ``correct``: runs a cell on many seeds in one
process and prints, per seed, the port's compared numbers and the
control's (the reference in TF32 in the port's place, on the same seeds,
samples and modules). Not part of any benchmark run.

    python portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds <s> [--out <file.jsonl>]
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run

    run.prepare_environment(ROOT)
    import torch

    from portbench import core

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a", encoding="utf-8") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = core.run_cell(ROOT, args.workload, seed, args.seconds, False, "cuda",
                            t0, control=seed in controls)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "correct": out["correct"],
                           "program": {k: v["value"] for k, v in out["checks"].items()},
                           "control": out.get("control"), "metrics": out["metrics"],
                           "timing": out["timing"], "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
