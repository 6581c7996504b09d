"""Run one cell of the benchmark once, on the card this process starts on.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the compared numbers beside their limits on standard error, then one
JSON line on standard output: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``), ``checks``
last. Without a card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result. Kernel libraries are built into
``build/`` inside the checkout, so only a checkout's first run compiles;
the port's autotune store and the profiler's trace go under ``TMPDIR``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def prepare_environment(root: Path) -> None:
    """Fixed cache directories inside the checkout, an empty autotune store
    of this run's own, and none of the port's switches from outside."""
    for name in ("NETREP_FAULT_PLAN", "NETREP_TELEMETRY", "NETREP_PEAK_OVERRIDES",
                 "NETREP_NULL_MARGIN_SCALE"):
        os.environ.pop(name, None)
    os.environ["NETREP_AOT_STORE"] = str(root / "build" / "netrep_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["NETREP_AUTOTUNE_STORE"] = tempfile.mkdtemp(prefix="portbench-autotune-")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    prepare_environment(ROOT)
    import torch

    from portbench import core

    chips = int(core.by_name(core.load_json(ROOT / "BENCHMARK.json")["workloads"],
                             args.workload, "workload")["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = core.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", T_PROCESS)
    except core.ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    print("portbench: " + json.dumps(out.pop("timing")), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
