"""Run one cell of the benchmark of ``spinglass_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device`` and, with
``--trace 1``, ``breakdown``; then ``checks``. Exits non-zero and prints no
result without a CUDA device (or with fewer than the cell asks for), when a
forbidden module was loaded, or when anything fails.

``--control <name>`` runs one of the workload's lower-precision controls in
the program's place (for setting limits; no benchmark run uses it).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root in place of this folder: the benchmark's modules are
# imported as ``portbench.*``, and none of them may shadow the standard
# library's
sys.path[0] = ROOT


def process_age() -> float:
    """Seconds since this process started (its start-up before the first
    line here counts in the set-up), 0 where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    t_start = T_START - process_age()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    from portbench import harness
    from portbench.reference.judge import table

    try:
        bench = harness.benchmark()
        wl = harness.cell(args.workload, bench)
        cfg = harness.load_json("configs", f"{wl['config']}.json")
        import torch

        if not torch.cuda.is_available():
            raise harness.RunFailed("no CUDA device")
        if torch.cuda.device_count() < wl["chips"]:
            raise harness.RunFailed(
                f"{wl['chips']} cards asked for, "
                f"{torch.cuda.device_count()} present")
        out = harness.run_cell(wl, cfg, bench, args.seed, args.seconds,
                               bool(args.trace), t_start=t_start,
                               control=args.control)
    except harness.RunFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    print(table(out["checks"]), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
