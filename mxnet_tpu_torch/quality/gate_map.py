"""The multi-seed mAP gate (counterpart of ``ci/gate_map.py`` and of
``ci/run_tests.sh``'s ``run_map_gate``).

One training run's mAP varies widely with its seed, so a recipe is run at
two fixed seeds and the median of their mAPs (the mean, for two) is gated
against a floor set from the port's own seed sweep on the card: the mean
of seeds 0 and 1 less about 20%, which a regression that halves the
typical mAP cannot clear.

    python -m mxnet_tpu_torch.quality.gate_map --run ssd300|ssd512|frcnn|rfcn|all
    python -m mxnet_tpu_torch.quality.gate_map --extract run.log
    python -m mxnet_tpu_torch.quality.gate_map --floor 0.14 0.09 0.27

``--run`` starts each seed's ``eval_*_map`` script in its own process (on
the card unless ``--device cpu``), echoes its output, writes it to
``--log-dir`` when given, and exits 1 unless every recipe's median clears
its floor.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import re
import statistics
import subprocess
import sys

__all__ = ["RECIPES", "FLOORS", "SINGLE_RUN_FLOORS", "extract_map", "final_map", "gate",
           "run_recipe", "main"]

# every eval script prints:  FINAL <recipe> <name> = <value>  (...); the
# match is non-greedy up to the first spaced "=", so the trailing "(steps=…,
# eval n=…)" cannot shadow the mAP
_FINAL_RE = re.compile(r"^FINAL\b.*?\s=\s+([0-9]*\.?[0-9]+)")
_TIMES_RE = re.compile(r"^TIMES\b.*\btrain_s=([0-9.]+) steps_per_s=([0-9.]+) eval_s=([0-9.]+)")

# the recipes of ci/run_tests.sh's chip tier: module and arguments
RECIPES = {
    "ssd300": ("eval_ssd_map", ["--full", "--steps", "2000"]),
    "ssd512": ("eval_ssd_map", ["--full", "--size", "512", "--steps", "2000"]),
    "frcnn": ("eval_frcnn_map", ["--vgg16", "--steps", "3000"]),
    "rfcn": ("eval_rfcn_map", ["--resnet101", "--steps", "3000", "--live-bn"]),
}
SEEDS = (0, 1)
# the port's floors: the mean of seeds 0 and 1 less ~20%, rounded down, from
# its own sweep on an H100 (PERF.md §5, "Detection quality on the card")
FLOORS = {"ssd300": 0.34, "ssd512": 0.50, "frcnn": 0.61, "rfcn": 0.11}
# one run's floor (chip_smoke.py's map_ssd300): the sweep's lowest run less
# ~20%, rounded down (the same sweep)
SINGLE_RUN_FLOORS = {"ssd300": 0.27}


def final_map(lines):
    """The last ``FINAL ... = <value>`` line's value among ``lines``, or None."""
    value = None
    for line in lines:
        m = _FINAL_RE.match(line.strip())
        if m:
            value = float(m.group(1))
    return value


def extract_map(path):
    """The last FINAL line's mAP in the log file ``path``."""
    with open(path, encoding="utf-8", errors="replace") as f:
        value = final_map(f)
    if value is None:
        raise SystemExit("%s: no 'FINAL ... = <mAP>' line found" % path)
    return value


def gate(values, floor):
    """-> (passed, line): the median of ``values`` against ``floor``."""
    med = statistics.median(values)
    line = "gate_map: median(%s) = %.4f vs floor %.4f" % (
        ", ".join("%.4f" % v for v in values), med, floor)
    return med >= floor, ("PASS: " if med >= floor else "FAIL: ") + line


def run_recipe(name, seeds=SEEDS, device=None, log_dir=None):
    """Run recipe ``name`` once per seed, each in its own process from the
    repository's root, echoing its output.  -> [(seed, mAP, train_s,
    steps_per_s, eval_s)]; raises SystemExit when a run fails or prints no
    FINAL line."""
    module, args = RECIPES[name]
    root = pathlib.Path(__file__).resolve().parents[2]
    out = []
    for seed in seeds:
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.quality." + module, *args,
               "--seed", str(seed)]
        if device is not None:
            cmd += ["--device", device]
        print("gate_map: %s seed %d: %s" % (name, seed, " ".join(cmd[1:])), flush=True)
        lines = []
        with subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) as proc:
            for line in proc.stdout:
                sys.stdout.write(line)
                lines.append(line)
        sys.stdout.flush()
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, "%s_seed%d.log" % (name, seed)), "w") as f:
                f.writelines(lines)
        value = final_map(lines)
        if proc.returncode != 0 or value is None:
            raise SystemExit("gate_map: %s seed %d failed (exit %d)"
                             % (name, seed, proc.returncode))
        times = next((m.groups() for m in map(_TIMES_RE.match, lines) if m), (None,) * 3)
        out.append((seed, value, *(None if t is None else float(t) for t in times)))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--extract", metavar="LOG",
                   help="print the FINAL mAP value parsed from LOG and exit")
    p.add_argument("--floor", type=float, help="exit 1 unless median(values) >= FLOOR")
    p.add_argument("values", nargs="*", type=float, help="per-seed mAP values to gate")
    p.add_argument("--run", choices=sorted(RECIPES) + ["all"],
                   help="run a recipe (or all) at --seeds and gate the median")
    p.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--log-dir", default=None, help="write each run's output here")
    args = p.parse_args(argv)

    if args.extract:
        print("%.4f" % extract_map(args.extract))
        return 0
    if args.run:
        names = sorted(RECIPES) if args.run == "all" else [args.run]
        ok = True
        summary = []
        for name in names:
            runs = run_recipe(name, args.seeds, args.device, args.log_dir)
            passed, line = gate([r[1] for r in runs], FLOORS[name])
            ok &= passed
            summary.append("%s %s; runs (seed, mAP, train s, steps/s, eval s): %s"
                           % (name, line, runs))
        for line in summary:
            print(line, flush=True)
        return 0 if ok else 1
    if args.floor is None or not args.values:
        p.error("need --run NAME, --extract LOG, or --floor F plus values")
    passed, line = gate(args.values, args.floor)
    print(line)
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
