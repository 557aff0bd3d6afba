"""The readings a cell's limits are set from, many seeds in one process.

    python3 portbench/tools/control.py --workload <name> --program 1,2,3 \
        [--control 1,2,3] [--half 1,2,3] [--unchanged 1,2,3] \
        [--seconds 20]

For each ``--program`` seed, the numbers that decide ``correct`` for a
sound run of the program (training: set-up's steps and readings, no
window; serving: a short window at the cell's own load, then the same
sample and comparison as a run).  For each ``--control`` seed, the
same numbers for the control: the reference put in the program's place
and computed in fp8, one precision below the configuration's bf16
(``reference/model.py``; training: the control's readings against the
reference's; serving: at each position of the served sequences, the
gap of the token the fp8 forward puts first).  Training's planted
faults, in the reference put in the program's place: for each
``--half`` seed, half of each batch left out, the mean taken over the
rest; for each ``--unchanged`` seed, steps that leave the state
unchanged.  One JSON line a reading on standard output; the run's own
output goes to standard error.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.lib import compare, harness, program  # noqa: E402
from portbench.reference import model as ref  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s] if text else []


def emit(**fields):
    print(json.dumps(fields), flush=True)


def train(args, ctx_of):
    drv = harness.load_module(os.path.join(harness.ROOT, "portbench",
                                           "drivers", "train.py"),
                              "portbench_driver_train")
    for seed in sorted(set(args.program) | set(args.control)
                       | set(args.half) | set(args.unchanged)):
        ctx = ctx_of(seed)
        t = time.perf_counter()
        cell = drv.TrainCell(ctx)
        got = cell.setup_steps()
        peak = program.read_peak(ctx.device)
        cell.close()
        base = drv.reference_readings(ctx, got["batches"])
        harness.log(f"seed {seed}: program and reference "
                    f"{time.perf_counter() - t:.1f} s")
        if seed in args.program:
            nums = compare.train_numbers(got, base)
            emit(kind="program", seed=seed, peak=peak,
                 losses=got["setup_losses"], ref_losses=base["losses"],
                 detail=compare.train_detail(got, base), **nums)
        if seed in args.control:
            low = drv.reference_readings(ctx, got["batches"],
                                         quant=ref.FP8)
            emit(kind="control", seed=seed, losses=low["losses"],
                 detail=compare.train_detail(low, base),
                 **compare.train_numbers(low, base))
        if seed in args.half:
            b = ctx.mix["batch"]
            half = drv.reference_readings(ctx, got["batches"],
                                          rows=slice(0, b // 2))
            emit(kind="half_batch", seed=seed, losses=half["losses"],
                 detail=compare.train_detail(half, base),
                 **compare.train_numbers(half, base))
        if seed in args.unchanged:
            still = drv.reference_readings(ctx, got["batches"], lr=0.0)
            emit(kind="unchanged", seed=seed, losses=still["losses"],
                 detail=compare.train_detail(still, base),
                 **compare.train_numbers(still, base))
        shutil.rmtree(ctx.scratch, ignore_errors=True)


def serve(args, ctx_of):
    drv = harness.load_module(os.path.join(harness.ROOT, "portbench",
                                           "drivers", "serve_open_loop.py"),
                              "portbench_driver_serve_open_loop")
    from portbench.lib.traffic import serve_schedule

    for seed in sorted(set(args.program) | set(args.control)):
        ctx = ctx_of(seed)
        cell = drv.ServeCell(ctx)
        schedule = serve_schedule(ctx.mix, seed, ctx.seconds,
                                  ctx.geometry.vocab)
        outcomes, t0, _ = cell.window(schedule, ctx.seconds)
        cell.close()
        summary = drv.summarize(ctx, outcomes, t0)
        picked = drv.sample(outcomes, seed, ctx.mix["check_requests"],
                            ctx.mix["check_tokens"])
        quant = ref.FP8 if seed in args.control else False
        gaps = drv.served_gaps(ctx, picked, quant=quant)
        emit(kind="serve", seed=seed, requests=len(outcomes),
             failed=summary["failed"], sample=len(picked), **gaps)
        shutil.rmtree(ctx.scratch, ignore_errors=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program", type=seeds, default=[])
    p.add_argument("--control", type=seeds, default=[])
    p.add_argument("--half", type=seeds, default=[])
    p.add_argument("--unchanged", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args()
    bench = harness.load_benchmark()

    def ctx_of(seed):
        ctx = harness.build_context(args.workload, seed, args.seconds, False,
                                    bench=bench)
        ctx.scratch = tempfile.mkdtemp(prefix="portbench-control-")
        return ctx

    kind = harness.build_context(args.workload, 0, 1, False,
                                 bench=bench).mix["driver"]
    (train if kind == "train" else serve)(args, ctx_of)
    return 0


if __name__ == "__main__":
    sys.exit(main())
