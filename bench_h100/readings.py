"""Readings of a cell's compared numbers, from which its limits are set
(not run by the benchmark's own runs):

    python3 bench_h100/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault-seeds 7,8,9] [--out file.jsonl]

Each seed runs the cell's set-up at its own size and then, without a
window, the same check as a run: the program (sound runs); the control,
the plain reference computed in FP8 put in the program's place; and each
fault of the driver's ``FAULTS`` planted in the program.  Prints one JSON
line per reading: every number the driver can compare, and the
exploratory numbers below, which no limit names."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import common  # noqa: E402


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


# ----------------------------------------------------------------- controls

def eval_control(drv, ref_model, fp8_model):
    """The reference in FP8 in the program's place in one call of the
    protocol on the pool's first split: the pairs the numbers read."""
    from reference.protocol import AsFloat, set_fp8

    drv.model = AsFloat(set_fp8(fp8_model, True))
    drv.sample = [(0, drv.call(0))]
    return drv.reference(ref_model)


def train_control(drv, ref_model, fp8_model):
    """The reference in FP8 in the program's place over the check epoch:
    (got, want)."""
    from reference.protocol import set_fp8

    got = drv.reference(set_fp8(fp8_model, True))
    return got, drv.reference(ref_model)


CONTROLS = {"eval_split": eval_control, "train_epochs": train_control}


def control(drv, kind, ref_model, fp8_model):
    """The control's readings, in the form the driver's numbers read; a
    driver of another kind brings its own ``control`` function."""
    mod = common.driver(kind)
    fn = getattr(mod, "control", None) or CONTROLS[kind]
    return fn(drv, ref_model, fp8_model)


def control_checks(drv, kind, ref_model, fp8_model, limits):
    """The cell's checks on the control."""
    mod = common.driver(kind)
    args = control(drv, kind, ref_model, fp8_model)
    args = args if isinstance(args, tuple) else (args,)
    return [common.check(n, mod.NUMBERS[n](*args), limits[n])
            for n in limits]


# ------------------------------------------------------- exploratory numbers

def eval_extra(pairs) -> dict:
    """The widest gap of a per-image Dice against the reference's."""
    return {"dice_gap": max(abs(a - b) for res, want in pairs
                            for a, b in zip(res["dice"], want["dice"]))}


def train_extra(got, want) -> dict:
    """First-gradient norms (worst leaf, worst moved leaf, median moved
    leaf), the first gradient's difference over all moved leaves, the
    median moved leaf's change-vector gap, the mean and widest
    gap of the validation probabilities after the epoch, the widest
    before it, and the worst leaf's name."""
    import numpy as np

    from reference import protocol as ref

    mod = common.driver("train_epochs")
    names, keep = mod.moved(want)

    def norms(d):
        return [float(d[n].double().norm()) for n in names]

    got_g, want_g = norms(got["grads"]), norms(want["grads"])
    kept = [n for n, k in zip(names, keep) if k]
    diff_all = sum(float((got["grads"][n].double() - want["grads"][n]
                          .double()).pow(2).sum()) for n in kept)
    want_all = sum(float(want["grads"][n].double().pow(2).sum())
                   for n in kept)
    diff_d = [float((got["delta"][n].double()
                     - want["delta"][n].double()).norm()) for n in names]
    gaps = ref.leaf_gaps([got["change"][n] for n in names],
                         [want["change"][n] for n in names], keep)
    epoch = (got["val_probs_epoch"] - want["val_probs_epoch"]).abs()
    return {
        "grad_gap": ref.worst_leaf_gap(got_g, want_g),
        "grad_gap_moved": ref.worst_leaf_gap(got_g, want_g, keep=keep),
        "grad_median_gap": ref.median_leaf_gap(got_g, want_g, keep=keep),
        "grad_vec_global_gap": (diff_all / want_all) ** 0.5,
        "change_vec_median_gap": ref.median_leaf_gap(
            diff_d, [0.0] * len(names), keep=keep,
            scale=norms(want["delta"])),
        "val_gap": float((got["val_probs"] - want["val_probs"]).abs().max()),
        "val_epoch_mean_gap": float(epoch.double().mean()),
        "val_epoch_gap": float(epoch.max()),
        "not_moved": [n for n, k in zip(names, keep) if not k],
        "worst_change": kept[int(np.argmax(gaps))] if gaps else None,
        "losses": [got["loss_sum"], want["loss_sum"]],
    }


def numbers(kind, drv, args) -> dict:
    mod = common.driver(kind)
    args = args if isinstance(args, tuple) else (args,)
    out = {n: fn(*args) for n, fn in mod.NUMBERS.items()}
    extra = {"eval_split": eval_extra, "train_epochs": train_extra}.get(kind)
    if extra:
        out.update(extra(*args))
    return out


# ----------------------------------------------------------------- readings

def reading(cell, seed, device, what, fault=None):
    """One reading: {cell, seed, what, fault, numbers, seconds}."""
    import torch

    from harness.run_cell import RunContext

    t0 = time.perf_counter()
    ctx = RunContext(cell, seed, device)
    kind = ctx.traffic["kind"]
    mod = common.driver(kind)
    if kind == "eval_split":
        ctx.traffic = dict(ctx.traffic, warmup_splits=1, pool_splits=1)
    drv = mod.Driver(ctx)
    with mod.FAULTS[fault]() if fault else contextlib.nullcontext():
        drv.setup()
        if kind == "eval_split":
            drv.sample = [(0, drv.call(0))]
    if what == "control":
        args = control(drv, kind, ctx.reference_model(),
                       ctx.reference_model())
    else:
        drv.release()
        want = drv.reference(ctx.reference_model())
        args = want if kind == "eval_split" else (drv.got, want)
    out = numbers(kind, drv, args)
    if kind == "train_epochs":
        out["skipped"] = args[0]["skipped"]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"cell": cell["name"], "seed": seed, "what": what,
            "fault": fault, "numbers": out,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="",
                    help="comma-separated faults (default: all but "
                         "'unchanged', which reads 1 by the measure)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    common.cache_environment()
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = common.cell(common.benchmark(), args.workload)
    kind = common.traffic(cell["traffic"])["kind"]
    table = common.driver(kind).FAULTS
    chosen = ([f for f in args.faults.split(",") if f] if args.faults
              else [f for f in table if f != "unchanged"])
    jobs = [(s, "program", None) for s in seeds(args.seeds)]
    jobs += [(s, "control", None) for s in seeds(args.control_seeds)]
    jobs += [(s, "fault", f) for s in seeds(args.fault_seeds)
             for f in chosen]
    out = open(args.out, "a") if args.out else None
    for seed, what, fault in jobs:
        rec = reading(cell, seed, device, what, fault=fault)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
