"""Readings that set a cell's limits, in one process: the numbers the run
compares for each of several seeds, for the program as it is, for the
reference's lower-precision control, and for planted faults.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 13 --seconds 1 \
        [--control] [--fault half_batch|unchanged_state] [--dump <file>]

Prints one JSON line a seed; ``--dump`` appends each seed's per-leaf norms
(program, reference, control) to a file as one JSON line. The benchmark's
own runs never plant a fault or run the control.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import common  # noqa: E402


@contextlib.contextmanager
def planted(fault):
    """The timed path broken underneath: ``unchanged_state`` (the optimizer's
    update is never applied), ``half_batch`` (each microbatch loses its
    second half of rows, or a step of one-row microbatches its second half
    of microbatches, the mean taken over the rest)."""
    if fault is None:
        yield
        return
    undo = []
    if fault == "unchanged_state":
        from aat_tpu_torch.training import optim

        saved = optim.apply_updates
        optim.apply_updates = lambda params, updates: None
        undo.append(lambda: setattr(optim, "apply_updates", saved))
    elif fault == "half_batch":
        from aat_tpu_torch.training.trainer import AATTrainer

        saved = AATTrainer._to_device, AATTrainer.training_step

        def rows(self, batch):
            return {k: v[: (v.shape[0] + 1) // 2] for k, v in saved[0](self, batch).items()}

        def step(self, micro, fetch_metrics=True):
            # a microbatch of one row: the step's second half of microbatches
            if len(micro[0]["input_ids"]) == 1:
                micro = micro[: max(1, len(micro) // 2)]
            return saved[1](self, micro, fetch_metrics)

        AATTrainer._to_device, AATTrainer.training_step = rows, step
        undo.append(lambda: (setattr(AATTrainer, "_to_device", saved[0]),
                             setattr(AATTrainer, "training_step", saved[1])))
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for fn in undo:
            fn()


def readings(run: common.Run, fault=None, dump=None) -> dict:
    driver = importlib.import_module(f"portbench.drivers.{run.cell['driver']}")
    with planted(fault):
        out = driver.run(run)
    if dump:
        with open(dump, "a") as f:
            f.write(json.dumps({"seed": run.seed, "fault": fault,
                                **{k: out["readings"][k] for k in ("program", "reference")},
                                "control": out.get("control_readings")}) + "\n")
    return {"seed": run.seed, "fault": fault, "correct": common.judge(out["checks"]),
            "numbers": out["readings"]["numbers"], "control": out.get("control"),
            "reference_s": out.get("reference_s"), "setup_s": out["e2e"]["setup_s"],
            "attempted": out["attempted"], "failed": out["failed"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibration reads the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        run = common.cell_run(args.workload, seed, args.seconds, False, device, time.time())
        run.control = args.control
        print(json.dumps(readings(run, args.fault, args.dump)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
