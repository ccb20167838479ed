"""Run one cell of the benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``portbench/workloads/<cell>.json``; it names its
configuration (``configs/``), its traffic (``traffic/``) and its driver
(``drivers/``). With ``--trace 0`` the line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read by
``metrics/<metric>.py``. The last line of standard output is the result;
the numbers compared for ``correct`` close standard error and the line.
Exits non-zero without a result when the machine has fewer CUDA devices
than the cell asks for, when the port cannot be imported, or when the JAX
package or JAX is loaded in this process once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ.setdefault("USE_FLAX", "0")  # keep libraries the port may load off JAX
os.environ.setdefault("USE_JAX", "0")

from portbench import common  # noqa: E402

STARTED = common.process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = common.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        importlib.import_module("aat_tpu_torch")
    except ImportError as exc:
        print(f"the program under test, aat_tpu_torch, cannot be imported: {exc}",
              file=sys.stderr)
        return 4
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = common.cell_run(args.workload, args.seed, args.seconds, bool(args.trace), device,
                          STARTED)
    driver = importlib.import_module(f"portbench.drivers.{run.cell['driver']}")
    out = driver.run(run)
    print(f"run: {args.workload} seed {args.seed}: setup {out['e2e']['setup_s']:.2f} s, "
          f"window {out['obs']['window_s']:.2f} s, {out['attempted']} attempted, reference "
          f"{out.get('reference_s', 0.0):.2f} s, peak "
          f"{out['memory_peak_bytes'] / common.GIB:.2f} GiB", file=sys.stderr, flush=True)
    found = common.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 5
    print(json.dumps(result_line(bench, run, out)))
    return 0


def result_line(bench: dict, run, out: dict) -> dict:
    import torch

    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                       else "cpu"),
              "count": run.cell.get("chips", 1),
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": common.judge(out["checks"]), "attempted": out["attempted"],
            "failed": out["failed"]}
    if run.trace:
        obs = out["obs"]
        line["metrics"] = common.per_layer(bench, run.name, obs)
        device["busy_s"] = obs.get("busy_s")
        device["window_s"] = obs.get("traced_window_s")
        line["device"] = device
        if obs.get("breakdown"):
            line["breakdown"] = obs["breakdown"]
    else:
        line["metrics"] = common.end_to_end(bench, run.name, out["e2e"])
        line["device"] = device
    common.print_checks(out["checks"])
    line["checks"] = out["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
