"""The plain reference against the port's plain routes at tiny widths, its
lower-precision control against the comparison, and what the harness and
the reference import."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import common, tiny
from portbench.reference import hashing, train_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 7, -12345, 2**31 + 17])
def test_dropout_rules_equal_the_ports(seed):
    from aat_tpu_torch.ops import attention, dropout

    assert hashing.fold_seed(seed, 3, 1) == dropout.fold_seed(seed, 3, 1)
    assert hashing.uniform_from_seed(seed) == dropout.uniform_from_seed(seed)
    x = torch.ones((6, 5, 7))
    s = dropout.fold_seed(seed, 2)
    got = hashing.dropout(s, x[2:5], 0.3, row0=2)
    assert torch.equal(got, dropout.dropout(s, x, 0.3)[2:5])
    keep = attention._keep_mask(s, 4, 3, 9, 11, 0.25, "cpu")
    assert torch.equal(hashing.attention_keep(s, 1, 2, 0, 3, 3, 9, 11, 0.25, "cpu"), keep[1:3])


def test_leaf_gap_sees_small_leaves_left_unmoved():
    """A program that moves every matrix as the reference does but never
    moves a bias or a norm scale reads a change gap of 1, however small
    those leaves are beside the matrices."""
    grads = {f"layer{i}/{kind}": size for i in range(24)
             for kind, size in (("kernel", 1.0), ("bias", 1e-2), ("scale", 1e-2))}
    changes = {p: (1.0 if p.endswith("kernel") else 1e-2) for p in grads}
    frozen = {p: (c if p.endswith("kernel") else 0.0) for p, c in changes.items()}
    reference = {"losses": [2.0], "grad_norms": grads, "change_norms": changes}
    program = {"losses": [2.0], "grad_norms": grads, "change_norms": frozen}
    got = train_ref.compare(program, reference)
    assert got["change_gap"] == 1.0 and got["grad_gap"] == 0.0
    assert got["excluded_leaves"] == 0


def tiny_train_run(seed):
    cell = common.load_json("workloads", "train-whole.smollm.json")
    config = tiny.config(common.load_json("configs", f"{cell['config']}.json"))
    traffic = tiny.traffic(common.load_json("traffic", f"{cell['traffic']}.json"))
    return common.cell_run(cell["name"], seed, 1.0, False, torch.device("cpu"), time.time(),
                           cell=cell, config=config, traffic=traffic)


def test_port_agrees_with_the_reference_and_the_control_does_not(cpu_threads):
    """At f32 on the CPU the port's plain routes follow the reference to
    rounding; the reference in float8 misses it by far more."""
    from portbench.drivers import train

    run = tiny_train_run(2**31 + 5)
    run.control = True
    out = train.run(run)
    got, control = out["readings"]["numbers"], out["control"]
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4 and got["change_gap"] < 1e-3
    assert control["loss_gap"] > 30 * got["loss_gap"] and control["grad_gap"] > 0.01
    assert common.judge(out["checks"])
    assert not common.judge({k: {"value": control[k], "limit": c["limit"]}
                             for k, c in out["checks"].items()})


def loaded(modules):
    code = ("import sys, json; sys.path.insert(0, %r)\n" % ROOT
            + "".join(f"import {m}\n" for m in modules)
            + "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_and_reference_no_program():
    harness = ["portbench.run", "portbench.calibrate", "portbench.drivers.train",
               "aat_tpu_torch.training.trainer", "aat_tpu_torch.data.collate"]
    names = loaded(harness)
    assert "aat_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "aat_tpu"}
    reference = ["portbench.reference.train_ref", "portbench.reference.collate",
                 "portbench.weights"]
    names = loaded(reference)
    assert not names & {"jax", "jaxlib", "flax", "aat_tpu", "aat_tpu_torch"}
    for metric in os.listdir(os.path.join(ROOT, "portbench", "metrics")):
        assert "aat_tpu" not in open(os.path.join(ROOT, "portbench", "metrics", metric)).read()
