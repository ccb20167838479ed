"""The training driver end to end on the CPU at tiny widths (the chip check
skipped), the contract's result line, and faults planted in the timed
path that ``correct`` must catch."""

import time

import pytest
import torch

from portbench import calibrate, common, run, tiny


def tiny_run(name, seed, seconds=2.0):
    cell = common.load_json("workloads", f"{name}.json")
    config = tiny.config(common.load_json("configs", f"{cell['config']}.json"))
    traffic = tiny.traffic(common.load_json("traffic", f"{cell['traffic']}.json"))
    return common.cell_run(name, seed, seconds, False, torch.device("cpu"), time.time(),
                           cell=cell, config=config, traffic=traffic)


def test_train_driver_prints_the_contract_line(cpu_threads, capsys):
    from portbench.drivers import train

    r = tiny_run("train-whole.smollm", 4_000_000_017)
    out = train.run(r)
    line = run.result_line(common.benchmark(), r, out)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "train_audio_s_per_s", "train_peak_gib"}
    assert line["device"]["platform"] == "cpu"
    err = capsys.readouterr().err
    assert all(f"check {k}:" in err for k in line["checks"])


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_train_faults_are_not_correct(cpu_threads, fault):
    r = tiny_run("train-whole.smollm", 99, seconds=0.5)
    got = calibrate.readings(r, fault)
    assert got["correct"] is False, got["numbers"]


@pytest.mark.card
@pytest.mark.parametrize("name", ["train-whole.smollm", "train-longform.qwen"])
def test_control_fails_at_the_cells_size(card, name):
    """The float8 control at the cell's own size on three seeds: each fails
    one of the cell's limits (run on the chip)."""
    for seed in (71, 72, 73):
        r = common.cell_run(name, seed, 1.0, False, card, time.time())
        r.control = True
        got = calibrate.readings(r)
        limits = r.cell["check"]["limits"]
        assert any(got["control"][k] > limits[k] for k in limits), got
