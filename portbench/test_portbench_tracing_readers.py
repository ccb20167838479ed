"""The readers of the port's spans and counters (``yardstick/spans`` and
the ten ``metrics/`` files it serves): idle gaps put down to hand-built
spans whose phases are known, per-step device times and data-layer ratios
from a given counter table, ``None`` where the program has no tracing, the
real trainer's spans on the CPU, and on the card a traced step whose
device operations and busy time the spans leave as they were."""

import statistics
import time

import pytest
import torch

from portbench import common, tiny, trace_cost
from portbench.yardstick import spans
from portbench.yardstick import trace as ytrace

DEVICE_READERS = ("train.forward_ms", "train.backward_ms", "train.optimizer_ms",
                  "dropout.device_ms")
IDLE_READERS = ("device.idle_ms.h2d", "device.idle_ms.model", "device.idle_ms.between_steps")
DATA_READERS = ("data.collate_ms", "data.starved_share", "data.queue_wait_ms")
CELLS = ("train-whole.smollm", "train-longform.qwen")
# the flash kernels take heads of 64 or 128
HEADS_OF_64 = {"hidden_size": 128, "intermediate_size": 256, "num_attention_heads": 2,
               "num_key_value_heads": 1}


def marks(name, begin, end):
    return [(f"aat.{name}.begin", begin, begin + 1), (f"aat.{name}.end", end - 1, end)]


def one_step(t0=0.0):
    """A step at ``t0`` in a window of 1000 µs: host markers (and two other
    host operations) and device operations whose gaps are, by the phase
    open on the host when each begins: between steps 0-50 and 950-1000; h2d
    115-130; model 170-175, 220-230 (inside dropout), 260-300, 600-640;
    other (optimizer, the step's tail) 720-730, 820-900."""
    host = (marks("train.step", 100, 850) + marks("train.h2d", 110, 150)
            + marks("train.forward", 160, 400) + marks("ops.dropout", 200, 250)
            + marks("train.backward", 420, 700) + marks("ops.dropout", 450, 480)
            + marks("train.optimizer", 710, 800)
            + [("aten::copy_", 111, 149), ("aten::mm", 300, 600)])
    device = [("k1", 50, 115), ("k2", 130, 170), ("k3", 175, 220), ("k4", 230, 260),
              ("k5", 300, 600), ("k6", 640, 720), ("k7", 730, 820), ("k8", 900, 950)]
    return ([(n, a + t0, b + t0) for n, a, b in host],
            [(n, a + t0, b + t0) for n, a, b in device])


def test_idle_gaps_by_the_span_open_when_they_began():
    host, device = one_step()
    obs = {"host_ops": host, "device_ops": device, "traced_window_us": (0.0, 1000.0)}
    got = spans.idle_by_phase(obs)
    assert got == {"h2d": 15.0, "model": 95.0, "between_steps": 100.0, "other": 90.0,
                   "steps": 1}
    want = {"device.idle_ms.h2d": 0.015, "device.idle_ms.model": 0.095,
            "device.idle_ms.between_steps": 0.1}
    assert {m: common.load_reader(m).read(obs) for m in IDLE_READERS} == pytest.approx(want)


def test_idle_readers_divide_by_the_traced_steps():
    (h1, d1), (h2, d2) = one_step(), one_step(1000.0)
    obs = {"host_ops": h2 + h1, "device_ops": d1 + d2, "traced_window_us": (0.0, 2000.0)}
    got = spans.idle_by_phase(obs)
    assert got["steps"] == 2 and got["model"] == 190.0 and got["between_steps"] == 200.0
    assert common.load_reader("device.idle_ms.model").read(obs) == pytest.approx(0.095)


def test_spans_rebuilt_from_markers_nest():
    host, _ = one_step()
    got = {(name, begin): outer for name, begin, _, outer in spans.spans(host)}
    assert got[("ops.dropout", 200)] == ("train.step", "train.forward")
    assert got[("ops.dropout", 450)] == ("train.step", "train.backward")
    assert got[("train.h2d", 110)] == ("train.step",)
    assert got[("train.step", 100)] == ()


def test_device_and_data_readers_from_the_counter_table(monkeypatch):
    table = {"span.train.step.calls": 2, "span.train.forward.device_s": 3.0,
             "span.train.backward.device_s": 5.0, "span.train.optimizer.device_s": 0.02,
             "span.ops.dropout.device_s": 4.0, "data.batches": 10, "data.collate_s": 2.0,
             "data.gets": 8, "data.empty_gets": 2, "data.wait_s": 0.4}
    monkeypatch.setattr(spans, "port_counters", lambda: table)
    want = {"train.forward_ms": 1500.0, "train.backward_ms": 2500.0,
            "train.optimizer_ms": 10.0, "dropout.device_ms": 2000.0,
            "data.collate_ms": 200.0, "data.starved_share": 25.0, "data.queue_wait_ms": 50.0}
    assert {m: common.load_reader(m).read({}) for m in want} == pytest.approx(want)


@pytest.mark.parametrize("table", [None, {}, {"data.batches": 3}])
def test_readers_give_none_without_the_programs_tracing(monkeypatch, table):
    """The parent's program: no counter table, an empty one (a run with
    tracing off), or no device spans; and profiler passes without markers."""
    monkeypatch.setattr(spans, "port_counters", lambda: table)
    _, device = one_step()
    obs = {"host_ops": [("aten::mm", 0, 10)], "device_ops": device,
           "traced_window_us": (0.0, 1000.0)}
    for metric in DEVICE_READERS + IDLE_READERS + DATA_READERS:
        assert common.load_reader(metric).read(obs) is None, metric
        assert common.load_reader(metric).read({}) is None, metric


def test_port_counters_absent_is_none(monkeypatch):
    from aat_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "counters")
    assert spans.port_counters() is None


def cell_file(name):
    return common.load_json("workloads", f"{name}.json")


def tiny_cell_run(name, seed, device, **config):
    cell = cell_file(name)
    return common.cell_run(
        name, seed, 0.0, True, device, time.time(), cell=cell,
        config=dict(tiny.config(common.load_json("configs", f"{cell['config']}.json")), **config),
        traffic=tiny.traffic(common.load_json("traffic", f"{cell['traffic']}.json")))


@pytest.mark.parametrize("remat", [False, True])
def test_trainer_spans_on_the_cpu(cpu_threads, remat):
    """A profiled training step of the whole cell's configuration at tiny
    width on the CPU: every span of the step appears, nested as placed
    (dropout inside the backward too where the encoder is recomputed),
    counted once a step or once a microbatch, with no device time."""
    from aat_tpu_torch.utils import timing

    r = tiny_cell_run("train-whole.smollm", 4_000_000_031, torch.device("cpu"),
                      encoder_remat=remat)
    trainer, micro = trace_cost.build(r)
    timing.reset()
    got = spans.spans(trace_cost.Profiled(trainer, micro, r.device).host_ops)
    outer = {}
    for name, _, _, chain in got:
        outer.setdefault(name, set()).add(chain)
    forward, backward = ("train.step", "train.forward"), ("train.step", "train.backward")
    assert outer == {"train.step": {()}, "train.h2d": {("train.step",)},
                     "train.forward": {("train.step",)}, "train.backward": {("train.step",)},
                     "train.optimizer": {("train.step",)},
                     "ops.dropout": {forward, backward} if remat else {forward}}
    table = timing.counters()
    assert table["span.train.step.calls"] == 1 and table["span.train.optimizer.calls"] == 1
    for name in ("train.h2d", "train.forward", "train.backward"):
        assert table[f"span.{name}.calls"] == len(micro)
    assert not any(k.endswith(".device_s") for k in table)
    timing.reset()


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_spans_leave_the_device_trace_as_it_was(card, name):
    """A profiled step of the cell's configuration at tiny width (heads of
    64, which the flash kernels take; LayerDrop off, so every step runs the
    same kernels): no ``aat.`` name among the profiler's device
    operations, and busy device time within 1% of the same step's with
    ``span`` patched to the no-op (medians of five each, in turns; run on
    the chip)."""
    from aat_tpu_torch.utils import timing

    remat = common.load_json("configs", f"{cell_file(name)['config']}.json")["encoder_remat"]
    r = tiny_cell_run(name, 4_000_000_037, card, compute_dtype="bfloat16", encoder_remat=remat,
                      hubert=dict(tiny.HUBERT, **HEADS_OF_64, layerdrop=0.0),
                      lm=dict(tiny.LM, **HEADS_OF_64))
    trainer, micro = trace_cost.build(r)
    for _ in range(2):
        trace_cost.step_wall(trainer, micro, card)
    timing.reset()
    runs = {"spans": [], "no_op": []}
    for _ in range(5):
        with_spans = trace_cost.Profiled(trainer, micro, card)
        assert with_spans.aat_on_device == 0
        runs["spans"].append(with_spans.device_ops)
        with trace_cost.patched_span(trace_cost.no_op_span):
            runs["no_op"].append(trace_cost.Profiled(trainer, micro, card).device_ops)
    table = timing.counters()
    assert table["span.train.step.calls"] == 5 and table["span.train.forward.device_s"] > 0
    busy = {k: [ytrace.busy_us(ops) for ops in v] for k, v in runs.items()}
    on, off = statistics.median(busy["spans"]), statistics.median(busy["no_op"])
    assert abs(on - off) <= 0.01 * off, (busy, differing_ops(
        *(runs[k][busy[k].index(m)] for k, m in (("spans", on), ("no_op", off)))))


def differing_ops(a, b, n=8):
    """The operation names whose count or summed time differ most between
    two profiler passes: ``[name, (count, us) in a, (count, us) in b]``."""
    def by_name(ops):
        out = {}
        for name, start, end in ops:
            c, t = out.get(name, (0, 0.0))
            out[name] = (c + 1, t + end - start)
        return out

    sa, sb = by_name(a), by_name(b)
    names = sorted(set(sa) | set(sb), key=lambda k: -abs(sa.get(k, (0, 0.0))[1]
                                                          - sb.get(k, (0, 0.0))[1]))
    return [[k[:80], sa.get(k), sb.get(k)] for k in names[:n]]
