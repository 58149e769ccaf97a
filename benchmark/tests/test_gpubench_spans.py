"""The per-layer metrics that read the program's spans
(seq2squiggle_tpu_torch/tracing.py), on short CPU runs of their cells: a
traced run reports each as a number; without the switch each reads as
nothing; the train step's readers take the window's untraced steps and no
other."""

import importlib.util
import io
import json
import time

import pytest
import torch

from benchmark.harness import core, spans

SMALL = {
    "r10-predict-genome": {"reads_per_job": 4, "mean_read_len": 400, "batch": 64, "judged_reads": 3},
    "r9-train": {"chunks": 8192, "files": 2, "batch": 64, "traced_steps": 2},
}
METRICS = {
    "r10-predict-genome": ("sampling.host_ms.predict", "run_loop.input_wait_ms.predict",
                           "run_loop.output_wait_ms.predict", "run_loop.offcpu_ms.predict",
                           "predict.job_setup_ms.predict"),
    "r9-train": ("train_step.host_ms.train", "train_step.masks_host_ms.train"),
}


def reader(name):
    spec = importlib.util.spec_from_file_location("m", core.BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def tracing(monkeypatch):
    """The recorder emptied, and the switch as the environment leaves it
    after the test (a traced run sets it)."""
    from seq2squiggle_tpu_torch import tracing

    monkeypatch.delenv(tracing.ENV, raising=False)
    tracing.reset()
    yield tracing
    monkeypatch.undo()
    tracing.switch_from_env()
    tracing.reset()


def test_the_metrics_are_declared_for_their_cells():
    declared = {m["name"]: m for m in core.load_cell("r9-train")[0]["per_layer"]}
    for cell, names in METRICS.items():
        for name in names:
            m = declared[name]
            assert m["workloads"] == [cell] and m["source"] == "program_span", name


@pytest.mark.parametrize("workload", list(SMALL))
def test_a_traced_run_reports_each_as_a_number(workload, tracing):
    out, err = io.StringIO(), io.StringIO()
    rc = core.run(workload, 2**31 + 31, 0.5, True, time.perf_counter(), device=torch.device("cpu"),
                  traffic_override=SMALL[workload], out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    for name in METRICS[workload]:
        value = res["metrics"][name]["value"]
        assert isinstance(value, float) and value >= 0, name
    if workload == "r9-train":
        m = res["metrics"]
        assert 0 < m["train_step.masks_host_ms.train"]["value"] < m["train_step.host_ms.train"]["value"]


def _window(workload, trace, tmp_path):
    _, cell, cfg_file, traffic, _ = core.load_cell(workload)
    ctx = core.make_context(cell, cfg_file, dict(traffic, **SMALL[workload]), 2**31 + 32,
                            torch.device("cpu"), str(tmp_path))
    driver = core.load_driver(ctx.traffic["driver"])(ctx)
    driver.setup()
    return driver.window(0.0, trace)


@pytest.mark.parametrize("workload", list(SMALL))
def test_without_the_switch_each_reads_as_nothing(workload, tracing, tmp_path):
    run = _window(workload, False, tmp_path)
    assert not tracing.enabled()
    for name in METRICS[workload]:
        assert reader(name)(run) is None, name


def test_the_train_readers_take_the_windows_untraced_steps(tracing, monkeypatch, tmp_path):
    monkeypatch.setenv(tracing.ENV, "1")
    run = _window("r9-train", True, tmp_path)
    checked = int(core.load_cell("r9-train")[3]["checked_steps"])
    after = int(core.load_cell("r9-train")[3]["traced_after_steps"])
    traced = range(checked + after, checked + after + SMALL["r9-train"]["traced_steps"])
    steps = spans.window_steps(run)
    assert len(steps) == run["untraced_steps"] == run["steps"] - len(traced)
    ids = [s.id for s, _ in steps]
    assert ids == [i for i in range(checked, checked + run["steps"]) if i not in traced]
    profiled = [r for r in tracing.records() if r.name == "train.step" and r.profiled]
    assert [r.id for r in profiled] == list(traced)
    want = sum(s.seconds for s, _ in steps) / len(steps)
    assert reader("train_step.host_ms.train")(run) == pytest.approx(1e3 * want)
