"""The host-output share `export.final_pct.predict`: its reader on made-up
runs, nothing where the program records neither counter, and a number in a
short traced CPU run of its cell."""

import importlib.util
import io
import json
import time

import pytest
import torch

from benchmark.harness import core

NAME = "export.final_pct.predict"
SMALL = {"reads_per_job": 4, "mean_read_len": 400, "batch": 64, "judged_reads": 3}


def reader():
    spec = importlib.util.spec_from_file_location("m", core.BENCH / "metrics" / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("timers,want", [
    ({}, None),  # a program without the counters
    ({"export.final_samples": 0.0, "export.behind_samples": 0.0}, None),
    ({"export.final_samples": 500.0}, 100.0),  # every sample waited for finalize
    ({"export.behind_samples": 500.0}, 0.0),
    ({"export.final_samples": 100.0, "export.behind_samples": 300.0}, 25.0),
])
def test_the_reader(timers, want):
    assert reader()({"timers": timers, "batches": 8, "untraced": [(1.0, 100)]}) == want


def test_the_cell_reports_it(monkeypatch):
    from seq2squiggle_tpu_torch import tracing

    monkeypatch.delenv(tracing.ENV, raising=False)
    tracing.reset()
    declared = {m["name"]: m for m in core.load_cell("r10-predict-genome")[0]["per_layer"]}
    assert declared[NAME]["workloads"] == ["r10-predict-genome"]
    out, err = io.StringIO(), io.StringIO()
    try:
        rc = core.run("r10-predict-genome", 2**31 + 41, 0.5, True, time.perf_counter(),
                      device=torch.device("cpu"), traffic_override=SMALL, out=out, err=err)
    finally:
        monkeypatch.undo()
        tracing.switch_from_env()
        tracing.reset()
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert 0.0 <= res["metrics"][NAME]["value"] <= 100.0
