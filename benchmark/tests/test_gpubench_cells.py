"""Whole runs of the cells on the CPU at small sizes, with the look for a
card skipped: a sound run is correct; the control (the reference at float8
in the program's place) and runs with the timed path broken are not. The
same runs on the card are marked `gpu`."""

import io
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import core

# r9-train keeps the cell's 128 steps an epoch (so its 32 steps of learning-
# rate warm-up): the checked steps then move the fitted weights as little
# as the cell's do.
SMALL = {
    "r10-predict-genome": {"reads_per_job": 4, "mean_read_len": 400, "batch": 64, "judged_reads": 3},
    "r9-train": {"chunks": 8192, "files": 2, "batch": 64, "traced_steps": 2},
}


def _run(workload, seed=2**31 + 21, trace=False, **override):
    out, err = io.StringIO(), io.StringIO()
    rc = core.run(workload, seed, 0.5, trace, time.perf_counter(), device=torch.device("cpu"),
                  traffic_override=dict(SMALL[workload], **override), out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", list(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(workload, trace):
    res = _run(workload, trace=trace)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    if not trace:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2


@pytest.mark.parametrize("override", [{"input": "reads"}, {"length_distribution": "gamma"},
                                      {"input": "reads", "length_distribution": "beta"}])
def test_other_predict_traffic_is_correct_without_code(override):
    """Read mode and the other read-length fits are traffic keys: a sound
    run of them is correct, and the judged reads are the ones the mode
    simulates."""
    res = _run("r10-predict-genome", seed=2**31 + 25, **override)
    assert res["correct"], res["checks"]
    assert res["checks"]["gap_p99_counts"]["value"] < res["checks"]["gap_p99_counts"]["limit"]


def _context(workload, seed, tmp_path):
    _, cell, cfg_file, traffic, limits = core.load_cell(workload)
    ctx = core.make_context(cell, cfg_file, dict(traffic, **SMALL[workload]), seed,
                            torch.device("cpu"), str(tmp_path))
    driver = core.load_driver(ctx.traffic["driver"])(ctx)
    driver.setup()
    driver.window(0.0, False)
    return driver, limits


def _fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("workload", list(SMALL))
def test_the_control_is_not_correct(workload, tmp_path):
    driver, limits = _context(workload, 2**31 + 22, tmp_path)
    assert not _fails(driver.check(), limits)
    assert _fails(driver.check(control="float8_e4m3"), limits)


def _perturb_decoder(monkeypatch):
    """A token or an answer altered where it is produced: the decoder's
    output 10 % off on one row in eight."""
    from seq2squiggle_tpu_torch.runtime import predict

    real = predict.decoder_output

    def altered(*a, **k):
        dec, *rest = real(*a, **k)
        dec = dec.clone()
        dec[::8] = (dec[::8].float() * 1.10).to(dec.dtype)
        return (dec, *rest)

    monkeypatch.setattr(predict, "decoder_output", altered)


def _half_batch_predict(monkeypatch):
    """Half of each batch left out: the second half's rows come back empty."""
    from seq2squiggle_tpu_torch.runtime import predict

    real = predict.decoder_output

    def halved(*a, **k):
        dec, *rest = real(*a, **k)
        dec = dec.clone()
        dec[dec.shape[0] // 2:] = 0
        return (dec, *rest)

    monkeypatch.setattr(predict, "decoder_output", halved)


def _unchanged_state(monkeypatch):
    """A step that returns its state unchanged: the optimizer does nothing."""
    from seq2squiggle_tpu_torch.train import optimizers

    monkeypatch.setattr(optimizers.Optimizer, "update", lambda self, g, s, p: None)


def _half_batch_train(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from seq2squiggle_tpu_torch.train import loop

    real = loop.loss_fn

    def halved(params, batch, mask, *a, **k):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0
        return real(params, batch, mask, *a, **k)

    monkeypatch.setattr(loop, "loss_fn", halved)


def _altered_loss(monkeypatch):
    """An answer altered where it is produced: the loss's signal term 10 %
    high."""
    from seq2squiggle_tpu_torch.train import loop

    real = loop.total_loss

    def altered(*a, **k):
        total, terms = real(*a, **k)
        total = total + 0.1 * terms["signal_loss"]
        return total, dict(terms, total_loss=total)

    monkeypatch.setattr(loop, "total_loss", altered)


@pytest.mark.parametrize("workload,fault", [
    ("r10-predict-genome", _perturb_decoder),
    ("r10-predict-genome", _half_batch_predict),
    ("r9-train", _unchanged_state),
    ("r9-train", _half_batch_train),
    ("r9-train", _altered_loss),
])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(workload, seed=2**31 + 23)
    assert res["correct"] is False, res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", list(SMALL))
def test_a_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                           "--seed", str(2**31 + 24), "--seconds", "3", "--trace", "0"],
                          capture_output=True, text=True, cwd=core.ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "r9-train",
                           "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                          cwd=core.ROOT, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
