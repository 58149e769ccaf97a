"""The port's `preprocess`, `standardize-events`, `sweep` and `version`
against the JAX package's on the CPU, and its command line against the JAX
package's, option by option.

Bars:
  - preprocess and standardize-events: the same files, byte for byte;
  - sweep (grid, random, halving; count 2, seed 4, a one-block f32 model):
    the same trial parameters in the same order, result rows with the same
    keys, each trial's valid_total_loss within rtol 1e-3 of the JAX
    package's (the JAX package's trials are memoised by config and seed:
    with seed 4 the random search draws the grid's two points, and halving
    starts from the random search's, so its three runs cover the nine trials);
  - version: exit code 0 and the torch version, with no GPU;
  - the command line: the same commands, and every option's flags and
    default equal, the port's hidden `--device` aside (this pins C12, the
    default of `train --save_valid_plots`).
"""

from __future__ import annotations

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import json
import logging
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from seq2squiggle_tpu import cli as jcli
from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.tools import standardize_events as jstd
from seq2squiggle_tpu.train import loop as jloop
from seq2squiggle_tpu.train import preprocess as jpre
from seq2squiggle_tpu.train import sweep as jsweep
from seq2squiggle_tpu_torch import cli as tcli
from seq2squiggle_tpu_torch.tools import standardize_events as tstd
from seq2squiggle_tpu_torch.train import preprocess as tpre

ROOT = pathlib.Path(__file__).resolve().parents[1]
SWEEP_SEED = 4


def _files(directory) -> dict:
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(directory).iterdir())}


@pytest.fixture(scope="module")
def events_tsv(tmp_path_factory):
    """An uncalled4-style events.tsv of three reads."""
    import pandas as pd
    from test_preprocess import make_events

    path = tmp_path_factory.mktemp("events") / "events.tsv"
    df = pd.concat([make_events(40 * 16, seed=i, read_name=f"read{i}", start_pos=100 * i)
                    for i in range(3)])
    df.to_csv(path, sep="\t", index=False)
    return str(path)


# ---------------------------------------------------------------------------
# preprocess and standardize-events
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batches,chunksize,partition_by,rna", [
    (True, 700, False, False), (False, 10_000_000, False, False),
    (True, 10_000_000, True, False), (True, 700, False, True)])
def test_preprocess_run_writes_the_jax_packages_files(events_tsv, tmp_path, batches,
                                                      chunksize, partition_by, rna):
    cfg = load_config(None)
    for which, run in (("jax", jpre.preprocess_run), ("port", tpre.preprocess_run)):
        np.random.seed(3)  # the shuffle draws from the global generator
        run(events_path=events_tsv, outdir=str(tmp_path / which), batches=batches,
            chunksize=chunksize, partition_by=partition_by, rna=rna, config=dict(cfg))
    want = _files(tmp_path / "jax")
    assert len(want) >= 5 and _files(tmp_path / "port") == want


def test_preprocess_command_writes_the_jax_packages_files(events_tsv, tmp_path, monkeypatch):
    # the JAX command turns on jax's persistent compile cache, which would
    # outlive this test in the worker; the files do not depend on it
    monkeypatch.setattr(jcli, "enable_compile_cache", lambda: None)
    for which, group in (("jax", jcli.main), ("port", tcli.main)):
        res = CliRunner().invoke(group, ["preprocess", events_tsv, str(tmp_path / which),
                                         "--chunksize", "900", "-s", "5"])
        assert res.exit_code == 0, (which, res.output, res.exception)
    want = _files(tmp_path / "jax")
    assert any(name.startswith("chunks-0001") for name in want)
    assert _files(tmp_path / "port") == want


@pytest.fixture()
def normalised_events(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(0)
    rows, pos = [], 0
    for i in range(30):
        n = int(rng.integers(2, 100))  # some events exceed filter_length=70
        rows.append(dict(read_name="r", position=i, model_kmer="ACGTACGTA", start_idx=pos,
                         end_idx=pos + n, event_stdv=1.0,
                         samples=",".join(map(str, rng.normal(0, 1, n).round(4)))))
        pos += n
    path = tmp_path / "events.tsv"
    pd.DataFrame(rows).to_csv(path, sep="\t", index=False)
    sigtk = tmp_path / "sigtk.txt"
    sigtk.write_text("read1 x 91.25 y z 12.5 rest\n")
    return path, sigtk


def test_standardize_events_writes_the_jax_tools_file(normalised_events, tmp_path):
    path, sigtk = normalised_events
    assert tstd.parse_sigtk_file(str(sigtk)) == jstd.parse_sigtk_file(str(sigtk))
    for mod in (jstd, tstd):
        mod.standardize_and_write_chunks(str(path), str(tmp_path / f"{mod.__name__}.tsv"), 7,
                                         91.25, 12.5, filter_length=70)
    want = (tmp_path / f"{jstd.__name__}.tsv").read_bytes()
    assert want.count(b"\n") > 10 and (tmp_path / f"{tstd.__name__}.tsv").read_bytes() == want

    # the port's module runs as a script, as the JAX package's console entry
    out = tmp_path / "cli.tsv"
    proc = subprocess.run([sys.executable, "-m", "seq2squiggle_tpu_torch.tools.standardize_events",
                           str(path), str(out), "--sigtk", str(sigtk), "--chunk_size", "7"],
                          cwd=str(ROOT), capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert out.read_bytes() == want


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------

_JAX_TRIALS: dict = {}


def _memoised(real):
    def train_run(**kw):
        key = (json.dumps(kw["config"], sort_keys=True, default=str), kw["seed"],
               kw["train_dir"], kw["valid_dir"], kw["save_valid_plots"])
        if key not in _JAX_TRIALS:
            _JAX_TRIALS[key] = real(**kw)
        return dict(_JAX_TRIALS[key])

    return train_run


@pytest.fixture(scope="module")
def sweep_data(tmp_path_factory):
    from test_preprocess import make_events

    root = tmp_path_factory.mktemp("sweep")
    cfg = load_config(None)
    for name, n_files, per_file in (("train", 2, 12), ("valid", 1, 2)):
        for i in range(n_files):
            df = make_events(per_file * 16, seed=20 + i + 10 * (name == "valid"),
                             read_name=f"{name}{i}")
            jpre.save_chunkset(jpre.build_chunkset(df, cfg, rna=False, partition_by=False),
                               str(root / name), i)
    config = dict(cfg, compute_dtype="float32", train_batch_size=8, max_epochs=1,
                  warmup_ratio=0.1, encoder_layers=1, decoder_layers=1)
    (root / "cfg.yaml").write_text(yaml.safe_dump(config))
    return root


def _space(root, which, method):
    space = {"train_dir": str(root / "train"), "valid_dir": str(root / "valid"),
             "method": method,
             "parameters": {"lr": {"values": [1e-3, 3e-3]}, "dff": {"value": 256}}}
    path = root / which / method / "sweep.yaml"
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(space))
    return path


def _rows(space_path):
    path = space_path.parent / "sweep_results.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("method,n_trials", [("grid", 2), ("random", 2), ("halving", 3)])
def test_sweep_proposes_and_scores_the_jax_packages_trials(sweep_data, tmp_path, monkeypatch,
                                                           method, n_trials):
    monkeypatch.chdir(tmp_path)  # train_run without a model path writes ./logs-<name>/
    monkeypatch.setattr(jloop, "train_run", _memoised(jloop.train_run))
    config = load_config(str(sweep_data / "cfg.yaml"))
    jspace = _space(sweep_data, "jax", method)
    jsweep.sweep_run(str(jspace), count=2, config=config, seed=SWEEP_SEED)
    tspace = _space(sweep_data, "port", method)
    res = CliRunner().invoke(tcli.main, ["sweep", "--sweep-id", str(tspace), "--count", "2",
                                         "-y", str(sweep_data / "cfg.yaml"),
                                         "-s", str(SWEEP_SEED), "--device", "cpu"])
    assert res.exit_code == 0, (res.output, res.exception)

    want, got = _rows(jspace), _rows(tspace)
    assert len(got) == len(want) == n_trials
    assert [r["params"] for r in got] == [r["params"] for r in want]
    if method != "halving":
        assert [r["params"]["lr"] for r in got] == [1e-3, 3e-3]
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["metrics"].keys() == w["metrics"].keys()
        assert {k: v for k, v in g.items() if k not in ("params", "metrics")} == \
            {k: v for k, v in w.items() if k not in ("params", "metrics")}
        np.testing.assert_allclose(g["metrics"]["valid_total_loss"],
                                   w["metrics"]["valid_total_loss"], rtol=1e-3)


# ---------------------------------------------------------------------------
# version and the command line
# ---------------------------------------------------------------------------


def test_version_reports_torch_without_a_gpu(caplog):
    caplog.set_level(logging.INFO, logger="seq2squiggle_tpu_torch")
    res = CliRunner().invoke(tcli.main, ["version"])
    assert res.exit_code == 0, (res.output, res.exception)
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert f"torch: {torch.__version__}" in text
    for name in ("seq2squiggle-tpu (PyTorch port): ", "CUDA: ", "numpy: ", "pyarrow: ",
                 "zstandard: ", "devices: "):
        assert name in text, name
    if not torch.cuda.is_available():
        assert "devices: no CUDA device" in text


def test_the_commands_are_the_jax_packages():
    assert sorted(tcli.main.commands) == sorted(jcli.main.commands) == [
        "predict", "preprocess", "sweep", "train", "version"]


def _options(command, skip=()):
    return {p.name: (sorted(p.opts), p.default) for p in command.params if p.name not in skip}


@pytest.mark.parametrize("name", ["predict", "preprocess", "sweep", "train", "version"])
def test_every_option_and_default_is_the_jax_packages(name):
    port = tcli.main.commands[name]
    assert ("device" in {p.name for p in port.params}) == (name in ("predict", "train", "sweep"))
    assert _options(port, skip=("device",)) == _options(jcli.main.commands[name])
    if name == "train":
        assert _options(port)["save_valid_plots"][1] is True  # C12
