"""The port's `predict` end to end on the CPU: runtime/simulate.py and the
CLI, against seq2squiggle_tpu's simulate_run (raw wire format) on the JAX CPU
backend, plus the guarantees around the device and the imports.

Bar for the end-to-end comparison: the same read IDs and record count, every
read the same length, and int16 samples equal except |Δ| <= 1 on <= 0.1 %
(the predict_step float32 bar).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.io.slow5 import read_slow5
from seq2squiggle_tpu.runtime.simulate import simulate_run as jax_simulate_run
from seq2squiggle_tpu_torch import cli
from seq2squiggle_tpu_torch.device import resolve_device
from seq2squiggle_tpu_torch.runtime.simulate import simulate_run

ROOT = pathlib.Path(__file__).resolve().parents[1]
R10 = str(ROOT / "assets" / "bench-weights-R10.npz")


def _write_fasta(path, n_reads, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n_reads):
            n = int(rng.integers(120, 700))
            fh.write(f">read{i}\n{''.join(rng.choice(list('ACGT'), n))}\n")
    return str(path)


def _run_kwargs(fasta, out, read_input):
    return dict(
        config=dict(load_config(None), compute_dtype="float32"),
        saved_weights=R10, fasta=fasta, read_input=read_input,
        n=-1 if read_input else 5, r=400, c=-1, out=str(out),
        profile="dna-r10-prom", dwell_mean=None, dwell_std=0.0, noise_std=2.0,
        noise_sampling=True, duration_sampling=True, distr="expon",
        predict_batch_size=32, export_every_n_samples=1_000_000, seed=11,
        show_progress=False, wire_format="raw",
    )


@pytest.mark.parametrize("read_input", [True, False])
def test_simulate_run_matches_jax(tmp_path, read_input):
    fasta = _write_fasta(tmp_path / "in.fasta", 6, seed=2)
    jax_simulate_run(**_run_kwargs(fasta, tmp_path / "jax.blow5", read_input))
    stats = simulate_run(**_run_kwargs(fasta, tmp_path / "port.blow5", read_input),
                         device=torch.device("cpu"))
    _, jrecs = read_slow5(str(tmp_path / "jax.blow5"))
    _, trecs = read_slow5(str(tmp_path / "port.blow5"))
    assert len(trecs) == len(jrecs) == stats["reads"] > 0
    assert [r["read_id"] for r in trecs] == [r["read_id"] for r in jrecs]
    diffs = []
    for jr, tr in zip(jrecs, trecs):
        assert len(tr["signal"]) == len(jr["signal"]) > 0
        diffs.append(np.abs(tr["signal"].astype(np.int64) - jr["signal"]))
    d = np.concatenate(diffs)
    assert d.max() <= 1 and (d == 1).mean() <= 0.001
    assert stats["samples"] == d.size


def test_cli_predict_on_cpu_writes_readable_blow5(tmp_path):
    fasta = _write_fasta(tmp_path / "reads.fasta", 3, seed=4)
    out = tmp_path / "cli.blow5"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "seq2squiggle_tpu_torch", "predict", fasta,
         "--read-input", "-o", str(out), "-m", R10, "-s", "3", "--device", "cpu",
         "--predict-batch-size", "16", "-v", "warning"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    _, recs = read_slow5(str(out))
    assert len(recs) == 3
    assert all(len(r["signal"]) > 0 for r in recs)


def test_device_cuda_without_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    fasta = _write_fasta(tmp_path / "r.fasta", 1, seed=5)
    result = CliRunner().invoke(cli.main, [
        "predict", fasta, "--read-input", "-o", str(tmp_path / "o.blow5"),
        "-m", R10, "--device", "cuda"])
    assert result.exit_code != 0
    assert isinstance(result.exception, RuntimeError)
    assert not (tmp_path / "o.blow5").exists()
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_run(**_run_kwargs(fasta, tmp_path / "o.blow5", True),
                     device=torch.device("cuda"))
    assert not (tmp_path / "o.blow5").exists()


def test_resolve_device_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("override,pattern", [
    (dict(num_shards=2), "num-shards"),
    (dict(trace_dir="trace"), "trace-dir"),
    (dict(wire_format="8"), "wire-format"),
    (dict(out="x.pod5"), "POD5"),
])
def test_unported_options_raise(tmp_path, override, pattern):
    fasta = _write_fasta(tmp_path / "r.fasta", 1, seed=6)
    kw = _run_kwargs(fasta, tmp_path / "o.blow5", True)
    if "out" in override:
        override = dict(out=str(tmp_path / override["out"]))
    kw.update(override)
    with pytest.raises(NotImplementedError, match=pattern):
        simulate_run(**kw, device=torch.device("cpu"))


def test_port_never_imports_jax():
    """Import the port and run a tiny CPU predict_step in a fresh process
    (this test process has jax loaded by tests/conftest.py)."""
    code = "\n".join([
        "import sys, torch",
        "import seq2squiggle_tpu_torch",
        "import seq2squiggle_tpu_torch.cli, seq2squiggle_tpu_torch.runtime.simulate",
        "from seq2squiggle_tpu_torch.host import load_config, read_slow5",
        "from seq2squiggle_tpu_torch import prng",
        "from seq2squiggle_tpu_torch.models.fft_model import init_params, to_device",
        "from seq2squiggle_tpu_torch.runtime.predict import PredictKnobs, predict_step",
        "cfg = load_config(None)",
        "p = to_device(init_params(cfg, prng.key(0)), torch.device('cpu'), torch.bfloat16)",
        "codes = torch.randint(1, 5, (2, 24), dtype=torch.uint8)",
        "s, c = predict_step(p, codes, torch.tensor([0, 1]), torch.tensor([0, 0]),",
        "                    prng.key(1), config=cfg, knobs=PredictKnobs())",
        "assert s.shape == (2, 250) and c.shape == (2,)",
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))",
        "assert not bad, bad",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
