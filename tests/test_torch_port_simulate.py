"""The port's `predict` end to end on the CPU: runtime/simulate.py and the
CLI, against seq2squiggle_tpu's simulate_run (raw wire format) on the JAX CPU
backend, plus the guarantees around the device and the imports.

Bar for the end-to-end comparison: the same read IDs and record count, every
read the same length, and int16 samples equal except |Δ| <= 1 on <= 0.1 %
(the predict_step float32 bar).
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

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
    (dict(wire_format="ulp"), "wire-format"),
])
def test_unported_options_raise(tmp_path, override, pattern):
    """The four options that raised NotImplementedError until the packed wire
    formats, --num-shards and --trace-dir were ported (the name is kept):
    each now runs, against the raw unsharded run with the same arguments.
    Two shards' records, merged by read id, are that run's; --trace-dir
    writes a trace and the same records; 8-bit deltas the same records; the
    ULP tier (bf16 for both runs) the same reads and sample counts, every
    sample within 1 count and >= 90 % equal (its stdev field is in quarter
    counts)."""
    fasta = _write_fasta(tmp_path / "r.fasta", 3, seed=6)
    kw = _run_kwargs(fasta, tmp_path / "raw.blow5", True)
    if override.get("wire_format") == "ulp":
        kw["config"] = dict(kw["config"], compute_dtype="bfloat16")
    simulate_run(**kw, device=torch.device("cpu"))
    _, want = read_slow5(str(tmp_path / "raw.blow5"))
    if pattern == "num-shards":
        got = []
        for i in range(2):
            kw.update(out=str(tmp_path / f"s{i}.blow5"), num_shards=2, shard_index=i)
            simulate_run(**kw, device=torch.device("cpu"))
            got += read_slow5(str(tmp_path / f"s{i}.blow5"))[1]
        got.sort(key=lambda r: [w["read_id"] for w in want].index(r["read_id"]))
    else:
        if pattern == "trace-dir":
            override = dict(trace_dir=str(tmp_path / "trace"))
        kw.update(out=str(tmp_path / "o.blow5"), **override)
        stats = simulate_run(**kw, device=torch.device("cpu"))
        got = read_slow5(str(tmp_path / "o.blow5"))[1]
        assert stats["wire_bits"] == {"8": 8, "ulp": 2}.get(override.get("wire_format"), 16)
    if pattern == "trace-dir":
        assert any((tmp_path / "trace").glob("*.json"))
    assert [r["read_id"] for r in got] == [r["read_id"] for r in want] and len(got) == 3
    d = np.concatenate([np.abs(g["signal"].astype(np.int64) - w["signal"])
                        for g, w in zip(got, want)])
    assert all(len(g["signal"]) == len(w["signal"]) for g, w in zip(got, want))
    if override.get("wire_format") == "ulp":
        assert d.max() <= 1 and (d == 0).mean() >= 0.9
    else:
        assert d.max() == 0


def test_port_never_imports_jax(tmp_path):
    """Import the port, run a tiny CPU predict_step (then one through the
    fused blocks with `pallas_pair: true`), one CPU train step, a CPU
    `simulate_run` at --wire-format auto (bf16: the ULP tier, through
    runtime/wire.py and the C++ decoder) and a resume from a legacy
    train_state.pkl the JAX package wrote (jax arrays and optax states) in a
    fresh process (this test process has jax loaded by tests/conftest.py):
    neither jax nor any module of the JAX package may be loaded after that."""
    import pickle

    import jax
    import jax.numpy as jnp

    from seq2squiggle_tpu.models.fft_model import init_params as jinit_params
    from seq2squiggle_tpu.train.optimizers import build_optimizer as jbuild_optimizer

    jcfg = load_config(None)
    jparams = jinit_params(jcfg, jax.random.key(0))
    legacy = tmp_path / "train_state.pkl"
    with open(legacy, "wb") as fh:
        pickle.dump({"params": jparams, "epoch": 2,
                     "opt_state": jbuild_optimizer(jcfg, 10).init(jparams)}, fh)
    assert b"jax._src.array" in legacy.read_bytes()
    code = "\n".join([
        "import sys, numpy as np, torch",
        "import seq2squiggle_tpu_torch",
        "import seq2squiggle_tpu_torch.cli, seq2squiggle_tpu_torch.runtime.simulate",
        "from seq2squiggle_tpu_torch.config import load_config",
        "from seq2squiggle_tpu_torch.io.slow5 import read_slow5",
        "from seq2squiggle_tpu_torch import prng",
        "from seq2squiggle_tpu_torch.models.fft_model import (init_params, to_device,",
        "    to_train_params, tree_leaves)",
        "from seq2squiggle_tpu_torch.runtime.predict import PredictKnobs, predict_step",
        "from seq2squiggle_tpu_torch.train.loop import make_train_step",
        "from seq2squiggle_tpu_torch.train.optimizers import build_optimizer",
        "torch.manual_seed(0)",
        "cfg = load_config(None)",
        "host = init_params(cfg, prng.key(0))",
        "p = to_device(host, torch.device('cpu'), torch.bfloat16)",
        "codes = torch.randint(1, 5, (2, 24), dtype=torch.uint8)",
        "s, c = predict_step(p, codes, torch.tensor([0, 1]), torch.tensor([0, 0]),",
        "                    prng.key(1), config=cfg, knobs=PredictKnobs())",
        "assert s.shape == (2, 250) and c.shape == (2,)",
        "pair = dict(cfg, use_pallas=True, pallas_pair=True)",
        "s2, c2 = predict_step(p, codes, torch.tensor([0, 1]), torch.tensor([0, 0]),",
        "                      prng.key(1), config=pair, knobs=PredictKnobs())",
        "s3, c3 = predict_step(p, codes, torch.tensor([0, 1]), torch.tensor([0, 0]),",
        "                      prng.key(1), config=dict(pair, pallas_pair=False),",
        "                      knobs=PredictKnobs())",
        "assert s2.shape == (2, 250) and torch.equal(s2, s3) and torch.equal(c2, c3)",
        "cfg = dict(cfg, compute_dtype='float32', pallas_train='core', max_signal_len=40)",
        "tp = to_train_params(host, torch.device('cpu'))",
        "opt = build_optimizer(cfg, 10)",
        "state = opt.init([v for _, v in tree_leaves(tp)])",
        "batch = {'chunks': torch.eye(5)[torch.randint(0, 5, (2, 16, 9))],",
        "         'targets': torch.rand(2, 40, 1), 'stdevs': torch.rand(2, 16),",
        "         'chunks_lengths': torch.randint(0, 5, (2, 16), dtype=torch.int32)}",
        "m = make_train_step(cfg, opt)(tp, state, batch, torch.ones(2), prng.key(2))",
        "assert np.isfinite(float(m['total_loss'])) and state['count'] == 1",
        "import tempfile, pathlib",
        "from seq2squiggle_tpu_torch.runtime.simulate import simulate_run",
        "tmp = pathlib.Path(tempfile.mkdtemp())",
        "seq = ''.join(np.random.default_rng(0).choice(list('ACGT'), 600))",
        "(tmp / 'r.fasta').write_text('>r0\\n' + seq + '\\n')",
        "st = simulate_run(config=load_config(None), saved_weights='assets/bench-weights-R10.npz',",
        "    fasta=str(tmp / 'r.fasta'), read_input=True, n=-1, r=400, c=-1,",
        "    out=str(tmp / 'o.blow5'), profile='dna-r10-prom', dwell_mean=None,",
        "    dwell_std=0.0, noise_std=2.0, noise_sampling=True, duration_sampling=True,",
        "    distr='expon', predict_batch_size=32, export_every_n_samples=1_000_000,",
        "    show_progress=False, device=torch.device('cpu'))",
        "assert st['wire_bits'] == 2 and st['wire_decode'] == {'native': 2, 'numpy': 0}, st",
        "assert len(read_slow5(str(tmp / 'o.blow5'))[1]) == 1",
        "from seq2squiggle_tpu_torch.models.weights import params_from_jax",
        "from seq2squiggle_tpu_torch.train.loop import load_train_state",
        f"old = load_train_state({str(legacy)!r})",
        "opt = build_optimizer(load_config(None), 10)",
        "leaves = [v for _, v in tree_leaves(params_from_jax(old['params']))]",
        "restored = opt.restore_state(opt.init(leaves), old['opt_leaves'])",
        "assert old['epoch'] == 2 and restored['count'] == 0 and len(leaves) == 84",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',",
        "             'seq2squiggle_tpu'))",
        "assert not bad, bad",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
