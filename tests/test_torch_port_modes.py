"""The rest of `predict`'s modes on the port (runtime/simulate.py on the CPU)
against seq2squiggle_tpu's simulate_run on the JAX CPU backend: POD5 output,
the R9 (k = 6) and RNA profiles, reference, coverage and whole-contig modes,
`-n` resampling, static dwell without noise, and streaming export. Each case
mirrors one of tests/test_e2e.py or tests/test_pod5.py with a FASTA written
into tmp_path from a numpy seed.

Bar, every case, float32: the same records in the same order (read IDs and
lengths equal) and int16 samples equal except |Δ| <= 1 on <= 0.1 % (the
predict_step float32 bar); POD5 files are compared through their decoded
reads. Runs without amplitude noise and sampled durations are held to equal
samples on all but 0.1 % as well (the decoder's float32 sums differ in order).
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import pathlib

import numpy as np
import pytest
import torch

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.io.pod5_native import read_pod5
from seq2squiggle_tpu.io.slow5 import read_slow5
from seq2squiggle_tpu.runtime.simulate import simulate_run as jax_simulate_run
from seq2squiggle_tpu_torch.io.pod5_native import read_pod5 as port_read_pod5
from seq2squiggle_tpu_torch.runtime.simulate import simulate_run

ROOT = pathlib.Path(__file__).resolve().parents[1]
R10 = str(ROOT / "assets" / "bench-weights-R10.npz")
R9 = str(ROOT / "assets" / "bench-weights-R9.npz")
SEED = 11


def _write_reads(path, n_reads=6, seed=2):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n_reads):
            n = int(rng.integers(120, 700))
            fh.write(f">read{i}\n{''.join(rng.choice(list('ACGT'), n))}\n")
    return str(path)


def _write_genome(path, n_bases, seed=3):
    rng = np.random.default_rng(seed)
    path.write_text(">contig\n" + "".join(rng.choice(list("ACGT"), n_bases)) + "\n")
    return str(path)


def _kwargs(fasta, out, **over):
    kw = dict(
        config=dict(load_config(None), compute_dtype="float32"),
        saved_weights=R10, fasta=fasta, read_input=True, n=-1, r=400, c=-1, out=str(out),
        profile="dna-r10-min", dwell_mean=None, dwell_std=0.0, noise_std=2.0,
        noise_sampling=True, duration_sampling=True, distr="expon",
        predict_batch_size=32, export_every_n_samples=1_000_000, seed=SEED,
        show_progress=False, wire_format="raw",
    )
    kw.update(over)
    return kw


def _records(path):
    """(attrs or run_info, [(read_id, signal)]) of a BLOW5/SLOW5 or POD5 file."""
    if str(path).endswith(".pod5"):
        data = read_pod5(str(path))
        return data["run_info"], [(r["read_id"], np.asarray(r["signal"])) for r in data["reads"]]
    attrs, recs = read_slow5(str(path))
    return attrs, [(r["read_id"], np.asarray(r["signal"])) for r in recs]


def _both(tmp_path, fasta, ext, **over):
    """Run both packages; returns (JAX stats, port stats, JAX file, port file)."""
    jout, tout = tmp_path / f"jax{ext}", tmp_path / f"port{ext}"
    jstats = jax_simulate_run(**_kwargs(fasta, jout, **over))
    tstats = simulate_run(**_kwargs(fasta, tout, **over), device=torch.device("cpu"))
    return jstats, tstats, jout, tout


def _hold(jout, tout, tstats):
    (jinfo, jrecs), (tinfo, trecs) = _records(jout), _records(tout)
    assert len(trecs) == len(jrecs) == tstats["reads"] > 0
    assert [rid for rid, _ in trecs] == [rid for rid, _ in jrecs]
    diffs = []
    for (_, js), (_, ts) in zip(jrecs, trecs):
        assert len(ts) == len(js) > 0
        diffs.append(np.abs(ts.astype(np.int64) - js.astype(np.int64)))
    d = np.concatenate(diffs)
    assert d.max() <= 1 and (d == 1).mean() <= 0.001
    assert tstats["samples"] == d.size
    return jinfo, tinfo, trecs


def test_pod5_output_matches_jax(tmp_path):
    """tests/test_pod5.py::test_e2e_pod5."""
    fasta = _write_reads(tmp_path / "reads.fasta")
    _, tstats, jout, tout = _both(tmp_path, fasta, ".pod5")
    jinfo, tinfo, trecs = _hold(jout, tout, tstats)
    assert len(trecs) == 6
    assert tinfo["sequencing_kit"] == jinfo["sequencing_kit"]
    assert tinfo["sample_rate"] == jinfo["sample_rate"]
    # the port's own reader reads the port's file to the same reads
    own = port_read_pod5(str(tout))
    assert [r["read_id"] for r in own["reads"]] == [rid for rid, _ in trecs]
    for r, (_, sig) in zip(own["reads"], trecs):
        np.testing.assert_array_equal(r["signal"], sig)
        assert r["num_samples"] == len(sig) > 0


def test_r9_profile_pod5_matches_jax(tmp_path):
    """tests/test_e2e.py::test_e2e_r9_profile_pod5: the k = 6 model, normal
    dwell jitter, POD5 out."""
    fasta = _write_reads(tmp_path / "reads.fasta", seed=4)
    _, tstats, jout, tout = _both(tmp_path, fasta, ".pod5", saved_weights=R9,
                                  profile="dna-r9-min", dwell_std=1.5,
                                  duration_sampling=False)
    _, tinfo, trecs = _hold(jout, tout, tstats)
    assert len(trecs) == 6
    assert tinfo["sequencing_kit"] == "SQK-LSK109"


def test_rna_profile_matches_jax(tmp_path):
    """tests/test_e2e.py::test_e2e_rna_profile (random weights, as there)."""
    fasta = _write_reads(tmp_path / "reads.fasta", seed=5)
    _, tstats, jout, tout = _both(tmp_path, fasta, ".slow5", saved_weights="random",
                                  profile="rna-004-min")
    _, tattrs, trecs = _hold(jout, tout, tstats)
    assert tattrs["experiment_type"] == "rna"
    assert len(trecs) == 6


def test_reference_mode_slow5_matches_jax(tmp_path):
    """tests/test_e2e.py::test_e2e_reference_mode: -n reads drawn from a genome."""
    fasta = _write_genome(tmp_path / "genome.fasta", 6000)
    _, tstats, jout, tout = _both(tmp_path, fasta, ".slow5", read_input=False, n=5, r=500)
    assert len(_hold(jout, tout, tstats)[2]) == 5


def test_coverage_mode_matches_jax(tmp_path):
    """tests/test_e2e.py::test_e2e_coverage_mode: -c 2 over a 12 kb genome at
    r = 1000 is about 24 reads."""
    fasta = _write_genome(tmp_path / "genome.fasta", 12_000)
    _, tstats, jout, tout = _both(tmp_path, fasta, ".blow5", read_input=False, n=-1, c=2,
                                  r=1000)
    assert 15 <= len(_hold(jout, tout, tstats)[2]) <= 30


def test_whole_contig_mode_matches_jax(tmp_path):
    """tests/test_e2e.py::test_e2e_whole_contig_mode: -r 0 with -n, each read
    one full contig; static dwell 4, no noise."""
    n_bases = 3000
    fasta = _write_genome(tmp_path / "genome.fasta", n_bases)
    jstats, tstats, jout, tout = _both(tmp_path, fasta, ".slow5", read_input=False, n=2, r=0,
                                       duration_sampling=False, dwell_mean=4.0, noise_std=0.0)
    assert len(_hold(jout, tout, tstats)[2]) == 2
    # 3000 bp -> 2992 9-mers -> ceil(/16) = 187 chunks per read
    assert tstats["chunks"] == jstats["chunks"] == 2 * -(-(n_bases - 8) // 16)


def test_read_mode_resampling_matches_jax(tmp_path):
    """tests/test_e2e.py::test_e2e_read_mode_resampling: -n 12 from 6 reads."""
    fasta = _write_reads(tmp_path / "reads.fasta", seed=6)
    _, tstats, jout, tout = _both(tmp_path, fasta, ".slow5", n=12)
    assert len(_hold(jout, tout, tstats)[2]) == 12


def test_static_dwell_no_noise_matches_jax(tmp_path):
    """tests/test_e2e.py::test_e2e_static_dwell_no_noise: ideal mode."""
    fasta = _write_reads(tmp_path / "reads.fasta", seed=7)
    _, tstats, jout, tout = _both(tmp_path, fasta, ".slow5", duration_sampling=False,
                                  noise_std=0.0, dwell_mean=10.0)
    _, _, trecs = _hold(jout, tout, tstats)
    assert len(trecs) == 6
    # 16 k-mers at dwell 10: at most 160 samples per chunk
    assert tstats["samples"] <= 160 * tstats["chunks"]


@pytest.mark.parametrize("ext", [".blow5", ".pod5"])
def test_streaming_export_matches_single_flush(tmp_path, ext):
    """tests/test_e2e.py::test_e2e_streaming_export_matches_single_flush: a
    tiny export threshold (many flushes through the writer thread) writes the
    records of one big flush; the big flush is held against the JAX package."""
    fasta = _write_reads(tmp_path / "reads.fasta", seed=8)
    _, tstats, jout, tout = _both(tmp_path, fasta, ext)
    _, _, one = _hold(jout, tout, tstats)
    many_out = tmp_path / f"many{ext}"
    simulate_run(**_kwargs(fasta, many_out, export_every_n_samples=4),
                 device=torch.device("cpu"))
    _, many = _records(many_out)
    assert [rid for rid, _ in many] == [rid for rid, _ in one]
    for (_, a), (_, b) in zip(one, many):
        np.testing.assert_array_equal(a, b)
