"""The inputs the benchmark makes repeat for a seed and differ across seeds;
the weights files fit the program; the BLOW5 reader reads what the program
writes."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.drivers import predict as predict_driver
from benchmark.harness import slow5_reader, synth

ROOT = pathlib.Path(__file__).resolve().parents[2]

EVENTS = json.loads((ROOT / "benchmark" / "traffic" / "train-shuffled.json").read_text())["events"]
CFG = dict(max_dna_len=16, max_signal_len=250, dmodel=64, dff=256, allowed_chars="_ACGT",
           seq_kmer=6, pre_layers=1, encoder_layers=2, decoder_layers=2, max_chunks_train=0)


def test_genome_repeats_for_a_seed(tmp_path):
    paths = [tmp_path / n for n in ("a.fa", "b.fa", "c.fa")]
    predict_driver.write_genome(str(paths[0]), 2**31 + 5, 1000)
    predict_driver.write_genome(str(paths[1]), 2**31 + 5, 1000)
    predict_driver.write_genome(str(paths[2]), 2**31 + 6, 1000)
    a, b, c = (p.read_bytes() for p in paths)
    assert a == b != c
    seq = a.split(b"\n")[1]
    assert len(seq) == 1000 and set(seq) <= set(b"ACGT")


def test_derived_seeds():
    s = [predict_driver.derived_seed(2**31 + 11, j) for j in range(50)]
    assert s == [predict_driver.derived_seed(2**31 + 11, j) for j in range(50)]
    assert len(set(s)) == 50 and all(0 <= x < 2**31 for x in s)
    assert s[0] != predict_driver.derived_seed(2**31 + 12, 0)


def test_chunk_files_repeat_for_a_seed(tmp_path):
    a = synth.write_chunk_files(str(tmp_path / "a"), 7, 256, 2, CFG, EVENTS)
    b = synth.write_chunk_files(str(tmp_path / "b"), 7, 256, 2, CFG, EVENTS)
    c = synth.write_chunk_files(str(tmp_path / "c"), 8, 256, 2, CFG, EVENTS)
    for kind in a["files"]:
        for pa, pb, pc in zip(a["files"][kind], b["files"][kind], c["files"][kind]):
            xa, xb, xc = np.load(pa), np.load(pb), np.load(pc)
            assert np.array_equal(xa, xb) and not np.array_equal(xa, xc)
    dwell = np.load(a["files"]["chunks_lengths"][0])
    t_len = np.load(a["files"]["targets_lengths"][0])
    assert dwell.min() >= 1 and np.array_equal(t_len, dwell.sum(1))
    assert 8 < dwell.mean() < 12  # Gamma(4) about the model's mean dwell of 10
    one_hot = np.load(a["files"]["chunks"][0])
    assert one_hot.shape == (128, 16, 6, 5) and np.all(one_hot.sum(-1) == 1)
    assert np.all(one_hot[..., 0] == 0)  # no '_' in a drawn k-mer


def test_chunk_files_are_what_the_program_loads(tmp_path):
    from seq2squiggle_tpu_torch.train.data import ChunkDataset

    made = synth.write_chunk_files(str(tmp_path), 3, 256, 2, CFG, EVENTS)
    ds = ChunkDataset(made["files"], 0, dict(CFG, scaling_max_value=165.0))
    batch = ds.get_batch(np.arange(8))
    assert len(ds) == 256 and batch["chunks"].shape == (8, 16, 6, 5)


@pytest.mark.parametrize("path,k", [("assets/bench-weights-R10.npz", 9),
                                    ("assets/bench-weights-R9.npz", 6)])
def test_weights_files_fit_the_program_tree(path, k):
    """The configurations' weights files hold every leaf of the program's
    tree at its shape, and the nested layout round-trips."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.models.fft_model import init_params

    from benchmark.reference.model import load_weights

    ours = load_weights(str(ROOT / path))
    theirs = synth.flatten(init_params(dict(CFG, seq_kmer=k), prng.key(1)))
    assert ours.keys() == theirs.keys()
    assert all(ours[n].shape == theirs[n].shape for n in ours)
    assert synth.flatten(synth.nest(ours)).keys() == ours.keys()


@pytest.mark.parametrize("press", ["zstd", "zlib", "none"])
def test_blow5_reader_reads_the_program_writer(tmp_path, press):
    pytest.importorskip("zstandard") if press == "zstd" else None
    from seq2squiggle_tpu_torch.io.slow5 import read_slow5
    from seq2squiggle_tpu_torch.io.writers import BLOW5Writer
    from seq2squiggle_tpu_torch.profiles import get_profile

    out = tmp_path / "x.blow5"
    w = BLOW5Writer(str(out), get_profile("dna-r10-prom"), False, "dna-r10-prom", False,
                    np.random.default_rng(0), slow5_press=press)
    rng = np.random.default_rng(1)
    sigs = {f"r{i}": rng.integers(-3000, 3000, 50 + 37 * i).astype(np.int16) for i in range(5)}
    w.write_batch(sigs)
    w.close()
    ours = list(slow5_reader.read_blow5(str(out)))
    theirs = read_slow5(str(out))[1]
    assert [r for r, _ in ours] == [r["read_id"] for r in theirs]
    assert all(np.array_equal(s, r["signal"]) for (_, s), r in zip(ours, theirs))
    assert [slow5_reader.read_index(r) for r, _ in ours] == list(range(5))


def test_chunk_levels_follow_the_pore_model():
    """An event's samples lie about its table's level: 85 pA plus the
    per-(position, base) terms of its k-mer, with the event's stdev."""
    rng = np.random.default_rng(5)
    one_hot, targets, dwell, stdev, _ = synth.make_chunks(rng, EVENTS, 64, CFG)
    means = [np.asarray(t["level"]) for t in EVENTS["tables"]]
    codes = one_hot.argmax(-1) - 1
    row, ev = 3, 2
    start = int(dwell[row, :ev].sum())
    got = targets[row, start:start + dwell[row, ev]].mean()
    levels = [85.0 + m[np.arange(6), codes[row, ev]].sum() for m in means]
    assert min(abs(got - lv) for lv in levels) < 4 * stdev[row, ev]
    assert 1.2 <= stdev.min() and stdev.max() <= 2.6
