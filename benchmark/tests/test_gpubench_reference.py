"""The plain reference against the program's CPU path at a tiny size. The
test imports both; the reference imports nothing of the program."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.harness import synth
from benchmark.reference import model, predict_ref, threefry, train_ref

ROOT = pathlib.Path(__file__).resolve().parents[2]

CFG = dict(max_dna_len=16, max_signal_len=250, dmodel=64, dff=256, allowed_chars="_ACGT",
           seq_kmer=9, pre_layers=1, encoder_layers=2, decoder_layers=2, encoder_heads=8,
           decoder_heads=8, encoder_dropout=0.2, decoder_dropout=0.2, duration_dropout=0.2,
           scaling_max_value=165.0, compute_dtype="float32", use_pallas="auto",
           pallas_train="auto", lr=5e-4, warmup_ratio=0.01, lr_schedule="warmup_cosine",
           gradient_clip_val=1.0, optimizer="Adam", weight_decay=0.0)


def test_threefry_draws_as_the_program_does():
    from seq2squiggle_tpu_torch import prng

    k = threefry.fold_in(threefry.key(2**31 + 77), torch.arange(5))
    pk = prng.fold_in(prng.key(2**31 + 77), torch.arange(5))
    assert torch.equal(k, pk)
    assert torch.equal(threefry.split(k, 3), prng.split(pk, 3))
    assert torch.equal(threefry.bits(k, (7, 3)), prng.random_bits(pk, (7, 3)))
    assert torch.equal(threefry.uniform(k, (100,), 1e-37, 1.0), prng.uniform(pk, (100,), 1e-37, 1.0))
    assert torch.equal(threefry.bernoulli(k, 0.8, (50,)), prng.bernoulli(pk, 0.8, (50,)))
    torch.testing.assert_close(threefry.normal(k, (1000,)), prng.normal(pk, (1000,)),
                               rtol=1e-5, atol=2e-6)  # erfinv: XLA's polynomial, ours float64


def test_gamma_as_the_program_draws_it():
    from seq2squiggle_tpu_torch.sampling import sample_gamma

    keys = threefry.fold_in(threefry.key(9), torch.arange(64))
    a = torch.linspace(0.3, 40.0, 64 * 16).reshape(64, 16)
    torch.testing.assert_close(threefry.gamma(keys, a), sample_gamma(keys, a), rtol=2e-5, atol=0)


@pytest.mark.parametrize("distr", ["expon", "gamma", "beta"])
def test_reads_and_chunks_as_the_program_draws_them(tmp_path, distr):
    from seq2squiggle_tpu_torch.io.reads import get_reads
    from seq2squiggle_tpu_torch.runtime.batcher import expand_windows, read_chunk_windows
    from benchmark.drivers.predict import write_genome

    fasta = tmp_path / "g.fa"
    write_genome(str(fasta), 2**31 + 3, 20000)
    theirs, _ = get_reads(str(fasta), False, 25, 2000, -1, dict(CFG), distr, 1234, "dna-r10-prom", 30)
    theirs = [s for s, _ in theirs]
    ours = predict_ref.sample_reads(predict_ref.read_genome(str(fasta)), 25, 2000, 1234, distr=distr)
    assert ours == theirs
    for read in ours[:5]:
        w, n = read_chunk_windows(read, 9, 16)
        assert np.array_equal(predict_ref.chunk_kmers(read, 9, 16), expand_windows(w, n, 9))


def _port_params(P):
    return synth.nest({k: v.clone() for k, v in P.items()})


def test_model_as_the_program_computes_it_at_float32():
    from seq2squiggle_tpu_torch.models import fft_model

    P = model.load_weights(str(ROOT / "assets" / "bench-weights-R10.npz"))
    tree = fft_model.to_device(_port_params(P), torch.device("cpu"), torch.float32)
    codes = torch.randint(0, 5, (4, 16, 9))
    x = model.one_hot(codes, 5)
    with torch.no_grad():
        enc, emb = fft_model.encoder_forward(tree, x, CFG)
        r_emb = model.embed(P, x, CFG, model.F32)
        torch.testing.assert_close(model.encode(P, r_emb, CFG, model.F32), enc, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(model.head(P, "noise_sampler", r_emb),
                                   fft_model.noise_head(tree, emb, CFG), rtol=1e-5, atol=1e-6)
        frames = torch.randn(4, 250, 64)
        torch.testing.assert_close(model.decode(P, frames, CFG, model.F32),
                                   fft_model.decoder_forward(tree, frames, CFG)[..., 0],
                                   rtol=1e-5, atol=1e-5)


def test_chunk_signals_match_the_program_raw_tier_at_float32():
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.runtime.predict import PredictKnobs, predict_step

    P = model.load_weights(str(ROOT / "assets" / "bench-weights-R10.npz"))
    tree = fft_model.to_device(_port_params(P), torch.device("cpu"), torch.float32)
    rng = np.random.default_rng(0)
    read = "".join(rng.choice(list("ACGT"), 16 * 40 + 8))
    codes = torch.from_numpy(predict_ref.chunk_kmers(read, 9, 16))
    B = codes.shape[0]
    ridx, coff = torch.full((B,), 3), torch.arange(B)
    run = dict(seed=2**31 + 9, noise_std=2.0, min_noise=0.0, min_duration=3,
               scaling_max_value=165.0, digitisation=2048, range=281.345551,
               offset_mean=-127.5655735)
    knobs = PredictKnobs(noise_std=2.0, digitisation=2048, signal_range=281.345551,
                         offset_mean=-127.5655735, wire_bits=16)
    with torch.no_grad():
        sig, cnt = predict_step(tree, codes, ridx.int(), coff.int(), prng.key(run["seed"]),
                                config=CFG, knobs=knobs)
        r_sig, r_cnt = predict_ref.chunk_signals(P, CFG, run, codes, ridx, coff)
    assert torch.equal(cnt.long(), r_cnt.long())
    valid = torch.arange(250)[None] < cnt[:, None]
    # the raw tier keeps the noise stdev unrounded; the reference rounds it
    # to quarter counts as the event tiers ship it: at most a count apart
    assert (sig.int() - r_sig.int()).abs()[valid].max() <= 1


def test_training_loss_and_gradients_match_the_program_at_float32():
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.train.loop import loss_fn

    cfg = dict(CFG, seq_kmer=6)
    P = model.load_weights(str(ROOT / "assets" / "bench-weights-R9.npz"))
    rng = np.random.default_rng(1)
    events = json.loads((ROOT / "benchmark" / "traffic" / "train-shuffled.json").read_text())["events"]
    one_hot, targets, dwell, stdev, _ = synth.make_chunks(rng, events, 8, cfg)
    batch = {"chunks": torch.from_numpy(one_hot.astype(np.float32)),
             "targets": torch.from_numpy(targets / 165.0)[..., None],
             "chunks_lengths": torch.from_numpy(dwell.astype(np.int32)),
             "stdevs": torch.from_numpy(stdev / 165.0)}
    mask = torch.ones(8)
    tree = fft_model.to_train_params(_port_params(P), torch.device("cpu"))
    paths, leaves = zip(*fft_model.tree_leaves(tree))
    want, _ = loss_fn(tree, batch, mask, cfg, prng.fold_in(prng.key(5), 2))
    grads = dict(zip(("/".join(p) for p in paths), torch.autograd.grad(want, leaves)))
    leaves_r = {k: v.clone().requires_grad_(True) for k, v in P.items()}
    got = train_ref.loss(leaves_r, batch, mask, cfg, threefry.fold_in(threefry.key(5), 2))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    g = dict(zip(leaves_r, torch.autograd.grad(got, list(leaves_r.values()))))
    for k in g:
        torch.testing.assert_close(g[k], grads[k], rtol=1e-3, atol=1e-6, msg=k)


def test_learning_rate_schedule_as_the_program_builds_it():
    from seq2squiggle_tpu_torch.train.optimizers import build_schedule

    sched = build_schedule(CFG, 3200)
    for c in (0, 1, 2, 31, 32, 33, 1000, 3199, 4000):
        assert train_ref.lr_at(CFG, 3200, c) == pytest.approx(sched(c), rel=1e-9, abs=1e-15)
