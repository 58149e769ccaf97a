"""The port's span recorder (seq2squiggle_tpu_torch/tracing.py) and the spans
of the predict run loop, the samplers and the train step, on the CPU.

Bars:
  - the recorder: a span's parent is the span open around it on its own
    thread, never one on another thread; totals count every span, the ring
    only the last RING; with the switch off nothing is recorded;
  - simulate_run with SEQ2SQUIGGLE_TPU_TIMERS=1: every per-batch span once a
    batch with ids 0..n-1 (the launching thread's `dispatch` and its input
    wait once more, id n: the wait for the end of the batches); the
    writer's `write` a flush, ids 0.., the first during the loop (the
    counters `export.behind_samples` and `export.final_samples` sum to the
    job's samples); the timers keep their keys and are numbers; the `dispatch` spans cover the loop's
    wall to within 2 %; each wait and `dispatch_offcpu` lies in [0, wall];
  - under a CPU torch.profiler the spans are ranges among its events, on
    every thread, the job's set-up one of them; where the profiler records
    inputs, each range holds its span's id;
  - make_train_step: one `train.step` a call, ids its call count, with
    `train.masks` children at dropout 0.2 and none at dropout 0.
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import collections
import pathlib
import threading

import numpy as np
import pytest
import torch

from seq2squiggle_tpu_torch import prng, tracing
from seq2squiggle_tpu_torch.config import load_config
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.runtime import simulate as tsimulate
from seq2squiggle_tpu_torch.train import loop as tloop
from seq2squiggle_tpu_torch.train import optimizers as topt

ROOT = pathlib.Path(__file__).resolve().parents[1]
R10 = str(ROOT / "assets" / "bench-weights-R10.npz")
CPU = torch.device("cpu")
PER_BATCH = ("h2d", "dispatch.output_wait", "fetch.wait", "decode", "export")
# the timers simulate_run returned before its stages were spans
OLD_KEYS = ("d2h_wait", "decode", "decode_cpu", "export", "export_cpu", "dispatch",
            "dispatch_cpu", "h2d_cpu", "finalize", "process_cpu", "n_t2", "decode_t2",
            "event2_noise_dispatch", "event2_noise_wait", "event2_rebuild",
            "event2_rebuild_cpu", "writer_write", "writer_write_cpu", "slow5_prep_cpu",
            "slow5_encode_cpu", "slow5_fwrite_cpu")
NEW_KEYS = ("input_wait", "output_wait", "dispatch_offcpu", "sampling", "job_setup")


@pytest.fixture
def recorder(monkeypatch):
    """The switch on, the recorder empty; both restored afterwards."""
    monkeypatch.setenv(tracing.ENV, "1")
    tracing.switch_from_env()
    tracing.reset()
    yield tracing
    monkeypatch.delenv(tracing.ENV, raising=False)
    tracing.switch_from_env()
    tracing.reset()


def _by_name(records):
    out = collections.defaultdict(list)
    for r in records:
        out[r.name].append(r)
    return out


# ---- the recorder ----


def test_spans_nest_on_their_own_thread(recorder):
    ready, go = threading.Event(), threading.Event()

    def other():
        ready.set()
        go.wait(10)
        with tracing.span("other", 7):
            pass

    thread = threading.Thread(target=other, name="tracing-test")
    thread.start()
    with tracing.span("outer", 1, cpu=True):
        assert ready.wait(10)
        with tracing.span("inner", 2):
            go.set()  # the other thread's span opens while these are open
            thread.join(10)
    assert not thread.is_alive()
    rec = _by_name(tracing.records())
    outer, inner, other_rec = rec["outer"][0], rec["inner"][0], rec["other"][0]
    assert outer.parent is None and inner.parent == outer.seq
    assert other_rec.parent is None and other_rec.thread == "tracing-test" and other_rec.id == 7
    assert outer.thread == inner.thread == threading.current_thread().name
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert 0 <= outer.cpu_ns <= outer.end_ns - outer.start_ns and inner.cpu_ns is None
    assert not outer.profiled
    with tracing.span("after"):
        pass
    assert _by_name(tracing.records())["after"][0].parent is None


def test_totals_count_every_span_and_the_ring_keeps_the_last(recorder, monkeypatch):
    monkeypatch.setattr(tracing, "_ring", collections.deque(maxlen=4))
    before = tracing.totals()
    for i in range(10):
        with tracing.span("s", i, cpu=True) as s:
            tracing.count("c", 2)
        assert s.seconds > 0
    got = tracing.totals().minus(before)
    assert got.spans["s"][0] == 10 and got.counts == {"c": 20}
    assert got.wall("s") >= got.cpu("s") >= 0
    assert [r.id for r in tracing.records()] == [6, 7, 8, 9]
    assert got.wall("absent") == 0.0 == got.cpu("absent")


def test_nothing_is_recorded_with_the_switch_off(recorder, monkeypatch):
    monkeypatch.delenv(tracing.ENV)
    assert not tracing.switch_from_env()
    first = tracing.span("off", 1, cpu=True)
    with first as s:
        tracing.count("c")
    assert tracing.span("off") is first and s.seconds == 0.0
    assert tracing.records() == [] and tracing.totals().spans == {}
    assert tracing.totals().counts == {}


# ---- the predict run loop ----


def _write_fasta(path, n_reads, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n_reads):
            n = int(rng.integers(120, 900))
            fh.write(f">read{i}\n{''.join(rng.choice(list('ACGT'), n))}\n")
    return str(path)


def _predict(tmp_path, **over):
    fasta = _write_fasta(tmp_path / "in.fasta", 4, seed=4)
    kwargs = dict(
        config=load_config(None), saved_weights=R10, fasta=fasta, read_input=True, n=-1,
        r=400, c=-1, out=str(tmp_path / "out.blow5"), profile="dna-r10-prom",
        dwell_mean=None, dwell_std=0.0, noise_std=2.0, noise_sampling=True,
        duration_sampling=True, distr="expon", predict_batch_size=8,
        export_every_n_samples=1_000_000, seed=11, show_progress=False,
        wire_format="auto", device=CPU)
    return tsimulate.simulate_run(**(kwargs | over))


@pytest.fixture
def predicted(recorder, tmp_path):
    stats = _predict(tmp_path)
    return stats, _by_name(tracing.records())


def test_every_batch_has_its_spans(predicted):
    stats, rec = predicted
    n = -(-stats["chunks"] // 8)
    assert n >= 3 and sum(v for k, v in stats["timers"].items() if k.startswith("n_t")) == n
    for name in PER_BATCH:
        assert [r.id for r in rec[name]] == list(range(n)), name
    for name in ("dispatch", "dispatch.input_wait"):
        assert [r.id for r in rec[name]] == list(range(n + 1)), name
    writes = [r.id for r in rec["write"]]
    assert writes == list(range(len(writes))) and 1 <= len(writes) <= n + 1
    assert {r.thread for r in rec["write"]} == {"seq2squiggle-export"}
    behind = stats["timers"]["export.behind_samples"]
    assert 0 < behind <= behind + stats["timers"].get("export.final_samples", 0) == stats["samples"]
    for name in ("job.setup", "h2d.loop", "dispatch.loop", "finalize"):
        assert len(rec[name]) == 1, name
    assert len(rec["sampling"]) == n  # one Gamma draw a batch, noise on the host
    dispatch = {r.seq: r for r in rec["dispatch"]}
    for name in ("dispatch.input_wait", "dispatch.output_wait", "sampling"):
        assert all(r.parent in dispatch for r in rec[name]), name
    assert {r.thread for r in rec["decode"]} == {"seq2squiggle-decode"}
    assert {r.thread for r in rec["h2d"]} == {"seq2squiggle-h2d"}


def test_timers_are_numbers_made_of_the_spans(predicted):
    stats, rec = predicted
    timers = stats["timers"]
    missing = set(OLD_KEYS + NEW_KEYS) - set(timers)
    assert not missing, missing
    for key, v in timers.items():
        assert isinstance(v, (int, float)) and float(v) >= 0, key
    loop = timers["dispatch"]
    batches = sum(r.seconds for r in rec["dispatch"])
    assert batches == pytest.approx(loop, rel=0.02)
    for key in ("input_wait", "output_wait", "dispatch_offcpu"):
        assert 0 <= timers[key] <= batches, key
    assert timers["sampling"] == pytest.approx(sum(r.seconds for r in rec["sampling"]))
    assert timers["job_setup"] == pytest.approx(rec["job.setup"][0].seconds)
    assert timers["d2h_wait"] == pytest.approx(sum(r.seconds for r in rec["fetch.wait"]))


def test_a_job_reads_only_its_own_spans(recorder, tmp_path):
    batches = [sum(v for k, v in _predict(tmp_path)["timers"].items() if k.startswith("n_t"))
               for _ in range(2)]
    assert batches[0] == batches[1] >= 3
    assert len(_by_name(tracing.records())["job.setup"]) == 2


def _profiled_ranges(tmp_path, **settings):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], **settings) as prof:
        stats = _predict(tmp_path)
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        ranges[e.name()].append(e)
    return -(-stats["chunks"] // 8), ranges


def test_spans_are_profiler_ranges_on_every_thread(recorder, tmp_path):
    n, ranges = _profiled_ranges(tmp_path, experimental_config=torch._C._profiler.
                                 _ExperimentalConfig(profile_all_threads=True))
    assert len(ranges["job.setup"]) == 1 and len(ranges["dispatch"]) == n + 1
    for name in PER_BATCH:
        assert len(ranges[name]) == n, name
    threads = {name: {e.start_thread_id() for e in ranges[name]} for name in PER_BATCH}
    assert len(set().union(*threads.values())) == 4  # h2d, dispatch, fetch, decode
    assert all(r.profiled for r in tracing.records())


def test_a_profiler_that_records_inputs_shows_the_ids(recorder, tmp_path):
    n, ranges = _profiled_ranges(tmp_path, record_shapes=True)  # this thread's ops
    assert [e.kwinputs()["id"] for e in ranges["dispatch"]] == list(range(n + 1))
    assert [e.kwinputs()["id"] for e in ranges["dispatch.output_wait"]] == list(range(n))


# ---- the train step ----


def _train_batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    K, k, T = cfg["max_dna_len"], cfg["seq_kmer"], cfg["max_signal_len"]
    lengths = rng.integers(0, 6, (B, K)).astype(np.int32)
    batch = {
        "chunks": np.eye(5, dtype=np.float32)[rng.integers(0, 5, (B, K, k))],
        "targets": rng.random((B, T, 1)).astype(np.float32),
        "chunks_lengths": lengths,
        "targets_lengths": lengths.sum(1).astype(np.int32),
        "stdevs": (rng.random((B, K)) * 0.1).astype(np.float32),
    }
    return {key: torch.from_numpy(v) for key, v in batch.items()}, torch.ones(B)


@pytest.mark.parametrize("dropout", [0.2, 0.0])
def test_each_train_step_is_a_span_with_its_mask_draws(recorder, dropout):
    cfg = load_config(None)
    cfg.update(compute_dtype="float32", encoder_layers=1, decoder_layers=1,
               pallas_train="block", encoder_dropout=dropout, decoder_dropout=dropout,
               duration_dropout=dropout)
    params = tmodel.to_train_params(tmodel.init_params(cfg, prng.key(2)), CPU)
    optimizer = topt.build_optimizer(cfg, 10)
    state = optimizer.init([v for _, v in tmodel.tree_leaves(params)])
    step = tloop.make_train_step(cfg, optimizer)
    for i in range(3):
        batch, mask = _train_batch(cfg, 4, seed=i)
        step(params, state, batch, mask, prng.fold_in(prng.key(1), i))
    rec = _by_name(tracing.records())
    steps = rec["train.step"]
    assert [r.id for r in steps] == [0, 1, 2] and not any(r.profiled for r in steps)
    masks = collections.Counter(r.parent for r in rec["train.masks"])
    if dropout:
        assert set(masks) == {r.seq for r in steps} and len(set(masks.values())) == 1
    else:
        assert not masks
