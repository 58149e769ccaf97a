"""The predict run loop's host threads (runtime/simulate.py) and the per-shard
launching threads (runtime/predict.py::ShardLaunchers) on the CPU.

Bars:
  - the stage timers hold every key the JAX package's simulate_run returns
    for the same run (SEQ2SQUIGGLE_TPU_TIMERS=1);
  - seq2squiggle-h2d, -fetch and -decode are alive during a run, and no
    seq2squiggle-* thread it started is alive after it;
  - a run whose decode is slowed (so the queues fill) writes records equal
    to an unslowed run's, at auto and raw, and holds exactly as many batches
    in flight as its queues allow;
  - the step-down ladder and the ULP probe, with the decode slowed, meet
    tests/test_torch_port_wire.py's bars;
  - over [cpu] * 8 each shard launches from its own thread, the same one
    every batch, in inference mode; the records are bit-identical to one
    device's, and a --trace-dir trace holds those threads' ops;
  - a failure in any stage (the reads, the decoder, a shard's step, the
    writer, also on a flush handed to it during the loop) is raised by
    simulate_run with its type and message, and no thread is left behind;
    each case has a time limit of its own;
  - at the default export threshold BLOW5 and SLOW5 reads go to the writer
    during the loop (write-behind) and the file's bytes are those of one
    flush at the end; POD5 keeps that one flush.
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import datetime
import json
import pathlib
import queue
import threading
import time
import types

import numpy as np
import pytest
import torch

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.io.slow5 import read_slow5
from seq2squiggle_tpu.runtime.simulate import simulate_run as jax_simulate_run
from seq2squiggle_tpu_torch.io import writers as twriters
from seq2squiggle_tpu_torch.io.pod5_native import read_pod5 as port_read_pod5
from seq2squiggle_tpu_torch.runtime import exporter as texporter
from seq2squiggle_tpu_torch.runtime import predict as tpredict
from seq2squiggle_tpu_torch.runtime import simulate as tsimulate

ROOT = pathlib.Path(__file__).resolve().parents[1]
R10 = str(ROOT / "assets" / "bench-weights-R10.npz")
CPU = torch.device("cpu")
STAGES = ("seq2squiggle-h2d", "seq2squiggle-fetch", "seq2squiggle-decode")
SLOW_S = 0.15  # the slowed decode's sleep a batch: a CPU step takes ~50 ms
HOLD_S = 2.0  # the first batch's, with a count of the batches the decode starts
RUN_LIMIT_S = 120  # a run that takes longer has hung


def _write_fasta(path, n_reads, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n_reads):
            n = int(rng.integers(120, 900))
            fh.write(f">read{i}\n{''.join(rng.choice(list('ACGT'), n))}\n")
    return str(path)


def _run_kwargs(fasta, out, **over):
    return dict(
        config=dict(load_config(None), compute_dtype="float32"),
        saved_weights=R10, fasta=fasta, read_input=True, n=-1, r=400, c=-1, out=str(out),
        profile="dna-r10-prom", dwell_mean=None, dwell_std=0.0, noise_std=2.0,
        noise_sampling=True, duration_sampling=True, distr="expon",
        predict_batch_size=8, export_every_n_samples=1_000_000, seed=11,
        show_progress=False, wire_format="auto") | over


def _records(path):
    if str(path).endswith(".pod5"):
        return [(r["read_id"], np.asarray(r["signal"], np.int64))
                for r in port_read_pod5(str(path))["reads"]]
    return [(r["read_id"], r["signal"].astype(np.int64)) for r in read_slow5(str(path))[1]]


def _left_behind(before=()):
    """The seq2squiggle-* threads alive now that were not in `before`, the
    threads alive when the run started: a test of the JAX package that ran
    earlier in the same worker can leave its own `seq2squiggle-batch-prefetch`
    thread behind, which is not this run's."""
    return [t.name for t in threading.enumerate()
            if t.name.startswith("seq2squiggle-") and t not in before]


def _run(fasta, tmp_path, name, device=CPU, ext=".blow5", **over):
    """simulate_run in a thread of its own, held to RUN_LIMIT_S: a hang
    fails the test instead of stalling the suite. Returns (stats, records)."""
    out = tmp_path / f"{name}{ext}"
    result = {}

    def target():
        try:
            result["stats"] = tsimulate.simulate_run(**_run_kwargs(fasta, out, **over),
                                                     device=device)
        except BaseException as exc:  # raised again below, on the test's thread
            result["error"] = exc

    before = set(threading.enumerate())
    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(RUN_LIMIT_S)
    assert not thread.is_alive(), f"simulate_run still running after {RUN_LIMIT_S} s"
    assert not _left_behind(before), _left_behind(before)
    if "error" in result:
        raise result["error"]
    return result["stats"], _records(out)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    return _write_fasta(tmp_path_factory.mktemp("pipeline") / "in.fasta", 5, seed=4)


@pytest.fixture(scope="module")
def short_fasta(tmp_path_factory):
    """Two or three batches over several CPU shards, whose threads contend
    for the interpreter lock at every op."""
    return _write_fasta(tmp_path_factory.mktemp("short") / "in.fasta", 2, seed=4)


@pytest.fixture(scope="module")
def ref(fasta, tmp_path_factory):
    """The unslowed runs the cases compare with: auto and raw at f32 on one
    device, and the timers of the JAX package's auto run and the port's."""
    tmp = tmp_path_factory.mktemp("ref")
    runs = {fmt: _run(fasta, tmp, f"ref_{fmt}", wire_format=fmt) for fmt in ("auto", "raw")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEQ2SQUIGGLE_TPU_TIMERS", "1")
        jax_stats = jax_simulate_run(**_run_kwargs(fasta, tmp / "jax.blow5"))
        port_stats, _ = _run(fasta, tmp, "timed")
    return runs, jax_stats["timers"], port_stats["timers"]


def _slow_decode(mp, seen=None):
    """Slow the decode thread (which unframes every buffer first): its first
    batch waits HOLD_S, long enough for the dispatch loop to fill the queues
    behind it, and every batch SLOW_S. `seen` counts the buffers it starts."""
    unframe = tsimulate.unframe_wire

    def slow(*args, **kw):
        if seen is not None and threading.current_thread().name == "seq2squiggle-decode":
            seen.append(1)
        time.sleep(HOLD_S if seen == [1] else SLOW_S)
        return unframe(*args, **kw)

    mp.setattr(tsimulate, "unframe_wire", slow)


def _count_decode_takes(mp, taken):
    """Count each batch the decode thread takes off its queue, inside the
    queue's lock as the item leaves it: no stage can move into the freed
    slot before the count. (The end of the run, None, is not a batch.)"""

    class Counted(queue.Queue):
        def _get(self):
            item = super()._get()
            if item is not None and threading.current_thread().name == "seq2squiggle-decode":
                taken.append(1)
            return item

    mp.setattr(tsimulate, "queue", types.SimpleNamespace(
        Queue=Counted, Empty=queue.Empty, Full=queue.Full))


def _assert_equal(got, want):
    assert [r for r, _ in got] == [r for r, _ in want] and len(got) > 0
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_timers_hold_the_jax_packages_keys(ref):
    _, jax_timers, port_timers = ref
    missing = set(jax_timers) - set(port_timers)
    assert not missing, missing
    for key in ("h2d_cpu", "dispatch_cpu", "d2h_wait"):
        assert key in port_timers and port_timers[key] >= 0, key


def test_stage_threads_alive_during_a_run(fasta, ref, tmp_path, monkeypatch):
    seen = set()
    batches = tsimulate.iter_batches

    def watched(*args, **kw):
        for batch in batches(*args, **kw):
            seen.update(t.name for t in threading.enumerate())
            yield batch

    monkeypatch.setattr(tsimulate, "iter_batches", watched)
    _, recs = _run(fasta, tmp_path, "watched")
    assert set(STAGES) <= seen, seen
    _assert_equal(recs, ref[0]["auto"][1])


@pytest.mark.parametrize("wire_format", ["auto", "raw"])
def test_slowed_decode_writes_the_same_records(fasta, ref, tmp_path, monkeypatch, wire_format):
    """Queues cut to 1 and 2 batches, which fill while the decode holds its
    first batch: the dispatch loop then runs exactly as far ahead of the
    decode as the fetch and decode queues, the batch the fetch thread holds
    and the one it launches allow (2 * 2 + 2), and no further."""
    monkeypatch.setattr(tsimulate, "H2D_DEPTH", 1)
    monkeypatch.setattr(tsimulate, "PIPELINE_DEPTH", 2)
    decoded, ahead = [], []
    _slow_decode(monkeypatch, [])
    _count_decode_takes(monkeypatch, decoded)
    step = tsimulate.predict_step_sharded
    dispatched = [0]

    def counted(*args, **kw):
        dispatched[0] += 1
        ahead.append(dispatched[0] - len(decoded))
        return step(*args, **kw)

    monkeypatch.setattr(tsimulate, "predict_step_sharded", counted)
    stats, recs = _run(fasta, tmp_path, "slow", wire_format=wire_format)
    _assert_equal(recs, ref[0][wire_format][1])
    assert len(decoded) == len(ahead) == -(-stats["chunks"] // 8) > 6
    assert max(ahead) == 2 * 2 + 2, ahead
    assert stats["wire_bits"] == ref[0][wire_format][0]["wire_bits"]


def test_slowed_decode_ladder_matches_raw(fasta, tmp_path, monkeypatch, caplog):
    """test_step_down_ladder_matches_raw's regime with many batches in
    flight at 8 bits when the run steps down: three recompute warnings, the
    later 8-bit batches recompute silently, records equal to raw."""
    kw = dict(noise_std=20.0, config=load_config(None))
    _, raw = _run(fasta, tmp_path, "ladder_raw", wire_format="raw", **kw)
    _slow_decode(monkeypatch, [])
    with caplog.at_level("WARNING", logger="seq2squiggle_tpu_torch"):
        stats, got = _run(fasta, tmp_path, "ladder_8", wire_format="8", **kw)
    assert stats["wire_bits"] == 12
    assert "downgrading wire format to 12-bit deltas" in caplog.text
    assert caplog.text.count("recomputed this batch raw") == 3
    _assert_equal(got, raw)


def test_slowed_decode_ulp_probe_steps_down(fasta, tmp_path, monkeypatch, caplog):
    """test_ulp_probe_steps_small_batches_down's regime: the first batch's
    probe steps the run to the event tier while later ULP batches are in
    flight; counts equal raw's, samples within 1."""
    kw = dict(config=load_config(None), noise_std=0.0)
    _, raw = _run(fasta, tmp_path, "probe_raw", wire_format="raw", **kw)
    _slow_decode(monkeypatch, [])
    with caplog.at_level("INFO", logger="seq2squiggle_tpu_torch"):
        stats, got = _run(fasta, tmp_path, "probe_auto", **kw)
    assert "switching to the 4-bit event tier proactively" in caplog.text
    assert stats["wire_bits"] == 4 and stats["wire_decode"]["numpy"] == 0
    assert [r for r, _ in got] == [r for r, _ in raw]
    assert [len(s) for _, s in got] == [len(s) for _, s in raw]
    assert np.abs(np.concatenate([a - b for (_, a), (_, b) in zip(got, raw)])).max() <= 1


def _watch_shards(mp):
    """Record (thread name, thread ident, native id, inference mode) for
    every predict_step call."""
    calls = []
    step = tpredict.predict_step

    def watched(*args, **kw):
        thread = threading.current_thread()
        calls.append((thread.name, thread.ident, threading.get_native_id(),
                      torch.is_inference_mode_enabled()))
        return step(*args, **kw)

    mp.setattr(tpredict, "predict_step", watched)
    return calls


def test_each_shard_launches_from_its_own_thread(short_fasta, tmp_path, monkeypatch):
    one, one_recs = _run(short_fasta, tmp_path, "one", predict_batch_size=32)
    calls = _watch_shards(monkeypatch)
    stats, recs = _run(short_fasta, tmp_path, "eight", device=[CPU] * 8, predict_batch_size=32)
    assert (stats["dp_shards"], one["dp_shards"]) == (8, 1)
    _assert_equal(recs, one_recs)
    names = {f"seq2squiggle-shard{i}_0" for i in range(8)}
    assert {name for name, *_ in calls} == names
    assert all(inference for *_, inference in calls)
    idents = {name: {ident for n, ident, _, _ in calls if n == name} for name in names}
    assert all(len(ids) == 1 for ids in idents.values()), idents  # the same thread every batch
    assert len({ident for _, ident, _, _ in calls}) == 8
    assert len(calls) == 8 * -(-stats["chunks"] // 32) >= 16  # one a shard a batch


def test_trace_holds_the_shard_threads_ops(short_fasta, tmp_path, monkeypatch):
    calls = _watch_shards(monkeypatch)
    trace_dir = tmp_path / "trace"
    _run(short_fasta, tmp_path, "traced", device=[CPU] * 2, predict_batch_size=16,
         trace_dir=str(trace_dir))
    trace = json.loads(next(trace_dir.glob("*.json")).read_text())
    tids = {e.get("tid") for e in trace["traceEvents"] if str(e.get("name")).startswith("aten::")}
    shard_tids = {native for _, _, native, _ in calls}
    assert len(shard_tids) == 2 and shard_tids <= tids, (shard_tids, tids)


class Injected(Exception):
    pass


def _fail_iter_batches(mp):
    batches = tsimulate.iter_batches

    def failing(*args, **kw):
        for i, batch in enumerate(batches(*args, **kw)):
            if i == 2:
                raise Injected("the reads failed")
            yield batch

    mp.setattr(tsimulate, "iter_batches", failing)


def _fail_decoder(mp):
    unframe = tsimulate.unframe_wire
    n = [0]

    def failing(*args, **kw):
        n[0] += 1
        if n[0] == 2:
            raise Injected("the decoder failed")
        return unframe(*args, **kw)

    mp.setattr(tsimulate, "unframe_wire", failing)


def _fail_shard(mp):
    step = tpredict.predict_step
    n = [0]

    def failing(*args, **kw):
        if threading.current_thread().name == "seq2squiggle-shard3_0":
            n[0] += 1
            if n[0] == 2:
                raise Injected("shard 3 failed")
        return step(*args, **kw)

    mp.setattr(tpredict, "predict_step", failing)


def _fail_writer(mp):
    def failing(self, *args, **kw):
        raise Injected("the writer failed")

    mp.setattr(twriters.BLOW5Writer, "write_flat", failing)
    mp.setattr(twriters.BLOW5Writer, "write_batch", failing)


@pytest.mark.parametrize("inject,message,n_dev", [
    (_fail_iter_batches, "the reads failed", 2), (_fail_decoder, "the decoder failed", 2),
    (_fail_shard, "shard 3 failed", 8), (_fail_writer, "the writer failed", 2)])
def test_a_failing_stage_is_raised_and_stops_every_thread(short_fasta, tmp_path, monkeypatch, inject,
                                                         message, n_dev):
    """Each run also has shard threads (2 or 8 devices) to stop."""
    inject(monkeypatch)
    with pytest.raises(Injected, match=message):
        _run(short_fasta, tmp_path, "failing", device=[CPU] * n_dev, predict_batch_size=4 * n_dev,
             export_every_n_samples=1)


def test_a_writer_failing_behind_the_loop_is_raised(fasta, tmp_path, monkeypatch):
    """At the default threshold the writer's first write is a flush that the
    decode thread handed to it during the loop; its failure is raised by
    simulate_run and every thread stops."""
    finalize, finalizing, during_loop = texporter.StreamingExporter.finalize, [], []

    def watched(self):
        finalizing.append(1)
        return finalize(self)

    def failing(self, *args, **kw):
        during_loop.append(not finalizing)
        raise Injected("the writer failed")

    monkeypatch.setattr(texporter.StreamingExporter, "finalize", watched)
    monkeypatch.setattr(twriters.BLOW5Writer, "write_flat", failing)
    with pytest.raises(Injected, match="the writer failed"):
        _run(fasta, tmp_path, "failing_behind", device=[CPU] * 2)
    assert during_loop == [True]


class _FixedClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2024, 1, 2, 3, 4, 5)


@pytest.mark.parametrize("ext", [".blow5", ".slow5", ".pod5"])
def test_write_behind_by_output_format(fasta, tmp_path, monkeypatch, ext):
    """At the default threshold (1,000,000 chunks, never reached here) the
    decode thread hands BLOW5 and SLOW5 reads to the idle writer during the
    loop (`export.behind_samples`), and the file's bytes are those of one
    flush in finalize (`inf`: no writer thread); POD5, whose flushes are
    record batches of the file, keeps its one flush in finalize."""
    monkeypatch.setattr(twriters, "datetime", _FixedClock)
    monkeypatch.setenv("SEQ2SQUIGGLE_TPU_TIMERS", "1")
    stats, recs = _run(fasta, tmp_path, "behind", ext=ext)
    one_stats, one = _run(fasta, tmp_path, "one", ext=ext, export_every_n_samples=float("inf"))
    _assert_equal(recs, one)
    got = stats["timers"]
    final = got.get("export.final_samples", 0)
    assert got.get("export.behind_samples", 0) + final == stats["samples"] == one_stats["samples"]
    assert one_stats["timers"]["export.final_samples"] == stats["samples"]
    if ext == ".pod5":
        assert "export.behind_samples" not in got
    else:
        assert got["export.behind_samples"] > 0
        assert (tmp_path / f"behind{ext}").read_bytes() == (tmp_path / f"one{ext}").read_bytes()
