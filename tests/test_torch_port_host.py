"""The port's own copies of the host modules against the JAX package's
originals: the same FASTA and seed give identical arrays and identical file
bytes (bit-equal: the copies differ only in imports, logger name and cache
directory). Also the static guard: no file of the port imports jax or any
module of the JAX package.
"""

from __future__ import annotations

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import datetime as _datetime
import importlib
import pathlib
import re
import threading
import time

import numpy as np
import pytest

import seq2squiggle_tpu as jpkg
import seq2squiggle_tpu_torch as tpkg

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = {"jax": "seq2squiggle_tpu", "port": "seq2squiggle_tpu_torch"}
SEED = 13


def mod(which: str, name: str):
    return importlib.import_module(f"{PACKAGES[which]}.{name}")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(SEED)
    path = tmp_path_factory.mktemp("host") / "reads.fasta"
    with open(path, "w") as fh:
        for i, n in enumerate((400, 1500, 90, 2600, 33, 800)):
            seq = "".join(rng.choice(list("ACGTN"), n, p=[.245, .245, .245, .245, .02]))
            fh.write(f">read{i} extra\n{seq}\n")
    return str(path)


def _reads(which, fasta, read_input):
    cfg = mod(which, "config").load_config(None)
    import random

    random.seed(SEED)  # n_to_random_bases draws from the global generator
    n = -1 if read_input else 12
    reads, total = mod(which, "io.reads").get_reads(
        fasta, read_input, n, 300, -1, cfg, "expon", SEED, "dna-r10-prom", 30)
    return cfg, [seq for seq, _ in reads], total


def _batches(which, fasta):
    cfg, seqs, _ = _reads(which, fasta, True)
    reads = [(s, f"id{i}") for i, s in enumerate(seqs)]
    return list(mod(which, "runtime.batcher").iter_batches(
        reads, 32, cfg["seq_kmer"], cfg["max_dna_len"]))


def _blow5_bytes(which, fasta, tmp_path, press, every=40, after_batch=None):
    """Batches -> a seeded fake device step -> StreamingExporter (its
    threshold `every` chunks) -> AsyncWriter -> BLOW5Writer; returns the
    file's bytes. `after_batch(i, exporter, writer)` runs after batch i."""
    writers = mod(which, "io.writers")
    profiles = mod(which, "profiles")

    class FixedClock(_datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2024, 1, 2, 3, 4, 5)

    old = writers.datetime
    writers.datetime = FixedClock
    try:
        out = tmp_path / f"{which}-{press}-{every}.blow5"
        writer = writers.BLOW5Writer(str(out), profiles.get_profile("dna-r10-prom"), False,
                                     "dna-r10-prom", False, np.random.default_rng(SEED),
                                     slow5_press=press)
        writer = mod(which, "runtime.async_writer").AsyncWriter(writer)
        exporter = mod(which, "runtime.exporter").StreamingExporter(writer, every)
        rng = np.random.default_rng(SEED)
        for i, batch in enumerate(_batches(which, fasta)):
            B = len(batch.read_idx)
            signal = rng.integers(-500, 1500, (B, 250)).astype(np.int16)
            counts = rng.integers(1, 250, B).astype(np.int32)
            exporter.add_batch(signal, counts, batch.segments)
            if after_batch is not None:
                after_batch(i, exporter, writer)
        exporter.finalize()
    finally:
        writers.datetime = old
    stats = (exporter.total_reads, exporter.total_chunks, exporter.total_samples)
    return out.read_bytes(), stats


def _case_get_reads_read_mode(fasta, tmp_path):
    return [_reads(w, fasta, True)[1:] for w in PACKAGES]


def _case_get_reads_reference_mode(fasta, tmp_path):
    return [_reads(w, fasta, False)[1:] for w in PACKAGES]


def _case_iter_batches(fasta, tmp_path):
    out = []
    for w in PACKAGES:
        out.append([(b.codes, b.read_idx, b.chunk_off, b.n_kmers, b.n_valid,
                     [(s.read_id, s.start_row, s.n_rows, s.read_done) for s in b.segments])
                    for b in _batches(w, fasta)])
    return out


def _case_blow5_zlib(fasta, tmp_path):
    return [_blow5_bytes(w, fasta, tmp_path, "zlib") for w in PACKAGES]


def _case_blow5_none(fasta, tmp_path):
    return [_blow5_bytes(w, fasta, tmp_path, "none") for w in PACKAGES]


def _case_slow5_roundtrip(fasta, tmp_path):
    out = []
    for w in PACKAGES:
        data, _ = _blow5_bytes(w, fasta, tmp_path, "zlib")
        path = tmp_path / f"{w}-rt.blow5"
        path.write_bytes(data)
        attrs, recs = mod(w, "io.slow5").read_slow5(str(path))
        out.append((sorted(attrs.items()) if isinstance(attrs, dict) else attrs,
                    [(r["read_id"], r["signal"]) for r in recs]))
    return out


def _case_profiles_and_config(fasta, tmp_path):
    out = []
    for w in PACKAGES:
        cfg = mod(w, "config").load_config(None)
        prof = mod(w, "profiles")
        out.append((cfg, {n: prof.get_profile(n) for n in ("dna-r10-prom", "dna-r9-min",
                                                           "rna-004-prom")},
                    prof.update_config_for_profile("dna-r9-min", dict(cfg))))
    return out


def _case_positional_table(fasta, tmp_path):
    return [mod(w, "ops.positional").sinusoid_encoding_table(250, 64) for w in PACKAGES]


def _case_preprocess(fasta, tmp_path):
    import pandas as pd
    import sys

    sys.path.insert(0, str(ROOT / "tests"))
    from test_preprocess import make_events

    events = tmp_path / "events.tsv"
    pd.concat([make_events(24 * 16, seed=i, read_name=f"r{i}") for i in range(2)]).to_csv(
        events, sep="\t", index=False)
    out = []
    for w in PACKAGES:
        np.random.seed(SEED)  # the shuffle draws from the global generator
        outdir = tmp_path / f"{w}-npy"
        mod(w, "train.preprocess").preprocess_run(
            str(events), str(outdir), batches=True, chunksize=200, partition_by=False,
            rna=False, config=mod(w, "config").load_config(None))
        out.append({p.name: np.load(p) for p in sorted(outdir.iterdir())})
    return out


def _case_standardize_events(fasta, tmp_path):
    import pandas as pd

    rng = np.random.default_rng(SEED)
    n = rng.integers(2, 90, 40)
    ends = np.cumsum(n)
    pd.DataFrame({"read_name": "r", "position": np.arange(40), "model_kmer": "ACGTACGTA",
                  "start_idx": ends - n, "end_idx": ends, "event_stdv": 1.0,
                  "samples": [",".join(map(str, rng.normal(0, 1, k).round(4))) for k in n]}
                 ).to_csv(tmp_path / "events.tsv", sep="\t", index=False)
    out = []
    for w in PACKAGES:
        path = tmp_path / f"{w}-std.tsv"
        mod(w, "tools.standardize_events").standardize_and_write_chunks(
            str(tmp_path / "events.tsv"), str(path), 9, 90.0, 11.0, filter_length=70)
        out.append(path.read_bytes())
    return out


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


CASES = [_case_get_reads_read_mode, _case_get_reads_reference_mode, _case_iter_batches,
         _case_blow5_zlib, _case_blow5_none, _case_slow5_roundtrip,
         _case_profiles_and_config, _case_positional_table, _case_preprocess,
         _case_standardize_events]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[6:] for c in CASES])
def test_copied_host_module_matches_original(case, fasta, tmp_path):
    original, copy = case(fasta, tmp_path)
    assert _equal(original, copy)
    if isinstance(original, (list, tuple)) and len(original):
        assert original[0] is not None  # the case produced something


@pytest.fixture
def counters(monkeypatch):
    """The port's span recorder on and emptied; off and emptied after."""
    from seq2squiggle_tpu_torch import tracing

    monkeypatch.setenv(tracing.ENV, "1")
    tracing.switch_from_env()
    tracing.reset()
    yield tracing
    monkeypatch.undo()
    tracing.switch_from_env()
    tracing.reset()


def _flush_when_idle(i, exporter, writer):
    """runtime/simulate.py's write-behind, after each batch the decode adds."""
    if writer.idle:
        exporter.flush()


def test_write_behind_writes_the_bytes_of_one_flush(fasta, tmp_path, counters):
    """The port's exporter at the default threshold (1,000,000 chunks, never
    reached), flushed whenever its writer's thread is idle, writes the bytes
    that the JAX package writes in its one flush in finalize."""
    one, _ = _blow5_bytes("jax", fasta, tmp_path, "zlib", every=1_000_000)
    behind, _ = _blow5_bytes("port", fasta, tmp_path, "zlib", every=1_000_000,
                             after_batch=_flush_when_idle)
    assert behind == one
    _, recs = mod("port", "io.slow5").read_slow5(str(tmp_path / "port-zlib-1000000.blow5"))
    got = counters.totals().counts
    assert got["export.behind_samples"] > 0
    assert (got["export.behind_samples"] + got.get("export.final_samples", 0)
            == sum(len(r["signal"]) for r in recs))


def test_write_behind_collects_reads_while_the_writer_is_busy(fasta, tmp_path, monkeypatch):
    """The writer's first write waits on an Event through batch HELD of 11
    (reads finish in batches 0, 3, 8, 9 and 10): the decode's adds go on,
    at most one flush waits behind the one being written, the reads that
    finish meanwhile go out together at the next idle moment, in stream
    order, and the file's bytes are those of one flush."""
    HELD = 9
    writers = mod("port", "io.writers")
    write_flat = writers.BLOW5Writer.write_flat
    release = threading.Event()
    flushes = []  # the read ids of each write, in the writer's order

    def held(self, read_ids, flat, sample_off):
        flushes.append(list(read_ids))
        if len(flushes) == 1:
            assert release.wait(60), "the writer was never released"
        return write_flat(self, read_ids, flat, sample_off)

    def after_batch(i, exporter, writer):
        _flush_when_idle(i, exporter, writer)
        if i == HELD:
            assert flushes[:1] == [["id0"]] and writer._queue.qsize() <= 1
            release.set()
            deadline = time.monotonic() + 60
            while not writer.idle and time.monotonic() < deadline:
                time.sleep(0.005)
            assert writer.idle

    monkeypatch.setattr(writers.BLOW5Writer, "write_flat", held)
    behind, _ = _blow5_bytes("port", fasta, tmp_path, "zlib", every=1_000_000,
                             after_batch=after_batch)
    one, _ = _blow5_bytes("jax", fasta, tmp_path, "zlib", every=1_000_000)
    assert behind == one
    assert [rid for ids in flushes for rid in ids] == [f"id{i}" for i in range(6)]
    # four batches finished reads while the writer was held, and at most two
    # flushes were handed over then, so a later flush carries several
    assert len(flushes) <= 3 and any(len(ids) > 1 for ids in flushes[1:])


def test_version_is_the_jax_packages():
    assert tpkg.__version__ == jpkg.__version__


def test_native_codec_caches_apart():
    """The two packages never load each other's codec library."""
    jb, tb = mod("jax", "io.native.build"), mod("port", "io.native.build")
    assert pathlib.Path(tb._SRC).read_bytes() == pathlib.Path(jb._SRC).read_bytes()
    assert pathlib.Path(tb._cache_path()).parent.name == "seq2squiggle_tpu_torch"
    assert pathlib.Path(jb._cache_path()).parent.name == "seq2squiggle_tpu"


def _port_files():
    files = sorted((ROOT / "seq2squiggle_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", *sorted(ROOT.glob("scripts/profile_torch_*.py"))]


_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)")
_CALL = re.compile(r"import_module\(\s*['\"]([\w.]+)|__import__\(\s*['\"]([\w.]+)")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    """Static scan of every import/from line (and importlib calls by name)."""
    bad = []
    for no, line in enumerate(path.read_text().splitlines(), 1):
        names = [m.group(1) for m in [_IMPORT.match(line)] if m]
        names += [g for m in _CALL.finditer(line) for g in m.groups() if g]
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "optax", "flax", "seq2squiggle_tpu"):
                bad.append(f"{path.name}:{no}: {line.strip()}")
    assert not bad, bad
