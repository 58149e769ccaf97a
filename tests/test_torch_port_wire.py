"""The port's device-to-host wire formats (runtime/predict.py's packers,
runtime/wire.py's decoders, runtime/simulate.py's tier choice and step-down)
against seq2squiggle_tpu on the JAX CPU backend, and against the port's own
raw tier.

Bars:
  - packers: the framed bytes of every tier bit-equal to the JAX package's on
    the same numpy-seeded inputs (`_flat_compact` too, with empty rows and an
    overflowing batch);
  - decoders: samples bit-equal to the JAX package's on the same wire buffer,
    on the numpy path and on the C++ path;
  - the port against its own raw tier: 8 and 12 bits equal; the ULP tier
    without noise or with static noise bit-equal; with sampled noise counts
    equal, |Δ| <= 1 and >= 90 % of samples equal (tests/test_wire.py's bars);
  - `simulate_run(wire_format="auto")` at float32 against the JAX package's:
    the same records, samples equal except |Δ| <= 1 on <= 0.1 % (the predict
    bar; the port's raw tier misses it against the JAX package's auto);
  - two shards' records together equal the unsharded run's.
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.io.slow5 import read_slow5
from seq2squiggle_tpu.ops import regulator as jregulator
from seq2squiggle_tpu.runtime import predict as jpredict
from seq2squiggle_tpu.runtime import wire as jwire
from seq2squiggle_tpu.runtime.simulate import simulate_run as jax_simulate_run
from seq2squiggle_tpu_torch import prng
from seq2squiggle_tpu_torch.io.native.build import load_native
from seq2squiggle_tpu_torch.models.fft_model import to_device
from seq2squiggle_tpu_torch.models.weights import load_checkpoint
from seq2squiggle_tpu_torch.ops import regulator as tregulator
from seq2squiggle_tpu_torch.runtime import predict as tpredict
from seq2squiggle_tpu_torch.runtime import simulate as tsimulate
from seq2squiggle_tpu_torch.runtime import wire as twire

ROOT = pathlib.Path(__file__).resolve().parents[1]
R10 = str(ROOT / "assets" / "bench-weights-R10.npz")
T, K = 250, 16
CPU = torch.device("cpu")


def _frames(outs) -> np.ndarray:
    return tpredict._frame_outputs(outs).numpy()


@functools.lru_cache(maxsize=None)
def _jax_framed(name, **static):
    """A JAX packer, jitted, with its outputs framed as make_predict_fn does."""
    fn = getattr(jpredict, name)
    return jax.jit(lambda *a: jpredict._frame_outputs(fn(*a, **static)))


def _knobs(**kw):
    kw = {"noise_std": 2.0, "noise_sampling": True, **kw}
    return jpredict.PredictKnobs(**kw), tpredict.PredictKnobs(**kw)


def _event_inputs(B, seed, jitter_pa=0.08, overflow_rows=True):
    """A clean prediction shaped like the decoder's, from numpy seed `seed`:
    a level per event (a random walk in log space: adjacent k-mers within a
    fraction of an octave), jitter within it (0.08 pA: about half a bf16 ULP,
    so mostly 0 and +-1 ULP steps), zeros in the tail segment; a few spikes
    (escapes and wide jumps at the ULP tier, exceptions at the event tier),
    two levels more than an octave off (escaped levels), one row of padding
    and, with overflow_rows, one row whose stdev overflows the sigma field
    and one whose level overflows int16. Returns the JAX and the port's
    arguments."""
    rng = np.random.default_rng(seed)
    dur = rng.integers(0, 30, (B, K)).astype(np.int32)
    dur[1, :] = 1  # a short read: a long tail segment
    ends, starts_ext, seg, is_start = (np.asarray(a) for a in
                                       jregulator.segment_map(jnp.asarray(dur), T))
    t_parts = tregulator.segment_map(torch.from_numpy(dur), T)
    for a, b in zip((ends, starts_ext, seg, is_start), t_parts):
        np.testing.assert_array_equal(a, b.numpy())
    level = np.clip(80.0 * np.exp(np.cumsum(rng.normal(0, 0.15, (B, K + 1)), axis=1)),
                    40, 130).astype(np.float32)
    level[[4, 5], [5, 2]] *= 2.6
    level[:, K] = 0.0  # the tail segment is zero
    pred = np.take_along_axis(level, seg, 1) + rng.normal(0, jitter_pa, (B, T)).astype(np.float32)
    spikes = rng.integers(0, B * T, 8)
    pred.reshape(-1)[spikes[:6]] += 1.2
    pred.reshape(-1)[spikes[6:]] += 5.0
    pred = np.where(seg < K, np.maximum(pred, 0.5), 0.0).astype(np.float32)
    noise_stdev = rng.uniform(0.005, 0.02, (B, K)).astype(np.float32)
    if overflow_rows:
        pred[2, :5] = 6000.0  # a level beyond int16 counts
        noise_stdev[3, 4] = 0.3  # beyond the quarter-count uint8 field
    read_idx = np.arange(B, dtype=np.int32)
    read_idx[-1] = -1
    jax_parts = tuple(jnp.asarray(a) for a in (ends, starts_ext, seg, is_start))
    return pred, jax_parts, t_parts, noise_stdev, read_idx


def _pack_both(bits, B=24, seed=0, knobs_kw=(), **inputs_kw):
    """The framed bytes of the tier-`bits` packer, the JAX package's and the
    port's, on one set of inputs."""
    jk, tk = _knobs(**dict(knobs_kw))
    pred, jparts, tparts, nstd, ridx = _event_inputs(B, seed, **inputs_kw)
    if bits == 4:
        jbuf = _jax_framed("_pack_event_wire", knobs=jk)(
            jnp.asarray(pred), jparts, jnp.asarray(nstd), jnp.asarray(ridx))
        tbuf = _frames(tpredict._pack_event_wire(
            torch.from_numpy(pred), tparts, torch.from_numpy(nstd),
            torch.from_numpy(ridx), tk))
    else:  # the ULP tier packs the bf16 decoder output, before the x 165
        dec = jnp.asarray(pred / 165.0, jnp.bfloat16)
        dec_t = torch.from_numpy(np.array(dec.astype(jnp.float32))).to(torch.bfloat16)
        jbuf = _jax_framed("_pack_event_wire_ulp", knobs=jk)(
            dec, jparts, jnp.asarray(nstd), jnp.asarray(ridx))
        tbuf = _frames(tpredict._pack_event_wire_ulp(
            dec_t, tparts, torch.from_numpy(nstd), torch.from_numpy(ridx), tk))
    return np.asarray(jbuf), tbuf, ridx


def _delta_inputs(B=32, seed=0):
    """Front-compacted int16 rows with boundary-style jumps (tests/test_wire.py
    test_pack_unpack_roundtrip_random), one row of noise that overflows int8
    deltas and one whose residuals overflow int16."""
    rng = np.random.default_rng(seed)
    sig = rng.integers(500, 520, (B, T)).astype(np.int32)
    for b in range(B):
        for j in rng.integers(0, T, rng.integers(0, 16)):
            sig[b, j:] += rng.integers(-800, 800)
    sig[1] = 800 + rng.normal(0, 150, T)
    sig[2, ::2] = 30000
    sig[2, 1::2] = -30000
    counts = rng.integers(1, T + 1, B).astype(np.int32)
    counts[1:3] = T
    sig = np.where(np.arange(T)[None] < counts[:, None], sig, 0).astype(np.int16)
    return sig, counts


# ---- packers: the port's framed bytes against the JAX package's ----

@pytest.mark.parametrize("bits", [8, 12, 16])
def test_delta_packers_bit_equal_to_jax(bits):
    sig, counts = _delta_inputs()
    if bits == 16:
        outs_j = (jnp.asarray(sig), jnp.asarray(counts))
        outs_t = (torch.from_numpy(sig), torch.from_numpy(counts))
    else:
        outs_j = jpredict._pack_wire(jnp.asarray(sig), jnp.asarray(counts), bits) + (
            jnp.asarray(counts),)
        outs_t = tpredict._pack_wire(torch.from_numpy(sig), torch.from_numpy(counts), bits) + (
            torch.from_numpy(counts),)
        n_exc = np.asarray(outs_j[3])
        assert n_exc[2] >= 1 << 20 and n_exc.max() > jpredict.WIRE_EXC_SLOTS[bits]
    jbuf = np.asarray(jpredict._frame_outputs(outs_j))
    tbuf = _frames(outs_t)
    assert tbuf.shape == (len(sig), tpredict.row_bytes(bits, T, K))
    np.testing.assert_array_equal(tbuf, jbuf)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("knobs_kw", [(), (("noise_std", 0.0),),
                                      (("noise_sampling", False),)])
def test_event_packers_bit_equal_to_jax(bits, knobs_kw):
    jbuf, tbuf, _ = _pack_both(bits, knobs_kw=knobs_kw)
    assert tbuf.shape[1] == tpredict.row_bytes(bits, T, K)
    np.testing.assert_array_equal(tbuf, jbuf)


def test_ulp_packer_overflowing_batch_bit_equal_to_jax():
    """A batch whose escapes overflow the batch-flat buffers: every row is
    flagged, and the truncated buffers still match byte for byte."""
    jbuf, tbuf, _ = _pack_both(2, B=8, seed=3, jitter_pa=2.0)
    flags = jwire.unframe_wire(jbuf, 2, T, K)[8]
    assert flags.all()
    np.testing.assert_array_equal(tbuf, jbuf)


@pytest.mark.parametrize("case", ["empty_rows", "overflow"])
def test_flat_compact_bit_equal_to_jax(case):
    rng = np.random.default_rng(5)
    B, W = 12, 40
    flagged = rng.random((B, W)) < 0.1
    flagged[[0, 4, 5, 11]] = False  # empty rows, the first and the last among them
    vals = rng.integers(-(2 ** 31), 2 ** 31 - 1, (B, W), dtype=np.int64).astype(np.int32)
    cap = 4 * B if case == "empty_rows" else int(flagged.sum()) // 2
    assert (int(flagged.sum()) > cap) == (case == "overflow")
    fj = jax.jit(jpredict._flat_compact, static_argnums=2)
    jflat, jtotal = fj(jnp.asarray(flagged), jnp.asarray(vals), cap)
    tflat, ttotal = tpredict._flat_compact(torch.from_numpy(flagged), torch.from_numpy(vals), cap)
    assert int(ttotal) == int(jtotal) == int(flagged.sum())
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))


# ---- decoders: the port's against the JAX package's on one wire buffer ----

@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("bits", [8, 12])
def test_delta_decoders_bit_equal_to_jax(bits, use_native):
    if use_native:
        assert load_native() is not None  # g++ builds the codec on this host
    sig, counts = _delta_inputs(seed=1)
    keep = np.ones(len(sig), bool)
    keep[1:3] = False  # the rows that overflow
    sig, counts = sig[keep], counts[keep]
    outs = [np.asarray(a) for a in
            jpredict._pack_wire(jnp.asarray(sig), jnp.asarray(counts), bits)]
    got = twire.unpack_wire(*outs, bits=bits, use_native=use_native)
    np.testing.assert_array_equal(got, jwire.unpack_wire(*outs, bits=bits,
                                                         use_native=use_native))
    live = np.arange(T)[None] < counts[:, None]
    np.testing.assert_array_equal(got[live], sig[live])


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("knobs_kw", [(), (("noise_std", 0.0),),
                                      (("noise_sampling", False), ("noise_std", 1.5))])
@pytest.mark.parametrize("bits", [2, 4])
def test_event_decoders_bit_equal_to_jax(bits, knobs_kw, use_native):
    """One wire buffer from the JAX packer, decoded by both packages: the
    numpy paths draw their noise through jax.random and through the port's
    threefry, the C++ paths through the same code."""
    if use_native:
        assert load_native() is not None
    jk, tk = _knobs(wire_bits=bits, **dict(knobs_kw))
    jbuf, _, ridx = _pack_both(bits, seed=7, knobs_kw=knobs_kw, overflow_rows=False)
    chunk_off = (np.arange(len(ridx)) % 3).astype(np.int32)
    jdec = jwire.EventWireDecoder(jk, jax.random.key(9), use_native=use_native, frames=T)
    tdec = twire.EventWireDecoder(tk, prng.key(9), use_native=use_native, frames=T)
    jflat, jcounts = jdec(jwire.unframe_wire(jbuf, bits, T, K), ridx, chunk_off)
    tflat, tcounts = tdec(twire.unframe_wire(jbuf, bits, T, K), ridx, chunk_off)
    assert tdec.native_used == use_native
    np.testing.assert_array_equal(tcounts, jcounts)
    np.testing.assert_array_equal(tflat, jflat)
    assert tflat.size == tcounts.sum() > 0



# ---- the port's tiers against its own raw tier (tests/test_wire.py's bars) ----

@pytest.fixture(scope="module")
def host_params():
    return load_checkpoint(R10)[0]


def _batch(B, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(1, 5, (B, K + 9 - 1)).astype(np.uint8)
    ridx = np.arange(B, dtype=np.int32)
    ridx[-2:] = -1  # padding rows contribute nothing
    coff = (np.arange(B) % 3).astype(np.int32)
    return codes, ridx, coff


def _port_step(host_params, dtype, bits, batch, key=11, **knobs_kw):
    """One framed predict_step on the CPU with the R10 weights."""
    cfg = dict(load_config(None), compute_dtype=dtype)
    params = to_device(host_params, CPU, torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    knobs = tpredict.PredictKnobs(wire_bits=bits, **knobs_kw)
    with torch.inference_mode():
        buf = tpredict.predict_step(params, *(torch.from_numpy(a) for a in batch),
                                    prng.key(key), config=cfg, knobs=knobs, framed=True)
    assert buf.dtype == torch.uint8 and buf.shape == (len(batch[0]), tpredict.row_bytes(bits, T, K))
    return buf.numpy(), knobs


def _decode(buf, knobs, batch, key=11, use_native=True):
    """(flat kept samples, counts) of one framed batch, through runtime/wire.py."""
    bits = knobs.wire_bits
    arrs = twire.unframe_wire(buf, bits, T, K)
    if bits in (2, 4):
        dec = twire.EventWireDecoder(knobs, prng.key(key), use_native=use_native, frames=T)
        return dec(arrs, batch[1], batch[2])
    if bits == 16:
        sig, counts = arrs
    else:
        sig, counts = twire.unpack_wire(*arrs[:4], bits=bits, use_native=use_native), arrs[4]
    return sig[np.arange(T)[None] < counts[:, None]], counts


def _tier_and_raw(host_params, dtype, bits, batch, use_native=True, **knobs_kw):
    raw = _decode(*_port_step(host_params, dtype, 16, batch, **knobs_kw), batch)
    got = _decode(*_port_step(host_params, dtype, bits, batch, **knobs_kw), batch,
                  use_native=use_native)
    np.testing.assert_array_equal(got[1], raw[1])  # counts exact
    return got[0].astype(np.int32), raw[0].astype(np.int32)


@pytest.mark.parametrize("bits", [8, 12])
def test_delta_tiers_equal_raw(host_params, bits):
    """tests/test_wire.py::test_packed_predict_matches_raw on the port."""
    got, raw = _tier_and_raw(host_params, "float32", bits, _batch(32, seed=1))
    np.testing.assert_array_equal(got, raw)


@pytest.mark.parametrize("knobs_kw", [
    dict(noise_std=0.0, noise_sampling=False),
    dict(noise_std=1.5, noise_sampling=False),
])
def test_ulp_tier_bit_exact_vs_raw(host_params, knobs_kw):
    """tests/test_wire.py::test_ulp_tier_bit_exact_vs_raw on the port: the
    decoder rebuilds the exact bf16 output and replays the digitisation."""
    got, raw = _tier_and_raw(host_params, "bfloat16", 2, _batch(48, seed=7),
                             use_native=False, **knobs_kw)
    np.testing.assert_array_equal(got, raw)


@pytest.mark.parametrize("use_native", [False, True])
def test_ulp_tier_sampled_noise_within_one_count(host_params, use_native):
    """tests/test_wire.py::test_ulp_tier_sampled_noise_within_one_count on the
    port: the stdev field is quantised to quarter counts."""
    got, raw = _tier_and_raw(host_params, "bfloat16", 2, _batch(48, seed=13),
                             use_native=use_native, noise_std=1.0, noise_sampling=True)
    diff = np.abs(got - raw)
    assert diff.max() <= 1 and (diff == 0).mean() > 0.9


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_overflow_detected(host_params, bits):
    """A noise scale no tier-`bits` row can hold (noise_std 40: the stdev
    field at 2 and 4, int8 deltas and their 24 slots at 8) makes the
    decoder refuse the batch, so the run recomputes it raw."""
    batch = _batch(8, seed=1)
    dtype = "bfloat16" if bits == 2 else "float32"
    buf, knobs = _port_step(host_params, dtype, bits, batch, noise_std=40.0)
    with pytest.raises(RuntimeError, match="exception overflow"):
        _decode(buf, knobs, batch)


@pytest.mark.parametrize("dtype,T_frames,wire_format,bits", [
    ("bfloat16", 250, "auto", 2), ("float32", 250, "auto", 4),
    ("bfloat16", 250, "event", 4), ("float32", 251, "auto", 8),
    ("float32", 251, "event", 8), ("bfloat16", 251, "auto", 2),
    ("bfloat16", 256, "ulp", 8), ("float32", 250, "12", 12),
    ("bfloat16", 250, "raw", 16),
])
def test_starting_tier_is_the_jax_packages(dtype, T_frames, wire_format, bits):
    """JAX simulate.py:168-193: ULP needs bf16 and T <= 255, the event tier
    an even T <= 255; an odd T starts at 8-bit deltas."""
    cfg = dict(load_config(None), compute_dtype=dtype, max_signal_len=T_frames)
    assert tsimulate.start_wire_bits(wire_format, cfg) == bits


# ---- simulate_run: the JAX package's auto (C11), shards, trace, timers ----

def _write_fasta(path, n_reads, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n_reads):
            n = int(rng.integers(120, 700))
            fh.write(f">read{i}\n{''.join(rng.choice(list('ACGT'), n))}\n")
    return str(path)


def _run_kwargs(fasta, out, **over):
    kw = dict(
        config=dict(load_config(None), compute_dtype="float32"),
        saved_weights=R10, fasta=fasta, read_input=True, n=-1, r=400, c=-1, out=str(out),
        profile="dna-r10-prom", dwell_mean=None, dwell_std=0.0, noise_std=2.0,
        noise_sampling=True, duration_sampling=True, distr="expon",
        predict_batch_size=32, export_every_n_samples=1_000_000, seed=11,
        show_progress=False, wire_format="auto",
    )
    kw.update(over)
    return kw


def _records(path):
    return [(r["read_id"], r["signal"].astype(np.int64)) for r in read_slow5(str(path))[1]]


def test_auto_matches_the_jax_packages_auto(tmp_path):
    """ROADMAP C11: at float32 both packages' auto start at the 4-bit event
    tier and regenerate the noise on the host; the records meet the predict
    bar. (The port's raw tier misses it: the event tier quantises the clean
    signal to counts before the noise.)"""
    fasta = _write_fasta(tmp_path / "in.fasta", 6, seed=2)
    jax_simulate_run(**_run_kwargs(fasta, tmp_path / "jax.blow5"))
    stats = tsimulate.simulate_run(**_run_kwargs(fasta, tmp_path / "port.blow5"), device=CPU)
    assert stats["wire_bits"] == 4 and stats["wire_decode"]["native"] > 0
    jrecs, trecs = _records(tmp_path / "jax.blow5"), _records(tmp_path / "port.blow5")
    assert [r for r, _ in trecs] == [r for r, _ in jrecs] and len(trecs) == 6
    assert [len(s) for _, s in trecs] == [len(s) for _, s in jrecs]
    d = np.abs(np.concatenate([t - j for (_, t), (_, j) in zip(trecs, jrecs)]))
    assert d.max() <= 1 and (d == 1).mean() <= 0.001


def test_two_shards_match_unsharded(tmp_path):
    """tests/test_sharding_invariance.py::test_two_shards_match_unsharded on
    the port, with a FASTA written here: the shards' records, by read id (the
    indexed UUIDs number reads globally), are the unsharded run's."""
    fasta = _write_fasta(tmp_path / "in.fasta", 7, seed=4)
    tsimulate.simulate_run(**_run_kwargs(fasta, tmp_path / "all.blow5"), device=CPU)
    for i in range(2):
        tsimulate.simulate_run(**_run_kwargs(fasta, tmp_path / f"s{i}.blow5", num_shards=2,
                                             shard_index=i), device=CPU)
    full = dict(_records(tmp_path / "all.blow5"))
    s0, s1 = dict(_records(tmp_path / "s0.blow5")), dict(_records(tmp_path / "s1.blow5"))
    assert len(full) == 7 and len(s0) == 4 and not set(s0) & set(s1)
    assert set(full) == set(s0) | set(s1)
    for read_id, signal in {**s0, **s1}.items():
        np.testing.assert_array_equal(signal, full[read_id])


def test_trace_dir_and_stage_timers(tmp_path, monkeypatch):
    """--trace-dir writes a torch.profiler trace; SEQ2SQUIGGLE_TPU_TIMERS=1
    fills stats["timers"] with the JAX package's keys."""
    monkeypatch.setenv("SEQ2SQUIGGLE_TPU_TIMERS", "1")
    fasta = _write_fasta(tmp_path / "in.fasta", 3, seed=5)
    stats = tsimulate.simulate_run(**_run_kwargs(
        fasta, tmp_path / "o.blow5", trace_dir=str(tmp_path / "trace"),
        config=load_config(None)), device=CPU)
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    timers = stats["timers"]
    n = timers["n_t2"]
    assert stats["wire_bits"] == 2 and n == stats["wire_decode"]["native"] >= 1
    for key in ("d2h_wait", "decode", "decode_t2", "export", "dispatch", "finalize",
                "process_cpu", "event2_rebuild", "writer_write", "slow5_encode_cpu"):
        assert key in timers, key
    assert timers["process_cpu"] > 0


def test_step_down_ladder_matches_raw(tmp_path, caplog):
    """tests/test_wire.py:45-66's regime in a run: noise whose deltas
    overflow int8 makes each 8-bit batch recompute raw, the fourth steps the
    run down to 12-bit deltas, and the records equal the raw run's."""
    fasta = _write_fasta(tmp_path / "in.fasta", 6, seed=2)
    kw = dict(noise_std=20.0, predict_batch_size=8)
    tsimulate.simulate_run(**_run_kwargs(fasta, tmp_path / "raw.blow5", wire_format="raw", **kw),
                           device=CPU)
    with caplog.at_level("WARNING", logger="seq2squiggle_tpu_torch"):
        stats = tsimulate.simulate_run(
            **_run_kwargs(fasta, tmp_path / "8.blow5", wire_format="8", **kw), device=CPU)
    assert stats["wire_bits"] == 12
    assert "downgrading wire format to 12-bit deltas" in caplog.text
    assert caplog.text.count("recomputed this batch raw") == 3
    got, raw = _records(tmp_path / "8.blow5"), _records(tmp_path / "raw.blow5")
    assert [r for r, _ in got] == [r for r, _ in raw] and len(got) == 6
    for (_, a), (_, b) in zip(got, raw):
        np.testing.assert_array_equal(a, b)


def test_ulp_budget_probe():
    """The first ULP batch's check of its batch-flat budgets (JAX
    simulate.py:356-405): 8 sigma of Poisson headroom or a step down."""
    B, W = 64, (T + 3) // 4
    arrs = [np.zeros((B, W), np.uint8), None, np.zeros((B, K), np.int8), None, None,
            np.zeros((B, tpredict.WIRE_ESC_NIB_PER_ROW // 2), np.uint8)]
    assert tsimulate.ulp_budget_short(arrs) is None
    arrs[0][:, :4] = 0xFF  # 16 escapes a row: 1024 + 8 sigma = 1280 slots, enough
    assert tsimulate.ulp_budget_short(arrs) is None
    arrs[0][:, 4] = 0x03  # one more a row: short
    assert tsimulate.ulp_budget_short(arrs) == "1088/1280 escape slots"
    arrs[0][:] = 0
    arrs[5][:4, 0] = 0x88  # 8 wide jumps for 16 slots
    assert tsimulate.ulp_budget_short(arrs) == "8/16 wide-jump slots"
    arrs[5][:] = 0
    arrs[2][:40, 3] = -127  # 40 escaped levels for 64 slots
    assert tsimulate.ulp_budget_short(arrs) == "40/64 level-escape slots"


def test_ulp_probe_steps_small_batches_down(tmp_path, caplog):
    """At batch 8 the ULP tier's flat budgets (2 wide-jump slots) have no
    headroom: the first batch steps the run down to the event tier, and
    the records stay within 1 count of the raw run's, counts exact."""
    fasta = _write_fasta(tmp_path / "in.fasta", 3, seed=8)
    kw = dict(config=load_config(None), predict_batch_size=8, noise_std=0.0)
    tsimulate.simulate_run(**_run_kwargs(fasta, tmp_path / "raw.blow5", wire_format="raw", **kw),
                           device=CPU)
    with caplog.at_level("INFO", logger="seq2squiggle_tpu_torch"):
        stats = tsimulate.simulate_run(**_run_kwargs(fasta, tmp_path / "a.blow5", **kw),
                                       device=CPU)
    assert "switching to the 4-bit event tier proactively" in caplog.text
    assert stats["wire_bits"] == 4 and stats["wire_decode"]["numpy"] == 0
    got, raw = _records(tmp_path / "a.blow5"), _records(tmp_path / "raw.blow5")
    assert [len(s) for _, s in got] == [len(s) for _, s in raw] and len(got) == 3
    d = np.abs(np.concatenate([a - b for (_, a), (_, b) in zip(got, raw)]))
    assert d.max() <= 1


def test_rows_past_256_frames_decode_through_numpy(tmp_path):
    """At T = 300 the C++ delta decoder, whose rows end at 256 frames, is
    passed over: stats count every batch as numpy's, and the records equal
    the raw run's. (12 bits: the random weights' jumps overflow int8.)"""
    assert load_native() is not None
    fasta = _write_fasta(tmp_path / "in.fasta", 3, seed=6)
    kw = dict(config=dict(load_config(None), compute_dtype="float32", max_signal_len=300),
              saved_weights="random")  # the checkpoint's positions end at 250
    tsimulate.simulate_run(**_run_kwargs(fasta, tmp_path / "raw.blow5", wire_format="raw", **kw),
                           device=CPU)
    assert tsimulate.start_wire_bits("auto", kw["config"]) == 8
    stats = tsimulate.simulate_run(**_run_kwargs(fasta, tmp_path / "a.blow5", wire_format="12",
                                                 **kw), device=CPU)
    assert stats["wire_bits"] == 12
    assert stats["wire_decode"]["native"] == 0 and stats["wire_decode"]["numpy"] >= 1
    got, raw = _records(tmp_path / "a.blow5"), _records(tmp_path / "raw.blow5")
    assert [r for r, _ in got] == [r for r, _ in raw] and len(got) == 3
    for (_, a), (_, b) in zip(got, raw):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_packers_on_the_card_match_the_cpu(host_params):
    """chip_smoke.py phase 14's packer check: each tier's framed bytes from
    the card equal the same packer's on the CPU fed the card's decoder
    output, stdevs and segment map."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    widths = chip_smoke.hold_packers(host_params, torch.device("cuda"), B=256)
    assert widths == {bits: tpredict.row_bytes(bits, T, K) for bits in (2, 4, 8, 12)}
