"""The benchmark's arithmetic: operation and byte counts, bounds, the
interval union, and the per-layer metrics' readers on made-up runs."""

import importlib.util
import pathlib

import pytest

from benchmark.harness import counts, trace

METRICS = pathlib.Path(__file__).resolve().parents[1] / "metrics"
CFG = dict(max_dna_len=16, max_signal_len=250, dmodel=64, dff=256, allowed_chars="_ACGT",
           seq_kmer=9, pre_layers=1, encoder_layers=2, decoder_layers=2)


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_block_counts_match_the_kernel_table():
    # PERF.md's kernel table: 41.5 GFLOP per 1024 x 250 fused-block call, a
    # bound of 0.087 ms per predict batch, 20.8 GFLOP per (512, 250) B3 forward
    assert counts.block_flops(1024, 250, 64, 256) == pytest.approx(41.55e9, rel=1e-3)
    assert counts.block_flops(512, 250, 64, 256) == pytest.approx(20.77e9, rel=1e-3)
    per_batch = 2 * counts.block_bound_s(1024, 250, 64, 256) + 2 * counts.block_bound_s(1024, 16, 64, 256)
    assert per_batch * 1e3 == pytest.approx(0.087, abs=5e-4)
    # a block call at 1024 x 250 is bound by compute: 42 us against 20 us of bytes
    assert counts.block_flops(1024, 250, 64, 256) / counts.PEAK_BF16_FLOPS > \
        counts.block_bytes(1024, 250, 64, 256) / counts.PEAK_HBM_BYTES


def test_model_flops_per_chunk():
    assert counts.model_forward_flops(CFG) == pytest.approx(85.08e6, rel=1e-3)
    r9 = dict(CFG, seq_kmer=6)
    assert counts.model_forward_flops(CFG) - counts.model_forward_flops(r9) == 2 * 16 * 15 * 64


def test_backward_bound_is_twice_the_forward():
    f = counts.block_bound_s(512, 250, 64, 256)
    assert counts.block_bound_s(512, 250, 64, 256, passes=2) == pytest.approx(2 * f)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 1), (0.5, 2)], 2.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(2, 3), (0, 1), (0.2, 0.4)], 2.0),
    ([(0, 5), (1, 2), (3, 4)], 5.0),
])
def test_union(intervals, want):
    assert trace.union_seconds(intervals) == pytest.approx(want)


def _trace(**over):
    tr = {"busy_s": 0.5, "window_s": 2.0, "launches": 1000, "batches": 4, "steps": 4,
          "kernel_s": {"void fft_block_mma_kernel<true>(...)": 0.01,
                       "void fft_block_pair_mma_kernel(...)": 0.0,
                       "void bwd_rows_mma_kernel(...)": 0.004,
                       "block_train_fwd_mma_kernel": 0.002, "other": 5.0}}
    tr.update(over)
    return tr


def test_idle_and_launch_readers():
    run = {"trace": _trace()}
    assert reader("device.idle_pct.predict")(run) == pytest.approx(75.0)
    assert reader("device.idle_pct.train")(run) == pytest.approx(75.0)
    assert reader("predict_step.launches.predict")(run) == pytest.approx(250.0)
    assert reader("train_step.launches.train")(run) == pytest.approx(250.0)
    assert reader("device.idle_pct.predict")({"trace": None}) is None
    assert reader("device.idle_pct.predict")({"trace": _trace(busy_s=0.0)}) is None


def test_roofline_readers():
    run = {"trace": _trace(), "config": CFG, "traffic": {"batch": 1024}}
    per_batch = 2 * counts.block_bound_s(1024, 250, 64, 256) + 2 * counts.block_bound_s(1024, 16, 64, 256)
    got = reader("fft_block_roofline")(run)
    assert got == pytest.approx(100 * per_batch * 4 / 0.01)
    run = {"trace": _trace(), "config": CFG, "traffic": {"batch": 512}}
    per_step = 2 * 3 * counts.block_bound_s(512, 250, 64, 256)
    got = reader("block_train_roofline")(run)
    assert got == pytest.approx(100 * per_step * 4 / 0.006)
    # no kernel of the list ran: the metric is left out, never 0
    empty = {"trace": _trace(kernel_s={"other": 1.0}), "config": CFG, "traffic": {"batch": 512}}
    assert reader("fft_block_roofline")(empty) is None
    assert reader("block_train_roofline")(empty) is None


def test_mfu_readers():
    f = counts.model_forward_flops(CFG)
    run = {"untraced": [(2.0, 1000), (3.0, 2000)], "config": CFG}
    assert reader("mfu.predict")(run) == pytest.approx(100 * f * 3000 / (5.0 * 989e12))
    run = {"trace": _trace(window_s=0.5, steps=2), "chunks": 10240, "wall_s": 11.0,
           "traced_wall_s": 1.0,
           "config": CFG, "traffic": {"batch": 512}}
    assert reader("mfu.train")(run) == pytest.approx(100 * 3 * f * 9216 / (10.0 * 989e12))


def test_host_readers():
    run = {"timers": {"dispatch_cpu": 2.0, "writer_write_cpu": 0.5, "decode_t2": 0.3,
                      "n_t2": 10, "decode_t8": 0.1, "n_t8": 10}, "batches": 20}
    assert reader("run_loop.dispatch_cpu_ms.predict")(run) == pytest.approx(100.0)
    assert reader("writer.cpu_ms.predict")(run) == pytest.approx(25.0)
    assert reader("wire.decode_ms.predict")(run) == pytest.approx(20.0)
    assert reader("wire.decode_ms.predict")({"timers": {}, "batches": 1}) is None
    assert reader("train_data.host_ms.train")({"data_s": 0.5, "untraced_steps": 100}) == pytest.approx(5.0)


def test_short_kernel_names():
    long = ("void at::native::vectorized_elementwise_kernel<2, at::native::AUnaryFunctor<long, long,"
            " long, at::native::BitwiseAndFunctor<long> >, std::array<char*, 2ul> >(int, "
            "at::native::AUnaryFunctor<long, long, long, at::native::BitwiseAndFunctor<long> >)")
    assert trace.short_name(long) == "at::native::vectorized_elementwise_kernel<BitwiseAndFunctor>"
    mine = "void (anonymous namespace)::fft_block_mma_kernel<false>(__nv_bfloat16 const*, int)"
    assert trace.short_name(mine) == "fft_block_mma_kernel<false>"


def test_alignment_absorbs_a_dwell_flip_and_counts_what_is_missing():
    import numpy as np

    from benchmark.harness.judge_predict import align, compare

    rng = np.random.default_rng(0)
    ref = rng.integers(-500, 500, 300).astype(np.int16)
    counts = [100, 100, 100]
    assert align(ref, ref, counts).max() == 0 and len(align(ref, ref, counts)) == 300
    # chunk 0 one frame longer (a dwell that rounded the other way), the rest intact
    prog = np.concatenate([ref[:40], ref[39:100], ref[100:]])
    gaps = align(prog, ref, counts)
    assert len(gaps) == 300 and np.median(gaps) == 0
    # a read the program lost counts every frame at the cap
    assert compare({}, {0: (ref, counts)}, 1)["gap_p99_counts"] == 64.0
    assert compare({0: prog}, {0: (ref, counts)}, 1)["length_gap"] == 1 / 300


def test_alignment_follows_a_drift_that_grows_with_the_read():
    import numpy as np

    from benchmark.harness import judge_predict

    rng = np.random.default_rng(1)
    counts = [100] * 1000
    ref = rng.integers(-500, 500, sum(counts)).astype(np.int16)
    # the first 70 chunks each one frame longer near their end: the drift ends
    # at 70 samples, past the floor of the window and within what a read of
    # 100k samples allows
    parts = []
    for c in range(len(counts)):
        chunk = ref[c * 100:(c + 1) * 100]
        parts.append(np.concatenate([chunk[:98], chunk[97:]]) if c < 70 else chunk)
    prog = np.concatenate(parts)
    assert judge_predict.DRIFT_FLOOR < 70 < judge_predict.drift_window(len(ref))
    gaps = judge_predict.align(prog, ref, counts)
    assert len(gaps) == len(ref) and np.percentile(gaps, 99) == 0
