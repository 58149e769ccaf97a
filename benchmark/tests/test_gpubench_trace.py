"""What the traced runs count and what the cells record besides: `reduce`
on made-up profiler events (a graph's replay is one launch; kernels are
counted, copies and sets are not), the kernel readers, the train cell's
step keys against the plain derivations, and the BLOW5 record compression
in the predict cell's result line."""

import importlib.util
import io
import json
import time

import pytest
import torch

from benchmark.harness import core, slow5_reader, trace
from benchmark.reference import threefry as ref_threefry

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Event:
    """The part of a kineto event that `reduce` reads."""

    def __init__(self, name, device_type, start_us, duration_us):
        self._name, self._type = name, device_type
        self._start, self._dur = int(start_us * 1000), int(duration_us * 1000)

    def name(self):
        return self._name

    def device_type(self):
        return self._type

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur


# two replayed steps: each the key's kernel, a copy of the batch, then one
# graph launch that runs three kernels and a set
EVENTS = [e for step in (0, 1000) for e in (
    Event("cudaLaunchKernel", CPU, step + 0, 5),
    Event("cudaMemcpyAsync", CPU, step + 6, 5),
    Event("cudaGraphLaunch", CPU, step + 12, 10),
    Event("void threefry_keys_kernel(...)", CUDA, step + 10, 2),
    Event("Memcpy HtoD (Pinned -> Device)", CUDA, step + 20, 10),
    Event("Memset (Device)", CUDA, step + 40, 1),
    Event("bwd_rows_mma_kernel", CUDA, step + 42, 100),
    Event("void at::native::reduce_kernel<512, 1>(...)", CUDA, step + 150, 10),
    Event("void at::native::vectorized_elementwise_kernel<4>(...)", CUDA, step + 170, 10),
)]


def reader(name):
    spec = importlib.util.spec_from_file_location("m", core.BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_reduce_counts_a_graph_launch_and_the_kernels_not_copies_or_sets():
    got = trace.reduce(EVENTS, 0.002)
    assert got["launches"] == 2 * 2
    assert got["kernels"] == 2 * 4
    assert got["busy_s"] == pytest.approx(2 * 133e-6)
    assert set(trace.LAUNCH_NAMES) >= {"cudaLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch"}


@pytest.mark.parametrize("name,per", [("train_step.kernels.train", "steps"),
                                      ("predict_step.kernels.predict", "batches")])
def test_the_kernel_readers(name, per):
    summary = dict(trace.reduce(EVENTS, 0.002), **{per: 2})
    assert reader(name)({"trace": summary}) == pytest.approx(4.0)
    assert reader(name)({"trace": None}) is None
    # a trace with no device work (the profiler saw no card) reads as nothing
    assert reader(name)({"trace": dict(summary, busy_s=0.0, kernels=0)}) is None
    declared = {m["name"]: m for m in core.load_cell("r9-train")[0]["per_layer"]}
    assert declared[name]["source"] == "device_trace" and len(declared[name]["workloads"]) == 1


def test_the_launch_readers_count_graph_launches():
    summary = trace.reduce(EVENTS, 0.002)
    assert reader("train_step.launches.train")({"trace": dict(summary, steps=2)}) == 2.0
    assert reader("predict_step.launches.predict")({"trace": dict(summary, batches=2)}) == 2.0


def test_the_train_cells_step_keys_are_the_plain_ones(monkeypatch, tmp_path):
    """The keys the driver hands the step for steps 0 to 9 come from the
    program's threefry.fold_in and equal prng.fold_in's and the
    reference's bit for bit."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.ops import threefry

    seed = 2**31 + 51
    made = []
    real = threefry.fold_in

    def spy(key, data):
        made.append((int(data), real(key, data)))
        return made[-1][1]

    monkeypatch.setattr(threefry, "fold_in", spy)
    _, cell, cfg_file, traffic, _ = core.load_cell("r9-train")
    small = dict(traffic, chunks=1024, files=1, batch=16)
    ctx = core.make_context(cell, cfg_file, small, seed, torch.device("cpu"), str(tmp_path))
    driver = core.load_driver(small["driver"])(ctx)
    driver.setup()
    while driver.step < 10:
        driver._step()
    assert [step for step, _ in made] == list(range(10))
    for step, got in made:
        assert torch.equal(got, prng.fold_in(prng.key(seed), step))
        assert torch.equal(got, ref_threefry.fold_in(ref_threefry.key(seed), step))


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_the_programs_fold_in_is_the_plain_one(device):
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.ops import threefry

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA device: the threefry kernel runs only on the card")
    seed = 2**31 + 52
    key = prng.key(seed, device)
    for step in range(10):
        got = threefry.fold_in(key, step).cpu()
        assert torch.equal(got, prng.fold_in(prng.key(seed), step))
        assert torch.equal(got, ref_threefry.fold_in(ref_threefry.key(seed), step))


def test_the_predict_result_names_the_record_compression():
    out, err = io.StringIO(), io.StringIO()
    rc = core.run("r10-predict-genome", 2**31 + 53, 0.2, False, time.perf_counter(),
                  device=torch.device("cpu"),
                  traffic_override={"reads_per_job": 4, "mean_read_len": 400, "batch": 64,
                                    "judged_reads": 3}, out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    try:
        import zstandard  # noqa: F401

        want = "zstd"
    except ImportError:  # the writer falls back to zlib
        want = "zlib"
    assert res["blow5_record_press"] == want
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("press", ["zstd", "zlib", "none"])
def test_record_press_reads_the_lead_in(tmp_path, press):
    path = tmp_path / "x.blow5"
    lead = bytearray(b"BLOW5\x01" + bytes(58))
    lead[9] = {name: code for code, name in slow5_reader.RECORD_PRESS.items()}[press]
    path.write_bytes(bytes(lead))
    assert slow5_reader.record_press(str(path)) == press
