"""The port's parallel layer in one process (seq2squiggle_tpu_torch/parallel/,
the sharded predict step, device data parallelism in simulate_run, the ULP
decoder's per-shard offsets, dropout on a dp slab, the attention core's
head counts) against the JAX package on its 8-device CPU mesh
(tests/conftest.py).

Bars:
  - the ('dp', 'tp') layout and the parameter rule: every leaf's spec equal
    to the JAX package's `param_shardings` (tests/test_parallel.py:23-43
    checks three), and each rank's shard equal to the JAX array's shard on
    that mesh position;
  - the sharded predict step over 8 CPU devices: framed bytes bit-equal to
    make_predict_fn_sharded's on the 8-device mesh at tiers 2, 4, 8, 12 and
    16. Both packages' model calls (encoder, noise head, decoder) are
    replaced by the same exact function of their inputs (dyadic sums, the
    same bits in both libraries), so what is compared is the step around
    the model: k-mer windows, keys, durations, regulation, packers, per-shard
    flat buffers and framing; the model's own numbers are held elsewhere
    (test_torch_port_predict.py);
  - the ULP and event decoders with dp_shards = 8: samples bit-equal to the
    JAX package's on the same sharded buffer (numpy and C++ paths), and to
    the one-device decode of the same rows (tests/test_parallel.py:45-77's
    invariance);
  - simulate_run over [cpu] * 8 (f32, the event tier) and [cpu] * 2 (bf16,
    the ULP tier with dp_shards 2): records bit-equal to one device's, and at
    f32 equal to the JAX
    package's 8-device run at the predict bar (same read ids and lengths,
    |Δ| <= 1 count on <= 0.1 % of samples), as test_sharding_invariance.py's
    device-dp case asks of the JAX package;
  - dropout on a dp slab: masks bit-equal to the global draw's rows, which
    is what the JAX package draws on its dp shard (threefry partitionable);
  - the attention core's plain versions at 1, 2 and 4 heads bit-equal to
    the 8-head version on the same heads, forward and backward;
  - the backend rule and the refusals: nccl on a shared card or the CPU
    raises, cuda without a card raises, no environment starts no group.
"""

from __future__ import annotations

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.io.slow5 import read_slow5
from seq2squiggle_tpu.parallel import mesh as jmesh
from seq2squiggle_tpu.runtime import predict as jpredict
from seq2squiggle_tpu.runtime import wire as jwire
from seq2squiggle_tpu.runtime.simulate import simulate_run as jax_simulate_run
from seq2squiggle_tpu_torch import device as tdevice
from seq2squiggle_tpu_torch import prng
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.models.weights import params_to_jax
from seq2squiggle_tpu_torch.ops import attention as tattention
from seq2squiggle_tpu_torch.ops import attn_core as tcore
from seq2squiggle_tpu_torch.parallel import distributed as tdist
from seq2squiggle_tpu_torch.parallel import mesh as tmesh
from seq2squiggle_tpu_torch.runtime import predict as tpredict
from seq2squiggle_tpu_torch.runtime import simulate as tsimulate
from seq2squiggle_tpu_torch.runtime import wire as twire

ROOT = pathlib.Path(__file__).resolve().parents[1]
R10 = str(ROOT / "assets" / "bench-weights-R10.npz")
CPU = torch.device("cpu")
N_DEV = 8
B, K, T, KMER = 64, 16, 250, 9


# ---- the layout and the parameter rule (tests/test_parallel.py:23-43) ----

def test_mesh_shapes():
    mesh = tmesh.make_mesh(n_dp=4, n_tp=2, world=8)
    assert mesh.shape == {"dp": 4, "tp": 2}
    assert tmesh.make_mesh(world=8).shape == {"dp": 8, "tp": 1}
    # rank r at the JAX mesh's position of device r: row r // tp, column r % tp
    jm = jmesh.make_mesh(n_dp=4, n_tp=2)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(ids - ids.min(), mesh.ranks)
    for r in range(8):
        m = tmesh.make_mesh(4, 2, world=8, rank=r)
        assert (m.dp_rank, m.tp_rank) == (r // 2, r % 2)
        assert m.local_rows(16) == slice(4 * (r // 2), 4 * (r // 2) + 4)
    with pytest.raises(ValueError, match="needs 8 ranks"):
        tmesh.make_mesh(4, 2, world=4)


def test_param_shardings_match_the_jax_packages():
    cfg = dict(load_config(None), compute_dtype="float32")
    tparams = tmodel.init_params(cfg, prng.key(0))
    jparams = params_to_jax(tparams)  # the JAX package's tree (init_params bit for bit)
    jm = jmesh.make_mesh(n_dp=4, n_tp=2)
    jspecs = jax.tree_util.tree_leaves(jmesh.param_shardings(jparams, jm))
    specs = tmesh.param_shardings(tparams)

    def spec_at(path):
        tree = specs
        for key in path:
            tree = tree[int(key)] if isinstance(tree, list) else tree[key]
        return tree

    tspecs = [spec_at(p) for p, _ in tmodel.tree_leaves(tparams)]
    assert len(jspecs) == len(tspecs) == len(tmodel.tree_leaves(tparams))
    assert [tuple(s.spec) for s in jspecs] == tspecs
    # 4 blocks: q, k, v and w_1 column-parallel (and their biases), fc and w_2 row-parallel
    assert tspecs.count((None, "tp")) == tspecs.count(("tp",)) == 16
    assert tspecs.count(("tp", None)) == 8
    # each rank's shard is the JAX array's shard at its mesh position
    sharded = jmesh.shard_params(jparams, jm)
    position = {d.id: divmod(i, 2) for i, d in enumerate(jm.devices.reshape(-1))}
    for (path, leaf), jleaf in zip(tmodel.tree_leaves(tparams),
                                   jax.tree_util.tree_leaves(sharded)):
        axis = tmesh.shard_axis(tmesh.spec_for("/".join(path), leaf.dim()))
        for shard in jleaf.addressable_shards:
            dp, tp = position[shard.device.id]
            mine = tmesh.shard_tensor(leaf, axis, tmesh.make_mesh(4, 2, world=8,
                                                                  rank=2 * dp + tp))
            np.testing.assert_array_equal(np.asarray(shard.data), mine.numpy())
    full = tmesh.shard_params(tparams, None)  # no mesh: the leaves themselves
    assert all(a is b for (_, a), (_, b) in zip(tmodel.tree_leaves(full),
                                                tmodel.tree_leaves(tparams)))


# ---- the sharded predict step against make_predict_fn_sharded ----

def _exact_models(lib):
    """The model calls of predict_step as one exact function of their inputs
    in `lib` (jnp or torch): the same bits in both packages."""
    is_jax = lib is jnp

    def as_f32(x):
        return x.astype(jnp.float32) if is_jax else x.float()

    def encoder(params, one_hot, config, **kw):
        pad = config["dmodel"] - one_hot.shape[-1]
        if is_jax:
            enc = jnp.pad(one_hot, ((0, 0), (0, 0), (0, pad)))
        else:
            enc = torch.nn.functional.pad(one_hot, (0, pad))
        return enc, enc

    def noise(params, emb32, config, **kw):
        return 2.0 ** -9 + emb32[..., 0] * 2.0 ** -10 + emb32[..., 7] * 2.0 ** -11

    def decoder(params, x, config, **kw):
        xf = as_f32(x)
        t = lib.arange(x.shape[1])
        level = 0.5 + xf[..., 0] * 2.0 ** -6 + xf[..., 1] * 2.0 ** -7 + xf[..., 5] * 2.0 ** -8
        bump = lib.where(t % 50 == 25, 3 * 2.0 ** -8, 0.0)  # a 3-ULP escape pair
        wide = lib.where(t == 120, 40 * 2.0 ** -8, 0.0)  # a wide jump pair
        rows = lib.arange(x.shape[0])[:, None] % 8
        high = xf[..., 2] * xf[..., 7] * 0.75  # > 127 bf16 steps: a level escape
        v = level + bump + lib.where(rows == 0, wide, 0.0) + lib.where(rows == 3, high, 0.0)
        v = lib.where(xf.sum(-1) > 0, v, 0.0)
        return (v.astype(x.dtype) if is_jax else v.to(x.dtype))[..., None]

    return {"encoder_forward": encoder, "noise_head": noise, "decoder_forward": decoder}


def _sharded_inputs(seed=3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(1, 5, (B, K + KMER - 1)).astype(np.uint8)
    ridx = (np.arange(B) // 3).astype(np.int32)
    ridx[[5, 40, 41]] = -1  # padding rows in two shards
    coff = (np.arange(B) % 3).astype(np.int32)
    n_kmers = np.full(B, K, np.int32)
    n_kmers[::7] = rng.integers(1, K, len(n_kmers[::7]))
    return codes, ridx, coff, n_kmers


def _knobs(mod, bits):
    return mod.PredictKnobs(wire_bits=bits, dwell_mean=10.0, dwell_std=3.0,
                            duration_sampling=False, noise_std=2.0 if bits <= 4 else 0.0)


@pytest.fixture(scope="module")
def sharded_bytes():
    """bits -> (port 8-shard framed bytes, JAX make_predict_fn_sharded bytes,
    the port's one-device bytes), with both packages' models replaced by
    `_exact_models`."""
    cfg = dict(load_config(None), compute_dtype="bfloat16")
    inputs = _sharded_inputs()
    jm = jmesh.make_mesh(n_dp=N_DEV, n_tp=1)
    bsh = jmesh.batch_sharding(jm)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, lib in ((jpredict, jnp), (tpredict, torch)):
            for name, fn in _exact_models(lib).items():
                mp.setattr(mod, name, fn)
        for bits in (2, 4, 8, 12, 16):
            fn = jpredict.make_predict_fn_sharded(cfg, _knobs(jpredict, bits), jm, framed=True)
            jbuf = np.asarray(fn({}, *(jax.device_put(a, bsh) for a in inputs[:3]),
                                 jax.random.key(11), jax.device_put(inputs[3], bsh)))
            devices = [CPU] * N_DEV
            with torch.inference_mode():
                tbuf = tpredict.predict_step_sharded(
                    {CPU: {}}, *(torch.from_numpy(a) for a in inputs[:3]), {CPU: prng.key(11)},
                    torch.from_numpy(inputs[3]), config=cfg, knobs=_knobs(tpredict, bits),
                    devices=devices).numpy()
                one = tpredict.predict_step(
                    {}, *(torch.from_numpy(a) for a in inputs[:3]), prng.key(11),
                    torch.from_numpy(inputs[3]), config=cfg, knobs=_knobs(tpredict, bits),
                    framed=True).numpy()
            out[bits] = (tbuf, jbuf, one)
    return out


@pytest.mark.parametrize("bits", [2, 4, 8, 12, 16])
def test_sharded_step_framed_bytes_equal_the_jax_packages(sharded_bytes, bits):
    tbuf, jbuf, one = sharded_bytes[bits]
    assert tbuf.shape == (B, tpredict.row_bytes(bits, T, K)) and tbuf.dtype == np.uint8
    np.testing.assert_array_equal(tbuf, jbuf)
    if bits == 2:  # the per-shard flat buffers: not the one-device layout
        arrs = twire.unframe_wire(tbuf, 2, T, K)
        assert not np.asarray(arrs[8]).any(), "no shard overflowed its buffers"
        assert (np.asarray(arrs[6]) != 0).any() and (np.asarray(arrs[7]) != 0).any()
        esc_rows = np.asarray(arrs[5]).reshape(N_DEV, -1).any(axis=1)
        assert esc_rows.all(), "every shard packs escapes into its own buffer"
        assert not np.array_equal(tbuf, one)
    else:  # no flat buffer: shards are the one-device rows
        np.testing.assert_array_equal(tbuf, one)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("bits", [2, 4])
def test_decoders_with_dp_shards_equal_the_jax_packages(sharded_bytes, bits, use_native):
    """The sharded buffer decoded with dp_shards = 8: the JAX package's
    samples, and the one-device decode of the same rows."""
    tbuf, _, one = sharded_bytes[bits]
    _, ridx, coff, _ = _sharded_inputs()
    tk, jk = _knobs(tpredict, bits), _knobs(jpredict, bits)
    tdec = twire.EventWireDecoder(tk, prng.key(11), use_native=use_native, frames=T,
                                  dp_shards=N_DEV)
    got = tdec(twire.unframe_wire(tbuf, bits, T, K), ridx, coff)
    assert tdec.native_used == use_native
    jdec = jwire.EventWireDecoder(jk, jax.random.key(11), use_native=use_native, frames=T,
                                  dp_shards=N_DEV)
    want = jdec(jwire.unframe_wire(tbuf, bits, T, K), ridx, coff)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    single = twire.EventWireDecoder(tk, prng.key(11), use_native=use_native, frames=T)(
        twire.unframe_wire(one, bits, T, K), ridx, coff)
    np.testing.assert_array_equal(got[1], single[1])
    np.testing.assert_array_equal(got[0], single[0])
    assert got[1].sum() > 0


def test_ulp_probe_judges_the_worst_shard():
    """A batch whose escapes crowd one shard: roomy as a whole, short for
    that shard (JAX simulate.py:356-405)."""
    W = (T + 3) // 4
    arrs = [np.zeros((B, W), np.uint8), None, np.zeros((B, K), np.int8), None, None,
            np.zeros((B, tpredict.WIRE_ESC_NIB_PER_ROW // 2), np.uint8)]
    arrs[0][:8, :5] = 0xFF  # 20 escapes a row, all in shard 0
    assert tsimulate.ulp_budget_short(arrs) is None  # 160 of 1280 over the batch
    assert tsimulate.ulp_budget_short(arrs, N_DEV) == "160/160 escape slots"


# ---- simulate_run over 8 devices ----

def _write_fasta(path, n_reads, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n_reads):
            n = int(rng.integers(120, 900))
            fh.write(f">read{i}\n{''.join(rng.choice(list('ACGT'), n))}\n")
    return str(path)


def _run_kwargs(fasta, out, dtype, **over):
    return dict(
        config=dict(load_config(None), compute_dtype=dtype),
        saved_weights=R10, fasta=fasta, read_input=True, n=-1, r=400, c=-1, out=str(out),
        profile="dna-r10-prom", dwell_mean=None, dwell_std=0.0, noise_std=2.0,
        noise_sampling=True, duration_sampling=True, distr="expon",
        predict_batch_size=32, export_every_n_samples=1_000_000, seed=11,
        show_progress=False, wire_format="auto") | over


def _records(path):
    return [(r["read_id"], r["signal"].astype(np.int64)) for r in read_slow5(str(path))[1]]


@pytest.mark.parametrize("dtype,n_dev,batch", [("bfloat16", 2, 96), ("float32", N_DEV, 32)])
def test_simulate_run_over_several_devices(tmp_path, dtype, n_dev, batch):
    """bf16 runs the ULP tier, whose flat buffers need ~40 rows a shard at the
    R10 model's escape rate (else the first batch's probe steps the run down
    to the event tier, as the JAX package's does): 2 shards of 48 rows. f32
    runs the event tier over 8 shards of 4 rows."""
    fasta = _write_fasta(tmp_path / "in.fasta", 5, seed=4)
    kw = dict(predict_batch_size=batch)
    one = tsimulate.simulate_run(**_run_kwargs(fasta, tmp_path / "one.blow5", dtype, **kw),
                                 device=[CPU])
    many = tsimulate.simulate_run(**_run_kwargs(fasta, tmp_path / "many.blow5", dtype, **kw),
                                  device=[CPU] * n_dev)
    assert (one["dp_shards"], many["dp_shards"]) == (1, n_dev)
    assert one["wire_bits"] == many["wire_bits"] == (2 if dtype == "bfloat16" else 4)
    got, want = _records(tmp_path / "many.blow5"), _records(tmp_path / "one.blow5")
    assert len(got) == len(want) == 5 and one["chunks"] > batch  # several batches
    for (ia, a), (ib, b) in zip(got, want):
        assert ia == ib
        np.testing.assert_array_equal(a, b)
    if dtype == "float32":  # the JAX package's run, on its 8 devices (device dp)
        jax_simulate_run(**_run_kwargs(fasta, tmp_path / "jax.blow5", dtype, **kw))
        jrecs = _records(tmp_path / "jax.blow5")
        assert [r for r, _ in jrecs] == [r for r, _ in got]
        assert [len(s) for _, s in jrecs] == [len(s) for _, s in got]
        d = np.abs(np.concatenate([a - j for (_, a), (_, j) in zip(got, jrecs)]))
        assert d.max() <= 1 and (d == 1).mean() <= 0.001


def test_batch_that_does_not_divide_runs_on_the_first_device(tmp_path):
    fasta = _write_fasta(tmp_path / "in.fasta", 2, seed=5)
    kw = _run_kwargs(fasta, tmp_path / "o.blow5", "float32", predict_batch_size=12)
    stats = tsimulate.simulate_run(**kw, device=[CPU] * N_DEV)
    assert stats["dp_shards"] == 1 and stats["reads"] == 2


# ---- dropout on a dp slab, the attention core's head counts ----

@pytest.mark.parametrize("n_dp", [2, 4])
def test_dropout_on_a_dp_slab_is_the_global_draws_rows(n_dp):
    shape, keep = (8, 50, 64), 0.8
    jkey = jax.random.key(5)
    want = np.asarray(jax.random.bernoulli(jkey, keep, shape))
    # the JAX package's draw made sharded over its dp axis (partitionable threefry)
    jm = jmesh.make_mesh(n_dp=n_dp, n_tp=1, devices=jax.devices()[:n_dp])
    sharded = jax.jit(lambda k: jax.random.bernoulli(k, keep, shape),
                      out_shardings=jmesh.batch_sharding(jm))(jkey)
    np.testing.assert_array_equal(np.asarray(sharded), want)
    per = shape[0] // n_dp
    for r in range(n_dp):
        mesh = tmesh.make_mesh(n_dp, 1, world=n_dp, rank=r)
        got = tattention.dropout_mask(prng.key(5), keep, (per, *shape[1:]), mesh)
        np.testing.assert_array_equal(got.numpy(), want[r * per:(r + 1) * per])
        x = torch.ones(per, *shape[1:])
        scales = tmodel._dropout_scales(prng.key(5), 1 - keep, x, mesh)
        np.testing.assert_array_equal(scales.numpy() != 0, want[r * per:(r + 1) * per])


@pytest.mark.parametrize("n_head", [1, 2, 4])
def test_core_plain_versions_on_fewer_heads_are_the_eight_head_ones(n_head):
    gen = torch.Generator().manual_seed(7)
    q, k, v, g = (torch.randn(3, 37, 64, generator=gen).to(torch.bfloat16) for _ in range(4))
    full = tcore.packed_attention_core_reference(q, k, v, 8)
    grads = tcore.packed_attention_core_backward_reference(q, k, v, g, 8)
    for first in range(0, 8, n_head):  # each tp rank's heads
        cols = slice(8 * first, 8 * (first + n_head))
        part = [t[..., cols].contiguous() for t in (q, k, v, g)]
        tcore._check(n_head, *part)
        assert torch.equal(tcore.packed_attention_core_reference(*part[:3], n_head),
                           full[..., cols])
        for a, b in zip(tcore.packed_attention_core_backward_reference(*part, n_head), grads):
            assert torch.equal(a, b[..., cols])


# ---- the backend rule and the refusals ----

def test_backend_rule_and_refusals(monkeypatch):
    assert tdist.backend_for("cuda", 2, 2) == "nccl"
    assert tdist.backend_for("cuda", 2, 1) == "gloo"  # two ranks on one card
    assert tdist.backend_for("cpu", 4, 0) == "gloo"
    assert tdist.backend_for("cuda", 1, 8, "nccl") == "nccl"
    with pytest.raises(ValueError, match="2 ranks share 1 card"):
        tdist.backend_for("cuda", 2, 1, "nccl")
    with pytest.raises(ValueError, match="on the CPU"):
        tdist.backend_for("cpu", 2, 0, "nccl")
    for var in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE",
                "SEQ2SQUIGGLE_TPU_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.maybe_init_distributed("cpu") is False
    assert tdist.world() == (1, 0)
    monkeypatch.setenv("SEQ2SQUIGGLE_TPU_DISTRIBUTED", "1")
    with pytest.raises(RuntimeError, match="needs its address"):
        tdist.maybe_init_distributed("cpu")
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tdist.maybe_init_distributed("cuda")
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tdevice.resolve_devices("cuda")
    assert tdevice.resolve_devices("cpu") == [CPU]
