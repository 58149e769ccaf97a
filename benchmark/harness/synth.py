"""Inputs the benchmark makes from the seed (training chunks), and the
weights tree's flat and nested layouts."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def make_chunks(rng: np.random.Generator, events: dict, n: int, cfg: dict):
    """`n` training chunks of `events`' model of a pore, in the form
    preprocess gives eventalign's events. A row's K events come from one of
    the model's tables, drawn from `rng` for the row; an event's k-mer is
    drawn base by base, and its level, noise stdev and mean dwell are the
    model's constants plus the table's per-(position, base) terms summed
    over the k-mer. Its dwell in samples is Gamma(`dwell_shape`) around that
    mean, rounded, at least 1; its samples are normal about the level,
    rounded to 0.001 pA and at least 0, end to end over the row's events and
    cut at T. Returns (one-hot (n, K, k, 5) float16 over '_ACGT', targets
    (n, T) float32 pA, dwells (n, K) int16, stdevs (n, K) float32 pA,
    target lengths (n,) int16: the row's samples before the cut)."""
    K, k, T = int(cfg["max_dna_len"]), int(cfg["seq_kmer"]), int(cfg["max_signal_len"])
    tabs = {part: np.asarray([t[part] for t in events["tables"]], np.float64)
            for part in ("level", "stdev", "dwell")}  # (tables, k, 4) each
    which = rng.integers(0, len(events["tables"]), n)
    codes = rng.integers(0, 4, (n, K, k))
    at = (which[:, None, None], np.arange(k)[None, None, :], codes)
    level = events["level_pA"] + tabs["level"][at].sum(-1)
    stdev = np.clip(events["stdev_pA"] + tabs["stdev"][at].sum(-1), *events["stdev_clip_pA"])
    mean = np.clip(events["dwell_mean"] + tabs["dwell"][at].sum(-1), *events["dwell_clip"])
    shape = float(events["dwell_shape"])
    dwell = np.maximum(1, np.round(rng.gamma(shape, mean / shape))).astype(np.int64)
    ends = np.cumsum(dwell, axis=1)
    seg = (np.arange(T)[None, :, None] >= ends[:, None, :]).sum(-1)  # (n, T) event of each sample
    rows = np.arange(n)[:, None]
    pad = np.concatenate([level, np.zeros((n, 1))], axis=1)
    pad_sd = np.concatenate([stdev, np.zeros((n, 1))], axis=1)
    samples = np.round(np.maximum(rng.normal(pad[rows, seg], pad_sd[rows, seg]), 0.0), 3)
    one_hot = np.zeros((n, K, k, 5), np.float16)
    one_hot[rows[..., None], np.arange(K)[None, :, None], np.arange(k)[None, None, :], codes + 1] = 1
    t_len = np.minimum(ends[:, -1], np.iinfo(np.int16).max).astype(np.int16)
    return (one_hot, samples.astype(np.float32), dwell.astype(np.int16), stdev.astype(np.float32),
            t_len)


def write_chunk_files(path: str, seed: int, n_chunks: int, n_files: int, cfg: dict,
                      events: dict) -> Dict:
    """`n_files` groups of chunks in preprocess's file format (chunks-,
    targets-, chunks_lengths-, targets_lengths-, stdevs-NNNN.npy); returns
    the file lists by kind and the bytes written."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng([int(seed), 3])
    per = n_chunks // n_files
    files = {name: [] for name in ("chunks", "targets", "chunks_lengths",
                                   "targets_lengths", "stdevs")}
    nbytes = 0
    for i in range(n_files):
        one_hot, targets, dwell, stdev, t_len = make_chunks(rng, events, per, cfg)
        arrays = {"chunks": one_hot, "targets": targets, "chunks_lengths": dwell,
                  "targets_lengths": t_len, "stdevs": stdev}
        for name, arr in arrays.items():
            p = os.path.join(path, f"{name}-{i:04d}.npy")
            np.save(p, arr)
            files[name].append(p)
            nbytes += os.path.getsize(p)
    return {"files": files, "bytes": nbytes}


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """The flat layout as the nested tree (lists where keys are indices)."""
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}
