"""`predict` in reference mode, recomputed plainly from its inputs.

Given the genome file, the weights, the run's seed and its settings, this
draws the same reads from the genome (seq2squiggle's reference mode: the
read-length fits `expon`, `gamma` and `beta`, random start and strand, exact-length and N
checks, up to 20 rounds of redraws), cuts them into chunks of K k-mers,
and for each chunk recomputes the encoder, the noise and duration heads,
the Gamma dwell times from the chunk's threefry key, the length
regulation, the decoder, the amplitude noise and the digitisation, with the
event wire tier's round trip of the noise stdev (quarter ADC counts).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.stats as st
import torch

from . import threefry as tf
from .model import F32, Params, Precision, decode, embed, encode, head, one_hot

_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")
# seq2squiggle's read-length fits: (scipy distribution, its parameters, the
# fit's mean read length, by which a drawn length is scaled to the mean asked for)
LENGTHS = {"expon": (st.expon, (213.98910256668592, 6972.5319847131141), 7106.0),
           "gamma": (st.gamma, (6.3693711, 0.53834893), 4.39),
           "beta": (st.beta, (1.778, 7.892, 316.758, 34191.257), 6615.0)}


def read_genome(path: str) -> List[str]:
    """The contigs of a FASTA file, upper case, anything but ACGT as N."""
    seqs, cur = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                cur = []
            elif line:
                cur.append(line)
    if cur:
        seqs.append("".join(cur))
    table = bytearray(b"N" * 256)
    for lo, up in zip(b"acgtACGT", b"ACGTACGT"):
        table[lo] = up
    return [s.encode().translate(bytes(table)).decode() for s in seqs]


def sample_reads(genome: Sequence[str], n: int, mean_len: int, seed: int,
                 min_read_len: int = 30, rounds: int = 20, distr: str = "expon") -> List[str]:
    """The reads reference mode draws (DNA, lengths from the fit `distr`), in read order.
    A genome with N in it is refused: the program replaces N by drawn bases."""
    if any("N" in g for g in genome):
        raise ValueError("the reference handles genomes of ACGT only")
    lens = np.asarray([len(g) for g in genome], np.int64)
    cum = np.cumsum(lens)
    total = int(lens.sum())
    out: Dict[int, str] = {}
    remaining = np.arange(n)
    for attempt in range(rounds):
        m = len(remaining)
        if m == 0:
            break
        rng = np.random.RandomState(
            np.random.SeedSequence([seed & 0x7FFFFFFF, attempt]).generate_state(1)[0])
        start = rng.randint(0, total, size=m)
        gi = np.searchsorted(cum, start, side="right")
        start_in = start - np.where(gi > 0, cum[gi - 1], 0)
        dist, params, ref_mean = LENGTHS[distr]
        length = (dist.rvs(*params, size=m, random_state=rng) * mean_len / ref_mean).astype(np.int64)
        length = np.clip(length, 1, total)
        strand = rng.choice(np.array(["+", "-"]), size=m)
        failed = []
        for j, i in enumerate(remaining):
            a = int(start_in[j])
            read = genome[gi[j]][a:a + int(length[j])]
            if len(read) != int(length[j]) or len(read) < min_read_len:
                failed.append(i)
                continue
            if strand[j] == "-":
                read = read.encode().translate(_COMPLEMENT)[::-1].decode()
            out[int(i)] = read
        remaining = np.asarray(failed, np.int64)
    return [out[i] for i in sorted(out)]


def chunk_kmers(read: str, k: int, K: int) -> np.ndarray:
    """(n_chunks, K, k) base codes ('_' 0, A 1, C 2, G 3, T 4); the k-mers past
    the read's last one are the all-'_' k-mer."""
    lut = np.full(256, 5, np.uint8)
    for i, ch in enumerate(b"_ACGT"):
        lut[ch] = i
    codes = lut[np.frombuffer(read.encode(), np.uint8)]
    n_kmers = len(codes) - k + 1
    n_chunks = -(-n_kmers // K)
    kmers = np.zeros((n_chunks * K, k), np.uint8)
    kmers[:n_kmers] = np.lib.stride_tricks.sliding_window_view(codes, k)
    return kmers.reshape(n_chunks, K, k)


def chunk_signals(P: Params, cfg: dict, run: dict, codes: torch.Tensor,
                  read_idx: torch.Tensor, chunk_off: torch.Tensor,
                  q: Precision = F32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Digitised samples of a block of chunks: ((B, T) int16 with each row's
    kept samples first, (B,) kept counts). `run` holds the seed and the
    settings (noise_std, min_noise, min_duration, scaling_max_value,
    digitisation, range, offset_mean)."""
    T = int(cfg["max_signal_len"])
    dev = codes.device
    emb = embed(P, one_hot(codes, len(cfg["allowed_chars"])), cfg, q)
    enc = encode(P, emb, cfg, q)
    noise_sd = head(P, "noise_sampler", emb)
    conc = head(P, "duration_sampler/conc", emb).clamp_min(1e-8)
    rate = head(P, "duration_sampler/rate", emb).clamp_min(1e-8)

    chunk_key = tf.fold_in(tf.fold_in(tf.key(run["seed"], dev), read_idx), chunk_off)
    dur = tf.gamma(tf.fold_in(chunk_key, 1), conc) / rate
    dur = torch.round(dur.clamp_min(1.0).clamp_min(float(run["min_duration"]))).long()

    ends = torch.cumsum(dur, 1).clamp(max=T)
    t = torch.arange(T, device=dev)
    seg = (ends[:, None, :] <= t[None, :, None]).sum(-1)  # (B, T) in [0, K]
    K = enc.shape[1]
    frames = torch.cat([enc, torch.zeros_like(enc[:, :1])], 1)
    frames = torch.gather(frames, 1, seg[..., None].expand(-1, -1, enc.shape[2]))
    pa = decode(P, frames, cfg, q) * np.float32(run["scaling_max_value"])

    dig, rng_pa = np.float32(run["digitisation"]), np.float32(run["range"])
    cpr = np.float32(dig / rng_pa)
    sigma_counts = (noise_sd.clamp_min(run["min_noise"]) * np.float32(run["noise_std"])
                    * np.float32(run["scaling_max_value"]) * cpr)
    sigma_raw = torch.round(sigma_counts * 4.0)
    # the event tier ships the stdev in quarter counts; a row it cannot hold
    # goes through the raw tier, which keeps the stdev as it is
    sigma_pa = torch.where(sigma_raw <= 255, sigma_raw * np.float32(0.25 * rng_pa / dig),
                           sigma_counts / cpr)
    sigma_tail = float(run["min_noise"] * run["noise_std"] * run["scaling_max_value"])
    sigma_ev = torch.cat([sigma_pa, torch.full_like(sigma_pa[:, :1], sigma_tail)], 1)
    sigma_f = torch.gather(sigma_ev, 1, seg)
    gauss = tf.normal(tf.fold_in(chunk_key, 2), (T,))
    noisy = torch.where(pa != 0, pa + gauss * sigma_f, pa).clamp_min(0.0)
    keep = noisy != 0
    counts = torch.round(noisy * dig / rng_pa - np.float32(run["offset_mean"]))
    counts = counts.clamp(-32768, 32767).to(torch.int16)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return torch.gather(counts, 1, order), keep.sum(1)


def read_signals(P: Params, cfg: dict, run: dict, reads: Dict[int, str], device="cpu",
                 q: Precision = F32, rows: int = 2048) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """{read index: (int16 signal, per-chunk sample counts)} for the given
    reads, computed `rows` chunks at a time."""
    parts = []
    for idx, seq in reads.items():
        kmers = chunk_kmers(seq, int(cfg["seq_kmer"]), int(cfg["max_dna_len"]))
        n = len(kmers)
        parts.append((kmers, np.full(n, idx, np.int64), np.arange(n, dtype=np.int64)))
    codes = np.concatenate([p[0] for p in parts])
    ridx = np.concatenate([p[1] for p in parts])
    coff = np.concatenate([p[2] for p in parts])
    sig_rows, cnt_rows = [], []
    with torch.no_grad():
        for s in range(0, len(codes), rows):
            sl = slice(s, s + rows)
            sig, cnt = chunk_signals(P, cfg, run, torch.from_numpy(codes[sl]).to(device),
                                     torch.from_numpy(ridx[sl]).to(device),
                                     torch.from_numpy(coff[sl]).to(device), q)
            sig_rows.append(sig.cpu().numpy())
            cnt_rows.append(cnt.cpu().numpy())
    sig_rows = np.concatenate(sig_rows)
    cnt_rows = np.concatenate(cnt_rows)
    out = {}
    for idx in reads:
        sel = np.nonzero(ridx == idx)[0]
        out[idx] = (np.concatenate([sig_rows[i, :cnt_rows[i]] for i in sel]), cnt_rows[sel])
    return out
