"""Bag-of-binary-words vocabulary: a codebook of binary words and dense
scoring.

Port of `orbslam2_tpu.vocab.bow` (the role of DBoW2 in ORB-SLAM2). A
vocabulary is a flat [V, 8] codebook or a two-level `Codebook` (coarse
cells, then per-cell fine words). BoW vectors are L1-normalised tf or
tf-idf word histograms [V]; similarity is DBoW2's L1 score.

The all-pairs assignments go through K1 (`ops/cuda_hamming`, the plain
version for CPU tensors); the per-row fine distance of the two-level
assignment is elementwise and stays plain. The histogram counts words in
integers (a sum of integers does not depend on the order the card adds
them in, so the card and the CPU agree bit for bit) and normalises after.

A session without a vocabulary file trains its own by binary k-medians
(`train_codebook`, `train_codebook2`). The random seeding is split out as
the RANSAC draws are: `draw_codebook_seeds` draws the initial centres and
each iteration's reseeds from a CPU generator, and the training takes
them, so a test can feed the reference's `jax.random` draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orbslam2_tpu_torch.ops import cuda_hamming, hamming
from orbslam2_tpu_torch.slam_map.map_state import masked_put_ as ms_put
from orbslam2_tpu_torch.solvers.horn import draw_samples


class Codebook(NamedTuple):
    """Two-level vocabulary of C * F words: coarse cells [C, 8], then F
    fine words per cell [C, F, 8] (int32 words holding uint32 bits). A
    flat codebook is the degenerate C = 1 case."""

    coarse: torch.Tensor
    fine: torch.Tensor

    @property
    def num_words(self) -> int:
        return self.coarse.shape[0] * self.fine.shape[1]


def num_words(codebook) -> int:
    """Effective vocabulary size for either representation."""
    if isinstance(codebook, Codebook):
        return codebook.num_words
    return codebook.shape[0]


def _unpack_bits(descs: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 words -> [N, 256] int32 in {0, 1}, bit j of word w at
    column 32 w + j."""
    shifts = torch.arange(32, dtype=torch.int32, device=descs.device)
    return ((descs[:, :, None] >> shifts) & 1).reshape(descs.shape[0], 256)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[V, 256] {0, 1} -> [V, 8] int32 words (the uint32 bits)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.reshape(-1, 8, 32).to(torch.int64) << shifts, dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def draw_codebook_seeds(valid: torch.Tensor, vocab_size: int, iters: int,
                        generator: torch.Generator) -> torch.Tensor:
    """[iters + 1, vocab_size] descriptor indices for one k-medians run: the
    initial centres, then each iteration's reseeds of empty clusters,
    drawn with replacement among the valid descriptors (among all when
    none is valid)."""
    return draw_samples(valid, iters + 1, vocab_size, generator)


def train_codebook(descs: torch.Tensor, valid: torch.Tensor, seeds: torch.Tensor,
                   vocab_size: int, iters: int = 8) -> torch.Tensor:
    """Binary k-medians: a [V, 8] codebook. Centres move to the bitwise
    majority of their assigned descriptors (ties to 1); an empty cluster
    is reseeded from `seeds`. The assignment is K1 (the nearest centre,
    the first on ties); the counts are integers."""
    V = vocab_size
    centers = descs[seeds[0]]
    bits = torch.where(valid[:, None], _unpack_bits(descs), 0)
    ones = valid.to(torch.int32)
    for k in range(iters):
        d = torch.where(valid[:, None], cuda_hamming.distance_matrix(descs, centers), 1 << 20)
        assign = torch.argmin(d, dim=1)
        counts = torch.zeros(V, dtype=torch.int32, device=descs.device).index_add_(0, assign, ones)
        bit_sums = torch.zeros((V, 256), dtype=torch.int32, device=descs.device).index_add_(
            0, assign, bits)
        new = _pack_bits((2 * bit_sums >= counts[:, None]).to(torch.int32))
        centers = torch.where((counts == 0)[:, None], descs[seeds[k + 1]], new)
    return centers


def train_codebook2(descs: torch.Tensor, valid: torch.Tensor, draw, coarse_size: int = 256,
                    fine_size: int = 64, iters: int = 6, bucket_cap: int = 4096) -> Codebook:
    """Two-level binary k-medians: coarse cells over the whole sample, then
    a fine codebook per cell on that cell's members (at most `bucket_cap`
    of them, the first by index). `draw(mask, vocab_size, cell)` gives
    each run's seeds (`draw_codebook_seeds`); `cell` is -1 for the coarse
    run."""
    N = descs.shape[0]
    C, M = coarse_size, bucket_cap
    dev = descs.device
    coarse = train_codebook(descs, valid, draw(valid, C, -1), C, iters)
    cell = torch.where(valid, torch.argmin(cuda_hamming.distance_matrix(descs, coarse), dim=1), C)
    order = torch.argsort(cell, stable=True)
    sc = cell[order]
    rank = torch.arange(N, device=dev) - torch.searchsorted(sc, sc, side="left")
    ok = (sc < C) & (rank < M)
    bucket = torch.zeros((C, M, 8), dtype=descs.dtype, device=dev)
    bvalid = torch.zeros((C, M), dtype=torch.bool, device=dev)
    ms_put(bucket, (sc, rank), descs[order], ok)
    ms_put(bvalid, (sc, rank), True, ok)
    fine = torch.stack([train_codebook(bucket[j], bvalid[j], draw(bvalid[j], fine_size, j),
                                       fine_size, iters) for j in range(C)])
    return Codebook(coarse=coarse, fine=fine)


def _assign2(descs: torch.Tensor, cb: Codebook) -> torch.Tensor:
    """Two-level word assignment [N] -> cell * F + fine."""
    F = cb.fine.shape[1]
    c = torch.argmin(cuda_hamming.distance_matrix(descs, cb.coarse), dim=1)
    d2 = hamming.distance(descs[:, None, :], cb.fine[c])      # [N, F]
    f = torch.argmin(d2, dim=1)
    return (c * F + f).to(torch.int32)


def word_ids(descs: torch.Tensor, codebook) -> torch.Tensor:
    """Per-feature word assignment [N] (ties to the first word)."""
    if isinstance(codebook, Codebook):
        return _assign2(descs, codebook)
    return torch.argmin(cuda_hamming.distance_matrix(descs, codebook), dim=1).to(torch.int32)


def bow_vector(descs: torch.Tensor, valid: torch.Tensor, codebook,
               idf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1-normalised tf (or tf-idf) word histogram [V] of the valid
    descriptors. `idf` is the per-word weight shipped with the vocabulary;
    None is tf only (a session-trained vocabulary has no corpus)."""
    V = num_words(codebook)
    assign = word_ids(descs, codebook).to(torch.int64)
    counts = torch.zeros(V, dtype=torch.int32, device=descs.device)
    counts.index_add_(0, assign, valid.to(torch.int32))
    hist = counts.to(torch.float32)
    if idf is not None:
        hist = hist * idf
    return hist / torch.clamp(torch.sum(hist), min=1e-9)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity in [0, 1]; broadcasts over leading dims of v2."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)
