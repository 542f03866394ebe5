"""Keyframe database: a BoW row per keyframe, and loop / relocalization
queries.

Port of `orbslam2_tpu.vocab.database` (ORB-SLAM2's KeyFrameDatabase): the
whole database is one dense [K, V] matrix and a query scores every
keyframe at once; the min-score gate and the covisibility-group
accumulation of DetectLoopCandidates are masked reductions. Ties are
ordered as the reference orders them (`lax.top_k` and `argsort` put the
lower index first): every sort here is stable.
"""

from __future__ import annotations

import torch

from orbslam2_tpu_torch.vocab import bow


class KeyFrameDatabase:
    """Owns the device-side [K, V] BoW matrix."""

    def __init__(self, codebook, max_keyframes: int, idf=None, device=None):
        self.codebook = codebook
        self.idf = idf          # [V] tf-idf weights (None = tf only)
        V = bow.num_words(codebook)
        self.vectors = torch.zeros((max_keyframes, V), dtype=torch.float32, device=device)
        self.present = torch.zeros((max_keyframes,), dtype=torch.bool, device=device)

    def add(self, kf_id: int, descs, valid) -> torch.Tensor:
        """Compute and store the keyframe's BoW row; returns the vector."""
        v = bow.bow_vector(descs, valid, self.codebook, self.idf)
        self.vectors[kf_id] = v
        self._set_present(kf_id, True)
        return v

    def erase(self, kf_id: int):
        self._set_present(kf_id, False)

    def _set_present(self, kf_id: int, value: bool):
        # the value made on the device: a Python scalar written through an
        # index is copied from the host, and the copy waits for the card
        idx = torch.full((1,), kf_id, device=self.present.device)
        self.present.index_put_((idx,), torch.full((1,), value, device=self.present.device))

    def query(self, vec, exclude_mask, min_score: float, covis, max_candidates: int = 8):
        return _query(self.vectors, self.present, vec, exclude_mask, min_score, covis,
                      max_candidates)


def _query(vectors, present, vec, exclude_mask, min_score, covis, max_candidates: int = 8):
    """Loop / relocalization candidates (ORB-SLAM2 DetectLoopCandidates):

    1. score the query against every present, non-excluded keyframe;
    2. keep scores >= min_score;
    3. accumulate each candidate's score over its covisibility group: the
       candidate and those of its top-10 covisible neighbours that scored;
    4. a group is represented by its best-scoring member; return the
       representatives of groups whose accumulated score reaches 0.75 of
       the best group's, best first.

    Returns (cand_ids [C] int32, cand_mask [C], scores [K])."""
    K = vectors.shape[0]
    dev = vectors.device
    scores = bow.l1_score(vec, vectors)
    ok = present & ~exclude_mask & (scores >= min_score)
    scores_ok = torch.where(ok, scores, 0.0)
    ng = min(10, K)
    top_w, top_idx = torch.sort(covis, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :ng], top_idx[:, :ng]
    neigh_ok = ok[top_idx] & (top_w > 0)
    neigh_scores = torch.where(neigh_ok, scores[top_idx], 0.0)
    acc = scores_ok + neigh_scores.sum(-1)
    # group representative = the best-scoring member (first on ties)
    best_n = torch.argmax(neigh_scores, dim=-1)
    best_n_score = torch.gather(neigh_scores, 1, best_n[:, None])[:, 0]
    rows = torch.arange(K, device=dev)
    rep = torch.where(best_n_score > scores_ok, top_idx[rows, best_n], rows)
    acc = torch.where(ok, acc, -1.0)
    best = torch.max(acc)
    admit_group = ok & (acc >= 0.75 * best) & (best > 0)
    # several groups may elect the same representative: keep the max
    # accumulated score per representative
    rep_w = torch.where(admit_group, rep, K)
    rep_acc = torch.full((K + 1,), -torch.inf, device=dev).scatter_reduce(
        0, rep_w, torch.where(admit_group, acc, -torch.inf), "amax", include_self=True)[:K]
    admit = rep_acc > -torch.inf
    order = torch.sort(torch.where(admit, -rep_acc, torch.inf), stable=True).indices
    cand = order[:max_candidates]
    return cand.to(torch.int32), admit[cand], scores
