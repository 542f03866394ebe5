"""Place-recognition scoring with the keyframe database's rows sharded
over a process group.

Port of `orbslam2_tpu.parallel.sharded_bow`. Each rank scores the query
against its block of database rows and accumulates the covisibility
groups of those rows; two all-gathers of packed [K/n, 2] rows (scores with
their admission flags, then group scores with their representatives) give
every rank what the 0.75-of-best selection needs, and the selection runs
on every rank. The steps are `vocab.database._query`'s own
(`group_scores` on the local rows, `candidates` on all of them), so the
semantics and the tie-breaking are too.
"""

from __future__ import annotations

import torch

from orbslam2_tpu_torch.parallel import group
from orbslam2_tpu_torch.vocab import bow, database


def sharded_query(vectors, present, vec, exclude_mask, min_score, covis,
                  max_candidates: int = 8):
    """Row-sharded loop / relocalization candidate query, called in every
    rank of the group with the whole database (`vectors` [K, V], `present`
    [K], `exclude_mask` [K], `covis` [K, K]; K a multiple of the group
    size). Returns (cand_ids [C] int32, cand_mask [C], scores [K]) on every
    rank."""
    mine = group.rows(vectors.shape[0])
    scores_l = bow.l1_score(vec, vectors[mine])
    ok_l = present[mine] & ~exclude_mask[mine] & (scores_l >= min_score)
    g1 = group.all_gather(torch.stack([ok_l.to(torch.float32), scores_l], dim=1))
    ok, scores = g1[:, 0] > 0.5, g1[:, 1]
    rows = torch.arange(mine.start, mine.stop, device=vectors.device)
    acc_l, rep_l = database.group_scores(ok, scores, covis[mine], rows)
    # a keyframe index is exact in float32 for any database size here
    g2 = group.all_gather(torch.stack([acc_l, rep_l.to(torch.float32)], dim=1))
    return (*database.candidates(ok, g2[:, 0], g2[:, 1].to(torch.int64), max_candidates),
            scores)
