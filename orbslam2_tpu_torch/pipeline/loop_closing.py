"""Loop closing: detection, Sim3 verification, correction, essential-graph
optimisation and the time-sliced global BA.

Port of `orbslam2_tpu.pipeline.loop_closing` (ORB-SLAM2's LoopClosing
thread): DetectLoop with its covisibility-consistency groups, ComputeSim3,
CorrectLoop and RunGlobalBundleAdjustment, on the solvers of `vocab/` and
`solvers/`. The schedule is the reference's: detection is dispatched when
a keyframe is inserted and finalised on a later frame, one candidate's
verification runs per frame, and a global BA runs `gba_slice_iters`
iterations per frame and is folded back in when done. A verification
reads one number to the host, its brute match count, and stops there
below 20 matches, as ORB-SLAM2's ComputeSim3 discards such a candidate;
the rest of its result is read on the next frame.

The map is updated in place, as everywhere in the port. The RANSAC draws
of the Sim3 verification come from the loop closer's CPU generator
(seeded with `cfg.seed + 7`, the reference's key) through
`horn.draw_sim3_samples`; a test may hand `_verify_candidate` the
reference's sets instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from orbslam2_tpu_torch import profiling
from orbslam2_tpu_torch.config import SlamConfig, Sensor
from orbslam2_tpu_torch.geometry import camera as cam_geo
from orbslam2_tpu_torch.geometry import se3, sim3
from orbslam2_tpu_torch.ops import match
from orbslam2_tpu_torch.pipeline import local_mapping as lm
from orbslam2_tpu_torch.pipeline.tracking import _i64, _top_k
from orbslam2_tpu_torch.slam_map import map_state as ms
from orbslam2_tpu_torch.slam_map.map_state import masked_put_
from orbslam2_tpu_torch.solvers import ba, horn, pose_graph, sim3_opt
from orbslam2_tpu_torch.vocab import bow
from orbslam2_tpu_torch.vocab.database import KeyFrameDatabase, _query


class LoopResult(NamedTuple):
    detected: bool
    matched_kf: int
    num_inliers: int


class DescriptorReservoir:
    """A fixed-capacity uniform sample of the session's ORB descriptors,
    for retraining a session-trained vocabulary on every keyframe seen so
    far (numpy on the host, the reference's own sampler and generator).
    Keyframes queue their descriptors as device copies; they reach the
    sample at the next `sample()`."""

    def __init__(self, cap: int = 32768, seed: int = 0):
        self.cap = cap
        self.buf = np.zeros((cap, 8), np.uint32)
        self.n = 0          # filled slots
        self.n_seen = 0     # total stream length
        self._rng = np.random.default_rng(seed)
        self._queue = []

    def add_deferred(self, descs: torch.Tensor, valid: torch.Tensor):
        # copies: the map's rows change in place when slots are reused
        self._queue.append((descs.clone(), valid.clone()))

    def drain(self):
        q, self._queue = self._queue, []
        for d, v in q:
            self.add(d.cpu().numpy().view(np.uint32), v.cpu().numpy())

    def add(self, descs: np.ndarray, valid: np.ndarray):
        d = np.asarray(descs)[np.asarray(valid)]
        if not len(d):
            return
        free = self.cap - self.n
        take = min(free, len(d))
        if take:
            self.buf[self.n : self.n + take] = d[:take]
            self.n += take
        rest = d[take:]
        self.n_seen += len(d)
        if len(rest):
            # batch reservoir replacement: each survivor lands in a random slot
            keep = self._rng.random(len(rest)) < self.cap / max(self.n_seen, 1)
            rest = rest[keep]
            if len(rest):
                slots = self._rng.integers(0, self.cap, size=len(rest))
                self.buf[slots] = rest

    def sample(self) -> tuple[np.ndarray, np.ndarray]:
        self.drain()
        valid = np.zeros(self.cap, bool)
        valid[: self.n] = True
        return self.buf, valid


# the loop region's capacity (ORB-SLAM2's mvpLoopMapPoints)
MAX_LOOP_POINTS = 4096
# ComputeSim3's first gate: a candidate with fewer brute (SearchByBoW)
# matches is discarded
MIN_BRUTE_MATCHES = 20


def _first_set(flags: torch.Tensor, size: int) -> torch.Tensor:
    """`jnp.nonzero(flags, size=size, fill_value=len(flags))`: the indices
    where `flags` holds, ascending, padded with len(flags). A sort rather
    than `nonzero`, which reads the count back to the host."""
    n = flags.shape[0]
    key = torch.where(flags, torch.arange(n, device=flags.device), n)
    first = torch.sort(key).values[:size]
    if first.shape[0] < size:
        first = torch.cat([first, first.new_full((size - first.shape[0],), n)])
    return first


def _pred_octave(max_dist, dist, scale_factors, num_levels: int):
    ratio = max_dist / torch.clamp(dist, min=1e-9)
    return torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / torch.log(scale_factors[1]))
        .to(torch.int32), 0, num_levels - 1)


def _project(p, K: cam_geo.Intrinsics):
    z = torch.clamp(p[..., 2], min=1e-3)
    return torch.stack([K.fx * p[..., 0] / z + K.cx, K.fy * p[..., 1] / z + K.cy], -1)


# ---------------------------------------------------------------------------
# device-side stages
# ---------------------------------------------------------------------------


def sim3_match_extend(state: ms.MapState, kf1: int, kf2: int, s12, R12, t12,
                      K: cam_geo.Intrinsics, scale_factors, th: float = 7.5,
                      num_levels: int = 8) -> torch.Tensor:
    """SearchBySim3: project KF1's points into KF2's image through S21 and
    KF2's into KF1's through S12, match within th * scale windows, keep
    the mutual agreements. Returns f2_for_f1 [S] (KF2 slot per KF1 slot,
    -1 none)."""
    S = state.kf_xy.shape[1]
    P = state.capacity_mp

    def slot_points(kf):
        pid = state.kf_point_idx[kf]
        pid_c = _i64(torch.clamp(pid, 0, P - 1))
        ok = state.kf_feat_valid[kf] & (pid >= 0) & state.mp_valid[pid_c]
        return pid_c, ok, se3.apply(state.kf_Tcw[kf], state.mp_pos[pid_c])

    def direction(pid_src, ok_src, pc_src, S_map, kf_dst):
        p_in_dst = sim3.apply(S_map, pc_src)
        pred_oct = _pred_octave(state.mp_max_dist[pid_src], torch.linalg.norm(p_in_dst, dim=-1),
                                scale_factors, num_levels)
        res = match.search_by_projection(
            state.mp_desc[pid_src], _project(p_in_dst, K), pred_oct,
            ok_src & (p_in_dst[:, 2] > 0.05),
            state.kf_desc[kf_dst], state.kf_xy[kf_dst], state.kf_octave[kf_dst],
            state.kf_feat_valid[kf_dst], th * scale_factors[_i64(pred_oct)],
            max_dist=match.TH_HIGH, ratio=1.0,
        )
        return res.best_idx

    pid1, ok1, pc1 = slot_points(kf1)
    pid2, ok2, pc2 = slot_points(kf2)
    S12 = (s12, R12, t12)
    best12 = direction(pid1, ok1, pc1, sim3.inverse(S12), kf2)   # KF1 slot -> KF2 slot
    best21 = direction(pid2, ok2, pc2, S12, kf1)                 # KF2 slot -> KF1 slot
    mutual = (best12 >= 0) & (best21[_i64(torch.clamp(best12, 0, S - 1))]
                              == torch.arange(S, device=best12.device))
    return torch.where(mutual, best12, -1)


def build_sim3_pairs(state: ms.MapState, kf1: int, kf2: int, f2_for_f1, level_sigma2):
    """Fixed-shape pair arrays for `optimize_sim3` from per-slot matches:
    (pc1, pc2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, mask)."""
    S = state.kf_xy.shape[1]
    P = state.capacity_mp
    nl = level_sigma2.shape[0]
    f2c = _i64(torch.clamp(f2_for_f1, 0, S - 1))
    pid1 = state.kf_point_idx[kf1]
    pid2 = state.kf_point_idx[kf2][f2c]
    pid1c = _i64(torch.clamp(pid1, 0, P - 1))
    pid2c = _i64(torch.clamp(pid2, 0, P - 1))
    mask = ((f2_for_f1 >= 0) & (pid1 >= 0) & (pid2 >= 0)
            & state.mp_valid[pid1c] & state.mp_valid[pid2c])
    pc1 = se3.apply(state.kf_Tcw[kf1], state.mp_pos[pid1c])
    pc2 = se3.apply(state.kf_Tcw[kf2], state.mp_pos[pid2c])
    inv1 = 1.0 / level_sigma2[_i64(torch.clamp(state.kf_octave[kf1], 0, nl - 1))]
    inv2 = 1.0 / level_sigma2[_i64(torch.clamp(state.kf_octave[kf2][f2c], 0, nl - 1))]
    return pc1, pc2, state.kf_xy[kf1], state.kf_xy[kf2][f2c], inv1, inv2, mask


def gather_loop_points(state: ms.MapState, loop_kf: int, covis_threshold: int = 15,
                       max_loop_points: int = MAX_LOOP_POINTS):
    """The loop region's landmarks: points bound in loop_kf or its
    covisible neighbours (ORB-SLAM2's mvpLoopMapPoints), lowest slot
    first. Returns (ids [M], mask [M])."""
    P = state.capacity_mp
    ids = state.kf_point_idx
    region = (((state.covis[loop_kf] >= covis_threshold) & state.kf_valid)
              | (torch.arange(state.capacity_kf, device=ids.device) == loop_kf))
    flags = torch.zeros(P, dtype=torch.bool, device=ids.device)
    masked_put_(flags, ids, True, region[:, None] & (ids >= 0))
    pts = _first_set(flags & state.mp_valid, max_loop_points)
    return torch.clamp(pts, 0, P - 1).to(torch.int32), pts < P


def guided_projection_count(state: ms.MapState, kf1: int, loop_pts, loop_mask, s_cw, R_cw,
                            t_cw, f2_for_f1, K: cam_geo.Intrinsics, scale_factors,
                            th: float = 10.0, num_levels: int = 8):
    """Project the loop region's landmarks into the current keyframe with
    the corrected similarity Scw and count all matches (ORB-SLAM2
    SearchByProjection(Scw) and its >= 40 acceptance). Returns (count,
    matched point per slot [S])."""
    pc = sim3.apply((s_cw, R_cw, t_cw), state.mp_pos[loop_pts])
    pred_oct = _pred_octave(state.mp_max_dist[loop_pts], torch.linalg.norm(pc, dim=-1),
                            scale_factors, num_levels)
    # match only into slots the Sim3 match set left free
    free = state.kf_feat_valid[kf1] & (f2_for_f1 < 0)
    res = match.search_by_projection(
        state.mp_desc[loop_pts], _project(pc, K), pred_oct, loop_mask & (pc[:, 2] > 0.05),
        state.kf_desc[kf1], state.kf_xy[kf1], state.kf_octave[kf1], free,
        th * scale_factors[_i64(pred_oct)], max_dist=match.TH_LOW, ratio=1.0,
    )
    assigned = res.assigned
    matched_pt = torch.where(
        assigned >= 0, loop_pts[_i64(torch.clamp(assigned, 0, loop_pts.shape[0] - 1))], -1
    ).to(torch.int32)
    count = torch.sum(matched_pt >= 0) + torch.sum(f2_for_f1 >= 0)
    return count, matched_pt


def _discarded(n_brute: int, S: int, device) -> tuple:
    """The outputs of a candidate discarded after the brute match, made
    without a kernel of the chain: the stats (n_brute, 0, 0, 0) as a CPU
    tensor (the host holds them already), and in place of the Sim3, the
    match and guided sets and the loop region the identity, no matches and
    an empty region, at their shapes on the map's device."""
    stats = torch.tensor([n_brute, 0, 0, 0], dtype=torch.int32)
    S12 = torch.zeros(8, device=device)
    S12[:2] = 1.0       # s = 1, q = (1, 0, 0, 0), t = 0
    none = torch.full((S,), -1, dtype=torch.int32, device=device)
    return (stats, S12, none, none.clone(),
            torch.zeros(MAX_LOOP_POINTS, dtype=torch.int32, device=device),
            torch.zeros(MAX_LOOP_POINTS, dtype=torch.bool, device=device))


def _verify_candidate(
    state: ms.MapState,
    kf_id: int,
    cand: int,
    draw: Callable[[torch.Tensor], torch.Tensor],
    K: cam_geo.Intrinsics,
    scale_factors,
    level_sigma2,
    min_inliers: int = 20,
    fix_scale: bool = True,
    covis_threshold: int = 15,
    num_levels: int = 8,
):
    """The ComputeSim3 chain for one candidate: brute match, Sim3 RANSAC,
    SearchBySim3 extension, joint OptimizeSim3, guided projection of the
    loop region with the corrected Scw. `draw` turns the brute match mask
    [S] into the RANSAC's [iters, 3] minimal sets; it is called once for
    every candidate, so that later candidates draw the same sets whether
    this one ran whole or not.

    The brute match's count is the chain's one read to the host. Below 20
    matches the candidate is discarded there, as ORB-SLAM2's ComputeSim3
    discards it after SearchByBoW: nothing past the draw is issued, the
    tracer counts `loop.verify.cut`, and the outputs are `_discarded`'s,
    stats (n_brute, 0, 0, 0). Otherwise the chain runs on with no further
    read, and its later gates (>= min_inliers after optimisation, >= 40
    guided) fold into one `ok` flag; RANSAC's own `success` is not among
    them, as in the reference.

    Returns (stats [4] int32 = (n_brute, n_opt, n_guided, ok), S12 pack
    [8], f2_final [S], guided_pt [S], loop_pts [M], loop_mask [M])."""
    S = state.kf_xy.shape[1]
    P = state.capacity_mp
    with profiling.span("loop.verify.brute"):
        pidc = _i64(torch.clamp(state.kf_point_idx[kf_id], 0, P - 1))
        vc = state.kf_feat_valid[kf_id] & (state.kf_point_idx[kf_id] >= 0) & state.mp_valid[pidc]
        pidk = _i64(torch.clamp(state.kf_point_idx[cand], 0, P - 1))
        vk = state.kf_feat_valid[cand] & (state.kf_point_idx[cand] >= 0) & state.mp_valid[pidk]
        res = match.search_brute(
            state.kf_desc[kf_id], vc, state.kf_angle[kf_id],
            state.kf_desc[cand], vk, state.kf_angle[cand],
            max_dist=match.TH_LOW, ratio=0.75, check_rotation=True,
        )
        n_brute = res.num_matches
        n_read = int(n_brute)
    f2 = res.best_idx
    matched = f2 >= 0
    samples = draw(matched)
    if n_read < MIN_BRUTE_MATCHES:
        profiling.count("loop.verify.cut")
        return _discarded(n_read, S, f2.device)
    f2c = _i64(torch.clamp(f2, 0, S - 1))
    with profiling.span("loop.verify.ransac"):
        s1 = level_sigma2[_i64(torch.clamp(state.kf_octave[kf_id], 0, num_levels - 1))]
        s2 = level_sigma2[_i64(torch.clamp(state.kf_octave[cand][f2c], 0, num_levels - 1))]
        sr = horn.ransac_sim3(
            state.mp_pos[pidc], state.mp_pos[pidk[f2c]], matched,
            state.kf_xy[kf_id], state.kf_xy[cand][f2c], s1, s2,
            state.kf_Tcw[kf_id], state.kf_Tcw[cand], K, samples,
            min_inliers=min_inliers, fix_scale=fix_scale,
        )
    with profiling.span("loop.verify.extend"):
        f2_ext = sim3_match_extend(state, kf_id, cand, sr.s, sr.R, sr.t, K, scale_factors,
                                   num_levels=num_levels)
        f2_all = torch.where(matched & sr.inliers, f2, f2_ext)
    with profiling.span("loop.verify.optimize"):
        pc1, pc2, uv1, uv2, inv1, inv2, pmask = build_sim3_pairs(state, kf_id, cand, f2_all,
                                                                 level_sigma2)
        opt = sim3_opt.optimize_sim3(sr.s, sr.R, sr.t, pc1, pc2, uv1, uv2, inv1, inv2, pmask, K,
                                     fix_scale)
        f2_final = torch.where(opt.inliers, f2_all, -1)
    with profiling.span("loop.verify.guided"):
        S_cw = sim3.compose((opt.s, opt.R, opt.t), sim3.from_se3(state.kf_Tcw[cand]))
        loop_pts, loop_mask = gather_loop_points(state, cand, covis_threshold=covis_threshold)
        count, guided_pt = guided_projection_count(state, kf_id, loop_pts, loop_mask, *S_cw,
                                                   f2_final, K, scale_factors,
                                                   num_levels=num_levels)
    # the reference's strict chain: >= 20 brute matches (held above),
    # >= min_inliers after the joint optimisation, >= 40 guided matches
    ok = (opt.num_inliers >= min_inliers) & (count >= 40)
    stats = torch.stack([x.to(torch.int32) for x in (n_brute, opt.num_inliers, count, ok)])
    return (stats, sim3.pack((opt.s, opt.R, opt.t)), f2_final, guided_pt, loop_pts, loop_mask)


def _propagate_neighborhood(state: ms.MapState, kf_id: int, s12, R12, t12,
                            covis_threshold: int = 15, max_targets: int = 24):
    """CorrectLoop's Sim3 propagation: the corrected S_iw of the current
    keyframe and its covisible neighbourhood. `(s12, R12, t12)` is the
    current keyframe's corrected S_cw.

    Returns (old_pack [K, 8], vert [K, 8] with the corrected entries,
    targets [T], target_ok [T]): the targets are the strongest covisible
    neighbours, the current keyframe first, for SearchAndFuse."""
    Kcap = state.capacity_kf
    old_pack = pose_graph.se3_to_pack(state.kf_Tcw)
    covis_row = state.covis[kf_id]
    idx = torch.arange(Kcap, device=covis_row.device)
    nbh = ((covis_row >= covis_threshold) & state.kf_valid) | (idx == kf_id)
    T_kc = state.kf_Tcw @ se3.inverse(state.kf_Tcw[kf_id])
    corrected = sim3.pack(sim3.compose(sim3.from_se3(T_kc), (s12, R12, t12)))
    vert = torch.where(nbh[:, None], corrected, old_pack)
    score = torch.where(idx == kf_id, 1 << 20, torch.where(nbh, covis_row, -1))
    top, targets = _top_k(score, min(max_targets, Kcap))
    return old_pack, vert, targets.to(torch.int32), top > 0


def _fuse_and_rebuild(state: ms.MapState, loop_pts, loop_mask, targets, target_ok,
                      K: cam_geo.Intrinsics, scale_factors, bounds, num_levels: int = 8):
    """SearchAndFuse over the corrected neighbourhood, then the
    observation tables and the whole covisibility matrix rebuilt from the
    bindings. Returns the number of observations dropped for want of
    slots (0-d)."""
    lm.fuse_points_into_kfs(state, loop_pts, loop_mask, targets, target_ok, K, scale_factors,
                            bounds, num_levels=num_levels)
    truncated = ms.rebuild_observations(state)
    rebuild_covisibility(state)
    return truncated


def build_essential_edges(state: ms.MapState, essential_threshold: int = 100,
                          max_edges: int = 2048):
    """The essential graph's edges: the spanning tree, the strong
    covisibility pairs (weight >= essential_threshold) and past loop
    edges, in row-major (i < j) order. Returns (edge_i, edge_j, meas_pack,
    edge_valid, n_total)."""
    Kcap = state.capacity_kf
    dev = state.covis.device
    iu = torch.arange(Kcap, device=dev)
    upper = iu[:, None] < iu[None, :]
    vv = state.kf_valid[:, None] & state.kf_valid[None, :]
    emask = ((state.covis >= essential_threshold) | state.loop_edges) & upper & vv
    par = state.kf_parent
    par_c = _i64(torch.clamp(par, 0, Kcap - 1))
    has_p = (par >= 0) & state.kf_valid & state.kf_valid[par_c]
    masked_put_(emask, (torch.minimum(par_c, iu), torch.maximum(par_c, iu)), True, has_p)
    n_total = torch.sum(emask)
    eidx = _first_set(emask.reshape(-1), max_edges)
    evalid = eidx < Kcap * Kcap
    eidx = torch.clamp(eidx, 0, Kcap * Kcap - 1)
    ei = torch.div(eidx, Kcap, rounding_mode="floor")
    ej = eidx % Kcap
    rel = state.kf_Tcw[ej] @ se3.inverse(state.kf_Tcw[ei])
    return (ei.to(torch.int32), ej.to(torch.int32), pose_graph.se3_to_pack(rel), evalid,
            n_total)


def _detect_candidates(state: ms.MapState, vectors, present, kf_id: int,
                       covis_threshold: int = 15, max_candidates: int = 8,
                       recent_exclusion: int = 8):
    """DetectLoop's device side: the min score over the covisible
    keyframes, the exclusion of covisible and recent keyframes, the
    database query, and the candidates' covisibility rows for the host's
    consistency grouping. Returns (cand, mask, cand_covis)."""
    Kcap = state.capacity_kf
    covis_row = state.covis[kf_id]
    covisible = (covis_row >= covis_threshold) & state.kf_valid
    vec = vectors[kf_id]
    scores = bow.l1_score(vec, vectors)
    min_score = torch.where(torch.any(covisible),
                            torch.min(torch.where(covisible, scores, torch.inf)), 0.05)
    # "recent" by insertion sequence: slots are recycled
    idx = torch.arange(Kcap, device=vectors.device)
    exclude = covisible | (idx == kf_id) | (state.kf_seq > state.kf_seq[kf_id] - recent_exclusion)
    # a culled keyframe's row may linger until its slot is reused
    cand, mask, _ = _query(vectors, present & state.kf_valid, vec, exclude,
                           torch.clamp(min_score, min=0.01), state.covis, max_candidates)
    return cand, mask, state.covis[_i64(cand)] > 0


def _bow_rows(kf_desc, kf_feat_valid, present, codebook, idf=None):
    """The [K, V] BoW matrix of every present keyframe, all keyframes'
    descriptors assigned in one batch (the reference maps `bow_vector`
    over the rows)."""
    Kn, S = kf_feat_valid.shape
    V = bow.num_words(codebook)
    words = bow.word_ids(kf_desc.reshape(Kn * S, 8), codebook).to(torch.int64)
    rows = torch.arange(Kn, device=words.device).repeat_interleave(S)
    counts = torch.zeros(Kn * V, dtype=torch.int32, device=words.device)
    counts.index_add_(0, rows * V + words, kf_feat_valid.reshape(-1).to(torch.int32))
    hist = counts.view(Kn, V).to(torch.float32)
    if idf is not None:
        hist = hist * idf
    vec = hist / torch.clamp(torch.sum(hist, dim=-1, keepdim=True), min=1e-9)
    return torch.where(present[:, None], vec, 0.0)


def _gba_fold_in(state: ms.MapState, cam_opt, pt_opt, pts, pt_ok, snap_kf_frame_id,
                 snap_kf_valid, snap_mp_first) -> None:
    """Fold a finished global BA into the live map, in place (ORB-SLAM2's
    RunGlobalBundleAdjustment completion): keyframes that were in the
    problem take their optimised pose; keyframes made since keep their
    current pose relative to their parent (walked down the spanning tree);
    points in the problem take their optimised position; every other point
    moves rigidly with its reference keyframe. Slot-identity guards (the
    keyframe's frame id, the point's first keyframe) keep recycled slots
    from taking stale values."""
    Kcap = state.capacity_kf
    P = state.capacity_mp
    old_T = state.kf_Tcw.clone()
    same_kf = state.kf_valid & snap_kf_valid & (state.kf_frame_id == snap_kf_frame_id)
    new_T = torch.where(same_kf[:, None, None], cam_opt, old_T)
    # parents are older than their children, and a global BA spans a few
    # frames: four relaxation passes resolve every chain
    resolved = same_kf
    p = _i64(torch.clamp(state.kf_parent, 0, Kcap - 1))
    T_rel = old_T @ se3.inverse(old_T[p])
    for _ in range(4):
        can = state.kf_valid & ~resolved & (state.kf_parent >= 0) & resolved[p]
        new_T = torch.where(can[:, None, None], T_rel @ new_T[p], new_T)
        resolved = resolved | can

    pts64 = _i64(pts)
    same_pt = state.mp_valid[pts64] & pt_ok & (state.mp_first_kf[pts64] == snap_mp_first)
    opt_full = torch.zeros(P, dtype=torch.bool, device=pts.device)
    masked_put_(opt_full, pts64, True, same_pt)
    ref = _i64(torch.clamp(state.mp_ref_kf, 0, Kcap - 1))
    movable = state.mp_valid & ~opt_full & (state.mp_ref_kf >= 0) & resolved[ref]
    p_new = se3.apply(se3.inverse(new_T[ref]), se3.apply(old_T[ref], state.mp_pos))
    mp_pos = torch.where(movable[:, None], p_new, state.mp_pos)
    masked_put_(mp_pos, pts64, pt_opt, same_pt)
    state.kf_Tcw.copy_(new_T)
    state.mp_pos.copy_(mp_pos)


def rebuild_covisibility(state: ms.MapState) -> None:
    """Recompute the whole covisibility matrix from the observation tables:
    every pair of observers of every valid point votes once (ORB-SLAM2's
    UpdateConnections, map-wide). Integer counts, so the order of the
    additions does not matter."""
    K = state.capacity_kf
    obs = state.mp_obs_kf
    o = torch.where((obs >= 0) & state.mp_valid[:, None], obs, K)
    a = o[:, :, None]
    b = o[:, None, :]
    pair = (a < K) & (b < K) & (a != b)
    cov = torch.zeros((K, K), dtype=torch.int32, device=obs.device)
    masked_put_(cov, (a, b), torch.ones((), dtype=torch.int32, device=obs.device), pair,
                accumulate=True)
    vv = state.kf_valid[:, None] & state.kf_valid[None, :]
    state.covis.copy_(torch.where(vv, cov, 0))


def replace_points(state: ms.MapState, old_ids, new_ids, mask) -> None:
    """Replace landmarks old -> new across the whole map (ORB-SLAM2
    MapPoint::Replace): every keyframe binding of `old` is rebound to
    `new` and `old` is invalidated, where `mask` holds. The observation
    tables must be rebuilt after (`ms.rebuild_observations`)."""
    P = state.capacity_mp
    remap = torch.arange(P, dtype=torch.int32, device=old_ids.device)
    masked_put_(remap, _i64(old_ids), new_ids, mask)
    pid = state.kf_point_idx
    state.kf_point_idx.copy_(torch.where(pid >= 0, remap[_i64(torch.clamp(pid, 0, P - 1))], -1))
    masked_put_(state.mp_valid, _i64(old_ids), False, mask)


class LoopCloser:
    """The loop closer's host side: the keyframe database, the consistency
    groups, the asynchronous detection and verification queue, the
    correction and the time-sliced global BA."""

    def __init__(self, cfg: SlamConfig, K: cam_geo.Intrinsics, codebook, device, log=None,
                 frozen_vocab: bool = False, idf=None):
        self.cfg = cfg
        self.K = K
        self.device = torch.device(device)
        self.codebook = codebook
        # per-word idf weights shipped with the vocabulary (None for a
        # session-trained one)
        self.idf = idf
        self.log = log
        # essential-graph edge capacity; doubles when a correction would
        # drop edges
        self._edge_cap = max(4 * cfg.map.max_keyframes, 512)
        self.db = KeyFrameDatabase(codebook, cfg.map.max_keyframes, idf=idf, device=self.device)
        nl = cfg.orb.num_levels
        sf = cfg.orb.scale_factor
        self.inv_sigma2 = torch.tensor([1.0 / sf ** (2 * i) for i in range(nl)],
                                       dtype=torch.float32, device=self.device)
        self.level_sigma2 = 1.0 / self.inv_sigma2
        self.scale_factors = torch.tensor([sf ** i for i in range(nl)], dtype=torch.float32,
                                          device=self.device)
        self.reservoir = DescriptorReservoir(cap=cfg.vocab.reservoir_cap, seed=cfg.vocab.seed)
        # a shipped vocabulary is frozen: no retraining
        self.frozen_vocab = frozen_vocab
        # the Sim3 RANSAC draws (the reference's PRNGKey(cfg.seed + 7))
        self.generator = torch.Generator().manual_seed(cfg.seed + 7)
        self._kf_count = 0
        self._loop_pts = None
        self._guided_pt = None
        self.edge_truncations = 0   # essential-graph edges dropped by the cap
        self.obs_truncations = 0    # observations dropped for want of slots
        self.last_loop_kf = -1_000
        self.last_loop_seq = -1_000
        # slot -> insertion sequence (slots are recycled)
        self._seq_of: dict[int, int] = {}
        # consistency groups: (set of keyframe ids, count, misses)
        self._consistent_groups: list[tuple[set, int, int]] = []
        self.loops_closed = 0
        # a detection dispatched at keyframe insertion, finalised on a
        # later frame: (kf_id, device results)
        self._pending_detect = None
        # the verification queue: one candidate's _verify_candidate per
        # frame, read on the next
        self._pending_verify = None
        # the time-sliced global BA in flight
        self._gba = None

    @property
    def has_pending(self) -> bool:
        return self._pending_detect is not None or self._pending_verify is not None

    def _draw(self, mask: torch.Tensor) -> torch.Tensor:
        return horn.draw_sim3_samples(mask, int(self.cfg.solver.sim3_ransac_iters),
                                      self.generator)

    # ------------------------------------------------------------------
    def add_keyframe_to_db(self, state: ms.MapState, kf_id: int):
        if not self.frozen_vocab:
            self.reservoir.add_deferred(state.kf_desc[kf_id], state.kf_feat_valid[kf_id])
        self._seq_of[kf_id] = self._kf_count
        self._kf_count += 1
        # a session-trained vocabulary retrains at keyframe-count doublings,
        # so it keeps up with the appearance the session has seen
        if (not self.frozen_vocab and self._kf_count >= 2
                and (self._kf_count & (self._kf_count - 1)) == 0):
            self._retrain_vocabulary(state)
        self.db.add(kf_id, state.kf_desc[kf_id], state.kf_feat_valid[kf_id])

    def _retrain_vocabulary(self, state: ms.MapState):
        """K-medians on the reservoir, the size in power-of-4 buckets of the
        data (two-level beyond 4096 words); every present database row is
        rebuilt with the new codebook, without idf."""
        buf, valid = self.reservoir.sample()
        n = int(valid.sum())
        if n < 256:
            return
        v = 256
        while v * 8 <= n and v * 4 <= self.cfg.vocab.vocab_size:
            v *= 4
        generator = torch.Generator().manual_seed(self.cfg.vocab.seed + self._kf_count)
        descs = torch.from_numpy(buf.view(np.int32)).to(self.device)
        valid_t = torch.from_numpy(valid).to(self.device)
        iters = self.cfg.vocab.train_iters
        if v > 4096:
            self.codebook = bow.train_codebook2(
                descs, valid_t,
                lambda m, size, cell: bow.draw_codebook_seeds(m, size, iters, generator),
                coarse_size=256, fine_size=v // 256, iters=iters)
        else:
            self.codebook = bow.train_codebook(
                descs, valid_t, bow.draw_codebook_seeds(valid_t, v, iters, generator), v, iters)
        present = self.db.present
        self.idf = None
        self.db = KeyFrameDatabase(self.codebook, self.cfg.map.max_keyframes, device=self.device)
        self.db.vectors = _bow_rows(state.kf_desc, state.kf_feat_valid, present, self.codebook)
        self.db.present = present

    # ------------------------------------------------------------------
    def _detect_args(self) -> dict:
        return dict(covis_threshold=self.cfg.map.covis_threshold,
                    max_candidates=int(self.cfg.vocab.max_candidates),
                    recent_exclusion=int(self.cfg.vocab.recent_exclusion))

    @profiling.spanned("loop.detect_dispatch")
    def dispatch_detect(self, state: ms.MapState, kf_id: int) -> bool:
        """Run DetectLoop's device side for this keyframe; its host side
        (`finalize_detect`) runs on a later frame. Returns True when a
        detection is now pending."""
        seq = self._seq_of.get(kf_id, self._kf_count - 1)
        if seq < self.last_loop_seq + 10 or seq < 10:
            return False
        handles = _detect_candidates(state, self.db.vectors, self.db.present, kf_id,
                                     **self._detect_args())
        self._pending_detect = (kf_id, handles)
        return True

    def process_async(self, state: ms.MapState) -> tuple[ms.MapState, Optional[LoopResult]]:
        """Advance the asynchronous machinery by one step per frame: read a
        pending Sim3 verification (which may correct), else a pending
        detection (which may queue verifications)."""
        if self._pending_verify is not None:
            return self._poll_verify(state)
        if self._pending_detect is not None:
            return self.finalize_detect(state)
        return state, None

    def finalize_detect(self, state: ms.MapState) -> tuple[ms.MapState, Optional[LoopResult]]:
        """Read the pending detection, group its candidates, and queue the
        ones consistent over 3 keyframes for verification."""
        kf_id, handles = self._pending_detect
        self._pending_detect = None
        accepted = self._group_candidates(kf_id, handles)
        if accepted and self._pending_verify is None:
            self._pending_verify = {
                "kf_id": kf_id,
                "seq": self._seq_of.get(kf_id, -1),
                "cands": [int(c) for c in accepted],
                "cand_seqs": [self._seq_of.get(int(c), -1) for c in accepted],
                "idx": 0,
                "handles": None,
            }
            self._dispatch_next_verify(state)
        elif accepted:
            # a verification chain is in flight; these candidates drop
            profiling.count("loop.candidates_dropped", len(accepted))
            if self.log is not None:
                self.log.emit("loop_verify_busy", kf_id=int(kf_id), n_dropped=len(accepted))
        return state, None

    def _dispatch_next_verify(self, state: ms.MapState):
        pv = self._pending_verify
        profiling.count("loop.verify.dispatched")
        pv["handles"] = self._run_verify(state, pv["kf_id"], pv["cands"][pv["idx"]])

    def _poll_verify(self, state: ms.MapState) -> tuple[ms.MapState, Optional[LoopResult]]:
        """Read the in-flight verification: correct on success, else
        dispatch the next queued candidate."""
        pv = self._pending_verify
        kf_id = pv["kf_id"]
        cand = pv["cands"][pv["idx"]]
        stats_d, S12_pack, f2_final, guided_pt, loop_pts, loop_mask = pv["handles"]
        with profiling.span("loop.verify_read", kf_id=int(kf_id), cand=int(cand)):
            n_brute, n_opt, n_guided, ok = stats_d.tolist()
        # either slot culled and recycled meanwhile: the result is stale
        stale = (self._seq_of.get(kf_id, -1) != pv["seq"]
                 or self._seq_of.get(cand, -1) != pv["cand_seqs"][pv["idx"]])
        if ok and not stale:
            # culled but not yet recycled: invisible to _seq_of
            with profiling.span("loop.verify_read", kf_id=int(kf_id), cand=int(cand)):
                stale = not all(state.kf_valid[[kf_id, cand]].tolist())
        self._count_outcome(n_brute, n_opt, ok, stale)
        if ok and not stale:
            self._pending_verify = None
            # points may have died since the dispatch: gate on the live map
            loop_mask = loop_mask & state.mp_valid[_i64(loop_pts)]
            gp_c = _i64(torch.clamp(guided_pt, 0, state.capacity_mp - 1))
            self._guided_pt = torch.where((guided_pt >= 0) & state.mp_valid[gp_c], guided_pt, -1)
            self._loop_pts = (loop_pts, loop_mask)
            # f2_final is not re-gated, as in the reference
            state = self.correct_loop(state, kf_id, cand, sim3.unpack(S12_pack), matches=f2_final)
            return state, LoopResult(True, cand, n_opt)
        if self.log is not None and not stale:
            self.log.emit("loop_sim3_fail", kf_id=int(kf_id), cand=int(cand), num_inliers=n_opt,
                          n_brute=n_brute, n_guided=n_guided)
        pv["idx"] += 1
        if stale or pv["idx"] >= len(pv["cands"]):
            self._pending_verify = None
        else:
            self._dispatch_next_verify(state)
        return state, None

    def detect(self, state: ms.MapState, kf_id: int) -> list[int]:
        """DetectLoop, synchronous."""
        seq = self._seq_of.get(kf_id, self._kf_count - 1)
        if seq < self.last_loop_seq + 10 or seq < 10:
            return []
        handles = _detect_candidates(state, self.db.vectors, self.db.present, kf_id,
                                     **self._detect_args())
        return self._group_candidates(kf_id, handles)

    def _group_candidates(self, kf_id: int, handles) -> list[int]:
        """DetectLoop's host side: covisibility consistency over
        consecutive keyframes. Returns at most 6 accepted candidates, best
        accumulated score first."""
        cand_d, mask_d, covis_d = handles
        with profiling.span("loop.detect_read", kf_id=int(kf_id)):
            cand, mask = cand_d.tolist(), mask_d.tolist()
            cand_covis = covis_d.cpu().numpy()
        profiling.count("loop.detections")
        cands = [c for c, m in zip(cand, mask) if m]
        th = self.cfg.vocab.covisibility_consistency_th
        new_groups: list[tuple[set, int, int]] = []
        accepted: list[int] = []
        matched_prev = [False] * len(self._consistent_groups)
        for row, c in zip(cand_covis, cand):
            if c not in cands:
                continue
            group = {c} | set(np.nonzero(row)[0].tolist())
            count = 0
            for gi, (prev_group, prev_count, _) in enumerate(self._consistent_groups):
                if group & prev_group:
                    count = max(count, prev_count + 1)
                    matched_prev[gi] = True
            new_groups.append((group, count, 0))
            if count >= th:
                accepted.append(c)
        # the optional miss grace (off by default: the reference resets a
        # group the moment it skips a keyframe)
        grace = self.cfg.vocab.consistency_miss_grace
        if grace > 0:
            for (pg, pc, pm), m in zip(self._consistent_groups, matched_prev):
                if not m and pm < grace:
                    new_groups.append((pg, pc, pm + 1))
        self._consistent_groups = new_groups
        if self.log is not None and cands:
            seq_cur = self._seq_of.get(kf_id)
            self.log.emit(
                "loop_detect", kf_id=int(kf_id), n_candidates=len(cands),
                n_accepted=len(accepted), max_count=max((g[1] for g in new_groups), default=0),
                cands=cands, cand_seq=[int(self._seq_of.get(c, -1)) for c in cands],
                kf_seq=int(seq_cur) if seq_cur is not None else -1,
            )
        profiling.count("loop.candidates", len(accepted[:6]))
        return accepted[:6]

    # ------------------------------------------------------------------
    def _run_verify(self, state: ms.MapState, kf_id: int, cand: int, draw=None):
        """The ComputeSim3 chain for one candidate (`_verify_candidate`: one
        host read, and a stop below 20 brute matches); `draw` defaults to
        the loop closer's own RANSAC draws."""
        with profiling.span("loop.verify", kf_id=int(kf_id), cand=int(cand)):
            return _verify_candidate(
                state, kf_id, cand, draw or self._draw, self.K, self.scale_factors,
                self.level_sigma2,
                min_inliers=int(self.cfg.solver.sim3_min_inliers),
                fix_scale=self.cfg.sensor != Sensor.MONOCULAR,
                covis_threshold=int(self.cfg.map.covis_threshold),
                num_levels=int(self.cfg.orb.num_levels),
            )

    def _count_outcome(self, n_brute: int, n_opt: int, ok: bool, stale: bool) -> None:
        """The tracer's count of a verification read: accepted, stale, or
        rejected at the first of the chain's gates it failed."""
        if stale:
            profiling.count("loop.verify.stale")
        elif ok:
            profiling.count("loop.verify.accepted")
        elif n_brute < MIN_BRUTE_MATCHES:
            profiling.count("loop.verify.rejected.brute")
        elif n_opt < int(self.cfg.solver.sim3_min_inliers):
            profiling.count("loop.verify.rejected.opt")
        else:
            profiling.count("loop.verify.rejected.guided")

    def compute_sim3(self, state: ms.MapState, kf_id: int, cand: int):
        """ComputeSim3 for one candidate, synchronous. Returns (success,
        (s, R, t) candidate-cam -> current-cam, n_inliers, f2_for_f1,
        guided matches)."""
        profiling.count("loop.verify.dispatched")
        stats_d, S12_pack, f2_final, guided_pt, loop_pts, loop_mask = \
            self._run_verify(state, kf_id, cand)
        with profiling.span("loop.verify_read", kf_id=int(kf_id), cand=int(cand)):
            n_brute, n_opt, n_guided, ok = stats_d.tolist()
        self._count_outcome(n_brute, n_opt, ok, False)
        if not ok:
            # the deepest gate reached
            return False, None, (n_opt if n_brute >= MIN_BRUTE_MATCHES else 0), None, n_guided
        self._loop_pts = (loop_pts, loop_mask)
        self._guided_pt = guided_pt
        return True, sim3.unpack(S12_pack), n_opt, f2_final, n_guided

    def warmup_correction(self, state: ms.MapState):
        """Run the whole correction chain once on a throwaway copy of the
        map and discard every result: a degenerate self-match through the
        Sim3 verification (keyframe 0 against itself, which passes the
        brute gate), `correct_loop` and the global-BA slices with their
        fold-in (the reference's `warmup_correction`, which compiles the
        same chain). What it moves off the tracking path is first-use
        cost: the first `torch.func` transform of a process imports
        `torch._dynamo`, `torch.distributed.tensor` and sympy (about 3 s on
        the host), and the card loads each new kernel at its first launch.
        The loop closer's draws, counters, log and the map are untouched."""
        iters = int(self.cfg.solver.sim3_ransac_iters)
        scratch = torch.Generator().manual_seed(0)
        _, _, _, _, loop_pts, loop_mask = self._run_verify(
            state, 0, 0, draw=lambda m: horn.draw_sim3_samples(m, iters, scratch))
        throwaway = ms.MapState(**{f.name: getattr(state, f.name).clone()
                                   for f in dataclasses.fields(state)})
        saved = (self.log, self.loops_closed, self.edge_truncations, self.obs_truncations,
                 self.last_loop_kf, self.last_loop_seq, self._gba, self._edge_cap)
        self.log = None
        try:
            self._loop_pts = (loop_pts, loop_mask)
            S = state.kf_desc.shape[1]
            dev = state.kf_valid.device
            self.correct_loop(throwaway, 0, 0, sim3.identity(device=dev),
                              matches=torch.full((S,), -1, dtype=torch.int32, device=dev))
            while self._gba is not None:
                self.step_gba_async(throwaway)
        finally:
            (self.log, self.loops_closed, self.edge_truncations, self.obs_truncations,
             self.last_loop_kf, self.last_loop_seq, self._gba, self._edge_cap) = saved
            self._loop_pts = None
            self._guided_pt = None

    # ------------------------------------------------------------------
    @profiling.spanned("loop.correct")
    def correct_loop(self, state: ms.MapState, kf_id: int, loop_kf: int, S12,
                     run_global_ba: bool = True, matches=None) -> ms.MapState:
        """CorrectLoop, in place: propagate the corrected Sim3 through the
        current neighbourhood, optimise the essential graph, write the
        poses back and remap the landmarks, replace the duplicated
        landmarks, SearchAndFuse, rebuild, then start the global BA."""
        Kcap = state.capacity_kf
        dev = state.kf_valid.device
        s12, R12, t12 = S12
        # the corrected current pose: S_cw = S_12 o S_2w (candidate = 2)
        S_cw_corr = sim3.compose((s12, R12, t12), sim3.from_se3(state.kf_Tcw[loop_kf]))
        old_pack, vert, fuse_targets, fuse_ok = _propagate_neighborhood(
            state, kf_id, *S_cw_corr, covis_threshold=int(self.cfg.map.covis_threshold),
            max_targets=24)

        # the essential graph's edges; the cap doubles rather than drop
        # edges (the count is read on the host, as in the reference)
        while True:
            ei, ej, meas, evalid, n_total = build_essential_edges(
                state, essential_threshold=self.cfg.map.essential_threshold,
                max_edges=self._edge_cap)
            n_total = int(n_total)
            if n_total <= self._edge_cap or self._edge_cap >= Kcap * Kcap:
                break
            if self.log is not None:
                self.log.emit("warn_edge_truncation", kf_id=int(kf_id), n_edges=n_total,
                              cap=self._edge_cap)
            self._edge_cap = min(self._edge_cap * 2, Kcap * Kcap)
        if n_total > self._edge_cap:
            self.edge_truncations += n_total - self._edge_cap
        # the measured loop edge S_cur<-loop = S12 last, with weight 5
        ei = torch.cat([ei, torch.full((1,), loop_kf, dtype=torch.int32, device=dev)])
        ej = torch.cat([ej, torch.full((1,), kf_id, dtype=torch.int32, device=dev)])
        meas = torch.cat([meas, sim3.pack((s12, R12, t12))[None]])
        weights = torch.cat([torch.where(evalid, 1.0, 0.0), torch.full((1,), 5.0, device=dev)])
        evalid = torch.cat([evalid, torch.ones(1, dtype=torch.bool, device=dev)])
        slots = torch.arange(Kcap, device=dev)
        fixed = (slots == loop_kf) | (slots == 0)
        prob = pose_graph.PoseGraphProblem(
            vertices=vert, vertex_valid=state.kf_valid, vertex_fixed=fixed, edge_i=ei,
            edge_j=ej, edge_meas=meas, edge_valid=evalid, edge_weight=weights)
        sc = self.cfg.solver
        if Kcap > sc.pose_graph_dense_max_k:
            new_pack = pose_graph.optimize_pose_graph_pcg(prob, iters=sc.pose_graph_iters,
                                                          cg_iters=sc.pose_graph_cg_iters)
        else:
            new_pack = pose_graph.optimize_pose_graph(prob, iters=sc.pose_graph_iters)

        # write back the poses, remap the landmarks
        new_pts = pose_graph.remap_points(state.mp_pos, state.mp_ref_kf, old_pack, new_pack)
        state.mp_pos.copy_(torch.where(state.mp_valid[:, None], new_pts, state.mp_pos))
        state.kf_Tcw.copy_(torch.where(state.kf_valid[:, None, None],
                                       pose_graph.pack_to_se3(new_pack), state.kf_Tcw))
        pair = torch.stack([ms.kf_index(kf_id, dev), ms.kf_index(loop_kf, dev)])
        state.loop_edges.index_put_((pair.flatten(), pair.flip(0).flatten()),
                                    torch.ones(2, dtype=torch.bool, device=dev))

        # duplicated landmarks: the current keyframe's matched and guided
        # points duplicate loop-side ones; the older (loop) point wins
        if matches is not None:
            P = state.capacity_mp
            pid1 = state.kf_point_idx[kf_id].clone()
            S = pid1.shape[0]
            new_pair = state.kf_point_idx[loop_kf][_i64(torch.clamp(matches, 0, S - 1))]
            pair_ok = (matches >= 0) & (pid1 >= 0) & (new_pair >= 0) & (new_pair != pid1)
            guided = (self._guided_pt if self._guided_pt is not None
                      else torch.full((S,), -1, dtype=torch.int32, device=dev))
            g_rep = (guided >= 0) & (pid1 >= 0) & (guided != pid1) & ~pair_ok
            g_bind = (guided >= 0) & (pid1 < 0)
            old = torch.where(pair_ok | g_rep, pid1, -1)
            new = torch.where(pair_ok, new_pair, torch.where(g_rep, guided, -1))
            replace_points(state, torch.clamp(old, 0, P - 1), torch.clamp(new, 0, P - 1),
                           (old >= 0) & (new >= 0))
            # bind the guided loop points into the current keyframe's free
            # slots
            row = state.kf_point_idx[kf_id]
            row.copy_(torch.where(g_bind, guided, row))

        # SearchAndFuse, the observation tables and the covisibility
        if self._loop_pts is not None:
            loop_pts, loop_mask = self._loop_pts
        else:
            loop_pts = torch.zeros(4096, dtype=torch.int64, device=dev)
            loop_mask = torch.zeros(4096, dtype=torch.bool, device=dev)
        truncated = int(_fuse_and_rebuild(state, loop_pts, loop_mask, fuse_targets, fuse_ok,
                                          self.K, self.scale_factors, self._image_bounds(),
                                          num_levels=self.cfg.orb.num_levels))
        if truncated and self.log is not None:
            self.log.emit("warn_obs_truncation", kf_id=int(kf_id), n_dropped=truncated,
                          obs_slots=int(state.obs_slots))
        self.obs_truncations += truncated

        # global BA, time-sliced by default; a correction during one
        # aborts it and starts a fresh snapshot
        if run_global_ba:
            if sc.gba_async:
                if self._gba is not None and self.log is not None:
                    self.log.emit("gba_aborted", kf_id=int(kf_id), iters_done=self._gba["done"])
                self._gba = None
                self.start_gba_async(state)
            else:
                self.global_ba(state)
        self.last_loop_kf = kf_id
        self.last_loop_seq = self._seq_of.get(kf_id, self._kf_count - 1)
        self.loops_closed += 1
        self._loop_pts = None
        self._guided_pt = None
        return state

    def _image_bounds(self):
        cam = self.cfg.camera
        return (0.0, float(cam.width), 0.0, float(cam.height))

    # ------------------------------------------------------------------
    def _global_problem(self, state: ms.MapState):
        return lm.build_global_ba_problem(state, self.inv_sigma2,
                                          max_points=self.cfg.map.max_points,
                                          obs_slots=state.obs_slots)

    def global_ba(self, state: ms.MapState) -> None:
        """Full-map BA in one call (ORB-SLAM2 GlobalBundleAdjustment), in
        place."""
        prob, cam_ids, cam_present, pts, pt_ok = self._global_problem(state)
        res = ba.bundle_adjust(prob, self.K, iters=self.cfg.solver.global_ba_iters,
                               use_kernel=True)
        lm.writeback_local_ba(state, res, prob, cam_ids, cam_present, pts, pt_ok)

    def start_gba_async(self, state: ms.MapState):
        """Snapshot the full-map BA problem and begin time-sliced solving:
        every tensor the slices and the fold-in read is a copy, since the
        map keeps changing in place while they run."""
        prob, _, _, pts, pt_ok = self._global_problem(state)
        self._gba = {
            "prob": prob,
            "pts": pts,
            "pt_ok": pt_ok,
            "cam": prob.cam_Tcw,
            "pt_pos": prob.points,
            "lam": torch.full((), 1e-4, dtype=torch.float32, device=state.kf_Tcw.device),
            "done": 0,
            "snap_kf_frame_id": state.kf_frame_id.clone(),
            "snap_kf_valid": state.kf_valid.clone(),
            "snap_mp_first": state.mp_first_kf[_i64(pts)],
        }
        if self.log is not None:
            self.log.emit("gba_start", total_iters=self.cfg.solver.global_ba_iters)

    @profiling.spanned("gba.step")
    def step_gba_async(self, state: ms.MapState) -> tuple[ms.MapState, bool]:
        """Run one slice of the global BA in flight. Returns (state,
        folded): folded is True when the last slice ran and the result was
        folded into the map (poses moved globally: the caller re-anchors
        tracking as after a loop correction)."""
        g = self._gba
        if g is None:
            return state, False
        sc = self.cfg.solver
        n = min(sc.gba_slice_iters, sc.global_ba_iters - g["done"])
        g["cam"], g["pt_pos"], g["lam"], _ = ba.bundle_adjust_slice(
            g["prob"], self.K, g["cam"], g["pt_pos"], g["lam"], iters=n, use_kernel=True)
        g["done"] += n
        if g["done"] < sc.global_ba_iters:
            return state, False
        _gba_fold_in(state, g["cam"], g["pt_pos"], g["pts"], g["pt_ok"], g["snap_kf_frame_id"],
                     g["snap_kf_valid"], g["snap_mp_first"])
        self._gba = None
        if self.log is not None:
            self.log.emit("gba_folded", total_iters=sc.global_ba_iters)
        return state, True

    def abort_gba(self):
        self._gba = None

    # ------------------------------------------------------------------
    def process_keyframe(self, state: ms.MapState,
                         kf_id: int) -> tuple[ms.MapState, Optional[LoopResult]]:
        """A whole loop-closing iteration for one keyframe, synchronous."""
        self.add_keyframe_to_db(state, kf_id)
        for c in self.detect(state, kf_id):
            okay, S12, n_inl, f2_final, _ = self.compute_sim3(state, kf_id, c)
            if okay:
                state = self.correct_loop(state, kf_id, c, S12, matches=f2_final)
                return state, LoopResult(True, c, n_inl)
        return state, None
