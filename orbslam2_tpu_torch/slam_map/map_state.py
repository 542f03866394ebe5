"""The SLAM map as a device-resident struct of tensors.

Port of `orbslam2_tpu.slam_map.map_state`: fixed-capacity masked arrays for
keyframes and map points, a padded per-point observation table,
per-keyframe feature-to-point bindings and a dense covisibility matrix,
with the maintenance functions local mapping uses.

State is updated IN PLACE: the functions here write into the tensors of
the `MapState` they are given, where the reference returns a new pytree and
donates the old one (`donate_argnums`) so XLA can reuse its buffers.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from orbslam2_tpu_torch.config import MapConfig, OrbConfig
from orbslam2_tpu_torch.ops import hamming


@dataclasses.dataclass
class MapState:
    # --- keyframes [K, ...] ---
    kf_Tcw: torch.Tensor          # [K, 4, 4]
    kf_valid: torch.Tensor        # [K] bool
    kf_frame_id: torch.Tensor     # [K] int32 source frame index
    kf_xy: torch.Tensor           # [K, S, 2] undistorted keypoint coords
    kf_ur: torch.Tensor           # [K, S] right-x coord (<0 mono)
    kf_depth: torch.Tensor        # [K, S] keypoint depth (<0 unknown)
    kf_octave: torch.Tensor       # [K, S] int32
    kf_angle: torch.Tensor        # [K, S]
    kf_desc: torch.Tensor         # [K, S, 8] int32 (uint32 bits)
    kf_feat_valid: torch.Tensor   # [K, S] bool
    kf_point_idx: torch.Tensor    # [K, S] int32 -> map point, -1 unbound
    kf_parent: torch.Tensor       # [K] int32 spanning-tree parent (-1 root)
    kf_seq: torch.Tensor          # [K] int32 insertion sequence number
    # --- map points [P, ...] ---
    mp_pos: torch.Tensor          # [P, 3]
    mp_valid: torch.Tensor        # [P] bool
    mp_desc: torch.Tensor         # [P, 8] int32 representative descriptor
    mp_normal: torch.Tensor       # [P, 3] mean viewing direction
    mp_min_dist: torch.Tensor     # [P] scale-invariance band lower
    mp_max_dist: torch.Tensor     # [P] upper
    mp_ref_kf: torch.Tensor       # [P] int32
    mp_first_kf: torch.Tensor     # [P] int32 creating keyframe's seq number
    mp_n_obs: torch.Tensor        # [P] int32 (stereo counts 2)
    mp_visible: torch.Tensor      # [P] int32 tracking visibility counter
    mp_found: torch.Tensor        # [P] int32 tracking found counter
    mp_obs_kf: torch.Tensor       # [P, O] int32 observing keyframe ids, -1 hole
    mp_obs_feat: torch.Tensor     # [P, O] int32 feature slot in that KF
    # --- graphs ---
    covis: torch.Tensor           # [K, K] int32 shared-point counts
    loop_edges: torch.Tensor      # [K, K] bool
    # --- counters (0-d) ---
    num_kf: torch.Tensor          # int32 keyframes ever inserted (monotonic)
    num_mp: torch.Tensor          # int32 allocated point slots

    @property
    def capacity_kf(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def capacity_mp(self) -> int:
        return self.mp_valid.shape[0]

    @property
    def obs_slots(self) -> int:
        return self.mp_obs_kf.shape[1]


def masked_put_(arr: torch.Tensor, index, values, mask, accumulate: bool = False) -> None:
    """In place: ``arr[index] = values`` (``+=`` with `accumulate`) where
    `mask` holds and the index is in range. `index` is a tensor or a tuple
    of tensors over the leading dimensions; index, values and mask
    broadcast together.

    The counterpart of the reference's ``.at[i].set(v, mode="drop")`` with an
    out-of-range sentinel for the entries to skip: they go to a scratch row
    past the end of a copy, so no index set is read back to the host (a
    `nonzero` would wait for the card). Duplicate selected indices have no
    defined winner, as in the reference; callers that need one arbitrate
    first."""
    index = index if isinstance(index, tuple) else (index,)
    *index, mask = torch.broadcast_tensors(*index, mask)
    lead = arr.shape[: len(index)]
    n = math.prod(lead)
    lin = torch.zeros_like(mask, dtype=torch.int64)
    for i, size in zip(index, lead):
        mask = mask & (i >= 0) & (i < size)
        lin = lin * size + i.to(torch.int64)
    lin = torch.where(mask, lin, n)
    if torch.is_tensor(values):
        values = values.to(arr.dtype)
    else:  # a fill on the card, not a copy from the host
        values = torch.full((), values, dtype=arr.dtype, device=arr.device)
    flat = arr.view((n,) + arr.shape[len(index):])
    buf = torch.cat([flat, flat[:1]])
    buf.index_put_((lin,), values, accumulate=accumulate)
    flat.copy_(buf[:n])


def kf_index(k, device) -> torch.Tensor:
    """A keyframe id as a one-element int64 tensor on `device`. Indexing
    with a 0-d tensor reads it on the host; with a [1] tensor it does not,
    so ids chosen on the card (neighbours, targets) stay there."""
    if torch.is_tensor(k):
        return k.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), int(k), dtype=torch.int64, device=device)


def allocate(map_cfg: MapConfig, orb_cfg: OrbConfig, device, obs_slots: int = 16) -> MapState:
    K = map_cfg.max_keyframes
    P = map_cfg.max_points
    S = orb_cfg.feature_slots
    O = obs_slots
    f32, i32 = torch.float32, torch.int32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return MapState(
        kf_Tcw=torch.eye(4, dtype=f32, device=device).repeat(K, 1, 1),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_xy=full((K, S, 2), 0.0, f32),
        kf_ur=full((K, S), -1.0, f32),
        kf_depth=full((K, S), -1.0, f32),
        kf_octave=full((K, S), 0, i32),
        kf_angle=full((K, S), 0.0, f32),
        kf_desc=full((K, S, 8), 0, i32),
        kf_feat_valid=full((K, S), False, torch.bool),
        kf_point_idx=full((K, S), -1, i32),
        kf_parent=full((K,), -1, i32),
        kf_seq=full((K,), -1, i32),
        mp_pos=full((P, 3), 0.0, f32),
        mp_valid=full((P,), False, torch.bool),
        mp_desc=full((P, 8), 0, i32),
        mp_normal=full((P, 3), 0.0, f32),
        mp_min_dist=full((P,), 0.0, f32),
        mp_max_dist=full((P,), 0.0, f32),
        mp_ref_kf=full((P,), -1, i32),
        mp_first_kf=full((P,), -1, i32),
        mp_n_obs=full((P,), 0, i32),
        mp_visible=full((P,), 1, i32),
        mp_found=full((P,), 1, i32),
        mp_obs_kf=full((P, O), -1, i32),
        mp_obs_feat=full((P, O), -1, i32),
        covis=full((K, K), 0, i32),
        loop_edges=full((K, K), False, torch.bool),
        num_kf=full((), 0, i32),
        num_mp=full((), 0, i32),
    )


# ---------------------------------------------------------------------------
# keyframe insertion
# ---------------------------------------------------------------------------


def add_keyframe(
    state: MapState,
    frame_id: int,
    Tcw: torch.Tensor,
    xy: torch.Tensor,
    ur: torch.Tensor,
    depth: torch.Tensor,
    octave: torch.Tensor,
    angle: torch.Tensor,
    desc: torch.Tensor,
    feat_valid: torch.Tensor,
    point_idx: torch.Tensor,
) -> int:
    """Write a new keyframe into the first free slot; bind its pre-matched
    points (point_idx[s] >= 0), append observations, refresh its
    covisibility row and pick its spanning-tree parent (strongest
    covisible older keyframe, else the newest older one).

    Returns the slot, or capacity_kf when no slot is free (then nothing is
    written except the reference's refresh of covisibility row K-1).
    Reads the free-slot decision on the host: insertion is a cold path."""
    K = state.capacity_kf
    seq = int(state.num_kf)
    free = ~state.kf_valid
    has_free = bool(free.any())
    k = int(torch.argmax(free.to(torch.int32))) if has_free else K
    kc = min(k, K - 1)
    if has_free:
        bind = point_idx >= 0
        state.kf_Tcw[k] = Tcw
        state.kf_valid[k] = True
        state.kf_frame_id[k] = frame_id
        state.kf_xy[k] = xy
        state.kf_ur[k] = ur
        state.kf_depth[k] = depth
        state.kf_octave[k] = octave
        state.kf_angle[k] = angle
        state.kf_desc[k] = desc
        state.kf_feat_valid[k] = feat_valid
        state.kf_point_idx[k] = torch.where(bind, point_idx, -1)
        state.kf_seq[k] = seq
        state.num_kf += 1
        _append_observations(state, k, torch.where(bind, point_idx, 0), bind, ur)
    update_covisibility_row(state, kc)
    if has_free:
        weights = state.covis[kc]
        older = state.kf_valid & (state.kf_seq >= 0) & (state.kf_seq < seq)
        w = torch.where(older, weights, -1)
        prev = torch.argmax(torch.where(older, state.kf_seq, -1))
        parent = torch.where(torch.amax(w) > 0, torch.argmax(w), prev)
        state.kf_parent[k] = torch.where(torch.any(older), parent, -1).to(torch.int32)
    return k


def _append_observations(state: MapState, k: int, point_ids, bind_mask, ur) -> None:
    """Append (k, feature slot) to each bound point's first free
    observation slot; stereo observations count twice."""
    S = point_ids.shape[0]
    pid = point_ids.to(torch.int64)
    free = state.mp_obs_kf[pid] < 0               # [S, O]
    slot = torch.argmax(free.to(torch.int32), dim=1)
    do = bind_mask & torch.any(free, dim=1)
    sel = torch.nonzero(do).squeeze(1)
    p, s = pid[sel], slot[sel]
    state.mp_obs_kf[p, s] = k
    state.mp_obs_feat[p, s] = torch.arange(S, dtype=torch.int32, device=pid.device)[sel]
    inc = torch.where(ur >= 0, 2, 1).to(torch.int32)
    state.mp_n_obs.index_add_(0, p, inc[sel])


def update_covisibility_row(state: MapState, k: int) -> None:
    """Recompute covis[k, :] and covis[:, k] from shared point bindings:
    flag keyframe k's points in a [P] vector, then count flagged bindings
    of every keyframe with one gather."""
    P = state.capacity_mp
    ids_k = state.kf_point_idx[k].to(torch.int64)
    flag = torch.zeros(P + 1, dtype=torch.bool, device=ids_k.device)
    flag[torch.where(ids_k >= 0, ids_k, P)] = True
    flag[P] = False
    ids_all = torch.where(state.kf_point_idx >= 0, state.kf_point_idx, P).to(torch.int64)
    counts = torch.sum(flag[ids_all], dim=1).to(torch.int32)
    counts = torch.where(state.kf_valid, counts, 0)
    counts[k] = 0
    state.covis[k, :] = counts
    state.covis[:, k] = counts


# ---------------------------------------------------------------------------
# map point insertion
# ---------------------------------------------------------------------------


def add_points(
    state: MapState,
    positions: torch.Tensor,   # [N, 3]
    valid: torch.Tensor,       # [N] bool
    ref_kf: int,
    feat_idx: torch.Tensor,    # [N] feature slot in ref_kf binding this point
    desc: torch.Tensor,        # [N, 8]
    normal: torch.Tensor,      # [N, 3]
    min_dist: torch.Tensor,    # [N]
    max_dist: torch.Tensor,    # [N]
    ur: torch.Tensor,          # [N] right coords of the seeding feature
) -> torch.Tensor:
    """Allocate new points into the first free slots (in slot order), bind
    them to ref_kf's features and seed their observation tables.

    Returns point ids [N] int32, -1 where invalid or out of capacity.
    Selects the rows on the host: insertion is a cold path."""
    N = positions.shape[0]
    P = state.capacity_mp
    dev = positions.device
    free = torch.nonzero(~state.mp_valid).squeeze(1)[:N]
    free = torch.cat([free, torch.full((N - free.shape[0],), P, dtype=free.dtype, device=dev)])
    slot_rank = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    pid = free[torch.clamp(slot_rank, 0, N - 1)]
    ok = valid & (pid < P)
    sel = torch.nonzero(ok).squeeze(1)
    p = pid[sel]
    first = state.kf_seq[min(max(ref_kf, 0), state.capacity_kf - 1)]
    state.mp_pos[p] = positions[sel]
    state.mp_valid[p] = True
    state.mp_desc[p] = desc[sel]
    state.mp_normal[p] = normal[sel]
    state.mp_min_dist[p] = min_dist[sel]
    state.mp_max_dist[p] = max_dist[sel]
    state.mp_ref_kf[p] = ref_kf
    state.mp_first_kf[p] = first
    state.mp_n_obs[p] = torch.where(ur[sel] >= 0, 2, 1).to(torch.int32)
    state.mp_visible[p] = 1
    state.mp_found[p] = 1
    state.mp_obs_kf[p, 0] = ref_kf
    state.mp_obs_feat[p, 0] = feat_idx[sel].to(torch.int32)
    state.num_mp += sel.shape[0]
    state.kf_point_idx[ref_kf, feat_idx[sel].to(torch.int64)] = p.to(torch.int32)
    return torch.where(ok, pid, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# derived quantities / maintenance
# ---------------------------------------------------------------------------


def recompute_point_stats(state: MapState, point_ids: torch.Tensor, scale_factors: torch.Tensor) -> None:
    """Re-elect the distinctive descriptor (least median Hamming distance
    to the other observations) and refresh the mean viewing direction and
    the scale-invariance band of a batch of points, in place (ORB-SLAM2
    ComputeDistinctiveDescriptors / UpdateNormalAndDepth). Entries of -1
    are skipped; only valid points are written.

    The per-point [N, O, O] Hamming distances use the plain
    `hamming.popcount_u32`, batched, as the reference uses its plain
    `distance_matrix` under `vmap`."""
    O = state.obs_slots
    K = state.capacity_kf
    i64 = torch.int64
    pid = torch.where(point_ids >= 0, point_ids, 0).to(i64)
    ok = (point_ids >= 0) & state.mp_valid[pid]

    obs_kf = state.mp_obs_kf[pid]                        # [N, O]
    obs_ft = state.mp_obs_feat[pid]
    has = obs_kf >= 0
    kf_w = torch.where(has, obs_kf, 0).to(i64)
    ft_w = torch.where(has, obs_ft, 0).to(i64)

    descs = state.kf_desc[kf_w, ft_w]                    # [N, O, 8]
    d = torch.zeros(descs.shape[:2] + (O,), dtype=torch.int32, device=descs.device)
    for w in range(descs.shape[-1]):
        d += hamming.popcount_u32(torch.bitwise_xor(descs[:, :, None, w], descs[:, None, :, w]))
    big = 1 << 16
    d = torch.where(has[:, :, None] & has[:, None, :], d, big)
    # masked median: sort each row, take the entry at n_valid // 2
    n_valid = torch.sum(has, dim=1)                      # [N]
    d_sorted = torch.sort(d, dim=-1).values
    med_idx = torch.clamp(n_valid // 2, 0, O - 1)
    med = torch.gather(d_sorted, 2, med_idx[:, None, None].expand(-1, O, 1))[..., 0]
    med = torch.where(has, med, big)
    best_obs = torch.argmin(med, dim=1)
    new_desc = torch.gather(descs, 1, best_obs[:, None, None].expand(-1, 1, 8))[:, 0]

    # normal: mean unit vector from the observers' centres to the point
    pos = state.mp_pos[pid]                               # [N, 3]
    T = state.kf_Tcw[kf_w]                                # [N, O, 4, 4]
    centers = -torch.einsum("nokj,nok->noj", T[..., :3, :3], T[..., :3, 3])
    dirs = pos[:, None, :] - centers
    dn = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-9)
    dn = torch.where(has[..., None], dn, 0.0)
    normal = dn.sum(1) / torch.clamp(n_valid[:, None], min=1)

    # depth band from the octave of the reference keyframe's observation
    ref = torch.clamp(state.mp_ref_kf[pid], 0, K - 1).to(i64)
    ref_T = state.kf_Tcw[ref]
    ref_c = -torch.einsum("nkj,nk->nj", ref_T[..., :3, :3], ref_T[..., :3, 3])
    dist = torch.linalg.norm(pos - ref_c, dim=-1)
    ref_slot = torch.argmax((obs_kf == ref[:, None]).to(torch.int32), dim=1)
    ref_feat = torch.gather(obs_ft, 1, ref_slot[:, None])[:, 0]
    octv = state.kf_octave[ref, torch.clamp(ref_feat, 0, state.kf_octave.shape[1] - 1).to(i64)]
    nl = scale_factors.shape[0]
    max_d = dist * scale_factors[torch.clamp(octv, 0, nl - 1).to(i64)]
    min_d = max_d / scale_factors[nl - 1]

    masked_put_(state.mp_desc, pid, new_desc, ok)
    masked_put_(state.mp_normal, pid, normal, ok)
    masked_put_(state.mp_max_dist, pid, max_d, ok)
    masked_put_(state.mp_min_dist, pid, min_d, ok)


def rebuild_observations(state: MapState) -> torch.Tensor:
    """Rebuild the observation tables (mp_obs_kf, mp_obs_feat, mp_n_obs) in
    place from the keyframe binding tables: flatten every (kf, feature,
    point) binding, sort by point with a stable sort, rank within each
    point's run and keep the first `obs_slots` of each.

    Returns the number of observations dropped because a point had more
    observers than `obs_slots` (0-d tensor)."""
    K, S = state.kf_point_idx.shape
    P = state.capacity_mp
    O = state.obs_slots
    dev = state.kf_point_idx.device
    pid = state.kf_point_idx
    pid_c = torch.clamp(pid, 0, P - 1).to(torch.int64)
    valid = (pid >= 0) & state.kf_feat_valid & state.kf_valid[:, None] & state.mp_valid[pid_c]
    flat_pid = torch.where(valid, pid, P).reshape(-1).to(torch.int64)
    kf_ids = torch.arange(K, dtype=torch.int32, device=dev)[:, None].expand(K, S).reshape(-1)
    ft_ids = torch.arange(S, dtype=torch.int32, device=dev)[None, :].expand(K, S).reshape(-1)
    order = torch.argsort(flat_pid, stable=True)
    sp = flat_pid[order]
    idx = torch.arange(sp.shape[0], device=dev)
    rank = idx - torch.searchsorted(sp, sp, side="left")
    ok = (sp < P) & (rank < O)
    state.mp_obs_kf.fill_(-1)
    state.mp_obs_feat.fill_(-1)
    masked_put_(state.mp_obs_kf, (sp, rank), kf_ids[order], ok)
    masked_put_(state.mp_obs_feat, (sp, rank), ft_ids[order], ok)
    ur = state.kf_ur.reshape(-1)[order]
    inc = torch.where(ur >= 0, 2, 1).to(torch.int32)
    state.mp_n_obs.zero_()
    masked_put_(state.mp_n_obs, sp, inc, sp < P, accumulate=True)
    return torch.sum((sp < P) & (rank >= O))


def covisible_keyframes(state: MapState, k, min_weight: int = 15) -> torch.Tensor:
    """[K] mask of keyframes sharing at least `min_weight` points with k
    (ORB-SLAM2 GetCovisiblesByWeight)."""
    return (state.covis[k] >= min_weight) & state.kf_valid
