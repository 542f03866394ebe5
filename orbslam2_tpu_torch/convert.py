"""Carry state across from the reference package: conversions between
numpy arrays and the port's types.

Inputs are mappings of field name to array-like (a reference NamedTuple's
``_asdict()`` works as it is: each value goes through ``np.asarray``).
Descriptors keep their bits: the reference's [*, 8] uint32 words become
[*, 8] int32 through ``np.ndarray.view``, and back.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from orbslam2_tpu_torch.geometry.camera import Intrinsics
from orbslam2_tpu_torch.pipeline.fused import TrackParams
from orbslam2_tpu_torch.pipeline.frame import FrameData
from orbslam2_tpu_torch.slam_map.map_state import MapState
from orbslam2_tpu_torch.solvers.ba import BAProblem, BAResult
from orbslam2_tpu_torch.solvers.pose_opt import PoseObservations

_DESC_FIELDS = ("desc", "kf_desc", "mp_desc")


def to_tensor(x, device) -> torch.Tensor:
    """numpy (or array-like) -> a new tensor on `device`; uint32 keeps its
    bits as int32. Always a copy: `np.asarray` of another framework's
    array may alias its buffer, and the port updates state in place."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device)


def to_numpy(t: torch.Tensor, descriptor: bool = False) -> np.ndarray:
    """tensor -> numpy; descriptor words go back to uint32."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if descriptor else a


def map_state_from_numpy(fields: Mapping, device) -> MapState:
    return MapState(**{f.name: to_tensor(fields[f.name], device)
                       for f in dataclasses.fields(MapState)})


def map_state_to_numpy(state: MapState) -> dict[str, np.ndarray]:
    return {f.name: to_numpy(getattr(state, f.name), f.name in _DESC_FIELDS)
            for f in dataclasses.fields(MapState)}


def frame_from_numpy(fields: Mapping, device) -> FrameData:
    return FrameData(**{
        name: (int(np.asarray(fields[name])) if name == "frame_id"
               else float(np.asarray(fields[name])) if name == "timestamp"
               else to_tensor(fields[name], device))
        for name in FrameData._fields
    })


def intrinsics_from_numpy(fields: Mapping, device) -> Intrinsics:
    return Intrinsics(**{name: to_tensor(fields[name], device).to(torch.float32)
                         for name in Intrinsics._fields})


def pose_observations_from_numpy(fields: Mapping, device) -> PoseObservations:
    return PoseObservations(**{name: to_tensor(fields[name], device)
                               for name in PoseObservations._fields})


def ba_problem_from_numpy(fields: Mapping, device) -> BAProblem:
    return BAProblem(**{name: to_tensor(fields[name], device) for name in BAProblem._fields})


def ba_result_to_numpy(result: BAResult) -> dict[str, np.ndarray]:
    return {name: to_numpy(getattr(result, name)) for name in BAResult._fields}


def track_params_from_numpy(fields: Mapping, device) -> TrackParams:
    f = {name: np.asarray(fields[name]) for name in TrackParams._fields}
    return TrackParams(
        scale_factors=to_tensor(f["scale_factors"], device),
        inv_sigma2=to_tensor(f["inv_sigma2"], device),
        bounds=tuple(float(v) for v in f["bounds"]),
        radius_th=float(f["radius_th"]),
        min_track=int(f["min_track"]),
        close_depth=float(f["close_depth"]),
        min_track_local=int(f["min_track_local"]),
        match_max_dist=int(f["match_max_dist"]),
    )
