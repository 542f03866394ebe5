"""Frame construction: ORB extraction, undistortion and depth seeding.

Port of `orbslam2_tpu.pipeline.frame`: the monocular, stereo and RGB-D
constructors each produce one fixed-shape FrameData. A stereo frame runs
both images through the one ORB extractor and matches them
(`ops.stereo.compute_stereo_matches`, which launches K1 once).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch import profiling
from orbslam2_tpu_torch.config import SlamConfig
from orbslam2_tpu_torch.geometry import camera as cam_geo
from orbslam2_tpu_torch.ops import orb, pyramid, stereo


class FrameData(NamedTuple):
    """Fixed-shape per-frame record."""

    frame_id: int
    timestamp: float
    xy: torch.Tensor        # [S, 2] undistorted keypoint coords
    xy_raw: torch.Tensor    # [S, 2] raw (distorted) coords
    ur: torch.Tensor        # [S] virtual right x (<0 = mono feature)
    depth: torch.Tensor     # [S] depth (<0 = unknown)
    octave: torch.Tensor    # [S] int32
    angle: torch.Tensor     # [S]
    desc: torch.Tensor      # [S, 8] int32 (uint32 bits)
    valid: torch.Tensor     # [S] bool


@profiling.spanned("frame.build")
def rgbd_frame(
    extractor: orb.OrbExtractor,
    image: torch.Tensor,
    depth_map: torch.Tensor,
    frame_id: int,
    timestamp: float,
    K: cam_geo.Intrinsics,
    inv_depth_factor: float,
    has_distortion: bool,
) -> FrameData:
    """ORB extraction + undistortion + depth seeding of one RGB-D frame."""
    feats = extractor(image)
    und = cam_geo.undistort_pixels(feats.xy, K) if has_distortion else feats.xy
    with profiling.span("frame.build.depth"):
        sm = stereo.compute_stereo_from_rgbd(
            feats.xy, und, feats.valid, depth_map, inv_depth_factor, K.bf
        )
    return FrameData(
        frame_id=frame_id,
        timestamp=timestamp,
        xy=und,
        xy_raw=feats.xy,
        ur=sm.u_right,
        depth=sm.depth,
        octave=feats.octave,
        angle=feats.angle,
        desc=feats.desc,
        valid=feats.valid,
    )


@profiling.spanned("frame.build")
def monocular_frame(
    extractor: orb.OrbExtractor,
    image: torch.Tensor,
    frame_id: int,
    timestamp: float,
    K: cam_geo.Intrinsics,
    has_distortion: bool,
) -> FrameData:
    """ORB extraction + undistortion of one monocular frame: no feature has
    depth."""
    feats = extractor(image)
    und = cam_geo.undistort_pixels(feats.xy, K) if has_distortion else feats.xy
    no_depth = torch.full(feats.valid.shape, -1.0, device=image.device)
    return FrameData(
        frame_id=frame_id,
        timestamp=timestamp,
        xy=und,
        xy_raw=feats.xy,
        ur=no_depth,
        depth=no_depth.clone(),
        octave=feats.octave,
        angle=feats.angle,
        desc=feats.desc,
        valid=feats.valid,
    )


@profiling.spanned("frame.build")
def stereo_frame(
    extractor: orb.OrbExtractor,
    left: torch.Tensor,
    right: torch.Tensor,
    frame_id: int,
    timestamp: float,
    K: cam_geo.Intrinsics,
    scale_factors: torch.Tensor,
    has_distortion: bool,
) -> FrameData:
    """ORB extraction of both images, the stereo match on their pyramids and
    undistortion of the left keypoints, for one rectified pair."""
    fl = extractor(left)
    fr = extractor(right)
    with profiling.span("frame.build.stereo_match"):
        lv_l = pyramid.build_pyramid(left, extractor.orb)
        lv_r = pyramid.build_pyramid(right, extractor.orb)
        sm = stereo.compute_stereo_matches(
            fl.xy, fl.octave, fl.desc, fl.valid,
            fr.xy, fr.octave, fr.desc, fr.valid,
            lv_l, lv_r, scale_factors, K.bf, K.fx,
        )
    und = cam_geo.undistort_pixels(fl.xy, K) if has_distortion else fl.xy
    return FrameData(
        frame_id=frame_id,
        timestamp=timestamp,
        xy=und,
        xy_raw=fl.xy,
        ur=sm.u_right,
        depth=sm.depth,
        octave=fl.octave,
        angle=fl.angle,
        desc=fl.desc,
        valid=fl.valid,
    )


class FrameBuilder:
    """Builds FrameData from images; owns the config, the intrinsics and
    the ORB extractor, all on `device`."""

    def __init__(self, cfg: SlamConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.K = cam_geo.Intrinsics.from_config(cfg.camera, device=self.device)
        self.extractor = orb.OrbExtractor(cfg.orb).to(self.device)
        self.scale_factors = torch.tensor(pyramid.level_scales(cfg.orb), dtype=torch.float32,
                                          device=self.device)
        self._next_id = 0

    def _fresh_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    def monocular(self, image: torch.Tensor, timestamp: float = 0.0) -> FrameData:
        return monocular_frame(self.extractor, image, self._fresh_id(), timestamp, self.K,
                               self.cfg.camera.has_distortion())

    def rgbd(self, image: torch.Tensor, depth_map: torch.Tensor, timestamp: float = 0.0) -> FrameData:
        return rgbd_frame(
            self.extractor, image, depth_map, self._fresh_id(), timestamp, self.K,
            1.0 / self.cfg.tracking.depth_map_factor, self.cfg.camera.has_distortion(),
        )

    def stereo(self, left: torch.Tensor, right: torch.Tensor, timestamp: float = 0.0) -> FrameData:
        return stereo_frame(
            self.extractor, left, right, self._fresh_id(), timestamp, self.K,
            self.scale_factors, self.cfg.camera.has_distortion(),
        )
