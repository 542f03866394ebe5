"""Parity of the port's stereo match and stereo frame with the reference
package on synthetic rectified pairs of the textured dolly, at 320x240
and at 640x480.

Tolerances: the SADs are float32 sums of 121 terms in another order, so
a feature whose SAD lies within 1e-4 (relative) of the median threshold
may fall on either side of it; at most 1 % of the matches may differ
(none did at either size when these tests were written). Where both sides
matched, `u_right` agrees to 1e-3 px and `depth` to 1e-4 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import CameraConfig, OrbConfig, SlamConfig, Sensor
from orbslam2_tpu.io import synthetic
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.ops import pyramid as jpyr
from orbslam2_tpu.ops import stereo as jstereo
from orbslam2_tpu.pipeline.frame import FrameBuilder as JBuilder
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.ops import stereo as tstereo
from orbslam2_tpu_torch.pipeline.frame import FrameBuilder as TBuilder
from tests.torch_threads import share_cores

share_cores()

SIZES = {
    "320x240": (CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, width=320, height=240),
                OrbConfig(num_features=300, feature_slots=320, candidates_per_level=2048)),
    "640x480": (CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0),
                OrbConfig(num_features=1000, feature_slots=1024)),
}


def _pair(cam):
    seq = synthetic.textured_sequence(n_frames=4, kind="forward", cam=cam)
    left, right, _ = seq.stereo(2)
    return left, right


def assert_stereo_parity(jm, tm, n_min):
    """Equal matched sets up to the threshold allowance; u_right and depth
    to tolerance where both matched."""
    ju, jd = np.asarray(jm.u_right), np.asarray(jm.depth)
    tu, td = tm.u_right.cpu().numpy(), tm.depth.cpu().numpy()
    jok, tok = jd > 0, td > 0
    assert ((ju >= 0) == jok).all() and ((tu >= 0) == tok).all()
    differ = int((jok != tok).sum())
    assert differ <= 0.01 * jok.sum(), (differ, int(jok.sum()))
    both = jok & tok
    assert both.sum() >= n_min, int(both.sum())
    np.testing.assert_allclose(tu[both], ju[both], atol=1e-3, rtol=0)
    np.testing.assert_allclose(td[both], jd[both], rtol=1e-4, atol=0)
    return differ


@pytest.mark.parametrize("size", list(SIZES))
def test_compute_stereo_matches_matches_reference(size):
    """The same features and pyramids into both versions."""
    cam, orb_cfg = SIZES[size]
    left, right = _pair(cam)
    fl = jorb.extract(jnp.asarray(left), orb_cfg)
    fr = jorb.extract(jnp.asarray(right), orb_cfg)
    lv_l = jpyr.build_pyramid(jnp.asarray(left), orb_cfg)
    lv_r = jpyr.build_pyramid(jnp.asarray(right), orb_cfg)
    sf = np.asarray(jpyr.level_scales(orb_cfg), np.float32)
    bf, fx = np.float32(cam.bf), np.float32(cam.fx)
    jm = jstereo.compute_stereo_matches(
        fl.xy, fl.octave, fl.desc, fl.valid, fr.xy, fr.octave, fr.desc, fr.valid,
        lv_l, lv_r, jnp.asarray(sf), jnp.asarray(bf), jnp.asarray(fx),
    )

    def t(x):
        return convert.to_tensor(x, "cpu")

    tm = tstereo.compute_stereo_matches(
        t(fl.xy), t(fl.octave), t(fl.desc), t(fl.valid),
        t(fr.xy), t(fr.octave), t(fr.desc), t(fr.valid),
        [t(x) for x in lv_l], [t(x) for x in lv_r], t(sf), t(bf), t(fx),
    )
    assert_stereo_parity(jm, tm, n_min=0.3 * int(np.asarray(fl.valid).sum()))


def test_stereo_frame_matches_reference():
    """`stereo_frame` as a whole (both extractions, both pyramids, the
    match, undistortion) against the reference's `FrameBuilder.stereo`."""
    cam, orb_cfg = SIZES["320x240"]
    cfg = SlamConfig(sensor=Sensor.STEREO, camera=cam, orb=orb_cfg)
    left, right = _pair(cam)
    jf = JBuilder(cfg).stereo(jnp.asarray(left), jnp.asarray(right), 0.5)
    tf = TBuilder(cfg, "cpu").stereo(torch.from_numpy(left), torch.from_numpy(right), 0.5)
    assert (tf.frame_id, tf.timestamp) == (jf.frame_id, jf.timestamp)
    for name in ("octave", "valid", "desc"):
        np.testing.assert_array_equal(convert.to_numpy(getattr(tf, name), name == "desc"),
                                      np.asarray(getattr(jf, name)))
    np.testing.assert_allclose(tf.xy.numpy(), np.asarray(jf.xy), atol=1e-4)
    np.testing.assert_allclose(tf.xy_raw.numpy(), np.asarray(jf.xy_raw), atol=1e-4)
    assert_stereo_parity(jstereo.StereoMatches(jf.ur, jf.depth),
                         tstereo.StereoMatches(tf.ur, tf.depth),
                         n_min=0.3 * int(np.asarray(jf.valid).sum()))


def test_monocular_frame_has_no_depth():
    cam, orb_cfg = SIZES["320x240"]
    cfg = SlamConfig(sensor=Sensor.MONOCULAR, camera=cam, orb=orb_cfg)
    left, _ = _pair(cam)
    jf = JBuilder(cfg).monocular(jnp.asarray(left))
    tf = TBuilder(cfg, "cpu").monocular(torch.from_numpy(left))
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    np.testing.assert_allclose(tf.xy.numpy(), np.asarray(jf.xy), atol=1e-4)
    assert (tf.ur == -1).all() and (tf.depth == -1).all()
    assert tf.ur.shape == tf.depth.shape == (orb_cfg.feature_slots,)
