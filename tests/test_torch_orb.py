"""Parity of the port's ORB front end (pyramid, FAST, selection, IC angle,
steered BRIEF, full extraction) with the reference package on a textured
synthetic 320x240 frame."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import CameraConfig, OrbConfig
from orbslam2_tpu.io import synthetic
from orbslam2_tpu.ops import fast as jfast
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.ops import patches as jpatches
from orbslam2_tpu.ops import pyramid as jpyr
from orbslam2_tpu_torch.ops import fast as tfast
from orbslam2_tpu_torch.ops import orb as torb
from orbslam2_tpu_torch.ops import patches as tpatches
from orbslam2_tpu_torch.ops import pyramid as tpyr

CAM = CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, width=320, height=240)
ORB = OrbConfig(num_features=300, feature_slots=320, candidates_per_level=2048)


@pytest.fixture(scope="module")
def image():
    seq = synthetic.textured_sequence(n_frames=3, kind="forward", cam=CAM)
    return seq.frame(1)[0]


@pytest.fixture(scope="module")
def extracted(image):
    jf = jorb.extract(jnp.asarray(image), ORB)
    tf = torb.OrbExtractor(ORB)(torch.from_numpy(image))
    return jf, tf


def test_pyramid_levels_match(image):
    """Bilinear half-pixel-centre downscales agree to 1e-3 on 0..255
    intensities (float32 rounding through seven successive resizes)."""
    jl = jpyr.build_pyramid(jnp.asarray(image), ORB)
    tl = tpyr.build_pyramid(torch.from_numpy(image), ORB)
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-3)


def test_gaussian_blur_matches(image):
    taps = tpyr.gaussian_kernel_1d()
    np.testing.assert_allclose(np.asarray(jpyr.gaussian_kernel_1d()), taps.numpy(), atol=1e-7)
    np.testing.assert_allclose(np.asarray(jpyr.gaussian_blur(jnp.asarray(image))),
                               tpyr.gaussian_blur(torch.from_numpy(image), taps).numpy(), atol=1e-3)


def test_fast_masks_and_scores_match(image):
    """Corner masks at both thresholds are identical; scores agree to
    float32 summation order."""
    jlo, jhi, js = jfast.fast_score_map2(jnp.asarray(image), jnp.float32(7), jnp.float32(20))
    tlo, thi, ts = tfast.fast_score_map2(torch.from_numpy(image)[None], 7.0, 20.0)
    assert np.array_equal(np.asarray(jlo), tlo[0].numpy())
    assert np.array_equal(np.asarray(jhi), thi[0].numpy())
    np.testing.assert_allclose(np.asarray(js), ts[0].numpy(), atol=1e-3)
    jsc, jst = jfast.detect(jnp.asarray(image), 20, 7, 19)
    tsc, tst = tfast.detect(torch.from_numpy(image), 20, 7, 19)
    assert np.array_equal(np.isfinite(np.asarray(jsc)), torch.isfinite(tsc).numpy())
    assert np.array_equal(np.asarray(jst), tst.numpy())


def test_has_arc_exhaustive():
    bits = np.arange(1 << 16, dtype=np.int32)
    ref = np.asarray(jfast._has_arc(jnp.asarray(bits)))
    got = tfast._has_arc(torch.from_numpy(bits).to(torch.int64)).numpy()
    assert np.array_equal(ref, got)


def test_select_uniform_matches(image):
    """Keypoints (xy) and validity of the uniform selection are identical
    (exact: stable sort reproduces lax.top_k's tie order)."""
    score, strong = jfast.detect(jnp.asarray(image), 20, 7, 19)
    jxy, jresp, jvalid = jorb.select_uniform(score, strong, 120, 2048, 32)
    txy, tresp, tvalid = torb.select_uniform(
        torch.from_numpy(np.asarray(score))[None], torch.from_numpy(np.asarray(strong))[None], 120, 32
    )
    assert np.array_equal(np.asarray(jvalid), tvalid[0].numpy())
    assert np.array_equal(np.asarray(jxy), txy[0].numpy())
    np.testing.assert_allclose(np.asarray(jresp), tresp[0].numpy(), atol=1e-3)


def test_ic_angle_matches(rng):
    p = rng.uniform(0, 255, (64, 31, 31)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jpatches.ic_angle(jnp.asarray(p), 15)),
                               tpatches.ic_angle(torch.from_numpy(p), 15).numpy(), atol=1e-4)


def test_extract_keypoints_match(extracted):
    """Full extraction: xy and octave identical, angles to atol 1e-4."""
    jf, tf = extracted
    valid = np.asarray(jf.valid)
    assert np.array_equal(valid, tf.valid.numpy())
    assert np.array_equal(np.asarray(jf.xy), tf.xy.numpy())
    assert np.array_equal(np.asarray(jf.octave), tf.octave.numpy())
    np.testing.assert_allclose(np.asarray(jf.angle)[valid], tf.angle.numpy()[valid], atol=1e-4)
    assert valid.sum() > 250


def test_extract_descriptors_match(extracted):
    """>= 99 % of descriptors identical: cos/sin may differ by an ulp, and
    an ulp at a .5 rounding boundary flips one BRIEF sample."""
    jf, tf = extracted
    valid = np.asarray(jf.valid)
    same = (np.asarray(jf.desc).view(np.int32) == tf.desc.numpy()).all(axis=1)
    assert same[valid].mean() >= 0.99, same[valid].mean()


def test_brief_pattern_copy_equals_reference():
    assert np.array_equal(jorb.make_brief_pattern(), torb.make_brief_pattern())


def test_descriptor_bits_round_trip(rng):
    """uint32 words -> int32 (view) -> packed bits -> uint32: same bits."""
    bits = rng.integers(0, 2, (40, 256)).astype(bool)
    bits[0] = True   # every word's sign bit set
    ref = np.asarray(jorb._pack_bits(jnp.asarray(bits.astype(np.uint32))))
    got = torb._pack_bits(torch.from_numpy(bits)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got.view(np.uint32), ref)
    assert np.array_equal(ref.view(np.int32).view(np.uint32), ref)
