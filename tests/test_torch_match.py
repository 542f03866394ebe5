"""Parity of the port's matchers with the reference package on the same
inputs: equal best_idx / best_dist / assigned, with ties built in
(duplicated target descriptors, several queries per target)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import match as jmatch
from orbslam2_tpu_torch.ops import match as tmatch

A, B = 160, 200


def _flip_bits(rng, desc, n_flips):
    out = desc.copy()
    for row in out:
        for _ in range(n_flips):
            w, bit = rng.integers(0, 8), rng.integers(0, 32)
            row[w] ^= np.uint32(1 << int(bit))
    return out


def _problem(rng):
    b = rng.integers(0, 2**32, (B, 8), dtype=np.uint32)
    b[1::7] = b[0::7][: len(b[1::7])]            # duplicated targets -> distance ties
    src = rng.integers(0, B, A)
    a = _flip_bits(rng, b[src], 6)
    a[::5] = a[1::5][: len(a[::5])]              # several queries per target
    a[3::11] = rng.integers(0, 2**32, (len(a[3::11]), 8), dtype=np.uint32)  # non-matches
    xy_b = rng.uniform(0, 320, (B, 2)).astype(np.float32)
    oct_b = rng.integers(0, 8, B).astype(np.int32)
    return {
        "desc_a": a, "desc_b": b,
        "xy_a": (xy_b[src] + rng.normal(0, 4, (A, 2))).astype(np.float32),
        "xy_b": xy_b,
        "oct_a": np.clip(oct_b[src] + rng.integers(-1, 2, A), 0, 7).astype(np.int32),
        "oct_b": oct_b,
        "valid_a": rng.random(A) < 0.9,
        "valid_b": rng.random(B) < 0.9,
        "ang_a": rng.uniform(-np.pi, np.pi, A).astype(np.float32),
        "ang_b": rng.uniform(-np.pi, np.pi, B).astype(np.float32),
        "radius": rng.uniform(5, 40, A).astype(np.float32),
    }


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v) for k, v in p.items()}


def _same(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.best_idx), tres.best_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jres.best_dist), tres.best_dist.numpy())
    np.testing.assert_array_equal(np.asarray(jres.assigned), tres.assigned.numpy())
    assert int(tres.num_matches) > 10


@pytest.mark.parametrize("ratio,check_rotation", [(1.0, False), (0.8, False), (0.9, True)])
def test_match_gated(rng, ratio, check_rotation):
    p = _problem(rng)
    gate = rng.random((A, B)) < 0.7
    pj, pt = _j(p), _t(p)
    jres = jmatch.match_gated(pj["desc_a"], pj["desc_b"], jnp.asarray(gate), max_dist=60, ratio=ratio,
                              angle_a=pj["ang_a"], angle_b=pj["ang_b"], check_rotation=check_rotation)
    tres = tmatch.match_gated(pt["desc_a"], pt["desc_b"], torch.from_numpy(gate), max_dist=60,
                              ratio=ratio, angle_a=pt["ang_a"], angle_b=pt["ang_b"],
                              check_rotation=check_rotation)
    _same(jres, tres)


def test_search_by_projection(rng):
    p = _problem(rng)
    pj, pt = _j(p), _t(p)
    jres = jmatch.search_by_projection(pj["desc_a"], pj["xy_a"], pj["oct_a"], pj["valid_a"],
                                       pj["desc_b"], pj["xy_b"], pj["oct_b"], pj["valid_b"],
                                       pj["radius"], max_dist=64, ratio=0.8)
    tres = tmatch.search_by_projection(pt["desc_a"], pt["xy_a"], pt["oct_a"], pt["valid_a"],
                                       pt["desc_b"], pt["xy_b"], pt["oct_b"], pt["valid_b"],
                                       pt["radius"], max_dist=64, ratio=0.8)
    _same(jres, tres)


def test_search_frame_to_frame(rng):
    p = _problem(rng)
    pj, pt = _j(p), _t(p)
    args = ("desc_a", "xy_a", "oct_a", "valid_a", "ang_a", "desc_b", "xy_b", "oct_b", "valid_b",
            "ang_b", "radius")
    jres = jmatch.search_frame_to_frame(*(pj[k] for k in args), max_dist=64)
    tres = tmatch.search_frame_to_frame(*(pt[k] for k in args), max_dist=64)
    _same(jres, tres)


@pytest.mark.parametrize("check_rotation", [True, False])
def test_search_brute(rng, check_rotation):
    p = _problem(rng)
    pj, pt = _j(p), _t(p)
    args = ("desc_a", "valid_a", "ang_a", "desc_b", "valid_b", "ang_b")
    jres = jmatch.search_brute(*(pj[k] for k in args), max_dist=50, ratio=0.7,
                               check_rotation=check_rotation)
    tres = tmatch.search_brute(*(pt[k] for k in args), max_dist=50, ratio=0.7,
                               check_rotation=check_rotation)
    _same(jres, tres)


def test_rotation_histogram_ties(rng):
    """Top-3 histogram bins with equal counts keep the lower bin first."""
    ang_b = np.zeros(B, np.float32)
    ang_a = np.repeat(np.linspace(0.1, 6.0, 8), A // 8).astype(np.float32)
    best = rng.integers(0, B, A).astype(np.int32)
    ok = np.ones(A, bool)
    ref = jmatch.rotation_consistency_mask(jnp.asarray(ang_a), jnp.asarray(ang_b),
                                           jnp.asarray(best), jnp.asarray(ok))
    got = tmatch.rotation_consistency_mask(torch.from_numpy(ang_a), torch.from_numpy(ang_b),
                                           torch.from_numpy(best), torch.from_numpy(ok))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
