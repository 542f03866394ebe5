"""The port's entry points (`orbslam2_tpu_torch.graft_entry`) against the
reference's `__graft_entry__.py` on the CPU.

`entry()`'s per-frame function runs on the reference's example arguments
(a noise image, random map points: nothing matches) and on a rendered
frame of the forward dolly whose map points are made from its own
features (`chip_smoke.matching_frame`). Tolerances: Tcw within 1e-4 and
the same inlier count; descriptors to `test_torch_orb.py`'s bar, at least
99 % of them identical (on the example image one of 1000 differs: its
orientation lies 1.2e-6 rad from the reference's, enough at a .5
rounding boundary of one rotated BRIEF sample; `tools/parity_margins.py`).
"""

import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as reference
from chip_smoke import matching_frame
from orbslam2_tpu_torch import graft_entry


@pytest.fixture(scope="module")
def fns():
    ref_fn, ref_args = reference.entry()
    fn, args = graft_entry.entry("cpu")
    return jax.jit(ref_fn), ref_args, fn, args


def compare(fns, numpy_args, min_inliers):
    ref_fn, _, fn, _ = fns
    T_r, n_r, d_r = ref_fn(*(a.view(np.uint32) if a.dtype == np.int32 else a
                             for a in numpy_args))
    T, n, d = fn(*(torch.from_numpy(a) for a in numpy_args))
    assert int(n) == int(n_r) and int(n) >= min_inliers
    np.testing.assert_allclose(T.numpy(), np.asarray(T_r), atol=1e-4)
    same = (d.numpy() == np.asarray(d_r).view(np.int32)).all(axis=1)
    assert same.mean() >= 0.99, same.mean()


def test_entry_example_args_equal_reference(fns):
    _, ref_args, _, args = fns
    assert len(args) == len(ref_args)
    for a, b in zip(args, ref_args):
        a = a.numpy()
        assert np.array_equal(a.view(np.uint32) if a.dtype == np.int32 else a, b)


def test_entry_fn_matches_reference_on_example_args(fns):
    compare(fns, tuple(a.numpy() for a in fns[3]), min_inliers=0)


def test_entry_fn_matches_reference_on_matching_frame(fns):
    compare(fns, matching_frame(), min_inliers=101)


def test_dryrun_multichip_on_cpu_ranks(capsys):
    graft_entry.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"dryrun_multichip OK: 2 rank\(s\) on cpu, cost=([0-9.]+), cams \(64, 4, 4\), "
                     r"points \(2048, 3\), pose-graph verts \(16, 8\)", line)
    assert m and np.isfinite(float(m.group(1))), line


def test_entry_points_refuse_cuda_without_a_card():
    """Both entry points default to the card; without one (or with fewer
    cards than ranks) they raise and nothing runs on the CPU."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="CUDA device"):
        graft_entry.dryrun_multichip(n, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        graft_entry.dryrun_multichip(n)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graft_entry.entry()
