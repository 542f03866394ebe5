"""K1's plain PyTorch version against the reference package's Hamming
distance and its Pallas kernel (interpret mode): exact integer equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import hamming as jham
from orbslam2_tpu.ops.pallas_hamming import distance_matrix_pallas
from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.ops import cuda_hamming
from orbslam2_tpu_torch.ops import hamming as tham


@pytest.mark.parametrize("n,m", [(256, 256), (100, 300), (512, 1024)])
def test_plain_matches_reference_and_pallas(rng, n, m):
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    ref = np.asarray(jham.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    pal = np.asarray(distance_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = tham.distance_matrix(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), pal)


def test_popcount_edge_words():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555, 0xF0F0F0F0],
                     dtype=np.uint32)
    ref = np.asarray(jham.popcount_u32(jnp.asarray(words)))
    got = tham.popcount_u32(torch.from_numpy(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, ref)


def test_wrapper_on_cpu_takes_plain_version(rng, monkeypatch):
    """A CPU tensor goes to the plain version: the kernel library is never
    loaded and the launch count stays 0."""
    monkeypatch.setitem(kernels.launch_counts, "hamming", 0)
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("kernel library loaded on CPU"))
    a = torch.from_numpy(rng.integers(0, 2**32, (64, 8), dtype=np.uint32).view(np.int32))
    b = torch.from_numpy(rng.integers(0, 2**32, (32, 8), dtype=np.uint32).view(np.int32))
    got = cuda_hamming.distance_matrix(a, b)
    assert torch.equal(got, tham.distance_matrix(a, b))
    assert kernels.launch_counts["hamming"] == 0


def test_cuda_entry_rejects_cpu_tensors():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hamming.distance_matrix_cuda(a, a)
