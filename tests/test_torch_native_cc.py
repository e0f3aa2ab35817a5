"""Connected components (videopainter_tpu_torch.native): the plain version
against both JAX versions (the lax.while_loop labelling and the C++
union-find) and scipy, the dispatcher, `fill_holes_in_mask_scores`, and the
CUDA kernel against the plain version on the card (skipped without one).

Labels are integers: the port numbers components from 1 in the raster order
of their first pixel, as both JAX versions do, so labels and areas must be
equal, with no tolerance."""

import numpy as np
import pytest
import torch

from videopainter_tpu.native import (connected_components_jax, connected_components_native,
                                     fill_holes_in_mask_scores as jfill_holes)
from videopainter_tpu_torch import _kernels
from videopainter_tpu_torch.native import (connected_components_cuda,
                                           connected_components_reference,
                                           fill_holes_in_mask_scores, get_connected_components)


def make_mask(seed=0, b=2, h=40, w=56, p=0.4):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 1, h, w) < p).astype(np.uint8)


def scipy_reference(mask):
    from scipy import ndimage

    labels = np.zeros_like(mask, np.int32)
    areas = np.zeros_like(mask, np.int32)
    for i in range(mask.shape[0]):
        lab, _ = ndimage.label(mask[i, 0], structure=np.ones((3, 3), int))
        ar = np.bincount(lab.ravel())[lab]
        ar[lab == 0] = 0
        labels[i, 0], areas[i, 0] = lab, ar
    return labels, areas


def assert_same_partition(labels, ref_labels):
    assert ((labels > 0) == (ref_labels > 0)).all()
    fg = ref_labels > 0
    pairs = set(zip(labels[fg].ravel().tolist(), ref_labels[fg].ravel().tolist()))
    assert len(pairs) == len({a for a, _ in pairs}) == len({b for _, b in pairs})


CASES = [(0, 0.4), (1, 0.7), (2, 0.1), (3, 0.5), (4, 0.41)]


@pytest.mark.parametrize("seed,p", CASES)
def test_plain_version_equals_both_jax_versions(seed, p):
    mask = make_mask(seed, p=p)
    labels, areas = connected_components_reference(torch.from_numpy(mask))
    assert labels.dtype == areas.dtype == torch.int32
    for ref_labels, ref_areas in (connected_components_jax(mask),
                                  connected_components_native(mask)):
        np.testing.assert_array_equal(labels.numpy(), ref_labels)
        np.testing.assert_array_equal(areas.numpy(), ref_areas)


@pytest.mark.parametrize("seed,p", CASES)
def test_plain_version_partitions_as_scipy(seed, p):
    mask = make_mask(seed, p=p)
    labels, areas = get_connected_components(mask)
    ref_labels, ref_areas = scipy_reference(mask)
    assert_same_partition(labels, ref_labels)
    np.testing.assert_array_equal(areas, ref_areas)


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (1, 1, 1, 37), (1, 1, 29, 1), (3, 1, 9, 13)])
def test_thin_and_tiny_masks(shape):
    for p in (0.0, 0.5, 1.0):
        mask = make_mask(7, *[shape[0], shape[2], shape[3]], p=p)
        labels, areas = get_connected_components(mask)
        ref = connected_components_native(mask)
        np.testing.assert_array_equal(labels, ref[0])
        np.testing.assert_array_equal(areas, ref[1])


def test_empty_and_full_and_dispatch():
    empty = torch.zeros((1, 1, 8, 8), dtype=torch.uint8)
    labels, areas = get_connected_components(empty)
    assert isinstance(labels, torch.Tensor) and labels.sum() == 0 and areas.sum() == 0
    full = np.ones((2, 1, 8, 8), np.uint8)
    labels, areas = get_connected_components(full)
    assert isinstance(labels, np.ndarray) and (labels == 1).all() and (areas == 64).all()
    with pytest.raises(ValueError):
        get_connected_components(torch.zeros((8, 8), dtype=torch.uint8))
    # no fallback: the kernel's wrapper refuses a CPU tensor rather than running elsewhere
    with pytest.raises(ValueError, match="CUDA"):
        connected_components_cuda(empty)
    assert _kernels.LAUNCHES["connected_components"] == 0


def test_fill_holes():
    mask = np.ones((32, 32), np.uint8)
    mask[10:12, 10:12] = 0        # a 4-pixel hole: filled
    mask[0:20, 0] = 0
    mask[:, 20:] = 0              # a large background region: kept
    out = fill_holes_in_mask_scores(mask, max_area=8)
    assert out[10, 10] == 1 and out[0, 25] == 0
    speck = np.zeros((32, 32), np.uint8)
    speck[5, 5] = 1               # a one-pixel speck: removed
    speck[20:30, 20:30] = 1
    out = fill_holes_in_mask_scores(torch.from_numpy(speck), max_area=4)
    assert isinstance(out, torch.Tensor) and out[5, 5] == 0 and out[25, 25] == 1


@pytest.mark.parametrize("max_area", [3, 20])
def test_fill_holes_matches_jax(max_area):
    mask = make_mask(11, b=2, h=24, w=31, p=0.55)
    np.testing.assert_array_equal(fill_holes_in_mask_scores(mask, max_area),
                                  jfill_holes(mask, max_area))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version on the same tensors, exact:
    random masks around the percolation threshold, empty / full, thin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cases = [make_mask(s, b=3, h=97, w=131, p=p) for s, p in CASES]
    cases += [np.zeros((1, 1, 33, 65), np.uint8), np.ones((2, 1, 64, 64), np.uint8),
              make_mask(8, b=1, h=1, w=1, p=1.0), make_mask(9, b=2, h=1, w=300, p=0.6)]
    for mask in cases:
        m = torch.from_numpy(mask).cuda()
        labels, areas = connected_components_cuda(m)
        torch.cuda.synchronize()
        ref_labels, ref_areas = connected_components_reference(m)
        assert torch.equal(labels, ref_labels) and torch.equal(areas, ref_areas)
