"""The mask band's epilogue: the kept instances' composite and the SDF green
channel, plain versions (`ops/sdf.py`) and kernels (`ops/cuda/mask_epilogue.py`).

On the CPU the plain composite is held to hand-made slabs and the wrappers to
the plain versions (they take them for CPU tensors). The card-only tests hold
the CUDA kernels to the plain versions on the card with torch.equal, on the
cases of `runtime/check_mask_epilogue.py`; run them on a machine with a card
with `python -m pytest --noconftest -m cuda tests/test_torch_mask_epilogue.py`.
"""

import numpy as np
import pytest
import torch

from prisma_tpu_torch.bands import mask_band
from prisma_tpu_torch.ops import sdf
from prisma_tpu_torch.ops.cuda import mask_epilogue as me
from prisma_tpu_torch.runtime import check_mask_epilogue as check

H, W = 6, 8


def _slab():
    """Five slots on a 6x8 frame: three kept and overlapping (a pixel in
    all three), one valid but of a class the band drops, one valid but under
    the confidence, one invalid slot with a mask; and the step's keep flags."""
    masks = torch.zeros((6, H, W), dtype=torch.bool)
    masks[0, 0:4, 0:4] = True   # person
    masks[1, 2:6, 2:6] = True   # dog
    masks[2, 3:5, 3:8] = True   # cat
    masks[3, :, 7] = True       # a car: not a kept class
    masks[4, 5, :] = True       # a person under the confidence
    masks[5, 0, :] = True       # an invalid slot
    slab = {"masks": masks,
            "labels": torch.tensor([0, 16, 15, 2, 0, 0]),
            "scores": torch.tensor([0.9, 0.8, 0.7, 0.9, 0.3, 0.9]),
            "valid": torch.tensor([True, True, True, True, True, False])}
    keep = mask_band.kept(slab, mask_band.CONFIDENCE_THRESHOLD,
                          torch.tensor(mask_band.CLASS_IDS))
    return slab, keep


def test_kept_composite_on_hand_made_slabs():
    slab, keep = _slab()
    assert keep.tolist() == [True, True, True, False, False, False]
    want = np.zeros((H, W), np.float32)
    want[0:4, 0:4] += 255
    want[2:6, 2:6] += 255
    want[3:5, 3:8] += 255
    got = sdf.kept_composite(slab["masks"], keep)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0, 255, 510, 765}
    # the step's expression before it moved into ops/sdf.py
    today = ((slab["masks"] & keep[:, None, None]).float() * 255.0).sum(dim=0)
    assert torch.equal(got, today)
    # no instance kept: all zero
    none = sdf.kept_composite(slab["masks"], torch.zeros(6, dtype=torch.bool))
    assert torch.equal(none, torch.zeros((H, W)))


def test_wrappers_take_the_plain_versions_on_the_cpu():
    slab, keep = _slab()
    masks = [slab["masks"], slab["masks"].flip(-1).contiguous()]
    keeps = [keep, ~keep]
    before = (me.kept_composite.launches, me.sdf_green.launches)
    composite, marked = me.kept_composite(masks, keeps)
    want = torch.stack([sdf.kept_composite(m, k) for m, k in zip(masks, keeps)])
    assert torch.equal(composite, want)
    assert marked.dtype == torch.bool and torch.equal(marked, want != 0.0)
    green = me.sdf_green(marked)
    assert torch.equal(green, sdf.sdf_green_device(want != 0.0))
    assert (me.kept_composite.launches, me.sdf_green.launches) == before


def test_wrappers_check_their_inputs():
    slab, keep = _slab()
    with pytest.raises(ValueError):
        me.kept_composite([slab["masks"]], [keep, keep])
    with pytest.raises(ValueError):
        me.kept_composite([], [])


@pytest.mark.parametrize("label,mask", check.small_sdf_cases(),
                         ids=[k for k, _ in check.small_sdf_cases()])
def test_sdf_wrapper_on_the_cpu_cases(label, mask):
    assert torch.equal(me.sdf_green(mask), sdf.sdf_green_device(mask))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
def test_sdf_kernel_equals_plain_on_card():
    gen = _card()
    for label, mask in check.sdf_cases(gen, "cuda"):
        before = me.sdf_green.launches
        green = me.sdf_green(mask)
        torch.cuda.synchronize()
        assert me.sdf_green.launches == before + 1, label
        assert green.shape == mask.shape and green.dtype == torch.float32, label
        assert torch.equal(green, sdf.sdf_green_device(mask)), label


@pytest.mark.cuda
def test_composite_kernel_equals_plain_on_card():
    gen = _card()
    for label, masks, keep in check.slab_cases(gen, "cuda"):
        h = check.held(masks, keep)
        assert h["composite"] and h["marked"] and h["green"], (label, h)
        assert h["launches"] == (-(-len(masks) // me.MAX_FRAMES), 1), (label, h)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take():
    _card()
    masks = torch.zeros((4, 16, 16), dtype=torch.bool, device="cuda")
    keep = torch.ones(4, dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError):
        me.kept_composite([masks.to(torch.uint8)], [keep])
    with pytest.raises(ValueError, match="contiguous"):
        me.kept_composite([masks.transpose(1, 2)], [keep])
    with pytest.raises(ValueError):
        me.kept_composite([masks, masks[:3]], [keep, keep[:3]])
    with pytest.raises(TypeError):
        me.sdf_green(masks.float())
    with pytest.raises(ValueError, match="contiguous"):
        me.sdf_green(masks.transpose(1, 2))
