"""The port's SOLOv2 (ResNet-101 + FPN + head, static-shape inference, matrix
NMS) and its device SDF against the JAX package's, in f32 on the CPU.

Weights are the JAX package's random init, carried across with
`weights.from_jax.solov2_state_dict`; the image is seeded with numpy at a
test scale of 160x96 (as tests/test_multiband.py shrinks it). Tolerances:
test_scale exact; the preprocessed image within 1e-6 of its scale (the same
f32 resize matrices, summed in another order); ResNet, FPN and head outputs
within 1e-4 of each output's scale (f32 through 101 layers, sums in another
order); matrix NMS within 1e-5; get_results on the same head outputs: the
decayed scores within 1e-5, labels and validity equal, the mask
probabilities of the valid instances within 1e-4 and at most 0.1% of their
thresholded pixels flipped. Through the whole network the head outputs part
by ~1e-6, which flips a few mask pixels at the 0.5 threshold before matrix
NMS, moves an IoU and with it a decayed score by up to ~2e-3, and can swap
two instances of near scores: there each JAX instance is matched to one of
the port's with its label, probabilities within 1e-4 and a decayed score
within 5e-3. The SDF green channel is equal (integers and their square
roots in f32 on both sides).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prisma_tpu.models import resnet as jresnet
from prisma_tpu.models import solov2 as jsolo
from prisma_tpu.ops import sdf as jsdf
from prisma_tpu_torch.models import resnet, solov2
from prisma_tpu_torch.ops import sdf
from prisma_tpu_torch.weights.from_jax import solov2_state_dict

SCALE = (160, 96)
HW = (96, 128)
CFG = solov2.SOLOv2Config(scale=SCALE)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test: the suite runs in several worker
    processes at once, and each torch op spreading over every core of the
    machine oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _close(ours, theirs, rel):
    theirs = np.asarray(theirs)
    assert tuple(ours.shape) == theirs.shape, (ours.shape, theirs.shape)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                               atol=rel * max(np.abs(theirs).max(), 1e-30))


@jax.jit
def _jax_network(params, img):
    feats = jresnet.forward(params["backbone"], img)
    fpn = jsolo.fpn_forward(params["fpn"], list(feats))
    heads = jsolo.head_forward(params["head"], fpn, jsolo.SOLOv2Config())
    return feats, fpn, heads


@pytest.fixture(scope="module")
def pair():
    """(JAX params, port model on the same weights, a 96x128 frame, the JAX
    network's outputs on it)."""
    params = jax.jit(jsolo.init_params)(jax.random.key(3))
    model = solov2.build(CFG)
    model.load_state_dict(solov2_state_dict(jax.tree.map(np.asarray, params)))
    frame = np.random.default_rng(0).integers(0, 256, size=(1, *HW, 3),
                                              dtype=np.uint8)
    img, hw = jsolo.preprocess(jnp.asarray(frame), scale=SCALE)
    return params, model, frame, (img, hw), _jax_network(params, img)


def test_test_scale_and_preprocess(pair):
    for h, w, budget in ((1080, 1920, (1333, 800)), (800, 1333, (1333, 800)),
                         (96, 128, SCALE), (480, 640, (1333, 800)),
                         (37, 91, (160, 96))):
        assert solov2.test_scale(h, w, *budget) == jsolo.test_scale(h, w, *budget)
    assert solov2.test_scale(1080, 1920) == (750, 1333)
    _params, _model, frame, (j_img, j_hw), _ = pair
    for f, scale in ((frame, SCALE), (frame[:, :90, :101], (160, 96))):
        j_img, j_hw = jsolo.preprocess(jnp.asarray(f), scale=scale)
        img, hw = solov2.preprocess(torch.from_numpy(np.ascontiguousarray(f)),
                                    scale=scale)
        assert hw == j_hw
        assert img.shape[-2] % 32 == 0 and img.shape[-1] % 32 == 0
        _close(img.permute(0, 2, 3, 1), j_img, 1e-6)


def test_resnet_fpn_and_head(pair):
    _params, model, _frame, (j_img, _hw), (j_feats, j_fpn, j_heads) = pair
    with torch.inference_mode():
        feats = resnet.forward(model.backbone, _nchw(j_img))
        fpn = solov2.fpn_forward(model.neck, feats)
        kernels, cls, mask_feats = solov2.head_forward(model.mask_head, fpn, CFG)
    assert len(feats) == 4 and len(fpn) == 5
    for ours, theirs in zip((*feats, *fpn), (*j_feats, *j_fpn)):
        _close(ours.permute(0, 2, 3, 1), theirs, 1e-4)
    j_kernels, j_cls, j_mask_feats = j_heads
    for ours, theirs in zip((*kernels, *cls, mask_feats),
                            (*j_kernels, *j_cls, j_mask_feats)):
        _close(ours.permute(0, 2, 3, 1), theirs, 1e-4)


def _nms_case(K, masks, labels, scores, valid):
    masks = np.asarray(masks, np.float32)
    j = jsolo.matrix_nms_static(
        jnp.asarray(masks), jnp.asarray(labels), jnp.asarray(scores, np.float32),
        jnp.asarray(masks.sum(1)), jnp.asarray(valid), 2.0, precision="highest")
    ours = solov2.matrix_nms_static(
        torch.from_numpy(masks), torch.tensor(labels),
        torch.tensor(scores, dtype=torch.float32),
        torch.from_numpy(masks.sum(1)), torch.tensor(valid), 2.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    return ours


def test_matrix_nms_static():
    rng = np.random.default_rng(4)
    K, M = 24, 400
    masks = rng.uniform(size=(K, M)) > 0.6
    masks[1] = masks[0]                      # duplicates with one label
    masks[2, :200] = masks[0, :200]
    masks[5] = False                         # an empty row
    labels = rng.integers(0, 3, size=K)
    labels[:3] = 1
    scores = np.sort(rng.uniform(0.2, 1.0, size=K))[::-1].copy()
    scores[3:7] = scores[3]                  # equal scores
    valid = np.ones(K, bool)
    valid[-5:] = False                       # invalid rows last, score 0
    scores[-5:] = 0.0
    out = _nms_case(K, masks, labels, scores, valid)
    assert float(out[1]) < 0.2 * float(scores[1])  # IoU 1 under one label
    # all labels equal, all scores equal
    _nms_case(K, masks, np.zeros(K, np.int64), np.full(K, 0.5), np.ones(K, bool))
    # the hand-made case of tests/test_solov2.py: a duplicate, a disjoint one
    base = np.zeros((8, 100), np.float32)
    base[0, :50] = base[1, :50] = base[2, 50:] = 1
    out = _nms_case(8, base, np.zeros(8, np.int64),
                    [0.9, 0.8, 0.7] + [0.0] * 5, [True] * 3 + [False] * 5)
    assert out[0] == pytest.approx(0.9) and out[2] == pytest.approx(0.7)


def _jax_slab_and_probs(heads, img_hw, monkeypatch):
    """JAX get_results, run op by op, with its last resize captured: the
    mask probabilities before the threshold."""
    seen = []
    real = jsolo.resize2d

    def capture(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out)
        return out

    monkeypatch.setattr(jsolo, "resize2d", capture)
    k, c, m = heads
    slab = jsolo.get_results(k, c, m, img_hw, HW, jsolo.SOLOv2Config())
    return slab, np.asarray(seen[-1])[..., 0]


def _check_slab(ours, theirs, j_probs):
    valid = np.asarray(theirs["valid"])
    n_valid = int(valid.sum())
    print(f"valid instances: {n_valid} of {valid.size}")
    assert n_valid > 0
    np.testing.assert_array_equal(ours["valid"].numpy(), valid)
    np.testing.assert_array_equal(ours["labels"].numpy()[valid],
                                  np.asarray(theirs["labels"])[valid])
    np.testing.assert_allclose(ours["scores"].numpy(), np.asarray(theirs["scores"]),
                               rtol=0, atol=1e-5)
    probs = ours["probs"].numpy()[valid]
    np.testing.assert_allclose(probs, j_probs[valid], rtol=0, atol=1e-4)
    flipped = (probs > 0.5) != np.asarray(theirs["masks"])[valid]
    assert flipped.mean() <= 1e-3, flipped.mean()
    np.testing.assert_array_equal(ours["masks"].numpy(), ours["probs"].numpy() > 0.5)


def test_get_results_on_the_same_head_outputs(pair, monkeypatch):
    _params, _model, _frame, (_img, hw), (_f, _p, heads) = pair
    theirs, j_probs = _jax_slab_and_probs(heads, hw, monkeypatch)
    k, c, m = heads
    with torch.inference_mode():
        ours = solov2.get_results([_nchw(t) for t in k], [_nchw(t) for t in c],
                                  _nchw(m), hw, HW, CFG)
    _check_slab(ours, theirs, j_probs)


def test_forward_slab(pair, monkeypatch):
    _params, model, frame, (_img, hw), (_f, _p, heads) = pair
    theirs, j_probs = _jax_slab_and_probs(heads, hw, monkeypatch)
    with torch.inference_mode():
        img, img_hw = solov2.preprocess(torch.from_numpy(frame), scale=SCALE)
        ours = solov2.forward(model, torch.cat([img, img]), img_hw, HW)
    assert len(ours) == 2
    for a, b in zip(ours[0].values(), ours[1].values()):
        assert torch.equal(a, b)  # one batch, one answer per frame
    ours = {k: v.numpy() for k, v in ours[0].items()}
    valid = np.asarray(theirs["valid"])
    print(f"valid instances: {int(valid.sum())} of {valid.size}")
    assert valid.sum() > 0 and ours["valid"].sum() == valid.sum()
    free = set(np.nonzero(ours["valid"])[0])
    for i in np.nonzero(valid)[0]:
        cands = [j for j in free if ours["labels"][j] == theirs["labels"][i]]
        errs = [np.abs(ours["probs"][j] - j_probs[i]).max() for j in cands]
        assert cands and min(errs) <= 1e-4, (i, errs)
        j = cands[int(np.argmin(errs))]
        assert abs(ours["scores"][j] - float(theirs["scores"][i])) <= 5e-3
        free.remove(j)


def _blobs(rng, shape, n=3):
    mask = np.zeros(shape, bool)
    for _ in range(n):
        y, x = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
        h, w = rng.integers(4, 40), rng.integers(4, 40)
        mask[y:y + h, x:x + w] = True
    return mask


@pytest.mark.parametrize("case", ["blobs", "speckle", "empty", "full", "far"])
def test_sdf_green_device(case):
    rng = np.random.default_rng(7)
    mask = {"blobs": lambda: _blobs(rng, (96, 128)),
            "speckle": lambda: rng.random((64, 200)) > 0.95,
            "empty": lambda: np.zeros((48, 48), bool),
            "full": lambda: np.ones((48, 48), bool),
            "far": lambda: np.pad(np.ones((1, 1), bool), ((0, 299), (0, 299)))}[case]()
    ours = sdf.sdf_green_device(torch.from_numpy(mask)).numpy()
    theirs = np.asarray(jsdf.sdf_green_device(jnp.asarray(mask)))
    np.testing.assert_array_equal(ours, theirs)
    host = sdf.mask_sdf_channel(np.stack([mask * 255.0] * 3, axis=-1))
    np.testing.assert_array_equal((ours.astype(np.float64) * 255.0).astype(np.uint8),
                                  (host * 255.0).astype(np.uint8))
    # batched: each frame as alone
    both = sdf.sdf_green_device(torch.from_numpy(np.stack([mask, ~mask])))
    assert torch.equal(both[0], torch.from_numpy(ours))
