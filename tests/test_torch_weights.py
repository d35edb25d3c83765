"""The port's weights: reference-key state_dicts, the JAX converter round
trip, and checkpoint files in each on-disk format, for relative
Depth-Anything, metric Depth-Anything (ZoeDepth head) and SOLOv2."""

import numpy as np
import pytest
import torch

import jax

from prisma_tpu.weights.torch_convert import (convert_checked,
                                              convert_depth_anything,
                                              convert_metric_depth_anything,
                                              convert_solov2)
from prisma_tpu_torch.models import depth_anything as da
from prisma_tpu_torch.models import solov2, vit
from prisma_tpu_torch.models import zoedepth as zoe
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights import store
from prisma_tpu_torch.weights.from_jax import (depth_anything_state_dict,
                                               metric_depth_anything_state_dict,
                                               solov2_state_dict)

TINY = vit.ViTConfig(embed_dim=64, depth=2, num_heads=2)
# the real vits checkpoint's DPT layout in miniature: widths differ per level
FEATURES, OUT_CHANNELS = 16, (8, 16, 32, 32)


@pytest.fixture(scope="module")
def model():
    m = da.build(TINY, FEATURES, OUT_CHANNELS)
    return da.init_params(m, torch.Generator().manual_seed(0))


def test_state_dict_keys_are_the_reference_checkpoints(model):
    keys = set(model.state_dict())
    for k in ("pretrained.cls_token", "pretrained.pos_embed",
              "pretrained.mask_token", "pretrained.patch_embed.proj.weight",
              "pretrained.blocks.1.attn.qkv.weight",
              "pretrained.blocks.1.ls2.gamma", "pretrained.norm.bias",
              "depth_head.projects.3.weight",
              "depth_head.resize_layers.0.weight",
              "depth_head.resize_layers.3.bias",
              "depth_head.scratch.layer4_rn.weight",
              "depth_head.scratch.refinenet4.resConfUnit1.conv1.weight",
              "depth_head.scratch.output_conv2.2.bias"):
        assert k in keys, k
    assert not any("resize_layers.2" in k for k in keys)  # the identity


def test_convert_then_from_jax_round_trip_is_exact(model):
    sd = model.state_dict()
    params = convert_depth_anything({k: v.numpy() for k, v in sd.items()},
                                    depth=TINY.depth)
    back = depth_anything_state_dict(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_load_state_dict_strict(model):
    sd = model.state_dict()
    loaded = store.depth_anything_from_state_dict(sd, TINY)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    del sd["depth_head.scratch.refinenet2.out_conv.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        da.build(TINY, FEATURES, OUT_CHANNELS).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("layout", ["raw", "module", "model", "state_dict"])
def test_checkpoint_file_layouts_load(tmp_path, monkeypatch, model, layout):
    monkeypatch.setitem(vit.VIT_CONFIGS, "tiny", TINY)
    sd = model.state_dict()
    payload = {"raw": sd,
               "module": {"module." + k: v for k, v in sd.items()},
               "model": {"model": sd, "epoch": 3},
               "state_dict": {"state_dict": sd}}[layout]
    torch.save(payload, tmp_path / "depth_anything_tiny14.pt")
    runtime = RuntimeConfig(models_dir=str(tmp_path), random_weights=False,
                            device="cpu")
    kind, loaded, enc = store.load_depth_anything(runtime, encoder="tiny")
    assert (kind, enc) == ("relative", "tiny")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_random_init_is_seeded(monkeypatch):
    monkeypatch.setitem(vit.VIT_CONFIGS, "tiny", TINY)
    runtime = RuntimeConfig(random_weights=True, device="cpu")
    a = store.load_depth_anything(runtime, encoder="tiny")[1].state_dict()
    b = store.load_depth_anything(runtime, encoder="tiny")[1].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["pretrained.pos_embed"].std()) == pytest.approx(0.02, rel=0.1)
    assert torch.all(a["pretrained.blocks.0.ls1.gamma"] == 1)


def test_missing_checkpoint_and_metric_raise(tmp_path):
    runtime = RuntimeConfig(models_dir=str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        store.load_depth_anything(runtime, encoder="vits")
    with pytest.raises(FileNotFoundError,
                       match="depth_anything_metric_depth_outdoor.pt"):
        store.load_depth_anything(runtime, encoder="vitl", metric="outdoor")
    with pytest.raises(FileNotFoundError, match="solov2_r101_fpn_3x_coco"):
        store.load_solov2(runtime)


# The other families: the metric model over the tiny core, and SOLOv2 R101.
@pytest.fixture(scope="module")
def family_models():
    metric = zoe.init_params(zoe.build(TINY, FEATURES, OUT_CHANNELS),
                             torch.Generator().manual_seed(1))
    solo = solov2.init_params(solov2.build(), torch.Generator().manual_seed(2))
    return {"metric": metric, "solov2": solo}


FAMILY_KEYS = {
    "metric": ("core.core.pretrained.pos_embed",
               "core.core.pretrained.blocks.1.attn.qkv.weight",
               "core.core.depth_head.scratch.output_conv2.2.bias",
               "conv2.weight", "seed_bin_regressor._net.2.bias",
               "seed_projector._net.0.weight", "projectors.3._net.2.weight",
               "attractors.0._net.2.weight", "attractors.3._net.0.bias",
               "conditional_log_binomial.mlp.0.weight",
               "conditional_log_binomial.mlp.2.bias"),
    "solov2": ("backbone.conv1.weight", "backbone.bn1.running_var",
               "backbone.layer3.22.conv3.weight",
               "backbone.layer4.0.downsample.1.weight",
               "neck.lateral_convs.3.conv.bias", "neck.fpn_convs.0.conv.weight",
               "mask_head.mask_feature_head.convs_all_levels.0.conv0.conv.weight",
               "mask_head.mask_feature_head.convs_all_levels.3.conv2.gn.bias",
               "mask_head.mask_feature_head.conv_pred.conv.weight",
               "mask_head.kernel_convs.0.conv.weight",
               "mask_head.cls_convs.3.gn.weight", "mask_head.conv_kernel.bias",
               "mask_head.conv_cls.weight")}


@pytest.mark.parametrize("family", ["metric", "solov2"])
def test_family_state_dict_keys_are_the_reference_checkpoints(family_models,
                                                               family):
    keys = set(family_models[family].state_dict())
    for k in FAMILY_KEYS[family]:
        assert k in keys, k
    if family == "solov2":
        # mmcv ConvModules under a norm have no conv bias; 4 + 1 levels' convs
        assert "mask_head.kernel_convs.0.conv.bias" not in keys
        assert not any("convs_all_levels.0.conv1" in k for k in keys)


@pytest.mark.parametrize("family", ["metric", "solov2"])
def test_family_convert_then_from_jax_round_trip(family_models, family):
    """Exact, except SOLOv2's batch norms, which convert_solov2 folds and
    from_jax unfolds to variance 1 - eps: their weights come back within an
    ulp ((1 - eps) + eps rounds in f32); every key is read by the JAX
    converter."""
    sd = family_models[family].state_dict()
    np_sd = {k: v.numpy() for k, v in sd.items()}
    if family == "metric":
        params = convert_checked(convert_metric_depth_anything, np_sd,
                                 depth=TINY.depth)
        back = metric_depth_anything_state_dict(jax.tree.map(np.asarray, params))
        sd = {k: v for k, v in sd.items() if not k.endswith("mask_token")}
        back.pop("core.core.pretrained.mask_token")
    else:
        params = convert_checked(convert_solov2, np_sd)
        back = solov2_state_dict(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if ".bn" in k or "downsample.1" in k:
            np.testing.assert_allclose(back[k].numpy(), v.numpy(), rtol=1.2e-7,
                                       atol=0, err_msg=k)
        else:
            assert torch.equal(back[k], v), k


@pytest.mark.parametrize("family", ["metric", "solov2"])
def test_family_load_state_dict_strict(family_models, family):
    sd = family_models[family].state_dict()
    if family == "metric":
        loaded = store.metric_depth_anything_from_state_dict(sd, TINY)
        fresh = zoe.build(TINY, FEATURES, OUT_CHANNELS)
        drop = "attractors.2._net.0.bias"
    else:
        loaded = solov2.build()
        loaded.load_state_dict(sd, strict=True)
        fresh = solov2.build()
        drop = "mask_head.cls_convs.1.gn.weight"
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    del sd[drop]
    with pytest.raises(RuntimeError, match="Missing key"):
        fresh.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("family,layout", [
    ("metric", "model"), ("metric", "raw"), ("solov2", "state_dict"),
    ("solov2", "no_step_counters")])
def test_family_checkpoint_file_layouts_load(tmp_path, monkeypatch,
                                             family_models, family, layout):
    """The metric checkpoint sits under 'model' and carries the log-binomial
    buffers derived from the bin count; the mmdet one under 'state_dict',
    with or without batch-norm step counters. Both load strictly."""
    sd = family_models[family].state_dict()
    if family == "metric":
        monkeypatch.setitem(vit.VIT_CONFIGS, "vitl", TINY)  # files are ViT-L
        extra = {"conditional_log_binomial.log_binomial_transform.k_idx":
                 torch.arange(64.0).view(1, -1, 1, 1),
                 "conditional_log_binomial.log_binomial_transform.K_minus_1":
                 torch.tensor([63.0])}
        payload = {"model": {**sd, **extra}} if layout == "model" else sd
        torch.save(payload, tmp_path / "depth_anything_metric_depth_indoor.pt")
        runtime = RuntimeConfig(models_dir=str(tmp_path), random_weights=False,
                                device="cpu")
        kind, loaded, enc = store.load_depth_anything(runtime, encoder="vits",
                                                      metric="indoor")
        assert (kind, enc) == ("metric", "vitl")
    else:
        payload = {k: v for k, v in sd.items()
                   if layout == "state_dict" or "num_batches_tracked" not in k}
        torch.save({"state_dict": payload, "meta": {"epoch": 36}},
                   tmp_path / "solov2_r101_fpn_3x_coco_20220512_125856.pth")
        loaded = store.load_solov2(RuntimeConfig(
            models_dir=str(tmp_path), random_weights=False, device="cpu"))
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_family_random_init_is_seeded():
    runtime = RuntimeConfig(random_weights=True, device="cpu")
    a = store.load_solov2(runtime).state_dict()
    b = store.load_solov2(runtime).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["mask_head.cls_convs.0.gn.weight"] == 1)
    w = a["backbone.layer1.0.conv2.weight"]
    assert float(w.std()) == pytest.approx(w[0].numel() ** -0.5, rel=0.1)
    kind, m, enc = store.load_depth_anything(runtime, encoder="vits",
                                             metric="outdoor")
    assert (kind, enc) == ("metric", "vits")
    # the JAX package's random metric core: features 64 for vits
    assert m.conv2.weight.shape == (64, 64, 1, 1)
    assert torch.all(m.conv2.bias == 0)
