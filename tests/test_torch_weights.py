"""The port's weights: reference-key state_dicts, the JAX converter round
trip, and checkpoint files in each on-disk format, for relative
Depth-Anything, metric Depth-Anything (ZoeDepth head), SOLOv2, ZoeD_N,
PatchFusion, MiDaS (DPT_Large, v2.1) and Marigold (the diffusers
snapshot)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prisma_tpu.weights.torch_convert import (convert_checked,
                                              convert_depth_anything,
                                              convert_metric_depth_anything,
                                              convert_midas2,
                                              convert_midas_dpt,
                                              convert_patchfusion,
                                              convert_solov2, convert_zoed)
from prisma_tpu_torch.models import beit
from prisma_tpu_torch.models import depth_anything as da
from prisma_tpu_torch.models import marigold as mg
from prisma_tpu_torch.models import midas, sd2
from prisma_tpu_torch.models import patchfusion as pf
from prisma_tpu_torch.models import solov2, vit, zoed
from prisma_tpu_torch.models import zoedepth as zoe
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights import store
from prisma_tpu_torch.weights.from_jax import (depth_anything_state_dict,
                                               marigold_state_dict,
                                               metric_depth_anything_state_dict,
                                               midas2_state_dict,
                                               midas_dpt_state_dict,
                                               patchfusion_state_dict,
                                               solov2_state_dict,
                                               zoed_state_dict)

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


# The BEiT-core families: ZoeD_N and PatchFusion, narrow (a BEiT 64 wide,
# 4 heads, 4 blocks; 32 features) in the checkpoints' key layouts.
BEIT_NARROW = dict(beit_cfg=beit.BEiTConfig(embed_dim=64, depth=4, num_heads=4),
                   features=32, out_channels=(16, 32, 64, 64))


@pytest.fixture(scope="module")
def beit_models():
    z = zoed.init_params(zoed.build(**BEIT_NARROW),
                         torch.Generator().manual_seed(3))
    p = pf.init_params(pf.build(**BEIT_NARROW, model_hw=pf.MODEL_HW),
                       torch.Generator().manual_seed(4))
    return {"zoed": z, "patchfusion": p}


BEIT_KEYS = {
    "zoed": ("core.core.pretrained.model.cls_token",
             "core.core.pretrained.model.patch_embed.proj.weight",
             "core.core.pretrained.model.blocks.3.attn.qkv.weight",
             "core.core.pretrained.model.blocks.0.attn.q_bias",
             "core.core.pretrained.model.blocks.0.attn.v_bias",
             "core.core.pretrained.model.blocks.2.attn.relative_position_bias_table",
             "core.core.pretrained.model.blocks.1.gamma_1",
             "core.core.pretrained.model.blocks.1.gamma_2",
             "core.core.pretrained.act_postprocess1.0.project.0.weight",
             "core.core.pretrained.act_postprocess1.3.bias",
             "core.core.pretrained.act_postprocess1.4.weight",
             "core.core.pretrained.act_postprocess2.4.weight",
             "core.core.pretrained.act_postprocess4.4.weight",
             "core.core.scratch.layer4_rn.weight",
             "core.core.scratch.refinenet1.resConfUnit2.conv1.bias",
             "core.core.scratch.refinenet4.out_conv.weight",
             "core.core.scratch.output_conv.0.weight",
             "core.core.scratch.output_conv.2.bias",
             "core.core.scratch.output_conv.4.weight",
             "conv2.weight", "seed_bin_regressor._net.2.bias",
             "attractors.3._net.0.weight",
             "conditional_log_binomial.mlp.2.weight"),
    "patchfusion": (
        "coarse_model.core.core.pretrained.model.blocks.0.attn.q_bias",
        "fine_model.core.core.scratch.output_conv.4.bias",
        "fine_model.conditional_log_binomial.mlp.0.weight",
        "coarse_input_proj.5.weight", "fine_input_proj.4.bias",
        "fusion_conv_list.5.weight",
        "fusion_extractor.inc.double_conv.0.weight",
        "fusion_extractor.inc.double_conv.1.running_var",
        "fusion_extractor.down5.maxpool_conv.1.double_conv.4.weight",
        "fusion_extractor.up1.conv.double_conv.0.bias",
        "fusion_extractor.up5.conv.double_conv.2.weight",
        "fusion_extractor.conv0.double_conv.2.bias",
        "fusion_extractor.conv5.double_conv.0.weight",
        "fusion_extractor.g2l0.embed_proj.weight",
        "fusion_extractor.g2l5.absolute_pos_embed",
        "fusion_extractor.g2l3.g2l_layer.blocks.2.attn.qkv.bias",
        "fusion_extractor.g2l0.g2l_layer.blocks.1.attn."
        "relative_position_bias_table",
        "fusion_extractor.g2l1.g2l_layer.blocks.0.mlp.fc2.weight",
        "fusion_extractor.g2l4.g2l_layer_norm.bias",
        "conv2.weight", "projectors.0._net.0.weight",
        "conditional_log_binomial.mlp.2.bias")}


@pytest.mark.parametrize("family", ["zoed", "patchfusion"])
def test_beit_family_keys_are_the_reference_checkpoints(beit_models, family):
    keys = set(beit_models[family].state_dict())
    for k in BEIT_KEYS[family]:
        assert k in keys, k
    # the UNet's DoubleConvs under a batch norm have no conv bias
    assert ("fusion_extractor.inc.double_conv.0.bias" not in keys
            and "core.core.pretrained.model.blocks.0.attn.qkv.bias" not in keys
            if family == "patchfusion"
            else "core.core.pretrained.model.blocks.0.attn.qkv.bias" not in keys)
    assert not any(k.endswith("relative_position_index") for k in keys)


@pytest.mark.parametrize("family", ["zoed", "patchfusion"])
def test_beit_family_convert_then_from_jax_round_trip(beit_models, family):
    """Exact but the UNet's batch norms, which convert_patchfusion folds and
    from_jax unfolds to mean 0, variance 1 - eps: their folded scale and
    shift come back within an ulp; every key is read by the JAX
    converter."""
    sd = beit_models[family].state_dict()
    np_sd = {k: v.numpy() for k, v in sd.items()}
    if family == "zoed":
        params = convert_checked(convert_zoed, {"model": np_sd})
        back = zoed_state_dict(jax.tree.map(np.asarray, params))
    else:
        params = convert_checked(convert_patchfusion, np_sd)
        back = patchfusion_state_dict(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)

    def folded(d, bn):
        scale = d[bn + "weight"] / torch.sqrt(d[bn + "running_var"] + 1e-5)
        return scale, d[bn + "bias"] - d[bn + "running_mean"] * scale

    for k, v in sd.items():
        if ".double_conv.1." in k or ".double_conv.4." in k:
            bn = k[:k.rindex(".") + 1]
            for a, b in zip(folded(back, bn), folded(sd, bn)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2.4e-7,
                                           atol=0, err_msg=k)
        else:
            assert torch.equal(back[k], v), k


def _derived_buffers(sd: dict) -> dict:
    """The buffers a real checkpoint carries that the port computes."""
    extra = {}
    for k in sd:
        if k.endswith("attn.relative_position_bias_table"):
            extra[k.replace("bias_table", "index")] = torch.zeros(2, 2, dtype=torch.long)
        if ".g2l_layer.blocks.1." in k and k.endswith("norm1.weight"):
            extra[k.replace("norm1.weight", "attn_mask")] = torch.zeros(1, 4, 4)
        if k.endswith("conditional_log_binomial.mlp.0.weight"):
            p = k.replace("mlp.0.weight", "log_binomial_transform.")
            extra[p + "k_idx"] = torch.arange(64.0).view(1, -1, 1, 1)
            extra[p + "K_minus_1"] = torch.tensor([63.0])
    return extra


@pytest.mark.parametrize("family", ["zoed", "patchfusion"])
def test_beit_family_checkpoint_files_load_strict(tmp_path, beit_models, family):
    """ZoeD_M12_N.pt under 'model', patchfusion_u4k.pt raw without its batch
    norms' step counters; both with the derived buffers. Each loads with
    strict=True; a missing key raises."""
    sd = beit_models[family].state_dict()
    runtime = RuntimeConfig(models_dir=str(tmp_path), random_weights=False,
                            device="cpu")
    if family == "zoed":
        torch.save({"model": {**sd, **_derived_buffers(sd)}},
                   tmp_path / "ZoeD_M12_N.pt")
        loaded = store.load_zoed(runtime)
    else:
        payload = {k: v for k, v in {**sd, **_derived_buffers(sd)}.items()
                   if not k.endswith("num_batches_tracked")}
        torch.save(payload, tmp_path / "patchfusion_u4k.pt")
        loaded, model_hw = store.load_patchfusion(runtime)
        assert model_hw == (384, 512)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    broken = dict(sd)
    del broken["attractors.1._net.2.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        (store.zoed_from_state_dict if family == "zoed"
         else store.patchfusion_from_state_dict)(broken)


def test_beit_family_random_init_is_seeded(monkeypatch, tmp_path):
    monkeypatch.setenv("PRISMA_ZOED_DEPTH", "4")
    monkeypatch.setenv("PRISMA_PF_DEPTH", "4")
    monkeypatch.setenv("PRISMA_PF_SIZE", "64,96")
    runtime = RuntimeConfig(random_weights=True, device="cpu")
    a = store.load_zoed(runtime).state_dict()
    b = store.load_zoed(runtime).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["core.core.pretrained.model.patch_embed.proj.weight"].shape[0] == 1024
    assert torch.all(a["core.core.pretrained.model.blocks.0.gamma_1"] == 0.1)
    model, hw = store.load_patchfusion(runtime)
    assert hw == (64, 96) and model.model_hw == (64, 96)
    assert len(model.fine_model.core.core.pretrained.model.blocks) == 4
    assert model.fusion_extractor.g2l0.absolute_pos_embed.shape == (1, 64 * 96, 32)
    with pytest.raises(FileNotFoundError, match="ZoeD_M12_N.pt"):
        store.load_zoed(RuntimeConfig(models_dir=str(tmp_path), device="cpu"))
    with pytest.raises(FileNotFoundError, match="patchfusion_u4k.pt"):
        store.load_patchfusion(RuntimeConfig(models_dir=str(tmp_path),
                                             device="cpu"))


# MiDaS: DPT_Large (a timm ViT 64 wide, one head of 64, 4 blocks, the 24x24
# position grid; 16 features) and v2.1 (ResNeXt-101 32x8d at stem width 16;
# 32 features), in the hub checkpoints' layouts.
MIDAS_VIT = vit.ViTConfig(embed_dim=64, depth=4, num_heads=1, patch_size=16,
                          base_img_size=384, layerscale=False)


@pytest.fixture(scope="module")
def midas_models():
    gen = torch.Generator().manual_seed(5)
    dpt = midas.init_params(midas.build_dpt(MIDAS_VIT, 16, (8, 16, 32, 32)), gen)
    v2 = midas.init_params_v2(midas.build_v2(32, width=16), gen)
    with torch.no_grad():
        for m in v2.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.6, 1.4, generator=gen)
    return {"dpt": dpt, "v2": v2}


MIDAS_KEYS = {
    "dpt": ("pretrained.model.cls_token", "pretrained.model.pos_embed",
            "pretrained.model.patch_embed.proj.weight",
            "pretrained.model.blocks.3.attn.qkv.bias",
            "pretrained.model.blocks.0.mlp.fc2.weight",
            "pretrained.model.norm.weight",
            "pretrained.act_postprocess1.0.project.0.weight",
            "pretrained.act_postprocess1.4.weight",
            "pretrained.act_postprocess4.4.bias", "scratch.layer3_rn.weight",
            "scratch.refinenet2.out_conv.weight", "scratch.output_conv.4.bias"),
    "v2": ("pretrained.layer1.0.weight", "pretrained.layer1.1.running_var",
           "pretrained.layer1.4.2.conv2.weight",
           "pretrained.layer3.22.bn3.bias",
           "pretrained.layer4.0.downsample.1.weight",
           "scratch.layer4_rn.weight",
           "scratch.refinenet1.resConfUnit2.conv1.bias",
           "scratch.output_conv.0.weight")}


@pytest.mark.parametrize("arch", ["dpt", "v2"])
def test_midas_keys_are_the_reference_checkpoints(midas_models, arch):
    keys = set(midas_models[arch].state_dict())
    for k in MIDAS_KEYS[arch]:
        assert k in keys, k
    assert not any(".ls1." in k or "mask_token" in k for k in keys)
    if arch == "v2":  # no out conv in the v2.1 fusion blocks; bias-free rn
        assert not any("out_conv" in k for k in keys)
        assert "scratch.layer1_rn.bias" not in keys
        assert midas_models[arch].state_dict()[
            "pretrained.layer2.0.conv2.weight"].shape == (128, 4, 3, 3)


@pytest.mark.parametrize("arch", ["dpt", "v2"])
def test_midas_convert_then_from_jax_round_trip(midas_models, arch):
    """Exact, except v2.1's batch norms, which convert_midas2 folds and
    from_jax unfolds to mean 0, variance 1 - eps: their folded scale and
    shift come back within an ulp; every key is read by the JAX converter."""
    sd = midas_models[arch].state_dict()
    np_sd = {k: v.numpy() for k, v in sd.items()}
    if arch == "dpt":
        params = convert_checked(convert_midas_dpt, np_sd)
        back = midas_dpt_state_dict(jax.tree.map(np.asarray, params))
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        return
    params = convert_checked(convert_midas2, np_sd)
    back = midas2_state_dict(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)

    def folded(d, bn):
        scale = d[bn + "weight"] / torch.sqrt(d[bn + "running_var"] + 1e-5)
        return scale, d[bn + "bias"] - d[bn + "running_mean"] * scale

    for k, v in sd.items():
        bn = k[:k.rindex(".") + 1]
        if bn + "running_var" in sd:
            if k.endswith("weight"):
                for a, b in zip(folded(back, bn), folded(sd, bn)):
                    np.testing.assert_allclose(a.numpy(), b.numpy(),
                                               rtol=2.4e-7, atol=1e-9,
                                               err_msg=k)
        else:
            assert torch.equal(back[k], v), k


@pytest.mark.parametrize("version", ["midas3", "midas2-small"])
def test_midas_checkpoint_files_load_in_both_packages(tmp_path, monkeypatch,
                                                      midas_models, version):
    """`dpt_large_384.pt` with timm's classifier beside the backbone (which
    neither package reads) and `midas_v21_384.pt` without its batch norms'
    step counters: the port loads each strictly, the JAX package's own
    loader converts the same file, and the two disparities agree within
    1e-5 of their scale (f32 both sides)."""
    from prisma_tpu.models import midas as jmidas
    from prisma_tpu.models import vit as jvit
    from prisma_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
    from prisma_tpu.weights import store as jstore

    arch = "v2" if version.startswith("midas2") else "dpt"
    sd = midas_models[arch].state_dict()
    if arch == "dpt":
        D = MIDAS_VIT.embed_dim
        payload = {**sd, "pretrained.model.head.weight": torch.zeros(1000, D),
                   "pretrained.model.head.bias": torch.zeros(1000)}
        torch.save(payload, tmp_path / "dpt_large_384.pt")
        monkeypatch.setattr(jmidas, "MIDAS_VIT_CONFIG", jvit.ViTConfig(
            embed_dim=D, depth=4, num_heads=1, patch_size=16,
            base_img_size=384, layerscale=False))
        monkeypatch.setattr(jmidas, "HOOKS", (0, 1, 2, 3))
    else:
        torch.save({k: v for k, v in sd.items()
                    if not k.endswith("num_batches_tracked")},
                   tmp_path / "midas_v21_384.pt")
    got_arch, loaded = store.load_midas(RuntimeConfig(
        models_dir=str(tmp_path), random_weights=False, device="cpu"), version)
    assert got_arch == arch
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    j_arch, params = jstore.load_midas(JaxRuntimeConfig(
        models_dir=str(tmp_path), weight_cache=False), version)
    assert j_arch == arch
    frames = np.random.default_rng(7).integers(0, 256, (1, 40, 56, 3),
                                               dtype=np.uint8)
    infer, jinfer = ((midas.infer_v2, jmidas.infer_v2) if arch == "v2"
                     else (midas.infer, jmidas.infer))
    with torch.inference_mode():
        ours = infer(loaded, torch.from_numpy(frames), target=64).numpy()
    theirs = np.asarray(jinfer(params, frames, target=64))
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=1e-5 * np.abs(theirs).max())
    with pytest.raises(FileNotFoundError, match="midas_v21_384.pt"):
        store.load_midas(RuntimeConfig(models_dir=str(tmp_path / "none"),
                                       device="cpu"), "midas2")
    with pytest.raises(ValueError, match="unknown midas"):
        store.load_midas(RuntimeConfig(device="cpu"), "midas4")


# Marigold: a narrow diffusers snapshot (UNet 64, 64, 128, 128 with heads
# of 64; VAE 32, 32, 64, 64; 32 groups, the widths the JAX package's loader
# runs at; a 64-wide, 2-layer text tower), the VAE's mid-block attention in
# the names of diffusers before 0.14, the text encoder with its position ids.
SNAP_UNET = dict(block_channels=(64, 64, 128, 128), cross_attention_dim=64,
                 head_dim=64, norm_groups=32)
SNAP_VAE = dict(block_channels=(32, 32, 64, 64), norm_groups=32)
OLD_VAE_NAMES = {"to_q": "query", "to_k": "key", "to_v": "value",
                 "to_out.0": "proj_attn"}


def _write_snapshot(root, model, text):
    import json
    import os
    for sub in ("unet", "vae", "text_encoder"):
        os.makedirs(root / sub)
    sd = model.state_dict()
    unet = {k[5:]: v for k, v in sd.items() if k.startswith("unet.")}
    vae = {}
    for k, v in sd.items():
        if k.startswith("vae."):
            k = k[4:]
            for new, old in OLD_VAE_NAMES.items():
                k = k.replace(f"attentions.0.{new}.", f"attentions.0.{old}.")
            vae[k] = v
    torch.save(unet, root / "unet" / "diffusion_pytorch_model.bin")
    torch.save(vae, root / "vae" / "diffusion_pytorch_model.bin")
    torch.save({**text.state_dict(), "text_model.embeddings.position_ids":
                torch.arange(77)[None]},
               root / "text_encoder" / "pytorch_model.bin")
    for sub, conf in (("unet", {"attention_head_dim": [1, 1, 2, 2],
                                "norm_num_groups": 32}),
                      ("vae", {"norm_num_groups": 32}),
                      ("text_encoder", {"num_attention_heads": 2,
                                        "bos_token_id": 49406,
                                        "eos_token_id": 49407})):
        with open(root / sub / "config.json", "w") as f:
            json.dump(conf, f)


def test_marigold_snapshot_loads_in_both_packages(tmp_path, monkeypatch):
    """The port loads `marigold/{unet,vae,text_encoder}` strictly (the old
    VAE names mapped, the position ids dropped) and computes the empty
    prompt's embedding with its own text tower; the JAX package's
    `convert_marigold` reads the same files: its trees carried back equal
    the port's state_dict, the embeddings agree within 1e-6, and one UNet
    call agrees within 1e-5 of its scale."""
    from prisma_tpu.models import marigold as jmar
    from prisma_tpu.models import sd2 as jsd2
    from prisma_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
    from prisma_tpu.weights import store as jstore

    gen = torch.Generator().manual_seed(6)
    model = mg.init_params(mg.build(sd2.UNetConfig(**SNAP_UNET),
                                    sd2.VAEConfig(**SNAP_VAE)), gen)
    text_cfg = mg.CLIPTextConfig(width=64, heads=2, layers=2)
    text = mg.init_text(mg.build_text(text_cfg), gen)
    _write_snapshot(tmp_path / "marigold", model, text)
    loaded = store.load_marigold(RuntimeConfig(models_dir=str(tmp_path),
                                               device="cpu"))
    sd = model.state_dict()
    assert set(loaded.state_dict()) == set(sd)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert loaded.unet.cfg == sd2.UNetConfig(**SNAP_UNET)
    with torch.inference_mode():
        embed = mg.empty_text_embed(text)
    assert torch.equal(loaded.empty_text_embed, embed)

    real = jmar.empty_text_embed
    monkeypatch.setattr(jmar, "empty_text_embed", lambda p: real(
        p, jmar.CLIPTextConfig(width=64, heads=2, layers=2)))
    params, _ucfg = jstore.load_marigold(JaxRuntimeConfig(
        models_dir=str(tmp_path), weight_cache=False))
    back = marigold_state_dict(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    np.testing.assert_allclose(np.asarray(params["empty_text_embed"]),
                               embed.numpy(), rtol=0, atol=1e-6)
    x = np.random.default_rng(8).normal(size=(1, 12, 16, 8)).astype(np.float32)
    ctx = np.asarray(params["empty_text_embed"])
    theirs = np.asarray(jax.jit(jsd2.unet_forward, static_argnums=(4,))(
        params["unet"], jnp.asarray(x), jnp.asarray([301]), jnp.asarray(ctx),
        jsd2.UNetConfig(**SNAP_UNET))).transpose(0, 3, 1, 2)
    with torch.inference_mode():
        ours = sd2.unet_forward(loaded.unet, torch.from_numpy(
            x.transpose(0, 3, 1, 2).copy()), torch.tensor([301]),
            loaded.empty_text_embed).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=1e-5 * np.abs(theirs).max())


def test_midas_and_marigold_random_init_is_seeded(monkeypatch):
    """Random MiDaS at full width (DPT_Large: ViT-L/16 at 384; v2.1:
    ResNeXt-101 32x8d), and the tiny Marigold with its text tower run."""
    runtime = RuntimeConfig(random_weights=True, device="cpu")
    arch, a = store.load_midas(runtime, "midas3-small")
    assert arch == "dpt" and a.pretrained.model.cfg == midas.VIT_CONFIG
    assert a.pretrained.model.pos_embed.shape == (1, 577, 1024)
    arch, b = store.load_midas(runtime, "midas2")
    assert arch == "v2"
    assert b.pretrained.layer4[0].conv2.weight.shape == (2048, 64, 3, 3)
    monkeypatch.setenv("PRISMA_MARIGOLD_TINY", "1")
    m1 = store.load_marigold(runtime)
    m2 = store.load_marigold(runtime)
    assert torch.equal(m1.empty_text_embed, m2.empty_text_embed)
    assert m1.empty_text_embed.shape == (1, 2, 64)
    assert bool(m1.empty_text_embed.abs().sum() > 0)
    assert all(torch.equal(v, m2.state_dict()[k])
               for k, v in m1.state_dict().items())
    with pytest.raises(FileNotFoundError, match="Bingxin/Marigold"):
        store.load_marigold(RuntimeConfig(models_dir="/nonexistent",
                                          device="cpu"))
