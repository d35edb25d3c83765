"""The port's weights: reference-key state_dicts, the JAX converter round
trip, and checkpoint files in each on-disk format."""

import numpy as np
import pytest
import torch

import jax

from prisma_tpu.weights.torch_convert import convert_depth_anything
from prisma_tpu_torch.models import depth_anything as da
from prisma_tpu_torch.models import vit
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights import store
from prisma_tpu_torch.weights.from_jax import depth_anything_state_dict

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        store.load_depth_anything(runtime, encoder="vitl", metric="outdoor")
