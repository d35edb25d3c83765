"""The fused loop's device part (bands/multiband.FusedDispatch) and the
segment step over it (multiband.segment_step): on the CPU at tiny sizes,
the segment step's rows equal what run_fused's sinks receive for the same
frames; it takes segments of any length from 2 frames, in run_fused's
batches and flow windows, and counts what it dispatches; the mask step,
SOLOv2 and the metric Depth-Anything open their spans."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from prisma_tpu_torch.bands import multiband
from prisma_tpu_torch.runtime.profiling import StageProfiler
from tests.test_multiband import _make_video
from tests.test_torch_multiband import narrow_mask, small_mask  # noqa: F401
from tests.test_torch_tracing import STAGES, _inside, _prisma_events

BATCH = 8


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_segment_rows_equal_what_run_fused_sinks_receive(tmp_path,
                                                         narrow_mask,
                                                         monkeypatch):
    """A 9-frame clip through run_fused (batches of 4, the last padded; flow
    windows of 4 frames, the tail padded) and its frames through the
    segment step built over the same steps: every row the sinks received
    equals the segment step's, bit for bit."""
    from prisma_tpu_torch.bands import depth_base, flow_base, mask_band
    from prisma_tpu_torch.runtime.config import RuntimeConfig

    clip = str(tmp_path / "clip.mp4")
    _make_video(clip, frames=9)
    runtime = RuntimeConfig(random_weights=True, compute_dtype="float32",
                            batch_size=4, segment_frames=0, device="cpu")
    options = dict(mask_on=True, mask_sdf=True, depth_band="depth_anything",
                   depth_build={"encoder": "vits", "img_size": (42, 56),
                                "metric": "outdoor"},
                   flow_band="flow_gmflow")
    decoded, received = [], {}
    real_batch = multiband.FusedDispatch.batch

    def batch(self, frames, valid):
        decoded.extend(frames[:valid])
        return real_batch(self, frames, valid)

    def recorder(band, sink):
        real_emit = sink.emit

        def emit(self, out, n):
            for k, v in out.items():
                received.setdefault(f"{band}.{k}", []).append(v[:n].copy())
            return real_emit(self, out, n)
        return emit

    monkeypatch.setattr(multiband.FusedDispatch, "batch", batch)
    for band, sink in (("mask", mask_band.MaskVideoSink),
                       ("depth", depth_base.DepthVideoSink),
                       ("flow", flow_base.FlowVideoSink)):
        monkeypatch.setattr(sink, "emit", recorder(band, sink))
    multiband.run_fused(clip, runtime, **options)
    monkeypatch.setattr(multiband.FusedDispatch, "batch", real_batch)
    assert len(decoded) == 9

    step = multiband.build_segment_step(runtime, 64, 96, **{
        k: v for k, v in options.items() if k != "mask_on"})
    rows = step(np.stack(decoded))
    assert sorted(rows) == sorted(received) == [
        "depth.heat", "depth.max", "depth.min", "flow.fwd_rgb",
        "flow.max_disp", "mask.composite", "mask.green"]
    for k, v in rows.items():
        want = np.concatenate(received[k])
        if k.startswith("flow."):
            assert len(want) == 8  # the 8 pairs
        else:
            want = want[:8]  # run_fused's 9th frame lies past the segment
        assert v.dtype == want.dtype and v.shape == want.shape, k
        np.testing.assert_array_equal(v, want, err_msg=k)
    assert step.counts == Counter({"mask batches": 2, "depth batches": 2,
                                   "flow windows": 3,
                                   "padded flow frames": 1})


def _fake_steps():
    """Steps that return each frame's index (the frames carry it in every
    pixel): the mask and depth steps one row a frame, the flow step one row
    a pair with both ends."""
    def mask(frames):
        return {"composite": frames[:, 0, 0, 0].astype(np.float32),
                "green": frames[:, 0, 0, 1].astype(np.float32)}

    def depth(frames):
        return {"min": frames[:, 0, 0, 0].astype(np.float32)}

    def flow(window):
        assert len(window) == BATCH
        return {"first": window[:-1, 0, 0, 0], "second": window[1:, 0, 0, 0]}

    return mask, depth, flow


@pytest.mark.parametrize("T", [2, 9, 29, 57])
def test_a_segment_of_any_length_and_its_counts(T):
    step = multiband.segment_step(*_fake_steps(), BATCH)
    frames = np.broadcast_to(np.arange(T, dtype=np.uint8)[:, None, None,
                                                            None],
                             (T, 4, 6, 3)).copy()
    rows = step(frames)
    n = T - 1
    assert set(rows) == {"mask.composite", "mask.green", "depth.min",
                         "flow.first", "flow.second"}
    assert all(len(v) == n for v in rows.values())
    np.testing.assert_array_equal(rows["mask.composite"], np.arange(n))
    np.testing.assert_array_equal(rows["depth.min"], np.arange(n))
    np.testing.assert_array_equal(rows["flow.first"], np.arange(n))
    np.testing.assert_array_equal(rows["flow.second"], np.arange(1, T))
    batches, windows = -(-n // BATCH), -(-n // (BATCH - 1))
    want = Counter({"mask batches": batches, "depth batches": batches,
                    "padded batch frames": batches * BATCH - n,
                    "flow windows": windows,
                    "padded flow frames": windows * (BATCH - 1) - n})
    assert step.counts == want
    step(frames)  # the counts keep every call's
    assert step.counts == want + want
    line = StageProfiler(enabled=True)
    line.totals["prisma.step"] = 1.0
    assert f"dispatched: depth batches x{2 * batches}" in line.report(
        counts={"dispatched": step.counts})


def test_a_segment_needs_two_frames():
    step = multiband.segment_step(*_fake_steps(), BATCH)
    with pytest.raises(ValueError, match="2 frames or more"):
        step(np.zeros((1, 4, 6, 3), np.uint8))


def test_the_fused_dispatch_skips_a_band_that_is_off():
    mask, _, flow = _fake_steps()
    fused = multiband.FusedDispatch(mask, None, flow, BATCH)
    frames = np.zeros((BATCH, 4, 6, 3), np.uint8)
    mask_out, depth_out, flow_outs = fused.batch(frames, 5)
    assert depth_out is None and flow_outs == [] and len(fused.flow_buf) == 5
    out, pairs = fused.tail()
    assert pairs == 4 and fused.flow_buf == [] and fused.tail() is None
    assert fused.counts == Counter({"mask batches": 1,
                                    "padded batch frames": 3,
                                    "flow windows": 1,
                                    "padded flow frames": 3})


def test_the_mask_step_and_solov2_open_their_spans(small_mask):
    from prisma_tpu_torch.bands import mask_band
    from prisma_tpu_torch.models import solov2
    from prisma_tpu_torch.weights import store
    from prisma_tpu_torch.runtime.config import RuntimeConfig

    cfg = solov2.SOLOv2Config(feat_channels=64, mask_feat_channels=64,
                              mask_out_channels=64)
    model = store.load_solov2(RuntimeConfig(random_weights=True,
                                            device="cpu"), cfg)
    step = mask_band._make_step(model, (48, 64), 0.5, sdf=True)
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3),
                                               dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(frames)
    assert set(out) == {"composite", "green"}
    events = _prisma_events(prof)
    names = [e[0] for e in events]
    assert names.count("prisma.step") == 1
    outer = events[names.index("prisma.step")]
    stages = [e for e in events if e[0] in STAGES]
    assert [e[0] for e in stages] == STAGES
    assert all(_inside(e, outer) for e in stages)
    inner = [e for e in events if e[0].startswith("prisma.model.")]
    assert [e[0] for e in inner] == ["prisma.model.mask_backbone",
                                     "prisma.model.mask_head",
                                     "prisma.model.mask_results"]
    assert all(_inside(e, stages[1]) for e in inner)


def test_the_metric_infer_opens_its_spans():
    from prisma_tpu_torch.models import vit
    from prisma_tpu_torch.models import zoedepth as zoe

    model = zoe.init_params(
        zoe.build(vit.ViTConfig(embed_dim=64, depth=4, num_heads=2), 32,
                  (32, 64, 128, 128)), torch.Generator().manual_seed(0))
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 40, 60, 3), dtype=np.uint8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            depth = zoe.metric_depth_anything_infer(model, frames, (28, 42))
    assert depth.shape == (2, 40, 60)
    names = [e[0] for e in _prisma_events(prof)]
    assert names == ["prisma.model.prepare", "prisma.model.encoder",
                     "prisma.model.head", "prisma.model.bins_head",
                     "prisma.model.resize_back"]
