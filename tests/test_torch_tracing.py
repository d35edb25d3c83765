"""The port's spans (runtime/profiling.py) on the CPU: the depth and flow
band steps of tests/test_torch_mesh.py open `prisma.step` once a call, its
four stages once each, in order and inside it, and the model's ranges
inside `prisma.step.model`; with no profiler `span` never opens a
`record_function`, and a profiler leaves the outputs bitwise as they were;
the loaders add to `setup_seconds()`; a StageProfiler keeps its host totals;
a video band's run loop puts its waits, steps and sinks on the trace that
PRISMA_TPU_TRACE writes and in the report of PRISMA_TPU_PROFILE=1."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from prisma_tpu_torch.runtime import profiling
from tests.test_torch_mesh import CPUS, DEPTH_FRAMES, RANDOM, _depth_steps

STAGES = ["prisma.step.inputs", "prisma.step.model", "prisma.step.epilogue",
          "prisma.step.outputs"]
DEPTH_MODEL = ["prisma.model.prepare", "prisma.model.encoder",
               "prisma.model.head", "prisma.model.resize_back"]
FLOW_MODEL = ["prisma.model.backbone", "prisma.model.transformer",
              "prisma.model.matching", "prisma.model.propagation",
              "prisma.model.upsample"]
FLOW_WINDOW = np.random.default_rng(3).integers(0, 256, (8, 32, 48, 3),
                                                dtype=np.uint8)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def steps():
    """{band: (step, its input, the model's spans)}: a tiny ViT (the widths
    of tests/test_torch_mesh.py's, random) and the random GMFlow."""
    from prisma_tpu_torch.bands.flow_base import make_flow_step
    from prisma_tpu_torch.models import depth_anything as da
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.models import vit
    from prisma_tpu_torch.weights import store

    depth = da.init_params(
        da.build(vit.ViTConfig(embed_dim=64, depth=4, num_heads=2), 32,
                 (32, 64, 128, 128)), torch.Generator().manual_seed(0))
    flow = make_flow_step(store.load_gmflow(RANDOM), gm.infer_pairs, (24, 36),
                          need_masks=True, need_flow=True, need_enc=True)
    return {"depth": (_depth_steps(depth, None)[1], DEPTH_FRAMES,
                      DEPTH_MODEL),
            "flow": (flow, FLOW_WINDOW, FLOW_MODEL)}


def _prisma_events(prof) -> list:
    """(name, start us, end us) of the trace's prisma.* ranges, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("prisma.")),
                  key=lambda e: (e[1], -e[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("band", ["depth", "flow"])
def test_a_step_opens_its_spans_in_order(steps, band):
    step, x, model_spans = steps[band]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(x)
    events = _prisma_events(prof)
    names = [e[0] for e in events]
    assert names.count("prisma.step") == 1
    outer = events[names.index("prisma.step")]
    stages = [e for e in events if e[0] in STAGES]
    assert [e[0] for e in stages] == STAGES  # once each, in order
    assert all(_inside(e, outer) for e in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    model = stages[1]
    inner = [e for e in events if e[0].startswith("prisma.model.")]
    assert [e[0] for e in inner] == model_spans
    assert all(_inside(e, model) for e in inner)


def test_the_split_path_keeps_the_outer_spans():
    """Over replicas the step opens prisma.step once, the stages of each
    replica in turn inside it, and the outputs once."""
    from prisma_tpu_torch.models import depth_anything as da
    from prisma_tpu_torch.models import vit

    model = da.init_params(
        da.build(vit.ViTConfig(embed_dim=64, depth=4, num_heads=2), 32,
                 (32, 64, 128, 128)), torch.Generator().manual_seed(0))
    split = _depth_steps(model, CPUS[:2])[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        split(DEPTH_FRAMES)
    names = [e[0] for e in _prisma_events(prof)
             if e[0].startswith("prisma.step")]
    assert names[0] == "prisma.step" and names.count("prisma.step") == 1
    assert names.count("prisma.step.model") == 2
    assert names.count("prisma.step.outputs") == 1
    assert names[-1] == "prisma.step.outputs"


@pytest.mark.parametrize("band", ["depth", "flow"])
def test_no_profiler_no_record_function_and_the_same_outputs(steps, band,
                                                            monkeypatch):
    step, x, _ = steps[band]
    opened = []
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    plain = step(x)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        traced = step(x)
    assert "prisma.step" in opened
    assert set(plain) == set(traced)
    for k in plain:
        assert plain[k].dtype == traced[k].dtype
        np.testing.assert_array_equal(plain[k], traced[k], err_msg=k)


def test_a_loaded_model_adds_to_the_weights_seconds():
    from prisma_tpu_torch.bands import flow_base
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.weights import store

    before = profiling.setup_seconds().get(profiling.SETUP_WEIGHTS, 0.0)
    model = store.load_gmflow(RANDOM, gm.GMFlowConfig(
        feature_channels=32, num_transformer_layers=1))
    loaded = profiling.setup_seconds()[profiling.SETUP_WEIGHTS]
    assert loaded > before
    flow_base.build_flow_step(model, gm.infer_pairs, 0.75, 48, 32, RANDOM,
                              backwards=False, mask=False)
    assert profiling.setup_seconds()[profiling.SETUP_WEIGHTS] > loaded


def test_timed_counts_a_nested_span_of_its_name_once(monkeypatch):
    clock = iter([0.0, 1.0, 10.0])  # outer start, inner start, outer end
    monkeypatch.setattr(profiling, "time",
                        SimpleNamespace(perf_counter=lambda: next(clock)))
    before = profiling.setup_seconds().get("test.setup", 0.0)
    with profiling.timed("test.setup"):
        with profiling.timed("test.setup"):
            pass
    assert profiling.setup_seconds()["test.setup"] - before == 10.0


def test_stage_profiler_keeps_its_host_totals(capsys):
    prof = profiling.StageProfiler(enabled=True)
    for _ in prof.iterate([1, 2, 3], "prisma.decode_wait"):
        with prof.host("prisma.step"):
            pass
        with prof.stage("prisma.sink"):
            pass
    assert prof.counts == {"prisma.decode_wait": 4, "prisma.step": 3,
                           "prisma.sink": 3}
    assert all(t >= 0.0 for t in prof.totals.values())
    out = prof.report(items=3)
    assert out == capsys.readouterr().out.strip()
    for name in ("prisma.decode_wait", "prisma.step", "prisma.sink",
                 "throughput"):
        assert name in out
    off = profiling.StageProfiler(enabled=False)
    with off.stage("prisma.sink"):
        pass
    assert not off.totals and off.report() == ""


def _make_folder(path, frames=4, w=64, h=48):
    from prisma_tpu_torch.io.video import VideoWriter
    from prisma_tpu_torch.utils import meta

    os.makedirs(path)
    m = meta.create_metadata(path)
    wr = VideoWriter(w, h, 24.0, filename=os.path.join(path, "rgba.mp4"))
    for i in range(frames):
        yy, xx = np.mgrid[0:h, 0:w]
        wr.write(np.stack([(xx + i * 3) % 256, (yy * 2) % 256,
                           (xx * 2 + yy) % 256], -1).astype(np.uint8))
    wr.close()
    meta.add_band(m, "rgba", url="rgba.mp4")
    meta.write_metadata(path, m)
    return path


def test_a_run_loop_traces_and_reports_its_stages(tmp_path, monkeypatch,
                                                 capsys):
    from prisma_tpu_torch.bands import flow_gmflow_band
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.runtime.config import RuntimeConfig

    traces = tmp_path / "traces"
    monkeypatch.setenv("PRISMA_TPU_PROFILE", "1")
    monkeypatch.setenv("PRISMA_TPU_TRACE", str(traces))
    folder = _make_folder(str(tmp_path / "seq"))
    flow_gmflow_band.run(folder, cfg=gm.GMFlowConfig(
        feature_channels=32, num_transformer_layers=1),
        runtime=RuntimeConfig(batch_size=3, compute_dtype="float32",
                              random_weights=True, device="cpu"))
    out = capsys.readouterr().out
    for name in ("prisma.decode_wait", "prisma.step", "prisma.sink",
                 profiling.SETUP_WEIGHTS):
        assert name in out
    (path,) = traces.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"prisma.decode_wait", "prisma.step", "prisma.sink",
            *STAGES, *FLOW_MODEL} <= names


class _Event:
    def __init__(self, name, start, end, device, corr=0, thread=1,
                 annotation=False):
        self._v = (name, start, end, device, corr, thread, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_profile_step_puts_device_time_under_the_launching_span():
    """profile_step's stage table: each device event goes to the spans open
    on its launching thread at the runtime or driver call of its
    correlation id (the port's kernels launch through ctypes, outside any
    torch operator); the spans' annotations on the device count nothing."""
    from prisma_tpu_torch.runtime import profile_step

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Event("prisma.step", 0, 100, cpu),
              _Event("prisma.step.model", 10, 60, cpu),
              _Event("prisma.step.outputs", 60, 100, cpu),
              _Event("aten::mm", 20, 30, cpu, corr=7),
              _Event("cudaLaunchKernel", 21, 22, cpu, corr=1),
              _Event("cuLaunchKernel", 40, 41, cpu, corr=2),
              _Event("cuLaunchKernel", 45, 46, cpu, corr=3, thread=2),
              _Event("cudaMemcpyAsync", 70, 90, cpu, corr=4),
              _Event("gemm", 1000, 3000, cuda, corr=1),
              _Event("flash_fwd", 3000, 7000, cuda, corr=2),
              _Event("other_thread", 7000, 8000, cuda, corr=3),
              _Event("Memcpy DtoH", 8000, 12000, cuda, corr=4),
              _Event("prisma.step.model", 1000, 7000, cuda, annotation=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    ms, device = profile_step.span_stages(prof, 2)
    assert device == pytest.approx(0.0055)
    assert ms == pytest.approx({"prisma.step": 0.005,
                                "prisma.step.model": 0.003,
                                "prisma.step.outputs": 0.002})
