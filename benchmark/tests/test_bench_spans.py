"""The readers of the program's spans on a synthetic trace: each idle gap
goes to the `prisma.step.*` stage whose range covers its middle, the gaps
under no stage are counted, the stages sum to the window less the busy
time, the device's annotation of a span is no device work, and the three
readers give None for a program without spans (the trace holds no
`prisma.` range; its profiling module keeps no `setup_seconds`)."""

from __future__ import annotations

import sys
import types

import pytest
import torch

from benchmark import spans
from benchmark.families import ELEMENTWISE
from benchmark.trace import Trace
from benchmark.tests.tiny import bench_path
from benchmark.run import load_module

MAIN, OTHER = 1, 2
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start, end, device=CPU, activity="",
                 thread=MAIN, annotation=False, corr=0):
        self._v = (name, start, end, device, activity, thread, annotation,
                   corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def activity_type(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def correlation_id(self):
        return self._v[7]


class Results:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def kernel(start, end, name="elementwise_kernel", corr=0):
    return Event(name, start, end, CUDA, "kernel", corr=corr)


def one_step_trace(with_spans=True) -> Trace:
    """One step over [0, 1000] ns: the benchmark's call [100, 900], the
    program's step [110, 890] with its stages inputs [120, 300], model
    [300, 600] (the encoder [310, 590] in it), epilogue [600, 700], outputs
    [700, 880]; kernels at [150, 250], [320, 400], [420, 580], [640, 690],
    [715, 720]. Idle gaps, by their middles: [0, 150] outside the step,
    [250, 320] inputs, [400, 420] model, [580, 640] epilogue, [690, 715]
    and [720, 1000] outputs. The step of another thread and the device's
    annotation of the model's range count for nothing."""
    events = [Event("bench.next_input", 0, 90),
              Event("bench.step_call", 100, 900),
              Event("bench.outputs", 900, 1000),
              kernel(150, 250), kernel(320, 400), kernel(420, 580),
              kernel(640, 690), kernel(715, 720),
              Event("aten::copy_", 720, 870),
              Event("prisma.step.model", 320, 580, CUDA,
                    "gpu_user_annotation", annotation=True),
              Event("prisma.step", 0, 1000, thread=OTHER)]
    if with_spans:
        events += [Event("prisma.step", 110, 890),
                   Event("prisma.step.inputs", 120, 300),
                   Event("prisma.step.model", 300, 600),
                   Event("prisma.model.encoder", 310, 590),
                   Event("prisma.step.epilogue", 600, 700),
                   Event("prisma.step.outputs", 700, 880)]
    return Trace(Results(events), 1)


def test_each_gap_goes_to_the_stage_over_its_middle():
    trace = one_step_trace()
    assert not [d for d in trace.device if d[0].startswith("prisma.")]
    got = spans.idle_by_stage(trace)
    assert got == pytest.approx({
        spans.OUTSIDE: 150e-9, "prisma.step.inputs": 70e-9,
        "prisma.step.model": 20e-9, "prisma.step.epilogue": 60e-9,
        "prisma.step.outputs": 305e-9}, abs=1e-15)


def test_the_stages_sum_to_the_idle_time():
    trace = one_step_trace()
    got = spans.idle_by_stage(trace)
    assert sum(got.values()) == pytest.approx(trace.window_s - trace.busy_s,
                                              abs=1e-15)


def test_a_gap_in_the_step_under_no_stage_is_counted():
    events = [Event("bench.step_call", 0, 1000), kernel(100, 900),
              Event("prisma.step", 0, 1000),
              Event("prisma.step.model", 100, 900)]
    got = spans.idle_by_stage(Trace(Results(events), 2))
    assert got == pytest.approx({spans.IN_STEP: 200e-9}, abs=1e-15)


def launched_trace(with_spans=True) -> Trace:
    """One step over [0, 2000] ns with the stages of one_step_trace's step
    (inputs [120, 300], model [300, 600] with the encoder [310, 590] in it,
    epilogue [600, 700], outputs [700, 880]) and a launch call for each
    device event: the H2D launched at 130 in the inputs; a kernel at 302 in
    the model and one at 400 in the encoder; two kernels launched at 640 and
    660 in the epilogue, the second through the driver API, both running
    after the span closed, at [720, 800] and [800, 900]; the D2H
    at 710 in the outputs; a kernel launched by another thread at 650; one
    launched at 950, after the step; one whose launch the trace lost."""
    events = [Event("bench.step_call", 100, 1000),
              Event("cudaMemcpyAsync", 130, 140, corr=11),
              kernel(150, 250, "Memcpy HtoD (Pinned -> Device)", corr=11),
              Event("cudaLaunchKernel", 302, 305, corr=12),
              kernel(330, 400, corr=12),
              Event("cudaLaunchKernel", 400, 405, corr=13),
              kernel(410, 580, "flash_fwd_bf16", corr=13),
              Event("cudaLaunchKernel", 640, 645, corr=14),
              kernel(720, 800, corr=14),
              Event("cuLaunchKernel", 660, 665, corr=15),
              kernel(800, 900, "instance_norm_relu_kernel", corr=15),
              Event("cudaMemcpyAsync", 710, 715, corr=16),
              kernel(900, 930, "Memcpy DtoH (Device -> Pinned)", corr=16),
              Event("cudaLaunchKernel", 650, 655, thread=OTHER, corr=17),
              kernel(940, 960, corr=17),
              Event("cudaLaunchKernel", 950, 955, corr=18),
              kernel(960, 990, corr=18),
              kernel(990, 1000, corr=19),
              Event("prisma.step.model", 330, 580, CUDA,
                    "gpu_user_annotation", annotation=True, corr=12)]
    if with_spans:
        events += [Event("prisma.step", 110, 890),
                   Event("prisma.step.inputs", 120, 300),
                   Event("prisma.step.model", 300, 600),
                   Event("prisma.model.encoder", 310, 590),
                   Event("prisma.step.epilogue", 600, 700),
                   Event("prisma.step.outputs", 700, 880)]
    return Trace(Results(events), 2)


def test_device_time_goes_to_the_span_of_its_launch():
    """Each device event goes to the innermost span open at its launch,
    where it ran after the span closed too; a launch under no torch
    operator (K1's, made from ctypes) and the driver's count like any
    other; the spans sum to all the trace's device time."""
    trace = launched_trace()
    got = spans.device_by_span(trace)
    assert got == pytest.approx({
        "prisma.step.inputs": 100e-9, "prisma.step.model": 70e-9,
        "prisma.model.encoder": 170e-9, "prisma.step.epilogue": 180e-9,
        "prisma.step.outputs": 30e-9, spans.OUTSIDE_SPANS: 50e-9,
        spans.NO_LAUNCH: 10e-9}, abs=1e-15)
    assert sum(got.values()) == pytest.approx(
        trace.device_s(lambda n: True), abs=1e-15)


def test_the_launches_change_nothing_the_trace_reported():
    trace = launched_trace()
    assert trace.busy_s == pytest.approx(610e-9, abs=1e-15)
    assert trace.window_s == pytest.approx(900e-9, abs=1e-15)
    assert trace.families() == pytest.approx({
        "host copies (HtoD)": 100e-9, "host copies (DtoH)": 30e-9,
        "K1 flash attention": 170e-9, "K4 instance norm": 100e-9,
        ELEMENTWISE: 210e-9}, abs=1e-15)
    assert sum(trace.idle_gaps().values()) == pytest.approx(290e-9, abs=1e-15)


def test_the_epilogue_reader():
    reader = _reader("epilogue_ms")
    assert reader.read(_ctx(launched_trace())) == pytest.approx(90e-6)
    assert reader.read(_ctx(one_step_trace())) == 0.0
    assert reader.read(_ctx(launched_trace(with_spans=False))) is None
    assert reader.read(_ctx(None)) is None


def _ctx(trace):
    return types.SimpleNamespace(trace=trace)


def _reader(name):
    return load_module(bench_path("metrics", name + ".py"),
                       "test_benchmark_metric_" + name)


def test_the_idle_readers():
    ctx = _ctx(one_step_trace())
    assert _reader("copy_idle_ms").read(ctx) == pytest.approx(375e-6)
    assert _reader("model_idle_ms").read(ctx) == pytest.approx(20e-6)


@pytest.mark.parametrize("ctx", [_ctx(one_step_trace(with_spans=False)),
                                 _ctx(None)])
def test_the_idle_readers_give_none_without_spans(ctx):
    assert _reader("copy_idle_ms").read(ctx) is None
    assert _reader("model_idle_ms").read(ctx) is None


def test_the_weights_reader(monkeypatch):
    name = "prisma_tpu_torch.runtime.profiling"
    reader = _reader("weights_load_s")
    older = types.ModuleType(name)  # a program with no set-up table
    monkeypatch.setitem(sys.modules, name, older)
    assert reader.read(_ctx(None)) is None
    older.setup_seconds = lambda: {"prisma.setup.build_kernels": 2.0}
    assert reader.read(_ctx(None)) is None
    older.setup_seconds = lambda: {"prisma.setup.weights": 3.5}
    assert reader.read(_ctx(None)) == 3.5
