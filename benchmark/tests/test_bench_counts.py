"""The frozen yardstick: the roofline counts reproduce the kernel bounds in
PERF.md, the cells' attention calls and FLOPs follow their shapes, and the
frozen kernel families agree with the program's own."""

from __future__ import annotations

import pytest

from benchmark import families
from benchmark.roofline import attention, instance_norm
from benchmark.run import load_json
from benchmark.tests.tiny import bench_path, manifest

PEAK = load_json(bench_path("peaks.json"))["NVIDIA H100 80GB HBM3"]


def _cell(name):
    from benchmark.run import Cell
    return Cell(manifest(), name)


@pytest.mark.parametrize("shape,ms", [((128, 2443, 64), 0.198),
                                      ((56, 4590, 128), 0.611)])
def test_attention_bound_reproduces_perf_md(shape, ms):
    B, N, d = shape
    assert round(attention.bound_s(attention.call(B, N, N, d, d), PEAK) * 1e3,
                 3) == ms


def test_streamed_and_instance_norm_bounds():
    k3 = attention.call(7, 18360, 18360, 128, 2, v_bytes=4, out_bytes=4)
    assert round(attention.bound_s(k3, PEAK) * 1e3, 3) == 0.620
    assert round(instance_norm.bound_s(14, 64, 408, 720, PEAK) * 1e3, 3) \
        == 0.314


def test_depth_attention_calls():
    cell = _cell("depth_anything_vitl.1080p")
    calls = cell.builder.attention_calls(cell.cfg, cell.traffic)
    assert len(calls) == 24
    assert {(c["B"], c["N"], c["d"]) for c in calls} == {(128, 2443, 64)}


def test_gmflow_attention_calls():
    cell = _cell("gmflow_sintel.1080p")
    calls = cell.builder.attention_calls(cell.cfg, cell.traffic)
    shapes = [(c["B"], c["N"], c["d"], c["dv"]) for c in calls]
    assert shapes.count((56, 4590, 128, 128)) == 12
    assert shapes.count((7, 18360, 128, 2)) == 2
    assert shapes.count((14, 18360, 128, 2)) == 1


def test_depth_flops_match_the_vit_by_hand():
    """The counter on the reference's graph gives, for ViT-L, the products
    counted by hand: the patch embedding and 24 blocks of qkv, proj, the
    MLP and the two attention products."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import depth_anything as ref

    cell = _cell("depth_anything_vitl.1080p")
    cfg = cell.cfg
    sd = {n: torch.empty(s, device="meta")
          for n, s, _ in ref.param_specs(cfg)}
    x = torch.empty(1, 3, 518, 924, device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.vit_features(sd, x, cfg, ref.Ops())
    D, N, P = 1024, 37 * 66 + 1, 37 * 66
    by_hand = 2 * P * 3 * 14 * 14 * D + 24 * (2 * N * 12 * D * D
                                              + 4 * N * N * D)
    assert fc.get_total_flops() == by_hand
    assert cell.builder.step_flops(cfg, cell.traffic) > 8 * by_hand


@pytest.mark.parametrize("name", [
    "void flash_fwd_bf16<64, 3>(...)", "flash_region_bf16", "flash_streamed",
    "instance_norm_relu_kernel", "raft_window_lookup_kernel",
    "lane_gather_kernel", "minor_transpose_kernel",
    "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pageable)",
    "Memset (Device)", "sm90_xmma_fprop_implicit_gemm", "cudnn::nchwToNhwc",
    "nvjet_tst_128x256", "ampere_bf16_s16816gemm", "cutlass_80_wmma",
    "void at::native::vectorized_elementwise_kernel<4>(...)",
    "void at::native::reduce_kernel<512, 1>(...)"])
def test_frozen_families_agree_with_the_program(name):
    from prisma_tpu_torch.runtime.profile_step import kernel_family
    assert families.kernel_family(name) == kernel_family(name)


def test_attention_kernels_named():
    assert attention.is_attention("void flash_fwd_bf16<64, 3>(...)")
    assert attention.is_attention("flash_region_bf16")
    assert attention.is_attention("flash_streamed_bf16<128, 2>")
    assert attention.is_attention("fmha_cutlassF_bf16_aligned_64x64")
    assert not attention.is_attention("sm90_xmma_gemm_bf16bf16")
