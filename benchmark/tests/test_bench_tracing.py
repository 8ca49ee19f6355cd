"""The traced run's reduction of the profiler's events: device work by the
kind of activity, never the host's annotation ranges that the profiler also
puts on the device's timeline."""
import types

import pytest
import torch

import tracing

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _event(name, kind, device=CUDA, annotation=False):
    return types.SimpleNamespace(name=name, activity_type=kind, device_type=device,
                                 is_user_annotation=annotation)


@pytest.mark.parametrize("name, kind, device, work", [
    ("ampere_sgemm_128x64_nn", "kernel", CUDA, True),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "kernel", CUDA, True),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", CUDA, True),
    ("Memset (Device)", "gpu_memset", CUDA, True),
    ("nccl:all_reduce", "gpu_user_annotation", CUDA, False),
    ("bench.rollout", "gpu_user_annotation", CUDA, False),
    ("aten::mm", "cpu_op", CPU, False),
])
def test_device_work_is_told_by_its_kind(name, kind, device, work):
    assert tracing._is_device(_event(name, kind, device)) is work


def test_without_a_kind_the_annotation_flag_decides():
    assert tracing._is_device(_event("nccl:all_reduce", None, annotation=True)) is False
    assert tracing._is_device(_event("sm90_xmma_fprop", None)) is True


def test_a_profiled_update_on_the_host_reads_no_device_work():
    prof = tracing.profiled_update(lambda: torch.ones(64, 64) @ torch.ones(64, 64),
                                   torch.device("cpu"))
    assert prof["busy_s"] == 0.0 and prof["window_s"] > 0
    assert prof["kernels"] == {} and prof["streams"] == {}
