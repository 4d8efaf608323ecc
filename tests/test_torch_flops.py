"""FLOP accounting, port against reference: ``convsep_tpu_torch.utils.flops``
against ``convsep_tpu.utils.flops`` for every preset in ``PRESETS`` (the
same integers), and the H100's peaks."""

import pytest

from convsep_tpu.configs import get_preset as jax_get_preset
from convsep_tpu.utils import flops as jax_flops
from convsep_tpu_torch.configs import PRESETS, get_preset
from convsep_tpu_torch.utils import flops


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_counts_match_jax(name):
    p, jp = get_preset(name), jax_get_preset(name)
    assert flops.model_param_count(p.model) == jax_flops.model_param_count(jp.model)
    assert flops.model_flops_per_segment(p.model) == jax_flops.model_flops_per_segment(jp.model)
    L = 30 * p.transform.fs
    assert flops.pipeline_flops_per_track(p, L) == jax_flops.pipeline_flops_per_track(jp, L)
    m = flops.mfu(p, L, 0.01, "NVIDIA H100 80GB HBM3")
    assert m["flops_per_track"] == jax_flops.pipeline_flops_per_track(jp, L)["total"]
    assert m["peak_bf16_tflops"] == 989.4
    assert m["mfu_bf16"] == round(m["flops_per_track"] / 0.01 / 1e12 / 989.4, 4)


def test_device_peaks():
    assert flops.device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert flops.device_peak_tflops("NVIDIA H100 80GB HBM3", "tf32") == 494.7
    assert flops.device_peak_tflops("NVIDIA H100 80GB HBM3", "fp32") == 66.9
    assert flops.device_peak_tflops("NVIDIA H100 PCIe") is None
    assert flops.device_peak_tflops("cpu") == 0.1
    assert flops.device_peak_tflops("TPU v5 lite") is None
    assert flops.mfu(get_preset("dsd100"), 44100, 0.01, "unknown card")["mfu_bf16"] is None
