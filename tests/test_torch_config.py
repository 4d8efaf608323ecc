"""convsep_tpu_torch scaffold: the preset mirror equals the JAX presets
field for field, device resolution never falls back, the package imports
no JAX, and the kernel build is wired to the sources in the checkout."""

import dataclasses
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from convsep_tpu.configs import presets as jax_presets
from convsep_tpu_torch import kernels
from convsep_tpu_torch.configs import presets as torch_presets
from convsep_tpu_torch.configs import preset_from_dict
from convsep_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(jax_presets.PRESETS))
def test_preset_mirror_equals_jax(name):
    want = jax_presets.get_preset(name)
    got = torch_presets.get_preset(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got.model)] == [
        f.name for f in dataclasses.fields(want.model)
    ]
    assert got.transform.bins == want.transform.bins
    for prop in ("conv2_time_eff", "enc_time", "enc_freq", "enc_flat"):
        assert getattr(got.model, prop) == getattr(want.model, prop), prop


def test_preset_names_and_from_dict():
    assert sorted(torch_presets.PRESETS) == sorted(jax_presets.PRESETS)
    jp = jax_presets.get_preset("multires4096")
    assert preset_from_dict(dataclasses.asdict(jp)) == torch_presets.get_preset("multires4096")
    with pytest.raises(ValueError, match="unknown preset"):
        torch_presets.get_preset("nope")


def test_resolve_device_has_no_cpu_fallback():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        assert resolve_device(None).type == "cuda"
    else:
        for dev in ("cuda", None):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(dev)
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_separator_on_missing_gpu_raises():
    from convsep_tpu_torch.separate import Separator

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the error path cannot be reached")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Separator(torch_presets.get_preset("dsd100"), {}, device="cuda")


def test_kernel_sources_match_bindings():
    """Every ctypes signature names an extern "C" launcher in csrc/, with the
    same argument count; the content hash is stable and the build lands in
    the git-ignored build/ tree."""
    text = "".join((kernels.CSRC / s).read_text() for s in kernels.SOURCES)
    for name, argtypes in kernels._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
    assert kernels.source_hash() == kernels.source_hash()
    assert kernels.build_dir().relative_to(REPO).parts[0] == "build"
    kernels.reset_launches()
    assert set(kernels.LAUNCHES.values()) == {0}


def test_package_never_imports_jax():
    """Importing every module and running the slice on CPU leaves jax,
    flax, grain and the JAX package out of sys.modules."""
    script = textwrap.dedent(
        """
        import dataclasses, sys
        import numpy as np, torch
        import convsep_tpu_torch.kernels
        import convsep_tpu_torch.dsp.cuda.ct_istft_kernel
        import convsep_tpu_torch.dsp.cuda.istft_kernel
        import convsep_tpu_torch.dsp.cuda.wiener_kernel
        import convsep_tpu_torch.models.decoder_fused_cuda
        import convsep_tpu_torch.utils.transfer
        import convsep_tpu_torch.benchmark, convsep_tpu_torch.cli, convsep_tpu_torch.eval
        import convsep_tpu_torch.utils.flops, convsep_tpu_torch.utils.profiling
        import convsep_tpu_torch.data.grain_pipeline, convsep_tpu_torch.distributed
        import convsep_tpu_torch.separate.sharded
        from convsep_tpu_torch.ckpt import init_params, to_jax_params
        from convsep_tpu_torch.configs import TransformConfig, get_preset
        from convsep_tpu_torch.separate import Separator, StereoSeparator

        p = get_preset("highres4096")
        t = TransformConfig(fs=8000, frame_size=256, hop_size=64)
        m = dataclasses.replace(p.model, feat_size=t.bins, conv1_freq=9,
                                conv1_filters=6, conv2_filters=5, bottleneck=16)
        p = dataclasses.replace(p, transform=t, model=m,
                                sep=dataclasses.replace(p.sep, segment_bucket=2))
        state = init_params(p.model, torch.Generator().manual_seed(0))
        to_jax_params(state)
        x = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
        y = Separator(p, state, device="cpu", output_dtype="int16")(0.1 * x)
        assert y.shape == (4, 5000) and y.dtype == np.int16
        pl = dataclasses.replace(p, transform=dataclasses.replace(t, fft_impl="pallas"))
        assert Separator(pl, state, device="cpu")(0.1 * x).shape == (4, 5000)
        st = dataclasses.replace(p, model=dataclasses.replace(m, channels_in=2,
                                                              decoder_reduce="all"))
        st_state = init_params(st.model, torch.Generator().manual_seed(0))
        y2 = StereoSeparator(st, st_state, device="cpu", complement_last=True)(
            0.1 * np.stack([x, x[::-1]], axis=1))
        assert y2.shape == (4, 5000, 2) and y2.dtype == np.float32
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "grain",
                                      "convsep_tpu")]
        assert not bad, bad
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
