"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card. Every test here is marked ``cuda`` and skips without a GPU. The file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 outputs 1e-5 absolute on stems in [-1, 1] (Wiener) and
1e-4 absolute on O(1) decode sums (as the JAX kernel tests); int16 within
±1 LSB; bf16 decode output within one bf16 ulp."""

import dataclasses

import numpy as np
import pytest
import torch

from convsep_tpu_torch import kernels
from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft, wiener_istft_plain
from convsep_tpu_torch.dsp.dft import stft_matmul
from convsep_tpu_torch.dsp.windows import sinebell
from convsep_tpu_torch.models.config import ConvSepConfig
from convsep_tpu_torch.models.convsep import band_freq_conv_kernel
from convsep_tpu_torch.models.decoder_fused_cuda import (
    band_freq_decode,
    band_freq_decode_plain,
    prepare_operands,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wiener_inputs(rng, S, length, nfft, hop, device, lead=(2,)):
    w = sinebell(nfft)
    x = torch.from_numpy((0.3 * rng.standard_normal((*lead, length))).astype(np.float32))
    re, im = stft_matmul(x.to(device), w, hop)
    nf = re.shape[-2]
    y = np.abs(rng.standard_normal((*lead, S, nf, nfft // 2 + 1))).astype(np.float32)
    y[..., : nf // 3, :8] = 0.0
    return w, torch.from_numpy(y).to(device), re, im


@pytest.mark.parametrize(
    "nfft,hop,length,S,kw",
    [
        (256, 64, 6000, 4, {}),
        (256, 128, 7000, 2, {"p": 2.0}),
        (512, 128, 9000, 3, {"conserve_last": True}),
        (256, 64, 4500, 4, {"eps": 1e-4}),
        (1024, 512, 30000, 4, {}),
        (4096, 1024, 60000, 4, {"p": 2.0, "conserve_last": True}),
        (4096, 1024, 60000, 5, {}),
        (384, 96, 6000, 3, {}),                    # even, not a power of two
        (1000, 250, 9000, 2, {"p": 2.0, "conserve_last": True}),
    ],
)
@pytest.mark.parametrize("ydt", [torch.float32, torch.bfloat16])
def test_wiener_istft_kernel_matches_plain(rng, cuda, nfft, hop, length, S, kw, ydt):
    w, y, re, im = _wiener_inputs(rng, S, length, nfft, hop, cuda)
    y = y.to(ydt)
    for out in ("float32", "int16"):
        before = kernels.LAUNCHES["wiener_istft"]
        got = wiener_istft(y, re, im, w, hop, length, output_dtype=out, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["wiener_istft"] == before + 1
        want = wiener_istft_plain(y, re, im, w, hop, length, output_dtype=out, **kw)
        assert got.shape == want.shape == (2, S, length) and got.dtype == want.dtype
        if out == "int16":
            assert (got.int() - want.int()).abs().max().item() <= 1
        else:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_wiener_istft_kernel_refuses(rng, cuda):
    w, y, re, im = _wiener_inputs(rng, 2, 6000, 256, 64, cuda)
    with pytest.raises(ValueError, match="p in"):
        wiener_istft(y, re, im, w, 64, 6000, p=1.5)
    with pytest.raises(ValueError, match="mixed devices"):
        wiener_istft(y.cpu(), re, im, w, 64, 6000)


CFG = ConvSepConfig(
    time_context=30, feat_size=129, channels_in=1, num_sources=3,
    conv1_filters=6, conv1_freq=9, conv1_freq_stride=4,
    conv2_filters=5, conv2_time=15, bottleneck=16,
)


@pytest.mark.parametrize("conv1_freq", [9, 37, 65])
@pytest.mark.parametrize("B", [1, 7, 16])
def test_fused_decode_kernel_matches_plain(rng, cuda, B, conv1_freq):
    cfg = dataclasses.replace(CFG, conv1_freq=conv1_freq)
    S, J, W = cfg.num_sources, cfg.bottleneck, cfg.enc_freq
    TpC = cfg.enc_time * cfg.conv2_filters

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(cuda)

    KC, _, _, _ = band_freq_conv_kernel(
        t(cfg.conv2_time_eff, 1, cfg.conv1_filters, cfg.conv2_filters, scale=0.3),
        t(1, cfg.conv1_freq, 1, cfg.conv1_filters, scale=0.3),
        cfg.enc_time, cfg.conv1_freq_stride,
    )
    ops = prepare_operands(t(J, S * W * TpC, scale=0.2), t(S * W * TpC, scale=0.1), KC, S, W, TpC)
    fc = torch.relu(t(B, J))
    for dt in (torch.float32, torch.bfloat16):
        before = kernels.LAUNCHES["fused_decode"]
        got = band_freq_decode(fc, *ops, out_dtype=dt)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fused_decode"] == before + 1
        want = band_freq_decode_plain(fc, *ops, out_dtype=dt)
        assert got.dtype == want.dtype == dt and got.shape == want.shape
        if dt == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        else:
            torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=2 ** -7)
    with pytest.raises(ValueError, match="float32 operands"):
        band_freq_decode(fc.double(), *ops)


def test_tiny_highres_slice_kernel_route_matches_plain(cuda):
    """The slice on the card: "auto" routing takes both kernels for the
    highres-shaped model and agrees with the all-plain route (f32 tail)."""
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.configs import TransformConfig, get_preset
    from convsep_tpu_torch.separate import Separator

    p = get_preset("highres4096")
    tr = TransformConfig(fs=8000, frame_size=256, hop_size=64)
    p = dataclasses.replace(
        p, transform=tr, sep=dataclasses.replace(p.sep, segment_bucket=2),
        model=dataclasses.replace(p.model, feat_size=tr.bins, conv1_freq=9, conv1_filters=6,
                                  conv2_filters=5, bottleneck=16, mask_dtype="float32"),
    )
    state = init_params(p.model, torch.Generator(device=cuda).manual_seed(0), cuda)
    mix = (0.2 * np.random.default_rng(1).standard_normal(9000)).astype(np.float32)
    kernels.reset_launches()
    got = Separator(p, state, device=cuda)(mix)
    assert kernels.LAUNCHES == {"wiener_istft": 1, "fused_decode": 1}
    plain = dataclasses.replace(
        p, model=dataclasses.replace(p.model, decoder_impl="bandconv"),
        transform=dataclasses.replace(p.transform, masked_synthesis="direct"),
    )
    want = Separator(plain, state, device=cuda)(mix)
    assert kernels.LAUNCHES == {"wiener_istft": 1, "fused_decode": 1}
    np.testing.assert_allclose(got, want, atol=1e-5)
