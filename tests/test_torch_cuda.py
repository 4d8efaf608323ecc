"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card. Every test here is marked ``cuda`` and skips without a GPU. The file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 outputs 1e-5 absolute on stems in [-1, 1] (Wiener) and
1e-4 absolute on O(1) decode sums (as the JAX kernel tests); int16 within
±1 LSB; bf16 decode output within one bf16 ulp; spectra within 1e-5 ×
max|X| (the STFT kernel's f32 sums run in another order than cuBLAS's);
adadelta bit for bit (both round every operation on its own), its
gradient square-sum within 1e-6 relative (the kernel sums in double)."""

import dataclasses

import numpy as np
import pytest
import torch

from convsep_tpu_torch import kernels
from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft, wiener_istft_plain
from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas, stft_pallas_plain
from convsep_tpu_torch.dsp.dft import stft_matmul
from convsep_tpu_torch.dsp.windows import sinebell
from convsep_tpu_torch.models.config import ConvSepConfig
from convsep_tpu_torch.models.convsep import band_freq_conv_kernel
from convsep_tpu_torch.models.decoder_fused_cuda import (
    band_freq_decode,
    band_freq_decode_plain,
    prepare_operands,
)
from convsep_tpu_torch.train.fused_optim import (
    fused_adadelta_apply,
    fused_adadelta_leaf,
    fused_adadelta_plain,
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
    launched = {"wiener_istft": 1, "fused_decode": 1, "stft": 0, "fused_adadelta": 0}
    assert kernels.LAUNCHES == launched
    plain = dataclasses.replace(
        p, model=dataclasses.replace(p.model, decoder_impl="bandconv"),
        transform=dataclasses.replace(p.transform, masked_synthesis="direct"),
    )
    want = Separator(plain, state, device=cuda)(mix)
    assert kernels.LAUNCHES == launched
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize(
    "nfft,hop,B,length",
    [
        (256, 128, 1, 3000),      # nf 26
        (256, 64, 7, 3001),       # nf 49, hop = W/4
        (512, 256, 160, 14336),   # nf 59
        (1024, 512, 32, 14336),   # the dsd100 training shape, nf 30
        (1024, 256, 3, 20000),    # nf 81, hop = W/4
        (2048, 1024, 5, 33333),   # nf 35
        (4096, 2048, 2, 60000),   # nf 32
        (4096, 1024, 4, 60001),   # nf 61, hop = W/4
        (1024, 512, 1, 1),        # one sample: 3 frames
    ],
)
def test_stft_kernel_matches_plain(rng, cuda, nfft, hop, B, length):
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32)).to(cuda)
    w = sinebell(nfft)
    before = kernels.LAUNCHES["stft"]
    re, im = stft_pallas(x, w, hop)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stft"] == before + 1
    re_p, im_p = stft_pallas_plain(x, w, hop)
    assert re.shape == re_p.shape == (B, -(-length // hop) + 2, nfft // 2 + 1)
    peak = max(re_p.abs().max().item(), im_p.abs().max().item())
    torch.testing.assert_close(re, re_p, atol=1e-5 * peak, rtol=0)
    torch.testing.assert_close(im, im_p, atol=1e-5 * peak, rtol=0)
    r1, i1 = stft_pallas(x[0], w, hop)  # unbatched
    torch.testing.assert_close(r1, re[0], atol=0, rtol=0)
    torch.testing.assert_close(i1, im[0], atol=0, rtol=0)


def test_stft_kernel_nfft_past_window(rng, cuda):
    x = torch.from_numpy(rng.standard_normal((3, 5000)).astype(np.float32)).to(cuda)
    w = sinebell(512)
    re, im = stft_pallas(x, w, 128, nfft=1024)
    re_p, im_p = stft_pallas_plain(x, w, 128, nfft=1024)
    peak = re_p.abs().max().item()
    torch.testing.assert_close(re, re_p, atol=1e-5 * peak, rtol=0)
    torch.testing.assert_close(im, im_p, atol=1e-5 * peak, rtol=0)
    with pytest.raises(ValueError, match="nfft"):
        stft_pallas(x, w, 128, nfft=256)


@pytest.mark.parametrize("n", [1, 3, 1000, 4099, 262_145, 3_000_001])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_adadelta_kernel_matches_plain(rng, cuda, n, offset):
    """The kernel in place against the plain version out of place on
    copies, twice (the second step from nonzero state); ``offset`` 1 takes
    views that start one float in, so the float4 path is off."""
    def t(scale, nonneg=False):
        v = scale * rng.standard_normal(n + offset)
        return torch.from_numpy((np.abs(v) if nonneg else v).astype(np.float32)).to(cuda)[offset:]

    p, a, d = t(1.0), t(1e-3, True), t(1e-5, True)
    ref = [x.clone() for x in (p, a, d)]
    for step in range(2):
        g = t(0.5 + step)
        before = kernels.LAUNCHES["fused_adadelta"]
        sq = fused_adadelta_leaf(p, g, a, d, 0.9, 0.95, 1e-6)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fused_adadelta"] == before + 1
        sq_p = fused_adadelta_plain(*ref[:1], g, *ref[1:], 0.9, 0.95, 1e-6)
        for got, want in zip((p, a, d), ref):
            assert torch.equal(got, want)
        torch.testing.assert_close(sq, sq_p, rtol=1e-6, atol=0)


def test_fused_adadelta_apply_routes_leaves(rng, cuda):
    """Leaves past min_elems take the kernel, the rest the plain formula;
    the grad norm sums both."""
    shapes = {"big": (300, 70), "small": (5, 3)}
    params = {k: torch.randn(s, device=cuda) for k, s in shapes.items()}
    grads = {k: torch.randn(s, device=cuda) for k, s in shapes.items()}
    from convsep_tpu_torch.train.optim import AdadeltaState, global_norm

    st = AdadeltaState({k: torch.zeros_like(v) for k, v in params.items()},
                       {k: torch.zeros_like(v) for k, v in params.items()})
    before = kernels.LAUNCHES["fused_adadelta"]
    _, _, gn = fused_adadelta_apply(params, grads, st, min_elems=1000)
    assert kernels.LAUNCHES["fused_adadelta"] == before + 1
    torch.testing.assert_close(gn, global_norm(grads), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="distinct"):
        fused_adadelta_leaf(params["big"], grads["big"], st.accu["big"], st.accu["big"],
                            1.0, 0.95, 1e-6)
    with pytest.raises(ValueError, match="mixed devices"):
        fused_adadelta_leaf(params["big"], grads["big"].cpu(), st.accu["big"],
                            st.delta_accu["big"], 1.0, 0.95, 1e-6)


def test_tiny_train_step_kernel_route_matches_plain(cuda):
    """One from-audio train step on the card: the kernel route (stft +
    fused adadelta, min_elems lowered so the tiny leaves take the kernel)
    against the plain route, from the same state and batch."""
    from functools import partial

    from convsep_tpu_torch.configs import TransformConfig, get_preset
    from convsep_tpu_torch.train import e2e, loop

    p = get_preset("dsd100")
    tr = TransformConfig(fs=8000, frame_size=256, hop_size=128, fft_impl="pallas")
    p = dataclasses.replace(
        p, transform=tr,
        model=dataclasses.replace(p.model, time_context=10, feat_size=tr.bins, conv1_freq=8,
                                  conv1_filters=4, conv2_filters=4, bottleneck=16),
        train=dataclasses.replace(p.train, optimizer_impl="fused"),
    )
    plain = dataclasses.replace(
        p, transform=dataclasses.replace(tr, fft_impl="matmul"),
        train=dataclasses.replace(p.train, optimizer_impl="xla"),
    )
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 4, 1024))
                         .astype(np.float32)).to(cuda)
    s_k, opt = loop.create_train_state(p, 0, cuda)
    s_p, _ = loop.create_train_state(plain, 0, cuda)
    from convsep_tpu_torch.train.fused_optim import fused_adadelta_apply as apply

    step_k = loop.step_from_loss(e2e.make_audio_loss_fn(p), opt,
                                 partial(apply, learning_rate=1.0, min_elems=1000))
    step_p = e2e.make_audio_train_step(plain, opt)
    kernels.reset_launches()
    s_k, m_k = step_k(s_k, 0.1 * x.sum(1), 0.1 * x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stft"] == 2 and kernels.LAUNCHES["fused_adadelta"] >= 2
    s_p, m_p = step_p(s_p, 0.1 * x.sum(1), 0.1 * x)
    torch.testing.assert_close(m_k["loss"], m_p["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(m_k["grad_norm"], m_p["grad_norm"], rtol=1e-5, atol=0)
    # from zero state |Δp| <= lr·|Δg| (adadelta's slope in g is at most 1);
    # 1e-5 × the grad norm bounds 1e-5 × max|g|; plus one f32 ulp of the
    # weight, which each route rounds once
    tol = 1e-5 * m_p["grad_norm"].item()
    for k in s_k.params:
        torch.testing.assert_close(s_k.params[k], s_p.params[k], rtol=2 ** -23, atol=tol)
