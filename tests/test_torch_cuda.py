"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card. Every test here is marked ``cuda`` and skips without a GPU. The file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 outputs 1e-5 absolute on stems in [-1, 1] (Wiener) and
1e-4 absolute on O(1) decode sums (as the JAX kernel tests); int16 within
±1 LSB; bf16 decode output within one bf16 ulp; spectra within 1e-5 ×
max|X| (the STFT kernel's f32 sums run in another order than cuBLAS's);
adadelta bit for bit (both round every operation on its own), its
gradient square-sum within 1e-6 relative (the kernel sums in double); the
iSTFT kernel 1e-5 absolute (int16 ±1 LSB); the Wiener mask kernel bit for
bit at p in {1, 2} (both round every operation alike, in one order) and
1e-6 relative through powf; the forward STFT kernel 1e-5 × max|X| (an FFT
against the factored DFT's sums); the Wiener+iSTFT kernel's Nyquist-row
input bit for bit against the same kernel fed the concatenated spectrum;
the band decode kernel 1e-5 × max|out| against the f32 product of the
same bf16-rounded operands."""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from convsep_tpu_torch import kernels
from convsep_tpu_torch.dsp.cuda.ct_stft_kernel import stft_ct_pallas, stft_ct_pallas_plain
from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import (
    istft_ct_pallas,
    istft_ct_pallas_plain,
    wiener_istft,
    wiener_istft_plain,
)
from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas, istft_pallas_plain, launch_istft
from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas, stft_pallas_plain
from convsep_tpu_torch.dsp.cuda.wiener_kernel import wiener_apply_pallas, wiener_apply_plain
from convsep_tpu_torch.dsp.dft import istft_matmul, stft_matmul
from convsep_tpu_torch.dsp.windows import sinebell
from convsep_tpu_torch.models.config import ConvSepConfig
from convsep_tpu_torch.models.convsep import band_freq_conv_kernel
from convsep_tpu_torch.models.decoder_band_cuda import (
    BandOperand,
    band_decode_pallas,
    band_operand,
    band_decode_wmajor,
    band_decode_wmajor_plain,
    band_tensor,
)
from convsep_tpu_torch.models.decoder_fused_cuda import (
    band_freq_decode,
    band_freq_decode_plain,
    card_plan,
    decode_plan,
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


@pytest.mark.parametrize("nfft", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 384, 1000])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_wiener_istft_kernel_every_size(rng, cuda, nfft, S):
    """Every power of two of the FFT core and two sizes that take the
    direct sum, S from 1 to 4 (an odd S: the last pair has no second
    source), hop nfft/4 and a length whose last round is ragged; bf16 y at
    odd S, f32 at even; float32 within 1e-5 and PCM16 within one LSB of the
    plain version, one launch each."""
    hop = nfft // 4
    length = 37 * hop + 5
    w, y, re, im = _wiener_inputs(rng, S, length, nfft, hop, cuda, lead=(1,))
    if S % 2:
        y = y.to(torch.bfloat16)
    for out in ("float32", "int16"):
        before = kernels.LAUNCHES["wiener_istft"]
        got = wiener_istft(y, re, im, w, hop, length, output_dtype=out, p=2.0 if S == 3 else 1.0)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["wiener_istft"] == before + 1
        _close(got, wiener_istft_plain(y, re, im, w, hop, length, output_dtype=out,
                                       p=2.0 if S == 3 else 1.0), out)


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
    """The slice on the card: the kernel route (the fused decode forced, as
    "auto" takes it only at the TMs where it won on the card; the
    Wiener+iSTFT kernel by "auto") agrees with the all-plain route (f32
    tail)."""
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.configs import TransformConfig, get_preset
    from convsep_tpu_torch.separate import Separator

    p = get_preset("highres4096")
    tr = TransformConfig(fs=8000, frame_size=256, hop_size=64)
    p = dataclasses.replace(
        p, transform=tr, sep=dataclasses.replace(p.sep, segment_bucket=2),
        model=dataclasses.replace(p.model, feat_size=tr.bins, conv1_freq=9, conv1_filters=6,
                                  conv2_filters=5, bottleneck=16, mask_dtype="float32",
                                  decoder_impl="bandconv_pallas"),
    )
    state = init_params(p.model, torch.Generator(device=cuda).manual_seed(0), cuda)
    mix = (0.2 * np.random.default_rng(1).standard_normal(9000)).astype(np.float32)
    kernels.reset_launches()
    got = Separator(p, state, device=cuda)(mix)
    launched = {"wiener_istft": 1, "fused_decode": 1, "stft": 0, "stft_dft": 0,
                "fused_adadelta": 0, "istft": 0, "wiener_apply": 0, "wiener_istft_ny": 0,
                "ct_stft": 0, "band_decode": 0}
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
        (1024, 512, 1, 1_474_560),  # the dsd100 fft_impl="pallas" track: nf 2882
        (1024, 512, 128, 14336),  # the training step's stems
        (8192, 2048, 2, 60000),   # nf 32, the FFT core's largest size
        (768, 256, 3, 20000),     # not a power of two: the dense DFT kernel
        (1000, 250, 2, 9001),
    ],
)
def test_stft_kernel_matches_plain(rng, cuda, nfft, hop, B, length):
    """Powers of two launch the FFT kernel ("stft"), other sizes the dense
    DFT kernel ("stft_dft"), each exactly once."""
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32)).to(cuda)
    w = sinebell(nfft)
    used, other = ("stft", "stft_dft") if nfft & (nfft - 1) == 0 else ("stft_dft", "stft")
    before = dict(kernels.LAUNCHES)
    re, im = stft_pallas(x, w, hop)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[used] == before[used] + 1
    assert kernels.LAUNCHES[other] == before[other]
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


def _spectra(rng, lead, length, nfft, hop, device, win=None):
    """Masked STFT halves of a random signal on ``device``."""
    w = sinebell(win or nfft)
    x = torch.from_numpy((0.3 * rng.standard_normal((*lead, length))).astype(np.float32))
    re, im = stft_matmul(x.to(device), w, hop, nfft=nfft)
    mask = torch.from_numpy(rng.uniform(0.0, 1.0, tuple(re.shape)).astype(np.float32)).to(device)
    return w, re * mask, im * mask


def _close(got, want, out):
    assert got.shape == want.shape and got.dtype == want.dtype
    if out == "int16":
        assert (got.int() - want.int()).abs().max().item() <= 1
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "lead,nfft,hop,length",
    [((3,), 256, 64, 6000), ((2, 4), 4096, 1024, 60000), ((1,), 2048, 512, 20001),
     ((), 1024, 256, 9000), ((5,), 512, 64, 7777)],
)
@pytest.mark.parametrize("out", ["float32", "int16"])
def test_istft_ct_kernel_matches_plain(rng, cuda, lead, nfft, hop, length, out):
    w, re, im = _spectra(rng, lead, length, nfft, hop, cuda)
    before = kernels.LAUNCHES["istft"]
    got = istft_ct_pallas(re, im, w, hop, length, output_dtype=out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["istft"] == before + 1
    want = istft_ct_pallas_plain(re, im, w, hop, length, output_dtype=out)
    assert got.shape == (*lead, length)
    _close(got, want, out)


@pytest.mark.parametrize(
    "lead,nfft,win,hop,length",
    [((4,), 1024, 1024, 512, 30000), ((), 128, 128, 64, 3000), ((2,), 256, 128, 32, 5000),
     ((3,), 384, 384, 96, 6000), ((2,), 1000, 1000, 250, 9000), ((1,), 4096, 4096, 1024, 40000)],
)
def test_istft_pallas_kernel_matches_plain(rng, cuda, lead, nfft, win, hop, length):
    w, re, im = _spectra(rng, lead, length, nfft, hop, cuda, win)
    before = kernels.LAUNCHES["istft"]
    got = istft_pallas(re, im, w, hop, length, nfft=nfft)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["istft"] == before + 1
    _close(got, istft_pallas_plain(re, im, w, hop, length, nfft=nfft), "float32")


def test_istft_kernel_refuses(rng, cuda):
    w, re, im = _spectra(rng, (2,), 6000, 256, 64, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        istft_pallas(re, im.cpu(), w, 64, 6000)
    with pytest.raises(ValueError, match="float32"):
        istft_ct_pallas(re.double(), im.double(), w, 64, 6000)
    with pytest.raises(ValueError, match="unsupported"):
        istft_ct_pallas(re, im, sinebell(256), 100, 6000)


@pytest.mark.parametrize("shape", [(4, 2882, 513), (4, 1442, 2049), (3, 7, 9), (1, 33, 129)])
@pytest.mark.parametrize("ydt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1.0, 2.0, 1.5])
def test_wiener_apply_kernel_matches_plain(rng, cuda, shape, ydt, p):
    y = np.abs(rng.standard_normal(shape)).astype(np.float32)
    y[:, : shape[1] // 3, :5] = 0.0
    y[0, shape[1] // 2:, :3] = -1.0
    y = torch.from_numpy(y).to(cuda).to(ydt)
    re = torch.from_numpy(rng.standard_normal(shape[1:]).astype(np.float32)).to(cuda)
    im = torch.from_numpy(rng.standard_normal(shape[1:]).astype(np.float32)).to(cuda)
    before = kernels.LAUNCHES["wiener_apply"]
    got = wiener_apply_pallas(y, re, im, p=p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wiener_apply"] == before + 1
    want = wiener_apply_plain(y, re, im, p=p)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == shape
        if p in (1.0, 2.0):
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="mixed devices"):
        wiener_apply_pallas(y, re.cpu(), im)


@pytest.mark.parametrize("B", [1, 9])
def test_fused_decode_kernel_stereo_tm240_matches_plain(rng, cuda, B):
    """The decode at the stereo geometry: channels_in 2 makes TM = T ·
    stride · C = 240, two 128-column tiles per block row."""
    cfg = dataclasses.replace(CFG, channels_in=2, num_sources=4)
    S, J, W = cfg.num_sources, cfg.bottleneck, cfg.enc_freq
    TpC = cfg.enc_time * cfg.conv2_filters

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(cuda)

    KC, _, _, _ = band_freq_conv_kernel(
        t(cfg.conv2_time_eff, 1, cfg.conv1_filters, cfg.conv2_filters, scale=0.3),
        t(1, cfg.conv1_freq, 2, cfg.conv1_filters, scale=0.3),
        cfg.enc_time, cfg.conv1_freq_stride,
    )
    assert KC.shape[-1] == 240
    ops = prepare_operands(t(J, S * W * TpC, scale=0.2), t(S * W * TpC, scale=0.1), KC, S, W, TpC)
    fc = torch.relu(t(B, J))
    for dt in (torch.float32, torch.bfloat16):
        got = band_freq_decode(fc, *ops, out_dtype=dt)
        want = band_freq_decode_plain(fc, *ops, out_dtype=dt)
        if dt == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        else:
            torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=2 ** -7)


def test_tiny_stereo_slice_kernel_route_matches_plain(cuda):
    """Stereo on the card: the fused decode (TM 240, forced) and the iSTFT
    kernel (forced: at 256 points "auto" keeps the reference's direct
    chain) against the all-plain route, float32 tail."""
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.configs import TransformConfig, get_preset
    from convsep_tpu_torch.separate import StereoSeparator, stereo

    def with_istft(algorithm, sep, audio):
        forced = functools.partial(stereo.istft_matmul, algorithm=algorithm)
        with mock.patch.object(stereo, "istft_matmul", forced):
            return sep(audio)


    p = get_preset("highres4096-stereo")
    tr = TransformConfig(fs=8000, frame_size=256, hop_size=64)
    p = dataclasses.replace(
        p, transform=tr, sep=dataclasses.replace(p.sep, segment_bucket=2),
        model=dataclasses.replace(p.model, feat_size=tr.bins, conv1_freq=9, conv1_filters=6,
                                  conv2_filters=5, bottleneck=16, mask_dtype="float32",
                                  decoder_impl="bandconv_pallas"),
    )
    state = init_params(p.model, torch.Generator(device=cuda).manual_seed(0), cuda)
    mix = (0.2 * np.random.default_rng(1).standard_normal((9000, 2))).astype(np.float32)
    kernels.reset_launches()
    got = with_istft("ct_pallas", StereoSeparator(p, state, device=cuda), mix)
    assert kernels.LAUNCHES["istft"] == 1 and kernels.LAUNCHES["fused_decode"] == 1
    plain = dataclasses.replace(p, model=dataclasses.replace(p.model, decoder_impl="bandconv"))
    want = with_istft("factored", StereoSeparator(plain, state, device=cuda), mix)
    assert kernels.LAUNCHES["istft"] == 1 and kernels.LAUNCHES["fused_decode"] == 1
    assert got.shape == (4, 9000, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_tiny_pallas_route_slice_matches_matmul_route(cuda):
    """``fft_impl="pallas"`` separation on the card: the STFT, Wiener mask
    and iSTFT kernels, one launch each, against the matmul route by SNR
    (the two STFTs sum in other orders, and the Wiener ratio amplifies
    that where every source's estimate is near 0)."""
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.configs import TransformConfig, get_preset
    from convsep_tpu_torch.separate import Separator

    p = get_preset("dsd100")
    tr = TransformConfig(fs=8000, frame_size=256, hop_size=128, fft_impl="pallas")
    p = dataclasses.replace(
        p, transform=tr, sep=dataclasses.replace(p.sep, segment_bucket=2),
        model=dataclasses.replace(p.model, time_context=10, feat_size=tr.bins, conv1_freq=8,
                                  conv1_filters=4, conv2_filters=4, bottleneck=16,
                                  mask_dtype="float32"),
    )
    state = init_params(p.model, torch.Generator(device=cuda).manual_seed(0), cuda)
    mix = (0.2 * np.random.default_rng(2).standard_normal(9000)).astype(np.float32)
    kernels.reset_launches()
    got = Separator(p, state, device=cuda)(mix)
    assert {k: kernels.LAUNCHES[k] for k in ("stft", "wiener_apply", "istft")} == {
        "stft": 1, "wiener_apply": 1, "istft": 1}
    mm = dataclasses.replace(p, transform=dataclasses.replace(tr, fft_impl="matmul",
                                                              masked_synthesis="direct"))
    want = Separator(mm, state, device=cuda)(mix).astype(np.float64)
    snr = 10 * np.log10((want ** 2).sum() / ((got - want) ** 2).sum())
    assert got.shape == (4, 9000) and np.isfinite(got).all() and snr >= 70.0, snr


@pytest.mark.parametrize(
    "nfft,B,length",
    [
        (4096, 1, 1_474_560),   # one 30 s multires4096 track: nf 1442
        (4096, 3, 60_001),      # nf 61: an odd last frame pairs with zeros
        (4096, 1, 1),           # one sample: 3 frames
        (2048, 2, 33_333),
        (8192, 2, 100_000),
    ],
)
def test_ct_stft_kernel_matches_plain(rng, cuda, nfft, B, length):
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32)).to(cuda)
    w = sinebell(nfft)
    before = kernels.LAUNCHES["ct_stft"]
    got = stft_ct_pallas(x, w, 1024)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ct_stft"] == before + 1
    want = stft_ct_pallas_plain(x, w, 1024)
    nf = -(-length // 1024) + 2
    assert got[0].shape == (B, nf, nfft // 2) and got[2].shape == (B, nf)
    peak = max(a.abs().max().item() for a in want)
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, atol=1e-5 * peak, rtol=0)
    for g, one in zip(got, stft_ct_pallas(x[0], w, 1024)):  # unbatched
        assert torch.equal(g[0], one)


def test_ct_stft_kernel_refuses(cuda):
    x = torch.zeros(2, 5000, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        stft_ct_pallas(x, sinebell(4096), 512)
    with pytest.raises(ValueError, match="kernel unsupported"):
        stft_ct_pallas(torch.zeros(2, 50000, device=cuda), sinebell(16384), 1024)


@pytest.mark.parametrize("S,kw", [(4, {}), (4, {"p": 2.0}), (3, {"conserve_last": True}),
                                  (4, {"output_dtype": "int16"})])
@pytest.mark.parametrize("ydt", [torch.float32, torch.bfloat16])
def test_wiener_istft_ny_input(rng, cuda, S, kw, ydt):
    """The Nyquist-row input against the plain version and, bit for bit,
    against the same kernel fed the concatenated spectrum."""
    w, length = sinebell(4096), 60_000
    x = torch.from_numpy((0.3 * rng.standard_normal((2, length))).astype(np.float32)).to(cuda)
    re, im, ny = stft_ct_pallas(x, w, 1024)
    y = np.abs(rng.standard_normal((2, S, re.shape[1], 2049))).astype(np.float32)
    y[..., : re.shape[1] // 3, :8] = 0.0
    y = torch.from_numpy(y).to(cuda).to(ydt)
    full_re = torch.cat([re, ny[..., None]], -1)
    full_im = torch.cat([im, torch.zeros_like(ny)[..., None]], -1)
    before = dict(kernels.LAUNCHES)
    got = wiener_istft(y, re, im, w, 1024, length, ny=ny, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wiener_istft_ny"] == before["wiener_istft_ny"] + 1
    assert kernels.LAUNCHES["wiener_istft"] == before["wiener_istft"]
    assert torch.equal(got, wiener_istft(y, full_re, full_im, w, 1024, length, **kw))
    _close(got, wiener_istft_plain(y, re, im, w, 1024, length, ny=ny, **kw),
           kw.get("output_dtype", "float32"))


@pytest.mark.parametrize(
    "N,Tp,W,C2,kh,I",
    [
        (196, 16, 505, 50, 15, 50),   # one multires4096 track: depth 800, 1500 columns
        (3, 16, 13, 8, 15, 6),
        (2, 6, 9, 8, 5, 3),
        (5, 1, 7, 16, 1, 130),        # one tap: the band is block-diagonal
        (1, 4, 200, 10, 9, 7),
    ],
)
def test_band_decode_kernel_matches_plain(rng, cuda, N, Tp, W, C2, kh, I):
    T = Tp + kh - 1
    z = torch.relu(torch.from_numpy(rng.standard_normal((N, W, Tp * C2)).astype(np.float32))).to(cuda)
    k = torch.from_numpy((0.2 * rng.standard_normal((kh, 1, I, C2))).astype(np.float32)).to(cuda)
    band = band_tensor(k, T)
    before = kernels.LAUNCHES["band_decode"]
    got = band_decode_wmajor(z, band, T)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["band_decode"] == before + 1
    want = band_decode_wmajor_plain(z, band)
    assert got.shape == want.shape == (N, W, T * I) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)
    assert torch.equal(band_decode_wmajor(z.to(torch.bfloat16), band, T), got)
    zt = z.reshape(N, W, Tp, C2).permute(0, 2, 1, 3)  # the reference's (N, Tp, W, O)
    assert torch.equal(band_decode_pallas(zt, k, T), got)


def test_band_decode_kernel_refuses(cuda):
    band = band_tensor(torch.zeros(15, 1, 50, 400, device=cuda), 30)  # depth 16 x 400
    with pytest.raises(ValueError, match="shared memory"):
        band_decode_wmajor(torch.zeros(2, 3, 6400, device=cuda), band, 30)
    band = band_tensor(torch.zeros(3, 1, 2, 5, device=cuda), 6)
    with pytest.raises(ValueError, match="mixed devices"):
        band_decode_wmajor(torch.zeros(2, 3, 20), band, 6)
    with pytest.raises(ValueError, match="packed taps"):
        band_decode_wmajor(torch.zeros(2, 3, 20, device=cuda),
                           BandOperand(band, torch.zeros(8, device=cuda, dtype=torch.bfloat16)), 6)


@pytest.mark.parametrize(
    "N,Tp,W,C2,kh,I",
    [
        (3, 10, 21, 8, 1, 12),     # kh 1: Tp = T, the band is block-diagonal
        (2, 1, 33, 6, 12, 10),     # Tp 1: kh = T, one depth block
        (1, 5, 77, 5, 4, 9),       # C2 odd (thread stores), I odd, M 77 (a ragged row tile)
        (4, 16, 50, 50, 15, 50),   # multires4096's geometry, M 200
        (1, 3, 300, 12, 6, 64),    # one 64-column product a t
        (2, 2, 70, 4, 3, 72),      # 9 products of 8 columns a t
    ],
)
def test_band_decode_kernel_shapes(rng, cuda, N, Tp, W, C2, kh, I):
    """Row tiles not a multiple of 64, the band's two extremes, odd C2 and
    I, and product widths from 8 to 64 columns: the prepared operand
    within 1e-5 × max|out| of the plain version, one launch, bit-equal to
    the bare band (packed on the call)."""
    T = Tp + kh - 1
    z = torch.relu(torch.from_numpy(rng.standard_normal((N, W, Tp * C2)).astype(np.float32))).to(cuda)
    k = torch.from_numpy((0.2 * rng.standard_normal((kh, 1, I, C2))).astype(np.float32)).to(cuda)
    op = band_operand(k, T)
    before = kernels.LAUNCHES["band_decode"]
    got = band_decode_wmajor(z, op, T)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["band_decode"] == before + 1
    want = band_decode_wmajor_plain(z, op)
    assert got.shape == want.shape == (N, W, T * I)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)
    assert torch.equal(band_decode_wmajor(z, op.band, T), got)


def _tiny_multires(**model_kw):
    """multires4096's transform (4096 pt, hop 1024, channels at 1024 and
    2048 points) and model geometry, cut in width, f32 tail."""
    from convsep_tpu_torch.configs import get_preset

    p = get_preset("multires4096")
    return dataclasses.replace(
        p, sep=dataclasses.replace(p.sep, segment_bucket=1),
        model=dataclasses.replace(p.model, conv1_freq=9, conv1_filters=4, conv2_filters=4,
                                  bottleneck=8, mask_dtype="float32", **model_kw),
    )


def test_tiny_multires_ct_route_matches_matmul_route(cuda):
    """``analysis="ct_pallas"`` on the card: the forward STFT kernel and the
    Nyquist-row Wiener+iSTFT kernel, one launch each, against the matmul
    route by SNR (the two analyses sum in other orders)."""
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.separate import Separator

    p = _tiny_multires(decoder_impl="bandconv")
    ct = dataclasses.replace(p, transform=dataclasses.replace(p.transform, analysis="ct_pallas"))
    state = init_params(p.model, torch.Generator(device=cuda).manual_seed(0), cuda)
    mix = (0.2 * np.random.default_rng(3).standard_normal(40_000)).astype(np.float32)
    kernels.reset_launches()
    got = Separator(ct, state, device=cuda)(mix)
    assert {k: kernels.LAUNCHES[k] for k in ("ct_stft", "wiener_istft_ny", "wiener_istft")} == {
        "ct_stft": 1, "wiener_istft_ny": 1, "wiener_istft": 0}
    want = Separator(p, state, device=cuda)(mix).astype(np.float64)
    snr = 10 * np.log10((want ** 2).sum() / ((got - want) ** 2).sum())
    assert got.shape == (4, 40_000) and np.isfinite(got).all() and snr >= 70.0, snr


def test_tiny_multires_band_pallas_matches_plain_band(cuda):
    """``decoder_impl="band_pallas"`` on the card: the band decode kernel
    against its plain version in the same model (the same z, so the same
    bf16 roundings), on the model's output y."""
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.models import convsep as tconv
    from convsep_tpu_torch.separate import Separator, source_magnitudes

    p = _tiny_multires(decoder_impl="band_pallas")
    state = init_params(p.model, torch.Generator(device=cuda).manual_seed(0), cuda)
    sep = Separator(p, state, device=cuda)
    x = torch.from_numpy((0.2 * np.random.default_rng(4).standard_normal((1, 30 * 1024)))
                         .astype(np.float32)).to(cuda)
    kernels.reset_launches()
    y = source_magnitudes(sep.model, x, p)[0]
    assert kernels.LAUNCHES["band_decode"] == 1 and kernels.LAUNCHES["fused_decode"] == 0
    def plain(z, band, T):
        return band_decode_wmajor_plain(z, band)

    with mock.patch.object(tconv, "band_decode_kernel", plain):
        y_p = source_magnitudes(sep.model, x, p)[0]
    assert kernels.LAUNCHES["band_decode"] == 1
    torch.testing.assert_close(y, y_p, atol=1e-5 * y_p.abs().max().item(), rtol=0)


# -- the redesigned decode (3xTF32 on the tensor cores) and iSTFT (FFT core)


def _decode_operands(rng, device, B, TM, ktaps, J=32, S=2, W_pad=40, TpC=100):
    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(device)

    fc = torch.relu(t(B, J))
    return fc, (t(J, S, W_pad, TpC, scale=0.2), t(S, W_pad, TpC, scale=0.1),
                t(TpC, ktaps, TM, scale=0.1))


@pytest.mark.parametrize("ktaps", [2, 8, 17])
@pytest.mark.parametrize("TM", [90, 120, 240, 360, 384])
@pytest.mark.parametrize("B", [1, 49, 64, 65])
def test_fused_decode_tiles(rng, cuda, B, TM, ktaps):
    """Across the fc row tile's edge (64, 65), the cluster's column tiles
    (3 to 8 blocks of 32 or 48 columns) and the halo's depth (ktaps):
    float32 output within chip_smoke.py's 1e-5 × max|plain| (3xTF32 keeps
    float32 parity), bf16 within one ulp."""
    fc, ops = _decode_operands(rng, cuda, B, TM, ktaps)
    for dt in (torch.float32, torch.bfloat16):
        got = band_freq_decode(fc, *ops, out_dtype=dt).float()
        want = band_freq_decode_plain(fc, *ops, out_dtype=dt).float()
        scale = want.abs().max().item()
        tol = (1e-5 if dt == torch.float32 else 2 ** -7) * scale
        assert got.shape == want.shape == (B, 2, 40, TM)
        assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("nfft", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 384, 1000])
@pytest.mark.parametrize("out", ["float32", "int16"])
def test_istft_kernel_every_size(rng, cuda, nfft, out):
    """The iSTFT kernel at every power of two its FFT core takes and at two
    sizes that take the direct sum, win = nfft, hop = nfft / 4, float32
    within 1e-5 and PCM16 within one LSB of the plain synthesis."""
    hop = nfft // 4
    length = 37 * hop + 5
    w, re, im = _spectra(rng, (3,), length, nfft, hop, cuda)
    before = kernels.LAUNCHES["istft"]
    got = launch_istft(re, im, w, hop, length, nfft, out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["istft"] == before + 1
    want = istft_matmul(re, im, w, hop, length, nfft=nfft, algorithm="direct", output_dtype=out)
    _close(got, want, out)


# ptxas's stack frame (bytes) of every iSTFT FFT-kernel instance the tests
# launch, by log2 of the FFT size, as measured on an H100 build (sm_90a,
# 128 registers a thread at 512 threads a block): the preset sizes (1024,
# 4096 points) keep their register arrays off the stack; 32, 512 and 8192
# points spill a few. A larger frame is a regression.
ISTFT_STACK_CEILING = {4: 0, 5: 88, 6: 0, 7: 0, 8: 0, 9: 16, 10: 0, 11: 0, 12: 0, 13: 8}


# the same for the fused decode kernel's two instances (MI, NI, warps): the
# 16-warp instance keeps its registers off the stack; the 12-warp one (96
# accumulators a thread at 168 registers) spills a few bytes.
DECODE_STACK_CEILING = {"ILi3ELi4ELi16E": 0, "ILi4ELi6ELi12E": 40}


def test_redesigned_kernels_keep_registers_off_the_stack(tmp_path):
    """ptxas's stack frames for the redesigned kernels: each fused decode
    and iSTFT FFT-kernel instance at most its recorded frame
    (``DECODE_STACK_CEILING``, ``ISTFT_STACK_CEILING``), every Wiener+iSTFT
    and band decode instance none; and no band decode instance has its
    wgmma chains serialized by ptxas (warning C7520)."""
    import re as regex
    import subprocess

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA toolkit of a machine with a card")
    frames, logs = {}, {}
    for src in ("decoder_fused.cu", "istft.cu", "wiener_istft.cu", "band_decode.cu"):
        out = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas=-v", "-c", str(kernels.CSRC / src),
             "-o", str(tmp_path / "k.o")], capture_output=True, text=True, check=True)
        logs[src] = out.stdout + out.stderr
        frames.update({m[0]: int(m[1]) for m in regex.findall(
            r"Function properties for (\S+)\n\s+(\d+) bytes stack frame", logs[src])})
    for name in ("wiener_fft_kernel", "wiener_direct_kernel", "band_decode_kernel"):
        hits = [v for k, v in frames.items() if name in k]
        assert hits and max(hits) == 0, (name, frames)
    assert "C7520" not in logs["band_decode.cu"]
    for inst, most in DECODE_STACK_CEILING.items():
        hits = [v for k, v in frames.items() if "fused_decode_kernel" + inst in k]
        assert len(hits) == 1 and hits[0] <= most, (inst, frames)
    for log2n, most in ISTFT_STACK_CEILING.items():
        hits = [v for k, v in frames.items() if f"istft_fft_kernelILi{log2n}E" in k]
        assert hits and max(hits) <= most, (log2n, frames)


@pytest.mark.parametrize("shape", [(49, 128, 4, 512, 800, 8, 120), (49, 128, 4, 512, 800, 8, 240),
                                   (49, 128, 4, 512, 800, 8, 360), (65, 32, 2, 40, 100, 17, 360),
                                   (1, 32, 2, 40, 100, 2, 90)])
def test_fused_decode_plan_mirrors_the_launcher(cuda, shape):
    """decode_plan (the CPU tests' mirror) is the launcher's own plan, and
    the card runs at least one of its clusters."""
    got = card_plan(*shape)
    p = decode_plan(*shape)
    assert (got["mi"], got["ni"], got["cluster"], got["bp"], got["wb"], got["rc"], got["es"],
            got["smem_bytes"]) == (p.mi, p.ni, p.cluster, p.bp, p.wb, p.rc, p.es, p.smem_bytes)
    assert got["active_clusters"] >= 1


def _tiny(name: str, **model_kw):
    """A preset's model geometry (T, stride, sources) at 8 kHz, W 256, cut
    in width, f32 tail."""
    from convsep_tpu_torch.configs import TransformConfig, get_preset

    p = get_preset(name)
    tr = TransformConfig(fs=8000, frame_size=256, hop_size=64 if "highres" in name else 128)
    return dataclasses.replace(
        p, transform=tr, sep=dataclasses.replace(p.sep, segment_bucket=2),
        model=dataclasses.replace(p.model, feat_size=tr.bins, conv1_freq=9, conv1_filters=6,
                                  conv2_filters=5, bottleneck=16, mask_dtype="float32",
                                  **model_kw),
    )


def _snr(ref, est):
    ref = ref.astype(np.float64)
    return 10 * np.log10((ref ** 2).sum() / max(((est - ref) ** 2).sum(), 1e-300))


def test_tiny_chunked_online_stream_on_the_card(cuda):
    """The chunked, online and stream separators on the card against the
    whole-track Separator (f32 tail; by SNR, as chip_smoke.py holds two
    routes: the whole track synthesizes with the Wiener+iSTFT kernel, a
    chunk by products), online against chunked bit for bit, and reset()
    and close() with copies in flight."""
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.separate import (
        ChunkedSeparator,
        OnlineSeparator,
        Separator,
        StreamSeparator,
    )

    p = _tiny("dsd100", time_context=10)
    state = init_params(p.model, torch.Generator(device=cuda).manual_seed(0), cuda)
    rng = np.random.default_rng(3)
    mix = (0.2 * rng.standard_normal(20_000)).astype(np.float32)
    whole = Separator(p, state, device=cuda)
    ref = whole(mix)
    chunked = ChunkedSeparator(p, state, chunk_segments=3, device=cuda)(mix)
    assert chunked.shape == ref.shape and _snr(ref, chunked) >= 70.0
    osep = OnlineSeparator(p, state, chunk_segments=3, max_pending=2, device=cuda)
    outs = [osep.push(mix[i:i + 777]) for i in range(0, len(mix), 777)]
    online = np.concatenate(outs + [osep.flush()], axis=-1)
    np.testing.assert_array_equal(online, chunked)
    osep.reset()
    osep.push(mix[: 3 * osep.latency_samples])
    assert osep._pending
    osep.reset()  # waits for the copies in flight
    assert not osep._pending
    osep.push(mix[: 3 * osep.latency_samples])
    osep.close()
    assert osep._copy is None and not osep._pending
    tracks = [mix, mix[:13_000], 0.5 * mix[:17_000]]
    got = [o for b in StreamSeparator(p, state, device=cuda).stream(iter(tracks), 2) for o in b]
    for t, o in zip(tracks, got):
        assert o.shape == (4, len(t)) and _snr(whole(t), o) >= 70.0


@pytest.mark.parametrize("B", [8, 32, 98])
def test_auto_decode_rule_by_batch_on_the_card(cuda, B):
    """"auto" launches the fused decode at TM 120 only for a batch inside
    FUSED_DECODE_WON: the online chunks (B 8) and a stream batch of two
    30 s tracks (B 98) take the plain decode, chunks of 32 segments the
    kernel."""
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.models import ConvSep
    from convsep_tpu_torch.models.decoder_fused_cuda import fused_decode_won

    p = _tiny("highres4096")
    cfg = p.model
    assert cfg.time_context * cfg.conv1_freq_stride * cfg.channels_in == 120
    model = ConvSep(cfg, init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda),
                    device=cuda).prepare_inference()
    x = torch.rand(B, cfg.time_context, cfg.feat_size, 1, device=cuda)
    kernels.reset_launches()
    y = model.sources(x)
    torch.cuda.synchronize()
    assert y.shape == (B, cfg.num_sources, cfg.time_context, cfg.feat_size)
    assert kernels.LAUNCHES["fused_decode"] == int(fused_decode_won(120, B))
    assert fused_decode_won(120, B) == (B == 32)


def test_async_copies_on_a_side_stream(cuda):
    """fetch_async's host tensor equals ``.cpu()`` once its event completes,
    also when the copy is enqueued behind work still running; an upload on
    the side stream is ordered before its use on the current stream."""
    from convsep_tpu_torch.utils.transfer import (
        fetch_async,
        host_array,
        stage_pinned,
        upload_async,
        wait_upload,
    )

    side = torch.cuda.Stream(cuda)
    a = torch.randn(2048, 2048, device=cuda)
    for _ in range(3):
        t = a @ a  # still running when the copy is enqueued
        host, done = fetch_async(t, side)
        assert host.is_pinned() and done is not None
        np.testing.assert_array_equal(host_array(host, done), t.cpu().numpy())
    arr = np.random.default_rng(0).standard_normal((3, 100_000)).astype(np.float32)
    staged = stage_pinned(arr, cuda)
    assert staged.is_pinned()
    dev, ev = upload_async(staged, cuda, side)
    out = wait_upload(dev, ev) * 2.0
    np.testing.assert_array_equal(out.cpu().numpy(), arr * 2.0)


def test_feature_step_fused_matches_plain_route(cuda):
    """One dsd100 feature step at full width (B 4): the fused route (two
    adadelta launches, fc_expand_kernel and fc_kernel) against the plain
    route from the same parameters, zero accumulators and batch: the loss
    within 1e-6 relative (the same forward), the updated weights within
    1e-5 × max|g| (cuDNN's weight-gradient convolutions need not repeat bit
    for bit); on the same gradients the fused update is the plain one bit
    for bit."""
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.train import loop

    p = get_preset("dsd100")
    fused = dataclasses.replace(p, train=dataclasses.replace(p.train, optimizer_impl="fused"))
    m = p.model
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = 0.3 * torch.rand(4, m.time_context, m.feat_size, 1, device=cuda, generator=gen)
    y = 0.3 * torch.rand(4, m.num_sources, m.time_context, m.feat_size, device=cuda,
                         generator=gen)
    sf, opt = loop.create_train_state(fused, 0, cuda)
    sp, _ = loop.create_train_state(p, 0, cuda, params=sf.params)
    kernels.reset_launches()
    sf, mf = loop.make_train_step(fused, opt)(sf, x, y)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_adadelta"] == 2
    kernels.reset_launches()
    sp, mp = loop.make_train_step(p, opt)(sp, x, y)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_adadelta"] == 0
    np.testing.assert_allclose(mf["loss"].item(), mp["loss"].item(), rtol=1e-6)
    init, _ = loop.create_train_state(p, 0, cuda)
    loss = loop._feature_loss_fn(p)(init.params, x, y)
    g = dict(zip(init.params, torch.autograd.grad(loss, list(init.params.values()))))
    gmax = max(v.abs().max().item() for v in g.values())
    for k in sf.params:
        err = (sf.params[k] - sp.params[k]).abs().max().item()
        assert err <= 1e-5 * gmax, (k, err, gmax)
    a, opt_a = loop.create_train_state(fused, 0, cuda, params=init.params)
    b, _ = loop.create_train_state(p, 0, cuda, params=init.params)
    _, sa, _ = loop._preset_apply_fn(fused)(a.params, g, a.opt_state)
    _, sb, _ = loop._apply_from_opt(opt_a)(b.params, g, b.opt_state)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(sa.accu[k], sb.accu[k]), k
        assert torch.equal(sa.delta_accu[k], sb.delta_accu[k]), k


def test_checkpoint_round_trip_of_a_cuda_state(cuda, tmp_path):
    """A dsd100 train state on the card (random accumulators) saved and
    restored into a fresh state on the card: every leaf bit for bit, on
    the card, the parameters trainable leaves."""
    from convsep_tpu_torch.ckpt import CheckpointManager
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.train import loop

    p = get_preset("dsd100")
    s, _ = loop.create_train_state(p, 0, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for k in s.params:
            s.opt_state.accu[k].copy_(torch.rand(s.params[k].shape, device=cuda, generator=gen))
    s.step = 7
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(7, s, extra={"epoch": 1, "batch_in_epoch": 3})
    fresh, _ = loop.create_train_state(p, 1, cuda)
    got, meta = mgr.restore_latest(fresh)
    assert meta == {"epoch": 1, "batch_in_epoch": 3} and got.step == 7
    for k in s.params:
        for a, b in ((s.params[k], got.params[k]), (s.opt_state.accu[k], got.opt_state.accu[k]),
                     (s.opt_state.delta_accu[k], got.opt_state.delta_accu[k])):
            assert b.device.type == "cuda" and torch.equal(a, b), k
        assert got.params[k].requires_grad and got.params[k].is_leaf


def test_bss_eval_on_the_card_matches_cpu(cuda):
    """BSS Eval in float64 on the card against the CPU route, within 1e-4
    dB, at flen 512 (2048² Grams): four noise sources, whose Grams the card
    factors and solves itself (Cholesky), and four sources of which three
    are tones, a Gram singular to rounding that both routes solve by
    LAPACK's least squares on the host (``SOLVES`` says which ran); a
    stereo pair of the latter."""
    from convsep_tpu_torch.eval import bss_eval_sources, bss_eval_stereo, sdr_only
    from convsep_tpu_torch.eval.bss_eval import SOLVES

    rng = np.random.default_rng(5)
    n = 3 * 8000
    t = np.arange(n) / 8000
    refs = np.stack([np.sin(2 * np.pi * f * t) * (1 + 0.3 * np.sin(2 * np.pi * 0.7 * t))
                     for f in (220.0, 440.0, 1760.0)] + [0.2 * rng.standard_normal(n)])
    mix = np.array([[0.8, 0.1, 0.05, 0.1], [0.1, 0.7, 0.1, 0.0], [0.0, 0.2, 0.9, 0.1],
                    [0.1, 0.0, 0.0, 0.6]])
    ests = mix @ refs + 0.02 * rng.standard_normal(refs.shape)
    noise = 0.2 * rng.standard_normal((4, n))
    noise_ests = mix @ noise + 0.02 * rng.standard_normal(noise.shape)
    for r, e, singular in ((noise, noise_ests, False), (refs, ests, True)):
        for compute_permutation in (False, True):
            SOLVES.clear()
            got = bss_eval_sources(r, e, flen=512, compute_permutation=compute_permutation,
                                   device=cuda)
            assert bool(SOLVES["lstsq_host"]) == singular, dict(SOLVES)
            assert SOLVES["cholesky"] > 0
            want = bss_eval_sources(r, e, flen=512, compute_permutation=compute_permutation,
                                    device="cpu")
            for g, w in zip(got[:3], want[:3]):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
            np.testing.assert_array_equal(got[3], want[3])
    st_refs = np.stack([refs[:2], refs[2:]])
    st_ests = np.stack([ests[:2], ests[2:]])
    for g, w in zip(bss_eval_stereo(st_refs, st_ests, flen=512, device=cuda),
                    bss_eval_stereo(st_refs, st_ests, flen=512, device="cpu")):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    assert abs(sdr_only(refs[0], ests[0], device=cuda)
               - sdr_only(refs[0], ests[0], device="cpu")) <= 1e-4


def test_cli_separate_on_the_card_equals_separator(cuda, tmp_path, monkeypatch):
    """``convsep-torch separate`` on the card (a seeded reference pickle)
    writes the PCM16 stems of an in-process ``Separator`` with the same
    weights, bit for bit, through the Wiener+iSTFT kernel."""
    import pickle

    from convsep_tpu_torch import cli
    from convsep_tpu_torch.ckpt import export_reference_params, init_params
    from convsep_tpu_torch.configs import presets
    from convsep_tpu_torch.data.io import read_wav, write_wav
    from convsep_tpu_torch.separate import Separator

    p = _tiny("dsd100", time_context=10)
    monkeypatch.setitem(presets.PRESETS, "tinydsd", lambda: p)
    state = init_params(p.model, torch.Generator().manual_seed(3))
    pkl = str(tmp_path / "m.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(export_reference_params(state, p.model), f, protocol=2)
    mix = (0.2 * np.random.default_rng(4).standard_normal(20_000)).astype(np.float32)
    wav = str(tmp_path / "mix.wav")
    write_wav(wav, p.transform.fs, mix)
    kernels.reset_launches()
    assert cli.main(["separate", "--preset", "tinydsd", "--params", pkl, "-i", wav,
                     "-o", str(tmp_path / "est"), "--device", "cuda"]) == 0
    assert kernels.LAUNCHES["wiener_istft"] == 1
    _, pcm = read_wav(wav)
    want = Separator(p, state, device=cuda, output_dtype="int16", input_dtype="int16")(pcm)
    for i, name in enumerate(p.sources):
        got = read_wav(str(tmp_path / "est" / f"{name}.wav"))[1]
        np.testing.assert_array_equal(np.round(got * 32768).astype(np.int16), want[i])
