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
the band decode kernels (the one-piece, the streamed and the forced
pieces) 1e-5 × max|out| against the f32 product of the same bf16-rounded
operands; the CUDA graph of K train steps against eager
steps bit for bit (cuDNN deterministic), and an asynchronous checkpoint's
restore bit for bit."""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from convsep_tpu_torch import kernels
from convsep_tpu_torch.dsp.cuda.ct_stft_kernel import (
    stft_ct_cluster_pallas,
    stft_ct_pallas,
    stft_ct_pallas_plain,
)
from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import (
    istft_ct_pallas,
    istft_ct_pallas_plain,
    wiener_bluestein_cluster_pallas,
    wiener_cluster_mixed_pallas,
    wiener_direct_pallas,
    wiener_istft,
    wiener_istft_plain,
)
from convsep_tpu_torch.dsp.cuda.fft_plan import wiener_plan
from convsep_tpu_torch.dsp.cuda.istft_kernel import (
    istft_bluestein_cluster_pallas,
    istft_direct_pallas,
    istft_pallas,
    istft_pallas_plain,
    launch_istft,
)
from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_dft_pallas, stft_pallas, stft_pallas_plain
from convsep_tpu_torch.dsp.cuda.wiener_kernel import wiener_apply_pallas, wiener_apply_plain
from convsep_tpu_torch.dsp.dft import _ct_supported, istft_matmul, stft_matmul
from convsep_tpu_torch.dsp.windows import sinebell
from convsep_tpu_torch.models.config import ConvSepConfig
from convsep_tpu_torch.models.convsep import band_freq_conv_kernel
from convsep_tpu_torch.models.decoder_band_cuda import (
    BAND_STREAM_WON,
    BandOperand,
    band_decode_pallas,
    band_decode_pieces_pallas,
    band_decode_stream_pallas,
    band_operand,
    band_decode_wmajor,
    band_decode_wmajor_plain,
    band_pieces,
    band_stream_plan,
    band_tensor,
    streams,
)
from convsep_tpu_torch.models.decoder_fused_cuda import (
    band_freq_decode,
    band_freq_decode_plain,
    card_plan,
    decode_plan,
    prepare_operands,
)
from convsep_tpu_torch.train.fused_optim import (
    _MIN_ELEMS,
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


WIENER_NAMES = tuple(k for k in kernels.LAUNCHES if k.startswith("wiener_istft"))


def _wiener_kernel(nfft, hop, S, nf, has_ny=False):
    """The launch count a Wiener+iSTFT call at this shape adds to: its plan's
    route (the core, the split, Bluestein, Bluestein's cluster, the direct
    cluster)."""
    route = wiener_plan(1, S, nf, nfft, hop).route
    return ("wiener_istft_ny" if has_ny else "wiener_istft") + ("" if route == "fft" else
                                                                "_" + route)


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
        (384, 96, 6000, 3, {}),                    # even, not a power of two: the split
        (1000, 250, 9000, 2, {"p": 2.0, "conserve_last": True}),  # Bluestein
    ],
)
@pytest.mark.parametrize("ydt", [torch.float32, torch.bfloat16])
def test_wiener_istft_kernel_matches_plain(rng, cuda, nfft, hop, length, S, kw, ydt):
    w, y, re, im = _wiener_inputs(rng, S, length, nfft, hop, cuda)
    y = y.to(ydt)
    name = _wiener_kernel(nfft, hop, S, re.shape[-2])
    for out in ("float32", "int16"):
        before = dict(kernels.LAUNCHES)
        got = wiener_istft(y, re, im, w, hop, length, output_dtype=out, **kw)
        torch.cuda.synchronize()
        assert {k: kernels.LAUNCHES[k] - before[k] for k in WIENER_NAMES} == {
            k: int(k == name) for k in WIENER_NAMES}
        want = wiener_istft_plain(y, re, im, w, hop, length, output_dtype=out, **kw)
        assert got.shape == want.shape == (2, S, length) and got.dtype == want.dtype
        if out == "int16":
            assert (got.int() - want.int()).abs().max().item() <= 1
        else:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("nfft", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 384, 1000])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_wiener_istft_kernel_every_size(rng, cuda, nfft, S):
    """Every power of two of the FFT core, a split size (384) and a
    Bluestein size (1000), S from 1 to 4 (an odd S: the last pair has no
    second source), hop nfft/4 and a length whose last round is ragged; bf16
    y at odd S, f32 at even; float32 within 1e-5 and PCM16 within one LSB of
    the plain version, one launch each of the plan's kernel."""
    hop = nfft // 4
    length = 37 * hop + 5
    w, y, re, im = _wiener_inputs(rng, S, length, nfft, hop, cuda, lead=(1,))
    if S % 2:
        y = y.to(torch.bfloat16)
    name = _wiener_kernel(nfft, hop, S, re.shape[-2])
    for out in ("float32", "int16"):
        before = kernels.LAUNCHES[name]
        got = wiener_istft(y, re, im, w, hop, length, output_dtype=out, p=2.0 if S == 3 else 1.0)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        _close(got, wiener_istft_plain(y, re, im, w, hop, length, output_dtype=out,
                                       p=2.0 if S == 3 else 1.0), out)


@pytest.mark.parametrize("nfft,hop,length,S,kw,ydt", [
    (16384, 2048, 60000, 4, {}, torch.float32),    # the reference's 16 384: C 2 (C 4), k 8
    (16384, 4096, 50000, 3, {"p": 2.0, "conserve_last": True}, torch.bfloat16),  # S odd
    (32768, 4096, 90000, 4, {}, torch.bfloat16),   # the reference's 32 768: C 4 (C 8)
    (10000, 2500, 40000, 2, {"p": 2.0}, torch.float32),  # 5-smooth: C 2 of n 5000 (C 4)
    (20000, 5000, 60000, 5, {"conserve_last": True}, torch.float32),  # C 4 (C 8), S odd
])
def test_wiener_istft_cluster_kernel_matches_plain(rng, cuda, nfft, hop, length, S, kw, ydt):
    """The Wiener+iSTFT past 8192 points on a thread-block cluster, a pair of
    sources a cluster: the route's kernel (the direct transform at the
    powers of two, "wiener_istft_cluster_dit"; the same on the 5-smooth
    block core at 10 000 and 20 000, "wiener_istft_cluster_mixed";
    Bluestein's elsewhere, "wiener_istft_cluster") and Bluestein's forced
    (wiener_bluestein_cluster_pallas), float32 within 1e-5 and PCM16 within
    one LSB of the plain version: one launch each, no other Wiener launch."""
    w, y, re, im = _wiener_inputs(rng, S, length, nfft, hop, cuda)
    y = y.to(ydt)
    route = "wiener_istft_cluster" + ("_dit" if nfft & (nfft - 1) == 0 else "_mixed")
    assert _wiener_kernel(nfft, hop, S, re.shape[-2]) == route
    for fn, name in ((wiener_istft, route), (wiener_bluestein_cluster_pallas,
                                             "wiener_istft_cluster")):
        for out in ("float32", "int16"):
            before = dict(kernels.LAUNCHES)
            got = fn(y, re, im, w, hop, length, output_dtype=out, **kw)
            torch.cuda.synchronize()
            assert {k: kernels.LAUNCHES[k] - before[k] for k in WIENER_NAMES} == {
                k: int(k == name) for k in WIENER_NAMES}
            _close(got, wiener_istft_plain(y, re, im, w, hop, length, output_dtype=out, **kw),
                   out)


@pytest.mark.parametrize("nfft,hop,length,S,kw,ydt,kernel", [
    (768, 256, 30000, 4, {}, torch.bfloat16, "wiener_istft_split"),  # 3 · 256
    (1280, 320, 30000, 3, {"p": 2.0, "conserve_last": True}, torch.float32,
     "wiener_istft_split"),                                            # 5 · 256, S odd
    (7680, 1920, 40000, 2, {"p": 2.0}, torch.bfloat16, "wiener_istft_split"),  # 15 · 512
    (240, 60, 6000, 5, {"conserve_last": True}, torch.float32, "wiener_istft_split"),  # 15 · 16
    (1000, 250, 30000, 4, {}, torch.bfloat16, "wiener_istft_bluestein"),  # M 2048
    (18, 9, 2000, 3, {"p": 2.0}, torch.float32, "wiener_istft_bluestein"),  # M 64: 8 groups
    (2000, 500, 30000, 4, {"conserve_last": True}, torch.float32, "wiener_istft_bluestein"),
    (6000, 1500, 40000, 4, {"p": 2.0, "conserve_last": True}, torch.bfloat16,
     "wiener_istft_bluestein"),                                        # the level
    (8190, 910, 40000, 3, {"p": 2.0}, torch.bfloat16, "wiener_istft_bluestein"),  # frame pairs
    (8190, 4095, 40000, 4, {}, torch.float32, "wiener_istft_bluestein"),  # the level, k 2
])
def test_wiener_istft_split_and_bluestein_kernels(rng, cuda, nfft, hop, length, S, kw, ydt,
                                                  kernel):
    """The Wiener+iSTFT at even sizes up to 8192 that are not powers of two:
    the split (m · 2^a) and Bluestein run backwards (on the core, on the
    level, and with frame pairs on the level where two carries do not fit),
    float32 within 1e-5 and PCM16 within one LSB of the plain version, one
    launch of the kernel each and no other Wiener launch."""
    w, y, re, im = _wiener_inputs(rng, S, length, nfft, hop, cuda)
    y = y.to(ydt)
    assert _wiener_kernel(nfft, hop, S, re.shape[-2]) == kernel
    for out in ("float32", "int16"):
        before = dict(kernels.LAUNCHES)
        got = wiener_istft(y, re, im, w, hop, length, output_dtype=out, **kw)
        torch.cuda.synchronize()
        assert {k: kernels.LAUNCHES[k] - before[k] for k in WIENER_NAMES} == {
            k: int(k == kernel) for k in WIENER_NAMES}
        _close(got, wiener_istft_plain(y, re, im, w, hop, length, output_dtype=out, **kw), out)


@pytest.mark.parametrize("nfft,hop", [(768, 256), (1000, 250), (8190, 910)])
def test_wiener_split_and_bluestein_ny_input(rng, cuda, nfft, hop):
    """The split's and Bluestein's Nyquist-row input (the bodies cut from the
    full spectrum): bit for bit the same kernel fed the concatenated
    spectrum, within 1e-5 of the plain version, counted under its _ny name."""
    S, length = 4, 30000
    w = sinebell(nfft)
    x = torch.from_numpy((0.3 * rng.standard_normal((2, length))).astype(np.float32)).to(cuda)
    fr, fi = stft_matmul(x, w, hop)
    re, im, ny = fr[..., :-1].contiguous(), fi[..., :-1].contiguous(), fr[..., -1].contiguous()
    y = np.abs(rng.standard_normal((2, S, re.shape[1], nfft // 2 + 1))).astype(np.float32)
    y[..., : re.shape[1] // 3, :8] = 0.0
    y = torch.from_numpy(y).to(cuda).to(torch.bfloat16)
    name = _wiener_kernel(nfft, hop, S, re.shape[1], has_ny=True)
    before = kernels.LAUNCHES[name]
    got = wiener_istft(y, re, im, w, hop, length, ny=ny, p=2.0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.equal(got, wiener_istft(y, fr, fi, w, hop, length, p=2.0))
    _close(got, wiener_istft_plain(y, re, im, w, hop, length, ny=ny, p=2.0), "float32")


@pytest.mark.parametrize("nfft,hop", [(768, 256), (1000, 250)])
def test_wiener_direct_pallas_forces_the_direct_sum(rng, cuda, nfft, hop):
    """wiener_direct_pallas runs the direct sum per sample that the split and
    Bluestein replaced (counted wiener_istft_direct, no other Wiener launch),
    within 1e-5 of the plain version, PCM16 within one LSB; it refuses a
    power of two."""
    w, y, re, im = _wiener_inputs(rng, 3, 9000, nfft, hop, cuda)
    for out in ("float32", "int16"):
        before = dict(kernels.LAUNCHES)
        got = wiener_direct_pallas(y, re, im, w, hop, 9000, output_dtype=out, p=2.0)
        torch.cuda.synchronize()
        assert {k: kernels.LAUNCHES[k] - before[k] for k in WIENER_NAMES} == {
            k: int(k == "wiener_istft_direct") for k in WIENER_NAMES}
        _close(got, wiener_istft_plain(y, re, im, w, hop, 9000, output_dtype=out, p=2.0), out)
    w, y, re, im = _wiener_inputs(rng, 2, 6000, 256, 64, cuda)
    with pytest.raises(ValueError, match="direct sum"):
        wiener_direct_pallas(y, re, im, w, 64, 6000)


@pytest.mark.parametrize("nfft,hop", [(16384, 2048), (32768, 4096)])
def test_wiener_istft_cluster_ny_input(rng, cuda, nfft, hop):
    """The direct cluster kernel's Nyquist-row input (the forward STFT
    kernel's pair at 16 384; the bodies cut from the full spectrum at 32
    768): bit for bit the same kernel fed the concatenated spectrum, within
    1e-5 of the plain version, counted as "wiener_istft_ny_cluster_dit";
    Bluestein's cluster forced the same, counted "wiener_istft_ny_cluster"."""
    S, length = 4, 70000
    w = sinebell(nfft)
    x = torch.from_numpy((0.3 * rng.standard_normal((2, length))).astype(np.float32)).to(cuda)
    if nfft == 16384:
        re, im, ny = stft_ct_pallas(x, w, hop)
    else:
        fr, fi = stft_matmul(x, w, hop)
        re, im, ny = fr[..., :-1].contiguous(), fi[..., :-1].contiguous(), fr[..., -1].contiguous()
    y = np.abs(rng.standard_normal((2, S, re.shape[1], nfft // 2 + 1))).astype(np.float32)
    y[..., : re.shape[1] // 3, :8] = 0.0
    y = torch.from_numpy(y).to(cuda).to(torch.bfloat16)
    full_re = torch.cat([re, ny[..., None]], -1)
    full_im = torch.cat([im, torch.zeros_like(ny)[..., None]], -1)
    for fn, name in ((wiener_istft, "wiener_istft_ny_cluster_dit"),
                     (wiener_bluestein_cluster_pallas, "wiener_istft_ny_cluster")):
        before = kernels.LAUNCHES[name]
        got = fn(y, re, im, w, hop, length, ny=ny, p=2.0)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        assert torch.equal(got, fn(y, full_re, full_im, w, hop, length, p=2.0))
        _close(got, wiener_istft_plain(y, re, im, w, hop, length, ny=ny, p=2.0), "float32")


@pytest.mark.parametrize("nfft,hop,length,S,kw,ydt", [
    (8640, 2160, 40000, 4, {}, torch.bfloat16),              # the smallest: C 2 of n 4320
    (11250, 2250, 40000, 3, {"p": 2.0, "conserve_last": True}, torch.float32),  # n 5625, odd
    (13122, 6561, 50000, 2, {"conserve_last": True}, torch.bfloat16),  # n 6561 = 3^8, k 2
    (24300, 2025, 60000, 4, {"p": 2.0}, torch.float32),     # C 4 of n 6075, odd; k 12
    (32400, 8100, 90000, 5, {}, torch.bfloat16),            # the largest: C 4 of n 8100, S odd
    (14000, 3500, 40000, 4, {}, torch.bfloat16),            # C 2 of n 7000: a radix-7 pass
    (28000, 7000, 80000, 3, {"p": 2.0}, torch.float32),     # C 4 of n 7000, S odd
    (8750, 1750, 40000, 4, {"conserve_last": True}, torch.bfloat16),  # n 4375 = 5^4·7, odd
    (22050, 4410, 60000, 4, {}, torch.bfloat16),            # C 3 of n 7350
    (30870, 6174, 60000, 3, {"p": 2.0}, torch.float32),     # C 5 of n 6174, S odd
    (30618, 10206, 60000, 4, {"conserve_last": True}, torch.bfloat16),  # C 6 of 5103, odd n
])
def test_wiener_istft_cluster_mixed_kernel_matches_plain(rng, cuda, nfft, hop, length, S, kw,
                                                         ydt):
    """The Wiener+iSTFT on the 7-smooth block core over a cluster of 2 to 6
    blocks ("wiener_istft_cluster_mixed", wiener_plan's route at
    WIENER_MIXED_WON) at sizes off the smoke's: odd n (each block ceil(N / 2
    / C) bins), C 2 to 6, k 2 to 12, radix-7 passes, float32 within 1e-5
    and PCM16 within one LSB of the plain version, one launch a call and no
    other Wiener launch; the same kernel forced (wiener_cluster_mixed_pallas)
    bit for bit; Bluestein's cluster forced at the same shape within 1e-5 of
    it; the Nyquist-row input bit for bit the concatenated spectrum's."""
    w, y, re, im = _wiener_inputs(rng, S, length, nfft, hop, cuda)
    y = y.to(ydt)
    assert _wiener_kernel(nfft, hop, S, re.shape[-2]) == "wiener_istft_cluster_mixed"
    for out in ("float32", "int16"):
        before = dict(kernels.LAUNCHES)
        got = wiener_istft(y, re, im, w, hop, length, output_dtype=out, **kw)
        torch.cuda.synchronize()
        assert {k: kernels.LAUNCHES[k] - before[k] for k in WIENER_NAMES} == {
            k: int(k == "wiener_istft_cluster_mixed") for k in WIENER_NAMES}
        _close(got, wiener_istft_plain(y, re, im, w, hop, length, output_dtype=out, **kw), out)
    before = kernels.LAUNCHES["wiener_istft_cluster_mixed"]
    forced = wiener_cluster_mixed_pallas(y, re, im, w, hop, length, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wiener_istft_cluster_mixed"] == before + 1
    assert torch.equal(forced, wiener_istft(y, re, im, w, hop, length, **kw))
    blue = wiener_bluestein_cluster_pallas(y, re, im, w, hop, length, **kw)
    _close(wiener_istft(y, re, im, w, hop, length, **kw), blue, "float32")
    body_re, body_im, ny = re[..., :-1].contiguous(), im[..., :-1].contiguous(), re[..., -1]
    before = kernels.LAUNCHES["wiener_istft_ny_cluster_mixed"]
    got = wiener_istft(y, body_re, body_im, w, hop, length, ny=ny.contiguous(), **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wiener_istft_ny_cluster_mixed"] == before + 1
    assert torch.equal(got, wiener_istft(y, re, im, w, hop, length, **kw))


def test_wiener_cluster_plan_reads_the_card_occupancy(cuda):
    """The Wiener cluster plans weigh waves of fft_plan.CLUSTERS_AT_ONCE
    clusters: the card's own cudaOccupancyMaxActiveClusters for Bluestein's
    cluster kernel's launch at 16 384 (C 4) and 32 768 (C 8) points, for
    the direct one's at 16 384 (C 2) and 32 768 (C 4), and for the mixed
    one's at 10 000 (C 2), 20 000, 32 400 (C 4), 22 050 (C 3), 30 870 (C 5)
    and 30 618 (C 6), one block an SM (the kernels' launch bound)."""
    import ctypes

    from convsep_tpu_torch.dsp.cuda import fft_plan as fp

    lib = kernels.library()
    for nfft, hop in ((16384, 2048), (32768, 4096), (32768, 2048)):
        for plan_of, launch, tables in ((fp.wiener_cluster_plan, lib.wiener_cluster_launch, 3),
                                        (fp.wiener_cluster_dit_plan, lib.wiener_cluster_dit_launch,
                                         1)):
            plan = plan_of(1, 4, 648, nfft, hop)
            active = ctypes.c_int(0)
            kernels.check(launch(None, 0, None, None, None, None, None, *(None,) * tables, None,
                                 0, 1, 4, 648, nfft, hop, 1, plan.rounds, 0, ctypes.c_float(1e-8),
                                 0, ctypes.byref(active), None), plan.route)
            assert active.value == fp.CLUSTERS_AT_ONCE[plan.cluster], (nfft, hop, plan.route,
                                                                       active.value)
    for nfft, hop in ((10000, 2500), (20000, 5000), (32400, 2025), (22050, 4410),
                      (30870, 6174), (30618, 10206)):
        plan = fp.wiener_cluster_mixed_plan(1, 4, 648, nfft, hop)
        active = ctypes.c_int(0)
        kernels.check(lib.wiener_cluster_mixed_launch(
            None, 0, None, None, None, None, None, None, None, 0, 1, 4, 648, nfft, hop, 1,
            plan.rounds, fp.mixed_schedule(fp.mixed_radices(nfft // plan.cluster)), 0,
            ctypes.c_float(1e-8), 0, ctypes.byref(active), None), plan.route)
        assert active.value == fp.CLUSTERS_AT_ONCE[plan.cluster], (nfft, hop, active.value)


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
    launched = {**{k: 0 for k in WIENER_NAMES}, "wiener_istft": 1, "fused_decode": 1,
                "stft": 0, "stft_split": 0,
                "stft_bluestein": 0, "stft_cluster": 0, "stft_dft": 0, "fused_adadelta": 0,
                "istft": 0, "istft_split": 0, "istft_bluestein": 0, "istft_cluster": 0,
                "istft_cluster_dit": 0, "istft_cluster_mixed": 0, "istft_direct": 0,
                "wiener_apply": 0,
                "wiener_istft_ny": 0, "wiener_istft_cluster": 0, "wiener_istft_ny_cluster": 0,
                "ct_stft": 0, "ct_stft_cluster": 0, "band_decode": 0, "band_decode_stream": 0,
                "stft_level2": 0, "istft_level2": 0, "istft_level2_direct": 0,
                "ct_stft_level": 0}
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
        (768, 256, 3, 20000),     # 3 · 256: the mixed-radix split
        (1536, 384, 2, 20000),    # 3 · 512
        (1280, 320, 3, 14336),    # 5 · 256
        (3072, 768, 2, 40000),    # 3 · 1024
        (2304, 576, 2, 30000),    # 9 · 256
        (48, 16, 2, 999),         # 3 · 16: groups of 3 threads share warps
        (240, 60, 2, 5000),       # 15 · 16
        (6144, 1536, 1, 60000),   # 3 · 2048, the split's largest P
        (1000, 250, 2, 9001),     # 8 · 125: Bluestein, M 2048
        (1000, 250, 32, 14336),   # the smoke's shape
        (1001, 143, 2, 9001),     # odd
        (1792, 448, 2, 20000),    # 7 · 256: M 4096
        (1600, 400, 2, 20000),    # 25 · 64
        (432, 108, 3, 9001),      # 27 · 16
        (18, 9, 3, 999),          # M 64: groups of 4 threads share warps
        (4000, 1000, 2, 30000),   # M 8192: 512 threads a transform
        (6000, 1500, 1, 30000),   # past 4096: Bluestein on the 16 384-point level
        (6000, 1500, 32, 14336),  # the smoke's shape
        (4097, 241, 2, 9001),     # the level's smallest size
        (8190, 2730, 2, 30000),   # and its largest even one
        (8191, 8191, 1, 20000),   # odd
        (12288, 3072, 1, 30000),  # 3 · 4096, past 8192: Bluestein on a cluster of 4
    ],
)
def test_stft_kernel_matches_plain(rng, cuda, nfft, hop, B, length):
    """Powers of two launch the FFT kernel ("stft"), m · 2^a (m 3, 5, 9,
    15) the split kernel ("stft_split"), other sizes up to 8192 Bluestein
    ("stft_bluestein"; past 4096 on the level), past 8192 up to 32 768
    Bluestein on a cluster ("stft_cluster"), each exactly once and no
    other."""
    used = _stft_name(nfft)
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32)).to(cuda)
    w = sinebell(nfft)
    assert used != "stft_split" or nfft in (768, 1536, 1280, 3072, 2304, 48, 240, 6144)
    assert (used == "stft_cluster") == (nfft > 8192)
    names = STFT_NAMES
    before = dict(kernels.LAUNCHES)
    re, im = stft_pallas(x, w, hop)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in names} == {k: int(k == used)
                                                                    for k in names}
    re_p, im_p = stft_pallas_plain(x, w, hop)
    assert re.shape == re_p.shape == (B, -(-length // hop) + 2, nfft // 2 + 1)
    peak = max(re_p.abs().max().item(), im_p.abs().max().item())
    torch.testing.assert_close(re, re_p, atol=1e-5 * peak, rtol=0)
    torch.testing.assert_close(im, im_p, atol=1e-5 * peak, rtol=0)
    r1, i1 = stft_pallas(x[0], w, hop)  # unbatched
    torch.testing.assert_close(r1, re[0], atol=0, rtol=0)
    torch.testing.assert_close(i1, im[0], atol=0, rtol=0)


STFT_NAMES = ("stft", "stft_split", "stft_bluestein", "stft_cluster", "stft_level2", "stft_dft")


def _rfft_stft(x, w, hop, nfft):
    """The plain STFT in float64 (torch.fft.rfft of the same padded, windowed
    frames), rounded to float32: the reference where the direct chain's
    matrices would pass 6 GB."""
    from convsep_tpu_torch.dsp.stft import _pad_signal, frame_signal, num_frames

    win = len(w)
    nf = num_frames(x.shape[-1], hop)
    frames = frame_signal(_pad_signal(x.double(), win, hop), win, hop, nf)
    z = torch.fft.rfft(frames * torch.from_numpy(w.astype(np.float32)).double().to(x.device),
                       n=nfft)
    return z.real.float(), z.imag.float()


def _stft_name(nfft: int) -> str:
    """The STFT kernel stft_pallas takes at nfft."""
    from convsep_tpu_torch.dsp.cuda.fft_plan import (bluestein_supported, cluster_supported,
                                                     split_supported)

    return ("stft" if nfft & (nfft - 1) == 0 and nfft <= 8192 else "stft_split"
            if split_supported(nfft) else "stft_bluestein" if bluestein_supported(nfft)
            else "stft_cluster" if cluster_supported(nfft) else "stft_dft")


@pytest.mark.parametrize("nfft,win,hop,B,length", [
    (8193, 8193, 2731, 2, 30000),     # the cluster's smallest size, odd: C 4
    (10000, 10000, 2500, 2, 30000),
    (12288, 12288, 3072, 32, 14336),  # the smoke's shape
    (16384, 16384, 4096, 2, 40000),   # C 4's largest: M 32 768
    (20000, 20000, 5000, 3, 50000),   # C 8: M 65 536
    (20000, 16000, 4000, 1, 30000),   # nfft past the window
    (32768, 16384, 4096, 1, 40000),   # C 8's largest (a half window keeps the plain tables small)
    (40000, 40000, 10000, 2, 60000),  # C 16: M 131 072
    (65536, 65536, 16384, 1, 50000),  # C 16's largest
    (50001, 40000, 8000, 1, 30000),   # C 16, odd, nfft past the window
])
def test_cluster_stft_kernel_matches_plain(rng, cuda, nfft, win, hop, B, length):
    """Bluestein on a thread-block cluster (M 32 768 on 4 blocks, 65 536 on
    8, 131 072 on 16) against the plain STFT within 1e-5 × max|X|: one
    "stft_cluster" launch and no other STFT kernel. Past 32 768 points the
    plain version is the factored chain (the direct one's matrices pass 6
    GB)."""
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32)).to(cuda)
    w = sinebell(win)
    before = dict(kernels.LAUNCHES)
    re, im = stft_pallas(x, w, hop, nfft)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in STFT_NAMES} == {
        k: int(k == "stft_cluster") for k in STFT_NAMES}
    if nfft > 32768:
        re_p, im_p = _rfft_stft(x, w, hop, nfft)
    else:
        re_p, im_p = stft_pallas_plain(x, w, hop, nfft)
    assert re.shape == re_p.shape == (B, -(-length // hop) + 2, nfft // 2 + 1)
    peak = max(re_p.abs().max().item(), im_p.abs().max().item())
    torch.testing.assert_close(re, re_p, atol=1e-5 * peak, rtol=0)
    torch.testing.assert_close(im, im_p, atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("nfft,hop", [(768, 256), (1280, 320)])
def test_dense_stft_kernel_forced_at_split_sizes(rng, cuda, nfft, hop):
    """stft_dft_pallas runs the dense kernel where the wrapper would take the
    split: both held to the plain version, one launch each."""
    x = torch.from_numpy((0.3 * rng.standard_normal((2, 14336))).astype(np.float32)).to(cuda)
    w = sinebell(nfft)
    re_p, im_p = stft_pallas_plain(x, w, hop)
    peak = max(re_p.abs().max().item(), im_p.abs().max().item())
    for fn, name in ((stft_dft_pallas, "stft_dft"), (stft_pallas, "stft_split")):
        before = kernels.LAUNCHES[name]
        re, im = fn(x, w, hop)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        torch.testing.assert_close(re, re_p, atol=1e-5 * peak, rtol=0)
        torch.testing.assert_close(im, im_p, atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("nfft,hop", [(1000, 250), (1001, 143), (6000, 1500), (12288, 3072)])
def test_dense_stft_kernel_forced_at_bluestein_sizes(rng, cuda, nfft, hop):
    """stft_dft_pallas runs the dense kernel where the wrapper takes
    Bluestein, on one block or (12 288) on a cluster: both held to the plain
    version, one launch each."""
    x = torch.from_numpy((0.3 * rng.standard_normal((2, 14336))).astype(np.float32)).to(cuda)
    w = sinebell(nfft)
    re_p, im_p = stft_pallas_plain(x, w, hop)
    peak = max(re_p.abs().max().item(), im_p.abs().max().item())
    for fn, name in ((stft_dft_pallas, "stft_dft"), (stft_pallas, _stft_name(nfft))):
        before = kernels.LAUNCHES[name]
        re, im = fn(x, w, hop)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        torch.testing.assert_close(re, re_p, atol=1e-5 * peak, rtol=0)
        torch.testing.assert_close(im, im_p, atol=1e-5 * peak, rtol=0)


def test_stft_bluestein_nfft_past_window(rng, cuda):
    x = torch.from_numpy(rng.standard_normal((3, 5000)).astype(np.float32)).to(cuda)
    w = sinebell(800)
    before = kernels.LAUNCHES["stft_bluestein"]
    re, im = stft_pallas(x, w, 200, nfft=1000)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stft_bluestein"] == before + 1
    re_p, im_p = stft_pallas_plain(x, w, 200, nfft=1000)
    peak = max(re_p.abs().max().item(), im_p.abs().max().item())
    torch.testing.assert_close(re, re_p, atol=1e-5 * peak, rtol=0)
    torch.testing.assert_close(im, im_p, atol=1e-5 * peak, rtol=0)


def test_stft_split_nfft_past_window(rng, cuda):
    x = torch.from_numpy(rng.standard_normal((3, 5000)).astype(np.float32)).to(cuda)
    w = sinebell(640)
    before = kernels.LAUNCHES["stft_split"]
    re, im = stft_pallas(x, w, 160, nfft=768)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stft_split"] == before + 1
    re_p, im_p = stft_pallas_plain(x, w, 160, nfft=768)
    peak = max(re_p.abs().max().item(), im_p.abs().max().item())
    torch.testing.assert_close(re, re_p, atol=1e-5 * peak, rtol=0)
    torch.testing.assert_close(im, im_p, atol=1e-5 * peak, rtol=0)


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
     ((3,), 384, 384, 96, 6000), ((2,), 1000, 1000, 250, 9000), ((1,), 4096, 4096, 1024, 40000),
     ((4,), 768, 768, 256, 30000), ((2,), 768, 640, 160, 9000), ((2,), 1000, 800, 200, 9000),
     ((2,), 6000, 6000, 1500, 40000), ((1,), 10000, 10000, 2500, 30000)],
)
def test_istft_pallas_kernel_matches_plain(rng, cuda, lead, nfft, win, hop, length):
    """The FFT kernel at powers of two counts as "istft", the split's sizes
    (384 = 3 · 128, 768) as "istft_split", Bluestein (1000; 6000 on the
    level) as "istft_bluestein", and past 8192 (10 000) the cluster that
    fft_plan.istft_plan takes: the mixed one, "istft_cluster_mixed", where
    ISTFT_MIXED_WON holds the size, else Bluestein's, "istft_cluster"."""
    name = _istft_name(nfft)
    w, re, im = _spectra(rng, lead, length, nfft, hop, cuda, win)
    before = {k: kernels.LAUNCHES[k] for k in ISTFT_NAMES}
    got = istft_pallas(re, im, w, hop, length, nfft=nfft)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == name) for k in before}
    _close(got, istft_pallas_plain(re, im, w, hop, length, nfft=nfft), "float32")


ISTFT_NAMES = ("istft", "istft_split", "istft_bluestein", "istft_cluster", "istft_cluster_dit",
               "istft_cluster_mixed", "istft_level2", "istft_level2_direct", "istft_direct")
# × max|out|: the cluster kernels against the float64 synthesis (chip_smoke.py's)
TOL_CLUSTER_F32 = 2e-6


def _istft_name(nfft: int) -> str:
    """The iSTFT kernel launch_istft takes at nfft."""
    from convsep_tpu_torch.dsp.cuda.fft_plan import (ISTFT_LEVEL2_DIRECT_WON, ISTFT_MIXED_WON,
                                                     bluestein_supported, cluster_supported,
                                                     split_supported)

    pow2 = nfft & (nfft - 1) == 0
    return ("istft" if pow2 and nfft <= 8192 else "istft_split"
            if split_supported(nfft) else "istft_bluestein" if bluestein_supported(nfft)
            else ("istft_cluster_dit" if pow2 else "istft_cluster_mixed"
                  if nfft in ISTFT_MIXED_WON else "istft_cluster") if cluster_supported(nfft)
            else ("istft_level2_direct" if nfft in ISTFT_LEVEL2_DIRECT_WON else "istft_level2")
            if 65536 < nfft <= 262144 else "istft_direct")


@pytest.mark.parametrize("nfft,win,hop,lead,length", [
    (8194, 8194, 4097, (2,), 40000),    # the cluster's smallest even size: C 4
    (10000, 10000, 2500, (1,), 60000),  # the smoke's W and hop, a part of the track
    (12288, 12288, 3072, (2,), 50000),
    (16384, 16384, 2048, (1,), 60000),  # C 4's largest, k 8
    (20000, 20000, 5000, (3,), 80000),  # C 8
    (20000, 16000, 4000, (1,), 50000),  # nfft past the window
    (32768, 16384, 4096, (1,), 60000),  # C 8's largest (a half window keeps the plain tables small)
    (40000, 40000, 10000, (1,), 150000),  # C 16: M 131 072
    (65536, 65536, 16384, (2,), 120000),  # C 16's largest
    (40002, 30000, 7500, (1,), 80000),   # C 16, nfft past the window
])
@pytest.mark.parametrize("out", ["float32", "int16"])
def test_cluster_istft_kernel_matches_plain(rng, cuda, nfft, win, hop, lead, length, out):
    """The cluster run backwards past 8192, float32 within 1e-5 and PCM16
    within one LSB of the plain synthesis: one launch of its kernel and no
    other iSTFT kernel, "istft_cluster" (Bluestein's) off the powers of two
    and the won 5-smooth sizes, "istft_cluster_dit" (the direct transform)
    at 16 384, 32 768 and 65 536, and "istft_cluster_mixed" (the same on the
    5-smooth block core) at fft_plan.ISTFT_MIXED_WON. Past 32 768 points
    the plain synthesis is the factored chain (the direct one's matrices
    pass 6 GB)."""
    w, re, im = _spectra(rng, lead, length, nfft, hop, cuda, win)
    before = dict(kernels.LAUNCHES)
    got = launch_istft(re, im, w, hop, length, nfft, out)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in ISTFT_NAMES} == {
        k: int(k == _istft_name(nfft)) for k in ISTFT_NAMES}
    _close(got, istft_matmul(re, im, w, hop, length, nfft=nfft,
                             algorithm="factored" if nfft > 32768 else "direct",
                             output_dtype=out), out)


@pytest.mark.parametrize("nfft,hop", [(1000, 250), (1792, 448), (4000, 1000), (6000, 1500),
                                      (18, 9), (8190, 910)])
@pytest.mark.parametrize("out", ["float32", "int16"])
def test_istft_bluestein_kernel_matches_plain(rng, cuda, nfft, hop, out):
    """Bluestein run backwards (M 2048, 4096, 8192, the level's 16 384 at
    6000 and at 8190 with hop nfft / 9, M 64 at 18) at win = nfft, float32
    within 1e-5 and PCM16 within one LSB of the plain synthesis, one
    "istft_bluestein" launch and no other iSTFT kernel."""
    length = 23 * hop + 7
    w, re, im = _spectra(rng, (3,), length, nfft, hop, cuda)
    before = dict(kernels.LAUNCHES)
    got = launch_istft(re, im, w, hop, length, nfft, out)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in ISTFT_NAMES} == {
        k: int(k == "istft_bluestein") for k in ISTFT_NAMES}
    _close(got, istft_matmul(re, im, w, hop, length, nfft=nfft, algorithm="direct",
                             output_dtype=out), out)


@pytest.mark.parametrize("nfft,win,hop", [(10000, 10000, 2500), (20000, 20000, 5000),
                                          (16384, 16384, 2048), (32768, 16384, 4096),
                                          (40000, 40000, 10000), (65536, 65536, 16384)])
def test_cluster_plan_reads_the_card_occupancy(cuda, nfft, win, hop):
    """istft_cluster_plan weighs waves of fft_plan.CLUSTERS_AT_ONCE clusters:
    the card's own cudaOccupancyMaxActiveClusters for the kernel's launch
    (on an H100 SXM 30 clusters of 4, 15 of 8 and CLUSTERS_AT_ONCE[16] of
    16)."""
    import ctypes

    from convsep_tpu_torch.dsp.cuda import fft_plan as fp

    active = ctypes.c_int(0)
    kernels.check(kernels.library().istft_cluster_occupancy(nfft, win, hop, 0,
                                                            ctypes.byref(active)),
                  "istft_cluster_occupancy")
    assert active.value == fp.CLUSTERS_AT_ONCE[fp.cluster_blocks(nfft)]


@pytest.mark.parametrize("nfft,win,hop", [(16384, 16384, 2048), (32768, 32768, 4096),
                                          (32768, 16384, 4096), (65536, 65536, 16384)])
def test_cluster_dit_plan_reads_the_card_occupancy(cuda, nfft, win, hop):
    """istft_cluster_dit_plan weighs waves of fft_plan.CLUSTERS_AT_ONCE
    clusters of nfft / 8192 blocks: the card's own
    cudaOccupancyMaxActiveClusters for istft_cluster_dit_kernel's launch (on
    an H100 SXM 66 clusters of 2, 30 of 4 and 15 of 8)."""
    import ctypes

    from convsep_tpu_torch.dsp.cuda import fft_plan as fp

    active = ctypes.c_int(0)
    kernels.check(kernels.library().istft_cluster_occupancy(nfft, win, hop, 1,
                                                            ctypes.byref(active)),
                  "istft_cluster_occupancy")
    plan = fp.istft_plan(1, 100, nfft, win, hop)
    assert plan.route == "cluster_dit" and plan.cluster == nfft // 8192
    assert active.value == fp.CLUSTERS_AT_ONCE[plan.cluster]


@pytest.mark.parametrize("nfft,win,hop,lead,length", [
    (16384, 16384, 2048, (4,), 150000),   # the reference's 16 384 on C 2, k 8
    (16384, 16384, 4096, (1,), 60000),
    (16384, 16384, 8192, (3,), 60001),    # k 2
    (32768, 32768, 4096, (2,), 150000),   # the reference's 32 768 on C 4
    (32768, 16384, 4096, (1,), 60000),    # a half window
    (65536, 65536, 16384, (1,), 150000),  # C 8
])
@pytest.mark.parametrize("out", ["float32", "int16"])
def test_istft_cluster_dit_kernel_matches_plain(rng, cuda, nfft, win, hop, lead, length, out):
    """The direct transform by decimation in time over a cluster of nfft /
    8192 blocks at the powers of two past 8192: one "istft_cluster_dit"
    launch a call and no other iSTFT kernel; float32 within TOL_CLUSTER_F32
    × max|out| of the float64 synthesis and 1e-5 of the plain one (the
    factored chain past a 16 384-point window, whose direct matrices grow
    large), PCM16 within one LSB of both."""
    w, re, im = _spectra(rng, lead, length, nfft, hop, cuda, win)
    before = dict(kernels.LAUNCHES)
    got = launch_istft(re, im, w, hop, length, nfft, out)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in ISTFT_NAMES} == {
        k: int(k == "istft_cluster_dit") for k in ISTFT_NAMES}
    want64 = _istft64(re, im, w, hop, length, nfft, out)
    plain = istft_matmul(re, im, w, hop, length, nfft=nfft,
                         algorithm="factored" if win > 16384 else "direct", output_dtype=out)
    _close(got, plain, out)
    if out == "int16":
        _close(got, want64, out)
    else:
        assert got.shape == want64.shape == (*lead, length)
        assert (got - want64).abs().max().item() <= TOL_CLUSTER_F32 * want64.abs().max().item()


@pytest.mark.parametrize("nfft,hop", [(16384, 2048), (32768, 4096), (65536, 16384)])
def test_istft_bluestein_cluster_forced_at_powers_of_two(rng, cuda, nfft, hop):
    """istft_bluestein_cluster_pallas still launches Bluestein's cluster
    ("istft_cluster") at the powers of two, where istft_pallas takes the
    direct transform ("istft_cluster_dit"): one launch each, the two within
    TOL_CLUSTER_F32 × max|out| of each other, and PCM16 through
    launch_istft(bluestein_cluster=True) within one LSB of the new kernel's."""
    length = 12 * nfft
    w, re, im = _spectra(rng, (1,), length, nfft, hop, cuda)
    outs = {}
    for fn, name in ((istft_bluestein_cluster_pallas, "istft_cluster"),
                     (istft_pallas, "istft_cluster_dit")):
        before = dict(kernels.LAUNCHES)
        outs[name] = fn(re, im, w, hop, length)
        torch.cuda.synchronize()
        assert {k: kernels.LAUNCHES[k] - before[k] for k in ISTFT_NAMES} == {
            k: int(k == name) for k in ISTFT_NAMES}
    a, b = outs["istft_cluster"], outs["istft_cluster_dit"]
    assert (a - b).abs().max().item() <= TOL_CLUSTER_F32 * b.abs().max().item()
    _close(launch_istft(re, im, w, hop, length, nfft, "int16", bluestein_cluster=True),
           launch_istft(re, im, w, hop, length, nfft, "int16"), "int16")


@pytest.mark.parametrize("nfft,win,hop", [(10000, 10000, 2500), (12000, 12000, 3000),
                                          (20000, 20000, 5000), (40000, 40000, 10000),
                                          (60000, 60000, 15000), (11250, 11250, 2250),
                                          (14000, 14000, 3500), (56000, 56000, 14000),
                                          (11025, 11025, 2205), (22050, 22050, 4410),
                                          (30870, 30870, 6174), (44100, 44100, 11025),
                                          (16807, 16807, 2401)])
def test_cluster_mixed_plan_reads_the_card_occupancy(cuda, nfft, win, hop):
    """istft_cluster_mixed_plan weighs waves of fft_plan.CLUSTERS_AT_ONCE
    clusters of C blocks: the card's own cudaOccupancyMaxActiveClusters for
    istft_cluster_mixed_kernel's launch (route 2; on an H100 SXM 66
    clusters of 2, 30 of 4 and 15 of 8, as the other cluster kernels, and
    39 of 3, 22 of 5, 17 of 6 and 15 of 7)."""
    import ctypes

    from convsep_tpu_torch.dsp.cuda import fft_plan as fp

    active = ctypes.c_int(0)
    kernels.check(kernels.library().istft_cluster_occupancy(nfft, win, hop, 2,
                                                            ctypes.byref(active)),
                  "istft_cluster_occupancy")
    plan = fp.istft_cluster_mixed_plan(1, 100, nfft, win, hop)
    assert plan.route == "cluster_mixed" and plan.cluster == fp.mixed_factors(nfft)[0]
    assert active.value == fp.CLUSTERS_AT_ONCE[plan.cluster]


@pytest.mark.parametrize("nfft,win,hop,lead,length", [
    (10000, 10000, 2500, (1,), 60000),   # C 2 of n 5000, the smoke's W and hop
    (12000, 12000, 3000, (2,), 50000),   # C 2 of n 6000 = 16·5·5·5·3
    (20000, 20000, 5000, (3,), 80000),   # C 4 of n 5000
    (20000, 16000, 4000, (1,), 50000),   # nfft past the window
    (40000, 40000, 10000, (1,), 150000),  # C 8 of n 5000
    (60000, 60000, 15000, (1,), 120000),  # C 8 of n 7500 = 4·5·5·5·5·3
    (11250, 11250, 2250, (2,), 40000),   # C 2 of the odd n 5625 = 5·5·5·5·9
    (14000, 14000, 3500, (1,), 60000),   # C 2 of n 7000 = 8·5·5·5·7: a radix-7 pass
    (28000, 28000, 7000, (2,), 80000),   # C 4 of n 7000
    (56000, 56000, 14000, (1,), 150000),  # C 8 of n 7000
    (8750, 8750, 1750, (1,), 40000),     # C 2 of the odd n 4375 = 5·5·5·5·7
    (16128, 16128, 4032, (1,), 50000),   # C 2 of n 8064 = 16·8·7·9: three radix-7 butterflies
    (11025, 11025, 2205, (2,), 40000),   # odd: C 3 of n 3675, no Nyquist bin
    (22050, 22050, 4410, (1,), 60000),   # C 3 of n 7350
    (30870, 30870, 6174, (1,), 80000),   # C 5 of n 6174
    (44100, 44100, 11025, (1,), 120000),  # C 6 of n 7350
    (16807, 16807, 2401, (1,), 50000),   # odd: C 7 of n 2401 = 7^4
    (33075, 22050, 4410, (1,), 60000),   # odd: C 5 of n 6615, nfft past the window
])
@pytest.mark.parametrize("out", ["float32", "int16"])
def test_istft_cluster_mixed_kernel_matches_plain(rng, cuda, nfft, win, hop, lead, length, out):
    """The direct transform on the 7-smooth block core over a cluster of 2
    to 8 blocks, odd sizes too, forced (launch_istft(cluster_mixed=True)) so that it runs
    whatever ISTFT_MIXED_WON holds: one "istft_cluster_mixed" launch a call
    and no other iSTFT kernel; float32 within TOL_CLUSTER_F32 × max|out| of
    the float64 synthesis and 1e-5 of the plain one (the factored chain past
    a 16 384-point window where it factors, whose direct matrices grow
    large; the direct one at 28 000, which it does not factor), PCM16 within
    one LSB of both."""
    w, re, im = _spectra(rng, lead, length, nfft, hop, cuda, win)
    before = dict(kernels.LAUNCHES)
    got = launch_istft(re, im, w, hop, length, nfft, out, cluster_mixed=True)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in ISTFT_NAMES} == {
        k: int(k == "istft_cluster_mixed") for k in ISTFT_NAMES}
    want64 = _istft64(re, im, w, hop, length, nfft, out)
    plain = istft_matmul(re, im, w, hop, length, nfft=nfft,
                         algorithm="factored" if win > 16384 and _ct_supported(nfft)
                         else "direct", output_dtype=out)
    _close(got, plain, out)
    if out == "int16":
        _close(got, want64, out)
    else:
        assert got.shape == want64.shape == (*lead, length)
        assert (got - want64).abs().max().item() <= TOL_CLUSTER_F32 * want64.abs().max().item()


@pytest.mark.parametrize("nfft,hop", [(10000, 2500), (12000, 3000), (20000, 5000),
                                      (40000, 10000), (60000, 15000), (14000, 3500),
                                      (56000, 14000)])
def test_istft_bluestein_cluster_forced_at_mixed_sizes(rng, cuda, nfft, hop):
    """Bluestein's cluster forced (istft_bluestein_cluster_pallas, counted
    "istft_cluster") and the mixed cluster forced at the same 7-smooth size:
    one launch each, the two within TOL_CLUSTER_F32 × max|out| of each
    other, PCM16 within one LSB; istft_pallas launches the mixed one
    exactly where ISTFT_MIXED_WON holds the size."""
    from convsep_tpu_torch.dsp.cuda.fft_plan import ISTFT_MIXED_WON

    length = 12 * nfft
    w, re, im = _spectra(rng, (1,), length, nfft, hop, cuda)
    outs = {}
    for name, fn in (("istft_cluster", lambda: istft_bluestein_cluster_pallas(re, im, w, hop,
                                                                               length)),
                     ("istft_cluster_mixed", lambda: launch_istft(re, im, w, hop, length, nfft,
                                                                  cluster_mixed=True))):
        before = dict(kernels.LAUNCHES)
        outs[name] = fn()
        torch.cuda.synchronize()
        assert {k: kernels.LAUNCHES[k] - before[k] for k in ISTFT_NAMES} == {
            k: int(k == name) for k in ISTFT_NAMES}
    a, b = outs["istft_cluster"], outs["istft_cluster_mixed"]
    assert (a - b).abs().max().item() <= TOL_CLUSTER_F32 * b.abs().max().item()
    _close(launch_istft(re, im, w, hop, length, nfft, "int16", bluestein_cluster=True),
           launch_istft(re, im, w, hop, length, nfft, "int16", cluster_mixed=True), "int16")
    before = dict(kernels.LAUNCHES)
    istft_pallas(re, im, w, hop, length)
    torch.cuda.synchronize()
    routed = "istft_cluster_mixed" if nfft in ISTFT_MIXED_WON else "istft_cluster"
    assert {k: kernels.LAUNCHES[k] - before[k] for k in ISTFT_NAMES} == {
        k: int(k == routed) for k in ISTFT_NAMES}


@pytest.mark.parametrize("nfft,hop", [(1000, 250), (768, 256), (6000, 1500), (10000, 2500)])
def test_istft_direct_sum_forced(rng, cuda, nfft, hop):
    """istft_direct_pallas runs the direct sum where the wrapper takes
    Bluestein (on a cluster at 10 000) or the split; launch_istft(direct=True)
    its PCM16: both held
    to the plain version, one "istft_direct" launch each, and the wrapper's
    own kernel beside it."""
    length = 19 * hop + 3
    w, re, im = _spectra(rng, (2,), length, nfft, hop, cuda)
    for fn, name in ((istft_direct_pallas, "istft_direct"), (istft_pallas, _istft_name(nfft))):
        before = dict(kernels.LAUNCHES)
        got = fn(re, im, w, hop, length)
        torch.cuda.synchronize()
        assert {k: kernels.LAUNCHES[k] - before[k] for k in ISTFT_NAMES} == {
            k: int(k == name) for k in ISTFT_NAMES}
        _close(got, istft_pallas_plain(re, im, w, hop, length), "float32")
    got = launch_istft(re, im, w, hop, length, nfft, "int16", direct=True)
    _close(got, istft_matmul(re, im, w, hop, length, nfft=nfft, algorithm="direct",
                             output_dtype="int16"), "int16")
    with pytest.raises(RuntimeError, match="istft_direct"):  # no direct sum at a power of two
        istft_direct_pallas(*_spectra(rng, (1,), 3000, 256, 64, cuda)[1:], sinebell(256), 64,
                            3000)


def test_kernel_routes_count_bluestein_not_dense(rng, cuda):
    """The launch counts: the STFT at W 6000 launches "stft_bluestein" and
    the iSTFT at W 1000 "istft_bluestein", with no "stft_dft" or
    "istft_direct" unless forced."""
    x = torch.from_numpy((0.3 * rng.standard_normal((2, 14336))).astype(np.float32)).to(cuda)
    kernels.reset_launches()
    stft_pallas(x, sinebell(6000), 1500)
    w, re, im = _spectra(rng, (2,), 9000, 1000, 250, cuda)
    istft_pallas(re, im, w, 250, 9000)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stft_bluestein"] == 1 and kernels.LAUNCHES["istft_bluestein"] == 1
    assert kernels.LAUNCHES["stft_dft"] == 0 and kernels.LAUNCHES["istft_direct"] == 0
    stft_dft_pallas(x, sinebell(6000), 1500)
    istft_direct_pallas(re, im, w, 250, 9000)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stft_dft"] == 1 and kernels.LAUNCHES["istft_direct"] == 1
    assert kernels.LAUNCHES["stft_bluestein"] == 1 and kernels.LAUNCHES["istft_bluestein"] == 1


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


@pytest.mark.parametrize("hop,B,length", [(4096, 1, 1_474_560), (2048, 2, 60_001),
                                          (1024, 1, 1), (16384, 3, 100_000)])
def test_ct_stft_cluster_kernel_matches_plain(rng, cuda, hop, B, length):
    """The fused forward STFT at the reference's 16 384 points through the
    cluster kernel, forced (Bluestein on a cluster of 4 blocks; the route
    takes the level), within 1e-5 × max|X| of the plain version, the
    Nyquist row apart: one "ct_stft_cluster" launch, no "ct_stft" and no
    "ct_stft_level"."""
    nfft = 16384
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32)).to(cuda)
    w = sinebell(nfft)
    before = dict(kernels.LAUNCHES)
    got = stft_ct_cluster_pallas(x, w, hop)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ct_stft_cluster"] == before["ct_stft_cluster"] + 1
    assert kernels.LAUNCHES["ct_stft"] == before["ct_stft"]
    assert kernels.LAUNCHES["ct_stft_level"] == before["ct_stft_level"]
    want = stft_ct_pallas_plain(x, w, hop)
    nf = -(-length // hop) + 2
    assert got[0].shape == (B, nf, nfft // 2) and got[2].shape == (B, nf)
    peak = max(a.abs().max().item() for a in want)
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, atol=1e-5 * peak, rtol=0)


def test_ct_stft_kernel_refuses(cuda):
    """Outside the reference's shapes the wrapper refuses; at its largest,
    16 384 points, the level kernel serves."""
    x = torch.zeros(2, 5000, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        stft_ct_pallas(x, sinebell(4096), 512)
    with pytest.raises(ValueError, match="unsupported"):
        stft_ct_pallas(torch.zeros(2, 50000, device=cuda), sinebell(32768), 1024)
    re, im, ny = stft_ct_pallas(torch.zeros(2, 50000, device=cuda), sinebell(16384), 1024)
    torch.cuda.synchronize()
    assert re.shape == (2, 51, 8192) and ny.shape == (2, 51)


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
    # depth 16 x 1000: not even one depth's z tile and one tap fit shared
    # memory, so the forced pieces refuse it (the streamed kernel takes it:
    # test_band_stream_takes_any_band)
    band = band_tensor(torch.zeros(15, 1, 50, 1000, device=cuda), 30)
    with pytest.raises(ValueError, match="shared memory"):
        band_decode_pieces_pallas(torch.zeros(2, 3, 16000, device=cuda), band, 30)
    op = band_operand(torch.zeros(15, 1, 50, 1000, device=cuda), 30)
    with pytest.raises(ValueError, match="stream-packed taps"):
        band_decode_wmajor(torch.zeros(2, 3, 16000, device=cuda),
                           BandOperand(op.band, op.packed, op.stream[:-8]), 30)
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


# the band decode's shapes past one block's shared memory over the model
# family's widths (tests/test_torch_envelopes.py's BAND_SWEEP, 1896 of its
# 4900): time context T, kh taps (Tp = T − kh + 1), C2 in and I out channels
BAND_SWEEP = [(T - kh + 1, c2, kh, i) for T in (10, 20, 30, 40) for kh in range(1, T + 1)
              for c2 in (8, 16, 32, 50, 64, 100, 128) for i in (8, 16, 32, 50, 64, 100, 128)]


def test_band_stream_matches_plain_over_the_sweep(cuda):
    """Every band of the sweep past one block's shared memory, at M 130 (a
    full 128-row tile and a ragged one): band_decode_wmajor launches the
    streamed kernel once (and band_decode.cu never) on the operand the
    model builds once, within 1e-5 × max|out| of the plain version."""
    past = [s for s in BAND_SWEEP if streams(*s) and (s not in BAND_STREAM_WON)]
    assert len(past) == 1896
    gen = torch.Generator(device=cuda).manual_seed(0)
    bad = []
    for tp, c2, kh, i in past:
        T = tp + kh - 1
        z = torch.relu(torch.randn(1, 130, tp * c2, generator=gen, device=cuda)).to(torch.bfloat16)
        op = band_operand(0.1 * torch.randn(kh, 1, i, c2, generator=gen, device=cuda), T)
        before = dict(kernels.LAUNCHES)
        got = band_decode_wmajor(z, op, T)
        want = band_decode_wmajor_plain(z, op)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if (kernels.LAUNCHES["band_decode_stream"] != before["band_decode_stream"] + 1
                or kernels.LAUNCHES["band_decode"] != before["band_decode"]
                or not err <= 1e-5 * scale):
            bad.append((tp, c2, kh, i, err / scale))
    assert not bad, bad[:10]


@pytest.mark.parametrize(
    "N,Tp,W,C2,kh,I",
    [
        (2, 16, 65, 128, 15, 64),   # BAND_PIECES_SHAPE's band: 8 pieces
        (2, 16, 65, 100, 15, 100),  # 6 pieces; 104 columns a product
        (1, 4, 70, 32, 3, 300),     # 300 columns: two chunks of 152 (fits band_decode.cu)
        (3, 15, 43, 50, 3, 50),     # Tp·C2 750: z by 4-byte copies
        (1, 3, 130, 7, 2, 5),       # Tp·C2 21: z by element loads
        (2, 16, 65, 32, 15, 100),   # fits band_decode.cu; routed by BAND_STREAM_WON
    ],
)
def test_band_stream_kernel_shapes(rng, cuda, N, Tp, W, C2, kh, I):
    """The streamed kernel forced, and routed where ``streams`` says so:
    within 1e-5 × max|out| of the plain version, one band_decode_stream
    launch a call, bit-equal from a bf16 z, a float32 z, a bare band
    (packed on the call) and a z that starts 2 bytes past a 16-byte
    boundary (element loads)."""
    T = Tp + kh - 1
    z = torch.relu(torch.from_numpy(rng.standard_normal((N, W, Tp * C2)).astype(np.float32))).to(cuda)
    k = torch.from_numpy((0.2 * rng.standard_normal((kh, 1, I, C2))).astype(np.float32)).to(cuda)
    op = band_operand(k, T)
    before = kernels.LAUNCHES["band_decode_stream"]
    got = band_decode_stream_pallas(z, op, T)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["band_decode_stream"] == before + 1
    want = band_decode_wmajor_plain(z, op)
    assert got.shape == want.shape == (N, W, T * I) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)
    zb = z.to(torch.bfloat16)
    assert torch.equal(band_decode_stream_pallas(zb, op, T), got)
    assert torch.equal(band_decode_stream_pallas(z, op.band, T), got)
    shifted = torch.empty(zb.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(zb.shape)
    shifted.copy_(zb)
    assert torch.equal(band_decode_stream_pallas(shifted, op, T), got)
    if streams(Tp, C2, kh, I):  # routed: band_decode_wmajor launches the same kernel
        assert torch.equal(band_decode_wmajor(z, op, T), got)


def test_band_decode_routes(rng, cuda):
    """band_decode_wmajor on the card: multires4096's band keeps
    band_decode.cu (one band_decode launch, no stream); a band past shared
    memory takes the streamed kernel once; band_decode_pieces_pallas forces
    the pieces there (one band_decode count a call, within 1e-5 ×
    max|out|)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    for tp, c2, kh, i, name in ((16, 50, 15, 50, "band_decode"),
                                (16, 128, 15, 64, "band_decode_stream")):
        T = tp + kh - 1
        z = torch.relu(torch.randn(2, 65, tp * c2, generator=gen, device=cuda))
        op = band_operand(0.1 * torch.randn(kh, 1, i, c2, generator=gen, device=cuda), T)
        kernels.reset_launches()
        got = band_decode_wmajor(z, op, T)
        assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {name: 1}
        want = band_decode_wmajor_plain(z, op)
        tol = 1e-5 * want.abs().max().item()
        torch.testing.assert_close(got, want, atol=tol, rtol=0)
        if name == "band_decode_stream":
            assert len(band_pieces(tp, c2, kh, i).pieces) == 8
            pieces = band_decode_pieces_pallas(z, op, T)
            assert kernels.LAUNCHES["band_decode"] == 1
            torch.testing.assert_close(pieces, want, atol=tol, rtol=0)


@pytest.mark.parametrize("W,C2,I", [(6, 1000, 50), (130, 1000, 300), (130, 512, 64)])
def test_band_stream_takes_any_band(cuda, W, C2, I):
    """Bands no piece of band_decode.cu fits (depth 16 × 1000) or deep ones
    (15 000 and 7680 depths a column block, past the 4096 where the
    kernel folds its accumulators into float32 sums: one chain drifted to
    1.4e-5 of the peak): the streamed kernel takes each in one launch,
    within 1e-5 × max|out| of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    z = torch.relu(torch.randn(1, W, 16 * C2, generator=gen, device=cuda))
    op = band_operand(0.05 * torch.randn(15, 1, I, C2, generator=gen, device=cuda), 30)
    assert band_stream_plan(W, 16, C2, 15, I).fold
    before = kernels.LAUNCHES["band_decode_stream"]
    got = band_decode_wmajor(z, op, 30)
    assert kernels.LAUNCHES["band_decode_stream"] == before + 1
    want = band_decode_wmajor_plain(z, op)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)


def test_band_stream_plan_is_the_launchers(cuda):
    """band_stream_plan mirrors csrc/band_stream.cu's plan (band_stream_plan
    there) at the two measured shapes, a two-chunk one and a deep band that
    folds, and the card holds every cluster the plan launches at once."""
    import ctypes

    lib = kernels.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M, tp, c2, kh, i in ((98980, 16, 128, 15, 64), (98980, 16, 100, 15, 100),
                             (70, 4, 32, 3, 300), (130, 16, 1000, 15, 300)):
        info = (ctypes.c_int * 11)()
        kernels.check(lib.band_stream_plan(M, tp, c2, kh, i, info), "band_stream_plan")
        p = band_stream_plan(M, tp, c2, kh, i, sms)
        assert list(info) == [p.n, p.g, p.chunks, p.groups, p.lq, p.np, p.copies, p.smem_bytes,
                              p.row_tiles, p.items, int(p.fold)]
        active = ctypes.c_int(0)
        kernels.check(lib.band_stream_clusters(p.n, ctypes.byref(active)), "band_stream")
        assert p.grid // 2 <= active.value, (p.grid, active.value)


def test_band_stream_keeps_registers_off_the_stack(tmp_path):
    """ptxas gives every streamed-kernel instance no stack frame and no
    spills, and serializes no wgmma chain (warning C7520)."""
    import re as regex
    import subprocess

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA toolkit of a machine with a card")
    srcs = [s for s in kernels.SOURCES if s.startswith("band_stream")]
    procs = [subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas=-v", "-c",
                               str(kernels.CSRC / s), "-o", str(tmp_path / f"{s}.o")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s in srcs]
    log = "".join(p.communicate()[0] for p in procs)
    assert all(p.returncode == 0 for p in procs), log[-3000:]
    frames = regex.findall(r"Function properties for (\S*band_stream_kernel\S*)\n\s+(\d+) bytes "
                           r"stack frame, (\d+) bytes spill stores", log)
    assert len(frames) == 32, frames
    assert all(f == "0" and sp == "0" for _, f, sp in frames), frames
    assert "C7520" not in log


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


@pytest.mark.parametrize("nfft", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 384, 1000,
                                  48, 80, 240, 768, 1280, 2304, 3072, 6144, 7680, 10_000])
@pytest.mark.parametrize("out", ["float32", "int16"])
def test_istft_kernel_every_size(rng, cuda, nfft, out):
    """The iSTFT kernels at every power of two the FFT core takes, at split
    sizes of every m (3, 5, 9, 15; 384 = 3 · 128 among them), at 1000
    (Bluestein) and at 10 000 (past 8192: Bluestein on a cluster), win =
    nfft, hop = nfft / 4, float32 within 1e-5 and PCM16 within one LSB of
    the plain synthesis; each counts under its own kernel's name."""
    hop = nfft // 4
    length = 37 * hop + 5
    w, re, im = _spectra(rng, (3,), length, nfft, hop, cuda)
    name = _istft_name(nfft)
    before = kernels.LAUNCHES[name]
    got = launch_istft(re, im, w, hop, length, nfft, out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    want = istft_matmul(re, im, w, hop, length, nfft=nfft, algorithm="direct", output_dtype=out)
    _close(got, want, out)


# ptxas's stack frame (bytes) of every iSTFT FFT-kernel instance the tests
# launch, by log2 of the FFT size, as measured on an H100 build (sm_90a,
# 128 registers a thread at 512 threads a block): the preset sizes (1024,
# 4096 points) keep their register arrays off the stack; 32, 512 and 8192
# points spill a few. A larger frame is a regression.
ISTFT_STACK_CEILING = {4: 0, 5: 88, 6: 0, 7: 0, 8: 0, 9: 16, 10: 0, 11: 0, 12: 0, 13: 8}

# the same for the inverse split's instances, by (log2 P, m), and for
# Bluestein's, by log2 M, on the same build: at 128 registers the inverse
# split holds four floats of spectrum a point beside its 16 points and
# spills 0-296 bytes (768 = 3 · 256, the smoke's, 16); forward Bluestein
# none but at M 512 and on the 16 384-point level (M 2^14, 192); inverse
# Bluestein 0-120 bytes.
ISTFT_SPLIT_STACK_CEILING = {
    (4, 3): 0, (4, 5): 0, (4, 9): 0, (4, 15): 152, (5, 3): 168, (5, 5): 144, (5, 9): 192,
    (5, 15): 232, (6, 3): 152, (6, 5): 8, (6, 9): 16, (6, 15): 240, (7, 3): 184, (7, 5): 8,
    (7, 9): 24, (7, 15): 232, (8, 3): 16, (8, 5): 24, (8, 9): 32, (8, 15): 200, (9, 3): 136,
    (9, 5): 168, (9, 9): 160, (9, 15): 296, (10, 3): 144, (10, 5): 176, (11, 3): 136,
}
BLUESTEIN_STACK_CEILING = {4: 0, 5: 0, 6: 0, 7: 0, 8: 0, 9: 8, 10: 0, 11: 0, 12: 0, 13: 0,
                           14: 192}
ISTFT_BLUESTEIN_STACK_CEILING = {4: 0, 5: 0, 6: 8, 7: 0, 8: 0, 9: 104, 10: 0, 11: 0, 12: 120,
                                 13: 120, 14: 120}
# the same for Bluestein on a thread-block cluster, by kernel and blocks a
# cluster (an 8192-point part a block, 128 registers), and for the
# Wiener+iSTFT's and the iSTFT's direct transform on a cluster, at the
# powers of two and on the 7-smooth block core (120 to 128 registers, no
# stack; at 3, 5, 6 and 7 blocks the puts and loads through 32-bit
# shared::cluster addresses kept them there)
CLUSTER_STACK_CEILING = {("stft_cluster_kernel", 4): 24, ("stft_cluster_kernel", 8): 16,
                         ("stft_cluster_kernel", 16): 16, ("istft_cluster_kernel", 4): 192,
                         ("istft_cluster_kernel", 8): 192, ("istft_cluster_kernel", 16): 192,
                         ("wiener_cluster_kernel", 4): 264, ("wiener_cluster_kernel", 8): 280,
                         ("wiener_cluster_dit_kernel", 2): 0,
                         ("wiener_cluster_dit_kernel", 4): 0,
                         ("wiener_cluster_mixed_kernel", 2): 0,
                         ("wiener_cluster_mixed_kernel", 3): 0,
                         ("wiener_cluster_mixed_kernel", 4): 0,
                         ("wiener_cluster_mixed_kernel", 5): 0,
                         ("wiener_cluster_mixed_kernel", 6): 0,
                         ("istft_cluster_dit_kernel", 2): 0, ("istft_cluster_dit_kernel", 4): 0,
                         ("istft_cluster_dit_kernel", 8): 0,
                         ("istft_cluster_mixed_kernel", 2): 0,
                         ("istft_cluster_mixed_kernel", 3): 0,
                         ("istft_cluster_mixed_kernel", 4): 0,
                         ("istft_cluster_mixed_kernel", 5): 0,
                         ("istft_cluster_mixed_kernel", 6): 0,
                         ("istft_cluster_mixed_kernel", 7): 0,
                         ("istft_cluster_mixed_kernel", 8): 0}
# the same for the Wiener+iSTFT's split, by (log2 P, m), and Bluestein, by
# (log2 M, frame pairs), on an H100 build (sm_90a, 128 registers): the split holds S sources' y loads beside its 16 points and spills
# 0-64 bytes (768 = 3 · 256, the smoke's, none); Bluestein none up to M
# 4096 but at M 512, 64-80 on M 8192 and the level, 248 with frame pairs
# (two frames' masks a point).
WIENER_SPLIT_STACK_CEILING = {
    (4, 3): 56, (4, 5): 16, (4, 9): 16, (4, 15): 0, (5, 3): 40, (5, 5): 40, (5, 9): 40,
    (5, 15): 40, (6, 3): 40, (6, 5): 0, (6, 9): 0, (6, 15): 48, (7, 3): 40, (7, 5): 0, (7, 9): 0,
    (7, 15): 48, (8, 3): 0, (8, 5): 0, (8, 9): 0, (8, 15): 8, (9, 3): 24, (9, 5): 32, (9, 9): 32,
    (9, 15): 64, (10, 3): 24, (10, 5): 32, (11, 3): 16,
}
WIENER_BLUESTEIN_STACK_CEILING = {
    (6, 0): 0, (7, 0): 0, (8, 0): 0, (9, 0): 24, (10, 0): 0, (11, 0): 0, (12, 0): 0, (13, 0): 64,
    (14, 0): 80, (14, 1): 248,
}
# the fused forward STFT's cluster kernel at 16 384 points (C 4), and its
# level kernel
CT_STFT_CLUSTER_STACK_CEILING = 8
CT_STFT_LEVEL_STACK_CEILING = 0
# the second level's phases, both directions, at M 2^18 and 2^19: the
# radix-R phases keep their R points in registers (up to 255 a thread at 256
# threads); phase B/C (Fft<13> on 512 threads at 128 registers) spills
LEVEL2_STACK_CEILING = {"level2_first_kernel": 0, "level2_middle_kernel": 144,
                        "level2_last_kernel": 0, "level2_split_kernel": 0}
# the direct second level's kernels (instances at R 16 and 32, the rows one
# for both): none spills
LEVEL2_DIRECT_STACK_CEILING = {"istft_level2_direct_combine_kernel": 0,
                               "istft_level2_direct_rows_kernel": 0,
                               "istft_level2_direct_ola_kernel": 0}


# the same for the fused decode kernel's instances (MI, NI, warps, split
# Kcat buffers, K4 buffers): the presets' 16-warp double-buffered instance
# keeps its registers off the stack; the 12-warp one (96 accumulators a
# thread at 168 registers) spills a few bytes; the single-buffered ones
# (the reference rule's edges, no preset) a few more or none.
DECODE_STACK_CEILING = {"ILi3ELi4ELi16ELi2ELi2E": 0, "ILi4ELi6ELi12ELi2ELi2E": 40,
                        "ILi3ELi4ELi16ELi1ELi2E": 0, "ILi3ELi4ELi16ELi1ELi1E": 16,
                        "ILi4ELi6ELi12ELi1ELi2E": 16, "ILi4ELi6ELi12ELi1ELi1E": 8}


def test_redesigned_kernels_keep_registers_off_the_stack(tmp_path):
    """ptxas's stack frames for the redesigned kernels: each fused decode
    and iSTFT FFT-kernel, inverse-split and Bluestein (both directions)
    instance at most its recorded frame (``DECODE_STACK_CEILING``,
    ``ISTFT_STACK_CEILING``, ``ISTFT_SPLIT_STACK_CEILING``,
    ``BLUESTEIN_STACK_CEILING``, ``ISTFT_BLUESTEIN_STACK_CEILING``, the
    Wiener+iSTFT's ``WIENER_SPLIT_STACK_CEILING`` and
    ``WIENER_BLUESTEIN_STACK_CEILING``, and the cluster's
    ``CLUSTER_STACK_CEILING``), every
    Wiener+iSTFT (on the core) and band decode instance none; and no band decode instance
    has its wgmma chains serialized by ptxas (warning C7520)."""
    import re as regex
    import subprocess

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA toolkit of a machine with a card")
    frames, logs = {}, {}
    for src in ("decoder_fused.cu", "istft.cu", "wiener_istft.cu", "wiener_split.cu",
                "wiener_bluestein.cu", "band_decode.cu", "stft_dft.cu", "ct_stft.cu"):
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
    for (log2p, m), most in ISTFT_SPLIT_STACK_CEILING.items():
        hits = [v for k, v in frames.items() if f"istft_split_kernelILi{log2p}ELi{m}E" in k]
        assert len(hits) == 1 and hits[0] <= most, (log2p, m, frames)
    for kernel, ceiling in (("stft_bluestein_kernel", BLUESTEIN_STACK_CEILING),
                            ("istft_bluestein_kernel", ISTFT_BLUESTEIN_STACK_CEILING)):
        for log2m, most in ceiling.items():  # the mangled name's length prefix tells them apart
            inst = f"{len(kernel)}{kernel}ILi{log2m}E"
            hits = [v for k, v in frames.items() if inst in k]
            assert len(hits) == 1 and hits[0] <= most, (inst, frames)
    for (log2p, m), most in WIENER_SPLIT_STACK_CEILING.items():
        hits = [v for k, v in frames.items() if f"wiener_split_kernelILi{log2p}ELi{m}E" in k]
        assert len(hits) == 1 and hits[0] <= most, (log2p, m, frames)
    for (log2m, pairs), most in WIENER_BLUESTEIN_STACK_CEILING.items():
        inst = f"wiener_bluestein_kernelILi{log2m}ELb{pairs}E"
        hits = [v for k, v in frames.items() if inst in k]
        assert len(hits) == 1 and hits[0] <= most, (log2m, pairs, frames)
    for (kernel, c), most in CLUSTER_STACK_CEILING.items():
        inst = f"{len(kernel)}{kernel}ILi{c}E"
        hits = [v for k, v in frames.items() if inst in k]
        assert len(hits) == 1 and hits[0] <= most, (inst, frames)
    hits = [v for k, v in frames.items() if "22ct_stft_cluster_kernelE" in k]
    assert len(hits) == 1 and hits[0] <= CT_STFT_CLUSTER_STACK_CEILING, frames
    hits = [v for k, v in frames.items() if "20ct_stft_level_kernelE" in k]
    assert len(hits) == 1 and hits[0] <= CT_STFT_LEVEL_STACK_CEILING, frames
    for phase, most in LEVEL2_STACK_CEILING.items():
        for log2m in (18, 19):
            hits = [v for k, v in frames.items() if f"{phase}ILi{log2m}E" in k]
            assert len(hits) == (1 if phase == "level2_split_kernel" else 2), (phase, frames)
            assert max(hits) <= most, (phase, log2m, frames)
    hits = [v for k, v in frames.items() if "istft_level2_ola_kernel" in k]
    assert len(hits) == 1 and hits[0] == 0, frames
    for kernel, most in LEVEL2_DIRECT_STACK_CEILING.items():
        hits = [v for k, v in frames.items() if f"{len(kernel)}{kernel}" in k]
        assert len(hits) == (1 if "rows" in kernel else 2) and max(hits) <= most, (kernel, frames)


# (B, J, S, W_pad, TpC, ktaps, TM): the presets' three TMs, and the
# envelope's plans: 32-row tiles with one buffer of split Kcat tiles (ktaps
# 16-17), J padded to 8 (100, 127), 8-row tiles with one buffer of each (J
# 512), 32-row tiles with one of each, a 64-row tile with one of each
DECODE_PLAN_SHAPES = [
    (49, 128, 4, 512, 800, 8, 120), (49, 128, 4, 512, 800, 8, 240),
    (49, 128, 4, 512, 800, 8, 360), (65, 32, 2, 40, 100, 17, 360), (1, 32, 2, 40, 100, 2, 90),
    (49, 128, 4, 512, 800, 17, 120), (49, 128, 4, 512, 800, 16, 360),
    (49, 100, 4, 512, 800, 8, 120), (49, 127, 4, 512, 800, 10, 120),
    (64, 512, 2, 64, 100, 17, 384), (65, 256, 2, 64, 100, 17, 240), (9, 512, 2, 40, 100, 17, 384),
]


@pytest.mark.parametrize("shape", DECODE_PLAN_SHAPES)
def test_fused_decode_plan_mirrors_the_launcher(cuda, shape):
    """decode_plan (the CPU tests' mirror) is the launcher's own plan, and
    the card runs at least one of its clusters."""
    got = card_plan(*shape)
    p = decode_plan(*shape)
    assert (got["mi"], got["ni"], got["cluster"], got["bp"], got["wb"], got["rc"], got["es"],
            got["smem_bytes"]) == (p.mi, p.ni, p.cluster, p.bp, p.wb, p.rc, p.es, p.smem_bytes)
    assert (got["bt"], got["kc_bufs"], got["k4_bufs"]) == (p.bt, p.kc_bufs, p.k4_bufs)
    assert got["active_clusters"] >= 1


@pytest.mark.parametrize("shape", DECODE_PLAN_SHAPES[5:])
def test_fused_decode_envelope_plans_match_plain(rng, cuda, shape):
    """The fused decode at the envelope's plans (the reference's ktaps 17
    and TM 384, J not a multiple of 8 and up to 512; row tiles of 32 and
    8, one buffer of split Kcat tiles or of K4 rows): float32 within 1e-5
    × max|plain|, bf16 within one ulp, one launch."""
    B, J, S, W_pad, TpC, ktaps, TM = shape
    fc, ops = _decode_operands(rng, cuda, B, TM, ktaps, J=J, S=S, W_pad=W_pad, TpC=TpC)
    for dt in (torch.float32, torch.bfloat16):
        before = kernels.LAUNCHES["fused_decode"]
        got = band_freq_decode(fc, *ops, out_dtype=dt).float()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fused_decode"] == before + 1
        want = band_freq_decode_plain(fc, *ops, out_dtype=dt).float()
        tol = (1e-5 if dt == torch.float32 else 2 ** -7) * want.abs().max().item()
        assert got.shape == want.shape == (B, S, W_pad, TM)
        assert (got - want).abs().max().item() <= tol


def _istft64(re, im, w, hop, length, nfft, out="float32"):
    """istft_pallas's function in float64 (numpy's inverse real FFT of the
    float32 spectra, the window, overlap-add, the window-power
    normalization, the W/2 trim), rounded once: the reference past the
    direct chain's sizes."""
    from convsep_tpu_torch.dsp.istft import ola_norm, overlap_add
    from convsep_tpu_torch.utils.pcm import quantize_pcm16

    win, nf = len(w), int(re.shape[-2])
    w32 = np.asarray(w, np.float32)
    wd = torch.from_numpy(w32.astype(np.float64)).to(re.device)
    frames = torch.fft.irfft(torch.complex(re.double(), im.double()), n=nfft)[..., :win] * wd
    norm = torch.from_numpy(ola_norm(w32, w32, hop, nf).astype(np.float64)).to(re.device)
    y = (overlap_add(frames, hop) / norm)[..., win // 2: win // 2 + length].float()
    return quantize_pcm16(y) if out == "int16" else y


@pytest.mark.parametrize("nfft,hop,lead,length,name", [
    (1001, 143, (2,), 30000, "istft_bluestein"),   # odd: no Nyquist bin
    (999, 333, (3,), 20000, "istft_bluestein"),
    (5001, 1667, (1,), 40000, "istft_bluestein"),  # odd on the level
    (9999, 1111, (1,), 60000, "istft_cluster"),    # odd on a cluster of 4
    (39999, 13333, (1,), 150000, "istft_cluster"),  # odd on a cluster of 16
])
@pytest.mark.parametrize("out", ["float32", "int16"])
def test_odd_istft_kernel_matches_plain(rng, cuda, nfft, hop, lead, length, name, out):
    """Odd nfft, which the reference's istft_pallas takes: Bluestein (on
    the core, the level or a cluster) run backwards, every bin but DC twice,
    float32 within 1e-6 × max|y| of the float64 synthesis (and 1e-5 of the
    plain version up to 32 768 points), PCM16 within one LSB; one launch of
    its kernel, no other."""
    w, re, im = _spectra(rng, lead, length, nfft, hop, cuda)
    before = dict(kernels.LAUNCHES)
    got = launch_istft(re, im, w, hop, length, nfft, out)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in ISTFT_NAMES} == {
        k: int(k == name) for k in ISTFT_NAMES}
    want = _istft64(re, im, w, hop, length, nfft, out)
    if out == "int16":
        _close(got, want, out)
    else:
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
        if nfft <= 32768:
            _close(got, istft_pallas_plain(re, im, w, hop, length, nfft=nfft), out)


@pytest.mark.parametrize("nfft,win,hop,B,length", [
    (70_000, 70_000, 17_500, 32, 14_336),    # M 262 144: 96 frames, 48 pairs, 4 rounds
    (131_072, 131_072, 32_768, 4, 14_336),   # the largest on M 262 144
    (99_999, 99_999, 33_333, 3, 200_000),    # odd, M 262 144
    (262_144, 262_144, 65_536, 2, 300_000),  # M 524 288: R 64, the level's largest
    (100_000, 80_000, 20_000, 2, 120_000),   # nfft past the window
])
def test_level2_stft_kernel_matches_float64(rng, cuda, nfft, win, hop, B, length):
    """Bluestein on the second level (M 262 144 or 524 288 over two passes
    through a scratch in device memory) against the float64 STFT within 2e-6
    × max|X|: one "stft_level2" count, no other STFT kernel."""
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32)).to(cuda)
    w = sinebell(win)
    before = dict(kernels.LAUNCHES)
    re, im = stft_pallas(x, w, hop, nfft)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in STFT_NAMES} == {
        k: int(k == "stft_level2") for k in STFT_NAMES}
    re_p, im_p = _rfft_stft(x, w, hop, nfft)
    assert re.shape == re_p.shape == (B, -(-length // hop) + 2, nfft // 2 + 1)
    peak = max(re_p.abs().max().item(), im_p.abs().max().item())
    torch.testing.assert_close(re, re_p, atol=2e-6 * peak, rtol=0)
    torch.testing.assert_close(im, im_p, atol=2e-6 * peak, rtol=0)


@pytest.mark.parametrize("nfft,win,hop,lead,length", [
    (70_000, 70_000, 17_500, (1,), 1_323_000),  # one 30 s signal at 44.1 kHz: 78 frames
    (70_001, 70_001, 70_001, (2,), 300_000),    # odd, k 1
    (131_072, 131_072, 32_768, (1,), 400_000),
    (262_144, 262_143, 29_127, (1,), 500_000),  # M 524 288, k 9 (a window of 9 hops)
    (100_000, 80_000, 20_000, (2,), 150_000),   # nfft past the window
    (200_000, 200_000, 50_000, (1,), 1_323_000),  # R 32 on the direct level: 29 frames
])
@pytest.mark.parametrize("out", ["float32", "int16"])
def test_level2_istft_kernel_matches_float64(rng, cuda, nfft, win, hop, lead, length, out):
    """The second level run backwards (every parity) against the float64
    synthesis within 2e-6 × max|y|, PCM16 within one LSB: one count of the
    kernel ``_istft_name`` names, no other iSTFT kernel: "istft_level2"
    (Bluestein's) off ``fft_plan.ISTFT_LEVEL2_DIRECT_WON``,
    "istft_level2_direct" (the direct transform) at its sizes (70 000, 131
    072, 262 144, 100 000 and 200 000 where won)."""
    w = sinebell(win)
    nf = -(-length // hop) + 2
    re = torch.randn(*lead, nf, nfft // 2 + 1, device=cuda)
    im = torch.randn(*lead, nf, nfft // 2 + 1, device=cuda)
    before = dict(kernels.LAUNCHES)
    got = launch_istft(re, im, w, hop, length, nfft, out)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in ISTFT_NAMES} == {
        k: int(k == _istft_name(nfft)) for k in ISTFT_NAMES}
    want = _istft64(re, im, w, hop, length, nfft, out)
    if out == "int16":
        _close(got, want, out)
    else:
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 2e-6 * want.abs().max().item()


@pytest.mark.parametrize("nfft,hop", [(70_000, 17_500), (200_000, 50_000)])
def test_istft_level2_bluestein_forced_at_direct_sizes(rng, cuda, nfft, hop):
    """istft_level2_bluestein_pallas still launches Bluestein's second level
    ("istft_level2") at the direct level's sizes, and
    launch_istft(level2_direct=True) the direct one ("istft_level2_direct"),
    won or not: one launch each, each within 2e-6 × max|out| of the float64
    synthesis (chip_smoke.TOL_LEVEL2), and PCM16 through
    launch_istft(level2_bluestein=True) within one LSB of the direct
    kernel's."""
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_level2_bluestein_pallas

    length = 1_323_000  # one 30 s signal at 44.1 kHz
    w = sinebell(nfft)
    nf = -(-length // hop) + 2
    re = torch.randn(1, nf, nfft // 2 + 1, device=cuda)
    im = torch.randn(1, nf, nfft // 2 + 1, device=cuda)
    want = _istft64(re, im, w, hop, length, nfft)
    for name, fn in (("istft_level2", lambda: istft_level2_bluestein_pallas(re, im, w, hop,
                                                                             length)),
                     ("istft_level2_direct", lambda: launch_istft(re, im, w, hop, length, nfft,
                                                                  level2_direct=True))):
        before = dict(kernels.LAUNCHES)
        got = fn()
        torch.cuda.synchronize()
        assert {k: kernels.LAUNCHES[k] - before[k] for k in ISTFT_NAMES} == {
            k: int(k == name) for k in ISTFT_NAMES}
        assert (got - want).abs().max().item() <= 2e-6 * want.abs().max().item()
    _close(launch_istft(re, im, w, hop, length, nfft, "int16", level2_bluestein=True),
           launch_istft(re, im, w, hop, length, nfft, "int16", level2_direct=True), "int16")


@pytest.mark.parametrize("hop,B,length", [(4096, 1, 1_474_560), (2048, 2, 60_001),
                                          (1024, 1, 1), (16384, 3, 100_000)])
def test_ct_stft_level_kernel_matches_plain(rng, cuda, hop, B, length):
    """The fused forward STFT at 16 384 points on the level (one 16
    384-point transform a pair of frames): within 1e-6 × max|X| of the
    float64 STFT and 1e-5 of the plain version, the Nyquist row apart, and
    within 1e-6 × max|X| of the cluster kernel forced on the same input;
    one "ct_stft_level" launch, no "ct_stft_cluster"."""
    nfft = 16384
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32)).to(cuda)
    w = sinebell(nfft)
    before = dict(kernels.LAUNCHES)
    got = stft_ct_pallas(x, w, hop)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ct_stft_level"] == before["ct_stft_level"] + 1
    assert kernels.LAUNCHES["ct_stft_cluster"] == before["ct_stft_cluster"]
    r64, i64 = _rfft_stft(x, w, hop, nfft)
    want64 = (r64[..., :nfft // 2], i64[..., :nfft // 2], r64[..., nfft // 2])
    peak = max(r64.abs().max().item(), i64.abs().max().item())
    for g, p, c in zip(got, want64, stft_ct_cluster_pallas(x, w, hop)):
        torch.testing.assert_close(g, p, atol=1e-6 * peak, rtol=0)
        torch.testing.assert_close(g, c, atol=1e-6 * peak, rtol=0)
    for g, p in zip(got, stft_ct_pallas_plain(x, w, hop)):
        torch.testing.assert_close(g, p, atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize(
    "N,Tp,W,C2,kh,I",
    [
        (2, 30, 40, 128, 1, 128),   # 30 depths of 128 channels: 3 pieces of 10 depths
        (1, 1, 64, 128, 30, 100),   # 30 taps of 128 × 100: 5 pieces of at most 7 taps
        (2, 12, 20, 100, 9, 128),   # both cut
        (3, 16, 13, 64, 15, 64),    # the presets' time context at 64 channels
    ],
)
def test_band_decode_pieces_match_plain(rng, cuda, N, Tp, W, C2, kh, I):
    """A band whose taps and z tile do not fit one block's shared memory,
    forced through the pieces (band_decode_pieces_pallas; band_decode_wmajor
    streams such a band since the streamed kernel came): band_pieces cuts
    it, each piece adds its columns (band_decode_piece_launch), within 1e-5
    × max|out| of the plain version, one "band_decode" count a call."""
    from convsep_tpu_torch.models.decoder_band_cuda import band_pieces, band_plan

    T = Tp + kh - 1
    with pytest.raises(ValueError, match="shared memory"):
        band_plan(N * W, Tp, C2, kh, I)
    assert len(band_pieces(Tp, C2, kh, I).pieces) > 1
    z = torch.relu(torch.from_numpy(rng.standard_normal((N, W, Tp * C2)).astype(np.float32))).to(cuda)
    k = torch.from_numpy((0.2 * rng.standard_normal((kh, 1, I, C2))).astype(np.float32)).to(cuda)
    op = band_operand(k, T)
    before = kernels.LAUNCHES["band_decode"]
    got = band_decode_pieces_pallas(z, op, T)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["band_decode"] == before + 1
    want = band_decode_wmajor_plain(z, op)
    assert got.shape == want.shape == (N, W, T * I)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)



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


class _Batches:
    """A feature dataset's ``batches`` of seeded random host arrays."""

    def __init__(self, preset, n: int):
        self.preset, self.n = preset, n

    def batches(self, batch_size, shuffle=True, seed=0, start=0):
        m = self.preset.model
        rng = np.random.default_rng(seed)
        for _ in range(start, self.n):
            x = 0.3 * rng.random((batch_size, m.time_context, m.feat_size, 1), np.float32)
            y = 0.3 * rng.random((batch_size, m.num_sources, m.time_context, m.feat_size),
                                 np.float32)
            yield x, y


def _pinned_buffers():
    """Patch the prefetch's pinned pool to record every buffer it hands out."""
    from convsep_tpu_torch.data import pipeline

    seen = []
    real = pipeline._Uploader._buffer

    def record(self, shape, dtype):
        entry = real(self, shape, dtype)
        seen.append((shape, entry[0].data_ptr(), entry[0].is_pinned()))
        return entry

    return mock.patch.object(pipeline._Uploader, "_buffer", record), seen


def test_prefetch_to_device_on_the_card(cuda):
    """prefetch_to_device with a CUDA device: every batch arrives on the
    card equal to its host arrays, in order, behind work still running on
    the consumer's stream; the producer stages through at most size + 1
    pinned buffers per leaf shape, reused, and ends with the loop."""
    import threading

    from convsep_tpu_torch.data.pipeline import prefetch_to_device

    rng = np.random.default_rng(0)
    host = [(rng.standard_normal((64, 1000)).astype(np.float32),
             rng.standard_normal(300).astype(np.float32)) for _ in range(10)]
    patch, seen = _pinned_buffers()
    a = torch.randn(2048, 2048, device=cuda)
    with patch:
        for i, (x, y) in enumerate(prefetch_to_device(iter(host), cuda, size=2)):
            busy = a @ a  # the step: device work the next upload overlaps
            assert x.device.type == "cuda" and y.device.type == "cuda"
            np.testing.assert_array_equal((x * 1.0).cpu().numpy(), host[i][0])
            np.testing.assert_array_equal(y.cpu().numpy(), host[i][1])
            del busy
    assert i == 9 and len(seen) == 20 and all(p for _, _, p in seen)
    for shape in ((64, 1000), (300,)):
        assert len({ptr for s, ptr, _ in seen if s == shape}) <= 3
    assert not [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


def test_trainer_fit_on_the_card_with_the_prefetch_thread(cuda):
    """Trainer(dsd100, feature files' batches).fit(max_steps=6) on the card:
    batches come through the prefetch thread and its pinned pool (reused),
    two adadelta launches a step, a finite loss, and no thread left after
    each of two fits."""
    import threading

    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.train import loop

    p = get_preset("dsd100")
    p = dataclasses.replace(p, train=dataclasses.replace(p.train, optimizer_impl="fused",
                                                         batch_size=4, log_every_steps=2))
    trainer = loop.Trainer(p, device=cuda)
    patch, seen = _pinned_buffers()
    kernels.reset_launches()
    with patch:
        for stop in (3, 6):
            losses = trainer.fit(_Batches(p, 50), num_epochs=1, max_steps=stop)
            assert int(trainer.state.step) == stop and losses == []
            assert not [t for t in threading.enumerate() if t.name == "prefetch_to_device"]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_adadelta"] == 2 * 6
    assert all(pinned for _, _, pinned in seen) and len(seen) >= 2 * 6
    assert len({ptr for _, ptr, _ in seen}) <= 2 * 2 * 3  # two fits, two leaves, 3 each
    assert all(torch.isfinite(v).all() for v in trainer.state.params.values())


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


K_STEP_ROUTES = {
    # name: (preset, from audio, transform fields, train fields)
    "dsd100 features, plain update": ("dsd100", False, {}, {"optimizer_impl": "xla"}),
    "dsd100 features, fused update": ("dsd100", False, {}, {"optimizer_impl": "fused"}),
    "dsd100 audio, stft + fused": ("dsd100", True, {"fft_impl": "pallas"},
                                   {"optimizer_impl": "fused"}),
    "multires4096 audio, stft + fused": ("multires4096", True, {"fft_impl": "pallas"},
                                         {"optimizer_impl": "fused"}),
    "dsd100 audio, bf16 state": ("dsd100", True, {},
                                 {"optimizer_impl": "xla", "optimizer_state_dtype": "bfloat16"}),
}


def _k_step_batches(p, from_audio: bool, K: int, B: int, groups: int, device):
    from convsep_tpu_torch.data.audio_dataset import segment_samples

    gen = torch.Generator(device=device).manual_seed(3)
    m = p.model
    if from_audio:
        stems = 0.1 * torch.randn(groups, K, B, m.num_sources, segment_samples(p),
                                  device=device, generator=gen)
        return [(s.sum(dim=2), s) for s in stems]
    x = 0.3 * torch.rand(groups, K, B, m.time_context, m.feat_size, m.channels_in,
                         device=device, generator=gen)
    y = 0.3 * torch.rand(groups, K, B, m.num_sources, m.time_context, m.feat_size,
                         device=device, generator=gen)
    return list(zip(x, y))


@pytest.mark.parametrize("route", sorted(K_STEP_ROUTES))
def test_k_step_graph_matches_eager_steps(cuda, route):
    """``steps_per_dispatch`` on the card: two replays of the CUDA graph of
    K = 4 whole steps against 8 eager single steps from the same seeded
    state on the same batches, under ``cudnn.deterministic``: losses, grad
    norms, parameters and optimizer state bit for bit, the step count, and
    the kernels' launch counts the same both ways (a replay adds the
    capture's counts)."""
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.train import e2e, loop

    name, from_audio, t_kw, tr_kw = K_STEP_ROUTES[route]
    p = get_preset(name)
    p = dataclasses.replace(p, transform=dataclasses.replace(p.transform, **t_kw),
                            train=dataclasses.replace(p.train, **tr_kw))
    K, B = 4, 2
    batches = _k_step_batches(p, from_audio, K, B, 2, cuda)
    single = e2e.make_audio_train_step if from_audio else loop.make_train_step
    multi = e2e.make_audio_train_step_multi if from_audio else loop.make_train_step_multi
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sa, opt = loop.create_train_state(p, 0, cuda)
        sb, _ = loop.create_train_state(p, 0, cuda)
        step_k, step_1 = multi(p, opt), single(p, opt)
        kernels.reset_launches()
        losses = []
        for xs, ys in batches:
            sa, m = step_k(sa, xs, ys)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        graph_launches = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        eager = []
        for xs, ys in batches:
            for x, y in zip(xs, ys):
                sb, m = step_1(sb, x, y)
                eager.append(m["loss"])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = prev
    assert sa.step == sb.step == 2 * K
    # the warm-up's two steps ran too (on copies of the state)
    warm = {k: n for k, n in graph_launches.items() if n}
    eager_launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    assert set(warm) == set(eager_launches)
    for k, n in eager_launches.items():
        per_step = n // (2 * K)
        assert warm[k] == n + 2 * per_step, (k, warm[k], n)
    if tr_kw.get("optimizer_impl") == "fused":  # a launch a large leaf a step
        big = sum(t.numel() >= _MIN_ELEMS for t in sb.params.values())
        assert big >= 2 and eager_launches["fused_adadelta"] == big * 2 * K
    if from_audio and t_kw.get("fft_impl") == "pallas":
        assert eager_launches["stft"] == 2 * 2 * K
    assert torch.equal(torch.cat(losses), torch.stack(eager))
    from convsep_tpu_torch.ckpt.checkpoint import flatten

    a, b = flatten((sa.params, sa.opt_state)), flatten((sb.params, sb.opt_state))
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (
            k, (a[k].float() - b[k].float()).abs().max().item())


def test_k_step_graph_recaptures_for_a_new_state(cuda):
    """A state whose tensors are new (a restore) takes a new capture: the
    old graph would update the old tensors."""
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.train import loop

    p = get_preset("dsd100")
    batches = _k_step_batches(p, False, 2, 2, 1, cuda)
    sa, opt = loop.create_train_state(p, 0, cuda)
    step_k = loop.make_train_step_multi(p, opt)
    sa, _ = step_k(sa, *batches[0])
    sb, _ = loop.create_train_state(p, 1, cuda)
    # detached: a clone that keeps an autograd graph of the parameters alive
    # keeps their gradient accumulators on the stream they were made on,
    # which a capture on another stream cannot join
    before = {k: v.detach().clone() for k, v in sb.params.items()}
    kept = {k: v.detach().clone() for k, v in sa.params.items()}
    sb, _ = step_k(sb, *batches[0])
    torch.cuda.synchronize()
    assert all(not torch.equal(before[k], sb.params[k]) for k in ("fc_kernel", "out_bias"))
    assert all(torch.equal(kept[k], sa.params[k]) for k in sa.params)


def test_async_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """The asynchronous writer with a dsd100 state on the card: ``save``
    returns once the state is on the host; the live tensors changed right
    after do not reach the file; the restore equals the saved state bit for
    bit, on the card."""
    from convsep_tpu_torch.ckpt import CheckpointManager
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.train import loop

    p = get_preset("dsd100")
    s, _ = loop.create_train_state(p, 0, cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    with torch.no_grad():
        for k in s.params:
            s.opt_state.accu[k].copy_(torch.rand(s.params[k].shape, device=cuda, generator=gen))
    saved = {k: v.clone() for k, v in s.params.items()}
    saved_accu = {k: v.clone() for k, v in s.opt_state.accu.items()}
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    assert mgr.save(5, s, extra={"epoch": 0, "batch_in_epoch": 5})
    with torch.no_grad():
        for k in s.params:
            s.params[k].add_(1.0)
            s.opt_state.accu[k].mul_(2.0)
    assert mgr.wait() and not mgr.fell_back_to_sync
    fresh, _ = loop.create_train_state(p, 1, cuda)
    got, meta = mgr.restore_latest(fresh)
    assert meta["batch_in_epoch"] == 5 and got.step == 0
    for k in s.params:
        assert got.params[k].device.type == "cuda" and torch.equal(got.params[k], saved[k]), k
        assert torch.equal(got.opt_state.accu[k], saved_accu[k]), k
