"""The host side of the forward-STFT FFT core (``csrc/fft_common.cuh``), on
CPU: the launch plan (``dsp/cuda/fft_plan.py``) for every shape the CUDA
tests, ``chip_smoke.py`` and the presets launch; the twiddle table; and a
torch mirror of the core's pass structure (the same radix order, Stockham
exchange slots and twiddle table as the kernel) against ``torch.fft.fft``
and, through the two-frame split, against the plain versions of both STFT
kernels.

Tolerances: the twiddle table within one float32 ulp of numpy's float64;
the mirror in complex128 within 1e-6 × max|Z| of ``torch.fft.fft`` (the
float32 twiddles' rounding, ~6e-8 relative, over log2 N stages); in
complex64 within 1e-5 × max|X| of the plain STFTs (float32 sums in another
order, the CUDA tests' tolerance)."""

import collections
import math

import numpy as np
import pytest
import torch

from convsep_tpu_torch.configs.presets import PRESETS, get_preset
from convsep_tpu_torch.data.audio_dataset import segment_samples
from convsep_tpu_torch.dsp.cuda import fft_plan as fp
from convsep_tpu_torch.dsp.cuda.ct_stft_kernel import stft_ct_pallas_plain
from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas_plain
from convsep_tpu_torch.dsp.stft import _pad_signal, frame_signal, num_frames
from convsep_tpu_torch.dsp.windows import sinebell
from convsep_tpu_torch.separate import bucket_length

# (signals, length, nfft, win, hop) of every power-of-two launch: the CUDA
# tests' cases, chip_smoke.py's phases 5, 6, 10 and 11, and each preset's
# separation track and training step
LAUNCHES = [
    (1, 3000, 256, 256, 128), (7, 3001, 256, 256, 64), (160, 14336, 512, 512, 256),
    (32, 14336, 1024, 1024, 512), (3, 20000, 1024, 1024, 256), (5, 33333, 2048, 2048, 1024),
    (2, 60000, 4096, 4096, 2048), (4, 60001, 4096, 4096, 1024), (1, 1, 1024, 1024, 512),
    (1, 1_474_560, 1024, 1024, 512), (3, 5000, 1024, 512, 128), (1, 1_000_000, 8192, 8192, 1024),
    (4, 1024, 256, 256, 128), (16, 1024, 256, 256, 128),
    (1, 1_474_560, 4096, 4096, 1024), (3, 60_001, 4096, 4096, 1024), (1, 1, 4096, 4096, 1024),
    (2, 33_333, 2048, 2048, 1024), (2, 100_000, 8192, 8192, 1024), (2, 60_000, 4096, 4096, 1024),
    (32, 14336, 1024, 1024, 512), (128, 14336, 1024, 1024, 512),
    (16, 1 << 14, 16, 16, 8), (3, 999, 32, 32, 16), (2, 4000, 128, 128, 64),
] + [
    (n, length, p.transform.nfft or p.transform.frame_size, p.transform.frame_size,
     p.transform.hop_size)
    for name in PRESETS
    for p in [get_preset(name)]
    for n, length in ((1, bucket_length(30 * 44100, p)),
                      (p.train.batch_size, segment_samples(p)),
                      (p.train.batch_size * p.model.num_sources, segment_samples(p)))
]


@pytest.mark.parametrize("signals,length,nfft,win,hop", LAUNCHES)
def test_launch_plan(signals, length, nfft, win, hop):
    nf = num_frames(length, hop)
    plan = fp.stft_plan(signals, nf, nfft, win, hop)
    rad = fp.radices(nfft)
    assert math.prod(rad) == nfft and set(rad[1:]) <= {16} and rad[0] in (2, 4, 8, 16)
    t = fp.threads_per_fft(nfft)
    assert t * fp.POINTS == nfft
    g = plan.ffts_per_block
    assert g & (g - 1) == 0 and plan.threads == g * t
    assert plan.threads % 32 == 0 and plan.threads <= fp.MAX_THREADS
    assert t <= 32 or g <= fp.MAX_NAMED_GROUPS  # named barriers 1 … g
    assert plan.smem_bytes == fp.smem_bytes(nfft, win, hop, g) <= fp.SMEM_MAX
    # the span holds every sample of the block's 2g frames, shifted by up to
    # three floats to 16-byte alignment and read in whole float4s
    span = fp.span_floats(2 * g, win, hop)
    assert span % 4 == 0 and span >= (2 * g - 1) * hop + win + 3 + 3
    # the grid covers every frame, with no block wholly past the last
    per = plan.blocks_per_signal
    assert per * 2 * g >= nf > (per - 1) * 2 * g
    assert plan.blocks == signals * per
    # two blocks per SM wherever a plan with more FFTs per block would not
    # give them; otherwise the most blocks
    if plan.blocks < 2 * fp.SMS:
        assert g == max(1, 32 // t)


@pytest.mark.parametrize("signals,length,nfft,hop,ffts,blocks", [
    (32, 14336, 1024, 512, 1, 480),      # training step, mixtures
    (128, 14336, 1024, 512, 4, 512),     # training step, stems
    (1, 1_474_560, 1024, 512, 4, 361),   # dsd100 fft_impl="pallas" track
    (1, 1_474_560, 4096, 1024, 2, 361),  # multires4096 analysis="ct_pallas" track
])
def test_main_path_plans(signals, length, nfft, hop, ffts, blocks):
    plan = fp.stft_plan(signals, num_frames(length, hop), nfft, nfft, hop)
    assert (plan.ffts_per_block, plan.blocks) == (ffts, blocks)
    assert plan.blocks >= 2 * fp.SMS


def test_plan_refusals():
    for n in (8, 1000, 16384):
        assert not fp.fft_supported(n)
        with pytest.raises(ValueError, match="no FFT plan"):
            fp.stft_plan(1, 10, n, n, n // 2)


@pytest.mark.parametrize("nfft", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                                  48, 80, 768, 1280, 2304, 6144])  # and the split's
def test_twiddle_table(nfft):
    tab = fp.twiddle_table(nfft)
    assert tab.shape == (nfft, 2) and tab.dtype == np.float32
    # numpy's float64 on the angle reduced to the first quadrant, where a
    # quarter turn's cosine is 0 exactly (not cos(pi/2) = 6e-17)
    m = np.arange(nfft)
    r = 2 * np.pi * (m % (nfft // 4)) / nfft
    turns = [(np.cos(r), -np.sin(r)), (-np.sin(r), -np.cos(r)),
             (-np.cos(r), np.sin(r)), (np.sin(r), np.cos(r))]
    q = m // (nfft // 4)
    want = np.stack([np.choose(q, [t[i] for t in turns]) for i in (0, 1)], -1)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(tab - want) <= ulp)
    full = np.exp(-2j * np.pi * m / nfft)
    assert np.abs(tab[:, 0] + 1j * tab[:, 1] - full).max() < 1e-7
    quarter = fp.twiddles(nfft, "cpu")
    assert quarter is fp.twiddles(nfft, "cpu")  # made once
    assert np.array_equal(quarter.numpy(), tab[: nfft // 4])


def test_window_copy_is_found_by_value():
    a = fp.window_f32(sinebell(1024), "cpu")
    assert fp.window_f32(sinebell(1024), "cpu") is a  # a fresh array, the same bytes
    assert torch.equal(a, torch.from_numpy(sinebell(1024).astype(np.float32)))
    b = fp.window_f32(sinebell(1024) * 0.5, "cpu")
    assert b is not a and torch.equal(b, 0.5 * a)


# -- the mirror -----------------------------------------------------------


def _roots16(dtype):
    e = np.arange(8)
    return torch.from_numpy(np.exp(-2j * np.pi * e / 16).astype(np.complex64)).to(dtype)


def _dft(u, r):
    """fft_common.cuh::dft<r>: radix-2 decimation in time over the last axis
    (the registers), bit-reversed in, natural order out."""
    bits = r.bit_length() - 1
    rev = [int(f"{i:0{bits}b}"[::-1], 2) if bits else 0 for i in range(r)]
    u = u[..., rev].clone()
    roots = _roots16(u.dtype)
    size = 2
    while size <= r:
        for i in range(0, r, size):
            for k in range(size // 2):
                a = u[..., i + k].clone()
                b = u[..., i + k + size // 2] * roots[k * (16 // size)]
                u[..., i + k] = a + b
                u[..., i + k + size // 2] = a - b
        size *= 2
    return u


def core_fft(z: torch.Tensor) -> torch.Tensor:
    """fft_common.cuh::Fft<log2 N>::run on (..., N) complex: thread j holds
    v[m] = element j + T m; each pass twiddles, runs 16 / r radix-r DFTs on
    registers q + s (16 / r) and writes them to the Stockham slots of a
    padded exchange buffer, which the next pass reads at j + T m."""
    N = z.shape[-1]
    T = fp.threads_per_fft(N)
    tw = torch.from_numpy(fp.twiddle_table(N).astype(np.float64)).to(z.dtype.to_real())
    tw = torch.complex(tw[:, 0], tw[:, 1])
    j = torch.arange(T)
    at_jm = j[:, None] + T * torch.arange(fp.POINTS)[None, :]  # (T, 16)
    buf = torch.full((*z.shape[:-1], fp.exchange_entries(N)), float("nan"), dtype=z.dtype)
    v = z[..., at_jm]
    ns = 1
    for p, r in enumerate(fp.radices(N)):
        if p:
            v = buf[..., fp.exchange_slot(at_jm)]
        nb = fp.POINTS // r
        s = torch.arange(r)
        for q in range(nb):
            b = j + q * T
            u = v[..., q + s * nb]  # (..., T, r)
            if ns > 1:
                u = u * tw[((b % ns)[:, None] * s[None, :]) * (N // (ns * r))]
            u = _dft(u, r)
            base = (b - b % ns) * r + b % ns
            buf[..., fp.exchange_slot(base[:, None] + s[None, :] * ns)] = u
        ns *= r
    return buf[..., fp.exchange_slot(torch.arange(N))]


@pytest.mark.parametrize("nfft", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192])
def test_core_matches_torch_fft(rng, nfft):
    z = rng.standard_normal((3, nfft)) + 1j * rng.standard_normal((3, nfft))
    got = core_fft(torch.from_numpy(z))
    want = torch.fft.fft(torch.from_numpy(z))
    torch.testing.assert_close(got, want, atol=1e-6 * want.abs().max().item(), rtol=0)


def core_stft(x: torch.Tensor, window: np.ndarray, hop: int, nfft: int,
              fft=core_fft) -> torch.Tensor:
    """stft_block in float32 (``fft``: split_fft for stft_split_block):
    frames f hop − W/2 + t of the zero-padded signal, windowed, zero-padded
    to nfft; frames 2g and 2g + 1 ride one transform (a zero frame after an
    odd last one) and split again. Returns (B, nf, nfft/2 + 1) complex64."""
    W = len(window)
    nf = num_frames(x.shape[-1], hop)
    frames = frame_signal(_pad_signal(x, W, hop), W, hop, nf)
    frames = frames * torch.from_numpy(window.astype(np.float32))
    frames = torch.nn.functional.pad(frames, (0, nfft - W))
    if nf % 2:
        frames = torch.nn.functional.pad(frames, (0, 0, 0, 1))
    zz = fft(torch.complex(frames[..., 0::2, :], frames[..., 1::2, :]))
    k = torch.arange(nfft // 2 + 1)
    z, w = zz[..., k], zz[..., (nfft - k) % nfft].conj()
    a, b = 0.5 * (z + w), -0.5j * (z - w)
    out = torch.stack([a, b], -2).flatten(-3, -2)  # frames back in order
    return out[..., :nf, :]


@pytest.mark.parametrize("nfft,win,hop,B,length", [
    (1024, 1024, 512, 3, 14336),   # the training step's framing
    (1024, 1024, 512, 1, 9001),    # nf odd: the last frame pairs with zeros
    (256, 256, 64, 2, 3001),
    (1024, 512, 128, 2, 5000),     # nfft past the window
    (128, 128, 64, 1, 1),
])
def test_core_stft_matches_stft_pallas_plain(rng, nfft, win, hop, B, length):
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32))
    w = sinebell(win)
    got = core_stft(x, w, hop, nfft)
    re, im = stft_pallas_plain(x, w, hop, nfft)
    peak = max(re.abs().max().item(), im.abs().max().item())
    torch.testing.assert_close(got.real, re, atol=1e-5 * peak, rtol=0)
    torch.testing.assert_close(got.imag, im, atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("nfft,B,length", [(4096, 1, 60_001), (2048, 2, 33_333),
                                           (8192, 1, 40_000)])
def test_core_stft_matches_stft_ct_pallas_plain(rng, nfft, B, length):
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32))
    w = sinebell(nfft)
    got = core_stft(x, w, 1024, nfft)
    re, im, ny = stft_ct_pallas_plain(x, w, 1024)
    peak = max(re.abs().max().item(), im.abs().max().item(), ny.abs().max().item())
    half = nfft // 2
    torch.testing.assert_close(got.real[..., :half], re, atol=1e-5 * peak, rtol=0)
    torch.testing.assert_close(got.imag[..., :half], im, atol=1e-5 * peak, rtol=0)
    torch.testing.assert_close(got.real[..., half], ny, atol=1e-5 * peak, rtol=0)
    assert got.imag[..., half].abs().max().item() == 0.0


def _ways(slots, banks):
    """Most distinct 8-byte words in one bank among one access's slots."""
    by_bank = {}
    for s in set(slots):
        by_bank.setdefault(s % banks, set()).add(s)
    return max(len(v) for v in by_bank.values())


@pytest.mark.parametrize("nfft", [512, 1024, 2048, 4096, 8192])
def test_exchange_slots_avoid_bank_conflicts(nfft):
    """The header's claim: with slot i + i/16, every pass's float2 reads
    and writes meet distinct banks in each half-warp (32 banks of 4 bytes:
    16 float2 per transaction), and the split's mirrored read at most two
    ways. Threads j of one warp are consecutive."""
    T = fp.threads_per_fft(nfft)
    ns, worst = 1, 1
    for p, r in enumerate(fp.radices(nfft)):
        nb = fp.POINTS // r
        for q in range(nb):
            for s in range(r):
                for h in range(0, T, 16):
                    js = np.arange(h, h + 16)
                    b = js + q * T
                    wr = fp.exchange_slot((b - b % ns) * r + b % ns + s * ns)
                    worst = max(worst, _ways(wr.tolist(), 16))
                    if p:
                        rd = fp.exchange_slot(js + T * (q + s * nb))
                        worst = max(worst, _ways(rd.tolist(), 16))
        ns *= r
    assert worst == 1
    split = 1
    for q in range(fp.POINTS // 2):
        for h in range(0, T, 16):
            k = np.arange(h, h + 16) + T * q
            split = max(split, _ways(fp.exchange_slot((nfft - k) % nfft).tolist(), 16))
    assert split <= 2


# -- the mixed-radix split (fft_common.cuh::stft_split_block) ---------------

SPLIT_SIZES = [48, 80, 768, 1280, 1536, 2304, 3072, 6144]


def _root(M: int, e, dtype):
    """e^{−2πi e / M} rounded once to the working precision: the kernel's
    literal roots (``root<M>``), or its float32 twiddle table's entries."""
    w = np.complex64(np.exp(-2j * np.pi * e / M))
    return torch.tensor(complex(w), dtype=dtype)


def _radix3(u0, u1, u2):
    s3 = float(np.float32(np.sqrt(3) / 2))
    t1 = u1 + u2
    t2 = u0 - 0.5 * t1
    d = (u1 - u2) * s3  # X1 = t2 − i d, X2 = t2 + i d
    return [u0 + t1, t2 - 1j * d, t2 + 1j * d]


def _radix5(u0, u1, u2, u3, u4):
    c1, c2 = (float(np.float32(np.cos(a))) for a in (2 * np.pi / 5, 4 * np.pi / 5))
    s1, s2 = (float(np.float32(np.sin(a))) for a in (2 * np.pi / 5, 4 * np.pi / 5))
    a1, b1, a2, b2 = u1 + u4, u1 - u4, u2 + u3, u2 - u3
    r1, r2 = u0 + c1 * a1 + c2 * a2, u0 + c2 * a1 + c1 * a2
    i1, i2 = s1 * b1 + s2 * b2, s2 * b1 - s1 * b2
    return [u0 + a1 + a2, r1 - 1j * i1, r2 - 1j * i2, r2 + 1j * i2, r1 + 1j * i1]


def dft_odd(u: list, M: int) -> list:
    """fft_common.cuh::dft_odd<M> on a list of M tensors (the registers):
    the radix-3 and radix-5 butterflies; 9 = 3 × 3 and 15 = 3 × 5 by
    Cooley–Tukey (R1 = 3 sub-DFTs of R2 points at stride 3, the literal
    twiddles e^{−2πi n1 k1 / M}, R2 DFTs of 3), output in natural order."""
    dtype = u[0].dtype
    if M == 3:
        return _radix3(*u)
    if M == 5:
        return _radix5(*u)
    r1, r2 = 3, M // 3
    t = {}
    for n1 in range(r1):
        sub = dft_odd([u[r1 * n2 + n1] for n2 in range(r2)], r2)
        for k1 in range(r2):
            t[n1, k1] = sub[k1] * _root(M, n1 * k1, dtype) if n1 * k1 else sub[k1]
    out = [None] * M
    for k1 in range(r2):
        col = dft_odd([t[n1, k1] for n1 in range(r1)], r1)
        for k2 in range(r1):
            out[k1 + r2 * k2] = col[k2]
    return out


def split_fft(z: torch.Tensor) -> torch.Tensor:
    """stft_split_block's transform on (..., N) complex, N = m · P: stage 1
    runs the core on the m sub-sequences n1 (points m n2 + n1) into the
    group's exchange buffer, sub-FFT n1's bin k1 at slot(n1 P + k1); stage
    2, for each column k1, reads slot(n P + k1) for n < m, multiplies by
    e^{−2πi n k1 / N} from the N-point float32 table, runs dft_odd<m> and
    writes bin k1 + P k2 back to slot(k2 P + k1): Z in natural order."""
    N = z.shape[-1]
    m, P = fp.split_factors(N)
    buf = torch.full((*z.shape[:-1], fp.exchange_entries(N)), float("nan"), dtype=z.dtype)
    k1 = torch.arange(P)
    for n1 in range(m):
        buf[..., fp.exchange_slot(n1 * P + k1)] = core_fft(z[..., n1::m])
    tw = torch.from_numpy(fp.twiddle_table(N).astype(np.float64)).to(z.dtype.to_real())
    tw = torch.complex(tw[:, 0], tw[:, 1])
    u = [buf[..., fp.exchange_slot(n * P + k1)] for n in range(m)]
    u = [u[0]] + [u[n] * tw[n * k1] for n in range(1, m)]
    for k2, col in enumerate(dft_odd(u, m)):
        buf[..., fp.exchange_slot(k2 * P + k1)] = col
    return buf[..., fp.exchange_slot(torch.arange(N))]


@pytest.mark.parametrize("nfft", SPLIT_SIZES)
def test_split_matches_torch_fft(rng, nfft):
    z = rng.standard_normal((3, nfft)) + 1j * rng.standard_normal((3, nfft))
    got = split_fft(torch.from_numpy(z))
    want = torch.fft.fft(torch.from_numpy(z))
    torch.testing.assert_close(got, want, atol=1e-6 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("m", [3, 5, 9, 15])
def test_odd_dfts_match_torch_fft(rng, m):
    z = torch.from_numpy(rng.standard_normal((4, m)) + 1j * rng.standard_normal((4, m)))
    got = torch.stack(dft_odd(list(z.unbind(-1)), m), -1)
    want = torch.fft.fft(z)
    torch.testing.assert_close(got, want, atol=1e-6 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("nfft,win,hop,B,length", [
    (n, n, n // 4, 2, 7 * n + 123) for n in SPLIT_SIZES] + [
    (768, 640, 160, 2, 5000),      # nfft past the window
    (768, 768, 256, 1, 14336),     # the smoke's shape, nf 58
    (1280, 1280, 320, 1, 14336),   # m = 5
    (48, 48, 16, 1, 1),            # one sample
])
def test_split_stft_matches_stft_pallas_plain(rng, nfft, win, hop, B, length):
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32))
    w = sinebell(win)
    got = core_stft(x, w, hop, nfft, fft=split_fft)
    re, im = stft_pallas_plain(x, w, hop, nfft)
    peak = max(re.abs().max().item(), im.abs().max().item())
    torch.testing.assert_close(got.real, re, atol=1e-5 * peak, rtol=0)
    torch.testing.assert_close(got.imag, im, atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("signals,length,nfft,win,hop", [
    (32, 14336, 768, 768, 256), (32, 14336, 1280, 1280, 320), (2, 20000, 1536, 1536, 384),
    (2, 30000, 3072, 3072, 768), (2, 20000, 2304, 2304, 576), (3, 40000, 6144, 6144, 1536),
    (1, 1, 48, 48, 16), (5, 999, 80, 80, 40), (2, 5000, 240, 240, 60), (1, 60000, 7680, 7680, 1920),
    (1, 1_474_560, 768, 768, 256), (3, 5000, 768, 640, 160),
])
def test_split_plan(signals, length, nfft, win, hop):
    nf = num_frames(length, hop)
    plan = fp.split_plan(signals, nf, nfft, win, hop)
    m, p = fp.split_factors(nfft)
    assert (plan.m, plan.p) == (m, p) and m * p == nfft and m in fp.SPLIT_ODD
    assert fp.fft_supported(p) and not fp.fft_supported(nfft)
    g = plan.ffts_per_block
    assert g & (g - 1) == 0 and plan.threads == g * m * fp.threads_per_fft(p)
    assert plan.threads % 32 == 0 and plan.threads <= fp.MAX_THREADS  # whole warps
    assert plan.smem_bytes == fp.split_smem_bytes(nfft, win, hop, g) <= fp.SMEM_MAX
    per = plan.blocks_per_signal
    assert per * 2 * g >= nf > (per - 1) * 2 * g and plan.blocks == signals * per
    if plan.blocks < 2 * fp.SMS:
        assert plan.threads == max(1, 32 // fp.threads_per_fft(p)) * nfft // fp.POINTS


def test_split_main_shapes():
    """The smoke's shapes, W 768 / hop 256 and W 1280 / hop 320 at B 32 (58
    and 47 frames): two transforms a block, 480 and 384 blocks."""
    a = fp.split_plan(32, num_frames(14336, 256), 768, 768, 256)
    b = fp.split_plan(32, num_frames(14336, 320), 1280, 1280, 320)
    assert (a.ffts_per_block, a.threads, a.blocks) == (2, 96, 480)
    assert (b.ffts_per_block, b.threads, b.blocks) == (2, 160, 384)


def test_split_refusals():
    """Powers of two go to the core's own kernel; the split refuses 1000 =
    8 · 125 (2^a < 16 and 125 is not a split factor), 7 · 256 (a factor 7),
    3 · 8 (2^a < 16) and sizes past 8192: up to 8192 they go to Bluestein
    (:func:`test_bluestein_routing`), past it to the dense DFT kernel."""
    for n in (1000, 1024, 7 * 256, 24, 16, 8192, 3 * 4096, 25 * 64, 27 * 16):
        assert not fp.split_supported(n)
        with pytest.raises(ValueError, match="no split plan"):
            fp.split_plan(1, 10, n, n, n // 2)
    assert all(fp.split_supported(m * p) for m in fp.SPLIT_ODD
               for p in (16, 32, 64, 128, 256, 512) if m * p <= 8192)


@pytest.mark.parametrize("nfft", [48, 80, 240, 768, 1280, 2304, 3072, 6144, 7680])
def test_split_slots_avoid_bank_conflicts(nfft):
    """The split's own accesses, with the block's threads laid out as the
    kernel lays them (group g = tid / T, T = nfft/16; its exchange buffer at
    g (N + N/16)): stage 2's reads and writes of column k1 = jj + T q at
    slot(n P + k1) meet distinct banks in each half-warp; stage 1's loads of
    the span (floats at stride m within a sub-FFT: a group reads m · P/16
    consecutive floats a register, of which a warp holds a part) meet at
    most two ways within each group of a warp (where groups share a warp
    their spans sit 2 hop floats apart, which depends on hop); the split's
    mirrored read is at most two-way."""
    m, p = fp.split_factors(nfft)
    plan = fp.split_plan(64, 100, nfft, nfft, nfft // 4)
    T, t1, E = nfft // fp.POINTS, fp.threads_per_fft(p), fp.exchange_entries(nfft)
    tid = np.arange(plan.threads)
    g, jj = tid // T, tid % T
    worst = split = span = 1
    for h in range(0, plan.threads, 16):
        gh, jh = g[h:h + 16], jj[h:h + 16]
        for q in range(-(-p // T)):
            k1 = jh + T * q
            live = k1 < p
            for n in range(m):
                slots = (gh * E + fp.exchange_slot(n * p + k1))[live]
                if slots.size:
                    worst = max(worst, _ways(slots.tolist(), 16))
        for q in range(fp.POINTS // 2 + 1):
            k = jh + T * q
            live = (k <= nfft // 2) & ((q < fp.POINTS // 2) | (jh == 0))
            mir = (gh * E + fp.exchange_slot((nfft - k) % nfft))[live]
            if mir.size:
                split = max(split, _ways(mir.tolist(), 16))
    for w in range(0, plan.threads, 32):  # floats: 32 banks of 4 bytes a warp
        gw, jw = g[w:w + 32], jj[w:w + 32]
        for mm in range(fp.POINTS):
            t = m * (jw % t1 + t1 * mm) + jw // t1
            for gg in set(gw.tolist()):
                span = max(span, _ways(t[gw == gg].tolist(), 32))
    assert worst == 1
    assert span <= 2 and split <= 2


# -- Bluestein (fft_common.cuh::stft_bluestein_block) ------------------------

BLUESTEIN_SIZES = [18, 432, 1000, 1001, 1792, 4000, 4097, 6000, 8190, 8191]
LEVEL = 2 * fp.MAX_NFFT  # the level's 16 384 points


def _level_twiddles(dtype):
    """w^n = e^{−2πi n / 16384}, n < 8192, from the level's float32 table."""
    tw = torch.from_numpy(fp.twiddle_table(LEVEL)[: LEVEL // 2].astype(np.float64))
    return torch.complex(tw[:, 0], tw[:, 1]).to(dtype)


def level_fft(z: torch.Tensor) -> torch.Tensor:
    """fft_common.cuh::Level::forward on (..., 16384) complex: the core on
    the even points (half 0) and on the odd points (half 1), then the
    radix-2 butterflies Z[k1] = Y0 + w^k1 Y1, Z[k1 + 8192] = Y0 − w^k1 Y1:
    Z in natural order."""
    y0, y1 = core_fft(z[..., 0::2]), core_fft(z[..., 1::2]) * _level_twiddles(z.dtype)
    return torch.cat([y0 + y1, y0 - y1], -1)


def level_fft_dif(u: torch.Tensor) -> torch.Tensor:
    """Level::forward_dif on (..., 16384) complex in natural order: a = u[n]
    + u[n + 8192], b = (u[n] − u[n + 8192]) w^n, the core on a (half 0) and
    on b (half 1). Returns the buffer: Z[2k] at k, Z[2k + 1] at 8192 + k
    (``Level::dif_slot``)."""
    h = LEVEL // 2
    a = u[..., :h] + u[..., h:]
    b = (u[..., :h] - u[..., h:]) * _level_twiddles(u.dtype)
    return torch.cat([core_fft(a), core_fft(b)], -1)


def dif_order(n: int) -> torch.Tensor:
    """Where level_fft_dif leaves point k: (k & 1) · 8192 + k / 2."""
    k = torch.arange(n)
    return (k & 1) * (LEVEL // 2) + (k >> 1)


def bluestein_fft(z: torch.Tensor) -> torch.Tensor:
    """Chirp::convolve and the post-chirp on (..., N) complex: times the
    float32 conj chirp, zero-padded to M, the FFT, times Ĉ / M, then
    conjugated through the FFT again (the inverse by conjugation), and Z[k]
    = conj c_k · conj(buf[at(k)]) for k < N. The core runs both transforms
    up to M 8192; the level runs the first by decimation in time and the
    second by decimation in frequency, which leaves its output in
    ``dif_order``."""
    N = z.shape[-1]
    M = fp.bluestein_size(N)
    chirp, chat = (torch.complex(t[:, 0], t[:, 1]).to(z.dtype) for t in fp.bluestein_tables(N, "cpu"))
    a = torch.nn.functional.pad(z * chirp, (0, M - N))
    if M <= fp.MAX_NFFT:
        buf = core_fft((core_fft(a) * chat).conj())[..., :N]
    elif M == LEVEL:
        buf = level_fft_dif((level_fft(a) * chat).conj())[..., dif_order(N)]
    else:
        buf = cluster_fft(a, M // fp.CLUSTER_PART, chat)[..., :N]
    return chirp * buf.conj()


# -- Bluestein over a thread-block cluster (fft_common.cuh::ClusterChirp) ------


def _powers(M: int, dtype) -> torch.Tensor:
    """w^e = e^{−2πi e / M}, e < M, from the float32 M-point table, as the
    cluster's blocks read it (``ldg_twiddle``)."""
    tw = torch.from_numpy(fp.twiddle_table(M).astype(np.float64))
    return torch.complex(tw[:, 0], tw[:, 1]).to(dtype)


def _part_fft(z: torch.Tensor) -> torch.Tensor:
    """A block's transform of its part: the core, or the level past 8192."""
    return core_fft(z) if z.shape[-1] <= fp.MAX_NFFT else level_fft(z)


def cluster_dif(u: torch.Tensor, c: int, terms: int | None = None) -> torch.Tensor:
    """ClusterChirp::convolve's first transform on (..., M) complex, M = c P:
    block r forms b_r[n] = w^{r n} Σ_{q < terms} u[n + P q] W^{r q} (Horner
    in W^r = w^{P r}; the kernel's terms are c / 2, u vanishing from M/2 on)
    and runs its part's transform: Y[c k + r] at [..., r, k]."""
    M = u.shape[-1]
    P = M // c
    terms = terms or c
    w = _powers(M, u.dtype)
    n = torch.arange(P)
    parts = []
    for r in range(c):
        s = u[..., n + P * (terms - 1)]
        for q in range(terms - 2, -1, -1):
            s = u[..., n + P * q] + s * w[P * r]
        parts.append(_part_fft(s * w[r * n] if r else s))
    return torch.stack(parts, -2)


def cluster_dit(v: torch.Tensor, c: int) -> torch.Tensor:
    """ClusterChirp::convolve's second transform and ClusterChirp::point on
    (..., c, P), point c k + r at [..., r, k]: block r transforms its part,
    V_r, and multiplies by w^{r k1} in place; Z[k1 + P q] = Σ_r (W^q)^r ·
    that, by Horner in W^q, read across the blocks. (..., M) natural order."""
    P = v.shape[-1]
    M = c * P
    w = _powers(M, v.dtype)
    k1 = torch.arange(P)
    parts = [_part_fft(v[..., r, :]) * (w[r * k1] if r else 1) for r in range(c)]
    out = []
    for q in range(c):
        z = parts[c - 1]
        for r in range(c - 2, -1, -1):
            z = parts[r] + z * w[P * q]
        out.append(z)
    return torch.cat(out, -1)


def cluster_fft(u: torch.Tensor, c: int, chat: torch.Tensor | None = None) -> torch.Tensor:
    """Steps 1–4 of ClusterChirp::convolve on (..., M) complex: the first
    transform (``cluster_dif``, c/2 terms where ``chat`` is given, as
    Bluestein's u vanishes from M/2 on), then, with ``chat``, its product
    with Ĉ[c k + r] conjugated, then the second transform and the combine
    (``cluster_dit``): conj(u ⊛ c) as Chirp leaves it. Without ``chat`` the
    two transforms compose to M · u[−n mod M]."""
    M = u.shape[-1]
    y = cluster_dif(u, c, c // 2 if chat is not None else None)
    if chat is not None:
        y = (y * chat.reshape(M // c, c).T).conj()
    return cluster_dit(y, c)


@pytest.mark.parametrize("M", [256, 2048, 32768])
@pytest.mark.parametrize("c", [2, 4, 8, 16])
def test_cluster_transforms_match_torch_fft(rng, M, c):
    """Both of the cluster's transforms against torch.fft.fft, with the
    kernel's index maps: the first leaves Y[c k + r] in block r's slot k,
    the second takes point c k + r from there and gives natural order; the
    two composed (cluster_fft without Ĉ) give M · u[−n mod M]."""
    z = torch.from_numpy(rng.standard_normal((2, M)) + 1j * rng.standard_normal((2, M)))
    want = torch.fft.fft(z)
    tol = 1e-6 * want.abs().max().item()
    P = M // c
    torch.testing.assert_close(cluster_dif(z, c), want.reshape(2, P, c).transpose(-1, -2),
                               atol=tol, rtol=0)
    torch.testing.assert_close(cluster_dit(z.reshape(2, P, c).transpose(-1, -2), c), want,
                               atol=tol, rtol=0)
    back = cluster_fft(z, c)
    torch.testing.assert_close(back, M * z[..., (-torch.arange(M)) % M],
                               atol=1e-6 * back.abs().max().item(), rtol=0)


@pytest.mark.parametrize("nfft", [8193, 10_000, 12_288, 16_384, 20_000, 40_000, 65_536])
def test_cluster_bluestein_matches_the_dft(rng, nfft):
    """Bluestein on the cluster (bluestein_fft past M 16 384: C = M / 8192
    blocks, 4 up to 16 384 points, 8 up to 32 768, 16 past) against the
    plain DFT (torch.fft.fft in float64): within 1e-6 × max|Z|."""
    assert fp.cluster_supported(nfft) and fp.cluster_blocks(nfft) == (
        4 if nfft <= 16384 else 8 if nfft <= 32768 else 16)
    z = rng.standard_normal((2, nfft)) + 1j * rng.standard_normal((2, nfft))
    got = bluestein_fft(torch.from_numpy(z))
    want = torch.fft.fft(torch.from_numpy(z))
    torch.testing.assert_close(got, want, atol=1e-6 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("signals,nf,nfft,win,hop", [
    (32, 7, 12288, 12288, 3072), (32, 5, 20000, 20000, 5000), (1, 1, 8193, 8193, 8193),
    (2, 40, 32768, 16384, 4096), (3, 20, 16384, 16384, 2048), (1, 9, 16385, 16385, 3277),
    (32, 4, 40000, 40000, 10000), (32, 3, 65536, 65536, 16384), (1, 9, 32769, 32769, 32769),
])
def test_cluster_plan(signals, nf, nfft, win, hop):
    """cluster_plan mirrors stft_cluster_launch: M / 8192 blocks a cluster
    (4 up to 16 384 points, 8 up to 32 768, the portable limit, 16 past),
    one cluster a pair of frames, 512 threads and 87 040 bytes a block (the
    8192-point quarter table and exchange buffer; the frames come from
    global memory)."""
    plan = fp.cluster_plan(signals, nf, nfft, win, hop)
    assert plan.m == fp.bluestein_size(nfft) == plan.cluster * fp.CLUSTER_PART
    assert plan.cluster == (4 if nfft <= 16384 else 8 if nfft <= 32768 else 16)
    assert plan.threads == fp.MAX_THREADS
    assert plan.clusters == signals * -(-nf // 2) and plan.blocks == plan.clusters * plan.cluster
    assert plan.smem_bytes == 8 * ((2048 + 128) + (8192 + 512)) == 87_040 <= fp.SMEM_MAX


@pytest.mark.parametrize("signals,nf,nfft,win,hop", [
    (1, 532, 10000, 10000, 2500), (1, 267, 20000, 20000, 5000), (1, 10, 10000, 10000, 2500),
    (4, 530, 10000, 10000, 2500), (2, 40, 8194, 8194, 4097), (1, 60, 32768, 32768, 4096),
    (3, 90, 16384, 16384, 2048), (1, 300, 20000, 16000, 4000), (1, 134, 40000, 40000, 10000),
    (1, 83, 65536, 65536, 16384), (2, 300, 50000, 40000, 5000), (1, 5, 32770, 32770, 16385),
])
def test_istft_cluster_plan(signals, nf, nfft, win, hop):
    """istft_cluster_plan mirrors istft_cluster_launch (one pair a round, a
    cluster owning 2 · rounds − (k − 1) hop rows, each block the carry of
    its 1/C of the columns, within shared memory) and takes the fewest
    waves × rounds (CLUSTERS_AT_ONCE a wave) over every rounds it may;
    istft_plan takes it off the powers of two and ISTFT_MIXED_WON (at 16
    384, 32 768 and 65 536 the direct transform's plan,
    test_istft_cluster_dit_plan; at 10 000, 20 000, 40 000 and 50 000 the
    mixed cluster's, test_istft_cluster_mixed_plan)."""
    plan = fp.istft_cluster_plan(signals, nf, nfft, win, hop)
    k = win // hop
    c = fp.cluster_blocks(nfft)
    if nfft & (nfft - 1) and nfft not in fp.ISTFT_MIXED_WON:
        assert plan == fp.istft_plan(signals, nf, nfft, win, hop)
    assert plan.route == "cluster"
    assert plan.cluster == c and plan.groups == 1 and plan.threads == 512
    assert plan.rows == 2 * plan.rounds - (k - 1) >= 1
    assert plan.blocks_per_signal * plan.rows >= nf + k - 1
    assert plan.blocks == signals * plan.blocks_per_signal * c
    assert plan.smem_bytes == 87_040 + 4 * (k - 1) * -(-hop // c) <= fp.SMEM_MAX

    def cost(rounds):
        rows = 2 * rounds - (k - 1)
        per = -(-(nf + k - 1) // rows)
        return -(-signals * per // fp.CLUSTERS_AT_ONCE[c]) * rounds

    assert all(cost(plan.rounds) <= cost(r) for r in range(-(-k // 2), 300)
               if 2 * r - (k - 1) >= 1)


@pytest.mark.parametrize("signals,nf,nfft,win,hop", [
    (4, 648, 16384, 16384, 2048), (4, 325, 32768, 32768, 4096), (1, 83, 65536, 65536, 16384),
    (3, 90, 16384, 16384, 2048), (1, 60, 32768, 16384, 4096), (2, 40, 65536, 32768, 8192),
    (1, 5, 16384, 16384, 16384), (1, 300, 16384, 16384, 2), (2, 17, 32768, 32768, 32768),
])
def test_istft_cluster_dit_plan(signals, nf, nfft, win, hop):
    """istft_cluster_dit_plan mirrors istft_cluster_dit_launch: C = nfft /
    8192 blocks (2, 4, 8), one pair a round, a cluster owning 2 · rounds −
    (k − 1) hop rows, each block the carry of its 1/C of the columns within
    shared memory, the fewest waves × rounds (CLUSTERS_AT_ONCE[C] a wave);
    istft_plan takes it at the powers of two past 8192."""
    plan = fp.istft_cluster_dit_plan(signals, nf, nfft, win, hop)
    k = win // hop
    c = nfft // 8192
    assert plan == fp.istft_plan(signals, nf, nfft, win, hop)
    assert (plan.route, plan.cluster, plan.groups, plan.threads) == ("cluster_dit", c, 1, 512)
    assert plan.rows == 2 * plan.rounds - (k - 1) >= 1
    assert plan.blocks_per_signal * plan.rows >= nf + k - 1
    assert plan.blocks == signals * plan.blocks_per_signal * c
    assert plan.smem_bytes == 87_040 + 4 * (k - 1) * -(-hop // c) <= fp.SMEM_MAX

    def cost(rounds):
        rows = 2 * rounds - (k - 1)
        per = -(-(nf + k - 1) // rows)
        return -(-signals * per // fp.CLUSTERS_AT_ONCE[c]) * rounds

    assert all(cost(plan.rounds) <= cost(r) for r in range(-(-k // 2), 400)
               if 2 * r - (k - 1) >= 1)


@pytest.mark.parametrize("nfft,hop,route,cluster", [
    (16384, 2048, "cluster_dit", 2), (32768, 4096, "cluster_dit", 4),
    (65536, 16384, "cluster_dit", 8), (10000, 2500, "cluster_mixed", 2),
    (20000, 5000, "cluster_mixed", 4), (40000, 10000, "cluster_mixed", 8),
    (12000, 3000, "cluster_mixed", 2), (60000, 15000, "cluster_mixed", 8),
    (14000, 3500, "cluster_mixed", 2), (56000, 14000, "cluster_mixed", 8),
    (11264, 2816, "cluster", 4), (22000, 5500, "cluster", 8),
    (20250, 10125, "cluster_mixed", 3), (10125, 3375, "cluster_mixed", 3),
    (40002, 20001, "cluster", 16), (11025, 2205, "cluster_mixed", 3),
    (44100, 11025, "cluster_mixed", 6), (16807, 2401, "cluster_mixed", 7),
    (30870, 6174, "cluster_mixed", 5), (9999, 1111, "cluster", 4),
    (46875, 9375, "cluster", 16),
])
def test_istft_cluster_routes(nfft, hop, route, cluster):
    """istft_plan's route past 8192: the direct transform ("cluster_dit")
    on nfft / 8192 blocks at the powers of two (the reference's 16 384 and
    32 768, and 65 536), the same on the 7-smooth block core
    ("cluster_mixed") on C = 2 to 8 blocks at the sizes that won their A/B
    (ISTFT_MIXED_WON: 10 000, 12 000, 14 000, 20 000, 40 000, 56 000,
    60 000, and on 3, 5, 6 or 7 blocks 10 125, 11 025, 20 250, 30 870,
    44 100, 16 807, ...), Bluestein's cluster ("cluster") on M / 8192 blocks
    at the rest (a prime past 7, a 7-smooth size past 8 blocks);
    Bluestein's plan still exists at the direct sizes, for the forced
    A/B."""
    plan = fp.istft_plan(2, 100, nfft, nfft, hop)
    assert (plan.route, plan.cluster) == (route, cluster)
    blue = fp.istft_cluster_plan(2, 100, nfft, nfft, hop)
    assert (blue.route, blue.cluster) == ("cluster", fp.cluster_blocks(nfft))
    if route == "cluster":
        assert blue == plan and nfft not in fp.ISTFT_MIXED_WON
    elif route == "cluster_mixed":
        assert plan == fp.istft_cluster_mixed_plan(2, 100, nfft, nfft, hop)
        assert nfft in fp.ISTFT_MIXED_WON and fp.mixed_factors(nfft)[0] == cluster
        with pytest.raises(ValueError, match="no iSTFT cluster_dit plan"):
            fp.istft_cluster_dit_plan(2, 100, nfft, nfft, hop)
    else:
        with pytest.raises(ValueError, match="no iSTFT cluster_dit plan"):
            fp.istft_cluster_dit_plan(2, 100, nfft + 2, nfft + 2, hop)


MIXED_SIZES = [n for n in range(fp.MAX_NFFT + 1, fp.CLUSTER_NFFT + 1) if fp.mixed_factors(n)]
# the sizes on clusters of 2, 4 and 8 blocks (the rule's first choice of C)
MIXED_POW2_SIZES = [n for n in MIXED_SIZES if fp.mixed_factors(n)[0] in (2, 4, 8)]


def test_mixed_factors_sizes():
    """mixed_factors takes 281 sizes past 8192. 204 even ones on C the
    fewest of 2, 4, 8 blocks that makes n <= 8192, n one of the 68 7-smooth
    numbers in (4096, 8192) off the powers of two: the 87 sizes of 29
    5-smooth n, and 117 of 39 n with a factor 7 (14 000, 28 000, 56 000 of
    7000). 33 of those have an odd n (eleven n, each at C 2, 4 and 8),
    which the core serves with its whole n-point table (no quarter turns);
    every n other than those that is not a multiple of 4 too (4374, 4410,
    6250, ...). Exactly the even sizes whose n = N / C is 7-smooth, C that
    rule's; the other 77 in test_mixed_factors_other_clusters."""
    assert len(MIXED_SIZES) == 281 and len(MIXED_POW2_SIZES) == 204
    assert {10_000, 12_000, 14_000, 15_000, 20_000, 24_000, 28_000, 30_000, 40_000, 48_000,
            56_000, 60_000} <= set(MIXED_POW2_SIZES)
    ns = sorted({fp.mixed_factors(n)[1] for n in MIXED_POW2_SIZES})
    assert len(ns) == 68 and {5000, 7000, 4375, 7203, 4116} <= set(ns)
    assert all(4096 < n < 8192 for n in ns)
    assert all(n & (n - 1) and fp.smooth7(n) for n in ns)
    assert len([n for n in ns if fp.smooth7(n) and n % 7]) == 29
    for nfft in range(fp.MAX_NFFT + 2, fp.CLUSTER_NFFT + 1, 2):
        c = 2 if nfft <= 16384 else 4 if nfft <= 32768 else 8
        want = (nfft & (nfft - 1) and nfft % c == 0 and fp.smooth7(nfft // c))
        assert (fp.mixed_factors(nfft) == (c, nfft // c)) if want else (
            fp.mixed_factors(nfft) is None or fp.mixed_factors(nfft)[0] not in (2, 4, 8)), nfft
    odd = [nfft for nfft in MIXED_POW2_SIZES if fp.mixed_factors(nfft)[1] % 2]
    assert len(odd) == 33 and {11_250, 12_150, 13_122, 8750, 14_406, 57_624} <= set(odd)
    assert sorted({fp.mixed_factors(n)[1] for n in odd}) == [
        4375, 4725, 5103, 5145, 5625, 6075, 6125, 6561, 6615, 7203, 7875]
    assert [n for n in ns if n % 4 == 2] == [4374, 4410, 4802, 5250, 5670, 6174, 6250, 6750,
                                             7290, 7350, 7938]
    assert [fp.mixed_factors(n) for n in (10_000, 20_000, 40_000)] == [(2, 5000), (4, 5000),
                                                                        (8, 5000)]
    assert [fp.mixed_factors(n) for n in (14_000, 28_000, 56_000)] == [(2, 7000), (4, 7000),
                                                                        (8, 7000)]


@pytest.mark.parametrize("nfft,why", [
    (8192, "a power of two on the core"), (16384, "a power of two: cluster_dit"),
    (65536, "a power of two: cluster_dit"), (10_002, "a prime past 5 (1667)"),
    (11_264, "2^10 · 11: a prime past 7"), (22_000, "2^4 · 5^3 · 11: a prime past 7"),
    (9_999, "3^2 · 11 · 101: a prime past 7"), (8_100, "on the core's Bluestein"),
    (46_875, "3 · 5^6: none of 6, 7, 8 blocks divides it"),
    (59_049, "3^10: 8 blocks do not divide it"),
    (64_827, "3^3 · 7^4: 8 blocks do not divide it"),
    (62_500, "2^2 · 5^6: 8 blocks do not divide it"),
    (65_538, "past the cluster"), (70_000, "past the cluster"),
])
def test_mixed_factors_refuses(nfft, why):
    """Sizes the mixed cluster leaves alone: Bluestein's cluster keeps the
    sizes past 8192 off the 7-smooth ones and the 13 7-smooth ones that
    need more than 8 blocks, the powers of two stay on the direct cluster."""
    assert fp.mixed_factors(nfft) is None, why
    with pytest.raises(ValueError, match="no iSTFT cluster_mixed plan"):
        fp.istft_cluster_mixed_plan(1, 40, nfft, min(nfft, 8192), min(nfft, 8192) // 4)
    if fp.cluster_supported(nfft):
        route = fp.istft_plan(1, 40, nfft, nfft, nfft // 4 if nfft % 4 == 0 else nfft).route
        assert route == ("cluster_dit" if nfft & (nfft - 1) == 0 else "cluster")


def test_mixed_factors_other_clusters():
    """The 77 7-smooth sizes past 8192 that no cluster of 2, 4 or 8 holds
    take the fewest blocks from ceil(N / 8192) to 8 that divide N: 25 on 3,
    27 on 5, 8 on 6 and 17 on 7; 40 of them odd (the iSTFT's alone). The 44.1
    kHz windows of 250 ms, 500 ms and 1 s among them, and 39 366 = 2 · 3^9;
    13 more 7-smooth sizes would need more than 8 blocks and stay None."""
    other = [n for n in MIXED_SIZES if fp.mixed_factors(n)[0] not in (2, 4, 8)]
    assert len(other) == 77 and sum(n % 2 for n in other) == 40
    assert collections.Counter(fp.mixed_factors(n)[0] for n in other) == {3: 25, 5: 27, 6: 8,
                                                                          7: 17}
    assert [fp.mixed_factors(n) for n in (11_025, 22_050, 44_100, 39_366)] == [
        (3, 3675), (3, 7350), (6, 7350), (6, 6561)]
    assert [fp.mixed_factors(n) for n in (30_870, 33_075, 39_690, 16_807, 12_005, 15_625)] == [
        (5, 6174), (5, 6615), (5, 7938), (7, 2401), (5, 2401), (5, 3125)]
    assert [fp.mixed_factors(n) for n in (10_125, 20_250, 40_500)] == [(3, 3375), (3, 6750),
                                                                       (5, 8100)]
    for nfft in other:
        c, n = fp.mixed_factors(nfft)
        assert c * n == nfft and n <= fp.MAX_NFFT and fp.smooth7(n)
        assert all(nfft % b for b in range(-(-nfft // fp.MAX_NFFT), c))
    left = [n for n in range(fp.MAX_NFFT + 1, fp.CLUSTER_NFFT + 1)
            if fp.smooth7(n) and n & (n - 1) and fp.mixed_factors(n) is None]
    assert left == [46_875, 50_625, 54_675, 56_250, 59_049, 59_535, 60_025, 60_750, 61_236,
                    61_250, 61_740, 62_500, 64_827]
    assert fp.mixed_factors(59_049) is None


@pytest.mark.parametrize("n", sorted({fp.mixed_factors(n)[1] for n in MIXED_SIZES}) + [
    60, 90, 135, 250, 2, 3, 5, 16, 81, 7, 14, 49, 70, 245, 343])
def test_mixed_radices(n):
    """The core's passes multiply to n, each a radix the kernel has, radix
    16 while four factors of two remain and one pass for the rest of the
    power of two; the schedule packs them 5 bits a pass, the first lowest,
    as istft_cluster_mixed_launch reads them."""
    rad = fp.mixed_radices(n)
    assert math.prod(rad) == n and set(rad) <= set(fp.MIXED_RADICES)
    twos = [r for r in rad if r in (2, 4, 8, 16)]
    assert twos == sorted(twos, reverse=True) and twos.count(2) + twos.count(4) + twos.count(
        8) <= 1
    sched = fp.mixed_schedule(rad)
    back = []
    while sched:
        back.append(sched & 31)
        sched >>= fp.MIXED_RADIX_BITS
    assert tuple(back) == rad


def test_mixed_radices_refuses():
    for n in (1, 11, 22, 4104):  # 4104 = 2^3 · 3^3 · 19
        with pytest.raises(ValueError, match="no mixed-radix passes"):
            fp.mixed_radices(n)
    assert fp.mixed_radices(5000) == (8, 5, 5, 5, 5) and fp.mixed_radices(6561) == (9, 9, 9, 9)
    # radix 7 after 5, before 9 and 3, as mixed_fft runs them
    assert fp.mixed_radices(7000) == (8, 5, 5, 5, 7) and fp.mixed_radices(7203) == (7, 7, 7, 7, 3)
    assert fp.mixed_radices(4375) == (5, 5, 5, 5, 7) and fp.mixed_radices(4116) == (4, 7, 7, 7, 3)
    assert fp.mixed_radices(8064) == (16, 8, 7, 9)


@pytest.mark.parametrize("signals,nf,nfft,win,hop", [
    (1, 532, 10_000, 10_000, 2500), (1, 267, 20_000, 20_000, 5000),
    (1, 135, 40_000, 40_000, 10_000), (4, 460, 12_000, 12_000, 3000), (2, 90, 60_000, 60_000, 6000),
    (1, 300, 11_250, 11_250, 1250), (3, 40, 45_000, 22_500, 2500), (1, 200, 10_000, 10_000, 2),
    (1, 602, 11_025, 11_025, 2205), (1, 302, 22_050, 22_050, 4410),  # odd, C 3; C 3
    (1, 122, 44_100, 44_100, 11_025), (2, 60, 16_807, 16_807, 2401),  # C 6; odd, C 7
    (1, 135, 30_870, 30_870, 6174),                                   # C 5
])
def test_istft_cluster_mixed_plan(signals, nf, nfft, win, hop):
    """istft_cluster_mixed_plan mirrors istft_cluster_mixed_launch: C and n
    of mixed_factors, one pair a round, a cluster owning 2 · rounds − (k −
    1) hop rows, each block the n-point table, the n-point exchange buffer
    and the carry of its 1/C of the columns within shared memory, the
    fewest waves × rounds (CLUSTERS_AT_ONCE[C] a wave)."""
    plan = fp.istft_cluster_mixed_plan(signals, nf, nfft, win, hop)
    c, n = fp.mixed_factors(nfft)
    k = win // hop
    assert (plan.route, plan.cluster, plan.groups, plan.threads) == ("cluster_mixed", c, 1, 512)
    assert plan.rows == 2 * plan.rounds - (k - 1) >= 1
    assert plan.blocks_per_signal * plan.rows >= nf + k - 1
    assert plan.blocks == signals * plan.blocks_per_signal * c
    carry = (k - 1) * -(-hop // c)
    assert plan.smem_bytes == 8 * (n + n + n // 16) + 4 * carry <= fp.SMEM_MAX
    assert plan.smem_bytes == fp.cluster_mixed_smem_bytes(n, carry)

    def cost(rounds):
        rows = 2 * rounds - (k - 1)
        per = -(-(nf + k - 1) // rows)
        return -(-signals * per // fp.CLUSTERS_AT_ONCE[c]) * rounds

    assert all(cost(plan.rounds) <= cost(r) for r in range(-(-k // 2), 300)
               if 2 * r - (k - 1) >= 1)


def test_istft_plan_mixed_routes():
    """istft_plan takes the mixed cluster exactly at the sizes of
    ISTFT_MIXED_WON (each a mixed_factors size, won on the card), Bluestein's
    cluster at the other 7-smooth sizes and every other even size off the
    powers of two; the powers of two stay on the direct cluster; Bluestein's
    plan and the mixed plan exist at every mixed size, for the forced A/B."""
    assert fp.ISTFT_MIXED_WON <= set(MIXED_SIZES)
    for nfft in MIXED_SIZES:
        hop = nfft // next(k for k in (4, 5, 3, 7) if nfft % k == 0)
        plan = fp.istft_plan(1, 100, nfft, nfft, hop)
        won = nfft in fp.ISTFT_MIXED_WON
        assert (plan.route, plan.cluster) == (
            ("cluster_mixed", fp.mixed_factors(nfft)[0]) if won
            else ("cluster", fp.cluster_blocks(nfft)))
        assert fp.istft_cluster_plan(1, 100, nfft, nfft, hop).route == "cluster"
        assert fp.istft_cluster_mixed_plan(1, 100, nfft, nfft, hop).route == "cluster_mixed"
    for nfft in (16384, 32768, 65536):
        assert fp.istft_plan(1, 100, nfft, nfft, nfft // 4).route == "cluster_dit"


def test_istft_cluster_main_plans():
    """The smoke's W 10 000, hop 2500 (one signal, nf 532) on Bluestein's
    cluster (forced there since the mixed one won): eleven rounds for 19
    rows, 29 clusters of 4, one wave of the card's 30; W 20 000, hop 5000
    (nf 267): 15 clusters of 8, the card's 15, eleven rounds. istft_plan's
    mixed cluster at the same shapes: 60 clusters of 2 (one wave of 66) and
    30 of 4 (the card's 30), six rounds for 9 rows; at W 40 000, hop 10 000
    (nf 135) 13 clusters of 8, seven rounds for 11 rows."""
    a = fp.istft_cluster_plan(1, 532, 10000, 10000, 2500)
    assert (a.cluster, a.rounds, a.rows, a.blocks_per_signal, a.blocks) == (4, 11, 19, 29, 116)
    b = fp.istft_cluster_plan(1, 267, 20000, 20000, 5000)
    assert (b.cluster, b.rounds, b.rows, b.blocks_per_signal, b.blocks) == (8, 11, 19, 15, 120)
    shapes = [(532, 10000, 2500, (2, 6, 9, 60, 120)), (267, 20000, 5000, (4, 6, 9, 30, 120)),
              (135, 40000, 10000, (8, 7, 11, 13, 104))]
    for nf, nfft, hop, want in shapes:
        m = fp.istft_plan(1, nf, nfft, nfft, hop)
        assert m.route == "cluster_mixed"
        assert (m.cluster, m.rounds, m.rows, m.blocks_per_signal, m.blocks) == want


def test_cluster_envelope():
    """The cluster takes 8193–65 536 points (M 32 768 on 4 blocks up to 16
    384, 65 536 on 8 up to 32 768, 131 072 on 16 past it), both directions;
    8192 stays on the FFT core and past 65 536 the dense DFT (forward)
    serves and the direct sum (inverse) refuses: its table and spectrum do
    not fit shared memory."""
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_supported

    assert not fp.cluster_supported(8192) and fp.fft_supported(8192)
    assert fp.cluster_supported(8193) and fp.cluster_supported(65536)
    assert not fp.cluster_supported(65537)
    assert [fp.cluster_blocks(n) for n in (8193, 16384, 16385, 32768, 32769, 65536)] == [
        4, 4, 8, 8, 16, 16]
    for n in (8192, 65537, 80000):
        with pytest.raises(ValueError, match="no cluster plan"):
            fp.cluster_plan(1, 4, n, n, n)
    with pytest.raises(ValueError, match="no cluster plan"):
        fp.cluster_plan(1, 4, 10000, 10001, 10001)  # a window past nfft
    assert fp.istft_plan(1, 4, 8192, 8192, 2048).cluster == 1
    assert fp.istft_plan(1, 4, 8194, 8194, 4097).cluster == 4
    assert fp.istft_plan(1, 4, 32768, 32768, 4096).cluster == 4  # the direct transform's
    assert fp.istft_cluster_plan(1, 4, 32768, 32768, 4096).cluster == 8
    assert fp.istft_plan(1, 4, 32770, 32770, 16385).cluster == 16
    assert fp.istft_plan(1, 4, 65536, 65536, 16384).cluster == 8
    assert fp.istft_cluster_plan(1, 4, 65536, 65536, 16384).cluster == 16
    assert istft_supported(8194, 8194, 4097) and istft_supported(32768, 32768, 4096)
    assert istft_supported(32770, 32770, 16385) and istft_supported(65536, 65536, 16384)
    assert istft_supported(8193, 8193, 8193) and istft_supported(65535, 65535, 13107)  # odd
    assert not fp.cluster_supported(65538) and fp.level2_supported(65538)
    assert istft_supported(65538, 65538, 32769)  # the second level
    with pytest.raises(ValueError, match="no iSTFT cluster plan"):
        fp.istft_cluster_plan(1, 4, 8193 * 8, 8192, 2048)


def test_level_matches_torch_fft(rng):
    """Both directions of the level at 16 384 points against torch.fft.fft:
    decimation in time in natural order, decimation in frequency in
    dif_order; and the level's 8192-point table, which each block takes
    from the even entries of the 16 384-point one, is the 8192-point
    twiddle table bit for bit (the same float64 angles, rounded once)."""
    z = torch.from_numpy(rng.standard_normal((2, LEVEL)) + 1j * rng.standard_normal((2, LEVEL)))
    want = torch.fft.fft(z)
    tol = 1e-6 * want.abs().max().item()
    torch.testing.assert_close(level_fft(z), want, atol=tol, rtol=0)
    torch.testing.assert_close(level_fft_dif(z)[..., dif_order(LEVEL)], want, atol=tol, rtol=0)
    assert np.array_equal(fp.twiddle_table(LEVEL)[::2], fp.twiddle_table(fp.MAX_NFFT))
    assert torch.equal(fp.twiddles(LEVEL, "cpu")[::2], fp.twiddles(fp.MAX_NFFT, "cpu"))


def test_level_float32_matches_torch_fft(rng):
    """The level in complex64 as the kernel runs it, against torch.fft.fft
    in float64: within 3e-6 of the peak (two more stages of rounding than
    the core's 8192 points)."""
    z = rng.standard_normal((2, LEVEL)) + 1j * rng.standard_normal((2, LEVEL))
    want = torch.fft.fft(torch.from_numpy(z))
    got = level_fft(torch.from_numpy(z.astype(np.complex64))).to(torch.complex128)
    assert (got - want).abs().max().item() <= 3e-6 * want.abs().max().item()


@pytest.mark.parametrize("nfft", BLUESTEIN_SIZES)
def test_bluestein_matches_torch_fft(rng, nfft):
    z = rng.standard_normal((3, nfft)) + 1j * rng.standard_normal((3, nfft))
    got = bluestein_fft(torch.from_numpy(z))
    want = torch.fft.fft(torch.from_numpy(z))
    torch.testing.assert_close(got, want, atol=1e-6 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("nfft,win,hop,B,length", [
    (18, 18, 9, 2, 300), (432, 432, 108, 1, 4000), (1000, 1000, 250, 2, 14336),
    (1001, 1001, 143, 1, 3000),   # odd: the partner of bin k is N - k
    (1792, 1792, 448, 1, 9000), (4000, 4000, 1000, 1, 12001),
    (1000, 800, 200, 1, 5000),    # nfft past the window
    (4097, 4097, 241, 1, 2000),   # M 16 384: the level
    (6000, 6000, 1500, 1, 6000),  # the smoke's W and hop
    (8190, 8190, 2730, 1, 5000),
    (8191, 8191, 1, 1, 3),        # odd, the level's largest
])
def test_bluestein_stft_matches_stft_pallas_plain(rng, nfft, win, hop, B, length):
    x = torch.from_numpy((0.3 * rng.standard_normal((B, length))).astype(np.float32))
    w = sinebell(win)
    got = core_stft(x, w, hop, nfft, fft=bluestein_fft)
    re, im = stft_pallas_plain(x, w, hop, nfft)
    peak = max(re.abs().max().item(), im.abs().max().item())
    torch.testing.assert_close(got.real, re, atol=1e-5 * peak, rtol=0)
    torch.testing.assert_close(got.imag, im, atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("nfft", BLUESTEIN_SIZES)
def test_bluestein_tables(nfft):
    """The chirp within one float32 rounding of float64 np.exp (its phase
    reduced exactly from the integer t²), Ĉ / M within float32 rounding of
    the float64 FFT of the wrapped chirp; made once per (nfft, device)."""
    chirp, chat = fp.bluestein_tables(nfft, "cpu")
    assert fp.bluestein_tables(nfft, "cpu")[0] is chirp
    M = fp.bluestein_size(nfft)
    assert chirp.shape == (nfft, 2) and chat.shape == (M, 2) and chirp.dtype == torch.float32
    assert M >= 2 * nfft - 1 and M // 2 < 2 * nfft - 1 and M & (M - 1) == 0
    t = np.arange(nfft)
    c = np.exp(1j * np.pi * t.astype(np.float64) ** 2 / nfft)
    got = chirp[:, 0].double().numpy() + 1j * chirp[:, 1].double().numpy()
    assert np.abs(got - np.conj(c)).max() < 1.2e-7
    wrapped = np.zeros(M, np.complex128)
    wrapped[:nfft], wrapped[M - nfft + 1:] = c, c[1:][::-1]
    want = np.fft.fft(wrapped) / M
    ghat = chat[:, 0].double().numpy() + 1j * chat[:, 1].double().numpy()
    assert np.abs(ghat - want).max() <= 1e-7 * np.abs(want).max()


@pytest.mark.parametrize("signals,nf,nfft,win,hop", [
    (32, 60, 1000, 1000, 250), (1, 3, 1000, 1000, 250), (2, 40, 1001, 1001, 143),
    (4, 200, 18, 18, 9), (32, 60, 432, 432, 108), (2, 30, 1792, 1792, 448),
    (3, 20, 4000, 4000, 1000), (64, 500, 4000, 4000, 1000), (5, 50, 1000, 800, 200),
])
def test_bluestein_plan(signals, nf, nfft, win, hop):
    """bluestein_plan mirrors stft_bluestein_launch: groups of M/16 threads,
    the fewest that make the block whole warps (one from M 512 on), shared
    memory the launcher's (stft_block's smem_bytes at M points),
    within the card's; the grid covers every frame pair."""
    plan = fp.bluestein_plan(signals, nf, nfft, win, hop)
    M = plan.m
    assert M == fp.bluestein_size(nfft) and M >= 2 * nfft - 1 and M <= fp.MAX_NFFT
    t = fp.threads_per_fft(M)
    g = plan.ffts_per_block
    assert g == max(1, 32 // t) and plan.threads == g * t
    assert plan.threads % 32 == 0 and plan.threads <= fp.MAX_THREADS
    span = fp.span_floats(2 * g, win, hop)
    assert plan.smem_bytes == 4 * span + 8 * (M // 4 + M // 64 + g * (M + M // 16))
    assert plan.smem_bytes == fp.smem_bytes(M, win, hop, g) <= fp.SMEM_MAX
    per = plan.blocks_per_signal
    assert per * 2 * g >= nf > (per - 1) * 2 * g and plan.blocks == signals * per


def test_bluestein_main_plan():
    """The smoke's W 1000, hop 250, B 32 (60 frames): M 2048, one transform
    of 128 threads a block, 960 blocks."""
    plan = fp.bluestein_plan(32, num_frames(14336, 250), 1000, 1000, 250)
    assert (plan.m, plan.ffts_per_block, plan.threads, plan.blocks) == (2048, 1, 128, 960)


def test_bluestein_routing():
    """The sizes the split refuses up to 8192 go to Bluestein (1000, 7 · 256,
    25 · 64, 27 · 16, odd sizes; past 4096 on the level: 4097, 6000, 8191);
    powers of two and split sizes go to their own kernels, and sizes past
    8192 (3 · 4096, 8193) to Bluestein on a cluster, not to the one-block
    kernel."""
    for n in (1000, 7 * 256, 25 * 64, 27 * 16, 1001, 18, 4000, 4095, 4097, 6000, 8190, 8191):
        assert fp.bluestein_supported(n) and not fp.split_supported(n)
        assert not fp.fft_supported(n)
        assert (fp.bluestein_size(n) == 2 * fp.MAX_NFFT) == (n > 4096)
    for n in (3 * 4096, 8193, 10_000, 1024, 768, 8192, 48, 6144):
        assert not fp.bluestein_supported(n)
        assert fp.cluster_supported(n) == (n > 8192)
        with pytest.raises(ValueError, match="no Bluestein plan"):
            fp.bluestein_plan(1, 10, n, n, n // 2)
    assert fp.split_supported(6144) and fp.fft_supported(8192)


@pytest.mark.parametrize("signals,nf,nfft,win,hop", [
    (32, 12, 6000, 6000, 1500), (1, 3, 4097, 4097, 241), (2, 40, 8191, 8191, 8191),
    (3, 20, 8190, 4095, 5), (64, 500, 6000, 3000, 1500),
])
def test_bluestein_level_plan(signals, nf, nfft, win, hop):
    """bluestein_plan on the level mirrors stft_bluestein_launch: one group
    of 512 threads a block, two frames, shared memory the 8192- and 16
    384-point quarter tables and one 16 384-point exchange buffer (191 488
    bytes, whatever the window and hop: the frames are read from global
    memory), one block an SM."""
    plan = fp.bluestein_plan(signals, nf, nfft, win, hop)
    assert plan.m == 2 * fp.MAX_NFFT and fp.bluestein_threads(plan.m) == fp.MAX_THREADS
    assert (plan.ffts_per_block, plan.threads) == (1, 512)
    assert plan.smem_bytes == 8 * ((2048 + 128) + (4096 + 256) + (16384 + 1024)) == 191_488
    assert plan.smem_bytes == fp.bluestein_smem_bytes(nfft, win, hop, 1) <= fp.SMEM_MAX
    assert fp.blocks_per_sm(plan.smem_bytes, plan.threads) == 1
    assert plan.blocks_per_signal == -(-nf // 2) and plan.blocks == signals * plan.blocks_per_signal


def test_bluestein_level_main_plan():
    """The smoke's W 6000, hop 1500, B 32 (12 frames): 6 pairs a signal,
    192 blocks of 512 threads."""
    plan = fp.bluestein_plan(32, num_frames(14336, 1500), 6000, 6000, 1500)
    assert (plan.m, plan.ffts_per_block, plan.threads, plan.blocks) == (16384, 1, 512, 192)


# -- the forward mirror's bits, before and after the inverse direction ------

# sha256 (first 16 hex digits) of core_fft on fixed complex64 inputs, taken
# from the forward mirror as it was before fft_common.cuh gained the inverse
# direction: the forward passes must give the same bits
FORWARD_DIGESTS = {16: "1762398c0f6c32bc", 256: "b77c76d9182ff21e",
                   1024: "03536b271c804858", 4096: "6f8d0e98ecdbce29"}


@pytest.mark.parametrize("nfft", sorted(FORWARD_DIGESTS))
def test_forward_mirror_bits_unchanged(nfft):
    import hashlib

    r = np.random.default_rng(nfft)
    z = (r.standard_normal((2, nfft)) + 1j * r.standard_normal((2, nfft))).astype(np.complex64)
    out = core_fft(torch.from_numpy(z)).numpy().tobytes()
    assert hashlib.sha256(out).hexdigest()[:16] == FORWARD_DIGESTS[nfft]


# -- the inverse kernel (csrc/istft.cu) ----------------------------------------


def inverse_input(re_a, im_a, re_b, im_b):
    """fft_common.cuh::inverse_input for every point at once: conj Z[k] of
    Z = A + iB, bins past Nyquist from the mirrored bin, DC and Nyquist
    imaginary parts ignored. (..., bins) float → (..., N) complex."""
    bins = re_a.shape[-1]
    N = 2 * (bins - 1)
    k = torch.arange(N)
    mirrored = k > N // 2
    kk = torch.where(mirrored, N - k, k)
    edge = (kk == 0) | (kk == N // 2)
    ar, br = re_a[..., kk], re_b[..., kk]
    ai = torch.where(edge, 0.0, im_a[..., kk])
    bi = torch.where(edge, 0.0, im_b[..., kk])
    return torch.where(mirrored, torch.complex(ar + bi, ai - br),
                       torch.complex(ar - bi, -(ai + br)))


def core_istft(re, im, window, hop, length, nfft, fft=core_fft):
    """istft_fft_kernel in float32 (``fft``: split_fft for
    istft_split_block, whose staged rows change where the points are read
    from, not their values): frames f, f + 1 ride one transform run
    backwards through the forward core (conjugated in and out), windowed
    with window / nfft; each output sample sums its frames in ascending
    frame order (the carry plus a round's frames, left to right), times the
    inverse window-power envelope, win/2 front trim. (B, nf, bins) → (B, L)."""
    from convsep_tpu_torch.dsp.dft import _key, inverse_norm

    W = len(window)
    k = W // hop
    B, nf, _ = re.shape
    pad = nf % 2
    re2 = torch.nn.functional.pad(re, (0, 0, 0, pad))
    im2 = torch.nn.functional.pad(im, (0, 0, 0, pad))
    zz = fft(inverse_input(re2[:, 0::2], im2[:, 0::2], re2[:, 1::2], im2[:, 1::2]))
    wn = torch.from_numpy((np.asarray(window, np.float64) / nfft).astype(np.float32))
    frames = torch.stack([zz.real[..., :W] * wn, -zz.imag[..., :W] * wn], 2)
    frames = frames.flatten(1, 2)[:, :nf]  # (B, nf, W)
    rows = nf + k - 1
    acc = torch.zeros(B, rows, hop)
    for i in range(k - 1, -1, -1):  # frame f = row - i: ascending f
        acc[:, i:i + nf] += frames[..., i * hop:(i + 1) * hop]
    inv = inverse_norm(_key(np.asarray(window, np.float32)), hop, nf, "cpu")
    out = acc.reshape(B, -1) * inv
    return out[:, W // 2:W // 2 + length]


@pytest.mark.parametrize("nfft", [16, 64, 256, 1024, 4096])
def test_inverse_core_matches_irfft(rng, nfft):
    bins = nfft // 2 + 1
    re = torch.from_numpy(rng.standard_normal((2, 3, bins)))
    im = torch.from_numpy(rng.standard_normal((2, 3, bins)))
    zz = core_fft(inverse_input(re[0], im[0], re[1], im[1]))
    a = torch.fft.irfft(torch.complex(re[0], im[0]), n=nfft)  # ignores DC/Nyquist imag
    b = torch.fft.irfft(torch.complex(re[1], im[1]), n=nfft)
    scale = a.abs().max().item() * nfft
    torch.testing.assert_close(zz.real / nfft, a, atol=1e-6 * scale / nfft, rtol=0)
    torch.testing.assert_close(-zz.imag / nfft, b, atol=1e-6 * scale / nfft, rtol=0)


@pytest.mark.parametrize("nfft,win,hop,nf,ct", [
    (256, 256, 64, 9, True), (256, 256, 128, 8, False), (1024, 1024, 512, 7, False),
    (1024, 1024, 256, 10, True), (4096, 4096, 1024, 7, True), (4096, 4096, 1024, 6, False),
    (256, 128, 32, 9, False),
])
def test_core_istft_matches_plain(rng, nfft, win, hop, nf, ct):
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import istft_ct_pallas_plain
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas_plain

    length = (nf - 2) * hop
    w = sinebell(win)
    bins = nfft // 2 + 1
    re = torch.from_numpy(rng.standard_normal((2, nf, bins)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((2, nf, bins)).astype(np.float32))
    got = core_istft(re, im, w, hop, length, nfft)
    if ct:
        want = istft_ct_pallas_plain(re, im, w, hop, length)
    else:
        want = istft_pallas_plain(re, im, w, hop, length, nfft=nfft)
    peak = want.abs().max().item()
    torch.testing.assert_close(got, want, atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("nfft,win,hop,nf", [
    (48, 48, 12, 9), (240, 240, 60, 8), (768, 768, 256, 7), (768, 640, 160, 8),
    (1280, 1280, 320, 6), (2304, 2304, 576, 7), (6144, 6144, 1536, 6),
])
def test_split_istft_matches_plain(rng, nfft, win, hop, nf):
    """istft_split_block's transform (the split run backwards by
    conjugation on inverse_input's points) and the rounds' gather, against
    istft_pallas_plain within 1e-5 × max|out|."""
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas_plain

    length = (nf - 2) * hop
    w = sinebell(win)
    bins = nfft // 2 + 1
    re = torch.from_numpy(rng.standard_normal((2, nf, bins)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((2, nf, bins)).astype(np.float32))
    got = core_istft(re, im, w, hop, length, nfft, fft=split_fft)
    want = istft_pallas_plain(re, im, w, hop, length, nfft=nfft)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("nfft,win,hop,nf", [
    (18, 18, 9, 9), (1000, 1000, 250, 8), (1000, 800, 200, 9), (1792, 1792, 448, 7),
    (4000, 4000, 1000, 6), (6000, 6000, 1500, 6), (8190, 8190, 2730, 5),
])
def test_bluestein_istft_matches_plain(rng, nfft, win, hop, nf):
    """istft_bluestein_block's transform (Bluestein run backwards: the DFT
    of inverse_input's conj Z, on the core up to M 8192 and on the level
    past 4096 points) and the rounds' gather, against istft_pallas_plain
    within 1e-5 × max|out|."""
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas_plain

    length = (nf - 2) * hop
    w = sinebell(win)
    bins = nfft // 2 + 1
    re = torch.from_numpy(rng.standard_normal((2, nf, bins)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((2, nf, bins)).astype(np.float32))
    got = core_istft(re, im, w, hop, length, nfft, fft=bluestein_fft)
    want = istft_pallas_plain(re, im, w, hop, length, nfft=nfft)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)


# (signals, nf, nfft, win, hop) of every iSTFT launch: the CUDA tests'
# cases, chip_smoke.py's phase 7 and both slices (stereo highres4096's 8
# signals, the dsd100 pallas route's 4), and each preset's whole track
ISTFT_LAUNCHES = [
    (3, num_frames(6000, 64), 256, 256, 64), (8, num_frames(60000, 1024), 4096, 4096, 1024),
    (1, num_frames(20001, 512), 2048, 2048, 512), (1, num_frames(9000, 256), 1024, 1024, 256),
    (5, num_frames(7777, 64), 512, 512, 64), (4, num_frames(30000, 512), 1024, 1024, 512),
    (1, num_frames(3000, 64), 128, 128, 64), (2, num_frames(5000, 32), 256, 128, 32),
    (3, num_frames(6000, 96), 384, 384, 96), (2, num_frames(9000, 250), 1000, 1000, 250),
    (1, num_frames(40000, 1024), 4096, 4096, 1024), (4, 5170, 768, 768, 256),
    (4, 5170, 1000, 1000, 250), (3, num_frames(20000, 320), 1280, 1280, 320),
    (3, num_frames(20000, 576), 2304, 2304, 576), (1, num_frames(60000, 1536), 6144, 6144, 1536),
    (3, num_frames(5000, 12), 48, 48, 12), (2, num_frames(3000, 60), 240, 240, 60),
    (8, 1442, 4096, 4096, 1024), (4, 2882, 1024, 1024, 512),
    (4, 884, 6000, 6000, 1500), (4, 530, 10000, 10000, 2500), (2, num_frames(20000, 448), 1792,
                                                               1792, 448),
    (3, num_frames(9000, 9), 18, 18, 9), (1, 40, 8190, 8190, 910), (2, 60, 4000, 4000, 1000),
] + [(2, num_frames(8 * n, n // 4), n, n, n // 4) for n in (16, 32, 64, 128, 256, 512,
                                                          1024, 2048, 4096, 8192)] + [
    (s * p.model.num_sources,
     num_frames(bucket_length(30 * 44100, p), p.transform.hop_size),
     p.transform.nfft or p.transform.frame_size, p.transform.frame_size, p.transform.hop_size)
    for name in PRESETS for p in [get_preset(name)] for s in (1, 2)
]


@pytest.mark.parametrize("signals,nf,nfft,win,hop", ISTFT_LAUNCHES)
def test_istft_plan(signals, nf, nfft, win, hop):
    plan = fp.istft_plan(signals, nf, nfft, win, hop)
    k = win // hop
    assert plan.smem_bytes <= fp.SMEM_MAX
    assert plan.rows >= 1 and plan.blocks == signals * plan.blocks_per_signal * plan.cluster
    assert plan.blocks_per_signal * plan.rows >= nf + k - 1 > (plan.blocks_per_signal - 1) * plan.rows
    assert plan.halo == (k - 1) / plan.rows
    if plan.groups == 0:  # the direct sum: even sizes past the cluster's 32 768
        assert not fp.fft_supported(nfft) and plan.rows <= fp.DIRECT_MAX_ROWS
        assert nfft > fp.CLUSTER_NFFT and not fp.bluestein_supported(nfft)
        assert plan.smem_bytes == 16 * nfft + 4 * plan.rows * hop
        return
    if plan.cluster > 1:  # a cluster: sizes past 8192
        assert (plan.groups, plan.threads, plan.blocks_per_sm) == (1, fp.MAX_THREADS, 1)
        assert plan.rows == 2 * plan.rounds - (k - 1)
        carry = (k - 1) * -(-hop // plan.cluster)
        if plan.route == "cluster_mixed":  # the 5-smooth sizes that won their A/B
            c, n = fp.mixed_factors(nfft)
            assert nfft in fp.ISTFT_MIXED_WON and plan.cluster == c
            assert plan.smem_bytes == fp.cluster_mixed_smem_bytes(n, carry)
            return
        # Bluestein's, or the direct one at the powers of two
        assert fp.cluster_supported(nfft) and nfft not in fp.ISTFT_MIXED_WON
        assert plan.cluster == (nfft // fp.CLUSTER_PART if plan.route == "cluster_dit"
                                else fp.cluster_blocks(nfft)) <= 16
        assert plan.smem_bytes == fp.cluster_smem_bytes(carry)
        return
    assert plan.cluster == 1
    blue = fp.bluestein_supported(nfft)
    t = fp.bluestein_threads(fp.bluestein_size(nfft)) if blue else fp.threads_per_fft(nfft)
    g = plan.groups
    assert g & (g - 1) == 0 and plan.threads == g * t
    assert plan.threads % 32 == 0 and plan.threads <= fp.MAX_THREADS
    assert t <= 32 or g <= fp.MAX_NAMED_GROUPS
    assert plan.smem_bytes == fp.istft_smem_bytes(nfft, win, hop, g)
    # a block's rounds of 2g frames cover its rows and the k - 1 before
    assert plan.rows == 2 * g * plan.rounds - (k - 1)
    assert plan.halo <= fp.MAX_HALO
    assert plan.rounds == 1 or 2 * g * (plan.rounds - 1) - (k - 1) < (k - 1) / fp.MAX_HALO
    assert plan.blocks_per_sm == fp.blocks_per_sm(plan.smem_bytes, plan.threads)
    assert plan.blocks_per_sm >= 2 or plan.note


@pytest.mark.parametrize("signals,nf,nfft,hop,groups,rounds,rows,blocks,per_sm", [
    (8, 1442, 4096, 1024, 2, 5, 17, 680, 2),   # highres4096-stereo, 8 signals
    (4, 2882, 1024, 512, 8, 1, 15, 772, 3),    # dsd100 fft_impl="pallas", 4 stems
])
def test_istft_main_path_plans(signals, nf, nfft, hop, groups, rounds, rows, blocks, per_sm):
    plan = fp.istft_plan(signals, nf, nfft, nfft, hop)
    assert (plan.groups, plan.rounds, plan.rows, plan.blocks, plan.blocks_per_sm) == (
        groups, rounds, rows, blocks, per_sm)
    assert plan.halo <= 3 / 16 and plan.note == ""


@pytest.mark.parametrize("signals,nf,nfft,win,hop", [
    (4, 5170, 768, 768, 256), (3, num_frames(6000, 96), 384, 384, 96), (1, 9, 48, 48, 12),
    (2, 500, 240, 240, 60), (3, 70, 1280, 1280, 320), (2, 60, 2304, 2304, 576),
    (1, 42, 6144, 6144, 1536), (2, 80, 7680, 7680, 960), (4, 90, 768, 384, 96),
])
def test_istft_split_plan(signals, nf, nfft, win, hop):
    """istft_plan at the split's sizes mirrors istft_split_launch: the
    fewest groups of m · P/16 threads in whole warps (G · P/16 a multiple
    of 32), at most 512 threads, the P- and nfft-point quarter tables, the
    exchange buffers and the carry within shared memory."""
    plan = fp.istft_plan(signals, nf, nfft, win, hop)
    m, p = fp.split_factors(nfft)
    g, k = plan.groups, win // hop
    assert g == max(1, 32 // fp.threads_per_fft(p))
    assert plan.threads == g * m * fp.threads_per_fft(p)
    assert plan.threads % 32 == 0 and plan.threads <= fp.MAX_THREADS
    assert (g * fp.threads_per_fft(p)) % 32 == 0  # m is odd
    tables = (p // 4 + p // 64) + (nfft // 4 + nfft // 64)  # twiddle_len(P) + quarter_len(N)
    assert plan.smem_bytes == 8 * (tables + g * (nfft + nfft // 16)) + 4 * (k - 1) * hop
    assert plan.smem_bytes <= fp.SMEM_MAX
    assert plan.rows == 2 * g * plan.rounds - (k - 1) >= 1 and plan.halo <= fp.MAX_HALO
    assert plan.blocks_per_signal * plan.rows >= nf + k - 1


def test_istft_split_main_plan():
    """The smoke's W 768, hop 256 iSTFT (4 signals, nf 5170): 2 transforms
    of 48 threads a block, four rounds of 4 frames for 14 rows, 1480
    blocks, twelve a SM by shared memory and threads."""
    plan = fp.istft_plan(4, 5170, 768, 768, 256)
    assert (plan.groups, plan.threads, plan.rounds, plan.rows, plan.blocks,
            plan.blocks_per_sm) == (2, 96, 4, 14, 1480, 12)


@pytest.mark.parametrize("signals,nf,nfft,win,hop", [
    (4, 5294, 1000, 1000, 250), (2, 50, 18, 18, 9), (3, 70, 1792, 1792, 448),
    (2, 60, 4000, 4000, 1000), (4, 884, 6000, 6000, 1500), (1, 40, 8190, 8190, 910),
    (2, 30, 4098, 4098, 2049), (3, 90, 1000, 800, 200), (1, 10, 6000, 3000, 1500),
])
def test_istft_bluestein_plan(signals, nf, nfft, win, hop):
    """istft_plan at the Bluestein sizes mirrors istft_bluestein_launch: the
    fewest groups of bluestein_threads(M) in whole warps (one group of 512
    threads on the level), the tables (the M-point quarter table; on the
    level the 8192- and 16 384-point ones), the exchange buffers of M
    points and the carry within shared memory; the rounds by the 3/16 rule."""
    plan = fp.istft_plan(signals, nf, nfft, win, hop)
    M, k = fp.bluestein_size(nfft), win // hop
    assert fp.bluestein_supported(nfft) and M >= 2 * nfft - 1
    t = fp.bluestein_threads(M)
    assert plan.groups == max(1, 32 // t) and plan.threads == plan.groups * t
    assert plan.threads % 32 == 0 and plan.threads <= fp.MAX_THREADS
    tables = (2048 + 128) + (M // 4 + M // 64) if M > fp.MAX_NFFT else M // 4 + M // 64
    assert plan.smem_bytes == 8 * (tables + plan.groups * (M + M // 16)) + 4 * (k - 1) * hop
    assert plan.smem_bytes == fp.istft_smem_bytes(nfft, win, hop, plan.groups) <= fp.SMEM_MAX
    assert plan.rows == 2 * plan.groups * plan.rounds - (k - 1) >= 1
    assert plan.halo <= fp.MAX_HALO and plan.blocks_per_signal * plan.rows >= nf + k - 1
    if M > fp.MAX_NFFT:
        assert plan.groups == 1 and plan.blocks_per_sm == 1 and plan.note


def test_istft_bluestein_main_plans():
    """The smoke's W 1000, hop 250 (4 signals, nf 5294): one group of 128
    threads, ten rounds of 2 frames for 17 rows, 1248 blocks; W 6000, hop
    1500 (4 signals, nf 884) on the level: one group of 512 threads, 209
    488 bytes, ten rounds, 212 blocks, one a SM."""
    a = fp.istft_plan(4, 5294, 1000, 1000, 250)
    assert (a.groups, a.threads, a.rounds, a.rows, a.blocks, a.smem_bytes) == (
        1, 128, 10, 17, 1248, 24_760)
    b = fp.istft_plan(4, 884, 6000, 6000, 1500)
    assert (b.groups, b.threads, b.rounds, b.rows, b.blocks, b.smem_bytes, b.blocks_per_sm) == (
        1, 512, 10, 17, 212, 209_488, 1)


def test_istft_level_fits_every_window():
    """On the level the tables and the exchange take 191 488 bytes, and the
    carry (win/hop − 1) hop floats is under 32 KB for any win <= 8192: every
    (win, hop) with win/hop <= 9 fits, so no Bluestein size is refused."""
    worst = max(fp.istft_smem_bytes(8190, win, win // k, 1)
                for win in range(4098, 8191, 2) for k in range(1, 10) if win % k == 0)
    assert worst == 191_488 + 4 * 8 * 910 <= fp.SMEM_MAX


def test_istft_refusals_where_shared_memory_does_not_fit(monkeypatch):
    """istft_plan raises, and istft_supported says no, where a plan does not
    fit shared memory: the direct sum past 12 800 points (its table and
    spectrum alone), which serves only past the cluster's 65 536 (13 000,
    20 000 and 40 000 run on a cluster: Bluestein's at 13 000, the mixed
    one at the others), and, with the card's limit cut below the level's
    191 488 bytes, the level."""
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_supported

    for n in (13_000, 20_000, 40_000):
        assert fp.cluster_supported(n) and istft_supported(n, n, n // 4)
        assert fp.istft_plan(1, 10, n, n, n // 4).cluster == (
            fp.mixed_factors(n)[0] if n in fp.ISTFT_MIXED_WON else fp.cluster_blocks(n))
        with pytest.raises(ValueError, match="no iSTFT plan fits"):
            fp.istft_direct_plan(1, 10, n, n, n // 4)
    for n in (65_540, 80_000):  # past the cluster: the second level, no shared-memory table
        assert not fp.cluster_supported(n) and istft_supported(n, n, n // 4)
        assert fp.istft_plan(1, 10, n, n, n // 4) == (  # 80 000 = 16 · 5000 on the direct one
            fp.level2_direct_plan if n in fp.ISTFT_LEVEL2_DIRECT_WON else fp.level2_plan)(
                1, 10, n, n, n // 4)
    for n in (262_148, 300_000):  # past the second level: the direct sum's table does not fit
        assert not fp.level2_supported(n) and not istft_supported(n, n, n // 4)
        with pytest.raises(ValueError, match="no iSTFT plan fits"):
            fp.istft_plan(1, 10, n, n, n // 4)
    fp.istft_plan.cache_clear()
    monkeypatch.setattr(fp, "SMEM_MAX", 190_000)
    try:
        with pytest.raises(ValueError, match="no iSTFT plan fits"):
            fp.istft_plan(1, 10, 6000, 6000, 1500)
        assert not istft_supported(6000, 6000, 1500) and istft_supported(1000, 1000, 250)
    finally:
        fp.istft_plan.cache_clear()


def test_synthesis_tables_found_by_value():
    a = fp.synthesis_tables(sinebell(256), 256, 64, 20, "cpu")
    assert fp.synthesis_tables(sinebell(256), 256, 64, 20, "cpu") is a
    assert fp.synthesis_tables(sinebell(256), 256, 64, 21, "cpu") is not a
    torch.testing.assert_close(a[0], torch.from_numpy((sinebell(256) / 256).astype(np.float32)))
    tab = fp.dft_table(1000, "cpu").double()
    m = np.arange(1000)
    assert np.abs(tab[:, 0].numpy() + 1j * tab[:, 1].numpy() - np.exp(-2j * np.pi * m / 1000)).max() < 1e-7


# -- the Wiener+iSTFT kernel (csrc/wiener_istft.cu) ------------------------------

# (signals, S, nf, nfft, hop) of every Wiener+iSTFT launch: the CUDA tests'
# cases, chip_smoke.py's phases 3 and 11, and each preset's whole track
WIENER_LAUNCHES = [
    (2, 4, num_frames(6000, 64), 256, 64), (2, 2, num_frames(7000, 128), 256, 128),
    (2, 3, num_frames(9000, 128), 512, 128), (2, 4, num_frames(30000, 512), 1024, 512),
    (2, 5, num_frames(60000, 1024), 4096, 1024), (2, 1, num_frames(60000, 1024), 4096, 1024),
    (2, 3, num_frames(6000, 96), 384, 96), (2, 2, num_frames(9000, 250), 1000, 250),
    (1, 4, 1442, 4096, 1024), (1, 4, 2882, 1024, 512), (3, 4, 40, 8192, 8192),
] + [(2, s, num_frames(37 * n // 4 + 5, n // 4), n, n // 4)
     for n in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192) for s in (1, 4)] + [
    (1, p.model.num_sources, num_frames(bucket_length(30 * 44100, p), p.transform.hop_size),
     p.transform.nfft or p.transform.frame_size, p.transform.hop_size)
    for name in PRESETS for p in [get_preset(name)]
]


@pytest.mark.parametrize("signals,S,nf,nfft,hop", WIENER_LAUNCHES)
def test_wiener_plan(signals, S, nf, nfft, hop):
    """wiener_plan is the launcher's arithmetic: a block per pair of
    sources and row range, the rows its rounds cover, within shared memory
    and the block limits."""
    plan = fp.wiener_plan(signals, S, nf, nfft, hop)
    k = nfft // hop
    assert plan.smem_bytes <= fp.SMEM_MAX == 232_448 and plan.rows >= 1
    assert plan.blocks == signals * plan.blocks_per_signal * plan.pairs
    assert plan.blocks_per_signal * plan.rows >= nf + k - 1 > (plan.blocks_per_signal - 1) * plan.rows
    assert plan.halo == (k - 1) / plan.rows
    assert plan.waves == -(-plan.blocks // (plan.blocks_per_sm * fp.SMS))
    assert plan.blocks_per_sm == fp.wiener_blocks_per_sm(plan.smem_bytes, plan.threads)
    g = plan.groups
    assert g & (g - 1) == 0 and plan.threads % 32 == 0 and plan.threads <= fp.MAX_THREADS
    frames = 2 * g if plan.frame_pairs else g  # a round's
    assert 1 <= plan.rounds <= max(-(-k // frames), fp.MAX_ROUNDS)
    assert plan.rows == frames * plan.rounds - (k - 1)
    split = fp.split_factors(nfft)
    if fp.fft_supported(nfft):  # the core: the most groups of a wave
        t = fp.threads_per_fft(nfft)
        assert plan.route == "fft" and plan.threads == g * t and not plan.frame_pairs
        assert t <= 32 or g <= fp.MAX_NAMED_GROUPS
        assert plan.smem_bytes == fp.wiener_smem_bytes(nfft, hop, g)
    elif split:  # the split: istft_plan's groups, two carries
        assert plan.route == "split" and not plan.frame_pairs
        assert g == fp.istft_plan(1, 100, nfft, nfft, hop).groups
        assert plan.threads == g * nfft // fp.POINTS
        assert plan.smem_bytes == fp.wiener_split_smem_bytes(nfft, hop, g) == (
            8 * (fp.twiddle_entries(split[1]) + fp.twiddle_entries(nfft)
                 + g * fp.exchange_entries(nfft)) + 8 * (k - 1) * hop)
    else:  # Bluestein: istft_plan's groups; frame pairs where two carries do not fit
        m = fp.bluestein_size(nfft)
        assert plan.route == "bluestein" and nfft % 2 == 0 and m <= fp.LEVEL_NFFT
        assert g == fp.istft_plan(1, 100, nfft, nfft, hop).groups
        assert plan.threads == g * fp.bluestein_threads(m)
        two = (8 * (fp.bluestein_table_entries(m) + g * fp.exchange_entries(m))
               + 8 * (k - 1) * hop)
        assert plan.frame_pairs == (two > fp.SMEM_MAX)
        assert m == fp.LEVEL_NFFT or not plan.frame_pairs
        assert plan.smem_bytes == fp.wiener_bluestein_smem_bytes(
            nfft, hop, g, 1 if plan.frame_pairs else 2)
    assert plan.pairs == (S if plan.frame_pairs else (S + 1) // 2)


def test_wiener_plan_every_size():
    """Every power of two of the FFT core and every hop that divides it,
    and even sizes off the core (the split's, Bluestein's on the core and
    on the level, with frame pairs where the two carries do not fit), have
    a plan within the limits."""
    for e in range(4, 14):
        n = 1 << e
        for hop in (n, n // 2, n // 4, n // 8, n // 16):
            for S in (1, 2, 3, 4, 5):
                test_wiener_plan(1, S, 1442, n, hop)
    for n, hop in ((16 + 2, 9), (384, 96), (1000, 250), (6000, 1500), (8190, 8190), (768, 256),
                   (1280, 320), (240, 60), (7680, 960), (6144, 1536), (2000, 500), (8190, 910),
                   (6000, 750), (4000, 1000), (24, 6), (8000, 8)):
        test_wiener_plan(2, 3, 500, n, hop)
    assert fp.wiener_plan(1, 4, 200, 8190, 910).frame_pairs
    assert not fp.wiener_plan(1, 4, 200, 6000, 1500).frame_pairs
    assert fp.wiener_plan(1, 4, 200, 6000, 750).frame_pairs  # 5250 floats a carry


@pytest.mark.parametrize("nfft,hop", [(768, 256), (1000, 250), (6000, 1500), (8190, 910)])
def test_wiener_direct_plan(nfft, hop):
    """The direct sum's plan, which only wiener_direct_pallas forces: up to
    16 hop rows a block within its shared-memory budget; none at a power of
    two or past 8192."""
    plan = fp.wiener_direct_plan(1, 4, 500, nfft, hop)
    assert (plan.route, plan.groups, plan.threads, plan.rounds) == ("direct", 0, 512, 1)
    assert plan.rows == min(fp.DIRECT_MAX_ROWS, (fp.DIRECT_SMEM_BUDGET - 16 * nfft) // (8 * hop))
    assert plan.smem_bytes == fp.wiener_direct_smem_bytes(nfft, hop, plan.rows)
    assert plan.blocks == plan.blocks_per_signal * 2
    for n, h in ((1024, 256), (16384, 2048), (1001, 143)):
        with pytest.raises(ValueError, match="direct sum"):
            fp.wiener_direct_plan(1, 4, 500, n, h)


@pytest.mark.parametrize("signals,S,nf,nfft,hop", [
    (1, 4, 648, 16384, 2048), (1, 4, 414, 32768, 4096), (1, 4, 648, 16384, 16384),
    (2, 3, 40, 10000, 2500), (1, 5, 90, 20000, 5000), (3, 2, 7, 8194, 4097),
    (1, 1, 5, 32768, 32768), (1, 4, 3000, 16384, 4096),
])
def test_wiener_cluster_plan(signals, S, nf, nfft, hop):
    """wiener_cluster_plan (Bluestein's cluster) and wiener_cluster_dit_plan
    (the powers of two) are the launchers' arithmetic: a cluster of C
    blocks (Bluestein's M / 8192, 4 up to 16 384 points and 8 up to 32 768;
    the direct transform's nfft / 8192, 2 or 4) of 512 threads a pair of
    sources and row range, one frame a round (R = rounds − (k − 1) rows),
    the two sources' carries of a block's 1/C of the columns within shared
    memory, the fewest waves × rounds over every rounds it may
    (CLUSTERS_AT_ONCE a wave: one block an SM). wiener_plan past 8192 is
    the direct one at the powers of two, the mixed one at WIENER_MIXED_WON
    (test_wiener_cluster_mixed_plan) and Bluestein's elsewhere."""
    k = nfft // hop
    pow2 = nfft & (nfft - 1) == 0
    plans = [(fp.wiener_cluster_plan(signals, S, nf, nfft, hop), fp.cluster_blocks(nfft),
              "cluster")]
    if pow2:
        plans.append((fp.wiener_cluster_dit_plan(signals, S, nf, nfft, hop),
                      nfft // fp.CLUSTER_PART, "cluster_dit"))
    assert fp.wiener_plan(signals, S, nf, nfft, hop) == (
        fp.wiener_cluster_mixed_plan(signals, S, nf, nfft, hop) if nfft in fp.WIENER_MIXED_WON
        else plans[-1][0])
    for plan, c, route in plans:
        assert plan.route == route and plan.cluster == c
        assert c == ((2 if nfft <= 16384 else 4) if pow2 and route == "cluster_dit"
                     else 4 if nfft <= 16384 else 8)
        assert plan.smem_bytes == 87_040 + 8 * (k - 1) * -(-hop // c) <= fp.SMEM_MAX
        at_once = fp.CLUSTERS_AT_ONCE[c]
        assert (plan.groups, plan.threads, plan.blocks_per_sm) == (1, fp.MAX_THREADS, 1)
        assert plan.pairs == (S + 1) // 2 and plan.rows == plan.rounds - (k - 1) >= 1
        assert plan.blocks_per_signal * plan.rows >= nf + k - 1
        clusters = signals * plan.blocks_per_signal * plan.pairs
        assert plan.blocks == clusters * c
        assert plan.waves == -(-clusters // at_once)

        def cost(rounds):
            per = -(-(nf + k - 1) // (rounds - (k - 1)))
            return -(-signals * per * plan.pairs // at_once) * rounds

        assert all(cost(plan.rounds) <= cost(r) for r in range(k, nf + 2 * k))


@pytest.mark.parametrize("signals,S,nf,nfft,hop,route,cluster,rounds,rows", [
    (1, 4, 648, 16384, 2048, "cluster_dit", 2, 27, 20),   # the smoke's 16 384: 66 clusters
    (1, 4, 325, 32768, 4096, "cluster_dit", 4, 30, 23),   # the smoke's 32 768: 30 clusters
    (1, 4, 532, 10000, 2500, "cluster", 4, 39, 36),       # Bluestein's, forced
    (1, 4, 267, 20000, 5000, "cluster", 8, 42, 39),
    (1, 4, 532, 10000, 2500, "cluster_mixed", 2, 20, 17),  # 5-smooth: C 2 of n 5000, 64 clusters
    (1, 4, 267, 20000, 5000, "cluster_mixed", 4, 21, 18),  # C 4: 30 clusters
    (1, 4, 292, 14000, 3500, "cluster_mixed", 2, 12, 9),  # 7-smooth: C 2 of n 7000
    (1, 4, 209, 22000, 5500, "cluster", 8, 34, 31),       # a prime past 7 (11): Bluestein's
])
def test_wiener_cluster_routes(signals, S, nf, nfft, hop, route, cluster, rounds, rows):
    """wiener_plan's route past 8192: the direct transform ("cluster_dit")
    on 2 blocks at the reference's 16 384 and 4 at 32 768, the same on the
    mixed-radix core ("cluster_mixed") on 2 blocks at 10 000 and 14 000 and
    4 at 20 000, Bluestein's cluster ("cluster") at 22 000 (and forced,
    wiener_cluster_plan, at 10 000 and 20 000); each plan one wave of the
    card's clusters at once."""
    plan = (fp.wiener_cluster_plan if route == "cluster" and nfft in fp.WIENER_MIXED_WON
            else fp.wiener_plan)(signals, S, nf, nfft, hop)
    assert (plan.route, plan.cluster, plan.rounds, plan.rows, plan.waves) == (
        route, cluster, rounds, rows, 1)


def test_wiener_cluster_envelope():
    """The Wiener+iSTFT cluster plans every even size past 8192 up to the
    reference's 32 768, at any hop that divides it, and nothing else (the
    direct transform's plan the powers of two only); the smoke's
    highres-like shape (4 stems of a 30 s track at W 16 384, hop 2048)
    fills one wave of clusters of 2."""
    assert fp.wiener_plan(1, 4, 648, 16384, 2048).waves == 1
    for n in (8194, 10_000, 16_384, 20_000, 32_768):
        for hop in (n, n // 2):
            want = (n // fp.CLUSTER_PART if n & (n - 1) == 0
                    else fp.mixed_factors(n)[0] if n in fp.WIENER_MIXED_WON
                    else fp.cluster_blocks(n))
            assert fp.wiener_plan(1, 4, 100, n, hop).cluster == want
    for n, hop in ((8192, 2048), (32_770, 16_385), (65_536, 16_384), (16_385, 16_385),
                   (16_384, 3000)):
        with pytest.raises(ValueError, match="no Wiener.iSTFT cluster plan"):
            fp.wiener_cluster_plan(1, 4, 100, n, hop)
    for n, hop in ((8192, 2048), (10_000, 2500), (65_536, 16_384), (16_384, 3000)):
        with pytest.raises(ValueError, match="no Wiener.iSTFT cluster_dit plan"):
            fp.wiener_cluster_dit_plan(1, 4, 100, n, hop)


WIENER_MIXED_SIZES = [n for n in MIXED_SIZES if fp.wiener_mixed_factors(n)]


@pytest.mark.parametrize("signals,S,nf,nfft,hop", [
    (1, 4, 532, 10_000, 2500), (1, 4, 267, 20_000, 5000),  # the smoke's: C 2 and 4 of n 5000
    (2, 3, 40, 11_250, 2250),     # n 5625, odd: S = ceil(N/2/C) bins a block
    (1, 5, 90, 26_244, 6561),     # n 6561 = 3^8 on C 4, S odd
    (1, 2, 300, 8640, 540),       # the smallest, k 16
    (1, 4, 120, 32_400, 2025),    # the largest, k 16: the most carry
    (3, 1, 7, 12_000, 12_000),    # k 1: no carry, one source
    (1, 4, 302, 22_050, 4410),    # 500 ms at 44.1 kHz: C 3 of n 7350
    (1, 4, 302, 30_618, 10_206),  # C 6 of n 5103 = 3^6 · 7, odd: the last share 2549 bins
    (2, 3, 135, 30_870, 6174),    # C 5 of n 6174
])
def test_wiener_cluster_mixed_plan(signals, S, nf, nfft, hop):
    """wiener_cluster_mixed_plan is wiener_cluster_mixed_launch's
    arithmetic: C and n of mixed_factors (C 2 to 6), a cluster of 512-thread
    blocks a pair of sources and row range, one frame a round (R = rounds −
    (k − 1) rows), each block the n-point table, the n-point exchange buffer
    and the two sources' carries of its 1/C of the columns within shared
    memory, the fewest waves × rounds (CLUSTERS_AT_ONCE[C] a wave)."""
    plan = fp.wiener_cluster_mixed_plan(signals, S, nf, nfft, hop)
    c, n = fp.mixed_factors(nfft)
    k = nfft // hop
    assert fp.wiener_mixed_factors(nfft) == (c, n)
    assert c in (2, 3, 4, 5, 6) and n <= 16 * fp.MAX_THREADS
    assert (plan.route, plan.cluster, plan.groups, plan.threads, plan.blocks_per_sm) == (
        "cluster_mixed", c, 1, fp.MAX_THREADS, 1)
    carry = 2 * (k - 1) * -(-hop // c)
    assert plan.smem_bytes == 8 * (n + n + n // 16) + 4 * carry <= fp.SMEM_MAX
    assert plan.smem_bytes == fp.cluster_mixed_smem_bytes(n, carry)
    assert plan.pairs == (S + 1) // 2 and plan.rows == plan.rounds - (k - 1) >= 1
    assert plan.blocks_per_signal * plan.rows >= nf + k - 1
    clusters = signals * plan.blocks_per_signal * plan.pairs
    assert plan.blocks == clusters * c and plan.waves == -(-clusters // fp.CLUSTERS_AT_ONCE[c])

    def cost(rounds):
        per = -(-(nf + k - 1) // (rounds - (k - 1)))
        return -(-signals * per * plan.pairs // fp.CLUSTERS_AT_ONCE[c]) * rounds

    assert all(cost(plan.rounds) <= cost(r) for r in range(k, nf + 2 * k))


def test_wiener_cluster_mixed_sizes_and_routes():
    """The mixed Wiener cluster serves 149 7-smooth even sizes of
    mixed_factors up to the reference's 32 768: 136 from 8232 to 32 400 (22
    with an odd n) on C 2 or 4, and 13 from 17 010 to 31 250 on C 3, 5 or 6
    (not 17 150 = 5 · 3430: its last block's 1715 bins are under the mask
    loads' four unguarded strides, WIENER_MIXED_MIN_SHARE); wiener_plan takes
    it exactly at WIENER_MIXED_WON and Bluestein's cluster at the other even
    sizes past 8192 off the powers of two; every one fits shared memory at
    k up to 16 (hop N / k)."""
    assert len(WIENER_MIXED_SIZES) == 149
    assert (WIENER_MIXED_SIZES[0], WIENER_MIXED_SIZES[-1]) == (8232, 32_400)
    pow2 = [n for n in WIENER_MIXED_SIZES if fp.mixed_factors(n)[0] in (2, 4)]
    assert len(pow2) == 136 and [n for n in WIENER_MIXED_SIZES if n not in pow2] == [
        17_010, 18_522, 18_750, 20_250, 21_870, 22_050, 23_814, 24_010, 26_250, 28_350, 30_618,
        30_870, 31_250]
    assert fp.mixed_factors(17_150) == (5, 3430) and fp.wiener_mixed_factors(17_150) is None
    odd = sorted(n for n in pow2 if fp.mixed_factors(n)[1] % 2)
    assert len(odd) == 22 and {11_250, 12_150, 13_122, 22_500, 24_300, 26_244, 8750, 14_406,
                               28_812} <= set(odd)
    assert fp.WIENER_MIXED_WON <= set(WIENER_MIXED_SIZES)
    for nfft in WIENER_MIXED_SIZES:
        c, n = fp.mixed_factors(nfft)
        half = nfft // 2
        assert half - (c - 1) * -(-half // c) >= fp.WIENER_MIXED_MIN_SHARE
        assert (c == (2 if nfft <= 16_384 else 4) and 4096 < n <= 8192) if nfft in pow2 else (
            c in (3, 5, 6) and n <= 8192)
        for k in (1, 2, 4, 8, 16):
            if nfft % k == 0:
                plan = fp.wiener_cluster_mixed_plan(1, 4, 100, nfft, nfft // k)
                assert plan.smem_bytes <= fp.SMEM_MAX and plan.cluster == c
        route = fp.wiener_plan(1, 4, 100, nfft, nfft // 2).route
        assert route == ("cluster_mixed" if nfft in fp.WIENER_MIXED_WON else "cluster")
        assert fp.wiener_cluster_plan(1, 4, 100, nfft, nfft // 2).route == "cluster"
    for nfft in (8194, 11_264, 16_386, 22_000, 30_002):
        assert fp.wiener_plan(1, 4, 100, nfft, nfft // 2).route == "cluster"


@pytest.mark.parametrize("nfft,hop", [
    (10_001, 10_001),   # odd
    (22_000, 5500),     # a prime past 7: 2^4 · 5^3 · 11
    (8194, 4097),       # a prime past 5
    (16_384, 2048),     # a power of two: the direct cluster
    (34_560, 8640),     # 5-smooth, past 32 768 (C 8)
    (8192, 2048),       # the core's
    (10_000, 3000),     # the hop does not divide it
    (11_025, 2205),     # odd: the iSTFT's alone
    (17_150, 3430),     # C 5 of n 3430: the last block's 1715 bins
    (33_075, 6615),     # past 32 768 (C 5)
])
def test_wiener_cluster_mixed_plan_refuses(nfft, hop):
    with pytest.raises(ValueError, match="no Wiener.iSTFT cluster_mixed plan"):
        fp.wiener_cluster_mixed_plan(1, 4, 100, nfft, hop)


def masked_bins(y, re, im, s0, p, eps, conserve_last, ny=None):
    """wiener_istft.cu::masked_bin for every frame and bin 0 .. N/2 at once:
    the masked half-spectra A (source s0) and B (s0 + 1; zero past S) of
    the mixture, the denominator summed in source order then + eps. With
    ``ny`` the mixture rows hold N/2 bins and bin N/2 is ny (imaginary 0)."""
    S = y.shape[-3]
    yf = y.float()
    q = torch.where(yf > 0, yf, torch.zeros(()))
    if p == 2.0:
        q = q * q
    d = q[..., 0, :, :]
    for s in range(1, S):
        d = d + q[..., s, :, :]
    d = d + eps
    if ny is not None:
        re = torch.cat([re, ny[..., None]], -1)
        im = torch.cat([im, torch.zeros_like(ny)[..., None]], -1)

    def mask(s):
        if s >= S:
            return torch.zeros_like(d)
        num = q[..., s, :, :] + (eps if conserve_last and s == S - 1 else 0.0)
        return num / d

    ma, mb = mask(s0), mask(s0 + 1)
    return ma * re, ma * im, mb * re, mb * im


def core_wiener_istft(y, re, im, window, hop, length, p=1.0, eps=1e-8, conserve_last=False,
                      ny=None, fft=core_fft):
    """wiener_fft_kernel in float32: per pair of sources, each frame's
    conj Z = conj(A + iB) loaded point by point (the mirrored bins past
    Nyquist), run through the forward core (``fft``: ``cluster_dit_fft``
    for wiener_cluster_dit_block), windowed with window / N; each sample
    sums its frames in ascending order; inverse window-power envelope, N/2
    front trim. (B, S, nf, bins) y → (B, S, L) stems."""
    from convsep_tpu_torch.dsp.dft import _key, inverse_norm

    B, S, nf, bins = y.shape
    N = 2 * (bins - 1)
    k = N // hop
    wn = torch.from_numpy((np.asarray(window, np.float64) / N).astype(np.float32))
    inv = inverse_norm(_key(np.asarray(window, np.float32)), hop, nf, "cpu")
    stems = []
    for s0 in range(0, S, 2):
        ar, ai, br, bi = masked_bins(y, re, im, s0, p, eps, conserve_last, ny)
        zz = fft(inverse_input(ar, ai, br, bi))  # (B, nf, N)
        for src, frames in ((s0, zz.real * wn), (s0 + 1, -zz.imag * wn)):
            if src >= S:
                continue
            acc = torch.zeros(B, nf + k - 1, hop)
            for i in range(k - 1, -1, -1):  # frame f = row - i: ascending f
                acc[:, i:i + nf] += frames[..., i * hop:(i + 1) * hop]
            stems.append((acc.reshape(B, -1) * inv)[:, N // 2:N // 2 + length])
    return torch.stack(stems, 1)


@pytest.mark.parametrize("nfft,hop,nf,S,kw,ny,bf16", [
    (256, 64, 9, 4, {}, False, False),
    (256, 128, 8, 3, {"p": 2.0}, False, True),
    (1024, 512, 7, 1, {"conserve_last": True}, False, False),
    (1024, 256, 10, 2, {"p": 2.0, "conserve_last": True}, False, True),
    (4096, 1024, 7, 4, {"conserve_last": True}, True, True),
    (4096, 1024, 6, 5, {"eps": 1e-4}, True, False),
    (16, 4, 12, 3, {}, False, False),
])
def test_core_wiener_istft_matches_plain(rng, nfft, hop, nf, S, kw, ny, bf16):
    """The kernel's Wiener point loading (conj Z of each pair, the mirrored
    bins, the Nyquist row, odd S) through the core against
    wiener_istft_plain, within the CUDA tests' 1e-5 absolute."""
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft_plain

    length = (nf - 2) * hop
    w = sinebell(nfft)
    bins = nfft // 2 + 1
    y = np.abs(rng.standard_normal((2, S, nf, bins))).astype(np.float32)
    y[..., : nf // 3, :8] = 0.0  # dead bins: the eps paths
    y = torch.from_numpy(y)
    if bf16:
        y = y.to(torch.bfloat16)
    cols = bins - 1 if ny else bins
    re = torch.from_numpy(rng.standard_normal((2, nf, cols)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((2, nf, cols)).astype(np.float32))
    nyq = torch.from_numpy(rng.standard_normal((2, nf)).astype(np.float32)) if ny else None
    got = core_wiener_istft(y, re, im, w, hop, length, ny=nyq, **kw)
    want = wiener_istft_plain(y, re, im, w, hop, length, ny=nyq, **kw)
    assert got.shape == want.shape == (2, S, length)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def cluster_dit_fft(u: torch.Tensor, c: int = 2) -> torch.Tensor:
    """fft_common.cuh::ClusterDit on (..., N) complex in natural order, N = c
    P: block r holds the points u[c n + r] (its residues, where
    ClusterDit::put stages them: block t mod c, slot t / c), transforms
    them and applies w^{r k1}; Z[k1 + P q] is the radix-c combine across
    the blocks (``cluster_dit``). (..., N) natural order."""
    N = u.shape[-1]
    return cluster_dit(u.reshape(*u.shape[:-1], N // c, c).transpose(-1, -2), c)


@pytest.mark.parametrize("nfft,c", [(128, 2), (256, 4), (16384, 2), (32768, 4)])
def test_cluster_dit_inverse_matches_torch_fft(rng, nfft, c):
    """The Wiener kernel's transform at the powers of two past 8192 (and at
    the host emulation's parts of 64 points): conj Z of two real frames'
    half-spectra, Z = A + iB (inverse_input), run through ClusterDit's
    residues, twiddle and radix-c combine, gives N conj(a + ib), a and b
    the frames' inverse real FFTs (torch.fft), within 1e-6 × max."""
    bins = nfft // 2 + 1
    spec = rng.standard_normal((4, 2, bins)) + 1j * rng.standard_normal((4, 2, bins))
    A, B = (torch.from_numpy(spec[:, i]) for i in (0, 1))
    z = cluster_dit_fft(inverse_input(A.real, A.imag, B.real, B.imag), c)
    want = nfft * torch.complex(torch.fft.irfft(A, nfft), -torch.fft.irfft(B, nfft))
    torch.testing.assert_close(z, want, atol=1e-6 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("nfft,c,win,hop,nf", [
    (128, 2, 128, 32, 9), (512, 8, 256, 64, 8), (16384, 2, 16384, 2048, 11),
    (32768, 4, 16384, 4096, 7),
])
def test_cluster_dit_istft_matches_plain(rng, nfft, c, win, hop, nf):
    """istft_cluster_dit_block's arithmetic in float32 (inverse_input's
    points of a pair, ClusterDit's residues, twiddle and combine, the
    frames' overlap-add in ascending order) against istft_pallas_plain
    within 1e-5 × max|out|."""
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas_plain

    length = (nf - 2) * hop
    w = sinebell(win)
    bins = nfft // 2 + 1
    re = torch.from_numpy(rng.standard_normal((2, nf, bins)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((2, nf, bins)).astype(np.float32))
    got = core_istft(re, im, w, hop, length, nfft, fft=lambda u: cluster_dit_fft(u, c))
    want = istft_pallas_plain(re, im, w, hop, length, nfft=nfft)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("nfft,c,hop,nf,S,kw,ny", [
    (128, 2, 32, 9, 4, {}, False),
    (256, 4, 64, 8, 3, {"p": 2.0}, True),
    (16384, 2, 2048, 5, 4, {"conserve_last": True}, True),
])
def test_cluster_dit_wiener_istft_matches_plain(rng, nfft, c, hop, nf, S, kw, ny):
    """wiener_cluster_dit_block's arithmetic in float32 (the masked points,
    ClusterDit's residues, twiddle and combine, the two sources' overlap-add)
    against wiener_istft_plain within 1e-5 × max|out|."""
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft_plain

    length = (nf - 2) * hop
    w = sinebell(nfft)
    bins = nfft // 2 + 1
    y = np.abs(rng.standard_normal((1, S, nf, bins))).astype(np.float32)
    y[..., : nf // 3, :8] = 0.0
    y = torch.from_numpy(y)
    cols = bins - 1 if ny else bins
    re = torch.from_numpy(rng.standard_normal((1, nf, cols)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((1, nf, cols)).astype(np.float32))
    nyq = torch.from_numpy(rng.standard_normal((1, nf)).astype(np.float32)) if ny else None
    got = core_wiener_istft(y, re, im, w, hop, length, ny=nyq, fft=lambda u: cluster_dit_fft(u, c),
                            **kw)
    want = wiener_istft_plain(y, re, im, w, hop, length, ny=nyq, **kw)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("signals,S,nf,nfft,hop,groups,rounds,rows,blocks", [
    (1, 4, 1442, 4096, 1024, 2, 13, 23, 126),  # highres4096, multires4096, bach10: one wave
    (1, 4, 2882, 1024, 512, 8, 6, 47, 124),    # dsd100: one wave
])
def test_wiener_main_path_plans(signals, S, nf, nfft, hop, groups, rounds, rows, blocks):
    plan = fp.wiener_plan(signals, S, nf, nfft, hop)
    assert (plan.groups, plan.rounds, plan.rows, plan.blocks, plan.waves) == (
        groups, rounds, rows, blocks, 1)


@pytest.mark.parametrize("signals,nf,nfft,win,hop", [
    (32, 3, 70_000, 70_000, 17_500),      # the smoke's STFT: 96 frames, 48 pairs, M 262 144
    (1, 78, 70_000, 70_000, 17_500),      # the smoke's iSTFT: one 30 s signal
    (32, 3, 131_072, 131_072, 32_768),    # the largest on M 262 144
    (32, 3, 131_073, 131_073, 131_073),   # odd, M 524 288
    (4, 7, 262_144, 262_144, 65_536),     # the level's largest
    (1, 1, 65_537, 65_537, 65_537),       # its smallest: one frame, one pair
    (3, 5, 100_000, 80_000, 20_000),      # nfft past the window
])
def test_level2_plan(signals, nf, nfft, win, hop):
    """level2_plan mirrors stft_level2_launch and istft_level2_launch: the
    flattened frames in pairs, M = 2^⌈log2(2 nfft − 1)⌉ = R · 8192 with R 32
    or 64, and as many pairs a round as keep the round's scratch (M float2
    a pair) within LEVEL2_SCRATCH_BYTES, which is half the card's L2: the
    phases read back what the one before wrote from the L2."""
    plan = fp.level2_plan(signals, nf, nfft, win, hop)
    m = fp.bluestein_size(nfft)
    assert fp.level2_supported(nfft) and not fp.cluster_supported(nfft)
    assert plan.m == m in (262_144, 524_288) and plan.radix == m // 8192 in (32, 64)
    assert plan.pairs == -(-signals * nf // 2)
    assert plan.pairs_per_round == min(plan.pairs, fp.LEVEL2_SCRATCH_BYTES // (8 * m))
    assert plan.rounds * plan.pairs_per_round >= plan.pairs
    assert (plan.rounds - 1) * plan.pairs_per_round < plan.pairs
    assert plan.scratch_bytes == 8 * m * plan.pairs_per_round
    assert plan.scratch_bytes <= fp.LEVEL2_SCRATCH_BYTES <= fp.L2_BYTES // 2
    assert plan.middle_smem_bytes == 87_040 <= fp.SMEM_MAX
    assert fp.istft_plan(signals, nf, nfft, win, hop) == (  # the won 7-smooth sizes moved
        fp.level2_direct_plan(signals, nf, nfft, win, hop)
        if nfft in fp.ISTFT_LEVEL2_DIRECT_WON else plan)


def test_level2_rounds_fit_the_l2():
    """12 pairs a round at M 262 144 (24 MiB of scratch), 6 at 524 288: the
    smoke's STFT (48 pairs) runs in 4 rounds, its iSTFT (39 pairs) in 4."""
    a = fp.level2_plan(32, 3, 70_000, 70_000, 17_500)
    assert (a.pairs, a.pairs_per_round, a.rounds, a.scratch_bytes) == (48, 12, 4, 24 * 2 ** 20)
    b = fp.level2_plan(1, 78, 70_000, 70_000, 17_500)
    assert (b.pairs, b.pairs_per_round, b.rounds) == (39, 12, 4)
    c = fp.level2_plan(32, 3, 200_000, 200_000, 50_000)
    assert (c.m, c.pairs_per_round, c.rounds, c.scratch_bytes) == (524_288, 6, 8, 24 * 2 ** 20)


def test_level2_envelope():
    """The second level takes 65 537–262 144 points, any parity; the
    cluster ends at 65 536 and past 262 144 no plan exists."""
    assert not fp.level2_supported(65_536) and fp.cluster_supported(65_536)
    assert fp.level2_supported(65_537) and fp.level2_supported(fp.LEVEL2_NFFT)
    assert not fp.level2_supported(fp.LEVEL2_NFFT + 1)
    assert fp.bluestein_size(131_072) == 262_144 and fp.bluestein_size(131_073) == 524_288
    for n in (65_536, 262_145, 300_000):
        with pytest.raises(ValueError, match="no second-level plan"):
            fp.level2_plan(1, 4, n, n, n)
    with pytest.raises(ValueError, match="no second-level plan"):
        fp.level2_plan(1, 4, 70_000, 70_001, 70_001)  # a window past nfft


def test_level2_direct_factors_takes_the_138_sizes():
    """level2_direct_factors: nfft = R n past 65 536 up to 262 144, R 16 up
    to 131 072 and 32 past it, n 7-smooth of either parity: 138 sizes, 69
    at each R (from 65 856 = 16 · 4116 and 131 712 = 32 · 4116), 11 odd n at
    each; none for an odd size, a prime factor past 7, or too few factors
    of two for R. ISTFT_LEVEL2_DIRECT_WON is a subset."""
    sizes = {n: fp.level2_direct_factors(n)
             for n in range(fp.CLUSTER_NFFT + 1, fp.LEVEL2_NFFT + 1) if fp.level2_direct_factors(n)}
    assert len(sizes) == 138 and min(sizes) == 65_856 and max(sizes) == 262_144
    for r in (16, 32):
        mine = {n: m for n, (q, m) in sizes.items() if q == r}
        assert len(mine) == 69 and sum(m % 2 for m in mine.values()) == 11
    for n, (r, m) in sizes.items():
        assert n == r * m and r == (16 if n <= 131_072 else 32) and m <= 8192 and fp.smooth7(m)
    assert sizes[70_000] == (16, 4375) and sizes[131_072] == (16, 8192)
    assert sizes[200_000] == (32, 6250) and sizes[131_712] == (32, 4116)
    for n in (99_999, 131_073, 70_001, 65_538, 65_536, 262_145, 131_088, 72_864):
        assert fp.level2_direct_factors(n) is None, n  # 131 088 = 16 · 8193; 72 864 = 16 · 4554
    assert fp.ISTFT_LEVEL2_DIRECT_WON <= set(sizes)


@pytest.mark.parametrize("nfft,hop", [
    (70_000, 17_500), (131_072, 32_768), (200_000, 50_000),  # the direct level where won
    (99_999, 33_333), (131_073, 131_073), (70_001, 70_001), (65_538, 32_769),  # Bluestein's
])
def test_istft_plan_routes_the_second_level(nfft, hop):
    """istft_plan takes the direct level (route "level2_direct") at the
    sizes in ISTFT_LEVEL2_DIRECT_WON, which holds the smoke's 70 000, 131
    072 and 200 000, and Bluestein's level (route "level2") at every other
    size past 65 536: odd, a factor past 7, or too few factors of two."""
    nf = -(-1_323_000 // hop) + 2  # one 30 s signal
    plan = fp.istft_plan(1, nf, nfft, nfft, hop)
    if fp.level2_direct_factors(nfft):
        assert nfft in fp.ISTFT_LEVEL2_DIRECT_WON
        assert plan == fp.level2_direct_plan(1, nf, nfft, nfft, hop)
        assert plan.route == "level2_direct"
    else:
        assert plan == fp.level2_plan(1, nf, nfft, nfft, hop) and plan.route == "level2"


@pytest.mark.parametrize("signals,nf,nfft,per,rounds", [
    (1, 78, 70_000, 39, 1),     # the smoke's: every pair of a 30 s signal in one round
    (1, 43, 131_072, 22, 1),
    (1, 29, 200_000, 15, 1),    # R 32: 15 pairs of 1.6 MB
    (1, 23, 262_144, 12, 1),
    (32, 3, 262_144, 12, 4),    # 48 pairs of 2 MiB: rounds of 12
    (4, 100, 65_856, 47, 5),    # 200 pairs of 527 kB: rounds of 47
])
def test_level2_direct_plan_keeps_the_scratch_in_the_l2(signals, nf, nfft, per, rounds):
    """level2_direct_plan mirrors istft_level2_direct_launch: the flattened
    frames in pairs, nfft float2 of scratch a pair, as many pairs a round as
    keep the round's scratch within LEVEL2_SCRATCH_BYTES (half the L2), the
    rows' block the n-point table and exchange buffer within SMEM_MAX."""
    r, n = fp.level2_direct_factors(nfft)
    plan = fp.level2_direct_plan(signals, nf, nfft, nfft, nfft // 4)
    assert plan.route == "level2_direct" and plan.m == nfft and plan.radix == r
    assert plan.pairs == -(-signals * nf // 2)
    assert (plan.pairs_per_round, plan.rounds) == (per, rounds)
    assert plan.pairs_per_round == min(plan.pairs, fp.LEVEL2_SCRATCH_BYTES // (8 * nfft))
    assert plan.scratch_bytes == 8 * nfft * per <= fp.LEVEL2_SCRATCH_BYTES <= fp.L2_BYTES // 2
    assert plan.middle_smem_bytes == fp.cluster_mixed_smem_bytes(n) <= fp.SMEM_MAX
    for bad in (99_999, 65_536, 262_145):
        with pytest.raises(ValueError, match="no direct second-level plan"):
            fp.level2_direct_plan(1, 4, bad, bad, bad)
    with pytest.raises(ValueError, match="no direct second-level plan"):
        fp.level2_direct_plan(1, 4, 70_000, 70_001, 70_001)  # a window past nfft


@pytest.mark.parametrize("nfft", [70_000, 131_073])
def test_level2_chat_by_rows(nfft):
    """level2_chat stores the chirp spectrum's entry R k + r at r · 8192 +
    k (phase B/C's block r reads its row in order), bit for bit the float32
    table of bluestein_tables."""
    _, chat = fp.bluestein_tables(nfft, "cpu")
    rows = fp.level2_chat(nfft, "cpu")
    r = fp.bluestein_size(nfft) // 8192
    assert rows.shape == chat.shape == (8192 * r, 2)
    k = torch.arange(8192)
    for q in (0, 1, r // 2, r - 1):
        assert torch.equal(rows[q * 8192 + k], chat[r * k + q])
