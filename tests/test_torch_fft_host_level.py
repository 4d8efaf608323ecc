"""The levels' device bodies on the CPU (the stand-in runtime and
:func:`tests.test_torch_fft_host.programs`): ``stft_level_block`` (the
fused STFT's 16 384 points on the level, ``ct_stft.cu::
ct_stft_level_kernel``) and the second level's phases ``level2_first`` /
``level2_middle`` / ``level2_last`` with ``level2_split`` or
``level2_overlap_add`` at M 262 144 and 524 288, both directions, against
numpy's float64 FFT and the float64 synthesis within 1e-5 × max, PCM16
within ±1 LSB."""

import subprocess

import numpy as np
import pytest

from convsep_tpu_torch.dsp.cuda import fft_plan as fp
from convsep_tpu_torch.dsp.stft import num_frames
from convsep_tpu_torch.dsp.windows import sinebell
from tests.test_torch_fft_host import programs

host = programs("level_stft", "level2")


def test_level_stft_source_matches_numpy(tmp_path, host, rng):
    """stft_level_block (ct_stft.cu::ct_stft_level_kernel: one 16 384-point
    transform a pair of frames on the level, its transforms synchronizing
    the whole block) at hop 4096 on two signals of 3 frames (a pair and a
    lone frame each), against numpy's float64 FFT of the same windowed
    frames within 1e-5 × max|X|: bins below Nyquist and the Nyquist row."""
    n, hop, B, length = 16_384, 4096, 2, 3 * 4096 + 100
    nf = num_frames(length, hop)
    x = (0.3 * rng.standard_normal((B, length))).astype(np.float32)
    w = sinebell(n)
    for name, arr in (("x", x), ("w", w), ("tw", fp.twiddles(n, "cpu").numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    subprocess.run([str(host["level_stft"]), str(tmp_path), *map(str, (B, length, hop, nf))],
                   check=True, timeout=300)
    half = n // 2
    out = np.fromfile(tmp_path / "out.bin", np.float32)
    re = out[:B * nf * half].reshape(B, nf, half)
    im = out[B * nf * half:2 * B * nf * half].reshape(B, nf, half)
    ny = out[2 * B * nf * half:].reshape(B, nf)
    assert np.isfinite(out).all()  # every bin of every frame written
    for b in range(B):
        padded = np.concatenate([np.zeros(n // 2), x[b].astype(np.float64), np.zeros(2 * n)])
        want = np.fft.rfft(np.stack([padded[f * hop:f * hop + n] for f in range(nf)])
                           * w.astype(np.float32).astype(np.float64))
        tol = 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(re[b], want.real[:, :half], atol=tol, rtol=0)
        np.testing.assert_allclose(im[b], want.imag[:, :half], atol=tol, rtol=0)
        np.testing.assert_allclose(ny[b], want.real[:, half], atol=tol, rtol=0)


def _level2_tables(tmp_path, nfft):
    m = fp.bluestein_size(nfft)
    chirp, _ = fp.bluestein_tables(nfft, "cpu")
    for name, arr in (("tw", fp.twiddles(m, "cpu").numpy()), ("chirp", chirp.numpy()),
                      ("chat", fp.level2_chat(nfft, "cpu").numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    return m.bit_length() - 1


@pytest.mark.parametrize("nfft,hop,B,length", [
    (70_000, 17_500, 1, 35_010),    # M 262 144: R 32, 3 frames in 2 pairs
    (70_001, 70_001, 2, 70_001),    # odd; frames of two signals share a pair
    (140_000, 35_000, 1, 35_000),   # M 524 288: R 64
])
def test_level2_stft_source_matches_numpy(tmp_path, host, rng, nfft, hop, B, length):
    """The second level's phases as stft_dft.cu::launch_level2 runs them
    (A, B/C, D and the split; every pair in one round) against numpy's
    float64 FFT of the same windowed frames, within 1e-5 × max|X|."""
    lg = _level2_tables(tmp_path, nfft)
    nf = num_frames(length, hop)
    x = (0.3 * rng.standard_normal((B, length))).astype(np.float32)
    w = sinebell(nfft)
    for name, arr in (("x", x), ("w", w)):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    args = [0, lg, B, length, nfft, hop, nf, nfft]
    subprocess.run([str(host["level2"]), str(tmp_path), *map(str, args)], check=True, timeout=300)
    out = np.fromfile(tmp_path / "out.bin", np.float32).reshape(2, B, nf, nfft // 2 + 1)
    assert np.isfinite(out).all()  # every bin of every frame written
    for b in range(B):
        padded = np.concatenate([np.zeros(nfft // 2), x[b].astype(np.float64), np.zeros(2 * nfft)])
        want = np.fft.rfft(np.stack([padded[f * hop:f * hop + nfft] for f in range(nf)])
                           * w.astype(np.float32).astype(np.float64))
        tol = 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(out[0, b], want.real, atol=tol, rtol=0)
        np.testing.assert_allclose(out[1, b], want.imag, atol=tol, rtol=0)


@pytest.mark.parametrize("nfft,hop,nt,length,out", [
    (70_000, 17_500, 1, 52_500, "float32"),   # M 262 144: 4 frames, every sample of 3 windows
    (70_001, 70_001, 2, 70_001, "int16"),     # odd: no Nyquist bin; frames of two signals a pair
    (131_072, 65_536, 1, 65_536, "float32"),  # the largest on M 262 144
])
def test_level2_istft_source_matches_numpy(tmp_path, host, rng, nfft, hop, nt, length, out):
    """The second level run backwards as istft.cu::launch_level2 runs it
    (A, B/C, D into the frames' samples, then the overlap-add) against the
    float64 synthesis (numpy's inverse real FFT, the window, overlap-add,
    the float32 envelope the kernel reads) within 1e-5 × max|out|, PCM16
    within ±1 LSB of the same rounded once."""
    lg = _level2_tables(tmp_path, nfft)
    nf = num_frames(length, hop)
    bins = nfft // 2 + 1
    re = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    im = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    w = sinebell(nfft)
    wn, inv = fp.synthesis_tables(w, nfft, hop, nf, "cpu")
    for name, arr in (("re", re), ("im", im), ("wn", wn.numpy()), ("inv", inv.numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    int16 = out == "int16"
    args = [1, lg, nt, nf, nfft, nfft, hop, length, int(int16)]
    subprocess.run([str(host["level2"]), str(tmp_path), *map(str, args)], check=True, timeout=300)
    got = np.fromfile(tmp_path / "out.bin", np.int16 if int16 else np.float32).reshape(nt, length)
    z = re.astype(np.float64) + 1j * im.astype(np.float64)
    frames = np.fft.irfft(z, nfft, axis=-1) * w.astype(np.float32).astype(np.float64)
    ola = np.zeros((nt, (nf - 1) * hop + nfft))
    for f in range(nf):
        ola[:, f * hop:f * hop + nfft] += frames[:, f]
    want = ola[:, nfft // 2:nfft // 2 + length] * inv.numpy()[nfft // 2:nfft // 2 + length]
    if int16:
        q = np.clip(np.rint(want * 32768.0), -32768, 32767).astype(np.int32)
        assert (q != 0).any() and np.abs(got.astype(np.int32) - q).max() <= 1
    else:
        assert np.isfinite(got).all()  # every sample written
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
