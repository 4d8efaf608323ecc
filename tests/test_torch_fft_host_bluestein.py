"""Bluestein's device bodies on the CPU (the stand-in runtime and
:func:`tests.test_torch_fft_host.programs`): ``stft_bluestein_block``
(``stft_dft.cu::stft_bluestein_kernel``, its transforms synchronizing the
block, ``kBlockSync``), on the core and on the 16 384-point level
(``Level``), against ``stft_pallas_plain`` within 1e-5 × max|X|; and
``istft_bluestein_block`` (``istft.cu::istft_bluestein_kernel``: Bluestein
run backwards, the rounds, carry and gather), on the core and on the level,
odd sizes too, against ``istft_pallas_plain`` within 1e-5 × max|out|, and as
PCM16 against the plain synthesis quantized within ±1 LSB."""

import subprocess

import numpy as np
import pytest
import torch

from convsep_tpu_torch.dsp.cuda import fft_plan as fp
from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas_plain
from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas_plain
from convsep_tpu_torch.dsp.dft import istft_matmul
from convsep_tpu_torch.dsp.stft import num_frames
from convsep_tpu_torch.dsp.windows import sinebell
from tests.test_torch_fft_host import programs

host = programs("bluestein_stft", "bluestein_istft")


@pytest.mark.parametrize("nfft,win,hop,B,length,ffts", [
    (1000, 1000, 250, 1, 3000, None),     # 8 · 125: M 2048, one transform a block
    (1000, 1000, 250, 2, 3000, 2),        # two transforms a block
    (1001, 1001, 143, 1, 2000, None),     # odd
    (1000, 800, 200, 1, 2500, None),      # nfft past the window
    (18, 18, 9, 2, 200, None),            # M 64: 8 transforms of 4 threads a block
    (1792, 1792, 448, 1, 4000, None),     # 7 · 256: M 4096
    (4000, 4000, 1000, 1, 6000, None),    # M 8192, 512 threads
    (6000, 6000, 1500, 1, 1500, None),    # M 16 384, the level: 3 frames, 2 blocks
])
def test_bluestein_source_matches_plain(tmp_path, host, rng, nfft, win, hop, B, length, ffts):
    """stft_bluestein_block at fft_plan.bluestein_plan's launch (or ``ffts``
    transforms a block): every bin of every frame written, equal to the
    plain STFT."""
    x = (0.3 * rng.standard_normal((B, length))).astype(np.float32)
    w = sinebell(win)
    nf = num_frames(length, hop)
    plan = fp.bluestein_plan(B, nf, nfft, win, hop)
    chirp, chat = fp.bluestein_tables(nfft, "cpu")
    for name, arr in (("x", x), ("w", w), ("tw", fp.twiddles(plan.m, "cpu").numpy()),
                      ("chirp", chirp.numpy()), ("chat", chat.numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    args = [plan.m.bit_length() - 1, B, length, win, hop, nf, nfft, ffts or plan.ffts_per_block]
    subprocess.run([str(host["bluestein_stft"]), str(tmp_path), *map(str, args)], check=True,
                   timeout=300)
    out = np.fromfile(tmp_path / "out.bin", np.float32).reshape(2, B, nf, nfft // 2 + 1)
    re, im = stft_pallas_plain(torch.from_numpy(x), w, hop, nfft)
    peak = max(re.abs().max().item(), im.abs().max().item())
    assert np.isfinite(out).all()  # every bin of every frame written
    np.testing.assert_allclose(out[0], re.numpy(), atol=1e-5 * peak, rtol=0)
    np.testing.assert_allclose(out[1], im.numpy(), atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("nfft,win,hop,nt,length,out", [
    (18, 18, 9, 2, 200, "float32"),        # M 64: 8 groups of 4 threads a block
    (18, 18, 9, 1, 200, "int16"),
    (1000, 1000, 250, 1, 3000, "float32"),  # 8 · 125: M 2048, one group of 128 threads
    (1000, 1000, 250, 1, 3000, "int16"),
    (1000, 800, 200, 1, 2500, "float32"),   # nfft past the window
    (6000, 6000, 1500, 1, 3000, "float32"),  # M 16 384: the level, one block
    (6000, 6000, 1500, 1, 3000, "int16"),
    (1001, 1001, 143, 1, 3000, "float32"),  # odd: no Nyquist bin, the last bin twice
    (999, 999, 333, 2, 3000, "int16"),
    (17, 17, 17, 1, 200, "float32"),        # odd, M 64: 8 groups of 4 threads
    (5001, 5001, 1667, 1, 6000, "float32"),  # odd on the level
])
def test_bluestein_istft_source_matches_plain(tmp_path, host, rng, nfft, win, hop, nt, length,
                                               out):
    """istft_bluestein_block at fft_plan.istft_plan's groups and rounds:
    every sample of every signal written, equal to the plain synthesis."""
    nf = num_frames(length, hop)
    bins = nfft // 2 + 1
    re = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    im = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    w = sinebell(win)
    plan = fp.istft_plan(nt, nf, nfft, win, hop)
    m = fp.bluestein_size(nfft)
    assert plan.groups and plan.threads == plan.groups * fp.bluestein_threads(m)
    wn, inv = fp.synthesis_tables(w, nfft, hop, nf, "cpu")
    chirp, chat = fp.bluestein_tables(nfft, "cpu")
    for name, arr in (("re", re), ("im", im), ("wn", wn.numpy()), ("inv", inv.numpy()),
                      ("tw", fp.twiddles(m, "cpu").numpy()), ("chirp", chirp.numpy()),
                      ("chat", chat.numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    int16 = out == "int16"
    args = [m.bit_length() - 1, nt, nf, nfft, win, hop, length, plan.groups, plan.rounds,
            int(int16)]
    subprocess.run([str(host["bluestein_istft"]), str(tmp_path), *map(str, args)], check=True,
                   timeout=300)
    got = np.fromfile(tmp_path / "out.bin", np.int16 if int16 else np.float32).reshape(nt, length)
    ret, imt = torch.from_numpy(re), torch.from_numpy(im)
    if int16:
        want = istft_matmul(ret, imt, w, hop, length, nfft=nfft, algorithm="direct",
                            output_dtype="int16").numpy()
        assert want.dtype == np.int16 and (want != 0).any()
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        want = istft_pallas_plain(ret, imt, w, hop, length, nfft=nfft).numpy()
        assert np.isfinite(got).all()  # every sample written
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
