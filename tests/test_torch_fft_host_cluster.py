"""The cluster's device bodies on the CPU (the stand-in runtime and
:func:`tests.test_torch_fft_host.programs`: a cluster's C blocks at once
with their own shared memory, ``cluster_sync`` and ``peer``):

* ``stft_cluster_block`` and ``istft_cluster_block``
  (``stft_dft.cu::stft_cluster_kernel``, ``istft.cu::istft_cluster_kernel``:
  Bluestein over a thread-block cluster) at parts of 64 and 512 points (C
  2, 4, 8 and 16) and at the card's 8192 (C 4; and C 16, M 131 072, on one
  transform pair against numpy's float64 FFT), against the plain STFT and
  iSTFT within 1e-5 × max|X| and 1e-5 × max|out|, PCM16 within ±1 LSB;
* ``istft_cluster_dit_block`` (``istft.cu::istft_cluster_dit_kernel``: the
  direct inverse by decimation in time over the cluster, ``ClusterDit``, at
  the powers of two past 8192; each block putting the points of its 1/C of
  both frames' bins) at parts of 64 and 512 points (C 2, 4 and 8) and at the
  card's 8192 (N 16 384 on C 2, N 32 768 on C 4), against the plain iSTFT
  within 1e-5 × max|out|, PCM16 within ±1 LSB."""

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

host = programs("cluster_stft", "cluster_istft", "istft_cluster_dit")


# (nfft, win, hop, B, length, log2 of a block's part): C = M / 2^LOG2P blocks
# a cluster, M = bluestein_size(nfft)
CLUSTER_STFT_CASES = [
    (50, 50, 25, 2, 300, 6),        # M 128: C 2
    (100, 100, 25, 1, 400, 6),      # M 256: C 4
    (101, 101, 101, 2, 700, 6),     # odd
    (200, 160, 40, 1, 600, 6),      # M 512: C 8; nfft past the window
    (300, 300, 75, 1, 900, 9),      # M 1024: C 2, a block of 32 threads
    (1000, 1000, 250, 2, 2000, 9),  # M 2048: C 4
    (1801, 1801, 1801, 1, 2000, 9),  # M 4096: C 8, odd
    (10000, 10000, 2500, 1, 3000, 13),  # the card's part, 8192: C 4, 2 clusters
    (300, 300, 75, 2, 900, 6),      # M 1024: C 16
    (511, 400, 100, 1, 700, 6),     # C 16, odd, nfft past the window
    (3000, 3000, 750, 1, 3000, 9),  # M 8192: C 16, a block of 32 threads
]


@pytest.mark.parametrize("nfft,win,hop,B,length,log2p", CLUSTER_STFT_CASES)
def test_cluster_stft_source_matches_plain(tmp_path, host, rng, nfft, win, hop, B, length, log2p):
    """stft_cluster_block as stft_cluster_kernel launches it (a cluster of
    C blocks a pair of frames): every bin of every frame written, equal to
    the plain STFT within 1e-5 × max|X|."""
    x = (0.3 * rng.standard_normal((B, length))).astype(np.float32)
    w = sinebell(win)
    nf = num_frames(length, hop)
    m = fp.bluestein_size(nfft)
    c = m >> log2p
    chirp, chat = fp.bluestein_tables(nfft, "cpu")
    for name, arr in (("x", x), ("w", w), ("tw", fp.twiddles(m, "cpu").numpy()),
                      ("chirp", chirp.numpy()), ("chat", chat.numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    args = [log2p, c, B, length, win, hop, nf, nfft]
    subprocess.run([str(host["cluster_stft"]), str(tmp_path), *map(str, args)], check=True,
                   timeout=300)
    out = np.fromfile(tmp_path / "out.bin", np.float32).reshape(2, B, nf, nfft // 2 + 1)
    re, im = stft_pallas_plain(torch.from_numpy(x), w, hop, nfft)
    peak = max(re.abs().max().item(), im.abs().max().item())
    assert np.isfinite(out).all()  # every bin of every frame written, no unwritten point read
    np.testing.assert_allclose(out[0], re.numpy(), atol=1e-5 * peak, rtol=0)
    np.testing.assert_allclose(out[1], im.numpy(), atol=1e-5 * peak, rtol=0)


# (nfft, win, hop, nt, length, log2p, rounds, out)
CLUSTER_ISTFT_CASES = [
    (50, 50, 25, 2, 300, 6, 3, "float32"),    # C 2; rounds of a pair, 5 rows a cluster
    (100, 100, 25, 1, 500, 6, 3, "float32"),  # C 4: k 4, 3 rows a cluster
    (100, 100, 25, 1, 500, 6, 2, "int16"),    # one row a cluster
    (200, 160, 40, 2, 900, 6, 5, "float32"),  # C 8; nfft past the window
    (202, 202, 101, 1, 700, 6, 4, "float32"),  # C 8: 101 columns over 8 blocks (13 a block)
    (1000, 1000, 250, 1, 3000, 9, 4, "int16"),  # C 4
    (1800, 1800, 200, 1, 5000, 9, 7, "float32"),  # C 8, k 9
    (10000, 10000, 2500, 1, 9000, 13, 3, "float32"),  # the card's part: C 4, 3 clusters
    (400, 400, 100, 2, 1500, 6, 4, "float32"),  # C 16: 100 columns over 16 blocks (7 a block)
    (300, 240, 60, 1, 1200, 6, 3, "int16"),     # C 16, nfft past the window
    (3000, 3000, 750, 1, 6000, 9, 4, "float32"),  # M 8192: C 16
    (101, 101, 101, 2, 700, 6, 3, "float32"),   # odd: C 4
    (999, 999, 333, 1, 3000, 9, 4, "int16"),    # odd: C 4
    (9999, 9999, 1111, 1, 9000, 13, 6, "float32"),  # odd, the card's part: C 4, k 9
]


@pytest.mark.parametrize("nfft,win,hop,nt,length,log2p,rounds,out", CLUSTER_ISTFT_CASES)
def test_cluster_istft_source_matches_plain(tmp_path, host, rng, nfft, win, hop, nt, length,
                                            log2p, rounds, out):
    """istft_cluster_block as istft_cluster_kernel launches it: every
    sample of every signal written, equal to the plain synthesis within
    1e-5 × max|out|, PCM16 within ±1 LSB."""
    nf = num_frames(length, hop)
    bins = nfft // 2 + 1
    re = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    im = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    w = sinebell(win)
    m = fp.bluestein_size(nfft)
    wn, inv = fp.synthesis_tables(w, nfft, hop, nf, "cpu")
    chirp, chat = fp.bluestein_tables(nfft, "cpu")
    for name, arr in (("re", re), ("im", im), ("wn", wn.numpy()), ("inv", inv.numpy()),
                      ("tw", fp.twiddles(m, "cpu").numpy()), ("chirp", chirp.numpy()),
                      ("chat", chat.numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    int16 = out == "int16"
    args = [log2p, m >> log2p, nt, nf, nfft, win, hop, length, rounds, int(int16)]
    subprocess.run([str(host["cluster_istft"]), str(tmp_path), *map(str, args)], check=True,
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


# (nfft, win, hop, nt, length, log2p, rounds (None: fft_plan.istft_plan's),
# out): C = nfft / 2^LOG2P blocks
ISTFT_CLUSTER_DIT_CASES = [
    (128, 128, 32, 2, 600, 6, 3, "float32"),   # C 2, k 4: 3 rows a cluster; nf 21, odd
    (256, 256, 64, 1, 900, 6, 4, "int16"),     # C 4: 5 rows a cluster; nf 17
    (256, 192, 48, 1, 700, 6, 3, "float32"),   # C 4, nfft past the window
    (512, 512, 128, 2, 2000, 6, 5, "float32"),  # C 8: 16 columns a block
    (512, 256, 64, 1, 1500, 6, 4, "int16"),    # C 8, nfft past the window
    (128, 128, 2, 1, 300, 6, 70, "float32"),   # hop 2 on C 2: a column a block, k 64
    (1024, 1024, 256, 1, 3000, 9, 4, "float32"),  # C 2
    (2048, 1024, 128, 1, 3000, 9, 6, "int16"),  # C 4, nfft past the window, k 8
    (16_384, 16_384, 2048, 1, 6144, 13, None, "float32"),  # the reference's 16 384 on C 2
    (32_768, 16_384, 4096, 1, 8192, 13, None, "int16"),  # 32 768 on C 4, a half window
]


@pytest.mark.parametrize("nfft,win,hop,nt,length,log2p,rounds,out", ISTFT_CLUSTER_DIT_CASES)
def test_istft_cluster_dit_source_matches_plain(tmp_path, host, rng, nfft, win, hop, nt, length,
                                                log2p, rounds, out):
    """istft_cluster_dit_block as istft_cluster_dit_kernel launches it (a
    cluster of C blocks a row range, one pair of frames a round, block r the
    points r mod C; a pair past the last frame loads zeros for its frame b):
    every sample of every signal written, equal to the plain synthesis
    within 1e-5 × max|out|, PCM16 within ±1 LSB."""
    nf = num_frames(length, hop)
    bins = nfft // 2 + 1
    c = nfft >> log2p
    if rounds is None:
        plan = fp.istft_plan(nt, nf, nfft, win, hop)
        assert (plan.route, plan.cluster, plan.threads) == ("cluster_dit", c, 512)
        rounds = plan.rounds
    re = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    im = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    w = sinebell(win)
    wn, inv = fp.synthesis_tables(w, nfft, hop, nf, "cpu")
    for name, arr in (("re", re), ("im", im), ("wn", wn.numpy()), ("inv", inv.numpy()),
                      ("tw", fp.twiddles(nfft, "cpu").numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    int16 = out == "int16"
    args = [log2p, c, nt, nf, win, hop, length, rounds, int(int16)]
    subprocess.run([str(host["istft_cluster_dit"]), str(tmp_path), *map(str, args)], check=True,
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


def test_cluster16_stft_source_matches_numpy(tmp_path, host, rng):
    """stft_cluster_block<13, 16>, the card's instance for 32 768 < nfft <=
    65 536 (M 131 072 on 16 blocks of 8192 points, 8192 threads at once
    here), on one transform pair: frames 0 and 1 of a W 40 000 signal
    against numpy's float64 FFT of the same windowed frames, within 1e-5 ×
    max|X|."""
    nfft = hop = 40_000
    length, nf = 50_000, 2
    assert fp.bluestein_size(nfft) == 16 * fp.CLUSTER_PART == 131_072
    x = (0.3 * rng.standard_normal((1, length))).astype(np.float32)
    w = sinebell(nfft)
    chirp, chat = fp.bluestein_tables(nfft, "cpu")
    for name, arr in (("x", x), ("w", w), ("tw", fp.twiddles(131_072, "cpu").numpy()),
                      ("chirp", chirp.numpy()), ("chat", chat.numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    args = [13, 16, 1, length, nfft, hop, nf, nfft]
    subprocess.run([str(host["cluster_stft"]), str(tmp_path), *map(str, args)], check=True,
                   timeout=300)
    out = np.fromfile(tmp_path / "out.bin", np.float32).reshape(2, nf, nfft // 2 + 1)
    padded = np.concatenate([np.zeros(nfft // 2), x[0].astype(np.float64), np.zeros(nfft)])
    want = np.fft.rfft(np.stack([padded[f * hop:f * hop + nfft] for f in range(nf)])
                       * w.astype(np.float32).astype(np.float64))
    peak = np.abs(want).max()
    assert np.isfinite(out).all()  # every bin of both frames written
    np.testing.assert_allclose(out[0], want.real, atol=1e-5 * peak, rtol=0)
    np.testing.assert_allclose(out[1], want.imag, atol=1e-5 * peak, rtol=0)
