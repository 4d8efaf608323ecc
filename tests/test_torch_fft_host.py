"""Device bodies of ``csrc/fft_common.cuh`` run on the CPU: compiled with
g++ against a stand-in ``cuda_runtime.h`` (``tests/cuda_host/``: one
std::thread per CUDA thread, a barrier a block for ``__syncthreads``) and
launched as the kernels launch them, with the plans of ``fft_plan``:

* ``stft_split_block`` (``stft_dft.cu::stft_split_kernel``), against
  ``stft_pallas_plain`` within 1e-5 × max|X| (float32 sums in another
  order);
* ``istft_split_block`` (``istft.cu::istft_split_kernel``: the split run
  backwards, the staged rows, the rounds, carry and gather), against
  ``istft_pallas_plain`` within 1e-5 × max|out|, and as PCM16 against the
  plain synthesis quantized within ±1 LSB;
* ``stft_bluestein_block`` (``stft_dft.cu::stft_bluestein_kernel``, its
  transforms synchronizing the block, ``kBlockSync``), on the core and on
  the 16 384-point level (``Level``), against ``stft_pallas_plain`` within
  1e-5 × max|X|;
* ``istft_bluestein_block`` (``istft.cu::istft_bluestein_kernel``:
  Bluestein run backwards, the rounds, carry and gather), on the core and
  on the level, against ``istft_pallas_plain`` within 1e-5 × max|out|, and
  as PCM16 against the plain synthesis quantized within ±1 LSB;
* ``stft_cluster_block`` and ``istft_cluster_block``
  (``stft_dft.cu::stft_cluster_kernel``, ``istft.cu::istft_cluster_kernel``:
  Bluestein over a thread-block cluster, its C blocks at once with their
  own shared memory, ``cluster_sync`` and ``peer``) at parts of 64 and 512
  points (C 2, 4, 8 and 16) and at the card's 8192 (C 4; and C 16, M 131
  072, on one transform pair against numpy's float64 FFT), against the
  plain STFT and iSTFT at the same tolerances;
* ``istft_cluster_dit_block`` (``istft.cu::istft_cluster_dit_kernel``: the
  direct inverse by decimation in time over the cluster, ``ClusterDit``, at
  the powers of two past 8192; each block putting the points of its 1/C of
  both frames' bins) at parts of 64 and 512 points (C 2, 4 and 8) and at the
  card's 8192 (N 16 384 on C 2, N 32 768 on C 4), against the plain
  iSTFT within 1e-5 × max|out|, PCM16 within ±1 LSB;
* ``mixed_fft`` (the mixed-radix block core's Stockham passes of radix 2,
  3, 4, 5, 8, 9 and 16 in a host-planned schedule) at every 5-smooth n it
  serves, against numpy's float64 FFT within 1e-6 × max|X|, and
  ``istft_cluster_mixed_block`` (``istft.cu::istft_cluster_mixed_kernel``:
  the direct inverse over the cluster on that core, ``ClusterMixed``) at
  small parts (C 2, 4 and 8, an odd n), against the plain iSTFT, and at the
  card's W 10 000, 20 000 and 40 000 (C 2, 4, 8 of n 5000) and W 11 250
  (an odd n), against the plain iSTFT or, past its matrices' memory, the
  float64 synthesis, within 1e-5 × max|out|, PCM16 within ±1 LSB;
* ``wiener_common.cuh::wiener_cluster_block``
  (``wiener_istft.cu::wiener_cluster_kernel``: the masked loads of every
  source, bf16 or f32 y, p 1 or 2, ``conserve_last``, the ``ny`` row, and
  the two sources' carries and gather) at parts of 64 and 512 points and at
  the card's 8192 (N 10 000 and 16 384), against ``wiener_istft_plain``
  within 1e-5 × max|out|, PCM16 within ±1 LSB;
* ``wiener_common.cuh::wiener_cluster_dit_block``
  (``wiener_istft.cu::wiener_cluster_dit_kernel``: the direct transform by
  decimation in time over the cluster, ``ClusterDit``, at the powers of two
  past 8192; each block loading its 1/C of the masked points) at parts of 64
  and 512 points (C 2 and 4) and at the card's 8192 (N 16 384 on C 2, N
  32 768 on C 4), against ``wiener_istft_plain`` within 1e-5 × max|out|,
  PCM16 within ±1 LSB;
* ``wiener_split_block`` and ``wiener_bluestein_block``
  (``wiener_istft.cu::wiener_split_kernel``, ``wiener_bluestein_kernel``:
  the same masked loads on the split and on Bluestein run backwards, a
  pair of sources a block, and on the level where two carries do not fit a
  pair of one source's frames) at fft_plan.wiener_plan's launches, at the
  same tolerances.

The kernels' own index maps, twiddle and chirp reads, butterflies, block
and cluster barriers and output guards. Built once per module under
pytest's temporary directory, the fourteen programs at once."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from convsep_tpu_torch.dsp.cuda import fft_plan as fp
from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas_plain
from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas_plain
from convsep_tpu_torch.dsp.dft import istft_matmul
from convsep_tpu_torch.dsp.stft import num_frames
from convsep_tpu_torch.dsp.windows import sinebell

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "convsep_tpu_torch" / "csrc"
PROGRAMS = ("split_stft", "split_istft", "bluestein_stft", "bluestein_istft", "cluster_stft",
            "cluster_istft", "istft_cluster_dit", "istft_cluster_mixed", "wiener_cluster",
            "wiener_cluster_dit",
            "wiener_split", "wiener_bluestein", "level_stft", "level2")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the host emulation")
    out = tmp_path_factory.mktemp("cuda_host")
    procs = {name: subprocess.Popen(
        [gxx, "-std=c++20", "-O1", "-pthread", f"-I{HERE / 'cuda_host'}", f"-I{CSRC}",
         str(HERE / "cuda_host" / f"{name}.cpp"), "-o", str(out / name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in PROGRAMS}
    for name, p in procs.items():
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, f"g++ {name}.cpp failed:\n{log}"
    return {name: out / name for name in PROGRAMS}


@pytest.fixture(scope="module")
def split_stft(host):
    return host["split_stft"]


@pytest.mark.parametrize("nfft,win,hop,B,length", [
    (768, 768, 256, 2, 3000),     # 3 · 256, the smoke's W and hop; 2 transforms a block
    (768, 640, 160, 1, 2000),     # nfft past the window
    (1280, 1280, 320, 1, 3001),   # 5 · 256
    (2304, 2304, 576, 1, 5000),   # 9 · 256 (3 × 3 in registers)
    (240, 240, 60, 1, 2000),      # 15 · 16 (3 × 5): 32 transforms of 15 threads a block
    (48, 48, 12, 1, 1),           # 3 · 16, one sample: 3 frames
    (1536, 1536, 384, 1, 4000),   # 3 · 512: a sub-FFT of a whole warp
])
def test_split_kernel_source_matches_plain(tmp_path, split_stft, rng, nfft, win, hop, B, length):
    x = (0.3 * rng.standard_normal((B, length))).astype(np.float32)
    w = sinebell(win)
    nf = num_frames(length, hop)
    plan = fp.split_plan(B, nf, nfft, win, hop)
    x.tofile(tmp_path / "x.bin")
    w.astype(np.float32).tofile(tmp_path / "w.bin")
    fp.twiddles(plan.p, "cpu").numpy().tofile(tmp_path / "twp.bin")
    fp.twiddles(nfft, "cpu").numpy().tofile(tmp_path / "twn.bin")
    args = [plan.m, plan.p.bit_length() - 1, B, length, win, hop, nf, plan.ffts_per_block]
    subprocess.run([str(split_stft), str(tmp_path), *map(str, args)], check=True, timeout=300)
    out = np.fromfile(tmp_path / "out.bin", np.float32).reshape(2, B, nf, nfft // 2 + 1)
    re, im = stft_pallas_plain(torch.from_numpy(x), w, hop, nfft)
    peak = max(re.abs().max().item(), im.abs().max().item())
    assert np.isfinite(out).all()  # every bin of every frame written
    np.testing.assert_allclose(out[0], re.numpy(), atol=1e-5 * peak, rtol=0)
    np.testing.assert_allclose(out[1], im.numpy(), atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("nfft,win,hop,nt,length,out", [
    (768, 768, 256, 2, 3000, "float32"),   # 3 · 256, the smoke's W and hop
    (768, 768, 256, 1, 3000, "int16"),
    (768, 640, 160, 1, 2000, "float32"),   # nfft past the window
    (1280, 1280, 320, 1, 3001, "float32"),  # 5 · 256
    (2304, 2304, 576, 1, 5000, "float32"),  # 9 · 256
    (240, 240, 60, 1, 1500, "int16"),      # 15 · 16: groups of 15 threads share warps
    (48, 48, 12, 1, 300, "float32"),       # 3 · 16
    (80, 80, 40, 2, 400, "float32"),       # 5 · 16, hop = W/2
    (6144, 6144, 1536, 1, 12000, "float32"),  # 3 · 2048, the split's largest P
])
def test_split_istft_source_matches_plain(tmp_path, host, rng, nfft, win, hop, nt, length, out):
    """istft_split_block at fft_plan.istft_plan's groups and rounds: every
    sample of every signal written, equal to the plain synthesis."""
    nf = num_frames(length, hop)
    bins = nfft // 2 + 1
    re = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    im = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    w = sinebell(win)
    plan = fp.istft_plan(nt, nf, nfft, win, hop)
    m, p = fp.split_factors(nfft)
    assert plan.groups and plan.threads == plan.groups * nfft // fp.POINTS
    wn, inv = fp.synthesis_tables(w, nfft, hop, nf, "cpu")
    for name, arr in (("re", re), ("im", im), ("wn", wn.numpy()), ("inv", inv.numpy()),
                      ("twp", fp.twiddles(p, "cpu").numpy()),
                      ("twn", fp.twiddles(nfft, "cpu").numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    int16 = out == "int16"
    args = [m, p.bit_length() - 1, nt, nf, win, hop, length, plan.groups, plan.rounds, int(int16)]
    subprocess.run([str(host["split_istft"]), str(tmp_path), *map(str, args)], check=True,
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


# every block size n of the mixed cluster's 87 sizes (fft_plan.mixed_factors)
MIXED_BLOCK_SIZES = sorted({fp.mixed_factors(n)[1] for n in range(fp.MAX_NFFT + 2,
                                                                  fp.CLUSTER_NFFT + 1, 2)
                            if fp.mixed_factors(n)})


@pytest.mark.parametrize("n", MIXED_BLOCK_SIZES)
def test_mixed_fft_source_matches_numpy(tmp_path, host, rng, n):
    """mixed_fft, the mixed cluster's block transform, on one block of the
    card's 512 threads in the passes fft_plan.mixed_radices plans, the
    twiddles from the n-point table (fft_plan.dft_table): the forward DFT of
    random complex points against numpy's float64 FFT within 1e-6 ×
    max|X|, every output written."""
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    x.view(np.float32).tofile(tmp_path / "x.bin")
    fp.dft_table(n, "cpu").numpy().tofile(tmp_path / "tw.bin")
    sched = fp.mixed_schedule(fp.mixed_radices(n))
    subprocess.run([str(host["istft_cluster_mixed"]), "fft", str(tmp_path), str(n), "512",
                    str(sched)], check=True, timeout=300)
    got = np.fromfile(tmp_path / "out.bin", np.float32).view(np.complex64)
    want = np.fft.fft(x.astype(np.complex128))
    assert np.isfinite(got.view(np.float32)).all()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)


def _istft64(re, im, w, nfft, hop, length, inv):
    """The float64 synthesis: numpy's inverse real FFT of the float32
    spectra, the float32 window, overlap-add, the float32 envelope the
    kernel reads, the win/2 front trim."""
    win, nf = len(w), re.shape[-2]
    frames = (np.fft.irfft(re.astype(np.float64) + 1j * im.astype(np.float64), nfft,
                           axis=-1)[..., :win] * w.astype(np.float32).astype(np.float64))
    ola = np.zeros((re.shape[0], (nf - 1) * hop + win))
    for f in range(nf):
        ola[:, f * hop:f * hop + win] += frames[:, f]
    return ola[:, win // 2:win // 2 + length] * inv[win // 2:win // 2 + length]


# (nfft, win, hop, nt, length, C, threads a block, rounds (None:
# fft_plan.istft_cluster_mixed_plan's), out): n = nfft / C
ISTFT_CLUSTER_MIXED_CASES = [
    (120, 120, 30, 2, 600, 2, 32, 3, "float32"),    # n 60 = 4·5·3; nf 22, odd pairs
    (540, 540, 135, 1, 2000, 4, 32, 3, "int16"),    # n 135 = 5·9·3, odd: no quarter table
    (2000, 1000, 250, 1, 4000, 8, 32, 4, "float32"),  # n 250 = 2·5·5·5; nfft past the window
    (60, 60, 2, 1, 80, 2, 4, 16, "float32"),        # hop 2: a column a block, k 30
    (10_000, 10_000, 2500, 1, 6000, 2, 512, None, "float32"),  # the card's: C 2 of n 5000
    (10_000, 10_000, 2500, 1, 6000, 2, 512, None, "int16"),
    (20_000, 20_000, 5000, 1, 10_000, 4, 512, None, "float32"),  # C 4
    (20_000, 20_000, 5000, 1, 10_000, 4, 512, None, "int16"),
    (40_000, 40_000, 10_000, 1, 20_000, 8, 512, None, "float32"),  # C 8
    (40_000, 40_000, 10_000, 1, 20_000, 8, 512, None, "int16"),
    (11_250, 11_250, 2250, 1, 6000, 2, 512, None, "float32"),  # n 5625 = 5^4·9, odd
]


@pytest.mark.parametrize("nfft,win,hop,nt,length,c,threads,rounds,out",
                         ISTFT_CLUSTER_MIXED_CASES)
def test_istft_cluster_mixed_source_matches_plain(tmp_path, host, rng, nfft, win, hop, nt,
                                                  length, c, threads, rounds, out):
    """istft_cluster_mixed_block as istft_cluster_mixed_kernel launches it
    (a cluster of C blocks a row range, one pair of frames a round, block r
    the points r mod C on the mixed-radix core): every sample of every
    signal written, within 1e-5 × max|out| of the plain iSTFT
    (istft_pallas_plain) up to 10 000 points and of the float64 synthesis
    past it (the plain version's direct matrices are 1.6 GB at 20 000 and
    6.4 GB at 40 000), PCM16 within ±1 LSB of the same quantized."""
    nf = num_frames(length, hop)
    bins = nfft // 2 + 1
    n = nfft // c
    if rounds is None:
        plan = fp.istft_cluster_mixed_plan(nt, nf, nfft, win, hop)
        assert fp.mixed_factors(nfft) == (c, n)
        assert (plan.route, plan.cluster, plan.threads) == ("cluster_mixed", c, 512)
        rounds = plan.rounds
    re = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    im = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    w = sinebell(win)
    wn, inv = fp.synthesis_tables(w, nfft, hop, nf, "cpu")
    for name, arr in (("re", re), ("im", im), ("wn", wn.numpy()), ("inv", inv.numpy()),
                      ("tw", fp.dft_table(nfft, "cpu").numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    int16 = out == "int16"
    args = [c, n, threads, nt, nf, win, hop, length, rounds, int(int16),
            fp.mixed_schedule(fp.mixed_radices(n))]
    subprocess.run([str(host["istft_cluster_mixed"]), "istft", str(tmp_path), *map(str, args)],
                   check=True, timeout=300)
    got = np.fromfile(tmp_path / "out.bin", np.int16 if int16 else np.float32).reshape(nt, length)
    if nfft <= 10_000:
        want = istft_pallas_plain(torch.from_numpy(re), torch.from_numpy(im), w, hop, length,
                                  nfft=nfft).numpy().astype(np.float64)
    else:
        want = _istft64(re, im, w, nfft, hop, length, inv.numpy())
    if int16:
        q = np.clip(np.rint(want * 32768.0), -32768, 32767).astype(np.int32)
        assert (q != 0).any() and np.abs(got.astype(np.int32) - q).max() <= 1
    else:
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


def _wiener_inputs(tmp_path, rng, nfft, hop, nt, S, length, ydt, has_ny):
    """The Wiener programs' inputs, written to tmp_path: nt random tracks'
    mixture spectra (the N/2-bin bodies and the Nyquist row with
    ``has_ny``), magnitudes y with dead bins (the eps shortfall paths) in
    ``ydt``, the window's synthesis tables. Returns (w, nf, y, re, im, ny)."""
    from convsep_tpu_torch.dsp.dft import stft_matmul

    w = sinebell(nfft)
    x = torch.from_numpy((0.3 * rng.standard_normal((nt, length))).astype(np.float32))
    re, im = stft_matmul(x, w, hop)
    nf = re.shape[-2]
    y = np.abs(rng.standard_normal((nt, S, nf, nfft // 2 + 1))).astype(np.float32)
    y[..., : nf // 3, :8] = 0.0  # dead bins: the eps shortfall paths
    y = torch.from_numpy(y).to(torch.bfloat16 if ydt == "bfloat16" else torch.float32)
    ny = None
    if has_ny:
        re, im, ny = re[..., :-1].contiguous(), im[..., :-1].contiguous(), re[..., -1].contiguous()
    wn, inv = fp.synthesis_tables(w, nfft, hop, nf, "cpu")
    y_bits = y.view(torch.int16).numpy() if ydt == "bfloat16" else y.numpy()
    for name, arr in (("re", re.numpy()), ("im", im.numpy()), ("wn", wn.numpy()),
                      ("inv", inv.numpy()), *([("ny", ny.numpy())] if has_ny else [])):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    np.ascontiguousarray(y_bits).tofile(tmp_path / "y.bin")
    return w, nf, y, re, im, ny


def _wiener_check(tmp_path, y, re, im, ny, w, hop, length, kw, out):
    """The program's stems against wiener_istft_plain: float32 within 1e-5 ×
    max|out| with every sample written, PCM16 within ±1 LSB."""
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft_plain

    int16 = out == "int16"
    got = np.fromfile(tmp_path / "out.bin", np.int16 if int16 else np.float32)
    got = got.reshape(*re.shape[:-2], y.shape[-3], length)
    want = wiener_istft_plain(y, re, im, w, hop, length, output_dtype=out, ny=ny, **kw).numpy()
    if int16:
        assert want.dtype == np.int16 and (want != 0).any()
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        assert np.isfinite(got).all()  # every sample of every stem written
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def _wiener_tail(kw, ydt, has_ny, out):
    """The programs' last arguments: YBF16 P2 EPS CONSERVE HASNY INT16."""
    return [int(ydt == "bfloat16"), int(kw.get("p", 1.0) == 2.0), repr(1e-8),
            int(kw.get("conserve_last", False)), int(has_ny), int(out == "int16")]


# (nfft, hop, nt, S, length, log2p, rounds (None: fft_plan.wiener_plan's),
# y dtype, keyword arguments of wiener_istft, out): C = M / 2^LOG2P blocks
WIENER_CLUSTER_CASES = [
    (100, 25, 1, 4, 500, 6, 5, "float32", {}, "float32"),  # M 256: C 4; 2 rows a cluster
    (200, 50, 2, 3, 900, 6, 6, "bfloat16", {"p": 2.0}, "float32"),  # C 8; S odd: no s1
    (128, 32, 1, 2, 600, 6, 4, "float32", {"conserve_last": True, "ny": True}, "int16"),
    (1000, 250, 1, 4, 3000, 9, 7, "bfloat16", {"conserve_last": True}, "int16"),  # C 4
    (2000, 500, 1, 5, 4000, 9, 9, "float32", {"p": 2.0, "ny": True}, "float32"),  # C 8
    (10_000, 2500, 1, 4, 12_000, 13, None, "float32", {}, "float32"),  # the card's part: C 4
    (16_384, 2048, 1, 4, 6144, 13, None, "bfloat16",  # the reference's 16 384: 5 frames
     {"p": 2.0, "conserve_last": True, "ny": True}, "float32"),
]
# the plan of the cases whose rounds are None: wiener_cluster_plan's, which
# wiener_plan takes at the even sizes past 8192 that are not powers of two
# and wiener_bluestein_cluster_pallas forces at the powers of two


@pytest.mark.parametrize("nfft,hop,nt,S,length,log2p,rounds,ydt,kw,out", WIENER_CLUSTER_CASES)
def test_wiener_cluster_source_matches_plain(tmp_path, host, rng, nfft, hop, nt, S, length,
                                             log2p, rounds, ydt, kw, out):
    """wiener_cluster_block as wiener_cluster_kernel launches it (a cluster
    a pair of sources and a row range, one frame a round): every sample of
    every stem written, equal to wiener_istft_plain within 1e-5 ×
    max|out|, PCM16 within ±1 LSB."""
    kw = dict(kw)
    has_ny = kw.pop("ny", False)
    w, nf, y, re, im, ny = _wiener_inputs(tmp_path, rng, nfft, hop, nt, S, length, ydt, has_ny)
    m = fp.bluestein_size(nfft)
    c = m >> log2p
    if rounds is None:
        plan = fp.wiener_cluster_plan(nt, S, nf, nfft, hop)
        assert (plan.cluster, plan.threads, plan.route) == (c, 512, "cluster")
        assert fp.wiener_plan(nt, S, nf, nfft, hop) == plan or nfft & (nfft - 1) == 0
        rounds = plan.rounds
    chirp, chat = fp.bluestein_tables(nfft, "cpu")
    for name, arr in (("tw", fp.twiddles(m, "cpu").numpy()), ("chirp", chirp.numpy()),
                      ("chat", chat.numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    args = [log2p, c, nt, S, nf, nfft, hop, length, rounds, *_wiener_tail(kw, ydt, has_ny, out)]
    subprocess.run([str(host["wiener_cluster"]), str(tmp_path), *map(str, args)], check=True,
                   timeout=300)
    _wiener_check(tmp_path, y, re, im, ny, w, hop, length, kw, out)


# (nfft, hop, nt, S, length, log2p, rounds (None: fft_plan.wiener_plan's),
# y dtype, keyword arguments of wiener_istft, out): C = nfft / 2^LOG2P blocks
WIENER_CLUSTER_DIT_CASES = [
    (128, 32, 1, 4, 600, 6, 5, "float32", {}, "float32"),  # C 2; 2 rows a cluster
    (256, 64, 2, 3, 900, 6, 6, "bfloat16", {"p": 2.0}, "float32"),  # C 4; S odd: no s1
    (128, 64, 1, 2, 700, 6, 4, "float32", {"conserve_last": True, "ny": True}, "int16"),
    (256, 2, 1, 2, 300, 6, 160, "float32", {"p": 2.0}, "float32"),  # hop 2: blocks 2, 3 idle
    (1024, 256, 1, 4, 3000, 9, 7, "bfloat16", {"conserve_last": True}, "int16"),  # C 2
    (2048, 512, 1, 5, 4000, 9, 9, "float32", {"p": 2.0, "ny": True}, "float32"),  # C 4
    (2048, 128, 1, 1, 3000, 9, 24, "bfloat16", {}, "float32"),  # k 16, one source
    (16_384, 2048, 1, 4, 6144, 13, None, "bfloat16",  # the reference's 16 384 on C 2
     {"p": 2.0, "conserve_last": True, "ny": True}, "float32"),
    (16_384, 4096, 1, 3, 8192, 13, None, "float32", {"p": 2.0}, "int16"),  # S odd, PCM16
    (32_768, 8192, 1, 2, 8192, 13, None, "float32", {"conserve_last": True}, "float32"),  # C 4
]


@pytest.mark.parametrize("nfft,hop,nt,S,length,log2p,rounds,ydt,kw,out",
                         WIENER_CLUSTER_DIT_CASES)
def test_wiener_cluster_dit_source_matches_plain(tmp_path, host, rng, nfft, hop, nt, S, length,
                                                 log2p, rounds, ydt, kw, out):
    """wiener_cluster_dit_block as wiener_cluster_dit_kernel launches it (a
    cluster of C blocks a pair of sources and a row range, one frame a
    round, block r the points r mod C): every sample of every stem written,
    equal to wiener_istft_plain within 1e-5 × max|out|, PCM16 within ±1
    LSB."""
    kw = dict(kw)
    has_ny = kw.pop("ny", False)
    w, nf, y, re, im, ny = _wiener_inputs(tmp_path, rng, nfft, hop, nt, S, length, ydt, has_ny)
    c = nfft >> log2p
    if rounds is None:
        plan = fp.wiener_plan(nt, S, nf, nfft, hop)
        assert (plan.cluster, plan.threads, plan.route) == (c, 512, "cluster_dit")
        rounds = plan.rounds
    np.ascontiguousarray(fp.twiddles(nfft, "cpu").numpy(), np.float32).tofile(tmp_path / "tw.bin")
    args = [log2p, c, nt, S, nf, hop, length, rounds, *_wiener_tail(kw, ydt, has_ny, out)]
    subprocess.run([str(host["wiener_cluster_dit"]), str(tmp_path), *map(str, args)], check=True,
                   timeout=300)
    _wiener_check(tmp_path, y, re, im, ny, w, hop, length, kw, out)


# (nfft, hop, nt, S, length, y dtype, keyword arguments of wiener_istft, out)
WIENER_SPLIT_CASES = [
    (384, 96, 1, 4, 3000, "float32", {}, "float32"),            # 3 · 128: 4 groups of 24
    (384, 96, 2, 3, 2000, "bfloat16", {"p": 2.0}, "int16"),     # S odd: the last pair has no s1
    (768, 256, 1, 4, 4000, "bfloat16", {"conserve_last": True}, "float32"),  # the smoke's W, hop
    (768, 192, 1, 3, 3000, "float32", {"p": 2.0, "ny": True}, "float32"),  # k 4, the ny row
    (1280, 320, 1, 2, 5000, "bfloat16", {"conserve_last": True, "ny": True}, "int16"),  # 5 · 256
    (240, 60, 1, 5, 1500, "float32", {"p": 2.0}, "float32"),    # 15 · 16: 32 groups of 15 threads
]


@pytest.mark.parametrize("nfft,hop,nt,S,length,ydt,kw,out", WIENER_SPLIT_CASES)
def test_wiener_split_source_matches_plain(tmp_path, host, rng, nfft, hop, nt, S, length, ydt,
                                           kw, out):
    """wiener_split_block at fft_plan.wiener_plan's groups and rounds (a
    block a pair of sources and a row range, a group one frame of the pair,
    the masked loads at the split's stride, two carries): every sample of
    every stem written, equal to wiener_istft_plain within 1e-5 × max|out|,
    PCM16 within ±1 LSB."""
    kw = dict(kw)
    has_ny = kw.pop("ny", False)
    w, nf, y, re, im, ny = _wiener_inputs(tmp_path, rng, nfft, hop, nt, S, length, ydt, has_ny)
    plan = fp.wiener_plan(nt, S, nf, nfft, hop)
    m, p = fp.split_factors(nfft)
    assert plan.route == "split" and plan.threads == plan.groups * nfft // fp.POINTS
    for name, arr in (("twp", fp.twiddles(p, "cpu").numpy()),
                      ("twn", fp.twiddles(nfft, "cpu").numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    args = [m, p.bit_length() - 1, nt, S, nf, hop, length, plan.groups, plan.rounds,
            *_wiener_tail(kw, ydt, has_ny, out)]
    subprocess.run([str(host["wiener_split"]), str(tmp_path), *map(str, args)], check=True,
                   timeout=300)
    _wiener_check(tmp_path, y, re, im, ny, w, hop, length, kw, out)


# (nfft, hop, nt, S, length, y dtype, keyword arguments of wiener_istft, out,
# frame pairs)
WIENER_BLUESTEIN_CASES = [
    (18, 9, 2, 3, 200, "float32", {}, "float32", False),        # M 64: 8 groups of 4; S odd
    (18, 6, 1, 4, 200, "bfloat16", {"p": 2.0, "ny": True}, "int16", False),
    (1000, 250, 1, 4, 3000, "bfloat16", {}, "float32", False),  # 8 · 125: M 2048, the smoke's
    (1000, 250, 1, 3, 3000, "float32", {"conserve_last": True}, "int16", False),
    (2000, 500, 1, 4, 4000, "float32", {"p": 2.0, "ny": True}, "float32", False),  # M 4096
    (6000, 1500, 1, 4, 3000, "bfloat16", {"conserve_last": True}, "float32", False),  # the level
    (6000, 1500, 1, 3, 3000, "float32", {"p": 2.0}, "int16", False),
    (8190, 910, 1, 3, 3000, "bfloat16", {"p": 2.0, "conserve_last": True, "ny": True},
     "float32", True),                                          # the level's frame pairs: k 9
    (8190, 910, 1, 2, 2000, "float32", {}, "int16", True),
]


@pytest.mark.parametrize("nfft,hop,nt,S,length,ydt,kw,out,pairs", WIENER_BLUESTEIN_CASES)
def test_wiener_bluestein_source_matches_plain(tmp_path, host, rng, nfft, hop, nt, S, length,
                                               ydt, kw, out, pairs):
    """wiener_bluestein_block at fft_plan.wiener_plan's groups and rounds, on
    the core and on the level (a pair of sources a block, two carries), and
    on the level where two carries do not fit (frame pairs: a source a
    block, a pair of its frames a group, one carry): every sample of every
    stem written, equal to wiener_istft_plain within 1e-5 × max|out|,
    PCM16 within ±1 LSB."""
    kw = dict(kw)
    has_ny = kw.pop("ny", False)
    w, nf, y, re, im, ny = _wiener_inputs(tmp_path, rng, nfft, hop, nt, S, length, ydt, has_ny)
    plan = fp.wiener_plan(nt, S, nf, nfft, hop)
    m = fp.bluestein_size(nfft)
    assert plan.route == "bluestein" and plan.frame_pairs == pairs
    assert plan.threads == plan.groups * fp.bluestein_threads(m)
    assert plan.pairs == (S if pairs else (S + 1) // 2)
    chirp, chat = fp.bluestein_tables(nfft, "cpu")
    for name, arr in (("tw", fp.twiddles(m, "cpu").numpy()), ("chirp", chirp.numpy()),
                      ("chat", chat.numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    args = [m.bit_length() - 1, nt, S, nf, nfft, hop, length, plan.groups, plan.rounds,
            int(pairs), *_wiener_tail(kw, ydt, has_ny, out)]
    subprocess.run([str(host["wiener_bluestein"]), str(tmp_path), *map(str, args)], check=True,
                   timeout=300)
    _wiener_check(tmp_path, y, re, im, ny, w, hop, length, kw, out)


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
