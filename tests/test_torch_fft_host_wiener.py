"""The Wiener+iSTFT's device bodies on the CPU (the stand-in runtime and
:func:`tests.test_torch_fft_host.programs`), each against
``wiener_istft_plain`` within 1e-5 × max|out| with every sample of every
stem written, PCM16 within ±1 LSB:

* ``wiener_common.cuh::wiener_cluster_block``
  (``wiener_istft.cu::wiener_cluster_kernel``: the masked loads of every
  source, bf16 or f32 y, p 1 or 2, ``conserve_last``, the ``ny`` row, and
  the two sources' carries and gather) at parts of 64 and 512 points and at
  the card's 8192 (N 10 000 and 16 384);
* ``wiener_common.cuh::wiener_cluster_dit_block``
  (``wiener_istft.cu::wiener_cluster_dit_kernel``: the direct transform by
  decimation in time over the cluster, ``ClusterDit``, at the powers of two
  past 8192; each block loading its 1/C of the masked points) at parts of 64
  and 512 points (C 2 and 4) and at the card's 8192 (N 16 384 on C 2, N
  32 768 on C 4);
* ``wiener_common.cuh::wiener_cluster_mixed_block``
  (``wiener_istft.cu::wiener_cluster_mixed_kernel``: the same over the
  7-smooth block core, ``ClusterMixed``; each block masking its ceil(N / 2
  / C) bins, guarded at the share's end) at small parts (C 2 to 6, odd n,
  k up to 16, radix-7 passes) and at the card's W 10 000 and 14 000 (C 2 of
  n 5000 and 7000) and W 22 050 (C 3 of n 7350), 512 threads;
* ``wiener_split_block`` and ``wiener_bluestein_block``
  (``wiener_istft.cu::wiener_split_kernel``, ``wiener_bluestein_kernel``:
  the same masked loads on the split and on Bluestein run backwards, a
  pair of sources a block, and on the level where two carries do not fit a
  pair of one source's frames) at fft_plan.wiener_plan's launches."""

import subprocess

import numpy as np
import pytest

from convsep_tpu_torch.dsp.cuda import fft_plan as fp
from tests.test_torch_fft_host import _wiener_check, _wiener_inputs, _wiener_tail, programs

host = programs("wiener_cluster", "wiener_cluster_dit", "wiener_cluster_mixed", "wiener_split",
                "wiener_bluestein")


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
# wiener_plan takes at the even sizes past 8192 that are neither powers of
# two nor in WIENER_MIXED_WON and wiener_bluestein_cluster_pallas forces at
# those


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
        assert fp.wiener_plan(nt, S, nf, nfft, hop) == plan or nfft & (nfft - 1) == 0 or (
            nfft in fp.WIENER_MIXED_WON)
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


# (nfft, hop, nt, S, length, C, threads a block, rounds (None:
# fft_plan.wiener_plan's), y dtype, keyword arguments of wiener_istft, out):
# n = nfft / C
WIENER_CLUSTER_MIXED_CASES = [
    (120, 30, 1, 4, 600, 2, 32, 5, "float32", {}, "float32"),  # n 60 = 4·5·3; 2 rows a cluster
    (540, 135, 2, 3, 2000, 4, 32, 6, "bfloat16", {"p": 2.0}, "float32"),  # n 135, odd; S odd
    (270, 135, 1, 2, 700, 2, 16, 4, "float32", {"conserve_last": True, "ny": True},
     "int16"),                                                  # n 135 on C 2: shares 34 and 33
    (120, 2, 1, 2, 200, 4, 4, 70, "float32", {"p": 2.0}, "float32"),  # hop 2: a column a block
    (2000, 125, 1, 5, 3000, 4, 32, 20, "bfloat16",              # n 500, k 16, the ny row
     {"p": 2.0, "conserve_last": True, "ny": True}, "float32"),
    (2250, 450, 1, 4, 4000, 2, 128, 9, "float32", {"ny": True}, "int16"),  # n 1125 = 9·125, odd
    (10_000, 2500, 1, 3, 6000, 2, 512, None, "bfloat16",        # the card's W 10 000: C 2 of n
     {"p": 2.0, "conserve_last": True, "ny": True}, "float32"),  # 5000, 512 threads
    (280, 70, 1, 3, 1400, 2, 16, 6, "float32", {"p": 2.0}, "float32"),  # n 140 = 4·5·7
    (490, 98, 1, 2, 1500, 2, 16, 6, "bfloat16", {"ny": True}, "int16"),  # n 245 = 5·7·7, odd
    (14_000, 3500, 1, 3, 8000, 2, 512, None, "bfloat16",        # the card's W 14 000: C 2 of n
     {"p": 2.0, "conserve_last": True, "ny": True}, "float32"),  # 7000 = 8·5·5·5·7
    (90, 30, 1, 4, 600, 3, 16, 5, "float32", {}, "float32"),    # C 3 of n 30 = 2·3·5
    (150, 30, 2, 3, 900, 5, 16, 7, "bfloat16", {"p": 2.0}, "float32"),  # C 5 of 30; S odd
    (180, 45, 1, 2, 800, 6, 16, 6, "float32", {"conserve_last": True, "ny": True},
     "int16"),                                                  # C 6 of n 30, the ny row
    (210, 42, 1, 3, 900, 3, 32, 7, "bfloat16", {"ny": True}, "float32"),  # C 3 of n 70 = 2·5·7
    (22_050, 4410, 1, 4, 12_000, 3, 512, None, "bfloat16",      # 500 ms at 44.1 kHz: C 3 of n
     {"p": 2.0, "conserve_last": True, "ny": True}, "float32"),  # 7350, shares of 3675
]


@pytest.mark.parametrize("nfft,hop,nt,S,length,c,threads,rounds,ydt,kw,out",
                         WIENER_CLUSTER_MIXED_CASES)
def test_wiener_cluster_mixed_source_matches_plain(tmp_path, host, rng, nfft, hop, nt, S, length,
                                                   c, threads, rounds, ydt, kw, out):
    """wiener_cluster_mixed_block as wiener_cluster_mixed_kernel launches it
    (a cluster of C blocks a pair of sources and a row range, one frame a
    round, block r the points r mod C on the mixed-radix core in the passes
    of fft_plan.mixed_schedule, the N-point table fft_plan.dft_table):
    every sample of every stem written, equal to wiener_istft_plain within
    1e-5 × max|out|, PCM16 within ±1 LSB."""
    kw = dict(kw)
    has_ny = kw.pop("ny", False)
    w, nf, y, re, im, ny = _wiener_inputs(tmp_path, rng, nfft, hop, nt, S, length, ydt, has_ny)
    n = nfft // c
    if rounds is None:
        plan = fp.wiener_cluster_mixed_plan(nt, S, nf, nfft, hop)
        assert fp.wiener_mixed_factors(nfft) == (c, n)
        assert (plan.cluster, plan.threads, plan.route) == (c, 512, "cluster_mixed")
        if nfft in fp.WIENER_MIXED_WON:
            assert fp.wiener_plan(nt, S, nf, nfft, hop) == plan
        rounds = plan.rounds
    np.ascontiguousarray(fp.dft_table(nfft, "cpu").numpy(), np.float32).tofile(tmp_path / "tw.bin")
    args = [c, n, threads, nt, S, nf, hop, length, rounds, *_wiener_tail(kw, ydt, has_ny, out),
            fp.mixed_schedule(fp.mixed_radices(n))]
    subprocess.run([str(host["wiener_cluster_mixed"]), str(tmp_path), *map(str, args)],
                   check=True, timeout=300)
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
