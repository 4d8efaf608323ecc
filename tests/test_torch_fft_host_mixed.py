"""The 7-smooth block core on the CPU (the stand-in runtime and
:func:`tests.test_torch_fft_host.programs`): ``mixed_fft`` (the
mixed-radix block core's Stockham passes of radix 2, 3, 4, 5, 7, 8, 9 and
16 in a host-planned schedule) at every 7-smooth n it serves, against
numpy's float64 FFT within 1e-6 × max|X|, and ``istft_cluster_mixed_block``
(``istft.cu::istft_cluster_mixed_kernel``: the direct inverse over the
cluster on that core, ``ClusterMixed``) at small parts (C 2 to 8, odd n,
odd N, a factor 7), against the plain iSTFT, and at the card's W 10 000,
20 000 and 40 000 (C 2, 4, 8 of n 5000), W 14 000 (C 2 of n 7000 = 8·5³·7),
W 11 250 and W 8750 (the odd n 5625 and 4375), W 11 025 (odd, C 3 of 3675)
and W 22 050 (C 3 of 7350), against the plain iSTFT or, past its
matrices' memory, the float64 synthesis, within 1e-5 × max|out|, PCM16
within ±1 LSB; at clusters of 2, 4 and 8, bit for bit what the power-of-two
form of ``ClusterMixed::put`` (a mask and a shift) gives."""

import subprocess

import numpy as np
import pytest
import torch

from convsep_tpu_torch.dsp.cuda import fft_plan as fp
from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas_plain
from convsep_tpu_torch.dsp.stft import num_frames
from convsep_tpu_torch.dsp.windows import sinebell
from tests.test_torch_fft_host import _istft64, programs

host = programs("istft_cluster_mixed")


# every block size n of the mixed cluster's 281 sizes (fft_plan.mixed_factors):
# 78, the 68 of clusters of 2, 4 and 8 and ten under 4096 of the others
MIXED_BLOCK_SIZES = sorted({fp.mixed_factors(n)[1] for n in range(fp.MAX_NFFT + 1,
                                                                  fp.CLUSTER_NFFT + 1)
                            if fp.mixed_factors(n)})


def test_mixed_sizes_source_matches_plan(host):
    """fft_common.cuh::mixed_sizes, the launchers' check, takes exactly the
    sizes past 8192 that fft_plan.mixed_factors takes, with the same C and
    n: 281 up to 65 536, 40 of them odd, 77 on clusters of 3, 5, 6 or 7."""
    out = subprocess.run([str(host["istft_cluster_mixed"]), "sizes"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    got = {int(a): (int(b), int(c)) for a, b, c in (line.split() for line in out.splitlines())}
    want = {n: fp.mixed_factors(n) for n in range(fp.MAX_NFFT + 1, fp.CLUSTER_NFFT + 1)
            if fp.mixed_factors(n)}
    assert got == want and len(got) == 281 and len(MIXED_BLOCK_SIZES) == 78
    assert sum(n % 2 for n in got) == 40
    assert sum(c not in (2, 4, 8) for c, _ in got.values()) == 77


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


# (nfft, win, hop, nt, length, C, threads a block, rounds (None:
# fft_plan.istft_cluster_mixed_plan's), out): n = nfft / C
ISTFT_CLUSTER_MIXED_CASES = [
    (120, 120, 30, 2, 600, 2, 32, 3, "float32"),    # n 60 = 4·5·3; nf 22, odd pairs
    (540, 540, 135, 1, 2000, 4, 32, 3, "int16"),    # n 135 = 5·9·3, odd: no quarter table
    (2000, 1000, 250, 1, 4000, 8, 32, 4, "float32"),  # n 250 = 2·5·5·5; nfft past the window
    (60, 60, 2, 1, 80, 2, 4, 16, "float32"),        # hop 2: a column a block, k 30
    (280, 280, 70, 2, 1500, 4, 32, 4, "float32"),   # n 70 = 2·5·7: a radix-7 pass, C 4
    (490, 490, 98, 1, 1500, 2, 16, 5, "int16"),     # n 245 = 5·7·7, odd: two radix-7 passes
    (10_000, 10_000, 2500, 1, 6000, 2, 512, None, "float32"),  # the card's: C 2 of n 5000
    (10_000, 10_000, 2500, 1, 6000, 2, 512, None, "int16"),
    (20_000, 20_000, 5000, 1, 10_000, 4, 512, None, "float32"),  # C 4
    (20_000, 20_000, 5000, 1, 10_000, 4, 512, None, "int16"),
    (40_000, 40_000, 10_000, 1, 20_000, 8, 512, None, "float32"),  # C 8
    (40_000, 40_000, 10_000, 1, 20_000, 8, 512, None, "int16"),
    (11_250, 11_250, 2250, 1, 6000, 2, 512, None, "float32"),  # n 5625 = 5^4·9, odd
    (14_000, 14_000, 3500, 1, 8000, 2, 512, None, "float32"),  # C 2 of n 7000 = 8·5·5·5·7
    (14_000, 14_000, 3500, 1, 8000, 2, 512, None, "int16"),
    (8750, 8750, 1750, 1, 5000, 2, 512, None, "float32"),    # n 4375 = 5^4·7, odd
    (135, 135, 27, 2, 700, 3, 16, 4, "float32"),    # C 3 of n 45 = 5·9: N odd, no Nyquist
    (135, 135, 27, 1, 700, 5, 16, 3, "int16"),      # C 5 of n 27 = 9·3: N odd
    (300, 300, 75, 2, 1500, 6, 16, 3, "float32"),   # C 6 of n 50 = 2·5·5
    (245, 245, 49, 1, 1200, 7, 16, 4, "float32"),   # C 7 of n 35 = 5·7: N odd, radix 7
    (336, 168, 42, 1, 1500, 7, 16, 3, "int16"),     # C 7 of n 48 = 16·3: nfft past the window
    (105, 105, 3, 1, 150, 3, 4, 20, "float32"),     # N odd, hop 3: a column a block, k 35
    (11_025, 11_025, 2205, 1, 8000, 3, 512, None, "float32"),  # 250 ms at 44.1 kHz: odd, C 3
    (11_025, 11_025, 2205, 1, 8000, 3, 512, None, "int16"),
    (22_050, 22_050, 4410, 1, 12_000, 3, 512, None, "float32"),  # 500 ms: C 3 of n 7350
    (22_050, 22_050, 4410, 1, 12_000, 3, 512, None, "int16"),
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


# (nfft, win, hop, length, C, threads a block, rounds): clusters of 2, 4 and
# 8, whose owner and slot t mod C, t / C are a mask and a shift
POW2_PUT_CASES = [
    (120, 120, 30, 600, 2, 32, 3),
    (540, 540, 135, 2000, 4, 32, 3),
    (2000, 1000, 250, 4000, 8, 32, 4),
    (10_000, 10_000, 2500, 6000, 2, 512, 6),
]


@pytest.mark.parametrize("nfft,win,hop,length,c,threads,rounds", POW2_PUT_CASES)
def test_istft_cluster_mixed_put_keeps_pow2_bits(tmp_path, host, rng, nfft, win, hop, length, c,
                                                 threads, rounds):
    """ClusterMixed::put finds a point's owner and slot as t mod C and t / C
    for any C from 2 to 8; at clusters of 2, 4 and 8 istft_cluster_mixed_block
    writes every sample bit for bit as with the put's power-of-two form (t &
    (C - 1), t >> log2 C) swapped in, float32 and int16."""
    nf = num_frames(length, hop)
    bins = nfft // 2 + 1
    n = nfft // c
    re = rng.standard_normal((1, nf, bins)).astype(np.float32)
    im = rng.standard_normal((1, nf, bins)).astype(np.float32)
    wn, inv = fp.synthesis_tables(sinebell(win), nfft, hop, nf, "cpu")
    for name, arr in (("re", re), ("im", im), ("wn", wn.numpy()), ("inv", inv.numpy()),
                      ("tw", fp.dft_table(nfft, "cpu").numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    for int16 in (0, 1):
        outs = []
        for verb in ("istft", "istft_mask"):
            args = [c, n, threads, 1, nf, win, hop, length, rounds, int16,
                    fp.mixed_schedule(fp.mixed_radices(n))]
            subprocess.run([str(host["istft_cluster_mixed"]), verb, str(tmp_path),
                            *map(str, args)], check=True, timeout=300)
            outs.append((tmp_path / "out.bin").read_bytes())
        assert outs[0] == outs[1] and len(outs[0]) == length * (2 if int16 else 4)
