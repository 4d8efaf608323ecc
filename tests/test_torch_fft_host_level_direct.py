"""The direct second level's device bodies on the CPU (the stand-in runtime
and :func:`tests.test_torch_fft_host.programs`): ``level2_direct_combine``,
``level2_direct_rows`` and ``level2_direct_overlap_add`` as
``istft.cu::launch_level2_direct`` runs them, at R 16 (an odd n, and n
8192) and R 32, against the float64 synthesis within 1e-5 × max|out| (PCM16
within ±1 LSB) and, float32, against the JAX package's factored
``istft_matmul`` on the same numpy spectra within 1e-5 × max|out|; and the
launcher's size check (``level2_direct_sizes``) against
``fft_plan.level2_direct_factors``."""

import subprocess

import numpy as np
import pytest
import torch

from convsep_tpu_torch.dsp.cuda import fft_plan as fp
from convsep_tpu_torch.dsp.stft import num_frames
from convsep_tpu_torch.dsp.windows import sinebell
from tests.test_torch_fft_host import _istft64, programs

host = programs("level2_direct")


@pytest.mark.parametrize("nfft,win,hop,nt,length,out,factors", [
    (70_000, 70_000, 17_500, 1, 35_000, "float32", (16, 4375)),   # odd n: 7 · 5^4; 2 pairs
    (131_072, 131_072, 32_768, 2, 32_768, "int16", (16, 8192)),  # 2 · 3 frames: a pair straddles
    (200_000, 200_000, 50_000, 1, 50_000, "float32", (32, 6250)),  # R 32: the 32-point combine
    (100_000, 80_000, 20_000, 1, 40_000, "float32", (16, 6250)),  # a window under nfft
])
def test_level2_direct_istft_source_matches_float64_and_jax(tmp_path, host, rng, nfft, win, hop,
                                                            nt, length, out, factors):
    from convsep_tpu.dsp import dft as jdft

    assert fp.level2_direct_factors(nfft) == factors
    r, n = factors
    nf = num_frames(length, hop)
    bins = nfft // 2 + 1
    re = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    im = rng.standard_normal((nt, nf, bins)).astype(np.float32)
    w = sinebell(win)
    wn, inv = fp.synthesis_tables(w, nfft, hop, nf, "cpu")
    for name, arr in (("re", re), ("im", im), ("wn", wn.numpy()), ("inv", inv.numpy()),
                      ("tables", fp.level2_direct_tables(nfft, "cpu").numpy())):
        np.ascontiguousarray(arr, np.float32).tofile(tmp_path / f"{name}.bin")
    int16 = out == "int16"
    args = [r, nt, nf, nfft, win, hop, length, int(int16),
            fp.mixed_schedule(fp.mixed_radices(n))]
    subprocess.run([str(host["level2_direct"]), str(tmp_path), *map(str, args)], check=True,
                   timeout=300)
    got = np.fromfile(tmp_path / "out.bin", np.int16 if int16 else np.float32).reshape(nt, length)
    want = _istft64(re, im, w, nfft, hop, length, inv.numpy())
    if int16:
        q = np.clip(np.rint(want * 32768.0), -32768, 32767).astype(np.int32)
        assert (q != 0).any() and np.abs(got.astype(np.int32) - q).max() <= 1
        return
    assert np.isfinite(got).all()  # every sample written
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    ref = np.asarray(jdft.istft_matmul(re, im, w, hop, length, nfft=nfft, precision="highest",
                                       algorithm="factored"))
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def test_level2_direct_tables():
    """level2_direct_tables: the combine's (R, n) table w^{n2 k1} and the
    rows' n-point table w^{R m} are dft_table's entries n2 · k1 and R · m,
    bit for bit."""
    for nfft in (70_000, 200_000):
        r, n = fp.level2_direct_factors(nfft)
        tab = fp.dft_table(nfft, "cpu")
        got = fp.level2_direct_tables(nfft, "cpu")
        assert got.shape == (nfft + n, 2)
        k1, n2 = 3, 1234
        assert torch.equal(got[k1 * n + n2], tab[k1 * n2])
        assert torch.equal(got[nfft:], tab[::r])
        assert torch.equal(got[:n], tab[:1].expand(n, 2))  # k1 = 0: ones


def test_level2_direct_sizes_match_the_plan(host):
    """The launcher's check (fft_common.cuh::level2_direct_sizes) takes
    exactly fft_plan.level2_direct_factors' 138 sizes, with the same R and n."""
    out = subprocess.run([str(host["level2_direct"]), "sizes"], check=True, timeout=60,
                         capture_output=True, text=True).stdout
    got = {int(a): (int(b), int(c)) for a, b, c in (line.split() for line in out.splitlines())}
    want = {n: fp.level2_direct_factors(n) for n in range(fp.CLUSTER_NFFT + 1, fp.LEVEL2_NFFT + 1)
            if fp.level2_direct_factors(n)}
    assert got == want and len(got) == 138
