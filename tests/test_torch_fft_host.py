"""Device bodies of ``csrc/fft_common.cuh`` and ``csrc/wiener_common.cuh``
run on the CPU: compiled with g++ against a stand-in ``cuda_runtime.h``
(``tests/cuda_host/``: each CUDA thread a fiber on one OS thread, a barrier
a block for ``__syncthreads``, the fibers in ascending and descending
thread order by turns between barriers) and launched as the kernels launch
them, with the plans of ``fft_plan``. The host tests are split by route, so
that a test run spreads them over its workers, each file building only the
``tests/cuda_host/`` programs it runs:

* this file: ``stft_split_block`` (``stft_dft.cu::stft_split_kernel``),
  against ``stft_pallas_plain`` within 1e-5 × max|X| (float32 sums in
  another order), and ``istft_split_block`` (``istft.cu::
  istft_split_kernel``: the split run backwards, the staged rows, the
  rounds, carry and gather), against ``istft_pallas_plain`` within 1e-5 ×
  max|out|, and as PCM16 against the plain synthesis quantized within ±1
  LSB; and the helpers the other files share (:func:`programs`, the Wiener
  programs' inputs and check, the float64 synthesis);
* ``test_torch_fft_host_bluestein.py``: Bluestein, forward and inverse, on
  the core and on the 16 384-point level;
* ``test_torch_fft_host_cluster.py``: Bluestein over a thread-block cluster,
  forward and inverse, and the iSTFT's direct cluster at the powers of two;
* ``test_torch_fft_host_mixed.py``: the 7-smooth block core and the iSTFT's
  mixed cluster;
* ``test_torch_fft_host_wiener.py``: the Wiener+iSTFT's masked loads on the
  split, on Bluestein and on the three cluster routes;
* ``test_torch_fft_host_level.py``: the fused STFT's 16 384 points on the
  level and the second level, both directions.

The kernels' own index maps, twiddle and chirp reads, butterflies, block
and cluster barriers and output guards. Each file builds its programs once
per module under pytest's temporary directory, all at once."""

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


def programs(*names):
    """A module-scoped fixture: the ``tests/cuda_host/<name>.cpp`` programs
    built with g++ at once into pytest's temporary directory, as {name:
    path}; it skips without g++."""

    @pytest.fixture(scope="module")
    def host(tmp_path_factory):
        gxx = shutil.which("g++")
        if gxx is None:
            pytest.skip("needs g++ (C++20) to build the host emulation")
        out = tmp_path_factory.mktemp("cuda_host")
        procs = {name: subprocess.Popen(
            [gxx, "-std=c++20", "-O1", f"-I{HERE / 'cuda_host'}", f"-I{CSRC}",
             str(HERE / "cuda_host" / f"{name}.cpp"), "-o", str(out / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in names}
        for name, p in procs.items():
            log = p.communicate(timeout=300)[0]
            assert p.returncode == 0, f"g++ {name}.cpp failed:\n{log}"
        return {name: out / name for name in names}

    return host


host = programs("split_stft", "split_istft")


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
