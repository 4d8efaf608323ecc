"""The mixed-radix split of the FFT core, its CUDA source run on the CPU:
``csrc/fft_common.cuh::stft_split_block`` compiled with g++ against a
stand-in ``cuda_runtime.h`` (``tests/cuda_host/``: one std::thread per
CUDA thread, a barrier a block for ``__syncthreads``) and launched as
``stft_dft.cu::stft_split_kernel`` launches it, with the plan of
``fft_plan.split_plan``. The kernel's own index maps, twiddle reads,
radix-3/5 butterflies, block barriers and output guards, held against
``stft_pallas_plain`` within 1e-5 × max|X| (float32 sums in another
order). Built once per test session under pytest's temporary directory."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from convsep_tpu_torch.dsp.cuda import fft_plan as fp
from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas_plain
from convsep_tpu_torch.dsp.stft import num_frames
from convsep_tpu_torch.dsp.windows import sinebell

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "convsep_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def split_stft(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the host emulation")
    exe = tmp_path_factory.mktemp("cuda_host") / "split_stft"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", f"-I{HERE / 'cuda_host'}",
                    f"-I{CSRC}", str(HERE / "cuda_host" / "split_stft.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    return exe


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
