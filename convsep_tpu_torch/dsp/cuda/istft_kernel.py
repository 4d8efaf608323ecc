"""Windowed inverse STFT + overlap-add: the CUDA kernel's launcher, the
``istft_pallas`` wrapper and its plain version.

The kernels of ``csrc/istft.cu`` (on the FFT core ``csrc/fft_common.cuh``
run backwards, launched by :func:`~convsep_tpu_torch.dsp.cuda.fft_plan.
istft_plan`) replace two TPU kernels that compute the same
window-power-normalized iSTFT:
``convsep_tpu/dsp/pallas/istft_kernel.py::istft_pallas`` (this module) and
``convsep_tpu/dsp/pallas/ct_istft_kernel.py::istft_ct_pallas``
(:mod:`convsep_tpu_torch.dsp.cuda.ct_istft_kernel`). Each wrapper keeps its
reference's contract and calls :func:`launch_istft`, which takes the FFT
kernel for powers of two 16–8192 (counted as ``LAUNCHES["istft"]``), the
split run backwards for m · 2^a (m 3, 5, 9, 15; counted as
``LAUNCHES["istft_split"]``), Bluestein run backwards for the other sizes up
to 8192, odd ones too (``LAUNCHES["istft_bluestein"]``), Bluestein over a
thread-block cluster run backwards past 8192, up to 65 536
(``LAUNCHES["istft_cluster"]``), at the powers of two there (16 384, 32 768,
65 536) the direct transform by decimation in time over a cluster of 2, 4
or 8 blocks (``LAUNCHES["istft_cluster_dit"]``), at the 7-smooth sizes there
that won their A/B (``fft_plan.ISTFT_MIXED_WON``: 10 000, 14 000, 20 000,
40 000, the odd 11 025, 44 100, ...) the same transform on a mixed-radix
block core over 2 to 8 blocks (``LAUNCHES["istft_cluster_mixed"]``;
``launch_istft(cluster_mixed=True)``
forces it at any of its sizes; :func:`istft_bluestein_cluster_pallas`
forces Bluestein's cluster at both, to hold and time it), and Bluestein on
the core's second level
run backwards past that, up to 262 144 (``LAUNCHES["istft_level2"]``, one
count a call: its phases are several launches), at the 7-smooth sizes there
that won their A/B (``fft_plan.ISTFT_LEVEL2_DIRECT_WON``: 70 000, 131 072,
200 000, ...) the direct transform on the second level, a radix-16 or 32
combine and rows on the mixed-radix block core
(``LAUNCHES["istft_level2_direct"]``, one count a call;
``launch_istft(level2_direct=True)`` forces it at any of its sizes;
:func:`istft_level2_bluestein_pallas` forces Bluestein's level there, to
hold and time it). An odd nfft has no Nyquist
bin: every bin but DC counts twice, as in the reference's inverse matrices.
The direct sum per sample (``LAUNCHES["istft_direct"]``) serves no size of
the wrapper: :func:`istft_direct_pallas` forces it up to 12 800 points (its
table fits shared memory up to there), to hold and time it. The kernels'
header says what bounds them on the H100.

The wrappers take their plain version only for CPU tensors. For CUDA
tensors they launch the kernel or raise: there is no fallback.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from convsep_tpu_torch import kernels
from convsep_tpu_torch.dsp.cuda.fft_plan import (
    bluestein_size,
    bluestein_tables,
    dft_table,
    istft_cluster_mixed_plan,
    istft_cluster_plan,
    istft_direct_plan,
    istft_plan,
    level2_chat,
    level2_direct_plan,
    level2_direct_tables,
    level2_plan,
    mixed_factors,
    mixed_radices,
    mixed_schedule,
    split_factors,
    synthesis_tables,
    twiddles,
)
from convsep_tpu_torch.dsp.dft import istft_matmul
from convsep_tpu_torch.dsp.stft import num_frames


def istft_supported(nfft: int, win_len: int, hop: int) -> bool:
    """The kernels' envelope: nfft >= win, ``win % hop == 0``, and a launch
    plan (:func:`~convsep_tpu_torch.dsp.cuda.fft_plan.istft_plan`) within
    shared memory, at any parity: powers of two from 16 to 8192 run on the
    FFT core, m · 2^a (m 3, 5, 9, 15, 2^a >= 16, up to 8192) on its split,
    the other sizes up to 8192 on Bluestein run backwards, up to 65 536 on
    a thread-block cluster (Bluestein's, or the direct transform at the
    powers of two and the won 7-smooth sizes), up to 262 144 on the core's
    second level (Bluestein's, or the direct transform at the won 7-smooth
    sizes); past that none (the direct sum per sample fits shared
    memory only up to 12 800 points)."""
    if not (2 <= win_len <= nfft and hop > 0 and win_len % hop == 0):
        return False
    try:
        istft_plan(1, 1, nfft, win_len, hop)
    except ValueError:
        return False
    return True


def launch_istft(
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    nfft: int,
    output_dtype: str = "float32",
    direct: bool = False,
    bluestein_cluster: bool = False,
    cluster_mixed: bool = False,
    level2_direct: bool = False,
    level2_bluestein: bool = False,
) -> torch.Tensor:
    """The kernel on CUDA tensors re/im (..., nf, nfft//2 + 1) float32 →
    (..., length) float32 or int16. Raises outside the envelope. The window's
    tables, the twiddles and the plan are found again per call, not made.
    ``direct``: the direct sum (:func:`istft_direct_pallas`);
    ``bluestein_cluster``: Bluestein's cluster past 8192, the powers of two
    and the 7-smooth sizes too (:func:`istft_bluestein_cluster_pallas`);
    ``cluster_mixed``: the mixed cluster at any size of
    :func:`~convsep_tpu_torch.dsp.cuda.fft_plan.mixed_factors`, won or not
    (its A/B); ``level2_direct``: the direct second level at any size of
    :func:`~convsep_tpu_torch.dsp.cuda.fft_plan.level2_direct_factors`, won
    or not (its A/B); ``level2_bluestein``: Bluestein's second level past
    65 536, the direct level's sizes too (:func:`istft_level2_bluestein_pallas`)."""
    win_len, hop, length = len(window), int(hop), int(length)
    if re.device.type != "cuda" or im.device != re.device:
        raise ValueError(f"istft kernel: re/im must share one CUDA device, got {re.device}, {im.device}")
    if re.dtype != torch.float32 or im.dtype != torch.float32 or im.shape != re.shape:
        raise ValueError("istft kernel: re/im must be float32 tensors of one shape")
    if int(re.shape[-1]) != nfft // 2 + 1:
        raise ValueError(f"istft kernel: {re.shape[-1]} bins do not match nfft={nfft}")
    if not istft_supported(nfft, win_len, hop):
        raise ValueError(f"istft kernel unsupported for nfft={nfft} win={win_len} hop={hop}")
    if output_dtype not in ("float32", "int16"):
        raise ValueError(f"output_dtype must be float32|int16, got {output_dtype}")
    lead = tuple(re.shape[:-2])
    nf, bins = int(re.shape[-2]), int(re.shape[-1])
    nt = math.prod(lead)
    dev = re.device
    where = str(dev)
    re3 = re.reshape(nt, nf, bins).contiguous()
    im3 = im.reshape(nt, nf, bins).contiguous()
    win_n, inv_norm = synthesis_tables(window, nfft, hop, nf, where)
    plan = (istft_direct_plan if direct else istft_cluster_plan if bluestein_cluster
            else istft_cluster_mixed_plan if cluster_mixed
            else level2_direct_plan if level2_direct
            else level2_plan if level2_bluestein
            else istft_plan)(nt, nf, nfft, win_len, hop)
    name = "istft" if plan.route == "fft" else "istft_" + plan.route
    int16 = output_dtype == "int16"
    out = torch.empty((nt, length), dtype=torch.int16 if int16 else torch.float32, device=dev)
    lib = kernels.library()
    with kernels.on_device(dev):
        stream = torch.cuda.current_stream(dev.index).cuda_stream
        if name == "istft_split":
            code = lib.istft_split_launch(
                re3.data_ptr(), im3.data_ptr(), win_n.data_ptr(), inv_norm.data_ptr(),
                twiddles(split_factors(nfft)[1], where).data_ptr(),
                twiddles(nfft, where).data_ptr(), out.data_ptr(), int(int16), nt, nf, nfft,
                win_len, hop, length, plan.groups, plan.rounds, stream,
            )
        elif name == "istft_bluestein":
            chirp, chat = bluestein_tables(nfft, where)
            code = lib.istft_bluestein_launch(
                re3.data_ptr(), im3.data_ptr(), win_n.data_ptr(), inv_norm.data_ptr(),
                twiddles(bluestein_size(nfft), where).data_ptr(), chirp.data_ptr(),
                chat.data_ptr(), out.data_ptr(), int(int16), nt, nf, nfft, win_len, hop, length,
                plan.groups, plan.rounds, stream,
            )
        elif name == "istft_cluster":
            chirp, chat = bluestein_tables(nfft, where)
            code = lib.istft_cluster_launch(
                re3.data_ptr(), im3.data_ptr(), win_n.data_ptr(), inv_norm.data_ptr(),
                twiddles(bluestein_size(nfft), where).data_ptr(), chirp.data_ptr(),
                chat.data_ptr(), out.data_ptr(), int(int16), nt, nf, nfft, win_len, hop, length,
                plan.rounds, stream,
            )
        elif name == "istft_cluster_dit":
            code = lib.istft_cluster_dit_launch(
                re3.data_ptr(), im3.data_ptr(), win_n.data_ptr(), inv_norm.data_ptr(),
                twiddles(nfft, where).data_ptr(), out.data_ptr(), int(int16), nt, nf, nfft,
                win_len, hop, length, plan.rounds, stream,
            )
        elif name == "istft_cluster_mixed":
            n = mixed_factors(nfft)[1]
            code = lib.istft_cluster_mixed_launch(
                re3.data_ptr(), im3.data_ptr(), win_n.data_ptr(), inv_norm.data_ptr(),
                dft_table(nfft, where).data_ptr(), out.data_ptr(), int(int16), nt, nf, nfft,
                win_len, hop, length, plan.rounds, mixed_schedule(mixed_radices(n)), stream,
            )
        elif name == "istft_level2":
            chirp, _ = bluestein_tables(nfft, where)
            scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32, device=dev)
            frames = torch.empty(nt * nf * win_len, dtype=torch.float32, device=dev)
            code = lib.istft_level2_launch(
                re3.data_ptr(), im3.data_ptr(), win_n.data_ptr(), inv_norm.data_ptr(),
                twiddles(plan.m, where).data_ptr(), chirp.data_ptr(),
                level2_chat(nfft, where).data_ptr(), scratch.data_ptr(), frames.data_ptr(),
                out.data_ptr(), int(int16), nt, nf, nfft, win_len, hop, length,
                plan.pairs_per_round, stream,
            )
        elif name == "istft_level2_direct":
            scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32, device=dev)
            frames = torch.empty(nt * nf * nfft, dtype=torch.float32, device=dev)
            code = lib.istft_level2_direct_launch(
                re3.data_ptr(), im3.data_ptr(), win_n.data_ptr(), inv_norm.data_ptr(),
                level2_direct_tables(nfft, where).data_ptr(), scratch.data_ptr(),
                frames.data_ptr(), out.data_ptr(), int(int16), nt, nf, nfft, win_len, hop, length,
                plan.pairs_per_round, mixed_schedule(mixed_radices(nfft // plan.radix)), stream,
            )
        else:
            tw = twiddles(nfft, where) if plan.groups else dft_table(nfft, where)
            code = lib.istft_launch(
                re3.data_ptr(), im3.data_ptr(), win_n.data_ptr(), inv_norm.data_ptr(),
                tw.data_ptr(), out.data_ptr(), int(int16), nt, nf, nfft, win_len, hop, length,
                plan.groups, plan.rounds if plan.groups else plan.rows, stream,
            )
    kernels.check(code, name)
    kernels.LAUNCHES[name] += 1
    return out.reshape(*lead, length)


def check_frames(re: torch.Tensor, length: int, hop: int) -> None:
    expect = num_frames(length, hop)
    if int(re.shape[-2]) != expect:
        raise ValueError(
            f"re/im have {re.shape[-2]} frames but length={length}, hop={hop} implies {expect}"
        )


def istft_pallas_plain(
    re: torch.Tensor, im: torch.Tensor, window: np.ndarray, hop: int, length: int,
    nfft: int | None = None,
) -> torch.Tensor:
    """The same function in plain PyTorch: :func:`istft_matmul`'s direct
    route (the window-folded inverse DFT matrices, then overlap-add)."""
    return istft_matmul(re, im, window, hop, length, nfft=nfft, algorithm="direct")


def istft_pallas(
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    nfft: int | None = None,
) -> torch.Tensor:
    """(nf, bins) or (N, nf, bins) ×2 → (length,) or (N, length) float32,
    equal to :func:`istft_matmul`. The reference's contract: ``win % hop ==
    0`` and ``win / hop <= 9``.

    CPU tensors: :func:`istft_pallas_plain`. CUDA tensors: the kernel."""
    return _istft(re, im, window, hop, length, nfft, direct=False)


def istft_direct_pallas(
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    nfft: int | None = None,
) -> torch.Tensor:
    """:func:`istft_pallas` through the direct sum at any nfft that is not
    a power of two, up to 12 800 (CUDA tensors), so that it can be held to
    the plain version and timed beside the split, Bluestein and cluster
    kernels at their sizes (PCM16: ``launch_istft(..., direct=True)``). CPU
    tensors: the plain version."""
    return _istft(re, im, window, hop, length, nfft, direct=True)


def istft_bluestein_cluster_pallas(
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    nfft: int | None = None,
) -> torch.Tensor:
    """:func:`istft_pallas` through Bluestein's cluster at any nfft past 8192
    up to 65 536 (CUDA tensors, counted as ``istft_cluster``), the powers of
    two and the won 7-smooth sizes too, where the direct transform
    (``istft_cluster_dit``, ``istft_cluster_mixed``) replaced it, so that
    it can be held and timed beside those kernels (PCM16:
    ``launch_istft(..., bluestein_cluster=True)``). CPU tensors: the plain
    version."""
    return _istft(re, im, window, hop, length, nfft, bluestein_cluster=True)


def istft_level2_bluestein_pallas(
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    nfft: int | None = None,
) -> torch.Tensor:
    """:func:`istft_pallas` through Bluestein's second level at any nfft
    past 65 536 up to 262 144 (CUDA tensors, counted as ``istft_level2``),
    the direct level's won sizes too, where ``istft_level2_direct``
    replaced it, so that it can be held and timed beside that kernel
    (PCM16: ``launch_istft(..., level2_bluestein=True)``). CPU tensors: the
    plain version."""
    return _istft(re, im, window, hop, length, nfft, level2_bluestein=True)


def _istft(re, im, window, hop, length, nfft, direct: bool = False,
           bluestein_cluster: bool = False, level2_bluestein: bool = False):
    window = np.asarray(window, np.float64)
    win_len = len(window)
    hop = int(hop)
    if re.dim() not in (2, 3):
        raise ValueError(
            f"istft_pallas expects (frames, bins) or (N, frames, bins), got {tuple(re.shape)}"
        )
    if win_len % hop != 0:
        raise ValueError(f"pallas istft requires win % hop == 0, got {win_len}/{hop}")
    if win_len // hop > 9:
        raise ValueError("pallas istft supports win/hop ratios up to 9")
    nfft = int(nfft or 2 * (int(re.shape[-1]) - 1))
    check_frames(re, length, hop)
    if {re.device.type, im.device.type} == {"cpu"}:
        return istft_pallas_plain(re, im, window, hop, length, nfft)
    return launch_istft(re, im, window, hop, length, nfft, direct=direct,
                        bluestein_cluster=bluestein_cluster, level2_bluestein=level2_bluestein)
