"""The two iSTFT kernels of ``convsep_tpu/dsp/pallas/ct_istft_kernel.py``:
wrappers and plain versions.

* :func:`wiener_istft` replaces ``istft_ct_pallas_wiener``. Its kernel
  (``csrc/wiener_istft.cu``, on the FFT core ``csrc/fft_common.cuh`` run
  backwards, launched by :func:`~convsep_tpu_torch.dsp.cuda.fft_plan.
  wiener_plan`) masks the mixture spectrum with the per-source magnitudes
  as it loads each frame's points, inverse-FFTs the frame and overlap-adds
  it, so the masked spectra never reach device memory; its header says what
  bounds it on the H100 and how the design follows. Like the reference
  (``has_ny``) it also takes the mixture as the forward STFT kernel's
  Nyquist-separate pair. At the sizes up to 8192 that are not powers of
  two it runs on the core's mixed-radix split (m · 2^a, counted as
  ``wiener_istft_split``) or on Bluestein run backwards (the other even
  sizes, ``wiener_istft_bluestein``); past 8192, up to the reference's
  32 768, Bluestein backwards on a thread-block cluster
  (:func:`~convsep_tpu_torch.dsp.cuda.fft_plan.wiener_cluster_plan`,
  ``wiener_istft_cluster``), at the powers of two there (16 384, 32 768)
  the direct transform by decimation in time over a cluster of 2 or 4
  blocks (:func:`~convsep_tpu_torch.dsp.cuda.fft_plan.
  wiener_cluster_dit_plan`, ``wiener_istft_cluster_dit``), at the 7-smooth
  sizes in ``fft_plan.WIENER_MIXED_WON`` (10 000, 14 000, ...) the same with
  each block's points on a mixed-radix core
  (:func:`~convsep_tpu_torch.dsp.cuda.fft_plan.wiener_cluster_mixed_plan`,
  ``wiener_istft_cluster_mixed``); with ``ny`` each counts as
  ``wiener_istft_ny``, ``wiener_istft_ny_split``, and so on.
  :func:`wiener_direct_pallas` forces the direct sum per sample that served
  the sizes off the core before (``wiener_istft_direct``),
  :func:`wiener_bluestein_cluster_pallas` Bluestein's cluster at the powers
  of two and the 7-smooth sizes past 8192, and
  :func:`wiener_cluster_mixed_pallas` the mixed cluster at any of its sizes,
  to hold and time them.
* :func:`istft_ct_pallas` replaces ``istft_ct_pallas``: the same iSTFT
  without the mask, through the kernel of ``csrc/istft.cu``
  (:func:`convsep_tpu_torch.dsp.cuda.istft_kernel.launch_istft`), which
  also serves ``istft_pallas``.

Each wrapper takes its plain version only for CPU tensors. For CUDA tensors
it launches its kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from convsep_tpu_torch import kernels
from convsep_tpu_torch.dsp.cuda.fft_plan import (
    WIENER_CLUSTER_NFFT,
    bluestein_size,
    bluestein_tables,
    dft_table,
    fft_supported,
    mixed_radices,
    mixed_schedule,
    split_factors,
    synthesis_tables,
    twiddles,
    wiener_cluster_mixed_plan,
    wiener_cluster_plan,
    wiener_direct_plan,
    wiener_plan,
)
from convsep_tpu_torch.dsp.cuda.istft_kernel import check_frames, istft_supported, launch_istft
from convsep_tpu_torch.dsp.dft import _use_factored, istft_matmul
from convsep_tpu_torch.dsp.stft import num_frames

_LANES = 128  # the reference kernel's lane-width factor of nfft

# The cluster plans' (nfft, hop) at which the Wiener+iSTFT kernel beat the
# plain masked chain (the mask, then the iSTFT "auto" takes) in a timed A/B
# on an H100 80GB HBM3 at 700 W, 4 stems of a 30 s track, bf16 y
# (tools/torch_wiener_mixed_ab.py; chip_smoke.py phase 3c repeats it at 10
# 000, 14 000, 16 384, 20 000, 22 050 and 32 768; PERF.md row 1″): "auto" takes the kernel
# past 8192 only there, as FUSED_DECODE_WON keys the decode. The direct
# cluster at the reference's 16 384 and 32 768 against the mask and the
# iSTFT's direct cluster, by 1.5-1.7x; the mixed cluster at each of its 136
# sizes on C 2 or 4 at the sweep's hop against the mask and the factored
# products (the direct ones where those do not factor, as at 11 250 and
# 14 000), by 4.97-53.1x, and at its 13 on C 3, 5 or 6 (22 050, hop 4410
# among them; tools/torch_wiener_mixed_ab.py --new) by 5.14-39.8x.
# Bluestein's cluster lost at every size it was timed.
WIENER_CLUSTER_WON: frozenset[tuple[int, int]] = frozenset({
    (8232, 2058), (8400, 2100), (8640, 2160), (8748, 2187), (8750, 1750), (8820, 2205), (8960,
    2240), (9000, 2250), (9072, 2268), (9216, 2304), (9408, 2352), (9450, 1890), (9600, 2400),
    (9604, 2401), (9720, 2430), (9800, 2450), (10000, 2500), (10080, 2520), (10206, 3402), (10240,
    2560), (10290, 2058), (10368, 2592), (10500, 2625), (10584, 2646), (10752, 2688), (10800,
    2700), (10976, 2744), (11200, 2800), (11250, 2250), (11340, 2835), (11520, 2880), (11664,
    2916), (11760, 2940), (12000, 3000), (12096, 3024), (12150, 2430), (12250, 2450), (12288,
    3072), (12348, 3087), (12500, 3125), (12544, 3136), (12600, 3150), (12800, 3200), (12960,
    3240), (13122, 4374), (13230, 2646), (13440, 3360), (13500, 3375), (13608, 3402), (13720,
    3430), (13824, 3456), (14000, 3500), (14112, 3528), (14336, 3584), (14400, 3600), (14406,
    4802), (14580, 3645), (14700, 3675), (15000, 3750), (15120, 3780), (15360, 3840), (15552,
    3888), (15680, 3920), (15750, 3150), (15876, 3969), (16000, 4000), (16128, 4032), (16200,
    4050), (16384, 2048), (16464, 4116), (16800, 4200), (17010, 3402), (17280, 4320), (17496,
    4374), (17500, 4375), (17640, 4410), (17920, 4480), (18000, 4500), (18144, 4536), (18432,
    4608), (18522, 6174), (18750, 3750), (18816, 4704), (18900, 4725), (19200, 4800), (19208,
    4802), (19440, 4860), (19600, 4900), (20000, 5000), (20160, 5040), (20250, 4050), (20412,
    5103), (20480, 5120), (20580, 5145), (20736, 5184), (21000, 5250), (21168, 5292), (21504,
    5376), (21600, 5400), (21870, 4374), (21952, 5488), (22050, 4410), (22400, 5600), (22500,
    5625), (22680, 5670), (23040, 5760), (23328, 5832), (23520, 5880), (23814, 7938), (24000,
    6000), (24010, 4802), (24192, 6048), (24300, 6075), (24500, 6125), (24576, 6144), (24696,
    6174), (25000, 6250), (25088, 6272), (25200, 6300), (25600, 6400), (25920, 6480), (26244,
    6561), (26250, 5250), (26460, 6615), (26880, 6720), (27000, 6750), (27216, 6804), (27440,
    6860), (27648, 6912), (28000, 7000), (28224, 7056), (28350, 5670), (28672, 7168), (28800,
    7200), (28812, 7203), (29160, 7290), (29400, 7350), (30000, 7500), (30240, 7560), (30618,
    10206), (30720, 7680), (30870, 6174), (31104, 7776), (31250, 6250), (31360, 7840), (31500,
    7875), (31752, 7938), (32000, 8000), (32256, 8064), (32400, 8100), (32768, 4096)})
# The same for the split's and Bluestein's (nfft, hop) up to 8192 (chip_smoke.py
# phase 7b, 4 stems of a 30 s track, PERF.md row 1′): each won, by 3.8-8.7x on an
# H100 80GB HBM3 at 700 W.
WIENER_SPLIT_BLUESTEIN_WON: frozenset[tuple[int, int]] = frozenset(
    {(768, 256), (1280, 320), (1000, 250), (6000, 1500), (8190, 910)})


def ct_pallas_supported(nfft: int, win_len: int, hop: int) -> bool:
    """The reference kernel's shapes (``ct_istft_kernel.ct_pallas_supported``):
    nfft == win, a 128-lane factorization nfft = 128·B with B >= 2 and
    (nfft/2)/128 dividing 128, ``win % hop == 0``, ``hop % B == 0`` and
    ``win / hop <= 9``. Kept so "auto" routes the shapes the TPU routed."""
    if nfft != win_len or nfft % _LANES:
        return False
    half, B = nfft // 2, nfft // _LANES
    if half % _LANES or _LANES % (half // _LANES) or B < 2:
        return False
    return win_len % hop == 0 and hop % B == 0 and win_len // hop <= 9


def istft_ct_supported(nfft: int, win_len: int, hop: int) -> bool:
    """Where :func:`istft_ct_pallas` launches on CUDA: the reference's
    shapes inside the kernel's own envelope."""
    return ct_pallas_supported(nfft, win_len, hop) and istft_supported(nfft, win_len, hop)


def istft_ct_pallas_plain(
    re: torch.Tensor, im: torch.Tensor, window: np.ndarray, hop: int, length: int,
    nfft: int | None = None, output_dtype: str = "float32",
) -> torch.Tensor:
    """The same function in plain PyTorch: :func:`istft_matmul`'s factored
    route (PCM16 quantized after the synthesis)."""
    return istft_matmul(re, im, window, hop, length, nfft=nfft, algorithm="factored",
                        output_dtype=output_dtype)


def istft_ct_pallas(
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    nfft: int | None = None,
    output_dtype: str = "float32",
) -> torch.Tensor:
    """(..., nf, bins) ×2 → (..., length): :func:`istft_matmul`'s factored
    algorithm as one kernel; leading axes flatten onto the kernel's grid.
    ``output_dtype="int16"`` quantizes to PCM16 in the kernel's epilogue.

    CPU tensors: :func:`istft_ct_pallas_plain`. CUDA tensors: the kernel."""
    window = np.asarray(window, np.float64)
    win_len = len(window)
    nfft = int(nfft or 2 * (int(re.shape[-1]) - 1))
    if not ct_pallas_supported(nfft, win_len, int(hop)):
        raise ValueError(
            f"istft_ct_pallas unsupported for nfft={nfft} win={win_len} hop={hop}; "
            "use dft.istft_matmul"
        )
    check_frames(re, length, int(hop))
    if output_dtype not in ("float32", "int16"):
        raise ValueError(f"output_dtype must be float32|int16, got {output_dtype}")
    if {re.device.type, im.device.type} == {"cpu"}:
        return istft_ct_pallas_plain(re, im, window, int(hop), int(length), nfft, output_dtype)
    return launch_istft(re, im, window, int(hop), int(length), nfft, output_dtype)


def wiener_istft_supported(nfft: int, win_len: int, hop: int) -> bool:
    """The kernel's envelope: ``win == nfft``, nfft even in [16, 32 768],
    ``nfft % hop == 0``, and a launch plan within shared memory
    (:func:`~convsep_tpu_torch.dsp.cuda.fft_plan.wiener_plan`; a block
    holds two sources, so their number does not bound it). Powers of two up
    to 8192 (every preset) run on the FFT core, m · 2^a on its split, the
    other even sizes up to 8192 on Bluestein run backwards, even sizes past
    8192 Bluestein run backwards on a thread-block cluster, the powers of
    two and the 7-smooth sizes there the direct transform over a cluster. It
    holds every shape of the reference's :func:`ct_pallas_supported`."""
    if not (win_len == nfft and 16 <= nfft <= WIENER_CLUSTER_NFFT and nfft % 2 == 0 and hop > 0
            and nfft % hop == 0):
        return False
    try:
        wiener_plan(1, 1, 1, nfft, hop)
    except ValueError:
        return False
    return True


def wiener_auto_supported(nfft: int, win_len: int, hop: int) -> bool:
    """Where :func:`istft_wiener`'s "auto" takes the kernel: inside
    :func:`wiener_istft_supported`, on the FFT core (powers of two up to
    8192), or at a split, Bluestein or cluster plan that won its A/B against
    the masked chain (``WIENER_SPLIT_BLUESTEIN_WON``, ``WIENER_CLUSTER_WON``);
    elsewhere ``masked_synthesis="ct_pallas_wiener"`` still reaches the
    kernel. Never the direct sum, which only :func:`wiener_direct_pallas`
    runs."""
    return wiener_istft_supported(nfft, win_len, hop) and (
        fft_supported(nfft) or (nfft, hop) in WIENER_SPLIT_BLUESTEIN_WON
        or (nfft, hop) in WIENER_CLUSTER_WON)


def wiener_istft_plain(
    y: torch.Tensor,
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    p: float = 1.0,
    eps: float = 1e-8,
    conserve_last: bool = False,
    output_dtype: str = "float32",
    algorithm: str = "auto",
    ny: torch.Tensor | None = None,
) -> torch.Tensor:
    """The same function in plain PyTorch: f32 Wiener mask × mixture (the
    masked spectra are materialized), then :func:`istft_matmul`. "auto"
    names the plain chain's own choice (factored at nfft >= 2048, else
    direct); "ct_pallas" sends the masked spectra through
    :func:`istft_ct_pallas`. With ``ny`` the Nyquist column is concatenated
    back onto re (and a zero one onto im), as the reference's XLA route
    does."""
    from convsep_tpu_torch.models.masks import wiener_mask

    if ny is not None:
        re = torch.cat([re, ny.unsqueeze(-1)], dim=-1)
        im = torch.cat([im, torch.zeros_like(ny).unsqueeze(-1)], dim=-1)
    nfft = 2 * (int(re.shape[-1]) - 1)
    if algorithm == "auto":
        algorithm = "factored" if _use_factored("auto", nfft) else "direct"
    mask = wiener_mask(y, p=p, eps=eps, axis=-3, conserve_last=conserve_last)
    return istft_matmul(
        mask * re.unsqueeze(-3), mask * im.unsqueeze(-3), window, hop, length,
        nfft=nfft, algorithm=algorithm, output_dtype=output_dtype,
    )


def wiener_istft(
    y: torch.Tensor,
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    p: float = 1.0,
    eps: float = 1e-8,
    conserve_last: bool = False,
    output_dtype: str = "float32",
    ny: torch.Tensor | None = None,
) -> torch.Tensor:
    """y (..., S, nf, bins) nonnegative magnitudes (f32 or bf16) + re/im
    (..., nf, bins) mixture halves → stems (..., S, length), f32 or int16.

    ``ny``: (..., nf) real Nyquist row when re/im are the forward STFT
    kernel's (..., nf, nfft/2) bodies (:func:`~convsep_tpu_torch.dsp.cuda.
    ct_stft_kernel.stft_ct_pallas`); y still has nfft/2 + 1 bins. The
    kernel reads it in place of a concatenated spectrum and counts under
    ``wiener_istft_ny``; off the core the kernel counts under
    ``wiener_istft_split``, ``wiener_istft_bluestein``,
    ``wiener_istft_cluster``, ``wiener_istft_cluster_dit`` or
    ``wiener_istft_cluster_mixed`` (``wiener_istft_ny_split``, and so on).

    CPU tensors: :func:`wiener_istft_plain`. CUDA tensors: the kernel."""
    return _wiener(y, re, im, window, hop, length, p, eps, conserve_last, output_dtype, ny)


def wiener_direct_pallas(
    y: torch.Tensor,
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    p: float = 1.0,
    eps: float = 1e-8,
    conserve_last: bool = False,
    output_dtype: str = "float32",
    ny: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`wiener_istft` through the direct sum per sample at any even
    nfft up to 8192 that is not a power of two (CUDA tensors, counted as
    ``wiener_istft_direct``), so that it can be held to the plain version
    and timed beside the split and Bluestein kernels that replaced it. CPU
    tensors: the plain version."""
    return _wiener(y, re, im, window, hop, length, p, eps, conserve_last, output_dtype, ny,
                   wiener_direct_plan)


def wiener_bluestein_cluster_pallas(
    y: torch.Tensor,
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    p: float = 1.0,
    eps: float = 1e-8,
    conserve_last: bool = False,
    output_dtype: str = "float32",
    ny: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`wiener_istft` through Bluestein's cluster at any even nfft past
    8192 up to the reference's 32 768 (CUDA tensors, counted as
    ``wiener_istft_cluster``), the powers of two and the 7-smooth sizes
    too, where the direct transforms (``wiener_istft_cluster_dit``,
    ``wiener_istft_cluster_mixed``) replaced it, so that it can be held and
    timed beside them. CPU tensors: the plain version."""
    return _wiener(y, re, im, window, hop, length, p, eps, conserve_last, output_dtype, ny,
                   wiener_cluster_plan)


def wiener_cluster_mixed_pallas(
    y: torch.Tensor,
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    p: float = 1.0,
    eps: float = 1e-8,
    conserve_last: bool = False,
    output_dtype: str = "float32",
    ny: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`wiener_istft` through the mixed cluster at any of its sizes
    (:func:`~convsep_tpu_torch.dsp.cuda.fft_plan.wiener_cluster_mixed_plan`,
    CUDA tensors, counted as ``wiener_istft_cluster_mixed``), in
    ``fft_plan.WIENER_MIXED_WON`` or not, so that a size can be timed
    against Bluestein's cluster before "auto" takes it. CPU tensors: the
    plain version."""
    return _wiener(y, re, im, window, hop, length, p, eps, conserve_last, output_dtype, ny,
                   wiener_cluster_mixed_plan)


def _wiener(y, re, im, window, hop, length, p, eps, conserve_last, output_dtype, ny,
            plan_of=wiener_plan):
    window = np.asarray(window, np.float64)
    win_len = len(window)
    has_ny = ny is not None
    bins = int(re.shape[-1]) + int(has_ny)
    nfft = 2 * (bins - 1)
    lead = tuple(re.shape[:-2])
    if tuple(y.shape[:len(lead)]) != lead or y.dim() != len(lead) + 3 \
            or tuple(y.shape[-2:]) != (int(re.shape[-2]), bins) or im.shape != re.shape:
        raise ValueError(
            f"y {tuple(y.shape)} must be re/im's shape {tuple(re.shape)} with "
            "one sources axis inserted at -3"
            + (" and the Nyquist bin appended" if has_ny else "")
        )
    if has_ny and tuple(ny.shape) != tuple(re.shape[:-1]):
        raise ValueError(f"ny {tuple(ny.shape)} must be re's {tuple(re.shape)} without bins")
    if output_dtype not in ("float32", "int16"):
        raise ValueError(f"output_dtype must be float32|int16, got {output_dtype}")
    expect = num_frames(length, hop)
    if int(re.shape[-2]) != expect:
        raise ValueError(
            f"re/im have {re.shape[-2]} frames but length={length}, hop={hop} "
            f"implies {expect}"
        )
    tensors = (y, re, im, ny) if has_ny else (y, re, im)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return wiener_istft_plain(
            y, re, im, window, hop, length, p=p, eps=eps,
            conserve_last=conserve_last, output_dtype=output_dtype, ny=ny,
        )
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"wiener_istft: tensors on mixed devices {devices}")
    S = int(y.shape[-3])
    if not wiener_istft_supported(nfft, win_len, hop):
        raise ValueError(f"wiener_istft kernel unsupported for nfft={nfft} win={win_len} hop={hop}")
    if p not in (1.0, 2.0):
        raise ValueError(f"wiener_istft kernel supports p in (1, 2), got {p}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"y must be float32 or bfloat16, got {y.dtype}")
    if any(t.dtype != torch.float32 for t in tensors[1:]):
        raise ValueError("re/im (and ny) must be float32")
    nf = int(re.shape[-2])
    nt = math.prod(lead)
    plan = plan_of(nt, S, nf, nfft, hop)
    dev = y.device
    where = str(dev)
    y4 = y.reshape(nt, S, nf, bins).contiguous()
    re3 = re.reshape(nt, nf, -1).contiguous()
    im3 = im.reshape(nt, nf, -1).contiguous()
    ny2 = ny.reshape(nt, nf).contiguous() if has_ny else None
    win_n, inv_norm = synthesis_tables(window, nfft, hop, nf, where)
    out_dt = torch.int16 if output_dtype == "int16" else torch.float32
    out = torch.empty((nt, S, length), dtype=out_dt, device=dev)
    lib = kernels.library()
    args = (y4.data_ptr(), int(y4.dtype == torch.bfloat16), re3.data_ptr(), im3.data_ptr(),
            ny2.data_ptr() if has_ny else None, win_n.data_ptr(), inv_norm.data_ptr())
    tw, tw_n, chirp, chat = (t.data_ptr() if t is not None else None
                             for t in _tables(plan.route, nfft, where))
    tail = (int(p == 2.0), ctypes.c_float(eps), int(conserve_last))
    with kernels.on_device(dev):
        stream = torch.cuda.current_stream(dev.index).cuda_stream
        if plan.route == "cluster":
            code = lib.wiener_cluster_launch(
                *args, tw, chirp, chat, out.data_ptr(), int(out_dt == torch.int16), nt, S, nf,
                nfft, int(hop), int(length), plan.rounds, *tail, None, stream,
            )
        elif plan.route == "cluster_dit":
            code = lib.wiener_cluster_dit_launch(
                *args, tw, out.data_ptr(), int(out_dt == torch.int16), nt, S, nf, nfft, int(hop),
                int(length), plan.rounds, *tail, None, stream,
            )
        elif plan.route == "cluster_mixed":
            code = lib.wiener_cluster_mixed_launch(
                *args, tw, out.data_ptr(), int(out_dt == torch.int16), nt, S, nf, nfft, int(hop),
                int(length), plan.rounds, mixed_schedule(mixed_radices(nfft // plan.cluster)),
                *tail, None, stream,
            )
        else:
            code = lib.wiener_istft_launch(
                *args, tw, tw_n, chirp, chat, out.data_ptr(), int(out_dt == torch.int16), nt, S,
                nf, nfft, int(hop), int(length), plan.groups,
                plan.rounds if plan.groups else plan.rows, *tail, stream,
            )
    name = ("wiener_istft_ny" if has_ny else "wiener_istft") + (
        "" if plan.route == "fft" else "_" + plan.route)
    kernels.check(code, name)
    kernels.LAUNCHES[name] += 1
    return out.reshape(*lead, S, length)


def _tables(route: str, nfft: int, where: str) -> tuple:
    """The tables a route's launch reads, (tw, tw_n, chirp, chat), None where
    it reads none: the quarter twiddle table of nfft on the core and the
    power-of-two cluster, of 2^a and nfft on the split, of Bluestein's M beside
    the chirp tables on Bluestein and its cluster; the full e^{−2πi m/N}
    table for the direct sum and the mixed cluster."""
    if route in ("bluestein", "cluster"):
        chirp, chat = bluestein_tables(nfft, where)
        return twiddles(bluestein_size(nfft), where), None, chirp, chat
    if route == "split":
        return twiddles(split_factors(nfft)[1], where), twiddles(nfft, where), None, None
    if route in ("direct", "cluster_mixed"):
        return dft_table(nfft, where), None, None, None
    return twiddles(nfft, where), None, None, None
