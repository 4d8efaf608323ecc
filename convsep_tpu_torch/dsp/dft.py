"""DFT-as-matmul STFT / iSTFT and the masked-resynthesis dispatcher.

Mirror of ``convsep_tpu.dsp.dft``. The transforms are plain large
products, so they stay ``torch.matmul`` / ``einsum`` (cuBLAS on the GPU),
in exact float32 whatever precision the caller set: the three public
transforms run inside :class:`~convsep_tpu_torch.utils.precision.
float32_exact`. Two algorithms, as in the reference:

* ``direct``: frames @ (W, bins) cos / -sin matrices with the window
  folded in;
* ``factored``: the two-pass Cooley-Tukey form, O(N·(N1+N2)) MACs.

``auto`` picks factored at nfft >= 2048 (:func:`_use_factored`), so the
port's numbers follow the reference's route for every preset. On CUDA
tensors, :func:`istft_matmul`'s "auto" takes the hand-written iSTFT kernel
(``istft_ct_pallas``) wherever the reference's TPU rule would take its
kernel: factored, inside ``ct_pallas_supported``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from convsep_tpu_torch.dsp.istft import ola_norm, overlap_add
from convsep_tpu_torch.dsp.stft import _pad_signal, frame_signal, num_frames
from convsep_tpu_torch.utils.precision import float32_exact


def _key(window: np.ndarray) -> bytes:
    """A window as a cache key: its float64 bytes (hashing a tuple of 4096
    Python floats cost a quarter of a millisecond of host time per call)."""
    return np.ascontiguousarray(window, np.float64).tobytes()


def _window(window_key: bytes) -> np.ndarray:
    """The window back from :func:`_key`, float64."""
    return np.frombuffer(window_key, np.float64)


# matrices past this many entries are made on a CUDA device itself, a block of
# rows at a time: the host's float64 temporaries pass 50 GB at nfft 70 000
_DEVICE_MATS = 2 ** 28


@lru_cache(maxsize=16)
def _forward_mats(nfft: int, window_key: bytes, device: str):
    """(W, bins) cos / -sin matrices with the analysis window folded in, in
    float64 rounded once to float32 (on the host, or past
    :data:`_DEVICE_MATS` entries on a CUDA ``device``, in the same order of
    operations)."""
    window = _window(window_key)
    win_len = len(window)
    bins = nfft // 2 + 1
    if torch.device(device).type == "cuda" and win_len * bins > _DEVICE_MATS:
        w = torch.from_numpy(window.copy()).to(device)
        k = torch.arange(bins, dtype=torch.float64, device=device)
        cos_m = torch.empty((win_len, bins), dtype=torch.float32, device=device)
        sin_m = torch.empty_like(cos_m)
        step = max(1, _DEVICE_MATS // 4 // bins)
        for r0 in range(0, win_len, step):
            r1 = min(r0 + step, win_len)
            n = torch.arange(r0, r1, dtype=torch.float64, device=device)[:, None]
            ang = 2.0 * np.pi * n * k / nfft
            cos_m[r0:r1] = w[r0:r1, None] * torch.cos(ang)
            sin_m[r0:r1] = w[r0:r1, None] * -torch.sin(ang)
        return cos_m, sin_m
    ang = 2.0 * np.pi * np.arange(nfft)[:, None] * np.arange(bins)[None, :] / nfft
    cos_m = (window[:, None] * np.cos(ang)[:win_len]).astype(np.float32)
    sin_m = (window[:, None] * -np.sin(ang)[:win_len]).astype(np.float32)
    return torch.from_numpy(cos_m).to(device), torch.from_numpy(sin_m).to(device)


@lru_cache(maxsize=16)
def _inverse_mats(nfft: int, window_key: bytes, device: str):
    """(bins, W) matrices: ``re @ A + im @ B = irfft(re + i·im)[:W] · window``."""
    window = _window(window_key)
    win_len = len(window)
    bins = nfft // 2 + 1
    ang = 2.0 * np.pi * np.arange(bins)[:, None] * np.arange(win_len)[None, :] / nfft
    w_k = np.full((bins, 1), 2.0)
    w_k[0] = 1.0
    if nfft % 2 == 0:
        w_k[-1] = 1.0
    a = (w_k * np.cos(ang)) / nfft * window[None, :]
    b = (-w_k * np.sin(ang)) / nfft * window[None, :]
    return (
        torch.from_numpy(a.astype(np.float32)).to(device),
        torch.from_numpy(b.astype(np.float32)).to(device),
    )


def _split_factor(n: int) -> tuple[int, int] | None:
    """Balanced n = a·b with a, b >= 8, a as close to sqrt(n) as possible."""
    for a in range(int(np.sqrt(n)), 7, -1):
        if n % a == 0 and n // a >= 8:
            return a, n // a
    return None


def _ct_supported(nfft: int) -> bool:
    f = _split_factor(nfft)
    return f is not None and nfft % 2 == 0 and (nfft // 2) % f[0] == 0


def _use_factored(algorithm: str, nfft: int) -> bool:
    if algorithm == "factored":
        if not _ct_supported(nfft):
            raise ValueError(f"nfft={nfft} has no balanced even factorization")
        return True
    if algorithm == "direct":
        return False
    if algorithm != "auto":
        raise ValueError(f"unknown DFT algorithm {algorithm!r}; have auto | direct | factored")
    return nfft >= 2048 and _ct_supported(nfft)


def _t(x: np.ndarray, device: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


@lru_cache(maxsize=16)
def _window_on(window_key: bytes, device: str) -> torch.Tensor:
    """The window as float32 on ``device``, copied once (a copy inside a
    training step would be a host wait, and one a CUDA graph cannot hold)."""
    return _t(_window(window_key), device)


@lru_cache(maxsize=8)
def _ct_forward_consts(nfft: int, device: str) -> tuple:
    """n = n1 + N1·n2, k = N2·k1 + k2: (N1, N2, inner E2 cos/sin (N2, N2),
    twiddle cos/sin (N1, N2), outer E1 cos/sin (N1, N1))."""
    a, b = _split_factor(nfft)
    ang2 = 2.0 * np.pi * np.outer(np.arange(b), np.arange(b)) / b
    angt = 2.0 * np.pi * np.outer(np.arange(a), np.arange(b)) / nfft
    ang1 = 2.0 * np.pi * np.outer(np.arange(a), np.arange(a)) / a
    return (
        a, b,
        _t(np.cos(ang2), device), _t(-np.sin(ang2), device),
        _t(np.cos(angt), device), _t(-np.sin(angt), device),
        _t(np.cos(ang1), device), _t(-np.sin(ang1), device),
    )


def _dft_frames_factored(frames: torch.Tensor, nfft: int, bins: int):
    """Windowed frames (..., nf, N) → (re, im) (..., nf, bins)."""
    a, b, c2, s2, tc, ts, c1, s1 = _ct_forward_consts(nfft, str(frames.device))
    x = frames.reshape(*frames.shape[:-1], b, a)  # [n2, n1]
    yr = torch.einsum("...ba,bd->...ad", x, c2)
    yi = torch.einsum("...ba,bd->...ad", x, s2)
    zr = yr * tc - yi * ts
    zi = yr * ts + yi * tc
    xr = torch.einsum("...ad,ac->...cd", zr, c1) - torch.einsum("...ad,ac->...cd", zi, s1)
    xi = torch.einsum("...ad,ac->...cd", zr, s1) + torch.einsum("...ad,ac->...cd", zi, c1)
    xr = xr.reshape(*xr.shape[:-2], a * b)[..., :bins]
    xi = xi.reshape(*xi.shape[:-2], a * b)[..., :bins]
    return xr, xi


@lru_cache(maxsize=8)
def _ct_inverse_consts(nfft: int, device: str) -> tuple:
    """Inverse (+i) factored DFT over the half-spectrum: bins k = k1 + N1·k2
    (k < N/2), output n = N2·m1 + m2. (N1, N2, K2, E2 cos/sin (K2, N2),
    twiddle cos/sin (N1, N2), E1 cos/sin (N1, N1), alt (N2,) = (-1)^m2)."""
    a, b = _split_factor(nfft)
    k2n = (nfft // 2) // a
    ang2 = 2.0 * np.pi * np.outer(np.arange(k2n), np.arange(b)) / b
    ang_t = 2.0 * np.pi * np.outer(np.arange(a), np.arange(b)) / nfft
    ang1 = 2.0 * np.pi * np.outer(np.arange(a), np.arange(a)) / a
    return (
        a, b, k2n,
        _t(np.cos(ang2), device), _t(np.sin(ang2), device),
        _t(np.cos(ang_t), device), _t(np.sin(ang_t), device),
        _t(np.cos(ang1), device), _t(np.sin(ang1), device),
        _t(np.where(np.arange(b) % 2 == 0, 1.0, -1.0), device),
    )


def _idft_frames_factored(re: torch.Tensor, im: torch.Tensor, nfft: int) -> torch.Tensor:
    """Hermitian half-spectra (..., nf, bins) → real frames (..., nf, nfft),
    1/N not applied: 2·(sum over k < N/2) − re[0] + re[N/2]·(−1)^n."""
    a, b, k2n, c2, s2, tc, ts, c1, s1, alt = _ct_inverse_consts(nfft, str(re.device))
    half = nfft // 2
    xr = re[..., :half].reshape(*re.shape[:-1], k2n, a)
    xi = im[..., :half].reshape(*im.shape[:-1], k2n, a)
    ar = torch.einsum("...bc,bm->...cm", xr, c2) - torch.einsum("...bc,bm->...cm", xi, s2)
    ai = torch.einsum("...bc,bm->...cm", xr, s2) + torch.einsum("...bc,bm->...cm", xi, c2)
    br = ar * tc - ai * ts
    bi = ar * ts + ai * tc
    x = torch.einsum("...cm,cl->...lm", br, c1) - torch.einsum("...cm,cl->...lm", bi, s1)
    x = 2.0 * x - re[..., 0, None, None] + re[..., half, None, None] * alt
    return x.reshape(*x.shape[:-2], a * b)


@float32_exact()
def stft_matmul(
    signal: torch.Tensor,
    window: np.ndarray,
    hop: int,
    nfft: int | None = None,
    algorithm: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT of (..., length) → (re, im), each (..., nf, nfft//2+1) float32."""
    window = np.asarray(window, np.float64)
    win_len = len(window)
    nfft = int(nfft or win_len)
    sig = signal.float()
    nf = num_frames(sig.shape[-1], int(hop))
    frames = frame_signal(_pad_signal(sig, win_len, int(hop)), win_len, int(hop), nf)
    dev = str(sig.device)
    if _use_factored(algorithm, nfft):
        frames = frames * _window_on(_key(window), dev)
        if win_len < nfft:
            frames = torch.nn.functional.pad(frames, (0, nfft - win_len))
        return _dft_frames_factored(frames, nfft, nfft // 2 + 1)
    cos_m, sin_m = _forward_mats(nfft, _key(window), dev)
    return frames @ cos_m, frames @ sin_m


@lru_cache(maxsize=16)
def inverse_norm(window_key: bytes, hop: int, n_frames: int, device: str) -> torch.Tensor:
    """1 / :func:`ola_norm` (synthesis = analysis window) as a float32
    tensor on ``device`` (cached: it depends only on the static shape)."""
    w = _window(window_key).astype(np.float32)
    return torch.from_numpy(1.0 / ola_norm(w, w, hop, n_frames)).to(device)


def resolve_istft(algorithm: str, nfft: int, win_len: int, hop: int,
                  device: torch.device) -> str:
    """What :func:`istft_matmul` runs: "ct_pallas" (the iSTFT kernel
    wrapper) or the plain chain's "factored" | "direct". "auto" takes the
    kernel only for CUDA tensors where the reference's rule holds
    (factored, ``ct_pallas_supported``) inside the kernel's envelope; an
    explicit "ct_pallas" asks for the wrapper, which is the plain factored
    chain on CPU tensors."""
    if algorithm == "ct_pallas":
        return algorithm
    factored = _use_factored(algorithm, nfft)
    if algorithm == "auto" and factored and torch.device(device).type == "cuda":
        from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import istft_ct_supported

        if istft_ct_supported(nfft, win_len, hop):
            return "ct_pallas"
    return "factored" if factored else "direct"


@float32_exact()
def istft_matmul(
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    nfft: int | None = None,
    algorithm: str = "auto",
    output_dtype: str = "float32",
) -> torch.Tensor:
    """Inverse of :func:`stft_matmul`: (..., nf, bins)×2 → (..., length),
    window-power-normalized OLA with the W//2 front drop (the synthesis
    window is also the analysis window, as on every reference path).
    ``algorithm``: "auto" | "direct" | "factored" | "ct_pallas"
    (:func:`resolve_istft`)."""
    window = np.asarray(window, np.float64)
    win_len = len(window)
    nfft = int(nfft or 2 * (int(re.shape[-1]) - 1))
    if output_dtype not in ("float32", "int16"):
        raise ValueError(f"output_dtype must be float32|int16, got {output_dtype}")
    route = resolve_istft(algorithm, nfft, win_len, int(hop), re.device)
    if route == "ct_pallas":
        from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import istft_ct_pallas

        return istft_ct_pallas(re, im, window, int(hop), int(length), nfft=nfft,
                               output_dtype=output_dtype)
    expect = num_frames(length, hop)
    if int(re.shape[-2]) != expect:
        raise ValueError(
            f"re/im have {re.shape[-2]} frames but length={length}, hop={hop} "
            f"implies {expect}"
        )
    dev = str(re.device)
    if route == "factored":
        frames = _idft_frames_factored(re, im, nfft)[..., :win_len]
        frames = frames * _t(window / float(nfft), dev)
    else:
        inv_a, inv_b = _inverse_mats(nfft, _key(window), dev)
        frames = re @ inv_a + im @ inv_b
    inv_norm = inverse_norm(_key(window.astype(np.float32)), int(hop), expect, dev)
    data = overlap_add(frames, int(hop)) * inv_norm
    front = win_len // 2
    out = data[..., front:front + length]
    if output_dtype == "int16":
        from convsep_tpu_torch.utils.pcm import quantize_pcm16

        return quantize_pcm16(out)
    return out


def resolve_masked_synthesis(
    algorithm: str, nfft: int, win_len: int, hop: int, p: float, device: torch.device,
) -> str:
    """What :func:`istft_wiener` runs: "ct_pallas_wiener" (the Wiener+iSTFT
    kernel wrapper) or the masked chain's concrete iSTFT algorithm
    ("ct_pallas" | "factored" | "direct"). "auto" takes the Wiener kernel
    only for CUDA tensors where it won its A/B against the masked chain
    (``ct_istft_kernel.wiener_auto_supported``: the FFT core's powers of
    two, the split and Bluestein plans in ``WIENER_SPLIT_BLUESTEIN_WON`` and
    the cluster plans in ``WIENER_CLUSTER_WON``; an explicit
    "ct_pallas_wiener" reaches the kernel at the others; never the direct
    sum, which only ``wiener_direct_pallas`` forces); otherwise it
    names what :func:`istft_matmul`'s own "auto" runs
    (:func:`resolve_istft`)."""
    if algorithm == "ct_pallas_wiener":
        return algorithm
    if algorithm == "auto":
        from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_auto_supported

        if (
            torch.device(device).type == "cuda"
            and p in (1.0, 2.0)
            and wiener_auto_supported(nfft, win_len, hop)
        ):
            return "ct_pallas_wiener"
        return resolve_istft("auto", nfft, win_len, hop, device)
    if algorithm in ("ct_pallas", "direct", "factored"):
        return algorithm
    raise ValueError(
        f"unknown masked_synthesis {algorithm!r}; have auto | ct_pallas_wiener "
        "| ct_pallas | direct | factored"
    )


def check_precision(precision: str) -> None:
    """Both "highest" and "high" are exact float32 on this package's routes;
    the reference's bf16x1 "default" ablation is not ported."""
    if precision not in ("highest", "high"):
        raise NotImplementedError(
            f"dft_precision={precision!r} is not ported; have highest | high"
        )


@float32_exact()
def istft_wiener(
    y: torch.Tensor,
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    nfft: int | None = None,
    precision: str = "highest",
    algorithm: str = "auto",
    output_dtype: str = "float32",
    p: float = 1.0,
    eps: float = 1e-8,
    conserve_last: bool = False,
    ny: torch.Tensor | None = None,
) -> torch.Tensor:
    """Masked resynthesis: y (..., S, nf, bins) source magnitudes, re/im
    (..., nf, bins) mixture halves → stems (..., S, length); semantically
    ``istft_matmul(mask·re, mask·im)`` with ``mask = wiener_mask(y, p, eps,
    axis=-3, conserve_last)``.

    ``ny``: (..., nf) real Nyquist row when re/im are the forward STFT
    kernel's (..., nf, nfft/2) bodies (``analysis="ct_pallas"``). The
    Wiener+iSTFT kernel reads it as it is, on "auto" too (the reference's
    "auto" rebuilt the concatenated spectrum and took its XLA chain); the
    plain chain concatenates it back."""
    check_precision(precision)
    window = np.asarray(window, np.float64)
    nfft = int(nfft or 2 * (int(re.shape[-1]) - (0 if ny is not None else 1)))
    route = resolve_masked_synthesis(algorithm, nfft, len(window), int(hop), p, re.device)
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import (
        wiener_istft,
        wiener_istft_plain,
    )

    if route == "ct_pallas_wiener":
        return wiener_istft(
            y, re, im, window, int(hop), int(length), p=p, eps=eps,
            conserve_last=conserve_last, output_dtype=output_dtype, ny=ny,
        )
    return wiener_istft_plain(
        y, re, im, window, int(hop), int(length), p=p, eps=eps,
        conserve_last=conserve_last, output_dtype=output_dtype, algorithm=route, ny=ny,
    )
