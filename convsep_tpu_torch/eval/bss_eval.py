"""BSS Eval source-separation metrics (SDR / SIR / SAR) in torch float64.

Mirror of ``convsep_tpu.eval.bss_eval`` (the bss_eval_sources
decomposition of Vincent et al. 2006, as popularized by mir_eval): each
estimate is split into

    s_target  — its projection onto the ``flen``-tap filtered subspace of
                the matching true source
    e_interf  — the further projection onto the subspace spanned by ALL
                true sources' delayed copies
    e_artif   — the remainder

    SDR = 10 log10 |s_target|² / |e_interf + e_artif|²
    SIR = 10 log10 |s_target|² / |e_interf|²
    SAR = 10 log10 |s_target + e_interf|² / |e_artif|²

The work runs in float64 on ``device`` (``None`` means "cuda", which
raises without a GPU; the CPU only when asked for), bar one step. The
correlations come from ``torch.fft.rfft`` / ``irfft``; the block-Toeplitz
Gram system is solved by ``torch.linalg.cholesky_ex`` and
``cholesky_solve`` (the reference's ``scipy.linalg.solve(assume_a="pos")``),
and where the factorization reports failure (a Gram singular to rounding,
as tones give) by ``torch.linalg.lstsq`` with LAPACK's SVD least squares
(gelsd), the reference's ``lstsq`` branch, on the host whatever the
device: PyTorch's CUDA ``lstsq`` assumes full rank, and a pseudo-inverse
on the card (eigh at gelsd's cutoff) truncates another set of singular
values, which lie densely around any cutoff, so its metrics left the
card-vs-CPU bound. ``SOLVES`` counts the Gram solves of the process by
route. The filter-and-sum is one batched FFT convolution.

Every estimate's projection onto all sources shares one Gram matrix, and
the one-source Grams are its diagonal blocks, so a call factors each once.
The metrics come back as numpy float64 arrays, as the reference's.
"""

from __future__ import annotations

import collections
import itertools

import numpy as np
import torch

from convsep_tpu_torch.utils.device import resolve_device


# Gram matrices solved in this process, by route: "cholesky" on the
# tensors' device, "lstsq_host" (gelsd on the host) where Cholesky failed
SOLVES: collections.Counter = collections.Counter()


def _f64(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _nfft(length: int, flen: int) -> int:
    return int(2 ** np.ceil(np.log2(length + flen)))


def _autocorr_gram(sf: torch.Tensor, flen: int, nfft: int) -> torch.Tensor:
    """Spectra (S, bins) of the sources → G (S·flen, S·flen) with
    G[(i,a),(j,b)] = <s_i(·-a), s_j(·-b)>."""
    S = sf.shape[0]
    corr = torch.fft.irfft(sf[:, None] * sf[None].conj(), n=nfft)  # (S, S, nfft)
    ar = torch.arange(flen, device=sf.device)
    lags = (ar[None, :] - ar[:, None]) % nfft  # blk[a, b] = corr[(b - a) mod nfft]
    return corr[:, :, lags].permute(0, 2, 1, 3).reshape(S * flen, S * flen)


def _cross_corr(ef: torch.Tensor, sf: torch.Tensor, flen: int, nfft: int) -> torch.Tensor:
    """Spectra of E estimates (E, bins) and S sources (S, bins) → D (E, S, flen)
    with D[e, j, b] = <est_e(·), s_j(·-b)>."""
    return torch.fft.irfft(ef[:, None] * sf[None].conj(), n=nfft)[..., :flen]


def _solve(G: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """G (..., n, n) positive semidefinite, D (..., n, k) → C with G C = D:
    Cholesky on G's device, or for each matrix where it fails the SVD
    least squares of the reference's branch (LAPACK gelsd) on the host
    (the module's docstring says why); ``SOLVES`` counts both."""
    L, info = torch.linalg.cholesky_ex(G)
    C = torch.cholesky_solve(D, L)
    bad = info != 0
    n_bad = int(bad.sum())
    SOLVES["cholesky"] += bad.numel() - n_bad
    SOLVES["lstsq_host"] += n_bad
    if not n_bad:
        return C
    if G.dim() == 2:
        return torch.linalg.lstsq(G.cpu(), D.cpu(), driver="gelsd").solution.to(C)
    C[bad] = torch.linalg.lstsq(G[bad].cpu(), D[bad].cpu(), driver="gelsd").solution.to(C)
    return C


def _filter_sum(C: torch.Tensor, sf: torch.Tensor, nfft: int, length: int) -> torch.Tensor:
    """Filters C (E, S, flen) and source spectra (S, bins) → (E, length):
    Σ_j conv(s_j, C[e, j])[:length]."""
    cf = torch.fft.rfft(C, n=nfft)  # (E, S, bins)
    return torch.fft.irfft((cf * sf[None]).sum(dim=1), n=nfft)[:, :length]


def _project(ests: torch.Tensor, sources: torch.Tensor, flen: int) -> torch.Tensor:
    """Least-squares projection of each row of ``ests`` (E, L) onto the
    delayed copies of ``sources`` (S, L) → (E, L)."""
    S, L = sources.shape
    nfft = _nfft(L, flen)
    sf = torch.fft.rfft(sources, n=nfft)
    ef = torch.fft.rfft(ests, n=nfft)
    D = _cross_corr(ef, sf, flen, nfft).reshape(ests.shape[0], S * flen)
    C = _solve(_autocorr_gram(sf, flen, nfft), D.T).T.reshape(-1, S, flen)
    return _filter_sum(C, sf, nfft, L)


def _db(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return 10 * torch.log10((num + 1e-30) / (den + 1e-30))


def _energy(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(dim=-1)


def _check_pair(refs: np.ndarray, ests: np.ndarray) -> None:
    if refs.shape != ests.shape or refs.ndim != 2:
        raise ValueError(f"shape mismatch: refs {refs.shape} vs ests {ests.shape}")


def bss_eval_sources(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    flen: int = 512,
    compute_permutation: bool = False,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(S, L) references + estimates → (sdr, sir, sar, perm), each (S,).

    With ``compute_permutation`` the estimate↔reference assignment of best
    mean SIR is chosen (campaign behavior); by default the order is taken
    as aligned."""
    dev = resolve_device(device)
    refs_np = np.asarray(reference_sources, np.float64)
    ests_np = np.asarray(estimated_sources, np.float64)
    _check_pair(refs_np, ests_np)
    S, L = refs_np.shape
    if any(np.sum(r**2) == 0 for r in refs_np):
        raise ValueError("reference source with zero energy")
    refs, ests = _f64(refs_np, dev), _f64(ests_np, dev)
    nfft = _nfft(L, flen)
    sf = torch.fft.rfft(refs, n=nfft)
    ef = torch.fft.rfft(ests, n=nfft)
    G = _autocorr_gram(sf, flen, nfft)
    D = _cross_corr(ef, sf, flen, nfft)  # (E=S, S, flen)
    # every estimate onto all sources: one Gram, S right-hand sides
    C_all = _solve(G, D.reshape(S, S * flen).T).T.reshape(S, S, flen)
    p_all = _filter_sum(C_all, sf, nfft, L)  # (S, L)
    # estimate i onto source j alone: the Gram's diagonal block j
    blocks = torch.stack([G[j * flen:(j + 1) * flen, j * flen:(j + 1) * flen]
                          for j in range(S)])  # (S, flen, flen)
    pairs = (list(itertools.product(range(S), range(S))) if compute_permutation
             else [(i, i) for i in range(S)])
    ii = torch.tensor([p[0] for p in pairs], device=dev)
    jj = torch.tensor([p[1] for p in pairs], device=dev)
    c1 = _solve(blocks[jj], D[ii, jj][..., None])[..., 0]  # (P, flen)
    s_true = torch.fft.irfft(torch.fft.rfft(c1, n=nfft) * sf[jj], n=nfft)[:, :L]
    e_interf = p_all[ii] - s_true
    e_artif = ests[ii] - p_all[ii]
    rows = torch.stack([
        _db(_energy(s_true), _energy(e_interf + e_artif)),
        _db(_energy(s_true), _energy(e_interf)),
        _db(_energy(s_true + e_interf), _energy(e_artif)),
    ], dim=-1).cpu().numpy()  # (P, 3)
    metric = {p: rows[k] for k, p in enumerate(pairs)}
    perms = list(itertools.permutations(range(S))) if compute_permutation else [tuple(range(S))]
    best = None
    for perm in perms:
        metrics = np.array([metric[(i, perm[i])] for i in range(S)])  # (S, 3)
        score = metrics[:, 1].mean()  # mean SIR, mir_eval's criterion
        if best is None or score > best[0]:
            best = (score, metrics, perm)
    _, metrics, perm = best
    return metrics[:, 0], metrics[:, 1], metrics[:, 2], np.asarray(perm)


def bss_eval_windowed(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    fs: int,
    window_s: float = 30.0,
    hop_s: float = 15.0,
    flen: int = 512,
    reduce: str = "median",
    device: str | torch.device | None = None,
) -> dict:
    """Campaign-style windowed evaluation (30 s windows at 15 s hop, the
    median over windows): (S, L) references + estimates → {"SDR": (S,),
    "SIR": (S,), "SAR": (S,), "windows": n, "per_window": (n, S, 3)}.
    Windows where any reference is silent are skipped."""
    refs = np.asarray(reference_sources, np.float64)
    ests = np.asarray(estimated_sources, np.float64)
    _check_pair(refs, ests)
    L = refs.shape[1]
    win = int(round(window_s * fs))
    hop = int(round(hop_s * fs))
    if L <= win:
        starts, win = [0], L
    else:
        starts = list(range(0, L - win + 1, hop))
    rows = []
    for s0 in starts:
        r, e = refs[:, s0:s0 + win], ests[:, s0:s0 + win]
        if any(np.sum(x**2) == 0 for x in r):
            continue  # silent-reference window: metric undefined, skip
        sdr, sir, sar, _ = bss_eval_sources(r, e, flen=flen, device=device)
        rows.append(np.stack([sdr, sir, sar], axis=-1))
    if not rows:
        raise ValueError("no evaluable windows (every window has a silent reference)")
    per_window = np.stack(rows)
    agg = (np.median if reduce == "median" else np.mean)(per_window, axis=0)
    return {"SDR": agg[:, 0], "SIR": agg[:, 1], "SAR": agg[:, 2], "windows": len(rows),
            "per_window": per_window}


def bss_eval_stereo(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    flen: int = 512,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(S, 2, L) stems: each channel's estimate decomposed against that
    channel's references (a source silent in the channel is represented by
    its other channel, so leakage into the wrong ear counts as
    interference), the target / interference / artifact energies summed
    over channels per source, then the three ratios."""
    dev = resolve_device(device)
    refs_np = np.asarray(reference_sources, np.float64)
    ests_np = np.asarray(estimated_sources, np.float64)
    if refs_np.shape != ests_np.shape or refs_np.ndim != 3 or refs_np.shape[1] != 2:
        raise ValueError(f"expected (S, 2, L) stems, got {refs_np.shape} / {ests_np.shape}")
    S = refs_np.shape[0]
    refs, ests = _f64(refs_np, dev), _f64(ests_np, dev)
    acc = torch.zeros((S, 5), dtype=torch.float64, device=dev)
    for c in range(2):
        rc, ec = refs[:, c], ests[:, c]
        active = [j for j in range(S) if np.sum(refs_np[j, c] ** 2) > 0]
        if not active:
            continue
        basis = [j for j in range(S) if j in active or np.sum(refs_np[j, 1 - c] ** 2) > 0]
        rows = torch.stack([rc[j] if j in active else refs[j, 1 - c] for j in basis])
        p_all = _project(ec, rows, flen)  # (S, L)
        s_true = torch.zeros_like(ec)
        for j in active:
            s_true[j] = _project(ec[j:j + 1], rc[j:j + 1], flen)[0]
        e_interf = p_all - s_true
        e_artif = ec - p_all
        acc += torch.stack([_energy(s_true), _energy(e_interf), _energy(e_interf + e_artif),
                            _energy(s_true + e_interf), _energy(e_artif)], dim=-1)
    acc = acc.cpu().numpy()
    eps = 1e-30
    sdr = 10 * np.log10((acc[:, 0] + eps) / (acc[:, 2] + eps))
    sir = 10 * np.log10((acc[:, 0] + eps) / (acc[:, 1] + eps))
    sar = 10 * np.log10((acc[:, 3] + eps) / (acc[:, 4] + eps))
    return sdr, sir, sar


def sdr_only(reference: np.ndarray, estimate: np.ndarray,
             device: str | torch.device | None = None) -> float:
    """Plain (filter-free) SNR-style SDR, a fast proxy; a silent reference
    gives -inf."""
    dev = resolve_device(device)
    ref, est = _f64(reference, dev), _f64(estimate, dev)
    ref_energy = float(_energy(ref.reshape(-1)))
    if ref_energy == 0.0:
        return float("-inf")
    return float(10 * np.log10(ref_energy / (float(_energy((ref - est).reshape(-1))) + 1e-30)))
