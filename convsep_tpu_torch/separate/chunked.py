"""Chunked single-track separation: fixed-size chunks through one chunk
program, with the overlap-add spill carried across chunk seams on the device.

Mirror of ``convsep_tpu.separate.chunked``. The track is cut into chunks of
``chunk_segments`` whole time-context windows, so the model sees the same
segments as the whole-track :class:`~convsep_tpu_torch.separate.pipeline.
Separator`, and each chunk runs

    frames → DFT → |X|·mult_factor_in (+ extra channels) → ConvSep.sources →
    score gate → Wiener mask × mixture → inverse DFT → local overlap-add →
    + spill carried in → × the chunk's inverse normalization → stems chunk

The only coupling between chunks is the overlap-add spill: the last
``W − hop`` unnormalized samples of chunk i, a small device tensor that
chunk i + 1 adds to its head. The normalization differs from chunk to chunk
only in the first chunk's ramp-up and the last chunk's tail, so three cached
device slices serve any track (:func:`inv_norm_slice`).

The chunk's DFT and inverse DFT are plain float32 products (factored at
2048 points and more, as :func:`~convsep_tpu_torch.dsp.dft.stft_matmul`
chooses), as in the reference; the decode takes the model's route ("auto":
the fused decode kernel where it won on the card). The whole chunk program
runs inside :class:`~convsep_tpu_torch.utils.precision.float32_exact`.

:class:`ChunkedSeparator` overlaps a track's copies with its compute on
CUDA: the padded track is staged once in pinned memory, chunk i + 1's
upload and chunk i − 1's stems download run on one copy stream while chunk
i computes, and the host waits only for the stems.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.dsp.dft import (
    _dft_frames_factored,
    _forward_mats,
    _idft_frames_factored,
    _inverse_mats,
    _key,
    _t,
    _use_factored,
    check_precision,
)
from convsep_tpu_torch.dsp.istft import ola_norm, overlap_add
from convsep_tpu_torch.dsp.multires import _interp
from convsep_tpu_torch.dsp.multires import _window as _mr_window
from convsep_tpu_torch.dsp.stft import frame_signal, num_frames, scale_magnitude
from convsep_tpu_torch.models.convsep import ConvSep
from convsep_tpu_torch.models.masks import wiener_mask
from convsep_tpu_torch.separate.complement import derive_last_stem
from convsep_tpu_torch.separate.pipeline import (
    check_options,
    check_supported,
    score_gate,
    window_of,
)
from convsep_tpu_torch.utils.device import resolve_device
from convsep_tpu_torch.utils.pcm import quantize_pcm16, quantize_pcm16_host
from convsep_tpu_torch.utils.precision import float32_exact
from convsep_tpu_torch.utils.transfer import (
    fetch_async,
    host_array,
    stage_pinned,
    upload_async,
    wait_upload,
)


def _dft(frames: torch.Tensor, window: np.ndarray, nfft: int, bins: int):
    """Unwindowed frames (..., Fc, W) → (re, im) (..., Fc, bins): factored
    where ``_use_factored("auto", nfft)`` holds and nfft == W, else the
    direct product with the window folded into the matrices."""
    dev = str(frames.device)
    if _use_factored("auto", nfft) and nfft == frames.shape[-1]:
        return _dft_frames_factored(frames * _t(window, dev), nfft, bins)
    cos_m, sin_m = _forward_mats(nfft, _key(window), dev)
    return frames @ cos_m, frames @ sin_m


def _multires_extra_chunk(audio_slice: torch.Tensor, preset: Preset, Fc: int) -> torch.Tensor:
    """(Fc·hop + W − hop,) padded-coordinate chunk slice → (Fc, bins, n_res)
    multi-resolution extra channels on the whole-track grid of
    :func:`~convsep_tpu_torch.dsp.multires.multires_channels`, scaled like
    the network input.

    Every resolution shares the main hop and has a window W2 ≤ W, so its
    frame n starts at n·hop + (W − W2)/2 inside the main slice (front pad
    W/2): the slice holds all the context each resolution needs, and its
    zero edges reproduce the whole track's padding."""
    t, tr = preset.transform, preset.train
    W, hop = t.frame_size, t.hop_size
    chans = []
    for size in t.multires:
        if size > W:
            raise ValueError(f"multires size {size} exceeds the main frame size {W}")
        off = (W - size) // 2
        view = audio_slice[..., off: off + (Fc - 1) * hop + size]
        re2, im2 = _dft(frame_signal(view, size, hop, Fc), _mr_window(t.window, size),
                        size, size // 2 + 1)
        mag2 = torch.sqrt(re2 * re2 + im2 * im2)
        chans.append(mag2 @ _interp(size // 2 + 1, t.bins, str(mag2.device)))
    return scale_magnitude(torch.stack(chans, dim=-1), t.iscale) * tr.mult_factor_in


def _to_float(audio_slice: torch.Tensor) -> torch.Tensor:
    if audio_slice.dtype == torch.int16:
        return audio_slice.float() * (1.0 / 32768.0)
    return audio_slice.float()


@float32_exact()
@torch.inference_mode()
def chunk_source_magnitudes(
    model: ConvSep,
    audio_slice: torch.Tensor,
    preset: Preset,
    chunk_segments: int,
    extra: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk's chain up to the mask: audio_slice (Fc·hop + W − hop,)
    float32 or int16 → the model's score-gated source magnitudes y (S, Fc,
    bins) and the mixture's spectrum halves re, im (Fc, bins). ``extra``:
    (Fc, bins, C − 1) channels scaled like the network input; None
    computes a multires preset's own from the slice."""
    t, m, tr = preset.transform, preset.model, preset.train
    W, hop, T = t.frame_size, t.hop_size, m.time_context
    Fc = T * chunk_segments
    x = _to_float(audio_slice)
    re, im = _dft(frame_signal(x, W, hop, Fc), window_of(preset), t.nfft or W, t.bins)
    mag = scale_magnitude(torch.sqrt(re * re + im * im), t.iscale) * tr.mult_factor_in
    segs = mag.reshape(chunk_segments, T, m.feat_size, 1)
    if extra is None and t.multires:
        extra = _multires_extra_chunk(x, preset, Fc)
    if extra is not None:
        extra = extra.to(device=mag.device, dtype=torch.float32)
        segs = torch.cat([segs, extra.reshape(chunk_segments, T, m.feat_size, -1)], dim=-1)
    y = model.sources(segs)  # (cs, S, T, F)
    y = y.transpose(0, 1).reshape(m.num_sources, Fc, m.feat_size)
    y = score_gate(y[None], None if extra is None else extra[None], mag[None], preset)[0]
    return y, re, im


def _synthesize(mask: torch.Tensor, re: torch.Tensor, im: torch.Tensor, spill: torch.Tensor,
                inv_norm: torch.Tensor, preset: Preset, Fc: int,
                output_dtype: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked spectra → inverse DFT → overlap-add → + spill → × inverse
    normalization (→ PCM16): (stems chunk (..., Fc·hop), new spill (...,
    W − hop)). The inverse runs at the preset's ``dft_precision``: both
    ported values are exact float32."""
    t = preset.transform
    W, hop = t.frame_size, t.hop_size
    nfft = t.nfft or W
    check_precision(t.dft_precision)
    win = window_of(preset)
    est_re, est_im = mask * re, mask * im
    dev = str(re.device)
    if _use_factored("auto", nfft) and nfft == W:
        fr = _idft_frames_factored(est_re, est_im, nfft)[..., :W] * _t(win / float(nfft), dev)
    else:
        inv_a, inv_b = _inverse_mats(nfft, _key(win), dev)
        fr = est_re @ inv_a + est_im @ inv_b
    ola = overlap_add(fr, hop)  # (..., Fc·hop + W − hop), unnormalized
    margin = W - hop
    out = torch.cat([ola[..., :margin] + spill, ola[..., margin:Fc * hop]], dim=-1) * inv_norm
    new_spill = ola[..., Fc * hop:].clone()
    if output_dtype == "int16":
        out = quantize_pcm16(out)
    return out, new_spill


@float32_exact()
@torch.inference_mode()
def separate_chunk(
    model: ConvSep,
    audio_slice: torch.Tensor,
    spill: torch.Tensor,
    inv_norm_slice: torch.Tensor,
    preset: Preset,
    chunk_segments: int,
    output_dtype: str = "float32",
    extra: torch.Tensor | None = None,
    conserve_last: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the separation with the overlap-add carry.

    ``audio_slice``: (Fc·hop + W − hop,) padded-coordinate samples covering
    the chunk's Fc = chunk_segments · time_context frames (the track's W/2
    front pad included: the caller slices one padded buffer), float32 or
    int16. ``spill``: (S, W − hop) unnormalized overlap-add tail of the
    previous chunk (zeros for the first). ``inv_norm_slice``: (Fc·hop,)
    reciprocal window-power normalization of this chunk's output span.
    ``extra``: (Fc, bins, C − 1) score-informed channels of the chunk's
    frames, scaled like the network input.

    → (stems chunk (S, Fc·hop), new spill (S, W − hop))."""
    check_supported(preset)
    m = preset.model
    y, re, im = chunk_source_magnitudes(model, audio_slice, preset, chunk_segments, extra)
    mask = wiener_mask(y, p=preset.sep.wiener_p, eps=preset.sep.wiener_eps, axis=0,
                       conserve_last=conserve_last)
    return _synthesize(mask, re[None], im[None], spill, inv_norm_slice, preset,
                       m.time_context * chunk_segments, output_dtype)


@float32_exact()
@torch.inference_mode()
def separate_chunk_stereo(
    model: ConvSep,
    audio_slice: torch.Tensor,
    spill: torch.Tensor,
    inv_norm_slice: torch.Tensor,
    preset: Preset,
    chunk_segments: int,
    output_dtype: str = "float32",
    conserve_last: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stereo chunk: (2, Fc·hop + W − hop) slice + (S, 2, W − hop) spill →
    ((S, 2, Fc·hop) stems chunk, new spill), the joint-channel model of
    :mod:`convsep_tpu_torch.separate.stereo` in :func:`separate_chunk`'s
    carry design."""
    check_supported(preset, stereo=True)
    t, m, tr = preset.transform, preset.model, preset.train
    W, hop, T = t.frame_size, t.hop_size, m.time_context
    Fc = T * chunk_segments
    x = _to_float(audio_slice)
    re, im = _dft(frame_signal(x, W, hop, Fc), window_of(preset), t.nfft or W, t.bins)
    mag = scale_magnitude(torch.sqrt(re * re + im * im), t.iscale) * tr.mult_factor_in
    segs = mag.reshape(2, chunk_segments, T, m.feat_size).permute(1, 2, 3, 0)
    y = model.sources(segs)  # (cs, S, T, F, 2)
    y = y.permute(1, 4, 0, 2, 3).reshape(m.num_sources, 2, Fc, m.feat_size)
    mask = wiener_mask(y, p=preset.sep.wiener_p, eps=preset.sep.wiener_eps, axis=0,
                       conserve_last=conserve_last)
    return _synthesize(mask, re[None], im[None], spill, inv_norm_slice, preset, Fc, output_dtype)


def inv_norm_slice(preset: Preset, chunk_segments: int, i: int, nc: int, nf: int,
                   cache: dict, device: torch.device | str = "cpu") -> torch.Tensor:
    """The device inverse-normalization slice of chunk i of nc (nf true
    frames).

    Middle chunks all see the steady-state periodic sequence; only the
    first (ramp-up) and last (tail) differ, so three cached tensors cover
    any track length ("first", "mid", and "last" or "only" per length).
    :class:`ChunkedSeparator` and
    :class:`~convsep_tpu_torch.separate.online.OnlineSeparator` share this,
    so their normalization is byte-identical."""
    t = preset.transform
    hop = t.hop_size
    span = preset.model.time_context * chunk_segments * hop
    if i == 0 and nc == 1:
        key = ("only", nf)
    elif i == 0:
        key = "first"
    elif i == nc - 1:
        key = ("last", nf, nc)
    else:
        key = "mid"
    cached = cache.get(key)
    if cached is not None:
        return cached
    win = window_of(preset).astype(np.float32)
    norm = ola_norm(win, win, hop, nf)  # ((nf − 1)·hop + W,)
    total = nc * span
    if len(norm) < total:
        norm = np.concatenate([norm, np.ones(total - len(norm), np.float32)])
    inv = torch.from_numpy(1.0 / norm[i * span:(i + 1) * span]).to(device)
    if key in ("first", "mid") or len(cache) < 64:
        cache[key] = inv
    return inv


def padded_chunks(audio: np.ndarray, preset: Preset, chunk_segments: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """A ([2,] L) track in STFT padded coordinates (W/2 front zeros, zeros
    out to the last chunk's framing margin) and the chunk program's inputs
    cut from it: (nc, [2,] Fc·hop + W − hop), each chunk contiguous."""
    t = preset.transform
    W, hop = t.frame_size, t.hop_size
    span = preset.model.time_context * chunk_segments * hop
    L = audio.shape[-1]
    nc = max(1, math.ceil(num_frames(L, hop) / (span // hop)))
    padded = np.zeros(audio.shape[:-1] + (nc * span + W - hop,), audio.dtype)
    padded[..., W // 2: W // 2 + L] = audio
    return padded, np.stack([padded[..., i * span: i * span + span + W - hop]
                             for i in range(nc)])


def check_chunkable(preset: Preset, what: str) -> tuple[bool, int]:
    """The reference's rules for chunked and online separation: (stereo,
    number of extra channels the caller supplies)."""
    t, m = preset.transform, preset.model
    stereo = m.decoder_reduce == "all"
    n_extra = 0
    if stereo:
        if m.channels_in != 2 or t.multires:
            raise ValueError(f"unsupported stereo preset {preset.name!r}")
    elif t.multires:
        # computed inside the chunk program from the same audio slice
        if any(size > t.frame_size for size in t.multires):
            raise ValueError(
                f"{what} separation requires multires sizes <= the main "
                f"frame size (got {t.multires} vs {t.frame_size})"
            )
    else:
        # channels_in > 1: a score-informed preset, the caller's channels
        n_extra = m.channels_in - 1
    if t.frame_size % t.hop_size != 0:
        raise ValueError(f"{what} separation requires W % hop == 0")
    if 4 * t.hop_size < t.frame_size:
        raise ValueError(f"{what} separation requires hop >= W/4 (spill fits one seam)")
    check_supported(preset, stereo=stereo)
    return stereo, n_extra


class ChunkedSeparator:
    """Stream ONE track through the chunk program.

    >>> cs = ChunkedSeparator(preset, state, device="cuda")
    >>> stems = cs(audio)            # (num_sources, len(audio))

    Equal to the whole-track :class:`~convsep_tpu_torch.separate.pipeline.
    Separator` up to float reassociation (≤ 2e-5 on the CPU, the
    reference's bound); memory does not grow with the track's length.

    ``state``: a flat parameter dict (:mod:`convsep_tpu_torch.ckpt.bridge`),
    prepared for inference once here. ``device``: ``None`` means "cuda",
    and "cuda" without a GPU raises. ``conserve_last``, ``complement_last``
    (the last stem derived on the host from each chunk's mixture span),
    ``output_dtype`` and ``input_dtype`` as for the whole-track separator.
    ``fetch_streams`` is kept for the reference's signature: the port
    overlaps every copy on one copy stream, and ignores it.
    """

    def __init__(
        self,
        preset: Preset,
        state: dict[str, torch.Tensor],
        chunk_segments: int = 32,
        output_dtype: str = "float32",
        input_dtype: str = "float32",
        fetch_streams: int = 4,
        complement_last: bool = False,
        conserve_last: bool = False,
        device: str | torch.device | None = None,
    ):
        self._stereo, self._n_extra = check_chunkable(preset, "chunked")
        check_options(preset, output_dtype, input_dtype, conserve_last, complement_last)
        self.preset = preset
        self.device = resolve_device(device)
        self.model = ConvSep(preset.model, state, device=self.device).prepare_inference()
        self.chunk_segments = int(chunk_segments)
        self.output_dtype = output_dtype
        self.input_dtype = input_dtype
        self.complement_last = bool(complement_last)
        self.conserve_last = bool(conserve_last or complement_last)
        self._copy = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._norm_cache: dict = {}

    def _inv_norm_dev(self, i: int, nc: int, nf: int) -> torch.Tensor:
        return inv_norm_slice(self.preset, self.chunk_segments, i, nc, nf, self._norm_cache,
                              self.device)

    def _derive_last(self, others: np.ndarray, padded: np.ndarray, i: int,
                     span: int) -> np.ndarray:
        """The last stem of chunk i = mixture slice − Σ fetched stems
        (host). ``padded`` is the mixture in padded coordinates, so its
        slice [i·span, (i + 1)·span) aligns sample for sample with the
        chunk's stems."""
        return derive_last_stem(others, padded[..., i * span: i * span + span],
                                self.input_dtype, self.output_dtype)

    def _prepare(self, audio: np.ndarray) -> np.ndarray:
        if self._stereo:
            if audio.ndim != 2:
                raise ValueError(f"expected stereo audio, got {audio.shape}")
            if audio.shape[1] == 2 and audio.shape[0] != 2:
                audio = audio.T  # (L, 2) wav layout → (2, L)
            elif audio.shape[0] != 2:
                raise ValueError(f"expected a 2-channel axis, got {audio.shape}")
        elif audio.ndim != 1:
            raise ValueError(f"expected mono (length,) audio, got {audio.shape}")
        if self.input_dtype == "int16":
            return audio if audio.dtype == np.int16 else quantize_pcm16_host(audio)
        return np.asarray(audio, np.float32)

    def __call__(self, audio: np.ndarray, extra: np.ndarray | None = None) -> np.ndarray:
        """mono (length,) mixture → (num_sources, length) stems; stereo
        presets take (2, length) or (length, 2) and give (num_sources,
        length, 2) stems (the wav layout).

        ``extra``: (n_frames, bins, channels_in − 1) score-informed
        channels, required iff the preset takes them; sliced per chunk and
        uploaded beside the audio chunks."""
        if self._n_extra == 0:
            if extra is not None:
                raise ValueError(f"preset {self.preset.name!r} takes no extra channels")
        elif extra is None:
            raise ValueError(
                f"preset {self.preset.name!r} needs (n_frames, F, "
                f"{self._n_extra}) extra score channels"
            )
        audio = self._prepare(np.asarray(audio))
        t, m = self.preset.transform, self.preset.model
        W, hop = t.frame_size, t.hop_size
        S, F = m.num_sources, m.feat_size
        Fc = m.time_context * self.chunk_segments
        span = Fc * hop
        L = int(audio.shape[-1])
        nf = num_frames(L, hop)
        # staged in pinned memory chunk by chunk: every upload is one
        # contiguous copy
        padded, chunks = padded_chunks(audio, self.preset, self.chunk_segments)
        nc = len(chunks)
        host_in = stage_pinned(chunks, self.device)
        host_ex = None
        if self._n_extra:
            extra = np.asarray(extra, np.float32)
            if extra.shape[1:] != (F, self._n_extra):
                raise ValueError(
                    f"extra must be (n_frames, {F}, {self._n_extra}), got {extra.shape}"
                )
            ex_padded = np.zeros((nc * Fc, F, self._n_extra), np.float32)
            n = min(nf, extra.shape[0])
            ex_padded[:n] = extra[:n]
            host_ex = stage_pinned(ex_padded.reshape(nc, Fc, F, self._n_extra), self.device)

        def upload(i: int):
            up = upload_async(host_in[i], self.device, self._copy)
            ex = None if host_ex is None else upload_async(host_ex[i], self.device, self._copy)
            return up, ex

        spill = torch.zeros((S, *audio.shape[:-1], W - hop), dtype=torch.float32,
                            device=self.device)
        n_fetch = S - 1 if self.complement_last else S
        fetches = []
        nxt = upload(0)
        for i in range(nc):
            up, ex = nxt
            if i + 1 < nc:  # the next chunk's upload runs while this one computes
                nxt = upload(i + 1)
            x = wait_upload(*up)
            norm = self._inv_norm_dev(i, nc, nf)
            if self._stereo:
                out, spill = separate_chunk_stereo(
                    self.model, x, spill, norm, self.preset, self.chunk_segments,
                    self.output_dtype, self.conserve_last)
            else:
                out, spill = separate_chunk(
                    self.model, x, spill, norm, self.preset, self.chunk_segments,
                    self.output_dtype, None if ex is None else wait_upload(*ex),
                    self.conserve_last)
            fetches.append(fetch_async(out[:n_fetch], self._copy))
        # the copy stream runs in order: each wait returns once that chunk's
        # stems are in host memory, while the later chunks still compute
        parts = []
        for i, (host, done) in enumerate(fetches):
            got = host_array(host, done)
            if self.complement_last:
                got = np.concatenate([got, self._derive_last(got, padded, i, span)[None]], 0)
            parts.append(got)
        full = np.concatenate(parts, axis=-1)[..., W // 2: W // 2 + L]
        return full.transpose(0, 2, 1) if self._stereo else full
