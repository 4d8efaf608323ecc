"""One track separated across the mesh's ranks.

Mirror of ``convsep_tpu.separate.sharded``. For one long track the segment
axis is split over the mesh's ``data`` axis: the STFT (two products) is
replicated, each rank runs the model on its block of segments, masks its
block of frames, inverse-transforms them, and the overlap-add joins the
blocks with :func:`~convsep_tpu_torch.distributed.halo.halo_overlap_add`
(one exchange of the ``win - hop`` seam a boundary). Every rank returns
the whole stems. ``separate/stream.py`` scales across tracks; this scales
one stream.
"""

from __future__ import annotations

import numpy as np
import torch

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.data.segment import segment_frames
from convsep_tpu_torch.distributed.halo import halo_overlap_add_local
from convsep_tpu_torch.distributed.mesh import rank_device
from convsep_tpu_torch.dsp.dft import _inverse_mats, _key, inverse_norm, stft_matmul
from convsep_tpu_torch.dsp.stft import scale_magnitude
from convsep_tpu_torch.models.convsep import ConvSep
from convsep_tpu_torch.models.masks import wiener_mask
from convsep_tpu_torch.separate.pipeline import bucket_length, window_of
from convsep_tpu_torch.utils.device import resolve_device
from convsep_tpu_torch.utils.precision import float32_exact
from convsep_tpu_torch.utils.transfer import fetch


@float32_exact()
@torch.no_grad()
def separate_track_sharded(model: ConvSep, audio: torch.Tensor, preset: Preset, mesh,
                           length: int) -> torch.Tensor:
    """(length,) mixture (the same on every rank) → (S, length) stems on
    every rank, the segment and frame axes split over ``mesh``'s data
    axis. ``fft_impl="matmul"`` only. A segment count that does not divide
    the data axis is padded with zero segments (the reference's framing
    adds two frames, which spill into one more segment)."""
    t, m, tr = preset.transform, preset.model, preset.train
    if t.fft_impl != "matmul":
        raise ValueError("sharded separation requires fft_impl='matmul'")
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    r = mesh.get_local_rank("data")
    win = window_of(preset)
    hop, W = t.hop_size, t.frame_size
    re, im = stft_matmul(audio, win, hop, t.nfft)  # replicated
    nf = re.shape[0]
    mag = scale_magnitude(torch.sqrt(re * re + im * im), t.iscale) * tr.mult_factor_in
    segs = segment_frames(mag, m.time_context)  # (nseg, T, F), zero-padded
    nseg = segs.shape[0]
    if nseg % n:
        segs = torch.nn.functional.pad(segs, (0, 0, 0, 0, 0, n - nseg % n))
        nseg = segs.shape[0]
    per = nseg // n
    y = model.sources(segs[r * per:(r + 1) * per, ..., None])  # (per, S, T, F)
    nf_pad = nseg * m.time_context
    lo, hi = r * per * m.time_context, (r + 1) * per * m.time_context
    y_frames = y.transpose(0, 1).reshape(m.num_sources, hi - lo, m.feat_size)
    re_p = torch.nn.functional.pad(re, (0, 0, 0, nf_pad - nf))[lo:hi]
    im_p = torch.nn.functional.pad(im, (0, 0, 0, nf_pad - nf))[lo:hi]
    mask = wiener_mask(y_frames, p=preset.sep.wiener_p, eps=preset.sep.wiener_eps, axis=0)
    inv_a, inv_b = _inverse_mats(t.nfft or W, _key(win), str(re.device))
    frames = (mask * re_p[None]) @ inv_a + (mask * im_p[None]) @ inv_b  # window folded in
    data = halo_overlap_add_local(frames, hop, mesh, "data")  # (S, (nf_pad - 1)·hop + W)
    data = data * inverse_norm(_key(win), hop, nf_pad, str(re.device))
    return data[:, W // 2: W // 2 + length]


class ShardedSeparator:
    """Whole-track separator running one track across every rank of
    ``mesh`` (each rank calls it with the same track and gets the whole
    stems). ``device``: the rank's device by default (its GPU on an NCCL
    mesh, the CPU on a gloo one)."""

    def __init__(self, preset: Preset, state: dict[str, torch.Tensor], mesh,
                 device: str | torch.device | None = None):
        self.preset = preset
        self.mesh = mesh
        self.device = rank_device(mesh) if device is None else resolve_device(device)
        self.model = ConvSep(preset.model, state, device=self.device).prepare_inference()

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        audio = np.asarray(audio, np.float32)
        if audio.ndim != 1:
            raise ValueError(f"expected mono audio, got {audio.shape}")
        L = len(audio)
        Lb = bucket_length(L, self.preset)
        padded = torch.from_numpy(np.pad(audio, (0, Lb - L))).to(self.device)
        out = separate_track_sharded(self.model, padded, self.preset, self.mesh, Lb)
        return fetch(out)[:, :L]
