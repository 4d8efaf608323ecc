"""ConvSep separation network: the inference path and the training path.

Mirror of ``convsep_tpu.models.convsep``. What separation runs
(``encoder_impl="collapsed"``):

* the collapsed encoder: conv1 → conv2 → flatten → fc has no nonlinearity
  before the post-fc ReLU, so it is ONE (B, T·F·C) @ (T·F·C, J) GEMM whose
  weight is the tied decode chain (:func:`band_decode_wmajor` +
  :func:`freq_decode_wmajor`) applied to the fc kernel's columns, computed
  once per model by :meth:`ConvSep.prepare_inference`;
* the per-source expansion dense, ReLU, and both tied InverseLayer decode
  stages composed into one matrix (:func:`band_freq_conv_kernel`): the
  reference's ``bandconv`` / ``bandconv_pallas`` decode, here
  :func:`convsep_tpu_torch.models.decoder_fused_cuda.band_freq_decode`
  (plain PyTorch or the hand-written CUDA kernel);
* the phase merge back to frequency bins, then ``out_bias`` and ReLU in
  ``mask_dtype`` (cast BEFORE the bias add, as the reference does).

``decoder_impl="band"`` / ``"band_pallas"`` decode in two stages instead:
the expansion dense (no W padding) and ReLU, viewed w-major as (B·S, W',
Tp·C2); the banded time stage, a float32 GEMM (``band``) or the bf16
operand kernel of :mod:`convsep_tpu_torch.models.decoder_band_cuda`
(``band_pallas``, the reference's numbers); then :func:`freq_decode_wmajor`.

What training runs (``encoder_impl="conv"``, the config
:func:`trainable_config` makes; :func:`train_sources`): conv1 → conv2 →
flatten in (T', F', C2) order → fc → ReLU → the expansion dense (no W
padding) → ReLU → the composed decode as a full conv along W', written as
one GEMM over all taps and shifted adds, with the composed matrix built inside
every call from the live conv kernels, so gradients reach them through
both the encoder and the decoder → phase merge → ``out_bias`` and ReLU in
float32. A model on a trainable config holds parameters that require
gradients.

Layouts at the public functions are the reference's: NHWC (B, T, F, C)
input, source-major (B, S, T, F) output, HWIO conv kernels. The reference's
decision-record decoders are not ported.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch
from torch import nn

from convsep_tpu_torch.models.config import ConvSepConfig
from convsep_tpu_torch.models.decoder_band_cuda import BandOperand, band_operand
from convsep_tpu_torch.models.decoder_band_cuda import band_decode_wmajor as band_decode_kernel
from convsep_tpu_torch.models.decoder_fused_cuda import (
    band_freq_decode,
    band_freq_decode_plain,
    fused_decode_supported,
    fused_decode_won,
    kcat_of,
    kernel_supported,
    prepare_operands,
    tap_fold,
)
from convsep_tpu_torch.utils.precision import float32_exact

__all__ = ["ConvSep", "ConvSepConfig", "resolve_decoder_impl", "train_sources",
           "trainable_config"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_BAND = ("band", "band_pallas")  # the two-stage decodes: no composed operands


@lru_cache(maxsize=16)
def _band_index(kh: int, Tp: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The banded tap matrix's (Tp, T) tap index and mask on ``device``,
    made once: the training step builds the matrix every step, and a copy
    from the host there is a wait that a CUDA graph cannot hold."""
    T = Tp + kh - 1
    delta = torch.arange(T)[None, :] - torch.arange(Tp)[:, None]
    return delta.clamp(0, kh - 1).to(device), ((delta >= 0) & (delta < kh)).to(device)


def _band_matrix_for(kernel: torch.Tensor, Tp: int) -> torch.Tensor:
    """(kh, 1, I, O) tied time kernel → dense (Tp·O, T·I) banded tap matrix."""
    kh, kw, I, O = kernel.shape
    if kw != 1:
        raise ValueError(f"band decode expects a (kh, 1, I, O) kernel, got {tuple(kernel.shape)}")
    T = Tp + kh - 1
    index, valid = _band_index(kh, Tp, str(kernel.device))
    taps = kernel[:, 0].permute(0, 2, 1)  # (kh, O, I)
    band = taps[index] * valid[:, :, None, None]
    return band.permute(0, 2, 1, 3).reshape(Tp * O, T * I)


def band_decode_wmajor(y: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Time-stage tied decode: y (N, Tp, W, O) → (N, W, T, I), w-major."""
    N, Tp, W, O = y.shape
    T = Tp + kernel.shape[0] - 1
    y2 = y.permute(0, 2, 1, 3).reshape(N * W, Tp * O)
    return (y2 @ _band_matrix_for(kernel, Tp)).reshape(N, W, T, kernel.shape[2])


def _freq_conv_kernel(kernel: torch.Tensor, stride: int) -> tuple[torch.Tensor, int]:
    """(1, kw, I, O) tied kernel → phase-decomposed (ktaps, 1, O, stride·I),
    taps flipped, out channels ordered (phase, in-channel)."""
    _, kw, I, O = kernel.shape
    ktaps = -(-kw // stride)
    k = torch.nn.functional.pad(kernel, (0, 0, 0, 0, 0, ktaps * stride - kw))
    k = k.reshape(ktaps, stride, I, O).flip(0)
    return k.permute(0, 3, 1, 2).reshape(ktaps, 1, O, stride * I), ktaps


def _phase_merge_tail(o: torch.Tensor, stride: int, I: int, kw: int, in_freq: int,
                      out_freq: int) -> torch.Tensor:
    """(N, Wo, T, stride·I) full-conv output → (N, T, F, I): merge the stride
    phases into bins, keep the valid extent ((in_freq − 1)·stride + kw),
    zero-pad to ``out_freq``."""
    N, Wo, T, _ = o.shape
    o = o.reshape(N, Wo, T, stride, I).permute(0, 2, 1, 3, 4).reshape(N, T, Wo * stride, I)
    w_keep = min((in_freq - 1) * stride + kw, o.shape[2])
    if out_freq < w_keep:
        raise ValueError(f"decode output {tuple(o.shape)} exceeds target freq {out_freq}")
    return torch.nn.functional.pad(o[:, :, :w_keep], (0, 0, 0, out_freq - w_keep))


def freq_decode_wmajor(y: torch.Tensor, kernel: torch.Tensor, stride: int,
                       out_freq: int) -> torch.Tensor:
    """Freq-stage tied decode: y (N, W', T, O) → (N, T, F, I); a full conv
    along W' written as per-tap products and shifted adds."""
    _, kw, I, _ = kernel.shape
    k, ktaps = _freq_conv_kernel(kernel, stride)
    N, Wp, T, _ = y.shape
    g = torch.einsum("nwto,uom->nwtum", y, k[:, 0])
    o = y.new_zeros((N, Wp + ktaps - 1, T, k.shape[3]))
    for tau in range(ktaps):
        lo = ktaps - 1 - tau
        o[:, lo:lo + Wp] += g[:, :, :, tau]
    return _phase_merge_tail(o, stride, I, kw, Wp, out_freq)


def band_freq_conv_kernel(k2: torch.Tensor, k1: torch.Tensor, Tp: int, stride: int):
    """Both decode stages as ONE conv along W': ((ktaps, 1, Tp·O, T·M),
    ktaps, T, M) with M = stride·C."""
    kh2, _, I2, O2 = k2.shape
    T = Tp + kh2 - 1
    bm3 = _band_matrix_for(k2, Tp).reshape(Tp * O2, T, I2)
    kc, ktaps = _freq_conv_kernel(k1, stride)
    M = kc.shape[3]
    KC = torch.einsum("cti,uim->uctm", bm3, kc[:, 0])
    return KC.reshape(ktaps, 1, Tp * O2, T * M), ktaps, T, M


def compose_collapsed_fc(kernel, bias, k1, b1, k2, b2, cfg: ConvSepConfig):
    """(fc kernel, fc bias, conv params) → (W_eff (T·F·C, J), c (J,)): the
    tied decode adjoint of the fc columns, with conv1/conv2 biases folded
    through the chain."""
    J = cfg.bottleneck
    w4 = kernel.reshape(cfg.enc_time, cfg.enc_freq, cfg.conv2_filters, J)
    d2wm = band_decode_wmajor(w4.permute(3, 0, 1, 2), k2)  # (J, F', T, C1)
    weff = freq_decode_wmajor(d2wm, k1, cfg.conv1_freq_stride, cfg.feat_size)
    w_eff = weff.reshape(J, -1).T
    h2c = torch.einsum("hwio,i->o", k2, b1) + b2
    return w_eff, bias + h2c @ w4.sum(dim=(0, 1))


@float32_exact()
def train_sources(params: dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ConvSepConfig) -> torch.Tensor:
    """The trainable forward, (B, T, F, C) → (B, S, T, F) in ``mask_dtype``,
    as a function of the flat parameter dict (:func:`param_shapes` names):
    the reference's ``ConvSep.sources`` with ``encoder_impl="conv"`` and the
    "bandconv" decode. Its convolutions run without TF32 (cuDNN's default
    for float32); the training step scopes the backward the same way."""
    B, T, F, C = x.shape
    if (T, F, C) != (cfg.time_context, cfg.feat_size, cfg.channels_in):
        raise ValueError(f"input {tuple(x.shape)} does not match config {cfg}")
    k1, k2 = params["conv1_kernel"], params["conv2_kernel"]
    s1 = cfg.conv1_freq_stride
    # NHWC / HWIO → NCHW / OIHW for torch's conv; the arithmetic is unchanged
    h1 = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2), k1.permute(3, 2, 0, 1),
                                    stride=(1, s1))
    h1 = h1 + params["conv1_bias"][:, None, None]
    h2 = torch.nn.functional.conv2d(h1, k2.permute(3, 2, 0, 1))
    h2 = h2 + params["conv2_bias"][:, None, None]
    # flatten in the reference's NHWC (T', F', C2) row-major order: the fc
    # kernel's rows are laid out that way
    flat = h2.permute(0, 2, 3, 1).reshape(B, -1)
    fc = torch.relu(flat @ params["fc_kernel"] + params["fc_bias"])
    S, W, TpC = cfg.num_sources, cfg.enc_freq, cfg.enc_time * cfg.conv2_filters
    e = torch.relu(fc @ params["fc_expand_kernel"] + params["fc_expand_bias"])
    KC, ktaps, Tt, M = band_freq_conv_kernel(k2, k1, cfg.enc_time, s1)
    # the reference's training "bandconv" (KC as a full conv along W')
    o = tap_fold(e.reshape(B * S, W, TpC), kcat_of(KC))
    d1 = _phase_merge_tail(o.reshape(B * S, W + ktaps - 1, Tt, M), s1, C,
                           cfg.conv1_freq, W, cfg.feat_size)
    return _finish(d1, params["out_bias"], B, S, C, cfg)


def _finish(d1: torch.Tensor, out_bias: torch.Tensor, B: int, S: int, C: int,
            cfg: ConvSepConfig) -> torch.Tensor:
    """(B·S, T, F, C) → channels reduced, cast to ``mask_dtype`` BEFORE the
    ``out_bias`` add, ReLU → (B, S, T, F) (or (B, S, T, F, C) for "all")."""
    md = _DTYPES[cfg.mask_dtype]
    bias = out_bias.to(md)
    if cfg.decoder_reduce == "all":
        y = d1.reshape(B, S, cfg.time_context, cfg.feat_size, C)
        return torch.relu(y.to(md) + bias[:, None, None, None])
    d = d1[..., 0] if cfg.decoder_reduce == "first" else d1.sum(dim=-1)
    y = d.reshape(B, S, cfg.time_context, cfg.feat_size)
    return torch.relu(y.to(md) + bias[:, None, None])


def resolve_decoder_impl(cfg: ConvSepConfig, device: torch.device,
                         batch: int | None = None) -> str:
    """The decode route: "bandconv_pallas" (the fused CUDA kernel wrapper),
    "bandconv" (plain PyTorch), or the two-stage "band_pallas" (the band
    kernel's wrapper) and "band" (a float32 GEMM). "auto" takes the fused
    kernel on CUDA only where the reference's TPU rule admits the shape, the
    kernel's envelope holds and the kernel won its A/B against the plain
    decode at that TM and ``batch`` (the decode's fc rows, B · segments) on
    the card (``FUSED_DECODE_WON``): the reference's rule that "auto" only
    ever picks the winning branch. An unknown batch (None) takes the plain
    decode. The table is keyed on ``cfg.compute_dtype``: under
    ``"bfloat16"`` the plain decode runs bf16 GEMMs, the float32 kernel
    gets the bf16 operands as float32 and lost its A/B (PERF.md), and the
    bf16 table is empty, so "auto" takes "bandconv". An explicit kernel
    route asks for the wrapper, which is the plain version on CPU tensors
    (``decoder_impl="bandconv_pallas"`` still runs the kernel under bf16)."""
    impl = cfg.decoder_impl
    if impl in ("bandconv", "bandconv_pallas", *_BAND):
        return impl
    if impl != "auto":
        raise NotImplementedError(
            f"decoder_impl={impl!r} is a reference decision record and is not "
            "ported; have auto | bandconv | bandconv_pallas | band | band_pallas"
        )
    TpC = cfg.enc_time * cfg.conv2_filters
    TM = cfg.time_context * cfg.conv1_freq_stride * cfg.channels_in
    if (
        torch.device(device).type == "cuda"
        and batch is not None
        and fused_decode_supported(TpC, TM, cfg.ktaps)
        and kernel_supported(cfg.bottleneck, cfg.ktaps, TM)
        and fused_decode_won(TM, batch, cfg.compute_dtype)
    ):
        return "bandconv_pallas"
    return "bandconv"


def trainable_config(cfg: ConvSepConfig) -> ConvSepConfig:
    """The differentiable config (the reference's rule): the fused decode
    and "auto" become the plain composed "bandconv" decode, the collapsed
    encoder reverts to the conv chain, the expansion is not W-padded
    (``expand_pad="output"``), and the mask tail is float32."""
    if cfg.decoder_impl == "band_pallas":
        cfg = dataclasses.replace(cfg, decoder_impl="band")
    if cfg.decoder_impl in ("bandconv_pallas", "auto"):
        cfg = dataclasses.replace(cfg, decoder_impl="bandconv")
    if cfg.encoder_impl == "collapsed":
        cfg = dataclasses.replace(cfg, encoder_impl="conv")
    if cfg.expand_pad == "kernel":
        cfg = dataclasses.replace(cfg, expand_pad="output")
    if cfg.mask_dtype != "float32":
        cfg = dataclasses.replace(cfg, mask_dtype="float32")
    return cfg


def _check_config(cfg: ConvSepConfig) -> None:
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    if cfg.compute_dtype != "float32" and (
        cfg.encoder_impl != "collapsed"
        or cfg.decoder_impl not in ("auto", "bandconv", "bandconv_pallas")
    ):
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r} is ported for inference on the composed "
            "decode (encoder_impl='collapsed', decoder_impl auto | bandconv | bandconv_pallas)"
        )
    if cfg.mask_dtype not in _DTYPES:
        raise ValueError(f"unknown mask_dtype {cfg.mask_dtype!r}")
    if cfg.encoder_impl not in ("collapsed", "conv"):
        raise ValueError(f"unknown encoder_impl {cfg.encoder_impl!r}; have conv | collapsed")
    if cfg.encoder_impl == "conv" and cfg.decoder_impl != "bandconv":
        raise NotImplementedError(
            "the conv (training) encoder is ported with decoder_impl='bandconv' "
            "(trainable_config); have bandconv"
        )
    if cfg.expand_order != "wmajor":
        raise NotImplementedError("only expand_order='wmajor' is ported")
    if cfg.expand_pad not in ("kernel", "output"):
        raise ValueError(f"unknown expand_pad {cfg.expand_pad!r}")
    if cfg.decoder_reduce not in ("first", "sum", "all"):
        raise ValueError(f"unknown decoder_reduce {cfg.decoder_reduce!r}")


def param_shapes(cfg: ConvSepConfig) -> dict[str, tuple[int, ...]]:
    """Parameter names (flat, ``fc/kernel`` → ``fc_kernel``) and shapes,
    identical to the reference's flax tree."""
    C, S, J = cfg.channels_in, cfg.num_sources, cfg.bottleneck
    return {
        "conv1_kernel": (1, cfg.conv1_freq, C, cfg.conv1_filters),
        "conv1_bias": (cfg.conv1_filters,),
        "conv2_kernel": (cfg.conv2_time_eff, 1, cfg.conv1_filters, cfg.conv2_filters),
        "conv2_bias": (cfg.conv2_filters,),
        "fc_kernel": (cfg.enc_flat, J),
        "fc_bias": (J,),
        "fc_expand_kernel": (J, S * cfg.enc_flat),
        "fc_expand_bias": (S * cfg.enc_flat,),
        "out_bias": (S,),
    }


class ConvSep(nn.Module):
    """Source-separation CNN; input (B, T, F, C) scaled magnitude, output
    (B, S, T, F) nonnegative estimates in ``mask_dtype``.

    Parameters are the reference's leaves under flat names
    (:func:`param_shapes`); build them with :mod:`convsep_tpu_torch.ckpt.bridge`.
    On a collapsed-encoder config the model is for inference (no
    gradients); on a :func:`trainable_config` its parameters require
    gradients and :meth:`sources` is :func:`train_sources`.
    """

    def __init__(self, cfg: ConvSepConfig, state: dict[str, torch.Tensor] | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        _check_config(cfg)
        self.config = cfg
        self.prepared = False
        trainable = cfg.encoder_impl == "conv"
        for name, shape in param_shapes(cfg).items():
            if state is None:
                t = torch.empty(shape, device=device)
            else:
                t = state[name].to(device=device, dtype=torch.float32)
                if tuple(t.shape) != shape:
                    raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
            self.register_parameter(name, nn.Parameter(t, requires_grad=trainable))

    @float32_exact()
    def _operands(self) -> dict[str, torch.Tensor]:
        """The composed encoder weight and, for the composed decodes, their
        operands (the two-stage band decodes read the raw expansion), with
        their products in float32 whatever precision the caller set."""
        cfg = self.config
        w_eff, c = compose_collapsed_fc(
            self.fc_kernel, self.fc_bias, self.conv1_kernel, self.conv1_bias,
            self.conv2_kernel, self.conv2_bias, cfg,
        )
        if cfg.decoder_impl == "band_pallas":  # the band and the kernels' packed taps
            op = band_operand(self.conv2_kernel, cfg.time_context)
            return {"w_eff": w_eff, "bias_eff": c, "band": op.band, "band_taps": op.packed,
                    "band_stream": op.stream}
        if cfg.decoder_impl in _BAND:
            return {"w_eff": w_eff, "bias_eff": c}
        KC, _, _, _ = band_freq_conv_kernel(
            self.conv2_kernel, self.conv1_kernel, cfg.enc_time, cfg.conv1_freq_stride
        )
        k4, b3, kcat = prepare_operands(
            self.fc_expand_kernel, self.fc_expand_bias, KC, cfg.num_sources,
            cfg.enc_freq, cfg.enc_time * cfg.conv2_filters,
        )
        ops = {"w_eff": w_eff, "bias_eff": c, "k4": k4, "b3": b3, "kcat": kcat}
        # compute_dtype: the operands composed in float32, then rounded
        dt = _DTYPES[cfg.compute_dtype]
        return {k: v.to(dt) for k, v in ops.items()}

    @torch.no_grad()
    def prepare_inference(self) -> "ConvSep":
        """Compute the composed encoder weight and the decode operands once
        (the reference's ``precompose_collapsed`` + ``prepare_inference``)
        and drop the raw ``fc_expand_kernel``: the padded ``k4`` replaces
        it, so the 827 MB highres4096 leaf is held once. The band decodes
        keep the raw leaf and build no ``k4``. A prepared model
        cannot be exported back to the reference tree. A trainable model
        (conv encoder) is never prepared: its training step composes the
        decode from the live kernels."""
        if self.config.encoder_impl != "collapsed":
            raise ValueError("prepare_inference needs the collapsed encoder; this model trains")
        if self.prepared:
            return self
        ops = self._operands()
        for name, t in ops.items():
            self.register_buffer(name, t.contiguous())
        if "k4" in ops:
            del self.fc_expand_kernel
        self.prepared = True
        self._prepared_ops = tuple(ops)
        return self

    def sources(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F, C) → (B, S, T, F)."""
        cfg = self.config
        if cfg.encoder_impl == "conv":
            return train_sources({n: getattr(self, n) for n in param_shapes(cfg)}, x, cfg)
        with torch.no_grad():
            return self._infer(x)

    def _infer(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        B, T, F, C = x.shape
        if (T, F, C) != (cfg.time_context, cfg.feat_size, cfg.channels_in):
            raise ValueError(f"input {tuple(x.shape)} does not match config {cfg}")
        ops = (
            {n: getattr(self, n) for n in self._prepared_ops}
            if self.prepared else self._operands()
        )
        fc = torch.relu(x.reshape(B, -1).to(ops["w_eff"].dtype) @ ops["w_eff"] + ops["bias_eff"])
        route = resolve_decoder_impl(cfg, x.device, B)
        if route in _BAND:
            return self._band_decode(fc, route, B, C, ops)
        md = _DTYPES[cfg.mask_dtype]
        if route == "bandconv_pallas":
            # bf16 operands are exact in float32 and so are their products:
            # the float32 kernel does the bf16 decode's work (its expansion
            # unrounded, where the reference rounds it to bf16)
            o4 = band_freq_decode(fc.float(), ops["k4"].float(), ops["b3"].float(),
                                  ops["kcat"].float(), out_dtype=md)
        else:
            o4 = band_freq_decode_plain(fc, ops["k4"], ops["b3"], ops["kcat"], out_dtype=md)
        S, W_pad = cfg.num_sources, o4.shape[2]
        M = cfg.conv1_freq_stride * C
        d1 = _phase_merge_tail(
            o4.reshape(B * S, W_pad, T, M), cfg.conv1_freq_stride, C,
            cfg.conv1_freq, cfg.enc_freq, cfg.feat_size,
        )
        return _finish(d1, self.out_bias, B, S, C, cfg)

    def _band_decode(self, fc: torch.Tensor, route: str, B: int, C: int,
                     ops: dict[str, torch.Tensor]) -> torch.Tensor:
        """The two-stage decode (the reference's w-major "band" and
        "band_pallas"): expansion + ReLU viewed (B·S, W', Tp·C2), the banded
        time stage (on "band_pallas" from the band and packed taps that
        :meth:`prepare_inference` builds once), the frequency stage, the
        tail."""
        cfg = self.config
        S, W, Tp, T = cfg.num_sources, cfg.enc_freq, cfg.enc_time, cfg.time_context
        e = torch.addmm(self.fc_expand_bias, fc, self.fc_expand_kernel).relu_()
        e = e.reshape(B * S, W, Tp * cfg.conv2_filters)
        if route == "band_pallas":
            d2 = band_decode_kernel(e, BandOperand(ops["band"], ops["band_taps"],
                                                       ops["band_stream"]), T)
        else:
            d2 = e.reshape(B * S * W, -1) @ _band_matrix_for(self.conv2_kernel, Tp)
        d1 = freq_decode_wmajor(d2.reshape(B * S, W, T, cfg.conv1_filters), self.conv1_kernel,
                                cfg.conv1_freq_stride, cfg.feat_size)
        return _finish(d1, self.out_bias, B, S, C, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sources(x)
