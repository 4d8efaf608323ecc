"""Reference checkpoint converter: Theano/Lasagne pickles ↔ the port's
flat parameter dict.

Mirror of ``convsep_tpu.ckpt.convert_reference``. A reference checkpoint
is a pickle of ``lasagne.layers.get_all_param_values(network)``, an
ordered list of numpy arrays. The rules:

1. **Conv kernels**: Theano's conv2d is a true convolution (kernel
   flipped); this package's are cross-correlations, so both spatial axes
   flip. Lasagne OIHW (out, in, kh, kw) → HWIO.
2. **Dense layers**: Lasagne stores (in, out) as here, but flattens the
   encoder output (channels, time, freq) row-major (NCHW) where this model
   flattens (time, freq, channels) (NHWC); row and column permutations
   fix it. The decode side's fold order is w-major (F', T', N2).
3. **The per-source expansion denses** are concatenated along the output
   axis into the single ``fc_expand_kernel``.
4. **The InverseLayer decoders are weight-tied** and hold no parameters.

:class:`Layout` declares the pickle's order and shapes;
:func:`detect_layout` picks the variant whose shapes fit. The parameters
come out as this package's flat dict (:func:`param_shapes` names) of
float32 CPU tensors, which a training state or ``ConvSep`` takes as they
are; :func:`export_reference_params` is the exact inverse. Nothing is
downloaded: the converter reads a file that the user supplies.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from convsep_tpu_torch.models.config import ConvSepConfig


@dataclasses.dataclass(frozen=True)
class Layout:
    """Order and shape conventions of the arrays in the reference pickle
    (the reference's own code was never available, so these are the
    plausible variants; :func:`detect_layout` chooses by shapes)."""

    conv_bias_separate: bool = True  # BiasLayer right after each conv
    merge_bias: bool = True  # final BiasLayer over the concatenated sources
    # True: per-source (expand.W, expand.b) pairs interleaved;
    # False: all expand.W arrays first, then all expand.b arrays
    expand_interleaved: bool = True
    # conv bias stored flat (filters,) or broadcastable (filters, 1, 1)
    conv_bias_chw: bool = False
    # Theano conv2d is a flipped true convolution; set False only if a
    # forward pass against a real reference output proves flip_filters=False
    flip_kernels: bool = True


# The pickles are files from outside, and pickle.load runs whatever code a
# malicious pickle names. The default loader therefore only rebuilds numpy
# arrays and raises on anything else; allow_unsafe=True restores full
# pickle semantics for a caller who trusts the file.
_SAFE_GLOBALS = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    # protocol-2 (Python 2) pickles encode array bytes through _codecs.encode
    ("_codecs", "encode"),
}


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Unpickler restricted to numpy-array reconstruction (no code runs)."""

    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"reference checkpoint pickle requests {module}.{name}; only plain "
            f"numpy arrays are allowed. If you trust this file, pass allow_unsafe=True."
        )


def load_reference_pickle(path: str, allow_unsafe: bool = False) -> list[np.ndarray]:
    """The reference checkpoint's arrays (Python 2 pickles read as latin1);
    only numpy arrays may be rebuilt unless ``allow_unsafe``."""

    def _load(f, **kw):
        if allow_unsafe:
            return pickle.load(f, **kw)
        return _NumpyOnlyUnpickler(f, **kw).load()

    with open(path, "rb") as f:
        try:
            values = _load(f)
        except UnicodeDecodeError:
            f.seek(0)
            values = _load(f, encoding="latin1")
    if not isinstance(values, (list, tuple)):
        raise ValueError(f"expected a list of arrays in {path}, got {type(values)}")
    return [np.asarray(v) for v in values]


def _check_order(cfg: ConvSepConfig) -> None:
    if cfg.expand_order != "wmajor":
        raise NotImplementedError(
            f"expand_order={cfg.expand_order!r} is not ported; the port folds w-major")


def _nchw_to_nhwc_perm(cfg: ConvSepConfig) -> np.ndarray:
    """perm[j] = i: flat NHWC index j here ↔ Lasagne's flat NCHW index i
    over the encoder output (T', F', N2) / (N2, T', F')."""
    Tp, Fp, C = cfg.enc_time, cfg.enc_freq, cfg.conv2_filters
    return np.arange(C * Tp * Fp).reshape(C, Tp, Fp).transpose(1, 2, 0).reshape(-1)


def _nchw_to_fold_perm(cfg: ConvSepConfig) -> np.ndarray:
    """The same for the decode side's w-major fold order (F', T', N2)."""
    Tp, Fp, C = cfg.enc_time, cfg.enc_freq, cfg.conv2_filters
    return np.arange(C * Tp * Fp).reshape(C, Tp, Fp).transpose(2, 1, 0).reshape(-1)


def _check(arr: np.ndarray, shape: tuple[int, ...], what: str) -> np.ndarray:
    if tuple(arr.shape) != shape:
        raise ValueError(
            f"reference param {what!r} has shape {tuple(arr.shape)}, expected {shape} "
            f"— architecture hyperparameters in ConvSepConfig likely need adjusting"
        )
    return arr


def convert_reference_params(
    values: list[np.ndarray], cfg: ConvSepConfig, layout: Layout = Layout()
) -> dict[str, torch.Tensor]:
    """Ordered reference arrays → the flat float32 parameter dict (CPU)."""
    _check_order(cfg)
    S = cfg.num_sources
    expected = 6 + 2 * S + (1 if layout.merge_bias else 0)
    if len(values) != expected:
        raise ValueError(
            f"reference pickle has {len(values)} arrays, expected {expected} for "
            f"{S} sources (layout {layout})"
        )
    it = iter(values)

    def conv_bias(arr, n, what):
        if layout.conv_bias_chw:
            return _check(arr, (n, 1, 1), what).reshape(n)
        return _check(arr, (n,), what)

    w1 = _check(next(it), (cfg.conv1_filters, cfg.channels_in, 1, cfg.conv1_freq), "conv1.W")
    b1 = conv_bias(next(it), cfg.conv1_filters, "conv1.b")
    w2 = _check(next(it), (cfg.conv2_filters, cfg.conv1_filters, cfg.conv2_time_eff, 1),
                "conv2.W")
    b2 = conv_bias(next(it), cfg.conv2_filters, "conv2.b")
    fc_w = _check(next(it), (cfg.enc_flat, cfg.bottleneck), "fc.W")[_nchw_to_nhwc_perm(cfg), :]
    fc_b = _check(next(it), (cfg.bottleneck,), "fc.b")
    exp_ws, exp_bs = [], []
    if layout.expand_interleaved:
        for s in range(S):
            exp_ws.append(_check(next(it), (cfg.bottleneck, cfg.enc_flat), f"expand{s}.W"))
            exp_bs.append(_check(next(it), (cfg.enc_flat,), f"expand{s}.b"))
    else:  # all weights, then all biases
        for s in range(S):
            exp_ws.append(_check(next(it), (cfg.bottleneck, cfg.enc_flat), f"expand{s}.W"))
        for s in range(S):
            exp_bs.append(_check(next(it), (cfg.enc_flat,), f"expand{s}.b"))
    fold_perm = _nchw_to_fold_perm(cfg)
    exp_ws = [w[:, fold_perm] for w in exp_ws]
    exp_bs = [b[fold_perm] for b in exp_bs]
    out_bias = (_check(next(it), (S,), "merge.b") if layout.merge_bias
                else np.zeros((S,), np.float32))

    def conv_kernel(w):  # OIHW true convolution → HWIO cross-correlation
        if layout.flip_kernels:
            w = w[:, :, ::-1, ::-1]
        return w.transpose(2, 3, 1, 0)

    arrays = {
        "conv1_kernel": conv_kernel(w1),
        "conv1_bias": b1,
        "conv2_kernel": conv_kernel(w2),
        "conv2_bias": b2,
        "fc_kernel": fc_w,
        "fc_bias": fc_b,
        "fc_expand_kernel": np.concatenate(exp_ws, axis=1),
        "fc_expand_bias": np.concatenate(exp_bs),
        "out_bias": out_bias,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(a, np.float32)) for k, a in arrays.items()}


def export_reference_params(
    params: dict[str, torch.Tensor], cfg: ConvSepConfig, layout: Layout = Layout()
) -> list[np.ndarray]:
    """Inverse of :func:`convert_reference_params`: the flat parameter
    dict (tensors on any device, or arrays) → the reference's ordered
    list of numpy arrays."""
    _check_order(cfg)
    p = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
         for k, v in params.items()}
    perm = _nchw_to_nhwc_perm(cfg)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    fold_perm = _nchw_to_fold_perm(cfg)
    fold_inv = np.empty_like(fold_perm)
    fold_inv[fold_perm] = np.arange(fold_perm.size)

    def conv_kernel(k):  # HWIO → OIHW (+ the spatial flip of the layout)
        k = k.transpose(3, 2, 0, 1)
        if layout.flip_kernels:
            k = k[:, :, ::-1, ::-1]
        return np.ascontiguousarray(k)

    def conv_bias(b):
        return b.reshape(-1, 1, 1) if layout.conv_bias_chw else b

    out = [
        conv_kernel(p["conv1_kernel"]),
        conv_bias(p["conv1_bias"]),
        conv_kernel(p["conv2_kernel"]),
        conv_bias(p["conv2_bias"]),
        p["fc_kernel"][inv, :],
        p["fc_bias"],
    ]
    S = cfg.num_sources
    ew = p["fc_expand_kernel"].reshape(cfg.bottleneck, S, cfg.enc_flat)
    eb = p["fc_expand_bias"].reshape(S, cfg.enc_flat)
    ws = [np.ascontiguousarray(ew[:, s, fold_inv]) for s in range(S)]
    bs = [np.ascontiguousarray(eb[s, fold_inv]) for s in range(S)]
    if layout.expand_interleaved:
        for w, b in zip(ws, bs):
            out.extend([w, b])
    else:
        out.extend(ws)
        out.extend(bs)
    if layout.merge_bias:
        out.append(p["out_bias"])
    return out


def detect_layout(values: list[np.ndarray], cfg: ConvSepConfig) -> Layout:
    """The :class:`Layout` variant whose shapes fit the pickle: merge bias
    present or not × expansion order × conv bias shape. ``flip_kernels``
    cannot be seen from shapes and stays True (Theano's default); the
    default layout wins where several fit (e.g. one source)."""
    fits, errors = [], []
    for merge in (True, False):
        for interleaved in (True, False):
            for chw in (False, True):
                layout = Layout(merge_bias=merge, expand_interleaved=interleaved,
                                conv_bias_chw=chw)
                try:
                    convert_reference_params(values, cfg, layout)
                except ValueError as e:
                    errors.append(f"{layout}: {e}")
                    continue
                fits.append(layout)
    if not fits:
        details = "\n  ".join(errors[:4])
        raise ValueError(
            f"no known reference layout fits this pickle "
            f"({len(values)} arrays, shapes {[tuple(v.shape) for v in values[:8]]}...).\n"
            f"First failures:\n  {details}"
        )
    return Layout() if Layout() in fits else fits[0]


def convert_reference_checkpoint(
    pickle_path: str,
    cfg: ConvSepConfig,
    layout: Layout | None = None,
    allow_unsafe: bool = False,
) -> dict[str, torch.Tensor]:
    """Load and convert a reference checkpoint file; ``layout=None``
    detects the layout from the arrays' count and shapes."""
    values = load_reference_pickle(pickle_path, allow_unsafe=allow_unsafe)
    if layout is None:
        layout = detect_layout(values, cfg)
    return convert_reference_params(values, cfg, layout)
