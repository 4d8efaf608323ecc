"""The package's float32 contract: products and convolutions in full float32.

PyTorch runs a float32 matrix product in full float32 by default, but a
float32 convolution goes through cuDNN in TF32 (about three decimal digits)
unless ``torch.backends.cudnn.allow_tf32`` is False, and a caller may lower
the matmul precision with ``torch.set_float32_matmul_precision``. The
reference computes in float32 (its parity bounds are 1e-5), so the training
and separation entry points run inside :class:`float32_exact`, which turns
both off for the call and gives the caller's settings back afterwards.
"""

from __future__ import annotations

import contextlib

import torch


class float32_exact(contextlib.ContextDecorator):
    """Context (or decorator) in which cuDNN convolutions run without TF32
    and float32 matmuls at "highest" precision; on exit the caller's
    ``cudnn.allow_tf32`` and float32 matmul precision are restored, also
    when the body raises. As a decorator every call gets its own instance,
    so nested and recursive uses restore in turn."""

    def _recreate_cm(self):
        return type(self)()

    def __enter__(self):
        self._saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        cudnn_tf32, matmul = self._saved
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(matmul)
        return False
