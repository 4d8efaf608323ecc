"""The package's float32 contract: products and convolutions in full float32.

PyTorch runs a float32 matrix product in full float32 by default, but a
float32 convolution goes through cuDNN in TF32 (about three decimal digits)
unless ``torch.backends.cudnn.allow_tf32`` is False, and a caller may lower
the matmul precision with ``torch.set_float32_matmul_precision`` (on a CPU
with bf16 matrix units "medium" runs float32 products in bf16). The
reference computes in float32 (its parity bounds are 1e-5), so the
training, separation and public DSP entry points run inside
:class:`float32_exact`, which turns both off for the call and gives the
caller's settings back afterwards.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0                    # float32_exact scopes open, in all threads
_saved: tuple | None = None   # the flags before the outermost one opened


class float32_exact(contextlib.ContextDecorator):
    """Context (or decorator) in which cuDNN convolutions run without TF32
    and float32 matmuls at "highest" precision; when the last open scope
    exits, the caller's ``cudnn.allow_tf32`` and float32 matmul precision
    are restored, also when the body raises.

    The two flags are process-wide, so the scopes are counted process-wide:
    the outermost scope saves the caller's flags and only the last one to
    exit restores them, whichever thread opened it. Scopes that overlap in
    time from different threads then leave the flags as the caller set
    them, which a save and restore per scope does not (a scope that opens
    while another thread's is lowered and exits after it would restore the
    lowered flags for good)."""

    def __enter__(self):
        global _depth, _saved
        with _lock:
            if _depth == 0:
                _saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
            _depth += 1
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        global _depth, _saved
        with _lock:
            _depth -= 1
            if _depth == 0:
                cudnn_tf32, matmul = _saved
                _saved = None
                torch.backends.cudnn.allow_tf32 = cudnn_tf32
                torch.set_float32_matmul_precision(matmul)
        return False
