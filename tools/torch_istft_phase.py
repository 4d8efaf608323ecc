#!/usr/bin/env python3
"""The iSTFT kernels on one CUDA GPU (no JAX): smoke phase 7 alone.

    python3 tools/torch_istft_phase.py

Builds the kernels (ptxas's registers and stack frames of the iSTFT cluster
kernels printed), then runs ``chip_smoke.phase_istft`` on its
``ISTFT_SHAPES``: each kernel against its plain version and, past 8192,
the float64 synthesis; card ms,
device ms in a profiler child, ``torch.istft`` beside it; at the powers of
two past 8192 the direct transform against Bluestein's cluster forced.
Prints the phase's lines and its numbers as one JSON line. Run it from the
root of the checkout.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys
import time

sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch

    import chip_smoke as cs
    from convsep_tpu_torch import kernels

    if cs.setup():
        return 1
    cs.CARD = cs.smi_line()
    print(f"{cs.CARD} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):  # nvcc's ptxas lines
        lib = kernels.build(verbose=True)
    kernels.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for m in re.finditer(r"Function properties for (\S*istft_cluster\S*)\n\s+(\d+) bytes stack "
                         r"frame.*\n.*Used (\d+) registers", buf.getvalue()):
        print(f"ptxas {m[1]}: {m[2]} bytes stack, {m[3]} registers")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    res = cs.phase_istft(torch.device("cuda", 0), torch.Generator(device="cuda").manual_seed(0))
    print(f"phase 7 took {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(res, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
