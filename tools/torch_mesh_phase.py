#!/usr/bin/env python3
"""The distributed paths on one CUDA GPU (no JAX): smoke phase 27 alone,
then the CLI's mesh training under ``torchrun``.

    python3 tools/torch_mesh_phase.py [--cli-only]

1. ``chip_smoke.phase_distributed`` on the 30 s mixture, after the
   kernels' build: ``ShardedSeparator`` at highres4096 against
   ``Separator``, ``StreamSeparator(mesh=)`` against the same without a
   mesh, ``Trainer(mesh=)`` at dsd100 B 32 on the kernel route in grain's
   order, stopped and resumed, and its step with and without the mesh.
   Prints the phase's lines, its numbers and each path's launches as JSON.
2. ``torchrun --nproc_per_node=1 -m convsep_tpu_torch --launches train
   --mesh-data 1 --grain --optimizer-impl fused`` for one epoch on the
   smoke's synthetic dsd100 tracks; prints its exit code, time and output.

Run it from the root of the checkout. Exits with the CLI's exit code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cli-only", action="store_true", help="skip phase 27")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.configs import get_preset

    if cs.setup():
        return 1
    cs.CARD = cs.smi_line()
    print(f"{cs.CARD} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if not args.cli_only:
        t0 = time.perf_counter()
        kernels.build(verbose=False)
        kernels.library()
        print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        out = cs.phase_distributed(torch.device("cuda", 0), cs.mixture(0))
        print(f"phase 27 took {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({k: {f: v for f, v in r.items() if f != "launches"}
                          for k, r in out.items()}))
        print(json.dumps({k: {n: c for n, c in r["launches"].items() if c}
                          for k, r in out.items()}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "tracks")
        cs.write_tracks(root, get_preset("dsd100").sources)
        t0 = time.perf_counter()
        r = subprocess.run(
            ["torchrun", "--nproc_per_node=1", "-m", "convsep_tpu_torch", "--launches",
             "train", "--mesh-data", "1", "--preset", "dsd100", "--features", root,
             "--from-audio", "--workdir", os.path.join(tmp, "run"), "--grain",
             "--epochs", "1", "--optimizer-impl", "fused"],
            capture_output=True, text=True, timeout=600)
        print(f"torchrun rc {r.returncode} in {time.perf_counter() - t0:.1f} s")
        print(r.stdout[-1500:])
        print(r.stderr[-2500:])
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
