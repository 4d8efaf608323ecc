"""Write ``convsep_tpu_torch/csrc/wgmma_bf16.cuh``: ``Wgmma<N>::mma``, one
``wgmma.mma_async`` m64nNk16 f32 += bf16 × bf16 with A and B from shared
memory, for every width N = 8, 16, …, 256 the instruction takes.

The instruction names its N/2 accumulator registers one by one, so each
width is its own inline-asm statement; this script writes them all.

    python3 tools/gen_wgmma_header.py
"""

from __future__ import annotations

from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "convsep_tpu_torch" / "csrc" / "wgmma_bf16.cuh"

HEAD = """\
// wgmma m64nNk16, f32 += bf16 x bf16, A and B from shared memory through
// matrix descriptors (K-major, no transpose), for N = 8, 16, ..., 256.
// scale_d 0 starts the accumulators from zero. d[4 j + v]: column group j,
// (row, column) = (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1) of the
// warp's 16 rows (g = lane / 4, q = lane % 4).
//
// Written by tools/gen_wgmma_header.py: each width names its N / 2
// accumulator registers one by one.
#pragma once

#include <stdint.h>

template <int N>
struct Wgmma;
"""


def variant(n: int) -> str:
    regs = n // 2
    dlist = ", ".join(f"%{i}" for i in range(regs))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return f"""
template <>
struct Wgmma<{n}> {{
  __device__ __forceinline__ static void mma(float (&d)[{regs}], uint64_t a, uint64_t b,
                                             int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{dlist}}}, %{regs}, %{regs + 1}, p, 1, 1, 0, 0;\\n}}\\n"
        : {outs}
        : "l"(a), "l"(b), "r"(scale_d));
  }}
}};
"""


def main() -> None:
    OUT.write_text(HEAD + "".join(variant(n) for n in range(8, 257, 8)))
    print(OUT)


if __name__ == "__main__":
    main()
