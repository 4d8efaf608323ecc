"""Fused ConvSep decode: the CUDA kernel's wrapper and plain version.

Replaces ``convsep_tpu/models/decoder_fused_pallas.py::band_freq_decode_pallas``.
Per fc row b, source s and expansion row w the decode is

    e = relu(fc[b] @ K4[:, s, w] + bias[s, w])      # (TpC,)
    out[b, s, w + i] += e @ Kcat[:, i]               # tap i < ktaps

with Kcat the tap-reversed composed band/freq decode matrix. The kernel
(``csrc/decoder_fused.cu``) keeps ``e`` (about 1.3 GB per highres4096
batch) out of device memory and runs both products on the tensor cores as
3xTF32 (float32 operands split into a TF32 part and a TF32 remainder, three
products summed in float32), which keeps float32 parity: the expansion by
``mma.sync``, the fold by ``wgmma``. The blocks that hold a w block's
column tiles form a thread-block cluster and share the expansion through
distributed shared memory. Its header says what bounds it on the H100;
:func:`decode_plan` mirrors its launch and :func:`card_plan` reads it.

The plain version materializes ``e`` and the per-tap products and folds
them with shifted adds. It is also this package's ``bandconv`` decode: the
reference's bandconv chain is the same linear map written as a conv.

:func:`band_freq_decode` takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from convsep_tpu_torch import kernels

_WPAD = 8  # expansion rows are padded to a multiple of this (as the reference)
_SMEM_MAX = 227 * 1024

# Where the kernel beat band_freq_decode_plain on the card, by the model's
# compute dtype: for each TM (output columns T·stride·C) the runs (first,
# last) of fc rows B (segments in one call) at which "auto" routes the fused
# decode (models/convsep.py::resolve_decoder_impl). Every B in a run was
# timed and won: tools/torch_decode_batches.py timed every B from 1 to 64
# and its ``BEYOND`` batches, kernel and plain in turns, and a B won when
# both kernel times were below both plain times (bf16 out, by events; H100
# 80GB HBM3, 700 W; PERF.md, row 2, names the run). An untimed B takes the
# plain decode. kernel / plain swings with B mod 4 to 8 (the kernel pads fc
# rows to a multiple of 4, cuBLAS picks its tiles by B): at TM 120 B 8 1.82,
# 32 0.84, 33 1.09, 49 0.97, 56 1.03, 64 0.92; past one 64-row tile the
# launcher pads every tile to 64 rows (B 65 1.59, 98 1.13 at TM 120).
# chip_smoke.py fails where a routed (TM, B) loses by more than the
# run-to-run spread. The sweep ran the float32 model. Under
# compute_dtype="bfloat16" the plain decode runs bf16 GEMMs and the kernel
# still does 3xTF32 work on the bf16 operands: it lost its one timed A/B
# (highres4096 B 49, 5.956 ms against 1.410; PERF.md), so no bf16 batch is
# routed until a kernel wins one.
FUSED_DECODE_WON = {
    "float32": {
        120: ((20, 20), (29, 32), (38, 40), (47, 49), (51, 52), (58, 64), (128, 128)),
        240: ((14, 16), (19, 20), (29, 36), (40, 40), (43, 52), (54, 56), (59, 64),
              (112, 112), (128, 128)),
        360: ((13, 20), (22, 24), (26, 64), (98, 98), (112, 112), (128, 128), (196, 196)),
    },
    "bfloat16": {},
}

# the kernel's tile (csrc/decoder_fused.cu)
BT = 64              # fc rows per row tile, at most
TC = 8               # t per chunk: one TF32 k-step
MAX_CLUSTER = 8      # blocks per cluster (the portable limit)
# (row tile, split Kcat buffers, K4 buffers) in the order the launcher tries
# them (``make_plan``): it takes the first whose most expansion rows a block
# keep stage 1's halo at or under 2, else the one with the least halo
PLAN_OPTIONS = ((64, 2, 2), (64, 1, 2), (64, 1, 1), (32, 1, 2), (32, 1, 1), (16, 1, 1),
                (8, 1, 1))


def fused_decode_won(TM: int, B: int, compute_dtype: str = "float32") -> bool:
    """Whether the kernel won its A/B against the plain decode at TM
    columns and B fc rows for a model of ``compute_dtype``: B lies in one
    of the TM's runs of won batches (``FUSED_DECODE_WON[compute_dtype]``)."""
    runs = FUSED_DECODE_WON[compute_dtype].get(TM, ())
    return any(lo <= B <= hi for lo, hi in runs)


def w_pad_rows(W: int, ktaps: int) -> int:
    """Expansion rows padded so every output row the full conv reaches
    (W + ktaps - 1) exists and w blocks tile exactly (as the reference)."""
    return -(-(W + ktaps - 1) // _WPAD) * _WPAD


def fused_decode_supported(TpC: int, TM: int, ktaps: int) -> bool:
    """The reference's routing rule for ``decoder_impl="auto"``
    (``decoder_fused_pallas.fused_decode_supported``): TPU lane padding of
    TM to 128 must waste at most 25 %. Kept so "auto" routes the same
    shapes as the TPU did (highres/multires geometry, not dsd100);
    widening it needs an A/B on the card."""
    if not (ktaps - 1 <= 16 and TpC % 8 == 0 and 90 <= TM <= 384):
        return False
    return (-(-TM // 128) * 128) / TM <= 1.25


def block_tile(TM: int) -> tuple[int, int, int, int]:
    """(MI, NI, C, W): a block of W warps, each holding MI m16 tiles of output
    rows, takes NI column groups of 8, and the C blocks of one cluster cover
    TM. 16 warps of 3 × 4 tiles (32 columns, 48 accumulators a thread) while
    that takes at most 8 blocks (TM ≤ 256), else 12 warps of 4 × 6 (48
    columns, 96 accumulators: 12 warps leave 168 registers a thread)."""
    if TM <= 256:
        return 3, 4, -(-TM // 32), 16
    return 4, 6, -(-TM // 48), 12


def smem_bytes(J: int, ktaps: int, MI: int, NI: int, W: int, FS: int, RC: int, ES: int,
               kc_bufs: int = 2, k4_bufs: int = 2) -> int:
    """Dynamic shared memory of a block (the launcher's ``plan_smem``): the
    split Kcat tiles in wgmma's layout (``kc_bufs`` buffers × hi, lo × ktaps
    × 8 t × 8 NI), fc (J × FS, J padded to 8), the K4 rows of its share of
    stage 1 (``k4_bufs`` × RC × J × 8 t), e (2 × 8 t × ES) and 16 W MI floats
    of room after it (the dropped tiles past a block's rows read there), the
    Kcat tile as copied (ktaps × 8 t × (8 NI + 8)) and four 8-byte
    mbarriers."""
    return 4 * (2 * kc_bufs * ktaps * 64 * NI + J * FS + k4_bufs * RC * J * TC + 2 * TC * ES
                + 16 * W * MI + ktaps * TC * (8 * NI + 8)) + 32


@dataclass(frozen=True)
class DecodePlan:
    warps: int           # warps a block
    mi: int              # m16 tiles of output rows per warp
    ni: int              # column groups of 8 per block
    cluster: int         # blocks per cluster: the column tiles, sharing stage 1
    b_tiles: int         # fc row tiles of ``bt``
    bp: int              # fc rows of a tile padded to a multiple of 4
    wb: int              # output rows w per block
    rows_e: int          # expansion rows per w block: wb + ktaps − 1
    rc: int              # of which each block of the cluster computes at most rc
    es: int              # shared stride of a t row of e
    w_blocks: int
    clusters: int
    blocks: int
    smem_bytes: int
    halo: float          # expansion rows computed per output row: rows_e / wb
    stage1_recompute: float  # stage 1's work over the expansion's (column tiles share it)
    k4_reads: float      # K4 reads from device memory over its size: b_tiles × halo
    row_padding: float   # stage 2's fc rows over the real ones: bp / min(B, bt)
    bt: int = BT         # fc rows a row tile holds, at most (64, 32, 16 or 8)
    kc_bufs: int = 2     # buffers of the split Kcat tiles (1: split after stage 2)
    k4_bufs: int = 2     # buffers of the K4 rows (1: copied after stage 1 read them)
    j_pad: int = 0       # fc's columns padded with zeros to the mma depth 8


def _fit_rows(B: int, J: int, W_pad: int, ktaps: int, MI: int, NI: int, C: int, W: int,
              bt: int = BT, kc_bufs: int = 2, k4_bufs: int = 2):
    """(BP, WB, RC, ES, smem) as the launcher's ``fit_rows``: the most
    expansion rows a block takes (16 W MI output rows at most) that shared
    memory holds for a row tile of ``bt`` fc rows, or None."""
    BP = -(-min(B, bt) // 4) * 4
    FS = -(-BP // 8) * 8   # fc's row stride: 8 or 24 mod 32 (conflict-free fragment reads)
    FS += 8 if FS % 16 == 0 else 0
    for WB in range(min(W * MI * 16 // BP, W_pad), 0, -1):
        R = WB + ktaps - 1
        RC = -(-R // C)
        ES = -(-(R * BP + 16) // 16) * 16 + 8   # 8 or 24 mod 32: conflict-free fragment reads
        smem = smem_bytes(J, ktaps, MI, NI, W, FS, RC, ES, kc_bufs, k4_bufs)
        if smem <= _SMEM_MAX:
            return BP, WB, RC, ES, smem
    return None


def _plan_rows(B: int, J: int, W_pad: int, ktaps: int, MI: int, NI: int, C: int, W: int):
    """((bt, kc_bufs, k4_bufs), (BP, WB, RC, ES, smem)) as the launcher's
    ``make_plan``: the first of :data:`PLAN_OPTIONS` whose rows keep the halo
    (WB + ktaps − 1) / WB at or under 2, else the one with the least halo
    (the earliest of equals); None if none fits. J is padded to 8."""
    J = -(-J // 8) * 8
    best = None
    for opt in PLAN_OPTIONS:
        rows = _fit_rows(B, J, W_pad, ktaps, MI, NI, C, W, *opt)
        if rows is None:
            continue
        if rows[1] >= ktaps - 1:
            return opt, rows
        if best is None or rows[1] > best[1][1]:
            best = (opt, rows)
    return best


def kernel_supported(J: int, ktaps: int, TM: int) -> bool:
    """The CUDA kernel's own envelope: any J (the wrapper pads fc with zero
    columns and K4 with zero rows to the mma depth 8, a copy of K4 a call
    where J is not a multiple of 8), TM within 8 blocks of 48 columns
    (384), and a plan whose
    shared memory fits a block's 227 KB for a full row tile (past the
    double-buffered 64-row tile the launcher single-buffers the split Kcat
    tiles and the K4 rows and takes 32, 16 or 8 fc rows a tile): every
    shape :func:`fused_decode_supported` admits (ktaps ≤ 17, TM 90–384) up
    to J 512 and past it."""
    if not (J >= 1 and ktaps >= 1 and 1 <= TM <= MAX_CLUSTER * 48):
        return False
    MI, NI, C, W = block_tile(TM)
    return _plan_rows(BT, J, 1, ktaps, MI, NI, C, W) is not None


def decode_plan(B: int, J: int, S: int, W_pad: int, TpC: int, ktaps: int, TM: int) -> DecodePlan:
    """The kernel's launch for a shape, as the C launcher makes it
    (``fused_decode_plan`` reads the card's), with what it costs: K4 comes
    from device memory once per cluster, ``k4_reads`` times in all, and
    stage 1 is computed ``stage1_recompute`` times."""
    if not kernel_supported(J, ktaps, TM):
        raise ValueError(f"fused decode kernel unsupported for J={J} ktaps={ktaps} TM={TM}")
    mi, ni, C, W = block_tile(TM)
    (bt, kc, k4), (BP, WB, RC, ES, smem) = _plan_rows(B, J, W_pad, ktaps, mi, ni, C, W)
    tiles = -(-B // bt)
    wb = -(-W_pad // WB)
    halo = (WB + ktaps - 1) / WB
    return DecodePlan(W, mi, ni, C, tiles, BP, WB, WB + ktaps - 1, RC, ES, wb, tiles * wb * S,
                      C * tiles * wb * S, smem, halo, halo, tiles * halo, BP / min(B, bt),
                      bt, kc, k4, -(-J // 8) * 8)


def card_plan(B: int, J: int, S: int, W_pad: int, TpC: int, ktaps: int, TM: int) -> dict:
    """The launcher's own plan for a shape and how many of its clusters the
    card runs at once (``cudaOccupancyMaxActiveClusters``); needs the card."""
    import ctypes

    info = (ctypes.c_int * 12)()
    code = kernels.library().fused_decode_plan(B, -(-J // 8) * 8, S, W_pad, TpC, ktaps, TM,
                                               info)
    kernels.check(code, "fused_decode_plan")
    keys = ("mi", "ni", "cluster", "bp", "wb", "rc", "es", "smem_bytes", "active_clusters",
            "bt", "kc_bufs", "k4_bufs")
    return dict(zip(keys, list(info)))


def kcat_of(KC: torch.Tensor) -> torch.Tensor:
    """Composed decode KC (ktaps, 1, TpC, TM) → Kcat (TpC, ktaps, TM), column
    block i holding conv tap ktaps - 1 - i."""
    return KC[:, 0].flip(0).permute(1, 0, 2)


def tap_fold(e: torch.Tensor, kcat: torch.Tensor) -> torch.Tensor:
    """The composed decode as a full conv along W: e (N, W, TpC) →
    (N, W + ktaps - 1, TM), ``out[w + i] += e[w] @ kcat[:, i]``, one GEMM
    for all taps and shifted adds. Differentiable in both operands."""
    N, W, TpC = e.shape
    _, ktaps, TM = kcat.shape
    g = (e.reshape(N * W, TpC) @ kcat.reshape(TpC, ktaps * TM)).reshape(N, W, ktaps, TM)
    out = e.new_zeros((N, W + ktaps - 1, TM))
    for i in range(ktaps):
        out[:, i:i + W] += g[:, :, i]
    return out


def prepare_operands(kernel: torch.Tensor, bias: torch.Tensor, KC: torch.Tensor,
                     S: int, W: int, TpC: int):
    """Raw fc_expand params ((J, S·W·TpC), (S·W·TpC,)) and the composed
    decode KC (ktaps, 1, TpC, TM) → the decode's operands:
    k4 (J, S, W_pad, TpC), b3 (S, W_pad, TpC), kcat (TpC, ktaps, TM) with
    column block i holding tap ktaps - 1 - i. Padded rows are zeros."""
    J = kernel.shape[0]
    ktaps = KC.shape[0]
    W_pad = w_pad_rows(W, ktaps)
    k4 = torch.nn.functional.pad(kernel.float().reshape(J, S, W, TpC), (0, 0, 0, W_pad - W))
    b3 = torch.nn.functional.pad(bias.float().reshape(S, W, TpC), (0, 0, 0, W_pad - W))
    return k4.contiguous(), b3.contiguous(), kcat_of(KC.float()).contiguous()


def band_freq_decode_plain(fc: torch.Tensor, k4: torch.Tensor, b3: torch.Tensor,
                           kcat: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """fc (B, J) → decode output (B, S, W_pad, TM) in ``out_dtype``: the
    full conv's rows past W_pad are dropped (the padded rows cover every
    row the real ones reach). The products run in the operands' dtype
    (float32, or bfloat16 for ``compute_dtype="bfloat16"``)."""
    B, J = fc.shape
    _, S, W_pad, TpC = k4.shape
    e = torch.relu(fc.to(k4.dtype) @ k4.reshape(J, -1) + b3.reshape(-1))
    out = tap_fold(e.reshape(B * S, W_pad, TpC), kcat)[:, :W_pad]
    return out.reshape(B, S, W_pad, kcat.shape[2]).to(out_dtype)


def band_freq_decode(fc: torch.Tensor, k4: torch.Tensor, b3: torch.Tensor,
                     kcat: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """The fused decode: plain version on CPU tensors, the CUDA kernel on
    CUDA tensors (raises outside its envelope)."""
    B, J = fc.shape
    if k4.dim() != 4 or k4.shape[0] != J or kcat.dim() != 3 or kcat.shape[0] != k4.shape[3]:
        raise ValueError(
            f"band_freq_decode: fc {tuple(fc.shape)}, k4 {tuple(k4.shape)}, "
            f"kcat {tuple(kcat.shape)} do not align"
        )
    _, S, W_pad, TpC = k4.shape
    _, ktaps, TM = kcat.shape
    if b3.shape != (S, W_pad, TpC):
        raise ValueError(f"bias {tuple(b3.shape)} != {(S, W_pad, TpC)}")
    devices = {t.device.type for t in (fc, k4, b3, kcat)}
    if devices == {"cpu"}:
        return band_freq_decode_plain(fc, k4, b3, kcat, out_dtype)
    if devices != {"cuda"} or len({t.device for t in (fc, k4, b3, kcat)}) != 1:
        raise ValueError(f"band_freq_decode: tensors on mixed devices {devices}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if any(t.dtype != torch.float32 for t in (fc, k4, b3, kcat)):
        raise ValueError("band_freq_decode kernel takes float32 operands")
    if not kernel_supported(J, ktaps, TM):
        raise ValueError(f"band_freq_decode kernel unsupported for J={J} ktaps={ktaps} TM={TM}")
    fc = fc.contiguous()
    k4, b3, kcat = k4.contiguous(), b3.contiguous(), kcat.contiguous()
    if J % 8:  # the mma's depth: zero columns of fc against zero rows of K4 (exact)
        pad = -J % 8
        fc = torch.nn.functional.pad(fc, (0, pad))
        k4 = torch.nn.functional.pad(k4, (0, 0, 0, 0, 0, 0, 0, pad))
        J += pad
    out = torch.empty((B, S, W_pad, TM), dtype=out_dtype, device=fc.device)
    lib = kernels.library()
    with kernels.on_device(fc.device):
        stream = torch.cuda.current_stream(fc.device).cuda_stream
        code = lib.fused_decode_launch(
            fc.data_ptr(), k4.data_ptr(), b3.data_ptr(), kcat.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), B, J, S, W_pad,
            TpC, ktaps, TM, stream,
        )
    kernels.check(code, "fused_decode")
    kernels.LAUNCHES["fused_decode"] += 1
    return out

