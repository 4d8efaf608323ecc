"""Banded time-stage decode: the CUDA kernel's wrappers and plain version.

Replaces ``convsep_tpu/models/decoder_pallas.py::band_decode_pallas``. The
tied decoder's time stage is, per expansion row (n, w),

    out[n, w, (t, i)] = Σ_{h, c} z[n, w, h, c] · band[h, c, (t, i)]

with ``band`` the banded tap tensor of the time kernel
(:func:`band_tensor`): ``band[h, c, (t, i)] = kernel[t − h, 0, i, c]``
inside the band, 0 outside. As in the reference, z and the band are rounded
to bfloat16 and the products summed in float32 (the reference's
XLA-default GEMM precision, kept by its kernel); a float32 decode would not
match it. Two kernels read z in the expansion's own w-major layout (N, W,
Tp·C2) and, in place of the band, its kh taps packed once per weight
tensor (:func:`band_operand`):

* ``csrc/band_decode.cu`` keeps the taps (:func:`pack_taps`) and a 64-row
  tile of z in shared memory, where they fit at once (every preset);
  :func:`band_plan` mirrors its launcher;
* ``csrc/band_stream.cu`` (on ``band_stream.cuh``) streams slabs of z and
  of the taps (:func:`pack_stream_taps`) through a ring in shared memory,
  so it takes any band in one launch; it serves the bands past the first
  kernel's shared memory and the shapes in ``BAND_STREAM_WON``;
  :func:`band_stream_plan` mirrors its launcher.

Their headers say what bounds them on the H100. :func:`band_decode_wmajor`
takes the plain version only for CPU tensors; for CUDA tensors it launches
a kernel or raises. For A/Bs, ``band_decode_stream_pallas`` forces the
streamed kernel, ``band_decode_resident_pallas`` the first one where the
band fits, and ``band_decode_pieces_pallas`` the pieces that served the
large bands before the streamed kernel (one launch a piece of
``csrc/band_decode.cu``, added into a zeroed output).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from math import gcd

import torch

from convsep_tpu_torch import kernels

ROWS = 64                 # rows of a tile (csrc/band_decode.cu: kRows)
THREADS = 256             # two consumer warpgroups
SMEM_MAX = 232_448        # dynamic shared memory a block may use
SM_SMEM = 228 * 1024      # shared memory of one SM
BLOCK_RESERVED = 1024     # shared memory the runtime keeps per resident block
QUADS = 25                # register path: quads of 16-byte chunks a lane holds (kQuads)
# the streamed kernel (csrc/band_stream.cuh)
STREAM_ROWS = 128         # rows of a tile: two consumer warpgroups (kTileRows)
STREAM_CLUSTER = 2        # blocks of a cluster, each one of a pair of row tiles (kCluster)
STREAM_SLAB = 64          # depths of a stage (kSlab)
STREAM_STAGES = 4         # the ring (kStages)
STREAM_STAGING = 8 * 8 * 88 * 4  # the consumer warps' staging rows (kStagingBytes)
STREAM_FOLD = 64          # a deep band's units restart every 64 slabs into float32 sums (kFold)
# (Tp, C2, kh, I) whose band fits band_decode.cu's shared memory but where
# the streamed kernel won the timed A/B against it (chip_smoke.py phase 11b:
# at I 100 band_decode.cu runs products 8 columns wide; at N 196, W 505 the
# streamed kernel took 0.66 ms against 3.57 on an H100 80GB HBM3 at 700 W)
BAND_STREAM_WON: frozenset = frozenset({(16, 32, 15, 100)})


def band_tensor(kernel: torch.Tensor, time_context: int) -> torch.Tensor:
    """(kh, 1, I, O) tied kernel → (Tp, O, T·I) banded taps:
    ``band[h, o, H·I + i] = kernel[H − h, 0, i, o]`` for 0 <= H − h < kh,
    else 0."""
    kh, kw, I, O = kernel.shape
    if kw != 1:
        raise ValueError(f"band decode expects a (kh, 1, I, O) kernel, got {tuple(kernel.shape)}")
    T = time_context
    Tp = T - kh + 1
    delta = torch.arange(T)[None, :] - torch.arange(Tp)[:, None]  # (Tp, T)
    valid = ((delta >= 0) & (delta < kh)).to(kernel.device)
    taps = kernel[:, 0].permute(0, 2, 1)  # (kh, O, I)
    band = taps[delta.clamp(0, kh - 1).to(kernel.device)] * valid[:, :, None, None].to(kernel.dtype)
    return band.permute(0, 2, 1, 3).reshape(Tp, O, T * I)


def taps_of_band(band: torch.Tensor, time_context: int) -> torch.Tensor:
    """(Tp, C2, T·I) band → its (kh, C2, I) taps: ``taps[d, c, i] =
    band[0, c, d·I + i]`` (tap d at h = 0, t = d)."""
    Tp, C2, TI = band.shape
    I = TI // time_context
    kh = time_context - Tp + 1
    return band[0, :, : kh * I].reshape(C2, kh, I).permute(1, 0, 2)


def pack_taps(taps: torch.Tensor) -> torch.Tensor:
    """(kh, C2, I) taps → the kernel's bf16 operand: rows ρ = (kh − 1 − d)·C2p
    + c (C2p = C2 rounded up to 8; 8 zero rows after tap 0), columns i < Ip
    (I rounded up to 8), in wgmma's K-major core matrices: element (ρ, i) at
    (ρ // 8)·8·Ip + (i // 8)·64 + (i % 8)·8 + ρ % 8. Column block t then
    reads taps t − h_lo .. t − h_hi as one run of rows."""
    kh, C2, I = taps.shape
    c2p, ip = -(-C2 // 8) * 8, -(-I // 8) * 8
    dense = torch.zeros(kh, c2p, ip, dtype=torch.float32, device=taps.device)
    dense[:, :C2, :I] = taps.float()
    dense = torch.cat([dense.flip(0).reshape(kh * c2p, ip),
                       torch.zeros(8, ip, device=taps.device)])
    rows = dense.shape[0]
    return (dense.reshape(rows // 8, 8, ip // 8, 8).permute(0, 2, 3, 1).reshape(-1)
            .to(torch.bfloat16).contiguous())


def pack_stream_taps(taps: torch.Tensor, Tp: int) -> torch.Tensor:
    """(kh, C2, I) taps → the streamed kernel's bf16 operand, (copies, Np,
    Lq) flattened (:func:`stream_shape`'s). Column i's row ρ = 64 + (kh −
    1 − d)·C2 + c holds tap d (64 zero rows before and after), so column
    block t's slab j of depths is rows 64 + (kh − 1 − t)·C2 + 64·j onward,
    zero where the band is. Each column keeps its rows contiguous (K-major),
    and copy q has them shifted down by (8 − q·gcd(C2, 8)) % 8 positions,
    so that a slab starts 16-byte aligned (as the kernel's TMA boxes must)
    in the copy its first row's residue names. Columns past I (up to
    chunks × N) are zero; Tp, z's depths, sets the chunks (a deep band's
    are narrower)."""
    kh, C2, I = taps.shape
    sh = stream_shape(Tp, kh, C2, I)
    rows = kh * C2
    ppad = torch.zeros(sh.np, rows + 2 * STREAM_SLAB, dtype=torch.float32, device=taps.device)
    ppad[:I, STREAM_SLAB:STREAM_SLAB + rows] = taps.float().flip(0).reshape(rows, I).t()
    q = torch.zeros(sh.copies, sh.np, sh.lq, dtype=torch.float32, device=taps.device)
    div = 8 // sh.copies
    for c in range(sh.copies):
        shift = (8 - c * div) % 8
        q[c, :, shift:shift + rows + 2 * STREAM_SLAB] = ppad
    return q.reshape(-1).to(torch.bfloat16).contiguous()


@dataclass(frozen=True)
class BandOperand:
    """A time kernel's band (:func:`band_tensor`, float32: the plain
    version's operand) beside its taps packed for the kernels
    (:func:`pack_taps`, :func:`pack_stream_taps`), built together once per
    weight tensor."""

    band: torch.Tensor
    packed: torch.Tensor
    stream: torch.Tensor | None = None


def band_operand(kernel: torch.Tensor, time_context: int) -> BandOperand:
    """(kh, 1, I, O) tied kernel → :class:`BandOperand`."""
    band = band_tensor(kernel, time_context)
    taps = kernel[:, 0].permute(0, 2, 1)
    return BandOperand(band, pack_taps(taps), pack_stream_taps(taps, band.shape[0]))


def h_range(t: int, Tp: int, kh: int) -> tuple[int, int]:
    """The taps h of column block t: the h with 0 <= t − h < kh, h < Tp."""
    return max(0, t - kh + 1), min(Tp - 1, t)


@dataclass(frozen=True)
class BandPlan:
    c2p: int              # C2 rounded up to 8
    ip: int               # I rounded up to 8
    nw: int               # columns of one product (a multiple of 8 dividing ip, <= 64)
    vec: int              # z's loads: 0 through registers a tile ahead, 2 pairs by
                          # cp.async, 1 thread stores (C2 odd)
    row_tiles: int
    grid: int             # persistent blocks
    smem_bytes: int
    steps: tuple          # 16-deep products of column block t, per t
    executed_ops: float   # 2 · multiply-adds the tensor cores run (padded rows, columns, depth)


def band_plan(M: int, Tp: int, C2: int, kh: int, I: int, sms: int = 132) -> BandPlan:
    """The kernel's launch, as ``csrc/band_decode.cu::band_decode_launch``
    computes it: a 64-row tile of z (padded depth Tp·C2p + 8), the packed
    taps ((kh·C2p + 8) × Ip) and 8 staging rows a warp in shared memory, one
    persistent block per ``blocks per SM × sms``; column block t runs
    ceil(taps(t)·C2p / 16) products of depth 16 over Ip columns."""
    c2p, ip = -(-C2 // 8) * 8, -(-I // 8) * 8
    nw = next(w for w in range(64, 0, -8) if ip % w == 0)
    K = Tp * C2
    vec = 0 if C2 % 2 == 0 and K % 8 == 0 and K <= 32 * QUADS else 2 if C2 % 2 == 0 else 1
    smem = _band_smem(Tp, C2, kh, I)
    if smem > SMEM_MAX:
        raise ValueError(f"band decode kernel: {smem} bytes of shared memory for Tp={Tp} "
                         f"C2={C2} kh={kh} I={I} exceed {SMEM_MAX}")
    row_tiles = -(-M // ROWS)
    per_sm = min(SM_SMEM // (smem + BLOCK_RESERVED), 2048 // THREADS)
    T = Tp + kh - 1
    steps = tuple(-(-(hi - lo + 1) * c2p // 16) for lo, hi in (h_range(t, Tp, kh) for t in range(T)))
    ops = 2.0 * ROWS * row_tiles * 16 * ip * sum(steps)
    return BandPlan(c2p, ip, nw, vec, row_tiles, min(row_tiles, per_sm * sms), smem, steps, ops)


@dataclass(frozen=True)
class BandPieces:
    """A band whose taps and 64-row z tile do not fit one block's shared
    memory at once, cut into pieces that do: z's depths h0 .. h1 − 1
    against the taps d0 .. d1 − 1, each a band decode of its own
    (``csrc/band_decode.cu::band_decode_piece_launch``) added into output
    columns h0 + d0 .. h1 + d1 − 2."""

    tp: int               # z's depths a piece takes (at most)
    kh: int               # the taps a piece takes (at most)
    pieces: tuple         # (h0, h1, d0, d1) each
    smem_bytes: int       # the largest piece's


@lru_cache(maxsize=64)
def band_pieces(Tp: int, C2: int, kh: int, I: int) -> BandPieces:
    """The fewest pieces (ties: the most taps a piece) whose largest fits
    shared memory (:func:`band_plan`'s rule): for each count of taps a
    piece, the most depths that fit beside them. One piece where the whole
    band fits. Raises ``ValueError`` where not even one depth and one tap
    fit (C2 and I past about 700)."""
    best = None
    for khp in range(kh, 0, -1):
        tp = next((t for t in range(Tp, 0, -1) if _band_smem(t, C2, khp, I) <= SMEM_MAX), 0)
        if not tp:
            continue
        key = (-(-Tp // tp) * -(-kh // khp), -khp)
        if best is None or key < best[0]:
            best = (key, tp, khp)
    if best is None:
        raise ValueError(f"band decode kernel: no piece of Tp={Tp} C2={C2} kh={kh} I={I} "
                         f"fits {SMEM_MAX} bytes of shared memory")
    _, tp, khp = best
    pieces = tuple((h0, min(h0 + tp, Tp), d0, min(d0 + khp, kh))
                   for h0 in range(0, Tp, tp) for d0 in range(0, kh, khp))
    return BandPieces(tp, khp, pieces, _band_smem(tp, C2, khp, I))


def _band_smem(Tp: int, C2: int, kh: int, I: int) -> int:
    """The launcher's shared memory (bytes): the 64-row z tile (depth Tp ·
    C2p + 8), the packed taps ((kh · C2p + 8) × Ip) and 8 staging rows a
    warp, in bf16 and float32."""
    c2p, ip = -(-C2 // 8) * 8, -(-I // 8) * 8
    nw = next(w for w in range(64, 0, -8) if ip % w == 0)
    stage = nw + (24 - nw) % 32  # floats a staging row takes
    return 2 * ROWS * (Tp * c2p + 8) + 2 * (kh * c2p + 8) * ip + 4 * (THREADS // 32) * 8 * stage


@dataclass(frozen=True)
class StreamShape:
    """The streamed kernel's widths for (Tp, kh, C2, I): chunks of N = Ip
    (I rounded up to 8) columns up to 256, past that two or more equal
    chunks; G column blocks an item (G·N / 2 accumulators a thread, at most
    128); the packed taps' shifted copies, columns and rows. A deep band
    (a column block past ``STREAM_FOLD`` slabs of 64 depths) folds: chunks
    of at most 128 columns, half the column blocks an item, float32 sums
    in shared memory."""

    n: int
    g: int
    chunks: int
    copies: int
    np: int
    lq: int
    fold: bool


def stream_slabs(Tp: int, C2: int, kh: int) -> tuple:
    """(j_lo, j_hi) of each column block t: its 64-depth slabs of z, the
    slabs that meet depths h_lo·C2 .. (h_hi + 1)·C2 − 1."""
    return tuple((lo * C2 // STREAM_SLAB, ((hi + 1) * C2 - 1) // STREAM_SLAB)
                 for lo, hi in (h_range(t, Tp, kh) for t in range(Tp + kh - 1)))


def stream_shape(Tp: int, kh: int, C2: int, I: int) -> StreamShape:
    fold = max(hi - lo + 1 for lo, hi in stream_slabs(Tp, C2, kh)) > STREAM_FOLD
    ip = _up(I, 8)
    chunks = -(-ip // (128 if fold else 256))
    n = _up(-(-ip // chunks), 8)
    g = 1 if n >= 256 else min(4, 256 // n)
    if fold:
        g = max(g // 2, 1)
    return StreamShape(n, g, chunks, 8 // gcd(C2, 8), n * chunks,
                       _up(kh * C2 + 2 * STREAM_SLAB + 8, 8), fold)


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


@dataclass(frozen=True)
class StreamPlan:
    n: int                # columns of a product (wgmma m64nNk16)
    g: int                # column blocks an item takes at once
    chunks: int           # column chunks of N
    groups: int           # items a (row tile, chunk): ceil(T / G)
    copies: int           # the packed taps' shifted copies
    np: int               # their columns (chunks · N)
    lq: int               # their rows a column
    smem_bytes: int
    row_tiles: int        # tiles of 128 rows
    items: int            # (pair of row tiles, chunk, group) triples: a cluster's
    grid: int             # persistent blocks, in clusters of 2
    fold: bool            # a deep band: sums in shared memory every STREAM_FOLD slabs
    slabs: tuple          # (j_lo, j_hi) of column block t: its 64-depth slabs of z
    executed_ops: float   # 2 · multiply-adds the tensor cores run (a pair's empty tile too)


@lru_cache(maxsize=64)
def band_stream_plan(M: int, Tp: int, C2: int, kh: int, I: int, sms: int = 132) -> StreamPlan:
    """The streamed kernel's launch, as ``csrc/band_stream.cu::
    band_stream_launch`` computes it: items (a pair of 128-row tiles, chunk
    of N columns, group of G column blocks), one launch of at most ``sms``
    persistent blocks in clusters of 2 (a block a row tile of the pair;
    each slab of taps loaded once for both; a deep band folds, see
    :class:`StreamShape`), a ring of 4 stages of 128 × 64 bf16 of z and G
    slabs of 64 × N bf16 of the taps, whatever the band's size. Column
    block t runs its slabs j_lo .. j_hi of z's depth k = h·C2 + c (64 each,
    h_lo·C2 ≤ k < (h_hi + 1)·C2 met) as 4 products of depth 16 each."""
    sh = stream_shape(Tp, kh, C2, I)
    T = Tp + kh - 1
    groups = -(-T // sh.g)
    row_tiles = -(-M // STREAM_ROWS)
    pairs = -(-row_tiles // STREAM_CLUSTER)
    items = pairs * sh.chunks * groups
    slabs = stream_slabs(Tp, C2, kh)

    def smem_of(fold: bool) -> int:  # band_stream.cuh::smem_bytes
        full_g = 1 if sh.n >= 256 else min(4, 256 // sh.n)
        g = max(full_g // 2, 1) if fold else full_g
        return (2048 + STREAM_STAGES * (2 * 64 * STREAM_SLAB * 2 + g * STREAM_SLAB * sh.n * 2)
                + STREAM_STAGING + (256 * g * (sh.n // 2) * 4 if fold else 0))

    smem = smem_of(False) if sh.n > 128 else max(smem_of(False), smem_of(True))
    ops = 2.0 * STREAM_ROWS * STREAM_SLAB * sh.n * STREAM_CLUSTER * pairs * sh.chunks * sum(
        hi - lo + 1 for lo, hi in slabs)
    grid = STREAM_CLUSTER * min(items, sms // STREAM_CLUSTER)
    return StreamPlan(sh.n, sh.g, sh.chunks, groups, sh.copies, sh.np, sh.lq, smem, row_tiles,
                      items, grid, sh.fold, slabs, ops)


def stream_items(plan: StreamPlan, T: int):
    """The units of a plan in the launcher's order of items: (row tile,
    chunk, t0, t1), column blocks t0 .. t1 of N columns from chunk · N, the
    two row tiles of a cluster's item in turn (a tile past the rows is
    left out)."""
    for pair in range(-(-plan.row_tiles // STREAM_CLUSTER)):
        for ch in range(plan.chunks):
            for gr in range(plan.groups):
                t0 = gr * plan.g
                for rank in range(STREAM_CLUSTER):
                    rt = STREAM_CLUSTER * pair + rank
                    if rt < plan.row_tiles:
                        yield rt, ch, t0, min(T, t0 + plan.g) - 1


def streams(Tp: int, C2: int, kh: int, I: int) -> bool:
    """Whether the card takes the streamed kernel for this band: where its
    taps and a 64-row z tile do not fit one block's shared memory at once
    (``csrc/band_decode.cu`` then cannot take it), or where it won its A/B
    (``BAND_STREAM_WON``)."""
    return _band_smem(Tp, C2, kh, I) > SMEM_MAX or (Tp, C2, kh, I) in BAND_STREAM_WON


@lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def band_decode_wmajor_plain(z: torch.Tensor, band: torch.Tensor | BandOperand) -> torch.Tensor:
    """z (N, W, Tp·O) and band (Tp, O, T·I) (or a :class:`BandOperand`) →
    (N, W, T·I) float32: both rounded to bfloat16, the product in float32
    (each bf16 × bf16 product is exact in float32)."""
    if isinstance(band, BandOperand):
        band = band.band
    Tp, O, TI = band.shape
    zb = z.to(torch.bfloat16).float()
    return zb @ band.to(torch.bfloat16).float().reshape(Tp * O, TI)


def band_decode_wmajor(z: torch.Tensor, band: torch.Tensor | BandOperand,
                       time_context: int) -> torch.Tensor:
    """The decode on the w-major fold: z (N, W, Tp·O) (float32 or bf16; a
    float32 z is rounded to bf16 first) and the band (Tp, O, T·I), a
    :func:`band_tensor`, or better a :class:`BandOperand` (its taps packed
    once; a bare band is packed on every call), T the time context →
    (N, W, T·I) float32. CPU tensors: :func:`band_decode_wmajor_plain`.
    CUDA tensors: the streamed kernel where :func:`streams` says so, else
    the taps-resident one."""
    dense = band.band if isinstance(band, BandOperand) else band
    _align(z, dense, time_context)
    devices = {z.device.type, dense.device.type}
    if devices == {"cpu"}:
        return band_decode_wmajor_plain(z, dense)
    if devices != {"cuda"} or z.device != dense.device:
        raise ValueError(f"band_decode: tensors on mixed devices {devices}")
    zb, op, dense, sms = _cuda_operands(z, band, time_context)
    Tp, O, TI = dense.shape
    T = time_context
    if streams(Tp, O, T - Tp + 1, TI // T):
        return _stream(zb, op, dense, T, sms)
    return _resident(zb, op, dense, T, sms)


def _align(z: torch.Tensor, dense: torch.Tensor, time_context: int) -> None:
    Tp, O, TI = dense.shape
    if z.dim() != 3 or z.shape[-1] != Tp * O or TI % time_context or time_context < Tp:
        raise ValueError(
            f"band_decode: z {tuple(z.shape)} and band {tuple(dense.shape)} do not align "
            f"(time context {time_context})"
        )


def _cuda_operands(z: torch.Tensor, band: torch.Tensor | BandOperand, time_context: int):
    """The checks of a CUDA launch: (z in bf16, the operand or None, the
    dense band, the SM count)."""
    op = band if isinstance(band, BandOperand) else None
    dense = op.band if op else band
    _align(z, dense, time_context)
    if z.device.type != "cuda" or dense.device != z.device:
        raise ValueError(f"band_decode: forced kernels take CUDA tensors on one device, got "
                         f"{z.device} and {dense.device}")
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"band_decode: z must be float32 or bfloat16, got {z.dtype}")
    dev = z.device
    sms = _sms(dev.index if dev.index is not None else torch.cuda.current_device())
    return z.to(torch.bfloat16).contiguous(), op, dense, sms


def _resident(zb: torch.Tensor, op: BandOperand | None, dense: torch.Tensor, T: int,
              sms: int) -> torch.Tensor:
    """One launch of the taps-resident kernel (``csrc/band_decode.cu``): zb
    (N, W, Tp·O) bf16, contiguous; raises where the band does not fit."""
    Tp, O, TI = dense.shape
    N, W, _ = zb.shape
    kh, I = T - Tp + 1, TI // T
    dev = zb.device
    plan = band_plan(N * W, Tp, O, kh, I, sms)
    packed = op.packed if op else pack_taps(taps_of_band(dense, T))
    if (packed.device != dev or packed.dtype != torch.bfloat16
            or packed.numel() != (kh * plan.c2p + 8) * plan.ip):
        raise ValueError("band_decode: the packed taps do not match the band")
    out = torch.empty((N, W, TI), dtype=torch.float32, device=dev)
    with kernels.on_device(dev):
        stream = torch.cuda.current_stream(dev.index).cuda_stream
        code = kernels.library().band_decode_launch(zb.data_ptr(), packed.data_ptr(),
                                                    out.data_ptr(), N * W, Tp, O, kh, I,
                                                    plan.grid, stream)
    kernels.check(code, "band_decode")
    kernels.LAUNCHES["band_decode"] += 1
    return out


def _stream(zb: torch.Tensor, op: BandOperand | None, dense: torch.Tensor, T: int,
            sms: int) -> torch.Tensor:
    """One launch of the streamed kernel (``csrc/band_stream.cu``): zb (N,
    W, Tp·O) bf16, contiguous."""
    Tp, O, TI = dense.shape
    N, W, _ = zb.shape
    kh, I = T - Tp + 1, TI // T
    dev = zb.device
    plan = band_stream_plan(N * W, Tp, O, kh, I, sms)
    packed = op.stream if op is not None and op.stream is not None else \
        pack_stream_taps(taps_of_band(dense, T), Tp)
    if (packed.device != dev or packed.dtype != torch.bfloat16
            or packed.numel() != plan.copies * plan.np * plan.lq):
        raise ValueError("band_decode: the stream-packed taps do not match the band")
    out = torch.empty((N, W, TI), dtype=torch.float32, device=dev)
    with kernels.on_device(dev):
        stream = torch.cuda.current_stream(dev.index).cuda_stream
        code = kernels.library().band_stream_launch(zb.data_ptr(), packed.data_ptr(),
                                                    out.data_ptr(), N * W, Tp, O, kh, I,
                                                    plan.grid, stream)
    kernels.check(code, "band_decode_stream")
    kernels.LAUNCHES["band_decode_stream"] += 1
    return out


def band_decode_stream_pallas(z: torch.Tensor, band: torch.Tensor | BandOperand,
                              time_context: int) -> torch.Tensor:
    """The streamed kernel forced at any band (CUDA tensors only; counted
    ``band_decode_stream``): the A/B against ``csrc/band_decode.cu`` where
    the band fits it."""
    zb, op, dense, sms = _cuda_operands(z, band, time_context)
    return _stream(zb, op, dense, time_context, sms)


def band_decode_resident_pallas(z: torch.Tensor, band: torch.Tensor | BandOperand,
                                time_context: int) -> torch.Tensor:
    """The taps-resident kernel (``csrc/band_decode.cu``) forced where the
    band fits its shared memory (CUDA tensors only; counted
    ``band_decode``): the A/B against the streamed kernel at the shapes
    ``BAND_STREAM_WON`` routes to it."""
    zb, op, dense, sms = _cuda_operands(z, band, time_context)
    return _resident(zb, op, dense, time_context, sms)


def band_decode_pieces_pallas(z: torch.Tensor, band: torch.Tensor | BandOperand,
                              time_context: int) -> torch.Tensor:
    """The pieces that served bands past one block's shared memory before
    the streamed kernel, forced (CUDA tensors only; counted ``band_decode``
    once a call): :func:`band_pieces` cuts the band into depths × taps, and
    each piece is one launch of ``csrc/band_decode.cu`` added into its
    columns of a zeroed output (z's and the output's row strides the whole
    band's; its taps cut and packed on every call)."""
    zb, _, dense, sms = _cuda_operands(z, band, time_context)
    Tp, O, TI = dense.shape
    N, W, K = zb.shape
    T = time_context
    kh, I = T - Tp + 1, TI // T
    dev = zb.device
    split = band_pieces(Tp, O, kh, I)
    taps = taps_of_band(dense, T)
    out = torch.zeros((N, W, TI), dtype=torch.float32, device=dev)
    lib = kernels.library()
    with kernels.on_device(dev):
        stream = torch.cuda.current_stream(dev.index).cuda_stream
        for h0, h1, d0, d1 in split.pieces:
            plan = band_plan(N * W, h1 - h0, O, d1 - d0, I, sms)
            packed = pack_taps(taps[d0:d1])
            code = lib.band_decode_piece_launch(
                zb.data_ptr() + 2 * h0 * O, packed.data_ptr(),
                out.data_ptr() + 4 * (h0 + d0) * I, N * W, h1 - h0, O, d1 - d0, I, K, TI, 1,
                plan.grid, stream)
            kernels.check(code, "band_decode")
    kernels.LAUNCHES["band_decode"] += 1
    return out


def band_decode_pallas(z: torch.Tensor, kernel: torch.Tensor, time_context: int) -> torch.Tensor:
    """The reference's contract: the (N, Tp, W, O) fold and the (kh, 1, I,
    O) time kernel → the (N, W, T·I) w-major time-stage decode (the layout
    ``freq_decode_wmajor`` takes)."""
    N, Tp, W, O = z.shape
    zw = z.permute(0, 2, 1, 3).reshape(N, W, Tp * O)
    return band_decode_wmajor(zw, band_operand(kernel, time_context), time_context)
