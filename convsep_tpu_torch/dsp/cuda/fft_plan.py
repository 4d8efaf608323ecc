"""Host side of the FFT core (``csrc/fft_common.cuh``): the launch plans of
the forward STFT kernels and of the inverse STFT kernel, the twiddle tables
and the device copies of the windows.

The two forward STFT kernels (``csrc/stft_dft.cu``, ``csrc/ct_stft.cu``)
run one complex FFT of nfft points, carrying two real frames, on a group of
nfft / 16 threads that hold 16 points each in registers, in Stockham passes
of the radices :func:`radices` gives, with one exchange buffer of
:func:`exchange_entries` float2 per group in shared memory (slot
:func:`exchange_slot`). A block holds ``ffts_per_block`` groups and first
loads the signal span of their 2 · ``ffts_per_block`` frames.
:func:`stft_plan` chooses that number for a shape, and computes the block's
threads, shared memory and the grid exactly as the C launchers do.

Sizes m · 2^a that are not powers of two (m in 3, 5, 9, 15) take the
mixed-radix split of the same core (``stft_split_block``): m interleaved
2^a-point FFTs, the twiddles e^{−2πi n1 k1 / N} from the N-point quarter
table, then 2^a m-point DFTs in registers across the exchange buffer;
:func:`split_factors` names the sizes and :func:`split_plan` sizes the
launch. Any other size up to 8192 takes Bluestein's chirp-z over the core
(``Chirp``, ``stft_bluestein_block``): two M-point transforms, M =
2^⌈log2(2N − 1)⌉ (:func:`bluestein_size`), and the chirp tables of
:func:`bluestein_tables`; :func:`bluestein_plan` sizes the launch. Past 4096
points M is 16 384, the level (``Level``): one group of 512 threads runs
two 8192-point transforms of the core and a radix-2 stage. Past 8192
points, up to :data:`CLUSTER_NFFT`, M is 32 768, 65 536 or 131 072 and its
points live across a thread-block cluster of M / 8192 blocks (4, 8 or 16:
``ClusterChirp``, ``stft_cluster_block``), each running the core's
8192-point transform on its part; :func:`cluster_plan` sizes that launch.
Past that, up to :data:`LEVEL2_NFFT`, M is 262 144 or 524 288, R = M / 8192
rows of the core's transform in a scratch in device memory, two passes of
radix-R DFTs in registers around one pass of the core
(``fft_common.cuh::level2_first``, ``level2_middle``, ``level2_last``);
:func:`level2_plan` sizes its rounds so that a round's scratch stays in the
L2, and :func:`level2_chat` orders the chirp spectrum for it. The fused
forward STFT's 16 384 points (``ct_stft.cu``) are one transform a pair of
frames on the level (``stft_level_block``), without a chirp.

The inverse STFT kernel (``csrc/istft.cu``) runs the same passes backwards
(by conjugation) on groups of a block that walk the block's frames in rounds
and overlap-add them by a gather, at the split's sizes on the split run
backwards, at the other sizes up to 8192 (odd ones too) on Bluestein run
backwards, past 8192 on the cluster run backwards (:func:`istft_cluster_plan`;
at the powers of two the direct transform over the cluster,
:func:`istft_cluster_dit_plan`, and at the 7-smooth sizes of
:func:`mixed_factors` the same on a mixed-radix block core whose passes
:func:`mixed_radices` plans, :func:`istft_cluster_mixed_plan`), past 65 536
on the second level run backwards (:func:`level2_plan`; at the 7-smooth
sizes of :func:`level2_direct_factors` the direct transform on the second
level without a chirp, :func:`level2_direct_plan`, a radix-R combine and R
rows of the mixed-radix core, its tables :func:`level2_direct_tables`);
:func:`istft_plan` sizes them all. The
Wiener+iSTFT kernel (``csrc/wiener_istft.cu``) does the same for one pair of
sources a block, the mask formed as the points load; :func:`wiener_plan`
sizes it on the core, the split and Bluestein, past 8192 on the cluster run
backwards (:func:`wiener_cluster_plan`, up to :data:`WIENER_CLUSTER_NFFT`,
the reference kernel's largest size), at the powers of two there on the
direct transform split by decimation in time over the cluster
(:func:`wiener_cluster_dit_plan`); :func:`wiener_direct_plan` sizes its
direct sum, which only a forced call runs.
"""

from __future__ import annotations

import ctypes
import math
import threading
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from convsep_tpu_torch.dsp.dft import _key, inverse_norm

SMS = 132                # streaming multiprocessors of an H100 SXM
SMEM_MAX = 227 * 1024    # dynamic shared memory a block may use
MAX_THREADS = 512        # fft_common::kMaxThreads
POINTS = 16              # complex points a thread holds
MAX_NAMED_GROUPS = 8     # groups per block that synchronize on named barriers
MIN_NFFT, MAX_NFFT = 2 ** 4, 2 ** 13
LEVEL_NFFT = 2 ** 14     # the level: Bluestein's largest convolution on one block (fft_common.cuh::Level)
CLUSTER_PART = 2 ** 13   # the points of one block of a cluster: the core's transform
CLUSTER_NFFT = 2 ** 16   # the cluster's largest nfft: M 131 072 on 16 blocks (non-portable)
WIENER_CLUSTER_NFFT = 2 ** 15  # the Wiener+iSTFT cluster's: the reference kernel's 32 768
LEVEL2_NFFT = 2 ** 18    # the second level's largest nfft: M 524 288 = 64 × 8192 in device memory
L2_BYTES = 50 * 2 ** 20  # the H100 SXM's L2 cache
LEVEL2_SCRATCH_BYTES = 24 * 2 ** 20  # the second level's scratch a round: within half the L2
LEVEL2_THREADS = 256     # fft_common::kLevel2Threads: a block of the radix-R phases
SPLIT_ODD = (3, 5, 9, 15)  # the split's odd factors: its m-point DFTs (radix 3 and 5)
SM_SMEM = 228 * 1024     # shared memory of one SM
BLOCK_RESERVED = 1024    # shared memory the runtime keeps per resident block
SM_THREADS = 2048        # resident threads per SM
SM_BLOCKS = 32           # resident blocks per SM
MAX_HALO = 3 / 16        # the inverse kernel's recomputed share of transforms
DIRECT_THREADS = 512     # the inverse kernel's direct sum (other sizes)
DIRECT_SMEM_BUDGET = 200 * 1024
DIRECT_MAX_ROWS = 16
# registers a thread may hold at 512 threads a block (__launch_bounds__(512));
# the inverse kernels' FFT instances use them all (ptxas, PERF.md)
REGS_PER_THREAD = 128
SM_REGS = 65536
MAX_ROUNDS = 256         # the most rounds wiener_plan weighs


def fft_supported(nfft: int) -> bool:
    """A power of two that the FFT core's template covers (16 … 8192)."""
    return MIN_NFFT <= nfft <= MAX_NFFT and nfft & (nfft - 1) == 0


def split_factors(nfft: int) -> tuple[int, int] | None:
    """(m, P) with nfft = m · P, m in ``SPLIT_ODD`` and P a power of two that
    the core plans (P >= 16), nfft <= 8192: the sizes of the mixed-radix
    split (``fft_common.cuh::stft_split_block``); None for any other size."""
    if not MIN_NFFT <= nfft <= MAX_NFFT:
        return None
    p = nfft & -nfft  # the largest power of two dividing nfft
    m = nfft // p
    return (m, p) if m in SPLIT_ODD and p >= MIN_NFFT else None


def split_supported(nfft: int) -> bool:
    return split_factors(nfft) is not None


def bluestein_size(nfft: int) -> int:
    """M = 2^⌈log2(2 nfft − 1)⌉, at least 16: the cyclic convolution that
    Bluestein's chirp-z runs on the core for nfft points
    (``fft_common.cuh::bluestein_log2``)."""
    return max(MIN_NFFT, 1 << (2 * nfft - 2).bit_length())


def bluestein_supported(nfft: int) -> bool:
    """A size the core takes by Bluestein (M <= 16 384, so nfft <= 8192)
    and neither by its own passes nor by the split."""
    return (2 <= nfft and bluestein_size(nfft) <= LEVEL_NFFT and not fft_supported(nfft)
            and not split_supported(nfft))


def cluster_supported(nfft: int) -> bool:
    """A size past 8192 that Bluestein takes on a thread-block cluster: M =
    :func:`bluestein_size` is 32 768 (nfft up to 16 384, 4 blocks), 65 536
    (up to 32 768, 8 blocks) or 131 072 (up to :data:`CLUSTER_NFFT`, 16
    blocks)."""
    return MAX_NFFT < nfft <= CLUSTER_NFFT


MIXED_RADICES = (2, 3, 4, 5, 7, 8, 9, 16)  # the mixed-radix block core's passes (mixed_fft)
MIXED_RADIX_BITS = 5  # fft_common::kMixedRadixBits: the bits of one radix in a schedule


def smooth7(n: int) -> bool:
    """n = 2^a · 3^b · 5^c · 7^d."""
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


def mixed_factors(nfft: int) -> tuple[int, int] | None:
    """(C, n) for a size the mixed cluster takes (``fft_common.cuh::
    mixed_sizes``, ``ClusterMixed``): a 7-smooth nfft in (8192, 65 536]
    that is not a power of two, n = nfft / C <= 8192 (7-smooth with it).

    * C is the fewest of 2, 4, 8 blocks with nfft / C <= 8192 where that C
      divides nfft: 204 even sizes on 68 block sizes n (4096 < n < 8192),
      the 87 5-smooth ones (10 000, 20 000 and 40 000 are C · 5000) and 117
      with a factor 7 (14 000, 28 000 and 56 000 are C · 7000); 33 of them
      on one of 11 odd n (11 250, 12 150, 13 122, 8750 = 2 · 4375, 14 406 =
      2 · 7203 and six more on 2 blocks, and twice and four times each).
    * Else C is the fewest blocks from ceil(nfft / 8192) to 8 that divides
      nfft: 77 sizes more, on C 3 (25: 11 025 = 3 · 3675, 22 050 = 3 ·
      7350), 5 (27: 30 870 = 5 · 6174, 33 075 = 5 · 6615), 6 (8: 44 100 =
      6 · 7350, 39 366 = 6 · 6561) and 7 (17: 16 807 = 7 · 2401); 40 of
      them odd (11 025, 12 005, 15 625, 33 075), which only the iSTFT
      takes (the Wiener+iSTFT's nfft is even).

    281 sizes in all. The core serves an odd n as any other, its n-point
    twiddle table whole. None for any other size: a prime factor past 7
    (11 264, 22 000, 9999), a power of two, or a 7-smooth size that needs
    more than 8 blocks (46 875, 50 625, 54 675, 56 250, 59 049, 59 535, 60
    025, 60 750, 61 236, 61 250, 61 740, 62 500 and 64 827)."""
    if not MAX_NFFT < nfft <= CLUSTER_NFFT or nfft & (nfft - 1) == 0 or not smooth7(nfft):
        return None
    c = 2 if nfft <= 2 * MAX_NFFT else 4 if nfft <= 4 * MAX_NFFT else 8
    if nfft % c:
        c = next((b for b in range(-(-nfft // MAX_NFFT), 9) if nfft % b == 0), None)
        if c is None:
            return None
    return c, nfft // c


def mixed_radices(n: int) -> tuple[int, ...]:
    """The passes of the mixed-radix core for a 7-smooth n, in order: radix
    16 while four factors of two remain, the rest of the power of two in one
    radix-2, 4 or 8 pass, then radix 5, then radix 7, then radix 9 and a
    last radix 3 (5000: 8, 5, 5, 5, 5; 7000: 8, 5, 5, 5, 7; 7203: 7, 7, 7,
    7, 3; 6561: 9, 9, 9, 9), the order in which the kernel runs a
    schedule's passes (``mixed_fft``: grouped by radix, 16, 8, 4, 2, 5, 7,
    9, 3). Each pass costs a round trip through the exchange buffer and two
    block barriers, so the fewest passes the radices allow."""
    if n < 2 or not smooth7(n):
        raise ValueError(f"no mixed-radix passes for n={n}: 7-smooth, at least 2")
    out = []
    a = (n & -n).bit_length() - 1
    out += [16] * (a // 4) + ([1 << a % 4] if a % 4 else [])
    m = n >> a
    for r in (5, 7):
        while m % r == 0:
            out.append(r)
            m //= r
    while m % 9 == 0:
        out.append(9)
        m //= 9
    if m == 3:
        out.append(3)
    return tuple(out)


def mixed_schedule(radices: tuple[int, ...]) -> int:
    """The radices as the kernel reads them: :data:`MIXED_RADIX_BITS` a
    radix, the first pass in the lowest bits (``istft_cluster_mixed_launch``
    checks that they multiply to n)."""
    return sum(r << (MIXED_RADIX_BITS * i) for i, r in enumerate(radices))


def level2_supported(nfft: int) -> bool:
    """A size past the cluster's 65 536 that the second level takes:
    Bluestein's M = :func:`bluestein_size` is 262 144 (nfft up to 131 072)
    or 524 288 (up to :data:`LEVEL2_NFFT`), R = M / 8192 = 32 or 64 rows of
    the core's transform, over two passes through device memory
    (``fft_common.cuh::level2_first``, ``level2_middle``, ``level2_last``)."""
    return CLUSTER_NFFT < nfft <= LEVEL2_NFFT


@dataclass(frozen=True)
class Level2Plan:
    nfft: int
    m: int                # the transform's length: Bluestein's 262 144 or 524 288; the direct nfft
    radix: int            # R: M / 8192 (phase A's and D's in-register DFTs, phase B/C's blocks a
                          # pair); the direct level's 16 or 32 (its combine, its rows a pair)
    pairs: int            # pairs of the flattened (signals × nf) frames
    pairs_per_round: int  # pairs whose scratch is in flight at once
    rounds: int           # rounds of four (STFT) or three (iSTFT) phase launches; two (direct)
    scratch_bytes: int    # M float2 a pair of a round
    middle_smem_bytes: int  # phase B/C's block: the 8192-point table and exchange buffer; the
                            # direct level's rows: the n-point table and exchange buffer
    route: str = "level2"  # the kernels: level2 (Bluestein's) or level2_direct


@lru_cache(maxsize=64)
def level2_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> Level2Plan:
    """The second level's launch, as ``csrc/stft_dft.cu::stft_level2_launch``
    and ``csrc/istft.cu::istft_level2_launch`` run it: the frames of every
    signal, flattened, in pairs; each pair takes M float2 of scratch, and a
    round holds as many pairs as :data:`LEVEL2_SCRATCH_BYTES` (half the L2)
    allows, 12 at M 262 144 and 6 at 524 288, so that each phase's reads of
    the scratch the previous one wrote come from the L2."""
    if not level2_supported(nfft) or win > nfft:
        raise ValueError(f"no second-level plan for nfft={nfft}: past {CLUSTER_NFFT}, at most "
                         f"{LEVEL2_NFFT}, and at least the window")
    m = bluestein_size(nfft)
    pairs = -(-signals * nf // 2)
    per = max(1, min(pairs, LEVEL2_SCRATCH_BYTES // (8 * m)))
    return Level2Plan(nfft, m, m // CLUSTER_PART, pairs, per, -(-pairs // per), per * 8 * m,
                      8 * (twiddle_entries(CLUSTER_PART) + exchange_entries(CLUSTER_PART)))


def level2_direct_factors(nfft: int) -> tuple[int, int] | None:
    """(R, n) for a size the direct second level takes (``fft_common.cuh::
    level2_direct_sizes``): 65 536 < nfft <= :data:`LEVEL2_NFFT`, R 16 up to
    131 072 and 32 past it, R dividing nfft, n = nfft / R 7-smooth (n <=
    8192 by the bounds), of either parity. 138 sizes, 69 at each R: 65 856
    = 16 · 4116 to 131 072 = 16 · 8192 (70 000 = 16 · 4375), 131 712 = 32 ·
    4116 to 262 144 = 32 · 8192 (200 000 = 32 · 6250); 11 odd n at each R.
    None for any other size: odd, a prime factor past 7, or too few factors
    of two for R (99 999, 131 073, 70 001, 65 538)."""
    if not level2_supported(nfft):
        return None
    r = 16 if nfft <= 2 * CLUSTER_NFFT else 32
    if nfft % r or not smooth7(nfft // r):
        return None
    return r, nfft // r


@lru_cache(maxsize=64)
def level2_direct_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> Level2Plan:
    """The direct second level's launch, as ``csrc/istft.cu::
    istft_level2_direct_launch`` runs it: the pairs of the flattened frames
    in rounds of as many as :data:`LEVEL2_SCRATCH_BYTES` holds at nfft
    float2 a pair (39 pairs of W 70 000 in one round), each round a combine
    launch of one thread a column and a rows launch of R blocks of 512
    threads a pair, each with :func:`cluster_mixed_smem_bytes` of n (route
    "level2_direct"). :func:`istft_plan` takes it at
    :data:`ISTFT_LEVEL2_DIRECT_WON`; ``launch_istft(level2_direct=True)``
    forces it at any size of :func:`level2_direct_factors`."""
    f = level2_direct_factors(nfft)
    if f is None or win > nfft:
        raise ValueError(f"no direct second-level plan for nfft={nfft}: R n past {CLUSTER_NFFT}, "
                         f"at most {LEVEL2_NFFT}, R 16 or 32, n 7-smooth, and at least the window")
    r, n = f
    pairs = -(-signals * nf // 2)
    per = max(1, min(pairs, LEVEL2_SCRATCH_BYTES // (8 * nfft)))
    return Level2Plan(nfft, nfft, r, pairs, per, -(-pairs // per), per * 8 * nfft,
                      cluster_mixed_smem_bytes(n), "level2_direct")


def cluster_blocks(nfft: int) -> int:
    """Blocks of one cluster transform: M / 8192 (``ClusterChirp``'s C)."""
    return bluestein_size(nfft) // CLUSTER_PART


def cluster_mixed_smem_bytes(n: int, carry: int = 0) -> int:
    """Dynamic shared memory of a mixed cluster's block (``fft_common.cuh::
    cluster_mixed_smem_bytes``): the whole n-point table, one n-point
    exchange buffer and ``carry`` floats."""
    return 8 * (n + exchange_entries(n)) + 4 * carry


def cluster_smem_bytes(carry: int = 0) -> int:
    """Dynamic shared memory of a cluster's block: the 8192-point quarter
    table, one 8192-point exchange buffer and ``carry`` floats (the
    inverse's carry of its columns) (``fft_common.cuh::cluster_smem_bytes``:
    87 040 bytes without a carry)."""
    return 8 * (twiddle_entries(CLUSTER_PART) + exchange_entries(CLUSTER_PART)) + 4 * carry


# Clusters of 2 to 8 and 16 blocks an H100 SXM holds at once: one block an
# SM (512 threads at 128 registers take an SM's 65 536), a cluster's blocks
# in one GPC, which leaves 12 of the 132 SMs idle at 4 and 8, 15 at 3, 22
# at 6, 27 at 7 (cudaOccupancyMaxActiveClusters through csrc/istft.cu::
# istft_cluster_occupancy for Bluestein's cluster, the direct one and the
# mixed one, and through wiener_cluster_dit_launch and
# wiener_cluster_mixed_launch, on an H100 80GB HBM3; tests/test_torch_cuda.py
# holds the card to it).
CLUSTERS_AT_ONCE = {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 16: 7}

# The sizes at which wiener_plan takes the mixed cluster (route
# "cluster_mixed") over Bluestein's: each beat Bluestein's cluster forced,
# 4 stems of a 30 s track, bf16 y, at hop nfft / 4 (nfft / 5, nfft / 3
# where 4 does not divide it), by 2.85-6.04x in card ms, in one run on an
# H100 80GB HBM3 at 700 W (tools/torch_wiener_mixed_ab.py, PERF.md rows 1″
# (5-smooth) and 1″ (7-smooth)): all 136 of mixed_factors up to the
# reference's 32 768 on C 2 or 4, the 78 with a factor 7 among them; and,
# by 3.65-5.75x in another such run (--new, PERF.md row 1″ (any C)), all
# 13 of wiener_mixed_factors on C 3, 5 or 6 (22 050 among them). Keyed by
# nfft alone, as ISTFT_MIXED_WON: both routes run the same rounds and
# gather. A size that loses stays on Bluestein's cluster.
WIENER_MIXED_WON: frozenset[int] = frozenset({
    8232, 8400, 8640, 8748, 8750, 8820, 8960, 9000, 9072, 9216, 9408, 9450, 9600, 9604, 9720, 9800,
    10000, 10080, 10206, 10240, 10290, 10368, 10500, 10584, 10752, 10800, 10976, 11200, 11250,
    11340, 11520, 11664, 11760, 12000, 12096, 12150, 12250, 12288, 12348, 12500, 12544, 12600,
    12800, 12960, 13122, 13230, 13440, 13500, 13608, 13720, 13824, 14000, 14112, 14336, 14400,
    14406, 14580, 14700, 15000, 15120, 15360, 15552, 15680, 15750, 15876, 16000, 16128, 16200,
    16464, 16800, 17010, 17280, 17496, 17500, 17640, 17920, 18000, 18144, 18432, 18522, 18750,
    18816, 18900, 19200, 19208, 19440, 19600, 20000, 20160, 20250, 20412, 20480, 20580, 20736,
    21000, 21168, 21504, 21600, 21870, 21952, 22050, 22400, 22500, 22680, 23040, 23328, 23520,
    23814, 24000, 24010, 24192, 24300, 24500, 24576, 24696, 25000, 25088, 25200, 25600, 25920,
    26244, 26250, 26460, 26880, 27000, 27216, 27440, 27648, 28000, 28224, 28350, 28672, 28800,
    28812, 29160, 29400, 30000, 30240, 30618, 30720, 30870, 31104, 31250, 31360, 31500, 31752,
    32000, 32256, 32400})

# The sizes at which istft_plan takes the mixed cluster (route
# "cluster_mixed") over Bluestein's: each beat Bluestein's cluster forced
# at hop nfft / 4 (nfft / 5, nfft / 3 or nfft / 7 where 4 does not divide
# it) on a 30 s track, by 1.97-5.23x in card ms, in one run on an H100
# 80GB HBM3 at 700 W (tools/torch_istft_mixed_ab.py, PERF.md rows 3‴, 3⁗
# (5-smooth) and (7-smooth)): all 204 of mixed_factors on C 2, 4 or 8, the
# 117 with a factor 7 among them; and, by 1.67-5.97x in another such run
# (--new, PERF.md row 3‴, 3⁗ (any C)), all 77 on C 3, 5, 6 or 7, 40 of
# them odd (11 025, 22 050 and 44 100 among them). Keyed by nfft alone:
# both routes run the same rounds and gather, so the hop moves them alike.
# A size that loses stays on Bluestein's cluster.
ISTFT_MIXED_WON: frozenset[int] = frozenset({
    8232, 8400, 8505, 8575, 8640, 8748, 8750, 8820, 8960, 9000, 9072, 9216, 9261, 9375, 9408, 9450,
    9600, 9604, 9720, 9800, 10000, 10080, 10125, 10206, 10240, 10290, 10368, 10500, 10584, 10752,
    10800, 10935, 10976, 11025, 11200, 11250, 11340, 11520, 11664, 11760, 11907, 12000, 12005,
    12096, 12150, 12250, 12288, 12348, 12500, 12544, 12600, 12800, 12960, 13122, 13125, 13230,
    13440, 13500, 13608, 13720, 13824, 14000, 14112, 14175, 14336, 14400, 14406, 14580, 14700,
    15000, 15120, 15309, 15360, 15435, 15552, 15625, 15680, 15750, 15876, 16000, 16128, 16200,
    16464, 16800, 16807, 16875, 17010, 17150, 17280, 17496, 17500, 17640, 17920, 18000, 18144,
    18225, 18375, 18432, 18522, 18750, 18816, 18900, 19200, 19208, 19440, 19600, 19683, 19845,
    20000, 20160, 20250, 20412, 20480, 20580, 20736, 21000, 21168, 21504, 21600, 21609, 21870,
    21875, 21952, 22050, 22400, 22500, 22680, 23040, 23328, 23520, 23625, 23814, 24000, 24010,
    24192, 24300, 24500, 24576, 24696, 25000, 25088, 25200, 25515, 25600, 25725, 25920, 26244,
    26250, 26460, 26880, 27000, 27216, 27440, 27648, 27783, 28000, 28125, 28224, 28350, 28672,
    28800, 28812, 29160, 29400, 30000, 30240, 30375, 30618, 30625, 30720, 30870, 31104, 31250,
    31360, 31500, 31752, 32000, 32256, 32400, 32805, 32928, 33075, 33600, 33614, 33750, 34020,
    34300, 34560, 34992, 35000, 35280, 35721, 35840, 36000, 36015, 36288, 36450, 36750, 36864,
    37044, 37500, 37632, 37800, 38400, 38416, 38880, 39200, 39366, 39375, 39690, 40000, 40320,
    40500, 40824, 40960, 41160, 41472, 42000, 42336, 42525, 42875, 43008, 43200, 43218, 43740,
    43750, 43904, 44100, 44800, 45000, 45360, 45927, 46080, 46305, 46656, 47040, 47250, 47628,
    48000, 48020, 48384, 48600, 49000, 49152, 49392, 50000, 50176, 50400, 50421, 51030, 51200,
    51450, 51840, 52488, 52500, 52920, 53760, 54000, 54432, 54880, 55125, 55296, 55566, 56000,
    56448, 56700, 57344, 57600, 57624, 58320, 58800, 60000, 60480, 61440, 62208, 62720, 63000,
    63504, 64000, 64512, 64800})

# The sizes at which istft_plan takes the direct second level (route
# "level2_direct") over Bluestein's: each beat Bluestein's second level
# forced in device ms, by 2.09-4.86x, its card ms not over Bluestein's by
# more than 5 % (both wrappers' host time bounds the card ms past about
# 100 000 points), one 30 s track at hop nfft / 4, in one run on an H100
# 80GB HBM3 at 700 W (tools/torch_istft_level2_ab.py, PERF.md row 3⁵
# (7-smooth)): all 138 of level2_direct_factors. Keyed by nfft alone: both
# routes' work grows with the frames alike. A size that loses stays on
# Bluestein's level.
ISTFT_LEVEL2_DIRECT_WON: frozenset[int] = frozenset({
    65856, 67200, 69120, 69984, 70000, 70560, 71680, 72000, 72576, 73728, 75264, 75600, 76800,
    76832, 77760, 78400, 80000, 80640, 81648, 81920, 82320, 82944, 84000, 84672, 86016, 86400,
    87808, 89600, 90000, 90720, 92160, 93312, 94080, 96000, 96768, 97200, 98000, 98304, 98784,
    100000, 100352, 100800, 102400, 103680, 104976, 105840, 107520, 108000, 108864, 109760, 110592,
    112000, 112896, 114688, 115200, 115248, 116640, 117600, 120000, 120960, 122880, 124416, 125440,
    126000, 127008, 128000, 129024, 129600, 131072, 131712, 134400, 138240, 139968, 140000, 141120,
    143360, 144000, 145152, 147456, 150528, 151200, 153600, 153664, 155520, 156800, 160000, 161280,
    163296, 163840, 164640, 165888, 168000, 169344, 172032, 172800, 175616, 179200, 180000, 181440,
    184320, 186624, 188160, 192000, 193536, 194400, 196000, 196608, 197568, 200000, 200704, 201600,
    204800, 207360, 209952, 211680, 215040, 216000, 217728, 219520, 221184, 224000, 225792, 229376,
    230400, 230496, 233280, 235200, 240000, 241920, 245760, 248832, 250880, 252000, 254016, 256000,
    258048, 259200, 262144})


@dataclass(frozen=True)
class ClusterPlan:
    nfft: int
    m: int                # the convolution's power-of-two length: 32 768, 65 536 or 131 072
    cluster: int          # blocks of a cluster: M / 8192
    threads: int          # per block: 512, one core transform
    clusters: int         # one a pair of frames
    blocks: int
    smem_bytes: int


@lru_cache(maxsize=64)
def cluster_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> ClusterPlan:
    """The forward cluster kernel's launch, as ``csrc/stft_dft.cu::
    stft_cluster_launch`` (and ``csrc/ct_stft.cu::ct_stft_cluster_launch``)
    computes it: a cluster of M / 8192 blocks of 512
    threads a pair of frames, its blocks consecutive in the grid, each
    block's shared memory :func:`cluster_smem_bytes` (the frames are read
    from global memory)."""
    if not cluster_supported(nfft) or win > nfft:
        raise ValueError(f"no cluster plan for nfft={nfft}: past {MAX_NFFT}, at most "
                         f"{CLUSTER_NFFT}, and at least the window")
    c = cluster_blocks(nfft)
    clusters = signals * -(-nf // 2)
    return ClusterPlan(nfft, bluestein_size(nfft), c, threads_per_fft(CLUSTER_PART), clusters,
                       clusters * c, cluster_smem_bytes())


def bluestein_threads(m: int) -> int:
    """Threads of one Bluestein transform of M points: M/16 on the core, one
    512-thread group on the level (``fft_common.cuh::bluestein_threads``)."""
    return MAX_THREADS if m > MAX_NFFT else threads_per_fft(m)


def bluestein_table_entries(m: int) -> int:
    """float2 slots of a Bluestein block's twiddle tables in shared memory:
    the M-point quarter table; on the level the 8192-point one and the 16
    384-point one (``fft_common.cuh::bluestein_tables_len``)."""
    return (twiddle_entries(MAX_NFFT) + twiddle_entries(m) if m > MAX_NFFT
            else twiddle_entries(m))


def bluestein_smem_bytes(nfft: int, win: int, hop: int, ffts: int) -> int:
    """The forward Bluestein kernel's dynamic shared memory: :func:`smem_bytes`
    at M points on the core; on the level the two tables and one exchange
    buffer, the frames read from global memory (191 488 bytes)."""
    m = bluestein_size(nfft)
    if m <= MAX_NFFT:
        return smem_bytes(m, win, hop, ffts)
    return 8 * (bluestein_table_entries(m) + exchange_entries(m))


def radices(nfft: int) -> tuple[int, ...]:
    """The Stockham passes' radices in order: log2(nfft) mod 4 bits first
    (radix 2, 4 or 8) when nfft is not a power of 16, then radix 16."""
    lg = int(nfft).bit_length() - 1
    return ((1 << lg % 4,) if lg % 4 else ()) + (16,) * (lg // 4)


def threads_per_fft(nfft: int) -> int:
    return nfft // POINTS


def exchange_entries(nfft: int) -> int:
    """float2 entries of one group's exchange buffer: one pad per 16."""
    return nfft + nfft // 16


def exchange_slot(i):
    """Where element i of a pass's output lives in the exchange buffer."""
    return i + (i >> 4)


def span_floats(frames: int, win: int, hop: int) -> int:
    """Shared floats of the span of ``frames`` frames: (frames − 1) hop + W
    samples in whole float4s, plus the 16-byte alignment shift."""
    return ((frames - 1) * hop + win + 3) // 4 * 4 + 8


def twiddle_entries(nfft: int) -> int:
    """float2 slots of the quarter twiddle table in shared memory."""
    return nfft // 4 + nfft // 64


def smem_bytes(nfft: int, win: int, hop: int, ffts: int) -> int:
    return (4 * span_floats(2 * ffts, win, hop)
            + 8 * (twiddle_entries(nfft) + ffts * exchange_entries(nfft)))


@dataclass(frozen=True)
class StftPlan:
    nfft: int
    ffts_per_block: int   # complex FFTs (groups) per block: 2× as many frames
    threads: int          # per block
    blocks_per_signal: int
    blocks: int
    smem_bytes: int


@lru_cache(maxsize=64)
def stft_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> StftPlan:
    """The launch of ``signals`` × ``nf`` frames: the most FFTs per block
    (a power of two) that still gives at least two blocks per SM, so that
    overlapping frames share one span load and every SM has work; the
    fewest when no choice reaches that. Blocks are whole warps; at most 8
    groups of more than one warp (their named barriers) and 512 threads."""
    if not fft_supported(nfft):
        raise ValueError(f"no FFT plan for nfft={nfft}: a power of two in "
                         f"[{MIN_NFFT}, {MAX_NFFT}]")
    t = threads_per_fft(nfft)
    g_min = max(1, 32 // t)
    g_max = MAX_THREADS // t if t <= 32 else min(MAX_NAMED_GROUPS, MAX_THREADS // t)
    choices = [1 << e for e in range(int(math.log2(g_max)), int(math.log2(g_min)) - 1, -1)
               if smem_bytes(nfft, win, hop, 1 << e) <= SMEM_MAX]
    if not choices:
        raise ValueError(f"no FFT plan fits shared memory: nfft={nfft} win={win} hop={hop}")
    g = next((c for c in choices if signals * -(-nf // (2 * c)) >= 2 * SMS), choices[-1])
    per_signal = -(-nf // (2 * g))
    return StftPlan(nfft, g, g * t, per_signal, signals * per_signal,
                    smem_bytes(nfft, win, hop, g))


def split_smem_bytes(nfft: int, win: int, hop: int, ffts: int) -> int:
    """The split kernel's dynamic shared memory: the span of 2 · ``ffts``
    frames, the P-point quarter twiddle table of stage 1, the nfft-point
    quarter table of the split's twiddles, one exchange buffer of nfft
    points per transform."""
    _, p = split_factors(nfft)
    return (4 * span_floats(2 * ffts, win, hop)
            + 8 * (twiddle_entries(p) + twiddle_entries(nfft) + ffts * exchange_entries(nfft)))


@dataclass(frozen=True)
class SplitPlan:
    nfft: int
    m: int                # odd factor: stage 2's m-point DFTs
    p: int                # power-of-two factor: stage 1's P-point FFTs
    ffts_per_block: int   # transforms (nfft points, 2 frames each) per block
    threads: int          # per block: ffts_per_block · m · P/16
    blocks_per_signal: int
    blocks: int
    smem_bytes: int


@lru_cache(maxsize=64)
def split_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> SplitPlan:
    """The split kernel's launch, as ``csrc/stft_dft.cu::stft_split_launch``
    checks it. A transform of nfft = m · P points is one group of m · P/16
    threads: stage 1 runs m P-point FFTs of P/16 threads each (the core's
    passes), stage 2 P m-point DFTs over the same threads, and the block
    synchronizes as a whole, so groups may share warps. m is odd, so a
    block of G groups is whole warps when G · P/16 is a multiple of 32:
    G a power of two from max(1, 32 / (P/16)) up to 512 threads. Of those
    that fit shared memory, the most that still give two blocks per SM,
    else the fewest (as :func:`stft_plan`)."""
    f = split_factors(nfft)
    if f is None:
        raise ValueError(f"no split plan for nfft={nfft}: m · 2^a with m in {SPLIT_ODD}, "
                         f"2^a >= {MIN_NFFT}, at most {MAX_NFFT}")
    m, p = f
    t = nfft // POINTS
    g_min = max(1, 32 // threads_per_fft(p))
    choices = [g for g in (1 << e for e in range(10)) if g >= g_min and g * t <= MAX_THREADS
               and split_smem_bytes(nfft, win, hop, g) <= SMEM_MAX][::-1]
    if not choices:
        raise ValueError(f"no split plan fits: nfft={nfft} win={win} hop={hop}")
    g = next((c for c in choices if signals * -(-nf // (2 * c)) >= 2 * SMS), choices[-1])
    per_signal = -(-nf // (2 * g))
    return SplitPlan(nfft, m, p, g, g * t, per_signal, signals * per_signal,
                     split_smem_bytes(nfft, win, hop, g))


@dataclass(frozen=True)
class BluesteinPlan:
    nfft: int
    m: int                # the convolution's power-of-two length
    ffts_per_block: int   # transforms (2 frames each) per block
    threads: int          # per block: ffts_per_block · M/16
    blocks_per_signal: int
    blocks: int
    smem_bytes: int


@lru_cache(maxsize=64)
def bluestein_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> BluesteinPlan:
    """The Bluestein kernel's launch, as ``csrc/stft_dft.cu::
    stft_bluestein_launch`` checks it: groups of :func:`bluestein_threads`,
    the fewest a block that make it whole warps (one transform a block from
    M 512 on), its shared memory :func:`bluestein_smem_bytes` (the chirp
    tables stay in global memory). One transform a block measured fastest
    at W 1000, 1792 and 4000 on an H100 (``tools/torch_fft_plan_study.py``,
    PERF.md)."""
    if not bluestein_supported(nfft):
        raise ValueError(f"no Bluestein plan for nfft={nfft}: at most 8192, neither a power "
                         f"of two nor a split size")
    m = bluestein_size(nfft)
    t = bluestein_threads(m)
    g = max(1, 32 // t)
    smem = bluestein_smem_bytes(nfft, win, hop, g)
    if smem > SMEM_MAX:
        raise ValueError(f"no Bluestein plan fits: nfft={nfft} win={win} hop={hop}")
    per_signal = -(-nf // (2 * g))
    return BluesteinPlan(nfft, m, g, g * t, per_signal, signals * per_signal, smem)


def blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks of ``threads`` with ``smem`` bytes that one SM holds at once,
    by shared memory and threads (registers: ptxas decides; see PERF.md)."""
    return min(SM_SMEM // (smem + BLOCK_RESERVED), SM_THREADS // threads, SM_BLOCKS)


def istft_smem_bytes(nfft: int, win: int, hop: int, groups: int) -> int:
    """The inverse kernel's dynamic shared memory: the quarter twiddle
    table (on the split, the P-point one and the nfft-point one; on
    Bluestein, :func:`bluestein_table_entries` at M), one exchange buffer
    per group (of M points on Bluestein), the carry of win/hop − 1 hop
    rows."""
    split = split_factors(nfft)
    if fft_supported(nfft) or split:
        tables = twiddle_entries(nfft) + (twiddle_entries(split[1]) if split else 0)
        points = nfft
    else:
        points = bluestein_size(nfft)
        tables = bluestein_table_entries(points)
    return 8 * (tables + groups * exchange_entries(points)) + 4 * (win // hop - 1) * hop


@dataclass(frozen=True)
class IstftPlan:
    nfft: int
    groups: int           # FFT groups per block (2 frames each); 0: the direct sum
    threads: int          # per block
    rounds: int           # rounds of 2·groups frames per block (1 for the direct sum)
    rows: int             # hop rows a block owns
    blocks_per_signal: int
    blocks: int
    smem_bytes: int
    blocks_per_sm: int    # by shared memory and threads
    halo: float           # recomputed share of the transforms: (win/hop − 1) / rows
    note: str             # why a block has an SM to itself, where it does
    cluster: int = 1      # blocks of a cluster that share one transform (1: none)
    route: str = "fft"    # the kernel: fft, split, bluestein, cluster, cluster_dit,
                          # cluster_mixed or direct


@lru_cache(maxsize=64)
def istft_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> IstftPlan:
    """The inverse kernel's launch, as ``csrc/istft.cu::istft_launch`` and
    ``istft_split_launch`` compute it. Powers of two: the most groups per
    block (a power of two, whole warps, at most 8 named-barrier groups, 512
    threads) that still leaves two blocks per SM by shared memory (else the
    fewest that fit, and the note says so), then the fewest rounds of
    2·groups frames whose rows (2·groups·rounds − (win/hop − 1)) keep the
    recomputed share at or under 3/16. The split's sizes (m · P): the
    fewest groups of m · P/16 threads that make the block whole warps
    (G · P/16 a multiple of 32: m is odd; they synchronize as a block), the
    rounds by the same rule; the fewest groups measured fastest at 768 and
    1280 on an H100 (``tools/torch_fft_plan_study.py``, PERF.md). The other
    sizes up to 8192, odd ones too (Bluestein run backwards,
    ``istft_bluestein_launch``): the fewest groups of
    :func:`bluestein_threads` that make the block whole warps, as
    :func:`bluestein_plan`, one on the level, the rounds by the same rule.
    Past 8192, up to :data:`CLUSTER_NFFT`: :func:`istft_cluster_plan`, the
    powers of two there (16 384, 32 768, 65 536)
    :func:`istft_cluster_dit_plan`, the 7-smooth sizes in
    :data:`ISTFT_MIXED_WON` :func:`istft_cluster_mixed_plan`; up to
    :data:`LEVEL2_NFFT`: the second level's :func:`level2_plan`, the
    7-smooth sizes in :data:`ISTFT_LEVEL2_DIRECT_WON` its direct transform's
    :func:`level2_direct_plan`. Other sizes: the direct sum, up to 16 hop
    rows per block. ``route`` names the kernel. A plan that does not fit
    shared memory raises ``ValueError``."""
    if cluster_supported(nfft):
        if nfft & (nfft - 1) == 0:
            return istft_cluster_dit_plan(signals, nf, nfft, win, hop)
        if nfft in ISTFT_MIXED_WON:
            return istft_cluster_mixed_plan(signals, nf, nfft, win, hop)
        return istft_cluster_plan(signals, nf, nfft, win, hop)
    if level2_supported(nfft):
        if nfft in ISTFT_LEVEL2_DIRECT_WON:
            return level2_direct_plan(signals, nf, nfft, win, hop)
        return level2_plan(signals, nf, nfft, win, hop)
    k = win // hop
    split = split_factors(nfft)
    blue = not (fft_supported(nfft) or split) and bluestein_supported(nfft)
    if not (fft_supported(nfft) or split or blue):
        return istft_direct_plan(signals, nf, nfft, win, hop)
    if split:
        t = threads_per_fft(nfft)
        g_min = g_max = max(1, 32 // threads_per_fft(split[1]))
    elif blue:
        t = bluestein_threads(bluestein_size(nfft))
        g_min = g_max = max(1, 32 // t)
    else:
        t = threads_per_fft(nfft)
        g_min = max(1, 32 // t)
        g_max = MAX_THREADS // t if t <= 32 else min(MAX_NAMED_GROUPS, MAX_THREADS // t)
    fits = [1 << e for e in range(int(math.log2(g_max)), int(math.log2(g_min)) - 1, -1)
            if istft_smem_bytes(nfft, win, hop, 1 << e) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"no iSTFT plan fits shared memory: nfft={nfft} win={win} hop={hop}")
    two = [g for g in fits if blocks_per_sm(istft_smem_bytes(nfft, win, hop, g), g * t) >= 2]
    need = max(1, math.ceil((k - 1) / MAX_HALO))

    def plan(g: int) -> IstftPlan:
        smem = istft_smem_bytes(nfft, win, hop, g)
        rounds = -(-(need + k - 1) // (2 * g))
        rows = 2 * g * rounds - (k - 1)
        per = -(-(nf + k - 1) // rows)
        note = "" if two else (f"one block per SM: {smem} bytes of shared memory (the "
                               f"exchange buffer and the {k - 1}-row carry)")
        return IstftPlan(nfft, g, g * t, rounds, rows, per, signals * per, smem,
                         blocks_per_sm(smem, g * t), (k - 1) / rows, note,
                         route="split" if split else "bluestein" if blue else "fft")

    # the most groups whose grid still gives every SM two blocks; else the
    # fewest (the most blocks)
    plans = [plan(g) for g in (two or fits[-1:])]
    return next((p for p in plans if p.blocks >= 2 * SMS), plans[-1])


@lru_cache(maxsize=64)
def istft_cluster_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> IstftPlan:
    """The inverse cluster kernel's launch, as ``csrc/istft.cu::
    istft_cluster_launch`` computes it: a cluster of C = M / 8192 blocks of
    512 threads owns R hop rows of a signal and transforms one pair of
    frames a round, R = 2 · rounds − (k − 1), k = win/hop; each block
    gathers its 1/C of every row's columns and keeps their carry. A
    signal of few frames gives few clusters, and the 3/16 halo rule of
    :func:`istft_plan` would spill two of its 32 clusters of 4 (W 10 000,
    hop 2500, 532 frames) into a second wave, so the rounds are weighed as
    :func:`wiener_plan` weighs them: over every rounds with R >= 1, up to
    one row range a signal or ``MAX_ROUNDS``, the least waves × rounds
    (:data:`CLUSTERS_AT_ONCE` a wave), ties to fewer transforms (route
    "cluster"). :func:`istft_plan` takes it off the powers of two;
    ``istft_bluestein_cluster_pallas`` forces it there too."""
    if not cluster_supported(nfft) or win > nfft:
        raise ValueError(f"no iSTFT cluster plan for nfft={nfft}: past {MAX_NFFT}, at most "
                         f"{CLUSTER_NFFT}, and at least the window")
    return _istft_cluster_rounds(signals, nf, nfft, win, hop, cluster_blocks(nfft), "cluster")


@lru_cache(maxsize=64)
def istft_cluster_dit_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> IstftPlan:
    """The inverse's launch at the powers of two past 8192 (16 384, 32 768
    and 65 536), as ``csrc/istft.cu::istft_cluster_dit_launch`` computes
    it: the direct transform by decimation in time over a cluster of C =
    nfft / 8192 blocks (2, 4 or 8) of 512 threads, no chirp; a cluster owns
    R hop rows of a signal and transforms one pair of frames a round, the
    rounds weighed as :func:`istft_cluster_plan` weighs them (route
    "cluster_dit")."""
    if not MAX_NFFT < nfft <= CLUSTER_NFFT or nfft & (nfft - 1) or win > nfft:
        raise ValueError(f"no iSTFT cluster_dit plan for nfft={nfft}: a power of two past "
                         f"{MAX_NFFT}, at most {CLUSTER_NFFT}, and at least the window")
    return _istft_cluster_rounds(signals, nf, nfft, win, hop, nfft // CLUSTER_PART,
                                 "cluster_dit")


@lru_cache(maxsize=64)
def istft_cluster_mixed_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> IstftPlan:
    """The inverse's launch at the 7-smooth sizes past 8192
    (:func:`mixed_factors`: 10 000, 14 000, 20 000, 40 000, the odd 11 025,
    44 100, ...), as ``csrc/istft.cu::istft_cluster_mixed_launch`` computes
    it: the direct transform by decimation in time over a cluster of C
    blocks (2 to 8) of 512
    threads, each block's n = nfft / C points on the mixed-radix core, its
    shared memory :func:`cluster_mixed_smem_bytes`; the rounds weighed as
    :func:`istft_cluster_plan` weighs them (route "cluster_mixed").
    :func:`istft_plan` takes it at :data:`ISTFT_MIXED_WON`;
    ``launch_istft(cluster_mixed=True)`` forces it at any of its sizes."""
    f = mixed_factors(nfft)
    if f is None or win > nfft:
        raise ValueError(f"no iSTFT cluster_mixed plan for nfft={nfft}: past {MAX_NFFT}, at "
                         f"most {CLUSTER_NFFT}, not a power of two, C · n with C <= 8 and n "
                         "7-smooth, and at least the window")
    c, n = f
    return _istft_cluster_rounds(signals, nf, nfft, win, hop, c, "cluster_mixed",
                                 lambda carry: cluster_mixed_smem_bytes(n, carry))


def _istft_cluster_rounds(signals: int, nf: int, nfft: int, win: int, hop: int, c: int,
                          route: str, smem_of=cluster_smem_bytes) -> IstftPlan:
    """An inverse cluster launch of C = ``c`` blocks a cluster: each
    block's shared memory ``smem_of`` (:func:`cluster_smem_bytes`) the carry
    of its 1/C of the columns; over every rounds with R >= 1, up to one row
    range a signal or ``MAX_ROUNDS``, the least waves × rounds, ties to
    fewer transforms."""
    k = win // hop
    total_rows = nf + k - 1
    smem = smem_of((k - 1) * -(-hop // c))  # at most 166 KB: win/hop <= 9
    fewest = -(-k // 2)  # the fewest rounds with R >= 1
    best = None
    for rounds in range(fewest, max(fewest, min(-(-(total_rows + k - 1) // 2), MAX_ROUNDS)) + 1):
        rows = 2 * rounds - (k - 1)
        per = -(-total_rows // rows)
        waves = -(-signals * per // CLUSTERS_AT_ONCE[c])
        key = (waves * rounds, signals * per * rounds)
        if best is None or key < best[0]:
            best = (key, IstftPlan(nfft, 1, threads_per_fft(CLUSTER_PART), rounds, rows, per,
                                   signals * per * c, smem, 1, (k - 1) / rows,
                                   "one block per SM: 512 threads at 128 registers", c, route))
    return best[1]


@lru_cache(maxsize=16)
def istft_direct_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> IstftPlan:
    """The direct sum's launch (``istft_launch`` with groups 0): one
    512-thread block a range of up to 16 hop rows, the e^{−2πi m/N} table,
    the spectrum and the rows' accumulators in shared memory. :func:`istft_plan`
    takes it for even sizes past the cluster's 65 536 (where its table and
    spectrum no longer fit: it refuses them); ``istft_direct_pallas``
    forces it at any even size."""
    k = win // hop
    rows = min(DIRECT_MAX_ROWS, (DIRECT_SMEM_BUDGET - 16 * nfft) // (4 * hop))
    if rows < 1:
        raise ValueError(f"no iSTFT plan fits shared memory: nfft={nfft} hop={hop}")
    smem = 16 * nfft + 4 * rows * hop
    per = -(-(nf + k - 1) // rows)
    return IstftPlan(nfft, 0, DIRECT_THREADS, 1, rows, per, signals * per, smem,
                     blocks_per_sm(smem, DIRECT_THREADS), (k - 1) / rows, "direct sum",
                     route="direct")


def wiener_smem_bytes(nfft: int, hop: int, groups: int) -> int:
    """The Wiener+iSTFT kernel's dynamic shared memory: the quarter twiddle
    table, one exchange buffer per group, the carry of nfft/hop − 1 hop rows
    for each of the block's two sources."""
    return (8 * (twiddle_entries(nfft) + groups * exchange_entries(nfft))
            + 8 * (nfft // hop - 1) * hop)


def wiener_split_smem_bytes(nfft: int, hop: int, groups: int) -> int:
    """The split's (``wiener_common.cuh::wiener_split_smem_bytes``): the
    P-point and nfft-point quarter tables, one nfft-point exchange buffer
    per group, the two sources' carries."""
    _, p = split_factors(nfft)
    return (8 * (twiddle_entries(p) + twiddle_entries(nfft) + groups * exchange_entries(nfft))
            + 8 * (nfft - hop))


def wiener_bluestein_smem_bytes(nfft: int, hop: int, groups: int, carries: int) -> int:
    """Bluestein's (``wiener_common.cuh::wiener_bluestein_smem_bytes``): the
    tables at M = :func:`bluestein_size`, one M-point exchange buffer per
    group, ``carries`` carries of nfft/hop − 1 hop rows (two for a pair of
    sources, one for a pair of frames)."""
    m = bluestein_size(nfft)
    return (8 * (bluestein_table_entries(m) + groups * exchange_entries(m))
            + 4 * carries * (nfft - hop))


def wiener_direct_smem_bytes(nfft: int, hop: int, rows: int) -> int:
    """The direct sum's: the e^{−2πi m/N} table, the spectrum, two sources'
    accumulators of ``rows`` hop rows."""
    return 16 * nfft + 8 * rows * hop


@dataclass(frozen=True)
class WienerPlan:
    nfft: int
    groups: int           # FFT groups per block (a frame each, two with frame_pairs); 0: direct
    threads: int          # per block
    rounds: int           # rounds of ``groups`` frames per block (1 for the direct sum)
    rows: int             # hop rows a block owns
    pairs: int            # blocks per row range: a pair of sources each (a source: frame_pairs)
    blocks_per_signal: int  # row ranges per track
    blocks: int
    smem_bytes: int
    blocks_per_sm: int    # by shared memory, threads and registers
    waves: int            # blocks over blocks_per_sm · SMS, rounded up
    halo: float           # recomputed share of the transforms: (nfft/hop − 1) / rows
    cluster: int = 1      # blocks of a cluster that share one transform (1: none)
    route: str = "fft"    # the kernel: fft, split, bluestein, cluster, cluster_dit or direct
    frame_pairs: bool = False  # Bluestein on the level: a block one source, a group two frames


@lru_cache(maxsize=64)
def wiener_plan(signals: int, S: int, nf: int, nfft: int, hop: int) -> WienerPlan:
    """The Wiener+iSTFT kernel's launch, as ``csrc/wiener_istft.cu::
    wiener_istft_launch`` computes it. A block owns one pair of sources
    (ceil(S/2) blocks per row range) and R hop rows, transformed in rounds
    of G frames (R = G·rounds − (k − 1), k = nfft/hop). Powers of two (the
    core, ``route`` "fft"): over G (a power of two, whole warps, at most 8
    named-barrier groups, 512 threads, within shared memory) and rounds (R
    >= 1, up to one row range a track or ``MAX_ROUNDS``), the plan with the
    least waves × rounds, each SM holding as many blocks as shared memory,
    threads and ``REGS_PER_THREAD`` registers allow; ties go to fewer
    transforms, then more groups. The split's sizes ("split") and the other
    even sizes up to 8192 ("bluestein"): G as :func:`istft_plan` takes it
    for the split and for Bluestein (the fewest groups that make the block
    whole warps; one 512-thread group on the level), the rounds by the same
    rule. On the level, where the two sources' carries do not fit beside
    its tables and exchange buffer, a block takes one source (S blocks per
    row range) and a group two of its frames a round (``frame_pairs``, R =
    2G·rounds − (k − 1)). Even sizes past 8192: :func:`wiener_cluster_plan`,
    the powers of two there :func:`wiener_cluster_dit_plan`, the 7-smooth
    sizes in :data:`WIENER_MIXED_WON` :func:`wiener_cluster_mixed_plan`. The
    direct sum is only forced (:func:`wiener_direct_plan`)."""
    if MAX_NFFT < nfft <= WIENER_CLUSTER_NFFT:
        if nfft & (nfft - 1) == 0:
            return wiener_cluster_dit_plan(signals, S, nf, nfft, hop)
        if nfft in WIENER_MIXED_WON:
            return wiener_cluster_mixed_plan(signals, S, nf, nfft, hop)
        return wiener_cluster_plan(signals, S, nf, nfft, hop)
    if nfft % 2 or not MIN_NFFT <= nfft <= MAX_NFFT or hop < 1 or nfft % hop:
        raise ValueError(f"no Wiener+iSTFT plan for nfft={nfft} hop={hop}: even, {MIN_NFFT} to "
                         f"{WIENER_CLUSTER_NFFT}, a multiple of the hop")
    k = nfft // hop
    total_rows = nf + k - 1
    split = split_factors(nfft)
    frame_pairs = False
    if fft_supported(nfft):
        route, t = "fft", threads_per_fft(nfft)
        g_max = MAX_THREADS // t if t <= 32 else min(MAX_NAMED_GROUPS, MAX_THREADS // t)
        groups = [1 << e for e in range(int(math.log2(max(1, 32 // t))), int(math.log2(g_max)) + 1)]

        def smem(g):
            return wiener_smem_bytes(nfft, hop, g)
    elif split:
        route, t = "split", threads_per_fft(nfft)
        groups = [max(1, 32 // threads_per_fft(split[1]))]

        def smem(g):
            return wiener_split_smem_bytes(nfft, hop, g)
    else:
        route, t = "bluestein", bluestein_threads(bluestein_size(nfft))
        groups = [max(1, 32 // t)]
        frame_pairs = (bluestein_size(nfft) > MAX_NFFT
                       and wiener_bluestein_smem_bytes(nfft, hop, groups[0], 2) > SMEM_MAX)

        def smem(g):
            return wiener_bluestein_smem_bytes(nfft, hop, g, 1 if frame_pairs else 2)
    units = S if frame_pairs else -(-S // 2)  # blocks per row range
    best = None
    for g in groups:
        if smem(g) > SMEM_MAX:
            continue
        bps = wiener_blocks_per_sm(smem(g), g * t)
        frames = 2 * g if frame_pairs else g  # a round's
        # from the fewest rounds (R >= 1) to those of one row range a track
        fewest = -(-k // frames)
        for rounds in range(fewest, max(fewest, min(-(-(total_rows + k - 1) // frames),
                                                     MAX_ROUNDS)) + 1):
            rows = frames * rounds - (k - 1)
            per = -(-total_rows // rows)
            blocks = signals * per * units
            waves = -(-blocks // (bps * SMS))
            key = (waves * rounds, blocks * rounds * g, -g)
            if best is None or key < best[0]:
                best = (key, WienerPlan(nfft, g, g * t, rounds, rows, units, per, blocks,
                                        smem(g), bps, waves, (k - 1) / rows, route=route,
                                        frame_pairs=frame_pairs))
    if best is None:
        raise ValueError(f"no Wiener+iSTFT plan fits shared memory: nfft={nfft} hop={hop}")
    return best[1]


@lru_cache(maxsize=16)
def wiener_direct_plan(signals: int, S: int, nf: int, nfft: int, hop: int) -> WienerPlan:
    """The direct sum's launch (``wiener_istft_launch`` with groups 0), which
    only ``wiener_direct_pallas`` forces: even nfft up to 8192 off the core,
    one 512-thread block per pair of sources and range of up to 16 hop rows,
    the e^{−2πi m/N} table, the spectrum and the two sources' accumulators
    in shared memory."""
    if nfft % 2 or not MIN_NFFT <= nfft <= MAX_NFFT or fft_supported(nfft) or hop < 1 or nfft % hop:
        raise ValueError(f"no Wiener+iSTFT direct sum for nfft={nfft} hop={hop}: even, "
                         f"{MIN_NFFT} to {MAX_NFFT}, not a power of two, a multiple of the hop")
    k = nfft // hop
    pairs = -(-S // 2)
    rows = min(DIRECT_MAX_ROWS, (DIRECT_SMEM_BUDGET - 16 * nfft) // (8 * hop))
    if rows < 1:
        raise ValueError(f"no Wiener+iSTFT direct sum fits shared memory: nfft={nfft} hop={hop}")
    smem = wiener_direct_smem_bytes(nfft, hop, rows)
    per = -(-(nf + k - 1) // rows)
    bps = wiener_blocks_per_sm(smem, DIRECT_THREADS)
    blocks = signals * per * pairs
    return WienerPlan(nfft, 0, DIRECT_THREADS, 1, rows, pairs, per, blocks, smem, bps,
                      -(-blocks // (bps * SMS)), (k - 1) / rows, route="direct")


@lru_cache(maxsize=64)
def wiener_cluster_plan(signals: int, S: int, nf: int, nfft: int, hop: int) -> WienerPlan:
    """The Wiener+iSTFT's Bluestein cluster launch, as ``csrc/wiener_istft.cu::
    wiener_cluster_launch`` computes it: even nfft past 8192 up to
    :data:`WIENER_CLUSTER_NFFT` (``wiener_plan`` sends the powers of two to
    :func:`wiener_cluster_dit_plan`; a forced call runs this kernel there
    too), a cluster of C = M / 8192 blocks (4 or 8) of 512 threads owns one
    pair of sources and R hop rows of a track and transforms one frame of
    the pair a round, R = rounds − (k − 1), k = nfft/hop; each block keeps
    the two sources' carries of its 1/C of the columns. The rounds are
    weighed by :func:`_cluster_rounds`."""
    if not MAX_NFFT < nfft <= WIENER_CLUSTER_NFFT or nfft % 2 or hop < 1 or nfft % hop:
        raise ValueError(f"no Wiener+iSTFT cluster plan for nfft={nfft} hop={hop}: even, past "
                         f"{MAX_NFFT}, at most {WIENER_CLUSTER_NFFT}, a multiple of the hop")
    return _cluster_rounds(signals, S, nf, nfft, hop, cluster_blocks(nfft), "cluster")


@lru_cache(maxsize=64)
def wiener_cluster_dit_plan(signals: int, S: int, nf: int, nfft: int, hop: int) -> WienerPlan:
    """The Wiener+iSTFT's launch at the powers of two past 8192 (16 384 and
    32 768), as ``csrc/wiener_istft.cu::wiener_cluster_dit_launch`` computes
    it: the direct transform by decimation in time over a cluster of C =
    nfft / 8192 blocks (2 or 4) of 512 threads, a cluster a pair of sources
    and R hop rows, one frame a round, the rounds weighed by
    :func:`_cluster_rounds` (route "cluster_dit")."""
    if not MAX_NFFT < nfft <= WIENER_CLUSTER_NFFT or nfft & (nfft - 1) or hop < 1 or nfft % hop:
        raise ValueError(f"no Wiener+iSTFT cluster_dit plan for nfft={nfft} hop={hop}: a power "
                         f"of two past {MAX_NFFT}, at most {WIENER_CLUSTER_NFFT}, a multiple of "
                         "the hop")
    return _cluster_rounds(signals, S, nf, nfft, hop, nfft // CLUSTER_PART, "cluster_dit")


WIENER_MIXED_MIN_SHARE = 4 * MAX_THREADS  # bins: the mask loads' four unguarded strides a thread


def wiener_mixed_factors(nfft: int) -> tuple[int, int] | None:
    """(C, n) for a size the Wiener+iSTFT's mixed cluster takes
    (``csrc/wiener_istft.cu::wiener_cluster_mixed_launch``):
    :func:`mixed_factors` of an even nfft up to :data:`WIENER_CLUSTER_NFFT`
    whose last block masks at least :data:`WIENER_MIXED_MIN_SHARE` bins
    (its mask loads read four strides of 512 threads unguarded). 149
    sizes: the 136 on C 2 or 4 (8232 to 32 400) and 13 on C 3, 5 or 6
    (17 010, 18 522, 18 750, 20 250, 21 870, 22 050 and 23 814 on 3;
    24 010, 26 250, 28 350, 30 870 and 31 250 on 5; 30 618 on 6). Not 17 150 =
    5 · 3430, whose last block's share is 1715 bins."""
    f = mixed_factors(nfft) if nfft % 2 == 0 and nfft <= WIENER_CLUSTER_NFFT else None
    if f is None:
        return None
    half = nfft // 2
    if half - (f[0] - 1) * -(-half // f[0]) < WIENER_MIXED_MIN_SHARE:
        return None
    return f


@lru_cache(maxsize=64)
def wiener_cluster_mixed_plan(signals: int, S: int, nf: int, nfft: int, hop: int) -> WienerPlan:
    """The Wiener+iSTFT's launch at the 7-smooth sizes past 8192 up to
    :data:`WIENER_CLUSTER_NFFT` (:func:`wiener_mixed_factors`: 149 even
    sizes from 8232 to 32 400, 10 000, 14 000, 20 000 and 22 050 among
    them), as ``csrc/wiener_istft.cu::wiener_cluster_mixed_launch``
    computes it: the direct transform by decimation in time over a cluster
    of C blocks (2 to 6) of 512 threads, each block's n = nfft / C points
    on the mixed-radix core, a cluster a pair of sources and R hop rows, one
    frame a round, each block's shared memory :func:`cluster_mixed_smem_bytes`
    with the two sources' carries; the rounds weighed by
    :func:`_cluster_rounds` (route "cluster_mixed"). :func:`wiener_plan`
    takes it at :data:`WIENER_MIXED_WON`."""
    f = wiener_mixed_factors(nfft)
    if f is None or hop < 1 or nfft % hop:
        raise ValueError(f"no Wiener+iSTFT cluster_mixed plan for nfft={nfft} hop={hop}: even, "
                         f"past {MAX_NFFT}, at most {WIENER_CLUSTER_NFFT}, not a power of two, "
                         "C · n with n 7-smooth, the last block's share at least "
                         f"{WIENER_MIXED_MIN_SHARE} bins, a multiple of the hop")
    c, n = f
    return _cluster_rounds(signals, S, nf, nfft, hop, c, "cluster_mixed",
                           lambda carry: cluster_mixed_smem_bytes(n, carry))


def _cluster_rounds(signals: int, S: int, nf: int, nfft: int, hop: int, c: int,
                    route: str, smem_of=cluster_smem_bytes) -> WienerPlan:
    """A Wiener cluster launch of C = ``c`` blocks a cluster: the grid is
    tracks × row ranges × pairs clusters, each block's shared memory
    ``smem_of`` (:func:`cluster_smem_bytes`) the two sources' carries of its
    1/C of the columns (``ValueError`` past :data:`SMEM_MAX`), and over
    every rounds with R >= 1, up to one row range a track or
    ``MAX_ROUNDS``, the least waves × rounds (:data:`CLUSTERS_AT_ONCE` a
    wave: one block an SM, as the kernels' launch bound of one block an SM
    lets each instance take 128 registers), ties to fewer transforms.
    ``blocks`` counts blocks, ``waves`` clusters over the card's count."""
    k = nfft // hop
    pairs = -(-S // 2)
    total_rows = nf + k - 1
    smem = smem_of(2 * (k - 1) * -(-hop // c))
    if smem > SMEM_MAX:
        raise ValueError(f"no Wiener+iSTFT {route} plan fits shared memory: nfft={nfft} "
                         f"hop={hop} needs {smem} bytes a block")
    best = None
    for rounds in range(k, max(k, min(total_rows + k - 1, MAX_ROUNDS)) + 1):
        rows = rounds - (k - 1)
        per = -(-total_rows // rows)
        clusters = signals * per * pairs
        waves = -(-clusters // CLUSTERS_AT_ONCE[c])
        key = (waves * rounds, clusters * rounds)
        if best is None or key < best[0]:
            best = (key, WienerPlan(nfft, 1, threads_per_fft(CLUSTER_PART), rounds, rows, pairs,
                                    per, clusters * c, smem, 1, waves, (k - 1) / rows, c,
                                    route=route))
    return best[1]


def wiener_blocks_per_sm(smem: int, threads: int) -> int:
    """:func:`blocks_per_sm` with the registers too, at ``REGS_PER_THREAD``."""
    return max(1, min(blocks_per_sm(smem, threads), SM_REGS // (threads * REGS_PER_THREAD)))


def twiddle_table(nfft: int) -> np.ndarray:
    """(nfft, 2) float32: e^{−2πi m / nfft} = (cos, −sin), 4 | nfft. The
    first quadrant (m < nfft/4) is computed in float64 and rounded once;
    the others are it times (−i)^q, exact swaps and negations, as the
    kernels turn it (``Fft::twiddle``, ``quarter_twiddle``)."""
    q = nfft // 4
    ang = 2.0 * np.pi * np.arange(q) / nfft
    c, s = np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)
    quads = [(c, s), (s, -c), (-c, -s), (-s, c)]
    return np.concatenate([np.stack(p, -1) for p in quads])


@lru_cache(maxsize=16)
def twiddles(nfft: int, device: str) -> torch.Tensor:
    """The first quadrant of :func:`twiddle_table` (nfft/4 rows), which the
    kernels copy into shared memory, on ``device``, made once per (nfft,
    device): a power of two for the core, and for the split both its P and
    its nfft (the split's twiddles e^{−2πi n1 k1 / nfft})."""
    return torch.from_numpy(np.ascontiguousarray(twiddle_table(nfft)[: nfft // 4])).to(device)


@lru_cache(maxsize=8)
def bluestein_tables(nfft: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(conj c_t for t < nfft, Ĉ / M) as (n, 2) float32 on ``device``, made
    once per (nfft, device): c_t = e^{iπ t²/nfft}, its angle π ((t² mod 2
    nfft) / nfft) from the integer t², so the phase is exact before the one
    rounding to float32; Ĉ the M-point FFT of the wrapped chirp (c_n at n <
    nfft and at M − n, 0 < n < nfft), in float64. Any nfft: up to 8192 for
    the one-block kernels, up to :data:`CLUSTER_NFFT` (M 131 072) for the
    cluster's, up to :data:`LEVEL2_NFFT` (M 524 288) for the second level's
    (which reads Ĉ through :func:`level2_chat`)."""
    m = bluestein_size(nfft)
    t = np.arange(nfft, dtype=np.int64)
    c = np.exp(1j * np.pi * ((t * t) % (2 * nfft)) / nfft)
    wrapped = np.zeros(m, np.complex128)
    wrapped[:nfft] = c
    wrapped[m - nfft + 1:] = c[1:][::-1]
    chat = np.fft.fft(wrapped) / m

    def pairs(z):
        return torch.from_numpy(np.stack([z.real, z.imag], -1).astype(np.float32)).to(device)

    return pairs(np.conj(c)), pairs(chat)


@lru_cache(maxsize=4)
def level2_chat(nfft: int, device: str) -> torch.Tensor:
    """The second level's chirp spectrum: :func:`bluestein_tables`' Ĉ / M
    (M float2) with entry R k + r stored at r · 8192 + k, so that phase
    B/C's block r reads its row of it in order."""
    m = bluestein_size(nfft)
    r = m // CLUSTER_PART
    chat = bluestein_tables(nfft, "cpu")[1]
    return chat.reshape(CLUSTER_PART, r, 2).transpose(0, 1).reshape(m, 2).to(device)


@lru_cache(maxsize=4)
def level2_direct_tables(nfft: int, device: str) -> torch.Tensor:
    """(nfft + n, 2) float32 on ``device``, made once per (nfft, device):
    the direct second level's tables, entries of :func:`dft_table` (rounded
    once from float64), R and n from :func:`level2_direct_factors`: the (R,
    n) table w^{n2 k1} at k1 · n + n2 (the combine's twiddles, read
    coalesced over n2), then the n-point table w^{R m}, m < n (the rows'
    ``mixed_fft``: the nfft-point table's entries at stride R)."""
    r, n = level2_direct_factors(nfft)
    tab = dft_table(nfft, "cpu")
    combine = tab[(torch.arange(r)[:, None] * torch.arange(n)[None, :]).reshape(-1)]
    return torch.cat([combine, tab[::r]]).to(device)


@lru_cache(maxsize=8)
def dft_table(nfft: int, device: str) -> torch.Tensor:
    """(nfft, 2) float32 e^{−2πi m / nfft}, m < nfft, made in float64: the
    inverse kernel's direct sum for sizes that are not powers of two."""
    ang = 2.0 * np.pi * np.arange(nfft) / nfft
    tab = np.stack([np.cos(ang), -np.sin(ang)], -1).astype(np.float32)
    return torch.from_numpy(tab).to(device)


_windows: list[tuple[np.ndarray, str, torch.Tensor]] = []
_windows_lock = threading.Lock()
_memcmp = ctypes.CDLL(None).memcmp
_memcmp.restype = ctypes.c_int
_memcmp.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Two contiguous float64 windows hold the same values, by a memcmp of
    their bytes: no copy, so no fresh pages to fault in (a copy of a 262
    144-point window cost more host time than the kernels' launches)."""
    return a.size == b.size and _memcmp(a.ctypes.data, b.ctypes.data, a.nbytes) == 0


def window_f32(window: np.ndarray, device: str) -> torch.Tensor:
    """The window as float32 on ``device``, copied once. Callers build a
    fresh array per call, so it is found again by comparing its bytes with
    the last few windows' (:func:`_same`), not by hashing them."""
    key = np.ascontiguousarray(window, np.float64)
    with _windows_lock:
        for i, (k, d, t) in enumerate(_windows):
            if d == device and _same(k, key):
                if i:
                    _windows.insert(0, _windows.pop(i))
                return t
        t = torch.from_numpy(key.astype(np.float32)).to(device)
        _windows.insert(0, (key.copy(), device, t))
        del _windows[8:]
        return t


_synthesis: list[tuple[np.ndarray, tuple, tuple[torch.Tensor, torch.Tensor]]] = []


def synthesis_tables(window: np.ndarray, nfft: int, hop: int, nf: int,
                     device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(window / nfft, 1 / window-power envelope of nf frames) as float32 on
    ``device``: the inverse kernel's two tables, made once per window and
    shape. A call's window is found again by comparing its float64 bytes
    with the last few (:func:`_same`; no conversion to float32, no second
    key per call)."""
    w = np.ascontiguousarray(window, np.float64)
    shape = (nfft, hop, nf, device)
    with _windows_lock:
        for i, (k, s, tabs) in enumerate(_synthesis):
            if s == shape and _same(k, w):
                if i:
                    _synthesis.insert(0, _synthesis.pop(i))
                return tabs
    key = w.copy()
    tabs = (torch.from_numpy((key / float(nfft)).astype(np.float32)).to(device),
            inverse_norm(_key(key.astype(np.float32)), hop, nf, device))
    with _windows_lock:
        _synthesis.insert(0, (key, shape, tabs))
        del _synthesis[8:]
    return tabs
