"""The fused decode kernel's design (``csrc/decoder_fused.cu``), on CPU.

* Its arithmetic, 3xTF32: a torch emulation that rounds each float32 operand
  to TF32 as the kernel does (to nearest, ties away from zero, 10 mantissa
  bits: an integer add and a mask, as ``cvt.rna.tf32.f32`` rounds), takes the
  remainder, of which the tensor core reads the TF32 bits (a truncation), and
  sums three products in float32. It meets ``chip_smoke.py``'s gate (1e-5 ×
  max|plain|) against ``band_freq_decode_plain``; one TF32 pass does not,
  which is why the kernel splits.
* Its launch plan (``decode_plan``) at the presets' and the CUDA tests'
  shapes: the block tile and cluster, shared memory, the halo, the
  recomputed share of stage 1, the K4 reads, the fc row padding; and
  ``kernel_supported``'s envelope.
* The repair around it: "auto" takes the kernel only at the TMs and
  batches at which it won on the card (``FUSED_DECODE_WON``, keyed on the
  compute dtype; the bf16 entry is empty). (The other repair, the float32
  contract, is ``test_torch_precision.py``'s.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from convsep_tpu_torch.configs import get_preset
from convsep_tpu_torch.models import convsep as tconv
from convsep_tpu_torch.models import decoder_fused_cuda as dfc
from convsep_tpu_torch.models.decoder_fused_cuda import (
    band_freq_decode_plain,
    decode_plan,
    kernel_supported,
)

TOL_DECODE_F32 = 1e-5  # × max|plain|: chip_smoke.py's gate for the kernel


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: add half a unit of the 10-bit mantissa's last place
    to the magnitude's bits (ties go away from zero), clear the 13 low bits."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_bits(x: torch.Tensor) -> torch.Tensor:
    """The TF32 bits of a float32, as the tensor core reads an operand."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """The kernel's split: hi rounded, the remainder x - hi as the tensor
    core reads it."""
    hi = tf32(x)
    return hi, tf32_bits(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's 3xTF32: small terms first, then big × big."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass: what the tensor cores give without the split."""
    return tf32(a) @ tf32(b)


def emulate(fc, k4, b3, kcat, mm):
    """band_freq_decode_plain with both products replaced by ``mm``."""
    B, J = fc.shape
    _, S, W_pad, TpC = k4.shape
    _, ktaps, TM = kcat.shape
    e = torch.relu(mm(fc, k4.reshape(J, -1)) + b3.reshape(-1)).reshape(B * S, W_pad, TpC)
    g = mm(e.reshape(-1, TpC), kcat.reshape(TpC, -1)).reshape(B * S, W_pad, ktaps, TM)
    out = e.new_zeros((B * S, W_pad + ktaps - 1, TM))
    for i in range(ktaps):
        out[:, i:i + W_pad] += g[:, :, i]
    return out[:, :W_pad].reshape(B, S, W_pad, TM)


def test_tf32_rounding():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -11, one + 2 ** -12, one + 3 * 2 ** -11,
                      -(one + 2 ** -11), 3.0e-5, -7.25], dtype=torch.float32)
    got = tf32(x)
    want = torch.tensor([one, one + 2 ** -10, one, one + 2 ** -9, -(one + 2 ** -10),
                         got[5].item(), -7.25])
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert torch.all(got.view(torch.int32) & 0x1FFF == 0)
    # 10 mantissa bits: within half a unit of 2^-10 relative
    assert abs(got[5].item() - 3.0e-5) <= 2 ** -11 * 3.0e-5
    hi, lo = split(torch.tensor([0.1, -1.7e3, 5e-8]))
    r = (hi.double() + lo.double() - torch.tensor([0.1, -1.7e3, 5e-8]).float().double()).abs()
    assert torch.all(r <= 2 ** -21 * torch.tensor([0.1, 1.7e3, 5e-8]).double())


@pytest.mark.parametrize("B,J,S,W,TpC,ktaps,TM", [
    (5, 16, 2, 13, 40, 4, 24),
    (3, 32, 1, 9, 64, 8, 120),
])
def test_split_meets_the_f32_gate_and_one_pass_does_not(rng, B, J, S, W, TpC, ktaps, TM):
    W_pad = dfc.w_pad_rows(W, ktaps)
    f32 = np.float32
    fc = torch.from_numpy(np.maximum(rng.standard_normal((B, J)), 0).astype(f32))
    k4 = torch.from_numpy((0.3 * rng.standard_normal((J, S, W_pad, TpC))).astype(f32))
    b3 = torch.from_numpy((0.1 * rng.standard_normal((S, W_pad, TpC))).astype(f32))
    kcat = torch.from_numpy((0.2 * rng.standard_normal((TpC, ktaps, TM))).astype(f32))
    want = band_freq_decode_plain(fc, k4, b3, kcat)
    tol = TOL_DECODE_F32 * want.abs().max().item()
    e3 = (emulate(fc, k4, b3, kcat, mm3) - want).abs().max().item()
    e1 = (emulate(fc, k4, b3, kcat, mm1) - want).abs().max().item()
    assert e3 <= tol, (e3, tol)
    assert e1 > 10 * tol, (e1, tol)


# (B, J, S, W_pad, TpC, ktaps, TM): highres4096, highres4096-stereo,
# multires4096, and the CUDA tests' decode cases
PLAN_SHAPES = [
    (49, 128, 4, 512, 800, 8, 120),
    (49, 128, 4, 512, 800, 8, 240),
    (49, 128, 4, 512, 800, 8, 360),
    (1, 16, 3, 40, 75, 3, 120),
    (64, 128, 4, 512, 800, 8, 384),
    (65, 128, 4, 512, 800, 8, 90),
    (7, 16, 3, 24, 75, 2, 360),
    (16, 128, 2, 64, 800, 16, 240),
    (65, 32, 2, 40, 100, 17, 360),
    (49, 128, 4, 512, 800, 17, 120),   # the reference's largest ktaps: 32-row tiles
    (49, 128, 4, 512, 800, 16, 360),
    (49, 100, 4, 512, 800, 8, 120),    # J not a multiple of 8: padded to 104
    (49, 512, 4, 512, 800, 17, 384),   # 8-row tiles, one buffer of each
]


@pytest.mark.parametrize("B,J,S,W_pad,TpC,ktaps,TM", PLAN_SHAPES)
def test_decode_plan(B, J, S, W_pad, TpC, ktaps, TM):
    p = decode_plan(B, J, S, W_pad, TpC, ktaps, TM)
    assert p.smem_bytes <= 227 * 1024
    # a row tile holds all fc rows up to bt (64 where shared memory allows),
    # padded to a multiple of 4
    assert p.bt in (64, 32, 16, 8) and (p.kc_bufs, p.k4_bufs) in ((2, 2), (1, 2), (1, 1))
    assert (p.bt, p.kc_bufs, p.k4_bufs) == (64, 2, 2) or p.kc_bufs == 1
    assert p.b_tiles == -(-B // p.bt) and p.bp == -(-min(B, p.bt) // 4) * 4
    assert p.row_padding == p.bp / min(B, p.bt)
    assert p.j_pad == -(-J // 8) * 8
    assert p.smem_bytes == dfc.smem_bytes(
        p.j_pad, ktaps, p.mi, p.ni, p.warps, p.bp + 8 if p.bp % 16 == 0 else -(-p.bp // 8) * 8,
        p.rc, p.es, p.kc_bufs, p.k4_bufs)
    # the first buffers and row tile whose halo is at most 2, else the least halo
    assert p.halo <= 2 or p.bt == 8 or ktaps > 17
    # 16 warps of 3 x 4 tiles (TM <= 256) or 12 warps of 4 x 6: MI m16 row
    # tiles a warp x NI column groups of 8 a block
    assert (p.warps, p.mi, p.ni) == ((16, 3, 4) if TM <= 256 else (12, 4, 6))
    assert p.wb * p.bp <= 16 * p.warps * p.mi
    # the cluster's blocks cover TM, at most 8 of them
    assert p.cluster * 8 * p.ni >= TM > (p.cluster - 1) * 8 * p.ni and p.cluster <= 8
    assert p.w_blocks * p.wb >= W_pad > (p.w_blocks - 1) * p.wb
    assert p.blocks == p.cluster * p.clusters == p.cluster * p.b_tiles * p.w_blocks * S
    # stage 1 is shared by the cluster: each block computes at most rc of
    # the w block's rows (its own and the halo's), K4 comes once per cluster
    assert p.rows_e == p.wb + ktaps - 1 and p.rc * p.cluster >= p.rows_e
    assert p.halo == p.rows_e / p.wb == p.stage1_recompute
    assert p.k4_reads == p.b_tiles * p.halo
    if ktaps <= 9 and W_pad >= 64:
        assert p.halo <= 1.6


def test_main_path_plans():
    """highres4096, stereo and multires4096 at B 49: one row tile (52 rows,
    not 64), stage 1 and K4 at most 1.5 times, the column tiles in one
    cluster."""
    hi = decode_plan(49, 128, 4, 512, 800, 8, 120)
    assert (hi.mi, hi.ni, hi.cluster, hi.wb, hi.rc, hi.blocks) == (3, 4, 4, 14, 6, 592)
    st = decode_plan(49, 128, 4, 512, 800, 8, 240)
    assert (st.cluster, st.rc) == (8, 3)
    mr = decode_plan(49, 128, 4, 512, 800, 8, 360)
    assert (mr.warps, mr.mi, mr.ni, mr.cluster, mr.wb, mr.rc) == (12, 4, 6, 8, 14, 3)
    for p in (hi, st, mr):
        assert p.b_tiles == 1 and p.bp == 52
        assert p.stage1_recompute <= 1.5 and p.k4_reads <= 1.5


def test_kernel_envelope():
    assert kernel_supported(128, 8, 120) and kernel_supported(128, 14, 120)
    assert kernel_supported(16, 3, 120) and kernel_supported(32, 17, 384)
    assert kernel_supported(128, 30, 120)      # one buffer of split Kcat tiles fits 227 KB
    assert not kernel_supported(128, 60, 120)  # even one outgrows it
    assert kernel_supported(12, 8, 120)        # J padded with zero columns to the mma depth 8
    assert not kernel_supported(8192, 8, 120)  # fc rows exceed shared memory
    assert not kernel_supported(128, 8, 385)   # more than 8 blocks of 48 columns
    with pytest.raises(ValueError, match="unsupported"):
        decode_plan(1, 8192, 1, 16, 8, 8, 120)


@pytest.mark.parametrize("preset,TM", [("highres4096", 120), ("highres4096-stereo", 240),
                                       ("multires4096", 360)])
@pytest.mark.parametrize("won", [{}, {120: ((1, 64),), 240: ((1, 64),), 360: ((1, 64),)},
                                 {120: ((1, 30), (40, 64))}])
def test_auto_routes_the_kernel_only_where_it_won(monkeypatch, preset, TM, won):
    cfg = get_preset(preset).model
    assert cfg.time_context * cfg.conv1_freq_stride * cfg.channels_in == TM
    monkeypatch.setattr(dfc, "FUSED_DECODE_WON", {"float32": won, "bfloat16": {}})
    cuda = torch.device("cuda")
    want = "bandconv_pallas" if TM in won else "bandconv"
    assert tconv.resolve_decoder_impl(cfg, cuda, 49) == want
    between = "bandconv_pallas" if TM in won and len(won[TM]) == 1 else "bandconv"
    assert tconv.resolve_decoder_impl(cfg, cuda, 35) == between  # between two won runs
    assert tconv.resolve_decoder_impl(cfg, cuda, 65) == "bandconv"
    assert tconv.resolve_decoder_impl(cfg, cuda) == "bandconv"  # the batch not known
    assert tconv.resolve_decoder_impl(cfg, torch.device("cpu"), 49) == "bandconv"
    forced = dataclasses.replace(cfg, decoder_impl="bandconv_pallas")
    assert tconv.resolve_decoder_impl(forced, cuda, 8) == "bandconv_pallas"
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")  # the bf16 table is empty
    assert tconv.resolve_decoder_impl(bf16, cuda, 49) == "bandconv"


@pytest.mark.parametrize("B,routed", [(8, False), (16, False), (20, True), (32, True),
                                      (36, False), (49, True), (56, False), (64, True),
                                      (65, False), (98, False), (128, True), (129, False)])
def test_auto_routes_by_batch_at_tm120(B, routed):
    """The separation paths' batches at TM 120 (highres4096): online chunks of
    8 segments, chunks of 32, a 30 s track of 49, a stream batch of two
    tracks, 98. The kernel lost at 8, 36, 56 and 98 (tools/
    torch_decode_batches.py), so "auto" takes the plain decode there; 129 was
    not timed."""
    cfg = get_preset("highres4096").model
    want = "bandconv_pallas" if routed else "bandconv"
    assert tconv.resolve_decoder_impl(cfg, torch.device("cuda"), B) == want
    assert dfc.fused_decode_won(120, B) == routed


def test_won_tms_are_inside_the_reference_rule():
    """Each TM's runs are sorted, disjoint and maximal, and hold only batches
    the sweep timed: every B of one row tile, and its ``BEYOND`` batches
    (one-point runs, since they are not consecutive)."""
    from tools.torch_decode_batches import BEYOND

    assert set(dfc.FUSED_DECODE_WON) == {"float32", "bfloat16"}
    assert dfc.FUSED_DECODE_WON["bfloat16"] == {}  # no kernel has won a bf16 A/B
    for TM, runs in dfc.FUSED_DECODE_WON["float32"].items():
        assert dfc.fused_decode_supported(800, TM, 8)
        assert runs and all(1 <= lo <= hi for lo, hi in runs)
        assert all(a[1] + 1 < b[0] for a, b in zip(runs, runs[1:]))
        for lo, hi in runs:
            assert hi <= dfc.BT or (lo == hi and lo in BEYOND)


@pytest.mark.parametrize("B", [8, 32, 49, 64])
def test_auto_routes_bf16_compute_to_the_plain_decode(B):
    """Under compute_dtype="bfloat16" "auto" takes the plain bf16 decode at
    every batch (the bf16 won table is empty); float32 keeps its routes, and
    an explicit "bandconv_pallas" stays the kernel. The CUDA device is a
    value only: no card is touched."""
    cuda = torch.device("cuda")
    cfg = get_preset("highres4096").model
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    assert tconv.resolve_decoder_impl(bf16, cuda, B) == "bandconv"
    assert not dfc.fused_decode_won(120, B, "bfloat16")
    want = "bandconv_pallas" if dfc.fused_decode_won(120, B) else "bandconv"
    assert tconv.resolve_decoder_impl(cfg, cuda, B) == want
    forced = dataclasses.replace(bf16, decoder_impl="bandconv_pallas")
    assert tconv.resolve_decoder_impl(forced, cuda, B) == "bandconv_pallas"
