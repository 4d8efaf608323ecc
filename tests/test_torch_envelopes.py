"""The port's card envelopes against the reference kernels' own admission
rules, on CPU: every shape that a Pallas kernel of the JAX package computes
(``ct_istft_kernel.ct_pallas_supported`` for the Wiener+iSTFT and the
iSTFT, ``ct_stft_kernel.ct_stft_supported`` for the fused forward STFT),
tried at every power of two from 16 to 65 536 and every hop, is a shape the
port's CUDA kernel takes, so no shape the reference computes raises on the
card; so are the reference ``istft_pallas``'s shapes (win % hop == 0 and
win/hop <= 9, at any nfft, odd ones too) up to the second level's 262 144,
the fused decode's (``fused_decode_supported``) over J 8–512, and the band
decode's (``band_decode_pallas`` checks only that the time kernel is
(kh, 1, I, O)) over the model family's widths. And the masked synthesis's "auto" never takes a kernel that lost its
timed A/B (the Wiener kernel off the core takes only the plans that won) nor
the Wiener kernel's direct sum, while the presets' routes stay where they
were."""

import numpy as np
import pytest
import torch

from convsep_tpu.dsp.pallas.ct_istft_kernel import ct_pallas_supported as jax_ct_pallas_supported
from convsep_tpu.dsp.pallas.ct_stft_kernel import ct_stft_supported as jax_ct_stft_supported
from convsep_tpu.dsp.pallas.istft_kernel import istft_pallas as jax_istft_pallas
from convsep_tpu.models.decoder_fused_pallas import (
    fused_decode_supported as jax_fused_decode_supported,
)
from convsep_tpu_torch.configs import PRESETS, get_preset
from convsep_tpu_torch.dsp.cuda import ct_istft_kernel as ck
from convsep_tpu_torch.dsp.cuda import ct_stft_kernel as cs
from convsep_tpu_torch.dsp.cuda import fft_plan as fp
from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_supported
from convsep_tpu_torch.dsp.dft import resolve_masked_synthesis
from convsep_tpu_torch.models import decoder_band_cuda as dbc
from convsep_tpu_torch.models import decoder_fused_cuda as dfc

CUDA = torch.device("cuda")  # only named: the routing rules read the device type
POWERS = [1 << e for e in range(4, 17)]  # 16 … 65 536


def _reference_shapes(rule) -> list[tuple[int, int]]:
    """(nfft, hop) at win = nfft that ``rule`` admits, over every hop 1 … nfft."""
    return [(n, hop) for n in POWERS for hop in range(1, n + 1) if rule(n, n, hop)]


def test_reference_admits_up_to_32768():
    """What the comparison below covers: the reference's Wiener+iSTFT takes
    every power of two from 256 to 32 768, its forward STFT 2048 to 16 384."""
    wiener = _reference_shapes(jax_ct_pallas_supported)
    stft = _reference_shapes(jax_ct_stft_supported)
    assert sorted({n for n, _ in wiener}) == [1 << e for e in range(8, 16)]
    assert sorted({n for n, _ in stft}) == [2048, 4096, 8192, 16384]
    assert (16384, 2048) in wiener and (32768, 4096) in wiener and (16384, 1024) in stft


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_wiener_card_envelope_holds_the_reference(p):
    """wiener_istft_supported ⊇ ct_pallas_supported at p 1 and 2: every
    (nfft, hop) where the reference's istft_ct_pallas_wiener computes stems
    (16 384 and 32 768 included, hop by hop) the card's kernel takes, and
    the masked synthesis's explicit "ct_pallas_wiener" names it."""
    shapes = _reference_shapes(jax_ct_pallas_supported)
    refused = [(n, hop) for n, hop in shapes if not ck.wiener_istft_supported(n, n, hop)]
    assert not refused, refused
    for n, hop in shapes:
        assert resolve_masked_synthesis("ct_pallas_wiener", n, n, hop, p, CUDA) == "ct_pallas_wiener"


def test_istft_card_envelope_holds_the_reference():
    """istft_ct_supported ⊇ ct_pallas_supported: the same shapes through
    the iSTFT without the mask (istft_ct_pallas) launch on the card."""
    refused = [(n, hop) for n, hop in _reference_shapes(jax_ct_pallas_supported)
               if not ck.istft_ct_supported(n, n, hop)]
    assert not refused, refused


def test_ct_stft_card_envelope_holds_the_reference():
    """kernel_supported ⊇ ct_stft_supported: every (nfft, hop) where the
    reference's stft_ct_pallas computes spectra (16 384 included) the card's
    kernel takes, and the port's own copy of the rule says the same."""
    shapes = _reference_shapes(jax_ct_stft_supported)
    refused = [(n, hop) for n, hop in shapes if not cs.kernel_supported(n, hop)]
    assert not refused, refused
    assert all(cs.ct_stft_supported(n, n, hop) for n, hop in shapes)
    assert not any(cs.ct_stft_supported(n, n, hop) for n in POWERS for hop in (1000, 1536)
                   if not jax_ct_stft_supported(n, n, hop))


@pytest.mark.parametrize("nfft,hop", [(768, 256), (1000, 250), (384, 96), (6000, 1500),
                                      (8190, 910), (18, 9)])
@pytest.mark.parametrize("p", [1.0, 2.0])
def test_auto_never_takes_the_wiener_direct_sum(nfft, hop, p):
    """At the even sizes that are not powers of two up to 8192 the Wiener
    kernel runs on the split or on Bluestein (PERF.md row 1′): "auto" takes
    it only at the (nfft, hop) where it won its A/B against the masked chain
    (WIENER_SPLIT_BLUESTEIN_WON), elsewhere the masked chain's iSTFT; the
    explicit "ct_pallas_wiener" reaches it everywhere, and neither names
    the direct sum, which only wiener_direct_pallas forces."""
    assert ck.wiener_istft_supported(nfft, nfft, hop)
    assert fp.wiener_plan(1, 4, 500, nfft, hop).route in ("split", "bluestein")
    route = resolve_masked_synthesis("auto", nfft, nfft, hop, p, CUDA)
    assert (route == "ct_pallas_wiener") == ((nfft, hop) in ck.WIENER_SPLIT_BLUESTEIN_WON)
    assert route in ("ct_pallas_wiener", "direct", "factored", "ct_pallas")
    assert resolve_masked_synthesis("ct_pallas_wiener", nfft, nfft, hop, p, CUDA) == \
        "ct_pallas_wiener"


def test_wiener_envelope_off_the_core_holds_every_even_size():
    """Every even nfft from 16 to 8192 that is not a power of two, at every
    hop nfft/k (k 1–9) that divides it and at hop 2, stays inside
    wiener_istft_supported (the direct sum took them all before the split
    and Bluestein replaced it) and runs on the split (m · 2^a) or on
    Bluestein, at any number of stems."""
    for n in range(18, 8193, 2):
        if n & (n - 1) == 0:
            continue
        route = "split" if fp.split_factors(n) else "bluestein"
        for hop in {n // k for k in range(1, 10) if n % k == 0} | {2}:
            assert ck.wiener_istft_supported(n, n, hop), (n, hop)
            assert fp.wiener_plan(1, 4, 100, n, hop).route == route, (n, hop)


@pytest.mark.parametrize("nfft,hop", [(16384, 2048), (16384, 4096), (32768, 4096),
                                      (10000, 2500), (20000, 5000)])
def test_auto_takes_a_cluster_plan_only_where_it_won(nfft, hop):
    """Past 8192 "auto" takes the Wiener kernel's cluster only at the plans
    in WIENER_CLUSTER_WON, the timed A/B's winners; elsewhere the masked
    chain's iSTFT."""
    route = resolve_masked_synthesis("auto", nfft, nfft, hop, 1.0, CUDA)
    assert (route == "ct_pallas_wiener") == ((nfft, hop) in ck.WIENER_CLUSTER_WON)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_routes_keep_the_wiener_kernel(name):
    """Every preset is a power of two up to 4096: its masked synthesis
    still takes the Wiener kernel on the card under "auto" (its launch
    counts do not move), and the plain chain on the CPU."""
    t = get_preset(name).transform
    nfft = t.nfft or t.frame_size
    assert nfft & (nfft - 1) == 0 and nfft <= 4096
    for p in (1.0, 2.0):
        assert resolve_masked_synthesis("auto", nfft, t.frame_size, t.hop_size, p, CUDA) == \
            "ct_pallas_wiener"
        assert resolve_masked_synthesis("auto", nfft, t.frame_size, t.hop_size, p,
                                        torch.device("cpu")) != "ct_pallas_wiener"


def _istft_rule_admits(win: int, hop: int) -> bool:
    """The reference ``istft_pallas``'s own checks on a shape (its source:
    win % hop == 0 and win/hop <= 9; any nfft >= win)."""
    return win % hop == 0 and win // hop <= 9


def test_istft_rule_is_the_reference_checks():
    """_istft_rule_admits refuses what the JAX ``istft_pallas`` refuses
    before it computes, and admits an odd size it computes."""
    for win, hop in ((12, 5), (100, 10), (1001, 100)):
        assert not _istft_rule_admits(win, hop)
        re = np.zeros((3, win // 2 + 1), np.float32)
        with pytest.raises(ValueError):
            jax_istft_pallas(re, re, np.ones(win), hop, hop, nfft=win, interpret=True)
    assert _istft_rule_admits(1001, 143) and _istft_rule_admits(999, 333)


def _istft_sizes() -> list[int]:
    """Every nfft from 2 to 8192; past it a sample (every 97th, the
    boundaries of the cluster and of the second level, odd and even) up to
    the second level's limit."""
    past = set(range(8193, fp.LEVEL2_NFFT + 1, 97))
    past |= {8193, 8194, 16_384, 16_385, 32_768, 32_769, 65_535, 65_536, 65_537, 65_538,
             70_000, 70_001, 99_999, 131_072, 131_073, fp.LEVEL2_NFFT - 1, fp.LEVEL2_NFFT}
    return list(range(2, 8193)) + sorted(past)


def test_istft_card_envelope_holds_the_reference_rule():
    """istft_supported ⊇ the reference ``istft_pallas``'s rule at win =
    nfft: every hop with win % hop == 0 and win/hop <= 9, at every odd and
    even nfft up to 8192 and a sample past it up to 262 144, is a shape the
    card's iSTFT takes (odd sizes on Bluestein, the cluster or the second
    level run backwards)."""
    refused = [(n, n // k) for n in _istft_sizes() for k in range(1, 10)
               if n % k == 0 and _istft_rule_admits(n, n // k) and not istft_supported(n, n, n // k)]
    assert not refused, refused[:20]
    assert istft_supported(1001, 1001, 143) and istft_supported(999, 999, 333)
    assert not istft_supported(fp.LEVEL2_NFFT + 2, fp.LEVEL2_NFFT + 2, 2)


# J 8–512 in steps of 8, and two that are not multiples of the mma depth
DECODE_JS = list(range(8, 513, 8)) + [100, 127]


def test_fused_decode_card_envelope_holds_the_reference_rule():
    """kernel_supported ⊇ fused_decode_supported: every (ktaps 1–17, TM
    90–384) the reference's rule admits (TpC % 8 == 0, lane padding at most
    1.25) at every J of DECODE_JS has a plan that fits shared memory, so an
    explicit decoder_impl="bandconv_pallas" launches on the card there."""
    shapes = [(k, tm) for k in range(1, 18) for tm in range(90, 385)
              if jax_fused_decode_supported(8, tm, k)]
    assert len(shapes) == 17 * (26 + 52 + 77)  # TM 103–128, 205–256, 308–384
    refused = [(j, k, tm) for j in DECODE_JS for k, tm in shapes if not dfc.kernel_supported(j, k, tm)]
    assert not refused, refused[:20]
    assert dfc.kernel_supported(128, 17, 120) and dfc.kernel_supported(100, 10, 120)


@pytest.mark.parametrize("J", [8, 100, 127, 128, 512])
def test_fused_decode_plans_at_the_edges(J):
    """The launcher's plan at the reference's largest tap count and each TM
    band's ends: the double-buffered 64-row tile where it fits with a halo
    of at most 2 (every preset), else one buffer of split Kcat tiles, of
    K4 rows, and fewer fc rows a tile; J padded to 8."""
    for TM in (103, 128, 205, 256, 308, 384):
        for ktaps in (1, 8, 17):
            p = dfc.decode_plan(64, J, 2, 64, 40, ktaps, TM)
            assert p.smem_bytes <= 227 * 1024 and p.j_pad == -(-J // 8) * 8
            assert p.halo <= 2 or ktaps == 17 and p.bt == 8


# the band decode's shapes: time context T, the time kernel's kh taps (Tp =
# T − kh + 1), its C2 input and I output channels
BAND_SWEEP = [(T - kh + 1, c2, kh, i) for T in (10, 20, 30, 40) for kh in range(1, T + 1)
              for c2 in (8, 16, 32, 50, 64, 100, 128) for i in (8, 16, 32, 50, 64, 100, 128)]


def test_band_card_envelope_holds_the_reference():
    """The reference's band_decode_pallas checks only that the time kernel
    is (kh, 1, I, O), so it takes every shape of BAND_SWEEP; 1896 of its
    4900 shapes do not fit one block's shared memory at once (the presets'
    Tp 16, C2 50, kh 15, I 50 takes 225 024 of 232 448 bytes). The card
    streams those (test_band_stream_plans_hold_the_sweep); the pieces that
    served them before, still forced by band_decode_pieces_pallas, cut each
    into pieces that fit (band_pieces): every shape has a plan."""
    whole = [s for s in BAND_SWEEP if dbc._band_smem(*s) <= dbc.SMEM_MAX]
    assert len(BAND_SWEEP) == 4900 and len(BAND_SWEEP) - len(whole) == 1896
    for tp, c2, kh, i in BAND_SWEEP:
        split = dbc.band_pieces(tp, c2, kh, i)
        assert split.smem_bytes <= dbc.SMEM_MAX
        assert (len(split.pieces) == 1) == (dbc._band_smem(tp, c2, kh, i) <= dbc.SMEM_MAX)
        hs = {(h0, h1) for h0, h1, _, _ in split.pieces}
        ds = {(d0, d1) for _, _, d0, d1 in split.pieces}
        assert len(split.pieces) == len(hs) * len(ds)  # every depth range meets every tap range
        assert sum(h1 - h0 for h0, h1 in hs) == tp and sum(d1 - d0 for d0, d1 in ds) == kh
        for h0, h1, d0, d1 in split.pieces:
            dbc.band_plan(64, h1 - h0, c2, d1 - d0, i)  # raises where a piece does not fit


def test_band_stream_plans_hold_the_sweep():
    """Every one of BAND_SWEEP's 1896 shapes past one block's shared memory
    routes to the streamed kernel (and no other shape but the won ones),
    and its plan (band_stream_plan, the launcher's mirror) is one launch:
    shared memory within 232 448 bytes whatever the band, at most one block
    an SM in clusters of 2, products N = Ip columns wide up to 256 (else
    equal chunks, two up to 512), and every output column (t, i) of every
    row tile (M 130: a full tile and a ragged one) in exactly one unit."""
    M, sms = 130, 132
    past = [s for s in BAND_SWEEP if dbc._band_smem(*s) > dbc.SMEM_MAX]
    assert len(past) == 1896
    assert {s for s in BAND_SWEEP if dbc.streams(*s)} == set(past) | (
        dbc.BAND_STREAM_WON & set(BAND_SWEEP))
    for tp, c2, kh, i in past:
        T = tp + kh - 1
        plan = dbc.band_stream_plan(M, tp, c2, kh, i, sms)
        ip = -(-i // 8) * 8
        assert plan.smem_bytes <= dbc.SMEM_MAX
        assert plan.grid % 2 == 0 and 2 <= plan.grid <= sms and plan.items >= plan.grid // 2
        assert plan.n % 8 == 0 and plan.n * plan.chunks >= ip
        assert (plan.chunks, plan.n) == ((1, ip) if ip <= 256 else (2, -(-ip // 16) * 8))
        assert plan.g * plan.n <= 256 and 1 <= plan.g <= 4
        seen = np.zeros((plan.row_tiles, T, plan.n * plan.chunks), np.int32)
        for rt, ch, t0, t1 in dbc.stream_items(plan, T):
            seen[rt, t0:t1 + 1, ch * plan.n:(ch + 1) * plan.n] += 1
        assert (seen[:, :, :i] == 1).all(), (tp, c2, kh, i)
