"""The port's card envelopes against the reference kernels' own admission
rules, on CPU: every shape that a Pallas kernel of the JAX package computes
(``ct_istft_kernel.ct_pallas_supported`` for the Wiener+iSTFT and the
iSTFT, ``ct_stft_kernel.ct_stft_supported`` for the fused forward STFT),
tried at every power of two from 16 to 65 536 and every hop, is a shape the
port's CUDA kernel takes, so no shape the reference computes raises on the
card. And the masked synthesis's "auto" never takes a kernel that lost its
timed A/B (the Wiener kernel's direct sum at the sizes that are not powers
of two), while the presets' routes stay where they were."""

import pytest
import torch

from convsep_tpu.dsp.pallas.ct_istft_kernel import ct_pallas_supported as jax_ct_pallas_supported
from convsep_tpu.dsp.pallas.ct_stft_kernel import ct_stft_supported as jax_ct_stft_supported
from convsep_tpu_torch.configs import PRESETS, get_preset
from convsep_tpu_torch.dsp.cuda import ct_istft_kernel as ck
from convsep_tpu_torch.dsp.cuda import ct_stft_kernel as cs
from convsep_tpu_torch.dsp.dft import resolve_masked_synthesis

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
    kernel is a direct sum per sample, which lost its A/B to the masked
    chain (PERF.md row 1′): "auto" names the masked chain's iSTFT there,
    and only the explicit "ct_pallas_wiener" reaches the kernel."""
    assert ck.wiener_istft_supported(nfft, nfft, hop)
    route = resolve_masked_synthesis("auto", nfft, nfft, hop, p, CUDA)
    assert route != "ct_pallas_wiener" and route in ("direct", "factored", "ct_pallas")
    assert resolve_masked_synthesis("ct_pallas_wiener", nfft, nfft, hop, p, CUDA) == \
        "ct_pallas_wiener"


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
