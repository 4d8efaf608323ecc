"""The training slice's two kernel modules, port against reference, on CPU:
the port's ``stft_pallas`` and ``fused_adadelta_apply`` (their plain
versions here) against the JAX functions run in Pallas interpret mode, on
the same numpy inputs.

Tolerances: spectra within 1e-5 × max|X| (float32 sums of W products in
another order); adadelta parameters and accumulators within 1e-6 absolute
on O(1) values (one-ulp differences where XLA contracts a multiply-add),
the grad norm within 1e-5 relative."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.dsp.pallas import stft_pallas as jax_stft_pallas
from convsep_tpu.dsp.windows import sinebell as jax_sinebell
from convsep_tpu.train.fused_optim import fused_adadelta_apply as jax_fused_apply
from convsep_tpu.train.optim import lasagne_adadelta as jax_adadelta
from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas, stft_pallas_plain
from convsep_tpu_torch.dsp.dft import stft_matmul
from convsep_tpu_torch.dsp.windows import sinebell
from convsep_tpu_torch.train.fused_optim import (
    fused_adadelta_apply,
    fused_adadelta_leaf,
    fused_adadelta_plain,
)
from convsep_tpu_torch.train.optim import AdadeltaState, global_norm, lasagne_adadelta


@pytest.mark.parametrize(
    "nfft,hop,nfft_pad,lead",
    [
        (256, 128, None, (3,)),
        (256, 128, None, ()),
        (256, 64, None, (2,)),
        (512, 128, 1024, (2,)),
        (128, 128, None, ()),
    ],
)
def test_stft_pallas_matches_jax(rng, nfft, hop, nfft_pad, lead):
    L = 8 * hop + 37  # not a hop multiple: the tail pad is exercised
    x = (0.3 * rng.standard_normal((*lead, L))).astype(np.float32)
    np.testing.assert_array_equal(sinebell(nfft), jax_sinebell(nfft))
    re_j, im_j = jax_stft_pallas(jnp.asarray(x), jax_sinebell(nfft), hop, nfft_pad,
                                 interpret=True)
    re_t, im_t = stft_pallas(torch.from_numpy(x), sinebell(nfft), hop, nfft_pad)
    assert tuple(re_t.shape) == re_j.shape == (*lead, L // hop + 3, (nfft_pad or nfft) // 2 + 1)
    peak = float(np.abs(np.asarray(re_j)).max())
    np.testing.assert_allclose(re_t.numpy(), np.asarray(re_j), atol=1e-5 * peak, rtol=0)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), atol=1e-5 * peak, rtol=0)


def test_stft_pallas_contract(rng):
    x = torch.from_numpy(rng.standard_normal((2, 3000)).astype(np.float32))
    w = sinebell(256)
    # the plain version is the direct DFT even where stft_matmul's "auto"
    # would factor (nfft >= 2048)
    re_p, _ = stft_pallas_plain(x, w, 128)
    re_m, _ = stft_matmul(x, w, 128, algorithm="direct")
    torch.testing.assert_close(re_p, re_m, rtol=0, atol=0)
    with pytest.raises(ValueError, match="win % hop"):
        stft_pallas(x, w, 96)
    with pytest.raises(ValueError, match=r"\(L,\) or \(B, L\)"):
        stft_pallas(x[None], w, 128)


def _tree(rng, shapes, scale=1.0):
    return {f"leaf{i}": (scale * rng.standard_normal(s)).astype(np.float32)
            for i, s in enumerate(shapes)}


# one leaf the reference's kernel takes at min_elems 1 << 12 (geometry
# 64 × 256), one past min_elems it cannot tile (4099 elements: the port's
# kernel rule ignores tiling, the math is the same), and small leaves
SHAPES = [(64, 256), (4099,), (7,), (50, 3), (128,)]


def test_fused_adadelta_matches_jax_mixed_leaves(rng):
    params = _tree(rng, SHAPES)
    jst = jax_adadelta().init(jax.tree.map(jnp.asarray, params))
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = lasagne_adadelta().init(tp)
    for i in range(3):  # several steps so the accumulators are nontrivial
        grads = _tree(rng, SHAPES, scale=0.5 + i)
        jp, jst, jgn = jax_fused_apply(jp, jax.tree.map(jnp.asarray, grads), jst,
                                       min_elems=1 << 12, interpret=True)
        tgrads = {k: torch.from_numpy(v) for k, v in grads.items()}
        out_p, out_st, tgn = fused_adadelta_apply(tp, tgrads, tst, min_elems=1 << 12)
        assert out_p is tp and out_st is tst  # in place
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
            np.testing.assert_allclose(tst.accu[k].numpy(), np.asarray(jst.accu[k]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(tst.delta_accu[k].numpy(),
                                       np.asarray(jst.delta_accu[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-5)


def test_fused_adadelta_equals_plain_optimizer(rng):
    """The fused route (in place) and the plain optimizer's update (new
    tensors, then p + update) give the same numbers."""
    params = {k: torch.from_numpy(v) for k, v in _tree(rng, SHAPES).items()}
    opt = lasagne_adadelta(learning_rate=0.7)
    ref_p = {k: v.clone() for k, v in params.items()}
    ref_st = opt.init(ref_p)
    cur_st = opt.init(params)
    for i in range(3):
        grads = {k: torch.from_numpy(v) for k, v in _tree(rng, SHAPES, 0.3 * (i + 1)).items()}
        upd, ref_st = opt.update(grads, ref_st, ref_p)
        for k in ref_p:
            ref_p[k] = ref_p[k] + upd[k]
        _, _, gn = fused_adadelta_apply(params, grads, cur_st, learning_rate=0.7)
        for k in params:
            torch.testing.assert_close(params[k], ref_p[k], rtol=0, atol=0)
            torch.testing.assert_close(cur_st.accu[k], ref_st.accu[k], rtol=0, atol=0)
            torch.testing.assert_close(cur_st.delta_accu[k], ref_st.delta_accu[k],
                                       rtol=0, atol=0)
        torch.testing.assert_close(gn, global_norm(grads), rtol=0, atol=0)


def test_adadelta_step0_bound(rng):
    """Zero state: u = g·sqrt(eps)/sqrt(0.05·g² + eps), |u| ≤ sqrt(20) ·
    1e-3 with slope ≤ 1 in g (the bound the card's route check relies on)."""
    g = torch.from_numpy(np.concatenate([rng.standard_normal(999), [1e-9, 50.0]])
                         .astype(np.float32))
    p, a, d = torch.zeros_like(g), torch.zeros_like(g), torch.zeros_like(g)
    sq = fused_adadelta_leaf(p, g, a, d, 1.0, 0.95, 1e-6)  # CPU: the plain version
    u = -p
    assert float(u.abs().max()) <= np.sqrt(20.0) * 1e-3 * (1 + 1e-6)
    assert torch.all(torch.sign(u) == torch.sign(g))
    assert torch.all(u.abs() <= g.abs() * (1 + 1e-6))
    torch.testing.assert_close(sq, (g * g).sum())
    p2, a2, d2 = torch.zeros_like(g), torch.zeros_like(g), torch.zeros_like(g)
    fused_adadelta_plain(p2, g, a2, d2, 1.0, 0.95, 1e-6)
    assert torch.equal(p, p2) and torch.equal(a, a2) and torch.equal(d, d2)


def test_adadelta_state_and_registry():
    from convsep_tpu_torch.train.optim import make_optimizer

    st = lasagne_adadelta().init({"w": torch.ones(3)})
    assert isinstance(st, AdadeltaState) and not st.accu["w"].any()
    with pytest.raises(NotImplementedError, match="float32"):
        lasagne_adadelta(state_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="adam"):
        make_optimizer("adam", learning_rate=1.0)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("nope")
