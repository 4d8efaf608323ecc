"""The banded time-stage decode (``decoder_impl="band_pallas"``) and the
two-stage ``band`` decode, port against reference, on CPU:

* ``band_tensor`` exactly equal to JAX's;
* the port's ``band_decode_pallas`` on CPU tensors (its plain version)
  against JAX's kernel in Pallas interpret mode on the same z: both round z
  and the band to bf16 and sum in f32, so they differ by the f32 sums'
  order, 1e-5 × max|out|;
* ``ConvSep`` with ``decoder_impl`` "band" and "band_pallas" against the
  JAX model on the same weights and input, 1e-5 × max|y|. "band_pallas"
  rounds the expansion z = relu(fc @ K + b) to bf16, and the two packages'
  f32 z differ in the last bits, so some elements round one bf16 ulp
  apart (~0.4 % of them here, up to 4.6e-4 × max|y| downstream). That
  route is held at 1e-5 with a bf16-exact expansion (K = 0, b in bf16,
  the same z in both), and at 2^-7 × max|y| with random weights."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.models import ConvSep as JaxConvSep
from convsep_tpu.models import ConvSepConfig as JaxConfig
from convsep_tpu.models import decoder_pallas as jdp
from convsep_tpu_torch.ckpt import from_jax_params
from convsep_tpu_torch.models import ConvSep, ConvSepConfig
from convsep_tpu_torch.models import convsep as tconv
from convsep_tpu_torch.models import decoder_band_cuda as tdb

# (kh, I, O, T): the multires4096 time stage (15, 50, 50, 30) cut in width
BANDS = [(15, 7, 5, 30), (5, 3, 3, 10), (1, 2, 6, 8), (4, 6, 4, 12)]


@pytest.mark.parametrize("kh,I,O,T", BANDS)
def test_band_tensor_equals_jax(rng, kh, I, O, T):
    k = (0.2 * rng.standard_normal((kh, 1, I, O))).astype(np.float32)
    want = np.asarray(jdp.band_tensor(jnp.asarray(k), T))
    got = tdb.band_tensor(torch.from_numpy(k), T).numpy()
    assert got.shape == want.shape == (T - kh + 1, O, T * I)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kh,I,O,T", BANDS)
@pytest.mark.parametrize("N,W", [(3, 13), (2, 8)])
def test_plain_matches_jax_interpret(rng, kh, I, O, T, N, W):
    Tp = T - kh + 1
    z = np.maximum(rng.standard_normal((N, Tp, W, O)), 0).astype(np.float32)
    k = (0.2 * rng.standard_normal((kh, 1, I, O))).astype(np.float32)
    want = np.asarray(jdp.band_decode_pallas(jnp.asarray(z), jnp.asarray(k), T, interpret=True))
    got = tdb.band_decode_pallas(torch.from_numpy(z), torch.from_numpy(k), T)
    assert got.dtype == torch.float32 and got.shape == want.shape == (N, W, T * I)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_plain_rounds_operands_to_bf16(rng):
    """The plain version is the f32 product of bf16-rounded operands (so a
    float32 decode differs from it at bf16 resolution)."""
    z = torch.from_numpy(rng.standard_normal((2, 9, 4 * 3)).astype(np.float32))
    band = tdb.band_tensor(torch.from_numpy(rng.standard_normal((3, 1, 2, 3)).astype(np.float32)), 6)
    got = tdb.band_decode_wmajor(z, band, 6)
    want = z.to(torch.bfloat16).double() @ band.to(torch.bfloat16).double().reshape(12, 12)
    torch.testing.assert_close(got.double(), want, atol=1e-6, rtol=0)
    assert (got - z @ band.reshape(12, 12)).abs().max() > 1e-4
    with pytest.raises(ValueError, match="align"):
        tdb.band_decode_wmajor(z, band, 5)


# tests/test_model.py's band configs, and the multires4096 geometry cut in
# width (3 input channels, stride 4, T 30, Tp 16)
MODELS = {
    "s2": dict(time_context=12, feat_size=65, channels_in=1, num_sources=3, conv1_filters=6,
               conv1_freq=9, conv1_freq_stride=2, conv2_filters=5, conv2_time=5, bottleneck=16),
    "s3": dict(time_context=12, feat_size=64, channels_in=1, num_sources=3, conv1_filters=6,
               conv1_freq=9, conv1_freq_stride=3, conv2_filters=5, conv2_time=5, bottleneck=16),
    "multires": dict(time_context=30, feat_size=129, channels_in=3, num_sources=4,
                     conv1_filters=6, conv1_freq=9, conv1_freq_stride=4, conv2_filters=5,
                     bottleneck=16),
}


def _run_both(rng, shape, impl, mask_dtype, exact_z):
    """(port outputs unprepared and prepared, JAX output) on one input."""
    kw = dict(MODELS[shape], decoder_impl=impl, mask_dtype=mask_dtype)
    jcfg, tcfg = JaxConfig(**kw), ConvSepConfig(**kw)
    x = np.abs(rng.standard_normal((3, jcfg.time_context, jcfg.feat_size,
                                    jcfg.channels_in))).astype(np.float32)
    params = JaxConvSep(jcfg).init(jax.random.PRNGKey(1), jnp.asarray(x))
    if exact_z:
        fe = params["params"]["fc_expand"]
        bias = np.asarray(fe["bias"]) + rng.standard_normal(fe["bias"].shape).astype(np.float32)
        bias = np.asarray(jnp.asarray(bias).astype(jnp.bfloat16).astype(jnp.float32))
        fe = {"kernel": jnp.zeros_like(fe["kernel"]), "bias": jnp.asarray(bias)}
        params = {**params, "params": {**params["params"], "fc_expand": fe}}
    want = np.asarray(JaxConvSep(jcfg).apply(params, jnp.asarray(x), method=JaxConvSep.sources)
                      .astype(jnp.float32))
    model = ConvSep(tcfg, from_jax_params(params, tcfg))
    unprepared = model.sources(torch.from_numpy(x))
    got = model.prepare_inference().sources(torch.from_numpy(x))
    assert "fc_expand_kernel" in dict(model.named_parameters())
    assert not hasattr(model, "k4")
    for out in (unprepared, got):
        assert out.dtype == getattr(torch, mask_dtype) and out.shape == want.shape
    return (unprepared, got), want


@pytest.mark.parametrize("shape", sorted(MODELS))
@pytest.mark.parametrize("impl", ["band", "band_pallas"])
@pytest.mark.parametrize("mask_dtype", ["float32", "bfloat16"])
def test_convsep_band_routes_match_jax(rng, shape, impl, mask_dtype):
    outs, want = _run_both(rng, shape, impl, mask_dtype, exact_z=impl == "band_pallas")
    scale = float(np.abs(want).max())
    assert scale > 0
    for out in outs:
        if mask_dtype == "float32":
            np.testing.assert_allclose(out.numpy(), want, atol=1e-5 * scale, rtol=0)
        else:  # rounded to bf16 twice (cast, + out_bias): one ulp apart at most
            np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -7,
                                       atol=1e-6 * scale)


@pytest.mark.parametrize("shape", sorted(MODELS))
def test_convsep_band_pallas_random_expansion_matches_jax(rng, shape):
    outs, want = _run_both(rng, shape, "band_pallas", "float32", exact_z=False)
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want, atol=2 ** -7 * np.abs(want).max(), rtol=0)


def test_band_routes_resolve_and_refuse_training():
    cfg = ConvSepConfig(**MODELS["s2"])
    for impl in ("band", "band_pallas"):
        c = dataclasses.replace(cfg, decoder_impl=impl)
        assert tconv.resolve_decoder_impl(c, torch.device("cpu")) == impl
        assert tconv.trainable_config(c).decoder_impl in ("band", "bandconv")
        with pytest.raises(NotImplementedError, match="bandconv"):
            ConvSep(tconv.trainable_config(c))


# -- the kernel's host side: the packed taps, the depth ranges, the plan ------


def unpack_taps(packed, kh, C2, I):
    """pack_taps' core-matrix order back to its (kh·C2p + 8, Ip) rows."""
    c2p, ip = -(-C2 // 8) * 8, -(-I // 8) * 8
    rows = kh * c2p + 8
    return packed.float().reshape(rows // 8, ip // 8, 8, 8).permute(0, 3, 1, 2).reshape(rows, ip)


def kernel_emulation(z, packed, Tp, C2, kh, I):
    """band_decode_kernel's arithmetic in float32: z's depth padded per tap
    to C2p (8 zero rows after the last); column block t multiplies depth
    h_lo·C2p .. + 16·steps of it by the same run of the packed taps' rows
    from tap t − h_lo, over Ip columns, keeping the first I."""
    M = z.shape[0]
    T = Tp + kh - 1
    plan = tdb.band_plan(M, Tp, C2, kh, I)
    c2p = plan.c2p
    a = torch.zeros(M, Tp * c2p + 8)
    a[:, : Tp * c2p].view(M, Tp, c2p)[..., :C2] = z.to(torch.bfloat16).float().view(M, Tp, C2)
    b = unpack_taps(packed, kh, C2, I)
    out = torch.empty(M, T * I)
    for t in range(T):
        lo, hi = tdb.h_range(t, Tp, kh)
        depth = 16 * plan.steps[t]
        rho = (kh - 1 - (t - lo)) * c2p
        out[:, t * I:(t + 1) * I] = (a[:, lo * c2p:lo * c2p + depth] @ b[rho:rho + depth])[:, :I]
    return out


BAND_SHAPES = [(196 * 505, 16, 50, 15, 50), (3 * 13, 16, 8, 15, 6), (2 * 9, 6, 8, 5, 3),
               (5 * 7, 1, 16, 1, 130), (1 * 200, 4, 10, 9, 7), (70, 8, 5, 5, 9), (64, 30, 2, 1, 8)]


@pytest.mark.parametrize("M,Tp,C2,kh,I", BAND_SHAPES)
def test_band_tile_depth_is_exactly_its_taps(rng, M, Tp, C2, kh, I):
    """Column block t's depth range [h_lo, h_hi] is exactly the taps h at
    which the band's columns of t have a nonzero, and the plan's products
    cover it with less than 16 rows to spare."""
    T = Tp + kh - 1
    k = torch.from_numpy(rng.uniform(0.5, 1.0, (kh, 1, I, C2)).astype(np.float32))
    band = tdb.band_tensor(k, T)
    plan = tdb.band_plan(M, Tp, C2, kh, I)
    for t in range(T):
        lo, hi = tdb.h_range(t, Tp, kh)
        nonzero = [h for h in range(Tp) if band[h, :, t * I:(t + 1) * I].abs().sum() > 0]
        assert nonzero == list(range(lo, hi + 1))
        assert 0 <= 16 * plan.steps[t] - (hi - lo + 1) * plan.c2p < 16


@pytest.mark.parametrize("M,Tp,C2,kh,I", BAND_SHAPES)
def test_band_plan_mirrors_the_launcher(M, Tp, C2, kh, I):
    plan = tdb.band_plan(M, Tp, C2, kh, I)
    assert plan.c2p % 8 == 0 and C2 <= plan.c2p < C2 + 8
    assert plan.ip % 8 == 0 and I <= plan.ip < I + 8
    assert plan.nw % 8 == 0 and plan.nw <= 64 and plan.ip % plan.nw == 0
    if plan.vec == 0:  # the register path: 16-byte loads, pairs inside one tap
        assert C2 % 2 == 0 and Tp * C2 % 8 == 0 and Tp * C2 <= 32 * tdb.QUADS
    else:
        assert plan.vec == (2 if C2 % 2 == 0 else 1)
    stage = plan.nw + (24 - plan.nw) % 32
    assert stage % 32 == 24 and plan.nw <= stage < plan.nw + 32
    assert plan.smem_bytes == (2 * 64 * (Tp * plan.c2p + 8) + 2 * (kh * plan.c2p + 8) * plan.ip
                               + 4 * 8 * 8 * stage)
    assert plan.smem_bytes <= 232_448
    assert plan.row_tiles == -(-M // 64) and 1 <= plan.grid <= plan.row_tiles
    assert plan.executed_ops == 2.0 * 64 * plan.row_tiles * 16 * plan.ip * sum(plan.steps)
    needed = 2.0 * M * C2 * I * sum(hi - lo + 1 for lo, hi in
                                    (tdb.h_range(t, Tp, kh) for t in range(Tp + kh - 1)))
    assert plan.executed_ops >= needed


def test_band_plan_at_multires4096():
    """One multires4096 track: 1547 row tiles on 132 persistent blocks, 220
    KB of shared memory, 1.505e11 operations run for the band's 1.188e11."""
    plan = tdb.band_plan(196 * 505, 16, 50, 15, 50)
    assert (plan.c2p, plan.ip, plan.nw, plan.vec, plan.row_tiles, plan.grid) == (
        56, 56, 56, 0, 1547, 132)
    assert plan.smem_bytes == 225_024 and plan.executed_ops == 150_454_140_928.0
    with pytest.raises(ValueError, match="shared memory"):
        tdb.band_plan(100, 64, 50, 15, 50)


@pytest.mark.parametrize("M,Tp,C2,kh,I", BAND_SHAPES[1:])
def test_kernel_emulation_matches_plain(rng, M, Tp, C2, kh, I):
    """The packed taps read as the kernel reads them (per t, one run of
    rows from tap t − h_lo against z's padded depth) give the plain
    version's output within 1e-5 × max|out| (f32 sums in another order)."""
    T = Tp + kh - 1
    z = torch.relu(torch.from_numpy(rng.standard_normal((M, Tp * C2)).astype(np.float32)))
    k = torch.from_numpy((0.2 * rng.standard_normal((kh, 1, I, C2))).astype(np.float32))
    op = tdb.band_operand(k, T)
    got = kernel_emulation(z, op.packed, Tp, C2, kh, I)
    want = tdb.band_decode_wmajor_plain(z[None], op)[0]
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("shape", ["multires", "s2"])
def test_prepared_band_operand_equals_band_tensor(rng, shape):
    """The operand the model builds once (prepare_inference) is band_tensor
    of its weights, and its packed taps, read as the kernel reads them,
    are that band in bf16 at every (h, c, t, i)."""
    cfg = ConvSepConfig(**MODELS[shape], decoder_impl="band_pallas")
    x = np.abs(rng.standard_normal((1, cfg.time_context, cfg.feat_size, cfg.channels_in)))
    params = JaxConvSep(JaxConfig(**MODELS[shape], decoder_impl="band_pallas")).init(
        jax.random.PRNGKey(2), jnp.asarray(x.astype(np.float32)))
    model = ConvSep(cfg, from_jax_params(params, cfg)).prepare_inference()
    T, Tp, C2 = cfg.time_context, cfg.enc_time, cfg.conv2_filters
    kh = T - Tp + 1
    I = model.conv2_kernel.shape[2]
    want = tdb.band_tensor(model.conv2_kernel, T)
    assert torch.equal(model.band, want)
    b = unpack_taps(model.band_taps, kh, C2, I)
    c2p = -(-C2 // 8) * 8
    got = torch.zeros_like(want)
    for h in range(Tp):
        for t in range(T):
            if 0 <= t - h < kh:
                rho = (kh - 1 - (t - h)) * c2p
                got[h, :, t * I:(t + 1) * I] = b[rho:rho + C2, :I]
    assert torch.equal(got, want.to(torch.bfloat16).float())
    assert b[kh * c2p:].abs().sum() == 0  # the zero rows after tap 0


@pytest.mark.parametrize("M,Tp,C2,kh,I", [(70, 30, 128, 1, 128), (64, 1, 128, 30, 100),
                                          (40, 12, 100, 9, 128)])
def test_band_pieces_emulation_matches_plain(rng, M, Tp, C2, kh, I):
    """A band too large for one block's shared memory, cut by band_pieces:
    each piece (z's depths h0 .. h1 − 1 against its own packed taps d0 ..
    d1 − 1, read as the kernel reads them) added into output columns h0 +
    d0 on, as band_decode_wmajor launches band_decode_piece_launch, gives
    the plain version's output within 1e-5 × max|out|."""
    T = Tp + kh - 1
    with pytest.raises(ValueError, match="shared memory"):
        tdb.band_plan(M, Tp, C2, kh, I)
    split = tdb.band_pieces(Tp, C2, kh, I)
    assert len(split.pieces) > 1 and split.smem_bytes <= tdb.SMEM_MAX
    k = torch.from_numpy((0.3 * rng.standard_normal((kh, 1, I, C2))).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((M, Tp * C2)).astype(np.float32))
    band = tdb.band_tensor(k, T)
    taps = tdb.taps_of_band(band, T)
    out = torch.zeros(M, T * I)
    for h0, h1, d0, d1 in split.pieces:
        part = kernel_emulation(z[:, h0 * C2:h1 * C2], tdb.pack_taps(taps[d0:d1]), h1 - h0, C2,
                                d1 - d0, I)
        out[:, (h0 + d0) * I:(h1 + d1 - 1) * I] += part
    want = tdb.band_decode_wmajor_plain(z[None], band)[0]
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5 * want.abs().max().item(),
                               rtol=0)


# -- the streamed kernel (csrc/band_stream.cu): packed taps, plan, reads ------


def stream_emulation(z, packed, Tp, C2, kh, I):
    """band_stream_kernel's arithmetic in float32, item by item in the
    launcher's order: a unit (128-row tile, column block t, chunk of N
    columns) sums, over its 64-depth slabs j of z's own row order (depths
    past Tp·C2 zero), slab j of z against the packed taps' 64 rows from 64
    + (kh − 1 − t)·C2 + 64·j, read in the shifted copy where they start
    16-byte aligned. Each output element must be written exactly once."""
    M = z.shape[0]
    T, S = Tp + kh - 1, Tp * C2
    plan = tdb.band_stream_plan(M, Tp, C2, kh, I)
    zb = z.to(torch.bfloat16).float()
    q = packed.float().reshape(plan.copies, plan.np, plan.lq)
    div = 8 // plan.copies
    out = torch.zeros(M, T * I)
    written = torch.zeros(M, T * I, dtype=torch.int32)
    for rt, ch, t0, t1 in tdb.stream_items(plan, T):
        rows = slice(rt * 128, min(M, rt * 128 + 128))
        n0 = ch * plan.n
        cols = min(plan.n, I - n0)
        for t in range(t0, t1 + 1):
            lo, hi = plan.slabs[t]
            assert plan.slabs[t0][0] <= lo and hi <= plan.slabs[t1][1]
            acc = torch.zeros(rows.stop - rows.start, plan.n)
            for j in range(lo, hi + 1):
                a = torch.zeros(rows.stop - rows.start, 64)
                a[:, :min(S, 64 * j + 64) - 64 * j] = zb[rows, 64 * j:64 * j + 64]
                rho = 64 + (kh - 1 - t) * C2 + 64 * j
                pos = rho + (8 - rho % 8) % 8
                assert pos % 8 == 0 and 0 <= pos and pos + 64 <= plan.lq
                acc += a @ q[rho % 8 // div, n0:n0 + plan.n, pos:pos + 64].t()
            if cols > 0:
                out[rows, t * I + n0:t * I + n0 + cols] = acc[:, :cols]
                written[rows, t * I + n0:t * I + n0 + cols] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("M,Tp,C2,kh,I", [(70, 30, 128, 1, 128), (64, 1, 128, 30, 100),
                                          (40, 12, 100, 9, 128), (300, 16, 128, 15, 64),
                                          (70, 4, 50, 3, 300), (130, 3, 7, 2, 5),
                                          (40, 4, 1100, 4, 200)])
def test_stream_emulation_matches_plain(rng, M, Tp, C2, kh, I):
    """The streamed kernel's reads (test_band_pieces_emulation_matches_plain's
    three shapes; BAND_PIECES_SHAPE's Tp, C2, kh, I at 300 rows, an odd
    count of row tiles; 300 columns in two chunks; C2 odd; a deep band,
    4400 depths a column block, in its fold's two chunks of 104) give the
    plain version's output within 1e-5 × max|out| (f32 sums in another
    order)."""
    assert tdb.band_stream_plan(M, Tp, C2, kh, I).fold == (C2 == 1100)
    T = Tp + kh - 1
    z = torch.relu(torch.from_numpy(rng.standard_normal((M, Tp * C2)).astype(np.float32)))
    k = torch.from_numpy((0.3 * rng.standard_normal((kh, 1, I, C2))).astype(np.float32))
    op = tdb.band_operand(k, T)
    got = stream_emulation(z, op.stream, Tp, C2, kh, I)
    want = tdb.band_decode_wmajor_plain(z[None], op)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * want.abs().max().item(),
                               rtol=0)


@pytest.mark.parametrize("Tp,C2,kh,I", [(16, 128, 15, 64), (16, 100, 15, 100), (4, 50, 3, 300),
                                        (3, 7, 2, 5), (16, 32, 15, 100), (4, 1100, 4, 200)])
def test_stream_packing_is_the_band(rng, Tp, C2, kh, I):
    """Every copy of pack_stream_taps holds the band: row 64 + (kh − 1 −
    d)·C2 + c of column i is tap d's (c, i) in bf16 at the copy's shift,
    zero elsewhere (the 64 rows before and after, columns past I)."""
    k = torch.from_numpy(rng.uniform(0.5, 1.0, (kh, 1, I, C2)).astype(np.float32))
    sh = tdb.stream_shape(Tp, kh, C2, I)
    q = tdb.pack_stream_taps(k[:, 0].permute(0, 2, 1), Tp).float().reshape(sh.copies, sh.np,
                                                                           sh.lq)
    taps = k[:, 0].permute(0, 2, 1).to(torch.bfloat16).float()  # (kh, C2, I)
    assert sh.copies == 8 // np.gcd(C2, 8) and sh.lq % 8 == 0 and sh.np == sh.n * sh.chunks
    for c in range(sh.copies):
        shift = (8 - c * (8 // sh.copies)) % 8
        want = torch.zeros(sh.np, sh.lq)
        want[:I, shift + 64:shift + 64 + kh * C2] = taps.flip(0).reshape(kh * C2, I).t()
        assert torch.equal(q[c], want)


def test_stream_plan_at_the_pieces_shapes():
    """BAND_PIECES_SHAPE (C2 128, I 64) and C2 100, I 100 at multires4096's
    rows: one launch of 132 blocks (66 clusters of 2) over pairs of 128-row
    tiles, N the whole of Ip (64; 104: one m64n104k16 chain, not thirteen
    n8 products), groups of 4 and 2 column blocks, 221 184 and 196 608
    bytes of shared memory; the operations run are the band's products up
    to the rows' and columns' padding."""
    M = 196 * 505
    a = tdb.band_stream_plan(M, 16, 128, 15, 64)
    assert (a.n, a.g, a.chunks, a.copies, a.row_tiles, a.items, a.grid, a.smem_bytes,
            a.fold) == (64, 4, 1, 1, 774, 387 * 8, 132, 221_184, False)
    assert a.executed_ops == 2.0 * 774 * 128 * 64 * 64 * 480
    b = tdb.band_stream_plan(M, 16, 100, 15, 100)
    assert (b.n, b.g, b.chunks, b.copies, b.grid, b.smem_bytes) == (104, 2, 1, 2, 132, 196_608)
    assert tdb.streams(16, 128, 15, 64) and tdb.streams(16, 100, 15, 100)
    assert not tdb.streams(16, 50, 15, 50)  # multires4096 keeps band_decode.cu


def test_port_band_decode_matches_jax_past_shared_memory(rng):
    """The port's band_decode_pallas (on CPU its plain version) against
    the JAX package's kernel in Pallas interpret mode at a band past one
    block's shared memory (Tp 16, C2 128, kh 15, I 64: the streamed
    kernel's shape on the card), N·W 26 rows, the same numpy inputs: both
    round z and the band to bf16 and sum in f32, 1e-5 × max|out|."""
    N, W, Tp, O, kh, I = 2, 13, 16, 128, 15, 64
    T = Tp + kh - 1
    assert tdb.streams(Tp, O, kh, I)
    z = np.maximum(rng.standard_normal((N, Tp, W, O)), 0).astype(np.float32)
    k = (0.1 * rng.standard_normal((kh, 1, I, O))).astype(np.float32)
    want = np.asarray(jdp.band_decode_pallas(jnp.asarray(z), jnp.asarray(k), T, interpret=True))
    got = tdb.band_decode_pallas(torch.from_numpy(z), torch.from_numpy(k), T)
    assert got.shape == want.shape == (N, W, T * I)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_forced_kernels_refuse_cpu_tensors():
    """band_decode_stream_pallas and band_decode_pieces_pallas take CUDA
    tensors only: on the CPU they raise instead of falling back."""
    band = tdb.band_tensor(torch.zeros(3, 1, 2, 5), 6)
    for fn in (tdb.band_decode_stream_pallas, tdb.band_decode_pieces_pallas):
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.zeros(2, 3, 20), band, 6)


def test_stream_plan_folds_deep_bands():
    """A column block past 64 slabs of 64 depths (4096) folds: chunks of at
    most 128 columns, half the column blocks an item (one where the group
    was one), within shared memory; the model family's widths never fold
    (at most 40 slabs: 20 depths of 128 channels)."""
    deep = tdb.band_stream_plan(130, 16, 1000, 15, 300)
    assert deep.fold and (deep.chunks, deep.n, deep.g) == (3, 104, 1)
    assert deep.smem_bytes <= tdb.SMEM_MAX
    assert tdb.band_stream_plan(130, 16, 1000, 15, 64).g == 2
    assert not tdb.band_stream_plan(130, 21, 128, 20, 128).fold
    assert max(hi - lo + 1 for lo, hi in tdb.band_stream_plan(130, 21, 128, 20, 128).slabs) == 40
