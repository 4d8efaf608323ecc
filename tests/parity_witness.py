"""Print the witnesses that set the CPU parity tests' float32 bounds: the
same quantity computed twice by the JAX reference, under two summation
orders or against float64.

    JAX_PLATFORMS=cpu python -m tests.parity_witness

* multires stems (``test_torch_chunked.TOL_MULTIRES``): the reference's
  chunked and whole-track stems with ``encoder_impl`` "collapsed" against
  "conv" (the same products in another order);
* the first feature step's grad norm (``test_torch_dispatch.TOL_FIRST_STEP``):
  the reference's float32 grad norm against its float64 evaluation
  (``compute_dtype="float64"`` under ``jax.enable_x64``), seeds 0-3;
* the from-audio trajectory (``test_torch_train_e2e``): each step's
  parameters by the reference's ``fft_impl="matmul"`` step against its
  ``"pallas"`` step from the same state.

Not collected by pytest (no ``test_`` prefix); it imports the JAX package,
as the tests do."""

import dataclasses

import tests.conftest  # noqa: F401  (jax on the CPU)
import numpy as np
import jax
import jax.numpy as jnp

from convsep_tpu.separate import ChunkedSeparator, Separator
from convsep_tpu.train import e2e as jax_e2e
from convsep_tpu.train import loop as jax_loop
from tests.test_chunked import _params, tiny_preset
from tests.test_torch_train_e2e import _batch, _with
from tests.test_torch_train_model import PRESETS


def multires() -> dict:
    jp = tiny_preset()
    jp = dataclasses.replace(jp, transform=dataclasses.replace(jp.transform, multires=(64, 128)),
                             model=dataclasses.replace(jp.model, channels_in=3))
    params = _params(jp)
    audio = (0.1 * np.random.default_rng(0).standard_normal(10_000)).astype(np.float32)
    conv = dataclasses.replace(jp, model=dataclasses.replace(jp.model, encoder_impl="conv"))
    out = {}
    for name, run in (("chunked", lambda p: ChunkedSeparator(p, params, chunk_segments=2)),
                      ("whole", lambda p: Separator(p, params))):
        out[name] = float(np.abs(np.asarray(run(jp)(audio)) - np.asarray(run(conv)(audio))).max())
    return out


def feature_grad_norm(seeds=range(4)) -> list[float]:
    jp = PRESETS["ikala_tiny"]()
    jp = dataclasses.replace(jp, sep=dataclasses.replace(jp.sep, wiener_eps=1e-2))
    out = []
    for seed in seeds:
        params = jax_loop.create_train_state(jp, seed)[0].params
        m, r = jp.model, np.random.default_rng(seed)
        x = np.abs(r.standard_normal((5, m.time_context, m.feat_size, 1))).astype(np.float32)
        y = np.abs(r.standard_normal((5, m.num_sources, m.time_context, m.feat_size))
                   ).astype(np.float32)
        norms = []
        for dt in (np.float32, np.float64):
            with jax.enable_x64(dt is np.float64):
                p = dataclasses.replace(jp, model=dataclasses.replace(
                    jp.model, compute_dtype=np.dtype(dt).name))
                args = [jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dt)), t)
                        for t in (params, x, y)]
                grads = jax.grad(jax_loop._feature_loss_fn(p))(*args)
                norms.append(float(np.sqrt(sum(float(jnp.sum(g * g))
                                               for g in jax.tree.leaves(grads)))))
        out.append(abs(norms[0] - norms[1]) / norms[1])
    return out


def trajectory() -> dict:
    out = {}
    for name in sorted(PRESETS):
        rng = np.random.default_rng(0)
        jp = _with(PRESETS[name]())
        state, opt = jax_loop.create_train_state(jp, 1)
        step = jax_e2e.make_audio_train_step(jp, opt)
        other = jax_e2e.make_audio_train_step(_with(PRESETS[name](), fft_impl="matmul"), opt)
        batches = [_batch(rng, jp, 4) for _ in range(4)]
        state, _ = step(state, *map(jnp.asarray, batches[0]))
        gaps = []
        for mix, stems in batches[1:]:
            wit, _ = other(jax.tree.map(jnp.copy, state), jnp.asarray(mix), jnp.asarray(stems))
            state, _ = step(state, jnp.asarray(mix), jnp.asarray(stems))
            gaps.append(max(float(jnp.abs(a - b).max()) for a, b in
                            zip(jax.tree.leaves(wit.params), jax.tree.leaves(state.params))))
        out[name] = gaps
    return out


if __name__ == "__main__":
    print("multires stems, encoder collapsed vs conv (max abs):", multires())
    print("feature grad norm, float32 vs float64 (relative), seeds 0-3:", feature_grad_norm())
    print("trajectory, matmul vs pallas step (max abs a step):", trajectory())
