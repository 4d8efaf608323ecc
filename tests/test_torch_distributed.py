"""The distributed layer, port against reference, on CPU: the port's
``distributed`` package, ``ShardedSeparator``, ``StreamSeparator(mesh=)``
and ``Trainer(mesh=)`` on gloo process groups of CPU ranks (one
subprocess a rank, ``tests/torch_ranks.py``, joined through a file store
in the test's temporary directory) against the JAX package on the
8-device CPU mesh that ``tests/conftest.py`` provides, and against the
port's own single-process runs.

Tolerances: the halo overlap-add 1e-6 absolute (sums of at most four
frames in another order); sharded stems 2e-5 absolute (the reference's
chunked ≡ whole-track bound: the same stems from blocks of segments);
stream stems under a mesh 1e-4 from the unsharded run (the reference's
stream ≡ single-track bound: each rank runs the model on its block of the
batch), int16 ±1 LSB; training as ``test_torch_dispatch.py`` holds it: the
batches exactly, the first step's loss and grad norm within
``TOL_FIRST_STEP`` relative, and each step taken from the reference's state
before it within 1e-5 of the largest parameter magnitude, or five times
the reference's own float32 error on that step against its float64
evaluation where that is larger. Every rank ends with the same parameters,
bit for bit."""

import dataclasses
import datetime
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from convsep_tpu.data.pipeline import SegmentDataset as JaxSegmentDataset
from convsep_tpu.distributed import halo_overlap_add as jax_halo
from convsep_tpu.distributed import make_mesh as jax_make_mesh
from convsep_tpu.dsp.istft import overlap_add as jax_overlap_add
from convsep_tpu.separate.sharded import ShardedSeparator as JaxSharded
from convsep_tpu.train import loop as jax_loop
from convsep_tpu_torch.ckpt import from_jax_params, opt_state_from_jax
from convsep_tpu_torch.data import synth
from convsep_tpu_torch.distributed import halo, mesh as tmesh
from convsep_tpu_torch.dsp.istft import overlap_add
from convsep_tpu_torch.models.convsep import trainable_config
from convsep_tpu_torch.separate import Separator, StreamSeparator
from convsep_tpu_torch.train import loop
from tests.test_chunked import _params, tiny_preset
from tests.test_torch_chunked import noise
from tests.test_torch_chunked import port as port_with_state
from tests.test_torch_dispatch import TOL_FIRST_STEP, _float64_step, _record_dispatches
from tests.test_torch_train_model import PRESETS, port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = {w: np.random.default_rng(w).standard_normal((3, 4 * w, 16)).astype(np.float32)
          for w in (1, 2, 4)}
HOP = 4
STEPS = 3


def run_ranks(d, world: int, jobs: list, timeout: float = 240) -> list[dict]:
    """Run ``jobs`` on ``world`` gloo ranks (subprocesses) → each rank's results."""
    os.makedirs(d, exist_ok=True)
    torch.save(jobs, os.path.join(d, "jobs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_ranks", str(r), str(world),
                               str(d)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)[-4000:]
    return [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    """The inputs of every job, and the reference's runs on the JAX mesh."""
    tmp = tmp_path_factory.mktemp("dist")
    s = {"tmp": tmp}
    jp = tiny_preset()
    jp = dataclasses.replace(jp, model=dataclasses.replace(jp.model, mask_dtype="float32"))
    params = _params(jp)
    s["sep"] = (jp, params, *port_with_state(jp, params))
    s["mix"] = noise(np.random.default_rng(3), 9_000)
    ij = tiny_preset(name="ikala")
    s["stream"] = (ij, *port_with_state(ij, _params(ij)))
    s["tracks"] = [noise(np.random.default_rng(10 + i), 4000 + 700 * i) for i in range(3)]
    # training: the reference's Trainer on make_mesh(data=2), each step recorded
    tj = PRESETS["ikala_tiny"]()
    feats = str(tmp / "feats")
    synth.synth_feature_dir(feats, tj.sources, num_tracks=3, seconds=2.0, fs=8000,
                            frame_size=256, hop_size=128, device="cpu")
    tj = dataclasses.replace(
        tj, sep=dataclasses.replace(tj.sep, wiener_eps=1e-2),
        train=dataclasses.replace(tj.train, batch_size=4, log_every_steps=1,
                                  optimizer_impl="xla"))
    tr = tj.train
    kw = dict(time_context=tr.time_context, overlap=tr.overlap,
              mult_factor_in=tr.mult_factor_in, mult_factor_out=tr.mult_factor_out)
    jt = jax_loop.Trainer(tj, mesh=jax_make_mesh(data=2))
    cfg = trainable_config(port(tj).model)
    init = from_jax_params(jt.state.params, cfg)
    seen = _record_dispatches(jt, lambda st: jax.tree.map(np.array, st))
    jt.fit(JaxSegmentDataset(feats, tj.sources, **kw), max_steps=STEPS)
    s["train"] = dict(jp=tj, cfg=cfg, init=init, feats=feats, seen=seen, jt=jt)
    return s


def _train_jobs(s) -> list:
    t = s["train"]
    pre = [(from_jax_params(st.params, t["cfg"]), opt_state_from_jax(st.opt_state, t["cfg"]),
            x, y) for _, x, y, st, _ in t["seen"]]
    preset = dataclasses.asdict(t["jp"])
    return [("train", dict(preset=preset, params=t["init"], features=t["feats"], steps=STEPS,
                           workdir=str(s["tmp"] / "run"))),
            ("steps", dict(preset=preset, pre=pre))]


@pytest.fixture(scope="module")
def world2(setting):
    jp, params, pp, state = setting["sep"]
    ij, ipp, istate = setting["stream"]
    jobs = [("halo", dict(frames=FRAMES[2], hop=HOP)),
            ("sharded", dict(preset=dataclasses.asdict(jp), state=state, audio=setting["mix"])),
            ("stream", dict(preset=dataclasses.asdict(ij), state=istate,
                            tracks=setting["tracks"], batch_size=2)),
            ("stream:int16", dict(preset=dataclasses.asdict(ij), state=istate,
                                  tracks=setting["tracks"], batch_size=3,
                                  output_dtype="int16"))]
    return run_ranks(setting["tmp"] / "w2", 2, jobs + _train_jobs(setting))


@pytest.fixture(scope="module")
def world4(setting):
    return run_ranks(setting["tmp"] / "w4", 4, [("halo", dict(frames=FRAMES[4], hop=HOP))])


@pytest.fixture
def group(tmp_path):
    """A gloo process group of this process alone."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=30))
    yield
    dist.destroy_process_group()


def _halo_want(world):
    """The reference's halo overlap-add on a mesh of ``world`` devices; on
    one device its plain overlap-add (its ``halo_overlap_add`` refuses a
    mesh of one: shard_map cannot infer the spill's replication there)."""
    frames = FRAMES[world]
    if world == 1:
        want = np.asarray(jax_overlap_add(jnp.asarray(frames), HOP))
    else:
        want = np.asarray(jax_halo(jnp.asarray(frames), HOP, jax_make_mesh(data=world)))
    np.testing.assert_allclose(overlap_add(torch.from_numpy(frames), HOP).numpy(), want,
                               atol=1e-6, rtol=0)
    return want


def test_halo_overlap_add_one_rank(group):
    m = tmesh.make_mesh(device="cpu")
    got = halo.halo_overlap_add(torch.from_numpy(FRAMES[1]), HOP, m)
    np.testing.assert_allclose(got.numpy(), _halo_want(1), atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_overlap_add_ranks(request, world):
    outs = request.getfixturevalue(f"world{world}")
    want = _halo_want(world)
    for out in outs:
        np.testing.assert_allclose(out["halo"], want, atol=1e-6, rtol=0)


class _StubMesh:
    mesh_dim_names = ("data", "model")

    def __init__(self, n):
        self.n = n

    def size(self, dim=None):
        return self.n

    def get_local_rank(self, name):
        return 0


@pytest.mark.parametrize("shape,hop,match", [((2, 7, 16), 4, "not divisible"),
                                             ((2, 8, 16), 20, "hop 20 > win_length"),
                                             ((2, 4, 16), 4, "local block too short")])
def test_halo_overlap_add_refuses(shape, hop, match):
    """The reference's three errors, before any exchange."""
    with pytest.raises(ValueError, match=match):
        halo.halo_overlap_add(torch.zeros(shape), hop, _StubMesh(2))


def test_mesh_helpers_one_rank(group):
    """make_mesh's inference and errors, the placements, the block
    placers and the rank mean on a mesh of one rank."""
    from torch.distributed.tensor import Replicate, Shard

    if not torch.cuda.is_available():  # the default device is the GPU, as elsewhere
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_mesh()
    m = tmesh.make_mesh(device="cpu")
    assert m.device_type == "cpu" and m.mesh_dim_names == ("data", "model")
    assert tuple(m.mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        tmesh.make_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x1x1 needs 2 devices, have 1"):
        tmesh.make_mesh(data=1, dcn=2, device="cpu")
    assert tmesh.batch_sharding(m, 4) == (Shard(0), Replicate())
    assert tmesh.replicated(m) == (Replicate(), Replicate())
    rules = tmesh.param_shardings(m, {"fc_kernel": 0, "fc_expand_kernel": 0,
                                      "fc_expand_bias": 0, "conv1_kernel": 0})
    assert rules == {"fc_kernel": (Replicate(), Shard(0)),
                     "fc_expand_kernel": (Replicate(), Shard(1)),
                     "fc_expand_bias": (Replicate(), Shard(0)),
                     "conv1_kernel": (Replicate(), Replicate())}
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    a, b = tmesh.put_leading(m, (x, [x]))
    assert isinstance(a, torch.Tensor) and torch.equal(a, torch.from_numpy(x))
    assert torch.equal(tmesh.put_stacked(m, {"k": x})["k"], torch.from_numpy(x))
    assert tmesh.host_block(m, stacked=True)((x, None))[0] is not None
    loss, grads = tmesh.mean_over_ranks(m)(torch.tensor(2.5), {"w": torch.ones(3)})
    assert float(loss) == 2.5 and torch.equal(grads["w"], torch.ones(3))
    g = tmesh.gather_batch(m, torch.arange(6, dtype=torch.int16).reshape(3, 2))
    assert g.dtype == torch.int16 and g.tolist() == [[0, 1], [2, 3], [4, 5]]


def test_sharded_separator_matches_jax_and_whole_track(setting, world2):
    jp, params, pp, state = setting["sep"]
    mix = setting["mix"]
    want = np.asarray(JaxSharded(jp, params, jax_make_mesh(data=2))(mix))
    whole = Separator(pp, state, device="cpu")(mix)
    for out in world2:
        got = out["sharded"]
        assert got.shape == want.shape == (4, len(mix))
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        np.testing.assert_allclose(got, whole, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(world2[0]["sharded"], world2[1]["sharded"])


def test_sharded_separator_one_rank_and_refusals(setting, group):
    from convsep_tpu_torch.separate.sharded import ShardedSeparator

    jp, params, pp, state = setting["sep"]
    mix = setting["mix"]
    m = tmesh.make_mesh(device="cpu")
    got = ShardedSeparator(pp, state, m)(mix)
    np.testing.assert_allclose(got, Separator(pp, state, device="cpu")(mix), atol=2e-5, rtol=0)
    pallas = dataclasses.replace(pp, transform=dataclasses.replace(pp.transform,
                                                                   fft_impl="pallas"))
    with pytest.raises(ValueError, match="matmul"):
        ShardedSeparator(pallas, state, m)(mix)
    with pytest.raises(ValueError, match="mono"):
        ShardedSeparator(pp, state, m)(np.zeros((2, 100), np.float32))


def test_stream_separator_mesh_equals_unsharded(setting, world2):
    """Three tracks on two ranks (the batch padded to four), through
    ``separate_many`` and ``stream``; float32 and int16 stems."""
    ij, ipp, istate = setting["stream"]
    tracks = setting["tracks"]
    plain = StreamSeparator(ipp, istate, device="cpu").separate_many(tracks)
    plain16 = StreamSeparator(ipp, istate, device="cpu",
                              output_dtype="int16").separate_many(tracks)
    for out in world2:
        for got in out["stream"]:
            assert len(got) == 3
            for g, w in zip(got, plain):
                assert g.shape == w.shape
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
        for got in out["stream:int16"]:
            for g, w in zip(got, plain16):
                assert g.dtype == np.int16
                assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
    for a, b in zip(world2[0]["stream"][0], world2[1]["stream"][0]):
        np.testing.assert_array_equal(a, b)


def test_trainer_mesh_matches_jax_mesh_and_one_process(setting, world2, tmp_path):
    """Two ranks train 3 steps: each fed its half of the reference's
    batches, every rank ends with the same parameters, only rank 0 wrote
    the checkpoint; the first step's loss and grad norm, and each step from
    the reference's state, against the reference's mesh Trainer; and the
    port's single-process Trainer's first step."""
    t = setting["train"]
    (p0, seen0, pos0), (p1, seen1, pos1) = (out["train"] for out in world2)
    for k in p0:
        torch.testing.assert_close(p0[k], p1[k], rtol=0, atol=0)
    assert pos0 == pos1 == t["jt"]._data_pos
    assert os.listdir(setting["tmp"] / "run" / "checkpoints")
    j_seen = t["seen"]
    assert len(seen0) == len(seen1) == len(j_seen) == STEPS
    for (x0, l0, g0), (x1, l1, g1), (_, jx, _, _, jm) in zip(seen0, seen1, j_seen):
        np.testing.assert_array_equal(np.concatenate([x0, x1]), jx)
        assert (l0, g0) == (l1, g1)
    for key, i in (("loss", 1), ("grad_norm", 2)):
        np.testing.assert_allclose(seen0[0][i], float(j_seen[0][4][key]), rtol=TOL_FIRST_STEP)
    # one process, the same initial parameters and batches
    single = loop.Trainer(port(t["jp"]), device="cpu")
    with torch.no_grad():
        for k, v in t["init"].items():
            single.state.params[k].copy_(v)
    first = single.train_step(single.state, torch.from_numpy(j_seen[0][1]),
                              torch.from_numpy(j_seen[0][2]))[1]
    for key, i in (("loss", 1), ("grad_norm", 2)):
        np.testing.assert_allclose(seen0[0][i], float(first[key]), rtol=TOL_FIRST_STEP)
    # each step from the reference's state before it
    truth = _float64_step(t["jp"], t["jt"].opt)
    posts = [st.params for _, _, _, st, _ in j_seen[1:]] + [t["jt"].state.params]
    for i, ((_, x, y, pre, _), post) in enumerate(zip(j_seen, posts)):
        want = from_jax_params(post, t["cfg"])
        wide = from_jax_params(truth(jax.tree.map(jnp.asarray, pre), x, y), t["cfg"])
        scale = max(float(w.abs().max()) for w in want.values())
        atol = max(1e-5 * scale, 5 * max(float((wide[k] - w.double()).abs().max())
                                         for k, w in want.items()))
        for out in world2:
            got = out["steps"][i]
            for k, w in want.items():
                np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=atol,
                                           err_msg=f"step {i}: {k}")
