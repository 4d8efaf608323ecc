"""Run jobs of the port on a gloo process group of CPU ranks, one process
a rank, for the distributed tests (``tests/test_torch_distributed.py``).

    python -m tests.torch_ranks <rank> <world> <dir>

reads ``<dir>/jobs.pt`` (a list of ``(name, kwargs)``), joins the group
through the file store ``<dir>/store`` and writes ``<dir>/out<rank>.pt``
(name → result). It imports neither jax nor the JAX package."""

from __future__ import annotations

import contextlib
import datetime
import os
import sys

import torch
import torch.distributed as dist


def _preset(d):
    from convsep_tpu_torch.configs import preset_from_dict

    return preset_from_dict(d)


def job_halo(mesh, frames, hop):
    from convsep_tpu_torch.distributed import halo_overlap_add

    return halo_overlap_add(torch.from_numpy(frames), hop, mesh).numpy()


def job_sharded(mesh, preset, state, audio):
    from convsep_tpu_torch.separate.sharded import ShardedSeparator

    return ShardedSeparator(_preset(preset), state, mesh)(audio).copy()


def job_stream(mesh, preset, state, tracks, batch_size, output_dtype="float32"):
    from convsep_tpu_torch.separate import StreamSeparator

    ss = StreamSeparator(_preset(preset), state, mesh=mesh, output_dtype=output_dtype)
    many = [o.copy() for o in ss.separate_many(tracks)]
    streamed = [o.copy() for b in ss.stream(iter(tracks), batch_size) for o in b]
    return many, streamed


def job_train(mesh, preset, params, features, steps, workdir, use_grain=False):
    from convsep_tpu_torch.data.pipeline import SegmentDataset
    from convsep_tpu_torch.train import loop

    pp = _preset(preset)
    tr = pp.train
    ds = SegmentDataset(features, pp.sources, time_context=tr.time_context, overlap=tr.overlap,
                        mult_factor_in=tr.mult_factor_in, mult_factor_out=tr.mult_factor_out)
    t = loop.Trainer(pp, workdir=workdir, mesh=mesh)
    with torch.no_grad():
        for k, v in params.items():
            t.state.params[k].copy_(v)
    seen = []
    step = t.train_step  # a spy records each step's (local) batch and metrics

    def spy(state, x, y):
        state, m = step(state, x, y)
        seen.append((x.numpy().copy(), float(m["loss"]), float(m["grad_norm"])))
        return state, m

    t.train_step = spy
    t.fit(ds, max_steps=steps, use_grain=use_grain)
    return {k: v.detach().clone() for k, v in t.state.params.items()}, seen, t.data_position


def job_steps(mesh, preset, pre):
    """One mesh step from each given state on its batch (this rank's block)."""
    from convsep_tpu_torch.distributed.mesh import mean_over_ranks, take_block
    from convsep_tpu_torch.train import loop

    pp = _preset(preset)
    _, opt = loop.create_train_state(pp, 0, "cpu")
    step = loop.make_train_step(pp, opt, reduce=mean_over_ranks(mesh))
    out = []
    for params, opt_state, x, y in pre:
        st, _ = loop.create_train_state(pp, 0, "cpu", params=params)
        st.opt_state = opt_state
        st, _ = step(st, torch.from_numpy(take_block(x, mesh, 0)),
                     torch.from_numpy(take_block(y, mesh, 0)))
        out.append({k: v.detach().clone() for k, v in st.params.items()})
    return out


def main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from convsep_tpu_torch.distributed import make_mesh

    try:
        mesh = make_mesh(device="cpu")
        out = {}
        for name, kw in torch.load(os.path.join(d, "jobs.pt"), weights_only=False):
            out[name] = globals()[f"job_{name.split(':')[0]}"](mesh, **kw)
        torch.save(out, os.path.join(d, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_mesh(store: str):
    """A gloo process group of the calling process alone and its mesh
    (data 1, model 1), destroyed on exit."""
    from convsep_tpu_torch.distributed import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=30))
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
