"""Spawning the port's sharded runs on the CPU: gloo ranks on one host.

`run_ranks(fn, shape, names, *args)` starts one process a rank with
``torch.multiprocessing``, gives each a gloo process group on a free
localhost port and a `Mesh` of ``shape``, calls ``fn(ctx, *args)`` and
returns rank 0's return value (a picklable object of numpy arrays).
It holds no tests of its own: the sharded tests import it.
"""
import os
import socket
import tempfile

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, shape, names, fn, args, out_path, ctx_kw):
    import torch.distributed as dist

    from repro_torch.models.parallel import ParallelContext, init_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_mesh(shape, names, backend="gloo")
        ctx = ParallelContext(mesh=mesh, **ctx_kw)
        out = fn(ctx, *args)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, shape=(2, 4), names=("data", "model"), *args, **ctx_kw):
    world = 1
    for n in shape:
        world *= n
    with tempfile.TemporaryDirectory() as d:
        out_path = os.path.join(d, "rank0.pt")
        mp.spawn(_worker, args=(world, free_port(), tuple(shape),
                                tuple(names), fn, args, out_path, ctx_kw),
                 nprocs=world, join=True)
        return torch.load(out_path, weights_only=False)


def jax_ref(case: str, inputs=None, timeout: int = 300):
    """The JAX package's sharded run `case` of ``test_torch_dist_jaxref.py`` on
    8 host devices, in a process of its own; returns its outputs."""
    import pickle
    import subprocess
    import sys

    import numpy as np
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(here, "..", "src"))
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.pkl")
        cmd = [sys.executable, os.path.join(here, "test_torch_dist_jaxref.py"),
               case, out]
        if inputs is not None:
            np.savez(os.path.join(d, "in.npz"), **inputs)
            cmd.append(os.path.join(d, "in.npz"))
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=timeout)
        assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
        with open(out, "rb") as f:
            return pickle.load(f)
