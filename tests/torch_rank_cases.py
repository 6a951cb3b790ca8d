"""Rank programs of the port's multi-rank tests, and the launcher that
spawns them.

``run_ranks(case, world, tmp, device)`` starts ``world`` processes of
``python tests/torch_rank_cases.py CASE RANK WORLD RENDEZVOUS OUT
DEVICE``; each joins a ``torch.distributed`` group at a ``file://``
rendezvous in ``tmp`` (so parallel test workers never share a port), runs
``CASES[CASE]`` and saves what it computed to ``OUT`` with
``torch.save``.  The ranks import torch, numpy and the port, never JAX.
The inputs of every case come from ``inputs`` (numpy seeds), so a test
process rebuilds them for its world-1 reference."""
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nfisam_tpu_torch.flows import NSFConfig  # noqa: E402
from nfisam_tpu_torch.train import TrainConfig  # noqa: E402

CASES = {}
# host_parallel values probed in a group, with what each should give
HOST_MODES = ["auto", True, "on", 1, False, "off", 0, "false"]


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def keys(B: int) -> np.ndarray:
    return np.stack([np.array([0, i], np.uint32) for i in range(B)])


def inputs(name: str, device="cpu"):
    """The inputs of a case, from numpy seeds."""
    rng = np.random.default_rng({"chunked": 5, "step": 1, "sampler": 2,
                                 "fits": 3}[name])
    if name == "chunked":
        stack = rng.normal(size=(5, 64, 4)).astype(np.float32)
        return (NSFConfig(dim=4, num_knots=5, hidden_dim=4),
                TrainConfig(max_iters=30, learning_rate=0.05),
                torch.as_tensor(stack, device=device))
    if name == "step":
        return (NSFConfig(dim=4, num_knots=5, hidden_dim=4),
                torch.as_tensor(rng.normal(size=(4, 64, 4)).astype(
                    np.float32), device=device))
    if name == "sampler":
        return (NSFConfig(dim=5, num_knots=5, hidden_dim=4),
                torch.as_tensor(rng.normal(size=(64, 2)).astype(np.float32),
                                device=device),
                torch.as_tensor(rng.normal(size=(64, 3)).astype(np.float32),
                                device=device))
    return {"raw256": rng.normal(size=(256, 3)).astype(np.float32),
            "raw150": rng.normal(size=(150, 4)).astype(np.float32),
            "raw3": rng.normal(size=(3, 4)).astype(np.float32),
            "stack160": rng.normal(size=(3, 160, 4)).astype(np.float32),
            "stack150": rng.normal(size=(3, 150, 4)).astype(np.float32)}


def sampler_params(cfg, device="cpu"):
    from nfisam_tpu_torch.flows import init_flow_params
    from nfisam_tpu_torch.utils.keys import torch_generator
    return init_flow_params(torch_generator(np.array([0, 2], np.uint32),
                                            device), cfg, device)


def r2_graph_solve(device, seed: int = 3, mesh=None, sample_mesh=None):
    """The 3-variable R^2 graph of the JAX package's
    ``tests/test_mesh.py`` solved by ``ParallelNFiSAM``; (samples by name,
    shard rows of the fused pass)."""
    from nfisam_tpu_torch.core.variables import R2Variable, VariableType
    from nfisam_tpu_torch.factors import (GaussianPriorFactor,
                                          R2RelativeGaussianLikelihoodFactor)
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import NFiSAMArgs
    a, b = R2Variable("x0"), R2Variable("x1")
    c = R2Variable("l1", variable_type=VariableType.Landmark)
    args = NFiSAMArgs(posterior_sample_num=512, local_sample_num=512,
                      flow_iterations=150, num_knots=5, hidden_dim=4,
                      learning_rate=0.05, elimination_method="pose_first",
                      seed=seed, data_parallel_mesh=mesh,
                      sample_mesh=sample_mesh)
    s = ParallelNFiSAM(args, device=device)
    for v in (a, b, c):
        s.add_node(v)
    s.add_factor(GaussianPriorFactor(a, np.zeros(2), np.eye(2) * 0.04))
    s.add_factor(R2RelativeGaussianLikelihoodFactor(
        a, b, np.array([1.0, 0.0]), np.eye(2) * 0.01))
    s.add_factor(R2RelativeGaussianLikelihoodFactor(
        b, c, np.array([0.0, 1.0]), np.eye(2) * 0.01))
    s.update_physical_and_working_graphs()
    samples = s.incremental_inference()
    return ({str(v.name): x.cpu() for v, x in samples.items()},
            getattr(samples, "shard_rows", None))


def step_run(mesh, device, steps: int = 30, key=(0, 7)):
    """(params and losses after one step, losses after ``steps`` more) of
    the sharded train step from ``init`` with ``key``."""
    from nfisam_tpu_torch.parallel import build_sharded_train_step
    cfg, data = inputs("step", device)
    step, init, shard = build_sharded_train_step(cfg, mesh,
                                                 learning_rate=0.05)
    params, state = init(np.array(key, np.uint32), 4, device)
    local = shard(data)
    params, state, loss1 = step(params, state, local)
    first = ([{k: v.cpu() for k, v in p.items()} for p in params],
             loss1.cpu())
    loss = loss1
    for _ in range(steps):
        params, state, loss = step(params, state, local)
    return first, loss.cpu()


def grid():
    """The mesh of the step, sampler and pass cases: (2, 2) on 4 ranks,
    (1, 2) on 2."""
    from nfisam_tpu_torch.parallel import make_mesh
    from nfisam_tpu_torch.parallel.mesh import world
    n = world()[1]
    n_clique = 2 if n % 4 == 0 else 1
    return make_mesh(n_clique=n_clique, n_data=n // n_clique)


# --------------------------------------------------------------------------
# the cases (one rank's part each)
# --------------------------------------------------------------------------
@case
def chunked(device):
    """``train_chunked`` at B = 3, 4, 5, and ``host_parallel_enabled``
    for every mode, inside the group and with a mesh set."""
    from nfisam_tpu_torch.parallel import (data_parallel_mesh,
                                           host_parallel_enabled,
                                           train_chunked)
    from nfisam_tpu_torch.solver import NFiSAMArgs
    cfg, tc, stack = inputs("chunked", device)
    out = {}
    for B in (3, 4, 5):
        fitted, idx = train_chunked(keys(B), stack[:B], cfg, tc,
                                    np.zeros((B, 4), bool))
        out[B] = ([{k: v.cpu() for k, v in p.items()} for p in fitted[0]],
                  fitted[1].cpu(), fitted[2], fitted[3].cpu(),
                  fitted[4].cpu(), idx.tolist())
    out["modes"] = [host_parallel_enabled(NFiSAMArgs(host_parallel=m))
                    for m in HOST_MODES]
    mesh = data_parallel_mesh()
    out["with_mesh"] = host_parallel_enabled(NFiSAMArgs(
        data_parallel_mesh=mesh))
    try:
        host_parallel_enabled(NFiSAMArgs(host_parallel="sometimes"))
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    return out


@case
def step(device):
    mesh = grid()
    first, last = step_run(mesh, device)
    return {"shape": dict(mesh.shape), "index": (mesh.clique_index,
                                                 mesh.data_index),
            "cliques": mesh.rows(4, "clique"), "first": first, "last": last}


# the init keys of ``step_keys``: [s, 7] for s = 0-15
STEP_KEYS = [(s, 7) for s in range(16)]


@case
def step_keys(device):
    """The step case's losses after 1 and 31 steps for each of
    ``STEP_KEYS``."""
    mesh = grid()
    out = {}
    for key in STEP_KEYS:
        (_, first), last = step_run(mesh, device, key=key)
        out[key] = (first, last)
    return out


@case
def sampler(device):
    from nfisam_tpu_torch.parallel import build_sharded_conditional_sampler
    cfg, xp, z = inputs("sampler", device)
    draw = build_sharded_conditional_sampler(cfg, grid(), 2)
    return {"out": draw(sampler_params(cfg, device), xp, z).cpu()}


@case
def fits(device):
    """Fits on a data mesh (1, 4) and a (2, 2) mesh."""
    from nfisam_tpu_torch.parallel import data_parallel_mesh, make_mesh
    from nfisam_tpu_torch.train import fit_flow_raw, fit_flows_batched
    data = inputs("fits")
    dp, grid = data_parallel_mesh(), make_mesh(n_clique=2, n_data=2)
    tc = TrainConfig(max_iters=40, learning_rate=0.05)
    out = {}
    for name, cfg, x in (("raw256", NSFConfig(dim=3, num_knots=5,
                                              hidden_dim=4), "raw256"),
                         ("raw150", NSFConfig(dim=4, num_knots=5,
                                              hidden_dim=4), "raw150"),
                         ("raw3", NSFConfig(dim=4, num_knots=5,
                                            hidden_dim=4), "raw3")):
        r = fit_flow_raw(np.array([0, 1], np.uint32),
                         torch.as_tensor(data[x], device=device), cfg, tc,
                         [False] * cfg.dim, mesh=dp)
        out[name] = (r[1].cpu(), r[2], r[3].cpu(), r[4].cpu())
    cfg = NSFConfig(dim=4, num_knots=5, hidden_dim=4)
    for name, mesh in (("stack160", grid), ("stack150", dp)):
        r = fit_flows_batched(keys(3), torch.as_tensor(data[name],
                                                       device=device),
                              cfg, tc, np.zeros((3, 4), bool), mesh=mesh)
        out[name] = ([{k: v.cpu() for k, v in p.items()} for p in r[0]],
                     r[1].cpu(), r[2], r[3].cpu(), r[4].cpu())
    return out


@case
def fused(device):
    samples, rows = r2_graph_solve(device, sample_mesh=grid())
    return {"samples": samples, "shard_rows": rows}


@case
def solve(device):
    from nfisam_tpu_torch.parallel import make_mesh
    mesh = make_mesh(n_clique=2, n_data=2)
    samples, rows = r2_graph_solve(device, mesh=mesh, sample_mesh=mesh)
    return {"samples": samples, "shard_rows": rows}


# --------------------------------------------------------------------------
# launcher
# --------------------------------------------------------------------------
def run_ranks(name: str, world: int, tmp, device: str = "cpu",
              timeout: float = 600.0) -> list:
    """Run case ``name`` in ``world`` rank processes; their results in
    rank order.  Raises with a failed rank's output."""
    tmp = str(tmp)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    rdv = os.path.join(tmp, f"rendezvous_{name}")
    outs = [os.path.join(tmp, f"{name}_rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), name, str(r), str(world),
         rdv, outs[r], device], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {name} exited {p.returncode}:"
                               f"\n{logs[r][-4000:]}")
    return [torch.load(o, weights_only=False) for o in outs]


def main(name, rank, world, rendezvous, out, device) -> None:
    from nfisam_tpu_torch.parallel import (destroy_process_group,
                                           init_process_group)
    torch.set_num_threads(1)
    init_process_group(int(rank), int(world), f"file://{rendezvous}",
                       device)
    try:
        result = CASES[name](torch.device(device))
    finally:
        destroy_process_group()
    torch.save(result, out)


if __name__ == "__main__":
    main(*sys.argv[1:])
