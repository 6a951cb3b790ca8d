"""Multi-process clique-parallel training over ``torch.distributed``.

Counterpart of ``nfisam_tpu/parallel/multihost.py``, with a rank of the
default process group in the place of a JAX process:

* each bucket's clique axis is split into contiguous chunks, one a rank;
  every rank trains only its chunk, and the trained stacks are gathered
  with one collective, so every rank goes on with the whole tree;
* the rest of the solve (graph surgery, simulation, the posterior pass)
  runs in every rank.  It is milliseconds a step, and running it
  everywhere keeps every rank's state, the key stream included, in
  lockstep without further communication.

Cliques of one bucket share dim, sample count and iteration cap, so equal
contiguous chunks balance by construction; a lone clique trains in every
rank (identical results, no communication).

A (clique, data) mesh (``parallel/mesh.py``) spans every rank of the group
and plays the part of one JAX process's devices: with a mesh set the
group is one host, and buckets are not chunked by rank.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import world


def init_process_group(rank: int, world_size: int, init_method: str,
                       device="cuda") -> str:
    """Join the default process group as ``rank`` of ``world_size`` at
    ``init_method`` (e.g. ``file://`` a path in a temporary directory).
    Returns the backend.

    On a card: ``nccl`` where each rank owns a card of its own (rank r on
    card r); ``gloo`` where ranks share one, since NCCL refuses two ranks
    on one device.  Gloo reduces CUDA tensors through the host (the mesh's
    collectives copy them there and back).  On the CPU: ``gloo``.  A rank
    asked for a card that finds none raises."""
    device = torch.device(device)
    backend = "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device")
        if torch.cuda.device_count() >= world_size:
            backend = "nccl"
            torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend


def destroy_process_group() -> None:
    """Leave the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def host_parallel_enabled(args) -> bool:
    """True when bucket chunking across ranks should be used: with more
    than one rank acting as a host (a mesh spans the group, so with one
    set the ranks are one host's devices)."""
    mode = getattr(args, "host_parallel", "auto")
    if mode in (False, 0, "off", "0", "false"):
        return False
    _, n = world()
    mesh = getattr(args, "data_parallel_mesh", None) or \
        getattr(args, "sample_mesh", None)
    if mesh is not None:
        n //= mesh.size
    if mode in (True, 1, "on", "1", "true"):
        return n > 1
    if mode == "auto":
        return n > 1
    raise ValueError(f"host_parallel={mode!r}: use True/False/'auto'")


def train_chunked(keys: np.ndarray, samples_stack: torch.Tensor, cfg, tc,
                  masks, scale_circular: bool = True,
                  mesh=None) -> Tuple[tuple, np.ndarray]:
    """Train a same-signature clique stack split across ranks.

    The same results as ``trainer.fit_flows_batched`` on the whole stack,
    bit for bit, except each rank computes only its contiguous chunk of
    ceil(B / ranks) cliques and the stacks are gathered on the host with
    one collective.  A member's fit does not depend on the other members
    of its loop, but on a card it does depend on the loop's width (the
    batched kernels and their reduction order are picked by shape), so a
    chunk trains at the width B, its last clique repeated.  Returns
    ``(outputs, trained_idx)``: ``outputs`` as ``fit_flows_batched``'s,
    on ``samples_stack``'s device, and ``trained_idx`` the clique indices
    THIS rank trained."""
    from ..train.trainer import fit_flows_batched, gather_fits

    B = int(np.asarray(keys).shape[0])
    pid, P = world()
    chunk = -(-B // P)
    lo, hi = pid * chunk, min((pid + 1) * chunk, B)
    # this rank's cliques (the last one again where the chunks overrun B),
    # then repeats of its last clique up to the width B
    idx = [min(i, B - 1) for i in range(pid * chunk, (pid + 1) * chunk)]
    idx += [idx[-1]] * (B - len(idx))
    out = fit_flows_batched(np.asarray(keys)[idx], samples_stack[idx], cfg,
                            tc, np.asarray(masks, dtype=bool)[idx],
                            scale_circular=scale_circular, mesh=mesh)
    params, iter_loss, n_iters, mean, std = out
    out = ([{k: v[:chunk] for k, v in p.items()} for p in params],
           iter_loss[:chunk], n_iters[:chunk], mean[:chunk], std[:chunk])
    # one host-side gather a bucket: parameter stacks are kilobytes
    out = gather_fits(out, None if P == 1 else dist.group.WORLD, B)
    return out, np.arange(lo, hi)
