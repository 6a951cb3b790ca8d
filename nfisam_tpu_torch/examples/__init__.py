"""The JAX repo's examples (``examples/``) in the port, each a module under
the example's own family and name::

    python -m nfisam_tpu_torch.examples.toy_examples.r2_relative_eight_nodes
    python -m nfisam_tpu_torch.examples.toy_examples.r2_range_incremental
    python -m nfisam_tpu_torch.examples.toy_examples.eight_pose_circle
    python -m nfisam_tpu_torch.examples.toy_examples.five_node_range_incremental
    python -m nfisam_tpu_torch.examples.small_range_gaussian_problem.run_nfisam
    python -m nfisam_tpu_torch.examples.small_range_gaussian_problem.generate_reference_solution
    python -m nfisam_tpu_torch.examples.small_range_gaussian_problem.compute_mmd RUN REF
    python -m nfisam_tpu_torch.examples.manhattan_world_with_range.generate_and_run

Each runs the JAX example's configuration at full size and prints its
lines.  A module that runs a solver or a sampler also takes ``--device``
(default ``cuda``: without a card it exits 1 unless given ``--device
cpu``); one that writes files takes ``--out``, the directory that takes the
place of the JAX example's own (default: the family's name under
``tempfile.gettempdir()``).  ``compute_mmd`` is numpy alone and takes
neither.  Each module exposes the function that builds its graph, with the
package's ``core`` and ``factors`` (or parser) as arguments so that a test
builds the JAX example's graph through the same function, and ``run``,
which returns the example's readings as a dict.
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np


def example_device(prog: str, device):
    """The device an example runs on (``resolve_device``), or None after
    saying why on stderr: its ``main`` then returns 1."""
    from ..utils.device import resolve_device
    try:
        return resolve_device(device)
    except RuntimeError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return None


def default_out(family: str) -> str:
    """The directory a family's examples write to by default."""
    return os.path.join(tempfile.gettempdir(), family)


def plot_args(verbose: bool = True):
    """The JAX examples' ``plot_args={}`` where matplotlib imports; else
    None (no ``step{i}.png``), said once."""
    from ..eval.viz import matplotlib_pyplot
    try:
        matplotlib_pyplot()
    except ImportError as e:
        if verbose:
            print(f"step plots left out: {e}", flush=True)
        return None
    return {}


def moment_line(name: str, s: np.ndarray) -> str:
    """The JAX examples' line of a variable's sample mean and std."""
    return (f"{name}: mean {np.round(s.mean(0), 2)} "
            f"std {np.round(s.std(0), 2)}")


def step_lines(per_step) -> list:
    """The JAX examples' lines of each step: its variables' means and
    stds by name."""
    lines = []
    for i, samples in enumerate(per_step):
        lines.append(f"step {i}:")
        lines += ["  " + moment_line(n, samples[n]) for n in sorted(samples)]
    return lines


def solve_steps(solver_args: dict, steps, device) -> tuple:
    """``NFiSAM`` at ``solver_args`` through its entry points, one
    (nodes, factors) batch a step.  Returns (per-step timings, per-step
    host samples by name, the solver): ``run_incremental``'s."""
    from ..scripts.manhattan_scale_run import run_incremental
    from ..solver import NFiSAM, NFiSAMArgs

    solver = NFiSAM(NFiSAMArgs(**solver_args), device=device)
    timings, per_step = run_incremental(solver, steps, device)
    return timings, per_step, solver


def map_estimate(nodes, factors, device) -> dict:
    """``GaussNewtonMAP`` of the graph from its best of 512 ancestral
    draws: {name: point}."""
    from ..solver import GaussNewtonMAP

    m = GaussNewtonMAP(nodes, factors, device=device)
    m.solve()
    return {str(v.name): np.asarray(p, np.float64)
            for v, p in m.results().items()}


def map_distances(samples: dict, est: dict, names) -> tuple:
    """Of each of ``names``: the distance (m) of its posterior-mean
    translation from ``est``'s, and, for an SE(2) pose, of its circular
    mean heading, wrapped to [0, pi].  Returns ({name: m}, {name: rad})."""
    trans, heading = {}, {}
    for n in names:
        s = np.asarray(samples[n], np.float64)
        trans[n] = float(np.linalg.norm(s[:, :2].mean(0) - est[n][:2]))
        if s.shape[1] == 3:
            mean = np.arctan2(np.sin(s[:, 2]).mean(), np.cos(s[:, 2]).mean())
            d = abs(mean - est[n][2]) % (2 * np.pi)
            heading[n] = float(min(d, 2 * np.pi - d))
    return trans, heading
