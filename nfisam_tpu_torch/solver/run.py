"""Incremental run harness: the per-step solve and its artifacts.

Counterpart of ``nfisam_tpu/solver/run.py``: ``run_incrementally``
creates ``run{N}`` under the case directory and writes the JAX package's
artifact set there (the parameters, and a step's samples, elimination
ordering, split timing, training losses, clique dim timing and, where
the graph has mixture factors, hypothesis weights; the step, fitting
and posterior timers of the run so far).  Every timer ends in a
synchronize on a card, so it measures the device's work; a step's
samples are stacked on the device and copied to the host once.  With
``plot_args`` each step's posterior is drawn to ``step{i}.png``, and a
run with mixture factors draws its hypothesis weights to
``hypoweights.png``, as the JAX package does.  Both need matplotlib:
``plot_args`` without it raises ``ImportError`` before the first step,
and a mixture run without it leaves out ``hypoweights.png`` alone and
says so once.
"""
from __future__ import annotations

import itertools
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..eval.viz import (matplotlib_pyplot, plot_2d_samples,
                        plot_hypothesis_weights)
from ..factors.mixtures import BinaryFactorMixture
from .solver import FactorGraphSolver


def run_incrementally(case_dir: str, solver: FactorGraphSolver,
                      nodes_factors_by_step, truth=None,
                      plot_args: Optional[dict] = None,
                      verbose: bool = True,
                      profile_steps: Optional[List[int]] = None) -> str:
    """Solve ``nodes_factors_by_step`` one step at a time and write the
    artifacts; returns the run directory.  ``truth`` (variable -> true
    value) is drawn on the ``plot_args`` plots, whose other options go to
    ``plot_2d_samples``.  ``profile_steps``: step indices traced by
    ``torch.profiler`` into ``<run_dir>/trace_step{i}.json``."""
    if plot_args is not None:
        matplotlib_pyplot()
    run_count = 1
    while os.path.exists(f"{case_dir}/run{run_count}"):
        run_count += 1
    run_dir = f"{case_dir}/run{run_count}"
    os.makedirs(run_dir)

    with open(f"{run_dir}/parameters", "w") as f:
        f.write(solver._args.json_str())

    num_batches = len(nodes_factors_by_step)
    step_timer: List[float] = []
    step_list: List[int] = []
    posterior_sampling_timer: List[float] = []
    fitting_timer: List[float] = []
    # mixture factor -> [(step, its posterior weights)]
    mixtures: Dict[BinaryFactorMixture, list] = {}

    for i in range(num_batches):
        step_nodes, step_factors = nodes_factors_by_step[i]
        for node in step_nodes:
            solver.add_node(node)
        for factor in step_factors:
            solver.add_factor(factor)
            if isinstance(factor, BinaryFactorMixture):
                mixtures[factor] = []

        step_list.append(i)
        prefix = f"{run_dir}/step{i}"
        detailed_timer: List[float] = []
        clique_dim_timer: List[List[float]] = []
        profiler = None
        if profile_steps is not None and i in profile_steps:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if solver.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.__enter__()
        start = solver._clock()
        solver.update_physical_and_working_graphs(timer=detailed_timer)
        cur_sample = solver.incremental_inference(
            timer=detailed_timer, clique_dim_timer=clique_dim_timer)
        step_timer.append(solver._clock() - start)
        if profiler is not None:
            profiler.__exit__(None, None, None)
            profiler.export_chrome_trace(f"{run_dir}/trace_step{i}.json")
        if verbose:
            print(f"step {i}/{num_batches} time: {step_timer[-1]:.3f} s, "
                  f"total: {sum(step_timer):.3f} s", flush=True)

        ordering = solver.elimination_ordering
        with open(f"{prefix}_ordering", "w") as f:
            f.write(" ".join(str(v.name) for v in ordering))
        with open(f"{prefix}_split_timing", "w") as f:
            f.write(" ".join(str(t) for t in detailed_timer))
        with open(f"{prefix}_step_training_loss", "w") as f:
            f.write(json.dumps(solver.training_losses()))

        if detailed_timer:
            posterior_sampling_timer.append(detailed_timer[-1])
            fitting_timer.append(sum(detailed_timer[1:-1]))

        X = torch.cat([cur_sample[v] for v in ordering], dim=1).cpu().numpy()
        np.savetxt(fname=prefix, X=X)
        np.savetxt(fname=prefix + "_dim_time", X=np.array(clique_dim_timer))

        for fname, data in (("step_timing", step_timer),
                            ("step_list", step_list),
                            ("posterior_sampling_timer",
                             posterior_sampling_timer),
                            ("fitting_timer", fitting_timer)):
            with open(f"{run_dir}/{fname}", "w") as f:
                f.write(" ".join(str(t) for t in data))

        host, col = {}, 0
        for v in ordering:
            host[v] = X[:, col:col + v.dim]
            col += v.dim
        if plot_args is not None:
            physical = set(solver.physical_vars)
            plot_2d_samples(
                samples_mapping=host, equal_axis=True,
                truth=None if truth is None else {
                    v: p for v, p in truth.items() if v in physical},
                truth_factors=[f for f in solver.physical_factors
                               if set(f.vars).issubset(physical)],
                title=f"Step {i}", file_name=f"{prefix}.png", **plot_args)

        if mixtures:
            with open(f"{prefix}.hypoweights", "w") as hf:
                for factor, history in mixtures.items():
                    weights = factor.posterior_weights(host)
                    hf.write(" ".join(str(v.name) for v in factor.vars) +
                             " : " + ",".join(str(w) for w in weights) +
                             "\n")
                    history.append((i, weights))

    if mixtures:
        _plot_hypothesis_weights(mixtures, f"{run_dir}/hypoweights.png",
                                 verbose)
    return run_dir


def _plot_hypothesis_weights(mixtures, file_name: str,
                             verbose: bool) -> None:
    """The mixture factors' weights by step (``plot_hypothesis_weights``),
    under the JAX package's labels; left out, with one line saying so,
    where matplotlib is missing."""
    step_weights: Dict[int, Dict] = {}
    for factor, history in mixtures.items():
        label = "->".join([str(factor.vars[0].name),
                           "|".join(str(v.name) for v in factor.vars[1:])])
        for step, w in history:
            step_weights.setdefault(step, {})[label] = w
    if not any(step_weights.values()):
        return
    try:
        matplotlib_pyplot()
    except ImportError as e:
        if verbose:
            print(f"{os.path.basename(file_name)} left out: {e}", flush=True)
        return
    plot_hypothesis_weights(step_weights, file_name=file_name)


def nfisam_empirical_study(knots, iters, training_samples, learning_rates,
                           hidden_dims, case_dir: str, data_file: str,
                           data_format: str, incremental_step: int = 1,
                           prior_cov_scale: float = 0.1,
                           plot_args: Optional[dict] = None,
                           solver_class=None, device=None,
                           **kwargs) -> List[str]:
    """Grid search: parse ``case_dir/data_file`` once, then run the whole
    incremental solve for every combination of (num_knots,
    flow_iterations, local_sample_num, learning_rate, hidden_dim), each in
    its own ``run{N}``; returns the run directories.  ``solver_class``
    defaults to ``ParallelNFiSAM``; other keyword arguments go to
    ``NFiSAMArgs``."""
    from ..io import graph_file_parser, group_nodes_factors_incrementally
    from .nfisam import NFiSAMArgs

    if solver_class is None:
        from ..parallel.scheduler import ParallelNFiSAM as solver_class

    nodes, truth, factors = graph_file_parser(
        os.path.join(case_dir, data_file), data_format,
        prior_cov_scale=prior_cov_scale)
    batches = group_nodes_factors_incrementally(
        nodes, factors, incremental_step=incremental_step)

    run_dirs: List[str] = []
    for knt, it, n_train, lr, hid in itertools.product(
            knots, iters, training_samples, learning_rates, hidden_dims):
        args = NFiSAMArgs(num_knots=knt, flow_iterations=it,
                          local_sample_num=n_train, learning_rate=lr,
                          hidden_dim=hid, **kwargs)
        run_dirs.append(run_incrementally(
            case_dir, solver_class(args, device=device), batches, truth,
            plot_args=plot_args))
    return run_dirs


# the reference's spelling
NFiSAM_empirial_study = nfisam_empirical_study
