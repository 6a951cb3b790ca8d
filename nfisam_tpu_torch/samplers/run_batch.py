"""Incremental batch runs of the global comparison samplers.

Counterpart of ``nfisam_tpu/samplers/run_batch.py``: replay a factor
graph step by step, solve the whole graph observed so far from scratch at
each step with a global sampler, and write the JAX package's artifact set
(``config.json``, ``step{i}.summary``, ``step{i}_ordering``,
``step{i}.sample``, ``step_timing``, ``step_list`` and, where the graph
has mixture factors, ``step{i}.hypoweights``) under ``dyn{N}``,
``nuts{N}`` or ``smc{N}``, and each step's plot (``step{i}.png``, drawn
with ``plot_args``).  Plots need matplotlib: without it ``plot_args``
raises ``ImportError`` before the first step, and a run without
``plot_args`` leaves the plots out and says so once.  The samplers run on
``device`` (``cuda`` unless named); ``parallel_config`` is accepted and
ignored, as in the JAX package.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.variables import Variable
from ..eval.viz import matplotlib_pyplot, plot_2d_samples
from ..factors.mixtures import BinaryFactorMixture
from ..io import graph_file_parser, group_nodes_factors_incrementally
from ..utils.functions import NumpyEncoder
from .nested import GlobalNestedSampler
from .nuts import GlobalMCMCSampler
from .smc import GlobalSMCSampler


def sampler_run_batch(make_sampler: Callable, sample_step: Callable,
                      run_prefix: str, case_dir: str, data_file: str,
                      data_format: str, incremental_step: int = 1,
                      selected_steps: Optional[Sequence[int]] = None,
                      prior_cov_scale: float = 0.1,
                      plot_args: Optional[dict] = None,
                      config: Optional[dict] = None,
                      verbose: bool = True) -> str:
    """Generic incremental replay harness.

    ``make_sampler(nodes, factors)`` builds a global sampler over the
    currently observed sub-graph; ``sample_step(sampler, summary)`` runs it
    and returns an ``(n, total_dim)`` array.  Returns the run directory.
    """
    try:
        matplotlib_pyplot()
        plots = True
    except ImportError as e:
        if plot_args is not None:
            raise
        plots = False
        if verbose:
            print(f"step plots left out: {e}", flush=True)
    data_dir = os.path.join(case_dir, data_file)
    nodes, truth, factors = graph_file_parser(
        data_file=data_dir, data_format=data_format,
        prior_cov_scale=prior_cov_scale)
    nodes_factors_by_step = group_nodes_factors_incrementally(
        nodes=nodes, factors=factors, incremental_step=incremental_step)

    run_count = 1
    while os.path.exists(f"{case_dir}/{run_prefix}{run_count}"):
        run_count += 1
    run_dir = f"{case_dir}/{run_prefix}{run_count}"
    os.makedirs(run_dir)
    with open(f"{run_dir}/config.json", "w") as fp:
        json.dump(config or {}, fp, cls=NumpyEncoder)

    num_batches = len(nodes_factors_by_step)
    observed_nodes: List[Variable] = []
    observed_factors: List = []
    step_timer: List[float] = []
    step_list: List[int] = []
    mixture_factor2weights: Dict = {}

    for i in range(num_batches):
        step_nodes, step_factors = nodes_factors_by_step[i]
        observed_nodes += step_nodes
        observed_factors += step_factors
        for factor in step_factors:
            if isinstance(factor, BinaryFactorMixture):
                mixture_factor2weights[factor] = []
        if selected_steps is not None and i not in selected_steps:
            continue

        sampler = make_sampler(observed_nodes, observed_factors)
        step_list.append(i)
        prefix = f"{run_dir}/step{i}"
        summary: Dict = {}
        start = time.time()
        sample_arr = np.asarray(sample_step(sampler, summary))
        step_timer.append(time.time() - start)

        if summary:
            with open(f"{prefix}.summary", "w") as fp:
                fp.write(json.dumps(summary, cls=NumpyEncoder))

        cur_sample: Dict[Variable, np.ndarray] = {}
        cur_dim = 0
        for var in observed_nodes:
            cur_sample[var] = sample_arr[:, cur_dim:cur_dim + var.dim]
            cur_dim += var.dim

        if verbose:
            print(f"step {i}/{num_batches} time: {step_timer[-1]:.3f} s, "
                  f"total: {sum(step_timer):.3f} s")

        with open(f"{prefix}_ordering", "w") as f:
            f.write(" ".join(str(v.name) for v in observed_nodes))
        np.savetxt(fname=f"{prefix}.sample", X=sample_arr)
        if plots:
            plot_2d_samples(
                samples_mapping=cur_sample,
                truth={v: p for v, p in truth.items()
                       if v in observed_nodes},
                truth_factors=[f for f in observed_factors
                               if set(f.vars).issubset(observed_nodes)],
                file_name=f"{prefix}.png", title=f"Step {i}",
                **(plot_args or {}))
        with open(f"{run_dir}/step_timing", "w") as f:
            f.write(" ".join(str(t) for t in step_timer))
        with open(f"{run_dir}/step_list", "w") as f:
            f.write(" ".join(str(s) for s in step_list))

        if mixture_factor2weights:
            with open(f"{prefix}.hypoweights", "w") as hypo_file:
                for factor, weights in mixture_factor2weights.items():
                    hypo_weights = factor.posterior_weights(cur_sample)
                    line = (" ".join(v.name for v in factor.vars) + " : "
                            + ",".join(str(w) for w in hypo_weights))
                    hypo_file.write(line + "\n")
                    weights.append(hypo_weights)
    return run_dir


def nested_run_batch(live_points: int, case_dir: str, data_file: str,
                     data_format: str, incremental_step: int = 1,
                     selected_steps: Optional[Sequence[int]] = None,
                     parallel_config=None, prior_cov_scale: float = 0.1,
                     plot_args: Optional[dict] = None,
                     dynamic_ns: bool = False, xlim=None, ylim=None,
                     verbose: bool = True, device=None, **kwargs) -> str:
    """Nested-sampling replay: run directories ``dyn{N}``, a per-step
    ``.summary`` with logz, ncall and efficiency."""
    del parallel_config
    method = "dynamic" if dynamic_ns else "nested"

    def make(nodes, factors):
        return GlobalNestedSampler(nodes=nodes, factors=factors,
                                   device=device, xlim=xlim, ylim=ylim)

    def step(sampler, summary):
        return sampler.sample(live_points=live_points,
                              sampling_method=method,
                              res_summary=summary, **kwargs)

    return sampler_run_batch(
        make, step, "dyn", case_dir, data_file, data_format,
        incremental_step, selected_steps, prior_cov_scale, plot_args,
        config=dict(live_points=live_points, dynamic_ns=dynamic_ns,
                    **kwargs),
        verbose=verbose)


dynesty_run_batch = nested_run_batch  # the reference's name


def nuts_run_batch(draws: int, case_dir: str, data_file: str,
                   data_format: str, incremental_step: int = 1,
                   selected_steps: Optional[Sequence[int]] = None,
                   nuts_config: Optional[dict] = None,
                   prior_cov_scale: float = 0.1,
                   plot_args: Optional[dict] = None,
                   verbose: bool = True, device=None) -> str:
    """NUTS replay: run directories ``nuts{N}``."""
    def make(nodes, factors):
        return GlobalMCMCSampler(nodes=nodes, factors=factors,
                                 device=device)

    def step(sampler, summary):
        out = sampler.sample(num_samples=draws, **(nuts_config or {}))
        summary.update(getattr(sampler, "diagnostics", {}) or {})
        return out

    return sampler_run_batch(
        make, step, "nuts", case_dir, data_file, data_format,
        incremental_step, selected_steps, prior_cov_scale, plot_args,
        config=dict(draws=draws, **(nuts_config or {})), verbose=verbose)


def smc_run_batch(draws: int, case_dir: str, data_file: str,
                  data_format: str, incremental_step: int = 1,
                  selected_steps: Optional[Sequence[int]] = None,
                  smc_config: Optional[dict] = None,
                  prior_cov_scale: float = 0.1,
                  plot_args: Optional[dict] = None, xlim=None, ylim=None,
                  verbose: bool = True, device=None, **kwargs) -> str:
    """SMC replay: run directories ``smc{N}``."""
    def make(nodes, factors):
        return GlobalSMCSampler(nodes=nodes, factors=factors,
                                device=device, xlim=xlim, ylim=ylim)

    def step(sampler, summary):
        return sampler.sample(num_samples=draws, summary=summary,
                              **(smc_config or {}), **kwargs)

    return sampler_run_batch(
        make, step, "smc", case_dir, data_file, data_format,
        incremental_step, selected_steps, prior_cov_scale, plot_args,
        config=dict(draws=draws, **(smc_config or {})), verbose=verbose)
