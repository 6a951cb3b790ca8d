"""NF-iSAM: normalizing-flow clique density models on the Bayes tree.

Counterpart of ``nfisam_tpu/solver/nfisam.py`` (sequential ``NFiSAM``):
each clique's simulated samples are padded to a dim bucket, one NSF-AR
flow is fitted to them, and the flow's separator marginal goes up the
tree as a ``FlowsPriorFactor``.  Conditional draws go through the masked
AR inverse, which is the CUDA kernel on a card.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core.distributions import norm_ppf
from ..core.variables import Variable, circular_dim_list
from ..factors.factors import grad_rows
from ..flows.ar_inverse import stack_inverse_masked_differentiable
from ..flows.model import (CliqueFlowModel, _select_inverse_fn,
                           conditional_draw_core)
from ..flows.nsf import NSFConfig
from ..graph.bayes_tree import CliqueNode
from ..samplers.simulation import compile_schedule
from ..train.trainer import TrainConfig, fit_flow_raw
from ..utils.keys import torch_generator
from ..utils.tracing import tracer
from .checkpoint import CliqueModelStore, clique_signature, content_tag
from .solver import (CliqueSeparatorFactor, ConditionalSampler,
                     FactorGraphSolver, SolverArgs)

# clique-dim bucketing: by default every clique pads up to the next power
# of two at least ``dim_bucket_floor`` (this) large, so a solve hits few
# flow shapes
DIM_BUCKET_FLOOR = 16


@dataclass
class NFiSAMArgs(SolverArgs):
    elimination_method: str = "pose_first"
    learning_rate: float = 0.015
    flow_number: int = 1
    flow_type: str = "NSF_AR"          # NSF_AR | NSF_AR_CS
    flow_iterations: int = 2000
    num_knots: int = 12
    hidden_dim: int = 8
    average_window: int = 50
    loss_delta_tol: float = 1e-2
    checkpoint_dir: Optional[str] = None
    # a directory to write each trained clique's loss curve to
    # (``<sorted clique variable names>.txt``); nothing if it is missing
    training_loss_dir: Optional[str] = None
    # validation-based stopping: below 1, a shuffled held-out part of each
    # clique's samples is scored every ``validation_interval`` iterations,
    # and training stops at ``slower_stop_rate`` times the iteration its
    # loss first rose (the plateau stop is then off)
    training_set_frac: float = 1.0
    validation_interval: int = 10
    slower_stop_rate: float = 2.0
    # a (clique, data) mesh over the ranks of a process group
    # (``parallel.mesh``): flow fits shard over it, posterior draws over
    # ``sample_mesh``'s data axis
    data_parallel_mesh: Optional[object] = None
    sample_mesh: Optional[object] = None
    # bucket chunking across the ranks of a process group
    # (``parallel/multihost.py``): "auto" = on with more than one rank and
    # no mesh
    host_parallel: object = "auto"
    # clique-dim bucketing: 0 pads every clique up to the next power of
    # two >= ``dim_bucket_floor``; a positive value pads to that multiple
    pad_dim_multiple: int = 0
    dim_bucket_floor: int = DIM_BUCKET_FLOOR
    # the conditioner width grows with the clique: max(hidden_dim,
    # aug_dim // 2); False keeps hidden_dim
    scale_hidden_with_dim: bool = True

    def train_config(self) -> TrainConfig:
        return TrainConfig(
            max_iters=self.flow_iterations,
            learning_rate=self.learning_rate,
            average_window=self.average_window,
            loss_delta_tol=self.loss_delta_tol,
            validation_interval=self.validation_interval,
            slower_stop_rate=self.slower_stop_rate,
            training_set_frac=self.training_set_frac)


def effective_hidden_dim(args, aug_dim: int) -> int:
    """Conditioner width for a clique of ``aug_dim`` columns
    (``NFiSAMArgs.scale_hidden_with_dim``)."""
    if getattr(args, "scale_hidden_with_dim", True):
        return max(int(args.hidden_dim), int(aug_dim) // 2)
    return int(args.hidden_dim)


class FlowModelAdapter(ConditionalSampler):
    """A ``CliqueFlowModel`` behind the solver's conditional-sampler
    protocol; each draw takes the next key of the solver's stream.

    With a ``mesh`` of several data ranks, a draw given observations whose
    rows split evenly over the data axis inverts only this rank's rows and
    gathers the rest: every rank draws the whole base sample from the key
    and keeps its rows, and the inverse is row by row, so the gathered
    draw is the unsharded one."""

    def __init__(self, model: CliqueFlowModel, key_source, mesh=None):
        self.model = model
        self._next_key = key_source
        self._mesh = mesh

    def conditional_sample_given_observation(self, conditional_dim,
                                             obs_samples=None,
                                             sample_number=None):
        if obs_samples is None and sample_number is None:
            raise ValueError("need obs_samples or sample_number")
        n = sample_number if sample_number is not None else 0
        mesh = self._mesh
        if mesh is not None and obs_samples is not None and \
                mesh.shape["data"] > 1 and \
                obs_samples.shape[0] % mesh.shape["data"] == 0:
            from ..parallel.mesh import all_gather_rows
            m = self.model
            gen = torch_generator(self._next_key(), m.device)
            rows = mesh.rows(obs_samples.shape[0])
            z = m.base.sample(gen, obs_samples.shape[0], m.device)[rows]
            out = all_gather_rows(m.conditional_draw(z, obs_samples[rows]),
                                  mesh.group("data"))
        else:
            out = self.model.conditional_sample(self._next_key(), n,
                                                obs_samples=obs_samples)
        return out[:, :conditional_dim] if conditional_dim else out


class FlowsPriorFactor(CliqueSeparatorFactor):
    """Separator-marginal factor backed by a trained flow."""

    def __init__(self, vars: List[Variable], flow_model: CliqueFlowModel,
                 true_obs: np.ndarray, circular_dim_list: List[bool],
                 key_source) -> None:
        self._vars = list(vars)
        self._flow_model = flow_model
        self._true_obs = np.asarray(true_obs, dtype=np.float64).reshape(-1)
        self._obs_dim = self._true_obs.shape[0]
        self._circular_dim_list = list(circular_dim_list)
        self._next_key = key_source
        if self.dim != len(self._circular_dim_list):
            raise ValueError("circular_dim_list does not match the vars")
        # the backing flow's fingerprint, read by the checkpoint signature
        # of the cliques above: the tag stamped at training, else a hash
        # of the flow's normalizer and last layer
        self.content_tag = flow_model.content_tag or hashlib.sha256(
            flow_model.mean.cpu().numpy().tobytes() +
            flow_model.std.cpu().numpy().tobytes() +
            flow_model.flow_params[0]["b3"].detach().cpu().numpy().tobytes()
        ).hexdigest()[:16]

    @property
    def vars(self) -> List[Variable]:
        return self._vars

    @property
    def circular_dim_list(self) -> List[bool]:
        return self._circular_dim_list

    def _obs_block(self, n: int) -> torch.Tensor:
        return self._const("_true_obs", self._flow_model.device).expand(
            n, self._obs_dim)

    def _augment(self, x: torch.Tensor) -> torch.Tensor:
        if self._obs_dim == 0:
            return x
        return torch.cat([self._obs_block(x.shape[0]), x], dim=1)

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        """Separator marginal log density (up to a constant: the stored
        observation columns are fixed)."""
        aug = self._augment(x.to(self._flow_model.device, torch.float32))
        _, prior_lp, log_det = self._flow_model.separator_forward(aug)
        return prior_lp + log_det

    def grad_x_log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        """Gradient of ``log_pdf`` in the separator columns."""
        def log_density(aug):
            _, prior_lp, log_det = \
                self._flow_model.separator_forward_differentiable(aug)
            return prior_lp + log_det

        aug = self._augment(x.to(self._flow_model.device, torch.float32))
        return grad_rows(log_density, aug)[:, self._obs_dim:]

    def unif_to_sample(self, u: torch.Tensor) -> torch.Tensor:
        """A single ``(d,)`` or a batch ``(n, d)`` of unit-cube points to
        separator samples: the flow's masked AR inverse of their normal
        quantiles with the observation columns pinned (the kernel on a
        card).  A flow wider than this factor (frontal and pad columns)
        takes zeros in the extra dims, which are sliced off.  It has a
        gradient in ``u``: the inverse's implicit-function VJP
        (``MaskedStackInverse``), where the JAX package differentiates its
        plain ``stack_inverse``."""
        return self._unif_to_sample(
            u, _select_inverse_fn(self._flow_model.device))

    def _unif_to_sample(self, u: torch.Tensor, inverse_fn) -> torch.Tensor:
        """``unif_to_sample`` through the masked AR inverse ``inverse_fn``."""
        m = self._flow_model
        squeeze = u.ndim == 1
        u = torch.atleast_2d(u).to(m.device, torch.float32)
        n, sep = u.shape[0], self._obs_dim
        z = norm_ppf(torch.clamp(u, 1e-12, 1.0 - 1e-12))
        z_full = torch.zeros((n, m.dim), dtype=torch.float32,
                             device=m.device)
        z_full[:, sep:sep + z.shape[1]] = z
        invert_mask = self.__dict__.get("_invert_mask")
        if invert_mask is None:
            invert_mask = self._invert_mask = torch.as_tensor(
                np.arange(m.dim) >= sep, device=m.device)

        def differentiable(flow_params, z_in, x_prefix, mask, cfg):
            return stack_inverse_masked_differentiable(
                flow_params, z_in, x_prefix, mask, cfg, inverse_fn)

        x = conditional_draw_core(
            m.flow_params, m.mean, m.std, m.circ_mask, z_full,
            m._padded(self._obs_block(n)), invert_mask, m.cfg,
            differentiable)
        out = x[:, sep:sep + self.dim]
        return out[0] if squeeze else out

    def sample(self, key, num_samples: int, device=None) -> torch.Tensor:
        """Draws of the separator block (the flow's own device; trailing
        columns beyond ``self.dim`` are the flow's frontal/pad columns)."""
        if self._obs_dim == 0:
            return self._flow_model.conditional_sample(key, num_samples)
        return self._flow_model.conditional_sample(
            key, 0, obs_samples=self._obs_block(num_samples))

    def sample_conditional(self, key, prefix_samples: torch.Tensor
                           ) -> torch.Tensor:
        """Draw the remaining suffix of ``self.vars`` given samples of a
        PREFIX of them (a sibling separator flow already drew the shared,
        root-most variables); the AR flow conditions on
        [true_obs | prefix] directly."""
        prefix_full = self._augment(prefix_samples)
        out = self._flow_model.conditional_sample(
            key, 0, obs_samples=prefix_full)
        suffix_dim = self.dim - (prefix_full.shape[1] - self._obs_dim)
        return out[:, :suffix_dim]

    def __str__(self) -> str:
        return "Factor FlowsPriorFactor " + \
            " ".join(str(v.name) for v in self._vars)


class NFiSAM(FactorGraphSolver):
    """Flow-based incremental solver, one clique at a time."""

    def __init__(self, args: NFiSAMArgs = None, device=None):
        args = args or NFiSAMArgs()
        if args.flow_type not in ("NSF_AR", "NSF_AR_CS"):
            raise NotImplementedError(f"Unknown flow type {args.flow_type}")
        super().__init__(args=args, device=device)
        self._args: NFiSAMArgs = self._args
        self._model_store = None
        if args.checkpoint_dir is not None:
            self._model_store = CliqueModelStore(args.checkpoint_dir,
                                                 self.device)

    # ---------------------------------------------------------- checkpoint
    def _clique_signature(self, clique):
        """(signature, simulation schedule) of a clique in the working
        graph, as the JAX package computes them."""
        subgraph = self._working_graph.clique_subgraph(clique)
        pattern = self._working_bayes_tree.clique_variable_pattern(clique)
        schedule = compile_schedule(subgraph.factors, pattern)
        circ = circular_dim_list(schedule.var_ordering)
        cfg = self._flow_config(len(circ), circ)
        return clique_signature(clique, schedule.var_ordering,
                                subgraph.factors, cfg), schedule

    def try_load_clique_model(self, clique):
        """(model, true observations) from the checkpoint store when the
        clique's signature is there, else None.  A clique holding a
        mode-repaired variable always retrains: its stored flow is the one
        the repair evicted, and its own factors can be unchanged."""
        if self._model_store is None or (self._repair_vars & clique.vars):
            return None
        sig, schedule = self._clique_signature(clique)
        model = self._model_store.load(sig)
        if model is None:
            return None
        return FlowModelAdapter(model, self._next_key), schedule.unused_obs

    def _save_clique_model(self, clique, model: CliqueFlowModel) -> None:
        if self._model_store is not None:
            self._model_store.save(self._clique_signature(clique)[0], model)

    def _record_training_loss(self, clique, iter_loss, n_iters) -> None:
        """Keep the clique's loss curve (on its device) for
        ``training_losses``, count it in the tracer's ``cliques_trained``
        and its iterations in ``adam_iters``; write it to
        ``training_loss_dir`` if that is a directory."""
        clique_name = "".join(sorted(str(v.name) for v in clique.vars))
        self._temp_training_loss[clique_name] = (iter_loss, n_iters)
        tracer.count("cliques_trained")
        tracer.count("adam_iters", int(n_iters))
        loss_dir = self._args.training_loss_dir
        if loss_dir is not None and os.path.isdir(loss_dir):
            np.savetxt(os.path.join(loss_dir, f"{clique_name}.txt"),
                       iter_loss[:int(n_iters)].cpu().numpy())

    # ------------------------------------------------------------- fitting
    def _flow_config(self, aug_dim: int,
                     circular_dim_list: List[bool]) -> NSFConfig:
        circ = () if self._args.flow_type == "NSF_AR" else \
            tuple(bool(c) for c in circular_dim_list)
        return NSFConfig(dim=aug_dim, num_knots=self._args.num_knots,
                         hidden_dim=effective_hidden_dim(self._args,
                                                         aug_dim),
                         num_flows=self._args.flow_number, circular=circ)

    def _dim_bucket(self, aug_dim: int) -> int:
        """Bucketed flow dim for a clique of ``aug_dim`` columns: the next
        multiple of ``pad_dim_multiple`` when that is above 1, else the
        next power of two from ``dim_bucket_floor`` (at least 2) up."""
        mult = int(self._args.pad_dim_multiple or 0)
        if mult > 1:
            return -(-aug_dim // mult) * mult
        b = max(int(self._args.dim_bucket_floor or DIM_BUCKET_FLOOR), 2)
        while b < aug_dim:
            b *= 2
        return b

    def _pad_samples(self, samples: torch.Tensor):
        """Pad trailing dummy N(0,1) columns so the flow dim lands on a
        bucket boundary.  The columns come from numpy's ``default_rng``
        seeded with the next key, as in the JAX package, so they are the
        same numbers there and here."""
        aug_dim = samples.shape[-1]
        pad = self._dim_bucket(aug_dim) - aug_dim
        if pad:
            key = self._next_key()
            rng = np.random.default_rng(int(key[1]))
            cols = rng.normal(size=(samples.shape[0], pad)).astype(
                np.float32)
            samples = torch.cat([samples, torch.as_tensor(
                cols, device=samples.device)], dim=1)
        return samples, pad

    def fit_clique_density_model(self, clique: CliqueNode, samples,
                                 var_ordering: List[Variable],
                                 timer: Optional[List[float]] = None
                                 ) -> FlowModelAdapter:
        """Fit the clique's flow; ``timer`` gets the training seconds."""
        samples = samples.to(torch.float32)
        aug_sep_dim = samples.shape[-1] - clique.frontal_dim
        circ = circular_dim_list(var_ordering)
        samples, pad = self._pad_samples(samples)
        padded_circ = circ + [False] * pad
        cfg = self._flow_config(samples.shape[-1], padded_circ)

        key = self._next_key()
        with self._phase("fit.bucket", timer, dim=cfg.dim,
                         n=samples.shape[0], size=1, lone=True):
            params, iter_loss, n_iters, mean, std = fit_flow_raw(
                key, samples, cfg, self._args.train_config(),
                padded_circ,
                scale_circular=(self._args.flow_type == "NSF_AR"),
                mesh=self._args.data_parallel_mesh)
        self._record_training_loss(clique, iter_loss, n_iters)
        model = CliqueFlowModel(cfg, params, mean, std, circ,
                                aug_sep_dim, pad_dims=pad,
                                content_tag=content_tag(key, cfg,
                                                        samples.shape))
        self._save_clique_model(clique, model)
        return FlowModelAdapter(model, self._next_key,
                                mesh=self._args.sample_mesh)

    # ----------------------------------------------------------- recycling
    def root_clique_density_model_to_leaf(self, old_clique: CliqueNode,
                                          new_clique: CliqueNode
                                          ) -> FlowModelAdapter:
        old = self._clique_density_model[old_clique]
        obs_dim = old.model.dim - old_clique.dim - old.model.pad_dims
        sep_dim = new_clique.separator_dim + obs_dim
        return FlowModelAdapter(old.model.with_separator_dim(sep_dim),
                                self._next_key)

    def clique_density_to_separator_factor(
            self, separator_var_list: List[Variable],
            density_model: FlowModelAdapter,
            true_obs: np.ndarray) -> FlowsPriorFactor:
        obs_dim = int(np.asarray(true_obs).reshape(-1).shape[0])
        sep_dim = sum(v.dim for v in separator_var_list)
        circ = density_model.model.circular_dim_list[
            obs_dim:obs_dim + sep_dim]
        return FlowsPriorFactor(vars=separator_var_list,
                                flow_model=density_model.model,
                                true_obs=np.asarray(true_obs).reshape(-1),
                                circular_dim_list=circ,
                                key_source=self._next_key)
