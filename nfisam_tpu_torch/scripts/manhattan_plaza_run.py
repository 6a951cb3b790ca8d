"""The manhattan_plaza runner: the JAX package's
``scripts/manhattan_plaza_run.py`` in the port.

The reference's ``example/slam/manhattan_world_with_range/manhattan_plaza/
run_nfisam.py`` (dataset seed0/pada0.4_r2_odom0.01_mada3: 136 SE(2) poses,
3 landmarks, 272 factors, 59 ambiguous-DA ranges) through the whole run
harness, ``nfisam_empirical_study`` -> ``run_incrementally``: a run
directory with every step's artifacts (samples, ordering, split timing,
training losses, clique dim timing, hypothesis weights) at K=9, hidden 8,
500 Adam iterations with no plateau stop (``loss_delta_tol=1e-9``), 2000
training samples, lr 0.01, one pose a step, pose_first, 1000 posterior
draws, ``prior_cov_scale=1.0``.  The read-out comes from the run
directory's artifacts (the last step's samples and ordering, the step
timing).  The floor: ``GaussNewtonMAP`` (max-mixture LM, Laplace) from
the best of 512 ancestral draws, and its gate, translation RMSE <= 1.1x
the floor's (exit 1).  The port draws that start from ``torch.Generator``
streams, which the JAX package's key stream does not give, so the run
also prints ``GaussNewtonMAP`` started from the ground truth column
beside it::

    python -m nfisam_tpu_torch.scripts.manhattan_plaza_run
    python -m nfisam_tpu_torch.scripts.manhattan_plaza_run --device cpu \\
        --limit-steps 3

The run takes the JAX script's arguments (none) plus ``--device``
(default ``cuda``: without a card it exits 1 unless given ``--device
cpu``), ``--out`` (the result JSON, by default the JAX script's
``manhattan_plaza_results.json`` in ``tempfile.gettempdir()``) and
``--limit-steps N``: ``run_incrementally`` on the first N steps with the
solver ``nfisam_empirical_study`` builds, both floors over that prefix,
failed gates printed instead of an exit.  The case directory is
``manhattan_plaza`` in ``tempfile.gettempdir()``.  Without matplotlib the
plots are left out with one line saying so.  Every timer ends in a
synchronize on a card.  The result has the JAX script's keys and these of
the port's: ``truth_start_floor_trans_rmse`` and
``truth_start_floor_landmark_rmse`` (the floor from the truth), ``fit_s``
and ``posterior_s`` (the run's ``fitting_timer`` and
``posterior_sampling_timer`` summed), ``outside_solve_s`` (``total_s``
less ``solve_s``: the parse, the run directory and every step's artifact
writes) and ``backend`` ("cuda" or "cpu").
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from .manhattan_scale_run import REPO

DATA = os.path.join(REPO, "data", "manhattan_plaza_factor_graph.fg")
FLOOR_GATE = 1.1
# the JAX script's nfisam_empirical_study arguments (:39-46)
STUDY = dict(knots=[9], iters=[500], training_samples=[2000],
             learning_rates=[0.01], hidden_dims=[8],
             data_file="factor_graph.fg", data_format="fg",
             incremental_step=1, prior_cov_scale=1.0,
             plot_args={"xlim": (-150, 400), "ylim": (-150, 400)},
             posterior_sample_num=1000, elimination_method="pose_first",
             training_set_frac=1.0, loss_delta_tol=1e-9, average_window=50)
# the study's grid axes and the NFiSAMArgs field each sets
GRID = {"knots": "num_knots", "iters": "flow_iterations",
        "training_samples": "local_sample_num",
        "learning_rates": "learning_rate", "hidden_dims": "hidden_dim"}
STUDY_ONLY = ("case_dir", "data_file", "data_format", "incremental_step",
              "prior_cov_scale", "plot_args")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.scripts.manhattan_plaza_run",
        description=__doc__.split("\n")[0])
    ap.add_argument("--limit-steps", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="result JSON (default manhattan_plaza_results.json"
                         " in the temporary directory)")
    return ap.parse_args(argv)


def study_args(**overrides) -> dict:
    """``STUDY`` with ``overrides``: a grid axis by its ``NFiSAMArgs``
    field (``flow_iterations=30`` sets ``iters=[30]``), anything else as
    it is named."""
    study = dict(STUDY)
    for field, value in overrides.items():
        axis = next((a for a, f in GRID.items() if f == field), None)
        study[axis or field] = [value] if axis else value
    return study


def solver_args(study: dict) -> dict:
    """The ``NFiSAMArgs`` fields ``nfisam_empirical_study`` builds from
    ``study`` (its first grid point)."""
    return {**{GRID[a]: study[a][0] for a in GRID},
            **{k: v for k, v in study.items()
               if k not in GRID and k not in STUDY_ONLY}}


def plot_args_or_none(plot_args):
    """``plot_args`` where matplotlib imports, else None, said once."""
    from ..eval.viz import matplotlib_pyplot
    try:
        matplotlib_pyplot()
    except ImportError as e:
        print(f"# plots left out: {e}", flush=True)
        return None
    return plot_args


def run_study(case_dir: str, device, limit_steps: int = 0,
              **overrides) -> tuple:
    """The run: the dataset copied into ``case_dir``, then the whole study
    (``nfisam_empirical_study``) or, with ``limit_steps``,
    ``run_incrementally`` on the stream's first steps with the solver the
    study builds.  Returns (the run directory, the solver or None, the
    seconds it took)."""
    from ..io import graph_file_parser, group_nodes_factors_incrementally
    from ..parallel import ParallelNFiSAM
    from ..solver import NFiSAMArgs
    from ..solver.run import nfisam_empirical_study, run_incrementally

    study = study_args(**overrides)
    study["plot_args"] = plot_args_or_none(study["plot_args"])
    os.makedirs(case_dir, exist_ok=True)
    shutil.copy(DATA, os.path.join(case_dir, study["data_file"]))
    t0 = time.perf_counter()
    if not limit_steps:
        run_dir = nfisam_empirical_study(case_dir=case_dir, device=device,
                                         **study)[0]
        return run_dir, None, time.perf_counter() - t0
    nodes, truth, factors = graph_file_parser(
        os.path.join(case_dir, study["data_file"]), study["data_format"],
        prior_cov_scale=study["prior_cov_scale"])
    batches = group_nodes_factors_incrementally(
        nodes, factors, incremental_step=study["incremental_step"])
    solver = ParallelNFiSAM(NFiSAMArgs(**solver_args(study)), device=device)
    run_dir = run_incrementally(case_dir, solver, batches[:limit_steps],
                                truth, plot_args=study["plot_args"])
    return run_dir, solver, time.perf_counter() - t0


# --------------------------------------------------------------------------
# the read-out
# --------------------------------------------------------------------------
def last_step(run_dir: str) -> int:
    """The last step whose samples the run directory holds (:61-64)."""
    return max(int(f[4:].split("_")[0].split(".")[0])
               for f in os.listdir(run_dir)
               if f.startswith("step") and f[4:].split("_")[0]
               .split(".")[0].isdigit())


def _rms(e) -> float:
    return float(np.sqrt(np.mean(np.array(e) ** 2)))


def artifact_readout(run_dir: str, nodes, truth, last=None) -> tuple:
    """The JAX script's read-out of the run directory (:57-79): the
    translation errors of the last step's (or step ``last``'s) posterior
    means (all, the landmarks') and each step's wall (``step_timing``).
    ``truth`` keyed by ``nodes``."""
    last = last_step(run_dir) if last is None else last
    X = np.loadtxt(f"{run_dir}/step{last}")
    with open(f"{run_dir}/step{last}_ordering") as fh:
        order = fh.read().split()
    name2var = {v.name: v for v in nodes}
    cur, errs, lmk = 0, [], []
    for nm in order:
        v = name2var[nm]
        mean = X[:, cur:cur + v.dim].mean(0)
        cur += v.dim
        if v in truth:
            e = float(np.linalg.norm(mean[:2] - truth[v][:2]))
            errs.append(e)
            if nm.startswith("L"):
                lmk.append(e)
    with open(f"{run_dir}/step_timing") as fh:
        steps = [float(t) for t in fh.read().split()]
    return errs, lmk, steps


def floor_errors(m, x_map, truth) -> tuple:
    """(translation RMSE, landmark RMSE or None) of a ``GaussNewtonMAP``
    point ``x_map`` over ``m.joint.vars`` (:89-101)."""
    cur, errs, lmk = 0, [], []
    for v in m.joint.vars:
        mean = x_map[cur:cur + v.dim]
        cur += v.dim
        if v in truth:
            e = float(np.linalg.norm(mean[:2] - truth[v][:2]))
            errs.append(e)
            if str(v.name).startswith("L"):
                lmk.append(e)
    return _rms(errs), _rms(lmk) if lmk else None


def floors(nodes, factors, truth, device) -> dict:
    """``GaussNewtonMAP`` over the graph, from the best of 512 ancestral
    draws (the JAX script's floor) and from the ground truth column:
    {"draws": (trans, landmark RMSE), "truth": (...)}."""
    from ..solver import GaussNewtonMAP
    out = {}
    m = GaussNewtonMAP(nodes, factors, device=device)
    out["draws"] = floor_errors(m, m.solve()[0], truth)
    x0 = np.concatenate([np.asarray(truth[v], np.float32)[:v.dim]
                         for v in m.joint.vars])
    out["truth"] = floor_errors(m, m.solve(x0=x0)[0], truth)
    return out


def result_record(run_dir, errs, lmk, steps, floor, total: float,
                  backend: str) -> dict:
    """The JAX script's result (:103-115), key for key, with ``floor``
    (``floors``) and the port's keys."""
    floor_rmse, floor_lmk = floor["draws"]
    trans_rmse = _rms(errs)

    def summed(name):
        path = os.path.join(run_dir, name)
        with open(path) as fh:
            return float(sum(float(t) for t in fh.read().split()))
    return {"total_s": round(total, 1),
            "solve_s": round(sum(steps), 1),
            "n_steps": len(steps),
            "median_step_s": round(float(np.median(steps)), 3),
            "trans_rmse": round(trans_rmse, 3),
            "landmark_rmse": round(_rms(lmk), 3) if lmk else None,
            "map_floor_trans_rmse": round(floor_rmse, 3),
            "map_floor_landmark_rmse": round(floor_lmk, 3)
            if floor_lmk is not None else None,
            "floor_gate_1.1x": bool(trans_rmse <= FLOOR_GATE * floor_rmse),
            "run_dir": run_dir,
            "truth_start_floor_trans_rmse": round(floor["truth"][0], 3),
            "truth_start_floor_landmark_rmse": None
            if floor["truth"][1] is None else round(floor["truth"][1], 3),
            "fit_s": round(summed("fitting_timer"), 1),
            "posterior_s": round(summed("posterior_sampling_timer"), 1),
            "outside_solve_s": round(total - sum(steps), 1),
            "backend": backend}


def solve_manhattan_plaza(args, case_dir=None, **overrides) -> tuple:
    """One run at ``args`` (``parse_args``; ``overrides`` of the study's
    solver fields): the run, the read-out of its artifacts, both floors
    over the graph that was solved.  Returns (the result record, the
    unrounded translation RMSE, the unrounded floors, the solver or
    None)."""
    from ..io import graph_file_parser, group_nodes_factors_incrementally
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    case_dir = case_dir or os.path.join(tempfile.gettempdir(),
                                        "manhattan_plaza")
    run_dir, solver, total = run_study(case_dir, device, args.limit_steps,
                                       **overrides)
    nodes, truth, factors = graph_file_parser(
        os.path.join(case_dir, "factor_graph.fg"), "fg")
    errs, lmk, steps = artifact_readout(run_dir, nodes, truth)
    if args.limit_steps:
        batches = group_nodes_factors_incrementally(
            nodes, factors, incremental_step=1)[:args.limit_steps]
        nodes = [n for ns, _ in batches for n in ns]
        factors = [f for _, fs in batches for f in fs]
    floor = floors(nodes, factors, truth, device)
    result = result_record(run_dir, errs, lmk, steps, floor, total,
                           device.type)
    print(f"# floor: from the best of 512 draws {floor['draws'][0]:.3f} m, "
          f"from the truth {floor['truth'][0]:.3f} m", flush=True)
    return result, _rms(errs), floor, solver


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result, trans_rmse, floor, _ = solve_manhattan_plaza(args)
    except RuntimeError as e:
        if "no CUDA device" not in str(e):
            raise
        print(f"manhattan_plaza_run: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    out = args.out or os.path.join(tempfile.gettempdir(),
                                   "manhattan_plaza_results.json")
    with open(out, "w") as fh:
        json.dump(result, fh)
    print(f"# wrote {out}", file=sys.stderr)
    if not result["floor_gate_1.1x"]:
        print(f"# FLOOR GATE FAILED: trans RMSE {trans_rmse:.2f} > 1.1 x MAP"
              f" floor {floor['draws'][0]:.2f}", file=sys.stderr)
        return 0 if args.limit_steps else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
