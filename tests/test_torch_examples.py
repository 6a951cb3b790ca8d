"""The port's examples (``nfisam_tpu_torch/examples``) against the JAX
repo's ``examples/`` on the CPU.

The JAX examples are read as source (``torch_script_ast``), never
imported: each edits ``sys.path`` and runs at import.  Their
``__main__`` blocks run here in a namespace of the JAX package's names,
with stand-ins where a test needs one (a solver that records its steps).

- Graphs: each toy example's graph, step by step, written as ``.fg`` text
  by each package's writer (types, means and covariances at full
  precision, variable order) equals the port module's graph function's; the
  port's case1 batches equal the JAX package's parse.
- Arguments: each module's ``NFiSAMArgs`` are the JAX example's literal
  ones.
- Generation: ``generate_and_run.generate`` writes the JAX example's
  ``factor_graph.fg`` byte for byte.
- ``compute_mmd``: the JAX script's numbers (in float64) to 1e-6 on the
  same files, a port run against a JAX reference and a JAX run against a
  port reference.
- Small solves (eight_pose_circle, five_node_range_incremental,
  generate_and_run) and the NS reference (steps 0-1 at 200 live points):
  the port against the JAX examples' own code at the same reduced sizes,
  in distribution (MMD, means), with the bounds stated at each test.
- Without a card each ``main`` exits 1 unless given ``--device cpu``.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_examples.py
MODE [JAX|port] [seed ...]`` runs a JAX example (or, with ``port``, the
port's module) at its full configuration on the CPU and prints the
figures behind ``chip_smoke.py``'s phase-32 gates:
``eight_pose`` (seeds 0-2: each pose's posterior-mean distance from the
port's ``GaussNewtonMAP`` of the graph, translation and wrapped heading),
``five_node`` (seeds 0-2: each step's pose distances from that step's
MAP, L1's share of samples above the x-axis at step 3; the band of
``chip_smoke.JAX_FIVE_NODE_L1_SIDES`` holds both sides' shares),
``ns_reference`` (keys [s, 7], s = 0-2: each step's joint MMD against
``data/case1_ref`` through the port's ``compute_mmd.mmds``) and
``generate_and_run`` (the graph at seed 1, solver seeds 0-2: the ``.fg``
file's sha256 and the last step's translation RMSE).  ``python
tests/test_torch_examples.py five_node-summary LOG ...`` reads the
``five_node`` lines of both arms from their printed output and prints
each step's spread, the Welch t and L1's sides (ROADMAP C9);
``five_node-parts [JAX|port] SEED ...`` splits step 1's error into the
fit's own (one draw of 20000) and the scatter of 40 draws of 500 on that
fit.
"""
import contextlib
import io
import json
import os
import re
import sys
import time

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import nfisam_tpu.core as jcore  # noqa: E402
import nfisam_tpu.factors as jfactors  # noqa: E402
import nfisam_tpu.io as jio  # noqa: E402
import nfisam_tpu.sim as jsim  # noqa: E402
import nfisam_tpu_torch.core as tcore  # noqa: E402
import nfisam_tpu_torch.factors as tfactors  # noqa: E402
from nfisam_tpu.eval import mmd as jmmd  # noqa: E402
from nfisam_tpu.samplers import GlobalNestedSampler as JNested  # noqa: E402
from nfisam_tpu.solver import NFiSAM as JNFiSAM  # noqa: E402
from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs  # noqa: E402
from nfisam_tpu.solver import run_incrementally as j_run_incrementally  # noqa: E402
from nfisam_tpu_torch.eval import mmd  # noqa: E402
from nfisam_tpu_torch.examples import map_distances, map_estimate  # noqa: E402
from nfisam_tpu_torch.examples.manhattan_world_with_range import \
    generate_and_run as ga  # noqa: E402
from nfisam_tpu_torch.examples.small_range_gaussian_problem import (  # noqa: E402
    FG, case1_graph, compute_mmd, generate_reference_solution, run_nfisam)
from nfisam_tpu_torch.examples.toy_examples import (  # noqa: E402
    eight_pose_circle, five_node_range_incremental, r2_range_incremental,
    r2_relative_eight_nodes)
from nfisam_tpu_torch.io import factor_graph_to_string  # noqa: E402
from torch_script_ast import (call_keywords, example_path,  # noqa: E402
                              main_block, script_functions)

torch.set_num_threads(1)

REF_DIR = os.path.join(REPO, "data", "case1_ref")
# each toy example: its module and its graph as [(new nodes, new factors)]
# a step from the module's graph function
TOYS = {"r2_relative_eight_nodes.py": (
            r2_relative_eight_nodes,
            lambda c, f: [r2_relative_eight_nodes.eight_node_graph(c, f)[:2]]),
        "r2_range_incremental.py": (
            r2_range_incremental, r2_range_incremental.r2_range_graph),
        "eight_pose_circle.py": (
            eight_pose_circle,
            lambda c, f: [eight_pose_circle.eight_pose_graph(c, f)]),
        "five_node_range_incremental.py": (
            five_node_range_incremental,
            five_node_range_incremental.five_node_graph)}
MODULES = [r2_relative_eight_nodes, r2_range_incremental, eight_pose_circle,
           five_node_range_incremental, run_nfisam,
           generate_reference_solution, ga]


def _public(*modules) -> dict:
    return {k: getattr(m, k) for m in modules for k in dir(m)
            if not k.startswith("_")}


def _recording(base, rec: dict):
    """``base`` (a JAX solver class) that records into ``rec`` itself
    ("solver"), each step's graph so far ("steps") and each step's samples
    by name ("samples")."""
    rec.setdefault("steps", [])
    rec.setdefault("samples", [])

    class Recorder(base):
        def __init__(self, args):
            super().__init__(args)
            rec["solver"] = self
            self._rec_nodes, self._rec_factors = [], []

        def add_node(self, n):
            self._rec_nodes.append(n)
            super().add_node(n)

        def add_factor(self, f):
            self._rec_factors.append(f)
            super().add_factor(f)

        def update_physical_and_working_graphs(self, *a, **k):
            rec["steps"].append((list(self._rec_nodes),
                                 list(self._rec_factors)))
            return super().update_physical_and_working_graphs(*a, **k)

        def incremental_inference(self, *a, **k):
            s = super().incremental_inference(*a, **k)
            rec["samples"].append({str(v.name): np.asarray(x)
                                   for v, x in s.items()})
            return s
    return Recorder


def _args(rec: dict, **args_over):
    """A stand-in for ``NFiSAMArgs`` that records the example's keywords
    ("kw") and updates them by ``args_over``."""
    def args(**kw):
        rec["kw"] = kw
        return JNFiSAMArgs(**{**kw, **args_over})
    return args


def _exec(family: str, file: str, ns: dict, argv=()) -> str:
    """Run the JAX example's ``__main__`` block in ``ns`` with ``argv`` as
    its command line; returns what it printed."""
    out, saved = io.StringIO(), sys.argv
    sys.argv = [file, *argv]
    try:
        with contextlib.redirect_stdout(out):
            exec(main_block(example_path(family, file)), ns)
    finally:
        sys.argv = saved
    return out.getvalue()


def run_jax_toy(file: str, solver_cls=JNFiSAM, **args_over) -> dict:
    """The JAX toy example with ``NFiSAMArgs`` updated by ``args_over``:
    {"solver", "kw" (the keywords it passed), "steps" (each step's graph so
    far), "samples" (each step's, by name), "text" (what it printed)}."""
    from nfisam_tpu.eval.metrics import gaussian_displacement_graph_moments
    rec = {}
    ns = {**_public(jcore, jfactors), "np": np,
          "NFiSAM": _recording(solver_cls, rec),
          "NFiSAMArgs": _args(rec, **args_over),
          "gaussian_displacement_graph_moments":
          gaussian_displacement_graph_moments}
    rec["text"] = _exec("toy_examples", file, ns)
    return rec


def run_jax_ns_reference(here: str, key=None, live_points=None,
                         steps=None) -> dict:
    """The JAX example ``generate_reference_solution.py`` writing to
    ``here/ns_reference``, its sampler given ``key`` and ``live_points``
    where set, its batches cut to ``steps``: {"samples" ((samples, column
    names) a step), "text"}."""
    rec = {"samples": []}

    class Sampler(JNested):
        def sample(self, **kw):
            if key is not None:
                kw["key"] = np.array(key, np.uint32)
            if live_points is not None:
                kw["live_points"] = live_points
            s = super().sample(**kw)
            rec["samples"].append((s, [str(v.name) for v in self._nodes]))
            return s

    def group(*a, **k):
        return jio.group_nodes_factors_incrementally(*a, **k)[:steps]

    ns = {"np": np, "os": os, "HERE": here, "FG": FG,
          "graph_file_parser": jio.graph_file_parser,
          "group_nodes_factors_incrementally": group,
          "GlobalNestedSampler": Sampler}
    rec["text"] = _exec("small_range_gaussian_problem",
                        "generate_reference_solution.py", ns)
    return rec


def run_jax_generate_and_run(here: str, graph_seed: int = 1, steps=None,
                             **args_over) -> dict:
    """The JAX example ``generate_and_run.py --seed graph_seed`` writing under
    ``here`` (no plots), its batches cut to ``steps``, ``NFiSAMArgs``
    updated by ``args_over`` (a solver ``seed`` among them): {"solver",
    "samples", "truth" (by name), "fg", "text"}."""
    rec = {}

    def group(*a, **k):
        return jio.group_nodes_factors_incrementally(*a, **k)[:steps]

    def run_incrementally(case_dir, solver, batches, truth, plot_args=None):
        rec["truth"] = {str(v.name): np.asarray(t) for v, t in truth.items()}
        rec["fg"] = os.path.join(case_dir, "factor_graph.fg")
        return j_run_incrementally(case_dir, solver, batches, truth,
                                   plot_args=None)

    import argparse
    ns = {"np": np, "os": os, "argparse": argparse, "HERE": here,
          "generate": _jax_generate(),
          "write_factor_graph_to_file": jio.write_factor_graph_to_file,
          "group_nodes_factors_incrementally": group,
          "NFiSAM": _recording(JNFiSAM, rec),
          "NFiSAMArgs": _args(rec, **args_over),
          "run_incrementally": run_incrementally}
    rec["text"] = _exec("manhattan_world_with_range", "generate_and_run.py",
                        ns, ["--seed", str(graph_seed)])
    return rec


def _jax_generate():
    ns = {"np": np, **_public(jsim)}
    return script_functions(example_path("manhattan_world_with_range",
                                         "generate_and_run.py"),
                            ["generate"], ns)["generate"]


class _GraphOnly:
    """A stand-in for the JAX solver that records the graph and solves
    nothing."""

    def __init__(self, args):
        pass

    def add_node(self, n):
        pass

    def add_factor(self, f):
        pass

    def update_physical_and_working_graphs(self, *a, **k):
        pass

    def incremental_inference(self, *a, **k):
        return _NoSamples()


class _NoSamples(dict):
    """No variable's samples, and two zero rows of any asked for."""

    def __missing__(self, v):
        return np.zeros((2, v.dim))


# --------------------------------------------------------------------------
# graphs, arguments, generation
# --------------------------------------------------------------------------
@pytest.mark.parametrize("file", sorted(TOYS))
def test_toy_graph_is_the_jax_examples(file):
    """Each step's graph so far as ``.fg`` text (every type, mean and
    covariance at full precision, in order) equals the port module's."""
    steps = run_jax_toy(file, solver_cls=_GraphOnly)["steps"]
    ours = TOYS[file][1](tcore, tfactors)
    assert len(steps) == len(ours)
    nodes, fs = [], []
    for (j_nodes, j_fs), (ns, new_fs) in zip(steps, ours):
        nodes += ns
        fs += new_fs
        assert factor_graph_to_string(nodes, fs) == \
            jio.fg_io.factor_graph_to_string(j_nodes, j_fs)


def test_case1_batches_are_the_jax_packages():
    _, _, _, j_batches = case1_graph(jio.graph_file_parser,
                                     jio.group_nodes_factors_incrementally)
    _, _, _, batches = case1_graph()
    assert len(batches) == len(j_batches) == 6
    for (ns, fs), (j_ns, j_fs) in zip(batches, j_batches):
        assert factor_graph_to_string(ns, fs) == \
            jio.fg_io.factor_graph_to_string(j_ns, j_fs)


ARGS = {("toy_examples", "r2_relative_eight_nodes.py"):
        r2_relative_eight_nodes.EIGHT_NODE_ARGS,
        ("toy_examples", "r2_range_incremental.py"):
        r2_range_incremental.R2_RANGE_ARGS,
        ("toy_examples", "eight_pose_circle.py"):
        eight_pose_circle.EIGHT_POSE_ARGS,
        ("toy_examples", "five_node_range_incremental.py"):
        five_node_range_incremental.FIVE_NODE_ARGS,
        ("small_range_gaussian_problem", "run_nfisam.py"):
        run_nfisam.RUN_ARGS,
        ("manhattan_world_with_range", "generate_and_run.py"):
        {**ga.GENERATE_RUN_ARGS, "seed": "args.seed"}}


@pytest.mark.parametrize("where", sorted(ARGS), ids=lambda w: w[1])
def test_solver_args_are_the_jax_examples(where):
    (kw,) = call_keywords(example_path(*where), "NFiSAMArgs")
    assert kw == ARGS[where]


def test_reference_solution_settings_are_the_jax_examples():
    (kw,) = call_keywords(example_path("small_range_gaussian_problem",
                                       "generate_reference_solution.py"),
                          "sample")
    assert kw == {"live_points": generate_reference_solution.LIVE_POINTS,
                  "res_summary": "summary"}
    (kw,) = call_keywords(example_path("small_range_gaussian_problem",
                                       "generate_reference_solution.py"),
                          "group_nodes_factors_incrementally")
    assert kw == {"incremental_step": 1}


@pytest.mark.parametrize("kw", [{"seed": 1},
                                {"seed": 3, "ada_prob": 0.2,
                                 "outlier_prob": 0.1}],
                         ids=["seed1", "seed3_ada_outlier"])
def test_generate_writes_the_jax_examples_fg(kw, tmp_path):
    rbt, lmk, fs, truth = _jax_generate()(**kw)
    jio.write_factor_graph_to_file(rbt + lmk, fs, truth,
                                   str(tmp_path / "jax.fg"))
    from nfisam_tpu_torch.io import write_factor_graph_to_file
    rbt, lmk, fs, truth = ga.generate(**kw)
    write_factor_graph_to_file(rbt + lmk, fs, truth,
                               str(tmp_path / "port.fg"))
    assert (tmp_path / "port.fg").read_bytes() == \
        (tmp_path / "jax.fg").read_bytes()


# --------------------------------------------------------------------------
# small solves and the NS reference against the JAX examples
# --------------------------------------------------------------------------
# the reduced sizes of the small solves (the JAX examples' settings else)
SMALL = dict(flow_iterations=150, local_sample_num=400,
             posterior_sample_num=400)
GAR_SMALL = dict(flow_iterations=100, local_sample_num=300,
                 posterior_sample_num=300)
GAR_STEPS = 2
# each compared group's (largest translation MMD of a variable, largest
# posterior-mean distance in m) between the JAX example at seeds s and
# s + 10, worst over s = 0-4 (``JAX_PLATFORMS=cpu python
# tests/test_torch_examples.py small-spread [example ...]``); the port
# at seed 0 must read within SMALL_FACTOR x that, and at least
# SMALL_FLOOR, where the JAX pairs read ~0 (X0 at step 0, held by its
# prior alone)
SMALL_JAX_SPREAD = {
    "eight_pose_circle": [(0.2825886263432465, 0.76239413022995)],
    "five_node_range_incremental": [
        (0.0, 0.006508167614665581),
        (0.03122628998148263, 0.03427059054374659),
        (0.07977332917169053, 0.0791281867027287),
        (0.2682396246273735, 0.3455220198631288),
        (0.6861545665634915, 0.7118819332122808)],
    "generate_and_run": [(0.37974283660197095, 4.916680812835693),
                         (0.15911045066898788, 15.983305931091309)]}
SMALL_FACTOR = 1.5
SMALL_FLOOR = 0.03


def compare(a: dict, b: dict, names) -> tuple:
    """(the largest MMD of a variable's translation columns, the largest
    distance between its posterior means in m) over ``names`` of two
    sample sets by name."""
    return (max(mmd(a[n][:, :2], b[n][:, :2]) for n in names),
            max(float(np.linalg.norm(a[n][:, :2].mean(0) -
                                     b[n][:, :2].mean(0))) for n in names))


def small_solve(example: str, package: str, seed: int) -> list:
    """An example at its reduced size by one package: each step's samples
    by name (generate_and_run: its last step's)."""
    import tempfile
    if example == "generate_and_run":
        with tempfile.TemporaryDirectory() as here:
            if package == "JAX":
                return run_jax_generate_and_run(
                    here, steps=GAR_STEPS, seed=seed,
                    **GAR_SMALL)["samples"][-1:]
            return [ga.run("cpu", here, steps=GAR_STEPS, verbose=False,
                           solver_seed=seed, **GAR_SMALL)["samples"]]
    if package == "JAX":
        return run_jax_toy(f"{example}.py", seed=seed, **SMALL)["samples"]
    r = TOYS[f"{example}.py"][0].run("cpu", seed, **SMALL)
    return r.get("per_step") or [r["samples"]]


def mirrored(samples: dict) -> dict:
    """Samples beside their mirror images in the x-axis (y and heading
    negated).  The five-node graph is symmetric under the mirror, so how a
    run splits its samples between L1's two modes, and the poses' y that
    follows it, is noise of the run (the JAX example's share above the
    axis reads 0.054-0.852 over seeds 0-9)."""
    return {n: np.vstack([s, s * np.array([1.0, -1.0, -1.0])[:s.shape[1]]])
            for n, s in samples.items()}


def small_comparisons(example: str, a: list, b: list) -> list:
    """``compare`` of each group of two small solves: the last step's
    poses (eight_pose_circle); each step's poses, then L1 at the last step,
    with their mirror images (five_node); the last step's poses, then its
    landmarks (generate_and_run)."""
    def group(x, kind):
        return sorted(n for n in x if n[0] in kind)
    if example == "eight_pose_circle":
        return [compare(a[-1], b[-1], sorted(b[-1]))]
    if example == "generate_and_run":
        return [compare(a[-1], b[-1], group(b[-1], "X")),
                compare(a[-1], b[-1], group(b[-1], "L"))]
    a, b = [mirrored(x) for x in a], [mirrored(y) for y in b]
    return [compare(x, y, group(y, "X")) for x, y in zip(a, b)] + \
        [compare(a[-1], b[-1], ["L1"])]


@pytest.fixture(autouse=True)
def _no_prewarm(monkeypatch):
    monkeypatch.setenv("NFISAM_PREWARM", "0")


@pytest.mark.parametrize("example", sorted(SMALL_JAX_SPREAD))
def test_small_solve_matches_the_jax_example(example):
    """The port and the JAX example at seed 0 and the reduced size: each
    compared group's largest translation MMD and posterior-mean distance
    within max(SMALL_FACTOR x the JAX example's own spread, SMALL_FLOOR)."""
    port = small_solve(example, "port", 0)
    jax_ = small_solve(example, "JAX", 0)
    assert len(port) == len(jax_)
    got = small_comparisons(example, port, jax_)
    bounds = [[max(SMALL_FACTOR * x, SMALL_FLOOR) for x in pair]
              for pair in SMALL_JAX_SPREAD[example]]
    assert len(got) == len(bounds)
    for (x, d), (bound_mmd, bound_m) in zip(got, bounds):
        assert x <= bound_mmd and d <= bound_m, (got, bounds)


# the NS reference at its reduced size: steps 0-1 at NS_LIVE live points
NS_LIVE = 200
NS_STEPS = 2


@pytest.fixture(scope="module")
def ns_runs(tmp_path_factory):
    """The NS reference at steps 0-1, NS_LIVE live points: the port's
    module (its default key) into ``port/ns_reference``, the JAX example
    into ``jax/ns_reference`` (its default key) and at keys [1, 7] and
    [2, 7]."""
    root = tmp_path_factory.mktemp("ns")
    port = generate_reference_solution.run("cpu", str(root / "port"),
                                           NS_STEPS, NS_LIVE)
    jax_runs = [run_jax_ns_reference(str(root / "jax"), None, NS_LIVE,
                                     NS_STEPS)]
    jax_runs += [run_jax_ns_reference(str(root / f"jax{s}"), [s, 7],
                                      NS_LIVE, NS_STEPS) for s in (1, 2)]
    return root, port, jax_runs


def test_ns_reference_within_the_jax_samplers_band(ns_runs):
    """Each step's joint MMD against ``data/case1_ref`` of the port's NS
    reference within max(2x the JAX example's worst over its keys [s, 7],
    s = 0-2, 0.01: the estimator's floor, where step 0's tree is drawn
    directly); the files are the JAX example's format, the printed lines
    its lines."""
    root, port, jax_runs = ns_runs
    name2var = compute_mmd.name_to_var()
    ours = _step_mmds(port["samples"], name2var)
    worst = np.max([_step_mmds(r["samples"], name2var) for r in jax_runs],
                   axis=0)
    assert np.all(np.asarray(ours) <= np.maximum(2 * worst, 0.01)), \
        (ours, worst)
    for step in range(NS_STEPS):
        for tag in ("port", "jax"):
            d = root / tag / "ns_reference"
            assert np.loadtxt(d / f"step{step}.sample").shape[1] == sum(
                compute_mmd.name_to_var()[n].dim
                for n in (d / f"step{step}_ordering").read_text().split())
    j_lines = jax_runs[0]["text"].splitlines()
    shape = re.compile(r"step (\d+): \d+ samples, \{(.*)\}")
    for ln, j_ln in zip(port["lines"], j_lines, strict=True):
        (step, summary), (j_step, j_summary) = (
            shape.fullmatch(x).groups() for x in (ln, j_ln))
        assert step == j_step and re.findall(r"'(\w+)'", summary) == \
            re.findall(r"'(\w+)'", j_summary)


def _jax_compute_mmd(run_prefix: str, ref_prefix: str) -> tuple:
    """The JAX script's ``main`` on the files under ``jax.enable_x64``:
    (every MMD it computed, unrounded; what it printed).  In float32 its
    MMD rounds: at an MMD of 0.005 the square root turns the kernel sums'
    float32 error into ~1e-4, where the port's float64 figure is exact to
    1e-6."""
    path = example_path("small_range_gaussian_problem", "compute_mmd.py")
    seen = []

    def recording_mmd(a, b):
        seen.append(jmmd(a, b))
        return seen[-1]

    ns = script_functions(path, ["translation_columns", "main"], {
        "np": np, "FG": FG, "graph_file_parser": jio.graph_file_parser,
        "mmd": recording_mmd})
    out = io.StringIO()
    with contextlib.redirect_stdout(out), jax.enable_x64(True):
        ns["main"](run_prefix, ref_prefix)
    return seen, out.getvalue()


def test_compute_mmd_gives_the_jax_scripts_numbers(ns_runs, tmp_path):
    """A port run against the JAX example's reference and a JAX run
    against the port's: the port's ``compute_mmd`` gives the JAX script's
    numbers to 1e-6 and prints its lines (the joint MMD to 1e-6)."""
    root, _, _ = ns_runs
    small = dict(flow_iterations=30, local_sample_num=200,
                 posterior_sample_num=300)
    port_run = run_nfisam.run("cpu", str(tmp_path / "port"), NS_STEPS,
                              verbose=False, **small)["run_dir"]
    rec = {}

    def group(*a, **k):
        return jio.group_nodes_factors_incrementally(*a, **k)[:NS_STEPS]

    ns = {"HERE": str(tmp_path / "jax"), "FG": FG,
          "graph_file_parser": jio.graph_file_parser,
          "group_nodes_factors_incrementally": group,
          "NFiSAM": JNFiSAM, "NFiSAMArgs": _args(rec, **small),
          "run_incrementally":
          lambda d, s, b, t, plot_args=None: j_run_incrementally(d, s, b, t)}
    os.makedirs(ns["HERE"])
    jax_run = _exec("small_range_gaussian_problem", "run_nfisam.py",
                    ns).split("artifacts: ")[-1].strip()
    for run_dir, ref in ((port_run, root / "jax" / "ns_reference"),
                         (jax_run, root / "port" / "ns_reference")):
        for step in range(NS_STEPS):
            args = [os.path.join(run_dir, f"step{step}"),
                    str(ref / f"step{step}")]
            seen, text = _jax_compute_mmd(*args)
            joint, marginals = compute_mmd.compute(*args)
            np.testing.assert_allclose([joint, *marginals.values()], seen,
                                       rtol=0, atol=1e-6)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert compute_mmd.main(args) == 0
            ours, theirs = out.getvalue().splitlines(), text.splitlines()
            assert ours[1:] == theirs[1:]
            assert abs(float(ours[0].split()[-1]) -
                       float(theirs[0].split()[-1])) <= 1e-6


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__.split(
    ".")[-1])
def test_main_without_a_card_exits_1(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert module.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_main_runs_on_the_cpu_when_asked(monkeypatch, capsys):
    """``--device cpu`` runs the example (here at a tiny size) and prints
    its lines: each step's variables by name, mean and std."""
    monkeypatch.setattr(r2_range_incremental, "R2_RANGE_ARGS", {
        **r2_range_incremental.R2_RANGE_ARGS, "flow_iterations": 20,
        "local_sample_num": 100, "posterior_sample_num": 100})
    assert r2_range_incremental.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln for ln in lines if ln.startswith("step")] == \
        [f"step {i}:" for i in range(4)]
    assert lines[-5:][0].startswith("  L1: mean [") and \
        lines[-1].startswith("  X3: mean [")


def test_phase32_child_readings_and_gates_on_cpu(monkeypatch):
    """``chip_smoke``'s phase-32 child on the CPU at a tiny size: its
    readings survive JSON; ``examples_report`` fails on no launch of the
    specialised kernel and on each gate past its bound, and passes with
    the bounds set just above the readings."""
    import chip_smoke as cs

    r = json.loads(json.dumps(cs.examples_readings(
        "cpu", ns_steps=2, ns_live=100, flow_iterations=20,
        local_sample_num=100, posterior_sample_num=100)))
    ex = r["examples"]
    assert list(ex) == ["eight_pose_circle", "five_node_range_incremental",
                        "run_nfisam", "generate_reference_solution",
                        "generate_and_run"]
    assert len(ex["run_nfisam"]["mmd"]) == 6
    assert len(ex["generate_reference_solution"]["mmd"]) == 2
    assert len(ex["five_node_range_incremental"]["pose_err"]) == 4
    with pytest.raises(SystemExit, match="never launched"):
        cs.examples_report(r)
    for e in ex.values():
        e["launches"]["specialized"] = 1
    e = ex["eight_pose_circle"]
    monkeypatch.setattr(cs, "JAX_EIGHT_POSE_WORST", (
        max(e["trans_err"].values()) / 2 + 1e-9,
        max(e["heading_err"].values()) / 2 + 1e-9))
    e = ex["five_node_range_incremental"]
    monkeypatch.setattr(cs, "JAX_FIVE_NODE_WORST", tuple(
        max(x.values()) / 2 + 1e-9 for x in e["pose_err"]))
    monkeypatch.setattr(cs, "JAX_FIVE_NODE_L1_SIDES", (
        min(e["l1_above"], 1 - e["l1_above"]) + cs.FIVE_NODE_BAND_MARGIN
        - 1e-9,
        max(e["l1_above"], 1 - e["l1_above"]) - cs.FIVE_NODE_BAND_MARGIN
        + 1e-9))
    ex["run_nfisam"]["run1_mmd"] = [1.0] * 6
    monkeypatch.setattr(cs, "JAX_NS_REFERENCE_MMD", tuple(
        x / 2 + 1e-9 for x in ex["generate_reference_solution"]["mmd"]))
    e = ex["generate_and_run"]
    monkeypatch.setattr(cs, "JAX_GENERATE_FG_SHA256", e["fg_sha256"])
    monkeypatch.setattr(cs, "JAX_GENERATE_RUN_WORST",
                        e["trans_rmse"] / 1.25 + 1e-9)
    cs.examples_report(r)
    for bad, match in (
            (("eight_pose_circle", "trans_err", "x3", 9.0), "off the MAP"),
            (("five_node_range_incremental", "l1_above", None, 1.0),
             "L1's modes"),
            (("run_nfisam", "run1_mmd", None, [0.0] * 6), "MMD gate"),
            (("generate_and_run", "fg_sha256", None, "0"), "not the JAX"),
            (("generate_and_run", "trans_rmse", None, 1e9), "RMSE gate")):
        label, key, sub, value = bad
        bad_r = json.loads(json.dumps(r))
        if sub is None:
            bad_r["examples"][label][key] = value
        else:
            bad_r["examples"][label][key][sub] = value
        with pytest.raises(SystemExit, match=match):
            cs.examples_report(bad_r)


# --------------------------------------------------------------------------
# the JAX examples at full size: the figures behind phase 32's gates
# --------------------------------------------------------------------------
def _step_mmds(samples_by_step, name2var) -> list:
    """Each NS step's joint MMD against ``data/case1_ref``'s posterior of
    that step (dynesty at steps 0-3, nested sampling at 4-5) through
    ``compute_mmd.mmds``."""
    out = []
    for step, (s, order) in enumerate(samples_by_step):
        src = "dyn" if step <= 3 else "ns"
        prefix = os.path.join(REF_DIR, f"{src}_step{step}")
        out.append(compute_mmd.mmds(
            s, order, np.loadtxt(prefix + ".sample"),
            compute_mmd.read_ordering(prefix + "_ordering"), name2var)[0])
    return out


def reference(mode: str, arm: str, seeds) -> None:
    """``mode``'s figures at the example's full size on the CPU for each of
    ``seeds``, by the JAX example's own code (``arm`` "JAX") or by the
    port's module (``arm`` "port"; ``ns_reference`` runs the sampler's
    default key alone there)."""
    import tempfile

    from nfisam_tpu_torch.scripts.manhattan_scale_run import point_errors

    for seed in seeds:
        t0 = time.perf_counter()
        if mode == "eight_pose":
            xs, fs = eight_pose_circle.eight_pose_graph(tcore, tfactors)
            if arm == "JAX":
                samples = run_jax_toy("eight_pose_circle.py",
                                      seed=seed)["samples"][-1]
                trans, heading = map_distances(
                    samples, map_estimate(xs, fs, "cpu"),
                    [str(v.name) for v in xs])
            else:
                p = eight_pose_circle.run("cpu", seed)
                trans, heading = p["trans_err"], p["heading_err"]
            r = {"trans": max(trans.values()),
                 "heading": max(heading.values()), "per_pose": trans}
        elif mode == "five_node":
            steps = five_node_range_incremental.five_node_graph(tcore,
                                                                tfactors)
            if arm == "JAX":
                per_step = run_jax_toy("five_node_range_incremental.py",
                                       seed=seed)["samples"]
                nodes, fs, errs = [], [], []
                for (ns, new_fs), samples in zip(steps, per_step):
                    nodes += ns
                    fs += new_fs
                    errs.append(map_distances(samples, map_estimate(
                        nodes, fs, "cpu"), [str(v.name) for v in nodes
                                            if str(v.name)[0] == "X"])[0])
                above = float(np.mean(per_step[-1]["L1"][:, 1] > 0))
            else:
                p = five_node_range_incremental.run("cpu", seed)
                errs, above = p["pose_err"], p["l1_above"]
            r = {"pose_worst_by_step": [max(e.values()) for e in errs],
                 "l1_above": above, "pose_err": errs}
        elif mode == "ns_reference":
            with tempfile.TemporaryDirectory() as here:
                samples = run_jax_ns_reference(here, key=[seed, 7])[
                    "samples"] if arm == "JAX" else \
                    generate_reference_solution.run("cpu", here)["samples"]
            r = {"mmd_by_step": _step_mmds(samples,
                                           compute_mmd.name_to_var())}
        else:
            with tempfile.TemporaryDirectory() as here:
                if arm == "JAX":
                    rec = run_jax_generate_and_run(here, 1, seed=seed)
                    r = {"fg_sha256": ga.sha256(rec["fg"])}
                    r["trans_rmse"] = point_errors(
                        {n: x[:, :2].mean(0)
                         for n, x in rec["samples"][-1].items()},
                        rec["truth"])[0]
                else:
                    p = ga.run("cpu", here, 1, verbose=False,
                               solver_seed=seed)
                    r = {"fg_sha256": p["fg_sha256"],
                         "trans_rmse": p["trans_rmse"]}
        r["s"] = time.perf_counter() - t0
        print(f"{arm} {mode} seed {seed}: {json.dumps(r)}", flush=True)


def small_spread(examples, seeds) -> None:
    """The small solves' spread: the JAX example at seeds s and s + 10 and
    the port at s against the JAX example at s."""
    for example in examples:
        for s in seeds:
            j = small_solve(example, "JAX", s)
            jj = small_solve(example, "JAX", s + 10)
            p = small_solve(example, "port", s)
            print(f"{example} seed {s}: JAX-JAX "
                  f"{small_comparisons(example, j, jj)}; port-JAX "
                  f"{small_comparisons(example, p, j)}", flush=True)


def five_node_parts(arm: str, seeds, repeats: int = 40,
                    many: int = 20000) -> None:
    """The parts of the five-node example's step-1 error, by package
    (``arm``) and seed: steps 0-1 solved at the example's settings, then
    ``repeats`` posterior draws of its 500 on that fit (the spread of
    X1's mean over them, beside the spread independent draws would give)
    and one draw of ``many`` (each pose's distance from the MAP: the fit's
    own error, sampling noise aside)."""
    import dataclasses
    os.environ["NFISAM_PREWARM"] = "0"
    args = dict(five_node_range_incremental.FIVE_NODE_ARGS)
    t_steps = five_node_range_incremental.five_node_graph(tcore,
                                                          tfactors)[:2]
    nodes = [n for ns, _ in t_steps for n in ns]
    est = map_estimate(nodes, [f for _, fs in t_steps for f in fs], "cpu")
    poses = [str(v.name) for v in nodes if str(v.name)[0] == "X"]

    def draw(solver):
        out = solver.sample_posterior()
        if hasattr(out, "materialize"):
            out = out.materialize()
        return {str(v.name): np.asarray(x.cpu() if torch.is_tensor(x)
                                        else x) for v, x in out.items()}
    for seed in seeds:
        if arm == "JAX":
            solver = JNFiSAM(JNFiSAMArgs(**args, seed=seed))
            steps = five_node_range_incremental.five_node_graph(
                jcore, jfactors)[:2]
        else:
            from nfisam_tpu_torch.solver import NFiSAM, NFiSAMArgs
            solver = NFiSAM(NFiSAMArgs(**args, seed=seed), device="cpu")
            steps = t_steps
        for ns, fs in steps:
            for n in ns:
                solver.add_node(n)
            for f in fs:
                solver.add_factor(f)
            solver.update_physical_and_working_graphs()
            solver.fit_tree_density_models()
            solver.sample_posterior()
        means, std = [], None
        for _ in range(repeats):
            x1 = draw(solver)["X1"][:, :2]
            means.append(x1.mean(0))
            std = x1.std(0) / np.sqrt(x1.shape[0])
        solver._args = dataclasses.replace(solver._args,
                                           posterior_sample_num=many)
        fit = map_distances(draw(solver), est, poses)[0]
        print(f"{arm} five_node parts seed {seed}: " + json.dumps({
            "x1_mean_spread": np.std(np.asarray(means, np.float64),
                                     axis=0).round(5).tolist(),
            "iid_spread": std.astype(np.float64).round(5).tolist(),
            "fit_err": {k: round(v, 5) for k, v in fit.items()}}),
            flush=True)


def five_node_summary(paths) -> None:
    """The per-seed lines ``reference("five_node", ...)`` printed into the
    files ``paths``, side by side: each step's worst pose distance by
    seed, each side's mean and standard deviation, the Welch t (port -
    JAX), the port seeds above the JAX maximum, and L1's share above the
    axis by seed; with ``five_node_parts``' lines, each side's step-1 fit
    error and the scatter of its draws."""
    rows, parts = {"JAX": {}, "port": {}}, {"JAX": {}, "port": {}}
    pat = re.compile(r"^(JAX|port) five_node (parts )?seed (\d+): (\{.*\})$")
    for path in paths:
        for line in open(path):
            m = pat.match(line.strip())
            if m:
                (parts if m.group(2) else rows)[m.group(1)][
                    int(m.group(3))] = json.loads(m.group(4))
    for arm, r in rows.items():
        print(f"{arm} seeds {sorted(r)}")
    n_steps = len(next(iter(rows["JAX"].values()))["pose_worst_by_step"])
    for step in range(n_steps):
        x = {arm: np.array([r[s]["pose_worst_by_step"][step]
                            for s in sorted(r)]) for arm, r in rows.items()}
        j, p = x["JAX"], x["port"]
        t = (p.mean() - j.mean()) / np.sqrt(j.var(ddof=1) / j.size +
                                            p.var(ddof=1) / p.size)
        print(f"step {step}: JAX {j.mean():.4f} +- {j.std(ddof=1):.4f} "
              f"(max {j.max():.4f}), port {p.mean():.4f} +- "
              f"{p.std(ddof=1):.4f} (max {p.max():.4f}); Welch t {t:.2f}; "
              f"port seeds above the JAX max: {int((p > j.max()).sum())}")
        for arm in ("JAX", "port"):
            print(f"  {arm}: " + " ".join(f"{v:.4f}" for v in x[arm]))
    for arm, r in rows.items():
        print(f"L1 above the axis, {arm}: " + " ".join(
            f"{r[s]['l1_above']:.3f}" for s in sorted(r)))
    for arm, r in parts.items():
        if not r:
            continue
        fit = np.array([r[s]["fit_err"]["X1"] for s in sorted(r)])
        ratio = np.array([np.divide(r[s]["x1_mean_spread"],
                                    r[s]["iid_spread"]) for s in sorted(r)])
        print(f"{arm} parts, seeds {sorted(r)}: X1's fit error "
              f"{fit.mean():.4f} +- {fit.std(ddof=1):.4f} m; the spread of "
              f"X1's 500-draw means over that of independent draws "
              f"(x, y): mean {ratio.mean(0).round(3).tolist()}, range "
              f"{ratio.min(0).round(2).tolist()} - "
              f"{ratio.max(0).round(2).tolist()}")


if __name__ == "__main__":
    if sys.argv[1] == "five_node-summary":
        five_node_summary(sys.argv[2:])
        sys.exit(0)
    if sys.argv[1] == "five_node-parts":
        five_node_parts("port" if "port" in sys.argv[2:] else "JAX",
                        [int(x) for x in sys.argv[2:] if x.isdigit()])
        sys.exit(0)
    arm = "port" if "port" in sys.argv[2:] else "JAX"
    seeds = [int(s) for s in sys.argv[2:] if s.isdigit()]
    if sys.argv[1] == "small-spread":
        small_spread([e for e in sys.argv[2:] if e in SMALL_JAX_SPREAD]
                     or sorted(SMALL_JAX_SPREAD), seeds or range(5))
    else:
        reference(sys.argv[1], arm, seeds or [0, 1, 2])
