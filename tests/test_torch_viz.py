"""The port's plots (``eval/viz.py``) against the JAX package's, on the
scene of the JAX package's ``tests/test_viz.py``.

Every public function draws the same figure as its JAX counterpart: the
artists (scatter offsets, line data, patch outlines, texts, contour
levels and paths) equal within 1e-12, and the file is written.  The
port's functions also take tensors.  ``kde_contour``'s 68% contour of
N(0, I) lies near r = 1.51.  ``solve --plot`` writes ``step{i}.png``.
With matplotlib hidden (``sys.modules``), every plotting function raises
an ``ImportError`` naming it, and a data-association run writes every
artifact but ``hypoweights.png``."""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import matplotlib  # noqa: E402

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import chip_smoke  # noqa: E402
import nfisam_tpu.core.variables as jv  # noqa: E402
import nfisam_tpu.eval.viz as jviz  # noqa: E402
import nfisam_tpu.factors.factors as jf  # noqa: E402
import nfisam_tpu.factors.mixtures as jm  # noqa: E402
import nfisam_tpu_torch.core.variables as tv  # noqa: E402
import nfisam_tpu_torch.eval.viz as tviz  # noqa: E402
import nfisam_tpu_torch.factors.factors as tf  # noqa: E402
import nfisam_tpu_torch.factors.mixtures as tm  # noqa: E402
from nfisam_tpu_torch import cli  # noqa: E402

TOL = 1e-12
FIGURE_MAKERS = ["confidence_ellipse", "plot_2d_samples",
                 "plot_marginal_kde_grid", "plot_hypothesis_weights",
                 "plot_2d_mean_trajectory", "plot_2d_clutter_trajectories"]
STEP_WEIGHTS = {1: {"X1->L1|L2": np.array([0.5, 0.5])},
                2: {"X1->L1|L2": np.array([0.7, 0.3]),
                    "X2->L1|L2": np.array([0.4, 0.6])},
                3: {"X1->L1|L2": np.array([0.9, 0.1]),
                    "X2->L1|L2": np.array([0.2, 0.8])}}


def scene(v, f, m):
    """``tests/test_viz.py``'s scene in one package's types: (samples,
    truth, factors)."""
    rng = np.random.default_rng(0)
    x0, x1 = v.SE2Variable("X0"), v.SE2Variable("X1")
    l1 = v.R2Variable("L1", variable_type=v.VariableType.Landmark)
    l2 = v.R2Variable("L2", variable_type=v.VariableType.Landmark)
    samples = {x0: rng.normal([0, 0, 0], 0.3, (400, 3)),
               x1: rng.normal([1, 0, 0], 0.3, (400, 3)),
               l1: rng.normal([2, 1], 0.4, (400, 2)),
               l2: rng.normal([2, -1], 0.4, (400, 2))}
    truth = {x0: np.array([0.0, 0, 0]), x1: np.array([1.0, 0, 0]),
             l1: np.array([2.0, 1]), l2: np.array([2.0, -1])}
    odom = f.SE2RelativeGaussianLikelihoodFactor(
        x0, x1, np.array([1.0, 0, 0]), covariance=np.eye(3) * 0.01)
    rng_f = f.SE2R2RangeGaussianLikelihoodFactor(x1, l1, 1.4, 0.1)
    ada = m.AmbiguousDataAssociationFactor(
        observer_var=x1, observed_vars=[l1, l2], weights=[0.5, 0.5],
        binary_factor_class=f.SE2R2RangeGaussianLikelihoodFactor,
        observation=np.array([1.4]), sigma=0.1)
    return samples, truth, [odom, rng_f, ada]


@pytest.fixture
def scenes():
    return scene(jv, jf, jm), scene(tv, tf, tm)


def artists(fig) -> list:
    """Every axes' drawn content as (kind, numbers or text)."""
    out = []
    fig.canvas.draw()
    for ax in fig.axes:
        out.append(("title", ax.get_title(), ax.get_xlabel(),
                    ax.get_ylabel()))
        out += [("collection", np.asarray(c.get_offsets(), float))
                for c in ax.collections]
        out += [("line", np.asarray(line.get_xydata(), float))
                for line in ax.lines]
        out += [("patch", np.asarray(p.get_verts(), float))
                for p in ax.patches]
        out += [("text", t.get_text(), np.asarray(t.get_position(), float))
                for t in ax.texts]
        out.append(("limits", np.asarray(ax.get_xlim() + ax.get_ylim())))
    return out


def same(a, b) -> None:
    """Two figures' ``artists`` equal within 1e-12."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y) and x[0] == y[0]
        for p, q in zip(x[1:], y[1:]):
            if isinstance(p, str):
                assert p == q
            else:
                np.testing.assert_allclose(p, q, atol=TOL, rtol=0)


def test_plot_2d_samples_full_surface_matches_jax(tmp_path, scenes):
    figs = []
    for viz, (samples, truth, factors) in zip((jviz, tviz), scenes):
        out = str(tmp_path / f"full_{viz.__name__}.png")
        figs.append(viz.plot_2d_samples(
            samples_mapping=samples, truth=truth, truth_factors=factors,
            has_orientation=True, if_legend=True, equal_axis=True,
            title="t", file_name=out,
            contour_vars=[v for v in samples if v.name == "L1"]))
        assert os.path.getsize(out) > 1000
    same(artists(figs[0]), artists(figs[1]))


def test_plot_2d_samples_array_form_matches_jax(tmp_path, scenes):
    figs = []
    for viz, (samples, truth, _) in zip((jviz, tviz), scenes):
        order = list(samples.keys())
        arr = np.concatenate([samples[v] for v in order], axis=1)
        figs.append(viz.plot_2d_samples(
            samples_array=arr, variable_ordering=order,
            colors=["r", "g", "b", "k"],
            file_name=str(tmp_path / "arr.png"), rbt_traj_no_samples=True,
            truth=truth))
        with pytest.raises(ValueError):
            viz.plot_2d_samples(samples_array=arr)
    same(artists(figs[0]), artists(figs[1]))


def test_plot_2d_samples_takes_tensors(scenes):
    """Tensors (as the solver's samples are) draw what arrays draw."""
    samples, truth, factors = scenes[1]
    a = tviz.plot_2d_samples(samples_mapping=samples, truth=truth,
                             truth_factors=factors)
    b = tviz.plot_2d_samples(
        samples_mapping={v: torch.as_tensor(x) for v, x in samples.items()},
        truth={v: torch.as_tensor(x) for v, x in truth.items()},
        truth_factors=factors)
    same(artists(a), artists(b))


def test_kde_contour_matches_jax_and_credible_mass():
    """The same levels and paths as the JAX package's; the 68% mass
    contour of N(0, I) is the circle r ~ 1.51."""
    xy = np.random.default_rng(1).normal(size=(1500, 2))
    sets = []
    for viz in (jviz, tviz):
        fig, ax = plt.subplots()
        cs = viz.kde_contour(ax, xy, levels=(0.68, 0.95))
        sets.append((np.asarray(cs.levels),
                     [p.vertices for p in cs.get_paths()]))
        plt.close(fig)
    np.testing.assert_allclose(sets[1][0], sets[0][0], atol=TOL, rtol=0)
    assert len(sets[1][1]) == len(sets[0][1])
    for p, q in zip(sets[1][1], sets[0][1]):
        np.testing.assert_allclose(p, q, atol=TOL, rtol=0)
    fig, ax = plt.subplots()
    cs = tviz.kde_contour(ax, torch.as_tensor(xy), levels=(0.68,))
    radii = np.linalg.norm(np.concatenate(
        [p.vertices for p in cs.get_paths()]), axis=1)
    assert 1.2 < np.median(radii) < 1.9
    plt.close(fig)


def test_mean_and_clutter_trajectories_match_jax(tmp_path, scenes):
    figs = {}
    for viz, (samples, _, _) in zip((jviz, tviz), scenes):
        order = list(samples.keys())
        f1 = str(tmp_path / "mean.png")
        f2 = str(tmp_path / "clutter.png")
        figs[viz] = (viz.plot_2d_mean_trajectory(samples, order,
                                                 file_name=f1,
                                                 if_legend=True),
                     viz.plot_2d_clutter_trajectories(
                         samples, order, traj_num=10, draw_ellipse=True,
                         ellipse_itv=1, draw_samples=20, file_name=f2))
        assert os.path.getsize(f1) > 1000 and os.path.getsize(f2) > 1000
    for a, b in zip(figs[jviz], figs[tviz]):
        same(artists(a), artists(b))


def test_plot_hypothesis_weights_matches_jax(tmp_path):
    figs = []
    for viz in (jviz, tviz):
        out = str(tmp_path / "hypo.png")
        figs.append(viz.plot_hypothesis_weights(
            STEP_WEIGHTS, file_name=out, true_assoc={"X1->L1|L2": "L1"}))
        assert os.path.getsize(out) > 1000
        with pytest.raises(ValueError):
            viz.plot_hypothesis_weights({1: {}})
    same(artists(figs[0]), artists(figs[1]))


def test_marginal_kde_grid_matches_jax(tmp_path, scenes):
    figs = []
    for viz, (samples, _, _) in zip((jviz, tviz), scenes):
        out = str(tmp_path / "kde.png")
        figs.append(viz.plot_marginal_kde_grid(samples, list(samples),
                                               file_name=out))
        assert os.path.getsize(out) > 1000
    same(artists(figs[0]), artists(figs[1]))


def test_confidence_ellipse_matches_jax():
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=300), rng.normal(size=300)
    figs = []
    for viz in (jviz, tviz):
        fig, ax = plt.subplots()
        viz.confidence_ellipse(x, y, ax, edgecolor="b")
        with pytest.raises(ValueError):
            viz.confidence_ellipse(np.zeros(3), np.zeros(4), ax)
        figs.append(fig)
    same(artists(figs[0]), artists(figs[1]))
    for fig in figs:
        plt.close(fig)


def test_pose_point_and_factor_glyphs_match_jax(scenes):
    figs = []
    for viz, (_, truth, factors) in zip((jviz, tviz), scenes):
        fig, ax = plt.subplots()
        by_name = {str(v.name): v for v in truth}
        viz.plot_pose(ax, truth[by_name["X1"]], color="g")
        viz.plot_point(ax, truth[by_name["L1"]], label="L1",
                       label_offset=(0.1, 0.1))
        viz.plot_likelihood_factor(ax, factors[0], truth)
        figs.append(fig)
    same(artists(figs[0]), artists(figs[1]))
    for fig in figs:
        plt.close(fig)


def test_solve_plot_writes_step_pngs(tmp_path):
    """``solve --plot`` on case1 at a tiny configuration draws every
    step."""
    assert cli.main(["solve", "--device", "cpu", "--fg",
                     chip_smoke.CASE1_FG, "--out", str(tmp_path),
                     "--iters", "20", "--train-samples", "100",
                     "--posterior-samples", "50", "--plot"]) == 0
    run = tmp_path / "run1"
    steps = [n for n in os.listdir(run) if n.startswith("step") and
             n[4:].isdigit()]
    assert steps and all((run / f"{n}.png").stat().st_size > 1000
                         for n in steps)


@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or
                 m.startswith("matplotlib.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


@pytest.mark.parametrize("name", FIGURE_MAKERS)
def test_plots_name_matplotlib_when_it_is_missing(no_matplotlib, name):
    """Each function that makes its own figure (or, for
    ``confidence_ellipse``, its patch) raises an ``ImportError`` naming
    matplotlib; the others draw on an axes the caller made with it."""
    samples = {tv.R2Variable("L1"): np.zeros((10, 2))}
    args = {"confidence_ellipse": (np.zeros(3), np.zeros(3), None),
            "plot_2d_samples": (samples,),
            "plot_marginal_kde_grid": (samples, list(samples)),
            "plot_hypothesis_weights": (STEP_WEIGHTS,),
            "plot_2d_mean_trajectory": (samples, list(samples)),
            "plot_2d_clutter_trajectories": (samples, list(samples))}[name]
    with pytest.raises(ImportError, match="matplotlib"):
        getattr(tviz, name)(*args)


def test_da_run_without_matplotlib_skips_only_hypoweights_png(
        no_matplotlib, tmp_path, capsys):
    """case1_da's first 3 steps through ``run_incrementally`` with
    matplotlib hidden: every artifact of a run with it, but
    ``hypoweights.png``, and one line saying so."""
    from nfisam_tpu_torch.io import (graph_file_parser,
                                     group_nodes_factors_incrementally)
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import NFiSAMArgs, run_incrementally
    nodes, truth, fs = graph_file_parser(os.path.join(
        REPO, "data", "case1_da_factor_graph.fg"))
    batches = group_nodes_factors_incrementally(nodes, fs, 1)[:3]
    args = NFiSAMArgs(posterior_sample_num=100, local_sample_num=200,
                      flow_iterations=30, seed=0)
    run = run_incrementally(str(tmp_path), ParallelNFiSAM(args, "cpu"),
                            batches, truth)
    names = set(os.listdir(run))
    assert "hypoweights.png" not in names
    assert {"step1.hypoweights", "step2.hypoweights", "parameters",
            "step_timing"} <= names
    out = capsys.readouterr().out
    assert out.count("hypoweights.png left out") == 1
    assert "matplotlib" in out
    with pytest.raises(ImportError, match="matplotlib"):
        run_incrementally(str(tmp_path), ParallelNFiSAM(args, "cpu"),
                          batches, truth, plot_args={})
