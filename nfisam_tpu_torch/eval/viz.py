"""Posterior plots (host-side matplotlib).

Counterpart of ``nfisam_tpu/eval/viz.py``, function for function, and of
the reference's ``src/utils/Visualization.py``: ``plot_2d_samples``
(scatter from a mapping or a packed array, oriented pose markers, truth
glyphs, odometry and measurement edges, red null-hypothesis edges, dashed
K-way edges, the mean trajectory alone), ``plot_2d_mean_trajectory``,
``plot_2d_clutter_trajectories``, ``confidence_ellipse``, and the density
views ``kde_contour`` (2-D Gaussian-KDE contours at credible masses),
``plot_marginal_kde_grid`` and ``plot_hypothesis_weights``.  Samples may
be tensors on any device or arrays; they are drawn from host copies.

matplotlib is imported inside the functions, so the package imports
without it (the card's machine has none); a plot asked for there raises
an ``ImportError`` that names matplotlib.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.variables import Variable, VariableType
from ..factors.factors import BinaryFactor, LikelihoodFactor, PriorFactor
from ..factors.mixtures import BinaryFactorWithNullHypo, KWayFactor


def matplotlib_pyplot():
    """``matplotlib.pyplot`` on the Agg backend; an ``ImportError`` naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plots need matplotlib, which is not installed "
                          f"({e})") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x) -> np.ndarray:
    """A host array of samples given as a tensor or an array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def confidence_ellipse(x: np.ndarray, y: np.ndarray, ax, n_std: float = 1.5,
                       facecolor="none", **kwargs):
    """Covariance confidence ellipse of paired samples (reference
    ``confidence_ellipse`` Visualization.py:516)."""
    matplotlib_pyplot()
    import matplotlib.transforms as transforms
    from matplotlib.patches import Ellipse
    x, y = _np(x), _np(y)
    if x.size != y.size:
        raise ValueError("x and y must be the same size")
    cov = np.cov(x, y)
    pearson = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    rx = np.sqrt(1 + pearson)
    ry = np.sqrt(1 - pearson)
    ellipse = Ellipse((0, 0), width=2 * rx, height=2 * ry,
                      facecolor=facecolor, **kwargs)
    sx = np.sqrt(cov[0, 0]) * n_std
    sy = np.sqrt(cov[1, 1]) * n_std
    transf = (transforms.Affine2D()
              .rotate_deg(45)
              .scale(sx, sy)
              .translate(np.mean(x), np.mean(y)))
    ellipse.set_transform(transf + ax.transData)
    return ax.add_patch(ellipse)


def _oriented_marker(theta: float):
    """Downward-arrow marker rotated to heading (reference :208-213)."""
    from matplotlib.markers import MarkerStyle
    marker = MarkerStyle(marker=r"$↓$")
    marker._transform = marker.get_transform().rotate_deg(
        90 + theta * 180.0 / np.pi)
    return marker


def plot_pose(ax, pose, marker_size: float = 40, color: str = "red",
              arrow_scale: float = 1.0):
    pose = _np(pose).reshape(-1)
    ax.scatter([pose[0]], [pose[1]], s=marker_size, color=color, marker="o")
    if pose.shape[0] >= 3:
        ax.arrow(pose[0], pose[1], arrow_scale * np.cos(pose[2]),
                 arrow_scale * np.sin(pose[2]), color=color,
                 head_width=0.3 * arrow_scale)


def plot_point(ax, point, marker_size: float = 40, color: str = "blue",
               label: Optional[str] = None, label_offset=(0, 0)):
    point = _np(point).reshape(-1)
    ax.scatter([point[0]], [point[1]], s=marker_size, color=color,
               marker="x")
    if label:
        ax.annotate(label, (point[0] + label_offset[0],
                            point[1] + label_offset[1]))


def plot_likelihood_factor(ax, factor, var2truth: Dict, color="gray",
                           alpha=0.5, width=0.8):
    pts = [_np(var2truth[v]).reshape(-1)[:2] for v in factor.vars
           if v in var2truth]
    for a, b in zip(pts, pts[1:]):
        ax.plot([a[0], b[0]], [a[1], b[1]], color=color, alpha=alpha,
                linewidth=width)


def _truth_glyphs(ax, truth, truth_pose_color, truth_landmark_color,
                  truth_pose_markersize, truth_landmark_markersize,
                  truth_pose_marker, truth_landmark_marker,
                  truth_label_offset):
    """Ground-truth pose/landmark glyphs (reference :262-296)."""
    for node, val in truth.items():
        val = _np(val).reshape(-1)
        if node.type == VariableType.Landmark:
            ax.plot([val[0]], [val[1]], c=truth_landmark_color,
                    markersize=truth_landmark_markersize,
                    marker=truth_landmark_marker)
            ax.text(val[0] + truth_label_offset[0],
                    val[1] + truth_label_offset[1], s=node.name,
                    size="x-small")
        elif val.shape[0] >= 3:
            ax.scatter([val[0]], [val[1]], c=truth_pose_color,
                       marker=_oriented_marker(val[2]),
                       s=truth_pose_markersize * 3)
            ax.text(val[0] + truth_label_offset[0],
                    val[1] + truth_label_offset[1], s=node.name)
        else:
            ax.plot([val[0]], [val[1]], c=truth_pose_color,
                    markersize=truth_pose_markersize,
                    marker=truth_pose_marker)


def _truth_factor_edges(ax, truth_factors, truth, plot_all_meas,
                        plot_meas_give_pose, truth_odometry_color,
                        truth_odometry_linewidth,
                        truth_landmark_measurement_color,
                        truth_landmark_measurement_linewidth):
    """Measurement-edge glyphs incl. red null-hypo edges and dashed K-way
    ambiguous-DA edges (reference :297-358)."""

    def edge_style(v1, v2):
        if (v1.type == VariableType.Pose and v2.type == VariableType.Pose):
            return truth_odometry_color, truth_odometry_linewidth, True
        return (truth_landmark_measurement_color,
                truth_landmark_measurement_linewidth, False)

    for factor in truth_factors:
        if isinstance(factor, PriorFactor):
            continue
        if isinstance(factor, KWayFactor):
            var1 = factor.root_var
            show = plot_all_meas or (
                plot_meas_give_pose is not None and
                var1 in set(plot_meas_give_pose))
            if not show or var1 not in truth:
                continue
            for var2 in factor.child_vars:
                if var2 not in truth:
                    continue
                color, width, _ = edge_style(var1, var2)
                (x1, y1), (x2, y2) = truth[var1][:2], truth[var2][:2]
                ax.plot([x1, x2], [y1, y2], "--", c=color,
                        linewidth=width, alpha=0.5)
        elif isinstance(factor, (BinaryFactor, LikelihoodFactor)) and \
                len(factor.vars) == 2:
            var1, var2 = factor.vars
            if var1 not in truth or var2 not in truth:
                continue
            color, width, is_odom = edge_style(var1, var2)
            show = plot_all_meas or is_odom or (
                plot_meas_give_pose is not None and
                set(factor.vars) & set(plot_meas_give_pose))
            if not show:
                continue
            (x1, y1), (x2, y2) = truth[var1][:2], truth[var2][:2]
            if isinstance(factor, BinaryFactorWithNullHypo):
                ax.plot([x1, x2], [y1, y2], c="red", linewidth=width)
            else:
                ax.plot([x1, x2], [y1, y2], c=color, linewidth=width)


def plot_2d_samples(samples_mapping: Dict[Variable, np.ndarray] = None,
                    samples_array: np.ndarray = None,
                    variable_ordering: List[Variable] = None,
                    has_orientation: bool = False,
                    colors: Union[List, Dict, None] = None,
                    truth: Dict[Variable, np.ndarray] = None,
                    truth_factors: Iterable = None,
                    title: str = None, equal_axis: bool = False,
                    marker_size: float = None, file_name: str = None,
                    xlim=None, ylim=None, if_legend: bool = False,
                    legend_on: bool = None,
                    show_plot: bool = False, ax=None,
                    fig_size=None,
                    rbt_traj_no_samples: bool = False,
                    rbt_traj_color: str = "r",
                    plot_all_meas: bool = True,
                    plot_meas_give_pose: Iterable[Variable] = None,
                    truth_odometry_color: str = "k",
                    truth_odometry_linewidth: float = 1,
                    truth_landmark_measurement_color: str = "k",
                    truth_landmark_measurement_linewidth: float = 1,
                    truth_pose_marker: str = "*",
                    truth_landmark_marker: str = "*",
                    truth_pose_markersize: float = 15,
                    truth_landmark_markersize: float = 15,
                    truth_pose_color: str = "r",
                    truth_landmark_color: str = "b",
                    truth_label_offset: Tuple[float, float] = (0, -4),
                    contour_vars: Iterable[Variable] = None,
                    contour_levels: Sequence[float] = (0.68, 0.95),
                    **kwargs):
    """Posterior scatter with ground-truth overlays (reference
    ``plot_2d_samples`` Visualization.py:51-380).

    Accepts samples either as a mapping or as a packed ``samples_array`` +
    ``variable_ordering``; optional extensions beyond the reference:
    ``contour_vars`` draws KDE credible-region contours (at
    ``contour_levels`` posterior mass) for the listed variables.
    """
    plt = matplotlib_pyplot()
    if samples_mapping is not None:
        samples_mapping = {v: _np(s) for v, s in samples_mapping.items()}
    if truth is not None:
        truth = {v: _np(p) for v, p in truth.items()}
    if ax is None:
        fig, ax = plt.subplots(figsize=fig_size)
    else:
        fig = ax.figure
    if legend_on is not None:
        if_legend = legend_on

    if samples_mapping is None and samples_array is not None:
        if variable_ordering is None:
            raise ValueError("samples_array requires variable_ordering")
        samples_mapping, cur = {}, 0
        samples_array = _np(samples_array)
        for var in variable_ordering:
            samples_mapping[var] = samples_array[:, cur:cur + var.dim]
            cur += var.dim
    order = variable_ordering or (list(samples_mapping.keys())
                                  if samples_mapping else [])
    if isinstance(colors, list):
        colors = {v: c for v, c in zip(order, colors)}

    if marker_size is None:
        marker_size = 10.0 if has_orientation else 1.0

    if samples_mapping:
        if rbt_traj_no_samples:
            scatter_vars = [v for v in order
                            if v.type == VariableType.Landmark]
            xs = [np.mean(samples_mapping[v][:, 0]) for v in order
                  if v.type == VariableType.Pose]
            ys = [np.mean(samples_mapping[v][:, 1]) for v in order
                  if v.type == VariableType.Pose]
            ax.plot(xs, ys, c=rbt_traj_color)
        else:
            scatter_vars = order
        for var in scatter_vars:
            s = samples_mapping[var]
            c = [colors[var]] if colors and var in colors else None
            if has_orientation and s.shape[1] >= 3:
                # oriented markers: subsample — one artist per sample
                step = max(1, s.shape[0] // 200)
                for row in s[::step]:
                    ax.scatter([row[0]], [row[1]],
                               marker=_oriented_marker(row[2]),
                               s=marker_size, c=c, **kwargs)
            else:
                ax.scatter(s[:, 0], s[:, 1], marker=".", s=marker_size,
                           c=c, label=str(var.name), **kwargs)

    if contour_vars and samples_mapping:
        for var in contour_vars:
            if var in samples_mapping:
                kde_contour(ax, samples_mapping[var][:, :2],
                            levels=contour_levels)

    if truth_factors and truth:
        _truth_factor_edges(ax, truth_factors, truth, plot_all_meas,
                            plot_meas_give_pose, truth_odometry_color,
                            truth_odometry_linewidth,
                            truth_landmark_measurement_color,
                            truth_landmark_measurement_linewidth)
    if truth:
        _truth_glyphs(ax, truth, truth_pose_color, truth_landmark_color,
                      truth_pose_markersize, truth_landmark_markersize,
                      truth_pose_marker, truth_landmark_marker,
                      truth_label_offset)
    if equal_axis:
        ax.set_aspect("equal", adjustable="datalim")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if if_legend:
        ax.legend(markerscale=6, fontsize=6)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    if title:
        ax.set_title(title)
    if file_name:
        fig.savefig(file_name, dpi=150, bbox_inches="tight")
    if show_plot:  # pragma: no cover
        plt.show()
    plt.close(fig)
    return fig


# --------------------------------------------------------------------------
# density views
# --------------------------------------------------------------------------

def _gaussian_kde_grid(xy: np.ndarray, grid_n: int = 120,
                       pad: float = 0.15):
    """Evaluate a 2-D Gaussian KDE (Scott's rule) on a regular grid."""
    xy = np.asarray(xy, dtype=np.float64)
    n = xy.shape[0]
    cov = np.cov(xy.T) + 1e-12 * np.eye(2)
    bw = n ** (-1.0 / 6.0)           # Scott's rule, d=2
    H = cov * bw * bw
    Hinv = np.linalg.inv(H)
    norm = 1.0 / (2 * np.pi * np.sqrt(np.linalg.det(H)) * n)
    lo, hi = xy.min(0), xy.max(0)
    span = hi - lo + 1e-9
    lo, hi = lo - pad * span, hi + pad * span
    gx = np.linspace(lo[0], hi[0], grid_n)
    gy = np.linspace(lo[1], hi[1], grid_n)
    XX, YY = np.meshgrid(gx, gy)
    pts = np.stack([XX.ravel(), YY.ravel()], axis=1)
    # evaluate in row chunks: the full (grid^2, n, 2) displacement tensor
    # would be hundreds of MB; chunking bounds the transient at a few MB
    Z = np.empty(pts.shape[0])
    chunk = max(1, 2_000_000 // max(n, 1))
    for s in range(0, pts.shape[0], chunk):
        d = pts[s:s + chunk, None, :] - xy[None, :, :]
        e = np.einsum("gni,ij,gnj->gn", d, Hinv, d)
        Z[s:s + chunk] = np.exp(-0.5 * e).sum(axis=1)
    Z = (norm * Z).reshape(grid_n, grid_n)
    return XX, YY, Z


def kde_contour(ax, xy: np.ndarray, levels: Sequence[float] = (0.68, 0.95),
                grid_n: int = 120, colors="k", linewidths=0.8,
                filled: bool = False, **kwargs):
    """Credible-region contours of a 2-D sample cloud.

    ``levels`` are posterior-mass fractions (e.g. 0.68 / 0.95); the density
    thresholds enclosing that mass are found from the KDE itself.  This is
    the contour view the reference builds ad hoc in its analysis scripts
    (``kde_plot_grid.py``) but never ships as a library function.
    """
    xy = _np(xy)
    if xy.shape[0] > 2000:          # KDE cost is O(grid * n)
        idx = np.random.default_rng(0).choice(xy.shape[0], 2000,
                                              replace=False)
        xy = xy[idx]
    XX, YY, Z = _gaussian_kde_grid(xy, grid_n=grid_n)
    zs = np.sort(Z.ravel())[::-1]
    cz = np.cumsum(zs)
    cz /= cz[-1]
    thresholds = sorted(
        float(zs[min(np.searchsorted(cz, m), len(zs) - 1)])
        for m in levels)
    # tight/small clouds can map nearby mass levels onto one density
    # threshold; matplotlib requires strictly increasing contour levels
    strict = []
    for t in thresholds:
        if strict and t <= strict[-1]:
            t = strict[-1] + max(abs(strict[-1]), 1e-12) * 1e-6
        strict.append(t)
    thresholds = strict
    if filled:
        return ax.contourf(XX, YY, Z, levels=thresholds + [Z.max() + 1e-30],
                           **kwargs)
    return ax.contour(XX, YY, Z, levels=thresholds, colors=colors,
                      linewidths=linewidths, **kwargs)


def plot_marginal_kde_grid(samples_mapping: Dict[Variable, np.ndarray],
                           ordering: Sequence[Variable],
                           file_name: str = None, grid_pts: int = 200):
    """Per-variable x/y marginal KDE curves in a grid (the reference's
    ``kde_plot_grid.py`` figure as a library call)."""
    plt = matplotlib_pyplot()
    n = len(ordering)
    ncol = min(n, 4)
    nrow = (n + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(3 * ncol, 2.2 * nrow),
                             squeeze=False)
    for i, var in enumerate(ordering):
        ax = axes[i // ncol][i % ncol]
        s = _np(samples_mapping[var])
        for j, lbl in [(0, "x"), (1, "y")]:
            col = s[:, j]
            lo, hi = col.min(), col.max()
            span = (hi - lo) + 1e-9
            grid = np.linspace(lo - 0.15 * span, hi + 0.15 * span, grid_pts)
            bw = max(col.std() * len(col) ** (-1 / 5.0), 1e-6)
            dens = np.exp(-0.5 * ((grid[:, None] - col[None, :]) / bw)
                          ** 2).sum(1) / (len(col) * bw * np.sqrt(2 * np.pi))
            ax.plot(grid, dens, label=lbl)
        ax.set_title(var.name, fontsize=8)
        ax.tick_params(labelsize=6)
    axes[0][0].legend(fontsize=6)
    fig.tight_layout()
    if file_name:
        fig.savefig(file_name, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_hypothesis_weights(step_weights: Dict[int, Dict[str, np.ndarray]],
                            file_name: str = None, true_assoc: Dict = None):
    """Posterior data-association weight trajectories.

    ``step_weights[step][factor_label] -> (n_components,) weights``; one
    panel per ambiguous factor, weight-vs-step lines per component.  The
    numeric source is the reference's per-step hypothesis-weight log
    (``FactorGraphSolver.py:913-933``).
    """
    plt = matplotlib_pyplot()
    labels: List[str] = []
    for sw in step_weights.values():
        for k in sw:
            if k not in labels:
                labels.append(k)
    n = len(labels)
    if n == 0:
        raise ValueError("no hypothesis weights to plot")
    ncol = min(n, 3)
    nrow = (n + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(3.4 * ncol, 2.4 * nrow),
                             squeeze=False)
    steps = sorted(step_weights.keys())
    for i, lbl in enumerate(labels):
        ax = axes[i // ncol][i % ncol]
        present = [s for s in steps if lbl in step_weights[s]]
        W = np.stack([_np(step_weights[s][lbl]) for s in present])
        for c in range(W.shape[1]):
            ax.plot(present, W[:, c], "-o", markersize=2.5,
                    label=f"comp {c}")
        if true_assoc and lbl in true_assoc:
            ax.axhline(1.0, color="gray", lw=0.5, ls=":")
            ax.set_title(f"{lbl} (true: {true_assoc[lbl]})", fontsize=8)
        else:
            ax.set_title(lbl, fontsize=8)
        ax.set_ylim(-0.05, 1.05)
        ax.set_xlabel("step", fontsize=7)
        ax.tick_params(labelsize=6)
        ax.legend(fontsize=5)
    fig.tight_layout()
    if file_name:
        fig.savefig(file_name, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_2d_mean_trajectory(samples_mapping: Dict[Variable, np.ndarray],
                            ordering: List[Variable], title: str = None,
                            file_name: str = None, if_legend: bool = False,
                            marker_size: Optional[int] = None):
    """Mean robot trajectory + landmark scatter (reference
    ``plot2d_mean_rbt_only`` Visualization.py:381-427)."""
    plt = matplotlib_pyplot()
    fig, ax = plt.subplots()
    xs, ys = [], []
    for var in ordering:
        s = _np(samples_mapping[var])
        if var.type == VariableType.Landmark:
            ax.scatter(s[:, 0], s[:, 1], s=marker_size or 1,
                       label=str(var.name))
        else:
            xs.append(s[:, 0].mean())
            ys.append(s[:, 1].mean())
    ax.plot(xs, ys, "-o", markersize=2)
    if if_legend:
        ax.legend()
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    if title:
        ax.set_title(title)
    if file_name:
        fig.savefig(file_name, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_2d_clutter_trajectories(samples_mapping: Dict[Variable, np.ndarray],
                                 ordering: List[Variable],
                                 traj_num: int = 20,
                                 draw_ellipse: bool = False,
                                 ellipse_itv: int = 200,
                                 draw_samples: int = 0,
                                 title: str = None, file_name: str = None,
                                 if_legend: bool = False, seed: int = 0):
    """Posterior trajectory spaghetti: individual joint-sample trajectories
    as thin black lines over the mean path, optional per-pose confidence
    ellipses (reference ``plot2d_clutter_rbt`` Visualization.py:428-515)."""
    plt = matplotlib_pyplot()
    fig, ax = plt.subplots()
    rbt_vars = [v for v in ordering if v.type == VariableType.Pose]
    lmk_vars = [v for v in ordering if v.type == VariableType.Landmark]
    if not rbt_vars:
        raise ValueError("no pose variables to plot")
    all_x = np.stack([_np(samples_mapping[v])[:, 0]
                      for v in rbt_vars], axis=1)
    all_y = np.stack([_np(samples_mapping[v])[:, 1]
                      for v in rbt_vars], axis=1)
    rng = np.random.default_rng(seed)
    picks = rng.choice(all_x.shape[0], min(traj_num, all_x.shape[0]),
                       replace=False)
    for idx in picks:
        ax.plot(all_x[idx], all_y[idx], color="black", linewidth=0.2)
    ax.plot(all_x.mean(0), all_y.mean(0), color="r", linewidth=0.5,
            alpha=0.8)
    if draw_ellipse or draw_samples > 0:
        for i, v in enumerate(rbt_vars):
            if i % ellipse_itv:
                continue
            s = _np(samples_mapping[v])
            if draw_samples > 0:
                ax.scatter(s[:draw_samples, 0], s[:draw_samples, 1], s=0.1)
            ax.scatter(s[:, 0].mean(), s[:, 1].mean(), marker="*")
            if draw_ellipse:
                confidence_ellipse(s[:, 0], s[:, 1], ax, edgecolor="blue")
    for v in lmk_vars:
        s = _np(samples_mapping[v])
        ax.scatter(s[:, 0], s[:, 1], s=1, label=str(v.name))
    if if_legend:
        ax.legend()
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    if title:
        ax.set_title(title)
    if file_name:
        fig.savefig(file_name, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return fig
