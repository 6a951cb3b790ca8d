"""Each cell's stream at a tiny size on the CPU: the benchmark's own cut
against the runners' grouping in the port, the fleet's renaming, and the
judge's numbers."""
import hashlib
import os

import numpy as np
import pytest

from portbench import reference, run, stream

FROZEN = {
    "manhattan_g16": "a0f1ae2c4f997cd79e9f6dc5ddab515939842668d191b5b639f9075cbbddfa5c",
}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_streams_are_frozen(name):
    with open(os.path.join(stream.STREAM_DIR, f"{name}.fg"), "rb") as fh:
        assert hashlib.sha256(fh.read()).hexdigest() == FROZEN[name]


def _port_names(step):
    vs, fs = step
    return ([str(v.name) for v in vs],
            [(type(f).__name__, [str(v.name) for v in f.vars]) for f in fs])


def _own_names(step):
    vs, fs = step
    return [v.name for v in vs], [(f.kind, f.vars) for f in fs]


@pytest.mark.parametrize("name, per_step", [("manhattan_g16", 1),
                                            ("manhattan_g16", 5)])
def test_cut_is_the_runners_grouping(name, per_step):
    """The first 40 steps as the runners group them
    (``group_nodes_factors_incrementally`` on the parsed file)."""
    from nfisam_tpu_torch.io import (graph_file_parser,
                                     group_nodes_factors_incrementally)
    nodes, _, factors = graph_file_parser(
        os.path.join(stream.STREAM_DIR, f"{name}.fg"))
    theirs = group_nodes_factors_incrementally(nodes, factors,
                                               incremental_step=per_step)
    ours = stream.cut(stream.load(name), per_step, 40)
    assert len(ours) == 40
    for a, b in zip(ours, theirs):
        assert _own_names(a) == _port_names(b)


def test_fleet_robots_are_disjoint():
    s = stream.load("manhattan_g16")
    one = stream.cut(s, 1, 6)
    steps = stream.fleet(s, 8, 1, 6)
    assert len(steps) == 6
    for t, (vs, fs) in enumerate(steps):
        assert len(vs) == 8 * len(one[t][0])
        assert len(fs) == 8 * len(one[t][1])
        for f in fs:
            robots = {n.split("_")[0] for n in f.vars}
            assert len(robots) == 1, f.vars
    names = [v.name for vs, _ in steps for v in vs]
    assert len(names) == len(set(names))
    for r in range(8):
        mine = [n[len(f"R{r}_"):] for n in names if n.startswith(f"R{r}_")]
        assert mine == [v.name for vs, _ in one for v in vs]


@pytest.mark.parametrize("workload", ["manhattan_g16.online1"])
@pytest.mark.parametrize("robots, per_step", [(1, 1), (1, 5), (8, 1)])
def test_program_gets_the_cut(workload, robots, per_step):
    """The port's parse of the cut text holds the same steps, variable for
    variable and factor for factor: each listed cell, and its stream as a
    fleet of eight and five poses a step."""
    from nfisam_tpu_torch.io import graph_file_parser
    _, config, traffic, _, _ = run.cell_spec(workload)
    traffic = {**traffic, "robots": robots, "poses_per_step": per_step}
    steps = run.cell_steps(config, traffic)[:5]
    prog = run.program_steps(steps, graph_file_parser)
    kinds = {stream.PRIOR, stream.ODOM, stream.RANGE, stream.MIXTURE}
    for ours, theirs in zip(steps, prog):
        names, facs = _own_names(ours)
        p_names, p_facs = _port_names(theirs)
        assert names == p_names
        assert [v for _, v in facs] == [v for _, v in p_facs]
        assert {k for k, _ in p_facs} <= kinds
    assert sum(len(vs) for vs, _ in steps) % robots == 0


def test_truth_reads_about_one():
    """The Manhattan stream was simulated from its truth with the stated
    noise, so the truth read as a one-sample posterior gives a whitened
    residual of about 1 a measurement dimension."""
    s = stream.load("manhattan_g16")
    steps = stream.cut(s, 1, 300)
    vs = [v for st in steps for v in st[0]]
    fs = [f for st in steps for f in st[1]]
    answer = {v.name: v.truth[None, :] for v in vs}
    read = reference.judge_step(answer, vs, fs, 1)
    assert read["faults"] == 0
    assert 0.7 < read["chi2_dof"] < 1.3


def test_judge_counts_faults():
    s = stream.load("manhattan_g16")
    steps = stream.cut(s, 1, 5)
    vs = [v for st in steps for v in st[0]]
    fs = [f for st in steps for f in st[1]]
    rng = np.random.default_rng(0)
    good = {v.name: v.truth + 0.01 * rng.standard_normal((10, v.dim))
            for v in vs}
    assert reference.judge_step(good, vs, fs, 10)["faults"] == 0
    missing = dict(good)
    missing.pop("X4")
    assert reference.judge_step(missing, vs, fs, 10)["faults"] == 1
    extra = {**good, "X99": good["X4"]}
    assert reference.judge_step(extra, vs, fs, 10)["faults"] == 1
    nan = {**good, "X2": np.full((10, 3), np.nan)}
    assert reference.judge_step(nan, vs, fs, 10)["faults"] == 1
    short = {**good, "X2": good["X2"][:5]}
    assert reference.judge_step(short, vs, fs, 10)["faults"] == 1
    shifted = {**good, "X2": good["X2"] + [3.0, 0.0, 0.0]}
    assert reference.judge_step(shifted, vs, fs, 10)["chi2_dof"] > \
        50 * reference.judge_step(good, vs, fs, 10)["chi2_dof"]


def test_mixture_reads_its_best_candidate():
    s = stream.load("manhattan_g16")
    mix = next(f for f in s.factors if f.kind == stream.MIXTURE)
    samples = {n: s.vars[n].truth[None, :] for n in mix.vars}
    chi2, dof = reference.factor_chi2(mix, samples)
    each = [reference.range_chi2(mix.obs[0], mix.cov[0],
                                 samples[mix.vars[0]], samples[c])[0]
            for c in mix.vars[1:]]
    assert dof == 1 and chi2 == pytest.approx(min(each))



def _posterior(n, rng, scale=1.0, n_steps=30):
    """The first steps' variables and factors, and ``n`` joint samples
    drawn as the exact posterior's relative poses are: X0 from its prior,
    each later pose the one before composed with their true relative pose
    and the odometry's noise; landmarks at their truth plus 1 m.  Every
    noise is drawn at ``scale`` times its sigma."""
    steps = stream.cut(stream.load("manhattan_g16"), 1, n_steps)
    vs = [v for st in steps for v in st[0]]
    fs = [f for st in steps for f in st[1]]
    truth = {v.name: v.truth for v in vs}
    into = {f.vars[1]: f for f in fs if f.kind == stream.ODOM}
    prior = next(f for f in fs if f.kind == stream.PRIOR)

    def noisy(pose, cov):
        noise = scale * rng.standard_normal((n, 3)) @ \
            np.linalg.cholesky(cov).T
        return reference._se2_compose(np.broadcast_to(pose, (n, 3)), noise)
    out = {}
    for v in vs:
        if v.kind == "Landmark":
            out[v.name] = v.truth + rng.standard_normal((n, 2))
        elif v.name in into:
            i = into[v.name].vars[0]
            rel = reference._se2_compose(reference._se2_inverse(truth[i]),
                                         v.truth)
            out[v.name] = reference._se2_compose(
                out[i], noisy(rel, into[v.name].cov))
        else:
            out[v.name] = noisy(prior.obs, prior.cov)
    return vs, fs, out


def _turned(samples, theta, center):
    c, s = np.cos(theta), np.sin(theta)
    out = {}
    for name, x in samples.items():
        p = x[:, :2] - center
        y = np.array(x)
        y[:, 0] = center[0] + c * p[:, 0] - s * p[:, 1]
        y[:, 1] = center[1] + s * p[:, 0] + c * p[:, 1]
        if x.shape[1] == 3:
            y[:, 2] = reference._wrap(x[:, 2] + theta)
        out[name] = y
    return out


def test_judge_reads_the_frame_and_the_spread():
    """A posterior drawn as the exact one's relative poses reads about 1
    on ``prior_chi2`` and ``narrow``; turned 30 degrees about the prior's
    position it reads the same but for ``prior_chi2``; at half its spread
    ``narrow`` reads about 4, collapsed to its mean ``NO_SPREAD``."""
    n = 400
    vs, fs, good = _posterior(n, np.random.default_rng(1))
    base = reference.judge_step(good, vs, fs, n)
    assert base["faults"] == 0
    assert 0.8 < base["prior_chi2"] < 1.25
    assert 0.8 < base["narrow"] < 1.25
    turned = reference.judge_step(_turned(good, np.pi / 6, (10.0, 10.0)),
                                  vs, fs, n)
    assert turned["chi2_dof"] == pytest.approx(base["chi2_dof"])
    assert turned["narrow"] == pytest.approx(base["narrow"])
    assert turned["prior_chi2"] > base["prior_chi2"] + 4.0
    _, _, half = _posterior(n, np.random.default_rng(1), scale=0.5)
    assert reference.judge_step(half, vs, fs, n)["narrow"] > \
        3.0 * base["narrow"]
    point = {k: np.broadcast_to(x.mean(0), x.shape) for k, x in good.items()}
    assert reference.judge_step(point, vs, fs, n)["narrow"] == \
        reference.NO_SPREAD


def test_judge_reads_the_samples_precision():
    """Samples in float32 all but never repeat a value; rounded to
    bfloat16 most do."""
    import torch
    n = 1000
    vs, fs, good = _posterior(n, np.random.default_rng(2))
    f32 = {k: x.astype(np.float32) for k, x in good.items()}
    bf16 = {k: torch.from_numpy(x).to(torch.bfloat16).float().numpy()
            for k, x in f32.items()}
    assert reference.judge_step(f32, vs, fs, n)["repeats"] < 0.01
    assert reference.judge_step(bf16, vs, fs, n)["repeats"] > 0.5
