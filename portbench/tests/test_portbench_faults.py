"""``correct`` against a broken timed path, on the CPU (the harness's look
for a card skipped: ``run_cell`` drives the rest of a run), and on the
card through the command.

Each fault is planted under the harness, in the solver's entry points,
and the run must come out not correct:

- a step that returns its state unchanged: every step hands back the
  first posterior it drew;
- half of the batch left out: the fleet's robots 4-7 never reach the
  solver; a robot's posterior keeps half of its sample rows;
- an answer altered where it is produced: the newest pose's samples
  moved 5 m (``chi2_dof``); every variable's samples collapsed to their
  mean (``narrow``); the whole map turned 30 degrees about the prior's
  position (``prior_chi2``: odometry and ranges read a turned map alike);
  the control, the samples served in bfloat16 (``repeats``);
- a guarantee of the configuration broken: every clique trained for a
  tenth of the configuration's Adam iterations.

There is no exchange between cards to leave out: every cell runs on one.
The fleet is the listed traffic with eight robots.  The structural
faults run at a tiny flow size; the altered answers and the broken
guarantee need the configuration's own flows, one window step after a
two-step warm-up (about a minute and a half each on the CPU).
"""
import math
import subprocess
import sys

import pytest
import torch

from portbench import run

TINY = dict(flow_iterations=20, local_sample_num=200,
            posterior_sample_num=100)
SHORT = dict(warmup_steps=2)
FLEET = dict(robots=8)


@pytest.fixture
def solver_class():
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    return ParallelNFiSAM


def _cpu(workload, seed, overrides=None, traffic=None):
    return run.run_cell(workload, seed, 0.1, False, device="cpu",
                        overrides=overrides, traffic_overrides=traffic,
                        listed_only=False)


def test_state_unchanged(monkeypatch, solver_class):
    draw = solver_class.sample_posterior
    first = {}

    def stale(self, *a, **k):
        if id(self) not in first:
            first[id(self)] = draw(self, *a, **k)
        return first[id(self)]
    monkeypatch.setattr(solver_class, "sample_posterior", stale)
    out = _cpu("manhattan_g16.online1", 2147483911, TINY, SHORT)
    assert not out["correct"] and out["check"]["faults"][0] > 0


def test_half_the_fleet_left_out(monkeypatch, solver_class):
    add_node, add_factor = solver_class.add_node, solver_class.add_factor

    def gone(v):
        return str(v.name).split("_")[0] in {"R4", "R5", "R6", "R7"}
    monkeypatch.setattr(solver_class, "add_node", lambda self, v:
                        self if gone(v) else add_node(self, v))
    monkeypatch.setattr(solver_class, "add_factor", lambda self, f:
                        self if any(map(gone, f.vars))
                        else add_factor(self, f))
    out = _cpu("manhattan_g16.online1", 2147483912, TINY, FLEET)
    assert not out["correct"] and out["check"]["faults"][0] > 0


def test_half_the_samples_left_out(monkeypatch, solver_class):
    draw = solver_class.sample_posterior
    monkeypatch.setattr(solver_class, "sample_posterior", lambda self: {
        v: x[:x.shape[0] // 2] for v, x in draw(self).items()})
    out = _cpu("manhattan_g16.online1", 2147483913, TINY, SHORT)
    assert not out["correct"] and out["check"]["faults"][0] > 0


def _newest_pose_moved(out):
    newest = max((v for v in out if str(v.name).startswith("X")),
                 key=lambda v: int(str(v.name)[1:]))
    out[newest] = out[newest] + torch.tensor([5.0, 0.0, 0.0])
    return out


def _collapsed(out):
    return {v: x.mean(dim=0, keepdim=True).expand_as(x).clone()
            for v, x in out.items()}


def _turned(out, theta=math.pi / 6, center=(10.0, 10.0)):
    """The map turned by ``theta`` about ``center``, the prior's position
    of X0."""
    c, s = math.cos(theta), math.sin(theta)
    turned = {}
    for v, x in out.items():
        px, py = x[:, 0] - center[0], x[:, 1] - center[1]
        cols = [center[0] + c * px - s * py, center[1] + s * px + c * py]
        if x.shape[1] == 3:
            cols.append(torch.remainder(x[:, 2] + theta + math.pi,
                                        2 * math.pi) - math.pi)
        turned[v] = torch.stack(cols, dim=1)
    return turned


def _bf16(out):
    return {v: x.to(torch.bfloat16).to(x.dtype) for v, x in out.items()}


# each altered answer, and the number of the judge that it must fail
ALTERED = {"moved": (_newest_pose_moved, "chi2_dof"),
           "collapsed": (_collapsed, "narrow"),
           "turned": (_turned, "prior_chi2"),
           "bf16": (_bf16, "repeats")}
SEED = 2147483914


@pytest.fixture(scope="module")
def sound():
    out = _cpu("manhattan_g16.online1", SEED, traffic=SHORT)
    assert out["correct"], out["check"]
    return out


@pytest.mark.parametrize("fault", sorted(ALTERED))
def test_altered_answer(monkeypatch, solver_class, sound, fault):
    change, number = ALTERED[fault]
    draw = solver_class.sample_posterior
    monkeypatch.setattr(solver_class, "sample_posterior",
                        lambda self: change(dict(draw(self).items())))
    out = _cpu("manhattan_g16.online1", SEED, traffic=SHORT)
    assert out["check"]["faults"][0] == 0
    assert not out["correct"]
    value, limit = out["check"][number]
    assert value > limit >= sound["check"][number][0], (number, value)


def test_tenth_of_the_training_fails():
    """The configuration's training cut to a tenth of its iterations."""
    config = run.cell_spec("manhattan_g16.online1")[1]
    cut = config["solver"]["flow_iterations"] // 10
    out = _cpu("manhattan_g16.online1", 2147483915,
               dict(flow_iterations=cut), SHORT)
    assert out["check"]["faults"][0] == 0
    assert not out["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["manhattan_g16.online1"])
def test_card_control_fails(card, monkeypatch, solver_class, workload):
    """On the card, at the cell's own size: a sound run through the command
    is correct; the control (the samples served in bfloat16) and a tenth
    of the training are not."""
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "2147483921", "--seconds", "5", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    assert '"correct": true' in done.stdout.splitlines()[-1]
    config = run.cell_spec(workload)[1]
    out = run.run_cell(workload, 2147483922, 5.0, False, overrides=dict(
        flow_iterations=config["solver"]["flow_iterations"] // 10))
    assert not out["correct"], out["check"]
    draw = solver_class.sample_posterior
    monkeypatch.setattr(solver_class, "sample_posterior",
                        lambda self: _bf16(dict(draw(self).items())))
    out = run.run_cell(workload, 2147483923, 5.0, False)
    assert not out["correct"], out["check"]
    assert out["check"]["repeats"][0] > out["check"]["repeats"][1]
