"""One run of one benchmark cell of the PyTorch and CUDA port
(``nfisam_tpu_torch``) on the card::

    python3 portbench/run.py --workload manhattan_g16.online1 --seed 7 \\
        --seconds 10 --trace 0

Set-up (``setup_s``, from this file's first line to the window): torch
and the port imported, the AR-inverse kernels loaded from the port's
build directory inside the checkout (built by the first run there), the
cell's stream cut from its frozen ``.fg`` (``stream.py``), the solver
built from the configuration's ``NFiSAMArgs`` and ``--seed``, and the
traffic's warm-up steps run.  The window then runs the stream's next
steps, each the runners' sequence (``add_node`` / ``add_factor``,
``update_physical_and_working_graphs``, ``fit_tree_density_models``,
``sample_posterior``, each ended by a synchronize), until ``--seconds``
have passed, finishing the step in progress, or until the stream ends.
``step_s`` is the window's wall over its steps.  After the window the
posteriors the window drew are judged by ``reference.py`` (every one, up
to ``KEEP``; beyond that a sample drawn from the seed, and always the
last), and the last line of standard output is the result as JSON.

``--trace 1`` gives the per-layer metrics instead: the traffic's
``trace_steps`` steps after the warm-up run under ``torch.profiler`` (its
trace is read in memory; nothing is written), then the window runs
untraced, and each reader of ``metrics/<name>.py`` takes its number from
the window's spans, the trace and the work counted from shapes
(``work.py``).

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic, read from ``configs/<name>.json`` and
``traffic/<name>.json``; the metrics of the cell are those
``BENCHMARK.json`` lists for it.  Exit codes: 0 with a result; 2 without
a card (or fewer cards than the cell asks for), a missing port, or JAX
loaded; 1 on an error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# a library the port imports must not load JAX behind it
os.environ.setdefault("USE_FLAX", "0")

from portbench import reference, stream, trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nfisam_tpu")
PACKAGE = "nfisam_tpu_torch"
KEEP = 64            # posteriors judged at most, besides the last
# the judge's numbers that every configuration compares; others
# (``reference.judge_step``) are compared where its ``limits`` name them
ALWAYS = ("faults", "chi2_dof")
CONTROLS = ("tf32", "bf16")   # overrides that lower the precision


class Refused(Exception):
    """A run that must print no result (exit 2)."""


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def cell_spec(workload: str, listed_only: bool = True) -> tuple:
    """(the cell's entry, its configuration, its traffic, the metric
    entries of BENCHMARK.json that the cell reports with and without a
    trace).  Unless ``listed_only``, a workload that BENCHMARK.json does
    not list is read as ``<configuration>.<traffic>`` on one card (the
    readings of a cell before it is listed)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload in cells:
        cell = cells[workload]
    elif not listed_only and "." in workload:
        config_name, traffic_name = workload.split(".", 1)
        cell = {"name": workload, "config": config_name,
                "traffic": traffic_name, "chips": 1}
    else:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")

    def mine(m):
        return workload in m.get("workloads", [workload])
    return (cell, config, traffic,
            [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def import_port():
    """The port's package, from this checkout and no other place."""
    spec = importlib.util.find_spec(PACKAGE)
    if spec is None or not os.path.abspath(spec.origin).startswith(
            os.path.join(ROOT, PACKAGE) + os.sep):
        raise Refused(f"{PACKAGE} is not in this checkout ({ROOT})")
    import nfisam_tpu_torch  # noqa: F401
    from nfisam_tpu_torch.flows import ar_inverse_kernel
    from nfisam_tpu_torch.io import graph_file_parser
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import NFiSAMArgs
    return ar_inverse_kernel, graph_file_parser, ParallelNFiSAM, NFiSAMArgs


def cell_steps(config: dict, traffic: dict) -> list:
    """The cell's steps (``stream.Step``), warm-up included: the stream to
    its end, or its first ``warmup_steps`` + ``max_window_steps`` where
    the traffic caps the window."""
    s = stream.load(traffic.get("stream", config["stream"]))
    cap = traffic.get("max_window_steps")
    return stream.fleet(s, traffic["robots"], traffic["poses_per_step"],
                        None if cap is None else
                        traffic["warmup_steps"] + cap)


def program_steps(steps, graph_file_parser) -> list:
    """The same steps as the port's variables and factors: the steps'
    text parsed by ``io.graph_file_parser`` from a file in the temporary
    directory, removed at once."""
    fd, path = tempfile.mkstemp(suffix=".fg")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(stream.to_text(steps))
        nodes, _, factors = graph_file_parser(path)
    finally:
        os.remove(path)
    by_name = {str(v.name): v for v in nodes}
    it = iter(factors)
    out = []
    for vs, fs in steps:
        out.append(([by_name[v.name] for v in vs], [next(it) for _ in fs]))
    return out


def clique_name(clique) -> str:
    return "".join(sorted(str(v.name) for v in clique.vars))


def step_work(solver) -> dict:
    """What the step computed, from the solver's public trees and its
    per-clique training record: each trained clique's (dim, Adam
    iterations) and the posterior's cliques (dim, separator dim)."""
    trained = solver._temp_training_loss
    cliques = solver.working_bayes_tree.clique_ordering()
    return {"trained": [(c.dim, int(trained[clique_name(c)][1]))
                        for c in cliques if clique_name(c) in trained],
            "posterior": [(c.dim, c.separator_dim) for c in
                          solver.physical_bayes_tree.clique_ordering()]}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", overrides=None, detail=None,
             traffic_overrides=None, listed_only: bool = True) -> dict:
    """One run of ``workload``: set-up, window, judge.  Returns the result
    record, the last line ``main`` prints.  ``overrides`` replace fields of
    the configuration's solver arguments (the controls' runs; ``tf32``
    turns TF32 on, ``bf16`` runs each step under bfloat16 autocast); a
    run on the CPU has no device metrics and exists for
    the tests.  ``detail``, a dict, gets each window step's spans and
    work; ``traffic_overrides`` replace fields of the traffic (the tests'
    shorter warm-up); ``listed_only`` as ``cell_spec`` has it."""
    import torch

    cell, config, traffic, e2e, per_layer = cell_spec(workload,
                                                      listed_only)
    traffic = {**traffic, **(traffic_overrides or {})}
    kernel, graph_file_parser, ParallelNFiSAM, NFiSAMArgs = import_port()
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        # the configuration's float32: no TF32 on the matmuls
        torch.backends.cuda.matmul.allow_tf32 = bool(
            (overrides or {}).get("tf32", False))
        torch.backends.cudnn.allow_tf32 = False
        kernel.load()
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    steps = cell_steps(config, traffic)
    prog = program_steps(steps, graph_file_parser)
    solver_args = {k: v for k, v in {**config["solver"],
                                     **(overrides or {})}.items()
                   if k not in CONTROLS}
    solver = ParallelNFiSAM(NFiSAMArgs(**solver_args, seed=int(seed)),
                            device=device)
    spans = tracing.Spans()
    work = []
    # the posteriors to judge: a reservoir of KEEP drawn from the seed,
    # and the newest
    kept, newest, seen = [], None, 0
    pick = random.Random(int(seed))

    def keep(k, samples):
        nonlocal newest, seen
        if newest is not None:
            if len(kept) < KEEP:
                kept.append(newest)
            else:
                j = pick.randrange(seen + 1)
                if j < KEEP:
                    kept[j] = newest
            seen += 1
        newest = (k, samples)

    lowered = contextlib.nullcontext
    if (overrides or {}).get("bf16"):
        def lowered():
            return torch.autocast(device.type, dtype=torch.bfloat16)

    def do_step(k, record_work):
        spans.rows.append({})
        with spans.span("step", sync), lowered():
            with spans.span("surgery", sync):
                for v in prog[k][0]:
                    solver.add_node(v)
                for f in prog[k][1]:
                    solver.add_factor(f)
                solver.update_physical_and_working_graphs()
            with spans.span("fit", sync):
                solver.fit_tree_density_models()
            with spans.span("posterior", sync):
                samples = solver.sample_posterior()
        if record_work:
            work.append(step_work(solver))
        return samples

    warm = traffic["warmup_steps"]
    for k in range(warm):
        do_step(k, False)
    spans.rows.clear()
    setup_s = time.perf_counter() - T_START

    # with a trace, the first steps after the warm-up run under the
    # profiler, before the window; the window's steps are never traced
    traced, n_traced, k = None, 0, warm
    if trace:
        n_traced = int(traffic["trace_steps"])
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            spans.profiling = True
            for _ in range(n_traced):
                keep(k, do_step(k, True))
                k += 1
            spans.profiling = False
        traced = tracing.read_trace(prof)
        del prof
    launches0 = kernel.launches
    t0 = time.perf_counter()
    while k < len(prog):
        keep(k, do_step(k, trace or detail is not None))
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    n_steps = k - warm - n_traced
    if n_steps == 0:
        raise RuntimeError(f"{workload}: the stream ends before the window")
    launches = kernel.launches - launches0
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    found = forbidden_modules()
    if found:
        raise Refused("JAX or the JAX package is loaded: " +
                      ", ".join(found))

    run = {"config": {**config, "solver": solver_args}, "traffic": traffic,
           "rows": spans.rows[n_traced:], "traced_rows": spans.rows[:n_traced],
           "work": work[n_traced:], "traced_work": work[:n_traced],
           "trace": traced}
    metrics = {}
    if trace:
        for m in per_layer:
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"step_s": window_s / n_steps, "setup_s": setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    # the judge runs once the window is closed and the peak is read, on
    # host copies, with the solver's state freed
    answers = sorted(kept + [newest], key=lambda a: a[0])
    del kept, newest
    host = [(k, host_answer(a)) for k, a in answers]
    del answers, solver
    if on_card:
        torch.cuda.empty_cache()
    limits = {**config["limits"], **traffic.get("limits", {})}
    reads = reference.judge(host, steps,
                            solver_args["posterior_sample_num"])
    correct, failed, check = verdict(reads, limits)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(cell["chips"]) if on_card else 0,
           "memory_peak_bytes": int(memory_peak)}
    out = {"correct": correct, "attempted": len(reads), "failed": failed,
           "metrics": metrics, "device": dev}
    if traced is not None:
        lo, hi = tracing.window(traced)
        dev["busy_s"] = tracing.busy_ns(traced) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = {"device_ops": tracing.top_device_ops(traced),
                            "idle_gaps": tracing.idle_gaps(traced)}
    if detail is not None:
        detail.update(rows=spans.rows, work=work, answers=host, steps=steps)
    out["steps"] = n_steps
    out["launches"] = launches
    out["readings"] = {name: [r[name] for r in reads] for name in reads[0]
                       if name != "step"}
    out["check"] = check
    return out


def host_answer(samples) -> dict:
    """A posterior as the solver returns it, as {name: NumPy (n, dim)}."""
    if hasattr(samples, "materialize"):
        samples = samples.materialize()
    return {str(v.name): x if isinstance(x, np.ndarray) else
            x.detach().cpu().numpy() for v, x in samples.items()}


def verdict(reads: list, limits: dict) -> tuple:
    """(correct, steps failed, {number: [worst step's value, limit]}) of
    the judge's readings under the configuration's ``limits``: the
    numbers of ``ALWAYS`` and each other number ``limits`` names.  A
    number with nothing to read fails its step; a limit that is null
    (not set yet) fails every step."""
    names = list(ALWAYS) + [n for n in limits if n not in ALWAYS]
    check, failed = {}, set()
    for name in names:
        limit = limits[name]
        values = [r[name] for r in reads]
        for r, value in zip(reads, values):
            if value is None or limit is None or value > limit:
                failed.add(r["step"])
        known = [v for v in values if v is not None]
        check[name] = [max(known) if known else None, limit]
    return (bool(reads) and not failed, len(failed), check)


def read_metric(name: str, run: dict):
    """The reader ``metrics/<name>.py``'s ``read(run)``: a number, or None
    where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", os.path.join(HERE, "metrics",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(run)
    return None if value is None else float(value)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 portbench/run.py",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        cell = cell_spec(args.workload)[0]
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{args.workload} needs {cell['chips']} CUDA "
                          f"card(s); this machine has "
                          f"{torch.cuda.device_count()}")
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except (FileNotFoundError, ImportError) as e:
        print(f"portbench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    for name, (value, limit) in out["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
