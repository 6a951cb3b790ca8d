"""The JAX package's runner scripts (``scripts/*.py``) read as source.

Importing one of them runs its module-level code: ``sys.argv`` parsing
and a ``jax.config`` compilation cache under a fixed path.  The port's
tests instead take the functions and statements they hold a port runner
against out of the script's syntax tree and run those alone, in a
namespace the test fills.
"""
import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script_path(name: str) -> str:
    return os.path.join(REPO, "scripts", name)


def example_path(family: str, name: str) -> str:
    """A JAX example, ``examples/<family>/<name>``: read it as a script
    (each edits ``sys.path`` and runs its example at import)."""
    return os.path.join(REPO, "examples", family, name)


def _tree(path: str) -> tuple:
    with open(path) as fh:
        src = fh.read()
    return src, ast.parse(src, path)


def script_functions(path: str, names, namespace: dict) -> dict:
    """Define the script's top-level functions ``names`` in ``namespace``
    (which supplies the module-level names they read); returns it."""
    _, tree = _tree(path)
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {d.name for d in defs} == set(names), names
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"),
         namespace)
    return namespace


def function_statements(path: str, func: str, start: str, stop=None):
    """The statements of the script's function ``func``, from the first
    whose source begins with ``start`` up to the first after it that
    begins with ``stop`` (not included; None: to the end), imports left
    out, compiled: run them with ``exec`` in a namespace holding the names
    they read.  A ``return x`` among them sets ``_return`` to x."""
    src, tree = _tree(path)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    segs = [ast.get_source_segment(src, s) for s in fn.body]
    i = next(k for k, s in enumerate(segs) if s.startswith(start))
    j = len(segs) if stop is None else next(
        k for k, s in enumerate(segs) if k > i and s.startswith(stop))
    body = []
    for s in fn.body[i:j]:
        if isinstance(s, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(s, ast.Return):
            s = ast.copy_location(ast.Assign(
                targets=[ast.Name("_return", ast.Store())], value=s.value),
                s)
        body.append(s)
    mod = ast.fix_missing_locations(ast.Module(body=body, type_ignores=[]))
    return compile(mod, path, "exec")


def main_block(path: str):
    """The body of the file's ``if __name__ == "__main__":`` block,
    compiled: run it with ``exec`` in a namespace holding the names it
    reads (a test's stand-ins for the solver among them)."""
    _, tree = _tree(path)
    block = next(n for n in tree.body if isinstance(n, ast.If)
                 and "__main__" in ast.dump(n.test))
    mod = ast.fix_missing_locations(ast.Module(body=block.body,
                                               type_ignores=[]))
    return compile(mod, path, "exec")


def call_keywords(path: str, callee: str) -> list:
    """The keyword arguments of every call of ``callee`` in the file, in
    order: {keyword: its literal value, or its source where it is not a
    literal}."""
    src, tree = _tree(path)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", getattr(n.func, "attr", None))
             == callee]
    out = []
    for c in sorted(calls, key=lambda c: (c.lineno, c.col_offset)):
        kws = {}
        for k in c.keywords:
            try:
                kws[k.arg] = ast.literal_eval(k.value)
            except ValueError:
                kws[k.arg] = ast.get_source_segment(src, k.value)
        out.append(kws)
    return out


def dict_keys(path: str, func: str, name: str) -> set:
    """The keys of the dict literal assigned to ``name`` in ``func``."""
    _, tree = _tree(path)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == name
                        for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no dict {name} in {func}")
