"""PyTorch port: `raft_tpu_torch/core/threads.THREAD_ROOTS` held both ways
against the package's syntax trees (the JAX package's raftlint
threadcheck lints only `raft_tpu`, `bench`, `tests` and `tools`).

Every site that hands a function to another execution context must
resolve to a registered root: `threading.Thread(target=...)`, a task
submitted to a thread pool executor, `signal.signal(sig, handler)` (a
lambda trampoline resolves to the call in its body; restoring a captured
handler or SIG_DFL / SIG_IGN is no new root), an event-bus `subscribe`,
a registry `add_collector` and a `weakref.finalize` callback. Every
registered root must be found at such a site. The roots are the JAX
package's, keyed by the port's paths, plus the two pools the port adds.
"""

import ast
from pathlib import Path

from raft_tpu.core.threads import THREAD_ROOTS as JAX_ROOTS
from raft_tpu_torch.core.threads import THREAD_ROOTS

_ROOT = Path(__file__).resolve().parent.parent
_PKG = _ROOT / "raft_tpu_torch"


class _Scopes(ast.NodeVisitor):
    """Each call node of a module with the qualified name of the def or
    class scope around it, and every def's qualified name."""

    def __init__(self):
        self.stack, self.calls, self.defs = [], [], {}

    def _scope(self, node):
        self.stack.append(node.name)
        self.defs[".".join(self.stack)] = node
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _scope

    def visit_Call(self, node):
        self.calls.append((".".join(self.stack), node))
        self.generic_visit(node)


def _modules():
    out = {}
    for path in sorted(_PKG.rglob("*.py")):
        v = _Scopes()
        v.visit(ast.parse(path.read_text(), filename=str(path)))
        out[str(path.relative_to(_ROOT))] = (path, v)
    return out


def _attr_chain(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.append(_attr_chain(node.func) + "()")
    return ".".join(reversed(parts))


def _resolve(mods, rel, scope, fn):
    """Qualified root name(s) of the callable expression `fn` at `scope`
    of module `rel`."""
    v = mods[rel][1]
    if isinstance(fn, ast.Lambda):  # a trampoline: the call in its body
        body = fn.body
        return _resolve(mods, rel, scope, body.func) if isinstance(body, ast.Call) else []
    if isinstance(fn, ast.Name):
        parts = scope.split(".") if scope else []
        while True:  # a nested def, innermost scope first, then the module's
            name = ".".join(parts + [fn.id])
            if name in v.defs:
                return [f"{rel}::{name}"]
            if not parts:
                return []
            parts.pop()
    if isinstance(fn, ast.Attribute):
        owner = _attr_chain(fn.value)
        if owner == "self":  # a method of the enclosing class
            cls = next((p for p in _class_prefixes(v, scope)), None)
            return [f"{rel}::{cls}.{fn.attr}"] if cls else []
        # a method by name: the classes of this module that define it,
        # else every class of the package that does
        found = [f"{r}::{q}" for r, (_, mv) in mods.items() for q in mv.defs
                 if q.count(".") == 1 and q.split(".")[1] == fn.attr
                 and isinstance(mv.defs[q.split(".")[0]], ast.ClassDef)]
        return [n for n in found if n.startswith(rel + "::")] or found
    return []


def _class_prefixes(v, scope):
    parts = scope.split(".")
    for n in range(len(parts), 0, -1):
        name = ".".join(parts[:n])
        if isinstance(v.defs.get(name), ast.ClassDef):
            yield name


def _kw(call, name, pos):
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return call.args[pos] if len(call.args) > pos else None


def _pool_factories(mods):
    """Functions that make a thread pool executor: their calls are pools."""
    names = set()
    for _, (path, v) in mods.items():
        for scope, call in v.calls:
            if _attr_chain(call.func).endswith("ThreadPoolExecutor") and scope:
                names.add(scope.split(".")[-1])
    return names


def _sites(mods):
    """[(module, line, kind, [resolved root names])] of every site."""
    pools = _pool_factories(mods)
    out = []
    for rel, (path, v) in mods.items():
        lines = path.read_text().splitlines()
        for scope, call in v.calls:
            chain = _attr_chain(call.func)
            fn, kind = None, None
            if chain.endswith("Thread") and _kw(call, "target", 99) is not None:
                fn, kind = _kw(call, "target", 99), "thread"
            elif (isinstance(call.func, ast.Attribute) and call.func.attr == "submit"
                  and isinstance(call.func.value, ast.Call)
                  and _attr_chain(call.func.value.func).split(".")[-1] in pools):
                fn, kind = call.args[0], "pool"
            elif chain == "signal.signal" and len(call.args) == 2:
                h = call.args[1]
                restore = ("thread-root-unknown" in lines[call.lineno - 1]
                           or (isinstance(h, ast.Attribute) and h.attr in ("SIG_DFL", "SIG_IGN")))
                if not restore:
                    fn, kind = h, "signal"
            elif isinstance(call.func, ast.Attribute) and call.func.attr == "subscribe":
                fn, kind = call.args[0], "subscribe"
            elif isinstance(call.func, ast.Attribute) and call.func.attr == "add_collector":
                fn, kind = call.args[1], "collector"
            elif chain == "weakref.finalize":
                fn, kind = call.args[1], "finalize"
            if kind is not None:
                out.append((rel, call.lineno, kind, _resolve(mods, rel, scope, fn)))
    return out


def test_every_site_resolves_to_a_registered_root():
    sites = _sites(_modules())
    assert len(sites) >= len(THREAD_ROOTS)
    for rel, line, kind, names in sites:
        assert names, f"{rel}:{line}: {kind} site the walk cannot resolve"
        assert any(n in THREAD_ROOTS for n in names), (rel, line, kind, names)


def test_every_registered_root_is_found():
    found = {n for *_, names in _sites(_modules()) for n in names}
    stale = sorted(set(THREAD_ROOTS) - found)
    assert not stale, stale


def test_roots_are_the_jax_roots_plus_the_port_pools():
    """Each JAX root has its counterpart under the port's path (but the
    serving benchmark's client threads: the port has no benchmark yet);
    the port adds the comms rank pool and the CRC pool."""
    want = {k.replace("raft_tpu/", "raft_tpu_torch/", 1) for k in JAX_ROOTS
            if not k.startswith("bench/")}
    extra = set(THREAD_ROOTS) - want
    assert want <= set(THREAD_ROOTS)
    assert extra == {"raft_tpu_torch/comms/comms.py::Comms.run.rank_main",
                     "raft_tpu_torch/core/serialize.py::crc32c_rows.tile"}
    for key in want:
        assert THREAD_ROOTS[key] == JAX_ROOTS[key.replace("raft_tpu_torch/", "raft_tpu/", 1)]
    import raft_tpu_torch.core.threads as threads

    assert "bench/bench_serve.py::main.client" in threads.__doc__
