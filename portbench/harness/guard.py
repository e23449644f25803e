"""The import guard of every run.

The program under test is `raft_tpu_torch`. Neither it nor the benchmark
may load the JAX package or JAX: at the end of a run no module in
`sys.modules` may have a top-level name (the part before the first dot,
compared whole) of `FORBIDDEN`. `raft_tpu_torch` passes, since its
top-level name is not `raft_tpu`. The reference may import nothing whose
top-level name is the program's either, which its sources show.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from types import ModuleType

FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")
PROGRAM = "raft_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = list(sys.modules if modules is None else modules)
    return sorted(m for m in names if top_level(m) in FORBIDDEN)


def imported_names(path: Path) -> set:
    """Every module name a Python source imports, at any depth."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


def reference_violations(reference_dir: Path) -> list:
    """(file, module) pairs where the reference imports the program, the
    JAX package or JAX: in its sources, and among the names its loaded
    modules hold (a module, or a function or class defined in one)."""
    banned = FORBIDDEN + (PROGRAM,)
    bad = []
    for path in sorted(Path(reference_dir).glob("*.py")):
        for name in sorted(imported_names(path)):
            if top_level(name) in banned:
                bad.append((path.name, name))
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("portbench.reference"):
            continue
        for value in list(vars(mod).values()):
            origin = value.__name__ if isinstance(value, ModuleType) else getattr(
                value, "__module__", None)
            if isinstance(origin, str) and top_level(origin) in banned:
                bad.append((mod_name, origin))
    return bad
