"""The import guard: what a run may not have loaded, and what the
reference may not import."""

import subprocess
import sys
import textwrap

from conftest import ROOT
from portbench.harness import guard
from portbench.harness.cell import guard_failures


def test_top_level_names_are_compared_whole():
    mods = ["raft_tpu_torch", "raft_tpu_torch.neighbors.ivf_pq", "torch", "jaxtyping",
            "raft_tpu_torchx", "flaxen"]
    assert guard.forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "raft_tpu",
           "raft_tpu.neighbors"]
    assert guard.forbidden_modules(mods + bad) == sorted(bad)


def test_the_reference_imports_nothing_of_the_program():
    assert guard.reference_violations(ROOT / "portbench" / "reference") == []


def test_a_reference_that_imports_the_program_is_caught(tmp_path):
    (tmp_path / "leak.py").write_text("import torch\nfrom raft_tpu_torch.neighbors import refine\n")
    (tmp_path / "leak2.py").write_text("def f():\n    import jax.numpy as jnp\n")
    assert guard.reference_violations(tmp_path) == [
        ("leak.py", "raft_tpu_torch.neighbors"), ("leak2.py", "jax.numpy")]


def _child(code):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_loading_the_reference_loads_no_program_module():
    r = _child("""
        import sys
        import portbench.reference.control, portbench.reference.exact_knn
        print(sorted(m for m in sys.modules if m.split('.')[0] in
                     ('raft_tpu_torch', 'raft_tpu', 'jax', 'jaxlib', 'flax')))
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_a_cpu_run_of_a_cell_loads_no_jax_and_the_guard_sees_a_planted_one():
    r = _child("""
        import io, json, sys, time
        sys.path.insert(0, 'portbench/tests')
        import conftest
        from pathlib import Path
        import tempfile
        from portbench.harness.manifest import Manifest
        from portbench.harness.cell import guard_failures
        tmp = Path(tempfile.mkdtemp())
        bench = json.loads(Path('BENCHMARK.json').read_text())
        for c in bench['configs']:
            p = tmp / f"{c['name']}.json"
            p.write_text(json.dumps(conftest.tiny_config(c['name'])))
            c['file'] = p.name
        (tmp / 'BENCHMARK.json').write_text(json.dumps(bench))
        m = Manifest(root=tmp)
        conftest.run_tiny(m, 'deep10m-ivfpq.batch10k')
        print(json.dumps(guard_failures()))
        sys.modules['jax'] = sys.modules['json']
        print(json.dumps(guard_failures()))
    """)
    assert r.returncode == 0, r.stderr
    clean, planted = r.stdout.strip().splitlines()[-2:]
    assert clean == "[]"
    assert planted == '["loaded: jax"]'


def test_guard_in_this_process_finds_the_reference_clean():
    assert not [f for f in guard_failures() if f.startswith("reference")]
