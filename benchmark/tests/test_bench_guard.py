"""No JAX in a run: the module check, and the reference's imports."""

import ast
import os
import subprocess
import sys

from benchmark.harness import guard, spec


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_modules(['multi_part_assembly_tpu_torch',
                                    'multi_part_assembly_tpu_torch.ops',
                                    'jaxtyping', 'flaxen.x', 'numpy']) == []
    assert guard.forbidden_modules(['jax.numpy', 'jaxlib', 'flax.linen',
                                    'multi_part_assembly_tpu.utils']) == \
        ['flax', 'jax', 'jaxlib', 'multi_part_assembly_tpu']


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.BENCH_DIR, 'reference')
    files = [os.path.join(d, n) for d, _, names in os.walk(ref)
             for n in names if n.endswith('.py')]
    assert any(os.sep + 'families' + os.sep in f for f in files)
    for path in files:
        name = os.path.relpath(path, ref)
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ''] if isinstance(
                node, ast.ImportFrom) and not node.level else []
            for mod in mods:
                assert mod.split('.')[0] not in (
                    'multi_part_assembly_tpu_torch', 'benchmark') + \
                    guard.FORBIDDEN, f'{name} imports {mod}'


def test_a_run_loads_no_jax():
    """Importing the harness, the port's trainer and the reference, as a
    run does, loads none of the forbidden modules."""
    code = ('import sys; sys.path.insert(0, %r); '
            'import benchmark.harness.cell, benchmark.harness.trace; '
            'import multi_part_assembly_tpu_torch.train.trainer; '
            'from benchmark.harness import guard; '
            'print(guard.forbidden_modules())') % spec.ROOT
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, env={**os.environ, 'USE_FLAX': '0'},
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'
