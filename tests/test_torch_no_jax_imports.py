"""The PyTorch port, and the scripts that drive it on a card, import no
JAX, no flax and nothing of the JAX package. Checked with ``ast`` on the
sources, without importing them."""
import ast
import os
import os.path as osp

import pytest

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tiseg_tpu')


def _sources():
    files = [osp.join(ROOT, 'chip_smoke.py')] + [osp.join(ROOT, 'tools', n) for n in ('pp_phases.py', 'flood_phases.py')]
    for d, _, names in os.walk(osp.join(ROOT, 'tiseg_tpu_torch')):
        files += [osp.join(d, n) for n in sorted(names) if n.endswith('.py')]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, 'attr', getattr(node.func, 'id', None))
              in ('import_module', '__import__') and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(module: str) -> bool:
    return module.split('.')[0] in FORBIDDEN


@pytest.mark.parametrize('path', _sources(), ids=lambda p: osp.relpath(p, ROOT))
def test_port_module_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f'{osp.relpath(path, ROOT)} imports {bad}'


def test_checker_catches_forbidden_imports(tmp_path):
    src = tmp_path / 'm.py'
    src.write_text('import jax.numpy as jnp\nfrom flax import linen\nfrom tiseg_tpu.utils import registry\n'
                   'import importlib\nimportlib.import_module("tiseg_tpu.ops")\n'
                   'from tiseg_tpu_torch.utils import Config\nimport torch\n')
    bad = [m for m in _imported_modules(str(src)) if _forbidden(m)]
    assert sorted(bad) == ['flax', 'jax.numpy', 'tiseg_tpu.ops', 'tiseg_tpu.utils']
