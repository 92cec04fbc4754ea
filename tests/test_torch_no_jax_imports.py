"""The PyTorch port, the scripts that drive it on a card, and the tests
that run on a card (``tests/test_torch_gpu_*.py`` and the local modules
they import) import no JAX, no flax and nothing of the JAX package.
Checked with ``ast`` on the sources, without importing them."""
import ast
import glob
import os
import os.path as osp

import pytest

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TESTS = osp.join(ROOT, 'tests')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tiseg_tpu')
CARD_TESTS = sorted(glob.glob(osp.join(TESTS, 'test_torch_gpu_*.py')))
CARD_TEST_MODULES = [osp.join(TESTS, n) for n in ('torch_cases.py', 'torch_ddp_worker.py')]  # what card tests import


def _sources():
    files = [osp.join(ROOT, 'chip_smoke.py')] + [osp.join(ROOT, 'tools', n) for n in ('pp_phases.py', 'flood_phases.py')]
    for d, _, names in os.walk(osp.join(ROOT, 'tiseg_tpu_torch')):
        files += [osp.join(d, n) for n in sorted(names) if n.endswith('.py')]
    return sorted(files) + CARD_TESTS + CARD_TEST_MODULES


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


@pytest.mark.parametrize('path', CARD_TESTS, ids=lambda p: osp.relpath(p, ROOT))
def test_card_tests_import_only_checked_local_modules(path):
    """A local module that a card test imports is checked above too."""
    local = {osp.splitext(osp.basename(p))[0] for p in glob.glob(osp.join(TESTS, '*.py'))}
    checked = {osp.splitext(osp.basename(p))[0] for p in CARD_TEST_MODULES}
    bad = [m for m in _imported_modules(path) if m.split('.')[0] in local - checked]
    assert not bad, f'{osp.relpath(path, ROOT)} imports unchecked local modules {bad}'


def _gpu_tests(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    return [node.name for node in tree.body if isinstance(node, ast.FunctionDef)
            and any(ast.unparse(d) == 'pytest.mark.gpu' for d in node.decorator_list)]


def test_gpu_tests_live_in_jax_free_files():
    """Every ``gpu`` test of the suite sits in a card test file, and every
    card test file holds ``gpu`` tests alone: the card has no JAX."""
    assert len(CARD_TESTS) >= 8
    for path in sorted(glob.glob(osp.join(TESTS, 'test_*.py'))):
        with open(path) as f:
            tests = [n.name for n in ast.parse(f.read()).body if isinstance(n, ast.FunctionDef)
                     and n.name.startswith('test_')]
        gpu = _gpu_tests(path)
        if path in CARD_TESTS:
            assert gpu and gpu == tests, f'{osp.relpath(path, ROOT)}: tests without the gpu marker'
        else:
            assert not gpu, f'{osp.relpath(path, ROOT)} holds gpu tests {gpu}: move them to a card test file'
