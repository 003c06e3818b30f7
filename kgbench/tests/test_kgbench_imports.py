"""No module the benchmark runs imports JAX or the JAX package, and no
reference imports the program. Every import of every module that
``kgbench/run.py`` can reach (the harness, each driver, reference and
metric reader) is parsed and its top-level name, before the first dot,
compared whole: ``kgdet_tpu_torch`` is not ``kgdet_tpu``."""
import ast
import os

from kgbench.tests.tiny import ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'kgdet_tpu'}
KG = os.path.join(ROOT, 'kgbench')


def imported_top_names(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', '')) in (
                'import_module', '__import__') and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split('.')[0])
    return names


def harness_files():
    for d, _, files in os.walk(KG):
        if os.path.basename(d) in ('tests', '__pycache__'):
            continue
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def test_harness_imports_neither_jax_nor_the_jax_package():
    files = list(harness_files())
    assert os.path.join(KG, 'run.py') in files
    assert any('metrics' in f for f in files)
    for path in files:
        bad = imported_top_names(path) & FORBIDDEN
        assert not bad, f'{os.path.relpath(path, ROOT)} imports {bad}'


def test_references_import_nothing_of_the_program():
    ref = os.path.join(KG, 'reference')
    for f in os.listdir(ref):
        if f.endswith('.py'):
            path = os.path.join(ref, f)
            names = imported_top_names(path)
            assert not names & (FORBIDDEN | {'kgdet_tpu_torch'}), f
            assert names <= {'__future__', 'math', 'numpy', 'torch',
                             'kgbench'}, f
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom) and node.level == 0 \
                        and node.module.startswith('kgbench'):
                    assert node.module.split('.')[:2] == [
                        'kgbench', 'reference'], (f, node.module)


def test_the_comparison_is_whole_names(tmp_path):
    path = tmp_path / 'probe.py'
    path.write_text('import kgdet_tpu_torch.api\n'
                    'from kgdet_tpu_torch import x\nimport jax.numpy\n')
    names = imported_top_names(str(path))
    assert names == {'kgdet_tpu_torch', 'jax'}
    assert names & FORBIDDEN == {'jax'}
