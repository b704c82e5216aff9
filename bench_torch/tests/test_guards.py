"""What the measured process may hold: no file of the benchmark imports JAX
or the JAX package (top-level names compared whole, so `keisei_tpu_torch`
is not `keisei_tpu`); the plain references import nothing of the program;
and a run in whose process such a module turns up, in the window or in the
check, has no result.

    python -m pytest bench_torch/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import pytest

from bench_torch import rollout_cell, run, spec
from bench_torch.tests.test_faults import tiny

REPO = Path(__file__).resolve().parents[2]
SOURCES = sorted(spec.ROOT.rglob("*.py"))
# the yardstick: the plain references and the comparison, apart from the program
REFERENCES = sorted(spec.ROOT.glob("arch/*.py")) + [
    spec.ROOT / f"{name}.py" for name in ("reference", "compare", "flops", "rules",
                                          "engine_check")]


def imported_roots(path: Path) -> set[str]:
    """Top-level names of every absolute import in `path`, and of every
    `import_module` call with a constant name."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            roots.add(node.args[0].value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    assert not imported_roots(path) & run.FOREIGN


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: str(p.relative_to(REPO)))
def test_the_references_import_nothing_of_the_program(path):
    assert "keisei_tpu_torch" not in imported_roots(path)


def test_the_references_load_nothing_of_the_program_or_of_jax():
    """The same, followed through every import, in a fresh interpreter."""
    code = textwrap.dedent(f"""
        import sys
        from bench_torch import compare, engine_check, flops, reference, rules, spec
        from bench_torch.arch import load
        for path in sorted((spec.ROOT / "arch").glob("*.py")):
            if path.stem != "__init__":
                load(spec.ROOT, path.stem)
        print(sorted({{k.split(".")[0] for k in sys.modules}}
                     & set({sorted(run.FOREIGN | {"keisei_tpu_torch"})!r})))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_refuse_foreign_compares_whole_top_level_names(monkeypatch):
    import keisei_tpu_torch  # noqa: F401  the port's name begins with the JAX package's
    run.refuse_foreign("now")
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    with pytest.raises(run.ForeignModules, match="holds jaxlib"):
        run.refuse_foreign("now")


@pytest.mark.parametrize("stage", ["run", "check"])
def test_a_run_whose_process_loads_the_jax_package_has_no_result(monkeypatch, stage):
    """A tiny rollout cell on the CPU, past the look for a card; a module of
    the JAX package turns up in the window or in the check."""
    real = getattr(rollout_cell, stage)

    def loads_it(*args, **kwargs):
        out = real(*args, **kwargs)
        monkeypatch.setitem(sys.modules, "keisei_tpu", types.ModuleType("keisei_tpu"))
        return out
    monkeypatch.setattr(rollout_cell, stage, loads_it)
    with pytest.raises(run.ForeignModules, match="holds keisei_tpu"):
        run.run_cell(tiny("b40c256.rollout-n1024"), 2 ** 31 + 105, 0.2, False, "cpu",
                     t0=time.monotonic())


def test_main_prints_no_result_and_exits_non_zero_when_refused(monkeypatch, capsys):
    def refused(*args, **kwargs):
        raise run.ForeignModules("once the window had closed, the process holds jax")
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(run.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", refused)
    rc = run.main(["--workload", "b40c256.rollout-n1024", "--seed", "7", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc == 3 and out == "" and "holds jax" in err
