"""The root conftest.py's `_SLOW` marks exactly its node ids `slow`, so a typo
in one fails here instead of leaving its case in tier-1's `-m 'not slow'` run."""
import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_conftest():
    # By path: a plain `import conftest` may find tests/conftest.py instead.
    spec = importlib.util.spec_from_file_location(
        "_root_conftest", os.path.join(ROOT, "conftest.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _collect(marks):
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-m", marks, "tests/test_pallas.py"],
        cwd=ROOT, capture_output=True, text=True, check=True,
    ).stdout
    return [line for line in out.splitlines() if "::" in line]


def test_slow_selects_exactly_the_listed_cases():
    slow_ids = _root_conftest()._SLOW
    slow = _collect("slow")
    rest = _collect("not slow")
    assert sorted(slow) == sorted(slow_ids)
    assert len(rest) == 50
    assert not set(rest) & set(slow_ids)
