"""The per-test time limit of the repo's root conftest.py, run the way tier-1
runs: under xdist with `--dist loadfile`, in a pytest of its own.

A test over its limit must fail alone, with every thread's stack in the
output, and run no second time: not on the worker that xdist starts in
place of the one the limit took down, nor on a live worker that takes the
test's file up again.  The other tests of its file must still run and pass.
"""

import ast
import importlib.util
import os
import time

import pytest

pytest_plugins = ["pytester"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT_CONFTEST = os.path.join(os.path.dirname(HERE), "conftest.py")

OVER_THE_LIMIT = """
    import time
    import pytest

    def test_before():
        pass

    @pytest.mark.time_limit(2)
    def test_over_the_limit():
        time.sleep(30)

    @pytest.mark.time_limit(2)
    def test_within_the_limit():
        time.sleep(0.1)
"""
QUICK = """
    def test_quick():
        pass
"""
# With --dist loadfile and two workers: one takes test_a and, after
# test_before, test_d; the other takes test_b and test_c and is still in
# test_slow_tail when the first crashes.  xdist then hands test_a's pending
# tests to the live worker before it reports the crash.
SLOW_TAIL = """
    import time

    def test_slow_tail():
        time.sleep(8)
"""


@pytest.mark.parametrize("workers,files,outcomes", [
    ("1", {"test_two": OVER_THE_LIMIT}, dict(passed=2, failed=1, skipped=1)),
    ("2", {"test_a": OVER_THE_LIMIT, "test_b": SLOW_TAIL, "test_c": QUICK,
           "test_d": QUICK},
     dict(passed=5, failed=1, skipped=1)),
], ids=["replaced_worker", "live_worker"])
def test_a_test_over_its_limit_fails_alone_and_the_run_goes_on(
        pytester, monkeypatch, workers, files, outcomes):
    # Only the plugins named below: each interpreter starts in a second.
    monkeypatch.setenv("PYTEST_DISABLE_PLUGIN_AUTOLOAD", "1")
    with open(ROOT_CONFTEST) as fh:
        pytester.makeconftest(fh.read())
    pytester.makeini("""
        [pytest]
        markers =
            slow: slow
            time_limit(seconds): this test's own time limit
    """)
    tests = pytester.mkdir("tests")
    for name, src in files.items():
        pytester.makepyfile(**{f"tests/{name}": src})
    start = time.monotonic()
    result = pytester.runpytest_subprocess(
        "-p", "xdist", "-n", workers, "--dist", "loadfile",
        "-p", "no:cacheprovider", "-p", "no:randomly", "-rs", str(tests),
        timeout=60)
    took = time.monotonic() - start
    result.assert_outcomes(**outcomes)
    out = result.stdout.str() + result.stderr.str()
    assert out.count("Timeout (0:00:02)!") == 1
    assert "in test_over_the_limit" in out
    assert "crashed while running 'tests/test_" in out
    assert "took a worker down before" in out
    assert took < 20, took


def test_every_mark_by_node_id_names_a_test():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT_CONFTEST)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tables = [mod.SLOW, mod.TIME_LIMIT]
    for fname in set(mod.SLOW) | set(mod.TIME_LIMIT):
        with open(os.path.join(HERE, fname)) as fh:
            tree = ast.parse(fh.read())
        names = {n.name for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        for table in tables:
            for entry in table.get(fname, ()):
                for part in entry.split("[")[0].split("::"):
                    assert part in names, (fname, entry)
