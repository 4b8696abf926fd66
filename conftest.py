"""Order of the test files under ``pytest -n N --dist loadfile``.

xdist's ``loadfile`` scheduler hands whole files to its workers, those with
the most tests first.  ``tests/test_serve.py`` has only 7 tests, so it would
start late, yet it is the longest file of the suite: in a 6-worker run on
the CPU it took 987 s of the 4450 s summed over the workers, most of it in
its last two tests, which wait out the JAX server's ``close()``.  Handed out
late it ends the run; handed out first it runs beside everything else.

So under ``--dist loadfile`` that one file goes to the first worker, and the
other files follow in xdist's own order: most tests first, ties in
collection order.  Without xdist, or under another ``--dist``, nothing
changes.  Only the order changes: every test runs as it did.
"""
import pytest

FIRST = "tests/test_serve.py"
_FLAG = "loadfile_first"


def pytest_configure(config):
    # the scheduler keeps the workers' collection order, which the hook
    # below sets on every worker alike
    if getattr(config.option, "dist", None) == "loadfile":
        config.option.loadscopereorder = False


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    # workers run with --dist "no": tell them the scheduler is loadfile's
    if node.config.option.dist == "loadfile":
        node.workerinput[_FLAG] = FIRST


@pytest.hookimpl(trylast=True)  # after `-m` and `-k` have deselected
def pytest_collection_modifyitems(config, items):
    first = getattr(config, "workerinput", {}).get(_FLAG)
    if first is None:
        return
    counts = {}
    for item in items:
        path = item.nodeid.split("::", 1)[0]
        counts[path] = counts.get(path, 0) + 1
    items.sort(key=lambda item: (
        (path := item.nodeid.split("::", 1)[0]) != first, -counts[path]))
