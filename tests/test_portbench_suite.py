"""The benchmark's own CPU tests in the repo's test run.

``python -m pytest portbench/tests`` runs them alone.  Here each test
function of ``portbench/tests`` and its ``card`` fixture are taken from
their modules as they are, so that the repo's run holds the benchmark's
copies of the rooflines, device times and spans to their tests too.  The
``cuda`` cases skip without a card."""

import importlib

import pytest

pytest.register_assert_rewrite("portbench.tests")

from portbench.tests.conftest import card  # noqa: E402,F401

for _name in ("cells", "imports", "layout", "program_spans", "reference", "trace"):
    _module = importlib.import_module(f"portbench.tests.test_portbench_{_name}")
    globals().update({k: v for k, v in vars(_module).items() if k.startswith("test_")})
