"""Parity of the port's admin socket with the JAX package's on the CPU:
every case of tests/test_admin_cli.py but ``test_cli_agent_end_to_end``
(it drives the command line, which the port does not have yet), and the
LiveCluster cases of tests/test_joins.py but
``test_join_template_renders_live`` (it needs the template renderer,
``tpl.py``, not ported yet), each run as written on both packages by
tests/test_torch_serving.py's harness: the same outcome, the same
recorded cluster calls and results, the same clusters. Tolerance: exact.
"""

import pytest

from test_torch_cluster import one_torch_thread  # noqa: F401
from test_torch_serving import (  # noqa: F401 - a module fixture
    cases, reference_fixtures, run_both)

# cases that build no LiveCluster (the parsers) run in the reference
# file itself; the rest here
JOINS_HOST_ONLY = ("test_parse_and_normalize_join", "test_parse_join_chain")
PARAMS = (cases("test_admin_cli", ("test_cli_agent_end_to_end",))
          + cases("test_joins", ("test_join_template_renders_live",)
                  + JOINS_HOST_ONLY))


@pytest.mark.parametrize("mod_name,name", PARAMS,
                         ids=[f"{m[5:]}::{n[5:]}" for m, n in PARAMS])
def test_reference_case(mod_name, name, reference_fixtures, request):
    run_both(mod_name, name, reference_fixtures, request)


def test_admin_replies_were_recorded(reference_fixtures):
    """The admin socket's replies were held reply for reply (runs after
    the reference cases, in file order)."""
    fx = reference_fixtures["test_admin_cli"]
    assert len(fx.replies["port"]) == len(fx.replies["ref"]) > 10
