"""Parity of the port's pgwire server with the JAX package's on the CPU:
every case of tests/test_pg.py, and the three LiveCluster cases that
need a server (``test_sql_extras.py::test_pgwire_aggregate_fields``,
``test_dml_exprs.py::test_http_expression_dml`` and
``::test_pg_expression_dml``), each run as written on both packages by
tests/test_torch_serving.py's harness: the same outcome, the same
recorded cluster calls and results, the same clusters. Tolerance: exact.
"""

import pytest

from test_torch_cluster import one_torch_thread  # noqa: F401
from test_torch_serving import (  # noqa: F401 - a module fixture
    cases, reference_fixtures, run_both)

SERVER_CASES = [("test_sql_extras", "test_pgwire_aggregate_fields"),
                ("test_dml_exprs", "test_http_expression_dml"),
                ("test_dml_exprs", "test_pg_expression_dml")]
PARAMS = cases("test_pg") + SERVER_CASES


@pytest.mark.parametrize("mod_name,name", PARAMS,
                         ids=[f"{m[5:]}::{n[5:]}" for m, n in PARAMS])
def test_reference_case(mod_name, name, reference_fixtures, request):
    run_both(mod_name, name, reference_fixtures, request)


def test_pg_replies_were_recorded(reference_fixtures):
    """The pgwire client's replies were held reply for reply (runs after
    the reference cases, in file order)."""
    fx = reference_fixtures["test_pg"]
    assert len(fx.replies["port"]) == len(fx.replies["ref"]) > 30
