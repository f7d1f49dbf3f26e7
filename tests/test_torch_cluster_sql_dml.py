"""Parity of the port's LiveCluster SQL surface with the JAX package's on
the CPU: the LiveCluster cases of tests/test_{dml_exprs,functions,
wire_parity,subs_load}.py, run as tests/test_torch_cluster_sql.py runs
the query modules' (each reference case twice, once per package, with
every cluster's calls recorded and compared and the clusters held leaf
for leaf). Tolerance: exact.
"""

import pytest

from test_torch_cluster import one_torch_thread  # noqa: F401
from test_torch_cluster_sql import CASES, QUERY_MODULES, params, run_both

PARAMS = params([m for m in CASES if m not in QUERY_MODULES])


@pytest.fixture(scope="module")
def module_fixtures():
    """One fixture cluster per package per module-scoped reference
    module, built on first use."""
    return {}


@pytest.mark.parametrize("mod_name,name", PARAMS,
                         ids=[f"{m[5:]}::{n[5:]}" for m, n in PARAMS])
def test_reference_case(mod_name, name, module_fixtures):
    run_both(mod_name, name, module_fixtures)
