"""SQLSTATE codes for the Postgres wire API.

The reference ships a full SQLSTATE table (`corro-pg/src/sql_state.rs`,
1336 LoC of generated code→condition-name pairs) so its `ErrorResponse`s
carry real Postgres error codes. This is the same table as data: the
standard PostgreSQL error codes (appendix A of the PG docs), keyed by the
condition name the code paths raise with.

Severity is always ERROR here; the wire layer fills in the rest.

Port of ``corro_sim/api/sql_state.py`` (data only).
"""

from __future__ import annotations

# condition name -> SQLSTATE code (PostgreSQL Appendix A)
SQL_STATE: dict[str, str] = {
    # Class 00/01/02 — success / warnings / no data
    "successful_completion": "00000",
    "warning": "01000",
    "no_data": "02000",
    # Class 03 — SQL statement not yet complete
    "sql_statement_not_yet_complete": "03000",
    # Class 08 — connection exceptions
    "connection_exception": "08000",
    "connection_does_not_exist": "08003",
    "connection_failure": "08006",
    "sqlclient_unable_to_establish_sqlconnection": "08001",
    "sqlserver_rejected_establishment_of_sqlconnection": "08004",
    "transaction_resolution_unknown": "08007",
    "protocol_violation": "08P01",
    # Class 0A — feature not supported
    "feature_not_supported": "0A000",
    # Class 0B — invalid transaction initiation
    "invalid_transaction_initiation": "0B000",
    # Class 21/22 — cardinality / data exceptions
    "cardinality_violation": "21000",
    "data_exception": "22000",
    "string_data_right_truncation": "22001",
    "null_value_not_allowed": "22004",
    "numeric_value_out_of_range": "22003",
    "invalid_datetime_format": "22007",
    "division_by_zero": "22012",
    "invalid_parameter_value": "22023",
    "invalid_text_representation": "22P02",
    "invalid_binary_representation": "22P03",
    # Class 23 — integrity constraint violations
    "integrity_constraint_violation": "23000",
    "restrict_violation": "23001",
    "not_null_violation": "23502",
    "foreign_key_violation": "23503",
    "unique_violation": "23505",
    "check_violation": "23514",
    # Class 24/25 — cursor / transaction state
    "invalid_cursor_state": "24000",
    "invalid_transaction_state": "25000",
    "active_sql_transaction": "25001",
    "branch_transaction_already_active": "25002",
    "inappropriate_access_mode_for_branch_transaction": "25003",
    "inappropriate_isolation_level_for_branch_transaction": "25004",
    "no_active_sql_transaction_for_branch_transaction": "25005",
    "read_only_sql_transaction": "25006",
    "schema_and_data_statement_mixing_not_supported": "25007",
    "no_active_sql_transaction": "25P01",
    "in_failed_sql_transaction": "25P02",
    "idle_in_transaction_session_timeout": "25P03",
    # Class 26/27/28 — statement name / data change / authorization
    "invalid_sql_statement_name": "26000",
    "triggered_data_change_violation": "27000",
    "invalid_authorization_specification": "28000",
    "invalid_password": "28P01",
    # Class 2D/2F — transaction termination / SQL routine
    "invalid_transaction_termination": "2D000",
    "sql_routine_exception": "2F000",
    # Class 34 — invalid cursor name
    "invalid_cursor_name": "34000",
    # Class 3D/3F — invalid catalog/schema name
    "invalid_catalog_name": "3D000",
    "invalid_schema_name": "3F000",
    # Class 40 — transaction rollback
    "transaction_rollback": "40000",
    "transaction_integrity_constraint_violation": "40002",
    "serialization_failure": "40001",
    "statement_completion_unknown": "40003",
    "deadlock_detected": "40P01",
    # Class 42 — syntax error or access rule violation
    "syntax_error_or_access_rule_violation": "42000",
    "syntax_error": "42601",
    "insufficient_privilege": "42501",
    "cannot_coerce": "42846",
    "grouping_error": "42803",
    "windowing_error": "42P20",
    "invalid_recursion": "42P19",
    "invalid_foreign_key": "42830",
    "invalid_name": "42602",
    "name_too_long": "42622",
    "reserved_name": "42939",
    "datatype_mismatch": "42804",
    "indeterminate_datatype": "42P18",
    "collation_mismatch": "42P21",
    "indeterminate_collation": "42P22",
    "wrong_object_type": "42809",
    "undefined_column": "42703",
    "undefined_function": "42883",
    "undefined_table": "42P01",
    "undefined_parameter": "42P02",
    "undefined_object": "42704",
    "duplicate_column": "42701",
    "duplicate_cursor": "42P03",
    "duplicate_database": "42P04",
    "duplicate_function": "42723",
    "duplicate_prepared_statement": "42P05",
    "duplicate_schema": "42P06",
    "duplicate_table": "42P07",
    "duplicate_alias": "42712",
    "duplicate_object": "42710",
    "ambiguous_column": "42702",
    "ambiguous_function": "42725",
    "ambiguous_parameter": "42P08",
    "ambiguous_alias": "42P09",
    "invalid_column_reference": "42P10",
    "invalid_column_definition": "42611",
    "invalid_cursor_definition": "42P11",
    "invalid_database_definition": "42P12",
    "invalid_function_definition": "42P13",
    "invalid_prepared_statement_definition": "42P14",
    "invalid_schema_definition": "42P15",
    "invalid_table_definition": "42P16",
    "invalid_object_definition": "42P17",
    # Class 53/54/55/57/58 — resources / limits / object state / intervention
    "insufficient_resources": "53000",
    "disk_full": "53100",
    "out_of_memory": "53200",
    "too_many_connections": "53300",
    "configuration_limit_exceeded": "53400",
    "program_limit_exceeded": "54000",
    "statement_too_complex": "54001",
    "too_many_columns": "54011",
    "too_many_arguments": "54023",
    "object_not_in_prerequisite_state": "55000",
    "object_in_use": "55006",
    "cant_change_runtime_param": "55P02",
    "lock_not_available": "55P03",
    "operator_intervention": "57000",
    "query_canceled": "57014",
    "admin_shutdown": "57P01",
    "crash_shutdown": "57P02",
    "cannot_connect_now": "57P03",
    "database_dropped": "57P04",
    "system_error": "58000",
    "io_error": "58030",
    "undefined_file": "58P01",
    "duplicate_file": "58P02",
    # Class XX — internal errors
    "internal_error": "XX000",
    "data_corrupted": "XX001",
    "index_corrupted": "XX002",
}


def code(condition: str) -> str:
    """SQLSTATE code for a condition name; internal_error if unknown."""
    return SQL_STATE.get(condition, "XX000")
