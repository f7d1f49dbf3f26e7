"""Client-facing API layer: statement parsing, SQL expressions and the
wire shapes. Port of ``corro_sim/api/`` (the host half)."""
