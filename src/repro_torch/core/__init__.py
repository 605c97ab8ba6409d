"""The paper's P-chase contract and measurement methods, copied from
``repro.core`` for the port (numpy only)."""
