"""serve_mfu.open (%): the model step, paged_step, open loop; moves tpot_p95_ms."""

from perfbench import readers


def read(records):
    return readers.serve_mfu(records) if readers.serving(records, "open") else None
