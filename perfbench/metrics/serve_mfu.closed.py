"""serve_mfu.closed (%): the model step, paged_step, closed loop; moves output_tok_s."""

from perfbench import readers


def read(records):
    return readers.serve_mfu(records) if readers.serving(records, "closed") else None
