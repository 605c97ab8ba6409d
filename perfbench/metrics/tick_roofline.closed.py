"""tick_roofline.closed (%): the tick's device work against its roofline, closed loop; moves output_tok_s."""

from perfbench import readers


def read(records):
    return readers.roofline(records) if readers.serving(records, "closed") else None
