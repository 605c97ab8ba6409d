"""device_idle_share.closed (%): the device, closed loop; moves output_tok_s."""

from perfbench import readers


def read(records):
    return readers.idle_share(records) if readers.serving(records, "closed") else None
