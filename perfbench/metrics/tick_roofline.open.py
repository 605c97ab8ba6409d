"""tick_roofline.open (%): the tick's device work against its roofline, open loop; moves tpot_p95_ms."""

from perfbench import readers


def read(records):
    return readers.roofline(records) if readers.serving(records, "open") else None
