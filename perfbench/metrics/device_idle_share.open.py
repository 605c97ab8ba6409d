"""device_idle_share.open (%): the device, open loop; moves tpot_p95_ms."""

from perfbench import readers


def read(records):
    return readers.idle_share(records) if readers.serving(records, "open") else None
