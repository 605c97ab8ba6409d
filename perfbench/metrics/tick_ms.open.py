"""tick_ms.open (ms): the engine tick, PagedServeEngine.step, open loop; moves tpot_p95_ms."""

from perfbench import readers


def read(records):
    return readers.tick_ms(records) if readers.serving(records, "open") else None
