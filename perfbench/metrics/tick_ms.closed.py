"""tick_ms.closed (ms): the engine tick, PagedServeEngine.step, closed loop; moves output_tok_s."""

from perfbench import readers


def read(records):
    return readers.tick_ms(records) if readers.serving(records, "closed") else None
