"""queue_ms_p95 (ms): engine admission, PagedServeEngine._admit; moves ttft_p95_ms."""

from perfbench import readers


def read(records):
    return readers.queue_ms_p95(records) if readers.serving(records, "open") else None
