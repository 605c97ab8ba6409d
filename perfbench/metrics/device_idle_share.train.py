"""device_idle_share.train (%): the device, training; moves train_tok_s."""

from perfbench import readers


def read(records):
    return readers.idle_share(records) if records.get("kind") == "train" else None
