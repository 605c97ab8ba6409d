"""train_step_roofline (%): the train step's device work against its roofline; moves train_tok_s."""

from perfbench import readers


def read(records):
    return readers.roofline(records) if records.get("kind") == "train" else None
