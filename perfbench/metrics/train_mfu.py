"""train_mfu (%): the train step, make_train_step; moves train_tok_s."""

from perfbench import readers


def read(records):
    return readers.train_mfu(records)
