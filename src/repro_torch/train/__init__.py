from repro_torch.train.loop import (  # noqa: F401
    TrainState, loss_fn, make_serve_step, make_train_step, make_prefill_step,
)
