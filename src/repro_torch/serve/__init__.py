"""The port's serving engines: the dense continuous-batching engine so far."""
