"""The port's model zoo: the dense GQA transformer so far."""
