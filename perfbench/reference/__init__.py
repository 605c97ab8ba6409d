"""Plain references of the benchmark's configurations, in PyTorch and
float32. They import nothing of the program under test and take nothing
it made: the benchmark hands them the weights and tokens it made itself,
and the program's served tokens or training readings only to judge."""
