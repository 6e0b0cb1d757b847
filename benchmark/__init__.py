"""The port's benchmark: `python3 benchmark/run.py --workload NAME --seed N
--seconds S --trace 0|1` (see README.md)."""
