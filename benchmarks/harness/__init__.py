"""The general parts of the benchmark: the runner, the drivers, the traffic
generator, the trace reader and the frozen yardstick. What belongs to one
configuration, traffic mix, cell or metric lives in files of its own under
``configs/``, ``traffic/``, ``workloads/`` and ``metrics/``."""
