"""One torch thread in the port's test processes.

Every ``tests/test_torch_*.py`` imports this module first.  The test run
spreads files over several worker processes, and torch's default
intra-op pool (one thread a core in each worker) makes the workers'
spinning pools starve each other on the tests' small tensors: a test that
takes seconds alone took minutes beside five busy workers.  One thread a
worker keeps the run's walls near the tests' own.  Port-on-port bitwise
comparisons run both sides in one process, at this one thread; the
comparisons against the reference carry tolerances.
"""

import torch

torch.set_num_threads(1)
