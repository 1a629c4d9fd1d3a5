"""One torch thread in each test process, for the port's CPU tests (each
``tests/test_torch_*.py`` but the card's ``test_torch_gpu.py`` imports this
module first).

The suite runs in six pytest workers on the machine's cores. torch's own
pool, a thread a core in every worker, made them spin against each other:
six runs side by side of ``test_torch_assoc_riccati.py -k solve`` took
262 s with the default pool and 31 s with one thread each (22.7 s alone).
The tests compare to tolerances or kernel against plain version on small
tensors, below torch's grain for splitting a loop over threads.
"""
import torch

torch.set_num_threads(1)
