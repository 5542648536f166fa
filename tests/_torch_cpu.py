"""One CPU thread for torch in the port's tests and the processes they
start.

The tests run in parallel workers (pytest-xdist, six under the tier-1
command), and torch's CPU ops default to a thread per core in each: with
the other workers busy, the small tensors of these tests spend most of
their time on contended threads (a 238-rating ALS training took 6.4 s
beside five busy workers and 0.02 s with one thread; the whole suite
1,363 s, against 140 s with every process on one thread). Importing this
module gives this process one intra-op thread, and the processes it
starts later one OpenMP thread (``OMP_NUM_THREADS``, read when they
start). Every port test file imports it, so a file run alone behaves as
it does in the suite.
"""

import os

import torch

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)
