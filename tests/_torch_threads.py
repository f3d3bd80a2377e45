"""One intra-op thread for torch in a port test's process, and in the
processes it starts (``OMP_NUM_THREADS``, unless the caller set it).

pytest-xdist's workers share the host's cores, and torch's default is one
thread per core in each of them: six workers on eight cores then run 48
threads, and the port's smoke-sized ops spend their time waiting for each
other (a 4-step xLSTM smoke run of ``launch.train`` took 62 s with six such
processes side by side, 7 s with one thread each; alone it takes 7-8 s
either way).  Imported by ``_torch_parity.py`` and by the port's test
files that do not import it."""
import os

import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
