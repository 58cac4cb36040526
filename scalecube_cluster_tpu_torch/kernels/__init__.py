"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper adds one to ``LAUNCHES[<kernel name>]`` where it launches
its kernel and nowhere else (its plain-PyTorch version, taken for CPU
tensors, does not count), so a run can show that its main path went
through the kernels: clear the counter, drive the path, read it.
"""

import collections

LAUNCHES: "collections.Counter[str]" = collections.Counter()
