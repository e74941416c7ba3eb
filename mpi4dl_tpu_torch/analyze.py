"""``python -m mpi4dl_tpu_torch.analyze`` — entry of the collective lint and
its A/B harnesses (twin of ``mpi4dl_tpu/analyze.py``; the implementation is
:mod:`mpi4dl_tpu_torch.analysis.cli`)."""

import sys

from mpi4dl_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
