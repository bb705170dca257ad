"""3D steady Poisson CLI (reference ``apps/3d/steady.cpp``), on the CUDA card.

Run as ``python -m pressurepoissonsolver_torch.apps.steady3d [options]``.
"""

import sys

from ..cli import main

if __name__ == "__main__":
    sys.exit(main(3))
