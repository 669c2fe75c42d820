"""``python -m repro_torch.core.engine.verify`` — see :mod:`verify.cli`."""

import sys

from repro_torch.core.engine.verify.cli import main

if __name__ == "__main__":      # importing the module runs nothing
    sys.exit(main())
