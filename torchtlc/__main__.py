"""python -m torchtlc check MC.cfg ... (the same as python -m torchtlc.cli)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
