"""`python -m directdemod_tpu_torch ...` runs the command-line interface."""
import sys

from .cli import main

sys.exit(main())
