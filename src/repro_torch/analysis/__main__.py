"""``python -m repro_torch.analysis`` — the static-verifier CLI.

The implementation lives in :mod:`repro_torch.launch.lint` next to the
other entry points (search/train); this shim only forwards."""
import sys

from repro_torch.launch.lint import main

if __name__ == "__main__":
    sys.exit(main())
