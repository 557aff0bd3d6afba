"""``python -m dcos_commons_tpu_torch.cli`` entry point.

Reference: sdk/cli/main.go:1-12 — the 12-line default CLI binary every
framework ships.

Port of ``dcos_commons_tpu/cli/__main__.py``, line for line but the imports.
"""

import sys

from dcos_commons_tpu_torch.cli.commands import main

if __name__ == "__main__":
    sys.exit(main())
