"""Command-line runner: ``python -m chrono_tpu_torch.run spec.yaml``
(the reference's yaml_app role; counterpart of ``chrono_tpu/run.py``).
Runs on the CUDA card unless ``--device`` names another device; reading
the spec file needs PyYAML."""

import sys

from chrono_tpu_torch.io.yaml_spec import main

if __name__ == "__main__":
    sys.exit(main())
