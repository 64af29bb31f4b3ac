"""python -m kubernetes_tpu_torch.cli — the port's ktctl."""

import sys

from kubernetes_tpu_torch.cli.ktctl import main

sys.exit(main())
