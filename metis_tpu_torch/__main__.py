import sys

from metis_tpu_torch.cli import main

sys.exit(main())
