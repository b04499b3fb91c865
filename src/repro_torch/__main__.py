import sys

from repro_torch.cli import main

sys.exit(main())
