import sys

from tpu_stencil_torch.cli import main

sys.exit(main())
