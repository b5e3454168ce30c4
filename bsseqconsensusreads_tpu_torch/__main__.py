import sys

from bsseqconsensusreads_tpu_torch.cli import main

sys.exit(main())
