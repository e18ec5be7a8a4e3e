"""``python -m dvsg_tpu_torch {stabilize,train,eval} ...``"""

import sys

from dvsg_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
