"""``python -m sparsematrixvectormultiplication_tpu_torch.bench``: the
flagship SpMV line on the card (:mod:`.flagship`)."""

import sys

from .flagship import main

if __name__ == "__main__":
    sys.exit(main())
